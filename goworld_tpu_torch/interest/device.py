"""The device step for interest-policy stacks: word planes resident on the
engine's device, one kernel launch a step, only changed words back.

The counterpart of the JAX package's ``interest/device.py`` (a jitted XLA
program per capacity, stack config and cadence) and of the host diff in
its ``interest/policy.py``.  A device stack's ``final`` and ``near``
planes live here as int32 [C, W] tensors (:class:`ResidentPlanes`),
allocated once per capacity and updated in place by
:func:`..ops.interest_cuda.interest_step` (the hand kernel
``csrc/interest_step.cu`` on a CUDA device, its plain PyTorch version on
the CPU).  A step (:func:`resident_step`):

1. :func:`upload_columns`: this tick's columns (x, z, r, team, vis, act:
   21 bytes a slot) through one reused pinned buffer, the distance field
   only when its grid changed, and both planes only when the stack marked
   them dirty (a host-side rewrite: growth, re-arm, payload, a demoted or
   host-fallback step);
2. the kernel: both planes in place, and each changed word (flat index,
   new word) appended to a list on the device, one list a plane;
3. :func:`fetch_changes`: the two counts with the lists' first
   ``PREFETCH`` entries (one wait), then the rest of a longer list, into
   reused pinned buffers.  A list past its cap (:func:`list_cap`) is a
   counted overflow: that plane is fetched whole and diffed on the host.

The host planes stay the stack's authoritative state (payloads, growth,
``words``); the stack applies the changes to them, so both sides are
equal after every step.  ``ResidentPlanes.stats`` counts plane uploads,
changed words, list overflows and the bytes each way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import interest_cuda as IC
from ..ops.aoi_predicate import words_to_numpy

# changed-word list cap: a sixteenth of a plane's words, at least 2^16
# (never more than the plane has)
LIST_MIN = 1 << 16
LIST_DIV = 16
# bytes a slot of this tick's columns: x, z, r, team, vis, act
COL_BYTES = 21
# list entries a plane fetched together with the counts
PREFETCH = 4096


def list_cap(capacity: int) -> int:
    """Entries of each changed-word list at ``capacity`` slots."""
    words = capacity * (capacity // 32)
    return min(words, max(LIST_MIN, words // LIST_DIV))


class ResidentPlanes:
    """One device stack's planes, lists and staging buffers on
    ``device``, (re)allocated when the capacity changes.  ``dirty``: the
    host planes were rewritten, the next step uploads them."""

    def __init__(self, device, stats: dict):
        self.device = torch.device(device)
        self.stats = stats
        self.capacity = None
        self.dirty = False
        self._grid_host = None

    def ensure(self, capacity: int) -> None:
        if capacity == self.capacity:
            return
        c, dev = capacity, self.device
        w = c // 32
        cuda = dev.type == "cuda"
        self.capacity = c
        self.cap = list_cap(c)
        self.final = torch.zeros((c, w), dtype=torch.int32, device=dev)
        self.near = torch.zeros((c, w), dtype=torch.int32, device=dev)
        self.lists = torch.empty((2, self.cap, 2), dtype=torch.int32,
                                 device=dev)
        self.counts = torch.zeros(2, dtype=torch.int32, device=dev)
        self.cols_h = torch.empty(COL_BYTES * c, dtype=torch.uint8,
                                  pin_memory=cuda)
        # on the CPU the staging buffers are the device buffers
        self.cols = torch.empty_like(self.cols_h, device=dev) if cuda \
            else self.cols_h
        self.counts_h = torch.empty(2, dtype=torch.int32, pin_memory=True) \
            if cuda else self.counts
        self.lists_h = torch.empty((2, self.cap, 2), dtype=torch.int32,
                                   pin_memory=True) if cuda else self.lists
        h = self.cols_h.numpy()
        self._h_f32 = h[: 12 * c].view(np.float32).reshape(3, c)
        self._h_i32 = h[12 * c: 20 * c].view(np.int32).reshape(2, c)
        self._h_act = h[20 * c:].view(np.bool_)
        f32 = self.cols[: 12 * c].view(torch.float32).reshape(3, c)
        i32 = self.cols[12 * c: 20 * c].view(torch.int32).reshape(2, c)
        self.columns = (f32[0], f32[1], f32[2],
                        self.cols[20 * c:].view(torch.bool), i32[0], i32[1])
        self.grid = None
        self._grid_host = None

    def clear_entity(self, slot: int, w: int, b: int) -> None:
        """Zero a slot's row and its column bit in both device planes (a
        few tensor ops; a dirty or unallocated side waits for its
        upload)."""
        if self.capacity is None or self.dirty:
            return
        m = ~(1 << b) & 0xFFFFFFFF
        m = m - (1 << 32) if m >= 1 << 31 else m  # the int32 of those bits
        for plane in (self.final, self.near):
            plane[slot].zero_()
            plane[:, w] &= m


def upload_columns(planes: ResidentPlanes, x, z, r, act, team, vis,
                   host_final, host_near, grid=None):
    """Stage this tick's columns on the device (and the field when its
    grid changed, the planes when dirty); returns the device columns
    (x, z, r, act, team, vis) and the device grid or None."""
    c = planes.capacity
    st = planes.stats
    if planes.dirty:
        for dev, host in ((planes.final, host_final),
                          (planes.near, host_near)):
            dev.copy_(torch.from_numpy(
                np.ascontiguousarray(host, np.uint32).view(np.int32)))
        planes.dirty = False
        st["plane_uploads"] += 1
        st["h2d_bytes"] += 2 * host_final.nbytes
    f, i = planes._h_f32, planes._h_i32
    f[0], f[1], f[2] = x, z, r
    i[0] = np.asarray(team, np.uint32).view(np.int32)
    i[1] = np.asarray(vis, np.uint32).view(np.int32)
    planes._h_act[:] = act
    if planes.cols is not planes.cols_h:
        planes.cols.copy_(planes.cols_h, non_blocking=True)
    st["h2d_bytes"] += COL_BYTES * c
    if grid is not None and (planes._grid_host is None
                             or planes._grid_host.shape != grid.shape
                             or not np.array_equal(planes._grid_host, grid)):
        planes._grid_host = np.array(grid, np.float32, copy=True)
        planes.grid = torch.from_numpy(planes._grid_host.copy()).to(
            planes.device)
        st["h2d_bytes"] += planes._grid_host.nbytes
    return planes.columns, (planes.grid if grid is not None else None)


def _wait(planes: ResidentPlanes) -> None:
    if planes.device.type == "cuda":
        torch.cuda.current_stream(planes.device).synchronize()


def fetch_changes(planes: ResidentPlanes, host_final, host_near):
    """The step's changed words per plane, ((flat index int64, new word
    np.uint32) of final, ... of near), every changed word once: the list
    prefixes, or past a list's cap the whole plane diffed against its host
    copy (a counted overflow)."""
    st = planes.stats
    cuda = planes.device.type == "cuda"
    head = min(planes.cap, PREFETCH)
    if cuda:
        planes.counts_h.copy_(planes.counts, non_blocking=True)
        for p in range(2):
            planes.lists_h[p, :head].copy_(planes.lists[p, :head],
                                           non_blocking=True)
    _wait(planes)
    counts = [int(v) for v in planes.counts_h.numpy()]
    st["d2h_bytes"] += planes.counts.nbytes + 2 * 8 * head
    words = planes.final.numel()
    for n in counts:
        if not 0 <= n <= words:
            raise RuntimeError(f"interest step: changed-word count {n} "
                               f"outside [0, {words}]")
    st["changed_words"] += sum(counts)
    rest = [(p, n) for p, n in enumerate(counts) if head < n <= planes.cap]
    for p, n in rest:
        if cuda:
            planes.lists_h[p, head:n].copy_(planes.lists[p, head:n],
                                            non_blocking=True)
        st["d2h_bytes"] += 8 * (n - head)
    if rest:
        _wait(planes)
    out = []
    for p, (n, dev, host) in enumerate(zip(
            counts, (planes.final, planes.near), (host_final, host_near))):
        if n <= planes.cap:
            e = planes.lists_h[p, :n].numpy()
            out.append((e[:, 0].astype(np.int64),
                        e[:, 1].copy().view(np.uint32)))
        else:
            new = words_to_numpy(dev).reshape(-1)
            idx = np.flatnonzero(new ^ host.reshape(-1))
            out.append((idx, new[idx]))
            st["list_overflows"] += 1
            st["d2h_bytes"] += new.nbytes
    return out


def resident_step(planes: ResidentPlanes, x, z, r, act, team, vis,
                  host_final, host_near, cfg, full: bool, grid=None):
    """One stack step on the planes' device: the changed words of both
    planes as :func:`fetch_changes` returns them -- bit-exact with
    :func:`.oracle.eval_step` diffed against ``host_final`` /
    ``host_near`` (which it leaves untouched: the stack applies the
    changes).  Raises whatever the device raises; the stack decides what
    it recovers from (engine/aoi._device_fault: injected faults only)."""
    planes.ensure(host_final.shape[0])
    cols, g = upload_columns(planes, x, z, r, act, team, vis, host_final,
                             host_near, grid if cfg.has_los else None)
    IC.interest_step(*cols, planes.final, planes.near, cfg, full, grid=g,
                     lists=planes.lists, counts=planes.counts)
    return fetch_changes(planes, host_final, host_near)
