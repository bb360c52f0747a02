"""Space-stacked cohort planes: one device step for many spaces.

Port of the JAX package's ``ops/aoi_cohort.py``.  A device bucket's
packed state already carries a leading slot axis (``[S, C, W]``), so a
slot IS a space row of a shared padded plane: stacking means routing
many small spaces into one ladder-shaped bucket, whose one step ticks
them all.  This module owns the shape discipline and the plane
pack/unpack:

* the pow2 shape ladder (:data:`DEFAULT_LADDER`): cohort capacities come
  from a short ladder (256/1024/4096), so membership churn moves spaces
  between buckets that exist instead of minting new shapes -- the set of
  capture keys is O(ladder), never O(spaces).  A space's capacity rounds
  up to its rung; the padded tail is inactive, which the predicate
  ignores bit-exactly;
* snapshot padding (:func:`pad_snapshot`): a live join rides the
  migration wire image (``engine/aoi._build_snapshot``), repacked
  losslessly to the rung (the planar word remap for pow2 ratios, the
  dense matrix otherwise), so the cohort's importer is the ordinary
  ``import_snapshot``;
* plane stack/unstack (:func:`stack_spaces` / :func:`unstack_spaces`):
  the explicit [S, shape] layout and its bit-exact round trip;
* the cohort step (:func:`cohort_step`): one step over the stacked
  planes per ``(tier, shape)``, memoized -- on CUDA tensors
  ``aoi_cuda.aoi_step_chg`` launches ``csrc/aoi_step.cu`` once for the
  whole cohort, on CPU tensors it runs the plain ``aoi_dense`` step.

Words are numpy ``uint32`` on the host and ``torch.int32`` on a device,
crossing only through ``aoi_predicate.words_to_torch`` /
``words_to_numpy``.
"""

from __future__ import annotations

import numpy as np

from . import aoi_predicate as P
from . import aoi_stage as AS
from . import dispatch_count as DC

# The pow2 shape ladder, short on purpose: every rung is a valid capacity
# (a multiple of P.LANE) and a power of two, so pad_snapshot can always
# take the planar word repack between rungs.
DEFAULT_LADDER = (256, 1024, 4096)


def validate_ladder(shapes) -> tuple[int, ...]:
    """Normalize and validate a ladder: ascending powers of two, each a
    valid capacity (a multiple of ``P.LANE``)."""
    out = tuple(int(s) for s in shapes)  # gwlint: allow[host-sync] -- config ladder ints, never device values
    if not out:
        raise ValueError("cohort ladder must not be empty")
    for s in out:
        if s & (s - 1) or s % P.LANE:
            raise ValueError(
                f"cohort shape {s} must be a power of two multiple of "
                f"{P.LANE}")
    if list(out) != sorted(set(out)):
        raise ValueError(f"cohort ladder must be strictly ascending: {out}")
    return out


def cohort_shape(capacity: int, shapes=DEFAULT_LADDER) -> int | None:
    """Smallest rung >= ``capacity``, or None (too big to stack: the space
    keeps its classic routing)."""
    for s in shapes:
        if capacity <= s:
            return s
    return None


def pad_snapshot(snap: dict, shape: int) -> dict:
    """Repack a snapshot (``engine/aoi._build_snapshot``'s format) to a
    larger rung, losslessly.  The packet stays as it is (its column
    indices are valid at the larger capacity); the words repack by the
    planar column remap for pow2 ratios and by the dense matrix
    otherwise."""
    cap = snap["capacity"]
    if shape == cap:
        return snap
    if shape < cap:
        raise ValueError(f"cannot shrink snapshot {cap} -> {shape}")
    words = snap["words"]
    ratio = shape // cap
    if shape == cap * ratio and ratio & (ratio - 1) == 0:
        c = cap
        while c < shape:
            words = P.repack_columns_double(words, c)
            c *= 2
    else:
        m = P.unpack_rows(words, cap)
        grown = np.zeros((cap, shape), bool)
        grown[:, :cap] = m
        words = P.pack_rows(grown)
    padded = np.zeros((shape, words.shape[1]), np.uint32)
    padded[:cap] = words
    r = np.zeros(shape, np.float32)
    r[:cap] = snap["r"]
    act = np.zeros(shape, bool)
    act[:cap] = snap["act"]
    return {"capacity": shape, "packet": snap["packet"], "r": r,
            "act": act, "sub": snap["sub"], "words": padded}


def _positions(snap: dict, shape: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense [shape] x/z from a snapshot's packet (its column indices are
    below the snapshot's capacity <= shape)."""
    x = np.zeros(shape, np.float32)
    z = np.zeros(shape, np.float32)
    if snap["packet"] is not None:
        _rows, cols, xv, zv = snap["packet"]
        x[cols] = xv
        z[cols] = zv
    return x, z


def stack_spaces(snaps: list[dict], shape: int) -> dict:
    """Stack per-space snapshots into cohort planes with a leading space
    axis: ``{"x", "z", "r": f32[S, shape], "act": bool[S, shape], "sub":
    bool[S], "words": u32[S, shape, W]}``.  Each space pads to ``shape``;
    the padded tail is inactive and all zero."""
    s_n = len(snaps)
    w = P.words_per_row(shape)
    planes = {"x": np.zeros((s_n, shape), np.float32),
              "z": np.zeros((s_n, shape), np.float32),
              "r": np.zeros((s_n, shape), np.float32),
              "act": np.zeros((s_n, shape), bool),
              "sub": np.zeros(s_n, bool),
              "words": np.zeros((s_n, shape, w), np.uint32)}
    for s, snap in enumerate(snaps):
        p = pad_snapshot(snap, shape)
        planes["x"][s], planes["z"][s] = _positions(snap, shape)
        planes["r"][s] = p["r"]
        planes["act"][s] = p["act"]
        planes["sub"][s] = p["sub"]
        planes["words"][s] = p["words"]
    return planes


def unstack_spaces(planes: dict, caps: list[int]) -> list[dict]:
    """Inverse of :func:`stack_spaces`: each space row cut back to its own
    capacity, bit-exactly (the padded tails are zero by construction)."""
    shape = planes["x"].shape[1]
    out = []
    for s, cap in enumerate(caps):
        if cap > shape:
            raise ValueError(f"space capacity {cap} exceeds plane {shape}")
        x = np.ascontiguousarray(planes["x"][s, :cap])
        z = np.ascontiguousarray(planes["z"][s, :cap])
        m = P.unpack_rows(planes["words"][s], shape)
        words = P.pack_rows(np.ascontiguousarray(m[:cap, :cap]))
        nz = np.nonzero((x.view(np.uint32) != 0)
                        | (z.view(np.uint32) != 0))[0]
        pkt = None
        if len(nz):
            pkt = tuple(np.ascontiguousarray(a) for a in AS.pad_packet(
                np.zeros(len(nz), np.int64), nz, x[nz], z[nz]))
        out.append({"capacity": cap, "packet": pkt,
                    "r": np.array(planes["r"][s, :cap], np.float32,
                                  copy=True),
                    "act": np.array(planes["act"][s, :cap], bool,
                                    copy=True),
                    "sub": bool(planes["sub"][s]),
                    "words": words})
    return out


# -- the cohort step ----------------------------------------------------------
#
# One step function per (tier, shape), shared by every cohort of that shape
# on that tier: re-bucketing between rungs never builds anything new.  The
# cache is filled only through _memo_step.

_STEP_CACHE: dict = {}


def _memo_step(key, fn):
    """Register a cohort step under its ``(tier, shape)`` key and hand it
    back: the single write point of the cache."""
    _STEP_CACHE[key] = fn
    return fn


def cohort_step(tier: str, shape: int):
    """The whole-cohort step of ``(tier, shape)``: stacked ``(x, z, r,
    act, prev)`` planes in (torch, words int32), ``(new, chg)`` out, one
    launch of ``csrc/aoi_step.cu`` for the whole cohort on CUDA tensors
    (its plain version on CPU tensors).  Memoized per key; callers count
    the launch with :func:`dispatch_count.record`."""
    key = (tier, shape)
    fn = _STEP_CACHE.get(key)
    if fn is not None:
        return fn
    from .aoi_cuda import aoi_step_chg

    def step(x, z, r, act, prev):
        if x.shape[-1] != shape:
            raise ValueError(f"cohort step of shape {shape} given planes "
                             f"of {x.shape[-1]}")
        return aoi_step_chg(x, z, r, act, prev)

    return _memo_step(key, step)


def run_cohort_step(tier: str, shape: int, planes: dict, device="cuda"):
    """One launch over explicit numpy planes (:func:`stack_spaces`) on
    ``device``, returning host ``(new, chg)`` uint32 arrays.  The launch
    is counted in :mod:`.dispatch_count` and its key recorded there
    (``aoi.cohort_step``)."""
    import torch

    dev = torch.device(device)
    fn = cohort_step(tier, shape)
    x, z, r = (torch.from_numpy(np.ascontiguousarray(planes[k])).to(dev)
               for k in ("x", "z", "r"))
    act = torch.from_numpy(np.ascontiguousarray(planes["act"])).to(dev)
    prev = P.words_to_torch(planes["words"], dev)
    DC.record()
    DC.record_key("aoi.cohort_step", (tier, shape, planes["x"].shape[0]))
    new, chg = fn(x, z, r, act, prev)
    return P.words_to_numpy(new), P.words_to_numpy(chg)
