"""The AOI seam of the port: where Spaces meet the GPU.

Port of the JAX package's ``engine/aoi.py``.  Each Space stages its
per-tick arrays (x, z, radius, active); the game loop calls
:meth:`AOIEngine.flush` once per tick; every bucket (one per backend and
capacity) runs one batched step for all its spaces and publishes
per-space enter/leave pairs in deterministic (observer, observed) order.

Backends (``default_backend=`` / ``create_space(backend=)``):

  * ``cuda`` (the default) -- device-resident interest state, the
    hand-written Hopper kernel (:class:`_CUDABucket`, or the mesh and
    row-sharded buckets on a ``mesh``);
  * ``cpu``  -- the numpy oracle (:mod:`..ops.aoi_oracle`), the parity
    reference;
  * ``cpp``  -- the native C++ sweep (:mod:`..ops.aoi_native`), the
    production host calculator (a warning and the numpy oracle when
    libgwaoi cannot load);
  * ``auto`` -- ``cpp`` below ``cuda_min_capacity``, ``cuda`` from there
    on: a small space finishes on the host in microseconds.

``backend`` says which calculator a space gets; ``device`` says where
the ``cuda`` backend's tensors live (``"cuda"``, or ``"cpu"`` for the
plain PyTorch versions the tests run).  Every backend gives the same
events, bit for bit.

One device bucket tick (:class:`_CUDABucket`), all of it enqueued before
the first wait:

  1. maintenance: slot resets and departed-entity clears on the packed
     state;
  2. delta staging: changed x/z entries scatter into the device-resident
     inputs (:mod:`..ops.aoi_stage`), or whole roles re-upload;
  3. the neighbor step (:func:`..ops.aoi_cuda.aoi_step_chg`: the Hopper
     kernel on CUDA tensors, its plain version on CPU tensors) gives
     ``new`` and ``chg = new ^ prev``;
  4. the subscription mask zeroes unsubscribed slots' changes;
  5. on-device compaction into (observer, observed, kind) triples
     (:func:`..ops.events.extract_triples`);
  6. one count scalar copies to pinned host memory, asynchronously.

Harvest then waits for the count, fetches the triple slice and fans it
out (:mod:`..ops.aoi_emit`).  A tick with more changes than the triple
cap is recovered from the full ``chg``/``new`` grids (counted in
``stats["decode_overflow"]``) and the cap grows.

``paged`` (:mod:`..ops.aoi_pages`) replaces steps 5-6 with the page
allocator: the changed words of each bin of 8 rows land on pages drawn
from a device-resident free list, and the harvest fetches the used page
prefix, the page table and four scalars; there is no global cap, and
the bins the pool cannot serve are re-read from the kept grids (counted
in ``stats["page_spills"]``).  The sharded buckets use the same pool to
absorb a shard whose stream overflows its caps.

Faults (:mod:`..faults`): the device buckets cross the JAX package's
seams (``aoi.grow``, ``aoi.h2d``, ``aoi.delta``, ``aoi.kernel``,
``aoi.device``, ``aoi.scalars``, ``aoi.fetch``, ``aoi.emit``, and
``aoi.pages`` when paged) at the same points, as often.  An injected
fault (:func:`_device_fault`) is recovered on the host from the durable
copies -- the input shadows and the host mirror of the words, kept
eagerly while a plan is active -- and the tick's events stay
bit-exact.  An injected fault of the calculator demotes the bucket one
level down its chain: 0 the hand kernel, 1 the plain PyTorch step on
the same device, 2 the host oracle (the device untouched).  An ``aoi.emit`` fault demotes the fan-out to the ``host``
mode.  Every demotion logs a warning, is counted in ``stats`` and
sticks until ``reset_calc_chain()`` / ``reset_emit_path()``.  Only the
plan's faults take that path: a real CUDA error (a refused launch, a
runtime error, out of memory), a build or input error and every other
exception propagate, so a failing kernel is never replaced unseen.

Interest-policy stacks (:mod:`..interest`, :meth:`AOIEngine.attach_interest`)
ride the handles: after every bucket's harvest, ``flush`` steps each
staged stack once (the ``aoi.interest`` span; one launch of
``csrc/interest_step.cu`` on the engine's device, or the numpy oracle
under ``interest_mode="host"``), and ``take_events`` returns the stack's
diff in place of the bucket's, whatever the bucket kind.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import faults
from ..ops import aoi_cuda as AK
from ..ops import aoi_dense as AD
from ..ops import aoi_emit as AE
from ..ops import aoi_pages as PG
from ..ops import aoi_predicate as P
from ..ops import aoi_stage as AS
from ..ops import dispatch_count as DC
from ..ops import events as EV
from ..ops import fused as FZ
from ..ops.aoi_oracle import CPUAOIOracle
from ..telemetry import trace as _T

_log = logging.getLogger("goworld_tpu_torch.aoi")

# triples-path extraction cap ceiling: the [max_triples, 32] bit matrix in
# extract_triples grows with it, so growth stops here and larger ticks
# take the counted full-grid recovery (decode_overflow)
_TRI_MAX = 1 << 18

# words per extraction chunk of the sharded buckets' row-stream codec
_LANES = 128

# backend names of the JAX package that the port does not have, and why
_LATER_BACKENDS = {
    "tpu": "nothing: the port's device backend is named 'cuda'",
}
BACKENDS = ("cuda", "cpu", "cpp", "auto")


# options of the JAX package's AOIEngine/Runtime and bucket methods that
# the port does not have yet, and the ROADMAP.md entry that brings each
_LATER_OPTIONS = {
    "export_snapshot": "snapshots (ROADMAP.md queue 1, item 9)",
    "import_snapshot": "snapshots (ROADMAP.md queue 1, item 9)",
    "evacuate": "failover (ROADMAP.md queue 1, item 9)",
}


def refuse_later(name: str):
    """Raise for an option or method the port does not have yet, naming
    the ROADMAP.md entry that brings it (never silently ignored)."""
    raise ValueError(f"{name} is not in the port yet; it comes with "
                     f"{_LATER_OPTIONS[name]}")


def resolve_device(device) -> torch.device:
    """The engine's torch device.  ``"cuda"`` with no CUDA device raises:
    the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch sees no CUDA device; pass "
                "device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def _check_backend(backend) -> None:
    if backend in BACKENDS:
        return
    later = _LATER_BACKENDS.get(backend)
    if later is None:
        raise ValueError(f"unknown AOI backend {backend!r} (one of "
                         f"{BACKENDS})")
    raise ValueError(f"AOI backend {backend!r} is not in the port; it "
                     f"comes with {later}")


# -- fault classification --------------------------------------------------


def _device_fault(e: BaseException) -> bool:
    """A fault the bucket recovers from on the host: an injected fault
    (:class:`..faults.InjectedFault`), and nothing else.  A real CUDA
    error (a refused launch, a runtime error, out of memory), a kernel
    library that does not build and an input the kernel's checks refuse
    all propagate: the port never falls back from a failing kernel on the
    card to its plain version or to the host."""
    return isinstance(e, faults.InjectedFault)


def _demotes(phase: str, e: BaseException) -> bool:
    """Whether a recovered fault demotes the calculator, as in the JAX
    package: any fault while the step was enqueued (``kernel``), a
    KernelFailure once it surfaced at the blocking fetch (``harvest``),
    nothing while inputs were staged."""
    return phase == "kernel" or (
        phase == "harvest" and isinstance(e, faults.KernelFailure))


def _device_lost(e: BaseException) -> bool:
    """The device is gone for good: the injected DeviceLost."""
    return isinstance(e, faults.DeviceLost)


def _calc_step(level: int, *args, out=None, **kw):
    """The step of a calculator chain level: 0 the hand kernel
    (:func:`..ops.aoi_cuda.aoi_step_chg`), 1 the plain PyTorch step on the
    same device (:func:`..ops.aoi_dense.aoi_step_chg_dense`)."""
    if level == 0:
        return AK.aoi_step_chg(*args, out=out, **kw)
    new, chg = AD.aoi_step_chg_dense(*args, **kw)
    if out is None:
        return new, chg
    out[0].copy_(new)
    out[1].copy_(chg)
    return out


def _packed_predicate(x, z, r, act, block: int = 2048) -> np.ndarray:
    """Host recomputation of one slot's packed interest words [C, W] --
    bit-exact with every device backend (all evaluate the same f32
    predicate).  Blocked over observer rows so the boolean matrix never
    materializes at O(C^2) bytes."""
    c = len(x)
    out = np.empty((c, P.words_per_row(c)), np.uint32)
    for lo in range(0, c, block):
        hi = min(lo + block, c)
        out[lo:hi] = P.pack_rows(P.interest_matrix(x, z, r, act, lo, hi))
    return out


def _batched_clear(prev_all, row_slots, row_ents, col_slots, col_words,
                   col_masks) -> None:
    """Erase departed entities' rows and columns of the packed state in
    place: all row clears, then all (pre-combined per (slot, word))
    column masks.  Index lists may repeat an entry (both operations are
    idempotent)."""
    prev_all[row_slots, row_ents, :] = 0
    cols = prev_all[col_slots, :, col_words] & col_masks[:, None]
    prev_all[col_slots, :, col_words] = cols


def _clear_words(words: np.ndarray, ents, capacity: int) -> None:
    """Departed entities' rows and columns out of host words [C, W]
    uint32, in place."""
    for ent in ents:
        words[ent] = 0
        w, b = P.word_bit_for_column(ent, capacity)
        words[:, w] &= np.uint32(~(np.uint32(1) << np.uint32(b))
                                 & 0xFFFFFFFF)


def _split_rows(tri: np.ndarray) -> dict[int, np.ndarray]:
    """(space_row, i, j) triples -> {space_row: (i, j) pairs}."""
    out: dict[int, np.ndarray] = {}
    if len(tri):
        for s in np.unique(tri[:, 0]).tolist():
            out[s] = tri[tri[:, 0] == s][:, 1:]
    return out


class _CapDecay:
    """Windowed decay of the sharded buckets' chunk-extraction caps
    (``max_chunks``, ``kcap``): growth on overflow is the owner's job;
    this tracks window peaks and proposes shrinks on a doubling window (a
    one-off mass tick must not keep storm-sized extraction buffers) and
    reports ``steady`` once the caps are final."""

    def __init__(self, nd_floor: int):
        self.nd_floor = nd_floor
        self.peak_nd = 0
        self.peak_mcc = 0
        self.flushes = 0
        self.refit_at = 8
        self.steady = False

    def reset_after_growth(self) -> None:
        self.peak_nd = self.peak_mcc = 0
        self.flushes = 0
        self.refit_at = 8
        self.steady = False

    def observe(self, nd: int, mcc: int, cur_nd: int,
                cur_k: int) -> tuple[int, int] | None:
        """Track one flush's peaks; at the window boundary return the
        shrunk ``(max_chunks, kcap)`` to adopt, or None."""
        self.peak_nd = max(self.peak_nd, nd)
        self.peak_mcc = max(self.peak_mcc, mcc)
        self.flushes += 1
        if self.flushes < self.refit_at:
            return None
        fit_nd = max(self.nd_floor, -(-self.peak_nd * 3 // 2 // 512) * 512)
        fit_k = min(max(8, 1 << (self.peak_mcc * 2 - 1).bit_length()),
                    _LANES)
        self.peak_nd = self.peak_mcc = 0
        self.flushes = 0
        self.refit_at = min(self.refit_at * 2, 128)
        if fit_nd < cur_nd or fit_k < cur_k:
            self.steady = False  # one more clean window confirms
            return min(cur_nd, fit_nd), min(cur_k, fit_k)
        self.steady = True
        return None


def _demote_emit(bucket, e: BaseException) -> None:
    """``aoi.emit`` fault: the bucket sticks to the host emit mode (its
    tick republishes through it, bit-exact) until ``reset_emit_path``."""
    bucket._emit = "host"
    bucket.stats["emit_path"] = AE.EMIT_LEVEL["host"]
    _log.warning("AOI bucket (cap %d) emit fan-out fault: %s -- demoting "
                 "to the host emit mode", bucket.capacity, e)


def _emit_expand(bucket, chg_vals, ent_vals, gidx):
    """Classified word stream -> sorted (enter, leave) (space, observer,
    observed) rows through the bucket's emit path: the C++ expansion when
    the bucket runs ``emit="native"`` (behind the ``aoi.emit`` seam: a
    fault demotes the bucket and this stream expands on the host), the
    numpy one otherwise (equal either way).  Harvest-phase numpy on
    already-fetched arrays."""
    if bucket._emit == "native" and len(chg_vals):
        try:
            faults.check("aoi.emit")
            return AE.expand_words_native(chg_vals, ent_vals, gidx,
                                          bucket.capacity)
        except Exception as e:
            # an injected fault, or the native library's own error
            if not isinstance(e, RuntimeError):
                raise
            _demote_emit(bucket, e)
    return EV.expand_classified_host(chg_vals, ent_vals, gidx,
                                     bucket.capacity)


class _TriCapDecay:
    """Windowed decay of the triples-path extraction cap: growth on
    overflow is the owner's job; this proposes post-storm shrinks on a
    doubling window (a one-off mass tick must not keep storm-sized
    extraction buffers) and reports ``steady`` once the cap is final."""

    def __init__(self, floor: int):
        self.floor = floor
        self.peak = 0
        self.flushes = 0
        self.refit_at = 8
        self.steady = False

    def reset_after_growth(self) -> None:
        self.peak = 0
        self.flushes = 0
        self.refit_at = 8
        self.steady = False

    def observe(self, count: int, cur: int) -> int | None:
        """Track one flush's triple count; at the window boundary return
        the shrunk cap to adopt, or None."""
        self.peak = max(self.peak, count)
        self.flushes += 1
        if self.flushes < self.refit_at:
            return None
        fit = max(self.floor,
                  1 << (max(self.peak * 3 // 2, 1) - 1).bit_length())
        self.peak = 0
        self.flushes = 0
        self.refit_at = min(self.refit_at * 2, 128)
        if fit < cur:
            self.steady = False  # one more clean window confirms
            return fit
        self.steady = True
        return None


class _PageDecay(_TriCapDecay):
    """Windowed decay of the paged pool size (``n_pages``), the
    triple cap's story: growth on a spill is the owner's job, bounded by
    :func:`..ops.aoi_pages.pool_ceiling` (a pool there never spills);
    this proposes post-storm shrinks and reports ``steady`` once the pool
    size is final."""


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a device tensor that never makes the host wait: on
    a CUDA device an asynchronous copy into pinned memory (read it after
    an event recorded behind it), on the CPU a clone."""
    if t.device.type != "cuda":
        return t.clone()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def _grid_stream(chg: torch.Tensor, new: torch.Tensor):
    """The classified stream of a kept (chg, new) word grid on its
    device: (gidx, chg_vals, ent_vals), ascending flat order; only the
    nonzero words cross to the host."""
    flat = chg.reshape(-1)
    gi = torch.nonzero(flat).reshape(-1)
    cv = flat[gi]
    ev = cv & new.reshape(-1)[gi]
    return (gi.cpu().numpy(), cv.cpu().numpy().view(np.uint32),
            ev.cpu().numpy().view(np.uint32))


class PageTableCorrupt(faults.InjectedFault):
    """The page table an ``aoi.pages`` poison corrupted failed validation:
    the free list is distrusted and the tick recovers on the host."""


def _page_table_bad(n_used: int, n_pages: int, injected: bool):
    """A fetched page table failed validation.  Corrupted by the plan's
    ``poison``: the recoverable :class:`PageTableCorrupt`.  Otherwise the
    allocator is wrong, and that propagates (the port never hides a
    fault of its device path)."""
    msg = (f"aoi.pages page table failed validation (n_used={n_used}, "
           f"n_pages={n_pages})")
    if injected:
        return PageTableCorrupt("RESOURCE_EXHAUSTED: " + msg)
    return RuntimeError(msg + ": the allocator's output is corrupt")


def _ensure_pool(bk, nw: int, device) -> int:
    """Size a bucket's page pool (``_n_pages``, the device free list
    ``_page_free``, the decay ``_pages``) for a grid of ``nw`` words: the
    first call seeds the decay's floor; the pool is the larger of its
    current size and the floor (so a preset floor sizes it), and a size
    change resets the free list to ``arange``.  The list follows the grid
    to its device (the shards of a mesh share one pool).  Returns
    ``n_pages``."""
    if bk._pages is None:
        bk._pages = _PageDecay(floor=PG.pool_floor(nw))
    want = max(bk._n_pages, bk._pages.floor)
    if bk._page_free is None or bk._page_free.shape[0] != want:
        bk._n_pages = want
        bk._page_free = torch.arange(want, dtype=torch.int32, device=device)
    elif bk._page_free.device != device:
        bk._page_free = bk._page_free.to(device)
    return bk._n_pages


def _grow_pool(bk, nw: int, bw: int, full: bool = False) -> None:
    """Re-arm a bucket's pool after a spill: double it, bounded by
    :func:`..ops.aoi_pages.pool_ceiling` (a pool there never spills), or
    with ``full`` (a whole-tick spill past ``MAX_SPILL`` bins: the pool is
    far too small) go to the ceiling at once; the free list resets at the
    next allocation and :class:`_PageDecay` shrinks the pool back after
    the storm."""
    ceil_p = PG.pool_ceiling(nw, bw)
    grown = ceil_p if full else min(ceil_p, max(bk._n_pages * 2, 64))
    if grown > bk._n_pages:
        bk._n_pages = grown
        bk._page_free = None
    bk._pages.reset_after_growth()


def _paged_absorb_shard(bk, chg: torch.Tensor, new: torch.Tensor, W: int):
    """Absorb one shard's stream overflow through the paged pool (the
    sharded buckets with ``paged``; the JAX package's
    ``_paged_absorb_chip``): instead of growing the stream caps and
    fetching the shard's full grids, compact its kept (chg, new) grids
    into pages on the device and fetch the used prefix, plus any spilled
    bins (counted in ``page_spills``).  The bucket's pool state
    (``_n_pages``, ``_page_free``, ``_pages``) persists across shards and
    ticks; ``aoi.pages`` is crossed once per absorbed shard: ``oom`` /
    ``fail`` / ``partial`` spill the whole shard and re-arm the pool,
    ``poison`` corrupts the fetched table, which validation catches (a
    whole-shard spill, the free list reset: counted in ``poisoned``).

    Returns the shard's classified stream ``(gidx, chg_vals, ent_vals)``
    with shard-local flat word indices, equal (up to order) to the raw
    grids' stream it replaces."""
    nw = chg.numel()
    bw = PG.bin_words_for(W)
    n_pages = _ensure_pool(bk, nw, chg.device)

    def whole_shard(why):
        bk.stats["page_spills"] += 1
        bk._page_free = None
        bk._pages.reset_after_growth()
        _log.warning("AOI page pool unusable for this shard (%s); "
                     "spilling its whole grid to the host and re-arming "
                     "the pool", why)
        return _grid_stream(chg, new)

    try:
        spec = faults.check("aoi.pages")
    except Exception as e:
        if not _device_fault(e):
            raise
        return whole_shard(e)
    if spec is not None and spec.kind == "partial":
        return whole_shard("partial allocation")
    pg, pc, pn, tab, free_next, sb, scal = PG.allocate_pages(
        chg, new, bk._page_free, PG.PAGE_WORDS, bw, PG.MAX_SPILL)
    bk._page_free = free_next
    n_used, n_spill = (int(v) for v in scal[:2].cpu().numpy())
    tab_h = tab.cpu().numpy()
    poisoned = spec is not None and spec.kind == "poison"
    if poisoned:
        tab_h = np.full_like(tab_h, np.iinfo(np.int32).min)
    if not (0 <= n_used <= n_pages and 0 <= n_spill <= -(-nw // bw)
            and PG.validate_page_table(tab_h, n_used, n_pages)):
        e = _page_table_bad(n_used, n_pages, poisoned)
        if not poisoned:
            raise e
        bk.stats["poisoned"] += 1
        return whole_shard(e)
    gidx, chg_vals, new_vals = PG.decode_pages(
        *(a[:n_used].cpu().numpy() for a in (pg, pc, pn)))
    gidx = gidx.astype(np.int64)
    if n_spill:
        # hotter than the pool: the spilled bins from the kept grids, and
        # the pool grows so the next storm tick absorbs on the device
        bk.stats["page_spills"] += n_spill
        sg, sc, sn = PG.spill_stream(chg.reshape(-1), new.reshape(-1),
                                     sb.cpu().numpy(), bw, nw)
        gidx = np.concatenate([gidx, sg])
        chg_vals = np.concatenate([chg_vals, sc])
        new_vals = np.concatenate([new_vals, sn])
        _grow_pool(bk, nw, bw)
    else:
        shrink = bk._pages.observe(n_used, n_pages)
        if shrink is not None:
            bk._n_pages = shrink
            bk._page_free = None
    bk.stats["page_occupancy"] = n_used / max(n_pages, 1)
    return gidx, chg_vals, chg_vals & new_vals


@dataclass(eq=False)
class SpaceAOIHandle:
    backend: str        # resolved: cuda | cpu | cpp
    capacity: int
    bucket: "_Bucket"
    slot: int
    released: bool = False
    # the backend as requested (may be "auto"); growth re-resolves it, so
    # a space that grows past the routing threshold moves to the device
    requested: str = ""
    # the attached interest-policy stack (AOIEngine.attach_interest)
    _policy_stack: object = None


class AOIEngine:
    """Per-process registry of AOI state, one bucket per (backend,
    capacity).

    ``device``: where the ``cuda`` backend's tensors live -- ``"cuda"``
    (default; raises without a GPU) or ``"cpu"`` (the plain PyTorch step,
    what the tests run).  ``default_backend`` (``cuda`` | ``cpu`` | ``cpp``
    | ``auto``): which calculator a space gets (module docstring);
    ``oracle_algorithm`` the numpy oracle's enumeration (``sweep`` |
    ``pairwise``); ``cuda_min_capacity`` the ``auto`` routing threshold.
    ``delta_staging`` ships sparse x/z packets instead of whole input
    arrays; ``flush_sched`` dispatches every bucket before the first
    harvest (False: each bucket dispatches and harvests in turn); ``emit``
    picks the fan-out (``auto`` | ``native`` | ``vector`` | ``host``).

    ``mesh`` (a :class:`..parallel.SpaceMesh`, or a device count for that
    many distinct CUDA devices) puts the ``cuda`` backend on several
    shards, as the JAX package routes (``engine/aoi.py`` ``create_space``):
    a space of capacity at least ``rowshard_min_capacity`` and a multiple
    of ``n_shards * 128`` gets its own row-sharded bucket
    (:mod:`.aoi_rowshard`), every other space the mesh bucket of its
    capacity (:mod:`.aoi_mesh`).  The mesh's devices must be of
    ``device``'s type.

    ``pipeline`` and ``cross_tick`` each request the same one-tick
    deferral (either flag, or both, shifts delivery by exactly one tick):
    a flush dispatches tick T and delivers tick T-1, whose count and an
    optimistic slice of its triples were copied to the host while the
    host ran the tick between; :meth:`drain` delivers the tick still in
    flight.  The row-sharded bucket accepts them and stays synchronous.
    ``fused`` runs each eligible steady tick of the single-device bucket
    as one CUDA graph replay (:mod:`..ops.fused`); the sharded buckets
    accept it and run unfused.  ``paged`` compacts the change stream
    into pages from an on-device free list (:mod:`..ops.aoi_pages`): the
    single-device bucket's tick in place of the capped triples, and the
    sharded buckets' absorber of a shard whose stream overflows its caps
    (no cap growth, no ``decode_overflow``); what the pool cannot serve
    spills to the host, counted in ``stats["page_spills"]``.

    ``interest_mode`` (``device`` | ``host``) is where an attached
    interest-policy stack evaluates: on ``device`` (the hand kernel on a
    CUDA device, its plain version on the CPU) or on the numpy oracle."""

    def __init__(self, device="cuda", default_backend: str = "cuda",
                 oracle_algorithm: str = "sweep",
                 cuda_min_capacity: int = 4096, delta_staging: bool = True,
                 flush_sched: bool = True, emit: str = "auto", mesh=None,
                 rowshard_min_capacity: int = 65536, pipeline: bool = False,
                 cross_tick: bool = False, fused: bool = False,
                 paged: bool = False, interest_mode: str = "device"):
        _check_backend(default_backend)
        if interest_mode not in ("device", "host"):
            raise ValueError(
                f"interest_mode must be device|host, got {interest_mode!r}")
        self.interest_mode = interest_mode
        # handles with an interest stack, in attach order (flush steps
        # their stacks in this order: the aoi.interest seam's crossings)
        self._stacked: list[SpaceAOIHandle] = []
        self.default_backend = default_backend
        self.oracle_algorithm = oracle_algorithm
        self.cuda_min_capacity = cuda_min_capacity
        self.pipeline = bool(pipeline)
        self.cross_tick = bool(cross_tick)
        self.fused = bool(fused)
        self.paged = bool(paged)
        self.device = resolve_device(device)
        if isinstance(mesh, int):
            from ..parallel import SpaceMesh, multichip_devices

            mesh = SpaceMesh(multichip_devices(mesh))
        if mesh is not None and mesh.platform != self.device.type:
            raise ValueError(f"a {mesh.platform} mesh on a {self.device.type} "
                             f"engine: pass device={mesh.platform!r}")
        self.mesh = mesh
        self.rowshard_min_capacity = rowshard_min_capacity
        self._rowshard_serial = 0
        if emit != "auto" and emit not in AE.EMIT_MODES:
            raise ValueError(
                f"aoi_emit must be one of {('auto',) + AE.EMIT_MODES}, "
                f"got {emit!r}")
        self.emit = emit
        self._emit_resolved: str | None = None
        self.delta_staging = delta_staging
        self.flush_sched = flush_sched
        # (kind, capacity or serial) -> bucket; kinds "cpp", "cpu",
        # "cuda", "mesh", "rowshard" (one exclusive bucket per space)
        self._buckets: dict[tuple, _Bucket] = {}

    def _resolve_emit(self) -> str:
        """Resolve the requested emit mode once (resolution may build
        libgwemit with make; it must not flap per bucket)."""
        if self._emit_resolved is None:
            self._emit_resolved = AE.resolve_mode(self.emit)
        return self._emit_resolved

    def _modes(self) -> dict:
        return {"pipeline": self.pipeline, "cross_tick": self.cross_tick,
                "fused": self.fused, "paged": self.paged}

    def create_space(self, capacity: int,
                     backend: str | None = None) -> SpaceAOIHandle:
        requested = backend or self.default_backend
        _check_backend(requested)
        capacity = P.round_capacity(capacity)
        backend = requested
        if backend == "auto":
            # capacity routing: a tiny space is dispatch-bound on the
            # card, the native sweep finishes it in microseconds
            backend = ("cuda" if capacity >= self.cuda_min_capacity
                       else "cpp")
        mesh = self.mesh
        if backend in ("cpu", "cpp"):
            key = (backend, capacity)
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = self._host_bucket(backend,
                                                                capacity)
        elif (mesh is not None and capacity >= self.rowshard_min_capacity
                and capacity % (mesh.n_devices * 128) == 0):
            # oversized single space: its interest rows shard over the
            # mesh, in a bucket of its own, freed with the space
            from .aoi_rowshard import _RowShardCUDABucket

            bucket = _RowShardCUDABucket(capacity, mesh,
                                         delta_staging=self.delta_staging,
                                         emit=self._resolve_emit(),
                                         **self._modes())
            self._rowshard_serial += 1
            self._buckets[("rowshard", self._rowshard_serial)] = bucket
        else:
            key = ("cuda" if mesh is None else "mesh", capacity)
            bucket = self._buckets.get(key)
            if bucket is None:
                if mesh is None:
                    bucket = _CUDABucket(capacity, self.device,
                                         delta_staging=self.delta_staging,
                                         emit=self._resolve_emit(),
                                         **self._modes())
                else:
                    from .aoi_mesh import _MeshCUDABucket

                    bucket = _MeshCUDABucket(
                        capacity, mesh, delta_staging=self.delta_staging,
                        emit=self._resolve_emit(), **self._modes())
                self._buckets[key] = bucket
        slot = bucket.acquire_slot()
        return SpaceAOIHandle(backend, capacity, bucket, slot,
                              requested=requested)

    def _host_bucket(self, backend: str, capacity: int) -> "_CPUBucket":
        if backend == "cpp":
            from ..ops import aoi_native

            if aoi_native.available():
                # "auto": grid candidate binning where the layout allows
                # it, the sweep otherwise (bit-exact either way)
                return _CPUBucket(capacity, "auto",
                                  oracle_cls=aoi_native.NativeAOIOracle)
            _log.warning("libgwaoi.so unavailable (no C++ toolchain?); "
                         "aoi_backend=cpp falls back to the numpy oracle")
        return _CPUBucket(capacity, self.oracle_algorithm)

    def release_space(self, h: SpaceAOIHandle) -> None:
        if not h.released:
            h.bucket.release_slot(h.slot)
            h.released = True
            if h in self._stacked:
                self._stacked.remove(h)
            if getattr(h.bucket, "exclusive", False):
                # a row-sharded space's bucket frees with it
                for k, b in list(self._buckets.items()):
                    if b is h.bucket:
                        del self._buckets[k]

    def submit(self, h: SpaceAOIHandle, x, z, radius, active) -> None:
        """Stage one space's tick inputs (numpy arrays of length <=
        capacity)."""
        if h.released:
            raise ValueError("space AOI handle already released")
        h.bucket.stage(h.slot, (x, z, radius, active))

    def flush(self) -> None:
        """Execute all staged steps (one kernel launch per bucket); the
        results are then available per space via :meth:`take_events` (one
        tick late under ``pipeline``/``cross_tick``).

        Split-phase: every bucket dispatches (maintenance, staging, kernel,
        compaction and the async count copy -- no waits; a host bucket
        computes here) before the first harvest blocks, so bucket N+1's
        device work overlaps bucket N's host decode.  Buckets go in key
        order (kind, capacity), so the order in which fault seams are
        crossed does not depend on the order spaces were created.
        ``flush_sched=False`` runs each bucket's dispatch and harvest
        before the next starts."""
        buckets = [self._buckets[k] for k in sorted(self._buckets)]
        if not self.flush_sched:
            for bucket in buckets:
                bucket.dispatch()
                bucket.harvest()
        else:
            for bucket in buckets:
                bucket.dispatch()
            for bucket in buckets:
                bucket.harvest()
        for bucket in buckets:
            if getattr(bucket, "_evacuating", False) \
                    and not bucket._evacuation_noted:
                # the JAX engine rebuilds a lost device's spaces onto a
                # fresh bucket here (_evacuate_bucket); the port keeps
                # serving them from the host at calc level 2
                bucket._evacuation_noted = True
                _log.warning(
                    "AOI bucket (cap %d) lost its device; its spaces stay "
                    "on the host oracle (calc level 2): evacuation to a "
                    "fresh bucket comes with snapshots (ROADMAP.md queue "
                    "1, item 9)", bucket.capacity)
        # interest-policy stacks evaluate LAST, after every bucket's
        # harvest: each staged stack runs one step and accumulates its
        # enter/leave diff for take_events (in the flush that submitted
        # it, whatever the bucket's deferral)
        staged = [h for h in self._stacked if h._policy_stack.has_pending]
        if staged:
            with _T.span("aoi.interest"):
                for h in staged:
                    h._policy_stack.step()

    def has_pending(self) -> bool:
        """True when a bucket holds a dispatched-but-undelivered tick (the
        runtime keeps flushing until it is delivered)."""
        return any(getattr(self._buckets[k], "_inflight", None) is not None
                   for k in sorted(self._buckets))

    def drain(self) -> None:
        """Deliver every tick still in flight without dispatching a new
        one (shutdown, state carry-over, tests); buckets in key order."""
        for k in sorted(self._buckets):
            self._buckets[k].drain()

    def take_events(self, h: SpaceAOIHandle):
        """(enter_pairs, leave_pairs) for this space from the last flush."""
        stack = h._policy_stack
        if stack is not None:
            # the stack owns the stream: drop the bucket's base-predicate
            # diff (the bucket still computes and carries the base state)
            h.bucket.take_events(h.slot)
            return stack.take_events()
        return h.bucket.take_events(h.slot)

    def set_subscribed(self, h: SpaceAOIHandle, flag: bool) -> None:
        """Opt a space in/out of the per-tick event stream: an opted-out
        slot's changes are masked before compaction, so its extraction,
        fetch and decode cost nothing; its interest state stays in the
        packed words, derived on demand."""
        h.bucket.set_subscribed(h.slot, flag)

    def clear_entity(self, h: SpaceAOIHandle, entity_slot: int) -> None:
        """Erase one entity's row and column from the space's
        previous-tick interest state (the runtime severs departing
        entities' pairs synchronously, so the diff must not re-emit them,
        and a reused slot must start clean)."""
        h.bucket.clear_entity(h.slot, entity_slot)
        if h._policy_stack is not None:
            h._policy_stack.clear_entity(entity_slot)

    def grow_space(self, h: SpaceAOIHandle,
                   new_capacity: int) -> SpaceAOIHandle:
        """Move a space to a larger-capacity bucket, carrying its interest
        state so the growth itself emits no enter/leave events."""
        new_capacity = P.round_capacity(new_capacity)
        if new_capacity <= h.capacity:
            raise ValueError("grow_space requires a larger capacity")
        nh = self.create_space(new_capacity, h.requested or h.backend)
        target = nh.capacity
        # get_prev delivers the old bucket's tick in flight first, so its
        # events land in _events and move with the space below
        old_words = h.bucket.get_prev(h.slot)
        ratio = target // h.capacity
        if target == h.capacity * ratio and ratio & (ratio - 1) == 0:
            # power-of-two growth: packed word-level column remap
            cap = h.capacity
            words = old_words
            while cap < target:
                words = P.repack_columns_double(words, cap)
                cap *= 2
            packed = np.zeros((target, words.shape[1]), np.uint32)
            packed[: h.capacity] = words
        else:
            m = P.unpack_rows(old_words, h.capacity)
            grown = np.zeros((target, target), bool)
            grown[: h.capacity, : h.capacity] = m
            packed = P.pack_rows(grown)
        nh.bucket.set_prev(nh.slot, packed)
        # carry undelivered events: growth can happen between flush() and
        # dispatch_aoi_events() (an on_enter_aoi hook spawning entities)
        pending = h.bucket._events.pop(h.slot, None)
        if pending is not None:
            nh.bucket._events[nh.slot] = pending
        stack = h._policy_stack
        if stack is not None:
            # the interest stack grows with the space: the same planar
            # column remap as the base carry above, then it rides the
            # new handle (in the old one's place in the step order)
            stack.grow(target)
            nh._policy_stack = stack
            h._policy_stack = None
            self._stacked[self._stacked.index(h)] = nh
        self.release_space(h)
        return nh

    def attach_interest(self, h: SpaceAOIHandle, policies,
                        mode: str | None = None):
        """Attach a composable interest-policy stack to a space
        (:mod:`..interest`): from here on the stack's step -- radius AND
        team mask AND tier cadence AND line of sight -- owns the space's
        event stream (:meth:`take_events` returns the stack's diff),
        while the base bucket keeps carrying the radius state.  The stack
        steps on the engine's device (``mode``, default
        ``interest_mode``)."""
        from ..interest import PolicyStack

        if h._policy_stack is not None:
            raise ValueError("space already has an interest stack")
        stack = PolicyStack(h.capacity, policies,
                            mode=mode or self.interest_mode,
                            device=self.device)
        h._policy_stack = stack
        self._stacked.append(h)
        return stack

    @staticmethod
    def interest_stack(h: SpaceAOIHandle):
        """The space's PolicyStack, or None (plain radius-only space)."""
        return h._policy_stack


class _Bucket:
    """Slot-managed batch of spaces sharing a backend and capacity."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.W = P.check_capacity(capacity)
        self.n_slots = 0
        self._free: list[int] = []
        self._staged: dict[int, tuple] = {}
        self._events: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def acquire_slot(self) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            slot = self.n_slots
            self.n_slots += 1
            self._grow_to(self.n_slots)
        self._reset_slot(slot)
        return slot

    def release_slot(self, slot: int) -> None:
        self._free.append(slot)
        self._staged.pop(slot, None)
        self._events.pop(slot, None)

    def stage(self, slot: int, staged: tuple) -> None:
        self._staged[slot] = staged

    def take_events(self, slot: int):
        return self._events.pop(slot, (np.empty((0, 2), np.int32),) * 2)

    def set_subscribed(self, slot: int, flag: bool) -> None:
        """Event-stream subscription (default: subscribed).  Host buckets
        ignore it: their events are a free by-product of the sweep."""

    def reset_emit_path(self) -> None:
        """Re-arm the configured emit mode after an ``aoi.emit`` demotion
        (an operator action: demotion sticks, so a flapping native layer
        cannot oscillate).  No-op for host buckets, which have no emit
        seam."""
        req = getattr(self, "_emit_requested", None)
        if req is not None:
            self._emit = req
            self.stats["emit_path"] = AE.EMIT_LEVEL[req]

    def dispatch(self) -> None:
        """Phase 1 of the split flush.  A host bucket computes its whole
        tick here, so its harvest is a no-op."""
        self.flush()

    def harvest(self) -> None:
        """Phase 2 of the split flush (no-op for a host bucket)."""

    def drain(self) -> None:
        """Deliver a tick still in flight (no-op for a synchronous
        bucket)."""
        self.harvest()

    def peek_words(self, slot: int) -> np.ndarray | None:
        """The slot's interest words [C, W] without a device round trip,
        or None when no cheap host copy exists (the caller then asks
        :meth:`get_prev`)."""
        return None

    # subclass API
    def flush(self) -> None:
        raise NotImplementedError

    def get_prev(self, slot: int) -> np.ndarray:
        raise NotImplementedError

    def set_prev(self, slot: int, words: np.ndarray) -> None:
        raise NotImplementedError

    def clear_entity(self, slot: int, entity_slot: int) -> None:
        raise NotImplementedError

    def _grow_to(self, n_slots: int) -> None:
        raise NotImplementedError

    def _reset_slot(self, slot: int) -> None:
        raise NotImplementedError


class _CPUBucket(_Bucket):
    """Host bucket: one oracle per slot -- ``oracle_cls`` the numpy oracle
    (the parity reference) or the native C++ sweep
    (:class:`..ops.aoi_native.NativeAOIOracle`, the production host
    calculator).  Its tick runs whole in :meth:`flush`."""

    def __init__(self, capacity: int, algorithm: str,
                 oracle_cls=CPUAOIOracle):
        super().__init__(capacity)
        self.algorithm = algorithm
        self._oracle_cls = oracle_cls
        self._oracles: list = []
        # cumulative seconds of the calculators' steps
        self.perf = {"calc_s": 0.0}

    def _grow_to(self, n_slots: int) -> None:
        while len(self._oracles) < n_slots:
            self._oracles.append(self._oracle_cls(self.capacity,
                                                  self.algorithm))

    def _reset_slot(self, slot: int) -> None:
        self._oracles[slot].reset()

    def flush(self) -> None:
        t0 = time.perf_counter()
        for slot, (x, z, r, act) in self._staged.items():
            self._events[slot] = self._oracles[slot].step(x, z, r, act)
        self._staged.clear()
        self.perf["calc_s"] += time.perf_counter() - t0

    def peek_words(self, slot: int) -> np.ndarray:
        return self._oracles[slot].prev_words

    def get_prev(self, slot: int) -> np.ndarray:
        return self._oracles[slot].prev_words.copy()

    def set_prev(self, slot: int, words: np.ndarray) -> None:
        self._oracles[slot].prev_words = np.asarray(words, np.uint32).copy()

    def clear_entity(self, slot: int, entity_slot: int) -> None:
        _clear_words(self._oracles[slot].prev_words, (entity_slot,),
                     self.capacity)


class _CalcChain:
    """The calculator chain's bookkeeping, shared by the device buckets:
    the level (0 the hand kernel, 1 the plain PyTorch step on the same
    device, 2 the host oracle), the phase a fault surfaced in, the fault
    counters and the lost-device state.  Only an injected fault reaches
    it (:func:`_device_fault`)."""

    _kind = "AOI bucket"  # the warnings' name for the bucket

    def _init_chain(self) -> None:
        self._ft = faults.active()  # keep the durable copies eagerly
        self._calc_level = 0
        self._fault_phase = "stage"
        # a level-2 tick, computed on the host at harvest
        self._oracle = None
        # the device is lost (injected DeviceLost): level 2 for good,
        # noted once by the engine
        self._evacuating = False
        self._evacuation_noted = False

    def _count_fault(self, e: BaseException) -> None:
        """Count a recovered fault and demote the calculator one level
        when the fault is the calculator's (:func:`_demotes`), loudly."""
        self.stats["rebuilds"] += 1
        if _demotes(self._fault_phase, e) and self._calc_level < 2:
            self._calc_level += 1
            self.stats["fallbacks"] += 1
            self.stats["calc_level"] = self._calc_level
        _log.warning("%s (cap %d) device fault during %s: %s -- recovering "
                     "the tick on the host (calc level %d)", self._kind,
                     self.capacity, self._fault_phase, e, self._calc_level)

    def _mark_evacuating(self) -> None:
        """The device is lost: never touch it again.  The host oracle (calc
        level 2) keeps serving bit-exact ticks from the durable copies."""
        self._evacuating = True
        self._calc_level = 2
        self.stats["calc_level"] = 2

    def reset_calc_chain(self) -> None:
        """Re-arm the hand kernel after a demotion (an operator action:
        demotion sticks, so a flapping device cannot oscillate)."""
        self._calc_level = 0
        self.stats["calc_level"] = 0
        self._rearm()

    def _rearm(self) -> None:
        """What the bucket readies for the kernel's return."""


class _Deferred(_CalcChain):
    """The flush schedule and the fault recovery of a device bucket with a
    host mirror (the single-device and the mesh buckets).

    Schedule.  The bucket sets ``pipeline``, ``cross_tick``, ``_inflight``
    (the record parked across flushes) and ``_due`` (the record the next
    harvest() delivers), and provides ``_dispatch_tick()`` (enqueue one
    tick: its record, or None when nothing was staged) and
    ``_harvest(rec)``.

    Recovery (the JAX package's ``_recover`` / ``_recover_harvest`` /
    ``_host_tick``).  The durable copies are the input shadows
    (``_hx``/``_hz``/``_hr``/``_hact``/``_hsub``, bitwise equal to the
    device inputs) and the mirror (the host copy of the words, kept
    eagerly while a fault plan is active).  On a device fault at dispatch
    the record in flight delivers, the faulted tick is computed on the
    host from (mirror, shadows) -- bit-exact: the host predicate is the
    device's and ``np.nonzero``'s ascending order is the extraction's --
    and the device state drops; the next dispatch re-uploads the words
    from the mirror.  A fault at harvest regenerates the lost record's
    events the same way (deferred, coalesced with the record dispatched
    after it).  Deferred, a host tick parks as a synthetic ``host``
    record, so the one-tick cadence holds.  The bucket provides
    ``_drop_device()``, ``_prev_to_numpy()``, ``_upload_prev(words)``,
    ``_restage_shadows()`` and ``_check_restaged()``."""

    def _init_faults(self) -> None:
        self._init_chain()
        self._need_rebuild = False  # words dropped: re-upload next dispatch
        self._cur_slots: list[int] = []

    @property
    def _defer(self) -> bool:
        """One-tick deferral in effect: ``pipeline`` and ``cross_tick``
        request the same mechanics, so any combination is one shift."""
        return self.pipeline or self.cross_tick

    def flush(self) -> None:
        """Dispatch immediately followed by harvest."""
        self.dispatch()
        self.harvest()

    def dispatch(self) -> None:
        """Phase 1: enqueue the staged tick without waiting on the device.
        Deferred, tick T parks and T-1's record becomes due (a flush with
        nothing new delivers the parked record).  At calc level 2 the
        tick is computed on the host, at harvest."""
        if self._due is not None or self._oracle is not None:
            # re-entrant flush (get_prev mid-scheduler): deliver what is
            # already due first
            self.harvest()
        if self._calc_level >= 2:
            # maintenance already reached the mirror when it was issued
            self._pending_reset.clear()
            self._pending_clear.clear()
            if self._staged:
                self._oracle = self._restage_shadows()
                self._check_restaged()
            self._due, self._inflight = self._inflight, None
            return
        try:
            rec = self._dispatch_tick()
        except Exception as e:
            if not _device_fault(e):
                raise
            self._recover(e)
            if _device_lost(e):
                self._mark_evacuating()
            return
        if self._defer:
            self._due, self._inflight = self._inflight, rec
        else:
            self._due = rec

    def harvest(self) -> None:
        """Phase 2: deliver the record dispatch() made due (and compute a
        level-2 tick on the host)."""
        rec, self._due = self._due, None
        if rec is not None:
            self._deliver(rec)
        slots, self._oracle = self._oracle, None
        if slots is not None:
            self._host_tick(slots)

    def drain(self) -> None:
        """Deliver the record in flight without dispatching a new one."""
        self.harvest()
        rec, self._inflight = self._inflight, None
        if rec is not None:
            self._deliver(rec)

    def _deliver(self, rec: dict) -> None:
        """Harvest one record; a device fault surfacing there (a kernel
        error materializes at the blocking fetch) recovers on the host."""
        self._fault_phase = "harvest"
        try:
            self._harvest(rec)
        except Exception as e:
            if not _device_fault(e):
                raise
            self._recover_harvest(e, rec)
            if _device_lost(e):
                self._mark_evacuating()

    def _check_restaged(self) -> None:
        """Refuse a tick the bucket cannot step (the mesh's seeded-but-
        unstaged slots); nothing for the single-device bucket."""

    # -- the calculator chain ------------------------------------------------

    def _mark_evacuating(self) -> None:
        super()._mark_evacuating()
        self._need_rebuild = False  # there is no device to rebuild onto

    def _rearm(self) -> None:
        if self.prev is None and self.s_max:
            self._ensure_mirror()
            self._need_rebuild = True

    def _rebuild_device(self) -> None:
        """Re-upload the words from the mirror after a recovery (at the
        next dispatch, so a dead device is retried at tick cadence)."""
        if not self._need_rebuild:
            return
        self._need_rebuild = False
        self._upload_prev(self._mirror)
        self.stats["h2d_bytes"] += self._mirror.nbytes

    def _ensure_mirror(self) -> None:
        """Make the mirror exist: zeros with no device words, else a fetch
        of the words; if the device cannot be read, the predicate of the
        input shadows (exact for every slot whose words are the predicate
        of its last staged inputs; seeded-then-unstepped slots lose their
        seed, loudly)."""
        if self._mirror is not None:
            return
        try:
            self._mirror = (
                np.zeros((self.s_max, self.capacity, self.W), np.uint32)
                if self.prev is None else self._prev_to_numpy())
        except Exception as e:  # the device is unreadable: any error
            _log.warning("device words unreadable during recovery (%s); "
                         "rebuilding the mirror from the input shadows", e)
            m = np.empty((self.s_max, self.capacity, self.W), np.uint32)
            for s in range(self.s_max):
                m[s] = _packed_predicate(self._hx[s], self._hz[s],
                                         self._hr[s], self._hact[s])
            self._mirror = m

    def _refresh_stale_rows(self) -> None:
        """Recompute mirror rows that went stale while unsubscribed: a
        slot's words are the predicate of its last staged inputs."""
        for s in sorted(self._mirror_stale):
            self._mirror[s] = _packed_predicate(
                self._hx[s], self._hz[s], self._hr[s], self._hact[s])
        self._mirror_stale.clear()

    def _land_maintenance(self) -> None:
        """Land queued resets and clears on the mirror (idempotent) and
        drop them from the device queues."""
        for s in sorted(self._pending_reset):
            self._mirror[s] = 0
        for s, ent in self._pending_clear:
            self._mirror_clear(s, ent)
        self._pending_reset.clear()
        self._pending_clear.clear()

    def _recover(self, e: BaseException) -> None:
        """Device fault at dispatch: deliver the record in flight, compute
        the faulted tick on the host, drop the device state.  A fault
        while inputs were staged (an upload's out-of-memory) rebuilds
        without demoting the calculator (:func:`_demotes`)."""
        self._count_fault(e)
        rec, self._inflight = self._inflight, None
        if rec is not None:
            try:
                self._harvest(rec)
            except Exception as he:  # the device died mid-harvest too
                _log.warning("record in flight unharvestable during "
                             "recovery (%s); its events are lost", he)
        self._ensure_mirror()
        self._land_maintenance()
        slots = self._restage_shadows() if self._staged else self._cur_slots
        self._cur_slots = []
        self._drop_device()
        self._need_rebuild = self._calc_level < 2
        if slots:
            self._host_tick(slots)

    def _recover_harvest(self, e: BaseException, rec: dict) -> None:
        """Device fault at harvest.  The mirror still holds the words
        before the record's tick and the shadows the newest inputs, so
        one host pass regenerates the lost events, published at once (in
        place of the record's delivery); deferred, the record dispatched
        after it is folded in."""
        self._count_fault(e)
        if rec.get("host"):
            self._publish(rec["slots"], rec["epochs"], *rec["payload"])
            rec_slots: list[int] = []
        else:
            rec_slots = rec["slots"]
        newest, self._inflight = self._inflight, None
        host_rec = None
        if newest is not None:
            if newest.get("host"):
                host_rec = newest  # its mirror effects already landed
            else:
                rec_slots = sorted(set(rec_slots) | set(newest["slots"]))
        self._ensure_mirror()
        self._apply_mirror_ops()
        self._land_maintenance()
        if self._staged:  # inputs staged between the phases
            rec_slots = sorted(set(rec_slots) | set(self._restage_shadows()))
        self._cur_slots = []
        self._drop_device()
        self._need_rebuild = self._calc_level < 2
        if rec_slots:
            self._host_tick(rec_slots, publish_now=True)
        self._inflight = host_rec

    def _host_tick(self, slots: list[int], publish_now: bool = False) -> None:
        """One bucket tick on the host from the durable copies, bit-exact
        with the device step.  Deferred (unless ``publish_now``), it parks
        as a synthetic record and delivers at the next flush."""
        c, W = self.capacity, self.W
        self.stats["host_ticks"] += 1
        self._refresh_stale_rows()
        sl = np.array(slots, np.intp)
        new = np.empty((len(slots), c, W), np.uint32)
        for i, s in enumerate(slots):
            new[i] = _packed_predicate(self._hx[s], self._hz[s],
                                       self._hr[s], self._hact[s])
        chg = new ^ self._mirror[sl]
        chg[~self._hsub[sl]] = 0
        flat = chg.reshape(-1)
        gidx = np.nonzero(flat)[0]
        chg_vals = flat[gidx]
        ent_vals = chg_vals & new.reshape(-1)[gidx]
        self._mirror[sl] = new
        epochs = [self._slot_epoch.get(s, 0) for s in slots]
        if self._defer and not publish_now:
            self._inflight = {"host": True, "slots": slots, "epochs": epochs,
                              "payload": (chg_vals, ent_vals, gidx)}
        else:
            self._publish(slots, epochs, chg_vals, ent_vals, gidx)

    # -- mirror upkeep and publish -------------------------------------------

    def _mirror_clear(self, slot: int, entity_slot: int) -> None:
        _clear_words(self._mirror[slot], (entity_slot,), self.capacity)

    def _queue_mirror_clear(self, slot: int, entity_slot: int) -> None:
        """A clear issued while a record is in flight postdates it: it
        lands after that record's XOR, or the XOR would re-plant the
        bits."""
        if self._mirror is None:
            return
        if self._inflight is not None or self._due is not None:
            self._mirror_ops.append(
                (slot, entity_slot, self._slot_epoch.get(slot, 0)))
        else:
            self._mirror_clear(slot, entity_slot)

    def _apply_mirror_ops(self) -> None:
        """Clears queued behind a record apply once its stream has; the
        epoch tag drops those whose slot was released since."""
        ops, self._mirror_ops = self._mirror_ops, []
        if self._mirror is None:
            return
        for slot, ent, epoch in ops:
            if self._slot_epoch.get(slot, 0) == epoch:
                self._mirror_clear(slot, ent)

    def _publish(self, slots, epochs, chg_vals, ent_vals, gidx) -> None:
        """Expand a classified change stream over the [len(slots), C, W]
        grid into per-slot (enter, leave) pair arrays and publish them."""
        pe, pl = _emit_expand(self, chg_vals, ent_vals, gidx)
        self._publish_pairs(slots, epochs, _split_rows(pe), _split_rows(pl))

    def _publish_pairs(self, slots, epochs, ent_rows, lv_rows) -> None:
        """Merge per-space-row (enter, leave) pair dicts into the
        deliverable events, under the slot-epoch liveness guard."""
        empty = np.empty((0, 2), np.int32)
        for row, (slot, epoch) in enumerate(zip(slots, epochs)):
            if self._slot_epoch.get(slot, 0) != epoch:
                continue  # slot released since dispatch: a dead space
            e = ent_rows.get(row, empty)
            lv = lv_rows.get(row, empty)
            pend = self._events.get(slot)
            if pend is not None:
                # a mid-dispatch harvest (grow_space inside an AOI hook
                # calls get_prev -> flush) can land while prior events are
                # undelivered: APPEND, oldest first
                e = np.concatenate([pend[0], e])
                lv = np.concatenate([pend[1], lv])
            self._events[slot] = (e, lv)


class _CUDABucket(_Deferred, _Bucket):
    """Device-resident interest state [S, C, W] int32 on the engine's
    device; one step per flush for every staged slot.

    S (slot count) grows by doubling; state survives growth.  Unstaged
    slots are not stepped: their previous words carry forward untouched.
    The host keeps SHADOWS of the staged inputs ([S, C] numpy, bitwise
    identical to the device copies) so each tick ships only the x/z
    entries whose bit patterns changed, and a MIRROR of the packed words
    (seeded on the first :meth:`peek_words`, or kept from the start while
    a fault plan is active, then kept current by XORing each harvested
    tick) so plain entities' interest sets derive on the host without a
    device round trip, and a faulted tick recovers from it.

    ``pipeline`` / ``cross_tick`` (either, or both: ``_defer``) park each
    dispatched record one flush: ``dispatch()`` of tick T parks T and
    hands T-1's record to ``harvest()``, so T's staging and kernel overlap
    T-1's fetch and fan-out and events arrive one tick late.  Each record
    copies its count and an optimistic slice of its triples (``_pred_tri``
    rows, refit to every harvested count) to pinned host memory at its
    dispatch; the harvest uses that slice when it holds every triple.
    :meth:`drain` delivers the parked record without dispatching.  Every
    read or replacement of the state drains first; mirror clears issued
    while a record is in flight apply after its stream (``_mirror_ops``).

    ``fused`` runs each eligible steady tick (delta staging on, no stale
    device role, r and act unchanged, at most ``_delta_max_frac`` of the
    entries changed, every acquired slot staged, calc level 0, emit mode
    not ``host`` unless paged) as one replay of a CUDA graph over the
    whole [S] grid (:mod:`..ops.fused`); any other tick runs the unfused
    flow, and both records take the same harvest.  An
    ``aoi.delta``/``aoi.kernel`` fault in the fused attempt moves the tick
    to the unfused flow before any device work (``fused_demotions``), as
    the JAX bucket does.

    ``paged`` replaces the triple extraction with the page allocator
    (:func:`..ops.aoi_pages.allocate_pages`) over a free list that stays
    on the device from tick to tick (``_page_free``, reset to ``arange``
    when the pool is resized or the device state drops).  The record
    keeps the pools, the page table, the spilled bins and four scalars
    (fused: one bundle), the small ones copied to pinned host memory at
    dispatch; :meth:`_harvest_paged` fetches the used page prefix, checks
    the table and re-reads the spilled bins from the kept grids.  The
    pool starts at :func:`..ops.aoi_pages.pool_floor`, doubles after a
    spill (to the ceiling after a whole-tick spill) and shrinks back
    through :class:`_PageDecay`.

    The calculator chain and the recovery are :class:`_Deferred`'s."""

    def __init__(self, capacity: int, device: torch.device,
                 delta_staging: bool = True, emit: str = "vector",
                 pipeline: bool = False, cross_tick: bool = False,
                 fused: bool = False, paged: bool = False):
        super().__init__(capacity)
        self.device = device
        self.delta_staging = delta_staging
        self.pipeline = bool(pipeline)
        self.cross_tick = bool(cross_tick)
        self.fused = bool(fused)
        self.paged = bool(paged)
        # the page pool: its size, the device free list [n_pages] int32,
        # its decay (sized at the first dispatch) and the pages of the
        # optimistic prefetch of a deferred record
        self._n_pages = 0
        self._page_free: torch.Tensor | None = None
        self._pages: _PageDecay | None = None
        self._pred_pages = 64
        self._emit = emit
        self._emit_requested = emit  # what reset_emit_path re-arms
        self._init_faults()
        # the record parked across flushes (deferral), and the record the
        # next harvest() delivers
        self._inflight: dict | None = None
        self._due: dict | None = None
        # per-slot release epoch: a harvest must not publish events for a
        # slot released (and possibly reused) after its dispatch
        self._slot_epoch: dict[int, int] = {}
        self.s_max = 0
        self.prev: torch.Tensor | None = None  # [S, C, W] int32
        self._pending_reset: set[int] = set()
        self._pending_clear: list[tuple[int, int]] = []
        # triples extraction cap: grows on a counted overflow up to
        # _TRI_MAX, decays back through _tri
        self._max_triples = 16384
        self._tri = _TriCapDecay(floor=16384)
        # rows of the optimistic triple prefetch of a deferred record
        self._pred_tri = 2048
        self._mirror: np.ndarray | None = None
        # (slot, entity, epoch) clears issued while a record is in
        # flight: they apply after that record's XOR
        self._mirror_ops: list[tuple] = []
        # slots opted out of the event stream: their mirror rows go stale
        # (_mirror_stale) and refresh from the device on the next peek
        self._unsub: set[int] = set()
        self._mirror_stale: set[int] = set()
        self._hx = np.zeros((0, capacity), np.float32)
        self._hz = np.zeros((0, capacity), np.float32)
        self._hr = np.zeros((0, capacity), np.float32)
        self._hact = np.zeros((0, capacity), bool)
        self._hsub = np.ones(0, bool)
        # device copies of the shadows (updated in place, so a captured
        # graph keeps reading them); _dev_stale names the roles that must
        # fully re-upload (grow/reset, r/act/sub change, recovery)
        self._dev: dict[str, torch.Tensor] = {}
        self._dev_stale: set[str] = {"xz", "ra", "sub"}
        # delta path bails to a full restage past this changed fraction
        self._delta_max_frac = 0.25
        self._fz: FZ.FusedTri | None = None  # the fused tick's buffers
        # (FusedPaged when paged)
        # h2d_bytes: wire bytes shipped; delta/full_flushes: how each
        # tick's inputs were staged; decode_overflow: ticks recovered from
        # the full grids; emit_path: 0 native, 1 vector, 2 host;
        # fused_dispatches: ticks run as one graph replay;
        # fused_demotions: fused attempts a seam fault moved to the
        # unfused flow; prefetch_hits/misses: deferred harvests whose
        # triples (or pages) the optimistic slice held / did not hold;
        # page_spills: bins (or whole ticks) the page pool could not serve,
        # re-read from the kept grids; page_occupancy: used / total pages
        # at the last paged harvest.  The fault counters: rebuilds (device
        # state dropped and recovered from the host copies), fallbacks
        # (calculator demotions), host_ticks (ticks the host computed),
        # poisoned (control scalars or a page table that failed
        # validation), calc_level (0 kernel, 1 plain step, 2 host oracle)
        self.stats = {"h2d_bytes": 0, "delta_flushes": 0, "full_flushes": 0,
                      "rebuilds": 0, "fallbacks": 0, "host_ticks": 0,
                      "poisoned": 0, "calc_level": 0,
                      "decode_overflow": 0,
                      "emit_path": AE.EMIT_LEVEL[emit],
                      "fused_dispatches": 0, "fused_demotions": 0,
                      "prefetch_hits": 0, "prefetch_misses": 0,
                      "page_spills": 0, "page_occupancy": 0.0}
        # cumulative seconds: stage = host pack + H2D + enqueue (dispatch),
        # fetch = waits for the count and the triples or grids, decode =
        # mirror upkeep (and the overflow expansion), emit = fan-out +
        # publish
        self.perf = {"stage_s": 0.0, "fetch_s": 0.0, "decode_s": 0.0,
                     "emit_s": 0.0}

    @property
    def _steady(self) -> bool:
        """No resize of the triple cap or the page pool pending."""
        if self.paged:
            return self._pages is not None and self._pages.steady
        return self._tri.steady

    def _grow_to(self, n_slots: int) -> None:
        if n_slots <= self.s_max:
            return
        self.drain()
        new_s = max(1, self.s_max)
        while new_s < n_slots:
            new_s *= 2
        if self._need_rebuild or self._calc_level >= 2:
            # the device words are down: the mirror grows on the host and
            # the next rebuild uploads it grown
            self.prev = None
        else:
            try:
                faults.check("aoi.grow")
                new_prev = torch.zeros((new_s, self.capacity, self.W),
                                       dtype=torch.int32, device=self.device)
                if self.prev is not None and self.s_max > 0:
                    new_prev[: self.s_max] = self.prev
                self.prev = new_prev
            except Exception as e:
                if not _device_fault(e):
                    raise
                # the grown state did not allocate; the old words are
                # intact, so the mirror seeds exactly and grows below
                self._ensure_mirror()
                self.stats["rebuilds"] += 1
                self.prev = None
                self._need_rebuild = True
                _log.warning("AOI bucket grow to %d slots hit a device "
                             "fault (%s); the words stay in the host "
                             "mirror until the next dispatch rebuilds",
                             new_s, e)
        if self._mirror is not None:
            grown = np.zeros((new_s, self.capacity, self.W), np.uint32)
            grown[: self._mirror.shape[0]] = self._mirror
            self._mirror = grown
        elif self._ft:
            # a fault plan keeps the durable copy from the start (a fresh
            # bucket's words are zero: no fetch)
            self._mirror = np.zeros((new_s, self.capacity, self.W),
                                    np.uint32)
        for name in ("_hx", "_hz", "_hr"):
            arr = getattr(self, name)
            grown = np.zeros((new_s, self.capacity), np.float32)
            grown[: arr.shape[0]] = arr
            setattr(self, name, grown)
        hact = np.zeros((new_s, self.capacity), bool)
        hact[: self._hact.shape[0]] = self._hact
        self._hact = hact
        hsub = np.ones(new_s, bool)
        hsub[: self._hsub.shape[0]] = self._hsub
        self._hsub = hsub
        self._dev.clear()
        self._dev_stale = {"xz", "ra", "sub"}
        self._fz = None  # its buffers and graphs have the old shapes
        self.s_max = new_s

    def _reset_slot(self, slot: int) -> None:
        self._pending_reset.add(slot)
        self._unsub.discard(slot)  # subscription is per-occupant
        self._hx[slot] = 0.0
        self._hz[slot] = 0.0
        self._hr[slot] = 0.0
        self._hact[slot] = False
        self._hsub[slot] = True
        self._dev_stale.update(("xz", "ra", "sub"))
        self._mirror_stale.discard(slot)
        if self._mirror is not None:
            # at once even with a tick in flight: its stream is epoch-
            # guarded, so a dead occupant's rows cannot XOR back over it
            self._mirror[slot] = 0

    def release_slot(self, slot: int) -> None:
        self._slot_epoch[slot] = self._slot_epoch.get(slot, 0) + 1
        super().release_slot(slot)

    def set_subscribed(self, slot: int, flag: bool) -> None:
        if flag:
            self._unsub.discard(slot)
        else:
            self._unsub.add(slot)
        if slot < self._hsub.shape[0] and self._hsub[slot] != flag:
            self._hsub[slot] = flag
            self._dev_stale.add("sub")

    def clear_entity(self, slot: int, entity_slot: int) -> None:
        self._pending_clear.append((slot, entity_slot))
        self._queue_mirror_clear(slot, entity_slot)

    # -- the device hooks of the recovery ----------------------------------

    def _drop_device(self) -> None:
        self.prev = None
        self._dev.clear()
        self._dev_stale = {"xz", "ra", "sub"}
        self._fz = None  # its graphs read the dropped tensors
        self._page_free = None  # reset at the next dispatch

    def _prev_to_numpy(self) -> np.ndarray:
        return P.words_to_numpy(self.prev)

    def _upload_prev(self, words: np.ndarray) -> None:
        self.prev = P.words_to_torch(words, self.device)

    # -- the tick -------------------------------------------------------

    def _dispatch_tick(self) -> dict | None:
        """Maintenance, staging, kernel, compaction and the async count
        copy of one tick; its record, or None when nothing was staged."""
        if not (self._staged or self._pending_reset or self._pending_clear):
            return None
        self._fault_phase = "stage"
        # the device's health probe (kind "reset": the device is lost)
        faults.check("aoi.device")
        self._rebuild_device()
        self._apply_maintenance()
        if not self._staged:
            return None
        t_stage0 = time.perf_counter()
        slots = sorted(self._staged)
        sl = np.array(slots, np.intp)
        # keep the previously staged values so the staging can diff the
        # new tick against them
        old = (self._hx[sl], self._hz[sl], self._hr[sl], self._hact[sl])
        self._restage_shadows()
        self._cur_slots = slots  # a recovery needs them once _staged is gone
        sub = self._hsub[sl]
        if self._mirror is not None and not sub.all():
            self._mirror_stale.update(s for s in slots if s in self._unsub)
        if self.paged:
            _ensure_pool(self, len(slots) * self.capacity * self.W,
                         self.device)
        rec = self._dispatch_fused(slots, sl, sub, *old) if self.fused \
            else None
        if rec is None:
            rec = self._dispatch_unfused(slots, sl, sub, *old)
        self.perf["stage_s"] += time.perf_counter() - t_stage0
        return rec

    def _record(self, slots, sub, new, chg, tri=None, count=None) -> dict:
        """A dispatched tick's record; its count (and, deferred, the
        optimistic triple slice) starts for the host."""
        rec = {"slots": slots, "s_n": len(slots), "mt": self._max_triples,
               "epochs": [self._slot_epoch.get(s, 0) for s in slots],
               "grids": (new, chg), "tri": tri, "count": None,
               "ready": None, "all_unsub": not sub.any(), "prefetch": None}
        if rec["all_unsub"]:
            return rec
        ndp = min(rec["mt"], self._pred_tri) if self._defer else 0
        rec["count"] = _host_copy(count)
        if ndp:
            rec["prefetch"] = _host_copy(tri[:ndp])
        rec["ready"] = self._ready_event()
        return rec

    def _ready_event(self):
        """An event after the copies just enqueued (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _paged_record(self, slots, sub, new, chg, pools=None, tab=None,
                      spill=None, scalars=None, bundle=None) -> dict:
        """A dispatched paged tick's record: its grids and pools; its page
        table, spilled bins and scalars (or the fused tick's bundle) and,
        deferred, the optimistic slice of its pools start for the host."""
        rec = {"mode": "paged", "slots": slots,
               "epochs": [self._slot_epoch.get(s, 0) for s in slots],
               "grids": (new, chg), "n_pages": self._n_pages,
               "pools": pools, "tab": None, "spill": None, "scalars": None,
               "bundle": None, "ready": None, "all_unsub": not sub.any(),
               "prefetch": None}
        if rec["all_unsub"]:
            return rec
        if bundle is not None:
            rec["bundle"] = _host_copy(bundle)
        else:
            rec["tab"], rec["spill"], rec["scalars"] = (
                _host_copy(t) for t in (tab, spill, scalars))
        if self._defer:
            ndp = min(self._n_pages, self._pred_pages)
            rec["prefetch"] = (ndp, [_host_copy(a[:ndp]) for a in pools])
        rec["ready"] = self._ready_event()
        return rec

    def _dispatch_unfused(self, slots, sl, sub, old_x, old_z, old_r,
                          old_act) -> dict:
        self._stage_inputs(sl, old_x, old_z, old_r, old_act)
        self._fault_phase = "kernel"
        faults.check("aoi.kernel")
        dev = self._dev
        every = len(slots) == self.s_max  # slots are sorted and unique
        if every:
            x, z, r, act, dsub, prev_rows = (dev["x"], dev["z"], dev["r"],
                                             dev["act"], dev["sub"],
                                             self.prev)
        else:
            idx = AS.h2d(sl.astype(np.int64), self.device)
            x, z, r, act, dsub, prev_rows = (
                t.index_select(0, idx) for t in
                (dev["x"], dev["z"], dev["r"], dev["act"], dev["sub"],
                 self.prev))
        DC.record()
        new, chg = _calc_step(self._calc_level, x, z, r, act, prev_rows)
        if every:
            self.prev = new
        else:
            self._detach_parked_new()
            self.prev.index_copy_(0, idx, new)
        if not sub.any():
            # nothing to extract (paged: the allocator would use no page)
            return (self._paged_record(slots, sub, new, chg) if self.paged
                    else self._record(slots, sub, new, chg))
        if not sub.all():
            # slots with no event consumers contribute nothing to the
            # change stream (``new`` above stays unmasked: prev must stay
            # authoritative)
            chg.masked_fill_(~dsub[:, None, None], 0)
        if self.paged:
            pg, pc, pn, tab, self._page_free, spill, scal = \
                PG.allocate_pages(chg, new, self._page_free, PG.PAGE_WORDS,
                                  PG.bin_words_for(self.W), PG.MAX_SPILL)
            return self._paged_record(slots, sub, new, chg, (pg, pc, pn),
                                      tab, spill, scal)
        tri, count = EV.extract_triples(chg, new, self.capacity,
                                        self._max_triples)
        return self._record(slots, sub, new, chg, tri, count.reshape(1))

    def _dispatch_fused(self, slots, sl, sub, old_x, old_z, old_r,
                        old_act) -> dict | None:
        """The tick as one graph replay, or None when the unfused flow
        runs it: silently when it is not eligible, counted in
        ``fused_demotions`` when an ``aoi.delta``/``aoi.kernel`` seam
        fault fired in the attempt (before any device work, so the
        unfused flow -- whose crossings then pass -- runs it in the same
        call, bit-exact)."""
        if (not self.delta_staging or self._dev_stale
                or any(role not in self._dev
                       for role in ("x", "z", "r", "act", "sub"))
                or self._calc_level >= 1 or self._need_rebuild
                or (self._emit == "host" and not self.paged)
                or len(slots) != self.n_slots):
            # the graph steps all s_max rows: every acquired slot must be
            # staged (rows never acquired hold zero words and inactive
            # inputs, so they stay zero and emit nothing)
            return None
        if not (np.array_equal(self._hr[sl], old_r)
                and np.array_equal(self._hact[sl], old_act)):
            return None  # r/act moved: a full-restage tick
        new_x, new_z = self._hx[sl], self._hz[sl]
        diff = (new_x.view(np.uint32) != old_x.view(np.uint32)) \
            | (new_z.view(np.uint32) != old_z.view(np.uint32))
        n_changed = np.count_nonzero(diff)
        if n_changed > self._delta_max_frac * diff.size:
            return None  # mass movement: a full restage
        try:
            if n_changed:
                faults.check("aoi.delta")
            self._fault_phase = "kernel"
            faults.check("aoi.kernel")
        except Exception as e:
            if not _device_fault(e):
                raise
            self.stats["fused_demotions"] += 1
            self._fault_phase = "stage"
            return None
        fz = self._fz
        if fz is None:
            fz = self._fz = (FZ.FusedPaged if self.paged else FZ.FusedTri)(
                self.s_max, self.capacity,
                FZ.packet_len(self.s_max, self.capacity,
                              self._delta_max_frac), self.device)
        if n_changed:
            rows, cols = np.nonzero(diff)
        else:
            # no mover: one entry rewriting a value the device holds
            rows, cols = np.zeros(1, np.intp), np.zeros(1, np.intp)
        pkt = AS.pad_packet(sl[rows], cols, new_x[rows, cols],
                            new_z[rows, cols], length=fz.plen)
        self.stats["h2d_bytes"] += AS.packet_nbytes(*pkt)
        self.stats["delta_flushes"] += 1
        parity = fz.parity_of(self.prev)
        fz.load_packet(parity, *pkt)
        fz.set_sub(self._hsub)
        dev = self._dev
        inputs = (dev["x"], dev["z"], dev["r"], dev["act"])
        self.stats["fused_dispatches"] += 1
        if self.paged:
            new, chg, pools, bundle, self._page_free = fz.run_paged(
                parity, self._page_free, *inputs)
            self.prev = new
            return self._paged_record(slots, sub, new, chg, pools,
                                      bundle=bundle)
        new, chg, tri, count = fz.run(parity, self._max_triples, *inputs)
        self.prev = new
        return self._record(slots, sub, new, chg, tri, count)

    def _detach_parked_new(self) -> None:
        """Before ``self.prev`` is written in place: a parked record whose
        new words ARE ``self.prev`` keeps a copy (its overflow recovery
        reads them)."""
        for rec in (self._inflight, self._due):
            if rec is not None and not rec.get("host") \
                    and rec["grids"][0] is self.prev:
                rec["grids"] = (self.prev.clone(), rec["grids"][1])

    def _apply_maintenance(self) -> None:
        """Land queued slot resets and entity clears on the packed state."""
        c = self.capacity
        dev = self.device
        if self._pending_reset or self._pending_clear:
            self._detach_parked_new()
        if self._pending_reset:
            idx = AS.h2d(np.array(sorted(self._pending_reset), np.int64), dev)
            DC.record()
            self.prev[idx] = 0
            self._pending_reset.clear()
        if not self._pending_clear:
            return
        # combine repeated (slot, word) column masks host-side so the
        # scatter indices are unique, then apply everything at once
        col_mask: dict[tuple[int, int], int] = {}
        rows = []
        for slot, e in self._pending_clear:
            w, b = P.word_bit_for_column(e, c)
            key = (slot, w)
            col_mask[key] = col_mask.get(key, 0xFFFFFFFF) & (
                ~(1 << b) & 0xFFFFFFFF)
            rows.append((slot, e))
        self._pending_clear.clear()
        cols = [(s, w, m) for (s, w), m in col_mask.items()]
        masks = np.array([m for _, _, m in cols], np.uint32).view(np.int32)

        def t(vals):
            return AS.h2d(np.array(vals, np.int64), dev)

        DC.record()
        _batched_clear(self.prev, t([s for s, _ in rows]),
                       t([e for _, e in rows]), t([s for s, _, _ in cols]),
                       t([w for _, w, _ in cols]), AS.h2d(masks, dev))

    def _harvest(self, rec: dict) -> None:
        """Wait for one record's count, fetch its triples (from the
        prefetched slice when it holds them all; past the cap, or when
        the count fails validation, the full grids), update the mirror
        and publish per-slot events.  A host record publishes what the
        host computed at its tick."""
        if rec.get("host"):
            self._publish(rec["slots"], rec["epochs"], *rec["payload"])
            self._apply_mirror_ops()
            return
        if rec.get("mode") == "paged":
            self._harvest_paged(rec)
            return
        slots, mt = rec["slots"], rec["mt"]
        c = self.capacity
        faults.check("aoi.fetch")  # stallable: a delayed host sync
        t_f0 = time.perf_counter()
        poisoned = False
        if rec["all_unsub"]:
            count = 0
        else:
            if rec["ready"] is not None:
                rec["ready"].synchronize()
            count = int(faults.filter("aoi.scalars",
                                      rec["count"].numpy())[0])
            if not 0 <= count <= len(slots) * c * c:
                # a garbage count: distrust the compact buffer and
                # recover the tick from the full grids (no cap growth)
                self.stats["poisoned"] += 1
                _log.warning("AOI triple count failed validation (%d); "
                             "recovering the tick from the full grids",
                             count)
                poisoned = True
        if poisoned or count > mt:
            if not poisoned:
                # triple-cap overflow: the compact buffer is truncated, so
                # recover this tick from the full grids, then grow the cap
                # so the next tick compacts on device again (counted)
                self.stats["decode_overflow"] += 1
                if self._max_triples < _TRI_MAX:
                    self._max_triples = min(
                        _TRI_MAX, 1 << (2 * count - 1).bit_length())
                self._tri.reset_after_growth()
            self._recover_from_grids(rec, t_f0)
            return
        shrink = self._tri.observe(count, self._max_triples)
        if shrink is not None:
            self._max_triples = shrink
        pf = rec["prefetch"]
        if count == 0:
            tri_h = np.empty((0, 3), np.int32)
        elif pf is not None and pf.shape[0] >= count:
            self.stats["prefetch_hits"] += 1
            tri_h = pf.numpy()[:count]
        else:
            if pf is not None:
                self.stats["prefetch_misses"] += 1
            ndp = min(mt, -(-count // 256) * 256)
            tri_h = rec["tri"][:ndp].cpu().numpy()[:count]
        self.perf["fetch_s"] += time.perf_counter() - t_f0
        # refit the next dispatch's optimistic prefetch to this tick
        self._pred_tri = max(
            2048, min(self._max_triples, -(-count * 5 // 4 // 256) * 256))
        t_f0 = time.perf_counter()
        if self._mirror is not None and len(tri_h):
            self._mirror_xor_triples(slots, rec["epochs"], tri_h)
        self._apply_mirror_ops()
        self.perf["decode_s"] += time.perf_counter() - t_f0
        t_f0 = time.perf_counter()
        self._fan_out(slots, rec["epochs"], tri_h)
        self.perf["emit_s"] += time.perf_counter() - t_f0

    def _recover_from_grids(self, rec: dict, t_f0: float) -> None:
        """Publish a record's tick from its full (chg, new) grids (a
        poisoned count or scalars, a triple-cap overflow, a whole-tick
        page spill): the nonzero change words in ascending flat order,
        as the device extraction orders them."""
        new, chg = rec["grids"]
        chg_h = P.words_to_numpy(chg).reshape(-1)
        new_h = P.words_to_numpy(new).reshape(-1)
        gidx = np.nonzero(chg_h)[0]
        chg_vals = chg_h[gidx]
        self.perf["fetch_s"] += time.perf_counter() - t_f0
        self._deliver_words(rec, gidx, chg_vals, chg_vals & new_h[gidx])

    def _deliver_words(self, rec: dict, gidx, chg_vals, ent_vals) -> None:
        """A record's classified word stream into the mirror (then the
        clears queued behind it) and out to the slots."""
        slots, epochs = rec["slots"], rec["epochs"]
        t0 = time.perf_counter()
        self._mirror_xor_stream(slots, epochs, gidx, chg_vals)
        self._apply_mirror_ops()
        self.perf["decode_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        self._publish(slots, epochs, chg_vals, ent_vals, gidx)
        self.perf["emit_s"] += time.perf_counter() - t0

    def _harvest_paged(self, rec: dict) -> None:
        """Harvest one paged tick: wait for its scalars (and page table and
        spilled bins, or the fused tick's bundle), fetch the used page
        prefix (from the prefetched slice when it holds it), check the
        page table, decode the pages, re-read the spilled bins from the
        kept grids, then update the mirror and publish.

        The degradations, each counted: spilled bins re-read on the host
        (``page_spills`` += bins, the pool doubles); more than
        ``MAX_SPILL`` spilled bins, or an ``aoi.pages`` ``oom``/``fail``/
        ``partial``, spill the whole tick from the raw grids
        (``page_spills`` += 1, the pool grows); scalars that fail
        validation recover the tick from the raw grids (``poisoned``).  A
        page table the plan's ``poison`` corrupted raises
        :class:`PageTableCorrupt`, which the recovery takes (the tick is
        recomputed on the host from the durable copies); a table that
        fails validation without an injected fault propagates."""
        slots, n_pages = rec["slots"], rec["n_pages"]
        bw = PG.bin_words_for(self.W)
        new, chg = rec["grids"]
        nw = len(slots) * self.capacity * self.W
        faults.check("aoi.fetch")  # stallable: a delayed host sync
        t_f0 = time.perf_counter()
        poisoned = False
        n_used = n_spill = 0
        page_spec = page_fault = None
        bun = None
        if not rec["all_unsub"]:
            if rec["ready"] is not None:
                rec["ready"].synchronize()
            if rec["bundle"] is not None:
                bun = rec["bundle"].numpy()
                raw = faults.filter("aoi.scalars", bun[:4])
            else:
                raw = faults.filter("aoi.scalars", rec["scalars"].numpy())
            n_used, n_spill, nz_fit, nz_total = (int(v) for v in raw)
            if not (0 <= n_used <= n_pages and 0 <= n_spill <= -(-nw // bw)
                    and 0 <= nz_fit <= nw and 0 <= nz_total <= nw):
                self.stats["poisoned"] += 1
                _log.warning("AOI page scalars failed validation (used=%d "
                             "spill=%d fit=%d total=%d); recovering the "
                             "tick from the full grids", n_used, n_spill,
                             nz_fit, nz_total)
                poisoned = True
                n_used = n_spill = 0
            # the aoi.pages seam: oom / fail / partial spill the whole
            # tick; poison corrupts the fetched page table (checked below)
            try:
                page_spec = faults.check("aoi.pages")
            except Exception as e:
                if not _device_fault(e):
                    raise
                page_fault = e
            if page_spec is not None and page_spec.kind == "partial":
                page_fault = page_spec
        shrink = (None if poisoned or n_spill or page_fault is not None
                  else self._pages.observe(n_used, n_pages))
        if shrink is not None and shrink < self._n_pages:
            self._n_pages = shrink
            self._page_free = None
        if poisoned or page_fault is not None or n_spill > PG.MAX_SPILL:
            if not poisoned:
                self.stats["page_spills"] += 1
                _log.warning("AOI page pool unusable this tick (%s); "
                             "spilling the whole tick to the host and "
                             "re-arming the pool",
                             page_fault if page_fault is not None else
                             f"{n_spill} bins spilled > {PG.MAX_SPILL}")
                # an organic mass spill: the pool is far too small; a
                # fault says nothing about its size, so it only doubles
                _grow_pool(self, nw, bw, full=page_fault is None)
            self._recover_from_grids(rec, t_f0)
            return
        pf = rec["prefetch"]
        if n_used == 0:
            pg_h = pc_h = pn_h = np.empty((0, PG.PAGE_WORDS), np.int32)
        elif pf is not None and pf[0] >= n_used:
            self.stats["prefetch_hits"] += 1
            pg_h, pc_h, pn_h = (a.numpy()[:n_used] for a in pf[1])
        else:
            if pf is not None:
                self.stats["prefetch_misses"] += 1
            ndp = min(n_pages, -(-n_used // 16) * 16)
            pg_h, pc_h, pn_h = (a[:ndp].cpu().numpy()[:n_used]
                                for a in rec["pools"])
        self.perf["fetch_s"] += time.perf_counter() - t_f0
        # refit the next dispatch's optimistic page prefetch to this tick
        self._pred_pages = max(
            64, min(self._n_pages, -(-n_used * 5 // 4 // 16) * 16))
        t0 = time.perf_counter()
        if n_used:
            tab_h = (bun[4:4 + n_pages] if bun is not None
                     else rec["tab"].numpy())
            injected = page_spec is not None and page_spec.kind == "poison"
            if injected:
                tab_h = np.full_like(tab_h, np.iinfo(np.int32).min)
            if not PG.validate_page_table(tab_h, n_used, n_pages):
                if injected:
                    self.stats["poisoned"] += 1
                    self._page_free = None
                raise _page_table_bad(n_used, n_pages, injected)
        gidx, chg_vals, new_vals = PG.decode_pages(pg_h, pc_h, pn_h)
        gidx = gidx.astype(np.int64)
        if n_spill:
            # the pool served every bin it could: the spilled bins' words
            # from the kept grids (merged unsorted: the mirror XOR is
            # order-free over unique words and the expansion sorts), and
            # the pool grows for the next tick
            self.stats["page_spills"] += n_spill
            sb = (bun[4 + n_pages:] if bun is not None
                  else rec["spill"].numpy())
            sg, sc, sn = PG.spill_stream(chg.reshape(-1), new.reshape(-1),
                                         sb, bw, nw)
            gidx = np.concatenate([gidx, sg])
            chg_vals = np.concatenate([chg_vals, sc])
            new_vals = np.concatenate([new_vals, sn])
            _grow_pool(self, nw, bw)
        self.stats["page_occupancy"] = n_used / n_pages if n_pages else 0.0
        self.perf["decode_s"] += time.perf_counter() - t0
        self._deliver_words(rec, gidx, chg_vals, chg_vals & new_vals)

    def _fan_out(self, slots, epochs, tri_h) -> None:
        """Publish a tick's fetched triples through the emit mode: the
        ``host`` mode folds them back into words and decodes those on the
        host; ``native``/``vector`` fan them out behind the ``aoi.emit``
        seam, whose fault demotes the bucket to ``host`` and republishes
        the same triples through it."""
        c = self.capacity
        if self._emit != "host":
            try:
                faults.check("aoi.emit")
                pe, pl = AE.fanout_triples(tri_h, c,
                                           native=self._emit == "native")
            except Exception as e:
                # an injected fault, or the native library's own error
                if not isinstance(e, RuntimeError):
                    raise
                _demote_emit(self, e)
            else:
                self._publish_pairs(slots, epochs, _split_rows(pe),
                                    _split_rows(pl))
                return
        self._publish(slots, epochs, *EV.triples_to_words(tri_h, c))

    def _restage_shadows(self) -> list[int]:
        """Copy staged tick inputs into the persistent host shadows."""
        slots = sorted(self._staged)
        for slot in slots:
            sx, sz, sr, sa = self._staged[slot]
            n = len(sx)
            self._hx[slot, :n] = sx
            self._hx[slot, n:] = 0.0
            self._hz[slot, :n] = sz
            self._hz[slot, n:] = 0.0
            self._hr[slot, :n] = sr
            self._hr[slot, n:] = 0.0
            self._hact[slot, :n] = sa
            self._hact[slot, n:] = False
        self._staged.clear()
        return slots

    def _stage_inputs(self, sl, old_x, old_z, old_r, old_act) -> None:
        """Bring the device-resident inputs up to date with the shadows:
        a sparse (row, col, x, z) packet on the steady path; whole role
        arrays after grow/reset/recovery, when r/act/sub changed, when the
        changed fraction exceeds _delta_max_frac, or without delta
        staging.  The diff compares float BIT PATTERNS (NaN payloads, -0.0
        vs 0.0), so the device copy stays byte-identical to the shadow."""
        new_x, new_z = self._hx[sl], self._hz[sl]
        diff = (new_x.view(np.uint32) != old_x.view(np.uint32)) \
            | (new_z.view(np.uint32) != old_z.view(np.uint32))
        n_changed = np.count_nonzero(diff)
        if not (np.array_equal(self._hr[sl], old_r)
                and np.array_equal(self._hact[sl], old_act)):
            self._dev_stale.update(("ra", "xz"))
        stale = self._dev_stale
        if (self.delta_staging and not stale
                and n_changed <= self._delta_max_frac * diff.size):
            if n_changed:
                faults.check("aoi.delta")
                rows, cols = np.nonzero(diff)
                pkt = AS.pad_packet(sl[rows], cols, new_x[rows, cols],
                                    new_z[rows, cols],
                                    page_granular=self.paged)
                DC.record()
                AS.apply_packet(self._dev["x"], self._dev["z"], *pkt)
                self.stats["h2d_bytes"] += AS.packet_nbytes(*pkt)
            self.stats["delta_flushes"] += 1
            return
        if (not self.delta_staging or "xz" in stale or n_changed
                or "x" not in self._dev):
            self._h2d("x", self._hx)
            self._h2d("z", self._hz)
        if "ra" in stale or "r" not in self._dev:
            self._h2d("r", self._hr)
            self._h2d("act", self._hact)
        if "sub" in stale or "sub" not in self._dev:
            self._h2d("sub", self._hsub)
        stale.clear()
        self.stats["full_flushes"] += 1

    def _h2d(self, role: str, arr: np.ndarray) -> None:
        """Full upload of one shadow role array -- the seam every full
        staged-input upload crosses -- into its device tensor in place (a
        captured graph keeps reading it); never aliasing the shadow on the
        CPU device."""
        faults.check("aoi.h2d")
        self.stats["h2d_bytes"] += arr.nbytes
        self._dev[role] = AS.h2d(arr, self.device, out=self._dev.get(role))

    # -- the host mirror ---------------------------------------------------

    def _mirror_xor_stream(self, slots, epochs, gidx, chg_vals) -> None:
        """Apply one harvested word stream (unique flat word indices over
        the [s_n, C, W] grid) to the host mirror."""
        if self._mirror is None or not len(gidx):
            return
        wps = self.capacity * self.W
        gidx = np.asarray(gidx, np.int64)
        rows = gidx // wps
        keep = self._live_rows(slots, epochs)[rows]
        g, v = (gidx, chg_vals) if keep.all() else (gidx[keep],
                                                    chg_vals[keep])
        srows = np.asarray(slots, np.int64)[g // wps]
        self._mirror.reshape(self.s_max, wps)[srows, g % wps] ^= v

    def _mirror_xor_triples(self, slots, epochs, tri) -> None:
        """Apply a tick's triples to the host mirror: each triple flips one
        unique (row, bit)."""
        c = self.capacity
        obs = tri[:, 0].astype(np.int64)
        keep = self._live_rows(slots, epochs)[obs // c]
        if not keep.all():
            obs, tri = obs[keep], tri[keep]
        j = tri[:, 1].astype(np.int64)
        srows = np.asarray(slots, np.int64)[obs // c]
        # planar layout: column j lives at word j % W, bit j // W
        gw = (srows * c + obs % c) * self.W + j % self.W
        bit = (j // self.W).astype(np.uint32)
        np.bitwise_xor.at(self._mirror.reshape(-1), gw, np.uint32(1) << bit)

    def _live_rows(self, slots, epochs) -> np.ndarray:
        """Per staged row: still the same occupant (epoch) and its mirror
        row not stale (a stale row refreshes from the device instead)."""
        cur = np.fromiter((self._slot_epoch.get(s, 0) for s in slots),
                          np.int64, len(slots))
        keep = cur == np.asarray(epochs, np.int64)
        if self._mirror_stale:
            keep &= ~np.fromiter((s in self._mirror_stale for s in slots),
                                 bool, len(slots))
        return keep

    def peek_words(self, slot: int) -> np.ndarray:
        """Host mirror of the slot's interest words [C, W] uint32.  The
        first call delivers any tick in flight and seeds the mirror with
        one device fetch, so mirror and delivered events agree; afterwards
        each harvest keeps it current.  A slot that was unsubscribed
        refreshes its rows from the device on demand (from the predicate
        of its shadows while the device is down)."""
        if self._mirror is None:
            self.drain()
            self._ensure_mirror()
            # maintenance queued for the next dispatch already holds for
            # the host view
            for s in sorted(self._pending_reset):
                self._mirror[s] = 0
            for s, e in self._pending_clear:
                self._mirror_clear(s, e)
            self._mirror_stale.clear()
        elif slot in self._mirror_stale:
            self.flush()
            self.drain()
            self._mirror[slot] = (
                P.words_to_numpy(self.prev[slot]) if self.prev is not None
                else _packed_predicate(self._hx[slot], self._hz[slot],
                                       self._hr[slot], self._hact[slot]))
            self._mirror_stale.discard(slot)
        return self._mirror[slot]

    def get_prev(self, slot: int) -> np.ndarray:
        """Previous-tick interest words [C, W] uint32 (after applying
        pending steps and delivering every tick in flight), for state
        carry-over; the mirror's while the device is down."""
        self.flush()
        self.drain()
        if self.prev is None:
            self._ensure_mirror()
            return self._mirror[slot].copy()
        return P.words_to_numpy(self.prev[slot])

    def set_prev(self, slot: int, words: np.ndarray) -> None:
        """Seed a slot's previous-tick interest words [C, W] uint32 (into
        the mirror while the device is down; the rebuild uploads it)."""
        self.flush()
        self.drain()
        self._pending_reset.discard(slot)
        w = np.asarray(words, np.uint32)
        if self.prev is not None:
            self.prev[slot] = P.words_to_torch(w, self.device)
        else:
            self._ensure_mirror()
        self._mirror_stale.discard(slot)
        if self._mirror is not None:
            self._mirror[slot] = w

    def import_state(self, slot: int, words, x, z, r, act) -> None:
        """Carry a slot's whole AOI state in from another engine (the JAX
        package's bucket included): its previous-tick words [C, W] uint32
        and the [C] inputs they were computed from.  The next tick then
        diffs against exactly that state, as the source would have."""
        self.drain()
        self._hx[slot] = x
        self._hz[slot] = z
        self._hr[slot] = r
        self._hact[slot] = act
        self._dev_stale.update(("xz", "ra"))
        self.set_prev(slot, words)
