"""The AOI seam of the port: where Spaces meet the GPU.

Port of the JAX package's ``engine/aoi.py`` single-device path.  Each
Space stages its per-tick arrays (x, z, radius, active); the game loop
calls :meth:`AOIEngine.flush` once per tick; every bucket (one per
capacity) runs ONE kernel launch for all its spaces and publishes
per-space enter/leave pairs in deterministic (observer, observed) order.

One bucket tick (:class:`_CUDABucket`), all of it enqueued before the
first wait:

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

The only backend is ``"cuda"`` (the device is the engine's ``device``:
``"cuda"`` by default, ``"cpu"`` for the tests).  There is no fallback
chain: a kernel fault raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import aoi_cuda as AK
from ..ops import aoi_emit as AE
from ..ops import aoi_predicate as P
from ..ops import aoi_stage as AS
from ..ops import dispatch_count as DC
from ..ops import events as EV
from ..ops import fused as FZ

# triples-path extraction cap ceiling: the [max_triples, 32] bit matrix in
# extract_triples grows with it, so growth stops here and larger ticks
# take the counted full-grid recovery (decode_overflow)
_TRI_MAX = 1 << 18

# words per extraction chunk of the sharded buckets' row-stream codec
_LANES = 128

# backend names of the JAX package that the port does not have yet, and
# the ROADMAP.md entry that brings each
_LATER_BACKENDS = {
    "cpu": "the host calculators (ROADMAP.md queue 1, item 11)",
    "cpp": "the host calculators (ROADMAP.md queue 1, item 11)",
    "auto": "capacity routing to the host calculators (ROADMAP.md "
            "queue 1, item 11)",
    "tpu": "nothing: the port's device backend is named 'cuda'",
}


# options of the JAX package's AOIEngine/Runtime and bucket methods that
# the port does not have yet, and the ROADMAP.md entry that brings each
_LATER_OPTIONS = {
    "fault_plan": "the fault seams (ROADMAP.md queue 1, item 4)",
    "paged": "paged storage (ROADMAP.md queue 1, item 5)",
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
    if backend is None or backend == "cuda":
        return
    later = _LATER_BACKENDS.get(backend)
    if later is None:
        raise ValueError(f"unknown AOI backend {backend!r}")
    raise ValueError(f"AOI backend {backend!r} is not in the port yet; it "
                     f"comes with {later}")


def _batched_clear(prev_all, row_slots, row_ents, col_slots, col_words,
                   col_masks) -> None:
    """Erase departed entities' rows and columns of the packed state in
    place: all row clears, then all (pre-combined per (slot, word))
    column masks.  Index lists may repeat an entry (both operations are
    idempotent)."""
    prev_all[row_slots, row_ents, :] = 0
    cols = prev_all[col_slots, :, col_words] & col_masks[:, None]
    prev_all[col_slots, :, col_words] = cols


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


def _emit_expand(bucket, chg_vals, ent_vals, gidx):
    """Classified word stream -> sorted (enter, leave) (space, observer,
    observed) rows through the bucket's emit path: the C++ expansion when
    the bucket runs ``emit="native"``, the numpy one otherwise (equal
    either way).  Harvest-phase numpy on already-fetched arrays."""
    if bucket._emit == "native" and len(chg_vals):
        return AE.expand_words_native(chg_vals, ent_vals, gidx,
                                      bucket.capacity)
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


@dataclass(eq=False)
class SpaceAOIHandle:
    backend: str
    capacity: int
    bucket: "_Bucket"
    slot: int
    released: bool = False


class AOIEngine:
    """Per-process registry of AOI state, one device bucket per capacity.

    ``device``: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``
    (the plain PyTorch step -- what the tests run).  ``delta_staging``
    ships sparse x/z packets instead of whole input arrays;
    ``flush_sched`` dispatches every bucket before the first harvest
    (False: each bucket dispatches and harvests in turn); ``emit`` picks
    the fan-out (``auto`` | ``native`` | ``vector``).

    ``mesh`` (a :class:`..parallel.SpaceMesh`, or a device count for that
    many distinct CUDA devices) puts the engine on several shards, as the
    JAX package routes (``engine/aoi.py`` ``create_space``): a space of
    capacity at least ``rowshard_min_capacity`` and a multiple of
    ``n_shards * 128`` gets its own row-sharded bucket
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
    accept it and run unfused.  ``paged`` is not in the port yet and
    raises."""

    def __init__(self, device="cuda", delta_staging: bool = True,
                 flush_sched: bool = True, emit: str = "auto", mesh=None,
                 rowshard_min_capacity: int = 65536, pipeline: bool = False,
                 cross_tick: bool = False, fused: bool = False,
                 paged: bool = False):
        if paged:
            refuse_later("paged")
        self.pipeline = bool(pipeline)
        self.cross_tick = bool(cross_tick)
        self.fused = bool(fused)
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
        # (kind, capacity or serial) -> bucket; kinds "cuda", "mesh",
        # "rowshard" (one exclusive bucket per space)
        self._buckets: dict[tuple, _Bucket] = {}

    def _resolve_emit(self) -> str:
        """Resolve the requested emit mode once (resolution may build
        libgwemit with make; it must not flap per bucket)."""
        if self._emit_resolved is None:
            self._emit_resolved = AE.resolve_mode(self.emit)
        return self._emit_resolved

    def _modes(self) -> dict:
        return {"pipeline": self.pipeline, "cross_tick": self.cross_tick,
                "fused": self.fused}

    def create_space(self, capacity: int,
                     backend: str | None = None) -> SpaceAOIHandle:
        _check_backend(backend)
        capacity = P.round_capacity(capacity)
        mesh = self.mesh
        if (mesh is not None and capacity >= self.rowshard_min_capacity
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
        return SpaceAOIHandle("cuda", capacity, bucket, slot)

    def release_space(self, h: SpaceAOIHandle) -> None:
        if not h.released:
            h.bucket.release_slot(h.slot)
            h.released = True
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
        compaction and the async count copy -- no waits) before the first
        harvest blocks, so bucket N+1's device work overlaps bucket N's
        host decode.  Buckets go in key order (kind, capacity).  ``flush_sched=False``
        runs each bucket's dispatch and harvest before the next starts."""
        buckets = [self._buckets[k] for k in sorted(self._buckets)]
        if not self.flush_sched:
            for bucket in buckets:
                bucket.dispatch()
                bucket.harvest()
            return
        for bucket in buckets:
            bucket.dispatch()
        for bucket in buckets:
            bucket.harvest()

    def has_pending(self) -> bool:
        """True when a bucket holds a dispatched-but-undelivered tick (the
        runtime keeps flushing until it is delivered)."""
        return any(self._buckets[k]._inflight is not None
                   for k in sorted(self._buckets))

    def drain(self) -> None:
        """Deliver every tick still in flight without dispatching a new
        one (shutdown, state carry-over, tests); buckets in key order."""
        for k in sorted(self._buckets):
            self._buckets[k].drain()

    def take_events(self, h: SpaceAOIHandle):
        """(enter_pairs, leave_pairs) for this space from the last flush."""
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

    def grow_space(self, h: SpaceAOIHandle,
                   new_capacity: int) -> SpaceAOIHandle:
        """Move a space to a larger-capacity bucket, carrying its interest
        state so the growth itself emits no enter/leave events."""
        new_capacity = P.round_capacity(new_capacity)
        if new_capacity <= h.capacity:
            raise ValueError("grow_space requires a larger capacity")
        nh = self.create_space(new_capacity)
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
        self.release_space(h)
        return nh

    def attach_interest(self, h, policies, mode=None):
        raise ValueError("interest-policy stacks are not in the port yet; "
                         "they come with ROADMAP.md queue 1, item 6")


class _Bucket:
    """Slot-managed batch of spaces sharing a capacity."""

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

    def drain(self) -> None:
        """Deliver a tick still in flight (no-op for a synchronous
        bucket)."""
        self.harvest()

    # subclass API
    def _grow_to(self, n_slots: int) -> None:
        raise NotImplementedError

    def _reset_slot(self, slot: int) -> None:
        raise NotImplementedError


class _Deferred:
    """The flush schedule of a bucket that can defer delivery by one tick.
    The bucket sets ``pipeline``, ``cross_tick``, ``_inflight`` (the
    record parked across flushes) and ``_due`` (the record the next
    harvest() delivers), and provides ``_dispatch_tick()`` (enqueue one
    tick: its record, or None when nothing was staged) and
    ``_harvest(rec)``."""

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
        nothing new delivers the parked record)."""
        if self._due is not None:
            # re-entrant flush (get_prev mid-scheduler): deliver the
            # record already due first
            self.harvest()
        rec = self._dispatch_tick()
        if self._defer:
            self._due, self._inflight = self._inflight, rec
        else:
            self._due = rec

    def harvest(self) -> None:
        """Phase 2: deliver the record dispatch() made due."""
        rec, self._due = self._due, None
        if rec is not None:
            self._harvest(rec)

    def drain(self) -> None:
        """Deliver the record in flight without dispatching a new one."""
        self.harvest()
        rec, self._inflight = self._inflight, None
        if rec is not None:
            self._harvest(rec)


class _CUDABucket(_Deferred, _Bucket):
    """Device-resident interest state [S, C, W] int32 on the engine's
    device; one kernel launch per flush for every staged slot.

    S (slot count) grows by doubling; state survives growth.  Unstaged
    slots are not stepped: their previous words carry forward untouched.
    The host keeps SHADOWS of the staged inputs ([S, C] numpy, bitwise
    identical to the device copies) so each tick ships only the x/z
    entries whose bit patterns changed, and a lazy MIRROR of the packed
    words (seeded on the first :meth:`peek_words`, then kept current by
    XORing each harvested tick) so plain entities' interest sets derive on
    the host without a device round trip.

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
    entries changed, every acquired slot staged) as one replay of a CUDA
    graph over the whole [S] grid
    (:mod:`..ops.fused`); any other tick runs the unfused flow, and both
    records take the same harvest."""

    def __init__(self, capacity: int, device: torch.device,
                 delta_staging: bool = True, emit: str = "vector",
                 pipeline: bool = False, cross_tick: bool = False,
                 fused: bool = False):
        super().__init__(capacity)
        self.device = device
        self.delta_staging = delta_staging
        self.pipeline = bool(pipeline)
        self.cross_tick = bool(cross_tick)
        self.fused = bool(fused)
        self._emit = emit
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
        # mirror clears issued while a record is in flight, tagged with
        # the slot's epoch: they apply after that record's XOR
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
        # fully re-upload (grow/reset, r/act change)
        self._dev: dict[str, torch.Tensor] = {}
        self._dev_stale: set[str] = {"xz", "ra"}
        # delta path bails to a full restage past this changed fraction
        self._delta_max_frac = 0.25
        self._fz: FZ.FusedTri | None = None  # the fused tick's buffers
        # h2d_bytes: wire bytes shipped; delta/full_flushes: how each
        # tick's inputs were staged; decode_overflow: ticks recovered from
        # the full grids; emit_path: 0 native, 1 vector; fused_dispatches:
        # ticks run as one graph replay; fused_demotions: fused attempts
        # a fault moved to the unfused flow (0: the port has no fault
        # seams yet); prefetch_hits/misses: deferred harvests whose
        # triples the optimistic slice held / did not hold
        self.stats = {"h2d_bytes": 0, "delta_flushes": 0, "full_flushes": 0,
                      "decode_overflow": 0,
                      "emit_path": AE.EMIT_LEVEL[emit],
                      "fused_dispatches": 0, "fused_demotions": 0,
                      "prefetch_hits": 0, "prefetch_misses": 0}
        # cumulative seconds: stage = host pack + H2D + enqueue (dispatch),
        # fetch = waits for the count and the triples or grids, decode =
        # mirror upkeep (and the overflow expansion), emit = fan-out +
        # publish
        self.perf = {"stage_s": 0.0, "fetch_s": 0.0, "decode_s": 0.0,
                     "emit_s": 0.0}

    def _grow_to(self, n_slots: int) -> None:
        if n_slots <= self.s_max:
            return
        self.drain()
        new_s = max(1, self.s_max)
        while new_s < n_slots:
            new_s *= 2
        new_prev = torch.zeros((new_s, self.capacity, self.W),
                               dtype=torch.int32, device=self.device)
        if self.prev is not None and self.s_max > 0:
            new_prev[: self.s_max] = self.prev
        self.prev = new_prev
        if self._mirror is not None:
            grown = np.zeros((new_s, self.capacity, self.W), np.uint32)
            grown[: self._mirror.shape[0]] = self._mirror
            self._mirror = grown
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
        self._dev_stale = {"xz", "ra"}
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
        self._dev_stale.update(("xz", "ra"))
        self._mirror_stale.discard(slot)
        if self._mirror is not None:
            # at once even with a tick in flight: its stream is epoch-
            # guarded, so a dead occupant's rows cannot XOR back over it
            self._mirror_apply(("reset", slot))

    def release_slot(self, slot: int) -> None:
        self._slot_epoch[slot] = self._slot_epoch.get(slot, 0) + 1
        super().release_slot(slot)

    def set_subscribed(self, slot: int, flag: bool) -> None:
        if flag:
            self._unsub.discard(slot)
        else:
            self._unsub.add(slot)
        if slot < self._hsub.shape[0]:
            self._hsub[slot] = flag

    def clear_entity(self, slot: int, entity_slot: int) -> None:
        self._pending_clear.append((slot, entity_slot))
        if self._mirror is None:
            return
        op = ("clear", slot, entity_slot)
        if self._inflight is not None or self._due is not None:
            # the clear postdates the record in flight: it must land after
            # that record's XOR, or the XOR would re-plant the bit
            self._mirror_ops.append(op + (self._slot_epoch.get(slot, 0),))
        else:
            self._mirror_apply(op)

    def _mirror_apply(self, op: tuple) -> None:
        if op[0] == "reset":
            self._mirror[op[1]] = 0
        else:
            _slot, e = op[1], op[2]
            self._mirror[_slot, e, :] = 0
            w, b = P.word_bit_for_column(e, self.capacity)
            self._mirror[_slot, :, w] &= np.uint32(
                ~(np.uint32(1) << np.uint32(b)) & 0xFFFFFFFF)

    def _apply_mirror_ops(self) -> None:
        """Clears queued behind a record apply once its stream has; the
        epoch tag drops those whose slot was released since."""
        ops, self._mirror_ops = self._mirror_ops, []
        if self._mirror is None:
            return
        for op in ops:
            if self._slot_epoch.get(op[1], 0) == op[-1]:
                self._mirror_apply(op[:-1])

    # -- the tick -------------------------------------------------------

    def _dispatch_tick(self) -> dict | None:
        """Maintenance, staging, kernel, compaction and the async count
        copy of one tick; its record, or None when nothing was staged."""
        if not (self._staged or self._pending_reset or self._pending_clear):
            return None
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
        sub = self._hsub[sl]
        if self._mirror is not None and not sub.all():
            self._mirror_stale.update(s for s in slots if s in self._unsub)
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
        if self.device.type == "cuda":
            rec["count"] = torch.empty(1, dtype=torch.int64, pin_memory=True)
            rec["count"].copy_(count, non_blocking=True)
            if ndp:
                pf = torch.empty((ndp, 3), dtype=torch.int32,
                                 pin_memory=True)
                pf.copy_(tri[:ndp], non_blocking=True)
                rec["prefetch"] = pf
            rec["ready"] = torch.cuda.Event()
            rec["ready"].record(torch.cuda.current_stream(self.device))
        else:
            rec["count"] = count.clone()
            if ndp:
                rec["prefetch"] = tri[:ndp].clone()
        return rec

    def _dispatch_unfused(self, slots, sl, sub, old_x, old_z, old_r,
                          old_act) -> dict:
        self._stage_inputs(sl, old_x, old_z, old_r, old_act)
        dev = self._dev
        every = len(slots) == self.s_max  # slots are sorted and unique
        if every:
            x, z, r, act, prev_rows = (dev["x"], dev["z"], dev["r"],
                                       dev["act"], self.prev)
        else:
            idx = AS.h2d(sl.astype(np.int64), self.device)
            x, z, r, act, prev_rows = (
                t.index_select(0, idx) for t in
                (dev["x"], dev["z"], dev["r"], dev["act"], self.prev))
        DC.record()
        new, chg = AK.aoi_step_chg(x, z, r, act, prev_rows)
        if every:
            self.prev = new
        else:
            self._detach_parked_new()
            self.prev.index_copy_(0, idx, new)
        if not sub.any():
            return self._record(slots, sub, new, chg)
        if not sub.all():
            # slots with no event consumers contribute nothing to the
            # change stream (``new`` above stays unmasked: prev must stay
            # authoritative)
            off = np.nonzero(~sub)[0].astype(np.int64)
            chg[AS.h2d(off, self.device)] = 0
        tri, count = EV.extract_triples(chg, new, self.capacity,
                                        self._max_triples)
        return self._record(slots, sub, new, chg, tri, count.reshape(1))

    def _dispatch_fused(self, slots, sl, sub, old_x, old_z, old_r,
                        old_act) -> dict | None:
        """The tick as one graph replay, or None when it is not eligible
        (then the unfused flow runs it: not a demotion)."""
        if (not self.delta_staging or self._dev_stale or "x" not in self._dev
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
        fz = self._fz
        if fz is None:
            fz = self._fz = FZ.FusedTri(
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
        new, chg, tri, count = fz.run(parity, self._max_triples, dev["x"],
                                      dev["z"], dev["r"], dev["act"])
        self.prev = new
        self.stats["fused_dispatches"] += 1
        return self._record(slots, sub, new, chg, tri, count)

    def _detach_parked_new(self) -> None:
        """Before ``self.prev`` is written in place: a parked record whose
        new words ARE ``self.prev`` keeps a copy (its overflow recovery
        reads them)."""
        for rec in (self._inflight, self._due):
            if rec is not None and rec["grids"][0] is self.prev:
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
        prefetched slice when it holds them all; past the cap, the full
        grids), update the mirror and publish per-slot events."""
        slots, mt = rec["slots"], rec["mt"]
        c = self.capacity
        new, chg = rec["grids"]
        t_f0 = time.perf_counter()
        if rec["all_unsub"]:
            count = 0
        else:
            if rec["ready"] is not None:
                rec["ready"].synchronize()
            count = int(rec["count"][0])
        if count > mt:
            # triple-cap overflow: the compact buffer is truncated, so
            # recover this tick from the full grids, then grow the cap so
            # the next tick compacts on device again (counted)
            self.stats["decode_overflow"] += 1
            if self._max_triples < _TRI_MAX:
                self._max_triples = min(
                    _TRI_MAX, 1 << (2 * count - 1).bit_length())
            self._tri.reset_after_growth()
            chg_h = P.words_to_numpy(chg).reshape(-1)
            new_h = P.words_to_numpy(new).reshape(-1)
            gidx = np.nonzero(chg_h)[0]
            chg_vals = chg_h[gidx]
            ent_vals = chg_vals & new_h[gidx]
            self.perf["fetch_s"] += time.perf_counter() - t_f0
            t_f0 = time.perf_counter()
            self._mirror_xor_stream(slots, rec["epochs"], gidx, chg_vals)
            self._apply_mirror_ops()
            self.perf["decode_s"] += time.perf_counter() - t_f0
            t_f0 = time.perf_counter()
            self._publish(slots, rec["epochs"], chg_vals, ent_vals, gidx)
            self.perf["emit_s"] += time.perf_counter() - t_f0
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
        pe, pl = AE.fanout_triples(tri_h, c, native=(self._emit == "native"))
        self._publish_pairs(slots, rec["epochs"], _split_rows(pe),
                            _split_rows(pl))
        self.perf["emit_s"] += time.perf_counter() - t_f0

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
        arrays after grow/reset, when r/act changed, when the changed
        fraction exceeds _delta_max_frac, or without delta staging.  The
        diff compares float BIT PATTERNS (NaN payloads, -0.0 vs 0.0), so
        the device copy stays byte-identical to the shadow."""
        new_x, new_z = self._hx[sl], self._hz[sl]
        diff = (new_x.view(np.uint32) != old_x.view(np.uint32)) \
            | (new_z.view(np.uint32) != old_z.view(np.uint32))
        n_changed = np.count_nonzero(diff)
        if not (np.array_equal(self._hr[sl], old_r)
                and np.array_equal(self._hact[sl], old_act)):
            self._dev_stale.update(("ra", "xz"))
        stale = self._dev_stale
        if (self.delta_staging and not stale and "x" in self._dev
                and n_changed <= self._delta_max_frac * diff.size):
            if n_changed:
                rows, cols = np.nonzero(diff)
                pkt = AS.pad_packet(sl[rows], cols, new_x[rows, cols],
                                    new_z[rows, cols])
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
        stale.clear()
        self.stats["full_flushes"] += 1

    def _h2d(self, role: str, arr: np.ndarray) -> None:
        """Full upload of one shadow role array, into its device tensor in
        place (a captured graph keeps reading it); never aliasing the
        shadow on the CPU device."""
        self.stats["h2d_bytes"] += arr.nbytes
        self._dev[role] = AS.h2d(arr, self.device, out=self._dev.get(role))

    # -- publish ----------------------------------------------------------

    def _publish(self, slots, epochs, chg_vals, ent_vals, gidx) -> None:
        """Expand a classified change stream into per-slot (enter, leave)
        pair arrays and publish them."""
        pe, pl = EV.expand_classified_host(chg_vals, ent_vals, gidx,
                                           self.capacity)
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
        refreshes its rows from the device on demand."""
        if self._mirror is None:
            self.drain()
            self._mirror = P.words_to_numpy(self.prev)
            # maintenance queued for the next dispatch already holds for
            # the host view
            for s in sorted(self._pending_reset):
                self._mirror_apply(("reset", s))
            for s, e in self._pending_clear:
                self._mirror_apply(("clear", s, e))
            self._mirror_stale.clear()
        elif slot in self._mirror_stale:
            self.flush()
            self.drain()
            self._mirror[slot] = P.words_to_numpy(self.prev[slot])
            self._mirror_stale.discard(slot)
        return self._mirror[slot]

    def get_prev(self, slot: int) -> np.ndarray:
        """Previous-tick interest words [C, W] uint32 (after applying
        pending steps and delivering every tick in flight), for state
        carry-over."""
        self.flush()
        self.drain()
        return P.words_to_numpy(self.prev[slot])

    def set_prev(self, slot: int, words: np.ndarray) -> None:
        """Seed a slot's previous-tick interest words [C, W] uint32."""
        self.flush()
        self.drain()
        self._pending_reset.discard(slot)
        w = np.asarray(words, np.uint32)
        self.prev[slot] = P.words_to_torch(w, self.device)
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
