"""The game runtime of the port: single logic thread + batched tick phases.

A slimmed port of the JAX package's ``engine/runtime.py``.  Each tick runs,
in this order (part of the engine contract):

  1. timers -- user logic (AI moves, scheduled callbacks);
  2. AOI    -- submit dirty spaces, one batched device step per bucket,
               replay enter/leave events through entity hooks;
  3. sync   -- position/yaw records for every entity flagged dirty, and
               attr deltas;
  4. post   -- callbacks queued during the tick.

``device`` says where the ``cuda`` backend's tensors live (``"cuda"`` by
default, ``"cpu"`` for the plain PyTorch path); ``aoi_backend`` which
calculator a space gets (``cuda`` by default -- the JAX runtime's default
is ``cpu`` -- or ``cpu``, ``cpp``, ``auto``: ``cpp`` below
``aoi_cuda_min_capacity``, ``cuda`` from there on).  ``aoi_pipeline`` /
``aoi_cross_tick`` defer the AOI events by one tick (the tick keeps
flushing while a tick is in flight), ``aoi_fused`` runs the steady
single-device tick as one graph replay and ``aoi_paged`` compacts the
change stream into pages (see :class:`.aoi.AOIEngine`); ``aoi_interest``
is where interest-policy stacks evaluate (``device``: the engine's
device, ``host``: the numpy oracle).  The sync phase first drains the
spaces whose sync column the batched ingest (:mod:`..ingest`) flagged.
``fault_plan`` (a :class:`..faults.FaultPlan` or its string) installs into
the port's :mod:`..faults` before the engine is built, as the JAX runtime
does.

``aoi_cohort`` (False | True | ``"auto"`` | ``"solo"``) and
``aoi_cohort_ladder`` stack small device spaces into shared cohort
buckets (see :class:`.aoi.AOIEngine`).

After the post phase, in the JAX runtime's order: the placement
controller steps (:mod:`.placement`; ``aoi_placement="auto"`` moves hot
host spaces to the device and idle device spaces to the host, live, one
at a time; ``static`` leaves that to ``placement.migrate``), then, with
``aoi_cohort`` on, the cohort planner (:class:`.placement.CohortPlanner`:
``aoi_cohort_planner="auto"`` sheds a member of a cohort over
``aoi_cohort_hot_ms`` and folds light solo spaces back, at most
``aoi_cohort_churn_budget`` moves a window and ``aoi_cohort_cooldown``
quiet ticks after one), then the checkpoint controller tracks the live
AOI spaces and captures the due ones (:mod:`.checkpoint`;
``aoi_checkpoint="interval"`` every ``aoi_checkpoint_interval`` ticks or
``"continuous"`` every tick, into ``aoi_checkpoint_store`` /
``aoi_checkpoint_kvdb`` or the filesystem backends under
``aoi_checkpoint_dir``; :meth:`arm_checkpoints` attaches one later).

Telemetry (:mod:`..telemetry`): ``telemetry_on=True`` enables it with the
runtime's ``now`` as the span clock.  The tick then records the spans
``tick`` (whole), ``tick.timers`` (timers and ``crontab.maybe_check()``),
``tick.aoi`` (with ``aoi.flush`` -- ``aoi.dispatch`` / ``aoi.harvest``
inside -- and ``aoi.emit``), ``tick.sync`` and ``tick.post``, marks each
tick and observes the ``tick.seconds`` histogram; disabled, each hook is
a no-op.  ``GW_TICK_BUDGET_MS`` (environment, 0 = off) makes a tick over
budget call ``flight.slo_breach``.  The spans read the host clock only:
no device sync.
"""

from __future__ import annotations

import os
import time
from typing import Callable

from .. import faults, telemetry
from ..telemetry import trace as _trace
from ..utils.crontab import Crontab
from .aoi import AOIEngine
from .entity import SYNC_NEIGHBORS, SYNC_OWN, Entity
from .manager import EntityManager
from .placement import PlacementController
from .post import PostQueue
from .timers import TimerQueue

# whole-tick latency histogram (pow2 buckets); a no-op while telemetry is
# disabled
_TICK_SECONDS = telemetry.histogram(
    "tick.seconds", "whole-tick wall time (timers+aoi+sync+post)")

# SLO gate: a tick over this budget trips the flight recorder (0 = off);
# an ops knob, read from the environment
try:
    _TICK_BUDGET_MS = float(os.environ.get("GW_TICK_BUDGET_MS", "0") or 0)
except ValueError:
    _TICK_BUDGET_MS = 0.0


class Runtime:
    def __init__(
        self,
        device="cuda",
        aoi_backend: str = "cuda",
        aoi_cuda_min_capacity: int = 4096,
        aoi_delta_staging: bool = True,
        aoi_flush_sched: bool = True,
        aoi_emit: str = "auto",
        aoi_mesh=None,
        aoi_rowshard_min_capacity: int = 65536,
        aoi_pipeline: bool = False,
        aoi_cross_tick: bool = False,
        aoi_fused: bool = False,
        aoi_paged: bool = False,
        aoi_interest: str = "device",
        aoi_placement: str = "static",
        aoi_migration_threshold_ms: float = 5.0,
        aoi_migration_cooldown: int = 64,
        aoi_cohort=False,
        aoi_cohort_ladder=None,
        aoi_cohort_planner: str = "static",
        aoi_cohort_hot_ms: float = 8.0,
        aoi_cohort_churn_budget: int = 2,
        aoi_cohort_cooldown: int = 32,
        aoi_checkpoint: str = "off",
        aoi_checkpoint_interval: int = 16,
        aoi_checkpoint_dir: str | None = None,
        aoi_checkpoint_store=None,
        aoi_checkpoint_kvdb=None,
        fault_plan=None,
        now: Callable[[], float] = time.monotonic,
        on_error: Callable[[BaseException], None] | None = None,
        telemetry_on: bool = False,
    ):
        # before the engine: buckets decide at construction whether to keep
        # their host mirrors eagerly (faults.active())
        if fault_plan is not None:
            faults.install(fault_plan)
        # the injectable clock doubles as the span clock; False leaves the
        # process-wide state as it is (something else may have enabled it)
        if telemetry_on:
            telemetry.enable(clock=now)
        self.now = now
        self.on_error = on_error or self._default_on_error
        self.timers = TimerQueue(now)
        self.post = PostQueue()
        self.crontab = Crontab()
        # aoi_mesh: a SpaceMesh (or a CUDA device count) puts the AOI pass
        # on several shards (see AOIEngine)
        self.aoi = AOIEngine(device=device, default_backend=aoi_backend,
                             cuda_min_capacity=aoi_cuda_min_capacity,
                             delta_staging=aoi_delta_staging,
                             flush_sched=aoi_flush_sched, emit=aoi_emit,
                             mesh=aoi_mesh,
                             rowshard_min_capacity=aoi_rowshard_min_capacity,
                             pipeline=aoi_pipeline, cross_tick=aoi_cross_tick,
                             fused=aoi_fused, paged=aoi_paged,
                             interest_mode=aoi_interest, cohort=aoi_cohort,
                             cohort_ladder=aoi_cohort_ladder)
        self.placement = PlacementController(
            self.aoi, mode=aoi_placement,
            threshold_ms=aoi_migration_threshold_ms,
            cooldown_ticks=aoi_migration_cooldown)
        self.cohort_planner = None
        if aoi_cohort:
            from .placement import CohortPlanner

            self.cohort_planner = CohortPlanner(
                self.aoi, mode=aoi_cohort_planner,
                hot_ms=aoi_cohort_hot_ms,
                churn_budget=aoi_cohort_churn_budget,
                cooldown_ticks=aoi_cohort_cooldown)
        self.checkpoint = None
        if aoi_checkpoint != "off":
            if aoi_checkpoint_store is None or aoi_checkpoint_kvdb is None:
                if aoi_checkpoint_dir is None:
                    raise ValueError(
                        f"aoi_checkpoint={aoi_checkpoint!r} needs "
                        "aoi_checkpoint_dir or store and kvdb backends")
                from .checkpoint import _open_backends

                aoi_checkpoint_store, aoi_checkpoint_kvdb = \
                    _open_backends(aoi_checkpoint_dir)
            self.arm_checkpoints(aoi_checkpoint_store, aoi_checkpoint_kvdb,
                                 mode=aoi_checkpoint,
                                 interval=aoi_checkpoint_interval)
        self.entities = EntityManager(self)
        self.tick_count = 0
        # entities with pending sync flags / attr deltas; the sync phase
        # walks only these.  The set object is stable (entities cache it).
        self._dirty_entities: set[Entity] = set()
        # spaces whose sync COLUMN holds pending flags (the batched ingest's
        # vectorized writes): drained at the head of the sync phase into
        # the per-entity dirty machinery.  A dict used as an ordered set
        self._col_sync_spaces: dict = {}
        # position sync records collected this tick:
        # (client_id, gate_id, entity_id, x, y, z, yaw)
        self.sync_out: list[tuple] = []

    def arm_checkpoints(self, store, manifest, mode: str = "interval",
                        interval: int = 16, **kw):
        """Attach (or replace) the checkpoint controller, journaling into
        ``store`` with its manifest in ``manifest``."""
        from .checkpoint import CheckpointController

        if self.checkpoint is not None:
            self.checkpoint.close()
        self.checkpoint = CheckpointController(
            self.aoi, store, manifest, mode=mode, interval=interval, **kw)
        return self.checkpoint

    def _default_on_error(self, e: BaseException):
        import traceback

        traceback.print_exception(type(e), e, e.__traceback__)

    # -- the tick ----------------------------------------------------------
    def tick(self):
        self.tick_count += 1
        _trace.mark_tick(self.tick_count)
        _t0 = _trace.t()
        _wall0 = time.perf_counter() if _TICK_BUDGET_MS > 0 else 0.0
        with _trace.span("tick.timers"):
            self.timers.tick(self.on_error)
            self.crontab.maybe_check()
        with _trace.span("tick.aoi"):
            self._aoi_phase()
        with _trace.span("tick.sync"):
            self._sync_phase()
        with _trace.span("tick.post"):
            self.post.tick(self.on_error)
        # between ticks: this tick's events are delivered, so a migration
        # or a cohort move snapshots no half-staged state and a capture is
        # consistent
        self.placement.step()
        if self.cohort_planner is not None:
            self.cohort_planner.step()
        if self.checkpoint is not None:
            self.checkpoint.sync_tracked({
                sid: sp._aoi_handle
                for sid, sp in self.entities.spaces.items()
                if sp._aoi_handle is not None})
            self.checkpoint.step(self.tick_count)
        _TICK_SECONDS.observe(_trace.lap("tick", _t0))
        if _TICK_BUDGET_MS > 0:
            dur_ms = (time.perf_counter() - _wall0) * 1000.0
            if dur_ms > _TICK_BUDGET_MS:
                from ..telemetry import flight as _flight

                _flight.slo_breach(self.tick_count, dur_ms, _TICK_BUDGET_MS)

    def _aoi_phase(self):
        spaces = list(self.entities.spaces.values())
        staged = False
        for sp in spaces:
            staged = sp.submit_aoi() or staged
        # a deferred bucket may hold a tick in flight with nothing new
        # staged: the flush still delivers it
        if staged or self.aoi.has_pending():
            with _trace.span("aoi.flush"):
                self.aoi.flush()
            with _trace.span("aoi.emit"):
                for sp in spaces:
                    sp.dispatch_aoi_events()
        # slots freed last tick become reusable only now, after event
        # delivery
        for sp in spaces:
            sp.recycle_aoi_slots()

    def _sync_phase(self):
        """Collect position sync + flush attr deltas for DIRTY entities
        only; the dirty set is drained in place, never swapped.  Pending
        sync-column flags (batched ingest) fold in first, so batched and
        per-entity movement emit through one path."""
        css = self._col_sync_spaces
        if css:
            for sp in css:
                sp.drain_column_sync()
            css.clear()
        ds = self._dirty_entities
        if not ds:
            return
        dirty = list(ds)
        ds.clear()
        for e in dirty:
            if e.destroyed:
                continue
            flags = e._sync_flags
            if flags:
                e._sync_flags = 0
                if (e.client is not None or
                        (flags & SYNC_NEIGHBORS and e._watcher_clients > 0)):
                    self._collect_sync(e, flags)
            if e._attr_deltas:
                e._flush_attr_deltas()

    def _collect_sync(self, e: Entity, flags: int):
        """One record per flagged entity per tick."""
        x, y, z = e.position.to_tuple()
        if flags & SYNC_OWN and e.client is not None:
            self.sync_out.append(
                (e.client.client_id, e.client.gate_id, e.id, x, y, z, e.yaw)
            )
        if flags & SYNC_NEIGHBORS and e._watcher_clients > 0:
            for other in e.interested_by:
                if other.client is not None:
                    self.sync_out.append(
                        (other.client.client_id, other.client.gate_id,
                         e.id, x, y, z, e.yaw))

    def drain_sync(self) -> list[tuple]:
        out = self.sync_out
        self.sync_out = []
        return out
