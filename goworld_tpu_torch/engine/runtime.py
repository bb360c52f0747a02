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
does.  Placement, cohorts, checkpoints, telemetry and the crontab of
the JAX runtime are not in the port yet (ROADMAP.md lists them; the
options that select them raise).
"""

from __future__ import annotations

import time
from typing import Callable

from .. import faults
from .aoi import AOIEngine
from .entity import SYNC_NEIGHBORS, SYNC_OWN, Entity
from .manager import EntityManager
from .post import PostQueue
from .timers import TimerQueue


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
        fault_plan=None,
        now: Callable[[], float] = time.monotonic,
        on_error: Callable[[BaseException], None] | None = None,
    ):
        # before the engine: buckets decide at construction whether to keep
        # their host mirrors eagerly (faults.active())
        if fault_plan is not None:
            faults.install(fault_plan)
        self.now = now
        self.on_error = on_error or self._default_on_error
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
                             interest_mode=aoi_interest)
        self.timers = TimerQueue(now)
        self.post = PostQueue()
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

    def _default_on_error(self, e: BaseException):
        import traceback

        traceback.print_exception(type(e), e, e.__traceback__)

    # -- the tick ----------------------------------------------------------
    def tick(self):
        self.tick_count += 1
        self.timers.tick(self.on_error)
        self._aoi_phase()
        self._sync_phase()
        self.post.tick(self.on_error)

    def _aoi_phase(self):
        spaces = list(self.entities.spaces.values())
        staged = False
        for sp in spaces:
            staged = sp.submit_aoi() or staged
        # a deferred bucket may hold a tick in flight with nothing new
        # staged: the flush still delivers it
        if staged or self.aoi.has_pending():
            self.aoi.flush()
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
