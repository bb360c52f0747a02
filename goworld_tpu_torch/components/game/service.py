"""Game service: hosts the entity runtime inside the cluster fabric.

Reference: components/game (game.go boot sequence, GameService.go main loop).
One logic thread drains the packet queue and runs the Runtime tick phases;
recv threads only enqueue (the reference's single-goroutine invariant).

Outbound plumbing per tick:
  * entity register/unregister -> MT_NOTIFY_CREATE/DESTROY_ENTITY (directory);
  * GameClient outboxes -> redirect-band packets to the owning gate;
  * position sync records -> per-gate MT_SYNC_POSITION_YAW_ON_CLIENTS batches
    (reference: CollectEntitySyncInfos, Entity.go:1221-1267);
  * remote RPC -> MT_CALL_ENTITY_METHOD via the entity's dispatcher shard.

The port's copy of the JAX package's ``components/game/service.py``.  Its
Runtime ticks the AOI on ``gcfg.aoi_device`` (``cuda`` by default: the
hand-written step kernel; ``cpu`` runs its plain PyTorch version) with
the calculator ``gcfg.aoi_backend`` names.  ``attach_checkpoints``
journals the game's spaces as ``aoi_device`` holds them: a ``cuda``
bucket's words are exported from the card.
"""

from __future__ import annotations

import os
import queue
import threading
import time

from ... import consts, faults, telemetry
from ...telemetry import flight, tracectx
from ...config import ClusterConfig
from ...consts import COMPONENT_QUEUE_MAX
from ...dispatchercluster import DispatcherCluster
from ...engine.entity import Entity, GameClient
from ...engine.ids import fixed_id, gen_id
from ...engine.runtime import Runtime
from ...engine.space import Space
from ...engine.vector import Vector3
from ...ingest import MovementIngest
from ...netutil import Packet
from ...proto import GWConnection, msgtypes as MT
from ...utils.asyncjobs import JobError
from ...utils import binutil, gwlog, gwutils, gwvar, opmon
from .lbc import LoadReporter

# the most inbound packets the logic loop handles between two due ticks
DRAIN_MAX = 1024


class NilSpace(Space):
    """Kindless per-game space (reference: Space.go:127-140); entities live
    here logically when not in a real space; receives OnGameReady."""


class GameService:
    def __init__(self, game_id: int, cfg: ClusterConfig, freeze_dir: str = "."):
        self.id = game_id
        self.cfg = cfg
        self.gcfg = cfg.games[game_id]
        self.freeze_dir = freeze_dir
        self.log = gwlog.logger(f"game{game_id}")
        self.rt = Runtime(
            device=self.gcfg.aoi_device,
            aoi_backend=self.gcfg.aoi_backend,
            on_error=lambda e: self.log.exception("entity error", exc_info=e),
            aoi_mesh=self.gcfg.aoi_mesh_devices or None,
            aoi_pipeline=self.gcfg.aoi_pipeline,
            aoi_cuda_min_capacity=self.gcfg.aoi_cuda_min_capacity,
            aoi_rowshard_min_capacity=self.gcfg.aoi_rowshard_min_capacity,
        )
        self.rt.on_entity_registered = self._on_entity_registered
        self.rt.on_entity_unregistered = self._on_entity_unregistered
        self.rt.game = self  # entities reach cluster ops through this
        # batched wire->column movement decode (goworld_tpu_torch/ingest/)
        self.ingest = MovementIngest(self.rt)
        self.queue: "queue.Queue[tuple]" = queue.Queue(maxsize=COMPONENT_QUEUE_MAX)
        self.cluster = DispatcherCluster(
            cfg.dispatcher_addrs(),
            on_packet=lambda i, p: self.queue.put((i, p)),
            register=self._register_to_dispatcher,
            tag=f"game{game_id}",
        )
        self.nil_space: NilSpace | None = None
        self.deployment_ready = False
        self.srvmap: dict[str, str] = {}
        self.on_srvdis_update = None  # service layer hook
        self._migrating: dict[str, dict] = {}  # eid -> {"space_id","pos"}
        self._freeze_acks_wanted = 0
        self._freeze_acks = 0
        self._frozen_file = os.path.join(self.freeze_dir, f"game{game_id}_frozen.dat")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._registering_suppressed = False
        self._suppress_notify_eids: set[str] = set()
        self._dirty_clients: set[GameClient] = set()
        self._lbc = LoadReporter()
        self.storage = None  # EntityStorageService, via attach_storage
        self.kvdb = None  # KVDBService, via attach_kvdb
        # cluster supervision (docs/robustness.md "Cluster supervision &
        # host failover"): per-dispatcher ownership epoch from the last
        # MT_GAME_LEASE_GRANT; renewed at the _renew_every cadence
        self._lease_epochs: dict[int, int] = {}
        self._renew_every = 1.0
        self.shutdown_notice = False  # set when a dispatcher fences us
        # failover re-homing bookkeeping: space id -> (handle, tick) of the
        # checkpoint restore, plus counted per-space restore failures
        self.rehomed: dict[str, tuple] = {}
        self.rehome_failures = 0
        self.replayed_batches = 0
        self.rt.entities.register(NilSpace, "__nil_space__")

    def attach_storage(self, base_dir: str = "."):
        """Create the async entity-storage service from config (reference:
        storage.Initialize, game.go:100)."""
        from ...storage import EntityStorageService, new_entity_storage
        from ...storage.backends import config_kwargs

        backend = new_entity_storage(
            self.cfg.storage.backend,
            **config_kwargs(self.cfg.storage.backend, self.cfg.storage, base_dir),
        )
        self.storage = EntityStorageService(backend, post=self.rt.post.post)
        return self.storage

    def attach_kvdb(self, base_dir: str = "."):
        from ...kvdb import KVDBService, new_kvdb_backend
        from ...kvdb.backends import config_kwargs

        backend = new_kvdb_backend(
            self.cfg.kvdb.backend,
            **config_kwargs(self.cfg.kvdb.backend, self.cfg.kvdb, base_dir),
        )
        self.kvdb = KVDBService(backend, post=self.rt.post.post)
        return self.kvdb

    def attach_checkpoints(self, base_dir: str = "."):
        """Arm durable world state (engine/checkpoint.py) when
        ``aoi_checkpoint`` is non-off: the journal rides the configured
        [storage] backend, the manifest the [kvdb] backend, both under
        their own sub-directories so entity saves and checkpoints never
        share a namespace.  Returns the controller (None when off)."""
        if self.gcfg.aoi_checkpoint == "off":
            return None
        from ...kvdb import new_kvdb_backend
        from ...kvdb.backends import config_kwargs as kv_kwargs
        from ...storage import new_entity_storage
        from ...storage.backends import config_kwargs as st_kwargs

        ck_dir = os.path.join(base_dir, "checkpoints")
        # the flight recorder dumps into a namespace beside the durable
        # store: the post-mortem lands where the forensics already live
        flight.configure(dir=os.path.join(base_dir, "flight"),
                         component=f"game{self.id}")
        store = new_entity_storage(
            self.cfg.storage.backend,
            **st_kwargs(self.cfg.storage.backend, self.cfg.storage, ck_dir))
        manifest = new_kvdb_backend(
            self.cfg.kvdb.backend,
            **kv_kwargs(self.cfg.kvdb.backend, self.cfg.kvdb, ck_dir))
        return self.rt.arm_checkpoints(
            store, manifest, mode=self.gcfg.aoi_checkpoint,
            interval=self.gcfg.aoi_checkpoint_interval)

    # -- boot --------------------------------------------------------------
    def register_entity_type(self, cls, name=None):
        return self.rt.entities.register(cls, name)

    def start(self, restore: bool = False):
        self._is_restore = restore
        if restore and os.path.exists(self._frozen_file):
            self._restore_from_freeze()
        else:
            self.nil_space = self.rt.entities.create(  # type: ignore[assignment]
                "__nil_space__", eid=fixed_id(f"nilspace-game{self.id}")
            )
        self.cluster.start()
        gwvar.set_var("component", f"game{self.id}")
        if self.gcfg.telemetry:
            # route span stamps through the runtime clock so tick spans and
            # timer deadlines read the same timeline (docs/observability.md)
            telemetry.enable(clock=self.rt.now)
        if self.gcfg.http_port:
            binutil.setup_http_server(self.gcfg.http_port)
        flight.configure(component=f"game{self.id}")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        opmon.start_periodic_dump(consts.OPMON_DUMP_INTERVAL_S)
        gwlog.announce_ready(f"game{self.id}", "game")
        return self

    def stop(self, save: bool = True):
        """Graceful terminate (reference: SIGTERM path, GameService.go:200-219):
        save persistent entities (when storage is attached), destroy all with
        hooks, then drop the cluster links.  Entity teardown is marshaled onto
        the logic thread -- destroying from another thread would race the
        tick's entity iteration."""

        def terminate():
            for e in list(self.rt.entities.entities.values()):
                if save and self.storage is not None and e.persistent:
                    self.storage.save(e.type_name, e.id, e.persistent_data())
                gwutils.run_panicless(e.destroy, logger=self.log)
            self._stop.set()

        if self._thread is not None and self._thread.is_alive():
            self.rt.post.post(terminate)
            self._thread.join(timeout=10)
            if self._thread.is_alive():  # logic thread wedged; force the flag
                self._stop.set()
        else:
            terminate()
        if self.storage is not None:
            self.storage.wait_idle(5.0)
        opmon.stop_periodic_dump()
        self.cluster.stop()

    def _register_to_dispatcher(self, conn: GWConnection):
        # register only the eids of THIS dispatcher's shard: create/destroy
        # notifications are shard-routed, so handing every dispatcher the
        # full list would leave non-shard directories with entries that rot
        # (and then mis-fire duplicate rejection)
        from ...dispatchercluster import entity_shard

        n = len(self.cluster.addrs)
        idx = conn.index  # set by DispatcherCluster before register()
        # snapshot first: this runs on the cluster connect thread while the
        # logic thread mutates the entities dict
        eids = [eid for eid in list(self.rt.entities.entities)
                if entity_shard(eid, n) == idx]
        # is_restore unblocks the dispatcher's frozen-game queue after a
        # hot reload (reference: reconnect-with-restore, GameService freeze)
        conn.send_set_game_id(self.id, getattr(self, "_is_restore", False), eids)

    # -- logic loop --------------------------------------------------------
    def _run(self):
        tick_s = self.gcfg.tick_interval_ms / 1000.0
        sync_s = self.gcfg.position_sync_interval_ms / 1000.0
        next_tick = time.monotonic() + tick_s
        next_sync = time.monotonic() + sync_s
        next_lbc = time.monotonic() + 1.0
        next_renew = time.monotonic()
        while not self._stop.is_set():
            self._handle_queued(max(0.0, next_tick - time.monotonic()))
            now = time.monotonic()
            if now >= next_tick:
                gwutils.run_panicless(self.rt.tick, logger=self.log)
                self._drain_client_outboxes()
                if now >= next_sync:
                    self._send_position_syncs()
                    next_sync = now + sync_s
                if now >= next_lbc:
                    self._report_load()
                    next_lbc = now + 1.0
                if self._lease_epochs and now >= next_renew:
                    self._renew_leases()
                    next_renew = now + self._renew_every
                self.cluster.flush_all()
                next_tick = now + tick_s

    def _handle_queued(self, timeout: float):
        """Handle the packets queued by now, up to DRAIN_MAX, waiting up
        to ``timeout`` for the first.  Taking one packet a loop iteration
        falls behind once a tick outlasts the packets' spacing (at the
        card's width a tick takes 70 ms and more): the queue then grows
        by a packet or more a tick, and what it holds goes stale."""
        for n in range(DRAIN_MAX):
            try:
                i, pkt = (self.queue.get(timeout=timeout) if n == 0
                          else self.queue.get_nowait())
            except queue.Empty:
                return
            gwutils.run_panicless(self._handle, pkt, i, logger=self.log)

    def _report_load(self):
        """Report CPU load to every dispatcher for LBC placement
        (reference: gamelbc.go:17-39)."""
        load = self._lbc.sample()
        for conn in self.cluster.all():
            try:
                conn.send_game_lbc_info(load)
            except OSError:
                pass

    def _checkpointed_space_ids(self) -> list[str]:
        """The re-homing inventory a lease renewal reports: spaces whose
        state the armed checkpoint controller is journaling (what a
        survivor could actually restore if we died)."""
        if self.rt.checkpoint is None:
            return []
        return sorted(
            sid for sid, sp in self.rt.entities.spaces.items()
            if sp._aoi_handle is not None)

    def _renew_leases(self):
        """Renew this game's liveness lease at every granted dispatcher.
        The ``clu.lease`` seam sits in front of the sends: a ``stall``
        fault parks the renewal past the TTL, which is exactly a missed
        lease -- the dispatcher fails our spaces over and the late renewal
        is fenced as a stale epoch."""
        faults.check("clu.lease")
        # telemetry on: the renewal piggybacks this game's metric snapshot
        # (the versioned suffix) so the dispatcher's /debug/metrics serves
        # the whole cluster without a second reporting channel
        metrics = telemetry.snapshot() if telemetry.enabled() else None
        self.cluster.renew_leases(
            self.id, self._lease_epochs, self._checkpointed_space_ids(),
            metrics=metrics)

    def step(self, n: int = 1):
        """Synchronous stepping for tests (no background thread)."""
        assert self._thread is None or not self._thread.is_alive(), (
            "step() must not race the started logic thread"
        )
        for _ in range(n):
            while True:
                try:
                    i, pkt = self.queue.get_nowait()
                except queue.Empty:
                    break
                gwutils.run_panicless(self._handle, pkt, i, logger=self.log)
            self.rt.tick()
            self._drain_client_outboxes()
            self._send_position_syncs()
            self.cluster.flush_all()

    # -- inbound handlers --------------------------------------------------
    def _handle(self, pkt: Packet, disp_index: int = 0):
        # clu.zombie: the split-brain probe.  A ``stall`` parks the logic
        # thread mid-loop -- long enough and the lease expires, our spaces
        # fail over, and when we resume every outbound packet carries a
        # stale epoch and gets fenced (docs/robustness.md)
        faults.check("clu.zombie")
        msgtype = pkt.read_u16()
        if msgtype == MT.MT_SRVDIS_SNAPSHOT:
            self._apply_srvdis_snapshot(disp_index, pkt)
            return
        if msgtype == MT.MT_GAME_LEASE_GRANT:
            # needs disp_index (epochs are per-dispatcher), so it is
            # special-cased like MT_SRVDIS_SNAPSHOT above
            self._apply_lease_grant(disp_index, pkt)
            return
        h = self._HANDLERS.get(msgtype)
        if h is None:
            self.log.warning("unhandled msgtype %d", msgtype)
            return
        h(self, pkt)

    def _h_deployment_ready(self, pkt):
        if self.deployment_ready:
            return
        self.deployment_ready = True
        gwvar.set_var("is_deployment_ready", True)
        self.log.info("deployment ready")
        for e in list(self.rt.entities.entities.values()):
            gwutils.run_panicless(e.on_game_ready, logger=self.log)

    def _h_client_connected(self, pkt):
        client_id = pkt.read_client_id()
        boot_eid = pkt.read_entity_id()
        gate_id = pkt.read_u16()
        boot_type = self.gcfg.boot_entity
        if not boot_type:
            self.log.error("no boot_entity configured")
            return
        e = self.rt.entities.create(boot_type, eid=boot_eid)
        e.set_client(GameClient(client_id, gate_id, self._client_dirty))

    def _h_client_disconnected(self, pkt):
        client_id = pkt.read_client_id()
        owner_eid = pkt.read_entity_id()
        e = self.rt.entities.get(owner_eid)
        if e is not None and e.client is not None and e.client.client_id == client_id:
            e.drop_client_ref()
            gwutils.run_panicless(e.on_client_disconnected, logger=self.log)

    def _h_call_entity_method(self, pkt):
        eid = pkt.read_entity_id()
        method = pkt.read_varstr()
        args = pkt.read_args()
        e = self.rt.entities.get(eid)
        if e is None:
            self.log.warning("call %s on missing entity %s", method, eid)
            return
        gwutils.run_panicless(e.call, method, *args, logger=self.log)

    def _h_call_entities_batch(self, pkt):
        """One RPC delivered to many local entities (the dispatcher already
        grouped the eid list per game).  Args are re-unpacked PER TARGET so
        a callee mutating a container argument cannot leak the mutation into
        later callees -- the same isolation N individual call packets gave."""
        method = pkt.read_varstr()
        args_wire = bytearray(pkt.read_varbytes())
        ap = Packet(args_wire)
        n = pkt.read_u32()
        for _ in range(n):
            e = self.rt.entities.get(pkt.read_entity_id())
            if e is not None:
                ap.rpos = 0
                args = ap.read_args()
                gwutils.run_panicless(e.call, method, *args, logger=self.log)

    def _h_call_entity_method_from_client(self, pkt):
        eid = pkt.read_entity_id()
        method = pkt.read_varstr()
        args = pkt.read_args()
        client_id = pkt.read_client_id()
        e = self.rt.entities.get(eid)
        if e is None:
            return
        gwutils.run_panicless(
            e.on_call_from_client, method, args, client_id, logger=self.log
        )

    def _h_give_client_to(self, pkt):
        """Receive client ownership for a local entity (reference:
        GateService.go:263-294 -- the gate's owner_entity_id switches when
        this entity's is_player create reaches it)."""
        eid = pkt.read_entity_id()
        client_id = pkt.read_client_id()
        gate_id = pkt.read_u16()
        e = self.rt.entities.get(eid)
        if e is None:
            # the handoff target is gone: the client has no owner anywhere --
            # kick it so it reconnects and gets a fresh boot entity
            self.log.warning("give_client_to: no entity %s; kicking client %s",
                             eid, client_id)
            conn = self.cluster.by_gate(gate_id)
            if conn is not None:
                conn.send_kick_client(gate_id, client_id)
            return
        old = e.client  # double handoff: the displaced client's teardown
        e.set_client(GameClient(client_id, gate_id, self._client_dirty))
        if old is not None:
            self._flush_orphan_client(old)

    def _h_call_nil_spaces(self, pkt):
        _exclude = pkt.read_u16()
        method = pkt.read_varstr()
        args = pkt.read_args()
        if self.nil_space is not None:
            gwutils.run_panicless(self.nil_space.call, method, *args, logger=self.log)

    def _h_sync_from_client(self, pkt):
        """Client position syncs arrive as one flat packet per gate flush;
        the batched ingest (goworld_tpu_torch/ingest/) frombuffer-decodes the
        whole record array and lands it in the per-space hot columns with
        vectorized writes -- zero per-entity Python attribute writes on
        the hot path; per-entity set_position stays for AI/logic moves
        (reference: GameService.go:398-410 flat array decode)."""
        # trace trailer off FIRST: ingest frombuffer-decodes remaining()
        # bytes as flat 32-byte records, and stripping must precede the
        # memoryview it takes over pkt.buf
        ctx = tracectx.try_strip(pkt)
        if ctx is not None:
            tracectx.record_hop(ctx, "game.ingest")
            tracectx.record_local_span(ctx, "wire.hop")
        self.ingest.ingest(pkt)

    def _h_create_entity_anywhere(self, pkt):
        eid = pkt.read_entity_id()
        type_name = pkt.read_varstr()
        attrs = pkt.read_data() or {}
        desc = self.rt.entities.registry.get(type_name)
        if desc is not None and desc.is_space:
            # space kind travels as a reserved attr, like the reference's
            # _space_kind_ on the __space__ entity (CreateSpaceAnywhere)
            kind = int(attrs.pop("_space_kind_", 1))
            self.rt.entities.create_space(type_name, kind=kind, eid=eid,
                                          attrs=attrs)
        else:
            self.rt.entities.create(type_name, eid=eid, attrs=attrs)

    def _h_load_entity_anywhere(self, pkt):
        eid = pkt.read_entity_id()
        type_name = pkt.read_varstr()
        storage = getattr(self, "storage", None)
        if storage is None:
            self.log.error("load_entity: no storage attached")
            return
        def on_loaded(data):
            if isinstance(data, JobError):
                # Never create over a read failure -- the entity may exist
                # on disk; a fresh instance would overwrite it on next save.
                self.log.error("load_entity: %s/%s read failed: %r",
                               type_name, eid, data.exception)
                return
            if data is None:
                self.log.warning("load_entity: %s/%s not found", type_name, eid)
                return
            if self.rt.entities.get(eid) is None:
                self.rt.entities.create(type_name, eid=eid, attrs=data or {})
        storage.load(type_name, eid, on_loaded)

    def _apply_srvdis_snapshot(self, disp_index: int, pkt: Packet):
        """Replace this dispatcher shard's slice of the service map with the
        snapshot: prune entries the dispatcher no longer has (released while
        our link was down -- keeping them would let a stale provider believe
        it still owns a singleton), then apply the rest."""
        from ...dispatchercluster import srvid_shard

        n_disp = len(self.cluster.addrs)
        count = pkt.read_u32()
        snap = {}
        for _ in range(count):
            srvid = pkt.read_varstr()
            snap[srvid] = pkt.read_varstr()
        changed = []
        for srvid in list(self.srvmap):
            if srvid_shard(srvid, n_disp) == disp_index and srvid not in snap:
                del self.srvmap[srvid]
                changed.append((srvid, ""))
        for srvid, info in snap.items():
            if self.srvmap.get(srvid) != info:
                self.srvmap[srvid] = info
                changed.append((srvid, info))
        if self.on_srvdis_update is not None:
            for srvid, info in changed:
                gwutils.run_panicless(
                    self.on_srvdis_update, srvid, info, logger=self.log
                )

    def _h_srvdis_update(self, pkt):
        srvid = pkt.read_varstr()
        info = pkt.read_varstr()
        if info:
            self.srvmap[srvid] = info
        else:  # deregistration (provider game died): open for re-claim
            self.srvmap.pop(srvid, None)
        if self.on_srvdis_update is not None:
            gwutils.run_panicless(self.on_srvdis_update, srvid, info, logger=self.log)

    # migration (§3.4)
    def _h_query_space_gameid_ack(self, pkt):
        space_id = pkt.read_entity_id()
        eid = pkt.read_entity_id()
        space_game = pkt.read_u16()
        mig = self._migrating.get(eid)
        e = self.rt.entities.get(eid)
        if mig is None or e is None or space_game == 0:
            self._migrating.pop(eid, None)
            return
        conn = self.cluster.by_entity(eid)
        if conn:
            conn.send_migrate_request(eid, space_id, space_game)

    def _h_migrate_request_ack(self, pkt):
        eid = pkt.read_entity_id()
        space_id = pkt.read_entity_id()
        space_game = pkt.read_u16()
        mig = self._migrating.pop(eid, None)
        e = self.rt.entities.get(eid)
        conn = self.cluster.by_entity(eid)
        if mig is None or e is None:
            if conn:
                conn.send_cancel_migrate(eid)
            return
        if conn is None:
            # dispatcher link mid-reconnect: abort rather than destroy the
            # entity with nowhere to send its state (block expires server-side)
            self.log.warning("migrate of %s aborted: dispatcher unavailable", eid)
            return
        data = e.migrate_data()
        data["target_space"] = space_id
        data["pos"] = mig["pos"].to_tuple()
        gwutils.run_panicless(e.on_migrate_out, logger=self.log)
        e._destroy_impl(is_migrate=True)
        conn.send_real_migrate(eid, space_game, data)

    def _h_real_migrate(self, pkt):
        eid = pkt.read_entity_id()
        _target = pkt.read_u16()
        data = pkt.read_data()
        client = data.get("client")
        e = self.rt.entities.restore(
            data,
            client_factory=lambda cid, gid: GameClient(
                cid, gid, self._client_dirty)
        )
        space_id = data.get("target_space")
        sp = self.rt.entities.spaces.get(space_id) if space_id else None
        if sp is not None:
            x, y, z = data["pos"]
            sp.enter_entity(e, Vector3(x, y, z))

    def _h_reject_duplicate_entity(self, pkt):
        """The dispatcher says our claimed entity lives on another game
        (e.g. a stale copy kept through a failed migration + reconnect):
        tear the local duplicate down QUIETLY -- migrate-style (no save: a
        stale copy must not clobber the legitimate owner's persisted state;
        no on_destroy side effects; no client destroy packet) and without a
        directory notify for this eid, which would wrongly evict the
        legitimate owner's mapping."""
        eid = pkt.read_entity_id()
        e = self.rt.entities.get(eid)
        if e is None:
            return
        self.log.warning("destroying duplicate entity %s (lives elsewhere)", eid)
        e.drop_client_ref()  # the real entity owns the client
        self._suppress_notify_eids.add(eid)
        try:
            gwutils.run_panicless(
                lambda: e._destroy_impl(is_migrate=True), logger=self.log
            )
        finally:
            self._suppress_notify_eids.discard(eid)

    def _h_game_connected(self, pkt):
        gid = pkt.read_u16()
        self.log.info("peer game%d connected", gid)

    def _h_game_disconnected(self, pkt):
        gid = pkt.read_u16()
        self.log.info("peer game%d disconnected", gid)

    def _h_gate_disconnected(self, pkt):
        gate_id = pkt.read_u16()
        # detach all clients of that gate (reference: EntityManager.go:141-148)
        for e in list(self.rt.entities.entities.values()):
            if e.client is not None and e.client.gate_id == gate_id:
                e.drop_client_ref()
                gwutils.run_panicless(e.on_client_disconnected, logger=self.log)

    def _h_freeze_ack(self, pkt):
        self._freeze_acks += 1
        if self._freeze_acks >= self._freeze_acks_wanted:
            self._do_freeze()

    # -- cluster supervision (docs/robustness.md) --------------------------
    def _apply_lease_grant(self, disp_index: int, pkt: Packet):
        """Dispatcher granted (or re-granted, after a re-registration) our
        ownership epoch.  Every renewal from now on must echo it; renewing
        faster than ttl/3 keeps one lost renewal from reading as death."""
        epoch = pkt.read_u32()
        ttl = pkt.read_f32()
        self._lease_epochs[disp_index] = epoch
        if ttl > 0:
            self._renew_every = min(self._renew_every, max(0.05, ttl / 3.0))
        self.log.info("lease granted by dispatcher %d: epoch=%d ttl=%.2fs",
                      disp_index, epoch, ttl)

    def _h_game_shutdown(self, pkt):
        """A dispatcher fenced us: our epoch is stale because our spaces
        were already re-homed to a survivor.  Applying any more world state
        here would double-deliver events, so stop the logic loop without
        saving -- the survivor's checkpoint restore is the authoritative
        state now."""
        self.shutdown_notice = True
        self.log.error("fenced by dispatcher: spaces re-homed elsewhere; "
                       "shutting down without save")
        self._stop.set()

    def _h_rehome_spaces(self, pkt):
        """Failover: adopt a dead game's spaces from the shared checkpoint
        store.  Per-space restore crosses the ``clu.restore`` seam --
        raising kinds abandon that space's re-home (counted), a stall
        stretches ticks_to_recover; neither corrupts the spaces already
        restored."""
        dead_gid = pkt.read_u16()
        epoch = pkt.read_u32()
        n = pkt.read_u32()
        sids = [pkt.read_varstr() for _ in range(n)]
        if self.rt.checkpoint is None:
            self.log.error("rehome of %d spaces from dead game%d: no "
                           "checkpoint controller armed", n, dead_gid)
            self.rehome_failures += n
            return
        for sid in sids:
            try:
                faults.check("clu.restore")
                res = self.rt.checkpoint.restore_into(self.rt.aoi, sid)
            except Exception as e:
                self.log.error("rehome restore of space %s failed: %r", sid, e)
                self.rehome_failures += 1
                continue
            if res is None:
                self.log.error("rehome: no checkpoint found for space %s", sid)
                self.rehome_failures += 1
                continue
            handle, tick, _ck_epoch = res
            self.rehomed[sid] = (handle, tick)
            self.log.info("re-homed space %s from dead game%d at tick %d "
                          "(ownership epoch %d)", sid, dead_gid, tick, epoch)
        if self.rehomed:
            # adopted spaces flush cold for a while -- hold auto placement
            # so warm-up noise cannot trigger a migration mid-recovery
            self.rt.placement.settle()

    def _h_replay_moves(self, pkt):
        """Dispatcher-buffered client movement since the last consistent
        epoch, replayed after the checkpoint restore.  Each payload is a
        full regrouped MT_SYNC_POSITION_YAW_FROM_CLIENT packet; re-entering
        it through _handle routes it into the batched ingest exactly like
        live traffic (per-connection TCP ordering already put the rehome
        before this and live re-routed batches after)."""
        _dead_gid = pkt.read_u16()
        n = pkt.read_u32()
        for _ in range(n):
            payload = pkt.read_varbytes()
            self._handle(Packet(bytearray(payload)))
            self.replayed_batches += 1

    _HANDLERS = {
        MT.MT_NOTIFY_DEPLOYMENT_READY: _h_deployment_ready,
        MT.MT_NOTIFY_CLIENT_CONNECTED: _h_client_connected,
        MT.MT_NOTIFY_CLIENT_DISCONNECTED: _h_client_disconnected,
        MT.MT_CALL_ENTITY_METHOD: _h_call_entity_method,
        MT.MT_CALL_ENTITY_METHOD_FROM_CLIENT: _h_call_entity_method_from_client,
        MT.MT_CALL_ENTITIES_BATCH: _h_call_entities_batch,
        MT.MT_GIVE_CLIENT_TO: _h_give_client_to,
        MT.MT_CALL_NIL_SPACES: _h_call_nil_spaces,
        MT.MT_SYNC_POSITION_YAW_FROM_CLIENT: _h_sync_from_client,
        MT.MT_CREATE_ENTITY_ANYWHERE: _h_create_entity_anywhere,
        MT.MT_LOAD_ENTITY_ANYWHERE: _h_load_entity_anywhere,
        MT.MT_SRVDIS_UPDATE: _h_srvdis_update,
        MT.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE: _h_query_space_gameid_ack,
        MT.MT_MIGRATE_REQUEST: _h_migrate_request_ack,
        MT.MT_REAL_MIGRATE: _h_real_migrate,
        MT.MT_REJECT_DUPLICATE_ENTITY: _h_reject_duplicate_entity,
        MT.MT_NOTIFY_GAME_CONNECTED: _h_game_connected,
        MT.MT_NOTIFY_GAME_DISCONNECTED: _h_game_disconnected,
        MT.MT_NOTIFY_GATE_DISCONNECTED: _h_gate_disconnected,
        MT.MT_START_FREEZE_GAME_ACK: _h_freeze_ack,
        MT.MT_GAME_SHUTDOWN: _h_game_shutdown,
        MT.MT_REHOME_SPACES: _h_rehome_spaces,
        MT.MT_REPLAY_MOVES: _h_replay_moves,
    }

    # -- outbound ----------------------------------------------------------
    def _on_entity_registered(self, e: Entity):
        if e.persistent and self.gcfg.save_interval_s > 0:
            e.add_timer(float(self.gcfg.save_interval_s), "save")
        if self._registering_suppressed or e.id in self._suppress_notify_eids:
            return
        conn = self.cluster.by_entity(e.id)
        if conn:
            conn.send_notify_create_entity(e.id)

    def _on_entity_unregistered(self, e: Entity):
        if self._registering_suppressed or e.id in self._suppress_notify_eids:
            return
        conn = self.cluster.by_entity(e.id)
        if conn:
            conn.send_notify_destroy_entity(e.id)

    def _client_dirty(self, cli: GameClient):
        self._dirty_clients.add(cli)

    def _drain_client_outboxes(self):
        # only clients that queued ops since the last drain (GameClient
        # registers itself via on_dirty; idle clients cost nothing per tick)
        if not self._dirty_clients:
            return
        clients, self._dirty_clients = self._dirty_clients, set()
        with opmon.Operation("game.outbox"):
            for cli in clients:
                if not cli.outbox:
                    continue
                conn = self.cluster.by_gate(cli.gate_id)
                if conn is None:
                    cli.outbox.clear()
                    continue
                for op in cli.outbox:
                    self._send_client_op(conn, cli, op)
                cli.outbox.clear()

    def _send_client_op(self, conn: GWConnection, cli: GameClient, op: tuple):
        kind = op[0]
        if kind == "create_entity":
            _, type_name, eid, is_player, attrs, pos, yaw = op
            conn.send_create_entity_on_client(
                cli.gate_id, cli.client_id, type_name, eid, is_player, attrs, pos, yaw
            )
        elif kind == "destroy_entity":
            _, type_name, eid = op
            conn.send_destroy_entity_on_client(
                cli.gate_id, cli.client_id, type_name, eid
            )
        elif kind == "attr_delta":
            _, eid, path, aop, value = op
            conn.send_notify_attr_change_on_client(
                cli.gate_id, cli.client_id, eid, path, aop, value
            )
        elif kind == "call":
            _, eid, method, args = op
            conn.send_call_entity_method_on_client(
                cli.gate_id, cli.client_id, eid, method, args
            )

    def _send_position_syncs(self):
        records = self.rt.drain_sync()
        if not records:
            return
        per_gate: dict[int, Packet] = {}
        for client_id, gate_id, eid, x, y, z, yaw in records:
            p = per_gate.get(gate_id)
            if p is None:
                p = GWConnection.make_sync_on_clients_packet(gate_id)
                per_gate[gate_id] = p
            GWConnection.append_sync_record(p, client_id, eid, x, y, z, yaw)
        traced = telemetry.enabled()
        for gate_id, p in per_gate.items():
            conn = self.cluster.by_gate(gate_id)
            if conn:
                if traced:
                    # downlink origin: each per-gate sync batch starts a
                    # fresh trace (hop 0) the dispatcher re-stamps gateward
                    tracectx.stamp(p, tracectx.new_trace_id(), hop=0)
                conn.send(p)

    def _flush_orphan_client(self, cli: GameClient):
        """Send the ops queued on a GameClient no longer bound to any entity
        -- the per-tick outbox drain only visits clients reachable via an
        entity, so detach/teardown ops would otherwise never leave."""
        conn = self.cluster.by_gate(cli.gate_id)
        if conn is not None:
            for op in cli.outbox:
                self._send_client_op(conn, cli, op)
        cli.outbox.clear()

    # -- cluster-facing API for entities/user code -------------------------
    def give_client_to(self, e: Entity, target_eid: str):
        """Hand ``e``'s client to a (possibly remote) entity by id
        (reference: GiveClientTo, Entity.go:752-765).  The local-target fast
        path lives in Entity.give_client_to; this is the cross-game leg."""
        cli = e.client
        if cli is None:
            return
        # check the route before the irreversible detach: once the client is
        # off this entity there is no local owner to fall back to
        target = self.cluster.by_entity(target_eid)
        if target is None:
            self.log.warning(
                "give_client_to: no route to %s's shard; keeping client on %s",
                target_eid, e.id)
            return
        e.set_client(None)
        self._flush_orphan_client(cli)
        target.send_give_client_to(target_eid, cli.client_id, cli.gate_id)

    def call_entity(self, eid: str, method: str, *args):
        """Local fast path, else route via dispatcher (reference:
        EntityManager.Call, :429-442 + OPTIMIZE_LOCAL_ENTITY_CALL)."""
        e = self.rt.entities.get(eid)
        if e is not None:
            self.rt.post.post(lambda: e.call(method, *args))
            return
        conn = self.cluster.by_entity(eid)
        if conn:
            conn.send_call_entity_method(eid, method, args)

    def call_entities_batch(self, eids, method: str, *args):
        """Fan one RPC out to many entities with ONE packet per dispatcher
        shard, split per game by the dispatcher (the pubsub publish path --
        contrast with one dispatcher packet per subscriber).  Local entities
        dispatch directly; per-entity ordering is preserved because a batch
        rides the same shard its members' single calls would."""
        from ...netutil.packet import pack_args

        remote: list[str] = []
        for eid in eids:
            e = self.rt.entities.get(eid)
            if e is not None:
                self.rt.post.post(
                    lambda e=e: gwutils.run_panicless(
                        e.call, method, *args, logger=self.log))
            else:
                remote.append(eid)
        if not remote:
            return
        args_wire = pack_args(args)
        groups: dict[int, tuple] = {}
        for eid in remote:
            conn = self.cluster.by_entity(eid)
            if conn:
                groups.setdefault(id(conn), (conn, []))[1].append(eid)
        for conn, shard_eids in groups.values():
            conn.send_call_entities_batch(shard_eids, method, args_wire)

    def create_entity_anywhere(self, type_name: str, attrs: dict | None = None) -> str:
        eid = gen_id()
        conn = self.cluster.by_entity(eid)
        if conn:
            conn.send_create_entity_anywhere(type_name, eid, attrs or {})
        return eid

    def load_entity_anywhere(self, type_name: str, eid: str):
        conn = self.cluster.by_entity(eid)
        if conn:
            conn.send_load_entity_anywhere(type_name, eid)

    def call_nil_spaces(self, method: str, *args):
        if self.nil_space is not None:
            self.nil_space.call(method, *args)
        conn = self.cluster.conns[0]
        if conn:
            conn.send_call_nil_spaces(self.id, method, args)

    def enter_space(self, e: Entity, space_id: str, pos: Vector3):
        """EnterSpace: local fast path or cross-game migration (§3.4)."""
        sp = self.rt.entities.spaces.get(space_id)
        if sp is not None:
            def do_enter():
                if e.space is not None:
                    e.space.leave_entity(e)
                sp.enter_entity(e, pos)
            self.rt.post.post(do_enter)
            return
        self._migrating[e.id] = {"space_id": space_id, "pos": pos}
        # the space's directory entry lives on the dispatcher shard of the
        # SPACE id, not the entity's
        conn = self.cluster.by_entity(space_id)
        if conn:
            conn.send_query_space_gameid_for_migrate(space_id, e.id)

    def call_filtered_clients(self, key: str, op: int, value: str,
                              method: str, *args):
        conn = self.cluster.conns[0]
        if conn:
            conn.send_call_filtered_clients(key, op, value, method, args)

    def set_client_filter_prop(self, e: Entity, key: str, value: str):
        cli = e.client
        if cli is None:
            return
        conn = self.cluster.by_gate(cli.gate_id)
        if conn:
            conn.send_set_clientproxy_filter_prop(cli.gate_id, cli.client_id, key, value)

    def declare_service(self, srvid: str, info: str, force: bool = False):
        conn = self.cluster.by_srvid(srvid)
        if conn:
            conn.send_srvdis_register(srvid, info, force)
            conn.flush()

    # -- freeze / restore (§3.6) -------------------------------------------
    def freeze(self):
        """SIGHUP hot-reload path: block traffic at dispatchers, dump all
        entity state, exit (reference: GameService.go:221-272)."""
        conns = self.cluster.all()
        self._freeze_acks_wanted = len(conns)
        self._freeze_acks = 0
        for c in conns:
            c.send_start_freeze_game()
            c.flush()

    def _do_freeze(self):
        import msgpack

        self.rt.post.tick(self.rt.on_error)  # drain pending posts
        spaces, entities = [], []
        for e in self.rt.entities.entities.values():
            gwutils.run_panicless(e.on_freeze, logger=self.log)
            d = e.migrate_data()
            # interest sets are part of the checkpoint: restore rebuilds
            # them and seeds the AOI calculator's previous-tick state, so
            # the first post-restore flush emits ONLY genuine diffs (changes
            # that happened while frozen) -- no suppression heuristics
            # (reference: quiet restore, EntityManager.go:591-652).
            # neighbors() is the lazy-aware accessor; gating on the eager
            # set would skip every plain entity's interests
            interest_ids = [o.id for o in e.neighbors()]
            if interest_ids:
                d["interests"] = interest_ids
            if e.is_space:
                d["kind"] = getattr(e, "kind", 0)
                d["aoi_dist"] = getattr(e, "_aoi_default_dist", 0.0)
                d["aoi_enabled"] = getattr(e, "aoi_enabled", False)
                d["members"] = [
                    (m.id, m.position.to_tuple())
                    for m in getattr(e, "entities", ())
                ]
                spaces.append(d)
            else:
                entities.append(d)
        blob = msgpack.packb(
            {"game_id": self.id, "spaces": spaces, "entities": entities},
            use_bin_type=True,
        )
        with open(self._frozen_file, "wb") as f:
            f.write(blob)
        self.log.info("frozen %d spaces + %d entities -> %s",
                      len(spaces), len(entities), self._frozen_file)
        self._stop.set()
        self.cluster.stop()

    def _restore_from_freeze(self):
        """Reference: restore.go + RestoreFreezedEntities 3-pass
        (EntityManager.go:591-652)."""
        import msgpack

        with open(self._frozen_file, "rb") as f:
            dump = msgpack.unpackb(f.read(), raw=False)
        os.unlink(self._frozen_file)
        self._registering_suppressed = True  # re-register via SET_GAME_ID list
        try:
            id2space = {}
            for d in dump["spaces"]:
                sp = self.rt.entities.restore(d)
                sp.kind = d.get("kind", 0)
                if d.get("aoi_enabled") and not sp.aoi_enabled:
                    sp.enable_aoi(d.get("aoi_dist", 0.0))
                id2space[d["id"]] = sp
                if d["type"] == "__nil_space__":
                    self.nil_space = sp
            if self.nil_space is None:
                self.nil_space = self.rt.entities.create(
                    "__nil_space__", eid=fixed_id(f"nilspace-game{self.id}")
                )
            member_pos = {}
            for d in dump["spaces"]:
                for mid, pos in d.get("members", ()):
                    member_pos[mid] = (d["id"], pos)
            pending_interests = []
            for d in dump["entities"]:
                e = self.rt.entities.restore(
                    d,
                    client_factory=lambda cid, gid: GameClient(
                        cid, gid, self._client_dirty)
                )
                # quiet client reattach: no re-create on the client
                if e.client is not None:
                    e.client.outbox.clear()
                if d.get("interests"):
                    pending_interests.append((e, d["interests"]))
                where = member_pos.get(e.id)
                if where is not None:
                    sp = id2space.get(where[0])
                    if sp is not None:
                        x, y, z = where[1]
                        sp.enter_entity(e, Vector3(x, y, z),
                                        is_restore=True)
                gwutils.run_panicless(e.on_restored, logger=self.log)
            # rebuild interest links quietly (no client ops, no hooks: the
            # clients' mirrors ARE the frozen interest sets), then seed each
            # space's AOI previous-tick words so the first flush diffs
            # against the frozen state instead of replaying every pair
            for e, ids in pending_interests:
                # PLAIN entities stay lazy -- their interests live only in
                # the seeded packed words below; eager sets are rebuilt just
                # for entities with clients/hooks
                if e._plain_aoi:
                    continue
                for oid in ids:
                    other = self.rt.entities.get(oid)
                    if other is None:
                        continue
                    e.interested_in.add(other)
                    other.interested_by.add(e)
                    if e.client is not None:
                        other._watcher_clients += 1
                        other._touch_watched()
            from ...ops import aoi_predicate as AP
            import numpy as np

            by_space: dict = {}
            for e, ids in pending_interests:
                if e.space is not None and e.aoi_slot >= 0:
                    by_space.setdefault(id(e.space), []).append((e, ids))
            for sp in id2space.values():
                h = sp._aoi_handle
                if h is None:
                    continue
                cap = h.capacity
                # build the packed words directly from the frozen interest
                # lists: O(pairs), not O(cap^2) and not O(spaces x entities)
                words = np.zeros((cap, AP.words_per_row(cap)), np.uint32)
                for e, ids in by_space.get(id(sp), ()):
                    for oid in ids:
                        other = self.rt.entities.get(oid)
                        if other is not None and other.aoi_slot >= 0 \
                                and other.space is sp:
                            w, b = AP.word_bit_for_column(
                                other.aoi_slot, cap)
                            words[e.aoi_slot, w] |= np.uint32(1) << np.uint32(b)
                h.bucket.set_prev(h.slot, words)
            self.log.info("restored %d spaces + %d entities",
                          len(dump["spaces"]), len(dump["entities"]))
        finally:
            self._registering_suppressed = False
