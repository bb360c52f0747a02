"""Dispatcher: the cluster's message router.

Reference: components/dispatcher/DispatcherService.go.  Single consumer loop
over a packet queue fed by per-connection recv threads; owns:

  * the entity location directory (eid -> game) with block/replay queues --
    the delivery-ordering mechanism across entity loads and migrations
    (reference: entityDispatchInfo, DispatcherService.go:28-80);
  * game-level blocking for freeze/hot-reload (gameDispatchInfo, :82-169);
  * boot-entity round-robin and least-loaded-game placement (LBC min-heap,
    :529-558, lbcheap.go);
  * the deployment readiness barrier (:446-476);
  * the srvdis registry mirror (:737-751);
  * broadcast primitives (games / gates / nil-spaces / filtered clients).

The port's copy of the JAX package's ``components/dispatcher/service.py``.
"""

from __future__ import annotations

import heapq
import queue
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ... import consts, telemetry
from ...config import ClusterConfig
from ...netutil import Packet, PacketConnection, serve_tcp
from ...proto import msgtypes as MT
from ...proto.connection import METRICS_SUFFIX_VERSION
from ...telemetry import flight, trace, tracectx
from ...utils import binutil, gwlog, gwvar, opmon

from ...consts import (  # noqa: F401  (module aliases kept for callers)
    BLOCKED_ENTITY_QUEUE_MAX,
    BLOCKED_GAME_QUEUE_MAX,
    COMPONENT_QUEUE_MAX,
    FREEZE_BLOCK_TIMEOUT,
    LOAD_BLOCK_TIMEOUT,
    MIGRATE_BLOCK_TIMEOUT,
)


@dataclass
class _EntityInfo:
    game_id: int = 0
    block_until: float = 0.0
    pending: deque = field(default_factory=deque)

    def blocked(self, now: float) -> bool:
        return self.block_until > now


@dataclass
class _GameInfo:
    conn: "object | None" = None  # _Peer
    block_until: float = 0.0
    pending: deque = field(default_factory=deque)
    frozen: bool = False
    load: float = 0.0
    # cluster supervision (lease_ttl_s > 0): the monotonically increasing
    # ownership epoch, bumped on every registration AND every failover --
    # packets from a peer stamped with an older epoch are fenced
    epoch: int = 0
    # injectable-clock deadline of the current lease; 0 = no lease granted
    lease_deadline: float = 0.0
    # space ids the game reported with its last renewal: the re-homing
    # inventory the survivor restores from the shared checkpoint store
    spaces: tuple = ()


# supervision telemetry (docs/observability.md "Cluster supervision")
_LEASES = telemetry.counter(
    "clu.leases", "game lease renewals accepted by the dispatcher")
_FAILOVERS = telemetry.counter(
    "clu.failovers", "dead-game failovers orchestrated (lease expiry, or "
    "disconnect with leases armed)")
_FENCED = telemetry.counter(
    "clu.fenced_packets", "stale-epoch (zombie/split-brain) game packets "
    "fenced: counted, dropped, sender told to shut down")
_REPLAYED = telemetry.counter(
    "clu.replayed_moves", "buffered client movement batches replayed to "
    "failover survivors")


class _Peer:
    """One accepted connection (game or gate)."""

    def __init__(self, pc: PacketConnection):
        self.pc = pc
        self.kind = "?"  # "game" | "gate"
        self.id = 0
        self.alive = True
        # ownership epoch stamped at registration; compared against the
        # _GameInfo epoch on every packet when leases are armed
        self.epoch = 0
        self.shutdown_sent = False

    def send(self, p: Packet, release=False):
        if self.alive:
            try:
                self.pc.send_packet(p, release=release)
            except OSError:
                self.alive = False

    def send_payload(self, payload: bytes):
        if self.alive:
            try:
                self.pc.send_packet(Packet(bytearray(payload)))
            except OSError:
                self.alive = False


class DispatcherService:
    def __init__(self, disp_id: int, cfg: ClusterConfig, now=time.monotonic):
        self.id = disp_id
        self.cfg = cfg
        dc = cfg.dispatchers[disp_id]
        self.dispcfg = dc
        self.addr = (dc.host, dc.port)
        self.queue: "queue.Queue[tuple]" = queue.Queue(maxsize=COMPONENT_QUEUE_MAX)
        self.games: dict[int, _GameInfo] = {}
        self.gates: dict[int, _Peer] = {}
        self.entities: dict[str, _EntityInfo] = {}
        self.srvdis: dict[str, str] = {}
        self._srvdis_owner: dict[str, int] = {}  # srvid -> registering game
        self.ready = False
        self._blocked_eids: set[str] = set()  # entities with block/pending state
        self._boot_rr = 0
        self._pending_boots: list[tuple] = []
        self._listener = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.log = gwlog.logger(f"dispatcher{disp_id}")
        # cluster supervision (docs/robustness.md "Cluster supervision &
        # host failover").  ``now`` is the injectable liveness clock -- all
        # lease grants, renewals and expiry sweeps read it, so fake-clock
        # tests drive the whole failover state machine with zero sleeps.
        self.now = now
        self._lease_ttl = float(dc.lease_ttl_s)
        # per-game bounded deque of regrouped client-movement payloads kept
        # for failover replay; only populated while leases are armed
        self._move_buffer: dict[int, deque] = {}
        # plain mirrors of the clu.* telemetry counters, always on (the
        # instruments are no-ops while telemetry is disabled)
        self.clu_stats = {"leases": 0, "failovers": 0,
                          "fenced_packets": 0, "replayed_moves": 0}
        # federated cluster view: component name -> last metric snapshot
        # (lease-renew piggyback from games, MT_METRICS_REPORT from gates);
        # re-emitted at /debug/metrics via a registry collector
        self.cluster_metrics: dict[str, dict] = {}
        self._metrics_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._listener = serve_tcp(self.addr, self._on_connection)
        self.addr = self._listener.getsockname()
        gwvar.set_var("component", f"dispatcher{self.id}")
        if self.dispcfg.telemetry:
            telemetry.enable()
        flight.configure(component=f"dispatcher{self.id}")
        # the dispatcher IS the cluster aggregation point: its
        # /debug/metrics re-emits every reported component snapshot,
        # labeled, next to its own series
        telemetry.register_collector(self._telemetry_collect, weak=True)
        if self.dispcfg.http_port:
            binutil.setup_http_server(self.dispcfg.http_port)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        opmon.start_periodic_dump(consts.OPMON_DUMP_INTERVAL_S)
        self.log.info("dispatcher listening on %s", self.addr)
        return self

    def stop(self):
        self._stop.set()
        if self._listener:
            self._listener.close()
        opmon.stop_periodic_dump()

    def _on_connection(self, sock, peer_addr):
        pc = PacketConnection(sock)
        peer = _Peer(pc)
        while True:
            try:
                pkt = pc.recv_packet()
            except (OSError, ValueError):
                pkt = None
            if pkt is None:
                self.queue.put(("disconnect", peer, None))
                return
            self.queue.put(("packet", peer, pkt))

    # -- main loop ---------------------------------------------------------
    def _run(self):
        flush_deadline = time.monotonic() + 0.005
        while not self._stop.is_set():
            timeout = max(0.0, flush_deadline - time.monotonic())
            try:
                kind, peer, pkt = self.queue.get(timeout=timeout)
            except queue.Empty:
                kind = None
            if kind == "packet":
                try:
                    # per-packet routing latency -> opmon table + registry
                    # (p50/p99 at /debug/metrics, span in /debug/trace)
                    with opmon.Operation("disp.route"):
                        self._handle(peer, pkt)
                except Exception:
                    self.log.exception("handler error")
            elif kind == "disconnect":
                self._on_disconnect(peer)
            now = time.monotonic()
            if now >= flush_deadline:
                self._flush_all()
                self._check_unblock(now)
                if self._lease_ttl > 0:
                    self._sweep_leases(self.now())
                flush_deadline = now + 0.005

    def _flush_all(self):
        for gi in self.games.values():
            if gi.conn is not None and gi.conn.alive:
                try:
                    gi.conn.pc.flush()
                except OSError:
                    gi.conn.alive = False
        for gate in self.gates.values():
            if gate.alive:
                try:
                    gate.pc.flush()
                except OSError:
                    gate.alive = False

    # -- handlers ----------------------------------------------------------
    def _handle(self, peer: _Peer, pkt: Packet):
        msgtype = pkt.read_u16()
        # epoch fence (leases armed): a game peer whose stamped epoch is
        # older than the directory's current epoch is a zombie -- a process
        # presumed dead (lease expired, spaces re-homed) that stalled and
        # resumed.  Its packets must not reach any handler: the directory
        # now routes its entities elsewhere, so delivering would double-
        # apply events.  Count, drop, tell it to shut down.  A fresh
        # MT_SET_GAME_ID is exempt -- re-registration is the re-admission
        # path and stamps a new epoch.
        if (self._lease_ttl > 0 and peer.kind == "game"
                and msgtype != MT.MT_SET_GAME_ID):
            gi = self.games.get(peer.id)
            if gi is not None and peer.epoch != gi.epoch:
                self._fence(peer, msgtype)
                return
        if MT.is_redirect_to_client(msgtype) or msgtype == MT.MT_SYNC_POSITION_YAW_ON_CLIENTS:
            gate_id = pkt.read_u16()
            gate = self.gates.get(gate_id)
            if msgtype == MT.MT_SYNC_POSITION_YAW_ON_CLIENTS:
                # downlink half of the causal trace: the game stamped the
                # per-gate batch; strip + measure here, re-stamp hop+1 so
                # the gate closes the loop (stride: client_id + 32B record)
                ctx = tracectx.try_strip(pkt, stride=48)
                if ctx is not None:
                    tracectx.record_hop(ctx, "dispatcher.sync_down")
                    if gate:
                        out = Packet(bytearray(pkt.payload))
                        if telemetry.enabled():
                            tracectx.stamp(out, ctx.trace_id, ctx.hop + 1,
                                           ctx.origin_ns)
                        gate.send(out)
                    return
            if gate:
                gate.send_payload(pkt.payload)
            return
        handler = self._HANDLERS.get(msgtype)
        if handler is None:
            self.log.warning("unknown msgtype %s", msgtype)
            return
        handler(self, peer, pkt)

    def _h_set_game_id(self, peer, pkt):
        gid = pkt.read_u16()
        is_restore = pkt.read_bool()
        n = pkt.read_u32()
        eids = [pkt.read_entity_id() for _ in range(n)]
        peer.kind, peer.id = "game", gid
        gi = self.games.setdefault(gid, _GameInfo())
        gi.conn = peer
        if self._lease_ttl > 0:
            # stamp a fresh ownership epoch and grant the first lease; any
            # older peer still claiming this gid is fenced from here on
            gi.epoch += 1
            peer.epoch = gi.epoch
            peer.shutdown_sent = False
            gi.lease_deadline = self.now() + self._lease_ttl
            grant = Packet.for_msgtype(MT.MT_GAME_LEASE_GRANT)
            grant.append_u32(gi.epoch)
            grant.append_f32(self._lease_ttl)
            peer.send(grant)
        # reconcile directory: entities the game claims that now map to a
        # DIFFERENT live game are rejected back so the claimer destroys its
        # duplicate (reference: DispatcherService.go:376-398); dead or
        # unmapped entries are simply (re)claimed
        rejected = 0
        for eid in eids:
            ei = self.entities.setdefault(eid, _EntityInfo())
            cur = self.games.get(ei.game_id)
            cur_live = cur is not None and (
                cur.frozen or (cur.conn is not None and cur.conn.alive)
            )
            if ei.game_id not in (0, gid) and cur_live:
                out = Packet.for_msgtype(MT.MT_REJECT_DUPLICATE_ENTITY)
                out.append_entity_id(eid)
                peer.send(out)
                rejected += 1
                continue
            ei.game_id = gid
        if rejected:
            self.log.warning("game%d: rejected %d duplicate entities",
                             gid, rejected)
        if is_restore and gi.frozen:
            gi.frozen = False
            self._unblock_game(gi)
        self.log.info("game%d connected (%d entities, restore=%s)", gid, n, is_restore)
        # announce the (re)connected game to its peers -- the twin of the
        # MT_NOTIFY_GAME_DISCONNECTED broadcast in _on_disconnect, so a
        # game sees both edges of a neighbor's availability
        ann = Packet.for_msgtype(MT.MT_NOTIFY_GAME_CONNECTED)
        ann.append_u16(gid)
        self._broadcast_games(ann, exclude=gid)
        # srvdis snapshot: a (re)connecting game must learn registrations it
        # missed AND drop stale ones purged while it was away (its provider
        # entry may have been released to another game) -- sent even when
        # empty so the game prunes this shard's entries
        # (reference: service-map-on-connect, GoWorldConnection.go:404-423)
        snap = Packet.for_msgtype(MT.MT_SRVDIS_SNAPSHOT)
        snap.append_u32(len(self.srvdis))
        for srvid, info in sorted(self.srvdis.items()):
            snap.append_varstr(srvid)
            snap.append_varstr(info)
        peer.send(snap)
        self._drain_pending_boots()
        self._check_ready()

    def _h_set_gate_id(self, peer, pkt):
        gate_id = pkt.read_u16()
        peer.kind, peer.id = "gate", gate_id
        self.gates[gate_id] = peer
        self.log.info("gate%d connected", gate_id)
        self._check_ready()

    def _check_ready(self):
        want_games = len(self.cfg.games)
        want_gates = len(self.cfg.gates)
        have_games = sum(
            1 for gi in self.games.values() if gi.conn and gi.conn.alive
        )
        have_gates = sum(1 for g in self.gates.values() if g.alive)
        if not self.ready and have_games >= want_games and have_gates >= want_gates:
            self.ready = True
            gwvar.set_var("is_deployment_ready", True)
            p = Packet.for_msgtype(MT.MT_NOTIFY_DEPLOYMENT_READY)
            self._broadcast_games(p)
            for gate in self.gates.values():
                gate.send_payload(p.payload)
            self.log.info("deployment ready (%d games, %d gates)", have_games, have_gates)

    def _h_notify_create_entity(self, peer, pkt):
        eid = pkt.read_entity_id()
        ei = self.entities.setdefault(eid, _EntityInfo())
        ei.game_id = peer.id
        self._unblock_entity(eid, ei)

    def _h_notify_destroy_entity(self, peer, pkt):
        eid = pkt.read_entity_id()
        self.entities.pop(eid, None)

    def _h_notify_client_connected(self, peer, pkt):
        # gate generated the boot entity id; pick a game round-robin
        # (reference: chooseGameForBootEntity, :545-558)
        client_id = pkt.read_client_id()
        boot_eid = pkt.read_entity_id()
        self._place_boot(client_id, boot_eid, peer.id)

    def _place_boot(self, client_id, boot_eid, gate_id):
        gids = sorted(
            gid for gid, gi in self.games.items()
            if gi.conn and gi.conn.alive and not gi.frozen
        )
        if not gids:
            # no game yet (cluster still forming): hold the boot request and
            # replay it when a game registers, instead of dropping the
            # client's one-shot boot message
            self.log.warning("no game available for boot entity; queueing")
            self._pending_boots.append((client_id, boot_eid, gate_id))
            return
        gid = gids[self._boot_rr % len(gids)]
        self._boot_rr += 1
        ei = self.entities.setdefault(boot_eid, _EntityInfo())
        ei.game_id = gid
        out = Packet.for_msgtype(MT.MT_NOTIFY_CLIENT_CONNECTED)
        out.append_client_id(client_id)
        out.append_entity_id(boot_eid)
        out.append_u16(gate_id)  # gate id appended for the game
        self._send_to_game(gid, out)

    def _drain_pending_boots(self):
        pending, self._pending_boots = self._pending_boots, []
        for client_id, boot_eid, gate_id in pending:
            self._place_boot(client_id, boot_eid, gate_id)

    def _h_notify_client_disconnected(self, peer, pkt):
        client_id = pkt.read_client_id()
        owner_eid = pkt.read_entity_id()
        if self._pending_boots:
            self._pending_boots = [
                b for b in self._pending_boots if b[0] != client_id
            ]
        ei = self.entities.get(owner_eid)
        if ei and ei.game_id:
            out = Packet.for_msgtype(MT.MT_NOTIFY_CLIENT_DISCONNECTED)
            out.append_client_id(client_id)
            out.append_entity_id(owner_eid)
            self._send_to_game(ei.game_id, out)

    def _h_create_entity_anywhere(self, peer, pkt):
        eid = pkt.read_entity_id()
        # least-loaded placement with virtual-load nudge
        # (reference: :529-542 + lbcheap)
        gid = self._pick_least_loaded_game()
        if gid == 0:
            self.log.error("no game for create-anywhere")
            return
        ei = self.entities.setdefault(eid, _EntityInfo())
        ei.game_id = gid
        ei.block_until = time.monotonic() + LOAD_BLOCK_TIMEOUT
        self._blocked_eids.add(eid)
        self._send_to_game(gid, Packet(bytearray(pkt.payload)))

    def _h_load_entity_anywhere(self, peer, pkt):
        eid = pkt.read_entity_id()
        ei = self.entities.setdefault(eid, _EntityInfo())
        if ei.game_id == 0:
            gid = self._pick_least_loaded_game()
            if gid == 0:
                return
            ei.game_id = gid
            # block calls until the game reports NOTIFY_CREATE_ENTITY
            # (reference: :682-711)
            ei.block_until = time.monotonic() + LOAD_BLOCK_TIMEOUT
            self._blocked_eids.add(eid)
            self._send_to_game(gid, Packet(bytearray(pkt.payload)))
        # already loaded/loading: nothing to do

    def _pick_least_loaded_game(self) -> int:
        best, best_load = 0, None
        for gid, gi in sorted(self.games.items()):
            if gi.conn is None or not gi.conn.alive or gi.frozen:
                continue
            jitter = gi.load * random.uniform(1.0, 1.1)
            if best_load is None or jitter < best_load:
                best, best_load = gid, jitter
        if best:
            self.games[best].load += 0.1  # virtual-load nudge per pick
        return best

    def _h_game_lbc_info(self, peer, pkt):
        load = pkt.read_f32()
        gi = self.games.get(peer.id)
        if gi:
            gi.load = load

    # -- cluster supervision: leases / fencing / failover ------------------
    def _h_game_lease_renew(self, peer, pkt):
        gid = pkt.read_u16()
        epoch = pkt.read_u32()
        n = pkt.read_u32()
        spaces = tuple(pkt.read_varstr() for _ in range(n))
        gi = self.games.get(gid)
        if gi is None or gi.conn is not peer or epoch != gi.epoch:
            # a renewal racing its own failover (stale epoch from a peer
            # the fence has not seen yet) must not resurrect the lease
            return
        gi.lease_deadline = self.now() + self._lease_ttl
        gi.spaces = spaces
        self.clu_stats["leases"] += 1
        _LEASES.inc()
        # versioned optional suffix: a piggybacked metric snapshot.  Old
        # senders stop at the space list (nothing remains); unknown future
        # versions are ignored, never parsed (docs/protocol.md).
        if pkt.remaining() > 0:
            ver = pkt.read_u8()
            if 1 <= ver <= METRICS_SUFFIX_VERSION:
                self._store_metrics(f"game{gid}", pkt.read_data())

    def _h_metrics_report(self, peer, pkt):
        """Out-of-band metric snapshot (gates: no lease to piggyback on)."""
        comp = pkt.read_varstr()
        ver = pkt.read_u8()
        if not 1 <= ver <= METRICS_SUFFIX_VERSION:
            return
        self._store_metrics(comp, pkt.read_data())

    def _store_metrics(self, comp: str, snap) -> None:
        if isinstance(snap, dict):
            with self._metrics_lock:
                self.cluster_metrics[comp] = snap

    def _telemetry_collect(self):
        """Registry collector: the federated cluster view.  Every reported
        component snapshot re-emits labeled by component, so one scrape of
        the dispatcher's /debug/metrics reads the whole cluster."""
        with self._metrics_lock:
            snaps = {c: dict(s) for c, s in self.cluster_metrics.items()}
        out = [telemetry.Sample("clu.metric_sources", "gauge",
                                float(len(snaps)),
                                help="components reporting metric "
                                     "snapshots to this dispatcher")]
        for comp in sorted(snaps):
            for key, val in sorted(snaps[comp].items()):
                if not isinstance(val, (int, float)) \
                        or isinstance(val, bool):
                    continue
                base, brace, _rest = key.partition("{")
                labels = {"component": comp}
                if brace:
                    labels["series"] = key
                out.append(telemetry.Sample(base, "gauge", float(val),
                                            labels))
        return out

    def _fence(self, peer: _Peer, msgtype: int):
        """Drop one stale-epoch packet and (once) tell the zombie to die."""
        self.clu_stats["fenced_packets"] += 1
        _FENCED.inc()
        if not peer.shutdown_sent:
            peer.shutdown_sent = True
            self.log.warning(
                "fencing zombie game%d (stale epoch %d, msgtype %d): "
                "sending shutdown", peer.id, peer.epoch, msgtype)
            peer.send(Packet.for_msgtype(MT.MT_GAME_SHUTDOWN))

    def _sweep_leases(self, now: float):
        """Fail over every registered game whose lease deadline passed.
        Runs on the dispatcher thread at the flush cadence; fake-clock
        tests call it directly with a synthetic ``now``."""
        for gid in sorted(self.games):
            gi = self.games[gid]
            if gi.conn is None or gi.frozen or not gi.lease_deadline:
                continue
            if now >= gi.lease_deadline:
                self.log.warning("game%d lease expired; failing over", gid)
                self._fail_over_game(gid)

    def _purge_dead_game(self, gid: int) -> int:
        """Broadcast the death and release the dead game's service
        registrations (cluster-singleton failover).  Returns the number of
        services released.  Shared by the classic disconnect path and the
        lease-failover path."""
        out = Packet.for_msgtype(MT.MT_NOTIFY_GAME_DISCONNECTED)
        out.append_u16(gid)
        self._broadcast_games(out, exclude=gid)
        stale = [s for s, g in self._srvdis_owner.items() if g == gid]
        for srvid in stale:
            del self._srvdis_owner[srvid]
            self.srvdis.pop(srvid, None)
            self._broadcast_games(
                self._srvdis_update_pkt(srvid, ""), exclude=gid
            )
        return len(stale)

    def _fail_over_game(self, gid: int):
        """Re-home a dead game's spaces onto the least-loaded survivor.

        Runs atomically on the dispatcher thread: bump the ownership epoch
        (fencing any zombie), clean the directory, pick a survivor, send it
        MT_REHOME_SPACES (restore from the shared checkpoint store) then
        MT_REPLAY_MOVES (the buffered client movement since the last
        consistent epoch), and re-point the dead game's directory entries.
        Per-connection TCP ordering guarantees the survivor processes
        rehome -> replay -> re-routed live traffic in that order."""
        gi = self.games.get(gid)
        if gi is None:
            return
        with trace.span("clu.failover"):
            gi.conn = None
            gi.lease_deadline = 0.0
            gi.epoch += 1
            dead = sorted(eid for eid, ei in self.entities.items()
                          if ei.game_id == gid)
            released = self._purge_dead_game(gid)
            survivor = self._pick_least_loaded_game()
            buf = self._move_buffer.pop(gid, None)
            if survivor == 0:
                for eid in dead:
                    del self.entities[eid]
                self.log.error(
                    "game%d died with no survivor: %d entities dropped, "
                    "%d services released", gid, len(dead), released)
                return
            out = Packet.for_msgtype(MT.MT_REHOME_SPACES)
            out.append_u16(gid)
            out.append_u32(gi.epoch)
            out.append_u32(len(gi.spaces))
            for sid in gi.spaces:
                out.append_varstr(sid)
            self._send_to_game(survivor, out)
            if buf:
                rp = Packet.for_msgtype(MT.MT_REPLAY_MOVES)
                rp.append_u16(gid)
                rp.append_u32(len(buf))
                for payload in buf:
                    rp.append_varbytes(payload)
                self._send_to_game(survivor, rp)
                self.clu_stats["replayed_moves"] += len(buf)
                _REPLAYED.inc(len(buf))
            for eid in dead:
                self.entities[eid].game_id = survivor
            self.clu_stats["failovers"] += 1
            _FAILOVERS.inc()
            # black-box the failover: what the dispatcher saw right up to
            # (and including) the re-homing decision
            flight.note("clu.failover", gid=gid, survivor=survivor,
                        spaces=len(gi.spaces), entities=len(dead),
                        replayed=len(buf) if buf else 0)
            flight.dump("failover")
            self.log.info(
                "game%d failed over to game%d: %d spaces re-homed, %d "
                "entities re-pointed, %d move batches replayed, %d "
                "services released", gid, survivor, len(gi.spaces),
                len(dead), len(buf) if buf else 0, released)
            gi.spaces = ()

    def _h_call_entity_method(self, peer, pkt):
        eid = pkt.read_entity_id()
        self._dispatch_entity_packet(eid, pkt)

    _h_call_entity_method_from_client = _h_call_entity_method

    def _h_call_entities_batch(self, peer, pkt):
        """Grouped entity-RPC fanout (pubsub publish): split the eid list by
        owning game and forward ONE batch packet per game.  Eids that are
        unknown, blocked, or behind a pending queue fall back to individual
        MT_CALL_ENTITY_METHOD packets so they ride the per-entity
        block/replay ordering machinery unchanged."""
        method = pkt.read_varstr()
        args_wire = pkt.read_varbytes()
        n = pkt.read_u32()
        now = time.monotonic()
        per_game: dict[int, list[str]] = {}
        for _ in range(n):
            eid = pkt.read_entity_id()
            ei = self.entities.get(eid)
            if (ei is None or ei.game_id == 0 or ei.blocked(now)
                    or ei.pending):
                sp = Packet.for_msgtype(MT.MT_CALL_ENTITY_METHOD)
                sp.append_entity_id(eid)
                sp.append_varstr(method)
                sp.append_bytes(args_wire)
                self._dispatch_entity_packet(eid, sp)
                continue
            per_game.setdefault(ei.game_id, []).append(eid)
        for gid, eids in sorted(per_game.items()):
            gp = Packet.for_msgtype(MT.MT_CALL_ENTITIES_BATCH)
            gp.append_varstr(method)
            gp.append_varbytes(args_wire)
            gp.append_u32(len(eids))
            for eid in eids:
                gp.append_entity_id(eid)
            self._send_to_game(gid, gp)

    def _h_give_client_to(self, peer, pkt):
        """Client handoff routes like an entity call (by target shard,
        queued while the target loads/migrates) -- but a handoff for an eid
        the directory hasn't learned yet must PARK, not drop: the source
        game has already detached its client, so dropping would strand the
        connection with no owner.  The park replays when the target's
        MT_NOTIFY_CREATE_ENTITY lands (reference: MT_GIVE_CLIENT_TO +
        dispatchPacket semantics, DispatcherService.go)."""
        eid = pkt.read_entity_id()
        ei = self.entities.get(eid)
        if ei is None or ei.game_id == 0:
            ei = self.entities.setdefault(eid, _EntityInfo())
            if len(ei.pending) < BLOCKED_ENTITY_QUEUE_MAX:
                ei.block_until = time.monotonic() + LOAD_BLOCK_TIMEOUT
                ei.pending.append(pkt.payload)
                self._blocked_eids.add(eid)
            return
        self._dispatch_entity_packet(eid, pkt)

    def _h_call_nil_spaces(self, peer, pkt):
        exclude = pkt.read_u16()
        for gid, gi in self.games.items():
            if gid != exclude and gi.conn and gi.conn.alive:
                self._send_to_game(gid, Packet(bytearray(pkt.payload)))

    def _h_sync_from_client(self, peer, pkt):
        """Flat array of (eid, x, y, z, yaw) from a gate; regroup per game
        (reference: DispatcherService.go:789-827)."""
        # the gate may have stamped a trace trailer (telemetry on at the
        # origin): strip it BEFORE record parsing, record the gate->disp
        # wire hop, and re-stamp hop+1 on every per-game packet below
        ctx = tracectx.try_strip(pkt)
        if ctx is not None:
            tracectx.record_hop(ctx, "dispatcher.sync")
            tracectx.record_local_span(ctx, "wire.hop")
        flight.note_packet("rx", MT.MT_SYNC_POSITION_YAW_FROM_CLIENT,
                           len(pkt.buf))
        per_game: dict[int, Packet] = {}
        while pkt.remaining() > 0:
            eid = pkt.read_entity_id()
            rec = pkt.read_bytes(16)
            ei = self.entities.get(eid)
            if ei is None or ei.game_id == 0:
                continue
            out = per_game.get(ei.game_id)
            if out is None:
                out = Packet.for_msgtype(MT.MT_SYNC_POSITION_YAW_FROM_CLIENT)
                per_game[ei.game_id] = out
            out.append_entity_id(eid)
            out.append_bytes(rec)
        for gid, out in per_game.items():
            if self._lease_ttl > 0:
                # buffer the regrouped batch for failover replay -- kept
                # even when delivery succeeds, because the owner may die
                # after the send but before applying it.  The survivor
                # dedups replay against its restored checkpoint tick.
                # Buffered BEFORE the trace re-stamp: replay bodies stay
                # trailer-free (the worker strips defensively anyway).
                buf = self._move_buffer.get(gid)
                if buf is None:
                    buf = deque(maxlen=max(1, self.dispcfg.lease_replay_cap))
                    self._move_buffer[gid] = buf
                buf.append(bytes(out.payload))
            if ctx is not None and telemetry.enabled():
                tracectx.stamp(out, ctx.trace_id, ctx.hop + 1,
                               ctx.origin_ns)
            self._send_to_game(gid, out)

    # -- migration ---------------------------------------------------------
    def _h_query_space_gameid_for_migrate(self, peer, pkt):
        space_id = pkt.read_entity_id()
        eid = pkt.read_entity_id()
        ei = self.entities.get(space_id)
        out = Packet.for_msgtype(MT.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE)
        out.append_entity_id(space_id)
        out.append_entity_id(eid)
        out.append_u16(ei.game_id if ei else 0)
        peer.send(out)

    def _h_migrate_request(self, peer, pkt):
        eid = pkt.read_entity_id()
        space_id = pkt.read_entity_id()
        space_game = pkt.read_u16()
        ei = self.entities.setdefault(eid, _EntityInfo())
        ei.block_until = time.monotonic() + MIGRATE_BLOCK_TIMEOUT
        self._blocked_eids.add(eid)
        out = Packet.for_msgtype(MT.MT_MIGRATE_REQUEST)
        out.append_entity_id(eid)
        out.append_entity_id(space_id)
        out.append_u16(space_game)
        peer.send(out)

    def _h_real_migrate(self, peer, pkt):
        eid = pkt.read_entity_id()
        target_game = pkt.read_u16()
        ei = self.entities.setdefault(eid, _EntityInfo())
        ei.game_id = target_game
        self._send_to_game(target_game, Packet(bytearray(pkt.payload)))
        self._unblock_entity(eid, ei)

    def _h_cancel_migrate(self, peer, pkt):
        eid = pkt.read_entity_id()
        ei = self.entities.get(eid)
        if ei:
            self._unblock_entity(eid, ei)

    # -- srvdis ------------------------------------------------------------
    @staticmethod
    def _srvdis_update_pkt(srvid: str, info: str) -> Packet:
        out = Packet.for_msgtype(MT.MT_SRVDIS_UPDATE)
        out.append_varstr(srvid)
        out.append_varstr(info)
        return out

    def _h_srvdis_register(self, peer, pkt):
        srvid = pkt.read_varstr()
        info = pkt.read_varstr()
        force = pkt.read_bool()
        if not info:
            # empty info is the deregistration sentinel on the update wire;
            # storing it would desync dispatcher and games permanently
            self.log.warning("rejecting empty srvdis registration for %s", srvid)
            return
        if force or srvid not in self.srvdis:
            self.srvdis[srvid] = info  # first-writer-wins (reference :737-751)
            self._srvdis_owner[srvid] = peer.id
            self._broadcast_games(self._srvdis_update_pkt(srvid, info))
        else:
            # already registered: send current registration back to requester
            peer.send(self._srvdis_update_pkt(srvid, self.srvdis[srvid]))

    # -- freeze ------------------------------------------------------------
    def _h_start_freeze_game(self, peer, pkt):
        gi = self.games.get(peer.id)
        if gi is None:
            return
        gi.frozen = True
        gi.block_until = time.monotonic() + FREEZE_BLOCK_TIMEOUT
        peer.send(Packet.for_msgtype(MT.MT_START_FREEZE_GAME_ACK))

    # -- filtered clients --------------------------------------------------
    def _h_call_filtered_clients(self, peer, pkt):
        for gate in self.gates.values():
            gate.send_payload(pkt.payload)

    def _h_set_filter_prop(self, peer, pkt):
        gate_id = pkt.read_u16()
        gate = self.gates.get(gate_id)
        if gate:
            gate.send_payload(pkt.payload)

    _h_clear_filter_props = _h_set_filter_prop

    # -- routing helpers ---------------------------------------------------
    def _dispatch_entity_packet(self, eid: str, pkt: Packet):
        """Route a packet to the entity's game, queuing while blocked
        (the ordering guarantee -- reference dispatchPacket, :34-80)."""
        ei = self.entities.get(eid)
        now = time.monotonic()
        if ei is None or ei.game_id == 0:
            return  # no such entity known; drop (reference logs similarly)
        # also queue while older packets are still pending (a block that just
        # expired must not let new packets overtake the queued ones)
        if ei.blocked(now) or ei.pending:
            if len(ei.pending) < BLOCKED_ENTITY_QUEUE_MAX:
                ei.pending.append(pkt.payload)
                self._blocked_eids.add(eid)
            return
        self._send_to_game(ei.game_id, Packet(bytearray(pkt.payload)))

    def _send_to_game(self, gid: int, pkt: Packet):
        gi = self.games.get(gid)
        if gi is None:
            return
        now = time.monotonic()
        if gi.frozen or gi.conn is None or not gi.conn.alive:
            if gi.frozen or gi.block_until > now:
                if len(gi.pending) < BLOCKED_GAME_QUEUE_MAX:
                    gi.pending.append(pkt.payload)
            return
        gi.conn.send(pkt)

    def _broadcast_games(self, pkt: Packet, exclude: int = 0):
        for gid, gi in self.games.items():
            if gid != exclude:
                self._send_to_game(gid, Packet(bytearray(pkt.payload)))

    def _unblock_entity(self, eid: str, ei: _EntityInfo):
        ei.block_until = 0.0
        if ei.game_id == 0 and ei.pending:
            # park expired without the entity ever registering: packets are
            # undeliverable (give_client_to parks land here on timeout).  A
            # dropped handoff strands a live, ownerless client connection --
            # kick it at its gate so the player reconnects cleanly.
            self.log.warning("dropping %d parked packets for unknown entity %s",
                             len(ei.pending), eid)
            while ei.pending:
                payload = ei.pending.popleft()
                pkt = Packet(bytearray(payload))
                if pkt.read_u16() != MT.MT_GIVE_CLIENT_TO:
                    continue
                pkt.read_entity_id()  # target eid (the one that never came)
                client_id = pkt.read_client_id()
                gate_id = pkt.read_u16()
                gate = self.gates.get(gate_id)
                if gate is not None:
                    out = Packet.for_msgtype(MT.MT_KICK_CLIENT)
                    out.append_u16(gate_id)
                    out.append_client_id(client_id)
                    gate.send(out, release=True)
        while ei.pending:
            payload = ei.pending.popleft()
            self._send_to_game(ei.game_id, Packet(bytearray(payload)))
        self._blocked_eids.discard(eid)

    def _unblock_game(self, gi: _GameInfo):
        gi.block_until = 0.0
        while gi.pending and gi.conn and gi.conn.alive:
            payload = gi.pending.popleft()
            gi.conn.send_payload(payload)

    def _check_unblock(self, now: float):
        # only entities with block/pending state are tracked -- the full
        # directory is never scanned on the 5 ms tick
        for eid in list(self._blocked_eids):
            ei = self.entities.get(eid)
            if ei is None:
                self._blocked_eids.discard(eid)
            elif ei.pending and not ei.blocked(now):
                self._unblock_entity(eid, ei)

    # -- disconnects -------------------------------------------------------
    def _on_disconnect(self, peer: _Peer):
        peer.alive = False
        if peer.kind == "game":
            gi = self.games.get(peer.id)
            if gi and gi.conn is peer:
                if gi.frozen:
                    # freeze in progress: keep queueing until restore
                    gi.conn = None
                    self.log.info("game%d frozen, awaiting restore", peer.id)
                    return
                if self._lease_ttl > 0:
                    # leases armed: a dropped connection is a death signal
                    # too -- same orchestration as lease expiry, just
                    # detected sooner
                    self._fail_over_game(peer.id)
                    return
                gi.conn = None
                # clean directory; notify everyone
                # (reference: :595-643)
                dead = [
                    eid for eid, ei in self.entities.items()
                    if ei.game_id == peer.id
                ]
                for eid in dead:
                    del self.entities[eid]
                released = self._purge_dead_game(peer.id)
                self.log.info(
                    "game%d disconnected (%d entities dropped, %d services released)",
                    peer.id, len(dead), released,
                )
        elif peer.kind == "gate":
            if self.gates.get(peer.id) is peer:
                del self.gates[peer.id]
                # boots queued through the dead gate would replay with a
                # stale gate id and leak boot entities
                self._pending_boots = [
                    b for b in self._pending_boots if b[2] != peer.id
                ]
                out = Packet.for_msgtype(MT.MT_NOTIFY_GATE_DISCONNECTED)
                out.append_u16(peer.id)
                self._broadcast_games(out)
                self.log.info("gate%d disconnected", peer.id)

    _HANDLERS = {
        MT.MT_SET_GAME_ID: _h_set_game_id,
        MT.MT_SET_GATE_ID: _h_set_gate_id,
        MT.MT_NOTIFY_CREATE_ENTITY: _h_notify_create_entity,
        MT.MT_NOTIFY_DESTROY_ENTITY: _h_notify_destroy_entity,
        MT.MT_NOTIFY_CLIENT_CONNECTED: _h_notify_client_connected,
        MT.MT_NOTIFY_CLIENT_DISCONNECTED: _h_notify_client_disconnected,
        MT.MT_CREATE_ENTITY_ANYWHERE: _h_create_entity_anywhere,
        MT.MT_LOAD_ENTITY_ANYWHERE: _h_load_entity_anywhere,
        MT.MT_CALL_ENTITY_METHOD: _h_call_entity_method,
        MT.MT_CALL_ENTITY_METHOD_FROM_CLIENT: _h_call_entity_method_from_client,
        MT.MT_CALL_ENTITIES_BATCH: _h_call_entities_batch,
        MT.MT_GIVE_CLIENT_TO: _h_give_client_to,
        MT.MT_CALL_NIL_SPACES: _h_call_nil_spaces,
        MT.MT_SYNC_POSITION_YAW_FROM_CLIENT: _h_sync_from_client,
        MT.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE: _h_query_space_gameid_for_migrate,
        MT.MT_MIGRATE_REQUEST: _h_migrate_request,
        MT.MT_REAL_MIGRATE: _h_real_migrate,
        MT.MT_CANCEL_MIGRATE: _h_cancel_migrate,
        MT.MT_SRVDIS_REGISTER: _h_srvdis_register,
        MT.MT_START_FREEZE_GAME: _h_start_freeze_game,
        MT.MT_CALL_FILTERED_CLIENTS: _h_call_filtered_clients,
        MT.MT_SET_CLIENTPROXY_FILTER_PROP: _h_set_filter_prop,
        MT.MT_KICK_CLIENT: _h_set_filter_prop,  # same gate-id routing
        MT.MT_CLEAR_CLIENTPROXY_FILTER_PROPS: _h_clear_filter_props,
        MT.MT_GAME_LBC_INFO: _h_game_lbc_info,
        MT.MT_GAME_LEASE_RENEW: _h_game_lease_renew,
        MT.MT_METRICS_REPORT: _h_metrics_report,
    }
