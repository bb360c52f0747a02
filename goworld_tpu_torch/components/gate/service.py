"""Gate: terminates client connections and bridges them to the cluster.

Reference: components/gate/GateService.go.  Owns a ClientProxy per client
(generates the ClientID, tracks the owner entity), routes:

  client -> cluster : entity RPC (ClientID appended), position sync batched
                      per dispatcher and flushed on the sync interval
                      (reference: GateService.go:400-427);
  cluster -> client : redirect band forwarded after reading the ClientID,
                      per-client regrouping of position-sync batches
                      (reference: :347-373), filtered-client calls via the
                      filter trees.

Heartbeat timeout kicks dead clients (reference: :202-212).

The port's copy of the JAX package's ``components/gate/service.py``: the
TCP listener (TLS when ``tls_cert`` and ``tls_key`` are set), the
WebSocket listener (``websocket_port``, TLS too) and the KCP listener
(``kcp_port``), compression, heartbeats, the filter trees and the sync
fan-out.  A listener that fails to bind raises at
:meth:`GateService.start`; the gate never serves TCP alone in its place.
"""

from __future__ import annotations

import queue
import ssl
import threading
import time

from ... import consts, telemetry
from ...telemetry import flight, tracectx
from ...config import ClusterConfig
from ...consts import COMPONENT_QUEUE_MAX
from ...dispatchercluster import DispatcherCluster
from ...engine.ids import gen_id
from ...netutil import Packet, PacketConnection, kcp, serve_tcp, websocket
from ...proto import GWConnection, msgtypes as MT
from ...utils import binutil, gwlog, gwutils, gwvar, opmon
from .filtertree import FilterTree


class ClientProxy:
    def __init__(self, pc: PacketConnection, gate: "GateService"):
        self.pc = pc
        self.gate = gate
        self.client_id = gen_id()
        self.owner_entity_id: str | None = None
        self.filter_props: dict[str, str] = {}
        # stamped on the gate's clock seam so liveness tests can drive the
        # heartbeat_timeout_s kick path on a fake clock with zero sleeps
        self.last_heartbeat = gate.now()
        self.alive = True

    def send(self, p: Packet):
        if self.alive:
            try:
                self.pc.send_packet(p)
            except OSError:
                self.alive = False

    def send_payload(self, payload: bytes):
        if self.alive:
            try:
                self.pc.send_packet(Packet(bytearray(payload)))
            except OSError:
                self.alive = False

    def flush(self):
        if self.alive:
            try:
                self.pc.flush()
            except OSError:
                self.alive = False


class GateService:
    def __init__(self, gate_id: int, cfg: ClusterConfig,
                 now=time.monotonic):
        self.id = gate_id
        self.cfg = cfg
        self.gatecfg = cfg.gates[gate_id]
        # injectable clock seam: every liveness decision (heartbeat stamps
        # and the heartbeat_timeout_s kick sweep) reads this, never wall
        # time directly, so failure-detection tests run on a fake clock
        self.now = now
        self.log = gwlog.logger(f"gate{gate_id}")
        self.queue: "queue.Queue[tuple]" = queue.Queue(maxsize=COMPONENT_QUEUE_MAX)
        self.clients: dict[str, ClientProxy] = {}
        self.filter_trees: dict[str, FilterTree] = {}
        self.cluster = DispatcherCluster(
            cfg.dispatcher_addrs(),
            on_packet=lambda i, p: self.queue.put(("disp", i, p)),
            register=lambda conn: conn.send_set_gate_id(self.id),
            tag=f"gate{gate_id}",
        )
        # client->server position syncs batched per dispatcher
        self._sync_batches: dict[int, Packet] = {}
        # boot requests awaiting a live dispatcher connection
        self._pending_boots: list[ClientProxy] = []
        self._listener = None
        self._ws_listener = None
        self._kcp_server = None
        self.kcp_addr: tuple[str, int] | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.addr = (self.gatecfg.host, self.gatecfg.port)
        self.ws_addr: tuple[str, int] | None = None
        self._ssl_ctx = None
        if self.gatecfg.tls_cert and self.gatecfg.tls_key:
            self._ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl_ctx.load_cert_chain(
                self.gatecfg.tls_cert, self.gatecfg.tls_key
            )

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._listener = serve_tcp(self.addr, self._on_client_connection)
        self.addr = self._listener.getsockname()
        if self.gatecfg.websocket_port:
            # 0 = disabled; negative = ephemeral bind (tests)
            self._ws_listener = serve_tcp(
                (self.gatecfg.host, max(self.gatecfg.websocket_port, 0)),
                self._on_ws_connection,
            )
            self.ws_addr = self._ws_listener.getsockname()
            self.log.info("gate websocket on %s", self.ws_addr)
        if self.gatecfg.kcp_port:
            # 0 = disabled; negative = ephemeral bind (tests)
            self._kcp_server = kcp.serve_kcp(
                (self.gatecfg.host, max(self.gatecfg.kcp_port, 0)),
                lambda sess, peer: self._serve_client(sess),
            )
            self.kcp_addr = self._kcp_server.addr
            self.log.info("gate kcp on %s", self.kcp_addr)
        gwvar.set_var("component", f"gate{self.id}")
        if self.gatecfg.telemetry:
            telemetry.enable()
        flight.configure(component=f"gate{self.id}")
        if self.gatecfg.http_port:
            binutil.setup_http_server(self.gatecfg.http_port)
        self.cluster.start()
        # don't announce readiness until the dispatchers are reachable --
        # otherwise the operator CLI lets clients in while boot-entity
        # requests would still be dropped on the floor
        if not self.cluster.wait_connected(30.0):
            self.log.warning(
                "dispatchers unreachable after 30s; announcing ready anyway "
                "(boot requests will queue until they connect)"
            )
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        opmon.start_periodic_dump(consts.OPMON_DUMP_INTERVAL_S)
        gwlog.announce_ready(f"gate{self.id}", "gate")
        self.log.info("gate listening on %s", self.addr)
        return self

    def stop(self):
        self._stop.set()
        opmon.stop_periodic_dump()
        self.cluster.stop()
        if self._listener:
            self._listener.close()
        if self._ws_listener:
            self._ws_listener.close()
        if self._kcp_server:
            self._kcp_server.close()

    # -- client connections ------------------------------------------------
    def _maybe_tls(self, sock):
        if self._ssl_ctx is None:
            return sock
        return self._ssl_ctx.wrap_socket(sock, server_side=True)

    def _on_client_connection(self, sock, peer_addr):
        try:
            sock = self._maybe_tls(sock)
        except (OSError, ValueError):
            return
        self._serve_client(sock)

    def _on_ws_connection(self, sock, peer_addr):
        try:
            sock = self._maybe_tls(sock)
            _headers, residue = websocket.server_handshake(sock)
        except (OSError, ValueError):
            return
        self._serve_client(
            websocket.WSSocket(sock, mask_outgoing=False, residue=residue)
        )

    def _serve_client(self, sock):
        pc = PacketConnection(sock, compression=self.gatecfg.compression)
        cp = ClientProxy(pc, self)
        self.queue.put(("client_new", cp, None))
        while True:
            try:
                pkt = pc.recv_packet()
            except (OSError, ValueError):
                pkt = None
            if pkt is None:
                self.queue.put(("client_gone", cp, None))
                return
            self.queue.put(("client_pkt", cp, pkt))

    # -- main loop ---------------------------------------------------------
    def _run(self):
        sync_s = self.gatecfg.position_sync_interval_ms / 1000.0
        flush_deadline = time.monotonic() + 0.005
        next_sync = time.monotonic() + sync_s
        # check at least twice per timeout window so short timeouts kick
        # promptly (the default stays one sweep per 5 s)
        hb_timeout = self.gatecfg.heartbeat_timeout_s
        hb_interval = min(5.0, max(0.25, hb_timeout / 2)) if hb_timeout > 0 else 5.0
        next_hb_check = time.monotonic() + hb_interval
        # gates hold no lease to piggyback metrics on; they push a
        # rate-limited MT_METRICS_REPORT instead (telemetry on only)
        next_metrics = time.monotonic() + 1.0
        while not self._stop.is_set():
            timeout = max(0.0, flush_deadline - time.monotonic())
            try:
                kind, a, b = self.queue.get(timeout=timeout)
                gwutils.run_panicless(self._dispatch, kind, a, b, logger=self.log)
            except queue.Empty:
                pass
            now = time.monotonic()
            if now >= next_sync:
                self._flush_sync_batches()
                next_sync = now + sync_s
            if now >= flush_deadline:
                self._retry_pending_boots()
                for cp in self.clients.values():
                    cp.flush()
                self.cluster.flush_all()
                flush_deadline = now + 0.005
            if now >= next_hb_check:
                # sweep on the gate clock, not the loop's scheduling clock:
                # with an injected fake clock the sweep cadence still rides
                # wall time but the LIVENESS decision rides self.now()
                self._kick_dead_clients(self.now())
                next_hb_check = now + hb_interval
            if now >= next_metrics:
                self._report_metrics()
                next_metrics = now + 1.0

    def _report_metrics(self):
        """Push this gate's metric snapshot to every live dispatcher (the
        federated /debug/metrics source for components without a lease)."""
        if not telemetry.enabled():
            return
        snap = telemetry.snapshot()
        for conn in self.cluster.conns:
            if conn:
                try:
                    conn.send_metrics_report(f"gate{self.id}", snap)
                except OSError:
                    pass

    def _dispatch(self, kind, a, b):
        if kind == "client_pkt":
            # slow-op warning at 100 ms (reference: GateService.go:433-440);
            # the context manager records on exceptions too -- the slow/
            # broken packets are exactly the ones the stats must not miss
            with opmon.Operation("gate.client_pkt", 0.1, self.log):
                self._handle_client_packet(a, b)
        elif kind == "disp":
            self._handle_dispatcher_packet(b)
        elif kind == "client_new":
            self._on_new_client(a)
        elif kind == "client_gone":
            self._on_client_gone(a)

    # -- new / dead clients ------------------------------------------------
    def _on_new_client(self, cp: ClientProxy):
        self.log.info("new client %s", cp.client_id)
        self.clients[cp.client_id] = cp
        # handshake: tell the client its id
        p = Packet.for_msgtype(MT.MT_CLIENT_HANDSHAKE)
        p.append_client_id(cp.client_id)
        cp.send(p)
        cp.flush()
        # boot entity id is generated ON THE GATE (reference:
        # onNewClientProxy, GateService.go:214-219)
        cp.owner_entity_id = gen_id()
        if not self._send_boot(cp):
            self._pending_boots.append(cp)

    def _send_boot(self, cp: ClientProxy) -> bool:
        conn = self.cluster.by_entity(cp.owner_entity_id)
        if conn is None:
            return False
        try:
            conn.send_notify_client_connected(cp.client_id, cp.owner_entity_id)
            conn.flush()
        except OSError:
            return False
        return True

    def _retry_pending_boots(self):
        if not self._pending_boots:
            return
        still = [
            cp for cp in self._pending_boots
            if cp.alive and not self._send_boot(cp)
        ]
        self._pending_boots = still

    def _on_client_gone(self, cp: ClientProxy):
        cp.alive = False
        if self.clients.get(cp.client_id) is cp:
            del self.clients[cp.client_id]
        for tree in self.filter_trees.values():
            tree.remove(cp)
        if cp.owner_entity_id:
            conn = self.cluster.by_entity(cp.owner_entity_id)
            if conn:
                conn.send_notify_client_disconnected(
                    cp.client_id, cp.owner_entity_id
                )

    def _kick_dead_clients(self, now: float):
        timeout = self.gatecfg.heartbeat_timeout_s
        if timeout <= 0:
            return
        for cp in list(self.clients.values()):
            if now - cp.last_heartbeat > timeout:
                self.log.info("client %s heartbeat timeout", cp.client_id)
                cp.pc.close()

    # -- client -> cluster -------------------------------------------------
    def _handle_client_packet(self, cp: ClientProxy, pkt: Packet):
        msgtype = pkt.read_u16()
        cp.last_heartbeat = self.now()
        if msgtype == MT.MT_HEARTBEAT:
            return
        if msgtype == MT.MT_CALL_ENTITY_METHOD_FROM_CLIENT:
            eid = pkt.read_entity_id()
            method = pkt.read_varstr()
            args = pkt.read_args()
            conn = self.cluster.by_entity(eid)
            if conn:
                conn.send_call_entity_method_from_client(
                    eid, method, args, cp.client_id
                )
            return
        if msgtype == MT.MT_SYNC_POSITION_YAW_FROM_CLIENT:
            # only the owner entity may be driven by this client
            eid = pkt.read_entity_id()
            if eid != cp.owner_entity_id:
                return
            rec = pkt.read_bytes(16)
            from ...dispatchercluster import entity_shard

            di = entity_shard(eid, len(self.cluster.conns))
            batch = self._sync_batches.get(di)
            if batch is None:
                batch = Packet.for_msgtype(MT.MT_SYNC_POSITION_YAW_FROM_CLIENT)
                self._sync_batches[di] = batch
            batch.append_entity_id(eid)
            batch.append_bytes(rec)
            return
        self.log.warning("unexpected client msgtype %d", msgtype)

    def _flush_sync_batches(self):
        # telemetry on: every flushed batch is the ORIGIN of one causal
        # trace -- a fresh trace id at hop 0, carried as a wire trailer the
        # dispatcher strips, measures, and re-stamps per game.  Telemetry
        # off: nothing is appended and the bytes stay identical.
        traced = telemetry.enabled()
        for di, batch in self._sync_batches.items():
            conn = self.cluster.conns[di]
            if conn:
                if traced:
                    tracectx.stamp(batch, tracectx.new_trace_id(), hop=0)
                flight.note_packet(
                    "tx", MT.MT_SYNC_POSITION_YAW_FROM_CLIENT,
                    len(batch.buf))
                conn.send(batch)
        self._sync_batches.clear()

    # -- cluster -> client -------------------------------------------------
    def _handle_dispatcher_packet(self, pkt: Packet):
        msgtype = pkt.read_u16()
        if MT.is_redirect_to_client(msgtype):
            _gate_id = pkt.read_u16()
            client_id = pkt.read_client_id()
            cp = self.clients.get(client_id)
            if cp is not None:
                if msgtype == MT.MT_CREATE_ENTITY_ON_CLIENT:
                    # the owner entity may change (GiveClientTo)
                    body = Packet(bytearray(pkt.payload))
                    body.read_u16()
                    body.read_u16()
                    body.read_client_id()
                    type_name = body.read_varstr()
                    eid = body.read_entity_id()
                    is_player = body.read_bool()
                    if is_player:
                        cp.owner_entity_id = eid
                # forward without the gate_id+client_id prefix: rebuild as
                # (msgtype, rest-of-body)
                out = Packet.for_msgtype(msgtype)
                out.append_bytes(bytes(pkt.buf[pkt.rpos:]))
                cp.send(out)
            return
        if msgtype == MT.MT_SYNC_POSITION_YAW_ON_CLIENTS:
            _gate_id = pkt.read_u16()
            # strip the trace trailer BEFORE the stride-48 regroup loop --
            # the trailer is not a (client_id, record) pair
            ctx = tracectx.try_strip(pkt, stride=48)
            if ctx is not None:
                tracectx.record_hop(ctx, "gate.sync_down")
                tracectx.record_local_span(ctx, "wire.hop")
            # regroup records per client (reference: GateService.go:347-373)
            per_client: dict[str, Packet] = {}
            while pkt.remaining() > 0:
                client_id = pkt.read_client_id()
                record = pkt.read_bytes(32)  # eid + x,y,z,yaw
                out = per_client.get(client_id)
                if out is None:
                    out = Packet.for_msgtype(MT.MT_SYNC_POSITION_YAW_ON_CLIENTS)
                    per_client[client_id] = out
                out.append_bytes(record)
            for client_id, out in per_client.items():
                cp = self.clients.get(client_id)
                if cp is not None:
                    cp.send(out)
            return
        if msgtype == MT.MT_CALL_FILTERED_CLIENTS:
            key = pkt.read_varstr()
            op = pkt.read_u8()
            value = pkt.read_varstr()
            method = pkt.read_varstr()
            args_raw = bytes(pkt.buf[pkt.rpos :])
            tree = self.filter_trees.get(key)
            if tree is None:
                return
            # client-facing shape: (method, args) -- a client-global call,
            # distinct from entity calls
            out = Packet.for_msgtype(MT.MT_CALL_FILTERED_CLIENTS)
            out.append_varstr(method)
            out.append_bytes(args_raw)
            payload = out.payload
            for cp in tree.visit(op, value):
                cp.send_payload(payload)
            return
        if msgtype == MT.MT_KICK_CLIENT:
            _gate_id = pkt.read_u16()
            client_id = pkt.read_client_id()
            cp = self.clients.get(client_id)
            if cp is not None:
                self.log.warning("kicking client %s (server request)",
                                 client_id)
                cp.pc.close()  # recv thread sees EOF -> client_gone teardown
            return
        if msgtype == MT.MT_SET_CLIENTPROXY_FILTER_PROP:
            _gate_id = pkt.read_u16()
            client_id = pkt.read_client_id()
            key = pkt.read_varstr()
            value = pkt.read_varstr()
            cp = self.clients.get(client_id)
            if cp is None:
                return
            cp.filter_props[key] = value
            tree = self.filter_trees.setdefault(key, FilterTree())
            tree.insert(cp, value)
            return
        if msgtype == MT.MT_CLEAR_CLIENTPROXY_FILTER_PROPS:
            _gate_id = pkt.read_u16()
            client_id = pkt.read_client_id()
            cp = self.clients.get(client_id)
            if cp is None:
                return
            for key in cp.filter_props:
                tree = self.filter_trees.get(key)
                if tree:
                    tree.remove(cp)
            cp.filter_props.clear()
            return
        if msgtype == MT.MT_NOTIFY_DEPLOYMENT_READY:
            self.log.info("deployment ready")
            return
        self.log.warning("unhandled dispatcher msgtype %d", msgtype)
