"""Headless game client: full client-side protocol implementation.

Reference role: examples/test_client (ClientBot.go / ClientEntity.go) -- the
bot client that mirrors server entities from the wire protocol; used by e2e
tests as strict protocol assertions and by users as the client SDK model.

Maintains:
  * ``entities``: id -> ClientEntity mirrors built from create/destroy ops;
  * attr mirrors updated via the delta stream (attrs.apply_delta);
  * positions updated from batched sync records;
  * the player (own) entity, re-bound on ownership handoff.

The port's copy of the JAX package's ``client.py``: TCP (TLS optional),
KCP (``transport="kcp"``; TLS over it raises ``ValueError``) and
WebSocket (``transport="ws"``, TLS optional).
"""

from __future__ import annotations

import threading
import time

from .engine.attrs import MapAttr, apply_delta
from .netutil import Packet, PacketConnection, connect_tcp, kcp, websocket
from .proto import msgtypes as MT


class ClientEntity:
    def __init__(self, type_name: str, eid: str, is_player: bool,
                 attrs: dict, pos: tuple, yaw: float):
        self.type_name = type_name
        self.id = eid
        self.is_player = is_player
        self.attrs = MapAttr(attrs)
        self.position = pos
        self.yaw = yaw
        self.calls: list[tuple] = []  # (method, args) received from server

    def __repr__(self):
        return f"<client-mirror {self.type_name}:{self.id}{' (player)' if self.is_player else ''}>"


class GameClientConnection:
    """A connected client.  ``poll()`` drains pending server messages on the
    caller's thread (no background threads -- deterministic for tests)."""

    def __init__(self, addr: tuple[str, int], compression: str = "gwlz",
                 transport: str = "tcp", tls: bool = False,
                 tls_cafile: str | None = None, strict: bool = False):
        if transport == "kcp":
            if tls or tls_cafile:
                raise ValueError("tls over kcp is not supported")
            sock = kcp.connect_kcp(addr)
        elif transport in ("tcp", "ws"):
            sock = connect_tcp(addr)
            if tls or tls_cafile:
                import ssl

                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                if tls_cafile:
                    ctx.load_verify_locations(tls_cafile)
                else:
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl.CERT_NONE
                sock = ctx.wrap_socket(sock, server_hostname=addr[0])
            if transport == "ws":
                residue = websocket.client_handshake(
                    sock, f"{addr[0]}:{addr[1]}"
                )
                sock = websocket.WSSocket(
                    sock, mask_outgoing=True, residue=residue
                )
        else:
            raise ValueError(f"unknown transport {transport!r}")
        self.pc = PacketConnection(sock, compression=compression)
        self.client_id: str | None = None
        self.entities: dict[str, ClientEntity] = {}
        self.player: ClientEntity | None = None
        self.filtered_calls: list[tuple] = []
        self._lock = threading.Lock()
        self.pc._sock.settimeout(0.01)
        # strict protocol-invariant mode (reference: test_client -strict,
        # ClientBot.go): hard violations raise; soft anomalies (explainable
        # by in-flight races, e.g. a delta for a just-destroyed mirror) are
        # counted in ``anomalies``
        self.strict = strict
        self.anomalies: dict[str, int] = {}
        self.closed = False

    def _violation(self, msg: str):
        if self.strict:
            raise AssertionError(f"protocol violation: {msg}")

    def _anomaly(self, kind: str):
        self.anomalies[kind] = self.anomalies.get(kind, 0) + 1

    # -- receive -----------------------------------------------------------
    def poll(self, duration: float = 0.0) -> int:
        """Process everything available (for up to ``duration`` seconds);
        returns number of packets handled.  Sets ``closed`` and returns
        immediately on EOF (e.g. the server kicked this client)."""
        deadline = time.monotonic() + duration
        n = 0
        while not self.closed:
            try:
                pkt = self.pc.recv_packet()
            except TimeoutError:
                if time.monotonic() >= deadline:
                    break
                continue
            except OSError:
                self.closed = True
                break
            if pkt is None:  # recv_packet returns None only on clean EOF
                self.closed = True
                break
            self._handle(pkt)
            n += 1
        return n

    def wait_for(self, predicate, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll(0.02)
            if predicate(self):
                return True
        return False

    def _handle(self, pkt: Packet):
        msgtype = pkt.read_u16()
        if msgtype == MT.MT_CLIENT_HANDSHAKE:
            if self.client_id is not None:
                self._violation("second handshake")
            self.client_id = pkt.read_client_id()
        elif msgtype == MT.MT_CREATE_ENTITY_ON_CLIENT:
            type_name = pkt.read_varstr()
            eid = pkt.read_entity_id()
            is_player = pkt.read_bool()
            attrs = pkt.read_data()
            pos = (pkt.read_f32(), pkt.read_f32(), pkt.read_f32())
            yaw = pkt.read_f32()
            if eid in self.entities:
                # a non-player duplicate means the server double-created a
                # mirror; a player re-create happens on GiveClientTo handoff
                if not is_player:
                    self._violation(f"duplicate create for {eid}")
                self._anomaly("recreate")
            if is_player and self.player is not None and self.player.id != eid:
                # ownership moved (handoff): the old player mirror must have
                # been destroyed or will be -- track as anomaly if it wasn't
                if self.player.id in self.entities:
                    self._anomaly("player_switch_old_alive")
            e = ClientEntity(type_name, eid, is_player, attrs or {}, pos, yaw)
            self.entities[eid] = e
            if is_player:
                self.player = e
        elif msgtype == MT.MT_DESTROY_ENTITY_ON_CLIENT:
            _type_name = pkt.read_varstr()
            eid = pkt.read_entity_id()
            if eid not in self.entities:
                self._violation(f"destroy for unknown mirror {eid}")
            e = self.entities.pop(eid, None)
            if e is not None and self.player is e:
                self.player = None
        elif msgtype == MT.MT_NOTIFY_ATTR_CHANGE_ON_CLIENT:
            eid = pkt.read_entity_id()
            d = pkt.read_data()
            e = self.entities.get(eid)
            if e is not None:
                apply_delta(e.attrs, tuple(d["p"]), d["o"], d["v"])
            else:
                # tolerated: the delta can race a destroy through the gate
                self._anomaly("delta_unknown_mirror")
        elif msgtype == MT.MT_CALL_ENTITY_METHOD_ON_CLIENT:
            eid = pkt.read_entity_id()
            method = pkt.read_varstr()
            args = pkt.read_args()
            e = self.entities.get(eid)
            if e is not None:
                e.calls.append((method, args))
            else:
                self._anomaly("call_unknown_mirror")
        elif msgtype == MT.MT_SYNC_POSITION_YAW_ON_CLIENTS:
            while pkt.remaining() > 0:
                eid = pkt.read_entity_id()
                x, y, z = pkt.read_f32(), pkt.read_f32(), pkt.read_f32()
                yaw = pkt.read_f32()
                e = self.entities.get(eid)
                if e is not None:
                    e.position = (x, y, z)
                    e.yaw = yaw
                else:
                    self._anomaly("sync_unknown_mirror")
        elif msgtype == MT.MT_CALL_FILTERED_CLIENTS:
            method = pkt.read_varstr()
            args = pkt.read_args()
            self.filtered_calls.append((method, args))
        else:
            self._violation(f"unexpected msgtype {msgtype}")

    # -- send --------------------------------------------------------------
    def call_server(self, eid: str, method: str, *args):
        p = Packet.for_msgtype(MT.MT_CALL_ENTITY_METHOD_FROM_CLIENT)
        p.append_entity_id(eid)
        p.append_varstr(method)
        p.append_args(args)
        self.pc.send_packet(p)
        self.pc.flush()

    def call_player(self, method: str, *args):
        if self.player is None:
            raise RuntimeError("no player entity yet")
        self.call_server(self.player.id, method, *args)

    def send_position(self, x: float, y: float, z: float, yaw: float = 0.0):
        if self.player is None:
            return
        p = Packet.for_msgtype(MT.MT_SYNC_POSITION_YAW_FROM_CLIENT)
        p.append_entity_id(self.player.id)
        import struct

        p.append_bytes(struct.pack("<ffff", x, y, z, yaw))
        self.pc.send_packet(p)
        self.pc.flush()

    def heartbeat(self):
        self.pc.send_packet(Packet.for_msgtype(MT.MT_HEARTBEAT))
        self.pc.flush()

    def close(self):
        self.pc.close()
