"""Typed connection wrapper: one sender per message type.

Reference model: engine/proto/GoWorldConnection.go:36-423 (SendXxx methods
over a PacketConnection).  Bodies are described per sender; the position-sync
record is 16-byte EntityID + x,y,z,yaw f32 (16 B payload), matching the
reference's record economy (proto.go:135-139).

The port's copy of the JAX package's ``proto/connection.py``.
"""

from __future__ import annotations

import threading
import time

from .. import faults
from ..netutil import Packet, PacketConnection
from . import msgtypes as MT

# version of the optional metric-snapshot suffix (lease renew piggyback /
# MT_METRICS_REPORT body); receivers ignore versions they don't know
METRICS_SUFFIX_VERSION = 1


class GWConnection:
    """A PacketConnection plus typed senders and an auto-flush thread."""

    def __init__(self, pc: PacketConnection):
        self.pc = pc
        self._autoflush_thread: threading.Thread | None = None
        self._autoflush_stop = threading.Event()

    # -- plumbing ----------------------------------------------------------
    def send(self, p: Packet):
        try:
            faults.check("conn.send")
        except ConnectionResetError:
            self.pc.close()
            raise
        self.pc.send_packet(p)

    def flush(self):
        self.pc.flush()

    def recv_packet(self) -> Packet | None:
        return self.pc.recv_packet()

    def close(self):
        self._autoflush_stop.set()
        self.pc.close()

    def set_auto_flush(self, interval: float = 0.005):
        """Flush pending sends every ``interval`` seconds (reference:
        SetAutoFlush goroutine, GoWorldConnection.go:443-458)."""
        if self._autoflush_thread is not None:
            return

        def loop():
            while not self._autoflush_stop.wait(interval):
                try:
                    self.pc.flush()
                except OSError:
                    return

        self._autoflush_thread = threading.Thread(target=loop, daemon=True)
        self._autoflush_thread.start()

    # -- registration ------------------------------------------------------
    def send_set_game_id(self, game_id: int, is_restore: bool, eids: list[str]):
        p = Packet.for_msgtype(MT.MT_SET_GAME_ID)
        p.append_u16(game_id)
        p.append_bool(is_restore)
        p.append_u32(len(eids))
        for eid in eids:
            p.append_entity_id(eid)
        self.send(p)

    def send_set_gate_id(self, gate_id: int):
        p = Packet.for_msgtype(MT.MT_SET_GATE_ID)
        p.append_u16(gate_id)
        self.send(p)

    # -- entity directory --------------------------------------------------
    def send_notify_create_entity(self, eid: str):
        p = Packet.for_msgtype(MT.MT_NOTIFY_CREATE_ENTITY)
        p.append_entity_id(eid)
        self.send(p)

    def send_notify_destroy_entity(self, eid: str):
        p = Packet.for_msgtype(MT.MT_NOTIFY_DESTROY_ENTITY)
        p.append_entity_id(eid)
        self.send(p)

    # -- client lifecycle --------------------------------------------------
    def send_notify_client_connected(self, client_id: str, boot_eid: str):
        p = Packet.for_msgtype(MT.MT_NOTIFY_CLIENT_CONNECTED)
        p.append_client_id(client_id)
        p.append_entity_id(boot_eid)
        self.send(p)

    def send_notify_client_disconnected(self, client_id: str, owner_eid: str):
        p = Packet.for_msgtype(MT.MT_NOTIFY_CLIENT_DISCONNECTED)
        p.append_client_id(client_id)
        p.append_entity_id(owner_eid)
        self.send(p)

    # -- placement / RPC ---------------------------------------------------
    def send_create_entity_anywhere(self, type_name: str, eid: str, attrs: dict):
        p = Packet.for_msgtype(MT.MT_CREATE_ENTITY_ANYWHERE)
        p.append_entity_id(eid)
        p.append_varstr(type_name)
        p.append_data(attrs)
        self.send(p)

    def send_load_entity_anywhere(self, type_name: str, eid: str):
        p = Packet.for_msgtype(MT.MT_LOAD_ENTITY_ANYWHERE)
        p.append_entity_id(eid)
        p.append_varstr(type_name)
        self.send(p)

    def send_call_entity_method(self, eid: str, method: str, args: tuple):
        p = Packet.for_msgtype(MT.MT_CALL_ENTITY_METHOD)
        p.append_entity_id(eid)
        p.append_varstr(method)
        p.append_args(args)
        self.send(p)

    def send_call_entities_batch(self, eids, method: str, args_wire: bytes):
        """One packet carrying one RPC for MANY entities (batched fanout --
        pubsub publish and friends).  ``args_wire`` is the raw
        ``append_args`` encoding (netutil.packet.pack_args) so the
        dispatcher re-slices the batch per game without unpacking it."""
        p = Packet.for_msgtype(MT.MT_CALL_ENTITIES_BATCH)
        p.append_varstr(method)
        p.append_varbytes(args_wire)
        p.append_u32(len(eids))
        for eid in eids:
            p.append_entity_id(eid)
        self.send(p)

    def send_give_client_to(self, target_eid: str, client_id: str,
                            gate_id: int):
        """Hand client ownership to an entity on (possibly) another game;
        routed by the TARGET's shard so a loading target queues the handoff
        (reference: MT_GIVE_CLIENT_TO, Entity.go:752-765)."""
        p = Packet.for_msgtype(MT.MT_GIVE_CLIENT_TO)
        p.append_entity_id(target_eid)
        p.append_client_id(client_id)
        p.append_u16(gate_id)
        self.send(p)

    def send_call_entity_method_from_client(
        self, eid: str, method: str, args: tuple, client_id: str
    ):
        p = Packet.for_msgtype(MT.MT_CALL_ENTITY_METHOD_FROM_CLIENT)
        p.append_entity_id(eid)
        p.append_varstr(method)
        p.append_args(args)
        p.append_client_id(client_id)
        self.send(p)

    def send_call_nil_spaces(self, exclude_game: int, method: str, args: tuple):
        p = Packet.for_msgtype(MT.MT_CALL_NIL_SPACES)
        p.append_u16(exclude_game)
        p.append_varstr(method)
        p.append_args(args)
        self.send(p)

    # -- migration ---------------------------------------------------------
    def send_query_space_gameid_for_migrate(self, space_id: str, eid: str):
        p = Packet.for_msgtype(MT.MT_QUERY_SPACE_GAMEID_FOR_MIGRATE)
        p.append_entity_id(space_id)
        p.append_entity_id(eid)
        self.send(p)

    def send_migrate_request(self, eid: str, space_id: str, space_game: int):
        p = Packet.for_msgtype(MT.MT_MIGRATE_REQUEST)
        p.append_entity_id(eid)
        p.append_entity_id(space_id)
        p.append_u16(space_game)
        self.send(p)

    def send_real_migrate(self, eid: str, target_game: int, data: dict):
        p = Packet.for_msgtype(MT.MT_REAL_MIGRATE)
        p.append_entity_id(eid)
        p.append_u16(target_game)
        p.append_data(data)
        self.send(p)

    def send_cancel_migrate(self, eid: str):
        p = Packet.for_msgtype(MT.MT_CANCEL_MIGRATE)
        p.append_entity_id(eid)
        self.send(p)

    # -- srvdis ------------------------------------------------------------
    def send_srvdis_register(self, srvid: str, info: str, force: bool):
        p = Packet.for_msgtype(MT.MT_SRVDIS_REGISTER)
        p.append_varstr(srvid)
        p.append_varstr(info)
        p.append_bool(force)
        self.send(p)

    def send_srvdis_update(self, srvid: str, info: str):
        p = Packet.for_msgtype(MT.MT_SRVDIS_UPDATE)
        p.append_varstr(srvid)
        p.append_varstr(info)
        self.send(p)

    # -- freeze ------------------------------------------------------------
    def send_start_freeze_game(self):
        self.send(Packet.for_msgtype(MT.MT_START_FREEZE_GAME))

    def send_start_freeze_game_ack(self):
        self.send(Packet.for_msgtype(MT.MT_START_FREEZE_GAME_ACK))

    # -- LBC ---------------------------------------------------------------
    def send_game_lbc_info(self, load: float):
        p = Packet.for_msgtype(MT.MT_GAME_LBC_INFO)
        p.append_f32(load)
        self.send(p)

    # -- cluster supervision ----------------------------------------------
    def send_game_lease_renew(self, game_id: int, epoch: int,
                              space_ids: list[str],
                              metrics: dict | None = None):
        """Renew this game's liveness lease at one dispatcher, reporting the
        ownership epoch it holds and the space ids whose checkpoints it is
        writing (the re-homing inventory if this lease ever expires).

        ``metrics`` piggybacks a telemetry snapshot as a VERSIONED optional
        suffix (u8 version + data blob) -- old receivers see nothing (they
        stop at the space-id list), old senders send nothing, and the
        receiver consumes the blob only behind a version check
        (docs/protocol.md "Versioned optional suffixes")."""
        p = Packet.for_msgtype(MT.MT_GAME_LEASE_RENEW)
        p.append_u16(game_id)
        p.append_u32(epoch)
        p.append_u32(len(space_ids))
        for sid in space_ids:
            p.append_varstr(sid)
        if metrics is not None:
            p.append_u8(METRICS_SUFFIX_VERSION)
            p.append_data(metrics)
        self.send(p)

    def send_metrics_report(self, component: str, metrics: dict):
        """Push one component's metric snapshot to a dispatcher (gates --
        which hold no lease to piggyback on -- and any out-of-band
        reporter).  Same versioned blob as the lease-renew suffix."""
        p = Packet.for_msgtype(MT.MT_METRICS_REPORT)
        p.append_varstr(component)
        p.append_u8(METRICS_SUFFIX_VERSION)
        p.append_data(metrics)
        self.send(p)

    def send_game_lease_grant(self, epoch: int, ttl: float):
        p = Packet.for_msgtype(MT.MT_GAME_LEASE_GRANT)
        p.append_u32(epoch)
        p.append_f32(ttl)
        self.send(p)

    def send_game_shutdown(self):
        """Fence notice: the receiver's ownership epoch is stale (its spaces
        were re-homed while it stalled) and it must terminate without
        saving -- the split-brain kill switch."""
        self.send(Packet.for_msgtype(MT.MT_GAME_SHUTDOWN))

    # -- position sync -----------------------------------------------------
    @staticmethod
    def make_sync_on_clients_packet(gate_id: int) -> Packet:
        """Per-gate batch; the dispatcher routes whole packets by this id
        (batching at every hop, reference: GateService.go:400-427 /
        DispatcherService.go:784-827)."""
        p = Packet.for_msgtype(MT.MT_SYNC_POSITION_YAW_ON_CLIENTS)
        p.append_u16(gate_id)
        return p

    @staticmethod
    def append_sync_record(p: Packet, client_id: str, eid: str,
                           x: float, y: float, z: float, yaw: float):
        p.append_client_id(client_id)
        p.append_entity_id(eid)
        p.append_f32(x)
        p.append_f32(y)
        p.append_f32(z)
        p.append_f32(yaw)

    # -- gate band ---------------------------------------------------------
    def send_create_entity_on_client(
        self, gate_id: int, client_id: str, type_name: str, eid: str,
        is_player: bool, attrs: dict, pos: tuple, yaw: float,
    ):
        p = Packet.for_msgtype(MT.MT_CREATE_ENTITY_ON_CLIENT)
        p.append_u16(gate_id)
        p.append_client_id(client_id)
        p.append_varstr(type_name)
        p.append_entity_id(eid)
        p.append_bool(is_player)
        p.append_data(attrs)
        p.append_f32(pos[0])
        p.append_f32(pos[1])
        p.append_f32(pos[2])
        p.append_f32(yaw)
        self.send(p)

    def send_destroy_entity_on_client(self, gate_id: int, client_id: str,
                                      type_name: str, eid: str):
        p = Packet.for_msgtype(MT.MT_DESTROY_ENTITY_ON_CLIENT)
        p.append_u16(gate_id)
        p.append_client_id(client_id)
        p.append_varstr(type_name)
        p.append_entity_id(eid)
        self.send(p)

    def send_notify_attr_change_on_client(
        self, gate_id: int, client_id: str, eid: str, path: tuple, op: str, value
    ):
        p = Packet.for_msgtype(MT.MT_NOTIFY_ATTR_CHANGE_ON_CLIENT)
        p.append_u16(gate_id)
        p.append_client_id(client_id)
        p.append_entity_id(eid)
        p.append_data({"p": list(path), "o": op, "v": value})
        self.send(p)

    def send_call_entity_method_on_client(
        self, gate_id: int, client_id: str, eid: str, method: str, args: tuple
    ):
        p = Packet.for_msgtype(MT.MT_CALL_ENTITY_METHOD_ON_CLIENT)
        p.append_u16(gate_id)
        p.append_client_id(client_id)
        p.append_entity_id(eid)
        p.append_varstr(method)
        p.append_args(args)
        self.send(p)

    # -- filtered clients --------------------------------------------------
    def send_kick_client(self, gate_id: int, client_id: str):
        """Close a client's connection at its gate (MT_KICK_CLIENT): the
        recovery for a client left ownerless by a failed GiveClientTo."""
        p = Packet.for_msgtype(MT.MT_KICK_CLIENT)
        p.append_u16(gate_id)
        p.append_client_id(client_id)
        self.send(p)

    def send_set_clientproxy_filter_prop(self, gate_id: int, client_id: str,
                                         key: str, value: str):
        p = Packet.for_msgtype(MT.MT_SET_CLIENTPROXY_FILTER_PROP)
        p.append_u16(gate_id)
        p.append_client_id(client_id)
        p.append_varstr(key)
        p.append_varstr(value)
        self.send(p)

    def send_clear_clientproxy_filter_props(self, gate_id: int, client_id: str):
        p = Packet.for_msgtype(MT.MT_CLEAR_CLIENTPROXY_FILTER_PROPS)
        p.append_u16(gate_id)
        p.append_client_id(client_id)
        self.send(p)

    def send_call_filtered_clients(self, key: str, op: int, value: str,
                                   method: str, args: tuple):
        p = Packet.for_msgtype(MT.MT_CALL_FILTERED_CLIENTS)
        p.append_varstr(key)
        p.append_u8(op)
        p.append_varstr(value)
        p.append_varstr(method)
        p.append_args(args)
        self.send(p)
