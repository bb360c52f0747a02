"""Cluster-aware RESP client: slot routing + MOVED/ASK redirects.

Reference role: the redis-go-cluster driver behind the reference's
redis_cluster storage/kvdb backends (engine/storage/backend/redis_cluster,
engine/kvdb/backend/redis_cluster).  Implements the redis-cluster client
contract: CRC16(XMODEM) key slots over 16384 buckets with ``{hash tag}``
extraction, topology discovery via ``CLUSTER SLOTS``, and -MOVED / -ASK
redirect handling with topology refresh.

Only single-key commands are routed (the engine's backends never issue
cross-slot multi-key commands).
"""

from __future__ import annotations

import threading

from .resp import RespClient, RespError

SLOTS = 16384


def _crc16(data: bytes) -> int:
    """CRC16/XMODEM (poly 0x1021, init 0) -- the redis cluster key hash."""
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else (crc << 1)
            crc &= 0xFFFF
    return crc


def key_slot(key: bytes | str) -> int:
    """Slot for a key, honoring the ``{hash tag}`` rule: if the key contains
    a non-empty ``{...}`` section, only its content is hashed."""
    if isinstance(key, str):
        key = key.encode("utf-8")
    start = key.find(b"{")
    if start != -1:
        end = key.find(b"}", start + 1)
        if end > start + 1:  # non-empty tag
            key = key[start + 1:end]
    return _crc16(key) % SLOTS


class RespClusterClient:
    """Routes each command to the node owning its key's slot.

    Threading contract: ``command()`` (and the ``_conns`` pool behind it)
    must be driven from ONE thread -- the storage/kvdb backends satisfy this
    by owning the client from a single OrderedWorker.  Only ``_slot_map``
    is lock-guarded, because ``_refresh_slots`` can be triggered from a
    MOVED reply mid-command."""

    def __init__(self, startup_nodes: list[tuple[str, int]],
                 timeout: float = 10.0):
        if not startup_nodes:
            raise ValueError("need at least one startup node")
        self._startup = list(startup_nodes)
        self._timeout = timeout
        self._conns: dict[tuple[str, int], RespClient] = {}
        self._slot_map: list[tuple[int, int, tuple[str, int]]] = []
        self._lock = threading.Lock()
        self._refresh_topology()

    # -- topology ----------------------------------------------------------
    def _refresh_topology(self):
        # try every node we know of -- startup seeds AND nodes learned from
        # CLUSTER SLOTS, so refresh survives dead seeds after a failover
        with self._lock:
            known = list(dict.fromkeys(
                self._startup + [addr for _, _, addr in self._slot_map]
            ))
        last_err: Exception | None = None
        for addr in known:
            try:
                reply = self._conn(addr).command("CLUSTER", "SLOTS")
            except (OSError, RespError) as e:
                last_err = e
                continue
            slot_map = []
            for entry in reply or []:
                start, end, master = int(entry[0]), int(entry[1]), entry[2]
                host = master[0]
                if isinstance(host, bytes):
                    host = host.decode("utf-8")
                slot_map.append((start, end, (host, int(master[1]))))
            if slot_map:
                with self._lock:
                    self._slot_map = slot_map
                return
        raise OSError(f"no cluster node reachable: {last_err}")

    def _node_for_slot(self, slot: int) -> tuple[str, int]:
        with self._lock:
            for start, end, addr in self._slot_map:
                if start <= slot <= end:
                    return addr
        # unassigned slot: any node will answer with MOVED
        return self._startup[0]

    def _conn(self, addr: tuple[str, int]) -> RespClient:
        c = self._conns.get(addr)
        if c is None:
            c = RespClient(addr[0], addr[1], timeout=self._timeout)
            self._conns[addr] = c
        return c

    def _drop_conn(self, addr: tuple[str, int]):
        c = self._conns.pop(addr, None)
        if c is not None:
            c.close()

    # -- API ---------------------------------------------------------------
    def command(self, *args, key: bytes | str | None = None):
        """Send one command routed by ``key`` (default: first argument after
        the command name).  Follows up to 5 MOVED/ASK redirects."""
        if key is None:
            if len(args) < 2:
                raise ValueError("cannot route a keyless command; pass key=")
            key = args[1]
        addr = self._node_for_slot(key_slot(key))
        asking = False
        for _ in range(5):
            try:
                conn = self._conn(addr)
                if asking:
                    conn.command("ASKING")
                    asking = False
                return conn.command(*args)
            except RespError as e:
                msg = str(e)
                if msg.startswith("MOVED "):
                    # topology changed: learn it, then retry at the new home
                    _slot, hostport = msg.split()[1:3]
                    host, _, port = hostport.rpartition(":")
                    addr = (host, int(port))
                    try:
                        self._refresh_topology()
                    except OSError:
                        pass
                    continue
                if msg.startswith("ASK "):
                    _slot, hostport = msg.split()[1:3]
                    host, _, port = hostport.rpartition(":")
                    addr = (host, int(port))
                    asking = True
                    continue
                raise
            except OSError:
                self._drop_conn(addr)
                self._refresh_topology()
                addr = self._node_for_slot(key_slot(key))
        raise OSError("too many cluster redirects")

    def close(self):
        for c in self._conns.values():
            c.close()
        self._conns.clear()
