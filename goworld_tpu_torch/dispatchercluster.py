"""Dispatcher-cluster client: every game/gate connects to every dispatcher.

Reference: engine/dispatchercluster (+ dispatcherclient) -- star topology per
dispatcher; traffic for one entity always rides the same dispatcher so its
delivery order is preserved (sharding function below); infinite reconnect
with backoff and re-registration (DispatcherConnMgr.go:66-147).

Robustness model (docs/robustness.md):

* Reconnect uses capped exponential backoff with *deterministic* jitter --
  the jitter is hashed from (tag, index, attempt), not drawn from
  ``random``, so a seeded fault plan replays the exact same reconnect
  timeline every run.
* Sends that race a dead link are not lost: ``post`` buffers payloads in a
  bounded per-dispatcher deque while the link is down, and a dying
  connection's un-flushed batch is salvaged (``take_pending``) and
  prepended.  On reconnect the buffer replays -- after ``register`` so the
  dispatcher sees the registration first, and *before* the connection is
  published in ``conns``, so replayed packets cannot interleave with new
  traffic.  Combined with the ``conn.flush`` seam firing before the batch
  is popped, an injected reset delivers every packet exactly once.
* ``status()`` exposes per-dispatcher health for tests and ops.

The port's copy of the JAX package's ``dispatchercluster.py``.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
import zlib
from typing import Callable

from . import faults, telemetry
from .netutil import PacketConnection, Packet, connect_tcp
from .telemetry.metrics import Sample
from .proto import GWConnection
from .utils import gwlog


def entity_shard(eid: str, n: int) -> int:
    """Entity -> dispatcher index; all parties compute identically
    (reference: hash.go:7-12)."""
    return zlib.crc32(eid.encode("ascii")) % n


def gate_shard(gate_id: int, n: int) -> int:
    return gate_id % n


def srvid_shard(srvid: str, n: int) -> int:
    return zlib.crc32(srvid.encode("utf-8")) % n


class DispatcherCluster:
    """Maintains one GWConnection per dispatcher.

    ``on_packet(disp_index, Packet)`` is called from recv threads -- the
    owner must enqueue into its logic loop.  ``register(conn)`` is called
    (from the connect thread) every time a connection (re)establishes, so the
    owner re-sends its registration.
    """

    _next_telemetry_id = 0  # distinguishes live clusters in metric labels

    def __init__(
        self,
        addrs: list[tuple[str, int]],
        on_packet: Callable[[int, Packet], None],
        register: Callable[[GWConnection], None],
        tag: str = "cluster",
        backoff_base: float = 0.5,
        backoff_cap: float = 15.0,
        pending_cap: int = 1024,
    ):
        self.addrs = addrs
        self.on_packet = on_packet
        self.register = register
        self.tag = tag
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.conns: list[GWConnection | None] = [None] * len(addrs)
        self._stop = threading.Event()
        self._state_change = threading.Event()  # pulsed on connect/disconnect
        self.log = gwlog.logger(tag)
        # Per-dispatcher outage buffer: raw payloads awaiting replay.
        # Bounded drop-oldest -- a dispatcher down for minutes must not eat
        # the process's memory; drops are counted, never silent.
        self._pending: list[collections.deque[bytes]] = [
            collections.deque(maxlen=pending_cap) for _ in addrs
        ]
        self._pending_locks = [threading.Lock() for _ in addrs]
        self._stats = [
            {"connected": False, "attempts": 0, "backoff_s": 0.0,
             "pending": 0, "replayed": 0, "dropped": 0, "last_error": None,
             "next_attempt": 0.0}
            for _ in addrs
        ]
        self._threads = [
            threading.Thread(target=self._maintain, args=(i,), daemon=True)
            for i in range(len(addrs))
        ]
        # /debug/metrics exposes status() through the registry; weak so a
        # dropped cluster (tests build many) unregisters itself
        self._telemetry_id = DispatcherCluster._next_telemetry_id
        DispatcherCluster._next_telemetry_id += 1
        telemetry.register_collector(self._telemetry_collect, weak=True)

    def start(self):
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        self._state_change.set()
        for c in self.conns:
            if c is not None:
                c.close()

    def wait_connected(self, timeout: float = 10.0) -> bool:
        """Wait for all links up.  Backoff-aware: returns False as soon as
        every still-down link's next reconnect attempt lies beyond the
        deadline (no point burning the rest of the timeout)."""
        deadline = time.monotonic() + timeout
        while not self._stop.is_set():
            if all(c is not None for c in self.conns):
                return True
            now = time.monotonic()
            if now >= deadline:
                return False
            down = [s for c, s in zip(self.conns, self._stats) if c is None]
            if down and all(s["attempts"] > 0 and s["next_attempt"] > deadline
                            for s in down):
                return False
            self._state_change.wait(min(0.05, deadline - now))
            self._state_change.clear()
        return False

    def status(self) -> list[dict]:
        """Per-dispatcher health snapshot."""
        out = []
        now = time.monotonic()
        for i, s in enumerate(self._stats):
            d = dict(s)
            # surface the backoff clock as "seconds until the next retry"
            # (0 while connected / retry due) instead of the raw monotonic
            # deadline, which is meaningless outside this process
            d["next_retry_in"] = (
                max(0.0, d.pop("next_attempt") - now)
                if self.conns[i] is None else 0.0)
            d["connected"] = self.conns[i] is not None
            d["pending"] = len(self._pending[i])
            out.append(d)
        return out

    def _telemetry_collect(self) -> list[Sample]:
        """status() rendered as registry samples, one series per link
        (docs/observability.md: the disp.* catalog)."""
        out = []
        for i, s in enumerate(self.status()):
            labels = {"cluster": str(self._telemetry_id),
                      "tag": self.tag, "disp": str(i)}
            out.append(Sample("disp.connected", "gauge",
                              1.0 if s["connected"] else 0.0, labels,
                              "1 while the dispatcher link is up"))
            out.append(Sample("disp.attempts", "gauge",
                              float(s["attempts"]), labels,
                              "consecutive failed reconnect attempts"))
            out.append(Sample("disp.backoff_s", "gauge",
                              float(s["backoff_s"]), labels,
                              "current reconnect backoff"))
            out.append(Sample("disp.next_retry_in", "gauge",
                              float(s["next_retry_in"]), labels,
                              "seconds until the next reconnect attempt "
                              "(0 while connected)"))
            out.append(Sample("disp.pending", "gauge",
                              float(s["pending"]), labels,
                              "payloads buffered for outage replay"))
            out.append(Sample("disp.replayed", "counter",
                              float(s["replayed"]), labels,
                              "payloads replayed after reconnect"))
            out.append(Sample("disp.dropped", "counter",
                              float(s["dropped"]), labels,
                              "payloads dropped oldest-first on overflow"))
        return out

    # -- outage buffering --------------------------------------------------
    def post(self, i: int, p: Packet) -> bool:
        """Send ``p`` on dispatcher ``i``, buffering the payload for replay
        if the link is down.  Returns True if sent live, False if buffered
        (or dropped-oldest when the buffer is full)."""
        conn = self.conns[i]
        if conn is not None:
            try:
                conn.send(p)
                return True
            except (OSError, ConnectionResetError):
                pass  # fell into the outage window: buffer below
        self._buffer(i, p.payload)
        p.release()
        return False

    def _buffer(self, i: int, payload: bytes, *, front: bool = False):
        with self._pending_locks[i]:
            q = self._pending[i]
            if len(q) == q.maxlen:
                self._stats[i]["dropped"] += 1
            if front:
                if len(q) == q.maxlen:
                    q.pop()  # appendleft on a full deque evicts the TAIL
                q.appendleft(payload)
            else:
                q.append(payload)

    def _salvage(self, i: int, conn: GWConnection):
        """Move a dying connection's un-flushed batch into the outage
        buffer, in front (it predates anything posted afterwards)."""
        batch = conn.pc.take_pending()
        for payload in reversed(batch):
            self._buffer(i, payload, front=True)

    def _replay(self, i: int, conn: GWConnection) -> int:
        """Drain the outage buffer onto a fresh connection."""
        n = 0
        while True:
            with self._pending_locks[i]:
                if not self._pending[i]:
                    break
                payload = self._pending[i].popleft()
            conn.pc.send_raw(payload)
            n += 1
        if n:
            conn.flush()
            self._stats[i]["replayed"] += n
        return n

    # -- backoff -----------------------------------------------------------
    def _backoff_delay(self, i: int, attempts: int) -> float:
        """Capped exponential backoff with deterministic jitter in
        [-25%, +25%), hashed from (tag, index, attempt) so reconnect
        timelines replay bit-for-bit under a fault plan."""
        base = min(self.backoff_cap, self.backoff_base * 2 ** (attempts - 1))
        h = hashlib.sha256(f"{self.tag}:{i}:{attempts}".encode()).digest()
        jitter = int.from_bytes(h[:4], "little") / 2**31 - 1.0  # [-1, 1)
        return base * (1.0 + 0.25 * jitter)

    # -- connection maintenance (reference: assureConnected loop) ---------
    def _maintain(self, i: int):
        attempts = 0
        while not self._stop.is_set():
            try:
                faults.check("disp.connect")
                sock = connect_tcp(self.addrs[i], timeout=5.0)
            except (OSError, ConnectionResetError) as e:
                attempts += 1
                delay = self._backoff_delay(i, attempts)
                self._stats[i].update(
                    attempts=attempts, backoff_s=delay, last_error=repr(e),
                    next_attempt=time.monotonic() + delay)
                self._state_change.set()
                self._stop.wait(delay)
                continue
            attempts = 0
            conn = GWConnection(PacketConnection(sock))
            conn.index = i  # which dispatcher shard this link serves
            try:
                self.register(conn)
                conn.flush()
                # Replay buffered traffic BEFORE publishing the connection:
                # nothing new can be sent on it yet, so replayed packets
                # keep their original order relative to later sends.
                self._replay(i, conn)
            except (OSError, ConnectionResetError) as e:
                self._salvage(i, conn)
                conn.close()
                attempts += 1
                delay = self._backoff_delay(i, attempts)
                self._stats[i].update(
                    attempts=attempts, backoff_s=delay, last_error=repr(e),
                    next_attempt=time.monotonic() + delay)
                self._state_change.set()
                self._stop.wait(delay)
                continue
            self.conns[i] = conn
            self._stats[i].update(connected=True, attempts=0, backoff_s=0.0,
                                  last_error=None)
            self._state_change.set()
            # Anything posted into the buffer while we were registering
            # (post() saw conns[i] is None) goes out now.
            try:
                self._replay(i, conn)
            except (OSError, ConnectionResetError):
                pass  # recv loop below will notice the dead link
            try:
                while True:
                    pkt = conn.recv_packet()
                    if pkt is None:
                        break
                    self.on_packet(i, pkt)
            except (OSError, ValueError):
                pass
            self.conns[i] = None
            self._stats[i]["connected"] = False
            self._salvage(i, conn)
            conn.close()
            self._state_change.set()
            if not self._stop.is_set():
                self.log.warning("dispatcher %d lost; reconnecting", i)
                attempts += 1
                delay = self._backoff_delay(i, attempts)
                self._stats[i].update(attempts=attempts, backoff_s=delay,
                                      next_attempt=time.monotonic() + delay)
                self._stop.wait(delay)

    # -- cluster supervision ----------------------------------------------
    def renew_leases(self, game_id: int, epochs: dict[int, int],
                     space_ids: list[str],
                     metrics: dict | None = None) -> int:
        """Send a liveness lease renewal on every connected link whose
        dispatcher has granted an epoch (docs/robustness.md "Cluster
        supervision & host failover").  Down links are skipped, NOT
        buffered into the outage replay: a renewal replayed after an
        outage would carry a pre-outage epoch and be fenced -- liveness
        claims must be fresh or absent.  ``metrics`` piggybacks a metric
        snapshot as the renewal's versioned suffix (docs/observability.md
        "Cluster metrics").  Returns the number sent."""
        n = 0
        for i, conn in enumerate(self.conns):
            epoch = epochs.get(i)
            if conn is None or epoch is None:
                continue
            try:
                # keep the metrics-less call shape when there is nothing
                # to piggyback (fake connections in tests stub exactly it)
                if metrics is None:
                    conn.send_game_lease_renew(game_id, epoch, space_ids)
                else:
                    conn.send_game_lease_renew(game_id, epoch, space_ids,
                                               metrics=metrics)
                n += 1
            except (OSError, ConnectionResetError):
                pass
        return n

    # -- selection ---------------------------------------------------------
    def by_entity(self, eid: str) -> GWConnection | None:
        return self.conns[entity_shard(eid, len(self.conns))]

    def by_gate(self, gate_id: int) -> GWConnection | None:
        return self.conns[gate_shard(gate_id, len(self.conns))]

    def by_srvid(self, srvid: str) -> GWConnection | None:
        return self.conns[srvid_shard(srvid, len(self.conns))]

    def all(self) -> list[GWConnection]:
        return [c for c in self.conns if c is not None]

    def flush_all(self):
        for c in self.conns:
            if c is not None:
                try:
                    c.flush()
                except (OSError, ConnectionResetError):
                    pass
