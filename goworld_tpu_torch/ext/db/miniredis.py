"""In-process mini-redis: a RESP2 server speaking the command subset the
redis storage/kvdb backends use (GET/SET/SETNX/EXISTS/DEL/KEYS/ZADD/ZREM/
ZRANGEBYLEX/SELECT/PING/FLUSHDB/DBSIZE).

Purpose: hermetic tests and dev runs without a real redis (the reference's
backend tests require live mongo/redis/mysql services in CI --
.travis.yml:27-35; this image has none, so the framework ships its own
wire-compatible stand-in).  Data is in-memory, per-db-index, protected by
one lock; not a production database.
"""

from __future__ import annotations

import fnmatch
import socket
import threading


class MiniRedis:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._dbs: dict[int, dict[bytes, bytes]] = {}
        self._zsets: dict[int, dict[bytes, set[bytes]]] = {}
        self._lock = threading.Lock()
        # cluster mode (set by MiniRedisCluster): this node's slot range and
        # the full topology for CLUSTER SLOTS / -MOVED replies
        self.slot_range: tuple[int, int] | None = None
        self.cluster_view: list[tuple[int, int, tuple[str, int]]] = []
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.addr = self._listener.getsockname()
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def close(self):
        self._stop.set()
        self._listener.close()

    # -- serving -----------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(sock,), daemon=True
            ).start()

    def _serve_conn(self, sock: socket.socket):
        buf = b""
        db = 0

        def read_line():
            nonlocal buf
            while b"\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise OSError
                buf += chunk
            line, buf = buf.split(b"\r\n", 1)
            return line

        def read_exact(n):
            nonlocal buf
            while len(buf) < n:
                chunk = sock.recv(65536)
                if not chunk:
                    raise OSError
                buf += chunk
            out, buf = buf[:n], buf[n:]
            return out

        try:
            while True:
                line = read_line()
                if not line.startswith(b"*"):
                    sock.sendall(b"-ERR protocol\r\n")
                    return
                argc = int(line[1:])
                args = []
                for _ in range(argc):
                    hdr = read_line()
                    n = int(hdr[1:])
                    args.append(read_exact(n))
                    read_exact(2)
                if not args:
                    continue
                cmd = args[0].upper().decode("ascii")
                if cmd == "SELECT":
                    db = int(args[1])
                    sock.sendall(b"+OK\r\n")
                    continue
                if cmd == "CLUSTER":
                    sock.sendall(self._cluster_reply(args[1:]))
                    continue
                moved = self._check_slot(cmd, args[1:])
                if moved is not None:
                    sock.sendall(moved)
                    continue
                reply = self._execute(db, cmd, args[1:])
                sock.sendall(reply)
        except OSError:
            pass
        finally:
            sock.close()

    # -- cluster mode ------------------------------------------------------
    _KEYED = frozenset({
        "GET", "SET", "SETNX", "EXISTS", "DEL", "ZADD", "ZREM",
        "ZRANGEBYLEX", "MGET",
    })

    def _cluster_reply(self, args: list[bytes]) -> bytes:
        sub = args[0].upper().decode("ascii") if args else ""
        if sub == "SLOTS" and self.cluster_view:
            out = [b"*%d\r\n" % len(self.cluster_view)]
            for start, end, (host, port) in self.cluster_view:
                hostb = host.encode("utf-8")
                out.append(
                    b"*3\r\n:%d\r\n:%d\r\n*2\r\n$%d\r\n%s\r\n:%d\r\n"
                    % (start, end, len(hostb), hostb, port)
                )
            return b"".join(out)
        return b"-ERR This instance has cluster support disabled\r\n"

    def _check_slot(self, cmd: str, args: list[bytes]) -> bytes | None:
        """-MOVED for keys this node does not own (cluster mode only)."""
        if self.slot_range is None or cmd not in self._KEYED or not args:
            return None
        from .respcluster import key_slot

        slot = key_slot(args[0])
        lo, hi = self.slot_range
        if lo <= slot <= hi:
            return None
        for start, end, (host, port) in self.cluster_view:
            if start <= slot <= end:
                return b"-MOVED %d %s:%d\r\n" % (slot, host.encode(), port)
        return b"-CLUSTERDOWN Hash slot not served\r\n"

    # -- commands ----------------------------------------------------------
    def _kv(self, db: int) -> dict[bytes, bytes]:
        return self._dbs.setdefault(db, {})

    def _zs(self, db: int) -> dict[bytes, set[bytes]]:
        return self._zsets.setdefault(db, {})

    @staticmethod
    def _bulk(v: bytes | None) -> bytes:
        if v is None:
            return b"$-1\r\n"
        return b"$%d\r\n%s\r\n" % (len(v), v)

    @staticmethod
    def _array(items: list[bytes]) -> bytes:
        return b"*%d\r\n" % len(items) + b"".join(
            MiniRedis._bulk(i) for i in items
        )

    def _execute(self, db: int, cmd: str, args: list[bytes]) -> bytes:
        with self._lock:
            kv, zs = self._kv(db), self._zs(db)
            if cmd == "PING":
                return b"+PONG\r\n"
            if cmd == "FLUSHDB":
                kv.clear()
                zs.clear()
                return b"+OK\r\n"
            if cmd == "DBSIZE":
                return b":%d\r\n" % len(kv)
            if cmd == "GET":
                return self._bulk(kv.get(args[0]))
            if cmd == "MGET":
                return b"*%d\r\n" % len(args) + b"".join(
                    self._bulk(kv.get(a)) for a in args
                )
            if cmd == "SET":
                kv[args[0]] = args[1]
                return b"+OK\r\n"
            if cmd == "SETNX":
                if args[0] in kv:
                    return b":0\r\n"
                kv[args[0]] = args[1]
                return b":1\r\n"
            if cmd == "EXISTS":
                return b":%d\r\n" % sum(1 for a in args if a in kv)
            if cmd == "DEL":
                n = 0
                for a in args:
                    if kv.pop(a, None) is not None:
                        n += 1
                    zs.pop(a, None)
                return b":%d\r\n" % n
            if cmd == "KEYS":
                pat = args[0].decode("utf-8", "replace")
                keys = sorted(
                    k for k in kv
                    if fnmatch.fnmatchcase(k.decode("utf-8", "replace"), pat)
                )
                return self._array(keys)
            if cmd == "ZADD":
                name = args[0]
                members = args[2::2]  # (score, member) pairs; scores ignored
                zset = zs.setdefault(name, set())
                added = sum(1 for m in members if m not in zset)
                zset.update(members)
                return b":%d\r\n" % added
            if cmd == "ZREM":
                zset = zs.get(args[0], set())
                n = sum(1 for m in args[1:] if m in zset)
                zset.difference_update(args[1:])
                return b":%d\r\n" % n
            if cmd == "ZRANGEBYLEX":
                zset = zs.get(args[0], set())
                lo, hi = args[1], args[2]
                out = sorted(zset)

                def keep(m: bytes) -> bool:
                    if lo == b"-":
                        ge = True
                    elif lo.startswith(b"["):
                        ge = m >= lo[1:]
                    elif lo.startswith(b"("):
                        ge = m > lo[1:]
                    else:
                        ge = False
                    if hi == b"+":
                        le = True
                    elif hi.startswith(b"["):
                        le = m <= hi[1:]
                    elif hi.startswith(b"("):
                        le = m < hi[1:]
                    else:
                        le = False
                    return ge and le

                return self._array([m for m in out if keep(m)])
            return b"-ERR unknown command '%s'\r\n" % cmd.encode()


class MiniRedisCluster:
    """N MiniRedis nodes with the 16384 slots split evenly between them --
    a hermetic stand-in for a real redis cluster (reference CI uses live
    services; this image has none)."""

    def __init__(self, n_nodes: int = 3, host: str = "127.0.0.1"):
        from .respcluster import SLOTS

        self.nodes = [MiniRedis(host) for _ in range(n_nodes)]
        per = SLOTS // n_nodes
        view = []
        for i, node in enumerate(self.nodes):
            start = i * per
            end = SLOTS - 1 if i == n_nodes - 1 else (i + 1) * per - 1
            node.slot_range = (start, end)
            view.append((start, end, node.addr))
        for node in self.nodes:
            node.cluster_view = view

    @property
    def addrs(self) -> list[tuple[str, int]]:
        return [n.addr for n in self.nodes]

    def close(self):
        for n in self.nodes:
            n.close()
