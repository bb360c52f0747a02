"""Minimal RESP2 (redis serialization protocol) client, stdlib-only.

Used by the redis storage/kvdb backends and the gwredis ext wrapper
(reference role: the redigo driver behind engine/storage/backend/redis and
engine/kvdb/backend/redis).  Synchronous; the engine's ordered async
workers provide the concurrency model, so the client needs no pooling.
"""

from __future__ import annotations

import socket
import threading


class RespError(Exception):
    """Server-side -ERR reply."""


class RespClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, timeout: float = 10.0):
        self.addr = (host, port)
        self._sock = socket.create_connection(self.addr, timeout=timeout)
        self._sock.settimeout(timeout)
        self._buf = b""
        self._lock = threading.Lock()
        if db:
            self.command("SELECT", db)

    # -- protocol ----------------------------------------------------------
    def _encode(self, args: tuple) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, bytes):
                b = a
            elif isinstance(a, str):
                b = a.encode("utf-8")
            elif isinstance(a, (int, float)):
                b = repr(a).encode("ascii")
            else:
                raise TypeError(f"bad redis arg type {type(a)!r}")
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise OSError("redis connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise OSError("redis connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode("utf-8")
        if kind == b"-":
            raise RespError(rest.decode("utf-8"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise OSError(f"bad RESP reply type {line!r}")

    # -- API ---------------------------------------------------------------
    def command(self, *args):
        """Send one command, return its reply (bulk strings as bytes)."""
        with self._lock:
            self._sock.sendall(self._encode(args))
            return self._read_reply()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
