"""Framed packet connections.

Frame format (reference: PacketConnection.go -- 4-byte LE size prefix whose
top bit marks a compressed payload, 512 B compression threshold):

    u32le  size | (0x80000000 if compressed)
    bytes  payload (size bytes; compressed stream if flagged)

``PacketConnection`` wraps a blocking socket: sends accumulate in a pending
buffer and go out in one syscall per ``flush`` (the reference batches
identically and auto-flushes every 5 ms); receiving is a blocking
``recv_packet`` plus an incremental ``FrameParser`` for feed-style use.
Thread-safety: sends may come from any thread; flush serializes.

The port's copy of the JAX package's ``netutil/conn.py``.
"""

from __future__ import annotations

import socket
import struct
import threading

from .. import faults
from ..utils import opmon
from .compress import Compressor, new_compressor
from .packet import MAX_PACKET_SIZE, Packet

_COMPRESSED_BIT = 0x80000000
_SIZE_MASK = 0x7FFFFFFF
from ..consts import COMPRESS_THRESHOLD  # noqa: F401  (re-export; 512 B)
_u32 = struct.Struct("<I")


class FrameParser:
    """Incremental frame decoder: feed bytes, collect packets."""

    def __init__(self, compressor: Compressor | None = None):
        self._buf = bytearray()
        self._compressor = compressor or new_compressor("gwlz")

    def feed(self, data: bytes) -> list[Packet]:
        self._buf += data
        out = []
        while True:
            if len(self._buf) < 4:
                break
            header = _u32.unpack_from(self._buf, 0)[0]
            size = header & _SIZE_MASK
            if size > MAX_PACKET_SIZE:
                raise ValueError(f"oversized frame: {size}")
            if len(self._buf) < 4 + size:
                break
            payload = bytes(self._buf[4 : 4 + size])
            del self._buf[: 4 + size]
            if header & _COMPRESSED_BIT:
                try:
                    payload = self._compressor.decompress(payload)
                except Exception as e:  # zlib.error is not a ValueError
                    raise ValueError(
                        f"corrupt compressed frame: {e} "
                        f"(size={size}, codec={self._compressor.name}, "
                        f"head={payload[:32].hex()})"
                    ) from e
            p = Packet(bytearray(payload))
            out.append(p)
        return out


class PacketConnection:
    def __init__(
        self,
        sock: socket.socket,
        compression: str = "gwlz",
        compress_threshold: int = COMPRESS_THRESHOLD,
    ):
        self._sock = sock
        self._compressor = new_compressor(compression)
        self._threshold = compress_threshold
        self._pending: list[bytes] = []
        self._send_lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._parser = FrameParser(self._compressor)
        self._recv_chunks: list[Packet] = []
        self.closed = False

    # -- send side ---------------------------------------------------------
    def send_packet(self, p: Packet, release: bool = True):
        payload = p.payload
        if release:
            p.release()
        with self._send_lock:
            self._pending.append(payload)

    def take_pending(self) -> list[bytes]:
        """Pop and return the un-flushed payloads (for reconnect salvage:
        a dead connection's pending sends can be replayed on its
        replacement via ``send_raw``)."""
        with self._send_lock:
            batch, self._pending = self._pending, []
        return batch

    def send_raw(self, payload: bytes):
        """Queue an already-extracted payload (reconnect replay path)."""
        with self._send_lock:
            self._pending.append(payload)

    def flush(self) -> int:
        """Frame and write everything pending in one syscall; returns bytes
        written.  (Reference: single-flusher Flush(reason),
        PacketConnection.go:98-163.)"""
        with self._flush_lock:
            # A closed connection must not pop the batch: sends that raced
            # the close stay in _pending for reconnect salvage instead of
            # being dropped into a doomed sendall.  Checked before the
            # fault seam so dead-link flushes don't consume occurrences.
            if self.closed:
                raise ConnectionResetError("flush on closed connection")
            # The seam fires BEFORE the batch is popped: an injected reset
            # leaves _pending intact, so reconnect salvage sees the full
            # batch and replay stays exactly-once.
            try:
                spec = faults.check("conn.flush")
            except ConnectionResetError:
                self.close()  # peer sees EOF, like a real dropped link
                raise
            with self._send_lock:
                batch, self._pending = self._pending, []
            if not batch:
                return 0
            with opmon.Operation("conn.flush"):
                out = bytearray()
                for payload in batch:
                    if self._threshold and len(payload) >= self._threshold:
                        z = self._compressor.compress(payload)
                        if len(z) < len(payload):
                            out += _u32.pack(len(z) | _COMPRESSED_BIT)
                            out += z
                            continue
                    out += _u32.pack(len(payload))
                    out += payload
                # A timed-out sendall leaves a PARTIAL frame on the wire and
                # permanently desyncs the peer's parser (sendall's documented
                # undefined-state caveat), so the write itself must always
                # run blocking; the caller's timeout is restored for recv.
                timeout = self._sock.gettimeout()
                if timeout is not None:
                    self._sock.settimeout(None)
                try:
                    if spec is not None and spec.kind == "partial":
                        # Write a prefix of the batch, then drop the link:
                        # the peer's FrameParser is left mid-frame, exactly
                        # like a connection cut between TCP segments.
                        frac = spec.arg if spec.arg is not None else 0.5
                        self._sock.sendall(bytes(out[: int(len(out) * frac)]))
                        self.close()
                        raise ConnectionResetError(
                            "injected partial write (link dropped mid-frame)")
                    self._sock.sendall(out)
                finally:
                    if timeout is not None and not self.closed:
                        self._sock.settimeout(timeout)
            return len(out)

    # -- recv side ---------------------------------------------------------
    def recv_packet(self, bufsize: int = 65536) -> Packet | None:
        """Blocking read of the next packet; None on clean EOF."""
        while not self._recv_chunks:
            try:
                faults.check("conn.recv")
            except ConnectionResetError:
                self.close()
                raise
            data = self._sock.recv(bufsize)
            if not data:
                return None
            self._recv_chunks.extend(self._parser.feed(data))
        return self._recv_chunks.pop(0)

    def close(self):
        if not self.closed:
            self.closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()


def serve_tcp(addr: tuple[str, int], on_connection, *, backlog: int = 128,
              stop_event: threading.Event | None = None) -> socket.socket:
    """Accept loop in a daemon thread (reference: ServeTCPForever,
    TCPServer.go:22-64).  ``on_connection(sock, peer)`` runs on its own
    thread per connection.  Returns the listening socket (bound port via
    ``.getsockname()``)."""
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ls.bind(addr)
    ls.listen(backlog)

    def loop():
        while stop_event is None or not stop_event.is_set():
            try:
                sock, peer = ls.accept()
            except OSError:
                return  # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=on_connection, args=(sock, peer), daemon=True
            )
            t.start()

    threading.Thread(target=loop, daemon=True).start()
    return ls


def connect_tcp(addr: tuple[str, int], timeout: float | None = None) -> socket.socket:
    sock = socket.create_connection(addr, timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return sock
