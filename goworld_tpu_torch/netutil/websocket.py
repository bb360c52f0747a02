"""Minimal RFC 6455 WebSocket transport (reference role: the gate's
websocket endpoint, gate.go:92-95 via golang.org/x/net/websocket).

Packets ride in binary frames; :class:`WSSocket` adapts a handshaken socket
to the ``recv``/``sendall``/``shutdown``/``close`` subset PacketConnection
uses, so the framed-packet layer is transport-agnostic.  Control frames
(ping/pong/close) are handled inside ``recv``.  Client->server frames are
masked per the RFC; server->client frames are not.

Robustness properties (each has a test):
  * bytes pipelined behind the HTTP handshake are preserved (the handshake
    functions return the residue, which seeds the WSSocket buffer);
  * frame parsing never consumes partial headers -- a socket timeout
    mid-frame leaves the stream position intact, so non-blocking polls with
    short timeouts can't desync the stream;
  * frames above MAX_FRAME_SIZE are rejected before buffering the payload;
  * sends are serialized by a lock (control-frame replies happen on the
    reader thread while data frames come from the logic thread).

The port's copy of the JAX package's ``netutil/websocket.py``: the same
frames and handshake bytes.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10

# above the packet layer's 25 MB MAX_PACKET_SIZE, below anything abusive
MAX_FRAME_SIZE = 32 << 20


def _accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _read_http_head(sock: socket.socket) -> tuple[bytes, bytes]:
    """Returns (head, residue): residue is whatever arrived after the blank
    line -- frames pipelined behind the handshake must not be lost."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(4096)
        if not chunk:
            raise OSError("connection closed during websocket handshake")
        buf += chunk
        if len(buf) > 65536:
            raise ValueError("oversized websocket handshake")
    head, residue = buf.split(b"\r\n\r\n", 1)
    return head, residue


def server_handshake(sock: socket.socket) -> tuple[dict[str, str], bytes]:
    """Read the client's HTTP upgrade request and reply 101; returns the
    request headers (lower-cased keys) and any residue bytes (pass to
    :class:`WSSocket`)."""
    head, residue = _read_http_head(sock)
    lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key")
    if (
        key is None
        or "websocket" not in headers.get("upgrade", "").lower()
        or not lines[0].startswith("GET ")
    ):
        sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        raise ValueError("not a websocket upgrade request")
    sock.sendall(
        (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n\r\n"
        ).encode("ascii")
    )
    return headers, residue


def client_handshake(sock: socket.socket, host: str, path: str = "/ws") -> bytes:
    """Performs the upgrade; returns residue bytes (frames the server
    pipelined behind its 101 response)."""
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    sock.sendall(
        (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        ).encode("ascii")
    )
    head, residue = _read_http_head(sock)
    status = head.split(b"\r\n", 1)[0]
    if b"101" not in status:
        raise OSError(f"websocket handshake rejected: {status!r}")
    want = _accept_key(key).encode("ascii")
    if want not in head:
        raise OSError("websocket handshake accept-key mismatch")
    return residue


def _xor_mask(payload: bytes, mkey: bytes) -> bytes:
    if not payload:
        return payload
    n = len(payload)
    full = mkey * (n // 4 + 1)
    return (
        int.from_bytes(payload, "big") ^ int.from_bytes(full[:n], "big")
    ).to_bytes(n, "big")


def _encode_frame(opcode: int, payload: bytes, mask: bool) -> bytes:
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < 1 << 16:
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        mkey = os.urandom(4)
        head += mkey
        payload = _xor_mask(payload, mkey)
    return bytes(head) + payload


class WSSocket:
    """Socket-like adapter over a handshaken websocket connection."""

    def __init__(self, sock: socket.socket, *, mask_outgoing: bool,
                 residue: bytes = b""):
        self._sock = sock
        self._mask = mask_outgoing
        self._rbuf = bytearray(residue)
        self._fragments: list[bytes] = []
        self._send_lock = threading.Lock()

    # -- sending -----------------------------------------------------------
    def _send_frame(self, opcode: int, payload: bytes) -> None:
        frame = _encode_frame(opcode, bytes(payload), self._mask)
        with self._send_lock:
            self._sock.sendall(frame)

    def sendall(self, data: bytes) -> None:
        self._send_frame(OP_BINARY, data)

    # -- receiving ---------------------------------------------------------
    def _parse_frame(self):
        """Parse one complete frame from _rbuf without consuming partial
        data; returns (fin, opcode, payload) or None if incomplete."""
        buf = self._rbuf
        if len(buf) < 2:
            return None
        b0, b1 = buf[0], buf[1]
        masked, plen = b1 & 0x80, b1 & 0x7F
        off = 2
        if plen == 126:
            if len(buf) < off + 2:
                return None
            plen = struct.unpack_from(">H", buf, off)[0]
            off += 2
        elif plen == 127:
            if len(buf) < off + 8:
                return None
            plen = struct.unpack_from(">Q", buf, off)[0]
            off += 8
        if plen > MAX_FRAME_SIZE:
            raise ValueError(f"oversized websocket frame: {plen}")
        if masked:
            if len(buf) < off + 4:
                return None
            mkey = bytes(buf[off : off + 4])
            off += 4
        else:
            mkey = None
        if len(buf) < off + plen:
            return None
        payload = bytes(buf[off : off + plen])
        del buf[: off + plen]
        if mkey:
            payload = _xor_mask(payload, mkey)
        return b0 & 0x80, b0 & 0x0F, payload

    def recv(self, _bufsize: int = 65536) -> bytes:
        """Next data payload (joined across fragments); b'' on close.
        TimeoutError propagates without losing stream position."""
        while True:
            try:
                frame = self._parse_frame()
            except ValueError:
                return b""  # poisoned stream: treat as closed
            if frame is None:
                try:
                    chunk = self._sock.recv(65536)
                except TimeoutError:
                    raise
                except OSError:
                    return b""
                if not chunk:
                    return b""
                self._rbuf += chunk
                continue
            fin, opcode, payload = frame
            if opcode == OP_CLOSE:
                try:
                    self._send_frame(OP_CLOSE, payload[:2])
                except OSError:
                    pass
                return b""
            if opcode == OP_PING:
                try:
                    self._send_frame(OP_PONG, payload)
                except OSError:
                    return b""
                continue
            if opcode == OP_PONG:
                continue
            self._fragments.append(payload)
            if fin:
                out = b"".join(self._fragments)
                self._fragments = []
                if out:
                    return out
                continue  # empty data frame: keep reading

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self, how: int) -> None:
        try:
            self._send_frame(OP_CLOSE, b"")
        except OSError:
            pass
        self._sock.shutdown(how)

    def close(self) -> None:
        self._sock.close()

    def setsockopt(self, *args) -> None:
        self._sock.setsockopt(*args)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def gettimeout(self):
        return self._sock.gettimeout()
