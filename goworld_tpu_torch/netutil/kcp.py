"""Reliable ARQ-over-UDP transport (reference role: the gate's KCP listener
via kcp-go, GateService.go:84-85 -- same port as TCP in the reference; here a
dedicated ``kcp_port``).

This is a deliberately small KCP-style protocol ("gwkcp"), not wire-
compatible with KCP: conversation-id multiplexed sessions over one UDP
socket, sliding-window ARQ with cumulative acks, SRTT-based RTO with
exponential backoff, fast retransmit on 3 duplicate acks, and in-order byte
delivery.  :class:`KCPSocket` adapts a session to the ``recv``/``sendall``/
``shutdown``/``close``/``settimeout`` subset PacketConnection uses, so the
framed-packet layer rides it unchanged (exactly how WSSocket composes).

Datagram layout (little-endian):

    u32 conv | u8 cmd | u32 seq | u32 ack | u16 wnd | u16 len | bytes data

cmds: DATA=1 (seq = segment number, data = payload chunk), ACK=2 (ack =
next-expected-seq; seq echoes the highest seq seen, for RTT), FIN=3 (seq =
final segment number).  Sessions are created server-side on first datagram
for an unknown (addr, conv).

The port's copy of the JAX package's ``netutil/kcp.py``: the same
datagrams, so either package's client talks to the other's gate.
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
import time

_HDR = struct.Struct("<IBIIHH")
HDR_SIZE = _HDR.size
MSS = 1200
CMD_DATA, CMD_ACK, CMD_FIN = 1, 2, 3
SND_WND = 256  # max in-flight segments
RCV_WND = 1024  # max buffered out-of-order segments
TICK_S = 0.01
RTO_MIN, RTO_MAX = 0.03, 3.0
DEAD_LINK_S = 30.0  # give up after this long without progress


class _Segment:
    __slots__ = ("seq", "data", "sent_at", "resends", "rto", "fast_acks")

    def __init__(self, seq: int, data: bytes):
        self.seq = seq
        self.data = data
        self.sent_at = 0.0
        self.resends = 0
        self.rto = 0.0
        self.fast_acks = 0


class KCPSession:
    """One reliable conversation.  Owned by a KCPServer or KCPClient, which
    pumps datagrams in via :meth:`input` and calls :meth:`update`
    periodically from its ticker thread."""

    def __init__(self, conv: int, sendfn, peer: tuple[str, int]):
        self.conv = conv
        self._sendfn = sendfn  # bytes -> None (connected-vs-unconnected UDP)
        self.peer = peer
        self._lock = threading.Condition()
        # send side
        self._snd_queue: list[bytes] = []  # not yet windowed
        self._snd_buf: dict[int, _Segment] = {}  # in flight
        self._snd_next = 0  # next seq to assign
        self._snd_una = 0  # oldest unacked
        # receive side
        self._rcv_buf: dict[int, bytes] = {}  # out-of-order
        self._rcv_next = 0  # next expected seq
        self._rcv_bytes = queue.Queue()  # in-order chunks for recv()
        self._eof = False
        # rtt estimation (Jacobson/Karels)
        self._srtt = 0.0
        self._rttvar = 0.0
        self._rto = 0.2
        self._ack_due = False
        self._peer_fin = None  # seq after last data, once FIN seen
        self._fin_seq = None
        self._fin_pending = False  # shutdown requested, data still queued
        self._next_fin_at = 0.0  # FIN retransmit schedule
        # client-side: retransmit the opening announce until the peer is
        # heard from (UDP may drop the first datagram)
        self._announcing = False
        self._next_announce = 0.0
        self._last_progress = time.monotonic()
        self.closed = False
        self.dead = False
        self._timeout: float | None = None

    # -- wire --------------------------------------------------------------
    def _emit(self, cmd: int, seq: int, data: bytes = b""):
        wnd = max(0, RCV_WND - len(self._rcv_buf))
        pkt = _HDR.pack(self.conv, cmd, seq, self._rcv_next, wnd, len(data)) + data
        try:
            self._sendfn(pkt)
        except OSError:
            pass

    def input(self, cmd: int, seq: int, ack: int, wnd: int, data: bytes):
        """Process one incoming segment (called from the demux thread)."""
        with self._lock:
            self._last_progress = time.monotonic()
            self._announcing = False  # peer heard from
            # cumulative ack frees send buffer
            if ack > self._snd_una:
                for s in range(self._snd_una, ack):
                    seg = self._snd_buf.pop(s, None)
                    if seg is not None and seg.resends == 0:
                        self._update_rtt(time.monotonic() - seg.sent_at)
                self._snd_una = ack
                self._fill_window_locked()
            elif cmd == CMD_ACK and ack == self._snd_una:
                # duplicate ack: fast-retransmit candidates
                seg = self._snd_buf.get(ack)
                if seg is not None:
                    seg.fast_acks += 1
                    if seg.fast_acks >= 3:
                        seg.fast_acks = 0
                        self._retransmit_locked(seg)
            if cmd == CMD_DATA:
                if self._rcv_next <= seq < self._rcv_next + RCV_WND:
                    self._rcv_buf.setdefault(seq, data)
                    self._drain_rcv_locked()
                self._ack_due = True
            elif cmd == CMD_FIN:
                self._peer_fin = seq
                self._ack_due = True
                self._check_peer_fin_locked()
            self._lock.notify_all()

    def _drain_rcv_locked(self):
        while self._rcv_next in self._rcv_buf:
            chunk = self._rcv_buf.pop(self._rcv_next)
            self._rcv_next += 1
            self._rcv_bytes.put(chunk)
        self._check_peer_fin_locked()

    def _check_peer_fin_locked(self):
        if self._peer_fin is not None and self._rcv_next >= self._peer_fin:
            self._rcv_bytes.put(b"")  # EOF marker

    def _update_rtt(self, rtt: float):
        if self._srtt == 0.0:
            self._srtt, self._rttvar = rtt, rtt / 2
        else:
            self._rttvar = 0.75 * self._rttvar + 0.25 * abs(self._srtt - rtt)
            self._srtt = 0.875 * self._srtt + 0.125 * rtt
        self._rto = min(max(self._srtt + 4 * self._rttvar, RTO_MIN), RTO_MAX)

    # -- send --------------------------------------------------------------
    def send_bytes(self, data: bytes):
        if self.closed or self.dead:
            raise OSError("kcp session closed")
        with self._lock:
            for off in range(0, len(data), MSS):
                self._snd_queue.append(bytes(data[off : off + MSS]))
            self._fill_window_locked()

    def _fill_window_locked(self):
        while self._snd_queue and len(self._snd_buf) < SND_WND:
            payload = self._snd_queue.pop(0)
            seg = _Segment(self._snd_next, payload)
            self._snd_next += 1
            self._snd_buf[seg.seq] = seg
            seg.sent_at = time.monotonic()
            seg.rto = self._rto
            self._emit(CMD_DATA, seg.seq, seg.data)
        if not self._snd_queue and self._fin_pending and self._fin_seq is None:
            self._maybe_emit_fin_locked()

    def _retransmit_locked(self, seg: _Segment):
        seg.resends += 1
        seg.sent_at = time.monotonic()
        seg.rto = min(seg.rto * 1.5, RTO_MAX)
        self._emit(CMD_DATA, seg.seq, seg.data)

    # -- periodic ----------------------------------------------------------
    def update(self):
        now = time.monotonic()
        with self._lock:
            if self._announcing and now >= self._next_announce:
                self._next_announce = now + 0.2
                self._emit(CMD_ACK, 0)
            if self._ack_due:
                self._ack_due = False
                self._emit(CMD_ACK, self._rcv_next)
            for seg in list(self._snd_buf.values()):
                if now - seg.sent_at > seg.rto:
                    self._retransmit_locked(seg)
            if (
                self._fin_seq is not None
                and not self.dead
                and now >= self._next_fin_at
            ):
                self._emit(CMD_FIN, self._fin_seq)
                self._next_fin_at = now + min(
                    max(self._rto, RTO_MIN) * 2, RTO_MAX
                )
            if now - self._last_progress > DEAD_LINK_S and (
                self._snd_buf or self.closed
            ):
                self.dead = True
                self._rcv_bytes.put(b"")
                self._lock.notify_all()

    # -- socket-like API ---------------------------------------------------
    def recv(self, _bufsize: int = 65536) -> bytes:
        if self._eof or self.dead:
            return b""
        try:
            chunk = self._rcv_bytes.get(timeout=self._timeout)
        except queue.Empty:
            raise TimeoutError("kcp recv timeout") from None
        if chunk == b"":
            self._eof = True
        return chunk

    def sendall(self, data: bytes) -> None:
        self.send_bytes(data)

    def settimeout(self, t: float | None) -> None:
        self._timeout = t

    def gettimeout(self) -> float | None:
        return self._timeout

    def setsockopt(self, *args) -> None:
        pass

    def shutdown(self, how: int) -> None:
        with self._lock:
            self._fin_pending = True
            self._maybe_emit_fin_locked()

    def _maybe_emit_fin_locked(self):
        """FIN carries the seq AFTER the last data segment, so it can only
        be assigned once everything queued has been windowed; retransmitted
        from update() until the session ends (FIN is unreliable otherwise)."""
        if not self._fin_pending or self._snd_queue:
            return
        if self._fin_seq is None:
            self._fin_seq = self._snd_next
        self._emit(CMD_FIN, self._fin_seq)
        self._next_fin_at = time.monotonic() + max(self._rto, RTO_MIN)

    def drained(self) -> bool:
        """All outgoing data acked and FIN emitted (used by the client
        endpoint to linger before dropping the UDP socket)."""
        with self._lock:
            return (
                self._fin_seq is not None
                and not self._snd_buf
                and not self._snd_queue
            )

    def close(self) -> None:
        self.shutdown(socket.SHUT_RDWR)
        self.closed = True


KCPSocket = KCPSession  # the session IS the socket-like object


class _Endpoint:
    """Shared demux/ticker machinery for server and client."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.sessions: dict[tuple, KCPSession] = {}  # (addr, conv) -> sess
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._recv_loop, daemon=True),
            threading.Thread(target=self._tick_loop, daemon=True),
        ]

    def start(self):
        for t in self._threads:
            t.start()
        return self

    def close(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass

    def _tick_loop(self):
        while not self._stop.is_set():
            time.sleep(TICK_S)
            for key, sess in list(self.sessions.items()):
                sess.update()
                if sess.dead:
                    self.sessions.pop(key, None)

    def _recv_loop(self):
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65536)
            except OSError:
                return
            if len(data) < HDR_SIZE:
                continue
            conv, cmd, seq, ack, wnd, ln = _HDR.unpack_from(data)
            payload = data[HDR_SIZE : HDR_SIZE + ln]
            self._dispatch(addr, conv, cmd, seq, ack, wnd, payload)

    def _dispatch(self, addr, conv, cmd, seq, ack, wnd, payload):
        raise NotImplementedError


class KCPServer(_Endpoint):
    """UDP listener creating a session per new (addr, conv);
    ``on_connection(session, addr)`` runs on its own thread, mirroring
    serve_tcp's contract."""

    def __init__(self, addr: tuple[str, int], on_connection):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(addr)
        super().__init__(sock)
        self.addr = sock.getsockname()
        self.on_connection = on_connection

    def _dispatch(self, addr, conv, cmd, seq, ack, wnd, payload):
        key = (addr, conv)
        sess = self.sessions.get(key)
        if sess is None:
            sess = KCPSession(
                conv, lambda pkt, _a=addr: self.sock.sendto(pkt, _a), addr
            )
            self.sessions[key] = sess
            threading.Thread(
                target=self.on_connection, args=(sess, addr), daemon=True
            ).start()
        sess.input(cmd, seq, ack, wnd, payload)


class KCPClient(_Endpoint):
    def __init__(self, addr: tuple[str, int]):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.connect(addr)
        super().__init__(sock)
        conv = int.from_bytes(os.urandom(4), "little") or 1
        self.session = KCPSession(conv, sock.send, addr)
        self.sessions[(addr, conv)] = self.session
        # the session's close lingers until outgoing data + FIN are flushed
        # (or a short deadline) before dropping the UDP socket -- an
        # immediate teardown would make the FIN and any unacked tail
        # unretransmittable
        _orig_close = self.session.close

        def close_all():
            _orig_close()
            deadline = time.monotonic() + 3.0
            while time.monotonic() < deadline:
                if self.session.drained() or self.session.dead:
                    break
                time.sleep(TICK_S)
            time.sleep(2 * TICK_S)  # let the last FIN/retransmit go out
            self.close()

        self.session.close = close_all  # type: ignore[method-assign]

    def _dispatch(self, addr, conv, cmd, seq, ack, wnd, payload):
        if conv == self.session.conv:
            self.session.input(cmd, seq, ack, wnd, payload)


def connect_kcp(addr: tuple[str, int]) -> KCPSession:
    """Dial a KCP endpoint; returns the socket-like session.  An initial
    empty ACK announces the conversation so the server can create the
    session (and e.g. a gate can send its handshake) before the client
    sends any data."""
    sess = KCPClient(addr).start().session
    sess._announcing = True
    sess._emit(CMD_ACK, 0)
    return sess


def serve_kcp(addr: tuple[str, int], on_connection) -> KCPServer:
    return KCPServer(addr, on_connection).start()
