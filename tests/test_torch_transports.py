"""The port's KCP and WebSocket transports (goworld_tpu_torch.netutil:
``kcp``, ``websocket``) against the JAX package's.

WebSocket: frames (masked under a fixed key, and unmasked), the accept
key and the client's upgrade request are the JAX bytes; each package's
socket reads the other's frames; ping / close, the handshake's residue,
a mid-frame timeout, an oversized frame and plain HTTP behave as in the
JAX tests.  KCP: the datagrams a session emits for a fixed input are the
JAX bytes; echo, a seeded 30%-loss bulk transfer, out-of-order
reassembly and FIN, each across the packages.  A port gate with TLS
serves both packages' clients over WebSocket (where ``openssl`` is
present, as the JAX test needs it)."""

import os
import random
import shutil
import socket
import subprocess
import threading

import numpy as np
import pytest

from goworld_tpu.netutil import kcp as jkcp
from goworld_tpu.netutil import websocket as jws
from goworld_tpu_torch.netutil import kcp, websocket as ws
from goworld_tpu_torch.netutil.conn import PacketConnection
from goworld_tpu_torch.netutil.packet import Packet

from test_torch_cluster import (package, scene_flow, start_cluster,
                                stop_cluster)
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture()
def fixed_mask(monkeypatch):
    """Both modules draw masks and keys from ``os.urandom``: pin it."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(7, 7 + n)))


def test_ws_frames_and_keys_equal_jax(fixed_mask):
    rng = np.random.default_rng(5)
    for n in (0, 1, 125, 126, 1000, 65535, 65536, 70000):
        payload = rng.bytes(n)
        for op in (ws.OP_BINARY, ws.OP_PING, ws.OP_CLOSE):
            for mask in (True, False):
                assert ws._encode_frame(op, payload, mask) == \
                    jws._encode_frame(op, payload, mask)
        mkey = rng.bytes(4)
        assert ws._xor_mask(payload, mkey) == jws._xor_mask(payload, mkey)
    assert ws._encode_frame(ws.OP_BINARY, b"ab", True)[2:6] == \
        bytes(range(7, 11))
    for key in ("dGhlIHNhbXBsZSBub25jZQ==", "x", ""):
        assert ws._accept_key(key) == jws._accept_key(key)
    assert ws._accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="  # RFC 6455's example
    # the client's upgrade request under the pinned key, and the residue
    reqs = []
    for mod in (ws, jws):
        a, b = socket.socketpair()
        b.settimeout(5)
        box = {}

        def serve(b=b, box=box):
            head = b""
            while b"\r\n\r\n" not in head:
                head += b.recv(4096)
            box["req"] = head
            key = [ln.split(b":", 1)[1].strip() for ln in head.split(b"\r\n")
                   if ln.lower().startswith(b"sec-websocket-key")][0]
            b.sendall(b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: "
                      b"websocket\r\nConnection: Upgrade\r\n"
                      b"Sec-WebSocket-Accept: "
                      + ws._accept_key(key.decode()).encode()
                      + b"\r\n\r\nresidue")

        t = threading.Thread(target=serve)
        t.start()
        assert mod.client_handshake(a, "h:1") == b"residue"
        t.join(5)
        reqs.append(box["req"])
        a.close()
        b.close()
    assert reqs[0] == reqs[1]


@pytest.mark.parametrize("writer,reader", [(ws, jws), (jws, ws)])
def test_ws_socket_cross_package(writer, reader):
    a, b = socket.socketpair()
    try:
        client = writer.WSSocket(a, mask_outgoing=True)
        server = reader.WSSocket(b, mask_outgoing=False)
        client.sendall(b"hello world")
        assert server.recv() == b"hello world"
        server.sendall(b"x" * 70000)  # 64-bit length header
        assert client.recv() == b"x" * 70000
        server.sendall(b"y" * 1000)  # 16-bit length header
        assert client.recv() == b"y" * 1000
        # a ping is answered with a pong and consumed
        a.sendall(writer._encode_frame(writer.OP_PING, b"p", True))
        a.sendall(writer._encode_frame(writer.OP_BINARY, b"data", True))
        assert server.recv() == b"data"
        assert a.recv(64)[0] & 0x0F == reader.OP_PONG
        a.sendall(writer._encode_frame(writer.OP_CLOSE, b"", True))
        assert server.recv() == b""
    finally:
        a.close()
        b.close()


def test_ws_residue_timeout_oversize_and_plain_http():
    # a frame pipelined behind the upgrade request is not lost
    a, b = socket.socketpair()
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    a.sendall(("GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n\r\n"
               ).encode() + jws._encode_frame(jws.OP_BINARY, b"piped", True))
    _headers, residue = ws.server_handshake(b)
    assert ws.WSSocket(b, mask_outgoing=False, residue=residue).recv() == \
        b"piped"
    a.close()
    b.close()
    # a timeout mid-header keeps the stream position
    a, b = socket.socketpair()
    sock = ws.WSSocket(b, mask_outgoing=False)
    sock.settimeout(0.05)
    frame = ws._encode_frame(ws.OP_BINARY, b"z" * 300, True)
    a.sendall(frame[:3])
    with pytest.raises(TimeoutError):
        sock.recv()
    a.sendall(frame[3:])
    assert sock.recv() == b"z" * 300
    # a frame over MAX_FRAME_SIZE closes, nothing buffered
    a.sendall(bytes([0x82, 127]) + (1 << 30).to_bytes(8, "big"))
    assert sock.recv() == b""
    a.close()
    b.close()
    # plain HTTP gets a 400 and a ValueError
    a, b = socket.socketpair()
    a.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
    with pytest.raises(ValueError):
        ws.server_handshake(b)
    assert b"400" in a.recv(256)
    a.close()
    b.close()


def session_datagrams(mod):
    """The datagrams a session emits for a fixed script: a send over two
    windows' worth of segments, acks of part of it, out-of-order data,
    a duplicate-ack run and the FIN."""
    out = []
    s = mod.KCPSession(77, out.append, ("127.0.0.1", 9))
    s.send_bytes(bytes(range(256)) * 20)  # 5 segments
    s.send_bytes(b"tail")
    s.input(mod.CMD_ACK, 0, 2, 64, b"")  # acks seq 0-1
    for seq in (1, 0, 3):
        s.input(mod.CMD_DATA, seq, 2, 64, f"d{seq}".encode())
    s.update()  # the ack due
    for _ in range(3):  # three duplicate acks: a fast retransmit of seq 2
        s.input(mod.CMD_ACK, 0, 2, 64, b"")
    s.input(mod.CMD_ACK, 0, 6, 64, b"")
    s.shutdown(socket.SHUT_RDWR)
    s.update()
    chunks = []
    s.settimeout(0.5)
    while len(b"".join(chunks)) < 4:
        chunks.append(s.recv())
    return out, b"".join(chunks)


def test_kcp_datagrams_equal_jax():
    got, got_rx = session_datagrams(kcp)
    want, want_rx = session_datagrams(jkcp)
    assert got == want
    assert got_rx == want_rx == b"d0d1"
    assert kcp.HDR_SIZE == jkcp.HDR_SIZE == 17
    conv, cmd, seq, ack, wnd, ln = kcp._HDR.unpack_from(got[0])
    assert (conv, cmd, seq, ln) == (77, kcp.CMD_DATA, 0, kcp.MSS)
    assert any(kcp._HDR.unpack_from(d)[1] == kcp.CMD_FIN for d in got)


def lossy(sendfn, rng, p_drop):
    def send(pkt):
        if rng.random() >= p_drop:
            sendfn(pkt)

    return send


@pytest.mark.parametrize("server_mod,client_mod", [(kcp, jkcp), (jkcp, kcp)])
def test_kcp_echo_and_lossy_bulk_across_packages(server_mod, client_mod):
    blob = bytes(random.Random(7).getrandbits(8) for _ in range(120_000))
    received, done = [], threading.Event()

    def on_conn(sess, peer):
        pc = PacketConnection(sess)
        pkt = pc.recv_packet()
        pc.send_packet(Packet(bytearray(pkt.payload)))
        pc.flush()
        sess._sendfn = lossy(sess._sendfn, random.Random(1), 0.3)
        total = 0
        while total < len(blob):
            chunk = sess.recv()
            if not chunk:
                break
            received.append(chunk)
            total += len(chunk)
        sess.sendall(b"ACKED")
        done.set()

    srv = server_mod.serve_kcp(("127.0.0.1", 0), on_conn)
    try:
        client = client_mod.connect_kcp(srv.addr)
        client.settimeout(30.0)
        pc = PacketConnection(client)
        out = Packet()
        out.append_varstr("kcp says hi")
        pc.send_packet(out)
        pc.flush()
        assert pc.recv_packet().read_varstr() == "kcp says hi"
        client._sendfn = lossy(client._sendfn, random.Random(2), 0.3)
        client.sendall(blob)
        assert done.wait(30), "the server never got the whole blob"
        assert b"".join(received) == blob
        assert client.recv() == b"ACKED"
        client.close()
    finally:
        srv.close()


@pytest.mark.parametrize("mod", [kcp, jkcp])
def test_kcp_out_of_order_and_fin(mod):
    """Out-of-order segments reassemble; a FIN from the other package's
    client ends the port's session (and back) after all its data."""
    sess = kcp.KCPSession(1, lambda pkt: None, ("127.0.0.1", 9))
    chunks = [b"AA", b"BB", b"CC", b"DD"]
    for i in (2, 0, 3, 1):
        sess.input(kcp.CMD_DATA, i, 0, 64, chunks[i])
    sess.settimeout(1.0)
    out = b""
    while len(out) < 8:
        out += sess.recv()
    assert out == b"AABBCCDD"
    server_mod = jkcp if mod is kcp else kcp
    sessions, ready = [], threading.Event()

    def on_conn(s, peer):
        sessions.append(s)
        ready.set()

    srv = server_mod.serve_kcp(("127.0.0.1", 0), on_conn)
    try:
        client = mod.connect_kcp(srv.addr)
        blob = bytes(range(256)) * 600  # over SND_WND segments' worth
        client.sendall(b"x" + blob)
        client.close()  # FIN after the queued data drains
        assert ready.wait(5)
        s = sessions[0]
        s.settimeout(20.0)
        got = b""
        while True:
            c = s.recv()
            if not c:
                break
            got += c
        assert got == b"x" + blob
        assert s.recv() == b""  # EOF latches
    finally:
        srv.close()


@pytest.fixture(scope="module")
def tls_cert(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "t.crt"), str(d / "t.key")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", key, "-out", cert, "-days", "1",
                    "-subj", "/CN=127.0.0.1"], check=True,
                   capture_output=True, timeout=60)
    return cert, key


@pytest.mark.parametrize("client_pkg", ["goworld_tpu_torch", "goworld_tpu"])
def test_websocket_over_tls_through_the_port_gate(client_pkg, tls_cert,
                                                  tmp_path):
    import importlib

    cert, key = tls_cert
    parts = start_cluster(package("goworld_tpu_torch"), tmp_path,
                          gate_extra=f"tls_cert = {cert}\ntls_key = {key}")
    try:
        client = importlib.import_module(f"{client_pkg}.client")
        scene_flow(client, parts[1], parts[2], transport="ws", tls=True)
    finally:
        stop_cluster(*parts)
