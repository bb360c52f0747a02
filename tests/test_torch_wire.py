"""The port's wire (goworld_tpu_torch: netutil, proto, the gate's filter
tree, lbc, config) against the JAX package's on the same inputs: packets
and their msgpack half byte-equal and read across the packages, every
compressor, the msgpackers, the frame parser on split and batched frames,
one compressed TCP round trip, the message types, the filter tree, the
load reporter and the inis of the JAX package's tests and examples."""

import dataclasses
import glob
import os
import random
import shutil
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

import goworld_tpu.config as JC
import goworld_tpu.netutil as JN
import goworld_tpu.netutil.compress as JZ
import goworld_tpu.netutil.msgpacker as JM
import goworld_tpu.proto.msgtypes as JT
import goworld_tpu_torch.config as PC
import goworld_tpu_torch.netutil as PN
import goworld_tpu_torch.netutil.compress as PZ
import goworld_tpu_torch.netutil.msgpacker as PM
import goworld_tpu_torch.proto.msgtypes as PT
from goworld_tpu.netutil.packet import pack_args as j_pack_args
from goworld_tpu_torch.netutil.packet import pack_args as p_pack_args
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": PN, "jax": JN}
Z_SO = "libgwlz.so"
DATA = [None, True, 7, -3, 2 ** 40, 1.5, "héllo", b"\x00\xffraw",
        [1, "two", [3.0]], {"a": 1, "b": [1, 2], "c": {"d": None}},
        {"p": ["x", 1], "o": 2, "v": {"k": "v"}}, (1, 2), list(range(300))]


def write_packet(Packet, rng):
    p = Packet.for_msgtype(PT.MT_CALL_ENTITY_METHOD)
    p.append_u8(rng.randrange(256))
    p.append_u16(rng.randrange(1 << 16))
    p.append_u32(rng.randrange(1 << 32))
    p.append_u64(rng.randrange(1 << 64))
    p.append_f32(rng.uniform(-1e6, 1e6))
    p.append_bool(rng.random() < 0.5)
    p.append_entity_id("".join(rng.choice("ABCxyz019_-") for _ in range(16)))
    p.append_varstr("método" * rng.randrange(4))
    p.append_varbytes(bytes(rng.randrange(256) for _ in range(rng.randrange(40))))
    p.append_data(DATA[rng.randrange(len(DATA))])
    p.append_args(tuple(DATA[: rng.randrange(len(DATA))]))
    return p


def read_packet(p):
    return (p.read_u16(), p.read_u8(), p.read_u16(), p.read_u32(),
            p.read_u64(), p.read_f32(), p.read_bool(), p.read_entity_id(),
            p.read_varstr(), p.read_varbytes(), p.read_data(), p.read_args(),
            p.remaining())


@pytest.mark.parametrize("seed", range(4))
def test_packet_bytes_and_reads_cross(seed):
    bufs = {k: bytes(write_packet(n.Packet, random.Random(seed)).buf)
            for k, n in PACKAGES.items()}
    assert bufs["port"] == bufs["jax"]
    for writer in PACKAGES:
        reads = [read_packet(n.Packet(bytearray(bufs[writer])))
                 for n in PACKAGES.values()]
        assert reads[0] == reads[1] and reads[0][-1] == 0
    args = tuple(DATA)
    assert p_pack_args(args) == j_pack_args(args)


def test_msgpackers_equal():
    for name in ("MessagePackMsgPacker", "JSONMsgPacker", "PickleMsgPacker"):
        p, j = getattr(PM, name)(), getattr(JM, name)()
        for obj in DATA:
            if name == "JSONMsgPacker" and isinstance(obj, bytes):
                continue
            raw = p.pack(obj)
            assert raw == j.pack(obj), (name, obj)
            assert p.unpack(raw) == j.unpack(raw)
    assert PM.default_packer.name == JM.default_packer.name == "messagepack"


def payloads(seed):
    rng = np.random.default_rng(seed)
    out = [b"", b"x", bytes(range(256)) * 9,
           rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
           b"abcabcabd" * 700,
           np.repeat(rng.integers(0, 4, 800, dtype=np.uint8), 7).tobytes()]
    return out


@pytest.mark.parametrize("fmt", ["none", "flate", "lzma", "lzw", "gwlz"])
def test_compressors_cross(fmt):
    p, j = PZ.new_compressor(fmt), JZ.new_compressor(fmt)
    assert p.name == j.name == fmt  # gwlz: the shared native library loaded
    for data in payloads(3):
        zp, zj = p.compress(data), j.compress(data)
        assert zp == zj
        assert j.decompress(zp) == data and p.decompress(zj) == data
    if fmt == "gwlz":
        assert PZ._SO_PATH == JZ._SO_PATH  # one library, each its own loader


@pytest.mark.parametrize("start", ["unbuilt", "half-written"])
def test_gwlz_first_use_in_concurrent_processes(tmp_path, start):
    """Processes that reach the codec together on a checkout where the
    library is not built yet (a cluster's first start), or is a file some
    process has only begun to write: each loads gwlz -- none falls back to
    flate, which would leave the peers on different codecs -- and no
    build directory is left behind."""
    nat = tmp_path / "native"
    nat.mkdir()
    for name in ("Makefile", "gwlz.cpp"):
        shutil.copy(os.path.join(ROOT, "native", name), nat / name)
    if start == "half-written":
        (nat / Z_SO).write_bytes(b"\x7fELF" + bytes(60))
    code = ("import goworld_tpu_torch.netutil.compress as Z\n"
            f"Z._NATIVE_DIR = {str(nat)!r}\n"
            f"Z._SO_PATH = {str(nat / Z_SO)!r}\n"
            "print(Z.new_compressor('gwlz').name)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("GW_SANITIZED_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [o.strip() for o, _ in outs] == [b"gwlz"] * 4, outs
    assert sorted(os.listdir(nat)) == ["Makefile", "gwlz.cpp", Z_SO]


def frames(compressor, seed, threshold=PN.COMPRESS_THRESHOLD):
    """A byte stream of framed payloads, as PacketConnection.flush
    writes it."""
    out, want = bytearray(), []
    for data in payloads(seed):
        body = struct.pack("<H", 7) + data
        want.append(body)
        z = compressor.compress(body) if len(body) >= threshold else None
        if z is not None and len(z) < len(body):
            out += struct.pack("<I", len(z) | 0x80000000) + z
        else:
            out += struct.pack("<I", len(body)) + body
    return bytes(out), want


@pytest.mark.parametrize("split", ["whole", "bytes", "random"])
def test_frame_parser_split_and_batched(split):
    stream, want = frames(JZ.new_compressor("gwlz"), 5)
    rng = random.Random(9)
    if split == "whole":
        cuts = [stream]
    elif split == "bytes":
        cuts = [stream[i:i + 1] for i in range(len(stream))]
    else:
        cuts, i = [], 0
        while i < len(stream):
            n = rng.randrange(1, 900)
            cuts.append(stream[i:i + n])
            i += n
    for n in PACKAGES.values():
        parser = n.FrameParser(n.new_compressor("gwlz"))
        got = [bytes(p.buf) for c in cuts for p in parser.feed(c)]
        assert got == want


def test_frame_parser_rejects_oversized_and_corrupt():
    for n in PACKAGES.values():
        with pytest.raises(ValueError, match="oversized"):
            n.FrameParser().feed(struct.pack("<I", PN.MAX_PACKET_SIZE + 1))
        with pytest.raises(ValueError, match="corrupt"):
            n.FrameParser(n.new_compressor("flate")).feed(
                struct.pack("<I", 4 | 0x80000000) + b"junk")


def test_tcp_round_trip_port_client_jax_server():
    """The port's connect_tcp + PacketConnection against the JAX
    serve_tcp + PacketConnection echo, gwlz-compressed both ways."""
    done = threading.Event()

    def echo(sock, _peer):
        pc = JN.PacketConnection(sock, compression="gwlz")
        while True:
            p = pc.recv_packet()
            if p is None:
                break
            pc.send_packet(JN.Packet(bytearray(p.buf)))
            pc.flush()
        done.set()

    ls = JN.serve_tcp(("127.0.0.1", 0), echo)
    try:
        sock = PN.connect_tcp(ls.getsockname(), timeout=10.0)
        sock.settimeout(10.0)
        pc = PN.PacketConnection(sock, compression="gwlz")
        want = [bytes(write_packet(PN.Packet, random.Random(s)).buf)
                for s in range(6)] + [b"\x07\x00" + b"z" * 20000]
        for b in want:
            pc.send_packet(PN.Packet(bytearray(b)))
        assert pc.flush() < sum(len(b) + 4 for b in want)  # compressed
        got = [bytes(pc.recv_packet().buf) for _ in want]
        assert got == want
        pc.close()
        assert done.wait(10.0)
    finally:
        ls.close()


def test_msgtypes_equal():
    def table(mod):
        return {k: v for k, v in vars(mod).items()
                if k.isupper() and isinstance(v, int)}

    assert table(PT) == table(JT) and len(table(PT)) > 50
    for t in range(0, 2100, 7):
        assert PT.is_redirect_to_client(t) == JT.is_redirect_to_client(t)


def test_filter_tree_matches_jax():
    from goworld_tpu.components.gate.filtertree import FilterTree as JF
    from goworld_tpu_torch.components.gate.filtertree import FilterTree as PF

    rng = random.Random(3)
    trees = (PF(), JF())
    proxies = [object() for _ in range(60)]
    values = ["", "a", "b", "b2", "10", "9", "z"]
    for step in range(400):
        proxy = rng.choice(proxies)
        if rng.random() < 0.25:
            assert trees[0].remove(proxy) == trees[1].remove(proxy)
        else:
            v = rng.choice(values)
            for t in trees:
                t.insert(proxy, v)
        assert len(trees[0]) == len(trees[1])
        if step % 20 == 0:
            for op in (PT.FILTER_OP_EQ, PT.FILTER_OP_NE, PT.FILTER_OP_LT,
                       PT.FILTER_OP_LTE, PT.FILTER_OP_GT, PT.FILTER_OP_GTE):
                v = rng.choice(values)
                got = [id(p) for p in trees[0].visit(op, v)]
                assert got == [id(p) for p in trees[1].visit(op, v)]
    with pytest.raises(ValueError):
        list(trees[0].visit(99, "a"))


def test_load_reporter_matches_jax(monkeypatch):
    import goworld_tpu.components.game.lbc as JL
    import goworld_tpu_torch.components.game.lbc as PL

    samples = {}
    for name, mod in (("port", PL), ("jax", JL)):
        clock = iter(np.arange(0.0, 10.0, 0.5))
        cpu = iter(np.cumsum([0.1, 0.3, 0.0, 0.5, 0.2] * 4))
        monkeypatch.setattr(mod.time, "monotonic", lambda: float(next(clock)))
        monkeypatch.setattr(mod.os, "times", lambda: os.times_result(
            (float(next(cpu)), 0.0, 0.0, 0.0, 0.0)))
        r = mod.LoadReporter()
        samples[name] = [r.sample() for _ in range(8)]
        monkeypatch.undo()
    assert samples["port"] == samples["jax"]
    assert max(samples["port"]) > 0


def inis():
    out = {"test_cluster_e2e": None}
    src = open(os.path.join(ROOT, "tests", "test_cluster_e2e.py")).read()
    out["test_cluster_e2e"] = src.split('CONFIG = """', 1)[1].split('"""')[0]
    for path in sorted(glob.glob(os.path.join(ROOT, "examples", "*",
                                              "goworld.ini"))):
        with open(path) as f:
            out[os.path.relpath(path, ROOT)] = f.read()
    return out


# the port's own fields: (its name, the JAX name or None)
PORT_GAME_KEYS = {"aoi_device": None,
                  "aoi_cuda_min_capacity": "aoi_tpu_min_capacity"}


@pytest.mark.parametrize("name", sorted(inis()))
def test_config_loads_like_jax(name):
    text = inis()[name]
    p, j = PC.loads(text), JC.loads(text)
    for section in ("dispatchers", "gates"):
        got = {k: dataclasses.asdict(v) for k, v in getattr(p, section).items()}
        assert got == {k: dataclasses.asdict(v)
                       for k, v in getattr(j, section).items()}
    for part in ("storage", "kvdb"):
        assert dataclasses.asdict(getattr(p, part)) == \
            dataclasses.asdict(getattr(j, part))
    assert p.games.keys() == j.games.keys() and p.games
    for gid, pg in p.games.items():
        got, want = dataclasses.asdict(pg), dataclasses.asdict(j.games[gid])
        assert got.pop("aoi_device") == "cuda"
        assert got.pop("aoi_cuda_min_capacity") == \
            want.pop("aoi_tpu_min_capacity")
        assert got == want
    assert p.dispatcher_addrs() == j.dispatcher_addrs()


def test_config_port_defaults_and_refusals():
    g = PC.loads("[game1]\n").games[1]
    assert (g.aoi_backend, g.aoi_device) == ("cuda", "cuda")
    assert JC.loads("[game1]\n").games[1].aoi_backend == "cpu"
    g = PC.loads("[game_common]\naoi_backend = cpp\naoi_device = cpu\n"
                 "aoi_cuda_min_capacity = 1024\n[game1]\n").games[1]
    assert (g.aoi_backend, g.aoi_device, g.aoi_cuda_min_capacity) == \
        ("cpp", "cpu", 1024)
    with pytest.raises(ValueError, match="'tpu' is not in the port.*'cuda'"):
        PC.loads("[game_common]\naoi_backend = tpu\n")
    with pytest.raises(ValueError, match="'aoi_tpu_min_capacity'.*"
                       "'aoi_cuda_min_capacity' in the port"):
        PC.loads("[game1]\naoi_tpu_min_capacity = 4096\n")
    with pytest.raises(ValueError, match="unknown AOI backend"):
        PC.loads("[game1]\naoi_backend = gpu\n")
    for text in ("[bogus]\n", "[game1]\nnot_a_key = 1\n"):
        with pytest.raises(ValueError, match="unknown config"):
            PC.loads(text)
        with pytest.raises(ValueError, match="unknown config"):
            JC.loads(text)
