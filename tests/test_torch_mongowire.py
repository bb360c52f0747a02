"""The port's mongo family (goworld_tpu_torch.ext.db: ``bson``,
``minimongo``, ``mongowire``; the ``mongodb`` storage and kvdb backends)
against the JAX package's.

BSON: seeded documents encode to the same bytes in both codecs and
decode back alike; both reject the same garbage.  OP_MSG: each package's
``MongoWireClient`` against each package's ``MiniMongoServer`` runs one
script (CRUD, a duplicate ``_id``, a severed socket, an unknown command)
with the same results.  The backends over the wire leave the same
documents in the server's store."""

import socket

import numpy as np
import pytest

from goworld_tpu.ext.db import bson as jbson
from goworld_tpu.ext.db import mongowire as jmw
from goworld_tpu.kvdb import backends as jkv
from goworld_tpu.storage import backends as jst
from goworld_tpu_torch.ext.db import bson, mongowire as mw
from goworld_tpu_torch.kvdb import backends as kv
from goworld_tpu_torch.storage import backends as st
from torch_threads import one_intra_op_thread  # noqa: F401

SEED = 20260


@pytest.fixture(scope="module")
def servers():
    """One MiniMongoServer of each package for the whole module."""
    srv = {"port": mw.MiniMongoServer(), "jax": jmw.MiniMongoServer()}
    yield srv
    for s in srv.values():
        s.close()


def seeded_value(rng, depth):
    kind = int(rng.integers(0, 9 if depth < 3 else 7))
    if kind == 0:  # around the int32 / int64 edges
        edge = int(rng.choice([0, (1 << 31) - 1, 1 << 31, -(1 << 31),
                               -(1 << 31) - 1, (1 << 63) - 1, -(1 << 63)]))
        return edge if edge in ((1 << 63) - 1, -(1 << 63)) else (
            edge + int(rng.integers(-2, 3)))
    if kind == 1:
        return int(rng.integers(-(1 << 62), 1 << 62))
    if kind == 2:
        return float(rng.choice([rng.standard_normal() * 1e6, 0.0, -0.0,
                                 float("inf"), -float("inf"), 5e-324]))
    if kind == 3:
        n = int(rng.integers(0, 12))
        return "".join(chr(int(c)) for c in rng.integers(0x20, 0x3000, n)
                       if not 0xD800 <= c < 0xE000)
    if kind == 4:
        return rng.bytes(int(rng.integers(0, 40)))
    if kind == 5:
        return bool(rng.integers(0, 2))
    if kind == 6:
        return None
    if kind == 7:
        return [seeded_value(rng, depth + 1)
                for _ in range(int(rng.integers(0, 5)))]
    return seeded_doc(rng, depth + 1)


def seeded_doc(rng, depth=0):
    return {f"k{i}_{int(rng.integers(0, 1000))}": seeded_value(rng, depth)
            for i in range(int(rng.integers(0, 7)))}


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the type is the result
        return ("raise", type(e).__name__)


def test_bson_bytes_equal_jax_over_seeded_documents():
    rng = np.random.default_rng(SEED)
    for _ in range(300):
        doc = seeded_doc(rng)
        enc = bson.encode(doc)
        assert enc == jbson.encode(doc)
        assert repr(bson.decode(enc)) == repr(jbson.decode(enc))
        assert repr(bson.decode(enc)) == repr(doc)
    # the width rule: int32 when it fits, int64 past it, beyond raises
    for v, tag in ((1, 0x10), ((1 << 31) - 1, 0x10), (1 << 31, 0x12),
                   (-(1 << 31) - 1, 0x12), ((1 << 63) - 1, 0x12)):
        assert bson.encode({"v": v})[4] == tag
    for v in (1 << 63, -(1 << 63) - 1, 1 << 64):
        assert outcome(bson.encode, {"v": v}) == \
            outcome(jbson.encode, {"v": v}) == ("raise", "BSONError")


def test_bson_rejects_the_same_garbage():
    good = bson.encode({"a": 1, "s": "x", "d": {"b": [1.5, None]}})
    objectid = b"\x14\x00\x00\x00\x07k\x00" + b"\x00" * 12 + b"\x00"
    bad = [b"", b"\x05\x00\x00\x00", good + b"x", good[:-1], objectid,
           b"\x05\x00\x00\x00\x01", b"\xff\xff\xff\x7f\x00"]
    rng = np.random.default_rng(SEED + 1)
    for _ in range(200):  # flipped bytes and cuts of a good document
        b = bytearray(good)
        for i in rng.integers(0, len(b), int(rng.integers(1, 4))):
            b[i] = int(rng.integers(0, 256))
        bad.append(bytes(b[:int(rng.integers(1, len(b) + 1))]))
    for b in bad:
        got, want = outcome(bson.decode, b), outcome(jbson.decode, b)
        assert repr(got) == repr(want), b
    for b in bad[:7]:  # malformed input raises, never decodes
        assert outcome(bson.decode, b)[0] == "raise"
    assert outcome(bson.decode, objectid) == ("raise", "BSONError")
    for doc in ({1: "non-str key"}, {"o": object()}, {"k\x00": 1}):
        assert outcome(bson.encode, doc) == outcome(jbson.encode, doc)
        assert outcome(bson.encode, doc)[0] == "raise"


def wire_script(client_mod, port, db):
    """One script through ``client_mod.MongoWireClient``; the results, with
    errors as their type's name."""
    out = []
    c = client_mod.MongoWireClient(port=port)
    out.append(c.server_info.get("maxWireVersion", 0) >= 13)
    col = c[db]["things"]
    col.insert_one({"_id": "a", "v": 1, "blob": b"\x01\x02", "f": 0.5})
    out.append(outcome(col.insert_one, {"_id": "a", "v": 9}))
    col.replace_one({"_id": "b"}, {"_id": "b", "v": 2, "n": None},
                    upsert=True)
    col.update_one({"_id": "b"}, {"$inc": {"v": 5}, "$set": {"w": [1, "x"]}})
    col.insert_one({"_id": "c", "v": 1 << 40})
    out.append(col.find_one({"_id": "a"}))
    out.append(col.find_one({"_id": "zz"}))
    out.append(col.count_documents({}))
    out.append(col.count_documents({"_id": "a"}, limit=1))
    out.append(list(col.find({}, {"_id": 1}).sort("_id", 1)))
    out.append(list(col.find({}).sort("_id", -1).limit(2)))
    out.append(list(col.find({"_id": {"$gte": "a", "$lt": "c"}})
                    .sort("_id", 1)))
    # a severed socket: a read reconnects transparently, a write raises
    # and the next call reconnects
    c._sock.close()
    out.append(col.find_one({"_id": "b"}))
    c._sock.close()
    try:
        col.insert_one({"_id": "y", "v": 2})
        out.append("no error")
    except (ConnectionError, OSError):
        out.append("connection error")
    col.insert_one({"_id": "y", "v": 2})
    out.append(col.find_one({"_id": "y"}))
    # an unknown command is an error reply, not a disconnect
    try:
        c._command("admin", {"frobnicate": 1})
        out.append("no error")
    except client_mod.MongoWireError as e:
        out.append(("MongoWireError", "no such command" in str(e)))
    out.append(c._command("admin", {"ping": 1})["ok"])
    col.delete_one({"_id": "a"})
    out.append(col.count_documents({}))
    col.delete_many({})
    out.append(col.count_documents({}))
    c.close()
    return out


def test_op_msg_interop_both_ways(servers):
    runs = {}
    for cname, cmod in (("port", mw), ("jax", jmw)):
        for sname in ("port", "jax"):
            runs[cname, sname] = wire_script(
                cmod, servers[sname].port, f"interop_{cname}_{sname}")
    want = runs["jax", "jax"]
    for key, got in runs.items():
        assert repr(got) == repr(want), key
    assert want[1] == ("raise", "DuplicateKeyError")
    assert want[2] == {"_id": "a", "v": 1, "blob": b"\x01\x02", "f": 0.5}
    assert want[10] == "connection error"
    assert want[12] == ("MongoWireError", True) and want[13]


def storage_script(be):
    out = [be.read("Avatar", "e1"), be.exists("Avatar", "e1")]
    be.write("Avatar", "e1", {"name": "bob", "lv": 3, "big": 1 << 40,
                              "inv": [1, {"id": "sword"}], "raw": b"\x00"})
    be.write("Avatar", "e2", {"name": "alice"})
    be.write("Monster", "m1", {"hp": 50.5})
    be.write("Avatar", "e2", {"name": "alice2"})
    out += [be.read("Avatar", "e1"), be.exists("Avatar", "e1"),
            be.list_entity_ids("Avatar"), be.list_entity_ids("Nothing")]
    return out


def kvdb_script(be):
    out = [be.get("k")]
    for k, v in (("k", "v"), ("b", "B"), ("a", "A"), ("ab", "AB"),
                 ("k", "v2"), ("unié", "中文")):
        be.put(k, v)
    out += [be.get("k"), be.get_or_put("k", "x"), be.get_or_put("f", "1"),
            be.find("a", "c"), be.find("", "")]
    return out


def documents(server, db):
    store = server.store[db]
    return {name: sorted(store[name].find({}), key=lambda d: d["_id"])
            for name in ("Avatar", "Monster", "kvdb")}


def test_backends_over_the_wire_leave_equal_documents(servers):
    for sname, srv in servers.items():
        results = {}
        for pkg, smod, kmod in (("port", st, kv), ("jax", jst, jkv)):
            db = f"backends_{pkg}_{sname}"
            be = smod.new_entity_storage("mongodb", port=srv.port, db=db)
            s = storage_script(be)
            be.close()
            be = kmod.new_kvdb_backend("mongodb", port=srv.port, db=db)
            k = kvdb_script(be)
            be.close()
            results[pkg] = (s, k, documents(srv, db))
        assert repr(results["port"]) == repr(results["jax"]), sname
        s, k, docs = results["port"]
        assert s[2]["big"] == 1 << 40 and s[4] == ["e1", "e2"]
        assert k[-2] == [("a", "A"), ("ab", "AB"), ("b", "B")]
        assert docs["Avatar"][1] == {"_id": "e2", "data": {"name": "alice2"}}
    # one package writes, the other reads
    srv = servers["port"]
    be = st.MongoEntityStorage(port=srv.port, db="backends_port_port")
    other = jst.MongoEntityStorage(port=srv.port, db="backends_port_port")
    assert other.read("Avatar", "e1") == be.read("Avatar", "e1")
    be.close()
    other.close()


def test_duplicate_id_and_unreachable_server_raise(servers):
    from goworld_tpu_torch.ext.db.minimongo import (DuplicateKeyError,
                                                    MiniMongoClient)

    col = MiniMongoClient()["db"]["c"]
    col.insert_one({"_id": "x", "v": 1})
    with pytest.raises(DuplicateKeyError):
        col.insert_one({"_id": "x", "v": 2})
    assert col.find_one({"_id": "x"})["v"] == 1
    c = mw.MongoWireClient(port=servers["jax"].port)
    c["dup"]["c"].insert_one({"_id": "x"})
    with pytest.raises(DuplicateKeyError):
        c["dup"]["c"].insert_one({"_id": "x"})
    c.close()
    # a backend that cannot connect raises: nothing stands in for it
    probe = socket.socket()  # a port nothing listens on
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    for make in (st.MongoEntityStorage, kv.MongoKVDB):
        with pytest.raises(OSError):
            make(port=port)
