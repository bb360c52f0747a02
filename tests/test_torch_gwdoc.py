"""The port's document wrapper (goworld_tpu_torch.ext.db.gwdoc: ``match``,
``apply_update``, ``DocStore``, ``GWDoc``) against the JAX package's.

Seeded documents, queries and updates give the same answers (or the same
error) through both packages' operators; one script of ``DocStore``
calls gives the same results and leaves a file each package reads back;
``GWDoc`` delivers its callbacks through ``post`` in submission order."""

import copy
import time

import numpy as np
import pytest

from goworld_tpu.ext.db import gwdoc as jgd
from goworld_tpu_torch.ext.db import gwdoc as gd
from test_torch_mongowire import outcome
from torch_threads import one_intra_op_thread  # noqa: F401

FIELDS = ("name", "lv", "tags", "eq.weapon.dmg", "eq", "missing", "_id")
VALUES = ("bob", "alice", 3, 7, 12, 2.5, None, True, "a", ["a", "b"], [1])


def seeded_doc(rng, i):
    doc = {"_id": f"d{i}"}
    if rng.random() < 0.8:
        doc["name"] = str(rng.choice(["bob", "alice", "carl"]))
    if rng.random() < 0.8:
        doc["lv"] = int(rng.integers(0, 10))
    if rng.random() < 0.5:
        doc["tags"] = [str(t) for t in rng.choice(["a", "b", "c"],
                                                  int(rng.integers(0, 3)))]
    if rng.random() < 0.5:
        doc["eq"] = {"weapon": {"dmg": int(rng.integers(5, 15))}}
    return doc


def seeded_cond(rng):
    v = VALUES[int(rng.integers(0, len(VALUES)))]
    op = str(rng.choice(["eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$in",
                         "$nin", "$exists", "$regex"]))
    if op == "eq":
        return v
    if op in ("$in", "$nin"):
        return {op: list(rng.choice(np.array(VALUES, dtype=object), 2))}
    if op == "$exists":
        return {op: bool(rng.integers(0, 2))}
    return {op: v}


def seeded_query(rng, depth=0):
    q = {}
    for _ in range(int(rng.integers(0, 3))):
        q[str(rng.choice(FIELDS))] = seeded_cond(rng)
    if depth == 0 and rng.random() < 0.3:
        q[str(rng.choice(["$and", "$or"]))] = [
            seeded_query(rng, 1) for _ in range(int(rng.integers(1, 3)))]
    return q


def seeded_update(rng):
    if rng.random() < 0.15:  # a full replacement
        return {"x": int(rng.integers(0, 5)), "name": "r"}
    u = {}
    for _ in range(int(rng.integers(1, 4))):
        op = str(rng.choice(["$set", "$unset", "$inc", "$push"]))
        path = str(rng.choice(["lv", "name", "eq.weapon.dmg", "b.c",
                               "tags", "new"]))
        val = (int(rng.integers(-3, 4)) if op == "$inc" else
               VALUES[int(rng.integers(0, len(VALUES)))])
        u.setdefault(op, {})[path] = val
    return u


def test_match_and_apply_update_equal_jax():
    rng = np.random.default_rng(7)
    docs = [seeded_doc(rng, i) for i in range(40)]
    hits = 0
    for _ in range(400):
        q = seeded_query(rng)
        for d in docs:
            got = outcome(gd.match, d, q)
            assert got == outcome(jgd.match, d, q), (d, q)
            hits += got == ("ok", True)
    assert hits > 100
    for _ in range(300):
        d, u = docs[int(rng.integers(0, len(docs)))], seeded_update(rng)
        before = copy.deepcopy(d)
        got = outcome(gd.apply_update, d, u)
        assert repr(got) == repr(outcome(jgd.apply_update, d, u)), (d, u)
        assert d == before  # the input is never touched
    assert gd.apply_update({"_id": "1", "a": 1}, {"x": 9}) == \
        {"_id": "1", "x": 9}
    with pytest.raises(ValueError):
        gd.match({"lv": 1}, {"lv": {"$regex": "x"}})


def docstore_script(mod, path):
    out = []
    db = mod.DocStore(path)
    db.insert("avatars", {"_id": "a1", "name": "bob", "lv": 3})
    db.insert("avatars", {"_id": "a2", "name": "alice", "lv": 9})
    db.insert("monsters", {"_id": "m1", "name": "slime"})
    out.append(outcome(db.insert, "avatars", {"_id": "a1", "v": 2}))
    out.append(db.find_id("avatars", "a1"))
    out += [db.count("avatars"), db.find_one("avatars", {"lv": {"$gt": 5}}),
            db.find("avatars", sort="-lv"), db.find("avatars", limit=1,
                                                    sort="lv")]
    out.append(db.update_id("avatars", "a1", {"$inc": {"lv": 1}}))
    out.append(db.update("avatars", {"lv": {"$gt": 0}},
                         {"$set": {"guild": "g"}}, multi=True))
    out.append(db.update("gear", {"_id": "g1", "owner.name": "z",
                                  "lv": {"$gt": 3}},
                         {"$set": {"slot": 1}}, upsert=True))
    out.append(db.find("gear"))
    out.append(db.upsert_id("avatars", "a3", {"$set": {"name": "carl"}}))
    out.append(db.upsert_id("avatars", "a3", {"$push": {"bag": 1}}))
    out.append(db.remove("avatars", {"guild": "g"}))
    out.append(db.find("avatars"))
    db.ensure_index("monsters", "name")
    db.ensure_index("monsters", "name")
    out.append(db.indexes("monsters"))
    db.close()
    return out


def test_docstore_equal_jax_and_files_cross(tmp_path):
    got = docstore_script(gd, str(tmp_path / "port.sqlite"))
    want = docstore_script(jgd, str(tmp_path / "jax.sqlite"))
    assert got == want
    assert got[0] == ("raise", "DuplicateKeyError")
    assert got[1] == {"_id": "a1", "name": "bob", "lv": 3}
    assert got[-2] == [{"_id": "a3", "name": "carl", "bag": [1]}]
    # persisted: each package reopens the other's file
    for mod, other in ((gd, "jax"), (jgd, "port")):
        db = mod.DocStore(str(tmp_path / f"{other}.sqlite"))
        assert db.find("avatars") == got[-2]
        assert db.find_id("monsters", "m1") == {"_id": "m1", "name": "slime"}
        assert db.indexes("monsters") == ["name"]
        db.close()
    # an in-memory store: a duplicate _id raises and keeps the original
    db = gd.DocStore()
    i = db.insert("c", {"v": 1})
    assert isinstance(i, str) and db.find_id("c", i) == {"_id": i, "v": 1}
    with pytest.raises(gd.DuplicateKeyError):
        db.insert("c", {"_id": i, "v": 2})
    assert db.find_id("c", i)["v"] == 1
    db.close()


def gwdoc_order(mod, path):
    posted, got = [], []
    db = mod.GWDoc(path, post=posted.append)
    db.insert("c", {"_id": "k", "v": 1}, callback=got.append)
    db.insert("c", {"_id": "k", "v": 1},
              callback=lambda r: got.append(type(r).__name__))
    db.update_id("c", "k", {"$inc": {"v": 10}}, callback=got.append)
    db.find_id("c", "k", callback=got.append)
    db.upsert_id("c", "j", {"$set": {"v": 0}}, callback=got.append)
    db.find("c", {"v": {"$gte": 0}}, sort="v", callback=got.append)
    db.count("c", callback=got.append)
    db.remove_id("c", "j", callback=got.append)
    t_end = time.monotonic() + 5
    while time.monotonic() < t_end and len(posted) < 8:
        time.sleep(0.005)
    assert not got  # nothing runs a callback before the logic thread does
    for fn in posted:
        fn()
    db.close()
    return got


def test_gwdoc_callback_order_equal_jax(tmp_path):
    got = gwdoc_order(gd, str(tmp_path / "p.sqlite"))
    assert got == gwdoc_order(jgd, str(tmp_path / "j.sqlite"))
    assert got == ["k", "JobError", 1, {"_id": "k", "v": 11}, 1,
                   [{"_id": "j", "v": 0}, {"_id": "k", "v": 11}], 2, 1]
