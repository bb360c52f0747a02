"""The port's persistence half (goworld_tpu_torch: storage/ and kvdb/
backends and services, ext/db's RESP client, cluster client and
miniredis, GameService.attach_storage / attach_kvdb / attach_checkpoints)
against the JAX package's.

Every backend of the port round-trips (mongodb and mysql over the port's
``MiniMongoServer`` / ``MiniMySQLServer``); each reads the records the
JAX backend of the same name wrote, and the JAX backend reads the port's
(byte for byte where the record is a file, a blob, a row or a
document); one script of calls through both packages' services gives
the same callbacks in the same order; the mongodb and mysql backends of
each package run over the other package's server; a port game (``aoi_backend = cuda``, ``aoi_device = cpu``:
the step's plain version) saves on ``stop`` and loads through the
dispatcher, and its checkpoints give the saved words back."""

import time

import numpy as np
import pytest

from goworld_tpu.ext.db import miniredis as jminiredis
from goworld_tpu.kvdb import backends as jkv
from goworld_tpu.kvdb import service as jkvs
from goworld_tpu.storage import backends as jst
from goworld_tpu.storage import service as jsts
from goworld_tpu.ext.db import mongowire as jmongowire
from goworld_tpu.ext.db import mysqlwire as jmysqlwire
from goworld_tpu_torch.ext.db import dbutil, miniredis, mongowire, mysqlwire
from goworld_tpu_torch.ext.db.resp import RespClient
from goworld_tpu_torch.ext.db.respcluster import key_slot
from goworld_tpu_torch.kvdb import backends as kv
from goworld_tpu_torch.kvdb import service as kvs
from goworld_tpu_torch.storage import backends as st
from goworld_tpu_torch.storage import service as sts
from torch_threads import one_intra_op_thread  # noqa: F401

BACKENDS = ("filesystem", "sqlite", "redis", "redis_cluster", "mongodb",
            "mysql")
RECORDS = [("Avatar", "e1", {"name": "bob", "lv": 3,
                             "inv": [1, 2, {"id": "sword"}],
                             "blob": b"\x00\xff" * 8, "f": 0.25}),
           ("Avatar", "e2", {"name": "alice"}),
           ("Monster", "m1", {"hp": 50})]
PAIRS = [("k", "v"), ("b", "B"), ("a", "A"), ("ab", "AB"), ("k", "v2"),
         ("unié", "中文")]


@pytest.fixture(scope="module")
def servers():
    """The port's miniredis, a 3-node cluster of it, its MiniMongoServer
    and its MiniMySQLServer; both packages' clients talk to them."""
    srv = {"redis": miniredis.MiniRedis(),
           "redis_cluster": miniredis.MiniRedisCluster(3),
           "mongodb": mongowire.MiniMongoServer(),
           "mysql": mysqlwire.MiniMySQLServer()}
    yield srv
    for s in srv.values():
        s.close()


@pytest.fixture(scope="module")
def jax_servers():
    """The JAX package's MiniMongoServer and MiniMySQLServer."""
    srv = {"mongodb": jmongowire.MiniMongoServer(),
           "mysql": jmysqlwire.MiniMySQLServer()}
    yield srv
    for s in srv.values():
        s.close()


DB_INDEX = iter(range(1, 1000))


def kwargs(backend, servers, tmp_path):
    """One fresh namespace of ``backend``: a directory, a redis db index,
    a mongo database, or the cluster or the mysql server emptied (each
    has one db)."""
    if backend in ("filesystem", "sqlite"):
        return {"directory": str(tmp_path)}
    if backend == "redis":
        host, port = servers["redis"].addr
        return {"host": host, "port": port, "db": next(DB_INDEX)}
    if backend == "mongodb":
        return {"port": servers["mongodb"].port, "db": next(DB_INDEX)}
    if backend == "mysql":
        srv = servers["mysql"]._srv
        with srv.db_lock:
            for table in ("entities", "kv"):
                srv.db.execute(f"DROP TABLE IF EXISTS {table}")
        return {"port": servers["mysql"].port}
    for addr in servers["redis_cluster"].addrs:
        c = RespClient(*addr)
        c.command("FLUSHDB")
        c.close()
    return {"addrs": servers["redis_cluster"].addrs}


def exercise_storage(be):
    assert be.read("Avatar", "e1") is None
    assert not be.exists("Avatar", "e1")
    for t, eid, data in RECORDS:
        be.write(t, eid, data)
    assert be.read("Avatar", "e1") == RECORDS[0][2]
    assert be.exists("Avatar", "e1")
    assert be.list_entity_ids("Avatar") == ["e1", "e2"]
    assert be.list_entity_ids("Monster") == ["m1"]
    assert be.list_entity_ids("Nothing") == []
    be.write("Avatar", "e2", {"name": "alice2"})  # overwrite
    assert be.read("Avatar", "e2") == {"name": "alice2"}


def exercise_kvdb(be):
    assert be.get("k") is None
    for k, v in PAIRS:
        be.put(k, v)
    assert be.get("k") == "v2"
    assert be.get_or_put("k", "other") == "v2"
    assert be.get_or_put("fresh", "first") is None
    assert be.get("fresh") == "first"
    assert be.find("a", "c") == [("a", "A"), ("ab", "AB"), ("b", "B")]
    assert be.find("", "") == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_backends_round_trip(backend, servers, tmp_path):
    k = kwargs(backend, servers, tmp_path / "st")
    be = st.new_entity_storage(backend, **k)
    exercise_storage(be)
    be.close()
    again = st.new_entity_storage(backend, **k)  # durable across a reopen
    assert again.read("Avatar", "e1") == RECORDS[0][2]
    again.close()
    k = kwargs(backend, servers, tmp_path / "kv")
    be = kv.new_kvdb_backend(backend, **k)
    exercise_kvdb(be)
    be.close()
    again = kv.new_kvdb_backend(backend, **k)
    assert again.get("fresh") == "first"
    assert again.find("", "~")[0] == ("a", "A")
    again.close()


def raw_records(backend, be, servers, directory, kind):
    """What ``be`` left in its store: file bytes, table rows or the redis
    values, by key."""
    import os
    import sqlite3

    if backend == "filesystem":
        out = {}
        for dirpath, _dirs, files in os.walk(directory):
            for f in files:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, directory)] = fh.read()
        return out
    if backend == "sqlite":
        name = "entities.sqlite" if kind == "storage" else "kvdb.sqlite"
        db = sqlite3.connect(os.path.join(directory, name))
        table = "entities" if kind == "storage" else "kv"
        rows = sorted(db.execute(f"SELECT * FROM {table}").fetchall())
        db.close()
        return rows
    if backend == "mysql":
        srv = servers["mysql"]._srv
        table = "entities" if kind == "storage" else "kv"
        with srv.db_lock:
            return sorted(srv.db.execute(f"SELECT * FROM {table}").fetchall())
    if backend == "mongodb":
        wire_db = be._db if kind == "storage" else be._col._db
        db = servers["mongodb"].store[wire_db.name]
        names = ("Avatar", "Monster") if kind == "storage" else ("kvdb",)
        return {n: sorted(db[n].find({}), key=lambda d: d["_id"])
                for n in names}
    c = be._c
    if kind == "storage":
        keys = [be._key(t, e) for t, e, _ in RECORDS]
        idx = [be._index(t) for t in ("Avatar", "Monster")]
    else:
        keys = [be._key(k) for k, _ in PAIRS]
        idx = [be._INDEX]
    return ({k: c.command("GET", k) for k in keys},
            {k: c.command("ZRANGEBYLEX", k, "-", "+") for k in idx})


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_records_read_across_packages(backend, writer, servers, tmp_path):
    """One package writes, the other reads what it wrote; written alike
    by both (each into its own namespace), the stores hold the same
    bytes."""
    mods = {"port": (st, kv), "jax": (jst, jkv)}
    reader = "jax" if writer == "port" else "port"
    raw = {}
    for who in (writer, reader):
        smod, kmod = mods[who]
        k = kwargs(backend, servers, tmp_path / who / "st")
        be = smod.new_entity_storage(backend, **k)
        for t, eid, data in RECORDS:
            be.write(t, eid, data)
        raw[who, "st"] = raw_records(backend, be, servers,
                                     tmp_path / who / "st", "storage")
        be.close()
        if who == writer:
            other = mods[reader][0].new_entity_storage(backend, **k)
            for t, eid, data in RECORDS:
                assert other.read(t, eid) == data
                assert other.exists(t, eid)
            assert other.list_entity_ids("Avatar") == ["e1", "e2"]
            other.close()
        k = kwargs(backend, servers, tmp_path / who / "kv")
        be = kmod.new_kvdb_backend(backend, **k)
        for key, val in PAIRS:
            be.put(key, val)
        raw[who, "kv"] = raw_records(backend, be, servers,
                                     tmp_path / who / "kv", "kvdb")
        be.close()
        if who == writer:
            other = mods[reader][1].new_kvdb_backend(backend, **k)
            assert other.get("k") == "v2"
            assert other.find("", "~") == sorted(dict(PAIRS).items())
            other.close()
    assert raw[writer, "st"] == raw[reader, "st"]
    assert raw[writer, "kv"] == raw[reader, "kv"]


def test_filesystem_kvdb_log_and_compaction_bytes_equal_jax(tmp_path):
    """The append-only log, its torn-tail seal and its compaction write
    the JAX package's bytes, and each package replays the other's log."""
    logs = {}
    for name, mod in (("port", kv), ("jax", jkv)):
        d = tmp_path / name
        be = mod.FilesystemKVDB(str(d))
        for i in range(30):
            be.put(f"k{i % 7}", f"v{i}é")
        be.close()
        with open(d / "kvdb.log", "a", encoding="utf-8") as f:
            f.write('{"k": "torn", "v')  # a kill -9 mid-append
        be = mod.FilesystemKVDB(str(d))  # seals the tail
        for i in range(2500):  # past the compaction threshold
            be.put("hot", f"h{i}")
        be.close()
        logs[name] = (d / "kvdb.log").read_bytes()
    assert logs["port"] == logs["jax"]
    assert len(logs["port"].splitlines()) < 1000  # compacted
    for mod, other in ((kv, "jax"), (jkv, "port")):
        be = mod.FilesystemKVDB(str(tmp_path / other))
        assert be.get("hot") == "h2499" and be.get("k3") == "v24é"
        assert be.get("torn") is None
        be.close()


def test_port_client_on_jax_miniredis():
    """The port's RESP client against the JAX package's server, and the
    cluster client's slots against the spec vector."""
    srv = jminiredis.MiniRedis()
    try:
        c = RespClient(*srv.addr)
        assert c.command("PING") == "PONG"
        assert c.command("SET", "bin", bytes(range(256))) == "OK"
        assert c.command("GET", "bin") == bytes(range(256))
        c.close()
    finally:
        srv.close()
    assert key_slot("123456789") == 0x31C3
    assert key_slot("{user1000}.following") == key_slot("{user1000}.x")


def ext_db_script(pkg, servers, tmp_path, db):
    """The async redis and SQL helpers of ``pkg``'s ``ext/db``: one
    script each, the callbacks' results in delivery order (errors as
    their type's name)."""
    import importlib

    gwredis = importlib.import_module(f"{pkg}.ext.db.gwredis")
    gwsql = importlib.import_module(f"{pkg}.ext.db.gwsql")
    out, posted = [], []

    def got(v):
        out.append(type(v).__name__ if isinstance(v, gwsql.JobError) else v)

    r = gwredis.GWRedis(*servers["redis"].addr, db=db, post=posted.append)
    r.set("x", "42", callback=got)
    r.get("x", callback=got)
    r.delete("x", "y", callback=got)
    r.command("ZADD", "z", 0, "a", callback=got)
    r.command("NOSUCHCMD", callback=got)
    assert r._worker.wait_clear(5)
    r.close()
    tmp_path.mkdir()
    q = gwsql.GWSql(str(tmp_path / "g.sqlite"), post=posted.append)
    q.execute("CREATE TABLE t (a INTEGER)", callback=got)
    q.execute("INSERT INTO t VALUES (1), (2)", callback=got)
    q.query("SELECT a FROM t ORDER BY a", callback=got)
    q.query("SELECT broken syntax", callback=got)
    assert q._worker.wait_clear(5)
    q.close()
    for fn in posted:
        fn()
    return out


def test_ext_db_helpers_equal_jax(servers, tmp_path):
    got = ext_db_script("goworld_tpu_torch", servers, tmp_path / "port",
                        next(DB_INDEX))
    want = ext_db_script("goworld_tpu", servers, tmp_path / "jax",
                         next(DB_INDEX))
    assert got == want
    assert got[:4] == ["OK", b"42", 1, 1] and got[4] == "JobError"
    assert got[-3:] == [2, [(1,), (2,)], "JobError"]


def service_script(smod, kmod, svc_mod, ksvc_mod, tmp_path, monkeypatch):
    """One script of calls through a storage service (a write that fails
    twice first) and a kvdb service; the callbacks in delivery order."""
    out = []
    posted = []
    be = smod.new_entity_storage("sqlite", directory=str(tmp_path / "st"))
    real, fails = be.write, {"n": 0}

    def flaky(t, eid, data):
        if eid == "retry" and fails["n"] < 2:
            fails["n"] += 1
            raise OSError("disk on fire")
        real(t, eid, data)

    be.write = flaky
    monkeypatch.setattr(svc_mod, "_SAVE_RETRY_BACKOFF", 0.01)
    svc = svc_mod.EntityStorageService(be, post=posted.append)
    svc.save("Avatar", "a1", {"n": 1}, callback=lambda: out.append("saved a1"))
    svc.exists("Avatar", "a1", lambda r: out.append(("exists", r)))
    svc.save("Avatar", "retry", {"n": 2},
             callback=lambda: out.append("saved retry"))
    svc.load("Avatar", "retry", lambda r: out.append(("load", r)))
    svc.load("Avatar", "none", lambda r: out.append(("load", r)))
    svc.list_entity_ids("Avatar", lambda r: out.append(("list", r)))
    assert svc.wait_idle(10)
    for fn in posted:
        fn()
    posted.clear()
    out.append(("retries", fails["n"]))
    svc.close()
    ks = ksvc_mod.KVDBService(
        kmod.new_kvdb_backend("filesystem", directory=str(tmp_path / "kv")),
        post=posted.append)
    ks.put("k1", "v1", lambda r: out.append(("put", r)))
    ks.get("k1", lambda r: out.append(("get", r)))
    ks.get_or_put("k1", "other", lambda r: out.append(("gop k1", r)))
    ks.get_or_put("k2", "v2", lambda r: out.append(("gop k2", r)))
    ks.get_or_put("k2", "v3", lambda r: out.append(("gop k2", r)))
    ks.find("k", "l", lambda r: out.append(("find", r)))
    assert ks.wait_idle(10)
    for fn in posted:
        fn()
    ks.close()
    return out


def test_services_order_equal_jax(tmp_path, monkeypatch):
    got = service_script(st, kv, sts, kvs, tmp_path / "port", monkeypatch)
    want = service_script(jst, jkv, jsts, jkvs, tmp_path / "jax",
                          monkeypatch)
    assert got == want
    assert got[:2] == ["saved a1", ("exists", True)]
    assert ("retries", 2) in got and ("gop k2", None) in got
    assert got[-1] == ("find", [("k1", "v1"), ("k2", "v2")])


@pytest.mark.parametrize("kind,name", [("storage", "mongodb"),
                                       ("storage", "mysql"),
                                       ("kvdb", "mongodb"),
                                       ("kvdb", "mysql")])
def test_wire_backends_on_both_packages_servers(kind, name, servers,
                                                jax_servers):
    """The mongodb and mysql backends of each package round-trip over
    the other package's mini server, from the config path's kwargs (the
    JAX package's keys); one that cannot connect raises."""
    from goworld_tpu_torch import config

    cfg = config.loads(f"[{kind}]\nbackend = {name}\n")
    sec = cfg.storage if kind == "storage" else cfg.kvdb
    mod = st if kind == "storage" else kv
    jmod = jst if kind == "storage" else jkv
    assert mod.config_kwargs(name, sec) == jmod.config_kwargs(name, sec)
    make = st.new_entity_storage if kind == "storage" else kv.new_kvdb_backend
    jmake = (jst.new_entity_storage if kind == "storage"
             else jkv.new_kvdb_backend)
    for mk, srvs in ((make, jax_servers), (jmake, servers)):
        k = dict(mod.config_kwargs(name, sec), **kwargs(name, srvs, None))
        be = mk(name, **k)
        (exercise_storage if kind == "storage" else exercise_kvdb)(be)
        be.close()
    if name == "mysql":
        c = dbutil.connect_mysql("127.0.0.1", servers["mysql"].port, "root",
                                 "", "goworld")
        assert isinstance(c, mysqlwire.MySQLWireClient)
        c.close()
    probe = __import__("socket").socket()  # a port nothing listens on
    probe.bind(("127.0.0.1", 0))
    free = probe.getsockname()[1]
    probe.close()
    with pytest.raises(OSError):
        make(name, port=free)


def port_cluster_cfg(tmp_path, extra=""):
    from goworld_tpu_torch import config

    return config.loads(
        "[deployment]\ndispatchers = 1\ngames = 1\ngates = 0\n"
        "[dispatcher1]\nport = 0\n"
        "[game_common]\naoi_backend = cuda\naoi_device = cpu\n"
        "[storage]\nbackend = sqlite\n"
        "[kvdb]\nbackend = filesystem\n" + extra)


def wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def test_game_saves_on_stop_and_loads_anywhere(tmp_path):
    """A port game with storage and kvdb attached: an entity saved by
    ``stop``, read by the JAX sqlite backend, then loaded back through
    the dispatcher (``load_entity_anywhere`` -> ``_h_load_entity_anywhere``)
    by a second game on the same store."""
    from goworld_tpu_torch.components.dispatcher.service import \
        DispatcherService
    from goworld_tpu_torch.components.game.service import GameService
    from goworld_tpu_torch.engine.entity import Entity

    class Keeper(Entity):
        persistent = True
        persistent_attrs = frozenset({"name", "gold"})

    cfg = port_cluster_cfg(tmp_path)
    disp = DispatcherService(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    games = []
    try:
        for run in range(2):
            gs = GameService(1, cfg, freeze_dir=str(tmp_path))
            gs.register_entity_type(Keeper)
            gs.attach_storage(str(tmp_path))
            kvsvc = gs.attach_kvdb(str(tmp_path))
            gs.start()
            games.append(gs)
            assert gs.cluster.wait_connected(5)
            if run == 0:
                created = []
                gs.rt.post.post(lambda: created.append(
                    gs.rt.entities.create("Keeper")))
                assert wait(lambda: created)
                e = created[0]
                eid = e.id
                gs.rt.post.post(lambda: (e.attrs.set("name", "keeper"),
                                         e.attrs.set("gold", 7),
                                         e.attrs.set("transient", 1)))
                kvsvc.put("keeper$name", eid)
                assert kvsvc.wait_idle(5)
                gs.stop()  # saves every persistent entity
                games.clear()
                jbe = jst.new_entity_storage(
                    "sqlite", directory=str(tmp_path / "entity_storage"))
                assert jbe.read("Keeper", eid) == {"name": "keeper",
                                                   "gold": 7}
                jbe.close()
                jk = jkv.FilesystemKVDB(str(tmp_path / "kvdb"))
                assert jk.get("keeper$name") == eid
                jk.close()
            else:
                gs.rt.post.post(lambda: gs.load_entity_anywhere("Keeper",
                                                                eid))
                assert wait(lambda: gs.rt.entities.get(eid) is not None)
                loaded = gs.rt.entities.get(eid)
                assert loaded.attrs.get_str("name") == "keeper"
                assert loaded.attrs.get_int("gold") == 7
                got = []
                gs.kvdb.get("keeper$name", got.append)
                assert wait(lambda: got) and got == [eid]
    finally:
        for g in games:
            g.stop()
        disp.stop()


def test_attach_checkpoints_journals_and_restores(tmp_path):
    """``attach_checkpoints`` over the configured backends arms a
    controller that journals the game's AOI spaces (``cuda`` buckets on
    ``aoi_device``); a fresh engine's ``restore_into`` over the same
    store gives the saved words back.  Off arms nothing."""
    from goworld_tpu_torch import config
    from goworld_tpu_torch.components.game.service import GameService
    from goworld_tpu_torch.engine.aoi import AOIEngine
    from goworld_tpu_torch.engine.checkpoint import CheckpointController
    from goworld_tpu_torch.engine.entity import Entity
    from goworld_tpu_torch.engine.space import Space
    from goworld_tpu_torch.engine.vector import Vector3

    class Scene(Space):
        pass

    class Mob(Entity):
        use_aoi = True
        aoi_distance = 100.0

    extra = "aoi_checkpoint = interval\naoi_checkpoint_interval = 2\n"
    cfg = port_cluster_cfg(tmp_path, "[game1]\n" + extra)
    off = port_cluster_cfg(tmp_path)
    assert GameService(1, off, freeze_dir=str(tmp_path)) \
        .attach_checkpoints(str(tmp_path)) is None
    gs = GameService(1, cfg, freeze_dir=str(tmp_path))
    for cls in (Scene, Mob):
        gs.register_entity_type(cls)
    ctl = gs.attach_checkpoints(str(tmp_path))
    assert ctl is gs.rt.checkpoint and ctl.mode == "interval"
    sp = gs.rt.entities.create_space("Scene", kind=1)
    sp.enable_aoi(100.0, capacity=256)
    rng = np.random.default_rng(3)
    mobs = [gs.rt.entities.create("Mob", space=sp, pos=Vector3(
        float(x), 0.0, float(z))) for x, z in rng.uniform(0, 400, (200, 2))]
    for t in range(6):
        for m in mobs[t::5]:
            m.set_position(Vector3(m.position.x + 3.0, 0.0, m.position.z))
        gs.rt.tick()
    h = sp._aoi_handle
    assert h.bucket.__class__.__name__ == "_CUDABucket"
    want = h.bucket.export_snapshot(h.slot)
    assert ctl.drain(10)
    assert ctl.stats["captures"] >= 3
    ctl.close()
    store = st.new_entity_storage(
        "sqlite", directory=str(tmp_path / "checkpoints" / "entity_storage"))
    manifest = kv.new_kvdb_backend(
        "filesystem", directory=str(tmp_path / "checkpoints" / "kvdb"))
    eng = AOIEngine(device="cpu")
    res = CheckpointController(eng, store, manifest).restore_into(
        eng, sp.id, tier="cuda")
    assert res is not None
    h2, tick, _epoch = res
    assert tick == 6
    got = h2.bucket.export_snapshot(h2.slot)
    np.testing.assert_array_equal(got["words"], want["words"])
    np.testing.assert_array_equal(got["act"], want["act"])


def test_restarted_controller_continues_the_chain(tmp_path):
    """A game restarted over its own store (``-restore``) re-arms a
    controller on a namespace that already journals its spaces: the new
    controller's epochs follow the old ones, so a restore gives the new
    process's state, never the old chain folded over the new records."""
    from goworld_tpu_torch.engine.aoi import AOIEngine
    from goworld_tpu_torch.engine.checkpoint import CheckpointController

    def backends():
        return (st.new_entity_storage("sqlite", directory=str(tmp_path)),
                kv.new_kvdb_backend("filesystem", directory=str(tmp_path)))

    rng = np.random.default_rng(5)
    r, act = np.full(256, 100.0, np.float32), np.ones(256, bool)
    last = {}
    for run, ticks in ((0, 40), (1, 4)):  # the first process, the restart
        eng = AOIEngine(device="cpu")
        ctl = CheckpointController(eng, *backends(), mode="interval",
                                   interval=2)
        h = eng._create_handle(256, "cuda")
        ctl.track("space", h)
        x, z = rng.uniform(0, 600, (2, 256)).astype(np.float32)
        for t in range(1, ticks + 1):
            x = x + rng.uniform(-5, 5, 256).astype(np.float32)
            eng.submit(h, x, z, r, act)
            eng.flush()
            eng.take_events(h)
            ctl.step(t)
        assert ctl.drain(10)
        last[run] = h.bucket.export_snapshot(h.slot)
        ctl.close()
    eng = AOIEngine(device="cpu")
    res = CheckpointController(eng, *backends(), mode="off").restore_into(
        eng, "space", tier="cuda")
    h2, tick, epoch = res
    assert (tick, epoch) == (4, 21)  # 20 epochs, then the restart's 2
    got = h2.bucket.export_snapshot(h2.slot)
    np.testing.assert_array_equal(got["words"], last[1]["words"])
