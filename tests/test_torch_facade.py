"""The port's developer surface (goworld_tpu_torch: the ``goworld`` facade
and ``goworld_cn``, ``services.ServiceManager``, ``ext/pubsub``, the
example games under ``goworld_tpu_torch/examples/``) against the JAX
package's.

The facades' public names equal the JAX modules'; the facade works on a
bound game of a live two-game cluster (creation, calls, kvdb, crontab,
storage queries, the Chinese twin); a service singleton is created once
over the two games; one publish script gives the JAX service's
deliveries; the example twins run the scenarios of
``tests/test_examples.py`` on the port, and each twin's outbound stream
equals the JAX example's on one inbound script (the recorder harness of
``chip_smoke.py`` phase 22a, both packages' ``gen_id`` on one counter).
Every game runs ``aoi_backend = cuda`` on ``aoi_device = cpu``."""

import importlib.util
import os
import sys
import time
import types

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from goworld_tpu_torch import config as gwconfig  # noqa: E402
from goworld_tpu_torch import goworld  # noqa: E402
from goworld_tpu_torch.client import GameClientConnection  # noqa: E402
from goworld_tpu_torch.components.dispatcher.service import \
    DispatcherService  # noqa: E402
from goworld_tpu_torch.components.game.service import GameService  # noqa: E402
from goworld_tpu_torch.components.gate.service import GateService  # noqa: E402
from goworld_tpu_torch.engine.entity import Entity  # noqa: E402
from goworld_tpu_torch.engine.rpc import rpc  # noqa: E402
from goworld_tpu_torch.services import ServiceManager  # noqa: E402

WAIT = 15.0


def wait(pred, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def on_logic(game, fn):
    """Run ``fn`` on the game's logic thread; its result."""
    box = []
    game.rt.post.post(lambda: box.append(fn()))
    assert wait(lambda: box), "posted function never ran"
    return box[0]


def public(mod):
    return sorted(n for n in vars(mod) if not n.startswith("_"))


@pytest.mark.parametrize("name", ["goworld", "goworld_cn"])
def test_facade_names_equal_jax(name):
    import importlib

    port = importlib.import_module(f"goworld_tpu_torch.{name}")
    jax = importlib.import_module(f"goworld_tpu.{name}")
    assert public(port) == public(jax)
    for n in public(port):
        a, b = getattr(port, n), getattr(jax, n)
        if callable(a) and hasattr(a, "__code__"):
            assert a.__code__.co_varnames[:a.__code__.co_argcount] == \
                b.__code__.co_varnames[:b.__code__.co_argcount], n


# -- a live two-game cluster of the port ------------------------------------


class Arena(goworld.Space):
    inited_kinds = []

    def on_space_init(self):
        Arena.inited_kinds.append(self.kind)


class Pawn(goworld.Entity):
    persistent = True
    persistent_attrs = frozenset({"gold"})
    greetings = []

    @goworld.rpc
    def greet(self, text):
        Pawn.greetings.append((self.id, text))


class CounterService(Entity):
    def on_init(self):
        self.attrs.set("count", 0)

    @rpc
    def bump(self):
        self.attrs.set("count", self.attrs.get_int("count") + 1)


CONFIG = """
[deployment]
dispatchers = 1
games = 2
gates = 0

[dispatcher1]
port = 0

[game_common]
aoi_backend = cuda
aoi_device = cpu
"""


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("facade")
    cfg = gwconfig.loads(CONFIG)
    disp = DispatcherService(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    games, mgrs = [], []
    for gid in (1, 2):
        gs = GameService(gid, cfg, freeze_dir=str(tmp))
        gs.attach_storage(str(tmp))  # one store: both games see saves
        gs.attach_kvdb(str(tmp / f"g{gid}"))
        gs.register_entity_type(Arena)
        gs.register_entity_type(Pawn)
        sm = ServiceManager(gs)
        sm.register(CounterService)
        sm.setup()
        gs.services = sm
        gs.start()
        games.append(gs)
        mgrs.append(sm)
    assert wait(lambda: all(g.deployment_ready for g in games))
    goworld.bind(games[0])
    yield disp, games, mgrs
    goworld.bind(None)
    for g in games:
        g.stop()
    disp.stop()


def test_facade_round_trip_on_bound_game(cluster):
    _disp, (g1, _g2), _mgrs = cluster
    Arena.inited_kinds.clear()
    Pawn.greetings.clear()

    def local_ops():
        sp = goworld.create_space_locally("Arena", kind=3)
        p = goworld.create_entity_locally("Pawn", space=sp)
        assert goworld.get_entity(p.id) is p
        assert goworld.nil_space() is g1.nil_space
        assert goworld.get_game_id() == 1
        goworld.call(p.id, "greet", "local")
        p.attrs.set("gold", 5)
        return p.id

    pid = on_logic(g1, local_ops)
    assert wait(lambda: (pid, "local") in Pawn.greetings)
    assert Arena.inited_kinds == [3]
    on_logic(g1, lambda: goworld.create_space_anywhere("Arena", kind=7))
    assert wait(lambda: 7 in Arena.inited_kinds), Arena.inited_kinds
    got = []
    on_logic(g1, lambda: goworld.kvdb_put("k1", "v1", lambda _: goworld.
                                          kvdb_get("k1", got.append)))
    assert wait(lambda: got == ["v1"]), got
    on_logic(g1, lambda: goworld.kvdb_get_or_put("k1", "v2", got.append))
    assert wait(lambda: len(got) == 2) and got[1] == "v1"
    # storage queries: the pawn saved on destroy, then listed and found
    on_logic(g1, lambda: goworld.get_entity(pid).destroy())
    assert g1.storage.wait_idle(5)
    on_logic(g1, lambda: goworld.exists_entity("Pawn", pid, got.append))
    on_logic(g1, lambda: goworld.list_entity_ids("Pawn", got.append))
    assert wait(lambda: len(got) == 4) and got[2:] == [True, [pid]]
    # crontab on a fake clock
    fired, clock = [], [1_000_000 * 60.0]

    def arm():
        g1.rt.crontab._wallclock = lambda: clock[0]
        return goworld.register_crontab(-1, -1, -1, -1, -1,
                                        lambda: fired.append(1))

    handle = on_logic(g1, arm)
    clock[0] += 60
    assert wait(lambda: len(fired) == 1)
    assert on_logic(g1, lambda: goworld.unregister_crontab(handle))
    # the Chinese twin delegates to the same bound game
    from goworld_tpu_torch import goworld_cn as cn

    assert on_logic(g1, lambda: cn.获取GameID()) == 1
    eid = on_logic(g1, lambda: cn.本地创建实体("Pawn").id)
    assert on_logic(g1, lambda: cn.获取实体(eid)) is not None
    on_logic(g1, lambda: cn.KV写("cnk", "v9", lambda _: got.append("put")))
    assert wait(lambda: "put" in got)
    on_logic(g1, lambda: cn.KV读("cnk", got.append))
    assert wait(lambda: "v9" in got)
    goworld.bind(None)
    with pytest.raises(RuntimeError, match="not bound"):
        goworld.current_game()
    goworld.bind(g1)


def registered(disp, eid):
    """The dispatcher's directory knows ``eid``'s game.  A call routed to
    an entity the directory does not know yet is dropped (the reference
    dispatcher's rule, in both packages): a service's creation reaches
    the dispatcher a loop iteration after the entity exists on its game,
    so a call from the other game must wait for it."""
    ei = disp.entities.get(eid)
    return ei is not None and ei.game_id != 0


def test_service_singleton_created_once_over_two_games(cluster):
    disp, games, mgrs = cluster
    assert wait(lambda: all(m.service_entity_id("CounterService")
                            for m in mgrs)), "service never registered"
    eid = mgrs[0].service_entity_id("CounterService")
    assert mgrs[1].service_entity_id("CounterService") == eid
    assert wait(lambda: sum(g.rt.entities.get(eid) is not None
                            for g in games) == 1)
    assert wait(lambda: registered(disp, eid))
    for mgr, g in zip(mgrs, games):
        assert on_logic(g, lambda mgr=mgr: mgr.call_service(
            "CounterService", "bump"))
    owner = next(g for g in games if g.rt.entities.get(eid) is not None)
    assert wait(lambda: owner.rt.entities.get(eid).attrs.get_int("count")
                == 2)
    time.sleep(1.2)  # one more reconcile round creates no second copy
    assert sum(len(g.rt.entities.by_type.get("CounterService", ()))
               for g in games) == 1


# -- recorder harness: one inbound script, both packages ---------------------


def jax_mods():
    from goworld_tpu import config, goworld as facade, telemetry
    from goworld_tpu.components.game import service as game_service
    from goworld_tpu.engine import ids, manager
    from goworld_tpu.engine.entity import Entity as JEntity
    from goworld_tpu.engine.rpc import rpc as jrpc
    from goworld_tpu.ext.pubsub import PublishSubscribeService
    from goworld_tpu.netutil import Packet
    from goworld_tpu.proto import GWConnection
    from goworld_tpu.proto import msgtypes as MT

    return types.SimpleNamespace(
        name="jax", config=config, telemetry=telemetry, facade=facade,
        GameService=game_service.GameService,
        id_modules=(ids, manager, game_service), fixed_id=ids.fixed_id,
        Entity=JEntity, rpc=jrpc, PubSub=PublishSubscribeService,
        Packet=Packet, GWConnection=GWConnection, MT=MT,
        example=lambda n: os.path.join(ROOT, "examples", n, "server.py"),
        ini="aoi_backend = cpu\n")


def port_mods():
    from goworld_tpu_torch import config, telemetry
    from goworld_tpu_torch.components.game import service as game_service
    from goworld_tpu_torch.engine import ids, manager
    from goworld_tpu_torch.ext.pubsub import PublishSubscribeService
    from goworld_tpu_torch.netutil import Packet
    from goworld_tpu_torch.proto import GWConnection
    from goworld_tpu_torch.proto import msgtypes as MT

    return types.SimpleNamespace(
        name="port", config=config, telemetry=telemetry, facade=goworld,
        GameService=game_service.GameService,
        id_modules=(ids, manager, game_service), fixed_id=ids.fixed_id,
        Entity=Entity, rpc=rpc, PubSub=PublishSubscribeService,
        Packet=Packet, GWConnection=GWConnection, MT=MT,
        example=lambda n: os.path.join(ROOT, "goworld_tpu_torch",
                                       "examples", f"{n}.py"),
        ini="aoi_backend = cuda\naoi_device = cpu\n")


def load(path, tag):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[tag] = mod
    spec.loader.exec_module(mod)
    return mod


class Recorded:
    """A game of package ``m`` with storage and kvdb attached, whose
    dispatcher link is ``chip_smoke.RecorderCluster``; ``step`` feeds one
    tick's inbound payloads, waits for the async services, and returns
    the tick's canonical outbound payloads."""

    def __init__(self, m, tmp, boot):
        self.m = m
        cfg = m.config.loads(f"[game1]\nboot_entity = {boot}\n" + m.ini)
        self.game = g = m.GameService(1, cfg, freeze_dir=str(tmp))
        self.rec = g.cluster = C.RecorderCluster(m.GWConnection)
        g.attach_storage(str(tmp))
        g.attach_kvdb(str(tmp))
        m.facade.bind(g)

    def start(self):
        g = self.game
        g.nil_space = g.rt.entities.create(
            "__nil_space__", eid=self.m.fixed_id(f"nilspace-game{g.id}"))
        return C.canonical(self.rec.take(), self.m.MT)

    def step(self, payloads=()):
        g = self.game
        for b in payloads:
            g.queue.put((0, self.m.Packet(bytearray(b))))
        g.step()
        assert g.storage.wait_idle(5) and g.kvdb.wait_idle(5)
        return C.canonical(self.rec.take(), self.m.MT)

    def close(self):
        self.m.facade.bind(None)
        self.game.storage.close()
        self.game.kvdb.close()


def client_script(steps):
    """Inbound payloads a tick: ``("connect", i)`` (client i's boot
    entity), ``("call", i, method, *args)`` (client i's RPC to it); one
    client-less tick after each, for the async callbacks."""
    from goworld_tpu_torch.netutil import Packet
    from goworld_tpu_torch.proto import msgtypes as MT

    out = []
    for step in steps:
        i = step[1]
        cid, eid = f"C{i:015d}", f"B{i:015d}"
        if step[0] == "connect":
            p = Packet.for_msgtype(MT.MT_NOTIFY_CLIENT_CONNECTED)
            p.append_client_id(cid)
            p.append_entity_id(eid)
            p.append_u16(1)
        else:
            p = Packet.for_msgtype(MT.MT_CALL_ENTITY_METHOD_FROM_CLIENT)
            p.append_entity_id(eid)
            p.append_varstr(step[2])
            p.append_args(step[3:])
            p.append_client_id(cid)
        out += [[p.payload], [], []]
    return out


EXAMPLE_SCRIPTS = {
    "nil_game": ("NilBoot", [("connect", 0), ("call", 0, "ping", 7),
                             ("connect", 1), ("call", 1, "ping", 8)]),
    "chatroom_demo": ("Account", [
        ("connect", 0), ("call", 0, "register", "alice", "pw1"),
        ("call", 0, "register", "alice", "pw1"),
        ("call", 0, "login", "alice", "nope"),
        ("call", 0, "login", "bob", "pw"),
        ("call", 0, "login", "alice", "pw1"), ("connect", 1),
        ("call", 1, "register", "bob", "pw2")]),
    "test_game": ("Avatar", [
        ("connect", 0), ("call", 0, "set_name", "p1"), ("connect", 1),
        ("call", 1, "set_name", "p2"),
        ("call", 0, "team_shout", "go team"),
        ("call", 1, "mail_to", "B000000000000000", "hi"),
        ("call", 0, "join_scene")]),
}


def run_recorded(m, tmp, build, script):
    ids = C.CounterIds(m.id_modules)
    m.telemetry.disable()
    r = None
    try:
        r = Recorded(m, tmp, build[0])
        build[1](r)
        out = [r.start()] + [r.step(t) for t in script]
        return out, r.game
    finally:
        ids.restore()
        if r is not None:
            r.close()


@pytest.mark.parametrize("name", sorted(EXAMPLE_SCRIPTS))
def test_example_stream_equal_jax(name, tmp_path):
    boot, steps = EXAMPLE_SCRIPTS[name]
    script = client_script(steps)
    runs = []
    for m in (port_mods(), jax_mods()):
        mod = load(m.example(name), f"twin_{m.name}_{name}")
        d = tmp_path / m.name
        d.mkdir()
        out, game = run_recorded(
            m, d, (boot, lambda r, mod=mod: mod.setup(r.game)), script)
        runs.append(out)
    got, want = runs
    assert len(got) == len(want)
    for t, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"{name} tick {t}: {len(a)} payloads against {len(b)}"
    assert sum(len(t) for t in got) >= len(steps)


def test_pubsub_deliveries_equal_jax(tmp_path):
    """Subscriptions (exact, prefix, ``*``), unsubscriptions and
    publishes through the service entity on a recorded game: the local
    subscribers' deliveries and the batches for the remote ones are the
    JAX service's."""
    remote = ["R000000000000001", "R000000000000002"]
    script = [("sub", 0, "chat.room1"), ("sub", 1, "chat.*"),
              ("sub", 2, "*"), ("sub", remote[0], "chat.room1"),
              ("sub", remote[1], "news.*"), ("pub", "chat.room1", "hi"),
              ("pub", "news.x", "scoop"), ("unsub", 1, "chat.*"),
              ("pub", "chat.room2", "yo"), ("unsub", 2, "*"),
              ("sub", 1, "chat.room2"), ("pub", "chat.room2", "again", 3),
              ("pub", "none", 0)]
    runs = []
    for m in (port_mods(), jax_mods()):

        class Listener(m.Entity):
            def on_init(self):
                self.heard = []

            @m.rpc
            def on_published(self, subject, *args):
                self.heard.append((subject, args))

        def build(r, m=m, Listener=Listener):
            r.game.register_entity_type(Listener)
            r.game.register_entity_type(m.PubSub)

        d = tmp_path / m.name
        d.mkdir()
        ids = C.CounterIds(m.id_modules)
        m.telemetry.disable()
        r = None
        try:
            r = Recorded(m, d, "Listener")
            build(r)
            r.start()
            em = r.game.rt.entities
            svc = em.create("PublishSubscribeService")
            subs = [em.create("Listener") for _ in range(3)]
            log = []
            for op in script:
                who = op[1] if op[0] == "pub" or isinstance(op[1], str) \
                    else subs[op[1]].id
                if op[0] == "sub":
                    svc.call("subscribe", who, op[2])
                elif op[0] == "unsub":
                    svc.call("unsubscribe", who, op[2])
                else:
                    svc.call("publish", *op[1:])
                log.append(r.step())
            log.append([s.heard for s in subs])
            runs.append(log)
        finally:
            ids.restore()
            if r is not None:
                r.close()
    got, want = runs
    assert got == want
    assert got[-1][0] == [("chat.room1", ("hi",))]
    assert ("chat.room2", ("yo",)) in got[-1][2]
    assert any(got[:-1])  # the remote subscribers' batches went out


# -- the example twins on a live cluster (tests/test_examples.py) -----------


def make_cluster(tmp_path, mod, boot_entity, games=1):
    cfg = gwconfig.loads(f"""
[deployment]
dispatchers = 1
games = {games}
gates = 1

[dispatcher1]
port = 0

[game_common]
boot_entity = {boot_entity}
aoi_backend = cuda
aoi_device = cpu
position_sync_interval_ms = 20

[gate1]
port = 0

[storage]
directory = {tmp_path}/entity_storage

[kvdb]
directory = {tmp_path}/kvdb
""")
    disp = DispatcherService(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    game_svcs = []
    for gid in range(1, games + 1):
        gs = GameService(gid, cfg, freeze_dir=str(tmp_path))
        gs.attach_storage(str(tmp_path))
        gs.attach_kvdb(str(tmp_path))
        mod.setup(gs)
        gs.start()
        game_svcs.append(gs)
    gate = GateService(1, cfg).start()
    assert wait(lambda: all(g.deployment_ready for g in game_svcs))
    if hasattr(mod, "on_ready"):
        for gs in game_svcs:
            gs.rt.post.post(lambda gs=gs: mod.on_ready(gs))
    return disp, game_svcs, gate


def teardown_cluster(disp, games, gate):
    gate.stop()
    for g in games:
        g.stop()
    disp.stop()


def calls(c, method):
    out = [args for e in c.entities.values() for m, args in e.calls
           if m == method]
    return out + [args for m, args in c.filtered_calls if m == method]


def wait_reply(c, send, pred, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        send()
        if c.wait_for(pred, 1.0):
            return True
    return False


def scenario_nil_game(gate):
    c = GameClientConnection(gate.addr)
    assert c.wait_for(lambda c: c.player is not None, WAIT)
    c.call_player("ping", 7)
    assert c.wait_for(lambda c: (7,) in calls(c, "pong"), WAIT)
    c.close()


def scenario_chatroom_demo(gate):
    c1 = GameClientConnection(gate.addr)
    assert c1.wait_for(lambda c: c.player is not None, WAIT)
    c1.call_player("register", "alice", "pw1")
    assert c1.wait_for(lambda c: calls(c, "show_info"), WAIT)
    assert "registered" in calls(c1, "show_info")[0][0]
    c1.call_player("register", "alice", "pw1")
    assert c1.wait_for(lambda c: calls(c, "show_error"), WAIT)
    assert "exists" in calls(c1, "show_error")[0][0]
    c1.call_player("login", "alice", "nope")
    assert c1.wait_for(lambda c: any("password" in a[0]
                                     for a in calls(c, "show_error")), WAIT)
    c1.call_player("login", "alice", "pw1")
    assert c1.wait_for(lambda c: c.player is not None
                       and c.player.type_name == "Avatar"
                       and c.player.attrs.get("name") == "alice", WAIT)
    c2 = GameClientConnection(gate.addr)
    assert c2.wait_for(lambda c: c.player is not None, WAIT)
    c2.call_player("register", "bob", "pw2")
    assert c2.wait_for(lambda c: calls(c, "show_info"), WAIT)
    c2.call_player("login", "bob", "pw2")
    assert c2.wait_for(lambda c: c.player is not None
                       and c.player.type_name == "Avatar", WAIT)
    c1.call_player("say", "hello room")
    assert c1.wait_for(lambda c: ("alice", "hello room")
                       in calls(c, "hear"), WAIT)
    assert c2.wait_for(lambda c: ("alice", "hello room")
                       in calls(c, "hear"), WAIT)
    c2.call_player("enter_room", "private")
    assert c2.wait_for(lambda c: any("private" in a[0]
                                     for a in calls(c, "show_info")), WAIT)
    n_before = len(calls(c2, "hear"))
    c1.call_player("say", "second")
    assert c1.wait_for(lambda c: ("alice", "second") in calls(c, "hear"),
                       WAIT)
    c2.poll(1.0)
    assert len(calls(c2, "hear")) == n_before
    c1.close()
    c2.close()


def scenario_test_game(gate):
    c1 = GameClientConnection(gate.addr)
    c2 = GameClientConnection(gate.addr)
    for c, name in ((c1, "p1"), (c2, "p2")):
        assert c.wait_for(lambda c: c.player is not None, WAIT)
        c.call_player("set_name", name)
        assert c.wait_for(lambda c: c.player.attrs.get("name") == name, WAIT)
        c.call_player("join_scene")
    assert c1.wait_for(lambda c: any(e.type_name == "Avatar"
                                     and not e.is_player
                                     for e in c.entities.values()), WAIT)
    both = {c1.player.id, c2.player.id}
    assert wait_reply(c1, lambda: c1.call_player("who_is_online"),
                      lambda c: any(both <= set(a[0])
                                    for a in calls(c, "online_list")))
    assert wait_reply(c2, lambda: c1.call_player("shout", "hello world"),
                      lambda c: ("broadcast.all", "p1", "hello world")
                      in calls(c, "heard"))
    assert wait_reply(c2, lambda: c1.call_player("mail_to", c2.player.id,
                                                 "mail body"),
                      lambda c: c.player.attrs.get("mails_got", 0) >= 1)
    assert wait_reply(c2, lambda: c2.call_player("read_mails"),
                      lambda c: calls(c, "mails"))
    assert any("mail body" in m for m in calls(c2, "mails")[-1][0])
    c1.call_player("team_shout", "go team")
    for c in (c1, c2):
        assert c.wait_for(lambda c: ("p1", "go team")
                          in calls(c, "team_heard"), WAIT)
    c1.close()
    c2.close()


@pytest.mark.parametrize("name,boot,games", [
    ("nil_game", "NilBoot", 1), ("chatroom_demo", "Account", 1),
    ("test_game", "Avatar", 2)])
def test_example_twin_on_a_live_cluster(name, boot, games, tmp_path):
    mod = load(port_mods().example(name), f"twin_live_{name}")
    parts = make_cluster(tmp_path, mod, boot, games)
    try:
        globals()[f"scenario_{name}"](parts[2])
    finally:
        teardown_cluster(*parts)
