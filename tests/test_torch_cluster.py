"""The port's game server (goworld_tpu_torch: config, dispatcher, gate,
game service, bot client) against the JAX package's.

(a) the recorder parity of chip_smoke.py's phase 22a at 2 spaces x 300
entities: the same inbound script into the port's GameService
(``aoi_backend=cuda``, ``aoi_device=cpu``: the kernels' plain versions)
and into the JAX GameService (``aoi_backend=cpu``) gives equal outbound
payloads and event CRCs tick by tick, with both packages' ``gen_id`` on
one counter; (b) the same after a JAX game's freeze file is restored into
each; (c) a live localhost cluster of the port (1 dispatcher, 2 games, 1
gate, in-process threads, port 0) serving the port's bot clients; (d)
the JAX bot client against the port's gate, and the port's client
against the JAX gate.  Every wait is bounded; nothing sleeps a fixed
time."""

import os
import shutil
import sys
import time
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402

SPACES, PER_SPACE, CLIENTS, CAPACITY, WORLD = 2, 300, 32, 512, 1000.0
TICKS, EVERY = 14, 10
WAIT = 10.0


def jax_game_mods():
    from goworld_tpu import config, telemetry
    from goworld_tpu.components.game import service as game_service
    from goworld_tpu.engine import ids, manager
    from goworld_tpu.engine.entity import Entity
    from goworld_tpu.engine.rpc import OWN_CLIENT, rpc
    from goworld_tpu.engine.space import Space
    from goworld_tpu.engine.vector import Vector3
    from goworld_tpu.netutil import Packet
    from goworld_tpu.proto import GWConnection
    from goworld_tpu.proto import msgtypes as MT

    return types.SimpleNamespace(
        config=config, telemetry=telemetry,
        GameService=game_service.GameService,
        id_modules=(ids, manager, game_service), fixed_id=ids.fixed_id,
        Entity=Entity, Space=Space, Vector3=Vector3, rpc=rpc,
        OWN_CLIENT=OWN_CLIENT, Packet=Packet, GWConnection=GWConnection,
        MT=MT, device_key=False)


@pytest.fixture()
def telemetry_off():
    mods = (C.port_game_mods(), jax_game_mods())
    was = [m.telemetry.enabled() for m in mods]
    for m in mods:
        m.telemetry.disable()
    yield mods
    for m, on in zip(mods, was):
        if on:
            m.telemetry.enable()


def test_scripted_game_matches_jax(telemetry_off, tmp_path):
    port, jax = telemetry_off
    runs = []
    for m, backend, device in ((port, "cuda", "cpu"), (jax, "cpu", None)):
        d = tmp_path / backend
        d.mkdir()
        runs.append(C.scripted_run(m, backend, device, d, SPACES, PER_SPACE,
                                   CLIENTS, CAPACITY, WORLD, TICKS, EVERY))
    got, want = runs
    assert got["errors"] == want["errors"] == 0, got["last_error"]
    assert got["setup"] == want["setup"]
    for t, (a, b) in enumerate(zip(got["ticks"], want["ticks"])):
        assert a == b, f"tick {t}: {len(a)} payloads against {len(b)}"
    assert got["crcs"] == want["crcs"]
    # the script reached every kind of outbound traffic
    kinds = {int.from_bytes(b[:2], "little") for t in got["ticks"] for b in t}
    MT = port.MT
    assert {MT.MT_CREATE_ENTITY_ON_CLIENT, MT.MT_DESTROY_ENTITY_ON_CLIENT,
            MT.MT_NOTIFY_ATTR_CHANGE_ON_CLIENT,
            MT.MT_SYNC_POSITION_YAW_ON_CLIENTS,
            MT.MT_NOTIFY_DESTROY_ENTITY} <= kinds
    assert sum(c != "00000000" for c in got["crcs"]) >= TICKS - 2


def test_freeze_file_restores_alike(telemetry_off, tmp_path):
    """A JAX game's freeze file (``_do_freeze``: msgpack of spaces,
    entities, clients and interests) restored into the port's game and
    into JAX's: the rest of the script gives equal streams."""
    port, jax = telemetry_off
    script = C.game_script(SPACES, CLIENTS, TICKS, EVERY, 5, WORLD)
    half = 6
    ids = C.CounterIds(jax.id_modules)
    try:
        src = tmp_path / "src"
        src.mkdir()
        sg = C.ScriptedGame(jax, "cpu", None, src)
        C.build_game_world(sg.game, jax, SPACES, PER_SPACE, CLIENTS,
                           CAPACITY, WORLD, 5)
        space_ids = [sp.id for sp in sg.game.smoke_spaces]
        walk = C.NpcWalk(sg.game.smoke_spaces, 5, WORLD)
        sg.run(script, range(half), walk, {2})
        sg.game._do_freeze()
    finally:
        ids.restore()
    frozen = src / "game1_frozen.dat"
    assert frozen.exists()
    runs = []
    for m, backend, device in ((port, "cuda", "cpu"), (jax, "cpu", None)):
        d = tmp_path / backend
        d.mkdir()
        shutil.copy(frozen, d / frozen.name)
        ids = C.CounterIds(m.id_modules)
        try:
            sg = C.ScriptedGame(m, backend, device, d, restore=True)
            g = sg.game
            assert not (d / frozen.name).exists()  # consumed by the restore
            g.smoke_spaces = [g.rt.entities.spaces[s] for s in space_ids]
            setup = C.canonical(sg.rec.take(), m.MT)
            walk = C.NpcWalk(g.smoke_spaces, 6, WORLD)
            errors = C.ErrorCount(g.log)
            out, crcs = sg.run(script, range(half, TICKS), walk, {half + 2})
            errors.close()
            assert errors.n == 0, errors.last
            avatars = sorted(e.id for e in g.rt.entities.entities.values()
                             if e.type_name == "SmokeAvatar")
        finally:
            ids.restore()
        runs.append((setup, out, crcs, avatars))
    got, want = runs
    assert got[3] == want[3] and len(got[3]) == SPACES * CLIENTS - 1
    assert got[0] == want[0]
    for t, (a, b) in enumerate(zip(got[1], want[1])):
        assert a == b, f"tick {half + t}: {len(a)} payloads against {len(b)}"
    assert got[2] == want[2]
    assert any(got[1])


# -- live clusters -----------------------------------------------------------

CLUSTER_INI = """
[deployment]
dispatchers = 1
games = 2
gates = 1

[dispatcher1]
port = 0

[game_common]
boot_entity = TestAvatar
aoi_backend = {backend}
{device}

[gate1]
port = 0
kcp_port = -1
websocket_port = -1
heartbeat_timeout_s = 0
{gate_extra}
"""


def package(name):
    """A package's cluster modules by name (the port or the JAX one)."""
    import importlib

    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        config=mod("config"), client=mod("client"),
        Dispatcher=mod("components.dispatcher.service").DispatcherService,
        Game=mod("components.game.service").GameService,
        Gate=mod("components.gate.service").GateService,
        Entity=mod("engine.entity").Entity, Space=mod("engine.space").Space,
        rpc=mod("engine.rpc"), Vector3=mod("engine.vector").Vector3,
        port=name == "goworld_tpu_torch")


def wait(pred, what):
    deadline = time.monotonic() + WAIT
    while not pred():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.005)


def start_cluster(pkg, tmp_path, gate_extra=""):
    class TestScene(pkg.Space):
        __test__ = False

    class TestAvatar(pkg.Entity):
        __test__ = False
        use_aoi = True
        aoi_distance = 100.0
        all_client_attrs = frozenset({"name"})
        client_attrs = frozenset({"secret"})

        def on_created(self):
            self.attrs.set("name", "anon")
            self.attrs.set("secret", "s3")
            self.set_client_syncing(True)

        @pkg.rpc.rpc(expose=pkg.rpc.OWN_CLIENT)
        def join_scene(self):
            scene_id = self._runtime().game.srvmap.get("scene")
            if scene_id:
                self.enter_space(scene_id, pkg.Vector3(10.0, 0.0, 10.0))

        @pkg.rpc.rpc(expose=pkg.rpc.OWN_CLIENT)
        def set_name(self, name):
            self.attrs.set("name", name)

    ini = CLUSTER_INI.format(
        backend="cuda" if pkg.port else "cpu",
        device="aoi_device = cpu" if pkg.port else "", gate_extra=gate_extra)
    cfg = pkg.config.loads(ini)
    disp = pkg.Dispatcher(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    games = []
    for gid in (1, 2):
        gs = pkg.Game(gid, cfg, freeze_dir=str(tmp_path))
        gs.register_entity_type(TestScene)
        gs.register_entity_type(TestAvatar)
        games.append(gs.start())
    gate = pkg.Gate(1, cfg).start()
    wait(lambda: all(g.deployment_ready for g in games), "deployment ready")

    def make_scene():
        sp = games[0].rt.entities.create_space("TestScene", kind=1)
        sp.enable_aoi(100.0)
        games[0].declare_service("scene", sp.id)

    games[0].rt.post.post(make_scene)
    wait(lambda: all("scene" in g.srvmap for g in games), "srvdis")
    return disp, games, gate


def stop_cluster(disp, games, gate):
    gate.stop()
    for g in games:
        g.stop()
    disp.stop()


@pytest.fixture()
def port_cluster(tmp_path):
    parts = start_cluster(package("goworld_tpu_torch"), tmp_path)
    yield parts
    stop_cluster(*parts)


def connect(client_mod, gate, transport="tcp", tls=False):
    addr = {"tcp": gate.addr, "kcp": gate.kcp_addr,
            "ws": gate.ws_addr}[transport]
    c = client_mod.GameClientConnection(addr, transport=transport, tls=tls,
                                        strict=True)
    assert c.wait_for(lambda c: c.player is not None, WAIT), "no boot entity"
    return c


def scene_flow(client_mod, games, gate, n=3, transport="tcp", tls=False):
    """Boot, join, mirrors, an attr delta with client-class filtering, an
    f32 bit-exact position sync, the leave-AOI destroy and a disconnect,
    over ``transport`` (tcp, kcp or ws; ``tls`` on tcp and ws)."""
    cs = [connect(client_mod, gate, transport, tls) for _ in range(n)]
    assert len({c.client_id for c in cs}) == n
    for c in cs:
        c.call_player("join_scene")
    for c in cs:
        assert c.wait_for(lambda c: len(c.entities) == n, WAIT), c.entities
    a, b = cs[0], cs[1]
    assert a.player.attrs.get("secret") == "s3"  # own client sees it
    b.call_player("set_name", "bob")
    assert a.wait_for(lambda c: c.entities[b.player.id].attrs.get("name")
                      == "bob", WAIT), "attr delta never reached neighbor"
    assert "secret" not in a.entities[b.player.id].attrs.keys()
    x, z, yaw = 12.3, 45.6, 0.7
    b.send_position(x, 1.5, z, yaw)
    want = tuple(float(np.float32(v)) for v in (x, 1.5, z))
    assert a.wait_for(lambda c: tuple(c.entities[b.player.id].position)
                      == want, WAIT), "position sync not bit-exact"
    assert a.entities[b.player.id].yaw == float(np.float32(yaw))
    owner = next(g for g in games if g.rt.entities.get(b.player.id))
    e = owner.rt.entities.get(b.player.id)
    assert (e.position.x, e.position.y, e.position.z) == want
    b.send_position(900.0, 0.0, 900.0)
    assert a.wait_for(lambda c: b.player.id not in c.entities, WAIT), \
        "leave-AOI destroy never reached neighbor"
    eid = cs[2].player.id
    cs[2].close()
    wait(lambda: all(g.rt.entities.get(eid) is None
                     or g.rt.entities.get(eid).client is None for g in games),
         "owner kept its client after the disconnect")
    for c in cs[:2]:
        assert not c.closed and not c.anomalies.get("recreate")
        c.close()


def test_port_cluster_serves_port_clients(port_cluster):
    from goworld_tpu_torch import client

    disp, games, gate = port_cluster
    scene_flow(client, games, gate)
    # the batched ingest took the moves: no per-entity write
    assert sum(g.ingest.stats["batched"] for g in games) >= 2
    assert sum(g.ingest.stats["per_entity_writes"] for g in games) == 0
    for g in games:
        (bucket,) = g.rt.aoi._buckets.values() or (None,)
        if bucket is not None:
            assert bucket.stats["calc_level"] == 0


def test_port_gate_serves_jax_client(port_cluster):
    from goworld_tpu import client

    disp, games, gate = port_cluster
    scene_flow(client, games, gate, n=3)


def test_jax_gate_serves_port_client(tmp_path):
    from goworld_tpu_torch import client

    parts = start_cluster(package("goworld_tpu"), tmp_path)
    try:
        scene_flow(client, parts[1], parts[2], n=3)
    finally:
        stop_cluster(*parts)


@pytest.mark.parametrize("client_pkg", ["goworld_tpu_torch", "goworld_tpu"])
@pytest.mark.parametrize("transport", ["kcp", "ws"])
def test_kcp_websocket_and_storage_attach(transport, client_pkg, port_cluster,
                                          tmp_path):
    """The port's gate serves KCP and WebSocket beside TCP: the port's
    and the JAX bot clients play the scene over each; a gate whose
    listener cannot bind raises; the storage half attaches."""
    import importlib

    from goworld_tpu_torch import client, config
    from goworld_tpu_torch.components.game.service import GameService
    from goworld_tpu_torch.components.gate.service import GateService

    disp, games, gate = port_cluster
    scene_flow(importlib.import_module(f"{client_pkg}.client"), games, gate,
               transport=transport)
    if transport == "kcp":
        with pytest.raises(ValueError, match="tls over kcp"):
            client.GameClientConnection(gate.kcp_addr, transport="kcp",
                                        tls=True)
    # the listener's port is taken: start raises, no TCP-only gate
    key = "kcp_port" if transport == "kcp" else "websocket_port"
    busy = (gate.kcp_addr if transport == "kcp" else gate.ws_addr)[1]
    cfg = config.loads(f"[gate1]\nport = 0\n{key} = {busy}\n")
    g2 = GateService(1, cfg)
    with pytest.raises(OSError):
        g2.start()
    g2.stop()
    cfg = config.loads("[game1]\naoi_device = cpu\n"
                       "aoi_checkpoint = interval\n")
    game = GameService(1, cfg, freeze_dir=str(tmp_path))
    for attach in (game.attach_storage, game.attach_kvdb,
                   game.attach_checkpoints):
        assert attach(str(tmp_path)) is not None
    assert game.storage is not None and game.kvdb is not None
    assert game.rt.checkpoint is not None
    for svc in (game.storage, game.kvdb, game.rt.checkpoint):
        svc.close()


def test_game_loop_drains_the_queue_before_a_due_tick(tmp_path, monkeypatch):
    """The logic loop handles every packet queued by the time a tick is
    due (up to DRAIN_MAX), not one a loop iteration: with a tick that
    outlasts the packets' spacing, one a tick would leave the rest
    waiting a tick each."""
    from goworld_tpu_torch import config
    from goworld_tpu_torch.components.game import service as S

    cfg = config.loads("[game1]\naoi_device = cpu\ntick_interval_ms = 5\n")
    game = S.GameService(1, cfg, freeze_dir=str(tmp_path))
    handled, at_tick = [], []
    game._handle = lambda pkt, i: handled.append(pkt)

    def tick():
        at_tick.append(len(handled))
        if len(at_tick) == 2:
            game._stop.set()

    game.rt.tick = tick
    game.cluster.flush_all = lambda: None
    n = S.DRAIN_MAX + 7
    for k in range(n):
        game.queue.put((0, k))
    # a clock on which every loop iteration finds its tick due
    clock = iter(range(0, 10 ** 9, 10))
    monkeypatch.setattr(S, "time", types.SimpleNamespace(
        monotonic=lambda: next(clock) / 1000.0))
    game._run()
    assert at_tick == [S.DRAIN_MAX, n]
    assert handled == list(range(n))


def test_game_on_cuda_without_a_card_raises(tmp_path):
    import torch

    from goworld_tpu_torch import config
    from goworld_tpu_torch.components.game.service import GameService

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = config.loads("[game1]\naoi_backend = cuda\n")
    assert cfg.games[1].aoi_device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GameService(1, cfg, freeze_dir=str(tmp_path))
