"""The port's dispatcher block and replay during an entity load against
the JAX package's (tests/test_load_blocking.py's scenario on
goworld_tpu_torch): calls made to an entity while it loads from storage
are parked at the dispatcher and replayed once it registers -- none
lost, in send order.  The delivered order is computed in both packages
on the same script and held equal.  The games run the cpu calculator on
``aoi_device = cpu``."""

import importlib
import time
import types

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

CONFIG = """
[deployment]
dispatchers = 1
games = 2
gates = 0

[dispatcher1]
port = 0

[game_common]
aoi_backend = cpu
aoi_device = cpu

[storage]
backend = filesystem
"""


def package(name):
    """The modules the scenario needs from a package (port or JAX)."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        config=mod("config"),
        Dispatcher=mod("components.dispatcher.service").DispatcherService,
        Game=mod("components.game.service").GameService,
        Entity=mod("engine.entity").Entity, gen_id=mod("engine.ids").gen_id,
        rpc=mod("engine.rpc").rpc,
        Filesystem=mod("storage.backends").FilesystemEntityStorage,
        StorageService=mod("storage").EntityStorageService)


def types_of(pkg):
    class SlowStorage(pkg.Filesystem):
        """Read delay widens the load window so the in-flight calls race
        it."""

        read_delay = 0.5

        def read(self, type_name, eid):
            time.sleep(self.read_delay)
            return super().read(type_name, eid)

    class LazyAvatar(pkg.Entity):
        persistent = True
        persistent_attrs = frozenset({"name", "marks"})

        @pkg.rpc
        def mark(self, value):
            self.attrs.get_list("marks").append(value)

    return SlowStorage, LazyAvatar


def start(pkg, tmp_path):
    slow, avatar = types_of(pkg)
    text = CONFIG if pkg is PORT else CONFIG.replace("aoi_device = cpu\n", "")
    cfg = pkg.config.loads(text)
    disp = pkg.Dispatcher(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    shared = str(tmp_path / "storage")
    games = []
    for gid in (1, 2):
        gs = pkg.Game(gid, cfg, freeze_dir=str(tmp_path))
        # both games share one storage dir so either can host the load
        backend = slow(shared)
        gs.storage = pkg.StorageService(backend, post=gs.rt.post.post)
        gs.register_entity_type(avatar)
        gs.start()
        games.append(gs)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not all(
        g.deployment_ready for g in games
    ):
        time.sleep(0.01)
    assert all(g.deployment_ready for g in games)
    return disp, games, shared


def stop(disp, games):
    for g in games:
        g.stop()
    disp.stop()


PORT, JAX = package("goworld_tpu_torch"), package("goworld_tpu")


@pytest.fixture()
def cluster(tmp_path):
    disp, games, shared = start(PORT, tmp_path)
    yield disp, games, shared
    stop(disp, games)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def load_and_call(pkg, g1, g2, shared):
    """Seed a record, load it anywhere and call it three times at once;
    the host's marks once they reach three, or None."""
    eid = pkg.gen_id()
    # seed storage directly (bypassing the slow read)
    pkg.Filesystem(shared).write(
        "LazyAvatar", eid, {"name": "sleeper", "marks": []}
    )

    g1.load_entity_anywhere("LazyAvatar", eid)
    # fire calls IMMEDIATELY -- the 0.5 s read is still in flight, so the
    # dispatcher must park these on the blocked entity's queue
    for v in (1, 2, 3):
        g1.call_entity(eid, "mark", v)

    def host():
        return g1.rt.entities.get(eid) or g2.rt.entities.get(eid)

    _wait(lambda: host() is not None
          and len(host().attrs.get_list("marks")) >= 3, 10)
    return eid, host()


def test_calls_during_load_are_queued_in_order(cluster, tmp_path):
    disp, (g1, g2), shared = cluster
    eid, host = load_and_call(PORT, g1, g2, shared)
    assert host is not None and list(host.attrs.get_list("marks")) == [
        1, 2, 3], (
        "calls made during load were lost or reordered: "
        + str([
            (g.id, e and list(e.attrs.get_list('marks')))
            for g in (g1, g2)
            for e in [g.rt.entities.get(eid)]
        ])
    )
    # the entity kept its persisted attrs too
    assert host.attrs.get_str("name") == "sleeper"
    # the JAX cluster delivers the same calls in the same order
    (tmp_path / "jax").mkdir()
    jdisp, (j1, j2), jshared = start(JAX, tmp_path / "jax")
    try:
        _jeid, jhost = load_and_call(JAX, j1, j2, jshared)
        assert jhost is not None
        assert list(jhost.attrs.get_list("marks")) == list(
            host.attrs.get_list("marks"))
    finally:
        stop(jdisp, (j1, j2))
