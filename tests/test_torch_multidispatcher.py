"""The port's multi-dispatcher sharding against the JAX package's
(tests/test_multidispatcher.py's scenario on goworld_tpu_torch): two
dispatchers, every game and gate linked to both, traffic sharded by
entity, gate and srvid so that per-entity order holds within a shard.
The three shard functions are held equal to the JAX package's over
1,000 seeded ids at n = 1-4; the live cluster carries client and
entity-to-entity RPCs across both shards.  A process of such a cluster
opens its dispatcher links on threads of their own at once, and each
loads the gwlz codec: a second thread must wait for the first's load,
not fall back to flate alone (its peers would read corrupt frames)."""

import base64
import threading
import time

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu import dispatchercluster as jax_dc
from goworld_tpu_torch import config as gwconfig
from goworld_tpu_torch import dispatchercluster as port_dc
from goworld_tpu_torch.client import GameClientConnection
from goworld_tpu_torch.components.dispatcher.service import DispatcherService
from goworld_tpu_torch.components.game.service import GameService
from goworld_tpu_torch.components.gate.service import GateService
from goworld_tpu_torch.dispatchercluster import entity_shard
from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import OWN_CLIENT, rpc
from goworld_tpu_torch.netutil import compress

CONFIG = """
[deployment]
dispatchers = 2
games = 2
gates = 1

[dispatcher1]
port = 0

[dispatcher2]
port = 0

[game_common]
boot_entity = ShardAvatar
aoi_backend = cpu
aoi_device = cpu

[gate1]
port = 0
heartbeat_timeout_s = 0
"""


class ShardAvatar(Entity):
    @rpc(expose=OWN_CLIENT)
    def ping(self, token):
        self.call_client("pong", token)

    @rpc
    def poke(self, from_eid):
        game = self._runtime().game
        game.call_entity(from_eid, "poked", self.id)

    @rpc
    def poked(self, by_eid):
        self.attrs.set("poked_by", by_eid)


def seeded_ids(n, seed):
    """``n`` entity ids in gen_id's form (16 url-safe base64 characters
    of 12 bytes), from a seed."""
    raw = np.random.default_rng(seed).integers(0, 256, (n, 12), np.uint8)
    return [base64.urlsafe_b64encode(r.tobytes()).decode() for r in raw]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shard_functions_equal_jax(n):
    eids = seeded_ids(1000, 17)
    srvids = [f"service/{e}" for e in seeded_ids(1000, 18)]
    gates = np.random.default_rng(19).integers(1, 1 << 16, 1000).tolist()
    for fn, keys in (("entity_shard", eids), ("gate_shard", gates),
                     ("srvid_shard", srvids)):
        got = [getattr(port_dc, fn)(k, n) for k in keys]
        want = [getattr(jax_dc, fn)(k, n) for k in keys]
        assert got == want, fn
        assert set(got) == set(range(n)), fn  # every shard is reached


def test_gwlz_load_waits_for_the_loading_thread(monkeypatch):
    """Two links' threads load the codec at once: the one arriving while
    the other loads gets the library too."""
    monkeypatch.setattr(compress, "_gwlz", None)
    monkeypatch.setattr(compress, "_gwlz_tried", False)
    real = compress.ctypes.CDLL
    loading = threading.Event()

    def slow_cdll(path):
        loading.set()
        time.sleep(0.2)
        return real(path)

    monkeypatch.setattr(compress.ctypes, "CDLL", slow_cdll)
    got = []
    first = threading.Thread(target=lambda: got.append(compress._load_gwlz()))
    first.start()
    assert loading.wait(5.0)
    got.append(compress._load_gwlz())  # while the first thread loads
    first.join()
    assert len(got) == 2 and all(lib is not None for lib in got)
    assert compress.new_compressor("gwlz").name == "gwlz"


@pytest.fixture()
def cluster(tmp_path):
    cfg = gwconfig.loads(CONFIG)
    disps = []
    for i in (1, 2):
        d = DispatcherService(i, cfg).start()
        cfg.dispatchers[i].host, cfg.dispatchers[i].port = d.addr
        disps.append(d)
    games = []
    for gid in (1, 2):
        gs = GameService(gid, cfg, freeze_dir=str(tmp_path))
        gs.register_entity_type(ShardAvatar)
        gs.start()
        games.append(gs)
    gate = GateService(1, cfg).start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not all(
        g.deployment_ready for g in games
    ):
        time.sleep(0.01)
    assert all(g.deployment_ready for g in games)
    yield disps, games, gate
    gate.stop()
    for g in games:
        g.stop()
    for d in disps:
        d.stop()


def test_traffic_spans_both_dispatcher_shards(cluster):
    disps, games, gate = cluster

    # connect clients until boot entities cover both shards (ids are random,
    # so a handful of clients is plenty)
    clients = []
    shards = set()
    for _ in range(8):
        c = GameClientConnection(gate.addr)
        assert c.wait_for(lambda c: c.player is not None, 10)
        clients.append(c)
        shards.add(entity_shard(c.player.id, 2))
        if len(shards) == 2 and len(clients) >= 4:
            break
    assert shards == {0, 1}, "entity ids never spanned both shards"

    # client -> entity RPC works regardless of which shard the entity is on
    for i, c in enumerate(clients):
        c.call_player("ping", f"tok{i}")
    for i, c in enumerate(clients):
        assert c.wait_for(
            lambda c, i=i: ("pong", (f"tok{i}",)) in c.player.calls, 10
        ), f"client {i} never got pong (shard {entity_shard(c.player.id, 2)})"

    # entity -> entity RPC across games AND shards: every avatar pokes every
    # other avatar; each poke crosses the poked entity's own dispatcher shard
    eids = [c.player.id for c in clients]
    all_games = {g.rt.entities.get(e): g for g in games for e in eids
                 if g.rt.entities.get(e) is not None}
    assert len(all_games) == len(eids)
    g1 = games[0]
    for a in eids:
        for b in eids:
            if a != b:
                g1.call_entity(b, "poke", a)
    deadline = time.monotonic() + 10

    def poked_count():
        n = 0
        for g in games:
            for e in eids:
                ent = g.rt.entities.get(e)
                if ent is not None and ent.attrs.get("poked_by"):
                    n += 1
        return n

    while time.monotonic() < deadline and poked_count() < len(eids):
        time.sleep(0.02)
    assert poked_count() == len(eids)

    # both dispatchers actually carried entity traffic (directory non-empty)
    for d in disps:
        owned = [e for e in eids if entity_shard(e, 2) == d.id - 1]
        for e in owned:
            assert e in d.entities, f"dispatcher{d.id} missing {e}"
    for c in clients:
        c.close()
