"""The port's migration under load against the JAX package's
(tests/test_migration_stress.py's scenarios on goworld_tpu_torch):
entities hop between spaces hosted on different games, over two
dispatchers, while RPCs keep firing at them -- with a barrier a wave and
with every hop queued up front.  Calls are queued across moves, attrs
and timers survive every hop, nothing runs twice.  The games run the cpu
calculator on ``aoi_device = cpu``."""

import time

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch import config as gwconfig
from goworld_tpu_torch.components.dispatcher.service import DispatcherService
from goworld_tpu_torch.components.game.service import GameService
from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import rpc
from goworld_tpu_torch.engine.space import Space
from goworld_tpu_torch.engine.vector import Vector3

CONFIG = """
[deployment]
dispatchers = 2
games = 2
gates = 0

[dispatcher1]
port = 0

[dispatcher2]
port = 0

[game_common]
aoi_backend = cpu
aoi_device = cpu
tick_interval_ms = 2
"""

N_WANDERERS = 12
N_HOPS = 6


class Arena(Space):
    pass


class Wanderer(Entity):
    def on_created(self):
        self.attrs.set_default("hops", 0)
        self.attrs.set_default("pings", 0)
        self.attrs.get_list("trail")
        # a repeating timer that must survive every migration
        self.add_timer(0.05, "beat")

    def beat(self):
        self.attrs.set("beats", self.attrs.get_int("beats") + 1)

    @rpc
    def ping(self, seq):
        self.attrs.set("pings", self.attrs.get_int("pings") + 1)

    @rpc
    def hop(self, space_id):
        self.attrs.set("hops", self.attrs.get_int("hops") + 1)
        self.attrs.get_list("trail").append(space_id)
        self.enter_space(space_id, Vector3(1.0, 0.0, 1.0))


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
        gs.register_entity_type(Arena)
        gs.register_entity_type(Wanderer)
        gs.start()
        games.append(gs)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not all(
        g.deployment_ready for g in games
    ):
        time.sleep(0.01)
    assert all(g.deployment_ready for g in games)
    yield disps, games
    for g in games:
        g.stop()
    for d in disps:
        d.stop()


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_migration_storm_preserves_state_and_calls(cluster):
    (d1, d2), (g1, g2) = cluster

    # one arena per game
    boxes = {}
    for g in (g1, g2):
        g.rt.post.post(
            lambda g=g: boxes.__setitem__(
                g.id, g.rt.entities.create_space("Arena", kind=1).id
            )
        )
    assert _wait(lambda: len(boxes) == 2)
    arena1, arena2 = boxes[1], boxes[2]

    # wanderers start on game1 inside arena1
    eids = []
    def spawn():
        sp = g1.rt.entities.spaces[arena1]
        for _ in range(N_WANDERERS):
            e = g1.rt.entities.create("Wanderer", space=sp)
            eids.append(e.id)
    g1.rt.post.post(spawn)
    assert _wait(lambda: len(eids) == N_WANDERERS)

    def find(eid):
        for g in (g1, g2):
            e = g.rt.entities.get(eid)
            if e is not None:
                return g, e
        return None, None

    # storm: command hops between the two arenas, interleaved with pings --
    # many pings land while the target is mid-migration and must be queued
    ping_seq = 0
    for hop in range(N_HOPS):
        target = arena2 if hop % 2 == 0 else arena1
        for eid in eids:
            g1.call_entity(eid, "hop", target)
            for _ in range(3):
                g1.call_entity(eid, "ping", ping_seq)
                ping_seq += 1
        # wait for the whole cohort to arrive before the next wave
        expect_gid = 2 if hop % 2 == 0 else 1
        def arrived():
            ok = 0
            for eid in eids:
                g, e = find(eid)
                if (g is not None and g.id == expect_gid
                        and e.attrs.get_int("hops") == hop + 1):
                    ok += 1
            return ok == N_WANDERERS
        assert _wait(arrived, 20), (
            f"hop {hop}: cohort did not arrive on game{expect_gid}: "
            + str([(eid, find(eid)[0] and find(eid)[0].id,
                    find(eid)[1] and find(eid)[1].attrs.get_int('hops'))
                   for eid in eids])
        )

    # no entity exists twice; every ping was delivered exactly once; the
    # trail shows every hop in order; timers kept beating across all hops
    for eid in eids:
        owners = [g for g in (g1, g2) if g.rt.entities.get(eid) is not None]
        assert len(owners) == 1, f"{eid} exists on {len(owners)} games"
    assert _wait(lambda: sum(
        find(eid)[1].attrs.get_int("pings") for eid in eids
    ) == ping_seq), "pings lost across migrations"
    for eid in eids:
        _, e = find(eid)
        assert e.attrs.get_int("hops") == N_HOPS
        want = [arena2 if h % 2 == 0 else arena1 for h in range(N_HOPS)]
        assert list(e.attrs.get_list("trail")) == want
    beats0 = {eid: find(eid)[1].attrs.get_int("beats") for eid in eids}
    assert _wait(lambda: all(
        find(eid)[1].attrs.get_int("beats") > beats0[eid] for eid in eids
    )), "migrated timers stopped beating"


def test_migration_storm_no_barriers(cluster):
    """Harsher: every hop+ping for every wanderer is enqueued up front, so
    entities have multiple queued migrations while already mid-flight.
    Per-entity dispatcher-shard ordering must still deliver everything
    exactly once and in order."""
    (d1, d2), (g1, g2) = cluster
    boxes = {}
    for g in (g1, g2):
        g.rt.post.post(
            lambda g=g: boxes.__setitem__(
                g.id, g.rt.entities.create_space("Arena", kind=1).id
            )
        )
    assert _wait(lambda: len(boxes) == 2)
    arena1, arena2 = boxes[1], boxes[2]

    eids = []
    def spawn():
        sp = g1.rt.entities.spaces[arena1]
        for _ in range(8):
            eids.append(g1.rt.entities.create("Wanderer", space=sp).id)
    g1.rt.post.post(spawn)
    assert _wait(lambda: len(eids) == 8)

    hops = 5
    pings = 0
    for h in range(hops):
        target = arena2 if h % 2 == 0 else arena1
        for eid in eids:
            g1.call_entity(eid, "hop", target)
            g1.call_entity(eid, "ping", pings)
            pings += 1

    def find(eid):
        for g in (g1, g2):
            e = g.rt.entities.get(eid)
            if e is not None:
                return e
        return None

    def settled():
        for eid in eids:
            e = find(eid)
            if e is None or e.attrs.get_int("hops") != hops:
                return False
            if e.attrs.get_int("pings") != hops:
                return False
        return True
    assert _wait(settled, 30), str([
        (eid, find(eid) and (find(eid).attrs.get_int("hops"),
                             find(eid).attrs.get_int("pings")))
        for eid in eids
    ])
    for eid in eids:
        e = find(eid)
        want = [arena2 if h % 2 == 0 else arena1 for h in range(hops)]
        assert list(e.attrs.get_list("trail")) == want
        owners = [g for g in (g1, g2) if g.rt.entities.get(eid)]
        assert len(owners) == 1
