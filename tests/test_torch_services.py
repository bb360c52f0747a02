"""The port's service singleton and pubsub against the JAX package's
(tests/test_services.py's scenarios on goworld_tpu_torch, a live 2-game
cluster): the singleton is created exactly once and answers calls from
both games; pubsub delivers exact and wildcard subscriptions across the
games and nothing else.  The games step their AOI on ``aoi_device =
cpu``."""

import time

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

import goworld_tpu_torch.config as gwconfig
from goworld_tpu_torch.components.dispatcher.service import DispatcherService
from goworld_tpu_torch.components.game.service import GameService
from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import rpc
from goworld_tpu_torch.ext.pubsub import PublishSubscribeService
from goworld_tpu_torch.services import ServiceManager


class CounterService(Entity):
    def on_init(self):
        self.attrs.set("count", 0)

    @rpc
    def bump(self):
        self.attrs.set("count", self.attrs.get_int("count") + 1)


class Listener(Entity):
    def __init__(self):
        super().__init__()
        self.heard = []

    @rpc
    def on_published(self, subject, *args):
        self.heard.append((subject, args))


@pytest.fixture()
def two_games():
    cfg = gwconfig.loads(
        "[deployment]\ndispatchers = 1\ngames = 2\ngates = 0\n"
        "[game_common]\naoi_device = cpu\n"
        "[dispatcher1]\nport = 0\n"
    )
    disp = DispatcherService(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    games, mgrs = [], []
    for gid in (1, 2):
        gs = GameService(gid, cfg)
        gs.register_entity_type(Listener)
        sm = ServiceManager(gs)
        sm.register(CounterService)
        sm.register(PublishSubscribeService)
        sm.setup()
        gs.start()
        games.append(gs)
        mgrs.append(sm)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not all(
        g.deployment_ready for g in games
    ):
        time.sleep(0.01)
    assert all(g.deployment_ready for g in games)
    yield disp, games, mgrs
    for g in games:
        g.stop()
    disp.stop()


def wait_for(pred, timeout=25.0):  # generous: full-suite runs are noisy
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def registered(disp, eid):
    """The dispatcher's directory knows ``eid``'s game.  A call routed to
    an entity the directory does not know yet is dropped (the reference
    dispatcher's rule, in both packages): a service's creation reaches
    the dispatcher a loop iteration after the entity exists on its game,
    so a call from the other game must wait for it."""
    ei = disp.entities.get(eid)
    return ei is not None and ei.game_id != 0


def test_singleton_created_exactly_once(two_games):
    disp, games, mgrs = two_games
    assert wait_for(
        lambda: all(
            mgr.service_entity_id("CounterService") is not None for mgr in mgrs
        )
    ), "service never registered"
    eid = mgrs[0].service_entity_id("CounterService")
    assert mgrs[1].service_entity_id("CounterService") == eid
    # instantiated on exactly one game
    assert wait_for(
        lambda: sum(
            1 for g in games if g.rt.entities.get(eid) is not None
        ) == 1
    ), "singleton not instantiated exactly once"

    assert wait_for(lambda: registered(disp, eid))

    # call_service works from both games
    for mgr in mgrs:
        assert mgr.call_service("CounterService", "bump")
    owner = next(g for g in games if g.rt.entities.get(eid) is not None)
    assert wait_for(
        lambda: owner.rt.entities.get(eid).attrs.get_int("count") == 2
    ), "service calls never arrived"


def test_pubsub_wildcard_and_exact(two_games):
    disp, games, mgrs = two_games
    assert wait_for(
        lambda: all(
            mgr.service_entity_id("PublishSubscribeService") is not None
            for mgr in mgrs
        )
    )
    assert wait_for(lambda: registered(
        disp, mgrs[0].service_entity_id("PublishSubscribeService")))
    # listeners on both games
    l1 = games[0].rt.entities.create("Listener")
    l2 = games[1].rt.entities.create("Listener")
    assert mgrs[0].call_service(
        "PublishSubscribeService", "subscribe", l1.id, "chat.room1"
    )
    assert mgrs[1].call_service(
        "PublishSubscribeService", "subscribe", l2.id, "chat.*"
    )
    time.sleep(0.3)  # let subscriptions land
    mgrs[0].call_service(
        "PublishSubscribeService", "publish", "chat.room1", "hi"
    )
    assert wait_for(lambda: ("chat.room1", ("hi",)) in l1.heard), "exact sub missed"
    assert wait_for(lambda: ("chat.room1", ("hi",)) in l2.heard), "wildcard sub missed"
    mgrs[0].call_service(
        "PublishSubscribeService", "publish", "news.x", "scoop"
    )
    mgrs[0].call_service(
        "PublishSubscribeService", "publish", "chat.room2", "yo"
    )
    assert wait_for(lambda: ("chat.room2", ("yo",)) in l2.heard)
    assert ("news.x", ("scoop",)) not in l2.heard
    assert all(s != "chat.room2" for s, _ in l1.heard)
