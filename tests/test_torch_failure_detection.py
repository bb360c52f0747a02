"""The port's failure detection against the JAX package's
(tests/test_failure_detection.py's scenarios on goworld_tpu_torch): game
death cleans the entity directory and fails the singleton over, gate
death detaches its clients, a silent client is heartbeat-kicked and an
active one is not, a provider's dropped link leaves no split brain, and a
reconnecting game's duplicate entity is refused.  The games run the cpu
calculator on ``aoi_device = cpu``."""

import time

from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch import config as gwconfig
from goworld_tpu_torch.client import GameClientConnection
from goworld_tpu_torch.components.dispatcher.service import DispatcherService
from goworld_tpu_torch.components.game.service import GameService
from goworld_tpu_torch.components.gate.service import GateService
from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import rpc
from goworld_tpu_torch.services import ServiceManager

CONFIG = """
[deployment]
dispatchers = 1
games = 2
gates = 1

[dispatcher1]
port = 0

[game_common]
boot_entity = FDAvatar
aoi_backend = cpu
aoi_device = cpu

[gate1]
port = 0
heartbeat_timeout_s = {hb}
"""


class FDAvatar(Entity):
    pass


class CounterService(Entity):
    created_on: list = []

    def on_created(self):
        CounterService.created_on.append(self._runtime().game.id)

    @rpc
    def bump(self):
        self.attrs.set("n", self.attrs.get_int("n") + 1)


def make_cluster(tmp_path, hb="0"):
    cfg = gwconfig.loads(CONFIG.format(hb=hb))
    disp = DispatcherService(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    games = []
    for gid in (1, 2):
        gs = GameService(gid, cfg, freeze_dir=str(tmp_path))
        gs.register_entity_type(FDAvatar)
        services = ServiceManager(gs)
        services.register(CounterService)
        services.setup()
        gs.services = services
        gs.start()
        games.append(gs)
    gate = GateService(1, cfg).start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not all(
        g.deployment_ready for g in games
    ):
        time.sleep(0.01)
    assert all(g.deployment_ready for g in games)
    return disp, games, gate


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_game_death_cleans_directory_and_fails_over_service(tmp_path):
    CounterService.created_on.clear()
    disp, (g1, g2), gate = make_cluster(tmp_path)
    try:
        # wait for the singleton to be claimed somewhere
        assert _wait(lambda: any(
            "service/CounterService" in g.srvmap for g in (g1, g2)
        )), "service never claimed"
        assert _wait(lambda: len(CounterService.created_on) == 1)
        owner_gid = CounterService.created_on[0]
        owner, survivor = (g1, g2) if owner_gid == 1 else (g2, g1)

        # a client's boot entity lands somewhere; count directory entries
        c = GameClientConnection(gate.addr)
        assert c.wait_for(lambda c: c.player is not None, 10)
        eid = c.player.id
        assert _wait(lambda: eid in disp.entities)

        # kill the service's host abruptly (no graceful terminate)
        owner.cluster.stop()
        owner._stop.set()

        # dispatcher drops the dead game's entities from the directory
        assert _wait(lambda: all(
            ei.game_id != owner.id for ei in disp.entities.values()
        )), "directory still maps entities to the dead game"

        # the singleton fails over to the survivor (reconciliation re-claims)
        assert _wait(
            lambda: len(CounterService.created_on) == 2, 20
        ), f"service never failed over (created_on={CounterService.created_on})"
        assert CounterService.created_on[1] == survivor.id
        assert _wait(lambda: "service/CounterService" in survivor.srvmap, 10)
        c.close()
    finally:
        gate.stop()
        for g in (g1, g2):
            g.stop()
        disp.stop()


def test_gate_death_detaches_clients(tmp_path):
    disp, (g1, g2), gate = make_cluster(tmp_path)
    try:
        c = GameClientConnection(gate.addr)
        assert c.wait_for(lambda c: c.player is not None, 10)
        eid = c.player.id
        owner = g1 if g1.rt.entities.get(eid) else g2
        ent = owner.rt.entities.get(eid)
        assert ent is not None and _wait(lambda: ent.client is not None)

        gate.stop()  # abrupt: dispatcher sees the conn drop

        assert _wait(lambda: ent.client is None, 10), \
            "entity still bound to a client of the dead gate"
    finally:
        for g in (g1, g2):
            g.stop()
        disp.stop()


def test_heartbeat_timeout_kicks_silent_client(tmp_path):
    disp, (g1, g2), gate = make_cluster(tmp_path, hb="1")
    try:
        c = GameClientConnection(gate.addr)
        assert c.wait_for(lambda c: c.player is not None, 10)
        assert c.client_id in gate.clients
        # stay silent: no heartbeats -> the gate must kick us within ~2
        # timeout windows (its recv loop sees the close and drops the proxy)
        assert _wait(lambda: c.client_id not in gate.clients, 10), \
            "silent client never kicked"

        # an active client in the same gate must NOT be kicked
        c2 = GameClientConnection(gate.addr)
        assert c2.wait_for(lambda c: c.player is not None, 10)
        deadline = time.monotonic() + 3
        alive = True
        while time.monotonic() < deadline:
            c2.heartbeat()
            try:
                c2.poll(0.05)
            except (OSError, ValueError):
                alive = False
                break
            time.sleep(0.2)
        assert alive, "heartbeating client was kicked"
        c2.close()
    finally:
        gate.stop()
        for g in (g1, g2):
            g.stop()
        disp.stop()


def test_provider_link_drop_no_split_brain(tmp_path):
    """A service provider whose dispatcher link drops transiently must not
    keep a stale singleton claim: the dispatcher purges its registration,
    and on reconnect the snapshot prunes the provider's stale srvmap entry
    so reconciliation converges to exactly one live instance."""
    CounterService.created_on.clear()
    disp, (g1, g2), gate = make_cluster(tmp_path)
    try:
        assert _wait(lambda: len(CounterService.created_on) == 1)
        owner_gid = CounterService.created_on[0]
        owner, survivor = (g1, g2) if owner_gid == 1 else (g2, g1)

        # drop only the TCP link (process stays up; cluster auto-reconnects)
        conn = owner.cluster.conns[0]
        assert conn is not None
        conn.close()

        # dispatcher purges the registration; eventually the registry maps
        # the service again (either side may win the re-claim)
        assert _wait(
            lambda: "service/CounterService" in disp.srvdis
            and all("service/CounterService" in g.srvmap for g in (g1, g2)),
            20,
        ), "registry never reconverged after link drop"

        def live_instances():
            out = []
            for g in (g1, g2):
                for e in g.rt.entities.entities.values():
                    if e.type_name == "CounterService":
                        out.append((g.id, e.id))
            return out

        # converges to exactly one live instance, and every game's srvmap
        # points at it
        def consistent():
            inst = live_instances()
            if len(inst) != 1:
                return False
            gid, eid = inst[0]
            want = f"{gid}/{eid}"
            return all(
                g.srvmap.get("service/CounterService") == want
                for g in (g1, g2)
            )
        assert _wait(consistent, 20), (
            f"split brain persists: instances={live_instances()}, "
            f"maps={[g.srvmap.get('service/CounterService') for g in (g1, g2)]}"
        )
    finally:
        gate.stop()
        for g in (g1, g2):
            g.stop()
        disp.stop()


def test_reconnect_duplicate_entities_rejected(tmp_path):
    """Reconnect reconciliation (reference: DispatcherService.go:376-398):
    a game re-registering an entity id that the directory maps to another
    LIVE game gets it rejected and destroys its local duplicate; the
    legitimate owner keeps the id and its directory mapping."""
    disp, (g1, g2), gate = make_cluster(tmp_path)
    try:
        # legit entity on g1
        box = []
        g1.rt.post.post(
            lambda: box.append(g1.rt.entities.create("FDAvatar").id)
        )
        assert _wait(lambda: bool(box))
        eid = box[0]
        assert _wait(
            lambda: disp.entities.get(eid) is not None
            and disp.entities[eid].game_id == 1
        )

        # simulate a stale copy on g2 (e.g. left by a failed migration):
        # create it with directory notifications suppressed
        def stale():
            g2._registering_suppressed = True
            try:
                g2.rt.entities.create("FDAvatar", eid=eid)
            finally:
                g2._registering_suppressed = False
        g2.rt.post.post(stale)
        assert _wait(lambda: g2.rt.entities.get(eid) is not None)

        # force g2 to reconnect -> it re-registers its full entity list
        conn = g2.cluster.conns[0]
        assert conn is not None
        conn.close()

        # the duplicate is rejected and destroyed; g1 keeps the entity and
        # the directory still maps it to g1
        assert _wait(lambda: g2.rt.entities.get(eid) is None, 15), \
            "duplicate on game2 never destroyed"
        assert g1.rt.entities.get(eid) is not None
        assert _wait(
            lambda: disp.entities.get(eid) is not None
            and disp.entities[eid].game_id == 1
        )
    finally:
        gate.stop()
        for g in (g1, g2):
            g.stop()
        disp.stop()
