"""The port's cross-game GiveClientTo against the JAX package's
(tests/test_give_client_to.py's scenarios on goworld_tpu_torch): the
Account boots on one game, the Avatar is created on the other, and after
the handoff the same client connection drives the Avatar (its rpc
answers, the gate switched the owner, the account died); a handoff that
races ahead of its target's registration parks at the dispatcher and
lands once the target registers; a parked handoff that expires kicks the
stranded client.  The games run the cpu calculator on ``aoi_device =
cpu``."""

import time

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch import config as gwconfig
from goworld_tpu_torch.client import GameClientConnection
from goworld_tpu_torch.components.dispatcher.service import DispatcherService
from goworld_tpu_torch.components.game.service import GameService
from goworld_tpu_torch.components.gate.service import GateService
from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.rpc import OWN_CLIENT, rpc

CONFIG = """
[deployment]
dispatchers = 1
games = 2
gates = 1

[dispatcher1]
port = 0

[game_common]
boot_entity = HandoffAccount
aoi_backend = cpu
aoi_device = cpu

[gate1]
port = 0
heartbeat_timeout_s = 0
"""


class HandoffAccount(Entity):
    died = []

    @rpc(expose=OWN_CLIENT)
    def do_handoff(self, avatar_eid):
        self.give_client_to(avatar_eid)

    def on_client_disconnected(self):
        HandoffAccount.died.append(self.id)
        self.destroy()


class HandoffAvatar(Entity):
    client_attrs = frozenset({"name"})

    def on_created(self):
        self.attrs.set("name", "ava")

    @rpc(expose=OWN_CLIENT)
    def ping(self, text):
        self.call_client("pong", text)


@pytest.fixture()
def cluster(tmp_path):
    HandoffAccount.died = []
    cfg = gwconfig.loads(CONFIG)
    disp = DispatcherService(1, cfg).start()
    cfg.dispatchers[1].host, cfg.dispatchers[1].port = disp.addr
    games = []
    for gid in (1, 2):
        gs = GameService(gid, cfg, freeze_dir=str(tmp_path))
        gs.register_entity_type(HandoffAccount)
        gs.register_entity_type(HandoffAvatar)
        gs.start()
        games.append(gs)
    gate = GateService(1, cfg).start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not all(
        g.deployment_ready for g in games
    ):
        time.sleep(0.01)
    assert all(g.deployment_ready for g in games)
    yield disp, games, gate
    gate.stop()
    for g in games:
        g.stop()
    disp.stop()


def _find_hosting_game(games, eid):
    for g in games:
        if g.rt.entities.get(eid) is not None:
            return g
    return None


def test_cross_game_give_client_to(cluster):
    disp, games, gate = cluster
    c = GameClientConnection(gate.addr)
    assert c.wait_for(lambda c: c.player is not None, 10.0), "no boot entity"
    account_id = c.player.id

    # find the game hosting the account; create the avatar on the OTHER one
    deadline = time.monotonic() + 5
    acc_game = None
    while time.monotonic() < deadline and acc_game is None:
        acc_game = _find_hosting_game(games, account_id)
        time.sleep(0.01)
    assert acc_game is not None
    other_game = games[1] if acc_game is games[0] else games[0]

    created = []
    other_game.rt.post.post(
        lambda: created.append(other_game.rt.entities.create("HandoffAvatar"))
    )
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not created:
        time.sleep(0.01)
    avatar_id = created[0].id
    assert _find_hosting_game(games, avatar_id) is other_game

    c.call_player("do_handoff", avatar_id)

    # the client's player must become the avatar (is_player create from the
    # other game flips the gate's owner and the client mirror)
    assert c.wait_for(
        lambda c: c.player is not None and c.player.id == avatar_id, 10.0
    ), f"player never switched to avatar: {c.player and c.player.id}"
    assert c.player.attrs.get("name") == "ava"

    # the same connection now drives the avatar on the other game
    c.call_player("ping", "across")
    assert c.wait_for(
        lambda c: ("pong", ("across",)) in c.player.calls, 10.0
    ), "rpc to the handed-off avatar never answered"

    # the account saw its client leave and destroyed itself
    assert c.wait_for(
        lambda _c: account_id in HandoffAccount.died
        and acc_game.rt.entities.get(account_id) is None,
        10.0,
    ), "account survived the handoff"

    # client disconnect now reaches the avatar's game: avatar learns it
    c.close()
    _wait_avatar_clientless(other_game, avatar_id)


def _wait_avatar_clientless(game, avatar_id):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        av = game.rt.entities.get(avatar_id)
        if av is not None and av.client is None:
            break
        time.sleep(0.01)
    av = game.rt.entities.get(avatar_id)
    assert av is not None and av.client is None, (
        "disconnect never reached the handed-off avatar"
    )


def test_handoff_parks_until_target_registers(cluster):
    """A handoff racing ahead of the target's directory registration must
    PARK at the dispatcher and replay on MT_NOTIFY_CREATE_ENTITY -- dropping
    it would strand the client (its old owner already detached)."""
    disp, games, gate = cluster
    c = GameClientConnection(gate.addr)
    assert c.wait_for(lambda c: c.player is not None, 10.0)
    account_id = c.player.id
    deadline = time.monotonic() + 5
    acc_game = None
    while time.monotonic() < deadline and acc_game is None:
        acc_game = _find_hosting_game(games, account_id)
        time.sleep(0.01)
    other_game = games[1] if acc_game is games[0] else games[0]

    # hand off to an eid that does NOT exist anywhere yet
    from goworld_tpu_torch.engine.ids import gen_id

    future_eid = gen_id()
    c.call_player("do_handoff", future_eid)
    # let the handoff reach the dispatcher and park
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not (
        disp.entities.get(future_eid) is not None
        and disp.entities[future_eid].pending
    ):
        time.sleep(0.01)
    assert disp.entities.get(future_eid) is not None, "handoff never parked"

    # now create the target; the parked handoff must replay onto it
    other_game.rt.post.post(
        lambda: other_game.rt.entities.create("HandoffAvatar", eid=future_eid)
    )
    assert c.wait_for(
        lambda c: c.player is not None and c.player.id == future_eid, 10.0
    ), "parked handoff never replayed to the late-registered target"
    c.call_player("ping", "late")
    assert c.wait_for(
        lambda c: ("pong", ("late",)) in c.player.calls, 10.0)
    c.close()


def test_expired_handoff_kicks_stranded_client(cluster, monkeypatch):
    """A parked handoff whose target never registers must not strand the
    client forever: on park expiry the dispatcher kicks the client at its
    gate (MT_KICK_CLIENT) so it can reconnect for a fresh boot entity."""
    import goworld_tpu_torch.components.dispatcher.service as dsvc

    # shrink the park window so the test observes expiry quickly
    monkeypatch.setattr(dsvc, "LOAD_BLOCK_TIMEOUT", 0.5)
    disp, games, gate = cluster
    c = GameClientConnection(gate.addr)
    assert c.wait_for(lambda c: c.player is not None, 10.0)

    from goworld_tpu_torch.engine.ids import gen_id

    c.call_player("do_handoff", gen_id())  # target will never exist
    # the park expires and the dispatcher kicks the connection: the client's
    # poll latches clean EOF into ``closed``
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not c.closed:
        c.poll(0.05)
    assert c.closed, "stranded client was never kicked after park expiry"
    c.close()
