"""The port's cluster supervision against the JAX package's
(tests/test_cluster_supervision.py's scenarios on goworld_tpu_torch):
lease grant and epoch, renewal, expiry rehome and move replay, the
no-survivor drop, the disconnect failover, the zombie fence and its
readmission, leases off, the gate's heartbeat kick, the game's grant,
shutdown, rehome and replay handlers and the ``clu.*`` seams, counters
and span.  Everything runs on injected fake clocks with zero sleeps (the
``now`` seams).  Where the outcome is a value -- the packets the
dispatcher sends, the ``clu.*`` series -- each scenario runs in both
packages and the values are held equal.  The kill -9 scenario's twin is
tests/test_torch_cli.py's."""

import importlib
import inspect
import types

import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch import config as gwconfig
from goworld_tpu_torch import faults, telemetry
from goworld_tpu_torch.components.dispatcher.service import _Peer
from goworld_tpu_torch.components.game.service import GameService
from goworld_tpu_torch.components.gate.service import ClientProxy, GateService
from goworld_tpu_torch.engine.ids import fixed_id
from goworld_tpu_torch.netutil import Packet
from goworld_tpu_torch.proto import msgtypes as MT
from goworld_tpu_torch.telemetry import trace

DISP_CONFIG = """
[deployment]
dispatchers = 1
games = 2
gates = 1

[dispatcher1]
port = 0
lease_ttl_s = 2.0
"""

GATE_CONFIG = """
[deployment]
dispatchers = 1
games = 1
gates = 1

[dispatcher1]
port = 0

[gate1]
port = 0
heartbeat_timeout_s = 30
"""

GAME_CONFIG = """
[deployment]
dispatchers = 1
games = 1
gates = 1

[dispatcher1]
port = 0

[game_common]
aoi_backend = cpu
aoi_device = cpu
"""


def pkg(name):
    """The supervision modules of a package (the port or the JAX one)."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    disp = mod("components.dispatcher.service")
    return types.SimpleNamespace(
        config=mod("config"), Dispatcher=disp.DispatcherService,
        Peer=disp._Peer, fixed_id=mod("engine.ids").fixed_id,
        Packet=mod("netutil").Packet, MT=mod("proto.msgtypes"))


PORT, JAX = pkg("goworld_tpu_torch"), pkg("goworld_tpu")


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class StubPC:
    """Records packets instead of writing a socket."""

    def __init__(self):
        self.sent: list[bytes] = []
        self.closed = False

    def send_packet(self, p, release: bool = False):
        self.sent.append(bytes(p.payload))

    def flush(self):
        pass

    def close(self):
        self.closed = True


def _msgtypes(pc: StubPC) -> list[int]:
    return [Packet(bytearray(b)).read_u16() for b in pc.sent]


def make_disp(clock, p=PORT, text=DISP_CONFIG):
    return p.Dispatcher(1, p.config.loads(text), now=clock)


def register_game(disp, gid: int, eids: tuple = (), p=PORT):
    peer = p.Peer(StubPC())
    pkt = p.Packet.for_msgtype(p.MT.MT_SET_GAME_ID)
    pkt.append_u16(gid)
    pkt.append_bool(False)
    pkt.append_u32(len(eids))
    for eid in eids:
        pkt.append_entity_id(eid)
    disp._handle(peer, pkt)
    return peer


def renew(disp, peer, gid: int, epoch: int, spaces: tuple = (), p=PORT):
    pkt = p.Packet.for_msgtype(p.MT.MT_GAME_LEASE_RENEW)
    pkt.append_u16(gid)
    pkt.append_u32(epoch)
    pkt.append_u32(len(spaces))
    for sid in spaces:
        pkt.append_varstr(sid)
    disp._handle(peer, pkt)


def sync_packet(eids, p=PORT):
    pkt = p.Packet.for_msgtype(p.MT.MT_SYNC_POSITION_YAW_FROM_CLIENT)
    for eid in eids:
        pkt.append_entity_id(eid)
        pkt.append_bytes(b"\x00" * 16)
    return pkt


def lbc_packet(p=PORT):
    pkt = p.Packet.for_msgtype(p.MT.MT_GAME_LBC_INFO)
    pkt.append_f32(0.5)
    return pkt


def both(scenario):
    """``scenario(p)`` in the port and in the JAX package."""
    return scenario(PORT), scenario(JAX)


# -- dispatcher: lease grant / renewal ---------------------------------------


def test_registration_grants_lease_and_epoch():
    clock = FakeClock()
    disp = make_disp(clock)
    peer = register_game(disp, 1, (fixed_id("e1"),))
    gi = disp.games[1]
    assert gi.epoch == 1 and peer.epoch == 1
    assert gi.lease_deadline == clock() + 2.0
    grants = [b for b in peer.pc.sent
              if Packet(bytearray(b)).read_u16() == MT.MT_GAME_LEASE_GRANT]
    assert len(grants) == 1
    g = Packet(bytearray(grants[0]))
    g.read_u16()
    assert g.read_u32() == 1
    assert g.read_f32() == pytest.approx(2.0)
    # the game hears the same bytes from either package's dispatcher
    got, want = both(lambda p: register_game(
        make_disp(FakeClock(), p), 1, (p.fixed_id("e1"),), p).pc.sent)
    assert got == want


def test_renewal_refreshes_deadline_and_space_inventory():
    clock = FakeClock()
    disp = make_disp(clock)
    peer = register_game(disp, 1)
    clock.advance(1.5)
    renew(disp, peer, 1, epoch=1, spaces=("s1", "s2"))
    gi = disp.games[1]
    assert gi.lease_deadline == clock() + 2.0
    assert gi.spaces == ("s1", "s2")
    assert disp.clu_stats["leases"] == 1
    # a stale-epoch renewal (zombie racing its own failover) must not
    # resurrect the lease
    clock.advance(1.0)
    before = gi.lease_deadline
    renew(disp, peer, 1, epoch=99, spaces=("s1",))
    assert gi.lease_deadline == before
    assert disp.clu_stats["leases"] == 1


def test_sweep_keeps_live_lease():
    clock = FakeClock()
    disp = make_disp(clock)
    register_game(disp, 1)
    clock.advance(1.9)
    disp._sweep_leases(clock())
    assert disp.clu_stats["failovers"] == 0
    assert disp.games[1].conn is not None


# -- dispatcher: expiry -> failover orchestration ----------------------------


def expiry_scenario(p):
    clock = FakeClock()
    disp = make_disp(clock, p)
    e1, e2 = p.fixed_id("fo:e1"), p.fixed_id("fo:e2")
    p1 = register_game(disp, 1, (e1, e2), p)
    renew(disp, p1, 1, epoch=1, spaces=("w1",), p=p)
    p2 = register_game(disp, 2, (p.fixed_id("fo:s1"),), p)
    renew(disp, p2, 2, epoch=1, spaces=("w2",), p=p)
    # a gate-style peer feeds client movement; the dispatcher buffers the
    # regrouped per-game batch even though delivery succeeds
    gate = p.Peer(StubPC())
    disp._handle(gate, sync_packet((e1, e2), p))
    buffered = len(disp._move_buffer[1])
    clock.advance(1.5)
    renew(disp, p2, 2, epoch=1, spaces=("w2",), p=p)  # survivor stays live
    n_before = len(p2.pc.sent)
    clock.advance(1.0)  # game1 now 2.5 past its last renewal
    disp._sweep_leases(clock())
    return disp, (e1, e2), buffered, p2.pc.sent[n_before:]


def test_lease_expiry_rehomes_spaces_and_replays_moves():
    disp, (e1, e2), buffered, new_sent = expiry_scenario(PORT)
    assert buffered == 1
    assert disp.clu_stats["failovers"] == 1
    assert disp.clu_stats["replayed_moves"] == 1
    gi1 = disp.games[1]
    assert gi1.conn is None and gi1.epoch == 2 and gi1.spaces == ()
    assert 1 not in disp._move_buffer
    # directory re-pointed to the survivor
    assert disp.entities[e1].game_id == 2
    assert disp.entities[e2].game_id == 2
    # survivor hears the death, then gets rehome then replay, in that order
    new = [Packet(bytearray(b)) for b in new_sent]
    kinds = [p.read_u16() for p in new]
    assert kinds == [MT.MT_NOTIFY_GAME_DISCONNECTED, MT.MT_REHOME_SPACES,
                     MT.MT_REPLAY_MOVES]
    rehome, replay = new[1:]
    assert rehome.read_u16() == 1          # dead gid
    assert rehome.read_u32() == 2          # fencing epoch
    assert rehome.read_u32() == 1 and rehome.read_varstr() == "w1"
    assert replay.read_u16() == 1
    assert replay.read_u32() == 1
    inner = Packet(bytearray(replay.read_varbytes()))
    assert inner.read_u16() == MT.MT_SYNC_POSITION_YAW_FROM_CLIENT
    # the survivor's notice, rehome and replay are the JAX dispatcher's
    # bytes for bytes
    assert new_sent == expiry_scenario(JAX)[3]


def test_expiry_with_no_survivor_drops_entities():
    clock = FakeClock()
    disp = make_disp(clock)
    eid = fixed_id("lonely")
    register_game(disp, 1, (eid,))
    clock.advance(3.0)
    disp._sweep_leases(clock())
    assert eid not in disp.entities
    assert disp.games[1].conn is None


def test_disconnect_with_leases_armed_fails_over_immediately():
    """SIGKILL shows up as a TCP EOF long before the lease expires --
    the disconnect path must run the same orchestration."""
    clock = FakeClock()
    disp = make_disp(clock)
    eid = fixed_id("dc:e1")
    p1 = register_game(disp, 1, (eid,))
    renew(disp, p1, 1, epoch=1, spaces=("w1",))
    register_game(disp, 2)
    disp._on_disconnect(p1)
    assert disp.clu_stats["failovers"] == 1
    assert disp.entities[eid].game_id == 2


# -- dispatcher: zombie fencing (the split-brain kill switch) ----------------


def _fail_over_with_zombie(p=PORT):
    clock = FakeClock()
    disp = make_disp(clock, p)
    eid = p.fixed_id("z:e1")
    zombie = register_game(disp, 1, (eid,), p)
    renew(disp, zombie, 1, epoch=1, spaces=("w1",), p=p)
    clock.advance(1.5)
    survivor = register_game(disp, 2, p=p)  # fresh lease: expires at +3.5
    clock.advance(1.0)  # zombie now 2.5 past its renewal, survivor live
    disp._sweep_leases(clock())
    assert disp.clu_stats["failovers"] == 1
    return disp, zombie, survivor, eid


def test_zombie_resume_is_fenced_and_told_to_die():
    """A game that stalls past lease expiry, loses its spaces, then
    resumes: every packet it sends is dropped at the fence, counted, and
    answered (once) with MT_GAME_SHUTDOWN -- no double-delivered events."""
    disp, zombie, survivor, eid = _fail_over_with_zombie()
    n_survivor = len(survivor.pc.sent)
    disp._handle(zombie, lbc_packet())
    assert disp.clu_stats["fenced_packets"] == 1
    assert _msgtypes(zombie.pc).count(MT.MT_GAME_SHUTDOWN) == 1
    # a second packet is still fenced but the shutdown notice is not
    # repeated
    dead = Packet.for_msgtype(MT.MT_NOTIFY_DESTROY_ENTITY)
    dead.append_entity_id(eid)
    disp._handle(zombie, dead)
    assert disp.clu_stats["fenced_packets"] == 2
    assert _msgtypes(zombie.pc).count(MT.MT_GAME_SHUTDOWN) == 1
    # the fenced destroy never reached a handler: the directory entry the
    # survivor now owns is intact (no double-applied event)
    assert disp.entities[eid].game_id == 2
    # nothing was forwarded to the survivor
    assert len(survivor.pc.sent) == n_survivor

    def zombie_hears(p):
        d, z, _s, _e = _fail_over_with_zombie(p)
        d._handle(z, lbc_packet(p))
        return z.pc.sent

    got, want = both(zombie_hears)
    assert got == want


def test_zombie_reregistration_is_the_readmission_path():
    """MT_SET_GAME_ID is exempt from the fence: a restarted process
    re-registers, gets a fresh epoch, and its packets flow again."""
    disp, zombie, survivor, eid = _fail_over_with_zombie()
    lbc = lbc_packet()
    disp._handle(zombie, lbc)
    assert disp.clu_stats["fenced_packets"] == 1
    reborn = register_game(disp, 1)
    gi = disp.games[1]
    assert gi.epoch == 3 and reborn.epoch == 3  # register, failover, register
    renew(disp, reborn, 1, epoch=3, spaces=("w1",))
    assert disp.clu_stats["leases"] == 2
    disp._handle(reborn, lbc)  # no longer fenced
    assert disp.clu_stats["fenced_packets"] == 1


def test_leases_off_means_no_fence_no_buffer():
    disp = make_disp(FakeClock(), text=DISP_CONFIG.replace(
        "lease_ttl_s = 2.0", ""))
    eid = fixed_id("off:e1")
    peer = register_game(disp, 1, (eid,))
    assert disp.games[1].epoch == 0
    assert MT.MT_GAME_LEASE_GRANT not in _msgtypes(peer.pc)
    disp._handle(_Peer(StubPC()), sync_packet((eid,)))
    assert disp._move_buffer == {}


# -- telemetry: counters + span names ----------------------------------------

CLU_NAMES = ("clu.leases", "clu.failovers", "clu.fenced_packets",
             "clu.replayed_moves")


def clu_series(name):
    """The dispatcher's ``clu.*`` counters in package ``name``: name, kind
    and help (values aside: they count the process's history)."""
    disp = importlib.import_module(f"{name}.components.dispatcher.service")
    return sorted((m.name, type(m).__name__, m.help) for m in (
        disp._LEASES, disp._FAILOVERS, disp._FENCED, disp._REPLAYED))


def test_clu_telemetry_counters_and_failover_span():
    reg = telemetry.registry()
    base = {n: reg.counter(n).value for n in CLU_NAMES}
    telemetry.enable()
    try:
        disp, zombie, survivor, eid = _fail_over_with_zombie()
        disp._handle(zombie, lbc_packet())
        assert reg.counter("clu.leases").value == base["clu.leases"] + 1
        assert reg.counter("clu.failovers").value == \
            base["clu.failovers"] + 1
        assert reg.counter("clu.fenced_packets").value == \
            base["clu.fenced_packets"] + 1
        assert reg.counter("clu.replayed_moves").value == \
            base["clu.replayed_moves"]  # no client movement was buffered
        assert "clu.failover" in [s[0] for s in trace.spans()]
    finally:
        telemetry.disable()
    # the JAX package's names, kinds and help
    got = clu_series("goworld_tpu_torch")
    assert got == clu_series("goworld_tpu")
    assert [name for name, *_ in got] == sorted(CLU_NAMES)


# -- gate: heartbeat kick on the injected clock (zero sleeps) ----------------


def test_gate_heartbeat_kick_rides_fake_clock():
    clock = FakeClock()
    cfg = gwconfig.loads(GATE_CONFIG)
    gate = GateService(1, cfg, now=clock)
    pc = StubPC()
    cp = ClientProxy(pc, gate)
    gate.clients[cp.client_id] = cp
    assert cp.last_heartbeat == 100.0  # stamped from the seam, not wall time
    clock.advance(29.0)
    gate._kick_dead_clients(clock())
    assert not pc.closed
    # a heartbeat refreshes the stamp on the same clock
    gate._handle_client_packet(cp, Packet.for_msgtype(MT.MT_HEARTBEAT))
    assert cp.last_heartbeat == clock()
    clock.advance(29.5)
    gate._kick_dead_clients(clock())
    assert not pc.closed
    clock.advance(1.0)
    gate._kick_dead_clients(clock())
    assert pc.closed


# -- game side: grant / shutdown / rehome / replay handlers ------------------


@pytest.fixture
def game(tmp_path):
    cfg = gwconfig.loads(GAME_CONFIG)
    return GameService(1, cfg, freeze_dir=str(tmp_path))


def test_game_applies_grant_and_renews_through_cluster(game):
    grant = Packet.for_msgtype(MT.MT_GAME_LEASE_GRANT)
    grant.append_u32(7)
    grant.append_f32(0.9)
    game._handle(grant, disp_index=0)
    assert game._lease_epochs == {0: 7}
    assert game._renew_every == pytest.approx(0.3)  # ttl / 3
    sent = []

    class _Conn:
        def send_game_lease_renew(self, gid, epoch, sids):
            sent.append((gid, epoch, tuple(sids)))

    game.cluster.conns[0] = _Conn()
    game._renew_leases()
    assert sent == [(1, 7, ())]


def test_game_shutdown_notice_stops_without_saving(game):
    game._handle(Packet.for_msgtype(MT.MT_GAME_SHUTDOWN))
    assert game.shutdown_notice
    assert game._stop.is_set()


def test_rehome_without_checkpoint_counts_failures(game):
    assert game.rt.checkpoint is None
    p = Packet.for_msgtype(MT.MT_REHOME_SPACES)
    p.append_u16(2)
    p.append_u32(3)
    p.append_u32(2)
    p.append_varstr("w1")
    p.append_varstr("w2")
    game._handle(p)
    assert game.rehome_failures == 2
    assert game.rehomed == {}


def test_replay_moves_reenters_handler(game):
    p = Packet.for_msgtype(MT.MT_REPLAY_MOVES)
    p.append_u16(2)
    p.append_u32(2)
    for _ in range(2):
        inner = Packet.for_msgtype(MT.MT_SYNC_POSITION_YAW_FROM_CLIENT)
        p.append_varbytes(bytes(inner.payload))
    game._handle(p)
    assert game.replayed_batches == 2


# -- fault seams: the clu.* family is injectable -----------------------------


def test_clu_seam_family_in_catalog():
    from goworld_tpu import faults as jax_faults

    for seam in ("clu.lease", "clu.kill", "clu.zombie", "clu.restore"):
        assert seam in faults.SEAMS, seam
        assert faults.SEAMS[seam] == jax_faults.SEAMS[seam], seam


def test_clu_zombie_seam_stalls_game_handler(game):
    """A stall on clu.zombie parks the logic thread mid-loop -- the
    mechanism the end-to-end zombie test uses to outlive its lease."""
    plan = faults.FaultPlan()
    plan.add("clu.zombie", "stall", at=1, arg=0.001)
    faults.install(plan)
    try:
        game._handle(Packet.for_msgtype(MT.MT_GAME_SHUTDOWN))
        assert [(f["seam"], f["kind"]) for f in plan.fired] == [
            ("clu.zombie", "stall")]
    finally:
        faults.clear()
    assert game.shutdown_notice


def test_clu_lease_seam_fails_renewal(game):
    plan = faults.FaultPlan()
    plan.add("clu.lease", "fail", at=1)
    faults.install(plan)
    try:
        with pytest.raises(faults.InjectedFault):
            game._renew_leases()
    finally:
        faults.clear()


def test_clu_restore_seam_counts_as_rehome_failure():
    """clu.restore failures must degrade to a counted per-space failure,
    not a crashed survivor -- checked end-to-end by the failover
    scenario; here the catalog entry is pinned."""
    assert "restore" in faults.SEAMS["clu.restore"] or faults.SEAMS["clu.restore"]


def test_clu_kill_seam_reaches_scenario_driver():
    from goworld_tpu_torch.engine import failover

    src = inspect.getsource(failover)
    assert 'faults.check("clu.kill")' in src
