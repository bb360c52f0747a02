"""The port's lazy interest sets against the JAX package's
(tests/test_lazy_interests.py's scenarios on goworld_tpu_torch): PLAIN
entities (no client, default AOI hooks) keep their interest state in the
calculator's packed words and derive it on demand; entities with clients
or hooks keep eager sets, and the two views agree through client attach
and detach, churn, the pipelined mirror's clear and slot reuse, and a
space opting out of the event stream.  The reference's backends ``cpu``
/ ``cpp`` / ``tpu`` are the port's ``cpu`` / ``cpp`` / ``cuda`` on
``device="cpu"`` (the step kernel's plain version).  Under churn the
derived neighbours are also held to the JAX package's on the same seeded
walk."""

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from goworld_tpu_torch.engine.entity import Entity, GameClient
from goworld_tpu_torch.engine.runtime import Runtime
from goworld_tpu_torch.engine.space import Space
from goworld_tpu_torch.engine.vector import Vector3


class Scene(Space):
    pass


class Mob(Entity):  # plain: default hooks, no client
    use_aoi = True
    aoi_distance = 50.0


class Watcher(Entity):  # non-plain: overridden hooks
    use_aoi = True
    aoi_distance = 50.0

    def on_init(self):
        self.seen = []

    def on_enter_aoi(self, other):
        self.seen.append(other.id)


def jax_types():
    """Scene, Mob and Watcher over the JAX package's engine."""
    from goworld_tpu.engine.entity import Entity as JaxEntity
    from goworld_tpu.engine.space import Space as JaxSpace

    class Scene(JaxSpace):
        pass

    class Mob(JaxEntity):
        use_aoi = True
        aoi_distance = 50.0

    class Watcher(JaxEntity):
        use_aoi = True
        aoi_distance = 50.0

        def on_init(self):
            self.seen = []

        def on_enter_aoi(self, other):
            self.seen.append(other.id)

    return Scene, Mob, Watcher


def build(backend, jax=False):
    if jax:
        from goworld_tpu.engine.runtime import Runtime as JaxRuntime

        rt = JaxRuntime(aoi_backend=backend)
        for cls in jax_types():
            rt.entities.register(cls)
    else:
        rt = Runtime(aoi_backend=backend, device="cpu")
        rt.entities.register(Scene)
        rt.entities.register(Mob)
        rt.entities.register(Watcher)
    sp = rt.entities.create_space("Scene", kind=1)
    sp.enable_aoi(50.0)
    return rt, sp


@pytest.mark.parametrize("backend", ["cpu", "cpp", "cuda"])
def test_plain_neighbors_derive_from_packed_words(backend):
    rt, sp = build(backend)
    a = rt.entities.create("Mob", space=sp, pos=Vector3(0, 0, 0))
    b = rt.entities.create("Mob", space=sp, pos=Vector3(10, 0, 10))
    c = rt.entities.create("Mob", space=sp, pos=Vector3(500, 0, 500))
    rt.tick()
    # plain entities: eager sets stay EMPTY, neighbors() derives
    assert a.interested_in == set() and a.interested_by == set()
    assert set(a.neighbors()) == {b}
    assert set(b.neighbors()) == {a}
    assert set(c.neighbors()) == set()
    assert set(a.observers()) == {b}
    # movement updates the derived view
    c.set_position(Vector3(20, 0, 20))
    rt.tick()
    assert set(a.neighbors()) == {b, c}
    assert set(c.neighbors()) == {a, b}
    # departure clears the packed state synchronously
    b.destroy()
    assert set(a.neighbors()) == {c}


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_client_attach_materializes_and_detach_dematerializes(backend):
    rt, sp = build(backend)
    a = rt.entities.create("Mob", space=sp, pos=Vector3(0, 0, 0))
    b = rt.entities.create("Mob", space=sp, pos=Vector3(10, 0, 10))
    rt.tick()
    assert a.interested_in == set()

    cli = GameClient("c1")
    a.set_client(cli)
    # materialized: eager sets now live, neighbor created on the client
    assert a.interested_in == {b} and b.interested_by == {a}
    assert b._watcher_clients == 1
    creates = [op for op in cli.outbox if op[0] == "create_entity"]
    assert {op[2] for op in creates} == {a.id, b.id}

    # while clienty, replay is eager: c walks in -> create op + sets update
    c = rt.entities.create("Mob", space=sp, pos=Vector3(5, 0, 5))
    rt.tick()
    assert c in a.interested_in and c._watcher_clients == 1
    assert any(op[0] == "create_entity" and op[2] == c.id
               for op in cli.outbox)

    a.set_client(None)
    # dematerialized: back to packed-only
    assert a.interested_in == set()
    assert b.interested_by == set() and b._watcher_clients == 0
    assert set(a.neighbors()) == {b, c}

    # subsequent moves keep the derived view correct with no eager state
    c.set_position(Vector3(500, 0, 500))
    rt.tick()
    assert set(a.neighbors()) == {b}


def test_mixed_plain_and_watcher_pairs():
    rt, sp = build("cpu")
    w = rt.entities.create("Watcher", space=sp, pos=Vector3(0, 0, 0))
    m = rt.entities.create("Mob", space=sp, pos=Vector3(10, 0, 10))
    rt.tick()
    # watcher is eager (hook fired, sets maintained); mob derives
    assert w.seen == [m.id]
    assert w.interested_in == {m}
    assert m.interested_by == {w}  # non-plain observers ARE tracked on m
    assert m.interested_in == set()
    assert set(m.neighbors()) == {w}
    # mob leaving severs the watcher's eager state synchronously
    m.destroy()
    assert w.interested_in == set()


def test_derived_matches_eager_under_churn():
    """Drive identical scenarios with a plain type and a hooked type; the
    plain side's derived neighbor sets must equal the hooked side's eager
    sets every tick."""
    rng = np.random.default_rng(4)
    pos0 = rng.uniform(0, 200, (40, 2))
    rts = {}
    ents = {}
    for kind, tname, jax in (("plain", "Mob", False),
                             ("eager", "Watcher", False),
                             ("jax", "Mob", True)):
        rt, sp = build("cpu", jax)
        es = [rt.entities.create(tname, space=sp,
                                 pos=Vector3(pos0[i, 0], 0, pos0[i, 1]))
              for i in range(40)]
        rts[kind] = rt
        ents[kind] = es
    rng = np.random.default_rng(9)
    for _t in range(4):
        moves = rng.uniform(-40, 40, (40, 2))
        for kind in rts:
            for e, d in zip(ents[kind], moves):
                e.set_position(Vector3(e.position.x + d[0], 0,
                                       e.position.z + d[1]))
            rts[kind].tick()
        for i in range(40):
            derived = {ents["plain"].index(n) for n in
                       ents["plain"][i].neighbors()}
            eager = {ents["eager"].index(n) for n in
                     ents["eager"][i].interested_in}
            assert derived == eager, f"slot {i} diverged"
            want = {ents["jax"].index(n) for n in
                    ents["jax"][i].neighbors()}
            assert derived == want, f"slot {i} diverged from JAX's"


def test_pipelined_mirror_survives_clear_ordering():
    """A clear_entity issued while a tick is in flight postdates that tick's
    change stream; the mirror must apply stream-then-clear, or the harvest
    XOR re-plants the bits the clear removed (ghost interests forever)."""
    from goworld_tpu_torch.engine.aoi import AOIEngine

    eng = AOIEngine(default_backend="cuda", pipeline=True, device="cpu")
    h = eng.create_space(128)
    x = np.array([0.0, 5.0], np.float32)
    r = np.full(2, 50, np.float32)
    act = np.ones(2, bool)
    b = h.bucket
    b.peek_words(h.slot)  # enable the mirror BEFORE any traffic
    eng.submit(h, x, x, r, act)
    eng.flush()  # enter pair dispatched, in flight
    # entity 1 departs before the harvest
    eng.clear_entity(h, 1)
    act2 = act.copy()
    act2[1] = False
    eng.submit(h, x, x, r, act2)
    eng.flush()  # harvests tick 1's stream, then the clear must re-apply
    eng.flush()  # trailing harvest
    words = b.peek_words(h.slot)
    assert not words.any(), (
        "ghost interest bits survived the in-flight clear: %r"
        % words[words != 0])


def test_pipelined_mirror_reset_on_slot_reuse():
    """A slot released and re-acquired while a tick is in flight: the new
    occupant must never see the dead space's interest words (the reset
    applies to the mirror immediately), and the dead epoch's in-flight
    change stream must not XOR back into the reset mirror at harvest."""
    from goworld_tpu_torch.engine.aoi import AOIEngine

    eng = AOIEngine(default_backend="cuda", pipeline=True, device="cpu")
    h = eng.create_space(128)
    b = h.bucket
    b.peek_words(h.slot)  # enable the mirror BEFORE any traffic
    x = np.array([0.0, 5.0], np.float32)
    r = np.full(2, 50, np.float32)
    act = np.ones(2, bool)
    eng.submit(h, x, x, r, act)
    eng.flush()  # tick 1 in flight, carrying the dead pair's change stream
    old_slot = h.slot
    eng.release_space(h)
    h2 = eng.create_space(128)
    assert h2.slot == old_slot, "expected slot reuse"
    assert not b.peek_words(h2.slot).any(), (
        "dead space's words visible to the new occupant before harvest")
    # new occupant: entities far apart -- its true interest words are zero,
    # so any leaked dead-epoch XOR (the 0<->1 pair bits) is visible
    x2 = np.array([900.0, 2000.0], np.float32)
    eng.submit(h2, x2, x2, r, act)
    eng.flush()   # harvests the dead tick; its stream must be dropped
    b.drain()
    words = b.peek_words(h2.slot)
    assert not words.any(), (
        "dead epoch's stream XORed into the reused slot's mirror: %r"
        % words[words != 0])


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_all_plain_space_unsubscribes_from_event_stream(backend):
    """Engine-integrated: a space whose entities
    are all plain opts out of the calculator's event stream (device
    backends then skip its extraction/fetch/decode); interest state still
    derives correctly, and a client entering re-subscribes the space so
    eager replay resumes."""
    rt, sp = build(backend)
    a = rt.entities.create("Mob", space=sp, pos=Vector3(0, 0, 0))
    b = rt.entities.create("Mob", space=sp, pos=Vector3(10, 0, 10))
    rt.tick()
    h = sp._aoi_handle
    # all-plain -> unsubscribed at the bucket (cpu backends accept the call
    # and ignore it; the cuda bucket masks the slot out of the stream)
    assert not sp._aoi_subscribed
    if backend == "cuda":
        assert h.slot in h.bucket._unsub
    # derivation still exact while unsubscribed
    b.set_position(Vector3(5, 0, 5))
    rt.tick()
    assert set(a.neighbors()) == {b}
    assert set(b.neighbors()) == {a}

    # a client attaches: materialize + re-subscribe; eager replay resumes
    cli = GameClient("c1")
    a.set_client(cli)
    assert a.interested_in == {b}
    c = rt.entities.create("Mob", space=sp, pos=Vector3(8, 0, 8))
    rt.tick()
    assert sp._aoi_subscribed
    if backend == "cuda":
        assert h.slot not in h.bucket._unsub
    assert c in a.interested_in, "event replay dead after re-subscribe"
    assert any(op[0] == "create_entity" and op[2] == c.id
               for op in cli.outbox)

    # client detaches: space returns to packed-only and opts back out
    a.set_client(None)
    c.set_position(Vector3(400, 0, 400))
    rt.tick()
    assert not sp._aoi_subscribed
    assert set(a.neighbors()) == {b}
