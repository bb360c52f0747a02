"""The port's batched ingest, packets, scripted fleet and load harness
(goworld_tpu_torch.ingest, .netutil, .load) against the JAX package's.

Tolerance: exact equality.  The same packet bytes (entities created with
the same ids in both packages) land through both packages'
``MovementIngest``: the columns, the sync flags, the stats and the sync
records of the next tick are equal, batched, per-entity and under the
``aoi.ingest`` seam (any kind demotes a batch to the per-entity path).
The fleets and gate batches of one seed are byte-identical; a load
harness of 512 clients x 4 spaces reports the same counts and ends with
the same stack words as the JAX harness on the CPU (latencies are
host-clock and not compared).  ``Packet`` round trips its scalars and
writes the JAX package's bytes.
"""

import numpy as np
import pytest

from goworld_tpu import faults as jfaults
from goworld_tpu import ingest as JIN
from goworld_tpu import load as JL
from goworld_tpu.engine.entity import Entity as JEntity
from goworld_tpu.engine.entity import GameClient as JClient
from goworld_tpu.engine.runtime import Runtime as JRuntime
from goworld_tpu.engine.space import Space as JSpace
from goworld_tpu.engine.vector import Vector3 as JVector3
from goworld_tpu.netutil import Packet as JPacket
from goworld_tpu_torch import faults as tfaults
from goworld_tpu_torch import ingest as TIN
from goworld_tpu_torch import load as TL
from goworld_tpu_torch import telemetry
from goworld_tpu_torch.engine.entity import Entity, GameClient
from goworld_tpu_torch.engine.runtime import Runtime
from goworld_tpu_torch.engine.space import Space
from goworld_tpu_torch.engine.vector import Vector3
from goworld_tpu_torch.netutil import Packet
from goworld_tpu_torch.telemetry import trace
from torch_threads import one_intra_op_thread  # noqa: F401

N = 6


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


class Scene(Space):
    pass


class Walker(Entity):
    use_aoi = True
    aoi_distance = 25.0


class JScene(JSpace):
    pass


class JWalker(JEntity):
    use_aoi = True
    aoi_distance = 25.0


def _eid(i):
    return f"walker{i:010d}"


def _world(port, plan=None, **kw):
    """N client-syncing walkers with fixed ids and clients."""
    if port:
        rt = Runtime(device="cpu", aoi_backend="cpu", fault_plan=plan, **kw)
        classes, V, C = (Scene, Walker), Vector3, GameClient
    else:
        rt = JRuntime(aoi_backend="cpu", fault_plan=plan, **kw)
        classes, V, C = (JScene, JWalker), JVector3, JClient
    for cls in classes:
        rt.entities.register(cls, cls.__name__.lstrip("J"))
    sc = rt.entities.create_space("Scene", kind=1, eid="scene" + "0" * 11)
    sc.enable_aoi(25.0)
    es = []
    for i in range(N):
        e = rt.entities.create("Walker", space=sc, eid=_eid(i),
                               pos=V(i * 12.0, 0, i * 12.0))
        e.set_client_syncing(True)
        e.set_client(C(("c%02d" % i).ljust(16, "x")))
        es.append(e)
    return rt, sc, es


def _sync_bytes(t, late=None):
    """One gate flush: every walker moves (and ``late`` ids, if any)."""
    pkt = JPacket(bytearray())
    for j, eid in enumerate([_eid(i) for i in range(N)] + (late or [])):
        pkt.append_entity_id(eid)
        for v in (t * 7 + j * 3, 1.5, t * 5 + j * 2, 0.125 * j):
            pkt.append_f32(float(v))
    return bytes(pkt.buf)


def _drive(port, batched=True, ticks=5, plan=None, **kw):
    rt, sc, es = _world(port, plan, **kw)
    rt.tick()
    ing = (TIN if port else JIN).MovementIngest(rt)
    out, cols = [], []
    mod = TIN if port else JIN
    for t in range(ticks):
        buf = _sync_bytes(t)
        pkt = (Packet if port else JPacket)(bytearray(buf))
        if batched:
            assert ing.ingest(pkt) == N
        else:
            rec = np.frombuffer(buf, dtype=mod.SYNC_RECORD)
            assert mod.apply_per_entity(rt.entities, rec) == N
        c = sc._cols
        cols.append({k: getattr(c, k)[:N].copy()
                     for k in ("x", "y", "z", "yaw", "sync")})
        rt.tick()
        out.append(sorted(rt.drain_sync()))
    return out, cols, dict(ing.stats)


def test_ingest_matches_jax():
    """Batched land: columns and sync flags after the land, the next
    tick's sync records and the stats, equal to the JAX package's; the
    per-entity path gives the same records."""
    got, gcols, gst = _drive(True)
    want, wcols, wst = _drive(False)
    assert got == want and gst == wst
    for g, w in zip(gcols, wcols):
        for k in g:
            assert np.array_equal(g[k], w[k]), k
    assert gst["per_entity_writes"] == 0 and gst["batched"] == 5 * N
    assert any(sum(c["sync"]) for c in gcols)  # flagged before the drain
    per_ent, _, _ = _drive(True, batched=False)
    assert per_ent == got


@pytest.mark.parametrize("kind", ["oom", "fail", "stall", "poison"])
def test_ingest_seam_demotes_batch(kind):
    """Any ``aoi.ingest`` kind demotes one batch to the per-entity path in
    both packages; the records equal the clean run's."""
    clean, _, _ = _drive(True)
    plans = [m.FaultPlan(seed=3).add("aoi.ingest", kind, at=2, arg=0.001)
             for m in (tfaults, jfaults)]
    got, _, gst = _drive(True, plan=plans[0])
    want, _, wst = _drive(False, plan=plans[1])
    assert got == clean == want
    assert gst == wst
    assert gst["demoted_batches"] == 1 and gst["per_entity_writes"] == N


def test_mid_enter_and_unknown_records():
    """A slotless record falls back per entity; unknown and spaceless ids
    are dropped; duplicates: the last write wins."""
    rt, sc, es = _world(True)
    rt.tick()
    ing = TIN.MovementIngest(rt)
    stray = rt.entities.create("Walker", pos=Vector3(0, 0, 0), eid=_eid(90))
    stray.set_client_syncing(True)
    slot, es[1].aoi_slot = es[1].aoi_slot, -1
    buf = _sync_bytes(1, late=[_eid(90), _eid(91), _eid(0)])
    assert ing.ingest(Packet(bytearray(buf))) == N + 3
    assert ing.stats["per_entity_writes"] == 1
    assert ing.stats["batched"] == N  # es[0] twice, es[1] not
    assert es[1].position.x == pytest.approx(1 * 7 + 1 * 3)
    es[1].aoi_slot = slot
    assert sc._cols.x[es[0].aoi_slot] == np.float32(7 + (N + 2) * 3)
    assert stray.position.x == 0.0


def test_ingest_telemetry():
    reg = telemetry.registry()
    assert TIN.movement._INGEST_BYTES is reg.counter("aoi.ingest_bytes")
    assert TIN.movement._BATCHED_FRAC is reg.gauge("aoi.ingest_batched_frac")
    telemetry.enable()
    trace.reset()
    try:
        before = reg.counter("aoi.ingest_bytes").value
        _drive(True, ticks=2)
        assert "aoi.ingest" in {n for n, *_ in trace.spans()}
        assert reg.counter("aoi.ingest_bytes").value - before \
            == 2 * N * TIN.RECORD_SIZE
        assert reg.gauge("aoi.ingest_batched_frac").value == 1.0
    finally:
        telemetry.disable()
    assert TIN.SYNC_RECORD == JIN.SYNC_RECORD and TIN.RECORD_SIZE == 32


# -- packets -------------------------------------------------------------------


def test_packet_roundtrip_and_bytes():
    def fill(p):
        p.append_u8(0x1ff)
        p.append_u16(0xBEEF)
        p.append_u32(0xDEADBEEF)
        p.append_u64(2**63 + 5)
        p.append_f32(1.25)
        p.append_bool(True)
        p.append_entity_id(_eid(7))
        p.append_varstr("héllo")
        p.append_varbytes(b"\x00\x01")
        p.append_bytes(b"tail")
        return p

    t, j = fill(Packet.for_msgtype(42)), fill(JPacket.for_msgtype(42))
    assert t.payload == j.payload and len(t) == len(j)
    q = Packet(bytearray(t.payload))
    assert q.read_u16() == 42 and q.read_u8() == 0xff
    assert (q.read_u16(), q.read_u32(), q.read_u64()) == \
        (0xBEEF, 0xDEADBEEF, 2**63 + 5)
    assert q.read_f32() == 1.25 and q.read_bool() is True
    assert q.read_entity_id() == _eid(7)
    assert q.read_varstr() == "héllo" and q.read_varbytes() == b"\x00\x01"
    assert q.remaining() == 4 and bytes(q.read_view(4)) == b"tail"
    with pytest.raises(ValueError, match="underflow"):
        q.read_u8()
    with pytest.raises(ValueError, match="entity id"):
        Packet().append_entity_id("short")
    t.release()
    assert t.buf is None


# -- the fleet, the gate batches, the harness -------------------------------


def test_fleet_and_gate_batches_match_jax():
    a, b = TL.ScriptedFleet(64, seed=3), JL.ScriptedFleet(64, seed=3)
    eids = [_eid(i) for i in range(64)]
    ta, jb = TL.GateBatcher(eids, 3), JL.GateBatcher(eids, 3)
    for _ in range(5):
        a.step()
        b.step()
        for k in ("x", "z", "y", "yaw"):
            assert np.array_equal(getattr(a, k), getattr(b, k))
        assert ta.batches(a) == jb.batches(b)
    assert np.abs(a.x).max() <= a.world_half + a.speed


def test_harness_matches_jax():
    """512 clients x 4 spaces, period 4, 9 ticks: the report's counts,
    the stacks' stats and final words equal the JAX harness's (its host
    mode on the CPU); the port's stacks step on device="cpu"."""
    period, ticks = 4, 9
    hz = TL.LoadHarness(512, n_spaces=4, n_gates=4, period=period, seed=11,
                        device="cpu")
    jz = JL.LoadHarness(512, n_spaces=4, n_gates=4, period=period, seed=11,
                        interest_mode="host")
    assert all(sp.interest_stack.mode == "device" for sp in hz.spaces)
    got, want = hz.run(ticks), jz.run(ticks)
    for k in ("clients", "spaces", "period", "ticks", "records",
              "unclosed", "ingest", "interest"):
        assert got[k] == want[k], k
    for tier in ("near", "far"):
        assert got["tiers"][tier]["n"] == want["tiers"][tier]["n"] > 0
    assert got["ingest"]["per_entity_writes"] == 0
    assert got["unclosed"] == 0 and got["interest"]["demotions"] == 0
    assert got["interest"]["full_evals"] == 4 * 3
    for a, b in zip(hz.spaces, jz.spaces):
        assert np.array_equal(a.interest_stack.words, b.interest_stack.words)
        assert np.array_equal(a.interest_stack.near, b.interest_stack.near)


def test_harness_host_mode_and_cuda_backend_equal():
    """The same harness with host-mode stacks, and with the base state on
    the ``cuda`` calculator: the stacks' words do not depend on either."""
    runs = [TL.LoadHarness(256, n_spaces=2, period=2, seed=5, device="cpu",
                           **kw) for kw in ({}, {"interest_mode": "host"},
                                            {"aoi_backend": "cuda"})]
    reps = [h.run(5) for h in runs]
    for h, rep in zip(runs[1:], reps[1:]):
        assert rep["interest"] == reps[0]["interest"]
        for a, b in zip(runs[0].spaces, h.spaces):
            assert np.array_equal(a.interest_stack.words,
                                  b.interest_stack.words)


def test_load_telemetry_names_registered():
    from goworld_tpu_torch.load import harness as hz

    reg = telemetry.registry()
    assert hz._LOAD_CLIENTS is reg.gauge("load.clients")
    assert hz._LOAD_MOVES is reg.counter("load.moves")
