"""The port's mesh bucket (goworld_tpu_torch.engine.aoi_mesh on 8 virtual
CPU shards: the plain step under the sharded codec) against the JAX
package's _MeshTPUBucket on its 8-device CPU mesh and its CPU oracle.
Tolerance: exact equality of every tick's enter/leave arrays, of the
final interest words and of the counted overflow recoveries."""

import numpy as np
import pytest

from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.parallel import SpaceMesh as JaxMesh
from goworld_tpu.parallel import multichip_devices as jax_devices
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.engine.aoi_mesh import _MeshCUDABucket
from goworld_tpu_torch.ops import aoi_cuda as AK
from goworld_tpu_torch.parallel import SpaceMesh
from torch_threads import one_intra_op_thread  # noqa: F401

N_DEV = 8


def walk(seed, cap, n, ticks, world=700.0, radius=50.0):
    """Per tick (x, z, r, act) of ``n`` entities with varied radii (the
    JAX mesh tests' walk, in a smaller world)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, world, n).astype(np.float32)
    z = rng.uniform(0, world, n).astype(np.float32)
    r = rng.uniform(0.5 * radius, 1.5 * radius, n).astype(np.float32)
    act = rng.random(n) < 0.95
    out = []
    for _ in range(ticks):
        x = np.clip(x + rng.uniform(-20, 20, n), 0, world).astype(np.float32)
        z = np.clip(z + rng.uniform(-20, 20, n), 0, world).astype(np.float32)
        out.append((x.copy(), z.copy(), r, act))
    return out


def engines(jax_mesh=True, **port_kw):
    engs = {"port": AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * N_DEV),
                              **port_kw),
            "cpu": JaxEngine(default_backend="cpu")}
    if jax_mesh:
        engs["mesh"] = JaxEngine(default_backend="tpu",
                                 mesh=JaxMesh(jax_devices(N_DEV)))
    return engs


def tick(engs, hs, inputs, t=0):
    """Submit per-space inputs (None = not staged) to every engine, flush,
    and assert every engine's events equal the oracle's; returns them."""
    evs = {}
    for k, e in engs.items():
        for h, a in zip(hs[k], inputs):
            if a is not None:
                e.submit(h, *a)
        e.flush()
        evs[k] = [e.take_events(h) for h in hs[k]]
    for k, got in evs.items():
        for s, ((ge, gl), (ce, cl)) in enumerate(zip(got, evs["cpu"])):
            np.testing.assert_array_equal(ge, ce, err_msg=f"{k} t={t} s={s}")
            np.testing.assert_array_equal(gl, cl, err_msg=f"{k} t={t} s={s}")
    return evs["cpu"]


@pytest.mark.parametrize("emit,sched,jax_mesh,delta", [
    ("native", True, True, True), ("vector", False, False, False)])
def test_mesh_parity_per_tick(emit, sched, jax_mesh, delta):
    """8 spaces of cap 256 on 8 shards, 5 ticks, one space sitting a tick
    out (its cached inputs re-step silently), the last ticks moving 5% of
    the entities (sparse delta packets); the overflow recoveries and final
    words equal the JAX mesh bucket's."""
    cap, n, spaces, ticks = 256, 220, 8, 5
    sc = [walk(s, cap, n, ticks) for s in range(spaces)]
    rng = np.random.default_rng(0)
    for s in sc:
        for t in (3, 4):  # only 5% of the entities move
            keep = rng.random(n) > 0.05
            x, z, r, act = s[t]
            s[t] = (np.where(keep, s[t - 1][0], x),
                    np.where(keep, s[t - 1][1], z), r, act)
    engs = engines(jax_mesh, emit=emit, flush_sched=sched,
                   delta_staging=delta)
    hs = {k: [e.create_space(cap) for _ in range(spaces)]
          for k, e in engs.items()}
    b = hs["port"][0].bucket
    assert isinstance(b, _MeshCUDABucket) and len(b.prev) == N_DEV
    AK.reset_launches()
    for t in range(ticks):
        inputs = [s[t] for s in sc]
        if t == 2:
            inputs[3] = None
        tick(engs, hs, inputs, t)
    jb = hs["cpu" if not jax_mesh else "mesh"][0].bucket
    if jax_mesh:
        assert b.stats["decode_overflow"] == jb.stats["decode_overflow"] > 0
        assert (b._max_chunks, b._kcap) == (jb._max_chunks, jb._kcap)
    for hp, hj in zip(hs["port"], hs["cpu" if not jax_mesh else "mesh"]):
        np.testing.assert_array_equal(b.get_prev(hp.slot),
                                      jb.get_prev(hj.slot))
    assert b.full_roundtrips == 0
    assert b.stats["delta_flushes"] == (2 if delta else 0)
    assert AK.launches == {"aoi_step": 0, "aoi_step_entlv": 0}


def test_mesh_clear_storm_and_growth():
    """A storm of clear_entity calls is silent, and growth 1024 -> 2048
    carries the state; no full-state round trip on the way."""
    cap, n = 1024, 800
    rng = np.random.default_rng(42)
    x = rng.uniform(0, 1500, n).astype(np.float32)
    z = rng.uniform(0, 1500, n).astype(np.float32)
    r = np.full(n, 80, np.float32)
    act = np.ones(n, bool)
    engs = engines()
    hs = {k: [e.create_space(cap)] for k, e in engs.items()}
    assert len(tick(engs, hs, [(x, z, r, act)])[0][0]) > 0
    gone = rng.choice(n, 200, replace=False)
    act2 = act.copy()
    act2[gone] = False
    for k, e in engs.items():
        for slot in gone:
            e.clear_entity(hs[k][0], int(slot))
    assert len(tick(engs, hs, [(x, z, r, act2)])[0][1]) == 0  # silent
    for k, e in engs.items():
        hs[k] = [e.grow_space(hs[k][0], 2048)]
    port_b = hs["port"][0].bucket
    n2 = 1500
    x2 = np.concatenate([x, rng.uniform(0, 1500, n2 - n)]).astype(np.float32)
    z2 = np.concatenate([z, rng.uniform(0, 1500, n2 - n)]).astype(np.float32)
    a2 = np.concatenate([act2, np.ones(n2 - n, bool)])
    ent, _lv = tick(engs, hs, [(x2, z2, np.full(n2, 80, np.float32), a2)])[0]
    assert len(ent) > 0
    assert port_b.capacity == 2048 and port_b.full_roundtrips == 0


@pytest.mark.parametrize("caps", [{"_max_chunks": 1},
                                  {"_max_gaps": 1, "_max_exc": 1}])
def test_mesh_forced_overflow_recovers_and_grows(caps):
    """Tiny caps force each shard's counted recovery: from its raw grids
    (chunk caps) or from its chunk grids (encode caps).  Events stay
    exact, the recoveries count as JAX's do and the caps grow."""
    cap, n = 256, 200
    sc = [walk(s + 100, cap, n, 2, world=500.0) for s in range(N_DEV)]
    engs = engines()
    hs = {k: [e.create_space(cap) for _ in range(N_DEV)]
          for k, e in engs.items()}
    b, jb = hs["port"][0].bucket, hs["mesh"][0].bucket
    for bucket in (b, jb):
        for k, v in caps.items():
            setattr(bucket, k, v)
    jb._step_cache.clear()
    for t in range(2):
        tick(engs, hs, [s[t] for s in sc], t)
    assert b.stats["decode_overflow"] == jb.stats["decode_overflow"] > 0
    assert all(getattr(b, k) == getattr(jb, k) for k in caps)
    assert any(getattr(b, k) > v for k, v in caps.items())


def test_mesh_subscription_masks_stream_and_peek_refreshes():
    """Unsubscribed slots deliver nothing while their state evolves; the
    mirror's stale rows refresh from the shards, and re-subscribing
    resumes exact parity."""
    cap, n, spaces, ticks = 256, 200, 8, 4
    sc = [walk(s + 7, cap, n, ticks) for s in range(spaces)]
    engs = engines()
    hs = {k: [e.create_space(cap) for _ in range(spaces)]
          for k, e in engs.items()}
    for k in ("port", "mesh"):
        hs[k][0].bucket.peek_words(hs[k][0].slot)  # enable the mirror
        for h in hs[k][::2]:
            engs[k].set_subscribed(h, False)
    for t in range(ticks):
        if t == 3:
            for k in ("port", "mesh"):
                engs[k].set_subscribed(hs[k][0], True)
        evs = {}
        for k, e in engs.items():
            for h, s in zip(hs[k], sc):
                e.submit(h, *s[t])
            e.flush()
            evs[k] = [e.take_events(h) for h in hs[k]]
        for s in range(spaces):
            unsub = s % 2 == 0 and not (s == 0 and t >= 3)
            for k in ("port", "mesh"):
                got, want = evs[k][s], evs["cpu"][s]
                if unsub:
                    assert got[0].size == 0 and got[1].size == 0
                else:
                    np.testing.assert_array_equal(got[0], want[0])
                    np.testing.assert_array_equal(got[1], want[1])
    for s in (0, 1, 2, 4):
        want = hs["cpu"][s].bucket.peek_words(hs["cpu"][s].slot)
        for k in ("port", "mesh"):
            np.testing.assert_array_equal(
                hs[k][s].bucket.peek_words(hs[k][s].slot), want,
                err_msg=f"{k} peek s={s}")
    assert hs["port"][0].bucket.full_roundtrips == 1  # the mirror's seed


def test_seeded_slot_must_stage_before_flush():
    """A slot seeded with set_prev and left unstaged would step cached
    zero inputs against carried words (a mass leave): refused."""
    eng = AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * N_DEV))
    h0, h1 = eng.create_space(256), eng.create_space(256)
    x = np.array([0.0, 5.0], np.float32)
    r = np.full(2, 50, np.float32)
    act = np.ones(2, bool)
    for h in (h0, h1):
        eng.submit(h, x, x, r, act)
    eng.flush()
    words = h1.bucket.get_prev(h1.slot)
    h1.bucket.set_prev(h1.slot, words)
    eng.submit(h0, x, x, r, act)
    with pytest.raises(RuntimeError, match="seeded"):
        eng.flush()


def test_seeded_slot_released_before_staging_does_not_poison_flush():
    eng = AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * N_DEV))
    cap = 256
    h0, h1 = eng.create_space(cap), eng.create_space(cap)
    x = np.array([0.0, 5.0], np.float32)
    r = np.full(2, 50, np.float32)
    act = np.ones(2, bool)
    eng.submit(h0, x, x, r, act)
    eng.flush()
    assert eng.take_events(h0)[0].size == 4
    h1.bucket.set_prev(h1.slot, h0.bucket.get_prev(h0.slot))
    eng.release_space(h1)
    eng.submit(h0, x, x, r, act)
    eng.flush()  # must not raise
    e, lv = eng.take_events(h0)
    assert e.size == 0 and lv.size == 0


def test_runtime_on_mesh_matches_jax():
    """Runtime.tick with the mesh bucket against the JAX Runtime (its CPU
    oracle: every JAX backend delivers the same arrays) on the same
    seeded game (watchers, bulk and per-entity moves, growth past 128,
    entities leaving); CRC, hook calls and every entity's neighbors()
    equal at every tick."""
    import goworld_tpu.engine.entity as JEnt
    import goworld_tpu.engine.runtime as JRt
    import goworld_tpu.engine.space as JSp
    import goworld_tpu.engine.vector as JVec
    import goworld_tpu_torch.engine.entity as TEnt
    import goworld_tpu_torch.engine.runtime as TRt
    import goworld_tpu_torch.engine.space as TSp
    import goworld_tpu_torch.engine.vector as TVec
    from test_torch_runtime import World, _game

    jw = World(JRt.Runtime(aoi_backend="cpu"), JEnt, JSp, JVec)
    tw = World(TRt.Runtime(device="cpu",
                           aoi_mesh=SpaceMesh(["cpu"] * N_DEV)),
               TEnt, TSp, TVec)
    for _ in zip(_game(jw, 3), _game(tw, 3)):
        jw.rt.tick()
        tw.rt.tick()
        assert tw.snapshot() == jw.snapshot()
    assert tw.space._cap == 256
    assert isinstance(tw.space._aoi_handle.bucket, _MeshCUDABucket)


def test_later_options_raise():
    """Options of the earlier ROADMAP.md items reach the mesh bucket:
    pipeline, cross_tick, fused and paged (items 1, 2 and 5), a fault
    plan (item 4) installs into the port's faults module, and the
    snapshot methods (item 9) no longer raise."""
    from goworld_tpu_torch import faults
    from goworld_tpu_torch.engine.runtime import Runtime

    mesh = SpaceMesh(["cpu"] * 2)
    for kw in ({"pipeline": True}, {"cross_tick": True}, {"fused": True},
               {"paged": True}):
        b = AOIEngine(device="cpu", mesh=mesh, **kw).create_space(128).bucket
        assert [getattr(b, k) for k in kw] == [True]
    try:
        Runtime(device="cpu", fault_plan="aoi.kernel:fail@99")
        assert [sp.seam for sp in faults.plan().specs] == ["aoi.kernel"]
    finally:
        faults.clear()
    # snapshots (item 9) are in: the mesh bucket exports, imports and
    # evacuates a slot
    eng = AOIEngine(device="cpu", mesh=mesh)
    h = eng.create_space(128)
    x = np.arange(128, dtype=np.float32)
    eng.submit(h, x, x, np.full(128, 3.0, np.float32), np.ones(128, bool))
    eng.flush()
    snap = h.bucket.export_snapshot(h.slot)
    h2 = eng.create_space(128)
    h2.bucket.import_snapshot(h2.slot, snap)
    assert np.array_equal(h2.bucket.get_prev(h2.slot), snap["words"])
    assert snap["words"].any()
    assert sorted(h.bucket.evacuate()) == [h.slot, h2.slot]
