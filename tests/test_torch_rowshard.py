"""The port's row-sharded bucket (goworld_tpu_torch.engine.aoi_rowshard on
8 virtual CPU shards) against the JAX package's _RowShardTPUBucket on its
8-device CPU mesh and its CPU oracle: one oversized space's observer rows
split over the shards.  Tolerance: exact equality of every tick's
enter/leave arrays, of the packed state, of derive_row/derive_col and of
the counted overflow recoveries."""

import numpy as np
import pytest

from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.parallel import SpaceMesh as JaxMesh
from goworld_tpu.parallel import multichip_devices as jax_devices
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.engine.aoi_mesh import _MeshCUDABucket
from goworld_tpu_torch.engine.aoi_rowshard import _RowShardCUDABucket
from goworld_tpu_torch.ops import aoi_predicate as TP
from goworld_tpu_torch.parallel import SpaceMesh
from torch_threads import one_intra_op_thread  # noqa: F401

N_DEV = 8


def engines(thresh=1024, jax_rowshard=True, n_dev=N_DEV, **port_kw):
    engs = {"port": AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * n_dev),
                              rowshard_min_capacity=thresh, **port_kw),
            "cpu": JaxEngine(default_backend="cpu")}
    if jax_rowshard:
        engs["rowshard"] = JaxEngine(default_backend="tpu",
                                     mesh=JaxMesh(jax_devices(n_dev)),
                                     rowshard_min_capacity=thresh)
    return engs


def tick(engs, hs, x, z, r, act, t=0):
    """One submit + flush on every engine; every engine's events must equal
    the oracle's.  Returns them."""
    evs = {}
    for k, e in engs.items():
        e.submit(hs[k], x, z, r, act)
        e.flush()
        evs[k] = e.take_events(hs[k])
    for k, (ge, gl) in evs.items():
        np.testing.assert_array_equal(ge, evs["cpu"][0], err_msg=f"{k} t={t}")
        np.testing.assert_array_equal(gl, evs["cpu"][1], err_msg=f"{k} t={t}")
    return evs["cpu"]


def walk(rng, x, z, n, world=1500.0):
    x = np.clip(x + rng.uniform(-25, 25, n), 0, world).astype(np.float32)
    z = np.clip(z + rng.uniform(-25, 25, n), 0, world).astype(np.float32)
    return x, z


@pytest.mark.parametrize("emit,delta", [("native", True), ("vector", False)])
def test_rowshard_parity_storm_and_state(emit, delta):
    """Var-radius walk, a clear storm (silent, maintenance on every
    shard), packed-state equality, derive_row/derive_col, and the
    exclusive bucket dropped at release."""
    cap, n = 1024, 900
    engs = engines(jax_rowshard=delta, emit=emit, delta_staging=delta)
    hs = {k: e.create_space(cap) for k, e in engs.items()}
    b = hs["port"].bucket
    assert isinstance(b, _RowShardCUDABucket)
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1500, n).astype(np.float32)
    z = rng.uniform(0, 1500, n).astype(np.float32)
    r = rng.uniform(40, 120, n).astype(np.float32)
    act = rng.random(n) < 0.95
    for t in range(4):
        mx, mz = walk(rng, x, z, n)
        # after the first tick 5% move: the sparse delta-packet path
        sel = rng.random(n) < (1.0 if t == 0 else 0.05)
        x, z = np.where(sel, mx, x), np.where(sel, mz, z)
        tick(engs, hs, x, z, r, act, t)
    assert [blk.shape for blk in b.prev] == [(cap // N_DEV, cap // 32)] * N_DEV
    gone = rng.choice(n, 120, replace=False)
    act2 = act.copy()
    act2[gone] = False
    for k, e in engs.items():
        for s in gone:
            e.clear_entity(hs[k], int(s))
    assert len(tick(engs, hs, x, z, r, act2)[1]) == 0  # the storm is silent
    assert b.stats["delta_flushes"] == (3 if delta else 0)
    want = hs["cpu"].bucket._oracles[hs["cpu"].slot].prev_words
    np.testing.assert_array_equal(b.get_prev(0), want)
    for e in (5, 130, 1000):
        np.testing.assert_array_equal(b.derive_row(0, e), want[e])
        w, bit = TP.word_bit_for_column(e, cap)
        np.testing.assert_array_equal(
            b.derive_col(0, e), np.nonzero(want[:, w] & (1 << bit))[0])
    if "rowshard" in hs:
        jb = hs["rowshard"].bucket
        assert b.stats["decode_overflow"] == jb.stats["decode_overflow"]
    engs["port"].release_space(hs["port"])
    assert not engs["port"]._buckets


def test_rowshard_overflow_recovery_parity():
    """Tiny chunk caps force each shard's counted recovery from its raw
    grids; events exact, the recoveries count as JAX's and the caps
    grow."""
    cap, n = 1024, 500
    engs = engines()
    hs = {k: e.create_space(cap) for k, e in engs.items()}
    b, jb = hs["port"].bucket, hs["rowshard"].bucket
    b._max_chunks = jb._max_chunks = 1
    jb._step_cache.clear()
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 600, n).astype(np.float32)
    z = rng.uniform(0, 600, n).astype(np.float32)
    r = np.full(n, 80, np.float32)
    act = np.ones(n, bool)
    for t in range(2):
        x, z = walk(rng, x, z, n, world=600.0)
        tick(engs, hs, x, z, r, act, t)
    assert b.stats["decode_overflow"] == jb.stats["decode_overflow"] > 0
    assert b._max_chunks == jb._max_chunks > 1


def test_rowshard_subscription_masks_stream():
    """An unsubscribed oversized space delivers nothing while its state
    evolves exactly; re-subscribing resumes parity."""
    cap, n = 1024, 600
    engs = engines(jax_rowshard=False)
    hs = {k: e.create_space(cap) for k, e in engs.items()}
    engs["port"].set_subscribed(hs["port"], False)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1200, n).astype(np.float32)
    z = rng.uniform(0, 1200, n).astype(np.float32)
    r = np.full(n, 70, np.float32)
    act = np.ones(n, bool)
    for _t in range(3):
        x, z = walk(rng, x, z, n, world=1200.0)
        for k, e in engs.items():
            e.submit(hs[k], x, z, r, act)
            e.flush()
        assert engs["port"].take_events(hs["port"])[0].size == 0
        engs["cpu"].take_events(hs["cpu"])
    want = hs["cpu"].bucket._oracles[hs["cpu"].slot].prev_words
    np.testing.assert_array_equal(hs["port"].bucket.get_prev(0), want)
    engs["port"].set_subscribed(hs["port"], True)
    x, z = walk(rng, x, z, n, world=1200.0)
    assert len(tick(engs, hs, x, z, r, act)[0]) > 0


def test_growth_crosses_into_rowshard():
    """A mesh-bucket space grows across the threshold into a row-sharded
    bucket with its interest state carried (no spurious events)."""
    cap, n = 1024, 400
    engs = engines(thresh=2048)
    hs = {k: e.create_space(cap) for k, e in engs.items()}
    assert isinstance(hs["port"].bucket, _MeshCUDABucket)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 900, n).astype(np.float32)
    z = rng.uniform(0, 900, n).astype(np.float32)
    r = np.full(n, 60, np.float32)
    act = np.ones(n, bool)
    tick(engs, hs, x, z, r, act)
    hs = {k: e.grow_space(hs[k], 2048) for k, e in engs.items()}
    assert isinstance(hs["port"].bucket, _RowShardCUDABucket)
    n2 = 700
    x2 = np.concatenate([x, rng.uniform(0, 900, n2 - n)]).astype(np.float32)
    z2 = np.concatenate([z, rng.uniform(0, 900, n2 - n)]).astype(np.float32)
    a2 = np.concatenate([act, np.ones(n2 - n, bool)])
    ent, _lv = tick(engs, hs, x2, z2, np.full(n2, 60, np.float32), a2)
    assert len(ent) > 0


def test_runtime_space_on_rowshard():
    """Runtime.tick with a pre-sized space on the row-sharded bucket:
    hooks, neighbors() through derive_row, observers() through
    derive_col, and a destroy severing pairs without re-emitting."""
    from goworld_tpu_torch.engine.entity import Entity
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.engine.space import Space
    from goworld_tpu_torch.engine.vector import Vector3

    seen = []

    class Scene(Space):
        pass

    class Mob(Entity):
        use_aoi = True
        aoi_distance = 50.0

    class Watcher(Entity):
        use_aoi = True
        aoi_distance = 50.0

        def on_enter_aoi(self, other):
            seen.append(other.id)

    rt = Runtime(device="cpu", aoi_mesh=SpaceMesh(["cpu"] * N_DEV),
                 aoi_rowshard_min_capacity=1024)
    for cls in (Scene, Mob, Watcher):
        rt.entities.register(cls)
    sp = rt.entities.create_space("Scene", kind=1)
    sp.enable_aoi(50.0, capacity=1024)
    assert isinstance(sp._aoi_handle.bucket, _RowShardCUDABucket)
    a = rt.entities.create("Mob", space=sp, pos=Vector3(0, 0, 0))
    b = rt.entities.create("Mob", space=sp, pos=Vector3(10, 0, 10))
    w = rt.entities.create("Watcher", space=sp, pos=Vector3(5, 0, 5))
    rt.tick()
    assert sorted(seen) == sorted([a.id, b.id])
    assert set(a.neighbors()) == {b, w}  # derive_row
    assert set(b.observers()) == {a, w}  # derive_col
    b.destroy()
    rt.tick()
    assert set(a.neighbors()) == {w}
    assert sp._aoi_handle.bucket.full_roundtrips == 0


def test_runtime_growth_into_rowshard_matches_jax():
    """The seeded game of test_torch_runtime on a 2-shard mesh whose
    row-shard threshold is the grown capacity (128 -> 256): the space
    crosses into the row-sharded bucket mid-game; CRC, hook calls and
    neighbors() equal the JAX Runtime's (CPU oracle) at every tick."""
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
    tw = World(TRt.Runtime(device="cpu", aoi_mesh=SpaceMesh(["cpu"] * 2),
                           aoi_rowshard_min_capacity=256),
               TEnt, TSp, TVec)
    for _ in zip(_game(jw, 4), _game(tw, 4)):
        jw.rt.tick()
        tw.rt.tick()
        assert tw.snapshot() == jw.snapshot()
    assert isinstance(tw.space._aoi_handle.bucket, _RowShardCUDABucket)
