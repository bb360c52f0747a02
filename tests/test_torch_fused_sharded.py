"""The fused tick of the port's sharded buckets
(``engine/aoi_mesh._MeshCUDABucket`` and
``engine/aoi_rowshard._RowShardCUDABucket`` with ``fused=True``:
``ops/fused.FusedShards``) on ``device="cpu"``, where each shard graph's
body runs eagerly: its plain version.  Tolerance: exact equality of
every tick's enter and leave arrays.

On a sparse walk (10% movers a tick) on 8 virtual CPU shards
(``SpaceMesh(["cpu"] * 8)``) the fused mesh equals the port's unfused
mesh, the JAX package's fused ``_MeshTPUBucket`` on its 8 virtual CPU
devices and its CPU oracle, tick for tick, sequential, pipelined and
cross-tick (shifted by one); the fused row-sharded bucket at capacity
2048 equals its unfused run and the oracle.  A steady fused tick counts one dispatch for each distinct
device (``["cpu", "cpu:0"] * 4`` gives two) against the unfused tick's
step a shard and scatter a shard (or device) with movers.  An
``aoi.kernel`` or ``aoi.delta`` fault in the fused attempt runs that
tick unfused (``fused_demotions``), equal to the oracle; a paged fused
bucket whose shards overflow their chunk caps equals the unfused paged
one with ``decode_overflow`` 0; a space unsubscribed mid-walk and back
equals the oracle.  ``fused_dispatches`` equals the eligible ticks in
each test."""

import numpy as np
import pytest

from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.parallel import SpaceMesh as JaxMesh
from goworld_tpu.parallel import multichip_devices as jax_devices
from goworld_tpu_torch import faults as tfaults
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.ops import dispatch_count as DC
from goworld_tpu_torch.parallel import SpaceMesh

from test_aoi_delta import _pad, _scene, _sparse_step
from torch_threads import one_intra_op_thread  # noqa: F401

CAP, ROW_CAP = 256, 2048
TICKS = 6
SPACES = 2
MODES = {"sequential": {}, "pipeline": {"pipeline": True},
         "cross_tick": {"cross_tick": True}}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    tfaults.clear()
    yield
    tfaults.clear()


def _port(mesh_devs=("cpu",) * 8, rowshard=False, **kw):
    extra = {"rowshard_min_capacity": ROW_CAP} if rowshard else {}
    return AOIEngine(device="cpu", mesh=SpaceMesh(list(mesh_devs)),
                     **extra, **kw)


def _walk(engines, cap, spaces, ticks=TICKS, n=180, seed=7, on_tick=None):
    """One sparse walk per space into every engine: per tick
    ``out[key][tick]`` = [(enter, leave) per space] and the port's
    dispatches; a deferred engine's last tick comes out of one more flush.
    ``on_tick(t, engines, handles)`` runs before tick t's submits."""
    handles = {k: [e.create_space(cap) for _ in range(spaces)]
               for k, e in engines.items()}
    scenes = [list(_scene(seed + i, cap, n)) for i in range(spaces)]
    out = {k: [] for k in engines}
    disp = {k: [] for k in engines}
    for t in range(ticks):
        for rng, xs, zs, _rr, _act in scenes:
            _sparse_step(rng, xs, zs)
        if on_tick is not None:
            on_tick(t, engines, handles)
        for k, e in engines.items():
            for (_rng, xs, zs, rr, act), h in zip(scenes, handles[k]):
                e.submit(h, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                         act.copy())
            DC.reset()
            e.flush()
            disp[k].append(DC.read())
            out[k].append([e.take_events(h) for h in handles[k]])
    for k, e in engines.items():
        if e.has_pending():
            e.flush()  # nothing staged: delivers the tick in flight
            out[k].append([e.take_events(h) for h in handles[k]])
    return handles, out, disp


def _same(out, ref, key, shift=0):
    for t in range(len(out[ref]) - shift):
        for s, ((we, wl), (ge, gl)) in enumerate(zip(out[ref][t],
                                                     out[key][t + shift])):
            np.testing.assert_array_equal(ge, we,
                                          err_msg=f"{key} t={t} space {s}")
            np.testing.assert_array_equal(gl, wl,
                                          err_msg=f"{key} t={t} space {s}")


@pytest.fixture(scope="module")
def jax_mesh():
    """The JAX oracle and the JAX package's fused mesh bucket on 8
    virtual CPU devices, sequential, over the walk every mesh test
    drives (one run: its jitted programs take seconds to build)."""
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "jax": JaxEngine(default_backend="tpu",
                                mesh=JaxMesh(jax_devices(8)), fused=True)}
    handles, out, _disp = _walk(engines, CAP, SPACES)
    assert type(handles["jax"][0].bucket).__name__ == "_MeshTPUBucket"
    return out, dict(handles["jax"][0].bucket.stats)


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_mesh_matches_jax_and_unfused(mode, jax_mesh):
    """Per tick, the fused mesh equals the unfused one in the same mode,
    and the JAX fused mesh and oracle (shifted by one when deferred)."""
    kw = MODES[mode]
    ref, jst = jax_mesh
    engines = {"plain": _port(**kw), "fused": _port(fused=True, **kw)}
    handles, out, disp = _walk(engines, CAP, SPACES)
    out.update(ref)
    assert type(handles["fused"][0].bucket).__name__ == "_MeshCUDABucket"
    shift = 1 if kw else 0
    _same(out, "plain", "fused")
    for k in ("cpu", "jax"):
        _same(out, k, "fused", shift)
    if shift:
        assert all(len(e) + len(lv) == 0 for e, lv in out["fused"][0])
    st = handles["fused"][0].bucket.stats
    # eligible: every tick after the first (a full restage)
    assert st["fused_dispatches"] == jst["fused_dispatches"] == TICKS - 1
    assert st["fused_demotions"] == 0
    assert handles["plain"][0].bucket.stats["fused_dispatches"] == 0
    assert disp["fused"][1:] == [1] * (TICKS - 1), disp["fused"]


def test_fused_rowshard_matches_oracle_and_unfused():
    """The twin of ``tests/test_fused.py::test_fused_rowshard_parity`` at
    capacity 2048: the fused row-sharded bucket equals the oracle and the
    unfused bucket per tick, every tick after the first fused."""
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "plain": _port(rowshard=True),
               "fused": _port(rowshard=True, fused=True)}
    handles, out, disp = _walk(engines, ROW_CAP, 1, n=300, seed=13)
    assert type(handles["fused"][0].bucket).__name__ == \
        "_RowShardCUDABucket"
    for k in ("cpu", "plain"):
        _same(out, k, "fused")
    st = handles["fused"][0].bucket.stats
    assert st["fused_dispatches"] == TICKS - 1
    assert st["fused_demotions"] == 0
    assert disp["fused"][1:] == [1] * (TICKS - 1), disp["fused"]


@pytest.mark.parametrize("rowshard", [False, True])
@pytest.mark.parametrize("devs", [["cpu"] * 8, ["cpu", "cpu:0"] * 4])
def test_steady_tick_one_dispatch_a_device(devs, rowshard):
    """The twin of ``scripts/fused_smoke.py``'s tiers: a steady fused tick
    counts one dispatch for each distinct device; the unfused tick one
    step a shard plus one scatter a shard with movers (mesh) or a device
    (row-sharded)."""
    cap, spaces = (ROW_CAP, 1) if rowshard else (CAP, 8)
    engines = {"plain": _port(devs, rowshard),
               "fused": _port(devs, rowshard, fused=True)}
    handles, out, disp = _walk(engines, cap, spaces)
    _same(out, "plain", "fused")
    n_dev = len(set(devs))
    if rowshard:
        unfused = len(devs) + n_dev
    else:
        # 8 spaces on 8 shards, every one with movers
        unfused = 2 * len(devs)
    assert disp["fused"][1:] == [n_dev] * (TICKS - 1), disp
    assert disp["plain"][1:] == [unfused] * (TICKS - 1), disp
    b = handles["fused"][0].bucket
    assert b.stats["fused_dispatches"] == TICKS - 1
    assert len(b._fz.devices) == n_dev


@pytest.mark.parametrize("rowshard", [False, True])
@pytest.mark.parametrize("plan", ["aoi.kernel:fail@3", "aoi.delta:fail@2"])
def test_demotion_same_tick_bit_exact(plan, rowshard):
    """A seam fault in the fused attempt runs that tick unfused, in the
    same call: the stream stays the oracle's, one demotion is counted,
    and no fault reaches the calculator chain."""
    tfaults.install(plan)
    cap, spaces, n = (ROW_CAP, 1, 300) if rowshard else (CAP, SPACES, 180)
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "fused": _port(rowshard=rowshard, fused=True)}
    handles, out, _disp = _walk(engines, cap, spaces, n=n)
    _same(out, "cpu", "fused")
    assert tfaults.plan().fired
    st = handles["fused"][0].bucket.stats
    assert st["fused_demotions"] == 1, st
    assert st["fused_dispatches"] == TICKS - 2, st
    assert st["calc_level"] == 0 and st["rebuilds"] == 0, st


@pytest.mark.parametrize("rowshard", [False, True])
def test_fused_paged_overflowing_shards(rowshard):
    """Every shard past its chunk caps (``_max_chunks = 1``): the fused
    paged bucket absorbs each through the page pool, equal to the
    unfused paged bucket and the oracle, with no decode overflow."""
    cap, spaces, n = (ROW_CAP, 1, 300) if rowshard else (CAP, SPACES, 180)
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "plain": _port(rowshard=rowshard, paged=True),
               "fused": _port(rowshard=rowshard, paged=True, fused=True)}

    def force(t, engines, handles):
        if t == 0:
            for k in ("plain", "fused"):
                handles[k][0].bucket._max_chunks = 1

    handles, out, _disp = _walk(engines, cap, spaces, n=n, on_tick=force)
    for k in ("cpu", "plain"):
        _same(out, k, "fused")
    st = handles["fused"][0].bucket.stats
    assert st["decode_overflow"] == 0 and st["fused_dispatches"] == TICKS - 1
    assert handles["fused"][0].bucket._max_chunks == 1


@pytest.mark.parametrize("mode", ["sequential", "cross_tick"])
def test_space_unsubscribed_mid_walk(mode):
    """Space 0 opts out of the event stream at tick 2 and back in at
    tick 4: each change restages in full (not eligible), the ticks
    between replay with the space masked (no events; the CPU oracle
    ignores the flag), and the stream equals the unfused mesh's and,
    outside the masked ticks, the oracle's; the final words are the
    oracle's."""
    kw = MODES[mode]

    def sub(t, engines, handles):
        if t in (2, 4):
            for k, e in engines.items():
                e.set_subscribed(handles[k][0], t == 4)

    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "plain": _port(**kw), "fused": _port(fused=True, **kw)}
    handles, out, _disp = _walk(engines, CAP, SPACES, on_tick=sub)
    _same(out, "plain", "fused")
    shift = 1 if kw else 0
    for t in range(TICKS):
        for s in range(SPACES):
            got = out["fused"][t + shift][s]
            if s == 0 and 2 <= t < 4:
                assert all(len(a) == 0 for a in got), (t, s)
                continue
            for g, w in zip(got, out["cpu"][t][s]):
                np.testing.assert_array_equal(g, w, err_msg=f"t={t} s={s}")
    for h, oh in zip(handles["fused"], handles["cpu"]):
        np.testing.assert_array_equal(h.bucket.get_prev(h.slot),
                                      oh.bucket.get_prev(oh.slot))
    st = handles["fused"][0].bucket.stats
    assert st["fused_dispatches"] == TICKS - 3, st
    assert st["full_flushes"] == 3, st


@pytest.mark.parametrize("rowshard", [False, True])
def test_fused_tick_spans(rowshard):
    """Traced, a fused tick records ``aoi.stage``, then ``aoi.kernel`` and
    ``aoi.fused`` over the replay (the JAX bucket's points); the prime
    tick, unfused, records no ``aoi.fused``."""
    from goworld_tpu_torch import telemetry
    from goworld_tpu_torch.telemetry import trace

    cap, spaces, n = (ROW_CAP, 1, 300) if rowshard else (CAP, SPACES, 180)
    telemetry.enable()
    try:
        trace.reset()
        handles, _out, _disp = _walk({"fused": _port(rowshard=rowshard,
                                                     fused=True)},
                                     cap, spaces, ticks=1, n=n)
        first = [nm for nm, *_ in trace.spans()]
        trace.reset()
        _walk({"fused": _port(rowshard=rowshard, fused=True)}, cap, spaces,
              ticks=2, n=n)
        names = [nm for nm, *_ in trace.spans()]
    finally:
        telemetry.disable()
    assert "aoi.fused" not in first, first
    fz = [nm for nm in names if nm in ("aoi.stage", "aoi.kernel",
                                       "aoi.fused")]
    assert fz == ["aoi.stage", "aoi.kernel", "aoi.fused"], names
