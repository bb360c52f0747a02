"""The port's fault seams and fallback chains against the JAX package's.

The port keeps its own copy of ``goworld_tpu/faults.py``
(``goworld_tpu_torch/faults.py``); each test installs the SAME plan string
into both modules and drives the port's ``cuda`` backend on
``device="cpu"`` (the plain PyTorch step under the device bucket) beside
the JAX package's ``tpu`` backend on its CPU platform, and the JAX numpy
oracle.  Tolerance: exact equality of every tick's enter/leave arrays
(against the oracle, shifted by one tick where deferred), of the buckets'
fault counters (``rebuilds``, ``fallbacks``, ``host_ticks``, ``poisoned``,
``calc_level``, ``fused_demotions``, ``emit_path``) and of the plans'
``fired`` lists: the same plan fires at the same seam occurrences in both
packages.  The scenarios are ``tests/test_faults.py``'s, plus an emit
demotion, a fused-tick demotion (also on the sharded buckets' fused tick)
and the mesh and row-sharded buckets on 8 virtual CPU shards.  Also here: the port's fault module against the JAX
package's, the classifier of device faults, and a freed world.
"""

import gc
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from goworld_tpu import faults as jfaults
from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.parallel import SpaceMesh as JaxMesh
from goworld_tpu.parallel import multichip_devices as jax_devices
from goworld_tpu_torch import faults as tfaults
from goworld_tpu_torch.engine import aoi as A
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.ops import aoi_cuda as AK
from goworld_tpu_torch.parallel import SpaceMesh

from test_aoi_delta import _assert_same, _drive, _pad, _scene, _sparse_step
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT_KEYS = ("rebuilds", "fallbacks", "host_ticks", "poisoned",
              "calc_level", "fused_demotions", "emit_path")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _install(plan: str) -> None:
    jfaults.install(plan)
    tfaults.install(plan)


def _same_faults(jb, tb) -> None:
    """Equal fault counters and equal fired lists."""
    assert {k: tb.stats[k] for k in FAULT_KEYS} == \
        {k: jb.stats[k] for k in FAULT_KEYS}, (tb.stats, jb.stats)
    assert tfaults.plan().fired == jfaults.plan().fired


# -- the module --------------------------------------------------------------

PLANS = ["seed=7;aoi.h2d:oom@3;aoi.kernel:fail@5;conn.flush:reset@2",
         "seed=7; aoi.h2d:oom@3; aoi.kernel:fail@5x2; "
         "aoi.fetch:stall@4:0.01; conn.flush:reset@auto",
         "aoi.emit:fail@auto;aoi.device:reset@auto;seed=11",
         "", ";;", "seed=3",
         # malformed: the same ValueError, naming token and grammar
         "not.a.seam:oom@1", "aoi.h2d:bogus@1", "aoi.h2d:oom",
         "aoi.h2d:oom@0", "aoi.h2d:oom@x", "aoi.h2d:oom@3x0",
         "aoi.h2d:oom@3:abc", "seed=x;aoi.h2d:oom@1", "aoi.h2d"]


def _parsed(mod, text):
    try:
        p = mod.parse(text)
    except ValueError as e:
        return ("error", str(e))
    return (p.seed, [vars(s) for s in p.specs])


def test_fault_module_matches_jax():
    assert tfaults.SEAMS == jfaults.SEAMS
    assert tfaults.KINDS == jfaults.KINDS
    for text in PLANS:
        assert _parsed(tfaults, text) == _parsed(jfaults, text), text
    for seed in range(6):
        for seam in tfaults.SEAMS:
            assert tfaults.derive_occurrence(seed, seam) == \
                jfaults.derive_occurrence(seed, seam)
    # firing: the same occurrences, kinds and records
    for text, seam in (("aoi.h2d:oom@3", "aoi.h2d"),
                       ("aoi.kernel:fail@5x2", "aoi.kernel"),
                       ("aoi.device:reset@2", "aoi.device"),
                       ("conn.flush:reset@1", "conn.flush")):
        hits = {}
        for mod in (tfaults, jfaults):
            mod.install(text)
            hits[mod] = []
            for i in range(1, 9):
                try:
                    mod.check(seam)
                except (mod.InjectedFault, ConnectionResetError) as e:
                    hits[mod].append((i, type(e).__name__))
        assert hits[tfaults] == hits[jfaults] != []
        assert tfaults.plan().fired == jfaults.plan().fired
    # poison through filter: the same garbage
    _install("aoi.scalars:poison@2")
    v = np.arange(5, dtype=np.int64)
    for i in range(3):
        np.testing.assert_array_equal(tfaults.filter("aoi.scalars", v),
                                      jfaults.filter("aoi.scalars", v))


def test_env_plan_activates_port_module_only():
    code = ("import sys, goworld_tpu_torch.faults as f; p = f.plan(); "
            "assert p is not None and p.seed == 3, p; "
            "assert [s.seam for s in p.specs] == ['aoi.kernel']; "
            "assert 'goworld_tpu.faults' not in sys.modules")
    env = dict(os.environ, GW_FAULT_PLAN="seed=3;aoi.kernel:fail@1",
               PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_runtime_installs_into_port_module():
    from goworld_tpu_torch.engine.runtime import Runtime

    Runtime(device="cpu", fault_plan="seed=9;aoi.kernel:fail@99")
    assert tfaults.active() and tfaults.plan().seed == 9
    assert not jfaults.active()


# -- the single-device bucket ------------------------------------------------

def _three(cap=256, tier=None, **kw):
    """JAX oracle, JAX tpu bucket and the port's cuda bucket on the CPU;
    ``tier`` "mesh" or "rowshard": both packages' sharded bucket on 8
    virtual CPU shards."""
    jkw, tkw = dict(kw), dict(kw)
    if tier is not None:
        jkw["mesh"] = JaxMesh(jax_devices(8))
        tkw["mesh"] = SpaceMesh(["cpu"] * 8)
    if tier == "rowshard":
        jkw["rowshard_min_capacity"] = tkw["rowshard_min_capacity"] = cap
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "tpu": JaxEngine(default_backend="tpu", **jkw),
               "port": AOIEngine(device="cpu", **tkw)}
    return engines, {k: e.create_space(cap) for k, e in engines.items()}


@pytest.mark.parametrize("plan,ticks,cap,n,kw,want", [
    # OOM at the 3rd upload + kernel failure at the 5th launch
    ("seed=7;aoi.h2d:oom@3;aoi.kernel:fail@5", 8, 256, 180, {},
     {"calc_level": 1}),
    # growth OOM on the first slot allocation
    ("aoi.grow:oom@1", 4, 128, 60, {}, {"calc_level": 0}),
    ("aoi.delta:oom@2", 6, 256, 180, {}, {"calc_level": 0}),
    ("aoi.scalars:poison@4", 8, 256, 180, {}, {"poisoned": 1}),
    ("aoi.fetch:stall@2:0.001", 5, 256, 180, {}, {"rebuilds": 0}),
    # harvest-phase faults: a kernel error demotes, an OOM only rebuilds
    ("aoi.fetch:fail@3", 8, 256, 180, {}, {"calc_level": 1}),
    ("aoi.fetch:oom@3", 8, 256, 180, {}, {"calc_level": 0}),
    # the emit seam: the fan-out demotes to the host mode
    ("aoi.emit:fail@3", 6, 256, 180, {"emit": "native"},
     {"emit_path": 2, "rebuilds": 0}),
    # a fault in the fused attempt moves the tick to the unfused flow
    ("aoi.kernel:fail@3", 6, 256, 180, {"fused": True},
     {"fused_demotions": 1, "calc_level": 0}),
    # the same on the sharded buckets' fused tick (8 virtual CPU shards)
    ("aoi.kernel:fail@3", 6, 256, 180, {"fused": True, "tier": "mesh"},
     {"fused_demotions": 1, "calc_level": 0}),
    ("aoi.kernel:fail@3", 5, 2048, 300, {"fused": True, "tier": "rowshard"},
     {"fused_demotions": 1, "calc_level": 0}),
])
def test_fault_scenarios_match_jax(plan, ticks, cap, n, kw, want):
    _install(plan)
    engines, handles = _three(cap, **kw)
    out, _ = _drive(engines, handles, cap, ticks, n=n)
    _assert_same(out)
    tb, jb = handles["port"].bucket, handles["tpu"].bucket
    _same_faults(jb, tb)
    assert tfaults.plan().fired, "the plan fired nothing"
    for k, v in want.items():
        assert tb.stats[k] == v, (k, tb.stats)


def test_device_lost_stays_on_the_host(caplog):
    """``aoi.device`` kind ``reset``: the faulted tick stays on the host
    (one host tick), then both engines evacuate the bucket's spaces onto
    a fresh bucket, which steps at calc level 0.  The events stay exact,
    and the same plan fires the same faults in both packages."""
    _install("aoi.device:reset@3")
    engines, handles = _three()
    old = handles["port"].bucket
    with caplog.at_level("WARNING", logger="goworld_tpu_torch.aoi"):
        out, _ = _drive(engines, handles, 256, 6)
    _assert_same(out)
    assert tfaults.plan().fired == jfaults.plan().fired
    assert old.stats["calc_level"] == 2 and old.stats["host_ticks"] == 1
    st = handles["port"].bucket.stats
    assert handles["port"].bucket is not old
    assert st["calc_level"] == 0 and st["host_ticks"] == 0, st
    assert st["full_flushes"] + st["delta_flushes"] == 3, st
    for k in ("tpu", "port"):
        assert engines[k].migration_stats["evacuations"] == 1
    assert sum("lost its device" in r.getMessage()
               for r in caplog.records) == 1


def test_chain_to_oracle_and_reset():
    """Two kernel failures in a row: the hand kernel, then the plain step,
    then the host oracle; the level sticks; reset_calc_chain() re-arms the
    kernel (its wrapper runs again) and the events stay exact."""
    _install("aoi.kernel:fail@2x2")
    engines, handles = _three()
    calls = []
    step = AK.aoi_step_chg

    def counted(*a, **kw):
        calls.append(1)
        return step(*a, **kw)

    AK.aoi_step_chg = counted
    try:
        out, st = _drive(engines, handles, 256, 6)
        _assert_same(out)
        tb, jb = handles["port"].bucket, handles["tpu"].bucket
        _same_faults(jb, tb)
        assert tb.stats["calc_level"] == 2 and tb.stats["host_ticks"] >= 3
        at_level2 = len(calls)
        assert at_level2 == 1  # one kernel tick before the chain fell
        for b in (tb, jb):
            b.reset_calc_chain()
        out, _ = _drive(engines, handles, 256, 3, state=st)
        _assert_same(out)
        _same_faults(jb, tb)
        assert tb.stats["calc_level"] == 0
        assert len(calls) == at_level2 + 3
    finally:
        AK.aoi_step_chg = step


@pytest.mark.parametrize("flag", ["pipeline", "cross_tick"])
def test_deferred_fault_one_tick_late(flag):
    """Deferred: the host-recovered tick parks as a synthetic record and
    delivers at the next flush, where the device tick would have."""
    _install("seed=5;aoi.kernel:fail@4;aoi.fetch:fail@6")
    engines, handles = _three(**{flag: True})
    out, _ = _drive(engines, handles, 256, 7)
    for k in ("tpu", "port"):
        engines[k].flush()  # the trailing flush delivers the last tick
        out[k].append(engines[k].take_events(handles[k]))
        assert len(out[k][0][0]) == 0 and len(out[k][0][1]) == 0
        _assert_same(out, shift=1, key=k)
    _same_faults(handles["tpu"].bucket, handles["port"].bucket)
    assert handles["port"].bucket.stats["host_ticks"] >= 2


def test_emit_host_mode_and_reset():
    """emit="host" from the start equals the oracle; after an aoi.emit
    demotion reset_emit_path() re-arms the native fan-out."""
    _install("aoi.emit:fail@2")
    engines, handles = _three(emit="native")
    out, st = _drive(engines, handles, 256, 3)
    _assert_same(out)
    tb = handles["port"].bucket
    assert tb._emit == "host" and tb.stats["emit_path"] == 2
    for k in ("tpu", "port"):
        handles[k].bucket.reset_emit_path()
    assert tb._emit == "native" and tb.stats["emit_path"] == 0
    out, _ = _drive(engines, handles, 256, 2, state=st)
    _assert_same(out)
    _same_faults(handles["tpu"].bucket, tb)


# -- the sharded buckets -----------------------------------------------------

@pytest.mark.parametrize("plan,kw", [
    ("seed=7;aoi.h2d:oom@3;aoi.kernel:fail@5", {}),
    ("aoi.scalars:poison@3;aoi.fetch:fail@5", {"pipeline": True}),
])
def test_mesh_fault_parity(plan, kw):
    _install(plan)
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "mesh": JaxEngine(default_backend="tpu",
                                 mesh=JaxMesh(jax_devices(8)), **kw),
               "port": AOIEngine(device="cpu",
                                 mesh=SpaceMesh(["cpu"] * 8), **kw)}
    handles = {k: e.create_space(256) for k, e in engines.items()}
    out, _ = _drive(engines, handles, 256, 7)
    if kw:
        # deferred, a harvest-time fault coalesces the faulted tick with
        # the one dispatched after it (both packages): the port's stream
        # equals the JAX bucket's, tick for tick
        for k in ("mesh", "port"):
            engines[k].flush()
            out[k].append(engines[k].take_events(handles[k]))
        _assert_same(out, ref="mesh", key="port")
    else:
        _assert_same(out)
    tb, jb = handles["port"].bucket, handles["mesh"].bucket
    assert type(tb).__name__ == "_MeshCUDABucket"
    _same_faults(jb, tb)
    assert tb.stats["rebuilds"] >= 1


@pytest.mark.parametrize("plan", ["aoi.kernel:fail@2",
                                  "aoi.h2d:oom@2;aoi.kernel:fail@3x2"])
def test_rowshard_fault_parity(plan):
    _install(plan)
    cap, n, ticks = 2048, 300, 5
    eng = AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * 8),
                    rowshard_min_capacity=2048)
    jeng = JaxEngine(default_backend="tpu", mesh=JaxMesh(jax_devices(8)),
                     rowshard_min_capacity=2048)
    oracle = JaxEngine(default_backend="cpu")
    hs = [e.create_space(cap) for e in (eng, jeng, oracle)]
    assert type(hs[0].bucket).__name__ == "_RowShardCUDABucket"
    rng, xs, zs, rr, act = _scene(13, cap, n)
    for t in range(ticks):
        _sparse_step(rng, xs, zs)
        got = []
        for e, h in zip((eng, jeng, oracle), hs):
            e.submit(h, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                     act.copy())
            e.flush()
            got.append(e.take_events(h))
        for ev in got[:2]:
            for a, b in zip(ev, got[2]):
                np.testing.assert_array_equal(a, b, err_msg=f"tick {t}")
    _same_faults(hs[1].bucket, hs[0].bucket)
    assert hs[0].bucket.stats["host_ticks"] >= 1


# -- the classifier ----------------------------------------------------------

def test_fault_classifier():
    """Only an injected fault of the port's own module is recovered; a
    real CUDA error, out of memory, a refused launch, a build or input
    error and every other exception propagate."""
    for e in (tfaults.DeviceOOM("aoi.h2d", 1),
              tfaults.KernelFailure("aoi.kernel", 1),
              tfaults.DeviceLost("aoi.device", 1)):
        assert A._device_fault(e)
    assert A._device_lost(tfaults.DeviceLost("aoi.device", 1))
    assert not A._device_lost(tfaults.KernelFailure("aoi.kernel", 1))
    # any injected fault while the step is enqueued demotes; at harvest
    # only a kernel failure; while inputs are staged none
    assert A._demotes("kernel", tfaults.DeviceOOM("aoi.kernel", 1))
    assert A._demotes("kernel", tfaults.KernelFailure("aoi.kernel", 1))
    assert A._demotes("harvest", tfaults.KernelFailure("aoi.fetch", 1))
    assert not A._demotes("harvest", tfaults.DeviceOOM("aoi.fetch", 1))
    assert not A._demotes("stage", tfaults.KernelFailure("aoi.h2d", 1))
    # the JAX package's injected faults are not the port's
    assert not A._device_fault(jfaults.KernelFailure("aoi.kernel", 1))
    for e in (torch.cuda.OutOfMemoryError("CUDA out of memory"),
              RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
              RuntimeError("aoi_step kernel launch failed: CUDA error 9"),
              ValueError("x: want torch.float32 [1, 128]"),
              RuntimeError("CUDA build failed: nvcc not found"),
              KeyError("x"), RuntimeError("logic bug")):
        assert not A._device_fault(e) and not A._device_lost(e)


@pytest.mark.parametrize("exc,level", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), None),
    (RuntimeError("CUDA error: unspecified launch failure"), None),
    (RuntimeError("aoi_step kernel launch failed: CUDA error 7"), None),
    (ValueError("x: want torch.float32"), None),
    (OSError("libaoi_step.so: cannot open shared object file"), None),
    (tfaults.DeviceOOM("aoi.kernel", 1), 1),
    (tfaults.DeviceLost("aoi.kernel", 1), 2),
])
def test_raised_step_errors(exc, level):
    """A fault raised by the kernel's wrapper: a real error propagates
    (the bucket never steps in for a failing kernel); an injected fault
    demotes the calculator, a lost device to the host, whose spaces then
    move to a fresh bucket at level 0; the events stay exact."""
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "port": AOIEngine(device="cpu")}
    handles = {k: e.create_space(256) for k, e in engines.items()}
    old = handles["port"].bucket
    step = AK.aoi_step_chg
    n = [0]

    def failing(*a, **kw):
        n[0] += 1
        if n[0] == 3:
            raise exc
        return step(*a, **kw)

    AK.aoi_step_chg = failing
    try:
        if level is None:
            with pytest.raises(type(exc)):
                _drive(engines, handles, 256, 5)
            st = handles["port"].bucket.stats
            assert st["rebuilds"] == st["host_ticks"] == 0
            assert st["calc_level"] == 0
            return
        out, _ = _drive(engines, handles, 256, 5)
    finally:
        AK.aoi_step_chg = step
    _assert_same(out)
    st = old.stats
    assert st["rebuilds"] == 1 and st["host_ticks"] >= 1
    assert st["calc_level"] == level
    evacuated = level == 2  # the lost device's space was rebuilt
    assert (handles["port"].bucket is not old) == evacuated
    assert engines["port"].migration_stats["evacuations"] == int(evacuated)
    assert handles["port"].bucket.stats["calc_level"] == (0 if evacuated
                                                          else level)


# -- the freed world ---------------------------------------------------------

def test_world_with_aoi_entities_is_freed():
    """A Runtime whose spaces hold AOI entities frees after ``del`` and one
    collection: nothing keeps its cycles (entity -> space -> slot map ->
    entity) out of the collector's reach."""
    from goworld_tpu_torch.engine.entity import Entity
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.engine.space import Space
    from goworld_tpu_torch.engine.vector import Vector3

    class FreedScene(Space):
        pass

    class FreedMob(Entity):
        use_aoi = True
        aoi_distance = 40.0

        def on_enter_aoi(self, other):
            pass

    refs = []
    for kw in ({}, {"aoi_backend": "cpp"}, {"aoi_cross_tick": True}):
        rt = Runtime(device="cpu", **kw)
        for cls in (FreedScene, FreedMob):
            rt.entities.register(cls)
        sp = rt.entities.create_space("FreedScene", kind=1)
        sp.enable_aoi(40.0)
        for i in range(30):
            rt.entities.create("FreedMob", space=sp,
                               pos=Vector3(float(i * 5), 0.0, 0.0))
        for _ in range(3):
            rt.tick()
        assert any(e.interested_in for e in sp.entities)
        refs.append(weakref.ref(rt))
        del rt, sp
    gc.collect()
    assert [r() for r in refs] == [None] * len(refs)
