"""Space-stacked cohorts of the port (goworld_tpu_torch.ops.aoi_cohort,
engine/aoi_cohort.py, ``AOIEngine(cohort=...)``, ``CohortPlanner``) on
device="cpu", held to the JAX package's (``default_backend="tpu"`` on
the CPU) and its CPU oracle on the same seeded walks.  Tolerance: exact
equality of every tick's enter and leave arrays, of the cohort planes
and words, of the dispatch counts, ``cohort_stats`` and the fault plans'
fired lists.

Mirrors tests/test_cohort.py and tests/test_cohort_roundtrip.py, plus
the port's own pins: a fused cohort with quiet members (spaces that stage
nothing on a tick) still takes one dispatch a tick and mints no capture
key, as the JAX bucket's gathered step does; an evacuated solo bucket is
re-homed on the ``cuda`` tier."""

import numpy as np
import pytest

from goworld_tpu import faults as jfaults
from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.engine.placement import CohortPlanner as JaxPlanner
from goworld_tpu.ops import aoi_cohort as JAC
from goworld_tpu.ops import dispatch_count as JDC
from goworld_tpu_torch import faults, telemetry
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.engine.placement import CohortPlanner
from goworld_tpu_torch.ops import aoi_cohort as AC
from goworld_tpu_torch.ops import aoi_predicate as P
from goworld_tpu_torch.ops import dispatch_count as DC
from goworld_tpu_torch.telemetry import trace
from test_aoi_delta import _pad, _scene, _sparse_step
from test_cohort_roundtrip import _assert_snap_equal, _snap

CAPS = (140, 200, 256, 300)  # mixed capacities; the first three share 256


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()
    telemetry.disable()


def _engines(caps=CAPS, **kw):
    """The JAX oracle and cohort engine beside the port's cohort and solo
    engines (device="cpu")."""
    engines = {
        "cpu": JaxEngine(default_backend="cpu"),
        "jax": JaxEngine(default_backend="tpu", cohort="auto", **kw),
        "cohort": AOIEngine(device="cpu", cohort="auto", **kw),
        "solo": AOIEngine(device="cpu", cohort="solo", **kw),
    }
    handles = {k: [e.create_space(c) for c in caps]
               for k, e in engines.items()}
    return engines, handles


def _counter(k):
    return JDC if k in ("cpu", "jax") else DC


def _drive(engines, handles, ticks, seed=11, n=110, quiet=None,
           dispatches=None):
    """One identical sparse walk per space into every engine:
    out[key][tick] = [(enter, leave) per space].  ``quiet(t, i)`` True
    leaves space i unsubmitted on tick t (its walk still moves);
    ``dispatches`` collects each engine's dispatch count per tick."""
    n_sp = len(next(iter(handles.values())))
    scenes = [list(_scene(seed + i, h.capacity, n))
              for i, h in enumerate(handles["cpu"])]
    out = {k: [] for k in engines}
    for t in range(ticks):
        for (rng, xs, zs, _rr, _act) in scenes:
            _sparse_step(rng, xs, zs)
        for k, e in engines.items():
            for i, ((_rng, xs, zs, rr, act), h) in enumerate(
                    zip(scenes, handles[k])):
                if quiet is not None and quiet(t, i):
                    continue
                cap = h.capacity
                e.submit(h, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                         _pad(act, cap))
            dc = _counter(k)
            dc.reset()
            e.flush()
            if dispatches is not None:
                dispatches.setdefault(k, []).append(dc.read())
            out[k].append([e.take_events(h) for h in handles[k]])
    assert all(len(v[0]) == n_sp for v in out.values())
    return out


def _assert_same(out, ref="cpu", keys=None):
    for k in (keys if keys is not None else [x for x in out if x != ref]):
        for t in range(len(out[ref])):
            for si, ((re_, rl), (pe, pl)) in enumerate(zip(out[ref][t],
                                                           out[k][t])):
                np.testing.assert_array_equal(
                    re_, pe, err_msg=f"{k} space {si} enter tick {t}")
                np.testing.assert_array_equal(
                    rl, pl, err_msg=f"{k} space {si} leave tick {t}")


def _fired():
    def of(p):
        return [(f["seam"], f["kind"], f["occurrence"]) for f in p.fired]

    return of(faults.plan()), of(jfaults.plan())


def _install(plan):
    faults.install(plan)
    jfaults.install(plan)


# -- routing & the shape ladder ----------------------------------------------

def test_cohort_routing_stacks_mixed_capacities():
    engines, handles = _engines()
    assert sorted(engines["cohort"]._buckets) == [("cuda-cohort", 256),
                                                  ("cuda-cohort", 1024)]
    assert [k for _t, k in sorted(engines["jax"]._buckets)] == [256, 1024]
    for k in ("cohort", "solo"):
        assert [h.capacity for h in handles[k]] == \
            [h.capacity for h in handles["jax"]] == [256, 256, 256, 1024]
    solo = engines["solo"]
    assert len(solo._buckets) == len(CAPS)
    assert all(b.cohort_solo and b.exclusive for b in solo._buckets.values())
    # solo keys sort as the JAX package's tpu-solo-<n> keys: as strings
    keys = sorted(solo._buckets)
    assert [k[0] for k in keys] == [f"cuda-solo-{i}" for i in (1, 2, 3, 4)]


def test_cohort_ladder_validation():
    for bad in ((), (300,), (64,), (1024, 256)):
        for mod in (AC, JAC):
            with pytest.raises(ValueError):
                mod.validate_ladder(bad)
    for cap in (1, 128, 200, 256, 257, 4096, 4097):
        assert AC.cohort_shape(cap) == JAC.cohort_shape(cap)
    assert AC.cohort_shape(200) == 256 and AC.cohort_shape(4097) is None
    assert AC.validate_ladder([256, 1024]) == (256, 1024)
    with pytest.raises(ValueError):
        AOIEngine(device="cpu", cohort="bogus")


def test_cohort_past_ladder_keeps_classic_routing():
    eng = AOIEngine(device="cpu", cohort="auto", cohort_ladder=(256,))
    h = eng.create_space(512)
    assert not getattr(h.bucket, "cohort", False)
    assert ("cuda", 512) in eng._buckets
    # host backends are never stacked
    hc = eng.create_space(200, "cpu")
    assert ("cpu", 256) in eng._buckets and hc.backend == "cpu"


# -- parity: cohort vs solo vs the JAX engines --------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_cohort_parity(fused):
    engines, handles = _engines(fused=fused)
    disp = {}
    out = _drive(engines, handles, 8, dispatches=disp)
    _assert_same(out)
    if fused:
        # steady ticks: one graph replay a cohort bucket, as the JAX
        # bucket's one jitted program
        assert disp["cohort"][2:] == disp["jax"][2:] == [2] * 6, disp


def test_cohort_parity_paged():
    engines, handles = _engines(paged=True)
    out = _drive(engines, handles, 6)
    _assert_same(out)


# -- the dispatch & capture pins ----------------------------------------------

def test_cohort_one_dispatch_per_tick_vs_solo():
    engines, handles = _engines(fused=True)
    _drive(engines, handles, 3)  # warm-up: full upload + first deltas
    counts = {}
    for k in ("jax", "cohort", "solo"):
        dc = _counter(k)
        dc.reset_keys()
        disp = {}
        _drive({k: engines[k], "cpu": engines["cpu"]},
               {k: handles[k], "cpu": handles["cpu"]}, 4, dispatches=disp)
        counts[k] = sum(disp[k])
        assert dc.new_keys() == 0, f"{k}: new capture keys after warm-up"
    assert counts["cohort"] == counts["jax"] == 2 * 4, counts
    assert counts["solo"] == len(CAPS) * 4, counts
    coh = engines["cohort"]._buckets[("cuda-cohort", 256)]
    jcoh = engines["jax"]._buckets[("tpu-cohort", 256)]
    assert coh.stats["cohort_dispatches"] == \
        jcoh.stats["cohort_dispatches"] >= 7
    assert coh.stats["cohort_demotions"] == 0


def test_quiet_members_stay_fused():
    """A quarter of the spaces stage nothing on each tick: the fused
    cohort still takes one dispatch a bucket (the staged-row mask, no new
    capture key), equal to the JAX bucket's gathered step, and its events
    equal the oracle's -- a quiet space emits nothing and keeps its
    words."""
    caps = (200,) * 8
    engines, handles = _engines(caps=caps, fused=True)
    del engines["solo"], handles["solo"]
    disp = {}

    def quiet(t, i):
        return t >= 2 and (i + t) % 4 == 0

    _drive(engines, handles, 3, n=100)  # both word parities captured
    DC.reset_keys()
    JDC.reset_keys()
    out = _drive(engines, handles, 8, n=100, quiet=quiet, dispatches=disp,
                 seed=5)
    _assert_same(out)
    assert disp["cohort"] == disp["jax"], disp
    assert disp["cohort"][1:] == [1] * 7, disp
    assert DC.new_keys() == 0
    b = handles["cohort"][0].bucket
    assert b.stats["fused_dispatches"] >= 9
    assert all(len(e) + len(lv) == 0 for t, row in enumerate(out["cohort"])
               for i, (e, lv) in enumerate(row) if quiet(t, i))


def test_quiet_member_clear_stays_silent():
    """A quiet member whose entity was cleared (it left the space) keeps
    the cleared words on a fused tick: its stale inputs are never
    re-stepped into events."""
    eng = AOIEngine(device="cpu", cohort="auto", fused=True)
    hs = [eng.create_space(256) for _ in range(2)]
    x = np.arange(256, dtype=np.float32)
    r = np.full(256, 3.0, np.float32)
    act = np.ones(256, bool)
    for t in range(4):
        xs = x.copy()
        xs[:8] += t  # a few movers: a delta tick, fused
        for h in hs:
            if t < 2 or h is hs[0]:
                eng.submit(h, xs if h is hs[0] else x, x, r, act)
        if t == 2:
            eng.clear_entity(hs[1], 5)
        eng.flush()
        ev = [eng.take_events(h) for h in hs]
    assert len(ev[1][0]) == len(ev[1][1]) == 0
    words = P.unpack_rows(hs[1].bucket.get_prev(hs[1].slot), 256)
    assert not words[5].any() and not words[:, 5].any()
    assert hs[1].bucket.stats["fused_dispatches"] >= 2


# -- the aoi.cohort fault seam ------------------------------------------------

@pytest.mark.parametrize("kind", ["fail", "oom", "reset"])
def test_cohort_fault_demotes_same_tick_bit_exact(kind):
    _install(f"aoi.cohort:{kind}@3x2")
    engines, handles = _engines()
    out = _drive(engines, handles, 8)
    _assert_same(out)
    coh = engines["cohort"]
    assert not any(k[0] == "cuda-cohort" for k in coh._buckets)
    assert coh.cohort_stats == engines["jax"].cohort_stats
    assert coh.cohort_stats["cohort_demoted_spaces"] == len(CAPS)
    port, jax = _fired()
    assert port == jax == [("aoi.cohort", kind, 3), ("aoi.cohort", kind, 4)]
    samples = {s.name: s.value for s in coh._telemetry_collect()}
    assert samples["aoi.cohorts"] == samples["aoi.cohort_spaces"] == 0
    assert samples["aoi.cohort_demoted_spaces"] == len(CAPS)


def test_cohort_demotion_sequential_flush_mode():
    _install("aoi.cohort:fail@3x2")
    engines, handles = _engines(flush_sched=False)
    out = _drive(engines, handles, 6)
    _assert_same(out)
    assert engines["cohort"].cohort_stats["cohort_demoted_spaces"] \
        == engines["jax"].cohort_stats["cohort_demoted_spaces"] == len(CAPS)
    assert _fired()[0] == _fired()[1]


def test_recohort_rearms_after_demotion():
    _install("aoi.cohort:fail@3x2")
    engines, handles = _engines()
    out = _drive(engines, handles, 4)
    faults.clear()
    jfaults.clear()
    coh = engines["cohort"]
    assert coh.recohort() == engines["jax"].recohort() == len(CAPS)
    assert sorted(coh._buckets) == [("cuda-cohort", 256),
                                    ("cuda-cohort", 1024)]
    out2 = _drive(engines, handles, 4)
    _assert_same(out)
    _assert_same(out2)
    _install("aoi.cohort:fail@1x2")
    out3 = _drive(engines, handles, 3)
    _assert_same(out3)
    assert coh.cohort_stats == engines["jax"].cohort_stats
    assert coh.cohort_stats["cohort_demoted_spaces"] == 2 * len(CAPS)


# -- live join/leave ----------------------------------------------------------

def test_cohort_join_leave_under_load():
    engines, handles = _engines()
    coh, hs = engines["cohort"], handles["cohort"]
    telemetry.enable()
    trace.reset()
    out = _drive(engines, handles, 3)
    coh.cohort_leave(hs[0])
    engines["jax"].cohort_leave(handles["jax"][0])
    assert hs[0].bucket.cohort_solo
    mid = _drive(engines, handles, 3)
    coh.cohort_join(hs[0])
    engines["jax"].cohort_join(handles["jax"][0])
    assert hs[0].bucket.cohort
    late = _drive(engines, handles, 3)
    names = [nm for nm, *_ in trace.spans()]
    telemetry.disable()
    for k in out:
        out[k].extend(mid[k])
        out[k].extend(late[k])
    _assert_same(out)
    assert "aoi.cohort.leave" in names and "aoi.cohort.join" in names
    assert coh.cohort_stats == engines["jax"].cohort_stats == {
        "cohort_joins": 1, "cohort_leaves": 1, "cohort_demoted_spaces": 0}
    samples = {s.name: s.value for s in coh._telemetry_collect()}
    assert samples["aoi.cohort_joins"] == samples["aoi.cohort_leaves"] == 1
    assert samples["aoi.cohorts"] == 2
    assert samples["aoi.cohort_spaces"] == len(CAPS)


@pytest.mark.parametrize("mode", ["pipeline", "cross_tick"])
def test_cohort_join_leave_deferred(mode):
    """Under a one-tick deferral the export delivers the tick in flight
    before a space moves: the stream equals the oracle's shifted by one,
    with nothing dropped or repeated."""
    port = AOIEngine(device="cpu", cohort="auto", **{mode: True})
    engines = {"cpu": JaxEngine(default_backend="cpu"), "cohort": port}
    handles = {k: [e.create_space(c) for c in CAPS]
               for k, e in engines.items()}
    out = _drive(engines, handles, 3)
    port.cohort_leave(handles["cohort"][1])
    mid = _drive(engines, handles, 3)
    port.cohort_join(handles["cohort"][1])
    late = _drive(engines, handles, 3)
    port.drain()
    tail = [port.take_events(h) for h in handles["cohort"]]
    got = out["cohort"] + mid["cohort"] + late["cohort"] + [tail]
    want = out["cpu"] + mid["cpu"] + late["cpu"]
    assert all(len(e) + len(lv) == 0 for e, lv in got[0])
    for t, row in enumerate(want):
        for si, ((we, wl), (ge, gl)) in enumerate(zip(row, got[t + 1])):
            np.testing.assert_array_equal(ge, we, err_msg=f"{t} {si}")
            np.testing.assert_array_equal(gl, wl, err_msg=f"{t} {si}")


def test_cohort_demote_span_and_staged_carry():
    _install("aoi.cohort:fail@2")
    engines, handles = _engines()
    telemetry.enable()
    trace.reset()
    out = _drive(engines, handles, 3)
    names = [nm for nm, *_ in trace.spans()]
    telemetry.disable()
    _assert_same(out)
    assert "aoi.cohort.demote" in names
    assert _fired()[0] == _fired()[1] == [("aoi.cohort", "fail", 2)]


def test_grow_space_from_cohort_crosses_rungs():
    engines, handles = _engines()
    _assert_same(_drive(engines, handles, 3))
    nh = engines["cohort"].grow_space(handles["cohort"][0], 512)
    assert nh.capacity == 1024 and nh.bucket.cohort
    handles["cohort"][0] = nh
    for k in ("cpu", "jax", "solo"):
        handles[k][0] = engines[k].grow_space(handles[k][0], 512)
    assert handles["solo"][0].capacity == handles["jax"][0].capacity == 1024
    _assert_same(_drive(engines, handles, 3))


# -- the planner ---------------------------------------------------------------

def test_cohort_planner_rejoins_demoted_spaces():
    _install("aoi.cohort:fail@1x2")
    engines, handles = _engines()
    del engines["solo"], handles["solo"]
    coh = engines["cohort"]
    planners = [CohortPlanner(coh, mode="auto", hot_ms=1e9, churn_budget=2,
                              cooldown_ticks=0),
                JaxPlanner(engines["jax"], mode="auto", hot_ms=1e9,
                           churn_budget=2, cooldown_ticks=0)]
    _drive(engines, handles, 3)
    faults.clear()
    jfaults.clear()
    assert coh.cohort_stats["cohort_demoted_spaces"] == len(CAPS)
    for _ in range(4):  # budget 2 a window: the spaces rejoin in waves
        for p in planners:
            p.step()
        _drive(engines, handles, 1)
        assert coh.cohort_stats == engines["jax"].cohort_stats
    assert coh.cohort_stats["cohort_joins"] == len(CAPS)
    assert sorted(coh._buckets) == [("cuda-cohort", 256),
                                    ("cuda-cohort", 1024)]
    _assert_same(_drive(engines, handles, 3))


def test_cohort_planner_sheds_hot_cohort_member():
    engines, handles = _engines()
    coh = engines["cohort"]
    _drive(engines, handles, 2)
    CohortPlanner(coh, mode="static", hot_ms=0.0).step()
    assert coh.cohort_stats["cohort_leaves"] == 0
    planners = [CohortPlanner(coh, mode="auto", hot_ms=0.0, churn_budget=1,
                              cooldown_ticks=0),
                JaxPlanner(engines["jax"], mode="auto", hot_ms=0.0,
                           churn_budget=1, cooldown_ticks=0)]
    _drive(engines, handles, 1)  # a sample for the planners' window
    for p in planners:
        p.step()
    assert coh.cohort_stats == engines["jax"].cohort_stats
    assert coh.cohort_stats["cohort_leaves"] == 1
    assert handles["cohort"][0].bucket.cohort_solo  # the lowest slot went
    _assert_same(_drive(engines, handles, 3))
    with pytest.raises(ValueError):
        CohortPlanner(coh, mode="bogus")


def test_runtime_cohort_knobs():
    from goworld_tpu_torch.engine.runtime import Runtime

    rt = Runtime(device="cpu", aoi_cohort=True, aoi_cohort_planner="auto",
                 aoi_cohort_ladder=(256, 1024), aoi_cohort_hot_ms=5.0,
                 aoi_cohort_churn_budget=3, aoi_cohort_cooldown=7)
    p = rt.cohort_planner
    assert isinstance(p, CohortPlanner)
    assert (p.mode, p.hot_ms, p.churn_budget, p.cooldown_ticks) == \
        ("auto", 5.0, 3, 7)
    assert rt.aoi.cohort == "auto" and rt.aoi.cohort_ladder == (256, 1024)
    h = rt.aoi.create_space(200)
    assert h.bucket.cohort
    for _ in range(3):
        rt.tick()
    assert p._tick == 3
    assert Runtime(device="cpu").cohort_planner is None


# -- evacuation of a solo bucket (its tier) -----------------------------------

def test_solo_bucket_evacuates_to_cuda_tier():
    """A solo (and a cohort) bucket's tier is ``cuda``, checked before
    ``exclusive``: losing its device re-homes the space on the shared
    ``cuda`` bucket of its rung, bit-exact against the oracle, where a
    ``rowshard`` answer would raise on a single-device engine."""
    eng = AOIEngine(device="cpu", cohort="solo")
    coh = AOIEngine(device="cpu", cohort="auto")
    assert eng._tier_of(eng.create_space(200).bucket) == "cuda"
    assert coh._tier_of(coh.create_space(200).bucket) == "cuda"
    faults.install("aoi.device:reset@4")
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "solo": AOIEngine(device="cpu", cohort="solo")}
    handles = {k: [e.create_space(c) for c in (200, 256)]
               for k, e in engines.items()}
    out = _drive(engines, handles, 6)
    _assert_same(out)
    solo = engines["solo"]
    assert solo.migration_stats["evacuations"] == 1
    assert ("cuda", 256) in solo._buckets
    assert faults.plan().fired[0]["seam"] == "aoi.device"


# -- planes: stack / unstack / pad, held to the JAX functions ----------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stack_unstack_equal_jax(seed):
    rng = np.random.default_rng(seed)
    caps = [int(rng.choice((128, 256, 384, 512, 1024)))
            for _ in range(int(rng.integers(2, 7)))]
    shape = max(AC.cohort_shape(c) for c in caps)
    snaps = [_snap(rng, c) for c in caps]
    planes = AC.stack_spaces(snaps, shape)
    want = JAC.stack_spaces(snaps, shape)
    for k in want:
        assert planes[k].dtype == want[k].dtype
        np.testing.assert_array_equal(planes[k].view(np.uint8),
                                      want[k].view(np.uint8), err_msg=k)
    back = AC.unstack_spaces(planes, caps)
    jback = JAC.unstack_spaces(want, caps)
    for i, (snap, rt, jrt) in enumerate(zip(snaps, back, jback)):
        _assert_snap_equal(snap, rt, caps[i], msg=f"space {i}")
        for k in ("r", "act", "words"):
            np.testing.assert_array_equal(rt[k], jrt[k])
        for a, b in zip(rt["packet"], jrt["packet"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap,shape", [(256, 1024), (384, 1024),
                                       (128, 256), (256, 4096)])
def test_pad_snapshot_equal_jax(cap, shape):
    rng = np.random.default_rng(cap + shape)
    snap = _snap(rng, cap)
    padded = AC.pad_snapshot(snap, shape)
    want = JAC.pad_snapshot(snap, shape)
    for k in ("r", "act", "words"):
        np.testing.assert_array_equal(padded[k], want[k], err_msg=k)
    assert padded["capacity"] == shape and padded["sub"] == want["sub"]
    with pytest.raises(ValueError):
        AC.pad_snapshot(padded, cap)


def test_run_cohort_step_equal_jax():
    """One whole-cohort step over stacked planes (the plain version on
    the CPU) equals the JAX jitted cohort step, and records its key."""
    rng = np.random.default_rng(3)
    snaps = [_snap(rng, c) for c in (128, 256, 200 // 128 * 128 + 128)]
    planes = AC.stack_spaces(snaps, 256)
    DC.clear_keys()
    new, chg = AC.run_cohort_step("cuda", 256, planes, device="cpu")
    jnew, jchg = JAC.run_cohort_step("tpu", 256, planes)
    np.testing.assert_array_equal(new, jnew)
    np.testing.assert_array_equal(chg, jchg)
    assert DC.new_keys() == 1
    assert AC.cohort_step("cuda", 256) is AC.cohort_step("cuda", 256)


def test_snapshots_cross_between_packages():
    """A snapshot exported by a JAX cohort bucket, padded by the port,
    imports into a port cohort bucket (and the other way round) and
    exports back bit for bit."""
    rng = np.random.default_rng(5)
    jeng = JaxEngine(default_backend="tpu", cohort="auto")
    peng = AOIEngine(device="cpu", cohort="auto")
    jh = jeng.create_space(200)
    ph = peng.create_space(200)
    snap = _snap(rng, 128)
    jh.bucket.import_snapshot(jh.slot, JAC.pad_snapshot(snap, 256))
    from_jax = jh.bucket.export_snapshot(jh.slot)
    ph.bucket.import_snapshot(ph.slot, AC.pad_snapshot(from_jax, 256))
    _assert_snap_equal(from_jax, ph.bucket.export_snapshot(ph.slot), 256)
    snap2 = AC.pad_snapshot(_snap(rng, 128), 256)
    ph.bucket.import_snapshot(ph.slot, snap2)
    jh.bucket.import_snapshot(jh.slot, ph.bucket.export_snapshot(ph.slot))
    _assert_snap_equal(snap2, jh.bucket.export_snapshot(jh.slot), 256)


def test_round_trip_through_live_cohort_bucket():
    rng = np.random.default_rng(5)
    eng = AOIEngine(device="cpu", cohort="auto")
    hs = [eng.create_space(200) for _ in range(3)]
    bucket = hs[0].bucket
    snaps = [AC.pad_snapshot(_snap(rng, 128), 256) for _ in hs]
    for h, s in zip(hs, snaps):
        bucket.import_snapshot(h.slot, s)
    for h, s in zip(hs, snaps):
        _assert_snap_equal(s, bucket.export_snapshot(h.slot), 256)
    freed = hs[1].slot
    eng.release_space(hs[1])
    nh = eng.create_space(240)
    assert nh.bucket is bucket and nh.slot == freed
    ns = AC.pad_snapshot(_snap(rng, 128), 256)
    bucket.import_snapshot(nh.slot, ns)
    _assert_snap_equal(ns, bucket.export_snapshot(nh.slot), 256)
    for h, s in ((hs[0], snaps[0]), (hs[2], snaps[2])):
        _assert_snap_equal(s, bucket.export_snapshot(h.slot), 256)


def test_round_trip_survives_grow():
    rng = np.random.default_rng(9)
    eng = AOIEngine(device="cpu", cohort="auto")
    h = eng.create_space(256)
    snap = _snap(rng, 256)
    h.bucket.import_snapshot(h.slot, snap)
    nh = eng.grow_space(h, 512)
    assert nh.capacity == 1024
    m0 = P.unpack_rows(snap["words"], 256)
    m1 = P.unpack_rows(nh.bucket.get_prev(nh.slot), 1024)
    np.testing.assert_array_equal(m1[:256, :256], m0)
    assert not m1[256:].any() and not m1[:, 256:].any()


def test_release_frees_solo_bucket():
    eng = AOIEngine(device="cpu", cohort="solo", fused=True)
    hs = [eng.create_space(200) for _ in range(3)]
    assert len(eng._buckets) == 3
    for h in hs:
        eng.release_space(h)
    assert eng._buckets == {}


def test_cross_cohort_page_lending():
    loads = [(256, 220), (256, 4)]
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "cohort": AOIEngine(device="cpu", cohort="auto", paged=True),
               "solo": AOIEngine(device="cpu", cohort="solo", paged=True)}
    handles = {k: [e.create_space(c) for c, _n in loads]
               for k, e in engines.items()}
    scenes = [list(_scene(21 + i, cap, n))
              for i, (cap, n) in enumerate(loads)]
    out = {k: [] for k in engines}
    for _t in range(6):
        for (rng, xs, zs, _rr, _act) in scenes:
            _sparse_step(rng, xs, zs)
        for k, e in engines.items():
            for (_rng, xs, zs, rr, act), h in zip(scenes, handles[k]):
                cap = h.capacity
                e.submit(h, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                         _pad(act, cap))
            e.flush()
            out[k].append([e.take_events(h) for h in handles[k]])
    _assert_same(out)
    bucket = handles["cohort"][0].bucket
    assert bucket is handles["cohort"][1].bucket
    assert bucket.stats["page_occupancy"] > 0
