"""The port's snapshots, live migration and chip-loss evacuation
(``goworld_tpu_torch/engine/placement.py``, the buckets' snapshot
methods, ``AOIEngine._evacuate_bucket``) against the JAX package.

The same seeded numpy walks go through the port (``device="cpu"``: the
plain PyTorch step under every device bucket; the mesh and row-sharded
buckets on 2 virtual CPU shards, so that capacity 256 row-shards) and
through the JAX package's ``cpu`` bucket (its numpy oracle).  Tolerance:
exact.  The wire images equal the JAX package's key by key and bit for
bit; every migrated, evacuated or imported space's concatenated
enter/leave stream equals the JAX ``cpu`` stream of the same walk that
never moved (concatenated, because a move across a deferred tier shifts
delivery by one tick, never its content).
"""

import numpy as np
import pytest

from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.engine.aoi import _build_snapshot as jax_build_snapshot
from goworld_tpu.engine.aoi import _unpack_positions as jax_unpack
from goworld_tpu_torch import faults, telemetry
from goworld_tpu_torch.engine import aoi as A
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.engine.placement import (MigrationError,
                                                PlacementController, _lag)
from goworld_tpu_torch.interest import TeamVisibilityPolicy, TieredRatePolicy
from goworld_tpu_torch.parallel import SpaceMesh
from goworld_tpu_torch.telemetry import trace

TIERS = ("cpu", "cpp", "cuda", "mesh", "rowshard")
CAP = 256
N_TICKS = 10
MIGRATE_AT = 4
FAULT_AT = 5


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear()
    yield
    faults.clear()


def _walk(seed, cap, n, frac=1.0):
    """``n`` ticks of a seeded walk (``frac`` of the entities move a
    tick: a sparse walk lets the fused tick engage)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 100.0, cap).astype(np.float32)
    z = rng.uniform(0.0, 100.0, cap).astype(np.float32)
    r = np.full(cap, 12.0, np.float32)
    act = np.ones(cap, bool)
    for _ in range(n):
        sel = rng.random(cap) < frac
        x = x + np.where(sel, rng.uniform(-3.0, 3.0, cap), 0.0).astype(
            np.float32)
        z = z + np.where(sel, rng.uniform(-3.0, 3.0, cap), 0.0).astype(
            np.float32)
        yield x.copy(), z.copy(), r, act


def _engine(**kw):
    return AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * 2), **kw)


def _collect(eng, h, evs):
    e, lv = eng.take_events(h)
    evs.append((np.array(e), np.array(lv)))


def _cat(evs):
    return (np.concatenate([e for e, _ in evs]),
            np.concatenate([lv for _, lv in evs]))


def _run(src, tgt=None, mig_at=-1, *, plan=None, n=N_TICKS, frac=1.0,
         **kw):
    """One space's walk on the port, from tier ``src``, with a live
    migration to ``tgt`` started before tick ``mig_at``; the concatenated
    (enters, leaves) and the engine, handle and migration."""
    faults.clear()
    if plan is not None:
        faults.install(plan)
    eng = _engine(**kw)
    pc = PlacementController(eng)
    h = eng._create_handle(CAP, src)
    mig = None
    evs = []
    for t, (x, z, r, act) in enumerate(_walk(7, CAP, n, frac)):
        if t == mig_at:
            mig = pc.migrate(h, tgt)
        eng.submit(h, x, z, r, act)
        eng.flush()
        _collect(eng, h, evs)
    while eng.has_pending():
        eng.flush()
        _collect(eng, h, evs)
    faults.clear()
    return (*_cat(evs), eng, h, mig)


_REFS: dict = {}


def _jax_ref(n=N_TICKS, frac=1.0):
    """The JAX ``cpu`` bucket's stream of the unmigrated walk."""
    key = (n, frac)
    if key not in _REFS:
        eng = JaxEngine(default_backend="cpu")
        h = eng.create_space(CAP, "cpu")
        evs = []
        for x, z, r, act in _walk(7, CAP, n, frac):
            eng.submit(h, x, z, r, act)
            eng.flush()
            _collect(eng, h, evs)
        _REFS[key] = _cat(evs)
    return _REFS[key]


def _assert_ref(e, lv, n=N_TICKS, frac=1.0):
    re_, rl = _jax_ref(n, frac)
    assert len(re_) and len(rl), "degenerate walk: no events"
    np.testing.assert_array_equal(e, re_, err_msg="enter stream diverged")
    np.testing.assert_array_equal(lv, rl, err_msg="leave stream diverged")


# -- the wire image ------------------------------------------------------------

def _edge_columns(c, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-50, 50, c).astype(np.float32)
    z = rng.uniform(-50, 50, c).astype(np.float32)
    sub = np.float32(1e-40)
    x[::7] = 0.0
    z[::7] = 0.0  # never written: no packet entry
    x[1::11], z[2::11] = -0.0, -0.0
    x[3::13], z[4::13] = np.nan, sub
    x[5::17], z[6::17] = np.inf, -np.inf
    x[8::19], z[8::19] = -sub, np.float32(np.nan)
    return x, z


@pytest.mark.parametrize("c", [128, 1056])
def test_wire_image_matches_jax(c):
    """The port's _build_snapshot / _unpack_positions against JAX's: the
    same keys, dtypes, shapes and bits, with -0.0, NaN, +-inf and
    subnormal positions (all travel; a 0.0 never written does not)."""
    x, z = _edge_columns(c, c)
    rng = np.random.default_rng(1)
    r = rng.choice([0.0, 5.0, np.inf, np.nan], c).astype(np.float32)
    act = rng.random(c) < 0.7
    words = rng.integers(0, 2**32, (c, c // 32), dtype=np.uint64).astype(
        np.uint32)
    for sub in (True, False):
        got = A._build_snapshot(c, x, z, r, act, sub, words)
        want = jax_build_snapshot(c, x, z, r, act, sub, words)
        assert sorted(got) == sorted(want)
        assert got["capacity"] == want["capacity"] and got["sub"] is sub
        for k in ("r", "act", "words"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
        for a, b in zip(got["packet"], want["packet"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        zero = ((x.view(np.uint32) == 0) & (z.view(np.uint32) == 0))
        assert set(got["packet"][1].tolist()) == \
            set(np.nonzero(~zero)[0].tolist())
        for a, b in zip(A._unpack_positions(got), jax_unpack(want)):
            assert a.tobytes() == b.tobytes()
        ux, uz = A._unpack_positions(got)
        assert ux.tobytes() == x.tobytes() and uz.tobytes() == z.tobytes()
    empty = A._build_snapshot(c, np.zeros(c, np.float32),
                              np.zeros(c, np.float32), r, act, True, words)
    assert empty["packet"] is None
    assert jax_build_snapshot(c, np.zeros(c, np.float32),
                              np.zeros(c, np.float32), r, act, True,
                              words)["packet"] is None


def _walked(eng, h, n=6):
    for x, z, r, act in _walk(3, CAP, n):
        eng.submit(h, x, z, r, act)
        eng.flush()
        eng.take_events(h)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("deferred", [False, True], ids=["sync", "pipe"])
def test_export_snapshot_matches_jax_cpu(tier, deferred):
    """Every port bucket kind's snapshot after a walk equals the JAX
    ``cpu`` bucket's after the same walk: words, sub, r, act and the
    packet, exactly (a deferred bucket delivers its tick first)."""
    jeng = JaxEngine(default_backend="cpu")
    jh = jeng.create_space(CAP, "cpu")
    _walked(jeng, jh)
    want = jh.bucket.export_snapshot(jh.slot)
    eng = _engine(pipeline=deferred)
    h = eng._create_handle(CAP, tier)
    _walked(eng, h)
    got = h.bucket.export_snapshot(h.slot)
    assert sorted(got) == sorted(want) and got["sub"] is want["sub"]
    for k in ("r", "act", "words"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    for a, b in zip(got["packet"], want["packet"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if tier not in ("cpu", "cpp"):
        eng.set_subscribed(h, False)
        assert h.bucket.export_snapshot(h.slot)["sub"] is False
    # the bucket evacuates every occupied slot
    snaps = h.bucket.evacuate()
    assert list(snaps) == [h.slot]
    assert np.array_equal(snaps[h.slot]["words"], want["words"])


@pytest.mark.parametrize("tier", ["cuda", "mesh", "rowshard"])
def test_jax_snapshot_imports_into_port(tier):
    """A snapshot the JAX ``cpu`` bucket exported mid-walk, imported into
    a port device bucket: the next ticks give the events of the JAX run
    that never moved, and the port's re-export round-trips it."""
    jeng = JaxEngine(default_backend="cpu")
    jh = jeng.create_space(CAP, "cpu")
    frames = list(_walk(11, CAP, 8))
    for x, z, r, act in frames[:4]:
        jeng.submit(jh, x, z, r, act)
        jeng.flush()
        jeng.take_events(jh)
    snap = jh.bucket.export_snapshot(jh.slot)
    eng = _engine()
    h = eng._create_handle(CAP, tier)
    h.bucket.import_snapshot(h.slot, snap)
    again = h.bucket.export_snapshot(h.slot)
    for k in ("r", "act", "words"):
        assert np.array_equal(again[k], snap[k])
    for a, b in zip(again["packet"], snap["packet"]):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        h.bucket.import_snapshot(h.slot, dict(snap, capacity=2 * CAP))
    for x, z, r, act in frames[4:]:
        for e_, hh in ((jeng, jh), (eng, h)):
            e_.submit(hh, x, z, r, act)
            e_.flush()
        je, jl = jeng.take_events(jh)
        pe, pl = eng.take_events(h)
        assert len(je) + len(jl) > 0
        np.testing.assert_array_equal(pe, je)
        np.testing.assert_array_equal(pl, jl)


def test_import_restages_every_role():
    """The import marks x/z, r/act and sub stale on the single-device
    bucket and writes the subscription flag: the next tick uploads every
    role whole (a fused bucket then runs it unfused)."""
    eng = AOIEngine(device="cpu", fused=True)
    src = eng._create_handle(CAP, "cpu")
    _walked(eng, src, n=2)
    snap = dict(src.bucket.export_snapshot(src.slot), sub=False)
    h = eng._create_handle(CAP, "cuda")
    b = h.bucket
    b._dev_stale.clear()
    b.import_snapshot(h.slot, snap)
    assert b._dev_stale == {"xz", "ra", "sub"}
    assert not b._hsub[h.slot] and h.slot in b._unsub


# -- live migration ----------------------------------------------------------

# (src, tgt, modes): every tier as source and as target; L = lag_t - lag_s
# in {-1, 0, +1}; both schedulers; fused and paged targets
PAIRS = [
    ("cpu", "cuda", {}),                                  # L = 0
    ("cpu", "cuda", {"pipeline": True}),                  # L = +1
    ("cpu", "cuda", {"cross_tick": True}),                # L = +1
    ("cuda", "cpu", {"pipeline": True, "flush_sched": False}),  # L = -1
    ("cpp", "cpu", {}),
    ("cuda", "cuda", {"pipeline": True}),                 # same tier
    ("cuda", "mesh", {"flush_sched": False}),
    ("mesh", "rowshard", {"pipeline": True}),             # L = -1
    ("rowshard", "cuda", {"pipeline": True}),             # L = +1
    ("rowshard", "cpp", {}),
    ("cpp", "rowshard", {"pipeline": True, "flush_sched": False}),
    ("mesh", "cpu", {}),
    ("cpu", "mesh", {"cross_tick": True}),                # L = +1
    ("cuda", "mesh", {"pipeline": True}),                 # L = 0
    ("cpu", "cuda", {"paged": True}),
    ("mesh", "cuda", {"paged": True, "pipeline": True}),
]


def _pair_id(p):
    s, t, kw = p
    return f"{s}-to-{t}" + "".join(f"-{k}" for k in kw)


@pytest.mark.parametrize("src,tgt,kw", PAIRS, ids=[_pair_id(p) for p in PAIRS])
def test_migration_equals_unmigrated_jax(src, tgt, kw):
    e, lv, eng, h, mig = _run(src, tgt, MIGRATE_AT, **kw)
    _assert_ref(e, lv)
    assert mig.done and mig.verified >= mig.need
    assert mig.crc != 0, "the cover verified no non-empty flush"
    assert eng.migration_stats["migrations"] == 1
    assert eng.migration_stats["migration_rollbacks"] == 0
    assert eng.migration_stats["migration_ms"] > 0.0
    assert eng._tier_of(h.bucket) == tgt or {tgt, eng._tier_of(
        h.bucket)} == {"cpu", "cpp"}  # cpp without libgwaoi is the oracle
    assert h._migration is None and not h.released
    lag = _lag(h.bucket) - mig.lag_s
    assert lag == mig.lag_t - mig.lag_s
    if tgt == "rowshard":
        assert not any(b.exclusive for b in eng._buckets.values()
                       if b is not h.bucket and hasattr(b, "exclusive"))


def test_migration_into_fused_target_restages_first():
    """A fused single-device target: the tick after the import runs
    unfused (a full restage: its device x/z are stale), later steady
    ticks replay the fused body, and the stream stays exact."""
    e, lv, eng, h, mig = _run("cpu", "cuda", MIGRATE_AT, frac=0.1,
                              n=N_TICKS + 4, fused=True)
    _assert_ref(e, lv, n=N_TICKS + 4, frac=0.1)
    assert mig.done
    st = h.bucket.stats
    assert st["full_flushes"] >= 1 and st["fused_dispatches"] >= 3, st


def test_lag_keys_on_the_deferral():
    """_lag reads the bucket's real deferral: the row-sharded bucket
    accepts pipeline and cross_tick but delivers in the flush (lag 0,
    though it carries an _inflight); deferred single-device and mesh
    buckets lag 1; host buckets 0."""
    for kw in ({"pipeline": True}, {"cross_tick": True}):
        eng = _engine(**kw)
        row = eng._create_handle(CAP, "rowshard").bucket
        assert row.pipeline or row.cross_tick
        assert hasattr(row, "_inflight") and _lag(row) == 0
        assert _lag(eng._create_handle(CAP, "cuda").bucket) == 1
        assert _lag(eng._create_handle(CAP, "mesh").bucket) == 1
        assert _lag(eng._create_handle(CAP, "cpu").bucket) == 0
    eng = _engine()
    assert _lag(eng._create_handle(CAP, "cuda").bucket) == 0


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipe"])
def test_oom_mid_cover_rolls_back(pipeline):
    """aoi.h2d:oom on the replayed target during the cover (the host
    source never crosses aoi.h2d): the migration rolls back, the source
    keeps serving, nothing is lost; a new migration then completes."""
    e, lv, eng, h, mig = _run("cpu", "cuda", MIGRATE_AT, pipeline=pipeline,
                              plan="aoi.h2d:oom@1")
    _assert_ref(e, lv)
    assert mig.done
    assert eng.migration_stats["migrations"] == 0
    assert eng.migration_stats["migration_rollbacks"] == 1
    assert eng._tier_of(h.bucket) == "cpu" and not h.released
    mig2 = PlacementController(eng).migrate(h, "cuda")
    for x, z, r, act in _walk(99, CAP, 4):
        eng.submit(h, x, z, r, act)
        eng.flush()
        eng.take_events(h)
    assert mig2.done and eng.migration_stats["migrations"] == 1


def test_chip_loss_during_cover_aborts_it():
    """The target's device is lost mid-cover (its second aoi.device
    crossing: the first is the import's maintenance, the second the
    cover's first tick): the cover aborts (the rollback), the lost bucket
    evacuates what is left on it (nothing), and the source's stream stays
    exact."""
    e, lv, eng, h, mig = _run("cpu", "cuda", MIGRATE_AT,
                              plan="aoi.device:reset@2")
    _assert_ref(e, lv)
    assert mig.done and h._migration is None and not h.released
    assert eng.migration_stats["migration_rollbacks"] == 1
    assert eng.migration_stats["migrations"] == 0
    assert eng.migration_stats["evacuations"] == 1
    assert eng._tier_of(h.bucket) == "cpu"
    assert list(eng._buckets) == [("cpu", CAP)]


# -- chip loss ---------------------------------------------------------------

@pytest.mark.parametrize("tier", ["cuda", "mesh", "rowshard"])
@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipe"])
def test_chip_loss_evacuates(tier, pipeline):
    """aoi.device:reset mid-walk: the tick is recovered on the host, the
    bucket's spaces are rebuilt on a fresh bucket of the same tier at
    calc level 0, the handle is re-pointed in place, and the stream
    equals the oracle's."""
    e, lv, eng, h, _m = _run(tier, pipeline=pipeline,
                             plan=f"aoi.device:reset@{FAULT_AT}")
    _assert_ref(e, lv)
    assert eng.migration_stats["evacuations"] == 1
    assert eng._tier_of(h.bucket) == tier and not h.released
    b = h.bucket
    assert b.stats["calc_level"] == 0 and not b._evacuating
    assert b.stats["host_ticks"] == 0 and b.stats["rebuilds"] == 0
    assert not any(getattr(x, "_evacuating", False)
                   for x in eng._buckets.values())
    assert any(x is b for x in eng._buckets.values())


def test_evacuation_carries_every_space():
    """Three spaces on one lost bucket: each is rebuilt on the one fresh
    bucket, and each stream equals its own unmoved JAX run."""
    faults.install("aoi.device:reset@3")
    eng = AOIEngine(device="cpu", pipeline=True)
    jeng = JaxEngine(default_backend="cpu")
    hs = [eng.create_space(CAP) for _ in range(3)]
    jhs = [jeng.create_space(CAP, "cpu") for _ in range(3)]
    walks = [list(_walk(s, CAP, 7)) for s in (1, 2, 3)]
    out = {id(h): [] for h in hs + jhs}
    for t in range(7):
        for (en, hh) in ((eng, hs), (jeng, jhs)):
            for h, w in zip(hh, walks):
                en.submit(h, *w[t])
            en.flush()
            for h in hh:
                _collect(en, h, out[id(h)])
    eng.drain()
    for h in hs:
        _collect(eng, h, out[id(h)])
    assert len({id(h.bucket) for h in hs}) == 1
    assert hs[0].bucket.stats["calc_level"] == 0
    assert eng.migration_stats["evacuations"] == 1
    for h, jh in zip(hs, jhs):
        for a, b in zip(_cat(out[id(h)]), _cat(out[id(jh)])):
            np.testing.assert_array_equal(a, b)


# -- the audit trail ---------------------------------------------------------

def _spans_named(name):
    return [(nm, t0, t1) for nm, _tid, t0, t1 in trace.spans() if nm == name]


def test_span_order():
    """aoi.migrate wraps the snapshot and the replay; every cover
    follows the replay; the swap nests in the last cover; an evacuation
    records aoi.evacuate."""
    telemetry.enable()
    trace.reset()
    try:
        _run("cpu", "cuda", MIGRATE_AT)
        outer, snap, rep, covers, swaps = (_spans_named(n) for n in (
            "aoi.migrate", "aoi.migrate.snapshot", "aoi.migrate.replay",
            "aoi.migrate.cover", "aoi.migrate.swap"))
        trace.reset()
        _run("cuda", plan=f"aoi.device:reset@{FAULT_AT}")
        evac = _spans_named("aoi.evacuate")
    finally:
        telemetry.disable()
    assert len(outer) == len(snap) == len(rep) == len(swaps) == 1
    assert covers and len(evac) == 1
    assert outer[0][1] <= snap[0][1] and snap[0][2] <= rep[0][1] \
        and rep[0][2] <= outer[0][2]
    assert rep[0][2] <= covers[0][1]
    last = covers[-1]
    assert last[1] <= swaps[0][1] and swaps[0][2] <= last[2]


# -- the controller ----------------------------------------------------------

def test_controller_rejects_bad_handles_and_tiers():
    eng = AOIEngine(device="cpu")
    pc = PlacementController(eng)
    h = eng.create_space(64, "cpu")
    for x, z, r, act in _walk(1, 64, 1):
        eng.submit(h, x, z, r, act)
    eng.flush()
    eng.take_events(h)
    for tier, msg in (("tpu", "'cuda'"), ("gpu", "unknown placement tier"),
                      ("mesh", "mesh engine"), ("rowshard", "mesh engine")):
        with pytest.raises(ValueError, match=msg):
            pc.migrate(h, tier)
    with pytest.raises(ValueError, match="row-shard"):
        _engine()._create_handle(384, "rowshard")
    assert h._migration is None
    pc.migrate(h, "cuda")
    with pytest.raises(MigrationError):
        pc.migrate(h, "cpu")        # one migration at a time per handle
    eng.release_space(h)            # aborts the cover, then releases
    assert eng.migration_stats["migration_rollbacks"] == 1
    with pytest.raises(MigrationError):
        pc.migrate(h, "cuda")       # a released handle does not move


def test_controller_mode_validated():
    with pytest.raises(ValueError, match="aoi_placement"):
        PlacementController(AOIEngine(device="cpu"), mode="adaptive")


@pytest.mark.parametrize("mode", ["auto", "static"])
def test_auto_promotes_hot_host_bucket_static_never_moves(mode):
    """``auto`` with a zero threshold moves the hot host space onto the
    device tier (the stream exact); ``static`` never moves it."""
    eng = AOIEngine(device="cpu")
    pc = PlacementController(eng, mode=mode, threshold_ms=0.0,
                             cooldown_ticks=0)
    h = eng.create_space(CAP, "cpu")
    evs = []
    for x, z, r, act in _walk(7, CAP, N_TICKS):
        eng.submit(h, x, z, r, act)
        eng.flush()
        _collect(eng, h, evs)
        pc.step()
    _assert_ref(*_cat(evs))
    if mode == "auto":
        assert eng.migration_stats["migrations"] >= 1
        assert eng._tier_of(h.bucket) == "cuda"
    else:
        assert eng.migration_stats["migrations"] == 0
        assert eng._tier_of(h.bucket) == "cpu"


def test_load_samples_shape():
    eng = AOIEngine(device="cpu")
    pc = PlacementController(eng)
    h = eng.create_space(64, "cpu")
    hd = eng.create_space(64, "cuda")
    for x, z, r, act in _walk(3, 64, 2):
        for hh in (h, hd):
            eng.submit(hh, x, z, r, act)
        eng.flush()
    samples = pc.load_samples()
    assert [s.tier for s in samples] == ["cpu", "cuda"]
    for s in samples:
        assert s.entities == 1 and s.flush_ms >= 0.0 and s.h2d_bytes >= 0.0
    assert samples[1].h2d_bytes > 0
    pc.settle()
    assert pc._cooldown == pc.cooldown_ticks


# -- a stacked space ---------------------------------------------------------

def test_stack_events_unchanged_across_move():
    """A space with a team + tier stack moves cuda -> cpp -> cuda
    (pipelined: L = -1 then +1): the stack's stream equals the unmoved
    space's, and the base state under it equals the JAX stream."""
    rng = np.random.default_rng(5)
    team = (np.uint32(1) << rng.integers(0, 3, CAP).astype(np.uint32))
    vis = np.where(rng.random(CAP) < 0.7, 0xFFFFFFFF, 1).astype(np.uint32)
    runs = {}
    for moved in (False, True):
        eng = AOIEngine(device="cpu", pipeline=True)
        pc = PlacementController(eng)
        h = eng.create_space(CAP, "cuda")
        stack = eng.attach_interest(h, [TeamVisibilityPolicy(),
                                        TieredRatePolicy(period=2)])
        evs = []
        for t, (x, z, r, act) in enumerate(_walk(7, CAP, 12)):
            if moved and t == 3:
                pc.migrate(h, "cpp")
            if moved and t == 7:
                assert eng._tier_of(h.bucket) == "cpp"
                pc.migrate(h, "cuda")
            eng.submit(h, x, z, r, act)
            stack.submit(x, z, r, act, team, vis)
            eng.flush()
            _collect(eng, h, evs)
        runs[moved] = (_cat(evs), eng.interest_stack(h) is stack,
                       eng.migration_stats["migrations"],
                       h.bucket.get_prev(h.slot))
    (e0, l0), same0, n0, w0 = runs[False]
    (e1, l1), same1, n1, w1 = runs[True]
    assert same0 and same1 and n0 == 0 and n1 == 2
    assert len(e0) and np.array_equal(e0, e1) and np.array_equal(l0, l1)
    assert np.array_equal(w0, w1)
