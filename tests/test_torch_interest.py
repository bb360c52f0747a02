"""The port's interest-policy stacks (goworld_tpu_torch.interest and
ops/interest_kernels, ops/interest_cuda) against the JAX package's.

The same numpy-seeded inputs go through both packages.  Tolerance: exact
equality everywhere.

* The stack step's plain version (``interest_cuda.interest_step`` on CPU
  tensors: ``interest_kernels.step_words`` with ``xp=torch``) and the
  port's numpy oracle against the JAX jitted step
  (``goworld_tpu.interest.device.eval_step`` on the CPU) and the JAX numpy
  oracle, for the six policy mixes of ``tests/test_interest.py``, full
  and off-cadence, LOS depths 1-4.
* Edge inputs: ties at ``r*near_frac`` and ``rn*hysteresis``, -0.0, NaN,
  +-inf, samples outside the world, team bit 31, inactive slots.  A NaN
  sample coordinate (an infinite radius across +inf -> -inf) is held to
  the JAX jitted step, which maps it to cell 0; the JAX numpy oracle
  raises IndexError there (its cast gives INT_MIN: a fault of the
  reference, ROADMAP.md queue 3), and the port's host mode answers
  like its device mode.  Subnormal inputs are held to the JAX numpy
  oracle (XLA's CPU backend flushes them to zero).
* ``PolicyStack`` on the device path (``device="cpu"``) against host
  mode and the JAX host stack; the engine seam on every bucket kind of
  the port (cpu, cuda, mesh, row-sharded; +-paged, +-cross_tick) against
  the JAX ``PolicyStack(mode="host")``; the ``aoi.interest`` seam, a
  corrupt field, the single-step fallback, growth, ``clear_entity``, the
  payload round trip, validation and the counters.
"""

import numpy as np
import pytest
import torch

from goworld_tpu import faults as jfaults
from goworld_tpu import interest as JI
from goworld_tpu.interest import device as JD
from goworld_tpu.interest import oracle as JO
from goworld_tpu_torch import faults as tfaults
from goworld_tpu_torch import interest as TI
from goworld_tpu_torch import telemetry
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.engine.entity import Entity
from goworld_tpu_torch.engine.runtime import Runtime
from goworld_tpu_torch.engine.space import Space
from goworld_tpu_torch.engine.vector import Vector3
from goworld_tpu_torch.interest import device as TD
from goworld_tpu_torch.interest import oracle as TO
from goworld_tpu_torch.interest.policy import _build_config
from goworld_tpu_torch.ops import aoi_predicate as P
from goworld_tpu_torch.ops import interest_cuda as IC
from goworld_tpu_torch.ops import interest_kernels as K
from goworld_tpu_torch.parallel import SpaceMesh

from test_interest import COMBOS, TIER1_ENGINE, _walk

CAP = 128
ENGINE_CAP = 256
N_TICKS = 9
BOXES = [(20.0, 20.0, 45.0, 60.0), (-60.0, -10.0, -30.0, 10.0)]
# the edge field also blocks the grid's first column: a NaN sample
# coordinate (cell 0) then decides the pair
EDGE_BOXES = BOXES + [(-100.0, -100.0, -97.0, 100.0)]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _field(mod, boxes=BOXES):
    return mod.DistanceField.from_boxes(boxes, (-100.0, -100.0),
                                        (200.0, 200.0), cell=5.0)


def _policies(mod, combo, period=4, depth=2, boxes=BOXES):
    ps = []
    if "team" in combo:
        ps.append(mod.TeamVisibilityPolicy())
    if "tier" in combo:
        ps.append(mod.TieredRatePolicy(period=period))
    if "los" in combo:
        ps.append(mod.LineOfSightPolicy(_field(mod, boxes), depth=depth))
    return ps


def _configs(combo, depth=2, boxes=BOXES):
    jcfg, jf = JI.policy._build_config(_policies(JI, combo, depth=depth,
                                                 boxes=boxes))
    tcfg, tf = _build_config(_policies(TI, combo, depth=depth, boxes=boxes))
    assert jcfg.key() == tcfg.key()
    grid = None if jf is None else jf.grid
    if tf is not None:
        assert np.array_equal(tf.grid, grid)
    return jcfg, tcfg, grid


def _frame(seed, cap):
    """One frame of the reference walk plus random previous planes."""
    x, z, r, act, team, vis = next(iter(_walk(seed, cap, 1)))
    rng = np.random.default_rng(seed + 1)
    w = cap // 32
    prev = rng.integers(0, 2**32, (2, cap, w), dtype=np.uint64) \
        .astype(np.uint32)
    prev[:, :, 0] |= np.uint32(1 << 31)
    act = act.copy()
    act[rng.random(cap) < 0.1] = False  # some inactive slots
    return x, z, r, act, team, vis, prev[0], prev[1]


def _edge(cap, seed, subnormal=False):
    """Columns with the step's edge cases, among them the +inf -> -inf
    pair under an infinite radius (its midpoints are NaN).
    ``subnormal``: subnormal coordinates in place of the non-finite ones
    (the JAX numpy oracle samples every pair, and a NaN midpoint
    anywhere makes it raise)."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.uniform(-110, 110, cap) * 4) / 4).astype(np.float32)
    z = (np.round(rng.uniform(-110, 110, cap) * 4) / 4).astype(np.float32)
    r = rng.choice([0.0, 10.0, 20.0, 40.0], cap).astype(np.float32)
    act = rng.random(cap) < 0.85
    team = (np.uint32(1) << rng.integers(0, 32, cap).astype(np.uint32)) \
        .astype(np.uint32)
    vis = rng.choice(np.array([0xFFFFFFFF, 1, 0x80000000, 0x80000001],
                              np.uint32), cap)
    n = min(cap, 64)
    x[:n:8], x[1:n:8] = 0.0, -0.0
    z[:n:4] = 0.0
    act[:24] = True
    r[7:n:16], r[15:n:16] = np.inf, np.nan
    if subnormal:
        sub = np.float32(1e-40)
        x[2:n:8], x[3:n:8] = sub, -sub
        z[4:n:8] = -sub
        r[8:n:16] = 0.0
    else:
        x[4:n:16], z[5:n:16], x[6:n:16] = np.nan, np.inf, -np.inf
        z[7:n:16], x[12:n:16] = -np.inf, np.inf
    # ties at r*near_frac (20) and at rn*hysteresis (25), just past it,
    # samples outside the world, team bit 31
    x[16], z[16], r[16], vis[16] = 0.0, 0.0, 40.0, 0x80000000
    x[17], z[17] = 20.0, 0.0
    x[18], z[18] = 25.0, 0.0
    x[19], z[19] = np.nextafter(np.float32(25.0), np.float32(30.0)), 0.0
    x[20], z[20], team[21] = 300.0, -400.0, 0x80000000
    if not subnormal:
        x[22], z[22], r[22], vis[22] = np.inf, 0.0, np.inf, 0xFFFFFFFF
        x[23], z[23], team[23] = -np.inf, 0.0, 1
    w = cap // 32
    prev = rng.integers(0, 2**32, (2, cap, w), dtype=np.uint64) \
        .astype(np.uint32)
    prev[:, :, 0] |= np.uint32(1 << 31)
    return x, z, r, act, team, vis, prev[0], prev[1]


def _port_plain(frame, cfg, full, grid):
    x, z, r, act, team, vis, pf, pn = frame
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, z, r, act)]
    tv = [torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))
          for a in (team, vis)]
    planes = [P.words_to_torch(w, "cpu") for w in (pf, pn)]
    g = None if grid is None else torch.from_numpy(grid)
    fin, near = IC.interest_step(*t, *tv, *planes, cfg, full, grid=g)
    return P.words_to_numpy(fin), P.words_to_numpy(near)


def _same(got, want, what):
    for g, w, name in zip(got, want, ("final", "near")):
        assert g.dtype == np.uint32 and np.array_equal(g, w), \
            f"{what}: {name} words differ"


# -- the step: the plain version and the oracle against JAX ------------------

STEP_CASES = (
    [(c, True, 2) for c in COMBOS if "los" not in c]
    + [(c, True, d) for c in COMBOS if "los" in c for d in (1, 2, 3, 4)]
    + [(c, False, 2) for c in COMBOS if "tier" in c])


@pytest.mark.parametrize("combo,full,depth", STEP_CASES,
                         ids=[f"{c}-{'full' if f else 'off'}-d{d}"
                              for c, f, d in STEP_CASES])
def test_step_matches_jax(combo, full, depth):
    jcfg, tcfg, grid = _configs(combo, depth)
    frame = _frame(5 + depth, CAP)
    want = JD.eval_step(*frame, jcfg, full, grid=grid)
    _same(JO.eval_step(*frame, jcfg, full, grid=grid), want, "JAX oracle")
    _same(_port_plain(frame, tcfg, full, grid), want, "plain step")
    _same(TO.eval_step(*frame, tcfg, full, grid=grid), want, "port oracle")


EDGE_CASES = [("los", True), ("team+tier+los", True),
              ("team+tier+los", False), ("team+tier", True)]


@pytest.mark.parametrize("combo,full", EDGE_CASES,
                         ids=[f"{c}-{'full' if f else 'off'}"
                              for c, f in EDGE_CASES])
def test_edge_inputs_match_jax_jit(combo, full):
    """NaN, +-inf, -0.0, ties, outside samples, bit 31, inactive slots:
    the port's plain step and host oracle equal the JAX jitted step,
    which maps a NaN sample to cell 0; the JAX numpy oracle raises on the
    same full LOS step (its INT_MIN cast), the fault of the reference."""
    jcfg, tcfg, grid = _configs(combo, 2, boxes=EDGE_BOXES)
    frame = _edge(256, 3)
    want = JD.eval_step(*frame, jcfg, full, grid=grid)
    _same(_port_plain(frame, tcfg, full, grid), want, "plain step")
    _same(TO.eval_step(*frame, tcfg, full, grid=grid), want, "port oracle")
    if full and combo == "los":
        with pytest.raises(IndexError):
            JO.eval_step(*frame, jcfg, full, grid=grid)


def test_nan_sample_takes_cell_zero():
    """The +inf -> -inf pair under an infinite radius: its midpoint is
    NaN, cell (0, iz).  With the grid's first column blocked the pair is
    occluded; with it open, visible -- on both port backends, as in the
    JAX jitted step."""
    frame = _edge(256, 3)
    w, b = P.word_bit_for_column(23, 256)
    for boxes, visible in ((EDGE_BOXES, False), (BOXES, True)):
        jcfg, tcfg, grid = _configs("los", 1, boxes=boxes)
        want = JD.eval_step(*frame, jcfg, True, grid=grid)
        for got in (_port_plain(frame, tcfg, True, grid),
                    TO.eval_step(*frame, tcfg, True, grid=grid)):
            _same(got, want, f"NaN sample, first column blocked={not visible}")
            assert bool((got[0][22, w] >> np.uint32(b)) & 1) == visible


@pytest.mark.parametrize("combo", ["team+tier+los", "los"])
def test_subnormals_match_jax_oracle(combo):
    """Subnormal coordinates: held to the JAX numpy oracle (IEEE, as the
    port on both devices); XLA's CPU backend flushes them to zero."""
    jcfg, tcfg, grid = _configs(combo, 3)
    frame = _edge(128, 11, subnormal=True)
    for full in (True, False) if "tier" in combo else (True,):
        want = JO.eval_step(*frame, jcfg, full, grid=grid)
        _same(_port_plain(frame, tcfg, full, grid), want, "plain step")
        _same(TO.eval_step(*frame, tcfg, full, grid=grid), want,
              "port oracle")


def test_row_blocks_equal_one_block(monkeypatch):
    """step_words walks row blocks; any block size gives the same words."""
    _, tcfg, grid = _configs("team+tier+los", 2)
    frame = _frame(3, 256)
    whole = _port_plain(frame, tcfg, True, grid)
    monkeypatch.setattr(K, "BLOCK_ELEMS", 256 * 24)  # 24-row blocks
    _same(_port_plain(frame, tcfg, True, grid), whole, "24-row blocks")
    _same(TO.eval_step(*frame, tcfg, True, grid=grid), whole, "numpy blocks")


def test_wrapper_checks():
    _, tcfg, grid = _configs("team+tier+los", 2)
    frame = _frame(3, CAP)
    with pytest.raises(ValueError, match="grid"):
        _port_plain(frame, tcfg, True, None)
    _, nocfg, _ = _configs("team", 2)
    with pytest.raises(ValueError, match="off-cadence"):
        _port_plain(frame, nocfg, False, None)
    bad = list(frame)
    bad[0] = bad[0].astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        _port_plain(bad, tcfg, True, grid)
    # a CPU tensor never reaches the kernel
    IC.reset_launches()
    _port_plain(frame, tcfg, True, grid)
    assert IC.launches == {"interest_step": 0}


# -- PolicyStack --------------------------------------------------------------


def _stacks(combo, period=4):
    return (TI.PolicyStack(CAP, _policies(TI, combo, period), mode="device",
                           device="cpu"),
            TI.PolicyStack(CAP, _policies(TI, combo, period), mode="host"),
            JI.PolicyStack(CAP, _policies(JI, combo, period), mode="host"))


@pytest.mark.parametrize("combo", COMBOS)
def test_stack_device_host_parity(combo):
    dev, host, ref = _stacks(combo)
    total = 0
    for frame in _walk(7, CAP, N_TICKS):
        for s in (dev, host, ref):
            s.submit(*frame)
            s.step()
        re_, rl = ref.take_events()
        for s in (dev, host):
            e, lv = s.take_events()
            assert np.array_equal(e, re_) and np.array_equal(lv, rl), combo
            assert np.array_equal(s.words, ref.words)
            assert np.array_equal(s.near, ref.near)
        total += len(re_) + len(rl)
    assert total > 0
    assert dev.stats == ref.stats
    assert dev.stats["demotions"] == 0 and dev.stats["host_steps"] == 0


def test_period_boundary_bitexact_and_cheaper():
    s4 = TI.PolicyStack(CAP, _policies(TI, "team+tier+los", 4),
                        device="cpu")
    s1 = TI.PolicyStack(CAP, _policies(TI, "team+tier+los", 1),
                        device="cpu")
    for t, frame in enumerate(_walk(11, CAP, N_TICKS)):
        for s in (s4, s1):
            s.submit(*frame)
            s.step()
        if t % 4 == 0:
            assert np.array_equal(s4.words, s1.words), t
            assert np.array_equal(s4.near, s1.near)
    assert s4.stats["full_evals"] == 3
    assert s1.stats["full_evals"] == N_TICKS
    # counted as the reference counts it: C * C * samples per full step
    assert s4.stats["los_pair_evals"] == 3 * CAP * CAP * 3
    assert 0 < s4.stats["los_pair_evals"] < s1.stats["los_pair_evals"]


def test_device_stack_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TI.PolicyStack(CAP, _policies(TI, "tier"))
    # host mode never touches a device
    assert TI.PolicyStack(CAP, _policies(TI, "tier"), mode="host").mode \
        == "host"


# -- the engine seam, every bucket kind ----------------------------------------


def _port_engine(tier, paged, cross_tick):
    if tier in ("mesh", "rowshard"):
        kw = {"rowshard_min_capacity": ENGINE_CAP} if tier == "rowshard" \
            else {}
        eng = AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * 2),
                        paged=paged, cross_tick=cross_tick, **kw)
        h = eng.create_space(ENGINE_CAP)
    else:
        eng = AOIEngine(device="cpu", paged=paged, cross_tick=cross_tick)
        h = eng.create_space(ENGINE_CAP, "cuda" if tier == "tpu" else tier)
    return eng, h


@pytest.mark.parametrize(
    "tier,paged,cross_tick", TIER1_ENGINE,
    ids=[f"{'cuda' if t == 'tpu' else t}{'+paged' if p else ''}"
         f"{'+xtick' if c else ''}" for t, p, c in TIER1_ENGINE])
def test_engine_stack_parity(tier, paged, cross_tick):
    eng, h = _port_engine(tier, paged, cross_tick)
    kind = {"cpu": "_CPUBucket", "tpu": "_CUDABucket",
            "mesh": "_MeshCUDABucket", "rowshard": "_RowShardCUDABucket"}
    assert type(h.bucket).__name__ == kind[tier]
    stack = eng.attach_interest(h, _policies(TI, "team+tier+los"))
    assert AOIEngine.interest_stack(h) is stack
    assert stack.device == torch.device("cpu") and stack.mode == "device"
    ref = JI.PolicyStack(ENGINE_CAP, _policies(JI, "team+tier+los"),
                         mode="host")
    got, want = ([], []), ([], [])
    for x, z, r, act, team, vis in _walk(3, ENGINE_CAP, N_TICKS):
        eng.submit(h, x, z, r, act)
        stack.submit(x, z, r, act, team, vis)
        eng.flush()
        e, lv = eng.take_events(h)
        got[0].append(np.asarray(e)), got[1].append(np.asarray(lv))
        ref.submit(x, z, r, act, team, vis)
        ref.step()
        re_, rl = ref.take_events()
        want[0].append(re_), want[1].append(rl)
        # the stack steps in the flush that submitted it, even where the
        # bucket defers its own delivery by a tick
        assert np.array_equal(got[0][-1], re_)
    while eng.has_pending():  # trailing cross-tick flushes: nothing more
        eng.flush()
        e, lv = eng.take_events(h)
        assert len(e) == 0 and len(lv) == 0
    for side in (0, 1):
        assert np.array_equal(np.concatenate(got[side]),
                              np.concatenate(want[side]))
    assert np.array_equal(stack.words, ref.words)
    assert sum(len(v) for v in want[0]) > 0
    assert stack.stats == ref.stats


def test_host_mode_engine_and_runtime_option():
    eng = AOIEngine(device="cpu", interest_mode="host")
    h = eng.create_space(CAP)
    assert eng.attach_interest(h, _policies(TI, "tier")).mode == "host"
    with pytest.raises(ValueError, match="already has"):
        eng.attach_interest(h, _policies(TI, "tier"))
    with pytest.raises(ValueError, match="interest_mode"):
        AOIEngine(device="cpu", interest_mode="gpu")
    assert Runtime(device="cpu", aoi_interest="host").aoi.interest_mode \
        == "host"


# -- degradation ---------------------------------------------------------------


def _drive(stack, frames, demote_at=None, reset_at=None):
    es, ls = [], []
    for t, frame in enumerate(frames):
        if t == demote_at:
            stack.force_demote()
        if t == reset_at:
            stack.reset_interest()
        stack.submit(*frame)
        stack.step()
        e, lv = stack.take_events()
        es.append(e), ls.append(lv)
    return np.concatenate(es), np.concatenate(ls)


@pytest.mark.parametrize("kind", ["poison", "fail", "reset"])
def test_interest_seam_demotes_and_rearms(kind):
    """Any fired kind on the port's ``aoi.interest`` seam demotes the
    stack sticky to the radius-only path; ``reset_interest`` re-arms.
    The stream equals the JAX host twin demoted and re-armed by hand at
    the same steps."""
    frames = list(_walk(13, CAP, N_TICKS))
    tfaults.install(f"aoi.interest:{kind}@3")
    dev = TI.PolicyStack(CAP, _policies(TI, "team+tier+los"), device="cpu")
    e, lv = _drive(dev, frames, reset_at=6)
    assert [(f["seam"], f["kind"], f["occurrence"])
            for f in tfaults.plan().fired] == [("aoi.interest", kind, 3)]
    tfaults.clear()
    twin = JI.PolicyStack(CAP, _policies(JI, "team+tier+los"), mode="host")
    te, tl = _drive(twin, frames, demote_at=2, reset_at=6)
    assert np.array_equal(e, te) and np.array_equal(lv, tl)
    assert dev.stats == twin.stats
    assert dev.stats["demotions"] == 1 and dev.stats["demoted_steps"] == 4
    assert not dev.demoted
    assert np.array_equal(dev.words, twin.words)
    assert np.array_equal(dev.near, twin.near)


def test_corrupt_distance_field_demotes():
    los = TI.LineOfSightPolicy(_field(TI), depth=2)
    stack = TI.PolicyStack(CAP, [TI.TieredRatePolicy(), los], device="cpu")
    frames = list(_walk(17, CAP, 4))
    stack.submit(*frames[0])
    stack.step()
    assert stack.stats["demotions"] == 0
    los.field.grid[3, 3] = np.nan
    for fr in frames[1:]:
        stack.submit(*fr)
        stack.step()
    assert stack.demoted and stack.stats["demotions"] == 1
    assert stack.stats["demoted_steps"] == 3
    assert not stack.near_rows().any()


def test_device_fault_single_step_fallback(monkeypatch):
    """An injected DeviceOOM inside the device step: that one step runs on
    the host oracle (``host_steps``), the device path resumes; a real
    error (anything the port's _device_fault refuses) propagates."""
    frames = list(_walk(19, CAP, 6))
    real = TD.eval_step
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise tfaults.DeviceOOM("aoi.interest", 1)
        return real(*a, **kw)

    monkeypatch.setattr(TD, "eval_step", flaky)
    dev = TI.PolicyStack(CAP, _policies(TI, "team+tier+los"), device="cpu")
    e, lv = _drive(dev, frames)
    host = JI.PolicyStack(CAP, _policies(JI, "team+tier+los"), mode="host")
    he, hl = _drive(host, frames)
    assert np.array_equal(e, he) and np.array_equal(lv, hl)
    assert dev.stats["host_steps"] == 1 and dev.stats["demotions"] == 0

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(TD, "eval_step", broken)
    dev.submit(*frames[0])
    with pytest.raises(RuntimeError, match="illegal memory"):
        dev.step()


# -- lifecycle -----------------------------------------------------------------


def test_grow_space_carries_stack():
    eng = AOIEngine(device="cpu")
    h = eng.create_space(CAP)
    stack = eng.attach_interest(h, _policies(TI, "team+tier"))
    ref = JI.PolicyStack(CAP, _policies(JI, "team+tier"), mode="host")
    frames = list(_walk(9, CAP, 3))
    for x, z, r, act, team, vis in frames:
        eng.submit(h, x, z, r, act)
        stack.submit(x, z, r, act, team, vis)
        ref.submit(x, z, r, act, team, vis)
        eng.flush()
        ref.step()
        eng.take_events(h)
    nh = eng.grow_space(h, CAP * 2)
    ref.grow(CAP * 2)
    assert AOIEngine.interest_stack(nh) is stack
    assert AOIEngine.interest_stack(h) is None
    assert eng._stacked == [nh]
    assert np.array_equal(stack.final, ref.final)
    assert np.array_equal(stack.near, ref.near)
    x, z, r, act, team, vis = frames[-1]

    def pad(a, fill=0):
        return np.concatenate([a, np.full(CAP, fill, a.dtype)])

    eng.submit(nh, pad(x), pad(z), pad(r), pad(act, False))
    stack.submit(pad(x), pad(z), pad(r), pad(act, False), pad(team),
                 pad(vis))
    eng.flush()
    e, lv = eng.take_events(nh)
    assert len(e) == 0 and len(lv) == 0  # growth itself emits nothing
    eng.release_space(nh)
    assert eng._stacked == []


def test_clear_entity_clears_both_planes():
    eng = AOIEngine(device="cpu")
    h = eng.create_space(CAP)
    stack = eng.attach_interest(h, _policies(TI, "tier"))
    ref = JI.PolicyStack(CAP, _policies(JI, "tier"), mode="host")
    for frame in _walk(21, CAP, 2):
        eng.submit(h, *frame[:4])
        stack.submit(*frame)
        ref.submit(*frame)
        eng.flush()
        ref.step()
    slot = int(np.nonzero(stack.final.any(1) & stack.near.any(1))[0][0])
    eng.clear_entity(h, slot)
    ref.clear_entity(slot)
    assert not stack.final[slot].any() and not stack.near[slot].any()
    w, b = P.word_bit_for_column(slot, CAP)
    assert not (stack.final[:, w] >> np.uint32(b) & 1).any()
    assert np.array_equal(stack.final, ref.final)
    assert np.array_equal(stack.near, ref.near)


def test_payload_roundtrip_with_field():
    a = TI.PolicyStack(CAP, _policies(TI, "team+tier+los"), device="cpu")
    for frame in _walk(23, CAP, 5):
        a.submit(*frame)
        a.step()
    pay = a.export_payload()
    a.take_events()  # the undelivered diff stays with a
    ref = JI.PolicyStack(CAP, _policies(JI, "team+tier+los"), mode="host")
    for frame in _walk(23, CAP, 5):
        ref.submit(*frame)
        ref.step()
    jpay = ref.export_payload()
    assert pay.keys() == jpay.keys()
    for k in pay:
        assert pay[k] == jpay[k], k
    boxes = [(0.0, 0.0, 10.0, 10.0)]
    b = TI.PolicyStack(CAP, _policies(TI, "team+tier+los", boxes=boxes),
                       device="cpu")
    b.import_payload(pay)
    assert b.step_count == a.step_count and b._cfg.key() == a._cfg.key()
    assert np.array_equal(b._field.grid, a._field.grid)
    assert np.array_equal(b.words, a.words) and np.array_equal(b.near, a.near)
    frames = list(_walk(29, CAP, 3))
    for fr in frames:
        for s in (a, b):
            s.submit(*fr)
            s.step()
        ea, la = a.take_events()
        eb, lb = b.take_events()
        assert np.array_equal(ea, eb) and np.array_equal(la, lb)
    with pytest.raises(ValueError, match="capacity"):
        TI.PolicyStack(2 * CAP, _policies(TI, "tier"),
                       device="cpu").import_payload(pay)


def test_distance_field_matches_jax():
    f, jf = _field(TI), _field(JI)
    assert np.array_equal(f.grid, jf.grid) and f.key() == jf.key()
    assert f.validate()
    st = f.export_state()
    assert st == jf.export_state()
    f2 = TI.DistanceField.import_state(
        {"origin": list(st["origin"]), "cell": st["cell"],
         "shape": list(st["shape"]), "grid": st["grid"]})
    assert np.array_equal(f2.grid, f.grid) and f2.key() == f.key()
    g = f.grid.copy()
    g[0, 0] = np.inf
    assert not TI.DistanceField(0.0, 0.0, 5.0, g).validate()


def test_policy_validation_errors():
    with pytest.raises(ValueError):
        TI.TieredRatePolicy(near_frac=0.0)
    with pytest.raises(ValueError):
        TI.TieredRatePolicy(hysteresis=0.5)
    with pytest.raises(ValueError):
        TI.TieredRatePolicy(period=0)
    with pytest.raises(TypeError):
        TI.LineOfSightPolicy("not a field")
    with pytest.raises(ValueError):
        TI.LineOfSightPolicy(_field(TI), depth=5)
    with pytest.raises(ValueError):
        TI.DistanceField(0.0, 0.0, -1.0, np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        TI.PolicyStack(CAP, [], device="cpu")
    with pytest.raises(ValueError):
        TI.PolicyStack(CAP, [TI.TieredRatePolicy(), TI.TieredRatePolicy()],
                       device="cpu")
    with pytest.raises(ValueError):
        TI.PolicyStack(CAP, [TI.TieredRatePolicy()], mode="gpu")

    class Rogue(TI.InterestPolicy):
        name = "rogue-unregistered"

    with pytest.raises(ValueError):
        TI.PolicyStack(CAP, [Rogue()], device="cpu")

    class Nameless(TI.InterestPolicy):
        pass

    with pytest.raises(ValueError):
        TI.register(Nameless)

    class Dup(TI.InterestPolicy):
        name = "team_mask"

    with pytest.raises(ValueError):
        TI.register(Dup)
    # a JAX package's policy is not one of the port's
    with pytest.raises(ValueError):
        TI.PolicyStack(CAP, [JI.TieredRatePolicy()], device="cpu")


def test_interest_counters_registered():
    from goworld_tpu_torch.interest import policy as pol

    reg = telemetry.registry()
    assert pol._STEPS is reg.counter("interest.steps")
    assert pol._FULL_EVALS is reg.counter("interest.full_evals")
    assert pol._DEMOTIONS is reg.counter("interest.demotions")
    assert pol._HOST_STEPS is reg.counter("interest.host_steps")
    assert pol._LOS_EVALS is reg.counter("interest.los_pair_evals")
    telemetry.enable()
    try:
        before = telemetry.snapshot()["interest.steps"]
        s = TI.PolicyStack(CAP, _policies(TI, "tier"), device="cpu")
        s.submit(*next(iter(_walk(3, CAP, 1))))
        s.step()
        assert telemetry.snapshot()["interest.steps"] == before + 1
        assert [n for n, *_ in telemetry.trace.spans()] == []
        eng = AOIEngine(device="cpu")
        h = eng.create_space(CAP)
        st = eng.attach_interest(h, _policies(TI, "tier"))
        frame = next(iter(_walk(3, CAP, 1)))
        eng.submit(h, *frame[:4])
        st.submit(*frame)
        eng.flush()
        assert "aoi.interest" in [n for n, *_ in telemetry.trace.spans()]
    finally:
        telemetry.disable()


# -- the runtime: team columns, tiers ---------------------------------------------


class _Watcher(Entity):
    use_aoi = True


class _Hooked(_Watcher):
    def on_enter_aoi(self, other):
        pass


class _Arena(Space):
    pass


def _rt():
    rt = Runtime(device="cpu")
    for cls in (_Watcher, _Hooked, _Arena):
        rt.entities.register(cls)
    return rt


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_team_mask_runtime_roundtrip(backend):
    rt = _rt()
    sp = rt.entities.create_space("_Arena", kind=1)
    sp.enable_aoi(20.0, backend=backend)
    sp.enable_interest(TI.TeamVisibilityPolicy())
    a = rt.entities.create("_Watcher", space=sp, pos=Vector3(0, 0, 0))
    b = rt.entities.create("_Hooked", space=sp, pos=Vector3(5, 0, 5))
    rt.tick()
    assert b in a.neighbors() and a in b.interested_in
    sp.set_aoi_team(a, team=0b10)
    sp.set_aoi_team(b, team=0b01, vis=0b01)
    rt.tick()
    assert b in a.neighbors()
    assert a not in b.interested_in
    sp.set_aoi_team(a, team=0b01)
    rt.tick()
    assert a in b.interested_in


def test_tiered_runtime_near_rows():
    rt = _rt()
    sp = rt.entities.create_space("_Arena", kind=1)
    sp.enable_aoi(40.0)
    sp.enable_interest(TI.TieredRatePolicy(period=4))
    a = rt.entities.create("_Watcher", space=sp, pos=Vector3(0, 0, 0))
    b = rt.entities.create("_Watcher", space=sp, pos=Vector3(5, 0, 0))
    far = rt.entities.create("_Watcher", space=sp, pos=Vector3(35, 0, 0))
    rt.tick()
    near = sp.interest_stack.near_rows()
    assert near[a.aoi_slot] and near[b.aoi_slot]
    assert not near[far.aoi_slot]
    assert far in a.neighbors()
    # a departing entity leaves both planes
    far.destroy()
    rt.tick()
    assert far not in a.neighbors()
