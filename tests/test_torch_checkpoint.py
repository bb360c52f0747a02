"""The port's checkpoints (``goworld_tpu_torch/engine/checkpoint.py``, the
``kvdb`` and ``storage`` filesystem backends) against the JAX package.

The same seeded numpy walks go through the port (``device="cpu"``: the
plain PyTorch step under the device buckets; the mesh and row-sharded
buckets on 2 virtual CPU shards) and through the JAX package's ``cpu``
bucket.  Tolerance: exact.  A restored space's stream equals the JAX
``cpu`` stream of the walk that never stopped; the journal is the JAX
package's byte for byte, so each package restores the other's to the
same snapshot; one plan string installed in both fault modules fires the
same ``store.*`` faults and leaves the same restorable state.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import zlib

import numpy as np
import pytest

from goworld_tpu import faults as jfaults
from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.engine.checkpoint import \
    CheckpointController as JaxController
from goworld_tpu.engine.checkpoint import _open_backends as jax_backends
from goworld_tpu_torch import faults, telemetry
from goworld_tpu_torch.engine import checkpoint as ck
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.engine.checkpoint import (MANIFEST_PREFIX, RECORD_TYPE,
                                                 CheckpointController,
                                                 _open_backends,
                                                 crash_restart_scenario)
from goworld_tpu_torch.interest import TieredRatePolicy
from goworld_tpu_torch.parallel import SpaceMesh
from goworld_tpu_torch.telemetry import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 256
PRE = 6     # checkpointed ticks before the restore
POST = 12   # ticks after it


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _frames(cap, ticks, seed=7, world=100.0, step=3.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, world, cap).astype(np.float32)
    z = rng.uniform(0.0, world, cap).astype(np.float32)
    out = []
    for _ in range(ticks):
        x = x + rng.uniform(-step, step, cap).astype(np.float32)
        z = z + rng.uniform(-step, step, cap).astype(np.float32)
        out.append((x.copy(), z.copy()))
    return out


def _consts(cap):
    return np.full(cap, 12.0, np.float32), np.ones(cap, bool)


def _tick(eng, handles, frame, r, act):
    x, z = frame
    for h in handles:
        eng.submit(h, x, z, r, act)
    eng.flush()
    return [tuple(np.asarray(a) for a in eng.take_events(h))
            for h in handles]


def _drive(ctl, eng, h, frames, start=0):
    r, act = _consts(len(frames[0][0]))
    for t, frame in enumerate(frames, start + 1):
        _tick(eng, [h], frame, r, act)
        ctl.step(t)


def _jax_stream(frames, cap=CAP):
    """Per-tick events of the JAX ``cpu`` bucket over ``frames``."""
    eng = JaxEngine(default_backend="cpu")
    h = eng.create_space(cap, "cpu")
    r, act = _consts(cap)
    return [_tick(eng, [h], f, r, act)[0] for f in frames]


# -- restore parity ----------------------------------------------------------

COMBOS = [("cuda", False, False), ("cuda", True, False),
          ("cuda", False, True), ("cpp", False, False),
          ("mesh", True, True), ("rowshard", False, True)]


@pytest.mark.parametrize(
    "tier,paged,cross_tick", COMBOS,
    ids=[f"{t}{'+paged' if p else ''}{'+xtick' if c else ''}"
         for t, p, c in COMBOS])
def test_restore_parity(tmp_path, tier, paged, cross_tick):
    """Checkpoint a space for PRE ticks, restore it into a fresh engine
    (the killed process's successor), and drive POST more frames: the
    restored stream equals the JAX ``cpu`` stream of those ticks."""
    frames = _frames(CAP, PRE + POST)
    r, act = _consts(CAP)
    mesh = SpaceMesh(["cpu"] * 2) if tier in ("mesh", "rowshard") else None
    eng = AOIEngine(device="cpu", mesh=mesh, paged=paged,
                    cross_tick=cross_tick)
    store, kv = _open_backends(str(tmp_path / "ck"))
    ctl = CheckpointController(eng, store, kv, mode="continuous")
    h = eng._create_handle(CAP, tier)
    ctl.track("s", h)
    for t in range(PRE):
        _tick(eng, [h], frames[t], r, act)
        ctl.step(t + 1)
    assert ctl.drain(), "writer did not drain"
    ctl.close()
    eng2 = AOIEngine(device="cpu", mesh=mesh, paged=paged,
                     cross_tick=cross_tick)
    rest = CheckpointController(eng2, *_open_backends(str(tmp_path / "ck")),
                                mode="off")
    h2, tick, epoch = rest.restore_into(eng2, "s", tier=tier)
    assert (tick, epoch) == (PRE, PRE - 1)
    got = [_tick(eng2, [h2], f, r, act)[0] for f in frames[PRE:]]
    while eng2.has_pending():
        eng2.flush()
        got.append(tuple(np.asarray(a) for a in eng2.take_events(h2)))
    want = _jax_stream(frames)[PRE:]
    for side in (0, 1):
        a = np.concatenate([g[side] for g in got])
        b = np.concatenate([w[side] for w in want])
        assert len(b) and np.array_equal(a, b), side
    if not cross_tick:
        for g, w in zip(got, want):
            assert all(np.array_equal(p, q) for p, q in zip(g, w))
    rest.close()


def test_restore_carries_the_interest_stack(tmp_path):
    """A stacked space's policy state rides every record; a space
    restored through restore_into gets it back at attach_interest, and
    its stack steps on as the uninterrupted one does."""
    frames = _frames(CAP, PRE + 6)
    r, act = _consts(CAP)
    team = np.ones(CAP, np.uint32)
    vis = np.full(CAP, 0xFFFFFFFF, np.uint32)

    def stacked(eng, h):
        return eng.attach_interest(h, [TieredRatePolicy(period=4)])

    def step(eng, h, stack, f):
        eng.submit(h, *f, r, act)
        stack.submit(*f, r, act, team, vis)
        eng.flush()
        return eng.take_events(h)

    eng = AOIEngine(device="cpu")
    store, kv = _open_backends(str(tmp_path))
    ctl = CheckpointController(eng, store, kv, mode="continuous")
    h = eng.create_space(CAP)
    stack = stacked(eng, h)
    ctl.track("s", h)
    for t in range(PRE):
        step(eng, h, stack, frames[t])
        ctl.step(t + 1)
    assert ctl.drain()
    eng2 = AOIEngine(device="cpu")
    h2, _tick_, _ep = ctl.restore_into(eng2, "s", tier="cuda")
    assert h2._interest_snapshot is not None
    stack2 = stacked(eng2, h2)
    assert h2._interest_snapshot is None
    assert stack2.step_count == stack.step_count == PRE
    for f in frames[PRE:]:
        a, b = step(eng, h, stack, f), step(eng2, h2, stack2, f)
        assert all(np.array_equal(p, q) for p, q in zip(a, b))
    assert np.array_equal(stack.final, stack2.final)
    ctl.close()


# -- the journal -------------------------------------------------------------

def _mk(tmp_path, eng, **kw):
    store, kv = _open_backends(str(tmp_path / "ck"))
    return CheckpointController(eng, store, kv, mode="continuous",
                                **kw), store, kv


def test_manifest_monotonic_and_crc_consistent(tmp_path):
    eng = AOIEngine(device="cpu")
    ctl, store, kv = _mk(tmp_path, eng)
    h = eng._create_handle(64, "cuda")
    ctl.track("s", h)
    _drive(ctl, eng, h, _frames(64, 10))
    assert ctl.drain()
    rows = kv.find(f"{MANIFEST_PREFIX}s/", f"{MANIFEST_PREFIX}s/~")
    assert len(rows) == ctl.stats["records_written"] >= 2
    entries = [json.loads(v) for _k, v in rows]
    epochs = [e["epoch"] for e in entries]
    ticks = [e["tick"] for e in entries]
    assert epochs == sorted(set(epochs)) and ticks == sorted(ticks)
    assert entries[0]["kind"] == "base"
    for ent in entries:
        rec = store.read(RECORD_TYPE, f"s.{ent['epoch']:08d}")
        assert zlib.crc32(rec["blob"]) & 0xFFFFFFFF == ent["crc"] \
            == rec["crc"]
    ctl.close()


def test_records_are_deltas_and_full_every_bounds_the_chain(tmp_path):
    """After the base a mostly idle space journals deltas smaller than
    the base, an idle tick journals nothing, and ``full_every`` re-bases
    the chain."""
    eng = AOIEngine(device="cpu")
    ctl, store, kv = _mk(tmp_path, eng)
    h = eng._create_handle(128, "cuda")
    ctl.track("s", h)
    frames = _frames(128, 4)
    _drive(ctl, eng, h, frames)
    r, act = _consts(128)
    _tick(eng, [h], frames[-1], r, act)  # nothing changes
    ctl.step(5)
    assert ctl.drain()
    assert (ctl.stats["bases"], ctl.stats["deltas"],
            ctl.stats["skipped_empty"]) == (1, 3, 1)
    base = store.read(RECORD_TYPE, "s.00000000")
    delta = store.read(RECORD_TYPE, "s.00000001")
    assert len(delta["blob"]) < len(base["blob"])
    ctl.close()
    eng = AOIEngine(device="cpu")
    ctl, store, kv = _mk(tmp_path / "b", eng, full_every=3)
    h = eng._create_handle(64, "cuda")
    ctl.track("s", h)
    _drive(ctl, eng, h, _frames(64, 9))
    assert ctl.drain() and ctl.stats["bases"] >= 2
    ctl.close()


def test_grow_space_forces_fresh_base(tmp_path):
    eng = AOIEngine(device="cpu")
    ctl, store, kv = _mk(tmp_path, eng)
    h = eng._create_handle(64, "cuda")
    ctl.track("s", h)
    _drive(ctl, eng, h, _frames(64, 2))
    h2 = eng.grow_space(h, 2 * h.capacity)
    ctl.track("s", h2)
    big = h2.capacity
    r, act = _consts(big)
    _tick(eng, [h2], _frames(big, 1, seed=9)[0], r, act)
    ctl.step(3)
    assert ctl.drain() and ctl.stats["bases"] == 2
    snap, _t, epoch = CheckpointController(eng, store, kv,
                                           mode="off").restore("s")
    assert snap["capacity"] == big and epoch == 2
    ctl.close()


# -- the store.* seams, in both packages -------------------------------------

# (plan, ticks, controller options, drain every tick) -- the scenarios of
# the JAX package's tests/test_checkpoint.py
STORE_PLANS = [
    ("store.write:fail@1x2", 3, {"retry_base_s": 0.0}, False),
    ("store.write:fail@2x2", 3, {"retry_base_s": 0.0, "max_retries": 2},
     True),
    ("store.write:partial@3:0.5", 4, {}, False),
    ("store.write:poison@2", 3, {}, False),
    ("store.manifest:partial@4:0.3", 4, {}, False),
    ("store.write:stall@1:0.01", 2, {}, False),
]
# a wedged writer and a one-deep queue: which captures drop depends on the
# writer thread's timing, in either package
BACKLOG_PLAN = "store.write:stall@1x4:0.05"

READ_PLANS = ["store.read:fail@1x2", "store.read:poison@1"]
STAT_KEYS = ("captures", "bases", "deltas", "skipped_empty", "write_retries",
             "manifest_retries", "dropped_epochs", "records_written")


def _both(tmp_path, plan, ticks, kw, drain_each, wedge=False):
    """The JAX controller over the JAX ``cpu`` bucket and the port's over
    its ``cuda`` bucket on the CPU, the same plan in both fault modules;
    their stats, fired faults and restores.  ``wedge``: the journal's
    writes wait until the ticks are done (a writer that cannot keep up,
    whatever the machine's speed)."""
    out = {}
    for name, Eng, Ctl, backends, fmod, tier, ekw in (
            ("jax", JaxEngine, JaxController, jax_backends, jfaults, "cpu",
             {"default_backend": "cpu"}),
            ("port", AOIEngine, CheckpointController, _open_backends, faults,
             "cuda", {"device": "cpu"})):
        eng = Eng(**ekw)
        store, kv = backends(str(tmp_path / name))
        gate = threading.Event()
        if wedge:
            write = store.write

            def wedged(*a, _w=write, _g=gate):
                assert _g.wait(timeout=60)
                return _w(*a)

            store.write = wedged
        else:
            gate.set()
        ctl = Ctl(eng, store, kv, mode="continuous", **kw)
        h = eng._create_handle(64, tier)
        ctl.track("s", h)
        if plan:
            fmod.install(plan)
        r, act = _consts(64)
        for t, frame in enumerate(_frames(64, ticks), 1):
            _tick(eng, [h], frame, r, act)
            ctl.step(t)
            if drain_each:
                assert ctl.drain()
        gate.set()
        assert ctl.drain(timeout=10.0)
        fired = [dict(f) for f in fmod.plan().fired] if plan else []
        fmod.clear()
        if plan == BACKLOG_PLAN:
            # the capture after the drops re-bases the chain
            _tick(eng, [h], _frames(64, 1, seed=3)[0], r, act)
            ctl.step(ticks + 1)
            assert ctl.drain()
        ctl.close()
        rest = Ctl(eng, store, kv, mode="off")
        out[name] = ({k: ctl.stats[k] for k in STAT_KEYS}, fired,
                     rest.restore("s"), rest.stats["torn_records"],
                     store, kv, eng)
    return out


def _same_restore(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    (sa, ta, ea), (sb, tb, eb) = a, b
    assert (ta, ea) == (tb, eb)
    assert sorted(sa) == sorted(sb) and sa["sub"] == sb["sub"]
    for k in ("r", "act", "words"):
        assert np.array_equal(sa[k], sb[k]), k
    for p, q in zip(sa["packet"], sb["packet"]):
        assert np.array_equal(p, q)


@pytest.mark.parametrize("plan,ticks,kw,drain_each", STORE_PLANS,
                         ids=[p[0] for p in STORE_PLANS])
def test_store_seams_match_jax(tmp_path, plan, ticks, kw, drain_each):
    out = _both(tmp_path, plan, ticks, kw, drain_each)
    (js, jf, jr, jt, *_), (ps, pf, pr, pt, *_) = out["jax"], out["port"]
    assert pf == jf and pf, "the plan fired nothing"
    assert ps == js and pt == jt
    _same_restore(pr, jr)
    assert pr is not None


def test_backlog_full_drops_and_rebases_in_both(tmp_path):
    """A wedged writer behind a one-deep queue: the captures it cannot
    take drop (counted) instead of blocking the tick, and the capture
    after them re-bases the chain.  Three records land in both packages
    (the one being written, the one queued, then, the plan cleared, the
    re-base), so the same stalls fire and the restore gives the same
    state at the same tick and epoch; which captures dropped follows the
    writer thread's timing."""
    out = _both(tmp_path, BACKLOG_PLAN, 6,
                {"queue_max": 1, "retry_base_s": 0.0}, False, wedge=True)
    (js, jf, jr, *_), (ps, pf, pr, *_) = out["jax"], out["port"]
    assert pf == jf and [f["occurrence"] for f in pf] == [1, 2]
    for stats in (js, ps):
        assert stats["records_written"] == 3, stats
        assert stats["captures"] - stats["skipped_empty"] == 7
        assert stats["bases"] >= 2
    assert jr[1:] == pr[1:] == (7, 2)
    _same_restore(pr, jr)


@pytest.mark.parametrize("plan", READ_PLANS)
def test_store_read_seams_match_jax(tmp_path, plan):
    """Read-side faults at restore: a failed read retries (counted), a
    poisoned one falls back to the epoch below, the same in both."""
    out = _both(tmp_path, "", 4, {"retry_base_s": 0.0}, False)
    res = {}
    for name, Ctl, fmod in (("jax", JaxController, jfaults),
                            ("port", CheckpointController, faults)):
        store, kv, eng = out[name][4:]
        rest = Ctl(eng, store, kv, mode="off", retry_base_s=0.0)
        fmod.install(plan)
        got = rest.restore("s")
        res[name] = (got, rest.stats["read_retries"],
                     rest.stats["torn_records"],
                     [dict(f) for f in fmod.plan().fired])
        fmod.clear()
    assert res["port"][1:] == res["jax"][1:]
    _same_restore(res["port"][0], res["jax"][0])
    assert res["port"][0][2] == (3 if "fail" in plan else 2)


# -- journals cross between the packages -------------------------------------

def test_journals_cross_between_packages(tmp_path):
    """A journal the JAX controller wrote restores in the port to the
    snapshot JAX restores from it, and the port's journal restores in the
    JAX package to the port's own restore."""
    frames = _frames(CAP, 5)
    for writer in ("jax", "port"):
        d = str(tmp_path / writer)
        if writer == "jax":
            eng = JaxEngine(default_backend="cpu")
            ctl = JaxController(eng, *jax_backends(d), mode="continuous")
            h = eng._create_handle(CAP, "cpu")
        else:
            eng = AOIEngine(device="cpu")
            ctl = CheckpointController(eng, *_open_backends(d),
                                       mode="continuous")
            h = eng._create_handle(CAP, "cuda")
        ctl.track("s", h)
        _drive(ctl, eng, h, frames)
        assert ctl.drain()
        ctl.close()
        jr = JaxController(JaxEngine(default_backend="cpu"),
                           *jax_backends(d), mode="off").restore("s")
        pr = CheckpointController(AOIEngine(device="cpu"),
                                  *_open_backends(d), mode="off").restore("s")
        assert pr[1:] == (5, 4)
        _same_restore(pr, jr)
        assert pr[0]["words"].any()


# -- the crash-restart driver ------------------------------------------------

def test_kill9_crash_restart_recovery(tmp_path):
    """A real SIGKILL mid-run of ``python -m
    goworld_tpu_torch.engine.checkpoint --device cpu``: restore and
    replay merged with the killed run's journal equal the uninterrupted
    run tick for tick, events_lost == 0."""
    out = crash_restart_scenario(str(tmp_path), cap=96, world=120.0,
                                 ticks=18, kill_at=12, tier="cuda",
                                 mode="continuous", interval=2,
                                 device="cpu", timeout=180)
    assert out["crash_rc"] == -signal.SIGKILL
    assert out["oracle_rc"] == 0 and out["resume_rc"] == 0
    assert 0 <= out["restored_tick"] <= out["kill_tick"]
    assert out["replay_parity_ok"] and out["parity_ok"]
    assert out["events_lost"] == 0 and out["oracle_events"] > 0


def test_driver_fault_plan_via_env(tmp_path):
    """GW_FAULT_PLAN reaches the driver's fault module: the store.write
    faults fire and heal, and the journal restores."""
    env = dict(os.environ, PYTHONPATH=ROOT,
               GW_FAULT_PLAN="store.write:fail@2x2;store.manifest:fail@3")
    r = subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.engine.checkpoint",
         "--dir", str(tmp_path / "ck"), "--journal",
         str(tmp_path / "j.journal"), "--ticks", "6", "--cap", "64",
         "--world", "80", "--tier", "cpp", "--device", "cpu", "--seed", "5"],
        env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    res = CheckpointController(AOIEngine(device="cpu"),
                               *_open_backends(str(tmp_path / "ck")),
                               mode="off").restore("bench")
    assert res is not None and res[1] == 6


# -- telemetry and the runtime -----------------------------------------------

def test_ckpt_telemetry_catalog(tmp_path):
    """Every ckpt.* span fires on a checkpoint and restore, and the
    counters move."""
    telemetry.enable()
    trace.reset()
    try:
        eng = AOIEngine(device="cpu")
        ctl, store, kv = _mk(tmp_path, eng)
        h = eng._create_handle(64, "cuda")
        ctl.track("s", h)
        _drive(ctl, eng, h, _frames(64, 3))
        assert ctl.drain()
        assert CheckpointController(eng, store, kv,
                                    mode="off").restore("s") is not None
        names = {s[0] for s in trace.spans()}
        for span in ("ckpt.snapshot", "ckpt.delta", "ckpt.flush",
                     "ckpt.restore"):
            assert span in names, span
        assert ck._BYTES.value > 0 and ck._RECORDS.value >= 3 \
            and ck._EPOCHS.value >= 3
        ctl.close()
    finally:
        telemetry.disable()


def test_runtime_checkpoint_wiring(tmp_path):
    """Runtime(aoi_checkpoint=...) arms the controller, tracks the live
    AOI spaces every tick and the journal restores; without backends it
    refuses; aoi_placement selects the controller's mode."""
    from goworld_tpu_torch.engine.entity import Entity
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.engine.space import Space
    from goworld_tpu_torch.engine.vector import Vector3

    class CkptScene(Space):
        pass

    class CkptWalker(Entity):
        use_aoi = True
        aoi_distance = 30.0

    with pytest.raises(ValueError, match="aoi_checkpoint"):
        Runtime(device="cpu", aoi_checkpoint="interval")
    with pytest.raises(ValueError, match="aoi_placement"):
        Runtime(device="cpu", aoi_placement="adaptive")
    rt = Runtime(device="cpu", aoi_checkpoint="interval",
                 aoi_checkpoint_interval=2, aoi_checkpoint_dir=str(tmp_path),
                 aoi_placement="auto", aoi_migration_threshold_ms=1e9,
                 aoi_migration_cooldown=3)
    assert rt.placement.mode == "auto" and rt.placement.cooldown_ticks == 3
    rt.entities.register(CkptScene)
    rt.entities.register(CkptWalker)
    sp = rt.entities.create_space("CkptScene", kind=1)
    sp.enable_aoi(30.0)
    rng = np.random.default_rng(3)
    es = [rt.entities.create(
        "CkptWalker", space=sp,
        pos=Vector3(rng.uniform(0, 40), 0.0, rng.uniform(0, 40)))
        for _ in range(8)]
    for _t in range(6):
        for e in es:
            e.set_position(Vector3(e.position.x + 1.0, 0, e.position.z))
        rt.tick()
    assert rt.placement._tick == 6
    assert rt.checkpoint.drain()
    assert rt.checkpoint.stats["records_written"] >= 1
    snap, tick, _epoch = rt.checkpoint.restore(sp.id)
    assert tick in (2, 4, 6) and snap["act"].sum() == 8
    old = rt.checkpoint
    assert rt.arm_checkpoints(*_open_backends(str(tmp_path / "b")),
                              mode="continuous") is rt.checkpoint
    assert old._writer is None
    rt.checkpoint.close()
