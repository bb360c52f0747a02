"""The port's one-tick deferral (``pipeline`` / ``cross_tick``) on
device="cpu": the plain PyTorch step under the single-device, mesh and
row-sharded buckets.  Tolerance: exact equality of every tick's enter and
leave arrays.

A deferred engine delivers tick T at flush T+1 (tick 0 delivers nothing;
``drain()`` delivers the last), so it must equal the JAX package's CPU
oracle (``AOIEngine(default_backend="cpu")``) and the port's sequential
engine shifted by exactly one tick, whichever flag or both, with the
split-phase scheduler on or off.  The pipelined JAX bucket is not the
reference here: its own pipelined tests are flaky under a parallel run.
The cases around the deferral: growth carrying the tick in flight, a
release in flight, a mid-tick harvest, an all-unsubscribed bucket, a
clear in flight under the host mirror, the mesh's scratch ring under a
forced overflow, the row-sharded bucket's zero shift and the Runtime."""

import zlib

import numpy as np
import pytest

from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.engine.aoi_rowshard import _RowShardCUDABucket
from goworld_tpu_torch.ops import aoi_predicate as P
from goworld_tpu_torch.parallel import SpaceMesh
from test_aoi_delta import _pad, _scene, _sparse_step
from torch_threads import one_intra_op_thread  # noqa: F401

CAPS = (256, 512)  # two capacities: two buckets for the scheduler
DEFERRED = {"pipe": {"pipeline": True}, "xt": {"cross_tick": True},
            "both": {"pipeline": True, "cross_tick": True}}


def drive(engines, ticks, before=None, seed=7, n=180):
    """One sparse walk per capacity into every engine; out[key][tick] =
    [(enter, leave) per space].  Deferred engines' trailing tick comes
    out of ``drain()``.  ``before(t, engines, handles)`` runs before each
    tick's flush."""
    handles = {k: [e.create_space(c) for c in CAPS]
               for k, e in engines.items()}
    scenes = [list(_scene(seed + i, cap, n)) for i, cap in enumerate(CAPS)]
    out = {k: [] for k in engines}
    for t in range(ticks):
        for rng, xs, zs, _rr, _act in scenes:
            _sparse_step(rng, xs, zs)
        for k, e in engines.items():
            for (_rng, xs, zs, rr, act), h, cap in zip(scenes, handles[k],
                                                        CAPS):
                e.submit(h, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                         act.copy())
            if before is not None:
                before(t, k, e, handles[k])
            e.flush()
            out[k].append([e.take_events(h) for h in handles[k]])
    for k in DEFERRED:
        if k in engines:
            assert engines[k].has_pending()
            engines[k].drain()
            assert not engines[k].has_pending()
            out[k].append([engines[k].take_events(h) for h in handles[k]])
    return handles, out


def assert_shifted(out, key, shift, ref="cpu"):
    if shift:
        assert all(len(e) == 0 and len(lv) == 0 for e, lv in out[key][0]), \
            f"{key}: tick 0 delivered events"
    assert len(out[key]) == len(out[ref]) + shift
    for t, want in enumerate(out[ref]):
        for s, ((we, wl), (ge, gl)) in enumerate(zip(want,
                                                     out[key][t + shift])):
            np.testing.assert_array_equal(ge, we,
                                          err_msg=f"{key} enter t={t} s={s}")
            np.testing.assert_array_equal(gl, wl,
                                          err_msg=f"{key} leave t={t} s={s}")


@pytest.mark.parametrize("where,sched", [
    ("single", True), ("single", False), ("mesh1", True), ("mesh4", False)])
def test_deferred_equals_oracle_shifted(where, sched):
    """pipeline, cross_tick and both: the oracle and the sequential port
    engine shifted by one tick.  Single device: one tick's prefetch is cut
    to one row (a miss: the harvest fetches the rest).  Mesh (1 and 4
    virtual shards): one tick's chunk cap is cut to one chunk, so its
    harvest recovers from the record's grids after the next tick was
    dispatched (the two-deep scratch ring)."""
    mesh = None if where == "single" else SpaceMesh(
        ["cpu"] * int(where[-1]))
    kw = {"device": "cpu", "flush_sched": sched, "mesh": mesh}
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "seq": AOIEngine(**kw)}
    engines.update((k, AOIEngine(**kw, **v)) for k, v in DEFERRED.items())

    def cut(t, k, e, hs):
        if t == 3 and k in DEFERRED:
            for h in hs:
                if mesh is None:
                    h.bucket._pred_tri = 1
                else:
                    h.bucket._max_chunks = 1

    handles, out = drive(engines, 7, before=cut)
    assert_shifted(out, "seq", 0)
    for k in DEFERRED:
        assert_shifted(out, k, 1)
        st = handles[k][0].bucket.stats
        if mesh is None:
            assert st["prefetch_hits"] > 0 and st["prefetch_misses"] > 0, st
        else:
            assert st["decode_overflow"] > 0 and st["prefetch_hits"] > 0, st
        for hd, hs in zip(handles[k], handles["seq"]):
            np.testing.assert_array_equal(hd.bucket.get_prev(hd.slot),
                                          hs.bucket.get_prev(hs.slot))


def _case_grow(eng, ora):
    """grow_space delivers the tick in flight and carries its events; the
    next ticks keep the one-tick shift."""
    rng, xs, zs, rr, act = _scene(3, 128, 100)
    h, oh = eng.create_space(128), ora.create_space(128)
    got, want = [], []
    for t in range(3):
        if t == 1:
            h, oh = eng.grow_space(h, 256), ora.grow_space(oh, 256)
            got.append(eng.take_events(h))  # the carried tick 0
        cap = h.capacity
        _sparse_step(rng, xs, zs)
        for e, hh, out in ((eng, h, got), (ora, oh, want)):
            e.submit(hh, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                     _pad(act[:100], cap))
            e.flush()
            out.append(e.take_events(hh))
    eng.drain()
    got.append(eng.take_events(h))
    assert len(got[1][0]) > 0, "tick 0's mass enter lost across growth"
    return [got[0], got[2]], [got[1], got[3], got[4]], want


def _case_release(eng, ora):
    """A slot released while its tick is in flight: the reused slot gets
    none of the dead space's events."""
    x = np.zeros(128, np.float32)
    r = np.full(128, 10, np.float32)
    act = np.zeros(128, bool)
    act[:2] = True
    h1 = eng.create_space(128)
    eng.submit(h1, x, x, r, act)
    eng.flush()
    eng.release_space(h1)
    h2 = eng.create_space(128)
    assert h2.slot == h1.slot
    eng.submit(h2, x, x, r, np.zeros(128, bool))
    eng.flush()
    got = [eng.take_events(h2)]
    eng.drain()
    got.append(eng.take_events(h2))
    empty = (np.empty((0, 2), np.int32),) * 2
    return [], got, [empty, empty]


def _case_midtick(eng, ora):
    """A harvest forced mid-tick (grow_space of another space before this
    one's events are taken) appends to the pending events."""
    x = np.array([0.0, 5.0], np.float32)
    r = np.full(2, 50, np.float32)
    act = np.ones(2, bool)
    hs = [eng.create_space(128), eng.create_space(128)]
    ohs = [ora.create_space(128), ora.create_space(128)]
    want = []
    for _t in range(2):
        for e, hh in ((eng, hs), (ora, ohs)):
            for h in hh:
                e.submit(h, x, x, r, act)
            e.flush()
        want.append(ora.take_events(ohs[1]))
        ora.take_events(ohs[0])
    eng.take_events(hs[0])
    eng.grow_space(hs[0], 256)  # delivers tick 1 into space 1's pending
    both = eng.take_events(hs[1])
    merged = tuple(np.concatenate([want[0][i], want[1][i]]) for i in (0, 1))
    assert len(merged[0]) == 2
    return [], [both], [merged]


def _case_unsub(eng, ora):
    """Every slot unsubscribed: no count, no prefetch, nothing fetched;
    the state still equals the oracle's."""
    rng, xs, zs, rr, act = _scene(5, 256, 150)
    hs = [eng.create_space(256) for _ in range(2)]
    ohs = [ora.create_space(256) for _ in range(2)]
    for h in hs:
        eng.set_subscribed(h, False)
    got = []
    for _t in range(3):
        _sparse_step(rng, xs, zs)
        for e, hh in ((eng, hs), (ora, ohs)):
            for h in hh:
                e.submit(h, _pad(xs, 256), _pad(zs, 256), _pad(rr, 256),
                         act.copy())
            e.flush()
        rec = hs[0].bucket._inflight
        assert rec["all_unsub"] and rec["count"] is None \
            and rec["prefetch"] is None
        got.append(eng.take_events(hs[0]))
    for h, oh in zip(hs, ohs):
        np.testing.assert_array_equal(h.bucket.get_prev(h.slot),
                                      oh.bucket.get_prev(oh.slot))
    empty = (np.empty((0, 2), np.int32),) * 2
    return [], got, [empty] * 3


def _case_clear_mirror(eng, ora):
    """clear_entity while a tick is in flight, the host mirror on: the
    clear lands after that tick's stream (_mirror_ops), so the mirror
    ends equal to the device words and to the oracle's."""
    x = np.array([0.0, 5.0, 10.0], np.float32)
    r = np.full(3, 50, np.float32)
    act = np.ones(3, bool)
    h, oh = eng.create_space(128), ora.create_space(128)
    b = h.bucket
    b.peek_words(h.slot)  # the mirror on before any traffic
    got, want = [], []
    for t in range(2):
        if t == 1:
            eng.clear_entity(h, 1)
            ora.clear_entity(oh, 1)
            act = act.copy()
            act[1] = False
        for e, hh, out in ((eng, h, got), (ora, oh, want)):
            e.submit(hh, x, x, r, act)
            e.flush()
            out.append(e.take_events(hh))
    assert b._mirror_ops == []  # applied at tick 0's harvest
    eng.drain()
    got.append(eng.take_events(h))
    words = b.peek_words(h.slot)
    m = P.unpack_rows(words, 128)
    assert m[0, 2] and m[2, 0] and not m[0, 1] and not m[1, 0]
    np.testing.assert_array_equal(words, P.words_to_numpy(b.prev[h.slot]))
    np.testing.assert_array_equal(words, oh.bucket.get_prev(oh.slot))
    return [], got, want


@pytest.mark.parametrize("case", [_case_grow, _case_release, _case_midtick,
                                  _case_unsub, _case_clear_mirror],
                         ids=lambda f: f.__name__[6:])
@pytest.mark.parametrize("flag", ["pipeline", "cross_tick"])
def test_deferred_cases(case, flag):
    """Each case returns (events with nothing to hold them to: they must
    be empty, events delivered from tick 0 on, the oracle's per tick); a
    deferred engine's tick 0 is empty and tick t+1 equals the oracle's
    tick t."""
    eng = AOIEngine(device="cpu", **{flag: True})
    quiet, got, want = case(eng, JaxEngine(default_backend="cpu"))
    for e, lv in quiet:
        assert len(e) == 0 and len(lv) == 0
    assert len(got) == len(want) + 1 or len(got) == len(want)
    if len(got) == len(want) + 1:
        assert len(got[0][0]) == 0 and len(got[0][1]) == 0
        got = got[1:]
    for t, ((ge, gl), (we, wl)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(ge, we, err_msg=f"enter t={t}")
        np.testing.assert_array_equal(gl, wl, err_msg=f"leave t={t}")


@pytest.mark.parametrize("flags", [{"pipeline": True}, {"cross_tick": True},
                                   {"pipeline": True, "cross_tick": True}])
def test_rowshard_stays_synchronous(flags):
    """The row-sharded bucket accepts the flags and delivers at zero
    shift, equal to the oracle."""
    cap = 1024
    eng = AOIEngine(device="cpu", mesh=SpaceMesh(["cpu"] * 4),
                    rowshard_min_capacity=cap, **flags)
    ora = JaxEngine(default_backend="cpu")
    h, oh = eng.create_space(cap), ora.create_space(cap)
    assert isinstance(h.bucket, _RowShardCUDABucket)
    rng, xs, zs, rr, act = _scene(13, cap, 300)
    for _t in range(3):
        _sparse_step(rng, xs, zs)
        for e, hh in ((eng, h), (ora, oh)):
            e.submit(hh, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                     act.copy())
            e.flush()
        assert not eng.has_pending()
        got, want = eng.take_events(h), ora.take_events(oh)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert len(want[0]) + len(want[1]) > 0


def _runtime_crcs(**kw):
    """A seeded game on the port's Runtime (watchers, bulk moves, growth
    past capacity 128): the CRC of each tick's delivered arrays, and of
    the trailing drain."""
    from goworld_tpu_torch.engine.entity import Entity
    from goworld_tpu_torch.engine.runtime import Runtime
    from goworld_tpu_torch.engine.space import Space
    from goworld_tpu_torch.engine.vector import Vector3

    class Scene(Space):
        pass

    class Mob(Entity):
        use_aoi = True
        aoi_distance = 60.0

    class Watcher(Mob):
        def on_enter_aoi(self, other):
            pass

    rt = Runtime(device="cpu", **kw)
    for cls in (Scene, Mob, Watcher):
        rt.entities.register(cls)
    crc = [0]
    take = rt.aoi.take_events

    def folding_take(h):
        ev = take(h)
        for a in ev:
            crc[0] = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc[0])
        return ev

    rt.aoi.take_events = folding_take
    sp = rt.entities.create_space("Scene", kind=1)
    sp.enable_aoi(60.0)
    rng = np.random.default_rng(4)
    ents = []

    def spawn(k):
        for p in rng.uniform(0, 400, (k, 2)):
            ents.append(rt.entities.create(
                "Watcher" if len(ents) % 10 == 0 else "Mob", space=sp,
                pos=Vector3(float(p[0]), 0.0, float(p[1]))))

    spawn(100)
    out = []
    for t in range(6):
        if t == 3:
            spawn(60)  # growth past capacity 128
        if t:
            slots = np.array([e.aoi_slot for e in ents])
            pos = np.array([[e.position.x, e.position.z] for e in ents])
            pos += rng.uniform(-12, 12, pos.shape)
            sp.move_entities(slots, pos[:, 0].astype(np.float32),
                             pos[:, 1].astype(np.float32))
        crc[0] = 0
        rt.tick()
        out.append(crc[0])
    crc[0] = 0
    rt.aoi.drain()
    sp.dispatch_aoi_events()
    out.append(crc[0])
    assert sp._cap == 256
    return out


@pytest.mark.parametrize("kw", [{"aoi_pipeline": True},
                                {"aoi_cross_tick": True}])
def test_runtime_deferred_equals_sequential_shifted(kw):
    seq = _runtime_crcs()
    got = _runtime_crcs(**kw)
    assert seq[-1] == 0  # nothing left in flight
    assert got[0] == 0 and got[1:] == seq[:-1]
