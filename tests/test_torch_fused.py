"""The port's fused tick (goworld_tpu_torch.ops.fused, ``fused=True``) on
device="cpu", where the graph's body runs eagerly: its plain version.
Tolerance: exact equality of every tick's enter and leave arrays.

On a sparse walk (10% movers a tick, as ``bench.py``'s
``movers_frac=0.1``) the fused engine equals the unfused one and the JAX
package's CPU oracle on every tick, its fallback ticks included (the
full first tick, an r change, a mass move), and its zero-mover tick;
fused + cross-tick equals them shifted by one.  A steady fused tick is
one dispatch against the unfused two (``ops.dispatch_count``), the
fused dispatches equal the eligible ticks, the packet has one length,
and the capture key is a pure function with no new key after warm-up."""

import numpy as np
import pytest

from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.ops import aoi_stage as AS
from goworld_tpu_torch.ops import dispatch_count as DC
from goworld_tpu_torch.ops import fused as FZ
from test_aoi_delta import _pad, _scene, _sparse_step
from torch_threads import one_intra_op_thread  # noqa: F401

CAPS = (256, 512)
TICKS = 9
# tick -> what the walk does that tick (every other tick: 10% movers)
SPECIAL = {3: "still", 5: "radius", 7: "mass"}


def fused_walk(engines, seed=7, n=180):
    """One walk per capacity into every engine: per tick out[key][tick] =
    [(enter, leave) per space] and dispatches[key][tick]; a deferred
    engine's trailing tick comes out of ``drain()``."""
    handles = {k: [e.create_space(c) for c in CAPS]
               for k, e in engines.items()}
    scenes = [list(_scene(seed + i, cap, n)) for i, cap in enumerate(CAPS)]
    out = {k: [] for k in engines}
    dispatches = {k: [] for k in engines}
    for t in range(TICKS):
        for rng, xs, zs, rr, _act in scenes:
            what = SPECIAL.get(t)
            if what == "radius":
                rr[5] += 7.0
            elif what == "mass":
                _sparse_step(rng, xs, zs, frac=1.0)
            elif what is None:
                _sparse_step(rng, xs, zs)
        for k, e in engines.items():
            for (_rng, xs, zs, rr, act), h, cap in zip(scenes, handles[k],
                                                        CAPS):
                e.submit(h, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                         act.copy())
            DC.reset()
            e.flush()
            dispatches[k].append(DC.read())
            out[k].append([e.take_events(h) for h in handles[k]])
    for k, e in engines.items():
        if e.has_pending():
            e.drain()
            out[k].append([e.take_events(h) for h in handles[k]])
    return handles, out, dispatches


def test_fused_equals_unfused_and_oracle():
    engines = {"cpu": JaxEngine(default_backend="cpu"),
               "plain": AOIEngine(device="cpu"),
               "fused": AOIEngine(device="cpu", fused=True),
               "fxt": AOIEngine(device="cpu", fused=True, cross_tick=True)}
    handles, out, dispatches = fused_walk(engines)
    for k, shift in (("plain", 0), ("fused", 0), ("fxt", 1)):
        assert len(out[k]) == TICKS + shift
        if shift:
            assert all(len(e) + len(lv) == 0 for e, lv in out[k][0])
        for t in range(TICKS):
            for s, ((we, wl), (ge, gl)) in enumerate(zip(
                    out["cpu"][t], out[k][t + shift])):
                np.testing.assert_array_equal(ge, we, err_msg=f"{k} t={t}")
                np.testing.assert_array_equal(gl, wl, err_msg=f"{k} t={t}")
    # eligible: every delta tick of the unfused engine (the first tick,
    # the r change and the mass move restage in full)
    eligible = [t for t in range(TICKS)
                if t not in (0, 5, 7)]
    for i, cap in enumerate(CAPS):
        plain = handles["plain"][i].bucket.stats
        assert plain["delta_flushes"] == len(eligible)
        assert plain["full_flushes"] == TICKS - len(eligible)
        for k in ("fused", "fxt"):
            st = handles[k][i].bucket.stats
            assert st["fused_dispatches"] == len(eligible), (k, st)
            assert st["fused_demotions"] == 0
            assert st["delta_flushes"] == plain["delta_flushes"]
    # two buckets a tick: the unfused delta tick counts 2 each (scatter +
    # step; 1 when nothing moved), the fused 1 each, a full restage 1
    # each; tick 0 adds each new slot's reset
    for t in range(TICKS):
        want_plain = 2 * (1 if t in (3, 5, 7) else 2)
        want_fused = 4 if t == 0 else 2
        assert dispatches["plain"][t] == want_plain, (t, dispatches)
        assert dispatches["fused"][t] == dispatches["fxt"][t] \
            == want_fused, (t, dispatches)


def test_fused_packet_has_one_length():
    """Every fused tick ships ``packet_len`` entries, padded by repeating
    the last (an idempotent set); a zero-mover tick ships one entry that
    rewrites a value the device already holds."""
    assert FZ.packet_len(8, 16384, 0.25) == 32768  # the card's phase 14
    assert FZ.packet_len(1, 256, 0.25) == 64
    assert FZ.packet_len(3, 512, 0.25) == 512
    rows, cols = np.array([0, 2, 1]), np.array([5, 9, 4])
    xv, zv = np.float32([1, 2, 3]), np.float32([4, 5, 6])
    pkt = AS.pad_packet(rows, cols, xv, zv, length=64)
    assert all(len(a) == 64 for a in pkt)
    for a, src in zip(pkt, (rows, cols, xv, zv)):
        np.testing.assert_array_equal(a[:3], src)
        assert (a[3:] == src[-1]).all()
    with pytest.raises(ValueError):
        AS.pad_packet(rows, cols, xv, zv, length=2)
    eng = AOIEngine(device="cpu", fused=True)
    h = eng.create_space(256)
    rng, xs, zs, rr, act = _scene(1, 256, 200)
    lens = set()
    for t in range(4):
        if t != 2:  # tick 2: nobody moves
            _sparse_step(rng, xs, zs)
        eng.submit(h, _pad(xs, 256), _pad(zs, 256), _pad(rr, 256), act)
        eng.flush()
        fz = h.bucket._fz
        if fz is not None:
            lens.add(tuple(fz.pkt.shape))
            if t == 2:
                pkt = fz.pkt.numpy()
                assert (pkt[0] == h.slot).all() and (pkt[1] == 0).all()
                assert pkt[2:, 0].view(np.float32)[0] == np.float32(xs[0])
    assert lens == {(4, FZ.packet_len(1, 256, 0.25))}
    assert h.bucket.stats["fused_dispatches"] == 3


def test_capture_key_is_pure_and_steady():
    """The capture key is a function of shapes, packet length, parity and
    triple cap alone; after warm-up a sparse walk makes no new key, and
    the two parities alternate."""
    a = FZ.capture_key(8, 16384, 32768, 0, 65536)
    assert a == FZ.capture_key(8, 16384, 32768, 0, 65536)
    assert a != FZ.capture_key(8, 16384, 32768, 1, 65536)
    assert a != FZ.capture_key(8, 16384, 32768, 0, 131072)
    eng = AOIEngine(device="cpu", fused=True)
    h = eng.create_space(512)
    rng, xs, zs, rr, act = _scene(2, 512, 300)
    DC.clear_keys()
    parities = []
    for t in range(8):
        if t == 3:
            DC.reset_keys()
        _sparse_step(rng, xs, zs)
        eng.submit(h, _pad(xs, 512), _pad(zs, 512), _pad(rr, 512), act)
        eng.flush()
        if h.bucket._fz is not None:
            parities.append(int(h.bucket.prev is h.bucket._fz.words[0]))
    assert DC.new_keys() == 0
    assert parities[1:] == [1 - p for p in parities[:-1]]


@pytest.mark.parametrize("kw,shift", [({"fused": True}, 0),
                                      ({"fused": True, "cross_tick": True},
                                       1)])
def test_fused_partial_grid_clears_and_subscription(kw, shift):
    """Three spaces in one bucket (a grid of four rows, one never
    acquired), entity clears, a space unsubscribed for three ticks (its
    events masked) and the host mirror on: fused (and fused + cross-tick,
    shifted) equals the oracle per tick, and the words and the mirror end
    equal."""
    cap = 256
    ora = JaxEngine(default_backend="cpu")
    eng = AOIEngine(device="cpu", **kw)
    scenes = [list(_scene(s, cap, 150)) for s in (1, 2, 3)]
    hs = [eng.create_space(cap) for _ in scenes]
    ohs = [ora.create_space(cap) for _ in scenes]
    assert hs[0].bucket.s_max == 4
    hs[0].bucket.peek_words(hs[0].slot)  # the mirror on
    got, want = [], []
    for t in range(10):
        if t in (3, 6):
            eng.set_subscribed(hs[1], t == 6)
            ora.set_subscribed(ohs[1], t == 6)
        for i, (rng, xs, zs, _rr, act) in enumerate(scenes):
            _sparse_step(rng, xs, zs)
            if t in (4, 7) and i == 2:
                act[10 + t] = False
                eng.clear_entity(hs[i], 10 + t)
                ora.clear_entity(ohs[i], 10 + t)
        for e, hh, out in ((eng, hs, got), (ora, ohs, want)):
            for (_rng, xs, zs, rr, act), h in zip(scenes, hh):
                e.submit(h, _pad(xs, cap), _pad(zs, cap), _pad(rr, cap),
                         act.copy())
            e.flush()
            out.append([e.take_events(h) for h in hh])
    eng.drain()
    got.append([eng.take_events(h) for h in hs])
    assert all(len(e) + len(lv) == 0 for e, lv in got[0]) or not shift
    for t in range(10):
        for s in range(3):
            if s == 1 and 3 <= t < 6:  # masked (the CPU oracle ignores it)
                assert all(len(a) == 0 for a in got[t + shift][s])
                continue
            for g, w in zip(got[t + shift][s], want[t][s]):
                np.testing.assert_array_equal(g, w, err_msg=f"t={t} s={s}")
    for h, oh in zip(hs, ohs):
        np.testing.assert_array_equal(h.bucket.get_prev(h.slot),
                                      oh.bucket.get_prev(oh.slot))
    np.testing.assert_array_equal(hs[0].bucket.peek_words(hs[0].slot),
                                  ohs[0].bucket.get_prev(ohs[0].slot))
    st = hs[0].bucket.stats
    # eligible: every tick but the first, the two whose departure changes
    # act and the two that change a subscription (all four restage in
    # full, as the JAX bucket does)
    assert st["fused_dispatches"] == st["delta_flushes"] == 5, st
    assert st["full_flushes"] == 5
