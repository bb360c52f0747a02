"""The port's AOIEngine (goworld_tpu_torch.engine.aoi, device="cpu": the
plain PyTorch step under the _CUDABucket) against the JAX package's
AOIEngine on its "tpu" bucket and its "cpu" oracle: per-tick enter/leave
arrays must be equal, element for element, through multi-space walks,
slot reuse, growth, idle spaces, subscription, entity clears, forced
triple overflow and a mid-walk state carry from a JAX bucket."""

import numpy as np
import pytest
import torch

from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.ops import aoi_cuda as AK
from test_aoi_parity import random_walk_scenario


def sparse_walk(seed, cap, n, ticks, frac=0.05):
    """Yields (x, z, r, active) per tick with only ``frac`` of the
    entities moving each tick (the delta-packet staging path)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 300, cap).astype(np.float32)
    z = rng.uniform(0, 300, cap).astype(np.float32)
    r = rng.choice([20.0, 40.0], cap).astype(np.float32)
    act = np.zeros(cap, bool)
    act[:n] = True
    for _ in range(ticks):
        yield x.copy(), z.copy(), r.copy(), act.copy()
        sel = rng.random(cap) < frac
        x[sel] += rng.uniform(-8, 8, sel.sum()).astype(np.float32)
        z[sel] += rng.uniform(-8, 8, sel.sum()).astype(np.float32)


def engines(**port_kw):
    return {"port": AOIEngine(device="cpu", **port_kw),
            "tpu": JaxEngine(default_backend="tpu"),
            "cpu": JaxEngine(default_backend="cpu")}


def drive(engs, scenarios, cap, between=None):
    """Submit every scenario's tick to every engine, flush, take events;
    assert all engines agree each tick.  ``between(t, engs, hs)`` runs
    before each tick's submit."""
    hs = {k: [e.create_space(cap) for _ in scenarios]
          for k, e in engs.items()}
    for t in range(len(scenarios[0])):
        if between is not None:
            between(t, engs, hs)
        evs = {}
        for k, e in engs.items():
            for h, sc in zip(hs[k], scenarios):
                if sc[t] is not None:
                    e.submit(h, *sc[t])
            e.flush()
            evs[k] = [e.take_events(h) for h in hs[k]]
        assert_same(evs, t)
    return hs


def assert_same(evs, t):
    ref = evs["cpu"]
    for k, got in evs.items():
        for s, ((ge, gl), (re_, rl)) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(ge, re_, err_msg=f"{k} enter t={t} s={s}")
            np.testing.assert_array_equal(gl, rl, err_msg=f"{k} leave t={t} s={s}")


@pytest.mark.parametrize("emit,delta,sched", [
    ("native", True, True), ("vector", False, False)])
def test_multi_space_walk_parity(emit, delta, sched):
    cap = 256
    scenarios = [list(random_walk_scenario(seed, cap, 200, 4,
                                           tie_lattice=seed % 2 == 0))
                 for seed in range(3)]
    scenarios.append(list(sparse_walk(7, cap, 220, 4)))
    engs = engines(emit=emit, delta_staging=delta, flush_sched=sched)
    AK.reset_launches()
    hs = drive(engs, scenarios, cap)
    assert AK.launches["aoi_step"] == 0  # CPU tensors: the plain step
    b = hs["port"][0].bucket
    for hp, hj in zip(hs["port"], hs["tpu"]):
        np.testing.assert_array_equal(b.get_prev(hp.slot),
                                      hj.bucket.get_prev(hj.slot))


@pytest.mark.parametrize("delta", [True, False])
def test_sparse_walk_delta_staging_parity(delta):
    cap = 256
    scenarios = [list(sparse_walk(s, cap, 220, 5)) for s in (8, 9)]
    hs = drive(engines(delta_staging=delta), scenarios, cap)
    stats = hs["port"][0].bucket.stats
    assert stats["delta_flushes"] == (4 if delta else 0)
    assert stats["full_flushes"] == (1 if delta else 5)


def test_slot_reuse_no_ghost_events():
    cap = 128
    x = np.zeros(cap, np.float32)
    r = np.full(cap, 10, np.float32)
    act = np.zeros(cap, bool)
    act[:2] = True
    for eng in engines().values():
        h1 = eng.create_space(cap)
        eng.submit(h1, x, x, r, act)
        eng.flush()
        assert len(eng.take_events(h1)[0]) == 2
        eng.release_space(h1)
        h2 = eng.create_space(cap)
        assert h2.slot == h1.slot
        eng.submit(h2, x, x, r, np.zeros(cap, bool))
        eng.flush()
        e, lv = eng.take_events(h2)
        assert len(e) == 0 and len(lv) == 0, f"{eng}: ghost {e} {lv}"


def test_grow_space_carries_state():
    cap, n = 128, 100
    x = np.random.default_rng(1).uniform(0, 300, n).astype(np.float32)
    r = np.full(n, 60, np.float32)
    act = np.ones(n, bool)
    out = {}
    for k, eng in engines().items():
        h = eng.create_space(cap)
        other = eng.create_space(cap)  # a neighbour slot in the same bucket
        eng.submit(h, x, x, r, act)
        eng.submit(other, x[::-1].copy(), x, r, act)
        eng.flush()
        first = eng.take_events(h)
        h = eng.grow_space(h, 512)
        x2 = np.pad(x + 3, (0, 1))
        eng.submit(h, x2, x2, np.pad(r, (0, 1)), np.pad(act, (0, 1)))
        eng.flush()
        out[k] = (first, eng.take_events(h), eng.take_events(other))
        assert h.capacity == 512
    for k in out:
        for a, b in zip(out[k], out["cpu"]):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_unstaged_space_keeps_state():
    cap = 256
    a = list(random_walk_scenario(1, cap, 150, 5))
    b = list(random_walk_scenario(2, cap, 150, 5))
    b[1] = b[2] = None  # space b sits out ticks 1 and 2
    drive(engines(), [a, b], cap)


def test_subscription_masks_stream_and_peek_refreshes():
    cap = 256
    scenarios = [list(random_walk_scenario(s, cap, 200, 6)) for s in range(2)]
    engs = engines()

    def between(t, engs, hs):
        for k, e in engs.items():
            if k == "cpu":
                continue  # the oracle ignores subscription
            if t == 0:
                e.set_subscribed(hs[k][1], False)
                hs[k][1].bucket.peek_words(hs[k][1].slot)
            if t == 4:
                e.set_subscribed(hs[k][1], True)

    hs = {k: [e.create_space(cap) for _ in scenarios] for k, e in engs.items()}
    for t in range(6):
        between(t, engs, hs)
        evs = {}
        for k, e in engs.items():
            for h, sc in zip(hs[k], scenarios):
                e.submit(h, *sc[t])
            e.flush()
            evs[k] = [e.take_events(h) for h in hs[k]]
        if t < 4:  # the unsubscribed space delivers nothing
            for k in ("port", "tpu"):
                assert all(len(a) == 0 for a in evs[k][1])
                evs[k][1] = evs["cpu"][1]
        assert_same(evs, t)
    want = hs["cpu"][1].bucket.peek_words(hs["cpu"][1].slot)
    np.testing.assert_array_equal(
        hs["port"][1].bucket.peek_words(hs["port"][1].slot), want)
    np.testing.assert_array_equal(
        hs["tpu"][1].bucket.peek_words(hs["tpu"][1].slot), want)


@pytest.mark.parametrize("mirror", [False, True])
def test_clear_entity_parity(mirror):
    cap = 256
    sc = list(random_walk_scenario(3, cap, 200, 5))
    gone = [5, 17, 40]

    def between(t, engs, hs):
        if t == 0 and mirror:
            for k in ("port", "tpu"):
                hs[k][0].bucket.peek_words(hs[k][0].slot)
        if t == 2:
            for e, h in ((e, hs[k][0]) for k, e in engs.items()):
                for s in gone:
                    e.clear_entity(h, s)
        if t >= 2:
            for s in gone:
                sc[t][3][s] = False

    hs = drive(engines(), [sc], cap, between)
    want = hs["cpu"][0].bucket.peek_words(hs["cpu"][0].slot)
    np.testing.assert_array_equal(
        hs["port"][0].bucket.peek_words(hs["port"][0].slot), want)


def test_forced_triple_overflow_recovers_and_grows():
    cap = 256
    scenarios = [list(random_walk_scenario(s, cap, 220, 4)) for s in range(2)]
    engs = engines()
    caps = []

    def between(t, engs, hs):
        b = hs["port"][0].bucket
        if t == 0:
            b._max_triples = 8
        caps.append(b._max_triples)

    hs = drive(engs, scenarios, cap, between)
    b = hs["port"][0].bucket
    assert b.stats["decode_overflow"] >= 1
    assert caps[1] > 8  # grew after the first overflow


def test_state_carry_from_jax_bucket():
    """Seed a port bucket mid-walk from a JAX bucket's words and input
    shadows; both must then continue identically (the carry-over of this
    system's state, as weights are carried in a model port)."""
    cap = 256
    scenarios = [list(random_walk_scenario(s, cap, 200, 6)) for s in (4, 5)]
    jax_eng = JaxEngine(default_backend="tpu")
    jhs = [jax_eng.create_space(cap) for _ in scenarios]
    for t in range(3):
        for h, sc in zip(jhs, scenarios):
            jax_eng.submit(h, *sc[t])
        jax_eng.flush()
        for h in jhs:
            jax_eng.take_events(h)
    port = AOIEngine(device="cpu")
    phs = [port.create_space(cap) for _ in scenarios]
    for ph, jh in zip(phs, jhs):
        jb, s = jh.bucket, jh.slot
        ph.bucket.import_state(ph.slot, jb.get_prev(s), jb._hx[s], jb._hz[s],
                               jb._hr[s], jb._hact[s])
        assert ph.bucket.prev.dtype == torch.int32
    for t in range(3, 6):
        for eng, hs in ((jax_eng, jhs), (port, phs)):
            for h, sc in zip(hs, scenarios):
                eng.submit(h, *sc[t])
            eng.flush()
        for ph, jh in zip(phs, jhs):
            pe, pl = port.take_events(ph)
            je, jl = jax_eng.take_events(jh)
            np.testing.assert_array_equal(pe, je)
            np.testing.assert_array_equal(pl, jl)
            assert len(pe) + len(pl) > 0
    for ph, jh in zip(phs, jhs):
        np.testing.assert_array_equal(ph.bucket.get_prev(ph.slot),
                                      jh.bucket.get_prev(jh.slot))


def test_backend_names():
    """The JAX package's backends, its "tpu" named "cuda": "cpu", "cpp"
    and "auto" (below the CUDA threshold) route to the host calculators;
    "tpu" and unknown names raise."""
    eng = AOIEngine(device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        eng.create_space(128, "tpu")
    with pytest.raises(ValueError):
        eng.create_space(128, "bogus")
    assert eng.create_space(128, "cuda").backend == "cuda"
    for name, want in (("cpu", "cpu"), ("cpp", "cpp"), ("auto", "cpp")):
        h = eng.create_space(128, name)
        assert (h.backend, h.requested) == (want, name)
