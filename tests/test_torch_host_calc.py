"""The port's host calculators, ``auto`` routing and ``host`` emit mode
against the JAX package's.

* The numpy oracle (``ops/aoi_oracle.CPUAOIOracle``, ``pairwise`` and
  ``sweep``) and the native sweep (``ops/aoi_native.NativeAOIOracle`` over
  the shared ``native/libgwaoi.so``) against the JAX package's classes on
  the same seeded inputs, with ties (|dx| == r), -0.0, NaN, +-inf and
  subnormal positions and radii (all host numpy or C++: no XLA, so no
  flush-to-zero to hold apart); the native library against the numpy
  predicate on finite inputs.
* ``AOIEngine(default_backend=...)`` for ``cpu``, ``cpp`` and ``auto``
  (the device spaces on ``device="cpu"``: the plain PyTorch step) against
  the JAX engine under the same backend, through clears and a growth that
  moves an ``auto`` space from the host calculator to the device; the
  routing of the default threshold (1024 -> ``cpp``, 4096 and 16384 ->
  ``cuda``, the JAX package's ``tpu``).
* ``emit="host"`` against ``native`` and ``vector``, through a forced
  triple-cap overflow.

Tolerance: exact equality of every tick's enter/leave arrays and of the
interest words.
"""

import numpy as np
import pytest

from goworld_tpu.engine.aoi import AOIEngine as JaxEngine
from goworld_tpu.ops import aoi_native as JN
from goworld_tpu.ops import aoi_oracle as JO
from goworld_tpu_torch.engine.aoi import AOIEngine
from goworld_tpu_torch.ops import aoi_emit as TE
from goworld_tpu_torch.ops import aoi_native as TN
from goworld_tpu_torch.ops import aoi_oracle as TO
from goworld_tpu_torch.ops import aoi_predicate as TP

from test_aoi_parity import random_walk_scenario
from torch_threads import one_intra_op_thread  # noqa: F401

# inf - inf and NaN inputs warn in numpy; the values are what is tested
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

SUB = np.float32(1e-40)  # subnormal in float32


def special_ticks(seed, cap, ticks=3):
    """Per tick (x, z, r, act) over ``cap`` slots: a tie lattice, signed
    zeros, NaN, +-inf and subnormal coordinates and radii, inactive tail."""
    rng = np.random.default_rng(seed)
    n = cap - 16
    out = []
    for t in range(ticks):
        x = (np.round(rng.uniform(0, 60, cap) * 4) / 4).astype(np.float32)
        z = (np.round(rng.uniform(0, 60, cap) * 4) / 4).astype(np.float32)
        r = rng.choice([2.0, 4.0, 8.25], cap).astype(np.float32)
        x[:4] = [0.0, -0.0, SUB, -SUB]
        z[:4] = [-0.0, 0.0, 0.0, SUB]
        r[:4] = [0.0, SUB, SUB, 0.0]
        x[4:8] = [np.nan, np.inf, -np.inf, 1.0]
        z[4:8] = [1.0, 1.0, 1.0, np.nan]
        r[8:12] = [np.inf, np.nan, -1.0, np.inf]
        x[12 + t] = x[20]  # a moving exact tie
        act = np.zeros(cap, bool)
        act[:n] = rng.random(n) < 0.9
        out.append((x, z, r, act))
    return out


ORACLES = {
    "pairwise": (lambda c: TO.CPUAOIOracle(c, "pairwise"),
                 lambda c: JO.CPUAOIOracle(c, "pairwise")),
    "sweep": (lambda c: TO.CPUAOIOracle(c, "sweep"),
              lambda c: JO.CPUAOIOracle(c, "sweep")),
    "native-auto": (lambda c: TN.NativeAOIOracle(c, "auto"),
                    lambda c: JN.NativeAOIOracle(c, "auto")),
    "native-sweep": (lambda c: TN.NativeAOIOracle(c, "sweep"),
                     lambda c: JN.NativeAOIOracle(c, "sweep")),
    # the native library against the numpy predicate: on finite inputs
    # only (libgwaoi, shared with the JAX package, drops pairs when a
    # coordinate or radius is NaN or infinite; ROADMAP.md queue 3)
    "native-vs-numpy": (lambda c: TN.NativeAOIOracle(c, "auto"),
                        lambda c: JO.CPUAOIOracle(c, "pairwise")),
}


@pytest.mark.parametrize("name,special", [
    (n, sp) for n in ORACLES for sp in (True, False)
    if not (sp and n == "native-vs-numpy")])
def test_host_oracles_match_jax(name, special):
    cap = 256
    ticks = (special_ticks(5, cap) if special else
             list(random_walk_scenario(3, cap, 200, 3, tie_lattice=True)))
    make_port, make_ref = ORACLES[name]
    port, ref = make_port(cap), make_ref(cap)
    n_events = 0
    for t, (x, z, r, act) in enumerate(ticks):
        got, want = port.step(x, z, r, act), ref.step(x, z, r, act)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"tick {t}")
        np.testing.assert_array_equal(port.prev_words, ref.prev_words)
        n_events += sum(len(a) for a in got)
    assert n_events > 0 or name == "native-auto"
    # a short input pads; an oversized one raises
    port.step(x[:100], z[:100], r[:100], act[:100])
    with pytest.raises(ValueError):
        port.step(np.zeros(cap + 1, np.float32), np.zeros(cap + 1),
                  np.zeros(cap + 1), np.zeros(cap + 1, bool))


def test_interest_matrix_matches_jax():
    from goworld_tpu.ops import aoi_predicate as JP

    for x, z, r, act in special_ticks(9, 128, ticks=2):
        np.testing.assert_array_equal(TP.interest_matrix(x, z, r, act),
                                      JP.interest_matrix(x, z, r, act))


@pytest.mark.parametrize("backend", ["cpu", "cpp", "auto"])
def test_engine_backends_match_jax(backend):
    """Three spaces (two small, one at the device threshold), per-tick
    events equal to the JAX engine's under the same backend, entity
    clears, and a growth that re-resolves an ``auto`` space."""
    port = AOIEngine(device="cpu", default_backend=backend,
                     cuda_min_capacity=256)
    jax = JaxEngine(default_backend=backend, tpu_min_capacity=256)
    caps = (128, 128, 256)
    scen = [list(random_walk_scenario(s, c, c - 20, 5, tie_lattice=s == 1))
            for s, c in enumerate(caps)]
    hp = [port.create_space(c) for c in caps]
    hj = [jax.create_space(c) for c in caps]
    for a, b in zip(hp, hj):
        assert a.backend == {"tpu": "cuda"}.get(b.backend, b.backend)
        assert a.requested == b.requested == backend
    for t in range(5):
        if t == 2:
            for e, hs in ((port, hp), (jax, hj)):
                e.clear_entity(hs[0], 3)
                hs[1] = e.grow_space(hs[1], 256)
            assert hp[1].backend == ("cpp" if backend == "cpp" else
                                     "cpu" if backend == "cpu" else "cuda")
        evs = []
        for e, hs in ((port, hp), (jax, hj)):
            for h, sc in zip(hs, scen):
                x, z, r, act = sc[t]
                if t >= 2 and h is hs[0]:
                    act = act.copy()
                    act[3] = False
                if t >= 2 and h is hs[1]:
                    x, z, r, act = (np.concatenate([a, np.zeros(128, a.dtype)])
                                    for a in (x, z, r, act))
                e.submit(h, x, z, r, act)
            e.flush()
            evs.append([e.take_events(h) for h in hs])
        for s, (g, w) in enumerate(zip(*evs)):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=f"t={t} s={s}")
    for a, b in zip(hp, hj):
        np.testing.assert_array_equal(a.bucket.get_prev(a.slot),
                                      b.bucket.get_prev(b.slot))


def test_auto_routing_default_threshold():
    port = AOIEngine(device="cpu", default_backend="auto")
    jax = JaxEngine(default_backend="auto")
    assert port.cuda_min_capacity == jax.tpu_min_capacity == 4096
    for cap in (1000, 1024, 4096, 16384):
        a, b = port.create_space(cap), jax.create_space(cap)
        assert (a.backend, a.capacity, a.requested) == (
            {"tpu": "cuda"}.get(b.backend, b.backend), b.capacity,
            b.requested), cap
    kinds = sorted(k[0] for k in port._buckets)
    assert kinds == ["cpp", "cuda", "cuda"]


@pytest.mark.parametrize("emit", ["host", "native", "vector"])
def test_emit_host_mode_matches(emit):
    """The three emit modes give the oracle's events; ``host`` reports
    emit_path 2 and never fuses."""
    cap = 256
    port = AOIEngine(device="cpu", emit=emit, fused=True)
    ora = JaxEngine(default_backend="cpu")
    scen = [list(random_walk_scenario(s, cap, 200, 5)) for s in (4, 5)]
    hp = [port.create_space(cap) for _ in scen]
    ho = [ora.create_space(cap) for _ in scen]
    b = hp[0].bucket
    for t in range(5):
        if t == 3:
            b._max_triples = 64  # the next tick overflows the cap
        evs = []
        for e, hs in ((port, hp), (ora, ho)):
            for h, sc in zip(hs, scen):
                e.submit(h, *sc[t])
            e.flush()
            evs.append([e.take_events(h) for h in hs])
        for g, w in zip(*evs):
            for a, c in zip(g, w):
                np.testing.assert_array_equal(a, c, err_msg=f"t={t}")
    assert b.stats["emit_path"] == TE.EMIT_LEVEL[emit]
    assert b.stats["decode_overflow"] >= 1
    if emit == "host":
        assert b.stats["fused_dispatches"] == 0
    assert TE.resolve_mode(emit) == emit or emit == "native"
