"""The port's block-culled AOI words and step (goworld_tpu_torch.ops.aoi_grid,
plain versions -- what the CPU runs and what csrc/aoi_grid.cu is held to on
the card) against the JAX package's ops/aoi_grid: the Pallas kernels in
interpret mode at col_words=32, as tests/test_aoi_grid.py runs them, and
the JAX cull table.  Tolerance: exact equality (IEEE compares and integer
packing; the culled fraction is a mean of 0/1 flags, exact in f32).

Non-finite radii are held to the JAX package's DENSE words: its cull
table's margin is max(radius) over all slots, so one NaN radius culls
every block and its culled words come out empty (pinned below)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from goworld_tpu.ops import aoi_dense as JD
from goworld_tpu.ops import aoi_grid as JG
from goworld_tpu.ops import aoi_predicate as JP
from goworld_tpu_torch.ops import aoi_grid as TG
from goworld_tpu_torch.ops import aoi_predicate as TP
from test_torch_aoi_step import covered_tiles

CW = 32  # col_words the JAX kernels take in interpret mode
# the JAX cull table jitted (eager mode compiles every primitive anew)
J_CULL = jax.jit(JG._cull_table, static_argnames=("s", "c", "ti", "wb"))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def sorted_layout(s, c, seed, world=4000.0, swap=0.0, var_r=True):
    """x-sorted active slots with an inactive tail (as sort_spaces leaves
    them), optionally 'nearly sorted': a fraction of slots swapped."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, world, (s, c)), axis=1).astype(np.float32)
    z = rng.uniform(0, world, (s, c)).astype(np.float32)
    r = (rng.uniform(40, 160, (s, c)) if var_r
         else np.full((s, c), 100.0)).astype(np.float32)
    act = np.ones((s, c), bool)
    act[:, c - c // 8:] = False  # inactive tail
    if swap:
        n = max(1, int(c * swap))
        for si in range(s):
            a = rng.integers(0, c, n)
            b = rng.integers(0, c, n)
            x[si, a], x[si, b] = x[si, b].copy(), x[si, a].copy()
    return x, z, r, act


def hotspot_layout(s, c, seed):
    rng = np.random.default_rng(seed)
    hot = rng.random((s, c)) < 0.9
    x = np.where(hot, rng.uniform(1400, 1600, (s, c)),
                 rng.uniform(0, 3000, (s, c))).astype(np.float32)
    z = np.where(hot, rng.uniform(1400, 1600, (s, c)),
                 rng.uniform(0, 3000, (s, c))).astype(np.float32)
    act = rng.random((s, c)) < 0.9
    xs, zs, rs, acts, _ = TG.sort_spaces(*_t(
        x, z, np.full((s, c), 100, np.float32), act))
    return tuple(a.numpy() for a in (xs, zs, rs, acts))


LAYOUTS = ["sorted", "nearly-sorted", "hotspot", "tie-lattice"]


def layout(name, s, c, seed):
    if name == "sorted":
        return sorted_layout(s, c, seed)
    if name == "nearly-sorted":
        return sorted_layout(s, c, seed, swap=0.01)
    if name == "hotspot":
        return hotspot_layout(s, c, seed)
    x, z, r, act = sorted_layout(s, c, seed, var_r=False)
    return (np.round(x / 50) * 50).astype(np.float32), \
        (np.round(z / 50) * 50).astype(np.float32), \
        np.full((s, c), 50, np.float32), act


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("s,c", [(1, 512), (2, 1024)])
def test_plain_culled_words_match_jax(name, s, c):
    x, z, r, act = layout(name, s, c, seed=s * 10 + c)
    want, want_frac = JG.aoi_words_culled(
        *map(jnp.asarray, (x, z, r, act)), col_words=CW, interpret=True)
    got, frac = TG.aoi_words_culled(*_t(x, z, r, act), col_words=CW)
    np.testing.assert_array_equal(TP.words_to_numpy(got), np.asarray(want))
    assert float(frac) == float(want_frac)
    assert float(frac) > 0.2  # the layouts are sorted enough to cull


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("br", [128, 512])
def test_plain_culled_step_matches_jax(name, br):
    s, c = 2, 1024
    x, z, r, act = layout(name, s, c, seed=br + len(name))
    rng = np.random.default_rng(br)
    prev = rng.integers(0, 2**32, (s, c, c // 32), dtype=np.uint64)
    prev = prev.astype(np.uint32)
    new_j, chg_j, frac_j = JG.aoi_step_culled(
        *map(jnp.asarray, (x, z, r, act, prev)), block_rows=br,
        col_words=CW, interpret=True)
    new_t, chg_t, frac_t = TG.aoi_step_culled(
        *_t(x, z, r, act), TP.words_to_torch(prev, "cpu"), block_rows=br,
        col_words=CW)
    np.testing.assert_array_equal(TP.words_to_numpy(new_t), np.asarray(new_j))
    np.testing.assert_array_equal(TP.words_to_numpy(chg_t), np.asarray(chg_j))
    assert float(frac_t) == float(frac_j)


@pytest.mark.parametrize("br,cw", [(128, 32), (256, 8), (512, 0), (100, 16)])
def test_cull_table_matches_jax_on_finite_inputs(br, cw):
    s, c = 2, 1024
    x, z, r, act = sorted_layout(s, c, seed=br + cw, swap=0.02)
    ti, wb = TG.legal_blocks(c, br, cw)
    assert (ti, wb, True) == JG._legal_blocks(c, c // 32, br, cw, True)
    xj, rj, aj = map(jnp.asarray, (x, r, act))
    need_j, frac_j = J_CULL(
        xj, rj, aj, jnp.where(aj, xj, jnp.inf), jnp.where(aj, rj, -1.0),
        s=s, c=c, ti=ti, wb=wb)
    need_t, frac_t = TG.cull_table(*_t(x, r, act), br, cw)
    assert need_t.dtype == torch.int32
    np.testing.assert_array_equal(need_t.numpy(), np.asarray(need_j))
    assert float(frac_t) == float(frac_j)


def test_nan_radius_culls_everything_in_jax_but_not_in_the_port():
    """One active slot with r = NaN among x-sorted uniform positions: the
    JAX culled kernel returns no bits and culled_frac 1.0, while its dense
    words have hundreds; the port equals the dense words, and without the
    NaN all three agree."""
    s, c = 1, 512
    rng = np.random.default_rng(2024)
    x = np.sort(rng.uniform(0, 4000, (s, c)), axis=1).astype(np.float32)
    z = rng.uniform(0, 4000, (s, c)).astype(np.float32)
    r = np.full((s, c), 100, np.float32)
    act = np.ones((s, c), bool)
    clean_t, _ = TG.aoi_words_culled(*_t(x, z, r, act), col_words=CW)
    clean_j, _ = JG.aoi_words_culled(
        *map(jnp.asarray, (x, z, r, act)), col_words=CW, interpret=True)
    np.testing.assert_array_equal(TP.words_to_numpy(clean_t),
                                  np.asarray(clean_j))
    r[0, 200] = np.nan
    args = list(map(jnp.asarray, (x, z, r, act)))
    culled_j, frac_j = JG.aoi_words_culled(*args, col_words=CW,
                                           interpret=True)
    dense_j, _ = JD.aoi_step_chg_dense(
        *[a[None] if a.ndim == 1 else a for a in args],
        jnp.zeros((s, c, c // 32), jnp.uint32))
    bits = int(np.unpackbits(np.asarray(dense_j).view(np.uint8)).sum())
    assert int(np.asarray(culled_j).sum()) == 0 and float(frac_j) == 1.0
    assert 400 < bits < int(np.unpackbits(
        np.asarray(clean_j).view(np.uint8)).sum())
    got, frac = TG.aoi_words_culled(*_t(x, z, r, act), col_words=CW)
    np.testing.assert_array_equal(TP.words_to_numpy(got), np.asarray(dense_j))
    assert float(frac) > 0.5


@pytest.mark.parametrize("case", ["nan-radius", "inf-radius", "nan-x",
                                  "inf-positions"])
def test_non_finite_inputs_equal_jax_dense_words(case):
    s, c = 2, 1024
    x, z, r, act = sorted_layout(s, c, seed=len(case), swap=0.01)
    if case == "nan-radius":
        r[:, 300] = np.nan
        r[1, 5] = np.nan
    elif case == "inf-radius":
        r[0, 700] = np.inf
        r[1, 0] = np.inf
        x[1, 1000] = np.inf  # an infinite position only r = +inf reaches
    elif case == "nan-x":
        x[:, 400] = np.nan
        z[0, 401] = np.nan
    else:
        x[0, 10], x[0, 11], z[1, 12] = np.inf, -np.inf, np.inf
        r[0, 11] = np.inf
    rng = np.random.default_rng(1)
    prev = rng.integers(0, 2**32, (s, c, c // 32), dtype=np.uint64)
    prev = prev.astype(np.uint32)
    new_j, chg_j = JD.aoi_step_chg_dense(
        *map(jnp.asarray, (x, z, r, act, prev)))
    new_t, chg_t, frac = TG.aoi_step_culled(
        *_t(x, z, r, act), TP.words_to_torch(prev, "cpu"), block_rows=128,
        col_words=CW)
    np.testing.assert_array_equal(TP.words_to_numpy(new_t), np.asarray(new_j))
    np.testing.assert_array_equal(TP.words_to_numpy(chg_t), np.asarray(chg_j))
    assert 0.3 < float(frac) < 1.0  # still culls; never everything
    words, _ = TG.aoi_words_culled(*_t(x, z, r, act), col_words=CW)
    np.testing.assert_array_equal(TP.words_to_numpy(words), np.asarray(new_j))


def test_cull_table_only_admits_on_non_finite_inputs():
    """Every pair the dense words hold lies in a block the table needs."""
    s, c, br = 1, 1024, 128
    x, z, r, act = sorted_layout(s, c, seed=5)
    r[0, 130] = np.nan
    r[0, 600] = np.inf
    x[0, 900] = np.nan
    need, _ = TG.cull_table(*_t(x, r, act), br, CW)
    words = TG.aoi_words_culled_plain(*_t(x, z, r, act))[0]
    m = TP.unpack_rows(TP.words_to_numpy(words)[0], c)
    ti, wb = TG.legal_blocks(c, br, CW)
    w = c // 32
    i, j = np.nonzero(m)
    k, word = j // w, j % w
    assert need.numpy()[0, i // ti, word // wb, k].all()
    assert need.numpy()[0, 600 // ti].all()  # the +inf radius's block


def test_sort_spaces_matches_jax_permutation():
    """The permutation equals jnp.argsort's on ties among inactive slots,
    +-0.0, NaN and +inf keys (the words are compared index for index in
    sorted space)."""
    rng = np.random.default_rng(3)
    s, c = 3, 256
    x = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, 2.5, np.nan, np.inf,
                             -np.inf], np.float32), (s, c))
    x[2] = rng.uniform(-5, 5, c).astype(np.float32)
    z = rng.uniform(0, 10, (s, c)).astype(np.float32)
    r = rng.uniform(0, 3, (s, c)).astype(np.float32)
    act = rng.random((s, c)) < 0.7
    want = JG.sort_spaces(*map(jnp.asarray, (x, z, r, act)))
    got = TG.sort_spaces(*_t(x, z, r, act))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_resort_and_entries_on_the_cpu_launch_nothing():
    s, c = 2, 512
    x, z, r, act = sorted_layout(s, c, seed=9)
    rng = np.random.default_rng(0)
    perm = rng.permuted(np.tile(np.arange(c), (s, 1)), axis=1)
    xu, zu, ru, au = (np.take_along_axis(a, perm, axis=1)
                      for a in (x, z, r, act))
    TG.reset_launches()
    p, sx, sz, rs, acts, words = TG.resort(*_t(xu, zu, ru, au))
    np.testing.assert_array_equal(sx.numpy(), np.take_along_axis(
        xu, p.numpy(), axis=1))
    dense = TG.aoi_words_culled_plain(sx, sz, rs, acts)[0]
    assert torch.equal(words, dense)
    assert TG.launches == {"aoi_words_culled": 0, "aoi_step_culled": 0}
    with pytest.raises(ValueError):
        TG.aoi_words_culled_cuda(*_t(x, z, r, act))
    with pytest.raises(ValueError):
        TG.aoi_step_culled(*_t(x, z, r, act), words[:, :5])


# -- the persistent culled kernels' launch plan (pure Python) ----------------


CULLED_PLAN_SHAPES = [  # (S, C, SMs, blocks per SM)
    (64, 16384, 132, 4),   # `million`
    (1, 131072, 132, 4),   # `zipf100k`
    (2, 1056, 132, 4),     # W = 33, C % 64 = 32
    (1, 4160, 132, 4),     # W = 130
    (40, 128, 2, 2),       # S larger than the grid
    (1, 32, 132, 4),       # one word per row
]


@pytest.mark.parametrize("s,c,n_sms,bps", CULLED_PLAN_SHAPES)
def test_culled_plan_covers_every_tile_once(s, c, n_sms, bps):
    """Every (space, 64-row tile, 32-word group) once, walked block by
    block as the kernels do; the cull counter's denominator (tiles x 32
    planes) is those tiles."""
    plan = TG.culled_plan(s, c, n_sms, bps)
    seen = covered_tiles(plan, s)
    w = c // 32
    want = {(sp, t, g) for sp in range(s) for t in range(-(-c // 64))
            for g in range(-(-w // 32))}
    assert len(seen) == len(want) and set(seen) == want


@pytest.mark.parametrize("s,c,n_sms,bps", CULLED_PLAN_SHAPES)
def test_culled_plan_grid_within_the_resident_limit(s, c, n_sms, bps):
    plan = TG.culled_plan(s, c, n_sms, bps)
    assert 1 <= plan.grid <= min(n_sms * bps, plan.units)
    assert plan.units >= min(8 * n_sms * bps,
                             s * plan.row_tiles * plan.groups)


@pytest.mark.parametrize("args", [(1, 100, 132, 4), (0, 128, 132, 4),
                                  (1, 128, 0, 4), (1, 128, 132, 0)])
def test_culled_plan_refuses_what_the_kernels_refuse(args):
    with pytest.raises(ValueError, match="plan"):
        TG.culled_plan(*args)


def test_plain_culled_step_at_a_ragged_width():
    """C = 1056 (W = 33: a ragged word group, and 32 rows past the last
    full 64-row tile): the plain culled step equals the JAX package's
    numpy predicate (its packing takes only multiples of 128 columns, so
    the port's packs it)."""
    s, c = 2, 1056
    x, z, r, act = sorted_layout(s, c, seed=12, swap=0.01)
    r[:, 7], r[:, 500] = np.nan, np.inf
    prev = np.random.default_rng(1).integers(
        0, 2**32, (s, c, c // 32), dtype=np.uint64).astype(np.uint32)
    new, chg, frac = TG.aoi_step_culled(*_t(x, z, r, act),
                                        TP.words_to_torch(prev, "cpu"))
    with np.errstate(invalid="ignore"):
        for sp in range(s):
            want = TP.pack_rows(JP.interest_matrix(x[sp], z[sp], r[sp],
                                                   act[sp]))
            np.testing.assert_array_equal(TP.words_to_numpy(new)[sp], want)
            np.testing.assert_array_equal(TP.words_to_numpy(chg)[sp],
                                          want ^ prev[sp])
    assert 0.0 <= float(frac) < 1.0
