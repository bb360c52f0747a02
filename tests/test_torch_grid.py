"""The port's block-culled AOI words and step (goworld_tpu_torch.ops.aoi_grid,
plain versions -- what the CPU runs and what csrc/aoi_grid.cu is held to on
the card) against the JAX package's ops/aoi_grid: the Pallas kernels in
interpret mode at col_words=32, as tests/test_aoi_grid.py runs them, and
the JAX cull table.  Tolerance: exact equality (IEEE compares and integer
packing; the culled fraction is a mean of 0/1 flags, exact in f32).

Non-finite radii are held to the JAX package's DENSE words: its cull
table's margin is max(radius) over all slots, so one NaN radius culls
every block and its culled words come out empty (pinned below)."""

from fractions import Fraction

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
    assert float(frac) == float(TG.vote_fraction(*_t(x, r, act)))
    _, table_frac = TG.cull_table(*_t(x, r, act), 128, CW)
    assert float(table_frac) == float(want_frac)
    assert float(table_frac) > 0.2  # the layouts are sorted enough to cull


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
    assert float(frac_t) == float(TG.vote_fraction(*_t(x, r, act)))
    _, table_frac = TG.cull_table(*_t(x, r, act), br, CW)
    assert float(table_frac) == float(frac_j)


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


NON_FINITE = ["nan-radius", "inf-radius", "nan-x", "inf-positions"]


def non_finite_layout(case, s=2, c=1024):
    """A nearly sorted layout with the non-finite inputs of ``case``."""
    x, z, r, act = sorted_layout(s, c, seed=len(case), swap=0.01)
    if case == "nan-radius":
        r[:, 300] = np.nan
        r[1, 5] = np.nan
    elif case == "inf-radius":
        r[0, 700] = np.inf
        r[1, 0] = np.inf
        x[1, 1000 * c // 1024] = np.inf  # only r = +inf reaches it
    elif case == "nan-x":
        x[:, 400] = np.nan
        z[0, 401] = np.nan
    else:
        x[0, 10], x[0, 11], z[1, 12] = np.inf, -np.inf, np.inf
        r[0, 11] = np.inf
    return x, z, r, act


@pytest.mark.parametrize("case", NON_FINITE)
def test_non_finite_inputs_equal_jax_dense_words(case):
    s, c = 2, 1024
    x, z, r, act = non_finite_layout(case, s, c)
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


# -- the words kernel: its launch plan and its vote (plain versions) ----------


@pytest.mark.parametrize("s,c,n_sms,bps", CULLED_PLAN_SHAPES)
def test_words_plan_covers_every_tile_once_in_short_units(s, c, n_sms, bps):
    """The words kernel stages a unit's rows in shared memory, so its
    units hold at most WORDS_UNIT_TILES row tiles; they still cover every
    (space, row tile, word group) once, and where the step's units are
    that short already the plans are the same."""
    plan = TG.words_plan(s, c, n_sms, bps)
    assert 1 <= plan.tiles <= TG.WORDS_UNIT_TILES
    assert 1 <= plan.grid <= min(n_sms * bps, plan.units)
    seen = covered_tiles(plan, s)
    want = {(sp, t, g) for sp in range(s) for t in range(-(-c // 64))
            for g in range(-(-(c // 32) // 32))}
    assert len(seen) == len(want) and set(seen) == want
    step = TG.culled_plan(s, c, n_sms, bps)
    assert (plan == step) == (step.tiles <= TG.WORDS_UNIT_TILES)


@pytest.mark.parametrize("args,kw", [
    ((1, 100, 132, 4), {}), ((0, 128, 132, 4), {}), ((1, 128, 0, 4), {}),
    ((1, 128, 132, 0), {}), ((1, 128, 132, 4), {"max_tiles": 0})])
def test_words_plan_refuses_what_the_kernel_refuses(args, kw):
    with pytest.raises(ValueError, match="plan"):
        if kw:
            TG.culled_plan(*args, **kw)
        else:
            TG.words_plan(*args)


def _round_f32(q):
    """The float32 nearest the rational ``q`` (ties to even)."""
    v = np.float32(float(q))
    best = None
    for cand in (np.nextafter(v, np.float32(-np.inf)), v,
                 np.nextafter(v, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - q)
        key = (d, int(np.array(cand).view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def numpy_votes(x, r, act):
    """The kernels' vote, one tile and group at a time: ``need[s, t, g]``
    with bit k set where plane k is tested."""
    s, c = x.shape
    w = c // 32
    f32 = np.float32
    b, a = Fraction(float(f32(1e-5))), Fraction(float(f32(1e-3)))
    need = np.zeros((s, -(-c // 64), -(-w // 32)), np.int64)
    with np.errstate(invalid="ignore", over="ignore"):
        for sp in range(s):
            for t in range(need.shape[1]):
                lo, hi, mag, every = f32(np.inf), f32(-np.inf), f32(0), False
                for i in range(64 * t, min(64 * t + 64, c)):
                    xi, ri = x[sp, i], r[sp, i]
                    every |= bool(act[sp, i] and ri == np.inf)
                    if act[sp, i] and np.isfinite(xi) and np.isfinite(ri):
                        lo = min(lo, f32(xi - ri))
                        hi = max(hi, f32(xi + ri))
                        mag = max(mag, f32(abs(xi) + abs(ri)))
                m = _round_f32(Fraction(float(mag)) * b + a)
                for g in range(need.shape[2]):
                    for k in range(32):
                        j = k * w + np.arange(32 * g, min(32 * g + 32, w))
                        on = act[sp, j] & np.isfinite(x[sp, j])
                        if every or (on.any() and
                                     x[sp, j][on].min() <= f32(hi + m) and
                                     x[sp, j][on].max() >= f32(lo - m)):
                            need[sp, t, g] |= 1 << k
    return need


VOTE_CASES = [("sorted", 1024), ("nearly-sorted", 1024), ("hotspot", 1024),
              ("tie-lattice", 1024), ("nearly-sorted", 1056)] + \
    [(case, 1024) for case in NON_FINITE]


def vote_layout(name, c):
    if name in NON_FINITE:
        return non_finite_layout(name, 2, c)
    return layout(name, 2, c, seed=c + len(name))


@pytest.mark.parametrize("name,c", VOTE_CASES)
def test_tile_votes_match_a_numpy_loop(name, c):
    """tile_votes (what the kernels' culled count is held to on the card)
    against a loop over tiles, groups and planes; the margin rounded once
    from its exact value."""
    x, z, r, act = vote_layout(name, c)
    got = TG.tile_votes(*_t(x, r, act))
    np.testing.assert_array_equal(got.numpy(), numpy_votes(x, r, act))
    assert 0 < int(got.ne(0xFFFFFFFF).sum())  # some tile culls a plane


@pytest.mark.parametrize("name,c", VOTE_CASES)
def test_tile_votes_only_admit(name, c):
    """Every bit of the JAX package's dense words lies in a (64-row tile,
    32-word group, plane) the kernels' vote admits, and a tile holding an
    active +inf radius admits every plane."""
    x, z, r, act = vote_layout(name, c)
    need = TG.tile_votes(*_t(x, r, act)).numpy()
    s, w = x.shape[0], c // 32
    if c % 128 == 0:
        dense, _ = JD.aoi_step_chg_dense(*map(jnp.asarray, (x, z, r, act)),
                                         jnp.zeros((s, c, w), jnp.uint32))
        pairs = [TP.unpack_rows(np.asarray(dense)[sp], c) for sp in range(s)]
    else:  # its packing takes multiples of 128 columns: its numpy predicate
        with np.errstate(invalid="ignore"):
            pairs = [JP.interest_matrix(x[sp], z[sp], r[sp], act[sp])
                     for sp in range(s)]
    for sp in range(s):
        i, j = np.nonzero(pairs[sp])
        assert i.size > 0
        k, word = j // w, j % w
        assert ((need[sp, i // 64, word // 32] >> k) & 1).all()
        for t in np.unique(np.nonzero(act[sp] & (r[sp] == np.inf))[0] // 64):
            assert (need[sp, t] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("name,c", VOTE_CASES + [("tiny", 32)])
def test_entry_fraction_is_the_votes_on_the_cpu(name, c):
    """The entries' culled_frac on CPU tensors is the kernels' fraction:
    the share of (tile, group, plane) steps the numpy vote loop skips,
    rounded once to float32 -- the same number the CUDA wrappers report,
    not the JAX package's table fraction."""
    if name == "tiny":  # one partial tile and group, half the slots off
        x, z, r, act = (a[:, :c].copy() for a in sorted_layout(2, 1024, 3))
        act[:, ::2] = False
    else:
        x, z, r, act = vote_layout(name, c)
    votes = numpy_votes(x, r, act)
    n = votes.size * 32
    kept = int(np.unpackbits(votes.astype(np.uint32).view(np.uint8)).sum())
    want = np.float32((n - kept) / n)
    prev = TP.words_to_torch(np.zeros((x.shape[0], c, c // 32), np.uint32),
                             "cpu")
    _, wf = TG.aoi_words_culled(*_t(x, z, r, act))
    _, _, sf = TG.aoi_step_culled(*_t(x, z, r, act), prev)
    assert wf.dtype == sf.dtype == torch.float32
    assert float(wf) == float(sf) == float(want)
