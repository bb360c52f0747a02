"""The port's plain AOI step (goworld_tpu_torch.ops.aoi_dense, what the CPU
runs and what the CUDA kernel is held to on the card) against the JAX
package: the Pallas kernel in interpret mode and the dense XLA step.
Tolerance: exact equality -- the predicate is IEEE sub/abs/compare in f32
and packing is integer, so no rounding or summation order is involved.

One known divergence is pinned separately: XLA's CPU backend flushes
subnormals to zero, so on subnormal inputs the JAX functions run on the
CPU disagree with the IEEE predicate; there the port is held to the JAX
package's own numpy reference (``aoi_predicate.interest_matrix``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from goworld_tpu.ops import aoi_dense as JD
from goworld_tpu.ops import aoi_predicate as JP
from goworld_tpu.ops.aoi_pallas import aoi_step_pallas
from goworld_tpu_torch.ops import aoi_cuda as AK
from goworld_tpu_torch.ops import aoi_predicate as TP
from test_aoi_parity import random_walk_scenario
from torch_threads import one_intra_op_thread  # noqa: F401


def edge_inputs(s, c, seed, subnormal=False, inf_radius=False):
    """[S, C] numpy inputs with the predicate's edge cases: a tie lattice,
    -0.0, NaN, +-inf positions, r = 0, partially active rows, and prev
    words with bit 31 set; optionally subnormal gaps under r = 0 and
    r = +inf observers."""
    rng = np.random.default_rng(seed)
    w = c // 32
    x = (np.round(rng.uniform(0, 200, (s, c)) * 4) / 4).astype(np.float32)
    z = (np.round(rng.uniform(0, 200, (s, c)) * 4) / 4).astype(np.float32)
    r = rng.choice([0.0, 10.0, 25.0, 50.0], (s, c)).astype(np.float32)
    act = rng.random((s, c)) < 0.8
    n = min(c, 64)
    x[:, :n:8] = 0.0
    x[:, 1:n:8] = -0.0
    z[:, :n:4] = 0.0
    r[:, :n:2] = 0.0
    x[:, 4:n:8] = np.nan
    z[:, 5:n:8] = np.inf
    x[:, 6:n:8] = -np.inf
    r[:, 15:n:16] = np.nan
    if subnormal:
        x[:, 2:n:8] = np.float32(1e-40)
        x[:, 3:n:8] = np.float32(-3e-45)
        z[:, 2:n:8] = z[:, 3:n:8] = 0.0
        act[:, :8] = True
    if inf_radius:
        r[:, 7:n:16] = np.inf
    prev = rng.integers(0, 2**32, (s, c, w), dtype=np.uint64)
    prev = prev.astype(np.uint32)
    prev[:, :, 0] |= np.uint32(1 << 31)
    return x, z, r, act, prev


def port_step(x, z, r, act, prev):
    t = [torch.from_numpy(a) for a in (x, z, r, act)]
    new, chg = AK.aoi_step_chg(*t, TP.words_to_torch(prev, "cpu"))
    return TP.words_to_numpy(new), TP.words_to_numpy(chg)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("c", [128, 256, 384])
def test_plain_step_matches_pallas_interpret(s, c):
    """Port vs the JAX Pallas kernel (interpret mode, emit="chg"), with the
    edge inputs it shares with the IEEE predicate (its +inf folding
    diverges from the masks for r = +inf, so no +inf radius here)."""
    x, z, r, act, prev = edge_inputs(s, c, seed=s * 1000 + c)
    new_j, chg_j = aoi_step_pallas(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(r), jnp.asarray(act),
        jnp.asarray(prev), emit="chg", interpret=True)
    new_t, chg_t = port_step(x, z, r, act, prev)
    np.testing.assert_array_equal(new_t, np.asarray(new_j))
    np.testing.assert_array_equal(chg_t, np.asarray(chg_j))


@pytest.mark.parametrize("c", [1024, 4096])
def test_plain_step_matches_jax_dense(c):
    """Port vs the JAX dense step at larger capacities, +inf radii and a
    seeded random walk's second tick included."""
    x, z, r, act, prev = edge_inputs(2, c, seed=c, inf_radius=True)
    new_j, chg_j = JD.aoi_step_chg_dense(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(r), jnp.asarray(act),
        jnp.asarray(prev))
    new_t, chg_t = port_step(x, z, r, act, prev)
    np.testing.assert_array_equal(new_t, np.asarray(new_j))
    np.testing.assert_array_equal(chg_t, np.asarray(chg_j))
    walk = list(random_walk_scenario(c, c, c - 100, 2, tie_lattice=True))
    prev = np.asarray(new_j)[:1]
    x, z, r, act = (a[None] for a in walk[1])
    new_j, chg_j = JD.aoi_step_chg_dense(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(r), jnp.asarray(act),
        jnp.asarray(prev))
    new_t, chg_t = port_step(x, z, r, act, prev)
    np.testing.assert_array_equal(new_t, np.asarray(new_j))
    np.testing.assert_array_equal(chg_t, np.asarray(chg_j))


@pytest.mark.parametrize("c", [128, 384])
def test_plain_step_subnormals_follow_ieee(c):
    """r = 0 with subnormal gaps: the port keeps IEEE subnormals, exactly
    as the JAX package's numpy predicate does (|1e-40 - 0| <= 0 is
    false)."""
    x, z, r, act, prev = edge_inputs(2, c, seed=7 + c, subnormal=True,
                                     inf_radius=True)
    new_t, chg_t = port_step(x, z, r, act, prev)
    with np.errstate(invalid="ignore"):  # inf - inf is NaN, as intended
        for s in range(2):
            want = JP.pack_rows(JP.interest_matrix(x[s], z[s], r[s], act[s]))
            np.testing.assert_array_equal(new_t[s], want)
            np.testing.assert_array_equal(chg_t[s], want ^ prev[s])
        # the case is live: flushing the subnormals to zero changes it
        tiny = np.finfo(np.float32).tiny
        xf = np.where(np.abs(x) < tiny, np.float32(0), x)
        flushed = JP.pack_rows(JP.interest_matrix(xf[0], z[0], r[0], act[0]))
    assert not np.array_equal(flushed, new_t[0])


def test_word_carry_roundtrip_and_layout_helpers():
    """words_to_torch / words_to_numpy keep every bit (bit 31 included)
    and never alias; the layout helpers equal the JAX package's."""
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, (5, 12), dtype=np.uint64).astype(np.uint32)
    t = TP.words_to_torch(w, "cpu")
    assert t.dtype == torch.int32
    back = TP.words_to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, w)
    t[0, 0] = 0
    assert back[0, 0] == w[0, 0]
    m = rng.random((384, 384)) < 0.1
    np.testing.assert_array_equal(TP.pack_rows(m), JP.pack_rows(m))
    words = JP.pack_rows(m)
    np.testing.assert_array_equal(TP.unpack_rows(words, 384), m)
    np.testing.assert_array_equal(TP.pairs_from_words(words, 384),
                                  JP.pairs_from_words(words, 384))
    for cap in (128, 256):
        mm = rng.random((cap, cap)) < 0.05
        np.testing.assert_array_equal(
            TP.repack_columns_double(JP.pack_rows(mm), cap),
            JP.repack_columns_double(JP.pack_rows(mm), cap))
    for n in (1, 128, 129, 1000):
        assert TP.round_capacity(n) == JP.round_capacity(n)
    assert TP.word_bit_for_column(77, 384) == JP.word_bit_for_column(77, 384)


@pytest.mark.parametrize("cap", [128, 384, 1024])
def test_pairs_from_sparse_matches_dense_expansion(cap):
    """pairs_from_sparse over (row, word) positions given in any order
    equals the JAX package's pairs_from_words over the dense plane that
    holds the same words (zero, all-ones and bit-31 words included)."""
    rng = np.random.default_rng(cap)
    w = cap // 32
    dense = np.zeros((cap, w), np.uint32)
    flat = rng.choice(cap * w, size=cap * w // 3, replace=False)
    vals = rng.integers(0, 2**32, flat.size, dtype=np.uint64) \
        .astype(np.uint32)
    vals[::7] = 0
    vals[1::7] = 0xFFFFFFFF
    vals[2::7] = 0x80000000
    rows, ws = flat // w, flat % w
    dense[rows, ws] = vals
    got = TP.pairs_from_sparse(rows, ws, vals, cap)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, JP.pairs_from_words(dense, cap))


def test_cpu_step_launches_no_kernel_and_checks_inputs():
    AK.reset_launches()
    x, z, r, act, prev = edge_inputs(1, 128, seed=1)
    port_step(x, z, r, act, prev)
    assert AK.launches["aoi_step"] == 0
    t = [torch.from_numpy(a) for a in (x, z, r, act)]
    with pytest.raises(ValueError):
        AK.aoi_step_chg(t[0].double(), *t[1:],
                        TP.words_to_torch(prev, "cpu"))
    with pytest.raises(ValueError):
        AK.aoi_step_chg_cuda(*t, TP.words_to_torch(prev, "cpu"))


@pytest.mark.parametrize("c", [128, 256])
def test_plain_row_masks_match_jax_dense(c):
    """The fused tick's row masks (``stg`` / ``sub``): a staged space's new
    words are the JAX dense step's, an unstaged space keeps prev, and chg
    is the JAX step's only where the space is staged and subscribed; the
    entry refuses masks of the wrong dtype, length or device."""
    x, z, r, act, prev = edge_inputs(4, c, seed=c + 7)
    new_j, chg_j = (np.asarray(a) for a in JD.aoi_step_chg_dense(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(r), jnp.asarray(act),
        jnp.asarray(prev)))
    stg = np.array([1, 0, 1, 0], np.int32)
    sub = np.array([1, 1, 0, 0], np.int32)
    t = [torch.from_numpy(a) for a in (x, z, r, act)]
    new, chg = AK.aoi_step_chg(*t, TP.words_to_torch(prev, "cpu"),
                               stg=torch.from_numpy(stg),
                               sub=torch.from_numpy(sub))
    new, chg = TP.words_to_numpy(new), TP.words_to_numpy(chg)
    keep = stg.astype(bool)[:, None, None]
    np.testing.assert_array_equal(new, np.where(keep, new_j, prev))
    emit = (stg & sub).astype(bool)[:, None, None]
    np.testing.assert_array_equal(chg, np.where(emit, chg_j, 0))
    for bad in (torch.ones(4, dtype=torch.int64),
                torch.ones(3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="stg"):
            AK.aoi_step_chg(*t, TP.words_to_torch(prev, "cpu"), stg=bad)


def rect_inputs(s, c_rows, c_cols, row0, seed, inf_radius=False):
    """Rectangular operands: the candidates are a whole edge-case space
    of ``c_cols`` slots, the rows its block ``[row0, row0 + c_rows)``
    (their global ids offset into the middle), prev [S, c_rows, W]."""
    x, z, r, act, _ = edge_inputs(s, c_cols, seed, inf_radius=inf_radius)
    rng = np.random.default_rng(seed + 1)
    b = slice(row0, row0 + c_rows)
    rid = np.broadcast_to(np.arange(row0, row0 + c_rows, dtype=np.int32),
                          (s, c_rows)).copy()
    prev = rng.integers(0, 2**32, (s, c_rows, c_cols // 32),
                        dtype=np.uint64).astype(np.uint32)
    prev[:, :, -1] |= np.uint32(1 << 31)
    rows = tuple(np.ascontiguousarray(a[:, b]) for a in (x, z, r, act))
    return rows, (x, z, act), rid, prev


def port_rect(rows, cols, rid, prev):
    new, chg = AK.aoi_step_chg(
        *(torch.from_numpy(a) for a in rows), TP.words_to_torch(prev, "cpu"),
        cols=tuple(torch.from_numpy(a) for a in cols),
        row_ids=torch.from_numpy(rid))
    return TP.words_to_numpy(new), TP.words_to_numpy(chg)


@pytest.mark.parametrize("s,c_rows,c_cols,row0", [
    (1, 128, 384, 128), (2, 96, 256, 70), (3, 256, 512, 200)])
def test_plain_rect_step_matches_pallas_interpret(s, c_rows, c_cols, row0):
    """Rectangular mode (a block of observer rows against every
    candidate, self-exclusion by global row id) vs the JAX Pallas kernel
    in interpret mode (no +inf radius: its folding diverges there)."""
    rows, cols, rid, prev = rect_inputs(s, c_rows, c_cols, row0,
                                        seed=c_rows + c_cols)
    new_j, chg_j = aoi_step_pallas(
        *map(jnp.asarray, rows), jnp.asarray(prev), emit="chg",
        cols=tuple(map(jnp.asarray, cols)), row_ids=jnp.asarray(rid),
        interpret=True)
    new_t, chg_t = port_rect(rows, cols, rid, prev)
    np.testing.assert_array_equal(new_t, np.asarray(new_j))
    np.testing.assert_array_equal(chg_t, np.asarray(chg_j))
    # the block's rows of the square step over the whole space are the
    # same words (self-exclusion by global id lands on the diagonal)
    x, z, r, act, _ = edge_inputs(s, c_cols, seed=c_rows + c_cols)
    sq_new, _ = port_step(x, z, r, act,
                          np.zeros((s, c_cols, c_cols // 32), np.uint32))
    np.testing.assert_array_equal(new_t, sq_new[:, row0:row0 + c_rows])


@pytest.mark.parametrize("c_cols", [1024, 4096])
def test_plain_rect_step_matches_jax_dense(c_cols):
    """Rectangular mode vs the JAX dense step at larger widths, +inf
    radii and out-of-range row ids (which exclude nothing) included."""
    s, c_rows, row0 = 2, 320, c_cols // 2 - 100
    rows, cols, rid, prev = rect_inputs(s, c_rows, c_cols, row0,
                                        seed=c_cols, inf_radius=True)
    rid[1, :3] = [-1, c_cols, c_cols + 5]
    new_j, chg_j = JD.aoi_step_chg_dense(
        *map(jnp.asarray, rows), jnp.asarray(prev),
        cols=tuple(map(jnp.asarray, cols)), row_ids=jnp.asarray(rid))
    new_t, chg_t = port_rect(rows, cols, rid, prev)
    np.testing.assert_array_equal(new_t, np.asarray(new_j))
    np.testing.assert_array_equal(chg_t, np.asarray(chg_j))


def test_rect_mode_checks_its_operands():
    rows, cols, rid, prev = rect_inputs(1, 128, 256, 64, seed=3)
    tr = [torch.from_numpy(a) for a in rows]
    tc = tuple(torch.from_numpy(a) for a in cols)
    tp = TP.words_to_torch(prev, "cpu")
    with pytest.raises(ValueError, match="row_ids"):
        AK.aoi_step_chg(*tr, tp, cols=tc)
    with pytest.raises(ValueError, match="row_ids"):
        AK.aoi_step_chg(*tr, tp, cols=tc,
                        row_ids=torch.from_numpy(rid).long())
    with pytest.raises(ValueError, match="prev_words"):
        AK.aoi_step_chg(*tr, tp[:, :, :4], cols=tc,
                        row_ids=torch.from_numpy(rid))
    with pytest.raises(ValueError, match="CUDA"):
        AK.aoi_step_chg_cuda(*tr, tp, cols=tc, row_ids=torch.from_numpy(rid))


# -- emit="entlv": new, enter = new & ~prev, leave = prev & ~new --------------


def port_entlv(x, z, r, act, prev, cols=None, row_ids=None):
    out = AK.aoi_step_entlv(
        *(torch.from_numpy(a) for a in (x, z, r, act)),
        TP.words_to_torch(prev, "cpu"),
        cols=None if cols is None else tuple(map(torch.from_numpy, cols)),
        row_ids=None if row_ids is None else torch.from_numpy(row_ids))
    return tuple(TP.words_to_numpy(t) for t in out)


def assert_entlv(got, want):
    for g, w, name in zip(got, want, ("new", "enter", "leave")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("s,c", [(1, 128), (3, 256), (2, 384), (1, 4096)])
def test_plain_entlv_matches_pallas_interpret(s, c):
    """The port's entlv step vs the JAX Pallas kernel in its default mode
    (interpret; C = 4096 reaches its slice-pack body, the others its MXU
    body), and its new words vs the chg mode's."""
    x, z, r, act, prev = edge_inputs(s, c, seed=50 + s * c)
    want = aoi_step_pallas(*map(jnp.asarray, (x, z, r, act, prev)),
                           interpret=True)
    got = port_entlv(x, z, r, act, prev)
    assert_entlv(got, want)
    new_c, _ = port_step(x, z, r, act, prev)
    np.testing.assert_array_equal(got[0], new_c)
    assert got[1].any() and got[2].any()


@pytest.mark.parametrize("s,c_rows,c_cols,row0", [
    (2, 96, 256, 70), (1, 128, 65536, 30000)])
def test_plain_rect_entlv_matches_pallas_interpret(s, c_rows, c_cols, row0):
    """Rectangular entlv vs the Pallas kernel (C_cols = 65536 reaches its
    plane-wise body)."""
    rows, cols, rid, prev = rect_inputs(s, c_rows, c_cols, row0,
                                        seed=c_rows + 7)
    want = aoi_step_pallas(*map(jnp.asarray, rows), jnp.asarray(prev),
                           cols=tuple(map(jnp.asarray, cols)),
                           row_ids=jnp.asarray(rid), interpret=True)
    assert_entlv(port_entlv(*rows, prev, cols=cols, row_ids=rid), want)


@pytest.mark.parametrize("c", [1024, 4096])
def test_plain_entlv_matches_jax_dense_batched(c):
    """The port's entlv step vs JAX ``aoi_step_dense_batched``, +inf radii
    included (the dense step masks activity, as the port does)."""
    x, z, r, act, prev = edge_inputs(2, c, seed=c + 3, inf_radius=True)
    want = JD.aoi_step_dense_batched(*map(jnp.asarray, (x, z, r, act, prev)))
    assert_entlv(port_entlv(x, z, r, act, prev), want)


@pytest.mark.parametrize("c", [128, 384])
def test_plain_entlv_subnormals_and_inf_radii_follow_ieee(c):
    """Subnormal gaps under r = 0 and r = +inf observers: held to the JAX
    package's numpy predicate (XLA's CPU backend flushes subnormals, and
    the Pallas folding sees inactive slots under r = +inf)."""
    x, z, r, act, prev = edge_inputs(2, c, seed=11 + c, subnormal=True,
                                     inf_radius=True)
    new, ent, lv = port_entlv(x, z, r, act, prev)
    with np.errstate(invalid="ignore"):  # inf - inf is NaN, as intended
        for s in range(2):
            want = JP.pack_rows(JP.interest_matrix(x[s], z[s], r[s], act[s]))
            np.testing.assert_array_equal(new[s], want)
            np.testing.assert_array_equal(ent[s], want & ~prev[s])
            np.testing.assert_array_equal(lv[s], prev[s] & ~want)


def test_entlv_entry_checks_and_counts():
    """The CPU path launches nothing; ``out=`` fills the caller's
    tensors; a CPU tensor at the kernel wrapper raises."""
    AK.reset_launches()
    x, z, r, act, prev = edge_inputs(1, 128, seed=2)
    t = [torch.from_numpy(a) for a in (x, z, r, act)]
    tp = TP.words_to_torch(prev, "cpu")
    out = tuple(torch.empty_like(tp) for _ in range(3))
    got = AK.aoi_step_entlv(*t, tp, out=out)
    assert all(g is o for g, o in zip(got, out))
    np.testing.assert_array_equal(TP.words_to_numpy(out[1]),
                                  port_entlv(x, z, r, act, prev)[1])
    assert AK.launches == {"aoi_step": 0, "aoi_step_entlv": 0}
    with pytest.raises(ValueError, match="out"):
        AK.aoi_step_entlv(*t, tp, out=out[:2])
    with pytest.raises(ValueError, match="CUDA"):
        AK.aoi_step_entlv_cuda(*t, tp)


# -- the persistent kernel's launch plan (pure Python, as the C entry takes it)


def unit_tiles(plan, u):
    """``(space, group, first row tile, end row tile)`` of unit ``u`` in
    the order StepPlan documents (the kernel's ``Cursor::enter``)."""
    g = u % plan.groups
    v = u // plan.groups
    t0 = (v % plan.runs) * plan.tiles
    return v // plan.runs, g, t0, min(t0 + plan.tiles, plan.row_tiles)


def covered_tiles(plan, s):
    """(space, row tile, word group) of every tile the plan's blocks walk,
    block by block as the kernel does (block b: units b, b + grid, ...)."""
    seen = []
    for b in range(plan.grid):
        for u in range(b, plan.units, plan.grid):
            sp, g, t0, t1 = unit_tiles(plan, u)
            assert 0 <= sp < s and 0 <= g < plan.groups and t0 < t1
            seen += [(sp, t, g) for t in range(t0, t1)]
    return seen


PLAN_SHAPES = [  # (S, R, W, SMs, blocks per SM)
    (1, 128, 4, 132, 3),       # tiny C: one unit, one tile
    (2, 1056, 33, 132, 3),     # ragged R (R % 64 = 32) and W (W % 32 = 1)
    (3, 96, 3, 2, 2),          # S larger than the grid
    (2, 100, 33, 1, 1),        # rect block, one resident block
    (1, 16384, 4096, 132, 3),  # zipfshare's block
    (8, 16384, 512, 132, 3),   # the engine path
    (64, 16384, 512, 132, 3),  # `million`
    (1, 131072, 4096, 132, 4),  # `zipf100k`, culled occupancy
    (5, 4160, 130, 7, 3),      # more units than tiles per group
]


@pytest.mark.parametrize("s,r,w,n_sms,bps", PLAN_SHAPES)
def test_step_plan_covers_every_tile_once(s, r, w, n_sms, bps):
    plan = AK.step_plan(s, r, w, n_sms, bps)
    seen = covered_tiles(plan, s)
    want = {(sp, t, g) for sp in range(s) for t in range(-(-r // 64))
            for g in range(-(-w // 32))}
    assert len(seen) == len(want) and set(seen) == want


@pytest.mark.parametrize("s,r,w,n_sms,bps", PLAN_SHAPES)
def test_step_plan_grid_within_the_resident_limit(s, r, w, n_sms, bps):
    """The grid never exceeds what fits at once, nor the units; the units
    number at least 8x the resident blocks where there are that many
    tiles, and the runs of a group differ by at most one unit's worth."""
    plan = AK.step_plan(s, r, w, n_sms, bps)
    resident = n_sms * bps
    assert 1 <= plan.grid <= min(resident, plan.units)
    total = s * plan.groups * plan.row_tiles
    assert plan.units >= min(AK.UNITS_PER_BLOCK * resident, total)
    lengths = {unit_tiles(plan, u)[3] - unit_tiles(plan, u)[2]
               for u in range(plan.units)}
    assert max(lengths) == plan.tiles and plan.tiles <= plan.row_tiles


@pytest.mark.parametrize("args", [
    (0, 128, 4, 132, 3), (1, 0, 4, 132, 3), (1, 128, 0, 132, 3),
    (1, (1 << 30) + 1, 4, 132, 3), (1, 128, (1 << 25) + 1, 132, 3),
    (1, 128, 4, 0, 3), (1, 128, 4, 132, 0), (1 << 31, 64, 32, 1, 1)])
def test_step_plan_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError, match="step_plan"):
        AK.step_plan(*args)


def test_step_at_ragged_widths_on_the_cpu():
    """C = 1056 (W = 33, R % 64 = 32) and a 100-row rect block: the step
    entries accept any multiple of 32 candidates (the kernel's rule);
    spaces keep the lane rule (check_capacity)."""
    x, z, r, act, prev = edge_inputs(2, 1056, seed=5)
    new, chg = port_step(x, z, r, act, prev)
    with np.errstate(invalid="ignore"):
        for s in range(2):
            # the JAX package packs only multiples of 128 columns
            want = TP.pack_rows(JP.interest_matrix(x[s], z[s], r[s], act[s]))
            np.testing.assert_array_equal(new[s], want)
            np.testing.assert_array_equal(chg[s], want ^ prev[s])
    rows, cols, rid, prev = rect_inputs(2, 100, 1056, 300, seed=9)
    new_r, _ = port_rect(rows, cols, rid, prev)
    sq, _ = port_step(*edge_inputs(2, 1056, seed=9)[:4],
                      np.zeros((2, 1056, 33), np.uint32))
    np.testing.assert_array_equal(new_r, sq[:, 300:400])
    with pytest.raises(ValueError, match="multiple of 128"):
        TP.check_capacity(1056)
    assert TP.check_capacity(1152) == 36
