"""The page allocator's hand-written kernel (goworld_tpu_torch/csrc/
pages.cu, bound in goworld_tpu_torch.ops.pages_cuda) as far as the CPU
reaches it: the launch plan as a pure function over the shapes the card
runs, the wrapper's checks (it raises before anything builds or
launches), the dispatch of ``ops/aoi_pages.allocate_pages`` (a CPU tensor
runs ``allocate_pages_plain`` and counts no launch), a numpy model of the
kernel's passes (the summary, the tiles' histograms and the boundary
class, the ranks from the earlier tiles, the write from the summary), and
the edge inputs that ``chip_smoke.py``
phase 3d holds the kernel to on the card, here held through the model and
the port's entry to the JAX package's ``paged_extract``.  Exact equality
throughout (integer work only)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from goworld_tpu.ops import aoi_pages as JPG
from goworld_tpu_torch.ops import aoi_pages as PG
from goworld_tpu_torch.ops import pages_cuda as PC
from goworld_tpu_torch.ops.aoi_predicate import words_per_row
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


@pytest.fixture
def no_kernel(monkeypatch):
    """Nothing may build or launch: the binding raises if reached, and the
    launch count stays 0."""
    def refuse():
        raise AssertionError("reached the CUDA library")

    monkeypatch.setattr(PC, "_fn", refuse)
    PC.reset_launches()
    yield
    assert PC.launches == {"allocate_pages": 0}


# -- the launch plan ----------------------------------------------------------

# (label, rows, C): the grids the card allocates over, rows of W = C / 32
# words -- phase 17 (phase 4's 8 x 16384), 17b's clustered crowd (1 x
# 2048), a shard of 17c's `million` on 4 virtual shards (16 x 16384) and of
# its `zipf100k` row-sharded on 8 (16384 rows of the 131072 candidates),
# phase 20b's cohort rungs (the 256 / 1024 / 4096 ladder, 64 spaces a
# rung) and 17d's space (1 x 8192)
PLAN_SHAPES = [("phase 17", 8 * 16384, 16384), ("17b", 2048, 2048),
               ("17c million shard", 16 * 16384, 16384),
               ("17c zipf100k shard", 16384, 131072),
               ("20b rung 256", 64 * 256, 256),
               ("20b rung 1024", 64 * 1024, 1024),
               ("20b rung 4096", 64 * 4096, 4096), ("17d", 8192, 8192)]


@pytest.mark.parametrize("label,rows,c", PLAN_SHAPES,
                         ids=[p[0] for p in PLAN_SHAPES])
def test_launch_plan_covers_the_path_shapes(label, rows, c):
    w = words_per_row(c)
    nw, bw = rows * w, PG.bin_words_for(w)
    n_pages = PG.pool_floor(nw)
    plan = PC.pages_plan(nw, n_pages, bw, PG.MAX_SPILL)
    assert plan.n_bins == -(-nw // bw) and plan.n_bins * bw == nw
    assert plan.n_classes == bw // PC.PAGE_WORDS + 1 <= PC.MAX_CLASSES
    assert plan.spill_width == min(plan.n_bins, PG.MAX_SPILL)
    # a warp a bin, grid-stride past MAX_BLOCKS; the rotation blocks cover
    # the free list the same way
    assert 1 <= plan.blocks <= PC.MAX_BLOCKS
    assert plan.blocks == min(-(-plan.n_bins // PC.WARPS), PC.MAX_BLOCKS)
    assert 1 <= plan.rot_blocks <= PC.MAX_ROT_BLOCKS
    assert plan.rot_blocks * PC.THREADS >= min(
        n_pages, PC.MAX_ROT_BLOCKS * PC.THREADS)
    # a summary bit a 4-word group, 32 to a word; the rank tiles cover
    # the bins a thread a bin (items 1 at every path shape)
    assert plan.sum_words == -(-bw // 128)
    assert plan.items == 1
    assert plan.tiles == -(-plan.n_bins // PC.RANK_THREADS) <= PC.MAX_TILES
    hist = plan.tiles * plan.n_classes
    assert plan.scratch == (2 * plan.n_bins + plan.n_bins * plan.sum_words
                            + hist + 2 * plan.tiles)
    assert plan.fill_bytes == 3 * 4 * 64 * n_pages + 4 * hist
    assert plan.n_bins * bw <= PC.INT32_MAX
    # a plan is a function of its arguments alone
    PC.pages_plan(7, 3, 5, 1)
    assert PC.pages_plan(nw, n_pages, bw, PG.MAX_SPILL) == plan
    # the same classes the JAX package's need can take
    assert PG.bin_words_for(w) == JPG.bin_words_for(w)


def test_launch_plan_exact_at_phase17():
    # 8 x 16384 x 512 words in 16,384 bins of 4096: need 0-64, a warp a
    # bin in 2048 blocks, 131,072 pages in 512 rotation blocks, 32 summary
    # words a bin (2 MB), 16 rank tiles of 1024 bins; the scratch 2.2 MB
    assert PC.pages_plan(8 * 16384 * 512, 131072, 4096, 64) == PC.Plan(
        16384, 65, 64, 2048, 512, 32, 1, 16, 558128, 100667456)
    # the million shard: 32,768 bins, 4096 blocks (the cap), 32 tiles
    assert PC.pages_plan(16 * 16384 * 512, 262144, 4096, 64)[:8] == (
        32768, 65, 64, 4096, 1024, 32, 1, 32)
    # zipf100k's row block: 2048 bins of 32,768 words, 513 classes
    assert PC.pages_plan(16384 * 4096, 131072, 32768, 64)[:8] == (
        2048, 513, 64, 256, 512, 256, 1, 2)
    # no words, no pages, fewer bins than MAX_SPILL: one empty rank tile
    assert PC.pages_plan(0, 0, 64, 64) == PC.Plan(0, 2, 0, 1, 1, 1, 1, 1,
                                                  4, 8)
    assert PC.pages_plan(100, 3, 64, 64)[:3] == (2, 2, 2)
    # past MAX_TILES tiles a rank thread takes more bins
    big = PC.pages_plan(2**31 - 8, 8, 1, 64)
    assert (big.items, big.tiles) == (2048, 1024)
    # the largest bin the grant holds, and one past it
    assert PC.pages_plan(1, 1, 2**19, 64).n_classes == PC.MAX_CLASSES
    assert PC.pages_plan(1, 1, 2**19 + 1, 64).n_classes == PC.MAX_CLASSES + 1


# -- the wrapper's checks and the dispatch ------------------------------------


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _free(n):
    return torch.arange(n, dtype=torch.int32)


# (chg, new, free, page_words, bin_words, out); "cpu" is well formed
BAD = {
    "int64 chg": lambda: (torch.zeros((2, 64, 2), dtype=torch.int64),
                          _i32(2, 64, 2), _free(8), 64, 16, None),
    "strided chg": lambda: (_i32(2, 2, 64).transpose(1, 2), _i32(2, 64, 2),
                            _free(8), 64, 16, None),
    "shape": lambda: (_i32(2, 64, 2), _i32(2, 64, 3), _free(8), 64, 16,
                      None),
    "free 2-D": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), _i32(2, 4), 64, 16,
                         None),
    "free int64": lambda: (_i32(2, 64, 2), _i32(2, 64, 2),
                           torch.arange(8), 64, 16, None),
    "page words": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), _free(8), 32, 16,
                           None),
    "bin words 0": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), _free(8), 64, 0,
                            None),
    "classes": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), _free(8), 64,
                        2**19 + 64, None),
    "past int32": lambda: (torch.empty(2**31, dtype=torch.int32,
                                       device="meta"),
                           torch.empty(2**31, dtype=torch.int32,
                                       device="meta"),
                           torch.empty(8, dtype=torch.int32, device="meta"),
                           64, 4096, None),
    "out length": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), _free(8), 64, 16,
                           (None,) * 6),
    "out shape": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), _free(8), 64, 16,
                          (_i32(8, 32),) + (None,) * 6),
    "out dtype": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), _free(8), 64, 16,
                          (None,) * 6 + (torch.zeros(4),)),
    "free_next is free": lambda: _next_is_free(),
    "cpu": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), _free(8), 64, 16, None),
}


def _next_is_free():
    free = _free(8)
    return (_i32(2, 64, 2), _i32(2, 64, 2), free, 64, 16,
            (None,) * 4 + (free,) + (None,) * 2)


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_raises_before_launch(case, no_kernel):
    chg, new, free, pw, bw, out = BAD[case]()
    with pytest.raises(ValueError):
        PC.allocate_pages_cuda(chg, new, free, pw, bw, PG.MAX_SPILL, out)


SCRATCH = {
    "short": lambda plan: torch.zeros(plan.scratch - 1, dtype=torch.int32),
    "int64": lambda plan: torch.zeros(plan.scratch, dtype=torch.int64),
    "strided": lambda plan: torch.zeros(2 * plan.scratch,
                                        dtype=torch.int32)[::2],
    "another device": lambda plan: torch.empty(plan.scratch,
                                               dtype=torch.int32,
                                               device="meta"),
}


@pytest.mark.parametrize("case", sorted(SCRATCH))
def test_wrapper_checks_the_given_scratch(case, no_kernel):
    """The fused paged graph hands the kernel its static scratch: one that
    is short, not int32, strided or elsewhere raises before a launch; the
    plain version on CPU tensors needs none and is unchanged by one."""
    chg, new, free = _i32(2, 64, 2), _i32(2, 64, 2), _free(8)
    plan = PC.pages_plan(chg.numel(), 8, 16, PG.MAX_SPILL)
    with pytest.raises(ValueError):
        PC.allocate_pages_cuda(chg, new, free, 64, 16, PG.MAX_SPILL,
                               scratch=SCRATCH[case](plan))
    got = PG.allocate_pages(chg, new, free, 64, 16, PG.MAX_SPILL,
                            scratch=torch.empty(0, dtype=torch.int32))
    want = PG.allocate_pages_plain(chg, new, free, 64, 16, PG.MAX_SPILL)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cpu_entry_runs_the_plain_version(no_kernel):
    rng = np.random.default_rng(5)
    # 64 bins of 512 words (W = 64), each of need 0-3
    chg = C.pages_need_grid(rng.integers(0, 4, 64), 512, rng)
    new = rng.integers(0, 2**32, chg.size, dtype=np.uint64).astype(
        np.uint32)
    tc = torch.from_numpy(chg.view(np.int32)).reshape(1, 512, 64)
    tn = torch.from_numpy(new.view(np.int32)).reshape(1, 512, 64)
    free = torch.from_numpy(rng.permutation(40).astype(np.int32))
    got = PG.allocate_pages(tc, tn, free)
    want = PG.allocate_pages_plain(tc, tn, free)
    assert len(got) == 7 and all(torch.equal(a, b)
                                 for a, b in zip(got, want))
    assert int(got[6][1]) > 0  # the pool is too small: some bins spill
    # out=: the outputs land in the given tensors (the fused paged graph's
    # pools and bundle slices), None entries come back fresh
    bundle = torch.full((4 + 40 + 64,), 9, dtype=torch.int32)
    pools = [torch.full((40, 64), 9, dtype=torch.int32) for _ in range(3)]
    out = (*pools, bundle[4:44], None, bundle[44:], bundle[:4])
    res = PG.allocate_pages(tc, tn, free, out=out)
    for i, (a, b) in enumerate(zip(res, want)):
        assert torch.equal(a, b), i
        if out[i] is not None:
            assert a is out[i]
    assert torch.equal(bundle, torch.cat([want[6], want[3], want[5]]))
    assert torch.equal(free, want[4].roll(int(want[6][0])))  # untouched
    with pytest.raises(ValueError):  # a bad out= raises on the CPU too
        PG.allocate_pages(tc, tn, free, out=(None,) * 7 + (None,))


def test_kernel_constants_match_the_package():
    assert PC.PAGE_WORDS == PG.PAGE_WORDS == JPG.PAGE_WORDS
    assert PC.MAX_CLASSES == 2**19 // PC.PAGE_WORDS + 1
    assert PC.SUM_SPAN == 32 * 4  # a summary word: 32 groups of 4 words
    src = open(os.path.join(ROOT, "goworld_tpu_torch", "csrc",
                            "pages.cu")).read()
    for name, v in (("PAGE_WORDS", PC.PAGE_WORDS),
                    ("MAX_CLASSES", PC.MAX_CLASSES),
                    ("MAX_TILES", PC.MAX_TILES),
                    ("RANK_THREADS", PC.RANK_THREADS),
                    ("THREADS", PC.THREADS)):
        assert f"constexpr int {name} = {v};" in src, name


# -- the redesigned passes, a numpy model of csrc/pages.cu -------------------


def model_allocate(chg, new, free, bw, max_spill=PG.MAX_SPILL, tile=None):
    """csrc/pages.cu's three passes in numpy, on uint32 words, rank tiles
    of ``tile`` bins (default: the kernel's plan, RANK_THREADS * items).
    The count pass: the counts, the summary (a bit for each 4-word group
    of a bin holding a nonzero word, 32 groups a summary word) and each
    tile's histogram of the need classes.  The ranks: the classes'
    histogram, the boundary class v* and its first k* bins by id; a
    tile's first page and spill ranks from the earlier tiles' histograms
    alone (eqP bins of v*, AP pages below it, SP bins above it); then the
    tile's bins in order.  The write pass: a granted bin's nonzero words
    from the groups its summary flags (sparse) or from the bin whole
    (dense), then the page table and the rotated free list."""
    flat_c = np.asarray(chg, np.uint32).reshape(-1)
    flat_n = np.asarray(new, np.uint32).reshape(-1)
    free = np.asarray(free, np.int32)
    nw, n_pages = flat_c.size, free.size
    plan = PC.pages_plan(nw, n_pages, bw, max_spill)
    n_bins, n_classes, sum_words = plan.n_bins, plan.n_classes, plan.sum_words
    if tile is None:
        tile = PC.RANK_THREADS * plan.items
        assert plan.tiles == max(1, -(-n_bins // tile))
    tiles = max(1, -(-n_bins // tile))
    # the count pass
    cnt = np.zeros(n_bins, np.int64)
    summary = np.zeros((n_bins, sum_words), np.uint64)
    hist = np.zeros((tiles, n_classes), np.int64)
    for b in range(n_bins):
        words = flat_c[b * bw:(b + 1) * bw]
        cnt[b] = np.count_nonzero(words)
        padded = np.zeros(-(-bw // 4) * 4, np.uint32)
        padded[:words.size] = words
        for gi in np.nonzero(padded.reshape(-1, 4).any(axis=1))[0]:
            summary[b, gi // 32] |= np.uint64(1) << np.uint64(gi % 32)
        need = -(-cnt[b] // 64)
        if need:
            hist[b // tile, need] += 1
    need = -(-cnt // 64)
    # the ranks
    v = np.arange(n_classes)
    h = hist.sum(axis=0)
    pages = v * h
    prefix = np.cumsum(pages) - pages
    bad = (v >= 1) & (h > 0) & (prefix + pages > n_pages)
    vs = int(np.argmax(bad)) if bad.any() else n_classes
    cut = vs < n_classes
    ks = (n_pages - prefix[vs]) // vs if cut else 0
    sw = min(n_bins, max_spill)
    rank0 = np.full(n_bins, -1, np.int64)
    spill_bins = np.full(sw, -1, np.int32)
    fit_words = 0
    for t in range(tiles):
        before = hist[:t]
        eqp = int(before[:, vs].sum()) if cut else 0
        ap = int((v[:vs] * before[:, :vs]).sum())
        sp = int(before[:, vs + 1:].sum())
        p, s, er = ap + vs * min(eqp, ks), sp + max(eqp - ks, 0), eqp
        for b in range(t * tile, min((t + 1) * tile, n_bins)):
            eq = need[b] == vs
            fit = need[b] > 0 and (need[b] < vs or (eq and er < ks))
            er += eq
            if fit:
                rank0[b] = p
                p += need[b]
                fit_words += cnt[b]
            elif need[b] > 0:
                if s < sw:
                    spill_bins[s] = b
                s += 1
    n_used = prefix[vs] + vs * ks if cut else int(pages.sum())
    n_spill = int(h[1:].sum() - h[1:vs].sum() - ks) if cut else 0
    # the write pass
    pool_g = np.full(n_pages * 64, -1, np.int32)
    pool_c = np.zeros(n_pages * 64, np.uint32)
    pool_n = np.zeros(n_pages * 64, np.uint32)
    for b in np.nonzero(rank0 >= 0)[0]:
        lo, hi = b * bw, min((b + 1) * bw, nw)
        # dense: cnt / sum_words reaches bw / 512 (a count-pass step)
        if cnt[b] * 512 >= bw * sum_words:
            g = lo + np.nonzero(flat_c[lo:hi])[0]
        else:
            g = []
            for j in range(sum_words):
                for k in range(32):
                    if int(summary[b, j]) >> k & 1:
                        g0 = lo + 4 * (32 * j + k)
                        g += [w for w in range(g0, min(g0 + 4, hi))
                              if flat_c[w]]
            g = np.array(g, np.int64)
            assert g.size == cnt[b]
        d = rank0[b] * 64 + np.arange(g.size)
        pool_g[d], pool_c[d], pool_n[d] = g, flat_c[g], flat_n[g]
    i = np.arange(n_pages)
    page_tab = np.where(i < n_used, free, -1).astype(np.int32)
    free_next = free[(i + n_used) % max(n_pages, 1)]
    scalars = np.array([n_used, n_spill, fit_words, cnt.sum()], np.int32)
    return (pool_g.reshape(n_pages, 64), pool_c.reshape(n_pages, 64),
            pool_n.reshape(n_pages, 64), page_tab, free_next, spill_bins,
            scalars)


EDGE = {case[0]: case for case in C.pages_edge_cases("cpu")}


def _jax(chg, new, free, bw):
    return [np.asarray(a) for a in JPG.paged_extract(
        jnp.asarray(chg), jnp.asarray(new), jnp.asarray(free),
        page_words=PG.PAGE_WORDS, bin_words=bw, max_spill=PG.MAX_SPILL)]


def _u32(t):
    return t.numpy().view(np.uint32)


_WANT = {}


def _jax_edge(case):
    """JAX's paged_extract on one edge case (computed once a case)."""
    if case not in _WANT:
        _, chg, new, free, bw = EDGE[case]
        _WANT[case] = _jax(_u32(chg), _u32(new), free.numpy(), bw)
    return _WANT[case]


@pytest.mark.parametrize("case", sorted(EDGE))
def test_grant_model_matches_jax_at_phase3d_edges(case):
    _, chg, new, free, bw = EDGE[case]
    want = _jax_edge(case)
    got = model_allocate(_u32(chg), _u32(new), free.numpy(), bw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (case, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{case} output {i}")


@pytest.mark.parametrize("tile", [1, 3, 8, 40])
@pytest.mark.parametrize("case", sorted(EDGE))
def test_rank_tiles_place_every_bin_at_phase3d_edges(case, tile):
    """A tile's first page and spill ranks come from the earlier tiles'
    histograms alone: with tiles of 1 bin, of 3 (not dividing the bin
    count), of 8 and of 40 the model still equals JAX everywhere."""
    _, chg, new, free, bw = EDGE[case]
    got = model_allocate(_u32(chg), _u32(new), free.numpy(), bw, tile=tile)
    for i, (a, b) in enumerate(zip(got, _jax_edge(case))):
        np.testing.assert_array_equal(a, b, err_msg=f"{case} output {i}")


@pytest.mark.parametrize("case", sorted(EDGE))
def test_port_entry_matches_jax_at_phase3d_edges(case, no_kernel):
    _, chg, new, free, bw = EDGE[case]
    want = _jax(_u32(chg), _u32(new), free.numpy(), bw)
    got = PG.allocate_pages(chg, new, free, PG.PAGE_WORDS, bw, PG.MAX_SPILL)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.numpy().view(b.dtype)
        assert a.shape == b.shape, (case, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{case} output {i}")
    n_used, n_spill = (int(v) for v in want[6][:2])
    n_pages = free.numel()
    expect = {"empty grid": (0, 0),
              "full grid, all words nonzero": (1024, 0),
              "ties at the boundary class": (104, 44),
              "a pool that fits exactly (n_used = n_pages)": (n_pages, 0),
              "one page short": (n_pages - 1, 1),
              "n_used = 0": (0, 128)}
    if case in expect:
        assert (n_used, n_spill) == expect[case]
    if case == "more than MAX_SPILL spills":
        assert n_spill > PG.MAX_SPILL and (want[5] >= 0).all()
    if case == "ragged last bin":
        assert chg.numel() % bw and want[5].size == PG.MAX_SPILL
    if case == "bit-31 words":
        assert (want[1][want[0] >= 0] == 0x80000000).all() and n_used


def test_grant_ties_resolve_by_bin_id():
    """In the boundary class the first k* bins by id fit: a pool of 105
    over bins alternating need 1 and 2 takes every need-1 bin and the 20
    lowest need-2 bins (odd ids 1 .. 39)."""
    _, chg, new, free, bw = EDGE["ties at the boundary class"]
    got = PG.allocate_pages(chg, new, free, PG.PAGE_WORDS, bw, PG.MAX_SPILL)
    assert got[5].tolist() == list(range(41, 128, 2)) + [-1] * 20
