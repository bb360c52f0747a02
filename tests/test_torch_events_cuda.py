"""The event compaction's hand-written kernels (goworld_tpu_torch/csrc/
events.cu, bound in goworld_tpu_torch.ops.events_cuda) as far as the CPU
reaches them: the launch plans as pure functions over the shapes the card
runs, the wrappers' checks (they raise before anything builds or
launches), the dispatch of ``ops/events`` (a CPU tensor runs the plain
version and counts no launch), and the edge inputs that ``chip_smoke.py``
phase 3c holds the kernels to on the card, here held through the port's
entries to the JAX package's ``ops/events``.  Exact equality throughout
(integer work only)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from goworld_tpu.ops import events as JE
from goworld_tpu_torch.ops import events as TE
from goworld_tpu_torch.ops import events_cuda as EC
from goworld_tpu_torch.ops.aoi_predicate import words_to_torch
from torch_threads import one_intra_op_thread  # noqa: F401

J_TRIPLES = jax.jit(JE.extract_triples, static_argnums=(2, 3))
J_EXTRACT = jax.jit(JE.extract_chunks, static_argnums=(1, 2),
                    static_argnames=("lanes",))
J_ENCODE = jax.jit(JE.encode_row_stream,
                   static_argnames=("w", "max_gaps", "max_exc"))


def _same(t, j, name):
    a, b = t.numpy(), np.asarray(j)
    if b.dtype == np.uint32 and a.dtype == np.int32:
        a = a.view(np.uint32)
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture
def no_kernel(monkeypatch):
    """Nothing may build or launch: the bindings raise if reached, and the
    launch counts stay 0."""
    def refuse(name):
        raise AssertionError(f"{name} reached the CUDA library")

    monkeypatch.setattr(EC, "_fn", refuse)
    EC.reset_launches()
    yield
    assert EC.launches == {"extract_triples": 0, "extract_chunks": 0,
                           "encode_row_stream": 0}


# -- launch plans -------------------------------------------------------------

# (label, words): the diffs the card compacts -- phase 4's bucket grid, the
# `million` / `zipf100k` words, `zipfshare`'s row block, a mesh shard of
# `million` (4 shards), phase 20's cohort rungs, the triples tile's edges,
# and int64 boundaries
PLAN_WORDS = [("phase4", 8 * 16384 * 512), ("million", 64 * 16384 * 512),
              ("zipf100k", 131072 * 4096), ("zipfshare", 16384 * 4096),
              ("mesh shard", 16 * 16384 * 512), ("rung 256", 24 * 256 * 8),
              ("rung 128", 24 * 128 * 4), ("one word", 1), ("empty", 0),
              ("tile - 1", EC.TRI_TILE - 1), ("tile", EC.TRI_TILE),
              ("tile + 1", EC.TRI_TILE + 1),
              ("2^31 - 1", 2**31 - 1), ("2^31", 2**31), ("2^34", 2**34)]


def _covers(units, span, blocks, tile):
    assert span % tile == 0 and span >= tile
    assert 1 <= blocks <= EC.MAX_BLOCKS
    assert (blocks - 1) * span < max(units, 1)
    assert blocks * span >= units


def _one_pass(units, plan, tile, counts, fill_bytes):
    """A tile a block, by ticket: the tiles cover the units (one tile for
    none) within the grid's x limit; a status word a tile for each ranked
    count, then the ticket, all zeroed by the reset memset."""
    assert plan.tile == tile
    assert 1 <= plan.tiles <= 2**31 - 1
    assert (plan.tiles - 1) * tile < max(units, 1) <= plan.tiles * tile
    assert plan.scratch == counts * plan.tiles + 1
    assert plan.reset_bytes == 8 * plan.scratch
    assert plan.fill_bytes == fill_bytes


@pytest.mark.parametrize("label,n", PLAN_WORDS, ids=[p[0] for p in PLAN_WORDS])
def test_launch_plans_cover_the_path_shapes(label, n):
    tp = EC.triples_plan(n, 1 << 18)
    _one_pass(n, tp, EC.TRI_TILE, 1, 12 << 18)
    rows = n // 128
    cp = EC.chunks_plan(rows, 4096)
    _covers(rows, cp.span, cp.blocks, EC.ROW_TILE)
    assert cp.scratch == 3 * cp.blocks + 2 and cp.rows == max(1, rows)
    assert cp.fill_blocks == min(-(-4096 // EC.WARPS), EC.MAX_FILL_BLOCKS)
    ep = EC.encode_plan(max(rows, 1), 2048, 16384)
    _one_pass(max(rows, 1), ep, EC.ENC_TILE, 1, 4 * 2048 + 12 * 16384)
    # a plan is a function of its arguments alone: the same call, after
    # others, gives the same plan
    EC.triples_plan(7, 3), EC.encode_plan(3, 1, 1), EC.chunks_plan(3, 1)
    assert EC.triples_plan(n, 1 << 18) == tp
    assert EC.chunks_plan(rows, 4096) == cp
    assert EC.encode_plan(max(rows, 1), 2048, 16384) == ep


def test_launch_plans_exact_at_phase4_and_million():
    # phase 4: 67.1 M words in 8192 tiles of 8192, a status word each and
    # the ticket; the 2^18 triple rows prefilled with -1
    assert EC.triples_plan(8 * 16384 * 512, 1 << 18) == EC.OnePass(
        8192, 8192, 8193, 65544, 3145728)
    # million: 4.19 M rows of 128 words, 1024 rows a block
    assert EC.chunks_plan(4194304, 65536)[:3] == (1024, 4096, 1024)
    # its encode at the path's caps: 500,736 rows in 978 tiles of 512,
    # one status word a tile (both counts); the four lists' fills
    assert EC.encode_plan(500736, 8192, 16384) == EC.OnePass(
        512, 978, 979, 7832, 229376)
    # zipfshare's row block: 524,288 rows, one tile a block
    assert EC.chunks_plan(524288, 8192)[:2] == (256, 2048)
    # a small diff and an empty one: one tile (it writes count)
    assert EC.triples_plan(5, 7) == EC.OnePass(8192, 1, 2, 16, 84)
    assert EC.triples_plan(0, 1) == EC.OnePass(8192, 1, 2, 16, 12)
    # the tile's edges, 2^34 words, one row, rows past a tile
    assert [EC.triples_plan(n, 1).tiles for n in (8191, 8192, 8193)] == [
        1, 1, 2]
    assert EC.triples_plan(2**34, 1).tiles == 2**21
    assert EC.encode_plan(1, 1, 1) == EC.OnePass(512, 1, 2, 16, 16)
    assert [EC.encode_plan(n, 1, 1).tiles for n in (511, 512, 513, 65536)
            ] == [1, 1, 2, 128]
    assert EC.span_plan(0, 256) == (256, 1)
    assert EC.span_plan(4097 * 256, 256) == (512, 2049)


# -- wrappers' checks and the dispatch ----------------------------------------


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


BAD_TRIPLES = {
    "int64 chg": lambda: (torch.zeros((2, 64, 2), dtype=torch.int64),
                          _i32(2, 64, 2), 64, 8),
    "strided chg": lambda: (_i32(2, 2, 64).transpose(1, 2), _i32(2, 64, 2),
                            64, 8),
    "shape": lambda: (_i32(2, 64, 2), _i32(2, 64, 3), 64, 8),
    "cap 0": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), 64, 0),
    "capacity": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), 63, 8),
    "cpu": lambda: (_i32(2, 64, 2), _i32(2, 64, 2), 64, 8),
}
BAD_CHUNKS = {
    "int64": lambda: (torch.zeros((4, 128), dtype=torch.int64), 4, 8, None),
    "strided": lambda: (_i32(128, 4).t(), 4, 8, None),
    "ragged rows": lambda: (_i32(3, 100), 4, 8, None),
    "aux shape": lambda: (_i32(4, 128), 4, 8, _i32(2, 128)),
    "cap 0": lambda: (_i32(4, 128), 0, 8, None),
    "k 0": lambda: (_i32(4, 128), 4, 0, None),
    "cpu": lambda: (_i32(4, 128), 4, 8, _i32(4, 128)),
}
BAD_ENCODE = {
    "uint8 vals": lambda: ((torch.zeros((4, 8), dtype=torch.uint8),
                            _i32(4, 8), _i32(4, 8), _i32(4), _i32(4)),
                           128, 8, 8),
    "strided widx": lambda: ((_i32(4, 8), _i32(4, 8), _i32(8, 4).t(),
                              _i32(4), _i32(4)), 128, 8, 8),
    "rsel shape": lambda: ((_i32(4, 8), _i32(4, 8), _i32(4, 8), _i32(5),
                            _i32(4)), 128, 8, 8),
    "no rows": lambda: ((_i32(0, 8), _i32(0, 8), _i32(0, 8), _i32(0),
                         _i32(0)), 128, 8, 8),
    "gaps 0": lambda: ((_i32(4, 8), _i32(4, 8), _i32(4, 8), _i32(4),
                        _i32(4)), 128, 0, 8),
    "exc 0": lambda: ((_i32(4, 8), _i32(4, 8), _i32(4, 8), _i32(4),
                       _i32(4)), 128, 8, 0),
    "cpu": lambda: ((_i32(4, 8), _i32(4, 8), _i32(4, 8), _i32(4), _i32(4)),
                    128, 8, 8),
}


@pytest.mark.parametrize("case", sorted(BAD_TRIPLES))
def test_triples_wrapper_raises_before_launch(case, no_kernel):
    with pytest.raises(ValueError):
        EC.extract_triples_cuda(*BAD_TRIPLES[case]())


@pytest.mark.parametrize("case", sorted(BAD_CHUNKS))
def test_chunks_wrapper_raises_before_launch(case, no_kernel):
    words, mc, k, aux = BAD_CHUNKS[case]()
    with pytest.raises(ValueError):
        EC.extract_chunks_cuda(words, mc, k, aux, 128)


@pytest.mark.parametrize("case", sorted(BAD_ENCODE))
def test_encode_wrapper_raises_before_launch(case, no_kernel):
    arrays, w, gaps, exc = BAD_ENCODE[case]()
    with pytest.raises(ValueError):
        EC.encode_row_stream_cuda(*arrays, w=w, max_gaps=gaps, max_exc=exc)


def _dense(shape, seed, density):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    words[rng.random(shape) >= density] = 0
    return words


def test_cpu_entries_run_the_plain_versions(no_kernel):
    chg, new = _dense((2, 64, 8), 3, 0.1), _dense((2, 64, 8), 4, 0.6)
    tc, tn = words_to_torch(chg, "cpu"), words_to_torch(new, "cpu")
    got = TE.extract_triples(tc, tn, 256, 300)
    want = TE.extract_triples_plain(tc, tn, 256, 300)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tri_j, cnt_j = J_TRIPLES(jnp.asarray(chg), jnp.asarray(new), 256, 300)
    _same(got[0], tri_j, "tri")
    assert int(got[1]) == int(cnt_j)
    ch = TE.extract_chunks(tc, 4, 8, tn, 128)
    assert all(a is b is None or torch.equal(a, b) for a, b in
               zip(ch, TE.extract_chunks_plain(tc, 4, 8, tn, 128)))
    enc = TE.encode_row_stream(*ch[:5], w=128,
                               max_gaps=8, max_exc=16)
    plain = TE.encode_row_stream_plain(ch[0], ch[1], ch[2], ch[3], ch[4],
                                       w=128, max_gaps=8, max_exc=16)
    assert all(torch.equal(a, b) for a, b in zip(enc, plain))


# -- the edge inputs of phase 3c, held to the JAX package ---------------------


def _triples_case(case):
    """(chg, new, capacity, max_triples) of one edge input (uint32)."""
    new = _dense((1, 64, 32), 11, 0.7)
    chg = np.zeros((1, 64, 32), np.uint32)
    if case == "cap-in-word":  # the cap falls on the 14th bit of word 9
        chg[0, 0, 3] = 0b10110
        chg[0, 0, 9] = 0xFFFFFFFF
        chg[0, 5, 1] = 1
        return chg, new, 1024, 3 + 13
    if case.startswith("cap-at-block"):  # tile 0 of the plan: 8192 words
        chg = np.full((1, 1024, 32), 0xFFFFFFFF, np.uint32)
        edge = EC.triples_plan(chg.size, 1).tile * 32
        return (chg, _dense(chg.shape, 11, 0.7), 1024,
                edge + int(case[len("cap-at-block"):] or 0))
    if case == "bit31-and-ones":
        chg[0, 0, 0] = 0x80000000
        chg[0, 63, 31] = 0xFFFFFFFF
        chg[0, 40, 7] = 0x80000001
        return chg, new, 1024, 40
    raise KeyError(case)


@pytest.mark.parametrize("case", ["cap-in-word", "cap-at-block",
                                  "cap-at-block-1", "cap-at-block+1",
                                  "bit31-and-ones"])
def test_triples_edges_match_jax(case, no_kernel):
    chg, new, cap, mt = _triples_case(case)
    tri_j, cnt_j = J_TRIPLES(jnp.asarray(chg), jnp.asarray(new), cap, mt)
    tri_t, cnt_t = TE.extract_triples(words_to_torch(chg, "cpu"),
                                      words_to_torch(new, "cpu"), cap, mt)
    _same(tri_t, tri_j, "tri")
    assert int(cnt_t) == int(cnt_j) == int(np.unpackbits(
        chg.view(np.uint8)).sum())
    if case != "bit31-and-ones":
        assert int(cnt_t) > mt and (tri_t.numpy() >= 0).all()


def _chunks_case(case):
    """(words, aux, max_chunks, k) of one edge input, rows of 128."""
    words = np.zeros((700, 128), np.uint32)
    aux = _dense((700, 128), 5, 0.5)
    if case == "one-dirty-last-row":
        words[699, 127] = 0x80000000
        return words, aux, 1, 8
    if case == "max-ccnt-unkept":  # the fullest row lies past the cap
        words[:10, 3] = 1
        words[500, :100] = 7
        return words, aux, 5, 8
    if case == "kk-at-lanes":
        words[3, :] = 0xFFFFFFFF
        words[4, ::3] = 2
        return words, aux, 4, 128
    raise KeyError(case)


@pytest.mark.parametrize("case", ["one-dirty-last-row", "max-ccnt-unkept",
                                  "kk-at-lanes"])
def test_chunks_edges_match_jax(case, no_kernel):
    words, aux, mc, k = _chunks_case(case)
    j = J_EXTRACT(jnp.asarray(words), mc, k, aux=jnp.asarray(aux),
                  lanes=128)
    t = TE.extract_chunks(words_to_torch(words, "cpu"), mc, k,
                          aux=words_to_torch(aux, "cpu"), lanes=128)
    for name, a, b in zip(("vals", "aux", "lane", "csel", "ccnt", "n_dirty",
                           "max_ccnt"), t, j):
        _same(a, b, name)
    if case == "max-ccnt-unkept":
        assert int(t[6]) == 100 and int(t[4].max()) == 1
    if case == "one-dirty-last-row":
        assert int(t[3][0]) == 699 and int(t[5]) == 1


def _encode_inputs():
    """Chunk rows with a dirty row every 100 rows (each escapes) and
    multi-bit words (each an exception)."""
    words = np.zeros((100 * 40, 128), np.uint32)
    rng = np.random.default_rng(2)
    for i, r in enumerate(range(0, 4000, 100)):
        words[r, rng.choice(128, 1 + i % 5, replace=False)] = (
            rng.integers(1, 2**32, 1 + i % 5, dtype=np.uint64))
    new = _dense(words.shape, 8, 0.5)
    return words, new


@pytest.mark.parametrize("which", ["n_esc", "exc_n"])
def test_encode_just_over_its_caps_matches_jax(which, no_kernel):
    words, new = _encode_inputs()
    j = J_EXTRACT(jnp.asarray(words), 64, 8, aux=jnp.asarray(new), lanes=128)
    t = TE.extract_chunks(words_to_torch(words, "cpu"), 64, 8,
                          aux=words_to_torch(new, "cpu"), lanes=128)
    full = TE.encode_row_stream(*t[:5], w=128, max_gaps=4096, max_exc=4096)
    n_esc, exc_n = int(full[4]), int(full[9])
    assert n_esc == 39 and exc_n > 40
    gaps = n_esc - 1 if which == "n_esc" else 4096
    exc = exc_n - 1 if which == "exc_n" else 4096
    enc_j = J_ENCODE(*j[:5], w=128, max_gaps=gaps, max_exc=exc)
    enc_t = TE.encode_row_stream(*t[:5], w=128, max_gaps=gaps, max_exc=exc)
    for name, a, b in zip(("rowb", "bitpos", "woff", "base_row", "n_esc",
                           "esc_rows", "exc_gidx", "exc_chg", "exc_new",
                           "exc_n"), enc_t, enc_j):
        _same(a, b, name)
    assert int(enc_t[4]) == n_esc and int(enc_t[9]) == exc_n
