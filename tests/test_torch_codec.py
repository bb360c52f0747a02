"""The port's row-stream codec (goworld_tpu_torch.ops.events extract_chunks,
encode_row_stream, decode_row_stream, expand_words_host) against the JAX
package's ops/events, and the giant-capacity tick as a whole
(goworld_tpu_torch.ops.cadence: fixed-order culled grid and row block)
against the same composition of JAX functions.  Every output buffer is
compared element for element (uint32 words carried as int32): the codec
is integer work and the step IEEE compares, so there is no tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from goworld_tpu.ops import aoi_grid as JG
from goworld_tpu.ops import events as JE
from goworld_tpu.ops.aoi_pallas import aoi_step_pallas
from goworld_tpu_torch.ops import cadence as CD
from goworld_tpu_torch.ops import events as TE
from goworld_tpu_torch.ops.aoi_predicate import words_to_numpy, words_to_torch
from torch_threads import one_intra_op_thread  # noqa: F401


# the JAX codec jitted (eager mode compiles every primitive anew per shape)
J_EXTRACT = jax.jit(JE.extract_chunks, static_argnums=(1, 2),
                    static_argnames=("lanes",))
J_ENCODE = jax.jit(JE.encode_row_stream,
                   static_argnames=("w", "max_gaps", "max_exc"))


def sparse_words(shape, density, seed, multi=0.0):
    """uint32 words with a ``density`` fraction of single-bit words and a
    ``multi`` fraction of random multi-bit words (bit 31 included)."""
    rng = np.random.default_rng(seed)
    words = np.zeros(shape, np.uint32)
    hit = rng.random(shape) < density
    words[hit] = np.uint32(1) << rng.integers(0, 32, hit.sum()).astype(
        np.uint32)
    many = rng.random(shape) < multi
    words[many] = rng.integers(0, 2**32, many.sum(), dtype=np.uint64)
    return words


def _same(t, j, name):
    """A port tensor equals a JAX array: the same shape and elements,
    int32 words read as the JAX side's uint32."""
    a, b = t.numpy(), np.asarray(j)
    if b.dtype == np.uint32 and a.dtype == np.int32:
        a = a.view(np.uint32)
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(a, b, err_msg=name)


def extract_both(words, new, mc, k, lanes=128, aux=True):
    j = J_EXTRACT(jnp.asarray(words), mc, k,
                          aux=jnp.asarray(new) if aux else None, lanes=lanes)
    t = TE.extract_chunks(words_to_torch(words, "cpu"), mc, k,
                          aux=words_to_torch(new, "cpu") if aux else None,
                          lanes=lanes)
    return j, t


EXTRACT_CASES = {
    # name: (shape, density, multi, max_chunks, k)
    "sparse": ((2, 256, 8), 0.01, 0.0, 64, 8),
    "overflow-chunks": ((2, 256, 8), 0.05, 0.0, 16, 8),
    "mcc-over-k": ((1, 512, 16), 0.2, 0.05, 256, 4),
    "k-over-lanes": ((1, 64, 8), 0.3, 0.1, 8, 40),
    "padded": ((1, 128, 4), 0.02, 0.0, 64, 8),
    "empty": ((1, 128, 4), 0.0, 0.0, 16, 8),
    "kk-at-lanes": ((1, 64, 8), 0.6, 0.3, 8, 128),
}


@pytest.mark.parametrize("case", sorted(EXTRACT_CASES))
def test_extract_chunks_matches_jax(case):
    shape, density, multi, mc, k = EXTRACT_CASES[case]
    words = sparse_words(shape, density, seed=len(case), multi=multi)
    new = sparse_words(shape, 0.5, seed=99, multi=0.3)
    lanes = 32 if case == "k-over-lanes" else 128
    j, t = extract_both(words, new, mc, k, lanes=lanes)
    assert len(j) == len(t) == 7
    for name, a, b in zip(("vals", "aux", "lane", "csel", "ccnt", "n_dirty",
                           "max_ccnt"), t, j):
        _same(a, b, name)
    nd, mcc = int(t[5]), int(t[6])
    nz_chunks = (words.reshape(-1, lanes) != 0).sum(1)
    assert nd == (nz_chunks > 0).sum() and mcc == nz_chunks.max()
    if case == "overflow-chunks":
        assert nd > mc
    if case == "mcc-over-k":
        assert mcc > k
    _, t2 = extract_both(words, new, mc, k, lanes=lanes, aux=False)
    assert t2[1] is None


ENCODE_CASES = {
    # name: (shape, density, multi, max_chunks, k, max_gaps, max_exc)
    "plain": ((2, 512, 16), 0.004, 0.0, 256, 8, 64, 256),
    "escapes": ((1, 8192, 32), 0.0002, 0.0, 2048, 8, 64, 256),
    "exceptions": ((1, 512, 16), 0.05, 0.05, 256, 16, 64, 4096),
    "gaps-overflow": ((1, 8192, 32), 0.0002, 0.0, 2048, 8, 4, 256),
    "exc-overflow": ((1, 512, 16), 0.05, 0.05, 256, 16, 64, 8),
    "wide-rows": ((1, 1024, 32), 0.01, 0.01, 512, 8, 64, 512),
    "one-slot": ((1, 512, 16), 0.05, 0.05, 256, 1, 64, 256),
}


@pytest.mark.parametrize("case", sorted(ENCODE_CASES))
def test_encode_row_stream_matches_jax_and_round_trips(case):
    shape, density, multi, mc, k, gaps, exc = ENCODE_CASES[case]
    words = sparse_words(shape, density, seed=len(case) + 7, multi=multi)
    new = sparse_words(shape, 0.5, seed=5, multi=0.3)
    lanes = 512 if case == "wide-rows" else 128  # uint16 woff past 256
    j, t = extract_both(words, new, mc, k, lanes=lanes)
    enc_j = J_ENCODE(j[0], j[1], j[2], j[3], j[4], w=lanes, max_gaps=gaps,
                     max_exc=exc)
    enc_t = TE.encode_row_stream(t[0], t[1], t[2], t[3], t[4], w=lanes,
                                 max_gaps=gaps, max_exc=exc)
    names = ("rowb", "bitpos", "woff", "base_row", "n_esc", "esc_rows",
             "exc_gidx", "exc_chg", "exc_new", "exc_n")
    for name, a, b in zip(names, enc_t, enc_j):
        _same(a, b, name)
        if name in ("rowb", "bitpos", "woff"):
            assert a.numpy().dtype == np.asarray(b).dtype, name
    n_esc, exc_n, nd = int(enc_t[4]), int(enc_t[9]), int(t[5])
    if case == "escapes":
        assert 0 < n_esc <= gaps
    if case == "exceptions":
        assert 0 < exc_n <= exc
    if case == "gaps-overflow":
        assert n_esc > gaps
    if case == "exc-overflow":
        assert exc_n > exc
    if nd > mc or int(t[6]) > k or n_esc > gaps or exc_n > exc:
        return  # incomplete stream: the caller falls back
    args = [a.numpy() for a in enc_t]
    chg, ent, gidx = TE.decode_row_stream(
        args[0], args[1], args[2], args[3], nd, lanes, args[5], args[6],
        args[7], args[8])
    want = JE.decode_row_stream(
        *(np.asarray(a) for a in enc_j[:4]), nd, lanes,
        *(np.asarray(a) for a in enc_j[5:9]))
    for a, b in zip((chg, ent, gidx), want):
        np.testing.assert_array_equal(a, b)
    # the round trip: exactly the changed words, their enter subsets
    flat, newf = words.reshape(-1), new.reshape(-1)
    order = np.argsort(gidx)
    np.testing.assert_array_equal(gidx[order], np.nonzero(flat)[0])
    np.testing.assert_array_equal(chg[order], flat[gidx[order]])
    np.testing.assert_array_equal(ent[order],
                                  flat[gidx[order]] & newf[gidx[order]])


def test_expand_words_host_matches_jax():
    cap = 256
    words = sparse_words((3, cap, cap // 32), 0.02, seed=4, multi=0.01)
    flat = words.reshape(-1)
    idx = np.nonzero(flat)[0].astype(np.int64)
    idx = np.concatenate([idx, [-1, -1]])
    vals = np.concatenate([flat[idx[:-2]], [7, 9]]).astype(np.uint32)
    got = TE.expand_words_host(vals, idx, cap)
    np.testing.assert_array_equal(got, JE.expand_words_host(vals, idx, cap,
                                                            3))
    assert len(got) == int(np.unpackbits(flat.view(np.uint8)).sum())
    assert TE.expand_words_host(vals[:0], idx[:0], cap).shape == (0, 3)


def test_caps_first_guess_and_refit():
    caps = CD.Caps.first_guess(4_194_304, grid=True)
    assert caps == CD.Caps(16384, 32, 8192, 16384)
    assert CD.Caps.first_guess(300, grid=False) == CD.Caps(512, 8)
    fit = caps.refit(4_194_304, {"n_dirty": 500_001, "max_ccnt": 9,
                                 "n_esc": 7000, "exc_n": 40_000})
    assert fit == CD.Caps(750_080, 18, 11264, 61440)
    assert caps.refit(1000, {"n_dirty": 5000, "max_ccnt": 100, "n_esc": 1,
                             "exc_n": 1}) == CD.Caps(1000, 128, 8192, 16384)


# -- the slice as a whole -----------------------------------------------------

QMAX = 80  # walk step 5: int8 deltas in [-80, 80] x 1/16
CW = 32


def _walk_np(pos, q, world):
    return np.clip(pos + q.astype(np.float32) * CD.QSCALE, np.float32(0),
                   np.float32(world))


def _jax_buffer(enc, nd, mcc):
    """The JAX codec's outputs in encode_tick's buffer layout."""
    (rowb, bitpos, woff, base_row, n_esc, esc_rows, exc_gidx, exc_chg,
     exc_new, exc_n) = (np.asarray(a) for a in enc)
    meta = np.concatenate([
        np.array([base_row, nd, mcc, n_esc, exc_n], np.int32),
        esc_rows, exc_gidx, exc_chg.view(np.int32), exc_new.view(np.int32)])
    return np.concatenate([rowb, bitpos.reshape(-1), woff.reshape(-1),
                           meta.view(np.uint8)])


def _jax_codec(new, chg, caps):
    vals, nv, lane, csel, ccnt, nd, mcc = J_EXTRACT(
        chg, caps.max_chunks, caps.k, aux=new, lanes=CD.LANES)
    enc = J_ENCODE(vals, nv, lane, csel, ccnt, w=CD.LANES,
                   max_gaps=caps.max_gaps, max_exc=caps.max_exc)
    return _jax_buffer(enc, int(nd), int(mcc))


def _replay(host, buf, caps):
    sc, dec = CD.decode_tick(buf, caps)
    assert dec is not None, f"stream overflowed its caps: {sc}"
    chg_vals, _, gidx = dec
    host[gidx] ^= chg_vals
    return sc


def test_fixed_order_run_matches_jax_composition():
    """S = 2, C = 1024 for 6 ticks with a re-sort before tick 4: the
    port's FixedOrderGrid + encode_tick against jnp.argsort + the JAX
    culled kernels (interpret) + the JAX codec.  Every tick's encoded
    buffer is equal byte for byte, and replaying the decoded stream onto
    a host copy of the words gives the device words."""
    s, c, world = 2, 1024, 2500.0
    rng = np.random.default_rng(21)
    x = rng.uniform(0, world, (s, c)).astype(np.float32)
    z = rng.uniform(0, world, (s, c)).astype(np.float32)
    r = np.full((s, c), 100, np.float32)
    act = np.ones((s, c), bool)
    act[1, 900:] = False
    grid = CD.FixedOrderGrid(*(torch.from_numpy(a.copy())
                               for a in (x, z, r, act)), world)
    caps = CD.Caps.first_guess(grid.n_stream_chunks, grid=True)

    def jax_resort(x, z):
        perm = np.asarray(jnp.argsort(jnp.where(act, x, np.inf), axis=1))
        take = [np.take_along_axis(a, perm, axis=1) for a in (x, z, r, act)]
        words, _ = JG.aoi_words_culled(*map(jnp.asarray, take),
                                       block_rows=512, col_words=CW,
                                       interpret=True)
        return perm, take, words

    perm, (sx, sz, rs, acts), words_j = jax_resort(x, z)
    np.testing.assert_array_equal(grid.perm_host, perm)
    host = words_to_numpy(grid.words).reshape(-1)
    np.testing.assert_array_equal(host, np.asarray(words_j).reshape(-1))
    events = 0
    for tick in range(1, 7):
        if tick == 4:
            grid.resort()
            perm, (sx, sz, rs, acts), words_j = jax_resort(x, z)
            np.testing.assert_array_equal(grid.perm_host, perm)
            host = words_to_numpy(grid.words).reshape(-1)
        qx = rng.integers(-QMAX, QMAX + 1, (s, c)).astype(np.int8)
        qz = rng.integers(-QMAX, QMAX + 1, (s, c)).astype(np.int8)
        x, z = _walk_np(x, qx, world), _walk_np(z, qz, world)
        sx = _walk_np(sx, np.take_along_axis(qx, perm, axis=1), world)
        sz = _walk_np(sz, np.take_along_axis(qz, perm, axis=1), world)
        new_t, chg_t, _ = grid.step(qx, qz)
        new_j, chg_j, _ = JG.aoi_step_culled(
            *map(jnp.asarray, (sx, sz, rs, acts)), words_j, block_rows=512,
            col_words=CW, interpret=True)
        words_j = new_j
        buf = CD.encode_tick(new_t, chg_t, caps).numpy()
        np.testing.assert_array_equal(buf, _jax_codec(new_j, chg_j, caps),
                                      err_msg=f"tick {tick}")
        sc = _replay(host, buf, caps)
        events += int(np.unpackbits(np.asarray(chg_j).view(np.uint8)).sum())
        np.testing.assert_array_equal(host, words_to_numpy(new_t).reshape(-1))
        np.testing.assert_array_equal(host, np.asarray(new_j).reshape(-1))
        assert sc["n_dirty"] > 0
    np.testing.assert_array_equal(grid.x.numpy(), x)
    assert events > 100


def test_row_block_run_matches_jax_rect_kernel():
    """The zipfshare composition at a small size: a 256-row block in the
    middle of a 1024-slot space, 3 ticks of the rectangular step (port vs
    the JAX Pallas kernel in interpret mode) and the codec."""
    s, c, rows, row0, world = 1, 1024, 256, 384, 2500.0
    rng = np.random.default_rng(8)
    x = rng.uniform(0, world, (s, c)).astype(np.float32)
    z = rng.uniform(0, world, (s, c)).astype(np.float32)
    r = np.full((s, c), 150, np.float32)
    act = rng.random((s, c)) < 0.95
    blk = CD.RowBlock(*(torch.from_numpy(a.copy()) for a in (x, z, r, act)),
                      world, rows, row0=row0)
    rid = jnp.asarray(np.arange(row0, row0 + rows, dtype=np.int32)[None])
    b = slice(row0, row0 + rows)

    def jax_step(prev):
        return aoi_step_pallas(
            *(jnp.asarray(a[:, b]) for a in (x, z, r, act)), prev,
            emit="chg", cols=tuple(map(jnp.asarray, (x, z, act))),
            row_ids=rid, interpret=True)

    words_j, _ = jax_step(jnp.zeros((s, rows, c // 32), jnp.uint32))
    host = words_to_numpy(blk.words).reshape(-1)
    np.testing.assert_array_equal(host, np.asarray(words_j).reshape(-1))
    caps = CD.Caps.first_guess(blk.n_stream_chunks, grid=False)
    for tick in range(3):
        qx = rng.integers(-QMAX, QMAX + 1, (s, c)).astype(np.int8)
        qz = rng.integers(-QMAX, QMAX + 1, (s, c)).astype(np.int8)
        x, z = _walk_np(x, qx, world), _walk_np(z, qz, world)
        new_t, chg_t = blk.step(qx, qz)
        words_j, chg_j = jax_step(words_j)
        buf = CD.encode_tick(new_t, chg_t, caps).numpy()
        np.testing.assert_array_equal(buf, _jax_codec(words_j, chg_j, caps),
                                      err_msg=f"tick {tick}")
        _replay(host, buf, caps)
        np.testing.assert_array_equal(host, np.asarray(words_j).reshape(-1))
