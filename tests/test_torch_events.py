"""The port's on-device event compaction (goworld_tpu_torch.ops.events)
against the JAX package's: ``extract_triples`` must give the identical
[max_triples, 3] buffer (order, -1 fill, truncation) and count, including
an empty diff, bit-31 words and count > max_triples.  Also the popcount,
the host expanders and the triples <-> words round trip.  Exact equality
throughout (integer work only)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from goworld_tpu.ops import events as JE
from goworld_tpu_torch.ops import events as TE
from goworld_tpu_torch.ops.aoi_predicate import words_to_torch


def _grids(s, c, density, seed):
    rng = np.random.default_rng(seed)
    w = c // 32
    bits = rng.random((s, c, w, 32)) < density
    chg = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)
    new = rng.integers(0, 2**32, (s, c, w), dtype=np.uint64).astype(np.uint32)
    return chg, new


def _both(chg, new, cap, mt):
    tri_j, cnt_j = JE.extract_triples(jnp.asarray(chg), jnp.asarray(new),
                                      cap, mt)
    tri_t, cnt_t = TE.extract_triples(words_to_torch(chg, "cpu"),
                                      words_to_torch(new, "cpu"), cap, mt)
    assert tri_t.dtype == torch.int32 and tuple(tri_t.shape) == (mt, 3)
    return (np.asarray(tri_j), int(cnt_j)), (tri_t.numpy(), int(cnt_t))


@pytest.mark.parametrize("case", ["empty", "sparse", "bit31", "overflow"])
def test_extract_triples_matches_jax(case):
    s, c, mt = 2, 256, 512
    chg, new = _grids(s, c, 0.002, seed=len(case))
    if case == "empty":
        chg[:] = 0
    elif case == "bit31":
        chg[:] = 0
        chg[0, 3, 5] = np.uint32(1 << 31)
        chg[1, 200, 7] = np.uint32(0x80000001)
        chg[1, 255, 7] = np.uint32(0xFFFFFFFF)
    elif case == "overflow":
        chg, new = _grids(s, c, 0.03, seed=9)
    (tri_j, cnt_j), (tri_t, cnt_t) = _both(chg, new, c, mt)
    assert cnt_t == cnt_j
    np.testing.assert_array_equal(tri_t, tri_j)
    if case == "overflow":
        assert cnt_t > mt and (tri_t >= 0).all()
    elif case == "empty":
        assert cnt_t == 0 and (tri_t == -1).all()
    else:
        assert 0 < cnt_t <= mt and (tri_t[cnt_t:] == -1).all()


def test_popcount_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.integers(0, 2**32, (3, 7, 12), dtype=np.uint64).astype(np.uint32)
    w[0, 0, :4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    got = TE.popcount_total(words_to_torch(w, "cpu"))
    assert int(got) == int(JE.popcount_total(jnp.asarray(w)))
    per = TE.popcount_words(words_to_torch(w, "cpu")).numpy()
    np.testing.assert_array_equal(
        per, np.unpackbits(w.view(np.uint8)).reshape(*w.shape, 32).sum(-1))


def test_triples_words_roundtrip_and_expanders_match_jax():
    c = 384
    chg, new = _grids(3, c, 0.004, seed=4)
    chg[2, 10, 3] |= np.uint32(1 << 31)
    (tri_j, cnt), (tri_t, _) = _both(chg, new, c, 4096)
    tri = tri_t[:cnt]
    cv, ev, gi = TE.triples_to_words(tri, c)
    cv_j, ev_j, gi_j = JE.triples_to_words(tri, c)
    for a, b in ((cv, cv_j), (ev, ev_j), (gi, gi_j)):
        np.testing.assert_array_equal(a, b)
    flat = chg.reshape(-1)
    nz = np.nonzero(flat)[0]
    np.testing.assert_array_equal(gi, nz)
    np.testing.assert_array_equal(cv, flat[nz])
    np.testing.assert_array_equal(ev, flat[nz] & new.reshape(-1)[nz])
    pe, pl = TE.expand_classified_host(cv, ev, gi, c)
    pe_j, pl_j = JE.expand_classified_host(cv, ev, gi, c, 3)
    np.testing.assert_array_equal(pe, pe_j)
    np.testing.assert_array_equal(pl, pl_j)
    assert len(pe) + len(pl) == cnt
    empty = TE.triples_to_words(np.empty((0, 3), np.int32), c)
    assert all(len(a) == 0 for a in empty)
