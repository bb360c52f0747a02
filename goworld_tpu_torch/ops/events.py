"""Device-side compaction of the classified AOI diff into event triples,
plus the host expanders the overflow recovery needs.

Port of the JAX package's ``ops/events.py`` (``popcount_total``,
``extract_triples``) in PyTorch, and numpy copies of its host half
(``_expand_bits``, ``_sorted_pairs``, ``expand_classified_host``,
``triples_to_words``).

:func:`extract_triples` never waits for the device: ``jnp.nonzero(size=,
fill_value=-1)`` becomes a cumsum over the nonzero mask and a scatter into
an ``[mt + 1]`` buffer whose last row discards everything past the cap.
``torch.nonzero`` is not used -- it returns a data-dependent shape and so
synchronizes the host on CUDA.  Pass order, fill values and overflow
semantics are the JAX function's, so the two ``tri`` buffers compare equal
element for element.
"""

from __future__ import annotations

import numpy as np
import torch

from .aoi_predicate import WORD_BITS, words_per_row

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 words (SWAR; torch has no
    popcount).  ``>>`` on int32 is arithmetic, so every shifted term is
    masked before it is used; the final multiply wraps in int32 and its
    top byte (at most 32) is the count."""
    v = words - ((words >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return (v * _H01) >> 24


def popcount_total(words: torch.Tensor) -> torch.Tensor:
    """Total set bits in a packed int32 words tensor (any shape), as an
    int64 scalar tensor on the words' device."""
    return popcount_words(words).sum(dtype=torch.int64)


def _nonzero_fixed(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first ``size`` True entries of a 1-D mask, ascending,
    -1-filled: ``jnp.nonzero(mask, size=size, fill_value=-1)`` without a
    host sync."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    dest = torch.where(mask & (pos < size), pos, size)
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(n, device=mask.device))
    return out[:size]


def extract_triples(chg: torch.Tensor, new: torch.Tensor, capacity: int,
                    max_triples: int):
    """Classified diff words -> compact (observer, observed, kind) triples,
    on the words' device, with no host sync.

    ``chg``/``new`` are int32 planar words of any leading shape whose flat
    word order defines the observer: ``obs = flat_word // W`` (for the
    bucket grids [s_n, C, W] that is the global observer row ``s * C +
    i``).  ``kind`` is 1 for enter (the bit's NEW state), 0 for leave.

    Pass 1 keeps the first ``max_triples`` nonzero words, pass 2 the first
    ``max_triples`` set bits of those in (word, bit) order.  Returns
    ``(tri [max_triples, 3] int32, count)``: rows past the real triples
    are (-1, -1, -1); ``count`` is the exact number of set bits in
    ``chg``, so ``count > max_triples`` tells the caller the buffer is
    truncated and the tick must be recovered from the grids.
    """
    w = words_per_row(capacity)
    flat_c = chg.reshape(-1)
    flat_n = new.reshape(-1)
    count = popcount_total(chg)
    widx = _nonzero_fixed(flat_c != 0, max_triples)
    wsel = widx.clamp(min=0)
    ok = widx >= 0
    wvals = torch.where(ok, flat_c[wsel], 0)
    nvals = torch.where(ok, flat_n[wsel], 0)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=chg.device)
    bits = (wvals[:, None] >> shifts) & 1
    sel = _nonzero_fixed(bits.reshape(-1) != 0, max_triples)
    sp = sel.clamp(min=0)
    slot = sp // WORD_BITS
    k = sp % WORD_BITS
    g = widx[slot]
    obs = g // w
    j = k * w + g % w
    kind = (nvals[slot] >> k.to(torch.int32)) & 1
    valid = sel >= 0
    tri = torch.stack([torch.where(valid, obs, -1),
                       torch.where(valid, j, -1),
                       torch.where(valid, kind.to(torch.int64), -1)],
                      dim=1).to(torch.int32)
    return tri, count


# -- host expanders (numpy copies; harvest phase only) ----------------------


def _expand_bits(vals, flat_idx, capacity, w):
    """(word values, flat word indices) -> unsorted (s, i, j, widx, k)."""
    v8 = np.ascontiguousarray(vals.astype("<u4")).view(np.uint8)
    bits = np.unpackbits(v8.reshape(-1, 4), axis=1, bitorder="little")
    widx, k = np.nonzero(bits)
    fi = flat_idx[widx]
    s = fi // (capacity * w)
    rem = fi % (capacity * w)
    i = rem // w
    word = rem % w
    j = k * w + word  # planar layout: bit k of word -> column k*W + word
    return s, i, j, widx, k


def _sorted_pairs(s, i, j, capacity):
    out = np.stack([s, i, j], axis=1).astype(np.int32)
    # single int64 sort key (int32 would wrap at capacity >= ~46k)
    key = (s.astype(np.int64) * capacity + i) * capacity + j
    return out[np.argsort(key)]


def expand_classified_host(chg_vals, ent_vals, flat_idx, capacity: int):
    """Classified word stream (``chg`` words, their enter subsets ``chg &
    new``, flat word indices) -> (enter [K, 3], leave [L, 3]) int32
    (space, observer, observed) rows, each sorted lexicographically."""
    w = words_per_row(capacity)
    chg_vals = np.asarray(chg_vals)
    ent_vals = np.asarray(ent_vals)
    flat_idx = np.asarray(flat_idx)
    if chg_vals.size == 0:
        e = np.empty((0, 3), np.int32)
        return e, e
    s, i, j, widx, k = _expand_bits(chg_vals, flat_idx, capacity, w)
    is_ent = ((ent_vals[widx] >> k.astype(np.uint32)) & 1).astype(bool)
    return (_sorted_pairs(s[is_ent], i[is_ent], j[is_ent], capacity),
            _sorted_pairs(s[~is_ent], i[~is_ent], j[~is_ent], capacity))


def triples_to_words(tri, capacity: int):
    """Already-fetched VALID triples [n, 3] int32 -> the classified word
    stream ``(chg_vals u32 [K], ent_vals u32 [K], gidx i64 [K])`` with
    ``gidx`` ascending: the inverse of :func:`extract_triples` up to word
    grouping."""
    w = words_per_row(capacity)
    if len(tri) == 0:
        z = np.empty(0, np.uint32)
        return z, z, np.empty(0, np.int64)
    obs = tri[:, 0].astype(np.int64)
    j = tri[:, 1].astype(np.int64)
    ent = tri[:, 2] == 1
    g = obs * w + j % w
    bit = (j // w).astype(np.uint32)
    gidx = np.unique(g)
    grp = np.searchsorted(gidx, g)
    chg_vals = np.zeros(len(gidx), np.uint32)
    ent_vals = np.zeros(len(gidx), np.uint32)
    np.bitwise_or.at(chg_vals, grp, np.uint32(1) << bit)
    np.bitwise_or.at(ent_vals, grp[ent], np.uint32(1) << bit[ent])
    return chg_vals, ent_vals, gidx
