"""Device-side compaction of the AOI diff (event triples for the engine
bucket, the row-stream codec for the giant-capacity path), plus the host
decoders and expanders.

Port of the JAX package's ``ops/events.py`` (``popcount_total``,
``extract_triples``, ``extract_chunks``, ``encode_row_stream``) in
PyTorch, and numpy copies of its host half (``decode_row_stream``,
``_expand_bits``, ``_sorted_pairs``, ``expand_words_host``,
``expand_classified_host``, ``triples_to_words``).

The three device entries (``extract_triples``, ``extract_chunks``,
``encode_row_stream``) dispatch on the device: a CUDA tensor launches
the hand-written kernel of ``csrc/events.cu`` (:mod:`.events_cuda`; a
refused launch raises, nothing falls back), a CPU tensor runs the plain
version beside it (``*_plain``).  ``popcount_total`` stays plain PyTorch.

The plain versions never wait for the device: ``jnp.nonzero(size=,
fill_value=-1)`` and the top-k selections of ascending indices become a
cumsum over the mask and a scatter into a buffer whose last row discards
everything past the cap.  ``torch.nonzero`` and ``.item()`` are not used
-- they synchronize the host on CUDA.  Pass order, fill values, caps and
overflow semantics are the JAX functions', so every output buffer
compares equal element for element (uint32 words carried as int32), and
the kernels are held to the plain versions the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from . import events_cuda as EC
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
    out.scatter_(0, dest, torch.arange(n, dtype=torch.int64,
                                       device=mask.device))
    return out[:size]


def extract_triples(chg: torch.Tensor, new: torch.Tensor, capacity: int,
                    max_triples: int):
    """THE triple extraction: ``csrc/events.cu`` on CUDA tensors
    (:func:`.events_cuda.extract_triples_cuda`), the plain version
    :func:`extract_triples_plain` on CPU tensors."""
    if chg.device.type == "cpu":
        return extract_triples_plain(chg, new, capacity, max_triples)
    return EC.extract_triples_cuda(chg, new, capacity, max_triples)


def extract_triples_plain(chg: torch.Tensor, new: torch.Tensor,
                          capacity: int, max_triples: int):
    """Classified diff words -> compact (observer, observed, kind) triples,
    on the words' device, with no host sync: the plain PyTorch version of
    ``csrc/events.cu`` ``gw_extract_triples``.

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


# -- the row-stream codec (giant-capacity device-cadence path) ---------------


def extract_chunks(words: torch.Tensor, max_chunks: int, k: int, aux=None,
                   lanes: int = 128):
    """THE chunk extraction: ``csrc/events.cu`` on CUDA tensors
    (:func:`.events_cuda.extract_chunks_cuda`), the plain version
    :func:`extract_chunks_plain` on CPU tensors."""
    if words.device.type == "cpu":
        return extract_chunks_plain(words, max_chunks, k, aux, lanes)
    return EC.extract_chunks_cuda(words, max_chunks, k, aux, lanes)


def extract_chunks_plain(words: torch.Tensor, max_chunks: int, k: int,
                         aux=None, lanes: int = 128):
    """Chunk-compacted extraction over ``lanes``-word windows (the plain
    PyTorch version of ``csrc/events.cu`` ``gw_extract_chunks``).

    Views the int32 words as rows of ``lanes`` words and keeps the first
    ``max_chunks`` dirty rows (ascending), and in each the first ``k``
    nonzero words in lane order, with ``aux`` (e.g. the NEW words)
    gathered at the same slots.  Returns ``(vals [max_chunks, kk] int32,
    aux_vals | None, lane [max_chunks, kk] int32 (-1 fill), csel
    [max_chunks] int32 ascending dirty-row indices, ccnt [max_chunks] int32
    true per-row word counts, n_dirty, max_ccnt)`` with ``kk = min(k,
    lanes)``; global word index of slot ``(c, t)`` is ``csel[c] * lanes +
    lane[c, t]``.  ``n_dirty > max_chunks`` or ``max_ccnt > k`` means the
    stream is incomplete; both scalars are exact regardless.  Equal
    element for element to the JAX package's ``extract_chunks`` (its
    top-k of dirty rows and its per-slot masked sums become a cumsum and
    scatters into buffers with a discard column, so nothing waits for
    the device)."""
    flat = words.reshape(-1, lanes)
    nc = flat.shape[0]
    dev = words.device
    nz = flat != 0
    ccnt_full = nz.sum(1, dtype=torch.int32)
    dirty = ccnt_full > 0
    n_dirty = dirty.sum(dtype=torch.int32)
    max_ccnt = ccnt_full.max() if nc else torch.zeros((), dtype=torch.int32,
                                                      device=dev)
    mc = min(max_chunks, nc)
    cidx = _nonzero_fixed(dirty, mc)
    valid_c = cidx >= 0
    csel = cidx.clamp(min=0)
    chunks = torch.where(valid_c[:, None], flat[csel], 0)
    nz2 = chunks != 0
    pos = torch.cumsum(nz2, 1, dtype=torch.int32) - 1
    kk = min(k, lanes)
    # each nonzero word lands in slot pos (when pos < kk); the rest go to
    # the discard column kk
    dest = torch.where(nz2 & (pos < kk), pos, kk).to(torch.int64)

    def compact(src, fill):
        out = torch.full((mc, kk + 1), fill, dtype=torch.int32, device=dev)
        return out.scatter_(1, dest, src)[:, :kk]

    vals = compact(chunks, 0)
    lane_ids = torch.arange(lanes, dtype=torch.int32, device=dev)
    lane = compact(lane_ids.expand(mc, lanes), -1)
    aux_vals = None
    if aux is not None:
        achunks = aux.reshape(-1, lanes)[csel]
        aux_vals = compact(achunks, 0)
    ccnt = torch.where(valid_c, ccnt_full[csel], 0)
    vals, lane = _pad(vals, max_chunks, 0), _pad(lane, max_chunks, -1)
    csel = _pad(csel.to(torch.int32), max_chunks, 0)
    ccnt = _pad(ccnt, max_chunks, 0)
    if aux_vals is not None:
        aux_vals = _pad(aux_vals, max_chunks, 0)
    return vals, aux_vals, lane, csel, ccnt, n_dirty, max_ccnt


_ROW_SLOTS = 2  # word slots shipped inline per row; the tail rides exc


def encode_row_stream(vals, new_vals, widx, rsel, rcnt, *, w: int,
                      max_gaps: int = 2048, max_exc: int = 16384):
    """THE row-stream encode: ``csrc/events.cu`` on CUDA tensors
    (:func:`.events_cuda.encode_row_stream_cuda`), the plain version
    :func:`encode_row_stream_plain` on CPU tensors."""
    if vals.device.type == "cpu":
        return encode_row_stream_plain(vals, new_vals, widx, rsel, rcnt, w=w,
                                       max_gaps=max_gaps, max_exc=max_exc)
    return EC.encode_row_stream_cuda(vals, new_vals, widx, rsel, rcnt, w=w,
                                     max_gaps=max_gaps, max_exc=max_exc)


def encode_row_stream_plain(vals, new_vals, widx, rsel, rcnt, *, w: int,
                            max_gaps: int = 2048, max_exc: int = 16384):
    """Compress a row-extracted change stream for D2H (about 1 B per row
    plus 2-3 B per single-bit word): the port of the JAX package's
    ``encode_row_stream``, equal to it element for element, and the plain
    PyTorch version of ``csrc/events.cu`` ``gw_encode_row_stream``.

    Per row ONE byte: row-index delta in bits 0-5 (63 = escaped, absolute
    index in ``esc_rows``) and ``min(rcnt, 2) - 1`` in bit 6.  Two inline
    word slots per row: ``bitpos`` u8 (bit position 0-4, bit 5 = the bit's
    NEW state i.e. enter; 255 = multi-bit word, shipped as an exception)
    and ``woff`` (word index within the row, uint8 when ``w <= 256`` else
    uint16).  Words beyond slot 2 and multi-bit words ship as absolute
    exception triples ``(gidx, chg, new)``, ascending.

    Returns ``(rowb u8 [mr], bitpos u8 [mr, 2], woff [mr, 2], base_row,
    n_esc, esc_rows int32 [max_gaps], exc_gidx int32 [max_exc], exc_chg
    int32 [max_exc], exc_new int32 [max_exc], exc_n)``; ``n_esc >
    max_gaps`` or ``exc_n > max_exc`` means the stream is incomplete.
    Decode with :func:`decode_row_stream`."""
    mr, k = vals.shape
    dev = vals.device
    slot = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    valid = slot < torch.clamp(rcnt, max=k)[:, None]
    has_row = rcnt > 0
    prev_r = torch.cat([rsel[:1], rsel[:-1]])
    rd = rsel - prev_r
    esc = has_row & (rd >= 63)
    db = torch.where(esc, 63, rd)
    nv2 = torch.clamp(rcnt, 1, _ROW_SLOTS) - 1
    rowb = torch.where(has_row, (db | (nv2 << 6)) & 0xFF, 0).to(torch.uint8)
    n_esc = esc.sum(dtype=torch.int32)
    epos = _nonzero_fixed(esc, min(max_gaps, mr))
    esc_rows = torch.where(epos >= 0, rsel[epos.clamp(min=0)], -1)
    esc_rows = _pad(esc_rows.to(torch.int32), max_gaps, -1)

    pc = popcount_words(vals)
    v64 = vals.to(torch.int64) & 0xFFFFFFFF
    ctz = popcount_words((v64 ^ (v64 - 1)).to(torch.int32)) - 1
    enter = (new_vals >> ctz.clamp(min=0)) & 1
    single = valid & (pc == 1)
    bitpos = torch.where(single, ctz | (enter << 5), 255)[:, :_ROW_SLOTS]
    bitpos = bitpos.to(torch.uint8)
    woff = torch.where(valid, widx, 0)[:, :_ROW_SLOTS]
    woff = woff.to(torch.uint8 if w <= 256 else torch.uint16)
    base_row = rsel[0]

    exc_mask = (valid & ((slot >= _ROW_SLOTS) | (pc > 1))).reshape(-1)
    exc_n = exc_mask.sum(dtype=torch.int32)
    sel = _nonzero_fixed(exc_mask, min(max_exc, mr * k))
    ok = sel >= 0
    sp = sel.clamp(min=0)
    gidx_grid = (rsel[:, None] * w + widx.clamp(min=0)).reshape(-1)
    exc_gidx = _pad(torch.where(ok, gidx_grid[sp], -1), max_exc, -1)
    exc_chg = _pad(torch.where(ok, vals.reshape(-1)[sp], 0), max_exc, 0)
    exc_new = _pad(torch.where(ok, new_vals.reshape(-1)[sp], 0), max_exc, 0)
    return (rowb, bitpos, woff, base_row, n_esc, esc_rows,
            exc_gidx, exc_chg, exc_new, exc_n)


def _pad(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``a`` with rows of ``fill`` appended up to ``n`` rows."""
    if a.shape[0] >= n:
        return a
    tail = torch.full((n - a.shape[0], *a.shape[1:]), fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, tail])


def decode_row_stream(rowb, bitpos, woff, base_row, n_dirty, w,  # gwlint: allow[host-sync] -- host-side decoder: consumes the already-drained stream
                      esc_rows, exc_gidx, exc_chg, exc_new):
    """Host-side (numpy) inverse of :func:`encode_row_stream`, on the
    already-fetched host copies of the stream (``exc_chg``/``exc_new`` as
    uint32 or int32 bits).

    Returns ``(chg_vals u32 [K], ent_vals u32 [K], gidx i64 [K])``:
    ``ent_vals`` are the enter-bit subsets (``chg & new``).  The caller
    checks the overflow contracts (``n_dirty`` against the row cap,
    ``n_esc`` against the escape slice, ``exc_n`` against the exception
    slice) before decoding."""
    nd = int(n_dirty)
    outs_c, outs_e, outs_g = [], [], []
    if nd > 0:
        rowb = np.asarray(rowb)[:nd]
        bitpos = np.asarray(bitpos)[:nd]
        woff = np.asarray(woff)[:nd]
        d = (rowb & 63).astype(np.int64)
        d[0] = 0
        esc_at = np.nonzero((rowb & 63) == 63)[0]
        rows = int(base_row) + np.cumsum(d)
        if len(esc_at):
            er = np.asarray(esc_rows)[:len(esc_at)].astype(np.int64)
            # reset the running index at each escape: add the correction of
            # the most recent escape at or before each row
            corr = er - rows[esc_at]
            which = np.searchsorted(esc_at, np.arange(nd), side="right") - 1
            adj = np.where(which >= 0, corr[np.maximum(which, 0)], 0)
            rows = rows + adj
        nv2 = ((rowb >> 6) & 1).astype(np.int32) + 1
        valid = np.arange(_ROW_SLOTS, dtype=np.int32)[None, :] < nv2[:, None]
        single = bitpos < 64
        m = valid & single
        bp = bitpos[m]
        outs_c.append(np.uint32(1) << (bp & 31).astype(np.uint32))
        outs_e.append(np.where(((bp >> 5) & 1) == 1, outs_c[-1],
                               np.uint32(0)))
        outs_g.append((rows[:, None] * w + woff.astype(np.int64))[m])
    keep = np.asarray(exc_gidx) >= 0
    if keep.any():
        ec = np.asarray(exc_chg)[keep].view(np.uint32)
        en = np.asarray(exc_new)[keep].view(np.uint32)
        outs_c.append(ec)
        outs_e.append(ec & en)
        outs_g.append(np.asarray(exc_gidx)[keep].astype(np.int64))
    if not outs_c:
        z = np.empty(0, np.uint32)
        return z, z, np.empty(0, np.int64)
    return (np.concatenate(outs_c), np.concatenate(outs_e),
            np.concatenate(outs_g))


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


def expand_words_host(vals, flat_idx, capacity: int):  # gwlint: allow[host-sync] -- host-side expansion of the drained stream
    """Words (any value dtype holding uint32 bits) at flat word indices
    (``-1`` entries are dropped) -> int32 [K, 3] (space, observer,
    observed) rows, sorted lexicographically."""
    w = words_per_row(capacity)
    vals = np.asarray(vals)
    flat_idx = np.asarray(flat_idx)
    keep = flat_idx >= 0
    vals, flat_idx = vals[keep], flat_idx[keep]
    if vals.size == 0:
        return np.empty((0, 3), np.int32)
    s, i, j, _, _ = _expand_bits(vals, flat_idx, capacity, w)
    return _sorted_pairs(s, i, j, capacity)


def expand_classified_host(chg_vals, ent_vals, flat_idx, capacity: int):  # gwlint: allow[host-sync,flush-phase] -- host-side expansion of the drained stream: harvest feeds it decoded values after the fetch
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
