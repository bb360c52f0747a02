"""Paged, ragged storage for the AOI change stream.

Port of the JAX package's ``ops/aoi_pages.py``.  The capped layouts (the
single-device bucket's triple cap, the sharded buckets' chunk and escape
caps) share one failure class: one dense hotspot forces a global cap,
and the tick either overflows (the counted ``decode_overflow`` recovery
from the full grids) or the cap grows.  Here the flat [S, C, W] change
grid is split into fixed *bins* of ``BIN_ROWS`` entity rows; each bin gets
a page table sized by its own occupancy, and the pages come from one
shared device-resident free list, so a dense bin borrows the pages
sparse bins never needed.

A page holds ``PAGE_WORDS`` word entries ``(gidx, chg_word, new_word)``:
the stream the bucket's mirror XOR and publish consume, so decoding is a
validity filter (:func:`decode_pages`).  The allocator
(:func:`allocate_pages`) runs on the words' device with static shapes and
no host sync, so a CUDA graph can hold it: the hand-written kernel of
``csrc/pages.cu`` (:mod:`.pages_cuda`) on a CUDA tensor, the plain
PyTorch version :func:`allocate_pages_plain` on a CPU tensor.  Both
compute:

1. count the nonzero change words per bin; ``need = ceil(cnt /
   PAGE_WORDS)``;
2. grant bins in ascending order of need (stable) while the running
   total fits the pool; the rest *spill*;
3. granted bins take consecutive page ranks; each of their words lands
   at ``rank * PAGE_WORDS + slot`` of the pools;
4. the page ids are taken from the head of the free list and the list
   is rotated: the page table (``free[:n_used]``) is what the host
   fetches and validates (:func:`validate_page_table`).

Spilled bins are re-read from the kept change grid on the host
(:func:`spill_stream`): a counted degradation, never data loss.

The words are ``torch.int32`` (packed uint32 bit patterns), so a word
with bit 31 set is negative: the allocator tests ``!= 0`` only.  The
numpy helpers take uint32 host words, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pages_cuda as PC

# word entries per page
PAGE_WORDS = 64

# entity rows per allocation bin (a bin covers BIN_ROWS consecutive rows
# of the [S*C, W] word grid)
BIN_ROWS = 8

# width of the spilled-bin vector; more spills than this take the
# whole-tick spill (counted)
MAX_SPILL = 64


def bin_words_for(words_per_row: int) -> int:
    """Flat words per allocation bin for a grid with W words per row."""
    return max(1, words_per_row) * BIN_ROWS


def pool_floor(n_words: int) -> int:
    """Starting pool size (pages): 1/8 of full coverage, at least 64."""
    return max(64, n_words // PAGE_WORDS // 8)


def pool_ceiling(n_words: int, bin_words: int) -> int:
    """Pages that can never spill: full word coverage plus one page of
    ragged padding per bin."""
    n_bins = -(-n_words // bin_words)
    return -(-n_words // PAGE_WORDS) + n_bins


def allocate_pages(chg: torch.Tensor, new: torch.Tensor, free: torch.Tensor,
                   page_words: int = PAGE_WORDS, bin_words: int | None = None,
                   max_spill: int = MAX_SPILL, out=None, scratch=None):
    """THE allocator: ``csrc/pages.cu`` on CUDA tensors
    (:func:`.pages_cuda.allocate_pages_cuda`; a refused launch raises,
    nothing falls back), the plain version :func:`allocate_pages_plain`
    on CPU tensors.  ``out``: seven tensors or None to write the outputs
    into (the fused paged graph's static pools and bundle slices; the
    rotated free list's must not be ``free``); the outputs are returned
    either way.  ``scratch``: the kernel's scratch (the fused paged
    graph's static one), or None; the plain version needs none."""
    if bin_words is None:
        bin_words = bin_words_for(chg.shape[-1])
    if chg.device.type != "cpu":
        return PC.allocate_pages_cuda(chg, new, free, page_words, bin_words,
                                      max_spill, out, scratch)
    got = allocate_pages_plain(chg, new, free, page_words, bin_words,
                               max_spill)
    if out is None:
        return got
    PC.check_out(out, free.shape[0], got[5].shape[0], free)
    return tuple(g if o is None else o.copy_(g) for o, g in zip(out, got))


def allocate_pages_plain(chg: torch.Tensor, new: torch.Tensor,
                         free: torch.Tensor, page_words: int = PAGE_WORDS,
                         bin_words: int | None = None,
                         max_spill: int = MAX_SPILL):
    """The allocate-and-compact pass in plain PyTorch, bit-exact with the
    JAX package's ``allocate_pages`` (the kernel's plain version).

    ``chg`` / ``new``: int32 word grids of any shape (flattened here);
    ``free``: the free list, int32 [n_pages].  ``bin_words`` defaults to
    :func:`bin_words_for` of the grid's last axis.

    Returns ``(pool_g, pool_c, pool_n, page_tab, free_next, spill_bins,
    scalars)``: the pools int32 [n_pages, page_words] in rank order
    (``pool_g`` the flat word index, -1 off the valid entries),
    ``page_tab`` ``free[:n_used]`` padded with -1, ``free_next`` the free
    list rotated by ``n_used``, ``spill_bins`` the spilled bin ids
    ascending (-1 padded, width ``min(n_bins, max_spill)``) and
    ``scalars`` int32 ``[n_used, n_spill, nz_fit_words, nz_total_words]``.
    Static shapes, no host sync: the grant order comes from a stable
    argsort, the rotation from a gather and the compaction from a scatter
    into a buffer one slot longer, whose last slot takes every word that
    does not land and is cut off."""
    if bin_words is None:
        bin_words = bin_words_for(chg.shape[-1])
    dev = chg.device
    i32 = torch.int32
    n_pages = free.shape[0]
    flat_c = chg.reshape(-1)
    flat_n = new.reshape(-1)
    nw = flat_c.shape[0]
    n_bins = -(-nw // bin_words)
    nwp = n_bins * bin_words
    if nwp != nw:
        flat_c = torch.nn.functional.pad(flat_c, (0, nwp - nw))
        flat_n = torch.nn.functional.pad(flat_n, (0, nwp - nw))

    nz = (flat_c != 0).view(n_bins, bin_words)
    cnt = nz.sum(dim=1, dtype=i32)
    need = (cnt + (page_words - 1)) // page_words

    # feasibility: grant ascending by need while the pool lasts
    order = torch.argsort(need, stable=True)
    fit_sorted = torch.cumsum(need[order], 0, dtype=i32) <= n_pages
    fit = torch.empty_like(fit_sorted).index_copy_(0, order, fit_sorted)
    fit &= need > 0
    spill = (need > 0) & ~fit
    n_spill = spill.sum(dtype=i32)
    bin_ids = torch.arange(n_bins, dtype=i32, device=dev)
    spill_sorted = torch.sort(torch.where(
        spill, bin_ids, n_bins)).values[:max_spill]
    spill_bins = torch.where(spill_sorted < n_bins, spill_sorted, -1).to(i32)

    # page-rank allocation: granted bins take consecutive rank ranges
    zero = torch.zeros((), dtype=i32, device=dev)
    need_fit = torch.where(fit, need, zero)
    rank0 = torch.cumsum(need_fit, 0, dtype=i32) - need_fit
    n_used = need_fit.sum(dtype=i32)
    cnt_fit = torch.where(fit, cnt, zero)
    wrank0 = torch.cumsum(cnt_fit, 0, dtype=i32) - cnt_fit
    nz_fit = nz & fit[:, None]
    gcum = torch.cumsum(nz_fit.view(-1), 0, dtype=i32).view(n_bins, bin_words)
    within = gcum - 1 - wrank0[:, None]  # rank inside the word's own bin
    oob = n_pages * page_words
    dst = ((rank0[:, None] + within // page_words) * page_words
           + within % page_words)
    dst = torch.where(nz_fit, dst, oob).view(-1).to(torch.int64)

    def scatter(fill, src):
        out = torch.full((oob + 1,), fill, dtype=i32, device=dev)
        return out.index_copy_(0, dst, src)[:oob].view(n_pages, page_words)

    pool_g = scatter(-1, torch.arange(nwp, dtype=i32, device=dev))
    pool_c = scatter(0, flat_c)
    pool_n = scatter(0, flat_n)

    # logical page ids: consume the free-list head, rotate the remainder
    ar = torch.arange(n_pages, dtype=i32, device=dev)
    page_tab = torch.where(ar < n_used, free, -1).to(i32)
    free_next = free[((ar + n_used) % max(n_pages, 1)).to(torch.int64)]

    scalars = torch.stack([n_used, n_spill, cnt_fit.sum(dtype=i32),
                           cnt.sum(dtype=i32)])
    return pool_g, pool_c, pool_n, page_tab, free_next, spill_bins, scalars


def allocate_pages_host(chg, new, free, page_words: int, bin_words: int,  # gwlint: allow[host-sync] -- NumPy oracle
                        max_spill: int):
    """NumPy oracle of :func:`allocate_pages` (the JAX package's, copied):
    the same outputs on uint32 host words, the pools ``pool_c``/``pool_n``
    as uint32."""
    free = np.asarray(free, np.int32)
    n_pages = free.shape[0]
    flat_c = np.asarray(chg, np.uint32).reshape(-1)
    flat_n = np.asarray(new, np.uint32).reshape(-1)
    nw = flat_c.shape[0]
    n_bins = -(-nw // bin_words)
    nwp = n_bins * bin_words
    if nwp != nw:
        flat_c = np.pad(flat_c, (0, nwp - nw))
        flat_n = np.pad(flat_n, (0, nwp - nw))

    nz = flat_c != 0
    cnt = nz.reshape(n_bins, bin_words).sum(axis=1).astype(np.int32)
    need = (cnt + (page_words - 1)) // page_words

    order = np.argsort(need, kind="stable")
    fit_sorted = np.cumsum(need[order]) <= n_pages
    fit = np.zeros((n_bins,), bool)
    fit[order] = fit_sorted
    fit &= need > 0
    spill = (need > 0) & ~fit
    n_spill = np.int32(spill.sum())
    bin_ids = np.arange(n_bins, dtype=np.int32)
    spill_sorted = np.sort(np.where(spill, bin_ids, n_bins))[:max_spill]
    spill_bins = np.where(spill_sorted < n_bins, spill_sorted,
                          -1).astype(np.int32)

    need_fit = np.where(fit, need, 0)
    rank0 = np.cumsum(need_fit) - need_fit
    n_used = np.int32(need_fit.sum())
    cnt_fit = np.where(fit, cnt, 0)
    wrank0 = np.cumsum(cnt_fit) - cnt_fit
    nz_fit = nz & np.repeat(fit, bin_words)
    gcum = np.cumsum(nz_fit.astype(np.int32)) - 1
    word_bin = np.arange(nwp, dtype=np.int32) // bin_words
    within = gcum - wrank0[word_bin]

    pool_g = np.full((n_pages * page_words,), -1, np.int32)
    pool_c = np.zeros((n_pages * page_words,), np.uint32)
    pool_n = np.zeros((n_pages * page_words,), np.uint32)
    sel = np.nonzero(nz_fit)[0]
    dst = ((rank0[word_bin[sel]] + within[sel] // page_words) * page_words
           + within[sel] % page_words)
    keep = dst < n_pages * page_words
    pool_g[dst[keep]] = sel[keep].astype(np.int32)
    pool_c[dst[keep]] = flat_c[sel[keep]]
    pool_n[dst[keep]] = flat_n[sel[keep]]

    page_tab = np.where(np.arange(n_pages, dtype=np.int32) < n_used,
                        free, -1).astype(np.int32)
    free_next = np.roll(free, -int(n_used))
    scalars = np.array([n_used, n_spill, cnt_fit.sum(), cnt.sum()],
                       np.int32)
    return (pool_g.reshape(n_pages, page_words),
            pool_c.reshape(n_pages, page_words),
            pool_n.reshape(n_pages, page_words),
            page_tab, free_next, spill_bins, scalars)


def decode_pages(pool_g, pool_c, pool_n):  # gwlint: allow[host-sync] -- host decode of fetched pages
    """Fetched pool rows (host arrays; words as uint32 or int32 bit
    patterns) -> the ``(gidx, chg_vals, new_vals)`` word stream of the
    valid entries, in rank order (ascending flat index within each
    granted bin); the values as uint32."""
    g = np.asarray(pool_g).reshape(-1)
    ok = g >= 0
    return (g[ok],
            np.asarray(pool_c).reshape(-1)[ok].view(np.uint32),
            np.asarray(pool_n).reshape(-1)[ok].view(np.uint32))


def _host_words(a) -> np.ndarray:
    """A slice of words as host uint32 (a torch tensor is fetched)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).view(np.uint32)


def spill_stream(chg_flat, new_flat, spill_bins, bin_words: int,  # gwlint: allow[host-sync] -- spill-to-host fallback
                 n_words: int):
    """Re-read the spilled bins' word slices of the kept change/new grids
    (flat, on the host or on the device: one fetch per bin) -> ``(gidx,
    chg_vals, new_vals)``.  ``n_words`` clips the last ragged bin."""
    gs, cs, ns = [], [], []
    for b in np.asarray(spill_bins).reshape(-1):
        if b < 0:
            continue
        lo = int(b) * bin_words
        hi = min(lo + bin_words, n_words)
        csl = _host_words(chg_flat[lo:hi])
        idx = np.nonzero(csl)[0]
        if idx.size == 0:
            continue
        gs.append((idx + lo).astype(np.int64))
        cs.append(csl[idx])
        ns.append(_host_words(new_flat[lo:hi])[idx])
    if not gs:
        z = np.zeros((0,), np.int64)
        return z, z.astype(np.uint32), z.astype(np.uint32)
    return (np.concatenate(gs), np.concatenate(cs), np.concatenate(ns))


def validate_page_table(page_tab, n_used: int, n_pages: int) -> bool:  # gwlint: allow[host-sync] -- validates an already-fetched table
    """The fetched page table's integrity: the first ``n_used`` entries
    unique in-range page ids, the rest -1.  A failure means the free list
    is corrupt."""
    t = np.asarray(page_tab).reshape(-1)
    if t.shape[0] != n_pages or not 0 <= n_used <= n_pages:
        return False
    used, rest = t[:n_used], t[n_used:]
    if rest.size and not np.all(rest == -1):
        return False
    if used.size and (used.min() < 0 or used.max() >= n_pages
                      or np.unique(used).size != used.size):
        return False
    return True
