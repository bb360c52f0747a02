"""Plain PyTorch version of the AOI step (the kernel's reference).

Evaluates the predicate of :mod:`aoi_predicate` over all pairs of each
space, packs it into planar int32 words and XOR-diffs against the previous
tick.  This is what the CPU runs (the tests) and what the hand-written
kernel (:mod:`aoi_cuda`, ``csrc/aoi_step.cu``) is held to on the card,
bit for bit.  It is the counterpart of the JAX package's
``ops/aoi_dense.py`` (``interest_words_dense``, ``aoi_step_chg_dense``,
``aoi_step_dense_batched``).

The predicate is exactly ``|x_j - x_i| <= r_i & |z_j - z_i| <= r_i &
act_i & act_j & i != j`` in float32, computed as sub -> abs -> compare
(no squared distance).  Activity is applied with masks, never by folding
it into the coordinates.  Packing ORs the 32 bit planes together: a
``sum`` would promote int32 to int64 and the bit-31 plane would not wrap
back into the int32 word.
"""

from __future__ import annotations

import torch

from .aoi_predicate import WORD_BITS, words_per_row

# observer rows per evaluation block: bounds the [rows, C] boolean
# intermediate (16 MiB at C = 16384)
_ROW_BLOCK = 1024


def _pack_planes(m: torch.Tensor, w: int) -> torch.Tensor:
    """bool [R, 32 * W] -> int32 [R, W], bit k of word w = m[:, k*W + w]."""
    planes = m.view(m.shape[0], WORD_BITS, w)
    acc = planes[:, 0, :].to(torch.int32)
    for k in range(1, WORD_BITS):
        acc |= planes[:, k, :].to(torch.int32) << k
    return acc


def interest_words_dense(x, z, radius, active, cols=None,
                         row_ids=None) -> torch.Tensor:
    """Predicate over all pairs of one space, packed.  [C] f32 inputs
    (``active`` bool) -> [C, W] int32.

    Rectangular mode: with ``cols=(x_c, z_c, act_c)`` ([C_cols]) the row
    arrays are a block of C_rows observers evaluated against all C_cols
    candidates, ``row_ids`` ([C_rows] integer) their global column ids for
    self-exclusion, and the result is [C_rows, C_cols / 32]."""
    x_c, z_c, act_c = (x, z, active) if cols is None else cols
    c_rows, c = x.shape[0], x_c.shape[0]
    w = words_per_row(c)
    out = torch.empty((c_rows, w), dtype=torch.int32, device=x.device)
    col_ids = torch.arange(c, device=x.device)
    if row_ids is None:
        row_ids = torch.arange(c_rows, device=x.device)
    for lo in range(0, c_rows, _ROW_BLOCK):
        hi = min(lo + _ROW_BLOCK, c_rows)
        r = radius[lo:hi, None]
        m = (x_c[None, :] - x[lo:hi, None]).abs() <= r
        m &= (z_c[None, :] - z[lo:hi, None]).abs() <= r
        m &= active[lo:hi, None] & act_c[None, :]
        m &= row_ids[lo:hi, None] != col_ids[None, :]
        out[lo:hi] = _pack_planes(m, w)
    return out


def _new_words(x, z, radius, active, prev_words, cols, row_ids):
    """[S, C_rows, W] new words of a batched step (see
    :func:`interest_words_dense`)."""
    if x.shape[0] == 0:
        return torch.empty_like(prev_words)
    return torch.stack([interest_words_dense(
        x[s], z[s], radius[s], active[s],
        cols=None if cols is None else tuple(t[s] for t in cols),
        row_ids=None if row_ids is None else row_ids[s])
        for s in range(x.shape[0])])


def aoi_step_chg_dense(x, z, radius, active, prev_words, cols=None,
                       row_ids=None):
    """Batched ``emit="chg"`` step: [S, C] inputs and [S, C, W] int32
    ``prev_words`` -> ``(new, new ^ prev)``, both [S, C, W] int32.  With
    ``cols=(x_c, z_c, act_c)`` ([S, C_cols]) and ``row_ids`` ([S, C_rows])
    it is the rectangular step: [S, C_rows] rows, [S, C_rows, C_cols / 32]
    words (see :func:`interest_words_dense`)."""
    new = _new_words(x, z, radius, active, prev_words, cols, row_ids)
    return new, new ^ prev_words


def aoi_step_entlv_dense(x, z, radius, active, prev_words, cols=None,
                         row_ids=None):
    """Batched ``emit="entlv"`` step (the JAX package's
    ``aoi_step_dense_batched`` and the Pallas kernel's default mode):
    -> ``(new, new & ~prev, prev & ~new)``, all int32 words shaped like
    ``prev_words``; square or rectangular as :func:`aoi_step_chg_dense`."""
    new = _new_words(x, z, radius, active, prev_words, cols, row_ids)
    return new, new & ~prev_words, prev_words & ~new
