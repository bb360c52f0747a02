"""The AOI interest predicate and packed-bitmask layout (port copy).

The port's own copy of the JAX package's ``ops/aoi_predicate.py`` layout
helpers (numpy only), plus the numpy <-> torch word carry-over.

Predicate (square-range / Chebyshev interest, per-entity radius):

    interested(A, B) :=  A != B
                     and active(A) and active(B)
                     and |x_B - x_A| <= r_A   (float32)
                     and |z_B - z_A| <= r_A   (float32)

Only exactly-rounded IEEE-754 float32 operations (subtract, abs, compare)
are used, so every backend that keeps subnormals evaluates the same bits.

Packed-bitmask layout ("planar"): the boolean interest matrix M[N, C] packs
into 32-bit words[N, W], W = C // 32, where bit k of words[i, w] is
M[i, k * W + w] -- bit plane k is the contiguous column slice
M[:, k*W:(k+1)*W].

Word dtype: numpy carries words as ``np.uint32`` (the JAX package's
dtype); torch carries the SAME bits as ``torch.int32``, because
``torch.uint32`` lacks shifts, ``~`` and ``index_put`` on the CPU.
:func:`words_to_torch` / :func:`words_to_numpy` are the only crossings.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32

# Space capacities are a multiple of LANE so W is a multiple of 4 (the JAX
# package's lane rule; kept so both packages accept the same capacities,
# and the event stream's 128-word chunks tile a space).  The word layout
# and the step itself need only a multiple of WORD_BITS.
LANE = 128


def round_capacity(n: int) -> int:
    """Smallest valid space capacity >= n (multiple of LANE, min LANE)."""
    return max(LANE, -(-n // LANE) * LANE)


def words_per_row(capacity: int) -> int:
    """W = C / 32 words per row of the planar layout."""
    if capacity % WORD_BITS != 0:
        raise ValueError(f"capacity {capacity} not a multiple of "
                         f"{WORD_BITS}")
    return capacity // WORD_BITS


def check_capacity(capacity: int) -> int:
    """A space's capacity must be a multiple of LANE; returns its W."""
    if capacity % LANE != 0:
        raise ValueError(f"capacity {capacity} not a multiple of {LANE}")
    return words_per_row(capacity)


def interest_matrix(x: np.ndarray, z: np.ndarray, radius: np.ndarray,
                    active: np.ndarray, lo: int = 0,
                    hi: int | None = None) -> np.ndarray:
    """The predicate over one space in numpy, O(C^2): 1-D float32/bool
    arrays of length C (padded slots inactive) -> bool M[lo:hi, C],
    M[i, j] when entity i is interested in entity j (all C rows by
    default).  The host calculators (:mod:`.aoi_oracle`) and fault
    recovery evaluate it."""
    x = np.asarray(x, np.float32)
    z = np.asarray(z, np.float32)
    radius = np.asarray(radius, np.float32)
    active = np.asarray(active, bool)
    hi = len(x) if hi is None else hi
    dx = np.abs(x[None, :] - x[lo:hi, None])  # f32, exactly rounded
    dz = np.abs(z[None, :] - z[lo:hi, None])
    r = radius[lo:hi, None]
    m = (dx <= r) & (dz <= r)
    m &= active[lo:hi, None] & active[None, :]
    rows = np.arange(lo, hi)
    m[rows - lo, rows] = False  # self-interest excluded, like the kernel
    return m


def pack_rows(m: np.ndarray) -> np.ndarray:
    """Pack bool matrix [N, C] -> uint32 words [N, W] (planar layout)."""
    n, c = m.shape
    w = words_per_row(c)
    planes = m.reshape(n, WORD_BITS, w).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)[None, :, None]
    return (planes << shifts).sum(axis=1, dtype=np.uint32)


def unpack_rows(words: np.ndarray, capacity: int) -> np.ndarray:
    """Inverse of pack_rows: uint32 [N, W] -> bool [N, capacity]."""
    n, w = words.shape
    if w != words_per_row(capacity):
        raise ValueError(f"words width {w} != {words_per_row(capacity)}")
    shifts = np.arange(WORD_BITS, dtype=np.uint32)[None, :, None]
    planes = (words[:, None, :] >> shifts) & np.uint32(1)
    return planes.reshape(n, capacity).astype(bool)


_EVEN = np.uint32(0x55555555)
_M2 = np.uint32(0x33333333)
_M4 = np.uint32(0x0F0F0F0F)
_M8 = np.uint32(0x00FF00FF)
_M16 = np.uint32(0x0000FFFF)


def _compress_even_bits(v: np.ndarray) -> np.ndarray:
    """Pack the even bits of each uint32 into its low 16 bits (bit 2t ->
    bit t) -- the classic parallel-compress ladder, vectorized."""
    v = v & _EVEN
    v = (v | (v >> np.uint32(1))) & _M2
    v = (v | (v >> np.uint32(2))) & _M4
    v = (v | (v >> np.uint32(4))) & _M8
    v = (v | (v >> np.uint32(8))) & _M16
    return v


def repack_columns_double(words: np.ndarray, old_cap: int) -> np.ndarray:
    """Remap packed rows [R, W(old_cap)] to the 2*old_cap column layout
    without materializing the dense boolean matrix.

    Column j of capacity C lives at (word j % W, bit j // W).  Doubling C
    keeps j but W2 = 2W, so old (w, k) moves to (w + (k & 1) * W, k >> 1):
    the even bit-planes of word w compact into word w, the odd ones into
    word w + W."""
    r, w_old = words.shape
    if w_old != words_per_row(old_cap):
        raise ValueError(f"words width {w_old} != {words_per_row(old_cap)}")
    out = np.empty((r, 2 * w_old), np.uint32)
    out[:, :w_old] = _compress_even_bits(words)
    out[:, w_old:] = _compress_even_bits(words >> np.uint32(1))
    return out


def word_bit_for_column(j: int, capacity: int) -> tuple[int, int]:
    """(word index, bit index) holding column j in the planar layout."""
    w = words_per_row(capacity)
    return j % w, j // w


def pairs_from_words(words: np.ndarray, capacity: int) -> np.ndarray:
    """(i, j) index pairs of set bits from packed words, sorted
    lexicographically by (i, j).  Returns int32 array [n_pairs, 2].
    Expands only the nonzero words (never the dense [N, C] matrix)."""
    words = np.asarray(words, np.uint32)
    if words.shape[1] != words_per_row(capacity):
        raise ValueError(f"words width {words.shape[1]} != "
                         f"{words_per_row(capacity)}")
    rows, ws = np.nonzero(words)
    return pairs_from_sparse(rows, ws, words[rows, ws], capacity)


def pairs_from_sparse(rows: np.ndarray, ws: np.ndarray, vals: np.ndarray,
                      capacity: int) -> np.ndarray:
    """(i, j) pairs of the set bits of words ``vals`` (np.uint32) at (row,
    word) positions ``rows``, ``ws``, in any order, sorted by (i, j):
    int32 [n, 2]."""
    w = words_per_row(capacity)
    # little-endian bytes, each unpacked low bit first: flat bit f is bit
    # f % 32 of word f // 32
    le = np.ascontiguousarray(vals, "<u4").view(np.uint8)
    f = np.flatnonzero(np.unpackbits(le, bitorder="little").view(bool))
    k = f >> 5
    key = (np.asarray(rows, np.int64)[k] * capacity + (f & 31) * w
           + np.asarray(ws, np.int64)[k])
    key.sort()
    i = key // capacity
    return np.stack([i, key - i * capacity], axis=1).astype(np.int32)


def words_to_torch(words: np.ndarray, device) -> torch.Tensor:
    """Carry packed words into the port: np.uint32 [..., W] -> a NEW
    torch.int32 tensor on ``device`` holding the same bits."""
    a = np.ascontiguousarray(words, np.uint32).view(np.int32)
    return torch.tensor(a, device=device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Carry packed words out of the port: torch.int32 -> a NEW np.uint32
    array with the same bits (never a view of the tensor's memory)."""
    if words.dtype != torch.int32:
        raise TypeError(f"packed words are torch.int32, got {words.dtype}")
    a = words.detach().cpu().numpy()
    return np.array(a, copy=True).view(np.uint32)
