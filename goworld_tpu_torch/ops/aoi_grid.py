"""Block-culled AOI words and step for large capacities.

Port of the JAX package's ``ops/aoi_grid.py``.  Each space's slots are put
in x order once (:func:`sort_spaces`), so index-contiguous groups are
spatially compact; the kernels then skip every (row block, column group)
step whose widened x windows are disjoint, while the words stay the dense
definition's bit for bit.  The order only needs to be roughly sorted: the
bounds come from the data, so a stale order widens windows and never
drops a pair.

On CUDA tensors :func:`aoi_words_culled` and :func:`aoi_step_culled`
launch the hand-written kernels of ``csrc/aoi_grid.cu`` (and raise if a
launch is refused -- there is no fallback); on CPU tensors they run the
plain versions, which are the dense words of :mod:`aoi_dense` plus the
kernels' culled fraction from :func:`vote_fraction`.  ``launches`` counts
kernel launches per kernel, and nothing else.

The kernels are persistent: :func:`culled_plan` (the step) and
:func:`words_plan` (the words pass, whose units hold at most
``WORDS_UNIT_TILES`` row tiles) size the grid from what fits on the card
and cut the work into the dense step's units (see :mod:`.aoi_cuda`).
Both kernels decide the cull per (64-row tile, 32-word group, plane) by
the same rule, so their culled fractions are equal; :func:`tile_votes`
is that decision's plain version.

The culled fraction has one meaning on both devices: the share of
(64-row tile, 32-word group, plane) steps the kernels' vote skips.  It is
not the JAX package's fraction, which counts its own ``(block_rows,
col_words)`` blocks; :func:`cull_table` keeps that table and fraction.

One repair against the JAX package: its cull table widens every bound by
a margin built from ``max(radius)`` over all slots, so one NaN radius
makes every bound NaN and culls every block (the words come out empty).
Here non-finite radii and NaN positions never widen or poison a bound;
a row block holding an active +inf radius needs every column group.  On
finite inputs the table is the JAX package's exactly.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .aoi_cuda import StepPlan, check_inputs, occupancy, step_plan
from .aoi_dense import aoi_step_chg_dense
from .aoi_predicate import WORD_BITS, words_per_row

# kernel launches by kernel name; reset by whoever reads them
launches = {"aoi_words_culled": 0, "aoi_step_culled": 0}
# the StepPlan of each kernel's last launch
last_plan: dict[str, StepPlan] = {}

_INF = float("inf")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def legal_blocks(c: int, block_rows: int, col_words: int) -> tuple[int, int]:
    """``(ti, wb)``: the row block and word window the JAX package's
    culled kernels use for ``block_rows``/``col_words`` at capacity
    ``c`` (its ``_legal_blocks``, without the TPU lane rule)."""
    w = words_per_row(c)
    if block_rows <= 0 or col_words < 0:
        raise ValueError(f"block_rows {block_rows} / col_words {col_words}")
    ti = min(block_rows, c)
    if ti != c:
        ti = (ti // 128) * 128
        if ti == 0 or c % ti != 0:
            ti = c
    wb = col_words or min(w, 512)
    while w % wb:
        wb //= 2
    return ti, wb


def cull_table(x, radius, active, block_rows: int = 128, col_words: int = 0):
    """``need[s, bi, wo, k]`` (int32) and the culled fraction (f32 scalar)
    of the JAX package's cull table (``_cull_table``) for [S, C] inputs.

    Row block ``bi`` (``ti`` rows) reaches x in ``[min(x - r), max(x +
    r)]`` over its active rows; column group ``(wo, k)`` covers slots
    ``[k*W + wo*wb, k*W + (wo+1)*wb)`` and spans ``[min x, max x]`` over
    its active slots; both are widened by ``1e-3 + 1e-5 * (max active |x|
    + max r)``.  Only finite positions and radii enter the bounds and the
    margin, and a row block with an active +inf radius needs every group,
    so the table can only admit (see the module docstring)."""
    s, c = x.shape
    ti, wb = legal_blocks(c, block_rows, col_words)
    w = words_per_row(c)
    n_bi, n_wo = c // ti, w // wb
    fin_x = torch.isfinite(x)
    fin_r = torch.isfinite(radius)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    ninf = torch.full((), -_INF, dtype=torch.float32, device=x.device)
    ax = torch.where(active & fin_x, x.abs(), zero).amax() if x.numel() \
        else zero
    rm = torch.where(fin_r, radius, ninf).amax() if x.numel() else zero
    rm = torch.where(torch.isinf(rm), zero, rm)  # no finite radius at all
    margin = torch.tensor(1e-3, dtype=torch.float32, device=x.device) + \
        torch.tensor(1e-5, dtype=torch.float32, device=x.device) * (ax + rm)
    row_in = (active & fin_x & fin_r).reshape(s, n_bi, ti)
    xr = x.reshape(s, n_bi, ti)
    rr = radius.reshape(s, n_bi, ti)
    row_lo = torch.where(row_in, xr - rr, _INF).amin(2) - margin
    row_hi = torch.where(row_in, xr + rr, -_INF).amax(2) + margin
    all_cols = (active & (radius == _INF)).reshape(s, n_bi, ti).any(2)
    col_in = (active & fin_x).reshape(s, WORD_BITS, n_wo, wb)
    xc = x.reshape(s, WORD_BITS, n_wo, wb)
    col_lo = torch.where(col_in, xc, _INF).amin(3)
    col_hi = torch.where(col_in, xc, -_INF).amax(3)
    need = ((col_lo[:, None] <= row_hi[:, :, None, None])
            & (col_hi[:, None] >= row_lo[:, :, None, None]))
    need |= all_cols[:, :, None, None]
    need = need.transpose(2, 3).to(torch.int32)  # -> [s, bi, wo, k]
    culled_frac = 1.0 - need.to(torch.float32).mean()
    return need, culled_frac


def _pad_last(t, n, value):
    """``t`` padded along its last dimension to ``n`` with ``value``."""
    if t.shape[-1] == n:
        return t
    fill = torch.full((*t.shape[:-1], n - t.shape[-1]), value, dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, fill], -1)


def _fma_f32(a, b: float, c: float):
    """``fl32(a * b + c)`` rounded once, as a float32 fused multiply-add
    rounds it (``a`` float32; ``b``, ``c`` taken as float32): the product
    is exact in float64, the sum is rounded to odd there (TwoSum's error
    decides the last bit), and float64 -> float32 then rounds as one
    rounding of the exact value would."""
    b32 = torch.tensor(b, dtype=torch.float32).item()
    c32 = torch.tensor(c, dtype=torch.float32).item()
    p = a.double() * b32
    s = p + c32
    t = s - p
    err = (p - (s - t)) + (c32 - t)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even, torch.nextafter(s, s + err), s)
    return s.float()


def tile_votes(x, radius, active):
    """``need[s, t, g]`` (int64, bits 0-31): the planes the CUDA kernels
    test for 64-row tile ``t`` and 32-word group ``g`` of [S, C] inputs
    in slot order, and the culled (tile, group, plane) steps they count.

    Plane ``k`` of group ``g`` holds the columns ``j = k*W + 32g + l``
    (``l < 32``, ``32g + l < W``); it spans ``[min x, max x]`` over those
    active with a finite x.  The tile reaches ``[min(x - r), max(x + r)]``
    over its active rows with finite x and r, widened by ``m = 1e-3 +
    1e-5 * max(|x| + |r|)`` over the same rows (one fused multiply-add in
    the kernels); a tile holding an active r = +inf needs every plane.
    Float32 throughout, the margin rounded once."""
    s, c = x.shape
    w = words_per_row(c)
    rt, gr = -(-c // 64), -(-w // 32)
    row_in = _pad_last(active & torch.isfinite(x) & torch.isfinite(radius),
                       rt * 64, False).reshape(s, rt, 64)
    xr = _pad_last(x, rt * 64, 0.0).reshape(s, rt, 64)
    rr = _pad_last(radius, rt * 64, 0.0).reshape(s, rt, 64)
    lo = torch.where(row_in, xr - rr, _INF).amin(2)
    hi = torch.where(row_in, xr + rr, -_INF).amax(2)
    mag = torch.where(row_in, xr.abs() + rr.abs(), 0.0).amax(2)
    every = _pad_last(active & (radius == _INF), rt * 64,
                      False).reshape(s, rt, 64).any(2)
    m = _fma_f32(mag, 1e-5, 1e-3)
    col_in = _pad_last((active & torch.isfinite(x)).reshape(s, WORD_BITS, w),
                       gr * 32, False).reshape(s, WORD_BITS, gr, 32)
    xc = _pad_last(x.reshape(s, WORD_BITS, w), gr * 32,
                   0.0).reshape(s, WORD_BITS, gr, 32)
    col_lo = torch.where(col_in, xc, _INF).amin(3).transpose(1, 2)
    col_hi = torch.where(col_in, xc, -_INF).amax(3).transpose(1, 2)
    need = ((col_lo[:, None] <= (hi + m)[:, :, None, None])
            & (col_hi[:, None] >= (lo - m)[:, :, None, None]))
    need |= every[:, :, None, None]  # [s, t, g, k]
    bits = torch.arange(WORD_BITS, dtype=torch.int64, device=x.device)
    return (need.to(torch.int64) << bits).sum(3)


# -- plain versions (what the CPU runs; the kernels' references) -------------


def vote_fraction(x, radius, active):
    """The kernels' culled fraction (f32 scalar) for [S, C] inputs: the
    share of (tile, group, plane) steps :func:`tile_votes` skips, rounded
    as the wrappers round theirs (the count's ratio in float64, then
    float32)."""
    need = tile_votes(x, radius, active)
    n = need.numel() * WORD_BITS
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    bits = torch.arange(WORD_BITS, dtype=torch.int64, device=x.device)
    kept = ((need[..., None] >> bits) & 1).sum()
    return ((n - kept).to(torch.float64) / n).to(torch.float32)


def aoi_words_culled_plain(x, z, radius, active):
    """``(words [S, C, W] int32, culled_frac)``: the dense words and the
    kernels' culled fraction (:func:`vote_fraction`)."""
    check_inputs(x, z, radius, active, None)
    s, c = x.shape
    zero = torch.zeros((s, c, words_per_row(c)), dtype=torch.int32,
                       device=x.device)
    words, _ = aoi_step_chg_dense(x, z, radius, active, zero)
    return words, vote_fraction(x, radius, active)


def aoi_step_culled_plain(x, z, radius, active, prev_words):
    """``(new, new ^ prev, culled_frac)`` as :func:`aoi_words_culled_plain`
    computes them."""
    check_inputs(x, z, radius, active, prev_words)
    new, chg = aoi_step_chg_dense(x, z, radius, active, prev_words)
    return new, chg, vote_fraction(x, radius, active)


# -- the kernels ---------------------------------------------------------------


# row tiles a unit of the words kernel holds at most: its rows are staged
# in shared memory (csrc/aoi_grid.cu UNIT_TILES)
WORDS_UNIT_TILES = 32


def culled_plan(s: int, c: int, n_sms: int, blocks_per_sm: int,
                max_tiles: int | None = None) -> StepPlan:
    """The persistent culled step's plan for S spaces of capacity C (the
    dense step's walk, :func:`.aoi_cuda.step_plan`, over the square
    [S, C, C / 32] words); ``max_tiles`` caps the row tiles a unit
    holds (:func:`words_plan`).  Raises ValueError on a shape the kernels
    refuse."""
    if c % WORD_BITS != 0:
        raise ValueError(f"culled_plan: capacity {c} not a multiple of "
                         f"{WORD_BITS}")
    return step_plan(s, c, c // WORD_BITS, n_sms, blocks_per_sm, max_tiles)


def words_plan(s: int, c: int, n_sms: int, blocks_per_sm: int) -> StepPlan:
    """The words kernel's plan: :func:`culled_plan` with at most
    ``WORDS_UNIT_TILES`` row tiles a unit."""
    return culled_plan(s, c, n_sms, blocks_per_sm, WORDS_UNIT_TILES)


def _lib():
    fn = _build.library("aoi_grid").gw_aoi_culled
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2 + \
            [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p] + \
            [ctypes.c_int64] * 2
    return fn


def _launch(name, x, z, radius, active, prev_words):
    if x.device.type != "cuda":
        raise ValueError(f"the culled kernels run on CUDA tensors, got "
                         f"{x.device}")
    ins = [t.contiguous() for t in (x, z, radius, active)]
    s, c = x.shape
    shape = (s, c, words_per_row(c))
    new = torch.empty(shape, dtype=torch.int32, device=x.device)
    prev = chg = None
    if prev_words is not None:
        prev = prev_words.contiguous()
        chg = torch.empty(shape, dtype=torch.int32, device=x.device)
    # the culled steps and the words kernel's unit queue
    skipped = torch.zeros(2, dtype=torch.int64, device=x.device)
    if s == 0 or c == 0:
        return new, chg, skipped[0].to(torch.float32)
    tiles = ctypes.c_int64(0)
    fn = _lib()
    plan = (culled_plan if prev is not None else words_plan)(
        s, c, *occupancy("aoi_grid", "gw_aoi_culled_occupancy",
                         int(prev is not None), x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins),
                None if prev is None else prev.data_ptr(), new.data_ptr(),
                None if chg is None else chg.data_ptr(), skipped.data_ptr(),
                s, c, ctypes.byref(tiles), stream, plan.grid, plan.tiles)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    last_plan[name] = plan
    frac = (skipped[0].to(torch.float64) / max(tiles.value, 1)).to(
        torch.float32)
    return new, chg, frac


def aoi_words_culled_cuda(x, z, radius, active):
    """Launch the words kernel: ``(words [S, C, W] int32, culled_frac f32
    device scalar)``."""
    check_inputs(x, z, radius, active, None)
    new, _, frac = _launch("aoi_words_culled", x, z, radius, active, None)
    return new, frac


def aoi_step_culled_cuda(x, z, radius, active, prev_words):
    """Launch the step kernel: ``(new, chg, culled_frac)``."""
    check_inputs(x, z, radius, active, prev_words)
    return _launch("aoi_step_culled", x, z, radius, active, prev_words)


# -- the entries -----------------------------------------------------------------


def aoi_words_culled(x, z, radius, active, *, block_rows=128, col_words=0):
    """Packed interest words for the current positions, with block
    culling: [S, C] inputs in the caller's (x-sorted) slot order ->
    ``(words [S, C, W] int32, culled_frac f32 scalar)``, the fraction the
    kernels' vote skips on either device.  The kernel on CUDA tensors,
    the plain version on CPU tensors.  ``block_rows`` and ``col_words``
    are the JAX package's tiles, checked as it checks them and otherwise
    unused (its fraction at those tiles is :func:`cull_table`'s)."""
    legal_blocks(x.shape[1], block_rows, col_words)
    if x.device.type == "cpu":
        return aoi_words_culled_plain(x, z, radius, active)
    return aoi_words_culled_cuda(x, z, radius, active)


def aoi_step_culled(x, z, radius, active, prev_words, *, block_rows=512,
                    col_words=0):
    """One culled tick with the diff fused: ``(new, chg, culled_frac)``.
    ``prev_words`` must be in the same slot order as the inputs (the
    caller holds one x-sorted order fixed across ticks).  Kernel on CUDA
    tensors, plain version on CPU tensors; ``block_rows``, ``col_words``
    and the fraction as :func:`aoi_words_culled`'s."""
    legal_blocks(x.shape[1], block_rows, col_words)
    if x.device.type == "cpu":
        return aoi_step_culled_plain(x, z, radius, active, prev_words)
    return aoi_step_culled_cuda(x, z, radius, active, prev_words)


def sort_spaces(x, z, radius, active):
    """Order each space's slots by x, inactive slots last (keyed +inf).
    Returns ``(xs, zs, rs, acts, perm)``; ``perm`` (int64 [S, C]) maps
    sorted index -> original index.  Stable, so the order equals
    ``jnp.argsort``'s on every key, ties, -0.0 and NaN included."""
    key = torch.where(active, x, _INF)
    perm = torch.sort(key, dim=1, stable=True).indices

    def take(a):
        return torch.gather(a, 1, perm)

    return take(x), take(z), take(radius), take(active), perm


def resort(x, z, radius, active):
    """A fresh x order and the current positions' words under it (one
    culled words pass): ``(perm, sx, sz, rs, acts, words)``.  The next
    culled step diffs against ``words`` in the new order, so events stay
    exact across a re-sort."""
    sx, sz, rs, acts, perm = sort_spaces(x, z, radius, active)
    words, _ = aoi_words_culled(sx, sz, rs, acts)
    return perm, sx, sz, rs, acts, words
