"""Interest-policy predicates of the port: one expression tree, two backends.

The port's copy of the JAX package's ``ops/interest_kernels.py``.  Every
policy mask is written once here and evaluated with ``xp=numpy`` by the
host oracle (:mod:`..interest.oracle`) and with ``xp=torch`` by the plain
version of the stack-step kernel (:func:`step_words`, held bit for bit to
``csrc/interest_step.cu`` on the card).

Bit-exactness rests on the same discipline as the JAX package's tree:
every float op is one exactly-rounded IEEE float32 op on every backend.

* the base predicate is sub, abs, compare (no squared distances);
* the tier thresholds are single multiplies (``r * near_frac``, then
  ``rn * hysteresis``), never a mul-add chain a compiler could contract;
* line-of-sight samples are dyadic midpoints, each a chain of
  ``(a + b) * 0.5`` (the halving is exact, add-then-mul has no FMA
  shape); the cell is ``floor((p - origin) * inv_cell)``, clipped in
  float32 before the integer cast.

One deliberate difference from the JAX package's numpy tree: a NaN sample
coordinate maps to cell 0 on both backends here, as the JAX jitted step
maps it (XLA converts NaN to the integer 0).  The JAX numpy oracle casts
NaN to INT_MIN and raises IndexError there (ROADMAP.md queue 3).

Word layout (planar, ``ops/aoi_predicate.py``): bit ``k`` of word ``w``
holds column ``k * W + w``.  numpy words are ``np.uint32``, torch words
``torch.int32`` holding the same bits; a bit is read as ``(w >> k) & 1``
(``>>`` is arithmetic on int32, the mask makes it exact).

Every mask takes ``rows`` = ``(lo, hi)``: the observer rows it evaluates
against all C columns, so the ``[rows, C]`` temporaries stay bounded
(:func:`step_words` walks row blocks; a [C, C] float32 temporary is 1 GiB
at C = 16384).
"""

from __future__ import annotations

import numpy as np
import torch

F32_HALF = np.float32(0.5)
F32_ZERO = np.float32(0.0)
WORD_BITS = 32
# elements of one [rows, C] temporary in step_words (64 MiB of float32)
BLOCK_ELEMS = 1 << 24


def _span(rows, c: int) -> tuple[int, int]:
    return (0, c) if rows is None else rows


def _f32(v, xp, like):
    """A float32 scalar of the backend (a 0-dim tensor on ``like``'s
    device for torch, so every product stays a float32 product)."""
    if xp is torch:
        return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                            device=like.device)
    return np.float32(v)


def _arange(lo: int, hi: int, xp, like):
    if xp is torch:
        return torch.arange(lo, hi, dtype=torch.int64, device=like.device)
    return np.arange(lo, hi)


# -- packed word layout ---------------------------------------------------------


def pack_bool(m, xp):
    """bool [N, C] -> words [N, W] (planar): np.uint32 for numpy,
    torch.int32 (the same bits) for torch."""
    n, c = m.shape
    w = c // WORD_BITS
    planes = m.reshape(n, WORD_BITS, w)
    if xp is torch:
        out = torch.zeros((n, w), dtype=torch.int32, device=m.device)
        for k in range(WORD_BITS):
            out |= planes[:, k, :].to(torch.int32) << k
        return out
    shifts = np.arange(WORD_BITS, dtype=np.uint32)[None, :, None]
    return np.sum(planes.astype(np.uint32) << shifts, axis=1,
                  dtype=np.uint32)


def unpack_words(words, capacity: int, xp):
    """words [N, W] -> bool [N, capacity] (inverse of pack_bool)."""
    if xp is torch:
        shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                              device=words.device)[None, :, None]
    else:
        shifts = np.arange(WORD_BITS, dtype=np.uint32)[None, :, None]
    planes = (words[:, None, :] >> shifts) & 1
    return planes.reshape(words.shape[0], capacity) != 0


# -- the policy masks (rows x all columns) ------------------------------------


def pair_gate(act, xp, rows=None):
    """active(A) & active(B) & A != B, bool [rows, C]."""
    c = act.shape[0]
    lo, hi = _span(rows, c)
    ri = _arange(lo, hi, xp, act)
    ci = _arange(0, c, xp, act)
    return (act[lo:hi, None] & act[None, :]) & (ri[:, None] != ci[None, :])


def base_mask(x, z, r, gate, xp, rows=None):
    """The radius predicate (Chebyshev window, the observer's radius)
    composed with ``gate``."""
    lo, hi = _span(rows, x.shape[0])
    dx = xp.abs(x[None, :] - x[lo:hi, None])  # f32, exactly rounded
    dz = xp.abs(z[None, :] - z[lo:hi, None])
    rr = r[lo:hi, None]
    return (dx <= rr) & (dz <= rr) & gate


def chebyshev(x, z, xp, rows=None):
    """Pairwise Chebyshev distance [rows, C]: the NaN-propagating max of
    the exact f32 |deltas|."""
    lo, hi = _span(rows, x.shape[0])
    dx = xp.abs(x[None, :] - x[lo:hi, None])
    dz = xp.abs(z[None, :] - z[lo:hi, None])
    return xp.maximum(dx, dz)


def team_mask(team, vis, xp, rows=None):
    """Faction visibility: A sees B iff ``vis[A] & team[B] != 0`` (any
    bit, bit 31 included)."""
    lo, hi = _span(rows, team.shape[0])
    return (vis[lo:hi, None] & team[None, :]) != 0


def near_mask(d, r, prev_near, gate, near_frac, hysteresis, xp, rows=None):
    """Tier assignment with hysteresis: NEAR at ``d <= r*near_frac``, kept
    until ``d > (r*near_frac)*hysteresis`` -- two single f32 multiplies."""
    lo, hi = _span(rows, r.shape[0])
    rn = r[lo:hi] * _f32(near_frac, xp, r)
    rf = rn * _f32(hysteresis, xp, r)
    near = (d <= rn[:, None]) | (prev_near & (d <= rf[:, None]))
    return near & gate


def segment_midpoints(ax, az, bx, bz, depth: int, xp):
    """The dyadic sample points of segment A->B in order: ``2^depth - 1``
    points, each a chain of exact ``(a + b) * 0.5`` halvings."""
    half = _f32(F32_HALF, xp, ax)
    out = []

    def rec(ax, az, bx, bz, d):
        mx = (ax + bx) * half
        mz = (az + bz) * half
        if d > 1:
            rec(ax, az, mx, mz, d - 1)
        out.append((mx, mz))
        if d > 1:
            rec(mx, mz, bx, bz, d - 1)

    rec(ax, az, bx, bz, depth)
    return out


def _cells(p, origin, inv_cell, top: int, xp):
    """``clip(floor((p - origin) * inv_cell), 0, top)`` as int64, a NaN
    mapped to cell 0 (the JAX jitted step's answer)."""
    f = xp.floor((p - _f32(origin, xp, p)) * _f32(inv_cell, xp, p))
    f = xp.clip(f, _f32(F32_ZERO, xp, p), _f32(top, xp, p))
    f = xp.nan_to_num(f, nan=0.0)
    return f.to(torch.int64) if xp is torch else f.astype(np.int64)


def los_clear(x, z, grid, origin_x, origin_z, inv_cell, depth: int, xp,
              rows=None):
    """Line-of-sight mask [rows, C]: True when no sampled point of the
    A->B segment lands in a cell with grid value <= 0."""
    lo, hi = _span(rows, x.shape[0])
    nz_cells, nx_cells = grid.shape
    flat = grid.reshape(-1)
    ax, az = x[lo:hi, None], z[lo:hi, None]
    bx, bz = x[None, :], z[None, :]
    blocked = None
    for px, pz in segment_midpoints(ax, az, bx, bz, depth, xp):
        ix = _cells(px, origin_x, inv_cell, nx_cells - 1, xp)
        iz = _cells(pz, origin_z, inv_cell, nz_cells - 1, xp)
        hit = flat[iz * nx_cells + ix] <= _f32(F32_ZERO, xp, flat)
        blocked = hit if blocked is None else (blocked | hit)
    return ~blocked


# -- the composed step ------------------------------------------------------------


def step_masks(x, z, r, act, team, vis, prev_final, prev_near, cfg, full,
               xp, grid=None, rows=None):
    """One policy-stack evaluation of observer rows ``rows`` (all rows by
    default): (final, near) as bool [rows, C], from this tick's columns
    and the rows' previous bool masks.  ``cfg`` carries has_team /
    has_tier / has_los and the tier / LOS scalars (a StackConfig);
    ``full`` selects the cadence.  A full step re-evaluates base & team &
    (near | los) (LOS on the far field only when a tier policy is
    present); an off step (tier policy only) re-evaluates near pairs and
    holds far pairs' previous bit.  The tier updates every step."""
    gate = pair_gate(act, xp, rows)
    if cfg.has_team:
        gate = gate & team_mask(team, vis, xp, rows)
    base = base_mask(x, z, r, gate, xp, rows)
    if cfg.has_tier:
        d = chebyshev(x, z, xp, rows)
        near = near_mask(d, r, prev_near, gate, cfg.near_frac,
                         cfg.hysteresis, xp, rows)
    else:
        near = None
    if full:
        if cfg.has_los:
            clear = los_clear(x, z, grid, cfg.origin_x, cfg.origin_z,
                              cfg.inv_cell, cfg.los_depth, xp, rows)
            final = base & (near | clear) if near is not None \
                else base & clear
        else:
            final = base
    else:
        # off-cadence: near lanes live, far lanes frozen
        final = (near & base) | (~near & prev_final)
    if near is None:
        near = base & False
    return final, near


def step_words(x, z, r, act, team, vis, prev_final_words, prev_near_words,
               cfg, full, xp, grid=None):
    """:func:`step_masks` over every row, packed: (final_words,
    near_words) [C, W], walked in row blocks of at most
    ``BLOCK_ELEMS / C`` rows.  With ``xp=torch`` this is the plain
    version of ``csrc/interest_step.cu``; with ``xp=numpy`` the host
    oracle.  Columns: x, z, r float32, act bool, team, vis 32-bit."""
    if not full and not cfg.has_tier:
        raise ValueError("an off-cadence step needs a tier policy")
    if cfg.has_los and grid is None:
        raise ValueError("a line-of-sight stack needs its grid")
    c = x.shape[0]
    block = max(1, min(c, BLOCK_ELEMS // max(c, 1)))
    finals, nears = [], []
    for lo in range(0, c, block):
        hi = min(c, lo + block)
        pf = unpack_words(prev_final_words[lo:hi], c, xp)
        pn = unpack_words(prev_near_words[lo:hi], c, xp)
        f, n = step_masks(x, z, r, act, team, vis, pf, pn, cfg, full, xp,
                          grid=grid, rows=(lo, hi))
        finals.append(pack_bool(f, xp))
        nears.append(pack_bool(n, xp))
    cat = torch.cat if xp is torch else np.concatenate
    return cat(finals), cat(nears)
