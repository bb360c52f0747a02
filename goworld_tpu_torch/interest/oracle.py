"""The host oracle for interest-policy stacks (port copy, numpy).

The stack-level composition of the policies' CPU oracles: a numpy
evaluation of the SAME expression tree the device step's plain version
runs (:mod:`..ops.interest_kernels` with ``xp=numpy``).  It is the whole
evaluation path of ``interest_mode="host"`` engines, the single-step
fallback after an injected device fault (``host_steps``), and the
reference the tests hold the device step to.

The demoted path (``aoi.interest`` seam fired, or a corrupt distance
field) is NOT the full oracle: it is the radius-only predicate below,
the one filter no corrupt policy state can reach.  Demotion is sticky
and counted; ``PolicyStack.reset_interest`` re-arms.
"""

from __future__ import annotations

import numpy as np

from ..ops import interest_kernels as K


def eval_step(x, z, r, act, team, vis, prev_final_words, prev_near_words,
              cfg, full: bool, grid=None):
    """One stack evaluation on the host: packed (final_words,
    near_words), each np.uint32 [C, W] -- bit-exact with the device step
    on the same inputs (a NaN sample coordinate maps to cell 0 in both)."""
    return K.step_words(
        np.asarray(x, np.float32), np.asarray(z, np.float32),
        np.asarray(r, np.float32), np.asarray(act, bool),
        np.asarray(team, np.uint32), np.asarray(vis, np.uint32),
        np.asarray(prev_final_words, np.uint32),
        np.asarray(prev_near_words, np.uint32), cfg, full, np,
        grid=grid if cfg.has_los else None)


def eval_radius_only(x, z, r, act):
    """The demotion target: the base predicate only (no team, no tier, no
    line of sight) -- packed words [C, W]."""
    x = np.asarray(x, np.float32)
    z = np.asarray(z, np.float32)
    r = np.asarray(r, np.float32)
    act = np.asarray(act, bool)
    c = x.shape[0]
    block = max(1, min(c, K.BLOCK_ELEMS // max(c, 1)))
    out = []
    for lo in range(0, c, block):
        rows = (lo, min(c, lo + block))
        gate = K.pair_gate(act, np, rows)
        out.append(K.pack_bool(K.base_mask(x, z, r, gate, np, rows), np))
    return np.concatenate(out)
