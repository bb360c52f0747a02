"""The host calculator of the port: the numpy AOI oracle.

The port's own copy of the JAX package's ``ops/aoi_oracle.py`` (pure
numpy, no device).  Batch-per-tick semantics, the contract every AOI
backend implements::

    step(x, z, radius, active) -> (enter_pairs, leave_pairs)

where the pair lists are int32 [K, 2] arrays of (observer, observed) index
pairs, sorted lexicographically, describing how the interest relation
changed since the previous step.  The first step reports every interested
pair as an enter event.

Two interchangeable algorithms, equal bit for bit:

  * ``pairwise`` -- O(C^2) dense evaluation of the predicate
    (:func:`.aoi_predicate.interest_matrix`): the parity oracle;
  * ``sweep``    -- a sort-by-x window query per entity (the XZ-sorted
    list strategy): only entities within the observer's x-window are
    examined, each re-checked with the exact f32 predicate.

Both keep the previous tick's interest state as packed uint32 words in
the planar layout of :mod:`.aoi_predicate`, so diffs are XORs.
"""

from __future__ import annotations

import numpy as np

from . import aoi_predicate as P


class CPUAOIOracle:
    """Per-space host AOI state: previous interest words + batched step."""

    def __init__(self, capacity: int, algorithm: str = "pairwise"):
        capacity = P.round_capacity(capacity)
        if algorithm not in ("pairwise", "sweep"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.capacity = capacity
        self.algorithm = algorithm
        self.W = P.words_per_row(capacity)
        self.prev_words = np.zeros((capacity, self.W), np.uint32)

    def reset(self) -> None:
        self.prev_words[:] = 0

    def _interest_matrix(self, x, z, radius, active) -> np.ndarray:
        if self.algorithm == "pairwise":
            return P.interest_matrix(x, z, radius, active)
        return _sweep_interest_matrix(x, z, radius, active)

    def step(self, x, z, radius, active):
        """Advance one tick; returns (enter_pairs, leave_pairs) int32
        [K, 2]."""
        c = self.capacity
        x = _padded(x, c, np.float32)
        z = _padded(z, c, np.float32)
        radius = _padded(radius, c, np.float32)
        active = _padded(active, c, bool)
        new_words = P.pack_rows(self._interest_matrix(x, z, radius, active))
        enter = new_words & ~self.prev_words
        leave = self.prev_words & ~new_words
        self.prev_words = new_words
        return P.pairs_from_words(enter, c), P.pairs_from_words(leave, c)


def _padded(a, capacity: int, dtype) -> np.ndarray:
    a = np.asarray(a, dtype)
    if a.shape[0] > capacity:
        raise ValueError(f"{a.shape[0]} entities exceed capacity {capacity}")
    if a.shape[0] < capacity:
        a = np.concatenate([a, np.zeros(capacity - a.shape[0], dtype)])
    return a


def _sweep_interest_matrix(x, z, radius, active) -> np.ndarray:
    """Sorted-x window query; the same matrix as ``interest_matrix``.

    The window is a prefilter only: every candidate is re-checked with the
    exact f32 predicate.  So the window must be conservative -- the
    f32-rounded difference f32(x_j - x_i) can be <= r while the true
    difference exceeds r by up to half an ulp -- and it is widened by one
    ulp of r and evaluated in f64 (where f32-valued bounds are exact)."""
    c = x.shape[0]
    m = np.zeros((c, c), bool)
    idx = np.nonzero(active)[0]
    if idx.size == 0:
        return m
    order = idx[np.argsort(x[idx], kind="stable")]
    xs64 = x[order].astype(np.float64)
    x64 = x.astype(np.float64)
    for i in idx:
        r = radius[i]
        rwide = np.float64(r) + np.spacing(r)
        lo = np.searchsorted(xs64, x64[i] - rwide, side="left")
        hi = np.searchsorted(xs64, x64[i] + rwide, side="right")
        cand = order[lo:hi]
        dx = np.abs(x[cand] - x[i])  # exact f32 predicate
        dz = np.abs(z[cand] - z[i])
        m[i, cand[(dx <= r) & (dz <= r)]] = True
        m[i, i] = False
    return m
