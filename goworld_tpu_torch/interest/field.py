"""Precomputed per-space occlusion distance fields (port copy).

The port's own copy of the JAX package's ``interest/field.py`` (numpy
only).  The line-of-sight policy (interest/policy.py) needs a constant-time
"is this point inside an obstacle?" oracle it can sample a few times per
entity pair inside the fused device step.  Following the visibility-
approximation line of work (PAPERS.md: *Efficient Visibility
Approximation for Game AI using Neural Omnidirectional Distance
Fields*), the world's static geometry is baked ONCE, host-side, into a
coarse signed-distance grid: cell value = distance to the nearest
obstacle boundary, negative inside an obstacle.  The LOS predicate then
reduces to "no sampled segment point lands in a cell with value <= 0".

The grid is plain float32 numpy, shared VERBATIM by the CPU oracle and
the device step (it rides H2D beside the columns) -- only the sampling
arithmetic has to be replay-exact, and that lives in
ops/interest_kernels.py and csrc/interest_step.cu.  Baking precision is therefore a quality knob,
not a correctness one: both backends read the same bytes.

Snapshot format: a distance field serializes into the same plain-dict
style the AOI buckets use for ``pad_packet`` migration snapshots --
``{"origin": (x, z), "cell": float, "grid": bytes, "shape": (nz, nx)}``
-- so policy state can ride checkpoint/migration payloads untouched.
"""

from __future__ import annotations

import numpy as np


class DistanceField:
    """A coarse signed-distance grid over the space's XZ plane.

    ``grid[iz, ix]`` covers the world cell
    ``[origin + i*cell, origin + (i+1)*cell)``; values are distances to
    the nearest obstacle edge (negative inside).  Coordinates outside
    the grid clamp to the border cells -- the world edge occludes
    nothing unless the baker says so.
    """

    def __init__(self, origin_x: float, origin_z: float, cell: float,
                 grid: np.ndarray):
        if cell <= 0.0:
            raise ValueError(f"cell size must be positive, got {cell}")
        grid = np.ascontiguousarray(grid, np.float32)
        if grid.ndim != 2 or 0 in grid.shape:
            raise ValueError(f"grid must be 2-D and non-empty, "
                             f"got shape {grid.shape}")
        self.origin_x = np.float32(origin_x)
        self.origin_z = np.float32(origin_z)
        self.cell = np.float32(cell)
        self.inv_cell = np.float32(1.0) / self.cell
        self.grid = grid

    @property
    def shape(self) -> tuple[int, int]:
        return self.grid.shape  # (nz, nx)

    def validate(self) -> bool:
        """False when the grid is corrupt (non-finite values -- exactly
        what the ``aoi.interest`` poison kind injects).  The policy stack
        checks this before every evaluation that samples the field and
        demotes to the radius-only oracle path on failure."""
        return bool(np.isfinite(self.grid).all())

    # -- baking -------------------------------------------------------------

    @classmethod
    def from_boxes(cls, boxes, origin, size, cell: float) -> "DistanceField":
        """Bake axis-aligned box obstacles into a field.

        ``boxes`` is an iterable of (x0, z0, x1, z1) world rectangles;
        ``origin`` = (x, z) of the grid's low corner, ``size`` = (sx, sz)
        world extent.  Distance metric is Chebyshev (matches the AOI
        window semantics); cells are sampled at their centers.  Baking is
        a one-time host cost at space setup -- precision here only moves
        the approximation, never oracle/device parity (both read the
        same grid)."""
        ox, oz = float(origin[0]), float(origin[1])
        sx, sz = float(size[0]), float(size[1])
        nx = max(1, int(np.ceil(sx / cell)))
        nz = max(1, int(np.ceil(sz / cell)))
        # cell-center sample coordinates
        cx = (ox + (np.arange(nx, dtype=np.float64) + 0.5) * cell)[None, :]
        cz = (oz + (np.arange(nz, dtype=np.float64) + 0.5) * cell)[:, None]
        dist = np.full((nz, nx), np.float64(max(sx, sz)))
        for (x0, z0, x1, z1) in boxes:
            # signed Chebyshev distance to the box: negative inside
            dx = np.maximum(x0 - cx, cx - x1)
            dz = np.maximum(z0 - cz, cz - z1)
            d = np.maximum(dx, dz)
            dist = np.minimum(dist, np.broadcast_to(d, dist.shape))
        return cls(ox, oz, cell, dist.astype(np.float32))

    # -- snapshot (rides the pad_packet-style payload dicts) ----------------

    def export_state(self) -> dict:
        return {"origin": (float(self.origin_x), float(self.origin_z)),
                "cell": float(self.cell),
                "shape": tuple(int(s) for s in self.grid.shape),
                "grid": self.grid.tobytes()}

    @classmethod
    def import_state(cls, state: dict) -> "DistanceField":
        nz, nx = state["shape"]
        grid = np.frombuffer(state["grid"], np.float32) \
            .reshape(nz, nx).copy()
        return cls(state["origin"][0], state["origin"][1],
                   state["cell"], grid)

    def key(self) -> tuple:
        """The field's geometry (origin, cell, shape): what a stack's
        configuration key holds of it (the grid CONTENT rides beside the
        columns and may change between steps)."""
        return (float(self.origin_x), float(self.origin_z),
                float(self.cell)) + self.shape
