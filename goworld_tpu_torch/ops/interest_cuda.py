"""The interest-policy stack step: the hand-written Hopper kernel on CUDA
tensors, its plain PyTorch version on CPU tensors.

:func:`interest_step` is the port's counterpart of the JAX package's
jitted stack step (``interest/device.py`` ``_get_step``, an XLA program
over ``ops/interest_kernels.step_masks``): a CUDA tensor launches
``csrc/interest_step.cu`` (and raises if the launch is refused -- there
is no fallback), a CPU tensor runs
:func:`.interest_kernels.step_words` with ``xp=torch``.
``launches["interest_step"]`` counts kernel launches and nothing else.

Inputs: x, z, r float32 [C]; act bool [C]; team, vis int32 [C] (the
ECS's uint32 bits); prev_final, prev_near int32 [C, W]; ``grid`` float32
[nz, nx] (a LOS stack) or None; ``cfg`` a StackConfig-shaped object
(has_team, has_tier, has_los, near_frac, hysteresis, origin_x, origin_z,
inv_cell, los_depth); ``full`` the cadence.  Output: (final, near) int32
[C, W], fresh.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import interest_kernels as K
from .aoi_predicate import words_per_row

# kernel launches; reset by whoever reads them
launches = {"interest_step": 0}

_TEAM, _TIER, _LOS, _FULL = 1, 2, 4, 8


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _want(name, t, dt, shape):
    if t.dtype != dt or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want {dt} {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")


def check_inputs(x, z, r, act, team, vis, prev_final, prev_near, cfg,
                 full, grid):
    """Validate dtypes, shapes, devices and the policy mix; returns W."""
    c = x.shape[0]
    for name, t, dt in (("x", x, torch.float32), ("z", z, torch.float32),
                        ("r", r, torch.float32), ("act", act, torch.bool),
                        ("team", team, torch.int32),
                        ("vis", vis, torch.int32)):
        _want(name, t, dt, (c,))
    w = words_per_row(c)
    _want("prev_final", prev_final, torch.int32, (c, w))
    _want("prev_near", prev_near, torch.int32, (c, w))
    if not full and not cfg.has_tier:
        raise ValueError("an off-cadence step needs a tier policy")
    if cfg.has_los:
        if grid is None or grid.dim() != 2 or grid.dtype != torch.float32 \
                or 0 in grid.shape:
            raise ValueError("a line-of-sight stack needs a float32 "
                             "[nz, nx] grid")
        if not 1 <= cfg.los_depth <= 4:
            raise ValueError(f"LOS depth {cfg.los_depth} not in [1, 4]")
    ts = [x, z, r, act, team, vis, prev_final, prev_near]
    if grid is not None:
        ts.append(grid)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    return w


def interest_step_plain(x, z, r, act, team, vis, prev_final, prev_near, cfg,
                        full, grid=None):
    """The plain PyTorch version (any device): ``step_words`` in row
    blocks."""
    check_inputs(x, z, r, act, team, vis, prev_final, prev_near, cfg, full,
                 grid)
    return K.step_words(x, z, r, act, team, vis, prev_final, prev_near, cfg,
                        full, torch, grid=grid if cfg.has_los else None)


def _lib():
    fn = _build.library("interest_step").gw_interest_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int64, ctypes.c_int]
                       + [ctypes.c_float] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return fn


def interest_step_cuda(x, z, r, act, team, vis, prev_final, prev_near, cfg,
                       full, grid=None):
    """Launch ``csrc/interest_step.cu`` on CUDA tensors -> (final, near)."""
    check_inputs(x, z, r, act, team, vis, prev_final, prev_near, cfg, full,
                 grid)
    if x.device.type != "cuda":
        raise ValueError(f"the interest kernel runs on CUDA tensors, got "
                         f"{x.device}")
    cols = [t.contiguous() for t in (x, z, r)]
    act8 = act.contiguous().view(torch.uint8)
    tv = [t.contiguous() for t in (team, vis, prev_final, prev_near)]
    fin = torch.empty_like(tv[2])
    near = torch.empty_like(tv[3])
    c = x.shape[0]
    if c == 0:
        return fin, near
    flags = ((_TEAM if cfg.has_team else 0) | (_TIER if cfg.has_tier else 0)
             | (_LOS if cfg.has_los else 0) | (_FULL if full else 0))
    g = grid.contiguous() if cfg.has_los else None
    nz, nx = g.shape if g is not None else (0, 0)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in cols), act8.data_ptr(),
                *(t.data_ptr() for t in tv),
                None if g is None else g.data_ptr(), fin.data_ptr(),
                near.data_ptr(), c, flags, float(np.float32(cfg.near_frac)),
                float(np.float32(cfg.hysteresis)),
                float(np.float32(cfg.origin_x)),
                float(np.float32(cfg.origin_z)),
                float(np.float32(cfg.inv_cell)), nz, nx,
                int(cfg.los_depth) if cfg.has_los else 0, stream)
    if rc != 0:
        raise RuntimeError(f"interest_step kernel launch failed: CUDA "
                           f"error {rc}")
    launches["interest_step"] += 1
    return fin, near


def interest_step(x, z, r, act, team, vis, prev_final, prev_near, cfg, full,
                  grid=None):
    """THE stack-step entry: the kernel on CUDA tensors, the plain version
    on CPU tensors, an error on anything else."""
    if x.device.type == "cpu":
        return interest_step_plain(x, z, r, act, team, vis, prev_final,
                                   prev_near, cfg, full, grid)
    return interest_step_cuda(x, z, r, act, team, vis, prev_final,
                              prev_near, cfg, full, grid)
