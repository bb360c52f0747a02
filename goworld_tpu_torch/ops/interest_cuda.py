"""The interest-policy stack step over resident word planes: the
hand-written Hopper kernel on CUDA tensors, its plain PyTorch version on
CPU tensors.

:func:`interest_step` is the port's counterpart of the JAX package's
jitted stack step (``interest/device.py`` ``_get_step``, an XLA program
over ``ops/interest_kernels.step_masks``) together with the host diff
that follows it (``interest/policy.py``, ``np.nonzero`` of ``new ^
prev``): a CUDA tensor launches ``csrc/interest_step.cu`` (and raises if
the launch is refused -- there is no fallback), a CPU tensor runs
:func:`interest_step_plain`.  ``launches["interest_step"]`` counts kernel
launches and nothing else.

Inputs: x, z, r float32 [C]; act bool [C]; team, vis int32 [C] (the
ECS's uint32 bits); ``final``, ``near`` int32 [C, W], contiguous, updated
IN PLACE to the step's planes; ``grid`` float32 [nz, nx] (a LOS stack) or
None; ``cfg`` a StackConfig-shaped object (has_team, has_tier, has_los,
near_frac, hysteresis, origin_x, origin_z, inv_cell, los_depth); ``full``
the cadence; ``lists`` int32 [2, cap, 2] and ``counts`` int32 [2], the
outputs: ``counts[p]`` is the number of words of plane p (0 final, 1
near) the step changed, and ``lists[p, :min(counts[p], cap)]`` holds
(flat index ``i * W + w``, new word) of each, every changed word once, in
no particular order.  Past ``cap`` entries are dropped: the caller then
reads the whole plane.
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
# flat word indices travel as int32
MAX_WORDS = 2**31 - 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _want(name, t, dt, shape):
    if t.dtype != dt or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want {dt} {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")


def check_inputs(x, z, r, act, team, vis, final, near, cfg, full, grid,
                 lists, counts):
    """Validate dtypes, shapes, layout, devices and the policy mix;
    returns W."""
    c = x.shape[0]
    for name, t, dt in (("x", x, torch.float32), ("z", z, torch.float32),
                        ("r", r, torch.float32), ("act", act, torch.bool),
                        ("team", team, torch.int32),
                        ("vis", vis, torch.int32)):
        _want(name, t, dt, (c,))
    w = words_per_row(c)
    if c * w > MAX_WORDS:
        raise ValueError(f"capacity {c}: {c * w} words a plane exceed "
                         f"int32 flat indices")
    _want("final", final, torch.int32, (c, w))
    _want("near", near, torch.int32, (c, w))
    if lists.dtype != torch.int32 or lists.dim() != 3 \
            or lists.shape[0] != 2 or lists.shape[2] != 2:
        raise ValueError(f"lists: want int32 [2, cap, 2], got {lists.dtype} "
                         f"{list(lists.shape)}")
    _want("counts", counts, torch.int32, (2,))
    for name, t in (("final", final), ("near", near), ("lists", lists),
                    ("counts", counts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (written in place)")
    if not full and not cfg.has_tier:
        raise ValueError("an off-cadence step needs a tier policy")
    if cfg.has_los:
        if grid is None or grid.dim() != 2 or grid.dtype != torch.float32 \
                or 0 in grid.shape:
            raise ValueError("a line-of-sight stack needs a float32 "
                             "[nz, nx] grid")
        if not 1 <= cfg.los_depth <= 4:
            raise ValueError(f"LOS depth {cfg.los_depth} not in [1, 4]")
    ts = [x, z, r, act, team, vis, final, near, lists, counts]
    if grid is not None:
        ts.append(grid)
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    return w


def interest_step_plain(x, z, r, act, team, vis, final, near, cfg, full,
                        grid=None, *, lists, counts):
    """The plain PyTorch version (any device): ``step_words`` in row
    blocks, then per plane ``torch.nonzero`` of the change into the list
    (ascending) and an in-place copy."""
    check_inputs(x, z, r, act, team, vis, final, near, cfg, full, grid,
                 lists, counts)
    new = K.step_words(x, z, r, act, team, vis, final, near, cfg, full,
                       torch, grid=grid if cfg.has_los else None)
    cap = lists.shape[1]
    for p, (plane, nw) in enumerate(zip((final, near), new)):
        flat = nw.reshape(-1)
        idx = torch.nonzero(flat ^ plane.reshape(-1)).reshape(-1)
        k = min(idx.numel(), cap)
        counts[p] = idx.numel()
        lists[p, :k, 0] = idx[:k].to(torch.int32)
        lists[p, :k, 1] = flat[idx[:k]]
        plane.copy_(nw)


def _lib():
    fn = _build.library("interest_step").gw_interest_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 12
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
                       + [ctypes.c_float] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return fn


def interest_step_cuda(x, z, r, act, team, vis, final, near, cfg, full,
                       grid=None, *, lists, counts):
    """Launch ``csrc/interest_step.cu`` on CUDA tensors: the planes in
    place, the changed words into ``lists`` / ``counts``."""
    check_inputs(x, z, r, act, team, vis, final, near, cfg, full, grid,
                 lists, counts)
    if x.device.type != "cuda":
        raise ValueError(f"the interest kernel runs on CUDA tensors, got "
                         f"{x.device}")
    cols = [t.contiguous() for t in (x, z, r)]
    act8 = act.contiguous().view(torch.uint8)
    tv = [t.contiguous() for t in (team, vis)]
    c = x.shape[0]
    if c == 0:
        counts.zero_()
        return
    flags = ((_TEAM if cfg.has_team else 0) | (_TIER if cfg.has_tier else 0)
             | (_LOS if cfg.has_los else 0) | (_FULL if full else 0))
    g = grid.contiguous() if cfg.has_los else None
    nz, nx = g.shape if g is not None else (0, 0)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in cols), act8.data_ptr(),
                *(t.data_ptr() for t in tv), final.data_ptr(),
                near.data_ptr(), None if g is None else g.data_ptr(),
                lists[0].data_ptr(), lists[1].data_ptr(), counts.data_ptr(),
                lists.shape[1], c, flags, float(np.float32(cfg.near_frac)),
                float(np.float32(cfg.hysteresis)),
                float(np.float32(cfg.origin_x)),
                float(np.float32(cfg.origin_z)),
                float(np.float32(cfg.inv_cell)), nz, nx,
                int(cfg.los_depth) if cfg.has_los else 0, stream)
    if rc != 0:
        raise RuntimeError(f"interest_step kernel launch failed: CUDA "
                           f"error {rc}")
    launches["interest_step"] += 1


def interest_step(x, z, r, act, team, vis, final, near, cfg, full,
                  grid=None, *, lists, counts):
    """THE stack-step entry: the kernel on CUDA tensors, the plain version
    on CPU tensors, an error on anything else."""
    if x.device.type == "cpu":
        return interest_step_plain(x, z, r, act, team, vis, final, near,
                                   cfg, full, grid, lists=lists,
                                   counts=counts)
    return interest_step_cuda(x, z, r, act, team, vis, final, near, cfg,
                              full, grid, lists=lists, counts=counts)
