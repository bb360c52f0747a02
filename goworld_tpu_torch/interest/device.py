"""The device step for interest-policy stacks: one kernel launch a step.

The counterpart of the JAX package's ``interest/device.py`` (a jitted XLA
program per capacity, stack config and cadence).  Here one call uploads
this tick's columns, both previous word planes and the distance field to
the engine's device, runs :func:`..ops.interest_cuda.interest_step` (the
hand kernel ``csrc/interest_step.cu`` on a CUDA device, its plain
PyTorch version on the CPU) and fetches both planes back: the planes are
host-authoritative, as in the JAX package (the stack owns them across
growth and payload round trips).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import interest_cuda as IC
from ..ops.aoi_predicate import words_to_numpy, words_to_torch


def _upload(x, z, r, act, team, vis, prev_final_words, prev_near_words,
            grid, dev):
    cols = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
            for a in (x, z, r)]
    a = torch.from_numpy(np.ascontiguousarray(act, bool)).to(dev)
    tv = [torch.from_numpy(np.ascontiguousarray(v, np.uint32).view(np.int32))
          .to(dev) for v in (team, vis)]
    planes = [words_to_torch(w, dev) for w in (prev_final_words,
                                               prev_near_words)]
    g = None if grid is None else torch.from_numpy(
        np.ascontiguousarray(grid, np.float32)).to(dev)
    return (*cols, a, *tv, *planes), g


def eval_step(x, z, r, act, team, vis, prev_final_words, prev_near_words,
              cfg, full: bool, grid=None, device="cuda"):
    """One stack evaluation on ``device``: packed (final_words,
    near_words) as host np.uint32 [C, W] -- bit-exact with
    :func:`.oracle.eval_step` on the same inputs.  Raises whatever the
    device raises; the stack decides what it recovers from
    (engine/aoi._device_fault: injected faults only)."""
    dev = torch.device(device)
    args, g = _upload(x, z, r, act, team, vis, prev_final_words,
                      prev_near_words, grid if cfg.has_los else None, dev)
    fin, near = IC.interest_step(*args, cfg, full, grid=g)
    return words_to_numpy(fin), words_to_numpy(near)
