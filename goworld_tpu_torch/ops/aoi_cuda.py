"""The AOI step entry: the hand-written Hopper kernel on CUDA tensors, its
plain PyTorch version on CPU tensors.

``aoi_step_chg`` is the port's counterpart of the JAX package's
``ops/aoi_dense.aoi_step_chg`` router, which sends the TPU to the Pallas
kernel ``ops/aoi_pallas.aoi_step_pallas(emit="chg")``.  Here the inputs'
device decides: a CUDA tensor launches ``csrc/aoi_step.cu`` (and raises
if the launch is refused -- there is no fallback), a CPU tensor runs
:func:`aoi_dense.aoi_step_chg_dense`.  ``launches["aoi_step"]`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .aoi_dense import aoi_step_chg_dense
from .aoi_predicate import words_per_row

# kernel launches by kernel name; reset by whoever reads them
launches = {"aoi_step": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(x, z, radius, active, prev_words):
    s, c = x.shape
    w = words_per_row(c)
    for name, t, dt in (("x", x, torch.float32), ("z", z, torch.float32),
                        ("radius", radius, torch.float32),
                        ("active", active, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (s, c):
            raise ValueError(f"{name}: want {dt} [{s}, {c}], got "
                             f"{t.dtype} {list(t.shape)}")
    if prev_words.dtype != torch.int32 or \
            tuple(prev_words.shape) != (s, c, w):
        raise ValueError(f"prev_words: want int32 [{s}, {c}, {w}], got "
                         f"{prev_words.dtype} {list(prev_words.shape)}")
    devs = {t.device for t in (x, z, radius, active, prev_words)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")


def _lib():
    fn = _build.library("aoi_step").gw_aoi_step_chg
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + \
            [ctypes.c_void_p]
    return fn


def aoi_step_chg_cuda(x, z, radius, active, prev_words):
    """Launch the kernel: [S, C] inputs, [S, C, W] int32 prev ->
    ``(new, chg)``, both fresh [S, C, W] int32 tensors."""
    _check(x, z, radius, active, prev_words)
    if x.device.type != "cuda":
        raise ValueError(f"the AOI kernel runs on CUDA tensors, got "
                         f"{x.device}")
    ins = [t.contiguous() for t in (x, z, radius, active, prev_words)]
    new = torch.empty_like(ins[4])
    chg = torch.empty_like(ins[4])
    s, c = x.shape
    if s == 0:
        return new, chg
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), new.data_ptr(),
                chg.data_ptr(), s, c, words_per_row(c), stream)
    if rc != 0:
        raise RuntimeError(f"aoi_step kernel launch failed: CUDA error {rc}")
    launches["aoi_step"] += 1
    return new, chg


def aoi_step_chg(x, z, radius, active, prev_words):
    """THE step entry for the engine bucket (``emit="chg"``, square
    mode): the kernel on CUDA tensors, the plain version on CPU tensors,
    an error on anything else."""
    if x.device.type == "cpu":
        _check(x, z, radius, active, prev_words)
        return aoi_step_chg_dense(x, z, radius, active, prev_words)
    return aoi_step_chg_cuda(x, z, radius, active, prev_words)
