"""The AOI step entries: the hand-written Hopper kernel on CUDA tensors,
its plain PyTorch version on CPU tensors.

``aoi_step_chg`` and ``aoi_step_entlv`` are the port's counterparts of the
JAX package's ``ops/aoi_pallas.aoi_step_pallas`` in its two output modes
(``emit="chg"``: new and ``new ^ prev``; ``emit="entlv"``, the Pallas
default: new, ``new & ~prev`` and ``prev & ~new``), in square mode and in
rectangular mode (``cols=``, ``row_ids=``).  Here the inputs' device
decides: a CUDA tensor launches ``csrc/aoi_step.cu`` (and raises if the
launch is refused -- there is no fallback), a CPU tensor runs
:mod:`aoi_dense`'s plain version.  ``launches["aoi_step"]`` counts
launches of the chg mode (square and rectangular),
``launches["aoi_step_entlv"]`` those of the entlv mode, and nothing else.

``out=`` hands the step preallocated output tensors (the buckets keep one
reusable set per shard); every output word is written.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .aoi_dense import aoi_step_chg_dense, aoi_step_entlv_dense
from .aoi_predicate import words_per_row

# kernel launches by kernel name; reset by whoever reads them
launches = {"aoi_step": 0, "aoi_step_entlv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _want(name, t, dt, shape):
    if t.dtype != dt or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want {dt} {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")


def check_inputs(x, z, radius, active, prev_words, cols=None, row_ids=None):
    """Validate the step's dtypes, shapes and devices (``prev_words`` may
    be None where a kernel takes none); returns the candidate arrays (the
    rows themselves in square mode)."""
    s, c_rows = x.shape
    for name, t, dt in (("x", x, torch.float32), ("z", z, torch.float32),
                        ("radius", radius, torch.float32),
                        ("active", active, torch.bool)):
        _want(name, t, dt, (s, c_rows))
    if cols is None:
        if row_ids is not None:
            raise ValueError("row_ids needs cols (rectangular mode)")
        cols = (x, z, active)
    else:
        x_c = cols[0]
        if x_c.dim() != 2 or x_c.shape[0] != s:
            raise ValueError(f"cols: want [{s}, C_cols], got "
                             f"{list(x_c.shape)}")
        for name, t, dt in zip(("x_c", "z_c", "act_c"), cols,
                               (torch.float32, torch.float32, torch.bool)):
            _want(name, t, dt, (s, x_c.shape[1]))
        if row_ids is None:
            raise ValueError("rectangular mode needs row_ids")
        _want("row_ids", row_ids, torch.int32, (s, c_rows))
    w = words_per_row(cols[0].shape[1])
    if prev_words is not None:
        _want("prev_words", prev_words, torch.int32, (s, c_rows, w))
    ts = [t for t in (x, z, radius, active, prev_words, *cols, row_ids)
          if t is not None]
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    return cols


# C entry point and output count of each mode
_MODES = {"aoi_step": ("gw_aoi_step_chg", 2),
          "aoi_step_entlv": ("gw_aoi_step_entlv", 3)}


def _lib(mode):
    name, n_out = _MODES[mode]
    fn = getattr(_build.library("aoi_step"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (9 + n_out) + \
            [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    return fn


def _outputs(prev, n_out, out):
    """Fresh outputs shaped like ``prev``, or the caller's ``out`` after a
    check."""
    if out is None:
        return tuple(torch.empty_like(prev) for _ in range(n_out))
    if len(out) != n_out:
        raise ValueError(f"out: want {n_out} tensors, got {len(out)}")
    for t in out:
        _want("out", t, torch.int32, tuple(prev.shape))
        if t.device != prev.device or not t.is_contiguous():
            raise ValueError("out: want contiguous tensors on the inputs' "
                             "device")
    return tuple(out)


def _launch(mode, x, z, radius, active, prev_words, cols, row_ids, out):
    cols = check_inputs(x, z, radius, active, prev_words, cols, row_ids)
    if x.device.type != "cuda":
        raise ValueError(f"the AOI kernel runs on CUDA tensors, got "
                         f"{x.device}")
    rows = [t.contiguous() for t in (x, z, radius, active)]
    cand = [t.contiguous() for t in cols]
    rid = None if row_ids is None else row_ids.contiguous()
    prev = prev_words.contiguous()
    outs = _outputs(prev, _MODES[mode][1], out)
    s, c_rows = x.shape
    if s == 0 or c_rows == 0:
        return outs
    fn = _lib(mode)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in rows + cand),
                None if rid is None else rid.data_ptr(), prev.data_ptr(),
                *(t.data_ptr() for t in outs), s, c_rows,
                cand[0].shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"{mode} kernel launch failed: CUDA error {rc}")
    launches[mode] += 1
    return outs


def _plain(fn, x, z, radius, active, prev_words, cols, row_ids, out):
    check_inputs(x, z, radius, active, prev_words, cols, row_ids)
    got = fn(x, z, radius, active, prev_words, cols=cols, row_ids=row_ids)
    if out is None:
        return got
    outs = _outputs(prev_words, len(got), out)
    for o, g in zip(outs, got):
        o.copy_(g)
    return outs


def aoi_step_chg_cuda(x, z, radius, active, prev_words, cols=None,
                      row_ids=None, out=None):
    """Launch the kernel in chg mode: [S, C_rows] inputs, [S, C_rows, W]
    int32 prev (W = C_cols / 32; square mode C_cols = C_rows) -> ``(new,
    chg)``, [S, C_rows, W] int32 tensors (fresh, or ``out``)."""
    return _launch("aoi_step", x, z, radius, active, prev_words, cols,
                   row_ids, out)


def aoi_step_entlv_cuda(x, z, radius, active, prev_words, cols=None,
                        row_ids=None, out=None):
    """Launch the kernel in entlv mode: as :func:`aoi_step_chg_cuda`, ->
    ``(new, enter, leave)``."""
    return _launch("aoi_step_entlv", x, z, radius, active, prev_words, cols,
                   row_ids, out)


def aoi_step_chg(x, z, radius, active, prev_words, cols=None, row_ids=None,
                 out=None):
    """THE step entry (``emit="chg"``, square or rectangular mode): the
    kernel on CUDA tensors, the plain version on CPU tensors, an error on
    anything else."""
    if x.device.type == "cpu":
        return _plain(aoi_step_chg_dense, x, z, radius, active, prev_words,
                      cols, row_ids, out)
    return aoi_step_chg_cuda(x, z, radius, active, prev_words, cols=cols,
                             row_ids=row_ids, out=out)


def aoi_step_entlv(x, z, radius, active, prev_words, cols=None,
                   row_ids=None, out=None):
    """The ``emit="entlv"`` step entry -> ``(new, enter, leave)``: the
    kernel on CUDA tensors, the plain version on CPU tensors, an error on
    anything else."""
    if x.device.type == "cpu":
        return _plain(aoi_step_entlv_dense, x, z, radius, active,
                      prev_words, cols, row_ids, out)
    return aoi_step_entlv_cuda(x, z, radius, active, prev_words, cols=cols,
                               row_ids=row_ids, out=out)
