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
reusable set per shard); every output word is written, and no output may
be ``prev_words`` itself.  ``stg=`` / ``sub=`` (chg mode) are the per-space
row masks of the fused tick, int32 [S] of 1 or 0 (:func:`row_masks_plain`
is their plain version): a space not staged keeps its ``prev`` words and
has no change, a space not subscribed has no change.

The kernel is persistent: :func:`step_plan` sizes its grid from what fits
on the card at once (read on the card by ``gw_aoi_step_occupancy``) and
cuts the work into units of (space, 32-word group, a run of 64-row tiles)
that the blocks walk (a pure function, tested on the CPU); ``last_plan``
holds the plan of each mode's last launch.

Telemetry: the collector registered at import serves ``launches`` as
``ops.kernel_launches{kernel=...}`` and :mod:`dispatch_count` as
``ops.dispatches`` on every process's ``/debug/metrics`` (telemetry on or
off): a child process's scrape shows whether its ticks ran the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import telemetry
from ..telemetry.metrics import Sample
from . import _build
from . import dispatch_count as DC
from .aoi_dense import aoi_step_chg_dense, aoi_step_entlv_dense
from .aoi_predicate import words_per_row

# kernel launches by kernel name; reset by whoever reads them
launches = {"aoi_step": 0, "aoi_step_entlv": 0}
# the StepPlan of each mode's last launch
last_plan: dict[str, StepPlan] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _telemetry_collect() -> list:
    return [Sample("ops.dispatches", "counter", DC.read(), None,
                   "device dispatches recorded (ops/dispatch_count)"),
            *(Sample("ops.kernel_launches", "counter", n, {"kernel": k},
                     "launches of the hand-written step kernel")
              for k, n in sorted(launches.items()))]


telemetry.register_collector(_telemetry_collect)


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


# -- the launch plan ------------------------------------------------------------

TILE_ROWS = 64    # observer rows per tile (csrc/aoi_tile.cuh TR)
GROUP_WORDS = 32  # words per group (TW)
UNITS_PER_BLOCK = 8  # at least this many units per resident block, where
                     # the shape has the tiles: a short tail
MAX_UNITS = 1 << 30  # the kernel's unit index stays an int


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """The persistent kernel's grid and work units.  The C entry takes
    ``grid`` and ``tiles``; make_plan in ``csrc/aoi_tile.cuh`` derives the
    rest from them and refuses a plan that does not fit the shape.  Unit
    u is (space u // groups // runs, word group u % groups, row tiles
    [t0, min(t0 + tiles, row_tiles)) with t0 = (u // groups % runs) *
    tiles), and block b walks units b, b + grid, ... (``Cursor`` there)."""

    grid: int       # blocks, at most what fits on the card at once
    tiles: int      # row tiles per unit (the last run of a group may hold fewer)
    row_tiles: int  # ceil(R / 64) per space
    groups: int     # ceil(W / 32) per row
    runs: int       # units per (space, group)
    units: int      # S * runs * groups


def step_plan(s: int, r: int, w: int, n_sms: int, blocks_per_sm: int,
              max_tiles: int | None = None) -> StepPlan:
    """The plan for S spaces of R observer rows and W words per row on a
    card with ``n_sms`` SMs that hold ``blocks_per_sm`` blocks each.  The
    units number at least ``UNITS_PER_BLOCK`` x the resident blocks (or
    one per tile where there are fewer tiles), hold at most ``max_tiles``
    row tiles each (where given), the runs of a group are as even as they
    can be, and the grid never exceeds the resident blocks or the units.
    Raises ValueError on a shape the kernel refuses."""
    if min(s, r, w) < 1 or r > 1 << 30 or w > 1 << 25:
        raise ValueError(f"step_plan: shape S={s} R={r} W={w} out of range")
    if n_sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"step_plan: {n_sms} SMs x {blocks_per_sm} blocks")
    if max_tiles is not None and max_tiles < 1:
        raise ValueError(f"step_plan: max_tiles {max_tiles}")
    row_tiles = -(-r // TILE_ROWS)
    groups = -(-w // GROUP_WORDS)
    resident = n_sms * blocks_per_sm
    most = max(1, s * groups * row_tiles // (UNITS_PER_BLOCK * resident))
    runs = -(-row_tiles // min(most, row_tiles, max_tiles or row_tiles))
    tiles = -(-row_tiles // runs)
    units = s * runs * groups
    if units > MAX_UNITS:
        raise ValueError(f"step_plan: {units} units at S={s} R={r} W={w}")
    return StepPlan(grid=min(resident, units), tiles=tiles,
                    row_tiles=row_tiles, groups=groups, runs=runs,
                    units=units)


_occupancy: dict[tuple, tuple[int, int]] = {}


def occupancy(lib_name: str, fn_name: str, kind: int,
              device: torch.device) -> tuple[int, int]:
    """``(n_sms, blocks_per_sm)`` of one kernel on ``device``, from the C
    query ``fn_name`` of ``csrc/<lib_name>.cu`` (read once per device)."""
    key = (fn_name, kind, device.index)
    got = _occupancy.get(key)
    if got is None:
        fn = getattr(_build.library(lib_name), fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        n_sms, blocks = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(kind, ctypes.byref(n_sms), ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")
        got = _occupancy[key] = (n_sms.value, blocks.value)
    return got


# C entry point, output count and row-mask count of each mode
_MODES = {"aoi_step": ("gw_aoi_step_chg", 2, 2),
          "aoi_step_entlv": ("gw_aoi_step_entlv", 3, 0)}


def _lib(mode):
    name, n_out, n_masks = _MODES[mode]
    fn = getattr(_build.library("aoi_step"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (9 + n_out) + \
            [ctypes.c_int64] * 3 + [ctypes.c_void_p] + \
            [ctypes.c_int64] * 2 + [ctypes.c_void_p] * n_masks
    return fn


def _masks(x, stg, sub):
    """The row masks after a check: int32 [S] on the inputs' device,
    contiguous (None stays None)."""
    out = []
    for name, m in (("stg", stg), ("sub", sub)):
        if m is not None:
            _want(name, m, torch.int32, (x.shape[0],))
            if m.device != x.device:
                raise ValueError(f"{name}: on {m.device}, the inputs on "
                                 f"{x.device}")
            m = m.contiguous()
        out.append(m)
    return out


def row_masks_plain(prev_words, new, chg, stg=None, sub=None) -> None:
    """The plain version of the kernel's row masks, in place on the
    unmasked step's ``new`` and ``chg``: a space with ``stg`` 0 keeps
    ``prev_words`` and has ``chg`` 0; a space with ``sub`` 0 has ``chg``
    0."""
    if stg is not None:
        torch.where(stg.bool()[:, None, None], new, prev_words, out=new)
        chg.mul_(stg[:, None, None])
    if sub is not None:
        chg.mul_(sub[:, None, None])


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


def _launch(mode, x, z, radius, active, prev_words, cols, row_ids, out,
            stg=None, sub=None):
    cols = check_inputs(x, z, radius, active, prev_words, cols, row_ids)
    if x.device.type != "cuda":
        raise ValueError(f"the AOI kernel runs on CUDA tensors, got "
                         f"{x.device}")
    rows = [t.contiguous() for t in (x, z, radius, active)]
    cand = [t.contiguous() for t in cols]
    rid = None if row_ids is None else row_ids.contiguous()
    prev = prev_words.contiguous()
    masks = _masks(x, stg, sub)
    outs = _outputs(prev, _MODES[mode][1], out)
    s, c_rows = x.shape
    if s == 0 or c_rows == 0:
        return outs
    if any(o.data_ptr() == prev.data_ptr() for o in outs):
        raise ValueError("out: an output may not be prev_words")
    fn = _lib(mode)
    c_cols = cand[0].shape[1]
    kind = 1 if mode == "aoi_step_entlv" else 2 if any(
        m is not None for m in masks) else 0
    plan = step_plan(s, c_rows, words_per_row(c_cols), *occupancy(
        "aoi_step", "gw_aoi_step_occupancy", kind, x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in rows + cand),
                None if rid is None else rid.data_ptr(), prev.data_ptr(),
                *(t.data_ptr() for t in outs), s, c_rows, c_cols, stream,
                plan.grid, plan.tiles,
                *(None if m is None else m.data_ptr()
                  for m in masks[:_MODES[mode][2]]))
    if rc != 0:
        raise RuntimeError(f"{mode} kernel launch failed: CUDA error {rc}")
    launches[mode] += 1
    last_plan[mode] = plan
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
                      row_ids=None, out=None, stg=None, sub=None):
    """Launch the kernel in chg mode: [S, C_rows] inputs, [S, C_rows, W]
    int32 prev (W = C_cols / 32; square mode C_cols = C_rows) -> ``(new,
    chg)``, [S, C_rows, W] int32 tensors (fresh, or ``out``), under the
    row masks ``stg`` / ``sub`` where given."""
    return _launch("aoi_step", x, z, radius, active, prev_words, cols,
                   row_ids, out, stg, sub)


def aoi_step_entlv_cuda(x, z, radius, active, prev_words, cols=None,
                        row_ids=None, out=None):
    """Launch the kernel in entlv mode: as :func:`aoi_step_chg_cuda`, ->
    ``(new, enter, leave)``."""
    return _launch("aoi_step_entlv", x, z, radius, active, prev_words, cols,
                   row_ids, out)


def aoi_step_chg(x, z, radius, active, prev_words, cols=None, row_ids=None,
                 out=None, stg=None, sub=None):
    """THE step entry (``emit="chg"``, square or rectangular mode, under
    the row masks ``stg`` / ``sub`` where given): the kernel on CUDA
    tensors, the plain version on CPU tensors, an error on anything
    else."""
    if x.device.type == "cpu":
        stg, sub = _masks(x, stg, sub)
        new, chg = _plain(aoi_step_chg_dense, x, z, radius, active,
                          prev_words, cols, row_ids, out)
        row_masks_plain(prev_words, new, chg, stg, sub)
        return new, chg
    return aoi_step_chg_cuda(x, z, radius, active, prev_words, cols=cols,
                             row_ids=row_ids, out=out, stg=stg, sub=sub)


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
