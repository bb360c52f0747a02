"""The delta scatter's hand-written Hopper kernel (``csrc/stage.cu``): its
ctypes binding, its launch plan and the wrapper's checks.

:func:`scatter_packet_cuda` takes the arguments of
:func:`.aoi_stage.scatter_packet` (which calls it on CUDA tensors and
:func:`.aoi_stage.scatter_packet_plain` on CPU tensors): the planes
``dx``/``dz`` (float32 [S, C], contiguous) and one packet ``pkt`` (int32
[4, n]: rows, cols, x bits, z bits), and sets ``dx[r, c]``/``dz[r, c]``
to the entry's bits for every entry, in place, in one launch; negative
indices count from the end and entries still outside the planes are
dropped (the reference's ``mode="drop"``).

The wrapper checks dtypes, shapes, contiguity and devices before
anything builds or launches, raises on a tensor that is not on a CUDA
device, launches on the current stream, raises if the launch was
refused, and adds one to ``launches["scatter_packet"]``: nowhere else
counts.  The launch plan is a pure function of the packet's length.
``launches`` is served as ``ops.kernel_launches{kernel=...}`` to
``/debug/metrics``.  Nothing is allocated: a CUDA graph can hold the
call.
"""

from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from ..telemetry.metrics import Sample
from . import _build

# kernel launches by kernel name; reset by whoever reads them
launches = {"scatter_packet": 0}

THREADS = 256      # threads a block (csrc/stage.cu THREADS)
MAX_BLOCKS = 1024  # blocks at most (grid-stride past them)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _telemetry_collect() -> list:
    return [Sample("ops.kernel_launches", "counter", n, {"kernel": k},
                   "launches of the hand-written kernels")
            for k, n in sorted(launches.items())]


telemetry.register_collector(_telemetry_collect)


def scatter_plan(n: int) -> int:
    """Blocks of one scatter of an ``n``-entry packet: a thread an entry,
    grid-stride past MAX_BLOCKS."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


def check_scatter(dx, dz, pkt) -> None:
    """Validate :func:`scatter_packet_cuda`'s arguments (and the plain
    version's): ``dx``, ``dz`` float32 [S, C] of one shape, contiguous;
    ``pkt`` int32 [4, n], contiguous; all on one device."""
    for name, t in (("dx", dx), ("dz", dz)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want a float32 tensor, got "
                             f"{getattr(t, 'dtype', type(t).__name__)}")
        if t.dim() != 2:
            raise ValueError(f"{name}: want [S, C], got {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dx.shape != dz.shape:
        raise ValueError(f"dx {list(dx.shape)} and dz {list(dz.shape)} "
                         f"differ in shape")
    if not isinstance(pkt, torch.Tensor) or pkt.dtype != torch.int32:
        raise ValueError(f"pkt: want an int32 tensor, got "
                         f"{getattr(pkt, 'dtype', type(pkt).__name__)}")
    if pkt.dim() != 2 or pkt.shape[0] != 4:
        raise ValueError(f"pkt: want [4, n], got {list(pkt.shape)}")
    if not pkt.is_contiguous():
        raise ValueError("pkt must be contiguous")
    devs = {t.device for t in (dx, dz, pkt)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devs))}")


# -- binding ------------------------------------------------------------------

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = [_P] + [_I64] * 4 + [_P] * 3


def _fn():
    fn = _build.library("stage").gw_scatter_packet
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
    return fn


# -- wrapper ------------------------------------------------------------------


def scatter_packet_cuda(dx: torch.Tensor, dz: torch.Tensor,
                        pkt: torch.Tensor) -> None:
    """``csrc/stage.cu`` ``gw_scatter_packet``: ``pkt``'s entries into
    ``dx``/``dz`` in place, as :func:`.aoi_stage.scatter_packet_plain`
    sets them."""
    check_scatter(dx, dz, pkt)
    if dx.device.type != "cuda":
        raise ValueError(f"the scatter_packet kernel runs on CUDA tensors, "
                         f"got {dx.device}")
    n = pkt.shape[1]
    s, c = dx.shape
    with torch.cuda.device(dx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn()(pkt.data_ptr(), n, s, c, scatter_plan(n), dx.data_ptr(),
                   dz.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"scatter_packet kernel launch failed: CUDA "
                           f"error {rc}")
    launches["scatter_packet"] += 1
