"""Sparse delta staging for device-resident tick inputs.

Port of the JAX package's ``ops/aoi_stage.py``.  The bucket keeps x/z
(and r/act/sub) resident on the device between flushes and ships only the
entries that changed since the last staged tick: a ``(rows, cols, xv,
zv)`` packet (:func:`pad_packet`, numpy, copied verbatim) applied by
:func:`apply_packet`.  Where JAX donates the [S, C] arrays to a jitted
scatter and rebinds the results, the port writes into the persistent
tensors in place: the packet rides as one int32 [4, n] array (rows,
cols, the x and z values' bit patterns: :func:`packet_arrays`) in one
H2D copy, and :func:`scatter_packet` sets both planes from it, through
the hand-written kernel of ``csrc/stage.cu`` (:mod:`.stage_cuda`) on
CUDA tensors and the plain version :func:`scatter_packet_plain` on CPU
tensors.  Both take the reference's ``mode="drop"``: a negative index
counts from the end (the reference normalises indices first) and an
entry still outside the planes is dropped.

Packets are padded by repeating their last entry: the scatter is an
idempotent set, so the padding never changes what lands (and it keeps the
packet lengths, which a later fused or graph-captured tick keys on, to a
small set).  Paged buckets pad page-granular, as the JAX package's do:
a mid-size packet rounds up to a whole number of ``_PAGE``-entry pages
(at most one page of waste where the power of two wastes up to half),
up to ``_PAGE_KEYS`` pages; larger packets take the power of two.
"""

from __future__ import annotations

import numpy as np
import torch

from . import stage_cuda as SC

_MIN_PACKET = 64
# page-granular padding (paged buckets): one page of packet entries; the
# first _PAGE_KEYS page multiples are admissible lengths
_PAGE = 64
_PAGE_KEYS = 8


def pad_packet(rows: np.ndarray, cols: np.ndarray, xv: np.ndarray,
               zv: np.ndarray, length: int | None = None,
               page_granular: bool = False):
    """Pad a (rows, cols, xv, zv) update packet to a power-of-two length
    (>= ``_MIN_PACKET``), or to exactly ``length`` (the fused tick's one
    packet length), by repeating the last entry.  Requires a non-empty
    packet (an empty delta skips the scatter entirely).

    ``page_granular=True`` (paged buckets) rounds a packet of at most
    ``_PAGE * _PAGE_KEYS`` entries up to a whole number of ``_PAGE``-entry
    pages instead; larger packets take the power of two either way."""
    k = len(rows)
    if k == 0:
        raise ValueError("empty delta packet: skip the scatter instead")
    if length is not None:
        if length < k:
            raise ValueError(f"packet of {k} entries over length {length}")
        n = length
    elif page_granular and k <= _PAGE * _PAGE_KEYS:
        n = -(-k // _PAGE) * _PAGE
    else:
        n = _MIN_PACKET
        while n < k:
            n *= 2
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    xv = np.ascontiguousarray(xv, np.float32)
    zv = np.ascontiguousarray(zv, np.float32)
    if n != k:
        pad = n - k
        rows = np.concatenate([rows, np.broadcast_to(rows[-1:], (pad,))])
        cols = np.concatenate([cols, np.broadcast_to(cols[-1:], (pad,))])
        xv = np.concatenate([xv, np.broadcast_to(xv[-1:], (pad,))])
        zv = np.concatenate([zv, np.broadcast_to(zv[-1:], (pad,))])
    return rows, cols, xv, zv


def h2d(arr: np.ndarray, device: torch.device,
        out: torch.Tensor | None = None) -> torch.Tensor:
    """A device copy of a host array (into ``out`` when given, in place)
    that never makes the host wait: on a CUDA device the array is copied
    into pinned memory and uploaded asynchronously on the current stream
    (a pageable upload would wait for the stream, and with it for a tick
    still in flight); on the CPU a plain copy (never aliasing ``arr``)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        t = t.pin_memory()
    if out is None:
        return t.to(device, non_blocking=True, copy=True)
    return out.copy_(t, non_blocking=True)


def packet_nbytes(rows, cols, xv, zv) -> int:
    """Wire bytes of one padded packet (the h2d_bytes attribution)."""
    return rows.nbytes + cols.nbytes + xv.nbytes + zv.nbytes


def packet_arrays(rows, cols, xv, zv) -> np.ndarray:
    """One padded numpy packet (what :func:`pad_packet` gives: int32
    indices, float32 values) as the one host array the scatter reads:
    int32 [4, n] of the rows, the cols and the x and z values' bit
    patterns."""
    return np.stack([rows, cols, xv.view(np.int32),
                     zv.view(np.int32)]).astype(np.int32, copy=False)


def scatter_packet(dx: torch.Tensor, dz: torch.Tensor,
                   pkt: torch.Tensor) -> None:
    """THE delta scatter, on device tensors: ``pkt`` int32 [4, n] (what
    :func:`packet_arrays` gives) into the float32 [S, C] planes ``dx`` /
    ``dz`` in place.  ``csrc/stage.cu`` on CUDA tensors
    (:func:`.stage_cuda.scatter_packet_cuda`; a refused launch raises,
    nothing falls back), :func:`scatter_packet_plain` on CPU tensors.  No
    host work, so a CUDA graph can hold it."""
    if dx.device.type != "cpu":
        SC.scatter_packet_cuda(dx, dz, pkt)
    else:
        scatter_packet_plain(dx, dz, pkt)


def scatter_packet_plain(dx: torch.Tensor, dz: torch.Tensor,
                         pkt: torch.Tensor) -> None:
    """The scatter in plain PyTorch (the kernel's plain version): two
    ``index_put_`` of the values' bit patterns (int32 views of the
    planes, so no float arithmetic touches them) at the entries that
    land, negative indices normalised first as the reference's are."""
    SC.check_scatter(dx, dz, pkt)
    s, c = dx.shape
    rows, cols = pkt[0].long(), pkt[1].long()
    rows = torch.where(rows < 0, rows + s, rows)
    cols = torch.where(cols < 0, cols + c, cols)
    keep = (rows >= 0) & (rows < s) & (cols >= 0) & (cols < c)
    at = (rows[keep], cols[keep])
    dx.view(torch.int32).index_put_(at, pkt[2][keep])
    dz.view(torch.int32).index_put_(at, pkt[3][keep])


def apply_packet(dx: torch.Tensor, dz: torch.Tensor, rows, cols, xv,
                 zv) -> None:
    """Scatter one padded numpy packet into the persistent [S, C] float32
    tensors ``dx``/``dz`` in place.  The packet rides one H2D copy."""
    scatter_packet(dx, dz, h2d(packet_arrays(rows, cols, xv, zv),
                               dx.device))
