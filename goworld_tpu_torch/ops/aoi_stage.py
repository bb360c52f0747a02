"""Sparse delta staging for device-resident tick inputs.

Port of the JAX package's ``ops/aoi_stage.py``.  The bucket keeps x/z
(and r/act/sub) resident on the device between flushes and ships only the
entries that changed since the last staged tick: a ``(rows, cols, xv,
zv)`` packet (:func:`pad_packet`, numpy, copied verbatim) applied by
:func:`apply_packet`.  Where JAX donates the [S, C] arrays to a jitted
scatter and rebinds the results, the port writes into the persistent
tensors in place with ``index_put_``.

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


def packet_arrays(rows, cols, xv, zv):
    """One padded numpy packet as the two host arrays the scatter reads:
    indices int64 [2, n] (rows, cols) and values float32 [2, n] (x, z)."""
    return (np.stack([rows, cols]).astype(np.int64),
            np.stack([xv, zv]).astype(np.float32, copy=False))


def scatter_packet(dx: torch.Tensor, dz: torch.Tensor, idx: torch.Tensor,
                   val: torch.Tensor) -> None:
    """The scatter alone, on device tensors: ``idx`` int64 [2, n], ``val``
    float32 [2, n] (what :func:`packet_arrays` gives).  No host work, so
    a CUDA graph can hold it."""
    dx.index_put_((idx[0], idx[1]), val[0])
    dz.index_put_((idx[0], idx[1]), val[1])


def apply_packet(dx: torch.Tensor, dz: torch.Tensor, rows, cols, xv,
                 zv) -> None:
    """Scatter one padded numpy packet into the persistent [S, C] float32
    tensors ``dx``/``dz`` in place.  The packet rides one H2D copy for the
    indices and one for the values."""
    idx, val = packet_arrays(rows, cols, xv, zv)
    scatter_packet(dx, dz, h2d(idx, dx.device), h2d(val, dx.device))
