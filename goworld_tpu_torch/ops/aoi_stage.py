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
small set).
"""

from __future__ import annotations

import numpy as np
import torch

_MIN_PACKET = 64


def pad_packet(rows: np.ndarray, cols: np.ndarray, xv: np.ndarray,
               zv: np.ndarray):
    """Pad a (rows, cols, xv, zv) update packet to a power-of-two length
    (>= ``_MIN_PACKET``) by repeating the last entry.  Requires a non-empty
    packet (an empty delta skips the scatter entirely).  (The JAX
    package's page-granular padding comes with paged storage.)"""
    k = len(rows)
    if k == 0:
        raise ValueError("empty delta packet: skip the scatter instead")
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


def packet_nbytes(rows, cols, xv, zv) -> int:
    """Wire bytes of one padded packet (the h2d_bytes attribution)."""
    return rows.nbytes + cols.nbytes + xv.nbytes + zv.nbytes


def apply_packet(dx: torch.Tensor, dz: torch.Tensor, rows, cols, xv,
                 zv) -> None:
    """Scatter one padded numpy packet into the persistent [S, C] float32
    tensors ``dx``/``dz`` in place.  The packet rides one H2D copy for the
    indices and one for the values."""
    dev = dx.device
    idx = torch.from_numpy(np.stack([rows, cols]).astype(np.int64)).to(dev)
    val = torch.from_numpy(np.stack([xv, zv])).to(dev)
    dx.index_put_((idx[0], idx[1]), val[0])
    dz.index_put_((idx[0], idx[1]), val[1])
