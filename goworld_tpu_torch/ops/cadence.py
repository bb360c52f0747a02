"""The giant-capacity device-cadence tick: a fixed x order, one culled step
per tick, and the row-stream codec.

Port of the tick that the JAX package's ``bench.py`` runs for BASELINE's
giant shapes (``bench_tpu_device_cadence``: ``million``, ``zipf100k`` and
its row-sharded ``zipfshare`` block).

* :class:`FixedOrderGrid` holds each space's slots in one x-sorted order
  (:func:`aoi_grid.resort`) and carries positions in both orders; a tick
  applies the walk's int8 deltas (pre-permuted on the host, so the device
  gathers nothing) and runs ONE culled step with the diff fused, against
  the previous tick's words in the same order.  A re-sort recomputes the
  current words under a fresh order, so the next tick's events stay exact.
* :class:`RowBlock` is one device's observer-row block of a row-sharded
  space: the rectangular step of its rows against every candidate.
* :func:`encode_tick` compacts a tick's diff on the device
  (:func:`events.extract_chunks` -> :func:`events.encode_row_stream`) into
  ONE uint8 buffer, with no host sync; :func:`decode_tick` reads the
  fetched buffer on the host and checks the overflow contracts.
* :class:`Caps` are the codec's static caps: a generous first guess,
  refit to the observed density (the counts are exact past the caps).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import aoi_cuda as AK
from . import aoi_grid as AG
from . import events as EV
from .aoi_predicate import check_capacity, words_per_row

LANES = 128  # stream chunk width in words
QSCALE = np.float32(1.0 / 16.0)  # int8 walk delta unit: 1/16 world unit
MAX_GAPS = 8192  # escaped row deltas (sorted-space streams escape often)
MAX_EXC = 16384  # exception triples (tail and multi-bit words)


def fit_pow(v, mult: int) -> int:
    """Round ``v`` up to a multiple of ``mult`` (at least ``mult``)."""
    return max(mult, -(-int(v) // mult) * mult)


@dataclasses.dataclass(frozen=True)
class Caps:
    max_chunks: int
    k: int
    max_gaps: int = MAX_GAPS
    max_exc: int = MAX_EXC

    @classmethod
    def first_guess(cls, n_stream_chunks: int, grid: bool) -> Caps:
        """Sorted (grid) space concentrates a tick's changed words into
        few chunks with many words each, so it gets wider slots."""
        return cls(fit_pow(min(n_stream_chunks, 16384), 512),
                   32 if grid else 8)

    def refit(self, n_stream_chunks: int, peaks: dict) -> Caps:
        """Caps fitted to the peaks of ``n_dirty``, ``max_ccnt``,
        ``n_esc`` and ``exc_n`` with headroom."""
        return Caps(
            min(n_stream_chunks, fit_pow(peaks["n_dirty"] * 3 // 2, 512)),
            min(LANES, max(8, fit_pow(peaks["max_ccnt"] * 2, 2))),
            max(MAX_GAPS, fit_pow(peaks["n_esc"] * 3 // 2, 1024)),
            max(MAX_EXC, fit_pow(peaks["exc_n"] * 3 // 2, 2048)))


SCALARS = ("base_row", "n_dirty", "max_ccnt", "n_esc", "exc_n")


def encode_tick(new: torch.Tensor, chg: torch.Tensor, caps: Caps):
    """One tick's diff -> the encoded stream as one uint8 tensor on the
    words' device: ``rowb [mc] | bitpos [mc, 2] | woff [mc, 2] | int32
    (base_row, n_dirty, max_ccnt, n_esc, exc_n, esc_rows [max_gaps],
    exc_gidx, exc_chg, exc_new [max_exc])``.  No host sync."""
    vals, nv, lane, csel, ccnt, nd, mcc = EV.extract_chunks(
        chg, caps.max_chunks, caps.k, aux=new, lanes=LANES)
    (rowb, bitpos, woff, base_row, n_esc, esc_rows, exc_gidx, exc_chg,
     exc_new, exc_n) = EV.encode_row_stream(
        vals, nv, lane, csel, ccnt, w=LANES, max_gaps=caps.max_gaps,
        max_exc=caps.max_exc)
    meta = torch.cat([torch.stack([base_row, nd, mcc, n_esc, exc_n]),
                      esc_rows, exc_gidx, exc_chg, exc_new])
    return torch.cat([rowb, bitpos.reshape(-1), woff.reshape(-1),
                      meta.view(torch.uint8)])


def decode_tick(buf: np.ndarray, caps: Caps):
    """Host side of :func:`encode_tick` on the fetched buffer.  Returns
    ``(scalars, decoded)``: ``decoded`` is ``(chg_vals u32, ent_vals u32,
    gidx i64)`` (``gidx`` the flat word index of each changed word), or
    None when a cap was exceeded (the stream is incomplete)."""
    mc, g, e = caps.max_chunks, caps.max_gaps, caps.max_exc
    rowb = buf[:mc]
    bitpos = buf[mc:3 * mc].reshape(mc, 2)
    woff = buf[3 * mc:5 * mc].reshape(mc, 2)
    meta = buf[5 * mc:].view(np.int32)
    sc = dict(zip(SCALARS, (int(v) for v in meta[:5])))
    if sc["n_dirty"] > mc or sc["max_ccnt"] > caps.k or \
            sc["n_esc"] > g or sc["exc_n"] > e:
        return sc, None
    o = 5
    esc_rows = meta[o:o + g]
    exc_gidx = meta[o + g:o + g + e]
    exc_chg = meta[o + g + e:o + g + 2 * e]
    exc_new = meta[o + g + 2 * e:o + g + 3 * e]
    return sc, EV.decode_row_stream(rowb, bitpos, woff, sc["base_row"],
                                    sc["n_dirty"], LANES, esc_rows,
                                    exc_gidx, exc_chg, exc_new)


def walk(pos: torch.Tensor, q: torch.Tensor, world: float) -> torch.Tensor:
    """``clip(pos + q * 1/16, 0, world)`` in float32: every product is
    exact, so host (numpy) and device positions agree bit for bit."""
    return torch.clamp(pos + q.to(torch.float32) * float(QSCALE), 0.0,
                       float(world))


class FixedOrderGrid:
    """Fixed-order culled tick over [S, C] spaces on one device.

    ``x, z, radius, active`` are device tensors in the original slot
    order; the grid keeps them (``x``/``z`` move) and their x-sorted
    copies ``sx, sz, rs, acts`` under ``perm``, plus the current words
    ``words`` in sorted order."""

    def __init__(self, x, z, radius, active, world: float):
        check_capacity(x.shape[1])  # the stream's chunks tile the words
        self.x, self.z, self.r, self.act = x, z, radius, active
        self.world = world
        self.resort()

    @property
    def n_stream_chunks(self) -> int:
        s, c = self.x.shape
        return s * c * words_per_row(c) // LANES

    def resort(self) -> torch.Tensor:
        """A fresh x order and the current words under it; returns them."""
        self.words = None  # free the old words before the new pass
        (self.perm, self.sx, self.sz, self.rs, self.acts,
         self.words) = AG.resort(self.x, self.z, self.r, self.act)
        self.perm_host = self.perm.cpu().numpy()
        return self.words

    def step(self, qx: np.ndarray, qz: np.ndarray):
        """Apply one tick's int8 walk deltas ([S, C], original order) and
        run the culled step: ``(new, chg, culled_frac)``; ``new`` becomes
        the carried words."""
        dev = self.x.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        qxp = np.take_along_axis(qx, self.perm_host, axis=1)
        qzp = np.take_along_axis(qz, self.perm_host, axis=1)
        self.x = walk(self.x, put(qx), self.world)
        self.z = walk(self.z, put(qz), self.world)
        self.sx = walk(self.sx, put(qxp), self.world)
        self.sz = walk(self.sz, put(qzp), self.world)
        new, chg, frac = AG.aoi_step_culled(
            self.sx, self.sz, self.rs, self.acts, self.words)
        self.words = new
        return new, chg, frac


class RowBlock:
    """One device's block of ``rows`` observer rows of row-sharded [S, C]
    spaces: every tick the whole space moves and the block's interest
    rows are evaluated against all C candidates (the rectangular step),
    self-exclusion by the rows' global ids."""

    def __init__(self, x, z, radius, active, world: float, rows: int,
                 row0: int = 0):
        self.x, self.z, self.r, self.act = x, z, radius, active
        self.world = world
        self.rows = slice(row0, row0 + rows)
        s, c = x.shape
        self.row_ids = torch.arange(row0, row0 + rows, dtype=torch.int32,
                                    device=x.device).expand(s, rows)
        self.row_ids = self.row_ids.contiguous()
        zero = torch.zeros((s, rows, check_capacity(c)), dtype=torch.int32,
                           device=x.device)
        self.words, _ = self._step(zero)

    @property
    def n_stream_chunks(self) -> int:
        s, c = self.x.shape
        return s * self.words.shape[1] * words_per_row(c) // LANES

    def _step(self, prev):
        b = self.rows
        return AK.aoi_step_chg(
            self.x[:, b], self.z[:, b], self.r[:, b], self.act[:, b], prev,
            cols=(self.x, self.z, self.act), row_ids=self.row_ids)

    def step(self, qx: np.ndarray, qz: np.ndarray):
        """Move every slot by the int8 deltas ([S, C]) and evaluate the
        block: ``(new, chg)``; ``new`` becomes the carried words."""
        dev = self.x.device
        self.x = walk(self.x, torch.from_numpy(qx).to(dev), self.world)
        self.z = walk(self.z, torch.from_numpy(qz).to(dev), self.world)
        new, chg = self._step(self.words)
        self.words = new
        return new, chg
