"""The fused bucket tick: one CUDA graph replay per steady tick.

Port of the JAX package's ``ops/aoi_fused.py`` ``fused_tri_step``.  There
the steady tick of a bucket compiles into one jitted, donated program;
here it is one ``torch.cuda.CUDAGraph``, captured over static buffers and
replayed each steady tick.  The body is the port's own functions, in the
reference's order:

    the packet's scatter (aoi_stage.scatter_packet)
      -> the step (aoi_cuda.aoi_step_chg with out=: csrc/aoi_step.cu,
         chg mode, on CUDA tensors)
      -> the subscription mask (a multiply by the device-resident sub
         vector)
      -> the triple extraction (events.extract_triples), copied into a
         static triple buffer, and the count into a static count buffer.

On CPU tensors the same body runs eagerly: that is the plain version,
and the tests hold it to the unfused path.  There is no kernel of this
module's own: the fusion is the graph around ``aoi_step.cu``.

Nothing host-bound sits inside the capture.  The packet is padded to one
length per bucket (:func:`packet_len`) and uploaded into a static device
buffer just before the replay, from one of two pinned staging buffers;
the count's copy to pinned host memory follows the replay.  Those two
copies are transfers, not dispatches.

The words ping-pong by parity: the graph of parity p reads
``words[p]`` and writes the new words into ``words[1 - p]`` and the
change words into ``chg[p]``, so the record a deferred tick keeps (its
new and chg words, its triples and count) survives the next tick's
replay.  A bucket's graphs are keyed by :func:`capture_key` -- its
shapes, the packet length, the parity and the triple cap -- and share
one memory pool; graphs of a triple cap the bucket has left are dropped.

The first replay of a key is preceded by one eager run of the body on a
side stream (``torch.cuda.graph``'s warm-up; it builds the kernel library
and reads its occupancy before any capture).  It computes the same tick,
so the replay that follows rewrites the same values.

The bucket's fused attempt (``engine/aoi._CUDABucket._dispatch_fused``)
crosses the ``aoi.delta`` and ``aoi.kernel`` fault seams before it loads
a packet: a fault there runs the tick unfused instead, as the JAX
bucket's does.  ``fused_paged_step`` comes with paged storage
(ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import aoi_cuda as AK
from . import aoi_stage as AS
from . import dispatch_count as DC
from . import events as EV
from .aoi_predicate import words_per_row

SITE = "aoi.fused_tri"


def packet_len(s: int, c: int, max_frac: float) -> int:
    """The one packet length of a bucket of ``s`` slots of capacity ``c``:
    the largest packet a fused tick may carry (``max_frac`` of the
    entries changed) rounded up to a power of two."""
    cap = math.ceil(max_frac * s * c)
    n = AS._MIN_PACKET
    while n < cap:
        n *= 2
    return n


def capture_key(s: int, c: int, plen: int, parity: int,
                max_triples: int) -> tuple:
    """The graph key of one fused tick: a pure function of the bucket's
    shapes, its packet length, the words' parity and the triple cap."""
    return (s, c, plen, parity, max_triples)


def tri_body(prev, new, chg, tri, count, x, z, r, act, sub, idx, val,
             capacity: int, max_triples: int) -> None:
    """One fused tick, in place: scatter ``(idx, val)`` into ``x``/``z``,
    step from ``prev`` into ``new``/``chg``, mask ``chg`` by ``sub`` (int32
    [S], 1 or 0), extract the triples into ``tri`` [max_triples, 3] and
    their count into ``count`` [1] int64.  No host work, so a CUDA graph
    can hold it."""
    AS.scatter_packet(x, z, idx, val)
    AK.aoi_step_chg(x, z, r, act, prev, out=(new, chg))
    chg.mul_(sub[:, None, None])
    t, n = EV.extract_triples(chg, new, capacity, max_triples)
    tri.copy_(t)
    count.copy_(n.reshape(1))


class FusedTri:
    """The static buffers and the graphs of one bucket's fused tick, for
    ``s`` slots of capacity ``capacity`` on ``device``.  The inputs
    (``x``, ``z``, ``r``, ``act`` [S, C]) are the bucket's device-resident
    tensors; they must keep their storage from one replay to the next
    (the bucket updates them in place)."""

    def __init__(self, s: int, capacity: int, plen: int,
                 device: torch.device):
        self.s, self.capacity, self.plen = s, capacity, plen
        self.device = device
        shape = (s, capacity, words_per_row(capacity))

        def buf(*shape_, dtype=torch.int32):
            return torch.zeros(shape_, dtype=dtype, device=device)

        self.words = [buf(*shape), buf(*shape)]
        self.chg = [buf(*shape), buf(*shape)]
        self.count = [buf(1, dtype=torch.int64), buf(1, dtype=torch.int64)]
        self.tri: dict[int, list[torch.Tensor]] = {}  # cap -> per parity
        self.idx = buf(2, plen, dtype=torch.int64)
        self.val = buf(2, plen, dtype=torch.float32)
        self.sub = torch.ones(s, dtype=torch.int32, device=device)
        self.sub_host = np.ones(s, bool)  # what self.sub holds
        self.cuda = device.type == "cuda"
        self.graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self.inputs: dict[tuple, tuple] = {}  # key -> captured input ptrs
        self.captures = 0
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        if self.cuda:
            # pinned staging of the packet, one per parity, reused once
            # the upload that last read it has run
            self._stage = [
                (torch.empty((2, plen), dtype=torch.int64).pin_memory(),
                 torch.empty((2, plen), dtype=torch.float32).pin_memory(),
                 torch.cuda.Event()) for _ in range(2)]

    def parity_of(self, prev: torch.Tensor) -> int:
        """The parity whose graph reads ``prev``: 0 or 1 when ``prev`` is
        one of the two word buffers; otherwise ``prev`` is copied into
        ``words[0]`` (a transfer, on a tick where the bucket was not
        fused before) and the parity is 0."""
        for p in (0, 1):
            if prev is self.words[p]:
                return p
        self.words[0].copy_(prev)
        return 0

    def tri_buffer(self, parity: int, max_triples: int) -> torch.Tensor:
        bufs = self.tri.get(max_triples)
        if bufs is None:
            # a cap the bucket has left never comes back as steady: drop
            # its graphs and buffers before capturing at the new one
            for cap in [k for k in self.tri if k != max_triples]:
                del self.tri[cap]
                for key in [k for k in self.graphs if k[-1] == cap]:
                    del self.graphs[key]
                    del self.inputs[key]
            bufs = self.tri[max_triples] = [
                torch.full((max_triples, 3), -1, dtype=torch.int32,
                           device=self.device) for _ in range(2)]
        return bufs[parity]

    def set_sub(self, hsub: np.ndarray) -> None:
        """Bring the device sub vector up to the host's subscription."""
        if not np.array_equal(hsub, self.sub_host):
            self.sub.copy_(AS.h2d(hsub.astype(np.int32), self.device))
            self.sub_host = hsub.copy()

    def load_packet(self, parity: int, rows, cols, xv, zv) -> None:
        """Upload one packet of exactly ``plen`` entries into the static
        device packet buffer."""
        idx, val = AS.packet_arrays(rows, cols, xv, zv)
        if not self.cuda:
            self.idx.copy_(torch.from_numpy(idx))
            self.val.copy_(torch.from_numpy(val))
            return
        idx_h, val_h, done = self._stage[parity]
        done.synchronize()
        idx_h.numpy()[...] = idx
        val_h.numpy()[...] = val
        self.idx.copy_(idx_h, non_blocking=True)
        self.val.copy_(val_h, non_blocking=True)
        done.record(torch.cuda.current_stream(self.device))

    def run(self, parity: int, max_triples: int, x, z, r, act):
        """One fused tick of parity ``parity`` over the loaded packet:
        ``(new, chg, tri, count)``, the static buffers it writes.  Counts
        one dispatch (the replay, or the eager body on the CPU) and, on
        the card, one launch of ``aoi_step.cu``."""
        p = parity
        tri = self.tri_buffer(p, max_triples)
        args = (self.words[p], self.words[1 - p], self.chg[p], tri,
                self.count[p], x, z, r, act, self.sub, self.idx, self.val,
                self.capacity, max_triples)
        key = capture_key(self.s, self.capacity, self.plen, p, max_triples)
        DC.record_key(SITE, key)
        DC.record()
        if not self.cuda:
            tri_body(*args)
        else:
            ptrs = tuple(t.data_ptr() for t in (x, z, r, act))
            g = self.graphs.get(key)
            if g is None:
                g = self._capture(key, args)
                self.inputs[key] = ptrs
            elif self.inputs[key] != ptrs:
                raise RuntimeError("fused tick: the bucket's device inputs "
                                   "moved since the graph was captured")
            g.replay()
            AK.launches["aoi_step"] += 1  # the replay launches aoi_step.cu
        return self.words[1 - p], self.chg[p], tri, self.count[p]

    def pool_bytes(self) -> int:
        """Bytes the graphs' private memory pool holds on the card (0 on
        the CPU)."""
        if not self.cuda:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) ==
                   tuple(self.pool))

    def _capture(self, key, args) -> torch.cuda.CUDAGraph:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            tri_body(*args)  # warm-up: a real launch of the kernel
        cur.wait_stream(side)
        g = torch.cuda.CUDAGraph()
        n0 = AK.launches["aoi_step"]
        with torch.cuda.graph(g, pool=self.pool):
            tri_body(*args)
        AK.launches["aoi_step"] = n0  # a capture launches nothing
        self.graphs[key] = g
        self.captures += 1
        return g
