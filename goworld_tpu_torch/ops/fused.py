"""The fused bucket tick: one CUDA graph replay per steady tick.

Port of the JAX package's ``ops/aoi_fused.py`` (``fused_tri_step``,
``fused_paged_step``).  There
the steady tick of a bucket compiles into one jitted, donated program;
here it is one ``torch.cuda.CUDAGraph``, captured over static buffers and
replayed each steady tick.  The body is the port's own functions, in the
reference's order:

    the packet's scatter (aoi_stage.scatter_packet)
      -> the step (aoi_cuda.aoi_step_chg with out=: csrc/aoi_step.cu,
         chg mode, on CUDA tensors) under two row masks, applied in the
         kernel's store from the device-resident vectors: the staged-row
         mask (a row the tick did not stage keeps its words and
         contributes no change) and the subscription mask
      -> the triple extraction (events.extract_triples), copied into a
         static triple buffer, and the count into a static count buffer
         (:class:`FusedTri`); or, on a paged bucket (:class:`FusedPaged`),
         the page allocator (aoi_pages.allocate_pages) from a static free
         list, its pools copied into static pool buffers and its page
         table, spilled bins and four scalars into one int32 bundle, which
         the harvest fetches with one copy where the unfused tick pays
         three.

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
new and chg words, its triples and count, or its pools and bundle)
survives the next tick's replay.  A bucket's graphs are keyed by
:func:`capture_key` -- its shapes, the packet length, the parity and the
size of its outputs (the triple cap, or the page pool's ``n_pages``: a
pool resize is a new capture) -- and share one memory pool; graphs of a
size the bucket has left are dropped.  Which rows the tick staged is a
buffer (``stg``, int32 [S]), not part of the key: a tick with quiet
spaces replays the same graph as one that staged every space.

The first replay of a key is preceded by one eager run of the body on a
side stream (``torch.cuda.graph``'s warm-up; it builds the kernel library
and reads its occupancy before any capture).  It computes the same tick,
so the replay that follows rewrites the same values.

The bucket's fused attempt (``engine/aoi._CUDABucket._dispatch_fused``)
crosses the ``aoi.delta`` and ``aoi.kernel`` fault seams before it loads
a packet: a fault there runs the tick unfused instead, as the JAX
bucket's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import aoi_cuda as AK
from . import aoi_pages as PG
from . import aoi_stage as AS
from . import dispatch_count as DC
from . import events as EV
from .aoi_predicate import words_per_row

SITE = "aoi.fused_tri"
PAGED_SITE = "aoi.fused_paged"


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
                size: int) -> tuple:
    """The graph key of one fused tick: a pure function of the bucket's
    shapes, its packet length, the words' parity and the size of its
    outputs (the triple cap, or the page pool's ``n_pages``)."""
    return (s, c, plen, parity, size)


def tri_body(prev, new, chg, tri, count, x, z, r, act, sub, stg, idx, val,
             capacity: int, max_triples: int) -> None:
    """One fused tick, in place: scatter ``(idx, val)`` into ``x``/``z``,
    step from ``prev`` into ``new``/``chg`` under the staged-row mask
    ``stg`` and the subscription mask ``sub`` (both int32 [S], 1 or 0),
    extract the triples into ``tri`` [max_triples, 3] and their count
    into ``count`` [1] int64.  No host work, so a CUDA graph can hold
    it."""
    AS.scatter_packet(x, z, idx, val)
    AK.aoi_step_chg(x, z, r, act, prev, out=(new, chg), stg=stg, sub=sub)
    t, n = EV.extract_triples(chg, new, capacity, max_triples)
    tri.copy_(t)
    count.copy_(n.reshape(1))


def paged_body(prev, new, chg, pg, pc, pn, bundle, free, x, z, r, act, sub,
               stg, idx, val, bin_words: int) -> None:
    """One fused paged tick, in place: :func:`tri_body`'s scatter, step and
    masks, then the page allocator over ``free`` (int32 [n_pages], updated
    to the rotated list), its pools into ``pg``/``pc``/``pn`` [n_pages,
    PAGE_WORDS] and ``bundle`` (int32) = [scalars (4), page table
    (n_pages), spilled bins].  No host work, so a CUDA graph can hold
    it."""
    AS.scatter_packet(x, z, idx, val)
    AK.aoi_step_chg(x, z, r, act, prev, out=(new, chg), stg=stg, sub=sub)
    g, c, n, tab, free_next, spill, scal = PG.allocate_pages(
        chg, new, free, PG.PAGE_WORDS, bin_words, PG.MAX_SPILL)
    pg.copy_(g)
    pc.copy_(c)
    pn.copy_(n)
    free.copy_(free_next)
    k = free.shape[0]
    bundle[:4].copy_(scal)
    bundle[4:4 + k].copy_(tab)
    bundle[4 + k:].copy_(spill)


class FusedTri:
    """The static buffers and the graphs of one bucket's fused tick, for
    ``s`` slots of capacity ``capacity`` on ``device``.  The inputs
    (``x``, ``z``, ``r``, ``act`` [S, C]) are the bucket's device-resident
    tensors; they must keep their storage from one replay to the next
    (the bucket updates them in place).  The outputs of this class are
    the triples and their count (:func:`tri_body`), sized by the triple
    cap; :class:`FusedPaged` swaps them for the page allocator's."""

    site = SITE

    def __init__(self, s: int, capacity: int, plen: int,
                 device: torch.device):
        self.s, self.capacity, self.plen = s, capacity, plen
        self.device = device
        shape = (s, capacity, words_per_row(capacity))

        def buf(*shape_, dtype=torch.int32):
            return torch.zeros(shape_, dtype=dtype, device=device)

        self.words = [buf(*shape), buf(*shape)]
        self.chg = [buf(*shape), buf(*shape)]
        # output size (triple cap or n_pages) -> per parity, the outputs
        self.outs: dict[int, list[tuple]] = {}
        self.idx = buf(2, plen, dtype=torch.int64)
        self.val = buf(2, plen, dtype=torch.float32)
        self.sub = torch.ones(s, dtype=torch.int32, device=device)
        self.sub_host = np.ones(s, bool)  # what self.sub holds
        self.stg = torch.ones(s, dtype=torch.int32, device=device)
        self.stg_host = np.ones(s, bool)  # what self.stg holds
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

    def outputs(self, parity: int, size: int) -> tuple:
        """The output buffers of parity ``parity`` at output size ``size``
        (made on first use).  A size the bucket has left never comes back
        as steady: its graphs and buffers are dropped first."""
        bufs = self.outs.get(size)
        if bufs is None:
            for old in [k for k in self.outs if k != size]:
                del self.outs[old]
                for key in [k for k in self.graphs if k[-1] == old]:
                    del self.graphs[key]
                    del self.inputs[key]
            bufs = self.outs[size] = self._make_outputs(size)
        return bufs[parity]

    def _make_outputs(self, max_triples: int) -> list[tuple]:
        return [(torch.full((max_triples, 3), -1, dtype=torch.int32,
                            device=self.device),
                 torch.zeros(1, dtype=torch.int64, device=self.device))
                for _ in range(2)]

    def _body(self, args: tuple, max_triples: int) -> None:
        tri_body(*args, self.capacity, max_triples)

    def set_sub(self, hsub: np.ndarray) -> None:
        """Bring the device sub vector up to the host's subscription."""
        if not np.array_equal(hsub, self.sub_host):
            self.sub.copy_(AS.h2d(hsub.astype(np.int32), self.device))
            self.sub_host = hsub.copy()

    def set_staged(self, staged: np.ndarray) -> None:
        """Bring the device staged-row vector up to ``staged`` (bool [S]:
        the rows this tick staged).  A transfer, only when it changed."""
        if not np.array_equal(staged, self.stg_host):
            self.stg.copy_(AS.h2d(staged.astype(np.int32), self.device))
            self.stg_host = staged.copy()

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

    def run(self, parity: int, size: int, x, z, r, act):
        """One fused tick of parity ``parity`` at output size ``size`` over
        the loaded packet: ``(new, chg, *outputs)``, the static buffers it
        writes.  Counts one dispatch (the replay, or the eager body on
        the CPU) and, on the card, one launch of ``aoi_step.cu``."""
        p = parity
        outs = self.outputs(p, size)
        args = (self.words[p], self.words[1 - p], self.chg[p], *outs,
                x, z, r, act, self.sub, self.stg, self.idx, self.val)
        key = capture_key(self.s, self.capacity, self.plen, p, size)
        DC.record_key(self.site, key)
        DC.record()
        if not self.cuda:
            self._body(args, size)
        else:
            ptrs = tuple(t.data_ptr() for t in (x, z, r, act))
            g = self.graphs.get(key)
            if g is None:
                g = self._capture(key, args, size)
                self.inputs[key] = ptrs
            elif self.inputs[key] != ptrs:
                raise RuntimeError("fused tick: the bucket's device inputs "
                                   "moved since the graph was captured")
            g.replay()
            AK.launches["aoi_step"] += 1  # the replay launches aoi_step.cu
        return (self.words[1 - p], self.chg[p], *outs)

    def pool_bytes(self) -> int:
        """Bytes the graphs' private memory pool holds on the card (0 on
        the CPU)."""
        if not self.cuda:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) ==
                   tuple(self.pool))

    def _capture(self, key, args, size) -> torch.cuda.CUDAGraph:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(args, size)  # warm-up: a real launch of the kernel
        cur.wait_stream(side)
        g = torch.cuda.CUDAGraph()
        n0 = AK.launches["aoi_step"]
        with torch.cuda.graph(g, pool=self.pool):
            self._body(args, size)
        AK.launches["aoi_step"] = n0  # a capture launches nothing
        self.graphs[key] = g
        self.captures += 1
        return g


class FusedPaged(FusedTri):
    """The fused tick of a paged bucket (:func:`paged_body`): its outputs,
    per parity, are the three pools [n_pages, PAGE_WORDS] and the bundle
    [4 + n_pages + spill width]; the free list [n_pages] is one static
    buffer both parities read and rotate, and it persists from tick to
    tick.  The spill width is the allocator's, ``min(n_bins,
    MAX_SPILL)`` of the [S, C, W] grid the graph steps."""

    site = PAGED_SITE

    def __init__(self, s: int, capacity: int, plen: int,
                 device: torch.device):
        super().__init__(s, capacity, plen, device)
        w = words_per_row(capacity)
        self.bin_words = PG.bin_words_for(w)
        n_bins = -(-(s * capacity * w) // self.bin_words)
        self.spill_width = min(n_bins, PG.MAX_SPILL)

    def _make_outputs(self, n_pages: int) -> list[tuple]:
        dev = self.device
        free = torch.arange(n_pages, dtype=torch.int32, device=dev)

        def pool(fill):
            return torch.full((n_pages, PG.PAGE_WORDS), fill,
                              dtype=torch.int32, device=dev)

        return [(pool(-1), pool(0), pool(0),
                 torch.zeros(4 + n_pages + self.spill_width,
                             dtype=torch.int32, device=dev), free)
                for _ in range(2)]

    def _body(self, args: tuple, n_pages: int) -> None:
        paged_body(*args, self.bin_words)

    def _capture(self, key, args, size) -> torch.cuda.CUDAGraph:
        # the warm-up run rotates the free list: put it back, so the
        # replay that follows allocates from the list the tick was given
        free = args[7]
        saved = free.clone()
        g = super()._capture(key, args, size)
        free.copy_(saved)
        return g

    def run_paged(self, parity: int, free: torch.Tensor, x, z, r, act):
        """One fused paged tick from the free list ``free`` (copied into
        the static one when it is another tensor: a pool reset, or a
        tick run unfused since): ``(new, chg, (pool_g, pool_c, pool_n),
        bundle, free_next)``, the static buffers it writes."""
        n_pages = free.shape[0]
        static = self.outputs(parity, n_pages)[-1]
        if free is not static:
            static.copy_(free)
        new, chg, pg, pc, pn, bundle, free = self.run(parity, n_pages,
                                                      x, z, r, act)
        return new, chg, (pg, pc, pn), bundle, free
