"""The fused bucket tick: one CUDA graph replay per steady tick.

Port of the JAX package's ``ops/aoi_fused.py`` (``fused_tri_step``,
``fused_paged_step``).  There
the steady tick of a bucket compiles into one jitted, donated program;
here it is one ``torch.cuda.CUDAGraph``, captured over static buffers and
replayed each steady tick.  The body is the port's own functions, in the
reference's order:

    the packet's scatter (aoi_stage.scatter_packet: csrc/stage.cu on
    CUDA tensors)
      -> the step (aoi_cuda.aoi_step_chg with out=: csrc/aoi_step.cu,
         chg mode, on CUDA tensors) under two row masks, applied in the
         kernel's store from the device-resident vectors: the staged-row
         mask (a row the tick did not stage keeps its words and
         contributes no change) and the subscription mask
      -> the triple extraction (events.extract_triples), copied into a
         static triple buffer, and the count into a static count buffer
         (:class:`FusedTri`); or, on a paged bucket (:class:`FusedPaged`),
         the page allocator (aoi_pages.allocate_pages: csrc/pages.cu on
         CUDA tensors) from a static free list, writing its pools into
         static pool buffers and its page table, spilled bins and four
         scalars into one int32 bundle (``out=``), which the harvest
         fetches with one copy where the unfused tick pays three.

On CPU tensors the same body runs eagerly: that is the plain version,
and the tests hold it to the unfused path.  There is no kernel of this
module's own: the fusion is the graph around ``stage.cu``,
``aoi_step.cu`` and the ``events.cu`` or ``pages.cu`` kernels its body
launches (a replay counts one launch of each, as the eager body
would).

The sharded buckets (``engine/aoi_mesh``, ``engine/aoi_rowshard``; the
JAX package folds their packet scatter into the per-chip program,
``_sharded_step(npk)``) take :class:`FusedShards`: one graph per
distinct device and parity, whose body (:func:`shard_body`) scatters
the packet into that device's x/z, then for each shard the device holds
runs the chg step (square on the mesh, rect on the row-sharded bucket),
the subscription mask and the shard codec (:func:`shard_codec`:
``extract_chunks`` and ``encode_row_stream``, the unfused dispatch's own
function), its outputs copied into static buffers of that parity.  Its
words are the bucket's own ``prev`` and spare, so a fused bucket holds
no second copy; its keys are :func:`capture_key` with the codec caps.

Nothing host-bound sits inside the capture.  The packet is padded to one
length per bucket (:func:`packet_len`) and uploaded, as one int32 [4, n]
array (:func:`.aoi_stage.packet_arrays`), into a static device buffer
just before the replay, through pinned memory
(:func:`.aoi_stage.h2d` with ``out=``); the count's copy to pinned host
memory follows the replay.  Those two copies are transfers, not
dispatches.

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
from typing import NamedTuple

import numpy as np
import torch

from . import aoi_cuda as AK
from . import aoi_pages as PG
from . import pages_cuda as PC
from . import aoi_stage as AS
from . import stage_cuda as SC
from . import dispatch_count as DC
from . import events as EV
from . import events_cuda as EC
from .aoi_predicate import words_per_row

SITE = "aoi.fused_tri"
PAGED_SITE = "aoi.fused_paged"
SHARD_SITE = "aoi.fused_shards"


def _pool_bytes(pool) -> int:
    """Bytes a graph memory pool holds on the card."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def _capture(pool, device, body, prepare=None) -> torch.cuda.CUDAGraph:
    """A new graph in ``pool`` on ``device`` holding ``body()``, after one
    eager run of it on a side stream (``torch.cuda.graph``'s warm-up: a
    real launch of the kernel, which builds its library and reads its
    occupancy before any capture).  ``prepare(warm_out)``, where given,
    runs between the two on the current stream and returns the body to
    capture instead.  A capture launches nothing: its counts are undone."""
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = body()
        cur.wait_stream(side)
        if prepare is not None:
            body = prepare(warm)
        del warm
        graph = torch.cuda.CUDAGraph()
        n0, e0 = AK.launches["aoi_step"], dict(EC.launches)
        p0, s0 = dict(PC.launches), dict(SC.launches)
        with torch.cuda.graph(graph, pool=pool):
            body()
        AK.launches["aoi_step"] = n0
        EC.launches.update(e0)
        PC.launches.update(p0)
        SC.launches.update(s0)
    return graph


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
                size: int, caps: tuple = ()) -> tuple:
    """The graph key of one fused tick: a pure function of the bucket's
    shapes, its packet length, the words' parity and the size of its
    outputs (the triple cap, or the page pool's ``n_pages``; a shard
    graph's shard count), and of a shard graph's codec caps
    ``(max_chunks, kcap, max_gaps, max_exc)``."""
    return (s, c, plen, parity, size) + tuple(caps)


def tri_body(prev, new, chg, tri, count, x, z, r, act, sub, stg, pkt,
             capacity: int, max_triples: int) -> None:
    """One fused tick, in place: scatter ``pkt`` into ``x``/``z``,
    step from ``prev`` into ``new``/``chg`` under the staged-row mask
    ``stg`` and the subscription mask ``sub`` (both int32 [S], 1 or 0),
    extract the triples into ``tri`` [max_triples, 3] and their count
    into ``count`` [1] int64.  No host work, so a CUDA graph can hold
    it."""
    AS.scatter_packet(x, z, pkt)
    AK.aoi_step_chg(x, z, r, act, prev, out=(new, chg), stg=stg, sub=sub)
    t, n = EV.extract_triples(chg, new, capacity, max_triples)
    tri.copy_(t)
    count.copy_(n.reshape(1))


def paged_body(prev, new, chg, pg, pc, pn, bundle, free, x, z, r, act, sub,
               stg, pkt, bin_words: int, scratch=None) -> None:
    """One fused paged tick, in place: :func:`tri_body`'s scatter, step and
    masks, then the page allocator over ``free`` (int32 [n_pages], updated
    to the rotated list), its pools into ``pg``/``pc``/``pn`` [n_pages,
    PAGE_WORDS] and ``bundle`` (int32) = [scalars (4), page table
    (n_pages), spilled bins], with the kernel's scratch ``scratch``
    (static: outside the graphs' pool).  No host work, so a CUDA graph
    can hold it."""
    AS.scatter_packet(x, z, pkt)
    AK.aoi_step_chg(x, z, r, act, prev, out=(new, chg), stg=stg, sub=sub)
    k = free.shape[0]
    free_next = PG.allocate_pages(
        chg, new, free, PG.PAGE_WORDS, bin_words, PG.MAX_SPILL,
        out=(pg, pc, pn, bundle[4:4 + k], None, bundle[4 + k:],
             bundle[:4]), scratch=scratch)[4]
    free.copy_(free_next)


class FusedTri:
    """The static buffers and the graphs of one bucket's fused tick, for
    ``s`` slots of capacity ``capacity`` on ``device``.  The inputs
    (``x``, ``z``, ``r``, ``act`` [S, C]) are the bucket's device-resident
    tensors; they must keep their storage from one replay to the next
    (the bucket updates them in place).  The outputs of this class are
    the triples and their count (:func:`tri_body`), sized by the triple
    cap; :class:`FusedPaged` swaps them for the page allocator's."""

    site = SITE
    # the hand kernels besides aoi_step.cu a replay of the body launches:
    # (their module's launch counts, kernel)
    replay_kernels = ((SC.launches, "scatter_packet"),
                      (EC.launches, "extract_triples"))

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
        self.pkt = buf(4, plen)
        self.sub = torch.ones(s, dtype=torch.int32, device=device)
        self.sub_host = np.ones(s, bool)  # what self.sub holds
        self.stg = torch.ones(s, dtype=torch.int32, device=device)
        self.stg_host = np.ones(s, bool)  # what self.stg holds
        self.cuda = device.type == "cuda"
        self.graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self.inputs: dict[tuple, tuple] = {}  # key -> captured input ptrs
        self.captures = 0
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None

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
            AS.h2d(hsub.astype(np.int32), self.device, out=self.sub)
            self.sub_host = hsub.copy()

    def set_staged(self, staged: np.ndarray) -> None:
        """Bring the device staged-row vector up to ``staged`` (bool [S]:
        the rows this tick staged).  A transfer, only when it changed."""
        if not np.array_equal(staged, self.stg_host):
            AS.h2d(staged.astype(np.int32), self.device, out=self.stg)
            self.stg_host = staged.copy()

    def load_packet(self, rows, cols, xv, zv) -> None:
        """Upload one packet of exactly ``plen`` entries into the static
        device packet buffer (through pinned memory, without a wait)."""
        AS.h2d(AS.packet_arrays(rows, cols, xv, zv), self.device,
               out=self.pkt)

    def run(self, parity: int, size: int, x, z, r, act):
        """One fused tick of parity ``parity`` at output size ``size`` over
        the loaded packet: ``(new, chg, *outputs)``, the static buffers it
        writes.  Counts one dispatch (the replay, or the eager body on
        the CPU) and, on the card, one launch of ``aoi_step.cu`` and of
        each of ``replay_kernels``."""
        p = parity
        outs = self.outputs(p, size)
        args = (self.words[p], self.words[1 - p], self.chg[p], *outs,
                x, z, r, act, self.sub, self.stg, self.pkt)
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
            for counts, k in self.replay_kernels:  # and the body's others
                counts[k] += 1
        return (self.words[1 - p], self.chg[p], *outs)

    def pool_bytes(self) -> int:
        """Bytes the graphs' private memory pool holds on the card (0 on
        the CPU)."""
        return _pool_bytes(self.pool) if self.cuda else 0

    def _capture(self, key, args, size) -> torch.cuda.CUDAGraph:
        g = self.graphs[key] = _capture(self.pool, self.device,
                                        lambda: self._body(args, size))
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
    replay_kernels = ((SC.launches, "scatter_packet"),
                      (PC.launches, "allocate_pages"))

    def __init__(self, s: int, capacity: int, plen: int,
                 device: torch.device):
        super().__init__(s, capacity, plen, device)
        w = words_per_row(capacity)
        self.bin_words = PG.bin_words_for(w)
        n_bins = -(-(s * capacity * w) // self.bin_words)
        self.spill_width = min(n_bins, PG.MAX_SPILL)
        # the allocator's scratch, one for both parities (a replay needs
        # none of it after): static, so the graphs' pool stays small
        self.scratch = None if not self.cuda else torch.empty(
            PC.pages_plan(s * capacity * w, 1, self.bin_words,
                          PG.MAX_SPILL).scratch, dtype=torch.int32,
            device=device)

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
        paged_body(*args, self.bin_words, self.scratch)

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


# -- the sharded buckets' fused tick ------------------------------------------


def shard_codec(new, chg, caps: tuple, lanes: int):
    """The event path of one shard's (masked) diff, on its device:
    :func:`.events.extract_chunks` then :func:`.events.encode_row_stream`
    under the codec caps ``(max_chunks, kcap, max_gaps, max_exc)``.
    Returns ``(chunks, streams, scalars)``: the chunk grids (vals, new
    vals, lane, csel), the seven stream arrays (rowb, bitpos, woff,
    esc_rows, exc_gidx, exc_chg, exc_new) and the five control scalars
    (n_dirty, max_ccnt, base_row, n_esc, exc_n) in one int64 [5].  No
    host work, so a CUDA graph can hold it; the unfused dispatch of the
    sharded buckets runs the same function."""
    mc, kcap, mg, mx = caps
    vals, nv, lane, csel, ccnt, nd, mcc = EV.extract_chunks(
        chg, mc, kcap, aux=new, lanes=lanes)
    (rowb, bitpos, woff, base_row, n_esc, esc_rows, exc_gidx, exc_chg,
     exc_new, exc_n) = EV.encode_row_stream(
        vals, nv, lane, csel, ccnt, w=lanes, max_gaps=mg, max_exc=mx)
    streams = (rowb, bitpos, woff, esc_rows, exc_gidx, exc_chg, exc_new)
    scalars = torch.stack([nd, mcc, base_row, n_esc, exc_n]).to(torch.int64)
    return (vals, nv, lane, csel), streams, scalars


class ShardStep(NamedTuple):
    """One shard's step inside a shard graph: its inputs (``x``, ``z``,
    ``r``, ``act``: views of its device's tensors), its words (``prev``
    read, ``new`` and ``chg`` written: the bucket's own buffers), its
    subscription mask (bool [rows], or None: no mask) and, on the
    row-sharded bucket, the rect step's candidates ``cols`` = (x, z, act)
    and its ``row_ids``."""

    x: torch.Tensor
    z: torch.Tensor
    r: torch.Tensor
    act: torch.Tensor
    prev: torch.Tensor
    new: torch.Tensor
    chg: torch.Tensor
    sub: torch.Tensor | None = None
    cols: tuple | None = None
    row_ids: torch.Tensor | None = None


def shard_body(dx, dz, pkt, steps, caps: tuple, lanes: int) -> list:
    """One device's part of a fused sharded tick, in place: scatter the
    packet ``pkt`` into the device's x/z (``dx``/``dz``, 2-D), then
    for each :class:`ShardStep` the chg step (``aoi_step.cu`` on CUDA
    tensors: square, or rect with ``cols``/``row_ids``) into its
    ``new``/``chg``, the subscription mask, and :func:`shard_codec`.
    Returns each shard's ``(chunks, streams, scalars)``.  No host work, so
    a CUDA graph can hold it."""
    AS.scatter_packet(dx, dz, pkt)
    out = []
    for st in steps:
        AK.aoi_step_chg(st.x, st.z, st.r, st.act, st.prev, cols=st.cols,
                        row_ids=st.row_ids, out=(st.new, st.chg))
        if st.sub is not None:
            st.chg.masked_fill_(~st.sub[:, None, None], 0)
        out.append(shard_codec(st.new, st.chg, caps, lanes))
    return out


def _tensors(tree):
    """The tensors of a nested tuple/list (None skipped), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [t for sub in tree for t in _tensors(sub)]


def _like(tree):
    """Fresh tensors shaped like those of ``tree``, nested the same."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree)
    return type(tree)(_like(t) for t in tree)


class FusedShards:
    """The fused tick of a sharded bucket (the mesh's, or the row-sharded
    bucket's): one CUDA graph per distinct device and parity, over the
    bucket's own device tensors.  The graph of device g runs
    :func:`shard_body` for the shards g holds: the packet's scatter into
    g's x/z, then each shard's step, mask and codec, the codec's outputs
    copied into static buffers (one set per parity, outside the graphs'
    pool, so a deferred record's grids, streams and scalars survive the
    next replay).  ``devices`` are the distinct devices, ``plens`` their
    packet lengths (:func:`packet_len`), ``rows`` and ``capacity`` a
    shard's step shape.

    The words are the bucket's: each shard's ``prev`` and its spare
    (``new``) swap every step, so the parity is which of the two shard
    0's ``prev`` is, and its chg buffers are the bucket's ring.  A graph
    records the pointers of every tensor it reads or writes; when they
    moved (growth, a device rebuild, a new buffer) it is captured anew
    under the same key.  A change of the codec caps drops every graph
    and buffer of the old caps.  On CPU tensors the body runs eagerly:
    the plain version.  Each device counts one dispatch a tick."""

    site = SHARD_SITE

    def __init__(self, devices, rows: int, capacity: int, plens, lanes: int):
        self.devices = list(devices)
        self.rows, self.capacity, self.lanes = rows, capacity, lanes
        self.plens = list(plens)
        self.cuda = self.devices[0].type == "cuda"
        self.pkt = [torch.zeros((4, n), dtype=torch.int32, device=d)
                    for d, n in zip(self.devices, self.plens)]
        self.graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self.inputs: dict[tuple, tuple] = {}  # key -> captured pointers
        self.outs: dict[tuple, list] = {}  # key -> static outputs
        self.caps: tuple | None = None
        self.captures = 0
        self._words: list[int | None] = [None, None]
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None

    def parity_of(self, words: torch.Tensor) -> int:
        """The parity of a tick stepping from ``words`` (shard 0's
        ``prev``): 0 or 1 for the bucket's two word buffers; a buffer not
        seen before takes parity 0 and starts a new pair."""
        p = words.data_ptr()
        if p in self._words:
            return self._words.index(p)
        if self._words[0] is not None and self._words[1] is None:
            self._words[1] = p
            return 1
        self._words = [p, None]
        return 0

    def load_packet(self, g: int, rows, cols, xv, zv) -> None:
        """Upload one padded packet of device ``g``'s rows (exactly
        ``plens[g]`` entries) into its static packet buffer (through
        pinned memory, without a wait)."""
        AS.h2d(AS.packet_arrays(rows, cols, xv, zv), self.devices[g],
               out=self.pkt[g])

    def key(self, g: int, parity: int, n_shards: int, caps: tuple) -> tuple:
        """Device ``g``'s graph key."""
        return (str(self.devices[g]),) + capture_key(
            self.rows, self.capacity, self.plens[g], parity, n_shards, caps)

    def run(self, parity: int, caps: tuple, xz, steps) -> list:
        """One fused tick of parity ``parity`` under the codec caps
        ``caps``: ``xz[g]`` = device g's (x, z) 2-D tensors, ``steps[g]``
        its shards' :class:`ShardStep`.  Returns, per device, its shards'
        ``(chunks, streams, scalars)`` (the static buffers on the card).
        Counts one dispatch a device (the replay, or the eager body on the
        CPU) and, on the card, one launch of ``stage.cu``'s scatter a
        device and one launch a shard of ``aoi_step.cu`` and of the
        codec's two ``events.cu`` kernels."""
        if caps != self.caps:
            for k in list(self.graphs):
                del self.graphs[k]
            self.inputs.clear()
            self.outs.clear()
            self.caps = caps
        out = []
        for g in range(len(self.devices)):
            key = self.key(g, parity, len(steps[g]), caps)
            DC.record_key(self.site, key)
            DC.record()
            args = (*xz[g], self.pkt[g], steps[g])
            if not self.cuda:
                out.append(shard_body(*args, caps, self.lanes))
                continue
            ptrs = tuple(t.data_ptr() for t in _tensors(args))
            graph = self.graphs.get(key)
            if graph is None or self.inputs[key] != ptrs:
                graph = self._capture(g, key, args, caps)
                self.inputs[key] = ptrs
            graph.replay()
            SC.launches["scatter_packet"] += 1
            AK.launches["aoi_step"] += len(steps[g])
            for k in ("extract_chunks", "encode_row_stream"):  # shard_codec
                EC.launches[k] += len(steps[g])
            out.append(self.outs[key])
        return out

    def pool_bytes(self) -> int:
        """Bytes the graphs' private memory pool holds on the card (0 on
        the CPU)."""
        return _pool_bytes(self.pool) if self.cuda else 0

    def _capture(self, g: int, key, args, caps) -> torch.cuda.CUDAGraph:
        self.graphs.pop(key, None)

        def body():
            return shard_body(*args, caps, self.lanes)

        def prepare(warm):
            # the static outputs, shaped by the warm-up's, on the current
            # stream (outside the graphs' pool)
            static = self.outs[key] = _like(warm)

            def copied():
                for dst, src in zip(_tensors(static), _tensors(body())):
                    dst.copy_(src)
            return copied

        graph = self.graphs[key] = _capture(self.pool, self.devices[g], body,
                                            prepare)
        self.captures += 1
        return graph
