"""The event compaction's hand-written Hopper kernels (``csrc/events.cu``):
ctypes bindings, their launch plans and the wrappers' checks.

* :func:`extract_triples_cuda` -- the classified diff into (observer,
  observed, kind) triples and their exact count (``gw_extract_triples``:
  one pass that reads ``chg`` once, tiles of :data:`TRI_TILE` words
  ranked by a decoupled look-back);
* :func:`extract_chunks_cuda` -- the chunk extraction of the row-stream
  codec (``gw_extract_chunks``: count, scan and write passes);
* :func:`encode_row_stream_cuda` -- the row-stream encode
  (``gw_encode_row_stream``: one launch, tiles of :data:`ENC_TILE` rows
  ranked by the same look-back).

Each takes the arguments of its entry in :mod:`.events` (which calls it
on CUDA tensors and its ``*_plain`` twin on CPU tensors) and returns the
same outputs, equal element for element.  A wrapper checks dtypes,
shapes, contiguity, devices and caps before anything launches, raises on
a tensor that is not on a CUDA device, allocates outputs and scratch
with ``torch.empty`` (inside a CUDA graph capture they come from the
graph's pool), launches on the current stream, raises if the launch was
refused, and adds one to ``launches[<kernel>]``: nowhere else counts.
The launch plans are pure functions of the shapes and caps, so a capture
key never has to know more.  ``launches`` is served as
``ops.kernel_launches{kernel=...}`` to ``/debug/metrics``.

The two single-pass entries take their tiles by an atomic ticket and
publish a status word a tile; the entry zeroes those words and the
ticket with a memset on the stream just before its kernel, so inside a
CUDA graph every replay resets the scratch it shares with the last
replay (``csrc/events.cu`` says why the kernel cannot reset it itself).
The lists' fills are memsets before the kernel too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import telemetry
from ..telemetry.metrics import Sample
from . import _build
from .aoi_predicate import words_per_row

# kernel launches by kernel name; reset by whoever reads them
launches = {"extract_triples": 0, "extract_chunks": 0,
            "encode_row_stream": 0}

THREADS = 256            # threads a block (csrc/events.cu THREADS)
WARPS = THREADS // 32
TRI_TILE = 32 * THREADS  # words a triples tile: eight 16-byte loads a thread
ENC_TILE = 2 * THREADS   # rows an encode tile: two a thread
ROW_TILE = THREADS       # rows a chunk block ranks in one step (1 a thread)
MAX_BLOCKS = 4096        # chunk count and write passes: at most this many
MAX_FILL_BLOCKS = 1024   # chunk gather pass


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _telemetry_collect() -> list:
    return [Sample("ops.kernel_launches", "counter", n, {"kernel": k},
                   "launches of the hand-written kernels")
            for k, n in sorted(launches.items())]


telemetry.register_collector(_telemetry_collect)


# -- launch plans (pure functions of the shapes and caps) ---------------------


class Plan(NamedTuple):
    """The chunk extraction's launch: ``blocks`` blocks of the count and
    write passes, each owning ``span`` rows (a multiple of its tile);
    ``fill_blocks`` blocks of the gather pass; ``scratch`` int64 entries
    of scratch; ``rows`` int32 entries of per-row scratch."""

    span: int
    blocks: int
    fill_blocks: int
    scratch: int
    rows: int = 0


class OnePass(NamedTuple):
    """A single-pass entry's launch: ``tiles`` blocks of ``tile`` units
    (words or rows), block by block taking tile ``t`` by ticket;
    ``scratch`` int64 entries: a status word a tile for each ranked
    count, then the ticket; ``reset_bytes`` the memset zeroing them
    before the kernel; ``fill_bytes`` the memsets of the outputs' fills
    (-1 rows and tails)."""

    tile: int
    tiles: int
    scratch: int
    reset_bytes: int
    fill_bytes: int


def span_plan(units: int, tile: int,
              max_blocks: int = MAX_BLOCKS) -> tuple[int, int]:
    """``(span, blocks)``: the fewest blocks of whole tiles, at most
    ``max_blocks``, that cover ``units`` (at least one block, also for
    0 units).  Block ``b`` owns units ``[b * span, min((b + 1) * span,
    units))``."""
    tiles = -(-units // tile)
    per = max(1, -(-tiles // max(1, min(tiles, max_blocks))))
    return per * tile, max(1, -(-tiles // per))


def fill_blocks(n: int, per_block: int) -> int:
    return max(1, min(-(-n // per_block), MAX_FILL_BLOCKS))


def one_pass(units: int, tile: int, counts: int, fill_bytes: int) -> OnePass:
    """A tile a block (one tile for 0 units), ``counts`` status words a
    tile and the ticket."""
    tiles = max(1, -(-units // tile))
    scratch = counts * tiles + 1
    return OnePass(tile, tiles, scratch, 8 * scratch, fill_bytes)


def triples_plan(n_words: int, max_triples: int) -> OnePass:
    """Fill: the triple buffer to -1 (12 bytes a row)."""
    return one_pass(n_words, TRI_TILE, 1, 12 * max_triples)


def chunks_plan(n_rows: int, max_chunks: int) -> Plan:
    """Scratch: per-block dirty rows, largest count and prefix, then
    (n_dirty, max_ccnt); per-row counts (int32).  The gather pass runs a
    warp a chunk."""
    span, blocks = span_plan(n_rows, ROW_TILE)
    return Plan(span, blocks, fill_blocks(max_chunks, WARPS),
                3 * blocks + 2, max(1, n_rows))


def encode_plan(n_rows: int, max_gaps: int, max_exc: int) -> OnePass:
    """One status word a tile holds both its counts; fills: the escaped
    rows and the exceptions' gidx to -1, chg and new to 0."""
    return one_pass(n_rows, ENC_TILE, 1, 4 * max_gaps + 12 * max_exc)


# -- checks -------------------------------------------------------------------


def _int32(name, t):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise ValueError(f"{name}: want an int32 tensor, got "
                         f"{getattr(t, 'dtype', type(t).__name__)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cap(name, v):
    if v < 1:
        raise ValueError(f"{name} must be >= 1, got {v}")


def _same_device(**ts):
    devs = {t.device for t in ts.values() if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devs))}")


def check_triples(chg, new, capacity: int, max_triples: int) -> int:
    """Validate :func:`extract_triples_cuda`'s arguments; returns W."""
    _int32("chg", chg)
    _int32("new", new)
    if chg.shape != new.shape:
        raise ValueError(f"chg {list(chg.shape)} and new {list(new.shape)} "
                         f"differ in shape")
    _same_device(chg=chg, new=new)
    _cap("max_triples", max_triples)
    _cap("capacity", capacity)
    return words_per_row(capacity)


def check_chunks(words, max_chunks: int, k: int, aux, lanes: int) -> int:
    """Validate :func:`extract_chunks_cuda`'s arguments; returns the row
    count."""
    _int32("words", words)
    if aux is not None:
        _int32("aux", aux)
        if aux.shape != words.shape:
            raise ValueError(f"aux {list(aux.shape)} and words "
                             f"{list(words.shape)} differ in shape")
    _same_device(words=words, aux=aux)
    _cap("max_chunks", max_chunks)
    _cap("k", k)
    _cap("lanes", lanes)
    if words.numel() % lanes:
        raise ValueError(f"{words.numel()} words are not rows of {lanes}")
    return words.numel() // lanes


def check_encode(vals, new_vals, widx, rsel, rcnt, w: int, max_gaps: int,
                 max_exc: int) -> tuple[int, int]:
    """Validate :func:`encode_row_stream_cuda`'s arguments; returns
    ``(mr, k)``."""
    for name, t in (("vals", vals), ("new_vals", new_vals), ("widx", widx),
                    ("rsel", rsel), ("rcnt", rcnt)):
        _int32(name, t)
    if vals.dim() != 2 or 0 in vals.shape:
        raise ValueError(f"vals: want [mr, k] with mr, k >= 1, got "
                         f"{list(vals.shape)}")
    mr, k = vals.shape
    for name, t, shape in (("new_vals", new_vals, (mr, k)),
                           ("widx", widx, (mr, k)), ("rsel", rsel, (mr,)),
                           ("rcnt", rcnt, (mr,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {list(shape)}, got "
                             f"{list(t.shape)}")
    _same_device(vals=vals, new_vals=new_vals, widx=widx, rsel=rsel,
                 rcnt=rcnt)
    _cap("w", w)
    if w > 2**31 - 1:
        raise ValueError(f"w {w} exceeds int32")
    _cap("max_gaps", max_gaps)
    _cap("max_exc", max_exc)
    if mr * k > 2**31 - 1:
        raise ValueError(f"vals [{mr}, {k}]: more than 2^31 - 1 slots")
    return mr, k


def _on_cuda(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got "
                         f"{t.device}")


# -- bindings -----------------------------------------------------------------

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    "gw_extract_triples": [_P, _P] + [_I64] * 5 + [_INT] + [_P] * 4,
    "gw_extract_chunks": [_P, _P] + [_I64] * 7 + [_INT] + [_P] * 9,
    "gw_encode_row_stream": [_P] * 5 + [_I64] * 7 + [_INT] + [_P] * 10,
    "gw_empty_launch": [_P],
}


def _fn(name: str):
    fn = getattr(_build.library("events"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _launch(kernel: str, dev: torch.device, entry: str, *args) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    launches[kernel] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t) -> int:
    return int(t.data_ptr() % 16 == 0)


# -- wrappers -----------------------------------------------------------------


def extract_triples_cuda(chg: torch.Tensor, new: torch.Tensor,
                         capacity: int, max_triples: int):
    """``csrc/events.cu`` ``gw_extract_triples``: ``(tri [max_triples, 3]
    int32, count)`` with ``count`` an int64 scalar tensor, as
    :func:`.events.extract_triples_plain` returns them.  ``count`` is
    exact past the cap: ``count > max_triples`` is the caller's counted
    overflow (the bucket's ``decode_overflow``)."""
    w = check_triples(chg, new, capacity, max_triples)
    _on_cuda("extract_triples", chg)
    dev = chg.device
    n = chg.numel()
    plan = triples_plan(n, max_triples)
    tri = torch.empty((max_triples, 3), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(plan.scratch, dtype=torch.int64, device=dev)
    _launch("extract_triples", dev, "gw_extract_triples", chg.data_ptr(),
            new.data_ptr(), n, w, max_triples, plan.tile, plan.tiles,
            _aligned(chg), tri.data_ptr(),
            count.data_ptr(), scratch.data_ptr())
    return tri, count


def extract_chunks_cuda(words: torch.Tensor, max_chunks: int, k: int,
                        aux=None, lanes: int = 128):
    """``csrc/events.cu`` ``gw_extract_chunks``: ``(vals, aux_vals | None,
    lane, csel, ccnt, n_dirty, max_ccnt)`` as
    :func:`.events.extract_chunks_plain` returns them."""
    nc = check_chunks(words, max_chunks, k, aux, lanes)
    _on_cuda("extract_chunks", words)
    dev = words.device
    kk = min(k, lanes)
    plan = chunks_plan(nc, max_chunks)

    def out(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    vals, lane = out(max_chunks, kk), out(max_chunks, kk)
    aux_vals = None if aux is None else out(max_chunks, kk)
    csel, ccnt, scalars = out(max_chunks), out(max_chunks), out(2)
    row_cnt = out(plan.rows)
    scratch = torch.empty(plan.scratch, dtype=torch.int64, device=dev)
    vec = int(lanes % 4 == 0 and words.data_ptr() % 16 == 0)
    _launch("extract_chunks", dev, "gw_extract_chunks", words.data_ptr(),
            _ptr(aux), nc, lanes, max_chunks, kk, plan.span, plan.blocks,
            plan.fill_blocks, vec, vals.data_ptr(), _ptr(aux_vals),
            lane.data_ptr(), csel.data_ptr(), ccnt.data_ptr(),
            scalars.data_ptr(), row_cnt.data_ptr(), scratch.data_ptr())
    return vals, aux_vals, lane, csel, ccnt, scalars[0], scalars[1]


def encode_row_stream_cuda(vals, new_vals, widx, rsel, rcnt, *, w: int,
                           max_gaps: int = 2048, max_exc: int = 16384):
    """``csrc/events.cu`` ``gw_encode_row_stream``: the ten outputs of
    :func:`.events.encode_row_stream_plain`, ``base_row`` being the view
    ``rsel[0]`` there too.  ``n_esc`` and ``exc_n`` are exact past the
    caps: ``n_esc > max_gaps`` or ``exc_n > max_exc`` is the caller's
    counted overflow (the mesh and row-sharded buckets'
    ``decode_overflow``; the giant path's decode returns no stream)."""
    mr, k = check_encode(vals, new_vals, widx, rsel, rcnt, w, max_gaps,
                         max_exc)
    _on_cuda("encode_row_stream", vals)
    dev = vals.device
    ns = min(k, 2)
    plan = encode_plan(mr, max_gaps, max_exc)
    rowb = torch.empty(mr, dtype=torch.uint8, device=dev)
    bitpos = torch.empty((mr, ns), dtype=torch.uint8, device=dev)
    woff = torch.empty((mr, ns), dtype=torch.uint8 if w <= 256
                       else torch.uint16, device=dev)

    # one allocation, laid out so that the fills the entry memsets are two
    # runs: the scratch and the lists filled with 0, then those with -1
    lists = torch.empty(2 * plan.scratch + max_gaps + 3 * max_exc + 2,
                        dtype=torch.int32, device=dev)
    scratch = lists[:2 * plan.scratch].view(torch.int64)
    exc_chg, exc_new, esc_rows, exc_gidx, scalars = lists[
        2 * plan.scratch:].split([max_exc, max_exc, max_gaps, max_exc, 2])
    _launch("encode_row_stream", dev, "gw_encode_row_stream",
            vals.data_ptr(), new_vals.data_ptr(), widx.data_ptr(),
            rsel.data_ptr(), rcnt.data_ptr(), mr, k, w, max_gaps, max_exc,
            plan.tile, plan.tiles, int(w > 256),
            rowb.data_ptr(), bitpos.data_ptr(), woff.data_ptr(),
            esc_rows.data_ptr(), exc_gidx.data_ptr(), exc_chg.data_ptr(),
            exc_new.data_ptr(), scalars.data_ptr(), scratch.data_ptr())
    return (rowb, bitpos, woff, rsel[0], scalars[0], esc_rows, exc_gidx,
            exc_chg, exc_new, scalars[1])


def empty_launch() -> None:
    """One launch of ``csrc/events.cu``'s empty kernel on the current
    stream: the floor under an entry's launch, which ``chip_smoke.py``
    times beside the encode (``launch_floor_ms``).  Counts nowhere."""
    rc = _fn("gw_empty_launch")(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
