"""The page allocator's hand-written Hopper kernel (``csrc/pages.cu``):
its ctypes binding, its launch plan and the wrapper's checks.

:func:`allocate_pages_cuda` takes the arguments of
:func:`.aoi_pages.allocate_pages` (which calls it on CUDA tensors and
:func:`.aoi_pages.allocate_pages_plain` on CPU tensors) and returns the
same seven outputs, equal element for element.  ``gw_allocate_pages``
memsets the pools to their fills and the rank tiles' histograms to 0,
then runs three kernels: a count pass (a warp a bin: its count, a
summary of its nonzero 4-word groups, its need class into its tile's
histogram), the ranks (a block a tile of bins: the boundary class of the
counting sort that stands for the plain version's stable argsort, the
tile's place from the earlier tiles' histograms, block scans) and a
write pass (a warp a granted bin, from its summary, and the page table
and rotated free list).

The wrapper checks dtypes, shapes, contiguity, devices, the page width
and the class count before anything launches, raises on a tensor that
is not on a CUDA device, allocates outputs and scratch with
``torch.empty`` (inside a CUDA graph capture they come from the graph's
pool) unless ``out=`` and ``scratch=`` name them (the fused paged graph
gives its static scratch: the summary makes it 2.2 MB at phase 17, which
the caching allocator would carve from a 20 MB segment of the graph's
pool), launches on the current stream, raises
if the launch was refused, and adds one to ``launches["allocate_pages"]``:
nowhere else counts.  The launch plan is a pure function of the shapes.
``launches`` is served as ``ops.kernel_launches{kernel=...}`` to
``/debug/metrics``.

No scratch carries from one launch to the next (``csrc/pages.cu`` says
why): the histograms' memset is a node of a captured graph, so a replay
starts clean.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import telemetry
from ..telemetry.metrics import Sample
from . import _build

# kernel launches by kernel name; reset by whoever reads them
launches = {"allocate_pages": 0}

THREADS = 256          # threads a block of the count and write passes
WARPS = THREADS // 32  # bins a block takes at once (a warp a bin)
RANK_THREADS = 1024    # threads a block of the ranks (a thread a bin x items)
PAGE_WORDS = 64        # word entries a page (csrc/pages.cu PAGE_WORDS)
MAX_CLASSES = 8193     # need classes the entry takes (1 + 2^19 / 64)
MAX_TILES = 1024       # rank tiles: at most this many (items grows past)
SUM_SPAN = 128         # words a summary word covers (32 groups of 4)
MAX_BLOCKS = 4096      # count and write passes' bin blocks: at most this many
MAX_ROT_BLOCKS = 1024  # the page table's and free list's blocks
INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _telemetry_collect() -> list:
    return [Sample("ops.kernel_launches", "counter", n, {"kernel": k},
                   "launches of the hand-written kernels")
            for k, n in sorted(launches.items())]


telemetry.register_collector(_telemetry_collect)


# -- launch plan (a pure function of the shapes) ------------------------------


class Plan(NamedTuple):
    """One allocation's launch: ``n_bins`` bins of the grid, ``n_classes``
    need classes (0 .. ceil(bin_words / 64)), ``spill_width`` entries of
    the spilled-bin vector; ``blocks`` blocks of the count pass and of
    the write pass's bins (a warp a bin, grid-stride), ``rot_blocks``
    more blocks of the write pass for the page table and the free list;
    ``sum_words`` summary words a bin (a bit a 4-word group); ``items``
    bins a thread of the ranks, ``tiles`` rank blocks (RANK_THREADS *
    items bins each); ``scratch`` int32 entries (the bins' counts, their
    page ranks, their summaries, the tiles' histograms, the tiles' word
    sums); ``fill_bytes`` the memsets (the pools and the histograms)."""

    n_bins: int
    n_classes: int
    spill_width: int
    blocks: int
    rot_blocks: int
    sum_words: int
    items: int
    tiles: int
    scratch: int
    fill_bytes: int


def pages_plan(n_words: int, n_pages: int, bin_words: int,
               max_spill: int) -> Plan:
    n_bins = -(-n_words // bin_words)
    n_classes = -(-bin_words // PAGE_WORDS) + 1
    sum_words = -(-bin_words // SUM_SPAN)
    items = max(1, -(-n_bins // (RANK_THREADS * MAX_TILES)))
    tiles = max(1, -(-n_bins // (RANK_THREADS * items)))
    hist = tiles * n_classes
    return Plan(n_bins, n_classes, min(n_bins, max_spill),
                max(1, min(-(-n_bins // WARPS), MAX_BLOCKS)),
                max(1, min(-(-n_pages // THREADS), MAX_ROT_BLOCKS)),
                sum_words, items, tiles,
                2 * n_bins + n_bins * sum_words + hist + 2 * tiles,
                3 * 4 * PAGE_WORDS * n_pages + 4 * hist)


def out_shapes(n_pages: int, spill_width: int) -> list[tuple]:
    """The shapes of the seven outputs, in order: the three pools, the
    page table, the rotated free list, the spilled bins, the scalars."""
    pool = (n_pages, PAGE_WORDS)
    return [pool, pool, pool, (n_pages,), (n_pages,), (spill_width,), (4,)]


# -- checks -------------------------------------------------------------------


def _int32(name, t):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise ValueError(f"{name}: want an int32 tensor, got "
                         f"{getattr(t, 'dtype', type(t).__name__)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_out(out, n_pages: int, spill_width: int, free) -> None:
    """``out``: seven tensors or None (None: the wrapper allocates it),
    each int32, contiguous and of its output's shape; the free list's
    output never ``free`` itself."""
    if len(out) != 7:
        raise ValueError(f"out: want 7 entries, got {len(out)}")
    for i, (t, shape) in enumerate(zip(out, out_shapes(n_pages,
                                                       spill_width))):
        if t is None:
            continue
        _int32(f"out[{i}]", t)
        if tuple(t.shape) != shape:
            raise ValueError(f"out[{i}]: want {list(shape)}, got "
                             f"{list(t.shape)}")
    if out[4] is not None and out[4].data_ptr() == free.data_ptr() \
            and free.numel():
        raise ValueError("out[4] (the rotated free list) must not be free")


def check_pages(chg, new, free, page_words: int, bin_words: int,
                max_spill: int, out=None, scratch=None) -> Plan:
    """Validate :func:`allocate_pages_cuda`'s arguments; returns the
    launch plan."""
    _int32("chg", chg)
    _int32("new", new)
    _int32("free", free)
    if chg.shape != new.shape:
        raise ValueError(f"chg {list(chg.shape)} and new {list(new.shape)} "
                         f"differ in shape")
    if free.dim() != 1:
        raise ValueError(f"free: want [n_pages], got {list(free.shape)}")
    if page_words != PAGE_WORDS:
        raise ValueError(f"page_words {page_words}: the kernel's page is "
                         f"{PAGE_WORDS} words")
    if bin_words < 1:
        raise ValueError(f"bin_words must be >= 1, got {bin_words}")
    if max_spill < 0:
        raise ValueError(f"max_spill must be >= 0, got {max_spill}")
    plan = pages_plan(chg.numel(), free.shape[0], bin_words, max_spill)
    if plan.n_classes > MAX_CLASSES:
        raise ValueError(f"bin_words {bin_words}: {plan.n_classes} need "
                         f"classes, the entry takes {MAX_CLASSES}")
    if plan.n_bins * bin_words > INT32_MAX:
        raise ValueError(f"{chg.numel()} words padded to bins of "
                         f"{bin_words}: flat indices past int32")
    ts = {"chg": chg, "new": new, "free": free}
    if scratch is not None:
        _int32("scratch", scratch)
        if scratch.numel() < plan.scratch:
            raise ValueError(f"scratch: {scratch.numel()} entries, the "
                             f"plan takes {plan.scratch}")
        ts["scratch"] = scratch
    if out is not None:
        check_out(out, free.shape[0], plan.spill_width, free)
        ts.update((f"out[{i}]", t) for i, t in enumerate(out)
                  if t is not None)
    devs = {t.device for t in ts.values()}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted(map(str, devs))}")
    return plan


# -- binding ------------------------------------------------------------------

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = [_P] * 3 + [_I64] * 11 + [_INT] + [_P] * 9


def _fn():
    fn = _build.library("pages").gw_allocate_pages
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
    return fn


# -- wrapper ------------------------------------------------------------------


def allocate_pages_cuda(chg: torch.Tensor, new: torch.Tensor,
                        free: torch.Tensor, page_words: int,
                        bin_words: int, max_spill: int, out=None,
                        scratch=None):
    """``csrc/pages.cu`` ``gw_allocate_pages``: ``(pool_g, pool_c, pool_n,
    page_tab, free_next, spill_bins, scalars)`` as
    :func:`.aoi_pages.allocate_pages_plain` returns them.  ``out``: seven
    tensors or None to write into (the fused paged graph's static pools
    and bundle slices); ``free_next`` must not be ``free``.  ``scratch``:
    int32, at least the plan's ``scratch`` entries (contiguous), or None
    (allocated here)."""
    plan = check_pages(chg, new, free, page_words, bin_words, max_spill,
                       out, scratch)
    if chg.device.type != "cuda":
        raise ValueError(f"the allocate_pages kernel runs on CUDA tensors, "
                         f"got {chg.device}")
    dev = chg.device
    n_pages = free.shape[0]
    outs = [None] * 7 if out is None else list(out)
    outs = [torch.empty(shape, dtype=torch.int32, device=dev) if t is None
            else t for t, shape in zip(outs, out_shapes(n_pages,
                                                        plan.spill_width))]
    if scratch is None:
        scratch = torch.empty(plan.scratch, dtype=torch.int32, device=dev)
    vec = int(chg.data_ptr() % 16 == 0 and new.data_ptr() % 16 == 0
              and bin_words % 4 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn()(chg.data_ptr(), new.data_ptr(), free.data_ptr(),
                   chg.numel(), bin_words, plan.n_bins, n_pages,
                   plan.n_classes, plan.spill_width, plan.blocks,
                   plan.rot_blocks, plan.sum_words, plan.items, plan.tiles,
                   vec, *(t.data_ptr() for t in outs),
                   scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"allocate_pages kernel launch failed: CUDA "
                           f"error {rc}")
    launches["allocate_pages"] += 1
    return tuple(outs)
