"""Observer-row-sharded AOI for ONE oversized space.

Port of the JAX package's ``engine/aoi_rowshard.py``
(``_RowShardTPUBucket``), without its fused, paged and fault-recovery
modes (ROADMAP.md queue 1; ``fused`` is accepted and runs unfused).  The
mesh bucket keeps each space on one shard; a space too large for one
device's tick budget (BASELINE's ``zipf100k``: 100k entities in one
space) shards WITHIN the space: shard d owns the interest rows
``[d*C/n, (d+1)*C/n)`` -- its block of observers -- evaluated against
ALL C candidates.  Work and interest-state memory
split n ways, every shard extracts and encodes its own diff, and the tick
needs no cross-device collective.

  * One bucket per space (``exclusive``): the engine drops it with its
    space.  At C = 131072 the packed state is 2 GiB.
  * Each shard runs the rectangular step (``ops/aoi_cuda.aoi_step_chg``
    with ``cols=`` and ``row_ids=``): its [C/n] observer block against the
    [C] candidate arrays, prev block [C/n, W], ``row_ids = lo + arange``
    so self-exclusion holds across blocks.  The inputs live once per
    distinct device, whole (x, z, r, act [C]); a shard's observer rows are
    a slice of them, so shards of one card share one copy, and the steady
    tick scatters one sparse packet into each distinct device's copy.
  * Events: the mesh bucket's per-shard chunk extraction and encode
    (``aoi_mesh._ShardCodec``); shard d's flat word indices are offset by
    ``d * (C/n) * W`` and expand with one space.
  * The flush is synchronous: events arrive the tick they are computed.
    ``pipeline`` and ``cross_tick`` are accepted and change nothing, as in
    the JAX package: one giant space keeps zero added latency.
  * No host mirror (at this size it would be the whole state):
    ``derive_row``/``derive_col`` fetch one observer's row [W] or one
    column's word over all rows [C] on demand; the port's Space prefers
    them.
  * An unsubscribed space (``set_subscribed(False)``) pays the step only:
    no extraction, no fetch, no decode.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import aoi_cuda as AK
from ..ops import aoi_emit as AE
from ..ops import aoi_predicate as P
from ..ops import aoi_stage as AS
from ..ops import dispatch_count as DC
from .aoi import _Bucket, _emit_expand
from .aoi_mesh import _ShardCodec


class _RowShardCUDABucket(_ShardCodec, _Bucket):
    """ONE space, its interest rows split over the mesh's shards."""

    exclusive = True  # engine: one bucket per space, dropped at release

    def __init__(self, capacity: int, mesh, delta_staging: bool = True,
                 emit: str = "vector", pipeline: bool = False,
                 cross_tick: bool = False, fused: bool = False):
        super().__init__(capacity)
        # accepted and ignored: the flush stays synchronous and unfused
        self.pipeline, self.cross_tick = bool(pipeline), bool(cross_tick)
        self.fused = bool(fused)
        self._emit = emit
        self.mesh = mesh
        self.n_dev = mesh.n_devices
        if capacity % (self.n_dev * 128):
            raise ValueError(
                f"row-sharded capacity {capacity} must be a multiple of "
                f"n_dev*128 = {self.n_dev * 128}")
        self.c_local = capacity // self.n_dev
        self.prev: list[torch.Tensor] | None = None  # per shard [C/n, W]
        # persistent staged inputs [C]; unstaged flushes step nothing
        self._hx = np.zeros(capacity, np.float32)
        self._hz = np.zeros(capacity, np.float32)
        self._hr = np.zeros(capacity, np.float32)
        self._hact = np.zeros(capacity, bool)
        self._pending_clear: list[int] = []
        self._subscribed = True
        self._init_codec(max_chunks=4096, max_exc=16384)
        self.delta_staging = delta_staging
        # the distinct devices of the shards, and per device the whole
        # inputs (role -> tensor [C]), bitwise equal to the shadows
        self._devs = list(dict.fromkeys(mesh.devices))
        self._dev_in: dict | None = None
        self._xz_stale = True
        self._ra_cache: tuple | None = None  # (r, act) last uploaded
        self._delta_max_frac = 0.25
        self._row_ids = [
            torch.arange(d * self.c_local, (d + 1) * self.c_local,
                         dtype=torch.int32, device=dev)[None]
            for d, dev in enumerate(mesh.devices)]
        self._inflight: dict | None = None
        self.full_roundtrips = 0
        self.stats = {"h2d_bytes": 0, "delta_flushes": 0, "full_flushes": 0,
                      "decode_overflow": 0, "emit_path": AE.EMIT_LEVEL[emit]}
        self.perf = {"stage_s": 0.0, "fetch_s": 0.0, "decode_s": 0.0,
                     "emit_s": 0.0}

    # -- the one slot --------------------------------------------------------

    def acquire_slot(self) -> int:
        if self.n_slots:
            raise RuntimeError("row-sharded bucket holds exactly one space")
        self.n_slots = 1
        return 0

    def set_subscribed(self, slot: int, flag: bool) -> None:
        self._subscribed = bool(flag)

    def clear_entity(self, slot: int, entity_slot: int) -> None:
        self._pending_clear.append(entity_slot)
        # the cached inputs keep the departed entity inactive, so a later
        # step cannot re-derive the cleared pairs
        self._hx[entity_slot] = 0.0
        self._hz[entity_slot] = 0.0
        self._hr[entity_slot] = 0.0
        self._hact[entity_slot] = False
        self._xz_stale = True

    # -- device state --------------------------------------------------------

    def _ensure_prev(self) -> None:
        if self.prev is None:
            self.prev = [torch.zeros((self.c_local, self.W), dtype=torch.int32,
                                     device=dev) for dev in self.mesh.devices]

    def _upload(self, roles) -> None:
        """Whole-array upload of ``roles`` to every distinct device."""
        if self._dev_in is None:
            self._dev_in = {dev: {} for dev in self._devs}
        arrs = {"x": self._hx, "z": self._hz, "r": self._hr,
                "act": self._hact}
        for dev in self._devs:
            for role in roles:
                self._dev_in[dev][role] = torch.from_numpy(arrs[role]).to(
                    dev, copy=True)
        self.stats["h2d_bytes"] += len(self._devs) * sum(
            arrs[r].nbytes for r in roles)

    def _stage_inputs(self, old_x, old_z) -> None:
        """Bring every distinct device's inputs up to date with the
        shadows: a sparse (cols, x, z) packet on the steady path, whole
        x/z after a clear, when the changed fraction exceeds
        _delta_max_frac, or without delta staging; r/act re-upload when
        their values change.  The diff compares float BIT PATTERNS."""
        ra = self._ra_cache
        if ra is None or not (np.array_equal(ra[0], self._hr)
                              and np.array_equal(ra[1], self._hact)):
            self._upload(("r", "act"))
            self._ra_cache = (self._hr.copy(), self._hact.copy())
        diff = (self._hx.view(np.uint32) != old_x.view(np.uint32)) \
            | (self._hz.view(np.uint32) != old_z.view(np.uint32))
        n_changed = np.count_nonzero(diff)
        if (self.delta_staging and not self._xz_stale
                and "x" in self._dev_in[self._devs[0]]
                and n_changed <= self._delta_max_frac * diff.size):
            if n_changed:
                cols = np.nonzero(diff)[0]
                pkt = AS.pad_packet(np.zeros(len(cols), np.int32), cols,
                                    self._hx[cols], self._hz[cols])
                for dev in self._devs:
                    t = self._dev_in[dev]
                    DC.record()
                    AS.apply_packet(t["x"].view(1, -1), t["z"].view(1, -1),
                                    *pkt)
                self.stats["h2d_bytes"] += len(self._devs) * (
                    pkt[1].nbytes + pkt[2].nbytes + pkt[3].nbytes)
            self.stats["delta_flushes"] += 1
            return
        self._upload(("x", "z"))
        self._xz_stale = False
        self.stats["full_flushes"] += 1

    def _apply_maintenance(self) -> None:
        """Departed entities: zero their rows on the owning shard and AND
        their column masks into every shard's rows."""
        if not self._pending_clear:
            return
        self._ensure_prev()
        ents = sorted(set(self._pending_clear))
        self._pending_clear.clear()
        DC.record()
        col_mask: dict[int, int] = {}
        for e in ents:
            d, i = divmod(e, self.c_local)
            self.prev[d][i] = 0
            w, b = P.word_bit_for_column(e, self.capacity)
            col_mask[w] = col_mask.get(w, 0xFFFFFFFF) & (~(1 << b)
                                                         & 0xFFFFFFFF)
        for w, m in sorted(col_mask.items()):
            mi = int(np.uint32(m).view(np.int32))
            for blk in self.prev:
                blk[:, w] &= mi

    # -- the flush -------------------------------------------------------------

    def flush(self) -> None:
        """Dispatch immediately followed by harvest; events always arrive
        the tick they are computed."""
        self.dispatch()
        self.harvest()

    def dispatch(self) -> None:
        """Phase 1: maintenance, staging and every shard's rectangular
        step, extraction, encode and scalar copy, enqueued without
        waiting."""
        if self._inflight is not None:
            self.harvest()
        self._apply_maintenance()
        if not self._staged:
            return
        t0 = time.perf_counter()
        sx, sz, sr, sa = self._staged.pop(0)
        self._staged.clear()
        old_x, old_z = self._hx.copy(), self._hz.copy()
        n = len(sx)
        self._hx[:n] = sx
        self._hz[:n] = sz
        self._hr[:n] = sr
        self._hact[:] = False
        self._hact[:n] = sa
        self._ensure_prev()
        self._stage_inputs(old_x, old_z)
        caps = self._caps_now()
        cl = self.c_local
        shards = []
        for d, dev in enumerate(self.mesh.devices):
            t = self._dev_in[dev]
            lo = d * cl
            rows = [t[k][lo:lo + cl][None] for k in ("x", "z", "r", "act")]
            prev = self.prev[d][None]
            out = tuple(o[None] for o in self._step_out(d, self.prev[d]))
            DC.record()
            new, chg = AK.aoi_step_chg(
                *rows, prev, cols=(t["x"][None], t["z"][None],
                                   t["act"][None]),
                row_ids=self._row_ids[d], out=out)
            new, chg = new[0], chg[0]
            self.prev[d] = new
            shards.append(self._encode_shard(new, chg, caps)
                          if self._subscribed else None)
        self._inflight = {"caps": caps, "shards": shards}
        self.perf["stage_s"] += time.perf_counter() - t0

    def harvest(self) -> None:
        """Phase 2: every shard's scalars, stream fetch and decode, one
        space's expansion."""
        rec, self._inflight = self._inflight, None
        if rec is None:
            return
        got = self._decode_shards(rec, self.c_local * self.W)
        t0 = time.perf_counter()
        empty = np.empty((0, 2), np.int32)
        e = lv = empty
        if got is not None:
            pe, pl = _emit_expand(self, *got)
            e = pe[:, 1:] if len(pe) else empty
            lv = pl[:, 1:] if len(pl) else empty
        pend = self._events.get(0)
        if pend is not None:
            e = np.concatenate([pend[0], e])
            lv = np.concatenate([pend[1], lv])
        self._events[0] = (e, lv)
        self.perf["emit_s"] += time.perf_counter() - t0

    # -- state carry and derivation -----------------------------------------

    def get_prev(self, slot: int) -> np.ndarray:
        """The space's words [C, W] uint32 (a full-state fetch)."""
        self.flush()
        if self.prev is None:
            return np.zeros((self.capacity, self.W), np.uint32)
        self.full_roundtrips += 1
        return np.concatenate([P.words_to_numpy(p) for p in self.prev])

    def set_prev(self, slot: int, words: np.ndarray) -> None:
        """Seed the space's words [C, W] uint32 (a full-state upload)."""
        self.flush()
        self._ensure_prev()
        words = np.ascontiguousarray(words, np.uint32)
        cl = self.c_local
        for d, blk in enumerate(self.prev):
            blk.copy_(P.words_to_torch(words[d * cl:(d + 1) * cl],
                                       blk.device))
        self.full_roundtrips += 1

    def peek_words(self, slot: int):
        return None  # no host mirror at this size: derive_row / derive_col

    def derive_row(self, slot: int, entity_slot: int) -> np.ndarray:
        """One observer's interest words [W] uint32 (one row's fetch)."""
        self.flush()
        if self.prev is None:
            return np.zeros(self.W, np.uint32)
        d, i = divmod(entity_slot, self.c_local)
        return P.words_to_numpy(self.prev[d][i])

    def derive_col(self, slot: int, entity_slot: int) -> np.ndarray:
        """Row indices of the observers interested in ``entity_slot`` (the
        packed column), from one word column of every shard."""
        self.flush()
        if self.prev is None:
            return np.empty(0, np.int64)
        w, b = P.word_bit_for_column(entity_slot, self.capacity)
        colw = np.concatenate([P.words_to_numpy(blk[:, w])
                               for blk in self.prev])
        return np.nonzero(colw & (np.uint32(1) << np.uint32(b)))[0]
