"""Observer-row-sharded AOI for ONE oversized space.

Port of the JAX package's ``engine/aoi_rowshard.py``
(``_RowShardTPUBucket``), with its fault recovery and its paged overflow
absorber, without its fused dispatch (ROADMAP.md queue 1, item 2;
``fused`` is accepted and runs unfused).
The mesh bucket keeps each space on one shard; a space too large for one
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
    ``d * (C/n) * W`` and expand with one space.  With ``paged``, a shard
    past its chunk caps is absorbed through the page pool
    (:func:`.aoi._paged_absorb_shard`), as on the mesh bucket.
  * The flush is synchronous: events arrive the tick they are computed.
    ``pipeline`` and ``cross_tick`` are accepted and change nothing, as in
    the JAX package: one giant space keeps zero added latency.
  * No host mirror (at this size it would be the whole state):
    ``derive_row``/``derive_col`` fetch one observer's row [W] or one
    column's word over all rows [C] on demand; the port's Space prefers
    them.
  * An unsubscribed space (``set_subscribed(False)``) pays the step only:
    no extraction, no fetch, no decode.

Faults, as in the JAX bucket: the seams are crossed at the same points
and as often (``aoi.grow`` at the lazy allocation of the words; per
dispatch ``aoi.device``, ``aoi.delta`` or one ``aoi.h2d`` for the x/z
restage, one ``aoi.h2d`` for the sub flag when it changed, ``aoi.kernel``,
then one ``aoi.h2d`` for each of r, act and the candidates' act whose
values changed; at harvest ``aoi.fetch`` and ``aoi.scalars``).  With no
mirror, a tick an injected fault hit recovers from the words before it
-- the ``set_prev`` seed while a plan is active, else the predicate of
the pre-tick shadows -- and publishes the same tick; ``_host_prev``
carries the state while the device is down.  The calculator chain is
the single-device bucket's (:class:`.aoi._CalcChain`): the hand kernel,
the plain PyTorch step, the host oracle.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import faults
from ..ops import aoi_emit as AE
from ..ops import aoi_predicate as P
from ..ops import aoi_stage as AS
from ..ops import dispatch_count as DC
from .aoi import (_Bucket, _build_snapshot, _calc_step, _CalcChain,
                  _check_snapshot, _clear_words, _device_fault, _device_lost,
                  _emit_expand, _packed_predicate, _unpack_positions)
from .aoi_mesh import _ShardCodec


class _RowShardCUDABucket(_ShardCodec, _CalcChain, _Bucket):
    """ONE space, its interest rows split over the mesh's shards."""

    exclusive = True  # engine: one bucket per space, dropped at release
    _kind = "row-sharded AOI bucket"

    def __init__(self, capacity: int, mesh, delta_staging: bool = True,
                 emit: str = "vector", pipeline: bool = False,
                 cross_tick: bool = False, fused: bool = False,
                 paged: bool = False):
        super().__init__(capacity)
        self.paged = bool(paged)  # the overflow absorber (module docstring)
        # accepted and ignored: the flush stays synchronous and unfused
        self.pipeline, self.cross_tick = bool(pipeline), bool(cross_tick)
        self.fused = bool(fused)
        self._emit = emit
        self._emit_requested = emit  # what reset_emit_path re-arms
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
        # role -> the host values last uploaded: "r", "act" and the JAX
        # bucket's replicated "act_all" (one copy here, one crossing
        # there) and "sub" (the flag, kept on the host here)
        self._h2d_cache: dict[str, np.ndarray] = {}
        self._delta_max_frac = 0.25
        self._row_ids = [
            torch.arange(d * self.c_local, (d + 1) * self.c_local,
                         dtype=torch.int32, device=dev)[None]
            for d, dev in enumerate(mesh.devices)]
        self._inflight: dict | None = None
        # fault recovery: the calculator chain, the set_prev seed kept
        # while a plan is active, the words carried on the host while the
        # device is down, and the pre-tick shadows of the tick in flight
        self._init_chain()
        self._seed_prev: np.ndarray | None = None
        self._host_prev: np.ndarray | None = None
        self._cur_old: tuple | None = None
        self._tick_inflight = False
        self.full_roundtrips = 0
        self.stats = {"h2d_bytes": 0, "delta_flushes": 0, "full_flushes": 0,
                      "rebuilds": 0, "fallbacks": 0, "host_ticks": 0,
                      "poisoned": 0, "calc_level": 0,
                      "decode_overflow": 0, "emit_path": AE.EMIT_LEVEL[emit],
                      "fused_dispatches": 0, "fused_demotions": 0,
                      "page_spills": 0, "page_occupancy": 0.0}
        self.perf = {"stage_s": 0.0, "fetch_s": 0.0, "decode_s": 0.0,
                     "emit_s": 0.0}

    # -- the one slot --------------------------------------------------------

    def acquire_slot(self) -> int:
        if self.n_slots:
            raise RuntimeError("row-sharded bucket holds exactly one space")
        self.n_slots = 1
        return 0

    def set_subscribed(self, slot: int, flag: bool) -> None:
        if self._subscribed != bool(flag):
            self._xz_stale = True
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
        self._h2d_cache.pop("act", None)
        self._h2d_cache.pop("r", None)

    # -- device state --------------------------------------------------------

    def _ensure_prev(self) -> None:
        """Allocate the words at the first dispatch (the ``aoi.grow``
        seam), from the host copy after a recovery."""
        if self.prev is not None:
            return
        faults.check("aoi.grow")
        src = self._host_prev
        cl = self.c_local
        self.prev = [
            torch.zeros((cl, self.W), dtype=torch.int32, device=dev)
            if src is None else P.words_to_torch(src[d * cl:(d + 1) * cl],
                                                 dev)
            for d, dev in enumerate(self.mesh.devices)]
        if src is not None:
            self.stats["h2d_bytes"] += src.nbytes
            self._host_prev = None

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

    def _changed(self, role: str, arr: np.ndarray) -> bool:
        """The role's values differ from those last uploaded: record them
        and cross the ``aoi.h2d`` seam, as the JAX bucket's upload does."""
        cached = self._h2d_cache.get(role)
        if cached is not None and np.array_equal(cached, arr):
            return False
        faults.check("aoi.h2d")
        self._h2d_cache[role] = np.array(arr, copy=True)
        return True

    def _stage_xz(self, old_x, old_z, old_r, old_act) -> None:
        """Bring every distinct device's x/z up to date with the shadows:
        a sparse (cols, x, z) packet on the steady path, whole x/z after a
        clear, an r/act/sub change or a recovery, when the changed
        fraction exceeds _delta_max_frac, or without delta staging.  The
        diff compares float BIT PATTERNS."""
        diff = (self._hx.view(np.uint32) != old_x.view(np.uint32)) \
            | (self._hz.view(np.uint32) != old_z.view(np.uint32))
        n_changed = np.count_nonzero(diff)
        if not (np.array_equal(self._hr, old_r)
                and np.array_equal(self._hact, old_act)):
            self._xz_stale = True
        if (self.delta_staging and not self._xz_stale
                and self._dev_in is not None
                and "x" in self._dev_in[self._devs[0]]
                and n_changed <= self._delta_max_frac * diff.size):
            if n_changed:
                faults.check("aoi.delta")
                cols = np.nonzero(diff)[0]
                pkt = AS.pad_packet(np.zeros(len(cols), np.int32), cols,
                                    self._hx[cols], self._hz[cols],
                                    page_granular=self.paged)
                for dev in self._devs:
                    t = self._dev_in[dev]
                    DC.record()
                    AS.apply_packet(t["x"].view(1, -1), t["z"].view(1, -1),
                                    *pkt)
                self.stats["h2d_bytes"] += len(self._devs) * (
                    pkt[1].nbytes + pkt[2].nbytes + pkt[3].nbytes)
            self.stats["delta_flushes"] += 1
            return
        faults.check("aoi.h2d")
        self._upload(("x", "z"))
        self._xz_stale = False
        self.stats["full_flushes"] += 1

    def _apply_maintenance(self) -> None:
        """Departed entities: zero their rows on the owning shard and AND
        their column masks into every shard's rows (into the host copy
        while the device is down)."""
        if not self._pending_clear:
            return
        ents = sorted(set(self._pending_clear))
        self._pending_clear.clear()
        if self.prev is None:
            if self._host_prev is not None:
                _clear_words(self._host_prev, ents, self.capacity)
            return
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
        waiting (at calc level 2: the host tick, parked for harvest)."""
        if self._inflight is not None or self._oracle is not None:
            self.harvest()
        if self._calc_level >= 2:
            self._dispatch_oracle()
            return
        try:
            self._dispatch_device()
        except Exception as e:
            if not _device_fault(e):
                raise
            self._recover(e)
            if _device_lost(e):
                self._mark_evacuating()

    def harvest(self) -> None:
        """Phase 2: every shard's scalars, stream fetch and decode, one
        space's expansion.  A device fault here recovers the tick from the
        pre-tick state (the tick stays armed until its events land)."""
        old, self._oracle = self._oracle, None
        if old is not None:
            self._host_tick(old)
            return
        rec, self._inflight = self._inflight, None
        if rec is None:
            return
        self._fault_phase = "harvest"
        try:
            self._harvest(rec)
        except Exception as e:
            if not _device_fault(e):
                raise
            self._recover(e)
            if _device_lost(e):
                self._mark_evacuating()
            return
        # the tick delivered: the words are the predicate of the shadows
        # again, so a set_prev seed is no longer the recovery base
        self._seed_prev = None
        self._tick_inflight = False

    def _restage_shadows(self) -> None:
        """Pop the staged tick into the shadows, keeping the pre-tick
        values in ``_cur_old`` (the staging's diff base and the recovery's
        old state)."""
        sx, sz, sr, sa = self._staged.pop(0)
        self._staged.clear()
        self._cur_old = (self._hx.copy(), self._hz.copy(), self._hr.copy(),
                         self._hact.copy())
        n = len(sx)
        self._hx[:n] = sx
        self._hz[:n] = sz
        self._hr[:n] = sr
        self._hact[:] = False
        self._hact[:n] = sa

    def _dispatch_device(self) -> None:
        self._fault_phase = "stage"
        faults.check("aoi.device")  # the shards' health probe
        self._apply_maintenance()
        if not self._staged:
            return
        t0 = time.perf_counter()
        self._restage_shadows()
        self._tick_inflight = True  # a restaged tick awaits its events
        self._ensure_prev()
        self._stage_xz(*self._cur_old)
        # the crossings of the JAX bucket's uploads, in its order: the sub
        # flag, the kernel, then r, act and the candidates' act
        self._changed("sub", np.array(self._subscribed))
        self._fault_phase = "kernel"
        faults.check("aoi.kernel")
        ra = [self._changed("r", self._hr), self._changed("act", self._hact)]
        self._changed("act_all", self._hact)
        if any(ra) or "r" not in self._dev_in[self._devs[0]]:
            self._upload(("r", "act"))
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
            new, chg = _calc_step(
                self._calc_level, *rows, prev,
                cols=(t["x"][None], t["z"][None], t["act"][None]),
                row_ids=self._row_ids[d], out=out)
            new, chg = new[0], chg[0]
            self.prev[d] = new
            shards.append(self._encode_shard(new, chg, caps)
                          if self._subscribed else None)
        self._inflight = {"caps": caps, "shards": shards}
        self.perf["stage_s"] += time.perf_counter() - t0

    def _harvest(self, rec: dict) -> None:
        got = self._decode_shards(rec, self.c_local * self.W,
                                  filter_empty=True)
        t0 = time.perf_counter()
        e = lv = np.empty((0, 2), np.int32)
        if got is not None:
            e, lv = self._pairs(*got)
        self._add_events(e, lv)
        self.perf["emit_s"] += time.perf_counter() - t0

    def _pairs(self, chg_vals, ent_vals, gidx):
        """One space's classified stream -> its (enter, leave) pairs."""
        empty = np.empty((0, 2), np.int32)
        pe, pl = _emit_expand(self, chg_vals, ent_vals, gidx)
        return (pe[:, 1:] if len(pe) else empty,
                pl[:, 1:] if len(pl) else empty)

    def _add_events(self, e, lv) -> None:
        pend = self._events.get(0)
        if pend is not None:
            e = np.concatenate([pend[0], e])
            lv = np.concatenate([pend[1], lv])
        self._events[0] = (e, lv)

    # -- fault recovery ------------------------------------------------------

    def _old_prev_host(self) -> np.ndarray:
        """The pre-tick words, rebuilt on the host: the set_prev seed if
        one is live, else the predicate of the pre-tick shadows (exact:
        the words are the predicate of the last stepped inputs, and
        clear_entity keeps the shadows consistent), with the queued
        clears landed."""
        if self._seed_prev is not None:
            old = self._seed_prev.copy()
        elif self._cur_old is not None:
            old = _packed_predicate(*self._cur_old)
        else:
            old = np.zeros((self.capacity, self.W), np.uint32)
        _clear_words(old, sorted(set(self._pending_clear)), self.capacity)
        self._pending_clear.clear()
        return old

    def _recover(self, e: BaseException) -> None:
        """Device fault: recompute the tick in flight on the host
        (bit-exact), publish it, and drop the device state."""
        self._count_fault(e)
        staged = self._tick_inflight or bool(self._staged)
        if staged:
            if not self._tick_inflight:
                self._restage_shadows()
        else:
            # maintenance only: no events to recover, only the state; the
            # shadows ARE the last stepped inputs
            self._cur_old = (self._hx, self._hz, self._hr, self._hact)
        old_prev = self._old_prev_host()
        self.prev = None
        self._dev_in = None
        self._xz_stale = True
        self._h2d_cache.clear()
        self._scratch = None
        self._page_free = None  # the free list lived on the devices
        if staged:
            self._host_tick(old_prev)
        else:
            self._host_prev = old_prev
            self._seed_prev = None
            self._cur_old = None
        self._tick_inflight = False

    def _host_tick(self, old_prev: np.ndarray) -> None:
        """One tick on the host from the durable copies, bit-exact with
        the sharded step (the global flat word order is the per-shard
        extraction's after the shard offset)."""
        self.stats["host_ticks"] += 1
        new = _packed_predicate(self._hx, self._hz, self._hr, self._hact)
        e = lv = np.empty((0, 2), np.int32)
        if self._subscribed:
            flat = (new ^ old_prev).reshape(-1)
            gidx = np.nonzero(flat)[0]
            chg_vals = flat[gidx]
            e, lv = self._pairs(chg_vals, chg_vals & new.reshape(-1)[gidx],
                                gidx)
        self._add_events(e, lv)
        self._host_prev = new
        self._seed_prev = None
        self._cur_old = None

    def _dispatch_oracle(self) -> None:
        """Level-2 dispatch: the device is out of the loop and
        ``_host_prev`` holds the words; maintenance and restaging run now,
        the host compute at harvest."""
        if self._host_prev is None:
            self._host_prev = np.zeros((self.capacity, self.W), np.uint32)
        if self._pending_clear:
            _clear_words(self._host_prev, sorted(set(self._pending_clear)),
                         self.capacity)
            self._pending_clear.clear()
        if not self._staged:
            return
        self._restage_shadows()
        self._oracle = (self._seed_prev if self._seed_prev is not None
                        else self._host_prev)

    # -- state carry and derivation -----------------------------------------

    def get_prev(self, slot: int) -> np.ndarray:
        """The space's words [C, W] uint32 (a full-state fetch; the host
        copy while the device is down)."""
        self.flush()
        if self.prev is None:
            if self._host_prev is not None:
                return self._host_prev.copy()
            return np.zeros((self.capacity, self.W), np.uint32)
        self.full_roundtrips += 1
        return np.concatenate([P.words_to_numpy(p) for p in self.prev])

    def set_prev(self, slot: int, words: np.ndarray) -> None:
        """Seed the space's words [C, W] uint32 (a full-state upload; on
        the host until the first dispatch or while the device is down)."""
        self.flush()
        words = np.ascontiguousarray(words, np.uint32)
        if self._calc_level >= 2 or self.prev is None:
            self._host_prev = words.copy()
            self._seed_prev = None
            return
        cl = self.c_local
        for d, blk in enumerate(self.prev):
            blk.copy_(P.words_to_torch(words[d * cl:(d + 1) * cl],
                                       blk.device))
        self.full_roundtrips += 1
        if self._ft:
            # the seed is the only durable copy of carried-in state until
            # the next step: keep it on the host while a plan is active
            self._seed_prev = words.copy()

    def export_snapshot(self, slot: int) -> dict:
        """The space's wire image from its 1-D shadows and words (the
        flush is synchronous: nothing in flight to deliver; on a lost
        device from the host copy)."""
        return _build_snapshot(self.capacity, self._hx, self._hz, self._hr,
                               self._hact, self._subscribed,
                               self.get_prev(slot))

    def import_snapshot(self, slot: int, snap: dict) -> None:
        """The snapshot into the shadows, the subscription flag and the
        words; the device inputs re-upload whole at the next tick."""
        _check_snapshot(snap, self.capacity)
        x, z = _unpack_positions(snap)
        self._hx[:] = x
        self._hz[:] = z
        self._hr[:] = snap["r"]
        self._hact[:] = snap["act"]
        self.set_subscribed(slot, snap["sub"])
        self._xz_stale = True
        self._h2d_cache.clear()
        self.set_prev(slot, snap["words"])
        if self._ft:
            # set_prev kept the words on the host and dropped the seed;
            # under a plan the seed is the recovery base of a fault on the
            # first tick after the import (the words need not be the
            # predicate of the shadows until that tick lands)
            self._seed_prev = np.ascontiguousarray(snap["words"], np.uint32)

    def peek_words(self, slot: int):
        return None  # no host mirror at this size: derive_row / derive_col

    def derive_row(self, slot: int, entity_slot: int) -> np.ndarray:
        """One observer's interest words [W] uint32 (one row's fetch)."""
        self.flush()
        if self.prev is None:
            if self._host_prev is not None:
                return self._host_prev[entity_slot].copy()
            return np.zeros(self.W, np.uint32)
        d, i = divmod(entity_slot, self.c_local)
        return P.words_to_numpy(self.prev[d][i])

    def derive_col(self, slot: int, entity_slot: int) -> np.ndarray:
        """Row indices of the observers interested in ``entity_slot`` (the
        packed column), from one word column of every shard."""
        self.flush()
        w, b = P.word_bit_for_column(entity_slot, self.capacity)
        if self.prev is None:
            if self._host_prev is None:
                return np.empty(0, np.int64)
            colw = self._host_prev[:, w]
        else:
            colw = np.concatenate([P.words_to_numpy(blk[:, w])
                                   for blk in self.prev])
        return np.nonzero(colw & (np.uint32(1) << np.uint32(b)))[0]

