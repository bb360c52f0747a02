"""Mesh-sharded AOI bucket: the engine's multi-device path.

Port of the JAX package's ``engine/aoi_mesh.py`` (``_MeshTPUBucket``),
with its pipelined mode and its fault recovery, without its fused and
paged modes (ROADMAP.md queue 1 names the item that brings each;
``fused`` is accepted and runs unfused).  The bucket's slots (spaces)
are placed across a :class:`..parallel.SpaceMesh`: shard d holds slots
``[d * S/n, (d + 1) * S/n)`` on its device, so every space's [C] rows
live wholly on one shard and the tick needs no cross-device collective.

Per flush, every shard's work is enqueued before the first wait:

    per shard:  the AOI step (ops/aoi_cuda.aoi_step_chg: the Hopper kernel
                on a CUDA shard, its plain version on a CPU shard)
                -> subscription mask
                -> chunk-compacted diff extraction (ops/events.extract_chunks)
                -> row-stream encode (ops/events.encode_row_stream)
                -> five scalars, copied asynchronously to pinned host memory

Harvest then waits for each shard's scalars, fetches and decodes its
stream (``decode_row_stream``) with the same overflow contract as the JAX
bucket -- a shard past its chunk caps is recovered from its raw grids, a
shard past its encode caps from its chunk grids, both counted in
``stats["decode_overflow"]``, and the caps grow -- offsets the shard-local
word indices to global ones and publishes per-slot enter/leave pairs,
equal to every other backend's.

Differences from the single-device bucket (as in the JAX package):

  * ALL slots step every flush (no gather across shards).  Unstaged slots
    re-step their cached previous inputs: identical inputs give a zero
    diff, so they emit nothing and their words are rewritten unchanged.
    ``clear_entity`` marks the departed entity inactive in the cached
    inputs too, so a cleared-but-unstaged slot stays silent.
  * A slot whose words were seeded with ``set_prev`` (growth) MUST be
    staged before the next flush -- stepping cached zero inputs against
    carried state would emit a mass leave; ``flush`` raises instead.

``pipeline`` / ``cross_tick`` defer delivery by one tick exactly as the
single-device bucket does (:class:`.aoi._CUDABucket`): a flush dispatches
tick T and harvests T-1, whose scalars and optimistically sized stream
slices (``_pred``, refit to every harvest's per-shard peaks) were copied
to pinned host memory at its dispatch; ``drain`` delivers the tick in
flight.

Faults: the bucket crosses the JAX mesh bucket's seams at the same points
(``aoi.grow`` at growth; per dispatch ``aoi.device``, then ``aoi.delta``
or one ``aoi.h2d`` for the x/z restage, ``aoi.kernel``, and one
``aoi.h2d`` for each of r, act and sub whose values changed; at harvest
``aoi.fetch``, ``aoi.scalars`` on the [shards, 5] scalars, validated, and
``aoi.emit`` in ``native`` mode), and on an injected fault recovers,
demotes and rebuilds as the single-device bucket does (:class:`.aoi._Deferred`): level 1 is the
plain PyTorch step on each shard, level 2 the host oracle.

Where JAX donates its scratch buffers to the jitted step, each shard here
keeps reusable word arrays: after a step the old ``prev`` becomes the next
step's ``new`` buffer, and the ``chg`` outputs rotate through a ring (two
deep when deferred: the parked record still holds the previous tick's),
so a steady tick allocates no word array.  A record keeps each shard's
``new`` words for its overflow recovery.  Maintenance never
round-trips the full state: resets and clears are in-place tensor ops on
the slot's shard, ``set_prev``/``get_prev`` move one slot's [C, W] words,
and growth regroups the shards device to device.  ``full_roundtrips``
counts full-state host copies (the first mirror seed only), so tests can
pin the steady state to zero.
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
from ..ops import events as EV
from .aoi import (_LANES, _Bucket, _calc_step, _CapDecay, _Deferred,
                  _device_fault, _emit_expand, _log, _packed_predicate,
                  _split_rows, refuse_later)


def _np_words(t: torch.Tensor) -> np.ndarray:
    """Fetched int32 device words as host uint32."""
    return t.cpu().numpy().view(np.uint32)


class _ShardCodec:
    """The per-shard event path both sharded buckets share: the encoded
    stream of one shard's diff, and its decode at harvest with the JAX
    buckets' overflow contract (``_harvest`` of ``aoi_mesh.py`` and
    ``aoi_rowshard.py``).  The owner sets the caps and ``stats``."""

    def _init_codec(self, max_chunks: int, max_exc: int,
                    ring: int = 1) -> None:
        # per-shard extraction caps: grow on overflow, decay through the
        # shared window so a mass-enter storm stops sizing later ticks
        self._max_chunks = max_chunks
        self._kcap = 8
        self._max_gaps = 2048
        self._max_exc = max_exc
        self._caps = _CapDecay(nd_floor=max_chunks)
        # per shard: the spare words buffer and a ring of `ring` chg buffers
        self._ring = ring
        self._scratch: list | None = None
        # optimistic per-shard prefetch of a deferred record's stream:
        # (rows, escapes, exceptions), refit to every harvest
        self._pred = (256, 64, 256)

    def _caps_now(self) -> tuple:
        return (self._max_chunks, self._kcap, self._max_gaps, self._max_exc)

    def _step_out(self, d: int, prev: torch.Tensor):
        """Shard d's output pair for a step from ``prev``: the spare words
        buffer (the words before the last step) and the ring's next chg
        buffer.  ``prev`` becomes the spare for the step after."""
        if self._scratch is None:
            self._scratch = [None] * self.n_dev
        sc = self._scratch[d]
        if sc is None or sc["chg"][0].shape != prev.shape:
            sc = self._scratch[d] = {
                "spare": None, "k": 0,
                "chg": [torch.empty_like(prev) for _ in range(self._ring)]}
        new = sc["spare"]
        if new is None or new.shape != prev.shape:
            new = torch.empty_like(prev)
        chg = sc["chg"][sc["k"]]
        sc["k"] = (sc["k"] + 1) % self._ring
        sc["spare"] = prev
        return new, chg

    def _encode_shard(self, new, chg, caps, pred=None) -> dict:
        """Enqueue the extraction, the encode and the async copy of the
        five control scalars of one shard's (masked) diff, and with
        ``pred`` = (rows, escapes, exceptions) the copy of the stream's
        first slices of those sizes (the deferred prefetch)."""
        mc, kcap, mg, mx = caps
        vals, nv, lane, csel, ccnt, nd, mcc = EV.extract_chunks(
            chg, mc, kcap, aux=new, lanes=_LANES)
        (rowb, bitpos, woff, base_row, n_esc, esc_rows, exc_gidx, exc_chg,
         exc_new, exc_n) = EV.encode_row_stream(
            vals, nv, lane, csel, ccnt, w=_LANES, max_gaps=mg, max_exc=mx)
        streams = (rowb, bitpos, woff, esc_rows, exc_gidx, exc_chg, exc_new)
        scalars = torch.stack([nd, mcc, base_row, n_esc, exc_n]).to(
            torch.int64)
        ready = pf = None
        if pred is not None:
            ndp, escp, excp = min(mc, pred[0]), min(mg, pred[1]), \
                min(mx, pred[2])
            pf = (ndp, escp, excp,
                  [a[:n] for a, n in zip(streams, (ndp,) * 3 + (escp,)
                                         + (excp,) * 3)])
        if scalars.device.type == "cuda":
            scal_h = torch.empty(5, dtype=torch.int64, pin_memory=True)
            scal_h.copy_(scalars, non_blocking=True)
            if pf is not None:
                host = []
                for a in pf[3]:
                    h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                    h.copy_(a, non_blocking=True)
                    host.append(h)
                pf = pf[:3] + (host,)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(scalars.device))
        else:
            scal_h = scalars
            if pf is not None:
                pf = pf[:3] + ([a.clone() for a in pf[3]],)
        return {"new": new, "chg": chg, "chunks": (vals, nv, lane, csel),
                "streams": streams, "scal": scal_h, "ready": ready,
                "prefetch": pf}

    def _detach_parked_new(self) -> None:
        """Before a shard's ``prev`` is written in place: a parked record
        whose new words ARE that tensor keeps a copy (its overflow
        recovery reads them)."""
        for rec in (self._inflight, self._due):
            for d, sh in enumerate(rec.get("shards", ()) if rec else ()):
                if sh is not None and sh["new"] is self.prev[d]:
                    sh["new"] = sh["new"].clone()

    def _decode_shards(self, rec, shard_words: int,
                       filter_empty: bool = False):
        """Wait for every shard's scalars, then fetch (from the prefetched
        slices when they hold the stream) and decode its stream, or
        recover it past a cap from the record's grids.  Returns the
        classified stream ``(chg_vals, ent_vals, gidx)`` with global flat
        word indices (shard d's offset by ``d * shard_words``), or None
        when every shard is empty.

        The fault seams of the JAX buckets' harvest: ``aoi.fetch`` before
        the wait, ``aoi.scalars`` on the [shards, 5] scalars (only when a
        shard was extracted, or ``filter_empty``).  Scalars that fail
        validation are counted in ``poisoned`` and every shard recovers
        from its raw grids, without cap growth."""
        faults.check("aoi.fetch")  # stallable: a delayed host sync
        mc, kcap, mg, mx = rec["caps"]
        t0 = time.perf_counter()
        scal = np.zeros((self.n_dev, 5), np.int64)
        for d, sh in enumerate(rec["shards"]):
            if sh is not None:
                if sh["ready"] is not None:
                    sh["ready"].synchronize()
                scal[d] = sh["scal"].numpy()
        poisoned = False
        if filter_empty or any(sh is not None for sh in rec["shards"]):
            scal = faults.filter("aoi.scalars", scal)
            chunks = shard_words // _LANES
            if not ((scal >= 0).all() and (scal[:, 0] <= chunks).all()
                    and (scal[:, 1] <= _LANES).all()
                    and (scal[:, 2] <= chunks).all()
                    and (scal[:, 3] <= shard_words).all()
                    and (scal[:, 4] <= shard_words).all()):
                self.stats["poisoned"] += 1
                _log.warning("AOI control scalars failed validation (%r); "
                             "recovering the tick from the raw grids",
                             scal.tolist())
                poisoned = True
        self.perf["fetch_s"] += time.perf_counter() - t0
        all_c, all_e, all_g = [], [], []
        grew = False
        peak_nd = peak_mcc = peak_esc = peak_exc = 0
        for d, sh in enumerate(rec["shards"]):
            if poisoned:
                if sh is None:
                    continue
                t0 = time.perf_counter()
                gidx, chg_vals, ent_vals = self._raw_stream(sh)
                self.perf["fetch_s"] += time.perf_counter() - t0
                all_c.append(chg_vals)
                all_e.append(ent_vals)
                all_g.append(gidx + d * shard_words)
                continue
            nd, mcc, base_row, n_esc, exc_n = (int(v) for v in scal[d])
            if nd == 0 and exc_n == 0:
                continue
            t0 = time.perf_counter()
            if nd > mc or mcc > kcap:
                # the shard's stream is incomplete: recover from its raw
                # grids (the nonzero words found on the device) and grow
                # the chunk caps for the next flush
                self._max_chunks = max(self._max_chunks, 2 * nd)
                self._kcap = min(max(self._kcap, 2 * mcc), _LANES)
                self.stats["decode_overflow"] += 1
                grew = True
                gidx, chg_vals, ent_vals = self._raw_stream(sh)
                self.perf["fetch_s"] += time.perf_counter() - t0
            elif n_esc > mg or exc_n > mx:
                # encode overflow: rebuild from the kept chunk grids
                self._max_gaps = max(mg, 2 * n_esc)
                self._max_exc = max(mx, 2 * exc_n)
                self.stats["decode_overflow"] += 1
                grew = True
                vals, nv, lane, csel = sh["chunks"]
                vh, nh = _np_words(vals), _np_words(nv)
                lh, ch = lane.cpu().numpy(), csel.cpu().numpy()
                valid = lh >= 0
                chg_vals = vh[valid]
                ent_vals = chg_vals & nh[valid]
                gidx = (ch[:, None].astype(np.int64) * _LANES + lh)[valid]
                self.perf["fetch_s"] += time.perf_counter() - t0
            else:
                pf = sh["prefetch"]
                nds, ne, nx = max(nd, 1), max(n_esc, 1), max(exc_n, 1)
                if pf is not None and pf[0] >= nds and pf[1] >= ne \
                        and pf[2] >= nx:
                    self.stats["prefetch_hits"] += 1
                    hb = [a.numpy() for a in pf[3]]
                else:
                    if pf is not None:
                        self.stats["prefetch_misses"] += 1
                    hb = [a[:n].cpu().numpy() for a, n in zip(
                        sh["streams"], (nds,) * 3 + (ne,) + (nx,) * 3)]
                self.perf["fetch_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                chg_vals, ent_vals, gidx = EV.decode_row_stream(
                    hb[0], hb[1], hb[2].astype(np.uint16), base_row, nd,
                    _LANES, hb[3], hb[4], hb[5], hb[6])
                self.perf["decode_s"] += time.perf_counter() - t0
            peak_nd = max(peak_nd, nd)
            peak_mcc = max(peak_mcc, mcc)
            peak_esc = max(peak_esc, n_esc)
            peak_exc = max(peak_exc, exc_n)
            all_c.append(chg_vals)
            all_e.append(ent_vals)
            all_g.append(np.asarray(gidx, np.int64) + d * shard_words)
        if grew:
            self._caps.reset_after_growth()
        elif not poisoned:  # poisoned peaks are zeros, not observations
            shrink = self._caps.observe(peak_nd, peak_mcc, self._max_chunks,
                                        self._kcap)
            if shrink is not None:
                self._max_chunks, self._kcap = shrink
        # refit the next deferred prefetch to this tick's per-shard peaks
        # (fresh, not a running max: sizes must decay after a storm)
        self._pred = (
            max(256, min(mc, -(-(peak_nd * 5 // 4) // 128) * 128)),
            max(64, -(-(peak_esc + 1) * 3 // 2 // 64) * 64),
            max(256, -(-(peak_exc + 1) * 5 // 4 // 256) * 256))
        if not all_c:
            return None
        return (np.concatenate(all_c), np.concatenate(all_e),
                np.concatenate(all_g))

    @staticmethod
    def _raw_stream(sh):
        """One shard's classified stream from its raw grids: (gidx,
        chg_vals, ent_vals), ascending flat order."""
        flat = sh["chg"].reshape(-1)
        gi = torch.nonzero(flat).reshape(-1)
        cv = flat[gi]
        ev = cv & sh["new"].reshape(-1)[gi]
        return gi.cpu().numpy(), _np_words(cv), _np_words(ev)

    # -- not in the port yet ------------------------------------------------

    def export_snapshot(self, slot: int):
        refuse_later("export_snapshot")

    def import_snapshot(self, slot: int, snap) -> None:
        refuse_later("import_snapshot")

    def evacuate(self):
        refuse_later("evacuate")


class _MeshCUDABucket(_ShardCodec, _Deferred, _Bucket):
    """Interest state [S, C, W] int32 split over the mesh's shards (S a
    multiple of the shard count, grown from ``n_dev`` by doubling); one
    step per shard per flush, every slot stepped."""

    def __init__(self, capacity: int, mesh, delta_staging: bool = True,
                 emit: str = "vector", pipeline: bool = False,
                 cross_tick: bool = False, fused: bool = False):
        super().__init__(capacity)
        self._emit = emit
        self._emit_requested = emit  # what reset_emit_path re-arms
        self.mesh = mesh
        self.n_dev = mesh.n_devices
        self.delta_staging = delta_staging
        self.pipeline = bool(pipeline)
        self.cross_tick = bool(cross_tick)
        self.fused = bool(fused)  # accepted; the mesh runs every tick unfused
        self._init_faults()
        self.s_max = 0
        self.prev: list[torch.Tensor] | None = None  # per shard [b, C, W]
        # host shadows of the staged inputs, persistent: unstaged slots
        # re-step their previous values (zero diff)
        self._hx = np.zeros((0, capacity), np.float32)
        self._hz = np.zeros((0, capacity), np.float32)
        self._hr = np.zeros((0, capacity), np.float32)
        self._hact = np.zeros((0, capacity), bool)
        self._hsub = np.ones(0, bool)
        self._unsub: set[int] = set()
        self._mirror_stale: set[int] = set()
        self._pending_reset: set[int] = set()
        self._pending_clear: list[tuple[int, int]] = []
        # slots seeded via set_prev and not staged since (module docstring)
        self._seeded_unstaged: set[int] = set()
        self._init_codec(max_chunks=1024, max_exc=8192,
                         ring=2 if self._defer else 1)
        # device copies of r/act/sub, re-uploaded only when values change
        self._h2d_cache: dict[str, tuple] = {}
        # per-shard device x/z, bitwise equal to the shadows; steady
        # flushes scatter a sparse packet into each shard's own rows.
        # _xz_stale: the copies must re-upload whole (growth, a reset, a
        # clear, an r/act/sub change, a recovery), as in the JAX bucket
        self._dx: list | None = None
        self._dz: list | None = None
        self._xz_stale = True
        self._delta_max_frac = 0.25
        # the record parked across flushes (deferral), and the record the
        # next harvest() delivers
        self._inflight: dict | None = None
        self._due: dict | None = None
        # per-slot release epoch: a harvest must not publish events (or XOR
        # mirror words) for a slot released after its dispatch
        self._slot_epoch: dict[int, int] = {}
        # host mirror of the words (see _CUDABucket); clears issued between
        # a dispatch and its harvest apply after its stream
        self._mirror: np.ndarray | None = None
        self._mirror_ops: list[tuple] = []
        self.full_roundtrips = 0
        self.stats = {"h2d_bytes": 0, "delta_flushes": 0, "full_flushes": 0,
                      "rebuilds": 0, "fallbacks": 0, "host_ticks": 0,
                      "poisoned": 0, "calc_level": 0,
                      "decode_overflow": 0, "emit_path": AE.EMIT_LEVEL[emit],
                      "fused_dispatches": 0, "fused_demotions": 0,
                      "prefetch_hits": 0, "prefetch_misses": 0}
        self.perf = {"stage_s": 0.0, "fetch_s": 0.0, "decode_s": 0.0,
                     "emit_s": 0.0}

    # -- slot management ---------------------------------------------------

    def _loc(self, slot: int) -> tuple[int, int]:
        """(shard, row within the shard) of a slot."""
        b = self.s_max // self.n_dev
        return slot // b, slot % b

    def _grow_to(self, n_slots: int) -> None:
        if n_slots <= self.s_max:
            return
        self.drain()
        new_s = max(self.n_dev, self.s_max)
        while new_s < n_slots:
            new_s *= 2
        for name in ("_hx", "_hz", "_hr"):
            arr = getattr(self, name)
            grown = np.zeros((new_s, self.capacity), np.float32)
            grown[: arr.shape[0]] = arr
            setattr(self, name, grown)
        hact = np.zeros((new_s, self.capacity), bool)
        hact[: self._hact.shape[0]] = self._hact
        self._hact = hact
        hsub = np.ones(new_s, bool)
        hsub[: self._hsub.shape[0]] = self._hsub
        self._hsub = hsub
        if self._need_rebuild or self._calc_level >= 2:
            # the device words are down: the mirror grows on the host and
            # the next rebuild uploads it grown
            self.prev = None
        else:
            try:
                faults.check("aoi.grow")
                self.prev = self._regroup(new_s)
            except Exception as e:
                if not _device_fault(e):
                    raise
                # the old words are intact: the mirror seeds from them
                self._ensure_mirror()
                self.stats["rebuilds"] += 1
                self.prev = None
                self._need_rebuild = True
                _log.warning("mesh AOI bucket grow to %d slots hit a device "
                             "fault (%s); the words stay in the host mirror "
                             "until the next dispatch rebuilds", new_s, e)
        if self._mirror is not None:
            grown = np.zeros((new_s, self.capacity, self.W), np.uint32)
            grown[: self._mirror.shape[0]] = self._mirror
            self._mirror = grown
        elif self._ft:
            # a fault plan keeps the durable copy from the start (the
            # first growth: the words are zero)
            self._mirror = np.zeros((new_s, self.capacity, self.W),
                                    np.uint32)
        self.s_max = new_s
        self._h2d_cache.clear()
        self._dx = self._dz = None
        self._xz_stale = True
        self._scratch = None

    def _regroup(self, new_s: int) -> list[torch.Tensor]:
        """The words regrouped into the blocks of ``new_s`` slots, device
        to device."""
        b_old, b_new = self.s_max // self.n_dev, new_s // self.n_dev
        prev = []
        for d, dev in enumerate(self.mesh.devices):
            blk = torch.zeros((b_new, self.capacity, self.W),
                              dtype=torch.int32, device=dev)
            lo = d * b_new
            for e in range(self.n_dev if self.prev is not None else 0):
                a, b = max(lo, e * b_old), min(lo + b_new, (e + 1) * b_old)
                if a < b:
                    blk[a - lo:b - lo] = self.prev[e][a - e * b_old:
                                                      b - e * b_old].to(dev)
            prev.append(blk)
        return prev

    def _reset_slot(self, slot: int) -> None:
        self._pending_reset.add(slot)
        # a reused slot's cached inputs are stale: it steps inert until its
        # space stages real arrays
        self._hx[slot] = 0.0
        self._hz[slot] = 0.0
        self._hr[slot] = 0.0
        self._hact[slot] = False
        self._xz_stale = True
        self._seeded_unstaged.discard(slot)
        self._unsub.discard(slot)  # subscription is per-occupant
        self._hsub[slot] = True
        self._mirror_stale.discard(slot)
        if self._mirror is not None:
            self._mirror[slot] = 0

    def release_slot(self, slot: int) -> None:
        self._slot_epoch[slot] = self._slot_epoch.get(slot, 0) + 1
        # a seeded slot released before staging is dead, not mis-staged
        self._seeded_unstaged.discard(slot)
        super().release_slot(slot)

    def set_subscribed(self, slot: int, flag: bool) -> None:
        if flag:
            self._unsub.discard(slot)
        else:
            self._unsub.add(slot)
        if slot < self._hsub.shape[0] and self._hsub[slot] != flag:
            self._hsub[slot] = flag
            self._xz_stale = True

    def clear_entity(self, slot: int, entity_slot: int) -> None:
        self._pending_clear.append((slot, entity_slot))
        # the departed entity is inactive in the cached inputs too, so an
        # unstaged re-step cannot re-derive the cleared pairs
        if slot < self._hact.shape[0]:
            self._hact[slot, entity_slot] = False
            self._xz_stale = True
        self._queue_mirror_clear(slot, entity_slot)

    # -- the device hooks of the recovery ----------------------------------

    def _drop_device(self) -> None:
        self.prev = None
        self._dx = self._dz = None
        self._xz_stale = True
        self._h2d_cache.clear()
        self._scratch = None

    def _prev_to_numpy(self) -> np.ndarray:
        self.full_roundtrips += 1
        return np.concatenate([P.words_to_numpy(p) for p in self.prev])

    def _upload_prev(self, words: np.ndarray) -> None:
        b = self.s_max // self.n_dev
        self.prev = [P.words_to_torch(words[d * b:(d + 1) * b], dev)
                     for d, dev in enumerate(self.mesh.devices)]
        self.full_roundtrips += 1

    def _check_restaged(self) -> None:
        if self._seeded_unstaged:
            raise RuntimeError(
                "mesh AOI bucket: slots %r carry seeded interest state but "
                "were not staged before flush -- stepping them would emit a "
                "spurious mass-leave (stage the space first)"
                % sorted(self._seeded_unstaged))

    # -- state carry and host views ----------------------------------------

    def peek_words(self, slot: int) -> np.ndarray:
        """Host mirror of the slot's words [C, W] uint32 (seeded with one
        fetch of the whole state, then kept current by each harvest; a
        slot that was unsubscribed refreshes its rows on demand)."""
        if self._mirror is None:
            self.flush()
            self.drain()
            self._ensure_mirror()
            for s in sorted(self._pending_reset):
                self._mirror[s] = 0
            for s, e in self._pending_clear:
                self._mirror_clear(s, e)
            self._mirror_stale.clear()
        elif slot in self._mirror_stale:
            self.flush()
            self.drain()
            if self.prev is not None:
                d, i = self._loc(slot)
                self._mirror[slot] = P.words_to_numpy(self.prev[d][i])
            else:
                self._mirror[slot] = _packed_predicate(
                    self._hx[slot], self._hz[slot], self._hr[slot],
                    self._hact[slot])
            self._mirror_stale.discard(slot)
        return self._mirror[slot]

    def get_prev(self, slot: int) -> np.ndarray:
        """The slot's previous-tick words [C, W] uint32 (one slot's
        fetch, after the staged work and every tick in flight; the
        mirror's while the device is down)."""
        self.flush()
        self.drain()
        if self.prev is None:
            self._ensure_mirror()
            return self._mirror[slot].copy()
        d, i = self._loc(slot)
        return P.words_to_numpy(self.prev[d][i])

    def set_prev(self, slot: int, words: np.ndarray) -> None:
        """Seed the slot's words [C, W] uint32; the slot must be staged
        before the next flush."""
        self.flush()
        self.drain()
        self._pending_reset.discard(slot)
        words = np.ascontiguousarray(words, np.uint32)
        if self.prev is not None:
            d, i = self._loc(slot)
            self.prev[d][i] = P.words_to_torch(words, self.prev[d].device)
        else:
            self._ensure_mirror()
        self._seeded_unstaged.add(slot)
        self._mirror_stale.discard(slot)
        if self._mirror is not None:
            self._mirror[slot] = words

    # -- the tick ----------------------------------------------------------

    def _apply_maintenance(self) -> None:
        """Land queued slot resets and entity clears on each slot's shard,
        in place."""
        c = self.capacity
        if self._pending_reset or self._pending_clear:
            self._detach_parked_new()
            DC.record()
        if self._pending_reset:
            for s in sorted(self._pending_reset):
                d, i = self._loc(s)
                self.prev[d][i] = 0
            self._pending_reset.clear()
        if not self._pending_clear:
            return
        col_mask: dict[tuple[int, int], int] = {}
        for slot, e in self._pending_clear:
            d, i = self._loc(slot)
            self.prev[d][i, e, :] = 0
            w, b = P.word_bit_for_column(e, c)
            col_mask[(slot, w)] = col_mask.get((slot, w), 0xFFFFFFFF) & (
                ~(1 << b) & 0xFFFFFFFF)
        self._pending_clear.clear()
        for (slot, w), m in sorted(col_mask.items()):
            d, i = self._loc(slot)
            self.prev[d][i, :, w] &= int(np.uint32(m).view(np.int32))

    def _restage_shadows(self) -> list[int]:
        """Copy staged tick inputs into the persistent host shadows."""
        slots = sorted(self._staged)
        for slot in slots:
            sx, sz, sr, sa = self._staged[slot]
            n = len(sx)
            self._hx[slot, :n] = sx
            self._hx[slot, n:] = 0.0
            self._hz[slot, :n] = sz
            self._hz[slot, n:] = 0.0
            self._hr[slot, :n] = sr
            self._hr[slot, n:] = 0.0
            self._hact[slot, :n] = sa
            self._hact[slot, n:] = False
            self._seeded_unstaged.discard(slot)
        self._staged.clear()
        return slots

    def _stage_xz(self, sl, old_x, old_z, old_r, old_act) -> None:
        """Bring each shard's device x/z up to date with the shadows: a
        sparse packet of its own changed rows on the steady path (the
        ``aoi.delta`` seam), a full upload (one ``aoi.h2d`` crossing)
        after growth, a reset, a clear, an r/act/sub change or a
        recovery, when the changed fraction exceeds _delta_max_frac, or
        without delta staging.  The diff compares float BIT PATTERNS, so
        the device copy stays byte-identical."""
        new_x, new_z = self._hx[sl], self._hz[sl]
        diff = (new_x.view(np.uint32) != old_x.view(np.uint32)) \
            | (new_z.view(np.uint32) != old_z.view(np.uint32))
        n_changed = np.count_nonzero(diff)
        if not (np.array_equal(self._hr[sl], old_r)
                and np.array_equal(self._hact[sl], old_act)):
            self._xz_stale = True
        if (self.delta_staging and not self._xz_stale and self._dx is not None
                and n_changed <= self._delta_max_frac * max(diff.size, 1)):
            if n_changed:
                faults.check("aoi.delta")
                rows, cols = np.nonzero(diff)
                grows = sl[rows]
                b = self.s_max // self.n_dev
                shard = grows // b
                for d in np.unique(shard).tolist():
                    m = shard == d
                    pkt = AS.pad_packet(grows[m] - d * b, cols[m],
                                        new_x[rows[m], cols[m]],
                                        new_z[rows[m], cols[m]])
                    DC.record()
                    AS.apply_packet(self._dx[d], self._dz[d], *pkt)
                    self.stats["h2d_bytes"] += AS.packet_nbytes(*pkt)
            self.stats["delta_flushes"] += 1
            return
        faults.check("aoi.h2d")
        self._dx = self.mesh.device_put(self._hx)
        self._dz = self.mesh.device_put(self._hz)
        self.stats["h2d_bytes"] += self._hx.nbytes + self._hz.nbytes
        self._xz_stale = False
        self.stats["full_flushes"] += 1

    def _h2d(self, role: str, arr: np.ndarray) -> list[torch.Tensor]:
        """The role's per-shard device copy, re-uploaded (an ``aoi.h2d``
        crossing) only when its values changed."""
        cached = self._h2d_cache.get(role)
        if cached is not None and np.array_equal(cached[0], arr):
            return cached[1]
        faults.check("aoi.h2d")
        dev = self.mesh.device_put(arr)
        self._h2d_cache[role] = (arr.copy(), dev)
        self.stats["h2d_bytes"] += arr.nbytes
        return dev

    def _dispatch_tick(self) -> dict | None:
        """Maintenance, staging and every shard's step, mask, extraction,
        encode and scalar copy of one tick, enqueued without waiting; its
        record, or None when nothing was staged."""
        if not (self._staged or self._pending_reset or self._pending_clear):
            return None
        self._fault_phase = "stage"
        faults.check("aoi.device")  # the mesh's health probe
        self._rebuild_device()
        self._apply_maintenance()
        if not self._staged:
            return None
        t0 = time.perf_counter()
        slots = sorted(self._staged)
        sl = np.array(slots, np.intp)
        old = (self._hx[sl], self._hz[sl], self._hr[sl], self._hact[sl])
        self._restage_shadows()
        self._cur_slots = slots  # a recovery needs them once _staged is gone
        self._check_restaged()
        if self._mirror is not None and self._unsub:
            self._mirror_stale.update(s for s in slots if s in self._unsub)
        self._stage_xz(sl, *old)
        self._fault_phase = "kernel"
        faults.check("aoi.kernel")
        r = self._h2d("r", self._hr)
        act = self._h2d("act", self._hact)
        sub = self._h2d("sub", self._hsub)
        # every staged slot unsubscribed (unstaged ones re-step identical
        # inputs): the stream is empty by construction, nothing to extract
        all_unsub = bool(self._unsub) and all(s in self._unsub for s in slots)
        masked = not self._hsub.all()
        caps = self._caps_now()
        pred = self._pred if self._defer else None
        shards = []
        for d in range(self.n_dev):
            DC.record()
            new, chg = _calc_step(self._calc_level, self._dx[d], self._dz[d],
                                  r[d], act[d], self.prev[d],
                                  out=self._step_out(d, self.prev[d]))
            self.prev[d] = new
            if all_unsub:
                shards.append(None)
                continue
            # slots with no event consumers contribute nothing to the
            # stream (``new`` stays unmasked: prev stays authoritative)
            if masked:
                chg.masked_fill_(~sub[d][:, None, None], 0)
            shards.append(self._encode_shard(new, chg, caps, pred))
        self.perf["stage_s"] += time.perf_counter() - t0
        return {
            "slots": slots, "caps": caps, "shards": shards,
            "b": self.s_max // self.n_dev,
            "epochs": np.fromiter((self._slot_epoch.get(s, 0)
                                   for s in range(self.s_max)), np.int64,
                                  self.s_max)}

    def _harvest(self, rec: dict) -> None:
        """Wait for each shard's scalars, fetch and decode its stream,
        update the mirror and publish per-slot events (a host record:
        publish what the host computed at its tick)."""
        if rec.get("host"):
            self._publish(rec["slots"], rec["epochs"], *rec["payload"])
            self._apply_mirror_ops()
            return
        c, W = self.capacity, self.W
        got = self._decode_shards(rec, rec["b"] * c * W)
        t0 = time.perf_counter()
        cur = np.fromiter((self._slot_epoch.get(s, 0)
                           for s in range(self.s_max)), np.int64, self.s_max)
        live = cur == rec["epochs"]
        if self._mirror is not None and got is not None:
            cv, gx = got[0], got[2]
            # epoch guard: a slot released since dispatch had its mirror
            # reset at re-acquire; its dead stream must not XOR back in.  A
            # stale row refreshes from the device on the next peek instead.
            keep = live[gx // (c * W)]
            if self._mirror_stale:
                stale = np.zeros(self.s_max, bool)
                stale[list(self._mirror_stale)] = True
                keep &= ~stale[gx // (c * W)]
            self._mirror.reshape(-1)[gx[keep]] ^= cv[keep]
        # clears issued after this tick's dispatch land after its stream
        self._apply_mirror_ops()
        self.perf["decode_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        empty = np.empty((0, 2), np.int32)
        if got is not None:
            pe, pl = _emit_expand(self, *got)
            ent_rows, lv_rows = _split_rows(pe), _split_rows(pl)
        else:
            ent_rows = lv_rows = {}
        for slot in rec["slots"]:
            if not live[slot]:
                continue  # released since dispatch: events of a dead space
            e = ent_rows.get(slot, empty)
            lv = lv_rows.get(slot, empty)
            pend = self._events.get(slot)
            if pend is not None:
                # a mid-dispatch harvest with undelivered prior events:
                # append, oldest first
                e = np.concatenate([pend[0], e])
                lv = np.concatenate([pend[1], lv])
            self._events[slot] = (e, lv)
        self.perf["emit_s"] += time.perf_counter() - t0
