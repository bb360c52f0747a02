"""Durable world state: snapshot-consistent incremental checkpoints.

Port of the JAX package's ``engine/checkpoint.py``; the journal it writes
(msgpack blobs, their CRCs, the manifest's keys and values) is the
reference's byte for byte, so either package restores the other's.

* **Base image** = the migration wire image: ``bucket.export_snapshot``
  (the delta-staging packet of the inputs and the previous-tick words; a
  deferred bucket delivers its tick in flight first).
* **Deltas**: the positions whose bit patterns changed as a
  ``pad_packet`` packet, the changed radii and activity as index lists,
  and the words as dirty pages of :data:`PAGE_ROWS` rows.
* **Off the tick's path**: ``step()`` captures (numpy diffs against the
  last checkpointed state, between ticks) and enqueues; a writer thread
  serializes, CRC-stamps, retries and lands the records in a
  ``storage/`` backend.  A full queue drops the capture (counted) and
  forces the next one to a base, so the chain heals; the tick never
  blocks.
* **Manifest**: one ``(space, epoch, tick)`` entry a durable epoch in a
  ``kvdb/`` backend, written only after its record.  A torn record (a
  kill -9 mid-write, a ``store.write`` ``partial``, a poisoned blob) fails
  its CRC at restore, and the chain falls back to the last consistent
  epoch.
* **Restore** walks the manifest newest first for the longest chain of
  valid records, folds it into a wire image and imports it into a fresh
  slot (``restore_into``), as an evacuation does.
  ``python -m goworld_tpu_torch.engine.checkpoint`` is the crash-restart
  driver (run, SIGKILL mid-run, restore, replay; per-tick event CRCs
  journaled line-buffered, so :func:`crash_restart_scenario` can prove
  ``events_lost == 0``).

Fault seams (``store.write`` / ``store.read`` / ``store.manifest``, the
port's :mod:`..faults`): fail, oom and reset retry with a capped backoff;
stall sleeps on the writer; partial and poison land a torn or corrupt
record, caught at restore.  An exhausted retry budget abandons that epoch
(counted), never the controller.

Telemetry (:mod:`..telemetry`): spans ``ckpt.snapshot`` / ``ckpt.delta``
/ ``ckpt.flush`` / ``ckpt.restore``; counters ``ckpt.bytes`` /
``ckpt.records`` / ``ckpt.epochs`` / ``ckpt.retries`` / ``ckpt.torn``;
gauges ``ckpt.backlog`` / ``ckpt.lag_ticks``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import zlib

import numpy as np

from .. import faults, telemetry
from ..telemetry import trace as _T
from .aoi import _build_snapshot, _unpack_positions

# rows per dirty page of the packed interest-words matrix.  Matches the
# paged-storage grain (ops/aoi_pages.PAGE_WORDS): a page is the unit the
# device path already thinks in, so dirty tracking composes with it.
PAGE_ROWS = 64

# storage namespace for journal records; eid = "<space>.<epoch:08d>"
RECORD_TYPE = "__ckpt__"
# kvdb manifest key = "ckpt/<space>/<epoch:08d>" -> json {epoch,tick,kind,crc}
MANIFEST_PREFIX = "ckpt/"
# any printable byte above the digits: the half-open find() upper bound
_MANIFEST_END = "~"

_BYTES = telemetry.counter(
    "ckpt.bytes", "journal bytes handed to the storage backend")
_RECORDS = telemetry.counter(
    "ckpt.records", "checkpoint journal records durably written")
_EPOCHS = telemetry.counter(
    "ckpt.epochs", "checkpoint epochs whose manifest entry landed")
_RETRIES = telemetry.counter(
    "ckpt.retries", "store.* operations retried after an injected or real "
    "backend fault")
_TORN = telemetry.counter(
    "ckpt.torn", "torn/corrupt journal records detected (CRC or decode "
    "mismatch at restore)")
_BACKLOG = telemetry.gauge(
    "ckpt.backlog", "captures queued to the background checkpoint writer")
_LAG = telemetry.gauge(
    "ckpt.lag_ticks", "worst tracked space's enqueued-tick minus durable-"
    "tick gap (ticks of checkpoint work still in flight)")


def _crc(blob: bytes) -> int:
    return zlib.crc32(blob) & 0xFFFFFFFF


def _record_eid(space_id: str, epoch: int) -> str:
    return f"{space_id}.{epoch:08d}"


def _manifest_key(space_id: str, epoch: int) -> str:
    return f"{MANIFEST_PREFIX}{space_id}/{epoch:08d}"


def _pos_packet(cols: np.ndarray, x: np.ndarray, z: np.ndarray):
    """Serialize changed position columns through the delta-staging wire
    format (ops/aoi_stage.pad_packet, page-granular padding -- <= 1 page
    of duplicated-tail waste; the replay scatter is an assignment, which
    absorbs the duplicates idempotently)."""
    from ..ops import aoi_stage as AS

    if not len(cols):
        return None
    rows, pc, px, pz = (np.asarray(a) for a in AS.pad_packet(
        np.zeros(len(cols), np.int64), cols.astype(np.int64),
        x.astype(np.float32), z.astype(np.float32), page_granular=True))
    return {"n": int(len(pc)), "rows": rows.astype(np.int64).tobytes(),
            "cols": pc.astype(np.int64).tobytes(),
            "xv": px.astype(np.float32).tobytes(),
            "zv": pz.astype(np.float32).tobytes()}


def _apply_pos_packet(pkt, x: np.ndarray, z: np.ndarray) -> None:
    if pkt is None:
        return
    cols = np.frombuffer(pkt["cols"], np.int64)
    x[cols] = np.frombuffer(pkt["xv"], np.float32)
    z[cols] = np.frombuffer(pkt["zv"], np.float32)


class _SpaceShadow:
    """Per-tracked-space last-checkpointed state: the diff baseline the
    next delta is computed against, plus the epoch chain bookkeeping."""

    __slots__ = ("handle", "capacity", "x", "z", "r", "act", "sub", "words",
                 "epoch", "deltas_since_base", "force_base",
                 "enqueued_tick", "acked_tick", "acked_epoch")

    def __init__(self, handle):
        self.handle = handle
        self.capacity = handle.capacity
        self.x = self.z = self.r = self.act = self.words = None
        self.sub = True
        self.epoch = 0
        self.deltas_since_base = 0
        self.force_base = True
        self.enqueued_tick = 0
        self.acked_tick = 0
        self.acked_epoch = -1


class CheckpointController:
    """Streams per-space incremental checkpoints off the hot path.

    ``mode``: ``"off"`` (step() is a no-op), ``"interval"`` (capture every
    ``interval`` ticks), ``"continuous"`` (every tick).  ``full_every``
    bounds the delta chain: after that many deltas the next capture is a
    fresh base, so restore replay work -- and the blast radius of one torn
    record -- stays bounded.
    """

    def __init__(self, engine, store, manifest, mode: str = "interval",
                 interval: int = 16, full_every: int = 64,
                 queue_max: int = 256, max_retries: int = 5,
                 retry_base_s: float = 0.001):
        if mode not in ("off", "interval", "continuous"):
            raise ValueError(f"unknown checkpoint mode {mode!r}")
        if interval < 1:
            raise ValueError("checkpoint interval must be >= 1")
        self.engine = engine
        self.store = store
        self.manifest = manifest
        self.mode = mode
        self.interval = interval
        self.full_every = full_every
        self.max_retries = max_retries
        self.retry_base_s = retry_base_s
        self._shadows: dict[str, _SpaceShadow] = {}
        self._q: "queue.Queue[tuple]" = queue.Queue(maxsize=queue_max)
        self._lock = threading.Lock()
        self.stats = {"captures": 0, "bases": 0, "deltas": 0,
                      "skipped_empty": 0, "backlog_drops": 0,
                      "write_retries": 0, "manifest_retries": 0,
                      "read_retries": 0, "dropped_epochs": 0,
                      "torn_records": 0, "bytes_written": 0,
                      "records_written": 0, "restores": 0}
        self._stop = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._writer = None
        if mode != "off":
            self._writer = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._writer.start()

    # -- tracking ---------------------------------------------------------

    def track(self, space_id: str, handle) -> None:
        """Start (or re-point) checkpointing for one space.  Idempotent;
        a changed handle object or capacity (space growth re-homes the
        slot) forces the next capture to a fresh base."""
        sh = self._shadows.get(space_id)
        if sh is not None and sh.handle is handle \
                and sh.capacity == handle.capacity:
            return
        if sh is not None and sh.handle is not handle:
            nsh = _SpaceShadow(handle)
            nsh.epoch = sh.epoch  # keep the manifest chain monotonic
            nsh.enqueued_tick = sh.enqueued_tick
            nsh.acked_tick, nsh.acked_epoch = sh.acked_tick, sh.acked_epoch
            self._shadows[space_id] = nsh
            return
        nsh = _SpaceShadow(handle)
        nsh.epoch = self._next_epoch(space_id)
        self._shadows[space_id] = nsh

    def _next_epoch(self, space_id: str) -> int:
        """The epoch after the newest the manifest holds for the space: a
        game restarted over its own store (``-restore``) continues the
        chain, so a restore never folds the earlier process's records into
        the new one's (a fresh store starts at 0)."""
        lo = _manifest_key(space_id, 0)[:-8]
        try:
            rows = self.manifest.find(lo, lo + _MANIFEST_END)
        except OSError:
            return 0
        epochs = [int(k[len(lo):]) for k, _v in rows if k[len(lo):].isdigit()]
        return max(epochs) + 1 if epochs else 0

    def untrack(self, space_id: str) -> None:
        self._shadows.pop(space_id, None)

    def sync_tracked(self, live: dict) -> None:
        """Reconcile the tracked set against ``{space_id: handle}`` --
        the Runtime's per-tick glue (spaces come and go; growth swaps
        handles)."""
        for sid, h in live.items():
            self.track(sid, h)
        for sid in [s for s in self._shadows if s not in live]:
            self.untrack(sid)

    # -- capture (the tick-side half) -------------------------------------

    def step(self, tick: int) -> None:
        """Capture every due space.  Runs between ticks (after event
        delivery), so the export is snapshot-consistent by construction;
        the expensive half (serialize + write) happens on the writer."""
        if self.mode == "off":
            return
        if self.mode == "interval" and tick % self.interval != 0:
            return
        for sid in sorted(self._shadows):
            self.capture(sid, tick)
        self._update_lag()

    def capture(self, space_id: str, tick: int) -> bool:
        """Capture one space now (used directly by benches/tests; step()
        calls it on cadence).  Returns True when a record was enqueued."""
        sh = self._shadows[space_id]
        h = sh.handle
        if h.released:
            return False
        self.stats["captures"] += 1
        with _T.span("ckpt.snapshot"):
            snap = h.bucket.export_snapshot(h.slot)
            x, z = _unpack_positions(snap)
        if sh.force_base or sh.x is None or sh.capacity != snap["capacity"] \
                or sh.deltas_since_base >= self.full_every \
                or sh.words.shape != snap["words"].shape:
            kind, payload = "base", self._base_payload(snap)
            self.stats["bases"] += 1
        else:
            with _T.span("ckpt.delta"):
                payload = self._delta_payload(sh, snap, x, z)
            if payload is None:
                self.stats["skipped_empty"] += 1
                return False
            kind = "delta"
            self.stats["deltas"] += 1
        payload.update({"kind": kind, "space": space_id,
                        "epoch": sh.epoch, "tick": tick,
                        "capacity": int(snap["capacity"]),
                        "sub": bool(snap["sub"])})
        stack = getattr(h, "_policy_stack", None)
        if stack is not None:
            # interest-policy state rides EVERY record (base and delta) as
            # a self-contained blob in the pad_packet snapshot format:
            # last-wins at fold time, so the chain walk needs no
            # stack-specific delta logic
            payload["interest"] = stack.export_payload()
        try:
            self._q.put_nowait((space_id, sh.epoch, tick, kind, payload))
        except queue.Full:
            # never block the tick: drop the capture, force the next one
            # to a base so the delta chain stays consistent
            self.stats["backlog_drops"] += 1
            sh.force_base = True
            return False
        self._idle.clear()
        _BACKLOG.set(self._q.qsize())
        # the shadow becomes the new diff baseline ONLY for enqueued work
        sh.x, sh.z = x, z
        sh.r = snap["r"]
        sh.act = snap["act"]
        sh.sub = bool(snap["sub"])
        sh.words = snap["words"]
        sh.capacity = int(snap["capacity"])
        sh.epoch += 1
        sh.enqueued_tick = tick
        sh.deltas_since_base = 0 if kind == "base" else \
            sh.deltas_since_base + 1
        sh.force_base = False
        return True

    @staticmethod
    def _base_payload(snap: dict) -> dict:
        pkt = snap["packet"]
        payload = {"packet": None, "r": snap["r"].tobytes(),
                   "act": np.asarray(snap["act"], bool).tobytes(),
                   "words": snap["words"].tobytes(),
                   "words_cols": int(snap["words"].shape[1])}
        if pkt is not None:
            rows, cols, xv, zv = (np.asarray(a) for a in pkt)
            payload["packet"] = {
                "n": int(len(cols)),
                "rows": rows.astype(np.int64).tobytes(),
                "cols": cols.astype(np.int64).tobytes(),
                "xv": xv.astype(np.float32).tobytes(),
                "zv": zv.astype(np.float32).tobytes()}
        return payload

    def _delta_payload(self, sh: _SpaceShadow, snap: dict,
                       x: np.ndarray, z: np.ndarray) -> dict | None:
        """Dirty-column / dirty-page diff against the shadow.  Bit-pattern
        compares (uint32 views), the delta-staging convention: -0.0 vs 0.0
        is a change, NaNs compare stably."""
        pos_chg = np.nonzero(
            (x.view(np.uint32) != sh.x.view(np.uint32))
            | (z.view(np.uint32) != sh.z.view(np.uint32)))[0]
        r = snap["r"]
        act = np.asarray(snap["act"], bool)
        r_chg = np.nonzero(r.view(np.uint32) != sh.r.view(np.uint32))[0]
        a_chg = np.nonzero(act != sh.act)[0]
        words = snap["words"]
        row_dirty = np.any(words != sh.words, axis=1)
        pages = {}
        if row_dirty.any():
            dirty_pages = np.nonzero(
                np.add.reduceat(
                    row_dirty,
                    np.arange(0, len(row_dirty), PAGE_ROWS)) > 0)[0]
            for p in dirty_pages.tolist():
                pages[str(p)] = words[p * PAGE_ROWS:(p + 1) * PAGE_ROWS] \
                    .tobytes()
        sub_chg = bool(snap["sub"]) != sh.sub
        if not len(pos_chg) and not len(r_chg) and not len(a_chg) \
                and not pages and not sub_chg:
            return None
        payload = {"pos": _pos_packet(pos_chg, x[pos_chg], z[pos_chg]),
                   "pages": pages, "words_cols": int(words.shape[1])}
        if len(r_chg):
            payload["r_idx"] = r_chg.astype(np.int64).tobytes()
            payload["r_val"] = r[r_chg].tobytes()
        if len(a_chg):
            payload["act_idx"] = a_chg.astype(np.int64).tobytes()
            payload["act_val"] = act[a_chg].tobytes()
        return payload

    def _update_lag(self) -> None:
        lag = 0
        for sh in self._shadows.values():
            lag = max(lag, sh.enqueued_tick - sh.acked_tick)
        _LAG.set(lag)

    # -- the background writer --------------------------------------------

    def _writer_loop(self) -> None:
        import msgpack

        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                self._idle.set()
                continue
            _BACKLOG.set(self._q.qsize())
            sid, epoch, tick, kind, payload = item
            with _T.span("ckpt.flush"):
                blob = msgpack.packb(payload, use_bin_type=True)
                record = {"crc": _crc(blob), "epoch": epoch, "tick": tick,
                          "kind": kind, "blob": blob}
                ok = self._guarded_write(_record_eid(sid, epoch), record)
                if ok:
                    ok = self._guarded_manifest_put(sid, epoch, tick, kind,
                                                    record["crc"], len(blob))
            if ok:
                self.stats["records_written"] += 1
                self.stats["bytes_written"] += len(blob)
                _RECORDS.inc()
                _BYTES.inc(len(blob))
                _EPOCHS.inc()
                sh = self._shadows.get(sid)
                if sh is not None and epoch > sh.acked_epoch:
                    sh.acked_epoch, sh.acked_tick = epoch, tick
            else:
                # epoch abandoned: the chain above it is unusable, so the
                # next capture must restart from a base (self-healing)
                self.stats["dropped_epochs"] += 1
                sh = self._shadows.get(sid)
                if sh is not None:
                    sh.force_base = True
            if self._q.empty():
                self._idle.set()

    def _retry_sleep(self, attempt: int) -> None:
        time.sleep(min(self.retry_base_s * (2 ** attempt), 0.05))

    def _guarded_write(self, eid: str, record: dict) -> bool:
        """One journal record through the ``store.write`` seam: fail/oom/
        reset retry with capped backoff; partial/poison land a torn or
        corrupt record (the CRC catches it at restore -- exactly what a
        mid-write SIGKILL leaves behind)."""
        for attempt in range(self.max_retries):
            try:
                spec = faults.check("store.write")
                rec = record
                if spec is not None and spec.kind == "partial":
                    frac = spec.arg if spec.arg is not None else 0.5
                    cut = max(0, int(len(record["blob"]) * frac))
                    rec = dict(record, blob=record["blob"][:cut])
                elif spec is not None and spec.kind == "poison":
                    b = bytearray(record["blob"])
                    b[len(b) // 2] ^= 0xFF
                    rec = dict(record, blob=bytes(b))
                self.store.write(RECORD_TYPE, eid, rec)
                return True
            except (faults.InjectedFault, ConnectionResetError, OSError):
                self.stats["write_retries"] += 1
                _RETRIES.inc()
                self._retry_sleep(attempt)
        return False

    def _guarded_manifest_put(self, sid: str, epoch: int, tick: int,
                              kind: str, crc: int, nbytes: int) -> bool:
        val = json.dumps({"epoch": epoch, "tick": tick, "kind": kind,
                          "crc": crc, "nbytes": nbytes})
        for attempt in range(self.max_retries):
            try:
                spec = faults.check("store.manifest")
                v = val
                if spec is not None and spec.kind == "partial":
                    frac = spec.arg if spec.arg is not None else 0.5
                    v = val[:max(0, int(len(val) * frac))]
                elif spec is not None and spec.kind == "poison":
                    v = "\x00" + val[1:]
                self.manifest.put(_manifest_key(sid, epoch), v)
                return True
            except (faults.InjectedFault, ConnectionResetError, OSError):
                self.stats["manifest_retries"] += 1
                _RETRIES.inc()
                self._retry_sleep(attempt)
        return False

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until the writer has landed everything enqueued so far
        (tests/benches assert durable state; close() calls this)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._q.empty() and self._idle.is_set():
                return True
            time.sleep(0.002)
        return False

    def close(self, drain: bool = True) -> None:
        if self._writer is not None:
            if drain:
                self.drain()
            self._stop.set()
            self._writer.join(timeout=5.0)
            self._writer = None

    # -- restore (the crash-restart half) ---------------------------------

    def _guarded_read(self, eid: str) -> dict | None:
        for attempt in range(self.max_retries):
            try:
                spec = faults.check("store.read")
                rec = self.store.read(RECORD_TYPE, eid)
                if rec is not None and spec is not None:
                    if spec.kind == "partial":
                        frac = spec.arg if spec.arg is not None else 0.5
                        cut = max(0, int(len(rec["blob"]) * frac))
                        rec = dict(rec, blob=rec["blob"][:cut])
                    elif spec.kind == "poison":
                        b = bytearray(rec["blob"])
                        if b:
                            b[len(b) // 2] ^= 0xFF
                        rec = dict(rec, blob=bytes(b))
                return rec
            except (faults.InjectedFault, ConnectionResetError, OSError):
                self.stats["read_retries"] += 1
                _RETRIES.inc()
                self._retry_sleep(attempt)
        return None

    def _manifest_entries(self, space_id: str) -> list[dict]:
        lo = _manifest_key(space_id, 0)[:-8]
        hi = lo + _MANIFEST_END
        for attempt in range(self.max_retries):
            try:
                faults.check("store.manifest")
                rows = self.manifest.find(lo, hi)
                break
            except (faults.InjectedFault, ConnectionResetError, OSError):
                self.stats["manifest_retries"] += 1
                _RETRIES.inc()
                self._retry_sleep(attempt)
        else:
            return []
        out = []
        for _k, v in rows:
            try:
                e = json.loads(v)
                out.append({"epoch": int(e["epoch"]), "tick": int(e["tick"]),
                            "kind": e["kind"], "crc": int(e["crc"])})
            except (ValueError, KeyError, TypeError):
                # torn/poisoned manifest line: skip it; the chain walk
                # below treats the epoch as absent and falls back
                self.stats["torn_records"] += 1
                _TORN.inc()
        out.sort(key=lambda e: e["epoch"])
        return out

    def _load_record(self, space_id: str, ent: dict, cache: dict):
        """One CRC-verified journal payload, memoized; None when the
        record is missing, torn, or disagrees with its manifest entry."""
        import msgpack

        epoch = ent["epoch"]
        if epoch in cache:
            return cache[epoch]
        rec = self._guarded_read(_record_eid(space_id, epoch))
        payload = None
        if rec is not None:
            blob = rec.get("blob", b"")
            if _crc(blob) == rec.get("crc") == ent["crc"] \
                    and rec.get("epoch") == epoch:
                try:
                    payload = msgpack.unpackb(blob, raw=False)
                except Exception:
                    payload = None
        if payload is None:
            self.stats["torn_records"] += 1
            _TORN.inc()
        cache[epoch] = payload
        return payload

    def restore(self, space_id: str):
        """Newest fully-consistent state for ``space_id``: walk the
        manifest newest-first, validate the base+delta chain record by
        record (per-record CRC), and fold it into a migration snapshot.
        A torn tail -- the record the SIGKILL interrupted, an injected
        ``partial``/``poison`` write -- just shortens the chain: the
        result is the last consistent epoch.  Returns ``(snap, tick,
        epoch)`` or None when no consistent chain exists."""
        with _T.span("ckpt.restore"):
            entries = self._manifest_entries(space_id)
            if not entries:
                return None
            by_epoch = {e["epoch"]: e for e in entries}
            cache: dict[int, dict | None] = {}
            for ent in reversed(entries):
                chain = self._chain_for(ent, by_epoch, cache, space_id)
                if chain is None:
                    continue
                snap, tick = self._fold_chain(chain)
                self.stats["restores"] += 1
                return snap, tick, ent["epoch"]
        return None

    def _chain_for(self, ent: dict, by_epoch: dict, cache: dict,
                   space_id: str):
        """The validated base..ent payload chain, or None if any link is
        missing/torn."""
        chain = []
        e = ent["epoch"]
        while True:
            cur = by_epoch.get(e)
            if cur is None:
                return None
            payload = self._load_record(space_id, cur, cache)
            if payload is None:
                return None
            chain.append((cur, payload))
            if payload["kind"] == "base":
                break
            e -= 1
        chain.reverse()
        return chain

    @staticmethod
    def _fold_chain(chain):
        """base payload + ordered deltas -> (_build_snapshot dict, tick)."""
        ent, base = chain[0]
        cap = int(base["capacity"])
        wcols = int(base["words_cols"])
        x = np.zeros(cap, np.float32)
        z = np.zeros(cap, np.float32)
        _apply_pos_packet(base["packet"], x, z)
        r = np.frombuffer(base["r"], np.float32).copy()
        act = np.frombuffer(base["act"], bool).copy()
        words = np.frombuffer(base["words"], np.uint32) \
            .reshape(cap, wcols).copy()
        sub = bool(base["sub"])
        tick = int(base["tick"])
        interest = base.get("interest")
        for ent, d in chain[1:]:
            _apply_pos_packet(d.get("pos"), x, z)
            if "r_idx" in d:
                r[np.frombuffer(d["r_idx"], np.int64)] = \
                    np.frombuffer(d["r_val"], np.float32)
            if "act_idx" in d:
                act[np.frombuffer(d["act_idx"], np.int64)] = \
                    np.frombuffer(d["act_val"], bool)
            for pk, pb in d.get("pages", {}).items():
                p = int(pk)
                words[p * PAGE_ROWS:(p + 1) * PAGE_ROWS] = \
                    np.frombuffer(pb, np.uint32).reshape(-1, wcols)
            sub = bool(d["sub"])
            tick = int(d["tick"])
            if "interest" in d:
                interest = d["interest"]
        snap = _build_snapshot(cap, x, z, r, act, sub, words)
        if interest is not None:
            snap["interest"] = interest
        return snap, tick

    def restore_into(self, engine, space_id: str, tier: str | None = None,
                     backend: str | None = None):
        """Crash-restart entry point: restore the newest consistent state
        onto a fresh slot of ``engine`` through the evacuation/migration
        ``import_snapshot`` path, and resume tracking (next capture is a
        fresh base at the next epoch -- any torn records above the
        restored epoch are simply overwritten).  Returns ``(handle, tick,
        epoch)`` or None."""
        res = self.restore(space_id)
        if res is None:
            return None
        snap, tick, epoch = res
        if tier is not None:
            h = engine._create_handle(snap["capacity"], tier)
        else:
            h = engine.create_space(snap["capacity"], backend)
        h.bucket.import_snapshot(h.slot, snap)
        if "interest" in snap:
            # stash for attach_interest: the restoring space re-declares
            # its policies (code), the payload restores their state
            h._interest_snapshot = snap["interest"]
        sh = _SpaceShadow(h)
        sh.epoch = epoch + 1
        sh.enqueued_tick = sh.acked_tick = tick
        sh.acked_epoch = epoch
        self._shadows[space_id] = sh
        return h, tick, epoch


# -- the crash-restart driver ------------------------------------------------
#
# ``python -m goworld_tpu_torch.engine.checkpoint --dir D ...`` runs one
# seeded AOI walk with checkpoints armed, journaling one line a tick
# ("<tick> <crc32:08x> <n_events> <seconds>", line-buffered: the
# delivered stream a SIGKILL cannot take back), and at --kill-at K
# SIGKILLs itself right after journaling tick K: deterministic, and still
# a real kill -9 (no atexit, no writer drain, torn tails included).  With
# --resume it restores from the checkpoint directory and replays ticks
# R+1..N.  crash_restart_scenario() is the parent: the oracle run, the
# killed run, the resumed run, then the merge (the ticks both delivered
# must agree bit for bit, and their union must equal the oracle:
# events_lost == 0).


def _walk_frames(cap: int, world: float, ticks: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, world, cap).astype(np.float32)
    z = rng.uniform(0.0, world, cap).astype(np.float32)
    frames = []
    for _ in range(ticks):
        x = x + rng.uniform(-3.0, 3.0, cap).astype(np.float32)
        z = z + rng.uniform(-3.0, 3.0, cap).astype(np.float32)
        frames.append((x.copy(), z.copy()))
    return frames


def _open_backends(base_dir: str):
    """The filesystem journal and manifest under ``base_dir``."""
    from ..kvdb.backends import FilesystemKVDB
    from ..storage.backends import FilesystemEntityStorage

    return (FilesystemEntityStorage(os.path.join(base_dir, "store")),
            FilesystemKVDB(os.path.join(base_dir, "kvdb")))


def _tick_crc(e, lv) -> tuple[int, int]:
    e = np.ascontiguousarray(e, np.int32)
    lv = np.ascontiguousarray(lv, np.int32)
    return (zlib.crc32(lv.tobytes(), zlib.crc32(e.tobytes(), 0)),
            len(e) + len(lv))


def _driver(argv=None) -> int:
    import argparse
    import signal
    import sys

    from .aoi import AOIEngine

    ap = argparse.ArgumentParser(
        description="deterministic checkpoint crash-restart driver")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--journal", required=True)
    ap.add_argument("--ticks", type=int, default=32)
    ap.add_argument("--cap", type=int, default=256)
    ap.add_argument("--world", type=float, default=400.0)
    ap.add_argument("--tier", default="cuda", choices=("cpu", "cpp", "cuda"))
    ap.add_argument("--device", default="cuda",
                    help="where the cuda tier's tensors live (cuda | cpu)")
    ap.add_argument("--mode", default="continuous",
                    choices=("interval", "continuous"))
    ap.add_argument("--interval", type=int, default=4)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--kill-at", type=int, default=-1)
    ap.add_argument("--no-checkpoint", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    frames = _walk_frames(args.cap, args.world, args.ticks, args.seed)
    r = np.full(args.cap, 100.0, np.float32)
    act = np.ones(args.cap, bool)
    eng = AOIEngine(device=args.device)
    ctl = None
    if not args.no_checkpoint:
        store, kv = _open_backends(args.dir)
        ctl = CheckpointController(eng, store, kv, mode=args.mode,
                                   interval=args.interval)
    start = 0
    jf = open(args.journal, "a", buffering=1)
    if args.resume:
        res = ctl.restore_into(eng, "bench", tier=args.tier)
        if res is None:
            print("no consistent checkpoint", file=sys.stderr)
            return 2
        h, tick, epoch = res
        start = tick
        jf.write(f"# restored epoch={epoch} tick={tick}\n")
    else:
        h = eng._create_handle(args.cap, args.tier)
        if ctl is not None:
            ctl.track("bench", h)
    for t in range(start + 1, args.ticks + 1):
        x, z = frames[t - 1]
        t0 = time.perf_counter()
        eng.submit(h, x, z, r, act)
        eng.flush()
        e, lv = eng.take_events(h)
        wall = time.perf_counter() - t0
        crc, n = _tick_crc(e, lv)
        jf.write(f"{t} {crc:08x} {n} {wall:.6f}\n")
        if ctl is not None:
            ctl.step(t)
        if t == args.kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
    if ctl is not None:
        ctl.drain()
        ctl.close()
    return 0


def _read_journal(path: str) -> tuple[dict, dict, int]:
    """{tick: crc_hex}, {tick: n_events}, restored_tick (-1 if none)."""
    crcs, counts, restored = {}, {}, -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if "restored" in line:
                    try:
                        restored = int(
                            line.rsplit("tick=", 1)[1].split()[0])
                    except (IndexError, ValueError):
                        pass  # a torn marker: no restore record
                continue
            # a kill -9 mid-append can leave a truncated last line; it
            # holds no complete (tick, crc, count) and is dropped, as a
            # torn checkpoint record is
            parts = line.split()
            try:
                t = int(parts[0])
                crc, n = parts[1], int(parts[2])
            except (IndexError, ValueError):
                continue
            crcs[t] = crc
            counts[t] = n
    return crcs, counts, restored


def crash_restart_scenario(base_dir: str, cap: int = 256,
                           world: float = 400.0, ticks: int = 32,
                           kill_at: int = 20, tier: str = "cuda",
                           mode: str = "continuous", interval: int = 4,
                           seed: int = 17, device: str = "cuda",
                           timeout: float = 600.0) -> dict:
    """The parent: the oracle run, the SIGKILLed run and the resumed run
    (each ``python -m goworld_tpu_torch.engine.checkpoint``, each given
    ``timeout`` seconds), then the merge.  Returns the verdict and the
    recovery numbers."""
    import subprocess
    import sys

    os.makedirs(base_dir, exist_ok=True)
    ck_dir = os.path.join(base_dir, "ckpt")
    oracle_j = os.path.join(base_dir, "oracle.journal")
    crash_j = os.path.join(base_dir, "crash.journal")
    resume_j = os.path.join(base_dir, "resume.journal")
    for p in (oracle_j, crash_j, resume_j):
        if os.path.exists(p):
            os.unlink(p)
    common = [sys.executable, "-m", "goworld_tpu_torch.engine.checkpoint",
              "--dir", ck_dir, "--ticks", str(ticks), "--cap", str(cap),
              "--world", str(world), "--tier", tier, "--device", device,
              "--mode", mode, "--interval", str(interval),
              "--seed", str(seed)]
    # the package's root on the children's path, wherever they start
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)

    def run(*extra):
        return subprocess.run(common + list(extra), env=env,
                              timeout=timeout).returncode

    rc_oracle = run("--journal", oracle_j, "--no-checkpoint")
    rc_crash = run("--journal", crash_j, "--kill-at", str(kill_at))
    t0 = time.perf_counter()
    rc_resume = run("--journal", resume_j, "--resume")
    restart_wall_s = time.perf_counter() - t0
    o_crc, o_n, _ = _read_journal(oracle_j)
    c_crc, c_n, _ = _read_journal(crash_j)
    r_crc, r_n, restored_tick = _read_journal(resume_j)
    # the ticks both sides delivered must agree bit for bit (what the
    # dispatcher's exactly-once replay drops as duplicates); the merge
    # takes each tick once
    overlap = sorted(set(c_crc) & set(r_crc))
    replay_ok = all(c_crc[t] == r_crc[t] for t in overlap)
    merged = dict(c_crc)
    merged.update(r_crc)
    merged_n = dict(c_n)
    merged_n.update(r_n)
    parity_ok = (replay_ok and set(merged) == set(o_crc)
                 and all(merged[t] == o_crc[t] for t in o_crc))
    events_lost = sum(o_n.values()) - sum(
        merged_n.get(t, 0) for t in o_n)
    return {
        "ticks": ticks,
        "kill_tick": kill_at,
        "restored_tick": restored_tick,
        "ticks_to_recover": kill_at - restored_tick,
        "replayed_overlap_ticks": len(overlap),
        "replay_parity_ok": replay_ok,
        "parity_ok": bool(parity_ok),
        "events_lost": int(events_lost),
        "restart_wall_s": restart_wall_s,
        "oracle_events": int(sum(o_n.values())),
        "crash_rc": rc_crash,
        "oracle_rc": rc_oracle,
        "resume_rc": rc_resume,
    }


if __name__ == "__main__":
    raise SystemExit(_driver())
