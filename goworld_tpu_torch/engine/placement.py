"""Placement: live space migration between AOI tiers.

Port of the JAX package's ``engine/placement.py``.  Three parts:

  * :class:`PlacementController` -- scores each bucket from its load
    counters (flush seconds, occupied slots, staged H2D bytes) and, in
    ``auto`` mode, moves at most one space a cooldown window: a hot host
    bucket's space to the device tier, an idle device bucket's space to
    the native host calculator;

  * :class:`_Migration` -- the live migration's state machine::

        snapshot -> replay -> double cover -> swap
                                   |
                                   +-> rollback (nothing lost)

    The source slot's wire image (``export_snapshot``: its input shadows
    as a delta-staging packet and its words) is replayed onto a slot of
    the target tier.  Then both homes compute every tick from the same
    staged inputs while the events still publish from the source; each
    flush the two freshly published deltas are compared (CRC and exact
    arrays, cadence-aligned when one side defers delivery by a tick).
    Once enough aligned flushes agree, the handle the Space holds is
    re-pointed in place, the undelivered events are carried (none lost,
    none repeated, no tick dropped) and the source slot's release
    silences a source tick still in flight.  A mismatch, or any fault
    recovery on the target during the cover, rolls back to the source;

  * :class:`CohortPlanner` -- scores the cohort tier from the same load
    counters and moves spaces between a cohort bucket and solo buckets
    (:meth:`..engine.aoi.AOIEngine.cohort_join` / ``cohort_leave``).

The chip-loss evacuation (``aoi.device`` kind ``reset``) uses the same
snapshots: :meth:`..engine.aoi.AOIEngine._evacuate_bucket`.

During a cover the space's events must be taken every tick (the
runtime's cadence).  A move between a deferred and an undeferred tier
shifts delivery by the one documented tick and loses nothing.
"""

from __future__ import annotations

import logging
import time
import zlib
from dataclasses import dataclass

import numpy as np

from ..telemetry import trace as _T

__all__ = ["PlacementController", "CohortPlanner", "LoadSample",
           "MigrationError"]

_log = logging.getLogger("goworld_tpu_torch.placement")

_EMPTY = np.empty((0, 2), np.int32)


class MigrationError(RuntimeError):
    """A migration could not start (a released or migrating handle)."""


def _lag(bucket) -> int:
    """Event-delivery lag of a bucket in flushes: 1 for a bucket whose
    one-tick deferral is in effect (``_Deferred._defer``: ``pipeline`` or
    ``cross_tick`` on the single-device and mesh buckets), else 0.  The
    row-sharded bucket accepts both flags and delivers every tick in the
    flush that computed it (its ``_inflight`` only bridges the two phases
    of one flush); a host bucket publishes inline."""
    return 1 if getattr(bucket, "_defer", False) else 0


def _crc_pair(d) -> int:
    crc = zlib.crc32(np.ascontiguousarray(d[0], np.int32).tobytes())
    return zlib.crc32(np.ascontiguousarray(d[1], np.int32).tobytes(), crc)


def _target_fault_count(bucket) -> int:
    st = getattr(bucket, "stats", None)
    if st is None:
        return 0
    return (st.get("rebuilds", 0) + st.get("fallbacks", 0)
            + st.get("host_ticks", 0))


class _Migration:
    """One live migration in its double cover.

    Made by :meth:`PlacementController.migrate` after the snapshot and
    the replay and registered on the engine, which calls
    :meth:`on_flush_begin` / :meth:`on_flush_end` around every flush and
    forwards the space's submits to the target while the cover runs."""

    def __init__(self, engine, handle, target):
        self.engine = engine
        self.h = handle          # the source: still owns delivery
        self.t = target          # the replayed shell handle
        self.lag_s = _lag(handle.bucket)
        self.lag_t = _lag(target.bucket)
        # aligned comparisons that must agree before the swap; with both
        # sides deferred the first aligned pair is the empty warm-up
        # flush, so one more covers a real tick
        self.need = 1 + min(self.lag_s, self.lag_t)
        self.verified = 0
        self.src_seq: list = []  # per-flush (enter, leave) deltas
        self.tgt_seq: list = []
        self.crc = 0             # running CRC over the verified deltas
        self.done = False
        self._src_pre = None
        self._t_faults0 = _target_fault_count(target.bucket)
        self.t0 = time.perf_counter()

    # -- engine hooks -----------------------------------------------------

    def on_submit(self, x, z, radius, active) -> None:
        """Stage the source's tick on the target too (the double
        compute: the same inputs in both homes)."""
        self.t.bucket.stage(self.t.slot, (x, z, radius, active))

    def on_flush_begin(self) -> None:
        # a publish replaces the slot's pending tuple (events are taken
        # every tick), so a tuple that is new at the flush's end IS the
        # flush's delta
        self._src_pre = self.h.bucket._events.get(self.h.slot)

    def on_flush_end(self) -> None:
        if self.done:
            return
        cur = self.h.bucket._events.get(self.h.slot)
        ds = cur if (cur is not None and cur is not self._src_pre) \
            else (_EMPTY, _EMPTY)
        # the target's events duplicate the source's while the source
        # delivers: take them into the cover buffer, so they neither leak
        # to the caller nor get replaced unseen
        dt = self.t.bucket._events.pop(self.t.slot, None)
        if dt is None:
            dt = (_EMPTY, _EMPTY)
        self.src_seq.append((np.asarray(ds[0]), np.asarray(ds[1])))
        self.tgt_seq.append((np.asarray(dt[0]), np.asarray(dt[1])))
        if _target_fault_count(self.t.bucket) != self._t_faults0:
            # the target recovered from a fault mid-cover: its deltas still
            # match (the recovery is exact), but a home that faulted in its
            # own audition is not adopted
            self.abort("target bucket faulted during cover")
            return
        k = len(self.src_seq)
        lag = self.lag_t - self.lag_s
        if lag >= 0:
            i, j = k - 1 - lag, k - 1  # the source's partner of the newest
            lead = self.tgt_seq[j] if i < 0 else None
        else:
            i, j = k - 1, k - 1 + lag  # the newest source's older partner
            lead = self.src_seq[i] if j < 0 else None
        if lead is not None:
            # cadence warm-up: the faster side has not reached the slower
            # side's first covered tick; its unpartnered delta must be empty
            if len(lead[0]) or len(lead[1]):
                self.abort("cadence misalignment at cover start")
            return
        ds, dt = self.src_seq[i], self.tgt_seq[j]
        crc_s, crc_t = _crc_pair(ds), _crc_pair(dt)
        if crc_s != crc_t or not (np.array_equal(ds[0], dt[0])
                                  and np.array_equal(ds[1], dt[1])):
            self.abort("event delta mismatch between source and target")
            return
        self.crc = zlib.crc32(crc_s.to_bytes(4, "little"), self.crc)
        self.verified += 1
        if self.verified >= self.need:
            with _T.span("aoi.migrate.swap"):
                self._swap()

    # -- terminal transitions ---------------------------------------------

    def _finish(self) -> None:
        self.done = True
        if self.h._migration is self:
            self.h._migration = None
        if self in self.engine._migrations:
            self.engine._migrations.remove(self)

    def abort(self, reason: str) -> None:
        """Roll back to the source: drop the replayed target slot.  The
        source never stopped serving, so nothing is lost."""
        if self.done:
            return
        self._finish()
        self.engine.release_space(self.t)
        self.engine.migration_stats["migration_rollbacks"] += 1
        _log.warning("live migration rolled back after %d verified "
                     "flushes: %s", self.verified, reason)

    def _swap(self) -> None:
        """The ownership swap, at the end of a verified flush.

        The undelivered events follow the cadence lag L = lag_t - lag_s
        (events are taken every tick, so the source's pending tuple is
        exactly this flush's delta):

          L == 0:  the source's pending becomes the target slot's (the
                   target's copies went to the cover buffer);
          L == 1:  nothing is owed now: the target's tick in flight
                   delivers it, exactly, one tick later (the space takes
                   the deferred cadence);
          L == -1: the source's pending tick and the target's newest delta
                   deliver together (the space catches up in one tick).

        Releasing the source slot bumps its epoch, so a source tick still
        in flight neither publishes nor reaches the mirror; an exclusive
        source bucket is dropped with its device state."""
        h, nh, eng = self.h, self.t, self.engine
        src_bucket, src_slot = h.bucket, h.slot
        lag = self.lag_t - self.lag_s
        sp = src_bucket._events.pop(src_slot, None)
        owed = None
        if lag == 0:
            owed = sp
        elif lag < 0:
            s_e, s_l = sp if sp is not None else (_EMPTY, _EMPTY)
            t_e, t_l = self.tgt_seq[-1]
            owed = (np.concatenate([s_e, t_e]), np.concatenate([s_l, t_l]))
        if owed is not None and (len(owed[0]) or len(owed[1])):
            nh.bucket._events[nh.slot] = owed
        # the space's handle object stays: it points at the new home
        h.bucket, h.slot, h.backend = nh.bucket, nh.slot, nh.backend
        h.capacity = nh.capacity
        h.requested = nh.requested or h.requested
        nh.released = True  # the shell handle gives its slot to h
        self._finish()
        src_bucket.release_slot(src_slot)
        if getattr(src_bucket, "exclusive", False):
            eng._drop_bucket(src_bucket)
        eng.migration_stats["migrations"] += 1
        eng.migration_stats["migration_ms"] += (
            time.perf_counter() - self.t0) * 1e3


@dataclass
class LoadSample:
    """One bucket's load since the controller's previous sample."""

    key: tuple
    tier: str
    entities: int       # occupied slots
    flush_ms: float     # the bucket's flush seconds a tick, in ms
    h2d_bytes: float    # staged wire bytes a tick


def _load_samples(engine, base: dict, tick: int) -> list:
    """Each bucket's load since the caller's previous call, in key order.
    ``base`` is the caller's {key: (perf, h2d, tick)} floor."""
    out = []
    for key in sorted(engine._buckets):
        b = engine._buckets[key]
        perf = sum(getattr(b, "perf", {}).values())
        h2d = getattr(b, "stats", {}).get("h2d_bytes", 0)
        base_p, base_h, base_t = base.get(key, (0.0, 0, tick - 1))
        dt = max(1, tick - base_t)
        out.append(LoadSample(
            key=key, tier=engine._tier_of(b),
            entities=b.n_slots - len(b._free),
            flush_ms=(perf - base_p) * 1e3 / dt,
            h2d_bytes=(h2d - base_h) / dt))
        base[key] = (perf, h2d, tick)
    return out


def _first_live_handle(engine, bucket):
    live = [h for h in engine._handles
            if h.bucket is bucket and not h.released
            and h._migration is None]
    live.sort(key=lambda h: h.slot)
    return live[0] if live else None


class PlacementController:
    """Scores bucket placement from the buckets' load counters and runs
    live migrations (``Runtime(aoi_placement="static" | "auto")``).

    ``static`` moves nothing on its own; :meth:`migrate` stays the
    operator's entry point.  ``auto`` decides in :meth:`step` (the
    runtime calls it once a tick, after the tick's phases): a host bucket
    over ``threshold_ms`` a tick has its first space moved to the device
    tier (``mesh`` on a mesh engine, else ``cuda``); a device bucket far
    below it (occupied, ``flush_ms * 8 < threshold_ms``) has one moved to
    the native host calculator.  One migration at a time and
    ``cooldown_ticks`` between decisions, so a noisy boundary cannot
    flap."""

    def __init__(self, engine, mode: str = "static",
                 threshold_ms: float = 5.0, cooldown_ticks: int = 64):
        if mode not in ("static", "auto"):
            raise ValueError(
                f"aoi_placement must be 'static' or 'auto', got {mode!r}")
        self.engine = engine
        self.mode = mode
        self.threshold_ms = threshold_ms
        self.cooldown_ticks = cooldown_ticks
        self._cooldown = 0
        self._tick = 0
        self._base: dict[tuple, tuple] = {}

    def migrate(self, h, tier: str) -> _Migration:
        """Start a live migration of one space to ``tier`` (``cpu`` |
        ``cpp`` | ``cuda`` | ``mesh`` | ``rowshard``): the snapshot and
        the replay now, the cover over the next flushes, the swap once
        they agree.  Returns the migration in its cover."""
        eng = self.engine
        if h.released:
            raise MigrationError("cannot migrate a released handle")
        if h._migration is not None:
            raise MigrationError("handle is already migrating")
        with _T.span("aoi.migrate"):
            with _T.span("aoi.migrate.snapshot"):
                snap = h.bucket.export_snapshot(h.slot)
            with _T.span("aoi.migrate.replay"):
                nh = eng._create_handle(h.capacity, tier)
                nh.bucket.import_snapshot(nh.slot, snap)
            mig = _Migration(eng, h, nh)
            h._migration = mig
            eng._migrations.append(mig)
        return mig

    def load_samples(self) -> list[LoadSample]:
        """Each bucket's load since the previous call, in key order."""
        return _load_samples(self.engine, self._base, self._tick)

    def decide(self) -> tuple | None:
        """(handle, target tier) of the one most pressing move, or None.
        A promotion (host to device) outranks a demotion."""
        eng = self.engine
        samples = self.load_samples()
        device_tier = "mesh" if eng.mesh is not None else "cuda"
        promote = [s for s in samples
                   if s.tier in ("cpu", "cpp") and s.entities
                   and s.flush_ms > self.threshold_ms]
        if promote:
            worst = max(promote, key=lambda s: s.flush_ms)
            h = _first_live_handle(eng, eng._buckets[worst.key])
            if h is not None:
                return h, device_tier
        demote = [s for s in samples
                  if s.tier in ("cuda", "mesh") and s.entities
                  and s.flush_ms * 8 < self.threshold_ms]
        if demote:
            idlest = min(demote, key=lambda s: s.flush_ms)
            h = _first_live_handle(eng, eng._buckets[idlest.key])
            if h is not None:
                return h, "cpp"
        return None

    def settle(self, ticks: int | None = None) -> None:
        """Hold ``auto`` decisions for ``ticks`` (default one cooldown
        window): the first flushes after a restore are warm-up noise, and
        scoring them would move spaces mid-recovery."""
        self._cooldown = max(
            self._cooldown,
            self.cooldown_ticks if ticks is None else int(ticks))

    def step(self) -> None:
        """One controller tick.  ``flush`` drives the cover; this only
        decides new moves, and only in ``auto`` mode."""
        self._tick += 1
        if self.mode != "auto":
            return
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if self.engine._migrations:
            return  # one live migration at a time
        plan = self.decide()
        if plan is not None:
            h, tier = plan
            try:
                self.migrate(h, tier)
            except MigrationError:
                pass  # raced with a release; score again next window
            self._cooldown = self.cooldown_ticks


class CohortPlanner:
    """Load-driven cohort membership (``Runtime(aoi_cohort_planner=
    "static" | "auto")``).

    Scores the cohort tier as :class:`PlacementController` scores bucket
    tiers -- per-bucket flush-ms deltas from the same counters the
    telemetry collector exports -- and moves membership live through
    :meth:`..engine.aoi.AOIEngine.cohort_join` / ``cohort_leave`` (the
    snapshot seam, between flushes, bit-exact).  Two rules:

      * a cohort whose shared step takes more than ``hot_ms`` a tick sheds
        one member a window (the lowest slot: the load of one member is
        not attributed, and shedding any member shrinks the step);
      * a light solo space -- a planner leave or an ``aoi.cohort``
        demotion alike -- folds back into its rung's cohort, so the
        planner doubles as the demotion's re-arm loop.

    At most ``churn_budget`` moves a decision window and
    ``cooldown_ticks`` quiet ticks after any move; target shapes come
    only from the engine's ladder, so churn moves spaces between buckets
    that exist and mints no capture key."""

    def __init__(self, engine, mode: str = "static", hot_ms: float = 8.0,
                 churn_budget: int = 2, cooldown_ticks: int = 32):
        if mode not in ("static", "auto"):
            raise ValueError(
                f"aoi_cohort_planner must be 'static' or 'auto', "
                f"got {mode!r}")
        self.engine = engine
        self.mode = mode
        self.hot_ms = hot_ms
        self.churn_budget = churn_budget
        self.cooldown_ticks = cooldown_ticks
        self._cooldown = 0
        self._tick = 0
        self._base: dict[tuple, tuple] = {}

    def load_samples(self) -> list[LoadSample]:
        """Each bucket's load since the previous call (the planner's own
        window: the placement controller's sampling is undisturbed)."""
        return _load_samples(self.engine, self._base, self._tick)

    def decide(self) -> list[tuple]:
        """[(handle, "leave" | "join"), ...] for this window: bounded by
        the churn budget, deterministic (bucket key order, hot leaves
        first)."""
        eng = self.engine
        samples = self.load_samples()
        plan: list[tuple] = []
        for s in samples:
            if len(plan) >= self.churn_budget:
                return plan
            b = eng._buckets.get(s.key)
            if (b is not None and getattr(b, "cohort", False)
                    and s.entities > 1 and s.flush_ms > self.hot_ms):
                h = _first_live_handle(eng, b)
                if h is not None:
                    plan.append((h, "leave"))
        for s in samples:
            if len(plan) >= self.churn_budget:
                return plan
            b = eng._buckets.get(s.key)
            if (b is not None and getattr(b, "cohort_solo", False)
                    and s.entities and s.flush_ms * 4 < self.hot_ms):
                h = _first_live_handle(eng, b)
                if h is not None:
                    plan.append((h, "join"))
        return plan

    def step(self) -> None:
        """One planner tick (the runtime calls it after placement.step)."""
        self._tick += 1
        if self.mode != "auto":
            return
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        moved = 0
        for h, action in self.decide():
            if h.released:
                continue  # released inside the window
            if action == "leave":
                self.engine.cohort_leave(h)
            else:
                self.engine.cohort_join(h)
            moved += 1
        if moved:
            self._cooldown = self.cooldown_ticks
