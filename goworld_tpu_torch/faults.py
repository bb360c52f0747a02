"""Deterministic fault injection: every failure we can name is replayable.

The port's own copy of the JAX package's ``goworld_tpu/faults.py``: the
same seam catalog, kinds, plan grammar, ``@auto`` scheduling and
``GW_FAULT_PLAN`` activation, so one plan string fires at the same seam
occurrences in both packages.  Its state is its own: a plan installed
here is invisible to the JAX package, and the reverse.

A :class:`FaultPlan` is a seedable list of (seam, kind, occurrence) specs.
Production code is instrumented with named *seams* -- ``faults.check(seam)``
calls that are no-ops (one global load + ``is None`` test) until a plan is
installed.  Each seam keeps an occurrence counter; a spec fires when its
seam's counter hits the spec's ``at`` (1-based), so a given (seed, seam,
occurrence) tuple replays the same fault in every run -- tests and the
chip smoke can assert on exact fault ticks.  The recovery half lives in
the port's AOI buckets (:mod:`.engine.aoi`: rebuild from the host copies,
the calculator and emit fallback chains).

The port crosses the ``aoi.grow``, ``aoi.h2d``, ``aoi.delta``,
``aoi.kernel``, ``aoi.scalars``, ``aoi.fetch``, ``aoi.emit`` and
``aoi.device`` seams; the others are named for the modules that cross
them (ROADMAP.md queue 1 lists those still to port).

Seam catalog (every name here must be exercised by at least one test --
enforced by the ``fault-seam-coverage`` gwlint rule):

========================  =====================================================
seam                      fires in
========================  =====================================================
``aoi.grow``              device allocation when a bucket grows its slots
``aoi.h2d``               full role-array upload (``_h2d``) during staging
``aoi.delta``             sparse delta-packet scatter during staging
``aoi.kernel``            the fused AOI kernel launch (bucket step) --
                          enqueued at dispatch; a real async-dispatch
                          error would surface at harvest, which the
                          ``aoi.fetch`` kinds model
``aoi.scalars``           control-scalar fetch (poison: corrupt the
                          values) -- issued async at dispatch, validated
                          at harvest decode
``aoi.fetch``             event-stream harvest drain (stall: delay the
                          host sync; fail/oom: the fault a dispatched
                          kernel surfaces at its blocking fetch)
``aoi.emit``              native event fan-out (libgwemit) during harvest
                          publish -- handled LOCALLY: the bucket demotes
                          to the host decode path and republishes the
                          same tick bit-exactly (never reaches the
                          device-fault recovery)
``aoi.device``            device health probe at bucket dispatch; kind
                          ``reset`` = the chip is LOST (raises
                          :class:`DeviceLost`): the bucket recovers the
                          in-flight tick host-side, marks itself
                          evacuating, and the engine rebuilds its spaces
                          onto surviving devices (docs/robustness.md
                          live migration & failover)
``aoi.ingest``            batched wire->column movement decode
                          (goworld_tpu/ingest/): any kind demotes the
                          whole batch to the per-entity apply path --
                          bit-identical semantics, counted in the
                          ingest fallback stats
``aoi.interest``          interest-policy stack evaluation (goworld_tpu/
                          interest/): poisoned mask, stale tier state,
                          corrupt distance field -- ANY fired kind
                          demotes the space's stack STICKY to the
                          radius-only oracle path (the one filter no
                          corrupt policy state can reach), counted in
                          ``interest.demotions``; the operator re-arm is
                          ``PolicyStack.reset_interest`` (next step is a
                          forced full eval whose diff re-emits the
                          policy transitions deterministically)
``aoi.cohort``            cohort-bucket health probe at dispatch
                          (engine/aoi_cohort.py, docs/perf.md
                          space-stacked cohorts): ANY fired kind
                          demotes the whole cohort to per-space solo
                          buckets -- this tick's staged inputs re-stage
                          and republish same-tick bit-exactly, counted
                          in ``aoi.cohort_demotions``; the operator
                          re-arm is ``AOIEngine.recohort`` (demoted
                          spaces re-stack through the snapshot seam)
``aoi.pages``             paged-storage allocator at harvest (paged
                          buckets, docs/perf.md): ``oom``/``fail``/
                          ``partial`` = pool exhaustion -- the bucket
                          spills the whole tick to host from the kept
                          change grid (counted in ``aoi.page_spills``),
                          republishes it same-tick bit-exactly and
                          re-arms the pool; ``poison`` = page-table
                          corruption -- validation catches it and the
                          bucket rebuilds from the host shadows
                          (``_recover_harvest``), reinitializing the
                          free list
``conn.send``             typed packet send (proto/connection.py)
``conn.flush``            framed batch write (netutil/conn.py flush)
``conn.recv``             blocking packet read (netutil/conn.py recv)
``disp.connect``          dispatcher connect attempt (dispatchercluster)
``bench.config``          per-config bench run (bench.py main loop)
``store.write``           checkpoint journal record write (engine/
                          checkpoint.py background writer):
                          ``fail``/``oom``/``reset`` = counted retry with
                          capped backoff; retry budget exhausted = the
                          epoch is dropped (counted) and the next capture
                          is forced to a fresh base; ``partial``/
                          ``poison`` = a torn/corrupt record lands on
                          disk -- exactly what a mid-write SIGKILL
                          leaves -- and the per-record CRC catches it at
                          restore.  Never blocks the tick
``store.read``            checkpoint journal record read at restore:
                          ``fail``/``oom``/``reset`` = counted retry;
                          ``partial``/``poison`` = torn/corrupt blob ->
                          CRC mismatch -> the chain walk falls back to
                          the last consistent epoch
``store.manifest``        checkpoint manifest kvdb put/find: ``fail``/
                          ``oom``/``reset`` = counted retry;
                          ``partial``/``poison`` = unparseable manifest
                          value, skipped at restore (the epoch reads as
                          absent; an earlier consistent epoch wins)
``clu.lease``             a game's per-dispatcher lease renewal (game
                          service / failover driver): ``stall`` parks the
                          renewal past the lease TTL so the dispatcher
                          declares the game dead and fails its spaces
                          over -- the late renewal then arrives with a
                          stale epoch and is fenced
``clu.kill``              the supervision driver's SIGKILL of a child
                          game process (engine/failover.py): crossed
                          right before the real ``kill -9``, so soaks
                          can count / stall / suppress host kills
                          deterministically
``clu.zombie``            the stall-then-resume split-brain probe in a
                          game's packet-processing loop: ``stall`` parks
                          the process past lease expiry and lets it
                          resume believing it still owns its spaces --
                          its next packet carries the old epoch and MUST
                          be fenced (counted, dropped, shutdown notice)
``clu.restore``           per-space checkpoint restore during failover
                          re-homing (``restore_into`` on the survivor):
                          any raising kind = that space's re-home is
                          abandoned this round (counted, the directory
                          keeps it dead rather than half-alive);
                          ``stall`` stretches ``ticks_to_recover``
========================  =====================================================

Kinds: ``oom`` (raise :class:`DeviceOOM`), ``fail`` (raise
:class:`KernelFailure`), ``reset`` (raise ``ConnectionResetError``),
``stall`` (sleep ``arg`` seconds, then continue), ``partial`` (returned to
the caller, which writes ``arg`` fraction of the bytes then drops the
link), ``poison`` (applied via :func:`filter`: corrupt the value).

Activation: ``faults.install(plan)`` (what ``Runtime(fault_plan=...)``
does), or the ``GW_FAULT_PLAN`` environment variable, parsed at import::

    GW_FAULT_PLAN="seed=7;aoi.h2d:oom@3;aoi.kernel:fail@5;conn.flush:reset@2"

Entry grammar: ``seam:kind@AT[xCOUNT][:ARG]`` -- fire ``kind`` at the
``AT``-th occurrence of ``seam`` (``COUNT`` consecutive occurrences,
default 1), with optional float ``ARG`` (stall seconds / partial
fraction).  ``AT`` may be ``auto``: derived deterministically from the
plan seed and the seam name, so a seeded plan scatters faults without
hand-picking ticks.  A malformed entry raises ``ValueError`` naming the
offending token and this grammar (a typo'd ``GW_FAULT_PLAN`` must fail
loudly at import, not with a bare int() traceback).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass

KINDS = ("oom", "fail", "stall", "poison", "reset", "partial")

SEAMS = {
    "aoi.grow": "device allocation on bucket slot growth",
    "aoi.h2d": "full role-array upload during input staging",
    "aoi.delta": "sparse delta-packet scatter during input staging",
    "aoi.kernel": "fused AOI kernel launch (enqueued at dispatch)",
    "aoi.scalars": "control-scalar fetch (poisonable; validated at harvest)",
    "aoi.fetch": "harvest-phase host sync (stallable; fail/oom = async "
                 "dispatch errors surfacing at the blocking fetch)",
    "aoi.emit": "native event fan-out during harvest publish (demotes to "
                "host decode, same-tick bit-exact fallback)",
    "aoi.device": "device health probe at bucket dispatch (reset = chip "
                  "lost; the bucket evacuates to surviving devices)",
    "aoi.cohort": "cohort-bucket health probe at dispatch (any kind = "
                  "demote the whole cohort to per-space solo buckets, "
                  "counted, same-tick bit-exact republish; "
                  "AOIEngine.recohort re-arms)",
    "aoi.pages": "paged-storage allocator at harvest (oom/fail/partial = "
                 "counted whole-tick spill + pool re-arm; poison = page-"
                 "table corruption caught by validation -> shadow rebuild)",
    "aoi.ingest": "batched wire->column movement decode (any kind demotes "
                  "the batch to the per-entity apply path, bit-identical)",
    "aoi.interest": "interest-policy stack evaluation (any kind = poisoned "
                    "mask / stale tier / corrupt distance field -> sticky "
                    "demotion to the radius-only oracle path, counted; "
                    "PolicyStack.reset_interest re-arms)",
    "conn.send": "typed packet send",
    "conn.flush": "framed batch write",
    "conn.recv": "blocking packet read",
    "disp.connect": "dispatcher connect attempt",
    "bench.config": "per-config bench run",
    "store.write": "checkpoint journal record write (engine/checkpoint.py "
                   "background writer; fail/oom/reset = counted retry with "
                   "capped backoff, partial/poison = torn/corrupt record "
                   "lands and the per-record CRC catches it at restore)",
    "store.read": "checkpoint journal record read during restore (fail/oom/"
                  "reset = counted retry; partial/poison = the read blob is "
                  "torn/corrupt -> CRC mismatch -> fall back to the last "
                  "consistent epoch)",
    "store.manifest": "checkpoint manifest kvdb put/find (fail/oom/reset = "
                      "counted retry; partial/poison = unparseable manifest "
                      "entry, skipped at restore -> earlier epoch wins)",
    "clu.lease": "per-dispatcher game lease renewal (stall = miss the TTL "
                 "-> the dispatcher fails the game's spaces over and the "
                 "late renewal is fenced as a stale epoch)",
    "clu.kill": "supervision driver SIGKILL of a child game process "
                "(engine/failover.py; crossed right before the real kill "
                "-9 so soaks can gate host kills deterministically)",
    "clu.zombie": "stall-then-resume split-brain probe in a game's packet "
                  "loop (stall past lease expiry, resume, next packet "
                  "carries the stale epoch and must be fenced)",
    "clu.restore": "per-space checkpoint restore during failover re-homing "
                   "(raising kinds abandon that space's re-home, counted; "
                   "stall stretches ticks_to_recover)",
}


class InjectedFault(RuntimeError):
    """Base class for all injected faults (so recovery code can tell an
    injected fault from a logic bug when it matters)."""


class DeviceOOM(InjectedFault):
    """Injected device allocation failure.  The message carries the JAX
    package's status text, so the logs of both packages read alike."""

    def __init__(self, seam: str, occurrence: int):
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected device OOM "
            f"(seam={seam}, occurrence={occurrence})")


class KernelFailure(InjectedFault):
    """Injected kernel-launch failure."""

    def __init__(self, seam: str, occurrence: int):
        super().__init__(
            f"INTERNAL: injected kernel failure "
            f"(seam={seam}, occurrence={occurrence})")


class DeviceLost(InjectedFault):
    """Injected permanent device loss (the ``aoi.device`` seam's ``reset``
    kind).  Unlike :class:`DeviceOOM` -- a transient the bucket recovers
    from in place -- this one means the chip is GONE: recovery must land
    on a different device (bucket evacuation, docs/robustness.md)."""

    def __init__(self, seam: str, occurrence: int):
        super().__init__(
            f"FAILED_PRECONDITION: injected device loss "
            f"(seam={seam}, occurrence={occurrence})")


@dataclass
class FaultSpec:
    seam: str
    kind: str
    at: int          # 1-based occurrence at which to start firing
    count: int = 1   # consecutive occurrences to fire on
    arg: float | None = None  # stall seconds / partial fraction

    def __post_init__(self):
        if self.seam not in SEAMS:
            raise ValueError(f"unknown fault seam {self.seam!r}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at < 1 or self.count < 1:
            raise ValueError("fault occurrence/count must be >= 1")

    def matches(self, occurrence: int) -> bool:
        return self.at <= occurrence < self.at + self.count


def derive_occurrence(seed: int, seam: str, lo: int = 1, hi: int = 8) -> int:
    """Deterministic occurrence in [lo, hi] from (seed, seam) -- the
    ``@auto`` scheduling.  sha256, not ``random``: stable across processes
    and python versions."""
    h = hashlib.sha256(f"{seed}:{seam}".encode()).digest()
    return lo + int.from_bytes(h[:4], "little") % (hi - lo + 1)


class FaultPlan:
    """A seedable, thread-safe set of fault specs with per-seam occurrence
    counters.  ``fired`` records every fault taken (seam, kind, occurrence,
    arg) for tests and status reporting."""

    def __init__(self, seed: int = 0, specs: list[FaultSpec] | None = None):
        self.seed = seed
        self.specs: list[FaultSpec] = list(specs or [])
        self.counts: dict[str, int] = {}
        self.fired: list[dict] = []
        self._lock = threading.Lock()

    def add(self, seam: str, kind: str, at: int | str = "auto",
            count: int = 1, arg: float | None = None) -> "FaultPlan":
        if at == "auto":
            at = derive_occurrence(self.seed, seam)
        self.specs.append(FaultSpec(seam, kind, int(at), count, arg))
        return self

    # -- firing ------------------------------------------------------------
    def _hit(self, seam: str) -> tuple[FaultSpec | None, int]:
        hit = None
        with self._lock:
            n = self.counts.get(seam, 0) + 1
            self.counts[seam] = n
            for spec in self.specs:
                if spec.seam == seam and spec.matches(n):
                    self.fired.append({"seam": seam, "kind": spec.kind,
                                       "occurrence": n, "arg": spec.arg})
                    hit = spec
                    break
        return hit, n

    def check(self, seam: str) -> FaultSpec | None:
        """Count one occurrence of ``seam``; raise/stall if a spec fires.
        Returns the fired spec for caller-handled kinds (``partial``),
        None otherwise."""
        spec, n = self._hit(seam)
        if spec is None:
            return None
        if spec.kind == "oom":
            raise DeviceOOM(seam, n)
        if spec.kind == "fail":
            raise KernelFailure(seam, n)
        if spec.kind == "reset":
            if seam == "aoi.device":
                # device seams have no connection to reset: reset = the
                # chip itself is lost (permanent; the bucket must evacuate)
                raise DeviceLost(seam, n)
            raise ConnectionResetError(
                f"injected connection reset (seam={seam}, occurrence={n})")
        if spec.kind == "stall":
            time.sleep(spec.arg if spec.arg is not None else 0.005)
            return spec
        return spec  # partial / poison: the caller applies it

    def filter(self, seam: str, value):
        """Count one occurrence of ``seam``; when a ``poison`` spec fires,
        return a corrupted copy of ``value`` (numpy arrays get garbage the
        consumer's validation must catch), else ``value`` unchanged."""
        spec, _ = self._hit(seam)
        if spec is None or spec.kind != "poison":
            return value
        import numpy as np

        arr = np.array(value, copy=True)
        if arr.dtype.kind == "f":
            arr[...] = np.nan
        else:
            # most-negative value of the dtype: fails any sane range check
            arr[...] = np.iinfo(arr.dtype).min
        return arr

    def snapshot(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "counts": dict(self.counts),
                    "fired": list(self.fired),
                    "specs": [vars(s).copy() for s in self.specs]}


_GRAMMAR = ("seam:kind@AT[xCOUNT][:ARG] with AT a 1-based integer or "
            "'auto', COUNT a positive integer, ARG a float "
            "(e.g. 'aoi.h2d:oom@3' or 'conn.flush:stall@2x3:0.01')")


def parse(text: str) -> FaultPlan:
    """Parse a ``GW_FAULT_PLAN`` string (grammar in the module docstring).
    Malformed entries raise ``ValueError`` naming the offending token AND
    the accepted grammar -- a typo'd env var must not surface as a bare
    ``int()`` traceback with no hint which entry broke."""
    seed = 0
    entries = []
    for part in filter(None, (p.strip() for p in text.split(";"))):
        if part.startswith("seed="):
            try:
                seed = int(part[5:])
            except ValueError:
                raise ValueError(
                    f"bad fault-plan seed {part!r}: want seed=<int>") from None
        else:
            entries.append(part)
    plan = FaultPlan(seed)
    for part in entries:
        try:
            seam, _, rest = part.partition(":")
            kind, _, where = rest.partition("@")
            if not seam or not kind or not where:
                raise ValueError("missing seam, kind, or @AT")
            arg = None
            if ":" in where:
                where, _, argtext = where.partition(":")
                arg = float(argtext)
            count = 1
            if "x" in where:
                where, _, counttext = where.partition("x")
                count = int(counttext)
            at = "auto" if where == "auto" else int(where)
            plan.add(seam, kind, at, count, arg)
        except ValueError as e:
            raise ValueError(
                f"bad fault spec {part!r} ({e}); accepted grammar: "
                f"{_GRAMMAR}") from None
    return plan


# -- process-global plan ---------------------------------------------------
_PLAN: FaultPlan | None = None


def install(plan: "FaultPlan | str | None") -> FaultPlan | None:
    """Install a plan process-wide (str specs are parsed); None clears."""
    global _PLAN
    _PLAN = parse(plan) if isinstance(plan, str) else plan
    return _PLAN


def clear() -> None:
    install(None)


def plan() -> FaultPlan | None:
    return _PLAN


def active() -> bool:
    return _PLAN is not None


def check(seam: str) -> FaultSpec | None:
    """The seam hook.  No plan installed: one global load, zero cost."""
    p = _PLAN
    if p is None:
        return None
    return p.check(seam)


def filter(seam: str, value):  # noqa: A001 -- deliberate: faults.filter(seam, v)
    p = _PLAN
    if p is None:
        return value
    return p.filter(seam, value)


_env = os.environ.get("GW_FAULT_PLAN")
if _env:
    _PLAN = parse(_env)
del _env


# The JAX package registers a telemetry collector here (plan live, per-seam
# crossings and faults taken); the port's telemetry registry comes with
# ROADMAP.md queue 1, item 12, and the collector with it.
