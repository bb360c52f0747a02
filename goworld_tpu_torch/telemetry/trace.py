"""Tick tracing of the port: spans -> a bounded ring.

The port's copy of the part of the JAX package's ``telemetry/trace.py``
that the interest, ingest and load modules use.  Two spellings:

* ``with trace.span("aoi.interest"): ...`` -- block-shaped phases;
* ``t0 = trace.t(); ...; trace.lap("aoi.fetch", t0)`` -- segments a
  ``with`` block cannot bracket.

Disabled (the default) both are near-free: ``span`` returns a shared
no-op context manager, ``t`` returns 0.0 and ``lap`` does nothing.
Tracing reads the clock and nothing else -- never device state -- so
enabling it cannot perturb the event stream.  Completed spans land in a
bounded ring (``collections.deque(maxlen=...)``) as (name, thread id,
t0, t1).  Tick marks, the Chrome trace export and the profiler bridge
stay with the runtime's telemetry (ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

import collections
import threading
import time

from ..consts import TRACE_RING_SPANS


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "tracer", "t0")

    def __init__(self, name: str, tracer: "Tracer"):
        self.name = name
        self.tracer = tracer

    def __enter__(self):
        self.t0 = self.tracer.clock()
        return self

    def __exit__(self, *exc):
        self.tracer.record(self.name, self.t0, self.tracer.clock())
        return False


class Tracer:
    def __init__(self, clock=time.perf_counter, ring: int = TRACE_RING_SPANS):
        self.clock = clock
        # (name, tid, t0, t1) per completed span; deque appends are atomic
        self.ring = collections.deque(maxlen=ring)

    def record(self, name: str, t0: float, t1: float) -> None:
        if t1 < t0:  # a clock swapped mid-span; clamp, don't corrupt
            t1 = t0
        self.ring.append((name, threading.get_ident(), t0, t1))


_TRACER: Tracer | None = None


def enable(clock=None, ring: int | None = None) -> Tracer:
    """Install a live tracer (idempotent; a new clock/ring replaces it)."""
    global _TRACER
    tr = _TRACER
    if tr is None or ring is not None or (clock is not None
                                          and clock is not tr.clock):
        tr = Tracer(clock or time.perf_counter, ring or TRACE_RING_SPANS)
        _TRACER = tr
    return tr


def disable() -> None:
    global _TRACER
    _TRACER = None


def span(name: str):
    """Context manager timing a block; the no-op singleton when disabled."""
    tr = _TRACER
    if tr is None:
        return _NOOP
    return _Span(name, tr)


def t() -> float:
    """Span start stamp for ``lap``; 0.0 (and free) when disabled."""
    tr = _TRACER
    if tr is None:
        return 0.0
    return tr.clock()


def lap(name: str, t0: float) -> float:
    """Record a completed span from a ``t()`` start stamp; returns the
    duration (0.0 when disabled)."""
    tr = _TRACER
    if tr is None:
        return 0.0
    t1 = tr.clock()
    tr.record(name, t0, t1)
    return t1 - t0


def reset() -> None:
    tr = _TRACER
    if tr is not None:
        tr.ring.clear()


def spans() -> list[tuple]:
    """Snapshot of the ring: (name, tid, t0, t1) tuples, oldest first."""
    tr = _TRACER
    if tr is None:
        return []
    return list(tr.ring)
