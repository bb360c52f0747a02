"""Tick tracing of the port: spans -> bounded ring -> Chrome trace JSON.

The port's copy of the JAX package's ``telemetry/trace.py``.  The span
API times the tick pipeline with two spellings matched to the call
sites:

* ``with trace.span("tick.aoi"): ...`` -- block-shaped phases (the
  runtime's tick phases, the engine's flush);
* ``t0 = trace.t(); ...; trace.lap("tick", t0)`` -- intervals a ``with``
  block cannot bracket.

Disabled (the default) both are near-free: ``span`` returns a shared
no-op context manager, ``t`` returns 0.0 and ``lap`` does nothing -- one
global load and an ``is None`` test each, the same contract as
``faults.check``.  Tracing reads the host clock and nothing else --
never device state, never a synchronize -- so enabling it cannot perturb
the event stream.

The clock is injectable (the ``Runtime.now`` seam): ``enable(clock=...)``
or :func:`set_clock` route every timestamp through it, so tests drive
spans with a deterministic clock.  Completed spans land in a bounded
ring (``collections.deque(maxlen=...)``) as (name, thread id, t0, t1);
:func:`mark_tick` records tick boundaries so exports can window to the
last N ticks.  :func:`export_chrome_trace` emits the Chrome trace-event
JSON that Perfetto loads, and :func:`enable_cuda_annotations` (off by
default) bridges spans onto ``torch.profiler.record_function`` so they
show up inside a ``torch.profiler`` trace of the card.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

from ..consts import TRACE_RING_SPANS, TRACE_TICK_MARKS


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "tracer", "t0", "_annot")

    def __init__(self, name: str, tracer: "Tracer"):
        self.name = name
        self.tracer = tracer

    def __enter__(self):
        tr = self.tracer
        factory = tr.annot_factory
        self._annot = None
        if factory is not None:
            self._annot = factory(self.name)
            self._annot.__enter__()
        _active_stack().append(self.name)
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        t1 = tr.clock()
        if self._annot is not None:
            self._annot.__exit__(None, None, None)
        stack = _active_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        tr.record(self.name, self.t0, t1)
        return False


_ACTIVE = threading.local()


def _active_stack() -> list:
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    return stack


def current_span() -> str | None:
    """Name of the innermost open ``with span(...)`` block on this thread
    (None when outside any span or while tracing is disabled).  Log lines
    use it to self-locate in the tick pipeline (utils/gwlog.py)."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


class Tracer:
    def __init__(self, clock=time.perf_counter, ring: int = TRACE_RING_SPANS):
        self.clock = clock
        self.annot_factory = None  # set by enable_cuda_annotations
        # (name, tid, t0, t1) per completed span; deque appends are atomic
        self.ring = collections.deque(maxlen=ring)
        self.ticks = collections.deque(maxlen=TRACE_TICK_MARKS)

    def record(self, name: str, t0: float, t1: float) -> None:
        if t1 < t0:  # a clock swapped mid-span; clamp, don't corrupt
            t1 = t0
        self.ring.append((name, threading.get_ident(), t0, t1))

    def mark_tick(self, n: int) -> None:
        self.ticks.append((n, self.clock()))

    def reset(self) -> None:
        self.ring.clear()
        self.ticks.clear()


_TRACER: Tracer | None = None


def enabled() -> bool:
    return _TRACER is not None


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


def set_clock(clock) -> None:
    """Route span timestamps through ``clock`` (the Runtime.now seam).
    No-op while tracing is disabled."""
    tr = _TRACER
    if tr is not None:
        tr.clock = clock


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


def mark_tick(n: int) -> None:
    tr = _TRACER
    if tr is not None:
        tr.mark_tick(n)


def reset() -> None:
    tr = _TRACER
    if tr is not None:
        tr.reset()


def spans() -> list[tuple]:
    """Snapshot of the ring: (name, tid, t0, t1) tuples, oldest first."""
    tr = _TRACER
    if tr is None:
        return []
    return list(tr.ring)


def enable_cuda_annotations(on: bool = True) -> bool:
    """Bridge spans onto ``torch.profiler.record_function`` so they appear
    inside a ``torch.profiler`` trace of the card.  Reads torch from
    ``sys.modules`` -- the telemetry package never imports it -- and
    returns False (a no-op) when torch is not loaded, no CUDA device is
    attached, or tracing is disabled."""
    tr = _TRACER
    if tr is None:
        return False
    if not on:
        tr.annot_factory = None
        return True
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_available():
            return False
        factory = torch.profiler.record_function
    except Exception:
        return False
    tr.annot_factory = factory
    return True


def export_chrome_trace(path: str | None = None,
                        last_ticks: int | None = None) -> dict:
    """Chrome trace-event JSON for the buffered spans (Perfetto loads it
    as-is).  ``last_ticks`` windows to the most recent N tick marks;
    ``path`` additionally writes the JSON to a file."""
    tr = _TRACER
    events: list[dict] = []
    pid = os.getpid()
    if tr is not None:
        ring = list(tr.ring)
        ticks = list(tr.ticks)
        cutoff = None
        if last_ticks is not None and len(ticks) > last_ticks:
            cutoff = ticks[-last_ticks][1]
            ticks = ticks[-last_ticks:]
        stamps = [t0 for _, _, t0, _ in ring] + [ts for _, ts in ticks]
        base = min(stamps) if stamps else 0.0
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": "goworld_tpu_torch"}})
        for name, tid, t0, t1 in ring:
            if cutoff is not None and t1 < cutoff:
                continue
            events.append({
                "name": name, "cat": "tick", "ph": "X",
                "ts": round((t0 - base) * 1e6, 3),
                "dur": round((t1 - t0) * 1e6, 3),
                "pid": pid, "tid": tid,
            })
        for n, ts in ticks:
            events.append({
                "name": "tick %d" % n, "cat": "tick", "ph": "i", "s": "p",
                "ts": round((ts - base) * 1e6, 3), "pid": pid, "tid": 0,
            })
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
    return doc
