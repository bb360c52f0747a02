"""In-process operation monitor (reference: engine/opmon -- count/avg/max per
named operation, slow-op warnings, periodic dump).

Each op also feeds a pow2-bucket latency histogram (telemetry.metrics), so
``dump()`` reports p50/p99 alongside avg/max, and the whole table doubles
as a telemetry collector: ``/debug/opmon`` and ``/debug/metrics`` render
the same ``_stats`` dict, so they agree by construction.  When span tracing
is enabled, every finished Operation also lands in the trace ring under its
op name (the ``conn.flush`` / ``gate.client_pkt`` rows in a Perfetto view).

The port's copy of the JAX package's ``utils/opmon.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..telemetry import register_collector
from ..telemetry.metrics import Histogram, Sample
from ..telemetry import trace as _trace


def _new_hist() -> Histogram:
    return Histogram("opmon")  # standalone: always records (opmon is on)


@dataclass
class _OpStat:
    count: int = 0
    total: float = 0.0
    peak: float = 0.0
    hist: Histogram = field(default_factory=_new_hist)


_lock = threading.Lock()
_stats: dict[str, _OpStat] = {}


class Operation:
    """Times one named operation.  Context-manager use is canonical::

        with opmon.Operation("gate.client_pkt", 0.1, log):
            ...

    ``warn_threshold``/``logger`` given at construction apply on
    ``__exit__``; explicit ``finish(...)`` arguments override them."""

    __slots__ = ("name", "t0", "_tt0", "_warn", "_logger")

    def __init__(self, name: str, warn_threshold: float = 0.0, logger=None):
        self.name = name
        self._warn = warn_threshold
        self._logger = logger
        self.t0 = time.perf_counter()
        self._tt0 = _trace.t()

    def finish(self, warn_threshold: float | None = None, logger=None):
        dt = time.perf_counter() - self.t0
        if self._tt0:  # skip ops that started before tracing was enabled
            _trace.lap(self.name, self._tt0)
        with _lock:
            st = _stats.setdefault(self.name, _OpStat())
            st.count += 1
            st.total += dt
            st.peak = max(st.peak, dt)
            st.hist.observe(dt)
        if warn_threshold is None:
            warn_threshold = self._warn
        if logger is None:
            logger = self._logger
        if warn_threshold and dt > warn_threshold and logger is not None:
            logger.warning("op %s took %.1f ms (> %.1f ms)",
                           self.name, dt * 1e3, warn_threshold * 1e3)
        return dt

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


def start_operation(name: str) -> Operation:
    return Operation(name)


def dump() -> dict[str, dict]:
    with _lock:
        return {
            name: {
                "count": st.count,
                "avg_ms": (st.total / st.count * 1e3) if st.count else 0.0,
                "max_ms": st.peak * 1e3,
                "p50_ms": st.hist.quantile(0.5) * 1e3,
                "p99_ms": st.hist.quantile(0.99) * 1e3,
            }
            for name, st in _stats.items()
        }


def reset():
    with _lock:
        _stats.clear()


def _telemetry_collect():
    """Registry collector: the op table under ``opmon.*`` dotted names,
    one labeled sample set per op -- sourced from the same ``_stats`` dict
    as ``dump()``, so /debug/opmon and /debug/metrics always agree."""
    with _lock:
        items = [(name, st.count, st.total, st.peak,
                  st.hist.quantile(0.5), st.hist.quantile(0.99))
                 for name, st in sorted(_stats.items())]
    out = []
    for name, count, total, peak, p50, p99 in items:
        lbl = {"op": name}
        out.append(Sample("opmon.count", "counter", count, lbl,
                          "operations finished"))
        out.append(Sample("opmon.total_seconds", "counter", total, lbl,
                          "cumulative operation time"))
        out.append(Sample("opmon.peak_seconds", "gauge", peak, lbl,
                          "slowest single operation"))
        out.append(Sample("opmon.p50_seconds", "gauge", p50, lbl,
                          "median operation time (pow2 bucket bound)"))
        out.append(Sample("opmon.p99_seconds", "gauge", p99, lbl,
                          "p99 operation time (pow2 bucket bound)"))
    return out


register_collector(_telemetry_collect)


_dump_thread: threading.Thread | None = None
_dump_stop: threading.Event | None = None
_dump_refs = 0


def start_periodic_dump(interval: float) -> None:
    """Log the op table every ``interval`` seconds (reference: opmon's
    periodic dump, opmon.go:26-35,70-95).  Refcounted: components co-hosted
    in one process each start/stop it; the dumper thread runs while at
    least one is alive.  Each start gets its own stop event so
    stop-then-start cannot leave a fresh thread observing a stale flag.
    The dump logs through a module-level logger: binding the first caller's
    logger would misattribute every co-hosted component's ops to it (and
    keep logging through a stopped component)."""
    global _dump_thread, _dump_stop, _dump_refs
    with _lock:
        _dump_refs += 1
        if (_dump_thread is not None and _dump_thread.is_alive()
                and _dump_stop is not None and not _dump_stop.is_set()):
            return
        stop = threading.Event()
        _dump_stop = stop

        def run():
            from . import gwlog

            mod_log = gwlog.logger("opmon")
            while not stop.wait(interval):
                table = dump()
                if not table:
                    continue
                lines = [
                    f"  {name:32s} x{st['count']:<8d} avg {st['avg_ms']:8.2f} ms"
                    f"  p99 {st['p99_ms']:8.2f} ms  max {st['max_ms']:8.2f} ms"
                    for name, st in sorted(table.items())
                ]
                mod_log.info("opmon:\n%s", "\n".join(lines))

        # still inside _lock: a concurrent start must not spawn a second
        # dumper whose stop event was just orphaned
        _dump_thread = threading.Thread(target=run, daemon=True)
        _dump_thread.start()


def stop_periodic_dump() -> None:
    global _dump_refs
    with _lock:
        _dump_refs = max(0, _dump_refs - 1)
        if _dump_refs == 0 and _dump_stop is not None:
            _dump_stop.set()
