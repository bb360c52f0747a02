"""Metrics registry of the port: counters, gauges, pow2-bucket histograms.

The port's copy of the part of the JAX package's ``telemetry/metrics.py``
that the interest, ingest and load modules use: the three instruments
and the :class:`Registry` that hands them out by stable dotted name, with
``snapshot``.  Mutators are thread-safe and allocate nothing; while the
registry is disabled (the default) they are no-ops, so a telemetry-off
process pays ~0 and behaves bit-identically.  The collectors and the
Prometheus exposition stay with the runtime's telemetry (ROADMAP.md
queue 1, item 12).

Histogram buckets are fixed powers of two (``2^-20``..``2^4`` seconds,
~1 us to 16 s): ``observe`` finds its bucket with ``math.frexp`` -- no
search, no allocation -- and quantiles come from a cumulative walk.
"""

from __future__ import annotations

import math
import threading

# pow2 bucket upper bounds for timing histograms: 2^-20 s (~1 us) .. 2^4 s
# (16 s); one overflow bucket (+Inf) on top.
HIST_LO_EXP = -20
HIST_HI_EXP = 4
HIST_BOUNDS = tuple(2.0 ** e for e in range(HIST_LO_EXP, HIST_HI_EXP + 1))
_NBUCKETS = len(HIST_BOUNDS) + 1  # trailing +Inf overflow bucket


def bucket_index(v: float) -> int:
    """Index of the smallest pow2 bound >= ``v`` (overflow -> last)."""
    if v <= HIST_BOUNDS[0]:
        return 0
    if v > HIST_BOUNDS[-1]:
        return _NBUCKETS - 1
    m, e = math.frexp(v)  # v = m * 2**e with 0.5 <= m < 1
    k = e - 1 if m == 0.5 else e  # smallest k with 2**k >= v
    return k - HIST_LO_EXP


class Counter:
    """Monotonic counter.  ``inc`` is thread-safe and zero-alloc."""

    __slots__ = ("name", "help", "_reg", "_lock", "value")

    def __init__(self, name: str, help: str = "", _reg=None):
        self.name = name
        self.help = help
        self._reg = _reg
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        reg = self._reg
        if reg is not None and not reg.enabled:
            return
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "help", "_reg", "value")

    def __init__(self, name: str, help: str = "", _reg=None):
        self.name = name
        self.help = help
        self._reg = _reg
        self.value = 0.0

    def set(self, v: float) -> None:
        reg = self._reg
        if reg is not None and not reg.enabled:
            return
        self.value = v  # single attribute store: atomic under the GIL


class Histogram:
    """Fixed pow2-bucket histogram (seconds-scale timings).

    Standalone instances (no registry) always record; registry-created
    ones no-op while the registry is disabled.
    """

    __slots__ = ("name", "help", "_reg", "_lock", "_counts", "sum", "count")

    def __init__(self, name: str, help: str = "", _reg=None):
        self.name = name
        self.help = help
        self._reg = _reg
        self._lock = threading.Lock()
        self._counts = [0] * _NBUCKETS
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        reg = self._reg
        if reg is not None and not reg.enabled:
            return
        i = bucket_index(v)
        with self._lock:
            self._counts[i] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the ``q``-quantile (0 when
        empty).  Coarse by design: pow2 bounds give half-order-of-magnitude
        resolution, enough to tell a 2 ms p99 from a 200 ms one."""
        with self._lock:
            total = self.count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                return HIST_BOUNDS[i] if i < len(HIST_BOUNDS) \
                    else float("inf")
        return float("inf")

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.sum,
                    "buckets": list(self._counts)}


class Registry:
    """Thread-safe instrument store."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    # -- instruments -------------------------------------------------------
    def _get(self, cls, name: str, help: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, _reg=self)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat name -> value dict (histograms expand to .count/.sum/
        .p50/.p99)."""
        out: dict[str, float] = {}
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if isinstance(m, Histogram):
                out[name + ".count"] = m.count
                out[name + ".sum"] = m.sum
                out[name + ".p50"] = m.quantile(0.5)
                out[name + ".p99"] = m.quantile(0.99)
            else:
                out[name] = m.value
        return out
