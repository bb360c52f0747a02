"""Metrics registry of the port: counters, gauges, pow2-bucket histograms.

The port's copy of the JAX package's ``telemetry/metrics.py``.  One
process-wide :class:`Registry` (held by ``goworld_tpu_torch.telemetry``)
unifies the stats the engine already keeps -- the AOI buckets' ``stats``
and ``perf`` dicts, the ``faults`` plan's crossings and firings -- under
stable dotted names, and renders them as Prometheus text exposition.

Two kinds of series:

* **instruments** -- :class:`Counter` / :class:`Gauge` / :class:`Histogram`
  objects created through the registry.  Mutators are thread-safe and
  allocate nothing on the hot path; while the registry is disabled (the
  default) they are no-ops (one attribute load + flag test), so a
  telemetry-off process pays ~0 and its behavior is bit-identical.
* **collectors** -- callables registered by the stat owners (``faults``,
  each ``AOIEngine``) that translate their always-on counters into
  :class:`Sample` rows at scrape time.  The hot paths keep their plain
  dict counters; the registry reads them only when asked, so exposition
  works with telemetry disabled, and a scrape never syncs the device.

Histogram buckets are fixed powers of two (``2^-20``..``2^4`` seconds,
~1 us to 16 s): ``observe`` finds its bucket with ``math.frexp`` -- no
search, no allocation -- and quantiles come from a cumulative walk.
"""

from __future__ import annotations

import math
import re
import threading
import weakref
from typing import Callable, Iterable, NamedTuple

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


class Sample(NamedTuple):
    """One exposition row, as produced by collectors."""

    name: str                    # stable dotted name ("aoi.h2d_bytes")
    kind: str                    # "counter" | "gauge"
    value: float
    labels: dict | None = None   # e.g. {"seam": "aoi.h2d"}
    help: str = ""


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


_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(dotted: str) -> str:
    return "gw_" + _NAME_OK.sub("_", dotted)


def _prom_labels(labels: dict | None, extra: tuple = ()) -> str:
    items = sorted(labels.items()) if labels else []
    items += list(extra)
    if not items:
        return ""
    body = ",".join('%s="%s"' % (k, str(v).replace('"', r"\""))
                    for k, v in items)
    return "{" + body + "}"


class Registry:
    """Thread-safe instrument store + collector pull point."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: list = []  # callables or weakref.WeakMethod

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

    # -- collectors --------------------------------------------------------
    def register_collector(self, fn: Callable[[], Iterable[Sample]],
                           weak: bool = False) -> None:
        """Register a sample producer.  ``weak=True`` wraps a bound method
        in a WeakMethod so the registry never keeps its owner (an
        AOIEngine) alive; dead entries are pruned at the next scrape."""
        entry = weakref.WeakMethod(fn) if weak else fn
        with self._lock:
            self._collectors.append(entry)

    def _collect(self) -> list[Sample]:
        with self._lock:
            entries = list(self._collectors)
        out: list[Sample] = []
        dead = []
        for entry in entries:
            fn = entry
            if isinstance(entry, weakref.WeakMethod):
                fn = entry()
                if fn is None:
                    dead.append(entry)
                    continue
            out.extend(fn())
        if dead:
            with self._lock:
                for entry in dead:
                    try:
                        self._collectors.remove(entry)
                    except ValueError:
                        pass
        return out

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat name -> value dict (histograms expand to .count/.sum/
        .p50/.p99).  Labeled collector samples key as name{k=v,...}."""
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
        for s in sorted(self._collect(),
                        key=lambda s: (s.name, sorted((s.labels or {}).items()))):
            key = s.name + _prom_labels(s.labels) if s.labels else s.name
            out[key] = out.get(key, 0.0) + s.value
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            pname = _prom_name(name)
            if isinstance(m, Counter):
                self._head(lines, pname + "_total", "counter", m.help)
                lines.append("%s_total %s" % (pname, _num(m.value)))
            elif isinstance(m, Gauge):
                self._head(lines, pname, "gauge", m.help)
                lines.append("%s %s" % (pname, _num(m.value)))
            else:
                snap = m.snapshot()
                self._head(lines, pname, "histogram", m.help)
                cum = 0
                for i, bound in enumerate(HIST_BOUNDS):
                    cum += snap["buckets"][i]
                    lines.append('%s_bucket{le="%s"} %d'
                                 % (pname, _num(bound), cum))
                cum += snap["buckets"][-1]
                lines.append('%s_bucket{le="+Inf"} %d' % (pname, cum))
                lines.append("%s_sum %s" % (pname, _num(snap["sum"])))
                lines.append("%s_count %d" % (pname, snap["count"]))
        by_name: dict[str, list[Sample]] = {}
        for s in self._collect():
            by_name.setdefault(s.name, []).append(s)
        for name in sorted(by_name):
            group = by_name[name]
            pname = _prom_name(name)
            kind = group[0].kind
            suffix = "_total" if kind == "counter" else ""
            self._head(lines, pname + suffix, kind, group[0].help)
            for s in sorted(group,
                            key=lambda s: sorted((s.labels or {}).items())):
                lines.append("%s%s%s %s" % (pname, suffix,
                                            _prom_labels(s.labels),
                                            _num(s.value)))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _head(lines: list[str], pname: str, kind: str, help: str) -> None:
        if help:
            lines.append("# HELP %s %s" % (pname, help.replace("\n", " ")))
        lines.append("# TYPE %s %s" % (pname, kind))


def _num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 2 ** 53 else repr(f)
