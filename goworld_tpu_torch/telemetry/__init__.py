"""Telemetry of the port: metrics registry + tick tracing + exposition.

The port's copy of the JAX package's ``telemetry/``.  Stdlib-only at
import: importable from anywhere in the package (faults, the engine
buckets, the runtime) with no cycle, and it never imports torch.

* :mod:`.metrics` -- the process-wide :class:`~.metrics.Registry` of
  counters/gauges/pow2-bucket histograms plus the collector pull point
  that unifies the always-on stat sources (the AOI buckets' ``stats`` and
  ``perf``, the ``faults`` plan) under stable dotted names;
* :mod:`.trace` -- the span API over a bounded ring, Chrome trace-event
  export and an optional ``torch.profiler`` annotation bridge;
* :mod:`.tracectx` -- the trace-context trailer of the movement wire and
  its received-hop ring;
* :mod:`.flight` -- the always-on flight recorder and its dumps.

``enable()`` turns instruments and spans on (``Runtime(telemetry_on=True)``
calls it); disabled -- the default -- every hot-path hook is a no-op and
the engine's behavior stays bit-identical.  Exposition (:func:`snapshot`,
:func:`render_prometheus`) works while disabled: collectors read stat
sources that are always on anyway.

``GW_TELEMETRY=1`` in the environment enables at import.
"""

from __future__ import annotations

import os
import sys

from . import metrics, trace
from .metrics import HIST_BOUNDS, Counter, Gauge, Histogram, Registry, Sample

_REGISTRY = Registry(enabled=False)


def accelerator_absent() -> bool:
    """True when this process has no CUDA device attached.  Reads
    ``sys.modules`` instead of importing torch: the telemetry package
    stays torch-free, and a process that never imported torch truthfully
    has no accelerator."""
    torch = sys.modules.get("torch")
    if torch is None:
        return True
    try:
        return not torch.cuda.is_available()
    except Exception:
        return True


def _accelerator_collect() -> list[Sample]:
    # always on (registered at import, served with telemetry off): whether
    # this process's numbers are a card's must be scrapeable
    return [Sample("accelerator_absent", "gauge",
                   1.0 if accelerator_absent() else 0.0,
                   help="1 when this process has no CUDA device attached "
                        "(its perf numbers are not accelerator evidence)")]


_REGISTRY.register_collector(_accelerator_collect)


def registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY.enabled


def enable(clock=None, ring: int | None = None) -> None:
    """Turn on instruments and span tracing process-wide.  ``clock`` routes
    span timestamps through an injected time source (the Runtime.now
    seam); ``ring`` bounds the span buffer."""
    _REGISTRY.enabled = True
    trace.enable(clock=clock, ring=ring)


def disable() -> None:
    _REGISTRY.enabled = False
    trace.disable()


def counter(name: str, help: str = "") -> Counter:
    return _REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    return _REGISTRY.histogram(name, help)


def register_collector(fn, weak: bool = False) -> None:
    _REGISTRY.register_collector(fn, weak=weak)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "Sample", "HIST_BOUNDS",
    "metrics", "trace", "registry", "enabled", "enable", "disable",
    "counter", "gauge", "histogram", "register_collector", "snapshot",
    "render_prometheus", "accelerator_absent",
]

if os.environ.get("GW_TELEMETRY", "") in ("1", "true", "yes"):
    enable()
