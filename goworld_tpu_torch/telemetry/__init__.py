"""Telemetry of the port: the metrics registry and span tracing.

The port's copy of the part of the JAX package's ``telemetry/`` that the
interest, ingest and load modules use (:mod:`.metrics`, :mod:`.trace`);
the collectors, the flight recorder, trace contexts and
``Runtime(telemetry=...)`` come with ROADMAP.md queue 1, item 12.
``enable()`` turns instruments and spans on; disabled -- the default --
every hot-path hook is a no-op and the engine's behavior is unchanged.
"""

from __future__ import annotations

from . import metrics, trace
from .metrics import HIST_BOUNDS, Counter, Gauge, Histogram, Registry

_REGISTRY = Registry(enabled=False)


def registry() -> Registry:
    return _REGISTRY


def enable(clock=None, ring: int | None = None) -> None:
    """Turn on instruments and span tracing process-wide.  ``clock`` routes
    span timestamps through an injected time source; ``ring`` bounds the
    span buffer."""
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


def snapshot() -> dict:
    return _REGISTRY.snapshot()


__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "HIST_BOUNDS", "metrics",
    "trace", "registry", "enable", "disable", "counter",
    "gauge", "histogram", "snapshot",
]
