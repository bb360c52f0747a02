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

The catalog: every span and metric name the port's code emits (the
``telemetry`` gwlint rule holds the code to this table; counters of a
bucket's ``stats`` not named here are exported as ``aoi.<stat>``).

=============================  =========  ================================
name                           kind       what it measures
=============================  =========  ================================
``tick.seconds``               histogram  whole-tick wall time
``tick.aoi``                   span       the AOI flush of a tick
``tick.timers``                span       timers fired by a tick
``tick.sync``                  span       position syncs of a tick
``tick.post``                  span       post callbacks of a tick
``aoi.flush``                  span       one engine flush
``aoi.dispatch``               span       every bucket's dispatch
``aoi.harvest``                span       every bucket's harvest
``aoi.stage``                  span       a sharded tick's staging
``aoi.kernel``                 span       a step's launch (and the host
                                          calculator's step)
``aoi.fused``                  span       a sharded bucket's fused replay
``aoi.emit``                   span       the native fan-out and publish
``aoi.interest``               span       the interest stacks' steps
``aoi.ingest``                 span       one batched movement ingest
``aoi.evacuate``               span       a lost device's evacuation
``aoi.migrate``                span       one live migration
``aoi.migrate.snapshot``       span       a migration's export
``aoi.migrate.replay``         span       a migration's import
``aoi.migrate.cover``          span       a double-cover flush
``aoi.migrate.swap``           span       a migration's swap
``aoi.cohort.join``            span       a space joining a cohort
``aoi.cohort.leave``           span       a space leaving a cohort
``aoi.cohort.demote``          span       a cohort's demotion
``aoi.buckets``                gauge      live AOI buckets of an engine
``aoi.cohorts``                gauge      live cohort buckets
``aoi.cohort_spaces``          gauge      spaces stacked into cohorts
``aoi.calc_level``             gauge      worst calculator fallback level
                                          (0 kernel, 1 plain, 2 host)
``aoi.emit_path``              gauge      worst emit-path fallback level
``aoi.page_occupancy``         gauge      fullest page pool at harvest
``aoi.ingest_bytes``           counter    wire bytes the ingest decoded
``aoi.ingest_batched_frac``    gauge      share of the last ingest batch
                                          landed by columnar writes
``interest.steps``             counter    policy-stack evaluations
``interest.full_evals``        counter    full-cadence evaluations
``interest.los_pair_evals``    counter    line-of-sight samples evaluated
``interest.host_steps``        counter    steps redone on the host oracle
``interest.demotions``         counter    sticky stack demotions
``ops.dispatches``             counter    device dispatches
                                          (``ops/dispatch_count``)
``ops.kernel_launches``        counter    hand-kernel launches
                                          (``ops/aoi_cuda.launches``)
``faults.active``              gauge      1 while a fault plan is set
``faults.fired``               counter    injected faults taken
``faults.occurrences``         counter    seam crossings
``ckpt.snapshot``              span       a checkpoint capture's export
``ckpt.delta``                 span       a capture's dirty diff
``ckpt.flush``                 span       the writer's drain
``ckpt.restore``               span       one space's restore
``ckpt.records``               counter    journal records written
``ckpt.bytes``                 counter    journal bytes written
``ckpt.epochs``                counter    epochs whose manifest landed
``ckpt.torn``                  counter    torn records found at restore
``ckpt.retries``               counter    ``store.*`` operations retried
``ckpt.backlog``               gauge      captures queued to the writer
``ckpt.lag_ticks``             gauge      worst enqueued-minus-durable
                                          tick gap
``conn.flush``                 op         a connection's flush
``disp.route``                 op         the dispatcher routing a packet
``disp.connected``             gauge      1 while the dispatcher link is
                                          up
``disp.attempts``              gauge      failed reconnect attempts
``disp.backoff_s``             gauge      current reconnect backoff
``disp.next_retry_in``         gauge      seconds to the next reconnect
``disp.pending``               gauge      payloads buffered for replay
``disp.dropped``               counter    payloads dropped on overflow
``disp.replayed``              counter    payloads replayed on reconnect
``clu.failover``               span       one host failover
``clu.failovers``              counter    failovers orchestrated
``clu.fenced_packets``         counter    stale-epoch packets dropped
``clu.leases``                 counter    lease renewals accepted
``clu.replayed_moves``         counter    movement batches replayed
``clu.metric_sources``         gauge      components whose metrics the
                                          dispatcher federates
``game.outbox``                op         a game's client outbox drain
``gate.client_pkt``            op         a gate handling a client packet
``storage.op``                 op         an entity-storage operation
                                          (``utils/opmon``)
``opmon.count``                counter    operations timed, per name
``opmon.total_seconds``        counter    their total seconds
``opmon.peak_seconds``         gauge      their slowest
``opmon.p50_seconds``          gauge      their median
``opmon.p99_seconds``          gauge      their 99th percentile
``load.clients``               gauge      clients of the load harness
``load.moves``                 counter    movement records it pushed
=============================  =========  ================================
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
