"""gwlint over the port: repo-specific static analysis for
goworld_tpu_torch.

The port's copy of the JAX package's ``analysis/``, with torch's
idiom in place of JAX's.  Run as ``python -m goworld_tpu_torch.analysis
goworld_tpu_torch/``.  Fifteen checkers, each an AST pass over a shared
per-run :class:`~.index.ProjectIndex` (stdlib-only -- no torch import
needed):

===================  =====================================================
rule                 invariant
===================  =====================================================
host-sync            no hidden D2H sync on per-tick device paths
dtype                pinned torch dtypes in ops/ code
wire                 msgtype enum + packet codecs + senders stay consistent
iter-order           no set/dict-order-dependent bytes on the wire
gate-coverage        auto-enabled branches are referenced from tests/
h2d-staging          full host-array uploads ride the _h2d/delta staging
                     seam
fault-seam-coverage  declared fault seams are checked in package code and
                     exercised from tests/
telemetry            every metric/span name is documented + tested; the
                     telemetry package never syncs the device
flush-phase          no host-sync call reachable from a bucket dispatch()
                     body (the split-phase scheduler's overlap contract)
fused-dispatch       no host-sync call reachable from the fused one-launch
                     step (its one-enqueue-per-tick contract)
bounded-caps         cap-shaped device buffers carry a counted overflow
                     fallback (no silent fixed-cap truncation)
oracle-parity        every registered InterestPolicy declares a CPU
                     oracle and is referenced from tests/
recompile-churn      CUDA graph captures and kernel-library loads are
                     memoized, and capture keys stay low-cardinality
thread-discipline    attributes written on a background thread and read
                     on the foreground path reference a lock/queue/event
msg-flow             every MT_* constant has a sender, a handler, and a
                     dispatcher route (or band pass-through)
===================  =====================================================

``RULES`` maps rule name -> checker; ``CHECKERS`` preserves the ordered
list form.  Suppressions: ``# gwlint: allow[rule] -- reason`` inline, or
an entry of ``suppressions.txt`` beside this module (:mod:`.core`).
"""

from __future__ import annotations

from . import (bounded_caps, coverage, determinism, dtypes, fault_seams,
               flush_phase, fused_dispatch, h2d_staging, host_sync,
               msg_flow, oracle_parity, recompile_churn, telemetry_rule,
               thread_discipline, wire_protocol)
from .core import Context, Finding, Suppressions, run

RULES = {
    host_sync.RULE: host_sync.check,
    dtypes.RULE: dtypes.check,
    wire_protocol.RULE: wire_protocol.check,
    determinism.RULE: determinism.check,
    coverage.RULE: coverage.check,
    h2d_staging.RULE: h2d_staging.check,
    fault_seams.RULE: fault_seams.check,
    telemetry_rule.RULE: telemetry_rule.check,
    flush_phase.RULE: flush_phase.check,
    fused_dispatch.RULE: fused_dispatch.check,
    bounded_caps.RULE: bounded_caps.check,
    oracle_parity.RULE: oracle_parity.check,
    recompile_churn.RULE: recompile_churn.check,
    thread_discipline.RULE: thread_discipline.check,
    msg_flow.RULE: msg_flow.check,
}

CHECKERS = list(RULES.values())

__all__ = ["CHECKERS", "RULES", "Context", "Finding", "Suppressions", "run"]
