"""fused-dispatch: nothing host-syncs inside the fused one-launch step.

The port's copy of the JAX package's rule.  The fused tick (ops/fused.py)
buys its one-dispatch-a-device shape by keeping the whole steady tick --
packet scatter -> the step kernel -> masks -> triple extraction, page
allocation or the shard codec -- inside one CUDA graph replay plus async
copies to pinned memory.  A single host-sync call reachable from the
fused attempt (an ``.item()`` "just to check", a ``.cpu()``, a
``torch.cuda.synchronize()``) silently re-serializes the tick: the graph
still replays, parity still holds, and the dispatch is back to paying a
blocking round trip -- exactly the overhead the fused mode exists to
delete; inside a capture it is an error on the card that no CPU test
sees.  Worse than the flush-phase failure mode, it also hides in the
A/B: the fused row keeps winning on dispatch COUNT while losing the
wall-clock it was built to reclaim.

Entry points walked (the shared ProjectIndex call graph -- index.py --
one sync taxonomy shared with host-sync and flush-phase):

* every module function of ops/fused.py and every method of its
  classes (the graph bodies, the packet upload, the replay);
* every ``*_fused*`` method of the bucket tiers (eligibility check,
  packet build, seam checks, and the enqueue around the replay).

Boundaries are explicit: ``# gwlint: allow[fused-dispatch] -- <why>`` on
the call or callee ``def`` line stops the traversal (demotion recovery
is host-side by design and lives on the unfused path anyway).

Scope: the bucket modules (engine/aoi.py, engine/aoi_mesh.py,
engine/aoi_rowshard.py, engine/aoi_cohort.py) and ops/fused.py.
"""

from __future__ import annotations

import ast

from .core import Context
from .index import fused_entries, walk_no_sync

RULE = "fused-dispatch"

SCOPE = ("engine/aoi.py", "engine/aoi_mesh.py", "engine/aoi_rowshard.py",
         "engine/aoi_cohort.py", "ops/fused.py")

_REASON = ("the fused tick is one replay a device + async copies "
           "(ops/fused.py); a host sync here re-serializes the tick the "
           "fusion exists to overlap")


_HINT = "move it out of the fused step"


def check(ctx: Context):
    index = ctx.index
    for sf in ctx.files_matching(*SCOPE):
        if sf.rel.endswith("ops/fused.py"):
            # every fused body and graph method is an entry point
            for cls, name, fn, fsf in fused_entries(index, sf):
                yield from walk_no_sync(index, RULE, _REASON, _HINT,
                                        cls, name, fn, fsf)
            continue
        for cls in sf.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            ci = index.classes_by_rel.get(sf.rel, {}).get(cls.name)
            if ci is None:
                continue
            for name, (m, msf) in ci.methods.items():
                if msf is sf and "_fused" in name:
                    yield from walk_no_sync(index, RULE, _REASON, _HINT,
                                            cls.name, name, m, msf)
