"""flush-phase: dispatch() must never block on a device value.

The port's copy of the JAX package's rule.  The split-phase flush
(``AOIEngine.flush``: every bucket's ``dispatch()``, then every
``harvest()``) only overlaps H2D, kernel launches, D2H and host decode
across AOI buckets because ``dispatch()`` is pure enqueue: every
bucket's dispatch runs before the FIRST blocking fetch, so one stray
``.item()`` / ``.cpu()`` / ``torch.cuda.synchronize()`` inside a
dispatch body serializes the whole tick back to
flush-per-bucket -- silently, with nothing crashing and the scheduler
spans still printing.  This rule walks the shared ProjectIndex call
graph (index.py) from each bucket tier's ``dispatch()`` (``self.X``
resolved through the class and its MRO -- ``_Bucket`` lives in
engine/aoi.py -- plus bare and module-alias calls through the import
table) and flags any host-sync call it can reach.

Boundaries are explicit: a call line or callee ``def`` line carrying
``# gwlint: allow[flush-phase] -- <why>`` stops the traversal there (the
idiom for the re-entrant harvest guard and the fault-recovery paths,
where the device is gone and host sync is the point).

The same walk guards the EMIT layer: harvest's
publish/fan-out helpers (``_publish*``/``_emit*`` in the bucket tiers,
plus every module function of ops/aoi_emit.py) run on already-fetched
host arrays, so a blocking device fetch reached from one re-serializes
the harvest drain the split-phase scheduler just overlapped.

The fused tick (ops/fused.py) is a third entry-point set: its module
functions and the methods of its classes are dispatch-phase code by
construction -- they run inside the bucket's fused attempt (``*_fused*``
methods, which the dispatch() walk already reaches through
``self._dispatch_fused``) -- so they get the same pure-enqueue
treatment; the dedicated fused-dispatch rule layers the fused-specific
diagnosis on top.

Scope: the bucket modules (engine/aoi.py, engine/aoi_mesh.py,
engine/aoi_rowshard.py, engine/aoi_cohort.py), the emit layer
(ops/aoi_emit.py, emit entry points only), and the fused tick
(ops/fused.py).
"""

from __future__ import annotations

import ast

from .core import Context
from .index import fused_entries, walk_no_sync

RULE = "flush-phase"

SCOPE = ("engine/aoi.py", "engine/aoi_mesh.py", "engine/aoi_rowshard.py",
         "engine/aoi_cohort.py")
# the emit layer: walked as its own entry-point set (harvest publish
# helpers must not re-enter blocking device fetches)
EMIT_SCOPE = SCOPE + ("ops/aoi_emit.py",)
# the fused tick: dispatch-phase code by construction (it runs inside
# the bucket's fused attempt), every module function and method an entry
FUSED_SCOPE = EMIT_SCOPE + ("ops/fused.py",)

_DISPATCH_REASON = ("dispatch() must be pure enqueue (the split flush's "
                    "overlap dies at the first blocking fetch)")
_EMIT_REASON = ("harvest emit helpers run on already-fetched arrays and "
                "must not re-enter a blocking device fetch")
_FUSED_REASON = ("the fused tick is dispatch-phase code -- one replay a "
                 "device, async copies after it (ops/fused.py)")

_HINT = "move it out of the walked phase"


def check(ctx: Context):
    index = ctx.index
    for sf in ctx.files_matching(*FUSED_SCOPE):
        if sf.rel.endswith("ops/fused.py"):
            # every fused body and graph method is dispatch-phase
            for cls, name, fn, fsf in fused_entries(index, sf):
                yield from walk_no_sync(index, RULE, _FUSED_REASON, _HINT,
                                        cls, name, fn, fsf)
            continue
        if sf.rel.endswith("ops/aoi_emit.py"):
            # every module function of the emit layer is an entry point
            for name, (fn, fsf) in index.mod_funcs.get(sf.rel, {}).items():
                yield from walk_no_sync(index, RULE, _EMIT_REASON, _HINT,
                                        "", name, fn, fsf)
            continue
        for cls in sf.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            ci = index.classes_by_rel.get(sf.rel, {}).get(cls.name)
            if ci is None:
                continue
            entry = ci.methods.get("dispatch")
            if entry is not None and entry[1] is sf:
                # inherited default (host-only tiers) is inline-ok
                yield from walk_no_sync(index, RULE, _DISPATCH_REASON, _HINT,
                                        cls.name, "dispatch", *entry)
            for name, m_entry in ci.methods.items():
                if m_entry[1] is sf and (name.startswith("_publish")
                                         or name.startswith("_emit")):
                    yield from walk_no_sync(index, RULE, _EMIT_REASON, _HINT,
                                            cls.name, name, *m_entry)
        # module-level emit helpers (shared across the bucket tiers)
        for name, (fn, fsf) in index.mod_funcs.get(sf.rel, {}).items():
            if name.startswith("_emit"):
                yield from walk_no_sync(index, RULE, _EMIT_REASON, _HINT,
                                        "", name, fn, fsf)
