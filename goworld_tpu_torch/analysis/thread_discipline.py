"""thread-discipline: background-thread writes need a sync primitive.

The port's copy of the JAX package's rule.  The engine's threading model is the reference's goroutine discipline
by convention: recv threads only enqueue, one logic thread drains, and
the long-lived background workers -- the checkpoint writer
(engine/checkpoint.py), the dispatcher reconnect/backoff threads
(dispatchercluster.py), the connection auto-flush loop
(proto/connection.py) -- publish through queues, Events and Locks.
Nothing ENFORCES that: a new `self.stats_last_write = time.time()`
inside a writer loop, read from the tick path, is a data race no test
catches on CPython and no type checker sees.

This rule classifies every ``threading.Thread(target=...)`` /
``Timer`` entry point (a ``self._run``-style method, or a local
closure def), walks the shared ProjectIndex call graph to close the
set of background functions, partitions each class's ``self.X``
writes/reads by thread, and flags attributes that are written from a
background function and read from a foreground (tick-path) method
when NEITHER side's function references a sync primitive attribute --
one initialized from ``threading.Lock/RLock/Event/Condition/
Semaphore`` or ``queue.Queue`` kin.  Referencing the primitive is the
convention being checked: a writer that holds ``self._lock`` or
pulses ``self._state_change``, or a reader that drains ``self._q``,
is following the house pattern; a pair that touches no primitive at
all is the finding.

``__init__`` writes are construction-time (pre-spawn) and never
background; the attribute holding the Thread object itself is
foreground bookkeeping.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, call_name
from .index import reachable_methods

RULE = "thread-discipline"

_SYNC_TYPES = {"Lock", "RLock", "Event", "Condition", "Semaphore",
               "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue",
               "LifoQueue", "PriorityQueue"}


def _enclosing_class(sf, node):
    cur = sf.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = sf.parents.get(cur)
    return None


def _enclosing_def(sf, node):
    cur = sf.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = sf.parents.get(cur)
    return None


def _sync_attrs(ci) -> set[str]:
    """Attrs assigned a threading/queue primitive anywhere in the class."""
    out = set()
    for attr, sites in ci.attr_writes.items():
        for _fn, node in sites:
            parent = ci.sf.parents.get(node)
            if isinstance(parent, ast.Assign) \
                    and isinstance(parent.value, ast.Call) \
                    and call_name(parent.value).rsplit(".", 1)[-1] \
                    in _SYNC_TYPES:
                out.add(attr)
    return out


def check(ctx: Context):
    index = ctx.index
    # class -> [(entry fn node, entry label, spawn line)]
    entries: dict[tuple[str, str], list] = {}
    for spawn in index.thread_spawns:
        cls = _enclosing_class(spawn.sf, spawn.node)
        if cls is None:
            continue
        target = spawn.target
        entry = None
        label = ""
        if isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            hit = index.resolve_method(spawn.sf.rel, cls.name, target.attr)
            if hit is not None:
                entry, label = hit[0], f"self.{target.attr}"
        elif isinstance(target, ast.Name):
            outer = _enclosing_def(spawn.sf, spawn.node)
            if outer is not None:
                entry = next(
                    (n for n in ast.walk(outer)
                     if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                     and n.name == target.id), None)
                label = f"{target.id}() in {outer.name}"
        if entry is not None:
            entries.setdefault((spawn.sf.rel, cls.name), []).append(
                (entry, label, spawn.node.lineno, spawn.sf))

    for (rel, cls_name), spawns in entries.items():
        ci = index.classes_by_rel.get(rel, {}).get(cls_name)
        if ci is None:
            continue
        sync = _sync_attrs(ci)
        background: dict = {}  # fn node -> (entry label, spawn line)
        for entry, label, line, esf in spawns:
            for fn in reachable_methods(index, rel, cls_name, entry, esf):
                background.setdefault(fn, (label, line))
        # fn -> attrs it touches (either direction), for the guard check
        touches: dict = {}
        for table in (ci.attr_writes, ci.attr_reads):
            for attr, sites in table.items():
                for fn, _node in sites:
                    touches.setdefault(fn, set()).add(attr)

        def _guarded(fn) -> bool:
            return bool(touches.get(fn, set()) & sync)

        for attr, writes in sorted(ci.attr_writes.items()):
            if attr in sync:
                continue
            bg_writes = [(fn, node) for fn, node in writes
                         if fn in background and fn.name != "__init__"]
            if not bg_writes:
                continue
            fg_reads = [
                (fn, node) for fn, node in ci.attr_reads.get(attr, [])
                if fn is not None and fn not in background
                and fn.name != "__init__"]
            if not fg_reads:
                continue
            for wfn, wnode in bg_writes:
                if _guarded(wfn):
                    continue
                bad = next((r for r in fg_reads if not _guarded(r[0])), None)
                if bad is None:
                    continue
                label, line = background[wfn]
                yield Finding(
                    RULE, rel, wnode.lineno, wnode.col_offset,
                    f"self.{attr} is written here on the background thread "
                    f"spawned at line {line} (target {label}) and read from "
                    f"{bad[0].name}() on the foreground path, with no "
                    "lock/queue/event referenced on either side -- guard "
                    "both sides with a primitive or hand the value over "
                    "through a queue/Event")
                break  # one finding per attr is enough signal
