"""telemetry: the metric/span name catalog stays honest, and the
telemetry package itself can never stall a tick.

The port's copy of the JAX package's rule.  The port's telemetry layer
(goworld_tpu_torch/telemetry) keeps its catalog of names in its own
package docstring (``goworld_tpu_torch/telemetry/__init__.py``,
:data:`CATALOG`), and makes the same promise the fault-seam catalog
makes: every name you can grep out of a dashboard exists in code, is
documented, and is pinned by a test.  Three ways it rots, mirrored from
fault-seam-coverage:

* production code names a span/metric (``trace.span("x")``,
  ``telemetry.counter("x")``, ``opmon.Operation("x")``, ``Sample("x", ...)``)
  that the catalog never lists -- it lies by omission and operators
  cannot find what a series means;
* a name is instrumented but no test references it -- renames and typos
  ship silently, and the bit-exactness parity suite loses sight of the
  instrumentation point;
* the telemetry package grows a host sync or a module-level torch import
  -- the observability layer itself would then stall the tick it
  measures (the one hard rule of the design: tracing reads clocks and
  counters only).  The allowed torch seams are lazy imports inside
  functions (the profiler bridge).

Names are AST-extracted string first-arguments; "documented" is a
word-boundary match over the catalog, "tested" the same over the port's
tests (ctx.tests_reference).

Wire-propagated telemetry headers get one extra discipline.  A struct
layout assigned to a ``*_WIRE`` name (``TRACE_WIRE =
struct.Struct(...)``) rides inside cross-process packets, so two
component builds can disagree about it mid-rolling-restart.  The rule
therefore enforces (the trace-context trailer of ``telemetry/tracectx``):

* every ``*_WIRE`` layout declares a sibling ``<NAME>_VERSION``
  constant -- the version byte is part of the contract, not garnish;
* every scope that ``.unpack``\\ s a ``*_WIRE`` layout also compares a
  version somewhere -- unknown versions must be skipped structurally
  (strip-and-ignore), never interpreted field-by-field.
"""

from __future__ import annotations

import ast
import os
import re

from .core import Context, Finding

RULE = "telemetry"

# call shapes that declare a telemetry name via their first string arg
_NAMING_ATTRS = ("span", "lap", "counter", "gauge", "histogram", "Operation")
# device/host-boundary calls that must never appear inside the telemetry
# package (they synchronize or copy -- the tick would pay for its own
# measurement)
_SYNC_ATTRS = ("item", "cpu", "numpy", "synchronize", "asarray")
# the catalog every name must appear in, relative to the repo root
CATALOG = "goworld_tpu_torch/telemetry/__init__.py"


def _telemetry_name(node: ast.Call) -> str | None:
    """The name literal of a telemetry-naming call, if that's what this is.

    Matches attribute spellings (``trace.span("x")``, ``_T.lap("x", t0)``,
    ``telemetry.counter("x")``, ``opmon.Operation("x")``) plus the bare
    ``Sample("x", ...)`` constructor collectors emit."""
    if isinstance(node.func, ast.Attribute):
        if node.func.attr not in _NAMING_ATTRS and node.func.attr != "Sample":
            return None
    elif isinstance(node.func, ast.Name):
        if node.func.id != "Sample":
            return None
    else:
        return None
    if not node.args:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


def _symbol(node: ast.AST) -> str | None:
    """Terminal identifier of a Name or Attribute (``TRACE_WIRE`` out of
    both ``TRACE_WIRE`` and ``tracectx.TRACE_WIRE``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _scope_nodes(scope: ast.AST):
    """Walk a function (or module) body without descending into nested
    function scopes -- each scope answers for its own version check."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _compares_version(scope: ast.AST) -> bool:
    """True when the scope contains a comparison whose operands touch a
    version symbol (``ver``, ``version``, ``TRACE_WIRE_VERSION``, ...)."""
    for node in _scope_nodes(scope):
        if not isinstance(node, ast.Compare):
            continue
        for op in [node.left, *node.comparators]:
            sym = _symbol(op)
            if sym and ("version" in sym.lower() or sym.lower() == "ver"):
                return True
    return False


def _wire_checks(sf):
    """Versioning discipline for wire-propagated header layouts."""
    rel = sf.rel
    consts: set[str] = set()
    wire_defs: dict[str, ast.Assign] = {}
    for stmt in sf.tree.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            continue
        name = stmt.targets[0].id
        consts.add(name)
        if name.endswith("_WIRE") and isinstance(stmt.value, ast.Call):
            func = stmt.value.func
            if (isinstance(func, ast.Attribute) and func.attr == "Struct") \
                    or (isinstance(func, ast.Name) and func.id == "Struct"):
                wire_defs[name] = stmt
    for name, stmt in sorted(wire_defs.items()):
        if name + "_VERSION" not in consts:
            yield Finding(
                RULE, rel, stmt.lineno, stmt.col_offset,
                f"wire layout {name!r} has no {name}_VERSION constant: "
                "wire-propagated header fields must carry a version so "
                "a receiver can skip layouts it does not understand")
    scopes = [sf.tree] + [n for n in ast.walk(sf.tree)
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
    for scope in scopes:
        for node in _scope_nodes(scope):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "unpack"):
                continue
            sym = _symbol(node.func.value)
            if sym is None or not sym.endswith("_WIRE"):
                continue
            if not _compares_version(scope):
                yield Finding(
                    RULE, rel, node.lineno, node.col_offset,
                    f"{sym}.unpack outside a version comparison: "
                    "interpret wire header fields only behind a version "
                    "check (strip-and-ignore unknown versions)")
            break  # one finding per scope is enough


def _doc_text(ctx: Context) -> str:
    path = os.path.join(ctx.root, *CATALOG.split("/"))
    try:
        with open(path, encoding="utf-8") as fh:
            return fh.read()
    except OSError:
        return ""


def _doc_references(docs: str, name: str) -> bool:
    # dotted-word boundary: "tick" must not ride on "tick.seconds"
    return re.search(r"(?<![\w.])" + re.escape(name) + r"(?![\w.])",
                     docs) is not None


def check(ctx: Context):
    docs = None
    seen: set[str] = set()
    for sf in ctx.files:
        rel = sf.rel
        if rel.startswith("tests/") or "/analysis/" in rel:
            continue
        yield from _wire_checks(sf)
        in_pkg = "/telemetry/" in rel or rel.startswith("telemetry/")
        if in_pkg:
            # purity: a module-level torch import drags a device runtime
            # into every importer; lazy imports inside functions are the
            # seam
            for stmt in sf.tree.body:
                if isinstance(stmt, ast.Import):
                    mods = [a.name for a in stmt.names]
                elif isinstance(stmt, ast.ImportFrom):
                    mods = [stmt.module or ""]
                else:
                    continue
                for m in mods:
                    if m == "torch" or m.startswith("torch."):
                        yield Finding(
                            RULE, rel, stmt.lineno, stmt.col_offset,
                            "module-level torch import in the telemetry "
                            "package: import it lazily inside the function "
                            "that needs it, so telemetry never drags in a "
                            "device runtime")
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            if in_pkg and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_ATTRS:
                yield Finding(
                    RULE, rel, node.lineno, node.col_offset,
                    f"host-sync call {node.func.attr!r} inside the "
                    "telemetry package: tracing must read clocks and "
                    "counters only, never synchronize the device")
            name = _telemetry_name(node)
            if name is None or name in seen:
                continue
            seen.add(name)
            if docs is None:
                docs = _doc_text(ctx)
            if not _doc_references(docs, name):
                yield Finding(
                    RULE, rel, node.lineno, node.col_offset,
                    f"telemetry name {name!r} is missing from the catalog "
                    f"({CATALOG}): it must list every name production "
                    "code can emit")
            if ctx.tests_dir is not None and not ctx.tests_reference(name):
                # a module-level instrument: the name itself is the symbol
                enc = sf.enclosing_function(node.lineno)
                yield Finding(
                    RULE, rel, node.lineno, node.col_offset,
                    f"telemetry name {name!r} is never referenced from "
                    "the port's tests: renames and typos in the "
                    "instrumentation would ship silently",
                    symbol=enc[0] if enc else name)
