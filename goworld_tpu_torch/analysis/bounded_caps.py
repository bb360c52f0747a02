"""bounded-caps: every fixed-capacity device buffer must count overflow.

The port's copy of the JAX package's rule, with torch's allocators.  The
robustness work retired a whole failure class: a device
buffer sized by a cap (``_max_triples``, ``_kcap``, ``mc`` chunk caps)
silently truncating -- or OOMing the host on growth -- when a skewed
entity distribution blows past it.  The paged layout absorbs skew, but
capped buffers legitimately remain (a captured graph and a sync-free
compaction want static shapes).  What must NEVER come back is an
*uncounted* cap: a ``torch.zeros``/``torch.full``/``torch.empty`` whose
shape derives from a
cap-like name and whose enclosing function has no counted overflow
fallback (a ``stats[...] += 1`` style counter, or spill/overflow
accounting feeding one).

A buffer that genuinely cannot overflow -- sized to the data, not to a
guess -- is annotated ``# gwlint: allow[bounded-caps] -- <why>`` like
every other rule.

Scope: the per-tick device modules (engine/aoi*.py, ops/).  The shape of
``torch.zeros``/``torch.empty`` is every positional argument (torch takes
sizes as varargs), of ``torch.full`` its first.
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, call_name, dotted

RULE = "bounded-caps"

SCOPE = ("engine/aoi.py", "engine/aoi_mesh.py", "engine/aoi_rowshard.py",
         "engine/aoi_cohort.py", "ops/")

_ALLOC = {"torch.zeros", "torch.full", "torch.empty"}
# identifiers that mark a shape as cap-derived (a sizing guess, not data)
_CAP_NAME = re.compile(r"cap|max|_tri\b|spill", re.IGNORECASE)
# evidence that the enclosing function counts the overflow instead of
# silently truncating: a stats-counter bump or spill/overflow plumbing
_FALLBACK = re.compile(r"spill|overflow|dropped|fallback", re.IGNORECASE)


def _cap_names(shape: ast.AST) -> list[str]:
    out = []
    for node in ast.walk(shape):
        ident = None
        if isinstance(node, ast.Name):
            ident = node.id
        elif isinstance(node, ast.Attribute):
            ident = node.attr
        if ident and _CAP_NAME.search(ident):
            out.append(ident)
    return out


def _has_counted_fallback(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Subscript) \
                and dotted(node.target.value).endswith("stats"):
            return True
        ident = None
        if isinstance(node, ast.Name):
            ident = node.id
        elif isinstance(node, ast.Attribute):
            ident = node.attr
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            ident = node.value
        if ident and _FALLBACK.search(ident):
            return True
    return False


def check(ctx: Context):
    for sf in ctx.files_matching(*SCOPE):
        for node in sf.nodes:
            if not isinstance(node, ast.Call) \
                    or call_name(node) not in _ALLOC or not node.args:
                continue
            shape = node.args[0] if call_name(node) == "torch.full" \
                else ast.Tuple(elts=list(node.args), ctx=ast.Load())
            for kw in node.keywords:
                if kw.arg == "size":
                    shape = kw.value
            caps = _cap_names(shape)
            if not caps:
                continue
            fn = node
            while fn in sf.parents and not isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = sf.parents[fn]
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _has_counted_fallback(fn):
                continue
            yield Finding(
                RULE, sf.rel, node.lineno, node.col_offset,
                f"device buffer shaped by cap-like '{caps[0]}' with no "
                "counted overflow fallback in the enclosing function; "
                "count the overflow (stats[...] += 1 / spill accounting) "
                "or mark '# gwlint: allow[bounded-caps] -- <why it cannot "
                "overflow>'")
