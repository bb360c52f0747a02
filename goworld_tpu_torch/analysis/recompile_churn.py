"""recompile-churn: work a tick rebuilds that should have been built once.

The port's counterpart of the JAX package's rule, under the same name.
There the hazard is an XLA retrace; the port compiles nothing through
XLA at run time, and what it builds per key instead is a captured
``torch.cuda.CUDAGraph`` (ops/fused.py: one per bucket shape, packet
length, parity, output size and codec caps, under
``ops/fused.capture_key``) and a kernel library loaded by ops/_build (a
``ctypes.CDLL`` per source).  Three hazards, all silent -- nothing
crashes, the tick just pays a capture or a load again:

* construction with no memoization: a ``torch.cuda.CUDAGraph``, a
  ``ctypes.CDLL`` / ``LoadLibrary`` or a ``torch.compile`` built inside a
  function with no evidence it is kept -- bound to a ``global``-declared
  name, a ``self.X`` attribute or a keyed subscript
  (``self.graphs[key] = g``, ``_libs[name] = lib``), returned to the
  caller, or handed to a helper -- is rebuilt on every call;
* a high-cardinality value in a capture key: an argument of
  ``capture_key(...)`` / ``record_key(...)`` naming a per-tick or
  per-entity value (tick, seed, epoch, time, an entity or client id, a
  count) makes one graph per distinct value;
* a cache that grows without bound: a subscript store into a graph or
  cache dict whose key expression names such a value.

Scope: the whole scanned tree.
"""

from __future__ import annotations

import ast
import re

from .core import Context, Finding, SourceFile, call_name, dotted

RULE = "recompile-churn"

_HIGH_CARD_RE = re.compile(
    r"(?:^|_)(tick|seed|frame|epoch|time|eid|uid)(?:$|_)"
    r"|count|n_entit|entity_id|client_id|space_id")
_KEY_CALLS = {"capture_key", "record_key"}
_CACHE_RE = re.compile(r"graph|cache", re.IGNORECASE)


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _params(fn) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def _enclosing_defs(sf: SourceFile, node: ast.AST) -> list:
    """Innermost-first chain of defs containing ``node``."""
    out = []
    cur = sf.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(cur)
        cur = sf.parents.get(cur)
    return out


def _assigned_names(fn) -> set[str]:
    out = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


def _jit_aliases_and_escape(outer, sites: list[ast.AST]) -> tuple[set, bool]:
    """Names in ``outer`` bound (transitively) to a construction from
    ``sites``, and whether any such value escapes into a global-declared
    name, attribute, or subscript, is returned, or is handed to a call
    -- the memoization evidence."""
    declared = set()
    for n in ast.walk(outer):
        if isinstance(n, (ast.Global, ast.Nonlocal)):
            declared.update(n.names)
    aliases = {d.name for d in sites
               if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))}
    calls = [s for s in sites if isinstance(s, ast.Call)]

    def _is_jit_value(expr) -> bool:
        return expr in calls or (
            isinstance(expr, ast.Name) and expr.id in aliases)

    escaped = False
    for _ in range(3):  # tiny fixpoint: alias chains are 1-2 hops deep
        changed = False
        for n in ast.walk(outer):
            if isinstance(n, ast.Return) and n.value is not None \
                    and _is_jit_value(n.value):
                # a factory returning the built object hands memoization
                # to the caller
                escaped = True
            elif isinstance(n, ast.Assign) and _is_jit_value(n.value):
                for t in n.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        escaped = True
                    elif isinstance(t, ast.Name):
                        if t.id in declared:
                            escaped = True
                        elif t.id not in aliases:
                            aliases.add(t.id)
                            changed = True
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, (ast.Attribute, ast.Name)):
                # cache.setdefault(key, g) / a registrar helper(key, g):
                # handing the built object to a container or helper counts
                # as memoized.  Only ARGUMENT position counts
                if any(_is_jit_value(a) for a in n.args) \
                        or any(_is_jit_value(kw.value) for kw in n.keywords):
                    escaped = True
        if not changed:
            break
    return aliases, escaped


def _idents(node: ast.AST) -> list[str]:
    """The identifiers (names and attribute terminals) under ``node``."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
    return out


def _high_card(node: ast.AST) -> list[str]:
    return sorted({i for i in _idents(node) if _HIGH_CARD_RE.search(i)})


def check(ctx: Context):
    index = ctx.index
    # -- construction inside a function without memoization -----------------
    by_outer: dict[tuple, list] = {}  # (sf, outermost def) -> sites
    for site in index.jit_sites:
        chain = _enclosing_defs(site.sf, site.node)
        if not chain:
            continue  # module level: built once at import
        by_outer.setdefault((site.sf, chain[-1]), []).append(site.node)
    for (sf, outer), sites in by_outer.items():
        _aliases, escaped = _jit_aliases_and_escape(outer, sites)
        if escaped:
            continue
        for site in sites:
            in_loop = False
            cur = sf.parents.get(site)
            while cur is not None and cur is not outer:
                if isinstance(cur, (ast.For, ast.While)):
                    in_loop = True
                cur = sf.parents.get(cur)
            where = "a loop in " if in_loop else ""
            what = call_name(site) or _last(dotted(site.func))
            yield Finding(
                RULE, sf.rel, site.lineno, site.col_offset,
                f"{what} built inside {where}{outer.name}() with no "
                "memoization: every call captures or loads it again; keep "
                "it in a global/attribute/keyed cache, or return it")

    for sf in ctx.files:
        for node in sf.nodes:
            # -- capture keys from per-tick / per-entity values -------------
            if isinstance(node, ast.Call) \
                    and _last(call_name(node)) in _KEY_CALLS:
                for name in _high_card(ast.Tuple(
                        elts=list(node.args) + [kw.value
                                                for kw in node.keywords],
                        ctx=ast.Load())):
                    yield Finding(
                        RULE, sf.rel, node.lineno, node.col_offset,
                        f"capture key built from '{name}', a per-tick or "
                        "per-entity value: every distinct value captures a "
                        "new graph; key on shapes, lengths and caps only")
            # -- graph/cache dicts keyed by such values ---------------------
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    # an object's (or module's) cache outlives the call;
                    # a local memo dict dies with it
                    if not (isinstance(tgt, ast.Subscript)
                            and isinstance(tgt.value, ast.Attribute)
                            and _CACHE_RE.search(tgt.value.attr)):
                        continue
                    for name in _high_card(tgt.slice):
                        yield Finding(
                            RULE, sf.rel, node.lineno, node.col_offset,
                            f"{dotted(tgt.value)} keyed by '{name}', a "
                            "per-tick or per-entity value: the cache grows "
                            "without bound; key it on low-cardinality "
                            "values")
