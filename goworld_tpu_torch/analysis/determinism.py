"""iter-order: no nondeterministic iteration feeding wire bytes.

The port's copy of the JAX package's rule.  The bit-exact parity contract (PAPER.md north star) extends to the host:
enter/leave callbacks replay in a deterministic order, and a wire stream
must encode identically across processes.  Two iteration orders break
that silently:

* ``set`` iteration is genuinely unordered (salted hashes): any packet
  bytes or event ordering derived from it differ per process;
* ``dict`` iteration is insertion-ordered, i.e. ordered by ACCIDENT of
  call history -- two replicas that learned the same registry in a
  different order emit different bytes for the same state.

Flagged in wire/codec modules (proto/, netutil/, ops/events.py, the
component services): ``for`` over a set (always), and ``for`` over
``.items()/.keys()/.values()`` when the loop body appends to a packet or
builds wire bytes.  ``sorted(...)`` is the sanctioned wrapper.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, call_name

RULE = "iter-order"

SCOPE = ("proto/", "netutil/", "ops/events.py", "components/")

_DICT_VIEWS = {"items", "keys", "values"}
_WIRE_CALL_MARKERS = {"for_msgtype", "pack", "encode"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return call_name(node) in ("set", "frozenset")
    return False


def _dict_view(node: ast.AST) -> str | None:
    """'items' if node is <expr>.items() (possibly via list(...)), else None."""
    if isinstance(node, ast.Call) and call_name(node) == "list" and node.args:
        return _dict_view(node.args[0])
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _DICT_VIEWS and not node.args:
        return node.func.attr
    return None


def _builds_wire_bytes(loop: ast.For) -> bool:
    for node in ast.walk(loop):
        if node is loop.iter:
            continue
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr.startswith("append_"):
                return True
            if call_name(node).rsplit(".", 1)[-1] in _WIRE_CALL_MARKERS:
                return True
    return False


def check(ctx: Context):
    for sf in ctx.files_matching(*SCOPE):
        for node in sf.nodes:
            if not isinstance(node, ast.For):
                continue
            it = node.iter
            if _is_set_expr(it):
                yield Finding(
                    RULE, sf.rel, it.lineno, it.col_offset,
                    "iterating a set in a wire/codec module: set order is "
                    "salted per process; sort it")
                continue
            view = _dict_view(it)
            if view is not None and _builds_wire_bytes(node):
                yield Finding(
                    RULE, sf.rel, it.lineno, it.col_offset,
                    f"dict .{view}() iteration feeds wire encoding: order is "
                    "insertion history, not state; wrap in sorted(...)")
