"""msg-flow: every msgtype is sent, routed, and handled -- end to end.

The port's copy of the JAX package's rule.  ``wire`` keeps the enum / codec / sender layers internally consistent;
this rule closes the loop ACROSS process kinds, the schema-compiler-
shaped safety net the hand-numbered protocol lacks.  For every ``MT_*``
constant in proto/msgtypes.py (band markers ``*_BEGIN``/``*_END``
excluded -- they bound ranges, they never ride the wire):

* a **sender** must exist: a ``Packet.for_msgtype(MT_X)`` site anywhere
  in the tree.  A constant with handlers but no sender is plumbing to
  nowhere; one with neither is a dead msgtype.
* a **handler** must exist: the constant keyed in a handler dict
  (``_HANDLERS = {MT.MT_X: _h_x}``) or compared against a received
  msgtype (``if msgtype == MT.MT_X``) somewhere.  Sent-but-unhandled
  drops packets on the floor at the receiving end.
* every constant below the gate<->client direct band (< 2000) flows
  THROUGH the dispatcher, so some dispatcher-side reference is
  required: a handler entry, a comparison, or the dispatcher itself
  being the sender.  The REDIRECT sub-band is the explicit pass-through
  (``is_redirect_to_client`` forwards by band, not by constant) and is
  exempt.

Findings anchor at the constant's definition line in msgtypes.py --
the number line is where the protocol is maintained.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, call_name
from .wire_protocol import _msgtype_constants

RULE = "msg-flow"

_MSGTYPES = "proto/msgtypes.py"
_DISPATCHER_DIR = "components/dispatcher/"


def _mt_names(node: ast.AST):
    """MT_* names referenced anywhere under ``node``."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr.startswith("MT_"):
            yield n.attr, n
        elif isinstance(n, ast.Name) and n.id.startswith("MT_"):
            yield n.id, n


def check(ctx: Context):
    mt_files = ctx.files_matching(_MSGTYPES)
    if not mt_files:
        return
    mt_sf = mt_files[0]
    constants = _msgtype_constants(mt_sf)
    values = {name: val for name, val, _ln in constants}
    redirect_lo = values.get("MT_REDIRECT_TO_CLIENT_BEGIN")
    redirect_hi = values.get("MT_REDIRECT_TO_CLIENT_END")

    senders: set[str] = set()
    consumers: set[str] = set()
    dispatcher_refs: set[str] = set()
    for sf in ctx.files:
        if sf.rel == mt_sf.rel:
            continue
        is_disp = _DISPATCHER_DIR in sf.rel
        for node in sf.nodes:
            if is_disp:
                if isinstance(node, ast.Attribute) \
                        and node.attr.startswith("MT_"):
                    dispatcher_refs.add(node.attr)
                elif isinstance(node, ast.Name) and node.id.startswith("MT_"):
                    dispatcher_refs.add(node.id)
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "for_msgtype":
                for arg in node.args:
                    for name, _n in _mt_names(arg):
                        senders.add(name)
            elif isinstance(node, ast.Dict):
                for key in node.keys:
                    if key is not None:
                        for name, _n in _mt_names(key):
                            consumers.add(name)
            elif isinstance(node, ast.Compare):
                for name, _n in _mt_names(node):
                    consumers.add(name)

    for name, val, line in constants:
        if name.endswith("_BEGIN") or name.endswith("_END"):
            continue
        sent = name in senders
        handled = name in consumers
        if not sent and not handled:
            yield Finding(
                RULE, mt_sf.rel, line, 0,
                f"{name} (id {val}) is dead: no Packet.for_msgtype() "
                "sender and no handler anywhere -- implement the flow or "
                "delete the constant (a dead id invites silent reuse)")
            continue
        if not sent:
            yield Finding(
                RULE, mt_sf.rel, line, 0,
                f"{name} (id {val}) is handled but never sent: no "
                "Packet.for_msgtype() site constructs it -- the handler "
                "is unreachable plumbing")
        if not handled:
            yield Finding(
                RULE, mt_sf.rel, line, 0,
                f"{name} (id {val}) is sent but never handled: no handler "
                "dict entry and no msgtype comparison consumes it -- "
                "receivers drop it on the floor")
        in_redirect = (redirect_lo is not None and redirect_hi is not None
                       and redirect_lo <= val <= redirect_hi)
        if val < 2000 and not in_redirect \
                and name not in dispatcher_refs and dispatcher_refs:
            yield Finding(
                RULE, mt_sf.rel, line, 0,
                f"{name} (id {val}) rides a dispatcher-routed band but "
                "the dispatcher never references it: add a _HANDLERS "
                "route, an explicit pass-through, or move it to the "
                "direct band")
