"""oracle-parity: every interest policy carries a CPU oracle and a test.

The port's copy of the JAX package's rule.  The interest-policy
subsystem (goworld_tpu_torch/interest/) makes one promise
the whole PR hangs on: the fused device step is bit-exact against a
composed CPU oracle.  That promise decomposes per policy -- each
registered :class:`InterestPolicy` declares its own numpy ``oracle``
(the reference for its mask) and the parity suite exercises it.  Three
ways it rots:

* a policy is registered (``@register`` / an ``InterestPolicy``
  subclass with a registry ``name``) but declares no ``oracle`` in its
  class body -- the stack's demotion target and the parity suite both
  lose their reference, and the device semantics become self-defining;
* a ``@register``-decorated class carries no class-level ``name``
  constant -- the registry key is the name, so registration can only
  fail at import time; the lint catches it before the import does;
* a policy class is never referenced from tests/ -- its oracle parity
  is unverified, so a device-side regression in that policy's mask
  ships silently (the same rot class gate-coverage and
  fault-seam-coverage exist for, specialised to interest policies).

Scope: files under an ``interest/`` directory.  The ``InterestPolicy``
base class itself is exempt (its ``oracle`` is the NotImplementedError
guard); "tested" is a word-boundary match over the port's tests
(ctx.tests_reference), same as the sibling coverage rules.
"""

from __future__ import annotations

import ast

from .core import Context, Finding

RULE = "oracle-parity"

_BASE = "InterestPolicy"


def _decorated_register(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        node = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(node, ast.Name) and node.id == "register":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "register":
            return True
    return False


def _inherits_policy(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        if isinstance(base, ast.Name) and base.id == _BASE:
            return True
        if isinstance(base, ast.Attribute) and base.attr == _BASE:
            return True
    return False


def _class_name_const(cls: ast.ClassDef) -> str | None:
    """The class-level ``name = "..."`` registry key, if present."""
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == "name" \
                        and isinstance(stmt.value, ast.Constant) \
                        and isinstance(stmt.value.value, str):
                    return stmt.value.value
    return None


def _defines_oracle(cls: ast.ClassDef) -> bool:
    return any(isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
               and stmt.name == "oracle" for stmt in cls.body)


def check(ctx: Context):
    for sf in ctx.files_matching("interest/"):
        if sf.rel.startswith("tests/"):
            continue
        for node in sf.nodes:
            if not isinstance(node, ast.ClassDef) or node.name == _BASE:
                continue
            registered = _decorated_register(node)
            if not (registered or _inherits_policy(node)):
                continue
            if sf.allowed(RULE, node.lineno):
                continue
            key = _class_name_const(node)
            if registered and not key:
                yield Finding(
                    RULE, sf.rel, node.lineno, node.col_offset,
                    f"@register-ed policy {node.name} has no class-level "
                    "name constant: the registry key is the name, so this "
                    "registration can only fail at import time",
                    symbol=node.name)
            if not registered and key:
                yield Finding(
                    RULE, sf.rel, node.lineno, node.col_offset,
                    f"interest policy {node.name} (name={key!r}) is never "
                    "@register-ed: PolicyStack rejects unregistered "
                    "policies, so this class is dead as a policy",
                    symbol=node.name)
            if not _defines_oracle(node):
                yield Finding(
                    RULE, sf.rel, node.lineno, node.col_offset,
                    f"interest policy {node.name} declares no CPU oracle "
                    "in its class body: the device step's bit-exactness "
                    "reference (and the demotion path's fallback "
                    "semantics) is missing",
                    symbol=node.name)
            if ctx.tests_dir is not None \
                    and not ctx.tests_reference(node.name):
                yield Finding(
                    RULE, sf.rel, node.lineno, node.col_offset,
                    f"interest policy {node.name} is never referenced "
                    "from tests/: its oracle parity is unverified, so a "
                    "device-side mask regression ships silently",
                    symbol=node.name)
