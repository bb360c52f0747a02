"""dtype: pinned torch dtypes in ops/ code.

The port's copy of the JAX package's rule, with torch's constructors.
Two bug classes, both producing silently wrong or silently slow code
rather than errors:

* unpinned constructor dtypes (``torch.zeros(n)``, ``torch.arange(n)``):
  the default is ``torch.get_default_dtype()`` (float32 unless someone
  changed it) or int64 for ``arange``, where the kernels and the bit-
  exact parity with the JAX package expect int32 words and float32
  positions; a default that drifts changes a kernel's argument type;
* ``.astype(float)`` / ``.astype(int)`` with python builtins: resolves
  to a platform-dependent width.

torch takes ``dtype`` only by keyword in these constructors, so the
check is ``dtype=`` present.  The ``*_like`` constructors inherit their
template's dtype and are fine.

Scope: ops/ only (the kernel library and its plain versions).  Host-side
numpy oracles in ops/ are grandfathered per file in the port's
``suppressions.txt``.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, call_name

RULE = "dtype"

SCOPE = ("ops/",)

# fresh-value constructors whose dtype is a process-wide default
_CONSTRUCTORS = {"torch.zeros", "torch.ones", "torch.empty", "torch.full",
                 "torch.arange"}


def check(ctx: Context):
    for sf in ctx.files_matching(*SCOPE):
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in _CONSTRUCTORS:
                if not any(kw.arg == "dtype" for kw in node.keywords):
                    yield Finding(
                        RULE, sf.rel, node.lineno, node.col_offset,
                        f"{name}(...) without dtype=: the default is a "
                        "process-wide setting (float32, or int64 for "
                        "arange); pin it")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "astype" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Name) and arg.id in ("float", "int"):
                    yield Finding(
                        RULE, sf.rel, node.lineno, node.col_offset,
                        f".astype({arg.id}) uses a python builtin: width "
                        "is platform-dependent; use an explicit numpy "
                        "dtype")
