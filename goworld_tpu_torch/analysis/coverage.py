"""gate-coverage: auto-enabled paths must be reachable from tests.

The port's copy of the JAX package's rule.  The ``exc_select='hier'``
bug class: a codec or kernel path that switches itself on past a size
threshold -- or behind an env / config flag -- ships to production the
first time anything crosses the threshold, which is exactly when no
test has ever run it.  The checker finds the gates and demands the
gating symbol appear somewhere in the port's tests:

* mode-string ternaries gated on a size comparison
  (``"hier" if n > (1 << 20) else "flat"``): both branch strings must be
  referenced from tests -- a test that names the mode exercises it;
* ``os.environ.get("X")`` / ``os.getenv("X")`` in package code: the env
  var name must appear in tests.

Reference is textual (word-boundary match over the port's tests,
``tests/test_torch_*.py``): gwlint wants
"a test knows this symbol exists", not full reachability analysis.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, call_name, const_int

RULE = "gate-coverage"

# a comparison constant this large is a "size threshold", not program logic
_SIZE_THRESHOLD = 256


def _threshold_gated(test: ast.AST) -> int | None:
    """Largest int constant >= _SIZE_THRESHOLD compared against in ``test``."""
    best = None
    for node in ast.walk(test):
        if isinstance(node, ast.Compare):
            for comp in [node.left, *node.comparators]:
                v = const_int(comp)
                if v is not None and v >= _SIZE_THRESHOLD:
                    best = v if best is None or v > best else best
    return best


def check(ctx: Context):
    if ctx.tests_dir is None:
        return
    for sf in ctx.files:
        for node in sf.nodes:
            if isinstance(node, ast.IfExp):
                thr = _threshold_gated(node.test)
                if thr is None:
                    continue
                for branch in (node.body, node.orelse):
                    if isinstance(branch, ast.Constant) \
                            and isinstance(branch.value, str) \
                            and len(branch.value) >= 2 \
                            and not ctx.tests_reference(branch.value):
                        yield Finding(
                            RULE, sf.rel, node.lineno, node.col_offset,
                            f"mode {branch.value!r} auto-enables past size "
                            f"threshold {thr} but no test references it: an "
                            "untested codepath will switch on in production "
                            "first")
            elif isinstance(node, ast.Call):
                name = call_name(node)
                var = None
                if name in ("os.getenv",) and node.args:
                    var = node.args[0]
                elif name == "os.environ.get" and node.args:
                    var = node.args[0]
                if isinstance(var, ast.Constant) \
                        and isinstance(var.value, str) \
                        and len(var.value) >= 2 \
                        and not ctx.tests_reference(var.value):
                    yield Finding(
                        RULE, sf.rel, node.lineno, node.col_offset,
                        f"env-flag gate {var.value!r} is never referenced "
                        "from tests/: the gated branch ships untested")
