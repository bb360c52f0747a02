"""fault-seam-coverage: every declared fault seam is real and tested.

The port's copy of the JAX package's rule, over the port's catalog
(``goworld_tpu_torch/faults.py``).  The fault-injection story only holds
if the seam catalog stays honest.  Three ways it rots:

* a seam is declared in ``SEAMS`` but no test ever injects through it --
  the recovery path behind it ships untested (the exact bug class
  gate-coverage exists for, specialised to fault seams);
* production code calls ``faults.check("...")`` with a name the catalog
  does not declare -- the fault never fires (``FaultSpec.__post_init__``
  rejects unknown seams at plan-build time, so the plan cannot even name
  it) and the docstring table lies;
* a seam is declared but no production code checks it -- dead catalog;
* a bucket tier grows a recovery path (``_recover``) without the
  evacuation/migration hooks (``export_snapshot`` / ``import_snapshot`` /
  ``evacuate``) -- the chip-loss failover path (``aoi.device`` seam,
  engine/placement.py) silently cannot re-home that tier's spaces, so a
  lost device strands them despite the tier "supporting" faults.  The
  port shares its recovery and hooks through mixins and ``_Bucket``, so
  both resolve through the class's MRO; a tier is a class deriving from
  ``_Bucket``, and a hook that only raises ``NotImplementedError`` (the
  base's stub) does not count.

A catalog finding carries its seam as the symbol, so the port's
``suppressions.txt`` can grandfather one seam (``path::rule::seam``).

Mechanics mirror gate-coverage: the catalog is AST-extracted from
faults.py (the ``SEAMS = {...}`` dict's string keys), usage is every
string literal passed as the first argument to a ``*.check(...)`` /
``*.filter(...)`` call on a ``faults``-named object, and "tested" is a
word-boundary text match over the port's tests
(``tests/test_torch_*.py``).
"""

from __future__ import annotations

import ast
import os
import re

from .core import Context, Finding

RULE = "fault-seam-coverage"

# seam families that only make sense complete: declaring or using any
# member without the rest leaves part of the code path uninjectable --
# e.g. a checkpoint journal whose writes can fault but whose restore
# reads cannot is untestable durability
FAMILIES = {
    "store": ("store.write", "store.read", "store.manifest"),
    # cluster supervision (the dispatcher's leases and the host
    # failover): a lease that can stall but whose failover restore cannot
    # fault -- or a zombie probe without the kill seam -- tests only half
    # the kill-a-host story
    "clu": ("clu.lease", "clu.kill", "clu.zombie", "clu.restore"),
}


def _declared_seams(sf) -> dict[str, int]:
    """SEAMS dict string keys -> declaration line, from faults.py."""
    out: dict[str, int] = {}
    for node in sf.nodes:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "SEAMS" in targets:
                for key in node.value.keys:
                    if isinstance(key, ast.Constant) \
                            and isinstance(key.value, str):
                        out[key.value] = key.lineno
    return out


def _seam_arg(node: ast.Call) -> str | None:
    """The seam literal of a faults.check/filter call, if that's what this
    is.  Matches ``faults.check("x")``, ``faults.filter("x", v)`` and the
    plan-level ``plan.add("x", ...)`` / ``self._plan.check("x")`` spellings
    used in tests -- anything whose attr is check/filter/add with a string
    first arg counts as naming a seam."""
    if not isinstance(node.func, ast.Attribute):
        return None
    if node.func.attr not in ("check", "filter"):
        return None
    if not node.args:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


def _is_tier(index, rel: str, cls: str) -> bool:
    """``cls`` derives from ``_Bucket`` (through the index's bases)."""
    seen, queue = set(), [(cls, rel)]
    while queue:
        name, crel = queue.pop(0)
        if name == "_Bucket":
            return True
        if (name, crel) in seen:
            continue
        seen.add((name, crel))
        ci = index.resolve_class(crel, name)
        if ci is None:
            continue
        for b in ci.bases:
            if isinstance(b, ast.Name):
                queue.append((b.id, ci.sf.rel))
            elif isinstance(b, ast.Attribute):
                queue.append((b.attr, ci.sf.rel))
    return False


def _real(hit) -> bool:
    """A resolved method that does more than raise NotImplementedError."""
    if hit is None:
        return False
    body = [st for st in hit[0].body
            if not (isinstance(st, ast.Expr)
                    and isinstance(st.value, ast.Constant))]
    return not (len(body) == 1 and isinstance(body[0], ast.Raise))


def _script_usage_text(ctx: Context) -> str:
    """Repo-root scripts (bench.py, scripts/*.py) are seam users too but
    usually sit outside the linted paths; their text keeps root-level seams
    like ``bench.config`` from reading as dead catalog entries."""
    chunks = []
    lint_roots = {sf.abspath for sf in ctx.files}
    candidates = []
    try:
        for name in sorted(os.listdir(ctx.root)):
            if name.endswith(".py"):
                candidates.append(os.path.join(ctx.root, name))
    except OSError:
        pass
    scripts = os.path.join(ctx.root, "scripts")
    if os.path.isdir(scripts):
        for name in sorted(os.listdir(scripts)):
            if name.endswith(".py"):
                candidates.append(os.path.join(scripts, name))
    for p in candidates:
        if p in lint_roots:
            continue
        try:
            with open(p, encoding="utf-8") as fh:
                chunks.append(fh.read())
        except OSError:
            pass
    return "\n".join(chunks)


def check(ctx: Context):
    catalog_files = ctx.files_matching("faults.py")
    catalog_files = [sf for sf in catalog_files
                     if sf.rel.endswith("goworld_tpu_torch/faults.py")
                     or sf.rel == "faults.py"]
    if not catalog_files:
        return
    cat_sf = catalog_files[0]
    declared = _declared_seams(cat_sf)
    if not declared:
        return

    # every faults.check/filter seam literal in package code (outside the
    # catalog module itself, this linter and tests/)
    used: dict[str, tuple[str, int]] = {}
    for sf in ctx.files:
        if sf is cat_sf or sf.rel.startswith("tests/") \
                or "/analysis/" in sf.rel:
            continue
        for node in sf.nodes:
            if isinstance(node, ast.Call):
                seam = _seam_arg(node)
                if seam is None:
                    continue
                if seam not in used:
                    used[seam] = (sf.rel, node.lineno)
                if seam not in declared:
                    yield Finding(
                        RULE, sf.rel, node.lineno, node.col_offset,
                        f"fault seam {seam!r} is not declared in the "
                        "faults.SEAMS catalog: no plan can name it, so this "
                        "check never fires")

    if ctx.tests_dir is not None:
        for seam, line in sorted(declared.items()):
            if not ctx.tests_reference(seam):
                yield Finding(
                    RULE, cat_sf.rel, line, 0,
                    f"declared fault seam {seam!r} is never referenced from "
                    "tests/: the recovery path behind it ships untested",
                    symbol=seam)

    script_text = None
    for seam, line in sorted(declared.items()):
        if seam in used:
            continue
        if script_text is None:
            script_text = _script_usage_text(ctx)
        if re.search(r"""(?:check|filter)\(\s*['"]"""
                     + re.escape(seam) + r"""['"]""", script_text):
            continue
        yield Finding(
            RULE, cat_sf.rel, line, 0,
            f"declared fault seam {seam!r} is checked nowhere in package "
            "code: dead catalog entry", symbol=seam)

    # family completeness: any member of a declared family present (in
    # the catalog or at a check site) pulls in the whole family -- a
    # journal whose write seam exists but whose read/manifest seams don't
    # can only be fault-tested on half its durability path
    for fam, members in sorted(FAMILIES.items()):
        present = [m for m in members if m in declared or m in used]
        if not present:
            continue
        missing = [m for m in members if m not in declared]
        for m in missing:
            anchor = next((mm for mm in members if mm in declared), None)
            if anchor is not None:
                path, line = cat_sf.rel, declared[anchor]
            else:
                path, line = used[present[0]]
            yield Finding(
                RULE, path, line, 0,
                f"fault-seam family {fam!r} is incomplete: {m!r} is not "
                f"declared in faults.SEAMS but "
                f"{', '.join(sorted(present))} "
                "exists -- the family must be declared, tested and "
                "non-dead together")

    # bucket tiers that recover from device faults must also be
    # evacuable/migratable: the aoi.device failover path rebuilds every
    # slot through export_snapshot/import_snapshot/evacuate, so a tier
    # with _recover but without the hooks strands its spaces on chip loss
    _HOOKS = ("export_snapshot", "import_snapshot", "evacuate")
    index = ctx.index
    for sf in ctx.files:
        base = os.path.basename(sf.rel)
        if not (base == "aoi.py" or base.startswith("aoi_")) \
                or "engine" not in sf.rel or sf.rel.startswith("tests/"):
            continue
        for node in sf.nodes:
            if not isinstance(node, ast.ClassDef) \
                    or node.name == "_Bucket" \
                    or not _is_tier(index, sf.rel, node.name) \
                    or index.resolve_method(sf.rel, node.name,
                                            "_recover") is None:
                continue
            missing = [h for h in _HOOKS
                       if not _real(index.resolve_method(sf.rel, node.name,
                                                         h))]
            if missing:
                yield Finding(
                    RULE, sf.rel, node.lineno, node.col_offset,
                    f"bucket tier {node.name} defines _recover but lacks "
                    f"{', '.join(missing)}: the aoi.device chip-loss "
                    "failover cannot evacuate this tier's spaces")
