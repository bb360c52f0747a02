"""h2d-staging: full host-array uploads must ride the delta-staging seam.

The port's copy of the JAX package's rule, with torch's uploads.  The
tick inputs (x/z/r/act/sub host shadows, ``self._h*``) are
device-resident between flushes; a steady tick ships only a sparse
update packet (``ops/aoi_stage.py``).  That contract dies silently if a
``flush()`` grows a direct ``AS.h2d(self._hx, dev)`` /
``torch.from_numpy(self._hz).to(dev)``: the full O(S*C) upload returns
every tick, nothing crashes, and the delta machinery measures as a
no-op.  Every full-array staged-input H2D lives in the ``_h2d`` /
``_stage_inputs`` / ``_stage_xz`` seam so this is auditable in one
place; this rule keeps it there.

An upload is ``torch.as_tensor`` / ``torch.tensor`` / ``AS.h2d`` (or
bare ``h2d``) / ``*.device_put`` of an array, or ``.to(device)`` /
``.cuda()`` of one (``.to(dtype)`` is a cast, not an upload).

Flagged: inside any function named ``flush`` or ``dispatch`` (or a
``_flush*`` / ``_dispatch*`` helper), an upload whose array is a host
shadow -- a ``self._h*`` attribute, a slice/index of one, or a local
name assigned from one.  Intentional sites take
``# gwlint: allow[h2d-staging]`` with a reason.

The batched ingest (goworld_tpu_torch/ingest/) is held to a stricter
line: it is the wire->COLUMN half of the path and must stay entirely
host-side -- its columns reach the device only through the
delta-staging seam at the next flush.  ANY upload call there is a
finding.

The fused tick (ops/fused.py) is held to the same line from the other
side: a captured graph reads its inputs at fixed addresses, so its
packet and row masks are written INTO static buffers (``copy_`` from
pinned staging, or an upload with ``out=``); any other upload there
makes a fresh tensor no graph reads, and the one-replay steady tick
quietly grows a second transfer.  The ``*_fused*`` bucket methods are
already covered by the flush/dispatch name filter (``_dispatch_fused``
matches ``_dispatch*``).

Scope: the bucket modules (engine/aoi.py, engine/aoi_mesh.py,
engine/aoi_rowshard.py, engine/aoi_cohort.py) for the flush/dispatch
shadow rule; ingest/ and ops/fused.py for the no-upload rules.
"""

from __future__ import annotations

import ast

from .core import Context, Finding, call_name, dotted

RULE = "h2d-staging"

SCOPE = ("engine/aoi.py", "engine/aoi_mesh.py", "engine/aoi_rowshard.py",
         "engine/aoi_cohort.py")
INGEST_SCOPE = ("ingest/",)
FUSED_SCOPE = ("ops/fused.py",)

# function-style uploads: the array is the first argument
_UPLOAD_NAMES = {"torch.as_tensor", "torch.tensor", "AS.h2d", "h2d",
                 "aoi_stage.h2d"}
# host-array wrappers an upload's array may sit in
_WRAPPERS = {"torch.from_numpy", "torch.as_tensor", "torch.tensor"}


def _is_shadow(node: ast.AST, shadow_locals: set[str]) -> bool:
    """True for ``self._h<x>``, any slice/index of it, or a local bound to
    one (``hx = self._hx; AS.h2d(hx, dev)``)."""
    if isinstance(node, ast.Subscript):
        return _is_shadow(node.value, shadow_locals)
    if isinstance(node, ast.Attribute):
        return node.attr.startswith("_h") and not node.attr.startswith(
            "_h2d")
    if isinstance(node, ast.Name):
        return node.id in shadow_locals
    return False


def _is_device(node: ast.AST) -> bool:
    """An argument of ``.to(...)`` that names a device, not a dtype (a
    ``torch.<dtype>`` attribute)."""
    return not (isinstance(node, ast.Attribute)
                and dotted(node).startswith("torch."))


def _upload_array(node: ast.Call):
    """The array an upload call ships (unwrapped from ``torch.from_numpy``
    and kin), or None when the call is not an upload."""
    name = call_name(node)
    if name in _UPLOAD_NAMES or (isinstance(node.func, ast.Attribute)
                                 and node.func.attr == "device_put"):
        arr = node.args[0] if node.args else None
    elif isinstance(node.func, ast.Attribute) and (
            node.func.attr == "cuda"
            or (node.func.attr == "to"
                and (any(kw.arg == "device" for kw in node.keywords)
                     or (node.args and _is_device(node.args[0]))))):
        arr = node.func.value
    else:
        return None
    while isinstance(arr, ast.Call) and call_name(arr) in _WRAPPERS \
            and arr.args:
        arr = arr.args[0]
    return arr if arr is not None else node


def _is_upload(node: ast.Call) -> bool:
    return _upload_array(node) is not None


def _in_place(node: ast.Call) -> bool:
    """An upload into an existing tensor (``out=``)."""
    return any(kw.arg == "out" for kw in node.keywords)


def check(ctx: Context):
    # ingest/ must stay host-side: ANY upload there bypasses the staging
    # seam (position data reaches the device only via ops/aoi_stage's
    # sparse packets at the next flush)
    for sf in ctx.files_matching(*INGEST_SCOPE):
        for node in sf.nodes:
            if not (isinstance(node, ast.Call) and _is_upload(node)):
                continue
            yield Finding(
                RULE, sf.rel, node.lineno, node.col_offset,
                "device upload inside the ingest module: the batched "
                "ingest is wire->column only -- position data reaches "
                "the device through the delta-staging seam "
                "(ops/aoi_stage) at the next flush, never at decode "
                "time; move the upload or mark the line "
                "'# gwlint: allow[h2d-staging] -- <why>'")
    # the fused tick: a graph reads its inputs at fixed addresses -- an
    # upload that makes a fresh tensor is a transfer no replay reads
    for sf in ctx.files_matching(*FUSED_SCOPE):
        for node in sf.nodes:
            if not (isinstance(node, ast.Call) and _is_upload(node)) \
                    or _in_place(node):
                continue
            yield Finding(
                RULE, sf.rel, node.lineno, node.col_offset,
                "device upload into a fresh tensor inside the fused tick: "
                "a captured graph reads its packet and masks from static "
                "buffers (ops/fused.py docstring), so write into them "
                "(copy_ from pinned staging, or out=) or mark the line "
                "'# gwlint: allow[h2d-staging] -- <why>'")
    for sf in ctx.files_matching(*SCOPE):
        for fn in sf.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or not (fn.name in ("flush", "dispatch")
                            or fn.name.startswith("_flush")
                            or fn.name.startswith("_dispatch")):
                continue
            # local names rebound from a shadow array count as shadows too
            shadow_locals: set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and _is_shadow(node.value, shadow_locals):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            shadow_locals.add(tgt.id)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                arr = _upload_array(node)
                if arr is None or not _is_shadow(arr, shadow_locals):
                    continue
                yield Finding(
                    RULE, sf.rel, node.lineno, node.col_offset,
                    "full host-array upload inside flush() bypasses the "
                    "_h2d/delta staging seam (every tick pays O(S*C) H2D "
                    "and the sparse-packet path silently degrades to a "
                    "no-op); route it through _h2d()/_stage_inputs()/"
                    "_stage_xz() or mark the line "
                    "'# gwlint: allow[h2d-staging] -- <why>'")
