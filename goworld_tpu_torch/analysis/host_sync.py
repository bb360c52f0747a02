"""host-sync: no hidden device->host synchronization on per-tick paths.

The port's copy of the JAX package's rule, with torch's sync taxonomy.
A stray ``.item()`` / ``.cpu()`` / ``torch.cuda.synchronize()`` inside
the per-tick device path stalls the dispatch pipeline for a full D2H
round trip: the host waits for every kernel queued before it.
Intentional drain points -- the ONE place per tick where results are
harvested -- are annotated ``# gwlint: allow[host-sync]`` on the ``def``
line; host-side oracle modules are grandfathered in the port's
``suppressions.txt``.

What counts as a sync (one taxonomy, shared with flush-phase and
fused-dispatch through :func:`.index.sync_msg`):

* ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` (a device
  value's fetch; statically every receiver counts);
* ``torch.cuda.synchronize()``, ``Event.synchronize()`` and
  ``Stream.synchronize()`` (any ``.synchronize()``);
* ``torch.nonzero`` / ``Tensor.nonzero`` without ``size=`` (the output
  length is data, so the host waits for it);
* ``bool()`` / ``int()`` / ``float()`` of a non-constant (a tensor's
  scalar fetch);
* ``np.asarray`` of a tensor (a blocking D2H copy).

Scope: the per-tick device modules (engine/aoi*.py, ops/).
"""

from __future__ import annotations

import ast

from .core import Context, Finding

RULE = "host-sync"

SCOPE = ("engine/aoi.py", "engine/aoi_mesh.py", "engine/aoi_rowshard.py",
         "engine/aoi_cohort.py", "ops/")

# attribute calls that fetch a device value to the host, or wait for it
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# dotted calls that force a sync / D2H copy
_SYNC_CALLS = {
    "np.asarray": "np.asarray on a device value is a blocking D2H fetch",
    "numpy.asarray": "numpy.asarray on a device value is a blocking D2H "
                     "fetch",
    "torch.cuda.synchronize": "torch.cuda.synchronize waits for the device",
}


def check(ctx: Context):
    from .index import sync_msg  # index reads this module's tables

    for sf in ctx.files_matching(*SCOPE):
        for node in sf.nodes:
            if not isinstance(node, ast.Call):
                continue
            msg = sync_msg(node)
            if msg is None:
                continue
            yield Finding(
                RULE, sf.rel, node.lineno, node.col_offset,
                msg + " inside a per-tick module; move it off the hot path "
                      "or mark the drain point with "
                      "'# gwlint: allow[host-sync] -- <why>'")
