"""The cohort bucket tier: many spaces, one device step per tick.

Port of the JAX package's ``engine/aoi_cohort.py``.  A
:class:`.aoi._CUDABucket`'s packed state already carries a leading slot
axis (``[S, C, W]``) and its dispatch already steps every staged slot in
one launch of ``csrc/aoi_step.cu`` (fused: one graph replay), so the slot
axis IS the space-stacking axis (:mod:`..ops.aoi_cohort`).  What the
cohort tier adds is the membership contract:

* spaces of different (small) capacities share the bucket: the engine
  rounds each up to the bucket's rung of the pow2 ladder
  (``aoi_cohort.cohort_shape``) and the padded tail stays inactive, which
  the predicate ignores bit-exactly;
* the bucket is the blast radius of the ``aoi.cohort`` fault seam, probed
  at dispatch before any staging touches device or shadow state: any
  fired kind flags the bucket for demotion, and the engine rebuilds every
  member space onto a solo bucket of its own in the same flush,
  re-staging this tick's inputs, so the republish is same-tick and
  bit-exact (``AOIEngine._demote_cohort``);
* the paged free list (inherited) is bucket-wide, so a quiet member lends
  page capacity to a crowded one.

Everything else -- delta staging, the fused tick, the recovery chain,
export/import/evacuate -- is inherited from ``_CUDABucket`` unchanged.
"""

from __future__ import annotations

from .. import faults
from .aoi import _CUDABucket, _device_fault


class _CohortCUDABucket(_CUDABucket):
    """A shared ladder-shaped device bucket stacking many small spaces."""

    _kind = "AOI cohort bucket"

    def __init__(self, capacity: int, device, **kw):
        super().__init__(capacity, device, **kw)
        self.cohort = True
        # set by dispatch when the aoi.cohort seam fires; the engine's flush
        # demotes the bucket before its harvest
        self._cohort_demote = False
        self.stats["cohort_dispatches"] = 0
        self.stats["cohort_demotions"] = 0

    def dispatch(self) -> None:
        """Probe the ``aoi.cohort`` seam, then run the inherited dispatch.
        The probe comes first (as ``aoi.device`` does in the tick), so a
        firing seam leaves ``_staged`` and the host shadows untouched: the
        engine re-stages this tick's inputs onto the demotion targets and
        republishes the same tick."""
        if not self._cohort_demote:
            try:
                spec = faults.check("aoi.cohort")
            except Exception as e:
                if not (_device_fault(e)
                        or isinstance(e, ConnectionResetError)):
                    raise
                spec = e
            if spec is not None:
                # any fired kind demotes: a cohort whose shared step is
                # suspect must not tick any member on it
                self._cohort_demote = True
                self.stats["cohort_demotions"] += 1
        if self._cohort_demote:
            # park nothing: the engine tears this bucket down before the
            # harvest; a deferred tick in flight is delivered by the
            # per-slot snapshot export during the demotion
            return
        if self._staged:
            self.stats["cohort_dispatches"] += 1
        super().dispatch()
