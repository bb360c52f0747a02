"""Composable per-space interest policies (port of the JAX package's
``interest/``).

The base AOI engine answers "who is inside my radius?"; a space may add
a stack of registered :class:`InterestPolicy` filters -- team/faction
visibility, tiered update rates, line-of-sight occlusion -- evaluated in
one launch of the hand kernel ``csrc/interest_step.cu`` per step on the
engine's device, bit-exact against the numpy oracle
(:mod:`.oracle`).

Entry points:

* ``Space.enable_interest(*policies)`` -- attach a stack to a space
  (after ``enable_aoi``, before entities enter);
* ``Space.set_aoi_team(entity, team, vis)`` -- the faction columns;
* ``AOIEngine.attach_interest`` / ``PolicyStack`` -- the engine seam;
* ``DistanceField.from_boxes`` -- bake static geometry for LOS.
"""

from .field import DistanceField
from .policy import (POLICIES, InterestPolicy, LineOfSightPolicy,
                     PolicyStack, StackConfig, TeamVisibilityPolicy,
                     TieredRatePolicy, register)

__all__ = [
    "DistanceField",
    "InterestPolicy",
    "LineOfSightPolicy",
    "POLICIES",
    "PolicyStack",
    "StackConfig",
    "TeamVisibilityPolicy",
    "TieredRatePolicy",
    "register",
]
