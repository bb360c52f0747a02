"""Game load reporting for least-loaded placement.

Reference role: components/game/lbc/gamelbc.go:17-39 -- each game samples its
CPU usage every second (gopsutil there) and reports it to every dispatcher,
which feeds the dispatcher's LBC min-heap used by CreateEntityAnywhere /
CreateSpaceAnywhere placement (DispatcherService.go:529-542, lbcheap.go).

Here the sample is the process CPU fraction over the sampling window,
computed from ``os.times()`` deltas -- no external dependency, and it
captures exactly what the placement heuristic needs: how busy this game's
logic process is relative to its peers.

The port's copy of the JAX package's ``components/game/lbc.py``.
"""

from __future__ import annotations

import os
import time


class LoadReporter:
    def __init__(self):
        t = os.times()
        self._cpu = t.user + t.system
        self._wall = time.monotonic()
        self.last = 0.0

    def sample(self) -> float:
        """CPU fraction (0..ncpu) of this process since the previous call."""
        t = os.times()
        cpu = t.user + t.system
        wall = time.monotonic()
        dt = wall - self._wall
        if dt > 0:
            self.last = max(0.0, (cpu - self._cpu) / dt)
        self._cpu, self._wall = cpu, wall
        return self.last
