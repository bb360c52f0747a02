"""Scripted-client load harness of the port (a copy of the JAX package's
``load/``).

``LoadHarness`` binds a vectorized scripted fleet (clients.py) to an
in-process world and drives gate-shaped sync batches through the batched
ingest front door every tick, reporting client-observed e2e latency
percentiles PER INTEREST TIER next to raw moves/s.  Entry points:

* ``chip_smoke.py`` phase 18c -- the JAX package's
  ``scripts/loadgen_smoke.py`` (10^5 clients, 256 spaces) and
  ``bench.py`` ``bench_engine_load`` (8192 clients, 8 spaces)
  configurations on the card;
* ``LoadHarness(...)`` directly for custom scales.
"""

from .clients import GateBatcher, ScriptedFleet
from .harness import LoadHarness, LoadScene, LoadWalker

__all__ = ["GateBatcher", "LoadHarness", "LoadScene", "LoadWalker",
           "ScriptedFleet"]
