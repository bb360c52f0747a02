"""The scripted-client load harness (port): gate-shaped traffic at fleet
scale.

The port's copy of the JAX package's ``load/harness.py``.  One in-process
world, 10^5..10^6 scripted clients (load/clients.py),
driven through the SAME server-side path live traffic takes:

    per-gate sync batches -> MovementIngest.ingest (the batched
    wire->column front door) -> Runtime.tick (AOI flush + interest-policy
    stacks + sync phase)

The harness measures what a player would feel, per interest tier: a
client's update is "delivered" when its effects are OBSERVABLE --
near-tier clients (any NEAR pair in their stack tier row) re-evaluate
every tick, so their update closes at the end of the tick that ingested
it; far-tier clients' full re-evaluation happens only on full-cadence
steps, so their oldest pending update closes at the next full eval.
That makes far p99 honestly ~= near p99 + (period-1) ticks: the latency
cost of tiered rates is REPORTED, not hidden, next to the device work
they save (``interest.los_pair_evals`` / full_evals in the stack stats).

What this harness deliberately is NOT: a socket-level client swarm; the
gate batches are byte-identical replicas of a gate's sync coalescing
(clients.GateBatcher), so the measured path is the server-side half --
ingest decode, column land, the interest stacks' device step, event
delivery -- which is the half that scales with client count.

``device`` goes to the :class:`Runtime`: where the ``cuda`` calculator's
tensors live and where the stacks step (``"cuda"`` by default,
``"cpu"`` for the plain PyTorch versions).  ``aoi_backend`` stays the
JAX package's default, ``"cpu"`` (the base radius state on the numpy
oracle; the stacks still step on ``device``).
"""

from __future__ import annotations

import time

import numpy as np

from .. import telemetry
from ..engine.entity import Entity
from ..engine.runtime import Runtime
from ..engine.space import Space
from ..engine.vector import Vector3
from ..ingest.movement import MovementIngest
from ..interest import TieredRatePolicy
from ..netutil.packet import Packet
from .clients import GateBatcher, ScriptedFleet

_LOAD_CLIENTS = telemetry.gauge(
    "load.clients", "scripted clients in the running load harness")
_LOAD_MOVES = telemetry.counter(
    "load.moves", "movement records ingested by the load harness")


class LoadWalker(Entity):
    """The scripted client's server-side avatar: AOI member accepting
    client-originated position sync (the batched ingest land path)."""
    use_aoi = True


class LoadScene(Space):
    pass


class LoadHarness:
    """Build a world, bind a scripted fleet to it, run ticks, report
    per-tier latency percentiles.

    ``policies_for(space_index)`` may be overridden via the ``policies``
    callable to vary stacks per space; the default gives every space a
    tiered-rate stack with ``period`` (the per-tier latency split needs
    a tier policy to have tiers to split on).
    """

    def __init__(self, n_clients: int, n_spaces: int = 16,
                 n_gates: int = 4, period: int = 4,
                 aoi_backend: str = "cpu", interest_mode: str = "device",
                 aoi_dist: float = 25.0, world_half: float = 200.0,
                 seed: int = 7, policies=None, device="cuda"):
        if n_clients < n_spaces:
            raise ValueError("need at least one client per space")
        self.n_clients = int(n_clients)
        self.n_spaces = int(n_spaces)
        self.period = int(period)
        self.rt = Runtime(device=device, aoi_backend=aoi_backend,
                          aoi_interest=interest_mode)
        self.rt.entities.register(LoadWalker)
        self.rt.entities.register(LoadScene)
        self.ingest = MovementIngest(self.rt)
        self.fleet = ScriptedFleet(self.n_clients, world_half=world_half,
                                   seed=seed)
        mk = policies or (lambda i: (TieredRatePolicy(period=self.period),))
        per_space = -(-self.n_clients // self.n_spaces)  # ceil
        self.spaces = []
        self._space_clients = []  # per space: fleet indices, slot order
        eids: list[str] = []
        for s in range(self.n_spaces):
            lo = s * per_space
            hi = min(lo + per_space, self.n_clients)
            sp = self.rt.entities.create_space("LoadScene", kind=1)
            sp.enable_aoi(aoi_dist, capacity=hi - lo)
            sp.enable_interest(*mk(s))
            idx = np.arange(lo, hi)
            slots = np.empty(len(idx), np.int64)
            for j, i in enumerate(idx):
                e = self.rt.entities.create(
                    "LoadWalker", space=sp,
                    pos=Vector3(float(self.fleet.x[i]), 0.0,
                                float(self.fleet.z[i])))
                e.set_client_syncing(True)
                slots[j] = e.aoi_slot
                eids.append(e.id)
            self.spaces.append(sp)
            # slot -> fleet index (entities enter in slot order, but map
            # via the recorded slots so the attribution never drifts)
            s2c = np.full(sp._cap, -1, np.int64)
            s2c[slots] = idx
            self._space_clients.append(s2c)
        self.batcher = GateBatcher(eids, n_gates)
        _LOAD_CLIENTS.set(self.n_clients)

    def run(self, ticks: int) -> dict:
        """Drive ``ticks`` full cycles; returns the load report.

        Tip: ``ticks = m * period + 1`` ends on a full-cadence step, so
        every far-tier pending update closes inside the run."""
        n = self.n_clients
        pending = np.full(n, np.nan)
        samples = {"near": [], "far": []}
        records = 0
        t0 = time.perf_counter()
        for _ in range(int(ticks)):
            self.fleet.step()
            t_in = time.perf_counter()
            for buf in self.batcher.batches(self.fleet):
                records += self.ingest.ingest(Packet(bytearray(buf)))
                _LOAD_MOVES.inc(len(buf) // 32)
            # a client's oldest unclosed update defines its latency: only
            # clients with nothing pending start a new measurement
            fresh = np.isnan(pending)
            pending[fresh] = t_in
            self.rt.tick()
            t_done = time.perf_counter()
            for sp, s2c in zip(self.spaces, self._space_clients):
                stack = sp.interest_stack
                near_slots = stack.near_rows()
                occupied = s2c >= 0
                near_c = s2c[near_slots[: len(s2c)] & occupied]
                if stack.last_step_full:
                    close_c = s2c[occupied]  # far tier closes too
                    far_c = np.setdiff1d(close_c, near_c,
                                         assume_unique=True)
                else:
                    close_c, far_c = near_c, near_c[:0]
                for tier, idx in (("near", near_c), ("far", far_c)):
                    lat = t_done - pending[idx]
                    samples[tier].append(lat[~np.isnan(lat)])
                pending[close_c] = np.nan
        wall = time.perf_counter() - t0
        report = {"clients": n, "spaces": self.n_spaces,
                  "period": self.period, "ticks": int(ticks),
                  "records": records, "wall_s": wall,
                  "moves_per_s": records / max(wall, 1e-9),
                  "unclosed": int(np.isnan(pending).size
                                  - np.isnan(pending).sum()),
                  "ingest": dict(self.ingest.stats), "tiers": {}}
        for tier, chunks in samples.items():
            lat = (np.concatenate(chunks) if chunks
                   else np.empty(0, np.float64))
            entry = {"n": int(lat.size)}
            if lat.size:
                p50, p99 = np.percentile(lat, [50.0, 99.0])
                entry["p50_ms"] = float(p50 * 1e3)
                entry["p99_ms"] = float(p99 * 1e3)
            report["tiers"][tier] = entry
        agg: dict[str, int] = {}
        for sp in self.spaces:
            for k, v in sp.interest_stack.stats.items():
                agg[k] = agg.get(k, 0) + v
        report["interest"] = agg
        return report
