"""Vectorized scripted clients (port copy): the synthetic half of the load
harness.

The port's copy of the JAX package's ``load/clients.py``.  The JAX
package's examples/test_client.py drives real socket clients one Bot at
a time --
the right tool for protocol conformance, hopeless for 10^5..10^6 clients
on one machine.  This module keeps the Bot's *script* (random-waypoint
walk, position sync every tick) but holds the whole fleet as flat numpy
arrays: one ``step()`` advances every client, and one ``tobytes()`` per
gate produces exactly the bytes a gate's sync coalescing would put on
the wire (components/gate: repeated ``[16B eid][x y z yaw f32]`` records
-- byte-identical to an ``ingest.SYNC_RECORD`` array).

The fleet is sharded over gates the way a real deployment stripes
clients over gate processes; the harness feeds each per-gate batch to
``MovementIngest.ingest`` -- the same front door a live gate's packets
enter through.
"""

from __future__ import annotations

import numpy as np

from ..ingest.movement import SYNC_RECORD


class ScriptedFleet:
    """``n`` scripted clients walking random waypoints in a square world.

    The script mirrors examples/test_client.py's Bot: pick a target,
    walk toward it at ``speed`` per tick, re-roll the target on arrival.
    All state is flat f32 arrays; ``step()`` is fully vectorized.
    """

    def __init__(self, n: int, world_half: float = 200.0,
                 speed: float = 3.0, seed: int = 7):
        self.n = int(n)
        self.world_half = np.float32(world_half)
        self.speed = np.float32(speed)
        self.rng = np.random.default_rng(seed)
        self.x = self.rng.uniform(-world_half, world_half, n) \
            .astype(np.float32)
        self.z = self.rng.uniform(-world_half, world_half, n) \
            .astype(np.float32)
        self.y = np.zeros(n, np.float32)
        self.yaw = np.zeros(n, np.float32)
        self._tx = self.rng.uniform(-world_half, world_half, n) \
            .astype(np.float32)
        self._tz = self.rng.uniform(-world_half, world_half, n) \
            .astype(np.float32)

    def step(self) -> None:
        """Advance every client one tick along its waypoint script."""
        dx = self._tx - self.x
        dz = self._tz - self.z
        dist = np.sqrt(dx * dx + dz * dz)
        arrived = dist <= self.speed
        n_arr = int(arrived.sum())
        if n_arr:
            wh = float(self.world_half)
            self._tx[arrived] = self.rng.uniform(-wh, wh, n_arr)
            self._tz[arrived] = self.rng.uniform(-wh, wh, n_arr)
        safe = np.maximum(dist, np.float32(1e-6))
        scale = np.where(arrived, np.float32(1.0), self.speed / safe)
        self.x = (self.x + dx * scale).astype(np.float32)
        self.z = (self.z + dz * scale).astype(np.float32)
        self.yaw = np.arctan2(dx, dz).astype(np.float32)


class GateBatcher:
    """Builds one wire batch per gate per tick, straight from fleet
    arrays.

    Clients stripe over ``n_gates`` round-robin (client i -> gate
    i % n_gates), like a front-end balancer would.  Each gate owns a
    preallocated SYNC_RECORD array with the eid column filled once;
    per tick only x/y/z/yaw refill before ``tobytes()`` -- the exact
    bytes the gate service's sync coalescing emits per flush.
    """

    def __init__(self, eids: list[str], n_gates: int):
        n = len(eids)
        self.n_gates = int(n_gates)
        eid_arr = np.array([e.encode("ascii") for e in eids], "S16")
        self._idx = []   # per gate: fleet indices
        self._rec = []   # per gate: preallocated record array
        for g in range(self.n_gates):
            idx = np.arange(g, n, self.n_gates)
            rec = np.zeros(len(idx), SYNC_RECORD)
            rec["eid"] = eid_arr[idx]
            self._idx.append(idx)
            self._rec.append(rec)

    def batches(self, fleet: ScriptedFleet) -> list[bytes]:
        """The per-gate sync batches for the fleet's current state."""
        out = []
        for idx, rec in zip(self._idx, self._rec):
            rec["x"] = fleet.x[idx]
            rec["y"] = fleet.y[idx]
            rec["z"] = fleet.z[idx]
            rec["yaw"] = fleet.yaw[idx]
            out.append(rec.tobytes())
        return out
