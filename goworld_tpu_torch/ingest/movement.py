"""Batched client-movement ingest (port copy): one frombuffer, vectorized
column lands.

The port's copy of the JAX package's ``ingest/movement.py``.  The gate
coalesces MT_SYNC_POSITION_YAW_FROM_CLIENT records into one flat
packet per flush (components/gate); the reference then decodes each record
into an entity method call (GameService.go:398-410).  Here the whole record
array decodes with a single ``np.frombuffer`` over the packet's remaining
bytes (netutil Packet.read_view -- zero copy), entities resolve to
(space, slot) pairs, and positions land in the per-space hot columns
(engine/ecs.py) as fancy-indexed array writes.  Nothing on the hot path
writes a Python attribute per entity:

  wire bytes -> SYNC_RECORD array -> cols.x/y/z/yaw[slots] -> (next flush)
  delta-staged H2D (ops/aoi_stage) and the interest stacks' columns.

Sync bookkeeping is columnar too: ``cols.sync[slots] |= SYNC_NEIGHBORS``
plus one runtime registration; the sync phase drains the column into the
per-entity dirty machinery only for entities some client actually watches
(Space.drain_column_sync), so batched and per-entity movement emit
identical records through one path.

Entities that cannot take the vectorized land -- unknown, not
client-syncing, spaceless, or mid-enter (``aoi_slot < 0``) -- fall back to
the per-entity ``sync_position_yaw_from_client`` apply, bit-identical in
effect and counted in ``stats``.  The ``aoi.ingest`` fault seam demotes a
whole batch to that path (faults.py): semantics are preserved under every
injected kind, the batch is merely slower.

Telemetry: the decode+land runs under the ``aoi.ingest`` span;
``aoi.ingest_bytes`` counts wire bytes consumed and
``aoi.ingest_batched_frac`` gauges the fraction of the last batch's
records that landed vectorized.
"""

from __future__ import annotations

import numpy as np

from .. import faults, telemetry
from ..engine.entity import SYNC_NEIGHBORS
from ..engine.ids import ID_LENGTH
from ..engine.vector import Vector3
from ..telemetry import trace as _T

# Wire layout of one record -- the JAX package's (its client.py append
# side and per-entity decode): [16s eid][f32 x][f32 y][f32 z][f32 yaw],
# little-endian, no padding.
SYNC_RECORD = np.dtype([("eid", f"S{ID_LENGTH}"), ("x", "<f4"),
                        ("y", "<f4"), ("z", "<f4"), ("yaw", "<f4")])
RECORD_SIZE = SYNC_RECORD.itemsize  # 32

_INGEST_BYTES = telemetry.counter(
    "aoi.ingest_bytes", "wire bytes decoded by the batched movement ingest")
_BATCHED_FRAC = telemetry.gauge(
    "aoi.ingest_batched_frac",
    "fraction of the last ingest batch landed via vectorized column writes")


def apply_per_entity(entities, rec: np.ndarray) -> int:
    """The per-entity baseline/fallback: one
    ``sync_position_yaw_from_client`` call per record (what the reference
    does for every record).  Returns how many records applied."""
    n_applied = 0
    get = entities.get
    eids = rec["eid"]
    xs, ys, zs, yaws = rec["x"], rec["y"], rec["z"], rec["yaw"]
    for i in range(len(rec)):
        e = get(eids[i].decode("ascii"))
        if e is None or not e.client_syncing or e.space is None:
            continue
        e.sync_position_yaw_from_client(
            Vector3(float(xs[i]), float(ys[i]), float(zs[i])),
            float(yaws[i]))
        n_applied += 1
    return n_applied


class MovementIngest:
    """Per-runtime ingest state: stats + the column-land hot path.

    ``stats`` keys (the load harness asserts ``per_entity_writes == 0``
    for its steady state):

    ``batches``/``records``     packets and records seen;
    ``batched``                 records landed via column writes;
    ``per_entity_writes``       records applied through the per-entity
                                fallback (mid-enter or demoted batch);
    ``demoted_batches``         whole batches the ``aoi.ingest`` seam
                                pushed onto the fallback path;
    ``bytes``                   wire bytes consumed.
    """

    __slots__ = ("rt", "stats")

    def __init__(self, rt):
        self.rt = rt
        self.stats = {"batches": 0, "records": 0, "batched": 0,
                      "per_entity_writes": 0, "demoted_batches": 0,
                      "bytes": 0}

    def ingest(self, pkt) -> int:
        """Decode + land every remaining record of ``pkt``.  Returns the
        record count."""
        nbytes = pkt.remaining()
        n = nbytes // RECORD_SIZE
        if n <= 0:
            return 0
        st = self.stats
        st["batches"] += 1
        st["records"] += n
        st["bytes"] += nbytes
        with _T.span("aoi.ingest"):
            _INGEST_BYTES.inc(n * RECORD_SIZE)
            # zero-copy view decode; rec aliases the pooled packet buffer,
            # and every land below copies out via fancy indexing
            rec = np.frombuffer(pkt.read_view(n * RECORD_SIZE),
                                dtype=SYNC_RECORD)
            # fault seam: ANY injected kind demotes the batch to the
            # per-entity path -- bit-identical land, merely slower
            try:
                demote = faults.check("aoi.ingest") is not None
            except Exception:
                demote = True
            if demote:
                st["demoted_batches"] += 1
                st["per_entity_writes"] += apply_per_entity(
                    self.rt.entities, rec)
                _BATCHED_FRAC.set(0.0)
                return n
            n_batched = self._land(rec)
        st["batched"] += n_batched
        _BATCHED_FRAC.set(n_batched / n)
        return n

    def _land(self, rec: np.ndarray) -> int:
        """Resolve records to (space, slot) groups and land them as
        vectorized column writes.  Resolution is per-record dict READS
        (unavoidable: eids are strings); the writes are arrays only."""
        get = self.rt.entities.get
        eids = rec["eid"]
        groups: dict = {}  # space -> ([record indices], [slots])
        fallback: list[int] = []  # mid-enter records (aoi_slot < 0)
        for i in range(len(rec)):
            e = get(eids[i].decode("ascii"))
            if e is None or not e.client_syncing or e.space is None:
                continue  # dropped -- same as the per-entity decode
            slot = e.aoi_slot
            if slot < 0:
                fallback.append(i)
                continue
            g = groups.get(e.space)
            if g is None:
                g = groups[e.space] = ([], [])
            g[0].append(i)
            g[1].append(slot)
        n_batched = 0
        css = self.rt._col_sync_spaces
        for sp, (ixs, slots) in groups.items():
            idx = np.asarray(ixs, np.intp)
            sl = np.asarray(slots, np.int64)
            cols = sp._cols
            # duplicate eids: fancy assignment applies in record order,
            # last write wins -- the per-entity path's sequential result
            cols.x[sl] = rec["x"][idx]
            cols.y[sl] = rec["y"][idx]
            cols.z[sl] = rec["z"][idx]
            cols.yaw[sl] = rec["yaw"][idx]
            # no owner echo for client-driven movement (same policy as
            # sync_position_yaw_from_client: correcting the owner fights
            # client-side prediction) -- neighbors only
            cols.sync[sl] |= SYNC_NEIGHBORS
            sp._aoi_dirty = True
            css[sp] = True
            n_batched += len(ixs)
        if fallback:
            st = self.stats
            for i in fallback:
                st["per_entity_writes"] += apply_per_entity(
                    self.rt.entities, rec[i:i + 1])
        return n_batched
