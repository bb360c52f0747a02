"""Gate-to-device ingest of the port: wire bytes -> columnar store, no
per-entity hops (a copy of the JAX package's ``ingest/``).

The reference decodes each client sync record into an entity method call
(GameService.go:398-410); this package decodes the flat record array with
one ``np.frombuffer`` and lands it in the per-space hot columns
(engine/ecs.py) with vectorized writes -- the wire->column->H2D path has
ZERO per-entity Python attribute writes.
"""

from .movement import (RECORD_SIZE, SYNC_RECORD, MovementIngest,
                       apply_per_entity)

__all__ = ["MovementIngest", "SYNC_RECORD", "RECORD_SIZE",
           "apply_per_entity"]
