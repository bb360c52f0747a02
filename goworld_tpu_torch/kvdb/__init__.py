"""Ordered async key-value store (reference: engine/kvdb/kvdb.go:20-101,
backend iface engine/kvdb/types/kvdb_types.go:4-25).

The reference serializes all KVDB ops through one async job group
(``_kvdb``) so operations are strictly ordered; callbacks re-enter the
logic thread.  Here one daemon worker drains an ordered queue and results
are delivered through ``post``.  The port's copy of the JAX package's
``kvdb/``.
"""

from .backends import FilesystemKVDB, KVDBBackend, new_kvdb_backend
from .service import KVDBService

__all__ = [
    "FilesystemKVDB",
    "KVDBBackend",
    "KVDBService",
    "new_kvdb_backend",
]
