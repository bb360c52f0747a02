"""The ordered async KVDB worker (reference: kvdb/kvdb.go:43-101).

All operations run on one ``OrderedWorker`` in submission order -- this is
the reference's ordering guarantee (one ``async`` job group named
``_kvdb``).  Callbacks are delivered through ``post`` so they run on the
caller's logic thread.  If a backend op raises, the callback receives a
``JobError`` -- never a result-shaped value (``None`` from ``get_or_put``
always means "value written", matching kvdb.go's (result, err) callbacks).
"""

from __future__ import annotations

from typing import Callable

from ..utils.asyncjobs import JobError, OrderedWorker
from .backends import KVDBBackend

__all__ = ["KVDBService", "JobError"]


class KVDBService:
    def __init__(self, backend: KVDBBackend,
                 post: Callable[[Callable], None] | None = None):
        self.backend = backend
        self._worker = OrderedWorker("kvdb", post=post)

    # -- API (async, ordered; callbacks on the logic thread) ---------------
    def get(self, key: str, callback: Callable[[object], None]):
        self._worker.submit(lambda: self.backend.get(key), callback)

    def put(self, key: str, val: str,
            callback: Callable[[object], None] | None = None):
        self._worker.submit(lambda: self.backend.put(key, val), callback)

    def get_or_put(self, key: str, val: str,
                   callback: Callable[[object], None]):
        self._worker.submit(
            lambda: self.backend.get_or_put(key, val), callback
        )

    def find(self, begin: str, end: str,
             callback: Callable[[object], None]):
        self._worker.submit(lambda: self.backend.find(begin, end), callback)

    def wait_idle(self, timeout: float | None = None) -> bool:
        return self._worker.wait_clear(timeout)

    def close(self):
        self._worker.close()
        self.backend.close()
