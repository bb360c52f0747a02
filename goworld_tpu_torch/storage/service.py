"""The async storage worker (reference: storage.go:66-286).

One ``OrderedWorker`` drains the op queue in order.  Saves retry with
backoff until they succeed (the reference retries forever -- an entity save
must not be lost); the retry loop aborts only on close.  Completion
callbacks are delivered through ``post`` so they run on the caller's logic
thread, never the worker.  Read-style ops deliver a ``JobError`` to their
callback if the backend raised.
"""

from __future__ import annotations

import time
from typing import Callable

from ..utils import gwlog, opmon
from ..utils.asyncjobs import JobError, OrderedWorker
from .backends import EntityStorageBackend

__all__ = ["EntityStorageService", "JobError"]

_SAVE_RETRY_BACKOFF = 1.0
QUEUE_WARN_LEN = 1000  # reference: storage queue-length warnings


class EntityStorageService:
    def __init__(
        self,
        backend: EntityStorageBackend,
        post: Callable[[Callable], None] | None = None,
    ):
        self.backend = backend
        self.log = gwlog.logger("storage")
        self._worker = OrderedWorker("storage", post=post)

    # -- API (async; callbacks on the logic thread) ------------------------
    def save(self, type_name: str, eid: str, data: dict,
             callback: Callable[[], None] | None = None):
        # only signal completion on success -- an aborted save (JobError at
        # shutdown) must not look like a durable write to the caller
        cb = None
        if callback is not None:
            def cb(result, _callback=callback):
                if not isinstance(result, JobError):
                    _callback()
        self._submit(
            lambda: self._save_with_retry(type_name, eid, data), cb
        )

    def load(self, type_name: str, eid: str,
             callback: Callable[[object], None]):
        self._submit(lambda: self.backend.read(type_name, eid), callback)

    def exists(self, type_name: str, eid: str,
               callback: Callable[[object], None]):
        self._submit(lambda: self.backend.exists(type_name, eid), callback)

    def list_entity_ids(self, type_name: str,
                        callback: Callable[[object], None]):
        self._submit(lambda: self.backend.list_entity_ids(type_name), callback)

    def _submit(self, op, callback):
        def monitored(op=op):
            with opmon.Operation("storage.op"):
                return op()

        self._worker.submit(monitored, callback)
        depth = self._worker.pending()
        if depth > QUEUE_WARN_LEN:
            self.log.warning("storage queue depth %d", depth)

    def wait_idle(self, timeout: float | None = None) -> bool:
        return self._worker.wait_clear(timeout)

    def close(self):
        self._worker.close()
        self.backend.close()

    def _save_with_retry(self, type_name: str, eid: str, data: dict):
        """Reference semantics: infinite retry -- saves must not be lost
        (storage.go save loop)."""
        while True:
            try:
                self.backend.write(type_name, eid, data)
                return
            except Exception:
                if self._worker.stopping.is_set():
                    raise
                self.log.exception(
                    "save %s/%s failed; retrying in %.1fs",
                    type_name, eid, _SAVE_RETRY_BACKOFF,
                )
                time.sleep(_SAVE_RETRY_BACKOFF)
