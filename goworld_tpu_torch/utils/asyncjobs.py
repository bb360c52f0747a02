"""Ordered async job workers (reference: engine/async/async.go:32-112).

The reference's ``async`` package gives each named group one goroutine
draining an ordered queue, with ``WaitClear`` for shutdown; results re-enter
the logic thread via ``post``.  ``OrderedWorker`` is that primitive: storage
and kvdb build on it (the reference serializes kvdb through the ``_kvdb``
group the same way).

Guarantees:
  * ops run strictly in submission order on one daemon thread;
  * ``close()`` drains everything already submitted (FIFO sentinel), it
    never drops queued work;
  * ``wait_clear()`` cannot return early -- pending accounting uses a
    counter under a lock, not a clear-then-put event race;
  * an op that raises delivers ``JobError(exc)`` to its callback, which is
    distinguishable from any legitimate result (``None`` must stay meaning
    "success with no value", e.g. kvdb get_or_put's "value written").

The port's copy of the JAX package's ``utils/asyncjobs.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

from . import gwlog


class JobError:
    """Delivered to a callback when its op raised, instead of a result."""

    __slots__ = ("exception",)

    def __init__(self, exception: BaseException):
        self.exception = exception

    def __repr__(self):
        return f"JobError({self.exception!r})"


class OrderedWorker:
    def __init__(self, name: str,
                 post: Callable[[Callable], None] | None = None):
        self.name = name
        self.post = post or (lambda fn: fn())
        self.log = gwlog.logger(name)
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._pending = 0
        self._clear = threading.Event()
        self._clear.set()
        self._stopping = threading.Event()  # aborts in-op retry loops only
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    @property
    def stopping(self) -> threading.Event:
        """For ops with internal retry loops: checked to abort on close."""
        return self._stopping

    def submit(self, op: Callable[[], object],
               callback: Callable[[object], None] | None = None):
        with self._lock:
            self._pending += 1
            self._clear.clear()
        self._queue.put((op, callback))

    def pending(self) -> int:
        with self._lock:
            return self._pending

    def wait_clear(self, timeout: float | None = None) -> bool:
        """Block until every submitted op has completed (reference:
        async.WaitClear)."""
        return self._clear.wait(timeout)

    def close(self, timeout: float = 10.0):
        """Drain all queued ops, then stop the worker."""
        self._stopping.set()
        self._queue.put(None)  # FIFO: everything submitted before runs first
        self._thread.join(timeout=timeout)

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                break
            op, callback = item
            try:
                result = op()
            except Exception as e:
                self.log.exception("%s: job failed", self.name)
                result = JobError(e)
            if callback is not None:
                self.post(lambda cb=callback, r=result: cb(r))
            with self._lock:
                self._pending -= 1
                if self._pending == 0:
                    self._clear.set()
