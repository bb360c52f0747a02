"""The post queue: the only safe way for worker threads / callbacks to run
code on the logic thread (reference: engine/post/post.go:21-44,
drained at the end of every main-loop iteration).

Thread-safe enqueue; single-consumer ``tick`` drains.  Callbacks posted while
draining run in the *next* drain (same as the reference's swap semantics),
so a callback that re-posts itself cannot starve the loop.
"""

from __future__ import annotations

import threading
from typing import Callable


class PostQueue:
    def __init__(self):
        self._lock = threading.Lock()
        self._queue: list[Callable[[], None]] = []

    def post(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._queue.append(fn)

    def tick(self, on_error: Callable[[BaseException], None] | None = None) -> int:
        with self._lock:
            batch, self._queue = self._queue, []
        for fn in batch:
            try:
                fn()
            except Exception as e:  # crash isolation, reference gwutils idiom
                if on_error:
                    on_error(e)
                else:
                    raise
        return len(batch)

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


_default = PostQueue()


def post(fn: Callable[[], None]) -> None:
    """Post to the process-wide default queue."""
    _default.post(fn)


def tick(on_error=None) -> int:
    return _default.tick(on_error)
