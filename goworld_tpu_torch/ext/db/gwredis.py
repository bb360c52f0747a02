"""Async redis wrapper for game code (reference: ext/db/gwredis/gwredis.go
-- direct DB access with callbacks on the logic thread).

All commands run in submission order on one ordered worker; callbacks
receive the reply (bulk strings as bytes) or a ``JobError``.
"""

from __future__ import annotations

from typing import Callable

from ...utils.asyncjobs import JobError, OrderedWorker  # noqa: F401
from .resp import RespClient


class GWRedis:
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0, post: Callable | None = None):
        self._client = RespClient(host, port, db=db)
        self._worker = OrderedWorker("gwredis", post=post)

    def command(self, *args, callback: Callable | None = None):
        """Run any redis command asynchronously."""
        self._worker.submit(lambda: self._client.command(*args), callback)

    # convenience verbs mirroring the reference wrapper's surface
    def get(self, key: str, callback: Callable):
        self.command("GET", key, callback=callback)

    def set(self, key: str, val, callback: Callable | None = None):
        self.command("SET", key, val, callback=callback)

    def delete(self, *keys: str, callback: Callable | None = None):
        self.command("DEL", *keys, callback=callback)

    def close(self):
        self._worker.close()
        self._client.close()
