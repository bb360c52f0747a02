"""Async SQL wrapper for game code (reference role: the ext/db family --
gwmongo's async op/callback contract applied to the SQL backend this image
supports, sqlite).

``execute`` for writes (returns rowcount), ``query`` for reads (returns the
row list); both run in submission order on one ordered worker and deliver
results (or ``JobError``) via post on the logic thread.
"""

from __future__ import annotations

import sqlite3
from typing import Callable

from ...utils.asyncjobs import JobError, OrderedWorker  # noqa: F401


class GWSql:
    def __init__(self, path: str, post: Callable | None = None):
        # the worker thread is the only executor, so sharing one connection
        # across submitting threads is safe
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._worker = OrderedWorker("gwsql", post=post)

    def execute(self, sql: str, params: tuple = (),
                callback: Callable | None = None):
        def op():
            cur = self._db.execute(sql, params)
            self._db.commit()
            return cur.rowcount

        self._worker.submit(op, callback)

    def query(self, sql: str, params: tuple = (),
              callback: Callable | None = None):
        self._worker.submit(
            lambda: self._db.execute(sql, params).fetchall(), callback
        )

    def close(self):
        self._worker.close()
        self._db.close()
