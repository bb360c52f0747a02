"""KVDB backends.

Backend interface (reference: kvdb/types/kvdb_types.go:4-25):
``get(key) -> str|None``, ``put(key, val)``, ``find(begin, end) ->
list[(key, val)]`` over the half-open range ``[begin, end)`` in key order,
``close()``.  ``get_or_put`` is provided on the base class from get/put;
backends with native compare-and-set may override it.

``filesystem`` is an append-only log (one JSON record per line) replayed
into a dict on open -- hermetic, crash-safe (partial trailing lines are
discarded), and compacted when the log grows well past the live key count.
``sqlite``, ``redis``, ``redis_cluster``, ``mongodb`` and ``mysql`` sit
behind the same seam (the last two over pymongo / pymysql when installed,
else the port's wire drivers ``ext/db/mongowire`` / ``ext/db/mysqlwire``);
other backends plug in via ``register_backend``.

The port's copy of the JAX package's ``kvdb/backends.py``: the log
lines, compaction, table and redis keys are the same bytes, so either
package reads what the other wrote.
"""

from __future__ import annotations

import json
import os

from ..utils import gwlog

log = gwlog.logger("kvdb")


class KVDBBackend:
    def get(self, key: str) -> str | None:
        raise NotImplementedError

    def put(self, key: str, val: str) -> None:
        raise NotImplementedError

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        raise NotImplementedError

    def get_or_put(self, key: str, val: str) -> str | None:
        """Return the existing value, or write ``val`` and return None
        (reference: kvdb.go GetOrPut).  Atomic because the service runs
        all ops on one ordered worker."""
        cur = self.get(key)
        if cur is not None:
            return cur
        self.put(key, val)
        return None

    def close(self) -> None:
        pass


_COMPACT_MIN_LOG = 1024  # don't bother compacting tiny logs


class FilesystemKVDB(KVDBBackend):
    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "kvdb.log")
        self.data: dict[str, str] = {}
        self._log_records = 0
        self._replay()
        self._compact_if_worthwhile()
        self._seal_torn_tail()
        self._log = open(self.path, "a", encoding="utf-8")

    def _seal_torn_tail(self):
        """A kill -9 mid-append can leave the log without a trailing
        newline; appending straight after would glue the next record onto
        the torn fragment and lose BOTH lines at the next replay.  Close
        the tail with a newline so the fragment stays an isolated
        discardable line."""
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                torn = f.read(1) != b"\n"
        except (FileNotFoundError, OSError):
            return  # absent or empty log: nothing to seal
        if torn:
            with open(self.path, "ab") as f:
                f.write(b"\n")

    def _replay(self):
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn trailing write
                    self.data[rec["k"]] = rec["v"]
                    self._log_records += 1
        except FileNotFoundError:
            pass

    def _compaction_due(self) -> bool:
        return (self._log_records >= _COMPACT_MIN_LOG
                and self._log_records >= 4 * max(1, len(self.data)))

    def _compact_if_worthwhile(self):
        if not self._compaction_due():
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for k in sorted(self.data):
                f.write(json.dumps({"k": k, "v": self.data[k]}) + "\n")
        os.replace(tmp, self.path)
        self._log_records = len(self.data)

    def get(self, key: str) -> str | None:
        return self.data.get(key)

    def put(self, key: str, val: str) -> None:
        self.data[key] = val
        self._log.write(json.dumps({"k": key, "v": val}) + "\n")
        self._log.flush()
        self._log_records += 1
        if self._compaction_due():
            # The live handle must be reopened even if compaction fails
            # (disk full writing the tmp file) -- the pre-compaction log is
            # still intact and later puts must keep appending to it.  A
            # compaction failure must not fail the put: the record above is
            # already durable.
            self._log.close()
            try:
                self._compact_if_worthwhile()
            except OSError as e:
                log.warning("kvdb compaction failed (will retry later): %r", e)
            finally:
                self._log = open(self.path, "a", encoding="utf-8")

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        return [(k, self.data[k]) for k in sorted(self.data)
                if begin <= k < end]

    def close(self) -> None:
        self._log.close()


class SqliteKVDB(KVDBBackend):
    """SQL-family kvdb (reference role: kvdb/backend/kvdb_mysql).  One
    ``kv(k, v)`` table; range find is an indexed scan."""

    def __init__(self, directory: str):
        import sqlite3

        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "kvdb.sqlite")
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv"
            " (k TEXT PRIMARY KEY, v TEXT NOT NULL)"
        )
        self._db.commit()

    def get(self, key: str) -> str | None:
        row = self._db.execute(
            "SELECT v FROM kv WHERE k = ?", (key,)
        ).fetchone()
        return None if row is None else row[0]

    def put(self, key: str, val: str) -> None:
        self._db.execute(
            "INSERT INTO kv (k, v) VALUES (?, ?)"
            " ON CONFLICT (k) DO UPDATE SET v = excluded.v",
            (key, val),
        )
        self._db.commit()

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        rows = self._db.execute(
            "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
            (begin, end),
        ).fetchall()
        return [(k, v) for k, v in rows]

    def close(self) -> None:
        self._db.close()


class RedisKVDB(KVDBBackend):
    """Redis kvdb (reference: kvdb/backend/kvdb_redis).  Values live at
    ``kvdb:<key>``; a sorted set mirrors the key space so ``find`` is an
    ordered lex range instead of a KEYS scan.  ``get_or_put`` uses SETNX
    for native compare-and-set."""

    config_kind = "server"

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0):
        from ..ext.db.resp import RespClient

        self._c = RespClient(host, port, db=db)

    @staticmethod
    def _key(key: str) -> str:
        return f"kvdb:{key}"

    _INDEX = "kvdb-index"

    def get(self, key: str) -> str | None:
        v = self._c.command("GET", self._key(key))
        return None if v is None else v.decode("utf-8")

    def put(self, key: str, val: str) -> None:
        # index first: a crash between the two commands then self-heals
        # (find() filters keys whose value is missing), whereas value-first
        # would leave a value invisible to find() forever
        self._c.command("ZADD", self._INDEX, 0, key)
        self._c.command("SET", self._key(key), val)

    def get_or_put(self, key: str, val: str) -> str | None:
        if self._c.command("SETNX", self._key(key), val):
            self._c.command("ZADD", self._INDEX, 0, key)
            return None
        v = self._c.command("GET", self._key(key))
        return None if v is None else v.decode("utf-8")

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        if end == "":
            return []  # half-open [begin, "") is empty
        lo = "-" if begin == "" else f"[{begin}"
        members = self._c.command("ZRANGEBYLEX", self._INDEX, lo, f"({end}")
        if not members:
            return []
        keys = [m.decode("utf-8") for m in members]
        vals = self._c.command("MGET", *[self._key(k) for k in keys])
        return [
            (k, v.decode("utf-8"))
            for k, v in zip(keys, vals)
            if v is not None
        ]

    def close(self) -> None:
        self._c.close()


class RedisClusterKVDB(RedisKVDB):
    """Redis-cluster kvdb (reference: kvdb/backend/kvdb_redis_cluster).
    Same schema as the redis kvdb, through the slot-aware cluster client.
    ``find`` issues per-key GETs instead of one MGET -- the keys span slots
    and cross-slot multi-key commands are illegal in a cluster."""

    config_kind = "cluster"

    def __init__(self, addrs: str | list[tuple[str, int]]):
        from ..ext.db.dbutil import parse_addrs
        from ..ext.db.respcluster import RespClusterClient

        self._c = RespClusterClient(parse_addrs(addrs))

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        if end == "":
            return []
        lo = "-" if begin == "" else f"[{begin}"
        members = self._c.command(
            "ZRANGEBYLEX", self._INDEX, lo, f"({end}"
        )
        out = []
        for m in members or []:
            k = m.decode("utf-8")
            v = self._c.command("GET", self._key(k))
            if v is not None:
                out.append((k, v.decode("utf-8")))
        return out


class MongoKVDB(KVDBBackend):
    """MongoDB kvdb (reference: kvdb/backend/kvdb_mongodb).  pymongo when
    installed, else the in-repo OP_MSG wire driver (ext/db/mongowire) --
    see MongoEntityStorage."""

    config_kind = "server"

    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 db: int | str = "goworld", client=None):
        from ..ext.db.dbutil import db_name

        if client is None:
            try:
                import pymongo

                client = pymongo.MongoClient(host, port)
            except ImportError:
                from ..ext.db.mongowire import MongoWireClient

                client = MongoWireClient(host, port)
        # pymongo-compatible client; tests may also inject minimongo
        self._client = client
        self._col = self._client[db_name(db)]["kvdb"]

    def get(self, key: str) -> str | None:
        doc = self._col.find_one({"_id": key})
        return doc["v"] if doc else None

    def put(self, key: str, val: str) -> None:
        self._col.replace_one({"_id": key}, {"_id": key, "v": val},
                              upsert=True)

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        cur = self._col.find(
            {"_id": {"$gte": begin, "$lt": end}}
        ).sort("_id", 1)
        return [(d["_id"], d["v"]) for d in cur]

    def close(self) -> None:
        self._client.close()


class MySQLKVDB(KVDBBackend):
    """MySQL kvdb (reference: kvdb/backend/kvdb_mysql).  pymysql or
    mysql.connector when installed, else the in-repo wire driver
    (ext/db/mysqlwire) -- see dbutil.connect_mysql."""

    config_kind = "sql_server"

    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 db: int | str = "goworld", user: str = "root",
                 password: str = "", conn=None):
        from ..ext.db.dbutil import connect_mysql, db_name

        # DB-API connection with the %s paramstyle (tests inject a shim)
        self._db = conn if conn is not None else connect_mysql(
            host, port, user, password, db_name(db))
        cur = self._db.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS kv"
            " (k VARCHAR(255) PRIMARY KEY, v TEXT NOT NULL)"
        )

    def get(self, key: str) -> str | None:
        cur = self._db.cursor()
        cur.execute("SELECT v FROM kv WHERE k = %s", (key,))
        row = cur.fetchone()
        return None if row is None else row[0]

    def put(self, key: str, val: str) -> None:
        cur = self._db.cursor()
        cur.execute("REPLACE INTO kv (k, v) VALUES (%s, %s)", (key, val))

    def find(self, begin: str, end: str) -> list[tuple[str, str]]:
        cur = self._db.cursor()
        cur.execute(
            "SELECT k, v FROM kv WHERE k >= %s AND k < %s ORDER BY k",
            (begin, end),
        )
        return [(k, v) for k, v in cur.fetchall()]

    def close(self) -> None:
        self._db.close()


_REGISTRY = {
    "filesystem": FilesystemKVDB,
    "sqlite": SqliteKVDB,
    "redis": RedisKVDB,
    "redis_cluster": RedisClusterKVDB,
    "mongodb": MongoKVDB,
    "mysql": MySQLKVDB,
}


def register_backend(name: str, cls):
    _REGISTRY[name] = cls


def new_kvdb_backend(backend: str, **kwargs) -> KVDBBackend:
    cls = _REGISTRY.get(backend)
    if cls is None:
        raise ValueError(
            f"unknown kvdb backend {backend!r} (have {sorted(_REGISTRY)})"
        )
    return cls(**kwargs)


def config_kwargs(backend: str, cfg, base_dir: str = ".") -> dict:
    """Constructor kwargs for a backend from its config section; the class
    attribute ``config_kind`` ("server" vs default "directory") selects the
    keys, so registered custom backends compose (see storage.backends)."""
    cls = _REGISTRY.get(backend)
    if cls is None:
        raise ValueError(
            f"unknown kvdb backend {backend!r} (have {sorted(_REGISTRY)})"
        )
    from ..ext.db.dbutil import backend_config_kwargs

    return backend_config_kwargs(cls, cfg, base_dir)
