"""Entity storage backends.

The backend interface (reference: storage_common/storage_common.go:6-13):
``write(type, eid, data)``, ``read(type, eid) -> dict|None``,
``exists(type, eid) -> bool``, ``list_entity_ids(type) -> list[str]``,
``close()``.  Backends are synchronous; the service wraps them in the worker.

Shipped backends (reference set: filesystem/mongodb/redis/redis_cluster/
mysql, storage/backend/*):

  * ``filesystem`` -- one msgpack file per entity under ``<dir>/<type>/<eid>``
    (hermetic; mirrors the reference's filesystem backend);
  * ``sqlite``     -- the SQL-family backend (reference: mysql), stdlib
    sqlite3, one ``entities(type, eid, data)`` table;
  * ``redis``      -- RESP protocol via ext/db/resp; keys
    ``storage:<type>:<eid>`` holding msgpack blobs, tested hermetically
    against ext/db/miniredis;
  * ``redis_cluster`` -- same schema through the slot-aware cluster client
    (ext/db/respcluster), tested against MiniRedisCluster;
  * ``mongodb`` / ``mysql`` -- pymongo / pymysql|mysql-connector when
    installed, else the port's own wire drivers (ext/db/mongowire,
    ext/db/mysqlwire), tested against MiniMongoServer / MiniMySQLServer;
    a backend that cannot connect raises.

The port's copy of the JAX package's ``storage/backends.py``: the same
records (msgpack of the attrs, the same files, table and redis keys), so
either package reads what the other wrote.
"""

from __future__ import annotations

import os
import sqlite3

import msgpack


class EntityStorageBackend:
    def write(self, type_name: str, eid: str, data: dict) -> None:
        raise NotImplementedError

    def read(self, type_name: str, eid: str) -> dict | None:
        raise NotImplementedError

    def exists(self, type_name: str, eid: str) -> bool:
        raise NotImplementedError

    def list_entity_ids(self, type_name: str) -> list[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FilesystemEntityStorage(EntityStorageBackend):
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, type_name: str, eid: str) -> str:
        return os.path.join(self.dir, type_name, eid)

    def write(self, type_name: str, eid: str, data: dict) -> None:
        d = os.path.join(self.dir, type_name)
        os.makedirs(d, exist_ok=True)
        tmp = self._path(type_name, eid) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(data, use_bin_type=True))
        os.replace(tmp, self._path(type_name, eid))  # atomic

    def read(self, type_name: str, eid: str) -> dict | None:
        try:
            with open(self._path(type_name, eid), "rb") as f:
                return msgpack.unpackb(f.read(), raw=False)
        except FileNotFoundError:
            return None

    def exists(self, type_name: str, eid: str) -> bool:
        return os.path.exists(self._path(type_name, eid))

    def list_entity_ids(self, type_name: str) -> list[str]:
        d = os.path.join(self.dir, type_name)
        try:
            return sorted(
                n for n in os.listdir(d) if not n.endswith(".tmp")
            )
        except FileNotFoundError:
            return []


class SqliteEntityStorage(EntityStorageBackend):
    """SQL-family backend (reference role: backend/mysql).  One connection;
    safe because the storage service serializes all ops on one ordered
    worker thread."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "entities.sqlite")
        self._db = sqlite3.connect(self.path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS entities ("
            " type TEXT NOT NULL, eid TEXT NOT NULL, data BLOB NOT NULL,"
            " PRIMARY KEY (type, eid))"
        )
        self._db.commit()

    def write(self, type_name: str, eid: str, data: dict) -> None:
        blob = msgpack.packb(data, use_bin_type=True)
        self._db.execute(
            "INSERT INTO entities (type, eid, data) VALUES (?, ?, ?)"
            " ON CONFLICT (type, eid) DO UPDATE SET data = excluded.data",
            (type_name, eid, blob),
        )
        self._db.commit()

    def read(self, type_name: str, eid: str) -> dict | None:
        row = self._db.execute(
            "SELECT data FROM entities WHERE type = ? AND eid = ?",
            (type_name, eid),
        ).fetchone()
        if row is None:
            return None
        return msgpack.unpackb(row[0], raw=False)

    def exists(self, type_name: str, eid: str) -> bool:
        row = self._db.execute(
            "SELECT 1 FROM entities WHERE type = ? AND eid = ?",
            (type_name, eid),
        ).fetchone()
        return row is not None

    def list_entity_ids(self, type_name: str) -> list[str]:
        rows = self._db.execute(
            "SELECT eid FROM entities WHERE type = ? ORDER BY eid",
            (type_name,),
        ).fetchall()
        return [r[0] for r in rows]

    def close(self) -> None:
        self._db.close()


class RedisEntityStorage(EntityStorageBackend):
    """Redis backend (reference: backend/redis/entity_storage_redis.go).
    ``storage:<type>:<eid>`` -> msgpack blob; a per-type set-index is kept
    in a sorted set for list_entity_ids (KEYS-free listing)."""

    config_kind = "server"

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 db: int = 0):
        from ..ext.db.resp import RespClient

        self._c = RespClient(host, port, db=db)

    @staticmethod
    def _key(type_name: str, eid: str) -> str:
        return f"storage:{type_name}:{eid}"

    @staticmethod
    def _index(type_name: str) -> str:
        return f"storage-index:{type_name}"

    def write(self, type_name: str, eid: str, data: dict) -> None:
        blob = msgpack.packb(data, use_bin_type=True)
        # index first (see RedisKVDB.put): a torn write leaves a listed eid
        # whose read() returns None, which callers already handle, rather
        # than a stored entity invisible to list_entity_ids forever
        self._c.command("ZADD", self._index(type_name), 0, eid)
        self._c.command("SET", self._key(type_name, eid), blob)

    def read(self, type_name: str, eid: str) -> dict | None:
        blob = self._c.command("GET", self._key(type_name, eid))
        if blob is None:
            return None
        return msgpack.unpackb(blob, raw=False)

    def exists(self, type_name: str, eid: str) -> bool:
        return bool(self._c.command("EXISTS", self._key(type_name, eid)))

    def list_entity_ids(self, type_name: str) -> list[str]:
        members = self._c.command(
            "ZRANGEBYLEX", self._index(type_name), "-", "+"
        )
        return [m.decode("utf-8") for m in members or []]

    def close(self) -> None:
        self._c.close()


class RedisClusterEntityStorage(RedisEntityStorage):
    """Redis-cluster backend (reference: backend/redis_cluster): same key
    schema as the redis backend, routed through the slot-aware cluster
    client (ext/db/respcluster) with MOVED/ASK handling.  Keys carry a
    ``{type}`` hash tag so an entity's blob and its type's list index live
    on the same node."""

    config_kind = "cluster"

    def __init__(self, addrs: str | list[tuple[str, int]]):
        from ..ext.db.dbutil import parse_addrs
        from ..ext.db.respcluster import RespClusterClient

        self._c = RespClusterClient(parse_addrs(addrs))

    @staticmethod
    def _key(type_name: str, eid: str) -> str:
        return f"storage:{{{type_name}}}:{eid}"

    @staticmethod
    def _index(type_name: str) -> str:
        return f"storage-index:{{{type_name}}}"


class MongoEntityStorage(EntityStorageBackend):
    """MongoDB backend (reference: backend/mongodb/mongodb.go).  One
    collection per entity type, documents ``{_id: eid, data: <attrs>}``.
    Uses pymongo when installed; otherwise the in-repo OP_MSG wire driver
    (ext/db/mongowire.MongoWireClient), so the real socket/BSON path runs
    without a mongo driver (hermetic tests pair it with
    MiniMongoServer)."""

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
        # ``client`` is any pymongo-compatible client -- a real MongoClient,
        # the wire driver above, or an injected in-process fake
        self._client = client
        self._db = self._client[db_name(db)]

    def write(self, type_name: str, eid: str, data: dict) -> None:
        self._db[type_name].replace_one(
            {"_id": eid}, {"_id": eid, "data": data}, upsert=True
        )

    def read(self, type_name: str, eid: str) -> dict | None:
        doc = self._db[type_name].find_one({"_id": eid})
        return doc["data"] if doc else None

    def exists(self, type_name: str, eid: str) -> bool:
        return self._db[type_name].count_documents({"_id": eid}, limit=1) > 0

    def list_entity_ids(self, type_name: str) -> list[str]:
        return sorted(
            d["_id"] for d in self._db[type_name].find({}, {"_id": 1})
        )

    def close(self) -> None:
        self._client.close()


class MySQLEntityStorage(EntityStorageBackend):
    """MySQL backend (reference: backend/mysql/entity_storage_mysql.go).
    pymysql or mysql.connector when installed, else the in-repo wire
    driver (ext/db/mysqlwire) -- see dbutil.connect_mysql.  Same table
    shape as the sqlite backend."""

    config_kind = "sql_server"

    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 db: int | str = "goworld", user: str = "root",
                 password: str = "", conn=None):
        from ..ext.db.dbutil import connect_mysql, db_name

        # ``conn`` is any DB-API connection speaking the %s paramstyle -- a
        # real MySQL driver connection, or the tests' sqlite shim
        self._db = conn if conn is not None else connect_mysql(
            host, port, user, password, db_name(db))
        cur = self._db.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS entities ("
            " type VARCHAR(64) NOT NULL, eid VARCHAR(32) NOT NULL,"
            " data BLOB NOT NULL, PRIMARY KEY (type, eid))"
        )

    def write(self, type_name: str, eid: str, data: dict) -> None:
        blob = msgpack.packb(data, use_bin_type=True)
        cur = self._db.cursor()
        cur.execute(
            "REPLACE INTO entities (type, eid, data) VALUES (%s, %s, %s)",
            (type_name, eid, blob),
        )

    def read(self, type_name: str, eid: str) -> dict | None:
        cur = self._db.cursor()
        cur.execute(
            "SELECT data FROM entities WHERE type = %s AND eid = %s",
            (type_name, eid),
        )
        row = cur.fetchone()
        return msgpack.unpackb(row[0], raw=False) if row else None

    def exists(self, type_name: str, eid: str) -> bool:
        cur = self._db.cursor()
        cur.execute(
            "SELECT 1 FROM entities WHERE type = %s AND eid = %s",
            (type_name, eid),
        )
        return cur.fetchone() is not None

    def list_entity_ids(self, type_name: str) -> list[str]:
        cur = self._db.cursor()
        cur.execute(
            "SELECT eid FROM entities WHERE type = %s ORDER BY eid",
            (type_name,),
        )
        return [r[0] for r in cur.fetchall()]

    def close(self) -> None:
        self._db.close()


_REGISTRY = {
    "filesystem": FilesystemEntityStorage,
    "sqlite": SqliteEntityStorage,
    "redis": RedisEntityStorage,
    "redis_cluster": RedisClusterEntityStorage,
    "mongodb": MongoEntityStorage,
    "mysql": MySQLEntityStorage,
}


def register_backend(name: str, cls):
    _REGISTRY[name] = cls


def new_entity_storage(backend: str, **kwargs) -> EntityStorageBackend:
    cls = _REGISTRY.get(backend)
    if cls is None:
        raise ValueError(
            f"unknown storage backend {backend!r} (have {sorted(_REGISTRY)})"
        )
    return cls(**kwargs)


def config_kwargs(backend: str, cfg, base_dir: str = ".") -> dict:
    """Constructor kwargs for a backend from its config section (see
    ext/db/dbutil.backend_config_kwargs for the config_kind contract)."""
    cls = _REGISTRY.get(backend)
    if cls is None:
        raise ValueError(
            f"unknown storage backend {backend!r} (have {sorted(_REGISTRY)})"
        )
    from ..ext.db.dbutil import backend_config_kwargs

    return backend_config_kwargs(cls, cfg, base_dir)
