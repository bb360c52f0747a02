"""In-process pymongo-compatible fake (the miniredis pattern, for Mongo).

Implements exactly the client surface the mongodb STORAGE and KVDB
backends use -- ``client[db][coll]`` with ``insert_one`` (duplicate _id
raises), ``replace_one(upsert=)``, ``update_one`` ($set/$unset/$inc),
``find_one``, ``find`` (+``sort``/projection/limit), ``count_documents``,
``delete_one``/``delete_many``.  (NOT a full pymongo fake: gwdoc's
PymongoEngine needs result objects (``matched_count``), ``update_many``
and index management -- run that against a real pymongo.)  Backends accept an
injected client, so their logic runs under test without mongod or
pymongo; against a real deployment the same code gets a real
``pymongo.MongoClient``.

Reference role: the reference tests its mongodb backends against a live
mongod in CI (engine/storage/storage_test.go pattern); this fake is the
hermetic stand-in.  The port's copy of the JAX package's
``ext/db/minimongo.py``.
"""

from __future__ import annotations

import threading
from typing import Any


class DuplicateKeyError(Exception):
    pass


def _match(doc: dict, flt: dict) -> bool:
    for k, cond in flt.items():
        v = doc.get(k)
        if isinstance(cond, dict):
            for op, rhs in cond.items():
                if op == "$gte":
                    if not (v is not None and v >= rhs):
                        return False
                elif op == "$gt":
                    if not (v is not None and v > rhs):
                        return False
                elif op == "$lte":
                    if not (v is not None and v <= rhs):
                        return False
                elif op == "$lt":
                    if not (v is not None and v < rhs):
                        return False
                elif op == "$ne":
                    if v == rhs:
                        return False
                elif op == "$eq":
                    if v != rhs:
                        return False
                else:
                    raise ValueError(f"minimongo: unsupported operator {op}")
        elif v != cond:
            return False
    return True


class _Cursor:
    def __init__(self, docs: list[dict], projection: dict | None):
        self._docs = docs
        self._proj = projection

    def sort(self, key: str, direction: int = 1) -> "_Cursor":
        # pymongo orders documents missing the sort key first (BSON null
        # sorts lowest); mirror that instead of crashing on None < value
        self._docs.sort(
            key=lambda d: (d.get(key) is not None, d.get(key)),
            reverse=direction < 0)
        return self

    def limit(self, n: int) -> "_Cursor":
        self._docs = self._docs[:n]
        return self

    def _project(self, d: dict) -> dict:
        if not self._proj:
            return dict(d)
        keep = {k for k, v in self._proj.items() if v}
        if "_id" not in self._proj:
            keep.add("_id")  # mongo includes _id unless excluded
        return {k: v for k, v in d.items() if k in keep}

    def __iter__(self):
        return (self._project(d) for d in self._docs)


class MiniCollection:
    def __init__(self):
        self._docs: dict[Any, dict] = {}
        self._lock = threading.Lock()

    def insert_one(self, doc: dict):
        with self._lock:
            _id = doc.get("_id")
            if _id in self._docs:
                raise DuplicateKeyError(f"duplicate _id {_id!r}")
            self._docs[_id] = dict(doc)

    def replace_one(self, flt: dict, doc: dict, upsert: bool = False):
        with self._lock:
            for _id, d in self._docs.items():
                if _match(d, flt):
                    self._docs[_id] = dict(doc)
                    return
            if upsert:
                _id = doc.get("_id")
                if _id is None:
                    import uuid

                    _id = uuid.uuid4().hex  # ObjectId stand-in
                    doc = dict(doc, _id=_id)
                elif _id in self._docs:
                    # the filter did not match but the _id exists: a real
                    # mongod's upsert-insert hits the unique index
                    raise DuplicateKeyError(f"duplicate _id {_id!r}")
                self._docs[_id] = dict(doc)

    def update_one(self, flt: dict, update: dict, upsert: bool = False):
        """Operator update ($set / $unset / $inc) on the first match; an
        upsert seeds the new document from the filter's equality fields
        (mongo's rule) before applying the operators."""
        ops = {k: update[k] for k in ("$set", "$unset", "$inc")
               if k in update}
        unknown = set(update) - set(ops)
        if unknown:
            raise ValueError(f"unsupported update operators {unknown}")

        for op in ops.values():
            for k in op:
                if "." in k:
                    # dotted paths address NESTED fields in mongo; storing
                    # a literal "a.b" key would silently diverge -- raise,
                    # matching this fake's unsupported-shape contract
                    raise ValueError(
                        f"dotted update paths unsupported: {k!r}")

        def apply(d: dict) -> dict:
            for k, v in ops.get("$set", {}).items():
                d[k] = v
            for k in ops.get("$unset", {}):
                d.pop(k, None)
            for k, v in ops.get("$inc", {}).items():
                d[k] = d.get(k, 0) + v
            return d

        with self._lock:
            for _id, d in self._docs.items():
                if _match(d, flt):
                    self._docs[_id] = apply(dict(d))
                    return
            if upsert:
                # mongo's upsert seed: the filter's equality conditions
                # (embedded-document values included; only operator
                # documents like {"$gt": 3} are conditions, not values)
                seed = {k: v for k, v in flt.items()
                        if not (isinstance(v, dict)
                                and any(kk.startswith("$") for kk in v))}
                doc = apply(seed)
                if doc.get("_id") is None:
                    import uuid

                    doc["_id"] = uuid.uuid4().hex  # ObjectId stand-in
                elif doc["_id"] in self._docs:
                    raise DuplicateKeyError(
                        f"duplicate _id {doc['_id']!r}")
                self._docs[doc["_id"]] = doc

    def find_one(self, flt: dict | None = None) -> dict | None:
        with self._lock:
            for d in self._docs.values():
                if flt is None or _match(d, flt):
                    return dict(d)
        return None

    def find(self, flt: dict | None = None,
             projection: dict | None = None) -> _Cursor:
        with self._lock:
            docs = [dict(d) for d in self._docs.values()
                    if flt is None or _match(d, flt)]
        return _Cursor(docs, projection)

    def count_documents(self, flt: dict | None = None,
                        limit: int | None = None) -> int:
        with self._lock:
            n = sum(1 for d in self._docs.values()
                    if flt is None or _match(d, flt))
        return min(n, limit) if limit else n

    def delete_one(self, flt: dict):
        with self._lock:
            for _id, d in list(self._docs.items()):
                if _match(d, flt):
                    del self._docs[_id]
                    return

    def delete_many(self, flt: dict):
        with self._lock:
            for _id, d in list(self._docs.items()):
                if _match(d, flt):
                    del self._docs[_id]


class MiniDB:
    def __init__(self):
        self._cols: dict[str, MiniCollection] = {}
        self._lock = threading.Lock()

    def __getitem__(self, name: str) -> MiniCollection:
        with self._lock:
            if name not in self._cols:
                self._cols[name] = MiniCollection()
            return self._cols[name]


class MiniMongoClient:
    def __init__(self):
        self._dbs: dict[str, MiniDB] = {}
        self._lock = threading.Lock()

    def __getitem__(self, name: str) -> MiniDB:
        with self._lock:
            if name not in self._dbs:
                self._dbs[name] = MiniDB()
            return self._dbs[name]

    def close(self):
        pass
