"""Async document-database wrapper for game code.

Reference role: ext/db/gwmongo/gwmongo.go (355 LoC) -- the rich direct-Mongo
async wrapper (insert/find/update/upsert/remove/index ops, callbacks posted
to the logic thread).  Without a mongo driver or server the
wrapper runs over a built-in embedded document engine (:class:`DocStore`,
sqlite-persisted, Mongo-style query/update operators); when pymongo is
available the same wrapper surface can be pointed at a real MongoDB via
``GWDoc(engine=PymongoEngine(client['mydb']))``.

Query operators: equality, $ne, $gt, $gte, $lt, $lte, $in, $nin, $exists,
dotted paths, $and, $or.  Update operators: $set, $unset, $inc, $push, or a
full replacement document.

The port's copy of the JAX package's ``ext/db/gwdoc.py``, over the port's
``engine/ids`` and ``utils/asyncjobs``.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Callable

import msgpack

from ...utils.asyncjobs import JobError, OrderedWorker  # noqa: F401
from ...engine.ids import gen_id


class DuplicateKeyError(Exception):
    """Insert with an _id that already exists in the collection (the
    reference's gwmongo surfaces MongoDB's duplicate-key error the same
    way; reference: ext/db/gwmongo/gwmongo.go Insert)."""


# -- query/update evaluation -------------------------------------------------

def _get_path(doc: dict, path: str):
    """Resolve a dotted path; returns (found, value)."""
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        elif isinstance(cur, list) and part.isdigit() and int(part) < len(cur):
            cur = cur[int(part)]
        else:
            return False, None
    return True, cur


def _cmp_ok(a, b) -> bool:
    """Comparable under mongo-ish rules (same broad type family)."""
    num = (int, float)
    if isinstance(a, num) and isinstance(b, num):
        return True
    return type(a) is type(b)


_QUERY_OPS = frozenset({
    "$exists", "$ne", "$nin", "$gt", "$gte", "$lt", "$lte", "$in",
})


def _match_cond(value_found: bool, value, cond) -> bool:
    if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
        for op in cond:
            if op not in _QUERY_OPS:
                raise ValueError(f"unsupported query operator {op!r}")
        for op, arg in cond.items():
            if op == "$exists":
                if bool(arg) != value_found:
                    return False
            elif op == "$ne":
                if value_found and value == arg:
                    return False
            elif op == "$nin":
                # mongo semantics: a missing field is "not in" any list
                if value_found and value in arg:
                    return False
            elif not value_found:
                return False
            elif op == "$gt":
                if not (_cmp_ok(value, arg) and value > arg):
                    return False
            elif op == "$gte":
                if not (_cmp_ok(value, arg) and value >= arg):
                    return False
            elif op == "$lt":
                if not (_cmp_ok(value, arg) and value < arg):
                    return False
            elif op == "$lte":
                if not (_cmp_ok(value, arg) and value <= arg):
                    return False
            elif op == "$in":
                if value not in arg:
                    return False
        return True
    return value_found and value == cond


def match(doc: dict, query: dict) -> bool:
    """Does ``doc`` satisfy the Mongo-style ``query``?"""
    for key, cond in query.items():
        if key == "$and":
            if not all(match(doc, q) for q in cond):
                return False
        elif key == "$or":
            if not any(match(doc, q) for q in cond):
                return False
        else:
            found, value = _get_path(doc, key)
            # equality against a list member also matches (mongo semantics)
            if found and isinstance(value, list) and not isinstance(cond, (dict, list)):
                if cond in value:
                    continue
            if not _match_cond(found, value, cond):
                return False
    return True


def _set_path(doc: dict, path: str, value):
    parts = path.split(".")
    cur = doc
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value


def _unset_path(doc: dict, path: str):
    parts = path.split(".")
    cur = doc
    for p in parts[:-1]:
        cur = cur.get(p)
        if not isinstance(cur, dict):
            return
    cur.pop(parts[-1], None)


def apply_update(doc: dict, update: dict) -> dict:
    """Apply a Mongo-style update; returns the new document."""
    ops = {k for k in update if k.startswith("$")}
    if not ops:
        new = dict(update)  # full replacement keeps the _id
        new["_id"] = doc["_id"]
        return new
    new = msgpack.unpackb(
        msgpack.packb(doc, use_bin_type=True), raw=False
    )  # deep copy through the storage codec
    for op, fields in update.items():
        if op == "$set":
            for path, v in fields.items():
                _set_path(new, path, v)
        elif op == "$unset":
            for path in fields:
                _unset_path(new, path)
        elif op == "$inc":
            for path, delta in fields.items():
                found, cur = _get_path(new, path)
                _set_path(new, path, (cur if found else 0) + delta)
        elif op == "$push":
            for path, v in fields.items():
                found, cur = _get_path(new, path)
                if not found or not isinstance(cur, list):
                    cur = []
                cur = cur + [v]
                _set_path(new, path, cur)
        else:
            raise ValueError(f"unsupported update operator {op!r}")
    return new


# -- embedded engine ---------------------------------------------------------

class DocStore:
    """Embedded document engine: collections of dict documents keyed by
    ``_id``, persisted in one sqlite table, queries evaluated in-process.
    Synchronous; :class:`GWDoc` adds the async contract."""

    def __init__(self, path: str | None = None):
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._db = sqlite3.connect(path or ":memory:",
                                   check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS docs ("
            " col TEXT NOT NULL, id TEXT NOT NULL, data BLOB NOT NULL,"
            " PRIMARY KEY (col, id))"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS doc_indexes ("
            " col TEXT NOT NULL, spec TEXT NOT NULL,"
            " PRIMARY KEY (col, spec))"
        )
        self._db.commit()
        self._lock = threading.Lock()

    # each document is stored msgpack'd; _id kept in the row key too
    def _iter(self, col: str):
        rows = self._db.execute(
            "SELECT data FROM docs WHERE col = ? ORDER BY id", (col,)
        ).fetchall()
        for (blob,) in rows:
            yield msgpack.unpackb(blob, raw=False)

    def insert(self, col: str, doc: dict) -> str:
        with self._lock:
            doc = dict(doc)
            doc.setdefault("_id", gen_id())
            # plain INSERT: a duplicate _id must fail loudly like MongoDB's
            # duplicate-key error (reference: gwmongo Insert), not silently
            # replace the existing document
            try:
                self._db.execute(
                    "INSERT INTO docs (col, id, data) VALUES (?,?,?)",
                    (col, str(doc["_id"]),
                     msgpack.packb(doc, use_bin_type=True)),
                )
            except sqlite3.IntegrityError as e:
                self._db.rollback()
                raise DuplicateKeyError(
                    f"duplicate _id {doc['_id']!r} in {col!r}") from e
            self._db.commit()
            return doc["_id"]

    def find(self, col: str, query: dict | None = None,
             limit: int = 0, sort: str | None = None) -> list[dict]:
        with self._lock:
            out = [d for d in self._iter(col) if match(d, query or {})]
        if sort:
            reverse = sort.startswith("-")
            key = sort.lstrip("+-")
            present = [d for d in out if _get_path(d, key)[0]]
            absent = [d for d in out if not _get_path(d, key)[0]]
            present.sort(key=lambda d: _get_path(d, key)[1], reverse=reverse)
            out = present + absent  # docs missing the sort key go last
        if limit:
            out = out[:limit]
        return out

    def find_one(self, col: str, query: dict | None = None) -> dict | None:
        res = self.find(col, query, limit=1)
        return res[0] if res else None

    def find_id(self, col: str, _id: str) -> dict | None:
        with self._lock:
            row = self._db.execute(
                "SELECT data FROM docs WHERE col = ? AND id = ?",
                (col, str(_id)),
            ).fetchone()
        return msgpack.unpackb(row[0], raw=False) if row else None

    def count(self, col: str, query: dict | None = None) -> int:
        if not query:
            with self._lock:
                (n,) = self._db.execute(
                    "SELECT COUNT(*) FROM docs WHERE col = ?", (col,)
                ).fetchone()
            return n
        return len(self.find(col, query))

    def _hits_locked(self, col: str, query: dict, multi: bool) -> list[dict]:
        """Matching docs; pure-_id-equality queries use the keyed row lookup
        instead of scanning and decoding the whole collection."""
        if set(query) == {"_id"} and not isinstance(query["_id"], dict):
            row = self._db.execute(
                "SELECT data FROM docs WHERE col = ? AND id = ?",
                (col, str(query["_id"])),
            ).fetchone()
            if row is None:
                return []
            doc = msgpack.unpackb(row[0], raw=False)
            # the row key is str(_id); re-check the real equality so e.g.
            # querying {'_id': '5'} never hits a doc whose _id is int 5
            # (find/count, which scan with match(), would not match it)
            return [doc] if match(doc, query) else []
        hits = [d for d in self._iter(col) if match(d, query)]
        return hits if multi else hits[:1]

    @staticmethod
    def _upsert_base(query: dict) -> dict:
        """Seed document from the equality parts of an upsert's query,
        expanding dotted paths into nested dicts (mongo upsert rules)."""
        base: dict = {}
        for k, v in query.items():
            if k.startswith("$"):
                continue
            if isinstance(v, dict) and any(x.startswith("$") for x in v):
                continue  # operator condition: contributes no seed value
            _set_path(base, k, v)
        if not isinstance(base.get("_id"), (str, int)):
            base.pop("_id", None)
        base.setdefault("_id", gen_id())
        return base

    def update(self, col: str, query: dict, update: dict,
               multi: bool = False, upsert: bool = False) -> int:
        with self._lock:
            hits = self._hits_locked(col, query, multi)
            for d in hits:
                new = apply_update(d, update)
                self._db.execute(
                    "UPDATE docs SET data = ? WHERE col = ? AND id = ?",
                    (msgpack.packb(new, use_bin_type=True), col,
                     str(d["_id"])),
                )
            if not hits and upsert:
                # inside the same critical section: a concurrent upsert must
                # not also see "no hits" and double-insert
                doc = apply_update(self._upsert_base(query), update)
                self._db.execute(
                    "INSERT OR REPLACE INTO docs (col, id, data)"
                    " VALUES (?,?,?)",
                    (col, str(doc["_id"]),
                     msgpack.packb(doc, use_bin_type=True)),
                )
                self._db.commit()
                return 1
            self._db.commit()
        return len(hits)

    def update_id(self, col: str, _id: str, update: dict) -> int:
        return self.update(col, {"_id": _id}, update)

    def upsert_id(self, col: str, _id: str, update: dict) -> int:
        return self.update(col, {"_id": _id}, update, upsert=True)

    def remove(self, col: str, query: dict, multi: bool = True) -> int:
        with self._lock:
            hits = self._hits_locked(col, query, multi)
            for d in hits:
                self._db.execute(
                    "DELETE FROM docs WHERE col = ? AND id = ?",
                    (col, str(d["_id"])),
                )
            self._db.commit()
        return len(hits)

    def remove_id(self, col: str, _id: str) -> int:
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM docs WHERE col = ? AND id = ?", (col, str(_id))
            )
            self._db.commit()
            return cur.rowcount

    def drop_collection(self, col: str):
        with self._lock:
            self._db.execute("DELETE FROM docs WHERE col = ?", (col,))
            self._db.execute("DELETE FROM doc_indexes WHERE col = ?", (col,))
            self._db.commit()

    def ensure_index(self, col: str, spec: str):
        """Recorded only -- the embedded engine scans; the record keeps the
        call surface (reference: gwmongo EnsureIndex) and lets a real-Mongo
        engine create it."""
        with self._lock:
            self._db.execute(
                "INSERT OR IGNORE INTO doc_indexes (col, spec) VALUES (?,?)",
                (col, spec),
            )
            self._db.commit()

    def indexes(self, col: str) -> list[str]:
        with self._lock:
            rows = self._db.execute(
                "SELECT spec FROM doc_indexes WHERE col = ? ORDER BY spec",
                (col,),
            ).fetchall()
        return [r[0] for r in rows]

    def close(self):
        self._db.close()


class PymongoEngine:
    """Adapter giving a real MongoDB the DocStore surface, for
    ``GWDoc(engine=PymongoEngine(client['mydb']))``.  Queries and updates
    pass through unchanged -- DocStore's operator dialect is a subset of
    Mongo's.  Needs pymongo."""

    def __init__(self, database):
        self._db = database

    def insert(self, col: str, doc: dict) -> str:
        doc = dict(doc)
        doc.setdefault("_id", gen_id())
        # insert_one so a duplicate _id raises, re-raised as the local
        # DuplicateKeyError so game code sees ONE type regardless of engine
        import pymongo.errors

        try:
            self._db[col].insert_one(doc)
        except pymongo.errors.DuplicateKeyError as e:
            raise DuplicateKeyError(
                f"duplicate _id {doc['_id']!r} in {col!r}") from e
        return doc["_id"]

    def find(self, col: str, query: dict | None = None,
             limit: int = 0, sort: str | None = None) -> list[dict]:
        cur = self._db[col].find(query or {})
        if sort:
            cur = cur.sort(sort.lstrip("+-"), -1 if sort.startswith("-") else 1)
        if limit:
            cur = cur.limit(limit)
        return list(cur)

    def find_one(self, col: str, query: dict | None = None) -> dict | None:
        return self._db[col].find_one(query or {})

    def find_id(self, col: str, _id: str) -> dict | None:
        return self._db[col].find_one({"_id": _id})

    def count(self, col: str, query: dict | None = None) -> int:
        return self._db[col].count_documents(query or {})

    def update(self, col: str, query: dict, update: dict,
               multi: bool = False, upsert: bool = False) -> int:
        if not any(k.startswith("$") for k in update):
            res = self._db[col].replace_one(query, update, upsert=upsert)
        elif multi:
            res = self._db[col].update_many(query, update, upsert=upsert)
        else:
            res = self._db[col].update_one(query, update, upsert=upsert)
        # matched (not modified) count mirrors DocStore.update's return
        return res.matched_count + (1 if res.upserted_id is not None else 0)

    def update_id(self, col: str, _id: str, update: dict) -> int:
        return self.update(col, {"_id": _id}, update)

    def upsert_id(self, col: str, _id: str, update: dict) -> int:
        return self.update(col, {"_id": _id}, update, upsert=True)

    def remove(self, col: str, query: dict, multi: bool = True) -> int:
        if multi:
            return self._db[col].delete_many(query).deleted_count
        return self._db[col].delete_one(query).deleted_count

    def remove_id(self, col: str, _id: str) -> int:
        return self._db[col].delete_one({"_id": _id}).deleted_count

    def drop_collection(self, col: str):
        self._db.drop_collection(col)

    def ensure_index(self, col: str, spec: str):
        self._db[col].create_index(spec)

    def indexes(self, col: str) -> list[str]:
        return sorted(self._db[col].index_information())

    def close(self):
        self._db.client.close()


# -- async wrapper (the reference's dev-facing surface) ----------------------

class GWDoc:
    """Async document DB for game code: every op runs in submission order on
    one ordered worker; callbacks are posted to the logic thread (reference:
    gwmongo.go's op/callback contract)."""

    def __init__(self, path: str | None = None,
                 post: Callable | None = None, engine=None):
        self._store = engine if engine is not None else DocStore(path)
        self._worker = OrderedWorker("gwdoc", post=post)

    def _submit(self, fn, callback):
        self._worker.submit(fn, callback)

    def insert(self, col: str, doc: dict, callback: Callable | None = None):
        self._submit(lambda: self._store.insert(col, doc), callback)

    def find(self, col: str, query: dict | None = None,
             callback: Callable | None = None, limit: int = 0,
             sort: str | None = None):
        self._submit(lambda: self._store.find(col, query, limit, sort),
                     callback)

    def find_one(self, col: str, query: dict | None = None,
                 callback: Callable | None = None):
        self._submit(lambda: self._store.find_one(col, query), callback)

    def find_id(self, col: str, _id: str,
                callback: Callable | None = None):
        self._submit(lambda: self._store.find_id(col, _id), callback)

    def count(self, col: str, query: dict | None = None,
              callback: Callable | None = None):
        self._submit(lambda: self._store.count(col, query), callback)

    def update(self, col: str, query: dict, update: dict,
               callback: Callable | None = None, multi: bool = False,
               upsert: bool = False):
        self._submit(
            lambda: self._store.update(col, query, update, multi, upsert),
            callback,
        )

    def update_id(self, col: str, _id: str, update: dict,
                  callback: Callable | None = None):
        self._submit(lambda: self._store.update_id(col, _id, update),
                     callback)

    def upsert_id(self, col: str, _id: str, update: dict,
                  callback: Callable | None = None):
        self._submit(lambda: self._store.upsert_id(col, _id, update),
                     callback)

    def remove(self, col: str, query: dict,
               callback: Callable | None = None, multi: bool = True):
        self._submit(lambda: self._store.remove(col, query, multi), callback)

    def remove_id(self, col: str, _id: str,
                  callback: Callable | None = None):
        self._submit(lambda: self._store.remove_id(col, _id), callback)

    def drop_collection(self, col: str, callback: Callable | None = None):
        self._submit(lambda: self._store.drop_collection(col), callback)

    def ensure_index(self, col: str, spec: str,
                     callback: Callable | None = None):
        self._submit(lambda: self._store.ensure_index(col, spec), callback)

    def close(self):
        self._worker.close()
        self._store.close()
