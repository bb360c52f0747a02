"""MongoDB wire protocol (OP_MSG): in-repo driver + hermetic server.

Without pymongo the mongo backends' driver-facing code (connection
handling, BSON type mapping) would run only against injected in-process
fakes.  This module closes that the way miniredis closes it for redis --
at the WIRE level:

  * :class:`MongoWireClient` -- a minimal real MongoDB driver: TCP socket,
    OP_MSG (opcode 2013) framing, BSON command documents (ext/db/bson).
    Exposes the pymongo-compatible subset the storage/kvdb backends use
    (``client[db][coll].insert_one/replace_one/find_one/find/
    count_documents/delete_one/delete_many``), so the backends run their
    REAL network path against any OP_MSG server -- an actual mongod, or:
  * :class:`MiniMongoServer` -- a hermetic OP_MSG server backed by the
    in-process minimongo store, speaking genuine BSON over genuine sockets
    (handshake ``hello``, ``insert``, ``update``, ``find`` with
    sort/limit/projection, ``delete``, ``count``, ``ping``).

The storage/kvdb mongodb backends fall back to MongoWireClient when
pymongo is absent, so ``StorageConfig(backend="mongodb")`` works end-to-end
without a mongo driver (tests/test_torch_mongowire.py drives it over a real
socket, against this server and the JAX package's).

Reference parity: engine/storage/backend/mongodb/mongodb.go and
kvdb/backend/kvdb_mongodb run against live mongod in CI; this is the
hermetic equivalent plus a usable driver.  The port's copy of the JAX
package's ``ext/db/mongowire.py``: the same OP_MSG bytes.
"""

from __future__ import annotations

import itertools
import socket
import socketserver
import struct
import threading

from . import bson
from .minimongo import DuplicateKeyError, MiniMongoClient

_HDR = struct.Struct("<iiii")
_OP_MSG = 2013
_FLAGS = struct.Struct("<I")


class MongoWireError(Exception):
    pass


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("mongo connection closed")
        buf += chunk
    return bytes(buf)


def _read_msg(sock: socket.socket) -> tuple[int, int, dict]:
    """Read one OP_MSG; returns (request_id, response_to, command_doc).
    Kind-1 document sequences are folded into the command doc under their
    identifier (the standard client option for insert/update/delete)."""
    hdr = _read_exact(sock, 16)
    length, req_id, resp_to, opcode = _HDR.unpack(hdr)
    if length < 16 or length > 48 * 1024 * 1024:
        raise MongoWireError(f"bad message length {length}")
    body = _read_exact(sock, length - 16)
    if opcode != _OP_MSG:
        raise MongoWireError(f"unsupported opcode {opcode} (only OP_MSG)")
    (flags,) = _FLAGS.unpack_from(body, 0)
    if flags & 0x1:  # checksumPresent
        body = body[:-4]
    at = 4
    doc: dict | None = None
    while at < len(body):
        kind = body[at]
        at += 1
        if kind == 0:
            d, at = bson.decode_at(body, at)
            if doc is None:
                doc = d
            else:
                doc.update(d)
        elif kind == 1:
            (sz,) = struct.unpack_from("<i", body, at)
            end = at + sz
            at += 4
            ident_end = body.index(b"\x00", at)
            ident = body[at:ident_end].decode("utf-8")
            at = ident_end + 1
            docs = []
            while at < end:
                d, at = bson.decode_at(body, at)
                docs.append(d)
            if doc is None:
                doc = {}
            doc[ident] = docs
        else:
            raise MongoWireError(f"unknown OP_MSG section kind {kind}")
    if doc is None:
        raise MongoWireError("OP_MSG carried no body section")
    return req_id, resp_to, doc


def _write_msg(sock: socket.socket, req_id: int, resp_to: int,
               doc: dict) -> None:
    body = _FLAGS.pack(0) + b"\x00" + bson.encode(doc)
    sock.sendall(_HDR.pack(16 + len(body), req_id, resp_to, _OP_MSG) + body)


# ---------------------------------------------------------------------------
# client (the in-repo driver)
# ---------------------------------------------------------------------------


class _WireCursor:
    """Lazy find(): accumulates sort/limit, issues the command on iteration
    (server-side sort/limit -- NOT client-side -- so the wire path is the
    one exercised)."""

    def __init__(self, coll: "_WireCollection", flt: dict | None,
                 projection: dict | None):
        self._coll = coll
        self._flt = flt or {}
        self._proj = projection
        self._sort: tuple[str, int] | None = None
        self._limit = 0

    def sort(self, key: str, direction: int = 1) -> "_WireCursor":
        self._sort = (key, direction)
        return self

    def limit(self, n: int) -> "_WireCursor":
        self._limit = n
        return self

    def __iter__(self):
        cmd = {"find": self._coll.name, "filter": self._flt}
        if self._proj is not None:
            cmd["projection"] = self._proj
        if self._sort is not None:
            cmd["sort"] = {self._sort[0]: self._sort[1]}
        if self._limit:
            cmd["limit"] = self._limit
        client = self._coll._db._client
        db = self._coll._db.name
        reply = client._command(db, cmd)
        cursor = reply["cursor"]
        docs = list(cursor["firstBatch"])
        # a real mongod caps firstBatch (~101 docs) and hands back a live
        # cursor id; drain it with getMore or large collections silently
        # truncate (MiniMongoServer always returns id 0)
        while cursor.get("id"):
            reply = client._command(db, {"getMore": cursor["id"],
                                         "collection": self._coll.name})
            cursor = reply["cursor"]
            docs.extend(cursor.get("nextBatch", []))
        return iter(docs)


class _WireCollection:
    def __init__(self, db: "_WireDatabase", name: str):
        self._db = db
        self.name = name

    def insert_one(self, doc: dict) -> None:
        r = self._db._cmd({"insert": self.name, "documents": [doc]})
        errs = r.get("writeErrors")
        if errs:
            if errs[0].get("code") == 11000:
                raise DuplicateKeyError(errs[0].get("errmsg", "duplicate key"))
            raise MongoWireError(str(errs[0]))

    def _update(self, flt: dict, u: dict, upsert: bool) -> None:
        r = self._db._cmd({
            "update": self.name,
            "updates": [{"q": flt, "u": u, "upsert": upsert,
                         "multi": False}],
        })
        # a real mongod reports per-statement failures as ok:1 +
        # writeErrors; swallowing them would turn failed updates into
        # silent no-ops (the hermetic server raises ok:0 instead)
        errs = r.get("writeErrors")
        if errs:
            if errs[0].get("code") == 11000:
                raise DuplicateKeyError(
                    errs[0].get("errmsg", "duplicate key"))
            raise MongoWireError(str(errs[0]))

    def replace_one(self, flt: dict, doc: dict, upsert: bool = False) -> None:
        self._update(flt, doc, upsert)

    def update_one(self, flt: dict, update: dict,
                   upsert: bool = False) -> None:
        """Operator update (``{"$set": {...}}`` etc.) -- same wire command
        as replace_one; the ``u`` document's ``$``-prefixed keys select the
        operator path on the server (real mongod and the hermetic server
        alike)."""
        if not update or not all(k.startswith("$") for k in update):
            # pymongo's contract: a plain document here would silently
            # take the replacement path and wipe the other fields
            raise ValueError("update_one requires $-operator documents "
                             "(use replace_one for full replacement)")
        self._update(flt, update, upsert)

    def find_one(self, flt: dict | None = None) -> dict | None:
        for d in _WireCursor(self, flt, None).limit(1):
            return d
        return None

    def find(self, flt: dict | None = None,
             projection: dict | None = None) -> _WireCursor:
        return _WireCursor(self, flt, projection)

    def count_documents(self, flt: dict | None = None,
                        limit: int | None = None) -> int:
        cmd = {"count": self.name, "query": flt or {}}
        if limit:
            cmd["limit"] = limit
        return int(self._db._cmd(cmd)["n"])

    def delete_one(self, flt: dict) -> None:
        self._db._cmd({"delete": self.name,
                       "deletes": [{"q": flt, "limit": 1}]})

    def delete_many(self, flt: dict) -> None:
        self._db._cmd({"delete": self.name,
                       "deletes": [{"q": flt, "limit": 0}]})


class _WireDatabase:
    def __init__(self, client: "MongoWireClient", name: str):
        self._client = client
        self.name = name

    def __getitem__(self, coll: str) -> _WireCollection:
        return _WireCollection(self, coll)

    def _cmd(self, cmd: dict) -> dict:
        return self._client._command(self.name, cmd)


class MongoWireClient:
    """Minimal MongoDB driver over OP_MSG.  Thread-safe (one socket, one
    in-flight command at a time under a lock -- the storage/kvdb services
    serialize their ops anyway)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 connect_timeout: float = 5.0):
        self._addr = (host, port)
        self._timeout = connect_timeout
        self._lock = threading.Lock()
        self._req_ids = itertools.count(1)
        self._sock: socket.socket | None = None
        self._connect()

    def _connect(self) -> None:
        # lock-free on purpose: called from __init__ and from inside
        # _command's locked region (reconnect) -- taking the lock here would
        # self-deadlock
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.settimeout(30.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        try:
            hello = self._roundtrip({"hello": 1, "$db": "admin"})
        except (ConnectionError, OSError):
            # handshake died after the socket was assigned: close it here or
            # the dead fd lingers until the next command's failure path
            self._close_dead_sock()
            raise
        if not hello.get("ok"):
            # rejected (auth/version): the half-initialized socket must not
            # stay assigned -- the next command would happily send on it
            self._close_dead_sock()
            raise MongoWireError(f"handshake rejected: {hello}")
        self.server_info = hello

    def __getitem__(self, db: str) -> _WireDatabase:
        return _WireDatabase(self, db)

    # commands a transparent retry cannot double-apply.  getMore is read-only
    # but its server-side cursor dies with the connection, so retrying it is
    # pointless; writes (insert/update/delete) whose reply was lost mid-read
    # may already have applied -- re-sending could double-apply or surface a
    # spurious DuplicateKeyError, so their retries belong to the storage
    # service's loop, which owns the operation's idempotency story.
    _RETRYABLE = frozenset({"find", "count", "hello", "ping", "ismaster"})

    def _command(self, db: str, cmd: dict) -> dict:
        doc = dict(cmd)
        doc["$db"] = db
        with self._lock:
            if self._sock is None:
                # a previous command died mid-flight and closed the socket;
                # nothing is in flight NOW, so reconnecting before the send
                # is safe for every command -- this is how a caller's retry
                # of a non-retryable write actually reaches the server again
                self._connect()
            try:
                reply = self._roundtrip(doc)
            except (ConnectionError, OSError):
                # the socket is dead either way: close it before any
                # reconnect replaces it (fd leak otherwise)
                self._close_dead_sock()
                if next(iter(cmd)) not in self._RETRYABLE:
                    raise
                # one transparent reconnect (the storage service's retry
                # loop handles longer outages)
                self._connect()
                try:
                    reply = self._roundtrip(doc)
                except (ConnectionError, OSError):
                    # the retry's fresh socket is just as dead; close it
                    # too or its fd leaks until the NEXT command fails
                    self._close_dead_sock()
                    raise
        if not reply.get("ok"):
            raise MongoWireError(
                f"command {next(iter(cmd))!r} failed: "
                f"{reply.get('errmsg', reply)}")
        return reply

    def _close_dead_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, doc: dict) -> dict:
        if self._sock is None:
            raise ConnectionError("not connected")
        req_id = next(self._req_ids)
        _write_msg(self._sock, req_id, 0, doc)
        _rid, resp_to, reply = _read_msg(self._sock)
        if resp_to != req_id:
            raise MongoWireError(
                f"reply to {resp_to}, expected {req_id} (protocol desync)")
        return reply

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None


# ---------------------------------------------------------------------------
# server (hermetic stand-in for mongod)
# ---------------------------------------------------------------------------


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        store: MiniMongoClient = self.server.store  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                req_id, _resp_to, cmd = _read_msg(sock)
                reply = self._dispatch(store, cmd)
                _write_msg(sock, next(self.server.req_ids), req_id, reply)
        except (ConnectionError, OSError):
            pass

    def _dispatch(self, store: MiniMongoClient, cmd: dict) -> dict:
        name = next(iter(cmd))
        db = cmd.get("$db", "admin")
        try:
            if name in ("hello", "ismaster", "isMaster"):
                return {"ok": 1.0, "isWritablePrimary": True,
                        "maxWireVersion": 17, "minWireVersion": 0,
                        "maxBsonObjectSize": 16 * 1024 * 1024}
            if name in ("ping", "endSessions"):
                return {"ok": 1.0}
            coll = store[db][cmd[name]]
            if name == "insert":
                n = 0
                errs = []
                for i, doc in enumerate(cmd.get("documents", [])):
                    try:
                        coll.insert_one(doc)
                        n += 1
                    except DuplicateKeyError as e:
                        errs.append({"index": i, "code": 11000,
                                     "errmsg": str(e)})
                out = {"n": n, "ok": 1.0}
                if errs:
                    out["writeErrors"] = errs
                return out
            if name == "update":
                n = 0
                errs = []
                for i, u in enumerate(cmd.get("updates", [])):
                    before = coll.count_documents(u.get("q", {}), limit=1)
                    ud = u.get("u", {})
                    try:
                        if any(k.startswith("$") for k in ud):
                            # operator document ($set/...), mongo's other
                            # update shape besides full replacement
                            coll.update_one(u.get("q", {}), ud,
                                            upsert=bool(u.get("upsert")))
                        else:
                            coll.replace_one(u.get("q", {}), ud,
                                             upsert=bool(u.get("upsert")))
                    except DuplicateKeyError as e:
                        # a real mongod reports an upsert-insert racing a
                        # unique index as ok:1 + writeErrors code 11000
                        errs.append({"index": i, "code": 11000,
                                     "errmsg": str(e)})
                        continue
                    n += max(before,
                             1 if u.get("upsert") else before)
                out = {"n": n, "nModified": n, "ok": 1.0}
                if errs:
                    out["writeErrors"] = errs
                return out
            if name == "find":
                cur = coll.find(cmd.get("filter") or {},
                                cmd.get("projection"))
                sort = cmd.get("sort")
                if sort:
                    k = next(iter(sort))
                    cur = cur.sort(k, int(sort[k]))
                limit = int(cmd.get("limit", 0))
                if limit:
                    cur = cur.limit(limit)
                batch = list(cur)
                return {"cursor": {"id": 0,
                                   "ns": f"{db}.{cmd[name]}",
                                   "firstBatch": batch},
                        "ok": 1.0}
            if name == "delete":
                n = 0
                for d in cmd.get("deletes", []):
                    q = d.get("q", {})
                    if int(d.get("limit", 0)) == 1:
                        if coll.count_documents(q, limit=1):
                            coll.delete_one(q)
                            n += 1
                    else:
                        n += coll.count_documents(q)
                        coll.delete_many(q)
                return {"n": n, "ok": 1.0}
            if name == "count":
                return {"n": coll.count_documents(
                    cmd.get("query") or {},
                    limit=int(cmd.get("limit", 0)) or None), "ok": 1.0}
            return {"ok": 0.0, "errmsg": f"no such command: '{name}'",
                    "code": 59}
        except Exception as e:  # malformed command must not kill the server
            return {"ok": 0.0, "errmsg": str(e), "code": 8}


class MiniMongoServer:
    """Hermetic OP_MSG server on 127.0.0.1:<port> (0 = ephemeral)."""

    def __init__(self, port: int = 0):
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Srv(("127.0.0.1", port), _Handler)
        self._srv.store = MiniMongoClient()  # type: ignore[attr-defined]
        self._srv.req_ids = itertools.count(1)  # type: ignore[attr-defined]
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="minimongod", daemon=True)
        self._thread.start()

    @property
    def store(self) -> MiniMongoClient:
        return self._srv.store  # type: ignore[attr-defined]

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
