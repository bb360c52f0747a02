"""MySQL client/server wire protocol: in-repo driver + hermetic server.

Without pymysql or mysql.connector the mysql storage/kvdb backends would
run only against an injected DB-API shim, and their real network path
would never execute.  Same treatment as ext/db/mongowire, at the MySQL wire
level:

  * :class:`MySQLWireClient` -- a minimal real MySQL driver: 3-byte-length
    packet framing, HandshakeV10 -> HandshakeResponse41 with
    ``mysql_native_password`` scrambling (AuthSwitch handled), COM_QUERY
    text protocol with classic EOF framing.  DB-API enough for the
    backends: ``cursor()``, ``execute(sql, params)`` with ``%s``
    parameters, ``fetchone``/``fetchall``, ``close``.
  * :class:`MiniMySQLServer` -- a hermetic server speaking the same wire,
    executing queries against an in-memory sqlite engine (the dialect the
    backends emit -- CREATE TABLE IF NOT EXISTS / REPLACE INTO / SELECT --
    is common to both).

Parameters are interpolated client-side using ONLY constructs valid in
both real MySQL and sqlite: ``''`` doubling for strings, ``x'..'`` hex
literals for bytes, bare numbers, NULL.  MySQL's default sql_mode treats
backslash as an escape inside string literals (sqlite does not), so the
client pins ``NO_BACKSLASH_ESCAPES`` -- see __init__ -- at connect; after
that the hermetic server's sqlite parser and a real mysqld agree
byte-for-byte, including for parameters containing backslashes.

Column values decode as bytes for binary-charset BLOB columns and str
otherwise -- exactly the two shapes the backends consume (msgpack blobs
and key/id strings).

Reference parity: engine/storage/backend/mysql and kvdb/backend/kvdb_mysql
run against live MySQL in CI; this is the hermetic equivalent plus a
usable driver for ``mysql_native_password`` deployments.  The port's copy
of the JAX package's ``ext/db/mysqlwire.py``: the same request bytes.
"""

from __future__ import annotations

import hashlib
import socket
import socketserver
import sqlite3
import struct
import threading

_CLIENT_PROTOCOL_41 = 0x0200
_CLIENT_CONNECT_WITH_DB = 0x0008
_CLIENT_SECURE_CONNECTION = 0x8000
_CLIENT_PLUGIN_AUTH = 0x00080000

_COM_QUIT = 0x01
_COM_INIT_DB = 0x02
_COM_QUERY = 0x03
_COM_PING = 0x0E

_TYPE_VAR_STRING = 0xFD
_TYPE_BLOB = 0xFC
_TYPE_LONGLONG = 0x08
_TYPE_DOUBLE = 0x05
# the text protocol ships every value as a string; the DRIVER converts by
# declared column type, so numeric results (COUNT(*), SUM, int columns)
# come back as python numbers from a real mysqld and the hermetic server
# alike.  BIT (0x10) is deliberately absent: its text-protocol form is raw
# bytes, not decimal text.  Conversion failures fall back to the string
# (defensive: a server may declare a type its values don't parse as).
_INT_TYPES = frozenset({0x01, 0x02, 0x03, 0x08, 0x09, 0x0D})
_FLOAT_TYPES = frozenset({0x04, 0x05, 0x00, 0xF6})
_CHARSET_UTF8 = 33
_CHARSET_BINARY = 63


class MySQLWireError(Exception):
    pass


# -- framing ----------------------------------------------------------------


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("mysql connection closed")
        buf += chunk
    return bytes(buf)


def _read_packet(sock: socket.socket) -> tuple[int, bytes]:
    hdr = _read_exact(sock, 4)
    length = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
    return hdr[3], _read_exact(sock, length)


def _send_packet(sock: socket.socket, seq: int, payload: bytes) -> None:
    if len(payload) >= 0xFFFFFF:
        raise MySQLWireError("packet too large")
    sock.sendall(bytes((len(payload) & 0xFF, (len(payload) >> 8) & 0xFF,
                        (len(payload) >> 16) & 0xFF, seq & 0xFF)) + payload)


def _lenenc_int(v: int) -> bytes:
    if v < 0xFB:
        return bytes((v,))
    if v < 1 << 16:
        return b"\xfc" + struct.pack("<H", v)
    if v < 1 << 24:
        return b"\xfd" + struct.pack("<I", v)[:3]
    return b"\xfe" + struct.pack("<Q", v)


def _read_lenenc_int(buf: bytes, at: int) -> tuple[int, int]:
    c = buf[at]
    if c < 0xFB:
        return c, at + 1
    if c == 0xFC:
        return struct.unpack_from("<H", buf, at + 1)[0], at + 3
    if c == 0xFD:
        return int.from_bytes(buf[at + 1:at + 4], "little"), at + 4
    if c == 0xFE:
        return struct.unpack_from("<Q", buf, at + 1)[0], at + 9
    raise MySQLWireError(f"bad length-encoded int {c:#x}")


def _lenenc_bytes(b: bytes) -> bytes:
    return _lenenc_int(len(b)) + b


def _read_lenenc_bytes(buf: bytes, at: int) -> tuple[bytes | None, int]:
    if buf[at] == 0xFB:  # NULL
        return None, at + 1
    n, at = _read_lenenc_int(buf, at)
    return buf[at:at + n], at + n


def _native_scramble(password: str, nonce: bytes) -> bytes:
    """mysql_native_password: SHA1(pwd) XOR SHA1(nonce + SHA1(SHA1(pwd)))."""
    if not password:
        return b""
    p1 = hashlib.sha1(password.encode("utf-8")).digest()
    p2 = hashlib.sha1(p1).digest()
    mix = hashlib.sha1(nonce + p2).digest()
    return bytes(a ^ b for a, b in zip(p1, mix))


def escape_literal(v) -> str:
    """SQL literal valid in BOTH MySQL and sqlite (see module docstring)."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return "x'" + bytes(v).hex() + "'"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise MySQLWireError(f"cannot encode SQL parameter {type(v).__name__}")


# -- client -----------------------------------------------------------------


class _WireCursor:
    def __init__(self, conn: "MySQLWireClient"):
        self._conn = conn
        self._rows: list[tuple] = []
        self._pos = 0
        self.rowcount = -1

    def execute(self, sql: str, params=()):
        if params:
            parts = sql.split("%s")
            if len(parts) != len(params) + 1:
                raise MySQLWireError(
                    f"parameter count mismatch: {len(parts) - 1} markers, "
                    f"{len(params)} params")
            sql = "".join(
                p + (escape_literal(params[i]) if i < len(params) else "")
                for i, p in enumerate(parts))
        self._rows, self.rowcount = self._conn._query(sql)
        self._pos = 0
        return self

    def fetchone(self):
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchall(self):
        rows = self._rows[self._pos:]
        self._pos = len(self._rows)
        return rows


class MySQLWireClient:
    """Minimal MySQL driver (text protocol).  One socket, one in-flight
    query under a lock -- the storage/kvdb workers serialize anyway."""

    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 user: str = "root", password: str = "",
                 database: str = "", connect_timeout: float = 5.0):
        self._lock = threading.Lock()
        self._sock = socket.create_connection((host, port),
                                              timeout=connect_timeout)
        self._sock.settimeout(30.0)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._handshake(user, password, database)
        self.autocommit = True  # text-protocol autocommit is server default
        # Backslashes are escape characters under MySQL's default sql_mode
        # but literal under sqlite; ''-doubled literals would therefore
        # parse differently (a param ending in \ even breaks the quoting).
        # NO_BACKSLASH_ESCAPES aligns a real mysqld with sqlite so one byte
        # stream means the same thing in both; the hermetic server answers
        # SET with a plain OK.
        self._query(
            "SET SESSION sql_mode = CONCAT(@@sql_mode, "
            "',NO_BACKSLASH_ESCAPES')")

    # -- connection setup --------------------------------------------------
    def _handshake(self, user: str, password: str, database: str) -> None:
        seq, pkt = _read_packet(self._sock)
        if pkt[0] == 0xFF:
            raise MySQLWireError(f"server error: {pkt[9:].decode()}")
        if pkt[0] != 10:
            raise MySQLWireError(f"unsupported handshake v{pkt[0]}")
        at = 1
        end = pkt.index(b"\x00", at)
        self.server_version = pkt[at:end].decode()
        at = end + 1 + 4  # thread id
        nonce1 = pkt[at:at + 8]
        at += 8 + 1  # filler
        at += 2 + 1 + 2 + 2  # caps1, charset, status, caps2
        auth_len = pkt[at]
        at += 1 + 10  # reserved
        nonce2 = pkt[at:at + max(13, auth_len - 8)]
        nonce = (nonce1 + nonce2).rstrip(b"\x00")[:20]

        caps = (_CLIENT_PROTOCOL_41 | _CLIENT_SECURE_CONNECTION
                | _CLIENT_PLUGIN_AUTH)
        if database:
            caps |= _CLIENT_CONNECT_WITH_DB
        auth = _native_scramble(password, nonce)
        body = struct.pack("<IIB23x", caps, 1 << 24, _CHARSET_UTF8)
        body += user.encode("utf-8") + b"\x00"
        body += _lenenc_bytes(auth)
        if database:
            body += database.encode("utf-8") + b"\x00"
        body += b"mysql_native_password\x00"
        _send_packet(self._sock, seq + 1, body)

        seq, pkt = _read_packet(self._sock)
        if pkt[0] == 0xFE:  # AuthSwitchRequest
            end = pkt.index(b"\x00", 1)
            plugin = pkt[1:end].decode()
            if plugin != "mysql_native_password":
                raise MySQLWireError(f"unsupported auth plugin {plugin}")
            new_nonce = pkt[end + 1:].rstrip(b"\x00")[:20]
            _send_packet(self._sock, seq + 1,
                         _native_scramble(password, new_nonce))
            seq, pkt = _read_packet(self._sock)
        if pkt[0] == 0xFF:
            raise MySQLWireError(f"auth failed: {pkt[9:].decode()}")

    # -- DB-API surface ----------------------------------------------------
    def cursor(self) -> _WireCursor:
        return _WireCursor(self)

    def close(self) -> None:
        with self._lock:
            try:
                _send_packet(self._sock, 0, bytes((_COM_QUIT,)))
            except OSError:
                pass
            finally:
                self._sock.close()

    # -- wire --------------------------------------------------------------
    def _query(self, sql: str) -> tuple[list[tuple], int]:
        with self._lock:
            _send_packet(self._sock, 0,
                         bytes((_COM_QUERY,)) + sql.encode("utf-8"))
            _seq, pkt = _read_packet(self._sock)
            if pkt[0] == 0xFF:
                raise MySQLWireError(
                    f"query failed: {pkt[9:].decode('utf-8', 'replace')}")
            if pkt[0] == 0x00:  # OK: no result set
                affected, _ = _read_lenenc_int(pkt, 1)
                return [], affected
            ncols, _ = _read_lenenc_int(pkt, 0)
            col_meta = []
            for _ in range(ncols):
                _seq, cp = _read_packet(self._sock)
                col_meta.append(self._parse_column(cp))
            _seq, eof = _read_packet(self._sock)
            if eof[0] != 0xFE:
                raise MySQLWireError("missing EOF after column definitions")
            rows: list[tuple] = []
            while True:
                _seq, rp = _read_packet(self._sock)
                if rp[0] == 0xFE and len(rp) < 9:
                    break
                if rp[0] == 0xFF:
                    raise MySQLWireError(
                        f"row error: {rp[9:].decode('utf-8', 'replace')}")
                at = 0
                vals = []
                for ctype, charset in col_meta:
                    raw, at = _read_lenenc_bytes(rp, at)
                    if raw is None:
                        vals.append(None)
                    elif charset == _CHARSET_BINARY and ctype in (
                            _TYPE_BLOB, 0xF9, 0xFA, 0xFB):
                        vals.append(bytes(raw))
                    elif ctype in _INT_TYPES or ctype in _FLOAT_TYPES:
                        try:
                            vals.append(int(raw) if ctype in _INT_TYPES
                                        else float(raw))
                        except ValueError:
                            vals.append(raw.decode("utf-8"))
                    else:
                        vals.append(raw.decode("utf-8"))
                rows.append(tuple(vals))
            return rows, len(rows)

    @staticmethod
    def _parse_column(pkt: bytes) -> tuple[int, int]:
        at = 0
        for _ in range(6):  # catalog, schema, table, org_table, name, org
            raw, at = _read_lenenc_bytes(pkt, at)
        _n, at = _read_lenenc_int(pkt, at)  # fixed-length fields marker
        charset = struct.unpack_from("<H", pkt, at)[0]
        ctype = pkt[at + 6]
        return ctype, charset


# -- server -----------------------------------------------------------------

_SERVER_NONCE = b"goworld_tpu_salt_20b"  # 20 bytes, static (hermetic server)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            self._serve(sock)
        except (ConnectionError, OSError):
            pass

    def _serve(self, sock):
        # HandshakeV10 (auth accepted regardless -- hermetic test server)
        hs = bytearray()
        hs += b"\x0a" + b"8.0.0-minimysql\x00"
        hs += struct.pack("<I", 1)
        hs += _SERVER_NONCE[:8] + b"\x00"
        hs += struct.pack("<H", (_CLIENT_PROTOCOL_41
                                 | _CLIENT_SECURE_CONNECTION) & 0xFFFF)
        hs += bytes((_CHARSET_UTF8,)) + struct.pack("<H", 2)  # status
        hs += struct.pack("<H", _CLIENT_PLUGIN_AUTH >> 16)
        hs += bytes((21,)) + b"\x00" * 10
        hs += _SERVER_NONCE[8:] + b"\x00"
        hs += b"mysql_native_password\x00"
        _send_packet(sock, 0, bytes(hs))
        seq, _resp = _read_packet(sock)
        _send_packet(sock, seq + 1, self._ok())

        db = self.server.db  # type: ignore[attr-defined]
        lock = self.server.db_lock  # type: ignore[attr-defined]
        while True:
            _seq, pkt = _read_packet(sock)
            cmd = pkt[0]
            if cmd == _COM_QUIT:
                return
            if cmd in (_COM_PING, _COM_INIT_DB):
                _send_packet(sock, 1, self._ok())
                continue
            if cmd != _COM_QUERY:
                _send_packet(sock, 1, self._err(1047,
                                                f"unsupported command {cmd}"))
                continue
            sql = pkt[1:].decode("utf-8")
            if sql.lstrip()[:4].upper() == "SET ":
                # session knobs (sql_mode etc.) have no sqlite analog; the
                # semantics they pin (NO_BACKSLASH_ESCAPES) are already how
                # sqlite parses, so OK is the honest reply
                _send_packet(sock, 1, self._ok())
                continue
            try:
                with lock:
                    cur = db.cursor()
                    cur.execute(sql)
                    if cur.description is None:
                        _send_packet(sock, 1, self._ok(cur.rowcount))
                        continue
                    rows = cur.fetchall()
                    names = [d[0] for d in cur.description]
                self._send_resultset(sock, names, rows)
            except sqlite3.Error as e:
                _send_packet(sock, 1, self._err(1064, str(e)))

    @staticmethod
    def _ok(affected: int = 0) -> bytes:
        return (b"\x00" + _lenenc_int(max(affected, 0)) + _lenenc_int(0)
                + struct.pack("<HH", 2, 0))

    @staticmethod
    def _err(code: int, msg: str) -> bytes:
        return (b"\xff" + struct.pack("<H", code) + b"#HY000"
                + msg.encode("utf-8"))

    def _send_resultset(self, sock, names, rows):
        seq = 1
        _send_packet(sock, seq, _lenenc_int(len(names)))
        # column types inferred from the first non-null value per column
        types = []
        for i, name in enumerate(names):
            vals = [r[i] for r in rows if r[i] is not None]
            if vals and any(isinstance(v, bytes) for v in vals):
                # ANY bytes value makes the column BLOB: sqlite columns are
                # typeless, so a bytes/str mix must not declare VAR_STRING
                # (the driver would raw.decode('utf-8') the bytes rows); a
                # real mysqld serves a BLOB column's text rows as bytes too
                ctype, charset = _TYPE_BLOB, _CHARSET_BINARY
            elif vals and all(isinstance(v, int)
                              and not isinstance(v, bool) for v in vals):
                # declare what a real mysqld declares for integer results
                # so the driver's type-directed decode agrees byte-for-byte
                ctype, charset = _TYPE_LONGLONG, _CHARSET_UTF8
            elif vals and all(isinstance(v, (int, float))
                              and not isinstance(v, bool) for v in vals):
                # sqlite columns are typeless: a mixed int/float column
                # must declare DOUBLE, not the first row's type
                ctype, charset = _TYPE_DOUBLE, _CHARSET_UTF8
            else:
                ctype, charset = _TYPE_VAR_STRING, _CHARSET_UTF8
            types.append((ctype, charset))
            seq += 1
            col = (_lenenc_bytes(b"def") + _lenenc_bytes(b"")
                   + _lenenc_bytes(b"") + _lenenc_bytes(b"")
                   + _lenenc_bytes(name.encode()) + _lenenc_bytes(b"")
                   + bytes((0x0C,)) + struct.pack("<H", charset)
                   + struct.pack("<I", 1024) + bytes((ctype,))
                   + struct.pack("<H", 0) + bytes((0,)) + b"\x00\x00")
            _send_packet(sock, seq, col)
        seq += 1
        _send_packet(sock, seq, b"\xfe\x00\x00\x02\x00")  # EOF
        for row in rows:
            seq += 1
            out = bytearray()
            for v in row:
                if v is None:
                    out += b"\xfb"
                elif isinstance(v, bytes):
                    out += _lenenc_bytes(v)
                elif isinstance(v, str):
                    out += _lenenc_bytes(v.encode("utf-8"))
                else:
                    out += _lenenc_bytes(str(v).encode("utf-8"))
            _send_packet(sock, seq, bytes(out))
        seq += 1
        _send_packet(sock, seq, b"\xfe\x00\x00\x02\x00")  # EOF


class MiniMySQLServer:
    """Hermetic MySQL-wire server on 127.0.0.1:<port> (0 = ephemeral),
    backed by one in-memory sqlite database shared across connections."""

    def __init__(self, port: int = 0):
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Srv(("127.0.0.1", port), _Handler)
        self._srv.db = sqlite3.connect(  # type: ignore[attr-defined]
            ":memory:", check_same_thread=False, isolation_level=None)
        self._srv.db_lock = threading.Lock()  # type: ignore[attr-defined]
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="minimysqld", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
