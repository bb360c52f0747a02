"""The port's mysql family (goworld_tpu_torch.ext.db.mysqlwire,
``dbutil.connect_mysql``, the ``mysql`` storage and kvdb backends) against
the JAX package's.

``escape_literal`` and the native-password scramble equal the JAX
functions; the bytes a client sends for a fixed session, captured by a
relay in front of the server, equal the JAX client's; each package's
client against each package's ``MiniMySQLServer`` runs one script with
the same results (a column that mixes bytes and str included); the
backends over the wire leave the same rows."""

import socket
import threading
import time

import numpy as np
import pytest

from goworld_tpu.ext.db import mysqlwire as jmy
from goworld_tpu.kvdb import backends as jkv
from goworld_tpu.storage import backends as jst
from goworld_tpu_torch.ext.db import dbutil, mysqlwire as my
from goworld_tpu_torch.kvdb import backends as kv
from goworld_tpu_torch.storage import backends as st
from test_torch_mongowire import (kvdb_script, outcome,
                                  storage_script)


@pytest.fixture(scope="module")
def servers():
    """One MiniMySQLServer of each package for the whole module."""
    srv = {"port": my.MiniMySQLServer(), "jax": jmy.MiniMySQLServer()}
    yield srv
    for s in srv.values():
        s.close()


def test_escape_literal_and_scramble_equal_jax():
    rng = np.random.default_rng(31)
    table = [None, 0, 7, -3, 1 << 40, True, False, 0.1, -2.5e300, "",
             "it's", "a\\'b", "trailing\\", "中文'é", b"", b"\x00\xff'",
             bytearray(b"ab"), memoryview(b"\x01"), object(), [1], 1j]
    table += [rng.bytes(int(rng.integers(0, 20))) for _ in range(20)]
    table += ["".join(chr(int(c)) for c in rng.integers(0x20, 0x250, 9))
              for _ in range(20)]
    for v in table:
        assert outcome(my.escape_literal, v) == outcome(jmy.escape_literal, v)
    assert my.escape_literal("it's") == "'it''s'"
    assert outcome(my.escape_literal, object()) == ("raise", "MySQLWireError")
    for pwd in ("", "secret", "pässwörd"):
        nonce = rng.bytes(20)
        assert my._native_scramble(pwd, nonce) == \
            jmy._native_scramble(pwd, nonce)
    for n in (0, 250, 251, 65535, 65536, 1 << 24, 1 << 40):
        enc = my._lenenc_int(n)
        assert enc == jmy._lenenc_int(n)
        assert my._read_lenenc_int(enc, 0) == (n, len(enc))


class Relay:
    """A TCP relay in front of a server that records, per accepted
    connection, every byte the client sent."""

    def __init__(self, upstream_port):
        self.up = upstream_port
        self.ls = socket.socket()
        self.ls.bind(("127.0.0.1", 0))
        self.ls.listen(4)
        self.port = self.ls.getsockname()[1]
        self.sent: list[bytearray] = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.ls.accept()
            except OSError:
                return
            s = socket.create_connection(("127.0.0.1", self.up))
            rec = bytearray()
            self.sent.append(rec)
            threading.Thread(target=self._pump, args=(c, s, rec),
                             daemon=True).start()
            threading.Thread(target=self._pump, args=(s, c, None),
                             daemon=True).start()

    @staticmethod
    def _pump(src, dst, rec):
        try:
            while True:
                b = src.recv(65536)
                if not b:
                    break
                if rec is not None:
                    rec += b
                dst.sendall(b)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        self.ls.close()


def test_request_bytes_equal_jax(servers):
    relay = Relay(servers["port"].port)
    try:
        for mod in (my, jmy):
            c = mod.MySQLWireClient(port=relay.port, user="gw",
                                    database="main")
            cur = c.cursor()
            cur.execute("CREATE TABLE IF NOT EXISTS req "
                        "(k VARCHAR(32) PRIMARY KEY, v BLOB)")
            cur.execute("REPLACE INTO req (k, v) VALUES (%s, %s)",
                        ("key'1", b"\x00\x01"))
            cur.execute("SELECT k, v FROM req WHERE k = %s", ("key'1",))
            assert cur.fetchall() == [("key'1", b"\x00\x01")]
            c.close()
        quit_pkt = b"\x01\x00\x00\x00\x01"  # COM_QUIT, the last request
        t_end = time.monotonic() + 5.0
        while time.monotonic() < t_end and not (len(relay.sent) == 2 and all(
                r.endswith(quit_pkt) for r in relay.sent)):
            time.sleep(0.01)
        port_bytes, jax_bytes = relay.sent
        assert bytes(port_bytes) == bytes(jax_bytes)
        assert b"NO_BACKSLASH_ESCAPES" in port_bytes
        assert b"x'0001'" in port_bytes
    finally:
        relay.close()


def wire_script(client_mod, server, table):
    out = []
    c = client_mod.MySQLWireClient(port=server.port)
    out.append(c.server_version.startswith("8.0"))
    cur = c.cursor()
    cur.execute(f"CREATE TABLE IF NOT EXISTS {table} "
                "(k VARCHAR(32) PRIMARY KEY, v BLOB, n TEXT)")
    cur.execute(f"REPLACE INTO {table} (k, v, n) VALUES (%s, %s, %s)",
                ("key'1", b"\x00\x01binary", None))
    for evil in ("trailing\\", "a\\'b", "c:\\dir\\n", "中文"):
        cur.execute(f"REPLACE INTO {table} (k, v, n) VALUES (%s, %s, %s)",
                    (evil, evil.encode("utf-8"), evil))
    cur.execute(f"SELECT k, v, n FROM {table} ORDER BY k")
    out.append(cur.fetchall())
    cur.execute(f"SELECT COUNT(*), SUM(LENGTH(v)) FROM {table}")
    out.append(cur.fetchone())
    cur.execute(f"SELECT 1 FROM {table} WHERE k = %s", ("missing",))
    out.append(cur.fetchone())
    out.append(outcome(cur.execute, "SELECT syntax error from from"))
    out.append(outcome(cur.execute, "SELECT %s, %s", (1,)))
    # a column mixing bytes and str decodes as bytes on every row
    cur.execute(f"CREATE TABLE IF NOT EXISTS {table}_mixed (k TEXT, v BLOB)")
    cur.execute(f"REPLACE INTO {table}_mixed (k, v) VALUES (%s, %s)",
                ("a", b"\xff\x00"))
    with server._srv.db_lock:
        server._srv.db.execute(
            f"INSERT INTO {table}_mixed (k, v) VALUES ('b', 'plain-text')")
    cur.execute(f"SELECT v FROM {table}_mixed ORDER BY k")
    out.append(cur.fetchall())
    c.close()
    return out


def test_wire_interop_both_ways(servers):
    runs = {}
    for cname, cmod in (("port", my), ("jax", jmy)):
        for sname, srv in servers.items():
            runs[cname, sname] = wire_script(cmod, srv, f"t_{cname}_{sname}")
    want = runs["jax", "jax"]
    for key, got in runs.items():
        assert got == want, key
    assert want[0] and want[1][0] == ("a\\'b", b"a\\'b", "a\\'b")
    assert want[2][0] == 5 and want[3] is None
    assert want[4] == want[5] == ("raise", "MySQLWireError")
    assert want[6] == [(b"\xff\x00",), (b"plain-text",)]


def rows(server, table):
    with server._srv.db_lock:
        return sorted(server._srv.db.execute(
            f"SELECT * FROM {table}").fetchall())


def fresh(server):
    """Drop the backends' tables: the server holds one database."""
    with server._srv.db_lock:
        for t in ("entities", "kv"):
            server._srv.db.execute(f"DROP TABLE IF EXISTS {t}")


def test_backends_over_the_wire_leave_equal_rows(servers):
    for sname, srv in servers.items():
        results = {}
        for pkg, smod, kmod in (("port", st, kv), ("jax", jst, jkv)):
            fresh(srv)
            be = smod.new_entity_storage("mysql", port=srv.port)
            s = storage_script(be)
            be.close()
            be = kmod.new_kvdb_backend("mysql", port=srv.port)
            k = kvdb_script(be)
            be.close()
            results[pkg] = (s, k, rows(srv, "entities"), rows(srv, "kv"))
        assert results["port"] == results["jax"], sname
        s, k, ent, kvs = results["port"]
        assert s[2]["raw"] == b"\x00" and s[4] == ["e1", "e2"]
        assert k[-2] == [("a", "A"), ("ab", "AB"), ("b", "B")]
        assert len(ent) == 3 and ("unié", "中文") in kvs
    # the port's backend reads what the JAX backend left, and back
    srv = servers["jax"]
    be, other = st.MySQLEntityStorage(port=srv.port), \
        jst.MySQLEntityStorage(port=srv.port)
    other.write("Avatar", "x1", {"hp": 3})
    assert be.read("Avatar", "x1") == {"hp": 3}
    be.write("Avatar", "x2", {"hp": 4})
    assert other.read("Avatar", "x2") == {"hp": 4}
    be.close()
    other.close()


def test_connect_mysql_and_unreachable_server(servers):
    c = dbutil.connect_mysql("127.0.0.1", servers["port"].port, "root", "",
                             "goworld")
    assert isinstance(c, my.MySQLWireClient)
    cur = c.cursor()
    cur.execute("SELECT 1 + 1")
    assert cur.fetchone() == (2,)
    c.close()
    probe = socket.socket()  # a port nothing listens on
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    for make in (st.MySQLEntityStorage, kv.MySQLKVDB):
        with pytest.raises(OSError):
            make(port=port)
