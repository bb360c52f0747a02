"""Shared helpers for the DB backend families (storage + kvdb).

One home for the driver-selection, address-parsing and config-mapping logic
both backend registries need, so neither package reaches into the other's
privates.
"""

from __future__ import annotations

import os


def parse_addrs(addrs: str | list[tuple[str, int]]) -> list[tuple[str, int]]:
    """'host:port,host:port' (or an already-parsed list) -> [(host, port)]."""
    if not isinstance(addrs, str):
        return list(addrs)
    out = []
    for part in addrs.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host, int(port)))
    return out


def db_name(db: int | str) -> str:
    """Database name from config: ``db`` may be a name or the numeric index
    the redis-style config carries."""
    return db if isinstance(db, str) and db else f"goworld{db or ''}"


def connect_mysql(host: str, port: int, user: str, password: str,
                  database: str):
    """Open a MySQL connection via whichever driver is installed, with
    autocommit on -- without it the first SELECT pins a REPEATABLE READ
    snapshot and a long-lived connection never sees other processes'
    committed writes."""
    try:
        import pymysql

        return pymysql.connect(host=host, port=port, user=user,
                               password=password, database=database,
                               autocommit=True)
    except ImportError:
        try:
            import mysql.connector

            conn = mysql.connector.connect(
                host=host, port=port, user=user, password=password,
                database=database,
            )
            conn.autocommit = True
            return conn
        except ImportError:
            # no external driver: the in-repo wire driver (real MySQL
            # protocol -- mysql_native_password deployments and the
            # hermetic MiniMySQLServer; see ext/db/mysqlwire)
            from .mysqlwire import MySQLWireClient

            return MySQLWireClient(host=host, port=port, user=user,
                                   password=password, database=database)


def backend_config_kwargs(cls, cfg, base_dir: str = ".") -> dict:
    """Constructor kwargs for a backend class from its config section.  The
    class declares its ``config_kind``:

      * "server"     -> host/port/db (redis, mongodb);
      * "sql_server" -> host/port/db/user/password (mysql);
      * "cluster"    -> addrs (redis_cluster), falling back to host:port;
      * default ("directory") -> directory under ``base_dir``.
    """
    kind = getattr(cls, "config_kind", "directory")
    if kind == "server":
        return {"host": cfg.host, "port": cfg.port, "db": cfg.db}
    if kind == "sql_server":
        return {"host": cfg.host, "port": cfg.port, "db": cfg.db,
                "user": cfg.user, "password": cfg.password}
    if kind == "cluster":
        return {"addrs": cfg.addrs or f"{cfg.host}:{cfg.port}"}
    return {"directory": os.path.join(base_dir, cfg.directory)}
