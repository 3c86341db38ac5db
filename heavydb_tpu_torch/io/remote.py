"""Remote foreign-storage transports: S3 object spooling and DB-API
(ODBC-role) imports.

Reference: DataMgr/ForeignStorage/ supports S3-backed delimited/parquet
foreign tables (files are downloaded into the local foreign-storage
cache before parsing) and ODBC foreign tables (a SELECT against a remote
RDBMS populates the chunks).  Parsing and ingest are host-side concerns
identical to the local wrappers, so remote sources reduce to (a)
materializing the object into a local spool file and (b) a row source
behind a DB-API cursor.  Both transports are pluggable.  The port has no
network transport of its own: an S3 path needs one installed with
register_s3_transport (a local-directory fixture in the tests, boto3 or
the like in a deployment), and without one it raises.
"""

from __future__ import annotations

import os
import urllib.parse
from typing import Callable, Optional

from heavydb_tpu_torch.errors import SqlError

# ---------------------------------------------------------------------------
# S3 (reference: AWS S3 FSI, DataMgr/OmniSciAwsSdk + ForeignStorage S3
# wrappers).  Transport signature: fn(bucket, key, dest_path, options) —
# must write the object's bytes to dest_path.
# ---------------------------------------------------------------------------

_s3_transport: Optional[Callable] = None


def register_s3_transport(fn: Optional[Callable]) -> None:
    """Install a custom S3 fetcher (tests use a local-directory fixture;
    deployments may plug boto3).  None removes it."""
    global _s3_transport
    _s3_transport = fn


def _default_s3_fetch(bucket: str, key: str, dest: str, options: dict):
    """No transport installed: the port opens no network connection of its
    own, so an S3 object is fetched only through register_s3_transport."""
    raise SqlError(
        f"S3 fetch failed for s3://{bucket}/{key}: no S3 transport is "
        "installed — install one with "
        "heavydb_tpu_torch.io.remote.register_s3_transport"
    )


def is_s3_uri(path: str) -> bool:
    return path.startswith("s3://")


def spool_s3(path: str, spool_dir: str, options: dict) -> str:
    """Materialize s3://bucket/key into spool_dir and return the local
    path (reference: FSI downloads S3 objects into the disk cache before
    the delimited/parquet wrapper parses them).  Re-fetches only when no
    spool file exists; REFRESH FOREIGN TABLES evicts to force re-fetch."""
    u = urllib.parse.urlparse(path)
    bucket, key = u.netloc, u.path.lstrip("/")
    if not bucket or not key:
        raise SqlError(f"malformed S3 uri {path!r}")
    os.makedirs(spool_dir, exist_ok=True)
    safe = key.replace("/", "__")
    dest = os.path.join(spool_dir, f"{bucket}__{safe}")
    if not os.path.exists(dest):
        tmp = dest + ".part"
        fetch = _s3_transport or _default_s3_fetch
        fetch(bucket, key, tmp, options)
        os.replace(tmp, dest)
    return dest


def evict_spool(path: str, spool_dir: str) -> None:
    u = urllib.parse.urlparse(path)
    safe = u.path.lstrip("/").replace("/", "__")
    dest = os.path.join(spool_dir, f"{u.netloc}__{safe}")
    try:
        os.unlink(dest)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# DB-API row source (reference: ODBC FSI wrapper — a SELECT against a
# remote RDBMS populates the foreign table's chunks).  Python's DB-API is
# the portable analogue of ODBC; sqlite3 ships in-process and any
# installed driver (psycopg2, pyodbc, ...) plugs in by module name or a
# registered connection factory.
# ---------------------------------------------------------------------------

_dbapi_factories = {}


def register_dbapi_factory(name: str, fn: Callable) -> None:
    """Register a named connection factory: fn(options) -> DB-API
    connection.  CREATE SERVER ... WITH (dbapi='<name>', ...) uses it."""
    _dbapi_factories[name] = fn


def dbapi_connect(options: dict):
    name = options.get("dbapi", "sqlite3")
    fn = _dbapi_factories.get(name)
    if fn is not None:
        return fn(options)
    if name == "sqlite3":
        import sqlite3

        database = options.get("database")
        if not database:
            raise SqlError("sql_select server requires a database option")
        return sqlite3.connect(database)
    # generic: import the named DB-API module; connect kwargs come from
    # the connection_string option (k=v;k=v) like an ODBC DSN
    try:
        import importlib

        mod = importlib.import_module(name)
    except ImportError:
        raise SqlError(
            f"DB-API driver {name!r} not installed; register a factory "
            "with heavydb_tpu_torch.io.remote.register_dbapi_factory"
        )
    conn_str = options.get("connection_string", "")
    kwargs = {}
    for part in conn_str.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            kwargs[k.strip()] = v.strip()
    return mod.connect(**kwargs)


def dbapi_query(options: dict, table_options: dict):
    """Run the foreign table's SELECT and return (column_names, rows)."""
    sql = table_options.get("sql_select")
    if not sql:
        src = table_options.get("remote_table")
        if not src:
            raise SqlError(
                "sql_select foreign table requires sql_select or "
                "remote_table option"
            )
        sql = f"SELECT * FROM {src}"
    conn = dbapi_connect(options)
    try:
        cur = conn.cursor()
        cur.execute(sql)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
    finally:
        conn.close()
    return names, rows
