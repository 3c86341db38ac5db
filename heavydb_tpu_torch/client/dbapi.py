"""PEP-249 (DB-API 2.0) driver over the heavydb_tpu_torch TCP protocol (the
port of heavydb_tpu/client/dbapi.py; the protocol is the same).

The reference ships a full JDBC driver (java/heavyaijdbc/, ~15k LoC) as
its standard-connector story; the Python ecosystem's equivalent is
DB-API — this module provides it over the same JSON-lines protocol the
interactive client uses, so SQLAlchemy-ish tooling, pandas.read_sql and
plain scripts can talk to the server without engine-specific APIs.

    import heavydb_tpu_torch.client.dbapi as dbapi
    con = dbapi.connect(host="127.0.0.1", port=6274, user="admin")
    cur = con.cursor()
    cur.execute("SELECT a, b FROM t WHERE a > %s", (10,))
    print(cur.fetchall())

paramstyle is 'pyformat' (%s / %(name)s) with client-side literal
substitution — the server has no prepared-statement protocol (neither
does the reference's Thrift sql_execute path).
"""

from __future__ import annotations

import datetime as _dt
from typing import Iterable, List, Optional

from heavydb_tpu_torch.client.client import Connection as _RawConnection
from heavydb_tpu_torch.client.client import ServerError

apilevel = "2.0"
threadsafety = 2  # threads may share the module and connections
paramstyle = "pyformat"


# ---- PEP-249 exception hierarchy ----
class Error(Exception):
    pass


class Warning(Exception):  # noqa: A001 — name mandated by PEP 249
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class DataError(DatabaseError):
    pass


class OperationalError(DatabaseError):
    pass


class IntegrityError(DatabaseError):
    pass


class InternalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


_ERROR_MAP = {
    "ParserError": ProgrammingError,
    "BinderError": ProgrammingError,
    "SqlError": ProgrammingError,
    "CatalogError": ProgrammingError,
    "PermissionError_": OperationalError,
    "NotSupported": NotSupportedError,
    "DivisionByZero": DataError,
    "QueryInterrupted": OperationalError,
    "WatchdogException": OperationalError,
}


def _translate(e: ServerError) -> Error:
    return _ERROR_MAP.get(e.type, DatabaseError)(str(e))


# ---- type objects (PEP-249 type comparison singletons) ----
class _DBAPIType(frozenset):
    def __eq__(self, other):
        return other in self or frozenset.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return frozenset.__hash__(self)


STRING = _DBAPIType({"TEXT", "VARCHAR", "CHAR"})
BINARY = _DBAPIType({"BLOB"})
NUMBER = _DBAPIType({
    "SMALLINT", "INT", "INTEGER", "BIGINT", "TINYINT",
    "FLOAT", "DOUBLE", "DECIMAL", "NUMERIC", "BOOLEAN",
})
DATETIME = _DBAPIType({"DATE", "TIME", "TIMESTAMP"})
ROWID = _DBAPIType({"BIGINT"})

Date = _dt.date
Time = _dt.time
Timestamp = _dt.datetime


def DateFromTicks(t):
    return _dt.date.fromtimestamp(t)


def TimeFromTicks(t):
    return _dt.datetime.fromtimestamp(t).time()


def TimestampFromTicks(t):
    return _dt.datetime.fromtimestamp(t)


def Binary(b):
    return bytes(b)


def _quote(v) -> str:
    """One literal → SQL text (client-side substitution)."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, _dt.datetime):
        return "'" + v.strftime("%Y-%m-%d %H:%M:%S") + "'"
    if isinstance(v, (_dt.date, _dt.time)):
        return "'" + v.isoformat() + "'"
    s = str(v)
    return "'" + s.replace("'", "''") + "'"


class Cursor:
    arraysize = 1

    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._rows: List[tuple] = []
        self._pos = 0
        self.description: Optional[List[tuple]] = None
        self.rowcount = -1
        self.lastrowid = None

    # ---- execution ----
    def execute(self, operation: str, parameters=None) -> "Cursor":
        if self._conn._raw is None:
            raise InterfaceError("cursor on a closed connection")
        if parameters is not None:
            if isinstance(parameters, dict):
                operation = operation % {
                    k: _quote(v) for k, v in parameters.items()
                }
            else:
                operation = operation % tuple(_quote(v) for v in parameters)
        try:
            res = self._conn._raw.sql(operation)
        except ServerError as e:
            raise _translate(e) from e
        self._rows = [tuple(r) for r in res.rows()]
        self._pos = 0
        self.rowcount = res.row_count if res.fields else -1
        self.description = [
            (f, t, None, None, None, None, None)
            for f, t in zip(res.fields, res.types)
        ] or None
        return self

    def executemany(self, operation: str, seq_of_parameters: Iterable):
        for p in seq_of_parameters:
            self.execute(operation, p)
        return self

    def callproc(self, *a, **k):
        raise NotSupportedError("stored procedures")

    # ---- fetch ----
    def fetchone(self) -> Optional[tuple]:
        if self._pos >= len(self._rows):
            return None
        r = self._rows[self._pos]
        self._pos += 1
        return r

    def fetchmany(self, size: Optional[int] = None) -> List[tuple]:
        n = size if size is not None else self.arraysize
        out = self._rows[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            r = self.fetchone()
            if r is None:
                return
            yield r

    # ---- no-ops / lifecycle ----
    def setinputsizes(self, sizes):
        pass

    def setoutputsize(self, size, column=None):
        pass

    def close(self):
        self._rows = []
        self.description = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Connection:
    def __init__(self, host: str, port: int, user: str, password: str):
        try:
            self._raw = _RawConnection(host, port, user=user,
                                       password=password)
        except ServerError as e:
            raise OperationalError(str(e)) from e
        except OSError as e:
            raise OperationalError(str(e)) from e

    def cursor(self) -> Cursor:
        if self._raw is None:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def commit(self):
        # statements auto-commit (reference: HeavyDB has no transactions;
        # its JDBC driver's commit() is a no-op the same way)
        if self._raw is None:
            raise InterfaceError("connection is closed")

    def rollback(self):
        raise NotSupportedError("transactions (auto-commit engine)")

    def close(self):
        if self._raw is not None:
            self._raw.close()
            self._raw = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(host: str = "127.0.0.1", port: int = 6274,
            user: str = "admin", password: str = "",
            **_ignored) -> Connection:
    return Connection(host, port, user, password)
