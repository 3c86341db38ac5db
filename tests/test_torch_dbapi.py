"""The port's PEP-249 driver (heavydb_tpu_torch.client.dbapi) against the
JAX package's: each test of tests/test_dbapi.py runs with each package's
driver against a server of the same package in this process (the port's
on device="cpu"), the reference test's assertions hold on both sides, and
the port's fetched rows, descriptions, row counts and errors are the
reference's (tests/torch_server_pair.py)."""

import datetime

import pytest

from torch_server_pair import PORT, REF, SIDES, same, serving


def _both(scenario):
    got = {}
    for side in SIDES:
        with serving(side) as srv:
            host, port = srv.server_address
            got[side.name] = scenario(side.dbapi, host, port)
    assert same(got["port"], got["ref"]), (got["port"], got["ref"])


def test_module_globals():
    for name in ("apilevel", "paramstyle", "threadsafety"):
        assert getattr(PORT.dbapi, name) == getattr(REF.dbapi, name)
    dbapi = PORT.dbapi
    assert dbapi.apilevel == "2.0"
    assert dbapi.paramstyle == "pyformat"
    assert dbapi.threadsafety >= 1
    assert issubclass(dbapi.ProgrammingError, dbapi.DatabaseError)
    assert issubclass(dbapi.DatabaseError, dbapi.Error)
    for cls in ("Warning", "InterfaceError", "DataError", "OperationalError",
                "IntegrityError", "InternalError", "ProgrammingError", "NotSupportedError"):
        want = [b.__name__ for b in getattr(REF.dbapi, cls).__mro__]
        assert [b.__name__ for b in getattr(dbapi, cls).__mro__] == want
    assert {k: v.__name__ for k, v in dbapi._ERROR_MAP.items()} \
        == {k: v.__name__ for k, v in REF.dbapi._ERROR_MAP.items()}
    for t in ("STRING", "BINARY", "NUMBER", "DATETIME", "ROWID"):
        assert set(getattr(dbapi, t)) == set(getattr(REF.dbapi, t))
    for v in (None, True, 3, 2.5, "o'neil", datetime.date(2024, 3, 1),
              datetime.datetime(2024, 3, 1, 12, 30, 5), datetime.time(8, 15)):
        assert dbapi._quote(v) == REF.dbapi._quote(v)


def _execute_fetch(dbapi, host, port):
    with dbapi.connect(host=host, port=port) as con:
        cur = con.cursor()
        cur.execute("CREATE TABLE t (a INT, b TEXT)")
        cur.executemany("INSERT INTO t VALUES (%s, %s)", [(1, "x"), (2, "y"), (3, None)])
        cur.execute("SELECT a, b FROM t ORDER BY a")
        assert cur.description[0][0] == "a"
        assert cur.rowcount == 3
        out = [cur.description, cur.rowcount, cur.fetchone(), cur.fetchmany(1),
               cur.fetchall(), cur.fetchone()]
        assert out[2:] == [(1, "x"), [(2, "y")], [(3, None)], None]
        return out


def _params_and_quoting(dbapi, host, port):
    with dbapi.connect(host=host, port=port) as con:
        cur = con.cursor()
        cur.execute("CREATE TABLE q (a INT, s TEXT)")
        cur.execute("INSERT INTO q VALUES (%s, %s)", (5, "o'neil"))
        cur.execute("SELECT s FROM q WHERE a = %(a)s", {"a": 5})
        first = cur.fetchall()
        assert first == [("o'neil",)]
        cur.execute("SELECT count(*) FROM q WHERE s = %s", ("o'neil",))
        second = cur.fetchone()
        assert second == (1,)
        return [first, second, cur.description]


def _iteration_and_types(dbapi, host, port):
    with dbapi.connect(host=host, port=port) as con:
        cur = con.cursor()
        cur.execute("CREATE TABLE it2 (d DATE, v DOUBLE, ts TIMESTAMP)")
        cur.execute("INSERT INTO it2 VALUES (%s, %s, %s)",
                    (datetime.date(2024, 3, 1), 2.5, datetime.datetime(2024, 3, 1, 12, 30, 5)))
        cur.execute("SELECT d, v, ts FROM it2")
        rows = list(cur)
        assert len(rows) == 1
        assert str(rows[0][0]).startswith("2024-03-01")
        assert rows[0][1] == 2.5
        assert cur.description[1][1] in dbapi.NUMBER
        assert cur.description[0][1] in dbapi.DATETIME
        return [rows, cur.description]


def _errors_translate(dbapi, host, port):
    with dbapi.connect(host=host, port=port) as con:
        cur = con.cursor()
        out = []
        for q in ("SELECT * FROM missing_table", "NOT SQL AT ALL"):
            with pytest.raises(dbapi.ProgrammingError) as ei:
                cur.execute(q)
            out.append((type(ei.value).__name__, str(ei.value)))
        cur.execute("CREATE TABLE z (x INT)")
        cur.execute("INSERT INTO z VALUES (1)")
        with pytest.raises(dbapi.DataError) as ei:
            cur.execute("SELECT x / 0 FROM z")
        return out + [(type(ei.value).__name__, str(ei.value))]


def _closed_connection(dbapi, host, port):
    con = dbapi.connect(host=host, port=port)
    con.close()
    out = []
    for use in (con.cursor, con.commit):
        with pytest.raises(dbapi.InterfaceError) as ei:
            use()
        out.append(str(ei.value))
    return out


def _commit_noop_rollback_unsupported(dbapi, host, port):
    with dbapi.connect(host=host, port=port) as con:
        con.commit()
        with pytest.raises(dbapi.NotSupportedError) as ei:
            con.rollback()
        return [str(ei.value)]


SCENARIOS = {
    "execute_fetch": _execute_fetch, "params_and_quoting": _params_and_quoting,
    "iteration_and_types": _iteration_and_types, "errors_translate": _errors_translate,
    "closed_connection": _closed_connection,
    "commit_noop_rollback_unsupported": _commit_noop_rollback_unsupported,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_driver_scenario(name):
    _both(SCENARIOS[name])
