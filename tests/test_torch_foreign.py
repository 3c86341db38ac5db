"""The port's foreign servers and tables against the JAX package.

The 10 cases of tests/test_foreign.py (delimited, parquet and regex
wrappers, REFRESH, read-only writes, custom servers, persisted
definitions, the disk cache and its invalidation, the scheduled refresh)
and the 8 of tests/test_foreign_remote.py (S3-spooled files through a
local-directory fixture transport, DB-API sources over sqlite3, a
registered DB-API factory), each run as one scenario through both
packages: the same rows and errors.  The port has no network transport:
an S3 path with none installed raises.

Every value is compared exactly, but sums of DOUBLE values within rtol
1e-9.
"""

import importlib
import os
import shutil
import sqlite3
import time

import pandas as pd
import pytest

from torch_pair import PORT, both, raises_in_both


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.pkg}.{name}")


def _csv(p, text="a,b,c\n1,x,1.5\n2,y,2.5\n3,x,3.5\n", name="data.csv"):
    os.makedirs(p, exist_ok=True)
    path = os.path.join(p, name)
    with open(path, "w") as f:
        f.write(text)
    return path


_FT = ("CREATE FOREIGN TABLE ft (a INT, b TEXT, c DOUBLE) "
       "SERVER default_local_delimited WITH (file_path='{}')")


# ---------------------------------------------------------------------------
# tests/test_foreign.py
# ---------------------------------------------------------------------------


def _delimited(pkg, p):
    db = pkg.connect()
    db.sql(_FT.format(_csv(p)))
    return db.sql("SELECT b, SUM(c) FROM ft GROUP BY b ORDER BY b").rows()


def _refresh(pkg, p):
    db = pkg.connect()
    f = _csv(p)
    db.sql(_FT.format(f))
    out = [db.sql("SELECT COUNT(*) FROM ft").scalar()]
    with open(f, "a") as fh:
        fh.write("4,z,9.0\n")
    out.append(db.sql("SELECT COUNT(*) FROM ft").scalar())  # the old snapshot
    db.sql("REFRESH FOREIGN TABLES ft")
    return out + [db.sql("SELECT COUNT(*), SUM(c) FROM ft").rows()]


def _read_only(pkg, p):
    db = pkg.connect()
    db.sql(_FT.format(_csv(p)))
    out = []
    for stmt in ["INSERT INTO ft VALUES (9, 'w', 0.0)", "UPDATE ft SET a = 0",
                 "DELETE FROM ft WHERE a = 1",
                 "INSERT INTO ft SELECT a, b, c FROM ft"]:
        with pytest.raises(pkg.errors.SqlError) as err:
            db.sql(stmt)
        out.append(str(err.value))
    with pytest.raises(pkg.errors.SqlError) as err:
        db.load_table("ft", {"a": [1], "b": ["q"], "c": [0.5]})
    return out + [str(err.value), db.sql("SELECT COUNT(*) FROM ft").scalar()]


def _parquet_inference(pkg, p):
    os.makedirs(p)
    pq = os.path.join(p, "d.parquet")
    pd.DataFrame({"k": [10, 20], "s": ["p", "q"]}).to_parquet(pq)
    db = pkg.connect()
    db.sql(f"CREATE FOREIGN TABLE fp SERVER default_local_parquet WITH (file_path='{pq}')")
    return db.sql("SELECT * FROM fp ORDER BY k").rows(), db.sql("DESCRIBE fp").rows()


def _custom_server(pkg, p):
    f = _csv(p)
    db = pkg.connect()
    db.sql(f"CREATE SERVER s1 FOREIGN DATA WRAPPER delimited_file "
           f"WITH (base_path='{os.path.dirname(f)}')")
    db.sql("CREATE FOREIGN TABLE ft2 (a INT, b TEXT, c DOUBLE) SERVER s1 "
           "WITH (file_path='data.csv')")
    out = [db.sql("SELECT COUNT(*) FROM ft2").scalar(), db.sql("SHOW SERVERS").rows()]
    db.sql("DROP TABLE ft2")
    db.sql("DROP SERVER s1")
    with pytest.raises(pkg.errors.SqlError) as err:
        db.sql("DROP SERVER s1")
    db.sql("DROP SERVER IF EXISTS s1")
    return out + [str(err.value), db.sql("SHOW SERVERS").rows()]


def _regex(pkg, p):
    log = _csv(p, "header\n2024-01-01 ERROR boom\n2024-01-02 INFO ok\nno match\n", "app.log")
    db = pkg.connect()
    db.sql(f"CREATE FOREIGN TABLE fl (d TEXT, lvl TEXT, msg TEXT) "
           f"SERVER default_local_regex_parsed "
           f"WITH (file_path='{log}', line_regex='(\\S+) (\\S+) (.*)')")
    return db.sql("SELECT d, lvl, msg FROM fl ORDER BY d NULLS LAST").rows()


def _persists_definition(pkg, p):
    f = _csv(p + "_src")
    db = pkg.connect(p)
    db.sql(_FT.format(f))
    out = [db.sql("SELECT COUNT(*) FROM ft").scalar()]
    del db
    with open(f, "a") as fh:  # the file grows while the database is down
        fh.write("4,z,9.0\n")
    return out + [pkg.connect(p).sql("SELECT COUNT(*), SUM(a) FROM ft").rows()]


def _disk_cache(pkg, p):
    src = _csv(p + "_src", "a,s\n1,x\n2,y\n3,x\n", "src.csv")
    db = pkg.connect(p)
    db.sql("CREATE SERVER cs FOREIGN DATA WRAPPER delimited_file "
           f"WITH (storage_type='LOCAL_FILE', base_path='{os.path.dirname(src)}')")
    db.sql("CREATE FOREIGN TABLE cft (a INT, s TEXT) SERVER cs WITH (file_path='src.csv')")
    out = [db.sql("SELECT sum(a) FROM cft").rows()]
    os.remove(src)
    db2 = pkg.connect(p)
    return out + [db2.sql("SELECT s, count(*) FROM cft GROUP BY s ORDER BY s").rows(),
                  db2.sql("SHOW SERVERS").rows()]


def _cache_invalidated(pkg, p):
    src = _csv(p + "_src", "a\n1\n2\n", "src2.csv")
    db = pkg.connect(p)
    db.sql("CREATE SERVER cs2 FOREIGN DATA WRAPPER delimited_file "
           f"WITH (storage_type='LOCAL_FILE', base_path='{os.path.dirname(src)}')")
    db.sql("CREATE FOREIGN TABLE cft2 (a INT) SERVER cs2 WITH (file_path='src2.csv')")
    out = [db.sql("SELECT count(*) FROM cft2").rows()]
    time.sleep(0.01)
    with open(src, "w") as fh:
        fh.write("a\n1\n2\n3\n4\n")
    return out + [pkg.connect(p).sql("SELECT count(*), sum(a) FROM cft2").rows()]


def _scheduled_refresh(pkg, p):
    refresh = _mod(pkg, "storage.refresh")
    out = [refresh.parse_interval(s) for s in ("30S", "2H", "1d")]
    out.append(refresh.next_refresh_time(
        {"refresh_timing_type": "SCHEDULED", "refresh_interval": "10S",
         "refresh_start_date_time": "1970-01-01T00:00:00+00:00"}, None, now=1005.0))
    out.append(refresh.next_refresh_time({"refresh_timing_type": "MANUAL"}, None, 0))
    f = _csv(p, "a\n1\n2\n", "feed.csv")
    db = pkg.connect()
    db.sql(f"CREATE SERVER s_sched FOREIGN DATA WRAPPER delimited_file "
           f"WITH (base_path='{os.path.dirname(f)}')")
    db.sql("CREATE FOREIGN TABLE ft_sched (a INT) SERVER s_sched WITH ("
           "file_path='feed.csv', refresh_timing_type='SCHEDULED', refresh_interval='1S')")
    out.append(db.sql("SELECT count(*) FROM ft_sched").rows())
    with open(f, "w") as fh:
        fh.write("a\n1\n2\n3\n")
    sched = db.refresh_scheduler
    now = time.time()
    out += [sched.poll(now), sched.poll(now + 2.0), db.sql("SELECT count(*) FROM ft_sched").rows()]
    db.sql("CREATE FOREIGN TABLE ft_man (a INT) SERVER s_sched WITH (file_path='feed.csv')")
    db.sql("SELECT count(*) FROM ft_man")
    return out + [sorted(t.name for t in sched.due_tables(now + 9999))]


# ---------------------------------------------------------------------------
# tests/test_foreign_remote.py
# ---------------------------------------------------------------------------


class _S3Fixture:
    """A local-directory S3 stand-in on a package's remote module:
    s3://bucket/key reads <root>/bucket/key."""

    def __init__(self, pkg, root):
        self.remote = _mod(pkg, "io.remote")
        self.root = root
        err = self.remote.SqlError

        def fetch(bucket, key, dest, options):
            src = os.path.join(root, bucket, key)
            if not os.path.exists(src):
                raise err(f"NoSuchKey: s3://{bucket}/{key}")
            shutil.copyfile(src, dest)

        self.fetch = fetch

    def __enter__(self):
        self.remote.register_s3_transport(self.fetch)
        return self

    def __exit__(self, *exc):
        self.remote.register_s3_transport(None)


def _s3_delimited(pkg, p):
    with _S3Fixture(pkg, os.path.join(p, "s3root")) as s3:
        _csv(os.path.join(s3.root, "mybucket", "data"), "k,v\n1,10.5\n2,20.5\n1,30.0\n",
             "fact.csv")
        db = pkg.connect()
        db.sql("CREATE SERVER s3srv FOREIGN DATA WRAPPER delimited_file "
               "WITH (s3_region = 'us-east-1')")
        db.sql("CREATE FOREIGN TABLE f3 (k INT, v DOUBLE) SERVER s3srv "
               "WITH (file_path = 's3://mybucket/data/fact.csv')")
        return db.sql("SELECT k, count(*), sum(v) FROM f3 GROUP BY k ORDER BY k").rows()


def _s3_refresh(pkg, p):
    with _S3Fixture(pkg, os.path.join(p, "s3root")) as s3:
        bucket = os.path.join(s3.root, "b2")
        _csv(bucket, "x\n1\n2\n", "t.csv")
        db = pkg.connect()
        db.sql("CREATE SERVER s3b FOREIGN DATA WRAPPER delimited_file")
        db.sql("CREATE FOREIGN TABLE fr (x INT) SERVER s3b WITH (file_path = 's3://b2/t.csv')")
        out = [db.sql("SELECT count(*) FROM fr").scalar()]
        _csv(bucket, "x\n1\n2\n3\n4\n", "t.csv")
        db.sql("REFRESH FOREIGN TABLES fr")
        return out + [db.sql("SELECT count(*), sum(x) FROM fr").rows()]


def _s3_missing(pkg, p):
    with _S3Fixture(pkg, os.path.join(p, "s3root")):
        db = pkg.connect()
        db.sql("CREATE SERVER s3c FOREIGN DATA WRAPPER delimited_file")
        db.sql("CREATE FOREIGN TABLE missing (x INT) SERVER s3c "
               "WITH (file_path = 's3://nowhere/nothing.csv')")


def _sqlite_src(p):
    os.makedirs(p, exist_ok=True)
    path = os.path.join(p, "src.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE remote_t (k INTEGER, v REAL, s TEXT)")
    conn.executemany("INSERT INTO remote_t VALUES (?, ?, ?)",
                     [(1, 1.5, "a"), (2, 2.5, "b"), (1, 3.5, None), (3, None, "a")])
    conn.commit()
    conn.close()
    return path


def _dbapi_declared(pkg, p):
    db = pkg.connect()
    db.sql("CREATE SERVER odbc1 FOREIGN DATA WRAPPER sql_select "
           f"WITH (dbapi = 'sqlite3', database = '{_sqlite_src(p)}')")
    db.sql("CREATE FOREIGN TABLE ext (k INT, v DOUBLE, s TEXT) SERVER odbc1 "
           "WITH (remote_table = 'remote_t')")
    return (db.sql("SELECT k, count(*), sum(v) FROM ext GROUP BY k ORDER BY k").rows(),
            db.sql("SELECT count(*) FROM ext WHERE s = 'a'").scalar())


def _dbapi_inferred(pkg, p):
    db = pkg.connect()
    db.sql("CREATE SERVER odbc2 FOREIGN DATA WRAPPER sql_select "
           f"WITH (dbapi = 'sqlite3', database = '{_sqlite_src(p)}')")
    db.sql("CREATE FOREIGN TABLE ext2 SERVER odbc2 "
           "WITH (sql_select = 'SELECT k, v, s FROM remote_t WHERE k < 3')")
    return db.sql("SELECT k, v, s FROM ext2 ORDER BY k, v").rows(), db.sql("DESCRIBE ext2").rows()


def _dbapi_refresh(pkg, p):
    src = _sqlite_src(p)
    db = pkg.connect()
    db.sql("CREATE SERVER odbc3 FOREIGN DATA WRAPPER sql_select "
           f"WITH (dbapi = 'sqlite3', database = '{src}')")
    db.sql("CREATE FOREIGN TABLE ext3 (k INT, v DOUBLE, s TEXT) SERVER odbc3 "
           "WITH (remote_table = 'remote_t')")
    out = [db.sql("SELECT count(*) FROM ext3").scalar()]
    conn = sqlite3.connect(src)
    conn.execute("INSERT INTO remote_t VALUES (9, 9.0, 'z')")
    conn.commit()
    conn.close()
    db.sql("REFRESH FOREIGN TABLES ext3")
    return out + [db.sql("SELECT count(*), sum(k) FROM ext3").rows()]


def _dbapi_factory(pkg, p):
    remote = _mod(pkg, "io.remote")
    calls = []

    def factory(options):
        calls.append(options.get("tag"))
        conn = sqlite3.connect(":memory:")
        conn.execute("CREATE TABLE t (a INTEGER)")
        conn.executemany("INSERT INTO t VALUES (?)", [(i,) for i in range(5)])
        conn.commit()
        return conn

    remote.register_dbapi_factory("mydriver", factory)
    try:
        db = pkg.connect()
        db.sql("CREATE SERVER odbc4 FOREIGN DATA WRAPPER sql_select "
               "WITH (dbapi = 'mydriver', tag = 'hello')")
        db.sql("CREATE FOREIGN TABLE ext4 (a INT) SERVER odbc4 WITH (remote_table = 't')")
        return db.sql("SELECT sum(a) FROM ext4").scalar(), calls
    finally:
        remote._dbapi_factories.pop("mydriver", None)


def _dbapi_write_rejected(pkg, p):
    db = pkg.connect()
    db.sql("CREATE SERVER odbc5 FOREIGN DATA WRAPPER sql_select "
           f"WITH (dbapi = 'sqlite3', database = '{_sqlite_src(p)}')")
    db.sql("CREATE FOREIGN TABLE ext5 (k INT, v DOUBLE, s TEXT) SERVER odbc5 "
           "WITH (remote_table = 'remote_t')")
    db.sql("INSERT INTO ext5 VALUES (1, 1.0, 'x')")


CASES = {
    "test_foreign.py::test_delimited_foreign_table": _delimited,
    "test_foreign.py::test_refresh_picks_up_changes": _refresh,
    "test_foreign.py::test_foreign_tables_are_read_only": _read_only,
    "test_foreign.py::test_parquet_schema_inference": _parquet_inference,
    "test_foreign.py::test_custom_server_base_path": _custom_server,
    "test_foreign.py::test_regex_parser_wrapper": _regex,
    "test_foreign.py::test_foreign_table_persists_definition": _persists_definition,
    "test_foreign.py::test_fsi_disk_cache_and_server_persistence": _disk_cache,
    "test_foreign.py::test_fsi_cache_invalidated_on_source_change": _cache_invalidated,
    "test_foreign.py::test_scheduled_refresh": _scheduled_refresh,
    "test_foreign_remote.py::test_s3_delimited_foreign_table": _s3_delimited,
    "test_foreign_remote.py::test_s3_refresh_refetches": _s3_refresh,
    "test_foreign_remote.py::test_dbapi_foreign_table_declared_schema": _dbapi_declared,
    "test_foreign_remote.py::test_dbapi_foreign_table_inferred_schema": _dbapi_inferred,
    "test_foreign_remote.py::test_dbapi_refresh_sees_source_changes": _dbapi_refresh,
    "test_foreign_remote.py::test_dbapi_registered_factory": _dbapi_factory,
}
ERROR_CASES = {
    "test_foreign_remote.py::test_s3_missing_object_errors": _s3_missing,
    "test_foreign_remote.py::test_foreign_write_rejected": _dbapi_write_rejected,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_foreign_cases(tmp_path, name):
    both(tmp_path, CASES[name])


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_reference_foreign_errors(tmp_path, name):
    assert raises_in_both(tmp_path, ERROR_CASES[name])[0] == "SqlError"


def test_s3_without_transport_raises(tmp_path):
    """The port opens no network connection of its own: with no S3
    transport installed, an S3 foreign table is refused at CREATE."""
    db = PORT.connect()
    db.sql("CREATE SERVER s3n FOREIGN DATA WRAPPER delimited_file")
    with pytest.raises(PORT.errors.SqlError, match="no S3 transport"):
        db.sql("CREATE FOREIGN TABLE nt (x INT) SERVER s3n "
               "WITH (file_path = 's3://bucket/key.csv')")
    assert db.catalog.get_table_opt("nt") is None
