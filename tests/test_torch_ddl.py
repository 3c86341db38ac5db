"""The port's in-memory SQL surface against the JAX package: DDL, views,
SHOW / DESCRIBE, EXPLAIN, the result recycler, COMMENT ON, ALTER COLUMN
TYPE, users, roles, privileges and row-level policies.

The cases of tests/test_engine_basic.py (test_ddl, test_views,
test_explain, test_alter_table_columns, test_result_recycler), the
in-memory ones of tests/test_ddl_security.py and tests/test_privileges.py
(the persistence round trips and the server wait for the port of storage
and of the server), each run through heavydb_tpu.connect() and
heavydb_tpu_torch.connect(device="cpu"): the same rows, the same errors
and the same text.  Then the port's own: the kernel and aux caches after
ALTER COLUMN TYPE and after RENAME COLUMN never serve an entry built for
the column before (the reference serves a stale dictionary table there),
column DDL moves the columns it does not change to the new generation on
the device, and the SHOW / registry statements, warmup, table_rows and
dashboards.

Tolerances: every value exact, but DOUBLE sums rtol 1e-9.
"""

import math

import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.errors import CatalogError as JCatalogError
from heavydb_tpu.errors import HeavyTpuError as JHeavyTpuError
from heavydb_tpu.errors import NotSupported as JNotSupported
from heavydb_tpu.errors import SqlError as JSqlError
from heavydb_tpu.storage.syscatalog import PermissionError_ as JPermissionError
from heavydb_tpu_torch.errors import CatalogError, HeavyTpuError, NotSupported, SqlError
from heavydb_tpu_torch.storage.syscatalog import PermissionError_


def _pair():
    return hdt.connect(), hdt_torch.connect(device="cpu")


def _both(dbs, *stmts, **kw):
    for db in dbs:
        for s in stmts:
            db.sql(s, **kw)


def _norm(v):
    return None if isinstance(v, float) and math.isnan(v) else v


def _close(a, b):
    if isinstance(b, float) and a is not None:
        return a == pytest.approx(b, rel=1e-9)
    return a == b


def _same(got, want, ordered=False):
    got = [tuple(_norm(v) for v in r) for r in got]
    want = [tuple(_norm(v) for v in r) for r in want]
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want), (got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w)), (g, w)


def _check(dbs, sql, **kw):
    ref, port = dbs
    want = ref.sql(sql, **kw).rows()
    got = port.sql(sql, **kw).rows()
    _same(got, want, "ORDER BY" in sql.upper())
    return got


def _raises(dbs, sql, jexc, exc, **kw):
    """The same statement fails in both packages with the same message."""
    ref, port = dbs
    with pytest.raises(jexc) as jerr:
        ref.sql(sql, **kw).rows()
    with pytest.raises(exc) as err:
        port.sql(sql, **kw).rows()
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# tests/test_engine_basic.py
# ---------------------------------------------------------------------------

@pytest.fixture()
def tdbs():
    dbs = _pair()
    _both(dbs, "CREATE TABLE t (x INT, y DOUBLE, s TEXT, d DATE, b BOOLEAN)",
          "INSERT INTO t VALUES "
          "(1, 2.5, 'foo', '2020-01-01', 'true'), "
          "(2, NULL, 'bar', '2020-06-15', 'false'), "
          "(3, 7.5, 'foo', NULL, NULL), "
          "(NULL, 1.0, NULL, '2021-03-03', 'true')")
    return dbs


def test_ddl():
    dbs = _pair()
    _both(dbs, "CREATE TABLE a (x INT)")
    _raises(dbs, "CREATE TABLE a (x INT)", JCatalogError, CatalogError)
    _both(dbs, "CREATE TABLE IF NOT EXISTS a (x INT)", "ALTER TABLE a RENAME TO b")
    assert [db.catalog.list_tables() for db in dbs] == [["b"], ["b"]]
    _both(dbs, "DROP TABLE b")
    _raises(dbs, "DROP TABLE b", JCatalogError, CatalogError)
    _both(dbs, "DROP TABLE IF EXISTS b")


def test_views(tdbs):
    _both(tdbs, "CREATE VIEW v AS SELECT s, count(*) c FROM t GROUP BY s")
    assert _check(tdbs, "SELECT * FROM v WHERE c > 1") == [("foo", 2)]
    _raises(tdbs, "CREATE VIEW v AS SELECT x FROM t", JCatalogError, CatalogError)
    _both(tdbs, "CREATE VIEW IF NOT EXISTS v AS SELECT x FROM t", "DROP VIEW v")
    _raises(tdbs, "SELECT * FROM v", JCatalogError, CatalogError)
    _raises(tdbs, "DROP VIEW v", JCatalogError, CatalogError)
    _both(tdbs, "DROP VIEW IF EXISTS v")


def test_explain(tdbs):
    ref, port = tdbs
    q = "EXPLAIN SELECT s, count(*) FROM t GROUP BY s"
    text = "\n".join(r[0] for r in port.sql(q).rows())
    assert "Compound" in text
    assert text == "\n".join(r[0] for r in ref.sql(q).rows())


def test_alter_table_columns():
    dbs = _pair()
    _both(dbs, "CREATE TABLE at (x INT)", "INSERT INTO at VALUES (1), (2)",
          "ALTER TABLE at ADD COLUMN y DOUBLE DEFAULT 9.5", "ALTER TABLE at ADD COLUMN s TEXT")
    assert _check(dbs, "SELECT x, y, s FROM at ORDER BY x") == [(1, 9.5, None), (2, 9.5, None)]
    _both(dbs, "INSERT INTO at VALUES (3, 1.0, 'n')", "ALTER TABLE at RENAME COLUMN y TO yy")
    assert _check(dbs, "SELECT sum(yy) FROM at") == [(20.0,)]
    _both(dbs, "ALTER TABLE at DROP COLUMN yy")
    assert [db.sql("SELECT * FROM at").fields for db in dbs] == [["x", "s"]] * 2
    _both(dbs, "OPTIMIZE TABLE at")
    assert _check(dbs, "SELECT count(*) FROM at") == [(3,)]
    _raises(dbs, "ALTER TABLE at DROP COLUMN nope", JCatalogError, CatalogError)
    _raises(dbs, "ALTER TABLE at ADD COLUMN x INT", JCatalogError, CatalogError)


def test_add_column_defaults():
    """A DEFAULT of each kind backfills the rows already there: DECIMAL
    (its scaling undone for the backfill), TEXT into a new dictionary,
    BIGINT, and NULL, on a table of several fragments."""
    ref = hdt.connect()
    port = hdt_torch.connect(device="cpu")
    dbs = (ref, port)
    _both(dbs, "CREATE TABLE ad (x INT) WITH (fragment_size=3)",
          "INSERT INTO ad VALUES (1), (2), (3), (4), (5), (6), (7)",
          "ALTER TABLE ad ADD COLUMN p DECIMAL(10,2) DEFAULT 12.34",
          "ALTER TABLE ad ADD COLUMN s TEXT DEFAULT 'dflt'",
          "ALTER TABLE ad ADD COLUMN b BIGINT DEFAULT -5000000000",
          "ALTER TABLE ad ADD COLUMN n SMALLINT")
    _check(dbs, "SELECT x, p, s, b, n FROM ad ORDER BY x")
    _check(dbs, "SELECT s, COUNT(*), SUM(p), MIN(b) FROM ad GROUP BY s")
    _both(dbs, "INSERT INTO ad VALUES (8, 1.5, 'z', 3, 2)")
    _check(dbs, "SELECT s, COUNT(*), SUM(p), MIN(b), MAX(n) FROM ad GROUP BY s")


def test_result_recycler():
    dbs = _pair()
    _both(dbs, "CREATE TABLE rr (x INT)", "INSERT INTO rr VALUES (1), (2)")
    q = "SELECT /*+ keep_result */ sum(x) FROM rr"
    for db in dbs:
        assert db.sql(q).scalar() == 3
        assert len(db._result_cache) == 1
        assert db.sql(q).scalar() == 3
        db.sql("INSERT INTO rr VALUES (10)")
        assert db.sql(q).scalar() == 13
    # the port drops the stale entry with the write
    assert len(dbs[1]._result_cache) == 1


def test_result_recycler_hit_and_keys():
    """A hit returns the recycled ResultSet and runs nothing; a query with
    a subquery is never recycled; a plain query never fills the cache."""
    port = hdt_torch.connect(device="cpu")
    port.sql("CREATE TABLE rr (x INT)")
    port.sql("INSERT INTO rr VALUES (1), (2), (5)")
    q = "SELECT /*+ keep_result */ x, COUNT(*) FROM rr GROUP BY x"
    first = port.sql(q)
    admitted = port.executor.resource_mgr.info()["total_admitted"]
    assert port.sql(q) is first
    assert port.executor.resource_mgr.info()["total_admitted"] == admitted
    port.sql("SELECT x FROM rr")
    port.sql("SELECT /*+ keep_result */ x FROM rr WHERE x > (SELECT MIN(x) FROM rr)")
    assert len(port._result_cache) == 1


# ---------------------------------------------------------------------------
# tests/test_ddl_security.py (in memory)
# ---------------------------------------------------------------------------

def _seed(dbs):
    _both(dbs, "CREATE TABLE emp (dept TEXT, salary INT, region TEXT)",
          "INSERT INTO emp VALUES "
          "('eng', 100, 'us'), ('eng', 120, 'eu'), "
          "('hr', 80, 'us'), ('sales', 90, 'eu'), ('sales', 95, 'us')")


def test_comment_on_table_and_column():
    dbs = _pair()
    _seed(dbs)
    _both(dbs, "COMMENT ON TABLE emp IS 'people table'",
          "COMMENT ON COLUMN emp.salary IS 'base salary, USD'")
    for db in dbs:
        t = db.catalog.get_table("emp")
        assert t.comment == "people table"
        assert t.column_by_name("salary").comment == "base salary, USD"
    _both(dbs, "COMMENT ON TABLE emp IS NULL")
    assert [db.catalog.get_table("emp").comment for db in dbs] == [None, None]
    _raises(dbs, "COMMENT ON COLUMN emp.nope IS 'x'", JSqlError, SqlError)


def test_alter_column_int_widen_and_float():
    dbs = _pair()
    _seed(dbs)
    _both(dbs, "ALTER TABLE emp ALTER COLUMN salary TYPE BIGINT")
    for db in dbs:
        assert db.catalog.get_table("emp").column_by_name("salary") \
            .type.sql_name().startswith("BIGINT")
    assert _check(dbs, "SELECT sum(salary) FROM emp") == [(485,)]
    _both(dbs, "ALTER TABLE emp ALTER salary SET DATA TYPE DOUBLE")
    assert _check(dbs, "SELECT sum(salary) FROM emp") == [(485.0,)]


def test_alter_column_narrow_out_of_range():
    dbs = _pair()
    _both(dbs, "CREATE TABLE n (v INT)", "INSERT INTO n VALUES (100000), (2)")
    _raises(dbs, "ALTER TABLE n ALTER COLUMN v TYPE SMALLINT", JHeavyTpuError, HeavyTpuError)
    # unchanged after the failed ALTER (all or nothing)
    assert _check(dbs, "SELECT sum(v) FROM n") == [(100002,)]


def test_alter_column_nulls_vs_not_null():
    dbs = _pair()
    _both(dbs, "CREATE TABLE m (v INT)", "INSERT INTO m VALUES (1), (NULL)")
    _raises(dbs, "ALTER TABLE m ALTER COLUMN v TYPE BIGINT NOT NULL",
            JHeavyTpuError, HeavyTpuError)
    _both(dbs, "ALTER TABLE m ALTER COLUMN v TYPE BIGINT")
    assert _check(dbs, "SELECT count(*) FROM m WHERE v IS NULL") == [(1,)]


def test_alter_column_int_to_text():
    dbs = _pair()
    _both(dbs, "CREATE TABLE s (v INT)", "INSERT INTO s VALUES (7), (8)",
          "ALTER TABLE s ALTER COLUMN v TYPE TEXT")
    assert {r[0] for r in _check(dbs, "SELECT v FROM s")} == {"7", "8"}
    assert _check(dbs, "SELECT count(*) FROM s WHERE v = '7'") == [(1,)]


def _rls_setup(dbs):
    _seed(dbs)
    _both(dbs, "CREATE USER bob (password='pw')", "GRANT SELECT ON emp TO bob")


def test_policy_restricts_text_column():
    dbs = _pair()
    _rls_setup(dbs)
    _both(dbs, "CREATE POLICY ON COLUMN emp.dept TO bob VALUES ('eng')")
    rows = _check(dbs, "SELECT dept, salary FROM emp", user="bob")
    assert {r[0] for r in rows} == {"eng"} and len(rows) == 2
    assert _check(dbs, "SELECT sum(salary) FROM emp", user="bob") == [(220,)]
    assert len(_check(dbs, "SELECT * FROM emp", user="admin")) == 5


def test_policy_restricts_int_column():
    dbs = _pair()
    _rls_setup(dbs)
    _both(dbs, "CREATE POLICY ON COLUMN emp.salary TO bob VALUES (80, 90)")
    rows = _check(dbs, "SELECT salary FROM emp", user="bob")
    assert sorted(r[0] for r in rows) == [80, 90]


def test_policy_via_role_and_multiple():
    dbs = _pair()
    _rls_setup(dbs)
    _both(dbs, "CREATE ROLE analysts", "GRANT analysts TO bob",
          "CREATE POLICY ON COLUMN emp.dept TO analysts VALUES ('eng', 'sales')",
          "CREATE POLICY ON COLUMN emp.region TO bob VALUES ('us')")
    rows = _check(dbs, "SELECT dept, region FROM emp", user="bob")
    assert all(r[0] in ("eng", "sales") and r[1] == "us" for r in rows)
    assert len(rows) == 2


def test_policy_applies_in_subquery_and_join():
    dbs = _pair()
    _rls_setup(dbs)
    _both(dbs, "CREATE TABLE dim (dept TEXT, hq TEXT)",
          "INSERT INTO dim VALUES ('eng', 'sf'), ('hr', 'nyc')",
          "GRANT SELECT ON dim TO bob",
          "CREATE POLICY ON COLUMN emp.dept TO bob VALUES ('eng')")
    rows = _check(dbs, "SELECT e.dept, d.hq FROM emp e JOIN dim d ON e.dept = d.dept",
                  user="bob")
    assert {r[0] for r in rows} == {"eng"}
    assert _check(dbs, "SELECT count(*) FROM (SELECT dept FROM emp)", user="bob") == [(2,)]
    assert _check(dbs, "SELECT count(*) FROM emp WHERE salary > "
                  "(SELECT MIN(salary) FROM emp)", user="bob") == [(1,)]


def test_show_and_drop_policy():
    dbs = _pair()
    _rls_setup(dbs)
    _both(dbs, "CREATE POLICY ON COLUMN emp.dept TO bob VALUES ('eng')")
    shown = _check(dbs, "SHOW POLICIES bob")
    assert any("emp.dept" in r[0] for r in shown)
    _both(dbs, "DROP POLICY ON COLUMN emp.dept FROM bob")
    assert _check(dbs, "SHOW POLICIES bob") == []
    assert len(_check(dbs, "SELECT * FROM emp", user="bob")) == 5
    _raises(dbs, "DROP POLICY ON COLUMN emp.dept FROM bob", JHeavyTpuError, HeavyTpuError)


def test_policy_refusals():
    dbs = _pair()
    _rls_setup(dbs)
    _both(dbs, "CREATE TABLE fl (f DOUBLE)")
    _raises(dbs, "CREATE POLICY ON COLUMN emp.nope TO bob VALUES (1)", JSqlError, SqlError)
    _raises(dbs, "CREATE POLICY ON COLUMN fl.f TO bob VALUES (1)", JNotSupported,
            NotSupported)
    _raises(dbs, "CREATE POLICY ON COLUMN emp.dept TO nobody VALUES ('x')",
            JCatalogError, CatalogError)


# ---------------------------------------------------------------------------
# tests/test_privileges.py (in memory)
# ---------------------------------------------------------------------------

@pytest.fixture()
def pdbs():
    dbs = _pair()
    _both(dbs, "CREATE TABLE t (x INT)", "INSERT INTO t VALUES (1)",
          "CREATE USER alice (password='secret')", "CREATE ROLE readers")
    return dbs


def test_user_lifecycle(pdbs):
    users = [r[0] for r in _check(pdbs, "SHOW USERS")]
    assert "alice" in users and "admin" in users
    for db in pdbs:
        assert db.syscatalog.check_login("alice", "secret")
    _both(pdbs, "ALTER USER alice (password='new')")
    for db in pdbs:
        assert not db.syscatalog.check_login("alice", "secret")
        assert db.syscatalog.check_login("alice", "new")
    _both(pdbs, "DROP USER alice")
    assert "alice" not in [r[0] for r in _check(pdbs, "SHOW USERS")]
    _raises(pdbs, "DROP USER admin", JCatalogError, CatalogError)


def test_privilege_enforcement(pdbs):
    _raises(pdbs, "SELECT * FROM t", JPermissionError, PermissionError_, user="alice")
    _both(pdbs, "GRANT SELECT ON TABLE t TO alice")
    assert _check(pdbs, "SELECT count(*) FROM t", user="alice") == [(1,)]
    _raises(pdbs, "INSERT INTO t VALUES (2)", JPermissionError, PermissionError_,
            user="alice")
    _both(pdbs, "REVOKE SELECT ON TABLE t FROM alice")
    _raises(pdbs, "SELECT * FROM t", JPermissionError, PermissionError_, user="alice")


def test_role_grants(pdbs):
    _both(pdbs, "GRANT SELECT ON TABLE t TO readers", "GRANT readers TO alice")
    assert _check(pdbs, "SELECT count(*) FROM t", user="alice") == [(1,)]
    assert _check(pdbs, "SHOW ROLES") == [("readers",)]
    _both(pdbs, "REVOKE readers FROM alice")
    _raises(pdbs, "SELECT * FROM t", JPermissionError, PermissionError_, user="alice")
    _both(pdbs, "DROP ROLE readers")
    assert _check(pdbs, "SHOW ROLES") == []


def test_admin_bypasses(pdbs):
    assert _check(pdbs, "SELECT count(*) FROM t", user="admin") == [(1,)]


def test_syscatalog_module_matches_reference():
    """storage/syscatalog.py is the reference's with its import changed."""
    import inspect

    import heavydb_tpu.storage.syscatalog as J
    import heavydb_tpu_torch.storage.syscatalog as P

    assert inspect.getsource(P).replace("heavydb_tpu_torch.", "heavydb_tpu.") \
        == inspect.getsource(J)


# ---------------------------------------------------------------------------
# SHOW / DESCRIBE / VALIDATE and the server's registries
# ---------------------------------------------------------------------------

def test_show_statements(tdbs):
    _both(tdbs, "CREATE TABLE u (k BIGINT, f FLOAT) WITH (fragment_size=2)",
          "INSERT INTO u VALUES (1, 1.5), (2, NULL), (3, 2.5)")
    for q in ("SHOW TABLES", "DESCRIBE t", "SHOW CREATE TABLE u", "SHOW TABLE DETAILS",
              "SHOW TABLE DETAILS u", "SHOW TABLE FUNCTIONS", "VALIDATE", "SHOW QUERIES",
              "SHOW USER SESSIONS", "SHOW ROLES"):
        _check(tdbs, q)
    ref, port = tdbs
    for db in tdbs:
        db.register_udf("twice", lambda x: x * 2, ["DOUBLE"], "DOUBLE")
    _same(port.sql("SHOW FUNCTIONS").rows(), ref.sql("SHOW FUNCTIONS").rows())
    _raises(tdbs, "KILL QUERY 'abc'", JSqlError, SqlError)
    _raises(tdbs, "DESCRIBE nope", JCatalogError, CatalogError)


def test_registry_providers():
    """SHOW QUERIES / SHOW USER SESSIONS read the providers a server
    installs; KILL QUERY calls its registry."""
    dbs = _pair()
    killed = []
    for db in dbs:
        db.queries_provider = lambda: [("s1", "RUNNING", "SELECT 1", 12.7)]
        db.session_provider = lambda: [("s1", "alice", "127.0.0.1", 3)]
        db.kill_provider = lambda sid: killed.append(sid) or sid == "s1"
    assert _check(dbs, "SHOW QUERIES") == [("s1", "RUNNING", "SELECT 1", 12)]
    assert _check(dbs, "SHOW USER SESSIONS") == [("s1", "alice", "127.0.0.1", 3)]
    assert _check(dbs, "KILL QUERY 's1'") == [("interrupted",)]
    assert _check(dbs, "KILL QUERY 's2'") == [("no such query",)]
    assert killed == ["s1", "s1", "s2", "s2"]


def test_warmup_table_rows_dashboards():
    dbs = _pair()
    _both(dbs, "CREATE TABLE w (x INT)", "INSERT INTO w VALUES (1), (2), (3)")
    for db in dbs:
        db.warmup(["SELECT COUNT(*) FROM w", "SELECT nope FROM w"])
        assert db.table_rows("w") == 3
        did = db.create_dashboard("d1", state="s", metadata="m")
        assert db.dashboards[did]["name"] == "d1"
        db.replace_dashboard(did, "d2", "s2", "m2", "bob")
        assert (db.dashboards[did]["name"], db.dashboards[did]["owner"]) == ("d2", "bob")
        db.delete_dashboard(did)
        assert db.dashboards == {}
    with pytest.raises(SqlError):
        dbs[1].delete_dashboard(did)


# ---------------------------------------------------------------------------
# the port's own: caches after column DDL
# ---------------------------------------------------------------------------

def _fresh_reference(port, table):
    """A new reference database holding the port's table as it stands."""
    ref = hdt.connect()
    t = port.catalog.get_table(table)
    cols = ", ".join(f"{cd.name} {cd.type}" for cd in t.columns)
    ref.sql(f"CREATE TABLE {table} ({cols})")
    for row in port.sql(f"SELECT * FROM {table}").rows():
        vals = ", ".join("NULL" if v is None else repr(v) for v in row)
        ref.sql(f"INSERT INTO {table} VALUES ({vals})")
    return ref


def test_aux_tables_after_alter_column_type():
    """TEXT -> INT -> TEXT gives the column a new dictionary of the same
    size in another order: the dictionary table built before must not be
    served (the reference serves it: 20 where the rows say 30)."""
    ref, port = _pair()
    for db in (ref, port):
        db.sql("CREATE TABLE a (s TEXT, n INT)")
        db.sql("INSERT INTO a VALUES ('1', 10), ('2', 20)")
        assert db.sql("SELECT SUM(n) FROM a WHERE s = '1'").rows() == [(10,)]
        db.sql("ALTER TABLE a ALTER COLUMN s TYPE INT")
        db.sql("DELETE FROM a WHERE s = 1")
        db.sql("INSERT INTO a VALUES (1, 30)")
        db.sql("ALTER TABLE a ALTER COLUMN s TYPE TEXT")
    q = "SELECT SUM(n) FROM a WHERE s = '1'"
    assert port.sql(q).rows() == [(30,)]
    assert ref.sql(q).rows() == [(20,)]  # the reference's stale table
    _same(port.sql(q).rows(), _fresh_reference(port, "a").sql(q).rows())
    _same(port.sql("SELECT s, MIN(n) FROM a GROUP BY s").rows(),
          _fresh_reference(port, "a").sql("SELECT s, MIN(n) FROM a GROUP BY s").rows())


def test_caches_after_column_ddl():
    """After ALTER COLUMN TYPE and RENAME COLUMN no kernel or aux table of
    the table is kept; the columns the statement did not change stay on
    the device under the new generation (nothing of them uploads again);
    the changed column uploads once; a column added under an old name is
    read, not the renamed one."""
    from heavydb_tpu_torch.exec.executor import _names_table

    rng = np.random.default_rng(3)
    n = 3000
    data = {"k": rng.integers(1, 50, n).astype(np.int32), "v": rng.random(n),
            "s": np.array([f"w{i % 7}" for i in range(n)], object)}
    ref, port = _pair()
    for db in (ref, port):
        db.sql("CREATE TABLE c (k INT, v DOUBLE, s TEXT)")
        db.load_table("c", data)
    ex = port.executor
    t = port.catalog.get_table("c")
    queries = ["SELECT k, COUNT(*), SUM(v) FROM c GROUP BY k",
               "SELECT s, COUNT(*), MIN(k) FROM c WHERE s LIKE 'w%' GROUP BY s"]
    for q in queries:
        _same(port.sql(q).rows(), ref.sql(q).rows())
    assert any(_names_table(k, t.table_id) for k in ex.kernel_cache)
    assert any(_names_table(k, t.table_id) for k in ex.aux_cache)

    def resident():
        return {k[2] for k, _ in ex.scan_cache.items() if k[0] == t.table_id}

    for stmt in ("ALTER TABLE c ALTER COLUMN k TYPE BIGINT",
                 "ALTER TABLE c RENAME COLUMN s TO s2"):
        gen0 = t.generation
        for db in (ref, port):
            db.sql(stmt)
        assert t.generation == gen0 + 1
        assert not any(_names_table(k, t.table_id) for k in ex.kernel_cache)
        assert not any(_names_table(k, t.table_id) for k in ex.aux_cache)
        assert all(k[1] == t.generation for k, _ in ex.scan_cache.items()
                   if k[0] == t.table_id)
    # k changed type and left; v and s moved to the new generation
    assert resident() == {2, 3}
    h2d = ex.h2d_bytes
    _same(port.sql(queries[0]).rows(), ref.sql(queries[0]).rows())
    assert ex.h2d_bytes - h2d == 3072 * 8  # k as BIGINT, its row bucket
    q = "SELECT s2, COUNT(*), MIN(k) FROM c WHERE s2 LIKE 'w%' GROUP BY s2"
    _same(port.sql(q).rows(), ref.sql(q).rows())
    for db in (ref, port):
        db.sql("ALTER TABLE c ADD COLUMN s TEXT DEFAULT 'fresh'")
    for q in ("SELECT s, COUNT(*) FROM c GROUP BY s", "SELECT COUNT(*) FROM c WHERE s = 'w1'"):
        _same(port.sql(q).rows(), ref.sql(q).rows())


def test_add_column_keeps_device_columns():
    """ADD COLUMN on a table loaded onto the device: its columns stay
    resident under the new generation, only the new column uploads (sent
    narrow: a constant's range fits int8), and the rows are the
    reference's."""
    rng = np.random.default_rng(4)
    n = 5000
    k = rng.integers(0, 20, n).astype(np.int32)
    v = rng.random(n).astype(np.float32)
    ref, port = _pair()
    ref.load_table("dv", {"k": k, "v": v.astype(np.float64)}, create=True)
    port.sql("CREATE TABLE dv (k INT, v DOUBLE)")
    port.load_table_device("dv", {"k": torch.from_numpy(k),
                                  "v": torch.from_numpy(v.astype(np.float64))})
    ex = port.executor
    ex._STAGE_MIN_BYTES = 1 << 10
    for db in (ref, port):
        db.sql("ALTER TABLE dv ADD COLUMN w INT DEFAULT 7")
    h2d = ex.h2d_bytes
    q = "SELECT k, COUNT(*), SUM(v), SUM(w) FROM dv GROUP BY k"
    _same(port.sql(q).rows(), ref.sql(q).rows())
    assert ex.h2d_bytes - h2d == n  # int8 on the wire
    for db in (ref, port):
        db.sql("ALTER TABLE dv DROP COLUMN w")
    h2d = ex.h2d_bytes
    _same(port.sql("SELECT k, SUM(v) FROM dv GROUP BY k").rows(),
          ref.sql("SELECT k, SUM(v) FROM dv GROUP BY k").rows())
    assert ex.h2d_bytes == h2d
