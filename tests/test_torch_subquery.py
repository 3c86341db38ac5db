"""Uncorrelated subqueries, set operations and grouping sets:
heavydb_tpu_torch against the JAX package.

The same seeded tables go into heavydb_tpu.connect() and, copied through
load_state, into heavydb_tpu_torch.connect(device="cpu"); every query must
give the reference's rows, as multisets without ORDER BY and in order with
it.  The queries are those of the reference's tests/test_subqueries.py
(correlated scalars the planner turns into joins, quantified ANY / ALL),
tests/test_grouping_sets.py (ROLLUP, CUBE, GROUPING SETS, HAVING per set)
and the subquery and UNION cases of tests/test_engine_basic.py, then the
traps of the port: a scalar subquery with no row (NULL) or two rows (an
error in both), NOT IN over a list holding a NULL, IN and UNION across two
string dictionaries, a CTE read by the outer query and by a subquery, the
declared types and promoted values of INT with BIGINT and INT with FLOAT
under UNION ALL, and a substituted constant that changes between runs.

Tolerances: integers and strings exact; DOUBLE results rtol 1e-9; FLOAT
sums rtol 1e-4 / atol 1e-3 (float32 accumulation in another order).
"""

import numpy as np
import pytest

import heavydb_tpu as hdt
from heavydb_tpu.errors import ExecutionError as JExecutionError
from heavydb_tpu_torch.errors import ExecutionError, NotSupported
from heavydb_tpu_torch.exec import executor as X
from tests.test_torch_join import _check, _pair, _same

I32_NULL = np.iinfo(np.int32).min


@pytest.fixture(scope="module")
def li_p():
    """tests/test_subqueries.py's tables."""
    ref = hdt.connect()
    rows_li = [(1, 5, 10.0), (1, 50, 20.0), (2, 3, 30.0), (2, 4, 40.0),
               (3, 100, 5.0), (None, 7, 1.0)]
    rows_p = [(1, "A"), (2, "B"), (3, "A"), (4, "C")]
    ref.sql("CREATE TABLE li (pk INT, qty INT, price DOUBLE)")
    ref.load_table("li", {"pk": [r[0] for r in rows_li], "qty": [r[1] for r in rows_li],
                          "price": [r[2] for r in rows_li]})
    ref.sql("CREATE TABLE p (pk INT, brand TEXT)")
    ref.load_table("p", {"pk": [r[0] for r in rows_p], "brand": [r[1] for r in rows_p]})
    return _pair(ref, ["li", "p"])


SUBQUERY_SUITE = [
    # correlated scalars (decorrelated into LEFT JOINs by the planner)
    "SELECT sum(price) FROM li l WHERE qty < "
    "(SELECT 0.5*avg(qty) FROM li l2 WHERE l2.pk = l.pk)",
    "SELECT p.pk, (SELECT sum(qty) FROM li WHERE li.pk = p.pk) FROM p ORDER BY p.pk",
    "SELECT p.pk, (SELECT count(*) FROM li WHERE li.pk = p.pk) FROM p ORDER BY p.pk",
    "SELECT p.pk, (SELECT count(*) FROM li WHERE li.pk = p.pk AND qty > 4) "
    "FROM p ORDER BY p.pk",
    "SELECT p.pk FROM p WHERE (SELECT max(qty) FROM li WHERE li.pk = p.pk) > 10 "
    "ORDER BY p.pk",
    "SELECT p.pk, (SELECT avg(price) FROM li WHERE li.pk = p.pk AND li.qty < 60) "
    "FROM p ORDER BY p.pk",
    "SELECT p.pk, (SELECT min(qty) FROM li WHERE li.pk = p.pk), "
    "(SELECT max(qty) FROM li WHERE li.pk = p.pk) FROM p ORDER BY p.pk",
    # quantified comparisons (IN, or guarded MIN / MAX scalar subqueries)
    "SELECT count(*) FROM li WHERE qty > ANY (SELECT qty FROM li WHERE pk = 2)",
    "SELECT count(*) FROM li WHERE qty >= ALL (SELECT qty FROM li WHERE pk = 2)",
    "SELECT count(*) FROM li WHERE qty > ANY (SELECT qty FROM li WHERE pk = 99)",
    "SELECT count(*) FROM li WHERE qty > ALL (SELECT qty FROM li WHERE pk = 99)",
    "SELECT count(*) FROM li WHERE qty = ANY (SELECT qty FROM li WHERE pk = 1)",
    "SELECT count(*) FROM li WHERE qty <> ALL (SELECT qty FROM li WHERE pk = 1)",
    "SELECT count(*) FROM li WHERE qty = ALL (SELECT qty FROM li WHERE qty = 100)",
    "SELECT count(*) FROM li WHERE qty <> ANY (SELECT qty FROM li WHERE pk <= 2)",
    "SELECT count(*) FROM li WHERE qty < SOME (SELECT qty FROM li WHERE pk = 1)",
]


@pytest.mark.parametrize("sql", SUBQUERY_SUITE, ids=range(len(SUBQUERY_SUITE)))
def test_subquery_suite(li_p, sql):
    _check(li_p, sql)


@pytest.fixture(scope="module")
def gsets():
    """tests/test_grouping_sets.py's table."""
    rng = np.random.default_rng(2)
    n = 5000
    ref = hdt.connect()
    ref.load_table("t", {"a": rng.integers(0, 4, n).astype(np.int32),
                         "b": rng.integers(0, 3, n).astype(np.int32),
                         "v": rng.integers(0, 100, n).astype(np.int32)}, create=True)
    return _pair(ref, ["t"])


GROUPING_SETS = [
    "SELECT a, b, count(*), sum(v) FROM t GROUP BY ROLLUP(a, b) "
    "ORDER BY a NULLS LAST, b NULLS LAST",
    "SELECT a, b, sum(v) FROM t GROUP BY CUBE(a, b) ORDER BY a NULLS LAST, b NULLS LAST",
    "SELECT a, b, count(*) FROM t GROUP BY GROUPING SETS ((a, b), (b), ()) "
    "ORDER BY a NULLS LAST, b NULLS LAST",
    "SELECT a, b, count(*) FROM t GROUP BY ROLLUP(a, b) HAVING count(*) > 430 "
    "ORDER BY a NULLS LAST, b NULLS LAST",
    "SELECT a % 2, sum(v) FROM t GROUP BY ROLLUP(a % 2) ORDER BY 1 NULLS LAST",
    # the hand expansion of the first, with typed NULLs
    "SELECT a, b, count(*), sum(v) FROM t GROUP BY a, b UNION ALL "
    "SELECT a, CAST(NULL AS INT), count(*), sum(v) FROM t GROUP BY a UNION ALL "
    "SELECT CAST(NULL AS INT), CAST(NULL AS INT), count(*), sum(v) FROM t",
]


@pytest.mark.parametrize("sql", GROUPING_SETS, ids=range(len(GROUPING_SETS)))
def test_grouping_sets(gsets, sql):
    _check(gsets, sql)


@pytest.fixture(scope="module")
def basic():
    """tests/test_engine_basic.py's table, through INSERT VALUES in both."""
    ref = hdt.connect()
    ref.sql("CREATE TABLE t (x INT, y DOUBLE, s TEXT, d DATE, b BOOLEAN)")
    ref.sql("INSERT INTO t VALUES (1, 2.5, 'foo', '2020-01-01', 'true'), "
            "(2, NULL, 'bar', '2020-06-15', 'false'), (3, 7.5, 'foo', NULL, NULL), "
            "(NULL, 1.0, NULL, '2021-03-03', 'true')")
    return _pair(ref, ["t"])


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM t WHERE x = (SELECT max(x) FROM t)",
    "SELECT count(*) FROM t WHERE s IN (SELECT s FROM t WHERE x = 1)",
    "SELECT count(*) FROM t WHERE EXISTS (SELECT 1 FROM t WHERE x > 10)",
    "SELECT s, c FROM (SELECT s, count(*) c FROM t GROUP BY s) sub WHERE c > 1",
    "SELECT x FROM t WHERE x = 1 UNION ALL SELECT x FROM t WHERE x > 1",
    "SELECT s FROM t UNION SELECT s FROM t ORDER BY s",
    "SELECT b, d FROM t UNION SELECT b, d FROM t",
])
def test_engine_basic_shapes(basic, sql):
    _check(basic, sql)


@pytest.fixture(scope="module")
def traps():
    """t: 3000 rows with NULL ints, a FLOAT, a BIGINT past 2^31 and a TEXT
    column with NULLs; u: 120 rows over a second dictionary that shares
    some of t's strings; n: a few rows whose ints hold a NULL."""
    rng = np.random.default_rng(7)
    n = 3000
    ref = hdt.connect()
    ref.sql("CREATE TABLE t (a INT, b BIGINT, f FLOAT, s TEXT, k INT)")
    ref.load_table("t", {
        "a": np.where(rng.random(n) < 0.05, I32_NULL, rng.integers(0, 60, n)).astype(np.int32),
        "b": (rng.integers(0, 50, n) + (1 << 33)).astype(np.int64),
        "f": (rng.integers(0, 40, n) / 4).astype(np.float32),
        "s": [["x", "y", "z", None][i] for i in rng.integers(0, 4, n)],
        "k": rng.integers(0, 10, n).astype(np.int32)})
    ref.sql("CREATE TABLE u (s TEXT, a INT)")
    ref.load_table("u", {"s": [["y", "q", "z", "w"][i] for i in rng.integers(0, 4, 120)],
                         "a": rng.integers(0, 80, 120).astype(np.int32)})
    ref.sql("CREATE TABLE n (a INT, s TEXT)")
    ref.sql("INSERT INTO n VALUES (3, 'x'), (NULL, NULL), (7, 'q')")
    return _pair(ref, ["t", "u", "n"])


# (sql, result columns that are FLOAT sums)
TRAPS = [
    # scalar subqueries: in WHERE, in the select list, in HAVING, with no row
    ("SELECT COUNT(*) FROM t WHERE a > (SELECT AVG(a) FROM t)", ()),
    ("SELECT k, (SELECT MAX(a) FROM u) FROM t WHERE k < 2", ()),
    ("SELECT k, COUNT(*) FROM t GROUP BY k HAVING COUNT(*) > (SELECT COUNT(*) FROM t) / 11",
     ()),
    ("SELECT COUNT(*), (SELECT a FROM u WHERE a > 1000) FROM t", ()),
    ("SELECT COUNT(*) FROM t WHERE a = (SELECT a FROM u WHERE a > 1000)", ()),
    # IN / NOT IN, with and without a NULL in the list
    ("SELECT COUNT(*) FROM t WHERE a IN (SELECT a FROM u)", ()),
    ("SELECT COUNT(*) FROM t WHERE a NOT IN (SELECT a FROM u)", ()),
    ("SELECT COUNT(*) FROM t WHERE a NOT IN (SELECT a FROM n)", ()),
    ("SELECT COUNT(*) FROM t WHERE a IN (SELECT a FROM n)", ()),
    ("SELECT COUNT(*) FROM t WHERE b IN (SELECT b + 1 FROM t WHERE k = 3)", ()),
    # nested IN (TPC-H Q20's shape, uncorrelated)
    ("SELECT k, COUNT(*) FROM t WHERE a IN (SELECT a FROM u WHERE s IN "
     "(SELECT s FROM n)) GROUP BY k", ()),
    # EXISTS / NOT EXISTS, true and false
    ("SELECT COUNT(*) FROM t WHERE EXISTS (SELECT 1 FROM u WHERE a > 10)", ()),
    ("SELECT COUNT(*) FROM t WHERE EXISTS (SELECT 1 FROM u WHERE a > 1000)", ()),
    ("SELECT COUNT(*) FROM t WHERE NOT EXISTS (SELECT 1 FROM u WHERE a > 10)", ()),
    ("SELECT COUNT(*) FROM t WHERE NOT EXISTS (SELECT 1 FROM u WHERE a > 1000)", ()),
    # quantified over a list with a NULL
    ("SELECT COUNT(*) FROM t WHERE a > ANY (SELECT a FROM n)", ()),
    ("SELECT COUNT(*) FROM t WHERE a < ALL (SELECT a FROM u WHERE a > 40)", ()),
    # strings of another dictionary
    ("SELECT COUNT(*) FROM t WHERE s IN (SELECT s FROM u)", ()),
    ("SELECT k, COUNT(*) FROM t WHERE s NOT IN (SELECT s FROM u WHERE a < 20) GROUP BY k",
     ()),
    ("SELECT s FROM t UNION SELECT s FROM u", ()),
    ("SELECT s, COUNT(*) FROM (SELECT s FROM t UNION ALL SELECT s FROM u) v GROUP BY s",
     ()),
    ("SELECT s FROM u UNION ALL SELECT s FROM n", ()),
    # set operations with NULL rows
    ("SELECT a FROM t WHERE k = 1 UNION ALL SELECT a FROM u", ()),
    ("SELECT a FROM t UNION SELECT a FROM n", ()),
    ("SELECT a, s FROM t INTERSECT SELECT a, s FROM n", ()),
    ("SELECT a FROM t INTERSECT SELECT a FROM u", ()),
    ("SELECT a FROM n EXCEPT SELECT a FROM u", ()),
    ("SELECT a FROM t EXCEPT SELECT a FROM u", ()),
    # grouping sets over a nullable key and a FLOAT sum
    ("SELECT k, a, COUNT(*), SUM(f) FROM t GROUP BY ROLLUP(k, a)", (3,)),
    ("SELECT k, a, COUNT(*) FROM t GROUP BY CUBE(k, a)", ()),
    ("SELECT k, a, COUNT(*) FROM t GROUP BY GROUPING SETS ((k, a), (a), ())", ()),
    # a CTE read by the outer query and by a subquery (TPC-H Q15's shape)
    ("WITH r AS (SELECT k, SUM(a) AS tot FROM t GROUP BY k) "
     "SELECT k, tot FROM r WHERE tot = (SELECT MAX(tot) FROM r)", ()),
    # a scalar subquery in a join's filter
    ("SELECT t.k, COUNT(*) FROM t JOIN u ON t.a = u.a WHERE u.a < (SELECT AVG(a) FROM u) "
     "GROUP BY t.k", ()),
    ("SELECT COUNT(*) FROM t JOIN u ON t.a = u.a AND u.a > (SELECT MIN(a) FROM n)", ()),
]


@pytest.mark.parametrize("sql,f32_cols", TRAPS, ids=range(len(TRAPS)))
def test_traps(traps, sql, f32_cols):
    _check(traps, sql, f32_cols)


def test_scalar_subquery_with_two_rows_raises(traps):
    ref, port = traps
    sql = "SELECT COUNT(*) FROM t WHERE a = (SELECT a FROM n)"
    with pytest.raises(JExecutionError, match="more than one row"):
        ref.sql(sql).rows()
    with pytest.raises(ExecutionError, match="more than one row"):
        port.sql(sql).rows()


@pytest.mark.parametrize("sql,want", [
    # INT with BIGINT past 2^31: the BIGINT values survive whole
    ("SELECT a FROM n WHERE a = 3 UNION ALL SELECT b FROM t WHERE b = 8589934592",
     [3, 8589934592]),
    # INT with FLOAT: 0.25 under a column the Union declares INTEGER
    ("SELECT a FROM n WHERE a = 3 UNION ALL SELECT f FROM t WHERE f = 0.25", [0.25, 3.0]),
])
def test_union_keeps_declared_type_and_promoted_values(traps, sql, want):
    ref, port = traps
    r, p = ref.sql(sql), port.sql(sql)
    assert [str(ti) for ti in p.types] == [str(ti) for ti in r.types] == ["INTEGER"]
    _same(p.rows(), r.rows())
    assert sorted(set(v for (v,) in p.rows())) == want


def test_substituted_constant_follows_the_data():
    """The subquery's value is part of the kernel cache key (a Constant in
    the Compound's expressions): a second run after an INSERT sees the new
    value."""
    ref = hdt.connect()
    ref.sql("CREATE TABLE q (a INT)")
    ref.sql("INSERT INTO q VALUES (1), (5), (9)")
    ref.sql("CREATE TABLE r (a INT)")
    ref.sql("INSERT INTO r VALUES (4)")
    engines = _pair(ref, ["q", "r"])
    sql = "SELECT COUNT(*) FROM q WHERE a > (SELECT MAX(a) FROM r)"
    assert _check(engines, sql) == [] and engines[1].sql(sql).rows() == [(2,)]
    for db in engines:
        db.sql("INSERT INTO r VALUES (6)")
    _check(engines, sql)
    assert engines[1].sql(sql).rows() == [(1,)]


def test_join_runs_keep_the_subqueries(traps):
    """execute() resets join_runs once; a subquery runs through the inner
    entry, so its join runs stay beside the outer query's."""
    _, port = traps
    port.sql("SELECT COUNT(*) FROM t JOIN u ON t.a = u.a WHERE t.k IN "
             "(SELECT t.k FROM t JOIN n ON t.a = n.a)").rows()
    assert len(port.executor.join_runs) == 2


def test_a_subquery_left_after_substitution_raises(traps, monkeypatch):
    _, port = traps
    monkeypatch.setattr(X.Executor, "_eval_subquery", lambda self, e: e)
    with pytest.raises(NotSupported, match="subquery left"):
        port.sql("SELECT COUNT(*) FROM t WHERE a > (SELECT AVG(a) FROM u)").rows()
