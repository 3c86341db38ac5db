"""Scalar UDFs and table functions: heavydb_tpu_torch against the JAX
package.

The cases of tests/test_udf.py, tests/test_ml_tfs.py and the ML cases of
tests/test_advice_fixes.py run through heavydb_tpu.connect() and
heavydb_tpu_torch.connect(device="cpu") on the same tables (in memory in
both: the port has no persistent storage yet).  A UDF is a jnp function
for the reference and the same formula over torch tensors for the port.
Every built-in table function of `_register_system_tfs` runs through both,
a table function joins a table and feeds a GROUP BY, a UDF sits in WHERE,
GROUP BY keys, aggregates and a window argument; then
heavydb_tpu_torch/ops/ml.py against the reference's on seeded data.

Tolerances: integers and strings exact; DOUBLE rtol 1e-9 (the table
functions run the same numpy code on the same inputs, so they agree to
the last bit but for the UDF arithmetic's association order).
"""

import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu import types as JT
from heavydb_tpu.errors import BinderError as JBinderError
from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import BinderError
from tests.test_torch_join import _same


def _both(statements=(), loads=()):
    dbs = (hdt.connect(), hdt_torch.connect(device="cpu"))
    for db in dbs:
        for st in statements:
            db.sql(st)
        for name, cols in loads:
            db.load_table(name, dict(cols), create=True)
    return dbs


def _check(dbs, sql, ordered=None):
    ref, port = dbs
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same(got, want, ordered="ORDER BY" in sql.upper() if ordered is None else ordered)
    return got


def _hypot(dbs):
    import jax.numpy as jnp

    ref, port = dbs
    ref.register_udf("HYPOT", lambda a, b: jnp.sqrt(a * a + b * b),
                     [JT.double(), JT.double()], JT.double())
    port.register_udf("HYPOT", lambda a, b: torch.sqrt(a * a + b * b),
                      [T.double(), T.double()], T.double())


@pytest.fixture(scope="module")
def udb():
    """tests/test_udf.py test_scalar_udf's table, and a wider one."""
    rng = np.random.default_rng(4)
    n = 5000
    a = np.where(rng.random(n) < 0.05, None, rng.integers(-50, 50, n))
    cols = {"k": rng.integers(0, 7, n).astype(np.int32), "a": list(a),
            "b": rng.random(n).astype(np.float32),
            "s": np.array([f"w{i % 13}" for i in range(n)], object)}
    dbs = _both(["CREATE TABLE t (x DOUBLE, y DOUBLE)",
                 "INSERT INTO t VALUES (3.0, 4.0), (6.0, 8.0), (NULL, 1.0)",
                 "CREATE TABLE u (k INT, a INT, b FLOAT, s TEXT)"])
    for db in dbs:
        db.load_table("u", {k: np.array(v, object) if isinstance(v, list) else v
                            for k, v in cols.items()})
    _hypot(dbs)
    return dbs


UDF_QUERIES = [
    # tests/test_udf.py test_scalar_udf
    "SELECT HYPOT(x, y) FROM t ORDER BY x NULLS LAST",
    "SELECT count(*) FROM t WHERE HYPOT(x, y) > 6",
    # INT and FLOAT arguments cast to DOUBLE, NULL propagation, GROUP BY
    # keys and aggregates
    "SELECT k, COUNT(*), SUM(HYPOT(a, b)), MAX(HYPOT(b, a)) FROM u GROUP BY k ORDER BY k",
    "SELECT COUNT(HYPOT(a, b)), MIN(HYPOT(a, 0)) FROM u",
    "SELECT CAST(HYPOT(a, 1) AS INT) h, COUNT(*) FROM u GROUP BY h ORDER BY h",
    "SELECT s, AVG(HYPOT(a, b)) FROM u WHERE HYPOT(a, b) BETWEEN 10 AND 30 GROUP BY s "
    "ORDER BY s",
]


@pytest.mark.parametrize("sql", UDF_QUERIES, ids=range(len(UDF_QUERIES)))
def test_scalar_udf(udb, sql):
    _check(udb, sql)


def test_udf_in_window_argument(udb):
    """A UDF in a window argument.  The reference's window compiler is
    given no UDFs (a KeyError there), so its rows come from the same
    formula written in SQL."""
    ref, port = udb
    tail = ("OVER (PARTITION BY k ORDER BY a, b) FROM u WHERE a > 40 ORDER BY k, a, b")
    want = ref.sql("SELECT k, SUM(SQRT(CAST(a AS DOUBLE) * a + CAST(b AS DOUBLE) * b)) "
                   + tail).rows()
    _same(port.sql("SELECT k, SUM(HYPOT(a, b)) " + tail).rows(), want, ordered=True)


def test_udf_wrong_arity(udb):
    for db, err in zip(udb, (JBinderError, BinderError)):
        db.register_udf("F1", lambda a: a, [JT.double() if err is JBinderError
                                             else T.double()],
                        JT.double() if err is JBinderError else T.double())
        with pytest.raises(err):
            db.sql("SELECT F1(x, x) FROM t")


def test_udf_returning_its_own_validity():
    """fn may return (value, valid): its NULLs join the arguments'."""
    import jax.numpy as jnp

    dbs = _both(["CREATE TABLE t (x DOUBLE)",
                 "INSERT INTO t VALUES (-1.0), (4.0), (NULL), (9.0)"])
    dbs[0].register_udf("SAFE_SQRT", lambda a: (jnp.sqrt(jnp.abs(a)), a >= 0),
                        [JT.double()], JT.double())
    dbs[1].register_udf("SAFE_SQRT", lambda a: (torch.sqrt(torch.abs(a)), a >= 0),
                        [T.double()], T.double())
    got = _check(dbs, "SELECT x, SAFE_SQRT(x) FROM t ORDER BY x NULLS LAST")
    assert [r[1] for r in got] == [None, 2.0, 3.0, None]


def test_generate_series():
    dbs = _both()
    _check(dbs, "SELECT * FROM TABLE(generate_series(1, 5))", ordered=True)
    _check(dbs, "SELECT * FROM TABLE(generate_series(0, 10, 5))", ordered=True)
    _check(dbs, "SELECT * FROM TABLE(generate_series(10, 1, -3))", ordered=True)
    _check(dbs, "SELECT sum(generate_series) FROM TABLE(generate_series(1, 100))")


def test_custom_table_function_with_cursor():
    dbs = _both(["CREATE TABLE t (k TEXT, v DOUBLE)",
                 "INSERT INTO t VALUES ('a', 1.0), ('b', 2.0), ('a', 3.0)"])

    def normalize(cursor=None):
        v = cursor["v"].astype(float)
        return {"k": cursor["k"], "z": (v - v.mean()) / v.std()}

    for db in dbs:
        db.register_table_function("normalize", normalize)
    got = _check(dbs, "SELECT k, z FROM TABLE(normalize(CURSOR(SELECT k, v FROM t))) "
                      "ORDER BY z")
    assert {r[0] for r in got} == {"a", "b"}


def test_table_function_join_and_group_by():
    dbs = _both(["CREATE TABLE r (n INT, lbl TEXT)",
                 "INSERT INTO r VALUES (2, 'two'), (4, 'four'), (4, 'vier')"])
    _check(dbs, "SELECT g.generate_series, r.lbl FROM TABLE(generate_series(1, 5)) g "
                "JOIN r ON g.generate_series = r.n ORDER BY 1, 2")
    _check(dbs, "SELECT r.lbl, COUNT(*), SUM(g.generate_series) FROM "
                "TABLE(generate_series(1, 50)) g JOIN r ON g.generate_series % 5 = r.n "
                "GROUP BY r.lbl")


def test_mandelbrot_and_dwell_times():
    dbs = _both(["CREATE TABLE ev (e INT, s INT, ts BIGINT)",
                 "INSERT INTO ev VALUES (1, 100, 0), (1, 101, 60), (1, 102, 180), "
                 "(2, 100, 10), (2, 105, 70), (3, 1, 5)"])
    _check(dbs, "SELECT * FROM TABLE(tf_compute_dwell_times("
                "CURSOR(SELECT e, s, ts FROM ev))) ORDER BY ts")
    _check(dbs, "SELECT y, SUM(num_iterations), MAX(x) FROM TABLE(tf_mandelbrot(24, 16)) "
                "GROUP BY y ORDER BY y")


@pytest.fixture(scope="module")
def mldb():
    """tests/test_udf.py's regression and k-means tables, and
    tests/test_ml_tfs.py's piecewise nonlinear one."""
    rng = np.random.default_rng(0)
    n = 400
    x1 = rng.normal(0, 1, n)
    rng = np.random.default_rng(1)
    f = np.concatenate([rng.normal(0, 0.1, 50), rng.normal(10, 0.1, 50)])
    rng = np.random.default_rng(7)
    m = 2000
    a1 = rng.uniform(-3, 3, m)
    a2 = rng.uniform(-3, 3, m)
    y = np.where(a1 > 0, 4.0 + 2.0 * a2, -3.0) + np.where(a2 > 1, 5.0, 0.0) \
        + rng.normal(0, 0.1, m)
    return _both(loads=[
        ("ml", {"id": np.arange(n, dtype=np.int32), "y": 3.0 + 2.0 * x1 + 0.01 * x1 ** 2,
                "x1": x1}),
        ("km", {"id": np.arange(100, dtype=np.int32), "f": f, "g": f[::-1].copy()}),
        ("mlt", {"id": np.arange(m, dtype=np.int64), "x1": a1, "x2": a2, "y": y}),
    ])


ML_QUERIES = [
    # tests/test_udf.py
    "SELECT coef_idx, coef FROM TABLE(linear_reg_fit(CURSOR(SELECT y, x1 FROM ml))) "
    "ORDER BY coef_idx",
    "SELECT id, prediction FROM TABLE(linear_reg_predict("
    "CURSOR(SELECT id, x1 FROM ml), 3.0, 2.0)) ORDER BY id",
    "SELECT cluster_id, COUNT(*) c FROM TABLE(kmeans("
    "CURSOR(SELECT id, f FROM km), 2)) GROUP BY cluster_id ORDER BY c, cluster_id",
    "SELECT id, cluster_id FROM TABLE(kmeans(CURSOR(SELECT id, f, g FROM km), 3, 5)) "
    "ORDER BY id",
    "SELECT id, pc1, pc2 FROM TABLE(pca_project(CURSOR(SELECT id, x1, x2, y FROM mlt), 2)) "
    "ORDER BY id LIMIT 50",
    # tests/test_ml_tfs.py
    "SELECT model_name, kind, n_trees, n_features FROM TABLE(decision_tree_reg_fit("
    "'dt', 8, 4, CURSOR(SELECT y, x1, x2 FROM mlt)))",
    "SELECT r2 FROM TABLE(r2_score('dt', CURSOR(SELECT y, x1, x2 FROM mlt)))",
    "SELECT id, prediction FROM TABLE(ml_reg_predict('dt', "
    "CURSOR(SELECT id, x1, x2 FROM mlt))) ORDER BY id",
    "SELECT * FROM TABLE(decision_tree_reg_fit('stump', 1, 4, "
    "CURSOR(SELECT y, x1, x2 FROM mlt)))",
    "SELECT r2 FROM TABLE(r2_score('stump', CURSOR(SELECT y, x1, x2 FROM mlt)))",
    "SELECT * FROM TABLE(random_forest_reg_fit('rf', 12, 8, "
    "CURSOR(SELECT y, x1, x2 FROM mlt)))",
    "SELECT r2 FROM TABLE(r2_score('rf', CURSOR(SELECT y, x1, x2 FROM mlt)))",
    "SELECT * FROM TABLE(gbt_reg_fit('g', 40, 3, 0.3, CURSOR(SELECT y, x1, x2 FROM mlt)))",
    "SELECT r2 FROM TABLE(r2_score('g', CURSOR(SELECT y, x1, x2 FROM mlt)))",
    "SELECT id, prediction FROM TABLE(ml_reg_predict('g', "
    "CURSOR(SELECT id, x1, x2 FROM mlt WHERE x1 > 2.5))) ORDER BY id",
    "SELECT * FROM TABLE(decision_tree_reg_fit('m1', CURSOR(SELECT y, x1 FROM mlt)))",
    "SELECT model_name, kind FROM TABLE(ml_models()) ORDER BY model_name",
]


def test_ml_table_functions(mldb):
    """In order: a model's fit comes before its scores and predictions."""
    for q in ML_QUERIES:
        _check(mldb, q)
    assert mldb[1].sql(ML_QUERIES[6]).rows()[0][0] > 0.9
    assert _check(mldb, ML_QUERIES[11])[0][0] > 0.9 > _check(mldb, ML_QUERIES[9])[0][0]


def test_ml_unknown_model_raises(mldb):
    for db in mldb:
        with pytest.raises(ValueError):
            db.sql("SELECT * FROM TABLE(ml_reg_predict('nope', "
                   "CURSOR(SELECT id, x1 FROM mlt)))")


def test_predict_matches_direct_model(mldb):
    """tests/test_ml_tfs.py test_predict_matches_direct_kernel: SQL-path
    prediction == the stored model's predict on the same data."""
    _, port = mldb
    port.sql("SELECT * FROM TABLE(decision_tree_reg_fit('d2', 6, 4, "
             "CURSOR(SELECT y, x1, x2 FROM mlt)))")
    cols = port.sql("SELECT x1, x2 FROM mlt ORDER BY id").rows()
    want = port._ml_models["d2"].predict(np.array(cols, np.float64))
    got = port.sql("SELECT prediction FROM TABLE(ml_reg_predict('d2', "
                   "CURSOR(SELECT id, x1, x2 FROM mlt))) ORDER BY id").rows()
    np.testing.assert_allclose([r[0] for r in got], want, rtol=1e-12)


def test_ml_cursor_needs_features():
    """tests/test_advice_fixes.py test_ml_cursor_needs_features."""
    for db in _both(["CREATE TABLE mt (y DOUBLE)", "INSERT INTO mt VALUES (1.0), (2.0)"]):
        with pytest.raises(Exception) as ei:
            db.sql("SELECT * FROM TABLE(decision_tree_reg_fit('m0', 8, 4, "
                   "CURSOR(SELECT y FROM mt)))").rows()
        assert "feature" in str(ei.value).lower()


def test_ml_predict_nonfinite_features_null():
    """tests/test_advice_fixes.py: a NaN feature predicts NULL."""
    rows = ", ".join(f"({i % 5}.0, {i % 5}.0)" for i in range(40))
    dbs = _both(["CREATE TABLE mfit (y DOUBLE, x DOUBLE)", f"INSERT INTO mfit VALUES {rows}",
                 "CREATE TABLE mp (id INT, x DOUBLE)",
                 "INSERT INTO mp VALUES (1, 2.0), (2, CAST('nan' AS DOUBLE)), (3, 4.0)"])
    for db in dbs:
        db.sql("SELECT * FROM TABLE(decision_tree_reg_fit('mnan', 8, 4, "
               "CURSOR(SELECT y, x FROM mfit)))").rows()
    got = _check(dbs, "SELECT * FROM TABLE(ml_reg_predict('mnan', "
                      "CURSOR(SELECT id, x FROM mp))) ORDER BY id")
    assert got[1][1] is None or np.isnan(got[1][1])


def test_r2_constant_y_perfect_fit():
    """tests/test_advice_fixes.py test_r2_constant_y_perfect_fit."""
    rows = ", ".join(f"(3.0, {i}.0)" for i in range(30))
    dbs = _both(["CREATE TABLE rc (y DOUBLE, x DOUBLE)", f"INSERT INTO rc VALUES {rows}"])
    for db in dbs:
        db.sql("SELECT * FROM TABLE(decision_tree_reg_fit('rcm', 8, 4, "
               "CURSOR(SELECT y, x FROM rc)))").rows()
    got = _check(dbs, "SELECT r2 FROM TABLE(r2_score('rcm', CURSOR(SELECT y, x FROM rc)))")
    assert abs(got[0][0] - 1.0) < 1e-9


def test_ml_module_matches_reference():
    """heavydb_tpu_torch/ops/ml.py against heavydb_tpu/ops/ml.py: the same
    trees, forests and boosted ensembles and predictions on seeded data."""
    from heavydb_tpu.ops import ml as RM
    from heavydb_tpu_torch.ops import ml as PM

    rng = np.random.default_rng(12)
    X = rng.normal(0, 1, (600, 3))
    y = np.sin(X[:, 0]) + X[:, 1] * (X[:, 2] > 0) + rng.normal(0, 0.05, 600)
    Xq = rng.normal(0, 1.2, (300, 3))
    for fit in (lambda M: M.fit_single(X, y, 6, 4),
                lambda M: M.fit_forest(X, y, n_trees=5, max_depth=5),
                lambda M: M.fit_gbt(X, y, n_trees=8, max_depth=3, learning_rate=0.3)):
        got, want = fit(PM), fit(RM)
        assert (got.kind, got.n_features, len(got.trees)) == \
            (want.kind, want.n_features, len(want.trees))
        for tg, tw in zip(got.trees, want.trees):
            assert tg.keys() == tw.keys()
            for k in tg:
                np.testing.assert_array_equal(np.asarray(tg[k]), np.asarray(tw[k]))
        np.testing.assert_array_equal(got.predict(Xq), want.predict(Xq))
