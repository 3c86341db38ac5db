"""Window functions: heavydb_tpu_torch against the JAX package.

The same tables go into heavydb_tpu.connect() and
heavydb_tpu_torch.connect(device="cpu"), and every query must give the
reference's rows, in order with an ORDER BY and as multisets without one:
every query of tests/test_window.py and tests/test_window_regressions.py,
then the parity hazards of the port, each named in a test: ties in
input-row order on the packed
and the generic sort; NaN, -0.0 and subnormals in PARTITION BY and ORDER
BY keys (one partition or one peer group with 0.0, as the reference's
XLA compares them); NULLS FIRST / LAST; a dictionary-string ORDER BY
under a WHERE; empty frames (NULL); frames clamped at partition edges;
pad rows after the data, which form their own partition.  The generated
queries of tests/test_window_fuzz.py are in tests/test_torch_window_fuzz.py,
and each function of heavydb_tpu_torch/ops/window.py against the
reference's in tests/test_torch_window_ops.py: the three files split the
reference's compile time between workers.

Tolerances: integers, strings and MIN / MAX / navigation values exact;
DOUBLE sums and averages rtol 1e-9 (atol 1e-9): the port sums in native
float64 by the reference's formulas, in another association order.
"""

import numpy as np
import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.errors import BinderError as JBinderError
from heavydb_tpu.errors import NotSupported as JNotSupported
from heavydb_tpu_torch.errors import BinderError, NotSupported
from tests.test_torch_join import _same


def _both(statements=(), loads=()):
    """(reference, port) with the same statements run and the same
    {column: values} tables loaded into each."""
    dbs = (hdt.connect(), hdt_torch.connect(device="cpu"))
    for db in dbs:
        for st in statements:
            db.sql(st)
        for name, cols in loads:
            db.load_table(name, {k: np.array(v, object) if isinstance(v, list) else v
                                 for k, v in cols.items()})
    return dbs


def _check(dbs, sql):
    ref, port = dbs
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same(got, want, ordered="ORDER BY" in sql.upper())
    return port


W_ROWS = ("INSERT INTO w VALUES ('a', 1, 10.0), ('a', 2, 20.0), ('a', 3, 30.0), "
          "('b', 1, 5.0), ('b', 2, NULL), ('b', 2, 7.0), ('c', 9, 1.0)")


@pytest.fixture(scope="module")
def wdb():
    """tests/test_window.py's table."""
    return _both(["CREATE TABLE w (g TEXT, x INT, v DOUBLE)", W_ROWS])


# the queries of tests/test_window.py's tests, in its order, then its
# FRAMED_QUERIES
WINDOW_SUITE = [
    "SELECT g, x, ROW_NUMBER() OVER (PARTITION BY g ORDER BY x) rn "
    "FROM w ORDER BY g, x, rn",
    "SELECT g, x, RANK() OVER (PARTITION BY g ORDER BY x), "
    "DENSE_RANK() OVER (PARTITION BY g ORDER BY x) FROM w WHERE g = 'b' ORDER BY x",
    "SELECT g, x, LAG(v) OVER (PARTITION BY g ORDER BY x), "
    "LEAD(v) OVER (PARTITION BY g ORDER BY x) FROM w WHERE g = 'a' ORDER BY x",
    "SELECT x, LAG(x, 2, -1) OVER (ORDER BY x, v NULLS LAST) FROM w "
    "WHERE g = 'a' ORDER BY x",
    "SELECT g, x, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY x), "
    "LAST_VALUE(v) OVER (PARTITION BY g ORDER BY x) FROM w WHERE g = 'a' ORDER BY x",
    "SELECT g, x, SUM(v) OVER (PARTITION BY g ORDER BY x), "
    "COUNT(v) OVER (PARTITION BY g ORDER BY x) FROM w WHERE g = 'b' "
    "ORDER BY x, v NULLS LAST",
    "SELECT g, SUM(v) OVER (PARTITION BY g), COUNT(*) OVER (PARTITION BY g), "
    "MIN(x) OVER (PARTITION BY g), MAX(v) OVER (PARTITION BY g) FROM w ORDER BY g, x",
    "SELECT x, MIN(v) OVER (ORDER BY x NULLS LAST, v NULLS LAST), "
    "MAX(v) OVER (ORDER BY x NULLS LAST, v NULLS LAST) FROM w WHERE g='a' ORDER BY x",
    "SELECT x, NTILE(2) OVER (ORDER BY x), PERCENT_RANK() OVER (ORDER BY x), "
    "CUME_DIST() OVER (ORDER BY x) FROM w WHERE g = 'a' ORDER BY x",
    "SELECT g, x, ROW_NUMBER() OVER (ORDER BY v DESC NULLS LAST, x) "
    "FROM w ORDER BY 3 LIMIT 3",
    "SELECT x, v - AVG(v) OVER (PARTITION BY g) delta FROM w WHERE g = 'a' ORDER BY x",
    "SELECT x, FIRST_VALUE(g) OVER (ORDER BY x, g) FROM w ORDER BY x, g LIMIT 2",
    "SELECT g, sv FROM (SELECT g, x, SUM(v) OVER (PARTITION BY g) sv "
    "FROM w WHERE x < 3) q WHERE sv > 10 ORDER BY g, x",
    # tests/test_window.py FRAMED_QUERIES
    "SELECT g, x, SUM(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST "
    "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, AVG(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST "
    "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, MIN(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST "
    "ROWS BETWEEN 1 PRECEDING AND 2 FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, MAX(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST "
    "ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) FROM w "
    "ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, COUNT(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST "
    "ROWS BETWEEN 1 FOLLOWING AND 2 FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, SUM(x) OVER (PARTITION BY g ORDER BY x "
    "RANGE BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) FROM w "
    "ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, MAX(v) OVER (PARTITION BY g ORDER BY x "
    "RANGE BETWEEN CURRENT ROW AND CURRENT ROW) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, MIN(x) OVER (PARTITION BY g ORDER BY x "
    "RANGE BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) FROM w "
    "ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST "
    "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, LAST_VALUE(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST "
    "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, SUM(v) OVER (PARTITION BY g "
    "ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) "
    "FROM w ORDER BY g, x, v NULLS FIRST",
    # a window over a GROUP BY result, a Sort over a window without ORDER BY
    # in its spec, a window without any outer ORDER BY (the egress order)
    "SELECT g, s, RANK() OVER (ORDER BY s DESC) r FROM (SELECT g, SUM(v) s FROM w "
    "GROUP BY g) q ORDER BY r, g",
    "SELECT g, x, COUNT(*) OVER (PARTITION BY g) c FROM w ORDER BY c DESC, g, x LIMIT 4",
    "SELECT g, x, v, LEAD(x) OVER (PARTITION BY g ORDER BY x), "
    "SUM(x) OVER (ORDER BY v NULLS FIRST, x) FROM w",
]


@pytest.mark.parametrize("sql", WINDOW_SUITE, ids=range(len(WINDOW_SUITE)))
def test_window_suite(wdb, sql):
    _check(wdb, sql)


def test_window_node_modes(wdb):
    """One spec over few columns emits in sorted order; two specs keep the
    row order and scatter back; each sort packed or generic as its keys
    allow."""
    port = _check(wdb, WINDOW_SUITE[0])
    assert port.executor.window_runs == [dict(mode="sorted", sort="packed", functions=1)]
    port = _check(wdb, WINDOW_SUITE[-1])
    assert port.executor.window_runs == [
        dict(mode="permsort", sort="packed", functions=1),
        dict(mode="permsort", sort="generic", functions=1)]


def test_framed_larger_random(wdb):
    """tests/test_window.py test_framed_larger_random_vs_sqlite's table
    and queries."""
    rng = np.random.default_rng(5)
    n = 3000
    g = rng.integers(0, 7, n)
    x = rng.integers(0, 50, n)
    v = np.where(rng.random(n) < 0.1, np.nan, rng.normal(0, 10, n))
    dbs = _both(["CREATE TABLE wr (g INT, x INT, v DOUBLE, r INT)"],
                [("wr", {"g": g.astype(np.int32), "x": x.astype(np.int32), "v": v,
                         "r": np.arange(n, dtype=np.int32)})])
    for q in [
        "SELECT g, x, SUM(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST, r "
        "ROWS BETWEEN 3 PRECEDING AND 2 FOLLOWING) s FROM wr ORDER BY g, r",
        "SELECT g, x, MIN(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST, r "
        "ROWS BETWEEN 5 PRECEDING AND 5 FOLLOWING) s FROM wr ORDER BY g, r",
        "SELECT g, x, MAX(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST, r "
        "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) s FROM wr ORDER BY g, r",
        "SELECT g, x, COUNT(v) OVER (PARTITION BY g ORDER BY x "
        "RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) s FROM wr ORDER BY g, r",
    ]:
        _check(dbs, q)


def test_frame_errors():
    dbs = _both(["CREATE TABLE fe (x INT)", "INSERT INTO fe VALUES (1), (2)"])
    for db, ns, be in zip(dbs, (JNotSupported, NotSupported), (JBinderError, BinderError)):
        with pytest.raises(ns):
            db.sql("SELECT SUM(x) OVER (ORDER BY x "
                   "RANGE BETWEEN 5 PRECEDING AND CURRENT ROW) FROM fe")
        with pytest.raises(be):
            db.sql("SELECT SUM(x) OVER (ORDER BY x "
                   "ROWS BETWEEN UNBOUNDED FOLLOWING AND CURRENT ROW) FROM fe")


@pytest.mark.parametrize("fn", [
    "LAG(v) IGNORE NULLS", "LEAD(v) IGNORE NULLS", "LAST_VALUE(v) IGNORE NULLS",
    "FIRST_VALUE(v) IGNORE NULLS", "LAG(v, 2, -1.0) IGNORE NULLS", "LAG(v) RESPECT NULLS",
    "NTH_VALUE(v, 2) IGNORE NULLS", "LEAD(v, 2, 0.5) IGNORE NULLS",
])
def test_ignore_nulls_navigation(fn):
    """tests/test_window.py test_ignore_nulls_navigation, and NTH_VALUE and a
    LEAD default."""
    dbs = _both(["CREATE TABLE wn (g INT, x INT, v DOUBLE)",
                 "INSERT INTO wn VALUES (1,1,10.0),(1,2,NULL),(1,3,NULL),"
                 "(1,4,40.0),(1,5,NULL),(2,1,NULL),(2,2,7.0)"])
    _check(dbs, f"SELECT g, x, {fn} OVER (PARTITION BY g ORDER BY x) FROM wn "
                "ORDER BY g, x")


def test_string_order_key_lexicographic():
    """tests/test_window.py test_string_order_key_lexicographic: a
    dictionary-string ORDER BY ranks lexicographically, not by id."""
    words = ["zebra", "apple", "mango", "kiwi", "banana", "apple", "zebra"]
    rows = [(w, int(i % 2), i) for i, w in enumerate(words)]
    dbs = _both(["CREATE TABLE wso (s TEXT, g INT, v INT)"],
                [("wso", {"s": [r[0] for r in rows], "g": [r[1] for r in rows],
                          "v": [r[2] for r in rows]})])
    for q in [
        "SELECT v, RANK() OVER (ORDER BY s) FROM wso ORDER BY v",
        "SELECT v, DENSE_RANK() OVER (ORDER BY s DESC) FROM wso ORDER BY v",
        "SELECT v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY s, v) FROM wso ORDER BY v",
        "SELECT v, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY s) FROM wso ORDER BY v",
        "SELECT v, SUM(v) OVER (ORDER BY s) FROM wso ORDER BY v",
    ]:
        _check(dbs, q)


def test_range_peers_on_unpackable_sort():
    """tests/test_window_regressions.py: a FLOAT ORDER BY key (the generic
    sort) keeps RANGE peers together."""
    rows = [(0, 1.5, 10.0), (0, 1.5, 20.0), (0, 2.5, 5.0), (1, 1.5, 1.0), (1, 1.5, 2.0)]
    dbs = _both(["CREATE TABLE wr (g INT, f DOUBLE, v DOUBLE)",
                 "INSERT INTO wr VALUES " + ", ".join(map(str, rows))])
    port = _check(dbs, "SELECT g, f, sum(v) OVER (PARTITION BY g ORDER BY f) "
                       "FROM wr ORDER BY g, f, v")
    assert port.executor.window_runs[0]["sort"] == "generic"


def test_dict_order_lexicographic_under_filter():
    """tests/test_window_regressions.py: a dictionary-string ORDER BY under a
    WHERE (whose Compound drops the target's dictionary)."""
    dbs = _both(["CREATE TABLE wd (g INT, s TEXT)",
                 "INSERT INTO wd VALUES (0, 'zz'), (0, 'aa'), (0, 'mm'), (1, 'zz')"])
    _check(dbs, "SELECT s, row_number() OVER (PARTITION BY g ORDER BY s) "
                "FROM wd WHERE g = 0 ORDER BY s")


# ---- parity hazards -----------------------------------------------------


@pytest.fixture(scope="module")
def hz():
    """Ties, NaN / -0.0 / subnormal / NULL keys and NULL values; 13 rows,
    so 3 pad rows follow the data in a 16-row bucket."""
    rows = {
        "k": [1, 1, 1, 2, 2, None, 3, 3, 3, 1, 2, None, 3],
        "t": [5, 5, 5, 1, 1, 2, None, 7, 7, 5, None, 2, 9],
        "f": [0.0, -0.0, 5e-324, 1.5, -1.5, None, 0.0, -5e-324, 2.0, -0.0, 1.5, 0.0, None],
        "v": [1.0, 2.0, None, 4.0, 8.0, 16.0, 32.0, None, 128.0, 256.0, 512.0, 1024.0,
              2048.0],
        "r": list(range(13)),
    }
    return _both(["CREATE TABLE hz (k INT, t INT, f DOUBLE, v DOUBLE, r INT)"],
                 [("hz", rows)])


@pytest.mark.parametrize("key", ["t", "f"], ids=["packed", "generic"])
def test_ties_in_row_order(hz, key):
    """Peers of a key keep the input row order, on the packed (INT) and the
    generic (DOUBLE) sort."""
    port = _check(hz, f"SELECT r, ROW_NUMBER() OVER (ORDER BY {key}), "
                      f"ROW_NUMBER() OVER (PARTITION BY k ORDER BY {key} DESC) FROM hz "
                      "ORDER BY r")
    assert {run["sort"] for run in port.executor.window_runs} == \
        {"packed" if key == "t" else "generic"}


def test_nan_negzero_subnormal_partition_keys(hz):
    """-0.0 and subnormals partition with 0.0 (the reference's canonical
    key; NaN from an expression as well)."""
    _check(hz, "SELECT r, COUNT(*) OVER (PARTITION BY f), SUM(v) OVER (PARTITION BY f), "
               "ROW_NUMBER() OVER (PARTITION BY f ORDER BY r) FROM hz ORDER BY r")
    _check(hz, "SELECT r, COUNT(*) OVER (PARTITION BY SQRT(f - 1.0)), "
               "SUM(v) OVER (PARTITION BY SQRT(f - 1.0)) FROM hz ORDER BY r")


def test_nan_and_subnormal_order_keys_are_peers_of_zero(hz):
    """NaN orders as 0.0, and -0.0 and subnormals compare equal to it, so
    all of them are one peer group."""
    _check(hz, "SELECT r, RANK() OVER (ORDER BY f), SUM(v) OVER (ORDER BY f), "
               "DENSE_RANK() OVER (ORDER BY f DESC) FROM hz ORDER BY r")
    _check(hz, "SELECT r, RANK() OVER (ORDER BY SQRT(f - 1.0)), "
               "SUM(v) OVER (PARTITION BY k ORDER BY SQRT(f - 1.0) DESC) FROM hz ORDER BY r")


@pytest.mark.parametrize("key", ["t", "f"], ids=["packed", "generic"])
@pytest.mark.parametrize("nulls", ["NULLS FIRST", "NULLS LAST"])
@pytest.mark.parametrize("direction", ["ASC", "DESC"])
def test_nulls_first_last(hz, key, nulls, direction):
    _check(hz, f"SELECT r, ROW_NUMBER() OVER (ORDER BY {key} {direction} {nulls}), "
               f"SUM(v) OVER (PARTITION BY k ORDER BY {key} {direction} {nulls}), "
               f"LAG(r) OVER (ORDER BY {key} {direction} {nulls}) FROM hz ORDER BY r")


def test_empty_frames_are_null(hz):
    _check(hz, "SELECT r, SUM(v) OVER (PARTITION BY k ORDER BY r "
               "ROWS BETWEEN 1 FOLLOWING AND 2 FOLLOWING), "
               "MIN(v) OVER (PARTITION BY k ORDER BY r "
               "ROWS BETWEEN 3 PRECEDING AND 2 PRECEDING), "
               "COUNT(v) OVER (PARTITION BY k ORDER BY r "
               "ROWS BETWEEN 2 FOLLOWING AND 3 FOLLOWING), "
               "FIRST_VALUE(v) OVER (PARTITION BY k ORDER BY r "
               "ROWS BETWEEN 2 FOLLOWING AND 4 FOLLOWING) FROM hz ORDER BY r")


def test_frames_clamped_at_partition_edges(hz):
    _check(hz, "SELECT r, AVG(v) OVER (PARTITION BY k ORDER BY r "
               "ROWS BETWEEN 5 PRECEDING AND 5 FOLLOWING), "
               "MAX(v) OVER (PARTITION BY k ORDER BY r "
               "ROWS BETWEEN 4 PRECEDING AND 1 FOLLOWING), "
               "SUM(r) OVER (PARTITION BY k ORDER BY r "
               "ROWS BETWEEN 2 PRECEDING AND 9 FOLLOWING), "
               "LAST_VALUE(v) OVER (PARTITION BY k ORDER BY r "
               "ROWS BETWEEN CURRENT ROW AND 8 FOLLOWING) FROM hz ORDER BY r")


@pytest.mark.parametrize("key", ["k", "f"], ids=["packed", "generic"])
def test_pad_rows_form_their_own_partition(hz, key):
    """13 rows in a 16-row bucket: the last partition's COUNT(*), ROW_NUMBER
    and LEAD must not see the 3 pad rows after it."""
    port = _check(hz, f"SELECT r, COUNT(*) OVER (PARTITION BY {key}), "
                      f"ROW_NUMBER() OVER (PARTITION BY {key} ORDER BY r DESC), "
                      f"LEAD(r) OVER (ORDER BY {key} NULLS LAST, r), "
                      f"COUNT(*) OVER (ORDER BY {key} NULLS LAST) FROM hz ORDER BY r")
    assert port.executor.window_runs  # the window ran in the port


def test_window_over_group_by_and_filter_compound(hz):
    """A window over an aggregate, a filter Compound over a window (top-N per
    group), an expression with a window, and a Sort / top-k over one."""
    _check(hz, "SELECT k, s, RANK() OVER (ORDER BY s DESC) FROM "
               "(SELECT k, SUM(v) s FROM hz GROUP BY k) q")
    # the planner refuses a window beside an aggregate in one SELECT, in both
    for db, ns in zip(hz, (JNotSupported, NotSupported)):
        with pytest.raises(ns):
            db.sql("SELECT k, SUM(v), RANK() OVER (ORDER BY SUM(v) DESC) FROM hz GROUP BY k")
    _check(hz, "SELECT k, r, v FROM (SELECT k, r, v, RANK() OVER (PARTITION BY k "
               "ORDER BY v DESC NULLS LAST) rk FROM hz) q WHERE rk <= 2")
    _check(hz, "SELECT r, v - AVG(v) OVER (PARTITION BY k) FROM hz ORDER BY r")
    _check(hz, "SELECT r, SUM(v) OVER (ORDER BY r) s FROM hz ORDER BY s DESC LIMIT 3")


def test_window_node_never_streams():
    """A GROUP BY over a window over a table past the stream threshold
    runs in one piece, as the reference's (a Window is never streamed)."""
    from heavydb_tpu_torch.config import Config

    rng = np.random.default_rng(3)
    n = 30_000
    cols = {"k": rng.integers(0, 10, n).astype(np.int32),
            "x": rng.integers(0, 1000, n).astype(np.int32), "v": rng.random(n)}
    ref = hdt.connect()
    port = hdt_torch.connect(device="cpu", config=Config(stream_threshold_bytes=50_000,
                                                         default_fragment_rows=4096))
    for db in (ref, port):
        db.sql("CREATE TABLE big (k INT, x INT, v DOUBLE) WITH (fragment_size=4096)")
        db.load_table("big", cols)
    q = ("SELECT k, COUNT(*), MAX(rs), SUM(rn) FROM (SELECT k, SUM(v) OVER "
         "(PARTITION BY k ORDER BY x) rs, ROW_NUMBER() OVER (PARTITION BY k ORDER BY x) rn "
         "FROM big) t GROUP BY k")
    _check((ref, port), q)
    assert port.executor.waves_run == 0
