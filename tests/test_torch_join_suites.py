"""Joins: the queries of the reference's join suites (test_join_order_full,
test_filter_pushdown, test_selectivity_probe, and the TPC-H shapes of
test_tpch_lite, string predicates included) through heavydb_tpu.connect()
and, copied through load_state, heavydb_tpu_torch.connect(device="cpu"),
compared as tests/test_torch_join.py compares them (`_check`)."""

import numpy as np
import pytest

import heavydb_tpu as hdt
from heavydb_tpu_torch.exec import executor as X
from tests import test_tpch_lite as TL
from tests.test_torch_engine import _copy_state
from tests.test_torch_join import I32_NULL, _check, _pair



@pytest.fixture(scope="module")
def order_suite():
    """tests/test_join_order_full.py's tables."""
    rng = np.random.default_rng(42)
    ref = hdt.connect()
    n = 5000
    ref.load_table("fact", {"k": rng.integers(0, 500, n).astype(np.int32),
                            "v": rng.random(n).astype(np.float32)}, create=True)
    ref.load_table("dim", {"k": np.arange(500, dtype=np.int32),
                           "nm": rng.integers(0, 20, 500).astype(np.int32)}, create=True)
    ref.load_table("f3", {"k": rng.integers(0, 300, 2000).astype(np.int32),
                          "v": rng.integers(0, 100, 2000).astype(np.int32)}, create=True)
    ref.load_table("m3", {"k": rng.integers(0, 300, 400).astype(np.int32),
                          "g": rng.integers(0, 9, 400).astype(np.int32)}, create=True)
    ref.load_table("d3", {"k": np.arange(300, dtype=np.int32)}, create=True)
    lk = rng.integers(0, 2000, 4000)
    lk = np.where(rng.random(4000) < 0.05, I32_NULL, lk).astype(np.int32)
    ref.sql("CREATE TABLE fl (k INT, v INT)")
    ref.load_table("fl", {"k": lk, "v": rng.integers(0, 100, 4000).astype(np.int32)})
    ref.load_table("fr", {"k": rng.integers(1000, 3000, 3000).astype(np.int32),
                          "v": rng.integers(0, 100, 3000).astype(np.int32)}, create=True)
    ref.sql("CREATE TABLE lg (k INT, s TEXT)")
    ref.sql("CREATE TABLE rg (k INT, v INT)")
    ref.sql("INSERT INTO lg VALUES (1,'a'), (2,'b'), (3,'c'), (NULL,'d'), (2,'e')")
    ref.sql("INSERT INTO rg VALUES (2,10), (4,20), (NULL,30), (2,40)")
    ref.sql("CREATE TABLE pa (k INT)")
    ref.sql("CREATE TABLE pb (k INT)")
    ref.sql("INSERT INTO pa VALUES (1), (2)")
    ref.sql("INSERT INTO pb VALUES (2), (3)")
    ref.sql("CREATE TABLE lo (k INT, d INT)")
    ref.load_table("lo", {"k": [1, 2, 3, None], "d": [10, 20, 30, 5]})
    ref.sql("CREATE TABLE ll (k INT, s INT, w DOUBLE)")
    ref.load_table("ll", {"k": [1, 1, 2, 3], "s": [5, 15, 19, 40],
                          "w": [1.0, 2.0, 3.0, 4.0]})
    ref.sql("CREATE TABLE njl (x INT)")
    ref.load_table("njl", {"x": [1, 2, 3, 4, None]})
    ref.sql("CREATE TABLE njr (y INT, v INT)")
    ref.load_table("njr", {"y": [2, 3, 3], "v": [10, -5, None]})
    names = ["fact", "dim", "f3", "m3", "d3", "fl", "fr", "lg", "rg", "pa", "pb",
             "lo", "ll", "njl", "njr"]
    return _pair(ref, names)


ORDER_QUERIES = [
    ("SELECT d.nm, count(*), sum(f.v) FROM fact f JOIN dim d ON f.k = d.k "
     "GROUP BY d.nm ORDER BY d.nm", (2,)),
    ("SELECT d.nm, count(*), sum(f.v) FROM dim d JOIN fact f ON d.k = f.k "
     "GROUP BY d.nm ORDER BY d.nm", (2,)),
    ("SELECT count(*) FROM dim s JOIN fact b ON s.k = b.k", ()),
    ("SELECT m.g, count(*), sum(f.v) FROM f3 f JOIN m3 m ON f.k=m.k "
     "JOIN d3 d ON m.k=d.k GROUP BY m.g ORDER BY m.g", ()),
    ("SELECT m.g, count(*), sum(f.v) FROM d3 d JOIN m3 m ON d.k=m.k "
     "JOIN f3 f ON m.k=f.k GROUP BY m.g ORDER BY m.g", ()),
    ("SELECT m.g, count(*), sum(f.v) FROM m3 m JOIN d3 d ON m.k=d.k "
     "JOIN f3 f ON d.k=f.k GROUP BY m.g ORDER BY m.g", ()),
    ("SELECT count(*), count(fl.v), count(fr.v), sum(fl.v), sum(fr.v) "
     "FROM fl FULL OUTER JOIN fr ON fl.k = fr.k", ()),
    ("SELECT rg.v, count(*), count(lg.s) FROM lg FULL JOIN rg "
     "ON lg.k = rg.k GROUP BY rg.v ORDER BY rg.v NULLS FIRST", ()),
    ("SELECT pa.k, pb.k FROM pa FULL JOIN pb ON pa.k = pb.k", ()),
    ("SELECT lo.k, lo.d, ll.s, ll.w FROM lo LEFT JOIN ll "
     "ON lo.k = ll.k AND ll.s > lo.d ORDER BY lo.k NULLS LAST, ll.s NULLS LAST", ()),
    ("SELECT lo.k, count(ll.s) FROM lo LEFT JOIN ll "
     "ON lo.k = ll.k AND ll.s > lo.d GROUP BY lo.k ORDER BY lo.k NULLS LAST", ()),
    ("SELECT lo.k, sum(ll.w) FROM lo LEFT JOIN ll "
     "ON lo.k = ll.k AND ll.s <> lo.d + 5 GROUP BY lo.k ORDER BY lo.k NULLS LAST", ()),
    ("SELECT lo.k, ll.s FROM lo LEFT JOIN ll ON lo.k = ll.k AND ll.s < 10 "
     "ORDER BY lo.k NULLS LAST, ll.s NULLS LAST", ()),
    ("SELECT k FROM lo WHERE EXISTS (SELECT 1 FROM ll "
     "WHERE ll.k = lo.k AND ll.s > lo.d) ORDER BY k", ()),
    ("SELECT k, d FROM lo WHERE NOT EXISTS (SELECT 1 FROM ll "
     "WHERE ll.k = lo.k AND ll.s > lo.d) ORDER BY k NULLS LAST", ()),
    ("SELECT k FROM lo WHERE EXISTS (SELECT 1 FROM ll "
     "WHERE ll.k = lo.k AND ll.s <> lo.d AND ll.s < 20) ORDER BY k", ()),
    ("SELECT njl.x, njr.v FROM njl LEFT JOIN njr ON njl.x=njr.y "
     "WHERE njr.v > 0 ORDER BY njl.x", ()),
    ("SELECT njl.x FROM njl LEFT JOIN njr ON njl.x=njr.y "
     "WHERE njr.v IS NULL ORDER BY njl.x NULLS LAST", ()),
    ("SELECT njl.x, njr.v FROM njl LEFT JOIN njr ON njl.x=njr.y "
     "WHERE njr.v > 0 OR njl.x = 1 ORDER BY njl.x", ()),
    ("SELECT njl.x, njr.y FROM njl LEFT JOIN njr ON njl.x=njr.y "
     "WHERE NOT (njr.v = 10) ORDER BY njl.x, njr.v", ()),
    ("SELECT njl.x, njr.y, njr.v FROM njl FULL OUTER JOIN njr "
     "ON njl.x=njr.y WHERE njl.x > 0 AND njr.v IS NOT NULL ORDER BY njl.x, njr.v", ()),
]


@pytest.mark.parametrize("sql,f32", ORDER_QUERIES)
def test_join_order_suite(order_suite, sql, f32):
    _check(order_suite, sql, f32)


def test_reorder_flips_probe_side(order_suite):
    """The runtime reorder makes the larger input the probe."""
    _, port = order_suite
    captured = []
    orig = X.Executor._plan_compound

    def spy(self, node, batches, offsets=(0,)):
        if node.join_levels:
            captured.append([i.table.name for i in node.inputs])
        return orig(self, node, batches, offsets)

    X.Executor._plan_compound = spy
    try:
        port.sql("SELECT count(*) FROM dim s JOIN fact b ON s.k = b.k").rows()
    finally:
        X.Executor._plan_compound = orig
    assert captured == [["fact", "dim"]]


def test_fragment_skipping_around_outer_joins():
    """Pruning fragments by chunk stats (each input with its own field
    offset) gives the rows of an unfragmented run, around FULL and LEFT
    joins, in both engines."""
    from heavydb_tpu.config import Config as JConfig

    rng = np.random.default_rng(3)
    n = 12_000
    cols_l = {"k": rng.integers(0, 3000, n).astype(np.int32),
              "v": np.sort(rng.integers(0, 1000, n)).astype(np.int32)}
    cols_r = {"k": rng.integers(1500, 4500, 4000).astype(np.int32),
              "v": np.sort(rng.integers(0, 1000, 4000)).astype(np.int32)}
    queries = [
        "SELECT count(*), count(l.v), count(r.v) FROM l FULL JOIN r ON l.k = r.k "
        "WHERE l.v > 500",
        "SELECT count(*) FROM l FULL JOIN r ON l.k = r.k WHERE r.v < 100",
        "SELECT count(*) FROM l LEFT JOIN r ON l.k = r.k WHERE l.v BETWEEN 100 AND 200",
        "SELECT count(*), sum(l.v) FROM l JOIN r ON l.k = r.k WHERE r.v > 900",
    ]
    results = []
    for frag in (100_000, 2_000):
        ref = hdt.connect(config=JConfig(default_fragment_rows=frag))
        ref.load_table("l", cols_l, create=True)
        ref.load_table("r", cols_r, create=True)
        port = _copy_state(ref, ["l", "r"], fragment_size=frag)
        assert len(port.catalog.get_table("r").fragments) == (2 if frag < 4000 else 1)
        got = [port.sql(q).rows() for q in queries]
        assert got == [ref.sql(q).rows() for q in queries]
        results.append(got)
    assert results[0] == results[1]


@pytest.fixture(scope="module")
def pushdown_suite():
    """tests/test_filter_pushdown.py's and test_selectivity_probe.py's
    tables (pf, pd; big, mid) and its cap case (bigf, bigd)."""
    rng = np.random.default_rng(42)
    ref = hdt.connect()
    n, m = 4000, 500
    ref.sql("CREATE TABLE pf (k INT, x INT, v DOUBLE)")
    x = rng.integers(-100, 100, n).astype(np.int32)
    x[::9] = I32_NULL
    ref.load_table("pf", {"k": rng.integers(0, 40, n).astype(np.int32), "x": x,
                          "v": np.round(rng.normal(0, 10, n), 3)})
    ref.sql("CREATE TABLE pd (k INT, g INT, w DOUBLE)")
    g = rng.integers(0, 8, m).astype(np.int32)
    g[::6] = I32_NULL
    ref.load_table("pd", {"k": rng.integers(0, 50, m).astype(np.int32), "g": g,
                          "w": np.round(rng.uniform(0, 5, m), 2)})
    ref.load_table("bigf", {"k": rng.integers(0, 10, 5000).astype(np.int32)}, create=True)
    ref.load_table("bigd", {"k": np.repeat(np.arange(10, dtype=np.int32), 200),
                            "sel": np.tile(np.arange(200, dtype=np.int32), 10)},
                   create=True)
    n_big, n_mid = 40_000, 1_000
    ref.load_table("big", {"k": rng.integers(0, n_mid, n_big).astype(np.int32),
                           "sel": rng.integers(0, 10_000, n_big).astype(np.int32),
                           "v": rng.random(n_big).astype(np.float32)}, create=True)
    ref.load_table("mid", {"k": np.arange(n_mid, dtype=np.int32),
                           "grp": rng.integers(0, 7, n_mid).astype(np.int32)}, create=True)
    return _pair(ref, ["pf", "pd", "bigf", "bigd", "big", "mid"])


PUSHDOWN_QUERIES = [
    "SELECT count(*), sum(f.v) FROM pf f JOIN pd d ON f.k = d.k WHERE f.x > 0",
    "SELECT count(*), sum(f.v) FROM pf f JOIN pd d ON f.k = d.k WHERE d.g < 4",
    "SELECT count(*) FROM pf f JOIN pd d ON f.k = d.k "
    "WHERE f.x > -50 AND d.g <= 5 AND f.v < d.w * 20",
    "SELECT count(*) FROM pf f JOIN pd d ON f.k = d.k WHERE f.x <> 3 AND d.g <> 2",
    "SELECT d.g, count(*), sum(f.v) FROM pf f JOIN pd d ON f.k = d.k "
    "WHERE f.x > 10 AND d.w > 1.0 GROUP BY d.g ORDER BY d.g NULLS FIRST",
    "SELECT count(*), count(d.g) FROM pf f LEFT JOIN pd d ON f.k = d.k WHERE f.x > 0",
    "SELECT count(*) FROM pf f LEFT JOIN pd d ON f.k = d.k WHERE f.x > 0 AND d.g IS NULL",
    "SELECT count(*) FROM pf f JOIN pd d ON f.k = d.k JOIN pd e ON f.k = e.k "
    "WHERE f.x > 0 AND d.g = 1 AND e.g = 2",
    "SELECT count(*) FROM bigf f JOIN bigd d ON f.k = d.k WHERE d.sel = 0",
    "SELECT m.grp, count(*) FROM big b JOIN mid m ON b.k = m.k "
    "WHERE b.sel < 5 GROUP BY m.grp ORDER BY m.grp",
    "SELECT m.grp, sum(b.v) FROM big b JOIN mid m ON b.k = m.k "
    "WHERE b.sel < 100 GROUP BY m.grp ORDER BY m.grp",
]


@pytest.mark.parametrize("sql", PUSHDOWN_QUERIES)
def test_pushdown_and_probe_suite(pushdown_suite, sql):
    _check(pushdown_suite, sql, (1,) if "sum(b.v)" in sql else ())


def _planned(db, sql):
    captured = []
    orig = X.Executor._plan_compound

    def spy(self, node, batches, offsets=(0,)):
        plan = orig(self, node, batches, offsets)
        if node.join_levels:
            captured.append(plan)
        return plan

    X.Executor._plan_compound = spy
    try:
        db.sql(sql).rows()
    finally:
        X.Executor._plan_compound = orig
    return captured[-1]


def test_pushdown_split(pushdown_suite):
    """The split as the reference makes it: a probe-side conjunct to the
    mask, a build-side one into an INNER build, none of a LEFT build, no
    DIV conjunct, and the build filter shrinks the expansion's need."""
    _, port = pushdown_suite
    plan = _planned(port, "SELECT count(*) FROM pf f JOIN pd d ON f.k = d.k "
                          "WHERE f.x > 0 AND d.g < 4 AND f.v < d.w * 20")
    assert len(plan.pre_mask) == 1 and len(plan.build_filters.get(1, [])) == 1
    assert plan.filter_rest == [] and any(jp.residual for jp in plan.joins)
    plan = _planned(port, "SELECT count(*) FROM pf f LEFT JOIN pd d ON f.k = d.k "
                          "WHERE f.x > 0 AND d.g IS NULL")
    assert len(plan.pre_mask) == 1 and not plan.build_filters
    assert len(plan.filter_rest) == 1
    plan = _planned(port, "SELECT count(*) FROM pf f JOIN pd d ON f.k = d.k "
                          "WHERE 100 / (f.x + 200) > 0")
    assert not plan.pre_mask and len(plan.filter_rest) == 1
    port.sql("SELECT count(*) FROM bigf f JOIN bigd d ON f.k = d.k WHERE d.sel = 0").rows()
    (run,) = port.executor.join_runs
    assert run.retries <= 1 and run.caps[0] < 4 * 5000


def test_selectivity_probe_cached(pushdown_suite):
    _, port = pushdown_suite
    sql = "SELECT count(*) FROM big b JOIN mid m ON b.k = m.k WHERE b.sel < 5"
    port.sql(sql).rows()
    assert any(k[0] == "selprobe" for k in port.executor._sel_cache)
    size = len(port.executor._sel_cache)
    port.sql(sql).rows()
    assert len(port.executor._sel_cache) == size


@pytest.fixture(scope="module")
def tpch():
    """tests/test_tpch_lite.py's schema at its sizes."""
    rng = np.random.default_rng(42)
    ref = hdt.connect()
    n_part, n_cust, n_ord, n_li = 200, 150, 1200, 6000
    ref.sql("CREATE TABLE part (p_partkey INT, p_brand TEXT, p_size INT, "
            "p_retailprice DOUBLE)")
    ref.load_table("part", {
        "p_partkey": np.arange(n_part, dtype=np.int32),
        "p_brand": [f"Brand#{v}" for v in rng.integers(1, 6, n_part)],
        "p_size": rng.integers(1, 51, n_part).astype(np.int32),
        "p_retailprice": np.round(900 + rng.uniform(0, 1200, n_part), 2)})
    ref.sql("CREATE TABLE customer (c_custkey INT, c_mktsegment TEXT, c_acctbal DOUBLE)")
    ref.load_table("customer", {
        "c_custkey": np.arange(n_cust, dtype=np.int32),
        "c_mktsegment": [["BUILDING", "AUTOMOBILE", "MACHINERY", "HOUSEHOLD",
                          "FURNITURE"][v] for v in rng.integers(0, 5, n_cust)],
        "c_acctbal": np.round(rng.uniform(-999, 9999, n_cust), 2)})
    ref.sql("CREATE TABLE orders (o_orderkey INT, o_custkey INT, o_orderdate INT, "
            "o_totalprice DOUBLE)")
    ref.load_table("orders", {
        "o_orderkey": np.arange(n_ord, dtype=np.int32),
        "o_custkey": rng.integers(0, n_cust, n_ord).astype(np.int32),
        "o_orderdate": rng.integers(8000, 11000, n_ord).astype(np.int32),
        "o_totalprice": np.round(rng.uniform(100, 400000, n_ord), 2)})
    ref.sql("CREATE TABLE lineitem (l_orderkey INT, l_partkey INT, l_quantity INT, "
            "l_extendedprice DOUBLE, l_discount DOUBLE, l_returnflag TEXT, "
            "l_shipdate INT)")
    ref.load_table("lineitem", {
        "l_orderkey": rng.integers(0, n_ord, n_li).astype(np.int32),
        "l_partkey": rng.integers(0, n_part, n_li).astype(np.int32),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.int32),
        "l_extendedprice": np.round(rng.uniform(900, 100000, n_li), 2),
        "l_discount": np.round(rng.uniform(0, 0.1, n_li), 2),
        "l_returnflag": [["A", "N", "R"][v] for v in rng.integers(0, 3, n_li)],
        "l_shipdate": rng.integers(8000, 11000, n_li).astype(np.int32)})
    return _pair(ref, ["part", "customer", "orders", "lineitem"])


# every TPC-H shape of test_tpch_lite.py: correlated subqueries are
# decorrelated into joins by the planner (Q2, Q17, Q20's inner AVG), and
# the uncorrelated ones run first and become constants (Q11, Q15, Q16, Q18,
# Q20, Q22)
TPCH = ["Q1", "Q2", "Q3", "Q4", "Q5", "Q6", "Q7", "Q8", "Q9", "Q10", "Q11", "Q12",
        "Q13", "Q14", "Q15", "Q16", "Q17", "Q18", "Q19", "Q20", "Q21", "Q22"]


@pytest.mark.parametrize("name", TPCH)
def test_tpch_shapes(tpch, name):
    _check(tpch, getattr(TL, name))
