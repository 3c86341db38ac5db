"""The slice as a whole: the same tables in heavydb_tpu.connect() and in
heavydb_tpu_torch.connect(device="cpu") (copied through load_state), the
same SELECTs through both, the same rows out.  GROUP BY results are
compared as multisets.

Tolerances: integers (counts, integer sums, MIN/MAX, keys) are exact;
float64 results (DOUBLE sums, AVG) use rtol=1e-9; SUM over FLOAT columns
uses rtol=1e-4, atol=1e-3 (float32 accumulation in another order).
"""

import math

import numpy as np
import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from benchmarks.synthetic import QUERIES, make_table
from heavydb_tpu.errors import DivisionByZero as JDivisionByZero
from heavydb_tpu_torch.errors import DivisionByZero, NotSupported
from heavydb_tpu_torch.kernels import groupby_minmax, lane_agg, radix_hist
from heavydb_tpu_torch.plan.optimizer import optimize
from heavydb_tpu_torch.sql.parser import parse_many

N_ROWS = 20_000


def _copy_state(ref_db, names, fragment_size=None):
    """Read table definitions, physical columns and dictionaries off the
    reference catalog and rebuild them in a port Database."""
    tables, dicts = [], {}
    for name in names:
        t = ref_db.catalog.get_table(name)
        tables.append((
            name,
            [(cd.name, str(cd.type)) for cd in t.columns],
            {cd.name: np.asarray(t.column_values(cd.col_id)) for cd in t.columns},
        ))
        dicts[name] = {cd.name: list(t.dicts[cd.col_id].entries())
                       for cd in t.columns if cd.type.is_dict_string}
    db = hdt_torch.connect(device="cpu")
    hdt_torch.load_state(db, tables, dicts=dicts, fragment_size=fragment_size)
    return db


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(11)
    n = N_ROWS
    ref = hdt.connect()
    ref.sql("CREATE TABLE t (k10 INT, k100 INT, k1k INT, k5k INT, k100k INT, "
            "x INT, b BIGINT, v FLOAT, d DOUBLE, s TEXT) "
            "WITH (fragment_size=6000)")
    nul = lambda p: rng.random(n) < p  # noqa: E731
    i32min = np.iinfo(np.int32).min
    cols = {
        "k10": np.where(nul(0.05), i32min, rng.integers(1, 11, n)).astype(np.int32),
        "k100": rng.integers(1, 101, n).astype(np.int32),
        "k1k": rng.integers(0, 1000, n).astype(np.int32),
        "k5k": rng.integers(-2500, 2500, n).astype(np.int32),
        "k100k": rng.integers(0, 100_000, n).astype(np.int32),
        "x": np.where(nul(0.1), i32min, rng.integers(-1000, 1000, n)).astype(np.int32),
        "b": rng.integers(-2**40, 2**40, n).astype(np.int64),
        "v": np.where(nul(0.1), np.nan, rng.random(n)).astype(np.float32),
        "d": rng.standard_normal(n) * 100,
    }
    t = ref.catalog.get_table("t")
    sid = t.dict_for(t.column_by_name("s").col_id).get_or_add_bulk(
        [["red", "green", "blue"][i] for i in rng.integers(0, 3, n)])
    cols["s"] = sid
    t.insert_columns({cd.col_id: cols[cd.name] for cd in t.columns})
    make_table(ref, 10_000, 4096, seed=3)
    ref.sql("CREATE TABLE td (d DATE, ts TIMESTAMP, amt DECIMAL(10,2), k INT)")
    td = ref.catalog.get_table("td")
    m = 5000
    phys = {
        "d": rng.integers(17_897, 19_000, m),        # days, 2019..2022
        "ts": rng.integers(1_577_836_800, 1_667_836_800, m),  # seconds
        "amt": rng.integers(-100_000, 100_000, m),   # cents
        "k": rng.integers(0, 12, m),
    }
    arrays = {}
    for cd in td.columns:
        a = phys[cd.name].astype(cd.type.np_dtype())
        a[rng.random(m) < 0.06] = cd.type.null_sentinel()
        arrays[cd.col_id] = a
    td.insert_columns(arrays)
    port = _copy_state(ref, ["t", "bench", "td"], fragment_size=None)
    return ref, port


def _canon(rows):
    def key(r):
        return tuple((v is None, "" if v is None else
                      (round(v, 4) if isinstance(v, float) else v)) for v in r)
    return sorted(rows, key=key)


def _same_rows(got, want, f32_cols=()):
    assert len(got) == len(want)
    for gr, wr in zip(_canon(got), _canon(want)):
        assert len(gr) == len(wr)
        for j, (g, w) in enumerate(zip(gr, wr)):
            if isinstance(w, float) and w is not None:
                assert g is not None
                if math.isnan(w):
                    assert math.isnan(g)
                elif j in f32_cols:
                    assert g == pytest.approx(w, rel=1e-4, abs=1e-3), (gr, wr)
                else:
                    assert g == pytest.approx(w, rel=1e-9, abs=1e-12), (gr, wr)
            else:
                assert g == w, (j, gr, wr)


def _check(engines, sql, f32_cols=()):
    ref, port = engines
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same_rows(got, want, f32_cols)
    return got


QUERIES_T = [
    # keyless
    ("SELECT COUNT(*), SUM(x), AVG(v), MIN(d), MAX(b), COUNT(v) FROM t", ()),
    ("SELECT COUNT(*), SUM(x), AVG(v), AVG(d) FROM t WHERE k10 > 3 AND v < 0.5",
     ()),
    ("SELECT SUM(v), MAX(v) FROM t WHERE k10 > 3", (0,)),
    ("SELECT COUNT(*) FROM t WHERE k10 IN (1, 3, 5) OR x BETWEEN 0 AND 100", ()),
    ("SELECT COUNT(*), SUM(k100) FROM t WHERE NOT (k10 = 2) AND k10 IS NOT NULL",
     ()),
    # perfect hash at 10 (+ NULL), 100, 1000, 5000 and 100000 slots
    ("SELECT k10, COUNT(*), COUNT(x), SUM(x), AVG(x), MIN(v), MAX(v), SUM(d) "
     "FROM t GROUP BY k10", ()),
    ("SELECT k100, COUNT(*), SUM(v), AVG(d), MIN(x), MAX(x) FROM t GROUP BY k100",
     (2,)),
    ("SELECT k1k, COUNT(*), SUM(b), MIN(v), MAX(d) FROM t WHERE x IS NOT NULL "
     "GROUP BY k1k", ()),
    ("SELECT k5k, COUNT(*), SUM(x), AVG(v), MIN(x), MAX(v) FROM t GROUP BY k5k",
     ()),
    ("SELECT k100k, COUNT(*), SUM(x), MAX(d), MIN(b) FROM t GROUP BY k100k", ()),
    ("SELECT k10, k100, COUNT(*), SUM(v), STDDEV(d) FROM t GROUP BY k10, k100",
     (3,)),
    # HAVING, CASE, CAST, arithmetic
    ("SELECT k100, COUNT(*) c, SUM(x) FROM t GROUP BY k100 HAVING COUNT(*) > 200",
     ()),
    ("SELECT k10, SUM(CASE WHEN x > 0 THEN x ELSE 0 END), "
     "COUNT(CASE WHEN v > 0.5 THEN 1 END) FROM t GROUP BY k10", ()),
    ("SELECT CAST(k10 AS DOUBLE) key0, COUNT(*), SUM(CAST(x AS BIGINT)), "
     "AVG(CAST(v AS DOUBLE)) FROM t GROUP BY key0", ()),
    ("SELECT k10, SUM(x * 2 + 1), AVG(d / 3.0), MAX(x - k100), MIN(k100 % 7) "
     "FROM t GROUP BY k10", ()),
    ("SELECT k10 + 1 AS kk, COUNT(*) FROM t WHERE d > 0 GROUP BY kk", ()),
    # projection
    ("SELECT k10, x + 1, v * 2, d FROM t WHERE k100 < 5", ()),
    # TEXT dictionary copied by load_state
    ("SELECT s, COUNT(*), SUM(x) FROM t GROUP BY s", ()),
    # rowid-hashed sampling
    ("SELECT COUNT(*), SUM(x) FROM t WHERE SAMPLE_RATIO(0.3)", ()),
    # dates, timestamps, decimals; DATE_TRUNC keys are bucketed ranges
    ("SELECT EXTRACT(YEAR FROM d), COUNT(*), SUM(amt) FROM td GROUP BY 1", ()),
    ("SELECT DATE_TRUNC(month, d) mo, COUNT(*), AVG(amt) FROM td GROUP BY mo",
     ()),
    ("SELECT EXTRACT(HOUR FROM ts), EXTRACT(DOW FROM d), COUNT(*) FROM td "
     "GROUP BY 1, 2", ()),
    ("SELECT k, MIN(d), MAX(ts), SUM(amt), MAX(amt) FROM td "
     "WHERE d IS NOT NULL GROUP BY k", ()),
    ("SELECT COUNT(*) FROM td WHERE d >= DATE '2021-01-01' AND amt > 0", ()),
]


@pytest.mark.parametrize("sql,f32_cols", QUERIES_T, ids=range(len(QUERIES_T)))
def test_slice_queries_match_reference(engines, sql, f32_cols):
    _check(engines, sql, f32_cols)


@pytest.mark.parametrize("name", ["NGA01", "NGA02", "NGA03", "PHS002", "PHS003",
                                  "PHM001", "PHM002"])
def test_synthetic_queries_match_reference(engines, name):
    _check(engines, QUERIES[name].replace("##TAB##", "bench"))


def test_kernel_counters_stay_zero_on_cpu(engines):
    _check(engines, "SELECT k1k, MIN(x), SUM(v) FROM t GROUP BY k1k", (2,))
    assert lane_agg.lane_agg.launches == 0
    assert radix_hist.fused_hist.launches == 0
    assert groupby_minmax.minmax_per_slot.launches == 0


def test_division_by_zero_raises_in_both(engines):
    ref, port = engines
    sql = "SELECT k10, SUM(x / (k100 - k100)) FROM t GROUP BY k10"
    with pytest.raises(JDivisionByZero):
        ref.sql(sql).rows()
    with pytest.raises(DivisionByZero):
        port.sql(sql).rows()
    # a divisor that is zero only on filtered-out rows does not raise
    _check(engines, "SELECT COUNT(*), SUM(x / k100) FROM t WHERE k100 > 1")


@pytest.mark.parametrize("sql", [
    "SELECT k10, COUNT(*) FROM t GROUP BY k10 ORDER BY k10",
    "SELECT a.k10, COUNT(*) FROM t a JOIN t b ON a.k100 = b.k100 GROUP BY a.k10",
    "SELECT x FROM t ORDER BY x LIMIT 3",
    "SELECT k10, COUNT(DISTINCT k100) FROM t GROUP BY k10",
])
def test_out_of_slice_queries_raise(engines, sql):
    _, port = engines
    with pytest.raises(NotSupported):
        port.sql(sql).rows()


def test_insert_and_drop_round_trip():
    db = hdt_torch.connect(device="cpu")
    db.sql("CREATE TABLE q (a INT, f DOUBLE)")
    db.sql("INSERT INTO q VALUES (1, 1.5), (2, NULL), (1, 2.5), (NULL, 4.0)")
    assert sorted(db.sql("SELECT a, COUNT(*), SUM(f) FROM q GROUP BY a").rows(),
                  key=str) == sorted([(1, 2, 4.0), (2, 1, None), (None, 1, 4.0)],
                                     key=str)
    db.sql("DROP TABLE q")
    assert db.catalog.get_table_opt("q") is None


def test_load_table_device_fragments_and_skipping():
    """Device-resident ingest: fragments are views of the loaded tensors,
    chunk stats come from the device, and a filter that rules out whole
    fragments scans the survivors as slices of the resident columns."""
    import torch

    rng = np.random.default_rng(5)
    k = np.sort(rng.integers(0, 50, 2500)).astype(np.int32)
    v = rng.random(2500).astype(np.float32)
    db = hdt_torch.connect(device="cpu")
    db.sql("CREATE TABLE dv (k INT, v FLOAT) WITH (fragment_size=1000)")
    db.load_table_device("dv", {"k": torch.from_numpy(k), "v": torch.from_numpy(v)})
    t = db.catalog.get_table("dv")
    assert [f.num_rows for f in t.fragments] == [1000, 1000, 500]
    assert t.fragments[0].stats[t.columns[0].col_id].max == int(k[999])
    lo = int(k[1500])
    sql = f"SELECT k, COUNT(*), SUM(v), MAX(v) FROM dv WHERE k >= {lo} GROUP BY k"
    plan = optimize(db._plan_select(parse_many(sql)[0]))
    assert db.executor._surviving_fragments(plan.inputs[0],
                                            plan.filter_cond) == [1, 2]
    batch, decode = db.sql_device(sql)
    got = sorted(decode().rows())
    sel = k >= lo
    want = []
    for key in np.unique(k[sel]):
        m = sel & (k == key)
        want.append((int(key), int(m.sum()), float(v[m].astype(np.float64).sum()),
                     float(v[m].max())))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3] == w[3]
        assert g[2] == pytest.approx(w[2], rel=1e-4, abs=1e-3)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024])
def test_row_mask_at_domain_edges(n):
    """The row mask of a padded domain holds exactly the table's rows at
    nrows = 0, 1, padded - 1 and padded (1023 and 1024 rows both pad to
    1024): projections, filters, keyless and grouped aggregates give the
    reference's rows."""
    from heavydb_tpu_torch.exec.batch import bucket

    assert bucket(1023) == bucket(1024) == 1024
    rng = np.random.default_rng(n)
    ref = hdt.connect()
    ref.sql("CREATE TABLE m (k INT, x INT, d DOUBLE)")
    if n:
        t = ref.catalog.get_table("m")
        cols = {"k": rng.integers(0, 5, n).astype(np.int32),
                "x": rng.integers(-50, 50, n).astype(np.int32),
                "d": rng.standard_normal(n)}
        t.insert_columns({cd.col_id: cols[cd.name] for cd in t.columns})
    port = _copy_state(ref, ["m"])
    for sql in ("SELECT k, x, d FROM m",
                "SELECT x FROM m WHERE k > 2",
                "SELECT COUNT(*), SUM(x), SUM(d) FROM m",
                "SELECT COUNT(*) FROM m WHERE x < 0",
                "SELECT k, COUNT(*), SUM(x), AVG(d) FROM m GROUP BY k"):
        _same_rows(port.sql(sql).rows(), ref.sql(sql).rows())
