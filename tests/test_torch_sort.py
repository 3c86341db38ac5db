"""ORDER BY, LIMIT / OFFSET and top-k: heavydb_tpu_torch against the JAX
package.

The same seeded tables go into heavydb_tpu.connect() and, copied through
load_state, into heavydb_tpu_torch.connect(device="cpu"); every query must
give the same rows in the same order: each result column bit-equal
(integers, dictionary ids, NULL sentinels, floats with the sign of zero).
A row-number column `r` rides along, so rows with equal keys show the
order they were taken in.  The paths: LIMIT without keys, the full
lexicographic sort, the single-key top-k at n <= 16384 and n > 16384
(ties in row order on both), the packed composite-key top-k, a composite
that does not pack (the full sort), and the top-k over fragment waves.
At the ops level, `sort_permutation`, `topk_indices`, `topk_indices_u`
and `composite_topk_key` against the JAX functions on seeded inputs.

DOUBLE top-k keys above 16384 rows: the reference's arithmetic f64 codec
folds -0.0 into +0.0 and subnormals into 0 there (and not below); the port
orders DOUBLE keys by their exact bits at every size, which
test_double_topk_keeps_exact_order pins against numpy.
"""

import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
import jax.numpy as jnp
from heavydb_tpu.ops import sort as JS
from heavydb_tpu_torch.ops import sort as S
from heavydb_tpu_torch.plan.optimizer import optimize
from heavydb_tpu_torch.sql.parser import parse_many
from tests.test_torch_engine import _copy_state

N = 20_000
FRAG = 4096
STRINGS = ["pear", "apple", "fig", "banana", "kiwi", "cherry", "date", "lime"]


def _nulls(rng, a, p, sentinel):
    a = a.copy()
    a[rng.random(a.shape[0]) < p] = sentinel
    return a


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(8)
    ref = hdt.connect()
    ref.sql("CREATE TABLE st (r INT NOT NULL, i INT, b BIGINT, bw BIGINT, "
            "fz FLOAT NOT NULL, fn FLOAT, d DOUBLE, dz DOUBLE NOT NULL, "
            "dt DATE, s TEXT) "
            f"WITH (fragment_size={FRAG})")
    i32, i64 = np.iinfo(np.int32).min, np.iinfo(np.int64).min
    fz_vals = np.array([-1.5, -0.0, 0.0, 0.5, 2.0, np.nan, np.inf, -np.inf],
                       np.float32)
    dz_vals = np.array([-2.0, -0.0, 0.0, 5e-324, -5e-324, 1e-310, 3.0],
                       np.float64)
    cols = {
        "r": np.arange(N, dtype=np.int32),
        # ~20 rows a value above 16384 rows
        "i": _nulls(rng, rng.integers(-500, 500, N).astype(np.int32), 0.08, i32),
        "b": _nulls(rng, (rng.integers(-2**40, 2**40, N) >> 30 << 30)
                    .astype(np.int64), 0.05, i64),
        # a range chunk stats cannot pack beside another key
        "bw": rng.integers(-2**62, 2**62, N).astype(np.int64),
        "fz": fz_vals[rng.integers(0, fz_vals.shape[0], N)],
        "fn": _nulls(rng, np.round(rng.random(N), 2).astype(np.float32), 0.1,
                     np.nan),
        # no zero and no subnormal: those differ above 16384 rows (below)
        "d": _nulls(rng, np.round(rng.standard_normal(N), 1) + 0.05, 0.05,
                    np.nan),
        "dz": dz_vals[rng.integers(0, dz_vals.shape[0], N)],
        "dt": _nulls(rng, rng.integers(18_000, 18_200, N).astype(np.int32),
                     0.05, i32),
    }
    t = ref.catalog.get_table("st")
    words = [None if rng.random() < 0.05 else STRINGS[j]
             for j in rng.integers(0, len(STRINGS), N)]
    cols["s"] = t.dict_for(t.column_by_name("s").col_id).get_or_add_bulk(words)
    t.insert_columns({cd.col_id: np.asarray(cols[cd.name]).astype(cd.type.np_dtype())
                      for cd in t.columns})
    port = _copy_state(ref, ["st"], fragment_size=FRAG)
    return ref, port


def _same(engines, sql):
    """Both engines give the same rows in the same order, bit for bit."""
    ref, port = engines
    want = ref.sql(sql)
    got = port.sql(sql)
    assert got.row_count == want.row_count, (sql, got.row_count, want.row_count)
    for j in range(want.col_count):
        w = np.ascontiguousarray(want.column_raw(j))
        g = np.ascontiguousarray(got.column_raw(j))
        assert g.dtype == w.dtype, (sql, j, g.dtype, w.dtype)
        if not np.array_equal(g.view(np.uint8), w.view(np.uint8)):
            bad = np.nonzero(g != w)[0]
            raise AssertionError(f"{sql}: column {j} differs first at row "
                                 f"{bad[:1]}: {g[bad[:5]]} vs {w[bad[:5]]}")
    return got


DIRS = ["ASC", "DESC", "ASC NULLS FIRST", "DESC NULLS LAST"]


def _dirs(k):
    """Every direction and NULL placement for the keys that hold NULLs and
    ties; ASC and DESC for the rest."""
    return DIRS if k in ("i", "fn", "d", "s") else DIRS[:2]


# the full sort of every key type
FULL = [f"SELECT r, {k} FROM st ORDER BY {k} {d}"
        for k in ["i", "b", "fz", "fn", "d", "dz", "dt", "s"] for d in _dirs(k)]
# top-k over 20000 rows (> 16384), OFFSET inside the window; DOUBLE keys
# with zeros or subnormals are left to the test that pins the port's rule
TOPK_BIG = [f"SELECT r, {k} FROM st ORDER BY {k} {d} LIMIT 50 OFFSET 7"
            for k in ["i", "b", "fz", "fn", "d", "dt"] for d in _dirs(k)]
# top-k over 6000 rows (<= 16384)
TOPK_SMALL = [f"SELECT r, {k} FROM st WHERE r < 6000 ORDER BY {k} {d} LIMIT 40"
              for k, d in [("i", "ASC"), ("b", "DESC"), ("fz", "ASC"), ("fz", "DESC"),
                           ("fn", "DESC NULLS LAST"), ("d", "ASC NULLS FIRST"),
                           ("dz", "DESC"), ("dz", "ASC"), ("dt", "DESC")]]
OTHER = [
    # bare LIMIT / OFFSET: a slice in input order, across fragments
    "SELECT r, i FROM st LIMIT 10",
    f"SELECT r, s FROM st LIMIT 5 OFFSET {FRAG - 2}",
    "SELECT r, i FROM st WHERE i > 0 LIMIT 7 OFFSET 3",
    "SELECT r FROM st LIMIT 0",
    # multi-key full sorts (no LIMIT)
    "SELECT r, i, fz, s FROM st ORDER BY i, fz DESC, s",
    "SELECT r, dt, b FROM st ORDER BY dt DESC NULLS LAST, b NULLS FIRST",
    "SELECT r, s, d FROM st ORDER BY s DESC, d",
    # composite top-k: INT range from chunk stats, FLOAT full width, DATE
    "SELECT r, i, fn FROM st ORDER BY i ASC, fn DESC LIMIT 40",
    "SELECT r, dt, i, fz FROM st ORDER BY dt DESC, i, fz LIMIT 25 OFFSET 5",
    "SELECT r, b, i FROM st ORDER BY b ASC, i DESC LIMIT 30",
    "SELECT r, i, fn FROM st WHERE r < 6000 ORDER BY fn NULLS FIRST, i LIMIT 33",
    # a composite that does not pack: a full sort under the LIMIT
    "SELECT r, bw, i FROM st ORDER BY bw, i LIMIT 30",
    # LIMIT past the top-k bound, OFFSET past the rows, OFFSET alone
    "SELECT r, i FROM st ORDER BY i DESC LIMIT 17000",
    "SELECT r, i FROM st ORDER BY i LIMIT 10 OFFSET 20000",
    "SELECT r, fz FROM st ORDER BY fz OFFSET 19990",
    # ORDER BY over projected expressions and a key not selected
    "SELECT r + 1, i * 2 FROM st WHERE fn > 0.5 ORDER BY i * 2 DESC, r LIMIT 20",
    "SELECT r FROM st ORDER BY fn DESC NULLS LAST LIMIT 12",
    # GROUP BY ... ORDER BY: full sort and top-N over the groups
    "SELECT i, COUNT(*), SUM(b) FROM st GROUP BY i ORDER BY 2 DESC, 1 LIMIT 10",
    "SELECT s, COUNT(*), MIN(r) FROM st GROUP BY s ORDER BY s NULLS FIRST",
    "SELECT dt, COUNT(*) c FROM st GROUP BY dt ORDER BY c DESC, dt LIMIT 15",
    "SELECT i, COUNT(*) FROM st WHERE i > 400 GROUP BY i ORDER BY COUNT(*) DESC",
]


@pytest.mark.parametrize("sql", FULL + TOPK_BIG + TOPK_SMALL + OTHER)
def test_rows_and_order_match_reference(engines, sql):
    _same(engines, sql)


def test_top_k_equals_the_full_sort(engines):
    """The packed three-key top-k gives the first rows of the full sort
    that LIMIT 17000 (past the top-k bound) takes."""
    port = engines[1]
    q = "SELECT r, i, fz, b FROM st ORDER BY i ASC, fz DESC, b ASC"
    fast, full = port.sql(f"{q} LIMIT 40"), port.sql(f"{q} LIMIT 17000")
    for j in range(4):  # bit for bit: fz holds NaN
        assert fast.column_raw(j).tobytes() == full.column_raw(j)[:40].tobytes()


# tests/test_engine_basic.py's table and its ORDER BY queries (those with
# no UNION, join or subquery)
BASIC = [
    "SELECT x FROM t ORDER BY x",
    "SELECT x FROM t ORDER BY x DESC",
    "SELECT x FROM t ORDER BY x ASC NULLS FIRST",
    "SELECT x FROM t ORDER BY x NULLS LAST LIMIT 2 OFFSET 1",
    "SELECT COALESCE(y, -1.0) FROM t ORDER BY x NULLS LAST",
    "SELECT s, count(*), sum(x) FROM t GROUP BY s ORDER BY s",
    "SELECT x % 2 AS par, count(*) FROM t WHERE x IS NOT NULL GROUP BY 1 ORDER BY 1",
    "SELECT DISTINCT s FROM t ORDER BY s",
    "SELECT d, b, x FROM t ORDER BY d DESC, b",
    "SELECT a, b, sum(v) FROM m GROUP BY a, b ORDER BY a, b NULLS LAST",
]


@pytest.fixture(scope="module")
def basic():
    dbs = hdt.connect(), hdt_torch.connect(device="cpu")
    for db in dbs:
        db.sql("CREATE TABLE t (x INT, y DOUBLE, s TEXT, d DATE, b BOOLEAN)")
        db.sql("INSERT INTO t VALUES "
               "(1, 2.5, 'foo', '2020-01-01', 'true'), "
               "(2, NULL, 'bar', '2020-06-15', 'false'), "
               "(3, 7.5, 'foo', NULL, NULL), "
               "(NULL, 1.0, NULL, '2021-03-03', 'true')")
        db.sql("CREATE TABLE m (a INT, b INT, v DOUBLE)")
        db.sql("INSERT INTO m VALUES (1,1,1.0),(1,1,2.0),(1,2,3.0),(2,1,4.0),(2,NULL,5.0)")
    return dbs


@pytest.mark.parametrize("sql", BASIC)
def test_engine_basic_order_by_matches_reference(basic, sql):
    ref, port = basic
    assert port.sql(sql).rows() == ref.sql(sql).rows()


def _composite_plan(db, sql):
    plan = optimize(db._plan_select(parse_many(sql)[0]))
    return db.executor._composite_sort_plan(plan, plan.inputs[0])


def test_composite_plans_pack_as_the_reference():
    """x1k-like INT keys narrow by chunk stats, FLOAT takes 32 bits; a
    BIGINT past 2^62 beside another key does not pack."""
    port = hdt_torch.connect(device="cpu")
    port.sql("CREATE TABLE c (k INT, v FLOAT, w BIGINT)")
    port.load_table("c", {"k": np.array([1, 1000, 500], np.int32),
                          "v": np.array([0.5, 1.5, 2.5], np.float32),
                          "w": np.array([-2**62, 2**62, 0], np.int64)})
    specs, total = _composite_plan(port, "SELECT k, v FROM c ORDER BY k DESC, v LIMIT 5")
    assert [s[:2] for s in specs] == [(10, 1), (32, None)]
    assert total == sum(s[0] + s[4] for s in specs)
    assert _composite_plan(port, "SELECT w, k FROM c ORDER BY w, k LIMIT 5") is None


# ---------------------------------------------------------------------------
# the streamed top-k (tests/test_stream_topk.py's and
# tests/test_multikey_topk.py's shapes)
# ---------------------------------------------------------------------------

STREAMED = [
    "SELECT r, fn FROM st ORDER BY fn DESC LIMIT 25",
    "SELECT r, i FROM st ORDER BY i LIMIT 10 OFFSET 5",
    "SELECT r + 1, fn * 2 FROM st WHERE i > 0 ORDER BY fn DESC LIMIT 7",
    "SELECT r, i, fz FROM st ORDER BY i ASC, fz DESC LIMIT 20",
    "SELECT r, fn FROM st ORDER BY fn DESC NULLS FIRST LIMIT 3",
    "SELECT r, dt FROM st WHERE dt > 18150 ORDER BY dt, r DESC LIMIT 9",
]


@pytest.fixture()
def streamed(engines):
    ref, port = engines
    for db in engines:
        db.config.stream_threshold_bytes = 1 << 14
    try:
        yield engines
    finally:
        for db in engines:
            db.config.stream_threshold_bytes = 0


@pytest.mark.parametrize("sql", STREAMED)
def test_streamed_topk_matches_reference(streamed, sql):
    port = streamed[1]
    waves0 = port.executor.waves_run
    _same(streamed, sql)
    # one fragment a wave: 4096 rows x >= 8 bytes pass the 8 KB wave budget
    assert port.executor.waves_run - waves0 == -(-N // FRAG)


def test_streamed_topk_matches_one_shot(streamed):
    port = streamed[1]
    sql = "SELECT r, i, fn FROM st ORDER BY fn LIMIT 50"
    waved = port.sql(sql).rows()
    port.config.stream_threshold_bytes = -1
    waves0 = port.executor.waves_run
    one_shot = port.sql(sql).rows()
    assert port.executor.waves_run == waves0
    assert waved == one_shot


def test_streamed_topk_with_no_surviving_rows(streamed):
    """Every wave scans rows and none passes the filter."""
    port = streamed[1]
    sql = "SELECT r, i FROM st WHERE fn > 2.0 ORDER BY i LIMIT 5"
    waves0 = port.executor.waves_run
    _same(streamed, sql)
    assert port.executor.waves_run - waves0 == -(-N // FRAG)
    assert port.sql(sql).rows() == []


# ---------------------------------------------------------------------------
# DOUBLE keys above 16384 rows: exact bits (the port's rule)
# ---------------------------------------------------------------------------


def _total_order_f64(a):
    """numpy int64 codes whose order is float64 total order (-0.0 < +0.0,
    subnormals kept)."""
    b = a.view(np.int64)
    return b ^ ((b >> 63) & np.int64(0x7FFFFFFFFFFFFFFF))


@pytest.mark.parametrize("direction", ["DESC", "ASC"])
def test_double_topk_keeps_exact_order(engines, direction):
    _, port = engines
    t = port.catalog.get_table("st")
    dz = np.asarray(t.column_values(t.column_by_name("dz").col_id))
    got = port.sql(f"SELECT r, dz FROM st ORDER BY dz {direction} LIMIT 16000").column_raw(0)
    code = _total_order_f64(dz)
    # ORDER BY ... ASC takes the largest of -dz, in total order
    if direction == "ASC":
        code = _total_order_f64(-dz)
    want = np.lexsort((np.arange(N), -code))[:16000]
    assert np.array_equal(got, want)
    # the window holds -0.0 beside +0.0 and the subnormals apart from zero
    held = dz[want]
    assert {np.signbit(x) for x in held[held == 0]} == {True, False}
    assert (np.abs(held[(held != 0)]) < 1e-300).any()


# ---------------------------------------------------------------------------
# ops level, against the JAX functions
# ---------------------------------------------------------------------------


def _ops_keys(rng, n):
    """Seeded key columns with NULLs, NaN, +-0.0 and many ties."""
    i32 = np.where(rng.random(n) < 0.1, np.iinfo(np.int32).min,
                   rng.integers(-20, 20, n)).astype(np.int32)
    f32 = np.array([-1.0, -0.0, 0.0, 0.25, np.nan, 3.0], np.float32)[
        rng.integers(0, 6, n)]
    f64 = np.round(rng.standard_normal(n), 1)
    i64 = rng.integers(-2**50, 2**50, n) >> 45 << 45
    return [i32, f32, f64, i64]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_permutation_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    cols = _ops_keys(rng, n)
    order = rng.permutation(len(cols))[:3]
    specs = [(bool(rng.integers(2)), bool(rng.integers(2))) for _ in order]
    nullable = [j in (0, 1) for j in order]
    mask = np.arange(n) < n - 37
    pay = rng.integers(0, 1 << 30, n).astype(np.int32)

    def tvs(conv, isnan):
        out = []
        for j, null in zip(order, nullable):
            v = conv(cols[j])
            valid = None
            if null:
                valid = conv(~isnan(cols[j]) if cols[j].dtype.kind == "f"
                             else cols[j] != np.iinfo(np.int32).min)
            out.append((v, valid))
        return out

    jp, jv, (jpay,) = JS.sort_permutation(tvs(jnp.asarray, np.isnan), specs,
                                          jnp.asarray(mask), payloads=[jnp.asarray(pay)])
    tp, tv, (tpay,) = S.sort_permutation(tvs(torch.from_numpy, np.isnan), specs,
                                         torch.from_numpy(mask),
                                         payloads=[torch.from_numpy(pay)])
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tpay.numpy(), np.asarray(jpay))


@pytest.mark.parametrize("n", [1000, 20_000])
@pytest.mark.parametrize("dtype", ["int32", "float32", "float64", "int64"])
def test_topk_indices_matches_reference(n, dtype):
    rng = np.random.default_rng(n)
    if dtype == "int32":
        key = rng.integers(-30, 30, n).astype(np.int32)
    elif dtype == "float32":  # ties, -0.0 beside +0.0, infinities
        key = np.array([-1.0, -0.0, 0.0, 0.5, np.inf, -np.inf], np.float32)[
            rng.integers(0, 6, n)]
    elif dtype == "float64":  # no zero or subnormal above 16384 rows
        key = np.round(rng.standard_normal(n), 1) + 0.05
    else:
        key = (rng.integers(-2**60, 2**60, n) >> 50 << 50).astype(np.int64)
    # the k-th value falls among ties at both sizes
    for k in ((1, 700) if n <= 16384 else (300,)):
        want = np.asarray(JS.topk_indices(jnp.asarray(key), k))
        got = S.topk_indices(torch.from_numpy(key), k).numpy()
        assert np.array_equal(got, want), (dtype, n, k)


@pytest.mark.parametrize("n", [1000, 20_000])
def test_composite_key_and_topk_match_reference(n):
    rng = np.random.default_rng(n + 5)
    k1 = np.where(rng.random(n) < 0.1, np.iinfo(np.int32).min,
                  rng.integers(3, 40, n)).astype(np.int32)
    v = np.where(rng.random(n) < 0.1, np.nan,
                 np.round(rng.random(n), 1)).astype(np.float32)
    dom = np.arange(n) < n - 11
    # values past the narrowed range clip to its top, as in the reference
    third = rng.integers(-9, 2**30 - 5, n).astype(np.int64)
    for cols, specs in [
        ([k1, v], ((6, 3, True, False, True), (32, None, False, True, True))),
        ([k1, v], ((6, 3, False, True, True), (32, None, True, False, False))),
        # 63 bits and the domain bit: a full 64-bit key
        ([k1, third], ((32, None, True, True, True), (30, -7, False, False, False))),
    ]:
        total = sum(s[0] + s[4] for s in specs)

        def tvs(conv):
            out = []
            for c, s in zip(cols, specs):
                valid = None
                if s[4]:
                    valid = (~np.isnan(c) if c.dtype.kind == "f"
                             else c != np.iinfo(np.int32).min)
                out.append((conv(c), None if valid is None else conv(valid)))
            return out

        ju, jbits = JS.composite_topk_key(tvs(jnp.asarray), specs, total,
                                          in_domain=jnp.asarray(dom))
        tu, tbits = S.composite_topk_key(tvs(torch.from_numpy), specs, total,
                                         in_domain=torch.from_numpy(dom))
        assert tbits == jbits
        want = np.asarray(ju).astype(np.uint64)
        if jbits == 64:
            want = want ^ np.uint64(1 << 63)
        assert np.array_equal(tu.numpy(), want.view(np.int64))
        for k in ((5, 300) if n <= 16384 else (300,)):
            assert np.array_equal(S.topk_indices_u(tu, tbits, k).numpy(),
                                  np.asarray(JS.topk_indices_u(ju, jbits, k)))
