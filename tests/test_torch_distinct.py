"""COUNT / SUM / AVG (DISTINCT), APPROX_COUNT_DISTINCT, APPROX_QUANTILE and
MODE: heavydb_tpu_torch against the JAX package.

Function level: each new function of heavydb_tpu_torch.ops.groupby against
heavydb_tpu.ops.groupby on the same numpy-seeded inputs: the sorted and the
hash COUNT(DISTINCT) forms (the hash form over 2^21 + 64 rows), SUM
(DISTINCT), the exact and the histogram quantile (over 2^21 + 64 rows),
MODE, the HyperLogLog registers and estimates, splitmix64 and the f64 bit
codec; `hash_group_ids`' contract (rows share an id if and only if their
keys are equal, `total` and `unresolved` exact); the HLL registers of
values whose hashes sit at the float64 rule's edges (a rest just below and
at 2^k, the top bits all ones).

Engine level: the same seeded tables in heavydb_tpu.connect() and, copied
through load_state, heavydb_tpu_torch.connect(device="cpu"), every
aggregate over INT, BIGINT, FLOAT and DOUBLE with NULLs, NaN, -0.0 and
subnormals, keyless, grouped and on the sort tier; the DISTINCT queries of
the reference's test_engine_basic, test_sqlite_oracle,
test_oracle_datetime_decimal, test_sparse_tier and test_buffer_mgr; the
hash form (enable_hash_groupby=True, over 2^21 rows) beside the sorted
form, which fold NaN and -0.0 differently; and the overflow retry from the
hash form to the sorted one.

Tolerances: counts, integer sums, modes, registers and estimates exact;
DOUBLE sums and AVG rtol 1e-9; FLOAT sums rtol 1e-4 / atol 1e-3; the
histogram quantile rtol 1e-12 (the interpolation rounds in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu.ops import f64bits as JF
from heavydb_tpu.ops import groupby as JG
from heavydb_tpu_torch.exec import executor as X
from heavydb_tpu_torch.ops import groupby as G
from tests.test_torch_engine import _copy_state
from tests.test_torch_join import _check, _pair

I32_NULL = np.iinfo(np.int32).min
I64_NULL = np.iinfo(np.int64).min
M64 = (1 << 64) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f"), (got[:8], want[:8])


# ---------------------------------------------------------------------------
# function level
# ---------------------------------------------------------------------------

S = 37


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(9)
    n = 6000
    f = (rng.integers(-40, 40, n) / 4).astype(np.float32)
    f[rng.random(n) < 0.03] = np.nan
    f[rng.random(n) < 0.03] = -0.0
    d = rng.integers(-60, 60, n) / 8.0
    d[rng.random(n) < 0.03] = np.nan
    d[rng.random(n) < 0.03] = -0.0
    d[rng.random(n) < 0.02] = 5e-324
    d[rng.random(n) < 0.02] = -5e-324
    return dict(gid=rng.integers(0, S, n).astype(np.int32), mask=rng.random(n) > 0.1,
                valid=rng.random(n) > 0.05,
                vals={"i32": rng.integers(-50, 50, n).astype(np.int32),
                      "i64": rng.integers(-50, 50, n).astype(np.int64) * (1 << 35),
                      "f32": f, "f64": d})


KINDS = ["i32", "i64", "f32", "f64"]


@pytest.mark.parametrize("kind", KINDS)
def test_distinct_count_sorted(rows, kind):
    r, v = rows, rows["vals"][kind]
    want, wo = JG.distinct_count_per_group(jnp.asarray(r["gid"]), (v, r["valid"]),
                                           jnp.asarray(r["mask"]), S)
    got, go = G.distinct_count_per_group(_t(r["gid"]), (_t(v), _t(r["valid"])),
                                         _t(r["mask"]), S)
    _eq(got, want)
    assert int(go) == int(wo) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_distinct_sum(rows, kind):
    r, v = rows, rows["vals"][kind]
    acc = np.dtype(np.float64) if v.dtype.kind == "f" else np.dtype(np.int64)
    ws, wc = JG.distinct_sum_per_group(jnp.asarray(r["gid"]), (v, None),
                                       jnp.asarray(r["mask"] & r["valid"]), S, acc)
    gs, gc = G.distinct_sum_per_group(_t(r["gid"]), (_t(v), None),
                                      _t(r["mask"] & r["valid"]), S, acc)
    _eq(gc, wc)
    if acc.kind == "f":
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-9)
    else:
        _eq(gs, ws)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 1.0])
def test_quantile_exact(rows, kind, q):
    r, v = rows, rows["vals"][kind]
    valid = r["valid"] & ~np.isnan(v) if v.dtype.kind == "f" else r["valid"]
    want, wh = JG.quantile_per_group(jnp.asarray(r["gid"]), (v, valid),
                                     jnp.asarray(r["mask"]), S, q)
    got, gh = G.quantile_per_group(_t(r["gid"]), (_t(v), _t(valid)), _t(r["mask"]), S, q)
    _eq(gh, wh)
    _eq(got[gh], np.asarray(want)[np.asarray(wh)])


@pytest.mark.parametrize("kind", KINDS)
def test_mode(rows, kind):
    r, v = rows, rows["vals"][kind]
    want, wh = JG.mode_per_group(jnp.asarray(r["gid"]), (v, r["valid"]),
                                 jnp.asarray(r["mask"]), S)
    got, gh = G.mode_per_group(_t(r["gid"]), (_t(v), _t(r["valid"])), _t(r["mask"]), S)
    _eq(gh, wh)
    _eq(got, want)


def test_mode_ties_go_to_the_smallest_value():
    gid = np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 1], np.int32)
    v = np.array([9, 4, 9, 4, 7, 3, 3, 7, 5, 5], np.int32)
    got, has = G.mode_per_group(_t(gid), (_t(v), None), None, 3)
    assert got[:2].tolist() == [4, 3] and has.tolist() == [True, True, False]
    want, _ = JG.mode_per_group(jnp.asarray(gid), (v, None), None, 3)
    assert np.asarray(want)[:2].tolist() == [4, 3]


@pytest.mark.parametrize("kind", KINDS)
def test_hll_registers_and_estimate(rows, kind):
    r, v = rows, rows["vals"][kind]
    want = jax.jit(lambda g, x, va, m: JG.hll_registers(g, (x, va), m, S))(
        r["gid"], v, r["valid"], r["mask"])
    got = G.hll_registers(_t(r["gid"]), (_t(v), _t(r["valid"])), _t(r["mask"]), S)
    _eq(got, want)
    _eq(G.hll_estimate(got), JG.hll_estimate(want))


def test_splitmix64_and_f64_bits(rows):
    x = np.concatenate([rows["vals"]["i64"], np.array([0, -1, I64_NULL, 2**63 - 1])])
    _eq(G._splitmix64(_t(x)), JF.u64_to_i64(JG._splitmix64(JF.i64_to_u64(x))))
    d = np.array([0.0, -0.0, 5e-324, -5e-324, 1e-310, -1e-310, 2.2250738585072014e-308,
                  np.nan, -np.nan, np.inf, -np.inf, 1.5, -2.5, 1e300], np.float64)
    want = jax.jit(JF.f64_to_bits)(d)
    _eq(G.f64_to_bits(_t(d)), want)
    # -0.0 and +0.0 hash as one value, as do every NaN and the subnormals
    assert len(set(G.f64_to_bits(_t(d[:6])).tolist())) == 1


def test_bucket_pow2():
    for x in (1, 2, 3, 4096, 4097, 1 << 25, (1 << 25) + 1):
        assert G.bucket_pow2(x) == JG.bucket_pow2(x)


def _inv_xorshift(y, s):
    x = y
    for _ in range(64 // s + 1):
        x = y ^ (x >> s)
    return x & M64


def _unsplitmix(h):
    """The int64 value whose splitmix64 hash is the uint64 h."""
    z = _inv_xorshift(h, 31)
    z = (z * pow(0x94D049BB133111EB, -1, 1 << 64)) & M64
    z = _inv_xorshift(z, 27)
    z = (z * pow(0xBF58476D1CE4E5B9, -1, 1 << 64)) & M64
    z = _inv_xorshift(z, 30)
    x = (z - 0x9E3779B97F4A7C15) & M64
    return x - (1 << 64) if x >> 63 else x


def test_hll_registers_at_the_float64_edges():
    """Values whose hashes leave a rest (the low 53 bits, shifted up, with
    the low 11 bits set) just below 2^k, at 2^k + 2047, or all ones (it
    rounds up to 2^64: rho 0): the registers equal the reference's, each
    value in its own group."""
    lows = [0, 1, (1 << 53) - 1, (1 << 53) - 2]
    for k in range(12, 64):
        lows += [(1 << (k - 11)) - 1, 1 << (k - 11), (1 << (k - 11)) - 2]
    hashes = [((i * 37) % 2048) << 53 | low for i, low in enumerate(lows)]
    hashes.append(M64)  # the top bits all ones
    vals = np.array([_unsplitmix(h) for h in hashes], np.int64)
    assert [v & M64 for v in
            np.asarray(JF.u64_to_i64(JG._splitmix64(JF.i64_to_u64(vals)))).tolist()] == hashes
    gid = np.arange(len(vals), dtype=np.int32)
    want = jax.jit(lambda g, x: JG.hll_registers(g, (x, None), None, len(vals)))(gid, vals)
    got = G.hll_registers(_t(gid), (_t(vals), None), None, len(vals))
    _eq(got, want)
    # all ones: the rest rounds to 2^64 and every register stays 0
    assert int(got[-1].max()) == 0 and int(got[2].max()) == 0


def test_hash_group_ids_contract():
    rng = np.random.default_rng(4)
    pool = np.concatenate([rng.integers(-2**62, 2**62, 700), [0, -1, 2**62]])
    keys = rng.choice(pool, 20000).astype(np.int64)
    mask = rng.random(20000) > 0.1
    gid, total, unresolved, slot_keys = G.hash_group_ids(_t(keys), _t(mask), 4096, rounds=4)
    assert total == 4 * 4096 and slot_keys.shape == (total,)
    gid = gid.numpy()
    ok = mask & (gid < total)
    assert int(unresolved) == int((mask & (gid == total)).sum()) == 0
    assert (gid[~mask] == total).all()
    # one id a key and one key an id
    pairs = set(zip(keys[ok].tolist(), gid[ok].tolist()))
    assert len(pairs) == len({k for k, _ in pairs}) == len({g for _, g in pairs})
    assert np.array_equal(slot_keys.numpy()[gid[ok]], keys[ok])
    # a table too small for the keys in two rounds leaves some unresolved
    gid2, total2, unresolved2, _ = G.hash_group_ids(_t(keys), _t(mask), 64, rounds=2)
    miss = mask & (gid2.numpy() == total2)
    assert total2 == 128 and int(unresolved2) == int(miss.sum()) > 0


@pytest.fixture(scope="module")
def big_rows():
    """2^21 + 64 rows: past the hash form's and the histogram's thresholds."""
    rng = np.random.default_rng(12)
    n = (1 << 21) + 64
    f = (rng.integers(-3000, 3000, n) / 4).astype(np.float32)
    f[rng.random(n) < 0.01] = np.nan
    f[rng.random(n) < 0.01] = -0.0
    f[rng.random(n) < 0.01] = np.inf
    return dict(gid=rng.integers(0, S, n).astype(np.int32), mask=rng.random(n) > 0.1,
                valid=rng.random(n) > 0.02, f=f,
                x=(rng.standard_normal(n) * 100).astype(np.float32))


@pytest.mark.parametrize("allow_hash", [True, False])
def test_distinct_count_hash_and_sorted_forms(big_rows, allow_hash):
    r = big_rows
    want, wo = jax.jit(lambda g, v, va, m: JG.distinct_count_per_group(
        g, (v, va), m, S, allow_hash=allow_hash))(r["gid"], r["f"], r["valid"], r["mask"])
    got, go = G.distinct_count_per_group(_t(r["gid"]), (_t(r["f"]), _t(r["valid"])),
                                         _t(r["mask"]), S, allow_hash=allow_hash)
    _eq(got, want)
    assert int(go) == int(wo) == 0


@pytest.mark.parametrize("q", [0.1, 0.97])
def test_quantile_histogram(big_rows, q):
    r = big_rows
    want, wh = jax.jit(lambda g, v, va, m: JG.quantile_per_group(g, (v, va), m, S, q))(
        r["gid"], r["x"], r["valid"], r["mask"])
    got, gh = G.quantile_per_group(_t(r["gid"]), (_t(r["x"]), _t(r["valid"])),
                                   _t(r["mask"]), S, q)
    _eq(gh, wh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dtab():
    """t: 20,000 rows; a INT, b BIGINT, f FLOAT, d DOUBLE, each with NULLs;
    f and d also hold -0.0, d subnormals; fn FLOAT NOT NULL and dn DOUBLE
    NOT NULL hold NaN, -0.0, +0.0 and +inf; k INT in 0..39 (perfect tier),
    sp BIGINT over 3000 sparse keys (sort tier)."""
    rng = np.random.default_rng(21)
    n = 20_000
    ref = hdt.connect()
    ref.sql("CREATE TABLE t (a INT, b BIGINT, f FLOAT, d DOUBLE, fn FLOAT NOT NULL, "
            "dn DOUBLE NOT NULL, k INT, sp BIGINT)")
    f = (rng.integers(0, 30, n) / 4).astype(np.float32)
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = np.nan
    d = rng.integers(-20, 20, n) / 8.0
    d[rng.random(n) < 0.05] = -0.0
    d[rng.random(n) < 0.02] = 5e-324
    d[rng.random(n) < 0.02] = -5e-324
    d[rng.random(n) < 0.05] = np.nan
    special = np.array([np.nan, -0.0, 0.0, np.inf, 1.5, -2.25])
    t = ref.catalog.get_table("t")
    cols = {
        "a": np.where(rng.random(n) < 0.05, I32_NULL, rng.integers(0, 500, n)).astype(np.int32),
        "b": np.where(rng.random(n) < 0.05, I64_NULL,
                      rng.integers(0, 300, n) * (1 << 33)).astype(np.int64),
        "f": f, "d": d,
        "fn": rng.choice(special, n).astype(np.float32),
        "dn": rng.choice(special, n),
        "k": rng.integers(0, 40, n).astype(np.int32),
        "sp": (rng.integers(0, 3000, n) * 1000003).astype(np.int64)}
    t.insert_columns({cd.col_id: cols[cd.name] for cd in t.columns})
    return _pair(ref, ["t"])


ENGINE = []
for _c in ("a", "b", "f", "d", "fn", "dn"):
    _aggs = (f"COUNT(DISTINCT {_c}), APPROX_COUNT_DISTINCT({_c}), MODE({_c}), "
             f"SUM(DISTINCT {_c}), AVG(DISTINCT {_c})")
    _f32 = (3, 4) if _c in ("f", "fn") else ()
    ENGINE += [
        (f"SELECT {_aggs}, APPROX_QUANTILE({_c}, 0.25) FROM t WHERE k < 30", _f32),
        (f"SELECT k, {_aggs}, APPROX_MEDIAN({_c}) FROM t GROUP BY k",
         tuple(i + 1 for i in _f32)),
    ]
    if _c in ("a", "f", "d", "fn"):
        ENGINE.append((f"SELECT sp, {_aggs}, APPROX_QUANTILE({_c}, 0.9) FROM t GROUP BY sp",
                       tuple(i + 1 for i in _f32)))
ENGINE += [
    # beside plain aggregates, under a filter and HAVING, over an expression
    ("SELECT k, COUNT(*), SUM(a), COUNT(DISTINCT a % 7), MAX(d) FROM t WHERE a > 100 "
     "GROUP BY k HAVING COUNT(DISTINCT a) > 10", ()),
    ("SELECT COUNT(DISTINCT k), COUNT(DISTINCT sp), SUM(DISTINCT k) FROM t", ()),
    ("SELECT k, MODE(a), COUNT(DISTINCT b) FROM t GROUP BY k ORDER BY k LIMIT 7", ()),
]


@pytest.mark.parametrize("sql,f32_cols", ENGINE, ids=range(len(ENGINE)))
def test_engine_aggregates(dtab, sql, f32_cols):
    _check(dtab, sql, f32_cols)


@pytest.fixture(scope="module")
def suites():
    """The DISTINCT cases of the reference's engine suites: test_engine_basic
    (tdb's t, sd, mq, am, big, acd), test_sqlite_oracle (t1),
    test_oracle_datetime_decimal (td), test_sparse_tier (s) and
    test_buffer_mgr (bt)."""
    rng = np.random.default_rng(5)
    ref = hdt.connect()
    ref.sql("CREATE TABLE t (x INT, y DOUBLE, s TEXT, d DATE, b BOOLEAN)")
    ref.sql("INSERT INTO t VALUES (1, 2.5, 'foo', '2020-01-01', 'true'), "
            "(2, NULL, 'bar', '2020-06-15', 'false'), (3, 7.5, 'foo', NULL, NULL), "
            "(NULL, 1.0, NULL, '2021-03-03', 'true')")
    ref.sql("CREATE TABLE sd (k INT, x INT, y DOUBLE)")
    ref.sql("INSERT INTO sd VALUES (1,5,1.5), (1,5,1.5), (1,7,2.5), (2,5,NULL), "
            "(2,NULL,3.0), (NULL,4,3.0), (2,5,3.0)")
    ref.sql("CREATE TABLE mq (g INT, v INT)")
    ref.sql("INSERT INTO mq VALUES (1,5),(1,5),(1,7),(2,3),(2,9),(2,9),(2,9),(1,NULL)")
    ref.sql("CREATE TABLE am (x DOUBLE, g INT)")
    ref.sql("INSERT INTO am VALUES (1.0,1),(2.0,1),(3.0,1),(10.0,2),(20.0,2)")
    ref.load_table("big", {"k": rng.integers(0, 10, 1000), "v": rng.normal(size=1000)},
                   create=True)
    ref.load_table("acd", {"v": rng.integers(0, 5000, 50_000)}, create=True)
    n = 600
    x = rng.integers(-50, 50, n).astype(np.int32)
    x[rng.random(n) < 0.1] = I32_NULL
    ref.sql("CREATE TABLE t1 (k INT, x INT, s TEXT)")
    ref.load_table("t1", {"k": rng.integers(0, 6, n).astype(np.int32), "x": x,
                          "s": [["red", "green", "blue", None][i]
                                for i in rng.integers(0, 4, n)]})
    days = rng.integers(17_897, 18_997, 800).astype(np.int32)
    days[::17] = I32_NULL
    ref.sql("CREATE TABLE td (d DATE, k INT)")
    ref.load_table("td", {"d": days, "k": rng.integers(0, 12, 800).astype(np.int32)})
    ref.load_table("s", {"k": rng.integers(0, 4000, 8000).astype(np.int64),
                         "v": rng.integers(-1000, 1000, 8000).astype(np.int64)}, create=True)
    ref.load_table("bt", {"k": rng.integers(0, 50, 3000).astype(np.int32),
                          "v": rng.integers(0, 200, 3000).astype(np.int32)}, create=True)
    return _pair(ref, ["t", "sd", "mq", "am", "big", "acd", "t1", "td", "s", "bt"])


SUITE_QUERIES = [
    "SELECT count(DISTINCT s) FROM t",
    "SELECT count(DISTINCT k) FROM big",
    "SELECT APPROX_COUNT_DISTINCT(v) FROM acd",
    "SELECT APPROX_MEDIAN(x) FROM am",
    "SELECT g, APPROX_MEDIAN(x) FROM am GROUP BY g ORDER BY g",
    "SELECT g, MODE(v) FROM mq GROUP BY g ORDER BY g",
    "SELECT APPROX_QUANTILE(v, 0.5) FROM mq WHERE g = 2",
    "SELECT sum(DISTINCT x), avg(DISTINCT y) FROM sd",
    "SELECT k, sum(DISTINCT x), avg(DISTINCT x) FROM sd GROUP BY k ORDER BY k NULLS FIRST",
    "SELECT sum(DISTINCT x) FROM sd WHERE x IS NULL",
    "SELECT count(DISTINCT x) FROM t1",
    "SELECT count(DISTINCT s) FROM t1",
    "SELECT count(DISTINCT x), count(DISTINCT s), sum(DISTINCT x) FROM t1 WHERE k > 2",
    "SELECT count(DISTINCT d) FROM td",
    "SELECT k, count(distinct v) FROM s GROUP BY k",
    "SELECT k, count(DISTINCT v) FROM bt GROUP BY k ORDER BY k",
]


@pytest.mark.parametrize("sql", SUITE_QUERIES, ids=range(len(SUITE_QUERIES)))
def test_reference_suites(suites, sql):
    _check(suites, sql)


@pytest.fixture(scope="module")
def big_engines():
    """2^21 + 4096 rows: fn FLOAT NOT NULL over NaN, -0.0, +0.0, +inf and
    quarter steps, a INT with NULLs, k INT in 0..9; a reference with the
    hash group-by enabled (COUNT(DISTINCT)'s hash form), one without, and
    one port whose setting the tests switch."""
    rng = np.random.default_rng(31)
    n = (1 << 21) + 4096
    fn = (rng.integers(-400, 400, n) / 4).astype(np.float32)
    for val in (np.nan, -0.0, 0.0, np.inf):
        fn[rng.random(n) < 0.01] = val
    cols = {"fn": fn, "a": np.where(rng.random(n) < 0.05, I32_NULL,
                                    rng.integers(0, 5000, n)).astype(np.int32),
            "k": rng.integers(0, 10, n).astype(np.int32)}
    refs = []
    for cfg in (JConfig(enable_hash_groupby=True), JConfig()):
        ref = hdt.connect(config=cfg)
        ref.sql("CREATE TABLE bg (fn FLOAT NOT NULL, a INT, k INT)")
        t = ref.catalog.get_table("bg")
        t.insert_columns({cd.col_id: cols[cd.name] for cd in t.columns})
        refs.append(ref)
    return refs[0], refs[1], _copy_state(refs[0], ["bg"])


def test_hash_and_sorted_forms_in_the_engine(big_engines):
    """The hash form keeps -0.0 apart from +0.0 and counts NaN as +inf;
    the sorted form folds both into 0.0: the port gives each form's
    answer under the same setting as the reference (the quantile takes
    the histogram sketch past 2^21 rows)."""
    ref_hash, ref_sort, port = big_engines
    sql = ("SELECT k, COUNT(DISTINCT fn), COUNT(DISTINCT a), APPROX_QUANTILE(a, 0.5) "
           "FROM bg GROUP BY k")
    answers = []
    for ref, on in ((ref_hash, True), (ref_sort, False)):
        port.config.enable_hash_groupby = on
        _check((ref, port), sql)
        answers.append(port.sql(sql).rows())
    port.config.enable_hash_groupby = False
    assert sorted(answers[0]) != sorted(answers[1])


def test_claim_overflow_reruns_on_the_sorted_form(big_engines, monkeypatch):
    """A hash claim table that leaves rows unresolved flags the run; the
    executor runs the Compound again on the sorted form."""
    _, ref_sort, port = big_engines
    calls = []
    real = G.hash_group_ids

    def short(packed, mask, slots, rounds=4):
        gid, total, _, keys = real(packed, mask, slots, rounds)
        calls.append(slots)
        return gid, total, torch.ones((), dtype=torch.int32), keys

    forced = []
    post = X.Executor._postprocess

    def spy(self, node, plan, outs):
        res = post(self, node, plan, outs)
        forced.append(plan.distinct_force_sort)
        return res

    monkeypatch.setattr(G, "hash_group_ids", short)
    monkeypatch.setattr(X.Executor, "_postprocess", spy)
    port.config.enable_hash_groupby = True
    try:
        _check((ref_sort, port), "SELECT COUNT(DISTINCT fn) FROM bg")
    finally:
        port.config.enable_hash_groupby = False
    assert len(calls) == 1 and forced == [True, True]
