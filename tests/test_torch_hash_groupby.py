"""The hash group-by tier (ops/groupby.py `pack_group_keys`,
`hash_group_ids`, `unpack_group_keys`; the `hash` branch of
exec/compound_kernel.py; the choice, the claim-table size and the
`hash_unresolved` rung of exec/executor.py) against the JAX package, both
with Config(enable_hash_groupby=True):

- every query of tests/test_hash_groupby.py on the same 40,000-row table,
  with the same tier in both packages;
- grouped aggregates on the hash tier, with filters, HAVING, NULL keys,
  FLOAT / DOUBLE keys holding NaN, -0.0, subnormals and +-inf, and a
  range-packed key pair with NULLs;
- pack_group_keys bit for bit, and unpack_group_keys as its inverse, over
  every key type and edge;
- the hash_unresolved rung (a claim table four times as large), the tier's
  working bytes a row, and a streamed query whose waves each plan their
  own tier.

The port's claims (one int64 scatter-min a round) give other slot ids
than the reference's, so rows without ORDER BY compare as multisets.
Tolerances: keys, counts, integer sums, MIN and MAX exact; DOUBLE sums
and AVG rtol 1e-9; FLOAT sums rtol 1e-4, atol 1e-3.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu.exec.executor import Executor as JExecutor
from heavydb_tpu.ops import groupby as JG
from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.exec.executor import Executor
from heavydb_tpu_torch.ops import groupby as G
from heavydb_tpu_torch.plan import rel_alg as R
from heavydb_tpu_torch.plan.optimizer import optimize
from heavydb_tpu_torch.sql.parser import parse_many

N = 40_000
I32_NULL = np.iinfo(np.int32).min
I64_NULL = np.iinfo(np.int64).min


def _h_columns():
    """tests/test_hash_groupby.py's table at 40,000 rows."""
    rng = np.random.default_rng(0)
    return {
        "sparse": rng.integers(0, 10_000_000_000, N),
        "dupy": rng.integers(1, 1001, N).astype(np.int64) * 10_000_000_000,
        "f": rng.random(N) * 1e6,
        "a": rng.integers(0, 2_000_000, N).astype(np.int32),
        "b": rng.integers(0, 1_000_000, N).astype(np.int32),
    }


def _edge_columns(n=30_000):
    """Hash-tier keys with every edge: a BIGINT with NULLs, a FLOAT and a
    DOUBLE drawn from a large set holding NaN (NULL), -0.0, +0.0,
    subnormals and +-inf, an INT with NULLs, a range-packed pair (p, q)
    with NULLs, and the values."""
    rng = np.random.default_rng(4)
    k = rng.integers(-2**50, 2**50, n)
    k[rng.random(n) < 0.05] = I64_NULL
    edges = np.array([np.nan, -0.0, 0.0, 5e-324, -5e-324, 2.2250738585072014e-308,
                      np.inf, -np.inf])
    d = rng.random(n) * 1e6
    pick = rng.random(n) < 0.2
    d[pick] = rng.choice(edges, int(pick.sum()))
    f = (rng.random(n) * 1e5).astype(np.float32)
    fedges = np.array([np.nan, -0.0, 0.0, 1e-45, -1e-45, 1.17549435e-38, np.inf,
                       -np.inf], np.float32)
    f[pick] = rng.choice(fedges, int(pick.sum()))
    i = rng.integers(-2**31 + 1, 2**31 - 1, n).astype(np.int32)
    i[rng.random(n) < 0.05] = I32_NULL
    p = rng.integers(0, 3_000_000, n).astype(np.int32)
    p[rng.random(n) < 0.05] = I32_NULL
    q = rng.integers(-500_000, 500_000, n).astype(np.int32)
    q[rng.random(n) < 0.05] = I32_NULL
    return {"k": k.astype(np.int64), "d": d, "f": f, "i": i, "p": p, "q": q,
            "v": rng.integers(-1000, 1000, n).astype(np.int64),
            "w": np.where(rng.random(n) < 0.1, np.nan, rng.random(n)).astype(np.float32)}


TABLES = [
    ("h", [("sparse", "BIGINT"), ("dupy", "BIGINT"), ("f", "DOUBLE"), ("a", "INT"),
           ("b", "INT")], _h_columns),
    ("e", [("k", "BIGINT"), ("d", "DOUBLE"), ("f", "FLOAT"), ("i", "INT"), ("p", "INT"),
           ("q", "INT"), ("v", "BIGINT"), ("w", "FLOAT")], _edge_columns),
]


def _load(tables, jcfg, cfg):
    ref = hdt.connect(config=jcfg)
    port = hdt_torch.connect(device="cpu", config=cfg)
    state = []
    for name, coldefs, make in tables:
        cols = make()
        ref.sql(f"CREATE TABLE {name} ("
                + ", ".join(f"{c} {t}" for c, t in coldefs) + ")")
        t = ref.catalog.get_table(name)
        t.insert_columns({cd.col_id: cols[cd.name] for cd in t.columns})
        state.append((name, coldefs, cols))
    hdt_torch.load_state(port, state)
    return ref, port


@pytest.fixture(scope="module")
def dbs():
    return _load(TABLES, JConfig(enable_hash_groupby=True),
                 Config(enable_hash_groupby=True))


def _record_runs(monkeypatch):
    """(strategy, cap) of every aggregate Compound run, for both engines."""
    runs = {"port": [], "ref": []}
    for cls, key in ((Executor, "port"), (JExecutor, "ref")):
        orig = cls._postprocess

        def spy(self, node, plan, outs, _orig=orig, _key=key):
            if plan.group_strategy is not None:
                runs[_key].append((plan.group_strategy[0], plan.group_cap))
            return _orig(self, node, plan, outs)

        monkeypatch.setattr(cls, "_postprocess", spy)
    return runs


def _key(r):
    return tuple((v is None, "" if v is None else
                  ("nan" if isinstance(v, float) and math.isnan(v) else v)) for v in r)


def _same_rows(got, want, f32_cols=(), ordered=False):
    assert len(got) == len(want)
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    for gr, wr in zip(got, want):
        for j, (g, w) in enumerate(zip(gr, wr)):
            if isinstance(w, float) and g is not None:
                if math.isnan(w):
                    assert math.isnan(g), (gr, wr)
                else:
                    tol = dict(rel=1e-4, abs=1e-3) if j in f32_cols else dict(rel=1e-9)
                    assert g == pytest.approx(w, **tol), (gr, wr)
            else:
                assert g == w, (j, gr, wr)


def _tiers(runs):
    return [r[0] for r in runs]


def _same_choice(runs):
    """Both packages chose the same tier with the same claim-table size for
    each Compound run; a rerun of the hash_unresolved rung (the cap x 4) is
    left out, since the two claims resolve keys differently (module
    docstring) and may take another number of them.  Returns the choices."""
    def choices(rs):
        return [r for i, r in enumerate(rs)
                if i == 0 or not (r[0] == "hash" == rs[i - 1][0] and r[1] == 4 * rs[i - 1][1])]

    assert choices(runs["port"]) == choices(runs["ref"])
    return choices(runs["port"])


# ---------------------------------------------------------------------------
# tests/test_hash_groupby.py, query by query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql,tier", [
    ("SELECT sparse, COUNT(*) FROM h GROUP BY sparse", "hash"),
    ("SELECT dupy, COUNT(*) FROM h GROUP BY dupy", "sort"),
], ids=["sparse", "dupy"])
def test_ndv_routing(dbs, monkeypatch, sql, tier):
    ref, port = dbs
    runs = _record_runs(monkeypatch)
    _same_rows(port.sql(sql).rows(), ref.sql(sql).rows())
    assert _tiers(_same_choice(runs)) == [tier]


# (query, FLOAT-sum columns, ORDER BY): the reference suite's queries and
# the aggregates, filters and keys of the hash tier
QUERIES = [
    ("SELECT sparse, COUNT(*) c FROM h GROUP BY sparse ORDER BY sparse LIMIT 10", (), True),
    ("SELECT COUNT(*) FROM (SELECT f FROM h GROUP BY f) q", (), False),
    ("SELECT COUNT(*) FROM (SELECT a, b FROM h GROUP BY a, b) q", (), False),
    ("SELECT a, b, COUNT(*), SUM(f), MIN(sparse), MAX(dupy) FROM h GROUP BY a, b", (), False),
    ("SELECT sparse, SUM(a), AVG(f), MIN(b) FROM h WHERE b > 500000 GROUP BY sparse",
     (), False),
    ("SELECT k, COUNT(*), SUM(v), SUM(w), MIN(v), MAX(w) FROM e GROUP BY k", (3,), False),
    ("SELECT k, COUNT(*) FROM e GROUP BY k HAVING COUNT(*) > 1", (), False),
    ("SELECT d, COUNT(*), SUM(v) FROM e GROUP BY d", (), False),
    ("SELECT f, COUNT(*), AVG(v) FROM e GROUP BY f", (), False),
    ("SELECT i, COUNT(*), SUM(w) FROM e WHERE v > 0 GROUP BY i", (2,), False),
    ("SELECT p, q, COUNT(*), SUM(v), MAX(w) FROM e GROUP BY p, q", (), False),
    ("SELECT d, COUNT(*) c FROM e GROUP BY d ORDER BY c DESC, d LIMIT 5", (), True),
]


@pytest.mark.parametrize("case", range(len(QUERIES)))
def test_hash_tier_matches_reference(dbs, monkeypatch, case):
    sql, f32_cols, ordered = QUERIES[case]
    ref, port = dbs
    runs = _record_runs(monkeypatch)
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same_rows(got, want, f32_cols, ordered)
    assert "hash" in _tiers(_same_choice(runs))


def test_hash_groupby_null_keys():
    """tests/test_hash_groupby.py::test_hash_groupby_null_keys at 40,000
    rows: the NULL group is the largest."""
    rng = np.random.default_rng(1)
    k = rng.integers(0, 10_000_000_000, N)
    k[::4] = I64_NULL
    tables = [("hn", [("k", "BIGINT")], lambda: {"k": k})]
    ref, port = _load(tables, JConfig(enable_hash_groupby=True),
                      Config(enable_hash_groupby=True))
    sql = "SELECT k, COUNT(*) c FROM hn GROUP BY k ORDER BY c DESC LIMIT 1"
    got = port.sql(sql).rows()
    assert got == ref.sql(sql).rows() == [(None, (N + 3) // 4)]


def test_subnormal_double_keys_fall_into_zero():
    """The reference compares with subnormals flushed: a DOUBLE key's
    subnormals and -0.0 join +0.0's group, and NaN is the NULL group."""
    d = np.array([0.0, -0.0, 5e-324, -5e-324, 1e-310, 1.5, np.nan, np.inf, 1.5] * 3)
    tables = [("z", [("d", "DOUBLE")], lambda: {"d": d})]
    ref, port = _load(tables, JConfig(enable_hash_groupby=True),
                      Config(enable_hash_groupby=True))
    sql = "SELECT d, COUNT(*) FROM z GROUP BY d"
    got = port.sql(sql).rows()
    _same_rows(got, ref.sql(sql).rows())
    assert sorted(got, key=_key) == sorted(
        [(0.0, 15), (1.5, 6), (None, 3), (math.inf, 3)], key=_key)


# ---------------------------------------------------------------------------
# pack / unpack against the reference's
# ---------------------------------------------------------------------------

_F64_EDGES = np.array([np.nan, -0.0, 0.0, 5e-324, -5e-324, 2.2250738585072014e-308,
                       np.inf, -np.inf, 1.5, -2.5, 1e300, -1e-300])
_F32_EDGES = np.array([np.nan, -0.0, 0.0, 1e-45, -1e-45, 1.17549435e-38, np.inf,
                       -np.inf, 1.5, -2.5, 3e38, -1e-30], np.float32)
_I32 = np.array([3, -7, I32_NULL, 2**31 - 1, 0, -2**31 + 1, 5, 9, 11, 1, 2, 4], np.int32)
_I64 = np.array([3, -7, I64_NULL, 2**63 - 1, 0, -2**62, 2**40, 9, 11, 1, 2, 4], np.int64)
_I16 = np.array([3, -7, np.iinfo(np.int16).min, 2**15 - 1, 0, 1, 2, 4, 5, 6, 7, 8], np.int16)
_VALID = np.array([True] * 11 + [False])

SINGLE_KEYS = [("double", _F64_EDGES, T.double()), ("float", _F32_EDGES, T.float_()),
               ("int", _I32, T.integer()), ("bigint", _I64, T.bigint()),
               ("smallint", _I16, T.smallint())]


def _canonical(vals, valid, ti):
    """The key each row's group holds: NULL (None) for the sentinel, an
    invalid row or NaN; -0.0 and subnormals as +0.0."""
    out = []
    for v, ok in zip(vals.tolist(), valid):
        if not ok or (isinstance(v, float) and math.isnan(v)) \
                or (not isinstance(v, float) and v == ti.null_sentinel()):
            out.append(None)
        elif isinstance(v, float) and abs(v) < np.finfo(vals.dtype).tiny:
            out.append(0.0)
        else:
            out.append(v)
    return out


@pytest.mark.parametrize("with_valid", [False, True], ids=["sentinel", "valid"])
@pytest.mark.parametrize("name,vals,ti", SINGLE_KEYS, ids=[k[0] for k in SINGLE_KEYS])
def test_pack_single_key_matches_reference(name, vals, ti, with_valid):
    valid = _VALID if with_valid else None
    want = np.asarray(JG.pack_group_keys(
        [(jnp.asarray(vals), None if valid is None else jnp.asarray(valid))], None))
    got = G.pack_group_keys(
        [(torch.from_numpy(vals), None if valid is None else torch.from_numpy(valid))], None)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    (kv, kvalid), = G.unpack_group_keys(got, None, [ti])
    ok = np.ones(len(vals), bool) if kvalid is None else kvalid.numpy()
    keys = [None if not o else v for v, o in zip(kv.numpy().tolist(), ok)]
    assert keys == _canonical(vals, _VALID if with_valid else np.ones(len(vals), bool), ti)
    (jv, jvalid), = JG.unpack_group_keys(jnp.asarray(want), None, [ti])
    np.testing.assert_array_equal(np.asarray(jvalid), ok)
    np.testing.assert_array_equal(np.asarray(jv)[ok], kv.numpy()[ok])


def test_pack_range_pair_matches_reference():
    spec = ((5, 100), (-3, 1000))
    k1 = np.array([5, 104, 50, 0, 200, 7], np.int32)
    k2 = np.array([-3, 996, 0, 7, 1, I64_NULL], np.int64)
    v1 = np.array([True, True, False, True, True, True])
    v2 = k2 != I64_NULL
    want = np.asarray(JG.pack_group_keys(
        [(jnp.asarray(k1), jnp.asarray(v1)), (jnp.asarray(k2), jnp.asarray(v2))], spec))
    got = G.pack_group_keys([(torch.from_numpy(k1), torch.from_numpy(v1)),
                             (torch.from_numpy(k2), torch.from_numpy(v2))], spec)
    np.testing.assert_array_equal(got.numpy(), want)
    out = G.unpack_group_keys(got, spec, [T.integer(), T.bigint()])
    ref = JG.unpack_group_keys(jnp.asarray(want), spec, [T.integer(), T.bigint()])
    for (kv, kvalid), (jv, jvalid) in zip(out, ref):
        np.testing.assert_array_equal(kvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(kv.numpy(), np.asarray(jv))
    # in-range keys come back as they went in (k1[4] = 200 clamps to 104)
    assert out[0][0].numpy()[[0, 1, 3]].tolist() == [5, 104, 5]
    assert out[1][0].numpy()[:5].tolist() == [-3, 996, 0, 7, 1]
    assert out[0][1].numpy().tolist() == v1.tolist()
    assert out[1][1].numpy().tolist() == v2.tolist()


def test_hash_claim_retry_converges():
    """tests/test_hash_groupby.py::test_hash_claim_retry_converges at
    50,000 keys: a table four times too small leaves keys unresolved; a
    large one resolves every key, and each resolved row's slot holds its
    key."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 60, 50_000)
    packed = G.pack_group_keys([(torch.from_numpy(keys), None)], None)
    _, _, unresolved, _ = G.hash_group_ids(packed, None, 8192)
    assert int(unresolved) > 0
    gid, total, unresolved, slot_keys = G.hash_group_ids(packed, None, 1 << 17)
    assert int(unresolved) == 0
    sel = gid < total
    assert bool(sel.all())
    assert torch.equal(slot_keys[gid[sel].long()], packed[sel])


# ---------------------------------------------------------------------------
# the retry rung, the working bytes, streaming
# ---------------------------------------------------------------------------

def test_unresolved_rung_grows_the_table_as_the_reference(monkeypatch):
    """30,000 distinct keys over a 4 x 8192-slot claim table (a quarter of
    the rows a round) leave keys unresolved in both packages: each runs
    again at 4 x the cap, and the rows agree."""
    rng = np.random.default_rng(6)
    cols = {"k": rng.integers(0, 1 << 50, 30_000),
            "v": rng.integers(0, 100, 30_000).astype(np.int32)}
    tables = [("r", [("k", "BIGINT"), ("v", "INT")], lambda: cols)]
    ref, port = _load(tables, JConfig(enable_hash_groupby=True),
                      Config(enable_hash_groupby=True))
    sql = "SELECT k, COUNT(*), SUM(v) FROM r GROUP BY k"
    runs = _record_runs(monkeypatch)
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same_rows(got, want)
    assert runs["port"] == runs["ref"] == [("hash", 8192), ("hash", 32768)]


def test_forced_unresolved_retries_within_the_ladder(monkeypatch):
    """A claim table made to report an unresolved row every time: each
    run grows the cap 4x until the ladder's bound raises."""
    from heavydb_tpu_torch.errors import ExecutionError
    from heavydb_tpu_torch.exec import executor as X

    port = hdt_torch.connect(device="cpu", config=Config(enable_hash_groupby=True))
    port.sql("CREATE TABLE q (b BIGINT)")
    port.sql("INSERT INTO q VALUES (1), (1099511627776), (NULL)")
    real = G.hash_group_ids
    caps = []

    def short(packed, mask, slots, rounds=4):
        caps.append(slots)
        gid, total, _, keys = real(packed, mask, slots, rounds)
        return gid, total, torch.ones((), dtype=torch.int32), keys

    monkeypatch.setattr(G, "hash_group_ids", short)
    with pytest.raises(ExecutionError, match="did not converge"):
        port.sql("SELECT b, COUNT(*) FROM q GROUP BY b").rows()
    assert caps == [4096 * 4 ** i for i in range(X.MAX_RETRIES + 1)]


def _compound(db, sql):
    root = optimize(db._plan_select(parse_many(sql)[0]))
    return next(n for n in R.topo_order(root) if isinstance(n, R.Compound)
                and n.is_aggregate)


def test_tier_row_bytes_of_the_hash_tier(dbs):
    """71 + s (Executor._tier_row_bytes): count(*) adds no stream; SUM of
    a DOUBLE adds its mask and value (1 + 8), MIN of an INT (1 + 4)."""
    _, port = dbs
    node = _compound(port, "SELECT sparse, COUNT(*), SUM(f), MIN(a) FROM h GROUP BY sparse")
    assert port.executor._group_tier(node, N)[0] == "hash"
    assert port.executor._tier_row_bytes(node, N) == 71 + 9 + 5
    # an NDV estimate of 60,000 (the sample is all singletons): 66 rows a key
    assert port.executor._group_tier(node, 100 * N)[0] == "sort"


def test_streamed_waves_plan_their_own_tier(monkeypatch):
    """Fragment waves of a hash-tier query: each wave plans the hash tier
    from its own rows, and the merge over the partial rows (no Scan, so no
    NDV) runs on the sort tier, in both packages, with the same first
    caps."""
    rng = np.random.default_rng(8)
    n = 48_000
    cols = {"k": rng.integers(0, 1 << 45, n), "v": rng.integers(0, 50, n).astype(np.int32)}
    tables = [("s", [("k", "BIGINT"), ("v", "INT")], lambda: cols)]
    kw = dict(enable_hash_groupby=True, stream_threshold_bytes=200_000,
              default_fragment_rows=12_000)
    ref, port = _load(tables, JConfig(**kw), Config(**kw))
    runs = _record_runs(monkeypatch)
    sql = "SELECT k, COUNT(*), SUM(v) FROM s GROUP BY k"
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same_rows(got, want)
    assert port.executor.last_stream.waves == 4
    # each wave's 12,000 keys take a second run at 4 x the cap; the merge's
    # sort tier sizes its 48,000 groups in its one run, where the
    # reference grows its first cap with a second
    assert [r[0] for r in runs["ref"][-2:]] == ["sort", "sort"]
    assert _tiers(_same_choice({"port": runs["port"], "ref": runs["ref"][:-1]})) \
        == ["hash"] * 4 + ["sort"]


@pytest.mark.parametrize("keys,tier", [(17_000, "sort"), (20_000, "hash"), (24_000, "sort"),
                                       (400_000, "sort")])
def test_rule_window_at_ten_million_rows(keys, tier):
    """The reference's estimator (`_estimate_group_ndv`) adds the sample's
    singleton share times the rows not sampled, so over 10^7 rows only a
    narrow band of uniform key counts estimates into [rows / 32, 2^19],
    where the rule takes the hash tier: 20,000 keys (hsparse, the chip's
    table), not 17,000 or 24,000, nor 400,000 (an estimate of ~8.9 x
    10^6).  The estimate reads the first fragment's first 65,536 rows and
    the table's row count, so a stand-in table holds just those, and
    both packages' estimators read it through a stand-in GROUP BY node:
    the same estimate, so the same tier."""
    from types import SimpleNamespace

    from heavydb_tpu import types as JT
    from heavydb_tpu.plan import exprs as JE
    from heavydb_tpu.plan import rel_alg as JR
    from heavydb_tpu_torch.plan import exprs as E

    rng = np.random.default_rng(11)
    sample = rng.choice(rng.integers(1, 10**10, keys), 65_536)

    def node(rel, ex, types):
        col = SimpleNamespace(col_id=1, type=types.bigint())
        table = SimpleNamespace(table_id=-1, generation=0, columns=[col], num_rows=10**7,
                                fragments=[SimpleNamespace(num_rows=10**7,
                                                           chunks={1: sample})])
        scan = object.__new__(rel.Scan)
        scan.table = table
        return SimpleNamespace(inputs=[scan],
                               group_exprs=[ex.InputRef(0, 0, types.bigint())])

    want = JExecutor._estimate_group_ndv(None, node(JR, JE, JT))
    port = SimpleNamespace(_ndv_cache={}, _sample_ndv=Executor._sample_ndv)
    ndv = Executor._estimate_group_ndv(port, node(R, E, T))
    assert ndv == want
    assert (10**7 // ndv <= 32 and ndv <= 1 << 19) == (tier == "hash")
    if keys == 400_000:
        assert 8_000_000 < ndv < 10_000_000
