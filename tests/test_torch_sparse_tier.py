"""Engine parity for the sort and radix group-by tiers: the same tables in
heavydb_tpu.connect() and heavydb_tpu_torch.connect(device="cpu"), the same
SELECTs through db.sql(), the same rows out (compared as sorted sets).

The port runs its default route (a dense key space above
sortagg_min_slots goes to the radix tier, here through the kernels' plain
versions) and, separately, enable_radix_groupby=False (the sort tier).
The JAX package runs force_radix_groupby=True (its numpy specification of
the radix kernel) and its sort tier.  The table is the one of
tests/test_sparse_tier.py: BIGINT keys, NULLs every 7th row, a BIGINT and
a DOUBLE value; sortagg_min_slots=256 lets it reach the tiers.

Tolerances: keys, counts, integer sums, MIN and MAX exact; DOUBLE sums and
AVG rtol=1e-9; FLOAT sums on the sort tier rtol=1e-6 (float64 prefix sums
on both sides, one float32 rounding each); STDDEV and VARIANCE rtol=1e-4:
the sort tier takes each group's sum of squares and sum as differences of
float64 prefix sums over the whole table (both engines, in another order),
and the variance cancels them, so a group of close values keeps an
absolute error of about 1e-16 times the table's prefix of squares.
"""

import math

import numpy as np
import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu.exec.executor import Executor as JExecutor
from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.exec.executor import Executor

I64_NULL = np.iinfo(np.int64).min
I32_NULL = np.iinfo(np.int32).min


def _sparse_columns(n=8000, key_range=4000, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, key_range, n).astype(np.int64)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    f = np.round(rng.uniform(-100, 100, n), 3)
    null = np.arange(n) % 7 == 0
    return {"k": k, "v": np.where(null, I64_NULL, v), "f": np.where(null, np.nan, f)}


def _wide_columns(n=6000, seed=1):
    """Keys with no dense range: b BIGINT over +-2^40 with NULLs, d DOUBLE
    from a small set holding NaN (NULL), -0.0 and +0.0."""
    rng = np.random.default_rng(seed)
    b = rng.choice(rng.integers(-2**40, 2**40, 700), n)
    b[rng.random(n) < 0.05] = I64_NULL
    d = rng.choice(np.array([np.nan, -0.0, 0.0, 1.25, -3.5, 1e300]), n)
    x = rng.integers(-1000, 1000, n).astype(np.int32)
    x[rng.random(n) < 0.1] = I32_NULL
    v = np.where(rng.random(n) < 0.1, np.nan, rng.random(n)).astype(np.float32)
    return {"b": b.astype(np.int64), "d": d, "k": rng.integers(0, 5, n).astype(np.int32),
            "x": x, "v": v}


TABLES = [
    ("s", [("k", "BIGINT"), ("v", "BIGINT"), ("f", "DOUBLE")], _sparse_columns),
    ("u", [("b", "BIGINT"), ("d", "DOUBLE"), ("k", "INT"), ("x", "INT"),
           ("v", "FLOAT")], _wide_columns),
]


def _hot_columns():
    # one key with more rows than a radix partition tile holds (and than
    # the reference's int-limb bound), plus 500 scattered keys; v INT keeps
    # SUM(v) within the reference's radix stream budget
    n_hot = 32767 + 200
    k = np.concatenate([np.full(n_hot, 7), 1000 + np.arange(500)]).astype(np.int64)
    v = np.concatenate([np.arange(n_hot) % 5 - 2, np.ones(500)]).astype(np.int32)
    return {"k": k, "v": v}


def _cap_columns():
    rng = np.random.default_rng(3)
    return {"k": rng.integers(-2**40, 2**40, 6000).astype(np.int64)}


def _load(ref_cfg, port_cfg, tables):
    ref = hdt.connect(config=ref_cfg)
    port = hdt_torch.connect(device="cpu", config=port_cfg)
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


def _jcfg(**kw):
    return JConfig(sortagg_min_slots=256, baseline_groupby_threshold=1 << 24, **kw)


def _cfg(**kw):
    return Config(sortagg_min_slots=256, baseline_groupby_threshold=1 << 24, **kw)


@pytest.fixture(scope="module")
def dbs():
    """{route: db}: the JAX package's radix and sort tiers, the port's
    default route and its sort tier, all holding the same tables."""
    ref_radix, port_radix = _load(_jcfg(force_radix_groupby=True), _cfg(), TABLES)
    ref_sort, port_sort = _load(_jcfg(), _cfg(enable_radix_groupby=False), TABLES)
    return {"ref_radix": ref_radix, "ref_sort": ref_sort,
            "port": port_radix, "port_sort": port_sort}


def _key(r):
    return tuple((v is None, "" if v is None else
                  (round(v, 3) if isinstance(v, float) else v)) for v in r)


def _same_rows(got, want, rtols=None):
    assert len(got) == len(want)
    for gr, wr in zip(sorted(got, key=_key), sorted(want, key=_key)):
        for j, (g, w) in enumerate(zip(gr, wr)):
            if isinstance(w, float):
                assert g is not None
                if math.isnan(w):
                    assert math.isnan(g)
                else:
                    rel = (rtols or {}).get(j, 1e-9)
                    assert g == pytest.approx(w, rel=rel, abs=1e-9), (gr, wr)
            else:
                assert g == w, (j, gr, wr)


F32, VAR = 1e-6, 1e-4
# (sql, {result column: rtol} where it is not 1e-9, the port's default
# route)
QUERIES = [
    ("SELECT k, count(*) FROM s GROUP BY k", None, "radix"),
    ("SELECT k, count(v) FROM s GROUP BY k", None, "radix"),
    ("SELECT k, sum(v) FROM s GROUP BY k", None, "radix"),
    ("SELECT k, sum(f) FROM s GROUP BY k", None, "radix"),
    ("SELECT k, min(v), max(v) FROM s GROUP BY k", None, "sort"),  # 8-byte MIN/MAX
    ("SELECT k, avg(v) FROM s GROUP BY k", None, "radix"),
    ("SELECT k, count(*) FROM s GROUP BY k HAVING count(*) > 2", None, "radix"),
    ("SELECT k, count(*), sum(v), avg(f) FROM s WHERE v > 0 GROUP BY k", None, "radix"),
    ("SELECT k, min(f), max(f), stddev(f) FROM s GROUP BY k", {3: VAR}, "sort"),
    ("SELECT k, count(*), min(CAST(v AS INT)), max(CAST(v AS INT)), variance(v) "
     "FROM s GROUP BY k", {4: VAR}, "radix"),
    ("SELECT b, COUNT(*) FROM u GROUP BY b", None, "sort"),
    ("SELECT b, k, COUNT(*), SUM(x), MIN(x) FROM u GROUP BY b, k", None, "sort"),
    ("SELECT d, COUNT(*), SUM(v), AVG(x), MAX(v) FROM u GROUP BY d", {2: F32}, "sort"),
    ("SELECT b, SUM(v), COUNT(v), MIN(d) FROM u WHERE k < 3 GROUP BY b", {1: F32}, "sort"),
    ("SELECT b, d, COUNT(*) FROM u GROUP BY b, d HAVING COUNT(*) > 1", None, "sort"),
]


@pytest.mark.parametrize("route", ["port", "port_sort"])
@pytest.mark.parametrize("sql,rtols,_route", QUERIES, ids=range(len(QUERIES)))
def test_tiers_match_reference(dbs, route, sql, rtols, _route):
    want = dbs["ref_sort"].sql(sql).rows()
    _same_rows(dbs[route].sql(sql).rows(), want, rtols)


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


@pytest.mark.parametrize("sql,_cols,route", QUERIES, ids=range(len(QUERIES)))
def test_routing(dbs, monkeypatch, sql, _cols, route):
    runs = _record_runs(monkeypatch)
    dbs["port"].sql(sql).rows()
    dbs["port_sort"].sql(sql).rows()
    assert [r[0] for r in runs["port"]] == [route, "sort"]


def test_retry_ladder_matches_reference(monkeypatch):
    """Hot key: radix bit 0 -> the sort tier, in both packages.  Too many
    groups for the sort tier's first cap: the reference reruns at
    bucket(num_groups), the port sizes its groups from the exact count in
    its one run.  The runs agree as far as the port's go, and the rows
    agree."""
    tables = [("h", [("k", "BIGINT"), ("v", "INT")], _hot_columns),
              ("w", [("k", "BIGINT")], _cap_columns)]
    ref, port = _load(_jcfg(force_radix_groupby=True,
                            baseline_groupby_initial_entries=256),
                      _cfg(baseline_groupby_initial_entries=256), tables)
    for sql, steps, ref_steps in (
            ("SELECT k, count(*), sum(v) FROM h GROUP BY k", ["radix", "sort"],
             ["radix", "sort"]),
            ("SELECT k, count(*) FROM w GROUP BY k", ["sort"], ["sort", "sort"])):
        runs = _record_runs(monkeypatch)
        want = ref.sql(sql).rows()
        got = port.sql(sql).rows()
        _same_rows(got, want)
        assert runs["port"] == runs["ref"][:len(steps)]
        assert [r[0] for r in runs["port"]] == steps
        assert [r[0] for r in runs["ref"]] == ref_steps
    hot = dict((r[0], r[1:]) for r in port.sql(
        "SELECT k, count(*), sum(v) FROM h GROUP BY k").rows())
    assert hot[7] == (32967, int((np.arange(32967) % 5 - 2).sum()))


def test_hash_groupby_is_not_ported(monkeypatch):
    """The three-row sparse BIGINT key on the hash tier: the port gives the
    reference's rows and the reference's runs (tier and claim-table cap).
    The name dates from when the port refused the tier here; it is kept so
    the case stays the same case across the suite's history."""
    tables = [("q", [("b", "BIGINT")],
               lambda: {"b": np.array([1, 1099511627776, I64_NULL], np.int64)})]
    ref, port = _load(JConfig(enable_hash_groupby=True),
                      Config(enable_hash_groupby=True), tables)
    runs = _record_runs(monkeypatch)
    sql = "SELECT b, COUNT(*) FROM q GROUP BY b"
    want = ref.sql(sql).rows()
    _same_rows(port.sql(sql).rows(), want)
    assert runs["port"] == runs["ref"] == [("hash", 4096)]


def _two_values():
    # 100 rows of two BIGINT keys: rows / NDV = 50 > 32, so the reference
    # leaves the hash tier to the sort tier
    return {"b": np.tile(np.array([1, 2**40], np.int64), 50),
            "v": np.arange(100, dtype=np.int64) - 30}


def _three_rows():
    return {"b": np.array([1, 2**40, I64_NULL], np.int64),
            "v": np.array([4, 5, 6], np.int64)}


@pytest.mark.parametrize("sql", [
    "SELECT b, COUNT(*), SUM(v) FROM h2 GROUP BY b",
    # an expression key: no NDV estimate, so no hash tier
    "SELECT b + 1, COUNT(*), SUM(v) FROM h3 GROUP BY b + 1",
], ids=["rows_per_ndv_50", "expression_key"])
def test_hash_setting_answers_on_the_sort_tier(monkeypatch, sql):
    """enable_hash_groupby=True: where the reference takes the sort tier,
    the port answers there with the same rows instead of raising."""
    tables = [("h2", [("b", "BIGINT"), ("v", "BIGINT")], _two_values),
              ("h3", [("b", "BIGINT"), ("v", "BIGINT")], _three_rows)]
    ref, port = _load(JConfig(enable_hash_groupby=True),
                      Config(enable_hash_groupby=True), tables)
    runs = _record_runs(monkeypatch)
    want = ref.sql(sql).rows()
    _same_rows(port.sql(sql).rows(), want)
    assert [r[0] for r in runs["ref"]] == [r[0] for r in runs["port"]] == ["sort"]
    assert runs["port"] == runs["ref"]


def test_hash_tier_choice_matches_reference(monkeypatch):
    """The three-row key is where the reference takes the hash tier: the
    port takes it there too, with the same runs and the same rows, and
    keeps the sort tier for the other shapes (test above)."""
    tables = [("h3", [("b", "BIGINT"), ("v", "BIGINT")], _three_rows)]
    ref, port = _load(JConfig(enable_hash_groupby=True),
                      Config(enable_hash_groupby=True), tables)
    runs = _record_runs(monkeypatch)
    sql = "SELECT b, COUNT(*), SUM(v) FROM h3 GROUP BY b"
    want = ref.sql(sql).rows()
    _same_rows(port.sql(sql).rows(), want)
    assert [r[0] for r in runs["ref"]] == ["hash"]
    assert runs["port"] == runs["ref"]


def _sized_columns(n=6000, seed=5):
    """Keys with no dense range, so the sort tier groups them: k512 and
    k513 hold exactly 512 and 513 distinct values (a bucket boundary of
    the group domain and one past it), kn 700 with NULL in every 9th row;
    v INT in [-1000, 1000)."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(-2**40, 2**40, 2000))[:700]
    rng.shuffle(pool)

    def keys(d):
        return pool[:d][rng.permutation(np.arange(n) % d)].astype(np.int64)

    kn = keys(700)
    kn[np.arange(n) % 9 == 0] = I64_NULL
    return {"k512": keys(512), "k513": keys(513), "kn": kn,
            "v": rng.integers(-1000, 1000, n).astype(np.int32)}


def _small_columns():
    # 200 rows: a row domain no larger than the first cap of 256
    rng = np.random.default_rng(6)
    return {"k": rng.integers(-2**40, 2**40, 150)[np.arange(200) % 150].astype(np.int64)}


SIZED_TABLES = [("g", [("k512", "BIGINT"), ("k513", "BIGINT"), ("kn", "BIGINT"),
                       ("v", "INT")], _sized_columns),
                ("sm", [("k", "BIGINT")], _small_columns)]


def _compound_nodes(tree):
    stack, out = [tree], []
    while stack:
        node = stack.pop()
        if node["name"].startswith("Compound#"):
            out.append(node)
        stack.extend(node.get("children", ()))
    return out


@pytest.fixture(scope="module")
def sized_dbs():
    """The JAX package and the port with a first sort-tier cap of 256
    groups, the port's debug timer on."""
    return _load(_jcfg(baseline_groupby_initial_entries=256),
                 _cfg(baseline_groupby_initial_entries=256, enable_debug_timer=True),
                 SIZED_TABLES)


@pytest.mark.parametrize("sql,sized", [
    ("SELECT kn, COUNT(*), SUM(v) FROM g GROUP BY kn", ["groups"]),
    ("SELECT k513, COUNT(*), MIN(v) FROM g GROUP BY k513 HAVING COUNT(*) > 11", ["groups"]),
    # no row survives a filter the chunk stats cannot skip
    ("SELECT k513, COUNT(*) FROM g WHERE v * 2 = 1 GROUP BY k513", ["groups"]),
    ("SELECT k512, SUM(v), MAX(v) FROM g GROUP BY k512", ["groups"]),
    ("SELECT k513, SUM(v), MAX(v) FROM g GROUP BY k513", ["groups"]),
    ("SELECT k, COUNT(*) FROM sm GROUP BY k", None),
], ids=["null_keys", "having", "no_rows", "at_bucket", "past_bucket", "below_cap"])
def test_sort_tier_sizes_groups_in_its_run(sized_dbs, monkeypatch, sql, sized):
    """More groups than the first cap: the port's one run reads the exact
    group count and sizes every per-group array from it (no retry, where
    the reference reruns); a row domain no larger than the cap takes no
    read.  The rows are the reference's."""
    ref, port = sized_dbs
    runs = _record_runs(monkeypatch)
    want = ref.sql(sql).rows()
    _same_rows(port.sql(sql).rows(), want)
    (node,) = _compound_nodes(port.last_query_timings)
    assert node["tier"] == "sort" and node["retries"] == 0
    assert node.get("sized_in_run") == sized
    assert runs["port"] == [("sort", 256 if sized else 224)]


@pytest.mark.parametrize("path", ["streamed", "sharded"])
def test_sort_tier_sizes_groups_in_waves_and_shards(monkeypatch, path):
    """Fragment waves and shard leaves each read their own group count,
    and the merge reads its own: every run is a first run, and the rows
    are the reference's."""
    kw = dict(baseline_groupby_initial_entries=256)
    extra = dict(stream_threshold_bytes=20_000, default_fragment_rows=1500) \
        if path == "streamed" else dict(num_shards=4)
    ref, port = _load(_jcfg(**kw), _cfg(**kw, **extra), SIZED_TABLES[:1])
    runs = _record_runs(monkeypatch)
    sql = "SELECT kn, COUNT(*), SUM(v), MIN(v) FROM g GROUP BY kn"
    want = ref.sql(sql).rows()
    _same_rows(port.sql(sql).rows(), want)
    if path == "streamed":
        leaves = port.executor.last_stream.waves
    else:
        (shard_run,) = port.executor.shard_runs
        assert shard_run.mode == "sharded"
        leaves = shard_run.leaf_runs
    assert leaves > 1
    assert [tier for tier, _ in runs["port"]] == ["sort"] * (leaves + 1)
