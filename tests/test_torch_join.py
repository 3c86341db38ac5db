"""Joins: heavydb_tpu_torch against the JAX package.

Ops level: every function of heavydb_tpu_torch.ops.join against
heavydb_tpu.ops.join on the same numpy-seeded inputs, integers exact and
the hashes (`_mix32`, `_splitmix64_combine`) bit-equal.  The sorted
build's order of rows within one key is the only freedom: the reference
sorts unstably, the port stably (rows ascending within a key), so
`build_sorted` is compared as (key, row) multisets plus that order.

Engine level: the same seeded tables go into heavydb_tpu.connect() and,
copied through load_state, into heavydb_tpu_torch.connect(device="cpu");
every query must give the reference's rows: as multisets without ORDER
BY, in order with it.  Integers are exact, DOUBLE results rtol 1e-9, FLOAT
sums rtol 1e-4 / atol 1e-3.  Then the join memory guard.  The queries of
the reference's join suites are in tests/test_torch_join_suites.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
from heavydb_tpu.exec import compound_kernel as JCK
from heavydb_tpu.ops import join as JJ
from heavydb_tpu_torch.errors import DeviceMemoryExceeded, NotSupported, WatchdogException
from heavydb_tpu_torch.exec import compound_kernel as CK
from heavydb_tpu_torch.exec import executor as X
from heavydb_tpu_torch.ops import join as J
from tests.test_torch_engine import _copy_state

I32_NULL = np.iinfo(np.int32).min


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_hash_table(build, slots: int):
    """The reference's build_hash_table, jitted (its eager form compiles
    op by op)."""
    f = jax.jit(lambda b: JJ.build_hash_table(b, slots)._replace(slots=0, rounds=0))
    return f(build)._replace(slots=slots, rounds=4)


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), (got[:12], want[:12])


# ---------------------------------------------------------------------------
# ops level
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def join_inputs():
    """A build side of 3000 padded rows (2900 live) with duplicate keys,
    NULL keys and keys outside [KMIN, KMIN + KRANGE); a probe side of 4000
    rows with NULL keys and a mask."""
    rng = np.random.default_rng(5)
    b, n = 3000, 4000
    bkeys = rng.integers(-20, 700, b).astype(np.int64)
    bvalid = rng.random(b) > 0.05
    pkeys = rng.integers(-40, 760, n).astype(np.int64)
    pvalid = rng.random(n) > 0.05
    pmask = rng.random(n) > 0.2
    return dict(bkeys=bkeys, bvalid=bvalid, nb=2900, pkeys=pkeys, pvalid=pvalid,
                pmask=pmask, kmin=0, krange=640)


def test_build_sorted_and_probe_counts(join_inputs):
    d = join_inputs
    got = J.build_sorted(_t(d["bkeys"]), _t(d["bvalid"]), d["nb"])
    want = JJ.build_sorted(jnp.asarray(d["bkeys"]), jnp.asarray(d["bvalid"]), d["nb"])
    _eq(got.keys_sorted, want.keys_sorted)
    _eq(got.valid_sorted, want.valid_sorted)
    g = sorted(zip(got.keys_sorted.tolist(), got.rows_sorted.tolist()))
    w = sorted(zip(np.asarray(want.keys_sorted).tolist(),
                   np.asarray(want.rows_sorted).tolist()))
    assert g == w
    # stable: rows ascending within each key
    ks, rs = got.keys_sorted.numpy(), got.rows_sorted.numpy()
    same = ks[1:] == ks[:-1]
    assert (rs[1:][same] > rs[:-1][same]).all()
    pv = d["pvalid"] & d["pmask"]
    _eq_pair(J.probe_counts(got, _t(d["pkeys"]), _t(pv)),
             JJ.probe_counts(want, jnp.asarray(d["pkeys"]), jnp.asarray(pv)))


def _eq_pair(got, want):
    for g, w in zip(got, want):
        _eq(g, w)


def test_sorted_build_keeps_a_valid_int64_max_key_before_invalid_rows():
    keys = np.array([5, np.iinfo(np.int64).max, 3, 7, np.iinfo(np.int64).max], np.int64)
    valid = np.array([True, True, False, True, False])
    got = J.build_sorted(_t(keys), _t(valid), 5)
    assert got.keys_sorted.tolist()[:3] == [5, 7, np.iinfo(np.int64).max]
    assert got.valid_sorted.tolist() == [True, True, True, False, False]
    assert got.rows_sorted.tolist()[:3] == [0, 3, 1]
    lo, cnt = J.probe_counts(got, _t(np.array([np.iinfo(np.int64).max, 3])), None)
    assert lo.tolist() == [2, 0] and cnt.tolist() == [1, 0]


@pytest.mark.parametrize("slots", [64, 8192])
def test_hash_table_and_probe(join_inputs, slots):
    """A 64-slot table cannot hold ~700 distinct keys in 4 rounds:
    `unresolved` counts them, as the reference's does."""
    d = join_inputs
    got_b = J.build_sorted(_t(d["bkeys"]), _t(d["bvalid"]), d["nb"])
    want_b = JJ.build_sorted(jnp.asarray(d["bkeys"]), jnp.asarray(d["bvalid"]), d["nb"])
    got = J.build_hash_table(got_b, slots)
    want = _ref_hash_table(want_b, slots)
    _eq(got.keys, want.keys)
    _eq(got.lo, want.lo)
    _eq(got.cnt, want.cnt)
    assert int(got.unresolved) == int(want.unresolved)
    assert (int(got.unresolved) > 0) == (slots == 64)
    pv = d["pvalid"] & d["pmask"]
    _eq_pair(J.probe_counts_hash(got, _t(d["pkeys"]), _t(pv)),
             JJ.probe_counts_hash(want, jnp.asarray(d["pkeys"]), jnp.asarray(pv)))


def _perfect_pair(d):
    bv = d["bvalid"]
    got = J.build_perfect(_t(d["bkeys"]), None if bv is None else _t(bv), d["nb"],
                          d["kmin"], d["krange"])
    want = jax.jit(JJ.build_perfect, static_argnums=(3, 4))(
        jnp.asarray(d["bkeys"]), None if bv is None else jnp.asarray(bv), d["nb"],
        d["kmin"], d["krange"])
    return got, want


def _perfect_case(case):
    """Build sides of the perfect build's edges: (keys, valid, num_rows,
    key_min, key_range)."""
    rng = np.random.default_rng(11)
    i64 = np.iinfo(np.int64)
    keys = rng.integers(90, 160, 500).astype(np.int64)
    valid = rng.random(500) > 0.3
    if case == "all_dropped":
        return keys, np.zeros(500, bool), 500, 100, 50
    if case == "range_1":
        return keys, valid, 480, 120, 1
    if case == "edges":
        keys[::7] = 99  # below key_min
        keys[3::7] = 150  # key_min + key_range
        keys[5::11] = 149
        keys[:4] = [i64.min, i64.max, i64.min + 1, -1]
        return keys, valid, 500, 100, 50
    if case == "num_rows_short":
        return keys, valid, 137, 90, 70
    if case == "valid_none":
        return keys, None, 450, 90, 70
    if case == "repeats":
        runs = np.repeat(rng.integers(0, 40, 80), rng.integers(1, 8, 80))  # in row order
        keys = np.concatenate([runs, rng.permutation(runs)]).astype(np.int64)
        return keys, rng.random(keys.shape[0]) > 0.1, keys.shape[0] - 3, 0, 40
    assert case == "empty"
    return np.zeros(0, np.int64), np.zeros(0, bool), 0, 0, 16


@pytest.mark.parametrize("case", ["all_dropped", "range_1", "edges", "num_rows_short",
                                  "valid_none", "repeats", "empty"])
def test_perfect_build_edges(case):
    """The perfect build's CPU path against the reference's at its edges:
    its counts, offsets and payload, element for element, in the dtypes
    of PerfectBuild; on the CPU the kernel never launches."""
    from heavydb_tpu_torch.kernels import join_build

    keys, valid, nb, kmin, krange = _perfect_case(case)
    before = join_build.perfect_count.launches
    got, want = _perfect_pair(dict(bkeys=keys, bvalid=valid, nb=nb, kmin=kmin, krange=krange))
    _eq(got.counts, want.counts)
    _eq(got.offsets, want.offsets)
    _eq(got.payload, want.payload)
    assert (got.counts.dtype, got.offsets.dtype, got.payload.dtype) == (
        torch.int32, torch.int64, torch.int32)
    assert got.counts.shape == (krange,) and got.payload.shape == keys.shape
    assert join_build.perfect_count.launches == before


def test_perfect_build_and_probes(join_inputs):
    d = join_inputs
    got, want = _perfect_pair(d)
    _eq(got.counts, want.counts)
    _eq(got.offsets, want.offsets)
    _eq(got.payload, want.payload)
    pk, pv, pm = _t(d["pkeys"]), _t(d["pvalid"]), _t(d["pmask"])
    jpk, jpv, jpm = (jnp.asarray(d[k]) for k in ("pkeys", "pvalid", "pmask"))
    _eq_pair(J.probe_perfect(got, pk, pv, d["krange"]),
             JJ.probe_perfect(want, jpk, jpv, d["krange"]))
    _eq_pair(J.probe_perfect_unique(got, pk, pv, d["krange"], pm),
             JJ.probe_perfect_unique(want, jpk, jpv, d["krange"], jpm))
    lo, cnt = J.probe_perfect(got, pk, pv, d["krange"])
    jlo, jcnt = JJ.probe_perfect(want, jpk, jpv, d["krange"])
    _eq_pair(J.probe_unique(lo, cnt, got.payload, pm),
             JJ.probe_unique(jlo, jcnt, want.payload, jpm))
    _eq(J.build_matched_flags(lo, cnt, got.payload, pm, 3000),
        JJ.build_matched_flags(jlo, jcnt, want.payload, jpm, 3000))


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("cap", [1024, 16384])
def test_expand_matches(join_inputs, cap, left_outer):
    """cap 1024 is below what the 4000 probe rows need: the slots within it
    and the exact `needed` still equal the reference's."""
    d = join_inputs
    got, want = _perfect_pair(d)
    lo, cnt = J.probe_perfect(got, _t(d["pkeys"]), _t(d["pvalid"]), d["krange"])
    jlo, jcnt = JJ.probe_perfect(want, jnp.asarray(d["pkeys"]),
                                 jnp.asarray(d["pvalid"]), d["krange"])
    g = J.expand_matches(lo, cnt, got.payload, _t(d["pmask"]), cap, left_outer)
    w = jax.jit(JJ.expand_matches, static_argnums=(4, 5))(
        jlo, jcnt, want.payload, jnp.asarray(d["pmask"]), cap, left_outer)
    for a, b in zip(g, w):
        _eq(a, b)
    assert g[4].dtype == torch.int64
    assert (int(g[4]) > cap) == (cap == 1024)


def test_expand_matches_needed_does_not_wrap():
    """needed past 2^31 stays exact (the reference's int32 sum would wrap)."""
    cnt = torch.full((3,), 1 << 30, dtype=torch.int32)
    lo = torch.zeros(3, dtype=torch.int32)
    out = J.expand_matches(lo, cnt, torch.arange(8, dtype=torch.int32), None, 8, False)
    assert int(out[4]) == 3 << 30
    assert out[2].all() and out[0].tolist() == [0] * 8


def test_hashes_bit_equal():
    rng = np.random.default_rng(9)
    keys = np.concatenate([rng.integers(-2**63, 2**63 - 1, 5000, dtype=np.int64),
                           np.array([0, -1, 1, np.iinfo(np.int64).max,
                                     np.iinfo(np.int64).min], np.int64)])
    lo32, hi32 = J._split32(_t(keys))
    jk = jnp.asarray(keys)
    jlo = (jk & jnp.int64(0xFFFFFFFF)).astype(jnp.uint32)
    jhi = jnp.right_shift(jk.view(jnp.uint64), jnp.uint64(32)).astype(jnp.uint32)
    for r in range(4):
        _eq(J._mix32(lo32, hi32, r), np.asarray(JJ._mix32(jlo, jhi, r)).astype(np.int64))
    h = torch.full(keys.shape, CK._HASH_SEED, dtype=torch.int64)
    jh = jnp.full(keys.shape, 0x243F6A8885A308D3, jnp.uint64)
    for k in (keys, np.roll(keys, 7)):
        h = CK._splitmix64_combine(h, _t(k))
        jh = JCK._splitmix64_combine(jh, jnp.asarray(k))
        assert np.array_equal(h.numpy(), np.asarray(jh).view(np.int64))
    assert np.array_equal(CK._srl(h, 1).numpy(),
                          np.asarray(jh >> jnp.uint64(1)).view(np.int64))


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

N_FACT = 3000
COLORS = ["red", "green", "blue", "cyan", "plum", "teal"]


@pytest.fixture(scope="module")
def engines():
    """fact (probe side), dim (unique keys 0..149 in a shuffled order, a
    TEXT column of its own dictionary), multi (keys with 0-6 rows each),
    dupdim (a key range as wide as its rows, with duplicates), dupfan (three
    rows for each of fact.g's six values and one more key, a range wider
    than its rows), wide (BIGINT keys of a 2^41 range, duplicated), tiny (4
    rows, for CROSS), t (two INT columns, for a self-join)."""
    rng = np.random.default_rng(17)
    ref = hdt.connect()

    def load(name, decl, cols, frag=None):
        with_ = f" WITH (fragment_size={frag})" if frag else ""
        ref.sql(f"CREATE TABLE {name} ({decl}){with_}")
        ref.load_table(name, cols)

    n = N_FACT
    k = rng.integers(0, 200, n).astype(np.int32)
    k[rng.random(n) < 0.05] = I32_NULL
    wide_keys = rng.integers(-2**40, 2**40, 400).astype(np.int64)
    load("fact", "k INT, g INT NOT NULL, kb BIGINT, kb2 BIGINT, v FLOAT, d DOUBLE, s TEXT",
         {"k": k, "g": rng.integers(0, 6, n).astype(np.int32),
          "kb": wide_keys[rng.integers(0, 400, n)],
          "kb2": wide_keys[rng.integers(0, 400, n)] // 3,
          "v": rng.random(n).astype(np.float32),
          "d": rng.standard_normal(n) * 10,
          "s": [COLORS[i] for i in rng.integers(0, 6, n)]}, frag=1000)
    dk = rng.permutation(150).astype(np.int32)
    load("dim", "k INT NOT NULL, nm INT, w DOUBLE, s TEXT",
         {"k": dk, "nm": rng.integers(0, 10, 150).astype(np.int32),
          "w": rng.random(150) * 5,
          "s": [["teal", "red", "mauve", "green"][i] for i in rng.integers(0, 4, 150)]})
    mk = np.repeat(np.arange(100, dtype=np.int32), rng.integers(0, 7, 100))
    load("multi", "k INT, g INT, w FLOAT",
         {"k": mk, "g": rng.integers(0, 6, mk.shape[0]).astype(np.int32),
          "w": rng.random(mk.shape[0]).astype(np.float32)})
    load("dupdim", "k INT, nm INT",
         {"k": np.array([0, 1, 2, 2, 3, 5, 5, 7], np.int32),
          "nm": np.arange(8, dtype=np.int32)})
    load("dupfan", "k INT, nm INT",
         {"k": np.append(np.repeat(np.arange(6, dtype=np.int32), 3), 40),
          "nm": np.arange(19, dtype=np.int32)})
    wk = np.concatenate([wide_keys[:300], wide_keys[:50]])
    load("wide", "kb BIGINT, kb2 BIGINT, u INT",
         {"kb": wk, "kb2": wk // 3, "u": np.arange(wk.shape[0], dtype=np.int32)})
    load("tiny", "t INT", {"t": np.array([1, 2, 3, 4], np.int32)})
    # test_torch_engine's table t in small: the self-join that slice
    # refused now runs
    k10 = rng.integers(1, 11, 2000).astype(np.int32)
    k10[rng.random(2000) < 0.05] = I32_NULL
    load("t", "k10 INT, k100 INT", {"k10": k10,
                                    "k100": rng.integers(1, 101, 2000).astype(np.int32)})
    port = _copy_state(ref, ["fact", "dim", "multi", "dupdim", "dupfan", "wide", "tiny",
                             "t"])
    return ref, port


def _canon(rows):
    def key(r):
        return tuple((v is None, "" if v is None else
                      (round(v, 3) if isinstance(v, float) else v)) for v in r)
    return sorted(rows, key=key)


def _same(got, want, f32_cols=(), ordered=False):
    assert len(got) == len(want), (len(got), len(want))
    if not ordered:
        got, want = _canon(got), _canon(want)
    for gr, wr in zip(got, want):
        assert len(gr) == len(wr)
        for j, (g, w) in enumerate(zip(gr, wr)):
            if isinstance(w, float) and not isinstance(g, str):
                assert g is not None, (gr, wr)
                if math.isnan(w):
                    assert math.isnan(g)
                elif j in f32_cols:
                    assert g == pytest.approx(w, rel=1e-4, abs=1e-3), (gr, wr)
                else:
                    assert g == pytest.approx(w, rel=1e-9, abs=1e-9), (gr, wr)
            else:
                assert g == w, (j, gr, wr)


def _pair(ref, names, **kw):
    return ref, _copy_state(ref, names, **kw)


def _check(engines, sql, f32_cols=()):
    ref, port = engines
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same(got, want, f32_cols, ordered="ORDER BY" in sql.upper())
    return port.executor.join_runs


# (sql, result columns that are FLOAT sums, each join run's build forms)
ENGINE_QUERIES = [
    # INNER, perfect-unique (dim's 150 keys span a range of 150)
    ("SELECT d.nm, COUNT(*), SUM(f.d) FROM fact f JOIN dim d ON f.k = d.k "
     "GROUP BY d.nm", (), [["perfect-unique"]]),
    # INNER, perfect (multi's keys repeat): expansion
    ("SELECT f.g, COUNT(*), SUM(m.w) FROM fact f JOIN multi m ON f.k = m.k "
     "GROUP BY f.g", (2,), [["perfect"]]),
    # INNER over sparse BIGINT keys: the hash table over a sorted build
    ("SELECT COUNT(*), SUM(w.u), SUM(f.d) FROM fact f JOIN wide w ON f.kb = w.kb",
     (), [["hash"]]),
    # multi-key, both keys ranged: an exact range pack
    ("SELECT COUNT(*), SUM(m.w) FROM fact f JOIN multi m ON f.k = m.k AND f.g = m.g",
     (1,), [["hash"]]),
    # multi-key over 2^41-wide BIGINTs: a splitmix64 hash pack and its recheck
    ("SELECT f.g, COUNT(*) FROM fact f JOIN wide w ON f.kb = w.kb AND f.kb2 = w.kb2 "
     "GROUP BY f.g", (), [["hash"]]),
    # projection through a join, ORDER BY over it
    ("SELECT f.k, d.nm, f.d FROM fact f JOIN dim d ON f.k = d.k WHERE f.g = 2 "
     "ORDER BY f.d, f.k LIMIT 40", (), None),
    # LEFT, no residual, and with one (ON-clause semantics)
    ("SELECT f.g, COUNT(*), COUNT(m.w), SUM(m.w) FROM fact f LEFT JOIN multi m "
     "ON f.k = m.k GROUP BY f.g", (3,), [["perfect"]]),
    ("SELECT f.g, COUNT(*), COUNT(m.g) FROM fact f LEFT JOIN multi m "
     "ON f.k = m.k AND m.g > f.g GROUP BY f.g", (), [["perfect"]]),
    ("SELECT f.k, m.g FROM fact f LEFT JOIN multi m ON f.k = m.k AND m.w < 0.3 "
     "WHERE f.g = 1", (), [["perfect"]]),
    # LEFT grouped by a build-side key: its NULL slot
    ("SELECT d.nm, COUNT(*), SUM(f.v) FROM fact f LEFT JOIN dim d ON f.k = d.k "
     "GROUP BY d.nm", (2,), [["perfect-unique"]]),
    ("SELECT m.g, COUNT(*) FROM fact f LEFT JOIN multi m ON f.k = m.k GROUP BY m.g",
     (), [["perfect"]]),
    # FULL
    ("SELECT COUNT(*), COUNT(f.k), COUNT(m.k), SUM(m.g) FROM fact f "
     "FULL JOIN multi m ON f.k = m.k", (), [["perfect"]]),
    ("SELECT m.g, COUNT(*), COUNT(f.g) FROM fact f FULL JOIN multi m ON f.k = m.k "
     "GROUP BY m.g", (), [["perfect"]]),
    # a self-join (test_torch_engine listed it as out of the slice before)
    ("SELECT a.k10, COUNT(*) FROM t a JOIN t b ON a.k100 = b.k100 GROUP BY a.k10",
     (), [["perfect"]]),
    # CROSS
    ("SELECT t.t, COUNT(*), SUM(d.w) FROM tiny t, dim d GROUP BY t.t", (),
     [["cross"]]),
    # SEMI / ANTI, with and without a residual
    ("SELECT g, COUNT(*) FROM fact f WHERE EXISTS (SELECT 1 FROM multi m "
     "WHERE m.k = f.k) GROUP BY g", (), [["perfect"]]),
    ("SELECT g, COUNT(*) FROM fact f WHERE NOT EXISTS (SELECT 1 FROM multi m "
     "WHERE m.k = f.k) GROUP BY g", (), [["perfect"]]),
    ("SELECT g, COUNT(*) FROM fact f WHERE EXISTS (SELECT 1 FROM multi m "
     "WHERE m.k = f.k AND m.g > f.g) GROUP BY g", (), [["perfect"]]),
    ("SELECT g, COUNT(*) FROM fact f WHERE NOT EXISTS (SELECT 1 FROM multi m "
     "WHERE m.k = f.k AND m.g > f.g) GROUP BY g", (), [["perfect"]]),
    ("SELECT g, COUNT(*) FROM fact f WHERE f.k IN (SELECT m.k FROM multi m "
     "WHERE m.g = f.g) GROUP BY g", (), None),
    ("SELECT COUNT(*) FROM fact f WHERE NOT EXISTS (SELECT 1 FROM wide w "
     "WHERE w.kb = f.kb AND w.u < 100)", (), None),
    # three inputs, and a derived (aggregated) table as a build side
    ("SELECT d.nm, COUNT(*), SUM(m.w) FROM fact f JOIN multi m ON f.k = m.k "
     "JOIN dim d ON m.k = d.k GROUP BY d.nm", (2,), None),
    ("SELECT a.g, COUNT(*), SUM(a.c) FROM fact f JOIN (SELECT k, g, COUNT(*) AS c "
     "FROM multi GROUP BY k, g) a ON f.k = a.k GROUP BY a.g", (), None),
    # TEXT keys of two dictionaries: a translated build key
    ("SELECT f.s, COUNT(*), SUM(d.nm) FROM fact f JOIN dim d ON f.s = d.s "
     "GROUP BY f.s", (), [["hash"]]),
    # a fan-out that retries (needed > cap) and a duplicate build key under
    # the unique-build guess (dupdim's range 0..7 is as wide as its 8 rows),
    # which the run expands in place
    ("SELECT f.g, COUNT(*) FROM fact f JOIN multi m ON f.k = m.k "
     "JOIN multi m2 ON m.k = m2.k GROUP BY f.g", (), None),
    ("SELECT d.nm, COUNT(*) FROM fact f JOIN dupdim d ON f.k = d.k GROUP BY d.nm",
     (), [["perfect"]]),
]


@pytest.mark.parametrize("sql,f32,forms", ENGINE_QUERIES)
def test_engine_parity(engines, sql, f32, forms):
    runs = _check(engines, sql, f32)
    assert runs, "no join Compound ran"
    if forms is not None:
        assert [r.builds for r in runs] == forms


def test_retries(engines):
    """The 1:N fan-out of two multi levels passes its first caps: the
    second level's need shows only once the first fits, so two retries;
    dupdim's duplicate keys undo the unique-build guess inside the run,
    which expands the level over the same build: no retry."""
    _, port = engines
    port.sql("SELECT f.g, COUNT(*) FROM fact f JOIN multi m ON f.k = m.k "
             "JOIN multi m2 ON m.k = m2.k GROUP BY f.g").rows()
    (run,) = port.executor.join_runs
    assert run.retries == 2 and run.caps[0] > N_FACT and run.caps[1] > run.caps[0]
    port.sql("SELECT d.nm, COUNT(*) FROM fact f JOIN dupdim d ON f.k = d.k "
             "GROUP BY d.nm").rows()
    (run,) = port.executor.join_runs
    assert run.retries == 0 and run.builds == ["perfect"] and run.caps[0] > 0


def _guess_unique(monkeypatch):
    """The unique-build guess on every INNER / LEFT equi level, which the
    planner's rule makes only for a dense key range without a residual."""
    plan_compound = X.Executor._plan_compound

    def guess(self, node, batches, offsets=(0,)):
        plan = plan_compound(self, node, batches, offsets)
        for li, jp in enumerate(plan.joins):
            if jp.kind in ("INNER", "LEFT"):
                jp.unique_build = True
                plan.caps[li] = 0
        return plan

    monkeypatch.setattr(X.Executor, "_plan_compound", guess)


def _compound_node(db):
    stack = [db.last_query_timings]
    while stack:
        node = stack.pop()
        if node["name"].startswith("Compound#"):
            return node
        stack.extend(node.get("children", ()))


@pytest.mark.parametrize("sql,forced,builds,retries", [
    ("SELECT d.nm, COUNT(*) FROM fact f JOIN dupdim d ON f.k = d.k GROUP BY d.nm",
     None, "perfect", 0),
    ("SELECT COUNT(*), SUM(w.u), SUM(f.d) FROM fact f JOIN wide w ON f.kb = w.kb",
     "hash", "hash", 0),
    ("SELECT f.g, COUNT(*), SUM(w.u) FROM fact f JOIN wide w ON f.kb = w.kb GROUP BY f.g",
     "sorted", "sorted", 0),
    ("SELECT f.g, COUNT(*), COUNT(d.nm), SUM(d.nm) FROM fact f LEFT JOIN dupdim d "
     "ON f.k = d.k GROUP BY f.g", None, "perfect", 0),
    # a residual keeps the planner off the guess: forced, the expansion
    # after the duplicate read applies it with ON-clause semantics
    ("SELECT f.g, COUNT(*), COUNT(d.nm) FROM fact f LEFT JOIN dupdim d "
     "ON f.k = d.k AND d.nm > f.g GROUP BY f.g", "residual", "perfect", 0),
    # every fact row meets three dupfan rows: 3 x 3000 pairs, past the
    # fallback capacity of bucket(3000): the join_cap rung converges
    ("SELECT d.nm, COUNT(*) FROM fact f JOIN dupfan d ON f.g = d.k GROUP BY d.nm",
     None, "perfect", 1),
], ids=["perfect", "hash", "sorted", "left", "left_residual", "past_fallback_cap"])
def test_duplicate_build_key_expands_in_the_run(engines, monkeypatch, sql, forced, builds,
                                                retries):
    """A duplicate build key under the unique-build guess: the run reads
    it and expands the level over the same build, with no retry unless the
    expansion passes the level's fallback capacity.  The rows are the
    reference's."""
    _, port = engines
    monkeypatch.setattr(port.config, "enable_debug_timer", True)
    if forced is not None:
        _guess_unique(monkeypatch)
    if forced == "sorted":
        monkeypatch.setattr(CK, "_JOIN_HASH_MAX_SLOTS", 1 << 10)
    (run,) = _check(engines, sql)
    assert run.builds == [builds] and run.retries == retries
    assert run.caps[0] >= (3 * N_FACT if retries else N_FACT)
    node = _compound_node(port)
    assert node["retries"] == retries and node["sized_in_run"] == ["join_dup#0"]


@pytest.mark.parametrize("max_range,builds", [(150, "perfect-unique"), (149, "hash")])
def test_perfect_range_stops_at_the_kernels_slots(engines, monkeypatch, max_range, builds):
    """The planner gives a perfect build no key range past the widest
    whose int32 slots kernel J1 writes (join_build.MAX_RANGE): dim's keys
    span 150, so with 149 the level takes another build; the rows stay
    the reference's."""
    from heavydb_tpu_torch.kernels import join_build

    monkeypatch.setattr(join_build, "MAX_RANGE", max_range)
    runs = _check(engines, "SELECT d.nm, COUNT(*) FROM fact f JOIN dim d ON f.k = d.k "
                           "GROUP BY d.nm")
    assert [r.builds for r in runs] == [[builds]]


def test_sorted_build(engines, monkeypatch):
    """Past the hash table's slot ceiling the level probes the sorted build
    by binary search; the rows stay the reference's."""
    monkeypatch.setattr(CK, "_JOIN_HASH_MAX_SLOTS", 1 << 10)
    runs = _check(engines, "SELECT f.g, COUNT(*), SUM(w.u) FROM fact f JOIN wide w "
                           "ON f.kb = w.kb GROUP BY f.g")
    assert [r.builds for r in runs] == [["sorted"]]


def test_hash_miss_retries_sorted(engines, monkeypatch):
    """A key that claims no hash slot reruns the level sorted."""
    monkeypatch.setattr(CK, "_join_hash_slots", lambda padded: 16)
    runs = _check(engines, "SELECT COUNT(*), SUM(w.u) FROM fact f JOIN wide w "
                           "ON f.kb = w.kb")
    assert [(r.builds, r.retries) for r in runs] == [(["sorted"], 1)]


def test_cross_join_watchdog(engines):
    ref, port = engines
    sql = "SELECT COUNT(*) FROM fact f, dim d"
    _check(engines, sql)
    cfg = port.executor.config
    port.executor.config = cfg.clone(watchdog_max_projected_rows=1000)
    try:
        with pytest.raises(WatchdogException):
            port.sql(sql).rows()
    finally:
        port.executor.config = cfg


def test_geo_and_unsupported_joins_raise(engines):
    _, port = engines
    with pytest.raises(NotSupported):
        port.sql("SELECT COUNT(*) FROM fact f JOIN dim d ON f.k < d.k").rows()
    with pytest.raises(NotSupported):
        port.sql("SELECT COUNT(*) FROM fact f FULL JOIN dim d "
                 "ON f.k = d.k AND f.g < d.nm").rows()


def test_join_memory_guard(engines, monkeypatch):
    """A join whose bytes pass the free device memory raises
    DeviceMemoryExceeded before anything of it runs; with room it runs."""
    _, port = engines
    sql = ("SELECT f.g, COUNT(*), SUM(m.w) FROM fact f JOIN multi m ON f.k = m.k "
           "GROUP BY f.g")
    port.sql(sql).rows()  # the inputs are resident: only the join is left
    calls = []
    for name in ("build_perfect", "expand_matches", "build_sorted"):
        orig = getattr(J, name)
        monkeypatch.setattr(J, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    seen = []

    def free(device, need=0):
        seen.append(need)
        return 10_000

    monkeypatch.setattr(X, "free_device_bytes", free)
    with pytest.raises(DeviceMemoryExceeded):
        port.sql(sql).rows()
    assert calls == [] and seen and seen[0] > 10_000
    monkeypatch.setattr(X, "free_device_bytes", lambda device, need=0: 1 << 40)
    _check(engines, sql, (2,))
    assert calls

