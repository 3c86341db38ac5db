"""Fragment-wave streaming (exec/partial_agg.py; Executor._plan_waves and
the one-block case of _try_sharded_compound) against the JAX package, with
the same Config(stream_threshold_bytes=..., default_fragment_rows=...) on
both sides:

- streamed aggregates (the shapes of tests/test_buffer_mgr.py
  test_streamed_aggregate_parity) give the reference's rows;
- a STDDEV query past the threshold stays single-pass in both;
- the wave plan under fragment skipping is the reference's;
- the device-memory term, with the free-memory read stubbed: a query that
  would not fit streams in the expected waves and still answers, and one
  whose single fragment would not fit raises DeviceMemoryExceeded before
  any scan or launch; the tier's working bytes a row, by hand; the
  partial rows the waves before a wave hold, counted against the free
  memory before its scan;
- the partials stay on the device, and the merge takes the tier of its
  keys' ranges;
- the decomposition of each streamable aggregate, as the reference's.

Rows are compared sorted by their keys: the queries have no ORDER BY.
Tolerances: integers, counts, MIN and MAX exact; results from FLOAT sums
(SUM and AVG of a FLOAT column, whose partials are FLOAT sums) rtol 1e-4,
atol 1e-3; DOUBLE rtol 1e-9.
"""

import numpy as np
import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu.exec import executor as JEX
from heavydb_tpu.exec import partial_agg as JPA
from heavydb_tpu.plan import rel_alg as JR
from heavydb_tpu.plan.optimizer import optimize as joptimize
from heavydb_tpu.sql.parser import parse_many as jparse
from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.errors import DeviceMemoryExceeded
from heavydb_tpu_torch.exec import executor as EX
from heavydb_tpu_torch.exec import partial_agg as PA
from heavydb_tpu_torch.plan import rel_alg as R
from heavydb_tpu_torch.plan.optimizer import optimize
from heavydb_tpu_torch.sql.parser import parse_many

N = 300_000
FRAG = 40_000
THRESHOLD = 50_000
F32 = dict(rel=1e-4, abs=1e-3)
F64 = dict(rel=1e-9, abs=1e-12)

# (query, tolerance of each column: e exact, f FLOAT-sum, d DOUBLE)
QUERIES = [
    ("SELECT count(*), sum(w), avg(v), min(w), max(v) FROM t WHERE w > 0",
     "eefee"),
    ("SELECT k, count(v), sum(v), avg(w) FROM t GROUP BY k", "eefd"),
    ("SELECT k % 9, sum(w) FROM t GROUP BY k % 9 HAVING count(*) > 50", "ee"),
    ("SELECT k, min(v), max(w), avg(v), count(*) FROM t WHERE g >= 150000 "
     "GROUP BY k", "eeefe"),
]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {
        "k": rng.integers(0, 250, N).astype(np.int32),
        "v": np.where(rng.random(N) < 0.1, np.nan, rng.random(N)).astype(np.float32),
        "w": rng.integers(-500, 500, N).astype(np.int32),
        # ascending: its chunk stats let a filter skip whole fragments
        "g": np.arange(N, dtype=np.int32),
    }


TABLE = "CREATE TABLE t (k INT, v FLOAT, w INT, g INT)"


def _port(data, **cfg):
    db = hdt_torch.connect(config=Config(default_fragment_rows=FRAG, **cfg),
                           device="cpu")
    db.sql(TABLE)
    db.load_table("t", data)
    return db


def _ref(data, **cfg):
    db = hdt.connect(config=JConfig(default_fragment_rows=FRAG, **cfg))
    db.sql(TABLE)
    db.load_table("t", data)
    return db


def _sorted(rows):
    return sorted(rows, key=lambda r: tuple((x is None, x or 0) for x in r[:1]))


def _check_rows(got, want, tols):
    got, want = _sorted(got), _sorted(want)
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for x, y, t in zip(rg, rw, tols):
            if t == "e" or x is None or y is None:
                assert x == y or (x != x and y != y), (rg, rw)
            else:
                assert x == pytest.approx(y, **(F32 if t == "f" else F64)), (rg, rw)


@pytest.fixture(scope="module")
def streamed(data):
    return (_port(data, stream_threshold_bytes=THRESHOLD),
            _ref(data, stream_threshold_bytes=THRESHOLD))


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_streamed_rows_match_reference(streamed, qi):
    port, ref = streamed
    sql, tols = QUERIES[qi]
    before = port.executor.waves_run
    got = port.sql(sql).rows()
    assert port.executor.waves_run > before  # it did stream
    _check_rows(got, ref.sql(sql).rows(), tols)


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_streamed_rows_match_single_pass(streamed, data, qi):
    port, _ = streamed
    single = _port(data, stream_threshold_bytes=-1)
    sql, tols = QUERIES[qi]
    _check_rows(port.sql(sql).rows(), single.sql(sql).rows(), tols)
    assert single.executor.waves_run == 0


def test_stddev_stays_single_pass_in_both(streamed, monkeypatch):
    port, ref = streamed
    calls = []
    orig = JEX.Executor._exec_compound_streamed
    monkeypatch.setattr(JEX.Executor, "_exec_compound_streamed",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    sql = "SELECT k % 9, stddev(w), count(*) FROM t GROUP BY k % 9"
    before = port.executor.waves_run
    got = port.sql(sql).rows()
    assert port.executor.waves_run == before
    want = ref.sql(sql).rows()
    assert calls == []
    _check_rows(got, want, "ede")


def _waves_of(executor_cls, monkeypatch):
    """Spy on an executor class's scans: the fragment ids of each wave."""
    waves = []
    orig = executor_cls._exec_scan

    def spy(self, node, needed, frag_ids=None):
        if frag_ids is not None:
            waves.append(list(frag_ids))
        return orig(self, node, needed, frag_ids)

    monkeypatch.setattr(executor_cls, "_exec_scan", spy)
    return waves


def test_wave_plan_under_fragment_skipping_is_the_references(data, monkeypatch):
    # g >= 150000 rules out fragments 0-2 (rows 0..119999) by their stats;
    # k, w, v and g are 16 column bytes a row, so a fragment's 640000 bytes
    # pass the 500000-byte wave budget alone: one fragment a wave
    cfg = dict(stream_threshold_bytes=1_000_000)
    port, ref = _port(data, **cfg), _ref(data, **cfg)
    sql = "SELECT k, sum(w), max(v) FROM t WHERE g >= 150000 GROUP BY k"
    pw = _waves_of(EX.Executor, monkeypatch)
    got = port.sql(sql).rows()
    jw = _waves_of(JEX.Executor, monkeypatch)
    want = ref.sql(sql).rows()
    assert pw == jw == [[3], [4], [5], [6], [7]]
    assert port.executor.last_stream.fragments == [3, 4, 5, 6, 7]
    assert port.executor.last_stream.waves == 5
    _check_rows(got, want, "eee")


def _compound(db, sql):
    root = optimize(db._plan_select(parse_many(sql)[0]))
    return next(n for n in R.topo_order(root) if isinstance(n, R.Compound)
                and n.is_aggregate)


# (query, tier, working bytes a row beside the columns, by hand; s = the
# aggregates' stream bytes: a bool mask and the value for each nullable
# argument, r = B6's records; see Executor._tier_row_bytes)
TIER_CASES = [
    # count(v): mask 1; sum(v) FLOAT: 1 + 4; avg(w) INT: 1 + 4 -> s = 11
    ("SELECT k, count(v), sum(v), avg(w) FROM t GROUP BY k", {}, "perfect",
     5 + 11),
    ("SELECT count(*), sum(w) FROM t", {}, "keyless", 1 + 5),
    # sum(w): s 1 + 4, r 8 + 8; min(v): s 1 + 4, r 8 + 4 -> 20 + 2 * 10 + 28
    ("SELECT g, count(*), sum(w), min(v) FROM t GROUP BY g",
     dict(sortagg_min_slots=256), "radix", 20 + 20 + 28),
    # the key operands: a domain flag, g's null flag and value (1 + 1 + 4);
    # partials: count 1, sum 2, min 2 -> 58 + 6 + 2 * 10 + 16 * 5
    ("SELECT g, count(*), sum(w), min(v) FROM t GROUP BY g",
     dict(sortagg_min_slots=256, enable_radix_groupby=False), "sort",
     58 + 6 + 20 + 80),
]


@pytest.mark.parametrize("case", range(len(TIER_CASES)))
def test_tier_row_bytes_by_hand(data, case):
    sql, cfg, tier, want = TIER_CASES[case]
    db = _port(data, **cfg)
    node = _compound(db, sql)
    assert db.executor._group_tier(node)[0] == tier
    assert db.executor._tier_row_bytes(node) == want


MEM_SQL = "SELECT k, count(v), sum(v), avg(w) FROM t GROUP BY k"
# k, v, w: 12 column bytes and 5 + 11 of the perfect tier a row
MEM_ROW = 12 + 16


def test_memory_term_streams_and_answers(data, monkeypatch):
    db = _port(data)  # the default threshold: no stream by bytes alone
    assert db.sql(MEM_SQL) is not None and db.executor.waves_run == 0
    # 2.5 fragments' working bytes free: a whole run (7.5 fragments) does
    # not fit; each wave of one fragment fits half of it
    monkeypatch.setattr(EX, "free_device_bytes",
                        lambda dev, need=0: int(2.5 * FRAG * MEM_ROW))
    got = db.sql(MEM_SQL).rows()
    sp = db.executor.last_stream
    assert sp.by_memory and sp.work_row_bytes == MEM_ROW and sp.row_bytes == 12
    assert sp.waves == db.executor.waves_run == 8
    _check_rows(got, _ref(data, stream_threshold_bytes=-1).sql(MEM_SQL).rows(), "eefd")


def test_memory_term_refuses_before_any_scan_or_launch(data, monkeypatch):
    db = _port(data)
    monkeypatch.setattr(EX, "free_device_bytes",
                        lambda dev, need=0: int(1.5 * FRAG * MEM_ROW))
    ran = []
    for name in ("_exec_scan", "_run_compound"):
        orig = getattr(EX.Executor, name)
        monkeypatch.setattr(EX.Executor, name,
                            lambda self, *a, _o=orig, _n=name, **k:
                            ran.append(_n) or _o(self, *a, **k))
    with pytest.raises(DeviceMemoryExceeded, match="half the"):
        db.sql(MEM_SQL)
    # a query that cannot stream (STDDEV) and does not fit is refused too
    with pytest.raises(DeviceMemoryExceeded, match="cannot run in fragment waves"):
        db.sql("SELECT k, stddev(w) FROM t GROUP BY k")
    assert ran == []


def test_memory_term_refuses_a_merge_that_does_not_fit(data, monkeypatch):
    db = _port(data)
    # room for every wave, then none for the merge of their 8 x 250 partial
    # rows (k, two counts, a FLOAT sum, an int sum: 32 column bytes a row,
    # and the sort tier's working bytes on top)
    reads = iter([int(2.5 * FRAG * MEM_ROW)] + [2000 * 32] * 20)
    monkeypatch.setattr(EX, "free_device_bytes", lambda dev, need=0: next(reads))
    with pytest.raises(DeviceMemoryExceeded, match="merging 2000 partial rows"):
        db.sql(MEM_SQL)
    assert db.executor.waves_run == 8


# g is unique over 300,000 values: the perfect tier, whose output views
# its 300,000 slots x 20 B (g 4, COUNT 8, SUM 8) whatever a wave's rows; a
# wave keeps a copy of its live rows' bucket alone (a fragment's 40,000
# rows: 40,960 x 20 B); g and w are 8 column bytes, and the tier's 5 + 5
# make 18 B a row
WIDE_SQL = "SELECT g, count(*), sum(w) FROM t GROUP BY g"
WIDE_SLOTS = 300_000 * 20


def _wave_partials(rows):
    return EX.B.bucket(rows) * 20


def test_memory_term_counts_the_partials_the_waves_hold(data, monkeypatch):
    held = []
    check = EX.Executor._check_held_partials
    monkeypatch.setattr(EX.Executor, "_check_held_partials",
                        lambda self, sp, rows, h: held.append(h) or check(self, sp, rows, h))
    # by the threshold, waves of at most 62,500 rows: one fragment a wave,
    # the last two (40,000 and 20,000 rows) together.  20 MB free: the
    # merge of the 300,000 partial rows fits (its columns and the perfect
    # tier's bytes, 43 B a row, 12.9 MB), so a merge on the host answers;
    # the waves' slot buffers (6 MB each) would not fit beside the fifth
    # wave, their live rows do
    db = _port(data, stream_threshold_bytes=1_000_000)
    monkeypatch.setattr(EX, "free_device_bytes", lambda dev, need=0: 20_000_000)
    got = db.sql(WIDE_SQL).rows()
    assert held == [i * _wave_partials(FRAG) for i in range(7)]
    assert db.executor.waves_run == 7 and 4 * WIDE_SLOTS + FRAG * 18 > 20_000_000
    _check_rows(got, _ref(data).sql(WIDE_SQL).rows(), "eee")
    # room for every wave, then not for the merge: refused before the
    # partials are concatenated
    reads = iter([20_000_000, 3_000_000])
    monkeypatch.setattr(EX, "free_device_bytes", lambda dev, need=0: next(reads))
    cats = []
    concat = EX.B.concat_batches
    monkeypatch.setattr(EX.B, "concat_batches",
                        lambda parts, **k: cats.append(len(parts)) or concat(parts, **k))
    with pytest.raises(DeviceMemoryExceeded, match="merging 300000 partial rows"):
        db.sql(WIDE_SQL)
    assert cats == [] and db.executor.waves_run == 2 * 7
    # 5 MB free: 300,000 rows x 18 B do not fit, so waves of three
    # fragments (120,000 rows x 18 B within half of it); the third wave's
    # 1,080,000 B beside the two waves' partial rows do not fit: refused
    # before its scan (a merge on the host, of 12.9 MB, would not fit
    # either)
    held.clear()
    db = _port(data)
    monkeypatch.setattr(EX, "free_device_bytes", lambda dev, need=0: 5_000_000)
    scans = _waves_of(EX.Executor, monkeypatch)
    two = 2 * _wave_partials(3 * FRAG)
    with pytest.raises(DeviceMemoryExceeded, match=f"beside the {two} B of partial rows"):
        db.sql(WIDE_SQL)
    assert held == [0, two // 2, two]
    assert scans == [[0, 1, 2], [3, 4, 5]] and db.executor.waves_run == 2


def test_streamed_partials_stay_on_the_device(streamed, monkeypatch):
    """A streamed GROUP BY on one device keeps its waves' partial rows on
    the device (no Batch reaches the host before the result is decoded),
    and the merge takes the tier its keys' ranges give (k's dense range:
    perfect), as the sharded merge does."""
    port, ref = streamed
    sql, tols = QUERIES[1]
    hosts, tiers = [], []
    to_numpy, run = EX.B.Batch.to_numpy, EX.Executor._run_compound
    monkeypatch.setattr(EX.B.Batch, "to_numpy",
                        lambda self: hosts.append(self.nrows) or to_numpy(self))
    monkeypatch.setattr(EX.Executor, "_run_compound",
                        lambda self, node, batches, plan:
                        run(self, node, batches, plan) if tiers.append(EX._tier_of(plan))
                        else run(self, node, batches, plan))
    before = port.executor.waves_run
    _, decode = port.sql_device(sql)
    waves = port.executor.waves_run - before
    assert hosts == [] and waves > 1
    assert tiers == ["perfect"] * (waves + 1)
    _check_rows(decode().rows(), ref.sql(sql).rows(), tols)


def test_memory_term_never_fires_on_the_cpu(data):
    assert EX.free_device_bytes(_port(data).device) is None


@pytest.mark.parametrize("sql", [
    "SELECT count(*), count(v), sum(w), avg(v), min(w), max(v) FROM t",
    "SELECT k, avg(w), sum(v), min(v), max(w), count(*) FROM t GROUP BY k",
    "SELECT k, sample(w), count(*) FROM t GROUP BY k HAVING avg(v) > 0.5",
    "SELECT k % 9, stddev(w) FROM t GROUP BY k % 9",
    "SELECT k, count(DISTINCT w) FROM t GROUP BY k",
])
def test_decomposition_matches_reference(data, sql):
    port = _port(data)
    ref = _ref(data)
    pn = _compound(port, sql)
    root = joptimize(ref._plan_select(jparse(sql)[0]))
    jn = next(n for n in JR.topo_order(root) if isinstance(n, JR.Compound)
              and n.is_aggregate)
    assert PA.decomposable(pn) == JPA.decomposable(jn)
    if not PA.decomposable(pn):
        return
    pw, jw = PA.decompose(pn), JPA.decompose(jn)
    assert [(a.kind.value, str(a.type)) for a in pw[0]] == \
        [(a.kind.value, str(a.type)) for a in jw[0]]
    assert pw[2] == jw[2] and pw[3] == jw[3]
    _, pa, pf = PA.make_leaf_node(pn)
    _, ja, jf = JPA.make_leaf_node(jn)
    pm = PA.make_merge_node(pn, pa, pf, pn.inputs[0])
    jm = JPA.make_merge_node(jn, ja, jf, jn.inputs[0])
    assert [(a.kind.value, str(a.type)) for a in pm.aggs] == \
        [(a.kind.value, str(a.type)) for a in jm.aggs]
    assert [str(e) for e in pm.target_exprs] == [str(e) for e in jm.target_exprs]
    assert str(pm.having) == str(jm.having)


def test_streamable_aggregates_are_the_references():
    assert {k.value for k in PA.STREAMABLE_AGGS} == \
        {k.value for k in JPA.STREAMABLE_AGGS}
