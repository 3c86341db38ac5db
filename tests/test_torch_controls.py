"""Per-query controls of the port against the JAX package: EXPLAIN, the
debug timer, hints, the static and dynamic watchdogs, interrupts, ALTER
SESSION / SYSTEM SET and the resource manager's admission.

The cases of tests/test_observability.py and tests/test_resource_mgr.py,
each run through heavydb_tpu.connect() and heavydb_tpu_torch.connect(
device="cpu") on the same seeded numpy data: the same rows, the same
refusals (WatchdogException, QueryInterrupted, QueryTimedOut, SqlError) and
the same EXPLAIN / EXPLAIN CALCITE text.  EXPLAIN OPTIMIZED is a port
difference: after the plan the reference prints its root Compound's jaxpr,
the port the program it runs (tier, each aggregate's kernel route, join
builds, kernel-cache key).  Then the port's own: the faults F1 (the static
watchdog was not enforced) and F2 (hints were dropped, also through
sql_device), per-thread query state under six threads on one Database,
and an interrupt or a deadline in the middle of the fragment waves of a
streamed aggregate and of a streamed top-k, each raising within the wave
that follows, the next query equal to the reference's.

Tolerances: every value exact, but DOUBLE sums rtol 1e-9 and FLOAT sums
rtol 1e-4 (summation order).
"""

import dataclasses
import math
import sys
import threading
import time

import numpy as np
import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu.errors import QueryInterrupted as JQueryInterrupted
from heavydb_tpu.errors import SqlError as JSqlError
from heavydb_tpu.errors import WatchdogException as JWatchdogException
from heavydb_tpu.exec import resource_mgr as JRM
from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.errors import QueryInterrupted, SqlError, WatchdogException
from heavydb_tpu_torch.exec import resource_mgr as RM


def _pair(**kw):
    return hdt.connect(config=JConfig(**kw)), hdt_torch.connect(device="cpu",
                                                                config=Config(**kw))


def _both(dbs, *stmts):
    for db in dbs:
        for s in stmts:
            db.sql(s)


def _close(a, b, rel):
    if isinstance(b, float) and a is not None:
        if math.isnan(b):
            return isinstance(a, float) and math.isnan(a)
        return a == pytest.approx(b, rel=rel)
    return a == b


def _same(got, want, ordered=False, rel=1e-9):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want), (got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(a, b, rel) for a, b in zip(g, w)), (g, w)


def _check(dbs, sql, rel=1e-9):
    ref, port = dbs
    _same(port.sql(sql).rows(), ref.sql(sql).rows(), "ORDER BY" in sql.upper(), rel)


def _text(rs):
    return "\n".join(r[0] for r in rs.rows())


# ---------------------------------------------------------------------------
# tests/test_observability.py
# ---------------------------------------------------------------------------

def test_explain_kinds():
    dbs = _pair()
    _both(dbs, "CREATE TABLE t (x INT, s TEXT)", "INSERT INTO t VALUES (1, 'a')")
    ref, port = dbs
    q = "SELECT s, count(*) FROM t GROUP BY s"
    plan = _text(port.sql(f"EXPLAIN {q}"))
    assert "Compound" in plan and plan == _text(ref.sql(f"EXPLAIN {q}"))
    calcite = _text(port.sql(f"EXPLAIN CALCITE {q}"))
    assert "Aggregate" in calcite and "Scan" in calcite
    assert calcite == _text(ref.sql(f"EXPLAIN CALCITE {q}"))
    ir = _text(port.sql(f"EXPLAIN OPTIMIZED {q}"))
    ref_ir = _text(ref.sql(f"EXPLAIN OPTIMIZED {q}"))
    assert "jaxpr" in ref_ir and "lambda" in ref_ir
    # the port difference: the plan as the reference prints it, then the
    # Compound's program in place of the jaxpr
    head, program = ir.split("\n\n--- compound program")
    assert head == ref_ir.split("\n\n--- kernel jaxpr ---")[0] == plan
    # one dictionary entry: one slot, a masked reduction
    assert "group-by tier: perfect, cap 1" in program
    assert "aggregate 0 COUNT: plain torch (a masked reduction)" in program
    assert "kernel-cache key: (('Compound'" in program


@pytest.mark.parametrize("query, tier, routes", [
    # keyless: one masked reduction an aggregate
    ("SELECT COUNT(*), SUM(x) FROM r WHERE k10 > 3", "keyless",
     ["COUNT: plain torch (a masked reduction)", "SUM: plain torch (a masked reduction)"]),
    # 100 slots: the shared count / sum pass and MIN / MAX on B1
    ("SELECT k100, COUNT(*), SUM(v), MIN(x), MAX(v) FROM r GROUP BY k100", "perfect",
     ["COUNT: B1 (the shared pass)", "SUM: B1 (the shared pass)",
      "MIN: B1 + B1 (count)", "MAX: B1 + B1 (count)"]),
    # 1000 slots: B2 for the pass and the counts, B3 for MIN / MAX; an
    # 8-byte MAX scatters in plain torch
    ("SELECT k1k, MIN(x), MAX(v), AVG(v), MAX(b) FROM r GROUP BY k1k", "perfect",
     ["MIN: B3 + B2 (count)", "MAX: B3 + B2 (count)", "AVG: B2 (the shared pass)",
      "MAX: plain scatter + B2 (count)"]),
    # 10 slots: MIN's count scatters in plain torch, the pass is B1
    ("SELECT k10, MIN(x), COUNT(DISTINCT x) FROM r GROUP BY k10", "perfect",
     ["MIN: plain scatter + plain scatter (count)",
      "COUNT_DISTINCT: plain torch (distinct values, sketches)"]),
    # no dense range: the sort tier
    ("SELECT s, COUNT(*) FROM r GROUP BY s", "sort", ["COUNT: plain torch (sorted segments)"]),
])
def test_explain_optimized_routes(query, tier, routes):
    """EXPLAIN OPTIMIZED names each aggregate's route as ops/groupby.py
    takes it, and the rows of the query are the reference's."""
    rng = np.random.default_rng(7)
    n = 5000
    data = {"k10": rng.integers(1, 11, n).astype(np.int32),
            "k100": rng.integers(1, 101, n).astype(np.int32),
            "k1k": rng.integers(1, 1001, n).astype(np.int32),
            "x": rng.integers(-50, 50, n).astype(np.int32),
            "b": rng.integers(-2 ** 40, 2 ** 40, n),
            "v": rng.random(n).astype(np.float32),
            "s": rng.integers(0, 2 ** 40, n) * 7}
    dbs = _pair()
    for db in dbs:
        db.sql("CREATE TABLE r (k10 INT, k100 INT, k1k INT, x INT, b BIGINT, v FLOAT, "
               "s BIGINT)")
        db.load_table("r", data)
    program = _text(dbs[1].sql(f"EXPLAIN OPTIMIZED {query}")).split("--- compound program")[1]
    assert f"group-by tier: {tier}," in program
    got = [ln.split(" ", 2)[2] for ln in program.splitlines() if ln.startswith("aggregate ")]
    assert got == routes
    _check(dbs, query, rel=1e-4)


def test_explain_optimized_join_builds():
    """Each join level's build form and capacity, as the kernel picks it."""
    dbs = _pair()
    _both(dbs, "CREATE TABLE f (k INT, v DOUBLE)", "CREATE TABLE d (k INT, g INT)",
          "INSERT INTO d VALUES (1, 10), (2, 20), (3, 30)",
          "INSERT INTO f VALUES (1, 1.5), (2, 2.5), (2, 3.5), (5, 4.0)")
    q = "SELECT d.g, COUNT(*), SUM(f.v) FROM f JOIN d ON f.k = d.k GROUP BY d.g"
    program = _text(dbs[1].sql(f"EXPLAIN OPTIMIZED {q}"))
    assert "join level 1: INNER perfect-unique, cap 0" in program
    _check(dbs, q)


def test_debug_timer():
    """The JAX package's tree holds plan / execute / fetch; the port's
    starts with the text's parse and, once the result is read, ends with
    its egress to the host."""
    ref, port = _pair(enable_debug_timer=True)
    for db, want in ((ref, ["plan", "execute", "fetch"]),
                     (port, ["parse", "plan", "execute", "fetch", "egress"])):
        db.sql("CREATE TABLE t (x INT)")
        db.sql("INSERT INTO t VALUES (1), (2)")
        assert db.sql("SELECT sum(x) FROM t").scalar() == 3
        info = db.last_query_timings
        assert info["name"] == "query"
        names = [c["name"] for c in info["children"]]
        assert names == want
        ex = next(c for c in info["children"] if c["name"] == "execute")
        assert any("Compound" in c["name"] for c in ex["children"])


def test_hints_parsed():
    dbs = _pair()
    _both(dbs, "CREATE TABLE t (x INT)", "INSERT INTO t VALUES (1)")
    for db in dbs:
        assert db.sql("SELECT /*+ cpu_mode */ count(*) FROM t").scalar() == 1


def test_watchdog():
    """F1: the static watchdog refuses a projection over more rows than
    watchdog_max_projected_rows, allows an aggregate, and no_watchdog lifts
    it for one query (F2)."""
    dbs = _pair(enable_watchdog=True, watchdog_max_projected_rows=100)
    for db in dbs:
        db.sql("CREATE TABLE t (x INT)")
        db.load_table("t", {"x": np.arange(1000)})
    ref, port = dbs
    with pytest.raises(JWatchdogException) as jerr:
        ref.sql("SELECT x FROM t WHERE x > 1")
    with pytest.raises(WatchdogException) as err:
        port.sql("SELECT x FROM t WHERE x > 1")
    assert str(err.value) == str(jerr.value)
    _check(dbs, "SELECT count(*) FROM t")
    _check(dbs, "SELECT /*+ no_watchdog */ x FROM t LIMIT 5")
    _check(dbs, "SELECT /*+ no_watchdog */ x FROM t WHERE x > 1")


def test_interrupt():
    dbs = _pair()
    _both(dbs, "CREATE TABLE t (x INT)", "INSERT INTO t VALUES (1)")
    for db, exc in zip(dbs, (JQueryInterrupted, QueryInterrupted)):
        db.executor.interrupt_check = lambda: True
        with pytest.raises(exc):
            db.sql("SELECT count(*) FROM t")
        db.executor.interrupt_check = None
        assert db.sql("SELECT count(*) FROM t").scalar() == 1


def test_alter_session_set():
    for db, err in zip(_pair(), (JSqlError, SqlError)):
        rs = db.sql("ALTER SESSION SET enable_watchdog = true")
        assert rs.rows() == [("enable_watchdog = True",)]
        assert db.config.enable_watchdog is True
        db.sql("ALTER SYSTEM SET max_concurrent_queries = 2")
        assert db.executor.resource_mgr.max_concurrent == 2
        db.sql("ALTER SYSTEM SET max_exec_bytes = 4096")
        assert db.executor.resource_mgr.max_bytes == 4096
        db.sql("ALTER SYSTEM SET admission_queue_timeout_s = 2.5")
        assert db.executor.resource_mgr.queue_timeout_s == 2.5
        db.sql("ALTER SESSION SET watchdog_max_projected_rows = 1000")
        assert db.config.watchdog_max_projected_rows == 1000
        with pytest.raises(err) as e:
            db.sql("ALTER SESSION SET bogus_flag = 1")
        assert "bogus_flag" in str(e.value)


@pytest.mark.parametrize("name", sorted(hdt_torch.api.Database._SETTABLE))
def test_every_settable_name_is_a_field_alter_system_sets(name):
    """Each name ALTER SYSTEM SET takes is a Config field, and the statement
    sets it."""
    db = hdt_torch.connect(device="cpu")
    assert name in {f.name for f in dataclasses.fields(Config)}
    cur = getattr(db.config, name)
    new = (not cur) if isinstance(cur, bool) else cur + 1
    lit = str(new).lower() if isinstance(new, bool) else new
    assert db.sql(f"ALTER SYSTEM SET {name} = {lit}").rows() == [(f"{name} = {new}",)]
    assert getattr(db.config, name) == new


def test_dynamic_watchdog_time_limit():
    """A query_time_limit(ms) hint aborts the query at its next checkpoint
    (the streaming waves) and does not outlive it."""
    rng = np.random.default_rng(0)
    data = {"k": rng.integers(0, 50, 200_000).astype(np.int32),
            "v": rng.random(200_000).astype(np.float32)}
    dbs = _pair(stream_threshold_bytes=50_000, default_fragment_rows=30_000)
    for db, exc in zip(dbs, (JWatchdogException, WatchdogException)):
        db.load_table("wd", data, create=True)
        assert db.sql("SELECT count(*) FROM wd").rows()[0][0] == 200_000
        t0 = time.time()
        with pytest.raises(exc):
            db.sql("SELECT /*+ query_time_limit(1) */ k, sum(v), avg(v) "
                   "FROM wd GROUP BY k").rows()
        assert time.time() - t0 < 5.0
    _check(dbs, "SELECT count(*) FROM wd WHERE k < 10")
    _check(dbs, "SELECT k, sum(v), avg(v) FROM wd GROUP BY k", rel=1e-4)


def test_interrupt_mid_streamed_query():
    """A streamed query polls the interrupt hook between its waves: it
    trips mid-query, and the table answers again afterwards."""
    rng = np.random.default_rng(2)
    cols = {1: rng.integers(0, 100, 20_000).astype(np.int32),
            2: rng.random(20_000).astype(np.float32)}
    dbs = _pair()
    for db, exc in zip(dbs, (JQueryInterrupted, QueryInterrupted)):
        db.config.stream_threshold_bytes = 1 << 12  # many waves
        db.sql("CREATE TABLE big_s (k INT, v FLOAT) WITH (fragment_size=500)")
        db.catalog.get_table("big_s").insert_columns(dict(cols))
        calls = {"n": 0}

        def trip_after_three():
            calls["n"] += 1
            return calls["n"] > 3

        db.executor.interrupt_check = trip_after_three
        with pytest.raises(exc):
            db.sql("SELECT k, count(*), sum(v) FROM big_s GROUP BY k")
        assert calls["n"] > 3
        db.executor.interrupt_check = None
        assert len(db.sql("SELECT k, count(*) FROM big_s GROUP BY k").rows()) == 100
    _check(dbs, "SELECT k, count(*), sum(v) FROM big_s GROUP BY k", rel=1e-4)


# ---------------------------------------------------------------------------
# tests/test_resource_mgr.py, on the port's copy of exec/resource_mgr.py
# ---------------------------------------------------------------------------

def test_serializes_at_capacity():
    mgr = RM.ResourceMgr(max_concurrent=1, queue_timeout_s=10)
    order = []
    g1 = mgr.acquire(0)
    done = threading.Event()

    def second():
        with mgr.acquire(0):
            order.append("second-admitted")
        done.set()

    th = threading.Thread(target=second)
    th.start()
    time.sleep(0.1)
    assert not done.is_set()
    order.append("first-released")
    g1.__exit__(None, None, None)
    th.join(timeout=5)
    assert not th.is_alive()
    assert order == ["first-released", "second-admitted"]
    assert mgr.info()["total_admitted"] == 2


def test_queue_timeout():
    for mod in (JRM, RM):
        mgr = mod.ResourceMgr(max_concurrent=1, queue_timeout_s=0.1)
        with mgr.acquire(0):
            with pytest.raises(mod.QueryTimedOut) as e:
                mgr.acquire(0)
        assert "queued > 0.1s (1 running)" in str(e.value)
        assert mgr.info()["total_timed_out"] == 1


def test_byte_limit_admission():
    mgr = RM.ResourceMgr(max_concurrent=8, max_bytes=100, queue_timeout_s=0.1)
    with mgr.acquire(80):
        with pytest.raises(RM.QueryTimedOut):
            mgr.acquire(50)
        with mgr.acquire(20):
            assert mgr.info()["running_bytes"] == 100
    # a lone query over the limit still runs
    with mgr.acquire(500):
        pass
    assert mgr.info()["peak_concurrent"] == 2


def test_estimate_and_engine_integration(monkeypatch):
    """The port admits each query through its resource manager, releases
    the grant, and estimates the bytes the reference estimates; the
    group-by's NDV estimate is sampled once per table generation, not once
    a query."""
    from heavydb_tpu.plan.optimizer import optimize as joptimize
    from heavydb_tpu.sql.parser import parse as jparse
    from heavydb_tpu_torch.exec.executor import Executor
    from heavydb_tpu_torch.plan.optimizer import optimize
    from heavydb_tpu_torch.sql.parser import parse

    rng = np.random.default_rng(0)
    data = {"x": rng.integers(0, 10, 1000).astype(np.int32), "y": rng.random(1000)}
    dbs = _pair()
    for db in dbs:
        db.sql("CREATE TABLE r (x INT, y DOUBLE)")
        db.load_table("r", data)
    ref, port = dbs
    rm = port.executor.resource_mgr
    before = rm.info()["total_admitted"]
    _check(dbs, "SELECT COUNT(*) FROM r WHERE x > 5")
    info = rm.info()
    assert info["total_admitted"] == before + 1 and info["running"] == 0
    for q in ("SELECT x FROM r", "SELECT x, COUNT(*), SUM(y) FROM r GROUP BY x"):
        plan = optimize(port._plan_select(parse(q)))
        jplan = joptimize(ref._plan_select(jparse(q)))
        assert rm.estimate_scan_bytes(plan) == 1000 * (4 + 8)
        assert rm.estimate_scan_bytes(plan) == ref.executor.resource_mgr.estimate_scan_bytes(jplan)
        assert rm.estimate_output_bytes(plan, port.executor) == \
            ref.executor.resource_mgr.estimate_output_bytes(jplan, ref.executor)
    samples = []
    real = Executor._sample_ndv
    monkeypatch.setattr(Executor, "_sample_ndv",
                        staticmethod(lambda t, idxs: samples.append(idxs) or real(t, idxs)))
    q = "SELECT x, COUNT(*) FROM r GROUP BY x"
    for _ in range(3):
        port.sql(q).rows()
    assert samples == []  # the estimate above sampled this generation
    port.sql("INSERT INTO r VALUES (1, 0.5)")
    for _ in range(3):
        port.sql(q).rows()
    assert samples == [[0]]


def test_concurrent_queries_through_engine():
    dbs = _pair()
    for db in dbs:
        db.sql("CREATE TABLE c (x INT)")
        db.load_table("c", {"x": np.arange(100, dtype=np.int32)})
        db.sql("SELECT SUM(x) FROM c")
        results = []

        def run():
            results.append(db.sql("SELECT SUM(x) FROM c").scalar())

        threads = [threading.Thread(target=run) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert results == [4950] * 6
        assert db.executor.resource_mgr.info()["running"] == 0


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

def test_hints_reach_sql_device():
    """F2: sql_device honours its SELECT's hints as sql does: the watchdog
    hint turns the static watchdog on for one query, query_time_limit sets
    a deadline, and neither outlives its query."""
    dbs = _pair(watchdog_max_projected_rows=100)
    for db in dbs:
        db.sql("CREATE TABLE t (x INT)")
        db.load_table("t", {"x": np.arange(1000)})
    for db, exc in zip(dbs, (JWatchdogException, WatchdogException)):
        with pytest.raises(exc):
            db.sql_device("SELECT /*+ watchdog */ x FROM t WHERE x > 1")
        with pytest.raises(exc):
            db.sql("SELECT /*+ watchdog */ x FROM t WHERE x > 1")
        batch, decode = db.sql_device("SELECT x FROM t WHERE x > 1")
        assert decode().row_count == 998
        db.executor.interrupt_check = lambda: time.sleep(0.005) or False
        with pytest.raises(exc):
            db.sql_device("SELECT /*+ query_time_limit(1) */ COUNT(*) FROM t")
        db.executor.interrupt_check = None
        assert db.sql_device("SELECT COUNT(*) FROM t")[1]().scalar() == 1000


def test_per_thread_state_under_concurrency():
    """Six threads on one Database, each with its own hints, interrupt hook
    and records: a thread's no_watchdog never lifts another's watchdog, an
    interrupt hook stops only its own thread's query, each thread's
    join_runs describe its own last query, and every result is the
    reference's."""
    rng = np.random.default_rng(11)
    n = 4000
    data = {"k": rng.integers(1, 41, n).astype(np.int32),
            "v": rng.random(n), "x": rng.integers(0, 1000, n).astype(np.int32)}
    dim = {"k": np.arange(1, 41, dtype=np.int32), "g": (np.arange(40) % 7).astype(np.int32)}
    ref, port = _pair(enable_watchdog=True, watchdog_max_projected_rows=1000)
    for db in (ref, port):
        db.load_table("f", data, create=True)
        db.load_table("d", dim, create=True)
    queries = {
        "agg": "SELECT k, COUNT(*), SUM(v) FROM f GROUP BY k",
        "join": "SELECT d.g, COUNT(*) FROM f JOIN d ON f.k = d.k GROUP BY d.g",
        "lifted": "SELECT /*+ no_watchdog */ x FROM f WHERE x >= 0",
    }
    want = {name: sorted(ref.sql(q).rows()) for name, q in queries.items()}
    errors, out = [], {}
    barrier = threading.Barrier(6)

    def worker(i):
        try:
            barrier.wait(timeout=30)
            ex = port.executor
            for rep in range(4):
                name = ("agg", "join", "lifted")[(i + rep) % 3]
                got = sorted(port.sql(queries[name]).rows())
                joins = list(ex.join_runs)
                out.setdefault(name, []).append(got)
                assert (len(joins) == 1) == (name == "join"), (name, joins)
                if i % 2:
                    # only this thread's queries are interrupted
                    ex.interrupt_check = lambda: True
                    try:
                        port.sql(queries["agg"])
                        raise AssertionError("not interrupted")
                    except QueryInterrupted:
                        pass
                    ex.interrupt_check = None
                else:
                    try:
                        port.sql("SELECT x FROM f WHERE x >= 0")
                        raise AssertionError("the watchdog was lifted")
                    except WatchdogException:
                        pass
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append((i, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for name, runs in out.items():
        for got in runs:
            _same(got, want[name], ordered=True)
    assert port.executor.resource_mgr.info()["running"] == 0


def _stream_pair():
    rng = np.random.default_rng(5)
    n = 40_000
    cols = {"k": rng.integers(0, 64, n).astype(np.int32),
            "v": rng.random(n).astype(np.float32),
            "x": rng.permutation(n).astype(np.int32)}
    dbs = _pair(stream_threshold_bytes=1 << 14, default_fragment_rows=4096)
    for db in dbs:
        db.load_table("s", cols, create=True)
    return dbs


STREAMED = {
    "aggregate": "SELECT k, COUNT(*), SUM(v) FROM s GROUP BY k",
    "top-k": "SELECT x, v FROM s WHERE k < 60 ORDER BY x DESC LIMIT 10",
}


@pytest.mark.parametrize("shape", sorted(STREAMED))
def test_interrupt_in_the_waves(shape):
    """An interrupt raised by the hook once the first wave has run stops the
    query at the next wave's checkpoint: one wave ran, no more."""
    dbs = _stream_pair()
    ref, port = dbs
    ex = port.executor
    waves0 = ex.waves_run
    port.sql(STREAMED[shape]).rows()
    assert ex.waves_run - waves0 >= 3
    waves0 = ex.waves_run
    ex.interrupt_check = lambda: ex.waves_run > waves0
    with pytest.raises(QueryInterrupted):
        port.sql(STREAMED[shape])
    assert ex.waves_run == waves0 + 1
    ex.interrupt_check = None
    _check(dbs, STREAMED[shape], rel=1e-4)


@pytest.mark.parametrize("shape", sorted(STREAMED))
def test_deadline_in_the_waves(shape):
    """A deadline that passes during the first wave stops the query at the
    next wave's checkpoint, and the next query has none."""
    dbs = _stream_pair()
    ref, port = dbs
    ex = port.executor
    waves0 = ex.waves_run

    def slow_first_wave():
        if ex.waves_run == waves0 + 1:
            time.sleep(1.1)
        return False

    ex.interrupt_check = slow_first_wave
    q = STREAMED[shape].replace("SELECT", "SELECT /*+ query_time_limit(1000) */", 1)
    with pytest.raises(WatchdogException):
        port.sql(q)
    assert ex.waves_run == waves0 + 1
    ex.interrupt_check = None
    assert ex._deadline is not None
    _check(dbs, STREAMED[shape], rel=1e-4)
    assert ex._deadline is None
