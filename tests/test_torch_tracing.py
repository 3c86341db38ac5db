"""The port's scopes (utils/timer.py): the per-query tree that
`Config(enable_debug_timer=True)` builds, and the `hdb:` torch.profiler
ranges that each scope opens while the profiler records, on the CPU."""

import threading

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import heavydb_tpu_torch as hdt
from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.exec import expr_compiler
from heavydb_tpu_torch.utils import timer as TM

JOIN = "SELECT d.nm, COUNT(*), SUM(f.v) FROM f JOIN d ON f.k = d.k GROUP BY d.nm"
# dupd's key range is as wide as its rows, so the planner guesses a unique
# build; its duplicate keys undo the guess inside the run: no retry
DUP = "SELECT d.nm, COUNT(*) FROM f JOIN dupd d ON f.k = d.k GROUP BY d.nm"
# three rows a key of fan: 3 x 2000 pairs, past the level's first cap of
# bucket(2000): one retry (`join_cap`)
FANOUT = "SELECT f.g, COUNT(*) FROM f JOIN fan m ON f.k = m.k GROUP BY f.g"


def _db(timer=True):
    rng = np.random.default_rng(3)
    db = hdt.connect(device="cpu", config=Config(enable_debug_timer=timer))
    n = 2000
    db.load_table("f", {"k": rng.integers(0, 200, n).astype(np.int32),
                        "g": rng.integers(0, 5, n).astype(np.int32),
                        "v": rng.random(n)}, create=True)
    db.load_table("d", {"k": np.arange(8, dtype=np.int32),
                        "nm": np.arange(8, dtype=np.int32) % 3}, create=True)
    db.load_table("dupd", {"k": np.array([0, 1, 2, 2, 3, 5, 5, 7], np.int32),
                           "nm": np.arange(8, dtype=np.int32)}, create=True)
    db.load_table("fan", {"k": np.repeat(np.arange(200, dtype=np.int32), 3)}, create=True)
    return db


def _nodes(tree):
    yield tree
    for c in tree.get("children", ()):
        yield from _nodes(c)


def _compound(tree):
    return next(n for n in _nodes(tree) if n["name"].startswith("Compound#"))


def _ranges(prof):
    return [e.name for e in prof.events() if e.name.startswith(TM.PREFIX)]


def test_select_tree_reads_every_top_scope():
    db = _db()
    rs = db.sql("SELECT g, COUNT(*) FROM f WHERE v > 0.5 GROUP BY g ORDER BY g")
    names = [c["name"] for c in db.last_query_timings["children"]]
    assert names == ["parse", "plan", "execute", "fetch"]
    rs.column_raw(0)
    tree = db.last_query_timings
    assert [c["name"] for c in tree["children"]] == \
        ["parse", "plan", "execute", "fetch", "egress"]
    assert tree["h2d_bytes"] >= 0 and tree["waves_run"] == 0
    assert all(c["ms"] >= 0 for c in tree["children"])


def test_join_node_holds_build_probe_and_tier():
    db = _db()
    db.sql(JOIN).rows()
    node = _compound(db.last_query_timings)
    assert node["tier"] == "perfect" and node["retries"] == 0
    join = next(c for c in node["children"] if c["name"] == "join#0")
    kids = [c["name"] for c in join["children"]]
    assert kids[0] == "build" and "probe" in kids


def test_capacity_retry_is_a_scope_and_a_range():
    db = _db()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        db.sql(FANOUT).rows()
    node = _compound(db.last_query_timings)
    assert node["retries"] == 1
    (retry,) = [c for c in node["children"] if c["name"] == "retry"]
    assert retry["cause"] == ["join_cap"]
    assert _ranges(prof).count(TM.PREFIX + "retry") == 1
    assert db.executor.join_runs[0].retries == 1
    # a size the run reads and uses is a `size_read` scope and range, and
    # no retry
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        db.sql(DUP).rows()
    node = _compound(db.last_query_timings)
    assert node["retries"] == 0 and node["sized_in_run"] == ["join_dup#0"]
    names = [n["name"] for n in _nodes(node)]
    assert names.count("size_read") == 1 and "retry" not in names
    assert _ranges(prof).count(TM.PREFIX + "size_read") == 1
    assert TM.PREFIX + "retry" not in _ranges(prof)


def test_kernel_builds_only_for_a_new_program():
    db = _db()
    db.sql("SELECT COUNT(*) FROM f WHERE g > 1").rows()
    assert _compound(db.last_query_timings)["kernel_built"]
    builds = db.executor.kernel_builds
    db.sql("SELECT COUNT(*) FROM f WHERE g > 1").rows()
    tree = db.last_query_timings
    assert not _compound(tree)["kernel_built"] and tree["kernel_builds"] == 0
    assert "kernel_build" not in [n["name"] for n in _nodes(tree)]
    assert db.executor.kernel_builds == builds
    # a new constant is a new program
    db.sql("SELECT COUNT(*) FROM f WHERE g > 2").rows()
    tree = db.last_query_timings
    assert _compound(tree)["kernel_built"] and tree["kernel_builds"] == 1
    assert db.executor.kernel_builds == builds + 1


def test_threads_read_their_own_timings():
    db = _db()
    queries = {0: "SELECT COUNT(*) FROM f WHERE g = 0",
               1: "SELECT SUM(v) FROM f WHERE g = 1"}
    ready = threading.Barrier(2)
    got = {}

    def client(i):
        rs = db.sql(queries[i])
        rs.rows()
        ready.wait()  # both queries ran before either reads
        got[i] = (db.last_query_timings, rs.timings())

    threads = [threading.Thread(target=client, args=(i,)) for i in queries]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert db.last_query_timings is None  # this thread ran no SELECT
    for i in queries:
        tree, own = got[i]
        # the thread's tree is its own result's, egress included
        assert tree == own
        assert [c["name"] for c in tree["children"]][-1] == "egress"
    assert got[0][0] != got[1][0]


def test_null_timer_is_a_shared_noop_without_profiler(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert TM.NULL_TIMER.scope("parse") is TM.NOOP
    assert TM.NullTimer().scope("execute") is TM.NOOP
    # and opens no range: the ray cast runs with record_function broken

    def broken(name):
        raise AssertionError(f"opened {name} with no profiler recording")

    monkeypatch.setattr(TM, "record_function", broken)
    off = torch.tensor([0], dtype=torch.int32)
    cnt = torch.tensor([4], dtype=torch.int32)
    sq = (torch.tensor([0., 1., 1., 0.], dtype=torch.float64),
          torch.tensor([0., 0., 1., 1.], dtype=torch.float64),
          torch.tensor([1., 1., 0., 0.], dtype=torch.float64),
          torch.tensor([0., 1., 1., 0.], dtype=torch.float64))
    px = torch.tensor([0.5], dtype=torch.float64)
    assert expr_compiler.ray_cast(off, cnt, px, px, sq, 4).tolist() == [1]
    db = _db(timer=False)
    assert db.sql(JOIN).rows()
    assert db.last_query_timings is None


def test_ranges_without_the_debug_timer():
    """With the debug timer off each scope is still a profiler range, and
    no range takes the benchmark's `pb:` prefix."""
    db = _db(timer=False)
    db.sql(JOIN).rows()
    db.sql_device("SELECT COUNT(*) FROM f")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        db.sql(JOIN).rows()
        db.sql_device("SELECT COUNT(*) FROM f")
    names = set(_ranges(prof))
    for scope in ("parse", "query", "plan", "execute", "fetch", "egress", "join#0",
                  "build", "probe", "control_read"):
        assert TM.PREFIX + scope in names, scope
    assert TM.PREFIX + "kernel_build" not in names
    assert not [e.name for e in prof.events() if e.name.startswith("pb:")]


def test_ray_cast_range_while_profiling():
    off = torch.tensor([0], dtype=torch.int32)
    cnt = torch.tensor([1], dtype=torch.int32)
    seg = tuple(torch.tensor([v], dtype=torch.float64) for v in (1., 0., 1., 1.))
    px = torch.tensor([0.5], dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        expr_compiler.ray_cast(off, cnt, px, px, seg, 1)
    assert TM.PREFIX + "contains_seg_ray_cast" in _ranges(prof)


def test_query_timer_scope_node_and_range():
    t = TM.QueryTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.scope("query"):
            with t.scope("retry") as node:
                t.note(n=1)
        # a scope after the root closed joins the root
        with t.scope("egress"):
            pass
    assert node.name == "retry" and node.attrs == {"n": 1}
    tree = t.to_dict()
    assert [c["name"] for c in tree["children"]] == ["retry", "egress"]
    assert tree["children"][0]["n"] == 1
    assert _ranges(prof) == [TM.PREFIX + n for n in ("query", "retry", "egress")]
