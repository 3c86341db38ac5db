"""The port's sharded execution in one process on the CPU against the JAX
package: `Config(num_shards=8)` runs each decomposable aggregate, top-k and
join over the shards' row blocks (a leaf a shard, then the merge), and
every other Compound gathered, and gives the reference's rows
(`connect(config=Config(num_shards=8))` on the conftest's 8-device CPU
mesh; floats rounded to 8 places as tests/test_distributed.py's `_canon`
does, in order under ORDER BY).  Each query's recorded mode
(`executor.shard_runs`) is asserted.  Beside the 8 virtual shards of the
CPU (every block a view of the column) runs a mesh of 4 distinct CPU
devices (`cpu`, `cpu:1`..`cpu:3`): each block resident as its own copy,
one host thread a device, the build sides replicated, as on distinct
cards.  Also: rows fewer than shards, blocks across small fragments and
the fragment skipping of a block, NULL and NaN in sums and MIN / MAX, each
group-by tier, shards streaming their own waves (past the threshold, and
past a device's stubbed free memory), an interrupt raised in a shard
thread, UPDATE, DELETE and a rollback after a sharded scan, RESTORE and
REFRESH, the counts the shard threads share, and the 360 generated queries
of tests/test_oracle_fuzz.py on both meshes against SQLite (as
tests/test_torch_oracle_fuzz.py runs them unsharded)."""

import sys
import threading

import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu_torch.config import Config as TConfig
from heavydb_tpu_torch.errors import QueryInterrupted
from heavydb_tpu_torch.exec import executor as X
from heavydb_tpu_torch.parallel.mesh import Mesh, shard_blocks

S = 8
THREADS_MESH = [torch.device("cpu")] + [torch.device("cpu", i) for i in range(1, 4)]

QUERIES = [  # tests/test_distributed.py's, with the mode each runs in
    ("SELECT count(*), sum(x), min(v), max(v) FROM t", "aggregate"),
    ("SELECT count(*) FROM t WHERE x > 0 AND v < 1.0", "aggregate"),
    ("SELECT k, count(*), sum(x), avg(v) FROM t GROUP BY k ORDER BY k", "aggregate"),
    ("SELECT k, count(DISTINCT x) FROM t GROUP BY k ORDER BY k", "gathered"),
    ("SELECT x % 7, count(*) FROM t WHERE x IS NOT NULL GROUP BY 1 ORDER BY 1", "aggregate"),
    ("SELECT d.name, count(*) FROM t JOIN d ON t.k = d.k GROUP BY d.name ORDER BY d.name",
     "join"),
    ("SELECT k, v FROM t ORDER BY v DESC, k LIMIT 20", "topk"),
    ("SELECT DISTINCT k FROM t ORDER BY k", "gathered"),
]


def _canon(rows):
    """tests/test_distributed.py's: floats rounded to 8 decimals."""
    return [tuple(round(v, 8) if isinstance(v, float) else v for v in r) for r in rows]


def _same(got, want, ordered, f32_cols=()):
    """Equal after `_canon`, in order if `ordered`; the columns f32_cols (FLOAT
    sums and averages: float32 adds in another order) within rtol 1e-4 /
    atol 1e-3, as chip_smoke.py holds FLOAT sums, then left out."""
    if f32_cols:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for i in f32_cols:
                assert (g[i] is None) == (w[i] is None)
                if w[i] is not None:
                    assert g[i] == pytest.approx(w[i], rel=1e-4, abs=1e-3)
        keep = lambda rows: [tuple(v for i, v in enumerate(r) if i not in f32_cols)  # noqa: E731
                             for r in rows]
        got, want = keep(got), keep(want)
    got, want = _canon(got), _canon(want)
    if ordered:
        assert got == want
    else:
        assert sorted(map(repr, got)) == sorted(map(repr, want))


def _threads(db):
    """db on a mesh of four distinct CPU devices."""
    db.executor.mesh = Mesh(THREADS_MESH)
    return db


def _modes(db):
    return [(r.mode, r.kind) for r in db.executor.shard_runs]


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 50, n),
            "x": np.where(rng.random(n) < 0.1, np.nan, rng.integers(-100, 100, n)),
            "v": rng.normal(size=n)}


def _load(db, data, frag=None):
    with_ = f" WITH (fragment_size={frag})" if frag else ""
    db.sql(f"CREATE TABLE t (k INT, x INT, v DOUBLE){with_}")
    db.load_table("t", data)
    db.sql("CREATE TABLE d (k INT, name TEXT)")
    db.sql("INSERT INTO d VALUES (1,'one'),(2,'two'),(3,'three'),(4,'four')")
    return db


@pytest.fixture(scope="module")
def dbs():
    """(reference 8-shard, port 8-shard, port on 4 distinct devices): the same
    10,000 rows, the last in fragments of 700 rows, so that blocks of 2500
    rows cross fragments."""
    data = _data(10_000, 2020)
    return (_load(hdt.connect(config=JConfig(num_shards=S)), data),
            _load(hdt_torch.connect(config=TConfig(num_shards=S), device="cpu"), data),
            _threads(_load(hdt_torch.connect(device="cpu"), data, frag=700)))


@pytest.mark.parametrize("sql,kind", QUERIES, ids=[q[:40] for q, _ in QUERIES])
def test_queries_shard_as_the_reference(dbs, sql, kind):
    ref, views, threads = dbs
    want = ref.sql(sql).rows()
    for db, shards in ((views, S), (threads, 4)):
        _same(db.sql(sql).rows(), want, "ORDER BY" in sql)
        runs = db.executor.shard_runs
        if kind == "gathered":
            assert _modes(db) == [("gathered", "compound")]
        else:
            assert _modes(db) == [("sharded", kind)]
            assert runs[0].shards == shards and len(runs[0].tiers) == shards


def test_blocks_are_views_or_resident_copies(dbs):
    """On the 8 virtual shards a block is a view of the cached column (no
    block entries); on distinct devices each block is cached under its range
    and device, and a gathered node copies them to the first device."""
    _, views, threads = dbs
    views.sql("SELECT count(*), sum(x) FROM t").rows()
    assert not any(X._is_block_key(k) for k, _ in views.executor.scan_cache.items())
    threads.sql("SELECT count(*), sum(x) FROM t").rows()
    t = threads.catalog.get_table("t")
    blocks = shard_blocks(threads.executor.mesh, t.num_rows)
    assert [(b.lo, b.hi) for b in blocks] == [(0, 2500), (2500, 5000), (5000, 7500),
                                              (7500, 10_000)]
    x = t.column_by_name("x").col_id
    keys = {k for k, _ in threads.executor.scan_cache.items() if X._is_block_key(k)}
    assert {X._block_key(t, x, b.lo, b.hi, b.device) for b in blocks} <= keys
    full = (t.table_id, t.generation, x, 10_240, None)
    assert threads.executor.scan_cache.get(full) is None
    threads.sql("SELECT DISTINCT x FROM t").rows()  # gathered from the blocks
    assert threads.executor.scan_cache.get(full) is None


def _both_small(rows, extra=None):
    """(reference, port) over `rows` rows of `t` and `d`, 8 shards."""
    data = _data(rows, 7)
    cfg = dict(num_shards=S, **(extra or {}))
    return (_load(hdt.connect(config=JConfig(**cfg)), data),
            _load(hdt_torch.connect(config=TConfig(**cfg), device="cpu"), data))


SMALL = [
    "SELECT count(*), sum(x), min(v), max(v), avg(v) FROM t",
    "SELECT k, count(*), sum(x) FROM t GROUP BY k ORDER BY k",
    "SELECT k, v FROM t ORDER BY v DESC LIMIT 5",
    "SELECT d.name, count(*) FROM t JOIN d ON t.k = d.k GROUP BY d.name ORDER BY d.name",
]


@pytest.mark.parametrize("rows", [3, 0])
def test_rows_fewer_than_shards(rows):
    """3 rows: blocks of one row on three shards, five empty blocks run no
    leaf; 0 rows: nothing to shard, the Compound runs gathered.  The join
    probes `d` (5 rows, the larger input): five shards of one row."""
    ref, port = _both_small(rows)
    port.sql("INSERT INTO d VALUES (1, 'uno')")
    ref.sql("INSERT INTO d VALUES (1, 'uno')")
    for q in SMALL:
        _same(port.sql(q).rows(), ref.sql(q).rows(), True)
        if rows == 0 and "LIMIT" in q:
            assert port.executor.shard_runs == []  # a Sort over an empty Scan
            continue
        run = port.executor.shard_runs[0]
        shards = 5 if "JOIN" in q else rows
        assert (run.mode, run.shards) == (("sharded", shards) if shards else ("gathered", 0))


def test_blocks_cross_fragments_and_skip(dbs):
    """Fragments of 700 rows under blocks of 1250: a block reads parts of
    three fragments; a filter whose chunk stats leave only the last
    fragments runs the shards whose blocks overlap them (the first block
    alone when none survives, for its keyless row).  Against the reference
    without shards; a filter that leaves no fragment raises in the
    reference with or without shards, so that query holds to its rows (no
    row: a count of 0, a NULL sum)."""
    rng = np.random.default_rng(11)
    n = 10_000
    data = {"s": np.arange(n), "v": rng.normal(size=n), "g": rng.integers(0, 9, n)}
    dbs_ = []
    for db in (hdt.connect(),
               hdt_torch.connect(config=TConfig(num_shards=S), device="cpu"),
               _threads(hdt_torch.connect(device="cpu"))):
        db.sql("CREATE TABLE f (s BIGINT, v DOUBLE, g INT) WITH (fragment_size=700)")
        db.load_table("f", data)
        dbs_.append(db)
    ref, views, threads = dbs_
    for q, shards in (("SELECT count(*), sum(v), min(s), max(s) FROM f WHERE s >= 8000",
                       (2, 1)),
                      ("SELECT g, count(*), sum(v) FROM f WHERE s < 4000 OR g = 3 "
                       "GROUP BY g ORDER BY g", (S, 4)),
                      ("SELECT count(*), sum(v) FROM f WHERE s < 0", (1, 1)),
                      ("SELECT s, v FROM f WHERE s >= 9000 ORDER BY v LIMIT 3", (2, 1))):
        want = [(0, None)] if "s < 0" in q else ref.sql(q).rows()
        for db, sh in zip((views, threads), shards):
            _same(db.sql(q).rows(), want, True)
            assert db.executor.shard_runs[0].shards == sh, q


def test_nulls_and_nan_in_sums_and_minmax():
    """FLOAT and DOUBLE columns with NaN loaded and NULL inserted, an INT with
    NULLs; a group NULL on some shards and valued on others, and a group
    NULL everywhere: the merge keeps NULL partials out of MIN / MAX / SUM."""
    rng = np.random.default_rng(5)
    n = 4_000
    g = rng.integers(0, 6, n)
    f = rng.normal(size=n).astype(np.float32)
    d = rng.normal(size=n)
    i = rng.integers(-50, 50, n).astype(float)
    f[(g == 1) & (np.arange(n) < n // 2)] = np.nan   # NULL on the first shards
    d[g == 2] = np.nan                                 # NULL everywhere
    i[rng.random(n) < 0.3] = np.nan
    data = {"g": g, "f": f, "d": d, "i": i}
    qs = ["SELECT g, count(*), count(f), sum(f), min(f), max(f), sum(d), min(d), max(d), "
          "avg(d), sum(i), min(i), max(i) FROM nn GROUP BY g ORDER BY g",
          "SELECT count(d), sum(d), min(f), max(i), avg(f) FROM nn",
          "SELECT g, min(d), max(d) FROM nn WHERE g = 2 GROUP BY g"]
    out = []
    for db in (hdt.connect(config=JConfig(num_shards=S)),
               hdt_torch.connect(config=TConfig(num_shards=S), device="cpu")):
        db.sql("CREATE TABLE nn (g INT, f FLOAT, d DOUBLE, i INT)")
        db.load_table("nn", data)
        db.sql("INSERT INTO nn VALUES (5, NULL, NULL, NULL), (6, NULL, 1.5, NULL)")
        out.append([db.sql(q).rows() for q in qs])
    for got, want, f32 in zip(out[1], out[0], ((3,), (4,), ())):
        _same(got, want, True, f32)


TIERS = [  # (query, the leaves' tier, the merge's)
    ("SELECT count(*), sum(a) FROM tt", "keyless", "keyless"),
    ("SELECT small, count(*), sum(a) FROM tt GROUP BY small ORDER BY small", "perfect",
     "perfect"),
    ("SELECT mid, count(*), sum(a), min(a) FROM tt GROUP BY mid ORDER BY mid", "radix",
     "radix"),
    ("SELECT big, count(*), sum(a) FROM tt GROUP BY big ORDER BY big", "sort", "sort"),
    ("SELECT wide, count(*), sum(a) FROM tt GROUP BY wide ORDER BY wide", "hash", "sort"),
]


def test_each_tier_shards():
    """The tier `_plan_compound` picks for a block's rows, on each leaf: keyless,
    perfect, radix (past 256 slots here), sort (40 keys spread over 2^40)
    and hash (5,000 keys over 2^40, the hash group-by on); the merge takes
    the tier of the keys' ranges (none for spread keys: sort)."""
    rng = np.random.default_rng(9)
    n = 20_000
    spread = rng.integers(0, 1 << 40, 5_000)
    data = {"a": rng.integers(-1000, 1000, n), "small": rng.integers(0, 50, n),
            "mid": rng.integers(0, 4_000, n), "big": spread[rng.integers(0, 40, n)],
            "wide": spread[rng.integers(0, 5_000, n)]}
    cfg = dict(num_shards=S, sortagg_min_slots=256, enable_hash_groupby=True)
    dbs_ = []
    for db in (hdt.connect(config=JConfig(**cfg)),
               hdt_torch.connect(config=TConfig(**cfg), device="cpu")):
        db.sql("CREATE TABLE tt (a INT, small INT, mid INT, big BIGINT, wide BIGINT)")
        db.load_table("tt", data)
        dbs_.append(db)
    ref, port = dbs_
    for q, tier, merge in TIERS:
        _same(port.sql(q).rows(), ref.sql(q).rows(), True)
        (run,) = port.executor.shard_runs
        assert (run.mode, set(run.tiers), run.merge_tier) == ("sharded", {tier}, merge), q


def test_shards_stream_their_waves(dbs, monkeypatch):
    """Past the stream threshold each shard runs its block in waves (row
    ranges of it: views of the column, or of the block resident on its
    device since the first, unstreamed run), aggregate and top-k alike;
    past a device's free memory (stubbed) too, each wave then uploaded for
    its run."""
    ref, _, _ = dbs
    data = _data(10_000, 2020)
    big = _data(200_000, 21)
    q = "SELECT k, count(*), sum(v), min(x), avg(x) FROM t GROUP BY k ORDER BY k"
    topk = "SELECT k, v FROM t WHERE k > 3 ORDER BY v DESC LIMIT 7"
    for mesh in (None, THREADS_MESH):
        db = _load(hdt_torch.connect(config=TConfig(num_shards=S), device="cpu"), data)
        if mesh:
            db.executor.mesh = Mesh(mesh)
        ex = db.executor
        _same(db.sql(q).rows(), ref.sql(q).rows(), True)
        assert ex.shard_runs[0].leaf_runs == ex.shard_runs[0].shards
        ex.config = ex.config.clone(stream_threshold_bytes=10_000)
        for sql in (q, topk):
            w0 = ex.waves_run
            _same(db.sql(sql).rows(), ref.sql(sql).rows(), True)
            (run,) = ex.shard_runs
            assert run.mode == "sharded" and run.leaf_runs > run.shards
            assert ex.waves_run - w0 == run.leaf_runs
        assert ex.last_stream is not None and ex.last_stream.waves > 1
    # 25,000 rows a shard x ~50 B of columns and tier do not fit 400 kB
    db = _load(hdt_torch.connect(config=TConfig(num_shards=S), device="cpu"), big)
    monkeypatch.setattr(X, "free_device_bytes", lambda device, need=0: 400_000)
    want = _load(hdt.connect(), big).sql(q).rows()
    _same(db.sql(q).rows(), want, True)
    assert db.executor.last_stream.by_memory and db.executor.shard_runs[0].leaf_runs > S
    assert not db.executor.scan_cache.items()  # each wave uploaded for its run


def test_interrupt_in_a_shard(dbs):
    """An interrupt raised by the hook inside a shard's thread stops the
    query (the other shards stop at their next checkpoint), and the next
    query runs; on the virtual shards, after the first shard's leaf."""
    ref, views, threads = dbs
    q = "SELECT k, count(*), sum(v) FROM t GROUP BY k ORDER BY k"
    main = threading.current_thread()
    for db in (threads, views):
        ex = db.executor
        seen = []

        def hook():
            seen.append(threading.current_thread())
            return db is threads and seen[-1] is not main or len(seen) > 4

        ex.interrupt_check = hook
        try:
            with pytest.raises(QueryInterrupted):
                db.sql(q)
        finally:
            ex.interrupt_check = None
        assert any(t is not main for t in seen) == (db is threads)
        _same(db.sql(q).rows(), ref.sql(q).rows(), True)


def _dml(db, path_db=None):
    qs = ["SELECT k, count(*), sum(x), min(v), max(v) FROM m GROUP BY k ORDER BY k",
          "SELECT count(*), sum(x) FROM m", "SELECT k, x, v FROM m ORDER BY v LIMIT 4"]
    return [db.sql(q).rows() for q in qs]


@pytest.mark.parametrize("mesh", ["views", "threads"])
def test_dml_after_a_sharded_scan(tmp_path, mesh):
    """UPDATE, DELETE and a rollback (set_table_epoch) on a database on disk,
    each after a sharded query and followed by one: the reference's rows,
    and no row block of an old generation left on any device."""
    data = _data(3_000, 13)
    out = {}
    for name, pkg, Config in (("ref", hdt, JConfig), ("port", hdt_torch, TConfig)):
        kw = {"device": "cpu"} if pkg is hdt_torch else {}
        db = pkg.connect(str(tmp_path / name), config=Config(num_shards=S), **kw)
        if pkg is hdt_torch and mesh == "threads":
            _threads(db)
        db.sql("CREATE TABLE m (k INT, x INT, v DOUBLE) WITH (fragment_size=700)")
        db.load_table("m", data)
        db.checkpoint()
        steps = [_dml(db)]
        epoch = db.get_table_epoch("m")
        for stmt in ("UPDATE m SET x = x + 1000, v = v * 2 WHERE k < 5",
                     "DELETE FROM m WHERE k >= 40 OR x < -90", None):
            if stmt is None:
                db.set_table_epoch("m", epoch)
            else:
                db.sql(stmt)
            if pkg is hdt_torch:
                gen = db.catalog.get_table("m").generation
                assert all(k[1] == gen for k, _ in db.executor.scan_cache.items()
                           if X._is_block_key(k))
            steps.append(_dml(db))
            if pkg is hdt_torch:
                assert [r.mode for r in db.executor.shard_runs] == ["sharded"], stmt
        out[name] = steps
    for got, want in zip(out["port"], out["ref"]):
        for g, w in zip(got, want):
            _same(g, w, True)


def test_mesh_must_start_on_the_databases_device():
    db = hdt_torch.connect(device="cpu")
    with pytest.raises(ValueError, match="first device"):
        db.executor.mesh = Mesh([torch.device("cpu", 1), torch.device("cpu")])
    db.executor.mesh = Mesh(THREADS_MESH)
    db.executor.mesh = None
    assert db.executor.mesh is None


def test_restore_and_refresh_leave_no_block(tmp_path):
    """On distinct devices, RESTORE over a table and REFRESH of a foreign table
    drop every row block of the old table or generation from every device;
    the next sharded query reads the new rows."""
    db = _threads(hdt_torch.connect(str(tmp_path / "db"), device="cpu"))
    ex = db.executor

    def blocks():
        return [k for k, _ in ex.scan_cache.items() if X._is_block_key(k)]

    db.sql("CREATE TABLE r (x INT, g INT)")
    db.sql("INSERT INTO r VALUES " + ", ".join(f"({i}, {i % 3})" for i in range(12)))
    dump = str(tmp_path / "r.tgz")
    db.sql(f"DUMP TABLE r TO '{dump}'")
    db.sql("INSERT INTO r VALUES (100, 0)")
    assert db.sql("SELECT COUNT(*), SUM(x) FROM r").rows() == [(13, 166)]
    old = db.catalog.get_table("r").table_id
    assert {k[0] for k in blocks()} == {old}
    db.sql(f"RESTORE TABLE r FROM '{dump}'")
    assert not any(k[0] == old for k in blocks())
    assert db.sql("SELECT g, COUNT(*), SUM(x) FROM r GROUP BY g ORDER BY g").rows() == \
        [(0, 4, 18), (1, 4, 22), (2, 4, 26)]
    assert ex.shard_runs[0].mode == "sharded"

    csv = tmp_path / "f.csv"
    csv.write_text("x,g\n" + "".join(f"{i},{i % 2}\n" for i in range(8)))
    db.sql(f"CREATE FOREIGN TABLE fr (x INT, g INT) SERVER default_local_delimited "
           f"WITH (file_path = '{csv}')")
    assert db.sql("SELECT COUNT(*), SUM(x) FROM fr").rows() == [(8, 28)]
    ft = db.catalog.get_table("fr")
    gen = ft.generation
    assert any(k[0] == ft.table_id and k[1] == gen for k in blocks())
    csv.write_text("x,g\n5,1\n6,0\n7,1\n")
    db.sql("REFRESH FOREIGN TABLES fr")
    assert not any(k[0] == ft.table_id and k[1] == gen for k in blocks())
    assert db.sql("SELECT COUNT(*), SUM(x) FROM fr").rows() == [(3, 18)]
    assert ex.shard_runs[0].mode == "sharded"


def test_counts_from_many_threads():
    """The state shard threads share, under a switch interval of 1 us: the
    kernels' launch counts (`_build.count_launch`, 16 threads x 2000), and
    the waves of 16 shard threads (more threads than a small host has cores)
    added to the caller's `waves_run`, none lost."""
    from heavydb_tpu_torch.kernels import _build

    class Counter:
        launches = 0

    def launch():
        for _ in range(2000):
            _build.count_launch(Counter)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert Counter.launches == 16 * 2000
        db = _load(hdt_torch.connect(config=TConfig(stream_threshold_bytes=400),
                                     device="cpu"), _data(4_000, 3))
        db.executor.mesh = Mesh([torch.device("cpu")]
                                + [torch.device("cpu", i) for i in range(1, 16)])
        w0 = db.executor.waves_run
        assert db.sql("SELECT count(*), sum(k) FROM t").rows()[0][0] == 4_000
        (run,) = db.executor.shard_runs
        assert run.shards == 16 and run.leaf_runs > 16
        assert db.executor.waves_run - w0 == run.leaf_runs
    finally:
        sys.setswitchinterval(old)


@pytest.fixture(scope="module")
def fuzz_oracles():
    """tests/test_torch_oracle_fuzz.py's two tables (the same seed and
    columns) in an Oracle over the 8 virtual shards and one over the 4
    distinct CPU devices."""
    from tests.test_sqlite_oracle import Oracle

    out = []
    for db in (hdt_torch.connect(config=TConfig(num_shards=S), device="cpu"),
               _threads(hdt_torch.connect(device="cpu"))):
        rng = np.random.default_rng(20260817)
        o = Oracle(db)
        n = 1200
        x = [int(v) if i % 11 else None for i, v in enumerate(rng.integers(-50, 50, n))]
        y = [float(round(v, 3)) if i % 7 else None for i, v in enumerate(rng.normal(0, 100, n))]
        s = [None if i % 13 == 0 else ["red", "green", "blue", "amber", "plum"][v]
             for i, v in enumerate(rng.integers(0, 5, n))]
        s2 = [None if i % 17 == 0 else ["ash", "oak", "elm", "fir"][v]
              for i, v in enumerate(rng.integers(0, 4, n))]
        k = [int(v) for v in rng.integers(0, 20, n)]
        big = [int(v) for v in rng.integers(-(2**40), 2**40, n)]
        o.load("f1", {"x": x, "y": y, "s": s, "s2": s2, "k": k, "big": big},
               {"x": "INT", "y": "DOUBLE", "s": "TEXT", "s2": "TEXT", "k": "INT",
                "big": "BIGINT"})
        m = 200
        o.load("f2", {"k": [int(v) for v in rng.integers(0, 25, m)],
                      "w": [float(round(v, 2)) for v in rng.uniform(0, 10, m)],
                      "tag": [["red", "green", "cyan"][v] for v in rng.integers(0, 3, m)]},
               {"k": "INT", "w": "DOUBLE", "tag": "TEXT"})
        out.append(o)
    return out


@pytest.mark.parametrize("batch", range(12))
def test_oracle_fuzz_on_shards(fuzz_oracles, batch):
    from tests.test_oracle_fuzz import N_QUERIES, Gen

    gen = Gen(9000 + batch)
    sharded = 0
    for qi in range(N_QUERIES // 12):
        q = gen.query()
        for o in fuzz_oracles:
            try:
                o.check(q)
            except Exception as e:
                raise AssertionError(f"seed={9000 + batch} #{qi} on {o.db.executor.mesh}: "
                                     f"{q}\n{type(e).__name__}: {e}") from None
            sharded += sum(r.mode == "sharded" for r in o.db.executor.shard_runs)
    assert sharded > 0
