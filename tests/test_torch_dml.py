"""UPDATE, DELETE, INSERT ... SELECT, CREATE TABLE AS SELECT and TRUNCATE
in the port against the JAX package: the same statements on the same
tables in heavydb_tpu.connect() and heavydb_tpu_torch.connect(device=
"cpu"), with the tables' contents (every row, in physical order) and the
follow-up queries compared after each statement.

The cases are the in-memory ones of tests/test_inplace_updel.py (the
persistence round trip waits for the port of storage), the DML of
tests/test_engine_basic.py, tests/test_sqlite_oracle.py,
tests/test_device_load.py and tests/test_none_encoded_text.py, and the
port's own guarantees: the device scan cache moves to the new generation
(no column is uploaded again after an UPDATE or a DELETE), a tensor given
to load_table_device is never written, the virtual rowid is made on the
device, and a mutation leaves no older generation in the cache.

Tolerances: every value exact, but DOUBLE sums rtol 1e-9.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.errors import NotSupported


def _pair(frag_rows=None):
    kw = {} if frag_rows is None else dict(default_fragment_rows=frag_rows)
    return hdt.connect(config=JConfig(**kw)), hdt_torch.connect(device="cpu",
                                                                config=Config(**kw))


def _both(dbs, *stmts):
    for db in dbs:
        for s in stmts:
            db.sql(s)


def _norm(v):
    return None if isinstance(v, float) and math.isnan(v) else v


def _close(a, b):
    if isinstance(b, float) and a is not None:
        return a == pytest.approx(b, rel=1e-9)
    return a == b


def _same(got, want, ordered=True):
    got = [tuple(_norm(v) for v in r) for r in got]
    want = [tuple(_norm(v) for v in r) for r in want]
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want), (got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w)), (g, w)


def _check(dbs, sql, ordered=None):
    ref, port = dbs
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same(got, want, "ORDER BY" in sql.upper() if ordered is None else ordered)
    return got


def _contents(dbs, table):
    """Every row of the table in physical order, and each fragment's row
    count, equal in both packages."""
    ref, port = dbs
    _check(dbs, f"SELECT rowid, * FROM {table} ORDER BY rowid")
    frags = [[f.num_rows for f in db.catalog.get_table(table).fragments]
             for db in (ref, port)]
    assert frags[0] == frags[1]


def _cached(db, t, gen=None):
    """(key -> tensor) of the port's scan cache for table t: full-table
    entries of generation gen (t's current one by default)."""
    gen = t.generation if gen is None else gen
    return {k: v for k, v in db.executor.scan_cache.items()
            if k[0] == t.table_id and k[1] == gen and k[4] is None}


def _stale(db, t):
    return [k for k, _ in db.executor.scan_cache.items()
            if k[0] == t.table_id and k[1] != t.generation]


# ---------------------------------------------------------------------------
# tests/test_inplace_updel.py (in-memory cases)
# ---------------------------------------------------------------------------

def _mk(nfrag=8, frag_rows=100):
    dbs = _pair(frag_rows)
    n = nfrag * frag_rows
    rows = ",".join(f"({i}, {i * 3}, 'name{i % 17}')" for i in range(n))
    _both(dbs, "CREATE TABLE t (id BIGINT, v BIGINT, s TEXT)", "INSERT INTO t VALUES " + rows)
    return dbs, n


def _chunk_ids(t):
    return {(f.fragment_id, cid): id(f.chunks[cid]) for f in t.fragments for cid in f.chunks}


def _changed(dbs, stmt):
    """Run stmt on both; the (fragment, column) chunks it replaced, the
    same in both."""
    out = []
    for db in dbs:
        t = db.catalog.get_table("t")
        before = _chunk_ids(t)
        db.sql(stmt)
        after = _chunk_ids(t)
        out.append({k for k in before if before[k] != after.get(k)})
    assert out[0] == out[1]
    return out[1]


def test_update_touches_one_fragment():
    dbs, n = _mk()
    assert _changed(dbs, "UPDATE t SET v = -1 WHERE id = 250") == {(2, 2)}
    _contents(dbs, "t")
    assert _check(dbs, "SELECT v FROM t WHERE id = 250") == [(-1,)]
    assert _check(dbs, "SELECT count(*) FROM t WHERE v = -1") == [(1,)]
    assert dbs[1].last_mutation == dict(rows=1, fragments=[2])


def test_update_multi_columns_and_fragments():
    dbs, n = _mk()
    changed = _changed(dbs, "UPDATE t SET v = v + 1000, s = 'patched' WHERE id IN (50, 450)")
    assert changed == {(0, 2), (0, 3), (4, 2), (4, 3)}
    _contents(dbs, "t")
    got = _check(dbs, "SELECT id, v, s FROM t WHERE s = 'patched' ORDER BY id")
    assert got == [(50, 1150, "patched"), (450, 2350, "patched")]


def test_delete_compacts_only_touched_fragments():
    dbs, n = _mk()
    changed = _changed(dbs, "DELETE FROM t WHERE id >= 300 AND id < 310")
    assert {f for f, _ in changed} == {3}
    assert dbs[1].catalog.get_table("t").fragments[3].num_rows == 90
    assert _check(dbs, "SELECT count(*) FROM t") == [(n - 10,)]
    assert _check(dbs, "SELECT count(*) FROM t WHERE id >= 300 AND id < 310") == [(0,)]
    # after the count: the reference cannot cut no fragment out of a
    # resident column (see test_updated_stats_follow)
    _contents(dbs, "t")


def test_update_null_predicate_semantics():
    dbs = _pair()
    _both(dbs, "CREATE TABLE u (a BIGINT, b BIGINT)",
          "INSERT INTO u VALUES (1, 10), (2, NULL), (3, 30)")
    # a NULL predicate matches no row (cond IS TRUE)
    _both(dbs, "UPDATE u SET a = 99 WHERE b > 15")
    _contents(dbs, "u")
    assert sorted(dbs[1].sql("SELECT a FROM u").column(0)) == [1, 2, 99]
    _both(dbs, "DELETE FROM u WHERE b > 15")
    _contents(dbs, "u")
    assert sorted(dbs[1].sql("SELECT a FROM u").column(0)) == [1, 2]


def test_update_guard_no_spurious_division_error():
    dbs = _pair()
    _both(dbs, "CREATE TABLE d (a DOUBLE, b BIGINT)", "INSERT INTO d VALUES (1.0, 0), (2.0, 4)")
    # rows the WHERE leaves out never raise on the value expression
    _both(dbs, "UPDATE d SET a = 1.0 / b WHERE b <> 0")
    _contents(dbs, "d")
    assert sorted(dbs[1].sql("SELECT a FROM d").column(0)) == [0.25, 1.0]


def test_scan_cache_patched_not_reuploaded():
    """The port's test_scan_cache_patched_not_reuploaded: an UPDATE moves
    the resident columns to the new generation, an untouched column keeps
    its tensor, and the next query uploads nothing."""
    dbs, n = _mk()
    port = dbs[1]
    ex = port.executor
    t = port.catalog.get_table("t")
    _check(dbs, "SELECT sum(v), count(s), max(id) FROM t")  # fills the cache
    keys0 = _cached(port, t)
    assert {k[2] for k in keys0} == {1, 2, 3}
    gen0 = t.generation
    _both(dbs, "UPDATE t SET v = 0 WHERE id = 10")
    assert t.generation != gen0
    keys1 = _cached(port, t)
    assert {k[2] for k in keys1} == {1, 2, 3} and not _stale(port, t)
    for k0, v0 in keys0.items():
        k1 = (k0[0], t.generation, k0[2], k0[3], None)
        if k0[2] != 2:  # v (col 2) was patched
            assert keys1[k1] is v0, f"column {k0[2]} was re-uploaded"
    h0 = ex.h2d_bytes
    assert _check(dbs, "SELECT sum(v), count(s), max(id) FROM t") == [
        (sum(i * 3 for i in range(n)) - 30, n, n - 1)]
    assert ex.h2d_bytes == h0
    _contents(dbs, "t")


def test_scan_cache_patched_after_delete():
    """The port's test_scan_cache_patched_after_delete: a DELETE compacts
    the resident columns on the device; the next queries upload nothing,
    and rowid stays the global physical position."""
    dbs, n = _mk()
    port = dbs[1]
    ex = port.executor
    t = port.catalog.get_table("t")
    base = _check(dbs, "SELECT sum(v), count(*), max(id) FROM t")[0]
    _both(dbs, "DELETE FROM t WHERE id % 100 = 7")  # one row a fragment
    assert {k[2] for k in _cached(port, t)} == {1, 2} and not _stale(port, t)
    h0 = ex.h2d_bytes
    got = _check(dbs, "SELECT sum(v), count(*), max(id) FROM t")[0]
    assert got[1] == n - 8
    assert got[0] == base[0] - sum((f * 100 + 7) * 3 for f in range(8))
    rids = _check(dbs, "SELECT max(rowid), count(*) FROM t")[0]
    assert rids[0] == rids[1] - 1
    assert ex.h2d_bytes == h0
    _contents(dbs, "t")


# ---------------------------------------------------------------------------
# the DML of test_engine_basic, test_sqlite_oracle, test_device_load and
# test_none_encoded_text
# ---------------------------------------------------------------------------

def _tdb():
    dbs = _pair()
    _both(dbs, "CREATE TABLE t (x INT, y DOUBLE, s TEXT, d DATE, b BOOLEAN)",
          "INSERT INTO t VALUES (1, 2.5, 'foo', '2020-01-01', 'true'), "
          "(2, NULL, 'bar', '2020-06-15', 'false'), (3, 7.5, 'foo', NULL, NULL), "
          "(NULL, 1.0, NULL, '2021-03-03', 'true')")
    return dbs


def test_insert_select_ctas():
    dbs = _tdb()
    _both(dbs, "CREATE TABLE t2 AS SELECT x, s FROM t WHERE x IS NOT NULL")
    _contents(dbs, "t2")
    assert _check(dbs, "SELECT count(*) FROM t2") == [(3,)]
    _both(dbs, "INSERT INTO t2 SELECT x, s FROM t WHERE x = 1")
    _contents(dbs, "t2")
    assert _check(dbs, "SELECT count(*) FROM t2") == [(4,)]
    assert _check(dbs, "SELECT s, count(*) FROM t2 GROUP BY s ORDER BY s") == [
        ("bar", 1), ("foo", 3)]


def test_update_delete():
    dbs = _tdb()
    _both(dbs, "UPDATE t SET x = x + 10 WHERE s = 'foo'")
    _contents(dbs, "t")
    assert _check(dbs, "SELECT sum(x) FROM t") == [(6 + 20,)]
    _both(dbs, "DELETE FROM t WHERE x > 10")
    _contents(dbs, "t")
    assert _check(dbs, "SELECT count(*) FROM t") == [(2,)]
    _both(dbs, "DELETE FROM t")
    _contents(dbs, "t")
    assert _check(dbs, "SELECT count(*) FROM t") == [(0,)]


def test_oracle_update_delete():
    """test_sqlite_oracle.py's table t1 at 2000 rows and its three
    statements, each followed by the table's contents and its checks."""
    rng = np.random.default_rng(42)
    n = 2000
    cols = {
        "x": np.array([np.iinfo(np.int32).min if i % 11 == 0 else int(v)
                       for i, v in enumerate(rng.integers(-50, 50, n))], np.int32),
        "y": np.array([float(round(v, 3)) if i % 7 else np.nan
                       for i, v in enumerate(rng.normal(0, 100, n))]),
        "s": np.array([None if i % 13 == 0 else ["red", "green", "blue", "amber", "x'y"][v]
                       for i, v in enumerate(rng.integers(0, 5, n))], object),
        "k": rng.integers(0, 20, n).astype(np.int32),
        "big": rng.integers(-(2**40), 2**40, n),
    }
    dbs = _pair(frag_rows=500)
    _both(dbs, "CREATE TABLE t1 (x INT, y DOUBLE, s TEXT, k INT, big BIGINT)")
    for db in dbs:
        db.load_table("t1", cols)
    for s in ["UPDATE t1 SET x = x + 100 WHERE k = 3",
              "DELETE FROM t1 WHERE k = 7",
              "UPDATE t1 SET y = 0.0 WHERE y IS NULL"]:
        _both(dbs, s)
        _contents(dbs, "t1")
    _check(dbs, "SELECT count(*), sum(x), sum(y) FROM t1")
    _check(dbs, "SELECT k, count(*) FROM t1 GROUP BY k ORDER BY k")


def test_device_load_stats_and_host_paths():
    """test_device_load.py's UPDATE of a device-loaded table: the lazy host
    chunks materialize for the patch, and the answers stay consistent."""
    n = 100_000
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    x = np.asarray(jax.random.randint(k1, (n,), 0, 100, jnp.int32))
    y = np.asarray(jax.random.uniform(k2, (n,), jnp.float32))
    ref, port = dbs = _pair()
    ref.load_table_device("dt", {"x": jnp.asarray(x), "y": jnp.asarray(y)}, create=True)
    port.load_table_device("dt", {"x": torch.from_numpy(x.copy()),
                                  "y": torch.from_numpy(y.copy())}, create=True)
    st = port.catalog.get_table("dt").fragments[0].stats[1]
    assert (st.min, st.max, st.has_nulls) == (0, 99, False)
    _both(dbs, "UPDATE dt SET x = -1 WHERE x = 99")
    assert _check(dbs, "SELECT count(*) FROM dt WHERE x = 99") == [(0,)]
    assert _check(dbs, "SELECT count(*) FROM dt") == [(n,)]
    _check(dbs, "SELECT x, count(*) FROM dt GROUP BY x ORDER BY x")
    _contents(dbs, "dt")


def _ndb():
    dbs = _pair()
    _both(dbs, "CREATE TABLE n (a TEXT ENCODING NONE, b INT)",
          "INSERT INTO n VALUES ('hello', 1), ('world', 2), ('hello', 3), "
          "(NULL, 4), ('Grüße', 5)")
    return dbs


def test_ctas_from_none_encoded():
    dbs = _ndb()
    _both(dbs, "CREATE TABLE c2 AS SELECT a, b * 2 AS bb FROM n")
    _contents(dbs, "c2")
    assert _check(dbs, "SELECT a FROM c2 WHERE bb = 2") == [("hello",)]


def test_update_delete_none_encoded():
    dbs = _ndb()
    port = dbs[1]
    t = port.catalog.get_table("n")
    _check(dbs, "SELECT a, b FROM n ORDER BY b")  # caches a and b
    dropped = port.executor.cache_keys_dropped
    _both(dbs, "UPDATE n SET a = 'patched' WHERE b = 2")
    # a's ids belong to the old generation's lazy dictionary: dropped, and
    # counted; b moved
    assert port.executor.cache_keys_dropped == dropped + 1
    assert {k[2] for k in _cached(port, t)} == {2}
    _contents(dbs, "n")
    assert _check(dbs, "SELECT a FROM n WHERE b = 2") == [("patched",)]
    _both(dbs, "UPDATE n SET a = a || '?' WHERE b = 1")
    _contents(dbs, "n")
    assert _check(dbs, "SELECT a FROM n WHERE b = 1") == [("hello?",)]
    _both(dbs, "DELETE FROM n WHERE b = 3")
    _contents(dbs, "n")
    assert _check(dbs, "SELECT COUNT(*) FROM n") == [(4,)]
    assert _check(dbs, "SELECT a, COUNT(*) FROM n GROUP BY a ORDER BY a") == [
        ("Grüße", 1), ("hello?", 1), ("patched", 1), (None, 1)]


# ---------------------------------------------------------------------------
# the port's own guarantees
# ---------------------------------------------------------------------------

def test_update_never_writes_the_loaded_tensor():
    """load_table_device seeds the scan cache with the caller's tensor
    when its length is a row bucket, and every fragment's lazy chunk views
    it: an UPDATE and a DELETE leave that tensor as it was."""
    n = 4096  # a bucket size: the cache holds the tensor itself
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
    v = torch.from_numpy(rng.random(n).astype(np.float32))
    k0, v0 = k.clone(), v.clone()
    port = hdt_torch.connect(device="cpu")
    port.sql("CREATE TABLE dv (k INT, v FLOAT) WITH (fragment_size=1000)")
    port.load_table_device("dv", {"k": k, "v": v})
    t = port.catalog.get_table("dv")
    assert any(c is k for c in _cached(port, t).values())
    port.sql("UPDATE dv SET k = -5, v = 2.0 WHERE k < 10")
    assert torch.equal(k, k0) and torch.equal(v, v0)
    want = np.where(k0.numpy() < 10, -5, k0.numpy())
    assert port.sql("SELECT COUNT(*), SUM(k) FROM dv").rows() == [(n, int(want.sum()))]
    port.sql("DELETE FROM dv WHERE k = -5")
    assert torch.equal(k, k0) and torch.equal(v, v0)
    assert port.sql("SELECT COUNT(*) FROM dv").rows() == [(int((k0 >= 10).sum()),)]


def test_rowid_is_made_on_the_device():
    """A scan of rowid (all fragments, or those fragment skipping leaves)
    uploads nothing once the table's columns are resident."""
    dbs, n = _mk()
    ex = dbs[1].executor
    _check(dbs, "SELECT count(*), max(id), sum(v) FROM t")
    h0 = ex.h2d_bytes
    _check(dbs, "SELECT min(rowid), max(rowid), sum(rowid) FROM t")
    _check(dbs, "SELECT rowid, v FROM t WHERE id >= 250 AND id < 420 ORDER BY rowid")
    _check(dbs, "SELECT sum(rowid) FROM t WHERE id > 690")
    assert ex.h2d_bytes == h0


def test_mutations_drop_older_generations():
    """After INSERT, UPDATE, DELETE, TRUNCATE and INSERT ... SELECT the scan
    cache holds no entry of the table's older generations."""
    dbs, n = _mk()
    port = dbs[1]
    t = port.catalog.get_table("t")
    for stmt in ["INSERT INTO t VALUES (9000, 1, 'x')",
                 "UPDATE t SET s = 'y' WHERE id > 700",
                 "DELETE FROM t WHERE id < 5",
                 "INSERT INTO t SELECT id + 10000, v, s FROM t WHERE id < 50",
                 "TRUNCATE TABLE t",
                 "INSERT INTO t VALUES (1, 2, 'z')"]:
        _check(dbs, "SELECT count(*), sum(v), count(s) FROM t")
        _both(dbs, stmt)
        assert not _stale(port, t), stmt
        _contents(dbs, "t")
    _both(dbs, "DROP TABLE t")
    assert not [k for k, _ in port.executor.scan_cache.items() if k[0] == t.table_id]


def test_updated_stats_follow():
    """UPDATE ... SET x = 0 widens x's chunk stats: the perfect tier's
    range, fragment skipping and the kernel cache see the new value, and a
    TEXT literal new to the dictionary is found by the next predicate.
    A filter whose chunk stats rule out every fragment, over a resident
    column, is the port's alone: the reference's device slice of no
    fragment fails (`jnp.concatenate` of nothing,
    heavydb_tpu/exec/executor.py:626)."""
    rng = np.random.default_rng(9)
    cols = {"x": rng.integers(1, 101, 3000).astype(np.int32),
            "y": rng.integers(0, 10, 3000).astype(np.int32),
            "s": np.array(["a", "b", "c"], object)[rng.integers(0, 3, 3000)]}
    dbs = _pair(frag_rows=1000)
    _both(dbs, "CREATE TABLE w (x INT, y INT, s TEXT)")
    for db in dbs:
        db.load_table("w", cols)
    q = "SELECT x, COUNT(*) FROM w WHERE y > 3 GROUP BY x ORDER BY x"
    _check(dbs, "SELECT COUNT(*) FROM w WHERE x = 0")
    _check(dbs, q)
    assert dbs[1].sql("SELECT COUNT(*) FROM w WHERE x = 0").rows() == [(0,)]
    _both(dbs, "UPDATE w SET x = 0, s = 'zz' WHERE y = 5")
    got = _check(dbs, q)
    assert got[0][0] == 0
    _check(dbs, "SELECT COUNT(*) FROM w WHERE x = 0")
    _check(dbs, "SELECT COUNT(*), MIN(y), MAX(y) FROM w WHERE s = 'zz'")
    _check(dbs, "SELECT s, COUNT(*) FROM w GROUP BY s ORDER BY s")
    _contents(dbs, "w")


def test_insert_select_casts_and_missing_columns():
    """INSERT ... SELECT into a subset of columns with other types: INT
    into DOUBLE and DECIMAL, DOUBLE into INT (truncated), NULLs kept, the
    columns left out NULL."""
    dbs = _pair()
    _both(dbs, "CREATE TABLE src (i INT, f DOUBLE)",
          "INSERT INTO src VALUES (1, 2.75), (NULL, -3.5), (4, NULL)",
          "CREATE TABLE dst (a DOUBLE, b INT, c DECIMAL(10, 2), s TEXT)",
          "INSERT INTO dst (a, b, c) SELECT i, f, i FROM src")
    _contents(dbs, "dst")
    _both(dbs, "CREATE TABLE named (p DOUBLE, q INT) AS SELECT f, i FROM src WHERE i > 0")
    _contents(dbs, "named")


def test_array_and_unknown_targets_raise():
    port = hdt_torch.connect(device="cpu")
    port.sql("CREATE TABLE q (a INT, b INT)")
    with pytest.raises(NotSupported):
        port.sql("CREATE TABLE qa AS SELECT ARRAY[a, b] AS arr FROM q")
    with pytest.raises(Exception):
        port.sql("UPDATE q SET nope = 1")
    with pytest.raises(Exception):
        port.sql("INSERT INTO q SELECT a FROM q")
