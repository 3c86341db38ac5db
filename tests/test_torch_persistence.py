"""The port's persistence against the JAX package: connect(path),
checkpoints after every statement, epochs and rollback, crash recovery,
the catalog migration v1 -> v2 and the newer-version refusal, the chunk
encoders and DUMP / RESTORE.

The 14 cases of tests/test_persistence.py and the disk cases of
tests/test_arrays.py, test_geo.py, test_geoint.py, test_inplace_updel.py,
test_none_encoded_text.py, test_ddl_security.py and test_privileges.py,
each run as one scenario through heavydb_tpu.connect(path) and
heavydb_tpu_torch.connect(path, device="cpu") in directories of their own:
the same rows, the same epochs and the same errors.  Then the port's own:
a directory written by either package opens in the other with the same
rows; each DML and DDL statement marks exactly the chunks it changed, so
that a reopen after UPDATE, DELETE, ADD COLUMN and ALTER COLUMN TYPE
serves the new rows; a table loaded from device tensors checkpoints
through its chunks' host copies; and after set_table_epoch, RESTORE and
REFRESH the executor holds no scan-cache column, aux table, kernel or
recycled result of the table's old generation or old id.

Every value is compared exactly, but sums of DOUBLE values within rtol
1e-9 (their order of addition differs); the data comes from each test's
own seeded generator.
"""

import json
import os

import numpy as np
import pytest
import torch

from heavydb_tpu.storage import persist as jpersist
from heavydb_tpu_torch.storage import persist as tpersist
from heavydb_tpu_torch.storage.table import LazyDeviceChunk
from torch_pair import PORT, REF
from torch_pair import both as _both
from torch_pair import raises_in_both as _raises_in_both
from torch_pair import same as _same


# ---------------------------------------------------------------------------
# tests/test_persistence.py
# ---------------------------------------------------------------------------


def _roundtrip(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE t (x INT, s TEXT, v DOUBLE)")
    db.sql("INSERT INTO t VALUES (1, 'a', 1.5), (2, 'b', NULL)")
    db.sql("INSERT INTO t VALUES (3, 'a', 2.5)")
    del db
    db2 = pkg.connect(p)
    return (db2.sql("SELECT count(*) FROM t").scalar(),
            db2.sql("SELECT s, sum(x) FROM t GROUP BY s ORDER BY s").rows(),
            db2.sql("SHOW TABLES").rows(),
            db2.sql("SELECT x, s, v FROM t ORDER BY x").rows())


def _epoch_rollback(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE t (x INT)")
    db.sql("INSERT INTO t VALUES (1)")
    e1 = db.get_table_epoch("t")
    db.sql("INSERT INTO t VALUES (2), (3)")
    out = [e1, db.get_table_epoch("t"), db.sql("SELECT count(*) FROM t").scalar()]
    db.set_table_epoch("t", e1)
    out.append(db.sql("SELECT count(*) FROM t").scalar())
    del db
    db2 = pkg.connect(p)
    return out + [db2.sql("SELECT count(*) FROM t").scalar(), db2.get_table_epoch("t")]


def _drop_table_removes_storage(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE t (x INT)")
    db.sql("INSERT INTO t VALUES (1)")
    db.sql("DROP TABLE t")
    del db
    db2 = pkg.connect(p)
    return db2.sql("SHOW TABLES").rows(), sorted(os.listdir(os.path.join(p, "tables")))


def _update_delete_persist(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE t (x INT)")
    db.sql("INSERT INTO t VALUES (1), (2), (3)")
    db.sql("UPDATE t SET x = x * 10 WHERE x > 1")
    db.sql("DELETE FROM t WHERE x = 1")
    del db
    db2 = pkg.connect(p)
    return sorted(r[0] for r in db2.sql("SELECT x FROM t").rows())


def _dump_restore(pkg, p):
    os.makedirs(p)
    db = pkg.connect()
    db.sql("CREATE TABLE t (x INT, s TEXT)")
    db.sql("INSERT INTO t VALUES (1, 'hello'), (2, NULL)")
    dump = os.path.join(p, "t.tgz")
    out = [db.sql(f"DUMP TABLE t TO '{dump}'").rows(), os.path.exists(dump)]
    db.sql("DROP TABLE t")
    out.append(db.sql(f"RESTORE TABLE t FROM '{dump}'").rows())
    return out + [db.sql("SELECT * FROM t ORDER BY x").rows()]


def _crash_recovery(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE t (x INT)")
    db.sql("INSERT INTO t VALUES (1)")
    t = db.catalog.get_table("t")
    store = db._table_stores[t.table_id]
    # a crash mid-checkpoint: a chunk of the next epoch, never committed
    epoch = store.committed_epoch()
    with open(store._chunk_path(0, 1, epoch + 1), "wb") as f:
        np.save(f, np.array([1, 2, 3, 4], np.int32))
    del db
    return pkg.connect(p).sql("SELECT count(*) FROM t").scalar()


def _inplace_update_fragments(pkg, p):
    d = pkg.connect()
    d.sql("CREATE TABLE f (x INT, y DOUBLE) WITH (fragment_size=100)")
    d.load_table("f", {"x": np.arange(250, dtype=np.int32), "y": np.zeros(250)})
    t = d.catalog.get_table("f")
    chunk0_before = t.fragments[0].chunks[2]
    d.sql("UPDATE f SET y = 1.5 WHERE x >= 200")
    out = [len(t.fragments), t.fragments[0].chunks[2] is chunk0_before,
           [sorted(f.dirty_cols) for f in t.fragments], d.sql("SELECT SUM(y) FROM f").scalar()]
    d.sql("UPDATE f SET y = 100.0 / x WHERE x = 200")
    return out + [d.sql("SELECT y FROM f WHERE x = 200").scalar()]


def _inplace_delete_compacts(pkg, p):
    d = pkg.connect()
    d.sql("CREATE TABLE g (x INT) WITH (fragment_size=100)")
    d.load_table("g", {"x": np.arange(250, dtype=np.int32)})
    t = d.catalog.get_table("g")
    c1_before = t.fragments[1].chunks[1]
    d.sql("DELETE FROM g WHERE x < 10")
    return (t.fragments[0].num_rows, t.fragments[1].chunks[1] is c1_before,
            d.sql("SELECT COUNT(*), MIN(x) FROM g").rows())


def _inplace_update_persists(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE u (k INT, s TEXT)")
    db.sql("INSERT INTO u VALUES (1, 'a'), (2, 'b'), (3, 'c')")
    db.sql("UPDATE u SET s = 'zz' WHERE k = 2")
    db.sql("DELETE FROM u WHERE k = 3")
    del db
    return pkg.connect(p).sql("SELECT k, s FROM u ORDER BY k").rows()


def _migration_v1_to_v2(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE mt (x INT, s TEXT)")
    db.sql("INSERT INTO mt VALUES (1, 'a'), (2, 'b')")
    path = os.path.join(p, "catalog.json")
    with open(path) as f:
        data = json.load(f)
    data["version"] = 1
    for tm in data["tables"]:
        tm.pop("shard_key", None)
        tm.pop("shard_count", None)
    with open(path, "w") as f:
        json.dump(data, f)
    db2 = pkg.connect(p)
    t = db2.catalog.get_table("mt")
    return t.shard_key, t.shard_count, db2.sql("SELECT count(*) FROM mt").rows()


def _shard_key_persists(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE sp (k INT, v INT, SHARD KEY (k)) WITH (shard_count=8)")
    t = pkg.connect(p).catalog.get_table("sp")
    return t.shard_key, t.shard_count


def _newer_version(pkg, p):
    db = pkg.connect(p)
    db.sql("CREATE TABLE nv (x INT)")
    path = os.path.join(p, "catalog.json")
    with open(path) as f:
        data = json.load(f)
    data["version"] = 99
    with open(path, "w") as f:
        json.dump(data, f)
    pkg.connect(p)


def _encoded_chunks(pkg, p):
    rng = np.random.default_rng(1601)
    db = pkg.connect(p)
    n = 20_000
    ts = np.arange(n, dtype=np.int64) * 30 + 1_600_000_000
    g = np.repeat(np.arange(20, dtype=np.int32), n // 20)
    v = rng.random(n)
    db.load_table("ev", {"ts": ts, "g": g, "v": v}, create=True)
    db.checkpoint()
    db2 = pkg.connect(p)
    m = db2._table_stores[db2.catalog.get_table("ev").table_id]
    manifest = m._load_manifest(m.committed_epoch())
    q = "SELECT g, count(*), sum(v), min(ts) FROM ev GROUP BY g ORDER BY g"
    return (db2.sql("SELECT count(*), min(g), max(g) FROM ev").rows(),
            db.sql(q).rows() == db2.sql(q).rows(), db2.sql(q).rows(),
            sorted(c["enc"] for c in manifest["chunks"].values()))


SCENARIOS = {
    "test_persist_roundtrip": _roundtrip,
    "test_epoch_rollback": _epoch_rollback,
    "test_drop_table_removes_storage": _drop_table_removes_storage,
    "test_update_delete_persist": _update_delete_persist,
    "test_dump_restore": _dump_restore,
    "test_crash_recovery_ignores_uncommitted": _crash_recovery,
    "test_inplace_update_touches_only_affected_fragments": _inplace_update_fragments,
    "test_inplace_delete_compacts_fragment": _inplace_delete_compacts,
    "test_inplace_update_persists": _inplace_update_persists,
    "test_catalog_migration_v1_to_v2": _migration_v1_to_v2,
    "test_shard_key_persists": _shard_key_persists,
    "test_encoded_chunks_persist_roundtrip": _encoded_chunks,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_persistence_cases(tmp_path, name):
    _both(tmp_path, SCENARIOS[name])


def test_newer_catalog_version_refused(tmp_path):
    _raises_in_both(tmp_path, _newer_version)


def test_chunk_encoders_roundtrip():
    """raw / RLE / DIFF: the same choice and the same parts as the
    reference's encoder, and a lossless decode."""
    rng = np.random.default_rng(1602)
    cols = [np.repeat(np.arange(50, dtype=np.int32), 200),
            np.arange(10_000, dtype=np.int64) * 60 + rng.integers(0, 30, 10_000),
            rng.integers(-2**40, 2**40, 10_000),
            np.repeat(np.array([2**62, -2**62, 0, 2**61, -5], np.int64), 100),
            rng.integers(-100, 100, 5000).astype(np.int16),
            np.arange(63, dtype=np.int32),
            rng.random(1000)]
    for arr in cols:
        enc, parts = tpersist.encode_chunk(arr)
        jenc, jparts = jpersist.encode_chunk(arr)
        assert enc == jenc
        for a, b in zip(parts, jparts):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        back = tpersist.decode_chunk(enc, parts, arr.dtype)
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)
    assert [tpersist.encode_chunk(c)[0] for c in cols[:3]] == ["rle", "diff", "raw"]


# ---------------------------------------------------------------------------
# the disk cases of the other reference suites
# ---------------------------------------------------------------------------


def _array_persistence(pkg, p):  # tests/test_arrays.py:166
    db = pkg.connect(p)
    db.sql("CREATE TABLE t (id INT, tags TEXT[], v DOUBLE[])")
    db.sql("INSERT INTO t VALUES (1, {'a','b'}, {0.5}), (2, NULL, {})")
    del db
    db2 = pkg.connect(p)
    out = [db2.sql("SELECT id, tags, v FROM t ORDER BY id").rows()]
    db2.sql("INSERT INTO t VALUES (3, {'c'}, NULL)")
    del db2
    return out + [pkg.connect(p).sql("SELECT id, CARDINALITY(tags) FROM t ORDER BY id").rows()]


def _geo_persistence(pkg, p):  # tests/test_geo.py:103
    db = pkg.connect(p)
    db.sql("CREATE TABLE g (p POINT)")
    db.sql("INSERT INTO g VALUES ('POINT(2.5 -3)')")
    del db
    db2 = pkg.connect(p)
    return db2.sql("SELECT p FROM g").scalar(), db2.sql("SELECT ST_X(p) FROM g").scalar()


def _geoint_persistence(pkg, p):  # tests/test_geoint.py:98
    db = pkg.connect(p)
    db.sql("CREATE TABLE gp (p GEOMETRY(POINT, 4326))")
    db.sql("INSERT INTO gp VALUES ('POINT(12.34 56.78)'), (NULL)")
    db.checkpoint()
    db2 = pkg.connect(p)
    t = db2.catalog.get_table("gp")
    return (str(t.fragments[0].chunks[t.columns[0].col_id][0].dtype),
            db2.sql("SELECT ST_X(p), ST_Y(p) FROM gp").rows())


def _updel_persistence(pkg, p):  # tests/test_inplace_updel.py:136
    db = pkg.connect(p, config=pkg.Config(default_fragment_rows=100))
    db.sql("CREATE TABLE t (id BIGINT, v BIGINT)")
    db.sql("INSERT INTO t VALUES " + ",".join(f"({i}, {i})" for i in range(300)))
    db.sql("UPDATE t SET v = 7777 WHERE id = 150")
    db.sql("DELETE FROM t WHERE id = 299")
    db2 = pkg.connect(p)
    return (db2.sql("SELECT v FROM t WHERE id = 150").rows(),
            db2.sql("SELECT count(*), sum(v), max(rowid) FROM t").rows())


def _none_text_persistence(pkg, p):  # tests/test_none_encoded_text.py:96
    db = pkg.connect(p)
    db.sql("CREATE TABLE p (a TEXT ENCODING NONE, b INT)")
    db.sql("INSERT INTO p VALUES ('x', 1), (NULL, 2), ('Grüße', 3)")
    db.sql("UPDATE p SET a = 'y' WHERE b = 1")
    db.checkpoint()
    return pkg.connect(p).sql("SELECT a, b FROM p ORDER BY b").rows()


def _comment_persists(pkg, p):  # tests/test_ddl_security.py:36
    db = pkg.connect(p)
    db.sql("CREATE TABLE c (x INT)")
    db.sql("COMMENT ON TABLE c IS 'kept'")
    db.sql("COMMENT ON COLUMN c.x IS 'col kept'")
    t = pkg.connect(p).catalog.get_table("c")
    return t.comment, t.column_by_name("x").comment


def _alter_column_persists(pkg, p):  # tests/test_ddl_security.py:90
    db = pkg.connect(p)
    db.sql("CREATE TABLE a (v INT)")
    db.sql("INSERT INTO a VALUES (5)")
    db.sql("ALTER TABLE a ALTER COLUMN v TYPE DOUBLE")
    return pkg.connect(p).sql("SELECT v FROM a").rows()


def _policy_persists(pkg, p):  # tests/test_ddl_security.py:169
    db = pkg.connect(p)
    db.sql("CREATE TABLE t (c TEXT)")
    db.sql("INSERT INTO t VALUES ('a'), ('b')")
    db.sql("CREATE USER u (password='x')")
    db.sql("GRANT SELECT ON t TO u")
    db.sql("CREATE POLICY ON COLUMN t.c TO u VALUES ('a')")
    return [r[0] for r in pkg.connect(p).sql("SELECT c FROM t", user="u").rows()]


def _privileges_persist(pkg, p):  # tests/test_privileges.py:54
    db = pkg.connect(p)
    db.sql("CREATE TABLE t (x INT)")
    db.sql("CREATE USER bob (password='pw')")
    db.sql("GRANT SELECT ON TABLE t TO bob")
    db.sql("INSERT INTO t VALUES (1)")
    del db
    db2 = pkg.connect(p)
    return (db2.syscatalog.check_login("bob", "pw"),
            db2.sql("SELECT count(*) FROM t", user="bob").scalar())


DISK_CASES = {
    "test_arrays.py::test_array_persistence": _array_persistence,
    "test_geo.py::test_geo_persistence": _geo_persistence,
    "test_geoint.py::test_compressed_persistence": _geoint_persistence,
    "test_inplace_updel.py::test_updel_persistence_roundtrip": _updel_persistence,
    "test_none_encoded_text.py::test_persistence_roundtrip": _none_text_persistence,
    "test_ddl_security.py::test_comment_persists": _comment_persists,
    "test_ddl_security.py::test_alter_column_persists": _alter_column_persists,
    "test_ddl_security.py::test_policy_persists": _policy_persists,
    "test_privileges.py::test_persistence": _privileges_persist,
}


@pytest.mark.parametrize("name", sorted(DISK_CASES))
def test_reference_disk_cases(tmp_path, name):
    _both(tmp_path, DISK_CASES[name])


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def _write_mixed(db):
    rng = np.random.default_rng(1603)
    n = 3000
    db.sql("CREATE TABLE m (i INT, b BIGINT, s SMALLINT, f FLOAT, d DOUBLE, "
           "t TEXT, n TEXT ENCODING NONE, dt DATE, a INT[], dec DECIMAL(10, 2)) "
           "WITH (fragment_size=1000)")
    words = np.array(["ab", "cd", "ef", None], object)
    db.load_table("m", {
        "i": rng.integers(-1000, 1000, n).astype(np.int32),
        "b": np.cumsum(rng.integers(0, 5, n)).astype(np.int64),
        "s": np.repeat(np.arange(30, dtype=np.int16), n // 30),
        "f": rng.random(n).astype(np.float32),
        "d": rng.standard_normal(n),
        "t": words[rng.integers(0, 4, n)],
        "n": np.array([None if k == 3 else f"w{k}" for k in rng.integers(0, 4, n)], object),
        "dt": np.array(["2024-01-0%d" % (k + 1) for k in rng.integers(0, 9, n)], object),
        "a": [list(range(k % 4)) if k % 5 else None for k in range(n)],
        "dec": np.round(rng.random(n) * 100, 2),
    })
    db.sql("INSERT INTO m (i, t) VALUES (NULL, 'zz')")
    db.sql("UPDATE m SET d = d * 2 WHERE i > 500")
    db.sql("DELETE FROM m WHERE i < -900")
    db.checkpoint()


_MIXED_Q = ["SELECT i, b, s, f, d, t, n, dt, a, dec FROM m ORDER BY rowid",
            "SELECT t, COUNT(*), SUM(d), MIN(i), MAX(b) FROM m GROUP BY t ORDER BY t",
            "SELECT s, COUNT(*), MIN(f), MAX(f) FROM m WHERE s < 12 GROUP BY s ORDER BY s"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_directory_opens_in_the_other_package(tmp_path, writer):
    """The on-disk format is the reference's: a directory written by one
    package opens in the other with the same rows, epochs and manifests,
    and a statement run there goes on from the same epoch."""
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    p = str(tmp_path / "db")
    wdb = w.connect(p)
    _write_mixed(wdb)
    want = [wdb.sql(q).rows() for q in _MIXED_Q]
    epoch = wdb.get_table_epoch("m")
    del wdb
    rdb = r.connect(p)
    assert rdb.get_table_epoch("m") == epoch
    got = [rdb.sql(q).rows() for q in _MIXED_Q]
    assert got[0] == want[0]  # every stored value, in row order
    assert _same(got[1:], want[1:])
    rdb.sql("UPDATE m SET i = 0 WHERE s = 3")
    assert rdb.get_table_epoch("m") == epoch + 1
    after = rdb.sql(_MIXED_Q[2]).rows()
    del rdb
    assert w.connect(p).sql(_MIXED_Q[2]).rows() == after


def _dml_ddl_reopen(pkg, p):
    """Each statement marks the chunks it changes: a reopen after each
    serves the new rows, and only changed chunks are written again."""
    db = pkg.connect(p, config=pkg.Config(default_fragment_rows=100))
    db.sql("CREATE TABLE w (k INT, v BIGINT, s TEXT)")
    db.load_table("w", {"k": np.arange(350, dtype=np.int32),
                        "v": np.arange(350, dtype=np.int64) * 3,
                        "s": np.array(["a", "b", "c", "d", "e"] * 70, object)})
    db.checkpoint()
    out = []
    q = "SELECT k, v, s FROM w ORDER BY k"
    for stmt in ["UPDATE w SET v = -1 WHERE k BETWEEN 120 AND 130",
                 "DELETE FROM w WHERE k >= 340 OR k < 5",
                 "ALTER TABLE w ADD COLUMN z INT DEFAULT 7",
                 "UPDATE w SET z = k WHERE k > 300",
                 "ALTER TABLE w ALTER COLUMN v TYPE DOUBLE",
                 "INSERT INTO w VALUES (1000, 1.5, 'q', 9)"]:
        store = db._table_stores[db.catalog.get_table("w").table_id]
        before = set(os.listdir(store.dir))
        db.sql(stmt)
        written = sorted(f for f in set(os.listdir(store.dir)) - before
                         if f.startswith("f"))
        q = "SELECT * FROM w ORDER BY k"
        want = db.sql(q).rows()
        got = pkg.connect(p).sql(q).rows()
        out.append((stmt, written, got == want, len(got)))
    return out


def test_dml_and_ddl_then_reopen(tmp_path):
    got = _both(tmp_path, _dml_ddl_reopen)
    assert all(same for _, _, same, _ in got)
    # an UPDATE of one fragment rewrites that fragment's one column
    assert got[0][1] == ["f1_c2.e3.npy"]


def test_device_loaded_table_checkpoints_host_copies(tmp_path):
    """A table loaded from device tensors (LazyDeviceChunk fragments)
    checkpoints each chunk's host copy: ordinary arrays on disk, the rows
    equal after a reopen, and the host copies made once."""
    rng = np.random.default_rng(1604)
    k = rng.integers(0, 50, 2500).astype(np.int32)
    v = rng.random(2500).astype(np.float32)
    p = str(tmp_path / "dev")
    db = PORT.connect(p)
    db.sql("CREATE TABLE dv (k INT, v FLOAT) WITH (fragment_size=1000)")
    db.load_table_device("dv", {"k": torch.from_numpy(k), "v": torch.from_numpy(v)})
    t = db.catalog.get_table("dv")
    assert all(isinstance(c, LazyDeviceChunk) for f in t.fragments for c in f.chunks.values())
    db.checkpoint()
    assert all(c._np is not None for f in t.fragments for c in f.chunks.values())
    store = db._table_stores[t.table_id]
    for name in os.listdir(store.dir):
        if name.startswith("f"):
            with open(os.path.join(store.dir, name), "rb") as fh:
                a = np.load(fh)  # no pickled objects
                assert a.dtype != object
    db2 = PORT.connect(p)
    t2 = db2.catalog.get_table("dv")
    np.testing.assert_array_equal(
        np.concatenate([f.chunks[t2.columns[0].col_id] for f in t2.fragments]), k)
    np.testing.assert_array_equal(
        np.concatenate([f.chunks[t2.columns[1].col_id] for f in t2.fragments]), v)
    q = "SELECT k, COUNT(*), SUM(v) FROM dv GROUP BY k ORDER BY k"
    assert db2.sql(q).rows() == db.sql(q).rows()


def _resident(db, table_id):
    """What the executor still holds of a table id: scan-cache keys, aux
    and kernel keys that name it, recycled results over it."""
    from heavydb_tpu_torch.exec.executor import _names_table

    ex = db.executor
    return ([k for k, _ in ex.scan_cache.items() if k[0] == table_id],
            [k for k in ex.aux_cache if _names_table(k, table_id)],
            [k for k in ex.kernel_cache if _names_table(k, table_id)],
            [k for k in db._result_cache if any(tid == table_id for tid, _ in k[1])])


def _warm(db, table):
    for q in [f"SELECT s, COUNT(*), SUM(x) FROM {table} GROUP BY s",
              f"/*+ keep_result */ SELECT COUNT(*) FROM {table} WHERE s LIKE 'a%'"]:
        db.sql(q).rows()


def test_device_state_dropped_after_rollback_restore_refresh(tmp_path):
    p = str(tmp_path / "db")
    db = PORT.connect(p)
    db.sql("CREATE TABLE r (x INT, s TEXT)")
    db.sql("INSERT INTO r VALUES (1, 'ab'), (2, 'b'), (3, 'ab')")
    e = db.get_table_epoch("r")
    db.sql("INSERT INTO r VALUES (4, 'ac')")
    _warm(db, "r")
    t = db.catalog.get_table("r")
    old_gen = t.generation
    assert all(_resident(db, t.table_id))
    db.set_table_epoch("r", e)
    assert t.generation > old_gen
    assert _resident(db, t.table_id) == ([], [], [], [])
    assert db.sql("SELECT COUNT(*), SUM(x) FROM r").rows() == [(3, 6)]
    assert all(k[1] == t.generation for k, _ in db.executor.scan_cache.items())

    # RESTORE over the table: nothing of the dropped id stays
    _warm(db, "r")
    dump = str(tmp_path / "r.tgz")
    db.sql(f"DUMP TABLE r TO '{dump}'")
    db.sql("INSERT INTO r VALUES (9, 'zz')")
    _warm(db, "r")
    old_id = t.table_id
    db.sql(f"RESTORE TABLE r FROM '{dump}'")
    assert _resident(db, old_id) == ([], [], [], [])
    assert db.catalog.get_table("r").table_id != old_id
    assert db.sql("SELECT COUNT(*), SUM(x) FROM r").rows() == [(3, 6)]

    # REFRESH of a foreign table: a new generation, the old one gone
    csv = tmp_path / "f.csv"
    csv.write_text("x,s\n1,ab\n2,ab\n")
    db.sql(f"CREATE FOREIGN TABLE fr (x INT, s TEXT) SERVER default_local_delimited "
           f"WITH (file_path = '{csv}')")
    _warm(db, "fr")
    ft = db.catalog.get_table("fr")
    assert all(_resident(db, ft.table_id))
    csv.write_text("x,s\n5,ab\n6,cd\n7,ab\n")
    db.sql("REFRESH FOREIGN TABLES fr")
    assert _resident(db, ft.table_id) == ([], [], [], [])
    assert db.sql("SELECT COUNT(*), SUM(x) FROM fr").rows() == [(3, 18)]


def test_set_table_epoch_errors_match(tmp_path):
    def unknown_epoch(pkg, p):
        db = pkg.connect(p)
        db.sql("CREATE TABLE t (x INT)")
        db.set_table_epoch("t", 42)

    def not_persistent(pkg, p):
        db = pkg.connect()
        db.sql("CREATE TABLE t (x INT)")
        db.set_table_epoch("t", 1)

    _raises_in_both(tmp_path / "a", unknown_epoch)
    _raises_in_both(tmp_path / "b", not_persistent)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_dump_archive_restores_in_the_other_package(tmp_path, writer):
    """A DUMP archive of either package RESTOREs in the other."""
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    rng = np.random.default_rng(1605)
    wdb = w.connect()
    wdb.sql("CREATE TABLE d (k INT, s TEXT, v DOUBLE) WITH (fragment_size=500)")
    wdb.load_table("d", {"k": rng.integers(0, 30, 1200).astype(np.int32),
                         "s": np.array(["a", "b", None], object)[rng.integers(0, 3, 1200)],
                         "v": rng.random(1200)})
    dump = str(tmp_path / "d.tgz")
    wdb.sql(f"DUMP TABLE d TO '{dump}'")
    rdb = r.connect()
    rdb.sql(f"RESTORE TABLE d FROM '{dump}'")
    q = "SELECT k, s, v FROM d ORDER BY rowid"
    assert rdb.sql(q).rows() == wdb.sql(q).rows()


def _tables_after_reopen(pkg, p):
    """Two tables, one dropped and another made (the survivors' ids in
    memory now differ from their stores'), a reopen, a table made and
    dropped again, then a RESTORE over a table, a table made and dropped
    and a reopen: every table keeps its rows."""
    db = pkg.connect(p)
    db.sql("CREATE TABLE a (x INT)")
    db.sql("INSERT INTO a VALUES (1), (2)")
    db.sql("CREATE TABLE b (x INT)")
    db.sql("INSERT INTO b VALUES (3)")
    db.sql("DROP TABLE a")
    db.sql("CREATE TABLE a2 (x INT)")
    db.sql("INSERT INTO a2 VALUES (5), (6), (7)")
    dump = os.path.join(os.path.dirname(p), pkg.name + "_b.tgz")
    db.sql(f"DUMP TABLE b TO '{dump}'")
    del db
    db = pkg.connect(p)
    db.sql("CREATE TABLE w (x INT)")
    db.sql("INSERT INTO w VALUES (9)")
    db.sql("DROP TABLE w")
    db.sql(f"RESTORE TABLE b FROM '{dump}'")
    db.sql("CREATE TABLE w2 (x INT)")
    db.sql("INSERT INTO w2 VALUES (8)")
    del db
    db = pkg.connect(p)
    db.sql("DROP TABLE w2")
    del db
    db = pkg.connect(p)
    return [db.sql(f"SELECT COUNT(*), SUM(x) FROM {t}").rows() for t in ("a2", "b")]


def test_new_tables_after_a_reopen_keep_the_stores_on_disk(tmp_path):
    """Fault of the reference, repaired in the port: after a reopen a table
    keeps its store directory's id apart from its id in memory, yet the
    reference saves the id in memory into catalog.json and gives a new table
    the next id in memory, whose store directory may be a reopened table's;
    writing and dropping the new table then loses that table's rows.  The
    port saves each table's store id and gives new tables ids above every
    store on disk (storage/persist.py `PersistentCatalogStore.load`)."""
    want = [[(3, 18)], [(1, 3)]]
    assert _tables_after_reopen(PORT, str(tmp_path / "port" / "db")) == want
    assert _tables_after_reopen(REF, str(tmp_path / "ref" / "db")) != want
