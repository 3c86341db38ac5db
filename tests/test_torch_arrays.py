"""ARRAY columns: heavydb_tpu_torch against the JAX package.

The same statements run in heavydb_tpu.connect() and
heavydb_tpu_torch.connect(device="cpu"); every query gives the
reference's rows (array values as lists, in order with ORDER BY, as
multisets without).  The cases are those of tests/test_arrays.py but
persistence (CARDINALITY, subscripts, ANY / ALL, array equality, UNNEST in
the project, under GROUP BY and after a filter, array literals,
load_table of per-row lists, CTAS, INSERT ... SELECT, UPDATE / DELETE of
tables that hold arrays, the binder's errors, arrays through a join),
and the port's own: tables of several fragments (fragment skipping, the
rowid handles renumbered after a DELETE), each `_array_aux` table kind
element for element against the reference's, and a mutation that leaves
no older generation's array tables in the executor's aux cache.

Tolerances: integers, strings and booleans exact; DOUBLE rtol 1e-9.
"""

import math

import numpy as np
import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu.config import Config as JConfig
from heavydb_tpu.plan.optimizer import optimize as joptimize
from heavydb_tpu.sql.parser import parse_many as jparse_many
from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.plan.optimizer import optimize
from heavydb_tpu_torch.sql.parser import parse_many


def _pair(frag_rows=None):
    kw = {} if frag_rows is None else dict(default_fragment_rows=frag_rows)
    return (hdt.connect(config=JConfig(**kw)),
            hdt_torch.connect(device="cpu", config=Config(**kw)))


def _both(dbs, *stmts):
    for db in dbs:
        for s in stmts:
            db.sql(s)


def _norm(v):
    if isinstance(v, float) and math.isnan(v):
        return None
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


def _close(a, b):
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(b, float) and a is not None:
        return a == pytest.approx(b, rel=1e-9)
    return a == b


def same_rows(got, want, ordered):
    got = [[_norm(v) for v in r] for r in got]
    want = [[_norm(v) for v in r] for r in want]
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want), (got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w)), (g, w)


def check(dbs, sql, ordered=None):
    ref, port = dbs
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    same_rows(got, want, "ORDER BY" in sql.upper() if ordered is None else ordered)
    return got


ADB = ["CREATE TABLE t (id INT, tags TEXT[], vals INT[], w DOUBLE)",
       "INSERT INTO t VALUES (1, {'a','b'}, {1,2,3}, 1.5), (2, {'b','c','d'}, {4}, 2.5), "
       "(3, NULL, {}, 3.5), (4, {'a'}, {7, NULL, 9}, 4.5)"]


@pytest.fixture(scope="module")
def adb():
    dbs = _pair()
    _both(dbs, *ADB)
    return dbs


# ---------------------------------------------------------------------------
# tests/test_arrays.py
# ---------------------------------------------------------------------------

ARRAY_QUERIES = [
    "SELECT id, tags, vals FROM t ORDER BY id",
    "SELECT id, CARDINALITY(tags), CARDINALITY(vals) FROM t ORDER BY id",
    "SELECT id, vals[1], vals[2], tags[1] FROM t ORDER BY id",
    "SELECT vals[9] FROM t ORDER BY id",
    "SELECT id, vals[id - 1], tags[CARDINALITY(tags)] FROM t ORDER BY id",
    "SELECT id FROM t WHERE 'a' = ANY tags ORDER BY id",
    "SELECT id FROM t WHERE 'z' <> ALL tags ORDER BY id",
    "SELECT id FROM t WHERE 5 < ANY vals ORDER BY id",
    "SELECT id FROM t WHERE 2 >= ALL vals ORDER BY id",
    "SELECT id FROM t WHERE 'b' >= ANY tags ORDER BY id",
    "SELECT id FROM t WHERE NULL = ANY vals ORDER BY id",
    "SELECT SUM(w) FROM t WHERE 'b' = ANY tags",
    "SELECT id, UNNEST(tags) FROM t ORDER BY id",
    "SELECT UNNEST(tags) tag, COUNT(*) c FROM t GROUP BY tag ORDER BY c DESC, tag",
    "SELECT SUM(UNNEST(vals)) FROM t",
    "SELECT id, UNNEST(vals) v FROM t WHERE id > 1 ORDER BY id, v",
    "SELECT UNNEST(vals) v, COUNT(*), SUM(w) FROM t GROUP BY v",
    "SELECT UNNEST(tags), w FROM t WHERE 'a' = ANY tags",
    "SELECT CARDINALITY(vals) c, COUNT(*) FROM t GROUP BY c ORDER BY c",
    "SELECT MAX(vals[1]), MIN(CARDINALITY(tags)) FROM t",
]


@pytest.mark.parametrize("sql", ARRAY_QUERIES)
def test_array_queries(adb, sql):
    check(adb, sql)


def test_array_literal_forms():
    dbs = _pair()
    _both(dbs, "CREATE TABLE a2 (x DOUBLE[], s TEXT[])",
          "INSERT INTO a2 VALUES (ARRAY[1.5, 2.5], ARRAY['p','q'])",
          "INSERT INTO a2 VALUES (NULL, {'r'})")
    got = check(dbs, "SELECT x, s FROM a2 ORDER BY CARDINALITY(s) DESC")
    assert got == [([1.5, 2.5], ["p", "q"]), (None, ["r"])]


def test_load_table_lists():
    dbs = _pair()
    _both(dbs, "CREATE TABLE a3 (id INT, xs BIGINT[])")
    for db in dbs:
        db.load_table("a3", {"id": np.arange(3, dtype=np.int32), "xs": [[10, 20], None, []]})
    got = check(dbs, "SELECT id, xs, CARDINALITY(xs) FROM a3 ORDER BY id")
    assert got == [(0, [10, 20], 2), (1, None, None), (2, [], 0)]


def test_ctas_and_insert_select():
    dbs = _pair()
    _both(dbs, *ADB)
    _both(dbs, "CREATE TABLE t2 AS SELECT id, tags FROM t WHERE id <= 2")
    check(dbs, "SELECT id, tags FROM t2 ORDER BY id")
    _both(dbs, "INSERT INTO t2 SELECT id, tags FROM t WHERE id = 4")
    assert check(dbs, "SELECT COUNT(*) FROM t2 WHERE 'a' = ANY tags") == [(2,)]
    # the copy's TEXT[] elements live in its own dictionary
    _both(dbs, "CREATE TABLE t3 (id INT, tags TEXT[], vals INT[])",
          "INSERT INTO t3 SELECT id, tags, vals FROM t WHERE id >= 3",
          "INSERT INTO t3 VALUES (9, {'z', NULL}, {})")
    check(dbs, "SELECT id, tags, vals, tags[2] FROM t3 ORDER BY id")
    check(dbs, "SELECT UNNEST(tags) s, COUNT(*) FROM t3 GROUP BY s ORDER BY s")


def test_update_delete_preserve_arrays():
    dbs = _pair()
    _both(dbs, *ADB)
    _both(dbs, "UPDATE t SET w = 0.0 WHERE id = 1", "DELETE FROM t WHERE id = 2")
    got = check(dbs, "SELECT id, tags, w FROM t ORDER BY id")
    assert got == [(1, ["a", "b"], 0.0), (3, None, 3.5), (4, ["a"], 4.5)]
    check(dbs, "SELECT id, UNNEST(vals) FROM t ORDER BY id")
    check(dbs, "SELECT id, CARDINALITY(tags), vals[1] FROM t WHERE 'a' = ANY tags "
               "ORDER BY id")


def _raises(dbs, sql):
    names = []
    for db in dbs:
        with pytest.raises(Exception) as ei:
            db.sql(sql)
        names.append(type(ei.value).__name__)
    assert names[0] == names[1], (sql, names)
    return names[1]


def test_array_errors(adb):
    assert _raises(adb, "SELECT * FROM t ORDER BY tags") == "BinderError"
    assert _raises(adb, "SELECT tags, COUNT(*) FROM t GROUP BY tags") == "BinderError"
    assert _raises(adb, "SELECT * FROM t WHERE tags = vals") == "BinderError"
    assert _raises(adb, "SELECT UNNEST(tags), UNNEST(vals) FROM t") == "NotSupported"
    assert _raises(adb, "SELECT id FROM t WHERE CARDINALITY(UNNEST(vals)) > 1") \
        in ("NotSupported", "BinderError")
    dbs = _pair()
    _both(dbs, *ADB)
    # UPDATE of an array column stays refused, as in the reference
    assert _raises(dbs, "UPDATE t SET vals = vals WHERE id = 1") == "NotSupported"


def test_array_join_side(adb):
    dbs = _pair()
    _both(dbs, *ADB, "CREATE TABLE d (id INT, nm TEXT)",
          "INSERT INTO d VALUES (1, 'one'), (4, 'four')")
    got = check(dbs, "SELECT d.nm, t.tags FROM t JOIN d ON t.id = d.id ORDER BY d.nm")
    assert got == [("four", ["a"]), ("one", ["a", "b"])]
    check(dbs, "SELECT d.nm, t.vals[2], CARDINALITY(t.tags) FROM t LEFT JOIN d "
               "ON t.id = d.id ORDER BY t.id")
    check(dbs, "SELECT d.nm, COUNT(*) FROM t JOIN d ON t.id = d.id "
               "WHERE 'a' = ANY t.tags GROUP BY d.nm")


def test_array_equality():
    dbs = _pair()
    _both(dbs, "CREATE TABLE aeq (a INT[], b INT[], s TEXT[], t2 TEXT[])",
          "INSERT INTO aeq VALUES ({1,2,3}, {1,2,3}, {'x','y'}, {'x','y'}),"
          " ({4,5}, {4,6}, {'a'}, {'b'}), (NULL, {1}, NULL, {'z'})")
    assert check(dbs, "SELECT a = b FROM aeq", ordered=True) == [(True,), (False,), (None,)]
    assert check(dbs, "SELECT count(*) FROM aeq WHERE a = b") == [(1,)]
    assert check(dbs, "SELECT count(*) FROM aeq WHERE a <> b") == [(1,)]
    assert check(dbs, "SELECT s = t2 FROM aeq", ordered=True) == [(True,), (False,), (None,)]


# ---------------------------------------------------------------------------
# the port's own: fragments, handles, aux tables, the aux cache
# ---------------------------------------------------------------------------

def _seeded_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        if rng.random() < 0.1:
            vals = "NULL"
        else:
            k = int(rng.integers(0, 5))
            el = ["NULL" if rng.random() < 0.1 else str(int(rng.integers(0, 50)))
                  for _ in range(k)]
            vals = "{" + ", ".join(el) + "}"
        tags = "{" + ", ".join(f"'s{int(x)}'" for x in rng.integers(0, 6, int(rng.integers(0, 3)))) + "}"
        rows.append(f"({i}, {vals}, {tags}, {float(rng.normal()):.6f})")
    return rows


@pytest.fixture(scope="module")
def frag_dbs():
    dbs = _pair(frag_rows=40)
    _both(dbs, "CREATE TABLE f (id INT, vals INT[], tags TEXT[], w DOUBLE)",
          "INSERT INTO f VALUES " + ", ".join(_seeded_rows(150, 7)))
    return dbs


FRAG_QUERIES = [
    # the filter's chunk stats skip fragments: the handles stay global
    "SELECT id, vals, vals[2], CARDINALITY(tags) FROM f WHERE id >= 85 ORDER BY id",
    "SELECT id, UNNEST(vals) FROM f WHERE id < 30 OR id > 130",
    "SELECT COUNT(*), SUM(w) FROM f WHERE 7 = ANY(vals) AND vals[1] < 40",
    "SELECT UNNEST(vals) v, COUNT(*) FROM f GROUP BY v",
    "SELECT UNNEST(tags) s, COUNT(*), SUM(w) FROM f WHERE id > 20 GROUP BY s",
    "SELECT id FROM f WHERE 10 > ALL vals ORDER BY id",
]


@pytest.mark.parametrize("sql", FRAG_QUERIES)
def test_fragmented_arrays(frag_dbs, sql):
    check(frag_dbs, sql)


def _array_fns(root):
    out = []
    seen = set()

    def walk_node(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for i in n.inputs:
            walk_node(i)
        afn = getattr(n, "afn", None)
        exprs = [afn] if afn is not None else []
        for attr in ("target_exprs", "group_exprs", "aggs"):
            exprs += [e for e in getattr(n, attr, None) or [] if e is not None]
        for attr in ("filter_cond", "having"):
            if getattr(n, attr, None) is not None:
                exprs.append(getattr(n, attr))
        exprs += [c for _, c in getattr(n, "join_levels", []) if c is not None]
        for e in exprs:
            # exprs.walk only follows children(): it walks either package's
            for sub in E.walk(e):
                if type(sub).__name__ == "ArrayFn":
                    out.append(sub)

    walk_node(root)
    return out


AUX_QUERIES = [
    "SELECT CARDINALITY(vals), vals[2], CARDINALITY(tags) FROM f",
    "SELECT COUNT(*) FROM f WHERE 7 = ANY(vals) OR 30 <= ALL vals OR 's3' < ANY tags",
    "SELECT COUNT(*) FROM f WHERE NULL = ANY(vals) OR 3.5 > ALL vals",
    "SELECT UNNEST(vals) FROM f",
]


@pytest.mark.parametrize("sql", AUX_QUERIES)
def test_array_aux_tables_match_reference(frag_dbs, sql):
    """Each ArrayFn's tables from `_array_aux`, element for element."""
    ref, port = frag_dbs
    jf = _array_fns(joptimize(ref._plan_select(jparse_many(sql)[0])))
    pf = _array_fns(optimize(port._plan_select(parse_many(sql)[0])))
    assert [a.op for a in jf] == [a.op for a in pf] and pf
    for ja, pa in zip(jf, pf):
        want = ref.executor._array_aux(ja)
        got = port.executor._array_aux(pa)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            w = np.asarray(w)
            g = g.numpy()
            assert w.dtype == g.dtype and w.shape == g.shape, (pa.op, w.dtype, g.dtype)
            assert np.array_equal(w, g, equal_nan=w.dtype.kind == "f"), pa.op


def test_delete_renumbers_handles():
    dbs = _pair(frag_rows=40)
    _both(dbs, "CREATE TABLE f (id INT, vals INT[], tags TEXT[], w DOUBLE)",
          "INSERT INTO f VALUES " + ", ".join(_seeded_rows(150, 11)))
    check(dbs, "SELECT id, vals, tags[1] FROM f ORDER BY id")  # the handles resident
    _both(dbs, "DELETE FROM f WHERE id % 7 = 3 OR id BETWEEN 41 AND 60")
    port = dbs[1]
    t = port.catalog.get_table("f")
    h = [v for k, v in port.executor.scan_cache.items()
         if k[0] == t.table_id and k[1] == t.generation and k[2] == 2][0]
    n = t.num_rows
    assert h[:n].tolist() == list(range(n)) and (h[n:] == -1).all()
    check(dbs, "SELECT id, vals, tags[1] FROM f ORDER BY id")
    check(dbs, "SELECT id, UNNEST(tags) FROM f WHERE id > 100")
    check(dbs, "SELECT COUNT(*) FROM f WHERE 4 = ANY vals")


def test_mutation_prunes_array_aux():
    """After an UPDATE and a DELETE on a table with arrays, drop_stale
    leaves no array aux table of an older generation in aux_cache."""
    dbs = _pair(frag_rows=40)
    _both(dbs, "CREATE TABLE f (id INT, vals INT[], tags TEXT[], w DOUBLE)",
          "INSERT INTO f VALUES " + ", ".join(_seeded_rows(120, 5)))
    port = dbs[1]
    t = port.catalog.get_table("f")
    q = "SELECT id, vals[1], CARDINALITY(tags), w FROM f WHERE 3 = ANY vals ORDER BY id"

    def array_gens():
        return {k[2] for k in port.executor.aux_cache
                if k[0] == "array" and k[1] == t.table_id}

    check(dbs, q)
    assert array_gens() == {t.generation}
    _both(dbs, "UPDATE f SET w = w + 1.0 WHERE id < 50")
    assert array_gens() == set()
    check(dbs, q)
    assert array_gens() == {t.generation}
    _both(dbs, "DELETE FROM f WHERE id > 100")
    assert array_gens() == set()
    check(dbs, q)
    check(dbs, "SELECT id, UNNEST(vals) FROM f ORDER BY id")
    assert array_gens() == {t.generation}
