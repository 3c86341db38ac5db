"""Dictionary strings: heavydb_tpu_torch against the JAX package.

Engine level: each fixture builds its tables in heavydb_tpu.connect()
(DDL and INSERT, or load_table) and copies them through load_state into
heavydb_tpu_torch.connect(device="cpu"); every query must give the
reference's rows: as multisets without ORDER BY, in order with it.
Integers and strings are exact, DOUBLE results rtol 1e-9.  The queries are
those of tests/test_string_ops.py, tests/test_pair_concat.py, the
none-encoded TEXT queries of tests/test_none_encoded_text.py whose
reference path needs no module the port lacks (UPDATE / DELETE, CTAS,
persistence and COPY stay out), and the LIKE / ILIKE queries of
tests/test_engine_basic.py and tests/test_sqlite_oracle.py.

Unit level: each table kind of the executor's `_aux_array` against the
reference's on the same dictionaries, element for element, and
storage/string_ops.apply_op / int_string_fn against the reference's for
every op name, on seeded strings that include '', NULL and non-ASCII.
"""

import math

import numpy as np
import pytest

import heavydb_tpu as hdt
from heavydb_tpu.errors import NotSupported as JNotSupported
from heavydb_tpu.plan import exprs as JE
from heavydb_tpu.storage import string_ops as JSO
from heavydb_tpu_torch.errors import NotSupported
from heavydb_tpu_torch.exec import executor as X
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.storage import string_ops as SO
from tests.test_torch_engine import _copy_state
from tests.test_torch_join import _same


def _engines(statements, names):
    """A reference database built by `statements` and a CPU port copy of
    its tables `names`."""
    ref = hdt.connect()
    for st in statements:
        if callable(st):
            st(ref)
        else:
            ref.sql(st)
    return ref, _copy_state(ref, names)


def _check(engines, sql, f32_cols=()):
    ref, port = engines
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    _same(got, want, f32_cols, ordered="ORDER BY" in sql.upper())


# ---------------------------------------------------------------------------
# tests/test_string_ops.py
# ---------------------------------------------------------------------------

STRING_OPS_TABLES = [
    "CREATE TABLE s (t TEXT, k INT)",
    "INSERT INTO s VALUES ('Hello World', 1), ('  pad  ', 2), ('a,b,c', 3), "
    "(NULL, 4), ('Grüße', 5)",
    "CREATE TABLE g (t TEXT)",
    "INSERT INTO g VALUES ('a'), ('A'), ('b'), ('B'), ('b')",
    "CREATE TABLE sp (t TEXT)",
    "INSERT INTO sp VALUES ('hello world'), ('banana'), ('abc')",
    "CREATE TABLE so (t TEXT)",
    "INSERT INTO so VALUES ('banana')",
    "CREATE TABLE sj (j TEXT)",
    "INSERT INTO sj VALUES ('{\"a\": {\"b\": [1, 2]}}'), ('{\"a\": 5}'), ('nope')",
    "CREATE TABLE sr (t TEXT)",
    "INSERT INTO sr VALUES ('banana'), ('xyz')",
    "CREATE TABLE sl (t TEXT)",
    "INSERT INTO sl VALUES ('banana'), ('banal')",
    "CREATE TABLE sw (t TEXT, v INT)",
    "INSERT INTO sw VALUES ('apple', 1), ('grape', 2), ('plum', 4)",
    "CREATE TABLE tc (s TEXT)",
    "INSERT INTO tc VALUES ('42'), ('3.5'), ('nope'), (NULL), ('-7')",
    "CREATE TABLE slr (s TEXT)",
    "INSERT INTO slr VALUES ('hello world'), (''), (NULL)",
    "CREATE TABLE sh (s TEXT)",
    "INSERT INTO sh VALUES ('Spark'), ('hello'), (''), (NULL)",
    "CREATE TABLE sjw (s TEXT)",
    "INSERT INTO sjw VALUES ('martha'), ('marhta'), ('')",
    "CREATE TABLE sws (s TEXT)",
    "INSERT INTO sws VALUES ('100% sure'), ('a_b'), ('plain'), (NULL)",
    "CREATE TABLE gl (a INT, b INT, c DOUBLE)",
    "INSERT INTO gl VALUES (1, 5, 2.5), (7, 3, NULL), (NULL, 4, 1.0)",
    "CREATE TABLE lt (s TEXT)",
    "INSERT INTO lt VALUES ('cat'), ('dog'), ('cat')",
]
STRING_OPS_NAMES = ["s", "g", "sp", "so", "sj", "sr", "sl", "sw", "tc", "slr", "sh",
                    "sjw", "sws", "gl", "lt"]

# one entry a test of tests/test_string_ops.py (its tables sj / sw of two
# tests each become sj, sjw and sw, sws here)
STRING_OPS_QUERIES = {
    "upper_lower": ["SELECT UPPER(t), LOWER(t) FROM s WHERE k = 1"],
    "substring_replace": ["SELECT SUBSTRING(t, 1, 5) FROM s WHERE k = 1",
                          "SELECT REPLACE(t, 'World', 'TPU') FROM s WHERE k = 1"],
    "trim_pad": ["SELECT TRIM(t) FROM s WHERE k = 2", "SELECT LTRIM(t) FROM s WHERE k = 2",
                 "SELECT LPAD(TRIM(t), 6, '*') FROM s WHERE k = 2"],
    "split_part": ["SELECT SPLIT_PART(t, ',', 2) FROM s WHERE k = 3",
                   "SELECT SPLIT_PART(t, ',', 9) FROM s WHERE k = 3"],
    "concat_operator": ["SELECT t || '!' FROM s WHERE k = 1",
                        "SELECT '<' || t FROM s WHERE k = 1", "SELECT 'a' || 'b'"],
    "null_propagation": ["SELECT UPPER(t) FROM s WHERE k = 4"],
    "unicode": ["SELECT UPPER(t) FROM s WHERE k = 5"],
    "predicate_over_transform": [
        "SELECT count(*) FROM s WHERE UPPER(t) = 'HELLO WORLD'",
        "SELECT count(*) FROM s WHERE LOWER(t) LIKE '%world%'"],
    "group_by_transform": ["SELECT UPPER(t) u, count(*) FROM g GROUP BY u ORDER BY u"],
    "order_by_transform": ["SELECT k FROM s WHERE t IS NOT NULL ORDER BY REVERSE(t)"],
    "length_of_transform": ["SELECT LENGTH(TRIM(t)) FROM s WHERE k = 2"],
    "chained": ["SELECT UPPER(REPLACE(t, 'l', 'L')) FROM s WHERE k = 1"],
    "position_and_instr": ["SELECT t, POSITION('an' IN t), INSTR(t, 'o') FROM sp ORDER BY t"],
    "overlay": ["SELECT OVERLAY(t, 'XX', 2) FROM so", "SELECT OVERLAY(t, 'Z', 2, 4) FROM so"],
    "json_value": ["SELECT JSON_VALUE(j, '$.a.b[1]'), JSON_VALUE(j, '$.a') FROM sj"],
    "regexp_substr_count": ["SELECT REGEXP_SUBSTR(t, '[aeiou]+'), REGEXP_COUNT(t, 'a') "
                            "FROM sr ORDER BY t"],
    "levenshtein": ["SELECT t, LEVENSHTEIN_DISTANCE(t, 'banal') FROM sl ORDER BY t"],
    "intfn_in_where_and_agg": ["SELECT SUM(v) FROM sw WHERE POSITION('ap' IN t) > 0"],
    "try_cast": ["SELECT s, TRY_CAST(s AS INT), TRY_CAST(s AS DOUBLE) FROM tc",
                 "SELECT SUM(TRY_CAST(s AS DOUBLE)) FROM tc",
                 "SELECT COUNT(*) FROM tc WHERE TRY_CAST(s AS INT) IS NOT NULL"],
    "left_right_space": ["SELECT LEFT(s, 3), RIGHT(s, 3), s || SPACE(2) || 'x' FROM slr"],
    "hash": ["SELECT HASH(s) FROM sh"],
    "jarowinkler": ["SELECT JAROWINKLER_SIMILARITY(s, 'martha') FROM sjw"],
    "startswith_endswith_contains": [
        "SELECT count(*) FROM sws WHERE CONTAINS(s, '0%')",
        "SELECT count(*) FROM sws WHERE CONTAINS(s, '_')",
        "SELECT count(*) FROM sws WHERE STARTSWITH(s, 'pl')",
        "SELECT count(*) FROM sws WHERE ENDSWITH(s, 'ure')"],
    "greatest_least": ["SELECT GREATEST(a, b), LEAST(a, b), GREATEST(a, b, c) FROM gl"],
}


@pytest.fixture(scope="module")
def string_ops():
    return _engines(STRING_OPS_TABLES, STRING_OPS_NAMES)


@pytest.mark.parametrize("name", sorted(STRING_OPS_QUERIES))
def test_string_ops_queries(string_ops, name):
    for sql in STRING_OPS_QUERIES[name]:
        _check(string_ops, sql)


def test_llm_transform_gated(string_ops):
    """LLM_TRANSFORM needs a registered backend in both engines, and then
    applies it once per distinct dictionary entry."""
    ref, port = string_ops
    sql = "SELECT LLM_TRANSFORM(s, 'p') FROM lt ORDER BY s"
    with pytest.raises(JNotSupported):
        ref.sql(sql)
    with pytest.raises(NotSupported):
        port.sql(sql)
    calls = []

    def fake(text, prompt):
        calls.append((text, prompt))
        return f"{prompt}:{text.upper()}"

    ref.register_llm_transform(fake)
    port.register_llm_transform(fake)
    try:
        want = ref.sql(sql).rows()
        n_ref = len(calls)
        got = port.sql(sql).rows()
        assert got == want == [("p:CAT",), ("p:CAT",), ("p:DOG",)]
        assert sorted(calls[n_ref:]) == [("cat", "p"), ("dog", "p")]
    finally:
        JSO.set_llm_transform(None)
        SO.set_llm_transform(None)


# ---------------------------------------------------------------------------
# tests/test_pair_concat.py
# ---------------------------------------------------------------------------


def _load_pc(ref):
    rng = np.random.default_rng(42)
    n = 500
    a = [None if i % 11 == 0 else ["ab", "cd", "ef", "g'h"][v]
         for i, v in enumerate(rng.integers(0, 4, n))]
    b = [None if i % 7 == 0 else ["X", "YY", ""][v]
         for i, v in enumerate(rng.integers(0, 3, n))]
    k = [int(v) for v in rng.integers(0, 5, n)]
    ref.sql("CREATE TABLE pc (a TEXT, b TEXT, k INT)")
    ref.load_table("pc", {"a": np.array(a, object), "b": np.array(b, object),
                          "k": np.array(k, object)})


@pytest.fixture(scope="module")
def pair_concat():
    return _engines([_load_pc, "CREATE TABLE cap_t (a TEXT, b TEXT)",
                     "INSERT INTO cap_t VALUES ('p','q')"], ["pc", "cap_t"])


PAIR_CONCAT_QUERIES = {
    "projection": ["SELECT a || b FROM pc"],
    "with_constants_and_chains": ["SELECT a || '-' || b FROM pc", "SELECT UPPER(a || b) FROM pc",
                                  "SELECT UPPER(a) || LOWER(b) FROM pc"],
    "nary_concat_fn": ["SELECT CONCAT(a, b) FROM pc", "SELECT CONCAT(a, '-', b) FROM pc"],
    "filter_group_order": [
        "SELECT count(*) FROM pc WHERE a || b = 'abX'",
        "SELECT a || b AS ab, count(*) FROM pc GROUP BY ab ORDER BY ab NULLS LAST, 2",
        "SELECT a || b, count(*) FROM pc GROUP BY a || b ORDER BY a || b NULLS LAST, 2",
        "SELECT MIN(a || b), MAX(a || b) FROM pc"],
    "groupby_repeated_transform": [
        "SELECT UPPER(a), count(*) FROM pc GROUP BY UPPER(a) ORDER BY UPPER(a) NULLS LAST"],
    "dict_ordering_comparisons": [
        "SELECT count(*) FROM pc WHERE a < b", "SELECT count(*) FROM pc WHERE a >= b",
        "SELECT a, b FROM pc WHERE UPPER(a) <= UPPER(b)",
        "SELECT count(*) FROM pc WHERE a || b > b || a"],
}


@pytest.mark.parametrize("name", sorted(PAIR_CONCAT_QUERIES))
def test_pair_concat_queries(pair_concat, name):
    for sql in PAIR_CONCAT_QUERIES[name]:
        _check(pair_concat, sql)


def test_pair_table_cap(pair_concat):
    """Past config.pair_concat_max_entries both engines refuse a || b, and
    answer it again under the default cap."""
    ref, port = pair_concat
    sql = "SELECT a || b FROM cap_t"
    for db, err in ((ref, JNotSupported), (port, NotSupported)):
        db.config.pair_concat_max_entries = 0
        try:
            with pytest.raises(err):
                db.sql(sql).rows()
        finally:
            db.config.pair_concat_max_entries = 1 << 22
    _check(pair_concat, sql)


@pytest.mark.parametrize("op", ["<", "<=", ">", ">=", "=", "<>"])
def test_pair_compare_operators(pair_concat, op):
    _check(pair_concat, f"SELECT k, count(*) FROM pc WHERE a {op} b GROUP BY k")
    _check(pair_concat, f"SELECT count(*) FROM pc WHERE UPPER(a) {op} LOWER(b) || a")


# ---------------------------------------------------------------------------
# tests/test_none_encoded_text.py
# ---------------------------------------------------------------------------

NONE_TABLES = [
    "CREATE TABLE n (a TEXT ENCODING NONE, b INT)",
    "INSERT INTO n VALUES ('hello', 1), ('world', 2), ('hello', 3), (NULL, 4), ('Grüße', 5)",
    "CREATE TABLE d (a TEXT, c INT)",
    "INSERT INTO d VALUES ('hello', 10), ('mars', 20)",
    "CREATE TABLE m (a TEXT ENCODING NONE, c INT)",
    "INSERT INTO m VALUES ('world', 7), ('hello', 8)",
    "CREATE TABLE tc (s TEXT, n TEXT ENCODING NONE, k INT)",
    "INSERT INTO tc VALUES ('12', '2023-01-15', 1), ('oops', 'not-a-date', 2), "
    "('3.75', '2024-06-30 12:30:00', 3), (NULL, NULL, 4), ('-7', '1999-12-31', 5)",
]

NONE_QUERIES = {
    "projection_and_nulls": ["SELECT a, b FROM n ORDER BY b"],
    "filter_eq_like": ["SELECT COUNT(*) FROM n WHERE a = 'hello'",
                       "SELECT COUNT(*) FROM n WHERE a LIKE 'h%'",
                       "SELECT COUNT(*) FROM n WHERE a IS NULL"],
    "group_by": ["SELECT a, COUNT(*), SUM(b) FROM n GROUP BY a ORDER BY a"],
    "transforms_apply": ["SELECT UPPER(a) FROM n WHERE b = 1", "SELECT a || '!' FROM n WHERE b = 2"],
    "join_with_dict_column": ["SELECT n.b, d.c FROM n JOIN d ON n.a = d.a ORDER BY n.b"],
    "join_two_none_encoded": ["SELECT n.b, m.c FROM n JOIN m ON n.a = m.a ORDER BY n.b, m.c"],
    "order_by_is_lexicographic": ["SELECT a FROM n WHERE a IS NOT NULL ORDER BY a"],
    "min_max": ["SELECT MIN(a), MAX(a), COUNT(a) FROM n",
                "SELECT b % 2, MIN(a), MAX(a) FROM n GROUP BY b % 2"],
    "try_cast_int": ["SELECT TRY_CAST(s AS INT), k FROM tc ORDER BY k"],
    "try_cast_double": ["SELECT TRY_CAST(s AS DOUBLE), k FROM tc ORDER BY k"],
    "try_cast_decimal": ["SELECT TRY_CAST(s AS DECIMAL(10, 2)), k FROM tc ORDER BY k"],
    "try_cast_date": ["SELECT TRY_CAST(n AS DATE), k FROM tc ORDER BY k"],
    "try_cast_timestamp": ["SELECT TRY_CAST(n AS TIMESTAMP), k FROM tc ORDER BY k"],
    "try_cast_in_predicate": ["SELECT COUNT(*) FROM tc WHERE TRY_CAST(n AS DATE) > '2023-06-01'"],
    "try_cast_aggregate": ["SELECT SUM(TRY_CAST(s AS INT)) FROM tc"],
    "hash_op": ["SELECT HASH(a) FROM n"],
}


@pytest.fixture(scope="module")
def none_encoded():
    return _engines(NONE_TABLES, ["n", "d", "m", "tc"])


@pytest.mark.parametrize("name", sorted(NONE_QUERIES))
def test_none_encoded_queries(none_encoded, name):
    for sql in NONE_QUERIES[name]:
        _check(none_encoded, sql)


def _op_matrix_statements(encoding):
    from tests.test_none_encoded_text import _OP_CASES

    enc = "" if encoding == "DICT" else " ENCODING NONE"
    inputs = sorted({inp for _, inp, _ in _OP_CASES})
    rows = ", ".join("('{}', {})".format(inp.replace("'", "''"), i)
                     for i, inp in enumerate(inputs))
    return [f"CREATE TABLE mx (c TEXT{enc}, k INT)", f"INSERT INTO mx VALUES {rows}"], inputs


@pytest.mark.parametrize("encoding", ["DICT", "NONE"])
def test_string_op_matrix(encoding):
    """tests/test_none_encoded_text.py's op matrix over both encodings,
    every op over every input: one query, a column an op."""
    from tests.test_none_encoded_text import _OP_CASES

    statements, _ = _op_matrix_statements(encoding)
    exprs = ", ".join(expr.format(c="c") for expr, _, _ in _OP_CASES)
    _check(_engines(statements, ["mx"]), f"SELECT k, {exprs} FROM mx ORDER BY k")


# ---------------------------------------------------------------------------
# LIKE / ILIKE of tests/test_engine_basic.py and tests/test_sqlite_oracle.py
# ---------------------------------------------------------------------------


def _load_t1(ref):
    rng = np.random.default_rng(42)
    n = 2000
    x = np.array([int(v) if i % 11 else None
                  for i, v in enumerate(rng.integers(-50, 50, n))], object)
    s = np.array([None if i % 13 == 0 else ["red", "green", "blue", "amber", "x'y"][v]
                  for i, v in enumerate(rng.integers(0, 5, n))], object)
    ref.sql("CREATE TABLE t1 (x INT, s TEXT, k INT) WITH (fragment_size=500)")
    ref.load_table("t1", {"x": x, "s": s, "k": rng.integers(0, 20, n).astype(np.int32)})


@pytest.fixture(scope="module")
def basic():
    return _engines([
        "CREATE TABLE t (x INT, y DOUBLE, s TEXT, d DATE, b BOOLEAN)",
        "INSERT INTO t VALUES (1, 2.5, 'foo', '2020-01-01', 'true'), "
        "(2, NULL, 'bar', '2020-06-15', 'false'), (3, 7.5, 'foo', NULL, NULL), "
        "(NULL, 1.0, NULL, '2021-03-03', 'true')", _load_t1], ["t", "t1"])


@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM t WHERE s = 'foo'",
    "SELECT count(*) FROM t WHERE s <> 'foo'",
    "SELECT count(*) FROM t WHERE s LIKE 'f%'",
    "SELECT count(*) FROM t WHERE s ILIKE 'BA_'",
    "SELECT count(*) FROM t WHERE s IN ('foo','baz')",
    "SELECT count(*) FROM t1 WHERE s = 'red'",
    "SELECT count(*) FROM t1 WHERE s <> 'red'",
    "SELECT count(*) FROM t1 WHERE s LIKE 'r%'",
    "SELECT count(*) FROM t1 WHERE s LIKE '%e%'",
    "SELECT count(*) FROM t1 WHERE s IN ('red', 'blue')",
    "SELECT count(*) FROM t1 WHERE s NOT IN ('red', 'blue')",
    "SELECT count(*) FROM t1 WHERE s ILIKE '%E%'",
    "SELECT k, count(*) FROM t1 WHERE s NOT LIKE '%e%' GROUP BY k",
    "SELECT s, MIN(x), MAX(x) FROM t1 WHERE s > 'blue' GROUP BY s",
    "SELECT k, MIN(s), MAX(s) FROM t1 GROUP BY k",
    "SELECT x, MIN(s) FROM t1 WHERE x > 40 GROUP BY x",
    "SELECT k, s FROM t1 WHERE x = 3 ORDER BY s NULLS FIRST, k",
])
def test_basic_string_predicates(basic, sql):
    _check(basic, sql)


def test_dict_equality_skips_fragments(basic):
    """`s = 'lit'` compares the literal's dictionary id with each
    fragment's id range, as the reference does."""
    _, port = basic
    ex = port.executor
    scan = next(n for n in _topo(port, "SELECT count(*) FROM t1 WHERE s = 'green'")
                if type(n).__name__ == "Scan")
    pred = next(c for c in E.walk(_filter_of(port, "SELECT count(*) FROM t1 WHERE s = 'green'"))
                if isinstance(c, E.DictStrPredicate))
    col, op, sid = ex._simple_qual(pred, scan)
    assert op == "=" and sid == port.dict_by_ref(pred.dict_ref).get_id("green")
    absent = E.DictStrPredicate(arg=pred.arg, kind="CMP", pattern="mauve", cmp_op="=",
                                dict_ref=pred.dict_ref, type=pred.type)
    assert ex._surviving_fragments(scan, absent) == []


def _plan(db, sql):
    from heavydb_tpu_torch.plan.optimizer import optimize
    from heavydb_tpu_torch.sql.parser import parse_many

    return optimize(db._plan_select(parse_many(sql)[0]))


def _topo(db, sql):
    from heavydb_tpu_torch.plan import rel_alg as R

    return list(R.topo_order(_plan(db, sql)))


def _filter_of(db, sql):
    return next(n.filter_cond for n in _topo(db, sql)
                if getattr(n, "filter_cond", None) is not None)


# ---------------------------------------------------------------------------
# caches, the probe, sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sql", [
    "SELECT k, count(*) FROM t1 WHERE s LIKE '%e%' AND s <> 'red' GROUP BY k",
    "SELECT UPPER(s), MIN(s), count(*) FROM t1 GROUP BY UPPER(s)",
    "SELECT s || UPPER(s), count(*) FROM t1 WHERE s < REVERSE(s) GROUP BY s || UPPER(s)",
])
def test_second_run_builds_no_table(basic, sql):
    """A query run again reads the tables and transient dictionaries of
    its first run: its transforms and pair concatenations bind to the same
    transient dictionaries."""
    _, port = basic
    port.sql(sql).rows()
    sizes = (len(port.executor.aux_cache), len(port._transient_dicts),
             len(port.executor.kernel_cache))
    _check(basic, sql)
    assert (len(port.executor.aux_cache), len(port._transient_dicts),
            len(port.executor.kernel_cache)) == sizes


def test_grown_dictionary_rebuilds_its_table():
    """A table's dictionary that grows between two runs gets new tables:
    every cache key carries the dictionary's size."""
    ref, port = _engines(["CREATE TABLE gr (s TEXT, k INT)",
                          "INSERT INTO gr VALUES ('ab', 1), ('cd', 2)"], ["gr"])
    queries = ("SELECT count(*) FROM gr WHERE s LIKE 'ab%'", "SELECT UPPER(s), k FROM gr",
               "SELECT MIN(s), MAX(s) FROM gr", "SELECT k FROM gr ORDER BY s DESC NULLS LAST")
    for q in queries:
        _check((ref, port), q)
    for db in (ref, port):
        db.sql("INSERT INTO gr VALUES ('abz', 3), (NULL, 4), ('aa', 5)")
    for q in queries:
        _check((ref, port), q)


def test_selectivity_probe_counts_string_conjuncts():
    """A string conjunct on a join input is counted by the selectivity
    probe, with the same tables the kernel reads."""
    rng = np.random.default_rng(3)

    def load(ref):
        ref.sql("CREATE TABLE big (k INT, s TEXT)")
        ref.load_table("big", {"k": rng.integers(0, 300, 4000).astype(np.int32),
                               "s": np.array(["ab", "cd", "ef"], object)[
                                   rng.integers(0, 3, 4000)]})
        ref.sql("CREATE TABLE mid (k INT, v INT)")
        ref.load_table("mid", {"k": np.arange(300, dtype=np.int32),
                               "v": rng.integers(0, 9, 300).astype(np.int32)})

    engines = _engines([load], ["big", "mid"])
    _, port = engines
    sql = ("SELECT m.v, count(*) FROM big b JOIN mid m ON b.k = m.k "
           "WHERE b.s LIKE 'a%' AND UPPER(b.s) <> 'XX' GROUP BY m.v")
    _check(engines, sql)
    hits = [v for k, v in port.executor._sel_cache.items() if k[0] == "selprobe"]
    big = port.catalog.get_table("big")
    ids = big.column_values(big.column_by_name("s").col_id)
    want = int((ids == port.dict_by_ref((big.table_id, big.column_by_name("s").col_id))
                .get_id("ab")).sum())
    assert want in hits


def test_empty_dictionary_min_max_and_predicates():
    """A TEXT column whose dictionary has no entry (every row NULL)."""
    engines = _engines(["CREATE TABLE e (s TEXT, k INT)",
                        "INSERT INTO e VALUES (NULL, 1), (NULL, 2), (NULL, 1)"], ["e"])
    for sql in ("SELECT k, MIN(s), MAX(s), COUNT(*) FROM e GROUP BY k",
                "SELECT count(*) FROM e WHERE s LIKE '%'",
                "SELECT count(*) FROM e WHERE s NOT IN ('a')",
                "SELECT UPPER(s), LENGTH(s) FROM e"):
        _check(engines, sql)


# ---------------------------------------------------------------------------
# unit level: _aux_array tables and string_ops
# ---------------------------------------------------------------------------

UNIT_STRINGS = ["", "abc", "ABC", "Grüße", "  pad ", "a,b,c", "naïve café", "42", "-7.5",
                "2024-02-29", "2023-13-01", "12:30:45", "x'y", "100%", "a_b", "日本語",
                '{"k": [1, 2]}', "YWI=", "a%20b", "banana"]


def _unit_strings(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    return [UNIT_STRINGS[i] for i in rng.integers(0, len(UNIT_STRINGS), n)]


@pytest.fixture(scope="module")
def unit():
    """One table of two TEXT columns and a TEXT ENCODING NONE column over
    the unit strings, in both engines."""
    rng = np.random.default_rng(17)
    a = np.array(_unit_strings(1) + [None], object)
    b = np.array(_unit_strings(2) + [None], object)
    n = np.array(_unit_strings(3) + [None], object)

    def load(ref):
        ref.sql("CREATE TABLE u (a TEXT, b TEXT, n TEXT ENCODING NONE, k INT)")
        ref.load_table("u", {"a": a, "b": b, "n": n,
                             "k": rng.integers(0, 5, a.shape[0]).astype(np.int32)})

    return _engines([load], ["u"])


def _exprs_of(db, sql, cls):
    """The expressions of class `cls` in the plan of `sql`."""
    out = {}
    for node in _topo(db, sql):
        for e in X._iter_node_exprs(node):
            for sub in E.walk(e):
                if isinstance(sub, cls):
                    out[sub.key()] = sub
    return list(out.values())


def _ref_exprs_of(ref, sql, cls):
    from heavydb_tpu.exec.executor import _iter_node_exprs
    from heavydb_tpu.plan import rel_alg as JR
    from heavydb_tpu.plan.optimizer import optimize
    from heavydb_tpu.sql.parser import parse_many

    out = {}
    for node in JR.topo_order(optimize(ref._plan_select(parse_many(sql)[0]))):
        for e in _iter_node_exprs(node):
            for sub in JE.walk(e):
                if isinstance(sub, cls):
                    out[sub.key()] = sub
    return list(out.values())


AUX_CASES = [
    ("strpred", "SELECT count(*) FROM u WHERE a LIKE '%a%'", "DictStrPredicate"),
    ("strpred", "SELECT count(*) FROM u WHERE a ILIKE 'A%'", "DictStrPredicate"),
    # the binder makes no REGEXP predicate (no SQL spells it): the LIKE
    # predicate above, made a REGEXP one in both packages
    ("strpred", "SELECT count(*) FROM u WHERE a LIKE '%a%'", "DictStrPredicate",
     dict(kind="REGEXP", pattern="[0-9]+.*|.*ä.*")),
    ("strpred", "SELECT count(*) FROM u WHERE a >= 'b'", "DictStrPredicate"),
    ("strpred", "SELECT count(*) FROM u WHERE a IN ('abc', 'x''y', 'zz')", "DictStrPredicate"),
    ("strpred", "SELECT LENGTH(a) FROM u", "DictStrPredicate"),
    ("strpred", "SELECT POSITION('a' IN a) FROM u", "DictStrPredicate"),
    ("strpred", "SELECT HASH(n) FROM u", "DictStrPredicate"),
    ("strpred", "SELECT TRY_CAST(a AS DOUBLE) FROM u", "DictStrPredicate"),
    ("strpred", "SELECT TRY_CAST(a AS INT) FROM u", "DictStrPredicate"),
    ("strpred", "SELECT TRY_CAST(n AS DECIMAL(10, 2)) FROM u", "DictStrPredicate"),
    ("strpred", "SELECT TRY_CAST(n AS DATE) FROM u", "DictStrPredicate"),
    ("strpred", "SELECT TRY_CAST(a AS TIMESTAMP) FROM u", "DictStrPredicate"),
    ("strpred", "SELECT TRY_CAST(a AS TIME) FROM u", "DictStrPredicate"),
    ("strtransform", "SELECT UPPER(REVERSE(a)) FROM u", "StringTransform"),
    ("strtransform", "SELECT SPLIT_PART(n, ',', 2) FROM u", "StringTransform"),
    ("pairconcat", "SELECT a || b FROM u", "StringPairConcat"),
    ("pairconcat", "SELECT LOWER(a) || n FROM u", "StringPairConcat"),
    ("pairrank", "SELECT count(*) FROM u WHERE a < b", "DictPairCompare"),
    ("pairrank", "SELECT count(*) FROM u WHERE UPPER(a) >= LOWER(n)", "DictPairCompare"),
]


def _host(t):
    if isinstance(t, tuple):
        return tuple(_host(x) for x in t)
    return np.asarray(t.cpu().numpy() if hasattr(t, "cpu") else t)


def _equal_tables(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal_tables(g, w)
        return
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind == "f":
        assert np.array_equal(got, want, equal_nan=True)
    else:
        assert np.array_equal(got, want)


def _transient_strings(db, ref):
    d = db.dict_by_ref(ref)
    return list(d.entries())


@pytest.mark.parametrize("case", AUX_CASES)
def test_aux_tables_match_reference(unit, case):
    """Each `_aux_array` kind against the reference's over the same
    dictionaries: equal tables, and transient dictionaries filled with the
    same strings in the same order."""
    import dataclasses

    kind, sql, cls = case[:3]
    change = case[3] if len(case) > 3 else {}
    ref, port = unit
    want_exprs = _ref_exprs_of(ref, sql, getattr(JE, cls))
    got_exprs = _exprs_of(port, sql, getattr(E, cls))
    assert len(want_exprs) == len(got_exprs) >= 1
    for w, g in zip(want_exprs, got_exprs):
        w, g = dataclasses.replace(w, **change), dataclasses.replace(g, **change)
        want = _host(ref.executor._aux_array((kind, w)))
        got = _host(port.executor._aux_array((kind, g)))
        _equal_tables(got, want)
        if kind in ("strtransform", "pairconcat"):
            assert _transient_strings(port, g.dict_ref) == _transient_strings(ref, w.dict_ref)


@pytest.mark.parametrize("col", ["a", "n"])
def test_rank_order_and_translate_tables_match_reference(unit, col):
    ref, port = unit
    rt, pt = ref.catalog.get_table("u"), port.catalog.get_table("u")
    rref = (rt.table_id, rt.column_by_name(col).col_id)
    pref = (pt.table_id, pt.column_by_name(col).col_id)
    for kind in ("dictrank", "dictorder"):
        _equal_tables(_host(port.executor._aux_array((kind, pref))),
                      _host(ref.executor._aux_array((kind, rref))))
    other = "b" if col == "a" else "a"
    rref2 = (rt.table_id, rt.column_by_name(other).col_id)
    pref2 = (pt.table_id, pt.column_by_name(other).col_id)
    _equal_tables(_host(port.executor._aux_array(("translate", (pref, pref2)))),
                  _host(ref.executor._aux_array(("translate", (rref, rref2)))))


def test_unit_table_queries(unit):
    for sql in ["SELECT k, MIN(a), MAX(b), MIN(n), MAX(n) FROM u GROUP BY k",
                "SELECT n, count(*) FROM u GROUP BY n",
                "SELECT a || b, count(*) FROM u WHERE LENGTH(n) > 3 GROUP BY a || b",
                "SELECT count(*) FROM u WHERE a LIKE 'a%' OR n ILIKE '%É%'",
                "SELECT k, a FROM u ORDER BY UPPER(a) NULLS LAST, k, a LIMIT 12"]:
        _check(unit, sql)


OP_ARGS = {
    "IDENTITY": [()], "GREATEST": [("b", "zz")], "LEAST": [("b",)],
    "UPPER": [()], "UCASE": [()], "LOWER": [()], "LCASE": [()], "INITCAP": [()],
    "REVERSE": [()], "TRIM": [(), ("a ",)], "LTRIM": [(), (" p",)], "RTRIM": [(), ("d ",)],
    "SUBSTRING": [(2,), (1, 3), (-2,), (0, 2)], "SUBSTR": [(2, 2)], "MID": [(3, 1)],
    "REPLACE": [("a", "Z")], "LPAD": [(6,), (3, "*")], "RPAD": [(6, "-="), (2,)],
    "REPEAT": [(2,), (0,)], "SPLIT_PART": [(",", 2), (",", -1), (",", 9)],
    "REGEXP_REPLACE": [("[0-9]+", "#")], "CONCAT": [("!",)], "PRECONCAT": [("<",)],
    "OVERLAY": [("XX", 2), ("Z", 2, 4)], "JSON_VALUE": [("$.k[1]",), ("$.k",)],
    "REGEXP_SUBSTR": [("[aeiou]+",), ("a", 1, 2)], "BASE64_ENCODE": [()],
    "BASE64_DECODE": [()], "URL_ENCODE": [()], "URL_DECODE": [()], "LEFT": [(2,), (0,)],
    "RIGHT": [(3,), (-1,)],
}
INT_FN_ARGS = {"POSITION": [("a",), ("a", 3)], "REGEXP_COUNT": [("a",), ("[0-9]", 2)],
               "LEVENSHTEIN": [("banal",)], "JAROWINKLER": [("martha",)],
               "HASH": [(), (7,)]}


def _same_or_raises(fn_got, fn_want):
    try:
        want = fn_want()
    except (ValueError, JNotSupported) as e:
        with pytest.raises(type(e) if isinstance(e, ValueError) else NotSupported):
            fn_got()
        return
    got = fn_got()
    assert got == want or (isinstance(want, float) and math.isclose(got, want))


@pytest.mark.parametrize("name", sorted(OP_ARGS))
def test_apply_op_matches_reference(name):
    strings = _unit_strings(23) + UNIT_STRINGS
    for args in OP_ARGS[name]:
        for s in strings:
            _same_or_raises(lambda: SO.apply_op(s, name, args),
                            lambda: JSO.apply_op(s, name, args))
        chain = ((name, args), ("UPPER", ()))
        for s in strings + [None]:
            assert SO.apply_chain(s, chain) == JSO.apply_chain(s, chain)


@pytest.mark.parametrize("name", sorted(INT_FN_ARGS))
def test_int_string_fn_matches_reference(name):
    for args in INT_FN_ARGS[name]:
        for s in _unit_strings(29) + UNIT_STRINGS:
            _same_or_raises(lambda: SO.int_string_fn(s, name, args),
                            lambda: JSO.int_string_fn(s, name, args))


def test_unknown_op_and_llm_backend_raise():
    with pytest.raises(ValueError):
        SO.apply_op("a", "NO_SUCH_OP", ())
    with pytest.raises(ValueError):
        SO.int_string_fn("a", "NO_SUCH_FN", ())
    with pytest.raises(NotSupported):
        SO.apply_op("a", "LLM_TRANSFORM", ("p",))



# ---------------------------------------------------------------------------
# tools/synthetic.py: load_strings and STRING_QUERIES
# ---------------------------------------------------------------------------


def test_synthetic_string_queries_match_reference():
    """load_strings on the CPU at 20,000 rows (a 3000-entry cname), and
    every STRING_QUERIES query against the reference over the same
    strings."""
    import heavydb_tpu_torch as hdt_torch
    from heavydb_tpu_torch.tools.synthetic import STRING_QUERIES, load_strings

    port = hdt_torch.connect(device="cpu")
    data, vocab = load_strings(port, 20_000, 5, fragment_rows=8192, customers=3000)
    ref = hdt.connect()
    cols = {}
    for c, t in data.items():
        a = t.numpy()
        if c in vocab:
            words = np.array(vocab[c], object)
            a = np.where(a >= 0, words[np.clip(a, 0, None)], None)
        cols[c] = a
    ref.sql("CREATE TABLE lstr (shipmode TEXT, shipinstruct TEXT, ptype TEXT, cname TEXT, "
            "x10 INT, x100 INT, x1k INT, v FLOAT) WITH (fragment_size=8192)")
    ref.load_table("lstr", cols)
    assert sum(a is None for a in cols["ptype"]) > 0
    for sql in STRING_QUERIES.values():
        _check((ref, port), sql, f32_cols=(1, 2, 3))
