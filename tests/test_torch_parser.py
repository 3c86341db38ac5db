"""The port's SQL front end (heavydb_tpu_torch/sql/, a copy of the
reference's) against the reference parser.

The 13 cases of tests/test_parser.py: each statement parses in both
packages to the same tree (the dataclasses' reprs, which name no
module), and the reference test's checks hold on the port's tree; a bad
statement raises ParserError with the same message in both.  Then the
statements of the storage and import surface (COPY, DUMP / RESTORE,
servers, foreign tables, REFRESH) parse the same in both.
"""

import pytest

from heavydb_tpu.errors import ParserError as JParserError
from heavydb_tpu.sql.parser import parse as jparse
from heavydb_tpu.sql.parser import parse_many as jparse_many
from heavydb_tpu_torch.errors import ParserError
from heavydb_tpu_torch.sql import ast as A
from heavydb_tpu_torch.sql.parser import parse, parse_many


def _same(sql):
    """The port's tree of sql, checked equal to the reference's."""
    got = parse(sql)
    assert repr(got) == repr(jparse(sql))
    return got


def test_select_basic():
    s = _same("SELECT a, b AS bb, 1+2 FROM t WHERE a > 1")
    assert isinstance(s, A.Select)
    assert len(s.projections) == 3
    assert s.projections[1][1] == "bb"
    assert isinstance(s.where, A.Binary)


def test_joins():
    j = _same("SELECT * FROM a JOIN b ON a.k = b.k LEFT OUTER JOIN c ON b.j = c.j").from_
    assert isinstance(j, A.JoinRef) and j.kind == "LEFT"
    assert isinstance(j.left, A.JoinRef) and j.left.kind == "INNER"


def test_right_join_swapped():
    j = _same("SELECT * FROM a RIGHT JOIN b ON a.k = b.k").from_
    assert j.kind == "LEFT"
    assert j.left.name == "b" and j.right.name == "a"


def test_group_order_limit():
    s = _same("SELECT x, count(*) c FROM t GROUP BY x HAVING count(*) > 1 "
              "ORDER BY c DESC NULLS LAST LIMIT 5 OFFSET 2")
    assert len(s.group_by) == 1 and s.having is not None
    assert s.order_by[0].asc is False and s.order_by[0].nulls_first is False
    assert s.limit == 5 and s.offset == 2


def test_case_simple_rewrite():
    c = _same("SELECT CASE x WHEN 1 THEN 'a' ELSE 'b' END FROM t").projections[0][0]
    assert isinstance(c, A.CaseWhen)
    assert isinstance(c.whens[0][0], A.Binary) and c.whens[0][0].op == "="


def test_string_escapes():
    assert _same("SELECT 'it''s'").projections[0][0].value == "it's"


def test_numeric_literals():
    s = _same("SELECT 1, 2.5, 1e3, .5, -7")
    kinds = [p[0].kind if isinstance(p[0], A.Literal) else None for p in s.projections]
    assert kinds[:3] == ["num_int", "num_decimal", "num_float"]


def test_in_between_like():
    s = _same("SELECT 1 FROM t WHERE a IN (1,2) AND b NOT BETWEEN 1 AND 2 "
              "AND c LIKE 'x%' ESCAPE '!' AND d NOT ILIKE 'y_'")
    assert s.where is not None


def test_create_table():
    s = _same("CREATE TABLE IF NOT EXISTS t (a INT NOT NULL, b DECIMAL(10,2), "
              "c TEXT ENCODING DICT(32), d TIMESTAMP(3)) WITH (fragment_size=1000)")
    assert s.if_not_exists and len(s.columns) == 4
    assert s.columns[1].type_name.params == (10, 2)
    assert s.columns[2].type_name.encoding == "DICT"
    assert s.options["fragment_size"] == 1000


def test_ctas_and_union_and_cte():
    assert _same("CREATE TABLE t2 AS SELECT * FROM t").as_select is not None
    s = _same("WITH c AS (SELECT 1) SELECT * FROM c UNION ALL SELECT 2")
    assert s.ctes and s.set_ops[0][0] == "UNION ALL"


@pytest.mark.parametrize("sql", ["SELECT FROM t", "SELECT 1 FROM t WHERE", "FROB x"])
def test_errors(sql):
    with pytest.raises(JParserError) as jerr:
        jparse(sql)
    with pytest.raises(ParserError) as err:
        parse(sql)
    assert str(err.value) == str(jerr.value)


def test_multi_statements():
    out = parse_many("SELECT 1; SELECT 2;")
    assert len(out) == 2
    assert repr(out) == repr(jparse_many("SELECT 1; SELECT 2;"))


def test_window_syntax():
    w = _same("SELECT ROW_NUMBER() OVER (PARTITION BY a ORDER BY b DESC) FROM t").projections[0][0]
    assert isinstance(w, A.WindowFuncCall)
    assert len(w.spec.partition_by) == 1


@pytest.mark.parametrize("sql", [
    "COPY t FROM '/data/x.csv' WITH (delimiter='|', header='false', no_native='true')",
    "COPY (SELECT a, b FROM t WHERE a > 1) TO '/data/out.parquet'",
    "DUMP TABLE t TO '/data/t.tgz'",
    "RESTORE TABLE t FROM '/data/t.tgz'",
    "CREATE SERVER IF NOT EXISTS s FOREIGN DATA WRAPPER delimited_file "
    "WITH (base_path='/data', storage_type='LOCAL_FILE')",
    "DROP SERVER IF EXISTS s",
    "SHOW SERVERS",
    "CREATE FOREIGN TABLE ft (a INT, b TEXT) SERVER s "
    "WITH (file_path='x.csv', refresh_timing_type='SCHEDULED', refresh_interval='1S')",
    "CREATE FOREIGN TABLE fp SERVER default_local_parquet WITH (file_path='d.parquet')",
    "REFRESH FOREIGN TABLES ft, fp",
])
def test_storage_statements_parse_alike(sql):
    _same(sql)
