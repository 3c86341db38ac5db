"""The port's COPY FROM / COPY TO against the JAX package.

The COPY cases of tests/test_engine_basic.py (test_copy_roundtrip,
test_copy_autocreate_with_detection, test_copy_to_parquet,
test_native_csv_parser_matches_pandas), tests/test_rowid.py
(test_duplicate_column_csv_export) and tests/test_none_encoded_text.py
(test_copy_csv), each run as one scenario through both packages: the same
rows, types, files and errors.  Then a seeded CSV of every scalar type
through the native parser, through pandas (no_native) and back from
parquet, which give the same rows in both packages and on each path; a
COPY that appends to a fragmented table; and `load_table` prestaging the
table where COPY FROM a CSV does not, as in the reference.

Every value is compared exactly, but sums of DOUBLE values within rtol
1e-9; the data comes from each test's own seeded generator.
"""

import csv
import datetime

import numpy as np
import pandas as pd
import pytest

from heavydb_tpu.io.csv_import import parse_csv_native as jparse_csv_native
from heavydb_tpu_torch.io.csv_import import parse_csv_native
from torch_pair import PORT, both, raises_in_both, same


def _copy_roundtrip(pkg, p):  # test_engine_basic.py:345
    import os

    os.makedirs(p)
    db = pkg.connect()
    db.sql("CREATE TABLE t (x INT, s TEXT)")
    db.sql("INSERT INTO t VALUES (1, 'a'), (2, NULL)")
    out = f"{p}/out.csv"
    r1 = db.sql(f"COPY (SELECT * FROM t) TO '{out}'").rows()
    db.sql("CREATE TABLE t2 (x INT, s TEXT)")
    r2 = db.sql(f"COPY t2 FROM '{out}'").rows()
    return (r1, r2, open(out).read(), db.sql("SELECT count(*) FROM t2").scalar(),
            db.sql("SELECT * FROM t2 ORDER BY x").rows())


def _autocreate(pkg, p):  # test_engine_basic.py:503
    import os

    os.makedirs(p)
    f = f"{p}/data.csv"
    with open(f, "w") as fh:
        fh.write("id,name,score,seen,flag\n1,alice,3.5,2024-01-01,true\n"
                 "2,bob,,2024-02-02,false\n3,,7.25,,true\n")
    db = pkg.connect()
    db.sql(f"COPY newtab FROM '{f}'")
    return (db.sql("SELECT * FROM newtab ORDER BY id").rows(),
            db.sql("DESCRIBE newtab").rows())


def _to_parquet(pkg, p):  # test_engine_basic.py:620
    import os

    os.makedirs(p)
    db = pkg.connect()
    db.sql("CREATE TABLE cp (a INT, s TEXT)")
    db.sql("INSERT INTO cp VALUES (1, 'x'), (2, NULL)")
    out = f"{p}/out.parquet"
    db.sql(f"COPY (SELECT * FROM cp) TO '{out}'")
    df = pd.read_parquet(out)
    return list(df["a"]), [None if pd.isna(v) else v for v in df["s"]], str(df["a"].dtype)


def _duplicate_column_export(pkg, p):  # test_rowid.py:81
    import os

    os.makedirs(p)
    db = pkg.connect()
    db.load_table("a", {"x": np.arange(3, dtype=np.int64)}, create=True)
    out = f"{p}/dup.csv"
    db.sql(f"COPY (SELECT x, x FROM a) TO '{out}'")
    return open(out).read()


def _none_text_copy(pkg, p):  # test_none_encoded_text.py:111
    import os

    os.makedirs(p)
    f = f"{p}/ns.csv"
    with open(f, "w") as fh:
        fh.write("a,b\nfoo,1\nbar,2\n,3\nfoo,4\n")
    db = pkg.connect()
    db.sql("CREATE TABLE cc (a TEXT ENCODING NONE, b INT)")
    db.sql(f"COPY cc FROM '{f}' WITH (header='true')")
    return db.sql("SELECT a, COUNT(*) FROM cc GROUP BY a ORDER BY a").rows()


CASES = {
    "test_engine_basic.py::test_copy_roundtrip": _copy_roundtrip,
    "test_engine_basic.py::test_copy_autocreate_with_detection": _autocreate,
    "test_engine_basic.py::test_copy_to_parquet": _to_parquet,
    "test_rowid.py::test_duplicate_column_csv_export": _duplicate_column_export,
    "test_none_encoded_text.py::test_copy_csv": _none_text_copy,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_copy_cases(tmp_path, name):
    both(tmp_path, CASES[name])


def test_native_csv_parser_matches_reference(tmp_path):
    """test_engine_basic.py:669: quoted fields, doubled quotes, embedded
    delimiters and null markers parse as the reference's native parser and
    as pandas parse them."""
    rng = np.random.default_rng(1611)
    p = tmp_path / "data.csv"
    n = 5000
    with open(p, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["i", "f", "s"])
        for k in range(n):
            w.writerow([int(rng.integers(-10**6, 10**6)) if k % 7 else "",
                        round(float(rng.random() * 100), 3) if k % 5 else "NULL",
                        ['say "hi"', "a,b", "plain", ""][k % 4]])
    names, cols, nrows = parse_csv_native(str(p))
    jnames, jcols, jnrows = jparse_csv_native(str(p))
    assert (names, nrows) == (jnames, jnrows) == (["i", "f", "s"], n)
    np.testing.assert_array_equal(cols[0], jcols[0])
    np.testing.assert_array_equal(cols[1], jcols[1])
    assert cols[2].to_list() == jcols[2].to_list()
    df = pd.read_csv(p, na_values=["NULL", ""], keep_default_na=True)
    np.testing.assert_array_equal(np.nan_to_num(cols[0], nan=-1),
                                  np.nan_to_num(df["i"].to_numpy(), nan=-1))
    np.testing.assert_allclose(np.nan_to_num(cols[1], nan=-1),
                               np.nan_to_num(df["f"].to_numpy(), nan=-1), atol=1e-9)
    assert cols[2].to_list() == [None if isinstance(v, float) else v for v in df["s"]]


def _write_mixed_csv(path, n, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["i", "b", "d", "t", "dt", "ok"])
        for k in range(n):
            w.writerow([int(rng.integers(-1000, 1000)) if k % 11 else "",
                        int(rng.integers(-2**40, 2**40)),
                        repr(float(rng.standard_normal())) if k % 13 else "",
                        ["red", "green", "blue", "", "x,y"][k % 5],
                        (datetime.date(2024, 1, 1) + datetime.timedelta(int(k % 300))).isoformat(),
                        ["true", "false"][k % 2]])


_MIXED_DDL = "CREATE TABLE {} (i INT, b BIGINT, d DOUBLE, t TEXT, dt DATE, ok BOOLEAN)"
_MIXED_Q = ["SELECT i, b, d, t, dt, ok FROM {} ORDER BY rowid",
            "SELECT t, COUNT(*), SUM(d), MIN(i), MAX(b), COUNT(dt) FROM {} GROUP BY t ORDER BY t"]


def _mixed_paths(pkg, p):
    import os

    os.makedirs(p)
    src = f"{p}/mixed.csv"
    _write_mixed_csv(src, 3000, 1612)
    db = pkg.connect()
    out = []
    for name, opts in [("nat", ""), ("pd", " WITH (no_native='true')")]:
        db.sql(_MIXED_DDL.format(name))
        out.append(db.sql(f"COPY {name} FROM '{src}'{opts}").rows())
    db.sql(f"COPY (SELECT * FROM nat) TO '{p}/back.parquet'")
    db.sql(_MIXED_DDL.format("pq"))
    out.append(db.sql(f"COPY pq FROM '{p}/back.parquet'").rows())
    db.sql(f"COPY (SELECT * FROM pd) TO '{p}/back.csv' WITH (delimiter='|')")
    db.sql(_MIXED_DDL.format("bar"))
    out.append(db.sql(f"COPY bar FROM '{p}/back.csv' WITH (delimiter='|')").rows())
    for name in ("nat", "pd", "pq", "bar"):
        out.append([db.sql(q.format(name)).rows() for q in _MIXED_Q])
    return out


def test_csv_native_pandas_parquet_paths(tmp_path):
    got = both(tmp_path, _mixed_paths)
    # the four tables hold the same rows on each path (pandas' float
    # parser may differ from the native one in the last bit)
    rows = [r[0] for r in got[4:]]
    assert len(rows[0]) == 3000
    assert rows[0] == rows[2] and rows[1] == rows[3]
    assert same(rows[0], rows[1])


@pytest.mark.parametrize("opts", ["", " WITH (no_native='true')"])
def test_copy_column_count_error(tmp_path, opts):
    def scenario(pkg, p):
        import os

        os.makedirs(p)
        src = f"{p}/two.csv"
        with open(src, "w") as fh:
            fh.write("a,b\n1,2\n")
        db = pkg.connect()
        db.sql("CREATE TABLE three (a INT, b INT, c INT)")
        db.sql(f"COPY three FROM '{src}'{opts}")

    assert raises_in_both(tmp_path, scenario)[0] == "StorageError"


def _append(pkg, p):
    import os

    os.makedirs(p)
    db = pkg.connect(config=pkg.Config(default_fragment_rows=1000))
    db.sql("CREATE TABLE ap (i INT, b BIGINT, d DOUBLE, t TEXT, dt DATE, ok BOOLEAN)")
    src = f"{p}/m.csv"
    _write_mixed_csv(src, 2500, 1613)
    out = []
    for _ in range(2):
        db.sql(f"COPY ap FROM '{src}'")
        t = db.catalog.get_table("ap")
        out.append(([f.num_rows for f in t.fragments],
                    db.sql("SELECT COUNT(*), SUM(i), MAX(dt) FROM ap").rows()))
    return out


def test_copy_appends_fragments(tmp_path):
    got = both(tmp_path, _append)
    assert got[1][0] == [1000, 1000, 1000, 1000, 1000]


def test_load_table_prestages_copy_does_not(tmp_path):
    """load_table (and so the GeoJSON and raster imports) uploads a table
    of eager_staging_min_rows rows or more at once when staging is on; a
    COPY FROM a CSV inserts straight into the table, as the reference's
    import_csv does, and its rows upload at the first scan."""
    cfg = PORT.Config(eager_device_staging=True, eager_staging_min_rows=100)
    db = PORT.connect(config=cfg)
    rng = np.random.default_rng(1614)
    db.load_table("lt", {"k": rng.integers(0, 9, 500).astype(np.int32)}, create=True)
    t = db.catalog.get_table("lt")
    assert {k[0] for k, _ in db.executor.scan_cache.items()} == {t.table_id}
    src = tmp_path / "c.csv"
    src.write_text("k\n" + "\n".join(str(v) for v in range(500)) + "\n")
    db.sql("CREATE TABLE ct (k INT)")
    db.sql(f"COPY ct FROM '{src}'")
    ct = db.catalog.get_table("ct")
    assert not [k for k, _ in db.executor.scan_cache.items() if k[0] == ct.table_id]
    assert db.sql("SELECT COUNT(*), SUM(k) FROM ct").rows() == [(500, 124750)]
