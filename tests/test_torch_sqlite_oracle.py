"""The port on the CPU against SQLite, the oracle the reference is held
to: the 63 queries of tests/test_sqlite_oracle.py, its integer-division
case and its UPDATE / DELETE case, over the same tables made from this
file's own seeded generator (heavydb_tpu_torch.connect(device="cpu")
through that file's Oracle: the same rows as SQLite, as a multiset unless
the query orders them; floats within rel 1e-5, abs 1e-6).
"""

import numpy as np
import pytest

import heavydb_tpu_torch as hdt_torch
from tests.test_sqlite_oracle import QUERIES, Oracle


def _oracle():
    rng = np.random.default_rng(42)
    o = Oracle(hdt_torch.connect(device="cpu"))
    n = 2000
    x = [int(v) if i % 11 else None for i, v in enumerate(rng.integers(-50, 50, n))]
    y = [float(round(v, 3)) if i % 7 else None for i, v in enumerate(rng.normal(0, 100, n))]
    s = [None if i % 13 == 0 else ["red", "green", "blue", "amber", "x'y"][v]
         for i, v in enumerate(rng.integers(0, 5, n))]
    k = [int(v) for v in rng.integers(0, 20, n)]
    big = [int(v) for v in rng.integers(-(2**40), 2**40, n)]
    o.load("t1", {"x": x, "y": y, "s": s, "k": k, "big": big},
           {"x": "INT", "y": "DOUBLE", "s": "TEXT", "k": "INT", "big": "BIGINT"})
    m = 300
    o.load("t2", {"k": [int(v) for v in rng.integers(0, 25, m)],
                  "w": [float(round(v, 2)) for v in rng.uniform(0, 10, m)],
                  "tag": [["red", "green", "cyan"][v] for v in rng.integers(0, 3, m)]},
           {"k": "INT", "w": "DOUBLE", "tag": "TEXT"})
    return o


@pytest.fixture(scope="module")
def oracle():
    return _oracle()


@pytest.mark.parametrize("sql", QUERIES, ids=lambda q: q[:60])
def test_oracle(oracle, sql):
    oracle.check(sql)


def test_oracle_int_division(oracle):
    oracle.check("SELECT x / 3 FROM t1 WHERE x IS NOT NULL ORDER BY x LIMIT 7")


def test_oracle_update_delete():
    o = _oracle()
    for s in ["UPDATE t1 SET x = x + 100 WHERE k = 3", "DELETE FROM t1 WHERE k = 7",
              "UPDATE t1 SET y = 0.0 WHERE y IS NULL"]:
        o.db.sql(s)
        o.lite.execute(s)
    o.check("SELECT count(*), sum(x), sum(y) FROM t1")
    o.check("SELECT k, count(*) FROM t1 GROUP BY k ORDER BY k")
