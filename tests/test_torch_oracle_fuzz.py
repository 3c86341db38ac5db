"""The port on the CPU against SQLite over the 360 generated queries of
tests/test_oracle_fuzz.py: the same 12 batches of its grammar (filters,
CASE, NULL logic, GROUP BY / HAVING, joins, ORDER BY + LIMIT, set
operations, subqueries, DISTINCT aggregates, string functions) over the
same two tables, made from this file's own seeded generator, through
heavydb_tpu_torch.connect(device="cpu") and tests/test_sqlite_oracle.py's
Oracle (floats within rel 1e-5, abs 1e-6).  The reference's side runs in
that file; it is not run again here.
"""

import numpy as np
import pytest

import heavydb_tpu_torch as hdt_torch
from tests.test_oracle_fuzz import N_QUERIES, Gen
from tests.test_sqlite_oracle import Oracle


@pytest.fixture(scope="module")
def foracle():
    rng = np.random.default_rng(20260817)
    o = Oracle(hdt_torch.connect(device="cpu"))
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
    return o


@pytest.mark.parametrize("batch", range(12))
def test_fuzz_batch(foracle, batch):
    gen = Gen(9000 + batch)
    for qi in range(N_QUERIES // 12):
        q = gen.query()
        try:
            foracle.check(q)
        except Exception as e:
            raise AssertionError(f"seed={9000 + batch} #{qi}: {q}\n"
                                 f"{type(e).__name__}: {e}") from None
