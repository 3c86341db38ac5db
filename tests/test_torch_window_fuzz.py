"""Window functions: the generated queries of tests/test_window_fuzz.py
through heavydb_tpu_torch and the JAX package.

Its four seeded batches of 15 queries (partition or none; INT, DOUBLE,
dictionary-string and mixed ORDER BY keys; ROWS and RANGE frames; WHERE
filters under the window) over its 600-row table w1, made from its seed,
each giving the reference's rows in order.  Tolerances as
tests/test_torch_window.py: integers and strings exact, DOUBLE rtol 1e-9.
"""

import random

import numpy as np
import pytest

from tests.test_torch_window import _both, _check


class WGen:
    """tests/test_window_fuzz.py's query generator."""
    FUNCS = [
        "ROW_NUMBER()", "RANK()", "DENSE_RANK()",
        "COUNT(*)", "COUNT(v)", "SUM(v)", "MIN(v)", "MAX(v)",
        "LAG(v)", "LEAD(v)", "FIRST_VALUE(v)", "LAST_VALUE(v)",
    ]
    FRAMES = [
        "",
        " ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW",
        " ROWS BETWEEN 2 PRECEDING AND CURRENT ROW",
        " ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING",
        " ROWS BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING",
        " RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW",
    ]

    def __init__(self, seed):
        self.r = random.Random(seed)

    def query(self):
        r = self.r
        fn = r.choice(self.FUNCS)
        frame = ""
        if fn.split("(")[0] in ("COUNT", "SUM", "MIN", "MAX",
                                "FIRST_VALUE", "LAST_VALUE"):
            frame = r.choice(self.FRAMES)
        part = r.choice(["", "PARTITION BY p"])
        order = r.choice([
            "ORDER BY o, rid",
            "ORDER BY f, rid",
            "ORDER BY s, rid",
            "ORDER BY o, s, rid",
        ]) if not frame.strip().startswith("RANGE") else "ORDER BY o, rid"
        spec = " ".join(x for x in (part, order) if x) + frame
        where = r.choice(["", "WHERE o < 40", "WHERE p <> 3"])
        return (f"SELECT rid, {fn} OVER ({spec}) FROM w1 {where} "
                "ORDER BY rid")


@pytest.fixture(scope="module")
def fuzz_dbs():
    """tests/test_window_fuzz.py's table w1, from its seed."""
    rng = np.random.default_rng(31415)
    n = 600
    cols = {
        "p": [int(v) for v in rng.integers(0, 7, n)],
        "o": [int(v) for v in rng.integers(0, 50, n)],
        "v": [None if i % 11 == 0 else float(round(x, 2))
              for i, x in enumerate(rng.normal(0, 10, n))],
        "f": [float(round(x, 1)) for x in rng.normal(0, 3, n)],
        "s": [f"t{int(v)}" for v in rng.integers(0, 9, n)],
        "rid": list(range(n)),
    }
    return _both(["CREATE TABLE w1 (p INT, o INT, v DOUBLE, f DOUBLE, s TEXT, rid INT)"],
                 [("w1", cols)])


@pytest.mark.parametrize("batch", range(4))
def test_window_fuzz(fuzz_dbs, batch):
    gen = WGen(2718 + batch)
    for qi in range(15):
        q = gen.query()
        try:
            _check(fuzz_dbs, q)
        except Exception as e:
            raise AssertionError(f"seed={2718 + batch} #{qi}: {q}\n{type(e).__name__}: {e}") \
                from None
