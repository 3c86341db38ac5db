"""Faults F3 and F4 of the port, held to the JAX package on the CPU path.

F3: a FLOAT / DOUBLE -> integer CAST out of the target's range saturates
at the range's ends, as the reference's XLA convert does (one at
INT_MIN's end is the NULL sentinel, so NULL); NaN and NULL give NULL.
Every integer target (TINYINT, SMALLINT, INT, BIGINT) over 1e300, -1e300,
3e9, -3e9, +-inf, NaN and 3e38 as FLOAT, and over random values around
each target's range.

F4: ROUND / TRUNCATE of a FLOAT scale, round and divide in float64, then
give a FLOAT, as the reference does: 20,000 values at half-way points
(x.xxx5), values near FLT_MAX (ROUND(f, 1) of 3e38 is 3e38, not inf),
and negative digit counts.

Every value is compared bit for bit.
"""

import numpy as np
import pytest

from torch_pair import PORT, REF

_TARGETS = ["TINYINT", "SMALLINT", "INT", "BIGINT"]
_EDGES = [1e300, -1e300, 3e9, -3e9, float("inf"), float("-inf"), float("nan"),
          3e38, -3e38, 2.0**63, -2.0**63, 2.0**31, -2.0**31 - 1, 127.9, -128.5,
          32767.5, -32768.9, 0.0, -0.0, 1.5, -2.5]


def _rows(db, sql):
    return [tuple(np.float32(v).tobytes() if isinstance(v, float) else v for v in r)
            for r in db.sql(sql).rows()]


def _load(values, ty):
    """Table c (id, x) in each package, x the values as FLOAT (past its
    range: +-inf) or DOUBLE, and one NULL."""
    with np.errstate(over="ignore"):
        vals = np.asarray(values, np.float32 if ty == "FLOAT" else np.float64)
    out = []
    for pkg in (REF, PORT):
        db = pkg.connect()
        db.sql(f"CREATE TABLE c (id INT, x {ty})")
        db.load_table("c", {"id": np.arange(len(vals), dtype=np.int32), "x": vals})
        db.sql(f"INSERT INTO c VALUES ({len(vals)}, NULL)")
        out.append(db)
    return out


@pytest.mark.parametrize("src", ["DOUBLE", "FLOAT"])
@pytest.mark.parametrize("target", _TARGETS)
def test_float_to_int_cast_saturates(src, target):
    rng = np.random.default_rng(1631)
    bound = {"TINYINT": 2**7, "SMALLINT": 2**15, "INT": 2**31, "BIGINT": 2**63}[target]
    vals = _EDGES + list(rng.uniform(-2.5 * bound, 2.5 * bound, 2000))
    ref, port = _load(vals, src)
    for sql in [f"SELECT id, CAST(x AS {target}) FROM c ORDER BY id",
                f"SELECT COUNT(*), SUM(CAST(x AS {target})) FROM c WHERE CAST(x AS {target}) > 0"]:
        assert port.sql(sql).rows() == ref.sql(sql).rows(), sql


def test_named_cast_values():
    """The values of the fault's report, one by one."""
    ref, port = _load([1e300, 3e9, -1e300, -3e9, float("-inf")], "DOUBLE")
    got = {t: [r[0] for r in port.sql(f"SELECT CAST(x AS {t}) FROM c ORDER BY id").rows()]
           for t in _TARGETS}
    assert got["INT"][:2] == [2147483647, 2147483647]
    assert got["BIGINT"][0] == 9223372036854775807
    assert got["SMALLINT"] == [32767, 32767, None, None, None, None]
    for t in _TARGETS:
        assert got[t] == [r[0] for r in ref.sql(f"SELECT CAST(x AS {t}) FROM c "
                                                f"ORDER BY id").rows()]
    ref, port = _load([3e38], "FLOAT")
    assert port.sql("SELECT CAST(x AS INT) FROM c WHERE id = 0").rows() == [(2147483647,)]


def _halfway(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 100_000, n) / 1000 + 0.0005).astype(np.float32)


@pytest.mark.parametrize("fn", ["ROUND", "TRUNCATE"])
@pytest.mark.parametrize("digits", [3, 1, 0, -2])
def test_round_truncate_float_in_float64(fn, digits):
    vals = np.concatenate([_halfway(20_000, 1632),
                           np.array([47.3185, 3e38, -3e38, 3.4e38, 1e-40, -0.0005], np.float32)])
    ref, port = _load(vals, "FLOAT")
    sql = f"SELECT id, {fn}(x, {digits}) FROM c ORDER BY id"
    got, want = _rows(port, sql), _rows(ref, sql)
    assert got == want
    assert str(port.sql(sql).types[1]) == str(ref.sql(sql).types[1]) == "FLOAT"


def test_round_named_values():
    ref, port = _load([47.3185, 3e38], "FLOAT")
    got = port.sql("SELECT ROUND(x, 3), ROUND(x, 1), TRUNCATE(x, 3) FROM c ORDER BY id").rows()
    assert got[0][0] == float(np.float32(47.319))
    assert got[1][1] == float(np.float32(3e38))
    assert got == ref.sql("SELECT ROUND(x, 3), ROUND(x, 1), TRUNCATE(x, 3) FROM c "
                          "ORDER BY id").rows()
