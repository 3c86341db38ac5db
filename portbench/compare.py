"""The comparison that decides `correct`: a query's rows against the plain
reference's.

Both sides give a list of columns.  A column is a numpy array (integers,
floats, DATE as days since 1970-01-01), a list of strings, or a `Dec`
(scaled integers and their scale).  Columns whose index the template lists
in FLOAT are compared by relative error; every other value must be equal,
decimals as exact rationals (a float equals a decimal only where it holds
its value exactly).  Rows of a query without ORDER BY are compared
as a set: both sides sorted by their exact values.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np


@dataclass
class Dec:
    """A DECIMAL column: raw scaled integers and the scale."""
    raw: object
    scale: int


def _exact_values(col) -> list:
    """Python values that compare exactly: a decimal as a Fraction, so that
    it equals a float only where the float holds it exactly."""
    if isinstance(col, Dec):
        d = 10 ** col.scale
        return [Fraction(int(v), d) for v in np.asarray(col.raw).tolist()]
    if isinstance(col, list):
        return list(col)
    return np.asarray(col).tolist()


def _float_values(col) -> list:
    if isinstance(col, Dec):
        return [int(v) / 10 ** col.scale for v in np.asarray(col.raw).tolist()]
    return [float(v) for v in np.asarray(col, dtype=np.float64).tolist()]


def _rows(cols, floats) -> list:
    vals = [(_float_values(c) if i in floats else _exact_values(c)) for i, c in enumerate(cols)]
    return list(zip(*vals)) if vals else []


def length(col) -> int:
    return len(col.raw) if isinstance(col, Dec) else len(col)


@dataclass
class Reading:
    """What one comparison found."""
    mismatched: int = 0      # exact values (or whole rows) that differ
    rel_err: float = 0.0     # the largest relative error of a FLOAT value
    values: int = 0          # values compared

    def add(self, other: "Reading") -> None:
        self.mismatched += other.mismatched
        self.rel_err = max(self.rel_err, other.rel_err)
        self.values += other.values


def compare(got: list, want: list, floats=(), ordered: bool = False) -> Reading:
    """Compare the program's columns `got` with the reference's `want`."""
    floats = set(floats)
    ncols = len(want)
    nwant = length(want[0]) if want else 0
    if len(got) != ncols or any(length(c) != nwant for c in got):
        n = max([nwant] + [length(c) for c in got])
        return Reading(mismatched=max(n, 1) * max(ncols, len(got), 1), values=n * ncols)
    rows_g, rows_w = _rows(got, floats), _rows(want, floats)
    if not ordered:
        exact = [i for i in range(ncols) if i not in floats]
        rows_g.sort(key=lambda r: tuple(r[i] for i in exact))
        rows_w.sort(key=lambda r: tuple(r[i] for i in exact))
    out = Reading(values=nwant * ncols)
    for rg, rw in zip(rows_g, rows_w):
        for i, (a, b) in enumerate(zip(rg, rw)):
            if i in floats:
                if a != b:
                    err = abs(a - b) / max(abs(b), 1e-300) if np.isfinite(a) else float("inf")
                    out.rel_err = max(out.rel_err, err)
            elif a != b:
                out.mismatched += 1
    return out
