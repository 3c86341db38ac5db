"""Draws of a template's substitution parameters from a numpy Generator.

A template's PARAMS maps each slot of its SQL to one of:

- {"int": [lo, hi]}: an integer uniform in [lo, hi];
- {"choice": [a, b, ...]}: one of the values, uniformly;
- {"sample": [[a, b, ...], k]}: k distinct values, a list (slots `{name[0]}`...);
- {"month": ["YYYY-MM", "YYYY-MM"]}: the first day of a month uniform in the range;
- {"day": ["YYYY-MM-DD", "YYYY-MM-DD"]}: a day uniform in the range;
- {"hundredths": [lo, hi]}: a decimal string k / 100 for k uniform in [lo, hi].
"""

from __future__ import annotations

import datetime as dt


def _month_index(s: str) -> int:
    y, m = s.split("-")[:2]
    return int(y) * 12 + int(m) - 1


def draw_one(spec: dict, rng):
    (kind, arg), = spec.items()
    if kind == "int":
        return int(rng.integers(arg[0], arg[1] + 1))
    if kind == "choice":
        return arg[int(rng.integers(0, len(arg)))]
    if kind == "sample":
        values, k = arg
        return [values[i] for i in rng.choice(len(values), size=k, replace=False)]
    if kind == "month":
        m = int(rng.integers(_month_index(arg[0]), _month_index(arg[1]) + 1))
        return f"{m // 12:04d}-{m % 12 + 1:02d}-01"
    if kind == "day":
        a, b = (dt.date.fromisoformat(x) for x in arg)
        return (a + dt.timedelta(days=int(rng.integers(0, (b - a).days + 1)))).isoformat()
    if kind == "hundredths":
        k = int(rng.integers(arg[0], arg[1] + 1))
        return f"{k // 100}.{k % 100:02d}"
    raise ValueError(f"unknown parameter kind {kind!r}")


def draw(params: dict, rng) -> dict:
    """One draw of every slot, in the order PARAMS lists them."""
    return {name: draw_one(spec, rng) for name, spec in params.items()}
