"""What the plain references share: the precision they compute in, and
DECIMAL arithmetic that is exact or, for the control, in float64 units.

Plain torch only: nothing here imports the port.
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass

import numpy as np
import torch

from portbench.compare import Dec


@dataclass
class Ctx:
    """How a reference computes: `fdt` is the dtype of FLOAT / DOUBLE
    arithmetic (float64 for the truth, the configuration's control dtype for
    the control), and `exact` says whether DECIMAL arithmetic is exact
    (scaled int64) or in float64 units (the control)."""
    device: torch.device
    fdt: torch.dtype = torch.float64
    exact: bool = True

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.fdt)

    def fixed(self, raw: torch.Tensor, scale: int) -> "Fixed":
        """A DECIMAL column given as scaled integers."""
        if self.exact:
            return Fixed(raw.to(torch.int64), scale, True)
        return Fixed(raw.to(torch.float64) / 10 ** scale, scale, False)

    def const(self, value: int) -> "Fixed":
        """An integer as a decimal scalar of scale 0."""
        dtype = torch.int64 if self.exact else torch.float64
        return Fixed(torch.tensor(value, dtype=dtype, device=self.device), 0, self.exact)


class Fixed:
    """A decimal tensor: scaled int64 when `exact`, else float64 units whose
    `scale` is only the scale a result is rounded to."""

    def __init__(self, v: torch.Tensor, scale: int, exact: bool):
        self.v, self.scale, self.exact = v, scale, exact

    def _align(self, o: "Fixed"):
        if not self.exact:
            return self.v, o.v, max(self.scale, o.scale)
        s = max(self.scale, o.scale)
        return self.v * 10 ** (s - self.scale), o.v * 10 ** (s - o.scale), s

    def __add__(self, o: "Fixed") -> "Fixed":
        a, b, s = self._align(o)
        return Fixed(a + b, s, self.exact)

    def __sub__(self, o: "Fixed") -> "Fixed":
        a, b, s = self._align(o)
        return Fixed(a - b, s, self.exact)

    def __mul__(self, o: "Fixed") -> "Fixed":
        return Fixed(self.v * o.v, self.scale + o.scale, self.exact)

    def where(self, mask: torch.Tensor) -> "Fixed":
        """The values where `mask`, 0 elsewhere."""
        return Fixed(torch.where(mask, self.v, torch.zeros_like(self.v)), self.scale, self.exact)

    def __getitem__(self, idx) -> "Fixed":
        return Fixed(self.v[idx], self.scale, self.exact)

    def sum(self) -> "Fixed":
        return Fixed(self.v.sum().reshape(1), self.scale, self.exact)

    def sum_by(self, index: torch.Tensor, n: int) -> "Fixed":
        out = torch.zeros(n, dtype=self.v.dtype, device=self.v.device)
        return Fixed(out.index_add_(0, index, self.v), self.scale, self.exact)

    def units(self) -> torch.Tensor:
        """float64 units (for a quotient or an ordering)."""
        return self.v.double() / 10 ** self.scale if self.exact else self.v

    def dec(self):
        """The column as the comparison takes it: a Dec, or the control's
        float64 values."""
        if self.exact:
            return Dec(self.v.cpu().numpy(), self.scale)
        return self.v.cpu().numpy()


def group_count(index: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(index, minlength=n)


def group_sum(index: torch.Tensor, values: torch.Tensor, n: int) -> torch.Tensor:
    """Per-group sums, accumulated in values' dtype."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)


def group_reduce(index: torch.Tensor, values: torch.Tensor, n: int, how: str) -> torch.Tensor:
    """Per-group "amin" / "amax" (groups with no row hold garbage)."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, index, values, how, include_self=False)


def host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def index_of(keys: torch.Tensor, probe: torch.Tensor):
    """For each probe value, the row of `keys` (unique) that holds it, and
    whether one does: a sort and a binary search."""
    order = torch.argsort(keys)
    sk = keys[order]
    pos = torch.searchsorted(sk, probe.to(sk.dtype)).clamp_(max=max(sk.numel() - 1, 0))
    found = sk[pos] == probe
    return order[pos], found


EPOCH = dt.date(1970, 1, 1)


def days(iso: str) -> int:
    """DATE 'YYYY-MM-DD' as days since 1970-01-01, the port's DATE value."""
    return (dt.date.fromisoformat(iso) - EPOCH).days


def add_months(iso: str, months: int) -> str:
    """DATE iso + INTERVAL months MONTH, for a first day of a month or any
    day that exists in the target month."""
    d = dt.date.fromisoformat(iso)
    m = d.year * 12 + d.month - 1 + months
    return d.replace(year=m // 12, month=m % 12 + 1).isoformat()

