"""A filtered top-k of rows: the 100 largest FLOAT values, ties in order of
the key."""

import torch

from portbench.refkit import host

SQL = "SELECT x10m, v FROM bench WHERE x10 > {c} ORDER BY v DESC, x10m LIMIT 100"
PARAMS = {"c": {"int": [0, 9]}}
READS = {"bench": ["x10m", "v", "x10"]}
ORDERED = True


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    m = b["x10"] > p["c"]
    x, v = b["x10m"][m], ctx.f(b["v"][m])
    # every row that ties with the 100th value, then v descending, x10m ascending
    rows = (v >= torch.topk(v, min(100, v.numel())).values[-1]).nonzero().flatten()
    rows = rows[torch.sort(x[rows], stable=True).indices]
    rows = rows[torch.sort(v[rows], descending=True, stable=True).indices[:100]]
    return [host(x[rows]), host(v[rows].double())]
