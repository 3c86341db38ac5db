"""A top-k of rows by three keys, the first descending, over the whole
table."""

import torch

from portbench.refkit import host

SQL = "SELECT x1k, v, x10k FROM bench ORDER BY x1k DESC, v, x10k LIMIT 50"
PARAMS = {}
READS = {"bench": ["x1k", "v", "x10k"]}
ORDERED = True


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    # every row that ties with the 50th x1k, then sorted by the keys, last first
    rows = (b["x1k"] >= torch.topk(b["x1k"], min(50, b["x1k"].numel())).values[-1]) \
        .nonzero().flatten()
    x, v, z = b["x1k"][rows], ctx.f(b["v"][rows]), b["x10k"][rows]
    o = torch.sort(z, stable=True).indices
    o = o[torch.sort(v[o], stable=True).indices]
    o = o[torch.sort(x[o], descending=True, stable=True).indices[:50]]
    return [host(x[o]), host(v[o].double()), host(z[o])]
