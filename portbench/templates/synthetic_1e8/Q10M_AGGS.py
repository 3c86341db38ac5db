"""A filtered GROUP BY over 10^7 dense INT keys with COUNT, an integer SUM,
a FLOAT SUM, MIN and MAX, then the top 100 by count."""

import torch

from portbench.refkit import group_count, group_reduce, group_sum, host

SQL = ("SELECT x10m, COUNT(*), SUM(x100), SUM(v), MIN(x10k), MAX(v) FROM bench "
       "WHERE x10 > {c} GROUP BY x10m ORDER BY 2 DESC, 1 LIMIT 100")
PARAMS = {"c": {"int": [0, 9]}}
READS = {"bench": ["x10m", "x100", "v", "x10k", "x10"]}
FLOAT = [3]
ORDERED = True


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    m = b["x10"] > p["c"]
    g = b["x10m"][m].long()
    v = ctx.f(b["v"][m])
    n = 10_000_001
    cnt = group_count(g, n)
    k = (cnt > 0).nonzero().flatten()
    # COUNT descending, then x10m ascending: a stable sort by count of keys in order
    k = k[torch.sort(cnt[k], descending=True, stable=True).indices[:100]]
    return [host(k), host(cnt[k]), host(group_sum(g, b["x100"][m].long(), n)[k]),
            host(group_sum(g, v, n)[k].double()),
            host(group_reduce(g, b["x10k"][m], n, "amin")[k]),
            host(group_reduce(g, v, n, "amax")[k].double())]
