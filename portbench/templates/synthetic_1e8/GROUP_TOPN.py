"""The Sort family's form (SORT02): 1000 groups, then the top 10 by count."""

import torch

from portbench.refkit import group_count, group_sum, host

SQL = ("SELECT x1k, COUNT(*), SUM(v) FROM bench GROUP BY x1k "
       "ORDER BY 2 DESC, 1 LIMIT 10")
PARAMS = {}
READS = {"bench": ["x1k", "v"]}
FLOAT = [2]
ORDERED = True


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    g = b["x1k"].long()
    cnt = group_count(g, 1001)
    s = group_sum(g, ctx.f(b["v"]), 1001)
    k = (cnt > 0).nonzero().flatten()
    # COUNT descending, then x1k ascending: a stable sort by count of keys in order
    order = torch.sort(cnt[k], descending=True, stable=True).indices[:10]
    k = k[order]
    return [host(k), host(cnt[k]), host(s[k].double())]
