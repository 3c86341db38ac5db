"""BH004 (the synthetic benchmark's high-cardinality group-by): 10^7 dense
INT keys, COUNT(*), then the top 100 by count."""

import torch

from portbench.refkit import group_count, host

SQL = "SELECT x10m, COUNT(*) FROM bench GROUP BY x10m ORDER BY 2 DESC, 1 LIMIT 100"
PARAMS = {}
READS = {"bench": ["x10m"]}
ORDERED = True


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    cnt = group_count(b["x10m"].long(), 10_000_001)
    k = (cnt > 0).nonzero().flatten()
    # COUNT descending, then x10m ascending: a stable sort by count of keys in order
    k = k[torch.sort(cnt[k], descending=True, stable=True).indices[:100]]
    return [host(k), host(cnt[k])]
