"""BH002 (the synthetic benchmark's high-cardinality group-by): 10,000
sparse BIGINT keys of step 10,000, COUNT(*), then the top 100 by count."""

import torch

from portbench.refkit import host

SQL = ("SELECT x10k_s10k, COUNT(*) FROM bench GROUP BY x10k_s10k "
       "ORDER BY 2 DESC, 1 LIMIT 100")
PARAMS = {}
READS = {"bench": ["x10k_s10k"]}
ORDERED = True


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    keys, cnt = torch.unique(b["x10k_s10k"], return_counts=True)
    # COUNT descending, then the key ascending: a stable sort by count of keys in order
    order = torch.sort(cnt, descending=True, stable=True).indices[:100]
    return [host(keys[order]), host(cnt[order])]
