"""BH003 (the synthetic benchmark's high-cardinality group-by): 10^6
sparse BIGINT keys of step 10,000, COUNT(*) and an integer SUM, then the
top 100 by count."""

import torch

from portbench.refkit import group_sum, host

SQL = ("SELECT x1m_s10k, COUNT(*), SUM(y100) FROM bench GROUP BY x1m_s10k "
       "ORDER BY 2 DESC, 1 LIMIT 100")
PARAMS = {}
READS = {"bench": ["x1m_s10k", "y100"]}
ORDERED = True


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    keys, inv, cnt = torch.unique(b["x1m_s10k"], return_inverse=True, return_counts=True)
    s = group_sum(inv, b["y100"].long(), keys.numel())
    # COUNT descending, then the key ascending: a stable sort by count of keys in order
    order = torch.sort(cnt, descending=True, stable=True).indices[:100]
    return [host(keys[order]), host(cnt[order]), host(s[order])]
