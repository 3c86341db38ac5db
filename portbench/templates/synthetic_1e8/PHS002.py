"""PerfectHashSingleCol PHS002: 1000 groups, an integer SUM."""

from portbench.refkit import group_count, group_sum, host

SQL = "SELECT x1k, COUNT(*), SUM(y10) FROM bench GROUP BY x1k"
PARAMS = {}
READS = {"bench": ["x1k", "y10"]}


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    g = b["x1k"].long()
    cnt = group_count(g, 1001)
    s = group_sum(g, b["y10"].long(), 1001)
    k = (cnt > 0).nonzero().flatten()
    return [host(k), host(cnt[k]), host(s[k])]
