"""10,000 groups with COUNT(*) and a FLOAT SUM."""

from portbench.refkit import group_count, group_sum, host

SQL = "SELECT x10k, COUNT(*), SUM(v) FROM bench GROUP BY x10k"
PARAMS = {}
READS = {"bench": ["x10k", "v"]}
FLOAT = [2]


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    g = b["x10k"].long()
    cnt = group_count(g, 10_001)
    s = group_sum(g, ctx.f(b["v"]), 10_001)
    k = (cnt > 0).nonzero().flatten()
    return [host(k), host(cnt[k]), host(s[k].double())]
