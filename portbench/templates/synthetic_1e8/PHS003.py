"""PerfectHashSingleCol PHS003: 100,000 groups, COUNT(*)."""

from portbench.refkit import group_count, host

SQL = "SELECT x100k, COUNT(*) FROM bench GROUP BY x100k"
PARAMS = {}
READS = {"bench": ["x100k"]}


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    cnt = group_count(b["x100k"].long(), 100_001)
    k = (cnt > 0).nonzero().flatten()
    return [host(k), host(cnt[k])]
