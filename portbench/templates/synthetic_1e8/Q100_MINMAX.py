"""A filtered GROUP BY over 100 groups with COUNT, a FLOAT SUM, MIN and MAX."""

from portbench.refkit import group_count, group_reduce, group_sum, host

SQL = ("SELECT x100, COUNT(*), SUM(v), MIN(x10k), MAX(v) FROM bench "
       "WHERE x10 > {c} GROUP BY x100")
PARAMS = {"c": {"int": [0, 9]}}
READS = {"bench": ["x100", "v", "x10k", "x10"]}
FLOAT = [2]


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    m = b["x10"] > p["c"]
    g = b["x100"][m].long()
    v = ctx.f(b["v"][m])
    cnt = group_count(g, 101)
    s = group_sum(g, v, 101)
    mn = group_reduce(g, b["x10k"][m], 101, "amin")
    mx = group_reduce(g, v, 101, "amax")
    k = (cnt > 0).nonzero().flatten()
    return [host(k), host(cnt[k]), host(s[k].double()), host(mn[k]), host(mx[k].double())]
