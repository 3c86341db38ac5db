"""1000 groups with MIN of an INT, MAX and AVG of a FLOAT."""

from portbench.refkit import group_count, group_reduce, group_sum, host

SQL = "SELECT x1k, MIN(x10k), MAX(v), AVG(v) FROM bench GROUP BY x1k"
PARAMS = {}
READS = {"bench": ["x1k", "x10k", "v"]}
FLOAT = [3]


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    g = b["x1k"].long()
    v = ctx.f(b["v"])
    cnt = group_count(g, 1001)
    mn = group_reduce(g, b["x10k"], 1001, "amin")
    mx = group_reduce(g, v, 1001, "amax")
    avg = group_sum(g, v, 1001) / cnt.to(ctx.fdt)
    k = (cnt > 0).nonzero().flatten()
    return [host(k), host(mn[k]), host(mx[k].double()), host(avg[k].double())]
