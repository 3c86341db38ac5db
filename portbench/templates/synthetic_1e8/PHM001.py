"""PerfectHashMultiCol PHM001: two keys of 10 values each, 100 groups."""

from portbench.refkit import group_count, group_sum, host

SQL = "SELECT x10, y10, COUNT(*), AVG(x100) FROM bench GROUP BY x10, y10"
PARAMS = {}
READS = {"bench": ["x10", "y10", "x100"]}
FLOAT = [3]


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    g = (b["x10"].long() - 1) * 10 + (b["y10"].long() - 1)
    cnt = group_count(g, 100)
    avg = group_sum(g, ctx.f(b["x100"]), 100) / cnt.to(ctx.fdt)
    keep = cnt > 0
    k = keep.nonzero().flatten()
    return [host(k // 10 + 1), host(k % 10 + 1), host(cnt[keep]), host(avg[keep].double())]
