"""NonGroupedAgg NGA03: a filtered COUNT(*), keyless."""

from portbench.refkit import host

SQL = "SELECT COUNT(*) FROM bench WHERE x100 > {lo} AND y100 <= {hi}"
PARAMS = {"lo": {"int": [1, 99]}, "hi": {"int": [1, 100]}}
READS = {"bench": ["x100", "y100"]}


def reference(t, p, ctx):
    b = t["bench"]["columns"]
    n = ((b["x100"] > p["lo"]) & (b["y100"] <= p["hi"])).sum()
    return [host(n.reshape(1))]
