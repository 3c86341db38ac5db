"""TPC-H Q4, the order priority checking query, in the specification's text."""

import torch

from portbench.refkit import add_months, days, host, index_of

SQL = ("SELECT o_orderpriority, COUNT(*) AS order_count FROM orders "
       "WHERE o_orderdate >= DATE '{date}' AND o_orderdate < DATE '{date}' + INTERVAL '3' MONTH "
       "AND EXISTS (SELECT * FROM lineitem WHERE l_orderkey = o_orderkey "
       "AND l_commitdate < l_receiptdate) "
       "GROUP BY o_orderpriority ORDER BY o_orderpriority")
PARAMS = {"date": {"month": ["1993-01", "1997-10"]}}
READS = {"orders": ["o_orderpriority", "o_orderdate", "o_orderkey"],
         "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"]}
ORDERED = True


def reference(t, p, ctx):
    o, li = t["orders"]["columns"], t["lineitem"]["columns"]
    vocab = t["orders"]["dicts"]["o_orderpriority"]
    late = li["l_commitdate"] < li["l_receiptdate"]
    oi, found = index_of(o["o_orderkey"], li["l_orderkey"][late])
    has = torch.zeros(o["o_orderkey"].numel(), dtype=torch.bool, device=oi.device)
    has[oi[found]] = True
    m = has & (o["o_orderdate"] >= days(p["date"])) & (
        o["o_orderdate"] < days(add_months(p["date"], 3)))
    cnt = torch.bincount(o["o_orderpriority"][m].long(), minlength=len(vocab)).tolist()
    keys = sorted((vocab[i], n) for i, n in enumerate(cnt) if n)
    return [[k for k, _ in keys], host(torch.tensor([n for _, n in keys]))]
