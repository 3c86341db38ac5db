"""TPC-H Q3, the shipping priority query, its joins written JOIN ... ON (the
comma form plans a cross join of customer and orders in the port: PERF.md,
Open questions), with l_orderkey added to ORDER BY for one order of ties."""

import torch

from portbench.refkit import days, host, index_of

SQL = ("SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue, o_orderdate, "
       "o_shippriority FROM customer JOIN orders ON c_custkey = o_custkey "
       "JOIN lineitem ON l_orderkey = o_orderkey WHERE c_mktsegment = '{segment}' "
       "AND o_orderdate < DATE '{date}' AND l_shipdate > DATE '{date}' "
       "GROUP BY l_orderkey, o_orderdate, o_shippriority "
       "ORDER BY revenue DESC, o_orderdate, l_orderkey LIMIT 10")
PARAMS = {"segment": {"choice": ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                                 "HOUSEHOLD"]},
          "date": {"day": ["1995-03-01", "1995-03-31"]}}
READS = {"customer": ["c_mktsegment", "c_custkey"],
         "orders": ["o_custkey", "o_orderkey", "o_orderdate", "o_shippriority"],
         "lineitem": ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"]}
ORDERED = True


def reference(t, p, ctx):
    c, o, li = (t[n]["columns"] for n in ("customer", "orders", "lineitem"))
    d = days(p["date"])
    seg = t["customer"]["dicts"]["c_mktsegment"].index(p["segment"])
    ci, cfound = index_of(c["c_custkey"], o["o_custkey"])
    o_ok = cfound & (c["c_mktsegment"][ci] == seg) & (o["o_orderdate"] < d)
    oi, ofound = index_of(o["o_orderkey"], li["l_orderkey"])
    m = ofound & o_ok[oi] & (li["l_shipdate"] > d)
    oi = oi[m]
    n = o["o_orderkey"].numel()
    rev = (ctx.fixed(li["l_extendedprice"][m], 2)
           * (ctx.const(1) - ctx.fixed(li["l_discount"][m], 2))).sum_by(oi, n)
    has = torch.zeros(n, dtype=torch.bool, device=oi.device)
    has[oi] = True
    k = has.nonzero().flatten()
    # ORDER BY revenue DESC, o_orderdate, l_orderkey: stable sorts, last key first
    k = k[torch.sort(o["o_orderkey"][k], stable=True).indices]
    k = k[torch.sort(o["o_orderdate"][k], stable=True).indices]
    k = k[torch.sort(rev.v[k], descending=True, stable=True).indices][:10]
    return [host(o["o_orderkey"][k]), rev[k].dec(), host(o["o_orderdate"][k]),
            host(o["o_shippriority"][k])]
