"""TPC-H Q5, the local supplier volume query, its joins written JOIN ... ON
(the comma form fails in the port at SF10: PERF.md, Open questions)."""

import torch

from portbench.refkit import add_months, days, index_of

SQL = ("SELECT n_name, SUM(l_extendedprice * (1 - l_discount)) AS revenue "
       "FROM customer JOIN orders ON c_custkey = o_custkey "
       "JOIN lineitem ON l_orderkey = o_orderkey "
       "JOIN supplier ON l_suppkey = s_suppkey AND c_nationkey = s_nationkey "
       "JOIN nation ON s_nationkey = n_nationkey JOIN region ON n_regionkey = r_regionkey "
       "WHERE r_name = '{region}' AND o_orderdate >= DATE '{date}' "
       "AND o_orderdate < DATE '{date}' + INTERVAL '1' YEAR "
       "GROUP BY n_name ORDER BY revenue DESC")
PARAMS = {"region": {"choice": ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]},
          "date": {"choice": ["1993-01-01", "1994-01-01", "1995-01-01", "1996-01-01",
                              "1997-01-01"]}}
READS = {"customer": ["c_custkey", "c_nationkey"],
         "orders": ["o_custkey", "o_orderkey", "o_orderdate"],
         "lineitem": ["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"],
         "supplier": ["s_suppkey", "s_nationkey"],
         "nation": ["n_nationkey", "n_name", "n_regionkey"],
         "region": ["r_regionkey", "r_name"]}
ORDERED = True


def reference(t, p, ctx):
    c, o, li, s, n, r = (t[x]["columns"] for x in
                         ("customer", "orders", "lineitem", "supplier", "nation", "region"))
    rid = t["region"]["dicts"]["r_name"].index(p["region"])
    rkey = r["r_regionkey"][r["r_name"] == rid]
    oi, of = index_of(o["o_orderkey"], li["l_orderkey"])
    ci, cf = index_of(c["c_custkey"], o["o_custkey"][oi])
    si, sf = index_of(s["s_suppkey"], li["l_suppkey"])
    snat = s["s_nationkey"][si]
    ni, nf = index_of(n["n_nationkey"], snat)
    od = o["o_orderdate"][oi]
    m = (of & cf & sf & nf & (c["c_nationkey"][ci] == snat)
         & torch.isin(n["n_regionkey"][ni], rkey)
         & (od >= days(p["date"])) & (od < days(add_months(p["date"], 12))))
    g = ni[m]
    k = n["n_nationkey"].numel()
    rev = (ctx.fixed(li["l_extendedprice"][m], 2)
           * (ctx.const(1) - ctx.fixed(li["l_discount"][m], 2))).sum_by(g, k)
    keys = torch.unique(g)
    keys = keys[torch.sort(rev.v[keys], descending=True, stable=True).indices]
    names = t["nation"]["dicts"]["n_name"]
    return [[names[int(n["n_name"][i])] for i in keys.tolist()], rev[keys].dec()]
