"""TPC-H Q10, the returned item reporting query, its joins written JOIN ...
ON (the comma form fails in the port at SF10), c_custkey added to ORDER BY
for one order of ties, and c_address and c_comment, free text that is not
loaded, left out of the select list and GROUP BY."""

import torch

from portbench.refkit import add_months, days, host, index_of

SQL = ("SELECT c_custkey, c_name, SUM(l_extendedprice * (1 - l_discount)) AS revenue, "
       "c_acctbal, n_name, c_phone FROM customer JOIN orders ON c_custkey = o_custkey "
       "JOIN lineitem ON l_orderkey = o_orderkey JOIN nation ON c_nationkey = n_nationkey "
       "WHERE o_orderdate >= DATE '{date}' AND o_orderdate < DATE '{date}' + INTERVAL '3' MONTH "
       "AND l_returnflag = 'R' "
       "GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name "
       "ORDER BY revenue DESC, c_custkey LIMIT 20")
PARAMS = {"date": {"month": ["1993-02", "1995-01"]}}
READS = {"customer": ["c_custkey", "c_name", "c_acctbal", "c_phone", "c_nationkey"],
         "orders": ["o_custkey", "o_orderkey", "o_orderdate"],
         "lineitem": ["l_orderkey", "l_extendedprice", "l_discount", "l_returnflag"],
         "nation": ["n_nationkey", "n_name"]}
ORDERED = True


def reference(t, p, ctx):
    c, o, li, n = (t[x]["columns"] for x in ("customer", "orders", "lineitem", "nation"))
    rflag = t["lineitem"]["dicts"]["l_returnflag"].index("R")
    oi, of = index_of(o["o_orderkey"], li["l_orderkey"])
    ci, cf = index_of(c["c_custkey"], o["o_custkey"][oi])
    od = o["o_orderdate"][oi]
    m = (of & cf & (li["l_returnflag"] == rflag) & (od >= days(p["date"]))
         & (od < days(add_months(p["date"], 3))))
    g = ci[m]
    k = c["c_custkey"].numel()
    rev = (ctx.fixed(li["l_extendedprice"][m], 2)
           * (ctx.const(1) - ctx.fixed(li["l_discount"][m], 2))).sum_by(g, k)
    keys = torch.unique(g)  # ascending rows, so ascending c_custkey
    keys = keys[torch.sort(c["c_custkey"][keys], stable=True).indices]
    keys = keys[torch.sort(rev.v[keys], descending=True, stable=True).indices][:20]
    ni, _ = index_of(n["n_nationkey"], c["c_nationkey"][keys])
    d = t["customer"]["dicts"]
    names = t["nation"]["dicts"]["n_name"]
    return [host(c["c_custkey"][keys]), [d["c_name"][i] for i in c["c_name"][keys].tolist()],
            rev[keys].dec(), ctx.fixed(c["c_acctbal"][keys], 2).dec(),
            [names[i] for i in n["n_name"][ni].tolist()],
            [d["c_phone"][i] for i in c["c_phone"][keys].tolist()]]
