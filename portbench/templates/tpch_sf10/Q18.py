"""TPC-H Q18, the large volume customer query, its joins written JOIN ... ON
(the comma form plans a cross join of customer and orders in the port), with
o_orderkey added to ORDER BY for one order of ties."""

import torch

from portbench.refkit import host, index_of

SQL = ("SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, SUM(l_quantity) "
       "FROM customer JOIN orders ON c_custkey = o_custkey "
       "JOIN lineitem ON o_orderkey = l_orderkey WHERE o_orderkey IN (SELECT l_orderkey "
       "FROM lineitem GROUP BY l_orderkey HAVING SUM(l_quantity) > {quantity}) "
       "GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice "
       "ORDER BY o_totalprice DESC, o_orderdate, o_orderkey LIMIT 100")
PARAMS = {"quantity": {"int": [312, 315]}}
READS = {"customer": ["c_name", "c_custkey"],
         "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"],
         "lineitem": ["l_orderkey", "l_quantity"]}
ORDERED = True


def reference(t, p, ctx):
    c, o, li = (t[x]["columns"] for x in ("customer", "orders", "lineitem"))
    oi, of = index_of(o["o_orderkey"], li["l_orderkey"])
    n = o["o_orderkey"].numel()
    qty = ctx.fixed(li["l_quantity"][of], 2).sum_by(oi[of], n)
    big = qty.v > (p["quantity"] * 100 if ctx.exact else p["quantity"])
    ci, cf = index_of(c["c_custkey"], o["o_custkey"])
    k = (big & cf).nonzero().flatten()
    k = k[torch.sort(o["o_orderkey"][k], stable=True).indices]
    k = k[torch.sort(o["o_orderdate"][k], stable=True).indices]
    k = k[torch.sort(o["o_totalprice"][k], descending=True, stable=True).indices][:100]
    names = t["customer"]["dicts"]["c_name"]
    return [[names[i] for i in c["c_name"][ci[k]].tolist()], host(c["c_custkey"][ci[k]]),
            host(o["o_orderkey"][k]), host(o["o_orderdate"][k]),
            ctx.fixed(o["o_totalprice"][k], 2).dec(), qty[k].dec()]
