"""TPC-H Q14, the promotion effect query, in the specification's text."""

import torch

from portbench.refkit import add_months, days, host, index_of

SQL = ("SELECT 100.00 * SUM(CASE WHEN p_type LIKE 'PROMO%' "
       "THEN l_extendedprice * (1 - l_discount) ELSE 0 END) "
       "/ SUM(l_extendedprice * (1 - l_discount)) AS promo_revenue FROM lineitem, part "
       "WHERE l_partkey = p_partkey AND l_shipdate >= DATE '{date}' "
       "AND l_shipdate < DATE '{date}' + INTERVAL '1' MONTH")
PARAMS = {"date": {"month": ["1993-01", "1997-12"]}}
READS = {"lineitem": ["l_partkey", "l_extendedprice", "l_discount", "l_shipdate"],
         "part": ["p_partkey", "p_type"]}
FLOAT = [0]


def reference(t, p, ctx):
    li, pa = t["lineitem"]["columns"], t["part"]["columns"]
    types = t["part"]["dicts"]["p_type"]
    promo_ids = torch.tensor([i for i, s in enumerate(types) if s.startswith("PROMO")],
                             device=pa["p_type"].device)
    m = (li["l_shipdate"] >= days(p["date"])) & (li["l_shipdate"] < days(add_months(p["date"], 1)))
    pi, pf = index_of(pa["p_partkey"], li["l_partkey"][m])
    rev = (ctx.fixed(li["l_extendedprice"][m], 2)
           * (ctx.const(1) - ctx.fixed(li["l_discount"][m], 2))).where(pf)
    promo = rev.where(torch.isin(pa["p_type"][pi], promo_ids))
    out = 100 * ctx.f(promo.sum().units()) / ctx.f(rev.sum().units())
    return [host(out.double())]
