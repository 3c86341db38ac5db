"""TPC-H Q12, the shipping modes and order priority query, in the
specification's text."""

import torch

from portbench.refkit import add_months, days, host, index_of

SQL = ("SELECT l_shipmode, SUM(CASE WHEN o_orderpriority = '1-URGENT' "
       "OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END) AS high_line_count, "
       "SUM(CASE WHEN o_orderpriority <> '1-URGENT' AND o_orderpriority <> '2-HIGH' "
       "THEN 1 ELSE 0 END) AS low_line_count FROM orders, lineitem "
       "WHERE o_orderkey = l_orderkey AND l_shipmode IN ('{modes[0]}', '{modes[1]}') "
       "AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate "
       "AND l_receiptdate >= DATE '{date}' "
       "AND l_receiptdate < DATE '{date}' + INTERVAL '1' YEAR "
       "GROUP BY l_shipmode ORDER BY l_shipmode")
PARAMS = {"modes": {"sample": [["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"], 2]},
          "date": {"choice": ["1993-01-01", "1994-01-01", "1995-01-01", "1996-01-01",
                              "1997-01-01"]}}
READS = {"orders": ["o_orderkey", "o_orderpriority"],
         "lineitem": ["l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate", "l_shipdate"]}
ORDERED = True


def reference(t, p, ctx):
    o, li = t["orders"]["columns"], t["lineitem"]["columns"]
    modes = t["lineitem"]["dicts"]["l_shipmode"]
    prios = t["orders"]["dicts"]["o_orderpriority"]
    want = torch.tensor([modes.index(x) for x in p["modes"]], device=li["l_shipmode"].device)
    rd = li["l_receiptdate"]
    m = (torch.isin(li["l_shipmode"], want) & (li["l_commitdate"] < rd)
         & (li["l_shipdate"] < li["l_commitdate"]) & (rd >= days(p["date"]))
         & (rd < days(add_months(p["date"], 12))))
    oi, of = index_of(o["o_orderkey"], li["l_orderkey"][m])
    high = torch.isin(o["o_orderpriority"][oi],
                      torch.tensor([prios.index("1-URGENT"), prios.index("2-HIGH")],
                                   device=oi.device)) & of
    mode = li["l_shipmode"][m].long()
    hi = torch.bincount(mode[high], minlength=len(modes))
    lo = torch.bincount(mode[of & ~high], minlength=len(modes))
    keys = sorted(i for i in range(len(modes)) if hi[i] + lo[i] > 0)
    keys.sort(key=lambda i: modes[i])
    k = torch.tensor(keys, dtype=torch.long, device=oi.device)
    return [[modes[i] for i in keys], host(hi[k]), host(lo[k])]
