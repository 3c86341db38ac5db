"""TPC-H Q1, the pricing summary report, in the specification's text.

Left out of the power mix: its sum_charge overflows the port's int64 at
SF10 (PERF.md, Open questions).  portbench/checks/templates.py still runs it.
"""

import torch

from portbench.refkit import days, host

SQL = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
       "SUM(l_extendedprice) AS sum_base_price, "
       "SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price, "
       "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge, "
       "AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price, "
       "AVG(l_discount) AS avg_disc, COUNT(*) AS count_order FROM lineitem "
       "WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '{delta}' DAY "
       "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus")
PARAMS = {"delta": {"int": [60, 120]}}
READS = {"lineitem": ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                      "l_discount", "l_tax", "l_shipdate"]}
FLOAT = [6, 7, 8]
ORDERED = True


def reference(t, p, ctx):
    li, vocab = t["lineitem"]["columns"], t["lineitem"]["dicts"]
    m = li["l_shipdate"] <= days("1998-12-01") - p["delta"]
    g = (li["l_returnflag"][m].long() * 2 + li["l_linestatus"][m].long())
    one = ctx.const(1)
    qty = ctx.fixed(li["l_quantity"][m], 2)
    price = ctx.fixed(li["l_extendedprice"][m], 2)
    disc = ctx.fixed(li["l_discount"][m], 2)
    tax = ctx.fixed(li["l_tax"][m], 2)
    disc_price = price * (one - disc)
    charge = disc_price * (one + tax)
    n = 2 * len(vocab["l_returnflag"])
    cnt = torch.bincount(g, minlength=n)
    sums = [x.sum_by(g, n) for x in (qty, price, disc_price, charge)]
    keys = [k for k in range(n) if cnt[k] > 0]
    keys.sort(key=lambda k: (vocab["l_returnflag"][k // 2], vocab["l_linestatus"][k % 2]))
    k = torch.tensor(keys, dtype=torch.long, device=g.device)
    c = cnt[k]
    avgs = [ctx.f(x.sum_by(g, n).units()[k]) / c.to(ctx.fdt) for x in (qty, price, disc)]
    return ([[vocab["l_returnflag"][x // 2] for x in keys],
             [vocab["l_linestatus"][x % 2] for x in keys]]
            + [s[k].dec() for s in sums]
            + [host(a.double()) for a in avgs] + [host(c)])
