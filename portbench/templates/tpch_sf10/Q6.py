"""TPC-H Q6, the forecasting revenue change query, in the specification's text."""

from portbench.refkit import add_months, days

SQL = ("SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
       "WHERE l_shipdate >= DATE '{date}' AND l_shipdate < DATE '{date}' + INTERVAL '1' YEAR "
       "AND l_discount BETWEEN {discount} - 0.01 AND {discount} + 0.01 "
       "AND l_quantity < {quantity}")
PARAMS = {"date": {"choice": ["1993-01-01", "1994-01-01", "1995-01-01", "1996-01-01",
                              "1997-01-01"]},
          "discount": {"hundredths": [2, 9]},
          "quantity": {"int": [24, 25]}}
READS = {"lineitem": ["l_extendedprice", "l_discount", "l_shipdate", "l_quantity"]}


def reference(t, p, ctx):
    li = t["lineitem"]["columns"]
    d = round(float(p["discount"]) * 100)
    m = ((li["l_shipdate"] >= days(p["date"])) & (li["l_shipdate"] < days(add_months(p["date"], 12)))
         & (li["l_discount"] >= d - 1) & (li["l_discount"] <= d + 1)
         & (li["l_quantity"] < p["quantity"] * 100))
    rev = (ctx.fixed(li["l_extendedprice"][m], 2) * ctx.fixed(li["l_discount"][m], 2)).sum()
    return [rev.dec()]
