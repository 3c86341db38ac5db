"""TPC-H's tables at a scale factor, made on the device from the seed by the
value rules of the specification's clause 4.2.3 (not dbgen's bytes).

Only the columns some template reads are made (the JSON file lists them).
`scale` multiplies the scale factor (tests); nation and region keep 25 and 5
rows.  DECIMAL(15,2) columns are scaled int64 (cents), DATE int32 days since
1970-01-01, TEXT dictionary ids with their vocabulary.
"""

import datetime as dt

import torch

NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
           ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
           ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
           ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPE_SYLLABLES = (["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"],
                  ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"],
                  ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"])
RETURNFLAGS = ["A", "N", "R"]
LINESTATUSES = ["F", "O"]


def _day(iso: str) -> int:
    return (dt.date.fromisoformat(iso) - dt.date(1970, 1, 1)).days


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE in cents: 90000 + ((P / 10) mod 20001) + 100 * (P mod 1000)."""
    p = partkey.long()
    return 90000 + (p // 10) % 20001 + 100 * (p % 1000)


def make(cfg: dict, seed: int, scale: float, device) -> dict:
    sf = cfg["scale_factor"] * scale
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    dev = device

    def ints(lo, hi, n, dtype=torch.int32):  # uniform in [lo, hi]
        return torch.randint(lo, hi + 1, (n,), dtype=dtype, device=dev, generator=gen)

    def keys(n):
        return torch.arange(1, n + 1, dtype=torch.int32, device=dev)

    n_part, n_supp = max(int(200_000 * sf), 1), max(int(10_000 * sf), 4)
    n_cust, n_ord = max(int(150_000 * sf), 3), max(int(1_500_000 * sf), 1)
    start, end, current = _day(cfg["start_date"]), _day(cfg["end_date"]), _day(cfg["current_date"])
    a, b, c = TYPE_SYLLABLES
    types = [f"{x} {y} {z}" for x in a for y in b for z in c]

    part = {"p_partkey": keys(n_part), "p_type": ints(0, len(types) - 1, n_part)}
    supplier = {"s_suppkey": keys(n_supp), "s_nationkey": ints(0, 24, n_supp)}
    c_nation = ints(0, 24, n_cust)
    # C_PHONE: country code (nation + 10), then 3, 3 and 4 random digits
    phone = (((c_nation.long() + 10) * 1000 + ints(100, 999, n_cust, torch.int64)) * 1000
             + ints(100, 999, n_cust, torch.int64)) * 10000 + ints(1000, 9999, n_cust, torch.int64)
    phones, phone_id = torch.unique(phone, return_inverse=True)
    phone_vocab = [f"{v // 10**10}-{v // 10**7 % 1000}-{v // 10**4 % 1000}-{v % 10**4}"
                   for v in phones.tolist()]
    customer = {"c_custkey": keys(n_cust), "c_name": keys(n_cust) - 1, "c_nationkey": c_nation,
                "c_phone": phone_id.to(torch.int32),
                "c_acctbal": ints(-99_999, 999_999, n_cust, torch.int64),
                "c_mktsegment": ints(0, len(SEGMENTS) - 1, n_cust)}

    # orders: sparse keys, customers whose key is not divisible by 3
    i = torch.arange(n_ord, dtype=torch.int64, device=dev)
    o_key = ((i // 8) * 32 + i % 8 + 1).to(torch.int32)
    m = ints(0, n_cust - n_cust // 3 - 1, n_ord, torch.int64)
    o_cust = ((m // 2) * 3 + m % 2 + 1).to(torch.int32)
    o_date = ints(start, end - 151, n_ord)

    # lineitem: 1-7 lines an order, each count about equally often, as many
    # lines as dbgen makes at the scale factor, for every seed the same
    # counts in the seed's order (the port's capacity ladder turns on the
    # row count: PERF.md)
    per = torch.arange(n_ord, device=dev) * 7 // n_ord + 1
    excess = int(per.sum()) - round(cfg["rows"]["lineitem"] * scale)
    per[n_ord - min(max(excess, 0), n_ord // 7):] -= 1
    per = per[torch.randperm(n_ord, device=dev, generator=gen)]
    oi = torch.repeat_interleave(torch.arange(n_ord, device=dev), per)
    n_li = int(oi.numel())
    pk = ints(1, n_part, n_li, torch.int64)
    si = ints(0, 3, n_li, torch.int64)
    sk = (pk + si * (n_supp // 4 + (pk - 1) // n_supp)) % n_supp + 1
    qty = ints(1, 50, n_li, torch.int64)
    ext = qty * retail_cents(pk)
    disc = ints(0, 10, n_li, torch.int64)
    tax = ints(0, 8, n_li, torch.int64)
    od = o_date[oi]
    ship = od + ints(1, 121, n_li)
    commit = od + ints(30, 90, n_li)
    receipt = ship + ints(1, 30, n_li)
    rflag = torch.where(receipt <= current, ints(0, 1, n_li) * 2, 1).to(torch.int32)  # R / A, else N
    lstatus = (ship > current).to(torch.int32)
    line_total = (ext * (100 + tax) * (100 - disc) + 5000) // 10000
    o_total = torch.zeros(n_ord, dtype=torch.int64, device=dev).index_add_(0, oi, line_total)
    lineitem = {"l_orderkey": o_key[oi], "l_partkey": pk.to(torch.int32),
                "l_suppkey": sk.to(torch.int32), "l_quantity": qty * 100,
                "l_extendedprice": ext, "l_discount": disc, "l_tax": tax,
                "l_returnflag": rflag, "l_linestatus": lstatus,
                "l_shipdate": ship, "l_commitdate": commit, "l_receiptdate": receipt,
                "l_shipmode": ints(0, len(SHIPMODES) - 1, n_li)}
    orders = {"o_orderkey": o_key, "o_custkey": o_cust, "o_orderdate": o_date,
              "o_orderpriority": ints(0, len(PRIORITIES) - 1, n_ord),
              "o_totalprice": o_total, "o_shippriority": torch.zeros(n_ord, dtype=torch.int32,
                                                                     device=dev)}
    nation = {"n_nationkey": torch.arange(25, dtype=torch.int32, device=dev),
              "n_name": torch.arange(25, dtype=torch.int32, device=dev),
              "n_regionkey": torch.tensor([r for _, r in NATIONS], dtype=torch.int32, device=dev)}
    region = {"r_regionkey": torch.arange(5, dtype=torch.int32, device=dev),
              "r_name": torch.arange(5, dtype=torch.int32, device=dev)}

    frag = max(int(33_554_432 * scale), 1)
    dec = "DECIMAL(15,2) NOT NULL"
    return {
        "lineitem": {"columns": lineitem, "ddl": (
            "CREATE TABLE lineitem (l_orderkey INT NOT NULL, l_partkey INT NOT NULL, "
            f"l_suppkey INT NOT NULL, l_quantity {dec}, l_extendedprice {dec}, "
            f"l_discount {dec}, l_tax {dec}, l_returnflag TEXT NOT NULL, "
            "l_linestatus TEXT NOT NULL, l_shipdate DATE NOT NULL, l_commitdate DATE NOT NULL, "
            "l_receiptdate DATE NOT NULL, l_shipmode TEXT NOT NULL) "
            f"WITH (fragment_size={frag})"),
            "dicts": {"l_returnflag": RETURNFLAGS, "l_linestatus": LINESTATUSES,
                      "l_shipmode": SHIPMODES}},
        "orders": {"columns": orders, "ddl": (
            "CREATE TABLE orders (o_orderkey INT NOT NULL, o_custkey INT NOT NULL, "
            "o_orderdate DATE NOT NULL, o_orderpriority TEXT NOT NULL, "
            f"o_totalprice {dec}, o_shippriority INT NOT NULL) WITH (fragment_size={frag})"),
            "dicts": {"o_orderpriority": PRIORITIES}},
        "customer": {"columns": customer, "ddl": (
            "CREATE TABLE customer (c_custkey INT NOT NULL, c_name TEXT NOT NULL, "
            "c_nationkey INT NOT NULL, c_phone TEXT NOT NULL, "
            f"c_acctbal {dec}, c_mktsegment TEXT NOT NULL) WITH (fragment_size={frag})"),
            "dicts": {"c_name": [f"Customer#{k:09d}" for k in range(1, n_cust + 1)],
                      "c_phone": phone_vocab, "c_mktsegment": SEGMENTS}},
        "part": {"columns": part, "ddl": (
            "CREATE TABLE part (p_partkey INT NOT NULL, p_type TEXT NOT NULL) "
            f"WITH (fragment_size={frag})"),
            "dicts": {"p_type": types}},
        "supplier": {"columns": supplier, "ddl": (
            "CREATE TABLE supplier (s_suppkey INT NOT NULL, s_nationkey INT NOT NULL)")},
        "nation": {"columns": nation, "ddl": (
            "CREATE TABLE nation (n_nationkey INT NOT NULL, n_name TEXT NOT NULL, "
            "n_regionkey INT NOT NULL)"),
            "dicts": {"n_name": [n for n, _ in NATIONS]}},
        "region": {"columns": region, "ddl": (
            "CREATE TABLE region (r_regionkey INT NOT NULL, r_name TEXT NOT NULL)"),
            "dicts": {"r_name": REGIONS}},
    }
