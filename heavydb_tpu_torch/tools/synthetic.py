"""The on-card workload shared by `chip_smoke.py` and `profile_queries`:
the synthetic benchmark's schema, the SELECTs of the port's slices (the
group-by QUERIES, the ORDER BY SORT_QUERIES, the join + GROUP BY
JOIN_QUERIES, the dictionary-string STRING_QUERIES, the subquery and set
operation SUBQ_QUERIES, the DISTINCT-family DISTINCT_QUERIES and the hash
group-by tier's HASH_QUERIES, with the settings some of them run under,
QUERY_SETTINGS; the window functions of WINDOW_QUERIES and the scalar UDF
of UDF_QUERIES, registered by `register_udfs`), the UPDATE / DELETE /
CTAS / INSERT ... SELECT / TRUNCATE statements of DML_STEPS, and the
loaders that build the tables on the device.

Schema (the reference's benchmarks/synthetic.py:21-31, 67-74): uniform INT
columns `x10 .. x100k` and `x10m` in [1, card]; sparse BIGINT columns
`x10k_s10k` and `x1m_s10k` = randint(1, card) * 10000; plus `v FLOAT`
uniform in [0, 1) (BASELINE config 1); in HeavyDB's 32M-row fragments.

The join queries' build sides (`load_dims`): `dim1k (k, nm)`, BASELINE
config 3's dimension (bench.py:321-325: k = 1..1000, nm uniform in 0..49);
`dim10m (k, g)`, a TPC-H orders-like primary-key side (k a permutation of
1..10^7, g uniform in 1..1000); `sdim (k, w)`, the sparse keys of
x1m_s10k (k a permutation of (1..10^6) x 10^4, w uniform in [0, 1));
`multi (k, w)`, keys 1..500 three times each (a 1:3 fan-out).

The string queries' table (`load_strings`): `lstr`, rows of TPC-H
lineitem's shape with part and customer attributes added to each row,
over the TPC-H specification's vocabularies (v3, 4.2.2.13 and 4.2.3):
`shipmode` (the 7 l_shipmode values), `shipinstruct` (the 4
l_shipinstruct values), `ptype` (the 150 p_type values, 6 x 5 x 5
syllables), `cname` (`Customer#%09d`, the c_name form, 10^6 entries); each
TEXT column uniform over its vocabulary with 1 % NULL; `x10`, `x100`,
`x1k` INT uniform as in `bench`; `v FLOAT`.

The hash tier's table (`load_hsparse`): `hsparse (k BIGINT, a INT, b INT,
x100 INT, v FLOAT)`, 10^7 rows; k one of HASH_KEYS distinct values drawn
once from [1, 10^10], (a, b) one of HASH_KEYS distinct pairs over
[0, 2^20)^2, each row picking its key and its pair uniformly; x100 and v
as in `bench`.  The reference's rule takes the hash tier only when its
NDV estimate (`Executor._estimate_group_ndv`: the 65,536-row sample's
distinct count plus its share of singletons times the rows not sampled)
is at most 2^19 and at least a 32nd of the rows.  At 10^7 rows that
holds for 20,000 uniform keys (25 rows a key by the estimate, 500 in
truth: the estimate is ~20 x too high, so the claim table is ~80 x the
keys) but not for 17,000 or 24,000, and HASH_KEYS_TRUE = 400,000 keys
(25 rows a key in truth, the depth the rule is meant for) estimate past
2^19 and run on the sort tier (tests/test_torch_hash_groupby.py
`test_rule_window_at_ten_million_rows`).

The geo tables (`load_geo`), cut from the NYC taxi demos of HeavyDB:
`trips (p GEOMETRY(POINT, 4326), fare DOUBLE, pax SMALLINT)`, TRIPS_ROWS
pickups uniform over NYC_BOX (1 % NULL), fare uniform in [2.5, 80], pax
in 1..6; `zones (zid INT, zone GEOMETRY(POLYGON, 4326))`, ZONES polygons
(the NYC TLC taxi zones' count): the tiles of a jittered ZONE_GRID grid
of shared vertices over the same box, ZONES_DROPPED tiles left out (their
pickups fall in no zone), each tile edge cut into ZONE_EDGE_SEGMENTS
straight segments (64 vertices a ring), every ZONE_HOLE_EVERY-th zone
with a square hole; `stations (sid INT, s GEOMETRY(POINT, 4326))`,
STATIONS points (about Citi Bike's count) uniform over the box.  SRID
4326 columns store GEOINT32 (int32 lon / lat, the reference's default);
the loader makes each coordinate as the codec does (storage/table.py
geoint_compress) and inserts the physical rows.

The multi-host rig's tables (`multihost_data`, `load_multihost`; the
reference's tests/multihost_worker.py): `fact (k INT, g INT, v FLOAT, s
TEXT)` partitioned across hosts, `dim (k, nm)` replicated, the skewed
`orders (ok, w)` partitioned, and `sharded (k, v)` routed by its SHARD
KEY; MULTIHOST_QUERIES run on them through DistEngine.

The array table (`load_arrays`): `arr (vals INT[], w DOUBLE)`, ARRAY_ROWS
rows of 0 .. ARRAY_MAX_LEN elements uniform in [0, ARRAY_VALUES), 2 %
NULL arrays and 1 % NULL elements; w uniform in [0, 1).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

FRAGMENT_ROWS = 33_554_432

COLUMNS = [("x10", 10), ("y10", 10), ("x100", 100), ("y100", 100),
           ("x1k", 1000), ("x10k", 10_000), ("x100k", 100_000),
           ("x10m", 10_000_000)]
# (name, card, step): BIGINT randint(1, card) * step
SPARSE_COLUMNS = [("x10k_s10k", 10_000, 10_000), ("x1m_s10k", 1_000_000, 10_000)]

QUERIES = {
    "NGA03": "SELECT COUNT(*) FROM bench WHERE x100 > 50 AND y100 <= 75",
    "PHM001": "SELECT x10, y10, COUNT(*), AVG(x100) FROM bench GROUP BY x10, y10",
    "Q100_MINMAX": "SELECT x100, COUNT(*), SUM(v), MIN(x10k), MAX(v) FROM bench "
                   "WHERE x10 > 3 GROUP BY x100",
    "PHS002": "SELECT x1k, COUNT(*), SUM(y10) FROM bench GROUP BY x1k",
    "Q1K_MINMAX": "SELECT x1k, MIN(x10k), MAX(v), AVG(v) FROM bench GROUP BY x1k",
    "Q10K": "SELECT x10k, COUNT(*), SUM(v) FROM bench GROUP BY x10k",
    "PHS003": "SELECT x100k, COUNT(*) FROM bench GROUP BY x100k",
    # keys with no dense range: the sort tier
    "BH002": "SELECT x10k_s10k, COUNT(*) FROM bench GROUP BY x10k_s10k",
    "BH003": "SELECT x1m_s10k, COUNT(*), SUM(y100) FROM bench GROUP BY x1m_s10k",
    # 10^7 dense slots: the radix tier
    "BH004": "SELECT x10m, COUNT(*) FROM bench GROUP BY x10m",
    "Q10M_AGGS": "SELECT x10m, COUNT(*), SUM(x100), SUM(v), MIN(x10k), MAX(v) "
                 "FROM bench WHERE x10 > 3 GROUP BY x10m",
}

# ORDER BY, LIMIT / OFFSET and top-k, one query a path of Executor._exec_sort
SORT_QUERIES = {
    # LIMIT without keys: a slice of the filtered rows in input order
    "LIMIT_ONLY": "SELECT x10, v FROM bench WHERE x1k = 5 LIMIT 20",
    # one FLOAT key over ~70M rows: the top-k select
    "TOPK_V": "SELECT x10m, v FROM bench WHERE x10 > 3 ORDER BY v DESC LIMIT 100",
    # one INT key with ~10 rows a value: ties taken in row order
    "TOPK_TIES": "SELECT x10m, x100 FROM bench ORDER BY x10m LIMIT 1000 OFFSET 10",
    # two keys packed into one (x1k in 10 + 1 bits from chunk stats, v 32 + 1)
    "TOPK_MULTI": "SELECT x1k, v, x10k FROM bench ORDER BY x1k DESC, v LIMIT 50",
    # B2 over 1000 groups, then ORDER BY over them
    "GROUP_TOPN": "SELECT x1k, COUNT(*), SUM(v) FROM bench GROUP BY x1k "
                  "ORDER BY 2 DESC, 1 LIMIT 10",
    # the full lexicographic sort of ~10M rows with three payloads
    "FULL_SORT": "SELECT x10m, x100, v FROM bench WHERE x10 = 1 "
                 "ORDER BY x100 DESC, x10m",
}


# join + GROUP BY over bench and the dimension tables of `load_dims`, one
# query a path of the join pipeline
JOIN_QUERIES = {
    # a perfect-unique build of 1000 keys: one gather a probe row, B1
    "JOIN_DIM1K": "SELECT d.nm, COUNT(*), SUM(b.v) FROM bench b JOIN dim1k d "
                  "ON b.x1k = d.k GROUP BY d.nm",
    # probe-side push-down, a perfect-unique build over 10^7 keys, B2 + B3
    "JOIN_DIM10M": "SELECT d.g, COUNT(*), SUM(b.v), MAX(b.x100) FROM bench b "
                   "JOIN dim10m d ON b.x10m = d.k WHERE b.x10 > 3 GROUP BY d.g",
    # no dense range: the hash table over a sorted build, the expansion,
    # build-side push-down, keyless
    "JOIN_SPARSE": "SELECT COUNT(*), SUM(s.w), SUM(b.y100) FROM bench b "
                   "JOIN sdim s ON b.x1m_s10k = s.k WHERE s.w < 0.5",
    # a perfect non-unique build, 1:3 fan-out and LEFT null rows: the
    # expansion passes its first cap and retries once
    "JOIN_LEFT_FANOUT": "SELECT b.x10, COUNT(*), COUNT(m.w), SUM(m.w) FROM bench b "
                        "LEFT JOIN multi m ON b.x1k = m.k GROUP BY b.x10",
    # SEMI and ANTI joins over filtered build inputs
    "EXISTS_ANTI": "SELECT b.x10, COUNT(*) FROM bench b WHERE EXISTS (SELECT 1 "
                   "FROM sdim s WHERE s.k = b.x1m_s10k AND s.w < 0.25) AND NOT "
                   "EXISTS (SELECT 1 FROM dim1k d WHERE d.k = b.x1k AND d.nm < 5) "
                   "GROUP BY b.x10",
}


# dictionary-string predicates, transforms, pair concatenations and
# comparisons and MIN / MAX over `lstr` (load_strings), one query a path
STRING_QUERIES = {
    # CMP =: a 7-entry bool table, one gather a row; B1 at 10 slots
    "STR_EQ": "SELECT x10, COUNT(*), SUM(v) FROM lstr WHERE shipmode = 'AIR' GROUP BY x10",
    # the TPC-H Q12 filter: IN and a negated CMP; a dictionary group key
    "STR_IN": "SELECT shipmode, COUNT(*), SUM(v) FROM lstr WHERE shipmode IN ('MAIL', "
              "'SHIP') AND shipinstruct <> 'NONE' GROUP BY shipmode",
    # the TPC-H Q14 filter over 150 entries; B1 at 100 slots
    "STR_LIKE": "SELECT x100, COUNT(*), SUM(v) FROM lstr WHERE ptype LIKE 'PROMO%' "
                "GROUP BY x100",
    # the rank and order tables; MIN and MAX over int32 ranks at 1000 slots
    "STR_MINMAX": "SELECT x1k, MIN(ptype), MAX(ptype), COUNT(*) FROM lstr GROUP BY x1k",
    # a transform into a transient dictionary: a key with no range
    "STR_TRANSFORM": "SELECT SUBSTRING(ptype, 1, 5) AS p, COUNT(*), SUM(v) FROM lstr "
                     "GROUP BY p",
    # a 7 x 4 pair table and the pair ranks in one filter
    "STR_PAIR": "SELECT x10, COUNT(*) FROM lstr WHERE shipmode || shipinstruct = "
                "'AIRNONE' OR shipmode < shipinstruct GROUP BY x10",
    # a host scan of a 10^6-entry dictionary
    "STR_LIKE_1M": "SELECT COUNT(*), SUM(v) FROM lstr WHERE cname LIKE '%7777%'",
}

# the HAVING bound of SUBQ_IN's inner query: ~7000 of bench's x10m values
# pass it
SUBQ_IN_BOUND = 1200

# uncorrelated subqueries and set operations over bench and load_dims' tables
SUBQ_QUERIES = {
    # TPC-H Q11's shape with integer sums: a keyless sum read once, then B2
    # at 1000 slots cut by HAVING against the constant
    "SUBQ_SCALAR": "SELECT x1k, COUNT(*), SUM(y100) FROM bench GROUP BY x1k "
                   "HAVING SUM(y100) > (SELECT SUM(y100) FROM bench) / 1000",
    # TPC-H Q18's shape: the inner GROUP BY over 10^7 groups (radix tier)
    # leaves a few thousand ids, tested against 100M rows beside a join
    "SUBQ_IN": "SELECT d.g, COUNT(*), SUM(b.v), MAX(b.x100) FROM bench b JOIN dim10m d "
               "ON b.x10m = d.k WHERE b.x10m IN (SELECT x10m FROM bench GROUP BY x10m "
               f"HAVING SUM(x100) > {SUBQ_IN_BOUND}) GROUP BY d.g",
    # NOT IN over ~100 ids of a dimension table
    "SUBQ_NOT_IN": "SELECT x10, COUNT(*) FROM bench WHERE x1k NOT IN (SELECT k FROM dim1k "
                   "WHERE nm < 5) GROUP BY x10",
    # two compactions of ~30M rows, a concatenation, B1 at 100 slots
    "UNION_ALL": "SELECT x100, COUNT(*), SUM(y10) FROM (SELECT x100, y10 FROM bench WHERE "
                 "x10 <= 3 UNION ALL SELECT y100, x10 FROM bench WHERE x10 >= 8) u "
                 "GROUP BY x100",
    # a tagged union of ~2 x 20,000 rows and two COUNT_IFs at 10^4 slots
    "SET_INTERSECT": "SELECT x10k FROM bench WHERE x100k <= 20 INTERSECT SELECT x10k "
                     "FROM bench WHERE x100k > 99980",
    # three grouping sets, each a scan of the table, then their UNION ALL
    "ROLLUP": "SELECT x10, x100, COUNT(*), SUM(v) FROM bench GROUP BY ROLLUP(x10, x100)",
}

# COUNT / SUM / AVG (DISTINCT), APPROX_COUNT_DISTINCT, APPROX_QUANTILE and MODE
DISTINCT_QUERIES = {
    # the hash form (QUERY_SETTINGS): 4-byte values past 2^21 rows
    "DIST_COUNT": "SELECT x100, COUNT(DISTINCT x10k) FROM bench GROUP BY x100",
    # BIGINT values: the sorted form, keyless
    "DIST_COUNT_WIDE": "SELECT COUNT(DISTINCT x1m_s10k) FROM bench",
    # the sorted (group, value) pairs
    "DIST_SUM": "SELECT x100, SUM(DISTINCT x1k), AVG(DISTINCT x1k) FROM bench GROUP BY x100",
    # HyperLogLog: 10 x 2048 registers
    "APPROX_CD": "SELECT x10, APPROX_COUNT_DISTINCT(x10m) FROM bench GROUP BY x10",
    # the histogram sketch (past 2^21 rows)
    "QUANTILE": "SELECT x100, APPROX_QUANTILE(v, 0.5) FROM bench GROUP BY x100",
    # the sort of (group, value) pairs, ties to the smallest value
    "MODE": "SELECT x10, MODE(x100) FROM bench GROUP BY x10",
}

# the hash group-by tier over `hsparse` (load_hsparse), under QUERY_SETTINGS
HASH_QUERIES = {
    # one BIGINT key packed as itself; x100 > 10 masks 10 % of the rows
    "HASH_BIGINT": "SELECT k, COUNT(*), SUM(v), MIN(x100) FROM hsparse WHERE x100 > 10 "
                   "GROUP BY k",
    # an (a, b) pair range-packed into one int64: 2^40 slots, past the
    # perfect and radix tiers
    "HASH_PAIR": "SELECT a, b, COUNT(*), SUM(v) FROM hsparse GROUP BY a, b",
}
HASH_KEYS = 20_000
HASH_ROWS = 10_000_000
# 25 rows a key at HASH_ROWS, the depth the rule (rows / NDV <= 32) is meant
# for; its estimate is past 2^19, so the rule leaves it to the sort tier, and
# chip_smoke.py times both tiers at it with the estimate set to the true count
HASH_KEYS_TRUE = 400_000

# geo expressions and the grid-bucket spatial join over `load_geo`'s tables
GEO_QUERIES = {
    # keyless; ST_X / ST_Y are SUBSCRIPT gathers of the decoded payload
    "GEO_DWITHIN": "SELECT COUNT(*) FROM trips WHERE ST_DWithin(p, "
                   "ST_GeomFromText('POINT(-73.9857 40.7484)', 4326), 0.01)",
    # the poly_build grid join, the CONTAINS_SEG ray cast over its pairs,
    # then B2 over the 263 zones' perfect slots
    "GEO_ZONE_JOIN": "SELECT z.zid, COUNT(*), AVG(t.fare) FROM trips t JOIN zones z "
                     "ON ST_Contains(z.zone, t.p) GROUP BY z.zid",
    # the dwithin grid join: 9 registrations a station
    "GEO_NEAR_JOIN": "SELECT COUNT(*) FROM trips t, stations s "
                     "WHERE ST_DWithin(t.p, s.s, 0.002)",
}
# array expressions over `load_arrays`' table
ARRAY_QUERIES = {
    # UNNEST of ~4 x 10^7 elements, then the group-by tier the port picks
    "ARR_UNNEST_GROUP": "SELECT UNNEST(vals) v, COUNT(*) FROM arr GROUP BY v",
    # the int8 ANY table and a SUBSCRIPT gather
    "ARR_ANY_SUBSCRIPT": "SELECT COUNT(*), SUM(w) FROM arr WHERE 7 = ANY(vals) "
                         "AND vals[1] < 500",
}
# window functions over bench (chip_smoke.py's window phase)
WINDOW_QUERIES = {
    # the reference's own window benchmark shape (bench.py:401-418): a
    # running SUM with RANGE peers and ROW_NUMBER over one spec (the sorted
    # egress, a packed key of 1 + 10 + 24 bits and 27 row bits), then B1
    # over 10 slots
    "WIN_RUNNING": "SELECT x10, COUNT(*), MAX(rs), SUM(rn) FROM (SELECT x10, "
                   "SUM(v) OVER (PARTITION BY x1k ORDER BY x10m) rs, "
                   "ROW_NUMBER() OVER (PARTITION BY x1k ORDER BY x10m) rn "
                   "FROM bench) t GROUP BY x10",
    # top 3 per group: a FLOAT order key (the generic sort), then a filter
    # Compound over the window
    "WIN_TOPN": "SELECT x1k, v, r FROM (SELECT x1k, v, RANK() OVER (PARTITION BY x1k "
                "ORDER BY v DESC) r FROM bench) t WHERE r <= 3",
    # three specs (the permutation egress): a bounded ROWS AVG (shifted
    # prefixes), a bounded ROWS MIN (the sparse table), a static LAG and a
    # DENSE_RANK with no partition; then B1 over 100 slots
    "WIN_FRAMES": "SELECT x100, COUNT(*), MAX(ma), MIN(mn), COUNT(lg), MAX(dr) FROM ("
                  "SELECT x100, AVG(v) OVER (PARTITION BY x100 ORDER BY x10m "
                  "ROWS BETWEEN 3 PRECEDING AND CURRENT ROW) ma, "
                  "MIN(v) OVER (PARTITION BY x100 ORDER BY x10m "
                  "ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING) mn, "
                  "LAG(x10k, 2) OVER (PARTITION BY x10 ORDER BY x10m) lg, "
                  "DENSE_RANK() OVER (ORDER BY x1k) dr FROM bench) t GROUP BY x100",
}
# a scalar UDF over bench (register_udfs), then B1 over 100 slots
UDF_QUERIES = {
    "UDF_GROUP": "SELECT x100, COUNT(*), SUM(HYPOT(v, x10k)) FROM bench GROUP BY x100",
}
# the distributed queries of the reference's multi-host rig
# (tests/multihost_worker.py), in its order, over `multihost_data`'s tables
# partitioned across hosts (`fact`, `orders`, `sharded` routed by SHARD
# KEY) and `dim` replicated; MH_GROUPBY_K (400 slots: B2, and B3 for MIN /
# MAX, in each leaf) added last
MULTIHOST_QUERIES = {
    "MH_KEYLESS": "SELECT count(*), sum(v), avg(v), min(v), max(v) FROM fact WHERE k < 200",
    "MH_GROUPBY": "SELECT g, count(*), sum(v), avg(v) FROM fact GROUP BY g ORDER BY g",
    "MH_JOIN_GROUPBY": "SELECT d.nm, count(*), sum(f.v) FROM fact f JOIN dim d "
                       "ON f.k = d.k GROUP BY d.nm ORDER BY d.nm",
    "MH_STRING_GROUPBY": "SELECT s, count(*) FROM fact GROUP BY s ORDER BY s",
    "MH_TOPK": "SELECT k, v FROM fact ORDER BY v DESC NULLS LAST LIMIT 25",
    "MH_FULL_SORT": "SELECT k, v FROM fact WHERE v > 1.5 ORDER BY v DESC NULLS LAST, k",
    "MH_COUNT_DISTINCT": "SELECT g, count(DISTINCT k), count(*) FROM fact "
                         "GROUP BY g ORDER BY g",
    "MH_MEDIAN": "SELECT g, approx_median(v) FROM fact WHERE g < 5 GROUP BY g ORDER BY g",
    "MH_MINMAX_STRING": "SELECT g, min(s), max(s) FROM fact GROUP BY g ORDER BY g",
    "MH_KEYLESS_DISTINCT": "SELECT count(DISTINCT k), approx_count_distinct(k) FROM fact "
                           "WHERE g < 30",
    "MH_FACT_FACT_JOIN": "SELECT count(*), sum(f.v), sum(o.w) FROM fact f JOIN orders o "
                         "ON f.k = o.ok",
    "MH_FACT_FACT_JOIN_GROUPBY": "SELECT f.g, count(*) FROM fact f JOIN orders o "
                                 "ON f.k = o.ok WHERE o.w > 0.5 GROUP BY f.g ORDER BY f.g",
    "MH_WINDOW": "SELECT g, k, sum(v) OVER (PARTITION BY g ORDER BY k, s), "
                 "row_number() OVER (PARTITION BY g ORDER BY k, s) "
                 "FROM fact WHERE g < 6 ORDER BY g, k, s",
    "MH_WINDOW_LAG_RANK": "SELECT g, k, lag(k) OVER (PARTITION BY g ORDER BY k, s, v), "
                          "rank() OVER (PARTITION BY g ORDER BY k) "
                          "FROM fact WHERE g < 4 AND v IS NOT NULL ORDER BY g, k, s, v",
    "MH_GLOBAL_WINDOW": "SELECT k, row_number() OVER (ORDER BY k, s, v) "
                        "FROM fact WHERE k < 3 AND v IS NOT NULL ORDER BY k, s, v",
    "MH_SHARD_LOAD": "SELECT count(*) FROM sharded",
    "MH_GROUPBY_K": "SELECT k, count(*), sum(v), min(v), max(v) FROM fact "
                    "GROUP BY k ORDER BY k",
}
MULTIHOST_SHARDED_DDL = ("CREATE TABLE sharded (k INT, v FLOAT, SHARD KEY (k)) "
                         "WITH (shard_count=8)")
MULTIHOST_NAMES = 23
MULTIHOST_ORDERS = 2_000
TRIPS_ROWS = 10_000_000
NYC_BOX = (-74.26, -73.70, 40.49, 40.92)  # lon min, lon max, lat min, lat max
POINT_NULL_SHARE = 0.01
ZONES = 263
ZONE_GRID = (17, 16)  # tiles across, tiles up
ZONES_DROPPED = ZONE_GRID[0] * ZONE_GRID[1] - ZONES
ZONE_EDGE_SEGMENTS = 16
ZONE_HOLE_EVERY = 5
STATIONS = 2_000
ARRAY_ROWS = 10_000_000
ARRAY_MAX_LEN = 8
ARRAY_VALUES = 1000
ARRAY_NULL_SHARE = 0.02
ELEMENT_NULL_SHARE = 0.01

# Config fields a query runs under, set on the connection around it:
# COUNT(DISTINCT) takes its hash form, and a GROUP BY the hash tier, only
# with the hash group-by enabled
QUERY_SETTINGS = {"DIST_COUNT": {"enable_hash_groupby": True},
                  **{name: {"enable_hash_groupby": True} for name in HASH_QUERIES}}

# UPDATE / DELETE / CREATE TABLE AS SELECT / INSERT ... SELECT / TRUNCATE on
# `bench`, in order: (cell, statement, the follow-up queries run after it)
DML_STEPS = [
    # ~10^5 rows in every fragment; the follow-up runs B1 over 101 slots
    ("DML_UPDATE", "UPDATE bench SET v = v + 1.0, x100 = 0 WHERE x1k = 5",
     ["SELECT x100, COUNT(*), SUM(v) FROM bench WHERE x10 > 3 GROUP BY x100"]),
    # ~10^5 rows; B3 + B2 at 1000 slots, and rowid after the compaction
    ("DML_DELETE", "DELETE FROM bench WHERE x10k <= 10",
     ["SELECT x1k, MIN(x10k), MAX(v), COUNT(*) FROM bench GROUP BY x1k",
      "SELECT COUNT(*), MAX(rowid) FROM bench"]),
    # ~3 x 10^7 rows, then ~10^7 more; B2 at 1000 slots over the new table
    ("CTAS_INSERT", "CREATE TABLE b3 AS SELECT x10, x1k, x10m, v FROM bench WHERE x10 <= 3",
     ["SELECT COUNT(*) FROM b3"]),
    ("CTAS_INSERT", "INSERT INTO b3 SELECT x10, x1k, x10m, v FROM bench WHERE x10 = 10",
     ["SELECT x1k, COUNT(*), SUM(v) FROM b3 GROUP BY x1k"]),
    ("CTAS_INSERT", "TRUNCATE TABLE b3", ["SELECT COUNT(*) FROM b3"]),
]


@contextlib.contextmanager
def query_settings(db, name: str):
    """Run the body with db's config set as QUERY_SETTINGS[name] says,
    then restore it."""
    settings = QUERY_SETTINGS.get(name, {})
    saved = {k: getattr(db.config, k) for k in settings}
    for k, v in settings.items():
        setattr(db.config, k, v)
    try:
        yield settings
    finally:
        for k, v in saved.items():
            setattr(db.config, k, v)

SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
P_TYPE_SYLLABLES = (["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"],
                    ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"],
                    ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"])
CUSTOMERS = 1_000_000
STRING_NULL_SHARE = 0.01


def string_vocabularies(customers: int = CUSTOMERS) -> Dict[str, list]:
    """Each TEXT column of `lstr` -> its vocabulary, in dictionary id order."""
    a, b, c = P_TYPE_SYLLABLES
    return {"shipmode": list(SHIPMODES), "shipinstruct": list(SHIPINSTRUCTS),
            "ptype": [f"{x} {y} {z}" for x in a for y in b for z in c],
            "cname": [f"Customer#{i:09d}" for i in range(1, customers + 1)]}


def load_strings(db, n: int, seed: int, fragment_rows: int = FRAGMENT_ROWS,
                 customers: int = CUSTOMERS):
    """CREATE TABLE lstr and load `n` random rows made on db's device from
    `seed`; returns (the device columns, each TEXT column's vocabulary).
    A NULL TEXT value is the id INT32_MIN."""
    gen = torch.Generator(device=db.device)
    gen.manual_seed(seed)
    dev = db.device
    vocab = string_vocabularies(customers)
    null = torch.iinfo(torch.int32).min
    data = {}
    for c, words in vocab.items():
        ids = torch.randint(0, len(words), (n,), dtype=torch.int32, device=dev,
                            generator=gen)
        nulls = torch.rand(n, device=dev, generator=gen) < STRING_NULL_SHARE
        data[c] = torch.where(nulls, null, ids)
    for c, k in (("x10", 10), ("x100", 100), ("x1k", 1000)):
        data[c] = torch.randint(1, k + 1, (n,), dtype=torch.int32, device=dev,
                                generator=gen)
    data["v"] = torch.rand(n, dtype=torch.float32, device=dev, generator=gen)
    db.sql("CREATE TABLE lstr (shipmode TEXT, shipinstruct TEXT, ptype TEXT, cname TEXT, "
           f"x10 INT, x100 INT, x1k INT, v FLOAT) WITH (fragment_size={fragment_rows})")
    db.load_table_device("lstr", data, dicts=vocab)
    return data, vocab


def multihost_data(n: int, seed: int = 42) -> Dict[str, np.ndarray]:
    """The multi-host rig's full dataset, drawn in the reference worker's
    order (tests/multihost_worker.py): fact `k` in [0, 400), `g` in [0, 37),
    `v` FLOAT uniform in [0, 1) with 10 % NaN, `s` name_{i % 23}; then the
    orders `ok` (half of them key 0, the rest uniform in [0, 400)) and `w`
    uniform in [0, 1).  A host loads rows pid::nprocs of each."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 400, n).astype(np.int32)
    g = rng.integers(0, 37, n).astype(np.int32)
    v = np.where(rng.random(n) < 0.1, np.nan, rng.random(n)).astype(np.float32)
    vocab = np.array([f"name_{i}" for i in range(MULTIHOST_NAMES)], object)
    s = vocab[np.arange(n) % MULTIHOST_NAMES]
    n_o = MULTIHOST_ORDERS
    ok = np.where(rng.random(n_o) < 0.5, 0, rng.integers(0, 400, n_o)).astype(np.int32)
    w = rng.random(n_o).astype(np.float32)
    return {"k": k, "g": g, "v": v, "s": s, "ok": ok, "w": w}


def load_multihost(dist, data: Dict[str, np.ndarray], pid: int, nprocs: int) -> None:
    """Each host's part of the rig's tables through DistEngine `dist`: rows
    pid::nprocs of fact and orders, dim (k in [0, 400), nm = k % 11)
    replicated, and `sharded` routed from the full k, v by its SHARD KEY."""
    sel = slice(pid, None, nprocs)
    dist.load_table("fact", {c: data[c][sel] for c in ("k", "g", "v", "s")})
    dim_k = np.arange(400, dtype=np.int32)
    dist.load_table("dim", {"k": dim_k, "nm": (dim_k % 11).astype(np.int32)},
                    replicated=True)
    dist.load_table("orders", {"ok": data["ok"][sel], "w": data["w"][sel]})
    dist.db.sql(MULTIHOST_SHARDED_DDL)
    dist.load_table("sharded", {"k": data["k"], "v": data["v"]}, create=False,
                    route_by_shard_key=True)


def register_udfs(db) -> None:
    """The scalar UDFs of UDF_QUERIES: HYPOT(a, b) over DOUBLE."""
    from heavydb_tpu_torch import types as T

    db.register_udf("HYPOT", lambda a, b: torch.sqrt(a * a + b * b),
                    [T.double(), T.double()], T.double())


def load_bench(db, n: int, seed: int,
               fragment_rows: int = FRAGMENT_ROWS) -> Dict[str, torch.Tensor]:
    """CREATE TABLE bench and load `n` random rows made on db's device from
    `seed`; returns the device columns."""
    gen = torch.Generator(device=db.device)
    gen.manual_seed(seed)
    data = {c: torch.randint(1, k + 1, (n,), dtype=torch.int32,
                             device=db.device, generator=gen)
            for c, k in COLUMNS}
    for c, k, step in SPARSE_COLUMNS:
        data[c] = torch.randint(1, k + 1, (n,), dtype=torch.int64,
                                device=db.device, generator=gen) * step
    data["v"] = torch.rand(n, dtype=torch.float32, device=db.device,
                           generator=gen)
    cols = ", ".join([f"{c} INT" for c, _ in COLUMNS]
                     + [f"{c} BIGINT" for c, _, _ in SPARSE_COLUMNS] + ["v FLOAT"])
    db.sql(f"CREATE TABLE bench ({cols}) WITH (fragment_size={fragment_rows})")
    db.load_table_device("bench", data)
    return data


def load_dims(db, seed: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """CREATE and load the join queries' dimension tables, made on db's
    device from `seed`; returns their device columns by table."""
    gen = torch.Generator(device=db.device)
    gen.manual_seed(seed)
    dev = db.device

    def ints(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), dtype=torch.int32, device=dev,
                             generator=gen)

    def perm(n, dtype):
        return torch.randperm(n, dtype=dtype, device=dev, generator=gen) + 1

    tables = {
        "dim1k": ("k INT NOT NULL, nm INT",
                  {"k": torch.arange(1, 1001, dtype=torch.int32, device=dev),
                   "nm": ints(0, 49, 1000)}),
        "dim10m": ("k INT NOT NULL, g INT",
                   {"k": perm(10_000_000, torch.int32), "g": ints(1, 1000, 10_000_000)}),
        "sdim": ("k BIGINT NOT NULL, w FLOAT",
                 {"k": perm(1_000_000, torch.int64) * 10_000,
                  "w": torch.rand(1_000_000, dtype=torch.float32, device=dev,
                                  generator=gen)}),
        "multi": ("k INT NOT NULL, w FLOAT",
                  {"k": torch.arange(1, 501, dtype=torch.int32, device=dev).repeat(3),
                   "w": torch.rand(1500, dtype=torch.float32, device=dev,
                                   generator=gen)}),
    }
    for name, (decl, data) in tables.items():
        db.sql(f"CREATE TABLE {name} ({decl})")
        db.load_table_device(name, data)
    return {name: data for name, (_, data) in tables.items()}


def load_hsparse(db, n: int, seed: int, keys: int = HASH_KEYS) -> Dict[str, torch.Tensor]:
    """CREATE TABLE hsparse and load `n` random rows made on db's device
    from `seed` (the module docstring's schema, with `keys` distinct keys
    and pairs); returns the device columns."""
    gen = torch.Generator(device=db.device)
    gen.manual_seed(seed)
    dev = db.device

    def distinct(lo, hi):
        # `keys` distinct values of [lo, hi), in random order
        while True:
            v = torch.unique(torch.randint(lo, hi, (keys + keys // 8,), dtype=torch.int64,
                                           device=dev, generator=gen))
            if v.shape[0] >= keys:
                pick = torch.randperm(v.shape[0], device=dev, generator=gen)[:keys]
                return v[pick]

    def rows():
        return torch.randint(0, keys, (n,), device=dev, generator=gen)

    kvals = distinct(1, 10**10 + 1)
    pairs = distinct(0, 1 << 40)
    pr = pairs[rows()]
    data = {"k": kvals[rows()], "a": (pr >> 20).to(torch.int32),
            "b": (pr & ((1 << 20) - 1)).to(torch.int32),
            "x100": torch.randint(1, 101, (n,), dtype=torch.int32, device=dev, generator=gen),
            "v": torch.rand(n, dtype=torch.float32, device=dev, generator=gen)}
    db.sql("CREATE TABLE hsparse (k BIGINT, a INT, b INT, x100 INT, v FLOAT) "
           f"WITH (fragment_size={FRAGMENT_ROWS})")
    db.load_table_device("hsparse", data)
    return data


def _object_rows(parts, null) -> np.ndarray:
    """An array column's physical rows: an object array of the per-row
    element arrays, None where `null`."""
    out = np.empty(len(parts), object)
    for i, (row, isnull) in enumerate(zip(parts, null.tolist())):
        out[i] = None if isnull else row
    return out


def _insert(db, name: str, cols: Dict[str, np.ndarray]) -> None:
    """Append physical host columns (null sentinels in place; array and
    geo columns as object rows) to table `name`."""
    t = db.catalog.get_table(name)
    t.insert_columns({cd.col_id: cols[cd.name] for cd in t.columns})
    db.executor.drop_stale()


def _geoint(x, y) -> np.ndarray:
    """[n, 2] int32 GEOINT32 lon / lat of float64 coordinates."""
    from heavydb_tpu_torch import types as T
    from heavydb_tpu_torch.storage.table import geoint_compress

    xy = np.empty(2 * len(x), np.float64)
    xy[0::2], xy[1::2] = x, y
    return geoint_compress(xy, T.SQLTypeKind.GEO_POINT).reshape(-1, 2)


def _points(rng, n: int) -> np.ndarray:
    lo_x, hi_x, lo_y, hi_y = NYC_BOX
    return _geoint(rng.uniform(lo_x, hi_x, n), rng.uniform(lo_y, hi_y, n))


def zone_rings(seed: int):
    """The zones' rings as float64 (x, y) vertex arrays: [(zid, outer,
    hole or None)], from the jittered grid of `seed`.  A tile edge's
    intermediate vertices are made once and shared by its two tiles."""
    rng = np.random.default_rng(seed)
    nx, ny = ZONE_GRID
    lo_x, hi_x, lo_y, hi_y = NYC_BOX
    gx = np.linspace(lo_x, hi_x, nx + 1)[:, None] + np.zeros((1, ny + 1))
    gy = np.zeros((nx + 1, 1)) + np.linspace(lo_y, hi_y, ny + 1)[None, :]
    dx, dy = (hi_x - lo_x) / nx, (hi_y - lo_y) / ny
    gx[1:-1, 1:-1] += rng.uniform(-0.3, 0.3, (nx - 1, ny - 1)) * dx
    gy[1:-1, 1:-1] += rng.uniform(-0.3, 0.3, (nx - 1, ny - 1)) * dy
    t = np.arange(ZONE_EDGE_SEGMENTS) / ZONE_EDGE_SEGMENTS

    def edge(a, b):
        # the vertices from corner a up to (not including) corner b
        (ax, ay), (bx, by) = (gx[a], gy[a]), (gx[b], gy[b])
        return np.stack([ax + (bx - ax) * t, ay + (by - ay) * t], 1)

    h_edges = {(i, j): edge((i, j), (i + 1, j)) for i in range(nx) for j in range(ny + 1)}
    v_edges = {(i, j): edge((i, j), (i, j + 1)) for i in range(nx + 1) for j in range(ny)}

    def reverse(e, far):
        # the same vertices walked back, starting at the far corner
        return np.concatenate([far[None, :], e[:0:-1]])

    dropped = set(rng.choice(nx * ny, ZONES_DROPPED, replace=False).tolist())
    out = []
    for k in range(nx * ny):
        if k in dropped:
            continue
        i, j = k % nx, k // nx
        ring = np.concatenate([
            h_edges[(i, j)], v_edges[(i + 1, j)],
            reverse(h_edges[(i, j + 1)], np.array([gx[i + 1, j + 1], gy[i + 1, j + 1]])),
            reverse(v_edges[(i, j)], np.array([gx[i, j + 1], gy[i, j + 1]]))])
        zid = len(out) + 1
        hole = None
        if zid % ZONE_HOLE_EVERY == 0:
            cx, cy = ring[:, 0].mean(), ring[:, 1].mean()
            r = 0.15 * min(dx, dy)
            hole = np.array([[cx - r, cy - r], [cx + r, cy - r], [cx + r, cy + r],
                             [cx - r, cy + r]])
        out.append((zid, ring, hole))
    return out


def _polygon_row(ring, hole) -> np.ndarray:
    """A GEOINT32 POLYGON payload: [rings, +outer coords, -hole coords,
    int32 coordinates...]."""
    rings = [ring] + ([hole] if hole is not None else [])
    head = [len(rings), 2 * len(ring)] + ([-2 * len(hole)] if hole is not None else [])
    coords = [_geoint(r[:, 0], r[:, 1]).reshape(-1) for r in rings]
    return np.concatenate([np.asarray(head, np.int32)] + coords)


def load_geo(db, seed: int, trips: int = TRIPS_ROWS) -> Dict[str, object]:
    """CREATE and load `trips`, `zones` and `stations` (the module
    docstring's schema), made on the host from `seed`.  Returns the
    physical columns: trips_xy ([n, 2] int32 GEOINT32), trips_null,
    fare, pax; zones (the zid and int32 POLYGON payload of each zone);
    stations_xy."""
    rng = np.random.default_rng(seed)
    xy = _points(rng, trips)
    null = rng.random(trips) < POINT_NULL_SHARE
    fare = rng.uniform(2.5, 80.0, trips)
    pax = rng.integers(1, 7, trips).astype(np.int16)
    zones = [(zid, _polygon_row(ring, hole)) for zid, ring, hole in zone_rings(seed + 1)]
    sxy = _points(rng, STATIONS)
    frag = f"WITH (fragment_size={FRAGMENT_ROWS})"
    db.sql(f"CREATE TABLE trips (p GEOMETRY(POINT, 4326), fare DOUBLE, pax SMALLINT) {frag}")
    _insert(db, "trips", {"p": _object_rows(xy, null), "fare": fare, "pax": pax})
    db.sql("CREATE TABLE zones (zid INT, zone GEOMETRY(POLYGON, 4326))")
    _insert(db, "zones", {"zid": np.array([z for z, _ in zones], np.int32),
                          "zone": _object_rows([r for _, r in zones],
                                               np.zeros(len(zones), bool))})
    db.sql("CREATE TABLE stations (sid INT, s GEOMETRY(POINT, 4326))")
    _insert(db, "stations", {"sid": np.arange(1, STATIONS + 1, dtype=np.int32),
                             "s": _object_rows(sxy, np.zeros(STATIONS, bool))})
    return dict(trips_xy=xy, trips_null=null, fare=fare, pax=pax, zones=zones,
                stations_xy=sxy)


def load_arrays(db, n: int, seed: int) -> Dict[str, np.ndarray]:
    """CREATE TABLE arr and load `n` rows made on the host from `seed`
    (the module docstring's schema).  Returns the flat elements (INT32_MIN
    for a NULL element), each row's offsets into them, the NULL arrays and
    w."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, ARRAY_MAX_LEN + 1, n)
    null = rng.random(n) < ARRAY_NULL_SHARE
    lengths[null] = 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = rng.integers(0, ARRAY_VALUES, int(offsets[-1])).astype(np.int32)
    flat[rng.random(flat.shape[0]) < ELEMENT_NULL_SHARE] = np.iinfo(np.int32).min
    w = rng.random(n)
    bounds = offsets.tolist()
    parts = [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    db.sql(f"CREATE TABLE arr (vals INT[], w DOUBLE) WITH (fragment_size={FRAGMENT_ROWS})")
    _insert(db, "arr", {"vals": _object_rows(parts, null), "w": w})
    return dict(flat=flat, offsets=offsets, null=null, w=w)
