"""On-card smoke test of the PyTorch/CUDA port (heavydb_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100); exits non-zero without one.  (With
--multihost-worker MODE PID NPROCS PORT it is one host of the multihost
phase's cluster, which the script starts itself.)  Phases, each
printing JSON lines:

  env      card, power limit, torch / CUDA / nvcc versions
  build    builds kernels B1-B6, B3a-c and J1 from heavydb_tpu_torch/kernels/csrc
           into build/kernels and runs the kernel gate
  kernel_info  registers, shared memory and resident blocks per SM of B1,
           B2 (each tier, with its cluster size), B3 and B4-B6 as they are
           launched
  sass     the shared-memory atomics B1, B2, B3 and B3a-c compile to
           (cuobjdump), once; B3's int32 MIN / MAX must be native
  kernels  each kernel against its plain PyTorch version at 100M rows and
           the shapes the main path gives it; times with CUDA events.  B1 at
           10 / 100 / 256 slots with a copy of the cells a warp and a
           block, B2 on each of its tiers with 4 and with 16 streams and
           its cluster tier against its global one at 2-16 blocks; both at
           100M + 3 rows, offset by one element, with int64 sums past 2^32,
           a NaN and an inf, and 17 streams (two launches).  B3 at 1000
           and 4096 slots, MIN and MAX over int32 and float32, timed one
           call at a time and 20 back to back, beside a counts-only launch
           of the same body; at 100M + 3 rows, offset by one element, and
           with its values offset from gid, over NaN, +-inf, -0.0 and the
           int32 extremes.  B3a-c
           (kernels/groupby_slots.py), which no SQL route runs, are driven
           through their own entry points here and count launches there;
           also at 100M + 3 rows and on inputs offset by one element.  B4
           at 1024-, 4096- and 16384-key tiles (16 keys a thread); B5 with
           6 streams and with none; B6 counts only, with 6 streams, and
           skewed (partitions past 4096 rows and a hot group in each).
           J1 (the perfect join build's slots and counts) at lineitem's
           67M padded rows over 6 x 10^7 keys with 1 / 63 / 100 % kept,
           16M unique keys and 25 keys, beside torch.bincount
  e2e      connect() on CUDA, a 100M-row table of the synthetic benchmark's
           schema loaded on the device, eleven SELECTs through db.sql(),
           each checked against numpy and timed; the kernel launch counters
           must rise on this path, each query on its own route, and no
           query may run in fragment waves
  stream   Q1K_MINMAX, Q10M_AGGS and an AVG query on the same table in
           fragment waves: forced by a 1 MB stream threshold, then by the
           device-memory term with the free-memory read stubbed; each
           equal to numpy, with its waves, warm ms and peak device bytes;
           a stub below one fragment's need raises before any launch
  sort     the ORDER BY queries of tools/synthetic.py SORT_QUERIES on the
           same table (LIMIT alone, single-key top-k on a FLOAT and on a
           tied INT key, a packed two-key top-k, GROUP BY ... ORDER BY ...
           LIMIT, a full three-column sort of ~10M rows) and the FLOAT
           top-k again in fragment waves (a 1 MB stream threshold, >= 3
           waves); each equal to numpy, rows and order, with its warm ms,
           waves and kernel launches (counted from 0 for this phase);
           beside them torch.topk and one stable torch.sort of the top-k
           keys, and the full sort's time split into sort passes and
           payload gathers
  join     the join + GROUP BY queries of tools/synthetic.py JOIN_QUERIES
           on the same table and four dimension tables made on the device
           (tools/synthetic.py load_dims): a perfect-unique build of 10^3
           and of 10^7 keys, a hash build over sparse BIGINT keys with its
           expansion, a LEFT join with a 1:3 fan-out that retries its
           capacity once, and SEMI + ANTI; each equal to numpy, with its
           warm ms, each join level's build form, caps and retries, its
           peak device bytes and its kernel launches (counted from 0 for
           this phase); J1 launches on each perfect build
  join_split  JOIN_SPARSE's hash probe beside a binary-search probe of the
           same keys, its sorted and hash builds and its expansion, and
           JOIN_DIM10M's perfect build and unique probe, timed apart
  join_shapes  FULL, CROSS, range- and hash-packed key pairs, LEFT and SEMI
           with a residual, TEXT keys of two dictionaries and a projection
           in ORDER BY order on small tables: the same rows on CUDA as on
           the CPU
  subq     the subquery and set-operation queries of tools/synthetic.py
           SUBQ_QUERIES on the same tables: a scalar subquery in HAVING,
           TPC-H Q18's IN over a radix-tier GROUP BY (its IN list's size and
           host copy time), NOT IN, UNION ALL, INTERSECT and ROLLUP; each
           equal to numpy, with its warm ms, the tier of each Compound, join
           builds, peak device bytes and kernel launches (counted from 0 for
           this phase)
  set_shapes  nested IN, EXISTS / NOT EXISTS, a scalar subquery with no row
           and with two (an error), NOT IN over a NULL, IN and UNION across
           two dictionaries, INT with BIGINT and FLOAT under UNION ALL,
           INTERSECT / EXCEPT with NULL rows, CUBE, GROUPING SETS, a CTE read
           twice, ANY / ALL, scalar subqueries in the select list and a join
           filter on 20,000-row tables: the same rows on CUDA as on the CPU
  distinct the DISTINCT_QUERIES of tools/synthetic.py on bench: COUNT
           (DISTINCT) on its hash form (the hash group-by on; its claim
           rounds) and its sorted form, SUM / AVG (DISTINCT),
           APPROX_COUNT_DISTINCT (equal to a host copy of the reference's
           HyperLogLog), APPROX_QUANTILE (within the sketch's bound of the
           exact median) and MODE; measured as the subq phase
  distinct_shapes  every DISTINCT-family aggregate over INT, BIGINT, FLOAT
           and DOUBLE with NULLs, NaN and -0.0, keyless, grouped and on the
           sort tier, on CUDA against the CPU; the hash form against the
           sorted one over 2^21 + 4096 rows; a claim table made to leave a
           row unresolved reruns on the sorted form
  strings  the dictionary-string queries of tools/synthetic.py
           STRING_QUERIES on a second 100M-row table made on the device
           (load_strings: TPC-H lineitem rows with the l_shipmode,
           l_shipinstruct, p_type and c_name vocabularies, 1 % NULL): CMP,
           IN, LIKE, a 10^6-entry LIKE (cold and warm), MIN / MAX over TEXT,
           a transform key and a pair concatenation with a pair comparison;
           each equal to numpy, with its warm ms, group-by tier, peak device
           bytes and kernel launches (counted from 0 for this phase)
  string_shapes  every dictionary predicate kind, chained transforms, a
           transform in ORDER BY, col || 'c' || col, the six pair
           comparisons, MIN / MAX over TEXT at 50 and 3000 groups (B1, B3),
           TEXT ENCODING NONE and the pair-table cap on 20,000-row tables:
           the same rows on CUDA as on the CPU
  hash     the hash group-by tier's HASH_QUERIES of tools/synthetic.py on
           a 10^7-row table made on the device (load_hsparse: a BIGINT key
           and an INT pair of 20,000 distinct values each, 500 rows a key,
           which the reference's estimator puts ~20 x too high, inside its
           rule): each equal to numpy, on the hash tier,
           with its NDV estimate (and an estimate's ms), claim-table cap,
           retries, claims, warm ms, peak device bytes and launches, and
           beside it the same query with the hash group-by off (the sort
           tier); BH003 on bench with the flag on stays on the sort tier;
           then both tiers again at 400,000 keys (25 rows a key), whose
           estimate the rule refuses, with the estimate set to the true
           count (the _TRUE_NDV lines)
  hash_shapes  single keys of INT, BIGINT, FLOAT and DOUBLE with NULL,
           NaN, -0.0, subnormals and +-inf, a range-packed pair with NULLs,
           HAVING and ORDER BY at a 4096-slot claim table (B2 at 16384
           slots), and a forced hash_unresolved retry: the same rows on
           CUDA as on the CPU
  window   tools/synthetic.py WINDOW_QUERIES on bench: WIN_RUNNING (the
           reference's window benchmark shape: a running SUM with RANGE
           peers and ROW_NUMBER over one spec, the sorted egress and a
           packed key, B1 over 10 slots), WIN_TOPN (RANK over a FLOAT key,
           the generic sort, a filter over it) and WIN_FRAMES (three specs
           and the permutation egress: a bounded ROWS AVG and MIN, a LAG, a
           DENSE_RANK with no partition, B1 over 100 slots); each equal to
           rows computed apart in plain torch on the card (stable sorts of
           packed keys, direct frame sums), with its first and warm ms, each
           spec's egress mode and sort, peak device bytes, launches (counted
           from 0 for this phase) and a torch.profiler breakdown
  window_split  the plain scans of ops/window.py alone at 10^8 rows: the
           running MIN / MAX with resets on its blocked and doubling forms,
           the blocked running maximum beside torch.cummax, a segmented
           propagation, the running sum, the packed key's sort
  window_shapes  every window kind, frame form, IGNORE NULLS case,
           NULL / NaN / -0.0 / subnormal key, a string order key, both egress
           modes and both sorts, windows over GROUP BY results (B1 and B2)
           on small tables: the same rows on CUDA as on the CPU
  udf      UDF_QUERIES on bench: UDF_GROUP, a SUM of the scalar UDF HYPOT
           (register_udfs) on B1 over 100 slots, against numpy, measured as
           the window cells
  udf_shapes  every built-in table function, the fits, k-means and PCA over
           a CURSOR of ~5 x 10^5 bench rows, and a table function in a join, on
           CUDA against the port on the CPU holding those rows
  dml      tools/synthetic.py DML_STEPS on bench after every phase that
           reads it: UPDATE (~10^5 rows in each fragment), DELETE (~10^5
           rows), CREATE TABLE AS SELECT (~3 x 10^7 rows), INSERT ... SELECT
           (~10^7) and TRUNCATE; for each, its ms, matched rows, fragments
           touched, bytes copied each way and the scan cache's bytes, then
           its follow-up queries against a numpy model of the tables (no
           upload after an UPDATE or a DELETE: the cache was patched on the
           card), with warm ms and launches
  geo      load_geo's tables made from the seed (tools/synthetic.py: 10^7
           GEOINT32 pickups over the NYC box, 263 jittered grid zones of 64
           vertices, some with a hole, 2000 stations; the load's seconds on
           a line of its own), then GEO_QUERIES: an ST_DWithin filter, the
           zone join (poly_build grid join, the CONTAINS_SEG ray cast, B2
           over 263 slots) and the station join (dwithin grid join); each
           equal to rows independent of the engine (numpy for the filter,
           a brute force of every point against every zone or station in
           plain torch float64 on the card for the joins), with its first
           and warm ms, join builds, caps and retries, peak device bytes,
           launches (counted from 0 for this phase), the ray cast's ms
           apart, and a torch.profiler breakdown (busy, idle share, the ray
           cast's device ms and launches)
  geo_shapes  every ST_* of the reference's geo suites, the three grid-join
           kinds (poly_probe included), holes, multipolygons, NULL and
           GEOINT32 geometries on small tables: the same rows on CUDA as on
           the CPU
  arrays   load_arrays' arr (10^7 rows of 0-8 INT elements) and
           ARRAY_QUERIES (UNNEST under GROUP BY, ANY with a subscript),
           measured as the geo cells against numpy over the generator's
           elements
  array_shapes  every ArrayFn op, UNNEST in the projection, under GROUP BY,
           after a filter and over TEXT[], CTAS, INSERT ... SELECT and
           DELETE with arrays: the same rows on CUDA as on the CPU
  hot_key  a 4M-row table where 60 % of the rows share one key of a 2^22
           key space: the radix tier flags the partition overflow and the
           query reruns on the sort tier, still equal to numpy
  controls the per-query controls on bench after the dml phase, launches
           counted from 0: EXPLAIN / EXPLAIN CALCITE / EXPLAIN OPTIMIZED of
           the eleven e2e queries (the kernels the OPTIMIZED program names
           must be the e2e route's); Q1K_MINMAX's plan / execute / fetch
           scopes under enable_debug_timer; the keep_result recycler (miss,
           hit, rows against numpy); Q10M_AGGS in 3 fragment waves stopped
           by an interrupt after its first wave and by a query_time_limit(1)
           hint (raised in the next wave, device bytes back, the next run
           equal to numpy); 8 threads of Q1K_MINMAX and PHS002 at
           max_concurrent_queries 1 and 4 and under a max_exec_bytes that
           admits one (rows against numpy, wall, p50 / p99, info()); the
           eleven e2e cells' warm ms with the resource manager on and off,
           in turns; an INSERT into bench, after which the recycled query
           misses
  upload   bench's host columns into a new table by load_table, its first
           query (Q100_MINMAX's shape) through one pageable copy, the
           staging ring wide and the staging ring narrow: ms, bytes on the
           wire, GB/s, device columns bit-equal; prestage_table; a BIGINT of
           int16-range values with 1 % NULL at 10^8 rows (2 bytes a row on
           the wire, rows against numpy)
  ddl      ADD COLUMN with a DEFAULT on bench and a query on it, DROP /
           RENAME COLUMN, RENAME TABLE, a view of Q1K_MINMAX's shape and
           Q1K_MINMAX under a row-level policy on x10 beside the
           superuser's, against numpy over the rows kept; statement ms and
           bytes; everything added dropped again
  persist  a database on disk on CUDA under build/ (free disk checked
           first, the directory removed at the end): bench's host columns by
           load_table, a checkpoint (seconds, bytes per column and
           encoding), the database released and reopened (seconds), the
           eleven e2e queries on the reopened table (first and warm ms, the
           first run's uploads, each on its e2e route against numpy), an
           UPDATE and an INSERT of one row (ms with the checkpoint, chunk
           bytes rewritten), a set_table_epoch rollback (the old rows
           against numpy, the rolled-back generation's device bytes freed),
           DUMP and RESTORE of a 5 x 10^6-row table (the dropped table's device
           bytes freed) and a query on it; then bench made on the device at
           5 x 10^6 rows (cut from 10^8 for the script's time) in a second
           database and its first checkpoint (a device-to-host copy a
           chunk); the first directory stays for the server phase
  server   the port's server on CUDA over that directory (serve, in
           process; start-up seconds): NGA03, PHM001, Q100_MINMAX, PHS002,
           Q1K_MINMAX, Q10K, PHS003, BH002 and BH003 through
           Connection.sql against numpy on their e2e routes (first and
           warm ms beside the same query's warm ms in process, bytes of
           JSON); BH004 and Q10M_AGGS wrapped in SELECT COUNT(*), SUM(...)
           FROM (...) t, their inner Compound on the radix tier (B5 + B6);
           sql_execute_df of Q1K_MINMAX against sql; four sessions of four
           queries at once over TCP and as four threads in process; a
           columnar load of 10^6 rows (seconds, bytes on the wire); an
           INSERT into a small table that returns while another session
           reads bench; PHS002 over HTTP; the device bytes back after the
           shutdown.  Then a second server on the directory with a 1 MB
           stream threshold: a session's wrapped Q10M_AGGS interrupted in
           its waves while another session runs Q1K_MINMAX (the victim
           raises, the survivor's rows equal numpy, no device bytes left);
           the directory is removed
  copy     5 x 10^6 rows of bench's columns (cut from 10^8 for the script's
           time) COPY'd TO a CSV and to parquet, then FROM the CSV through
           the native parser and through pandas and FROM the parquet: rows/s
           each way, Q1K_MINMAX's shape on each table against numpy (first
           and warm ms, B2 + B3); a COPY of the CSV appended to the 10^8-row
           bench (host ms)
  fsi      a delimited and a parquet foreign table over those files: the
           first query (the lazy read and the upload) and the warm one
           against numpy; the CSV cut to half its rows and REFRESH FOREIGN
           TABLES: the new rows against numpy, the old generation's device
           bytes freed
  io_shapes  GeoJSON points and polygons, an ESRI ASCII grid, XYZ points, a
           GeoTIFF and a stream importer of six batches, imported into a
           CUDA database and into the port on the CPU: the same rows, B1 and
           B2 launched; then three stream batches into a table past
           eager_staging_min_rows, the bytes each puts on the wire
  cast_shapes  faults F3 and F4: every FLOAT / DOUBLE -> integer CAST over
           the edges and values around each target's range, ROUND /
           TRUNCATE of a FLOAT at half-way points and near FLT_MAX: the
           same bits on CUDA as on the CPU
  sharded  Config.num_shards' path in one process, after subq on the e2e
           Database: NGA03, PHM001, Q100_MINMAX, PHS002, Q1K_MINMAX, Q10K,
           BH004, Q10M_AGGS, TOPK_V and JOIN_DIM1K on the executor's mesh
           set to Mesh([cuda:0] * 4) (each shard's block a view of the
           resident column, a leaf a shard, the merge), against numpy:
           the recorded mode and tiers, the route's kernels launched at
           least once a shard, warm ms beside the unsharded warm ms, the
           peak; then the mesh put back.  On two or more cards the same
           under Config(num_shards=cards) over distinct cards with each
           card's busy ms; on one card a line says that part did not run
  multihost  parallel/* on this card, after the other phases: in process,
           Config(num_shards=cards + 1) raises the reference's ValueError and
           Q1K_MINMAX under num_shards=1 runs on its e2e route against
           numpy; the five shard-map steps of parallel/dist_query.py on
           Mesh([cuda:0] * 4) at 10^7 rows (half the rows on one key)
           against numpy, the join and the shuffle with bins that hold
           every row and with bins the skew overflows.  Then a 2-process
           cluster on this card: two copies of this script started with
           --multihost-worker, joined by a gloo group on localhost, each
           host loading its half of the rig's 2 x 10^7-row fact table and
           the other tables (tools/synthetic.py multihost_data /
           load_multihost; fact declared with v FLOAT) and running
           MULTIHOST_QUERIES twice (first, warm) against a vectorized numpy
           oracle over the full data: wall, engine and exchange ms, bytes
           sent, gathered and padded, kernel launches, device bytes; then
           each host's partition of 2 x 10^6 rows written to a database
           on disk under build/, both processes restarted
           (check_table_consistency, the rows again) and a divergence
           (host 1 deletes rows: every host raises NotSupported).  The
           exchange runs on the host over gloo with both processes on one
           card: no number of it is a multi-GPU figure
Then each new phase's seconds, the script's wall time, the env line
again, the kernel summary line (its launches are those of the e2e, sort,
join, subq, sharded, distinct, strings, hash, window, window_shapes, udf,
udf_shapes, dml, geo, geo_shapes, arrays, array_shapes, controls, upload,
ddl, persist, server, copy, fsi, io_shapes and multihost phases, the
cluster hosts' included), the card line, and
the final {"ok": true, "device": ...} line.  Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from heavydb_tpu_torch.tools import synthetic
from heavydb_tpu_torch.tools.synthetic import (JOIN_QUERIES, QUERIES, SORT_QUERIES,
                                               load_bench, load_dims)

ROWS = 100_000_000
SEED = 20261016
# tolerances: counts / integer sums / MIN / MAX exact; float64 sums and
# AVG rtol=1e-9; float32 sums rtol=1e-4, atol=1e-3 (summation order)
F32_TOL = dict(rtol=1e-4, atol=1e-3)
F64_TOL = dict(rtol=1e-9, atol=1e-9)

# kernel, CUDA source, the TPU pallas_call it replaces, and the slot count
# its row of the summary line is taken at
KERNELS = [
    ("lane_agg", "heavydb_tpu_torch/kernels/csrc/lane_agg.cu",
     "heavydb_tpu/kernels/lane_agg.py:158", 100),
    ("radix_hist", "heavydb_tpu_torch/kernels/csrc/radix_hist.cu",
     "heavydb_tpu/kernels/radix_hist.py:198", 1000),
    ("groupby_minmax", "heavydb_tpu_torch/kernels/csrc/groupby_minmax.cu",
     "heavydb_tpu/kernels/groupby_pallas.py:302", 1000),
    ("tile_sort", "heavydb_tpu_torch/kernels/csrc/tile_sort.cu",
     "heavydb_tpu/kernels/tile_sort.py:141", "4 payloads"),
    ("radix_partition", "heavydb_tpu_torch/kernels/csrc/radix_groupby.cu",
     "heavydb_tpu/kernels/radix_groupby.py:425", "6 streams"),
    ("radix_group", "heavydb_tpu_torch/kernels/csrc/radix_groupby.cu",
     "heavydb_tpu/kernels/radix_groupby.py:657", "6 streams"),
    ("count_per_slot", "heavydb_tpu_torch/kernels/csrc/groupby_slots.cu",
     "heavydb_tpu/kernels/groupby_pallas.py:142", 1000),
    ("sum_f32_per_slot", "heavydb_tpu_torch/kernels/csrc/groupby_slots.cu",
     "heavydb_tpu/kernels/groupby_pallas.py:177", 1000),
    ("sum_int_per_slot", "heavydb_tpu_torch/kernels/csrc/groupby_slots.cu",
     "heavydb_tpu/kernels/groupby_pallas.py:243", 1000),
]
KERNEL_NAMES = tuple(k[0] for k in KERNELS)

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def mem_rate(card: str) -> float:
    """Device memory bytes/s of the card (NVIDIA data sheets)."""
    return 2.0e12 if "PCIe" in card else 3.35e12


def timed(fn, reps: int) -> float:
    """Median ms over `reps` runs after one warm-up run (CUDA events)."""
    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, launches: int = 20) -> float:
    """ms a call of fn takes with `launches` calls back to back (CUDA events
    around all of them, after one warm-up run), so the wrapper's host work
    overlaps the kernels instead of adding to them."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / launches


def agree(got, want, tol=None) -> float:
    """Raise unless got == want (exact, or within tol); return max |err|."""
    got = got.double().cpu().numpy() if got.is_floating_point() else got.cpu().numpy()
    want = want.double().cpu().numpy() if want.is_floating_point() else want.cpu().numpy()
    if tol is None or got.dtype.kind != "f":
        if not np.array_equal(got, want):
            raise AssertionError(f"mismatch: {got[:8]} vs {want[:8]}")
        return 0.0
    np.testing.assert_allclose(got, want, **tol)
    fin = np.isfinite(want)
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

SPARSE_SLOTS = 10_000_000
SORT_TILE = 4096  # B4's tile in the summary line
SORT_TILES = (1024, 4096, 16384)
# B6's skewed shape: one group of SKEW_ROWS rows added to each of
# SKEW_PARTS partitions, so each of those holds ~3052 + 4500 rows, between
# SMALL_TILE and GROUP_TILE (the second launch), with no bit 0
SKEW_PARTS = 64
SKEW_ROWS = 4500


def kernel_inputs(n: int, num_slots: int, gen):
    """gid, row mask and one tensor of its own for every stream, so each
    byte the bound counts is a byte the kernel reads from memory."""
    def rand():
        return torch.rand(n, device="cuda", generator=gen)

    def ints():
        return torch.randint(1, 10_001, (n,), dtype=torch.int32, device="cuda",
                             generator=gen)

    gid = torch.randint(0, num_slots, (n,), dtype=torch.int32, device="cuda",
                        generator=gen)
    mask = rand() < 0.9
    cm = mask & (rand() < 0.8)
    vals = {"count": cm, "sumi": torch.where(cm, ints(), 0),
            "sumf": torch.where(cm, rand(), 0.0),
            "sumd": torch.where(cm, rand(), 0.0),
            "min": torch.where(cm, ints(), 0), "max": torch.where(cm, rand(), 0.0)}
    return gid, mask, vals


def out_bytes(v, op) -> int:
    """Bytes per slot of a stream's result: int64 / float64 sums and
    counts, MIN / MAX in the value's dtype."""
    return v.element_size() if op in ("min", "max") else 8


# B1 and B2 at the main path's stream sets
B1_OPS = ["count", "sumi", "sumf", "sumd", "min", "max"]
B2_OPS = ["count", "sumi", "sumf", "sumd"]
B1_SHAPES = (10, 100, 256)
# one shape on each tier of radix_hist.plan with 4 streams: four 256-thread
# blocks, two 512-thread blocks, one 1024-thread block an SM, clusters of
# 2 and 4, global atomics
B2_SHAPES = (1000, 3000, 6000, 10_000, 24_577, 65_536)
# 16 streams of every B2 class, and their tiers (256 / 512 / 1024-thread
# private copies, clusters of 2 and 4, global atomics)
B2_WIDE = [("count", torch.bool), ("sumi", torch.bool), ("sumi", torch.int8),
           ("sumi", torch.int16), ("sumi", torch.int32), ("sumi", torch.int64),
           ("sumf", torch.float32), ("sumd", torch.float32), ("sumd", torch.float64),
           ("count", torch.bool), ("sumi", torch.int8), ("sumi", torch.int16),
           ("sumi", torch.int32), ("sumi", torch.int64), ("sumf", torch.float32),
           ("sumd", torch.float64)]
B2_WIDE_SHAPES = (300, 800, 1500, 3000, 6000, 65_536)


def tol_of(op):
    return F32_TOL if op == "sumf" else (F64_TOL if op == "sumd" else None)


def check_streams(got, want, streams) -> float:
    err = 0.0
    for (_, op), g, w in zip([(None, "count")] + list(streams), got, want):
        err = max(err, agree(g, w, tol_of(op)))
    return err


def plan_of(name, num_slots, ops):
    """The plan the wrapper launches B1 / B2 / B3 (`name`) with."""
    from heavydb_tpu_torch.kernels import groupby_minmax, lane_agg, radix_hist

    if name == "lane_agg":
        return lane_agg.plan(num_slots, ops)
    if name == "groupby_minmax":
        return groupby_minmax.plan(num_slots)
    return radix_hist.plan(num_slots, ops)


def plan_fields(p) -> dict:
    return dict(tier=p.tier, cluster=p.cluster, threads=p.threads,
                smem_bytes=p.smem_bytes)


def agg_bytes(n, num_slots, mask, streams) -> int:
    """Bytes B1 / B2 must move: each input read once (gid, mask, each
    stream at its width), each per-slot output written once."""
    read = n * (4 + (mask.element_size() if mask is not None else 0)
                + sum(v.element_size() for v, _ in streams))
    return read + num_slots * (8 + sum(out_bytes(v, op) for v, op in streams))


def wide_streams(n, gen, cm):
    """B2_WIDE: one tensor a stream, zero where cm is False."""
    out = []
    for op, dt in B2_WIDE:
        if dt == torch.bool:
            v = cm & (torch.rand(n, device="cuda", generator=gen) < 0.5)
        elif dt.is_floating_point:
            v = torch.where(cm, torch.rand(n, device="cuda", generator=gen,
                                           dtype=dt) * 100, 0.0).to(dt)
        else:
            info = torch.iinfo(dt)
            v = torch.where(cm, torch.randint(info.min, info.max, (n,), device="cuda",
                                              generator=gen, dtype=torch.int64),
                            0).to(dt)
        out.append((v, op))
    return out


def run_kernels(n: int, rate: float):
    from heavydb_tpu_torch.kernels import _plain, lane_agg, radix_hist

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    shapes = []
    fns = {"lane_agg": lane_agg.lane_agg, "radix_hist": radix_hist.fused_hist}
    cases = [("lane_agg", S) for S in B1_SHAPES] + [("radix_hist", S) for S in B2_SHAPES]
    for name, num_slots in cases:
        ops = B1_OPS if name == "lane_agg" else B2_OPS
        gid, mask, vals = kernel_inputs(n, num_slots, gen)
        streams = [(vals[op], op) for op in ops]
        del vals
        plan = plan_of(name, num_slots, ops)
        run = lambda: fns[name](gid, mask, streams, num_slots)  # noqa: E731
        err = check_streams(run(), _plain.scatter_scan(gid, mask, streams, num_slots),
                            streams)
        line = dict(kernel=name, rows=n, slots=num_slots, streams=ops,
                    max_abs_err=err, **plan_fields(plan), ms=timed(run, 10),
                    plain_ms=timed(lambda: _plain.scatter_scan(gid, mask, streams,
                                                               num_slots), 3),
                    bound_ms=agg_bytes(n, num_slots, mask, streams) / rate * 1e3,
                    # yardstick: per-slot counts alone, the kernel with no
                    # streams against torch.bincount (unmasked gid)
                    counts_only_ms=timed(lambda: fns[name](gid, None, [], num_slots), 10),
                    bincount_ms=timed(lambda: torch.bincount(gid, minlength=num_slots), 10),
                    counts_only_bound_ms=(n * 4 + num_slots * 8) / rate * 1e3,
                    counts_only_tier=plan_of(name, num_slots, []).tier)
        shapes.append(line)
        del gid, mask, streams
    # B2 with 16 streams of every class, on each tier
    wide_tiers = set()
    for num_slots in B2_WIDE_SHAPES:
        gid, mask, vals = kernel_inputs(n, num_slots, gen)
        streams = wide_streams(n, gen, vals["count"])
        del vals
        ops = [op for _, op in streams]
        err = check_streams(radix_hist.fused_hist(gid, mask, streams, num_slots),
                            _plain.scatter_scan(gid, mask, streams, num_slots), streams)
        plan = radix_hist.plan(num_slots, ops)
        wide_tiers.add((plan.tier, plan.cluster, plan.threads))
        shapes.append(dict(
            kernel="radix_hist", tag="16 streams", rows=n, slots=num_slots,
            streams=[f"{op} {str(v.dtype)[6:]}" for v, op in streams],
            max_abs_err=err, **plan_fields(plan),
            ms=timed(lambda: radix_hist.fused_hist(gid, mask, streams, num_slots), 10),
            plain_ms=timed(lambda: _plain.scatter_scan(gid, mask, streams, num_slots), 3),
            bound_ms=agg_bytes(n, num_slots, mask, streams) / rate * 1e3))
        del gid, mask, streams
    want_tiers = {("shared", 1, 256), ("shared", 1, 512), ("shared_sm", 1, 1024),
                  ("cluster", 2, 1024), ("cluster", 4, 1024), ("global", 1, 256)}
    if wide_tiers != want_tiers:
        raise AssertionError(f"16-stream shapes cover tiers {sorted(wide_tiers)}, "
                             f"not {sorted(want_tiers)}")
    shapes += agg_edges(n, rate)
    shapes += run_minmax(n, rate, gen)
    torch.cuda.empty_cache()
    return shapes


B3_SHAPES = (1000, 4096)


def run_minmax(n: int, rate: float, gen):
    """B3 at 1000 and 4096 slots: MIN and MAX over int32 and float32 against
    the plain version; `timed` (one call at a time), device time (20 calls
    back to back) and `scatter_reduce` for each; a counts-only launch of the
    same body (B2 with no stream, the same mask) for the count cells B3
    computes and drops.  The line without a tag (MAX float32) is the
    summary's."""
    from heavydb_tpu_torch.kernels import _plain, groupby_minmax, radix_hist

    lines = []
    for num_slots in B3_SHAPES:
        gid, _, vals = kernel_inputs(n, num_slots, gen)
        cm, i32, f32 = vals["count"], vals["min"], vals["max"]
        del vals
        idx = _plain.slot_index(gid, cm, num_slots)
        counts_only = lambda: radix_hist.fused_hist(gid, cm, [], num_slots)  # noqa: E731
        for v in (f32, i32):
            for is_min in (False, True):
                op = "min" if is_min else "max"
                kind = str(v.dtype)[6:]
                run = lambda: groupby_minmax.minmax_per_slot(  # noqa: E731
                    gid, v, cm, num_slots, is_min)
                plain = lambda: groupby_minmax.minmax_per_slot_plain(  # noqa: E731
                    gid, v, cm, num_slots, is_min)
                agree(run(), plain())
                buf = torch.full((num_slots + 1,), _plain.minmax_ident(v.dtype, is_min),
                                 dtype=v.dtype, device="cuda")
                line = dict(
                    kernel="groupby_minmax", rows=n, slots=num_slots,
                    streams=[f"{op} {kind}"], max_abs_err=0.0,
                    **plan_fields(groupby_minmax.plan(num_slots)),
                    ms=timed(run, 10), device_ms=device_ms(run),
                    plain_ms=timed(plain, 3),
                    bound_ms=(n * 9 + num_slots * 4) / rate * 1e3,
                    library_ms=timed(lambda: buf.scatter_reduce(
                        0, idx, v, "amin" if is_min else "amax"), 10))
                if (op, kind) != ("max", "float32"):
                    line["tag"] = f"{op} {kind}"
                else:
                    line.update(counts_only_ms=timed(counts_only, 10),
                                counts_only_device_ms=device_ms(counts_only),
                                counts_only_bound_ms=(n * 5 + num_slots * 8) / rate * 1e3)
                lines.append(line)
        del gid, cm, i32, f32, idx
    torch.cuda.empty_cache()
    return lines + minmax_edges(n, rate)


def same_minmax(got, want):
    """B3's result against the plain version: NaN where it has NaN, equal
    values elsewhere (-0.0 == +0.0; its sign is checked on its own)."""
    g, w = got.cpu(), want.cpu()
    if g.is_floating_point():
        if not torch.equal(g.isnan(), w.isnan()):
            raise AssertionError("groupby_minmax: NaN slots differ")
        g, w = g[~g.isnan()], w[~w.isnan()]
    agree(g, w)


def minmax_edges(n: int, rate: float, S: int = 1000):
    """B3 at n + 3 rows (a ragged tail), on views one element into their
    storage (a scalar head) and with only the values one element off gid
    (loaded one at a time), over float32 values with a NaN, +inf, -inf and
    slots of -0.0 and +0.0, and int32 values with both extremes; MIN and
    MAX each against the plain version, and the -0.0 / +0.0 slots by their
    sign."""
    from heavydb_tpu_torch.kernels import groupby_minmax as GM

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    m = n + 4
    gid = torch.randint(-3, S + 3, (m,), dtype=torch.int32, device="cuda",
                        generator=gen)
    mask = torch.rand(m, device="cuda", generator=gen) < 0.9
    f32 = torch.randn(m, device="cuda", generator=gen)
    i32 = torch.randint(-2**31, 2**31 - 1, (m,), dtype=torch.int32, device="cuda",
                        generator=gen)
    # slots 1-3 get a NaN, +inf and -inf; slots 4 and 5 hold only zeros (-0.0
    # and +0.0, then -0.0 alone); i32 gets both extremes
    gid[gid == 4] = 6
    gid[gid == 5] = 6
    plant = {10: (1, float("nan")), 20: (2, float("inf")), 30: (3, float("-inf")),
             40: (4, -0.0), 41: (4, 0.0), 50: (5, -0.0)}
    for r, (g, x) in plant.items():  # rows every view holds
        gid[r], mask[r], f32[r] = g, True, x
    i32[60], i32[61] = -2**31, 2**31 - 1
    views = (("n + 3 rows", slice(0, n + 3), slice(0, n + 3)),
             ("offset by one element", slice(1, n + 4), slice(1, n + 4)),
             ("values offset from gid", slice(0, n + 3), slice(1, n + 4)))
    lines = []
    for tag, rows, vrows in views:
        g, mk = gid[rows], mask[rows]
        for v in (f32, i32):
            for is_min in (True, False):
                got = GM.minmax_per_slot(g, v[vrows], mk, S, is_min)
                same_minmax(got, GM.minmax_per_slot_plain(g, v[vrows], mk, S, is_min))
                if v is f32 and vrows == rows:
                    if not (bool(got[1].isnan()) and float(got[2 + is_min]) ==
                            (float("-inf") if is_min else float("inf"))):
                        raise AssertionError(f"groupby_minmax {tag}: NaN / inf slots")
                    # -0.0 sorts below +0.0: MIN of slot 4 is -0.0, MAX +0.0
                    sign = torch.signbit(got[4:6]).tolist()
                    if sign != ([True, True] if is_min else [False, True]):
                        raise AssertionError(f"groupby_minmax {tag}: signed zeros {sign}")
        lines.append(dict(
            kernel="groupby_minmax", tag=tag, rows=g.shape[0], slots=S,
            storage_offset=[g.storage_offset(), f32[vrows].storage_offset()],
            streams=["min / max float32 / int32"], max_abs_err=0.0,
            ms=timed(lambda: GM.minmax_per_slot(g, f32[vrows], mk, S, False), 10),
            bound_ms=(g.shape[0] * 9 + S * 4) / rate * 1e3))
    del gid, mask, f32, i32
    torch.cuda.empty_cache()
    return lines


def agg_edges(n: int, rate: float):
    """B1 at 100 slots and B2 at 1000 against their plain versions at n + 3
    rows (a ragged tail) and on views one element into their storage (a
    scalar head), with an int64 SUMI stream whose per-slot sums pass 2^32
    and a NaN and an inf in the SUMF stream; then 17 streams, which take a
    second launch."""
    from heavydb_tpu_torch.kernels import _plain, lane_agg, radix_hist

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    m = n + 4
    lines = []
    for name, fn, S, ops in (("lane_agg", lane_agg.lane_agg, 100, B1_OPS),
                             ("radix_hist", radix_hist.fused_hist, 1000, B2_OPS)):
        gid = torch.randint(-3, S + 3, (m,), dtype=torch.int32, device="cuda",
                            generator=gen)
        mask = torch.rand(m, device="cuda", generator=gen) < 0.9
        cm = mask & (torch.rand(m, device="cuda", generator=gen) < 0.8)
        f = torch.where(cm, torch.rand(m, device="cuda", generator=gen), 0.0)
        f[10], f[20] = float("nan"), float("inf")
        gid[10], gid[20], mask[10], mask[20] = 1, 2, True, True
        vals = {"count": cm,
                "sumi": torch.where(cm, torch.randint(-2**40, 2**40, (m,), device="cuda",
                                                      generator=gen), 0),
                "sumf": f,
                "sumd": torch.where(cm, torch.rand(m, device="cuda", generator=gen,
                                                   dtype=torch.float64), 0.0),
                "min": torch.where(cm, torch.randint(-10**6, 10**6, (m,), device="cuda",
                                                     dtype=torch.int32, generator=gen), 0),
                "max": torch.where(cm, torch.randn(m, device="cuda", generator=gen), 0.0)}
        streams = [(vals[op], op) for op in ops]
        for tag, sl in (("n + 3 rows", slice(0, n + 3)),
                        ("offset by one element", slice(1, n + 4))):
            g, mk = gid[sl], mask[sl]
            ss = [(v[sl], op) for v, op in streams]
            want = _plain.scatter_scan(g, mk, ss, S)
            big = int(want[ops.index("sumi") + 1].abs().max())
            if big <= 2**32:
                raise AssertionError(f"{name} {tag}: SUMI sums stay below 2^32")
            sumf = want[ops.index("sumf") + 1]
            if not (bool(sumf.isnan().any()) and bool(sumf.isinf().any())):
                raise AssertionError(f"{name} {tag}: no NaN or inf slot in SUMF")
            err = check_streams(fn(g, mk, ss, S), want, ss)
            lines.append(dict(
                kernel=name, tag=tag, rows=g.shape[0], slots=S,
                storage_offset=g.storage_offset(), streams=ops, max_abs_err=err,
                sumi_max_abs=big, ms=timed(lambda: fn(g, mk, ss, S), 10),
                bound_ms=agg_bytes(g.shape[0], S, mk, ss) / rate * 1e3))
        # 17 streams: the first 16 in one launch, the 17th in a second
        ss = (streams * 17)[:17]
        before = fn.launches
        err = check_streams(fn(gid, mask, ss, S), _plain.scatter_scan(gid, mask, ss, S), ss)
        if fn.launches - before != 2:
            raise AssertionError(f"{name}: 17 streams took {fn.launches - before} "
                                 "launches, not 2")
        lines.append(dict(
            kernel=name, tag="17 streams", rows=m, slots=S, launches=2,
            streams=[op for _, op in ss], max_abs_err=err,
            ms=timed(lambda: fn(gid, mask, ss, S), 10),
            bound_ms=agg_bytes(m, S, mask, ss) / rate * 1e3))
        del gid, mask, cm, f, vals, streams, ss
    torch.cuda.empty_cache()
    return lines


def agg_info():
    """Registers, local and shared bytes, blocks per SM and cluster size of
    B1, B2 and B3 as each shape of the kernels phase launches them."""
    from heavydb_tpu_torch.kernels import _build

    kinds = {"count": "bool", "sumi": "int32", "sumf": "float32", "sumd": "float32",
             "min": "int32", "max": "float32"}
    cases = [("lane_agg", S, [(op, kinds[op]) for op in B1_OPS]) for S in B1_SHAPES]
    cases += [("radix_hist", S, [(op, kinds[op]) for op in B2_OPS]) for S in B2_SHAPES]
    cases += [("radix_hist", S, [(op, str(dt)[6:]) for op, dt in B2_WIDE])
              for S in B2_WIDE_SHAPES]
    cases += [("groupby_minmax", S, [("max", "float32")]) for S in (257,) + B3_SHAPES]
    lines = []
    for name, S, specs in cases:
        plan = plan_of(name, S, [op for op, _ in specs])
        ki = _build.stream_info(name, S, specs, plan)
        if plan.tier == "cluster" and ki["resident_clusters"] < 1:
            raise AssertionError(f"{name} at {S} slots: no cluster fits")
        lines.append(dict(kernel=name, slots=S, streams=len(specs),
                          **{**plan_fields(plan), **ki}))
    return lines


SLOT_SHAPES = (1000, 4096, 65_536)


def run_slot_kernels(n: int, rate: float):
    """B3a-c through their public entry points at n rows and 1000, 4096 and
    65536 slots (65536 takes the global-atomics path of all three), each
    against its plain version, then timed.  No SQL route runs them, so this
    is their path: the counters are set to 0 just before each entry-point
    run and read just after.  Returns the shape lines and those launches."""
    from heavydb_tpu_torch.kernels import _plain, groupby_slots as GS

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    fns = {f.__name__: f for f in (GS.count_per_slot, GS.sum_f32_per_slot,
                                   GS.sum_int_per_slot)}
    path = dict.fromkeys(fns, 0)
    shapes = []
    for S in SLOT_SHAPES:
        gid = torch.randint(0, S, (n,), dtype=torch.int32, device="cuda",
                            generator=gen)
        mask = torch.rand(n, device="cuda", generator=gen) < 0.9
        f32 = torch.randn(n, device="cuda", generator=gen)
        i32 = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                            device="cuda", generator=gen)
        # past +-2^31: each value adds its two's-complement int32
        i64 = torch.randint(-2**40, 2**40, (n,), dtype=torch.int64, device="cuda",
                            generator=gen)
        # the library yardstick of B3c gets the index and the int64 values
        # (int64 ones wrapped) ready-made
        idx = _plain.slot_index(gid, mask, S)
        w32, w64 = i32.to(torch.int64), i64.to(torch.int32).to(torch.int64)
        buf = torch.zeros(S + 1, dtype=torch.int64, device="cuda")
        # name, values, tolerance, library call, bytes read + written
        cases = [
            ("count_per_slot", None, None,
             lambda: torch.bincount(gid, minlength=S), n * 5 + S * 8),
            ("sum_f32_per_slot", f32, F32_TOL,
             lambda: torch.bincount(gid, weights=f32, minlength=S), n * 9 + S * 4),
            ("sum_int_per_slot", i32, None,
             lambda: buf.index_add_(0, idx, w32), n * 9 + S * 8),
            ("sum_int_per_slot", i64, None,
             lambda: buf.index_add_(0, idx, w64), n * 13 + S * 8),
        ]
        for name, v, tol, library, nbytes in cases:
            args = (gid, mask, S) if v is None else (gid, v, mask, S)
            plain = getattr(GS, name + "_plain")
            for f in fns.values():
                f.launches = 0  # the entry-point run starts here
            got = fns[name](*args)
            for k, f in fns.items():
                path[k] += f.launches
            err = agree(got, plain(*args), tol)
            del got
            line = dict(
                kernel=name, rows=n, slots=S, max_abs_err=err,
                ms=timed(lambda: fns[name](*args), 10),
                plain_ms=timed(lambda: plain(*args), 3),
                bound_ms=nbytes / rate * 1e3, library_ms=timed(library, 10),
                path="kernel entry point")
            if v is not None:
                line["values"] = str(v.dtype)[6:]
            if v is i64:
                line["tag"] = "int64 values"
            shapes.append(line)
        del gid, mask, f32, i32, i64, idx, w32, w64, buf, cases, args
    shapes += slot_edges(n, rate)
    torch.cuda.empty_cache()
    if min(path.values()) < 1:
        raise AssertionError(f"a kernel never launched on its entry point: {path}")
    return shapes, path


def slot_edges(n: int, rate: float, S: int = 1000):
    """B3a-c at n + 3 rows (a ragged tail after the 4-row vectors) and on
    views that start one element into their storage (a scalar head before
    gid's first 16-byte boundary), each against its plain version."""
    from heavydb_tpu_torch.kernels import groupby_slots as GS

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    m = n + 4
    gid = torch.randint(-3, S + 3, (m,), dtype=torch.int32, device="cuda",
                        generator=gen)
    mask = torch.rand(m, device="cuda", generator=gen) < 0.9
    f32 = torch.randn(m, device="cuda", generator=gen)
    i64 = torch.randint(-2**40, 2**40, (m,), dtype=torch.int64, device="cuda",
                        generator=gen)
    i32 = i64.to(torch.int32)
    lines = []
    for tag, sl in (("n + 3 rows", slice(0, n + 3)),
                    ("offset by one element", slice(1, n + 4))):
        g, mk = gid[sl], mask[sl]
        for name, v, tol, per_row in (
                ("count_per_slot", None, None, 5), ("sum_f32_per_slot", f32, F32_TOL, 9),
                ("sum_int_per_slot", i32, None, 9), ("sum_int_per_slot", i64, None, 13)):
            args = (g, mk, S) if v is None else (g, v[sl], mk, S)
            fn, plain = getattr(GS, name), getattr(GS, name + "_plain")
            err = agree(fn(*args), plain(*args), tol)
            lines.append(dict(
                kernel=name, tag=tag, rows=g.shape[0], slots=S,
                storage_offset=g.storage_offset(),
                values=None if v is None else str(v.dtype)[6:], max_abs_err=err,
                ms=timed(lambda: fn(*args), 10),
                bound_ms=(g.shape[0] * per_row + S * 8) / rate * 1e3))
    return lines


def sass_atomics():
    """The atomic instructions of each B1, B2, B3 and B3a-c kernel as built
    (cuobjdump -sass of its library): whether a shared-memory add is a
    native ATOMS instruction or a compare-and-swap loop (ATOMS.CAST.SPIN).
    B1 / B2 add integer sums as 32-bit halves, so their SUMI cells need no
    64-bit compare-and-swap.  Raises unless B3's shared-memory kernel keeps
    its int32 keys with native ATOMS.MIN and ATOMS.MAX."""
    import os
    import re
    import shutil

    from heavydb_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise FileNotFoundError("cuobjdump not found: the SASS phase cannot run")
    res = {}
    for lib in ("lane_agg", "radix_hist", "groupby_minmax", "groupby_slots"):
        text = subprocess.run([tool, "-sass", _build._lib_path(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        out, fn = {}, None
        for ln in text.splitlines():
            head = re.search(r"Function : (\S+)", ln)
            if head:
                fn = head.group(1)
                continue
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
            if fn and op and op.group(1).startswith(("ATOM", "RED")):
                out.setdefault(fn, set()).add(op.group(1))
        res[lib] = {k: sorted(v) for k, v in out.items()}
    f32 = [ops for k, ops in res["groupby_slots"].items()
           if "SumF32Op" in k and "Lb1E" in k]
    # native 32-bit shared adds that return the old value (the SUMI low
    # word) in B1 / B2's shared-memory instantiations
    native = {lib: sorted(k for k, ops in res[lib].items()
                          if any(o.startswith("ATOMS.ADD") for o in ops))
              for lib in ("lane_agg", "radix_hist")}
    b3 = sorted(o for ops in res["groupby_minmax"].values() for o in ops)
    if not (any(o.startswith("ATOMS.MIN") for o in b3)
            and any(o.startswith("ATOMS.MAX") for o in b3)):
        raise AssertionError(f"groupby_minmax: no native shared MIN / MAX in {b3}")
    return {"kernels": res,
            "b3_native_shared_minmax": [o for o in b3 if o.startswith(("ATOMS.MIN",
                                                                       "ATOMS.MAX"))],
            "b1_b2_native_shared_add": native,
            "sum_f32_private_shared_add": f32[0] if f32 else None,
            "sum_f32_shared_add_is_cas_loop":
                any("CAS" in o for o in f32[0]) if f32 else None}


def check_tile_sort(keys, pays, got, want_keys, T):
    """Exact check of an unstable tile sort: keys equal the plain sort's,
    payload 0 (each row's index in its tile) is a permutation of every tile
    that carries each key with its row, the other payloads follow it."""
    agree(got[0], want_keys)
    if not pays:
        return
    idx = got[1].view(-1, T).long()
    agree(torch.gather(keys.view(-1, T), 1, idx).reshape(-1), got[0])
    agree(torch.sort(idx, dim=1).values,
          torch.arange(T, device="cuda").expand_as(idx))
    for p, o in zip(pays[1:], got[2:]):
        agree(o, torch.gather(p.view(-1, T), 1, idx).reshape(-1))


def sparse_streams(n, gen, num_slots=SPARSE_SLOTS):
    """gid over num_slots and one stream of each class; the sumi stream is
    the row number, so B5's output names each row's origin."""
    gid = torch.randint(0, num_slots, (n,), dtype=torch.int32, device="cuda",
                        generator=gen)
    cm = torch.rand(n, device="cuda", generator=gen) < 0.8
    f = torch.where(cm, torch.rand(n, device="cuda", generator=gen), 0.0)
    i = torch.randint(1, 10_001, (n,), dtype=torch.int32, device="cuda",
                      generator=gen)
    streams = [(cm, "count"),
               (torch.arange(n, dtype=torch.int32, device="cuda"), "sumi"),
               (f, "sumf"),
               (torch.where(cm, torch.rand(n, device="cuda", generator=gen,
                                           dtype=torch.float64), 0.0), "sumd"),
               (torch.where(cm, i, 2**31 - 1), "min"),
               (torch.where(cm, f, float("-inf")), "max")]
    return gid, streams


def skewed(gid, streams):
    """B6's skewed shape: SKEW_ROWS more rows of one key in each of
    SKEW_PARTS partitions of plan(len(gid)), their values those of the
    first rows."""
    from heavydb_tpu_torch.kernels import radix_groupby as RG

    pbits = RG.plan(gid.shape[0] + SKEW_PARTS * SKEW_ROWS)
    cand = torch.arange(1, 1 << 14, device="cuda")
    part = ((cand * RG._MULT) & 0xFFFFFFFF) >> (32 - pbits)
    _, first = np.unique(part.cpu().numpy(), return_index=True)
    hot = cand[torch.from_numpy(np.sort(first)[:SKEW_PARTS]).cuda()]
    extra = SKEW_PARTS * SKEW_ROWS
    gid = torch.cat([gid, hot.to(torch.int32).repeat_interleave(SKEW_ROWS)])
    return gid, [(torch.cat([v, v[:extra]]), op) for v, op in streams]


def stream_bytes(streams) -> int:
    return sum(v.element_size() for v, _ in streams)


def total_bytes(streams) -> int:
    """Bytes per group of the per-group totals (radix_groupby contract)."""
    return sum(4 if op in ("sumf", "min", "max") else 8 for _, op in streams)


def b5_case(tag, gid, streams, pbits, rate):
    """B5 against radix_partition_plain: counts and offsets exactly, every
    valid row once in the partition of its top hash bits with its own hb
    (and with streams, each output row carries its origin in the sumi
    stream, so every stream must follow its row)."""
    from heavydb_tpu_torch.kernels import radix_groupby as RG

    n = gid.shape[0]
    hb, parts, counts, offsets = RG.radix_partition(gid, streams, SPARSE_SLOTS, pbits)
    phb, _, pcounts, poffsets = RG.radix_partition_plain(gid, streams,
                                                         SPARSE_SLOTS, pbits)
    agree(counts, pcounts)
    agree(offsets, poffsets)
    nv = int(counts.sum())
    region = torch.repeat_interleave(torch.arange(1 << pbits, device="cuda"), counts)
    if streams:
        rows = parts[1][:nv].long()
        agree(torch.sort(rows).values, torch.arange(n, device="cuda"))
        h_of = (gid.long()[rows] * RG._MULT) & 0xFFFFFFFF
        agree(hb[:nv], (h_of ^ 0x80000000).to(torch.int32))
        agree(h_of >> (32 - pbits), region)
        for (v, _), o in zip(streams, parts):
            agree(o[:nv], v[rows])
        del rows, h_of
    else:
        # hb names the gid: each partition's multiset of hb equals the plain one
        def keyed(x):
            return torch.sort((region << 32) | (x[:nv].long() & 0xFFFFFFFF)).values

        agree(keyed(hb), keyed(phb))
        h = (hb[:nv].long() & 0xFFFFFFFF) ^ 0x80000000
        agree(h >> (32 - pbits), region)
    del hb, parts, phb, region
    sb = stream_bytes(streams)
    part_bytes = n * (4 + sb) + nv * (4 + sb)
    p1, p2 = RG.level_bits(pbits)
    # what the design moves: gid twice (histogram, level 1), the streams
    # in, hb and the streams out, and with two levels once more through
    # the scratch (read and written)
    design = n * 4 + part_bytes + (2 * nv * (4 + sb) if p2 else 0)
    return dict(
        kernel="radix_partition", tag=tag, rows=n, slots=SPARSE_SLOTS,
        partitions=1 << pbits, levels=[p1, p2], max_abs_err=0.0,
        ms=timed(lambda: RG.radix_partition(gid, streams, SPARSE_SLOTS, pbits), 10),
        plain_ms=timed(lambda: RG.radix_partition_plain(gid, streams, SPARSE_SLOTS,
                                                         pbits), 3),
        library_ms=None, bound_ms=part_bytes / rate * 1e3,
        design_bytes=design, design_bound_ms=design / rate * 1e3,
        scratch_bytes=n * (4 + sb) if p2 else 0)


def run_sort_kernels(n: int, rate: float):
    """B4, B5 and B6 against their plain versions at n rows."""
    from heavydb_tpu_torch.exec.batch import bucket
    from heavydb_tpu_torch.kernels import radix_groupby as RG, tile_sort as TS

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    shapes = []
    for T in SORT_TILES:
        nt = n // T * T
        keys = torch.randint(-2**31, 2**31 - 1, (nt,), dtype=torch.int32,
                             device="cuda", generator=gen)
        # many equal keys: the payloads must still follow their rows
        dups = torch.randint(-50, 50, (nt,), dtype=torch.int32, device="cuda",
                             generator=gen)
        local = torch.arange(T, dtype=torch.int32, device="cuda").repeat(nt // T)
        library_ms = timed(lambda: torch.sort(keys.view(-1, T), dim=1), 10)
        for n_pay in (0, 4):
            pays = [local] + [torch.randint(-2**31, 2**31 - 1, (nt,), dtype=torch.int32,
                                            device="cuda", generator=gen)
                              for _ in range(n_pay - 1)] if n_pay else []
            for k in (keys, dups):
                got = TS.sort_tiles(k, pays, T)
                want = TS.sort_tiles_plain(k, pays, T)
                check_tile_sort(k, pays, got, want[0], T)
                del got, want
            tag = f"{n_pay} payloads" + ("" if T == SORT_TILE else f", {T}-key tiles")
            shapes.append(dict(
                kernel="tile_sort", tag=tag, rows=nt, tile=T, max_abs_err=0.0,
                ms=timed(lambda: TS.sort_tiles(keys, pays, T), 10),
                plain_ms=timed(lambda: TS.sort_tiles_plain(keys, pays, T), 3),
                library_ms=library_ms,
                bound_ms=nt * 8 * (1 + n_pay) / rate * 1e3,
                kernel_info=TS.kernel_info(T, n_pay)))
            del pays
        del keys, dups, local
        torch.cuda.empty_cache()

    gid, streams = sparse_streams(n, gen)
    pbits = RG.plan(n)
    for tag, ss in (("6 streams", streams), ("no streams", [])):
        shapes.append(b5_case(tag, gid, ss, pbits, rate))

    cap = bucket(SPARSE_SLOTS)

    def b6_case(tag, gid, ss, library=None):
        got = RG.sparse_groupby(gid, ss, SPARSE_SLOTS, cap)
        want = RG.sparse_groupby_plain(gid, ss, SPARSE_SLOTS, cap)
        ng = int(got[3])
        if int(got[4]) != 0 or ng != int(want[3]):
            raise AssertionError(f"sparse_groupby {tag}: overflow {int(got[4])}, "
                                 f"{ng} groups vs {int(want[3])}")
        agree(got[0], want[0])
        agree(got[1], want[1])
        err = 0.0
        for (_, op), g, w in zip(ss, got[2], want[2]):
            err = max(err, agree(g, w, F32_TOL if op == "sumf" else
                                 (F64_TOL if op == "sumd" else None)))
        del got, want
        n = gid.shape[0]
        out_bytes = ng * (4 + 8 + total_bytes(ss))
        whole_ms = timed(lambda: RG.sparse_groupby(gid, ss, SPARSE_SLOTS, cap), 5)
        plain_ms = timed(lambda: RG.sparse_groupby_plain(gid, ss, SPARSE_SLOTS, cap), 3)
        pbits = RG.plan(n)
        ops = [op for _, op in ss]
        # device memory of each phase above what the caller holds: B5's
        # scratch is freed before B6 allocates its larger stage arrays, so
        # B5 must not set the radix tier's peak
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        hb, parts, counts, offsets = RG.radix_partition(gid, ss, SPARSE_SLOTS, pbits)
        b5_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        RG.radix_group(hb, parts, ops, counts, offsets, cap)
        tier_peak = torch.cuda.max_memory_allocated() - base
        if b5_peak > tier_peak:
            raise AssertionError(f"sparse_groupby {tag}: B5 peaks at {b5_peak} B, "
                                 f"above B6's {tier_peak} B")
        nv = int(counts.sum())
        group_ms = timed(lambda: RG.radix_group(hb, parts, ops, counts, offsets, cap), 5)
        launch = RG.group_launch(counts)
        shapes.append(dict(
            kernel="radix_group", tag=tag, rows=n, slots=SPARSE_SLOTS,
            groups=ng, cap=cap, max_abs_err=err, ms=group_ms, plain_ms=plain_ms,
            library_ms=timed(library, 5) if library else None,
            bound_ms=(nv * (4 + stream_bytes(ss)) + out_bytes) / rate * 1e3,
            sparse_groupby_ms=whole_ms,
            sparse_groupby_bound_ms=(n * (4 + stream_bytes(ss)) + out_bytes)
            / rate * 1e3,
            b5_peak_bytes=b5_peak, tier_peak_bytes=tier_peak,
            largest_partition=int(counts.max()),
            partitions_by_launch=[int((launch == j).sum())
                                  for j in range(len(RG.GROUP_LAUNCHES))]))

    b6_case("counts only", gid, [],
            lambda: torch.unique(gid, return_counts=True))
    b6_case("6 streams", gid, streams)
    gid, streams = skewed(gid, streams)
    b6_case("skewed, 6 streams", gid, streams)
    if shapes[-1]["partitions_by_launch"][1] != SKEW_PARTS:
        raise AssertionError(f"skewed shape: {shapes[-1]['partitions_by_launch']} "
                             f"partitions by B6 launch, expected {SKEW_PARTS} in "
                             "the second")
    del gid, streams
    torch.cuda.empty_cache()
    return shapes


# ---------------------------------------------------------------------------
# end-to-end phase
# ---------------------------------------------------------------------------


def _groups(keys, n_slots, ok=None):
    k = keys if ok is None else keys[ok]
    return k, np.bincount(k, minlength=n_slots)


def _reduce_at(ufunc, idx, v, n_slots, fill):
    out = np.full(n_slots, fill, v.dtype)
    ufunc.at(out, idx, v)
    return out


def expected(name, h):
    """numpy answer of each query: {key tuple: row tuple of aggregates}."""
    if name == "NGA03":
        return {(): (int(((h["x100"] > 50) & (h["y100"] <= 75)).sum()),)}
    if name == "PHM001":
        k = (h["x10"].astype(np.int64) - 1) * 10 + (h["y10"] - 1)
        cnt = np.bincount(k, minlength=100)
        s = np.bincount(k, weights=h["x100"].astype(np.float64), minlength=100)
        si = np.zeros(100, np.int64)
        np.add.at(si, k, h["x100"].astype(np.int64))
        return {(i // 10 + 1, i % 10 + 1): (int(cnt[i]), si[i] / cnt[i])
                for i in range(100) if cnt[i]}
    if name == "Q100_MINMAX":
        ok = h["x10"] > 3
        k = h["x100"][ok].astype(np.int64)
        cnt = np.bincount(k, minlength=101)
        sv = np.bincount(k, weights=h["v"][ok].astype(np.float64), minlength=101)
        mn = _reduce_at(np.minimum, k, h["x10k"][ok], 101, np.iinfo(np.int32).max)
        mx = _reduce_at(np.maximum, k, h["v"][ok], 101, -np.inf)
        return {(i,): (int(cnt[i]), sv[i], int(mn[i]), float(mx[i]))
                for i in range(101) if cnt[i]}
    if name == "PHS002":
        k = h["x1k"].astype(np.int64)
        cnt = np.bincount(k, minlength=1001)
        s = np.zeros(1001, np.int64)
        np.add.at(s, k, h["y10"].astype(np.int64))
        return {(i,): (int(cnt[i]), int(s[i])) for i in range(1001) if cnt[i]}
    if name == "Q1K_MINMAX":
        k = h["x1k"].astype(np.int64)
        cnt = np.bincount(k, minlength=1001)
        mn = _reduce_at(np.minimum, k, h["x10k"], 1001, np.iinfo(np.int32).max)
        mx = _reduce_at(np.maximum, k, h["v"], 1001, -np.inf)
        sv = np.bincount(k, weights=h["v"].astype(np.float64), minlength=1001)
        return {(i,): (int(mn[i]), float(mx[i]), sv[i] / cnt[i])
                for i in range(1001) if cnt[i]}
    if name == "Q100_AVG":
        ok = h["x10"] > 3
        k = h["x100"][ok].astype(np.int64)
        cnt = np.bincount(k, minlength=101)
        sv = np.bincount(k, weights=h["v"][ok].astype(np.float64), minlength=101)
        sk = np.bincount(k, weights=h["x10k"][ok].astype(np.float64), minlength=101)
        return {(i,): (sv[i] / cnt[i], sk[i] / cnt[i]) for i in range(101) if cnt[i]}
    if name == "Q10K":
        k = h["x10k"].astype(np.int64)
        cnt = np.bincount(k, minlength=10_001)
        sv = np.bincount(k, weights=h["v"].astype(np.float64), minlength=10_001)
        return {(i,): (int(cnt[i]), sv[i]) for i in range(10_001) if cnt[i]}
    if name == "PHS003":
        cnt = np.bincount(h["x100k"], minlength=100_001)
        return {(i,): (int(cnt[i]),) for i in range(100_001) if cnt[i]}
    raise KeyError(name)


def expected_arrays(name, h):
    """numpy answer of the sort- and radix-tier queries as (keys, columns),
    keys ascending; the step-10000 keys are counted by bincount(k // 10000)."""
    if name in ("BH002", "BH003"):
        col = "x10k_s10k" if name == "BH002" else "x1m_s10k"
        k = h[col] // 10_000
        cnt = np.bincount(k)
        live = np.nonzero(cnt)[0]
        cols = [cnt[live]]
        if name == "BH003":
            s = np.bincount(k, weights=h["y100"].astype(np.float64))
            cols.append(s[live].astype(np.int64))
        return live * 10_000, cols
    if name == "BH004":
        cnt = np.bincount(h["x10m"])
        live = np.nonzero(cnt)[0]
        return live, [cnt[live]]
    if name == "Q10M_AGGS":
        ok = h["x10"] > 3
        k = h["x10m"][ok].astype(np.int64)
        cnt = np.bincount(k)
        live = np.nonzero(cnt)[0]
        s = np.bincount(k, weights=h["x100"][ok].astype(np.float64))
        sv = np.bincount(k, weights=h["v"][ok].astype(np.float64))
        mn = _reduce_at(np.minimum, k, h["x10k"][ok], cnt.shape[0],
                        np.iinfo(np.int32).max)
        mx = _reduce_at(np.maximum, k, h["v"][ok], cnt.shape[0], -np.inf)
        return live, [cnt[live], s[live].astype(np.int64), sv[live], mn[live],
                      mx[live]]
    raise KeyError(name)


# kernels each query's route must launch (ops/groupby.py and executor
# routing); the keyless count, the 100000-slot group-by and the sort tier
# (BH002, BH003) take plain torch.  tile_sort's network runs inside
# radix_group; its own entry point is never on the main path.
ROUTES = {
    "NGA03": set(), "PHM001": {"lane_agg"}, "Q100_MINMAX": {"lane_agg"},
    "PHS002": {"radix_hist"}, "Q1K_MINMAX": {"radix_hist", "groupby_minmax"},
    "Q10K": {"radix_hist"}, "PHS003": set(), "BH002": set(), "BH003": set(),
    "BH004": {"radix_partition", "radix_group"},
    "Q10M_AGGS": {"radix_partition", "radix_group"},
    # the sort phase: only GROUP_TOPN's group-by launches a kernel (B2);
    # ORDER BY itself is plain torch, as the reference's is plain XLA
    "LIMIT_ONLY": set(), "TOPK_V": set(), "TOPK_TIES": set(), "TOPK_MULTI": set(),
    "GROUP_TOPN": {"radix_hist"}, "FULL_SORT": set(), "TOPK_V_STREAMED": set(),
    # the join phase: the joins are plain torch, the group-by after them
    # launches B1 (<= 256 slots), B2 + B3 (1000 slots); JOIN_SPARSE is keyless
    "JOIN_DIM1K": {"lane_agg"}, "JOIN_DIM10M": {"radix_hist", "groupby_minmax"},
    "JOIN_SPARSE": set(), "JOIN_LEFT_FANOUT": {"lane_agg"}, "EXISTS_ANTI": {"lane_agg"},
    # the strings phase: the string work is host tables and gathers; the
    # group-by after it launches B1 (<= 256 slots; a dictionary key of 7 + 1),
    # B2 (the counts) + B3 (MIN and MAX over int32 ranks at 1000 slots);
    # STR_TRANSFORM's key has no range (the sort tier), STR_LIKE_1M is keyless
    "STR_EQ": {"lane_agg"}, "STR_IN": {"lane_agg"}, "STR_LIKE": {"lane_agg"},
    "STR_MINMAX": {"radix_hist", "groupby_minmax"}, "STR_TRANSFORM": set(),
    "STR_PAIR": {"lane_agg"}, "STR_LIKE_1M": set(),
    # the subq phase: SUBQ_SCALAR's keyless sum is plain torch, its group-by
    # B2; SUBQ_IN's inner GROUP BY x10m the radix tier (B5 + B6), its outer
    # group-by B2 + B3; SUBQ_NOT_IN B1 at 10 slots; a Compound over a Union
    # has no key range, so UNION_ALL and SET_INTERSECT group on the sort
    # tier (the reference's rule); ROLLUP's branches B2 (1000 slots), B1 (10)
    # and a keyless one
    "SUBQ_SCALAR": {"radix_hist"},
    "SUBQ_IN": {"radix_partition", "radix_group", "radix_hist", "groupby_minmax"},
    "SUBQ_NOT_IN": {"lane_agg"}, "UNION_ALL": set(), "SET_INTERSECT": set(),
    "ROLLUP": {"radix_hist", "lane_agg"},
    # the distinct phase: the DISTINCT family is plain torch (sorts, scans,
    # scatters), as the reference's is plain XLA; a perfect-tier group-by
    # counts its groups' rows with B1, DIST_COUNT's hash form also counts
    # the slots each group owns with B1, QUANTILE's sketch takes each
    # group's count, MIN and MAX with B1
    "DIST_COUNT": {"lane_agg"}, "DIST_COUNT_WIDE": set(), "DIST_SUM": {"lane_agg"},
    "APPROX_CD": {"lane_agg"}, "QUANTILE": {"lane_agg"}, "MODE": {"lane_agg"},
    # the hash phase: the hash tier aggregates over 4 x ~1.8M claim slots,
    # past every kernel (plain scatters); the sort tier is plain torch
    "HASH_BIGINT": set(), "HASH_PAIR": set(),
    # the geo and arrays phases: the aux tables are host numpy, the grid
    # join and the ray cast plain torch; GEO_ZONE_JOIN's group-by over the
    # 263 zones is B2; an UNNEST column has no key range (the sort tier)
    "GEO_DWITHIN": set(), "GEO_ZONE_JOIN": {"radix_hist"}, "GEO_NEAR_JOIN": set(),
    "ARR_UNNEST_GROUP": set(), "ARR_ANY_SUBSCRIPT": set(),
}
def _j1():
    """J1's wrapper, whose `launches` count the perfect join builds on the
    card (kept apart from the nine counters of ROUTES)."""
    from heavydb_tpu_torch.kernels import join_build

    return join_build.perfect_count


def check_route(name, delta) -> None:
    """Raise unless the query launched exactly the kernels ROUTES names
    (delta: each kernel's launches in its runs)."""
    for kname, d in zip(KERNEL_NAMES, delta):
        if (d > 0) != (kname in ROUTES[name]):
            raise AssertionError(
                f"{name}: {kname} launched {d} times; expected the "
                f"route to use {sorted(ROUTES[name]) or 'no kernel'}")


# queries checked column by column as arrays (large results)
ARRAY_CHECKED = ("BH002", "BH003", "BH004", "Q10M_AGGS")

# result columns of each query that are FLOAT sums (float32 tolerance)
F32_RESULT_COLS = {"Q100_MINMAX": {2}, "Q10K": {2}, "Q10M_AGGS": {3}}


def check_arrays(name, rs, h, f32_cols=None) -> int:
    f32_cols = F32_RESULT_COLS.get(name, ()) if f32_cols is None else f32_cols
    keys, want = expected_arrays(name, h)
    got_keys = rs.column_raw(0)
    order = np.argsort(got_keys, kind="stable")
    if not np.array_equal(got_keys[order], keys):
        raise AssertionError(f"{name}: {got_keys.shape[0]} keys, numpy has "
                             f"{keys.shape[0]}, or they differ")
    for j, w in enumerate(want):
        col = j + 1
        g = rs.column_raw(col)[order]
        tol = F32_TOL if col in f32_cols else (
            F64_TOL if w.dtype.kind == "f" and g.dtype == np.float64 else None)
        agree(torch.from_numpy(np.ascontiguousarray(g)),
              torch.from_numpy(np.ascontiguousarray(w.astype(g.dtype))), tol)
    return keys.shape[0]


def check_result(name, rs, h, f32_cols=None) -> int:
    """Raise unless the result equals numpy's; f32_cols: the result columns
    held to float32 tolerance (default F32_RESULT_COLS)."""
    f32_cols = F32_RESULT_COLS.get(name, ()) if f32_cols is None else f32_cols
    if name in ARRAY_CHECKED:
        return check_arrays(name, rs, h, f32_cols)
    want = expected(name, h)
    n_keys = {"NGA03": 0, "PHM001": 2}.get(name, 1)
    cols = [rs.column(i) for i in range(rs.col_count)]
    rows = list(zip(*cols))
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows, numpy has {len(want)}")
    for r in rows:
        w = want[tuple(r[:n_keys])]
        for j, (g, e) in enumerate(zip(r[n_keys:], w)):
            col = n_keys + j
            if isinstance(e, float):
                tol = F32_TOL if col in f32_cols else F64_TOL
                if not np.isclose(g, e, **tol):
                    raise AssertionError(f"{name}: {r} vs {w} (column {col})")
            elif g != e:
                raise AssertionError(f"{name}: {r} vs {w} (column {col})")
    return len(rows)


def decode(rs):
    """The result on the host: Python rows, or numpy columns for the
    queries with millions of groups."""
    if rs.row_count > 100_000:
        return [rs.column_raw(i) for i in range(rs.col_count)]
    return rs.rows()


def run_e2e(n: int, card: str, counters):
    import heavydb_tpu_torch as hdt

    db = hdt.connect()
    t0 = time.perf_counter()
    data = load_bench(db, n, SEED + 1)
    torch.cuda.synchronize()
    make_and_load_s = time.perf_counter() - t0
    host = {k: v.cpu().numpy() for k, v in data.items()}
    del data
    n_frags = len(db.catalog.get_table("bench").fragments)

    def launches():
        return [c.launches for c in counters]

    for c in counters:
        c.launches = 0  # the main path starts here
    out = []
    for name, q in QUERIES.items():
        before = launches()
        waves0 = db.executor.waves_run
        t0 = time.perf_counter()
        rs = db.sql(q)
        decode(rs)
        first_ms = (time.perf_counter() - t0) * 1e3
        nrows = check_result(name, rs, host)

        def device_run():
            batch, _ = db.sql_device(q)
            torch.cuda.synchronize()
            return batch

        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            device_run()
            reps.append((time.perf_counter() - t0) * 1e3)
        warm = statistics.median(reps)
        t0 = time.perf_counter()
        decode(db.sql(q))
        e2e_ms = (time.perf_counter() - t0) * 1e3
        delta = [a - b for a, b in zip(launches(), before)]
        check_route(name, delta)
        waves = db.executor.waves_run - waves0
        if waves:
            raise AssertionError(f"{name}: ran in {waves} fragment waves at the "
                                 "default stream threshold")
        out.append(dict(query=name, rows_out=nrows, first_with_decode_ms=first_ms,
                        warm_ms=warm, rows_per_s=n / (warm / 1e3),
                        warm_with_decode_ms=e2e_ms, waves=waves,
                        launches=dict(zip(KERNEL_NAMES, delta))))
    total = launches()
    return dict(rows=n, fragments=n_frags, make_and_load_s=make_and_load_s,
                card=card, queries=out), total, db, host


HOT_ROWS = 4_000_000
HOT_SLOTS = 1 << 22


def run_hot_key(db, counters):
    """A key holding 60 % of 4M rows in a 2^22 key space: the radix tier
    must route it, flag the overflowing partition (bit 0) and rerun on the
    sort tier, with the answer still equal to numpy's."""
    from heavydb_tpu_torch.exec.executor import Executor

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    k = torch.randint(0, HOT_SLOTS, (HOT_ROWS,), dtype=torch.int32, device="cuda",
                      generator=gen)
    k[torch.rand(HOT_ROWS, device="cuda", generator=gen) < 0.6] = 123_457
    v = torch.randint(-100, 101, (HOT_ROWS,), dtype=torch.int32, device="cuda",
                      generator=gen)
    db.sql("CREATE TABLE hot (k INT, v INT)")
    db.load_table_device("hot", {"k": k, "v": v})
    hk, hv = k.cpu().numpy().astype(np.int64), v.cpu().numpy().astype(np.float64)
    del k, v
    steps = []
    orig = Executor._postprocess

    def spy(self, node, plan, outs):
        if plan.group_strategy is not None:
            steps.append(plan.group_strategy[0])
        return orig(self, node, plan, outs)

    before = [c.launches for c in counters]
    Executor._postprocess = spy
    try:
        t0 = time.perf_counter()
        rs = db.sql("SELECT k, COUNT(*), SUM(v) FROM hot GROUP BY k")
        cols = [rs.column_raw(i) for i in range(3)]
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        Executor._postprocess = orig
    launched = dict(zip(KERNEL_NAMES, [c.launches - b for c, b in
                                       zip(counters, before)]))
    # radix, then the sort tier (once more if the radix run's group count,
    # which misses the overflowed partition, left the sort tier's cap short)
    if steps[:2] != ["radix", "sort"] or set(steps[1:]) != {"sort"}:
        raise AssertionError(f"hot key: strategies {steps}, expected radix "
                             "then sort")
    if not (launched["radix_partition"] and launched["radix_group"]):
        raise AssertionError(f"hot key: the radix kernels did not run: {launched}")
    cnt = np.bincount(hk, minlength=HOT_SLOTS)
    live = np.nonzero(cnt)[0]
    sums = np.bincount(hk, weights=hv, minlength=HOT_SLOTS)[live].astype(np.int64)
    order = np.argsort(cols[0])
    for g, w in ((cols[0][order], live), (cols[1][order], cnt[live]),
                 (cols[2][order], sums)):
        if not np.array_equal(g, w):
            raise AssertionError("hot key: the result differs from numpy")
    return dict(rows=HOT_ROWS, slots=HOT_SLOTS, hot_share=float(cnt.max() / HOT_ROWS),
                groups=int(live.shape[0]), strategies=steps, ms=ms,
                launches=launched)


# ---------------------------------------------------------------------------
# stream phase
# ---------------------------------------------------------------------------

# Q1K_MINMAX (perfect tier, B3 and B2), Q10M_AGGS (radix tier) and an AVG
# query (B1; AVG splits into SUM and COUNT partials)
STREAM_QUERIES = {
    "Q1K_MINMAX": QUERIES["Q1K_MINMAX"],
    "Q10M_AGGS": QUERIES["Q10M_AGGS"],
    "Q100_AVG": "SELECT x100, AVG(v), AVG(x10k) FROM bench WHERE x10 > 3 "
                "GROUP BY x100",
}
FORCED_THRESHOLD = 1 << 20
# streamed, AVG over a FLOAT column merges FLOAT SUM partials (as in the
# reference), so those results are held to float32 tolerance too
STREAM_F32_COLS = {"Q1K_MINMAX": {3}, "Q10M_AGGS": {3}, "Q100_AVG": {1}}


def run_stream(db, host, counters):
    """Each STREAM_QUERIES query three ways: whole (the default config),
    in waves forced by a 1 MB stream threshold, and in waves forced by
    the device-memory term, with the free-memory read stubbed to 2.5
    fragments' working bytes (the executor's own estimate of the query:
    one fragment a wave).  Each run equals numpy; it reports waves, warm
    ms (median of 3) and peak device bytes above what the table holds.  A
    stub of 1.5 fragments' need must raise DeviceMemoryExceeded with no
    kernel launched."""
    from heavydb_tpu_torch.errors import DeviceMemoryExceeded
    from heavydb_tpu_torch.exec import executor as EX
    from heavydb_tpu_torch.tools.synthetic import FRAGMENT_ROWS

    ex = db.executor
    base_cfg = ex.config
    real_free = EX.free_device_bytes
    out = []

    def run(name, q):
        waves0 = ex.waves_run
        rs = db.sql(q)
        nrows = check_result(name, rs, host, STREAM_F32_COLS[name])
        waves = ex.waves_run - waves0
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            db.sql_device(q)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        db.sql_device(q)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        return dict(rows_out=nrows, waves=waves, warm_ms=statistics.median(reps),
                    peak_bytes=peak)

    try:
        for name, q in STREAM_QUERIES.items():
            whole = run(name, q)
            ex.config = base_cfg.clone(stream_threshold_bytes=FORCED_THRESHOLD)
            forced = run(name, q)
            sp = ex.last_stream
            ex.config = base_cfg
            work = FRAGMENT_ROWS * sp.work_row_bytes
            EX.free_device_bytes = lambda dev, need=0: int(2.5 * work)  # noqa: E731
            by_memory = run(name, q)
            if not ex.last_stream.by_memory:
                raise AssertionError(f"{name}: the memory term did not plan the waves")
            if by_memory["peak_bytes"] > 2.5 * work:
                raise AssertionError(f"{name}: streamed peak {by_memory['peak_bytes']} B "
                                     f"past the {int(2.5 * work)} B the plan was given")
            EX.free_device_bytes = lambda dev, need=0: int(1.5 * work)  # noqa: E731
            before = [c.launches for c in counters]
            try:
                db.sql(q)
                raise AssertionError(f"{name}: a fragment over half the free "
                                     "memory did not raise")
            except DeviceMemoryExceeded as e:
                refused = str(e)
            if [c.launches for c in counters] != before:
                raise AssertionError(f"{name}: kernels launched before the refusal")
            EX.free_device_bytes = real_free
            if whole["waves"] or forced["waves"] != 3 or by_memory["waves"] != 3:
                raise AssertionError(f"{name}: waves {whole['waves']} / "
                                     f"{forced['waves']} / {by_memory['waves']}, "
                                     "not 0 / 3 / 3")
            out.append(dict(query=name, work_row_bytes=sp.work_row_bytes,
                            col_row_bytes=sp.row_bytes, whole=whole,
                            forced_threshold=dict(threshold=FORCED_THRESHOLD, **forced),
                            memory_term=dict(stub_free_bytes=int(2.5 * work),
                                             **by_memory),
                            refused=refused))
    finally:
        ex.config = base_cfg
        EX.free_device_bytes = real_free
    return out


# ---------------------------------------------------------------------------
# sort phase
# ---------------------------------------------------------------------------


def _first(cand, keys, start, stop):
    """Rows of `cand` (ascending row indices) in the order of `keys`
    (arrays over cand, most significant first, each ascending), ties in row
    order, positions start..stop."""
    order = np.lexsort([cand] + list(reversed(keys)))
    return cand[order[start:stop]]


def expected_sort(name, h):
    """numpy answer of each SORT_QUERIES query: its columns, rows in order."""
    if name == "LIMIT_ONLY":
        idx = np.flatnonzero(h["x1k"] == 5)[:20]
        return [h["x10"][idx], h["v"][idx]]
    if name == "TOPK_V":
        ok = h["x10"] > 3
        thr = np.partition(h["v"][ok], -100)[-100]
        cand = np.flatnonzero(ok & (h["v"] >= thr))
        idx = _first(cand, [-h["v"][cand]], 0, 100)
        return [h["x10m"][idx], h["v"][idx]]
    if name == "TOPK_TIES":
        x = h["x10m"]
        top = int(np.searchsorted(np.cumsum(np.bincount(x)), 1010))
        cand = np.flatnonzero(x <= top)
        idx = _first(cand, [x[cand]], 10, 1010)
        return [x[idx], h["x100"][idx]]
    if name == "TOPK_MULTI":
        x = h["x1k"]
        above = np.cumsum(np.bincount(x)[::-1])[::-1]  # rows with x1k >= i
        cand = np.flatnonzero(x >= int(np.flatnonzero(above >= 50)[-1]))
        idx = _first(cand, [-x[cand], h["v"][cand]], 0, 50)
        return [x[idx], h["v"][idx], h["x10k"][idx]]
    if name == "GROUP_TOPN":
        cnt = np.bincount(h["x1k"])
        sv = np.bincount(h["x1k"], weights=h["v"].astype(np.float64))
        keys = np.flatnonzero(cnt)
        top = _first(keys, [-cnt[keys]], 0, 10)
        return [top, cnt[top], sv[top]]
    if name == "FULL_SORT":
        cand = np.flatnonzero(h["x10"] == 1)
        idx = _first(cand, [-h["x100"][cand], h["x10m"][cand]], 0, cand.shape[0])
        return [h["x10m"][idx], h["x100"][idx], h["v"][idx]]
    raise KeyError(name)


def check_sort(name, rs, h) -> int:
    """Raise unless each column equals numpy's, row for row: exact, the
    FLOAT sum of GROUP_TOPN to float32 tolerance."""
    want = expected_sort(name.replace("_STREAMED", ""), h)
    if rs.row_count != want[0].shape[0]:
        raise AssertionError(f"{name}: {rs.row_count} rows, numpy has "
                             f"{want[0].shape[0]}")
    for j, w in enumerate(want):
        g = rs.column_raw(j)
        tol = F32_TOL if (name == "GROUP_TOPN" and j == 2) else None
        agree(torch.from_numpy(np.ascontiguousarray(g)),
              torch.from_numpy(np.ascontiguousarray(w.astype(g.dtype))), tol)
    return rs.row_count


def run_sort(db, host, counters):
    """Each SORT_QUERIES query, then TOPK_V in fragment waves, with the
    launch counters set to 0 before the first: rows out, first and warm ms
    (median of 5), waves and launches, each checked against numpy and
    ROUTES.  Returns the lines and each kernel's launches in the phase."""
    ex = db.executor
    base_cfg = ex.config
    runs = list(SORT_QUERIES.items()) + [("TOPK_V_STREAMED", SORT_QUERIES["TOPK_V"])]
    out = []
    for c in counters:
        c.launches = 0  # the sort path starts here
    try:
        for name, q in runs:
            if name == "TOPK_V_STREAMED":
                ex.config = base_cfg.clone(stream_threshold_bytes=FORCED_THRESHOLD)
            before = [c.launches for c in counters]
            waves0 = ex.waves_run
            t0 = time.perf_counter()
            rs = db.sql(q)
            rs.column_raw(0)
            first_ms = (time.perf_counter() - t0) * 1e3
            waves = ex.waves_run - waves0
            nrows = check_sort(name, rs, host)
            reps = []
            for _ in range(5):
                t0 = time.perf_counter()
                db.sql_device(q)
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) * 1e3)
            delta = [c.launches - b for c, b in zip(counters, before)]
            check_route(name, delta)
            if (waves < 3) if name == "TOPK_V_STREAMED" else waves:
                raise AssertionError(f"{name}: {waves} fragment waves")
            out.append(dict(query=name, rows_out=nrows, first_with_decode_ms=first_ms,
                            warm_ms=statistics.median(reps), waves=waves,
                            launches=dict(zip(KERNEL_NAMES, delta))))
    finally:
        ex.config = base_cfg
    return out, [c.launches for c in counters]


def sort_yardsticks(db, host, rate):
    """The top-k select of TOPK_V and TOPK_TIES on their keys beside
    torch.topk and one stable torch.sort of the same key (CUDA events,
    median of 5); FULL_SORT's filtered input, its sort permutation and its
    payload gathers timed apart."""
    from heavydb_tpu_torch.exec import batch as B
    from heavydb_tpu_torch.exec.compound_kernel import derive_valid
    from heavydb_tpu_torch.ops import sort as S
    from heavydb_tpu_torch.plan.optimizer import optimize
    from heavydb_tpu_torch.sql.parser import parse_many

    lines = []
    # the descending-priority keys _exec_topk selects on (no NULL or NaN in
    # the data): v of the rows with x10 > 3; -x10m for ORDER BY x10m ASC
    v = torch.from_numpy(host["v"][host["x10"] > 3]).cuda()
    x = torch.from_numpy(host["x10m"]).cuda()
    for name, key, k, lib in (
            ("TOPK_V", v, 100, lambda: torch.topk(v, 100)),
            ("TOPK_TIES", -x, 1010, lambda: torch.topk(x, 1010, largest=False))):
        got = S.topk_indices(key, k)
        agree(key[got], lib()[0] if name == "TOPK_V" else -lib()[0])
        lines.append(dict(
            query=name, rows=key.shape[0], k=k,
            select_ms=timed(lambda: S.topk_indices(key, k), 5),
            torch_topk_ms=timed(lib, 5),
            torch_sort_stable_ms=timed(lambda: torch.sort(key, descending=True,
                                                          stable=True), 5),
            bound_ms=key.shape[0] * key.element_size() / rate * 1e3))
    del v, x
    ex = db.executor
    plan = optimize(db._plan_select(parse_many(SORT_QUERIES["FULL_SORT"])[0]))
    child = plan.inputs[0]
    inp = ex._exec(child, {}, set(range(child.arity)))
    tvs = [(inp.cols[i], derive_valid(inp.cols[i], inp.types[i])) for i, _, _ in plan.keys]
    specs = [(asc, nf) for _, asc, nf in plan.keys]
    dom = ex._in_domain(inp.padded, inp.nrows)
    take = S.sort_permutation(tvs, specs, dom)[0][:B.bucket(inp.nrows)]
    lines.append(dict(
        query="FULL_SORT", rows=inp.nrows, padded=inp.padded,
        filter_ms=timed(lambda: ex._exec(child, {}, set(range(child.arity))), 5),
        sort_permutation_ms=timed(lambda: S.sort_permutation(tvs, specs, dom), 5),
        gathers_ms=timed(lambda: [c[take] for c in inp.cols], 5),
        payloads=len(inp.cols)))
    return lines


# ---------------------------------------------------------------------------
# join phase
# ---------------------------------------------------------------------------

# each join cell's build forms (one list a join Compound, one entry a
# level) and capacity retries; EXISTS_ANTI's builds are as the plan picks
# them
JOIN_PLANS = {
    "JOIN_DIM1K": ([["perfect-unique"]], 0),
    "JOIN_DIM10M": ([["perfect-unique"]], 0),
    "JOIN_SPARSE": ([["hash"]], 0),
    "JOIN_LEFT_FANOUT": ([["perfect"]], 1),
    "EXISTS_ANTI": (None, 0),
}
# (group keys, FLOAT-sum result columns) of each join cell
JOIN_SHAPES = {"JOIN_DIM1K": (1, {2}), "JOIN_DIM10M": (1, {2}), "JOIN_SPARSE": (0, {1}),
               "JOIN_LEFT_FANOUT": (1, {3}), "EXISTS_ANTI": (1, set())}


def _by_key(keys, vals, size, dtype):
    """vals placed at their keys: a lookup table key -> value."""
    out = np.zeros(size, dtype)
    out[keys] = vals
    return out


def expected_join(name, h, dims):
    """numpy answer of each JOIN_QUERIES query: {key tuple: row tuple}."""
    sw = _by_key(dims["sdim"]["k"] // 10_000, dims["sdim"]["w"], 1_000_001, np.float32)
    if name == "JOIN_DIM1K":
        nm = dims["dim1k"]["nm"][h["x1k"] - 1].astype(np.int64)
        cnt = np.bincount(nm, minlength=50)
        sv = np.bincount(nm, weights=h["v"].astype(np.float64), minlength=50)
        return {(i,): (int(cnt[i]), sv[i]) for i in range(50) if cnt[i]}
    if name == "JOIN_DIM10M":
        gk = _by_key(dims["dim10m"]["k"], dims["dim10m"]["g"], 10_000_001, np.int64)
        ok = h["x10"] > 3
        g = gk[h["x10m"][ok]]
        cnt = np.bincount(g, minlength=1001)
        sv = np.bincount(g, weights=h["v"][ok].astype(np.float64), minlength=1001)
        # MAX(x100) of a group: the largest x100 with a row in it
        seen = np.bincount(g * 101 + h["x100"][ok], minlength=1001 * 101) > 0
        mx = 100 - np.argmax(seen.reshape(1001, 101)[:, ::-1], axis=1)
        return {(i,): (int(cnt[i]), sv[i], int(mx[i])) for i in range(1001) if cnt[i]}
    if name == "JOIN_SPARSE":
        w = sw[h["x1m_s10k"] // 10_000]
        ok = w < 0.5
        return {(): (int(ok.sum()), float(w[ok].astype(np.float64).sum()),
                     int(h["y100"][ok].astype(np.int64).sum()))}
    if name == "JOIN_LEFT_FANOUT":
        wsum = np.bincount(dims["multi"]["k"], minlength=1001,
                           weights=dims["multi"]["w"].astype(np.float64))
        hit = h["x1k"] <= 500
        x10 = h["x10"].astype(np.int64)
        cnt = np.bincount(x10, weights=np.where(hit, 3, 1), minlength=11)
        cw = np.bincount(x10, weights=np.where(hit, 3, 0), minlength=11)
        sw_ = np.bincount(x10, weights=wsum[h["x1k"]], minlength=11)
        return {(i,): (int(cnt[i]), int(cw[i]), sw_[i]) for i in range(11) if cnt[i]}
    if name == "EXISTS_ANTI":
        keep = (sw[h["x1m_s10k"] // 10_000] < 0.25) & ~(dims["dim1k"]["nm"][h["x1k"] - 1] < 5)
        cnt = np.bincount(h["x10"][keep], minlength=11)
        return {(i,): (int(cnt[i]),) for i in range(11) if cnt[i]}
    raise KeyError(name)


def check_join(name, rs, h, dims) -> int:
    """Raise unless the rows equal numpy's: integers exact, FLOAT sums to
    float32 tolerance."""
    want = expected_join(name, h, dims)
    n_keys, f32_cols = JOIN_SHAPES[name]
    rows = rs.rows()
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows, numpy has {len(want)}")
    for r in rows:
        w = want[tuple(r[:n_keys])]
        for j, (g, e) in enumerate(zip(r[n_keys:], w)):
            col = n_keys + j
            ok = np.isclose(g, e, **(F32_TOL if col in f32_cols else F64_TOL)) \
                if isinstance(e, float) else g == e
            if not ok:
                raise AssertionError(f"{name}: {r} vs {w} (column {col})")
    return len(rows)


def run_join(db, host, counters):
    """The dimension tables, then each JOIN_QUERIES query with the launch
    counters set to 0 before the first: rows out, first and warm ms (median
    of 5), each join Compound's build forms, caps and retries, the peak
    device bytes above what was allocated before it, and launches, each
    checked against numpy, JOIN_PLANS and ROUTES.  Returns the lines, each
    kernel's launches in the phase and the dimension tables on the host."""
    t0 = time.perf_counter()
    data = load_dims(db, SEED + 2)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dims = {t: {c: v.cpu().numpy() for c, v in cols.items()} for t, cols in data.items()}
    del data
    ex = db.executor
    out = [dict(query="load_dims", seconds=load_s,
                rows={t: int(next(iter(c.values())).shape[0]) for t, c in dims.items()})]
    for c in counters:
        c.launches = 0  # the join path starts here
    j1 = _j1()
    for name, q in JOIN_QUERIES.items():
        before = [c.launches for c in counters]
        j1_before = j1.launches
        t0 = time.perf_counter()
        rs = db.sql(q)
        rs.rows()
        first_ms = (time.perf_counter() - t0) * 1e3
        runs = list(ex.join_runs)
        nrows = check_join(name, rs, host, dims)
        builds, retries = JOIN_PLANS[name]
        if builds is not None and [r.builds for r in runs] != builds:
            raise AssertionError(f"{name}: builds {[r.builds for r in runs]}, "
                                 f"expected {builds}")
        if sum(r.retries for r in runs) != retries:
            raise AssertionError(f"{name}: {[r.retries for r in runs]} retries, "
                                 f"expected {retries}")
        j1_first = j1.launches - j1_before
        perfect = sum(b.startswith("perfect") for r in runs for b in r.builds)
        if builds is not None and (j1_first > 0) != (perfect > 0):
            raise AssertionError(f"{name}: J1 launched {j1_first} times on builds "
                                 f"{[r.builds for r in runs]}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            db.sql_device(q)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        delta = [c.launches - b for c, b in zip(counters, before)]
        check_route(name, delta)
        out.append(dict(query=name, rows_out=nrows, first_with_decode_ms=first_ms,
                        warm_ms=statistics.median(reps), warm_runs_ms=reps,
                        builds=[r.builds for r in runs], caps=[r.caps for r in runs],
                        retries=[r.retries for r in runs], peak_device_bytes=peak,
                        launches=dict(zip(KERNEL_NAMES, delta)),
                        j1_launches=j1.launches - j1_before))
    return out, [c.launches for c in counters], dims


# the join shapes the 100M-row cells leave out, on small tables: FULL,
# CROSS, a range-packed and a hash-packed key pair, LEFT and SEMI with a
# residual, TEXT keys of two dictionaries, a projection in ORDER BY order
JOIN_SHAPE_QUERIES = [
    "SELECT COUNT(*), COUNT(f.k), COUNT(m.k), SUM(m.g) FROM jf f FULL JOIN jm m "
    "ON f.k = m.k",
    "SELECT m.g, COUNT(*), COUNT(f.g) FROM jf f FULL JOIN jm m ON f.k = m.k GROUP BY m.g",
    "SELECT t.t, COUNT(*), SUM(m.g) FROM jt t, jm m GROUP BY t.t",
    "SELECT COUNT(*), SUM(m.w) FROM jf f JOIN jm m ON f.k = m.k AND f.g = m.g",
    "SELECT f.g, COUNT(*) FROM jf f JOIN jw w ON f.kb = w.kb AND f.kb2 = w.kb2 GROUP BY f.g",
    "SELECT f.g, COUNT(*), COUNT(m.g) FROM jf f LEFT JOIN jm m ON f.k = m.k AND m.g > f.g "
    "GROUP BY f.g",
    "SELECT g, COUNT(*) FROM jf f WHERE EXISTS (SELECT 1 FROM jm m WHERE m.k = f.k "
    "AND m.g > f.g) GROUP BY g",
    "SELECT f.s, COUNT(*), SUM(d.k) FROM jf f JOIN jd d ON f.s = d.s GROUP BY f.s",
    "SELECT f.k, m.g, f.d FROM jf f JOIN jm m ON f.k = m.k WHERE f.g = 2 "
    "ORDER BY f.d, m.g LIMIT 50",
]


def run_join_shapes():
    """JOIN_SHAPE_QUERIES on CUDA against the same port on the CPU (whose
    rows tests/test_torch_join.py holds to the JAX package's): the same
    rows, as multisets without ORDER BY; FLOAT sums to float32 tolerance."""
    import heavydb_tpu_torch as hdt

    rng = np.random.default_rng(SEED)
    n = 20_000
    k = rng.integers(0, 200, n).astype(np.int32)
    k[rng.random(n) < 0.05] = np.iinfo(np.int32).min
    wide = rng.integers(-2**40, 2**40, 400)
    colors = np.array(["red", "green", "blue", "cyan", "plum", "teal"], dtype=object)
    mk = np.repeat(np.arange(100, dtype=np.int32), rng.integers(0, 7, 100))
    wk = np.concatenate([wide[:300], wide[:50]])
    tables = [
        ("jf", "k INT, g INT, kb BIGINT, kb2 BIGINT, d DOUBLE, s TEXT",
         {"k": k, "g": rng.integers(0, 6, n).astype(np.int32),
          "kb": wide[rng.integers(0, 400, n)], "kb2": wide[rng.integers(0, 400, n)] // 3,
          "d": rng.standard_normal(n), "s": colors[rng.integers(0, 6, n)]}),
        ("jm", "k INT, g INT, w FLOAT",
         {"k": mk, "g": rng.integers(0, 6, mk.shape[0]).astype(np.int32),
          "w": rng.random(mk.shape[0]).astype(np.float32)}),
        ("jw", "kb BIGINT, kb2 BIGINT", {"kb": wk, "kb2": wk // 3}),
        ("jt", "t INT", {"t": np.arange(1, 5, dtype=np.int32)}),
        ("jd", "k INT, s TEXT", {"k": np.arange(4, dtype=np.int32),
                                 "s": np.array(["teal", "red", "mauve", "green"], object)}),
    ]
    dbs = [hdt.connect(), hdt.connect(device="cpu")]
    for db in dbs:
        for name, decl, cols in tables:
            db.sql(f"CREATE TABLE {name} ({decl})")
            db.load_table(name, cols)
    rows_out, builds = [], []
    for q in JOIN_SHAPE_QUERIES:
        got, want = (db.sql(q).rows() for db in dbs)
        builds.append([r.builds for r in dbs[0].executor.join_runs])
        if "ORDER BY" not in q:
            got, want = sorted(got, key=repr), sorted(want, key=repr)
        if len(got) != len(want):
            raise AssertionError(f"{q}: {len(got)} rows on CUDA, {len(want)} on the CPU")
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                ok = np.isclose(a, b, **(F32_TOL if "SUM(m.w)" in q else F64_TOL)) \
                    if isinstance(b, float) else a == b
                if not ok:
                    raise AssertionError(f"{q}: {g} on CUDA, {w} on the CPU")
        rows_out.append(len(got))
    return dict(queries=len(JOIN_SHAPE_QUERIES), rows_out=rows_out, builds=builds)


def join_yardsticks(host, dims):
    """The steps of JOIN_SPARSE's and JOIN_DIM10M's joins timed apart on
    their keys (CUDA events, median of 5): the sorted build, the hash table
    over it, the hash probe beside the binary-search probe of the same keys
    (their (lo, cnt) must agree) and the expansion at the query's first
    cap; the 10^7-key perfect build and its unique probe."""
    from heavydb_tpu_torch.exec import batch as B
    from heavydb_tpu_torch.exec.compound_kernel import _join_hash_slots
    from heavydb_tpu_torch.ops import join as J

    pk = torch.from_numpy(host["x1m_s10k"]).cuda()
    bk = torch.from_numpy(dims["sdim"]["k"]).cuda()
    nb = bk.shape[0]
    slots = _join_hash_slots(B.bucket(nb))
    build = J.build_sorted(bk, None, nb)
    table = J.build_hash_table(build, slots)
    lo_h, cnt_h = J.probe_counts_hash(table, pk, None)
    lo_s, cnt_s = J.probe_counts(build, pk, None)
    agree(cnt_h, cnt_s)
    agree(torch.where(cnt_h > 0, lo_h, 0), torch.where(cnt_s > 0, lo_s, 0))
    cap = B.bucket(pk.shape[0])
    lines = [dict(
        query="JOIN_SPARSE", probe_rows=pk.shape[0], build_rows=nb, slots=slots,
        unresolved=int(table.unresolved), cap=cap,
        build_sorted_ms=timed(lambda: J.build_sorted(bk, None, nb), 5),
        build_hash_ms=timed(lambda: J.build_hash_table(build, slots), 5),
        probe_hash_ms=timed(lambda: J.probe_counts_hash(table, pk, None), 5),
        probe_sorted_ms=timed(lambda: J.probe_counts(build, pk, None), 5),
        expand_ms=timed(lambda: J.expand_matches(lo_h, cnt_h, build.rows_sorted, None,
                                                 cap, False), 5))]
    del pk, bk, build, table, lo_h, cnt_h, lo_s, cnt_s
    px = torch.from_numpy(host["x10m"]).cuda()
    dk = torch.from_numpy(dims["dim10m"]["k"]).cuda()
    n10 = dk.shape[0]
    pbuild = J.build_perfect(dk, None, n10, 1, n10)
    lines.append(dict(
        query="JOIN_DIM10M", probe_rows=px.shape[0], build_rows=n10,
        build_perfect_ms=timed(lambda: J.build_perfect(dk, None, n10, 1, n10), 5),
        probe_perfect_unique_ms=timed(
            lambda: J.probe_perfect_unique(pbuild, px, None, n10, None), 5)))
    return lines


def _lineitem_orderkeys(gen, padded=67_108_864, rows=59_986_052):
    """l_orderkey as TPC-H SF10's lineitem holds it: runs of 1-7 rows of
    one key over the first 8 of every 32 keys, padded to the row bucket."""
    n_orders = rows // 4
    okeys = torch.arange(n_orders, device="cuda", dtype=torch.int64)
    okeys = (okeys // 8) * 32 + okeys % 8 + 1
    lines = torch.randint(1, 8, (n_orders,), device="cuda", generator=gen)
    keys = torch.repeat_interleave(okeys, lines)[:rows]
    out = torch.zeros(padded, dtype=torch.int64, device="cuda")
    out[:keys.shape[0]] = keys
    return out, int(keys.shape[0])


def _j1_bytes(keys, valid, num_rows: int, counts) -> int:
    """The bytes J1 has to move: the live rows' validity (1 B a row), each
    32-byte sector of keys that holds a kept row, every slot written (4 B
    a row), the counts zeroed (4 B a slot), and each 32-byte sector of
    counts that a kept row touches read and written back."""
    live = keys.shape[0] if num_rows is None else min(int(num_rows), keys.shape[0])
    kept = (torch.ones(live, dtype=torch.bool, device=keys.device) if valid is None
            else valid[:live].clone())

    def sectors(mask, per):
        pad = (-mask.shape[0]) % per
        if pad:
            mask = torch.cat([mask, mask.new_zeros(pad)])
        return int(mask.view(-1, per).any(1).sum())

    nbytes = (0 if valid is None else live) + sectors(kept, 4) * 32
    nbytes += keys.shape[0] * 4 + counts.shape[0] * 4 + sectors(counts > 0, 8) * 64
    return nbytes


def run_join_build_kernel(rate: float):
    """J1 (kernels/join_build.py) at the shapes of
    tests/test_torch_join_build_chip.py: lineitem's 67,108,864 padded rows
    over a range of 6 x 10^7 with 1 %, 63 % and every row kept, 16,777,216
    unique keys, 2^24 rows over 25 keys.  build_perfect through the
    wrapper `perfect_count` against the plain build (counts, offsets and
    payload equal), then timed (CUDA events, median of 10): the wrapper
    (the counts' zeroing and J1), its plain version, torch.bincount of the
    int64 slot plus the cast to int32 (the library yardstick), and the
    whole build_perfect through each.  Bound: `_j1_bytes` at `rate`."""
    from heavydb_tpu_torch.kernels import join_build as JB
    from heavydb_tpu_torch.ops import join as J

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 28)
    lineitem, live = _lineitem_orderkeys(gen)
    cases = []
    for kept in (0.01, 0.63, 1.0):
        valid = None if kept == 1.0 else (
            torch.rand(lineitem.shape[0], device="cuda", generator=gen) < kept)
        cases.append((f"lineitem, {kept:.0%} kept", lineitem, valid, live, 1, 60_000_000))
    n = 16_777_216
    cases.append(("unique keys", torch.randperm(n, device="cuda", generator=gen) + 5,
                  None, n, 5, n))
    n = 1 << 24
    cases.append(("25 keys", torch.randint(-2, 28, (n,), device="cuda", generator=gen),
                  torch.rand(n, device="cuda", generator=gen) < 0.9, n - 1000, 0, 25))
    lines = []
    for tag, keys, valid, nr, kmin, R in cases:
        args = (keys, valid, nr, kmin, R)

        def plain_build():
            slot, counts = JB.perfect_count_plain(*args)
            offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
            return J.PerfectBuild(counts, offsets,
                                  torch.sort(slot, stable=True).indices.to(torch.int32), kmin)

        before = JB.perfect_count.launches
        got, want = J.build_perfect(*args), plain_build()
        assert JB.perfect_count.launches == before + 1, "build_perfect did not run J1"
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            agree(a, b)
        nbytes = _j1_bytes(keys, valid, nr, want.counts)
        slot64 = JB.perfect_count_plain(*args)[0].to(torch.int64)
        del got, want
        lines.append(dict(
            kernel="perfect_count", tag=tag, rows=keys.shape[0], live_rows=nr, slots=R,
            ms=timed(lambda: JB.perfect_count(*args), 10), bound_ms=nbytes / rate * 1e3,
            bound_bytes=nbytes,
            plain_ms=timed(lambda: JB.perfect_count_plain(*args), 10),
            library_ms=timed(lambda: torch.bincount(slot64, minlength=R + 1)[:R]
                             .to(torch.int32), 10),
            build_perfect_ms=timed(lambda: J.build_perfect(*args), 10),
            build_perfect_plain_ms=timed(plain_build, 10),
            **JB.kernel_info()))
        del slot64
    del cases, lineitem
    torch.cuda.empty_cache()
    return lines


# ---------------------------------------------------------------------------
# strings phase
# ---------------------------------------------------------------------------

STRING_ROWS = ROWS
# the result columns of each string cell that are FLOAT sums, and its key
# columns
STRING_F32_COLS = {"STR_EQ": {2}, "STR_IN": {2}, "STR_LIKE": {2}, "STR_TRANSFORM": {2},
                   "STR_LIKE_1M": {1}}
STRING_KEYS = {"STR_LIKE_1M": 0}


def _gather(table, ids):
    """Row i: table[ids[i]], False where the id is NULL (negative)."""
    ok = ids >= 0
    return ok & table[np.where(ok, ids, 0)]


def _over(vocab, pred):
    """A bool table over a vocabulary, the predicate evaluated in Python."""
    return np.array([bool(pred(s)) for s in vocab], bool)


def _grouped(keys, m, v, size):
    """count (and the float64 sum of v, if given) of the rows m per key in
    [0, size)."""
    cnt = np.bincount(keys[m], minlength=size)
    if v is None:
        return cnt, None
    return cnt, np.bincount(keys[m], weights=v[m].astype(np.float64), minlength=size)


def expected_strings(name, h, vocab):
    """numpy's rows of a string cell: {key tuple: value tuple}.  Each
    predicate is evaluated over its vocabulary in Python, then gathered by
    the rows' ids."""
    mode, instr, ptype, cname = (h[c] for c in ("shipmode", "shipinstruct", "ptype", "cname"))
    v = h["v"]
    if name in ("STR_EQ", "STR_LIKE", "STR_PAIR"):
        if name == "STR_EQ":
            m = _gather(_over(vocab["shipmode"], lambda s: s == "AIR"), mode)
            key, size = h["x10"], 11
        elif name == "STR_LIKE":
            m = _gather(_over(vocab["ptype"], lambda s: s.startswith("PROMO")), ptype)
            key, size = h["x100"], 101
        else:
            ok = np.array([[a + b == "AIRNONE" or a < b for b in vocab["shipinstruct"]]
                           for a in vocab["shipmode"]], bool)
            both = (mode >= 0) & (instr >= 0)
            m = both & ok[np.where(both, mode, 0), np.where(both, instr, 0)]
            key, size = h["x10"], 11
        cnt, sums = _grouped(key, m, None if name == "STR_PAIR" else v, size)
        return {(g,): (int(cnt[g]),) if sums is None else (int(cnt[g]), float(sums[g]))
                for g in np.nonzero(cnt)[0]}
    if name == "STR_IN":
        m = _gather(_over(vocab["shipmode"], lambda s: s in ("MAIL", "SHIP")), mode) \
            & _gather(_over(vocab["shipinstruct"], lambda s: s != "NONE"), instr)
        cnt, sums = _grouped(mode, m, v, len(vocab["shipmode"]))
        return {(vocab["shipmode"][i],): (int(cnt[i]), float(sums[i]))
                for i in np.nonzero(cnt)[0]}
    if name == "STR_MINMAX":
        words = vocab["ptype"]
        rank = np.empty(len(words), np.int64)
        rank[sorted(range(len(words)), key=words.__getitem__)] = np.arange(len(words))
        by_rank = sorted(words)
        ok = ptype >= 0
        g = h["x1k"].astype(np.int64)
        hist = np.bincount(g[ok] * len(words) + rank[ptype[ok]],
                           minlength=1001 * len(words)).reshape(1001, len(words)) > 0
        cnt = np.bincount(g, minlength=1001)
        out = {}
        for k in np.nonzero(cnt)[0]:
            present = np.nonzero(hist[k])[0]
            lo, hi = (by_rank[present[0]], by_rank[present[-1]]) if present.size \
                else (None, None)
            out[(k,)] = (lo, hi, int(cnt[k]))
        return out
    if name == "STR_TRANSFORM":
        words = vocab["ptype"]
        ok = ptype >= 0
        cnt, sums = _grouped(ptype, ok, v, len(words))
        out = {}
        for i, w in enumerate(words):
            c, s0 = out.get((w[:5],), (0, 0.0))
            out[(w[:5],)] = (c + int(cnt[i]), s0 + float(sums[i]))
        if (~ok).any():
            out[(None,)] = (int((~ok).sum()), float(v[~ok].astype(np.float64).sum()))
        return {k: c for k, c in out.items() if c[0]}
    if name == "STR_LIKE_1M":
        m = _gather(_over(vocab["cname"], lambda s: "7777" in s), cname)
        return {(): (int(m.sum()), float(v[m].astype(np.float64).sum()) if m.any() else None)}
    raise KeyError(name)


def check_strings(name, rs, h, vocab) -> int:
    """Raise unless the rows equal numpy's: counts and MIN / MAX strings
    exact, FLOAT sums to float32 tolerance."""
    want = expected_strings(name, h, vocab)
    n_keys = STRING_KEYS.get(name, 1)
    rows = rs.rows()
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows, numpy has {len(want)}")
    f32 = STRING_F32_COLS.get(name, ())
    for r in rows:
        key = tuple(int(k) if isinstance(k, (int, np.integer)) else k for k in r[:n_keys])
        if key not in want:
            raise AssertionError(f"{name}: row {r} has a key numpy has not")
        for j, (g, e) in enumerate(zip(r[n_keys:], want[key])):
            col = n_keys + j
            ok = (g is None and e is None) if e is None or g is None else (
                np.isclose(g, e, **F32_TOL) if col in f32 else g == e)
            if not ok:
                raise AssertionError(f"{name}: {r} vs {want[key]} (column {col})")
    return len(rows)


def run_strings(db, counters, n: int = STRING_ROWS):
    """The lstr table (tools/synthetic.py load_strings), then each
    STRING_QUERIES query with the launch counters set to 0 before the
    first: rows out, first and warm ms (median of 5), the group-by tier
    of each Compound run, the peak device bytes above what was allocated
    before it and the launches, each checked against numpy and ROUTES;
    STR_LIKE_1M's first run is cold (its 10^6-entry dictionary scanned for
    the first time), and its table is built again alone (aux_build_ms).
    Returns the lines and each kernel's launches in the phase."""
    from heavydb_tpu_torch.exec import executor as X
    from heavydb_tpu_torch.plan import rel_alg as R
    from heavydb_tpu_torch.plan.optimizer import optimize
    from heavydb_tpu_torch.sql.parser import parse_many
    from heavydb_tpu_torch.tools.synthetic import STRING_QUERIES, load_strings

    t0 = time.perf_counter()
    data, vocab = load_strings(db, n, SEED + 4)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    h = {c: t.cpu().numpy() for c, t in data.items()}
    del data
    ex = db.executor
    out = [dict(query="load_strings", seconds=load_s, rows=n,
                vocabulary={c: len(w) for c, w in vocab.items()})]
    for c in counters:
        c.launches = 0  # the strings path starts here
    with _RunSpy() as spy:
        for name, q in STRING_QUERIES.items():
            before = [c.launches for c in counters]
            del spy.runs[:]
            t0 = time.perf_counter()
            rs = db.sql(q)
            rs.rows()
            first_ms = (time.perf_counter() - t0) * 1e3
            run_tiers = [r[0] for r in spy.runs]
            nrows = check_strings(name, rs, h, vocab)
            warm, reps, peak = warm_ms(db, q)
            delta = [c.launches - b for c, b in zip(counters, before)]
            check_route(name, delta)
            line = dict(query=name, rows_out=nrows, first_with_decode_ms=first_ms,
                        warm_ms=warm, warm_runs_ms=reps,
                        tiers=run_tiers, peak_device_bytes=peak,
                        launches=dict(zip(KERNEL_NAMES, delta)))
            if name == "STR_LIKE_1M":
                plan = optimize(db._plan_select(parse_many(q)[0]))
                specs = X._expr_aux_specs(
                    e for node in R.topo_order(plan) for e in X._iter_node_exprs(node))
                cached = [k for k in ex.aux_cache if k[0] == "strpred"
                          and any(k[3] == sk for sk in specs)]
                for k in cached:
                    del ex.aux_cache[k]
                t0 = time.perf_counter()
                ex._aux_tables(specs, list(specs))
                torch.cuda.synchronize()
                line.update(cold_ms=first_ms, aux_build_ms=(time.perf_counter() - t0) * 1e3,
                            dictionary_entries=len(vocab["cname"]))
            out.append(line)
    return out, [c.launches for c in counters]


# small tables, the same rows on CUDA as on the CPU: every dictionary
# predicate kind SQL spells (LIKE, ILIKE, CMP with six operators, IN,
# LENGTH, INTFN, TRYCAST), a chained transform, a transform in ORDER BY,
# col || 'const' || col, the six pair comparisons, MIN / MAX over TEXT at 50
# (B1) and 3000 (B3) groups, and TEXT ENCODING NONE under LIKE, a transform
# and as a GROUP BY key
STRING_SHAPE_QUERIES = [
    "SELECT k50, COUNT(*) FROM ss WHERE a LIKE '%an%' GROUP BY k50",
    "SELECT COUNT(*), SUM(v) FROM ss WHERE a ILIKE 'B%' OR b ILIKE '%É%'",
    *[f"SELECT COUNT(*) FROM ss WHERE a {op} 'c'" for op in ("=", "<>", "<", "<=", ">", ">=")],
    "SELECT k50, COUNT(*) FROM ss WHERE a IN ('banana', 'x', '') GROUP BY k50",
    "SELECT COUNT(*) FROM ss WHERE b NOT IN ('42', 'nope')",
    "SELECT LENGTH(a) AS la, COUNT(*) FROM ss GROUP BY la",
    "SELECT k50, SUM(POSITION('a' IN a)), MAX(HASH(b)) FROM ss GROUP BY k50",
    "SELECT SUM(TRY_CAST(b AS INT)), COUNT(TRY_CAST(b AS DOUBLE)), "
    "MIN(TRY_CAST(b AS DATE)), MAX(TRY_CAST(b AS DATE)) FROM ss",
    "SELECT UPPER(REPLACE(SUBSTRING(a, 1, 4), 'a', 'o')) AS t, COUNT(*) FROM ss GROUP BY t",
    "SELECT a, k3000, v FROM ss WHERE k50 = 7 ORDER BY REVERSE(a) NULLS FIRST, k3000, v "
    "LIMIT 100",
    "SELECT a || '-' || b AS ab, COUNT(*) FROM ss GROUP BY ab",
    *[f"SELECT COUNT(*) FROM ss WHERE a {op} b" for op in ("=", "<>", "<", "<=", ">", ">=")],
    "SELECT k50, MIN(a), MAX(b), COUNT(*) FROM ss GROUP BY k50",
    "SELECT k3000, MIN(a), MAX(a) FROM ss GROUP BY k3000",
    "SELECT COUNT(*) FROM ss WHERE n LIKE 'Cust%7%'",
    "SELECT UPPER(n) AS u, COUNT(*) FROM ss WHERE k50 < 10 GROUP BY u",
    "SELECT n, COUNT(*), SUM(v) FROM ss GROUP BY n",
]
# the queries whose MIN / MAX must launch B1 (50 groups) and B3 (3000)
STRING_SHAPE_KERNELS = {"SELECT k50, MIN(a), MAX(b), COUNT(*) FROM ss GROUP BY k50":
                        "lane_agg",
                        "SELECT k3000, MIN(a), MAX(a) FROM ss GROUP BY k3000":
                        "groupby_minmax"}
SHAPE_WORDS_A = ["banana", "Banana", "apple", "", "cab", "x", "naïve", "Grüße", "ban an",
                 "c", "abc", "zz"]
SHAPE_WORDS_B = ["42", "-7", "3.5", "nope", "2024-02-29", "1999-12-31", "", "BÉTA", "c",
                 "apple", "x"]


def run_string_shapes(counters, n: int = 20_000):
    """STRING_SHAPE_QUERIES on CUDA against the same port on the CPU: the
    same rows (multisets without ORDER BY; FLOAT sums to float32
    tolerance), B1 and B3 launched by the MIN / MAX queries at 50 and 3000
    groups, and the pair_concat_max_entries refusal on both."""
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.errors import NotSupported

    rng = np.random.default_rng(SEED + 5)

    def words(vocab):
        w = np.array(vocab, object)[rng.integers(0, len(vocab), n)]
        w[rng.random(n) < 0.03] = None
        return w

    names = np.array([f"Customer#{i:09d}" for i in rng.integers(1, 500, n)], object)
    names[rng.random(n) < 0.03] = None
    cols = {"a": words(SHAPE_WORDS_A), "b": words(SHAPE_WORDS_B), "n": names,
            "k50": rng.integers(0, 50, n).astype(np.int32),
            "k3000": rng.integers(0, 3000, n).astype(np.int32),
            "v": rng.random(n).astype(np.float32)}
    dbs = [hdt.connect(), hdt.connect(device="cpu")]
    for db in dbs:
        db.sql("CREATE TABLE ss (a TEXT, b TEXT, n TEXT ENCODING NONE, k50 INT, k3000 INT, "
               "v FLOAT)")
        db.load_table("ss", cols)
        db.sql("CREATE TABLE cap (a TEXT, b TEXT)")
        db.sql("INSERT INTO cap VALUES ('p', 'q'), ('r', 's')")
    rows_out, launched = [], {}
    for q in STRING_SHAPE_QUERIES:
        before = [c.launches for c in counters]
        got, want = (db.sql(q).rows() for db in dbs)
        delta = dict(zip(KERNEL_NAMES, [c.launches - b for c, b in zip(counters, before)]))
        if q in STRING_SHAPE_KERNELS:
            kname = STRING_SHAPE_KERNELS[q]
            if not delta[kname]:
                raise AssertionError(f"{q}: {kname} did not launch: {delta}")
            launched[kname] = delta[kname]
        if "ORDER BY" not in q:
            got, want = sorted(got, key=repr), sorted(want, key=repr)
        if len(got) != len(want):
            raise AssertionError(f"{q}: {len(got)} rows on CUDA, {len(want)} on the CPU")
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                ok = np.isclose(a, b, **(F32_TOL if "SUM(v)" in q else F64_TOL)) \
                    if isinstance(b, float) and a is not None else a == b
                if not ok:
                    raise AssertionError(f"{q}: {g} on CUDA, {w} on the CPU")
        rows_out.append(len(got))
    refused = 0
    for db in dbs:
        db.config.pair_concat_max_entries = 3
        try:
            db.sql("SELECT a || b FROM cap").rows()
        except NotSupported:
            refused += 1
        finally:
            db.config.pair_concat_max_entries = 1 << 22
    if refused != len(dbs):
        raise AssertionError(f"|| past pair_concat_max_entries: {refused} of "
                             f"{len(dbs)} engines refused it")
    return dict(queries=len(STRING_SHAPE_QUERIES), rows=n, rows_out=rows_out,
                minmax_launches=launched, pair_cap_refused=refused)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# subqueries and set operations; the DISTINCT family
# ---------------------------------------------------------------------------

# (group-key columns, FLOAT-sum result columns) of each subq / distinct cell
SUBQ_SHAPES = {"SUBQ_SCALAR": (1, set()), "SUBQ_IN": (1, {2}), "SUBQ_NOT_IN": (1, set()),
               "UNION_ALL": (1, set()), "SET_INTERSECT": (1, set()), "ROLLUP": (2, {3})}
DISTINCT_SHAPES = {"DIST_COUNT": (1, set()), "DIST_COUNT_WIDE": (0, set()),
                   "DIST_SUM": (1, set()), "APPROX_CD": (1, set()), "MODE": (1, set())}


def _count_sum(keys, size, *cols):
    """bincount counts and float64 sums of each column over int keys."""
    return [np.bincount(keys, minlength=size)] + [
        np.bincount(keys, weights=c.astype(np.float64), minlength=size) for c in cols]


def _largest(keys, vals, size, span):
    """The largest of the small ints vals (1..span) of each key."""
    seen = np.bincount(keys * (span + 1) + vals, minlength=size * (span + 1)) > 0
    return span - np.argmax(seen.reshape(size, span + 1)[:, ::-1], axis=1)


def subq_in_ids(h):
    """x10m values whose SUM(x100) passes SUBQ_IN_BOUND (the inner query)."""
    from heavydb_tpu_torch.tools.synthetic import SUBQ_IN_BOUND
    s = np.bincount(h["x10m"], weights=h["x100"].astype(np.float64), minlength=10_000_001)
    return np.nonzero(s > SUBQ_IN_BOUND)[0]


def expected_subq(name, h, dims):
    """numpy answer of each SUBQ_QUERIES query: {key tuple: row tuple}."""
    if name == "SUBQ_SCALAR":
        cnt, s = _count_sum(h["x1k"], 1001, h["y100"])
        bound = int(h["y100"].sum(dtype=np.int64)) // 1000
        return {(k,): (int(cnt[k]), int(s[k])) for k in range(1, 1001) if s[k] > bound}
    if name == "SUBQ_IN":
        inside = np.zeros(10_000_001, bool)
        inside[subq_in_ids(h)] = True
        sel = inside[h["x10m"]]
        gk = _by_key(dims["dim10m"]["k"], dims["dim10m"]["g"], 10_000_001, np.int64)
        g = gk[h["x10m"][sel]]
        cnt, sv = _count_sum(g, 1001, h["v"][sel])
        mx = _largest(g, h["x100"][sel].astype(np.int64), 1001, 100)
        return {(k,): (int(cnt[k]), sv[k], int(mx[k])) for k in range(1001) if cnt[k]}
    if name == "SUBQ_NOT_IN":
        out = np.zeros(1001, bool)
        out[dims["dim1k"]["k"][dims["dim1k"]["nm"] < 5]] = True
        keep = ~out[h["x1k"]]
        cnt = np.bincount(h["x10"][keep], minlength=11)
        return {(k,): (int(cnt[k]),) for k in range(11) if cnt[k]}
    if name == "UNION_ALL":
        a, b = h["x10"] <= 3, h["x10"] >= 8
        ca, sa = _count_sum(h["x100"][a], 101, h["y10"][a])
        cb, sb = _count_sum(h["y100"][b], 101, h["x10"][b])
        return {(k,): (int(ca[k] + cb[k]), int(sa[k] + sb[k])) for k in range(101)
                if ca[k] + cb[k]}
    if name == "SET_INTERSECT":
        both = np.intersect1d(h["x10k"][h["x100k"] <= 20], h["x10k"][h["x100k"] > 99980])
        return {(int(k),): () for k in both}
    if name == "ROLLUP":
        x10 = h["x10"].astype(np.int64)
        c2, s2 = _count_sum(x10 * 101 + h["x100"], 11 * 101, h["v"])
        c1, s1 = _count_sum(x10, 11, h["v"])
        out = {(k // 101, k % 101): (int(c2[k]), s2[k]) for k in np.nonzero(c2)[0]}
        out.update({(k, None): (int(c1[k]), s1[k]) for k in np.nonzero(c1)[0]})
        out[(None, None)] = (int(c1.sum()), float(s1.sum()))
        return out
    raise KeyError(name)


def _splitmix64_np(x):
    """The reference's splitmix64 over uint64 numpy values."""
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def hll_estimates_np(keys, vals, size):
    """The reference's APPROX_COUNT_DISTINCT of int vals (1..10^7) per int
    key, on the host: splitmix64, register = the top 11 bits, rho = 64 -
    floor(log(f) x (1 / log 2)) of f = float64 of the rest with its low 11
    bits set, the largest rho a register, the HyperLogLog estimate with
    linear counting."""
    with np.errstate(over="ignore"):
        h = _splitmix64_np(np.arange(int(vals.max()) + 1, dtype=np.uint64))
        reg = (h >> np.uint64(53)).astype(np.int64)
        rest = (h << np.uint64(11)) | np.uint64(0x7FF)
    rho = 64 - np.floor(np.log(rest.astype(np.float64)) * (1.0 / np.log(2.0))).astype(
        np.int64)
    cell = keys.astype(np.int64) * 2048 + reg[vals]
    seen = np.zeros(size * 2048 * 64, bool)
    seen[cell * 64 + rho[vals]] = True
    seen = seen.reshape(size, 2048, 64)
    regs = np.where(seen.any(2), 63 - np.argmax(seen[:, :, ::-1], axis=2), 0)
    m = 2048
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.exp(np.log(2.0) * -regs.astype(np.float64)).sum(1)
    zeros = (regs == 0).sum(1).astype(np.float64)
    lc = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
    est = np.where((est <= 2.5 * m) & (zeros > 0), lc, est)
    return np.round(est).astype(np.int64)


def quantiles_np(keys, vals, size, q):
    """Each int key's exact quantile of vals (numpy's linear interpolation)
    and the range of its values."""
    order = np.argsort(keys.astype(np.int8), kind="stable")
    sv = vals[order].astype(np.float64)
    bounds = np.concatenate([[0], np.cumsum(np.bincount(keys, minlength=size))])
    out = {}
    for k in range(size):
        part = sv[bounds[k]:bounds[k + 1]]
        if part.shape[0]:
            out[k] = (float(np.quantile(part, q)), float(part.max() - part.min()))
    return out


def expected_distinct(name, h):
    """numpy answer of each DISTINCT_QUERIES query but QUANTILE: {key
    tuple: row tuple}."""
    if name == "DIST_COUNT":
        seen = np.zeros(101 * 10_001, bool)
        seen[h["x100"].astype(np.int64) * 10_001 + h["x10k"]] = True
        cnt = seen.reshape(101, 10_001).sum(1)
        return {(k,): (int(cnt[k]),) for k in range(101) if cnt[k]}
    if name == "DIST_COUNT_WIDE":
        seen = np.zeros(1_000_001, bool)
        seen[h["x1m_s10k"] // 10_000] = True
        return {(): (int(seen.sum()),)}
    if name == "DIST_SUM":
        seen = np.zeros((101, 1001), bool)
        seen.reshape(-1)[h["x100"].astype(np.int64) * 1001 + h["x1k"]] = True
        cnt = seen.sum(1)
        s = (seen * np.arange(1001)).sum(1)
        return {(k,): (int(s[k]), s[k] / cnt[k]) for k in range(101) if cnt[k]}
    if name == "APPROX_CD":
        est = hll_estimates_np(h["x10"], h["x10m"], 11)
        present = np.bincount(h["x10"], minlength=11) > 0
        return {(k,): (int(est[k]),) for k in range(11) if present[k]}
    if name == "MODE":
        cnt = np.bincount(h["x10"].astype(np.int64) * 101 + h["x100"],
                          minlength=11 * 101).reshape(11, 101)
        return {(k,): (int(np.argmax(cnt[k])),) for k in range(11) if cnt[k].any()}
    raise KeyError(name)


def check_rows(name, rows, want, n_keys, f32_cols) -> int:
    """Raise unless rows equal want ({key tuple: row tuple}): integers
    exact, FLOAT sums to float32 tolerance, other floats to float64's."""
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows, numpy has {len(want)}")
    for r in rows:
        w = want[tuple(r[:n_keys])]
        for j, (g, e) in enumerate(zip(r[n_keys:], w)):
            col = n_keys + j
            ok = np.isclose(g, e, **(F32_TOL if col in f32_cols else F64_TOL)) \
                if isinstance(e, float) else g == e
            if not ok:
                raise AssertionError(f"{name}: {r} vs {w} (column {col})")
    return len(rows)


def check_quantile(rows, h) -> dict:
    """QUANTILE against numpy's exact per-group median: within the
    histogram sketch's bound, (max - min) / 4096^2 a group (100 groups:
    4096 bins, 2 zooms)."""
    want = quantiles_np(h["x100"], h["v"], 101, 0.5)
    if len(rows) != len(want):
        raise AssertionError(f"QUANTILE: {len(rows)} rows, numpy has {len(want)}")
    worst = 0.0
    for k, got in rows:
        exact, span = want[k]
        bound = span / 4096 ** 2
        if not abs(got - exact) <= bound * (1 + 1e-9):
            raise AssertionError(f"QUANTILE: group {k}: {got} vs {exact} (bound {bound})")
        worst = max(worst, abs(got - exact) / bound if bound else 0.0)
    return dict(rows_out=len(rows), worst_error_over_bound=worst)


def warm_ms(db, q, reps: int = 5):
    """Median ms of reps runs through sql_device (parse to control read,
    the result left on the card), the runs, and the peak device bytes above
    what was allocated before them."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        db.sql_device(q)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), out, torch.cuda.max_memory_allocated() - base


def _measure(db, name, q, counters, check, spy):
    """One SUBQ / DISTINCT cell: the first run (checked), then five warm
    runs with the peak device bytes above what was allocated before them;
    launches of the cell and the group-by tier of each Compound of the
    first run."""
    before = [c.launches for c in counters]
    j1_before = _j1().launches
    del spy.runs[:]
    t0 = time.perf_counter()
    rs = db.sql(q)
    rows = rs.rows()
    first_ms = (time.perf_counter() - t0) * 1e3
    run_tiers = [r[0] for r in spy.runs]
    checked = check(rs, rows)
    joins = [dict(builds=r.builds, caps=r.caps, retries=r.retries)
             for r in db.executor.join_runs]
    warm, reps, peak = warm_ms(db, q)
    delta = [c.launches - b for c, b in zip(counters, before)]
    check_route(name, delta)
    return dict(query=name, **checked, first_with_decode_ms=first_ms,
                warm_ms=warm, warm_runs_ms=reps, tiers=run_tiers,
                joins=joins, peak_device_bytes=peak,
                launches=dict(zip(KERNEL_NAMES, delta)),
                j1_launches=_j1().launches - j1_before)


class _RunSpy:
    """Records (tier, cap) of every Compound run (Executor._postprocess) in
    `runs`; with `claims` on, the claims of every hash_group_ids call:
    slots a round, rounds, rows left unresolved, and the last round that
    resolved a key (each read back, so only outside timed runs)."""

    def __init__(self):
        from heavydb_tpu_torch.exec import executor as X
        from heavydb_tpu_torch.ops import groupby as G

        self.X, self.G = X, G
        self.post, self.claim = X.Executor._postprocess, G.hash_group_ids
        self.runs, self.claims, self.claims_on = [], [], False
        post, claim, me = self.post, self.claim, self

        def spy_post(ex, node, plan, outs):
            if plan.group_strategy is not None:
                me.runs.append((plan.group_strategy[0], plan.group_cap))
            return post(ex, node, plan, outs)

        def spy_claim(packed, mask, slots, rounds=4):
            gid, total, unresolved, keys = claim(packed, mask, slots, rounds)
            if me.claims_on:
                won = gid[gid < total]
                me.claims.append(dict(
                    slots=slots, rounds=rounds, unresolved=int(unresolved),
                    rounds_used=int(won.max()) // slots + 1 if won.numel() else 0))
            return gid, total, unresolved, keys

        self.spy_post, self.spy_claim = spy_post, spy_claim

    def __enter__(self):
        self.X.Executor._postprocess = self.spy_post
        self.G.hash_group_ids = self.spy_claim
        return self

    def __exit__(self, *exc):
        self.X.Executor._postprocess = self.post
        self.G.hash_group_ids = self.claim

    def first(self, fn):
        """fn() with the run and claim records cleared and claims on; returns
        (fn's result, ms, runs, claims)."""
        del self.runs[:], self.claims[:]
        self.claims_on = True
        try:
            t0 = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            self.claims_on = False
        return out, ms, list(self.runs), list(self.claims)


# sharded: Config.num_shards' path in one process (the executor's mesh)
SHARDED_SHARDS = 4  # Mesh([cuda:0] * 4): the one card four times
# each cell's query, how it shards, and the tier each leaf runs ("select":
# the top-k); the merge takes the tier of the keys' ranges
SHARDED_CELLS = {
    "NGA03": ("aggregate", "keyless"), "PHM001": ("aggregate", "perfect"),
    "Q100_MINMAX": ("aggregate", "perfect"), "PHS002": ("aggregate", "perfect"),
    "Q1K_MINMAX": ("aggregate", "perfect"), "Q10K": ("aggregate", "perfect"),
    "BH004": ("aggregate", "radix"), "Q10M_AGGS": ("aggregate", "radix"),
    "TOPK_V": ("topk", "select"), "JOIN_DIM1K": ("join", "perfect"),
}


def _sharded_query(name):
    return QUERIES.get(name) or SORT_QUERIES.get(name) or JOIN_QUERIES[name]


def _sharded_check(name, rs, host, dims) -> int:
    if name in QUERIES:
        # an AVG over a FLOAT column merges FLOAT SUM partials, as streamed
        return check_result(name, rs, host, set(F32_RESULT_COLS.get(name, ()))
                            | STREAM_F32_COLS.get(name, set()))
    if name in SORT_QUERIES:
        return check_sort(name, rs, host)
    return check_join(name, rs, host, dims)


def _busy_by_card(db, q) -> dict:
    """Device ms of one warm run on each card (torch.profiler's CUDA
    events by device index)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        db.sql_device(q)
        torch.cuda.synchronize()
    busy: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.device_index] = busy.get(e.device_index, 0.0) + e.time_range.elapsed_us() / 1e3
    return {f"cuda:{k}": v for k, v in sorted(busy.items())}


def _sharded_cells(db, host, dims, counters, shards: int, unsharded: dict) -> list:
    """Each SHARDED_CELLS query on db's mesh: the rows against numpy, the
    recorded mode and each leaf's tier, launches of its first run (each
    kernel of its route at least once a shard), first and warm ms (median
    of 5) and the peak device bytes above what was allocated before, beside
    `unsharded`'s (query -> (warm ms, peak bytes))."""
    ex = db.executor
    out = []
    for name, (kind, tier) in SHARDED_CELLS.items():
        q = _sharded_query(name)
        before = [c.launches for c in counters]
        j1_before = _j1().launches
        t0 = time.perf_counter()
        rs = db.sql(q)
        rs.column_raw(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        delta = [c.launches - b for c, b in zip(counters, before)]
        runs = list(ex.shard_runs)
        nrows = _sharded_check(name, rs, host, dims)
        if [(r.mode, r.kind) for r in runs] != [("sharded", kind)] \
                or runs[0].shards != shards or set(runs[0].tiers) != {tier}:
            raise AssertionError(f"sharded {name}: ran {runs}, expected a {kind} leaf "
                                 f"on each of {shards} shards on the {tier} tier")
        check_route(name, delta)
        short = [k for k, d in zip(KERNEL_NAMES, delta) if k in ROUTES[name] and d < shards]
        if short:
            raise AssertionError(f"sharded {name}: {short} launched fewer than once a "
                                 f"shard: {dict(zip(KERNEL_NAMES, delta))}")
        warm, reps, peak = warm_ms(db, q)
        out.append(dict(query=name, mode=runs[0].mode, kind=kind, shards=runs[0].shards,
                        tiers=runs[0].tiers, merge_tier=runs[0].merge_tier,
                        leaf_runs=runs[0].leaf_runs, rows_out=nrows,
                        first_with_decode_ms=first_ms, warm_ms=warm, warm_runs_ms=reps,
                        unsharded_warm_ms=unsharded.get(name, (None,))[0], peak_bytes=peak,
                        unsharded_peak_bytes=unsharded.get(name, (None, None))[1],
                        launches=dict(zip(KERNEL_NAMES, delta)),
                        j1_launches=_j1().launches - j1_before))
    return out


def run_sharded(db, host, dims, counters):
    """The sharded phase, on the e2e Database (bench's 10^8 rows and the join
    phase's dimension tables, before any statement changes them): each
    SHARDED_CELLS query unsharded (warm ms, median of 5, and peak), then with the
    executor's mesh set to Mesh([cuda:0] * 4), as the reference's test
    reads `executor.mesh`: every block a view of the resident column, the
    leaves one after another on the card, the merge there; then the mesh put
    back.  Launch counters from 0 before the phase.  Where the machine has
    two or more cards, the same queries under Config(num_shards=cards) on a
    new Database over distinct cards, with each card's busy ms; on one card
    a line saying that part did not run.  Returns the lines and each
    kernel's launches in the phase."""
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.config import Config
    from heavydb_tpu_torch.parallel.mesh import Mesh

    ex = db.executor
    unsharded = {}
    for name in SHARDED_CELLS:
        warm, _, peak = warm_ms(db, _sharded_query(name))
        unsharded[name] = (warm, peak)
    for c in counters:
        c.launches = 0  # the sharded path starts here
    ex.mesh = Mesh([torch.device("cuda", 0)] * SHARDED_SHARDS)
    try:
        lines = [dict(part="mesh", mesh=repr(ex.mesh), **cell) for cell in
                 _sharded_cells(db, host, dims, counters, SHARDED_SHARDS, unsharded)]
    finally:
        ex.mesh = None
    total = [c.launches for c in counters]
    cards = torch.cuda.device_count()
    if cards < 2:
        lines.append(dict(part="distinct_cards", ran=False,
                          reason=f"{cards} CUDA device: a mesh over distinct cards needs "
                                 "two or more, so no multi-GPU figure is taken"))
        return lines, total
    db2 = hdt.connect(config=Config(num_shards=cards))
    load_bench(db2, ROWS, SEED + 1)
    load_dims(db2, SEED + 2)
    for c in counters:
        c.launches = 0
    for cell in _sharded_cells(db2, host, dims, counters, cards, {}):
        cell["busy_ms_by_card"] = _busy_by_card(db2, _sharded_query(cell["query"]))
        lines.append(dict(part="distinct_cards", mesh=repr(db2.executor.mesh), **cell))
    total = [a + c.launches for a, c in zip(total, counters)]
    del db2
    torch.cuda.empty_cache()
    return lines, total


def run_subq(db, host, dims, counters):
    """Each SUBQ_QUERIES query on bench and load_dims' tables with the
    launch counters set to 0 before the first: rows against numpy, warm ms
    (median of 5), the tier of each Compound, join builds, peak device
    bytes and launches; SUBQ_IN also the size of its IN list and the time
    of the list's host sort and copy to the card, which its filter makes
    at every run (median of 5).  Returns the lines and each kernel's
    launches in the phase."""
    from heavydb_tpu_torch.tools.synthetic import SUBQ_QUERIES

    for c in counters:
        c.launches = 0  # the subq path starts here
    out = []
    with _RunSpy() as spy:
        for name, q in SUBQ_QUERIES.items():
            n_keys, f32 = SUBQ_SHAPES[name]
            want = expected_subq(name, host, dims)

            def check(rs, rows, name=name, want=want, n_keys=n_keys, f32=f32):
                return dict(rows_out=check_rows(name, rows, want, n_keys, f32))

            line = _measure(db, name, q, counters, check, spy)
            if name == "SUBQ_IN":
                ids = subq_in_ids(host).tolist()
                if not 1_000 <= len(ids) <= 20_000:
                    raise AssertionError(f"SUBQ_IN: its IN list holds {len(ids)} ids")

                def copy():
                    torch.from_numpy(np.sort(np.asarray(ids))).to("cuda")

                line.update(in_list_ids=len(ids), in_list_copy_ms=timed(copy, 5))
            out.append(line)
    return out, [c.launches for c in counters]


def run_distinct(db, host, counters):
    """Each DISTINCT_QUERIES query on bench (under its QUERY_SETTINGS),
    measured as run_subq's: rows against numpy (QUANTILE within the
    sketch's bound of the exact median, APPROX_CD equal to the host copy
    of the reference's HyperLogLog); DIST_COUNT also the claim rounds that
    resolved a key and the rows left unresolved.  Returns the lines and
    each kernel's launches in the phase."""
    from heavydb_tpu_torch.tools.synthetic import DISTINCT_QUERIES, query_settings

    for c in counters:
        c.launches = 0  # the distinct path starts here
    out = []
    with _RunSpy() as spy:
        for name, q in DISTINCT_QUERIES.items():
            if name == "QUANTILE":
                def check(rs, rows):
                    return check_quantile(rows, host)
            else:
                n_keys, f32 = DISTINCT_SHAPES[name]
                want = expected_distinct(name, host)

                def check(rs, rows, name=name, want=want, n_keys=n_keys, f32=f32):
                    return dict(rows_out=check_rows(name, rows, want, n_keys, f32))

            with query_settings(db, name) as settings:
                line = _measure(db, name, q, counters, check, spy)
                if name == "DIST_COUNT":
                    # one more run, read back: the claim rounds of the hash form
                    claims = spy.first(lambda: db.sql(q).rows())[3]
                    if not claims or claims[0]["unresolved"]:
                        raise AssertionError(f"DIST_COUNT: the hash form's claims: {claims}")
                    line.update(settings=settings, hash_claims=claims[0])
            out.append(line)
    return out, [c.launches for c in counters]


def _same_on_both(q, got, want, f32):
    """Raise unless the CUDA rows equal the CPU rows (as multisets without
    ORDER BY)."""
    if "ORDER BY" not in q:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    if len(got) != len(want):
        raise AssertionError(f"{q}: {len(got)} rows on CUDA, {len(want)} on the CPU")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            ok = (a is None and b is None) or (
                np.isclose(a, b, equal_nan=True, **(F32_TOL if f32 else F64_TOL))
                if isinstance(b, float) and a is not None else a == b)
            if not ok:
                raise AssertionError(f"{q}: {g} on CUDA, {w} on the CPU")


# small tables, the same rows on CUDA as on the CPU: nested IN, EXISTS /
# NOT EXISTS true and false, a scalar subquery with no row, NOT IN over a
# list with a NULL, IN and UNION across two dictionaries, INT with BIGINT
# and with FLOAT under UNION ALL, INTERSECT / EXCEPT with NULL rows, CUBE and
# GROUPING SETS, a CTE read twice, ANY / ALL, scalar subqueries in the
# select list and in a join's filter
SET_SHAPE_QUERIES = [
    "SELECT k, COUNT(*) FROM st WHERE a IN (SELECT a FROM su WHERE s IN "
    "(SELECT s FROM sn)) GROUP BY k",
    "SELECT COUNT(*) FROM st WHERE EXISTS (SELECT 1 FROM su WHERE a > 10)",
    "SELECT COUNT(*) FROM st WHERE EXISTS (SELECT 1 FROM su WHERE a > 1000)",
    "SELECT COUNT(*) FROM st WHERE NOT EXISTS (SELECT 1 FROM su WHERE a > 10)",
    "SELECT COUNT(*) FROM st WHERE NOT EXISTS (SELECT 1 FROM su WHERE a > 1000)",
    "SELECT COUNT(*), (SELECT a FROM su WHERE a > 1000) FROM st",
    "SELECT COUNT(*) FROM st WHERE a NOT IN (SELECT a FROM sn)",
    "SELECT COUNT(*) FROM st WHERE a NOT IN (SELECT a FROM su)",
    "SELECT k, COUNT(*) FROM st WHERE s IN (SELECT s FROM su) GROUP BY k",
    "SELECT s FROM st UNION SELECT s FROM su",
    "SELECT s, COUNT(*) FROM (SELECT s FROM st UNION ALL SELECT s FROM su) v GROUP BY s",
    "SELECT a FROM sn WHERE a = 3 UNION ALL SELECT b FROM st WHERE b > 8589934600",
    "SELECT a FROM sn WHERE a = 3 UNION ALL SELECT f FROM st WHERE f < 1",
    "SELECT a, s FROM st INTERSECT SELECT a, s FROM sn",
    "SELECT a FROM sn EXCEPT SELECT a FROM su",
    "SELECT a FROM st EXCEPT SELECT a FROM su",
    "SELECT k, a, COUNT(*), SUM(b) FROM st GROUP BY CUBE(k, a)",
    "SELECT k, a, COUNT(*) FROM st GROUP BY GROUPING SETS ((k, a), (a), ())",
    "WITH r AS (SELECT k, SUM(a) AS tot FROM st GROUP BY k) "
    "SELECT k, tot FROM r WHERE tot = (SELECT MAX(tot) FROM r)",
    "SELECT COUNT(*) FROM st WHERE a > ANY (SELECT a FROM sn)",
    "SELECT COUNT(*) FROM st WHERE a < ALL (SELECT a FROM su WHERE a > 40)",
    "SELECT k, (SELECT MAX(a) FROM su) FROM st WHERE k < 2",
    "SELECT st.k, COUNT(*) FROM st JOIN su ON st.a = su.a WHERE su.a < "
    "(SELECT AVG(a) FROM su) GROUP BY st.k",
]


def _twin_dbs():
    import heavydb_tpu_torch as hdt

    return [hdt.connect(), hdt.connect(device="cpu")]


def run_set_shapes(n: int = 20_000):
    """SET_SHAPE_QUERIES on CUDA against the same port on the CPU, and a
    scalar subquery with two rows raising ExecutionError on both."""
    from heavydb_tpu_torch.errors import ExecutionError

    rng = np.random.default_rng(SEED + 6)
    i32 = np.iinfo(np.int32).min
    st = {"a": np.where(rng.random(n) < 0.05, i32, rng.integers(0, 60, n)).astype(np.int32),
          "b": (rng.integers(0, 50, n) + (1 << 33)).astype(np.int64),
          "f": (rng.integers(0, 40, n) / 4).astype(np.float32),
          "s": np.array(["x", "y", "z", None], object)[rng.integers(0, 4, n)],
          "k": rng.integers(0, 10, n).astype(np.int32)}
    su = {"s": np.array(["y", "q", "z", "w"], object)[rng.integers(0, 4, 120)],
          "a": rng.integers(0, 80, 120).astype(np.int32)}
    dbs = _twin_dbs()
    for db in dbs:
        db.sql("CREATE TABLE st (a INT, b BIGINT, f FLOAT, s TEXT, k INT)")
        db.load_table("st", st)
        db.sql("CREATE TABLE su (s TEXT, a INT)")
        db.load_table("su", su)
        db.sql("CREATE TABLE sn (a INT, s TEXT)")
        db.sql("INSERT INTO sn VALUES (3, 'x'), (NULL, NULL), (7, 'q')")
    rows_out = []
    for q in SET_SHAPE_QUERIES:
        got, want = (db.sql(q).rows() for db in dbs)
        _same_on_both(q, got, want, False)
        rows_out.append(len(got))
    raised = 0
    for db in dbs:
        try:
            db.sql("SELECT COUNT(*) FROM st WHERE a = (SELECT a FROM sn)").rows()
        except ExecutionError:
            raised += 1
    if raised != len(dbs):
        raise AssertionError(f"a two-row scalar subquery raised on {raised} engines")
    return dict(queries=len(SET_SHAPE_QUERIES), rows=n, rows_out=rows_out,
                two_row_scalar_raised=raised)


def _distinct_shape_queries():
    qs = []
    for c in ("a", "b", "f", "d", "fn"):
        aggs = (f"COUNT(DISTINCT {c}), APPROX_COUNT_DISTINCT({c}), MODE({c}), "
                f"SUM(DISTINCT {c}), AVG(DISTINCT {c})")
        qs += [f"SELECT {aggs}, APPROX_QUANTILE({c}, 0.25) FROM sd",
               f"SELECT k, {aggs}, APPROX_MEDIAN({c}) FROM sd GROUP BY k",
               f"SELECT sp, {aggs}, APPROX_QUANTILE({c}, 0.9) FROM sd GROUP BY sp"]
    return qs


DISTINCT_SHAPE_QUERIES = _distinct_shape_queries()


def run_distinct_shapes(n: int = 20_000, n_big: int = (1 << 21) + 4096):
    """DISTINCT_SHAPE_QUERIES (every aggregate over INT, BIGINT, FLOAT and
    DOUBLE with NULLs, NaN and -0.0, keyless, grouped and on the sort tier)
    on CUDA against the same port on the CPU; then COUNT(DISTINCT) of a
    FLOAT NOT NULL over n_big rows on its hash form (the hash group-by on)
    against the CPU, and with hash_group_ids made to leave a row unresolved:
    the run ends on the sorted form and gives the sorted form's rows."""
    from heavydb_tpu_torch.exec import executor as X
    from heavydb_tpu_torch.ops import groupby as G

    rng = np.random.default_rng(SEED + 7)
    i32, i64 = np.iinfo(np.int32).min, np.iinfo(np.int64).min
    f = (rng.integers(0, 30, n) / 4).astype(np.float32)
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = np.nan
    d = rng.integers(-20, 20, n) / 8.0
    d[rng.random(n) < 0.05] = -0.0
    d[rng.random(n) < 0.05] = np.nan
    special = np.array([np.nan, -0.0, 0.0, np.inf, 1.5, -2.25], np.float32)
    sd = {"a": np.where(rng.random(n) < 0.05, i32, rng.integers(0, 500, n)).astype(np.int32),
          "b": np.where(rng.random(n) < 0.05, i64, rng.integers(0, 300, n) << 33),
          "f": f, "d": d, "fn": rng.choice(special, n),
          "k": rng.integers(0, 40, n).astype(np.int32),
          "sp": (rng.integers(0, 3000, n) * 1000003).astype(np.int64)}
    fn_big = (rng.integers(-400, 400, n_big) / 4).astype(np.float32)
    for val in (np.nan, -0.0, 0.0, np.inf):
        fn_big[rng.random(n_big) < 0.01] = val
    dbs = _twin_dbs()
    for db in dbs:
        db.sql("CREATE TABLE sd (a INT, b BIGINT, f FLOAT, d DOUBLE, fn FLOAT NOT NULL, "
               "k INT, sp BIGINT)")
        db.load_table("sd", sd)
        db.sql("CREATE TABLE sb (fn FLOAT NOT NULL, k INT)")
        db.load_table("sb", {"fn": fn_big, "k": rng.integers(0, 10, n_big).astype(np.int32)})
    rows_out = []
    for q in DISTINCT_SHAPE_QUERIES:
        got, want = (db.sql(q).rows() for db in dbs)
        _same_on_both(q, got, want, "(f)" in q or "(fn)" in q)
        rows_out.append(len(got))
    big = "SELECT k, COUNT(DISTINCT fn) FROM sb GROUP BY k"
    answers = {}
    for on in (True, False):
        for db in dbs:
            db.config.enable_hash_groupby = on
        got, want = (db.sql(big).rows() for db in dbs)
        _same_on_both(big, got, want, False)
        answers[on] = sorted(got)
    if answers[True] == answers[False]:
        raise AssertionError("the hash and the sorted COUNT(DISTINCT) forms agree on "
                             "-0.0 and NaN")
    # the overflow retry on CUDA: a claim table that leaves a row unresolved
    real, post = G.hash_group_ids, X.Executor._postprocess
    forced = []

    def short(packed, mask, slots, rounds=4):
        gid, total, _, keys = real(packed, mask, slots, rounds)
        return gid, total, torch.ones((), dtype=torch.int32, device=gid.device), keys

    def spy(ex, node, plan, outs):
        res = post(ex, node, plan, outs)
        forced.append(plan.distinct_force_sort)
        return res

    dbs[0].config.enable_hash_groupby = True
    G.hash_group_ids, X.Executor._postprocess = short, spy
    try:
        retried = sorted(dbs[0].sql(big).rows())
    finally:
        G.hash_group_ids, X.Executor._postprocess = real, post
        dbs[0].config.enable_hash_groupby = False
    if retried != answers[False] or forced != [True, True]:
        raise AssertionError(f"the overflow retry: {forced}, rows equal to the sorted "
                             f"form's: {retried == answers[False]}")
    return dict(queries=len(DISTINCT_SHAPE_QUERIES), rows=n, rows_out=rows_out,
                hash_form_rows=n_big, retry_runs=len(forced))



# ---------------------------------------------------------------------------
# the hash group-by tier; UPDATE / DELETE / CTAS / INSERT ... SELECT / TRUNCATE
# ---------------------------------------------------------------------------

def _grouped_np(keys, ok, *vals):
    """{key: (count, sum of each vals...)} over the rows ok; keys an int64
    array (a packed pair for two keys)."""
    k = keys[ok]
    uniq, inv = np.unique(k, return_inverse=True)
    cnt = np.bincount(inv)
    sums = [np.bincount(inv, weights=v[ok].astype(np.float64)) for v in vals]
    return uniq, inv, cnt, sums


def expected_hash(name, h):
    """numpy answer of each HASH_QUERIES query: {key tuple: row tuple}."""
    if name == "HASH_BIGINT":
        ok = h["x100"] > 10
        uniq, inv, cnt, (sv,) = _grouped_np(h["k"], ok, h["v"])
        mn = _reduce_at(np.minimum, inv, h["x100"][ok], uniq.shape[0],
                        np.iinfo(np.int32).max)
        return {(int(k),): (int(c), s, int(m)) for k, c, s, m in zip(uniq, cnt, sv, mn)}
    if name == "HASH_PAIR":
        pair = (h["a"].astype(np.int64) << 20) | h["b"]
        uniq, _, cnt, (sv,) = _grouped_np(pair, np.ones(pair.shape[0], bool), h["v"])
        return {(int(p >> 20), int(p & 0xFFFFF)): (int(c), s)
                for p, c, s in zip(uniq, cnt, sv)}
    raise KeyError(name)


# (group-key columns, FLOAT-sum result columns) of each hash cell
HASH_SHAPES = {"HASH_BIGINT": (1, {2}), "HASH_PAIR": (2, {3})}


def run_hash(db, host, counters):
    """The hsparse table (tools/synthetic.py load_hsparse), then each
    HASH_QUERIES query with the hash group-by on (its QUERY_SETTINGS) and
    the launch counters set to 0 before the first: rows against numpy, the
    tier of each run (the first must be hash), the NDV estimate, the ms of
    one uncached estimate and the estimates a warm run asks for, the
    claim-table cap, the retries, the claims (rows left unresolved, the
    rounds used), warm ms (median of 5), peak device bytes and launches;
    then the same query with the hash group-by off (the sort tier, its rows
    checked again) as the yardstick; and BH003 on bench with the flag on,
    which must stay on the sort tier (its rows / NDV estimate is past 32).
    Then hsparse again with HASH_KEYS_TRUE keys (25 rows a key), whose
    estimate the rule refuses, and each query on both tiers with the
    estimate set to the true key count.  Returns the lines and each
    kernel's launches in the phase."""
    from heavydb_tpu_torch.exec.executor import Executor
    from heavydb_tpu_torch.plan import rel_alg as R
    from heavydb_tpu_torch.plan.optimizer import optimize
    from heavydb_tpu_torch.sql.parser import parse_many
    from heavydb_tpu_torch.tools.synthetic import (HASH_KEYS, HASH_KEYS_TRUE, HASH_QUERIES,
                                                   HASH_ROWS, load_hsparse, query_settings)

    def load(keys, seed):
        t0 = time.perf_counter()
        data = load_hsparse(db, HASH_ROWS, seed, keys)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        h = {c: t.cpu().numpy() for c, t in data.items()}
        return h, dict(query="load_hsparse", seconds=load_s, rows=HASH_ROWS, keys=keys)

    def agg_node(q):
        plan = optimize(db._plan_select(parse_many(q)[0]))
        return next(n for n in R.topo_order(plan)
                    if isinstance(n, R.Compound) and n.is_aggregate)

    def ndv_cost(q):
        # the estimate, one uncached estimate's ms (median of 5: the
        # first fragment's 65,536-row head read and the host count) and
        # the estimates a warm run asks for (cache hits)
        node, ex = agg_node(q), db.executor
        ms = []
        for _ in range(5):
            ex._ndv_cache.clear()
            t0 = time.perf_counter()
            est = ex._estimate_group_ndv(node)
            ms.append((time.perf_counter() - t0) * 1e3)
        real, calls = Executor._estimate_group_ndv, []

        def count(self, node):
            calls.append(1)
            return real(self, node)

        Executor._estimate_group_ndv = count
        try:
            db.sql_device(q)
            torch.cuda.synchronize()
        finally:
            Executor._estimate_group_ndv = real
        return dict(ndv_estimate=est, ndv_sample_ms=statistics.median(ms),
                    ndv_sample_runs_ms=ms, ndv_estimates_per_run=len(calls))

    def cells(h, spy, tag):
        for name, q in HASH_QUERIES.items():
            n_keys, f32 = HASH_SHAPES[name]
            want = expected_hash(name, h)
            line = dict(query=name + tag)
            for on in (True, False):
                with query_settings(db, name) as settings:
                    db.config.enable_hash_groupby = on
                    before = [c.launches for c in counters]
                    rows, first_ms, runs, claims = spy.first(lambda: db.sql(q).rows())
                    nrows = check_rows(name, rows, want, n_keys, f32)
                    tier = "hash" if on else "sort"
                    if not runs or any(r[0] != tier for r in runs):
                        raise AssertionError(f"{name}{tag}: runs {runs}, expected the {tier} tier")
                    warm, reps, peak = warm_ms(db, q)
                    delta = [c.launches - b for c, b in zip(counters, before)]
                    check_route(name, delta)
                    part = dict(rows_out=nrows, tier=tier, runs=runs, first_with_decode_ms=first_ms,
                                warm_ms=warm, warm_runs_ms=reps, peak_device_bytes=peak,
                                launches=dict(zip(KERNEL_NAMES, delta)))
                    if on:
                        ndv = ndv_cost(q) if not tag else dict(ndv_estimate=HASH_KEYS_TRUE)
                        part.update(settings=settings, **ndv,
                                    claim_cap=runs[0][1], retries=len(runs) - 1,
                                    claims=claims, hash_unresolved=[c["unresolved"] for c in claims])
                        line.update(part)
                    else:
                        line["sort_tier"] = part
            line["hash_over_sort"] = line["warm_ms"] / line["sort_tier"]["warm_ms"]
            out.append(line)

    h, loaded = load(HASH_KEYS, SEED + 9)
    out = [loaded]
    for c in counters:
        c.launches = 0  # the hash path starts here
    with _RunSpy() as spy:
        cells(h, spy, "")
        # the rule's row cap: bench's sparse key with the flag on
        db.config.enable_hash_groupby = True
        try:
            rs, first_ms, runs, _ = spy.first(lambda: db.sql(QUERIES["BH003"]))
            est = db.executor._estimate_group_ndv(agg_node(QUERIES["BH003"]))
        finally:
            db.config.enable_hash_groupby = False
        if not runs or any(r[0] != "sort" for r in runs):
            raise AssertionError(f"BH003 with the hash group-by on: runs {runs}")
        out.append(dict(query="BH003", enable_hash_groupby=True, runs=runs,
                        rows_out=check_result("BH003", rs, host),
                        ndv_estimate=est, first_with_decode_ms=first_ms))
        # the rule's depth: the estimate of HASH_KEYS_TRUE keys is past
        # 2^19, so the hash tier runs only with the true count put in
        db.sql("DROP TABLE hsparse")
        h, loaded = load(HASH_KEYS_TRUE, SEED + 11)
        out.append(loaded)
        est = db.executor._estimate_group_ndv(agg_node(HASH_QUERIES["HASH_BIGINT"]))
        if est <= 1 << 19:
            raise AssertionError(f"{HASH_KEYS_TRUE} keys: estimate {est} is within the rule")
        real = Executor._estimate_group_ndv
        Executor._estimate_group_ndv = lambda self, node: HASH_KEYS_TRUE
        try:
            cells(h, spy, "_TRUE_NDV")
        finally:
            Executor._estimate_group_ndv = real
        out[-1].update(rule_estimate=est)
        db.sql("DROP TABLE hsparse")
    return out, [c.launches for c in counters]


def _hash_shape_columns(n, rng):
    """1000 distinct keys of each type over n rows (20 rows a key at
    20,000 rows: an NDV estimate of ~1000, so a 4096-slot claim table and
    4 x 4096 = 16384 slots, where B2 counts and sums), each drawn with the
    edges of its type: NULL, NaN, -0.0, subnormals and +-inf."""
    i32, i64 = np.iinfo(np.int32).min, np.iinfo(np.int64).min

    def pick(vals):
        return vals[rng.integers(0, vals.shape[0], n)]

    fedge = np.array([np.nan, -0.0, 0.0, 1e-45, -1e-45, 1.17549435e-38, np.inf, -np.inf],
                     np.float32)
    dedge = np.array([np.nan, -0.0, 0.0, 5e-324, -5e-324, 2.2250738585072014e-308,
                      np.inf, -np.inf])
    ki = pick(np.append(rng.integers(-2**31 + 1, 2**31 - 1, 999), i32).astype(np.int32))
    kb = pick(np.append(rng.integers(-2**62, 2**62, 999), i64))
    kf = pick(np.concatenate([fedge, (rng.random(992) * 1e6).astype(np.float32)]))
    kd = pick(np.concatenate([dedge, rng.random(992) * 1e12]))
    pairs = np.stack([rng.integers(-2**20, 2**20, 1000), rng.integers(0, 2**30, 1000)], 1)
    pairs[rng.random(1000) < 0.05, 0] = i32
    pairs[rng.random(1000) < 0.05, 1] = i32
    pq = pairs[rng.integers(0, 1000, n)].astype(np.int32)
    return {"ki": ki, "kb": kb, "kf": kf, "kd": kd, "p": pq[:, 0], "q": pq[:, 1],
            "v": rng.integers(-1000, 1000, n).astype(np.int32),
            "w": np.where(rng.random(n) < 0.05, np.nan, rng.random(n)).astype(np.float32)}


HASH_SHAPE_QUERIES = [
    *[f"SELECT {k}, COUNT(*), SUM(v), SUM(w), MIN(v), MAX(w) FROM hs GROUP BY {k}"
      for k in ("ki", "kb", "kf", "kd")],
    "SELECT p, q, COUNT(*), SUM(v), MAX(w) FROM hs GROUP BY p, q",
    "SELECT kd, COUNT(*) FROM hs WHERE v > 0 GROUP BY kd HAVING COUNT(*) > 8",
    "SELECT kb, COUNT(*) c FROM hs GROUP BY kb ORDER BY c DESC, kb LIMIT 10",
]


def run_hash_shapes(counters, n: int = 20_000):
    """HASH_SHAPE_QUERIES (single keys of INT, BIGINT, FLOAT and DOUBLE
    with NULL, NaN, -0.0, subnormals and +-inf; a range-packed pair with
    NULLs; HAVING; ORDER BY) with the hash group-by on, on CUDA against the
    same port on the CPU: the same rows, every run on the hash tier with a
    4096-slot claim table on both, and B2 launched at 16384 slots; then a
    claim table made to leave a row unresolved once: the run takes the
    hash_unresolved rung (cap x 4) and still gives the CPU's rows."""
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.config import Config

    cols = _hash_shape_columns(n, np.random.default_rng(SEED + 10))
    dbs = [hdt.connect(config=Config(enable_hash_groupby=True)),
           hdt.connect(device="cpu", config=Config(enable_hash_groupby=True))]
    for db in dbs:
        db.sql("CREATE TABLE hs (ki INT, kb BIGINT, kf FLOAT, kd DOUBLE, p INT, q INT, "
               "v INT, w FLOAT)")
        db.load_table("hs", cols)
    rows_out, b2 = [], 0
    with _RunSpy() as spy:
        for q in HASH_SHAPE_QUERIES:
            before = [c.launches for c in counters]
            (got, _, gruns, _), (want, _, wruns, _) = [
                spy.first(lambda db=db: db.sql(q).rows()) for db in dbs]
            delta = dict(zip(KERNEL_NAMES, [c.launches - b for c, b in zip(counters, before)]))
            if gruns != wruns or [r for r in gruns if r[0] == "hash"] != [("hash", 4096)]:
                raise AssertionError(f"{q}: runs {gruns} on CUDA, {wruns} on the CPU")
            if not delta["radix_hist"]:
                raise AssertionError(f"{q}: B2 did not launch at 16384 slots: {delta}")
            b2 += delta["radix_hist"]
            _same_on_both(q, got, want, "SUM(w)" in q)
            rows_out.append(len(got))
        # the hash_unresolved rung on CUDA
        q = HASH_SHAPE_QUERIES[1]
        want = dbs[1].sql(q).rows()
        real, forced = spy.G.hash_group_ids, []

        def short(packed, mask, slots, rounds=4):
            gid, total, unresolved, keys = real(packed, mask, slots, rounds)
            if not forced:
                forced.append(slots)
                unresolved = torch.ones((), dtype=torch.int32, device=gid.device)
            return gid, total, unresolved, keys

        spy.G.hash_group_ids = short
        try:
            got, _, runs, _ = spy.first(lambda: dbs[0].sql(q).rows())
        finally:
            spy.G.hash_group_ids = spy.spy_claim
        if runs != [("hash", 4096), ("hash", 16384)]:
            raise AssertionError(f"the hash_unresolved rung: runs {runs}")
        _same_on_both(q, got, want, True)
    return dict(queries=len(HASH_SHAPE_QUERIES), rows=n, rows_out=rows_out,
                b2_launches=b2, retry_runs=runs)


class _CopySpy:
    """Counts the bytes the body copies to the host: result batches read
    back (Batch.to_numpy: the live rows' bucket of each column) and lazy
    device chunks materialized for a host patch
    (LazyDeviceChunk._materialize)."""

    def __enter__(self):
        from heavydb_tpu_torch.exec import batch as B
        from heavydb_tpu_torch.storage import table as TB

        self.B, self.TB, self.bytes = B, TB, 0
        self.saved = to_numpy, materialize = B.Batch.to_numpy, TB.LazyDeviceChunk._materialize
        me = self

        def spy_to_numpy(batch):
            need = B.bucket(max(batch.nrows, 1))
            me.bytes += sum(min(c.shape[0], need) * c.element_size()
                            for c in batch.cols if c is not None)
            return to_numpy(batch)

        def spy_materialize(chunk):
            if chunk._np is None:
                me.bytes += chunk.nbytes
            return materialize(chunk)

        B.Batch.to_numpy, TB.LazyDeviceChunk._materialize = spy_to_numpy, spy_materialize
        return self

    def __exit__(self, *exc):
        self.B.Batch.to_numpy, self.TB.LazyDeviceChunk._materialize = self.saved


class _Split:
    """ms spent in each named method during the body, the card synchronised
    around each call; a method called inside another is timed in both.
    targets: (class or module, name) pairs, by default the DML path's."""

    def __init__(self, targets=None):
        from heavydb_tpu_torch.api import Database
        from heavydb_tpu_torch.exec.executor import Executor
        from heavydb_tpu_torch.storage.table import Fragment, LazyDeviceChunk, Table

        self.targets = targets or [
            (Database, "_matched_rows_and_values"), (Executor, "execute"),
            (LazyDeviceChunk, "_materialize"), (Fragment, "compute_stats"),
            (Table, "update_rows_at"), (Table, "delete_rows_at"),
            (Table, "insert_columns"), (Executor, "patch_cache_update"),
            (Executor, "patch_cache_delete")]
        self.ms = {}

    def __enter__(self):
        self.saved = [(cls, name, getattr(cls, name)) for cls, name in self.targets]
        for cls, name, orig in self.saved:
            def timed_call(*a, _orig=orig, _name=name, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    self.ms[_name] = self.ms.get(_name, 0.0) + (time.perf_counter() - t0) * 1e3

            setattr(cls, name, timed_call)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self.saved:
            setattr(cls, name, orig)


def dml_apply(step, h, b3):
    """The numpy model after each DML_STEPS statement: h (bench's kept
    columns) and b3 (the CTAS table's columns, or None) as they must be."""
    if step.startswith("UPDATE bench"):
        m = h["x1k"] == 5
        h["v"] = np.where(m, (h["v"].astype(np.float64) + 1.0).astype(np.float32), h["v"])
        h["x100"] = np.where(m, 0, h["x100"]).astype(np.int32)
        return h, b3, int(m.sum())
    if step.startswith("DELETE FROM bench"):
        keep = h["x10k"] > 10
        return {c: a[keep] for c, a in h.items()}, b3, int((~keep).sum())
    if step.startswith("CREATE TABLE b3"):
        m = h["x10"] <= 3
        return h, {c: h[c][m] for c in ("x10", "x1k", "x10m", "v")}, int(m.sum())
    if step.startswith("INSERT INTO b3"):
        m = h["x10"] == 10
        return h, {c: np.concatenate([b3[c], h[c][m]]) for c in b3}, int(m.sum())
    if step.startswith("TRUNCATE"):
        return h, {c: a[:0] for c, a in b3.items()}, int(b3["x10"].shape[0])
    raise KeyError(step)


def expected_dml(q, h, b3):
    """numpy answer of each DML_STEPS follow-up: {key tuple: row tuple}."""
    if q.startswith("SELECT x100, COUNT(*), SUM(v) FROM bench"):
        ok = h["x10"] > 3
        k = h["x100"][ok].astype(np.int64)
        cnt = np.bincount(k, minlength=101)
        sv = np.bincount(k, weights=h["v"][ok].astype(np.float64), minlength=101)
        return {(i,): (int(cnt[i]), sv[i]) for i in range(101) if cnt[i]}
    if q.startswith("SELECT x1k, MIN(x10k)"):
        k = h["x1k"].astype(np.int64)
        cnt = np.bincount(k, minlength=1001)
        mn = _reduce_at(np.minimum, k, h["x10k"], 1001, np.iinfo(np.int32).max)
        mx = _reduce_at(np.maximum, k, h["v"], 1001, -np.inf)
        return {(i,): (int(mn[i]), float(mx[i]), int(cnt[i])) for i in range(1001) if cnt[i]}
    if q == "SELECT COUNT(*), MAX(rowid) FROM bench":
        n = h["x10"].shape[0]
        return {(): (n, n - 1)}
    if q.startswith("SELECT x1k, COUNT(*), SUM(v) FROM b3"):
        k = b3["x1k"].astype(np.int64)
        cnt = np.bincount(k, minlength=1001)
        sv = np.bincount(k, weights=b3["v"].astype(np.float64), minlength=1001)
        return {(i,): (int(cnt[i]), sv[i]) for i in range(1001) if cnt[i]}
    if q == "SELECT COUNT(*) FROM b3":
        return {(): (int(b3["x10"].shape[0]),)}
    raise KeyError(q)


# (group-key columns, FLOAT-sum result columns, kernels the route launches)
# of each DML_STEPS follow-up: B1 at 101 slots after the UPDATE, B3 + B2 at
# 1000 slots after the DELETE, B2 over the CTAS table; the counts are keyless
DML_FOLLOW_UPS = {
    "SELECT x100": (1, {2}, {"lane_agg"}),
    "SELECT x1k, MIN(x10k)": (1, set(), {"radix_hist", "groupby_minmax"}),
    "SELECT COUNT(*), MAX(rowid)": (0, set(), set()),
    "SELECT x1k, COUNT(*), SUM(v) FROM b3": (1, {2}, {"radix_hist"}),
    "SELECT COUNT(*) FROM b3": (0, set(), set()),
}


def run_dml(db, host, counters):
    """DML_STEPS on bench, in order, with the launch counters set to 0
    before the first.  After each statement: its ms and the ms of its
    parts (`_Split`: the matched-rows query, the host copies of lazy
    chunks, chunk stats, the fragment patch, the device move of the scan
    cache), the rows it matched (or inserted) and the fragments it
    touched, the bytes it copied to the host (matched rows, lazy chunks
    materialized for the patch) and to the card, the scan cache's bytes
    and dropped keys; then each follow-up
    query: its first run's uploads (none after an UPDATE or a DELETE: the
    cache was patched), its rows against the numpy model of the table, its
    warm ms (median of 5) and launches.  Returns the lines and each
    kernel's launches in the phase.  `host`, the numpy model of bench,
    follows each statement (the later phases check against it)."""
    from heavydb_tpu_torch.tools.synthetic import DML_STEPS

    h = dict(host)
    b3 = None
    ex = db.executor
    for c in counters:
        c.launches = 0  # the dml path starts here
    out = []
    for cell, stmt, follow_ups in DML_STEPS:
        tname = "b3" if "b3" in stmt else "bench"
        t = db.catalog.get_table_opt(tname)
        frags_before = len(t.fragments) if t is not None else 0
        h2d0, dropped0 = ex.h2d_bytes, ex.cache_keys_dropped
        db.last_mutation = None
        with _CopySpy() as d2h, _Split() as split:
            t0 = time.perf_counter()
            db.sql(stmt)
            torch.cuda.synchronize()
            stmt_ms = (time.perf_counter() - t0) * 1e3
        h, b3, want_rows = dml_apply(stmt, h, b3)
        mut = db.last_mutation
        if mut is not None and mut["rows"] != want_rows:
            raise AssertionError(f"{cell}: {mut['rows']} rows matched, numpy has {want_rows}")
        line = dict(cell=cell, statement=stmt, statement_ms=stmt_ms, rows=want_rows,
                    fragments_touched=mut["fragments"] if mut else None,
                    fragments=len(db.catalog.get_table(tname).fragments),
                    fragments_before=frags_before, d2h_bytes=d2h.bytes,
                    h2d_bytes=ex.h2d_bytes - h2d0, scan_cache_bytes=ex.scan_cache.total_bytes,
                    cache_keys_dropped=ex.cache_keys_dropped - dropped0,
                    split_ms=split.ms, follow_ups=[])
        for q in follow_ups:
            n_keys, f32, route = next(v for k, v in DML_FOLLOW_UPS.items() if q.startswith(k))
            before = [c.launches for c in counters]
            h2d1 = ex.h2d_bytes
            t0 = time.perf_counter()
            rows = db.sql(q).rows()
            first_ms = (time.perf_counter() - t0) * 1e3
            uploaded = ex.h2d_bytes - h2d1
            if stmt.split()[0] in ("UPDATE", "DELETE") and uploaded:
                raise AssertionError(f"{cell}: {q} uploaded {uploaded} B after the "
                                     "statement; the scan cache was not patched")
            nrows = check_rows(cell, rows, expected_dml(q, h, b3), n_keys, f32)
            warm, reps, peak = warm_ms(db, q)
            delta = [c.launches - b for c, b in zip(counters, before)]
            for kname, d in zip(KERNEL_NAMES, delta):
                if (d > 0) != (kname in route):
                    raise AssertionError(f"{cell}: {q}: {kname} launched {d} times; "
                                         f"expected {sorted(route) or 'no kernel'}")
            line["follow_ups"].append(dict(
                query=q, rows_out=nrows, first_with_decode_ms=first_ms,
                first_run_h2d_bytes=uploaded,
                cache="uploaded" if uploaded else
                "patched" if stmt.split()[0] in ("UPDATE", "DELETE") else "resident",
                warm_ms=warm, warm_runs_ms=reps, peak_device_bytes=peak,
                launches=dict(zip(KERNEL_NAMES, delta))))
        out.append(line)
    host.clear()
    host.update(h)
    return out, [c.launches for c in counters]


# ---------------------------------------------------------------------------
# geo and arrays phases
# ---------------------------------------------------------------------------

# GEOINT32's published decode constants (the reference's
# Geospatial/CompressionRuntime.h): degrees = int32 x constant
GEOINT32_DX = 8.3819031754424345e-08
GEOINT32_DY = 4.1909515877212172e-08
INT32_NULL = int(np.iinfo(np.int32).min)
# the join residual's ray cast over a chunk of this many points x every
# zone segment (float64 temporaries of ~1.2 GB each)
BRUTE_POINTS = 8192
BRUTE_NEAR_POINTS = 1 << 16


def decoded(xy: np.ndarray):
    """float64 lon, lat of [n, 2] GEOINT32 coordinates."""
    return xy[:, 0] * GEOINT32_DX, xy[:, 1] * GEOINT32_DY


def zone_segments(zones):
    """float64 [Z, S] x1, y1, x2, y2 of every ring segment of each zone
    (its wrap edge included), decoded from the stored int32 payloads
    ([rings, +-coords a ring, coords...]); a zone with fewer segments is
    padded with ones at y = inf, which no ray crosses."""
    rows = []
    for _, row in zones:
        nr = int(row[0])
        off, parts = 1 + nr, []
        for sz in row[1:1 + nr].tolist():
            c = row[off:off + abs(sz)]
            off += abs(sz)
            x, y = c[0::2] * GEOINT32_DX, c[1::2] * GEOINT32_DY
            parts.append((x, y, np.roll(x, -1), np.roll(y, -1)))
        rows.append([np.concatenate(p) for p in zip(*parts)])
    width = max(r[0].shape[0] for r in rows)
    out = np.zeros((4, len(rows), width))
    out[1, :, :] = out[3, :, :] = np.inf
    for z, r in enumerate(rows):
        for k in range(4):
            out[k, z, :r[k].shape[0]] = r[k]
    return out


def expected_geo(name, g):
    """{key: row} of a GEO_QUERIES cell, independent of the engine: numpy
    over the generator's coordinates for the filter; for the joins, every
    point against every zone (the even-odd crossing expression of the
    reference's CONTAINS_SEG, term for term) or every station (its
    distance expression), in plain torch float64 on the card, in chunks of
    points."""
    x, y = decoded(g["trips_xy"])
    live = ~g["trips_null"]
    if name == "GEO_DWITHIN":
        dx, dy = x - -73.9857, y - 40.7484
        return {(): (int((live & (np.sqrt(dx * dx + dy * dy) <= 0.01)).sum()),)}
    dev = torch.device("cuda")
    tx, ty = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    tlive = torch.from_numpy(live).to(dev)
    if name == "GEO_NEAR_JOIN":
        sx, sy = (torch.from_numpy(c).to(dev)[None, :] for c in decoded(g["stations_xy"]))
        total = 0
        for a in range(0, tx.shape[0], BRUTE_NEAR_POINTS):
            dx = tx[a:a + BRUTE_NEAR_POINTS, None] - sx
            dy = ty[a:a + BRUTE_NEAR_POINTS, None] - sy
            hit = (torch.sqrt(dx * dx + dy * dy) <= 0.002) & tlive[a:a + BRUTE_NEAR_POINTS, None]
            total += int(hit.sum())
        return {(): (total,)}
    x1, y1, x2, y2 = (torch.from_numpy(s).to(dev)[None] for s in zone_segments(g["zones"]))
    fare = torch.from_numpy(g["fare"]).to(dev)
    Z = x1.shape[1]
    cnt, fsum = tx.new_zeros(Z, dtype=torch.int64), tx.new_zeros(Z)
    for a in range(0, tx.shape[0], BRUTE_POINTS):
        px = tx[a:a + BRUTE_POINTS, None, None]
        py = ty[a:a + BRUTE_POINTS, None, None]
        cr = ((y1 > py) != (y2 > py)) & (
            px < (x2 - x1) * (py - y1) / torch.where(y2 == y1, 1e-300, y2 - y1) + x1)
        inside = (cr.sum(-1) % 2 == 1) & tlive[a:a + BRUTE_POINTS, None]
        cnt += inside.sum(0)
        fsum += (inside * fare[a:a + BRUTE_POINTS, None]).sum(0)
    cnt, fsum = cnt.cpu().numpy(), fsum.cpu().numpy()
    return {(int(zid),): (int(cnt[z]), float(fsum[z] / cnt[z]))
            for z, (zid, _) in enumerate(g["zones"]) if cnt[z]}


def expected_array_cells(name, a):
    """{key: row} of an ARRAY_QUERIES cell: numpy over the generator's flat
    elements (INT32_MIN a NULL element) and row offsets."""
    flat, offs = a["flat"], a["offsets"]
    ok = flat != INT32_NULL
    if name == "ARR_UNNEST_GROUP":
        counts = np.bincount(flat[ok], minlength=1)
        want = {(int(v),): (int(c),) for v, c in enumerate(counts) if c}
        if (~ok).any():
            want[(None,)] = (int((~ok).sum()),)
        return want
    n = offs.shape[0] - 1
    lengths = np.diff(offs)
    row_of = np.repeat(np.arange(n), lengths)
    has7 = np.bincount(row_of[flat == 7], minlength=n) > 0
    first = flat[np.minimum(offs[:-1], max(flat.shape[0] - 1, 0))]
    hit = has7 & ~a["null"] & (lengths > 0) & (first != INT32_NULL) & (first < 500)
    return {(): (int(hit.sum()), float(a["w"][hit].sum()))}


def _cell(db, name, q, want, n_keys, counters, spy):
    """One geo or array cell: the first run (its aux tables built, checked
    against want), the join runs, five warm runs with their peak device
    bytes, the tier of each Compound, the launches of the cell
    (against ROUTES), a run with the ray cast timed apart, and a
    torch.profiler breakdown (tools/profile_queries.py)."""
    from heavydb_tpu_torch.exec import expr_compiler as XC
    from heavydb_tpu_torch.tools.profile_queries import profile_query

    before = [c.launches for c in counters]
    del spy.runs[:]
    t0 = time.perf_counter()
    rows = db.sql(q).rows()
    first_ms = (time.perf_counter() - t0) * 1e3
    tiers = [r[0] for r in spy.runs]
    nrows = check_rows(name, rows, want, n_keys, ())
    joins = [dict(builds=r.builds, caps=r.caps, retries=r.retries)
             for r in db.executor.join_runs]
    warm, reps, peak = warm_ms(db, q)
    delta = [c.launches - b for c, b in zip(counters, before)]
    check_route(name, delta)
    with _Split([(XC, "ray_cast")]) as split:
        t0 = time.perf_counter()
        db.sql_device(q)
        torch.cuda.synchronize()
        split_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_query(db, q)
    return dict(query=name, rows_out=nrows, first_with_decode_ms=first_ms,
                warm_ms=warm, warm_runs_ms=reps, tiers=tiers, joins=joins,
                peak_device_bytes=peak, launches=dict(zip(KERNEL_NAMES, delta)),
                ray_cast_ms=split.ms.get("ray_cast"),
                run_with_ray_cast_synced_ms=split_ms, profile=prof)


def run_geo(db, counters):
    """load_geo's trips (10^7 points), zones and stations, then each
    GEO_QUERIES cell with the launch counters set to 0 before the first
    (`_cell`), against the engine-independent expected rows.  Returns the
    lines (the load's seconds first) and each kernel's launches in the
    phase."""
    from heavydb_tpu_torch.tools.synthetic import GEO_QUERIES, TRIPS_ROWS, load_geo

    t0 = time.perf_counter()
    g = load_geo(db, SEED + 11)
    load_s = time.perf_counter() - t0
    out = [dict(query="load_geo", make_and_load_s=load_s,
                rows=dict(trips=TRIPS_ROWS, zones=len(g["zones"]),
                          stations=int(g["stations_xy"].shape[0])))]
    for c in counters:
        c.launches = 0  # the geo path starts here
    with _RunSpy() as spy:
        for name, q in GEO_QUERIES.items():
            t0 = time.perf_counter()
            want = expected_geo(name, g)
            expected_s = time.perf_counter() - t0
            line = _cell(db, name, q, want, 1 if name == "GEO_ZONE_JOIN" else 0,
                         counters, spy)
            line["expected_s"] = expected_s
            out.append(line)
    # each table's first use: the first run of the first cell that reads it
    # (its aux tables built on the host and copied to the card)
    first = {ln["query"]: ln["first_with_decode_ms"] / 1e3 for ln in out[1:]}
    out[0]["first_use_s"] = dict(trips=first["GEO_DWITHIN"], zones=first["GEO_ZONE_JOIN"],
                                 stations=first["GEO_NEAR_JOIN"])
    out.append(ray_cast_gathers(g))
    return out, [c.launches for c in counters]


def ray_cast_gathers(g, n: int = 1 << 24) -> dict:
    """One pass's segment gathers of the ray cast at its chunk of n pair
    rows over the zones' segments: four 1-D gathers (expr_compiler.ray_cast)
    beside one row gather of the same [segments, 4] table."""
    x1, y1, x2, y2 = zone_segments(g["zones"]).reshape(4, -1)
    real = np.isfinite(y1)  # not a padding segment
    segs = [torch.from_numpy(np.ascontiguousarray(a[real])).to("cuda")
            for a in (x1, y1, x2, y2)]
    seg4 = torch.stack(segs, 1)
    j = torch.from_numpy(np.random.default_rng(SEED + 15).integers(0, seg4.shape[0], n)).to(
        "cuda")
    return dict(query="ray_cast_gathers", rows=n, segments=int(seg4.shape[0]),
                gathers_1d_ms=timed(lambda: [s[j] for s in segs], 10),
                row_gather_ms=timed(lambda: seg4[j], 10))


def run_arrays(db, counters):
    """load_arrays' arr (10^7 rows), then each ARRAY_QUERIES cell as
    run_geo's, against numpy over the generator's elements."""
    from heavydb_tpu_torch.tools.synthetic import ARRAY_QUERIES, ARRAY_ROWS, load_arrays

    t0 = time.perf_counter()
    a = load_arrays(db, ARRAY_ROWS, SEED + 12)
    load_s = time.perf_counter() - t0
    out = [dict(query="load_arrays", make_and_load_s=load_s, rows=ARRAY_ROWS,
                elements=int(a["flat"].shape[0]))]
    for c in counters:
        c.launches = 0  # the arrays path starts here
    with _RunSpy() as spy:
        for name, q in ARRAY_QUERIES.items():
            want = expected_array_cells(name, a)
            out.append(_cell(db, name, q, want, 1 if name == "ARR_UNNEST_GROUP" else 0,
                             counters, spy))
    out[0]["first_use_s"] = dict(arr=out[1]["first_with_decode_ms"] / 1e3)
    return out, [c.launches for c in counters]


# small geo tables: every ST_* of the reference's geo suites, the three
# grid-join kinds, holes, multipolygons, NULL geometries, GEOINT32 and
# uncompressed columns, on CUDA against the same port on the CPU
GEO_SHAPE_TABLES = [
    "CREATE TABLE geo (id INT, p POINT, zone GEOMETRY(POLYGON, 4326))",
    "INSERT INTO geo VALUES (1, 'POINT(1 1)', 'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))'), "
    "(2, 'POINT(10 10)', 'POLYGON((0 0, 2 0, 2 2, 0 2, 0 0))'), (3, NULL, NULL)",
    "CREATE TABLE pts2 (a POINT, b POINT)",
    "INSERT INTO pts2 VALUES ('POINT(0 0)', 'POINT(3 4)')",
    "CREATE TABLE ln (path LINESTRING)",
    "INSERT INTO ln VALUES ('LINESTRING(0 0, 3 4, 3 8)')",
    "CREATE TABLE mr (poly POLYGON, mp MULTIPOLYGON)",
    "INSERT INTO mr VALUES ('POLYGON((0 0, 10 0, 10 10, 0 10), (4 4, 6 4, 6 6, 4 6))', "
    "'MULTIPOLYGON(((0 0, 2 0, 2 2, 0 2)), ((5 5, 7 5, 7 7, 5 7)))')",
    "CREATE TABLE si (poly POLYGON, ln LINESTRING, p POINT)",
    "INSERT INTO si VALUES ('POLYGON((0 0, 4 0, 4 4, 0 4))', 'LINESTRING(-1 -1, 5 5)', "
    "'POINT(2 2)'), ('POLYGON((10 10, 12 10, 12 12, 10 12))', 'LINESTRING(20 20, 21 21)', "
    "'POINT(30 30)')",
    "CREATE TABLE cz (id INT, z POLYGON, p POINT)",
    "INSERT INTO cz VALUES (1, 'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0),(2 1, 3 1, 3 2, 2 2, 2 1))', "
    "'POINT(3 7)'), (2, 'POLYGON((0 0, 2 0, 2 6, 0 6, 0 0))', 'POINT(1 1)'), (3, NULL, NULL)",
    "CREATE TABLE g (a GEOMETRY(POINT, 4326), b GEOMETRY(POINT, 4326) ENCODING NONE, c POINT)",
    "INSERT INTO g VALUES ('POINT(1.5 2.5)', 'POINT(1.5 2.5)', 'POINT(1.5 2.5)'), "
    "('POINT(-122.4194 37.7749)', NULL, 'POINT(-73.9857 40.7484)')",
    "CREATE TABLE gb (id INT, z POLYGON, l LINESTRING)",
    "INSERT INTO gb VALUES (1, 'POLYGON((1 2, 5 2, 5 8, 1 8, 1 2))', "
    "'LINESTRING(0 0, 3 4, -2 1)'), (2, NULL, NULL)",
    "CREATE TABLE cpts (g GEOMETRY(POINT))",
    "INSERT INTO cpts VALUES ('POINT (10 20)')",
    "CREATE TABLE ply (g GEOMETRY(POLYGON))",
    "INSERT INTO ply VALUES ('POLYGON ((0 0, 4 0, 4 4, 0 4))')",
    "CREATE TABLE th (g GEOMETRY(POLYGON))",
    "INSERT INTO th VALUES ('POLYGON ((0 0, 4 0, 4 4, 0 4), (1 1, 3 1, 3 3, 1 3))')",
    "CREATE TABLE tu (a GEOMETRY(POLYGON), b GEOMETRY(POLYGON))",
    "INSERT INTO tu VALUES ('POLYGON ((0 0, 1 0, 1 1, 0 1))', 'POLYGON ((5 5, 7 5, 7 7, 5 7))')",
]
GEO_SHAPE_QUERIES = [
    "SELECT id, p, zone, ST_X(p), ST_Y(p), ST_Distance(p, 'POINT(0 0)') FROM geo ORDER BY id",
    "SELECT id FROM geo WHERE ST_DWithin(p, 'POINT(0 0)', 2.0)",
    "SELECT ST_Distance(a, b) FROM pts2",
    "SELECT id, ST_Contains(zone, p), ST_Contains(zone, ST_GeomFromText('POINT(1 1)')), "
    "ST_Within(p, zone) FROM geo ORDER BY id",
    "SELECT id FROM geo WHERE ST_Contains('POLYGON((0 0, 5 0, 5 5, 0 5, 0 0))', p)",
    "SELECT ST_Area(zone), ST_Perimeter(zone), ST_NPoints(zone), ST_NRings(zone), "
    "ST_SRID(zone) FROM geo ORDER BY id",
    "SELECT ST_Length(path), ST_NPoints(path), path FROM ln",
    "SELECT ST_AREA(poly), ST_AREA(mp), ST_NPOINTS(mp), ST_PERIMETER(poly), mp, "
    "ST_CONTAINS(poly, 'POINT(5 5)'), ST_CONTAINS(mp, 'POINT(6 6)') FROM mr",
    "SELECT ST_INTERSECTS(poly, 'POLYGON((3 3, 6 3, 6 6, 3 6))'), "
    "ST_INTERSECTS(ln, 'POLYGON((0 0, 4 0, 4 4, 0 4))'), ST_INTERSECTS(poly, p) FROM si",
    "SELECT id, ST_X(ST_Centroid(z)), ST_Y(ST_Centroid(z)), ST_X(ST_Centroid(p)) FROM cz "
    "ORDER BY id",
    "SELECT ST_X(a), ST_X(b), ST_X(c), a, b, c FROM g",
    "SELECT ST_XMin(z), ST_XMax(z), ST_YMin(z), ST_YMax(z), ST_XMin(l), ST_YMax(l) FROM gb "
    "ORDER BY id",
    "SELECT ST_X(ST_Transform(a, 900913)), ST_Y(ST_Transform(a, 900913)) FROM g",
    "SELECT ST_AREA(ST_BUFFER(g, 2.0)), ST_ASTEXT(ST_BUFFER(g, 2.0)) FROM cpts",
    "SELECT ST_AREA(ST_INTERSECTION(g, 'POLYGON ((0 0, 2 0, 2 4, 0 4))')) FROM th",
    "SELECT ST_AREA(ST_DIFFERENCE(g, 'POLYGON ((3 1, 6 1, 6 3, 3 3))')), "
    "ST_NRINGS(ST_DIFFERENCE(g, 'POLYGON ((1 1, 2 1, 2 2, 1 2))')) FROM ply",
    "SELECT ST_AREA(ST_UNION(a, b)), ST_ASTEXT(ST_UNION(a, b)) FROM tu",
    # the grid joins: dwithin, poly_build (a hole, a NULL zone), poly_probe
    "SELECT a.id, b.id FROM gpa a, gpb b WHERE ST_DWITHIN(a.p, b.p, 0.3)",
    "SELECT z.zid, COUNT(*), AVG(ST_X(p.p)) FROM gpa p, gz z WHERE ST_CONTAINS(z.zone, p.p) "
    "GROUP BY z.zid",
    "SELECT z.zid, p.id FROM gzbig z, gpb p WHERE ST_CONTAINS(z.zone, p.p)",
    "SELECT COUNT(*) FROM gpa p JOIN gz z ON ST_INTERSECTS(p.p, z.zone)",
]
# the build form each grid join of GEO_SHAPE_QUERIES must take
GEO_SHAPE_JOINS = {"geo dwithin x9", "geo poly_build x4", "geo poly_probe x4"}


def _geo_shape_rows(rng, n, lo, hi, nulls):
    pts = rng.uniform(lo, hi, (n, 2))
    return [f"({i}, NULL)" if i in nulls else f"({i}, 'POINT({x!r} {y!r})')"
            for i, (x, y) in enumerate(pts.tolist())]


def _geo_shape_zones(rng, n):
    out = []
    for i in range(n):
        cx, cy = rng.uniform(0, 18, 2).tolist()
        w, h = rng.uniform(0.5, 3.0, 2).tolist()
        if i % 4 == 0:
            out.append(f"({i}, NULL)")
        elif i % 3 == 0:
            out.append(f"({i}, 'POLYGON(({cx} {cy}, {cx+w} {cy}, {cx+w} {cy+h}, {cx} {cy+h}),"
                       f"({cx+w*.4} {cy+h*.4}, {cx+w*.6} {cy+h*.4}, {cx+w*.6} {cy+h*.6}, "
                       f"{cx+w*.4} {cy+h*.6}))')")
        else:
            out.append(f"({i}, 'POLYGON(({cx} {cy}, {cx+w} {cy}, {cx+w*.5} {cy+h}))')")
    return out


def run_geo_shapes(counters):
    """GEO_SHAPE_QUERIES on CUDA against the same port on the CPU (whose
    rows tests/test_torch_geo*.py hold to the JAX package's): the same
    rows, each grid-join kind taken on CUDA.  Returns the line and each
    kernel's launches in the phase."""
    rng = np.random.default_rng(SEED + 13)
    tables = GEO_SHAPE_TABLES + [
        "CREATE TABLE gpa (id INT, p POINT)",
        "INSERT INTO gpa VALUES " + ", ".join(_geo_shape_rows(rng, 600, 0, 20, {3, 9})),
        "CREATE TABLE gpb (id INT, p POINT)",
        "INSERT INTO gpb VALUES " + ", ".join(_geo_shape_rows(rng, 80, 0, 20, {0})),
        "CREATE TABLE gz (zid INT, zone GEOMETRY(POLYGON, 4326))",
        "INSERT INTO gz VALUES " + ", ".join(_geo_shape_zones(rng, 30)),
        "CREATE TABLE gzbig (zid INT, zone MULTIPOLYGON)",
        "INSERT INTO gzbig VALUES " + ", ".join(
            r.replace("'POLYGON(", "'MULTIPOLYGON((").replace("))')", ")))')")
            for r in _geo_shape_zones(rng, 300)),
    ]
    dbs = _twin_dbs()
    for db in dbs:
        for st in tables:
            db.sql(st)
    for c in counters:
        c.launches = 0  # the geo_shapes path starts here
    rows_out, builds = [], set()
    for q in GEO_SHAPE_QUERIES:
        got, want = (db.sql(q).rows() for db in dbs)
        builds |= {" ".join(b.split()[:3]) for r in dbs[0].executor.join_runs
                   for b in r.builds}
        _same_on_both(q, got, want, False)
        rows_out.append(len(got))
    if builds != GEO_SHAPE_JOINS:
        raise AssertionError(f"geo_shapes: grid joins {builds}, expected {GEO_SHAPE_JOINS}")
    return dict(queries=len(GEO_SHAPE_QUERIES), rows_out=rows_out,
                joins=sorted(builds)), [c.launches for c in counters]


ARRAY_SHAPE_TABLES = [
    "CREATE TABLE t (id INT, tags TEXT[], vals INT[], w DOUBLE, d DOUBLE[])",
    "INSERT INTO t VALUES (1, {'a','b'}, {1,2,3}, 1.5, {0.5, NULL}), "
    "(2, {'b','c','d'}, {4}, 2.5, NULL), (3, NULL, {}, 3.5, {}), "
    "(4, {'a'}, {7, NULL, 9}, 4.5, {2.25})",
    "CREATE TABLE aeq (a INT[], b INT[], s TEXT[], s2 TEXT[])",
    "INSERT INTO aeq VALUES ({1,2,3}, {1,2,3}, {'x','y'}, {'x','y'}), "
    "({4,5}, {4,6}, {'a'}, {'b'}), (NULL, {1}, NULL, {'z'})",
]
ARRAY_SHAPE_QUERIES = [
    "SELECT id, tags, vals, d FROM t ORDER BY id",
    "SELECT id, CARDINALITY(tags), CARDINALITY(vals), vals[1], vals[2], vals[9], tags[1], "
    "d[2] FROM t ORDER BY id",
    "SELECT id FROM t WHERE 'a' = ANY tags OR 5 < ANY vals ORDER BY id",
    "SELECT id FROM t WHERE 'z' <> ALL tags AND 2 >= ALL vals ORDER BY id",
    "SELECT id FROM t WHERE NULL = ANY vals OR 1.5 < ALL d ORDER BY id",
    "SELECT a = b, s = s2 FROM aeq",
    "SELECT id, UNNEST(tags) FROM t ORDER BY id",
    "SELECT UNNEST(tags) tag, COUNT(*) FROM t GROUP BY tag",
    "SELECT id, UNNEST(vals) v FROM t WHERE id > 1",
    "SELECT SUM(UNNEST(vals)), COUNT(*) FROM t",
    "SELECT UNNEST(vals) v, COUNT(*), SUM(w) FROM t GROUP BY v",
    "SELECT id, vals, tags[2] FROM big WHERE id >= 15000 AND 3 = ANY vals",
    "SELECT UNNEST(tags) s, COUNT(*), SUM(w) FROM big WHERE CARDINALITY(vals) > 2 GROUP BY s",
    "SELECT UNNEST(vals) v, COUNT(*) FROM big GROUP BY v",
    "SELECT id, tags FROM t2 ORDER BY id",
    "SELECT COUNT(*), SUM(CARDINALITY(vals)), MAX(vals[1]) FROM t3",
    "SELECT id, UNNEST(vals), tags[1] FROM big WHERE id < 300",
]
# statements between the queries of ARRAY_SHAPE_QUERIES that read t2 / t3
ARRAY_SHAPE_DML = [
    "CREATE TABLE t2 AS SELECT id, tags FROM t WHERE id <= 2",
    "INSERT INTO t2 SELECT id, tags FROM t WHERE id = 4",
    "CREATE TABLE t3 AS SELECT id, vals, tags FROM big WHERE id < 5000",
    "DELETE FROM t3 WHERE id % 3 = 0",
    "DELETE FROM big WHERE id % 7 = 1",
]


def run_array_shapes(counters, n: int = 20_000):
    """Every ArrayFn op, UNNEST in the projection, under GROUP BY, after a
    filter and over TEXT[], and CTAS, INSERT ... SELECT and DELETE of
    tables with arrays, on small tables (one of n rows in 4096-row
    fragments): the same rows on CUDA as on the CPU.  Returns the line and
    each kernel's launches in the phase."""
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.config import Config

    rng = np.random.default_rng(SEED + 14)
    words = np.array(["p", "q", "r", "s", "t"], object)
    vals, tags = [], []
    for i in range(n):
        k = int(rng.integers(0, 6))
        vals.append(None if i % 50 == 7 else
                    [None if rng.random() < 0.05 else int(v) for v in rng.integers(0, 20, k)])
        tags.append(None if i % 40 == 3 else list(words[rng.integers(0, 5, k % 3)]))
    big = {"id": np.arange(n, dtype=np.int32), "vals": vals, "tags": tags, "w": rng.random(n)}
    dbs = [hdt.connect(config=Config(default_fragment_rows=4096)),
           hdt.connect(device="cpu", config=Config(default_fragment_rows=4096))]
    for db in dbs:
        for st in ARRAY_SHAPE_TABLES:
            db.sql(st)
        db.sql("CREATE TABLE big (id INT, vals INT[], tags TEXT[], w DOUBLE)")
        db.load_table("big", big)
    for c in counters:
        c.launches = 0  # the array_shapes path starts here
    rows_out = []
    for q in ARRAY_SHAPE_QUERIES:
        if q.endswith(("FROM t2 ORDER BY id",)):
            for db in dbs:
                for st in ARRAY_SHAPE_DML:
                    db.sql(st)
        got, want = (db.sql(q).rows() for db in dbs)
        _same_on_both(q, got, want, False)
        rows_out.append(len(got))
    return dict(queries=len(ARRAY_SHAPE_QUERIES), statements=len(ARRAY_SHAPE_DML), rows=n,
                rows_out=rows_out), [c.launches for c in counters]


# ---------------------------------------------------------------------------
# window, window_shapes, udf and udf_shapes phases
# ---------------------------------------------------------------------------

# result columns held to rtol 1e-6: WIN_FRAMES' MAX(ma), a difference of
# global prefixes over 10^8 rows (~5 x 10^7 at the end) against the
# direct 4-row sum, which loses ~10^-8 relative to the prefix
PREFIX_TOL = dict(rtol=1e-6, atol=1e-9)
WINDOW_TOLS = {"WIN_RUNNING": {}, "WIN_TOPN": {}, "WIN_FRAMES": {1: PREFIX_TOL},
               "UDF_GROUP": {}}
WINDOW_KEYS = {"WIN_RUNNING": 1, "WIN_FRAMES": 1, "UDF_GROUP": 1}
# each window spec's egress mode and sort, in order (Executor.window_runs)
WINDOW_PLANS = {
    "WIN_RUNNING": [("sorted", "packed")],
    "WIN_TOPN": [("sorted", "generic")],
    "WIN_FRAMES": [("permsort", "packed")] * 3,
    "UDF_GROUP": [],
}
ROUTES.update({
    # the window phase: the sorts and scans are plain torch, as the
    # reference's are plain XLA; the GROUP BY over the window launches B1
    # (10 and 100 slots); WIN_TOPN has no GROUP BY
    "WIN_RUNNING": {"lane_agg"}, "WIN_TOPN": set(), "WIN_FRAMES": {"lane_agg"},
    # the udf phase: HYPOT runs in the Compound, its SUM on B1
    "UDF_GROUP": {"lane_agg"},
})


def _first_of_run(s):
    """Index of the first element equal to each element of sorted s."""
    return torch.searchsorted(s, s)


def _last_of_run(s):
    return torch.searchsorted(s, s, right=True) - 1


def _per_key(keys, size, *cols):
    """{(k,): row} over the keys present: cols are (values, reduce) with
    reduce "count", "sum", "amax" or "amin"."""
    cnt = torch.bincount(keys, minlength=size)
    out = []
    for vals, how in cols:
        if how == "count":
            out.append(torch.bincount(keys if vals is None else keys[vals], minlength=size))
        elif how == "sum":
            out.append(torch.zeros(size, dtype=vals.dtype, device=vals.device)
                       .index_add_(0, keys, vals))
        else:
            fill = float("-inf") if how == "amax" else float("inf")
            if not vals.is_floating_point():
                info = torch.iinfo(vals.dtype)
                fill = info.min if how == "amax" else info.max
            out.append(torch.full((size,), fill, dtype=vals.dtype, device=vals.device)
                       .scatter_reduce(0, keys, vals, how))
    cnt = cnt.cpu().numpy()
    host = [c.cpu().numpy() for c in out]
    return {(k,): tuple(c[k].item() for c in host) for k in range(size) if cnt[k]}


def expected_window(name, h, dev):
    """Each window cell's rows, computed apart from ops/window.py in plain
    torch on the card (numpy would take minutes over 10^8 rows): stable
    sorts of packed keys, run bounds by binary search, and direct sums
    and minima over the frame's rows."""
    col = {c: torch.from_numpy(h[c]).to(dev) for c in ("x10", "x100", "x1k", "x10m", "v")}
    n = col["v"].shape[0]
    i = torch.arange(n, device=dev)
    if name == "WIN_RUNNING":
        ks, order = torch.sort((col["x1k"].long() << 24) | col["x10m"].long(), stable=True)
        pf = _first_of_run(ks >> 24)
        cs = torch.cumsum(col["v"][order].double(), 0)
        base = torch.where(pf > 0, cs[(pf - 1).clamp(min=0)], 0.0)
        rs = cs[_last_of_run(ks)] - base  # RANGE peers: through the last peer
        g = col["x10"][order].long()
        return _per_key(g, 11, (None, "count"), (rs, "amax"), (i - pf + 1, "sum"))
    if name == "WIN_TOPN":
        desc = 0x7FFFFFFF - col["v"].view(torch.int32).long()  # v >= 0: bits in order
        ks, order = torch.sort((col["x1k"].long() << 32) | desc)
        r = _first_of_run(ks) - _first_of_run(ks >> 32) + 1
        sel = r <= 3
        rows = zip(col["x1k"][order][sel].tolist(), col["v"][order][sel].tolist(),
                   r[sel].tolist())
        return sorted(rows)
    if name == "WIN_FRAMES":
        ks, o1 = torch.sort((col["x100"].long() << 24) | col["x10m"].long(), stable=True)
        pf, pe = _first_of_run(ks >> 24), _last_of_run(ks >> 24)
        vd = col["v"][o1].double()
        s, cnt = vd.clone(), torch.ones(n, dtype=torch.int64, device=dev)
        for d in (1, 2, 3):  # ROWS BETWEEN 3 PRECEDING AND CURRENT ROW, directly
            ok = i - d >= pf
            s += torch.where(ok, vd[(i - d).clamp(min=0)], 0.0)
            cnt += ok
        vf = col["v"][o1]
        mn = vf.clone()
        for d in (-2, -1, 1, 2):  # ROWS BETWEEN 2 PRECEDING AND 2 FOLLOWING
            j = i + d
            ok = (j >= pf) & (j <= pe)
            mn = torch.where(ok, torch.minimum(mn, vf[j.clamp(0, n - 1)]), mn)
        g1 = col["x100"][o1].long()
        ks2, o2 = torch.sort((col["x10"].long() << 24) | col["x10m"].long(), stable=True)
        lag_ok = i - _first_of_run(ks2 >> 24) >= 2  # LAG(x10k, 2) within x10
        uniq = torch.unique(col["x1k"])
        dr = torch.searchsorted(uniq, col["x1k"]) + 1  # DENSE_RANK over all rows
        g = col["x100"].long()
        want = _per_key(g1, 101, (None, "count"), (s / cnt, "amax"), (mn, "amin"))
        lg = _per_key(col["x100"][o2].long(), 101, (lag_ok, "count"))
        drm = _per_key(g, 101, (dr, "amax"))
        return {k: w + lg[k] + drm[k] for k, w in want.items()}
    raise KeyError(name)


def expected_udf(name, h):
    """UDF_GROUP in numpy: HYPOT of the DOUBLE casts, per x100."""
    if name != "UDF_GROUP":
        raise KeyError(name)
    a = h["v"].astype(np.float64)
    b = h["x10k"].astype(np.float64)
    hyp = np.sqrt(a * a + b * b)
    cnt = np.bincount(h["x100"], minlength=101)
    s = np.bincount(h["x100"], weights=hyp, minlength=101)
    return {(k,): (int(cnt[k]), float(s[k])) for k in range(101) if cnt[k]}


def check_cell_rows(name, rows, want, n_keys, tols) -> int:
    """Raise unless rows equal want: {key: row} for grouped cells, a sorted
    list of rows for a multiset; integers and FLOAT values exact, DOUBLE
    rtol 1e-9 unless tols names a column."""
    if isinstance(want, list):
        got = sorted(tuple(r) for r in rows)
        if got != want:
            raise AssertionError(f"{name}: {len(got)} rows, expected {len(want)}, "
                                 f"or they differ")
        return len(got)
    if len(rows) != len(want):
        raise AssertionError(f"{name}: {len(rows)} rows, expected {len(want)}")
    for r in rows:
        w = want[tuple(r[:n_keys])]
        for j, (g, e) in enumerate(zip(r[n_keys:], w)):
            ok = np.isclose(g, e, **tols.get(j, F64_TOL)) if isinstance(e, float) \
                else g == e
            if not ok:
                raise AssertionError(f"{name}: {r} vs {w} (column {n_keys + j})")
    return len(rows)


def _window_cell(db, name, q, want, counters, spy):
    """One window or UDF cell on bench: the first run (checked against
    want), each window spec's egress mode and sort, five warm runs with
    their peak device bytes, the tier of each Compound, the cell's
    launches (against ROUTES), and a torch.profiler breakdown."""
    from heavydb_tpu_torch.tools.profile_queries import profile_query

    before = [c.launches for c in counters]
    del spy.runs[:]
    t0 = time.perf_counter()
    rows = db.sql(q).rows()
    first_ms = (time.perf_counter() - t0) * 1e3
    tiers = [r[0] for r in spy.runs]
    nrows = check_cell_rows(name, rows, want, WINDOW_KEYS.get(name, 0), WINDOW_TOLS[name])
    plans = [(r["mode"], r["sort"]) for r in db.executor.window_runs]
    if plans != WINDOW_PLANS[name]:
        raise AssertionError(f"{name}: window specs ran as {plans}, "
                             f"expected {WINDOW_PLANS[name]}")
    warm, reps, peak = warm_ms(db, q)
    delta = [c.launches - b for c, b in zip(counters, before)]
    check_route(name, delta)
    prof = profile_query(db, q)
    return dict(query=name, rows_out=nrows, first_with_decode_ms=first_ms, warm_ms=warm,
                warm_runs_ms=reps, window_specs=[dict(mode=m, sort=s) for m, s in plans],
                tiers=tiers, peak_device_bytes=peak,
                launches=dict(zip(KERNEL_NAMES, delta)), profile=prof)


def run_window(db, host, counters):
    """WINDOW_QUERIES on bench with the launch counters set to 0 before the
    first, against expected_window.  Returns the lines and each kernel's
    launches in the phase."""
    from heavydb_tpu_torch.tools.synthetic import WINDOW_QUERIES

    for c in counters:
        c.launches = 0  # the window path starts here
    out = []
    with _RunSpy() as spy:
        for name, q in WINDOW_QUERIES.items():
            t0 = time.perf_counter()
            want = expected_window(name, host, db.device)
            torch.cuda.empty_cache()
            expected_s = time.perf_counter() - t0
            line = _window_cell(db, name, q, want, counters, spy)
            line["expected_s"] = expected_s
            out.append(line)
    return out, [c.launches for c in counters]


def window_yardsticks(n: int = ROWS, parts: int = 1000) -> list:
    """The plain scans of ops/window.py alone at n rows in `parts`
    partitions: the running MIN / MAX with resets on its blocked running
    maximum form (FLOAT) and its doubling form (DOUBLE), the blocked
    running maximum beside one torch.cummax of the same int64 row, a
    segmented propagation, the running sum, and the window sort of a
    packed int64 key (CUDA events, median of 5)."""
    from heavydb_tpu_torch.ops import window as W

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 17)
    starts = torch.rand(n, device="cuda", generator=gen) < parts / n
    starts[0] = True
    v32 = torch.rand(n, device="cuda", generator=gen)
    v64 = v32.double()
    key = torch.randint(0, 1 << 35, (n,), device="cuda", generator=gen)
    out = []
    for name, fn in [
        ("running_max_blocked_f32", lambda: W._seg_running_op(v32, starts, torch.maximum)),
        ("running_max_doubling_f64", lambda: W._seg_running_op(v64, starts, torch.maximum)),
        ("cummax_blocked_int64", lambda: W._cummax(key)),
        ("torch_cummax_int64", lambda: torch.cummax(key, 0)),
        ("flag_index_forward", lambda: W._flag_index(starts)),
        ("flag_index_reverse", lambda: W._flag_index(starts, reverse=True)),
        ("running_sum_f64", lambda: W._seg_running_sum(v64, starts)),
        ("sort_packed_int64", lambda: torch.sort(key)),
    ]:
        out.append(dict(op=name, rows=n, partitions=int(starts.sum()), ms=timed(fn, 5)))
    return out


def run_udf(db, host, counters):
    """UDF_QUERIES on bench (HYPOT registered by register_udfs), measured
    as the window cells, against numpy."""
    from heavydb_tpu_torch.tools.synthetic import UDF_QUERIES, register_udfs

    register_udfs(db)
    for c in counters:
        c.launches = 0  # the udf path starts here
    out = []
    with _RunSpy() as spy:
        for name, q in UDF_QUERIES.items():
            out.append(_window_cell(db, name, q, expected_udf(name, host), counters, spy))
    return out, [c.launches for c in counters]


# small tables, the same rows on CUDA as on the CPU: every window kind,
# every frame form, IGNORE NULLS, NULL / NaN / -0.0 / subnormal keys, a
# string order key under a WHERE, both egress modes and both sorts, and
# windows over GROUP BY results on B1 and B2
WINDOW_SHAPE_TABLES = [
    "CREATE TABLE w (g TEXT, x INT, v DOUBLE)",
    "INSERT INTO w VALUES ('a', 1, 10.0), ('a', 2, 20.0), ('a', 3, 30.0), "
    "('b', 1, 5.0), ('b', 2, NULL), ('b', 2, 7.0), ('c', 9, 1.0)",
    "CREATE TABLE hz (k INT, t INT, f DOUBLE, v DOUBLE, r INT)",
    "INSERT INTO hz VALUES (1, 5, 0.0, 1.0, 0), (1, 5, -0.0, 2.0, 1), "
    "(1, 5, 5e-324, NULL, 2), (2, 1, 1.5, 4.0, 3), (2, 1, -1.5, 8.0, 4), "
    "(NULL, 2, NULL, 16.0, 5), (3, NULL, 0.0, 32.0, 6), (3, 7, -5e-324, NULL, 7), "
    "(3, 7, 2.0, 128.0, 8), (1, 5, -0.0, 256.0, 9), (2, NULL, 1.5, 512.0, 10), "
    "(NULL, 2, 0.0, 1024.0, 11), (3, 9, NULL, 2048.0, 12)",
]
WINDOW_SHAPE_QUERIES = [
    "SELECT g, x, ROW_NUMBER() OVER (PARTITION BY g ORDER BY x) rn FROM w ORDER BY g, x, rn",
    "SELECT g, x, RANK() OVER (PARTITION BY g ORDER BY x), DENSE_RANK() OVER (PARTITION BY g "
    "ORDER BY x) FROM w WHERE g = 'b' ORDER BY x",
    "SELECT g, x, LAG(v) OVER (PARTITION BY g ORDER BY x), LEAD(v) OVER (PARTITION BY g "
    "ORDER BY x) FROM w WHERE g = 'a' ORDER BY x",
    "SELECT x, LAG(x, 2, -1) OVER (ORDER BY x, v NULLS LAST) FROM w WHERE g = 'a' ORDER BY x",
    "SELECT g, x, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY x), LAST_VALUE(v) OVER "
    "(PARTITION BY g ORDER BY x), NTH_VALUE(v, 2) OVER (PARTITION BY g ORDER BY x) "
    "FROM w ORDER BY g, x, v",
    "SELECT g, SUM(v) OVER (PARTITION BY g), COUNT(*) OVER (PARTITION BY g), MIN(x) OVER "
    "(PARTITION BY g), MAX(v) OVER (PARTITION BY g), AVG(x) OVER (PARTITION BY g) "
    "FROM w ORDER BY g, x",
    "SELECT x, NTILE(2) OVER (ORDER BY x), PERCENT_RANK() OVER (ORDER BY x), CUME_DIST() "
    "OVER (ORDER BY x) FROM w ORDER BY x, g",
    "SELECT g, x, SUM(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST ROWS BETWEEN 1 "
    "PRECEDING AND 1 FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, MIN(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST ROWS BETWEEN 1 "
    "PRECEDING AND 2 FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, MAX(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST ROWS BETWEEN "
    "CURRENT ROW AND UNBOUNDED FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, COUNT(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST ROWS BETWEEN 1 "
    "FOLLOWING AND 2 FOLLOWING) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, SUM(x) OVER (PARTITION BY g ORDER BY x RANGE BETWEEN CURRENT ROW AND "
    "UNBOUNDED FOLLOWING), MAX(v) OVER (PARTITION BY g ORDER BY x RANGE BETWEEN CURRENT "
    "ROW AND CURRENT ROW) FROM w ORDER BY g, x, v NULLS FIRST",
    "SELECT g, x, FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY x, v NULLS FIRST ROWS "
    "BETWEEN 1 PRECEDING AND 1 FOLLOWING), LAST_VALUE(v) OVER (PARTITION BY g ORDER BY x, "
    "v NULLS FIRST ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM w "
    "ORDER BY g, x, v NULLS FIRST",
    "SELECT x, v - AVG(v) OVER (PARTITION BY g) delta FROM w WHERE g = 'a' ORDER BY x",
    "SELECT g, sv FROM (SELECT g, x, SUM(v) OVER (PARTITION BY g) sv FROM w WHERE x < 3) q "
    "WHERE sv > 10 ORDER BY g, x",
    "SELECT x, FIRST_VALUE(g) OVER (ORDER BY x, g) FROM w ORDER BY x, g LIMIT 2",
    "SELECT g, x, v, LEAD(x) OVER (PARTITION BY g ORDER BY x), SUM(x) OVER (ORDER BY v "
    "NULLS FIRST, x) FROM w",
    "SELECT r, ROW_NUMBER() OVER (ORDER BY t), ROW_NUMBER() OVER (PARTITION BY k ORDER BY "
    "f DESC) FROM hz ORDER BY r",
    "SELECT r, COUNT(*) OVER (PARTITION BY f), SUM(v) OVER (PARTITION BY f), RANK() OVER "
    "(ORDER BY f), DENSE_RANK() OVER (ORDER BY f DESC) FROM hz ORDER BY r",
    "SELECT r, COUNT(*) OVER (PARTITION BY SQRT(f - 1.0)), RANK() OVER (ORDER BY "
    "SQRT(f - 1.0)) FROM hz ORDER BY r",
    "SELECT r, SUM(v) OVER (PARTITION BY k ORDER BY f), RANK() OVER (PARTITION BY k "
    "ORDER BY f) FROM hz ORDER BY r",
    "SELECT r, ROW_NUMBER() OVER (ORDER BY t DESC NULLS FIRST), SUM(v) OVER (PARTITION BY k "
    "ORDER BY f NULLS LAST), LAG(r) OVER (ORDER BY f ASC NULLS FIRST) FROM hz ORDER BY r",
    "SELECT r, SUM(v) OVER (PARTITION BY k ORDER BY r ROWS BETWEEN 1 FOLLOWING AND 2 "
    "FOLLOWING), MIN(v) OVER (PARTITION BY k ORDER BY r ROWS BETWEEN 3 PRECEDING AND 2 "
    "PRECEDING), AVG(v) OVER (PARTITION BY k ORDER BY r ROWS BETWEEN 5 PRECEDING AND 5 "
    "FOLLOWING) FROM hz ORDER BY r",
    "SELECT r, LAG(v) IGNORE NULLS OVER (PARTITION BY k ORDER BY r), LEAD(v, 2, 0.5) IGNORE "
    "NULLS OVER (PARTITION BY k ORDER BY r), FIRST_VALUE(v) IGNORE NULLS OVER (PARTITION BY "
    "k ORDER BY r), LAST_VALUE(v) IGNORE NULLS OVER (PARTITION BY k ORDER BY r), "
    "NTH_VALUE(v, 2) IGNORE NULLS OVER (PARTITION BY k ORDER BY r) FROM hz ORDER BY r",
    "SELECT r, COUNT(*) OVER (PARTITION BY k), ROW_NUMBER() OVER (PARTITION BY f ORDER BY "
    "r DESC), COUNT(*) OVER (ORDER BY k NULLS LAST) FROM hz ORDER BY r",
    "SELECT s, ROW_NUMBER() OVER (PARTITION BY p ORDER BY s, rid) FROM ws WHERE o < 40 "
    "ORDER BY rid",
    "SELECT rid, SUM(v) OVER (PARTITION BY p ORDER BY o, rid ROWS BETWEEN 2 PRECEDING AND "
    "CURRENT ROW), MIN(v) OVER (PARTITION BY p ORDER BY f, rid ROWS BETWEEN 1 PRECEDING "
    "AND 1 FOLLOWING), MAX(v) OVER (ORDER BY o, rid RANGE BETWEEN UNBOUNDED PRECEDING AND "
    "CURRENT ROW) FROM ws ORDER BY rid",
    "SELECT rid, COUNT(v) OVER (PARTITION BY p ORDER BY o), LAST_VALUE(v) OVER (ORDER BY "
    "s, rid), RANK() OVER (PARTITION BY p ORDER BY f DESC) FROM ws WHERE p <> 3 ORDER BY rid",
    "SELECT k, s, RANK() OVER (ORDER BY s DESC) FROM (SELECT p k, SUM(v) s FROM ws "
    "GROUP BY p) q",
    "SELECT k, c, s, DENSE_RANK() OVER (ORDER BY c DESC, k) FROM (SELECT k1k k, COUNT(*) c, "
    "SUM(v) s FROM ws GROUP BY k1k) q",
]
WINDOW_SHAPE_PLANS = {("sorted", "packed"), ("sorted", "generic"), ("permsort", "packed"),
                      ("permsort", "generic")}


def run_window_shapes(counters, n: int = 20_000):
    """WINDOW_SHAPE_QUERIES on CUDA against the same port on the CPU (whose
    rows tests/test_torch_window*.py hold to the JAX package's): the same
    rows, all four (egress mode, sort) pairs taken on CUDA, and B1 and B2
    under the windows over GROUP BY results.  Returns the line and each
    kernel's launches in the phase."""
    rng = np.random.default_rng(SEED + 16)
    ws = {"p": rng.integers(0, 7, n).astype(np.int32),
          "o": rng.integers(0, 50, n).astype(np.int32),
          "v": np.where(rng.random(n) < 0.09, np.nan, np.round(rng.normal(0, 10, n), 2)),
          "f": np.round(rng.normal(0, 3, n), 1),
          "s": np.array([f"t{k}" for k in range(9)], object)[rng.integers(0, 9, n)],
          "k1k": rng.integers(0, 1000, n).astype(np.int32),
          "rid": np.arange(n, dtype=np.int32)}
    dbs = _twin_dbs()
    for db in dbs:
        for st in WINDOW_SHAPE_TABLES:
            db.sql(st)
        db.sql("CREATE TABLE ws (p INT, o INT, v DOUBLE, f DOUBLE, s TEXT, k1k INT, rid INT)")
        db.load_table("ws", ws)
    for c in counters:
        c.launches = 0  # the window_shapes path starts here
    rows_out, plans = [], set()
    for q in WINDOW_SHAPE_QUERIES:
        got, want = (db.sql(q).rows() for db in dbs)
        plans |= {(r["mode"], r["sort"]) for r in dbs[0].executor.window_runs}
        _same_on_both(q, got, want, False)
        rows_out.append(len(got))
    if plans != WINDOW_SHAPE_PLANS:
        raise AssertionError(f"window_shapes: specs ran as {plans}")
    launched = dict(zip(KERNEL_NAMES, [c.launches for c in counters]))
    if min(launched["lane_agg"], launched["radix_hist"]) < 1:
        raise AssertionError(f"window_shapes: B1 and B2 under the windows: {launched}")
    return dict(queries=len(WINDOW_SHAPE_QUERIES), rows=n, rows_out=rows_out,
                specs=sorted(plans)), [c.launches for c in counters]


# the table functions, on CUDA against the CPU: every built-in of
# api._register_system_tfs; the fits read a CURSOR over ~5 x 10^5 rows of
# bench (cut from ~10^6 for the script's time; the CPU twin holds those rows
# of bench in the same order)
UDF_CURSOR_X10M = 50_000
UDF_CURSOR = f"FROM bench WHERE x10m <= {UDF_CURSOR_X10M}"
UDF_SHAPE_QUERIES = [
    "SELECT * FROM TABLE(generate_series(1, 20, 3)) ORDER BY 1",
    "SELECT y, SUM(num_iterations), MAX(x) FROM TABLE(tf_mandelbrot(64, 48)) GROUP BY y",
    "SELECT coef_idx, coef FROM TABLE(linear_reg_fit(CURSOR(SELECT v, x10, x100 "
    f"{UDF_CURSOR}))) ORDER BY coef_idx",
    "SELECT COUNT(*), SUM(prediction) FROM TABLE(linear_reg_predict(CURSOR(SELECT x10m, "
    f"x10, x100 {UDF_CURSOR}), 0.5, 0.01, -0.002))",
    "SELECT cluster_id, COUNT(*), SUM(id) FROM TABLE(kmeans(CURSOR(SELECT x10m, x10, x100 "
    f"{UDF_CURSOR}), 4, 5)) GROUP BY cluster_id",
    "SELECT COUNT(*), SUM(pc1), SUM(pc2 * pc2) FROM TABLE(pca_project(CURSOR(SELECT x10m, "
    f"x10, x100, x1k {UDF_CURSOR}), 2))",
    "SELECT * FROM TABLE(tf_compute_dwell_times(CURSOR(SELECT x10, x100, x10m "
    f"{UDF_CURSOR} AND x1k = 7))) ORDER BY ts, entity_id, site_id",
    "SELECT * FROM TABLE(decision_tree_reg_fit('dtb', 6, 4, CURSOR(SELECT v, x10, x100 "
    f"{UDF_CURSOR})))",
    "SELECT * FROM TABLE(random_forest_reg_fit('rfb', 3, 5, CURSOR(SELECT v, x10, x100 "
    f"{UDF_CURSOR})))",
    "SELECT * FROM TABLE(gbt_reg_fit('gbb', 4, 3, 0.3, CURSOR(SELECT v, x10, x100 "
    f"{UDF_CURSOR})))",
    f"SELECT r2 FROM TABLE(r2_score('gbb', CURSOR(SELECT v, x10, x100 {UDF_CURSOR})))",
    "SELECT COUNT(*), SUM(prediction) FROM TABLE(ml_reg_predict('rfb', CURSOR(SELECT x10m, "
    f"x10, x100 {UDF_CURSOR})))",
    "SELECT model_name, kind FROM TABLE(ml_models()) ORDER BY model_name",
    "SELECT g.generate_series, COUNT(*), SUM(b.v) FROM TABLE(generate_series(1, 100)) g "
    f"JOIN bench b ON g.generate_series = b.x100 WHERE b.x10m <= {UDF_CURSOR_X10M} GROUP BY 1",
]


def run_udf_shapes(db, host, counters):
    """UDF_SHAPE_QUERIES on db (CUDA, bench at 10^8 rows) against the port
    on the CPU holding bench's rows that the cursors read: the same rows
    (the fits are the same numpy over the same cursor).  Returns the line
    and each kernel's launches in the phase."""
    import heavydb_tpu_torch as hdt

    keep = host["x10m"] <= UDF_CURSOR_X10M
    cpu = hdt.connect(device="cpu")
    cols = ("x10", "x100", "x1k", "x10m", "v")
    cpu.sql("CREATE TABLE bench (" + ", ".join(
        f"{c} {'FLOAT' if c == 'v' else 'INT'}" for c in cols) + ")")
    cpu.load_table("bench", {c: host[c][keep] for c in cols})
    for c in counters:
        c.launches = 0  # the udf_shapes path starts here
    rows_out, seconds = [], []
    for q in UDF_SHAPE_QUERIES:
        t0 = time.perf_counter()
        got = db.sql(q).rows()
        seconds.append(time.perf_counter() - t0)
        _same_on_both(q, got, cpu.sql(q).rows(), "SUM(b.v)" in q)
        rows_out.append(len(got))
    return dict(queries=len(UDF_SHAPE_QUERIES), cursor_rows=int(keep.sum()),
                rows_out=rows_out, cuda_seconds=seconds), [c.launches for c in counters]


# ---------------------------------------------------------------------------
# controls, upload and ddl phases (bench after the dml phase)
# ---------------------------------------------------------------------------

# the kernels EXPLAIN OPTIMIZED names -> their launch counters
PROGRAM_KERNELS = {"B1": "lane_agg", "B2": "radix_hist", "B3": "groupby_minmax",
                   "B5": "radix_partition", "B6": "radix_group"}
ADMISSION_QUERIES = ("Q1K_MINMAX", "PHS002")
# a row INSERTed into bench by the controls phase, in column order
INSERTED_ROW = {"x10": 1, "y10": 1, "x100": 1, "y100": 1, "x1k": 1, "x10k": 1,
                "x100k": 1, "x10m": 1, "x10k_s10k": 10_000, "x1m_s10k": 10_000, "v": 0.5}


def explained(db, name, q) -> dict:
    """EXPLAIN, EXPLAIN CALCITE and EXPLAIN OPTIMIZED of one query: each
    one's ms and lines, the program's tier and each aggregate's route; the
    kernels the program names must be those the e2e phase saw it launch."""
    import re

    line = dict(query=name)
    for kind in ("PLAN", "CALCITE", "OPTIMIZED"):
        t0 = time.perf_counter()
        text = [r[0] for r in db.sql(f"EXPLAIN {'' if kind == 'PLAN' else kind} {q}").rows()]
        line[f"{kind.lower()}_ms"] = (time.perf_counter() - t0) * 1e3
        line[f"{kind.lower()}_lines"] = len(text)
    program = "\n".join(text).split("--- compound program")[1].splitlines()
    line["tier"] = next(ln for ln in program if ln.startswith("group-by tier"))
    routes = [ln for ln in program if ln.startswith(("aggregate ", "presence "))]
    named = {PROGRAM_KERNELS[b] for ln in routes for b in re.findall(r"\bB[1-6]\b", ln)}
    if named != ROUTES[name]:
        raise AssertionError(f"{name}: EXPLAIN OPTIMIZED names {sorted(named)}, the e2e "
                             f"route launched {sorted(ROUTES[name])}")
    line["routes"] = routes
    return line


def timer_split(db, name, q, reps: int = 5) -> dict:
    """The query's plan / execute / fetch scopes under enable_debug_timer,
    median of reps runs after one: on CUDA `execute` ends at the Compound's
    control read, which waits for the device; `fetch` only wraps the device
    result, whose columns reach the host when read (here, after the
    timer)."""
    runs = []
    db.config.enable_debug_timer = True
    try:
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            rs = db.sql(q)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            rs.rows()
            scopes = {c["name"]: c["ms"] for c in db.last_query_timings["children"]}
            runs.append(dict(scopes, query=db.last_query_timings["ms"], wall=wall))
    finally:
        db.config.enable_debug_timer = False
    return {f"{k}_ms": statistics.median(r[k] for r in runs[1:])
            for k in ("plan", "execute", "fetch", "query", "wall")} | dict(query=name)


def recycled(db, host, name) -> dict:
    """The keep_result hint: the first run a miss, the second a hit that
    returns the same ResultSet, its rows numpy's."""
    q = QUERIES[name].replace("SELECT", "SELECT /*+ keep_result */", 1)
    ex = db.executor
    h2d0 = ex.h2d_bytes
    t0 = time.perf_counter()
    rs = db.sql(q)
    rs.rows()
    miss_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hit = db.sql(q)
    hit.rows()
    hit_ms = (time.perf_counter() - t0) * 1e3
    if hit is not rs:
        raise AssertionError(f"{name}: keep_result did not recycle the result")
    return dict(query=name, miss_ms=miss_ms, miss_h2d_bytes=ex.h2d_bytes - h2d0,
                hit_ms=hit_ms, rows_out=check_result(name, hit, host),
                cached_results=len(db._result_cache))


def stopped_in_the_waves(db, host) -> dict:
    """Q10M_AGGS in 3 fragment waves (a 1 MB stream threshold), stopped by
    an interrupt raised once its first wave has run, then by a
    query_time_limit(1) hint: each raises in the wave that follows; the
    device bytes come back to where they were, but for scan-cache entries
    the run kept; the next run equals numpy."""
    import gc

    from heavydb_tpu_torch.errors import QueryInterrupted, WatchdogException

    ex = db.executor
    base_cfg = ex.config
    q = QUERIES["Q10M_AGGS"]
    out = {}
    ex.config = base_cfg.clone(stream_threshold_bytes=FORCED_THRESHOLD)
    try:
        for how, hook, sql, exc in (
                ("interrupt", lambda: ex.waves_run > waves0, q, QueryInterrupted),
                ("deadline", None, q.replace("SELECT", "SELECT /*+ query_time_limit(1) */", 1),
                 WatchdogException)):
            gc.collect()
            torch.cuda.synchronize()
            mem0, cache0 = torch.cuda.memory_allocated(), ex.scan_cache.total_bytes
            waves0 = ex.waves_run
            ex.interrupt_check = hook
            raised = None
            t0 = time.perf_counter()
            try:
                db.sql(sql)
            except exc as e:
                raised = str(e)
            raise_ms = (time.perf_counter() - t0) * 1e3
            ex.interrupt_check = None
            waves = ex.waves_run - waves0
            if raised is None or waves > 1:
                raise AssertionError(f"{how}: raised {raised!r} after {waves} waves")
            gc.collect()
            torch.cuda.synchronize()
            left = torch.cuda.memory_allocated() - mem0
            kept = ex.scan_cache.total_bytes - cache0
            if left > kept:
                raise AssertionError(f"{how}: {left} B left on the card, the scan cache "
                                     f"kept {kept} B")
            out[how] = dict(raised=raised, ms_to_raise=raise_ms, waves_run=waves,
                            device_bytes_left=left, scan_cache_bytes_kept=kept)
    finally:
        ex.config = base_cfg
        ex.interrupt_check = None
    rs = db.sql(q)
    out["next_run_rows"] = check_result("Q10M_AGGS", rs, host)
    return out


def admitted(db, host, n_threads: int = 8, per_thread: int = 2) -> list:
    """8 threads run Q1K_MINMAX and PHS002 (two each, alternating) on the
    one Database at max_concurrent_queries 1 and 4, then at 4 with
    max_exec_bytes below two queries' estimate: each result equals numpy;
    the wall time, each query's p50 / p99 ms (to its decoded rows) and the
    manager's info(), whose running count is 0 at the end."""
    import threading

    from heavydb_tpu_torch.plan.optimizer import optimize
    from heavydb_tpu_torch.sql.parser import parse

    ex = db.executor
    rm = ex.resource_mgr
    ests = [rm.estimate_scan_bytes(p) + rm.estimate_output_bytes(p, ex)
            for p in (optimize(db._plan_select(parse(QUERIES[n]))) for n in ADMISSION_QUERIES)]
    limit = int(1.5 * max(ests))
    if 2 * min(ests) <= limit:
        raise AssertionError(f"estimates {ests}: two queries would fit {limit} B")
    want = {n: expected(n, host) for n in ADMISSION_QUERIES}
    out = []
    for label, conc, max_bytes in (("max_concurrent_queries=1", 1, 0),
                                   ("max_concurrent_queries=4", 4, 0),
                                   (f"max_exec_bytes={limit}", 4, limit)):
        db.sql(f"ALTER SYSTEM SET max_concurrent_queries = {conc}")
        db.sql(f"ALTER SYSTEM SET max_exec_bytes = {max_bytes}")
        rm.peak_concurrent = 0
        admitted0 = rm.total_admitted
        results, errors = [], []
        barrier = threading.Barrier(n_threads)

        def worker(i):
            try:
                barrier.wait(timeout=60)
                for j in range(per_thread):
                    name = ADMISSION_QUERIES[(i + j) % 2]
                    t0 = time.perf_counter()
                    rs = db.sql(QUERIES[name])
                    rs.rows()
                    results.append((name, (time.perf_counter() - t0) * 1e3, rs))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = (time.perf_counter() - t0) * 1e3
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"{label}: {errors or 'a thread did not finish'}")
        for name, _, rs in results:
            check_rows(name, rs.rows(), want[name], 1, ())
        info = rm.info()
        if info["running"] or info["queued"] or len(results) != n_threads * per_thread:
            raise AssertionError(f"{label}: {len(results)} results, {info}")
        if info["total_admitted"] - admitted0 != len(results):
            raise AssertionError(f"{label}: admitted {info['total_admitted'] - admitted0}")
        if (conc == 1 or max_bytes) and info["peak_concurrent"] != 1:
            raise AssertionError(f"{label}: {info['peak_concurrent']} ran together")
        lat = {n: [ms for m, ms, _ in results if m == n] for n in ADMISSION_QUERIES}
        out.append(dict(setting=label, estimates=ests, queries=len(results), wall_ms=wall,
                        p50_ms={n: float(np.percentile(v, 50)) for n, v in lat.items()},
                        p99_ms={n: float(np.percentile(v, 99)) for n, v in lat.items()},
                        info=info))
    db.sql("ALTER SYSTEM SET max_concurrent_queries = 4")
    db.sql("ALTER SYSTEM SET max_exec_bytes = 0")
    return out


def admission_cost(db) -> list:
    """Each e2e cell's warm ms with the resource manager on (the default)
    and off, in turns (on, off, off, on; 5 runs each), and the host time of
    its estimate alone (median of 20)."""
    from heavydb_tpu_torch.plan.optimizer import optimize
    from heavydb_tpu_torch.sql.parser import parse

    ex = db.executor
    rm = ex.resource_mgr
    out = []
    try:
        for name, q in QUERIES.items():
            runs = {"on": [], "off": []}
            for mode in ("on", "off", "off", "on"):
                ex.resource_mgr = rm if mode == "on" else None
                runs[mode].append(warm_ms(db, q)[0])
            ex.resource_mgr = rm
            plan = optimize(db._plan_select(parse(q)))
            est = []
            for _ in range(20):
                t0 = time.perf_counter()
                rm.estimate_scan_bytes(plan) + rm.estimate_output_bytes(plan, ex)
                est.append((time.perf_counter() - t0) * 1e3)
            on, off = statistics.mean(runs["on"]), statistics.mean(runs["off"])
            out.append(dict(query=name, on_ms=runs["on"], off_ms=runs["off"],
                            on_minus_off_ms=on - off, estimate_ms=statistics.median(est)))
    finally:
        ex.resource_mgr = rm
    return out


def run_controls(db, host, counters):
    """The per-query controls on bench, with the launch counters set to 0
    first: EXPLAIN of the eleven e2e queries, Q1K_MINMAX's debug-timer
    scopes, the result recycler, Q10M_AGGS stopped in its waves, admission
    under 8 threads, the e2e cells' warm ms with admission on and off; then
    an INSERT into bench, after which the recycled query misses (numpy's
    model gets the row too).  Returns the lines and each kernel's launches."""
    for c in counters:
        c.launches = 0  # the controls path starts here
    lines = [dict(part="explain", **explained(db, n, q)) for n, q in QUERIES.items()]
    lines.append(dict(part="debug_timer", **timer_split(db, "Q1K_MINMAX",
                                                        QUERIES["Q1K_MINMAX"])))
    lines.append(dict(part="keep_result", **recycled(db, host, "Q1K_MINMAX")))
    lines.append(dict(part="stopped", **stopped_in_the_waves(db, host)))
    lines += [dict(part="admission", **a) for a in admitted(db, host)]
    lines += [dict(part="admission_cost", **a) for a in admission_cost(db)]
    cols = list(INSERTED_ROW)
    t0 = time.perf_counter()
    db.sql(f"INSERT INTO bench ({', '.join(cols)}) VALUES "
           f"({', '.join(repr(INSERTED_ROW[c]) for c in cols)})")
    insert_ms = (time.perf_counter() - t0) * 1e3
    for c in cols:
        host[c] = np.append(host[c], np.array([INSERTED_ROW[c]], host[c].dtype))
    after = recycled(db, host, "Q1K_MINMAX")
    if not after["miss_h2d_bytes"]:
        raise AssertionError("keep_result served a result across an INSERT")
    lines.append(dict(part="keep_result_after_insert", insert_ms=insert_ms, **after))
    total = [c.launches for c in counters]
    launched = dict(zip(KERNEL_NAMES, total))
    if min(launched[k] for k in set().union(*(ROUTES[n] for n in QUERIES))) < 1:
        raise AssertionError(f"a kernel of the e2e routes never launched: {launched}")
    return lines, total


BENCH_COLUMNS = tuple(INSERTED_ROW)
UPLOAD_QUERY = QUERIES["Q100_MINMAX"].replace("FROM bench", "FROM up")
UPLOAD_PATHS = (("pageable", 1 << 62, False), ("staged_wide", None, True),
                ("staged_narrow", None, False))


def run_upload(db, host, counters):
    """bench's host columns into a new table through load_table, its first
    query (Q100_MINMAX's shape: x10, x100, x10k, v) taken three ways: one
    pageable copy a column, staged with no narrowing (the chunk-stat range
    withheld), staged with narrowing; for each its ms, the bytes that
    crossed, the upload alone timed again (GB/s of the wire and of the
    columns), and the device columns, bit-equal across the three; the table
    is dropped after each.  On the last, prestage_table's seconds for every
    column and the first query after it (nothing uploads).  Then a BIGINT
    of int16-range values with 1 % NULL at 10^8 rows: 2 bytes a row on the
    wire, its rows numpy's."""
    from heavydb_tpu_torch.exec import executor as EX
    from heavydb_tpu_torch.plan import rel_alg as R

    ex = db.executor
    cfg = db.config
    staging, min0 = cfg.eager_device_staging, ex._STAGE_MIN_BYTES
    narrow = EX._narrow_dtype
    schema = ", ".join(f"{cd.name} {cd.type}" for cd in db.catalog.get_table("bench").columns)
    cfg.eager_device_staging = False
    for c in counters:
        c.launches = 0  # the upload path starts here
    want = expected("Q100_MINMAX", host)
    used = ("x10", "x100", "x10k", "v")
    lines, ref_cols = [], None
    try:
        for path, min_bytes, wide in UPLOAD_PATHS:
            db.sql(f"CREATE TABLE up ({schema})")
            t0 = time.perf_counter()
            db.load_table("up", {c: host[c] for c in BENCH_COLUMNS})
            load_s = time.perf_counter() - t0
            t = db.catalog.get_table("up")
            # the wide path: the narrowing rule stubbed to find no type
            EX._narrow_dtype = (lambda dt, rng: None) if wide else narrow
            ex._STAGE_MIN_BYTES = min0 if min_bytes is None else min_bytes
            torch.cuda.synchronize()
            h2d0 = ex.h2d_bytes
            t0 = time.perf_counter()
            rows = db.sql(UPLOAD_QUERY).rows()
            first_ms = (time.perf_counter() - t0) * 1e3
            wire = ex.h2d_bytes - h2d0
            nrows = check_rows(path, rows, want, 1, F32_RESULT_COLS["Q100_MINMAX"])
            warm = warm_ms(db, UPLOAD_QUERY)[0]
            ids = {cd.col_id: cd.name for cd in t.columns if cd.name in used}
            keys = [k for k, _ in ex.scan_cache.items() if k[0] == t.table_id]
            cols = {ids[k[2]]: ex.scan_cache.get(k) for k in keys}
            for k in keys:
                ex.scan_cache.pop(k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex._exec_scan(R.Scan(t), {i for i, cd in enumerate(t.columns) if cd.name in used})
            torch.cuda.synchronize()
            upload_ms = (time.perf_counter() - t0) * 1e3
            logical = sum(host[c].nbytes for c in used)
            if ref_cols is None:
                ref_cols = cols
            for c, a in cols.items():
                b = ref_cols[c]
                if a.dtype != b.dtype or not torch.equal(
                        a.view(torch.int32) if a.is_floating_point() else a,
                        b.view(torch.int32) if b.is_floating_point() else b):
                    raise AssertionError(f"{path}: column {c} differs from the pageable copy")
            line = dict(path=path, load_table_s=load_s, first_query_ms=first_ms,
                        first_query_h2d_bytes=wire, warm_ms=warm, rows_out=nrows,
                        upload_ms=upload_ms, wire_gb_per_s=wire / upload_ms / 1e6,
                        column_gb_per_s=logical / upload_ms / 1e6, column_bytes=logical,
                        device_dtypes={c: str(a.dtype) for c, a in cols.items()})
            if path == "staged_narrow":
                for k in [k for k, _ in ex.scan_cache.items() if k[0] == t.table_id]:
                    ex.scan_cache.pop(k)
                torch.cuda.synchronize()
                h2d0 = ex.h2d_bytes
                t0 = time.perf_counter()
                ex.prestage_table(t)
                line["prestage_s"] = time.perf_counter() - t0
                line["prestage_h2d_bytes"] = ex.h2d_bytes - h2d0
                h2d0 = ex.h2d_bytes
                t0 = time.perf_counter()
                rows = db.sql(UPLOAD_QUERY).rows()
                line["first_query_after_prestage_ms"] = (time.perf_counter() - t0) * 1e3
                check_rows(path, rows, want, 1, F32_RESULT_COLS["Q100_MINMAX"])
                if ex.h2d_bytes != h2d0:
                    raise AssertionError("the first query after prestage_table uploaded")
            del cols
            db.sql("DROP TABLE up")
            lines.append(line)
        del ref_cols
        EX._narrow_dtype = narrow
        ex._STAGE_MIN_BYTES = min0
        rng = np.random.default_rng(SEED + 7)
        k = rng.integers(-30_000, 30_001, ROWS)
        k[rng.random(ROWS) < 0.01] = np.iinfo(np.int64).min
        db.sql("CREATE TABLE bnull (k BIGINT)")
        db.load_table("bnull", {"k": k})
        ok = k != np.iinfo(np.int64).min
        h2d0 = ex.h2d_bytes
        t0 = time.perf_counter()
        rows = db.sql("SELECT COUNT(*), COUNT(k), MIN(k), MAX(k), SUM(k) FROM bnull").rows()
        first_ms = (time.perf_counter() - t0) * 1e3
        wire = ex.h2d_bytes - h2d0
        kv = k[ok]
        numpy_rows = [(ROWS, int(ok.sum()), int(kv.min()), int(kv.max()), int(kv.sum()))]
        if rows != numpy_rows or wire != ROWS * 2:
            raise AssertionError(f"bnull: {rows} vs {numpy_rows}; {wire} B on the wire")
        nulls = db.sql("SELECT COUNT(*) FROM bnull WHERE k IS NULL").rows()
        if nulls != [(int((~ok).sum()),)]:
            raise AssertionError(f"bnull: {nulls} NULLs")
        lines.append(dict(path="bigint_int16_range_1pct_null", rows=ROWS, first_query_ms=first_ms,
                          first_query_h2d_bytes=wire, column_bytes=k.nbytes,
                          warm_ms=warm_ms(db, "SELECT COUNT(*), COUNT(k), MIN(k), MAX(k), "
                                          "SUM(k) FROM bnull")[0]))
        db.sql("DROP TABLE bnull")
    finally:
        cfg.eager_device_staging = staging
        ex._STAGE_MIN_BYTES = min0
        EX._narrow_dtype = narrow
    total = [c.launches for c in counters]
    if dict(zip(KERNEL_NAMES, total))["lane_agg"] < 1:
        raise AssertionError("B1 did not launch in the upload phase (Q100_MINMAX's shape)")
    return lines, total


def run_ddl(db, host, counters):
    """Column DDL, views and a row-level policy on the 10^8-row bench after
    the dml and controls phases, with the launch counters set to 0 first
    (the expected rows come from `host`, which those phases kept): ADD
    COLUMN with a DEFAULT and a query on it (the new column alone uploads,
    one byte a row), DROP COLUMN, RENAME COLUMN and RENAME TABLE and back
    (nothing uploads), a view of Q1K_MINMAX's shape, and Q1K_MINMAX by a
    user whose policy keeps x10 IN (1, 2, 3), beside the superuser's warm
    ms; each statement's ms and bytes; everything added is dropped."""
    ex = db.executor
    for c in counters:
        c.launches = 0  # the ddl path starts here
    lines = []
    n = db.table_rows("bench")

    def statement(sql):
        torch.cuda.synchronize()
        h2d0 = ex.h2d_bytes
        t0 = time.perf_counter()
        db.sql(sql)
        torch.cuda.synchronize()
        lines.append(dict(statement=sql, ms=(time.perf_counter() - t0) * 1e3,
                          h2d_bytes=ex.h2d_bytes - h2d0))

    def query(label, q, want, f32=(), user=None, uploads=0):
        h2d0 = ex.h2d_bytes
        t0 = time.perf_counter()
        rows = db.sql(q, user=user).rows()
        first_ms = (time.perf_counter() - t0) * 1e3
        uploaded = ex.h2d_bytes - h2d0
        nrows = check_rows(label, rows, want, 1, f32)
        if uploads is not None and uploaded != uploads:
            raise AssertionError(f"{label}: uploaded {uploaded} B, expected {uploads}")
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            db.sql(q, user=user)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        lines.append(dict(query=label, sql=q, user=user, rows_out=nrows, first_ms=first_ms,
                          first_h2d_bytes=uploaded, warm_ms=statistics.median(reps)))

    q1k = QUERIES["Q1K_MINMAX"]
    want_1k = expected("Q1K_MINMAX", host)
    k = host["x1k"].astype(np.int64)
    cnt = np.bincount(k, minlength=1001)
    statement("ALTER TABLE bench ADD COLUMN z INT DEFAULT 7")
    query("ADD_COLUMN", "SELECT x1k, COUNT(*), SUM(z) FROM bench GROUP BY x1k",
          {(i,): (int(cnt[i]), 7 * int(cnt[i])) for i in range(1001) if cnt[i]}, uploads=n)
    statement("ALTER TABLE bench DROP COLUMN z")
    query("DROP_COLUMN", q1k, want_1k)
    statement("ALTER TABLE bench RENAME COLUMN x1k TO k1k")
    query("RENAME_COLUMN", q1k.replace("x1k", "k1k"), want_1k)
    statement("ALTER TABLE bench RENAME COLUMN k1k TO x1k")
    statement("ALTER TABLE bench RENAME TO bench_r")
    query("RENAME_TABLE", q1k.replace("bench", "bench_r"), want_1k)
    statement("ALTER TABLE bench_r RENAME TO bench")
    statement("CREATE VIEW v1k AS SELECT x1k, MIN(x10k) AS mn, MAX(v) AS mx, AVG(v) AS av "
              "FROM bench GROUP BY x1k")
    query("VIEW", "SELECT * FROM v1k", want_1k)
    statement("DROP VIEW v1k")
    statement("CREATE USER analyst (password='pw')")
    statement("GRANT SELECT ON bench TO analyst")
    statement("CREATE POLICY ON COLUMN bench.x10 TO analyst VALUES (1, 2, 3)")
    keep = np.isin(host["x10"], (1, 2, 3))
    # x10 uploads here unless an earlier phase left it resident
    query("POLICY", q1k, expected("Q1K_MINMAX", {c: host[c][keep] for c in ("x1k", "x10k", "v")}),
          user="analyst", uploads=None)
    query("SUPERUSER", q1k, want_1k)
    statement("DROP POLICY ON COLUMN bench.x10 FROM analyst")
    statement("DROP USER analyst")
    details = db.sql("SHOW TABLE DETAILS bench").rows()
    lines.append(dict(statement="SHOW TABLE DETAILS bench", row=list(details[0])))
    if db.catalog.get_table("bench").column_by_name("z") is not None or db._views:
        raise AssertionError("the ddl phase left a column or a view behind")
    total = [c.launches for c in counters]
    launched = dict(zip(KERNEL_NAMES, total))
    if launched["radix_hist"] < 1 or launched["groupby_minmax"] < 1:
        raise AssertionError(f"B2 / B3 did not launch in the ddl phase: {launched}")
    return lines, total


# the storage and import phases: everything they write goes under the
# repo's git-ignored build/, and is removed at their end
STORE_ROOT = "build/chip_store"
STORE_MIN_FREE = 24 << 30  # a 10^8-row store (~3.2 GB), the server's tables, exports, dumps
COPY_ROWS = 5_000_000  # the copy, fsi and DUMP tables, cut from 10^8 for the script's time


def _store_root(name: str) -> str:
    """A fresh directory under STORE_ROOT, after a check of free disk."""
    import os
    import shutil

    path = os.path.abspath(os.path.join(STORE_ROOT, name))
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    free = shutil.disk_usage(path).free
    if free < STORE_MIN_FREE:
        raise AssertionError(f"{path}: {free} bytes free on its disk, the storage phases "
                             f"need {STORE_MIN_FREE}")
    return path


def _files_bytes(d: str) -> dict:
    import os

    return {f: os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)}


def _bench_schema(db, name: str = "bench") -> str:
    return ", ".join(f"{cd.name} {cd.type}" for cd in db.catalog.get_table(name).columns)


def _store_layout(db, name: str) -> dict:
    """Bytes on disk of a table's committed epoch, per column and
    encoding, from its manifest (`encode_chunk`'s choice per chunk)."""
    import os

    t = db.catalog.get_table(name)
    store = db._table_stores[t.table_id]
    m = store._load_manifest(store.committed_epoch())
    by_col = {}
    for key, ref in m["chunks"].items():
        f, c = (int(x) for x in key.split(":"))
        size = os.path.getsize(store._chunk_path(f, c, ref["epoch"]))
        col = by_col.setdefault(t.column_by_id(c).name, {})
        col[ref["enc"]] = col.get(ref["enc"], 0) + size
    return dict(epoch=m["epoch"], chunks=len(m["chunks"]), by_column=by_col,
                bytes=sum(sum(v.values()) for v in by_col.values()))


def _statement_on_disk(db, name: str, sql: str) -> dict:
    """One statement on a database on disk: its ms (the checkpoint after
    it included) and the chunk files it wrote."""
    t = db.catalog.get_table(name)
    d = db._table_stores[t.table_id].dir
    before = _files_bytes(d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db.sql(sql)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    new = {f: b for f, b in _files_bytes(d).items() if f not in before and f.startswith("f")}
    return dict(statement=sql, ms=ms, chunk_files_written=len(new),
                bytes_written=sum(new.values()), epoch=db.get_table_epoch(name))


def _resident_of(db, table_id, gen=None) -> int:
    """Device bytes of a table's scan-cache columns (of one generation)."""
    return sum(a.numel() * a.element_size() for k, a in db.executor.scan_cache.items()
               if k[0] == table_id and (gen is None or k[1] == gen))


def _e2e_cells(db, host, counters, names, table="bench") -> list:
    """QUERIES (on `table`) against numpy over `host`: first and warm ms,
    bytes uploaded by the first run, each on its e2e route."""
    out = []
    for name in names:
        q = QUERIES[name].replace("FROM bench", f"FROM {table}")
        before = [c.launches for c in counters]
        h2d0 = db.executor.h2d_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = db.sql(q)
        decode(rs)
        first_ms = (time.perf_counter() - t0) * 1e3
        h2d = db.executor.h2d_bytes - h2d0
        nrows = check_result(name, rs, host)
        warm = warm_ms(db, q)[0]
        delta = [c.launches - b for c, b in zip(counters, before)]
        check_route(name, delta)
        out.append(dict(query=name, table=table, rows_out=nrows, first_ms=first_ms,
                        first_h2d_bytes=h2d, warm_ms=warm,
                        launches=dict(zip(KERNEL_NAMES, delta))))
    return out


def run_persist(db, host, counters):
    """A database on disk on CUDA (under build/): bench's host columns by
    load_table at 10^8 rows, a checkpoint (seconds, bytes per column and
    encoding), the database released and reopened (seconds), the eleven
    e2e queries on the reopened table (first run uploads, each on its e2e
    route, against numpy), an UPDATE and an INSERT of one row (ms with the
    checkpoint, the chunk bytes rewritten), a set_table_epoch rollback
    (rows against numpy of the old values, the rolled-back generation's
    device bytes freed), DUMP and RESTORE of a COPY_ROWS-row table and a query on
    it; then bench made on the device (load_table_device) at COPY_ROWS rows
    in a second database on disk and its first checkpoint, each chunk's
    host copy through one device-to-host copy.  Launches counted from 0.
    Returns the lines, the launches and the first database's directory (bench back at its first epoch, equal to `host`),
    which the server phase serves and the caller removes (with its parent,
    STORE_ROOT/persist)."""
    import gc
    import os
    import shutil

    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.tools.synthetic import FRAGMENT_ROWS

    for c in counters:
        c.launches = 0  # the persist path starts here
    root = _store_root("persist")
    lines = []
    n = int(host["x10"].shape[0])
    schema = _bench_schema(db)
    try:
        path = os.path.join(root, "db")
        pdb = hdt.connect(path)
        pdb.sql(f"CREATE TABLE bench ({schema}) WITH (fragment_size={FRAGMENT_ROWS})")
        t0 = time.perf_counter()
        pdb.load_table("bench", {c: host[c] for c in BENCH_COLUMNS})
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pdb.checkpoint()
        ckpt_s = time.perf_counter() - t0
        layout = _store_layout(pdb, "bench")
        lines.append(dict(part="checkpoint", rows=n, load_table_s=load_s, checkpoint_s=ckpt_s,
                          disk_gb_per_s=layout["bytes"] / ckpt_s / 1e9, **layout))
        epoch0 = pdb.get_table_epoch("bench")
        del pdb
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pdb = hdt.connect(path)
        reopen_s = time.perf_counter() - t0
        if pdb.table_rows("bench") != n or pdb.get_table_epoch("bench") != epoch0:
            raise AssertionError("persist: the reopened bench differs in rows or epoch")
        lines.append(dict(part="reopen", reopen_s=reopen_s, rows=n, epoch=epoch0,
                          device_bytes_after_reopen=torch.cuda.memory_allocated() - base))
        for line in _e2e_cells(pdb, host, counters, QUERIES):
            lines.append(dict(part="reopened_e2e", **line))
        t = pdb.catalog.get_table("bench")
        r = n // 8  # a row of the first fragment
        old = int(host["x100"][r])
        lines.append(dict(part="update_one_row", **_statement_on_disk(
            pdb, "bench", f"UPDATE bench SET x100 = 0 WHERE rowid = {r}")))
        cols = list(INSERTED_ROW)
        lines.append(dict(part="insert_one_row", **_statement_on_disk(
            pdb, "bench", f"INSERT INTO bench ({', '.join(cols)}) VALUES "
                          f"({', '.join(repr(INSERTED_ROW[c]) for c in cols)})")))
        s100 = int(host["x100"].sum(dtype=np.int64))
        # x100, x1k and x10k of the new generation resident before the rollback
        got = pdb.sql("SELECT COUNT(*), SUM(x100), MIN(x1k), MAX(x10k) FROM bench").rows()
        if got != [(n + 1, s100 - old + INSERTED_ROW["x100"], 1, int(host["x10k"].max()))]:
            raise AssertionError(f"persist: after UPDATE and INSERT {got}")
        old_gen = t.generation
        resident = _resident_of(pdb, t.table_id, old_gen)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pdb.set_table_epoch("bench", epoch0)
        torch.cuda.synchronize()
        rollback_ms = (time.perf_counter() - t0) * 1e3
        mem1 = torch.cuda.memory_allocated()
        if _resident_of(pdb, t.table_id) or mem0 - mem1 < resident:
            raise AssertionError(f"persist: after the rollback {mem0 - mem1} device bytes freed, "
                                 f"{resident} were resident")
        line = dict(part="rollback", ms=rollback_ms, to_epoch=epoch0, resident_bytes=resident,
                    device_bytes_freed=mem0 - mem1)
        cells = _e2e_cells(pdb, host, counters, ("Q1K_MINMAX", "Q100_MINMAX"))
        if pdb.sql("SELECT COUNT(*), SUM(x100) FROM bench").rows() != [(n, s100)]:
            raise AssertionError("persist: the rollback did not give the old rows")
        lines.append(dict(line, queries=cells))
        # DUMP / RESTORE of a COPY_ROWS-row table, RESTORE over it
        sub = {c: host[c][:COPY_ROWS] for c in BENCH_COLUMNS}
        pdb.sql(f"CREATE TABLE b7 ({schema})")
        pdb.load_table("b7", sub)
        pdb.checkpoint()
        dump = os.path.join(root, "b7.tgz")
        t0 = time.perf_counter()
        pdb.sql(f"DUMP TABLE b7 TO '{dump}'")
        dump_s = time.perf_counter() - t0
        _e2e_cells(pdb, sub, counters, ("Q1K_MINMAX",), table="b7")
        old_id = pdb.catalog.get_table("b7").table_id
        mem0 = torch.cuda.memory_allocated()
        resident = _resident_of(pdb, old_id)
        t0 = time.perf_counter()
        pdb.sql(f"RESTORE TABLE b7 FROM '{dump}'")
        restore_s = time.perf_counter() - t0
        mem1 = torch.cuda.memory_allocated()
        if _resident_of(pdb, old_id) or mem0 - mem1 < resident:
            raise AssertionError("persist: RESTORE left device columns of the dropped table")
        lines.append(dict(part="dump_restore", rows=COPY_ROWS, dump_s=dump_s,
                          dump_bytes=os.path.getsize(dump), restore_s=restore_s,
                          device_bytes_freed=mem0 - mem1, resident_bytes=resident,
                          queries=_e2e_cells(pdb, sub, counters, ("Q1K_MINMAX",), table="b7")))
        del pdb, sub, t
        gc.collect()
        torch.cuda.empty_cache()
        # bench made on the device (load_table_device) in a second database,
        # cut to COPY_ROWS rows in three fragments as bench's 10^8 rows are:
        # its first checkpoint copies each chunk to the host once
        ddb = hdt.connect(os.path.join(root, "ddb"))
        data = load_bench(ddb, COPY_ROWS, SEED + 1, fragment_rows=-(-COPY_ROWS // 3))
        dev_bytes = sum(a.numel() * a.element_size() for a in data.values())
        del data
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddb.checkpoint()
        ckpt_s = time.perf_counter() - t0
        t = ddb.catalog.get_table("bench")
        if not all(getattr(ch, "_np", 0) is not None for f in t.fragments
                   for ch in f.chunks.values()):
            raise AssertionError("persist: a device chunk was not copied to the host")
        lines.append(dict(part="checkpoint_device_loaded", rows=COPY_ROWS,
                          fragments=len(t.fragments), checkpoint_s=ckpt_s,
                          d2h_bytes=dev_bytes, **_store_layout(ddb, "bench")))
        del ddb, t
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    total = [c.launches for c in counters]
    launched = dict(zip(KERNEL_NAMES, total))
    if min(launched[k] for k in set().union(*(ROUTES[q] for q in QUERIES))) < 1:
        raise AssertionError(f"a kernel of the e2e routes never launched in persist: {launched}")
    return lines, total, path


# the e2e queries the server phase sends over TCP as they are; BH004 and
# Q10M_AGGS (10^7 groups: gigabytes of JSON) go wrapped, so that their
# result is one row while their inner Compound keeps the radix tier
SERVER_QUERIES = ("NGA03", "PHM001", "Q100_MINMAX", "PHS002", "Q1K_MINMAX", "Q10K", "PHS003",
                  "BH002", "BH003")
SERVER_WRAPPED = {
    "BH004": "SELECT COUNT(*), SUM(c) FROM (SELECT x10m, COUNT(*) AS c FROM bench "
             "GROUP BY x10m) t",
    "Q10M_AGGS": "SELECT COUNT(*), SUM(c), SUM(s), MIN(mn), MAX(mx) FROM (SELECT x10m, "
                 "COUNT(*) AS c, SUM(x100) AS s, SUM(v) AS sv, MIN(x10k) AS mn, MAX(v) AS mx "
                 "FROM bench WHERE x10 > 3 GROUP BY x10m) t",
}
SERVER_LOAD_ROWS = 1_000_000
SERVER_SESSIONS = 4
SERVER_ALLOC_SLACK = 2 << 20  # the caching allocator's rounding of a block
SERVER_INTERRUPT_AFTER_MS = 200  # the victim's run time when it is interrupted
SERVER_POLL_S = 0.005  # between get_queries_info polls, which hold the server's GIL


class _Remote:
    """A server's reply in the shape check_result reads: column(i),
    column_raw(i) and col_count over the decoded JSON columns."""

    def __init__(self, res):
        self.res = res
        self.col_count = len(res.columns)
        self.row_count = res.row_count

    def column(self, i):
        return self.res.columns[i]

    def column_raw(self, i):
        return np.asarray(self.res.columns[i])


def expected_wrapped(name, h):
    """numpy answer of a SERVER_WRAPPED query: one row."""
    _, cols = expected_arrays(name, h)
    if name == "BH004":
        return [(cols[0].shape[0], int(cols[0].sum()))]
    cnt, s, _, mn, mx = cols
    return [(cnt.shape[0], int(cnt.sum()), int(s.sum()), int(mn.min()), float(mx.max()))]


def _served(srv):
    """Serve a TCP or HTTP server on a thread; its address."""
    import threading

    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return srv.server_address


def _hang_up(*conns) -> None:
    """Close client connections with their read files: a Connection's
    close() leaves its socket open while the file it reads replies from
    lives, and the server's handler thread with it."""
    for c in conns:
        c.close()
        c.rfile.close()


def _stop_serving(srv, engine, n_threads: int) -> None:
    """Shut a server down and wait until its threads (serve_forever, the
    handlers, the refresh scheduler) have ended: n_threads were alive
    before it started."""
    import threading

    srv.shutdown()
    srv.server_close()
    engine.db.refresh_scheduler.stop()
    deadline = time.perf_counter() + 60
    while threading.active_count() > n_threads:
        if time.perf_counter() > deadline:
            raise AssertionError(f"server: threads still alive {threading.enumerate()}")
        time.sleep(0.01)


def _device_bytes_settled() -> int:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _wire_bytes(payload) -> int:
    from heavydb_tpu_torch.server import protocol as P

    return len(P.dumps({"id": 1, "result": payload}))


def _over_tcp(engine, conn, name, q, host, counters, spy):
    """One query through Connection.sql: the first run (rows against numpy,
    each Compound's tier), warm runs over TCP beside the same query's warm
    runs in process on the server's Database (decoded to Python values,
    the rows encode_result sends), bytes of JSON; the launches of the TCP
    runs and those of the in-process runs, each held to its e2e route on
    its own."""
    from heavydb_tpu_torch.server import protocol as P

    reps = 3 if name in ARRAY_CHECKED else 5
    before = [c.launches for c in counters]
    del spy.runs[:]
    t0 = time.perf_counter()
    res = conn.sql(q)
    first_ms = (time.perf_counter() - t0) * 1e3
    tiers = [r[0] for r in spy.runs]
    if name in SERVER_WRAPPED:
        got = [tuple(r) for r in res.rows()]
        want = expected_wrapped(name, host)
        if got != want:
            raise AssertionError(f"server {name}: {got}, numpy {want}")
        if tiers.count("radix") != 1:
            raise AssertionError(f"server {name}: the inner Compound left the radix tier: "
                                 f"{tiers}")
        rows_out = len(got)
    else:
        rows_out = check_result(name, _Remote(res), host)
    payload = dict(fields=res.fields, types=res.types, columns=res.columns,
                   row_count=res.row_count, execution_time_ms=res.execution_time_ms)
    tcp = []
    for _ in range(reps):
        t0 = time.perf_counter()
        conn.sql(q)
        tcp.append((time.perf_counter() - t0) * 1e3)
    delta = [c.launches - b for c, b in zip(counters, before)]
    check_route(name, delta)  # the TCP runs alone, first and warm
    before = [c.launches for c in counters]
    local = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rs = engine.db.sql(q)
        [rs.column(i) for i in range(rs.col_count)]
        local.append((time.perf_counter() - t0) * 1e3)
    local_delta = [c.launches - b for c, b in zip(counters, before)]
    check_route(name, local_delta)
    t0 = time.perf_counter()
    P.dumps({"id": 1, "result": P.encode_result(rs)})
    encode_ms = (time.perf_counter() - t0) * 1e3
    warm, in_process = statistics.median(tcp), statistics.median(local)
    return dict(query=name, sql=q, rows_out=rows_out, first_ms=first_ms, warm_ms=warm,
                warm_runs_ms=tcp, in_process_warm_ms=in_process, wire_ms=warm - in_process,
                encode_ms=encode_ms, json_bytes=_wire_bytes(payload),
                tiers=tiers, launches=dict(zip(KERNEL_NAMES, delta)),
                in_process_launches=dict(zip(KERNEL_NAMES, local_delta)))


def _sessions_at_once(engine, address, host, n=SERVER_SESSIONS, per=4) -> list:
    """n sessions x per queries of ADMIT_8T's pair (Q1K_MINMAX, PHS002 in
    turns) at once, over TCP and then as n threads on the server's Database
    in process: rows against numpy, wall, p50 / p99 ms a query."""
    import threading

    from heavydb_tpu_torch.client.client import Connection

    want = {q: expected(q, host) for q in ADMISSION_QUERIES}
    out = []
    for how in ("tcp", "in_process"):
        conns = [Connection(*address) for _ in range(n)] if how == "tcp" else [None] * n
        results, errors = [], []
        barrier = threading.Barrier(n)

        def worker(i):
            try:
                barrier.wait(timeout=60)
                for j in range(per):
                    name = ADMISSION_QUERIES[(i + j) % 2]
                    t0 = time.perf_counter()
                    if how == "tcp":
                        rows = [tuple(r) for r in conns[i].sql(QUERIES[name]).rows()]
                    else:
                        rows = engine.db.sql(QUERIES[name]).rows()
                    results.append((name, (time.perf_counter() - t0) * 1e3, rows))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = (time.perf_counter() - t0) * 1e3
        if how == "tcp":
            _hang_up(*conns)
        if errors or len(results) != n * per:
            raise AssertionError(f"server sessions ({how}): {errors or len(results)}")
        for name, _, rows in results:
            check_rows(name, rows, want[name], 1, ())
        lat = {q: [ms for m, ms, _ in results if m == q] for q in ADMISSION_QUERIES}
        out.append(dict(part="sessions", how=how, sessions=n, queries=len(results),
                        wall_ms=wall,
                        p50_ms={q: float(np.percentile(v, 50)) for q, v in lat.items()},
                        p99_ms={q: float(np.percentile(v, 99)) for q, v in lat.items()}))
    return out


def _writes(engine, address, host) -> list:
    """load_table_binary_columnar of SERVER_LOAD_ROWS rows of three columns
    (seconds, bytes on the wire, the rows read back against numpy); then an
    INSERT of one row into a small table from one session while another
    session's batch reads bench: the INSERT returns while the reader runs
    (table-level locks)."""
    import threading

    from heavydb_tpu_torch.client.client import Connection
    from heavydb_tpu_torch.server import protocol as P

    n = SERVER_LOAD_ROWS
    cols = {"a": host["x1k"][:n], "b": host["x10m"][:n], "c": host["v"][:n]}
    lines = []
    c = Connection(*address)
    try:
        c.sql("CREATE TABLE wload (a INT, b INT, c FLOAT)")
        wire = len(P.dumps({"id": 1, "method": "load_table_binary_columnar", "params": {
            "session": c.session, "table": "wload",
            "columns": {k: P.encode_array(np.asarray(v)) for k, v in cols.items()}}}))
        t0 = time.perf_counter()
        loaded = c.load_table("wload", cols)
        load_s = time.perf_counter() - t0
        got = [tuple(r) for r in c.sql("SELECT COUNT(*), SUM(a), MIN(b), MAX(c) "
                                       "FROM wload").rows()]
        want = [(n, int(cols["a"].sum(dtype=np.int64)), int(cols["b"].min()),
                 float(cols["c"].max()))]
        if loaded != n or got != want:
            raise AssertionError(f"server load: {loaded} rows, {got}, numpy {want}")
        raw = sum(int(v.nbytes) for v in cols.values())
        lines.append(dict(part="load_table_binary_columnar", rows=n, seconds=load_s,
                          raw_bytes=raw, wire_bytes=wire, wire_over_raw=wire / raw))
        c.sql("CREATE TABLE wtiny (x INT)")
        reader_q = ";\n".join([QUERIES["BH003"]] * 4 + [QUERIES["NGA03"]])
        done = {}

        def read():
            r = Connection(*address)
            try:
                t0 = time.perf_counter()
                done["rows"] = r.sql(reader_q).rows()
                done["ms"] = (time.perf_counter() - t0) * 1e3
                done["at"] = time.perf_counter()
            finally:
                _hang_up(r)

        t = threading.Thread(target=read)
        t.start()
        deadline = time.perf_counter() + 120
        while not any(i["query"] == reader_q[:200] for i in c.get_queries_info()):
            if time.perf_counter() > deadline:
                raise AssertionError("server writes: the reader never ran")
            time.sleep(SERVER_POLL_S)
        t0 = time.perf_counter()
        c.sql("INSERT INTO wtiny VALUES (1)")
        insert_end = time.perf_counter()
        t.join(timeout=600)
        if "at" not in done or [tuple(r) for r in done["rows"]] != [expected("NGA03", host)[()]]:
            raise AssertionError(f"server writes: the reader gave {done.get('rows')}")
        if not insert_end < done["at"]:
            raise AssertionError("server writes: the INSERT waited for the reader of bench")
        if tuple(c.sql("SELECT COUNT(*), SUM(x) FROM wtiny").rows()[0]) != (1, 1):
            raise AssertionError("server writes: the INSERT is not read back")
        lines.append(dict(part="insert_beside_reader", insert_ms=(insert_end - t0) * 1e3,
                          reader_ms=done["ms"],
                          reader_left_ms=(done["at"] - insert_end) * 1e3))
        c.sql("DROP TABLE wload")
        c.sql("DROP TABLE wtiny")
    finally:
        _hang_up(c)
    return lines


def _over_http(engine, host) -> dict:
    """PHS002 through serve_http on the same engine: rows against numpy."""
    import json
    import types
    import urllib.request

    from heavydb_tpu_torch.server.http_server import serve_http

    hs = serve_http(port=0, core=engine)
    h, port = _served(hs)
    base = f"http://{h}:{port}"
    try:
        def post(path, payload):
            req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read())

        _, out = post("/", {"method": "connect", "params": {}, "id": 1})
        t0 = time.perf_counter()
        code, res = post("/sql", {"session": out["result"], "query": QUERIES["PHS002"]})
        ms = (time.perf_counter() - t0) * 1e3
        rows = check_result("PHS002", _Remote(types.SimpleNamespace(
            columns=res["columns"], row_count=res["row_count"])), host)
        return dict(part="http", query="PHS002", status=code, rows_out=rows, ms=ms)
    finally:
        hs.shutdown()
        hs.server_close()


def _interrupted(path, host, counters) -> dict:
    """A second server on the same directory, started with the stream
    phase's 1 MB threshold (FORCED_THRESHOLD): one session's wrapped
    Q10M_AGGS (its inner Compound in fragment waves) is interrupted once it
    has run SERVER_INTERRUPT_AFTER_MS, while another session runs
    Q1K_MINMAX in turns (its waves too).  The victim raises
    QueryInterrupted; the survivor's rows equal numpy; the device bytes
    after both are back, but for the scan-cache columns the runs kept; the
    server's shutdown frees the rest."""
    import threading

    from heavydb_tpu_torch.client.client import Connection, ServerError
    from heavydb_tpu_torch.config import Config
    from heavydb_tpu_torch.server.server import serve

    base = _device_bytes_settled()
    n_threads = threading.active_count()
    srv = serve(port=0, data_path=path, config=Config(stream_threshold_bytes=FORCED_THRESHOLD))
    engine = srv.engine
    address = _served(srv)
    ex = engine.db.executor
    want = expected("Q1K_MINMAX", host)
    try:
        mem0, cache0 = _device_bytes_settled(), ex.scan_cache.total_bytes
        victim, survivor, admin = (Connection(*address) for _ in range(3))
        outcome, survived, stop = {}, [], threading.Event()

        def victim_run():
            t0 = time.perf_counter()
            try:
                victim.sql(SERVER_WRAPPED["Q10M_AGGS"])
                outcome["raised"] = None
            except ServerError as e:
                outcome["raised"] = (e.type, str(e))
            outcome["at"] = time.perf_counter()
            outcome["ms"] = (outcome["at"] - t0) * 1e3

        def survivor_run():
            try:
                while not stop.is_set() or len(survived) < 2:
                    t0 = time.perf_counter()
                    rows = [tuple(r) for r in survivor.sql(QUERIES["Q1K_MINMAX"]).rows()]
                    survived.append((time.perf_counter() - t0) * 1e3)
                    # its AVG(v) adds FLOAT partials of the waves
                    check_rows("Q1K_MINMAX", rows, want, 1, STREAM_F32_COLS["Q1K_MINMAX"])
            except Exception as e:  # noqa: BLE001 - reported below
                outcome["survivor_error"] = repr(e)

        ts = [threading.Thread(target=survivor_run), threading.Thread(target=victim_run)]
        for t in ts:
            t.start()
        deadline = time.perf_counter() + 300
        sid = victim.session[:8]
        while True:
            live = [i for i in admin.get_queries_info() if i["session"] == sid]
            if live and live[0]["elapsed_ms"] >= SERVER_INTERRUPT_AFTER_MS:
                break
            if "at" in outcome or time.perf_counter() > deadline:
                raise AssertionError(f"server interrupt: the victim ended first: {outcome}")
            time.sleep(SERVER_POLL_S)
        t_int = time.perf_counter()
        admin.call("interrupt", session=victim.session)
        ts[1].join(timeout=600)
        stop.set()
        ts[0].join(timeout=600)
        _hang_up(victim, survivor, admin)
        if outcome.get("raised", (None,))[0] != "QueryInterrupted" \
                or "survivor_error" in outcome:
            raise AssertionError(f"server interrupt: {outcome}")
        left = _device_bytes_settled() - mem0
        kept = ex.scan_cache.total_bytes - cache0
        if left > kept + SERVER_ALLOC_SLACK:
            raise AssertionError(f"server interrupt: {left} B left on the card, the scan "
                                 f"cache kept {kept} B")
        line = dict(part="interrupt", victim=SERVER_WRAPPED["Q10M_AGGS"],
                    raised=outcome["raised"], elapsed_at_interrupt_ms=live[0]["elapsed_ms"],
                    ms_to_raise=(outcome["at"] - t_int) * 1e3, victim_ms=outcome["ms"],
                    survivor_queries=len(survived), survivor_ms=survived,
                    device_bytes_left=left, scan_cache_bytes_kept=kept)
    finally:
        _stop_serving(srv, engine, n_threads)
    del srv, engine, ex
    line["device_bytes_after_shutdown"] = _device_bytes_settled() - base
    if line["device_bytes_after_shutdown"] > SERVER_ALLOC_SLACK:
        raise AssertionError(f"server interrupt: {line['device_bytes_after_shutdown']} B "
                             "left after the second server's shutdown")
    return line


def run_server(db, host, counters, path):
    """The port's server on CUDA over the database on disk that the
    persist phase wrote (bench at its first epoch, equal to `host`),
    launches counted from 0: serve(port=0, data_path=path) in process
    (start-up seconds: the reopen and the kernel gate), the e2e queries
    through Connection.sql against numpy on their e2e routes (first and warm
    ms beside the in-process warm ms, bytes of JSON), BH004 and Q10M_AGGS
    wrapped (their inner Compound on the radix tier), sql_execute_df of
    Q1K_MINMAX against sql, four sessions at once, a columnar load and an
    INSERT beside a reader, one query over HTTP; the device bytes back to
    their level before the phase after the shutdown; then the interrupt on
    a second server (_interrupted).  Returns the lines and the launches."""
    from heavydb_tpu_torch.client.client import Connection
    from heavydb_tpu_torch.server.server import serve

    import threading

    for c in counters:
        c.launches = 0  # the server path starts here
    base = _device_bytes_settled()
    n_threads = threading.active_count()
    t0 = time.perf_counter()
    srv = serve(port=0, data_path=path)
    start_s = time.perf_counter() - t0
    engine = srv.engine
    address = _served(srv)
    n = engine.db.table_rows("bench")
    if n != host["x10"].shape[0]:
        raise AssertionError(f"server: {n} rows of bench, numpy has {host['x10'].shape[0]}")
    lines = [dict(part="start", start_s=start_s, rows=n, device=str(engine.db.device),
                  device_bytes_after_start=torch.cuda.memory_allocated() - base)]
    try:
        c = Connection(*address)
        with _RunSpy() as spy:
            for name in SERVER_QUERIES:
                lines.append(dict(part="query", **_over_tcp(engine, c, name, QUERIES[name],
                                                            host, counters, spy)))
            for name, q in SERVER_WRAPPED.items():
                lines.append(dict(part="wrapped", **_over_tcp(engine, c, name, q, host,
                                                              counters, spy)))
            q = QUERIES["Q1K_MINMAX"]
            tbl = c.sql_df(q)
            arrow, sql = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                tbl = c.sql_df(q)
                arrow.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                c.sql(q)
                sql.append((time.perf_counter() - t0) * 1e3)
            check_rows("Q1K_MINMAX", list(zip(*(col.to_pylist() for col in tbl.columns))),
                       expected("Q1K_MINMAX", host), 1, ())
            lines.append(dict(part="sql_execute_df", query="Q1K_MINMAX", rows_out=tbl.num_rows,
                              arrow_ms=statistics.median(arrow), sql_ms=statistics.median(sql)))
        _hang_up(c)
        lines += _sessions_at_once(engine, address, host)
        lines += _writes(engine, address, host)
        lines.append(_over_http(engine, host))
    finally:
        _stop_serving(srv, engine, n_threads)
    del srv, engine
    left = _device_bytes_settled() - base
    if left > SERVER_ALLOC_SLACK:
        raise AssertionError(f"server: {left} device bytes left after the shutdown")
    lines.append(dict(part="shutdown", device_bytes_left=left))
    lines.append(_interrupted(path, host, counters))
    total = [c.launches for c in counters]
    launched = dict(zip(KERNEL_NAMES, total))
    if min(launched[k] for k in set().union(*(ROUTES[q] for q in QUERIES))) < 1:
        raise AssertionError(f"a kernel of the e2e routes never launched in server: {launched}")
    return lines, total


def run_copy(db, host, counters):
    """COPY on the CUDA database of the earlier phases, launches counted from
    0: COPY_ROWS of bench's rows (cut from 10^8 for the script's time)
    loaded as b7, COPY TO a CSV and to parquet, COPY FROM the CSV through
    the native parser and through pandas (no_native) and from the parquet,
    each table's rows/s and Q1K_MINMAX's shape on it against numpy (first
    and warm ms, B2 + B3); then a COPY of the CSV into the 10^8-row bench
    (its host ms: the last fragment's chunks concatenated, a new one made).
    Returns the lines, the launches, and the files for the fsi phase."""
    import os

    for c in counters:
        c.launches = 0  # the copy path starts here
    root = _store_root("copy")
    schema = _bench_schema(db)
    cols = ", ".join(BENCH_COLUMNS)
    sub = {c: host[c][:COPY_ROWS] for c in BENCH_COLUMNS}
    db.sql(f"CREATE TABLE b7 ({schema})")
    db.load_table("b7", sub)
    lines = []
    files = {"csv": os.path.join(root, "b7.csv"), "parquet": os.path.join(root, "b7.parquet")}
    for kind, f in files.items():
        t0 = time.perf_counter()
        db.sql(f"COPY (SELECT {cols} FROM b7) TO '{f}'")
        s = time.perf_counter() - t0
        lines.append(dict(part=f"copy_to_{kind}", rows=COPY_ROWS, seconds=s,
                          rows_per_s=COPY_ROWS / s, file_bytes=os.path.getsize(f)))
    db.sql("DROP TABLE b7")
    for name, f, opts in (("native", files["csv"], ""),
                          ("pandas", files["csv"], " WITH (no_native='true')"),
                          ("parquet", files["parquet"], "")):
        db.sql(f"CREATE TABLE c_{name} ({schema})")
        t0 = time.perf_counter()
        db.sql(f"COPY c_{name} FROM '{f}'{opts}")
        s = time.perf_counter() - t0
        if db.table_rows(f"c_{name}") != COPY_ROWS:
            raise AssertionError(f"copy: c_{name} holds {db.table_rows(f'c_{name}')} rows")
        (cell,) = _e2e_cells(db, sub, counters, ("Q1K_MINMAX",), table=f"c_{name}")
        lines.append(dict(part=f"copy_from_{name}", rows=COPY_ROWS, seconds=s,
                          rows_per_s=COPY_ROWS / s, query=cell))
        db.sql(f"DROP TABLE c_{name}")
    n = db.table_rows("bench")
    frags = len(db.catalog.get_table("bench").fragments)
    t0 = time.perf_counter()
    db.sql(f"COPY bench FROM '{files['csv']}'")
    append_ms = (time.perf_counter() - t0) * 1e3
    got = db.sql("SELECT COUNT(*), SUM(x100) FROM bench").rows()
    want = [(n + COPY_ROWS, int(host["x100"].sum(dtype=np.int64))
             + int(sub["x100"].sum(dtype=np.int64)))]
    if got != want:
        raise AssertionError(f"copy: bench after the append {got}, numpy {want}")
    lines.append(dict(part="copy_append_to_bench", rows_before=n, rows_appended=COPY_ROWS,
                      host_ms=append_ms, fragments_before=frags,
                      fragments_after=len(db.catalog.get_table("bench").fragments)))
    total = [c.launches for c in counters]
    launched = dict(zip(KERNEL_NAMES, total))
    if launched["radix_hist"] < 1 or launched["groupby_minmax"] < 1:
        raise AssertionError(f"B2 / B3 did not launch in the copy phase: {launched}")
    return lines, total, dict(files, root=root, sub=sub)


def _cut_csv(path: str, rows: int) -> None:
    """Keep a CSV's header and its first `rows` rows."""
    with open(path, "rb") as f:
        data = f.read()
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == ord("\n"))
    with open(path, "wb") as f:
        f.write(data[:int(nl[rows]) + 1])


def run_fsi(db, counters, files):
    """Foreign tables on the CUDA database over the copy phase's CSV and
    parquet files, launches counted from 0: each one's first query (the
    lazy read, the upload) and warm query, Q1K_MINMAX's shape against numpy;
    then the CSV cut to half its rows and REFRESH FOREIGN TABLES: the new
    rows against numpy, and no device column of the old generation left
    (its bytes freed).  The copy phase's files are removed at the end."""
    import shutil

    for c in counters:
        c.launches = 0  # the fsi path starts here
    sub = files["sub"]
    schema = _bench_schema(db)
    lines = []
    try:
        for name, server, f in (("fcsv", "default_local_delimited", files["csv"]),
                                ("fpq", "default_local_parquet", files["parquet"])):
            t0 = time.perf_counter()
            db.sql(f"CREATE FOREIGN TABLE {name} ({schema}) SERVER {server} "
                   f"WITH (file_path='{f}')")
            create_ms = (time.perf_counter() - t0) * 1e3
            (cell,) = _e2e_cells(db, sub, counters, ("Q1K_MINMAX",), table=name)
            lines.append(dict(part=f"foreign_{name}", rows=COPY_ROWS, create_ms=create_ms,
                              query=cell))
        half = COPY_ROWS // 2
        t0 = time.perf_counter()
        _cut_csv(files["csv"], half)
        cut_s = time.perf_counter() - t0
        t = db.catalog.get_table("fcsv")
        old_gen = t.generation
        resident = _resident_of(db, t.table_id, old_gen)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        db.sql("REFRESH FOREIGN TABLES fcsv")
        refresh_ms = (time.perf_counter() - t0) * 1e3
        mem1 = torch.cuda.memory_allocated()
        if _resident_of(db, t.table_id, old_gen) or mem0 - mem1 < resident:
            raise AssertionError(f"fsi: after REFRESH {mem0 - mem1} device bytes freed, "
                                 f"{resident} were resident")
        (cell,) = _e2e_cells(db, {c: a[:half] for c, a in sub.items()}, counters,
                             ("Q1K_MINMAX",), table="fcsv")
        lines.append(dict(part="refresh_fcsv", rows=half, file_cut_s=cut_s,
                          refresh_ms=refresh_ms, resident_bytes=resident,
                          device_bytes_freed=mem0 - mem1, query=cell))
        db.sql("DROP TABLE fcsv")
        db.sql("DROP TABLE fpq")
    finally:
        shutil.rmtree(files["root"], ignore_errors=True)
    total = [c.launches for c in counters]
    launched = dict(zip(KERNEL_NAMES, total))
    if launched["radix_hist"] < 1 or launched["groupby_minmax"] < 1:
        raise AssertionError(f"B2 / B3 did not launch in the fsi phase: {launched}")
    return lines, total


def _io_shape_files(root: str, rng) -> dict:
    """The io_shapes phase's files: GeoJSON points and polygons, an ESRI
    ASCII grid, XYZ points and a GeoTIFF."""
    import os

    from PIL import Image, TiffImagePlugin

    n = 20_000
    xs, ys = rng.uniform(-74.05, -73.75, n), rng.uniform(40.6, 40.9, n)
    feats = [{"type": "Feature", "geometry": {"type": "Point", "coordinates": [x, y]},
              "properties": {"k": int(k), "v": float(v)}}
             for x, y, k, v in zip(xs.tolist(), ys.tolist(), rng.integers(0, 100, n).tolist(),
                                   rng.random(n).tolist())]
    polys = []
    for i in range(300):
        x0, y0, w = float(rng.uniform(0, 100)), float(rng.uniform(0, 100)), float(rng.uniform(1, 5))
        ring = [[x0, y0], [x0 + w, y0], [x0 + w, y0 + w], [x0, y0 + w], [x0, y0]]
        polys.append({"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [ring]},
                      "properties": {"tag": f"z{i % 37}"}})
    files = {"points": os.path.join(root, "pts.geojson"),
             "polygons": os.path.join(root, "polys.geojson"),
             "asc": os.path.join(root, "grid.asc"), "xyz": os.path.join(root, "pts.xyz"),
             "tif": os.path.join(root, "grid.tif")}
    for key, fs in (("points", feats), ("polygons", polys)):
        with open(files[key], "w") as f:
            json.dump({"type": "FeatureCollection", "features": fs}, f)
    grid = rng.integers(0, 1000, (150, 200)).astype(np.float64)
    grid[rng.random(grid.shape) < 0.02] = -9999
    with open(files["asc"], "w") as f:
        f.write("ncols 200\nnrows 150\nxllcorner -74.0\nyllcorner 40.5\ncellsize 0.001\n"
                "NODATA_value -9999\n")
        for row in grid.astype(np.int64):
            f.write(" ".join(map(str, row.tolist())) + "\n")
    with open(files["xyz"], "w") as f:
        for x, y, z in zip(rng.uniform(0, 10, 5000), rng.uniform(0, 10, 5000),
                           rng.integers(0, 500, 5000)):
            f.write(f"{x:.4f} {y:.4f} {z}\n")
    im = Image.fromarray(rng.integers(0, 1000, (80, 100)).astype(np.int32))
    ifd = TiffImagePlugin.ImageFileDirectory_v2()
    ifd[33550], ifd.tagtype[33550] = (0.01, 0.01, 0.0), 12
    ifd[33922], ifd.tagtype[33922] = (0.0, 0.0, 0.0, 5.0, 50.0, 0.0), 12
    im.save(files["tif"], tiffinfo=ifd)
    return files


IO_SHAPE_QUERIES = [
    ("gpts", "SELECT k, COUNT(*), SUM(v), MIN(ST_X(geom)), MAX(ST_Y(geom)) FROM gpts GROUP BY k"),
    ("gpts", "SELECT COUNT(*) FROM gpts WHERE ST_DISTANCE(geom, 'POINT (-73.9 40.75)') < 0.05"),
    ("gpolys", "SELECT tag, COUNT(*), SUM(ST_AREA(geom)) FROM gpolys GROUP BY tag"),
    ("rast", "SELECT COUNT(*), COUNT(band_1_1), SUM(band_1_1), MIN(raster_lon), "
             "MAX(raster_lat) FROM rast"),
    ("rast", "SELECT CAST(band_1_1 AS INT) / 10 AS b, COUNT(*) FROM rast "
             "WHERE band_1_1 IS NOT NULL GROUP BY b"),
    ("xyz", "SELECT CAST(raster_lon AS INT), COUNT(*), SUM(band_1_1) FROM xyz GROUP BY 1"),
    ("tif", "SELECT band_1_I, COUNT(*), MIN(raster_lon) FROM tif GROUP BY band_1_I"),
    ("sti", "SELECT a % 50, COUNT(*), SUM(v), MAX(s) FROM sti GROUP BY 1"),
]


def run_io_shapes(counters):
    """GeoJSON points and polygons, an ESRI ASCII grid, XYZ points and a
    GeoTIFF, each COPY'd into a CUDA database and into the same port on the
    CPU, and a stream importer of several batches into both: the same rows
    on CUDA as on the CPU over IO_SHAPE_QUERIES, with B1 and B2 launched by
    their GROUP BYs.  Launches counted from 0."""
    import shutil

    for c in counters:
        c.launches = 0  # the io_shapes path starts here
    root = _store_root("io")
    rng = np.random.default_rng(SEED + 16)
    lines = {}
    try:
        files = _io_shape_files(root, rng)
        stream_rows = [(int(a), float(v), f"s{int(a) % 7}") for a, v in
                       zip(rng.integers(0, 10_000, 30_000), rng.random(30_000))]
        dbs = _twin_dbs()
        for db in dbs:
            t0 = time.perf_counter()
            db.sql(f"COPY gpts FROM '{files['points']}'")
            db.sql(f"COPY gpolys FROM '{files['polygons']}' WITH (source_type='geo_file')")
            db.sql(f"COPY rast FROM '{files['asc']}' WITH (source_type='raster_file')")
            db.sql(f"COPY xyz FROM '{files['xyz']}' WITH (source_type='raster_file')")
            db.sql(f"COPY tif FROM '{files['tif']}' WITH (source_type='raster_file')")
            db.sql("CREATE TABLE sti (a INT, v DOUBLE, s TEXT)")
            imp = db.stream_importer("sti", batch_size=5000)
            h2d0 = db.executor.h2d_bytes
            imp.push_rows(stream_rows)
            st = imp.close()
            lines[db.device.type] = dict(import_s=time.perf_counter() - t0,
                                         stream_batches=st.batches,
                                         stream_rows=st.rows_loaded,
                                         stream_h2d_bytes=db.executor.h2d_bytes - h2d0)
        launched = {}
        for table, q in IO_SHAPE_QUERIES:
            before = [c.launches for c in counters]
            got, want = (d.sql(q).rows() for d in dbs)
            _same_on_both(q, got, want, False)
            for k, d in zip(KERNEL_NAMES, [c.launches - b for c, b in zip(counters, before)]):
                launched[k] = launched.get(k, 0) + d
        if launched["lane_agg"] < 1 or launched["radix_hist"] < 1:
            raise AssertionError(f"io_shapes: B1 / B2 did not launch: {launched}")
        rows = {t: dbs[0].table_rows(t) for t in ("gpts", "gpolys", "rast", "xyz", "tif", "sti")}
        # batches into a table past eager_staging_min_rows: each batch goes
        # through load_table, which uploads the whole table again
        big = dbs[0]
        base = big.config.eager_staging_min_rows
        big.sql("CREATE TABLE stb (a INT, v DOUBLE)")
        big.load_table("stb", {"a": rng.integers(0, 1000, base).astype(np.int32),
                               "v": rng.random(base)})
        imp = big.stream_importer("stb", batch_size=10_000)
        batches = []
        for _ in range(3):
            h2d0 = big.executor.h2d_bytes
            t0 = time.perf_counter()
            imp.push_rows([r[:2] for r in stream_rows[:10_000]])
            torch.cuda.synchronize()
            batches.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                h2d_bytes=big.executor.h2d_bytes - h2d0,
                                table_rows=big.table_rows("stb")))
        imp.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(queries=len(IO_SHAPE_QUERIES), table_rows=rows, launches=launched,
                stream_batches_past_staging=batches, **lines), [c.launches for c in counters]


CAST_TARGETS = ("TINYINT", "SMALLINT", "INT", "BIGINT")


def _bits(rows):
    """Rows with each float as its exact hex (-0.0, NaN and every bit
    compared)."""
    return [tuple(v.hex() if isinstance(v, float) else v for v in r) for r in rows]


def run_cast_shapes(n: int = 200_000):
    """Faults F3 and F4 on CUDA against the CPU, bit for bit: every
    FLOAT / DOUBLE -> integer CAST over the edges (+-1e300, +-3e9, +-inf,
    NaN, 3e38, the targets' ends) and values around each target's range,
    and ROUND / TRUNCATE of a FLOAT at half-way points and near FLT_MAX,
    with 3, 1, 0 and -2 digits."""
    rng = np.random.default_rng(SEED + 34)
    edges = np.array([1e300, -1e300, 3e9, -3e9, np.inf, -np.inf, np.nan, 3e38, -3e38,
                      2.0**63, -2.0**63, 2.0**31, -2.0**31 - 1, 127.9, -128.5, 32767.5,
                      -32768.9, 0.0, -0.0, 1.5, -2.5])
    d = np.concatenate([edges, rng.uniform(-2.5, 2.5, n) * 10.0 ** rng.integers(0, 20, n)])
    f = np.concatenate([np.array([47.3185, 3e38, -3e38, 3.4e38, 1e-40, -0.0005], np.float32),
                        (rng.integers(0, 100_000, d.shape[0] - 6) / 1000 + 0.0005)
                        .astype(np.float32)])
    with np.errstate(over="ignore"):
        df = d.astype(np.float32)
    dbs = _twin_dbs()
    for db in dbs:
        db.sql("CREATE TABLE c (id INT, d DOUBLE, df FLOAT, f FLOAT)")
        db.load_table("c", {"id": np.arange(d.shape[0], dtype=np.int32), "d": d, "df": df,
                            "f": f})
    queries = [f"SELECT id, CAST(d AS {t}), CAST(df AS {t}) FROM c ORDER BY id"
               for t in CAST_TARGETS]
    queries += [f"SELECT id, ROUND(f, {k}), TRUNCATE(f, {k}) FROM c ORDER BY id"
                for k in (3, 1, 0, -2)]
    for q in queries:
        got, want = (_bits(db.sql(q).rows()) for db in dbs)
        if got != want:
            bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"{q}: row {bad} {got[bad]} on CUDA, {want[bad]} on the CPU")
    named = dbs[0].sql("SELECT CAST(d AS INT), CAST(d AS SMALLINT), CAST(df AS INT) FROM c "
                       "WHERE id IN (0, 2, 7) ORDER BY id").rows()
    rounded = dbs[0].sql("SELECT ROUND(f, 3), ROUND(f, 1) FROM c WHERE id < 2 ORDER BY id").rows()
    if named[0][:2] != (2147483647, 32767) or rounded[0][0] != float(np.float32(47.319)) \
            or rounded[1][1] != float(np.float32(3e38)):
        raise AssertionError(f"cast_shapes: {named}, {rounded}")
    return dict(rows=int(d.shape[0]), queries=len(queries), named=named, rounded=rounded)


# ---------------------------------------------------------------------------
# multihost: parallel/* on the one card
# ---------------------------------------------------------------------------

MH_HOSTS = 2
MH_ROWS = 20_000_000  # the rig's fact rows in all, 10^7 a host (the reference worker: 2 x 10^5)
MH_PERSIST_ROWS = 2_000_000  # the restart's fact rows in all, 10^6 a host
MH_PERSIST_QUERIES = ("MH_GROUPBY", "MH_STRING_GROUPBY", "MH_JOIN_GROUPBY", "MH_GROUPBY_K")
MH_DQ_ROWS = 10_000_000  # the shard-map steps' rows
MH_DQ_SHARDS = 4  # the shards of Mesh([cuda:0] * 4)
MH_DQ_ROW_BLOCK = 1 << 21  # each destination bin: no overflow at MH_DQ_ROWS (<= 1.6M a bin)
MH_DQ_SMALL_BLOCK = 1 << 19  # a bin the skewed rows overflow
MH_WORKER_ARG = "--multihost-worker"
MH_WORKER_THREADS = 4  # torch's CPU threads a worker: two workers on the host's 8 cores
MH_COLLECTIVE_TIMEOUT_S = 120  # gloo's timeout: a dead peer fails the collective
MH_CLUSTER_TIMEOUT_S = 240  # the wall-clock limit of a cluster's processes
MH_TOL = 1e-4  # FLOAT sums and averages, relative (the reference worker's, floor 1)
MH_WINDOW_TOL = 1e-3  # the reference worker's for the running window sums
# fact's schema declared, with v FLOAT (4 bytes: MIN / MAX go to B3 at 400
# slots); the reference worker's load_table infers DOUBLE for it
MH_FACT_DDL = "CREATE TABLE fact (k INT, g INT, v FLOAT, s TEXT)"


def _mh_close(got, want, tol=MH_TOL) -> bool:
    if isinstance(want, float):
        return got is not None and abs(got - want) <= max(abs(want), 1.0) * tol
    return got == want


def _mh_rows_equal(label, got, want, tol=MH_TOL) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, numpy has {len(want)}")
    for a, b in zip(got, want):
        if len(a) != len(b) or not all(_mh_close(x, y, tol) for x, y in zip(a, b)):
            raise AssertionError(f"{label}: {a} vs numpy's {b}")


def _mh_groups(keys, size, ok, vals, minmax=False):
    """Per key in [0, size): rows, and the count, float64 sum, min and max
    (with minmax, else None) of vals over the rows where ok."""
    rows = np.bincount(keys, minlength=size)
    kk, vv = keys[ok], vals[ok].astype(np.float64)
    cnt = np.bincount(kk, minlength=size)
    tot = np.bincount(kk, weights=vv, minlength=size)
    if not minmax:
        return rows, cnt, tot, None, None
    order = np.argsort(kk, kind="stable")
    ks, vs = kk[order], vv[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]]) if ks.size else ks
    mn = np.full(size, np.nan)
    mx = np.full(size, np.nan)
    if ks.size:
        mn[ks[starts]] = np.minimum.reduceat(vs, starts)
        mx[ks[starts]] = np.maximum.reduceat(vs, starts)
    return rows, cnt, tot, mn, mx


def _mh_name_rank(d):
    """The names, each row's name code, and each row's rank of its name in
    the names' sort order."""
    vocab = np.array([f"name_{i}" for i in range(synthetic.MULTIHOST_NAMES)], object)
    code = np.arange(d["k"].shape[0]) % synthetic.MULTIHOST_NAMES
    rank = np.argsort(np.argsort(vocab.astype(str)))
    return vocab, code, rank[code]


def _mh_sorted_window(sel, keys):
    """Rows of sel in lexsort order of keys (the last key first), and the
    starts of each partition (keys[-1]) in that order."""
    idx = np.flatnonzero(sel)
    order = idx[np.lexsort(tuple(k[idx] for k in keys))]
    part = keys[-1][order]
    new_part = np.r_[True, part[1:] != part[:-1]]
    start = np.maximum.accumulate(np.where(new_part, np.arange(order.size), 0))
    return order, new_part, start


MH_RAW = ("MH_TOPK", "MH_WINDOW", "MH_WINDOW_LAG_RANK", "MH_GLOBAL_WINDOW")


def expected_multihost(label, d):
    """numpy's answer over the full data d, vectorized: its rows, or for the
    large results of MH_RAW what check_multihost holds their columns to."""
    k, g, v = d["k"], d["g"], d["v"]
    m = ~np.isnan(v)
    v64 = v.astype(np.float64)
    if label in MH_RAW:
        return _mh_expected_raw(label, d)
    if label == "MH_KEYLESS":
        f = k < 200
        fv = v64[f & m]
        return [(int(f.sum()), float(fv.sum()), float(fv.mean()), float(fv.min()),
                 float(fv.max()))]
    if label in ("MH_GROUPBY", "MH_GROUPBY_K", "MH_JOIN_GROUPBY"):
        keys, size = {"MH_GROUPBY": (g, 37), "MH_GROUPBY_K": (k, 400),
                      "MH_JOIN_GROUPBY": (k % 11, 11)}[label]
        n_rows, cnt, tot, mn, mx = _mh_groups(keys, size, m, v, label == "MH_GROUPBY_K")
        live = np.flatnonzero(n_rows)
        if label == "MH_GROUPBY":
            return [(int(i), int(n_rows[i]), float(tot[i]), float(tot[i] / cnt[i])) for i in live]
        if label == "MH_GROUPBY_K":
            return [(int(i), int(n_rows[i]), float(tot[i]), float(mn[i]), float(mx[i]))
                    for i in live]
        return [(int(i), int(n_rows[i]), float(tot[i])) for i in live]
    if label == "MH_STRING_GROUPBY":
        vocab, code, _ = _mh_name_rank(d)
        cnt = np.bincount(code, minlength=vocab.size)
        return sorted((str(vocab[i]), int(cnt[i])) for i in np.flatnonzero(cnt))
    if label == "MH_FULL_SORT":
        sel = np.flatnonzero(m & (v > 1.5))
        fo = sel[np.lexsort((k[sel], -v[sel]))]
        return [(int(k[i]), float(v[i])) for i in fo]
    if label == "MH_COUNT_DISTINCT":
        pairs = np.unique(g.astype(np.int64) * 400 + k)
        nd = np.bincount(pairs // 400, minlength=37)
        n_rows = np.bincount(g, minlength=37)
        return [(int(i), int(nd[i]), int(n_rows[i])) for i in np.flatnonzero(n_rows)]
    if label == "MH_MEDIAN":
        return [(i, float(np.median(v64[(g == i) & m]))) for i in range(5)]
    if label == "MH_MINMAX_STRING":
        vocab, code, _ = _mh_name_rank(d)
        seen = np.bincount(g.astype(np.int64) * vocab.size + code,
                           minlength=37 * vocab.size).reshape(37, vocab.size) > 0
        return [(int(i), min(vocab[seen[i]]), max(vocab[seen[i]]))
                for i in np.flatnonzero(seen.any(1))]
    if label == "MH_KEYLESS_DISTINCT":  # the exact count; the estimate within 10 %
        return int(np.unique(k[g < 30]).size)
    if label == "MH_FACT_FACT_JOIN":
        ok, w = d["ok"], d["w"].astype(np.float64)
        per_cnt = np.bincount(ok, minlength=400)
        per_w = np.bincount(ok, weights=w, minlength=400)
        return [(int(per_cnt[k].sum()), float((np.where(m, v64, 0.0) * per_cnt[k]).sum()),
                 float(per_w[k].sum()))]
    if label == "MH_FACT_FACT_JOIN_GROUPBY":
        hot = np.bincount(d["ok"][d["w"] > 0.5], minlength=400)
        per_g = np.bincount(g, weights=hot[k], minlength=37)
        return [(int(i), int(per_g[i])) for i in np.flatnonzero(per_g)]
    if label == "MH_SHARD_LOAD":
        return [(int(k.shape[0]),)]
    raise AssertionError(f"no oracle for {label}")


def _mh_expected_raw(label, d) -> dict:
    k, g, v = d["k"], d["g"], d["v"]
    m = ~np.isnan(v)
    _, _, s_rank = _mh_name_rank(d)
    int_null = np.iinfo(np.int32).min
    if label == "MH_TOPK":
        vv = np.where(m, v, -np.inf)
        top = np.sort(np.partition(vv, vv.size - 25)[-25:])[::-1]
        # rows tied on v may come from any of the tied rows: per value, the
        # keys of every row holding it, and whether all of them are in
        ties = {x: (np.sort(k[vv == x]), (top == x).sum() == (vv == x).sum())
                for x in np.unique(top)}
        return {"top": top, "ties": ties}
    if label == "MH_WINDOW":
        order, new_part, start = _mh_sorted_window(g < 6, (s_rank, k, g))
        gs, ks, ss = g[order], k[order], s_rank[order]
        vs = v[order].astype(np.float64)
        peer_end = np.r_[(gs[1:] != gs[:-1]) | (ks[1:] != ks[:-1]) | (ss[1:] != ss[:-1]), True]
        last = np.minimum.accumulate(np.where(peer_end, np.arange(order.size),
                                              order.size)[::-1])[::-1]
        cum = np.cumsum(np.where(np.isnan(vs), 0.0, vs))
        cnt = np.cumsum(~np.isnan(vs))
        base_cum = np.where(start > 0, cum[start - 1], 0.0)
        base_cnt = np.where(start > 0, cnt[start - 1], 0)
        run = cum[last] - base_cum[last]
        run = np.where(cnt[last] - base_cnt[last] > 0, run, np.nan)
        return {"g": gs, "k": ks, "rn": np.arange(order.size) - start + 1, "sum": run}
    if label == "MH_WINDOW_LAG_RANK":
        order, new_part, start = _mh_sorted_window((g < 4) & m, (v, s_rank, k, g))
        gs, ks = g[order], k[order]
        lag = np.where(new_part, int_null, np.r_[int_null, ks[:-1]])
        new_key = new_part | np.r_[True, ks[1:] != ks[:-1]]
        rank = np.maximum.accumulate(np.where(new_key, np.arange(order.size), 0)) - start + 1
        rows = np.stack([gs, ks, lag, rank]).astype(np.int64)
    else:  # MH_GLOBAL_WINDOW
        idx = np.flatnonzero((k < 3) & m)
        order = idx[np.lexsort((v[idx], s_rank[idx], k[idx]))]
        rows = np.stack([k[order], np.arange(1, order.size + 1)]).astype(np.int64)
    # rows tied on the ORDER BY come in any order: compared sorted
    return {"rows": rows, "sorted": rows[:, np.lexsort(rows[::-1])]}


def check_multihost(label, rs, want) -> int:
    """Raise unless the distributed result equals want, numpy's answer
    (expected_multihost): FLOAT sums within MH_TOL, the window sums within
    MH_WINDOW_TOL, rows in ORDER BY order, peers in any order."""
    if label in MH_RAW:
        return _mh_check_raw(label, [rs.column_raw(i) for i in range(rs.col_count)], want)
    rows = rs.rows()
    if label == "MH_KEYLESS_DISTINCT":
        exact, approx = rows[0]
        if exact != want or not 0.9 * want <= approx <= 1.1 * want:
            raise AssertionError(f"{label}: {rows} vs numpy's {want}")
        return 1
    _mh_rows_equal(label, rows, want)
    return len(rows)


def _mh_check_raw(label, got, want) -> int:
    """The large results, column by column as arrays."""
    n_got = got[0].shape[0]
    if label == "MH_TOPK":
        top = want["top"]
        vals = got[1].astype(np.float32)
        if n_got != top.size or not np.array_equal(vals, top):
            raise AssertionError(f"{label}: values {vals} vs numpy's {top}")
        for x, (keys, full) in want["ties"].items():
            got_k = np.sort(got[0][vals == x])
            if full and not np.array_equal(got_k, keys) or not np.isin(got_k, keys).all():
                raise AssertionError(f"{label}: keys {got_k} at v={x}, numpy's {keys}")
        return n_got
    if label == "MH_WINDOW":
        if n_got != want["g"].size:
            raise AssertionError(f"{label}: {n_got} rows, numpy has {want['g'].size}")
        seq = got[0].astype(np.int64) * 400 + got[1]
        if np.any(np.diff(seq) < 0):
            raise AssertionError(f"{label}: rows out of ORDER BY g, k order")
        o = np.lexsort((got[3], got[0]))  # peers in any order: compare by (g, row_number)
        gg, gk, gsum, grn = (c[o] for c in got)
        if not (np.array_equal(gg, want["g"]) and np.array_equal(gk, want["k"])
                and np.array_equal(grn, want["rn"])):
            raise AssertionError(f"{label}: g, k or row_number differ from numpy's")
        run = want["sum"]
        nulls = np.isnan(run)
        bad = (np.isnan(gsum) != nulls) | (~nulls & (np.abs(gsum - run) > np.maximum(
            np.abs(run), 1.0) * MH_WINDOW_TOL))
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise AssertionError(f"{label}: running sum {gsum[i]} vs numpy's {run[i]}")
        return n_got
    have = np.stack(got).astype(np.int64)
    if have.shape != want["rows"].shape:
        raise AssertionError(f"{label}: {have.shape[1]} rows, numpy has "
                             f"{want['rows'].shape[1]}")
    if label == "MH_WINDOW_LAG_RANK" and not np.array_equal(have[:2], want["rows"][:2]):
        raise AssertionError(f"{label}: rows out of ORDER BY g, k order")
    if not np.array_equal(have[:, np.lexsort(have[::-1])], want["sorted"]):
        raise AssertionError(f"{label}: rows differ from numpy's")
    return n_got


class _TimedRuntime:
    """Times the runtime's gathers and exchanges from outside the package:
    allgather_multi (which every gather, exchange and dictionary merge
    calls) and allgather_scalar are wrapped on the instance."""

    def __init__(self, rt):
        self.ms = 0.0
        self.calls = 0
        self.sent = 0  # this host's payload bytes
        self.gathered = 0  # every host's payload bytes, as received
        self.padded = 0  # bytes of the padded gathers (one pow2 buffer a host)
        multi, scalar = rt.allgather_multi, rt.allgather_scalar
        hosts = rt.num_processes

        def timed_multi(arrays):
            t0 = time.perf_counter()
            out = multi(arrays)
            self.ms += (time.perf_counter() - t0) * 1e3
            self.calls += 2
            self.sent += sum(np.asarray(a).nbytes for a in arrays)
            per_host = [sum(parts[p].nbytes for parts in out) for p in range(hosts)]
            self.gathered += sum(per_host)
            self.padded += hosts * (1 << max(max(per_host).bit_length(), 4))
            return out

        def timed_scalar(x):
            t0 = time.perf_counter()
            out = scalar(x)
            self.ms += (time.perf_counter() - t0) * 1e3
            self.calls += 1
            self.sent += 8
            self.gathered += 8 * hosts
            self.padded += 8 * hosts
            return out

        rt.allgather_multi = timed_multi
        rt.allgather_scalar = timed_scalar

    def snap(self):
        return (self.ms, self.calls, self.sent, self.gathered, self.padded)

    def since(self, before) -> dict:
        d = [a - b for a, b in zip(self.snap(), before)]
        return dict(exchange_ms=d[0], collectives=d[1], sent_bytes=d[2],
                    gathered_bytes=d[3], padded_bytes=d[4])


def _mh_counters():
    from heavydb_tpu_torch.kernels import (groupby_minmax, groupby_slots, lane_agg,
                                           radix_groupby, radix_hist, tile_sort)

    return [lane_agg.lane_agg, radix_hist.fused_hist, groupby_minmax.minmax_per_slot,
            tile_sort.sort_tiles, radix_groupby.radix_partition, radix_groupby.radix_group,
            groupby_slots.count_per_slot, groupby_slots.sum_f32_per_slot,
            groupby_slots.sum_int_per_slot]


def _mh_store(pid: int) -> str:
    return os.path.abspath(os.path.join(STORE_ROOT, "multihost", f"host{pid}"))


def multihost_worker(mode: str, pid: int, nprocs: int, port: int) -> None:
    """One host of the cluster on this card: JSON lines on stdout.  mode
    "queries": load its partition of the rig's tables, run every
    MULTIHOST_QUERIES query against numpy over the full data, then write a
    partition of MH_PERSIST_ROWS rows to a database on disk and record its
    rows; "restart": reopen that database, check the cluster's consistency
    and the recorded rows, then drop rows on host 1 and expect every host
    to detect the divergence."""
    t_start, entered = time.perf_counter(), time.time()
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.errors import NotSupported
    from heavydb_tpu_torch.parallel.dist_engine import DistEngine
    from heavydb_tpu_torch.parallel.multihost import MultiHostRuntime

    torch.set_num_threads(MH_WORKER_THREADS)
    rt = MultiHostRuntime()
    rt.initialize(f"127.0.0.1:{port}", nprocs, pid, timeout_s=MH_COLLECTIVE_TIMEOUT_S)
    timed = _TimedRuntime(rt)
    counters = _mh_counters()
    path = _mh_store(pid)
    results = os.path.join(os.path.dirname(path), f"results{pid}.json")
    if mode == "queries":
        db = hdt.connect()
    else:
        t0 = time.perf_counter()
        db = hdt.connect(path)
        reopen_s = time.perf_counter() - t0
    emit({"host": pid, "step": "start", "entered_unix_s": entered,
          "connect_s": time.perf_counter() - t_start,
          "device": str(db.device), "device_bytes": torch.cuda.memory_allocated()})
    for c in counters:
        c.launches = 0  # the main path starts here
    if mode == "queries":
        t0 = time.perf_counter()
        data = synthetic.multihost_data(MH_ROWS)
        make_s = time.perf_counter() - t0
        dist = DistEngine(db, rt)
        before = timed.snap()
        t0 = time.perf_counter()
        db.sql(MH_FACT_DDL)
        synthetic.load_multihost(dist, data, pid, nprocs)
        torch.cuda.synchronize()
        emit({"host": pid, "step": "load", "rows": MH_ROWS, "make_s": make_s,
              "load_s": time.perf_counter() - t0, **timed.since(before),
              "local_rows": {t: db.catalog.get_table(t).num_rows
                             for t in ("fact", "orders", "sharded")},
              "device_bytes": torch.cuda.memory_allocated()})
        for label, q in synthetic.MULTIHOST_QUERIES.items():
            runs, outs = [], []
            for _ in range(2):  # first and warm
                b_ex, b_l = timed.snap(), [c.launches for c in counters]
                t0 = time.perf_counter()
                rs = dist.sql(q)
                for i in range(rs.col_count):
                    rs.column_raw(i)
                wall = (time.perf_counter() - t0) * 1e3
                outs.append(rs)
                ex = timed.since(b_ex)
                runs.append(dict(wall_ms=wall, engine_ms=wall - ex["exchange_ms"], **ex,
                                 launches={n: c.launches - b for n, c, b
                                           in zip(KERNEL_NAMES, counters, b_l) if c.launches > b}))
            t0 = time.perf_counter()
            want = expected_multihost(label, data)
            n_out = [check_multihost(label, r, want) for r in outs][0]
            emit({"host": pid, "query": label, "rows_out": n_out, "first": runs[0],
                  "warm": runs[1], "check_s": time.perf_counter() - t0})
            rt.barrier()  # the next query starts together: no host's check in its exchanges
        del dist, data
        # a partition on disk for the restart
        pdata = synthetic.multihost_data(MH_PERSIST_ROWS, seed=7)
        os.makedirs(path)
        t0 = time.perf_counter()
        pdist = DistEngine(hdt.connect(path), rt)
        sel = slice(pid, None, nprocs)
        pdist.load_table("fact", {c: pdata[c][sel] for c in ("k", "g", "v", "s")})
        dim_k = np.arange(400, dtype=np.int32)
        pdist.load_table("dim", {"k": dim_k, "nm": (dim_k % 11).astype(np.int32)},
                         replicated=True)
        load_s = time.perf_counter() - t0
        recorded = {}
        for label in MH_PERSIST_QUERIES:
            rs = pdist.sql(synthetic.MULTIHOST_QUERIES[label])
            check_multihost(label, rs, expected_multihost(label, pdata))
            recorded[label] = rs.rows()
        with open(results, "w") as f:
            json.dump(recorded, f)
        emit({"host": pid, "step": "persist", "rows": MH_PERSIST_ROWS, "load_checkpoint_s": load_s,
              "store_bytes": sum(os.path.getsize(os.path.join(dp, f))
                                 for dp, _, fs in os.walk(path) for f in fs)})
    else:
        dist = DistEngine(db, rt)  # dist_meta.json restores the partition record
        if "fact" not in dist.partitioned or dist.global_rows.get("fact") != MH_PERSIST_ROWS:
            raise AssertionError(f"restart: {dist.partitioned}, {dist.global_rows}")
        t0 = time.perf_counter()
        report = dist.check_table_consistency()
        check_ms = (time.perf_counter() - t0) * 1e3
        with open(results) as f:
            want = json.load(f)
        for label in MH_PERSIST_QUERIES:
            got = dist.sql(synthetic.MULTIHOST_QUERIES[label]).rows()
            _mh_rows_equal(f"restart {label}", got, [tuple(r) for r in want[label]])
        if pid == 1:
            db.sql("DELETE FROM fact WHERE g = 3")  # this host loses rows
        try:
            dist.check_table_consistency()
            detected = None
        except NotSupported as e:
            detected = str(e)
        if detected is None:
            raise AssertionError("divergence: check_table_consistency passed after a "
                                 "host lost rows")
        emit({"host": pid, "step": "restart", "reopen_s": reopen_s, "consistency_ms": check_ms,
              "hosts_ok": report["ok"], "rows_equal": list(MH_PERSIST_QUERIES),
              "divergence": detected})
    total = {n: c.launches for n, c in zip(KERNEL_NAMES, counters)}
    if mode == "queries" and min(total[n] for n in ("lane_agg", "radix_hist",
                                                    "groupby_minmax")) < 1:
        raise AssertionError(f"host {pid}: B1, B2 or B3 never launched: {total}")
    rt.shutdown()
    emit({"host": pid, "step": "done", "launches": total, "seconds": time.perf_counter() - t_start,
          "device_bytes": torch.cuda.memory_allocated(),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mh_cluster(mode: str, nprocs: int = MH_HOSTS) -> list:
    """Start nprocs copies of this script as the hosts of a cluster on this
    card and wait for all; any failure or the wall-clock limit kills the
    rest and raises.  Returns each host's JSON lines."""
    import tempfile

    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    for attempt in range(2):
        port = _free_port()
        spawned = time.time()
        outs = [tempfile.TemporaryFile(mode="w+") for _ in range(nprocs)]
        errs = [tempfile.TemporaryFile(mode="w+") for _ in range(nprocs)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), MH_WORKER_ARG,
                                   mode, str(pid), str(nprocs), str(port)],
                                  stdout=outs[pid], stderr=errs[pid], text=True, env=env)
                 for pid in range(nprocs)]
        deadline = time.monotonic() + MH_CLUSTER_TIMEOUT_S
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.returncode not in (None, 0)
                                                      for p in procs):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for o, e in zip(outs, errs):
            o.seek(0)
            e.seek(0)
            texts.append((o.read(), e.read()))
            o.close()
            e.close()
        if attempt == 0 and any("address already in use" in e.lower() for _, e in texts):
            continue
        bad = [(pid, p.returncode) for pid, p in enumerate(procs) if p.returncode != 0]
        if bad:
            detail = "\n".join(f"host {pid} rc {rc}:\n{texts[pid][0][-2000:]}\n"
                               f"{texts[pid][1][-3000:]}" for pid, rc in bad)
            raise AssertionError(f"multihost {mode}: hosts failed or timed out:\n{detail}")
        hosts = [[json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
                 for out, _ in texts]
        for lines in hosts:  # process start, imports and connect(), from the spawn
            start = lines[0]
            start["spawn_to_connected_s"] = start["entered_unix_s"] - spawned + start["connect_s"]
        return hosts


def _mh_dist_query() -> list:
    """The five shard-map steps on Mesh([cuda:0] * 4) at MH_DQ_ROWS rows
    against numpy; ms of each (host clock around a synchronised call)."""
    from heavydb_tpu_torch.parallel import dist_query as DQ
    from heavydb_tpu_torch.parallel.mesh import Mesh, row_sharding

    S = MH_DQ_SHARDS
    mesh = Mesh([torch.device("cuda", 0)] * S)
    n = MH_DQ_ROWS
    rng = np.random.default_rng(SEED + 5)
    keys = rng.integers(0, 1000, n).astype(np.int32)
    keys[::2] = 7  # skew: one key on half the rows, in every shard
    vals = rng.random(n).astype(np.float32)
    blocks = row_sharding(mesh).shard_slices(n)
    nrows = np.array([sl.stop - sl.start - 1000 * s for s, sl in enumerate(blocks)], np.int32)
    live = np.zeros(n, bool)
    for sl, r in zip(blocks, nrows):
        live[sl.start:sl.start + r] = True
    dev = torch.device("cuda", 0)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    tk, tv, tn = t(keys), t(vals), t(nrows)
    lines = []

    def run(name, fn, *args):
        fn(*args)
        torch.cuda.synchronize()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        line = {"step": "dist_query", "function": name, "rows": n, "shards": S,
                "ms": statistics.median(reps)}
        lines.append(line)
        return [o.cpu().numpy() for o in out], line

    want_c = np.bincount(keys[live], minlength=1000)
    want_s = np.bincount(keys[live], weights=vals[live].astype(np.float64), minlength=1000)
    (c, s), _ = run("distributed_groupby_sum_count",
                    DQ.distributed_groupby_sum_count(mesh, 1000), tk, tv, tn)
    if not (np.array_equal(c, want_c) and np.allclose(s, want_s, rtol=1e-5)):
        raise AssertionError("distributed_groupby_sum_count disagrees with numpy")
    (c, s), _ = run("distributed_groupby_reduce_scatter",
                    DQ.distributed_groupby_reduce_scatter(mesh, 1000), tk, tv, tn)
    if not (np.array_equal(c[:1000], want_c) and not c[1000:].any()
            and np.allclose(s[:1000], want_s, rtol=1e-5)):
        raise AssertionError("distributed_groupby_reduce_scatter disagrees with numpy")
    payload = np.arange(n, dtype=np.int64)
    order = np.argsort(-np.where(live, vals, -np.inf), kind="stable")[:100]
    (tv_, tp), _ = run("distributed_topk", DQ.distributed_topk(mesh, 100), tv,
                       t(payload), tn)
    if not (np.array_equal(tv_, vals[order]) and np.array_equal(tp, payload[order])):
        raise AssertionError("distributed_topk disagrees with numpy")
    # join: probe (key, group, value) against a build key set of even keys
    pg = rng.integers(0, 64, n).astype(np.int32)
    bk = rng.permutation(np.arange(0, 1000, 2)).astype(np.int64)
    bk = np.resize(bk, n // 100)  # repeated build keys, 10^5 rows
    bn = np.array([sl.stop - sl.start for sl in row_sharding(mesh).shard_slices(bk.size)],
                  np.int32)
    hit = live & np.isin(keys, bk)
    want_jc = np.bincount(pg[hit], minlength=64)
    want_js = np.bincount(pg[hit], weights=vals[hit].astype(np.float64), minlength=64)
    hp = DQ.shard_hash(tk, S).cpu().numpy()
    hb = DQ.shard_hash(t(bk), S).cpu().numpy()

    def overflow(row_block):
        over = 0
        for h, lv, size in ((hp, live, n), (hb, np.ones(bk.size, bool), bk.size)):
            for sl in row_sharding(mesh).shard_slices(size):
                top = np.bincount(h[sl][lv[sl]], minlength=S).max()
                over += max(int(top) - row_block, 0)
        return over

    for row_block in (MH_DQ_ROW_BLOCK, MH_DQ_SMALL_BLOCK):
        (c, s, o), line = run("distributed_join_groupby",
                              DQ.distributed_join_groupby(mesh, row_block, 64),
                              tk.to(torch.int64), t(pg), tv, tn, t(bk), t(bn))
        line.update(row_block=row_block, overflow=int(o[0]))
        if int(o[0]) != overflow(row_block) or (o != o[0]).any():
            raise AssertionError(f"distributed_join_groupby: overflow {o} vs numpy's "
                                 f"{overflow(row_block)}")
        if row_block == MH_DQ_ROW_BLOCK and not (
                o[0] == 0 and np.array_equal(c, want_jc) and np.allclose(s, want_js, rtol=1e-5)):
            raise AssertionError("distributed_join_groupby disagrees with numpy")
    for row_block in (MH_DQ_ROW_BLOCK, MH_DQ_SMALL_BLOCK):
        (rk, rv, rc, need), line = run("hash_repartition", DQ.hash_repartition(mesh, row_block),
                                       tk, tv, tn)
        line.update(row_block=row_block, needed=int(need[0]))
        want_need = 0
        for s, sl in enumerate(blocks):
            idx = np.arange(sl.start, sl.start + nrows[s])
            want_need += int(np.bincount(hp[idx], minlength=S).max())
        if (need != want_need).any():
            raise AssertionError(f"hash_repartition: overflow {need} vs numpy's {want_need}")
        for r in range(S):  # shard r's rows, each sender's in its order
            for s, sl in enumerate(blocks):
                idx = np.arange(sl.start, sl.start + nrows[s])
                mine = idx[hp[idx] == r][:row_block]
                base = (r * S + s) * row_block
                cnt = int(rc[r * S + s])
                if not (cnt == mine.size and np.array_equal(rk[base:base + cnt], keys[mine])
                        and np.array_equal(rv[base:base + cnt], vals[mine])):
                    raise AssertionError(f"hash_repartition: shard {r}'s rows from shard {s}")
    return lines


def run_multihost(counters) -> tuple:
    """The multihost phase: in process (num_shards on one card, the
    shard-map steps on Mesh([cuda:0] * 4)), then a 2-process cluster on
    this card, then its restart and a divergence.  (The executor's
    sharded path in one process is the sharded phase's.)"""
    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.config import Config

    lines = []
    n = torch.cuda.device_count() + 1  # 2 on one card
    try:
        hdt.connect(config=Config(num_shards=n))
        raise AssertionError(f"num_shards={n} on {n - 1} cards did not raise")
    except ValueError as e:
        lines.append({"step": f"num_shards_{n}", "raised": type(e).__name__,
                      "message": str(e)})
    db = hdt.connect(config=Config(num_shards=1))
    data = load_bench(db, MH_DQ_ROWS, SEED + 3)
    host = {c: a.cpu().numpy() for c, a in data.items()}
    del data
    before = [c.launches for c in counters]
    t0 = time.perf_counter()
    rs = db.sql(QUERIES["Q1K_MINMAX"])
    n_out = check_result("Q1K_MINMAX", rs, host)
    ms = (time.perf_counter() - t0) * 1e3
    warm, _, _ = warm_ms(db, QUERIES["Q1K_MINMAX"])
    delta = [c.launches - b for c, b in zip(counters, before)]
    check_route("Q1K_MINMAX", delta)
    lines.append({"step": "num_shards_1", "query": "Q1K_MINMAX", "rows": MH_DQ_ROWS,
                  "rows_out": n_out, "mesh": repr(db.executor.mesh), "first_ms": ms,
                  "warm_ms": warm, "launches": dict(zip(KERNEL_NAMES, delta))})
    del db, host
    torch.cuda.empty_cache()
    lines += _mh_dist_query()
    torch.cuda.empty_cache()
    total = list(delta)
    store = _store_root("multihost")
    try:
        for mode in ("queries", "restart"):
            t0 = time.perf_counter()
            hosts = _mh_cluster(mode)
            lines.append({"step": f"cluster_{mode}", "hosts": len(hosts),
                          "seconds": time.perf_counter() - t0})
            for host_lines in hosts:
                lines += host_lines
                done = next(ln for ln in host_lines if ln.get("step") == "done")
                total = [a + done["launches"][n] for a, n in zip(total, KERNEL_NAMES)]
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return lines, total


def main() -> None:
    t_start = time.perf_counter()
    card = smi()
    rate = mem_rate(card)
    from heavydb_tpu_torch.kernels import (_build, gate, groupby_minmax, groupby_slots,
                                           lane_agg, radix_groupby, radix_hist,
                                           tile_sort)

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    env = {"phase": "env", "card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": nvcc}
    emit(env)
    t0 = time.perf_counter()
    info = gate.kernel_gate(torch.device("cuda"))
    emit({"phase": "build", "build_s": info["seconds"],
          "gate_s": time.perf_counter() - t0, "built": info["built"],
          "source_s": info["source_seconds"],
          "entry_functions": {k: v.count("Compiling entry function")
                              for k, v in info["ptxas"].items()},
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln
                        or "spill" in ln] for k, v in info["ptxas"].items()}})
    # registers, shared memory and resident blocks per SM of B4-B6 as
    # they are launched (cudaFuncGetAttributes, the occupancy calculator)
    for name, ki in radix_groupby.kernel_info().items():
        emit({"phase": "kernel_info", "kernel": name, **ki})
    for T in SORT_TILES:
        for n_pay in (0, 4):
            emit({"phase": "kernel_info", "kernel": "tile_sort", "tile": T,
                  "payloads": n_pay, **tile_sort.kernel_info(T, n_pay)})
    for ki in agg_info():
        emit({"phase": "kernel_info", **ki})
    emit({"phase": "sass", **sass_atomics()})
    slot_shapes, slot_launches = run_slot_kernels(ROWS, rate)
    shapes = run_kernels(ROWS, rate) + slot_shapes + run_sort_kernels(ROWS, rate)
    for s in shapes:
        emit({"phase": "kernels", **s})
    for s in run_join_build_kernel(rate):
        emit({"phase": "kernels", **s})
    counters = [lane_agg.lane_agg, radix_hist.fused_hist,
                groupby_minmax.minmax_per_slot, tile_sort.sort_tiles,
                radix_groupby.radix_partition, radix_groupby.radix_group,
                groupby_slots.count_per_slot, groupby_slots.sum_f32_per_slot,
                groupby_slots.sum_int_per_slot]
    e2e, total, db, host = run_e2e(ROWS, card, counters)
    emit({"phase": "e2e", **e2e})
    launched = dict(zip(KERNEL_NAMES, total))
    # every kernel of an SQL route ran; B4's network runs inside radix_group
    if min(launched[k] for k in set().union(*ROUTES.values())) < 1:
        raise AssertionError(f"a kernel never launched on the main path: {launched}")
    for line in run_stream(db, host, counters):
        emit({"phase": "stream", **line})
    sort_lines, sort_total = run_sort(db, host, counters)
    for line in sort_lines:
        emit({"phase": "sort", **line})
    for line in sort_yardsticks(db, host, rate):
        emit({"phase": "sort_split", **line})
    join_lines, join_total, dims = run_join(db, host, counters)
    for line in join_lines:
        emit({"phase": "join", **line})
    for line in join_yardsticks(host, dims):
        emit({"phase": "join_split", **line})
    emit({"phase": "join_shapes", **run_join_shapes()})
    subq_lines, subq_total = run_subq(db, host, dims, counters)
    for line in subq_lines:
        emit({"phase": "subq", **line})
    t0 = time.perf_counter()
    sharded_lines, sharded_total = run_sharded(db, host, dims, counters)
    for line in sharded_lines:
        emit({"phase": "sharded", **line})
    sharded_s = time.perf_counter() - t0
    del dims
    emit({"phase": "set_shapes", **run_set_shapes()})
    distinct_lines, distinct_total = run_distinct(db, host, counters)
    for line in distinct_lines:
        emit({"phase": "distinct", **line})
    emit({"phase": "distinct_shapes", **run_distinct_shapes()})
    string_lines, string_total = run_strings(db, counters)
    for line in string_lines:
        emit({"phase": "strings", **line})
    emit({"phase": "string_shapes", **run_string_shapes(counters)})
    phase_s = {"sharded": sharded_s}
    t0 = time.perf_counter()
    hash_lines, hash_total = run_hash(db, host, counters)
    for line in hash_lines:
        emit({"phase": "hash", **line})
    phase_s["hash"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    emit({"phase": "hash_shapes", **run_hash_shapes(counters)})
    phase_s["hash_shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    win_lines, win_total = run_window(db, host, counters)
    for line in win_lines:
        emit({"phase": "window", **line})
    for line in window_yardsticks():
        emit({"phase": "window_split", **line})
    phase_s["window"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line, win_shape_total = run_window_shapes(counters)
    emit({"phase": "window_shapes", **line})
    phase_s["window_shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    udf_lines, udf_total = run_udf(db, host, counters)
    for line in udf_lines:
        emit({"phase": "udf", **line})
    phase_s["udf"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line, udf_shape_total = run_udf_shapes(db, host, counters)
    emit({"phase": "udf_shapes", **line})
    phase_s["udf_shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dml_lines, dml_total = run_dml(db, host, counters)
    for line in dml_lines:
        emit({"phase": "dml", **line})
    phase_s["dml"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    geo_lines, geo_total = run_geo(db, counters)
    for line in geo_lines:
        emit({"phase": "geo", **line})
    phase_s["geo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line, geo_shape_total = run_geo_shapes(counters)
    emit({"phase": "geo_shapes", **line})
    phase_s["geo_shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arr_lines, arr_total = run_arrays(db, counters)
    for line in arr_lines:
        emit({"phase": "arrays", **line})
    phase_s["arrays"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line, arr_shape_total = run_array_shapes(counters)
    emit({"phase": "array_shapes", **line})
    phase_s["array_shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctl_lines, ctl_total = run_controls(db, host, counters)
    for line in ctl_lines:
        emit({"phase": "controls", **line})
    phase_s["controls"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    up_lines, up_total = run_upload(db, host, counters)
    for line in up_lines:
        emit({"phase": "upload", **line})
    phase_s["upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ddl_lines, ddl_total = run_ddl(db, host, counters)
    for line in ddl_lines:
        emit({"phase": "ddl", **line})
    phase_s["ddl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    persist_lines, persist_total, store = run_persist(db, host, counters)
    for line in persist_lines:
        emit({"phase": "persist", **line})
    phase_s["persist"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        server_lines, server_total = run_server(db, host, counters, store)
    finally:
        shutil.rmtree(os.path.dirname(store), ignore_errors=True)
    for line in server_lines:
        emit({"phase": "server", **line})
    phase_s["server"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    copy_lines, copy_total, copied = run_copy(db, host, counters)
    for line in copy_lines:
        emit({"phase": "copy", **line})
    phase_s["copy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fsi_lines, fsi_total = run_fsi(db, counters, copied)
    for line in fsi_lines:
        emit({"phase": "fsi", **line})
    del copied
    phase_s["fsi"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line, io_total = run_io_shapes(counters)
    emit({"phase": "io_shapes", **line})
    phase_s["io_shapes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    emit({"phase": "cast_shapes", **run_cast_shapes()})
    phase_s["cast_shapes"] = time.perf_counter() - t0
    # the kernels line counts the launches of the main-path phases
    total = [sum(t) for t in zip(total, sort_total, join_total, subq_total, sharded_total,
                                  distinct_total, string_total, hash_total, win_total,
                                  win_shape_total, udf_total, udf_shape_total, dml_total,
                                  geo_total, geo_shape_total, arr_total, arr_shape_total,
                                  ctl_total, up_total, ddl_total, persist_total, server_total,
                                  copy_total, fsi_total, io_total)]
    if dict(zip(KERNEL_NAMES, geo_total))["radix_hist"] < 1:
        raise AssertionError("B2 did not launch in the geo phase (GEO_ZONE_JOIN)")
    del host
    emit({"phase": "hot_key", **run_hot_key(db, counters)})
    del db
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mh_lines, mh_total = run_multihost(counters)
    for line in mh_lines:
        emit({"phase": "multihost", **line})
    phase_s["multihost"] = time.perf_counter() - t0
    emit({"phase": "phase_seconds", **phase_s})
    # the cluster's hosts ran the port's kernels in their own processes
    total = [a + b for a, b in zip(total, mh_total)]
    rows = []
    rg_info = radix_groupby.kernel_info()
    for (name, src, replaces, tag), n_launched in zip(KERNELS, total):
        s = next(x for x in shapes
                 if x["kernel"] == name and x.get("tag", x.get("slots")) == tag)
        row = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=n_launched, max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"], bound_by="bytes",
            library_ms=s.get("library_ms"), rows=s["rows"], shape=str(tag))
        if "device_ms" in s:
            row["device_ms"] = s["device_ms"]
        if name in slot_launches:
            row.update(launches=slot_launches[name], path="kernel entry point")
        if name == "tile_sort":
            row["runs_inside"] = {"kernel": "radix_group",
                                  "launches": launched["radix_group"]}
            row["kernel_info"] = s["kernel_info"]
        if name in ("radix_partition", "radix_group"):
            row["kernel_info"] = {k: v for k, v in rg_info.items()
                                  if (k.startswith("part") == (name == "radix_partition"))}
        if name == "radix_partition":
            row.update(design_bytes=s["design_bytes"],
                       design_bound_ms=s["design_bound_ms"])
        rows.append(row)
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    emit(env)  # again, inside the tail of the output that is kept
    emit({"kernels": rows})


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == [MH_WORKER_ARG]:  # a host of the multihost phase's cluster
        multihost_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
        sys.exit(0)
    main()
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
