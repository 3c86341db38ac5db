"""Where the time of a SELECT goes on the card.

    python -m heavydb_tpu_torch.tools.profile_queries [--rows 100000000]
        [--stream-threshold BYTES] [--queries NAME ...]

Loads the synthetic benchmark's schema (tools/synthetic.py: uniform INT
columns x10 .. x10m, sparse BIGINT columns x10k_s10k and x1m_s10k, a FLOAT
column v, random from a seed) on the CUDA device, runs each
query (the group-by QUERIES, the ORDER BY SORT_QUERIES, the join + GROUP
BY JOIN_QUERIES, the dictionary-string STRING_QUERIES, the subquery and
set-operation SUBQ_QUERIES, the DISTINCT_QUERIES and the hash group-by
tier's HASH_QUERIES of tools/synthetic.py, whose dimension tables
`load_dims`, whose `lstr` table `load_strings` and whose `hsparse` table
`load_hsparse` (HASH_ROWS rows) add when one of them runs; each under its QUERY_SETTINGS,
and a HASH_QUERIES query also with the hash group-by off, on the sort
tier; the geo GEO_QUERIES over `load_geo`'s trips, zones and stations and
the ARRAY_QUERIES over `load_arrays`' arr, loaded when one of them runs;
the window functions of WINDOW_QUERIES and the scalar UDF of UDF_QUERIES
on bench) warm under
torch.profiler, and prints one JSON line per query: the
host-clock time of a run (median of 5 unprofiled runs, parse to control
read, result left on the device), the CUDA kernel and copy time of one
profiled run, the device's idle share (1 - busy / median wall), the
kernels that took the most time, the device time and kernel launches
under each named range of the run (RANGES: the CONTAINS_SEG ray cast of
a geo join, the port's `hdb:` scope of utils/timer.py), and the fragment waves a run took
(`--stream-threshold` sets the config's stream_threshold_bytes, so a
small one runs every query in waves).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from heavydb_tpu_torch.config import Config
from heavydb_tpu_torch.utils.timer import PREFIX
from heavydb_tpu_torch.tools.synthetic import (ARRAY_QUERIES, ARRAY_ROWS, DISTINCT_QUERIES,
                                               FRAGMENT_ROWS, GEO_QUERIES, HASH_QUERIES,
                                               HASH_ROWS, JOIN_QUERIES, QUERIES,
                                               SORT_QUERIES, STRING_QUERIES, SUBQ_QUERIES,
                                               TRIPS_ROWS, UDF_QUERIES, WINDOW_QUERIES,
                                               load_arrays, load_bench, load_dims,
                                               load_geo, load_hsparse, load_strings,
                                               query_settings, register_udfs)

ALL_QUERIES = {**QUERIES, **SORT_QUERIES, **JOIN_QUERIES, **STRING_QUERIES,
               **SUBQ_QUERIES, **DISTINCT_QUERIES, **HASH_QUERIES, **GEO_QUERIES,
               **ARRAY_QUERIES, **WINDOW_QUERIES, **UDF_QUERIES}
# the queries that read load_dims' tables
DIM_QUERIES = set(JOIN_QUERIES) | {"SUBQ_IN", "SUBQ_NOT_IN"}
# the queries on tables of their own, and those tables' rows
OWN_ROWS = {**{q: HASH_ROWS for q in HASH_QUERIES}, **{q: TRIPS_ROWS for q in GEO_QUERIES},
            **{q: ARRAY_ROWS for q in ARRAY_QUERIES}}
# record_function ranges of the port whose device time and launches a
# profile reports apart
RANGES = (PREFIX + "contains_seg_ray_cast",)
# device-side profiler entries that are not kernels, copies or sets: the
# runtime's own, and the device-side copies of the port's ranges
NOT_KERNELS = {"Activity Buffer Request", "Command Buffer Full"}


def is_kernel(name: str) -> bool:
    return name not in NOT_KERNELS and not name.startswith(PREFIX)


def range_stats(prof, name: str) -> dict:
    """Device ms and launches of the kernels, copies and sets that ran
    inside the record_function range `name` of a torch.profiler run: those
    within the device-side spans of the range (every occurrence)."""
    from torch.autograd import DeviceType

    evts = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in evts
             if e.name == name and e.device_type == DeviceType.CUDA]
    us, launches = 0.0, 0
    for e in evts:
        if e.device_type == DeviceType.CUDA and is_kernel(e.name) and any(
                a <= e.time_range.start and e.time_range.end <= b for a, b in spans):
            us += e.time_range.elapsed_us()
            launches += 1
    return dict(device_ms=us / 1e3, launches=launches)


def _device_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    if v is None:
        v = evt.self_cuda_time_total
    return float(v)


def profile_query(db, sql: str, reps: int = 5) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        db.sql_device(sql)
        torch.cuda.synchronize()

    run()  # warm
    waves0 = db.executor.waves_run
    run()
    waves = db.executor.waves_run - waves0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, memcpy, memset): the aten ops that
    # launched them carry the same time again, a named range (`hdb:`) spans
    # its kernels, and the runtime's waits on a full launch queue are no work
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and is_kernel(e.key)]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    # the profiler stretches the host clock, so the idle share is taken
    # against the median unprofiled wall time; one stream runs one kernel
    # at a time, so busy time above the profiled run's own wall means the
    # sum is wrong (against the unprofiled runs' wall a query ~2 % idle
    # can pass it by the spread of its kernels' times between runs)
    wall = statistics.median(walls)
    if busy_ms > wall_ms:
        raise RuntimeError(f"device busy {busy_ms:.3f} ms exceeds the "
                           f"{wall_ms:.3f} ms wall clock of the profiled run")
    top = sorted(kernels, key=_device_us, reverse=True)[:6]
    ranges = {name: range_stats(prof, name) for name in RANGES}
    return dict(
        wall_ms=wall, profiled_wall_ms=wall_ms,
        device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall, waves=waves,
        top=[dict(name=e.key[:80], ms=_device_us(e) / 1e3, calls=e.count)
             for e in top],
        ranges={k: v for k, v in ranges.items() if v["launches"]})


def main(argv=None) -> None:
    import heavydb_tpu_torch as hdt

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--fragment-rows", type=int, default=FRAGMENT_ROWS)
    ap.add_argument("--stream-threshold", type=int, default=0,
                    help="the config's stream_threshold_bytes (0: its default)")
    ap.add_argument("--queries", nargs="*", default=list(ALL_QUERIES),
                    choices=list(ALL_QUERIES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_queries: needs a CUDA device")
    db = hdt.connect(config=Config(stream_threshold_bytes=args.stream_threshold))
    register_udfs(db)
    if set(args.queries) - set(OWN_ROWS):
        load_bench(db, args.rows, args.seed, args.fragment_rows)
    if set(args.queries) & DIM_QUERIES:
        load_dims(db, args.seed + 1)
    if set(args.queries) & set(STRING_QUERIES):
        load_strings(db, args.rows, args.seed + 4, args.fragment_rows)
    if set(args.queries) & set(HASH_QUERIES):
        load_hsparse(db, HASH_ROWS, args.seed + 9)
    if set(args.queries) & set(GEO_QUERIES):
        load_geo(db, args.seed + 11)
    if set(args.queries) & set(ARRAY_QUERIES):
        load_arrays(db, ARRAY_ROWS, args.seed + 12)
    card = torch.cuda.get_device_name(0)
    for name in args.queries:
        rows = OWN_ROWS.get(name, args.rows)
        with query_settings(db, name) as settings:
            line = profile_query(db, ALL_QUERIES[name])
        print(json.dumps({"query": name, "rows": rows, "card": card, **settings,
                          **line}), flush=True)
        if name in HASH_QUERIES:
            # the yardstick: the same query with the hash group-by off
            line = profile_query(db, ALL_QUERIES[name])
            print(json.dumps({"query": name, "rows": rows, "card": card,
                              "enable_hash_groupby": False, **line}), flush=True)


if __name__ == "__main__":
    main()
