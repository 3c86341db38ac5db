"""The kernel gate: builds the group-by kernels and checks each once.

Counterpart of heavydb_tpu/ops/groupby.py `_pallas_probe_locked`, the
one-block compile-and-run probe that gates the TPU's Pallas tiers.  Here
the gate builds kernels B1-B6, B3a-c and J1 from csrc/, launches each on a
small input and holds it against its plain version.  On CUDA it raises on
any failure; it never reports the kernels as unavailable.  Its launches do
not count in the wrappers' launch counters.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from heavydb_tpu_torch.kernels import (_build, _plain, groupby_minmax, groupby_slots,
                                       join_build, lane_agg, radix_groupby, radix_hist,
                                       tile_sort)

_LOCK = threading.Lock()
_PASSED: Dict[str, dict] = {}


def _inputs(device, n: int, num_slots: int, seed: int):
    rng = np.random.default_rng(seed)
    gid = rng.integers(-2, num_slots + 2, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    cm = mask & (rng.random(n) < 0.7)
    f = np.where(cm, rng.standard_normal(n), 0).astype(np.float32)
    i32 = np.where(cm, rng.integers(-2**31, 2**31 - 1, n), 0).astype(np.int32)
    i64 = np.where(cm, rng.integers(-2**62, 2**62, n), 0).astype(np.int64)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(gid), t(mask), t(cm), t(f), t(i32), t(i64)


def _same(a, b, what: str):
    if a.dtype.is_floating_point:
        ok = torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        ok = torch.equal(a, b)
    if not ok:
        raise RuntimeError(f"kernel gate: {what} disagrees with its plain "
                           "version")


def _check_sorts(device):
    """B4 on distinct keys (so payloads compare exactly), B5 alone with two
    levels, and B5 + B6 over four partitions with every stream class,
    through both B6 launches."""
    rng = np.random.default_rng(4)
    n = 4096
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    key = t(rng.permutation(n).astype(np.int32) - 2000)
    pay = [t(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)),
           t(rng.standard_normal(n).astype(np.float32))]
    for pays in ([], pay):  # the kernel of bare keys, and of (key, index) words
        for got, want in zip(tile_sort.sort_tiles(key, pays, 1024),
                             tile_sort.sort_tiles_plain(key, pays, 1024)):
            _same(got, want, "tile_sort")
    n = 1 << 14
    gid, mask, cm, f, i32, i64 = _inputs(device, n, 3000, 5)
    gid = torch.where(mask, gid, -1)

    def streams(f):
        return [(cm, "count"), (i64, "sumi"), (f, "sumf"), (f, "sumd"),
                (torch.where(cm, f, float("inf")), "min"),
                (torch.where(cm, i32, -2**31), "max")]

    # B5 alone with two levels (2^9 partitions: 5 + 4 bits); the row id
    # stream names each output row's origin
    rows = torch.arange(n, dtype=torch.int32, device=device)
    got = radix_groupby.radix_partition(gid, [(rows, "sumi"), (f, "sumf")], 3000, 9)
    want = radix_groupby.radix_partition_plain(gid, [(rows, "sumi"), (f, "sumf")],
                                               3000, 9)
    _same(got[2], want[2], "radix_partition counts")
    nv = int(want[2].sum())
    region = torch.repeat_interleave(torch.arange(1 << 9, device=device), want[2])

    def by_row(hb, parts):
        order = torch.argsort(region * n + parts[0][:nv].long())
        return [hb[:nv][order]] + [p[:nv][order] for p in parts]

    for a, b in zip(by_row(got[0], got[1]), by_row(want[0], want[1])):
        _same(a, b, "radix_partition rows")

    # then a hot group of 4400 rows, whose partition (~6800 rows) takes B6's
    # second launch; its float values are multiples of 1/8, so every float32
    # partial sum is exact in any order
    hot = gid.clone()
    hot[:4400] = 7
    for g, ss, cap in ((gid, streams(f), 4096), (gid, streams(f), 100),
                       (hot, streams(torch.round(f * 8) / 8), 4096)):
        got = radix_groupby.sparse_groupby(g, ss, 3000, cap)
        want = radix_groupby.sparse_groupby_plain(g, ss, 3000, cap)
        for j, (a, b) in enumerate(zip(got[:2] + tuple(got[2]) + got[3:],
                                       want[:2] + tuple(want[2]) + want[3:])):
            _same(a, b.to(a.dtype), f"sparse_groupby cap={cap}, output {j}")


def _check_join_build(device):
    """J1 over 25 slots and over 5000: keys in runs with a validity and
    rows past num_rows, the same one element in, and keys in no order with
    no validity."""
    rng = np.random.default_rng(6)
    n = 5000
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    for key_range in (25, 5000):
        keys = t(np.sort(rng.integers(-3, key_range + 3, n)).astype(np.int64) + 7)
        valid = t(rng.random(n) < 0.7)
        for k, v, num_rows in ((keys, valid, n - 100), (keys[1:], valid[1:], n),
                               (keys[t(rng.permutation(n))], None, n - 7)):
            got = join_build.launch(k, v, num_rows, 7, key_range)
            want = join_build.perfect_count_plain(k, v, num_rows, 7, key_range)
            for a, b, what in zip(got, want, ("slots", "counts")):
                _same(a, b, f"perfect_count {what} at {key_range} slots")


def kernel_gate(device) -> dict:
    """Build and check B1-B6, B3a-c and J1 on `device` once per process.
    Returns the build record (seconds, nvcc version, ptxas report)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the kernel gate runs on CUDA devices only")
    key = str(device)
    with _LOCK:
        if key in _PASSED:
            return _PASSED[key]
        info = dict(_build.build_all())
        n = 1 << 14
        counters = (lane_agg.lane_agg, radix_hist.fused_hist)
        before = [c.launches for c in counters]
        # B1 at 37 slots and at 256 slots with 16 streams; B2 on each tier
        # of radix_hist.plan: 256 / 512 / 1024-thread private copies,
        # clusters of 2 and 4 blocks, global atomics
        b1 = ("count", "sumi", "sumi", "sumf", "sumd", "min", "max")
        for name, num_slots, ops in (
            ("lane_agg", 37, b1),
            ("lane_agg", 256, (b1 * 3)[:16]),
            ("radix_hist", 1000, ("count", "sumi", "sumf", "sumd")),
            ("radix_hist", 3000, ("count", "sumi", "sumf", "sumd", "sumi")),
            ("radix_hist", 6000, ("count", "sumi", "sumf", "sumd", "sumi")),
            ("radix_hist", 10000, ("count", "sumi", "sumf", "sumd", "sumi")),
            ("radix_hist", 20000, ("count", "sumi", "sumf", "sumd", "sumi")),
            ("radix_hist", 65536, ("sumi", "sumd") * 8),
        ):
            gid, mask, cm, f, i32, i64 = _inputs(device, n, num_slots, num_slots)
            vals = {"count": [cm], "sumi": [i32, i64], "sumf": [f],
                    "sumd": [f], "min": [f], "max": [i32]}
            streams = []
            for op in ops:
                streams.append((vals[op][0], op))
                vals[op] = vals[op][1:] or vals[op]
            fn = lane_agg.lane_agg if name == "lane_agg" else radix_hist.fused_hist
            # aligned rows, and views one element in (a scalar head)
            for sl in (slice(None), slice(1, None)):
                ss = [(v[sl], op) for v, op in streams]
                got = fn(gid[sl], mask[sl], ss, num_slots)
                want = _plain.scatter_scan(gid[sl], mask[sl], ss, num_slots)
                for j, (a, b) in enumerate(zip(got, want)):
                    _same(a, b, f"{name} at {num_slots} slots, {len(ops)} streams, "
                          f"output {j}")
        for c, b in zip(counters, before):
            c.launches = b
        # B3 at 3000 slots: aligned rows, and views one element in
        for vals in (i32, f):
            for is_min in (True, False):
                for sl in (slice(None), slice(1, None)):
                    args = (gid[sl], vals[sl], mask[sl], 3000, is_min)
                    _same(groupby_minmax.launch(*args),
                          groupby_minmax.minmax_per_slot_plain(*args),
                          f"groupby_minmax {vals.dtype} is_min={is_min}")
        # B3a-c on the shared-memory path (1000 slots) and the global one
        for num_slots in (1000, 40000):
            gid, mask, _, f, i32, i64 = _inputs(device, n, num_slots, num_slots + 1)
            for kind, vals in (("count", None), ("sum_f32", f), ("sum_int", i32),
                               ("sum_int", i64)):
                # aligned rows, and views one element in (a scalar head)
                for sl in (slice(None), slice(1, None)):
                    v = None if vals is None else vals[sl]
                    got = groupby_slots.launch(kind, gid[sl], v, mask[sl], num_slots)
                    want = groupby_slots.plain(kind, gid[sl], v, mask[sl], num_slots)
                    _same(got, want, f"groupby_slots {kind} at {num_slots} slots, "
                          f"{None if vals is None else vals.dtype} values")
        counters = (tile_sort.sort_tiles, radix_groupby.radix_partition,
                    radix_groupby.radix_group)
        before = [c.launches for c in counters]
        _check_sorts(device)
        for c, b in zip(counters, before):
            c.launches = b
        _check_join_build(device)
        torch.cuda.synchronize(device)
        _PASSED[key] = info
        return info
