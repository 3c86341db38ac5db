"""The kernel gate: builds the group-by kernels and checks each once.

Counterpart of heavydb_tpu/ops/groupby.py `_pallas_probe_locked`, the
one-block compile-and-run probe that gates the TPU's Pallas tiers.  Here
the gate builds kernels B1-B6 and B3a-c from csrc/, launches each on a
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
                                       radix_groupby, tile_sort)

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
    """B4 on distinct keys (so payloads compare exactly) and B5 + B6 over
    four partitions with every stream class, through both B6 launches."""
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


def kernel_gate(device) -> dict:
    """Build and check B1-B6 and B3a-c on `device` once per process.
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
        for name, num_slots, ops in (
            ("lane_agg", 37, ("count", "sumi", "sumi", "sumf", "sumd", "min",
                              "max")),
            ("radix_hist", 1000, ("count", "sumi", "sumf", "sumd")),
            ("radix_hist", 40000, ("count", "sumi", "sumi", "sumf", "sumd")),
        ):
            gid, mask, cm, f, i32, i64 = _inputs(device, n, num_slots, num_slots)
            vals = {"count": [cm], "sumi": [i32, i64], "sumf": [f],
                    "sumd": [f], "min": [f], "max": [i32]}
            streams = []
            for op in ops:
                streams.append((vals[op][0], op))
                vals[op] = vals[op][1:] or vals[op]
            got = _build.launch_streams(name, gid, mask, streams, num_slots)
            want = _plain.scatter_scan(gid, mask, streams, num_slots)
            for j, (a, b) in enumerate(zip(got, want)):
                _same(a, b, f"{name} at {num_slots} slots, output {j}")
        for vals in (i32, f):
            for is_min in (True, False):
                got = groupby_minmax.launch(gid, vals, mask, 3000, is_min)
                want = groupby_minmax.minmax_per_slot_plain(
                    gid, vals, mask, 3000, is_min)
                _same(got, want, f"groupby_minmax {vals.dtype} is_min={is_min}")
        # B3a-c on the shared-memory path (1000 slots) and the global one
        for num_slots in (1000, 40000):
            gid, mask, _, f, i32, i64 = _inputs(device, n, num_slots, num_slots + 1)
            for kind, vals in (("count", None), ("sum_f32", f), ("sum_int", i32),
                               ("sum_int", i64)):
                got = groupby_slots.launch(kind, gid, vals, mask, num_slots)
                want = groupby_slots.plain(kind, gid, vals, mask, num_slots)
                _same(got, want, f"groupby_slots {kind} at {num_slots} slots, "
                      f"{None if vals is None else vals.dtype} values")
        counters = (tile_sort.sort_tiles, radix_groupby.radix_partition,
                    radix_groupby.radix_group)
        before = [c.launches for c in counters]
        _check_sorts(device)
        for c, b in zip(counters, before):
            c.launches = b
        torch.cuda.synchronize(device)
        _PASSED[key] = info
        return info
