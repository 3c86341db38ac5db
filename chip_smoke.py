"""On-card smoke test of the PyTorch/CUDA port (heavydb_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100); exits non-zero without one.  Phases, each
printing JSON lines:

  env      card, power limit, torch / CUDA / nvcc versions
  build    builds kernels B1-B6 and B3a-c from heavydb_tpu_torch/kernels/csrc
           into build/kernels and runs the kernel gate
  kernel_info  registers, shared memory and resident blocks per SM of B4-B6
           as they are launched
  sass     the shared-memory atomics B3a-c compile to (cuobjdump), once
  kernels  each kernel against its plain PyTorch version at 100M rows and
           the shapes the main path gives it; times with CUDA events.  B3a-c
           (kernels/groupby_slots.py), which no SQL route runs, are driven
           through their own entry points here and count launches there;
           also at 100M + 3 rows and on inputs offset by one element.  B4
           at 1024-, 4096- and 16384-key tiles (16 keys a thread); B5 with
           6 streams and with none; B6 counts only, with 6 streams, and
           skewed (partitions past 4096 rows and a hot group in each)
  e2e      connect() on CUDA, a 100M-row table of the synthetic benchmark's
           schema loaded on the device, eleven SELECTs through db.sql(),
           each checked against numpy and timed; the kernel launch counters
           must rise on this path, each query on its own route
  hot_key  a 4M-row table where 60 % of the rows share one key of a 2^22
           key space: the radix tier flags the partition overflow and the
           query reruns on the sort tier, still equal to numpy
Then the kernel summary line, the card line, and the final
{"ok": true, "device": ...} line.  Any failure exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from heavydb_tpu_torch.tools.synthetic import QUERIES, load_bench

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


def run_kernels(n: int, rate: float):
    from heavydb_tpu_torch.kernels import _plain, groupby_minmax, lane_agg, radix_hist

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    shapes = []
    stream_sets = {
        "lane_agg": ["count", "sumi", "sumf", "sumd", "min", "max"],
        "radix_hist": ["count", "sumi", "sumf", "sumd"],
    }
    for name, fn, slots_list in (
        ("lane_agg", lane_agg.lane_agg, (10, 100, 256)),
        ("radix_hist", radix_hist.fused_hist, (1000, 10_000, 65_536)),
    ):
        for num_slots in slots_list:
            gid, mask, vals = kernel_inputs(n, num_slots, gen)
            streams = [(vals[op], op) for op in stream_sets[name]]
            del vals
            got = fn(gid, mask, streams, num_slots)
            want = _plain.scatter_scan(gid, mask, streams, num_slots)
            err = 0.0
            for (_, op), g, w in zip([(None, "count")] + streams, got, want):
                err = max(err, agree(g, w, F32_TOL if op == "sumf" else
                                     (F64_TOL if op == "sumd" else None)))
            del got, want
            ms = timed(lambda: fn(gid, mask, streams, num_slots), 10)
            plain_ms = timed(lambda: _plain.scatter_scan(gid, mask, streams,
                                                         num_slots), 3)
            # yardstick: per-slot counts alone, the kernel with no streams
            # against torch.bincount (unmasked gid)
            count_ms = timed(lambda: fn(gid, None, [], num_slots), 10)
            bincount_ms = timed(lambda: torch.bincount(gid, minlength=num_slots), 10)
            read = n * (gid.element_size() + mask.element_size()
                        + sum(v.element_size() for v, _ in streams))
            write = num_slots * (8 + sum(out_bytes(v, op) for v, op in streams))
            shapes.append(dict(
                kernel=name, rows=n, slots=num_slots,
                streams=stream_sets[name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=(read + write) / rate * 1e3,
                counts_only_ms=count_ms, bincount_ms=bincount_ms,
                counts_only_bound_ms=(n * 4 + num_slots * 8) / rate * 1e3,
            ))
            del gid, mask, streams
    for num_slots in (1000, 4096):
        gid, _, vals = kernel_inputs(n, num_slots, gen)
        cm, i32, f32 = vals["count"], vals["min"], vals["max"]
        del vals
        for v in (i32, f32):
            for is_min in (True, False):
                got = groupby_minmax.minmax_per_slot(gid, v, cm, num_slots, is_min)
                want = groupby_minmax.minmax_per_slot_plain(gid, v, cm,
                                                            num_slots, is_min)
                agree(got, want)
        ms = timed(lambda: groupby_minmax.minmax_per_slot(
            gid, f32, cm, num_slots, False), 10)
        plain_ms = timed(lambda: groupby_minmax.minmax_per_slot_plain(
            gid, f32, cm, num_slots, False), 3)
        idx = _plain.slot_index(gid, cm, num_slots)
        buf = torch.full((num_slots + 1,), float("-inf"), device="cuda")
        library_ms = timed(lambda: buf.scatter_reduce(0, idx, f32, "amax"), 10)
        read = n * (4 + 1 + 4)
        shapes.append(dict(
            kernel="groupby_minmax", rows=n, slots=num_slots,
            streams=["max float32"], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=(read + num_slots * 4) / rate * 1e3, library_ms=library_ms,
        ))
        del gid, cm, i32, f32, idx
    torch.cuda.empty_cache()
    return shapes


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
    """The atomic instructions of each B3a-c kernel as built
    (cuobjdump -sass of its library): whether the shared-memory f32 add of
    B3b is a native ATOMS add or a compare-and-swap loop."""
    import os
    import re
    import shutil

    from heavydb_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise FileNotFoundError("cuobjdump not found: the SASS phase cannot run")
    text = subprocess.run([tool, "-sass", _build._lib_path("groupby_slots")],
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
    res = {k: sorted(v) for k, v in out.items()}
    f32 = [ops for k, ops in res.items() if "SumF32Op" in k and "Lb1E" in k]
    return {"kernels": res,
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
}
# queries checked column by column as arrays (large results)
ARRAY_CHECKED = ("BH002", "BH003", "BH004", "Q10M_AGGS")

# result columns of each query that are FLOAT sums (float32 tolerance)
F32_RESULT_COLS = {"Q100_MINMAX": {2}, "Q10K": {2}, "Q10M_AGGS": {3}}


def check_arrays(name, rs, h) -> int:
    keys, want = expected_arrays(name, h)
    got_keys = rs.column_raw(0)
    order = np.argsort(got_keys, kind="stable")
    if not np.array_equal(got_keys[order], keys):
        raise AssertionError(f"{name}: {got_keys.shape[0]} keys, numpy has "
                             f"{keys.shape[0]}, or they differ")
    for j, w in enumerate(want):
        col = j + 1
        g = rs.column_raw(col)[order]
        tol = F32_TOL if col in F32_RESULT_COLS.get(name, ()) else (
            F64_TOL if w.dtype.kind == "f" and g.dtype == np.float64 else None)
        agree(torch.from_numpy(np.ascontiguousarray(g)),
              torch.from_numpy(np.ascontiguousarray(w.astype(g.dtype))), tol)
    return keys.shape[0]


def check_result(name, rs, h) -> int:
    if name in ARRAY_CHECKED:
        return check_arrays(name, rs, h)
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
                tol = F32_TOL if col in F32_RESULT_COLS.get(name, ()) else F64_TOL
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
        for kname, d in zip(KERNEL_NAMES, delta):
            if (d > 0) != (kname in ROUTES[name]):
                raise AssertionError(
                    f"{name}: {kname} launched {d} times; expected the "
                    f"route to use {sorted(ROUTES[name]) or 'no kernel'}")
        out.append(dict(query=name, rows_out=nrows, first_with_decode_ms=first_ms,
                        warm_ms=warm, rows_per_s=n / (warm / 1e3),
                        warm_with_decode_ms=e2e_ms,
                        launches=dict(zip(KERNEL_NAMES, delta))))
    total = launches()
    return dict(rows=n, fragments=n_frags, make_and_load_s=make_and_load_s,
                card=card, queries=out), total, db


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


def main() -> None:
    card = smi()
    rate = mem_rate(card)
    from heavydb_tpu_torch.kernels import (_build, gate, groupby_minmax, groupby_slots,
                                           lane_agg, radix_groupby, radix_hist,
                                           tile_sort)

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc})
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
    emit({"phase": "sass", **sass_atomics()})
    slot_shapes, slot_launches = run_slot_kernels(ROWS, rate)
    shapes = run_kernels(ROWS, rate) + slot_shapes + run_sort_kernels(ROWS, rate)
    for s in shapes:
        emit({"phase": "kernels", **s})
    counters = [lane_agg.lane_agg, radix_hist.fused_hist,
                groupby_minmax.minmax_per_slot, tile_sort.sort_tiles,
                radix_groupby.radix_partition, radix_groupby.radix_group,
                groupby_slots.count_per_slot, groupby_slots.sum_f32_per_slot,
                groupby_slots.sum_int_per_slot]
    e2e, total, db = run_e2e(ROWS, card, counters)
    emit({"phase": "e2e", **e2e})
    launched = dict(zip(KERNEL_NAMES, total))
    # every kernel of an SQL route ran; B4's network runs inside radix_group
    if min(launched[k] for k in set().union(*ROUTES.values())) < 1:
        raise AssertionError(f"a kernel never launched on the main path: {launched}")
    emit({"phase": "hot_key", **run_hot_key(db, counters)})
    del db
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
    emit({"kernels": rows})


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        sys.exit(2)
    main()
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
