"""Radix-partition group-by of huge or sparse dense key spaces (kernels B5
and B6, entry point `sparse_groupby`).

Port of heavydb_tpu/kernels/radix_groupby.py.  csrc/radix_groupby.cu
holds both kernels:

- `radix_partition` (B5, TPU `_partition_call`): a histogram of the
  2^pbits partitions, then one or two levels of at most 256 buckets
  (`level_bits`) that move every valid row's biased hash hb and its
  streams, a tile of PART_TILE rows at a time ranked in shared memory, in
  whole runs into one exactly sized region per partition; two levels go
  through a scratch copy of hb and the streams;
- `radix_group` (B6, TPU `_groupby_call`): a block inserts its
  partition's keys into a hash table in shared memory, sorts only the
  distinct keys (B4's network) to rank the groups, adds each operand per
  rank with shared-memory atomics, and writes compacted per-group records
  in hash order.  Two launches: partitions of at most SMALL_TILE rows,
  then the rest up to GROUP_TILE (`group_launch`).

Contract of `sparse_groupby(gid, streams, num_slots, cap)`: rows whose gid
lies outside [0, num_slots) are dropped.  `streams` are (values, op) with
the stream classes of kernels/lane_agg.py: count (bool), sumi (int),
sumf (float32), sumd (float32/64), min / max (int32/float32; rows that
must not contribute hold the identity, +-inf or the int32 bound).  Returns
(gid_out int32[cap], len_out int64[cap], totals[cap]..., num_groups,
overflow), totals being int64 for count / sumi, float32 for sumf, float64
for sumd and the value's dtype for min / max.  Groups come in ascending
order of h = gid * 0x9E3779B1 mod 2^32; entries past min(num_groups, cap)
are 0.  num_groups is exact even above cap.  overflow bit 0: a partition
held more rows than GROUP_TILE, results are invalid, rerun on the sort
tier; bit 1: num_groups > cap, retry with cap >= num_groups.  The TPU's
16-bit limbs and double-single pairs, and with them the limb bound
MAX_SEG_INT, do not exist here.

CPU tensors take the plain version (`sparse_groupby_plain`, the port's
copy of the reference's numpy specification `_ref_sparse_groupby`); CUDA
tensors launch the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from heavydb_tpu_torch.kernels import _build, _plain

_MULT = 0x9E3779B1
_INV = pow(_MULT, -1, 1 << 32)
# most rows a B6 block groups: 8192 x 18.5 B = 148 KB of the 227 KB a
# block may use (radix_groupby.cu group_smem_bytes); a partition past it
# sets overflow bit 0
GROUP_TILE = 8192
# most rows of a partition in B6's first launch: 74 KB a block, three
# blocks an SM
SMALL_TILE = 4096
# B6's launches: (fewest, most) rows of the partitions each one groups
GROUP_LAUNCHES = ((0, SMALL_TILE), (SMALL_TILE + 1, GROUP_TILE))
# mean rows per partition the plan aims at: half a tile leaves room for the
# spread of a uniform hash (about +-2 % at 4096 rows)
_TARGET_FILL = GROUP_TILE // 2
# B5's histogram keeps 4 B per bucket in shared memory: 2^15 x 4 B = 128 KB
MAX_PART_BITS = 15
# most bits one B5 level partitions by: 256 buckets, so a tile's runs
# average PART_TILE / 256 = 64 rows
LEVEL_BITS = 8
# rows a B5 block ranks at once (radix_groupby.cu PT_TILE)
PART_TILE = 16384
MAX_STREAMS = _build.MAX_STREAMS


def plan(n: int) -> int:
    """Partition bits for n input rows: P = 2^pbits partitions of about
    _TARGET_FILL rows each (at most 2^MAX_PART_BITS)."""
    if n <= _TARGET_FILL:
        return 0
    return min(MAX_PART_BITS, math.ceil(math.log2(n / _TARGET_FILL)))


def level_bits(pbits: int):
    """B5's levels for 2^pbits partitions: (p1, p2) bits, level 1 by the
    top p1 bits and level 2 by the next p2 (p2 = 0: one level).  Above
    LEVEL_BITS, p1 = ceil(pbits / 2), as the reference's `_plan` splits."""
    if pbits <= LEVEL_BITS:
        return pbits, 0
    p1 = (pbits + 1) // 2
    return p1, pbits - p1


def group_launch(counts):
    """Index into GROUP_LAUNCHES of the B6 launch that groups each
    partition of `counts` rows; -1 where no launch does (more rows than
    GROUP_TILE: overflow bit 0)."""
    out = torch.full_like(counts, -1)
    for j, (lo, hi) in enumerate(GROUP_LAUNCHES):
        out = torch.where((counts >= lo) & (counts <= hi), j, out)
    return out


def _check(gid, streams, num_slots: int, cap: int):
    if not 0 < num_slots < 2**31:
        raise ValueError(f"sparse_groupby: {num_slots} slots outside 1..2^31-1")
    if cap < 1:
        raise ValueError("sparse_groupby: cap must be positive")
    if len(streams) > MAX_STREAMS:
        raise ValueError(f"sparse_groupby: at most {MAX_STREAMS} streams")
    _build.check_rows(gid, None, [v for v, _ in streams])
    for v, op in streams:
        if str(v.dtype).replace("torch.", "") not in _build._ALLOWED.get(op, ()):
            raise ValueError(f"sparse_groupby: stream {op!r} does not take "
                             f"{v.dtype}")


def _total_dtype(v, op):
    if op in ("count", "sumi"):
        return torch.int64
    if op == "sumf":
        return torch.float32
    if op == "sumd":
        return torch.float64
    return v.dtype


def record_dtype(v, op):
    """dtype of B6's per-row stage and per-group record of stream (v, op):
    MIN / MAX records are int32 order keys until radix_group decodes them."""
    return torch.int32 if op in ("min", "max") else _total_dtype(v, op)


def sparse_groupby(gid, streams, num_slots: int, cap: int):
    streams = [(v.contiguous(), op) for v, op in streams]
    _check(gid, streams, num_slots, cap)
    if gid.device.type == "cpu":
        return sparse_groupby_plain(gid, streams, num_slots, cap)
    if gid.device.type != "cuda":
        raise ValueError(f"sparse_groupby: no kernel for device {gid.device}")
    pbits = plan(gid.shape[0])
    hb, parts, counts, offsets = radix_partition(gid, streams, num_slots, pbits)
    return radix_group(hb, parts, [op for _, op in streams], counts, offsets,
                       cap)


def _stream_set(vals, outs, ops) -> _build.StreamSet:
    ss = _build.StreamSet()
    ss.n = len(vals)
    for j, (v, o, op) in enumerate(zip(vals, outs, ops)):
        ss.vals[j] = v.data_ptr()
        ss.out[j] = o.data_ptr()
        ss.op[j] = _build.OP_CODES[op]
        ss.dt[j] = _build.DT_CODES[str(v.dtype).replace("torch.", "")]
    return ss


def radix_partition(gid, streams, num_slots: int, pbits: int):
    """B5 on CUDA: (hb int32[n], partitioned streams [n] each, counts
    int64[P], offsets int64[P]).  Partition p holds rows
    [offsets[p], offsets[p] + counts[p]); entries past the valid rows are
    unset.  With two levels (`level_bits`) it takes a scratch copy of hb
    and the streams, n x (4 + stream bytes), for the time of the call: it
    is freed before `radix_group` allocates its stage arrays, n x (12 +
    record bytes), larger for every stream class (`record_dtype`), so it
    does not raise `sparse_groupby`'s peak memory.  CPU tensors take `radix_partition_plain` (its arrays hold only the
    valid rows)."""
    if gid.device.type == "cpu":
        return radix_partition_plain(gid, streams, num_slots, pbits)
    if gid.device.type != "cuda":
        raise ValueError(f"radix_partition: no kernel for device {gid.device}")
    dev = gid.device
    n = gid.shape[0]
    P = 1 << pbits
    counts = torch.zeros(P, dtype=torch.int64, device=dev)
    hb = torch.empty(n, dtype=torch.int32, device=dev)
    parts = [torch.empty_like(v) for v, _ in streams]
    if n == 0:
        return hb, parts, counts, torch.zeros_like(counts)
    fn = _build.entry("radix_groupby")
    sp = _build.stream_ptr(dev)
    vals = [v for v, _ in streams]
    ops = [op for _, op in streams]
    _, p2 = level_bits(pbits)

    def run(keys, outs, ins, dst_hb, offsets, cursor, pass_, what):
        ss = _stream_set(ins, outs, ops)
        with torch.cuda.device(dev):
            _build.check(fn.partition(
                keys.data_ptr(), n, num_slots, pbits, p2, counts.data_ptr(),
                None if offsets is None else offsets.data_ptr(),
                None if cursor is None else cursor.data_ptr(),
                None if dst_hb is None else dst_hb.data_ptr(), ctypes.byref(ss),
                pass_, sp), f"radix_partition {what}")

    run(gid, [], [], None, None, None, 0, "histogram")
    offsets = torch.cumsum(counts, 0) - counts
    cursor = offsets.clone()
    if p2 == 0:
        run(gid, parts, vals, hb, offsets, cursor, 1, "level 1")
    else:
        s_hb = torch.empty_like(hb)
        s_parts = [torch.empty_like(v) for v in vals]
        run(gid, s_parts, vals, s_hb, offsets, cursor, 1, "level 1")
        cursor.copy_(offsets)
        run(s_hb, parts, s_parts, hb, offsets, cursor, 2, "level 2")
    _build.count_launch(radix_partition)
    return hb, parts, counts, offsets


radix_partition.launches = 0


def radix_group(hb, parts, ops, counts, offsets, cap: int):
    """B6 on CUDA over B5's partitions: (gid_out, len_out, totals,
    num_groups int64, overflow int32)."""
    dev = hb.device
    n = hb.shape[0]
    P = counts.shape[0]
    stage_hb = torch.empty(n, dtype=torch.int32, device=dev)
    stage_len = torch.empty(n, dtype=torch.int64, device=dev)
    rec_dt = [record_dtype(v, op) for v, op in zip(parts, ops)]
    stage = [torch.empty(n, dtype=dt, device=dev) for dt in rec_dt]
    ng_part = torch.zeros(P, dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    gid_out = torch.zeros(cap, dtype=torch.int32, device=dev)
    len_out = torch.zeros(cap, dtype=torch.int64, device=dev)
    keys_out = [torch.zeros(cap, dtype=dt, device=dev) for dt in rec_dt]
    fn = _build.entry("radix_groupby")
    sp = _build.stream_ptr(dev)
    ss_parts = _stream_set(parts, stage, ops)
    ss_stage = _stream_set(stage, keys_out, ops)
    if n:
        # one block per partition, then one persistent block per SM that
        # skips the partitions the first launch took
        grids = (P, _build.grid_for(P, dev, 1, 1))
        for (lo, hi), grid in zip(GROUP_LAUNCHES, grids):
            with torch.cuda.device(dev):
                _build.check(fn.group(hb.data_ptr(), ctypes.byref(ss_parts), None,
                                      counts.data_ptr(), offsets.data_ptr(), P,
                                      lo, hi, GROUP_TILE, stage_hb.data_ptr(),
                                      stage_len.data_ptr(), ng_part.data_ptr(),
                                      flag.data_ptr(), None, cap, None, None, 0,
                                      grid, sp), "radix_group")
        _build.count_launch(radix_group)
    ng64 = ng_part.to(torch.int64)
    goff = torch.cumsum(ng64, 0) - ng64
    num_groups = ng64.sum()
    if n:
        with torch.cuda.device(dev):
            _build.check(fn.group(None, None, ctypes.byref(ss_stage),
                                  counts.data_ptr(), offsets.data_ptr(), P, 0, 0,
                                  GROUP_TILE, stage_hb.data_ptr(),
                                  stage_len.data_ptr(), ng_part.data_ptr(), None,
                                  goff.data_ptr(), cap, gid_out.data_ptr(),
                                  len_out.data_ptr(), 1, P, sp), "radix_group compact")
    totals = []
    for v, op, o in zip(parts, ops, keys_out):
        if op in ("min", "max"):
            # unset entries hold key 0, which decodes to 0 / +0.0
            o = _build.decode_keys(o, v.dtype)
        totals.append(o)
    overflow = flag[0] + 2 * (num_groups > cap).to(torch.int32)
    return gid_out, len_out, totals, num_groups, overflow


radix_group.launches = 0


def kernel_info() -> dict:
    """Registers, local and shared bytes, resident blocks per SM and
    threads of B5's and B6's kernels as they are launched at 2^15
    partitions, B5's levels with 4- and 8-byte widest columns (CUDA
    only)."""
    fn = _build.entry("radix_groupby")
    return {name: _build.launch_info(
        lambda out, w=which, a=arg: fn.info(w, a, out), name)
        for name, which, arg in (
            ("part_hist_kernel", 0, MAX_PART_BITS),
            ("part_l1_kernel, 4-byte columns", 1, 4),
            ("part_l1_kernel, 8-byte columns", 1, 8),
            ("part_l2_kernel, 4-byte columns", 4, 4),
            ("part_l2_kernel, 8-byte columns", 4, 8),
            (f"group_kernel <= {SMALL_TILE} rows", 2, SMALL_TILE),
            (f"group_kernel <= {GROUP_TILE} rows", 2, GROUP_TILE),
            ("compact_kernel", 3, 0))}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def radix_partition_plain(gid, streams, num_slots: int, pbits: int):
    """B5's contract in plain torch: the valid rows' hb and streams in
    partition order (input order inside a partition, which the kernel does
    not promise), counts and offsets."""
    valid = (gid >= 0) & (gid < num_slots)
    h = (gid[valid].to(torch.int64) * _MULT) & 0xFFFFFFFF
    part = (h >> (32 - pbits)) if pbits else torch.zeros_like(h)
    order = torch.argsort(part, stable=True)
    counts = torch.bincount(part, minlength=1 << pbits)
    hb = (h[order] ^ 0x80000000).to(torch.int32)
    parts = [v[valid][order] for v, _ in streams]
    return hb, parts, counts, torch.cumsum(counts, 0) - counts


def sparse_groupby_plain(gid, streams, num_slots: int, cap: int):
    """The port's copy of the reference's numpy specification
    `_ref_sparse_groupby`: the same outputs, order and overflow bits, with
    bit 0 taken at the port's partition capacity (a partition of `plan`
    holding more than GROUP_TILE rows)."""
    dev = gid.device
    valid = (gid >= 0) & (gid < num_slots)
    g = gid[valid].to(torch.int64)
    h = (g * _MULT) & 0xFFFFFFFF
    order = torch.argsort(h, stable=True)
    hs = h[order]
    first = torch.ones(hs.shape[0], dtype=torch.bool, device=dev)
    first[1:] = hs[1:] != hs[:-1]
    seg = torch.cumsum(first, 0) - 1
    ng = int(first.sum())
    m = min(ng, cap)
    gid_out = torch.zeros(cap, dtype=torch.int32, device=dev)
    gid_out[:m] = ((hs[first][:m] * _INV) & 0xFFFFFFFF).to(torch.int32)
    len_out = torch.zeros(cap, dtype=torch.int64, device=dev)
    cnt = torch.bincount(seg, minlength=ng)
    len_out[:m] = cnt[:m]
    pbits = plan(gid.shape[0])
    part = (h >> (32 - pbits)) if pbits else torch.zeros_like(h)
    hard = int(torch.bincount(part, minlength=1).max()) > GROUP_TILE \
        if h.numel() else False
    totals = []
    for v, op in streams:
        sv = v[valid][order]
        if op in ("min", "max"):
            acc = torch.full((max(ng, 1),), _plain.minmax_ident(v.dtype, op == "min"),
                             dtype=v.dtype, device=dev)
            acc.scatter_reduce_(0, seg, sv, "amin" if op == "min" else "amax")
        else:
            wide = torch.float64 if op in ("sumf", "sumd") else torch.int64
            acc = torch.zeros(max(ng, 1), dtype=wide, device=dev)
            acc.index_add_(0, seg, sv.to(wide))
            acc = acc.to(_total_dtype(v, op))
        out = torch.zeros(cap, dtype=acc.dtype, device=dev)
        out[:m] = acc[:m]
        totals.append(out)
    overflow = int(hard) + (2 if ng > cap else 0)
    return (gid_out, len_out, totals, torch.tensor(ng, device=dev),
            torch.tensor(overflow, dtype=torch.int32, device=dev))
