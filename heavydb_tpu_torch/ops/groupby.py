"""Group-by building blocks for the keyless, perfect-hash and sort
strategies.

Port of heavydb_tpu/ops/groupby.py: `perfect_group_ids`, the segment
reductions `segment_count` / `segment_sum` / `segment_minmax`,
`_shared_scan`, the dispatcher to the group-by kernels, the sort tier
(`sort_group_rows`, `SortedSegments`), the hash tier's
`pack_group_keys`, `hash_group_ids` and `unpack_group_keys`, and the
aggregates over distinct values, quantiles, modes and HyperLogLog
registers (`distinct_count_per_group`, `distinct_sum_per_group`,
`quantile_per_group`, `mode_per_group`, `hll_registers`,
`hll_estimate`), in plain torch as the reference's are plain XLA; their
scatters send the rows that add nothing to spare cells, so that no
address takes them all.  The routing is the
reference's TPU routing, with "the Pallas kernels are available" read as
"the tensors are on CUDA"; the same routing runs on the CPU, where every
kernel wrapper takes its plain version:

  count/sum streams, 2..256 slots        -> kernels/lane_agg (B1)
  count/sum streams, 257..65536 slots    -> kernels/radix_hist (B2)
  MIN/MAX of <=4-byte values, 33..256    -> kernels/lane_agg (B1)
  MIN/MAX of <=4-byte values, 257..4096  -> kernels/groupby_minmax (B3)
  everything else (<=32 slots in the segment_* calls, 8-byte MIN/MAX,
  more than 65536 slots)                 -> plain torch index_add_ /
                                            scatter_reduce_
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from heavydb_tpu_torch.kernels import _plain, groupby_minmax, lane_agg, radix_hist

TV = Tuple[object, Optional[object]]

SMALL_SLOTS = 32
# the largest slot count the fused kernels take (B2's bound)
SHARED_SCAN_MAX_SLOTS = radix_hist.MAX_SLOTS

_TORCH_DT = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """torch dtype of a numpy dtype (or a torch dtype, unchanged)."""
    if isinstance(dt, torch.dtype):
        return dt
    return _TORCH_DT[np.dtype(dt)]


def perfect_group_ids(key_tvs: Sequence[TV],
                      ranges: Sequence[Tuple[int, int, bool, int]], mask):
    """Positional group id for dense key spaces.  ranges: (min, extent,
    has_nulls, bucket) per key.  A NULL key (when has_nulls) maps to the
    extra coordinate `extent`; masked rows get the id `total` (out of
    range).  Returns (gid int32, total_slots)."""
    total = 1
    for (_, extent, has_nulls, _) in ranges:
        total *= extent + (1 if has_nulls else 0)
    # int32 arithmetic when every key is <=4 bytes and the slot space fits:
    # only null and padding rows can wrap, and those are replaced below
    narrow = total < 2**31 and all(
        torch.is_tensor(v) and v.element_size() <= 4 and not v.is_floating_point()
        and -2**31 < mn < 2**31
        for (v, _), (mn, *_r) in zip(key_tvs, ranges))
    work = torch.int32 if narrow else torch.int64
    gid = None
    for (val, valid), (mn, extent, has_nulls, bucket) in zip(key_tvs, ranges):
        if torch.is_tensor(val) and val.is_floating_point():
            # exact-integer float keys (CAST(int AS DOUBLE)); NaN = null
            val = torch.nan_to_num(val).to(torch.int64)
        iv = torch.as_tensor(val).to(work) - mn
        if bucket > 1:
            iv = torch.div(iv, bucket, rounding_mode="floor")
        iv = iv.clamp(0, extent - 1)
        span = extent + (1 if has_nulls else 0)
        if has_nulls and valid is not None:
            iv = torch.where(valid, iv, extent)
        gid = iv if gid is None else gid * span + iv
    gid = gid.to(torch.int32)
    if mask is not None:
        gid = torch.where(mask, gid, total)
    return gid, total


def _shared_scan(gid, mask, streams, num_slots: int):
    """One fused pass of count/sum streams ([(values, op)], op in count,
    sumi, sumf, sumd): B1 up to 256 slots, B2 up to 65536, plain torch
    above.  Returns [counts int64[S]] + per stream (count/sumi -> int64,
    sumf/sumd -> float64)."""
    gid = gid.to(torch.int32).contiguous()
    streams = [(v.contiguous(), op) for v, op in streams]
    if num_slots <= lane_agg.MAX_SLOTS:
        return lane_agg.lane_agg(gid, mask, streams, num_slots)
    if num_slots <= radix_hist.MAX_SLOTS:
        return radix_hist.fused_hist(gid, mask, streams, num_slots)
    return _plain.scatter_scan(gid, mask, streams, num_slots)


def _ones_mask(gid):
    return torch.ones(gid.shape[0], dtype=torch.bool, device=gid.device)


def segment_count(gid, contrib_mask, num_slots: int):
    cm = contrib_mask if contrib_mask is not None else _ones_mask(gid)
    if num_slots == 1:
        return cm.sum(dtype=torch.int64).reshape(1)
    if num_slots <= SMALL_SLOTS or num_slots > SHARED_SCAN_MAX_SLOTS:
        return _plain.scatter_scan(gid, cm, [], num_slots)[0]
    return _shared_scan(gid, cm, [], num_slots)[0]


def sum_stream(values, acc_dtype: np.dtype):
    """(values, op) of a sum stream accumulating in `acc_dtype`: exact int64
    for integer accumulators, float32 partials for FLOAT, float64 for
    DOUBLE (float32 values are read as they are, not widened first)."""
    v = torch.as_tensor(values)
    if acc_dtype.kind in "iu":
        return (v.to(torch_dtype(acc_dtype)) if v.is_floating_point() else v,
                "sumi")
    if acc_dtype.itemsize == 4:
        return v.to(torch.float32), "sumf"
    if v.dtype not in (torch.float32, torch.float64):
        v = v.to(torch.float64)
    return v, "sumd"


def segment_sum(gid, values, contrib_mask, num_slots: int, acc_dtype):
    acc_dtype = np.dtype(acc_dtype)
    acc_t = torch_dtype(acc_dtype)
    cm = contrib_mask if contrib_mask is not None else _ones_mask(gid)
    if num_slots == 1:
        v = torch.as_tensor(values).to(acc_t)
        return torch.where(cm, v, 0).sum(dtype=acc_t).reshape(1)
    # rows outside cm are masked out of the pass, so v needs no zeroing
    streams = [sum_stream(values, acc_dtype)]
    if num_slots <= SMALL_SLOTS or num_slots > SHARED_SCAN_MAX_SLOTS:
        res = _plain.scatter_scan(gid, cm, streams, num_slots)
    else:
        res = _shared_scan(gid, cm, streams, num_slots)
    return res[1].to(acc_t)


def segment_minmax(gid, values, contrib_mask, num_slots: int, is_min: bool):
    v = torch.as_tensor(values)
    cm = contrib_mask if contrib_mask is not None else _ones_mask(gid)
    # the kernels take 4-byte values: narrower ones (and bool) widen to int32
    w = v if v.element_size() >= 4 else v.to(torch.int32)
    if num_slots == 1:
        vv = torch.where(cm, w, _plain.minmax_ident(w.dtype, is_min))
        return (vv.amin() if is_min else vv.amax()).reshape(1).to(v.dtype)
    g32 = gid.to(torch.int32).contiguous()
    if SMALL_SLOTS < num_slots and w.element_size() == 4:
        if num_slots <= lane_agg.MAX_SLOTS:
            op = "min" if is_min else "max"
            out = lane_agg.lane_agg(g32, cm.contiguous(), [(w.contiguous(), op)],
                                    num_slots)
            return out[1].to(v.dtype)
        if num_slots <= groupby_minmax.MAX_SLOTS:
            return groupby_minmax.minmax_per_slot(
                g32, w.contiguous(), cm.contiguous(), num_slots, is_min
            ).to(v.dtype)
    idx = _plain.slot_index(g32, cm, num_slots)
    return _plain.scatter_minmax(idx, w, num_slots, is_min).to(v.dtype)


# ---------------------------------------------------------------------------
# the sort tier
# ---------------------------------------------------------------------------


def compact_perm(mask):
    """Stable permutation putting mask=True rows first: prefix sum and one
    scatter, no sort (out_position[i] = cumsum(mask)[i] - 1 for kept
    rows)."""
    n = mask.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=mask.device)
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    target = torch.where(mask, pos, n)  # dropped rows land past the end
    perm = torch.zeros(n + 1, dtype=torch.int64, device=mask.device)
    perm.scatter_(0, target, rows)
    return perm[:n]


def _flush_subnormals(v):
    """Floats whose magnitude is below the smallest normal (subnormals and
    -0.0) as +0.0: the reference's XLA compares with subnormals flushed to
    zero, so they equal 0.0 in its keys and distinct values."""
    tiny = torch.finfo(v.dtype).tiny
    return torch.where(v.abs() < tiny, torch.zeros((), dtype=v.dtype, device=v.device), v)


def _canonical_key(val, valid):
    """(null_flag int8, canonical value) sort operands of one key column:
    NaN, -0.0 and subnormals become 0 so they cannot split a group, NULL
    rows get their own flag (and value 0), booleans sort as int8."""
    v = torch.as_tensor(val)
    if v.dtype == torch.bool:
        v = v.to(torch.int8)
    if v.is_floating_point():
        v = torch.where(torch.isnan(v), torch.zeros((), dtype=v.dtype, device=v.device),
                        _flush_subnormals(v))
    if valid is None:
        return None, v
    nullf = (~valid).to(torch.int8)
    return nullf, torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                                    device=v.device))


def _lex_sort_perm(operands):
    """Permutation that sorts rows lexicographically by `operands` (most
    significant first), stably: one stable torch.sort pass per operand,
    least significant first."""
    n = operands[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=operands[0].device)
    for op in reversed(operands):
        _, p = torch.sort(op[perm], stable=True)
        perm = perm[p]
    return perm


def sort_group_rows(key_tvs: Sequence[TV], mask, cap, payloads=(),
                    need_rows: bool = True):
    """Sort-based grouping that keeps the sorted row domain; payload row
    arrays (aggregate arguments and validities) ride the same permutation.
    Rows outside `mask` sort last.  `cap` is the group domain's size, or a
    function of the exact group count (a 0-d tensor) that returns it, called
    once that count is known and before any group id is clamped.

    Returns (sgid, s_rows, s_domain, changed, num_groups, sorted_keys,
    sorted_payloads):
      sgid[N] int64        contiguous group id per sorted row (cap for
                           rows out of the domain or past cap)
      s_rows[N] int64      original row of each sorted position
      s_domain[N] bool     in-domain rows (sorted first)
      changed[N] bool      first sorted row of each group
      num_groups           0-d tensor, exact even above cap
      sorted_keys          per key (canonical value, valid) in sorted order
      sorted_payloads      the payloads in sorted order
    """
    n = torch.as_tensor(key_tvs[0][0]).shape[0]
    operands = []
    dom_idx = None
    if mask is not None:
        dom_idx = len(operands)
        operands.append((~mask).to(torch.int8))
    key_ops = []  # (null operand index or None, value operand index)
    for val, valid in key_tvs:
        nullf, v = _canonical_key(val, valid)
        ni = None
        if nullf is not None:
            ni = len(operands)
            operands.append(nullf)
        key_ops.append((ni, len(operands)))
        operands.append(v)
    perm = _lex_sort_perm(operands)
    sorted_ops = [o[perm] for o in operands]
    device = perm.device
    s_domain = (sorted_ops[dom_idx] == 0) if dom_idx is not None \
        else torch.ones(n, dtype=torch.bool, device=device)
    s_rows = perm if need_rows else torch.arange(n, device=device)
    sorted_pl = [torch.as_tensor(p)[perm] for p in payloads]
    changed = torch.zeros(n, dtype=torch.bool, device=device)
    changed[:1] = True
    for opnd in sorted_ops[1 if dom_idx is not None else 0:]:
        changed[1:] |= opnd[1:] != opnd[:-1]
    changed &= s_domain
    sgid = torch.cumsum(changed, 0) - 1
    num_groups = changed.sum()
    if callable(cap):
        cap = cap(num_groups)
    sgid = torch.where(s_domain, sgid.clamp(max=cap), cap)
    sorted_keys = []
    for ni, vi in key_ops:
        valid_s = (sorted_ops[ni] == 0) if ni is not None \
            else torch.ones(n, dtype=torch.bool, device=device)
        sorted_keys.append((sorted_ops[vi], valid_s))
    return (sgid, s_rows, s_domain, changed, num_groups, sorted_keys,
            sorted_pl)


class _Deferred:
    """Placeholder for a per-group array that materializes after the
    shared compaction (SortedSegments.flush)."""

    def __init__(self, idx: int, post):
        self.idx = idx
        self.post = post


class SortedSegments:
    """Sorted-domain counterpart of the segment_* functions of this module
    (the `segs` hook of ops.agg).  gid arguments are the contiguous sorted
    sgid; values and masks arrive in sorted order.

    Counts and sums become prefix sums whose value at each group's first
    row is deferred; one compaction (group-start rows first, group order
    kept) then materializes every deferred array at [cap], and a group's
    total is the difference of adjacent prefixes.  MIN/MAX reduce straight
    into [cap] by the contiguous group id."""

    def __init__(self, changed, s_domain, num_groups, cap: int):
        self.changed = changed
        self.s_domain = s_domain
        self.num_groups = num_groups
        self.cap = cap
        self._pending = []  # sorted-domain arrays, read at group-start rows
        self._compacted = []

    # -- deferral plumbing --
    def defer(self, start_vals, post=None):
        self._pending.append(torch.as_tensor(start_vals))
        return _Deferred(len(self._pending) - 1, post)

    def flush(self):
        """One compaction permutation materializes every pending array."""
        if not self._pending:
            return
        perm = compact_perm(self.changed)[: self.cap]
        comp = []
        for p in self._pending:
            c = p[perm]
            if c.shape[0] < self.cap:
                # a row domain shorter than the cap: entries past
                # num_groups are unused, so zeros will do
                c = torch.cat([c, torch.zeros(self.cap - c.shape[0],
                                              dtype=c.dtype, device=c.device)])
            comp.append(c)
        self._compacted = comp

    def resolve(self, obj):
        if isinstance(obj, _Deferred):
            c = self._compacted[obj.idx]
            return obj.post(c) if obj.post is not None else c
        return obj

    def _prefix_total(self, c, out_dtype):
        """Defer an inclusive prefix sum c: compacted entry g is the prefix
        before group g, and a group's total is the next entry minus its
        own (the last group closes against the grand total)."""
        cprev = torch.cat([torch.zeros(1, dtype=c.dtype, device=c.device),
                           c[:-1]])
        total = c[-1]
        ng = self.num_groups
        cap = self.cap

        def post(cp):
            gi = torch.arange(cap, device=cp.device)
            nxt = torch.where(gi + 1 < ng, torch.cat([cp[1:], cp[:1] * 0]),
                              total)
            return (nxt - cp).to(out_dtype)

        return self.defer(cprev, post)

    def _in_domain(self, gid, contrib_mask):
        cm = contrib_mask if contrib_mask is not None \
            else torch.ones(gid.shape[0], dtype=torch.bool, device=gid.device)
        return cm & self.s_domain

    # -- the segment_* surface --
    def segment_count(self, gid, contrib_mask, num_slots: int):
        cm = self._in_domain(gid, contrib_mask)
        return self._prefix_total(torch.cumsum(cm, 0, dtype=torch.int64),
                                  torch.int64)

    def segment_sum(self, gid, values, contrib_mask, num_slots: int,
                    acc_dtype):
        acc_dtype = np.dtype(acc_dtype)
        # float accumulators take float64 prefixes: a difference of two
        # float32 prefixes over millions of rows would carry an error of
        # the order of whole elements
        cum_t = torch.float64 if acc_dtype.kind == "f" else torch_dtype(acc_dtype)
        cm = self._in_domain(gid, contrib_mask)
        v = torch.as_tensor(values).to(cum_t)
        v = torch.where(cm, v, torch.zeros((), dtype=cum_t, device=v.device))
        return self._prefix_total(torch.cumsum(v, 0), torch_dtype(acc_dtype))

    def segment_minmax(self, gid, values, contrib_mask, num_slots: int,
                       is_min: bool):
        """Per-group MIN/MAX by the contiguous sorted group id; NaN
        propagates as in the reference's jnp.minimum / maximum scan."""
        v = torch.as_tensor(values)
        cm = self._in_domain(gid, contrib_mask)
        idx = torch.where(cm, gid.to(torch.int64), self.cap).clamp(max=self.cap)
        return _plain.scatter_minmax(idx, v, self.cap, is_min)

    # the aggregates over distinct values, quantiles and modes keep their
    # own formulations; the contiguous sorted sgid is a valid gid for them
    def _sorted_mask(self, mask):
        return self.s_domain if mask is None else mask & self.s_domain

    def distinct_count_per_group(self, gid, val_tv, mask, num_slots, allow_hash=True):
        return distinct_count_per_group(gid, val_tv, self._sorted_mask(mask), num_slots,
                                        allow_hash=allow_hash)

    def distinct_sum_per_group(self, gid, val_tv, mask, num_slots, acc_dt):
        return distinct_sum_per_group(gid, val_tv, self._sorted_mask(mask), num_slots,
                                      acc_dt)

    def hll_registers(self, gid, val_tv, mask, num_slots):
        return hll_registers(gid, val_tv, self._sorted_mask(mask), num_slots)

    def quantile_per_group(self, gid, val_tv, mask, num_slots, q):
        return quantile_per_group(gid, val_tv, self._sorted_mask(mask), num_slots, q)

    def mode_per_group(self, gid, val_tv, mask, num_slots):
        return mode_per_group(gid, val_tv, self._sorted_mask(mask), num_slots)


# ---------------------------------------------------------------------------
# COUNT / SUM / AVG (DISTINCT), APPROX_QUANTILE, MODE, APPROX_COUNT_DISTINCT
# ---------------------------------------------------------------------------

# the reference's uint64 constants as int64 bit patterns
_SM_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_SM_MUL1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_SM_MUL2 = 0x94D049BB133111EB - (1 << 64)
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_LN2 = math.log(2.0)
# log2 as the reference's XLA computes it: log(x) / log(2) with the
# division by a constant rewritten as a product with its reciprocal
_INV_LN2 = 1.0 / _LN2


def _srl(x, s: int):
    """Logical shift right of an int64 tensor, as uint64 would shift."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _contrib(mask, valid, n: int, device):
    cm = mask if mask is not None else torch.ones(n, dtype=torch.bool, device=device)
    return cm if valid is None else cm & valid


def _sort_pairs(g, v):
    """(g, v) sorted by g, then v, ascending (g int32 >= 0): one sort of an
    int64 key when v is 4 bytes or less (g in the high word, v's
    order-keeping 32 bits in the low one), else a stable sort an operand."""
    if v.element_size() <= 4:
        if v.is_floating_point():
            b = v.to(torch.float32).view(torch.int32).to(torch.int64)
            low = torch.where(b < 0, ~b, b | (1 << 31)) & 0xFFFFFFFF
        else:
            low = v.to(torch.int64) + (1 << 31)
        perm = torch.sort((g.to(torch.int64) << 32) | low).indices
    else:
        perm = _lex_sort_perm([g, v])
    return g[perm], v[perm]


def _run_starts(sg, sv):
    """True at the first row of each run of equal (g, v) pairs."""
    first = torch.ones(sg.shape[0], dtype=torch.bool, device=sg.device)
    first[1:] = (sg[1:] != sg[:-1]) | (sv[1:] != sv[:-1])
    return first


def _group_bounds(sg, num_slots: int):
    """int64[num_slots + 1]: the first sorted row of each group 0 ..
    num_slots (sg sorted ascending; rows out of every group hold
    num_slots)."""
    want = torch.arange(num_slots + 1, dtype=sg.dtype, device=sg.device)
    return torch.searchsorted(sg, want)


def _sum_by_bounds(x, bounds, dtype):
    """Per-group sums of the row values x over the sorted groups' row
    ranges, as differences of one prefix sum (no scatter)."""
    c = torch.cumsum(x.to(dtype), 0)
    c = torch.cat([torch.zeros(1, dtype=dtype, device=x.device), c])
    return c[bounds[1:]] - c[bounds[:-1]]


def bucket_pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 1)


def hash_group_ids(packed, mask, slots: int, rounds: int = 4):
    """Group ids of sparse int64 keys by slot claiming: each round, every
    unresolved key takes the smallest unresolved key hashed to its slot
    (one int64 scatter-min a round) and the rows of that key are resolved
    there; keys that lost re-hash in the next round.  All rows of a key
    follow the same slot sequence, so rows share an id if and only if
    their keys are equal.  The hash is the reference's 32-bit mix of the
    key's halves, round by round.

    Returns (gid int32 [n] in [0, total], total = rounds x slots (the id
    of masked and unresolved rows), the unresolved rows (int32 0-d), the
    key of each slot (int64 [total], INT64_MAX for a slot no key took))."""
    n = packed.shape[0]
    dev = packed.device
    total = rounds * slots
    unresolved = mask if mask is not None else torch.ones(n, dtype=torch.bool, device=dev)
    gid = torch.full((n,), total, dtype=torch.int32, device=dev)
    base = (packed & 0xFFFFFFFF) * 0x85EBCA6B + _srl(packed, 32) * 0xC2B2AE35
    big = torch.full((), _I64_MAX, dtype=torch.int64, device=dev)
    tables = []
    for r in range(rounds):
        h = (base + (0x9E3779B9 * (r + 1) & 0xFFFFFFFF)) & 0xFFFFFFFF
        h = h ^ (h >> 16)
        h = (h * 0x7FEB352D) & 0xFFFFFFFF
        h = h ^ (h >> 15)
        slot = h & (slots - 1)
        buf = torch.full((slots,), _I64_MAX, dtype=torch.int64, device=dev)
        buf.scatter_reduce_(0, slot, torch.where(unresolved, packed, big), "amin")
        won = unresolved & (buf[slot] == packed)
        gid = torch.where(won, (slot + r * slots).to(torch.int32), gid)
        unresolved = unresolved & ~won
        tables.append(buf)
    return gid, total, unresolved.sum(dtype=torch.int32), torch.cat(tables)


def pack_group_keys(key_tvs: Sequence[TV], spec):
    """One int64 a row for the hash group-by tier's claims.

    spec None: one key of any scalar type, packed as itself.  NULLs ride
    in-band as the value dtype's sentinel, so narrowing on unpack gives it
    back.  A FLOAT / DOUBLE key takes NaN as the NULL group and -0.0 and
    subnormals as +0.0 (the reference compares with subnormals flushed),
    then its bits.
    spec ((lo, span), ...): the key tuple range-packed, each key as 1 +
    (value - lo) clamped to [1, span + 1] with 0 for NULL, in base span + 2
    (the planner checks that the product fits 63 bits)."""
    if spec is None:
        val, valid = key_tvs[0]
        v = torch.as_tensor(val)
        if v.is_floating_point():
            isnull = torch.isnan(v) if valid is None else torch.isnan(v) | ~valid
            canon = torch.where(isnull, float("nan"), _flush_subnormals(v))
            if canon.dtype == torch.float64:
                return canon.view(torch.int64)
            return canon.to(torch.float32).view(torch.int32).to(torch.int64)
        p = v.to(torch.int64)
        if valid is not None:
            p = torch.where(valid, p, torch.iinfo(v.dtype).min)
        return p
    packed = None
    for (val, valid), (lo, span) in zip(key_tvs, spec):
        iv = (torch.as_tensor(val).to(torch.int64) - lo + 1).clamp(1, span + 1)
        if valid is not None:
            iv = torch.where(valid, iv, 0)
        packed = iv if packed is None else packed * (span + 2) + iv
    return packed


def unpack_group_keys(slot_keys, spec, group_types):
    """The inverse of `pack_group_keys` over the claim table's key of each
    slot: one (values, valid) a group key, valid None for a NOT NULL key.
    A slot no key took holds garbage; group presence filters it out."""
    if spec is None:
        ti = group_types[0]
        dt = torch_dtype(ti.np_dtype())
        if dt.is_floating_point:
            kv = slot_keys.view(torch.float64) if dt == torch.float64 \
                else slot_keys.to(torch.int32).view(torch.float32)
            return [(kv, ~torch.isnan(kv) if ti.nullable else None)]
        kv = slot_keys.to(dt)
        return [(kv, kv != torch.iinfo(dt).min if ti.nullable else None)]
    rem = slot_keys
    parts = []
    for _, span in reversed(spec):
        parts.append(rem % (span + 2))
        rem = rem // (span + 2)
    parts.reverse()
    return [((iv - 1 + lo).to(torch_dtype(ti.np_dtype())),
             iv != 0 if ti.nullable else None)
            for ti, iv, (lo, span) in zip(group_types, parts, spec)]


def distinct_count_per_group(gid, val_tv: TV, mask, num_slots: int,
                             allow_hash: bool = True):
    """Exact COUNT(DISTINCT x) per group.  Values of 4 bytes or less over
    more than 2^21 rows claim hash slots by the packed (group, value) pair
    (`hash_group_ids`): each distinct pair owns one slot, so a group's
    count is the number of slots its pairs own.  The hash form reads FLOAT
    values as bits, with NaN as +inf and -0.0 apart from +0.0, as the
    reference's does; the sorted form (wider values, fewer rows, or
    allow_hash False) folds NaN into 0.0 and -0.0 into +0.0.  Returns
    (counts int64 [num_slots], unresolved rows: 0 on the sorted form, above
    0 when the claim rounds ran out and the sorted form must run)."""
    val, valid = val_tv
    v0 = torch.as_tensor(val)
    n = v0.shape[0]
    if allow_hash and n > (1 << 21) and v0.element_size() <= 4 \
            and num_slots <= (1 << 30):
        contrib = _contrib(mask, valid, n, v0.device)
        if v0.is_floating_point():
            canon = torch.where(torch.isnan(v0), float("inf"), v0)
            bits = canon.to(torch.float32).view(torch.int32)
        else:
            bits = v0.to(torch.int32)
        packed = (gid.to(torch.int64) << 32) | (bits.to(torch.int64) & 0xFFFFFFFF)
        slots = bucket_pow2(max(n // 2, 1 << 12))
        _, total, unresolved, slot_keys = hash_group_ids(packed, contrib, slots, rounds=6)
        # the group of each slot a pair owns is its key's high word
        owned = slot_keys != _I64_MAX
        slot_g = torch.where(owned, slot_keys >> 32, 0).to(torch.int32)
        return segment_count(slot_g, owned, num_slots), unresolved
    return (_distinct_count_sorted(gid, val_tv, mask, num_slots),
            torch.zeros((), dtype=torch.int32, device=v0.device))


def _distinct_count_sorted(gid, val_tv: TV, mask, num_slots: int):
    val, valid = val_tv
    v0 = torch.as_tensor(val)
    contrib = _contrib(mask, valid, v0.shape[0], v0.device)
    g = torch.where(contrib, gid.to(torch.int32), num_slots)
    _, v = _canonical_key(v0, None)
    sg, sv = _sort_pairs(g, v)
    return _sum_by_bounds(_run_starts(sg, sv), _group_bounds(sg, num_slots), torch.int64)


def distinct_sum_per_group(gid, val_tv: TV, mask, num_slots: int, acc_dt):
    """Exact SUM(DISTINCT x) per group over the sorted (group, value)
    pairs: the first row of each distinct pair adds its value.  Returns
    (sums [num_slots] in acc_dt, distinct counts int64 [num_slots])."""
    val, valid = val_tv
    v0 = torch.as_tensor(val)
    contrib = _contrib(mask, valid, v0.shape[0], v0.device)
    g = torch.where(contrib, gid.to(torch.int32), num_slots)
    sg, sv = _sort_pairs(g, _flush_subnormals(v0) if v0.is_floating_point() else v0)
    first = _run_starts(sg, sv) & (sg < num_slots)
    # a per-slot sum of the first rows, not a prefix sum: a NaN or an inf
    # stays in its own group
    return (segment_sum(sg, sv, first, num_slots, acc_dt),
            _sum_by_bounds(first, _group_bounds(sg, num_slots), torch.int64))


# above this row count APPROX_QUANTILE takes the histogram sketch
QUANTILE_EXACT_MAX_ROWS = 1 << 21


def quantile_per_group(gid, val_tv: TV, mask, num_slots: int, q: float):
    """Per-group quantile (APPROX_QUANTILE): exact, with numpy's linear
    interpolation, over the sorted (group, value) pairs up to
    QUANTILE_EXACT_MAX_ROWS rows; the histogram sketch above.  Returns
    (values float64 [num_slots], group has a value)."""
    val, valid = val_tv
    v0 = torch.as_tensor(val)
    n = v0.shape[0]
    if n > QUANTILE_EXACT_MAX_ROWS:
        return _quantile_histogram(gid, val_tv, mask, num_slots, q)
    contrib = _contrib(mask, valid, n, v0.device)
    g = torch.where(contrib, gid.to(torch.int32), num_slots)
    fval = torch.where(contrib, _flush_subnormals(v0.to(torch.float64)), 0.0)
    sg, sv = _sort_pairs(g, fval)
    bounds = _group_bounds(sg, num_slots)
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    pos = q * (counts - 1).clamp(min=0).to(torch.float64)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(torch.float64)
    lo_v = sv[(starts + lo).clamp(0, n - 1)]
    hi_v = sv[(starts + hi).clamp(0, n - 1)]
    return lo_v * (1 - frac) + hi_v * frac, counts > 0


def _quantile_histogram(gid, val_tv: TV, mask, num_slots: int, q: float):
    """Histogram-sketch quantile: each group's [lo, hi] interval zoomed
    through per-group histograms of `bins` bins, `zooms` times; the error
    is at most (hi - lo) / bins^zooms."""
    val, valid = val_tv
    v0 = torch.as_tensor(val)
    n = v0.shape[0]
    dev = v0.device
    contrib = _contrib(mask, valid, n, dev)
    fval = torch.where(contrib, v0.to(torch.float64), 0.0)
    g = torch.where(contrib, gid.to(torch.int32), num_slots)
    if num_slots <= 1024:
        bins, zooms = 4096, 2
    elif num_slots <= (1 << 16):
        bins, zooms = 256, 3
    else:
        bins, zooms = 64, 3
    cnt = segment_count(gid, contrib, num_slots)
    # MIN / MAX in the argument's own type (the kernels take values of 4
    # bytes or less); the cast to float64 is monotone, so it commutes
    have = cnt > 0
    inf = torch.full((), float("inf"), dtype=torch.float64, device=dev)
    glo = torch.where(have, segment_minmax(gid, v0, contrib, num_slots, True).to(
        torch.float64), inf)
    ghi = torch.where(have, segment_minmax(gid, v0, contrib, num_slots, False).to(
        torch.float64), -inf)
    pos = q * (cnt - 1).clamp(min=0).to(torch.float64)
    frac = pos - torch.floor(pos)
    gs = g.clamp(0, num_slots - 1).to(torch.int64)
    cells = num_slots * bins

    def value_at_rank(rank):
        lo, hi, rk = glo, ghi, rank
        for _ in range(zooms):
            width = ((hi - lo) / bins).clamp(min=1e-300)
            lo_r, hi_r, w_r = lo[gs], hi[gs], width[gs]
            b = torch.floor((fval - lo_r) / w_r).clamp(0, bins - 1).to(torch.int64)
            # rows outside the zoomed interval add 0 to their group's edge
            # bin (the rank left is relative to the interval's start)
            in_iv = contrib & (fval >= lo_r) & (fval <= hi_r)
            hist = torch.zeros(cells, dtype=torch.int32, device=dev)
            hist.index_add_(0, gs * bins + b, in_iv.to(torch.int32))
            cum = torch.cumsum(hist.view(num_slots, bins), 1)
            below = torch.cat([torch.zeros(num_slots, 1, dtype=cum.dtype, device=dev),
                               cum[:, :-1]], 1)
            # the first bin whose cumulative count passes the rank
            bstar = (cum > rk[:, None]).to(torch.uint8).argmax(1)
            rk = rk - below.gather(1, bstar[:, None])[:, 0]
            lo = lo + bstar.to(torch.float64) * width
            hi = lo + width
        return (lo + hi) * 0.5

    vlo = value_at_rank(torch.floor(pos).to(torch.int64))
    vhi = value_at_rank(torch.ceil(pos).to(torch.int64))
    out = torch.minimum(torch.maximum(vlo * (1 - frac) + vhi * frac, glo), ghi)
    return out, have


def mode_per_group(gid, val_tv: TV, mask, num_slots: int):
    """MODE: the most frequent value of each group, ties to the smallest.
    Over the sorted (group, value) pairs each run of equal values packs
    its length with its start (length x (n + 1) + n - start), and the
    group's largest pack names the longest run, the earliest (smallest
    value) among equals.  Returns (values [num_slots], group has a
    value)."""
    val, valid = val_tv
    v0 = torch.as_tensor(val)
    n = v0.shape[0]
    dev = v0.device
    contrib = _contrib(mask, valid, n, dev)
    g = torch.where(contrib, gid.to(torch.int32), num_slots)
    _, v = _canonical_key(v0, None)
    sg, sv = _sort_pairs(g, v)
    first = _run_starts(sg, sv)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    # the start of the run after each row's run: the run starts in order
    # (a compaction), read at the next run's index
    starts = compact_perm(first)
    nxt_run = torch.cumsum(first, 0)
    nxt = torch.where(nxt_run < first.sum(), starts[nxt_run.clamp(max=n - 1)], n)
    packed = (nxt - rows) * (n + 1) + (n - rows)
    best = segment_minmax(sg, packed, first & (sg < num_slots), num_slots, False)
    best_start = n - best % (n + 1)
    return sv[best_start.clamp(0, n - 1)], best > 0


# ---------------------------------------------------------------------------
# HyperLogLog (APPROX_COUNT_DISTINCT)
# ---------------------------------------------------------------------------

HLL_BITS = 11  # 2048 registers
HLL_M = 1 << HLL_BITS


def _splitmix64(x):
    """splitmix64 of int64 bit patterns, in int64: wrapping int64 adds and
    products have the uint64 ones' bits."""
    z = x + _SM_GOLDEN
    z = (z ^ _srl(z, 30)) * _SM_MUL1
    z = (z ^ _srl(z, 27)) * _SM_MUL2
    return z ^ _srl(z, 31)


def f64_to_bits(v):
    """The reference's IEEE-754 pattern of float64 values as int64 (its
    ops/f64bits.f64_to_bits, as it runs on the CPU): -0.0, +0.0 and every
    subnormal of either sign give +0.0's pattern, every NaN one quiet
    pattern, the rest their bits."""
    v = v.to(torch.float64)
    b = v.view(torch.int64)
    b = torch.where((b & _I64_MAX) < (1 << 52), 0, b)
    return torch.where(torch.isnan(v), 0x7FF8000000000000, b)


def _u64_to_f64(x):
    """The float64 nearest the uint64 whose bits int64 x holds, ties to
    even, as a uint64 -> float64 conversion rounds: [2^63, 2^64) keeps the
    top 53 bits of the low 63, rounded."""
    low = x & _I64_MAX
    q, r = low >> 11, low & 0x7FF
    up = (r > 0x400) | ((r == 0x400) & ((q & 1) == 1))
    high = (q + up.to(torch.int64)).to(torch.float64) * 2048.0 + 2.0 ** 63
    return torch.where(x >= 0, x.to(torch.float64), high)


def hll_registers(gid, val_tv: TV, mask, num_slots: int):
    """[num_slots, HLL_M] int8 registers: the largest rho of each group's
    values in each register.  A value's 64-bit hash picks the register by
    its top HLL_BITS bits; rho is 64 - floor(log2(rest)) of the remaining
    bits with the low HLL_BITS set, log2 taken as the reference takes it,
    log(f) x (1 / log(2)) of the float64 nearest rest.  So a rest that
    rounds up to 2^64 gives rho 0, and one at or just below a power of two
    can differ by one from its count of leading zeros."""
    val, valid = val_tv
    v0 = torch.as_tensor(val)
    n = v0.shape[0]
    contrib = _contrib(mask, valid, n, v0.device)
    bits = f64_to_bits(v0) if v0.is_floating_point() else v0.to(torch.int64)
    h = _splitmix64(bits)
    reg = _srl(h, 64 - HLL_BITS)
    rest = (h << HLL_BITS) | (HLL_M - 1)
    lz = 63 - torch.floor(torch.log(_u64_to_f64(rest)) * _INV_LN2).to(torch.int32)
    cells = num_slots * HLL_M
    regs = torch.zeros(cells + 1, dtype=torch.int32, device=v0.device)
    regs.scatter_reduce_(0, _plain.slot_index(gid.to(torch.int64) * HLL_M + reg, contrib,
                                              cells), lz + 1, "amax")
    return regs[:cells].to(torch.int8).view(num_slots, HLL_M)


def hll_estimate(registers):
    """[G, HLL_M] int8 registers -> the estimated distinct count of each
    group (int64), with the small-range (linear counting) correction.
    2^-r is exp(-r log 2), as the reference's exp2 computes it."""
    m = HLL_M
    alpha = 0.7213 / (1 + 1.079 / m)
    r = registers.to(torch.float64)
    est = alpha * m * m / torch.exp(_LN2 * -r).sum(1)
    zeros = (registers == 0).sum(1).to(torch.float64)
    lc = m * torch.log(torch.where(zeros > 0, m / zeros.clamp(min=1), 1.0))
    est = torch.where((est <= 2.5 * m) & (zeros > 0), lc, est)
    return torch.round(est).to(torch.int64)
