"""Group-by building blocks for the keyless, perfect-hash and sort
strategies.

Port of heavydb_tpu/ops/groupby.py: `perfect_group_ids`, the segment
reductions `segment_count` / `segment_sum` / `segment_minmax`,
`_shared_scan`, the dispatcher to the group-by kernels, and the sort tier
(`sort_group_rows`, `SortedSegments`).  The routing is the
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

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from heavydb_tpu_torch.errors import NotSupported
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


def _canonical_key(val, valid):
    """(null_flag int8, canonical value) sort operands of one key column:
    NaN and -0.0 become 0 so they cannot split a group, NULL rows get their
    own flag (and value 0), booleans sort as int8."""
    v = torch.as_tensor(val)
    if v.dtype == torch.bool:
        v = v.to(torch.int8)
    if v.is_floating_point():
        v = torch.where(torch.isnan(v) | (v == 0), torch.zeros((), dtype=v.dtype,
                                                               device=v.device), v)
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


def sort_group_rows(key_tvs: Sequence[TV], mask, cap: int, payloads=(),
                    need_rows: bool = True):
    """Sort-based grouping that keeps the sorted row domain; payload row
    arrays (aggregate arguments and validities) ride the same permutation.
    Rows outside `mask` sort last.

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

    def distinct_count_per_group(self, *args, **kwargs):
        raise NotSupported("DISTINCT aggregates")

    def distinct_sum_per_group(self, *args, **kwargs):
        raise NotSupported("DISTINCT aggregates")

    def hll_registers(self, *args, **kwargs):
        raise NotSupported("APPROX_COUNT_DISTINCT")

    def quantile_per_group(self, *args, **kwargs):
        raise NotSupported("APPROX_QUANTILE")

    def mode_per_group(self, *args, **kwargs):
        raise NotSupported("MODE")
