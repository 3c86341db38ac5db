"""Aggregate lowering: E.Agg -> per-slot partials -> finalize.

Port of heavydb_tpu/ops/agg.py: COUNT, COUNT_IF, SUM, SUM_IF, AVG, MIN,
MAX, SAMPLE, SINGLE_VALUE, STDDEV, VARIANCE, COUNT / SUM / AVG (DISTINCT),
APPROX_COUNT_DISTINCT, APPROX_QUANTILE (and APPROX_MEDIAN) and MODE, keyless
and grouped.  The reference's 8-bit biased limbs and f32 hi/lo splits exist
because Mosaic on the TPU has no 64-bit types; here exact integer sums are
an int64 stream and DOUBLE sums a float64 stream (kernels/lane_agg.py
stream classes).

Null semantics match SQL/HeavyDB: aggregates skip NULL inputs; SUM/MIN/MAX/
AVG of zero valid rows is NULL; COUNT is never NULL.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from heavydb_tpu_torch.errors import NotSupported
from heavydb_tpu_torch.kernels import groupby_minmax, lane_agg
from heavydb_tpu_torch.ops import groupby as G
from heavydb_tpu_torch.plan import exprs as E

TV = Tuple[object, Optional[object]]

_SUPPORTED = {E.AggKind[k] for k in (
    "COUNT", "COUNT_IF", "SUM", "SUM_IF", "AVG", "MIN", "MAX", "SAMPLE",
    "SINGLE_VALUE", "STDDEV", "VARIANCE", "COUNT_DISTINCT", "APPROX_COUNT_DISTINCT",
    "APPROX_QUANTILE", "MODE")}


def _fusable(la) -> bool:
    A = E.AggKind
    agg = la.agg
    return la.kind in (A.COUNT, A.COUNT_IF, A.SUM, A.SUM_IF, A.AVG, A.STDDEV,
                       A.VARIANCE) and not agg.distinct and not (
        agg.arg is not None and agg.arg.type.is_decimal)


def _full_like_rows(compiler, val):
    val = torch.as_tensor(val)
    return val.expand(compiler.domain_size) if val.dim() == 0 else val


def _arg_and_mask(la, compiler, mask):
    """(argument TV or None, contribution mask or None) of one aggregate."""
    A = E.AggKind
    agg = la.agg
    arg_tv = compiler.compile(agg.arg) if agg.arg is not None else None
    cm = mask
    if arg_tv is not None and arg_tv[1] is not None:
        cm = arg_tv[1] if cm is None else (cm & arg_tv[1])
    if la.kind in (A.COUNT_IF, A.SUM_IF):
        pred = compiler.compile_predicate(agg.arg2)
        cm = pred if cm is None else (cm & pred)
    if cm is not None and cm.dim() == 0:
        cm = cm.expand(compiler.domain_size)
    return arg_tv, cm


def _keyless_fused(lowered, compiler, mask):
    """Keyless (single-slot) aggregation: every partial is one masked
    reduction over the row domain.  Returns partials (each value shaped
    [1]) or None when an aggregate kind can't ride (caller falls back)."""
    A = E.AggKind
    partials: List[Optional[dict]] = [None] * len(lowered)
    for idx, la in enumerate(lowered):
        if not _fusable(la):
            return None
        arg_tv, cm = _arg_and_mask(la, compiler, mask)
        if cm is None:
            if arg_tv is None:
                return None  # bare count(*) with no mask: nothing to fuse
            cm = torch.ones(compiler.domain_size, dtype=torch.bool,
                            device=compiler.device)
        p = {"count": cm.sum(dtype=torch.int64).reshape(1)}
        partials[idx] = p
        if la.kind in (A.COUNT, A.COUNT_IF):
            continue
        acc = np.dtype(np.float64) if la.kind in (A.STDDEV, A.VARIANCE) \
            else np.dtype(la._acc_dtype())
        acc_t = G.torch_dtype(acc)
        v = torch.where(cm, _full_like_rows(compiler, arg_tv[0]).to(acc_t), 0)
        p["sum"] = v.sum(dtype=acc_t).reshape(1)
        if la.kind in (A.STDDEV, A.VARIANCE):
            p["sumsq"] = (v * v).sum(dtype=acc_t).reshape(1)
    return partials


def accumulate_all(lowered, compiler, gid, mask, num_slots: int,
                   want_present: bool = False, segs=None):
    """Partials for ALL aggregates of one group-by.  Between 2 and 65536
    slots every count/sum-style partial becomes one stream of a SINGLE
    kernel pass (kernels/lane_agg or kernels/radix_hist); per-aggregate
    filters fold into the streams (count_i = sum mask_i, sum_i =
    sum value*mask_i).  Other kinds accumulate per aggregate.

    `segs` swaps the segment reductions: a groupby.SortedSegments (the sort
    tier) aggregates a sorted row domain per aggregate instead.

    Returns (partials, present_counts): with want_present, the per-slot row
    count under the plain mask (the fused pass's base counts)."""
    A = E.AggKind
    if num_slots == 1 and not want_present and segs is None:
        # keyless only: a 1-slot PERFECT group-by still needs presence
        fused = _keyless_fused(lowered, compiler, mask)
        if fused is not None:
            return fused, None
    if segs is not None or not 1 < num_slots <= G.SHARED_SCAN_MAX_SLOTS:
        segs = segs if segs is not None else G
        parts = [la.accumulate(compiler, gid, mask, num_slots, segs=segs)
                 for la in lowered]
        pres = None
        if want_present:
            # an unfiltered COUNT(*) partial counts exactly the masked
            # rows per slot — reuse it instead of a second scatter
            for la, p in zip(lowered, parts):
                if la.kind == A.COUNT and la.agg.arg is None \
                        and isinstance(p, dict) and "count" in p:
                    pres = p["count"]
                    break
            if pres is None:
                pres = segs.segment_count(gid, mask, num_slots)
        return parts, pres

    streams = []  # (values, op)
    sinks = []    # (partials dict, key, acc torch dtype or None)
    base_counts = []  # partials whose count is the pass's base count
    partials: List[Optional[dict]] = [None] * len(lowered)
    for idx, la in enumerate(lowered):
        if not _fusable(la):
            partials[idx] = la.accumulate(compiler, gid, mask, num_slots)
            continue
        arg_tv, cm = _arg_and_mask(la, compiler, mask)
        if cm is None:
            cm = torch.ones(gid.shape[0], dtype=torch.bool, device=gid.device)
        p: dict = {}
        partials[idx] = p
        if cm is mask:
            base_counts.append(p)  # the pass's own row counts
        else:
            streams.append((cm, "count"))
            sinks.append((p, "count", None))
        if la.kind in (A.COUNT, A.COUNT_IF):
            continue
        val = _full_like_rows(compiler, arg_tv[0])
        if la.kind in (A.STDDEV, A.VARIANCE):
            fv = torch.where(cm, val.to(torch.float64), 0)
            streams.append((fv, "sumd"))
            sinks.append((p, "sum", torch.float64))
            streams.append((fv * fv, "sumd"))
            sinks.append((p, "sumsq", torch.float64))
            continue
        acc = np.dtype(la._acc_dtype())
        if not val.is_floating_point() and la.kind == A.AVG:
            # AVG over ints sums exactly in int64; finalize divides in f64
            acc = np.dtype(np.int64)
        v, op = G.sum_stream(val, acc)
        # rows outside the pass's mask never add; only a narrower cm needs
        # the stream zeroed
        streams.append((v if cm is mask else torch.where(cm, v, 0), op))
        sinks.append((p, "sum", G.torch_dtype(acc)))

    res = G._shared_scan(gid, mask, streams, num_slots)
    for (p, key, acc_t), r in zip(sinks, res[1:]):
        p[key] = r if acc_t is None else r.to(acc_t)
    for p in base_counts:
        p["count"] = res[0]
    present = res[0] if want_present else None
    return partials, present


def pass_kernel(slots: int) -> str:
    """The kernel of the shared count / sum pass over `slots` slots."""
    return "B1" if slots <= lane_agg.MAX_SLOTS else "B2"


def route(agg: E.Agg, tier: str, slots: Optional[int]) -> str:
    """The kernel route of one aggregate on a group-by tier over `slots`
    slots, as `accumulate_all` and the segment reductions of ops/groupby.py
    take it (EXPLAIN OPTIMIZED): B1 / B2 for the shared pass, B1 / B3 for
    MIN / MAX of <= 4-byte values, B5 + B6 on the radix tier, else plain
    torch."""
    A = E.AggKind
    if tier == "radix":
        return "B5 + B6"
    if tier == "sort":
        return "plain torch (sorted segments)"
    if slots == 1:
        return "plain torch (a masked reduction)"
    la = LoweredAgg(agg)
    if agg.distinct or la.kind in (A.COUNT_DISTINCT, A.APPROX_COUNT_DISTINCT,
                                   A.APPROX_QUANTILE, A.MODE):
        return "plain torch (distinct values, sketches)"
    shared = slots <= G.SHARED_SCAN_MAX_SLOTS
    count = pass_kernel(slots) if shared and slots > G.SMALL_SLOTS else "plain scatter"
    if la.kind in (A.MIN, A.MAX, A.SAMPLE, A.SINGLE_VALUE):
        narrow = agg.arg is not None and (
            agg.arg.type.is_dict_string or np.dtype(agg.arg.type.np_dtype()).itemsize <= 4)
        mm = "plain scatter"
        if narrow and G.SMALL_SLOTS < slots <= lane_agg.MAX_SLOTS:
            mm = "B1"
        elif narrow and lane_agg.MAX_SLOTS < slots <= groupby_minmax.MAX_SLOTS:
            mm = "B3"
        return f"{mm} + {count} (count)"
    if not shared:
        return "plain scatter"
    if not _fusable(la):
        return f"{count} (sums and count)"
    return f"{pass_kernel(slots)} (the shared pass)"


class LoweredAgg:
    """One aggregate target, lowered."""

    def __init__(self, agg: E.Agg):
        self.agg = agg
        self.kind = agg.kind

    def accumulate(self, compiler, gid, mask, num_slots: int,
                   segs=None) -> Dict[str, object]:
        """Partials of this aggregate; `segs` swaps the segment reductions
        (None: this module's G, else a groupby.SortedSegments)."""
        if segs is None:
            segs = G
        k = self.kind
        A = E.AggKind
        if k not in _SUPPORTED:
            raise NotSupported(f"aggregate {k}")
        if k in (A.COUNT_DISTINCT, A.APPROX_COUNT_DISTINCT, A.APPROX_QUANTILE, A.MODE):
            val, valid = compiler.compile(self.agg.arg)
            arg_tv = (_full_like_rows(compiler, val), valid)
        if k == A.COUNT_DISTINCT:
            # the hash form, unless the plan asks for the sorted one; a
            # claim table that ran out of rounds flags the run, and the
            # executor runs it again on the sorted form
            cnt, overflow = segs.distinct_count_per_group(
                gid, arg_tv, mask, num_slots,
                allow_hash=not getattr(compiler, "distinct_force_sort", False))
            compiler._flag_error("count_distinct_overflow", overflow > 0, None)
            return {"count": cnt}
        if k == A.APPROX_COUNT_DISTINCT:
            return {"hll": segs.hll_registers(gid, arg_tv, mask, num_slots)}
        if k == A.APPROX_QUANTILE:
            val, has = segs.quantile_per_group(gid, arg_tv, mask, num_slots,
                                               float(self.agg.arg2.value))
            return {"value": val, "count": has.to(torch.int64)}
        if k == A.MODE:
            val, has = segs.mode_per_group(gid, arg_tv, mask, num_slots)
            return {"max": val, "count": has.to(torch.int64)}
        arg_tv, cm = _arg_and_mask(self, compiler, mask)
        if cm is None:
            cm = torch.ones(gid.shape[0], dtype=torch.bool, device=gid.device)
        if k in (A.COUNT, A.COUNT_IF):
            return {"count": segs.segment_count(gid, cm, num_slots)}
        val = _full_like_rows(compiler, arg_tv[0])
        if k in (A.SUM, A.SUM_IF, A.AVG) and self.agg.distinct:
            # SUM / AVG(DISTINCT x): over the distinct (group, value) pairs
            s, cnt = segs.distinct_sum_per_group(gid, (val, None), cm, num_slots,
                                                 self._acc_dtype())
            return {"sum": s, "count": cnt}
        if k in (A.SUM, A.SUM_IF, A.AVG):
            return {
                "sum": segs.segment_sum(gid, val, cm, num_slots, self._acc_dtype()),
                "count": segs.segment_count(gid, cm, num_slots),
            }
        if k in (A.MIN, A.MAX, A.SAMPLE, A.SINGLE_VALUE):
            is_min = k == A.MIN
            dref = self._dict_ref()
            if dref is not None and k in (A.MIN, A.MAX):
                # dictionary strings order by their lexicographic rank, an
                # int32 stream for the min / max kernels; finalize maps the
                # rank back to an id
                rank = compiler.aux[("dictrank", dref)]
                safe = val.clamp(0, rank.shape[0] - 1).to(torch.int64)
                val = torch.where(val >= 0, rank[safe], 0).to(torch.int32)
            return {
                "min" if is_min else "max":
                    segs.segment_minmax(gid, val, cm, num_slots, is_min),
                "count": segs.segment_count(gid, cm, num_slots),
            }
        # STDDEV / VARIANCE
        fval = val.to(torch.float64)
        if self.agg.arg.type.is_decimal:
            fval = fval / (10**self.agg.arg.type.scale)
        f64 = np.dtype(np.float64)
        return {
            "sum": segs.segment_sum(gid, fval, cm, num_slots, f64),
            "sumsq": segs.segment_sum(gid, fval * fval, cm, num_slots, f64),
            "count": segs.segment_count(gid, cm, num_slots),
        }

    def _acc_dtype(self):
        return self.agg.type.np_dtype()

    def _dict_ref(self):
        if self.agg.arg is not None and self.agg.arg.type.is_dict_string:
            return getattr(self.agg.arg, "dict_ref", None)
        return None

    def finalize(self, partials: Dict[str, object], aux=None) -> TV:
        """(values, valid) per slot; `aux` holds the `dictorder` table of a
        MIN / MAX over a dictionary string (rank -> id)."""
        k = self.kind
        A = E.AggKind
        dref = self._dict_ref()
        if dref is not None and k in (A.MIN, A.MAX):
            order = aux[("dictorder", dref)]
            rank = partials["min" if k == A.MIN else "max"]
            safe = rank.clamp(0, order.shape[0] - 1).to(torch.int64)
            ids = torch.where((rank >= 0) & (rank < order.shape[0]), order[safe], 0)
            return ids.to(torch.int32), partials["count"] > 0
        if k in (A.COUNT, A.COUNT_IF, A.COUNT_DISTINCT):
            return partials["count"], None
        if k == A.APPROX_COUNT_DISTINCT:
            return G.hll_estimate(partials["hll"]), None
        if k == A.APPROX_QUANTILE:
            return partials["value"], partials["count"] > 0
        if k in (A.SUM, A.SUM_IF):
            return partials["sum"], partials["count"] > 0
        if k == A.AVG:
            cnt = partials["count"].clamp(min=1)
            s = partials["sum"].to(torch.float64)
            if self.agg.arg.type.is_decimal:
                s = s / (10**self.agg.arg.type.scale)
            return s / cnt, partials["count"] > 0
        if k == A.MIN:
            return partials["min"], partials["count"] > 0
        if k in (A.MAX, A.SAMPLE, A.SINGLE_VALUE, A.MODE):
            return partials["max"], partials["count"] > 0
        if k in (A.STDDEV, A.VARIANCE):
            n = partials["count"].clamp(min=2).to(torch.float64)
            mean = partials["sum"] / partials["count"].clamp(min=1)
            var = (partials["sumsq"] - partials["sum"] * mean) / (n - 1)
            var = var.clamp(min=0.0)
            out = torch.sqrt(var) if k == A.STDDEV else var
            return out, partials["count"] > 1
        raise NotSupported(f"aggregate {k}")
