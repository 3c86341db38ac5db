"""Engine routing for the radix-partition group-by (kernels/radix_groupby,
kernels B5 and B6): which Compounds may ride it, and the glue between
aggregates and the kernel's streams.

Port of heavydb_tpu/exec/radix_tier.py:

- `eligible()`: static check at plan time that every aggregate of the node
  maps onto the kernel's stream classes within the stream budget;
- `build_streams()`: compile each aggregate's argument into streams
  (count / sumi / sumf / sumd / min / max) with SQL's skip-NULL semantics;
- `finalize_partials()`: kernel outputs -> the partials dicts that
  ops.agg.LoweredAgg.finalize reads.

The reference's 16-bit integer limbs and double-single f32 pairs exist
because Mosaic has no 64-bit types; here exact integer sums are one `sumi`
stream (int64 totals), DOUBLE sums one `sumd` stream (float64) and FLOAT
sums one `sumf` stream (float32 within the group's one partition).

Stream budget: B6 (csrc/radix_groupby.cu group_kernel) reduces the streams
one after another into a single accumulator array of 8 B per group, which
reuses its sort buffer, so its shared-memory layout (18.5 B per partition
row: sort buffer / accumulators, a hash table of two 4-byte entries and a
2-byte rank per row) does not grow with the stream count; the budget is
the kernels' StreamSet width, RG.MAX_STREAMS = 16.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from heavydb_tpu_torch.kernels import _plain
from heavydb_tpu_torch.kernels import radix_groupby as RG
from heavydb_tpu_torch.ops.groupby import torch_dtype
from heavydb_tpu_torch.plan import exprs as E


class RadixUnsupported(Exception):
    """Raised while a Compound's kernel runs when the compiled aggregate
    shape diverges from the static plan (a validity the types did not
    announce); the executor reroutes the query to the sort tier."""


def _agg_spec(agg: E.Agg) -> Optional[dict]:
    """Stream recipe of one aggregate, or None if it cannot ride the radix
    kernel.  The stream count must match build_streams exactly."""
    A = E.AggKind
    k = agg.kind
    if agg.distinct:
        return None
    if k in (A.COUNT, A.COUNT_IF):
        needs_cm = k == A.COUNT_IF or (
            agg.arg is not None and agg.arg.type.nullable)
        return {"cls": "count", "needs_cm": needs_cm,
                "n_streams": 1 if needs_cm else 0}
    if agg.arg is None:
        return None
    vdt = np.dtype(agg.arg.type.np_dtype())
    nullable = bool(agg.arg.type.nullable)
    if k in (A.SUM, A.SUM_IF, A.AVG):
        needs_cm = nullable or k == A.SUM_IF
        acc = np.dtype(agg.type.np_dtype())
        if vdt.kind in "iub" and (acc.kind == "i" or k == A.AVG):
            cls = "sumint"
        elif acc == np.dtype(np.float64):
            cls = "sumd"
        elif acc.kind == "f":
            cls = "sumf"
        else:
            return None
        return {"cls": cls, "needs_cm": needs_cm,
                "n_streams": 1 + (1 if needs_cm else 0)}
    if k in (A.STDDEV, A.VARIANCE):
        return {"cls": "std", "needs_cm": nullable,
                "n_streams": 2 + (1 if nullable else 0)}
    if k in (A.MIN, A.MAX, A.SAMPLE, A.SINGLE_VALUE):
        if k in (A.MIN, A.MAX) and agg.arg.type.is_dict_string:
            return None  # ordering needs the rank/aux tables
        if vdt.itemsize > 4 or vdt.kind not in "iubf":
            return None
        return {"cls": "minmax", "is_min": k == A.MIN, "needs_cm": nullable,
                "n_streams": 1 + (1 if nullable else 0)}
    return None


def plan_aggs(aggs) -> Optional[List[dict]]:
    specs = []
    total = 0
    for a in aggs:
        s = _agg_spec(a)
        if s is None:
            return None
        total += s["n_streams"]
        specs.append(s)
    if total > RG.MAX_STREAMS:
        return None
    return specs


def row_bytes(aggs):
    """(s, r): bytes a row of the streams `build_streams` makes for `aggs`,
    and of B6's stage records of them (kernels/radix_groupby.py
    `record_dtype`), from the arguments' SQL types.  An aggregate the
    streams cannot take counts its argument, a bool mask and an 8-byte
    record."""
    s = r = 0
    for agg in aggs:
        spec = _agg_spec(agg)
        if spec is None:
            w = 0 if agg.arg is None else np.dtype(agg.arg.type.np_dtype()).itemsize
            s, r = s + w + 1, r + 8
            continue
        if spec["needs_cm"]:
            s, r = s + 1, r + 8  # a bool count stream, int64 records
        cls = spec["cls"]
        if cls == "count":
            continue
        vdt = np.dtype(agg.arg.type.np_dtype())
        if cls == "sumint":
            s, r = s + (8 if vdt.kind == "b" else vdt.itemsize), r + 8
        elif cls == "sumd":
            s, r = s + (4 if vdt == np.float32 else 8), r + 8
        elif cls == "std":
            s, r = s + 16, r + 16
        else:  # sumf, minmax: 4-byte values and records
            s, r = s + 4, r + 4
    return s, r


def eligible(node, ranges, slots: int, cfg) -> bool:
    """Static plan-time check: can this Compound's group-by run on the
    radix tier?"""
    if not cfg.enable_radix_groupby:
        return False
    if slots >= (1 << 31):
        return False
    # bucketed keys (DATE_TRUNC ranges) are not rebuilt from the slot index
    # without a min-stream; they stay on the sort tier
    if any(r.bucket > 1 for r in ranges):
        return False
    return plan_aggs(node.aggs) is not None


def build_streams(lowered, specs, compiler, base_mask):
    """Compile aggregate arguments into kernel streams.

    Returns (streams [(values, op)], jobs); jobs drive finalize_partials.
    Raises RadixUnsupported if the compiled shape needs a validity stream
    the static plan did not budget."""
    A = E.AggKind
    streams = []
    jobs: List[dict] = []
    n = compiler.domain_size
    for la, spec in zip(lowered, specs):
        agg = la.agg
        k = la.kind
        arg_tv = compiler.compile(agg.arg) if agg.arg is not None else None
        cm = base_mask
        extra_valid = False
        if arg_tv is not None and arg_tv[1] is not None:
            cm = cm & arg_tv[1]
            extra_valid = True
        if k in (A.COUNT_IF, A.SUM_IF):
            cm = cm & compiler.compile_predicate(agg.arg2)
            extra_valid = True
        if extra_valid and not spec["needs_cm"]:
            # the static plan assumed cm == the row mask; diverging here
            # would break the stream budget: reroute to the sort tier
            raise RadixUnsupported(
                f"unplanned validity for {k}: type said non-nullable")
        cm = cm.expand(n) if cm.dim() == 0 else cm
        job = {"cls": spec["cls"], "la": la}
        if spec["needs_cm"]:
            job["cm_idx"] = len(streams)
            streams.append((cm, "count"))
        cls = spec["cls"]
        if cls == "count":
            jobs.append(job)
            continue
        val = torch.as_tensor(arg_tv[0])
        val = val.expand(n) if val.dim() == 0 else val
        zero = torch.zeros((), device=val.device)
        job["s_idx"] = len(streams)
        if cls == "sumf":
            streams.append((torch.where(cm, val.to(torch.float32),
                                        zero.float()), "sumf"))
            job["acc"] = np.dtype(la._acc_dtype())
        elif cls == "sumd":
            # decimal sums take the exact sumint path: their accumulator is
            # the scaled int64
            v = val if val.dtype in (torch.float32, torch.float64) \
                else val.to(torch.float64)
            streams.append((torch.where(cm, v, zero.to(v.dtype)), "sumd"))
            job["acc"] = np.dtype(la._acc_dtype())
        elif cls == "sumint":
            acc = np.dtype(la._acc_dtype())
            job["acc"] = np.dtype(np.int64) if acc.kind == "f" else acc
            v = val.to(torch.int64) if val.dtype == torch.bool else val
            streams.append((torch.where(cm, v, zero.to(v.dtype)), "sumi"))
        elif cls == "std":
            fv = val.to(torch.float64)
            if agg.arg.type.is_decimal:
                fv = fv / (10 ** agg.arg.type.scale)
            fv = torch.where(cm, fv, zero.double())
            streams.append((fv, "sumd"))
            streams.append((fv * fv, "sumd"))
        else:  # minmax
            is_min = spec["is_min"]
            job["is_min"] = is_min
            job["out_dt"] = val.dtype
            # the kernel takes 4-byte values: narrower ints widen to int32
            w = val if val.dtype in (torch.int32, torch.float32) \
                else val.to(torch.int32)
            ident = _plain.minmax_ident(w.dtype, is_min)
            streams.append((torch.where(cm, w, torch.full((), ident, dtype=w.dtype,
                                                          device=w.device)),
                            "min" if is_min else "max"))
        jobs.append(job)
    return streams, jobs


def finalize_partials(jobs, len_out, totals) -> List[dict]:
    """Kernel outputs -> the partials dicts of ops.agg."""
    partials: List[dict] = []
    for job in jobs:
        cls = job["cls"]
        cnt = totals[job["cm_idx"]] if "cm_idx" in job else len_out
        p = {"count": cnt}
        if cls in ("sumf", "sumd", "sumint"):
            p["sum"] = totals[job["s_idx"]].to(torch_dtype(job["acc"]))
        elif cls == "std":
            s = job["s_idx"]
            p["sum"] = totals[s]
            p["sumsq"] = totals[s + 1]
        elif cls == "minmax":  # "max" also serves SAMPLE / SINGLE_VALUE
            p["min" if job["is_min"] else "max"] = \
                totals[job["s_idx"]].to(job["out_dt"])
        partials.append(p)
    return partials

