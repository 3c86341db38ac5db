"""Compound work-unit kernel builder.

Port of heavydb_tpu/exec/compound_kernel.py for the paths of this slice:
filter mask -> projection, or filter mask -> keyless / perfect-hash /
radix / sort group-by with aggregates -> HAVING -> compaction.  The
reference traces one closure per Compound into a single XLA program; torch
runs the same closure eagerly, op by op, with the group-by aggregates in
the hand-written kernels (ops/groupby.py, kernels/radix_groupby.py).

The closure returns a dict with the output columns, the exact row count,
the group count, the radix tier's overflow bits and the error flags,
packed as control scalars into one int32 tensor ('ctrl_vec') that the
executor reads with a single host copy.  Joins and the hash group-by
strategy raise NotSupported.
"""

from __future__ import annotations

from typing import Dict

import torch

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import NotSupported
from heavydb_tpu_torch.exec import radix_tier as RT
from heavydb_tpu_torch.exec.expr_compiler import ExprCompiler
from heavydb_tpu_torch.kernels import radix_groupby as RG
from heavydb_tpu_torch.ops import agg as AGG
from heavydb_tpu_torch.ops import groupby as G
from heavydb_tpu_torch.plan import exprs as E


def _sentinelize(val, valid, ti: T.TypeInfo):
    """Apply in-band null sentinel for storage/output."""
    dt = G.torch_dtype(ti.np_dtype())
    val = torch.as_tensor(val).to(dt)
    if valid is None:
        return val
    null = float("nan") if dt.is_floating_point else ti.null_sentinel()
    return torch.where(valid, val, null)


def ctrl_keys(d) -> list:
    """Control scalars the executor reads after every kernel run, in
    deterministic order; they also ride packed in one int32 tensor
    ('ctrl_vec') so the host reads them with one copy."""
    return sorted(k for k in d if k in ("n_out", "num_groups", "radix_overflow")
                  or k.startswith("err_"))


def derive_valid(arr, ti: T.TypeInfo):
    if arr.is_floating_point():
        return ~torch.isnan(arr)
    return arr != ti.null_sentinel()


def _broadcast(x, n: int):
    x = torch.as_tensor(x)
    return x.expand(n) if x.shape != (n,) else x


def build_compound_kernel(node, batches, plan, device):
    """Returns (kernel_fn, layout).  kernel_fn(*args) -> dict."""
    from heavydb_tpu_torch.exec.executor import _KernelLayout

    strategy = plan.group_strategy
    cap = plan.group_cap
    if node.is_aggregate and strategy[0] not in ("perfect", "keyless",
                                                 "radix", "sort"):
        raise NotSupported(f"the {strategy[0]} group-by strategy")

    b0 = batches[0]
    present_cols = [ci for ci, c in enumerate(b0.cols) if c is not None]
    layout = _KernelLayout([(0, present_cols)], [0])
    domain_size = b0.padded
    col_types = list(b0.types)

    def kernel(*args):
        cols = dict(zip(present_cols, args[:len(present_cols)]))
        nrows = args[len(present_cols)]
        error_flags: Dict[str, torch.Tensor] = {}
        # the rows [0, nrows) of the padded domain: a bool fill and a
        # cleared tail, not an int64 iota compared with nrows
        mask = torch.ones(domain_size, dtype=torch.bool, device=device)
        mask[nrows:] = False
        trivial = True  # mask == iota<nrows, no compaction needed
        tv_cache: Dict[int, tuple] = {}

        def field_tv(f: int):
            hit = tv_cache.get(f)
            if hit is None:
                val = cols[f]
                ti = col_types[f]
                hit = (val, derive_valid(val, ti) if ti.nullable else None)
                tv_cache[f] = hit
            return hit

        def domain_compiler(exprs):
            needed = set()
            for e in exprs:
                if e is not None:
                    needed |= {r.field_idx for r in E.collect_input_refs(e)}
            return ExprCompiler({f: field_tv(f) for f in needed},
                                error_flags, device, domain_size)

        # ---- filter ----
        if node.filter_cond is not None:
            fc = domain_compiler([node.filter_cond])
            mask = mask & fc.compile_predicate(node.filter_cond)
            trivial = False

        def merge_masked_flags(tmp, m):
            # error flags raised by expressions only count for rows/groups
            # that survive to be evaluated (reference: row-wise codegen
            # guards expression eval behind the filter)
            for name, vec in tmp.items():
                v = vec & m
                error_flags[name] = error_flags[name] | v \
                    if name in error_flags else v

        out: Dict[str, object] = {}
        if not node.is_aggregate:
            # ---- projection ----
            tc = domain_compiler(node.target_exprs)
            tflags: Dict[str, torch.Tensor] = {}
            tc.error_flags = tflags
            outs = []
            for e, ti in zip(node.target_exprs, node.types):
                val, valid = tc.compile(e)
                val = _broadcast(val.to(G.torch_dtype(ti.np_dtype())), domain_size)
                if valid is not None:
                    valid = _broadcast(valid, domain_size)
                outs.append(_sentinelize(val, valid, ti))
            merge_masked_flags(tflags, mask)
            if trivial:
                out["cols"] = tuple(outs)
                out["n_out"] = torch.tensor(nrows, dtype=torch.int32)
            else:
                perm = G.compact_perm(mask)
                out["cols"] = tuple(o[perm] for o in outs)
                out["n_out"] = mask.sum().to(torch.int32)
        else:
            out.update(_aggregate(node, strategy, cap, mask, domain_compiler,
                                  merge_masked_flags, device))

        for name, flag in error_flags.items():
            out[f"err_{name}"] = flag.any()
        ck = ctrl_keys(out)
        if ck:
            out["ctrl_vec"] = torch.stack([
                torch.as_tensor(out[k]).to(device=device, dtype=torch.int32)
                for k in ck
            ])
        return out

    return kernel, layout


def _slot_coords(slot_ids, ranges):
    """Per-key coordinates of perfect slot ids (the inverse of
    ops.groupby.perfect_group_ids)."""
    rem = slot_ids
    coords = []
    for (mn, extent, has_nulls, bucket) in reversed(ranges):
        span = extent + (1 if has_nulls else 0)
        coords.append(rem % span)
        rem = rem // span
    coords.reverse()
    return coords


def _aggregate(node, strategy, cap, mask, domain_compiler, merge_masked_flags,
               device) -> dict:
    n_keys = len(node.group_exprs)
    kc = domain_compiler(node.group_exprs + list(node.aggs))
    aflags: Dict[str, torch.Tensor] = {}
    kc.error_flags = aflags
    kind = strategy[0]
    lowered = [AGG.LoweredAgg(a) for a in node.aggs]
    res: Dict[str, object] = {}
    key_tvs = [kc.compile(g) for g in node.group_exprs]
    key_tvs = [(_broadcast(v, kc.domain_size), m) for v, m in key_tvs]
    agg_kc, agg_mask, segs, partials = kc, mask, None, None
    if kind == "perfect":
        ranges = strategy[1]
        gid, slots = G.perfect_group_ids(key_tvs, ranges, mask)
        agg_gid = gid
        num_groups = torch.tensor(slots, dtype=torch.int32)
        # positional key reconstruction: the slot id is an arithmetic code
        # of the key tuple, so slot -> key is arithmetic.  Only BUCKETED
        # keys (DATE_TRUNC ranges) need a min-scan to recover the value;
        # the NULL slot is a fixed coordinate either way.
        coords = _slot_coords(torch.arange(slots, dtype=torch.int64,
                                           device=device), ranges)
        key_out_tvs = []
        for (val, _), gexpr, rng, coord in zip(key_tvs, node.group_exprs,
                                               ranges, coords):
            mn, extent, has_nulls, bucket = rng
            dt = G.torch_dtype(gexpr.type.np_dtype())
            if bucket > 1:
                kbuf = G.segment_minmax(gid, val.to(dt), mask, slots, is_min=True)
            else:
                kbuf = (coord + mn).to(dt)
            key_out_tvs.append((kbuf, (coord < extent) if has_nulls else None))
    elif kind == "keyless":
        slots = 1
        agg_gid = torch.where(mask, 0, 1).to(torch.int32)
        num_groups = torch.tensor(1, dtype=torch.int32)
        key_out_tvs = []
    elif kind == "radix":
        # dense slot ids as for perfect hash -> radix partition + per
        # partition sort and segmented reduce (kernels B5, B6), which
        # return compacted per-group records in hash order
        ranges = strategy[1]
        slots = cap
        gid, num_slots = G.perfect_group_ids(key_tvs, ranges, mask)
        specs = RT.plan_aggs(node.aggs)
        if specs is None:
            raise RT.RadixUnsupported("aggregate set fell out of the stream "
                                      "budget")
        streams, jobs = RT.build_streams(lowered, specs, kc, mask)
        gid_out, len_out, totals, num_groups, ovf = RG.sparse_groupby(
            gid, streams, num_slots, slots)
        res["radix_overflow"] = ovf
        partials = RT.finalize_partials(jobs, len_out, totals)
        # keys from the compacted slot ids: arithmetic (bucketed ranges
        # stay off this tier)
        coords = _slot_coords(gid_out.to(torch.int64), ranges)
        key_out_tvs = []
        for gexpr, (mn, extent, has_nulls, _), coord in zip(
                node.group_exprs, ranges, coords):
            dt = G.torch_dtype(gexpr.type.np_dtype())
            key_out_tvs.append(((coord + mn).to(dt),
                                (coord < extent) if has_nulls else None))
    else:  # sort: aggregate over the sorted row domain
        slots = cap
        # aggregate arguments compile once in row order and ride the
        # grouping permutation as payloads
        seeds = {}
        for a in node.aggs:
            for e in (a.arg, a.arg2):
                if e is not None and E.collect_input_refs(e) \
                        and e.key() not in seeds:
                    seeds[e.key()] = kc.compile(e)
        payloads, layout = [], []
        for ekey, (val, valid) in seeds.items():
            payloads.append(_broadcast(val, kc.domain_size))
            if valid is not None:
                payloads.append(_broadcast(valid, kc.domain_size))
            layout.append((ekey, valid is not None))
        (agg_gid, s_rows, agg_mask, changed, num_groups, sorted_keys,
         sorted_pl) = G.sort_group_rows(key_tvs, mask, slots, payloads,
                                         need_rows=bool(payloads))
        segs = G.SortedSegments(changed, agg_mask, num_groups, slots)
        agg_kc = _SortedCompiler(kc, s_rows)
        it = iter(sorted_pl)
        for ekey, has_valid in layout:
            agg_kc.memo[ekey] = (next(it), next(it) if has_valid else None)
        # keys at group-start rows, deferred through the compaction
        key_out_tvs = [
            (segs.defer(sv),
             segs.defer(svalid) if gexpr.type.nullable else None)
            for (sv, svalid), gexpr in zip(sorted_keys, node.group_exprs)]
    res["num_groups"] = num_groups

    present_counts = None
    if partials is None:
        partials, present_counts = AGG.accumulate_all(
            lowered, agg_kc, agg_gid, agg_mask, slots,
            want_present=kind == "perfect", segs=segs)
    if segs is not None:
        # one compaction materializes every deferred per-group array
        segs.flush()
        partials = [{k: segs.resolve(v) for k, v in p.items()}
                    for p in partials]
        key_out_tvs = [(segs.resolve(a), segs.resolve(b) if b is not None
                        else None) for a, b in key_out_tvs]
    merge_masked_flags(aflags, mask)
    agg_tvs = [la.finalize(p) for la, p in zip(lowered, partials)]
    if kind == "perfect":
        present = present_counts > 0
    elif kind == "keyless":
        present = torch.ones(1, dtype=torch.bool, device=device)
    else:  # sort / radix: compacted, dense by construction
        present = torch.arange(slots, device=device) < torch.clamp(
            num_groups, max=slots)

    # group-domain compiler: fields = keys ++ agg results
    gcols = dict(enumerate(key_out_tvs))
    for j, tv in enumerate(agg_tvs):
        gcols[n_keys + j] = tv
    gflags: Dict[str, torch.Tensor] = {}
    gcomp = ExprCompiler(gcols, gflags, device, slots)
    if node.having is not None:
        present = present & gcomp.compile_predicate(node.having)
    outs = []
    for e, ti in zip(node.target_exprs, node.types):
        val, valid = gcomp.compile(e)
        val = _broadcast(val.to(G.torch_dtype(ti.np_dtype())), slots)
        if valid is not None:
            valid = _broadcast(valid, slots)
        outs.append(_sentinelize(val, valid, ti))
    merge_masked_flags(gflags, present)
    if kind == "keyless":
        res["cols"] = tuple(outs)
        res["n_out"] = torch.tensor(1, dtype=torch.int32)
    elif kind in ("sort", "radix") and node.having is None:
        # groups 0 .. num_groups-1 already: no compaction
        res["cols"] = tuple(outs)
        res["n_out"] = torch.clamp(num_groups, max=slots)
    else:
        perm = G.compact_perm(present)
        res["cols"] = tuple(o[perm] for o in outs)
        res["n_out"] = present.sum().to(torch.int32)
    return res


class _SortedCompiler:
    """Row-domain ExprCompiler seen through the sort permutation:
    expressions compile in original row order (error flags stay in the
    row domain) and their results gather into the sorted row domain for
    the sorted-segment aggregation (ops.groupby.SortedSegments).  `memo`
    holds the aggregate arguments that rode the sort as payloads."""

    def __init__(self, base, s_rows):
        self._base = base
        self._rows = s_rows
        self.memo = {}

    def __getattr__(self, name):
        return getattr(self._base, name)

    def _gather(self, a):
        if a is None or not torch.is_tensor(a) or a.dim() == 0 \
                or a.shape[0] != self._rows.shape[0]:
            return a
        return a[self._rows]

    def compile(self, e):
        key = e.key()
        hit = self.memo.get(key)
        if hit is None:
            val, valid = self._base.compile(e)
            hit = (self._gather(val), self._gather(valid))
            self.memo[key] = hit
        return hit

    def compile_predicate(self, e):
        val, valid = self.compile(e)
        val = torch.as_tensor(val).to(torch.bool)
        return val if valid is None else val & valid
