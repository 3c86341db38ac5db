"""Compound work-unit kernel builder.

Port of heavydb_tpu/exec/compound_kernel.py: join builds and probes ->
filter mask -> projection, or -> keyless / perfect-hash / radix / hash /
sort group-by with aggregates -> HAVING -> compaction.  The reference traces one
closure per Compound into a single XLA program; torch runs the same
closure eagerly, op by op, with the group-by aggregates in the
hand-written kernels (ops/groupby.py, kernels/radix_groupby.py) and the
joins in plain torch (ops/join.py), as the reference's are plain XLA.

The join levels keep a domain: per input, the row index of each domain
slot (`idx`, None = the identity over input 0) and a matched flag (False
= a LEFT / FULL null-extended row); a level expands the domain to its
capacity, or keeps it when the build's keys are unique.  A size that only
the run can know is read on the host where the run computes it, each read
in the caller's timer's `size_read` scope, and the program is sized or
switched in the same run: the sort tier's group domain from the exact
group count (where the row domain is larger than the plan's first cap),
and a unique-build level that meets a duplicate key expands over the same
build into its fallback capacity.  The closure returns a dict with the
output columns, the exact row count, the group count, each join level's
exact needed capacity and hash-miss flag, the radix tier's overflow bits,
the hash tier's unresolved rows and the error flags; the control scalars
also ride packed in one int64 tensor ('ctrl_vec') that the executor reads
with a single host copy.  Host values beside them: 'sized_in_run', what
the run sized ("groups", "join_dup#<level>"), and 'join_fallback_<level>',
the capacity a unique-build level expanded into.  Each join level runs in
the timer's `join#<level>` scope, its builds in `build` and its probes and
expansions in `probe`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.exec import batch as B
from heavydb_tpu_torch.exec import radix_tier as RT
from heavydb_tpu_torch.exec.expr_compiler import ExprCompiler, and_valid
from heavydb_tpu_torch.kernels import radix_groupby as RG
from heavydb_tpu_torch.ops import agg as AGG
from heavydb_tpu_torch.ops import groupby as G
from heavydb_tpu_torch.ops import join as J
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.utils.timer import NULL_TIMER

# the reference's uint64 constants as int64 bit patterns (ops/groupby.py)
_SM_GOLDEN, _SM_MUL1, _SM_MUL2 = G._SM_GOLDEN, G._SM_MUL1, G._SM_MUL2
_srl = G._srl
_HASH_SEED = 0x243F6A8885A308D3

# claim scatters that collide cost ~4.6 us a slot past VMEM on the TPU, so
# the reference keeps builds past 2^21 slots on the sorted form; kept as
# is, so that the plan, its caps and its retries match the reference's
_JOIN_HASH_MAX_SLOTS = 1 << 21


def _splitmix64_combine(h, k):
    """The reference's uint64 splitmix64 combine, in int64: wrapping int64
    adds and products have the uint64 ones' bits."""
    x = k + _SM_GOLDEN + h * 64 + _srl(h, 2)
    z = (x ^ _srl(x, 30)) * _SM_MUL1
    z = (z ^ _srl(z, 27)) * _SM_MUL2
    return h ^ (z ^ _srl(z, 31))


def _join_hash_slots(build_padded: int) -> int:
    # >= 2x the build row count (unique keys <= rows), pow2 for masking
    return 1 << max(int(build_padded * 2 - 1).bit_length(), 12)


def _cellify(x, y, cell):
    """Coordinates -> their int64 grid cell, floor(coordinate / cell) in
    float64 clipped to +-2^30 (exec/geo_join.py: clipping merges far-out
    cells, so it adds candidates and never loses one)."""
    def axis(v):
        return torch.floor(v.to(torch.float64) / cell).clamp(-(2.0 ** 30), 2.0 ** 30) \
            .to(torch.int64)

    return axis(x), axis(y)


def _pack_cells(ci, cj):
    return (ci << 32) | (cj & 0xFFFFFFFF)


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
    deterministic order; they also ride packed in one int64 tensor
    ('ctrl_vec') so the host reads them with one copy."""
    return sorted(k for k in d if k in ("n_out", "num_groups", "radix_overflow",
                                         "hash_unresolved")
                  or k.startswith(("join_needed_", "join_hash_miss_", "err_")))


def derive_valid(arr, ti: T.TypeInfo):
    if arr.is_floating_point():
        return ~torch.isnan(arr)
    return arr != ti.null_sentinel()


def _broadcast(x, n: int):
    x = torch.as_tensor(x)
    return x.expand(n) if x.shape != (n,) else x


def _iota(n: int, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def input_of_field(offsets, f: int):
    """(input, local field) of combined-schema field f, given each input's
    first field."""
    for i in reversed(range(len(offsets))):
        if f >= offsets[i]:
            return i, f - offsets[i]
    raise AssertionError(f"field {f} is in no input")


class _Domain:
    """The rows a Compound's kernel works over and how to read a field of
    any input there.  idx[i]: input i's row of each domain slot (None = the
    identity over input 0, before any expanding join); matched[i]: False
    where the slot is a null-extended row of an outer join (None = all
    matched)."""

    def __init__(self, cols, col_types, offsets, aux, nrows, padded0, device,
                 udfs=None):
        self.cols = cols
        self.udfs = udfs
        self.col_types = col_types
        self.offsets = offsets
        self.aux = aux
        self.nrows = nrows
        self.device = device
        self.error_flags: Dict[str, torch.Tensor] = {}
        self.idx: Dict[int, Optional[torch.Tensor]] = {0: None}
        self.matched: Dict[int, Optional[torch.Tensor]] = {0: None}
        self.size = padded0
        # the rows [0, nrows) of the padded domain: a bool fill and a
        # cleared tail, not an int64 iota compared with nrows
        self.mask = torch.ones(padded0, dtype=torch.bool, device=device)
        self.mask[nrows[0]:] = False
        self.trivial = True  # mask == iota < nrows[0]: no compaction needed
        self.tv_cache: Dict[int, tuple] = {}

    def field_tv(self, f: int):
        """TV of combined-schema field f over the current domain."""
        hit = self.tv_cache.get(f)
        if hit is not None:
            return hit
        i, local = input_of_field(self.offsets, f)
        val = self.cols[i][local]
        ti = self.col_types[i][local]
        if self.idx.get(i) is not None or i != 0:
            val = val[self.idx[i]]
        valid = derive_valid(val, ti) if ti.nullable else None
        if self.matched.get(i) is not None:
            valid = and_valid(valid, self.matched[i])
        hit = self.tv_cache[f] = (val, valid)
        return hit

    def compiler(self, exprs):
        needed = set()
        for e in exprs:
            if e is not None:
                needed |= {r.field_idx for r in E.collect_input_refs(e)}
        return ExprCompiler({f: self.field_tv(f) for f in needed}, self.aux,
                            self.error_flags, self.device, self.size, self.udfs)

    def restrict(self, preds):
        """mask &= each predicate over the current domain."""
        if preds:
            c = self.compiler(preds)
            for p in preds:
                self.mask = self.mask & c.compile_predicate(p)

    def remap(self, pidx):
        """Carry every input's row index and matched flag through pidx."""
        for i in list(self.idx):
            self.idx[i] = pidx if self.idx[i] is None else self.idx[i][pidx]
            if self.matched.get(i) is not None:
                self.matched[i] = self.matched[i][pidx]
        self.tv_cache.clear()

    def build_side_tv(self, expr, bi: int, pb: int):
        """Evaluate an expression directly over input bi's pb padded rows."""
        cdict = {}
        for r in E.collect_input_refs(expr):
            local = r.field_idx - self.offsets[bi]
            base = self.cols[bi][local]
            ti = self.col_types[bi][local]
            cdict[r.field_idx] = (base, derive_valid(base, ti) if ti.nullable else None)
        val, valid = ExprCompiler(cdict, self.aux, self.error_flags, self.device,
                                  pb, self.udfs).compile(expr)
        return _broadcast(val, pb), valid


def _pack_keys(tvs, jp, n: int):
    """One or more key TVs -> a single int64 key and its validity."""
    valid = None
    for _, v in tvs:
        valid = and_valid(valid, v)
    vals = [_broadcast(v, n).to(torch.int64) for v, _ in tvs]
    if jp.pack == "single":
        return vals[0], valid
    if jp.pack == "range":
        k = None
        for val, (lo, ext) in zip(vals, jp.pack_spans):
            part = (val - lo).clamp(0, ext - 1)
            k = part if k is None else k * ext + part
        return k, valid
    # hash pack (the planner appended an equality recheck to the residual)
    h = torch.full((n,), _HASH_SEED, dtype=torch.int64, device=vals[0].device)
    for val in vals:
        h = _splitmix64_combine(h, val)
    return _srl(h, 1), valid


def build_compound_kernel(node, batches, plan, device):
    """Returns (kernel_fn, layout).  kernel_fn(*args, timer=...) -> dict;
    `timer` (utils/timer.py) takes the join levels' scopes."""
    from heavydb_tpu_torch.exec.executor import _KernelLayout

    strategy = plan.group_strategy
    cap = plan.group_cap
    n_inputs = len(batches)
    offsets = list(plan.offsets)
    batch_cols = [(bi, [ci for ci, c in enumerate(b.cols) if c is not None])
                  for bi, b in enumerate(batches)]
    aux_order = sorted(plan.aux_specs, key=repr)
    layout = _KernelLayout(batch_cols, list(range(n_inputs)), aux_order)
    paddeds = [b.padded for b in batches]
    col_types = [list(b.types) for b in batches]
    # a snapshot: the executor changes the plan's join levels after this
    # kernel is cached under their old values
    joins = [dataclasses.replace(jp) for jp in plan.joins]
    caps = list(plan.caps)
    # the filter push-down split (executor._plan_compound): probe-side
    # conjuncts tighten the mask before any expansion, build-side ones keep
    # rows out of the join tables
    pre_mask = list(plan.pre_mask)
    build_filters = dict(plan.build_filters)
    filter_rest = plan.filter_rest
    distinct_force_sort = plan.distinct_force_sort
    udfs = plan.udfs

    def kernel(*args, timer=NULL_TIMER):
        it = iter(args)
        cols = {bi: {ci: next(it) for ci in present} for bi, present in batch_cols}
        nrows = [next(it) for _ in range(n_inputs)]
        aux = {k: next(it) for k in aux_order}
        dom = _Domain(cols, col_types, offsets, aux, nrows, paddeds[0], device, udfs)
        out: Dict[str, object] = {}
        sized = []  # what this run sized from a host read
        if pre_mask:
            dom.restrict(pre_mask)
            dom.trivial = False
        for li, jp in enumerate(joins):
            with timer.scope(f"join#{li}"):
                _join_level(dom, li, jp, caps[li], paddeds[li + 1],
                            build_filters.get(li + 1, ()), out, timer, sized)

        # ---- filter ----
        if filter_rest is not None:
            # split performed: only the conjuncts left after it run here
            if filter_rest:
                dom.restrict(filter_rest)
                dom.trivial = False
        elif node.filter_cond is not None:
            dom.restrict([node.filter_cond])
            dom.trivial = False

        error_flags = dom.error_flags

        def merge_masked_flags(tmp, m):
            # error flags raised by expressions only count for rows/groups
            # that survive to be evaluated (reference: row-wise codegen
            # guards expression eval behind the filter)
            for name, vec in tmp.items():
                v = vec & m
                error_flags[name] = error_flags[name] | v \
                    if name in error_flags else v

        mask = dom.mask
        if not node.is_aggregate:
            # ---- projection ----
            tc = dom.compiler(node.target_exprs)
            tflags: Dict[str, torch.Tensor] = {}
            tc.error_flags = tflags
            outs = []
            for e, ti in zip(node.target_exprs, node.types):
                val, valid = tc.compile(e)
                val = _broadcast(val.to(G.torch_dtype(ti.np_dtype())), dom.size)
                if valid is not None:
                    valid = _broadcast(valid, dom.size)
                outs.append(_sentinelize(val, valid, ti))
            merge_masked_flags(tflags, mask)
            if dom.trivial:
                out["cols"] = tuple(outs)
                out["n_out"] = torch.tensor(nrows[0], dtype=torch.int32)
            else:
                perm = G.compact_perm(mask)
                out["cols"] = tuple(o[perm] for o in outs)
                out["n_out"] = mask.sum().to(torch.int32)
        else:
            out.update(_aggregate(node, strategy, cap, mask, dom.compiler,
                                  merge_masked_flags, device, distinct_force_sort,
                                  timer, sized))

        for name, flag in error_flags.items():
            out[f"err_{name}"] = flag.any()
        ck = ctrl_keys(out)
        if ck:
            out["ctrl_vec"] = torch.stack([
                torch.as_tensor(out[k]).to(device=device, dtype=torch.int64)
                for k in ck
            ])
        if sized:
            out["sized_in_run"] = sized
        return out

    return kernel, layout


def _build_keys(dom: _Domain, jp, bi: int, pb: int, filters):
    """The build input's packed key and validity: dictionary ids translated
    into the probe's dictionary, the pushed build-side filters ANDed in."""
    tvs = [dom.build_side_tv(e, bi, pb) for e in jp.build_keys]
    if jp.translate is not None:
        tbl = dom.aux[jp.translate]
        bval, bvalid = tvs[0]
        safe = bval.clamp(0, tbl.shape[0] - 1).to(torch.int64)
        tvs = [(torch.where((bval >= 0) & (bval < tbl.shape[0]), tbl[safe], -1),
                bvalid)]
    bkey, bvalid = _pack_keys(tvs, jp, pb)
    return bkey, _filtered(dom, bi, pb, filters, bvalid)


def _filtered(dom: _Domain, bi: int, pb: int, filters, bvalid):
    """A build input's validity with its pushed-down filters ANDed in."""
    for c in filters:
        val, valid = dom.build_side_tv(c, bi, pb)
        keep = val.to(torch.bool)
        if valid is not None:
            keep = keep & valid
        bvalid = keep if bvalid is None else bvalid & keep
    return bvalid


def _probe_keys(dom: _Domain, jp):
    pc = dom.compiler(jp.probe_keys)
    pkey, pvalid = _pack_keys([pc.compile(e) for e in jp.probe_keys], jp, dom.size)
    return pkey, dom.mask if pvalid is None else dom.mask & pvalid


def _sorted_or_hash(jp, li, bkey, bvalid, nrows_b, pb, pkey, pvalid_m, out, timer):
    """Probe through a sorted build, or the hash table over it (a key that
    claims no slot sets join_hash_miss_<li>; the executor reruns the level
    sorted).  Returns (lo, cnt, build rows in match order)."""
    table = None
    with timer.scope("build"):
        build = J.build_sorted(bkey, bvalid, nrows_b)
        if not (jp.hash_fallback or _join_hash_slots(pb) > _JOIN_HASH_MAX_SLOTS):
            table = J.build_hash_table(build, _join_hash_slots(build.keys_sorted.shape[0]))
            out[f"join_hash_miss_{li}"] = table.unresolved
    with timer.scope("probe"):
        if table is None:
            lo, cnt = J.probe_counts(build, pkey, pvalid_m)
        else:
            lo, cnt = J.probe_counts_hash(table, pkey, pvalid_m)
    return lo, cnt, build.rows_sorted


def _geo_candidates(dom: _Domain, li: int, jp, pb: int, filters, out, timer):
    """The grid-bucket spatial join's candidates (exec/geo_join.py): each
    probe row keys on its own cell, each build row registers under
    len(offsets) neighbouring cells (a replicated build of the existing
    sorted or hash form); a (probe, build) pair meets under exactly one
    cell, the probe's.  The exact geo predicate stays in jp.residual.
    Returns (lo, cnt, build rows in match order) over the domain."""
    gs = jp.geo
    bi = li + 1
    dev = dom.device
    cell = gs.cell if gs.cell is not None else dom.aux[gs.bbox_key][2][0]

    def bbox_corner(rid, ridv):
        # a polygon's key point: its bounding box's min corner
        xmin_a, ymin_a, _ = dom.aux[gs.bbox_key]
        ridc = rid.to(torch.int64).clamp(0, xmin_a.shape[0] - 1)
        x, y = xmin_a[ridc], ymin_a[ridc]
        return x, y, and_valid(~torch.isnan(x), ridv)

    pc = dom.compiler(jp.probe_keys)
    if gs.kind == "poly_probe":
        px, py, pvalid = bbox_corner(*pc.compile(jp.probe_keys[0]))
    else:
        (px, pxv), (py, pyv) = pc.compile(jp.probe_keys[0]), pc.compile(jp.probe_keys[1])
        pvalid = and_valid(pxv, pyv)
    pkey = _pack_cells(*_cellify(_broadcast(px, dom.size), _broadcast(py, dom.size), cell))
    pvalid_m = dom.mask if pvalid is None else dom.mask & pvalid
    if gs.kind == "poly_build":
        bx, by, bvalid = bbox_corner(*dom.build_side_tv(jp.build_keys[0], bi, pb))
    else:
        (bx, bxv), (by, byv) = (dom.build_side_tv(e, bi, pb) for e in jp.build_keys)
        bvalid = and_valid(bxv, byv)
    bvalid = _filtered(dom, bi, pb, filters, bvalid)
    bci, bcj = _cellify(bx, by, cell)
    reps = len(gs.offsets)
    bkeys = torch.cat([_pack_cells(bci + di, bcj + dj) for di, dj in gs.offsets])
    bok = _iota(pb, dev) < dom.nrows[bi]
    if bvalid is not None:
        bok = bok & bvalid
    lo, cnt, rows = _sorted_or_hash(jp, li, bkeys, bok.repeat(reps), reps * pb, reps * pb,
                                    pkey, pvalid_m, out, timer)
    # a replicated key's payload index -> its build row
    return lo, cnt, rows % pb


def _surviving_per_row(eff, ok, cap: int):
    """Per probe row, how many of its expanded slots (probe-major, at the
    exclusive prefix sums of `eff`) pass `ok`, from two prefix sums."""
    ends = torch.cumsum(eff, 0, dtype=torch.int64)
    starts = ends - eff
    pref = torch.cat([torch.zeros(1, dtype=torch.int64, device=ok.device),
                      torch.cumsum(ok, 0, dtype=torch.int64)])
    return pref[ends.clamp(max=cap)] - pref[starts.clamp(max=cap)]


def _join_level(dom: _Domain, li: int, jp, cap: int, pb: int, filters, out, timer,
                sized):
    """Join level li: input li + 1 is the build side over the current
    domain.  SEMI / ANTI refine the mask; the others expand the domain
    (or keep it, for a unique build whose probe found no duplicate key)
    and carry every input through.  The J.build_* calls run in `timer`'s
    `build` scope, the probes and expansions in `probe`, the duplicate
    check's host read in `size_read`; a level that expands instead of
    keeping its unique build's domain appends "join_dup#<li>" to `sized`."""
    bi = li + 1
    dev = dom.device
    needed_key = f"join_needed_{li}"
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    left_outer = jp.kind in ("LEFT", "FULL")
    # LEFT with residual conditions: a pair failing the residual is NOT a
    # match (ON-clause semantics): expand pairs only, apply the residual,
    # then append a null-extended slot for every probe row that lost all
    # its matches
    left_resid = jp.kind == "LEFT" and bool(jp.residual)
    if jp.kind in ("SEMI", "ANTI"):
        # existence joins: refine the mask, no domain expansion
        pkey, pvalid_m = _probe_keys(dom, jp)
        bkey, bvalid = _build_keys(dom, jp, bi, pb, filters)
        if jp.key_min is not None:
            with timer.scope("build"):
                pbuild = J.build_perfect(bkey, bvalid, dom.nrows[bi], jp.key_min,
                                         jp.key_range)
            with timer.scope("probe"):
                lo, cnt = J.probe_perfect(pbuild, pkey, pvalid_m, jp.key_range)
            rows_by_slot = pbuild.payload
        else:
            lo, cnt, rows_by_slot = _sorted_or_hash(
                jp, li, bkey, bvalid, dom.nrows[bi], pb, pkey, pvalid_m, out, timer)
        if jp.residual:
            # residual conditions (TPC-H Q4 / Q21's correlated comparisons,
            # hash-pack rechecks) need the candidate pairs: expand, test,
            # then count each probe row's surviving pairs
            with timer.scope("probe"):
                pidx, bidx, out_mask, _, needed = J.expand_matches(
                    lo, cnt, rows_by_slot, dom.mask, cap, False)
            out[needed_key] = needed
            saved = (dict(dom.idx), dict(dom.matched), dom.size)
            dom.remap(pidx)
            dom.idx[bi] = bidx
            dom.matched[bi] = None
            dom.size = cap
            rc = dom.compiler(jp.residual)
            ok = out_mask
            for r in jp.residual:
                ok = ok & rc.compile_predicate(r)
            dom.idx, dom.matched, dom.size = saved
            dom.tv_cache.clear()
            eff = torch.where(dom.mask, cnt, 0)
            exists = _surviving_per_row(eff, ok, cap) > 0
        else:
            exists = cnt > 0
            out[needed_key] = zero
        # ANTI keeps rows with no match; a NULL key never matches, so its
        # row is kept (NOT EXISTS semantics)
        dom.mask = dom.mask & (exists if jp.kind == "SEMI" else ~exists)
        dom.trivial = False
        return
    if jp.kind == "CROSS":
        lo = torch.zeros(dom.size, dtype=torch.int32, device=dev)
        cnt = torch.where(dom.mask, dom.nrows[bi], 0).to(torch.int32)
        rows_by_slot = _iota(pb, dev)
        with timer.scope("probe"):
            pidx, bidx, out_mask, m_new, needed = J.expand_matches(
                lo, cnt, rows_by_slot, dom.mask, cap, False)
    elif jp.geo is not None:
        lo, cnt, rows_by_slot = _geo_candidates(dom, li, jp, pb, filters, out, timer)
        with timer.scope("probe"):
            pidx, bidx, out_mask, m_new, needed = J.expand_matches(
                lo, cnt, rows_by_slot, dom.mask, cap, False)
    else:
        pkey, pvalid_m = _probe_keys(dom, jp)
        bkey, bvalid = _build_keys(dom, jp, bi, pb, filters)
        unique = None
        if jp.key_min is not None:
            # dense-range positional build: the probe is gathers
            with timer.scope("build"):
                pbuild = J.build_perfect(bkey, bvalid, dom.nrows[bi], jp.key_min,
                                         jp.key_range)
            with timer.scope("probe"):
                if jp.unique_build:
                    # PK-FK: slot -> build row composed on the build side
                    unique = J.probe_perfect_unique(pbuild, pkey, pvalid_m,
                                                    jp.key_range, dom.mask)
                else:
                    lo, cnt = J.probe_perfect(pbuild, pkey, pvalid_m, jp.key_range)
                    rows_by_slot = pbuild.payload
        else:
            lo, cnt, rows_by_slot = _sorted_or_hash(
                jp, li, bkey, bvalid, dom.nrows[bi], pb, pkey, pvalid_m, out, timer)
            if jp.unique_build:
                with timer.scope("probe"):
                    bidx_u, matched_u = J.probe_unique(lo, cnt, rows_by_slot, dom.mask)
                unique = (bidx_u, cnt, matched_u)
        if unique is not None:
            bidx_u, cnt, matched_u = unique
            with timer.scope("size_read"):
                dup = bool(cnt.max() > 1)
            if not dup:
                # at most one match a probe row: the identity domain
                out[needed_key] = zero
                dom.idx[bi] = bidx_u
                if left_outer:
                    dom.matched[bi] = matched_u
                else:
                    dom.mask = dom.mask & matched_u
                    dom.matched[bi] = None
                dom.trivial = False
                dom.tv_cache.clear()
                dom.restrict(jp.residual)
                return
            # a duplicate build key undoes the guess: expand over the same
            # build into the level's fallback capacity (past it, the
            # executor's join_cap rung reruns at the exact one)
            cap = jp.fallback_cap
            out[f"join_fallback_{li}"] = cap
            sized.append(f"join_dup#{li}")
            if jp.key_min is not None:
                with timer.scope("probe"):
                    lo, cnt = J.probe_perfect(pbuild, pkey, pvalid_m, jp.key_range)
                rows_by_slot = pbuild.payload
        with timer.scope("probe"):
            pidx, bidx, out_mask, m_new, needed = J.expand_matches(
                lo, cnt, rows_by_slot, dom.mask, cap, left_outer and not left_resid)
    out[needed_key] = needed
    prev_idx, prev_matched = dict(dom.idx), dict(dom.matched)
    prev_mask, prev_size = dom.mask, dom.size
    dom.remap(pidx)
    dom.idx[bi] = bidx
    dom.matched[bi] = m_new if (left_outer and not left_resid) else None
    dom.mask = out_mask
    dom.size = cap
    if jp.kind == "FULL":
        # one slot per build row, valid for the unmatched real ones, the
        # probe-side fields NULL there: inner + left-null + right-null
        with timer.scope("probe"):
            bm = J.build_matched_flags(lo, cnt, rows_by_slot, pvalid_m, pb)
        extra = _iota(pb, dev)
        extra_valid = (extra < dom.nrows[bi]) & ~bm
        for i in list(dom.idx):
            if i == bi:
                continue
            dom.idx[i] = torch.cat([dom.idx[i], torch.zeros_like(extra)])
            pm = dom.matched.get(i)
            if pm is None:
                pm = torch.ones(cap, dtype=torch.bool, device=dev)
            dom.matched[i] = torch.cat([pm, torch.zeros(pb, dtype=torch.bool,
                                                        device=dev)])
        dom.idx[bi] = torch.cat([dom.idx[bi], extra])
        dom.matched[bi] = torch.cat([dom.matched[bi],
                                     torch.ones(pb, dtype=torch.bool, device=dev)])
        dom.mask = torch.cat([dom.mask, extra_valid])
        dom.size = cap + pb
    dom.trivial = False
    dom.tv_cache.clear()
    # residual conjuncts (INNER semantics)
    dom.restrict(jp.residual)
    if left_resid:
        # a null-extended slot for each previous domain row none of whose
        # pairs survived
        eff = torch.where(prev_mask, cnt, 0)
        extra_valid = prev_mask & (_surviving_per_row(eff, dom.mask, cap) == 0)
        for i in list(dom.idx):
            if i == bi:
                continue
            pi = prev_idx.get(i)
            if pi is None:
                pi = _iota(prev_size, dev)
            dom.idx[i] = torch.cat([dom.idx[i], pi])
            pm, ppm = dom.matched.get(i), prev_matched.get(i)
            if pm is not None or ppm is not None:
                if pm is None:
                    pm = torch.ones(cap, dtype=torch.bool, device=dev)
                if ppm is None:
                    ppm = torch.ones(prev_size, dtype=torch.bool, device=dev)
                dom.matched[i] = torch.cat([pm, ppm])
        dom.idx[bi] = torch.cat([dom.idx[bi], torch.zeros(prev_size, dtype=torch.int32,
                                                          device=dev)])
        mb = dom.matched.get(bi)
        if mb is None:
            mb = torch.ones(cap, dtype=torch.bool, device=dev)
        dom.matched[bi] = torch.cat([mb, torch.zeros(prev_size, dtype=torch.bool,
                                                     device=dev)])
        dom.mask = torch.cat([dom.mask, extra_valid])
        dom.size = cap + prev_size
        dom.tv_cache.clear()


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
               device, distinct_force_sort, timer, sized) -> dict:
    n_keys = len(node.group_exprs)
    kc = domain_compiler(node.group_exprs + list(node.aggs))
    aflags: Dict[str, torch.Tensor] = {}
    kc.error_flags = aflags
    # COUNT(DISTINCT) on its sorted form, not the hash form
    kc.distinct_force_sort = distinct_force_sort
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
    elif kind == "hash":
        # sparse keys: slot claiming over the packed keys (the reference's
        # GroupByBaselineHash open addressing); the keys come straight from
        # the claim tables, with no segment-min scan
        spec = strategy[1]
        packed = G.pack_group_keys(key_tvs, spec)
        gid, slots, unresolved, slot_keys = G.hash_group_ids(packed, mask, cap)
        res["hash_unresolved"] = unresolved
        # an unresolved row holds the id `slots`: out of every aggregate
        # (the run is discarded and retried with a larger table)
        agg_gid, agg_mask = gid, mask & (gid < slots)
        num_groups = torch.tensor(slots, dtype=torch.int32)
        key_out_tvs = G.unpack_group_keys(slot_keys, spec,
                                          [g.type for g in node.group_exprs])
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

        def size_groups(num_groups):
            # a row domain no larger than the first cap bounds the groups;
            # past it, the exact count sizes every per-group array
            nonlocal slots
            if kc.domain_size > cap:
                with timer.scope("size_read"):
                    slots = B.bucket(int(num_groups))
                sized.append("groups")
            return slots

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
         sorted_pl) = G.sort_group_rows(key_tvs, mask, size_groups, payloads,
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
            want_present=kind in ("perfect", "hash"), segs=segs)
    if segs is not None:
        # one compaction materializes every deferred per-group array
        segs.flush()
        partials = [{k: segs.resolve(v) for k, v in p.items()}
                    for p in partials]
        key_out_tvs = [(segs.resolve(a), segs.resolve(b) if b is not None
                        else None) for a, b in key_out_tvs]
    merge_masked_flags(aflags, mask)
    agg_tvs = [la.finalize(p, kc.aux) for la, p in zip(lowered, partials)]
    if kind in ("perfect", "hash"):
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
    gcomp = ExprCompiler(gcols, kc.aux, gflags, device, slots, kc.udfs)
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
