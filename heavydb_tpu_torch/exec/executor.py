"""Query executor: walks the optimized RelAlg DAG and runs each Compound
work unit through one compound kernel (exec/compound_kernel.py).

Port of heavydb_tpu/exec/executor.py for this slice: `execute`, `_exec`,
the scan over the table's fragments (with chunk-stat fragment skipping),
`_exec_compound`, `_run_compound` with the capacity-retry ladder, the
group-by strategy choice (keyless, perfect hash, radix, sort), fragment-wave
streaming of decomposable aggregates (`_stream_plan`,
`_exec_compound_streamed`), the kernel cache and `_postprocess`; ORDER BY,
LIMIT and OFFSET (`_exec_sort`: the keyless slice, the full sort, the
single-key and packed composite-key top-k of `_exec_topk`, and the top-k
over fragment waves of `_try_stream_topk`).  Torch runs eagerly, so there
is no jit and no artifact cache; the control scalars of each Compound run
still reach the host in one read, and a Sort node reads nothing back.

Every tensor lives on the executor's one explicit device.  Window, Union,
Unnest, joins, subqueries and the hash group-by tier raise NotSupported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import (DeviceMemoryExceeded, DivisionByZero,
                                      ExecutionError, NotSupported)
from heavydb_tpu_torch.exec import batch as B
from heavydb_tpu_torch.exec import radix_tier as RT
from heavydb_tpu_torch.exec import ranges as RNG
from heavydb_tpu_torch.exec.compound_kernel import (build_compound_kernel, ctrl_keys,
                                                    derive_valid)
from heavydb_tpu_torch.exec.partial_agg import decomposable, make_leaf_node, make_merge_node
from heavydb_tpu_torch.ops import sort as S
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.plan import rel_alg as R
from heavydb_tpu_torch.plan.select_planner import _node_dict_ref
from heavydb_tpu_torch.storage.buffer_mgr import DeviceLRUCache, default_device_budget
from heavydb_tpu_torch.utils.timer import NullTimer

# capacity retries of one Compound: a sort-tier or radix cap miss converges
# in one retry (num_groups is exact), a radix hard overflow takes one more
MAX_RETRIES = 4


# CUDA device index -> the bytes PyTorch's caching allocator can hold there:
# the free memory CUDA reports plus the allocator's reserve, at the last
# `mem_get_info` read.  The card's memory is one per process, as is the
# allocator.
_HOLDABLE: Dict[int, int] = {}


def _allocator_bytes(idx: int):
    """(allocated, reserved) bytes of PyTorch's caching allocator on CUDA
    device idx, from its nested statistics (the flat `memory_allocated`
    builds and sorts every key, which costs a query's plan more host time)."""
    st = torch.cuda.memory_stats_as_nested_dict(idx)

    def cur(key):
        return st.get(key, {}).get("all", {}).get("current", 0)

    return cur("allocated_bytes"), cur("reserved_bytes")


def free_device_bytes(device, need: int = 0) -> Optional[int]:
    """Bytes a new allocation can still take on `device`: what the caching
    allocator can hold there less what it has allocated.  The holdable
    bytes come from `torch.cuda.mem_get_info` on first use and again only
    when they fall short of `need`: that read in every query cost more
    wall time than the rest of its plan (PERF.md §7).  Memory another
    process takes meanwhile is not seen until then.  None off CUDA, where
    nothing is checked."""
    if device.type != "cuda":
        return None
    idx = device.index if device.index is not None else torch.cuda.current_device()
    allocated, _ = _allocator_bytes(idx)
    held = _HOLDABLE.get(idx)
    if held is None or held - allocated < need:
        free, _total = torch.cuda.mem_get_info(idx)
        allocated, reserved = _allocator_bytes(idx)
        held = _HOLDABLE[idx] = free + reserved
    return int(held - allocated)


def _scan_field_type(table, f: int) -> T.TypeInfo:
    """Type of scan field f; fields past the physical columns are the
    virtual rowid pseudo-column (BIGINT NOT NULL)."""
    if f < len(table.columns):
        return table.columns[f].type
    return T.bigint(nullable=False)


def _scan_fields(node: R.Compound) -> set:
    """Input fields an aggregate Compound reads: its keys, aggregate
    arguments and filter."""
    needed = set()
    for e in list(node.group_exprs) + list(node.aggs) + (
            [node.filter_cond] if node.filter_cond is not None else []):
        needed |= {r.field_idx for r in E.collect_input_refs(e)}
    return needed


def _iter_node_exprs(node: R.RelNode):
    if isinstance(node, R.Compound):
        for _, c in node.join_levels:
            if c is not None:
                yield c
        if node.filter_cond is not None:
            yield node.filter_cond
        yield from node.group_exprs
        yield from node.aggs
        yield from node.target_exprs
        if node.having is not None:
            yield node.having


class Executor:
    def __init__(self, db):
        self.db = db
        self.config = db.config
        self.device = db.device
        self.kernel_cache: Dict[tuple, object] = {}
        # dictionary rank tables of string ORDER BY keys
        self.aux_cache: Dict[tuple, torch.Tensor] = {}
        budget = self.config.device_cache_bytes
        if budget == 0:
            budget = default_device_budget(self.device)
        elif budget < 0:
            budget = 0  # unbounded
        self.scan_cache = DeviceLRUCache(budget)
        self.timer = NullTimer()
        # fragment waves run by streamed Compounds and top-k Sorts, and the
        # last Compound stream plan
        self.waves_run = 0
        self.last_stream: Optional[StreamPlan] = None

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------
    def execute(self, root: R.RelNode) -> B.Batch:
        for node in R.topo_order(root):
            for e in _iter_node_exprs(node):
                if any(isinstance(s, E.SubqueryExpr) for s in E.walk(e)):
                    raise NotSupported("subqueries")
        return self._exec(root, {}, needed=set(range(root.arity)))

    def _exec(self, node: R.RelNode, memo, needed) -> B.Batch:
        if node.id in memo:
            return memo[node.id]
        with self.timer.scope(f"{type(node).__name__}#{node.id}"):
            if isinstance(node, R.Scan):
                out = self._exec_scan(node, needed)
            elif isinstance(node, R.Values):
                out = self._exec_values(node)
            elif isinstance(node, R.TableData):
                out = B.from_host_columns(node.arrays, node.num_rows,
                                          node.types, self.device)
            elif isinstance(node, R.Sort):
                out = self._exec_sort(node, memo)
            elif isinstance(node, R.Compound):
                out = self._exec_compound(node, memo)
            else:
                raise NotSupported(f"cannot execute node {type(node).__name__}")
        memo[node.id] = out
        return out

    # ---- Scan ----
    def _put(self, host: np.ndarray, size: int, ti) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(B.pad_to(host, size, ti))).to(self.device)

    def _exec_scan(self, node: R.Scan, needed, frag_ids=None) -> B.Batch:
        """Device columns of the table's fragments (all, or frag_ids),
        concatenated and null-padded to the row bucket.  Full columns are
        cached; a subset of fragments is cut from a resident full column
        on the device when there is one."""
        t = node.table
        if frag_ids is not None:
            frags = [t.fragments[i] for i in frag_ids]
            n = sum(f.num_rows for f in frags)
            fkey = tuple(frag_ids)
        else:
            frags = None
            n = t.num_rows
            fkey = None
        size = B.bucket(n)
        gstart = np.cumsum([0] + [f.num_rows for f in t.fragments])
        cols: List[Optional[torch.Tensor]] = []
        for i in range(node.arity):
            if needed is not None and i not in needed:
                cols.append(None)
                continue
            if i >= len(t.columns):
                # virtual rowid field: GLOBAL physical row position, stable
                # under fragment skipping (reference: Catalog's virtual rowid)
                use = range(len(t.fragments)) if frags is None else frag_ids
                host = np.concatenate(
                    [np.arange(gstart[f], gstart[f + 1], dtype=np.int64)
                     for f in use] + [np.empty(0, np.int64)])
                cols.append(self._put(host, size, T.bigint(nullable=False)))
                continue
            cd = t.columns[i]
            if cd.type.is_array or cd.type.is_none_string or cd.type.is_geo:
                raise NotSupported(f"scan of {cd.type.sql_name()} column {cd.name}")
            key = (t.table_id, t.generation, cd.col_id, size, fkey)
            arr = self.scan_cache.get(key)
            if arr is None and fkey is not None:
                full = self.scan_cache.get(
                    (t.table_id, t.generation, cd.col_id, B.bucket(t.num_rows), None))
                if full is not None:
                    # device slice of the resident column; transient (one
                    # query), so not cached
                    segs = [full[int(gstart[f]):int(gstart[f + 1])] for f in frag_ids]
                    cat = torch.cat(segs) if segs else full[:0]
                    if cat.shape[0] < size:
                        pad = torch.full((size - cat.shape[0],),
                                         cd.type.null_sentinel(), dtype=cat.dtype,
                                         device=cat.device)
                        cat = torch.cat([cat, pad])
                    cols.append(cat)
                    continue
            if arr is None:
                if frags is None:
                    host = t.column_values(cd.col_id)
                else:
                    parts = [np.asarray(f.chunks[cd.col_id]) for f in frags
                             if f.num_rows]
                    host = (np.concatenate(parts) if parts
                            else np.empty(0, cd.type.np_dtype()))
                arr = self._put(np.asarray(host), size, cd.type)
                self.scan_cache[key] = arr
            cols.append(arr)
        return B.Batch(cols, n, list(node.types))

    def _exec_values(self, node: R.Values) -> B.Batch:
        arrays = []
        for i, ti in enumerate(node.types):
            vals = [r[i] for r in node.rows]
            arrays.append(np.array(
                [ti.null_sentinel() if v is None else v for v in vals],
                ti.np_dtype()))
        return B.from_host_columns(arrays, len(node.rows), node.types,
                                   self.device)

    # ---- Sort ----
    def _in_domain(self, padded: int, nrows: int) -> torch.Tensor:
        """bool[padded]: True for the live rows, which come first."""
        m = torch.ones(padded, dtype=torch.bool, device=self.device)
        m[nrows:] = False
        return m

    def _dict_rank_table(self, ref) -> torch.Tensor:
        """id -> lexicographic rank, for string ORDER BY; built on the host
        once per dictionary size."""
        d = self.db.dict_by_ref(ref)
        key = ("rank", ref, d.size)
        hit = self.aux_cache.get(key)
        if hit is not None:
            return hit
        host = np.zeros(B.bucket(max(d.size, 1)), np.int32)
        order = np.argsort(np.array(d.entries(), dtype=object))
        host[order.astype(np.int32)] = np.arange(len(order), dtype=np.int32)
        arr = torch.from_numpy(host).to(self.device)
        self.aux_cache[key] = arr
        return arr

    def _exec_sort(self, node: R.Sort, memo) -> B.Batch:
        child = node.inputs[0]
        if not node.keys:
            # LIMIT / OFFSET without ORDER BY: a slice in input order
            inp = self._exec(child, memo, set(range(child.arity)))
            off = node.offset or 0
            n_out = max(inp.nrows - off, 0)
            if node.limit is not None:
                n_out = min(n_out, node.limit)
            cols = inp.cols if not off else [
                None if c is None else c[off:] for c in inp.cols]
            return B.Batch(list(cols), n_out, list(node.types))
        key_specs = [(asc, nf) for _, asc, nf in node.keys]
        key_idxs = [i for i, _, _ in node.keys]
        limit_total = (node.limit or 0) + (node.offset or 0)
        composite_specs = None
        if len(node.keys) > 1 and node.limit is not None:
            composite_specs = self._composite_sort_plan(node, child)
        topk_eligible = (
            node.limit is not None
            and 0 < limit_total <= 16384
            and ((len(node.keys) == 1
                  and not node.types[key_idxs[0]].is_dict_string)
                 or composite_specs is not None))
        # ORDER BY ... LIMIT over fragment waves, without the whole input
        if topk_eligible and child.id not in memo:
            st = self._try_stream_topk(node, child, limit_total, composite_specs)
            if st is not None:
                return st
        inp = self._exec(child, memo, set(range(child.arity)))
        n = inp.nrows
        if n == 0:
            return B.Batch(inp.cols, 0, list(node.types))
        if topk_eligible:
            return self._exec_topk(node, inp, limit_total, specs=composite_specs)

        # the full sort; dictionary strings sort by their lexicographic rank
        key_tvs = []
        for idx in key_idxs:
            ti = inp.types[idx]
            val = inp.cols[idx]
            valid = derive_valid(val, ti) if ti.nullable else None
            ref = _node_dict_ref(child, idx) if ti.is_dict_string else None
            if ref is not None:
                tbl = self._dict_rank_table(ref)
                safe = val.clamp(0, tbl.shape[0] - 1).to(torch.int64)
                val = torch.where(val >= 0, tbl[safe], -1)
            key_tvs.append((val, valid))
        perm, _, _ = S.sort_permutation(key_tvs, key_specs,
                                        self._in_domain(inp.padded, n))
        off = node.offset or 0
        n_out = max(n - off, 0)
        if node.limit is not None:
            n_out = min(n_out, node.limit)
        # gather only the rows the result keeps (the reference slices
        # c[off : off + bucket(n_out)] when there is an offset)
        take = perm[off: off + B.bucket(n_out)]
        cols = [None if c is None else c[take] for c in inp.cols]
        return B.Batch(cols, n_out, list(node.types))

    def _composite_sort_plan(self, node: R.Sort, child):
        """Multi-key ORDER BY ... LIMIT packing: per-key orderable bit
        widths (chunk-stat-narrowed ints, full-width f32) packed into one
        <= 63-bit top-k key.  Returns (specs, total bits) for
        ops.sort.composite_topk_key, or None when the keys don't pack."""
        specs = []
        total = 0
        for idx, asc, nulls_first in node.keys:
            ti = node.types[idx]
            if ti.is_dict_string or ti.is_array or ti.is_geo or ti.is_string:
                return None
            if ti.is_fp:
                if np.dtype(ti.np_dtype()) != np.float32:
                    return None  # f64 never fits beside another key
                wv, lo = 32, None
            else:
                r = RNG.column_range(child, idx)
                if r is not None and r.hi >= r.lo:
                    wv = max((int(r.hi) - int(r.lo)).bit_length(), 1)
                    lo = int(r.lo)
                elif np.dtype(ti.np_dtype()).itemsize <= 4:
                    wv, lo = 32, None
                else:
                    return None  # unbounded 64-bit int beside another key
            specs.append((wv, lo, asc, nulls_first, ti.nullable))
            total += wv + (1 if ti.nullable else 0)
        if total > 63:
            return None
        return tuple(specs), total

    def _try_stream_topk(self, node: R.Sort, child, k_total: int,
                         composite_specs=None):
        """ORDER BY ... LIMIT k over fragment waves: each wave keeps its k
        best rows, the waves' winners are concatenated (waves x k rows) and
        one last select takes the global k; exact, since the union of the
        waves' top k holds the global top k.  None when the input is small
        enough for one pass or the child does not stream (the reference's
        rule: a Scan, or a non-aggregate Compound over one, of 2+
        fragments, past the stream threshold)."""
        cfg = self.config
        thr = cfg.stream_threshold_bytes
        if thr < 0:
            return None
        if thr == 0:
            thr = (self.scan_cache.budget_bytes or (11 << 30)) // 2
        if isinstance(child, R.Scan):
            scan, compound = child, None
        elif (isinstance(child, R.Compound) and not child.is_aggregate
              and not child.join_levels and len(child.inputs) == 1
              and isinstance(child.inputs[0], R.Scan)):
            scan, compound = child.inputs[0], child
        else:
            return None
        t = scan.table
        if len(t.fragments) < 2:
            return None
        if compound is None:
            scan_needed = set(range(scan.arity))
        else:
            scan_needed = set()
            for e in _iter_node_exprs(compound):
                scan_needed |= {r.field_idx for r in E.collect_input_refs(e)}
        if any(_scan_field_type(t, f).is_array for f in scan_needed):
            return None
        row_bytes = max(sum(_scan_field_type(t, f).np_dtype().itemsize
                            for f in scan_needed), 1)
        if t.num_rows * row_bytes <= thr:
            return None
        frag_ids = None
        fc = compound.filter_cond if compound is not None else None
        if fc is not None:
            frag_ids = self._surviving_fragments(scan, fc)
        if frag_ids is None:
            frag_ids = [f.fragment_id for f in t.fragments]
        # waves of at most half the threshold's bytes and topk_stream_row_cap
        # rows (the select's temporaries are several bytes a row)
        wave_budget = max(thr // 2, 1)
        waves, cur, cur_bytes, cur_rows = [], [], 0, 0
        for fid in frag_ids:
            fr = t.fragments[fid].num_rows
            if cur and (cur_bytes + fr * row_bytes > wave_budget
                        or cur_rows + fr > cfg.topk_stream_row_cap):
                waves.append(cur)
                cur, cur_bytes, cur_rows = [], 0, 0
            cur.append(fid)
            cur_bytes += fr * row_bytes
            cur_rows += fr
        if cur:
            waves.append(cur)
        if len(waves) < 2:
            return None
        winners: List[B.Batch] = []
        for wave in waves:
            batch = self._exec_scan(scan, scan_needed, frag_ids=wave)
            if compound is not None:
                plan = self._plan_compound(compound, [batch])
                batch = self._run_compound(compound, [batch], plan)
            self.waves_run += 1
            if batch.nrows == 0:
                continue
            winners.append(self._exec_topk(node, batch, k_total, apply_offset=False,
                                           specs=composite_specs))
        if not winners:
            return B.from_host_columns([np.empty(0, ti.np_dtype()) for ti in node.types],
                                       0, node.types, self.device)
        cat = B.concat_batches(winners)
        cat.types = list(node.types)
        return self._exec_topk(node, cat, k_total, specs=composite_specs)

    def _exec_topk(self, node: R.Sort, inp: B.Batch, k_total: int,
                   apply_offset: bool = True, specs=None) -> B.Batch:
        """ORDER BY ... LIMIT k by a top-k select: one key directly, several
        through a packed composite key (specs from _composite_sort_plan)."""
        padded = inp.padded
        k = min(k_total, padded)
        in_domain = self._in_domain(padded, inp.nrows)
        if specs is not None:
            key_tvs = []
            for i, _, _ in node.keys:
                ti = inp.types[i]
                val = inp.cols[i]
                key_tvs.append((val, derive_valid(val, ti) if ti.nullable else None))
            u, bits = S.composite_topk_key(key_tvs, specs[0], specs[1],
                                           in_domain=in_domain)
            top_idx = S.topk_indices_u(u, bits, k)
        else:
            idx, asc, nulls_first = node.keys[0]
            ti = inp.types[idx]
            val = inp.cols[idx]
            valid = derive_valid(val, ti) if ti.nullable else None
            # a DESCENDING-priority key in an order-exact dtype
            if val.is_floating_point():
                key = torch.where(torch.isnan(val), 0.0, val)
                lo_sent, hi_sent = -np.inf, np.inf
            else:
                kdt = torch.int64 if val.element_size() > 4 else torch.int32
                key = val.to(kdt)
                lo_sent, hi_sent = torch.iinfo(kdt).min + 1, torch.iinfo(kdt).max
            if asc:
                key = -key
            if valid is not None:
                key = torch.where(valid, key, hi_sent if nulls_first else lo_sent)
            key = torch.where(in_domain, key, lo_sent)
            top_idx = S.topk_indices(key, k)
        out_cols = [None if c is None else c[top_idx] for c in inp.cols]
        if not apply_offset:
            # a wave of the streamed path keeps all k_total candidates; the
            # final select applies OFFSET and LIMIT
            return B.Batch(out_cols, min(inp.nrows, k), list(node.types))
        off = node.offset or 0
        n_out = max(min(inp.nrows, k) - off, 0)
        if node.limit is not None:
            n_out = min(n_out, node.limit)
        if off:
            out_cols = [None if c is None else c[off:] for c in out_cols]
        return B.Batch(out_cols, n_out, list(node.types))

    # ---- Compound ----
    def _exec_compound(self, node: R.Compound, memo) -> B.Batch:
        ident = self._try_identity_projection(node, memo)
        if ident is not None:
            return ident
        sp = self._stream_plan(node)
        if sp is not None:
            return self._exec_compound_streamed(node, sp)
        batches, plan = self._prepare_compound(node, memo)
        return self._run_compound(node, batches, plan)

    def _try_identity_projection(self, node: R.Compound, memo):
        """Pure column-subset/reorder projections ALIAS the child's device
        buffers instead of running a copy."""
        if len(node.inputs) != 1 or node.is_aggregate or node.aggs \
                or node.filter_cond is not None or node.having is not None \
                or node.group_exprs \
                or any(c is not None for _, c in node.join_levels):
            return None
        if not all(isinstance(e, E.InputRef) for e in node.target_exprs):
            return None
        child = node.inputs[0]
        for e, tt in zip(node.target_exprs, node.types):
            if child.types[e.field_idx] != tt:
                return None
        inp = self._exec(child, memo, {e.field_idx for e in node.target_exprs})
        cols = [inp.cols[e.field_idx] for e in node.target_exprs]
        if any(c is None for c in cols):
            return None
        return B.Batch(cols, inp.nrows, list(node.types))

    def _run_compound(self, node: R.Compound, batches, plan) -> B.Batch:
        # retry ladder: _postprocess returns None after updating the plan
        # when the run missed its output capacity or must change tier
        for _ in range(MAX_RETRIES + 1):
            kernel, layout = self._get_kernel(node, batches, plan)
            try:
                outs = kernel(*self._kernel_args(batches, plan, layout))
            except RT.RadixUnsupported:
                # the compiled aggregate shape diverged from the radix
                # tier's static stream plan: reroute to the sort tier
                if plan.group_strategy[0] != "radix":
                    raise
                plan.group_strategy = ("sort", None)
                continue
            result = self._postprocess(node, plan, outs)
            if result is not None:
                return result
        raise ExecutionError("capacity retry ladder did not converge")

    # ---- fragment-wave streaming (out-of-core aggregates) ----
    def _stream_plan(self, node: R.Compound) -> Optional["StreamPlan"]:
        """How an aggregate over one Scan runs in fragment waves with
        partial-aggregate merge; None = over its whole input.

        The reference's rule: no joins, one Scan input of two or more
        fragments, decomposable aggregates, no array column, and the needed
        column bytes above the threshold (0: half the scan cache's budget).
        Beside it, the device's memory: when the columns and the group-by
        tier's working bytes (`_tier_row_bytes`) of the rows the filter's
        fragment skipping leaves would not fit the free memory, the waves
        shrink until each fits half of it.  A Compound that does not fit
        and cannot stream, or whose largest fragment alone would not fit
        half the free memory, raises DeviceMemoryExceeded here, before any
        scan or launch; so does the merge of the waves' partial rows (a
        TableData input) that would not fit."""
        if node.join_levels or len(node.inputs) != 1 or not node.is_aggregate:
            return None
        inp = node.inputs[0]
        if isinstance(inp, R.TableData):
            # the merge of a streamed Compound's partial rows: held to the
            # free memory, never streamed
            work_row = (sum(ti.np_dtype().itemsize for ti in inp.types)
                        + self._tier_row_bytes(node))
            free = free_device_bytes(self.device, inp.num_rows * work_row)
            if free is not None and inp.num_rows * work_row > free:
                raise DeviceMemoryExceeded(
                    f"merging {inp.num_rows} partial rows x {work_row} B needs "
                    f"more than the {free} B free on {self.device}")
            return None
        if not isinstance(inp, R.Scan):
            return None
        t = inp.table
        types = [_scan_field_type(t, f) for f in _scan_fields(node)]
        if any(ti.is_array for ti in types):
            return None  # array aux payloads aren't fragment-local
        col_bytes = sum(ti.np_dtype().itemsize for ti in types)
        row_bytes = max(col_bytes, 1)
        # the fragments the filter's chunk stats leave
        frag_ids = None
        if node.filter_cond is not None:
            frag_ids = self._surviving_fragments(inp, node.filter_cond)
        if frag_ids is None:
            frag_ids = [f.fragment_id for f in t.fragments]
        rows = [t.fragments[f].num_rows for f in frag_ids]
        work_row = row_bytes + self._tier_row_bytes(node)
        free = free_device_bytes(self.device, sum(rows) * work_row)
        by_memory = free is not None and sum(rows) * work_row > free
        thr = self.config.stream_threshold_bytes
        if thr < 0 or len(t.fragments) < 2 or not decomposable(node):
            if by_memory:
                raise DeviceMemoryExceeded(
                    f"{sum(rows)} rows x {work_row} B need more than the "
                    f"{free} B free on {self.device}, and this query cannot "
                    "run in fragment waves")
            return None
        if thr == 0:
            thr = (self.scan_cache.budget_bytes or (11 << 30)) // 2
        if by_memory:
            if max(rows) * work_row > free // 2:
                raise DeviceMemoryExceeded(
                    f"a fragment of {max(rows)} rows x {work_row} B needs more "
                    f"than half the {free} B free on {self.device}")
            # a wave of thr / 2 column bytes holds free / 2 working bytes
            thr = min(thr, free * row_bytes // work_row)
        elif t.num_rows * col_bytes <= thr:
            return None
        return StreamPlan(thr, row_bytes, work_row, by_memory, frag_ids)

    def _exec_compound_streamed(self, node: R.Compound, sp: "StreamPlan") -> B.Batch:
        """Execute in fragment waves: per-wave Compound with decomposed
        aggregates (AVG -> SUM + COUNT), the small per-wave group results
        taken to the host, then one merge Compound over them re-aggregating
        the partials (SUM of counts / sums, MIN of mins, ...) and applying
        the original targets and HAVING over the finalize expressions."""
        scan = node.inputs[0]
        t = scan.table
        wave_node, wave_aggs, fin = make_leaf_node(node)
        needed = _scan_fields(node)
        # fragment waves of at most half the threshold's column bytes
        wave_budget = max(sp.threshold // 2, 1)
        waves, cur, cur_bytes = [], [], 0
        for fid in sp.fragments:
            fb = t.fragments[fid].num_rows * sp.row_bytes
            if cur and cur_bytes + fb > wave_budget:
                waves.append(cur)
                cur, cur_bytes = [], 0
            cur.append(fid)
            cur_bytes += fb
        if cur:
            waves.append(cur)
        sp.waves = len(waves)
        self.last_stream = sp
        parts: List[List[np.ndarray]] = []
        for wave in waves:
            batch = self._exec_scan(scan, needed, frag_ids=wave)
            plan = self._plan_compound(wave_node, [batch])
            out = self._run_compound(wave_node, [batch], plan)
            parts.append(out.to_numpy())
            self.waves_run += 1
            del batch, out
        wave_targets = wave_node.target_exprs
        arrays = [np.concatenate([p[i] for p in parts]) if parts
                  else np.empty(0, wt.type.np_dtype())
                  for i, wt in enumerate(wave_targets)]
        td = R.TableData(wave_node.fields, [wt.type for wt in wave_targets],
                         arrays, [getattr(wt, "dict_ref", None) for wt in wave_targets])
        merge_node = make_merge_node(node, wave_aggs, fin, td)
        return self._exec(merge_node, {}, set(range(merge_node.arity)))

    def _tier_row_bytes(self, node: R.Compound) -> int:
        """Device bytes a row of the Compound's group-by holds beside its
        scanned columns, on the tier `_plan_compound` would pick, from the
        SQL types (s: the aggregates' streams, a bool contribution mask and
        the value each, as exec/radix_tier.py `row_bytes` counts them):
          keyless  1 + s        the row mask
          perfect  5 + s        the row mask and the int32 slot id
          radix    20 + 2s + r  gid, B5's hb, B6's stage hb and length (4 +
                                4 + 4 + 8), the streams and B5's partitioned
                                copy of them (2s), B6's stage records (r)
          sort     58 + k + 2p + 16a
                                `sort_group_rows`: the permutation (8), one
                                stable pass (its gathered operand, sorted
                                values, indices and composed permutation,
                                32), the domain and group-start flags and
                                the int64 group ids with their prefix sum
                                (18), the sorted key operands (k: a domain
                                flag, each key's null flag and value), the
                                aggregate arguments in row order and gathered
                                (2p, p taken as s); `SortedSegments`: an
                                8-byte masked copy and prefix sum of each
                                partial (16a)"""
        s, r = RT.row_bytes(node.aggs)
        tier = self._group_tier(node)[0]
        if tier == "keyless":
            return 1 + s
        if tier == "perfect":
            return 5 + s
        if tier == "radix":
            return 20 + 2 * s + r
        k = 1 + sum(np.dtype(g.type.np_dtype()).itemsize + g.type.nullable
                    for g in node.group_exprs)
        A = E.AggKind
        a = sum(1 if ag.kind in (A.COUNT, A.COUNT_IF)
                else 3 if ag.kind in (A.STDDEV, A.VARIANCE) else 2 for ag in node.aggs)
        return 58 + k + 2 * s + 16 * a

    def _group_tier(self, node: R.Compound):
        """(tier, ranges, slots) of an aggregate Compound's group-by, known
        before its scan: keyless; perfect or radix or sort when every key
        has a dense range within baseline_groupby_threshold slots (slots
        their product); else the sort tier, slots None (a query the
        reference would run on its hash tier raises in `_plan_compound`)."""
        cfg = self.config
        if not node.group_exprs:
            return "keyless", [], 1
        ranges = [RNG.expr_range(g, node.inputs) for g in node.group_exprs]
        slots = 1
        for r in ranges:
            if r is None or r.extent <= 0 or r.extent > cfg.baseline_groupby_threshold:
                return "sort", ranges, None
            slots *= r.extent + (1 if r.has_nulls else 0)
            if slots > cfg.baseline_groupby_threshold:
                return "sort", ranges, None
        if slots <= cfg.sortagg_min_slots:
            return "perfect", ranges, slots
        return ("radix" if RT.eligible(node, ranges, slots, cfg) else "sort"), ranges, slots

    def _prepare_compound(self, node: R.Compound, memo):
        if len(node.inputs) != 1 or any(
                c is not None or k != "INNER" for k, c in node.join_levels):
            raise NotSupported("joins")
        if node.is_aggregate:
            needed = _scan_fields(node)
        else:
            needed = set()
            for e in _iter_node_exprs(node):
                needed |= {r.field_idx for r in E.collect_input_refs(e)}
        inp = node.inputs[0]
        frag_ids = None
        if isinstance(inp, R.Scan) and node.filter_cond is not None \
                and len(inp.table.fragments) > 1:
            frag_ids = self._surviving_fragments(inp, node.filter_cond)
        if frag_ids is not None:
            batch = self._exec_scan(inp, needed, frag_ids)
        else:
            batch = self._exec(inp, memo, needed)
        return [batch], self._plan_compound(node, [batch])

    def _surviving_fragments(self, scan: R.Scan, filter_cond):
        """Fragments whose chunk min/max can satisfy every simple
        `col <cmp> const` conjunct; None when all survive."""
        from heavydb_tpu_torch.plan.optimizer import _split_conjuncts

        t = scan.table
        quals = [q for q in (self._simple_qual(c, scan)
                             for c in _split_conjuncts(filter_cond))
                 if q is not None]
        if not quals:
            return None
        keep = []
        for frag in t.fragments:
            ok = True
            for col_id, op, v in quals:
                st = frag.stats.get(col_id)
                if st is None or st.min is None:
                    continue
                mn, mx = st.min, st.max
                ok = {"=": mn <= v <= mx, "<": mn < v, "<=": mn <= v,
                      ">": mx > v, ">=": mx >= v}[op]
                if not ok:
                    break
            if ok:
                keep.append(frag.fragment_id)
        if len(keep) == len(t.fragments):
            return None
        return keep

    def _simple_qual(self, c, scan: R.Scan):
        """col <cmp> const over this scan's columns -> (col_id, op, value)."""
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
        if not isinstance(c, E.BinOp) or c.op not in E.COMPARISON_OPS \
                or c.op == E.BinOpKind.NE:
            return None
        lhs, rhs, op = c.left, c.right, c.op.value
        if isinstance(rhs, E.InputRef) and isinstance(lhs, E.Constant):
            lhs, rhs, op = rhs, lhs, flip.get(op, op)
        if not (isinstance(lhs, E.InputRef) and isinstance(rhs, E.Constant)) \
                or rhs.value is None:
            return None
        if not 0 <= lhs.field_idx < len(scan.table.columns):
            return None
        cd = scan.table.columns[lhs.field_idx]
        if not (cd.type.is_integer or cd.type.is_time or cd.type.is_decimal
                or cd.type.is_boolean):
            return None
        try:
            return (cd.col_id, op, int(rhs.value))
        except (TypeError, ValueError):
            return None

    # ---- compound planning ----
    def _plan_compound(self, node: R.Compound, batches):
        cfg = self.config
        plan = _CompoundPlan()
        if node.is_aggregate and node.group_exprs:
            tier, ranges, slots = self._group_tier(node)
            padded = max(batches[0].padded, 8)
            spec = tuple((r.lo, r.extent, r.has_nulls, r.bucket) for r in ranges) \
                if slots is not None else None
            if tier == "perfect":
                plan.group_strategy = ("perfect", spec)
                plan.group_cap = slots
            elif slots is not None:
                # huge dense key spaces: the radix tier when the aggregates
                # fit its stream budget, else the sort tier; neither
                # allocates [slots]-sized buffers
                plan.group_strategy = ("radix", spec) if tier == "radix" else ("sort", None)
                plan.group_cap = B.bucket(min(slots, padded))
            else:
                # the reference's hash tier, where it would take it: keys
                # that pack, a known NDV, and both a low collision depth
                # (rows / NDV) and a small claim table; else the sort tier
                if cfg.enable_hash_groupby \
                        and _hash_pack_spec(node.group_exprs, ranges) is not _NO_PACK:
                    ndv = self._estimate_group_ndv(node)
                    if ndv is not None and max(batches[0].nrows, 1) // max(ndv, 1) <= 32 \
                            and ndv <= (1 << 19):
                        raise NotSupported("hash group-by")
                plan.group_strategy = ("sort", None)
                plan.group_cap = B.bucket(
                    min(cfg.baseline_groupby_initial_entries, padded))
        elif node.is_aggregate:
            plan.group_strategy = ("keyless", None)
            plan.group_cap = 1
        return plan

    def _estimate_group_ndv(self, node) -> Optional[int]:
        """Chao1 distinct estimate from a host sample of the group key
        columns (the reference's `_estimate_group_ndv`, which stands in for
        HeavyDB's CardinalityEstimator).  Only for plain column keys over a
        single Scan; None = unknown.  A device-backed chunk gives its first
        65536 values with one small copy, never the whole fragment."""
        if len(node.inputs) != 1 or not isinstance(node.inputs[0], R.Scan):
            return None
        t = node.inputs[0].table
        idxs = []
        for g in node.group_exprs:
            e = g
            while isinstance(e, E.Cast):
                e = e.operand
            if not isinstance(e, E.InputRef):
                return None
            idxs.append(e.field_idx)
        cols = []
        for i in idxs:
            if i >= len(t.columns):  # virtual rowid field: no chunk stats
                return None
            cd = t.columns[i]
            if cd.type.is_array:
                return None
            frag = next((f for f in t.fragments if f.num_rows), None)
            if frag is None:
                return 1
            raw = frag.chunks[cd.col_id]
            if hasattr(raw, "head"):
                chunk = raw.head(65536)
            else:
                chunk = np.asarray(raw[:65536])
            if cd.type.is_none_string:
                # object array with None holes: estimate over a
                # NULL-sentineled unicode copy
                chunk = np.array(
                    ["\x00\x00<null>" if v is None else v for v in chunk])
            cols.append(chunk)
        if not cols:
            return None
        m = len(cols[0])
        if m == 0:
            return 1
        sample = cols[0] if len(cols) == 1 else np.rec.fromarrays(cols)
        _, counts = np.unique(sample, return_counts=True)
        u = len(counts)
        f1 = int((counts == 1).sum())
        f2 = int((counts == 2).sum())
        # Chao1 for saturated samples; it explodes as f2 -> 0 (all
        # singletons), where the linear unseen-mass extrapolation is the
        # right model: take the smaller of the two
        chao = u + (f1 * f1) / (2.0 * (f2 + 1))
        frac_unique = f1 / m
        linear = u + frac_unique * max(t.num_rows - m, 0)
        est = min(chao + frac_unique * max(t.num_rows - m, 0), linear * 1.5)
        return max(int(est), 1)

    # ---- kernel build & cache ----
    def _get_kernel(self, node, batches, plan):
        shapes = tuple(
            (b.padded,) + tuple(
                (i, str(c.dtype)) for i, c in enumerate(b.cols) if c is not None)
            for b in batches)
        key = (node.plan_key(), shapes, plan.group_strategy, plan.group_cap)
        hit = self.kernel_cache.get(key)
        if hit is None:
            hit = build_compound_kernel(node, batches, plan, self.device)
            self.kernel_cache[key] = hit
        return hit

    def _kernel_args(self, batches, plan, layout):
        args = []
        for bi, cols in layout.batch_cols:
            for ci in cols:
                args.append(batches[bi].cols[ci])
        for bi in layout.nrows_batches:
            args.append(int(batches[bi].nrows))
        return args

    def _postprocess(self, node, plan, outs) -> B.Batch:
        d = outs
        # keyless aggregate with no error flags has a STATIC output (1 row):
        # no control read at all
        if plan.group_strategy and plan.group_strategy[0] == "keyless" \
                and not any(k.startswith("err_") for k in d):
            return B.Batch(list(d["cols"]), 1, list(node.types))
        # ALL control scalars in ONE device->host copy
        host = dict(zip(ctrl_keys(d), d["ctrl_vec"].tolist()))
        if host.get("err_div_by_zero"):
            raise DivisionByZero("division by zero")
        strategy = plan.group_strategy[0] if plan.group_strategy else None
        if strategy == "sort":
            ng = int(host["num_groups"])
            if ng > plan.group_cap:
                plan.group_cap = B.bucket(ng)
                return None
        if strategy == "radix":
            ng = int(host["num_groups"])
            ovf = int(host["radix_overflow"])
            if ovf & 1:
                # a partition held more rows than the group kernel's tile:
                # the results are invalid; rerun on the sort tier
                plan.group_strategy = ("sort", None)
                plan.group_cap = B.bucket(max(ng, 8))
                return None
            if ovf & 2 or ng > plan.group_cap:
                # output cap exceeded; num_groups is exact: one retry
                plan.group_cap = B.bucket(ng)
                return None
        n_out = int(host["n_out"])
        cols = list(d["cols"])
        size = B.bucket(n_out)
        if cols and cols[0].shape[0] > size:
            cols = [c[:size] for c in cols]
        return B.Batch(cols, n_out, list(node.types))


# ---------------------------------------------------------------------------
# compound plan containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamPlan:
    """A Compound's fragment waves (Executor._stream_plan): waves of at
    most threshold / 2 column bytes over `fragments`; row_bytes = the
    needed column bytes a row, work_row_bytes = those and the group-by
    tier's; by_memory = shrunk to the device's free memory; waves = how
    many ran."""

    threshold: int
    row_bytes: int
    work_row_bytes: int
    by_memory: bool
    fragments: List[int]
    waves: int = 0


@dataclasses.dataclass
class _CompoundPlan:
    # ("perfect" | "radix", ((min, extent, has_nulls, bucket), ...)) |
    # ("sort", None) | ("keyless", None)
    group_strategy: Optional[tuple] = None
    group_cap: int = 0


@dataclasses.dataclass
class _KernelLayout:
    batch_cols: list = None  # [(batch_idx, [col_idx...])...]
    nrows_batches: list = None


_NO_PACK = object()


def _hash_pack_spec(group_exprs, ranges):
    """Packing spec of the reference's hash tier: None = single-key
    identity packing (any scalar key type); ((lo, span), ...) = range
    packing of multi-key tuples with known ranges that fit 63 bits;
    _NO_PACK = not hashable (the sort tier groups them)."""
    for g in group_exprs:
        if g.type.is_array or g.type.is_string and not g.type.is_dict_string:
            return _NO_PACK
    if len(group_exprs) == 1:
        return None
    spec = []
    total = 1
    for r in ranges:
        if r is None or r.extent <= 0:
            return _NO_PACK
        spec.append((r.lo, r.extent))
        total *= r.extent + 2
        if total >= (1 << 62):
            return _NO_PACK
    return tuple(spec)
