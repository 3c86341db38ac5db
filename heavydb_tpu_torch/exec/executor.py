"""Query executor: walks the optimized RelAlg DAG and runs each Compound
work unit through one compound kernel (exec/compound_kernel.py).

Port of heavydb_tpu/exec/executor.py for this slice: `execute`, `_exec`,
the scan over the table's fragments (with chunk-stat fragment skipping),
`_exec_compound`, `_run_compound` with the capacity-retry ladder, the
group-by strategy choice (keyless, perfect hash, radix, sort), the kernel
cache and `_postprocess`.  Torch runs eagerly, so there is no jit and no
artifact cache; the control scalars of each Compound run still reach the
host in one read.

Every tensor lives on the executor's one explicit device.  Sort, Window,
Union, Unnest, joins, subqueries and the hash group-by tier raise
NotSupported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import DivisionByZero, ExecutionError, NotSupported
from heavydb_tpu_torch.exec import batch as B
from heavydb_tpu_torch.exec import radix_tier as RT
from heavydb_tpu_torch.exec import ranges as RNG
from heavydb_tpu_torch.exec.compound_kernel import build_compound_kernel, ctrl_keys
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.plan import rel_alg as R
from heavydb_tpu_torch.storage.buffer_mgr import DeviceLRUCache, default_device_budget
from heavydb_tpu_torch.utils.timer import NullTimer

# capacity retries of one Compound: a sort-tier or radix cap miss converges
# in one retry (num_groups is exact), a radix hard overflow takes one more
MAX_RETRIES = 4

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
        budget = self.config.device_cache_bytes
        if budget == 0:
            budget = default_device_budget(self.device)
        elif budget < 0:
            budget = 0  # unbounded
        self.scan_cache = DeviceLRUCache(budget)
        self.timer = NullTimer()

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

    # ---- Compound ----
    def _exec_compound(self, node: R.Compound, memo) -> B.Batch:
        ident = self._try_identity_projection(node, memo)
        if ident is not None:
            return ident
        if self._stream_plan(node) is not None:
            raise NotSupported("fragment-wave streaming")
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

    def _stream_plan(self, node: R.Compound):
        """Fragment-wave streaming is not ported yet: every Compound runs
        over its whole input."""
        return None

    def _prepare_compound(self, node: R.Compound, memo):
        if len(node.inputs) != 1 or any(
                c is not None or k != "INNER" for k, c in node.join_levels):
            raise NotSupported("joins")
        needed = set()
        if node.is_aggregate:
            exprs = list(node.group_exprs) + list(node.aggs) + (
                [node.filter_cond] if node.filter_cond is not None else [])
        else:
            exprs = list(_iter_node_exprs(node))
        for e in exprs:
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
            ranges = [RNG.expr_range(g, node.inputs) for g in node.group_exprs]
            slots = 1
            ok = True
            for r in ranges:
                if r is None or r.extent <= 0 \
                        or r.extent > cfg.baseline_groupby_threshold:
                    ok = False
                    break
                slots *= r.extent + (1 if r.has_nulls else 0)
                if slots > cfg.baseline_groupby_threshold:
                    ok = False
                    break
            padded = max(batches[0].padded, 8)
            if ok and slots > cfg.sortagg_min_slots:
                # huge dense key spaces: the radix tier when the aggregates
                # fit its stream budget, else the sort tier; neither
                # allocates [slots]-sized buffers
                if RT.eligible(node, ranges, slots, cfg):
                    plan.group_strategy = ("radix", tuple(
                        (r.lo, r.extent, r.has_nulls, r.bucket) for r in ranges))
                else:
                    plan.group_strategy = ("sort", None)
                plan.group_cap = B.bucket(min(slots, padded))
            elif ok:
                plan.group_strategy = ("perfect", tuple(
                    (r.lo, r.extent, r.has_nulls, r.bucket) for r in ranges))
                plan.group_cap = slots
            elif cfg.enable_hash_groupby:
                raise NotSupported("hash group-by")
            else:
                plan.group_strategy = ("sort", None)
                plan.group_cap = B.bucket(
                    min(cfg.baseline_groupby_initial_entries, padded))
        elif node.is_aggregate:
            plan.group_strategy = ("keyless", None)
            plan.group_cap = 1
        return plan

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
class _CompoundPlan:
    # ("perfect" | "radix", ((min, extent, has_nulls, bucket), ...)) |
    # ("sort", None) | ("keyless", None)
    group_strategy: Optional[tuple] = None
    group_cap: int = 0


@dataclasses.dataclass
class _KernelLayout:
    batch_cols: list = None  # [(batch_idx, [col_idx...])...]
    nrows_batches: list = None
