"""Query executor: walks the optimized RelAlg DAG and runs each Compound
work unit through one compound kernel (exec/compound_kernel.py).

Port of heavydb_tpu/exec/executor.py: `execute`, `_exec`, the scan over a
table's fragments (with chunk-stat fragment skipping, each input with its
own field offset), `_exec_compound`, `_run_compound` with the retry
ladder (join hash misses and expansion capacity; the radix tier's group
capacity and overflow; the hash tier's unresolved keys), the join planning of
`_plan_compound` (filter push-down, key packing, perfect / hash / sorted
builds, the CROSS watchdog, outer-join nullability of group keys) with the
runtime join reorder and its selectivity probe, the group-by strategy
choice (keyless, perfect hash, radix, hash, sort), fragment-wave streaming of
decomposable aggregates (`_stream_plan`, `_exec_compound_streamed`), the
kernel cache and `_postprocess`; ORDER BY, LIMIT and OFFSET (`_exec_sort`:
the keyless slice, the full sort, the single-key and packed composite-key
top-k of `_exec_topk`, and the top-k over fragment waves of
`_try_stream_topk`); the dictionary-string tables (`_aux_array`: the
predicate, transform, pair-concatenation, pair-rank, rank and order
tables, built on the host over dictionary entries) and the scan of TEXT
ENCODING NONE columns as ids of their table's lazy dictionary.  Torch
runs eagerly, so there is no jit and no artifact cache, and a size that
only the run can know is read where the run computes it and sizes the
same run (the sort tier's group count; a duplicate key under a
unique-build guess, which expands the level in place), where the
reference, whose programs have static shapes, runs the Compound again.
The control scalars of each Compound run still reach the host in one
read, and a Sort node reads nothing back.  Before a join Compound launches, its bytes are
held to the card's free memory (`_check_join_memory`).  After an UPDATE
or a DELETE the resident full-table columns move to the table's new
generation on the device (`patch_cache_update`, `patch_cache_delete`), and
every statement that changes a table drops what no query can read again
(`drop_stale`).

Uncorrelated subqueries run first and become constants in place
(`_substitute_subqueries`, `_eval_subquery`: scalar, EXISTS, IN / NOT IN);
UNION ALL concatenates its inputs (`_exec_union`), and UNION DISTINCT,
INTERSECT / EXCEPT and GROUPING SETS / ROLLUP / CUBE are Compounds over it.

Array and geo columns scan as int32 global rowids (`_array_handles`);
each ArrayFn reads tables built on the host over the column's payload
rows (`_array_aux`, `_geo_host`, `_geobbox_aux`; a geometry-transform
chain applies first, `_geo_xform_rows`), cached by table generation and
pruned by `drop_stale`.  UNNEST expands rows into their elements
(`_exec_unnest`), and a join level with no equality runs as the
grid-bucket spatial join when its residual holds a distance or
polygon-containment test (exec/geo_join.py, planned in `_plan_compound`).

A Window node appends its window columns to its child's batch
(`_exec_window` over exec/window_kernel.py: one sort a partition / order
spec, segmented scans, the batch emitted in sorted order or the outputs
scattered back), with the string tables of its arguments and a rank
table for each dictionary-string ORDER BY key; it is never streamed.
Scalar UDFs reach the expression compiler through each Compound's plan.
Every tensor lives on the executor's explicit device (a shard's, on a
mesh).  A subquery left after substitution raises NotSupported.

Per-query controls, as the reference's: the interrupt hook, the timer, the
query hints and the dynamic watchdog's deadline are per thread, as are the
records of the calling thread's last query (`join_runs`, `window_runs`,
`last_stream`) and its counters (`waves_run`, `h2d_bytes`,
`kernel_builds`), so that concurrent callers of one Database never see
each other's (`_PerThread`).  The timer's scopes here (utils/timer.py):
each node's `<Node>#<id>`; in a Compound, `kernel_build` on a kernel-cache
miss, `aux_build` on an aux-table miss, `control_read`, `retry` around
each attempt past the first, and the kernel's `join#<level>` with its
`build` and `probe`, and `size_read` around each in-run size read
(exec/compound_kernel.py); the Compound's node notes `sized_in_run`.
`execute` sets the deadline (the `query_time_limit(ms)` or
`dynamic_watchdog` hint, or `enable_dynamic_watchdog`) and takes an
admission grant from the resource manager (exec/resource_mgr.py) for the
plan's estimated bytes; a subquery runs inside its parent's grant.
`_checkpoint` raises QueryInterrupted or WatchdogException at each node,
each retry of a Compound and each fragment wave; it reads a host flag and
the monotonic clock and never waits for the device.  The static watchdog
refuses a projection over more rows than `watchdog_max_projected_rows`
(`enable_watchdog` or the `watchdog` hint; `no_watchdog` lifts it).

On a mesh of more than one shard (Config.num_shards, or `mesh` set), as
the reference row-shards every scan over its mesh: each decomposable
aggregate, ORDER BY ... LIMIT k over a Scan and join probing a Scan runs
a leaf a shard over the shard's row block, on the shard's device (a view
of the resident column when the shards share the Database's device,
else a copy resident there; one host thread a device), and the leaves'
results merge on the Database's device; every other node runs there,
gathered (`_try_sharded_compound`, `_try_sharded_topk`, `shard_runs`).

A large column uploads in chunks through a ring of reused staging buffers
(pinned on CUDA, each reused only after its copy's event), with no full
padded host copy, the pad tail filled on the device, and an integer column
whose chunk-stat range fits a narrower type sent narrow and widened on the
device (`_staged_put`, the reference's rule); `prestage_table` uploads a
table's columns ahead of its first query.  The reference's jax.export
artifact cache (`_ArtifactKernel`) has no counterpart: the port runs
eagerly, and its only compiled artifacts are the nvcc builds of the hand
kernels, which kernels/_build.py already caches under build/kernels.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import (CatalogError, DeviceMemoryExceeded, DivisionByZero,
                                      ExecutionError, NotSupported, QueryInterrupted,
                                      WatchdogException)
from heavydb_tpu_torch.exec import batch as B
from heavydb_tpu_torch.exec import geo_join as GEO
from heavydb_tpu_torch.exec import radix_tier as RT
from heavydb_tpu_torch.exec import ranges as RNG
from heavydb_tpu_torch.exec.compound_kernel import (build_compound_kernel, ctrl_keys,
                                                    derive_valid, input_of_field)
from heavydb_tpu_torch.exec.expr_compiler import ExprCompiler
from heavydb_tpu_torch.exec.partial_agg import decomposable, make_leaf_node, make_merge_node
from heavydb_tpu_torch.exec.resource_mgr import ResourceMgr
from heavydb_tpu_torch.kernels import join_build as JB
from heavydb_tpu_torch.ops import agg as AGG
from heavydb_tpu_torch.ops import groupby as G
from heavydb_tpu_torch.ops import join as J
from heavydb_tpu_torch.ops import sort as S
from heavydb_tpu_torch.parallel.mesh import shard_blocks
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.plan import rel_alg as R
from heavydb_tpu_torch.plan.builder import _const_cast
from heavydb_tpu_torch.plan.select_planner import _node_dict_ref
from heavydb_tpu_torch.storage.buffer_mgr import DeviceLRUCache, default_device_budget
from heavydb_tpu_torch.storage.table import torch_to_np_dtype
from heavydb_tpu_torch.utils.timer import NOOP, NULL_TIMER

# capacity retries of one Compound: a join expansion or radix cap miss
# converges in one retry (the counts are exact; a level's need shows once
# the levels before it fit), a radix hard overflow takes one more; the sort
# tier's groups and a duplicate key under a unique build are sized in the run
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


class _PerThread:
    """An Executor attribute each thread sees on its own: the state of the
    query the thread runs (made by `default()` at a thread's first read)."""

    def __init__(self, default):
        self.default = default

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, ex, owner=None):
        if ex is None:
            return self
        tls = ex._tls
        if not hasattr(tls, self.name):
            setattr(tls, self.name, self.default())
        return getattr(tls, self.name)

    def __set__(self, ex, value):
        setattr(ex._tls, self.name, value)


class Executor:
    # per-query state of the calling thread: the interrupt hook (a callable
    # returning True to stop), the scope timer, the query hints and the
    # dynamic watchdog's monotonic deadline
    interrupt_check = _PerThread(lambda: None)
    timer = _PerThread(lambda: NULL_TIMER)
    exec_hints = _PerThread(dict)
    _deadline = _PerThread(lambda: None)
    # the calling thread's last execute(): each join Compound's builds,
    # caps and retries; each window spec's egress mode and sort; the last
    # Compound stream plan
    join_runs = _PerThread(list)
    window_runs = _PerThread(list)
    last_stream = _PerThread(lambda: None)
    # the calling thread's counters: fragment waves run by streamed
    # Compounds and top-k Sorts; host-to-device bytes of scanned columns,
    # aux tables and cache patches; Compound programs built (kernel-cache
    # misses)
    waves_run = _PerThread(int)
    h2d_bytes = _PerThread(int)
    kernel_builds = _PerThread(int)
    # the calling thread's last execute() on a mesh: how each Compound and
    # top-k Sort ran (ShardRun: sharded or gathered, and its tiers)
    shard_runs = _PerThread(list)

    # a column of at least _STAGE_MIN_BYTES uploads in pieces of
    # _STAGE_CHUNK_BYTES through _STAGE_BUFFERS reused staging buffers
    _STAGE_MIN_BYTES = 64 << 20
    _STAGE_CHUNK_BYTES = 32 << 20
    _STAGE_BUFFERS = 2

    def __init__(self, db):
        self.db = db
        self.config = db.config
        self._tls = threading.local()
        self.device = db.device
        self.resource_mgr: Optional[ResourceMgr] = None
        if self.config.enable_executor_resource_mgr:
            self.resource_mgr = ResourceMgr(self.config.max_concurrent_queries,
                                            self.config.max_exec_bytes or None,
                                            self.config.admission_queue_timeout_s)
        # the staging ring: [buffer, event of its last copy or None], and
        # the lock that gives it to one upload at a time
        self._stage_ring: List[list] = []
        self._stage_lock = threading.Lock()
        self.kernel_cache: Dict[tuple, object] = {}
        # the device tables of dictionary strings and join translations
        # (`_aux_array`), by a key that carries their dictionaries' sizes;
        # built under a lock, since shard threads fill the same transient
        # dictionaries
        self.aux_cache: Dict[tuple, object] = {}
        self._aux_lock = threading.RLock()
        budget = self.config.device_cache_bytes
        if budget == 0:
            budget = default_device_budget(self.device)
        elif budget < 0:
            budget = 0  # unbounded
        self.scan_cache = DeviceLRUCache(budget)
        # selectivity probe counts of join inputs (_selectivity_sizes)
        self._sel_cache: Dict[tuple, int] = {}
        # scan-cache keys a mutation dropped rather than moved
        self.cache_keys_dropped = 0
        # the hash tier's NDV estimates by (table, generation, key fields),
        # pruned by drop_stale
        self._ndv_cache: Dict[tuple, Optional[int]] = {}
        self.mesh = self._make_mesh(self.config.num_shards)

    def _make_mesh(self, n: Optional[int]):
        """The 1-D mesh of Config.num_shards shards (None for one): n
        virtual shards of the CPU, or n distinct cards, the Database's
        first (more cards than the machine has raise the reference's
        ValueError)."""
        if not n or n <= 1:
            return None
        from heavydb_tpu_torch.parallel.mesh import Mesh, make_mesh

        mesh = make_mesh(n, self.device.type)
        if self.device.type != "cuda":
            return mesh
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return Mesh([self.device] + [c for c in cards if c != self.device][:n - 1])

    @property
    def device(self) -> torch.device:
        """The device the calling thread's work runs on: a shard's while
        the thread runs that shard (`_on_device`), else the Database's."""
        return getattr(self._tls, "shard_device", None) or self._home

    @device.setter
    def device(self, d) -> None:
        self._home = torch.device(d)

    @property
    def mesh(self):
        """The 1-D mesh each Compound's scan is row-sharded over (None: the
        Database's device alone)."""
        return self._mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        """Run on `mesh` from the next query.  Its first device must be the
        Database's, which keeps results, merges and dictionary tables;
        every other distinct CUDA device passes the kernel gate now, so
        that nothing is built in the middle of a query.  The row blocks of
        an earlier mesh leave the scan cache."""
        if mesh is not None:
            if mesh.devices[0] != self._home:
                raise ValueError(f"the mesh's first device {mesh.devices[0]} is not "
                                 f"the Database's ({self._home})")
            for d in mesh.distinct_devices()[1:]:
                if d.type == "cuda":
                    from heavydb_tpu_torch.kernels.gate import kernel_gate

                    kernel_gate(d)
        for key, _ in self.scan_cache.items():
            if _is_block_key(key):
                self.scan_cache.pop(key)
        self._mesh = mesh

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------
    def execute(self, root: R.RelNode) -> B.Batch:
        """Run a plan under the dynamic watchdog's deadline and, with the
        resource manager on, inside an admission grant for its estimated
        scan and output bytes (queued FIFO while the grants in force leave
        no room)."""
        self.join_runs = []
        self.window_runs = []
        self.shard_runs = []
        hints = self.exec_hints
        limit_ms = 0
        if self.config.enable_dynamic_watchdog or hints.get("dynamic_watchdog") \
                or hints.get("query_time_limit"):
            try:
                limit_ms = int(hints.get("query_time_limit") or 0)
            except (TypeError, ValueError):
                limit_ms = 0
            limit_ms = limit_ms or self.config.dynamic_watchdog_time_limit_ms
        self._deadline = time.monotonic() + limit_ms / 1000.0 if limit_ms else None
        rm = self.resource_mgr
        if rm is None:
            return self._execute_plan(root)
        est = rm.estimate_scan_bytes(root) + rm.estimate_output_bytes(root, self)
        with rm.acquire(est):
            return self._execute_plan(root)

    def _checkpoint(self) -> None:
        """Raise QueryInterrupted when the calling thread's interrupt hook
        says so, WatchdogException past its deadline.  A host flag and the
        monotonic clock: nothing waits for the device."""
        check = self.interrupt_check
        if check is not None and check():
            raise QueryInterrupted("query interrupted by session")
        dl = self._deadline
        if dl is not None and time.monotonic() > dl:
            raise WatchdogException("query exceeded the dynamic watchdog time limit")

    def _execute_plan(self, root: R.RelNode) -> B.Batch:
        """Run a plan after substituting its uncorrelated subqueries; a
        subquery's own plan comes back through here, inside the outer
        query's admission grant (another grant could wait on itself at
        `max_concurrent_queries`), and the outer query's `join_runs` keep
        its subqueries' join runs too."""
        self._substitute_subqueries(root, set())
        for node in R.topo_order(root):
            for e in _iter_node_exprs(node):
                if any(isinstance(s, E.SubqueryExpr) for s in E.walk(e)):
                    raise NotSupported("a subquery left after substitution")
        return self._exec(root, {}, needed=set(range(root.arity)))

    # ------------------------------------------------------------------
    # uncorrelated subqueries (the reference's executeRelAlgSubqueries)
    # ------------------------------------------------------------------
    def _substitute_subqueries(self, node: R.RelNode, seen: set) -> None:
        """Run every SubqueryExpr of the plan's Compounds and rewrite it in
        place into a Constant or an InValues, inputs first; everything
        after this (the kernel cache key, streaming, fragment skipping, the
        string tables) sees the constants."""
        if node.id in seen:
            return
        seen.add(node.id)
        for i in node.inputs:
            self._substitute_subqueries(i, seen)
        if not isinstance(node, R.Compound):
            return

        def subst(e: E.Expr) -> E.Expr:
            return self._eval_subquery(e) if isinstance(e, E.SubqueryExpr) else e

        def rw(e):
            return None if e is None else E.rewrite(e, subst)

        node.join_levels = [(k, rw(c)) for k, c in node.join_levels]
        node.filter_cond = rw(node.filter_cond)
        node.group_exprs = [rw(e) for e in node.group_exprs]
        node.aggs = [rw(e) for e in node.aggs]
        node.target_exprs = [rw(e) for e in node.target_exprs]
        node.having = rw(node.having)

    def _eval_subquery(self, e: E.SubqueryExpr) -> E.Expr:
        """The subquery's value as an expression: a scalar (NULL for no
        row; more than one row raises), EXISTS as a boolean, IN as an
        InValues over the result's non-NULL values (dictionary strings
        remapped into the probe column's dictionary, strings it lacks
        dropped); NOT IN over a list holding a NULL is never true.  The
        result is read from the device once."""
        from heavydb_tpu_torch.plan.optimizer import optimize

        # the reference optimizes the subquery's plan again (a CTE shared
        # with the outer plan runs once for each, with its own memo)
        plan = optimize(e.plan)
        out = self._execute_plan(plan)
        if e.kind == "exists":
            res = (out.nrows > 0) != bool(e.negated)
            return E.Constant(1 if res else 0, T.boolean(False))
        ti = out.types[0]
        if e.kind == "scalar":
            if out.nrows == 0:
                return E.Constant(None, e.type)
            if out.nrows > 1:
                raise ExecutionError("scalar subquery returned more than one row")
            v = out.col(0)[0].item()
            if _is_null_value(v, ti):
                return E.Constant(None, e.type)
            return E.Constant(v, ti.with_nullable(False))
        vals = out.col(0)[: out.nrows].cpu().numpy()
        arg = e.arg
        if arg.type.is_dict_string:
            sub_ref = _node_dict_ref(plan, 0) if ti.is_dict_string else None
            if sub_ref is None:
                raise NotSupported("IN subquery over computed strings")
            strings = self.db.dict_by_ref(sub_ref).get_strings(vals)
            probe = self.db.dict_by_ref(arg.dict_ref)
            ids = [probe.get_id(s) for s in strings if s is not None]
            return E.InValues(arg=arg, values=tuple(i for i in ids if i >= 0),
                              negated=e.negated, type=T.boolean(arg.type.nullable))
        pys = []
        had_null = False
        for v in vals.tolist():
            if _is_null_value(v, ti):
                had_null = True
                continue
            pys.append(_const_cast(v, ti, arg.type))
        if e.negated and had_null:
            # x NOT IN (..., NULL) is never TRUE (three-valued logic)
            return E.Constant(0, T.boolean(nullable=False))
        return E.InValues(arg=arg, values=tuple(pys), negated=e.negated,
                          type=T.boolean(arg.type.nullable))

    def _exec(self, node: R.RelNode, memo, needed) -> B.Batch:
        if node.id in memo:
            return memo[node.id]
        self._checkpoint()
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
            elif isinstance(node, R.Union):
                out = self._exec_union(node, memo)
            elif isinstance(node, R.Unnest):
                out = self._exec_unnest(node, memo)
            elif isinstance(node, R.Window):
                out = self._exec_window(node, memo)
            else:
                raise NotSupported(f"cannot execute node {type(node).__name__}")
        memo[node.id] = out
        return out

    # ---- scan-cache moves for UPDATE / DELETE / TRUNCATE ----
    # A mutation bumps the table's generation, which is part of every scan
    # cache key.  Instead of an O(table) upload at the next query, the
    # resident full-table columns move to the new generation on the device:
    # a scatter of the new values for an UPDATE, a gather of the kept rows
    # for a DELETE.  Both make new tensors, so a tensor the caller gave
    # `load_table_device` (which the cache may hold itself) is never written.
    # A fragment-subset entry, or a TEXT ENCODING NONE column (its lazy
    # dictionary re-interns in the new generation), is dropped and counted.
    def _old_entries(self, t, old_gen: int, changed=()):
        """The (key, tensor) entries of t's generation old_gen, removed
        from the cache, full-table ones of columns t still has and that are
        not in `changed` only; the others are dropped."""
        out = []
        live = {cd.col_id: cd for cd in t.columns}
        for key, arr in list(self.scan_cache.items()):
            if key[0] != t.table_id or key[1] != old_gen:
                continue
            self.scan_cache.pop(key)
            cd = live.get(key[2])
            if key[4] is not None or cd is None or cd.type.is_none_string \
                    or key[2] in changed:
                self.cache_keys_dropped += 1
                continue
            out.append((key, arr))
        return out

    def patch_cache_columns(self, t, old_gen: int, changed=()) -> None:
        """Move t's resident columns from old_gen to its generation after a
        statement that bumped it without touching their rows (ADD / DROP /
        RENAME COLUMN, OPTIMIZE, ALTER COLUMN TYPE of another column); a
        column in `changed`, or dropped, leaves the cache."""
        for (tid, _, cid, size, _), arr in self._old_entries(t, old_gen, changed):
            self.scan_cache[(tid, t.generation, cid, size, None)] = arr

    def patch_cache_update(self, t, old_gen: int, rowids: np.ndarray,
                           new_cols: Dict[int, np.ndarray]) -> None:
        """Move t's resident columns from old_gen to its generation; each
        updated column gets the new values (aligned with rowids, the
        global row positions) by a device scatter."""
        rid = None
        for (tid, _, cid, size, _), arr in self._old_entries(t, old_gen):
            if cid in new_cols:
                if rid is None:
                    rid = self._to_device(np.asarray(rowids, np.int64))
                vals = np.asarray(new_cols[cid]).astype(
                    torch_to_np_dtype(arr.dtype), copy=False)
                arr = arr.index_put((rid,), self._to_device(vals))
            self.scan_cache[(tid, t.generation, cid, size, None)] = arr

    def patch_cache_delete(self, t, old_gen: int, old_num_rows: int,
                           rowids: np.ndarray) -> None:
        """Move t's resident columns from old_gen to its generation by a
        device gather of the rows that stay (rowids: the deleted rows'
        global positions), null-padded to the new row bucket."""
        new_n = t.num_rows
        new_size = B.bucket(new_n)
        keep = None
        for (tid, _, cid, _, _), arr in self._old_entries(t, old_gen):
            if t.column_by_id(cid).type.is_array:
                # array handles are global rowids: renumbered, not moved
                self.scan_cache[(tid, t.generation, cid, new_size, None)] = \
                    self._array_handles(t, None, new_n, new_size)
                continue
            if keep is None:
                gone = torch.zeros(old_num_rows, dtype=torch.bool, device=self.device)
                gone[self._to_device(np.asarray(rowids, np.int64))] = True
                keep = torch.nonzero(~gone).squeeze(1)
            comp = arr[keep]
            if new_size > new_n:
                comp = torch.cat([comp, torch.full(
                    (new_size - new_n,), t.column_by_id(cid).type.null_sentinel(),
                    dtype=arr.dtype, device=arr.device)])
            self.scan_cache[(tid, t.generation, cid, new_size, None)] = comp

    def drop_stale(self) -> None:
        """Drop, and count, every scan-cache entry of a table that is gone
        or has changed its generation since: none can be read again (an
        UPDATE's or a DELETE's columns were moved first).  NDV estimates and
        the array and geo aux tables of such tables go too."""
        def live(key):
            try:
                return self.db.catalog.get_table_by_id(key[0]).generation == key[1]
            except CatalogError:
                return False

        for key in [k for k, _ in self.scan_cache.items()]:
            if not live(key):
                self.scan_cache.pop(key)
                self.cache_keys_dropped += 1
        for key in [k for k in self._ndv_cache if not live(k)]:
            del self._ndv_cache[key]
        for key in [k for k in self.aux_cache
                    if k[0] in ("array", "geobbox") and not live(k[1:3])]:
            del self.aux_cache[key]

    # ---- Scan ----
    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """One host-to-device copy, counted in h2d_bytes."""
        host = np.ascontiguousarray(host)
        self.h2d_bytes += host.nbytes
        return torch.from_numpy(host).to(self.device)

    def _staged_put(self, parts, size: int, ti, rng=None) -> torch.Tensor:
        """A column's host pieces (its fragments' chunks, in order) as one
        device tensor of `size` rows, null-padded.  Under _STAGE_MIN_BYTES:
        one pageable copy.  Else the pieces go in _STAGE_CHUNK_BYTES chunks
        through the staging ring into a tensor allocated on the device, whose
        pad tail is filled there, so the host holds no full padded copy.  An
        integer column whose chunk-stat range `rng` = (lo, hi, has_nulls)
        fits int8 / int16 / int32 with room for that type's minimum as its
        NULL (the reference's rule) crosses narrow and is widened on the
        device, the narrow minimum mapped back to the column's sentinel.
        h2d_bytes counts the bytes that cross."""
        parts = [np.asarray(p) for p in parts]
        dt = parts[0].dtype if parts else np.dtype(ti.np_dtype())
        n = sum(int(p.shape[0]) for p in parts)
        sent = ti.null_sentinel()
        if n * dt.itemsize < self._STAGE_MIN_BYTES:
            return self._to_device(np.concatenate(
                parts + [np.full(size - n, sent, dt)]))
        narrow = _narrow_dtype(dt, rng)
        send_dt = narrow if narrow is not None else dt
        send_sent = np.iinfo(narrow).min if narrow is not None else sent
        out = torch.empty(size, dtype=G.torch_dtype(send_dt), device=self.device)
        if size > n:
            out[n:] = send_sent
        remap = narrow is not None and bool(rng[2])
        rows = max(1, self._STAGE_CHUNK_BYTES // send_dt.itemsize)
        with self._stage_lock:
            ring = self._staging_ring()
            pos = k = 0
            for part in parts:
                for i in range(0, part.shape[0], rows):
                    src = part[i:i + rows]
                    m = src.shape[0]
                    slot = ring[k % len(ring)]
                    if slot[1] is not None:
                        slot[1].synchronize()  # its last copy has left it
                    buf = slot[0].view(G.torch_dtype(send_dt))[:m]
                    host = buf.numpy()
                    np.copyto(host, src, casting="unsafe")
                    if remap:
                        host[src == sent] = send_sent
                    out[pos:pos + m].copy_(buf, non_blocking=True)
                    if self.device.type == "cuda":
                        slot[1] = torch.cuda.Event()
                        slot[1].record()
                    pos += m
                    k += 1
        self.h2d_bytes += n * send_dt.itemsize
        if narrow is None:
            return out
        return torch.where(out == int(send_sent), sent, out.to(G.torch_dtype(dt)))

    def _staging_ring(self) -> List[list]:
        """The staging buffers of _STAGE_CHUNK_BYTES, made at first use
        (page-locked on CUDA, so that a copy runs while the next chunk is
        filled) and again when the chunk size changes."""
        nbytes = self._STAGE_CHUNK_BYTES
        if not self._stage_ring or self._stage_ring[0][0].numel() != nbytes:
            for slot in self._stage_ring:
                if slot[1] is not None:
                    slot[1].synchronize()
            pin = self.device.type == "cuda"
            self._stage_ring = [[torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin),
                                 None] for _ in range(self._STAGE_BUFFERS)]
        return self._stage_ring

    def prestage_table(self, t) -> None:
        """Upload every column of t into the scan cache now, and wait for
        the copies, so that its first query finds it resident.  A failure
        raises: nothing falls back to a later upload."""
        self._exec_scan(R.Scan(t), None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _rowids(self, t, frag_ids, n: int, size: int) -> torch.Tensor:
        """The virtual rowid of the scanned fragments (all, or frag_ids):
        each row's global physical position, made on the device, padded
        with the BIGINT null."""
        dev = self.device
        rid = torch.full((size,), T.bigint().null_sentinel(), dtype=torch.int64, device=dev)
        if frag_ids is None:
            rid[:n] = torch.arange(n, dtype=torch.int64, device=dev)
            return rid
        gstart = np.cumsum([0] + [f.num_rows for f in t.fragments])
        lens = [t.fragments[f].num_rows for f in frag_ids]
        local = np.cumsum([0] + lens[:-1])
        shift = torch.tensor([int(gstart[f] - lo) for f, lo in zip(frag_ids, local)],
                             dtype=torch.int64, device=dev)
        rid[:n] = torch.arange(n, dtype=torch.int64, device=dev) + torch.repeat_interleave(
            shift, torch.tensor(lens, device=dev), output_size=n)
        return rid

    def _array_handles(self, t, frag_ids, n: int, size: int) -> torch.Tensor:
        """The device handle of an array or geo column over the scanned
        fragments: each row's int32 global rowid (the index of its host
        payload row; its lengths, offsets and elements ride as aux tables,
        `_array_aux`), -1 past the n rows."""
        rid = self._rowids(t, frag_ids, n, size)
        return torch.where(rid >= 0, rid, -1).to(torch.int32)

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
                cols.append(self._rowids(t, frag_ids, n, size))
                continue
            cd = t.columns[i]
            key = (t.table_id, t.generation, cd.col_id, size, fkey)
            arr = self.scan_cache.get(key)
            if arr is None and cd.type.is_array:
                arr = self._array_handles(t, frag_ids, n, size)
                self.scan_cache[key] = arr
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
            if arr is None and fkey is None and self._sharded() and not self._views():
                # a node that runs gathered, over the shards' resident row
                # blocks copied to the Database's device (not cached)
                gathered = self._gathered_column(t, cd, size)
                if gathered is not None:
                    cols.append(gathered)
                    continue
            if arr is None and cd.type.is_none_string:
                # TEXT ENCODING NONE scans as ids of the table's lazy
                # dictionary of this generation (the reference's
                # StringDictionaryProxy interning at query time)
                _, ids = t.lazy_text_dict(cd.col_id)
                use = range(len(t.fragments)) if frags is None else frag_ids
                arr = self._staged_put([ids[int(gstart[f]):int(gstart[f + 1])] for f in use],
                                       size, T.text_dict(nullable=cd.type.nullable))
                self.scan_cache[key] = arr
            if arr is None:
                parts = [f.chunks[cd.col_id] for f in (t.fragments if frags is None else frags)
                         if f.num_rows]
                arr = self._staged_put(parts, size, cd.type, t.column_range(cd.col_id))
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

    # ---- Union ----
    def _exec_union(self, node: R.Union, memo) -> B.Batch:
        """UNION ALL: the inputs' live rows concatenated on the device.  The
        values keep the promoted dtype of the concatenation (INT with FLOAT
        gives float32) under the Union's declared types, the left input's,
        as the reference's do.  UNION DISTINCT, INTERSECT / EXCEPT and the
        grouping sets are Compounds over this node."""
        parts = [self._exec(i, memo, set(range(i.arity))) for i in node.inputs]
        out = B.concat_batches(parts)
        out.types = list(node.types)
        return out

    # ---- Unnest ----
    def _exec_unnest(self, node: R.Unnest, memo) -> B.Batch:
        """One output row an array element (the reference's
        `_exec_unnest`): the join expansion (ops/join.expand_matches) of
        each live row into its elements, over the flat element payload.
        Its capacity is the flat size, so it never retries.  The element
        column comes last; a NULL element keeps its sentinel."""
        child = node.inputs[0]
        inp = self._exec(child, memo, set(range(child.arity)))
        lengths, offsets, flat = self._array_aux(node.afn)
        rid = inp.cols[node.afn.rowid.field_idx].to(torch.int64)
        live = self._in_domain(inp.padded, inp.nrows) & (rid >= 0)
        ridc = rid.clamp(0, lengths.shape[0] - 1)
        cnt = torch.where(live, lengths[ridc].clamp(min=0), 0)
        pidx, elem, out_mask, _, needed = J.expand_matches(
            offsets[ridc], cnt, flat, None, int(flat.shape[0]), False)
        pidx = torch.where(out_mask, pidx, 0)
        cols = [None if c is None else c[pidx] for c in inp.cols] + [elem]
        return B.Batch(cols, int(needed), list(node.types))

    # ---- Window ----
    def _exec_window(self, node: R.Window, memo) -> B.Batch:
        """The window columns appended to the child's (exec/window_kernel.py),
        with the dictionary-string tables of the functions' arguments and
        an id -> rank table for each dictionary-string ORDER BY key, so that
        such keys order lexicographically (the Sort node's contract)."""
        from heavydb_tpu_torch.exec.window_kernel import run_window

        child = node.inputs[0]
        inp = self._exec(child, memo, set(range(child.arity)))
        specs = _expr_aux_specs(node.wfuncs)
        aux = self._aux_tables(specs, list(specs))
        rank_info = {}
        for w in node.wfuncs:
            for e, _asc, _nf in w.order_by:
                if e.type.is_dict_string and isinstance(e, E.InputRef):
                    # the bound expression carries its dictionary; a Compound
                    # target built by a later pass may have dropped it, and
                    # ranking by raw id would order by first insertion
                    ref = getattr(e, "dict_ref", None) \
                        or self._result_dict_ref(child, e.field_idx)
                    if ref is not None:
                        ak = ("winrank", e.key())
                        aux[ak] = self._dict_rank_table(ref)
                        rank_info[e.key()] = (ak, self.db.dict_by_ref(ref).size)
        cols, wcols, runs = run_window(node, inp, aux, rank_info,
                                       getattr(self.db, "_udfs", {}), self.device)
        self.window_runs.extend(runs)
        return B.Batch(list(cols) + list(wcols), inp.nrows, list(node.types))

    def _result_dict_ref(self, node: R.RelNode, field_idx: int):
        return _node_dict_ref(node, field_idx)

    # ---- Sort ----
    def _in_domain(self, padded: int, nrows: int) -> torch.Tensor:
        """bool[padded]: True for the live rows, which come first."""
        m = torch.ones(padded, dtype=torch.bool, device=self.device)
        m[nrows:] = False
        return m

    def _dict_rank_table(self, ref) -> torch.Tensor:
        """id -> lexicographic rank, for string ORDER BY keys and MIN / MAX
        over a dictionary string; built on the host once per dictionary
        size."""
        d = self.db.dict_by_ref(ref)

        def make():
            host = np.zeros(B.bucket(max(d.size, 1)), np.int32)
            order = np.argsort(np.array(d.entries(), dtype=object))
            host[order.astype(np.int32)] = np.arange(len(order), dtype=np.int32)
            return host

        return self._cached(("rank", ref, d.size), make)

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
        key_idxs = [i for i, _, _ in node.keys]
        limit_total = (node.limit or 0) + (node.offset or 0)
        composite_specs = None
        if len(node.keys) > 1 and node.limit is not None:
            composite_specs = self._composite_sort_plan(node, child)
        topk_eligible = (
            node.limit is not None
            and 0 < limit_total <= _TOPK_MAX
            and ((len(node.keys) == 1
                  and not node.types[key_idxs[0]].is_dict_string)
                 or composite_specs is not None))
        if node.limit is not None and 0 < limit_total <= _TOPK_MAX \
                and child.id not in memo and self._sharded():
            st = self._try_sharded_topk(node, child, limit_total, topk_eligible,
                                        composite_specs)
            if st is not None:
                return st
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
        return self._sorted_rows(node, child, inp, node.offset or 0, node.limit)

    def _sorted_rows(self, node: R.Sort, child, inp: B.Batch, off: int,
                     limit: Optional[int]) -> B.Batch:
        """The full sort of inp's rows (dictionary strings by their
        lexicographic rank, a stable sort), rows [off, off + limit) kept."""
        n = inp.nrows
        key_tvs = []
        for idx, _, _ in node.keys:
            ti = inp.types[idx]
            val = inp.cols[idx]
            valid = derive_valid(val, ti) if ti.nullable else None
            ref = _node_dict_ref(child, idx) if ti.is_dict_string else None
            if ref is not None:
                tbl = self._dict_rank_table(ref)
                safe = val.clamp(0, tbl.shape[0] - 1).to(torch.int64)
                val = torch.where(val >= 0, tbl[safe], -1)
            key_tvs.append((val, valid))
        perm, _, _ = S.sort_permutation(key_tvs, [(asc, nf) for _, asc, nf in node.keys],
                                        self._in_domain(inp.padded, n))
        n_out = max(n - off, 0)
        if limit is not None:
            n_out = min(n_out, limit)
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
        thr = self._stream_threshold()
        src = _topk_source(child)
        if thr < 0 or src is None or len(src[0].table.fragments) < 2:
            return None
        scan, compound, scan_needed, row_bytes = src
        t = scan.table
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
            self._checkpoint()
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

    def _stream_threshold(self) -> int:
        """Config.stream_threshold_bytes resolved: 0 is half the scan
        cache's budget; -1 never streams."""
        thr = self.config.stream_threshold_bytes
        return (self.scan_cache.budget_bytes or (11 << 30)) // 2 if thr == 0 else thr

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
        if self._sharded():
            out = self._try_sharded_compound(node, memo)
            if out is not None:
                return out
        sp = self._stream_plan(node)
        if sp is not None:
            out, tier = self._exec_compound_streamed(node, sp), "waves"
        else:
            batches, plan = self._prepare_compound(node, memo)
            out = self._run_compound(node, batches, plan)
            tier = _tier_of(plan)
        if self._sharded():
            self.shard_runs.append(ShardRun(f"Compound#{node.id}", "compound", "gathered",
                                            [tier]))
        return out

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
        # retry ladder: an attempt returns the rungs that updated the plan
        # when the run missed a capacity it cannot size itself (a join
        # expansion, the radix or hash tier's table) or must change tier;
        # each attempt past the first runs in a `retry` scope that notes
        # them (`cause`), and the Compound's scope notes its tier, retries,
        # whether a program was built, and what the runs sized from a host
        # read (`sized_in_run`)
        builds, rungs, sized = self.kernel_builds, None, []
        for attempt in range(MAX_RETRIES + 1):
            with self.timer.scope("retry") if attempt else NOOP:
                if rungs:
                    self.timer.note(cause=rungs)
                out = self._attempt_compound(node, batches, plan, sized)
            if isinstance(out, B.Batch):
                self.timer.note(tier=_tier_of(plan), retries=attempt,
                                kernel_built=self.kernel_builds > builds)
                if sized:
                    self.timer.note(sized_in_run=sized)
                if plan.joins:
                    self.join_runs.append(JoinRun(
                        [_build_form(jp, b.padded) for jp, b in zip(plan.joins, batches[1:])],
                        list(plan.caps), attempt))
                return out
            rungs = out
        raise ExecutionError("capacity retry ladder did not converge")

    def _attempt_compound(self, node: R.Compound, batches, plan, sized):
        """One run of the Compound's program: its Batch, or the names of
        the ladder's rungs that changed the plan for another run.  What the
        run sized from a host read is appended to `sized`."""
        self._checkpoint()
        if plan.joins:
            self._check_join_memory(node, batches, plan)
        kernel, layout = self._get_kernel(node, batches, plan)
        try:
            outs = kernel(*self._kernel_args(batches, plan, layout), timer=self.timer)
        except RT.RadixUnsupported:
            # the compiled aggregate shape diverged from the radix
            # tier's static stream plan: reroute to the sort tier
            if plan.group_strategy[0] != "radix":
                raise
            plan.group_strategy = ("sort", None)
            return ["radix_unsupported"]
        sized.extend(outs.get("sized_in_run", ()))
        return self._postprocess(node, plan, outs)

    def _join_bytes(self, node: R.Compound, batches, plan) -> int:
        """Device bytes a join Compound's kernel holds, from its inputs and
        plan: the input columns; per level, its domain d (the cap; for a
        unique build, the larger of the previous domain and the fallback
        capacity that a duplicate key expands it into; plus the build's padded rows
        for FULL, or the previous domain for LEFT with a residual; the
        candidate pairs of SEMI / ANTI with a residual) x (per input in the
        domain 4 B of row index and 1 B of matched flag, 1 B of mask, the
        input columns gathered into the domain, and 24 B of expansion
        temporaries: marks, prefix sum, slot, ordinal, build position and
        two flags); a grid join's replicated build keys (offsets x the
        build's padded rows, each with its packed key, validity, sorted key
        and row, and two hash slots of key, start and count: 57 B); and
        the group tier's working bytes a row (`_tier_row_bytes`) over the
        last domain."""
        col_bytes = [sum(c.element_size() for c in b.cols if c is not None)
                     for b in batches]
        total = sum(b.padded * cb for b, cb in zip(batches, col_bytes))
        d = batches[0].padded
        for li, (jp, cap) in enumerate(zip(plan.joins, plan.caps)):
            k = li + 2  # inputs in the domain after this level
            per_slot = 5 * k + 1 + sum(col_bytes[:k]) + 24
            if jp.kind in ("SEMI", "ANTI"):
                total += (cap if jp.residual else 0) * per_slot
                continue
            if jp.geo is not None:
                total += len(jp.geo.offsets) * batches[li + 1].padded * 57
            prev = d
            # a unique build expands into its fallback capacity in the same
            # run when the probe finds a duplicate key
            d = max(d, jp.fallback_cap) if jp.unique_build else cap
            if jp.kind == "FULL":
                d += batches[li + 1].padded
            elif jp.kind == "LEFT" and jp.residual:
                d += prev
            total += d * per_slot
        if node.is_aggregate:
            total += d * self._tier_row_bytes(node, d)
        return total

    def _check_join_memory(self, node: R.Compound, batches, plan) -> None:
        """DeviceMemoryExceeded before the kernel launches anything when the
        join's bytes (`_join_bytes`) would not fit the free device memory;
        nothing is checked off CUDA."""
        need = self._join_bytes(node, batches, plan)
        free = free_device_bytes(self.device, need)
        if free is not None and need > free:
            raise DeviceMemoryExceeded(
                f"a join of caps {list(plan.caps)} needs {need} B, more than the "
                f"{free} B free on {self.device}")

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
            self._check_merge_memory(node, inp.num_rows, inp.types)
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
        work_row = row_bytes + self._tier_row_bytes(node, sum(rows))
        free = free_device_bytes(self.device, sum(rows) * work_row)
        by_memory = free is not None and sum(rows) * work_row > free
        thr = self._stream_threshold()
        if thr < 0 or len(t.fragments) < 2 or not decomposable(node):
            if by_memory:
                raise DeviceMemoryExceeded(
                    f"{sum(rows)} rows x {work_row} B need more than the "
                    f"{free} B free on {self.device}, and this query cannot "
                    "run in fragment waves")
            return None
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

    def _check_merge_memory(self, node: R.Compound, nrows: int, types) -> None:
        """DeviceMemoryExceeded when a merge Compound over nrows partial
        rows (their columns and the group-by tier's working bytes) would
        not fit the free memory."""
        work_row = (sum(ti.np_dtype().itemsize for ti in types)
                    + self._tier_row_bytes(node, nrows))
        free = free_device_bytes(self.device, nrows * work_row)
        if free is not None and nrows * work_row > free:
            raise DeviceMemoryExceeded(
                f"merging {nrows} partial rows x {work_row} B needs "
                f"more than the {free} B free on {self.device}")

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
            self._checkpoint()
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

    # ---- sharded execution (a mesh of more than one shard) ----
    # The reference row-shards every scanned column over its mesh and lets
    # XLA partition each Compound.  Here each shard's row block of the probe
    # Scan (`parallel/mesh.shard_blocks`) is a view of the resident column
    # when every shard is the Database's device, else its own copy resident
    # on the shard's device; each shard runs a leaf over its block on its
    # device, and the leaves' results meet on the Database's device.
    def _sharded(self) -> bool:
        return self._mesh is not None and self._mesh.size > 1

    def _views(self) -> bool:
        """Every shard is the Database's device: a block is a view."""
        return self._mesh.distinct_devices() == [self._home]

    @contextlib.contextmanager
    def _on_device(self, dev: torch.device):
        """The calling thread's work runs on dev (its tensors, kernels,
        aux tables and memory checks; CUDA's current device) inside."""
        prev = getattr(self._tls, "shard_device", None)
        self._tls.shard_device = dev
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    yield
            else:
                yield
        finally:
            self._tls.shard_device = prev

    def _on_shards(self, blocks, fn) -> list:
        """fn(lo, hi) over each block on its device, the results in block
        order.  The blocks of one device run one after another; with more
        than one device, one host thread a device runs them at the same
        time, carrying the query's interrupt hook, deadline and hints, and
        a checkpoint raised in one stops the others.  The threads' counters
        and records (h2d_bytes, waves_run, join_runs, last_stream) add to
        the caller's; the first error raised is raised here."""
        by_dev: Dict[torch.device, List[int]] = {}
        for i, b in enumerate(blocks):
            by_dev.setdefault(b.device, []).append(i)
        out: list = [None] * len(blocks)

        def run(dev, idxs):
            with self._on_device(dev):
                for i in idxs:
                    self._checkpoint()
                    out[i] = fn(blocks[i].lo, blocks[i].hi)

        if len(by_dev) == 1:
            run(*next(iter(by_dev.items())))
            return out
        check, deadline, hints = self.interrupt_check, self._deadline, self.exec_hints
        stop = threading.Event()
        errors: List[BaseException] = []
        lock = threading.Lock()

        def shard_thread(dev, idxs):
            # a pool thread may take a second device's shards: its records
            # start empty for each
            self.interrupt_check = lambda: stop.is_set() or bool(check and check())
            self._deadline, self.exec_hints = deadline, hints
            self.h2d_bytes, self.waves_run, self.join_runs, self.last_stream = 0, 0, [], None
            try:
                run(dev, idxs)
            except Exception as e:  # raised again by the caller, below
                with lock:
                    errors.append(e)
                stop.set()
            return self.h2d_bytes, self.waves_run, self.join_runs, self.last_stream

        with concurrent.futures.ThreadPoolExecutor(len(by_dev)) as pool:
            stats = [f.result() for f in [pool.submit(shard_thread, d, idxs)
                                          for d, idxs in by_dev.items()]]
        for h2d, waves, joins, last in stats:
            self.h2d_bytes += h2d
            self.waves_run += waves
            self.join_runs.extend(joins)
            if last is not None:
                self.last_stream = last
        if errors:
            raise errors[0]
        return out

    def _blocks_to_run(self, scan: R.Scan, filter_cond) -> list:
        """The shards' non-empty row blocks of a scan that overlap a
        fragment the filter's chunk stats leave (a block spans parts of
        fragments); the first block when none does, so that a keyless
        aggregate still has its row."""
        t = scan.table
        blocks = [b for b in shard_blocks(self._mesh, t.num_rows) if b.hi > b.lo]
        if filter_cond is not None and len(t.fragments) > 1:
            frag_ids = self._surviving_fragments(scan, filter_cond)
            if frag_ids is not None:
                gstart = np.cumsum([0] + [f.num_rows for f in t.fragments])
                spans = [(int(gstart[f]), int(gstart[f + 1])) for f in frag_ids]
                blocks = [b for b in blocks
                          if any(a < b.hi and b.lo < e for a, e in spans)] or blocks[:1]
        return blocks

    def _scan_rows(self, scan: R.Scan, needed, lo: int, hi: int, keep: bool) -> B.Batch:
        """Rows [lo, hi) of a Scan's needed columns on this thread's
        device, null-padded to their bucket, uploaded through
        `_staged_put` from the fragments they cross: a shard's row block,
        kept in the scan cache under its range and device (`keep`), or a
        wave of one, for this run only."""
        t = scan.table
        m = hi - lo
        size = B.bucket(m)
        dev = self.device
        gstart = np.cumsum([0] + [f.num_rows for f in t.fragments])
        cols: List[Optional[torch.Tensor]] = []
        for i in range(scan.arity):
            if i not in needed:
                cols.append(None)
            elif i >= len(t.columns):  # the virtual rowid: global positions
                rid = torch.full((size,), T.bigint().null_sentinel(), dtype=torch.int64,
                                 device=dev)
                rid[:m] = torch.arange(lo, hi, dtype=torch.int64, device=dev)
                cols.append(rid)
            else:
                cd = t.columns[i]
                key = _block_key(t, cd.col_id, lo, hi, dev)
                arr = self.scan_cache.get(key) if keep else None
                if arr is None:
                    if cd.type.is_none_string:
                        _, ids = t.lazy_text_dict(cd.col_id)
                        parts = [ids[lo:hi]]
                        ti, rng = T.text_dict(nullable=cd.type.nullable), None
                    else:
                        parts = [np.asarray(f.chunks[cd.col_id])[max(lo, a) - a:min(hi, e) - a]
                                 for f, a, e in zip(t.fragments, gstart[:-1], gstart[1:])
                                 if a < hi and lo < e]
                        ti, rng = cd.type, t.column_range(cd.col_id)
                    arr = self._staged_put(parts, size, ti, rng)
                    if keep:
                        self.scan_cache[key] = arr
                cols.append(arr)
        return B.Batch(cols, m, list(scan.types))

    def _gathered_column(self, t, cd, size: int) -> Optional[torch.Tensor]:
        """A column whose shards' row blocks are all resident, copied from
        their devices onto the Database's and null-padded to size, for a
        node that runs gathered; None when a block is not resident."""
        arrs = []
        for b in shard_blocks(self._mesh, t.num_rows):
            if b.hi > b.lo:
                blk = self.scan_cache.get(_block_key(t, cd.col_id, b.lo, b.hi, b.device))
                if blk is None:
                    return None
                arrs.append(blk[:b.hi - b.lo].to(self._home))
        if not arrs:
            return None
        arrs.append(torch.full((size - t.num_rows,), cd.type.null_sentinel(),
                               dtype=arrs[0].dtype, device=self._home))
        return torch.cat(arrs)

    def _resident_rows(self, scan: R.Scan, needed, row_bytes: int,
                       work_bytes: int) -> Optional[B.Batch]:
        """On a mesh of the Database's device alone: the needed columns over
        the whole table, resident there (uploaded now unless their bytes
        with work_bytes pass the free memory), of which the blocks are
        views; None elsewhere (blocks resident on their devices, or waves
        uploaded one at a time)."""
        if not self._views():
            return None
        t = scan.table
        size = B.bucket(t.num_rows)
        resident = all(self.scan_cache.get((t.table_id, t.generation, t.columns[f].col_id,
                                            size, None)) is not None
                       for f in needed if f < len(t.columns))
        need = work_bytes + (0 if resident else t.num_rows * row_bytes)
        free = free_device_bytes(self._home, need)
        if free is not None and need > free:
            return None
        return self._exec_scan(scan, needed)

    def _block_rows(self, scan: R.Scan, needed, block, lo: int, hi: int,
                    full: Optional[B.Batch]) -> B.Batch:
        """Rows [lo, hi) of a shard's block (block = its (lo, hi)) on this
        thread's device: a view of `full` or of the resident block, the
        block itself (made resident), or a wave uploaded for this run."""
        def view(b, a):
            return B.Batch([None if c is None else c[lo - a:hi - a] for c in b.cols],
                           hi - lo, list(b.types))

        if full is not None:
            return view(full, 0)
        if self._views():
            return self._scan_rows(scan, needed, lo, hi, keep=False)
        if (lo, hi) == tuple(block):
            return self._scan_rows(scan, needed, lo, hi, keep=True)
        t = scan.table
        cols = [None] * scan.arity
        for f in needed:
            if f < len(t.columns):
                cols[f] = self.scan_cache.get(_block_key(t, t.columns[f].col_id, *block,
                                                         self.device))
        if all(cols[f] is not None for f in needed):
            return view(B.Batch(cols, block[1] - block[0], list(scan.types)), block[0])
        return self._scan_rows(scan, needed, lo, hi, keep=False)

    def _shard_waves(self, node: R.Compound, m: int, row_bytes: int) -> list:
        """The row ranges [a, b) of a shard's block of m rows its leaf runs
        over: the whole block, or waves when the block's needed column
        bytes pass the stream threshold or its rows with the tier's working
        bytes pass the free memory of this thread's device (the rule of
        `_stream_plan`, over the block; a block splits at any row)."""
        work_row = row_bytes + self._tier_row_bytes(node, m)
        free = free_device_bytes(self.device, m * work_row)
        by_memory = free is not None and m * work_row > free
        thr = self._stream_threshold()
        if thr < 0:
            if by_memory:
                raise DeviceMemoryExceeded(
                    f"a shard's {m} rows x {work_row} B need more than the {free} B "
                    f"free on {self.device}, and streaming is off")
            return [(0, m)]
        if by_memory:
            thr = min(thr, free * row_bytes // work_row)
        elif m * row_bytes <= thr:
            return [(0, m)]
        step = max(1, thr // 2 // row_bytes)
        waves = [(a, min(a + step, m)) for a in range(0, m, step)]
        self.last_stream = StreamPlan(thr, row_bytes, work_row, by_memory, [], len(waves))
        return waves

    def _try_sharded_compound(self, node: R.Compound, memo) -> Optional[B.Batch]:
        """Run an aggregate or join Compound as one leaf a shard over the
        probe Scan's row blocks, each on its shard's device, when it has the
        shape that shards: its first input a Scan with rows and no array
        column read from it; an aggregate decomposable
        (`partial_agg.decomposable`, the stream rule's); joins with an
        equality at each level and none FULL, whose build sides run once on
        the Database's device and are copied to every other distinct device
        (the reference keeps such tables replicated), with the probe kept
        first by the runtime reorder.  An aggregate leaf is `make_leaf_node`
        on the tier `_plan_compound` picks for its block, streamed in waves
        past the threshold or the device's memory (`_shard_waves`); the
        partials merge on the Database's device through `make_merge_node`.
        A join's projected rows are concatenated there in shard order.
        None: the Compound runs gathered."""
        from heavydb_tpu_torch.plan.optimizer import _reorder_joins

        scan = node.inputs[0]
        if not isinstance(scan, R.Scan) or scan.table.num_rows == 0:
            return None
        if (not decomposable(node)) if node.is_aggregate else not node.join_levels:
            return None
        offsets = _input_offsets(node)
        for li, (kind, cond) in enumerate(node.join_levels):
            lo = offsets[li + 1]
            if kind == "FULL" or (cond is not None and not _split_join_condition(
                    cond, lo, lo + node.inputs[li + 1].arity)[0]):
                return None  # build rows unmatched on every shard; a spatial join
        t = scan.table
        needed = _input_fields(node, offsets)[0]
        if any(_scan_field_type(t, f).is_array for f in needed):
            return None
        builds = []
        if node.join_levels:
            per_input = _input_fields(node, offsets)
            builds = [self._exec_input(node, i, memo, per_input[i], offsets)
                      for i in range(1, len(node.inputs))]
            _reorder_joins(node, sizes=[t.num_rows] + [b.nrows for b in builds])
            order = node.__dict__.pop("_reordered", None)
            if order:
                if order[0] != 0:
                    return None  # another input probes: gathered
                builds = [builds[i - 1] for i in order[1:]]
                offsets = _input_offsets(node)
            self._static_watchdog(node, t.num_rows)
        leaf, wave_aggs, fin = make_leaf_node(node) if node.is_aggregate else (node, None, None)
        blocks = self._blocks_to_run(scan, node.filter_cond)
        row_bytes = max(sum(_scan_field_type(t, f).np_dtype().itemsize for f in needed), 1)
        m = max(b.hi - b.lo for b in blocks)
        full = self._resident_rows(scan, needed, row_bytes,
                                   m * self._tier_row_bytes(leaf, m) if node.is_aggregate else 0)
        replicas = {d: builds if d == self._home else [_batch_to(b, d) for b in builds]
                    for d in {b.device for b in blocks}}

        def leaf_runs(lo, hi):
            waves = [(0, hi - lo)] if node.join_levels else \
                self._shard_waves(leaf, hi - lo, row_bytes)
            outs = []
            for a, b in waves:
                self._checkpoint()
                batches = [self._block_rows(scan, needed, (lo, hi), lo + a, lo + b, full)] \
                    + replicas[self.device]
                plan = self._plan_compound(leaf, batches, offsets)
                outs.append((self._run_compound(leaf, batches, plan), _tier_of(plan)))
                if len(waves) > 1:
                    self.waves_run += 1
            return outs

        runs = [r for rs in self._on_shards(blocks, leaf_runs) for r in rs]
        tiers = [tier for _, tier in runs]
        parts = [_batch_to(out, self._home, live=True) for out, _ in runs]
        del runs  # the merge frees the partials once they are concatenated
        merge_tier = None
        if node.is_aggregate:
            out, merge_tier = self._merge_partials(node, leaf, wave_aggs, fin, parts)
        else:
            out = B.concat_batches(parts)
            out.types = list(node.types)
            parts.clear()
        self.shard_runs.append(ShardRun(
            f"Compound#{node.id}", "join" if node.join_levels else "aggregate", "sharded",
            tiers, merge_tier, len(blocks), len(tiers)))
        return out

    def _merge_partials(self, node, leaf, wave_aggs, fin, parts):
        """The leaves' partial rows, on the Database's device, merged by
        `make_merge_node` (the waves' path) over a partial-rows source that
        carries the group keys' ranges, so that the merge takes the tier
        their slots give.  `parts` is emptied once concatenated, so that the
        partials are freed before the merge runs.  Returns the result and
        the merge's tier."""
        cat = B.concat_batches(parts)
        parts.clear()
        td = R.TableData(leaf.fields, [wt.type for wt in leaf.target_exprs], [],
                         [getattr(wt, "dict_ref", None) for wt in leaf.target_exprs])
        td.field_ranges = _group_ranges(node)
        merge = make_merge_node(node, wave_aggs, fin, td)
        self._check_merge_memory(merge, cat.nrows, td.types)
        batches, plan = self._prepare_compound(merge, {td.id: cat})
        return self._run_compound(merge, batches, plan), _tier_of(plan)

    def _try_sharded_topk(self, node: R.Sort, child, k_total: int, topk: bool,
                          specs) -> Optional[B.Batch]:
        """ORDER BY ... LIMIT k over a Scan, or a non-aggregate Compound on
        one Scan, shard by shard: each shard keeps its k best rows (the
        top-k select when `topk`, else the stable full sort's first k), in
        waves past the stream threshold as `_try_stream_topk` runs them;
        those rows meet on the Database's device in shard order, and one
        last select takes the global k with the reference's tie order (the
        row order).  None when the child has another shape."""
        src = _topk_source(child)
        if src is None or src[0].table.num_rows == 0:
            return None
        scan, compound, needed, row_bytes = src
        t = scan.table
        if compound is not None:
            self._static_watchdog(compound, t.num_rows)
        cfg = self.config
        blocks = self._blocks_to_run(scan, compound.filter_cond if compound else None)
        full = self._resident_rows(scan, needed, row_bytes, 0)
        thr = self._stream_threshold()

        def best(batch, final):
            if topk:
                return self._exec_topk(node, batch, k_total, apply_offset=final, specs=specs)
            if final:
                return self._sorted_rows(node, child, batch, node.offset or 0, node.limit)
            return self._sorted_rows(node, child, batch, 0, k_total)

        def shard_best(lo, hi):
            step = hi - lo
            if thr >= 0 and (hi - lo) * row_bytes > thr:
                step = max(1, min(thr // 2 // row_bytes, cfg.topk_stream_row_cap))
            waves = [(a, min(a + step, hi)) for a in range(lo, hi, step)]
            winners = []
            for a, b in waves:
                self._checkpoint()
                batch = self._block_rows(scan, needed, (lo, hi), a, b, full)
                if compound is not None:
                    batch = self._run_compound(compound, [batch],
                                               self._plan_compound(compound, [batch]))
                if len(waves) > 1:
                    self.waves_run += 1
                if batch.nrows:
                    winners.append(best(batch, False))
            return len(waves), winners

        results = self._on_shards(blocks, shard_best)
        winners = [_batch_to(w, self._home, live=True) for _, ws in results for w in ws]
        self.shard_runs.append(ShardRun(
            f"Sort#{node.id}", "topk", "sharded", ["select" if topk else "sort"] * len(winners),
            "select" if topk else "sort", len(blocks), sum(n for n, _ in results)))
        if not winners:
            return B.from_host_columns([np.empty(0, ti.np_dtype()) for ti in node.types],
                                       0, node.types, self.device)
        cat = B.concat_batches(winners)
        cat.types = list(node.types)
        return best(cat, True)

    def _tier_row_bytes(self, node: R.Compound, nrows: Optional[int] = None) -> int:
        """Device bytes a row of the Compound's group-by holds beside its
        scanned columns, on the tier `_plan_compound` would pick for nrows
        input rows (`_group_tier`), from the SQL types (s: the aggregates'
        streams, a bool contribution mask and the value each, as
        exec/radix_tier.py `row_bytes` counts them):
          keyless  1 + s        the row mask
          perfect  5 + s        the row mask and the int32 slot id
          hash     71 + s       the row mask and the int32 slot id (5), the
                                packed key and its hash's base (16), the
                                unresolved and aggregate masks (2), one
                                claim round's slot, claim and gathered
                                claim (24), the rounds x cap claim tables
                                (8: cap <= rows / 4), the unpacked keys and
                                presence counts of the rounds x cap slots
                                (16)
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
        tier = self._group_tier(node, nrows)[0]
        if tier == "keyless":
            return 1 + s
        if tier == "perfect":
            return 5 + s
        if tier == "hash":
            return 71 + s
        if tier == "radix":
            return 20 + 2 * s + r
        k = 1 + sum(np.dtype(g.type.np_dtype()).itemsize + g.type.nullable
                    for g in node.group_exprs)
        A = E.AggKind
        a = sum(1 if ag.kind in (A.COUNT, A.COUNT_IF)
                else 3 if ag.kind in (A.STDDEV, A.VARIANCE) else 2 for ag in node.aggs)
        return 58 + k + 2 * s + 16 * a

    def _group_tier(self, node: R.Compound, nrows: Optional[int] = None):
        """(tier, ranges, slots) of an aggregate Compound's group-by over
        nrows input rows (None: a Scan input's table rows), known before
        its scan: keyless; perfect or radix or sort when every key has a
        dense range within baseline_groupby_threshold slots (slots their
        product); else hash where `_hash_ndv` takes it (slots its NDV
        estimate), or sort (slots None)."""
        cfg = self.config
        if not node.group_exprs:
            return "keyless", [], 1
        ranges = _group_ranges(node)
        slots = 1
        for r in ranges:
            if r is None or r.extent <= 0 or r.extent > cfg.baseline_groupby_threshold \
                    or slots * (r.extent + (1 if r.has_nulls else 0)) \
                    > cfg.baseline_groupby_threshold:
                if nrows is None and len(node.inputs) == 1 \
                        and isinstance(node.inputs[0], R.Scan):
                    nrows = node.inputs[0].table.num_rows
                ndv = self._hash_ndv(node, ranges, nrows) if nrows is not None else None
                return ("hash", ranges, ndv) if ndv else ("sort", ranges, None)
            slots *= r.extent + (1 if r.has_nulls else 0)
        if slots <= cfg.sortagg_min_slots:
            return "perfect", ranges, slots
        return ("radix" if RT.eligible(node, ranges, slots, cfg) else "sort"), ranges, slots

    def _prepare_compound(self, node: R.Compound, memo):
        """The Compound's input batches (needed columns only; a Scan's
        fragments skipped by the filter's chunk stats, each input with its
        own field offset), its inputs reordered by their sizes at run time
        when it joins, and its plan."""
        offsets = _input_offsets(node)
        per_input = _input_fields(node, offsets)
        batches = [self._exec_input(node, i, memo, per_input[i], offsets)
                   for i in range(len(node.inputs))]
        if len(node.inputs) > 1:
            # the runtime half of the reference's FromTableReordering: the
            # inputs' real (post-filter, where probed) sizes pick the probe
            from heavydb_tpu_torch.plan.optimizer import _reorder_joins

            sizes = [b.nrows for b in batches]
            if self.config.enable_selectivity_probe and node.filter_cond is not None \
                    and all(k == "INNER" and c is not None for k, c in node.join_levels):
                sizes = self._selectivity_sizes(node, batches, offsets, sizes)
            _reorder_joins(node, sizes=sizes)
            order = node.__dict__.pop("_reordered", None)
            if order:
                batches = [batches[i] for i in order]
                offsets = _input_offsets(node)
        return batches, self._plan_compound(node, batches, offsets)

    def _exec_input(self, node: R.Compound, i: int, memo, needed, offsets) -> B.Batch:
        """Input i of a Compound, its needed fields only; a Scan's fragments
        skipped by the filter's chunk stats."""
        inp = node.inputs[i]
        if isinstance(inp, R.Scan) and node.filter_cond is not None \
                and len(inp.table.fragments) > 1:
            frag_ids = self._surviving_fragments(inp, node.filter_cond, offsets[i])
            if frag_ids is not None:
                return self._exec_scan(inp, needed, frag_ids)
        return self._exec(inp, memo, needed)

    def _selectivity_sizes(self, node, batches, offsets, sizes):
        """Post-filter row count per join input: the rows of each input that
        pass its single-input WHERE conjuncts, counted on the device and
        cached per (input plan, conjuncts, table generations, rows) (the
        reference's selectivity probe, JoinFilterPushDown.cpp)."""
        from heavydb_tpu_torch.plan.optimizer import _split_conjuncts

        n_in = len(node.inputs)
        per_input: Dict[int, list] = {}
        for c in _split_conjuncts(node.filter_cond):
            owner = {input_of_field(offsets, r.field_idx)[0] for r in E.collect_input_refs(c)}
            if len(owner) == 1:
                per_input.setdefault(owner.pop(), []).append(c)
        out = list(sizes)
        if len(self._sel_cache) > 4096:
            self._sel_cache.clear()
        for bi, conjs in per_input.items():
            if n_in == 2 and sizes[bi] <= sizes[1 - bi]:
                # shrinking the smaller of two inputs cannot flip the
                # probe / build choice: no device round trip
                continue
            gens = tuple(sorted((s.table.table_id, s.table.generation)
                                for s in R.topo_order(node.inputs[bi])
                                if isinstance(s, R.Scan)))
            rkey = ("selprobe", node.inputs[bi].plan_key(),
                    tuple(sorted(c.key() for c in conjs)), gens, batches[bi].nrows)
            hit = self._sel_cache.get(rkey)
            if hit is None:
                hit = self._probe_count(batches[bi], offsets[bi], conjs)
                if hit is None:
                    continue
                self._sel_cache[rkey] = hit
            out[bi] = hit
        return out

    def _probe_count(self, batch, offset: int, conjs) -> Optional[int]:
        """Rows of `batch` passing every conjunct (each over this input's
        fields only), with the dictionary-string tables they read; None for
        a conjunct it cannot count here."""
        for c in conjs:
            if any(isinstance(s, (E.SubqueryExpr, E.Agg, E.WindowFunc))
                   for s in E.walk(c)):
                return None
        specs = _expr_aux_specs(conjs)
        fields = sorted({r.field_idx for c in conjs for r in E.collect_input_refs(c)})
        cdict = {}
        for f in fields:
            local = f - offset
            if not 0 <= local < len(batch.cols) or batch.cols[local] is None:
                return None
            v, ti = batch.cols[local], batch.types[local]
            cdict[f] = (v, derive_valid(v, ti) if ti.nullable else None)
        comp = ExprCompiler(cdict, self._aux_tables(specs, list(specs)), None,
                            self.device, batch.padded, getattr(self.db, "_udfs", {}))
        m = self._in_domain(batch.padded, batch.nrows)
        try:
            for c in conjs:
                m = m & comp.compile_predicate(c)
        except NotSupported:
            return None  # the probe is advisory: keep the raw row count
        return int(m.sum())

    def _surviving_fragments(self, scan: R.Scan, filter_cond, offset: int = 0):
        """Fragments whose chunk min/max can satisfy every simple
        `col <cmp> const` conjunct over this scan (its fields start at
        `offset` of the filter's input domain); None when all survive."""
        from heavydb_tpu_torch.plan.optimizer import _split_conjuncts

        t = scan.table
        quals = [q for q in (self._simple_qual(c, scan, offset)
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

    def _simple_qual(self, c, scan: R.Scan, offset: int = 0):
        """col <cmp> const over this scan's columns -> (col_id, op, value);
        a dictionary string `col = 'lit'` compares the literal's id."""
        flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
        if isinstance(c, E.DictStrPredicate) and c.kind == "CMP" \
                and c.cmp_op == "=" and not c.negated \
                and isinstance(c.arg, E.InputRef):
            local = c.arg.field_idx - offset
            if 0 <= local < len(scan.table.columns) and c.dict_ref is not None:
                cd = scan.table.columns[local]
                if (scan.table.table_id, cd.col_id) == c.dict_ref:
                    return (cd.col_id, "=", self.db.dict_by_ref(c.dict_ref).get_id(c.pattern))
            return None
        if not isinstance(c, E.BinOp) or c.op not in E.COMPARISON_OPS \
                or c.op == E.BinOpKind.NE:
            return None
        lhs, rhs, op = c.left, c.right, c.op.value
        if isinstance(rhs, E.InputRef) and isinstance(lhs, E.Constant):
            lhs, rhs, op = rhs, lhs, flip.get(op, op)
        if not (isinstance(lhs, E.InputRef) and isinstance(rhs, E.Constant)) \
                or rhs.value is None:
            return None
        local = lhs.field_idx - offset
        if not 0 <= local < len(scan.table.columns):
            return None
        cd = scan.table.columns[local]
        if not (cd.type.is_integer or cd.type.is_time or cd.type.is_decimal
                or cd.type.is_boolean):
            return None
        try:
            return (cd.col_id, op, int(rhs.value))
        except (TypeError, ValueError):
            return None

    # ---- compound planning ----
    def _plan_compound(self, node: R.Compound, batches, offsets=(0,)):
        cfg = self.config
        plan = _CompoundPlan(offsets=list(offsets),
                             distinct_force_sort=not cfg.enable_hash_groupby,
                             udfs=getattr(self.db, "_udfs", {}))
        probe = batches[0]
        self._static_watchdog(node, probe.nrows)
        if node.filter_cond is not None and node.join_levels \
                and not any(k == "FULL" for k, _ in node.join_levels):
            self._split_filter(node, offsets, plan)
        for li, (kind, cond) in enumerate(node.join_levels):
            bi = li + 1
            lo = offsets[bi]
            equis, residual = _split_join_condition(cond, lo, lo + node.inputs[bi].arity)
            build_rows = batches[bi].nrows
            if kind == "CROSS" and cond is None:
                if build_rows * max(probe.nrows, 1) > cfg.watchdog_max_projected_rows:
                    raise WatchdogException("cross join too large")
                plan.joins.append(_JoinPlan(kind="CROSS", residual=None))
                plan.caps.append(B.bucket(max(probe.nrows * max(build_rows, 1), 1)))
                continue
            if not equis:
                # spatial predicates: the grid-bucket candidate join (the
                # reference's BoundingBoxIntersectJoinHashTable); the geo
                # conjunct stays in the residual as the exact test
                gj = GEO.plan_geo_join(residual, lo, lo + node.inputs[bi].arity)
                if gj is None or kind != "INNER":
                    raise NotSupported("non-equi join conditions require ≥1 equality")
                probe_keys, build_keys, spec, extra_aux = gj
                for k_, s_ in extra_aux:
                    plan.aux_specs.setdefault(k_, s_)
                jp = _JoinPlan(kind="INNER", probe_keys=probe_keys, build_keys=build_keys,
                               residual=residual, pack="geo", geo=spec)
                plan.joins.append(jp)
                jp.fallback_cap = B.bucket(max(probe.nrows, build_rows, 1) * 4)
                plan.caps.append(jp.fallback_cap)
                continue
            if kind == "FULL" and residual:
                # build-side matched flags do not see residual kills
                raise NotSupported("FULL JOIN with non-equi residual conditions")
            jp = self._plan_join_keys(node, equis, residual, kind, batches, bi)
            if jp.key_min is not None and kind in ("INNER", "LEFT") \
                    and not jp.residual and jp.key_range >= build_rows:
                # PK side, by the reference's rule: a dense range at least
                # as wide as the row count; a duplicate key found in the
                # run expands the level in the same run
                jp.unique_build = True
            plan.joins.append(jp)
            jp.fallback_cap = B.bucket(max(probe.nrows, build_rows, 1))
            plan.caps.append(0 if jp.unique_build else jp.fallback_cap)
            if jp.translate is not None:
                plan.aux_specs.setdefault(jp.translate, ("translate", jp.translate))
        if node.is_aggregate and node.group_exprs:
            tier, ranges, slots = self._group_tier(node, batches[0].nrows)
            padded = max(batches[0].padded, 8)
            if tier == "hash":
                # the hash tier, where the reference takes it: a claim
                # table of 4 x NDV (slots) a round, at most a quarter of
                # the rows, clamped to [4096, 2^21]
                plan.group_strategy = ("hash", _hash_pack_spec(node.group_exprs, ranges))
                cap = min(batches[0].padded // 4, 4 * slots)
                plan.group_cap = B.bucket(min(max(cap, 4096), 1 << 21))
            elif slots is not None:
                spec = tuple((r.lo, r.extent, r.has_nulls, r.bucket) for r in ranges)
                if tier == "perfect":
                    plan.group_strategy = ("perfect", spec)
                    plan.group_cap = slots
                else:
                    # huge dense key spaces: the radix tier when the
                    # aggregates fit its stream budget, else the sort
                    # tier; neither allocates [slots]-sized buffers
                    plan.group_strategy = ("radix", spec) if tier == "radix" else ("sort", None)
                    plan.group_cap = B.bucket(min(slots, padded))
            else:
                plan.group_strategy = ("sort", None)
                plan.group_cap = B.bucket(
                    min(cfg.baseline_groupby_initial_entries, padded))
        elif node.is_aggregate:
            plan.group_strategy = ("keyless", None)
            plan.group_cap = 1
        plan.aux_specs.update(_expr_aux_specs(_iter_node_exprs(node)))
        return plan

    def _static_watchdog(self, node: R.Compound, nrows: int) -> None:
        """The static watchdog (the reference's pre-execution check): a
        projection over more rows than the limit is refused."""
        cfg = self.config
        hints = self.exec_hints
        watchdog = (cfg.enable_watchdog or hints.get("watchdog")) \
            and not hints.get("no_watchdog")
        if watchdog and not node.is_aggregate \
                and nrows > cfg.watchdog_max_projected_rows:
            raise WatchdogException(
                f"projection over {nrows:,} rows exceeds the watchdog "
                f"limit ({cfg.watchdog_max_projected_rows:,})")

    def _split_filter(self, node: R.Compound, offsets, plan) -> None:
        """Filter push-down into the join pipeline (the reference's
        FILTER_PROJECT_TRANSPOSE rules and JoinFilterPushDown): a WHERE
        conjunct over one input moves to the probe mask before any
        expansion (input 0) or into the build-side validity of an INNER
        level; the rest stay after the joins.  DIV / MOD conjuncts stay put,
        so that their error flags never fire for rows a join would drop."""
        from heavydb_tpu_torch.plan.optimizer import _split_conjuncts

        rest = []
        for c in _split_conjuncts(node.filter_cond):
            refs = E.collect_input_refs(c)
            pushable = bool(refs) and not any(
                isinstance(s, E.BinOp) and s.op in (E.BinOpKind.DIV, E.BinOpKind.MOD)
                for s in E.walk(c))
            owner = {input_of_field(offsets, r.field_idx)[0] for r in refs}
            if pushable and owner == {0}:
                plan.pre_mask.append(c)
            elif pushable and len(owner) == 1 \
                    and node.join_levels[next(iter(owner)) - 1][0] == "INNER":
                plan.build_filters.setdefault(next(iter(owner)), []).append(c)
            else:
                rest.append(c)
        plan.filter_rest = rest

    def _plan_join_keys(self, node, equis, residual, kind, batches, build_input):
        """Key packing of a level's (possibly multi-column) equi keys:
        `single` (a perfect build when the build key has a dense range of
        modest width), `range` (an exact packing of ranged keys) or `hash`
        (splitmix64, with an equality recheck appended to the residual)."""
        probe_exprs = [p for p, _ in equis]
        build_exprs = [b for _, b in equis]
        if len(equis) == 1:
            pe, be = probe_exprs[0], build_exprs[0]
            translate = None
            if pe.type.is_dict_string or be.type.is_dict_string:
                pref = getattr(pe, "dict_ref", None)
                bref = getattr(be, "dict_ref", None)
                if pref is None or bref is None:
                    raise NotSupported("join on computed string keys")
                if pref != bref:
                    translate = (bref, pref)
            if pe.type.is_fp or be.type.is_fp:
                raise NotSupported("float join keys")
            key_min = key_range = None
            if translate is None:
                br = RNG.expr_range(be, node.inputs)
                # JB.MAX_RANGE: the widest range whose int32 slots the
                # build's kernel J1 writes
                if br is not None and 0 < br.extent <= min(
                        self.config.perfect_join_max_range, JB.MAX_RANGE,
                        max(batches[build_input].padded * 4, 1 << 16)):
                    key_min, key_range = br.lo, br.extent
            return _JoinPlan(kind=kind, probe_keys=probe_exprs, build_keys=build_exprs,
                             residual=residual, translate=translate, pack="single",
                             key_min=key_min, key_range=key_range)
        # multi-key: dictionary ids compare only within one dictionary
        for pe, be in equis:
            if pe.type.is_dict_string or be.type.is_dict_string:
                pref = getattr(pe, "dict_ref", None)
                bref = getattr(be, "dict_ref", None)
                if pref is None or bref is None or pref != bref:
                    raise NotSupported(
                        "multi-column join with cross-dictionary string keys")
        spans = []
        for be, pe in zip(build_exprs, probe_exprs):
            rb = RNG.expr_range(be, node.inputs)
            rp = RNG.expr_range(pe, node.inputs)
            if rb is None or rp is None:
                spans = None
                break
            lo, hi = min(rb.lo, rp.lo), max(rb.hi, rp.hi)
            spans.append((lo, hi - lo + 1))
        if spans is not None and math.prod(ext for _, ext in spans) <= (1 << 62):
            return _JoinPlan(kind=kind, probe_keys=probe_exprs, build_keys=build_exprs,
                             residual=residual, pack="range", pack_spans=tuple(spans))
        if kind in ("LEFT", "FULL"):
            raise NotSupported(f"{kind} JOIN with unpackable multi-column keys")
        recheck = [E.BinOp(E.BinOpKind.EQ, p, b, T.boolean(True)) for p, b in equis]
        return _JoinPlan(kind=kind, probe_keys=probe_exprs, build_keys=build_exprs,
                         residual=list(residual) + recheck, pack="hash")

    def _hash_ndv(self, node, ranges, nrows: int) -> Optional[int]:
        """The estimated NDV of the group keys where the reference's rule
        takes the hash tier, else None: the hash group-by enabled, keys
        that pack (`_hash_pack_spec`), a known NDV, at most 32 rows a key
        (the claims' collision depth) and at most 2^19 keys (the claim
        table's size)."""
        if not self.config.enable_hash_groupby \
                or _hash_pack_spec(node.group_exprs, ranges) is _NO_PACK:
            return None
        ndv = self._estimate_group_ndv(node)
        if ndv is None or max(nrows, 1) // max(ndv, 1) > 32 or ndv > (1 << 19):
            return None
        return ndv

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
        key = (t.table_id, t.generation, tuple(idxs))
        if key not in self._ndv_cache:
            self._ndv_cache[key] = self._sample_ndv(t, idxs)
        return self._ndv_cache[key]

    @staticmethod
    def _sample_ndv(t, idxs) -> Optional[int]:
        """`_estimate_group_ndv` over the key fields idxs of table t."""
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
    @staticmethod
    def _kernel_key(node, batches, plan) -> tuple:
        """The kernel cache's key of a Compound's program: its plan's
        structure, the inputs' padded rows and dtypes, and the plan's
        capacities, tier, join forms and aux tables."""
        shapes = tuple(
            (b.padded,) + tuple(
                (i, str(c.dtype)) for i, c in enumerate(b.cols) if c is not None)
            for b in batches)
        return (node.plan_key(), shapes, tuple(plan.caps), plan.group_strategy,
                plan.group_cap, plan.distinct_force_sort,
                tuple((jp.kind, jp.pack, jp.pack_spans, jp.key_min, jp.key_range,
                       jp.translate, jp.unique_build, jp.hash_fallback, jp.geo)
                      for jp in plan.joins),
                tuple(sorted(plan.aux_specs, key=repr)))

    def program_text(self, root: R.RelNode) -> Optional[str]:
        """The root Compound's program as the port runs it (EXPLAIN
        OPTIMIZED): its group-by tier and capacity, each aggregate's route
        (B1, B2, B3, B5 + B6, or plain torch), each join level's build form
        and capacity, and its kernel-cache key; None for a plan with no
        Compound.  Subqueries run first, as in `execute`, and the Compound's
        inputs are scanned (columns may upload), but nothing of the
        Compound itself runs."""
        compounds = [n for n in R.topo_order(root) if isinstance(n, R.Compound)]
        if not compounds:
            return None
        node = compounds[-1]
        self._substitute_subqueries(root, set())
        batches, plan = self._prepare_compound(node, {})
        self._get_kernel(node, batches, plan)
        tier = plan.group_strategy[0] if plan.group_strategy else "projection"
        slots = {"keyless": 1, "perfect": plan.group_cap,
                 "hash": 4 * plan.group_cap}.get(tier)
        lines = [f"--- compound program: Compound#{node.id} ---",
                 f"group-by tier: {tier}, cap {plan.group_cap}"]
        if tier in ("perfect", "hash") and 1 < slots <= G.SHARED_SCAN_MAX_SLOTS:
            lines.append(f"presence counts: {AGG.pass_kernel(slots)} (the shared pass "
                         f"over {slots} slots)")
        for i, agg in enumerate(node.aggs):
            lines.append(f"aggregate {i} {agg.kind.name}: {AGG.route(agg, tier, slots)}")
        for li, (jp, cap) in enumerate(zip(plan.joins, plan.caps)):
            lines.append(f"join level {li + 1}: {jp.kind} "
                         f"{_build_form(jp, batches[li + 1].padded)}, cap {cap}")
        lines.append(f"kernel-cache key: {self._kernel_key(node, batches, plan)!r}")
        return "\n".join(lines)

    def forget_table(self, table_id: int) -> None:
        """Drop every kernel and aux table whose key names the table: its
        Scan, or one of its columns as a dictionary reference (table_id,
        col_id[, step]).  An aux table is keyed by its dictionary's reference
        and size, so after a column's type, name or dictionary changes, or
        the table goes, a stale one could otherwise be served."""
        for cache in (self.kernel_cache, self.aux_cache):
            for key in [k for k in cache if _names_table(k, table_id)]:
                del cache[key]

    def _get_kernel(self, node, batches, plan):
        key = self._kernel_key(node, batches, plan)
        if self.device != self._home:
            key += (str(self.device),)  # a shard's program on its own device
        hit = self.kernel_cache.get(key)
        if hit is None:
            with self.timer.scope("kernel_build"):
                hit = build_compound_kernel(node, batches, plan, self.device)
            self.kernel_cache[key] = hit
            self.kernel_builds += 1
        return hit

    def _kernel_args(self, batches, plan, layout):
        args = []
        for bi, cols in layout.batch_cols:
            for ci in cols:
                args.append(batches[bi].cols[ci])
        for bi in layout.nrows_batches:
            args.append(int(batches[bi].nrows))
        aux = self._aux_tables(plan.aux_specs, layout.aux_order)
        args.extend(aux[k] for k in layout.aux_order)
        return args

    # ---- aux tables ----
    def _aux_tables(self, specs, order) -> dict:
        """The device table of each aux key in `order`.  Pair concats, then
        transforms, are built first: they fill the transient dictionaries
        that the other tables over their outputs read."""
        out = {}
        for stage in ("pairconcat", "strtransform"):
            for k in order:
                if specs[k][0] == stage:
                    out[k] = self._aux_array(specs[k])
        for k in order:
            if k not in out:
                out[k] = self._aux_array(specs[k])
        return out

    def _aux_array(self, spec):
        """Device tables a kernel reads beside its columns, built on the
        host over dictionary entries and copied to the device once per cache
        key (each key carries the sizes of the dictionaries it reads):
          strpred       a bool match table a dictionary id (LIKE, ILIKE,
                        REGEXP, CMP, IN), or its value (LENGTH, INTFN,
                        TRYCAST; the type's null sentinel or NaN where NULL)
          strtransform  id -> id of the transformed string in the
                        transform's transient dictionary (INT32_MIN: NULL)
          pairconcat    (left id, right id) -> id of the concatenation in
                        its transient dictionary
          pairrank      (left, right): id -> rank in the sorted union of
                        both sides' (transformed) entries
          dictrank      id -> lexicographic rank; dictorder: rank -> id
          translate     a join key's build dictionary id -> probe
                        dictionary id (-1 for a string the probe lacks)
          array         an ArrayFn's tables over its column's payload rows
                        (`_array_aux`), by table generation
          geobbox       a geo column's bounding-box corners and grid cell
                        (`_geobbox_aux`), by table generation"""
        kind, payload = spec
        build = {"strpred": self._strpred_table,
                 "strtransform": self._transform_table,
                 "pairconcat": self._pair_concat_table,
                 "pairrank": self._pair_rank_tables,
                 "dictrank": self._dict_rank_table,
                 "dictorder": self._dict_order_table,
                 "translate": self._translate_table,
                 "array": self._array_aux,
                 "geobbox": self._geobbox_aux}.get(kind)
        if build is None:
            raise NotSupported(f"aux {kind}")
        return build(payload)

    def _cached(self, key, make):
        """aux_cache[key], made on the host by make() and copied to the
        device (a tuple of tables copies each table and keeps any other
        item as it is) on a miss.  A shard's device keeps its own copy."""
        if self.device != self._home:
            key += (str(self.device),)
        hit = self.aux_cache.get(key)
        if hit is None:
            with self._aux_lock:
                hit = self.aux_cache.get(key)
                if hit is None:
                    with self.timer.scope("aux_build"):
                        host = make()
                        if isinstance(host, tuple):
                            hit = tuple(self._to_device(h) if isinstance(h, np.ndarray)
                                        else h for h in host)
                        else:
                            hit = self._to_device(host)
                    self.aux_cache[key] = hit
        return hit

    def _strpred_table(self, pred: E.DictStrPredicate):
        d = self.db.dict_by_ref(pred.dict_ref)
        return self._cached(("strpred", pred.dict_ref, d.size, pred.key()),
                            lambda: _strpred_host(pred, d))

    def _transform_table(self, tr: E.StringTransform):
        from heavydb_tpu_torch.storage.string_ops import apply_chain

        src = self.db.dict_by_ref(tr.src_dict_ref)
        dst = self.db.dict_by_ref(tr.dict_ref)

        def make():
            entries = src.entries()
            ids = dst.get_or_add_bulk([apply_chain(s, tr.ops) for s in entries])
            host = np.full(B.bucket(max(len(entries), 1)), _I32_MIN, np.int32)
            host[:len(ids)] = ids
            return host

        return self._cached(("strtransform", tr.src_dict_ref, src.size, tr.ops,
                             tr.dict_ref), make)

    def _pair_concat_table(self, e: E.StringPairConcat):
        from heavydb_tpu_torch.storage.string_ops import apply_chain

        # a side that is itself a pair concat reads that pair's output
        # dictionary: fill it first
        for side in (e.left, e.right):
            if isinstance(side, E.StringPairConcat):
                self._pair_concat_table(side)
        ld = self.db.dict_by_ref(e.left_ref)
        rd = self.db.dict_by_ref(e.right_ref)
        cap = self.config.pair_concat_max_entries
        if ld.size * rd.size > cap:
            raise NotSupported(
                f"|| between dictionary columns with {ld.size}x{rd.size} entries "
                f"(dense pairwise translation table cap {cap})")

        def make():
            les = [apply_chain(s, e.left_ops) for s in ld.entries()]
            res = [apply_chain(s, e.right_ops) for s in rd.entries()]
            host = np.full((B.bucket(max(len(les), 1)), B.bucket(max(len(res), 1))),
                           _I32_MIN, np.int32)
            strs, pos = [], []
            for i, a in enumerate(les):
                if a is None:
                    continue
                for j, b in enumerate(res):
                    if b is not None:
                        strs.append(a + b)
                        pos.append(i * len(res) + j)
            if strs:
                flat = np.full(len(les) * len(res), _I32_MIN, np.int32)
                flat[np.asarray(pos)] = self.db.dict_by_ref(e.dict_ref).get_or_add_bulk(strs)
                host[:len(les), :len(res)] = flat.reshape(len(les), len(res))
            return host

        return self._cached(("pairconcat", e.left_ref, ld.size, e.left_ops, e.right_ref,
                             rd.size, e.right_ops, e.dict_ref), make)

    def _pair_rank_tables(self, e: E.DictPairCompare):
        from heavydb_tpu_torch.storage.string_ops import apply_chain

        ld = self.db.dict_by_ref(e.left_ref)
        rd = self.db.dict_by_ref(e.right_ref)

        def make():
            les = [apply_chain(s, e.left_ops) for s in ld.entries()]
            res = [apply_chain(s, e.right_ops) for s in rd.entries()]
            rank_of = {s: i for i, s in enumerate(sorted(
                {s for s in les + res if s is not None}))}
            tables = []
            for side in (les, res):
                t = np.full(B.bucket(max(len(side), 1)), _I32_MIN, np.int32)
                for i, s in enumerate(side):
                    if s is not None:
                        t[i] = rank_of[s]
                tables.append(t)
            return tuple(tables)

        return self._cached(("pairrank", e.left_ref, ld.size, e.left_ops, e.right_ref,
                             rd.size, e.right_ops), make)

    def _dict_order_table(self, ref):
        d = self.db.dict_by_ref(ref)

        def make():
            host = np.zeros(B.bucket(max(d.size, 1)), np.int32)
            order = np.argsort(np.array(d.entries(), dtype=object))
            host[:len(order)] = order.astype(np.int32)
            return host

        return self._cached(("order", ref, d.size), make)

    def _translate_table(self, refs):
        from_ref, to_ref = refs
        fd = self.db.dict_by_ref(from_ref)
        td = self.db.dict_by_ref(to_ref)

        def make():
            host = np.full(B.bucket(max(fd.size, 1)), -1, np.int32)
            host[:fd.size] = fd.translation_to(td)
            return host

        return self._cached(("translate", from_ref, to_ref, fd.size, td.size), make)

    # ---- array and geo aux tables (the reference's `_array_aux`) ----
    def _geo_xform_rows(self, t, cid, arr_ref):
        """Column payload rows, with the dict_ref[2] geometry-transform
        chain applied (the GEOS runtime's role, ops/geo_construct.py)."""
        rows = t.column_values(cid)
        if len(arr_ref) > 2 and arr_ref[2]:
            from heavydb_tpu_torch.ops.geo_construct import apply_steps

            kind = t.column_by_id(cid).type.kind
            rows = apply_steps(
                rows, kind, arr_ref[2],
                lambda rt, rc: self.db.catalog.get_table_by_id(rt).column_values(rc))
        return rows

    def _geobbox_aux(self, arr_ref):
        """(xmin[n], ymin[n], [cell]) of a geo column for the grid join:
        each row's bounding-box min corner and the grid's cell size, the
        largest bounding-box extent, so that every box spans at most 2
        cells an axis (the reference's BoundingBoxIntersectJoinHashTable
        bucket sizing)."""
        tid, cid = arr_ref[:2]
        t = self.db.catalog.get_table_by_id(tid)
        key = ("geobbox", tid, t.generation, cid,
               arr_ref[2] if len(arr_ref) > 2 else None)
        return self._cached(key, lambda: self._geobbox_host(t, cid, arr_ref))

    def _geobbox_host(self, t, cid, arr_ref):
        from heavydb_tpu_torch.storage.table import geo_rings

        kind = t.column_by_id(cid).type.kind
        if len(arr_ref) > 2 and arr_ref[2]:
            from heavydb_tpu_torch.ops.geo_construct import result_kind

            kind = result_kind(kind, arr_ref[2])
        rows = self._geo_xform_rows(t, cid, arr_ref)
        n = len(rows)
        xmin = np.full(n, np.nan)
        ymin = np.full(n, np.nan)
        cell = 0.0
        for i, r in enumerate(rows):
            if r is None:
                continue
            xs, ys = [], []
            for c, _ in geo_rings(r, kind):
                if len(c) >= 2:
                    xs.append(c[0::2])
                    ys.append(c[1::2])
            if not xs:
                continue
            x = np.concatenate(xs)
            y = np.concatenate(ys)
            xmin[i], ymin[i] = x.min(), y.min()
            cell = max(cell, float(x.max() - x.min()), float(y.max() - y.min()))
        cell = max(cell, 1e-9)
        pad = B.bucket(max(n, 1))
        return (B.pad_to(xmin, pad, T.double(True)), B.pad_to(ymin, pad, T.double(True)),
                np.asarray([cell], np.float64))

    def _array_aux(self, afn):
        """The aux tables of an ArrayFn over a base-table array or geo
        column, built on the host over its payload rows, bit for bit as
        the reference builds them, and copied to the device once per
        (table generation, ArrayFn):
          CARDINALITY, SUBSCRIPT, UNNEST
                  (lengths[n] int32, -1 = a NULL array; offsets[n + 1]
                  int32; the flat elements, GEOINT32 points decoded)
          ANY, ALL, ARR_EQ, CONTAINS, CONTAINS_LITPOLY, INTERSECTS_LIT
                  (int8[n]: 1 true, 0 false, -1 NULL)
          AREA, PERIMETER, XMIN .. YMAX, CENTROID_X / _Y
                  (f64[n], NaN = NULL)
          NPOINTS, NRINGS
                  (int32[n], -1 = NULL)
          CONTAINS_SEG
                  (segment offsets[n + 1], segment counts[n], x1, y1, x2,
                  y2 of every ring segment in f64, the longest polygon's
                  segment count: the ray cast's trip count)
        The reference's ArrayIR.cpp codegenArrayAt and the kANY / kALL
        lowering of Analyzer::BinOper; GeoOps for the geo scalars."""
        tid, cid = afn.arr_ref[:2]
        t = self.db.catalog.get_table_by_id(tid)
        if afn.op in ("CARDINALITY", "SUBSCRIPT", "UNNEST"):
            # one payload table a column (and transform chain) serves every
            # such ArrayFn over it: ST_X and ST_Y, vals[1] and UNNEST(vals)
            key = ("array", tid, t.generation, cid, "payload", afn.arr_ref)
        else:
            key = ("array", tid, t.generation, cid, afn.op, afn.key())
        return self._cached(key, lambda: self._array_host(afn, t, cid))

    def _array_host(self, afn, t, cid):
        eti = afn.elem
        rows = self._geo_xform_rows(t, cid, afn.arr_ref)
        n = len(rows)
        lengths = np.array([-1 if r is None else len(r) for r in rows], np.int32)
        clamped = np.maximum(lengths, 0)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(clamped, out=offsets[1:])
        parts = [r for r in rows if r is not None and r.size]
        flat = np.concatenate(parts) if parts else np.empty(0, eti.np_dtype())
        cd_t = t.column_by_id(cid).type
        if cd_t.is_geo_compressed and flat.dtype.kind in "iu" \
                and cd_t.kind in (T.SQLTypeKind.GEO_POINT, T.SQLTypeKind.GEO_LINESTRING):
            # a headerless GEOINT32 payload: decoded for the flat-element
            # ops (SUBSCRIPT -> ST_X / ST_Y); ring payloads decode in
            # geo_rings
            from heavydb_tpu_torch.storage.table import geoint_decompress

            flat = geoint_decompress(flat, cd_t.kind)
        if flat.dtype.kind == "f":
            validf = ~np.isnan(flat)
        else:
            validf = flat != eti.null_sentinel()
        padn = B.bucket(max(n, 1))
        if afn.op in ("AREA", "PERIMETER", "CONTAINS", "CONTAINS_LITPOLY",
                      "NPOINTS", "INTERSECTS_LIT", "CONTAINS_SEG",
                      "XMIN", "XMAX", "YMIN", "YMAX",
                      "NRINGS", "CENTROID_X", "CENTROID_Y"):
            return self._geo_host(afn, t, rows)
        if afn.op == "ARR_EQ":
            # whole-array equality a row; TEXT[] columns hold ids of their
            # own dictionaries, compared as strings
            other_cid = afn.args[0].dict_ref[1]
            rows_b = t.column_values(other_cid)
            da = t.dicts.get(cid)
            db_ = t.dicts.get(other_cid)
            out = np.full(n, -1, np.int8)
            for i in range(n):
                ra, rb = rows[i], rows_b[i]
                if ra is None or rb is None:
                    continue
                if len(ra) != len(rb):
                    out[i] = 0
                    continue
                if da is not None and db_ is not None and da is not db_:
                    sa = [da.get_string(int(x)) if x >= 0 else None for x in ra]
                    sb = [db_.get_string(int(x)) if x >= 0 else None for x in rb]
                    out[i] = 1 if sa == sb else 0
                else:
                    out[i] = 1 if bool((np.asarray(ra) == np.asarray(rb)).all()) else 0
            return (B.pad_to(out, padn, T.tinyint(False)),)
        if afn.op in ("CARDINALITY", "SUBSCRIPT", "UNNEST"):
            return (B.pad_to(lengths, padn, T.integer(False)),
                    np.concatenate([offsets.astype(np.int32),
                                    np.full(B.bucket(n + 1) - (n + 1), offsets[-1],
                                            np.int32)]),
                    B.pad_to(flat, B.bucket(max(len(flat), 1)), eti))
        # ANY / ALL with a constant left-hand side
        lit = afn.args[0]
        litval = lit.value
        flat_rowid = np.repeat(np.arange(n), clamped)
        if litval is None:
            out = np.where(clamped == 0, np.int8(0 if afn.op == "ANY" else 1),
                           np.int8(-1)).astype(np.int8)
        else:
            if eti.is_dict_string:
                d = t.dict_for(cid)
                # compare_ids evaluates `entry <op> pattern`; the
                # quantified comparison is `lit <op> elem`: flip the op
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>"}
                match_ids = d.compare_ids(flip[afn.cmp_op], str(litval))
                table = np.zeros(max(d.size, 1) + 1, bool)
                table[match_ids] = True
                cmpf = table[np.where(validf, flat, d.size)]
            else:
                litv = litval / 10**lit.type.scale if lit.type.is_decimal else litval
                ops = {"=": np.equal, "<>": np.not_equal, "<": np.less,
                       "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
                vals = flat / 10**eti.scale if eti.is_decimal else flat
                with np.errstate(invalid="ignore"):
                    cmpf = ops[afn.cmp_op](litv, vals)

            def per_row(w):
                return np.bincount(flat_rowid, weights=w, minlength=n)[:n] if n \
                    else np.zeros(0)

            n_true = per_row(cmpf & validf)
            n_nullel = per_row(~validf)
            n_false = per_row(~cmpf & validf)
            if afn.op == "ANY":
                out = np.where(n_true > 0, 1, np.where(n_nullel > 0, -1, 0)).astype(np.int8)
            else:
                out = np.where(n_false > 0, 0, np.where(n_nullel > 0, -1, 1)).astype(np.int8)
            out = np.where(lengths < 0, np.int8(-1), out)
        return (B.pad_to(out, padn, T.tinyint(False)),)

    def _geo_host(self, afn, t, rows):
        """The geo scalars of `_array_aux`, a table row each, on the host
        (the reference's `_geo_aux`; ST_Contains is the even-odd ray cast
        of its point-in-polygon runtime function)."""
        from heavydb_tpu_torch.storage.table import geo_rings, wkt_to_coords

        n = len(rows)
        padn = B.bucket(max(n, 1))
        K = T.SQLTypeKind
        kind = afn.elem.kind

        def shoelace(c):
            x, y = c[0::2], c[1::2]
            return 0.5 * abs(
                np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
            )

        if afn.op in ("XMIN", "XMAX", "YMIN", "YMAX"):
            # bbox corner per geometry (reference ST_XMin/... —
            # ExtensionFunctionsGeo.hpp over the coord stream)
            out = np.full(n, np.nan)
            off = 0 if afn.op[0] == "X" else 1
            red = np.min if afn.op.endswith("MIN") else np.max
            for i, r in enumerate(rows):
                if r is None:
                    continue
                vals = [red(c[off::2]) for c, _ in geo_rings(r, kind)
                        if len(c) >= 2]
                if vals:
                    out[i] = red(vals)
            return (B.pad_to(out, padn, T.double(True)),)
        if afn.op == "AREA":
            out = np.full(n, np.nan)
            for i, r in enumerate(rows):
                if r is None:
                    continue
                a = 0.0
                for c, outer in geo_rings(r, kind):
                    if len(c) >= 6:
                        a += shoelace(c) if outer else -shoelace(c)
                out[i] = max(a, 0.0)
            return (B.pad_to(out, padn, T.double(True)),)
        if afn.op == "CONTAINS_SEG":
            # per-row segment CSR for the IN-KERNEL even-odd ray cast
            # (cross-table geo joins can't precompute per-row results —
            # candidate pairs are data-dependent).  Same ring filter as
            # point_in below: rings with ≥ 3 points, wrap edge included.
            seg_cnt = np.full(n, -1, np.int32)
            xs1, ys1, xs2, ys2 = [], [], [], []
            for i, r in enumerate(rows):
                if r is None:
                    continue
                cnt = 0
                for c, _ in geo_rings(r, kind):
                    if len(c) < 6:
                        continue
                    x, y = c[0::2], c[1::2]
                    xs1.append(x)
                    ys1.append(y)
                    xs2.append(np.roll(x, -1))
                    ys2.append(np.roll(y, -1))
                    cnt += len(x)
                seg_cnt[i] = cnt
            total = int(np.maximum(seg_cnt, 0).sum())
            seg_off = np.zeros(n + 1, np.int32)
            np.cumsum(np.maximum(seg_cnt, 0), out=seg_off[1:])
            maxseg = int(np.maximum(seg_cnt, 0).max()) if n else 0

            def flat_f64(parts):
                return (np.concatenate(parts) if parts
                        else np.empty(0, np.float64)).astype(np.float64)

            padt = B.bucket(max(total, 1))
            return (np.concatenate([seg_off, np.full(B.bucket(n + 1) - (n + 1), total,
                                                     np.int32)]),
                    B.pad_to(seg_cnt, padn, T.integer(False)),
                    B.pad_to(flat_f64(xs1), padt, T.double(False)),
                    B.pad_to(flat_f64(ys1), padt, T.double(False)),
                    B.pad_to(flat_f64(xs2), padt, T.double(False)),
                    B.pad_to(flat_f64(ys2), padt, T.double(False)),
                    maxseg)
        if afn.op == "PERIMETER":
            out = np.full(n, np.nan)
            closed = kind != K.GEO_LINESTRING
            for i, r in enumerate(rows):
                if r is None:
                    continue
                p = 0.0
                any_ring = False
                for c, _ in geo_rings(r, kind):
                    if len(c) < 4:
                        continue
                    any_ring = True
                    x, y = c[0::2], c[1::2]
                    if closed:
                        x = np.append(x, x[0])
                        y = np.append(y, y[0])
                    p += np.sqrt(np.diff(x) ** 2 + np.diff(y) ** 2).sum()
                if any_ring:
                    out[i] = p
            return (B.pad_to(out, padn, T.double(True)),)
        if afn.op == "NPOINTS":
            out = np.full(n, -1, np.int32)
            for i, r in enumerate(rows):
                if r is None:
                    continue
                out[i] = sum(
                    len(c) // 2 for c, _ in geo_rings(r, kind)
                )
            return (B.pad_to(out, padn, T.integer(False)),)
        if afn.op == "NRINGS":
            # reference ST_NRings: ring count incl. holes
            out = np.full(n, -1, np.int32)
            for i, r in enumerate(rows):
                if r is None:
                    continue
                out[i] = sum(1 for _c, _ in geo_rings(r, kind))
            return (B.pad_to(out, padn, T.integer(False)),)
        if afn.op in ("CENTROID_X", "CENTROID_Y"):
            # reference ST_Centroid: polygons area-weighted over rings
            # (holes subtract), linestrings vertex mean, points identity
            out = np.full(n, np.nan)
            off = 0 if afn.op.endswith("X") else 1
            poly = kind in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON)
            for i, r in enumerate(rows):
                if r is None:
                    continue
                if poly:
                    num = 0.0
                    den = 0.0
                    for c, outer in geo_rings(r, kind):
                        if len(c) < 6:
                            continue
                        x, y = c[0::2], c[1::2]
                        x2, y2 = np.roll(x, -1), np.roll(y, -1)
                        cross = x * y2 - x2 * y
                        a = cross.sum() / 2.0
                        coord = (x + x2) if off == 0 else (y + y2)
                        cm = (coord * cross).sum() / 6.0
                        sgn = 1.0 if outer else -1.0
                        num += sgn * abs(a) * (cm / a if a != 0 else 0.0)
                        den += sgn * abs(a)
                    if den != 0:
                        out[i] = num / den
                else:
                    vals = [c[off::2] for c, _ in geo_rings(r, kind)
                            if len(c) >= 2]
                    if vals:
                        allv = np.concatenate(vals)
                        out[i] = float(allv.mean())
            return (B.pad_to(out, padn, T.double(True)),)

        def point_in(px, py, rings):
            """Even-odd point-in-polygon across ALL rings (outer rings and
            holes alike — parity handles holes; reference point-in-poly
            runtime function semantics)."""
            crossings = 0
            for c, _ in rings:
                if len(c) < 6:
                    continue
                x, y = c[0::2], c[1::2]
                x2, y2 = np.roll(x, -1), np.roll(y, -1)
                cr = ((y > py) != (y2 > py)) & (
                    px < (x2 - x) * (py - y)
                    / np.where(y2 == y, 1e-300, y2 - y) + x
                )
                crossings += int(cr.sum())
            return crossings % 2 == 1

        def segs(rings, close=True):
            for c, _ in rings:
                if len(c) < 4:
                    continue
                x, y = c[0::2], c[1::2]
                x2 = np.roll(x, -1) if close else x[1:]
                y2 = np.roll(y, -1) if close else y[1:]
                if not close:
                    x, y = x[:-1], y[:-1]
                yield x, y, x2, y2

        def seg_intersect(a, b):
            """Any segment of ring-set a intersects any segment of b."""
            B_ = list(segs(b))
            for ax, ay, ax2, ay2 in segs(a):
                for bx, by, bx2, by2 in B_:
                    d1x, d1y = ax2 - ax, ay2 - ay
                    # orientation cross products, vectorized over a-segs
                    for j in range(len(bx)):
                        o1 = d1x * (by[j] - ay) - d1y * (bx[j] - ax)
                        o2 = d1x * (by2[j] - ay) - d1y * (bx2[j] - ax)
                        d2x, d2y = bx2[j] - bx[j], by2[j] - by[j]
                        o3 = d2x * (ay - by[j]) - d2y * (ax - bx[j])
                        o4 = d2x * (ay2 - by[j]) - d2y * (ax2 - bx[j])
                        hit = ((np.sign(o1) != np.sign(o2))
                               & (np.sign(o3) != np.sign(o4)))
                        if bool(hit.any()):
                            return True
            return False

        def geoms_intersect(ra, ka, rb, kb):
            """Exact-ish intersection: bbox prefilter, then segment
            crossing or containment either way."""
            poly_kinds = (K.GEO_POLYGON, K.GEO_MULTIPOLYGON)
            flat_a = np.concatenate([c for c, _ in ra]) if ra else np.empty(0)
            flat_b = np.concatenate([c for c, _ in rb]) if rb else np.empty(0)
            if flat_a.size < 2 or flat_b.size < 2:
                return False
            if (flat_a[0::2].min() > flat_b[0::2].max()
                    or flat_a[0::2].max() < flat_b[0::2].min()
                    or flat_a[1::2].min() > flat_b[1::2].max()
                    or flat_a[1::2].max() < flat_b[1::2].min()):
                return False
            if ka == K.GEO_POINT:
                if kb in poly_kinds:
                    return point_in(flat_a[0], flat_a[1], rb)
                if kb == K.GEO_POINT:
                    return bool(flat_a[0] == flat_b[0]
                                and flat_a[1] == flat_b[1])
            if kb == K.GEO_POINT:
                return geoms_intersect(rb, kb, ra, ka)
            if seg_intersect(ra, rb):
                return True
            if ka in poly_kinds and point_in(flat_b[0], flat_b[1], ra):
                return True
            if kb in poly_kinds and point_in(flat_a[0], flat_a[1], rb):
                return True
            return False

        out = np.full(n, -1, np.int8)
        if afn.op == "CONTAINS_LITPOLY":
            lit_rings = geo_rings(
                wkt_to_coords(afn.args[0].value, K.GEO_POLYGON),
                K.GEO_POLYGON,
            )
            for i, r in enumerate(rows):
                if r is None or len(r) < 2:
                    continue
                out[i] = 1 if point_in(r[0], r[1], lit_rings) else 0
        elif afn.op == "INTERSECTS_LIT":
            wkt = str(afn.args[0].value)
            tag = wkt.strip().split("(")[0].strip().upper()
            lk = {
                "POINT": K.GEO_POINT, "LINESTRING": K.GEO_LINESTRING,
                "POLYGON": K.GEO_POLYGON,
                "MULTIPOLYGON": K.GEO_MULTIPOLYGON,
            }[tag]
            lit_rings = geo_rings(wkt_to_coords(wkt, lk), lk)
            for i, r in enumerate(rows):
                if r is None:
                    continue
                out[i] = 1 if geoms_intersect(
                    geo_rings(r, kind), kind, lit_rings, lk
                ) else 0
        else:  # CONTAINS: per-row polygon, point column or literal point
            pt = afn.args[0]
            if isinstance(pt, E.Constant):
                c = wkt_to_coords(pt.value, K.GEO_POINT)
                pxs = np.full(n, c[0])
                pys = np.full(n, c[1])
                pok = np.ones(n, bool)
            else:
                prows = t.column_values(pt.dict_ref[1])
                pxs = np.full(n, np.nan)
                pys = np.full(n, np.nan)
                for i, pr in enumerate(prows):
                    if pr is not None and len(pr) >= 2:
                        pxs[i], pys[i] = pr[0], pr[1]
                pok = ~np.isnan(pxs)
            for i, r in enumerate(rows):
                if r is None or not pok[i]:
                    continue
                out[i] = 1 if point_in(
                    pxs[i], pys[i], geo_rings(r, kind)
                ) else 0
        return (B.pad_to(out, padn, T.tinyint(False)),)

    def _postprocess(self, node, plan, outs):
        """The Compound's Batch from its program's outputs, or the names
        of the retry ladder's rungs that changed the plan.  A unique-build
        level that the run expanded (`join_fallback_<li>`) is recorded in
        the plan as an expanding level at that capacity; the join_cap rung
        then holds it to its exact need like any other."""
        d = outs
        # keyless aggregate with no join and no error flags has a STATIC
        # output (1 row): no control read at all
        if not plan.joins and plan.group_strategy \
                and plan.group_strategy[0] == "keyless" \
                and not any(k.startswith("err_") for k in d):
            return B.Batch(list(d["cols"]), 1, list(node.types))
        # ALL control scalars in ONE device->host copy
        with self.timer.scope("control_read"):
            host = dict(zip(ctrl_keys(d), d["ctrl_vec"].tolist()))
        if host.get("err_count_distinct_overflow"):
            # a COUNT(DISTINCT) hash claim table ran out of rounds: run
            # again on the sorted form
            plan.distinct_force_sort = True
            return ["distinct_overflow"]
        if host.get("err_div_by_zero"):
            raise DivisionByZero("division by zero")
        # the join rungs: a build key that claimed no hash slot -> the
        # sorted build; an expansion past its cap -> the exact capacity
        rungs = []
        for li, jp in enumerate(plan.joins):
            fallback_cap = d.get(f"join_fallback_{li}")
            if fallback_cap:
                jp.unique_build = False
                plan.caps[li] = fallback_cap
            if host.get(f"join_hash_miss_{li}", 0) > 0:
                jp.hash_fallback = True
                rungs.append("join_hash_miss")
        if rungs:
            return rungs
        for li, jp in enumerate(plan.joins):
            needed = int(host[f"join_needed_{li}"])
            if needed > plan.caps[li]:
                if B.bucket(needed) > _MAX_JOIN_DOMAIN:
                    raise ExecutionError(
                        f"join level {li} needs {needed} rows, more than the "
                        f"{_MAX_JOIN_DOMAIN} its int32 row indices address")
                plan.caps[li] = B.bucket(needed)
                rungs.append("join_cap")
        strategy = plan.group_strategy[0] if plan.group_strategy else None
        if strategy == "hash":
            if int(host["hash_unresolved"]) > 0:
                # a key found no free slot in any claim round: a table four
                # times as large
                plan.group_cap *= 4
                rungs.append("hash_unresolved")
        elif strategy == "radix":
            ng = int(host["num_groups"])
            ovf = int(host["radix_overflow"])
            if ovf & 1:
                # a partition held more rows than the group kernel's tile:
                # the results are invalid; rerun on the sort tier
                plan.group_strategy = ("sort", None)
                plan.group_cap = B.bucket(max(ng, 8))
                rungs.append("radix_overflow")
            elif ovf & 2 or ng > plan.group_cap:
                # output cap exceeded; num_groups is exact: one retry
                plan.group_cap = B.bucket(ng)
                rungs.append("group_cap")
        if rungs:
            return rungs
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
class _JoinPlan:
    kind: str = "INNER"  # INNER | LEFT | FULL | SEMI | ANTI | CROSS
    probe_keys: list = None
    build_keys: list = None
    residual: list = None
    translate: Optional[tuple] = None  # (from_dict_ref, to_dict_ref)
    pack: str = "single"  # single | range | hash | geo
    pack_spans: tuple = ()
    # dense-range perfect build (reference PerfectJoinHashTable)
    key_min: Optional[int] = None
    key_range: Optional[int] = None
    # build keys believed unique (PK side): an identity-domain probe, no
    # expansion; checked in the run (a duplicate key expands the level into
    # fallback_cap over the same build)
    unique_build: bool = False
    fallback_cap: int = 0
    # a hash-table build left a key without a slot: probe sorted instead
    hash_fallback: bool = False
    # the grid-bucket spatial join (exec/geo_join.py GeoJoinSpec; pack "geo")
    geo: Optional[object] = None


@dataclasses.dataclass
class _CompoundPlan:
    offsets: list = dataclasses.field(default_factory=lambda: [0])
    joins: List[_JoinPlan] = dataclasses.field(default_factory=list)
    # expansion capacity per join level (0: identity domain)
    caps: List[int] = dataclasses.field(default_factory=list)
    # ("perfect" | "radix", ((min, extent, has_nulls, bucket), ...)) |
    # ("hash", pack spec of _hash_pack_spec) | ("sort", None) |
    # ("keyless", None)
    group_strategy: Optional[tuple] = None
    group_cap: int = 0
    aux_specs: dict = dataclasses.field(default_factory=dict)
    # the filter push-down split (filter_rest None: no split made)
    pre_mask: list = dataclasses.field(default_factory=list)
    build_filters: dict = dataclasses.field(default_factory=dict)
    filter_rest: Optional[list] = None
    # COUNT(DISTINCT) on its sorted form: unless the hash group-by is
    # enabled (the reference's rule), and after a claim table ran out
    distinct_force_sort: bool = False
    # the Database's scalar UDFs (the live registry, read at each call)
    udfs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class JoinRun:
    """A join Compound's run: each level's build form (`_build_form`),
    its final caps and the retries it took."""

    builds: List[str]
    caps: List[int]
    retries: int


@dataclasses.dataclass
class ShardRun:
    """How a Compound or a top-k Sort ran on a mesh: `mode` "sharded" (a
    leaf a shard, `kind` aggregate / join / topk) or "gathered" (`kind`
    compound, on the Database's device); `tiers` the group-by tier of each
    leaf run ("select" / "sort" for a top-k's shard rows; "waves" for a
    streamed gathered Compound), `merge_tier` the merge's, `shards` the
    shards that ran, `leaf_runs` the leaves run (waves included)."""

    node: str
    kind: str
    mode: str
    tiers: List[str]
    merge_tier: Optional[str] = None
    shards: int = 0
    leaf_runs: int = 0


@dataclasses.dataclass
class _KernelLayout:
    batch_cols: list = None  # [(batch_idx, [col_idx...])...]
    nrows_batches: list = None
    aux_order: list = None


_NO_PACK = object()

# ORDER BY ... LIMIT takes the top-k select (and shards) up to this many rows
_TOPK_MAX = 16384


def _tier_of(plan) -> str:
    return plan.group_strategy[0] if plan.group_strategy else "projection"


def _input_fields(node: R.Compound, offsets) -> List[set]:
    """Each input's fields a Compound reads (local to the input).  Group,
    filter and join refs are over the combined input domain; an
    aggregate's targets read its outputs, so they are left out."""
    if node.is_aggregate:
        exprs = list(node.group_exprs) + list(node.aggs) + [
            c for _, c in node.join_levels if c is not None] + (
            [node.filter_cond] if node.filter_cond is not None else [])
    else:
        exprs = list(_iter_node_exprs(node))
    per_input = [set() for _ in node.inputs]
    for e in exprs:
        for r in E.collect_input_refs(e):
            i = input_of_field(offsets, r.field_idx)[0]
            per_input[i].add(r.field_idx - offsets[i])
    return per_input


def _topk_source(child):
    """(scan, compound or None, the scan's needed fields, their bytes a row)
    of a top-k Sort's child that streams or shards: a Scan, or a
    non-aggregate Compound with no join over one, reading no array column;
    None for another child."""
    if isinstance(child, R.Scan):
        scan, compound = child, None
        needed = set(range(scan.arity))
    elif (isinstance(child, R.Compound) and not child.is_aggregate
          and not child.join_levels and len(child.inputs) == 1
          and isinstance(child.inputs[0], R.Scan)):
        scan, compound = child.inputs[0], child
        needed = set()
        for e in _iter_node_exprs(compound):
            needed |= {r.field_idx for r in E.collect_input_refs(e)}
    else:
        return None
    t = scan.table
    if any(_scan_field_type(t, f).is_array for f in needed):
        return None
    return (scan, compound, needed,
            max(sum(_scan_field_type(t, f).np_dtype().itemsize for f in needed), 1))


def _block_key(t, col_id: int, lo: int, hi: int, device) -> tuple:
    """The scan-cache key of a shard's row block [lo, hi) of a column on a
    device (a non-None fifth part: `_old_entries` drops it)."""
    return (t.table_id, t.generation, col_id, B.bucket(hi - lo), ("rows", lo, hi, str(device)))


def _is_block_key(key) -> bool:
    return isinstance(key[4], tuple) and key[4][:1] == ("rows",)


def _batch_to(b: B.Batch, device, live: bool = False) -> B.Batch:
    """b's columns on device (no copy where they are); `live`: only the
    bucket of its live rows."""
    n = B.bucket(max(b.nrows, 1)) if live else None
    return B.Batch([None if c is None else c[:n].to(device) for c in b.cols],
                   b.nrows, list(b.types))


def _names_table(key, table_id: int) -> bool:
    """True when a cache key holds, at any depth, a Scan of table_id or a
    column reference (table_id, col_id) / (table_id, col_id, step)."""
    if not isinstance(key, tuple):
        return False
    if len(key) >= 2 and key[0] == "Scan" and key[1] == table_id:
        return True
    if len(key) in (2, 3) and key[0] == table_id and isinstance(key[1], int) \
            and not isinstance(key[1], bool):
        return True
    return any(_names_table(k, table_id) for k in key)


def _narrow_dtype(dt: np.dtype, rng) -> Optional[np.dtype]:
    """The narrowest of int8 / int16 / int32, narrower than the integer
    dtype dt, whose values hold the chunk-stat range rng = (lo, hi, ...)
    above its minimum (kept for NULL); None when none does."""
    if dt.kind != "i" or rng is None or rng[0] is None or rng[1] is None:
        return None
    lo, hi = int(rng[0]), int(rng[1])
    for cand in (np.int8, np.int16, np.int32):
        ii = np.iinfo(cand)
        if np.dtype(cand).itemsize < dt.itemsize and ii.min < lo and hi <= ii.max:
            return np.dtype(cand)
    return None


def _is_null_value(v, ti: T.TypeInfo) -> bool:
    """A value read back from a column is its type's NULL (None, NaN or
    the null sentinel)."""
    if v is None:
        return True
    if isinstance(v, float):
        return v != v
    try:
        return v == ti.null_sentinel()
    except Exception:
        return False


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


# a join domain's row indices are int32
_MAX_JOIN_DOMAIN = (1 << 31) - 1

# a NULL dictionary id in a transform or pair table
_I32_MIN = int(np.iinfo(np.int32).min)


def _expr_aux_specs(exprs) -> dict:
    """aux key -> spec of every aux table the expressions read (the
    reference's `_plan_compound` aux specs): a dictionary predicate's
    table, a transform's, a pair concat's, a pair comparison's rank
    tables, the rank and order tables of a MIN / MAX over a dictionary
    string, and an ArrayFn's tables (UNNEST's are its node's own)."""
    specs = {}
    kinds = ((E.DictStrPredicate, "strpred"), (E.StringTransform, "strtransform"),
             (E.StringPairConcat, "pairconcat"), (E.DictPairCompare, "pairrank"))
    for e in exprs:
        for sub in E.walk(e):
            for cls, kind in kinds:
                if isinstance(sub, cls):
                    specs.setdefault(sub.key(), (kind, sub))
            if isinstance(sub, E.Agg) and sub.kind in (E.AggKind.MIN, E.AggKind.MAX) \
                    and sub.arg is not None and sub.arg.type.is_dict_string:
                ref = getattr(sub.arg, "dict_ref", None)
                if ref is not None:
                    specs.setdefault(("dictrank", ref), ("dictrank", ref))
                    specs.setdefault(("dictorder", ref), ("dictorder", ref))
            if isinstance(sub, E.ArrayFn) and sub.op != "UNNEST":
                specs.setdefault(sub.key(), ("array", sub))
    return specs


def _strpred_host(pred: E.DictStrPredicate, d) -> np.ndarray:
    """A predicate's host table over the entries of dictionary d, padded
    to the bucket of its size: bool matches (LIKE, ILIKE, REGEXP, CMP, IN)
    or values (LENGTH; INTFN and TRYCAST with the null sentinel, or NaN,
    where the entry gives NULL)."""
    import json

    padded = B.bucket(max(d.size, 1))
    if pred.kind == "LENGTH":
        host = np.zeros(padded, np.int32)
        host[:d.size] = [len(s) for s in d.entries()]
        return host
    if pred.kind == "TRYCAST":
        return _try_cast_host(pred, d, padded)
    if pred.kind == "INTFN":
        from heavydb_tpu_torch.storage.string_ops import int_string_fn

        args = tuple(json.loads(pred.pattern))
        sentinel = pred.type.null_sentinel()
        host = np.zeros(padded, pred.type.np_dtype())
        for i, s in enumerate(d.entries()):
            v = int_string_fn(s, pred.cmp_op, args)
            host[i] = sentinel if v is None else v
        return host
    if pred.kind in ("LIKE", "ILIKE"):
        ids = d.like_ids(pred.pattern, pred.escape, pred.kind == "ILIKE")
    elif pred.kind == "REGEXP":
        ids = d.regexp_ids(pred.pattern)
    elif pred.kind == "CMP":
        ids = d.compare_ids(pred.cmp_op, pred.pattern)
    elif pred.kind == "IN":
        pats = pred.pattern.split("\x00") if pred.pattern else []
        ids = np.array([i for i in (d.get_id(p) for p in pats) if i >= 0], np.int32)
    else:
        raise NotSupported(f"dict predicate {pred.kind}")
    host = np.zeros(padded, bool)
    host[ids] = True
    return host


def _try_cast_host(pred: E.DictStrPredicate, d, padded: int) -> np.ndarray:
    """TRY_CAST(text AS type) of each entry: the value, or the type's null
    sentinel (NaN for a float) where it does not parse.  DATE, TIMESTAMP
    and TIME parse as ISO text (the reference's TryStringCast ->
    StringToDatum); numbers as a float, then rounded to the type."""
    import json

    _, scale = json.loads(pred.pattern)
    ti = pred.type
    dt = ti.np_dtype()
    host = np.full(padded, ti.null_sentinel(), dt)
    if ti.kind in (T.SQLTypeKind.DATE, T.SQLTypeKind.TIMESTAMP, T.SQLTypeKind.TIME):
        for i, entry in enumerate(d.entries()):
            try:
                v = _const_cast(entry, T.text_none(), ti)
            except (ValueError, OverflowError):  # no such date or time: NULL
                continue
            if v is not None:
                host[i] = v
        return host
    for i, entry in enumerate(d.entries()):
        try:
            v = float(entry.strip())
        except ValueError:
            continue
        if dt.kind == "f":
            host[i] = v
            continue
        if ti.is_decimal:
            v = round(v * 10**scale)
        if abs(v - round(v)) < 1e-9 or ti.is_decimal:
            iv = int(round(v))
            if np.iinfo(dt).min < iv <= np.iinfo(dt).max:
                host[i] = iv
    return host


def _build_form(jp: _JoinPlan, build_padded: int) -> str:
    """How a level builds and probes: cross, perfect-unique, perfect, hash
    or sorted (as the kernel picks it); a grid join names its kind, its
    registrations a build row and its probe."""
    from heavydb_tpu_torch.exec.compound_kernel import (_JOIN_HASH_MAX_SLOTS,
                                                        _join_hash_slots)

    if jp.kind == "CROSS":
        return "cross"
    if jp.geo is not None:
        reps = len(jp.geo.offsets)
        probe = "sorted" if jp.hash_fallback or \
            _join_hash_slots(reps * build_padded) > _JOIN_HASH_MAX_SLOTS else "hash"
        return f"geo {jp.geo.kind} x{reps} {probe}"
    if jp.key_min is not None:
        return "perfect-unique" if jp.unique_build else "perfect"
    if jp.hash_fallback or _join_hash_slots(build_padded) > _JOIN_HASH_MAX_SLOTS:
        return "sorted"
    return "hash"


def _input_offsets(node: R.RelNode) -> List[int]:
    """Each input's first field in the Compound's combined input schema."""
    offsets, acc = [], 0
    for i in node.inputs:
        offsets.append(acc)
        acc += i.arity
    return offsets


def _group_ranges(node: R.Compound) -> list:
    """Chunk-stat ranges of the group keys, made nullable where an outer
    join null-extends their fields (LEFT: the build side's; FULL: both
    sides'), so that the perfect tier gives the NULL rows their own slot."""
    ranges = [RNG.expr_range(g, node.inputs) for g in node.group_exprs]
    offsets = _input_offsets(node)
    outer = set()
    for li, (kind, _) in enumerate(node.join_levels):
        end = offsets[li + 1] + node.inputs[li + 1].arity
        if kind == "LEFT":
            outer |= set(range(offsets[li + 1], end))
        elif kind == "FULL":
            outer |= set(range(0, end))
    for gi, g in enumerate(node.group_exprs):
        r = ranges[gi]
        if r is not None and not r.has_nulls and any(
                ref.field_idx in outer for ref in E.collect_input_refs(g)):
            ranges[gi] = dataclasses.replace(r, has_nulls=True)
    return ranges


def _split_join_condition(cond, lo: int, hi: int):
    """Split a join condition into equi pairs (probe_expr, build_expr) and
    residual conjuncts.  Build side = fields in [lo, hi)."""
    if cond is None:
        return [], []
    from heavydb_tpu_torch.plan.optimizer import _split_conjuncts

    def sides(e):
        refs = E.collect_input_refs(e)
        return (bool(refs) and all(r.field_idx < lo for r in refs),
                bool(refs) and all(lo <= r.field_idx < hi for r in refs))

    equis, residual = [], []
    for c in _split_conjuncts(cond):
        if isinstance(c, E.DictPairCompare) and c.op == "=" \
                and not c.left_ops and not c.right_ops:
            # a chain-free dict = dict across the two sides becomes a raw-id
            # equi key (the planner translates the dictionaries); on one
            # side it stays a residual DictPairCompare
            (l_probe, l_build), (r_probe, r_build) = sides(c.left), sides(c.right)
            if not ((l_probe and r_build) or (l_build and r_probe)):
                residual.append(c)
                continue
            c = E.BinOp(E.BinOpKind.EQ, c.left, c.right, c.type)
        if isinstance(c, E.BinOp) and c.op == E.BinOpKind.EQ:
            (l_probe, l_build), (r_probe, r_build) = sides(c.left), sides(c.right)
            if l_probe and r_build:
                equis.append((c.left, c.right))
                continue
            if l_build and r_probe:
                equis.append((c.right, c.left))
                continue
        residual.append(c)
    return equis, residual
