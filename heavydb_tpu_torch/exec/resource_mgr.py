"""Admission control for concurrent queries.

Reference: QueryEngine/ExecutorResourceMgr/ — queries submit a resource
request (CPU/GPU slots, buffer-pool bytes), the manager admits them in
order when resources free up, and oversubscription policies decide what
may run concurrently (ExecutorResourceMgr.h request_resources /
ExecutorResourcePool).

Port of heavydb_tpu/exec/resource_mgr.py.  On the card the scarce
resources are its one execution stream and its memory for the scan
working set.  The manager caps concurrent executing queries and the sum
of their estimated bytes; excess queries queue FIFO with a timeout.
Estimation uses chunk metadata only (column widths × row counts of
scanned fragments), the same inputs the reference's bytes-per-query
estimate uses, and the executor's NDV estimate of a group-by, which it
caches per (table, generation, key fields), so a warm query samples
nothing.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from heavydb_tpu_torch.errors import ExecutionError


class QueryTimedOut(ExecutionError):
    """Queued past the admission timeout (reference
    QueryTimedOutWaitingInQueue)."""


@dataclass
class ResourceRequest:
    query_id: int = 0
    est_bytes: int = 0
    submitted_at: float = field(default_factory=time.monotonic)


class ResourceMgr:
    def __init__(
        self,
        max_concurrent: int = 4,
        max_bytes: Optional[int] = None,
        queue_timeout_s: float = 300.0,
    ):
        self.max_concurrent = max_concurrent
        self.max_bytes = max_bytes
        self.queue_timeout_s = queue_timeout_s
        self._cv = threading.Condition()
        self._running: Dict[int, ResourceRequest] = {}
        self._next_id = 0
        self._queued = 0
        # stats (reference get_executor_resource_pool_info)
        self.total_admitted = 0
        self.total_timed_out = 0
        self.peak_concurrent = 0

    # ------------------------------------------------------------------
    def estimate_scan_bytes(self, plan) -> int:
        """Working-set estimate from chunk metadata: bytes of every scanned
        column (the device scan cache footprint)."""
        from heavydb_tpu_torch.plan import rel_alg as R

        total = 0
        for node in R.topo_order(plan):
            if isinstance(node, R.Scan):
                t = node.table
                n = t.num_rows
                for cd in t.columns:
                    try:
                        total += n * cd.type.np_dtype().itemsize
                    except TypeError:
                        total += n * 4
        return total

    # ------------------------------------------------------------------
    def estimate_output_bytes(self, plan, executor=None) -> int:
        """Output-buffer estimate: group-by result buffers and join
        1:N expansion buffers — exactly the allocations that OOM when
        admission only counts scan bytes (reference
        ExecutorResourcePool.h:99-119 output-buffer grants)."""
        from heavydb_tpu_torch.plan import rel_alg as R

        total = 0
        scan_rows = 0
        for node in R.topo_order(plan):
            if isinstance(node, R.Scan):
                scan_rows = max(scan_rows, node.table.num_rows)
            groups = getattr(node, "group_exprs", None)
            aggs = getattr(node, "agg_exprs", None) \
                or getattr(node, "aggs", None)
            if groups:
                slots = None
                if executor is not None:
                    try:
                        slots = executor._estimate_group_ndv(node)
                    except (TypeError, ValueError):
                        # a key sample numpy cannot order (np.unique)
                        slots = None
                if slots is None:
                    # unknown NDV: assume the sort-tier bound (output
                    # can't exceed input rows)
                    slots = scan_rows or (1 << 16)
                width = 8 * (len(groups) + 2 * len(aggs or ()))
                total += int(slots) * max(width, 8)
            levels = getattr(node, "join_levels", None)
            if levels:
                # static-cap 1:N expansion: each level materializes
                # pair indices over the probe domain
                ncols = len(getattr(node, "target_exprs", ()) or ()) or 4
                total += scan_rows * 8 * (len(levels) + 1) \
                    + scan_rows * 8 * ncols
        return total

    # ------------------------------------------------------------------
    def acquire(self, est_bytes: int = 0) -> "ResourceGrant":
        """Block until the query is admitted; returns a grant to release.
        Raises QueryTimedOut after queue_timeout_s."""
        deadline = time.monotonic() + self.queue_timeout_s
        with self._cv:
            self._queued += 1
            try:
                while not self._admissible(est_bytes):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self.total_timed_out += 1
                        raise QueryTimedOut(
                            f"query queued > {self.queue_timeout_s}s "
                            f"({len(self._running)} running)"
                        )
                    self._cv.wait(timeout=remaining)
            finally:
                self._queued -= 1
            self._next_id += 1
            req = ResourceRequest(self._next_id, est_bytes)
            self._running[req.query_id] = req
            self.total_admitted += 1
            self.peak_concurrent = max(
                self.peak_concurrent, len(self._running)
            )
            return ResourceGrant(self, req)

    def _admissible(self, est_bytes: int) -> bool:
        if len(self._running) >= self.max_concurrent:
            return False
        if self.max_bytes is not None and self._running:
            in_use = sum(r.est_bytes for r in self._running.values())
            if in_use + est_bytes > self.max_bytes:
                return False
        return True

    def _release(self, req: ResourceRequest):
        with self._cv:
            self._running.pop(req.query_id, None)
            self._cv.notify_all()

    def info(self) -> dict:
        with self._cv:
            return {
                "running": len(self._running),
                "queued": self._queued,
                "running_bytes": sum(
                    r.est_bytes for r in self._running.values()
                ),
                "max_concurrent": self.max_concurrent,
                "max_bytes": self.max_bytes,
                "total_admitted": self.total_admitted,
                "total_timed_out": self.total_timed_out,
                "peak_concurrent": self.peak_concurrent,
            }


class ResourceGrant:
    def __init__(self, mgr: ResourceMgr, req: ResourceRequest):
        self._mgr = mgr
        self._req = req

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._mgr._release(self._req)
        return False
