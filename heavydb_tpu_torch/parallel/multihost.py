"""Multi-host execution runtime over torch.distributed.

Counterpart of heavydb_tpu/parallel/multihost.py, which rides
jax.distributed.  The reference's aggregator/leaf cluster maps onto a
torch.distributed process group with the gloo backend:

- every host runs the same engine process; `MultiHostRuntime.initialize`
  joins the cluster (coordinator = host 0's address), with a finite
  timeout, so that a dead peer fails a collective instead of hanging it;
- tables are row-partitioned across hosts (`DistEngine.load_table`), with
  string dictionaries built globally (a deterministic merge of per-host
  uniques) so that dictionary ids agree everywhere;
- each host runs the leaf Compound over its partition on its own device;
  the partial rows are exchanged here, as host numpy, and the aggregator
  merge runs replicated (parallel/dist_engine.py).

The data plane stays host numpy, as in the reference, whose exchange is
process_allgather of numpy arrays: one meta gather and one padded pow2
byte gather a call, over gloo, which serves CPU and CUDA processes alike.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, List, Optional

import numpy as np
import torch


class MultiHostRuntime:
    """Process-group membership + host-data exchange helpers."""

    def __init__(self):
        self.initialized = False
        self.num_processes = 1
        self.process_id = 0

    def initialize(
        self,
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        timeout_s: float = 300.0,
    ) -> bool:
        """Join (or bootstrap) the cluster: a gloo group at
        tcp://coordinator_address.  Single-process -> no-op."""
        if num_processes is None or num_processes <= 1:
            return False
        import torch.distributed as dist

        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id or 0,
            timeout=timedelta(seconds=timeout_s),
        )
        self.initialized = True
        self.num_processes = num_processes
        self.process_id = process_id or 0
        return True

    def shutdown(self) -> None:
        """Leave the process group (after a last barrier, so that no host
        tears the group down under a peer's collective)."""
        if self.initialized:
            import torch.distributed as dist

            dist.barrier()
            dist.destroy_process_group()
            self.initialized = False

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    # ---- host-data exchange (control/data plane helpers) ----

    def _allgather(self, a: np.ndarray) -> np.ndarray:
        """[P, *a.shape]: every host's equal-shaped array (process_allgather)."""
        if not self.initialized:
            return a[None]
        import torch.distributed as dist

        t = torch.from_numpy(np.ascontiguousarray(a))
        out = [torch.empty_like(t) for _ in range(self.num_processes)]
        dist.all_gather(out, t)
        return torch.stack(out).numpy()

    def allgather_scalar(self, x: int) -> List[int]:
        g = self._allgather(np.array([x], np.int64))
        return [int(v) for v in g.reshape(-1)]

    def allgather_multi(
        self, arrays: List[np.ndarray]
    ) -> List[List[np.ndarray]]:
        """ONE padded byte exchange for a LIST of 1-D arrays (per-host
        lengths may differ; array count and dtypes must match across
        hosts).  Returns, per array, the per-host pieces.

        Two collectives regardless of column count: a meta gather of the
        lengths and byte count, then the bytes padded to a power of two
        (at least 16), so that repeated queries reuse one size class."""
        k = len(arrays)
        arrs = [np.ascontiguousarray(a) for a in arrays]
        lens = np.array([a.shape[0] for a in arrs], np.int64)
        blob = b"".join(a.tobytes() for a in arrs)
        nb = len(blob)
        meta = np.concatenate([lens, np.array([nb], np.int64)])
        metas = self._allgather(meta).reshape(self.num_processes, k + 1)
        cap = 1 << max(int(metas[:, -1].max()).bit_length(), 4)
        pad = np.zeros((cap,), np.uint8)
        pad[:nb] = np.frombuffer(blob, np.uint8)
        g = self._allgather(pad).reshape(self.num_processes, cap)
        out: List[List[np.ndarray]] = [[] for _ in range(k)]
        for p in range(self.num_processes):
            off = 0
            buf = g[p]
            for i, a in enumerate(arrs):
                n = int(metas[p, i])
                nbytes = n * a.dtype.itemsize
                piece = np.frombuffer(
                    buf[off:off + nbytes].tobytes(), a.dtype
                )
                out[i].append(piece)
                off += nbytes
        return out

    def allgather_array(self, a: np.ndarray) -> List[np.ndarray]:
        """Gather a variable-length 1-D array from every host (padded
        exchange; trimmed per-host on receipt)."""
        return self.allgather_multi([np.ascontiguousarray(a)])[0]

    def allgather_concat(self, arrays: List[np.ndarray]) -> List[np.ndarray]:
        """Gather several columns from every host (ONE exchange) and
        return the concatenation over hosts for each column."""
        if not arrays:
            return []
        per = self.allgather_multi(
            [np.ascontiguousarray(a) for a in arrays]
        )
        return [np.concatenate(parts) for parts in per]

    def allgather_bytes(self, b: bytes) -> List[bytes]:
        arr = np.frombuffer(b, np.uint8)
        return [bytes(p.tobytes()) for p in self.allgather_array(arr)]

    def allgather_strings(self, strings: List[str]) -> List[str]:
        """Deterministic global merge of per-host string lists (dictionary
        build): process order, then first-seen order within each host."""
        blob = "\x00".join(strings).encode("utf-8")
        merged: List[str] = []
        seen = set()
        for b in self.allgather_bytes(blob):
            if not b:
                continue
            for s in b.decode("utf-8").split("\x00"):
                if s not in seen:
                    seen.add(s)
                    merged.append(s)
        return merged

    def exchange_rows(
        self, cols: List[np.ndarray], dest: np.ndarray
    ) -> List[np.ndarray]:
        """Route row i of `cols` to host dest[i] (the repartition data
        plane).  ONE batched allgather + a local filter, as in the
        reference: traffic is allgather-shaped, but memory and compute
        partition correctly.  Rows are pre-sorted (stably) by destination,
        so a host receives the senders' rows in sending-host order, each
        host's rows in their order; the local filter is one contiguous
        slice per sending host."""
        d = np.asarray(dest, np.int32)
        order = np.argsort(d, kind="stable")
        payload = [np.ascontiguousarray(np.asarray(c)[order])
                   for c in cols]
        # per-dest row counts ride the meta vector as one extra array
        counts = np.bincount(d, minlength=self.num_processes).astype(
            np.int64
        )
        per = self.allgather_multi(payload + [counts])
        all_counts = per[-1]  # per host: rows bound for each dest
        out = []
        for parts in per[:-1]:
            mine = []
            for p, piece in enumerate(parts):
                starts = np.concatenate(
                    [[0], np.cumsum(all_counts[p])]
                )
                lo = int(starts[self.process_id])
                hi = int(starts[self.process_id + 1])
                mine.append(piece[lo:hi])
            out.append(np.concatenate(mine))
        return out

    def barrier(self, name: str = "hdt"):
        if self.initialized:
            import torch.distributed as dist

            dist.barrier()


def generations_snapshot(db) -> Dict[str, dict]:
    """Consistent metadata snapshot for distributed planning (reference
    AggregatedColRange + StringDictionaryGenerations + TableGenerations).
    Consumed by DistEngine.snapshot to verify all hosts plan against the
    same global metadata."""
    out = {}
    for name in db.catalog.list_tables():
        t = db.catalog.get_table(name)
        cols = {}
        for cd in t.columns:
            mn, mx, has_nulls = t.column_range(cd.col_id)
            cols[cd.name] = {
                "min": mn, "max": mx, "has_nulls": has_nulls,
                "dict_size": (
                    t.dicts[cd.col_id].size if cd.col_id in t.dicts else None
                ),
            }
        out[name] = {
            "generation": t.generation,
            "num_rows": t.num_rows,
            "columns": cols,
        }
    return out
