"""Device-resident columnar batches.

Port of heavydb_tpu/exec/batch.py.  A Batch is the unit flowing between
execution steps — the analogue of the reference's intermediate
ResultSet/ColumnarResults (QueryEngine/ColumnarResults.cpp): padded dense
device tensors (one per column) plus the actual row count.  Padding rounds
row counts up to quarter-step buckets, as the reference does to reuse its
compiled kernels across sizes; pad rows hold null sentinels and are
excluded by the in-domain mask (iota < nrows) before any kernel sees them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from heavydb_tpu_torch import types as T

MIN_BUCKET = 8


def bucket(n: int) -> int:
    """Next {1, 1.25, 1.5, 1.75}·2^k ≥ n (min MIN_BUCKET).

    Pure powers of two waste up to half the domain as padding (a 20M-row
    table pads to 32M — every kernel then streams/scatters 1.6x the real
    rows).  Quarter-steps cap padding at 25% for a bounded 4x growth in
    distinct compiled shapes (the kernel cache keys on the bucket)."""
    if n <= MIN_BUCKET:
        return MIN_BUCKET
    step = 1 << ((n - 1).bit_length() - 3)  # quarter points of the octave
    return -(-n // step) * step


def pad_to(arr: np.ndarray, size: int, ti: T.TypeInfo) -> np.ndarray:
    n = arr.shape[0]
    if n == size:
        return arr
    pad_val = ti.null_sentinel()
    out = np.full(size, pad_val, arr.dtype)
    out[:n] = arr
    return out


@dataclass
class Batch:
    """cols[i] is a device tensor of length `padded` (or None if pruned)."""

    cols: List[Optional[torch.Tensor]]
    nrows: int
    types: List[T.TypeInfo]

    @property
    def padded(self) -> int:
        for c in self.cols:
            if c is not None:
                return c.shape[0]
        return bucket(self.nrows)

    def col(self, i: int) -> torch.Tensor:
        c = self.cols[i]
        assert c is not None, f"column {i} was pruned"
        return c

    def to_numpy(self) -> List[Optional[np.ndarray]]:
        # Slice every column to the live row count on the device BEFORE the
        # host copy: a LIMIT 5 over a 20M-row batch must ship 5 rows, not
        # the padded 20M.  Same-dtype columns concatenate on the device and
        # come back in one copy.
        need = bucket(max(self.nrows, 1))
        present = [
            (i, c if c.shape[0] <= need else c[:need])
            for i, c in enumerate(self.cols) if c is not None
        ]
        out: List[Optional[np.ndarray]] = [None] * len(self.cols)
        sliced = dict(present)
        groups: dict = {}
        for i, c in present:
            groups.setdefault(c.dtype, []).append(i)
        for _, idxs in groups.items():
            if len(idxs) == 1:
                i = idxs[0]
                out[i] = sliced[i].cpu().numpy()[: self.nrows]
                continue
            host = torch.cat([sliced[i] for i in idxs]).cpu().numpy()
            off = 0
            for i in idxs:
                n = sliced[i].shape[0]
                out[i] = host[off:off + n][: self.nrows]
                off += n
        return out


def from_host_columns(
    arrays: Sequence[Optional[np.ndarray]],
    nrows: int,
    types: Sequence[T.TypeInfo],
    device,
) -> Batch:
    size = bucket(nrows)
    cols = []
    for arr, ti in zip(arrays, types):
        if arr is None:
            cols.append(None)
            continue
        padded = pad_to(np.ascontiguousarray(arr), size, ti)
        cols.append(torch.from_numpy(padded).to(device))
    return Batch(list(cols), nrows, list(types))


def concat_batches(batches: Sequence[Batch], release: bool = False) -> Batch:
    """Union-all of same-schema batches: their live rows concatenated on
    their device, re-bucketed and null-padded.  `release`: each batch's
    column is dropped once it is copied, so that the copies hold at most
    one column beside what is left of the inputs."""
    total = sum(b.nrows for b in batches)
    size = bucket(total)
    types = batches[0].types
    out_cols = []
    for i, ti in enumerate(types):
        if any(b.cols[i] is None for b in batches):
            out_cols.append(None)
            continue
        cat = torch.cat([b.cols[i][: b.nrows] for b in batches])
        if release:
            for b in batches:
                b.cols[i] = None
        if cat.shape[0] < size:
            pad = torch.full((size - cat.shape[0],), ti.null_sentinel(),
                             dtype=cat.dtype, device=cat.device)
            cat = torch.cat([cat, pad])
        out_cols.append(cat)
    return Batch(out_cols, total, list(types))
