"""Group-by aggregation over at most 256 slots in one pass (kernel B1).

Port of heavydb_tpu/kernels/lane_agg.py (`lane_agg`, TPU kernel
`_lane_agg`).  The CUDA kernel is csrc/lane_agg.cu on the body of
csrc/stream_agg.cuh: a private copy of every slot's cells a block in shared
memory, rows loaded 4 at a time as vectors, one dispatch on the stream's
class a tile, integer sums as native 32-bit halves, merged once per block
with global atomics.  It is bound by the bytes it reads: gid (4 B/row), the
mask (1 B/row) and each stream at its own width, never widened before the
launch.

Contract: a row contributes when mask[r] holds and 0 <= gid[r] < S.
streams: [(values, op)] with op in
  count  bool values           -> int64 count of True rows
  sumi   int values            -> exact int64 sum
  sumf   float32 values        -> float32 within a block, float64 across
  sumd   float32/64 values     -> float64 sum
  min    int32/float32 values  -> per-slot MIN in the value's dtype
  max    int32/float32 values  -> per-slot MAX in the value's dtype
Sum streams hold 0 on rows that must not add.  Returns [counts int64[S]] +
one tensor per stream.  A slot that no row reached keeps 0 (sums) or the
dtype's identity (+-inf, int32 max/min) for MIN/MAX.

CPU tensors take the plain version; CUDA tensors launch the kernel.
"""

from __future__ import annotations

from heavydb_tpu_torch.kernels import _build, _plain

MAX_SLOTS = 256


def plan(num_slots: int, ops) -> _build.AggPlan:
    """B1's launch: 256-thread blocks, each with a copy of every slot's
    cells in shared memory (at most 256 slots x 16 8-byte streams: 33 KB)."""
    return _build.AggPlan("shared", 1, 256, _build.smem_bytes(num_slots, ops),
                          num_slots)


def lane_agg(gid, mask, streams, num_slots: int):
    if not 0 < num_slots <= MAX_SLOTS:
        raise ValueError(f"lane_agg: {num_slots} slots outside 1..{MAX_SLOTS}")
    if gid.device.type == "cpu":
        return lane_agg_plain(gid, mask, streams, num_slots)
    if gid.device.type != "cuda":
        raise ValueError(f"lane_agg: no kernel for device {gid.device}")
    return _build.launch_streams("lane_agg", gid, mask, streams, num_slots,
                                 lambda ops: plan(num_slots, ops), counter=lane_agg)


lane_agg.launches = 0


def lane_agg_plain(gid, mask, streams, num_slots: int):
    return _plain.scatter_scan(gid, mask, streams, num_slots)
