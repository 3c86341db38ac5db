"""Group-by histogram of counts and count/sum streams over 257..65536
slots in one pass (kernel B2).

Port of heavydb_tpu/kernels/radix_hist.py (`fused_hist`, TPU kernel
`_fused_hist`).  The TPU kernel cast the histogram as a bf16 one-hot GEMM
for its matrix unit; csrc/radix_hist.cu is a histogram on the body of
csrc/stream_agg.cuh (4-row vector loads, one dispatch a tile and stream,
integer sums as native 32-bit halves) whose cells stay in shared memory as
far as they can: `plan` picks the tier by their bytes.  It is bound by the
bytes it reads: gid (4 B/row), the mask (1 B/row) and each stream at its
own width.

Contract as kernels/lane_agg.py, with stream ops count, sumi, sumf and
sumd only (MIN/MAX over these slot counts is kernels/groupby_minmax.py);
float32 sums add in float32 within a block and in float64 across blocks.

CPU tensors take the plain version; CUDA tensors launch the kernel.
"""

from __future__ import annotations

from heavydb_tpu_torch.kernels import _build, _plain

MAX_SLOTS = 1 << 16
# blocks of a cluster, smallest first: each block scans all the cluster's
# rows, and from 8 blocks on the global tier is faster (PERF.md section 6)
CLUSTER_SIZES = (2, 4)


def plan(num_slots: int, ops) -> _build.AggPlan:
    """B2's tier for S slots and streams of `ops`, by the shared bytes of
    all slots' cells (b):
      b <= 56 KB   shared     four 256-thread blocks an SM, a copy each
      b <= 112 KB  shared     two 512-thread blocks an SM, a copy each
      b <= 227 KB  shared_sm  one 1024-thread block an SM, a copy each
      else         cluster    the smallest cluster of C (2 or 4) 1024-thread
                              blocks whose S / C slots a block fit in 227
                              KB; slot g lives in block g % C at cell
                              g // C, and each block of the cluster scans
                              the cluster's rows for its own slots
      beyond C=4   global     atomics into the outputs, 256 threads
    """
    b = _build.smem_bytes(num_slots, ops)
    if b <= _build.SMEM_FOUR_BLOCKS:
        return _build.AggPlan("shared", 1, 256, b, num_slots)
    if b <= _build.SMEM_TWO_BLOCKS:
        return _build.AggPlan("shared", 1, 512, b, num_slots)
    if b <= _build.SMEM_BLOCK_MAX:
        return _build.AggPlan("shared_sm", 1, 1024, b, num_slots)
    for c in CLUSTER_SIZES:
        per_block = -(-num_slots // c)
        b = _build.smem_bytes(per_block, ops)
        if b <= _build.SMEM_BLOCK_MAX:
            return _build.AggPlan("cluster", c, 1024, b, per_block)
    return _build.AggPlan("global", 1, 256, 0, num_slots)


def fused_hist(gid, mask, streams, num_slots: int):
    if not 0 < num_slots <= MAX_SLOTS:
        raise ValueError(f"fused_hist: {num_slots} slots outside 1..{MAX_SLOTS}")
    for _, op in streams:
        if op not in ("count", "sumi", "sumf", "sumd"):
            raise ValueError(f"fused_hist: stream op {op!r} not supported")
    if gid.device.type == "cpu":
        return fused_hist_plain(gid, mask, streams, num_slots)
    if gid.device.type != "cuda":
        raise ValueError(f"fused_hist: no kernel for device {gid.device}")
    return _build.launch_streams("radix_hist", gid, mask, streams, num_slots,
                                 lambda ops: plan(num_slots, ops),
                                 counter=fused_hist)


fused_hist.launches = 0


def fused_hist_plain(gid, mask, streams, num_slots: int):
    return _plain.scatter_scan(gid, mask, streams, num_slots)
