"""Per-slot MIN or MAX over 257..4096 slots in the value's own type
(kernel B3).

Port of heavydb_tpu/kernels/groupby_pallas.py `minmax_per_slot` (a
[block, slots] masked tile reduce in VMEM).  The CUDA kernel is
csrc/groupby_minmax.cu on the body of csrc/stream_agg.cuh with one MIN or
MAX stream: 4-row vector loads, one copy of every slot's cells a block in
shared memory, native shared atomicMin / atomicMax on int32 keys, a
resident grid.  float32 values travel as order-preserving int32 keys (NaN
wins both MIN and MAX, -0.0 sorts below +0.0) and are decoded here.  The
body's per-slot counts are computed and dropped.  It is bound by the bytes
it reads: gid (4 B/row), the mask (1 B/row) and the values (4 B/row).

Values must be at most 4 bytes; int8/int16/bool values are widened to
int32 and the result cast back.  Slots no row reached keep the identity
(+inf / -inf, int32 max / min).

CPU tensors take the plain version; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import torch

from heavydb_tpu_torch.kernels import _build, _plain

MAX_SLOTS = 4096


def plan(num_slots: int) -> _build.AggPlan:
    """B3's launch: 256-thread blocks, each with a copy of every slot's u32
    count and int32 key in shared memory (4096 slots: 32 KB, within the 56
    KB that lets four blocks share an SM)."""
    return _build.AggPlan("shared", 1, 256, _build.smem_bytes(num_slots, ["min"]),
                          num_slots)


def _widen(values):
    if values.dtype in (torch.int32, torch.float32):
        return values
    if values.dtype in (torch.bool, torch.int8, torch.int16):
        return values.to(torch.int32)
    raise ValueError(f"minmax_per_slot: {values.dtype} values unsupported "
                     "(at most 4 bytes)")


def minmax_per_slot(gid, values, mask, num_slots: int, is_min: bool):
    if not 0 < num_slots <= MAX_SLOTS:
        raise ValueError(f"minmax_per_slot: {num_slots} slots outside "
                         f"1..{MAX_SLOTS}")
    if gid.device.type == "cpu":
        return minmax_per_slot_plain(gid, values, mask, num_slots, is_min)
    if gid.device.type != "cuda":
        raise ValueError(f"minmax_per_slot: no kernel for device {gid.device}")
    return launch(gid, values, mask, num_slots, is_min, counter=minmax_per_slot)


minmax_per_slot.launches = 0


def launch(gid, values, mask, num_slots: int, is_min: bool, counter=None):
    """The CUDA launch itself; `counter.launches` (the wrapper's launch
    count, if given) rises by one when the kernel launches."""
    _, out = _build.launch_streams(
        "groupby_minmax", gid, mask, [(_widen(values), "min" if is_min else "max")],
        num_slots, lambda ops: plan(num_slots), counter=counter)
    return out.to(values.dtype)


def minmax_per_slot_plain(gid, values, mask, num_slots: int, is_min: bool):
    v = _widen(values)
    idx = _plain.slot_index(gid, mask, num_slots)
    return _plain.scatter_minmax(idx, v, num_slots, is_min).to(values.dtype)
