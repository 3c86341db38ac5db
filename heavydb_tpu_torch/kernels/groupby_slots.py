"""Per-slot COUNT, float32 SUM and exact integer SUM over 1..65536 slots,
one value stream each (kernels B3a-c).

Port of heavydb_tpu/kernels/groupby_pallas.py `count_per_slot`,
`sum_f32_per_slot` and `sum_int_per_slot` (a [block, slots] one-hot summed
on the TPU's matrix unit).  csrc/groupby_slots.cu is a histogram: block-
private shared-memory cells while the slots fit in 96 KB, global atomics
above, each thread loading 4 rows at a time with several such loads in
flight.  It is bound by the bytes it reads: gid (4 B/row), the mask
(1 B/row) and the values (4 or 8 B/row).  The kernel picks its grid (as
many 256-thread blocks as stay resident) and its vector or one-row path
(by the alignment of the inputs).  No SQL route calls these, in the
port as in the reference; the query engine's counts and sums go through
lane_agg and radix_hist.

Contracts, as the reference's:
- a row counts when its slot id lies in [0, S) and the mask (if given) is
  set; gid of another integer dtype is cast to int32 first;
- `count_per_slot` -> int64[S];
- `sum_f32_per_slot` -> float32[S], float values cast to float32 and added
  in float32 within a CUDA block and float64 across; a NaN or +-inf stays
  in its own slot (the reference's one-hot product spread it to all);
- `sum_int_per_slot` -> exact int64[S] of each value's two's-complement
  int32: int64 values outside the int32 range wrap, as the reference's
  +2^31 bias and uint32 cast make them.

CPU tensors take the plain version; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import torch

from heavydb_tpu_torch.kernels import _build, _plain

MAX_SLOTS = 65536


def _rows(gid, mask, num_slots: int, what: str):
    if not 0 < num_slots <= MAX_SLOTS:
        raise ValueError(f"{what}: {num_slots} slots outside 1..{MAX_SLOTS}")
    if gid.dtype.is_floating_point or gid.dtype.is_complex:
        raise ValueError(f"{what}: gid must be integer, not {gid.dtype}")
    gid = gid.to(torch.int32).contiguous()
    if mask is not None:
        mask = mask.to(torch.bool).contiguous()
    return gid, mask


def _int_values(values):
    """int32 or int64 values; narrower integers and bool widen to int32."""
    if values.dtype.is_floating_point or values.dtype.is_complex:
        raise ValueError(f"sum_int_per_slot: integer values, not {values.dtype}")
    if values.dtype != torch.int64:
        values = values.to(torch.int32)
    return values.contiguous()


def _on_cpu(gid, what: str) -> bool:
    if gid.device.type == "cpu":
        return True
    if gid.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {gid.device}")
    return False


def count_per_slot(gid, mask, num_slots: int):
    """counts[num_slots] int64."""
    gid, mask = _rows(gid, mask, num_slots, "count_per_slot")
    if _on_cpu(gid, "count_per_slot"):
        return count_per_slot_plain(gid, mask, num_slots)
    return launch("count", gid, None, mask, num_slots, counter=count_per_slot)


def sum_f32_per_slot(gid, values, mask, num_slots: int):
    """float32 sums[num_slots]."""
    gid, mask = _rows(gid, mask, num_slots, "sum_f32_per_slot")
    values = values.to(torch.float32).contiguous()
    if _on_cpu(gid, "sum_f32_per_slot"):
        return sum_f32_per_slot_plain(gid, values, mask, num_slots)
    return launch("sum_f32", gid, values, mask, num_slots, counter=sum_f32_per_slot)


def sum_int_per_slot(gid, values, mask, num_slots: int):
    """Exact int64 sums[num_slots] of int32-range values (wider ones wrap)."""
    gid, mask = _rows(gid, mask, num_slots, "sum_int_per_slot")
    values = _int_values(values)
    if _on_cpu(gid, "sum_int_per_slot"):
        return sum_int_per_slot_plain(gid, values, mask, num_slots)
    return launch("sum_int", gid, values, mask, num_slots, counter=sum_int_per_slot)


count_per_slot.launches = 0
sum_f32_per_slot.launches = 0
sum_int_per_slot.launches = 0

_ALLOWED = {"count": (None,), "sum_f32": (torch.float32,),
            "sum_int": (torch.int32, torch.int64)}


def launch(kind: str, gid, values, mask, num_slots: int, counter=None):
    """The CUDA launch of kernel `kind` ("count", "sum_f32" or "sum_int")
    on int32 gid and values of its dtype; `counter.launches` (the wrapper's
    launch count, if given) rises by one when the kernel launches."""
    vdt = None if values is None else values.dtype
    if vdt not in _ALLOWED[kind]:
        raise ValueError(f"{kind}_per_slot: values of {vdt} unsupported")
    _build.check_rows(gid, mask, [] if values is None else [values])
    dev = gid.device
    out = torch.zeros(num_slots, device=dev,
                      dtype=torch.float64 if kind == "sum_f32" else torch.int64)
    n = gid.shape[0]
    if n:
        fn = _build.entry("groupby_slots")[kind]
        with torch.cuda.device(dev):
            _build.check(fn(gid.data_ptr(),
                            mask.data_ptr() if mask is not None else None,
                            values.data_ptr() if values is not None else None,
                            _build.DT_CODES[str(vdt)[6:]] if vdt is not None else -1,
                            n, num_slots, out.data_ptr(), _build.stream_ptr(dev)),
                         f"{kind}_per_slot")
        if counter is not None:
            _build.count_launch(counter)
    return out.to(torch.float32) if kind == "sum_f32" else out


def _index_sum(gid, values, mask, num_slots: int, dtype):
    idx = _plain.slot_index(gid, mask, num_slots)
    acc = torch.zeros(num_slots + 1, dtype=dtype, device=gid.device)
    acc.index_add_(0, idx, torch.ones_like(idx) if values is None
                   else values.to(dtype))
    return acc[:num_slots]


def count_per_slot_plain(gid, mask, num_slots: int):
    return _index_sum(gid, None, mask, num_slots, torch.int64)


def sum_f32_per_slot_plain(gid, values, mask, num_slots: int):
    return _index_sum(gid, values.to(torch.float32), mask, num_slots,
                      torch.float64).to(torch.float32)


def sum_int_per_slot_plain(gid, values, mask, num_slots: int):
    return _index_sum(gid, values.to(torch.int32), mask, num_slots, torch.int64)


def plain(kind: str, gid, values, mask, num_slots: int):
    """The plain version of kernel `kind`, with `launch`'s arguments."""
    if kind == "count":
        return count_per_slot_plain(gid, mask, num_slots)
    fn = sum_f32_per_slot_plain if kind == "sum_f32" else sum_int_per_slot_plain
    return fn(gid, values, mask, num_slots)
