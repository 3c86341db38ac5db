"""The perfect join build's slot and count pass (kernel J1).

`ops/join.py` `build_perfect` takes from it each build row's slot in the
dense key space [key_min, key_min + key_range) and the rows a slot holds;
it then orders the rows by slot with one stable sort.  A row drops (its
slot is key_range, and it is not counted) when it is at or past
`num_rows`, its validity is False, or its key is outside the range.

csrc/join_build.cu does this in one pass over the rows: int32 slots out,
int32 counts, no atomic for a dropped row, one atomic for each run of
equal slots in a warp, and no read of a dropped row's key.  It reads
nothing back to the host.  The plain
version is the formula `build_perfect` used before it: an int64 slot and
`torch.bincount` over key_range + 1 bins.

CPU tensors take the plain version; CUDA tensors launch the kernel on
their own card's current stream.  The planner gives a perfect build no
key_range past MAX_RANGE, whose drop slot int32 cannot hold; on the CPU
such a range keeps an int64 slot, and on the card it raises.
"""

from __future__ import annotations

import torch

from heavydb_tpu_torch.kernels import _build

# the largest key_range whose drop slot (key_range itself) fits int32
MAX_RANGE = 2**31 - 2


def perfect_count(keys, valid, num_rows: int, key_min: int, key_range: int):
    """(slot[b], counts int32[key_range]) of the build rows `keys` (any
    integer dtype, read as int64) with validity `valid` (bool or None).
    slot is int32, or on the CPU int64 where key_range passes MAX_RANGE."""
    keys = keys.to(torch.int64).contiguous()
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
    if keys.device.type == "cpu":
        return perfect_count_plain(keys, valid, num_rows, key_min, key_range)
    if keys.device.type != "cuda":
        raise ValueError(f"perfect_count: no kernel for device {keys.device}")
    if valid is not None and (valid.shape != keys.shape or valid.device != keys.device):
        raise ValueError("perfect_count: valid must be a bool tensor like keys")
    return launch(keys, valid, int(num_rows), int(key_min), int(key_range),
                  counter=perfect_count)


perfect_count.launches = 0


def launch(keys, valid, num_rows: int, key_min: int, key_range: int, counter=None):
    """The CUDA launch on contiguous int64 keys and bool validity (or None);
    `counter.launches` (the wrapper's launch count, if given) rises by one
    when the kernel launches."""
    if not 0 <= key_range <= MAX_RANGE:
        raise ValueError(f"perfect_count: key_range {key_range} outside 0..{MAX_RANGE}")
    dev = keys.device
    n = keys.shape[0]
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(key_range, dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            _build.check(_build.entry("join_build").run(
                keys.data_ptr(), valid.data_ptr() if valid is not None else None, n,
                num_rows, key_min, key_range, slot.data_ptr(), counts.data_ptr(),
                _build.stream_ptr(dev)), "perfect_count")
        if counter is not None:
            _build.count_launch(counter)
    return slot, counts


def perfect_count_plain(keys, valid, num_rows: int, key_min: int, key_range: int):
    """The plain version on any device: the slot in int64 (int32 where
    key_range allows), the counts by `torch.bincount`."""
    b = keys.shape[0]
    ok = torch.ones(b, dtype=torch.bool, device=keys.device)
    ok[int(num_rows):] = False
    if valid is not None:
        ok = ok & valid
    slot = keys.to(torch.int64) - key_min
    slot = torch.where(ok & (slot >= 0) & (slot < key_range), slot, key_range)
    counts = torch.bincount(slot, minlength=key_range + 1)[:key_range].to(torch.int32)
    return (slot.to(torch.int32) if key_range <= MAX_RANGE else slot), counts


def kernel_info() -> dict:
    """Registers, local and shared bytes, resident blocks per SM and threads
    of a launch."""
    return _build.launch_info(lambda out: _build.entry("join_build").info(out),
                              "perfect_count info")
