"""Sort each fixed tile of int32 keys ascending, payloads riding along
(kernel B4).

Port of heavydb_tpu/kernels/tile_sort.py (`sort_tiles`, TPU body
`_tile_bitonic`).  csrc/tile_sort.cuh holds the network, a
register-blocked bitonic sort that B6 (csrc/radix_groupby.cu) also runs on
each partition's distinct keys; csrc/tile_sort.cu is this standalone entry
point: one block per tile, 16 keys in each thread's registers,
sorting the int32 keys alone when there is no payload and 64-bit (key,
local index) words otherwise, then one gather of each payload, staged in
shared memory, through the sorted indices.

Contract: `key` int32[n], n a multiple of `rows_per_tile` (a power of two
in [32, 16384]); up to four payloads of 4 bytes each.  Returns
[key_sorted, *payloads_sorted], every tile sorted ascending on its own.
The contract promises no order among equal keys (the kernel gives them in
row order, the plain version in `torch.sort`'s).

CPU tensors take the plain version; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from heavydb_tpu_torch.kernels import _build

MAX_PAYLOADS = 4
MAX_TILE = 16384


class Payloads(ctypes.Structure):
    """Mirror of `struct Payloads` in csrc/tile_sort.cu."""

    _fields_ = [
        ("inp", ctypes.c_void_p * MAX_PAYLOADS),
        ("out", ctypes.c_void_p * MAX_PAYLOADS),
        ("n", ctypes.c_int),
    ]


def _check(key, payloads, rows_per_tile: int):
    T = rows_per_tile
    if T < 32 or T & (T - 1) or T > MAX_TILE:
        raise ValueError(f"sort_tiles: tile {T} is not a power of two in "
                         f"[32, {MAX_TILE}]")
    if key.dtype != torch.int32 or key.dim() != 1 or not key.is_contiguous():
        raise ValueError("sort_tiles: key must be a contiguous 1-D int32 tensor")
    if key.shape[0] % T:
        raise ValueError("sort_tiles: length is not a multiple of the tile")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"sort_tiles: at most {MAX_PAYLOADS} payloads")
    for p in payloads:
        if p.element_size() != 4 or p.shape != key.shape \
                or not p.is_contiguous() or p.device != key.device:
            raise ValueError("sort_tiles: payloads must be contiguous 4-byte "
                             "tensors like key")


def sort_tiles(key, payloads=(), rows_per_tile: int = 4096):
    payloads = list(payloads)
    _check(key, payloads, rows_per_tile)
    if key.device.type == "cpu":
        return sort_tiles_plain(key, payloads, rows_per_tile)
    if key.device.type != "cuda":
        raise ValueError(f"sort_tiles: no kernel for device {key.device}")
    key_out = torch.empty_like(key)
    outs = [torch.empty_like(p) for p in payloads]
    ps = Payloads()
    ps.n = len(payloads)
    for j, (p, o) in enumerate(zip(payloads, outs)):
        ps.inp[j] = p.data_ptr()
        ps.out[j] = o.data_ptr()
    if key.shape[0]:
        fn = _build.entry("tile_sort")
        _build.check(fn(key.data_ptr(), key_out.data_ptr(), ctypes.addressof(ps),
                        key.shape[0], rows_per_tile, None,
                        _build.stream_ptr(key.device)), "tile_sort")
        sort_tiles.launches += 1
    return [key_out] + outs


sort_tiles.launches = 0


def kernel_info(rows_per_tile: int = 4096, n_payloads: int = 0) -> dict:
    """Registers, local and shared bytes, resident blocks per SM and
    threads of the kernel as sort_tiles launches it (CUDA only)."""
    ps = Payloads()
    ps.n = n_payloads
    fn = _build.entry("tile_sort")
    return _build.launch_info(
        lambda out: fn(None, None, ctypes.addressof(ps), 0, rows_per_tile,
                       out, None), "tile_sort info")


def sort_tiles_plain(key, payloads=(), rows_per_tile: int = 4096):
    k2 = key.view(-1, rows_per_tile)
    ks, order = torch.sort(k2, dim=1)
    return [ks.reshape(-1)] + [
        torch.gather(p.view(-1, rows_per_tile), 1, order).reshape(-1)
        for p in payloads]
