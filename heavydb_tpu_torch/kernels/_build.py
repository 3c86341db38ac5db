"""Build and load the hand-written CUDA kernels of kernels/csrc/.

Each `.cu` source builds with its own `nvcc` (all started together) into a
shared library with a plain C interface, loaded with ctypes.  Outputs go to
`build/kernels/` at the root of the checkout, named by a hash of the
sources, so a stale library is never loaded.  Nothing here runs at import
time: the first CUDA launch (or `build_all`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "kernels")

# kernel module name -> CUDA source
SOURCES = {
    "lane_agg": "lane_agg.cu",
    "radix_hist": "radix_hist.cu",
    "groupby_minmax": "groupby_minmax.cu",
    "tile_sort": "tile_sort.cu",
    "radix_groupby": "radix_groupby.cu",
    "groupby_slots": "groupby_slots.cu",
}
_HEADERS = ("agg_common.cuh", "tile_sort.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAX_STREAMS = 16

# dtype codes of agg_common.cuh
DT_CODES = {"bool": 0, "int8": 1, "int16": 2, "int32": 3, "int64": 4,
            "float32": 5, "float64": 6}
OP_CODES = {"count": 0, "sumi": 1, "sumf": 2, "sumd": 3, "min": 4, "max": 5}


class StreamSet(ctypes.Structure):
    """Mirror of `struct StreamSet` in csrc/agg_common.cuh."""

    _fields_ = [
        ("vals", ctypes.c_void_p * MAX_STREAMS),
        ("out", ctypes.c_void_p * MAX_STREAMS),
        ("op", ctypes.c_int * MAX_STREAMS),
        ("dt", ctypes.c_int * MAX_STREAMS),
        ("n", ctypes.c_int),
    ]


_LOCK = threading.Lock()
_FNS: Dict[str, object] = {}  # kernel module name -> bound C entry point
# what the last build did: seconds, nvcc version, ptxas report per source
BUILD_INFO: Dict[str, object] = {}


def nvcc_path() -> str:
    p = shutil.which("nvcc")
    if p is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        p = "/usr/local/cuda/bin/nvcc"
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return p


def _digest(src: str) -> str:
    h = hashlib.sha256()
    for name in (src,) + _HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(SOURCES[name])}.so")


def build_all() -> Dict[str, object]:
    """Build every kernel library that is not built yet, one nvcc per
    source, all at once.  Returns BUILD_INFO.  Raises on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not os.path.exists(_lib_path(n))}
    t0 = time.perf_counter()
    procs = {}
    if todo:
        nvcc = nvcc_path()
        for name, out in todo.items():
            tmp = out + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
    reports = {}
    failed = []
    for name, (p, tmp, out) in procs.items():
        text, _ = p.communicate(timeout=600)
        reports[name] = text
        if p.returncode != 0:
            failed.append(f"{name}:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["built"] = sorted(todo)
    BUILD_INFO["ptxas"] = reports
    if todo:
        BUILD_INFO["nvcc"] = subprocess.run(
            [nvcc_path(), "--version"], capture_output=True, text=True
        ).stdout.strip().splitlines()[-1]
    return BUILD_INFO


def _bind(lib: ctypes.CDLL, name: str):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "lane_agg":
        fn = lib.hdb_lane_agg
        fn.argtypes = [p, p, ll, i, ctypes.POINTER(StreamSet), p, i, i, p]
    elif name == "radix_hist":
        fn = lib.hdb_radix_hist
        fn.argtypes = [p, p, ll, i, ctypes.POINTER(StreamSet), p, i, i, p]
    elif name == "groupby_minmax":
        fn = lib.hdb_minmax
        fn.argtypes = [p, p, p, i, ll, i, i, p, i, i, p]
    elif name == "tile_sort":
        fn = lib.hdb_sort_tiles
        fn.argtypes = [p, p, p, ll, i, p, p]
    elif name == "groupby_slots":
        fns = {}
        for kind in ("count", "sum_f32", "sum_int"):
            f = getattr(lib, f"hdb_{kind}_per_slot")
            f.argtypes = [p, p, p, i, ll, i, p, i, i, p]
            f.restype = ctypes.c_int
            fns[kind] = f
        return fns
    else:
        part = lib.hdb_radix_partition
        part.argtypes = [p, ll, i, i, p, p, p, ctypes.POINTER(StreamSet), i, i,
                         i, p]
        part.restype = ctypes.c_int
        group = lib.hdb_radix_group
        group.argtypes = [p, ctypes.POINTER(StreamSet),
                          ctypes.POINTER(StreamSet), p, p, i, i, i, i, p, p, p,
                          p, p, ll, p, p, i, i, p]
        group.restype = ctypes.c_int
        info = lib.hdb_radix_info
        info.argtypes = [i, i, p]
        info.restype = ctypes.c_int
        return types.SimpleNamespace(partition=part, group=group, info=info)
    fn.restype = ctypes.c_int
    return fn


def entry(name: str):
    """The bound C entry point of kernel module `name` (builds and loads
    every kernel library on first use)."""
    with _LOCK:
        if not _FNS:
            build_all()
            for n in SOURCES:
                _FNS[n] = _bind(ctypes.CDLL(_lib_path(n)), n)
    return _FNS[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def launch_info(call, what: str) -> dict:
    """Run an entry point's kernel_info query (csrc/agg_common.cuh):
    `call(out)` passes the address of five ints for it to fill."""
    out = (ctypes.c_int * 5)()
    check(call(ctypes.addressof(out)), what)
    return dict(registers=out[0], local_bytes=out[1], shared_bytes=out[2],
                blocks_per_sm=out[3], threads=out[4])


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


_SM_COUNT: Dict[int, int] = {}


def grid_for(n: int, device, blocks_per_sm: int, block: int = 256) -> int:
    """Blocks for a grid-stride launch: enough to cover n, at most
    blocks_per_sm on each SM."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SM_COUNT.get(idx)
    if sms is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _SM_COUNT[idx] = sms
    return int(max(1, min(-(-n // block), sms * blocks_per_sm)))


def key_ident(dtype, is_min: bool) -> int:
    """Identity key of csrc/agg_common.cuh key_ident."""
    import torch

    if dtype == torch.float32:
        return 0x7F800000 if is_min else -0x7F800001  # keys of +inf / -inf
    return 2**31 - 1 if is_min else -(2**31)


def decode_keys(keys, dtype):
    """int32 keys (agg_common.cuh f32_key) -> values of `dtype`."""
    import torch

    if dtype == torch.float32:
        return torch.where(keys < 0, keys ^ 0x7FFFFFFF, keys).view(torch.float32)
    return keys


def check_rows(gid, mask, n_values=()):
    import torch

    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError("gid must be a contiguous 1-D int32 tensor")
    n = gid.shape[0]
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (n,)
                             or not mask.is_contiguous()
                             or mask.device != gid.device):
        raise ValueError("mask must be a contiguous bool tensor like gid")
    for v in n_values:
        if v.shape != (n,) or not v.is_contiguous() or v.device != gid.device:
            raise ValueError("stream values must be contiguous, like gid")


_ALLOWED = {
    "count": ("bool",),
    "sumi": ("bool", "int8", "int16", "int32", "int64"),
    "sumf": ("float32",),
    "sumd": ("float32", "float64"),
    "min": ("int32", "float32"),
    "max": ("int32", "float32"),
}


def launch_streams(name: str, gid, mask, streams, num_slots: int,
                   blocks_per_sm: int = 4, block: int = 256, counter=None):
    """Launch the StreamSet kernel `name` (lane_agg or radix_hist) on CUDA
    tensors; `counter.launches` (the wrapper's launch count, if given)
    rises by one per kernel launch.  Returns [counts int64[S]] + one output
    per stream (count/sumi -> int64, sumf/sumd -> float64, min/max -> the
    value's dtype)."""
    import torch

    check_rows(gid, mask, [v for v, _ in streams])
    for v, op in streams:
        if str(v.dtype).replace("torch.", "") not in _ALLOWED.get(op, ()):
            raise ValueError(f"{name}: stream {op!r} does not take {v.dtype}")
    dev = gid.device
    n = gid.shape[0]
    fn = entry(name)
    counts = torch.zeros(num_slots, dtype=torch.int64, device=dev)
    outs = []
    for v, op in streams:
        if op in ("count", "sumi"):
            outs.append(torch.zeros(num_slots, dtype=torch.int64, device=dev))
        elif op in ("sumf", "sumd"):
            outs.append(torch.zeros(num_slots, dtype=torch.float64, device=dev))
        else:
            outs.append(torch.full((num_slots,), key_ident(v.dtype, op == "min"),
                                   dtype=torch.int32, device=dev))
    if n:
        grid = grid_for(n, dev, blocks_per_sm, block)
        sp = stream_ptr(dev)
        mptr = mask.data_ptr() if mask is not None else None
        # more than MAX_STREAMS streams: further launches over the same rows,
        # whose counts land in a scratch buffer
        for c0 in range(0, max(len(streams), 1), MAX_STREAMS):
            chunk = list(range(c0, min(c0 + MAX_STREAMS, len(streams))))
            ss = StreamSet()
            ss.n = len(chunk)
            for j, si in enumerate(chunk):
                v, op = streams[si]
                ss.vals[j] = v.data_ptr()
                ss.out[j] = outs[si].data_ptr()
                ss.op[j] = OP_CODES[op]
                ss.dt[j] = DT_CODES[str(v.dtype).replace("torch.", "")]
            cbuf = counts if c0 == 0 else torch.zeros_like(counts)
            check(fn(gid.data_ptr(), mptr, n, num_slots, ctypes.byref(ss),
                     cbuf.data_ptr(), grid, block, sp), name)
            if counter is not None:
                counter.launches += 1
    res = [counts]
    for (v, op), o in zip(streams, outs):
        res.append(decode_keys(o, v.dtype) if op in ("min", "max") else o)
    return res
