"""Build and load the hand-written CUDA kernels of kernels/csrc/.

Each `.cu` source builds with its own `nvcc` (all started together) into a
shared library with a plain C interface, loaded with ctypes.  Outputs go to
`build/kernels/` at the root of the checkout, named by a hash of the
sources, so a stale library is never loaded.  Nothing here runs at import
time: the first CUDA launch (or `build_all`) builds.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
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
_HEADERS = ("agg_common.cuh", "stream_agg.cuh", "tile_sort.cuh")
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


def _nvcc(cmd, t0: float):
    """Run one nvcc: (return code, its report, seconds from t0 to its end)."""
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=600)
    return p.returncode, p.stdout, time.perf_counter() - t0


def build_all() -> Dict[str, object]:
    """Build every kernel library that is not built yet, one nvcc per
    source, all at once.  Returns BUILD_INFO.  Raises on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not os.path.exists(_lib_path(n))}
    t0 = time.perf_counter()
    done = {}
    if todo:
        nvcc = nvcc_path()
        with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
            jobs = {}
            for name, out in todo.items():
                tmp = out + f".tmp{os.getpid()}"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
                jobs[name] = (pool.submit(_nvcc, cmd, t0), tmp, out)
            done = {name: (f.result(), tmp, out) for name, (f, tmp, out) in jobs.items()}
    failed = []
    for name, ((rc, text, _), tmp, out) in done.items():
        if rc != 0:
            failed.append(f"{name}:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["built"] = sorted(todo)
    # each source's nvcc, from the common start to its end
    BUILD_INFO["source_seconds"] = {n: r[2] for n, (r, _, _) in done.items()}
    BUILD_INFO["ptxas"] = {n: r[1] for n, (r, _, _) in done.items()}
    if todo:
        BUILD_INFO["nvcc"] = subprocess.run(
            [nvcc_path(), "--version"], capture_output=True, text=True
        ).stdout.strip().splitlines()[-1]
    return BUILD_INFO


def _bind(lib: ctypes.CDLL, name: str):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name in ("lane_agg", "radix_hist", "groupby_minmax"):
        run = getattr(lib, f"hdb_{name}")
        run.argtypes = [p, p, ll, i, ctypes.POINTER(StreamSet), p, i, i, i, ll, p]
        info = getattr(lib, f"hdb_{name}_info")
        info.argtypes = [i, ctypes.POINTER(StreamSet), i, i, i, ll, p]
        run.restype = info.restype = ctypes.c_int
        return types.SimpleNamespace(run=run, info=info)
    elif name == "tile_sort":
        fn = lib.hdb_sort_tiles
        fn.argtypes = [p, p, p, ll, i, p, p]
    elif name == "groupby_slots":
        fns = {}
        for kind in ("count", "sum_f32", "sum_int"):
            f = getattr(lib, f"hdb_{kind}_per_slot")
            f.argtypes = [p, p, p, i, ll, i, p, p]
            f.restype = ctypes.c_int
            fns[kind] = f
        return fns
    else:
        part = lib.hdb_radix_partition
        part.argtypes = [p, ll, i, i, i, p, p, p, p, ctypes.POINTER(StreamSet),
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


_COUNT_LOCK = threading.Lock()


def count_launch(counter) -> None:
    """Add one to a wrapper's launch count (`counter.launches`) under a
    lock: the shards of a mesh launch from one host thread a device."""
    with _COUNT_LOCK:
        counter.launches += 1


def stream_ptr(device) -> int:
    """The current stream of `device`.  A launch sets CUDA's current device
    to its tensors' device around the call (`torch.cuda.device`): the
    runtime launches on the calling thread's current device."""
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


# ---- B1, B2 and B3 (csrc/stream_agg.cuh) ----

# shared memory a block may opt in to on sm_90 (227 KB), and the most that
# lets four (two) blocks share an SM's 228 KB, 1 KB reserved a block
SMEM_BLOCK_MAX = 232448
SMEM_FOUR_BLOCKS = 56 * 1024
SMEM_TWO_BLOCKS = 112 * 1024
# stream_agg.cuh MODE of each tier
TIER_MODES = {"shared": 0, "shared_sm": 0, "cluster": 0, "global": 1}


@dataclasses.dataclass(frozen=True)
class AggPlan:
    """How a B1 / B2 / B3 launch holds its cells: tier (shared: a private
    copy a block, two or more blocks an SM; shared_sm: one block an SM;
    cluster: the cells split over the blocks of a thread-block cluster,
    each block scanning the cluster's rows for its own slots; global:
    atomics into the outputs), blocks a cluster, threads a block, dynamic
    shared bytes a block, and slots a block holds."""

    tier: str
    cluster: int
    threads: int
    smem_bytes: int
    slots_per_block: int


def smem_bytes(slots: int, ops) -> int:
    """Shared bytes of `slots` slots' cells as csrc/stream_agg.cuh lays them
    out (sa_smem_bytes, which checks the count at launch): u32 counts, then
    one cell array a stream (SUMI and SUMD 8 bytes a cell, every other class
    4), each from an 8-byte boundary."""
    a8 = lambda x: (x + 7) & ~7  # noqa: E731
    return a8(slots * 4) + sum(a8(slots * (8 if op in ("sumi", "sumd") else 4))
                               for op in ops)


def _stream_set(specs) -> StreamSet:
    """A StreamSet of [(values or None, op, dtype name)], pointers null
    where there are no values."""
    ss = StreamSet()
    ss.n = len(specs)
    for j, (v, op, dt) in enumerate(specs):
        ss.vals[j] = v.data_ptr() if v is not None else None
        ss.op[j] = OP_CODES[op]
        ss.dt[j] = DT_CODES[dt]
    return ss


def stream_info(name: str, num_slots: int, specs, plan: AggPlan) -> dict:
    """What a launch of B1 / B2 / B3 (`name`) with `plan` over streams
    [(op, dtype name)] gets: registers, local and shared bytes, resident
    blocks per SM, threads, cluster size, resident clusters."""
    ss = _stream_set([(None, op, dt) for op, dt in specs])
    out = (ctypes.c_int * 7)()
    check(entry(name).info(num_slots, ctypes.byref(ss), TIER_MODES[plan.tier],
                           plan.cluster, plan.threads, plan.smem_bytes,
                           ctypes.addressof(out)), f"{name} info")
    return dict(registers=out[0], local_bytes=out[1], shared_bytes=out[2],
                blocks_per_sm=out[3], threads=out[4], cluster=out[5],
                resident_clusters=out[6])


def launch_streams(name: str, gid, mask, streams, num_slots: int, plan,
                   counter=None):
    """Launch B1 / B2 / B3 (`name`: lane_agg, radix_hist or groupby_minmax)
    on CUDA tensors.
    `plan(ops)` gives the AggPlan of a launch over streams of those ops;
    `counter.launches` (the wrapper's launch count, if given) rises by one
    per kernel launch.  Returns [counts int64[S]] + one output per stream
    (count/sumi -> int64, sumf/sumd -> float64, min/max -> the value's
    dtype)."""
    import torch

    check_rows(gid, mask, [v for v, _ in streams])
    for v, op in streams:
        if str(v.dtype).replace("torch.", "") not in _ALLOWED.get(op, ()):
            raise ValueError(f"{name}: stream {op!r} does not take {v.dtype}")
    dev = gid.device
    n = gid.shape[0]
    fn = entry(name).run
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
        sp = stream_ptr(dev)
        mptr = mask.data_ptr() if mask is not None else None
        # more than MAX_STREAMS streams: further launches over the same rows,
        # whose counts land in a scratch buffer
        for c0 in range(0, max(len(streams), 1), MAX_STREAMS):
            chunk = streams[c0:c0 + MAX_STREAMS]
            ss = _stream_set([(v, op, str(v.dtype).replace("torch.", ""))
                              for v, op in chunk])
            for j, o in enumerate(outs[c0:c0 + MAX_STREAMS]):
                ss.out[j] = o.data_ptr()
            p = plan([op for _, op in chunk])
            cbuf = counts if c0 == 0 else torch.zeros_like(counts)
            with torch.cuda.device(dev):
                check(fn(gid.data_ptr(), mptr, n, num_slots, ctypes.byref(ss),
                         cbuf.data_ptr(), TIER_MODES[p.tier], p.cluster, p.threads,
                         p.smem_bytes, sp), name)
            if counter is not None:
                count_launch(counter)
    res = [counts]
    for (v, op), o in zip(streams, outs):
        res.append(decode_keys(o, v.dtype) if op in ("min", "max") else o)
    return res
