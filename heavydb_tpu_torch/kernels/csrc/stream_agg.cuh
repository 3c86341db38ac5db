// The shared body of B1 (lane_agg.cu) and B2 (radix_hist.cu): per-slot
// counts and up to HDB_MAX_STREAMS value streams (agg_common.cuh's classes)
// in one pass over the rows.
//
// Bound: bytes read (gid 4 B/row, the mask 1 B/row, each stream at its own
// width, nothing widened before the launch) and the per-slot outputs written
// once.  What the design does about it:
//  - Rows go as tiles: each thread loads SA_VECS vectors of 4 rows (an int4
//    of gid, one 32-bit word of the mask) and keeps their slot ids in
//    registers, -1 for a row that does not contribute.
//  - Streams go outer, one switch on (op, dtype) a tile and stream into a
//    routine templated on that class, which loads the stream's values for
//    the thread's rows as vectors (a 32-bit word of bool/int8, a uint2 of
//    int16, an int4/float4 of 4-byte values, two longlong2 of 8-byte
//    values) and adds them.  (Prefetching the tile's rows of every stream
//    into L2 first gained 2-9 % with 4-6 streams and lost 17 % with 16,
//    PERF.md section 6, so the loads stay as they are.)
//  - Rows before gid's first 16-byte boundary and after the last whole
//    vector (at most 3 + 3) take a one-row path in the first block (or
//    cluster).  A stream or mask that does not line up with gid there loads
//    its 4 values one by one inside the vector path.
//  - Integer sums keep each cell as two u32 words and add with native
//    32-bit atomics: atomicAdd of the low word returns the old value, whose
//    carry goes with the high word into a second add, made only when
//    nonzero.  The sum stays exact mod 2^64; a 64-bit shared add would be a
//    compare-and-swap loop.  Counts and MIN/MAX keys are native too; the
//    f32 and f64 shared adds stay compare-and-swap loops.
//  - Where the cells live (MODE): SA_SHARED, in shared memory, merged once
//    into the global outputs: one private copy a block, or, past one
//    block's 227 KB, split over the C blocks of a thread-block cluster,
//    slot g in block g % C at cell g / C.  Every block of the
//    cluster scans the cluster's rows and adds only the slots it owns into
//    its own shared memory, so no add crosses SMs: the C blocks read each
//    row, the first from device memory and the others, co-scheduled by the
//    cluster, mostly from L2, and a block loads values only for 4-row
//    vectors that hold a row of its own.  Adds into the owner's cells over
//    distributed shared memory (mapa, red.shared::cluster) were measured
//    slower than this (PERF.md section 6).  SA_GLOBAL, straight global
//    atomics into the outputs.  The wrapper picks the mode
//    and the cluster size on the host (kernels/lane_agg.py,
//    kernels/radix_hist.py `plan`).
//
// Precision, as agg_common.cuh's stream classes promise: SUMF adds in f32
// within a block and in f64 across blocks; SUMD in f64; a NaN or +-inf
// stays in its slot; MIN/MAX through agg_common.cuh's int32 keys.
#pragma once

#include <stdint.h>
#include <string.h>

#include "agg_common.cuh"

enum { SA_SHARED = 0, SA_GLOBAL = 1 };

// 4-row vectors a thread loads a tile
#define SA_VECS 2
// shared memory a block may opt in to on sm_90 (227 KB)
#define SA_MAX_SMEM 232448

// A block's cells for P slots in its shared memory: u32 counts from byte
// 0, then one cell array a stream (SUMI two u32 words and SUMD an f64 a
// cell, every other class a 32-bit word), each from an 8-byte boundary.
// The kernel steps through the arrays with sa_next; the wrapper plans with
// the same sizes (kernels/_build.py smem_bytes) and passes its byte count,
// which sa_run checks against sa_smem_bytes.  (Reading the offsets from a
// kernel argument instead cost 12-18 % on the H100, PERF.md section 6.)
__host__ __device__ __forceinline__ size_t sa_next(size_t off, int P, int op) {
  return off + (((size_t)P * ((op == OP_SUMI || op == OP_SUMD) ? 8 : 4) + 7) & ~(size_t)7);
}
__host__ __device__ __forceinline__ size_t sa_first(int P) {
  return ((size_t)P * 4 + 7) & ~(size_t)7;
}
static inline size_t sa_smem_bytes(int P, const StreamSet& ss) {
  size_t off = sa_first(P);
  for (int k = 0; k < ss.n; ++k) off = sa_next(off, P, ss.op[k]);
  return off;
}

static inline int sa_width(int dt) {
  switch (dt) {
    case DT_BOOL:
    case DT_I8: return 1;
    case DT_I16: return 2;
    case DT_I32:
    case DT_F32: return 4;
    default: return 8;
  }
}

static inline bool sa_valid(int op, int dt, bool minmax) {
  switch (op) {
    case OP_COUNT: return dt == DT_BOOL;
    case OP_SUMI: return dt >= DT_BOOL && dt <= DT_I64;
    case OP_SUMF: return dt == DT_F32;
    case OP_SUMD: return dt == DT_F32 || dt == DT_F64;
    case OP_MIN:
    case OP_MAX: return minmax && (dt == DT_I32 || dt == DT_F32);
  }
  return false;
}

// The (op, value type) classes, for the switches of the tile and the row.
#define SA_SUM_CLASSES(X)                 \
  X(OP_COUNT, DT_BOOL, unsigned char)     \
  X(OP_SUMI, DT_BOOL, unsigned char)      \
  X(OP_SUMI, DT_I8, signed char)          \
  X(OP_SUMI, DT_I16, short)               \
  X(OP_SUMI, DT_I32, int)                 \
  X(OP_SUMI, DT_I64, long long)           \
  X(OP_SUMF, DT_F32, float)               \
  X(OP_SUMD, DT_F32, float)               \
  X(OP_SUMD, DT_F64, double)
#define SA_MINMAX_CLASSES(X) \
  X(OP_MIN, DT_I32, int)     \
  X(OP_MIN, DT_F32, float)   \
  X(OP_MAX, DT_I32, int)     \
  X(OP_MAX, DT_F32, float)

// What a class accumulates (A) from one value (of).
template <int OP>
struct SAOp;
template <>
struct SAOp<OP_COUNT> {
  typedef unsigned A;
  template <class V>
  static __device__ __forceinline__ A of(V x) { return x != 0 ? 1u : 0u; }
};
template <>
struct SAOp<OP_SUMI> {
  typedef unsigned long long A;
  template <class V>
  static __device__ __forceinline__ A of(V x) { return (A)(long long)x; }
};
template <>
struct SAOp<OP_SUMF> {
  typedef float A;
  static __device__ __forceinline__ A of(float x) { return x; }
};
template <>
struct SAOp<OP_SUMD> {
  typedef double A;
  template <class V>
  static __device__ __forceinline__ A of(V x) { return (double)x; }
};
template <>
struct SAOp<OP_MIN> {
  typedef int A;
  static __device__ __forceinline__ A of(int x) { return x; }
  static __device__ __forceinline__ A of(float x) { return f32_key(x, true); }
};
template <>
struct SAOp<OP_MAX> {
  typedef int A;
  static __device__ __forceinline__ A of(int x) { return x; }
  static __device__ __forceinline__ A of(float x) { return f32_key(x, false); }
};

// Exact 64-bit add as native 32-bit adds: the low word's carry rides with
// the high word.
__device__ __forceinline__ void sa_add_halves(unsigned* cell, unsigned long long x) {
  const unsigned lo = (unsigned)x;
  unsigned hi = (unsigned)(x >> 32);
  if (lo) {
    const unsigned old = atomicAdd(cell, lo);
    hi += (old + lo < old) ? 1u : 0u;
  }
  if (hi) atomicAdd(cell + 1, hi);
}

// Add a partial of class OP to cell g.  In shared memory: u32 counts, SUMI
// halves, f32 SUMF, f64 SUMD, int32 keys; in the global outputs (SA_GLOBAL):
// u64 counts and SUMI, f64 sums.  Zero sums are not added.
template <int MODE, int OP>
__device__ __forceinline__ void sa_put(void* arr, int g, typename SAOp<OP>::A a) {
  if constexpr (OP == OP_COUNT) {
    if (a == 0u) return;
    if constexpr (MODE == SA_GLOBAL)
      atomicAdd((unsigned long long*)arr + g, (unsigned long long)a);
    else
      atomicAdd((unsigned*)arr + g, a);
  } else if constexpr (OP == OP_SUMI) {
    if (a == 0ull) return;
    if constexpr (MODE == SA_GLOBAL)
      atomicAdd((unsigned long long*)arr + g, a);
    else
      sa_add_halves((unsigned*)((uint2*)arr + g), a);
  } else if constexpr (OP == OP_SUMF) {
    if (a == 0.f) return;  // NaN != 0: added
    if constexpr (MODE == SA_GLOBAL)
      atomicAdd((double*)arr + g, (double)a);
    else
      atomicAdd((float*)arr + g, a);
  } else if constexpr (OP == OP_SUMD) {
    if (a == 0.0) return;
    atomicAdd((double*)arr + g, a);
  } else if constexpr (OP == OP_MIN) {
    atomicMin((int*)arr + g, a);
  } else {
    atomicMax((int*)arr + g, a);
  }
}

// Values of rows r0 .. r0 + 3: one vector load where `vec` (the stream lines
// up with gid's 16-byte boundary), else four scalar loads.
template <class V>
__device__ __forceinline__ void sa_load4(const void* p, long long r0, bool vec, V (&x)[4]) {
  const V* v = (const V*)p + r0;
  if (vec) {
    if constexpr (sizeof(V) == 1) {
      const unsigned w = *(const unsigned*)v;
      memcpy(x, &w, 4);
    } else if constexpr (sizeof(V) == 2) {
      const uint2 w = *(const uint2*)v;
      memcpy(x, &w, 8);
    } else if constexpr (sizeof(V) == 4) {
      const int4 w = *(const int4*)v;
      memcpy(x, &w, 16);
    } else {
      const longlong2 a = ((const longlong2*)v)[0];
      const longlong2 b = ((const longlong2*)v)[1];
      memcpy(x, &a, 16);
      memcpy(x + 2, &b, 16);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = v[j];
  }
}

// One stream's values for the thread's tile rows, added into its cells.
template <int MODE, int OP, class V>
__device__ __forceinline__ void sa_tile_stream(void* arr, const void* vals, bool vec,
                                               const long long (&r0)[SA_VECS],
                                               const int (&g)[SA_VECS][4]) {
  V x[SA_VECS][4];
#pragma unroll
  for (int u = 0; u < SA_VECS; ++u) {
    if (r0[u] >= 0) {
      sa_load4(vals, r0[u], vec, x[u]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[u][j] = (V)0;
    }
  }
#pragma unroll
  for (int u = 0; u < SA_VECS; ++u) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (g[u][j] >= 0) sa_put<MODE, OP>(arr, g[u][j], SAOp<OP>::of(x[u][j]));
  }
}

// One row on its own (the head and tail rows): the count and every stream,
// if its slot is this block's (rank of a group of 1 << shift).
template <int MODE, bool MINMAX>
__device__ __forceinline__ void sa_row(long long r, const int* __restrict__ gid,
                                       const unsigned char* __restrict__ mask, int S, int P,
                                       int shift, int rank, const StreamSet& ss,
                                       unsigned char* smem, unsigned long long* __restrict__ counts) {
  int g;
  if (!row_slot(gid, mask, r, S, &g) || (g & ((1 << shift) - 1)) != rank) return;
  g >>= shift;
  sa_put<MODE, OP_COUNT>(MODE == SA_GLOBAL ? (void*)counts : (void*)smem, g, 1u);
  size_t off = sa_first(P);
  for (int k = 0; k < ss.n; ++k) {
    void* arr = MODE == SA_GLOBAL ? ss.out[k] : (void*)(smem + off);
    off = sa_next(off, P, ss.op[k]);
    const void* vals = ss.vals[k];
    switch (ss.op[k] * 8 + ss.dt[k]) {
#define SA_ROW_CASE(OPC, DTC, V) \
  case OPC * 8 + DTC:            \
    sa_put<MODE, OPC>(arr, g, SAOp<OPC>::of(((const V*)vals)[r])); \
    break;
      SA_SUM_CLASSES(SA_ROW_CASE)
      default:
        if constexpr (MINMAX) {
          switch (ss.op[k] * 8 + ss.dt[k]) { SA_MINMAX_CLASSES(SA_ROW_CASE) }
        }
#undef SA_ROW_CASE
    }
  }
}

// Every one of this block's P cells an array at its identity.
__device__ __forceinline__ void sa_init(unsigned char* smem, int P, const StreamSet& ss) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    ((unsigned*)smem)[i] = 0u;
    size_t off = sa_first(P);
    for (int k = 0; k < ss.n; ++k) {
      unsigned char* a = smem + off;
      off = sa_next(off, P, ss.op[k]);
      switch (ss.op[k]) {
        case OP_COUNT: ((unsigned*)a)[i] = 0u; break;
        case OP_SUMI: ((uint2*)a)[i] = make_uint2(0u, 0u); break;
        case OP_SUMF: ((float*)a)[i] = 0.f; break;
        case OP_SUMD: ((double*)a)[i] = 0.0; break;
        case OP_MIN: ((int*)a)[i] = key_ident(ss.dt[k], true); break;
        case OP_MAX: ((int*)a)[i] = key_ident(ss.dt[k], false); break;
      }
    }
  }
}

// This block's cells into the global outputs: local slot i is slot
// (i << shift) | rank; slots no row reached are skipped.
__device__ __forceinline__ void sa_merge(const unsigned char* smem, int P, int rank, int shift,
                                         int S, const StreamSet& ss,
                                         unsigned long long* __restrict__ counts) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int g = (i << shift) | rank;
    if (g >= S) break;
    const unsigned c = ((const unsigned*)smem)[i];
    if (c == 0u) continue;
    atomicAdd(counts + g, (unsigned long long)c);
    size_t off = sa_first(P);
    for (int k = 0; k < ss.n; ++k) {
      const unsigned char* a = smem + off;
      off = sa_next(off, P, ss.op[k]);
      switch (ss.op[k]) {
        case OP_COUNT: {
          const unsigned x = ((const unsigned*)a)[i];
          if (x) atomicAdd((unsigned long long*)ss.out[k] + g, (unsigned long long)x);
        } break;
        case OP_SUMI: {
          const uint2 h = ((const uint2*)a)[i];
          const unsigned long long x = ((unsigned long long)h.y << 32) | h.x;
          if (x) atomicAdd((unsigned long long*)ss.out[k] + g, x);
        } break;
        case OP_SUMF: {
          const double x = (double)((const float*)a)[i];
          if (x != 0.0) atomicAdd((double*)ss.out[k] + g, x);
        } break;
        case OP_SUMD: {
          const double x = ((const double*)a)[i];
          if (x != 0.0) atomicAdd((double*)ss.out[k] + g, x);
        } break;
        case OP_MIN: atomicMin((int*)ss.out[k] + g, ((const int*)a)[i]); break;
        case OP_MAX: atomicMax((int*)ss.out[k] + g, ((const int*)a)[i]); break;
      }
    }
  }
}

// Rows [head, head + 4 nvec) go as 4-row vectors, the rest one at a time.
// vec_bits: bit k set where stream k's vectors are aligned, bit 16 where the
// mask's are.  The blocks form groups of C = 1 << shift (a cluster, or
// single blocks); the blocks of a group scan the same rows, and block
// `rank` of its group takes the slots g with g % C == rank, at cell g / C of
// its own shared memory, whose P cells it merges.
template <int MODE, bool MINMAX, int THREADS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
    stream_agg_kernel(const int* __restrict__ gid, const unsigned char* __restrict__ mask,
                      long long n, int S, long long head, long long nvec, unsigned vec_bits,
                      int P, int shift, StreamSet ss, unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char sa_smem[];
  const int cmask = (1 << shift) - 1;
  const int rank = (int)blockIdx.x & cmask;
  if constexpr (MODE != SA_GLOBAL) {
    sa_init(sa_smem, P, ss);
    __syncthreads();
  }
  void* carr = MODE == SA_GLOBAL ? (void*)counts : (void*)sa_smem;
  const bool mvec = (vec_bits >> 16) & 1u;
  // vectors a sweep of all groups covers
  const long long stride = (long long)(gridDim.x >> shift) * THREADS;
  for (long long q0 = (long long)(blockIdx.x >> shift) * THREADS + threadIdx.x; q0 < nvec;
       q0 += stride * SA_VECS) {
    long long r0[SA_VECS];
    int g[SA_VECS][4];
#pragma unroll
    for (int u = 0; u < SA_VECS; ++u) {
      const long long q = q0 + (long long)u * stride;
      r0[u] = -1;
      g[u][0] = g[u][1] = g[u][2] = g[u][3] = -1;
      if (q < nvec) {
        const long long r = head + 4 * q;
        const int4 gv = *(const int4*)(gid + r);
        unsigned m = 0x01010101u;
        if (mask != nullptr) {
          if (mvec)
            m = *(const unsigned*)(mask + r);
          else
            m = (unsigned)mask[r] | ((unsigned)mask[r + 1] << 8) |
                ((unsigned)mask[r + 2] << 16) | ((unsigned)mask[r + 3] << 24);
        }
        const int v[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if ((unsigned)v[j] < (unsigned)S && ((m >> (8 * j)) & 0xFFu) &&
              (v[j] & cmask) == rank)
            g[u][j] = v[j] >> shift;
        // a vector with no row of this block loads no values
        if (max(max(g[u][0], g[u][1]), max(g[u][2], g[u][3])) >= 0) r0[u] = r;
      }
    }
#pragma unroll
    for (int u = 0; u < SA_VECS; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g[u][j] >= 0) sa_put<MODE, OP_COUNT>(carr, g[u][j], 1u);
    }
    size_t off = sa_first(P);
    for (int k = 0; k < ss.n; ++k) {
      void* arr = MODE == SA_GLOBAL ? ss.out[k] : (void*)(sa_smem + off);
      off = sa_next(off, P, ss.op[k]);
      const void* vals = ss.vals[k];
      const bool vec = (vec_bits >> k) & 1u;
      switch (ss.op[k] * 8 + ss.dt[k]) {
#define SA_TILE_CASE(OPC, DTC, V)                              \
  case OPC * 8 + DTC:                                          \
    sa_tile_stream<MODE, OPC, V>(arr, vals, vec, r0, g);       \
    break;
        SA_SUM_CLASSES(SA_TILE_CASE)
        default:
          if constexpr (MINMAX) {
            switch (ss.op[k] * 8 + ss.dt[k]) { SA_MINMAX_CLASSES(SA_TILE_CASE) }
          }
#undef SA_TILE_CASE
      }
    }
  }
  if ((blockIdx.x >> shift) == 0) {
    const long long t = threadIdx.x, tail0 = head + 4 * nvec;
    if (t < head)
      sa_row<MODE, MINMAX>(t, gid, mask, S, P, shift, rank, ss, sa_smem, counts);
    else if (t - head < n - tail0)
      sa_row<MODE, MINMAX>(tail0 + (t - head), gid, mask, S, P, shift, rank, ss, sa_smem,
                           counts);
  }
  if constexpr (MODE != SA_GLOBAL) {
    __syncthreads();
    sa_merge(sa_smem, P, rank, shift, S, ss, counts);
  }
}

// Launch one instantiation (info == nullptr), or fill info[0..6] with its
// registers, local bytes, shared bytes a block, resident blocks per SM,
// threads, cluster size and, for a cluster, the clusters resident at once.
// counts and every output are zeroed (MIN/MAX at their identity) by the
// caller.  C: blocks of a cluster (2 or 4), or 1 for no cluster.  smem:
// the shared bytes a block the wrapper planned (0 for SA_GLOBAL), which
// must be sa_smem_bytes of P = ceil(S / C) slots.
template <int MODE, bool MINMAX, int THREADS>
static int sa_run(const int* gid, const unsigned char* mask, long long n, int S,
                  const StreamSet* ss, unsigned long long* counts, int C, long long smem,
                  void* stream, int* info) {
  if (S <= 0 || ss->n < 0 || ss->n > HDB_MAX_STREAMS || ((uintptr_t)gid & 3) != 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < ss->n; ++k)
    if (!sa_valid(ss->op[k], ss->dt[k], MINMAX)) return (int)cudaErrorInvalidValue;
  if (!(C == 1 || C == 2 || C == 4) || (C > 1 && MODE != SA_SHARED))
    return (int)cudaErrorInvalidValue;
  const int shift = C / 2;  // log2 C
  const int P = (S + C - 1) / C;
  if (smem != (MODE == SA_GLOBAL ? 0 : (long long)sa_smem_bytes(P, *ss)) || smem > SA_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  void (*fn)(const int*, const unsigned char*, long long, int, long long, long long, unsigned,
             int, int, StreamSet, unsigned long long*) =
      stream_agg_kernel<MODE, MINMAX, THREADS>;
  int rc = set_smem((const void*)fn, smem);
  if (rc) return rc;
  cudaError_t e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  int clusters = 0;
  if (C > 1) {
    e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)fn, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  }
  if (info != nullptr) {
    rc = kernel_info((const void*)fn, THREADS, smem, info);
    info[5] = C;
    info[6] = clusters;
    return rc;
  }
  if (n <= 0) return 0;
  // vectors from gid's first 16-byte boundary; a stream or the mask whose
  // rows there do not line up loads its vectors one value at a time
  long long head = (long long)(((16 - ((uintptr_t)gid & 15)) & 15) / 4);
  if (head > n) head = n;
  const long long nvec = (n - head) / 4;
  unsigned vec_bits = 0u;
  for (int k = 0; k < ss->n; ++k) {
    const int w = sa_width(ss->dt[k]);
    const uintptr_t need = w >= 4 ? 16 : 4 * w;
    if (((uintptr_t)ss->vals[k] + head * w) % need == 0) vec_bits |= 1u << k;
  }
  if (mask == nullptr || ((uintptr_t)mask + head) % 4 == 0) vec_bits |= 1u << 16;
  long long work = (nvec + (long long)THREADS * SA_VECS - 1) / ((long long)THREADS * SA_VECS);
  if (work < 1) work = 1;
  int grid;
  if (C > 1) {
    // a cluster's blocks scan the same rows: as many clusters as blocks
    // one copy of the rows would take, at most those resident at once
    grid = (int)(work < clusters ? work : clusters) * C;
  } else {
    rc = resident_grid((const void*)fn, THREADS, smem, work, &grid);
    if (rc) return rc;
  }
  cfg.gridDim = dim3((unsigned)grid);
  e = cudaLaunchKernelEx(&cfg, fn, gid, mask, n, S, head, nvec, vec_bits, P, shift, *ss, counts);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
