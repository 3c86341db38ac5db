// B3a-c: per-slot COUNT, float32 SUM and exact integer SUM over 1..65536
// slots, one value stream each, one pass over the rows.
//
// Replaces the TPU kernels of heavydb_tpu/kernels/groupby_pallas.py:
//   hdb_count_per_slot    <- count_per_slot    (pallas_call :142)
//   hdb_sum_f32_per_slot  <- sum_f32_per_slot  (pallas_call :177)
//   hdb_sum_int_per_slot  <- sum_int_per_slot  (pallas_call :243)
// On the TPU each grid step built a [block, slots] one-hot in VMEM and summed
// it on the matrix unit; integer sums travelled as four 8-bit limbs of the
// value biased by 2^31, so that f32 dots stayed exact.  Hopper has atomics,
// so each of the three is a plain histogram:
//  - while S cells fit in 96 KB of shared memory (u32 counts and f32 sums up
//    to 24576 slots, u64 integer sums up to 12288), every block accumulates
//    its rows into a private copy of the slots with shared-memory atomics, so
//    rows of one slot collide only within a block, and then adds each
//    nonzero cell once into the global u64 / f64 outputs;
//  - above that, every row adds straight into the global outputs.
//
// Contracts kept from the TPU kernels: a row counts when its slot id lies in
// [0, S) and its mask byte (if a mask is given) is nonzero; other rows are
// not read past their id and mask.  Float sums add in f32 within a block and
// in f64 across blocks (the wrapper rounds to f32 once), and a NaN or +-inf
// stays in its own slot (the one-hot product spread it to every slot).
// Integer sums add each value's two's-complement int32, (long long)(int)x,
// exactly in 64 bits: the TPU kernel's +2^31 bias and uint32 cast gives the
// same wrap for int64 values outside the int32 range.
//
// Bound: bytes read (gid 4 B/row, the mask 1 B/row, values 4 or 8 B/row).
// One row a thread at a time keeps too few bytes in flight to cover the
// memory latency, so each thread loads 4 rows at a time (an int4 of gid, a
// 4-byte word of the mask, a float4 / int4 / two longlong2 of values),
// Op::VECS such vectors before its first atomic, from the first 16-byte
// boundary of gid on; rows before it and after the last whole vector, or
// every row when the mask or values do not line up with gid, take the
// one-row path.  Blocks of 256 threads, as many as stay resident (8 an SM
// while the cells are small).  On sm_90a the shared-memory count compiles
// to a native increment (ATOMS.POPC.INC), the f32 and u64 adds to
// compare-and-swap loops (ATOMS.CAST.SPIN; cuobjdump -sass).
#include <stdint.h>

#include "agg_common.cuh"

#define SLOTS_BLOCK 256
#define SLOTS_PRIVATE_MAX_SMEM (96 * 1024)

// One accumulation per kernel: the block-private cell, the global output
// cell, the value bytes of a row (VB), the 4-row vectors a thread loads
// before its first atomic (VECS: 2 where the cell is 64-bit, which takes
// twice the registers a value and a compare-and-swap loop an add) and
// what one row, or one 4-row vector q (16-byte aligned), adds.
struct CountOp {
  typedef unsigned int Cell;
  typedef unsigned long long Out;
  static constexpr int VB = 0;
  static constexpr int VECS = 4;
  static __device__ __forceinline__ Cell load(const void*, long long) { return 1u; }
  static __device__ __forceinline__ void load4(const void*, long long, Cell (&c)[4]) {
    c[0] = c[1] = c[2] = c[3] = 1u;
  }
};

struct SumF32Op {
  typedef float Cell;
  typedef double Out;
  static constexpr int VB = 4;
  static constexpr int VECS = 4;
  static __device__ __forceinline__ Cell load(const void* v, long long r) {
    return ((const float*)v)[r];
  }
  static __device__ __forceinline__ void load4(const void* v, long long q, Cell (&c)[4]) {
    const float4 x = ((const float4*)v)[q];
    c[0] = x.x, c[1] = x.y, c[2] = x.z, c[3] = x.w;
  }
};

struct SumI32Op {
  typedef unsigned long long Cell;
  typedef unsigned long long Out;
  static constexpr int VB = 4;
  static constexpr int VECS = 2;
  static __device__ __forceinline__ Cell load(const void* v, long long r) {
    return (Cell)(long long)((const int*)v)[r];
  }
  static __device__ __forceinline__ void load4(const void* v, long long q, Cell (&c)[4]) {
    const int4 x = ((const int4*)v)[q];
    c[0] = (Cell)(long long)x.x, c[1] = (Cell)(long long)x.y;
    c[2] = (Cell)(long long)x.z, c[3] = (Cell)(long long)x.w;
  }
};

struct SumI64WrapOp {
  typedef unsigned long long Cell;
  typedef unsigned long long Out;
  static constexpr int VB = 8;
  static constexpr int VECS = 2;
  // the low 32 bits, read as a signed int32
  static __device__ __forceinline__ Cell wrap(long long x) {
    return (Cell)(long long)(int)(unsigned int)x;
  }
  static __device__ __forceinline__ Cell load(const void* v, long long r) {
    return wrap(((const long long*)v)[r]);
  }
  static __device__ __forceinline__ void load4(const void* v, long long q, Cell (&c)[4]) {
    const longlong2 a = ((const longlong2*)v)[2 * q];
    const longlong2 b = ((const longlong2*)v)[2 * q + 1];
    c[0] = wrap(a.x), c[1] = wrap(a.y), c[2] = wrap(b.x), c[3] = wrap(b.y);
  }
};

// PRIVATE: one block-private copy of the S cells in shared memory, merged
// into `out` at the end (a copy a warp tied or lost, PERF.md section 6);
// else straight global atomics.  Rows [head, head + 4 nvec) go as vectors, the
// rest one row at a time.
template <class Op, bool PRIVATE>
__global__ void __launch_bounds__(SLOTS_BLOCK)
    slots_kernel(const int* __restrict__ gid, const unsigned char* __restrict__ mask,
                 const void* __restrict__ vals, long long n, int S, long long head,
                 long long nvec, typename Op::Out* __restrict__ out) {
  typedef typename Op::Cell Cell;
  typedef typename Op::Out Out;
  extern __shared__ __align__(16) unsigned char slot_smem[];
  Cell* acc = (Cell*)slot_smem;
  if (PRIVATE) {
    for (int i = threadIdx.x; i < S; i += SLOTS_BLOCK) acc[i] = (Cell)0;
    __syncthreads();
  }
  auto add = [&](int g, Cell x) {
    if (PRIVATE)
      atomicAdd(acc + g, x);
    else
      atomicAdd(out + g, (Out)x);
  };
  const long long tid = (long long)blockIdx.x * SLOTS_BLOCK + threadIdx.x;
  const long long stride = (long long)gridDim.x * SLOTS_BLOCK;
  auto one = [&](long long r) {
    int g;
    if (row_slot(gid, mask, r, S, &g)) add(g, Op::load(vals, r));
  };
  for (long long r = tid; r < head; r += stride) one(r);
  for (long long r = head + 4 * nvec + tid; r < n; r += stride) one(r);
  const int4* g4 = (const int4*)(gid + head);
  const unsigned* m4 = mask != nullptr ? (const unsigned*)(mask + head) : nullptr;
  const void* v4 = Op::VB ? (const void*)((const char*)vals + head * Op::VB) : nullptr;
  for (long long q0 = tid; q0 < nvec; q0 += stride * Op::VECS) {
    int4 g[Op::VECS];
    unsigned m[Op::VECS];
    Cell c[Op::VECS][4];
#pragma unroll
    for (int u = 0; u < Op::VECS; ++u) {
      const long long q = q0 + u * stride;
      if (q < nvec) {
        g[u] = g4[q];
        m[u] = m4 != nullptr ? m4[q] : 0x01010101u;
        Op::load4(v4, q, c[u]);
      } else {
        g[u] = make_int4(-1, -1, -1, -1);
        m[u] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < Op::VECS; ++u) {
      if ((unsigned)g[u].x < (unsigned)S && (m[u] & 0xFFu)) add(g[u].x, c[u][0]);
      if ((unsigned)g[u].y < (unsigned)S && (m[u] & 0xFF00u)) add(g[u].y, c[u][1]);
      if ((unsigned)g[u].z < (unsigned)S && (m[u] & 0xFF0000u)) add(g[u].z, c[u][2]);
      if ((unsigned)g[u].w < (unsigned)S && (m[u] & 0xFF000000u)) add(g[u].w, c[u][3]);
    }
  }
  if (PRIVATE) {
    __syncthreads();
    for (int i = threadIdx.x; i < S; i += SLOTS_BLOCK) {
      const Cell x = acc[i];
      if (x != (Cell)0) atomicAdd(out + i, (Out)x);  // NaN != 0: merged
    }
  }
}

template <class Op>
static int launch_slots(const int* gid, const unsigned char* mask, const void* vals, long long n,
                        int S, void* out, void* stream) {
  if (S <= 0 || ((uintptr_t)gid & 3) != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // vectors from gid's first 16-byte boundary, where the mask and the
  // values line up with it; else every row one at a time
  long long head = (long long)(((16 - ((uintptr_t)gid & 15)) & 15) / 4);
  bool vec = head < n;
  if (mask != nullptr && (((uintptr_t)mask + head) & 3) != 0) vec = false;
  if (Op::VB && (((uintptr_t)vals + head * Op::VB) & 15) != 0) vec = false;
  if (!vec) head = n;
  const long long nvec = (n - head) / 4;
  const size_t cells = (size_t)S * sizeof(typename Op::Cell);
  const bool priv = cells <= SLOTS_PRIVATE_MAX_SMEM;
  const size_t smem = priv ? cells : 0;
  const void* fn =
      priv ? (const void*)slots_kernel<Op, true> : (const void*)slots_kernel<Op, false>;
  const long long per_block = vec ? (long long)SLOTS_BLOCK * 4 * Op::VECS : SLOTS_BLOCK;
  int grid;
  int rc = set_smem(fn, smem);
  if (rc || (rc = resident_grid(fn, SLOTS_BLOCK, smem, (n + per_block - 1) / per_block, &grid)))
    return rc;
  typename Op::Out* o = (typename Op::Out*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (priv)
    slots_kernel<Op, true><<<grid, SLOTS_BLOCK, smem, s>>>(gid, mask, vals, n, S, head, nvec, o);
  else
    slots_kernel<Op, false><<<grid, SLOTS_BLOCK, 0, s>>>(gid, mask, vals, n, S, head, nvec, o);
  return (int)cudaGetLastError();
}

// All three take (gid, mask or null, values, dtype code, n, S, out,
// stream); out is u64[S] (counts, integer sums) or f64[S] (float sums),
// zeroed by the caller.
extern "C" int hdb_count_per_slot(const int* gid, const unsigned char* mask, const void* vals,
                                  int dt, long long n, int S, void* out, void* stream) {
  return launch_slots<CountOp>(gid, mask, vals, n, S, out, stream);
}

extern "C" int hdb_sum_f32_per_slot(const int* gid, const unsigned char* mask, const void* vals,
                                    int dt, long long n, int S, void* out, void* stream) {
  if (dt != DT_F32) return (int)cudaErrorInvalidValue;
  return launch_slots<SumF32Op>(gid, mask, vals, n, S, out, stream);
}

extern "C" int hdb_sum_int_per_slot(const int* gid, const unsigned char* mask, const void* vals,
                                    int dt, long long n, int S, void* out, void* stream) {
  if (dt == DT_I32) return launch_slots<SumI32Op>(gid, mask, vals, n, S, out, stream);
  if (dt == DT_I64)
    return launch_slots<SumI64WrapOp>(gid, mask, vals, n, S, out, stream);
  return (int)cudaErrorInvalidValue;
}
