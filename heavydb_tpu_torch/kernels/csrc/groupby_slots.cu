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
// Bound: bytes read (gid 4 B/row, the mask 1 B/row, values 4 or 8 B/row);
// global atomics above the shared-memory budget are the cost to watch.
#include "agg_common.cuh"

#define SLOTS_PRIVATE_MAX_SMEM (96 * 1024)

// One accumulation per kernel: the block-private cell, the global output
// cell and what one row adds.
struct CountOp {
  typedef unsigned int Cell;
  typedef unsigned long long Out;
  static __device__ __forceinline__ Cell load(const void*, long long) { return 1u; }
};

struct SumF32Op {
  typedef float Cell;
  typedef double Out;
  static __device__ __forceinline__ Cell load(const void* v, long long r) {
    return ((const float*)v)[r];
  }
};

struct SumI32Op {
  typedef unsigned long long Cell;
  typedef unsigned long long Out;
  static __device__ __forceinline__ Cell load(const void* v, long long r) {
    return (Cell)(long long)((const int*)v)[r];
  }
};

struct SumI64WrapOp {
  typedef unsigned long long Cell;
  typedef unsigned long long Out;
  // the low 32 bits, read as a signed int32
  static __device__ __forceinline__ Cell load(const void* v, long long r) {
    return (Cell)(long long)(int)(unsigned int)((const unsigned long long*)v)[r];
  }
};

template <class Op>
__global__ void slots_private_kernel(const int* __restrict__ gid,
                                     const unsigned char* __restrict__ mask,
                                     const void* __restrict__ vals, long long n, int S,
                                     typename Op::Out* __restrict__ out) {
  typedef typename Op::Cell Cell;
  extern __shared__ __align__(8) unsigned char slot_smem[];
  Cell* acc = (Cell*)slot_smem;
  for (int i = threadIdx.x; i < S; i += blockDim.x) acc[i] = (Cell)0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    int g;
    if (!row_slot(gid, mask, r, S, &g)) continue;
    atomicAdd(acc + g, Op::load(vals, r));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    Cell x = acc[i];
    if (x != (Cell)0) atomicAdd(out + i, (typename Op::Out)x);  // NaN != 0: merged
  }
}

template <class Op>
__global__ void slots_global_kernel(const int* __restrict__ gid,
                                    const unsigned char* __restrict__ mask,
                                    const void* __restrict__ vals, long long n, int S,
                                    typename Op::Out* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    int g;
    if (!row_slot(gid, mask, r, S, &g)) continue;
    atomicAdd(out + g, (typename Op::Out)Op::load(vals, r));
  }
}

template <class Op>
static int launch_slots(const int* gid, const unsigned char* mask, const void* vals, long long n,
                        int S, void* out, int grid, int block, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  typename Op::Out* o = (typename Op::Out*)out;
  size_t smem = (size_t)S * sizeof(typename Op::Cell);
  if (smem <= SLOTS_PRIVATE_MAX_SMEM) {
    int rc = set_smem((const void*)slots_private_kernel<Op>, smem);
    if (rc) return rc;
    slots_private_kernel<Op><<<grid, block, smem, (cudaStream_t)stream>>>(gid, mask, vals, n, S, o);
  } else {
    slots_global_kernel<Op><<<grid, block, 0, (cudaStream_t)stream>>>(gid, mask, vals, n, S, o);
  }
  return (int)cudaGetLastError();
}

// All three take (gid, mask or null, values, dtype code, n, S, out, grid,
// block, stream); out is u64[S] (counts, integer sums) or f64[S] (float
// sums), zeroed by the caller.
extern "C" int hdb_count_per_slot(const int* gid, const unsigned char* mask, const void* vals,
                                  int dt, long long n, int S, void* out, int grid, int block,
                                  void* stream) {
  return launch_slots<CountOp>(gid, mask, vals, n, S, out, grid, block, stream);
}

extern "C" int hdb_sum_f32_per_slot(const int* gid, const unsigned char* mask, const void* vals,
                                    int dt, long long n, int S, void* out, int grid, int block,
                                    void* stream) {
  if (dt != DT_F32) return (int)cudaErrorInvalidValue;
  return launch_slots<SumF32Op>(gid, mask, vals, n, S, out, grid, block, stream);
}

extern "C" int hdb_sum_int_per_slot(const int* gid, const unsigned char* mask, const void* vals,
                                    int dt, long long n, int S, void* out, int grid, int block,
                                    void* stream) {
  if (dt == DT_I32) return launch_slots<SumI32Op>(gid, mask, vals, n, S, out, grid, block, stream);
  if (dt == DT_I64)
    return launch_slots<SumI64WrapOp>(gid, mask, vals, n, S, out, grid, block, stream);
  return (int)cudaErrorInvalidValue;
}
