// Shared pieces of the group-by aggregation kernels (lane_agg.cu,
// radix_hist.cu, groupby_minmax.cu).
//
// Row contract, common to all three: a row contributes when its slot id
// g = gid[r] lies in [0, S) and mask[r] (if a mask is given) is nonzero.
// Streams carry one value per row; the caller has already zeroed sum
// streams on rows that must not contribute.
//
// Stream classes (op) and what each accumulates per slot:
//   OP_COUNT  0/1 values (bool)            -> int64 count of nonzero rows
//   OP_SUMI   int8/16/32/64 values         -> exact int64 sum (wraps mod 2^64)
//   OP_SUMF   float32 values               -> float32 per block, float64 across
//   OP_SUMD   float32/float64 values       -> float64 sum
//   OP_MIN/MAX int32/float32 values        -> int32 order-preserving key
#pragma once

#include <cuda_runtime.h>

#define HDB_MAX_STREAMS 16

enum { OP_COUNT = 0, OP_SUMI = 1, OP_SUMF = 2, OP_SUMD = 3, OP_MIN = 4, OP_MAX = 5 };
enum { DT_BOOL = 0, DT_I8 = 1, DT_I16 = 2, DT_I32 = 3, DT_I64 = 4, DT_F32 = 5, DT_F64 = 6 };

#define HDB_INT_MIN ((int)0x80000000)
#define HDB_INT_MAX ((int)0x7FFFFFFF)
// keys of +inf / -inf under f32_key
#define HDB_KEY_POS_INF ((int)0x7F800000)
#define HDB_KEY_NEG_INF ((int)0x807FFFFF)

struct StreamSet {
  const void* vals[HDB_MAX_STREAMS];
  void* out[HDB_MAX_STREAMS];
  int op[HDB_MAX_STREAMS];
  int dt[HDB_MAX_STREAMS];
  int n;
};

__device__ __forceinline__ long long load_int(const void* p, int dt, long long i) {
  switch (dt) {
    case DT_BOOL: return (long long)((const unsigned char*)p)[i];
    case DT_I8: return (long long)((const signed char*)p)[i];
    case DT_I16: return (long long)((const short*)p)[i];
    case DT_I32: return (long long)((const int*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

__device__ __forceinline__ double load_f64(const void* p, int dt, long long i) {
  return dt == DT_F32 ? (double)((const float*)p)[i] : ((const double*)p)[i];
}

// Order-preserving int32 key of a float: flipping the low 31 bits of a
// negative float reverses its magnitude order, so signed int compares
// match float compares (-0.0 sorts just below +0.0).  NaN maps to the end
// that wins the reduction, so MIN and MAX both propagate NaN as
// jnp.minimum / jnp.maximum do.  The map is its own inverse on non-NaN keys.
__device__ __forceinline__ int f32_key(float v, bool is_min) {
  if (v != v) return is_min ? HDB_INT_MIN : HDB_INT_MAX;
  int b = __float_as_int(v);
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

__device__ __forceinline__ int load_key(const void* p, int dt, long long i, bool is_min) {
  if (dt == DT_F32) return f32_key(((const float*)p)[i], is_min);
  return ((const int*)p)[i];
}

__device__ __forceinline__ int key_ident(int dt, bool is_min) {
  if (dt == DT_F32) return is_min ? HDB_KEY_POS_INF : HDB_KEY_NEG_INF;
  return is_min ? HDB_INT_MAX : HDB_INT_MIN;
}

__device__ __forceinline__ bool row_slot(const int* __restrict__ gid,
                                         const unsigned char* __restrict__ mask,
                                         long long r, int S, int* g) {
  int v = gid[r];
  if ((unsigned)v >= (unsigned)S) return false;
  if (mask != nullptr && !mask[r]) return false;
  *g = v;
  return true;
}

// Bytes of one block-private accumulator cell for a stream class.
__host__ __device__ __forceinline__ size_t cell_bytes(int op) {
  return (op == OP_SUMI || op == OP_SUMD) ? 8 : 4;
}

__host__ __device__ __forceinline__ size_t align8(size_t x) { return (x + 7) & ~(size_t)7; }

// Shared-memory bytes for S slots: int32 counts, then one cell array per stream.
__host__ __device__ __forceinline__ size_t private_smem_bytes(int S, const StreamSet& ss) {
  size_t off = align8((size_t)S * 4);
  for (int k = 0; k < ss.n; ++k) off = align8(off + (size_t)S * cell_bytes(ss.op[k]));
  return off;
}

// One block: grid-stride over rows into block-private shared accumulators,
// then one merge of the nonzero slots into the global outputs with atomics.
__device__ __forceinline__ void block_private_agg(const int* __restrict__ gid,
                                                  const unsigned char* __restrict__ mask,
                                                  long long n, int S, const StreamSet& ss,
                                                  unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(8) unsigned char smem[];
  unsigned int* s_cnt = (unsigned int*)smem;
  unsigned char* acc[HDB_MAX_STREAMS];
  size_t off = align8((size_t)S * 4);
  for (int k = 0; k < ss.n; ++k) {
    acc[k] = smem + off;
    off = align8(off + (size_t)S * cell_bytes(ss.op[k]));
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    s_cnt[i] = 0u;
    for (int k = 0; k < ss.n; ++k) {
      switch (ss.op[k]) {
        case OP_COUNT: ((unsigned int*)acc[k])[i] = 0u; break;
        case OP_SUMI: ((unsigned long long*)acc[k])[i] = 0ull; break;
        case OP_SUMF: ((float*)acc[k])[i] = 0.f; break;
        case OP_SUMD: ((double*)acc[k])[i] = 0.0; break;
        case OP_MIN: ((int*)acc[k])[i] = key_ident(ss.dt[k], true); break;
        case OP_MAX: ((int*)acc[k])[i] = key_ident(ss.dt[k], false); break;
      }
    }
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    int g;
    if (!row_slot(gid, mask, r, S, &g)) continue;
    atomicAdd(&s_cnt[g], 1u);
    for (int k = 0; k < ss.n; ++k) {
      const void* v = ss.vals[k];
      const int dt = ss.dt[k];
      switch (ss.op[k]) {
        case OP_COUNT:
          if (load_int(v, dt, r)) atomicAdd(((unsigned int*)acc[k]) + g, 1u);
          break;
        case OP_SUMI: {
          long long x = load_int(v, dt, r);
          if (x) atomicAdd(((unsigned long long*)acc[k]) + g, (unsigned long long)x);
        } break;
        case OP_SUMF: {
          float x = ((const float*)v)[r];
          if (x != 0.f) atomicAdd(((float*)acc[k]) + g, x);
        } break;
        case OP_SUMD: {
          double x = load_f64(v, dt, r);
          if (x != 0.0) atomicAdd(((double*)acc[k]) + g, x);
        } break;
        case OP_MIN: atomicMin(((int*)acc[k]) + g, load_key(v, dt, r, true)); break;
        case OP_MAX: atomicMax(((int*)acc[k]) + g, load_key(v, dt, r, false)); break;
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    unsigned int c = s_cnt[i];
    if (c == 0u) continue;  // no row of this block reached slot i
    atomicAdd(counts + i, (unsigned long long)c);
    for (int k = 0; k < ss.n; ++k) {
      switch (ss.op[k]) {
        case OP_COUNT: {
          unsigned int x = ((unsigned int*)acc[k])[i];
          if (x) atomicAdd(((unsigned long long*)ss.out[k]) + i, (unsigned long long)x);
        } break;
        case OP_SUMI: {
          unsigned long long x = ((unsigned long long*)acc[k])[i];
          if (x) atomicAdd(((unsigned long long*)ss.out[k]) + i, x);
        } break;
        case OP_SUMF: {
          float x = ((float*)acc[k])[i];
          if (x != 0.f) atomicAdd(((double*)ss.out[k]) + i, (double)x);
        } break;
        case OP_SUMD: {
          double x = ((double*)acc[k])[i];
          if (x != 0.0) atomicAdd(((double*)ss.out[k]) + i, x);
        } break;
        case OP_MIN: atomicMin(((int*)ss.out[k]) + i, ((int*)acc[k])[i]); break;
        case OP_MAX: atomicMax(((int*)ss.out[k]) + i, ((int*)acc[k])[i]); break;
      }
    }
  }
}

static inline int set_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// What a launch of fn with `block` threads and `smem` dynamic bytes gets:
// out = registers a thread, local (stack) bytes a thread, shared bytes a
// block (static + dynamic), resident blocks per SM, threads a block.
static inline int kernel_info(const void* fn, int block, size_t smem, int* out) {
  int rc = set_smem(fn, smem);
  if (rc) return rc;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, block, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + smem);
  out[3] = blocks;
  out[4] = block;
  return 0;
}
