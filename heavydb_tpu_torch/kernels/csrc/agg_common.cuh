// Shared pieces of the group-by aggregation kernels (stream_agg.cuh for
// lane_agg.cu, radix_hist.cu and groupby_minmax.cu; groupby_slots.cu;
// radix_groupby.cu).
//
// Row contract, common to all: a row contributes when its slot id
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

static inline int set_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Blocks of a grid-stride launch of fn: as many as stay resident on all the
// SMs at once (the occupancy calculator, after set_smem), at most `work`,
// at least one.
static inline int resident_grid(const void* fn, int block, size_t smem, long long work,
                                int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, block, smem);
  if (e != cudaSuccess) return (int)e;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (g > work) g = work;
  *grid = g < 1 ? 1 : (int)g;
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
