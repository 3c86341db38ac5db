// B4 body: block-level bitonic sort of (key, index) pairs in shared memory.
//
// Counterpart of heavydb_tpu/kernels/tile_sort.py:_tile_bitonic, which ran
// the network on (R, 128) vregs with lane gathers and sublane rolls.  Here
// one thread block sorts one tile held in shared memory:
//  - strides of 32 and more: one compare-exchange per pair of elements in
//    shared memory, __syncthreads() between strides;
//  - strides under 32: each warp loads a 32-element chunk into registers and
//    runs every such stride with __shfl_xor_sync, no barrier between them.
// Only the int32 key and the element's local index move through the
// network; callers permute each payload once afterwards through the index.
// The sort is ascending and unstable, as the reference's is.
//
// Bound: shared-memory traffic, about log2(n)^2 / 2 passes over 8 B per
// element, most of them in registers; device memory is read and written
// once per element by the caller.
#pragma once

#include <cuda_runtime.h>

#define HDB_FULL_MASK 0xffffffffu

// Strides j < 32 of the stages k in [k_lo, k_hi], for every 32-element chunk
// of keys/idx[0, n2).  Position p of a stage-k block runs ascending when
// (p & k) == 0.  n2 is a power of two of at least 32.
__device__ __forceinline__ void bitonic_warp_stages(int* keys, int* idx, int n2, int k_lo,
                                                    int k_hi) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int base = (threadIdx.x >> 5) * 32; base < n2; base += nwarps * 32) {
    const int p = base + lane;
    int kv = keys[p];
    int iv = idx[p];
    for (int k = k_lo; k <= k_hi; k <<= 1) {
      const bool desc = (p & k) != 0;
      for (int j = (k >> 1) < 16 ? (k >> 1) : 16; j > 0; j >>= 1) {
        const int pk = __shfl_xor_sync(HDB_FULL_MASK, kv, j);
        const int pi = __shfl_xor_sync(HDB_FULL_MASK, iv, j);
        const bool upper = (lane & j) != 0;
        // the lower position keeps the smaller key in an ascending block;
        // both positions of a pair agree, and equal keys never move
        const bool take = (upper != desc) ? (pk > kv) : (pk < kv);
        if (take) {
          kv = pk;
          iv = pi;
        }
      }
    }
    keys[p] = kv;
    idx[p] = iv;
  }
}

// Sort keys[0, n2) ascending in shared memory, idx riding along.  Every
// thread of the block calls it; blockDim.x is a multiple of 32; n2 is a
// power of two of at least 32.  The caller synchronises before the call;
// the sort ends with a barrier.
__device__ __forceinline__ void block_bitonic_sort(int* keys, int* idx, int n2) {
  bitonic_warp_stages(keys, idx, n2, 2, 32);
  __syncthreads();
  for (int k = 64; k <= n2; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int t = threadIdx.x; t < (n2 >> 1); t += blockDim.x) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo + j;
        const int a = keys[lo];
        const int b = keys[hi];
        if (((lo & k) == 0) ? (a > b) : (a < b)) {
          keys[lo] = b;
          keys[hi] = a;
          const int t2 = idx[lo];
          idx[lo] = idx[hi];
          idx[hi] = t2;
        }
      }
      __syncthreads();
    }
    bitonic_warp_stages(keys, idx, n2, k, k);
    __syncthreads();
  }
}
