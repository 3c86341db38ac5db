// B4 body, also run by B6: a register-blocked bitonic sort of 32- or
// 64-bit words.
//
// Counterpart of heavydb_tpu/kernels/tile_sort.py:_tile_bitonic, which ran
// the network on (R, 128) vregs with lane gathers and sublane rolls.
//
// What bounds it on Hopper: not device memory (each word is read and
// written once by the caller) but the network's log2(n)^2 / 2
// compare-exchange steps, and how many of them go through shared memory
// behind a block barrier.  The first port of it kept keys and indices
// in two shared arrays, reloaded them for every stage and paid a barrier
// for every stride of 32 and more: 28 per 4096-key tile.  This one:
//  - sorts one word per element: the int32 key alone where nothing rides
//    along (B4 with no payload), else a 64-bit word with the key in the
//    high half (biased so that unsigned order is the key's order) and its
//    local index in the low half: one compare and one move per exchange,
//    all words distinct, so equal keys keep their row order;
//  - keeps E consecutive positions of the network in each thread's
//    registers (thread t holds positions t*E .. t*E + E - 1):
//      strides j < E         compare inside the thread's registers,
//      strides E <= j < 32E  exchange between the lanes of a warp
//                            (__shfl_xor_sync, no barrier),
//      strides j >= 32E      through shared memory, one barrier each; at
//                            E = 16 and 4096 words that is 6 strides;
//  - pads the shared buffer by one word after every E, so a warp storing
//    its register rows does not hit one bank 32 times.
// tests/test_torch_block_sort.py models this schedule (the same mapping,
// E and stride split) against torch.sort on the CPU.
#pragma once

#include <cuda_runtime.h>

#define HDB_FULL_MASK 0xffffffffu

typedef unsigned long long hdb_u64;

// Word of an int32 key and a local index: unsigned order = (key, index) order.
__device__ __forceinline__ hdb_u64 bsort_word(int key, unsigned idx) {
  return ((hdb_u64)((unsigned)key ^ 0x80000000u) << 32) | idx;
}
__device__ __forceinline__ int bsort_key(hdb_u64 w) {
  return (int)((unsigned)(w >> 32) ^ 0x80000000u);
}

__host__ __device__ __forceinline__ int bsort_pad(int p, int E) { return p + p / E; }

// Shared-memory bytes block_sort needs for n2 words of `word` bytes at E a
// thread (none while the whole network fits in one warp's registers).
__host__ __device__ __forceinline__ size_t bsort_smem_bytes(int n2, int E, int word) {
  return n2 > 32 * E ? (size_t)bsort_pad(n2, E) * word : 0;
}

// Strides j < E of stage k, in the thread's registers; base = t * E.
template <int E, typename W>
__device__ __forceinline__ void bsort_regs(W (&v)[E], int base, int k) {
#pragma unroll
  for (int j = E / 2; j >= 1; j >>= 1) {
    if (j >= k) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & j) continue;
      const bool asc = ((base + e) & k) == 0;
      const W a = v[e], b = v[e | j];
      const bool swap = (b < a) == asc;
      v[e] = swap ? b : a;
      v[e | j] = swap ? a : b;
    }
  }
}

// Strides j_hi .. E of stage k (k > j_hi, j_hi <= 16E) between the lanes
// of a warp: the partner of position p is p ^ j, lane ^ (j / E), the same
// register.  All 32 lanes call it.
template <int E, typename W>
__device__ __forceinline__ void bsort_warp(W (&v)[E], int base, int k, int j_hi) {
  const int lane = threadIdx.x & 31;
  const bool asc = (base & k) == 0;  // k > j >= E: one direction per thread
  for (int j = j_hi; j >= E; j >>= 1) {
    const int m = j / E;
    const bool keep_min = ((lane & m) == 0) == asc;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const W w = __shfl_xor_sync(HDB_FULL_MASK, v[e], m);
      v[e] = (w < v[e]) == keep_min ? w : v[e];
    }
  }
}

// Sort ascending the words of positions [0, n2) that the block's threads
// hold in v (E consecutive positions a thread, as above); on return v holds
// the sorted words at the same positions.  n2 is a power of two of at most
// blockDim.x * E; blockDim.x is a multiple of 32.  Registers of positions
// at or past n2 take part in no exchange with positions below it.  buf:
// bsort_smem_bytes(n2, E, sizeof(W)) bytes of shared memory, whose words at
// bsort_pad(t * E + e, E) thread t may already hold (B6 loads v from there).
// Every thread of the block calls it; it ends with a barrier when it used
// shared memory.
template <int E, typename W>
__device__ __forceinline__ void block_sort(W (&v)[E], int n2, W* buf) {
  const int base = threadIdx.x * E;
  const int wspan = 32 * E;  // positions one warp holds
  const bool live = (int)(threadIdx.x & ~31u) * E < n2;  // warp-uniform
  if (live) {
    const int k_hi = n2 < wspan ? n2 : wspan;
    for (int k = 2; k <= k_hi; k <<= 1) {
      bsort_warp<E, W>(v, base, k, k >> 1);
      bsort_regs<E, W>(v, base, k);
    }
  }
  if (n2 <= wspan) return;
  for (int k = 2 * wspan; k <= n2; k <<= 1) {
    if (live) {
#pragma unroll
      for (int e = 0; e < E; ++e) buf[bsort_pad(base + e, E)] = v[e];
    }
    __syncthreads();
    for (int j = k >> 1; j >= wspan; j >>= 1) {
      for (int q = threadIdx.x; q < (n2 >> 1); q += blockDim.x) {
        const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        W* pa = buf + bsort_pad(lo, E);
        W* pb = buf + bsort_pad(lo + j, E);
        const W a = *pa, b = *pb;
        if ((lo & k) == 0 ? a > b : a < b) {
          *pa = b;
          *pb = a;
        }
      }
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = buf[bsort_pad(base + e, E)];
      bsort_warp<E, W>(v, base, k, wspan >> 1);
      bsort_regs<E, W>(v, base, k);
    }
  }
  __syncthreads();
}
