// B4: sort each fixed tile of int32 keys ascending, up to four 4-byte
// payloads riding along.
//
// Replaces the TPU kernel heavydb_tpu/kernels/tile_sort.py:sort_tiles (one
// grid step per (R, 128) VMEM tile).  One block sorts one tile of T keys:
// each thread loads TS_E = 16 consecutive keys (16-byte loads where the
// tensors are aligned; 16 lets a 16384-key tile fit 1024 threads) and runs
// block_sort of tile_sort.cuh on its registers.
// With no payload the network sorts the int32 keys themselves
// (sort_keys_kernel); with payloads it sorts 64-bit (key, index in the
// tile) words (sort_pairs_kernel), writes the sorted keys, then moves each
// payload once: its tile is staged in shared memory with 16-byte loads and
// gathered from there through the sorted indices.  The kernels are
// templates over the payload count and the block's thread cap, so no
// payload pointer is indexed at run time and blocks of up to 512 threads
// keep 128 registers a thread.
//
// Bound: bytes, each key and payload read once and written once (0.24 ms
// for 10^8 keys at 3.35 TB/s); the network's exchanges, most of them in
// registers and warp shuffles, come first in practice.
#include <stdint.h>

#include "agg_common.cuh"
#include "tile_sort.cuh"

#define HDB_MAX_PAYLOADS 4
#define TS_E 16  // keys a thread holds

struct Payloads {
  const int* in[HDB_MAX_PAYLOADS];
  int* out[HDB_MAX_PAYLOADS];
  int n;
};

// Keys of thread t's positions p0 .. p0 + TS_E - 1 of the tile (16-byte
// loads where vec).
__device__ __forceinline__ void load_keys(const int* __restrict__ src, int vec, int (&k)[TS_E]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < TS_E / 4; ++q) {
      const int4 x = ((const int4*)src)[q];
      k[4 * q] = x.x;
      k[4 * q + 1] = x.y;
      k[4 * q + 2] = x.z;
      k[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < TS_E; ++e) k[e] = src[e];
  }
}

__device__ __forceinline__ void store_keys(int* __restrict__ dst, int vec, const int (&k)[TS_E]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < TS_E / 4; ++q)
      ((int4*)dst)[q] = make_int4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < TS_E; ++e) dst[e] = k[e];
  }
}

// No payload: the network sorts the int32 keys themselves.
template <int MAXT>
__global__ void __launch_bounds__(MAXT) sort_keys_kernel(const int* __restrict__ key,
                                                         int* __restrict__ key_out, int T,
                                                         int vec) {
  extern __shared__ int s_keys[];
  const long long base = (long long)blockIdx.x * T;
  const int p0 = threadIdx.x * TS_E;
  const bool mine = p0 < T;
  int v[TS_E];
#pragma unroll
  for (int e = 0; e < TS_E; ++e) v[e] = HDB_INT_MAX;
  if (mine) load_keys(key + base + p0, vec, v);
  block_sort<TS_E, int>(v, T, s_keys);
  if (mine) store_keys(key_out + base + p0, vec, v);
}

// NP payloads: the network sorts (key, index) words; then each payload's
// tile is staged in shared memory with 16-byte loads and gathered from
// there through the sorted indices.
template <int NP, int MAXT>
__global__ void __launch_bounds__(MAXT) sort_pairs_kernel(const int* __restrict__ key,
                                                          int* __restrict__ key_out,
                                                          Payloads ps, int T, int vec) {
  extern __shared__ hdb_u64 s_sort[];
  int* s_pay = (int*)s_sort;
  const long long base = (long long)blockIdx.x * T;
  const int p0 = threadIdx.x * TS_E;
  const bool mine = p0 < T;
  hdb_u64 v[TS_E];
  int k[TS_E];
#pragma unroll
  for (int e = 0; e < TS_E; ++e) v[e] = ~0ull;
  if (mine) {
    load_keys(key + base + p0, vec, k);
#pragma unroll
    for (int e = 0; e < TS_E; ++e) v[e] = bsort_word(k[e], p0 + e);
  }
  block_sort<TS_E, hdb_u64>(v, T, s_sort);
  if (mine) {
#pragma unroll
    for (int e = 0; e < TS_E; ++e) k[e] = bsort_key(v[e]);
    store_keys(key_out + base + p0, vec, k);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    __syncthreads();  // the sort's or the last payload's use of shared memory
    const int* src = ps.in[p] + base;
    if (vec) {
      for (int q = threadIdx.x; q < T / 4; q += blockDim.x)
        ((int4*)s_pay)[q] = ((const int4*)src)[q];
    } else {
      for (int q = threadIdx.x; q < T; q += blockDim.x) s_pay[q] = src[q];
    }
    __syncthreads();
    if (mine) {
#pragma unroll
      for (int e = 0; e < TS_E; ++e) k[e] = s_pay[(unsigned)v[e]];
      store_keys(ps.out[p] + base + p0, vec, k);
    }
  }
}

static int sort_block(int T) { return T / TS_E < 32 ? 32 : T / TS_E; }

// Launch (or, with info, describe) the kernel for NP payloads and a block
// of at most MAXT threads.
template <int NP, int MAXT>
static int sort_launch(const int* key, int* key_out, const Payloads& ps, long long n, int T,
                       int vec, int* info, cudaStream_t stream) {
  const void* fn;
  size_t smem;
  if constexpr (NP == 0) {
    fn = (const void*)sort_keys_kernel<MAXT>;
    smem = bsort_smem_bytes(T, TS_E, sizeof(int));
  } else {
    fn = (const void*)sort_pairs_kernel<NP, MAXT>;
    smem = bsort_smem_bytes(T, TS_E, sizeof(hdb_u64));
    if (smem < (size_t)T * sizeof(int)) smem = (size_t)T * sizeof(int);
  }
  const int block = sort_block(T);
  if (info) return kernel_info(fn, block, smem, info);
  int rc = set_smem(fn, smem);
  if (rc) return rc;
  const unsigned grid = (unsigned)(n / T);
  if constexpr (NP == 0)
    sort_keys_kernel<MAXT><<<grid, block, smem, stream>>>(key, key_out, T, vec);
  else
    sort_pairs_kernel<NP, MAXT><<<grid, block, smem, stream>>>(key, key_out, ps, T, vec);
  return (int)cudaGetLastError();
}

template <int MAXT>
static int sort_dispatch(const int* key, int* key_out, const Payloads& ps, long long n, int T,
                         int vec, int* info, cudaStream_t stream) {
  switch (ps.n) {
    case 0: return sort_launch<0, MAXT>(key, key_out, ps, n, T, vec, info, stream);
    case 1: return sort_launch<1, MAXT>(key, key_out, ps, n, T, vec, info, stream);
    case 2: return sort_launch<2, MAXT>(key, key_out, ps, n, T, vec, info, stream);
    case 3: return sort_launch<3, MAXT>(key, key_out, ps, n, T, vec, info, stream);
    default: return sort_launch<4, MAXT>(key, key_out, ps, n, T, vec, info, stream);
  }
}

extern "C" int hdb_sort_tiles(const int* key, int* key_out, const Payloads* ps, long long n, int T,
                              int* info, void* stream) {
  if (T < 32 || (T & (T - 1)) != 0 || T > 16384 || n % T != 0 || ps->n < 0 ||
      ps->n > HDB_MAX_PAYLOADS)
    return (int)cudaErrorInvalidValue;
  if (n == 0 && !info) return 0;
  uintptr_t addr = (uintptr_t)key | (uintptr_t)key_out;
  for (int p = 0; p < ps->n; ++p) addr |= (uintptr_t)ps->in[p] | (uintptr_t)ps->out[p];
  const int vec = (addr & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  // up to 512 threads a block leaves a thread 128 registers
  return T / TS_E > 512 ? sort_dispatch<1024>(key, key_out, *ps, n, T, vec, info, s)
                        : sort_dispatch<512>(key, key_out, *ps, n, T, vec, info, s);
}
