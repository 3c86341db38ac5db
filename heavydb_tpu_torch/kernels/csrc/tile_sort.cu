// B4: sort each fixed tile of int32 keys ascending, up to four 4-byte
// payloads riding along.
//
// Replaces the TPU kernel heavydb_tpu/kernels/tile_sort.py:sort_tiles (one
// grid step per (R, 128) VMEM tile).  One thread block sorts one tile of T
// keys in shared memory (block_bitonic_sort of tile_sort.cuh: 8 B per
// element, T <= 16384 keys = 128 KB), then writes the keys and permutes
// each payload once through the sorted local indices.
//
// Bound: bytes, each key and payload read once and written once; the
// payload gather reads inside one tile, so it stays within a few KB.
#include "agg_common.cuh"
#include "tile_sort.cuh"

#define HDB_MAX_PAYLOADS 4

struct Payloads {
  const int* in[HDB_MAX_PAYLOADS];
  int* out[HDB_MAX_PAYLOADS];
  int n;
};

__global__ void sort_tiles_kernel(const int* __restrict__ key, int* __restrict__ key_out, Payloads ps,
                                  int T) {
  extern __shared__ int s_sort[];
  int* keys = s_sort;
  int* idx = s_sort + T;
  const long long base = (long long)blockIdx.x * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    keys[i] = key[base + i];
    idx[i] = i;
  }
  __syncthreads();
  block_bitonic_sort(keys, idx, T);
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    key_out[base + i] = keys[i];
    const int src = idx[i];
    for (int p = 0; p < ps.n; ++p) ps.out[p][base + i] = ps.in[p][base + src];
  }
}

extern "C" int hdb_sort_tiles(const int* key, int* key_out, const Payloads* ps, long long n, int T,
                              void* stream) {
  if (T < 32 || (T & (T - 1)) != 0 || T > 16384 || n % T != 0 || ps->n < 0 ||
      ps->n > HDB_MAX_PAYLOADS)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  size_t smem = (size_t)T * 2 * sizeof(int);
  int rc = set_smem((const void*)sort_tiles_kernel, smem);
  if (rc) return rc;
  const int block = T < 512 ? T : 512;
  sort_tiles_kernel<<<(unsigned)(n / T), block, smem, (cudaStream_t)stream>>>(key, key_out, *ps, T);
  return (int)cudaGetLastError();
}
