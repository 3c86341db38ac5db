// J1: the perfect join build's slot-and-count pass, one pass over the build
// rows (ops/join.py build_perfect through kernels/join_build.py).
//
// Replaces no TPU kernel: heavydb_tpu/ops/join.py build_perfect leaves its
// scatter-add (`.at[slot].add(1, mode="drop")`) to XLA.  The port's plain
// version is torch.bincount over an int64 slot in which every dropped row
// (masked out, outside [key_min, key_min + R), or at or past num_rows) holds
// the drop slot R.  On the card that sends most of a filtered build's rows to
// one int64 global atomic, reads the slot's minimum and maximum back to the
// host first, and leaves int64 counts over R + 1 slots to cast.
//
// Here each row gets its int32 slot (key - key_min, or R where it drops) and
// only the kept rows are counted, into int32 counts[R] zeroed by the caller:
//  - a dropped row writes its slot and takes no atomic;
//  - a warp adds each run of equal slots in neighbouring lanes with one
//    atomic (a build in key order, such as lineitem's l_orderkey runs of
//    1-7 rows, takes one a run); __match_any_sync would also join equal
//    slots that are not neighbours, at a far lower throughput, and keys in
//    no order repeat too rarely within 32 rows for that to pay;
//  - the runs add straight into the global counts at every key_range:
//    the wide builds (orders' and lineitem's order keys) outgrow shared
//    memory, and the narrow ones (nation's 25 keys) have as few rows;
//  - a row's key is read only where its validity keeps it, so a build
//    that its filter thins reads the keys' sectors that hold a kept row.
// The slot's range test is one unsigned compare of key - key_min, the
// same bits as the plain version's wrapping int64 subtraction and its test
// 0 <= slot < R.
//
// Bound: bytes, the validity of the live rows (1 B a row), the 32-byte
// sectors of keys that hold a kept row, the slot written (4 B a row), the
// counts zeroed (4 B a slot), and each sector of counts that a kept row
// touches read and written back.  Each thread loads JB_UNROLL rows, a
// warp's 32 neighbouring rows at a time, before its first atomic.
// 256-thread blocks, as many as stay resident.
#include <stdint.h>

#include "agg_common.cuh"

#define JB_BLOCK 256
#define JB_UNROLL 4

__global__ void __launch_bounds__(JB_BLOCK)
    perfect_count_kernel(const long long* __restrict__ keys,
                         const unsigned char* __restrict__ valid, long long n, long long live,
                         long long key_min, int R, int* __restrict__ slot,
                         int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const unsigned after = ~((2u << lane) - 1u);  // the lanes above this one
  const long long warp = ((long long)blockIdx.x * JB_BLOCK + threadIdx.x) >> 5;
  const long long step = ((long long)gridDim.x * JB_BLOCK) * JB_UNROLL;
  const unsigned long long range = (unsigned long long)R;
  for (long long base = warp * 32 * JB_UNROLL; base < n; base += step) {
    long long k[JB_UNROLL];
    bool in[JB_UNROLL];
#pragma unroll
    for (int u = 0; u < JB_UNROLL; ++u) {
      const long long r = base + u * 32 + lane;
      in[u] = r < live && (valid == nullptr || valid[r] != 0);
    }
#pragma unroll
    for (int u = 0; u < JB_UNROLL; ++u) k[u] = in[u] ? keys[base + u * 32 + lane] : 0;
#pragma unroll
    for (int u = 0; u < JB_UNROLL; ++u) {
      const long long r = base + u * 32 + lane;
      const unsigned long long d = (unsigned long long)k[u] - (unsigned long long)key_min;
      const bool ok = in[u] && d < range;
      const int s = ok ? (int)d : R;
      if (r < n) slot[r] = s;
      const unsigned okm = __ballot_sync(0xFFFFFFFFu, ok);
      if (okm == 0u) continue;
      const int prev = __shfl_up_sync(0xFFFFFFFFu, s, 1);
      const bool head = ok && !(lane > 0 && ((okm >> (lane - 1)) & 1u) && prev == s);
      const unsigned heads = __ballot_sync(0xFFFFFFFFu, head);
      if (head) {
        // the run ends at the next head or the next dropped row
        const unsigned stop = (heads | ~okm) & after;
        atomicAdd(counts + s, (stop ? __ffs(stop) - 1 : 32) - lane);
      }
    }
  }
}

// keys int64[n], valid bool[n] or null; rows at or past `live` drop; slot
// int32[n] out; counts int32[R], zeroed by the caller.  0 <= R < 2^31 - 1.
extern "C" int hdb_perfect_count(const long long* keys, const unsigned char* valid, long long n,
                                 long long live, long long key_min, int R, int* slot,
                                 int* counts, void* stream) {
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (live > n) live = n;
  const long long per_block = (long long)JB_BLOCK * JB_UNROLL;
  int grid;
  int rc = resident_grid((const void*)perfect_count_kernel, JB_BLOCK, 0,
                         (n + per_block - 1) / per_block, &grid);
  if (rc) return rc;
  perfect_count_kernel<<<grid, JB_BLOCK, 0, (cudaStream_t)stream>>>(keys, valid, n, live,
                                                                    key_min, R, slot, counts);
  return (int)cudaGetLastError();
}

// registers, local bytes, shared bytes, resident blocks per SM and threads
// of a launch (agg_common.cuh kernel_info)
extern "C" int hdb_perfect_count_info(int* out) {
  return kernel_info((const void*)perfect_count_kernel, JB_BLOCK, 0, out);
}
