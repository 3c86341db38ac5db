// B3: per-slot MIN or MAX over 257..4096 slots, in the value's own 4-byte
// type, one pass over the rows.
//
// Replaces the TPU kernel heavydb_tpu/kernels/groupby_pallas.py:
// minmax_per_slot (a [block, slots] masked tile reduce in VMEM).  The body
// is stream_agg.cuh's, instantiated with MIN/MAX classes as B1's is, over
// one MIN or MAX stream: each thread loads two 4-row vectors a tile (an
// int4 of gid, one 32-bit mask word, an int4 / float4 of values), a block
// keeps one copy of every slot's cells in shared memory (a u32 count and an
// int32 key: 4096 slots take 32 KB, so four 256-thread blocks share an SM)
// and reduces with native shared atomicMin / atomicMax, a resident grid
// sweeps the rows, and each block merges the slots it reached into the
// global keys once.  int32 values are their own keys; float32 values use
// agg_common.cuh's order-preserving key, which the wrapper decodes.  The
// per-slot counts the body keeps come back too, and the wrapper drops them.
//
// Bound: bytes read (gid 4 B/row, the mask 1 B/row, values 4 B/row).  The
// kernel it replaces here loaded one row a thread a step (9 bytes in
// flight), too few to cover device memory's latency.
#include "stream_agg.cuh"

static int minmax_run(const int* gid, const unsigned char* mask, long long n, int S,
                      const StreamSet* ss, unsigned long long* counts, int mode, int cluster,
                      int threads, long long smem, void* stream, int* info) {
  if (mode != SA_SHARED || cluster != 1 || threads != 256 || ss->n != 1 ||
      (ss->op[0] != OP_MIN && ss->op[0] != OP_MAX))
    return (int)cudaErrorInvalidValue;
  return sa_run<SA_SHARED, true, 256>(gid, mask, n, S, ss, counts, 1, smem, stream, info);
}

// counts u64[S] zeroed and the key output int32[S] at its identity by the
// caller; smem as sa_run's.
extern "C" int hdb_groupby_minmax(const int* gid, const unsigned char* mask, long long n, int S,
                                  const StreamSet* ss, unsigned long long* counts, int mode,
                                  int cluster, int threads, long long smem, void* stream) {
  return minmax_run(gid, mask, n, S, ss, counts, mode, cluster, threads, smem, stream,
                    nullptr);
}

// What a launch of that plan gets: out[0..6] as sa_run's info.
extern "C" int hdb_groupby_minmax_info(int S, const StreamSet* ss, int mode, int cluster,
                                       int threads, long long smem, int* out) {
  return minmax_run(nullptr, nullptr, 0, S, ss, nullptr, mode, cluster, threads, smem, nullptr,
                    out);
}
