// B2: group-by histogram of counts and count/sum streams over 257..65536
// slots, one pass over the rows.
//
// Replaces the TPU kernel heavydb_tpu/kernels/radix_hist.py:_fused_hist,
// which recast the histogram as a bf16 one-hot GEMM for the TPU's matrix
// unit.  Hopper has atomics, so this is a histogram whose cells stay in
// shared memory as far as they can (the body is stream_agg.cuh).  The
// wrapper (kernels/radix_hist.py plan) picks one of four tiers by the
// shared bytes of all slots' cells:
//  1. up to 112 KB: a private copy a block, 1024 threads an SM as four
//     blocks of 256 (up to 56 KB) or two of 512 (1000 slots x 4 streams:
//     28 KB);
//  2. up to 227 KB: a private copy a block, one block of 1024 threads an SM
//     (10000 slots x a count and two 4-byte cells: 120 KB);
//  3. up to 4 x 227 KB: a thread-block cluster of 2 or 4 blocks of 1024
//     threads, slot g in block g % C (10000 slots x 4 streams: 280 KB over
//     2 blocks); every block scans the cluster's rows and adds only its
//     own slots, so the cells stay in each block's shared memory;
//  4. beyond that: every row adds straight into the global u64 / f64
//     outputs, with the same vector loads (65536 slots x 4 streams).
//     Clusters of 8 and 16 blocks were measured slower than this tier
//     (PERF.md section 6): each block of a cluster reads all its rows.
// float32 sums add in f32 within a block and in f64 across blocks.
//
// Bound: bytes read (gid 4 B/row, the mask 1 B/row, each stream at its own
// width).  A cluster of C blocks reads gid and the mask C times and the
// values of a 4-row vector once for each block that owns one of its rows,
// mostly from L2; the global tier's cost is its L2 atomics.
#include "stream_agg.cuh"

static int hist_run(const int* gid, const unsigned char* mask, long long n, int S,
                    const StreamSet* ss, unsigned long long* counts, int mode, int cluster,
                    int threads, long long smem, void* stream, int* info) {
  if (mode == SA_SHARED && threads == 256)
    return sa_run<SA_SHARED, false, 256>(gid, mask, n, S, ss, counts, cluster, smem, stream,
                                         info);
  if (mode == SA_SHARED && threads == 512)
    return sa_run<SA_SHARED, false, 512>(gid, mask, n, S, ss, counts, cluster, smem, stream,
                                         info);
  if (mode == SA_SHARED && threads == 1024)
    return sa_run<SA_SHARED, false, 1024>(gid, mask, n, S, ss, counts, cluster, smem,
                                          stream, info);
  if (mode == SA_GLOBAL && threads == 256)
    return sa_run<SA_GLOBAL, false, 256>(gid, mask, n, S, ss, counts, cluster, smem, stream,
                                         info);
  return (int)cudaErrorInvalidValue;
}

// counts u64[S] and the outputs (u64 counts / sums, f64 sums) zeroed by
// the caller; smem as sa_run's.
extern "C" int hdb_radix_hist(const int* gid, const unsigned char* mask, long long n, int S,
                              const StreamSet* ss, unsigned long long* counts, int mode,
                              int cluster, int threads, long long smem, void* stream) {
  return hist_run(gid, mask, n, S, ss, counts, mode, cluster, threads, smem, stream,
                  nullptr);
}

// What a launch of that plan gets: out[0..6] as sa_run's info.
extern "C" int hdb_radix_hist_info(int S, const StreamSet* ss, int mode, int cluster,
                                   int threads, long long smem, int* out) {
  return hist_run(nullptr, nullptr, 0, S, ss, nullptr, mode, cluster, threads, smem, nullptr,
                  out);
}
