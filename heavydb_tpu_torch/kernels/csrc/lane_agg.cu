// B1: group-by aggregation over at most 256 slots, one pass over the rows:
// per-slot counts and up to 16 streams of counts, exact integer sums, f32 /
// f64 sums and MIN/MAX keys.
//
// Replaces the TPU kernel heavydb_tpu/kernels/lane_agg.py:_lane_agg (a
// per-lane VMEM accumulator matrix swept by masked sublane reductions).
// On Hopper every block keeps a private copy of all slots' cells in shared
// memory (256 slots x 16 streams of 8-byte cells: 33 KB) and merges the
// slots it reached into the global outputs once.  The body is
// stream_agg.cuh: 4-row vector loads, one dispatch a tile and stream,
// integer sums as native 32-bit halves.  Warp pre-aggregation
// (__match_any_sync and a shuffle tree over each slot's lanes, one atomic
// a slot) lost at 10 and at 100 slots (PERF.md section 6) and was dropped.
//
// Bound: bytes read (gid 4 B/row, the mask 1 B/row, each stream at its own
// width).  At few slots the rows of a block land on a few cells, and a
// compare-and-swap add (f32, f64) retries whenever another warp wrote the
// cell first.  A copy of the cells a warp gained about 10 % at 10 slots
// and nothing measurable at 100, the only B1 slot count of the benchmark
// queries (PERF.md section 6), so a block keeps one copy.
#include "stream_agg.cuh"

static int lane_run(const int* gid, const unsigned char* mask, long long n, int S,
                    const StreamSet* ss, unsigned long long* counts, int mode, int cluster,
                    int threads, long long smem, void* stream, int* info) {
  if (mode != SA_SHARED || cluster != 1 || threads != 256) return (int)cudaErrorInvalidValue;
  return sa_run<SA_SHARED, true, 256>(gid, mask, n, S, ss, counts, 1, smem, stream, info);
}

// counts u64[S] and the outputs (u64 counts / sums, f64 sums, int32 keys at
// their identity) zeroed by the caller; smem as sa_run's.
extern "C" int hdb_lane_agg(const int* gid, const unsigned char* mask, long long n, int S,
                            const StreamSet* ss, unsigned long long* counts, int mode,
                            int cluster, int threads, long long smem, void* stream) {
  return lane_run(gid, mask, n, S, ss, counts, mode, cluster, threads, smem, stream,
                  nullptr);
}

// What a launch of that plan gets: out[0..6] as sa_run's info.
extern "C" int hdb_lane_agg_info(int S, const StreamSet* ss, int mode, int cluster, int threads,
                                 long long smem, int* out) {
  return lane_run(nullptr, nullptr, 0, S, ss, nullptr, mode, cluster, threads, smem, nullptr,
                  out);
}
