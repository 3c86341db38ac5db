// B5 and B6: the radix-partition group-by of huge or sparse dense key
// spaces.
//
// Replaces the TPU kernels heavydb_tpu/kernels/radix_groupby.py:
// _partition_call (B5) and _groupby_call (B6), driven by sparse_groupby.
// Rows carry a slot id gid in [0, S) (others are dropped) and up to
// HDB_MAX_STREAMS value streams of the classes of agg_common.cuh.  The hash
// h = gid * 0x9E3779B1 (mod 2^32) is a bijection; its biased form
// hb = h ^ 2^31 orders as h under signed compares.
//
// B5, radix partition by the top `pbits` bits of h into P = 2^pbits
// partitions.  Scattering each row on its own (a cursor atomic a row, a
// partial 32-byte sector write a row for hb and each stream) keeps 32768 x
// (1 + streams) regions open, more than the L2 holds.  So B5 partitions in
// at most two levels of <= 256 buckets each and writes whole runs, as the
// TPU kernel's L1 / L2 passes do:
//   part_hist_kernel  counts all P final partitions (1024 threads, 4 B x P
//                     <= 128 KB of shared counters, gid read 16 B at a time),
//                     merged into counts[P] with global atomics.  Their
//                     exclusive scan (host glue) gives every final offset and
//                     every level-1 region: bucket b1 spans
//                     [offsets[b1 << p2], offsets[(b1 + 1) << p2]);
//   part_l1_kernel    tiles of PT_TILE input rows: a block ranks its tile's
//                     valid rows by level-1 bucket (the top p1 bits) with a
//                     256-bin shared histogram and a block scan, reserves one
//                     range per non-empty bucket with one global atomicAdd on
//                     that bucket's cursor, then moves hb and each stream in
//                     turn: a coalesced load, a store into shared memory at
//                     the row's rank, and each bucket's run written from
//                     shared memory by consecutive threads to consecutive
//                     addresses.  One column is staged at a time, so shared
//                     memory (PT_TILE x (widest column + 1) B, 80-144 KB)
//                     does not grow with the stream count.  With one level
//                     (pbits <= 8) it writes the final arrays; else a
//                     scratch set laid out like them;
//   part_l2_kernel    the same inside each level-1 region, by the low p2
//                     bits, from the scratch into the final arrays.  Tiles
//                     never straddle two regions: each block scans the
//                     regions' tile counts on the device and blocks stride
//                     over all tiles, so a region that holds most rows (a hot
//                     key) spreads over every SM.
// Each row moves twice (scratch, then final) and gid is read twice; about
// 12 GB at 10^8 rows and 25 B of streams, against the 5.8 GB that one pass
// must move.  The scratch, n x (4 + stream bytes) (2.9 GB there), is
// allocated by the wrapper for the time of the call; the kernels allocate
// nothing.  The TPU kernel's fixed regions, sentinel padding, fringe
// rows and 1.45x margin do not exist here.
//
// B6, group_kernel, one partition at a time per block.  Bound: bytes (the
// partitioned rows read once, one record per group written twice, ~0.16 ms
// for 10^8 rows and 10^7 groups counts-only).  The first port of it
// sorted every row with the block sort, reduced each operand with a
// block-wide segmented scan, gathered the streams through the sort index
// and sized 172 KB of shared memory for a full tile, so one block ran per
// SM.  This one aggregates by hashing and sorts only the groups:
//   1. read the partition's hb once, coalesced (16-byte loads where
//      aligned), and insert each key into an open-addressing table in
//      shared memory (atomicCAS, linear probing, a power of two of at least
//      2 entries a row, the key mixed by a second odd multiplier); keep
//      each row's table slot (2 B a row);
//   2. compact the occupied entries into 64-bit words (key, slot) and sort
//      only those ng words with block_sort of tile_sort.cuh: a word's
//      position is its group's rank, so records stay in ascending hb order;
//   3. counts, then each stream in turn, read the partition's rows in order
//      and add into one accumulator per rank with shared-memory atomics
//      (64-bit int add for count / sumi, f64 add for sumd, f32 add for
//      sumf, int32 min / max on the order keys for MIN / MAX).  A warp
//      whose lanes all carry one rank (a hot group) first folds them into
//      one atomic; any other warp adds one atomic a lane.  The one
//      accumulator array is reused stream after stream, so shared memory
//      does not grow with the stream count;
//   4. write one record per group (hb, row count, one total per stream) at
//      off + rank into a staging area laid out like the partitioned input,
//      and the partition's group count.
// Shared memory follows the partitions that occur: a first launch, one
// block per partition, takes the partitions of at most 4096 rows with
// 74 KB a block (three resident blocks an SM); a second, persistent launch
// skips those and takes the rest up to the tile (8192 rows, 148 KB).  A
// partition with more rows than the tile sets flag bit 0 and writes no
// records.  Both launches read the counts on the device.  compact_kernel
// then copies the records of partition p to [goff[p], goff[p] + ng[p]) of
// the [cap] outputs, goff being the exclusive scan of the group counts
// (host glue), and turns hb back into gid.
//
// Precision: counts, sumi and MIN / MAX are exact (int64 adds, and exact
// int32 compares on the order-preserving keys of agg_common.cuh); sumd adds
// in float64; sumf adds in float32 within the group's one partition, in
// atomic order, which changes from run to run: it stays within rtol 1e-4 /
// atol 1e-3 of the float64 sum rounded once.
#include <stdint.h>

#include "agg_common.cuh"
#include "tile_sort.cuh"

#define RG_MULT 0x9E3779B1u
#define RG_INV 0x0E8B2F51u  // RG_MULT^-1 mod 2^32
// biased hash of no valid gid (gid = 0xF174D0AF < 0): the table's empty entry
#define RG_SENT 0x7FFFFFFF
#define RG_SLOT_MULT 0x85EBCA6Bu  // spreads a partition's keys over its table
#define RG_E 16                   // words a thread holds in B6's sort

__device__ __forceinline__ unsigned rg_hash(int g) { return (unsigned)g * RG_MULT; }

__device__ __forceinline__ unsigned rg_bucket(unsigned h, int pbits) {
  return pbits ? (h >> (32 - pbits)) : 0u;
}

__host__ __device__ __forceinline__ int elem_bytes(int dt) {
  switch (dt) {
    case DT_BOOL:
    case DT_I8: return 1;
    case DT_I16: return 2;
    case DT_I32:
    case DT_F32: return 4;
    default: return 8;
  }
}

__device__ __forceinline__ void copy_elem(void* dst, long long d, const void* src, long long s,
                                          int bytes) {
  switch (bytes) {
    case 1: ((unsigned char*)dst)[d] = ((const unsigned char*)src)[s]; break;
    case 2: ((unsigned short*)dst)[d] = ((const unsigned short*)src)[s]; break;
    case 4: ((unsigned int*)dst)[d] = ((const unsigned int*)src)[s]; break;
    default: ((unsigned long long*)dst)[d] = ((const unsigned long long*)src)[s]; break;
  }
}

// Let fn take `smem` dynamic bytes beside its static ones (whose sum may
// pass 48 KB even where smem alone does not) and prefer shared memory to L1.
static int prefer_shared(const void* fn, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------------------
// B5
// ---------------------------------------------------------------------------

#define PH_BLOCK 1024  // part_hist_kernel's threads
#define PH_VECS 4      // 16-byte gid loads a thread has in flight
// part_l1 / l2 threads (one block of 1024 an SM, at most 64 registers a
// thread) and the rows each ranks in a tile of 16384, whose runs then
// average 64 rows at 256 buckets (8192-row tiles lost 18 % at 6 streams,
// PERF.md section 6).
#define PT_BLOCK 1024
#define PT_E 16
#define PT_TILE (PT_BLOCK * PT_E)
#define PT_MAXB 256    // buckets of a level

__global__ void __launch_bounds__(PH_BLOCK)
    part_hist_kernel(const int* __restrict__ gid, long long n, int S, int pbits,
                     unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int s_hist[];
  const int P = 1 << pbits;
  for (int i = threadIdx.x; i < P; i += PH_BLOCK) s_hist[i] = 0u;
  __syncthreads();
  auto add = [&](int g) {
    if ((unsigned)g < (unsigned)S) atomicAdd(&s_hist[rg_bucket(rg_hash(g), pbits)], 1u);
  };
  const long long tid = (long long)blockIdx.x * PH_BLOCK + threadIdx.x;
  const long long stride = (long long)gridDim.x * PH_BLOCK;
  // scalar rows before the first 16-byte boundary and after the last
  long long head = (long long)(((16 - ((uintptr_t)gid & 15)) & 15) / 4);
  head = head < n ? head : n;
  const long long nvec = (n - head) / 4;
  if (tid < head) add(gid[tid]);
  for (long long r = head + 4 * nvec + tid; r < n; r += stride) add(gid[r]);
  const int4* g4 = (const int4*)(gid + head);
  for (long long q0 = tid; q0 < nvec; q0 += stride * PH_VECS) {
    int4 x[PH_VECS];
#pragma unroll
    for (int u = 0; u < PH_VECS; ++u) {
      const long long q = q0 + u * stride;
      x[u] = q < nvec ? g4[q] : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < PH_VECS; ++u) {
      add(x[u].x);
      add(x[u].y);
      add(x[u].z);
      add(x[u].w);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += PH_BLOCK)
    if (s_hist[i]) atomicAdd(counts + i, (unsigned long long)s_hist[i]);
}

// A block's bins for one tile.
struct PartBins {
  unsigned hist[PT_MAXB];  // rows of each bucket in the tile
  unsigned base[PT_MAXB];  // their exclusive scan: a bucket's first tile rank
  long long adj[PT_MAXB];  // rank j of bucket b goes to output row adj[b] + j
  unsigned wtot[PT_MAXB / 32];
};

// Exclusive scan of in[0, m) (m <= PT_MAXB) into out; returns the total.
// Every thread of the block calls it; it ends with a barrier.
__device__ __forceinline__ unsigned scan_bins(const unsigned* in, unsigned* out, int m,
                                              unsigned* wtot) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  unsigned x = 0, incl = 0;
  if (t < PT_MAXB) {
    x = t < m ? in[t] : 0u;
    incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(HDB_FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wtot[t >> 5] = incl;
  }
  __syncthreads();
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < PT_MAXB / 32; ++w) {
    if (t < PT_MAXB && w == (t >> 5)) x = total + incl - x;
    total += wtot[w];
  }
  if (t < m) out[t] = x;
  __syncthreads();
  return total;
}

// Level 1 reads gid (rows outside [0, S) dropped) and writes hb; level 2
// reads hb.
template <bool FROM_GID>
__device__ __forceinline__ bool row_hash(int key, int S, unsigned* h) {
  if (FROM_GID) {
    *h = rg_hash(key);
    return (unsigned)key < (unsigned)S;
  }
  *h = (unsigned)key ^ 0x80000000u;
  return true;
}

// Each bucket's run of the staged tile out to its reserved range, by
// consecutive threads to consecutive addresses.  Every thread calls it
// after staging its rows; it ends with a barrier.
template <typename W>
__device__ __forceinline__ void write_runs(const W* stage, const unsigned char* bucket_of,
                                           const long long* adj, int cnt, W* __restrict__ dst) {
  __syncthreads();
  for (int j = threadIdx.x; j < cnt; j += PT_BLOCK) dst[adj[bucket_of[j]] + j] = stage[j];
  __syncthreads();
}

// One stream of a tile: each thread's rows into shared memory at their
// tile ranks (pos[k] of its k-th row, -1: no row), then out in runs.
template <typename W>
__device__ __forceinline__ void move_column(const W* __restrict__ src, long long r0,
                                            const int (&pos)[PT_E], W* stage,
                                            const unsigned char* bucket_of, const long long* adj,
                                            int cnt, W* __restrict__ dst) {
  constexpr int CH = 8;  // loads a thread has in flight
#pragma unroll
  for (int k0 = 0; k0 < PT_E; k0 += CH) {
    W v[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k)
      v[k] = pos[k0 + k] >= 0 ? src[r0 + (k0 + k) * PT_BLOCK + threadIdx.x] : (W)0;
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (pos[k0 + k] >= 0) stage[pos[k0 + k]] = v[k];
  }
  write_runs(stage, bucket_of, adj, cnt, dst);
}

// Partition the tile of `rows` rows from r0: bucket (part >> lo) & (nb - 1)
// of each valid row, part being its final partition; a bucket's range is
// reserved at cursor[cbase + (bucket << cshift)].  smem: the staging area
// (PT_TILE x the widest column) and then each tile rank's bucket.
template <bool FROM_GID>
__device__ __forceinline__ void part_tile(const int* __restrict__ keys, long long r0, int rows,
                                          int S, int pbits, int lo, int nb, long long cbase,
                                          int cshift, unsigned long long* __restrict__ cursor,
                                          int* __restrict__ hb_out, const StreamSet& ss,
                                          PartBins& bins, unsigned char* smem, int stage_w) {
  const int tid = threadIdx.x;
  unsigned char* bucket_of = smem + (size_t)PT_TILE * stage_w;
  for (int b = tid; b < nb; b += PT_BLOCK) bins.hist[b] = 0u;
  __syncthreads();
  int key[PT_E];
#pragma unroll
  for (int k = 0; k < PT_E; ++k) {
    const int i = k * PT_BLOCK + tid;
    key[k] = i < rows ? keys[r0 + i] : 0;
  }
  // pos = bucket << 16 | rank within the bucket, until the bases are known
  int pos[PT_E];
#pragma unroll
  for (int k = 0; k < PT_E; ++k) {
    unsigned h;
    pos[k] = -1;
    if (k * PT_BLOCK + tid < rows && row_hash<FROM_GID>(key[k], S, &h)) {
      const unsigned b = (rg_bucket(h, pbits) >> lo) & (unsigned)(nb - 1);
      pos[k] = (int)(b << 16 | atomicAdd(&bins.hist[b], 1u));
    }
  }
  __syncthreads();
  const int cnt = (int)scan_bins(bins.hist, bins.base, nb, bins.wtot);
  for (int b = tid; b < nb; b += PT_BLOCK) {
    const unsigned c = bins.hist[b];
    if (c)
      bins.adj[b] = (long long)atomicAdd(cursor + cbase + ((long long)b << cshift),
                                         (unsigned long long)c) -
                    (long long)bins.base[b];
  }
#pragma unroll
  for (int k = 0; k < PT_E; ++k) {
    if (pos[k] < 0) continue;
    const int b = pos[k] >> 16;
    const int p = (int)bins.base[b] + (pos[k] & 0xFFFF);
    bucket_of[p] = (unsigned char)b;
    pos[k] = p;
  }
  // hb from the keys still in registers (write_runs' first barrier
  // publishes adj and bucket_of)
  int* st = (int*)smem;
#pragma unroll
  for (int k = 0; k < PT_E; ++k)
    if (pos[k] >= 0) st[pos[k]] = FROM_GID ? (int)(rg_hash(key[k]) ^ 0x80000000u) : key[k];
  write_runs(st, bucket_of, bins.adj, cnt, hb_out);
  for (int c = 0; c < ss.n; ++c) {
    switch (elem_bytes(ss.dt[c])) {
      case 1:
        move_column((const unsigned char*)ss.vals[c], r0, pos, smem, bucket_of, bins.adj, cnt,
                    (unsigned char*)ss.out[c]);
        break;
      case 2:
        move_column((const unsigned short*)ss.vals[c], r0, pos, (unsigned short*)smem, bucket_of,
                    bins.adj, cnt, (unsigned short*)ss.out[c]);
        break;
      case 4:
        move_column((const unsigned*)ss.vals[c], r0, pos, (unsigned*)smem, bucket_of, bins.adj,
                    cnt, (unsigned*)ss.out[c]);
        break;
      default:
        move_column((const unsigned long long*)ss.vals[c], r0, pos, (unsigned long long*)smem,
                    bucket_of, bins.adj, cnt, (unsigned long long*)ss.out[c]);
        break;
    }
  }
}

// Level 1: the input in tiles of PT_TILE rows, by the top p1 = pbits - p2
// bits; cursor[b1 << p2] starts at offsets[b1 << p2].
__global__ void __launch_bounds__(PT_BLOCK, 1)
    part_l1_kernel(const int* __restrict__ gid, long long n, int S, int pbits, int p2,
                   unsigned long long* __restrict__ cursor, int* __restrict__ hb_out,
                   StreamSet ss, int stage_w) {
  extern __shared__ __align__(16) unsigned char pt_smem[];
  __shared__ PartBins bins;
  const long long ntiles = (n + PT_TILE - 1) / PT_TILE;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long r0 = t * PT_TILE;
    const int rows = (int)(n - r0 < PT_TILE ? n - r0 : PT_TILE);
    part_tile<true>(gid, r0, rows, S, pbits, p2, 1 << (pbits - p2), 0, p2, cursor, hb_out, ss,
                    bins, pt_smem, stage_w);
  }
}

// Level 2: each level-1 region of the scratch (hb_in, ss.vals) in tiles of
// at most PT_TILE rows, by the low p2 bits, into the final arrays; cursor
// starts at offsets.
__global__ void __launch_bounds__(PT_BLOCK, 1)
    part_l2_kernel(const int* __restrict__ hb_in, const unsigned long long* __restrict__ counts,
                   const long long* __restrict__ offsets, int pbits, int p2,
                   unsigned long long* __restrict__ cursor, int* __restrict__ hb_out,
                   StreamSet ss, int stage_w) {
  extern __shared__ __align__(16) unsigned char pt_smem[];
  __shared__ PartBins bins;
  __shared__ long long s_r0[PT_MAXB], s_r1[PT_MAXB];  // each region's rows
  __shared__ unsigned s_t0[PT_MAXB];                  // its first tile
  const int nr = 1 << (pbits - p2);
  const int P = 1 << pbits;
  for (int r = threadIdx.x; r < nr; r += PT_BLOCK) {
    const long long a = offsets[r << p2];
    const long long b =
        r + 1 < nr ? offsets[(r + 1) << p2] : offsets[P - 1] + (long long)counts[P - 1];
    s_r0[r] = a;
    s_r1[r] = b;
    bins.hist[r] = (unsigned)((b - a + PT_TILE - 1) / PT_TILE);
  }
  __syncthreads();
  const unsigned ntiles = scan_bins(bins.hist, s_t0, nr, bins.wtot);
  for (unsigned t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // the region of tile t: the last r with s_t0[r] <= t (empty regions
    // share their successor's first tile and are passed over)
    int lo = 0, hi = nr - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_t0[mid] <= t) lo = mid;
      else hi = mid - 1;
    }
    const long long r0 = s_r0[lo] + (long long)(t - s_t0[lo]) * PT_TILE;
    const int rows = (int)(s_r1[lo] - r0 < PT_TILE ? s_r1[lo] - r0 : PT_TILE);
    part_tile<false>(hb_in, r0, rows, 0, pbits, 0, 1 << p2, (long long)lo << p2, 0, cursor,
                     hb_out, ss, bins, pt_smem, stage_w);
  }
}

// Bytes of the widest column a tile stages: hb, or a wider stream.
static int stage_width(const StreamSet* ss) {
  int w = 4;
  for (int k = 0; ss != nullptr && k < ss->n; ++k)
    w = elem_bytes(ss->dt[k]) > w ? elem_bytes(ss->dt[k]) : w;
  return w;
}

static size_t part_tile_smem(int stage_w) { return (size_t)PT_TILE * (stage_w + 1); }

// pass 0: part_hist_kernel into counts (zeroed by the caller).  pass 1:
// level 1 from keys = gid, cursor = a copy of offsets; into the final
// arrays (hb_out, ss->out) when p2 = 0, else into the scratch ones.
// pass 2: level 2 from keys = the scratch hb and ss->vals = the scratch
// streams into the final arrays, cursor = a fresh copy of offsets.  Each
// launch is a grid-stride over its tiles, as many blocks as stay resident.
extern "C" int hdb_radix_partition(const int* keys, long long n, int S, int pbits, int p2,
                                   unsigned long long* counts, const long long* offsets,
                                   unsigned long long* cursor, int* hb_out, const StreamSet* ss,
                                   int pass, void* stream) {
  if (pbits < 0 || pbits > 15 || p2 < 0 || pbits - p2 > 8 || p2 > 8 || pass < 0 || pass > 2 ||
      (pass == 2 && p2 == 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int grid = 1;
  int rc;
  if (pass == 0) {
    const void* fn = (const void*)part_hist_kernel;
    const size_t smem = (size_t)sizeof(unsigned int) << pbits;
    if ((rc = prefer_shared(fn, smem)) ||
        (rc = resident_grid(fn, PH_BLOCK, smem, (n + 4095) / 4096, &grid)))
      return rc;
    part_hist_kernel<<<grid, PH_BLOCK, smem, s>>>(keys, n, S, pbits, counts);
    return (int)cudaGetLastError();
  }
  const int stage_w = stage_width(ss);
  const size_t smem = part_tile_smem(stage_w);
  const long long tiles = (n + PT_TILE - 1) / PT_TILE + (pass == 2 ? (1 << (pbits - p2)) : 0);
  const void* fn = pass == 1 ? (const void*)part_l1_kernel : (const void*)part_l2_kernel;
  if ((rc = prefer_shared(fn, smem)) || (rc = resident_grid(fn, PT_BLOCK, smem, tiles, &grid)))
    return rc;
  if (pass == 1)
    part_l1_kernel<<<grid, PT_BLOCK, smem, s>>>(keys, n, S, pbits, p2, cursor, hb_out, *ss,
                                                stage_w);
  else
    part_l2_kernel<<<grid, PT_BLOCK, smem, s>>>(keys, counts, offsets, pbits, p2, cursor, hb_out,
                                                *ss, stage_w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B6
// ---------------------------------------------------------------------------

// Bytes of the sort buffer, which the accumulators reuse (8 B a group).
__host__ __device__ __forceinline__ size_t group_buf_bytes(int rows) {
  const size_t sort = bsort_smem_bytes(rows, RG_E, sizeof(hdb_u64));
  return sort > (size_t)rows * 8 ? sort : (size_t)rows * 8;
}

// Dynamic shared memory of group_kernel for partitions of at most `rows`
// rows (a power of two): sort buffer / accumulators, the hash table (2
// entries of 4 B a row), each row's table slot and then rank (2 B a row).
__host__ __device__ __forceinline__ size_t group_smem_bytes(int rows) {
  return group_buf_bytes(rows) + (size_t)rows * 2 * 4 + (size_t)rows * 2;
}

// Add each lane's x (the identity where !ok) into acc[r] with
// shared-memory atomics: where the whole warp carries one rank (a hot
// group) its lanes fold first into one atomic, else each lane adds its own.
// Every lane of the warp calls it.
template <typename T, typename Red, typename Atom>
__device__ __forceinline__ void warp_add(T* acc, int r, bool ok, T x, Red red, Atom atom) {
  const int r0 = __shfl_sync(HDB_FULL_MASK, r, 0);
  if (__all_sync(HDB_FULL_MASK, r == r0)) {
    for (int o = 16; o > 0; o >>= 1) x = red(x, __shfl_xor_sync(HDB_FULL_MASK, x, o));
    if ((threadIdx.x & 31) == 0 && ok) atom(acc + r0, x);
  } else if (ok) {
    atom(acc + r, x);
  }
}

// One stream of one partition: acc[r] = the reduction of the rows of rank
// r, then out[r] = acc[r] for r < ng.  load(i) reads row i of the
// partition; red combines two values; atom adds a value into an
// accumulator in shared memory.  Every thread of the block calls it.
template <typename T, typename Load, typename Red, typename Atom>
__device__ __forceinline__ void reduce_stream(T* acc, T ident, const unsigned short* rank, int cnt,
                                              int ng, Load load, Red red, Atom atom, T* out) {
  for (int r = threadIdx.x; r < ng; r += blockDim.x) acc[r] = ident;
  __syncthreads();
  for (int i0 = 0; i0 < cnt; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < cnt;
    warp_add(acc, ok ? (int)rank[i] : -1, ok, ok ? load(i) : ident, red, atom);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < ng; r += blockDim.x) out[r] = acc[r];
  __syncthreads();
}

struct AddOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Step 3 of group_partition: row counts into stage_len[off + rank] (and
// rank[i] from row i's table slot to its group rank), then each stream's
// totals into its staging array, ng groups of cnt rows.
template <int BLOCK>
__device__ __forceinline__ void aggregate(const StreamSet& ss, int cnt, long long off, int ng,
                                          hdb_u64* buf, const int* table, unsigned short* rank,
                                          long long* __restrict__ stage_len) {
  unsigned* cnt_acc = (unsigned*)buf;
  for (int r = threadIdx.x; r < ng; r += BLOCK) cnt_acc[r] = 0u;
  __syncthreads();
  for (int i0 = 0; i0 < cnt; i0 += BLOCK) {
    const int i = i0 + threadIdx.x;
    int r = -1;
    if (i < cnt) {
      r = table[rank[i]];
      rank[i] = (unsigned short)r;
    }
    warp_add(cnt_acc, r, i < cnt, i < cnt ? 1u : 0u, AddOp(),
             [](unsigned* a, unsigned x) { atomicAdd(a, x); });
  }
  __syncthreads();
  for (int r = threadIdx.x; r < ng; r += BLOCK) stage_len[off + r] = cnt_acc[r];
  __syncthreads();

  for (int k = 0; k < ss.n; ++k) {
    const void* vals = ss.vals[k];
    const int dt = ss.dt[k];
    const int op = ss.op[k];
    auto add_ll = [](long long* a, long long x) {
      atomicAdd((unsigned long long*)a, (unsigned long long)x);
    };
    if (op == OP_COUNT || op == OP_SUMI) {
      const bool is_count = op == OP_COUNT;
      reduce_stream<long long>(
          (long long*)buf, 0ll, rank, cnt, ng,
          [&](int i) {
            const long long x = load_int(vals, dt, off + i);
            return is_count ? (long long)(x != 0) : x;
          },
          AddOp(), add_ll, (long long*)ss.out[k] + off);
    } else if (op == OP_SUMF) {
      reduce_stream<float>(
          (float*)buf, 0.f, rank, cnt, ng, [&](int i) { return ((const float*)vals)[off + i]; },
          AddOp(), [](float* a, float x) { atomicAdd(a, x); }, (float*)ss.out[k] + off);
    } else if (op == OP_SUMD) {
      reduce_stream<double>(
          (double*)buf, 0.0, rank, cnt, ng, [&](int i) { return load_f64(vals, dt, off + i); },
          AddOp(), [](double* a, double x) { atomicAdd(a, x); }, (double*)ss.out[k] + off);
    } else if (op == OP_MIN) {
      reduce_stream<int>(
          (int*)buf, key_ident(dt, true), rank, cnt, ng,
          [&](int i) { return load_key(vals, dt, off + i, true); }, MinOp(),
          [](int* a, int x) { atomicMin(a, x); }, (int*)ss.out[k] + off);
    } else {
      reduce_stream<int>(
          (int*)buf, key_ident(dt, false), rank, cnt, ng,
          [&](int i) { return load_key(vals, dt, off + i, false); }, MaxOp(),
          [](int* a, int x) { atomicMax(a, x); }, (int*)ss.out[k] + off);
    }
  }
}

// Group partition p (cnt > 0 rows from off) into records at off + rank.
template <int BLOCK>
__device__ __forceinline__ void group_partition(const int* __restrict__ hb, const StreamSet& ss,
                                                int p, int cnt, long long off, int max_rows,
                                                unsigned char* smem, int* __restrict__ stage_hb,
                                                long long* __restrict__ stage_len,
                                                int* __restrict__ ng_part, int* s_ng) {
  hdb_u64* buf = (hdb_u64*)smem;
  int* table = (int*)(smem + group_buf_bytes(max_rows));
  unsigned short* rank = (unsigned short*)(table + 2 * max_rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  // 1. insert every key; rank[i] = row i's table slot
  int tbits = 5;
  while ((1 << tbits) < 2 * cnt) ++tbits;
  const int ts = 1 << tbits;
  for (int s = tid; s < ts; s += BLOCK) table[s] = RG_SENT;
  if (tid == 0) *s_ng = 0;
  __syncthreads();
  const int* src = hb + off;
  auto insert = [&](int i, int key) {
    unsigned s = ((unsigned)key * RG_SLOT_MULT) >> (32 - tbits);
    for (;;) {
      int cur = ((volatile int*)table)[s];
      if (cur == RG_SENT) {
        cur = atomicCAS(table + s, RG_SENT, key);
        if (cur == RG_SENT) cur = key;
      }
      if (cur == key) break;
      s = (s + 1) & (unsigned)(ts - 1);
    }
    rank[i] = (unsigned short)s;
  };
  int head = (int)((16 - ((uintptr_t)src & 15)) & 15) / 4;
  head = head < cnt ? head : cnt;
  if (tid < head) insert(tid, src[tid]);
  const int nvec = (cnt - head) / 4;
  const int4* src4 = (const int4*)(src + head);
  for (int q = tid; q < nvec; q += BLOCK) {
    const int4 x = src4[q];
    const int i = head + 4 * q;
    insert(i, x.x);
    insert(i + 1, x.y);
    insert(i + 2, x.z);
    insert(i + 3, x.w);
  }
  for (int i = head + 4 * nvec + tid; i < cnt; i += BLOCK) insert(i, src[i]);
  __syncthreads();

  // 2. the occupied entries as words (key, slot), at the positions the
  // sort's threads load them from
  for (int s0 = 0; s0 < ts; s0 += BLOCK) {
    const int s = s0 + tid;
    const int key = s < ts ? table[s] : RG_SENT;  // whole warps lie past ts
    const bool occ = key != RG_SENT;
    const unsigned b = __ballot_sync(HDB_FULL_MASK, occ);
    int at = 0;
    if (lane == 0 && b) at = atomicAdd(s_ng, __popc(b));
    at = __shfl_sync(HDB_FULL_MASK, at, 0) + __popc(b & ((1u << lane) - 1u));
    if (occ) buf[bsort_pad(at, RG_E)] = bsort_word(key, (unsigned)s);
  }
  __syncthreads();
  const int ng = *s_ng;
  int n2 = 1;
  while (n2 < ng) n2 <<= 1;
  hdb_u64 v[RG_E];
  const int base = tid * RG_E;
#pragma unroll
  for (int e = 0; e < RG_E; ++e) v[e] = base + e < ng ? buf[bsort_pad(base + e, RG_E)] : ~0ull;
  block_sort<RG_E>(v, n2, buf);

  // the table entry of each group now holds its rank; its record's key
#pragma unroll
  for (int e = 0; e < RG_E; ++e) {
    if (base + e < ng) {
      table[(unsigned)v[e]] = base + e;
      stage_hb[off + base + e] = bsort_key(v[e]);
    }
  }
  __syncthreads();

  // 3. row counts and streams
  aggregate<BLOCK>(ss, cnt, off, ng, buf, table, rank, stage_len);
  if (tid == 0) ng_part[p] = ng;
}

// Blocks walk the partitions p = blockIdx.x, + gridDim.x, ... and group
// those of min_rows..max_rows rows.  A partition of more rows sets bit 0
// when max_rows reaches the tile, and is left to a later launch otherwise.
template <int BLOCK>
__global__ void __launch_bounds__(BLOCK, BLOCK == 256 ? 3 : 1)
    group_kernel(const int* __restrict__ hb, StreamSet ss,
                 const unsigned long long* __restrict__ counts,
                 const long long* __restrict__ offsets, int P, int min_rows, int max_rows,
                 int tile, int* __restrict__ stage_hb, long long* __restrict__ stage_len,
                 int* __restrict__ ng_part, int* __restrict__ flag) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ng;
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const long long cnt = (long long)counts[p];
    if (cnt < min_rows) continue;
    if (cnt > max_rows) {
      if (max_rows >= tile && threadIdx.x == 0) {
        ng_part[p] = 0;
        atomicOr(flag, 1);
      }
      continue;
    }
    if (cnt == 0) {
      if (threadIdx.x == 0) ng_part[p] = 0;
      continue;
    }
    group_partition<BLOCK>(hb, ss, p, (int)cnt, offsets[p], max_rows, smem, stage_hb, stage_len,
                           ng_part, &s_ng);
    __syncthreads();
  }
}

__host__ __device__ __forceinline__ int total_bytes(int op) {
  return (op == OP_COUNT || op == OP_SUMI || op == OP_SUMD) ? 8 : 4;
}

// stage: the staging records of group_kernel (vals = stage arrays per
// stream, out = the [cap] outputs).
__global__ void compact_kernel(const long long* __restrict__ offsets,
                               const int* __restrict__ ng_part, const long long* __restrict__ goff,
                               long long cap, const int* __restrict__ stage_hb,
                               const long long* __restrict__ stage_len, StreamSet stage,
                               int* __restrict__ gid_out, long long* __restrict__ len_out) {
  const int p = blockIdx.x;
  const int m = ng_part[p];
  const long long src0 = offsets[p];
  const long long dst0 = goff[p];
  for (int g = threadIdx.x; g < m; g += blockDim.x) {
    const long long d = dst0 + g;
    if (d >= cap) break;
    const long long s = src0 + g;
    const unsigned h = (unsigned)stage_hb[s] ^ 0x80000000u;
    gid_out[d] = (int)(h * RG_INV);
    len_out[d] = stage_len[s];
    for (int k = 0; k < stage.n; ++k)
      copy_elem(stage.out[k], d, stage.vals[k], s, total_bytes(stage.op[k]));
  }
}

// group_kernel's launch for partitions of at most max_rows rows: threads
// a block (max_rows <= threads * RG_E) and its shared memory.
static const void* group_fn(int max_rows, int* block) {
  *block = max_rows <= 256 * RG_E ? 256 : 512;
  return *block == 256 ? (const void*)group_kernel<256> : (const void*)group_kernel<512>;
}

// pass 0: group_kernel over the partitions of min_rows..max_rows rows
// (max_rows a power of two <= 8192), `grid` blocks; pass 1: compact_kernel.
extern "C" int hdb_radix_group(const int* hb, const StreamSet* parts, const StreamSet* stage,
                               const unsigned long long* counts, const long long* offsets, int P,
                               int min_rows, int max_rows, int tile, int* stage_hb,
                               long long* stage_len, int* ng_part, int* flag,
                               const long long* goff, long long cap, int* gid_out,
                               long long* len_out, int pass, int grid, void* stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  if (pass == 0) {
    if (max_rows < 32 || (max_rows & (max_rows - 1)) != 0 || max_rows > 512 * RG_E ||
        grid < 1)
      return (int)cudaErrorInvalidValue;
    int block;
    const void* fn = group_fn(max_rows, &block);
    const size_t smem = group_smem_bytes(max_rows);
    int rc = prefer_shared(fn, smem);
    if (rc) return rc;
    cudaStream_t s = (cudaStream_t)stream;
    if (block == 256)
      group_kernel<256><<<grid, 256, smem, s>>>(hb, *parts, counts, offsets, P, min_rows,
                                                max_rows, tile, stage_hb, stage_len, ng_part,
                                                flag);
    else
      group_kernel<512><<<grid, 512, smem, s>>>(hb, *parts, counts, offsets, P, min_rows,
                                                max_rows, tile, stage_hb, stage_len, ng_part,
                                                flag);
  } else {
    compact_kernel<<<P, 128, 0, (cudaStream_t)stream>>>(offsets, ng_part, goff, cap, stage_hb,
                                                        stage_len, *stage, gid_out, len_out);
  }
  return (int)cudaGetLastError();
}

// kernel_info of one kernel as it is launched: which = 0 part_hist_kernel
// (arg = pbits), 1 part_l1_kernel and 4 part_l2_kernel (arg = the widest
// column's bytes), 2 group_kernel (arg = max_rows), 3 compact_kernel.
extern "C" int hdb_radix_info(int which, int arg, int* out) {
  const void* fn;
  int block;
  size_t smem = 0;
  switch (which) {
    case 0: fn = (const void*)part_hist_kernel, block = PH_BLOCK, smem = (size_t)4 << arg; break;
    case 1:
    case 4:
      fn = which == 1 ? (const void*)part_l1_kernel : (const void*)part_l2_kernel;
      block = PT_BLOCK;
      smem = part_tile_smem(arg);
      break;
    case 2: fn = group_fn(arg, &block), smem = group_smem_bytes(arg); break;
    default: fn = (const void*)compact_kernel, block = 128; break;
  }
  int rc = prefer_shared(fn, smem);
  return rc ? rc : kernel_info(fn, block, smem, out);
}
