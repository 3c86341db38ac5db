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
// buckets, in two passes:
//   part_hist_kernel     block-private shared counters (4 B x P <= 128 KB),
//                        merged into counts[P] with global atomics;
//   part_scatter_kernel  after an exclusive scan of counts (host glue),
//                        each valid row takes a slot from its bucket's
//                        atomic cursor and writes hb and every stream at its
//                        own width into exactly sized regions.
// The TPU kernel's fixed regions, sentinel padding, fringe rows and 1.45x
// margin do not exist here.  Bound: bytes (gid read twice, hb and each
// stream written once and read once); the scatter's random writes and the
// per-row cursor atomics are the cost to watch.
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

// ---------------------------------------------------------------------------
// B5
// ---------------------------------------------------------------------------

__global__ void part_hist_kernel(const int* __restrict__ gid, long long n, int S, int pbits,
                                 unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int s_hist[];
  const int P = 1 << pbits;
  for (int i = threadIdx.x; i < P; i += blockDim.x) s_hist[i] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    const int g = gid[r];
    if ((unsigned)g >= (unsigned)S) continue;
    atomicAdd(&s_hist[rg_bucket(rg_hash(g), pbits)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    if (s_hist[i]) atomicAdd(counts + i, (unsigned long long)s_hist[i]);
}

__global__ void part_scatter_kernel(const int* __restrict__ gid, long long n, int S, int pbits,
                                    unsigned long long* __restrict__ cursor,
                                    int* __restrict__ hb_out, StreamSet ss) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    const int g = gid[r];
    if ((unsigned)g >= (unsigned)S) continue;
    const unsigned h = rg_hash(g);
    const long long pos = (long long)atomicAdd(cursor + rg_bucket(h, pbits), 1ull);
    hb_out[pos] = (int)(h ^ 0x80000000u);
    for (int k = 0; k < ss.n; ++k) copy_elem(ss.out[k], pos, ss.vals[k], r, elem_bytes(ss.dt[k]));
  }
}

extern "C" int hdb_radix_partition(const int* gid, long long n, int S, int pbits,
                                   unsigned long long* counts, unsigned long long* cursor,
                                   int* hb_out, const StreamSet* ss, int pass, int grid,
                                   int block, void* stream) {
  if (pbits < 0 || pbits > 15) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (pass == 0) {
    size_t smem = (size_t)sizeof(unsigned int) << pbits;
    int rc = set_smem((const void*)part_hist_kernel, smem);
    if (rc) return rc;
    part_hist_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(gid, n, S, pbits, counts);
  } else {
    part_scatter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(gid, n, S, pbits, cursor,
                                                                  hb_out, *ss);
  }
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

static int group_prepare(const void* fn, size_t smem) {
  int rc = set_smem(fn, smem);
  if (rc) return rc;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
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
    int rc = group_prepare(fn, smem);
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
// (arg = pbits), 1 part_scatter_kernel, 2 group_kernel (arg = max_rows),
// 3 compact_kernel.
extern "C" int hdb_radix_info(int which, int arg, int* out) {
  switch (which) {
    case 0: return kernel_info((const void*)part_hist_kernel, 256, (size_t)4 << arg, out);
    case 1: return kernel_info((const void*)part_scatter_kernel, 256, 0, out);
    case 2: {
      int block;
      const void* fn = group_fn(arg, &block);
      const size_t smem = group_smem_bytes(arg);
      int rc = group_prepare(fn, smem);
      return rc ? rc : kernel_info(fn, block, smem, out);
    }
    default: return kernel_info((const void*)compact_kernel, 128, 0, out);
  }
}
