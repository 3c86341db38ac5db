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
// B6, one block per partition (group_kernel):
//   1. load the partition's hb into shared memory and sort (hb, local
//      index) with B4's block_bitonic_sort;
//   2. mark segment heads (hb differs from its left neighbour) and reduce
//      every segment with a block-wide segmented scan (seg_scan: each thread
//      walks a fixed run of at most tile / blockDim elements, then warp
//      shuffles and one shared array carry the runs' aggregates), so a hot
//      group costs what any other run of rows costs;
//   3. write one record per group (hb, row count, one total per stream) at
//      its rank within the partition into a staging area laid out like the
//      partitioned input, and the partition's group count;
// then compact_kernel copies the records of partition p to
// [goff[p], goff[p] + ng[p]) of the [cap] outputs, goff being the exclusive
// scan of the group counts (host glue), and turns hb back into gid.
// Partitions follow the top bits of h and are sorted inside, so the output
// is in ascending h order.  A partition with more rows than the tile sets
// flag bit 0 and writes no records.  Bound: bytes (the partitioned rows
// read once, the records written twice); the shared-memory sort comes next.
//
// Precision: counts and sumi are exact int64; sumf adds in float32 (a group
// lives in one partition); sumd adds in float64; MIN / MAX are exact on the
// order-preserving int32 keys of agg_common.cuh.
#include "agg_common.cuh"
#include "tile_sort.cuh"

#define RG_MULT 0x9E3779B1u
#define RG_INV 0x0E8B2F51u  // RG_MULT^-1 mod 2^32
#define RG_SENT 0x7FFFFFFF  // biased hash of no valid gid; sorts last

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

// Inclusive segmented scan of buf[0, n) in place: at element i, the op
// reduction of its segment's elements up to i.  A segment starts where
// head[i] is nonzero (head == nullptr: one segment).  Every thread of the
// block calls it; blockDim.x is a multiple of 32 and at most 1024.
template <typename T, typename Op>
__device__ void seg_scan(T* buf, const unsigned char* head, int n, Op op) {
  __shared__ T s_v[32];
  __shared__ int s_f[32];
  __shared__ int s_ok[32];
  const int items = (n + blockDim.x - 1) / blockDim.x;
  const int s = threadIdx.x * items;
  const int e = min(s + items, n);
  // 1. each thread's own run
  T v = T();
  int f = 0;
  const bool ok0 = s < e;
  if (ok0) {
    v = buf[s];
    f = head ? head[s] != 0 : s == 0;
    for (int i = s + 1; i < e; ++i) {
      if (head && head[i]) {
        f = 1;
        v = buf[i];
      } else {
        v = op(v, buf[i]);
      }
      buf[i] = v;
    }
  }
  // 2. segmented scan of the runs' (aggregate, has-head) pairs; a thread
  // with no elements is the identity
  int ok = ok0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const T pv = __shfl_up_sync(HDB_FULL_MASK, v, d);
    const int pf = __shfl_up_sync(HDB_FULL_MASK, f, d);
    const int pok = __shfl_up_sync(HDB_FULL_MASK, ok, d);
    if (lane >= d && pok) {
      if (!ok) {
        v = pv;
        f = pf;
        ok = 1;
      } else if (!f) {
        v = op(pv, v);
        f = pf;
      }
    }
  }
  // exclusive prefix within the warp
  T xv = __shfl_up_sync(HDB_FULL_MASK, v, 1);
  int xf = __shfl_up_sync(HDB_FULL_MASK, f, 1);
  int xok = __shfl_up_sync(HDB_FULL_MASK, ok, 1) && lane > 0;
  if (lane == 31) {
    s_v[warp] = v;
    s_f[warp] = f;
    s_ok[warp] = ok;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    T wv = lane < nw ? s_v[lane] : T();
    int wf = lane < nw ? s_f[lane] : 0;
    int wok = lane < nw ? s_ok[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const T pv = __shfl_up_sync(HDB_FULL_MASK, wv, d);
      const int pf = __shfl_up_sync(HDB_FULL_MASK, wf, d);
      const int pok = __shfl_up_sync(HDB_FULL_MASK, wok, d);
      if (lane >= d && pok) {
        if (!wok) {
          wv = pv;
          wf = pf;
          wok = 1;
        } else if (!wf) {
          wv = op(pv, wv);
          wf = pf;
        }
      }
    }
    // exclusive prefix over warps
    const T ev = __shfl_up_sync(HDB_FULL_MASK, wv, 1);
    const int ef = __shfl_up_sync(HDB_FULL_MASK, wf, 1);
    const int eok = __shfl_up_sync(HDB_FULL_MASK, wok, 1) && lane > 0;
    __syncwarp();
    if (lane < nw) {
      s_v[lane] = ev;
      s_f[lane] = ef;
      s_ok[lane] = eok;
    }
  }
  __syncthreads();
  // carry into this thread = (warps before) then (lanes before)
  if (warp > 0 && s_ok[warp]) {
    if (!xok) {
      xv = s_v[warp];
      xf = s_f[warp];
      xok = 1;
    } else if (!xf) {
      xv = op(s_v[warp], xv);
    }
  }
  // 3. the carry reaches this run's elements before its first head
  if (xok && ok0) {
    for (int i = s; i < e; ++i) {
      if (head ? head[i] != 0 : i == 0) break;
      buf[i] = op(xv, buf[i]);
    }
  }
  __syncthreads();
}

// Shared-memory bytes of group_kernel for a tile: keys, indices, group
// ranks (int32 each), one 8-byte scan buffer, head flags.
__host__ __device__ __forceinline__ size_t group_smem_bytes(int tile) {
  return (size_t)tile * (4 + 4 + 4 + 8 + 1);
}

__device__ __forceinline__ bool seg_end(const unsigned char* head, int i, int n) {
  return i == n - 1 || head[i + 1] != 0;
}

__global__ void group_kernel(const int* __restrict__ hb, StreamSet ss,
                             const unsigned long long* __restrict__ counts,
                             const long long* __restrict__ offsets, int tile,
                             int* __restrict__ stage_hb, long long* __restrict__ stage_len,
                             int* __restrict__ ng_part, int* __restrict__ flag) {
  extern __shared__ __align__(8) unsigned char smem[];
  double* buf_raw = (double*)smem;  // 8-byte scan buffer first, for alignment
  int* keys = (int*)(smem + (size_t)tile * 8);
  int* idx = keys + tile;
  int* rank = idx + tile;
  unsigned char* head = (unsigned char*)(rank + tile);

  const int p = blockIdx.x;
  const long long cnt_ll = (long long)counts[p];
  const long long off = offsets[p];
  if (cnt_ll == 0) {
    if (threadIdx.x == 0) ng_part[p] = 0;
    return;
  }
  if (cnt_ll > tile) {
    if (threadIdx.x == 0) {
      ng_part[p] = 0;
      atomicOr(flag, 1);
    }
    return;
  }
  const int cnt = (int)cnt_ll;
  int n2 = 32;
  while (n2 < cnt) n2 <<= 1;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    keys[i] = i < cnt ? hb[off + i] : RG_SENT;
    idx[i] = i;
  }
  __syncthreads();
  block_bitonic_sort(keys, idx, n2);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const unsigned char hd = (i == 0 || keys[i] != keys[i - 1]) ? 1 : 0;
    head[i] = hd;
    rank[i] = hd;
  }
  __syncthreads();
  seg_scan<int>(rank, nullptr, cnt, AddOp());  // 1-based group rank
  const int ng = rank[cnt - 1];

  // row counts per group
  long long* lbuf = (long long*)buf_raw;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) lbuf[i] = 1;
  __syncthreads();
  seg_scan<long long>(lbuf, head, cnt, AddOp());
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    if (!seg_end(head, i, cnt)) continue;
    const long long g = off + rank[i] - 1;
    stage_hb[g] = keys[i];
    stage_len[g] = lbuf[i];
  }
  __syncthreads();

  for (int k = 0; k < ss.n; ++k) {
    const void* v = ss.vals[k];
    const int dt = ss.dt[k];
    const int op = ss.op[k];
    if (op == OP_COUNT || op == OP_SUMI) {
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
        const long long x = load_int(v, dt, off + idx[i]);
        lbuf[i] = op == OP_COUNT ? (x != 0) : x;
      }
      __syncthreads();
      seg_scan<long long>(lbuf, head, cnt, AddOp());
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        if (seg_end(head, i, cnt)) ((long long*)ss.out[k])[off + rank[i] - 1] = lbuf[i];
    } else if (op == OP_SUMF) {
      float* fbuf = (float*)buf_raw;
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        fbuf[i] = ((const float*)v)[off + idx[i]];
      __syncthreads();
      seg_scan<float>(fbuf, head, cnt, AddOp());
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        if (seg_end(head, i, cnt)) ((float*)ss.out[k])[off + rank[i] - 1] = fbuf[i];
    } else if (op == OP_SUMD) {
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        buf_raw[i] = load_f64(v, dt, off + idx[i]);
      __syncthreads();
      seg_scan<double>(buf_raw, head, cnt, AddOp());
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        if (seg_end(head, i, cnt)) ((double*)ss.out[k])[off + rank[i] - 1] = buf_raw[i];
    } else {
      const bool is_min = op == OP_MIN;
      int* ibuf = (int*)buf_raw;
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        ibuf[i] = load_key(v, dt, off + idx[i], is_min);
      __syncthreads();
      if (is_min) seg_scan<int>(ibuf, head, cnt, MinOp());
      else seg_scan<int>(ibuf, head, cnt, MaxOp());
      for (int i = threadIdx.x; i < cnt; i += blockDim.x)
        if (seg_end(head, i, cnt)) ((int*)ss.out[k])[off + rank[i] - 1] = ibuf[i];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) ng_part[p] = ng;
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

extern "C" int hdb_radix_group(const int* hb, const StreamSet* parts, const StreamSet* stage,
                               const unsigned long long* counts, const long long* offsets, int P,
                               int tile, int* stage_hb, long long* stage_len, int* ng_part,
                               int* flag, const long long* goff, long long cap, int* gid_out,
                               long long* len_out, int pass, void* stream) {
  if (tile < 32 || (tile & (tile - 1)) != 0 || P < 1) return (int)cudaErrorInvalidValue;
  if (pass == 0) {
    size_t smem = group_smem_bytes(tile);
    int rc = set_smem((const void*)group_kernel, smem);
    if (rc) return rc;
    group_kernel<<<P, 256, smem, (cudaStream_t)stream>>>(hb, *parts, counts, offsets, tile,
                                                         stage_hb, stage_len, ng_part, flag);
  } else {
    compact_kernel<<<P, 128, 0, (cudaStream_t)stream>>>(offsets, ng_part, goff, cap, stage_hb,
                                                        stage_len, *stage, gid_out, len_out);
  }
  return (int)cudaGetLastError();
}
