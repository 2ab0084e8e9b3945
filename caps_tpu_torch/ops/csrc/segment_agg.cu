// Dense-domain segment aggregation: the group-by histogram.
//
// Replaces caps_tpu/ops/segment.py dense_segment_agg (Pallas _agg_kernel).
// out[s] = agg{ values[r] : codes[r] == s, ok[r] }, s in [0, S), with the
// kinds count, sum_f32, sum_i32, min_i32, max_i32, min_f32, max_f32 and
// the identities 0 / INT_MAX / INT_MIN / +inf / -inf for empty slots.
// Float min/max order -0.0 below +0.0 and let any NaN win, as jnp.min /
// jnp.max do in the TPU kernel.
//
// Bound: bytes.  Each row is read once (code + ok + value: 5 or 9 bytes)
// and the slots are few, so the floor is the rows over the card's memory
// rate.  The TPU kernel compares every row with every slot of a segment
// tile; its grid walks segment tiles (axis 0) and row tiles (axis 1) in
// order with the output tile resident.  Here one launch handles a window
// of slots (the TPU's segment tile) and every block of the grid:
//
//   * keeps a histogram of the window in shared memory and streams its
//     rows through it with shared-memory atomics.  Integer atomics
//     commute, so the result does not depend on their timing; float
//     min/max ride integer atomics on an order-preserving int image of
//     the float (NaN mapped to the extreme key of the kind);
//   * reads 16 bytes of codes and values and 4 bytes of ok a thread a
//     step, UNROLL steps issued before any is used, so ~80 bytes a
//     thread are in flight; rows before the first 16-byte boundary, the
//     tail, and inputs that cannot be aligned take a scalar loop;
//   * folds with the other blocks of its thread-block cluster through
//     distributed shared memory (each block folds a slice of the window
//     in rank order) and adds its slice into a device-wide accumulator
//     with device atomics, then takes a ticket; the grid's last block
//     copies the accumulator into out and sets it and the ticket back to
//     0 for the next launch on the stream.  One launch, no fill and no
//     second kernel.  Device atomics, not a last cluster folding every
//     cluster's partial: 64 x S partials read by a few SMs cost more than
//     the rows.  Lanes that share a code are not combined first
//     (__match_any_sync): that was slower at every S tried, 1 and 3 too.
//
// What remains above the bound is the fold: a cluster barrier, the
// atomics, a fence, the ticket and the last block's read of the
// accumulator follow one another after the last block's rows
// (chip_compare.py --parts breakdown times the kernel without it).
// sum_f32 must not depend on atomic timing (the engine's determinism
// check digests results): it sums in double in a fixed order and rounds
// once.  A block loads a tile of SUM_TILE rows, sorts (code, row) keys in
// shared memory (a bitonic network, so the work per tile does not grow
// with the slots), takes a segmented scan over the sorted tile in a
// fixed tree, and the thread holding a run's last row adds the run to
// the slot.  Blocks take tiles in a fixed order; clusters fold in rank
// order and the last cluster folds the cluster partials in cluster order.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <limits.h>

namespace cg = cooperative_groups;

enum { COUNT = 0, SUM_F32 = 1, SUM_I32 = 2, MIN_I32 = 3, MAX_I32 = 4,
       MIN_F32 = 5, MAX_F32 = 6 };

// ops/segment.py segment_geometry mirrors these
static constexpr int THREADS = 256;
static constexpr int HIST_CLUSTER = 4;   // blocks a cluster, 32-bit kinds
static constexpr int SUM_CLUSTER = 8;    // sum_f32 (fewer partials to fold)
static constexpr int UNROLL = 4;
static constexpr int SUM_TILE = 1024;
static constexpr int BLOCKS_PER_SM = 4;
static constexpr int WARPS = THREADS / 32;
static constexpr unsigned DEAD = 0xFFFFFFFFu;   // sum_f32 key of no row
static_assert(SUM_TILE == 4 * THREADS, "sum_kernel scans 4 sorted rows a thread");

template <int KIND> struct Acc { using T = int; };
template <> struct Acc<SUM_F32> { using T = double; };

template <int KIND>
__device__ __forceinline__ typename Acc<KIND>::T ident() {
  if (KIND == MIN_I32) return INT_MAX;
  if (KIND == MAX_I32) return INT_MIN;
  if (KIND == MIN_F32) return 0x7F800000;                          // key(+inf)
  if (KIND == MAX_F32) return (int)(0xFF800000u ^ 0x7FFFFFFFu);    // key(-inf)
  return 0;
}

template <int KIND>
__device__ __forceinline__ typename Acc<KIND>::T combine(
    typename Acc<KIND>::T a, typename Acc<KIND>::T b) {
  if (KIND == MIN_I32 || KIND == MIN_F32) return min(a, b);
  if (KIND == MAX_I32 || KIND == MAX_F32) return max(a, b);
  return a + b;
}

// Monotone float -> int32 image: a < b as floats iff key(a) < key(b),
// -0.0 (key -1) below +0.0 (key 0); a NaN of either sign takes nan_key.
__device__ __forceinline__ int f2key(int bits, int nan_key) {
  if ((bits & 0x7FFFFFFF) > 0x7F800000) return nan_key;
  return bits >= 0 ? bits : (bits ^ 0x7FFFFFFF);
}

// The value one row adds to its slot, from the raw 32 bits of its value.
template <int KIND>
__device__ __forceinline__ int row_value(int raw) {
  if (KIND == COUNT) return 1;
  if (KIND == MIN_F32) return f2key(raw, INT_MIN);
  if (KIND == MAX_F32) return f2key(raw, INT_MAX);
  return raw;
}

template <int KIND>
__device__ __forceinline__ void store_out(void* out, int s,
                                          typename Acc<KIND>::T acc) {
  if (KIND == SUM_F32) {
    static_cast<float*>(out)[s] = (float)acc;
  } else if (KIND == MIN_F32 || KIND == MAX_F32) {
    int k = (int)acc;   // an extreme key decodes to a NaN
    static_cast<float*>(out)[s] = __int_as_float(k >= 0 ? k : (k ^ 0x7FFFFFFF));
  } else {
    static_cast<int*>(out)[s] = (int)acc;
  }
}

template <int KIND>
__device__ __forceinline__ void add_row(int* hist, int key, int v) {
  if (KIND == COUNT || KIND == SUM_I32) atomicAdd(&hist[key], v);
  else if (KIND == MIN_I32 || KIND == MIN_F32) atomicMin(&hist[key], v);
  else atomicMax(&hist[key], v);
}

__device__ __forceinline__ int comp(const int4& x, int k) {
  return k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
}

// The cluster's fold of the slots [lo, hi) this block owns: the members'
// histograms in rank order, read through distributed shared memory.
template <int KIND>
__device__ __forceinline__ typename Acc<KIND>::T cluster_slot(
    cg::cluster_group& cluster, typename Acc<KIND>::T* hist, int s) {
  constexpr int C = KIND == SUM_F32 ? SUM_CLUSTER : HIST_CLUSTER;
  typename Acc<KIND>::T acc = ident<KIND>();
#pragma unroll
  for (int q = 0; q < C; ++q)
    acc = combine<KIND>(acc, cluster.map_shared_rank(hist, q)[s]);
  return acc;
}

// sum_f32's ticket: after every member of the cluster has written what
// it folds, rank 0 takes a ticket and tells each member whether this
// cluster is the grid's last.  Returns that, with the writes of every
// cluster visible.
__device__ __forceinline__ bool last_cluster(cg::cluster_group& cluster,
                                             int* ticket, int* last) {
  __threadfence();
  cluster.sync();   // also: no member reads another's histogram after this
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    const int is_last = atomicAdd(ticket, 1) == (int)(gridDim.x / SUM_CLUSTER) - 1;
    for (int q = 0; q < SUM_CLUSTER; ++q) *cluster.map_shared_rank(last, q) = is_last;
  }
  cluster.sync();
  if (!*last) return false;
  __threadfence();
  return true;
}

// The device-wide accumulator of the 32-bit kinds holds 0 between
// launches: count and sums add; min and max take an unsigned max of an
// order-preserving (for min, order-reversing) image whose identity is 0.
template <int KIND>
__device__ __forceinline__ unsigned to_acc(int v) {
  if (KIND == MIN_I32 || KIND == MIN_F32) return ~((unsigned)v ^ 0x80000000u);
  if (KIND == MAX_I32 || KIND == MAX_F32) return (unsigned)v ^ 0x80000000u;
  return (unsigned)v;
}
template <int KIND>
__device__ __forceinline__ int from_acc(unsigned u) {
  if (u == 0u) return ident<KIND>();   // no row (float min/max: +-inf)
  if (KIND == MIN_I32 || KIND == MIN_F32) return (int)(~u ^ 0x80000000u);
  if (KIND == MAX_I32 || KIND == MAX_F32) return (int)(u ^ 0x80000000u);
  return (int)u;
}

// Fold the blocks' 32-bit histograms into out (see the header): each
// block folds its slice of the window over its cluster through
// distributed shared memory and adds it into acc with device atomics
// (they commute, so the order does not matter), then takes a ticket; the
// grid's last block reads acc into out and zeroes it and the ticket.
// Every thread of every block calls it once its block's histogram is
// complete.
template <int KIND>
__device__ void fold_hist(int* hist, int W, unsigned* acc, int* ticket,
                          void* out, int* last) {
  cg::cluster_group cluster = cg::this_cluster();
  const int slice = (W + HIST_CLUSTER - 1) / HIST_CLUSTER;
  const int lo = (int)cluster.block_rank() * slice;
  const int hi = min(W, lo + slice);
  const bool one = gridDim.x == HIST_CLUSTER;
  cluster.sync();   // every member's histogram is complete
  for (int s = lo + (int)threadIdx.x; s < hi; s += THREADS) {
    const int v = cluster_slot<KIND>(cluster, hist, s);
    if (one) store_out<KIND>(out, s, v);
    else if (v != ident<KIND>()) {
      if (KIND == COUNT || KIND == SUM_I32) atomicAdd(&acc[s], to_acc<KIND>(v));
      else atomicMax(&acc[s], to_acc<KIND>(v));
    }
  }
  if (!one) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (*last) {
      __threadfence();
#pragma unroll 4
      for (int s = threadIdx.x; s < W; s += THREADS) {
        store_out<KIND>(out, s, from_acc<KIND>(__ldcg(&acc[s])));
        acc[s] = 0u;
      }
      if (threadIdx.x == 0) *ticket = 0;
    }
  }
  cluster.sync();   // no block leaves while a member may read its histogram
}

// Fold the blocks' double histograms of sum_f32 into out in a fixed
// order: each cluster folds in rank order and writes its partial; the
// last cluster folds the partials in cluster order, P threads a slot
// (P | 32, so they share a warp) each taking every P-th partial, then a
// butterfly over the P.  P depends only on the window, so the order is
// fixed for a shape.
__device__ void fold_sum(double* hist, int W, double* partials, int* ticket,
                         void* out, int* last) {
  cg::cluster_group cluster = cg::this_cluster();
  const int clusters = gridDim.x / SUM_CLUSTER;
  const int slice = (W + SUM_CLUSTER - 1) / SUM_CLUSTER;
  const int lo = (int)cluster.block_rank() * slice;
  const int hi = min(W, lo + slice);
  cluster.sync();   // every member's histogram is complete
  double* mine = partials + (size_t)(blockIdx.x / SUM_CLUSTER) * W;
  for (int s = lo + (int)threadIdx.x; s < hi; s += THREADS) {
    const double v = cluster_slot<SUM_F32>(cluster, hist, s);
    if (clusters == 1) store_out<SUM_F32>(out, s, v);
    else mine[s] = v;
  }
  if (clusters == 1) { cluster.sync(); return; }
  if (!last_cluster(cluster, ticket, last)) return;
  int P = 1;
  while (P < 32 && 2 * P * max(hi - lo, 1) <= THREADS) P *= 2;
  const int p = threadIdx.x % P;
  for (int s0 = lo; s0 < hi; s0 += THREADS / P) {   // uniform over the block
    const int s = s0 + (int)threadIdx.x / P;
    double acc = 0.0;
    if (s < hi) {
#pragma unroll 8
      for (int k = p; k < clusters; k += P)
        acc += __ldcg(&partials[(size_t)k * W + s]);
    }
    for (int off = P / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    if (s < hi && p == 0) store_out<SUM_F32>(out, s, acc);
  }
  if (cluster.block_rank() == 0 && threadIdx.x == 0) *ticket = 0;
}

extern __shared__ __align__(16) unsigned char smem_raw[];

template <int KIND>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
hist_kernel(const int* __restrict__ codes, const uint8_t* __restrict__ ok,
            const int* __restrict__ values, int n, int head, int vec,
            int base, int W, unsigned* __restrict__ acc,
            int* __restrict__ ticket, void* __restrict__ out) {
  int* hist = reinterpret_cast<int*>(smem_raw);
  __shared__ int last;
  constexpr bool VALS = KIND != COUNT;
  for (int s = threadIdx.x; s < W; s += THREADS) hist[s] = ident<KIND>();
  __syncthreads();
  const int nthreads = gridDim.x * THREADS;
  const int gtid = blockIdx.x * THREADS + threadIdx.x;
  const int n4 = vec ? (n - head) >> 2 : 0;
  const int4* c4 = reinterpret_cast<const int4*>(codes + head);
  const uint32_t* o4 = reinterpret_cast<const uint32_t*>(ok + head);
  const int4* v4 = reinterpret_cast<const int4*>(values + head);
  for (int g0 = 0; g0 < n4; g0 += nthreads * UNROLL) {
    int4 c[UNROLL], v[UNROLL];
    uint32_t o[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int g = g0 + u * nthreads + gtid;
      const bool in = g < n4;
      c[u] = in ? __ldg(&c4[g]) : make_int4(0, 0, 0, 0);
      o[u] = in ? __ldg(&o4[g]) : 0u;
      if (VALS) v[u] = in ? __ldg(&v4[g]) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cw = comp(c[u], k) - base;
        if (((o[u] >> (8 * k)) & 0xFFu) && (unsigned)cw < (unsigned)W)
          add_row<KIND>(hist, cw, row_value<KIND>(VALS ? comp(v[u], k) : 0));
      }
    }
  }
  // scalar rows: [0, head) and the tail [head + 4 * n4, n)
  const int tail = head + 4 * n4;
  const int m = head + (n - tail);
  for (int j = gtid; j < m; j += nthreads) {
    const int r = j < head ? j : tail + (j - head);
    const int cw = __ldg(&codes[r]) - base;
    if (__ldg(&ok[r]) && (unsigned)cw < (unsigned)W)
      add_row<KIND>(hist, cw, row_value<KIND>(VALS ? __ldg(&values[r]) : 0));
  }
  fold_hist<KIND>(hist, W, acc, ticket, out, &last);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
sum_kernel(const int* __restrict__ codes, const uint8_t* __restrict__ ok,
           const float* __restrict__ values, int n, int base, int W,
           double* __restrict__ partials, int* __restrict__ ticket,
           void* __restrict__ out) {
  double* hist = reinterpret_cast<double*>(smem_raw);
  __shared__ unsigned keys[SUM_TILE];   // (slot << 10 | row in tile), DEAD
  __shared__ float tv[SUM_TILE];
  __shared__ int wflag[WARPS];
  __shared__ double wval[WARPS];
  __shared__ int last;
  for (int s = threadIdx.x; s < W; s += THREADS) hist[s] = 0.0;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (long long row0 = (long long)blockIdx.x * SUM_TILE; row0 < n;
       row0 += (long long)gridDim.x * SUM_TILE) {
    // thread t holds the keys of positions 4t .. 4t+3 in registers; all
    // three loads of a row are issued at once
    unsigned x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int li = 4 * t + i;
      const long long r = row0 + li;
      const bool in = r < n;
      const bool live = in && __ldg(&ok[r]);
      const int cw = (in ? __ldg(&codes[r]) : base) - base;
      tv[li] = in ? __ldg(&values[r]) : 0.f;
      x[i] = live && (unsigned)cw < (unsigned)W
                 ? ((unsigned)cw << 10) | (unsigned)li : DEAD;
    }
    // bitonic sort of the unique keys (a stable sort of the rows by
    // slot): partners within a thread, then across lanes by shuffles;
    // only the 6 stages with partners in another warp go through
    // shared memory
#pragma unroll
    for (int k = 2; k <= SUM_TILE; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        unsigned y[4];
        if (j >= 128) {
#pragma unroll
          for (int i = 0; i < 4; ++i) keys[4 * t + i] = x[i];
          __syncthreads();
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i] = keys[(4 * t + i) ^ j];
          __syncthreads();
        } else if (j >= 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i] = __shfl_xor_sync(0xFFFFFFFFu, x[i], j >> 2);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i] = x[i ^ j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pos = 4 * t + i;
          const bool keep_min = ((pos & k) == 0) == ((pos & j) == 0);
          x[i] = keep_min ? min(x[i], y[i]) : max(x[i], y[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) keys[4 * t + i] = x[i];
    __syncthreads();
    // segmented inclusive scan over the sorted tile, 4 positions a
    // thread, then the warp and the block, in a fixed tree
    int cc[4];
    double r[4];
    bool seen[4];
    const int prev = t == 0 ? -2 : (keys[4 * t - 1] == DEAD ? -1 : (int)(keys[4 * t - 1] >> 10));
    const int next = t == THREADS - 1 ? -2 : (keys[4 * t + 4] == DEAD ? -1 : (int)(keys[4 * t + 4] >> 10));
    bool f = false;
    double run = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned key = x[j];
      cc[j] = key == DEAD ? -1 : (int)(key >> 10);
      const double v = key == DEAD ? 0.0 : (double)tv[key & (SUM_TILE - 1)];
      const bool headj = cc[j] != (j ? cc[j - 1] : prev);
      run = headj ? v : run + v;
      f = f || headj;
      r[j] = run;
      seen[j] = f;
    }
    double v = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int fo = __shfl_up_sync(0xFFFFFFFFu, (int)f, d);
      const double vo = __shfl_up_sync(0xFFFFFFFFu, v, d);
      if (lane >= d) {
        if (!f) v = vo + v;
        f = f || fo;
      }
    }
    int fe = __shfl_up_sync(0xFFFFFFFFu, (int)f, 1);
    double ve = __shfl_up_sync(0xFFFFFFFFu, v, 1);
    if (lane == 0) { fe = 0; ve = 0.0; }
    if (lane == 31) { wflag[warp] = f; wval[warp] = v; }
    __syncthreads();
    double pv = 0.0;
    for (int w = 0; w < warp; ++w) pv = wflag[w] ? wval[w] : pv + wval[w];
    const double pre = fe ? ve : pv + ve;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool end = (j < 3 ? cc[j + 1] : next) != cc[j];
      if (end && cc[j] >= 0) hist[cc[j]] += seen[j] ? r[j] : pre + r[j];
    }
    __syncthreads();
  }
  fold_sum(hist, W, partials, ticket, out, &last);
}

template <typename... Params, typename... Args>
static int launch(void (*kernel)(Params...), int blocks, int cluster,
                  size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int KIND>
static int launch_hist(const void* codes, const void* ok, const void* values,
                       int n, int head, int vec, int base, int W, int blocks,
                       void* acc, void* ticket, void* out, cudaStream_t st) {
  return launch(hist_kernel<KIND>, blocks, HIST_CLUSTER, (size_t)W * sizeof(int), st,
                static_cast<const int*>(codes),
                static_cast<const uint8_t*>(ok),
                static_cast<const int*>(values), n, head, vec, base, W,
                static_cast<unsigned*>(acc), static_cast<int*>(ticket), out);
}

extern "C" {

// The device's SM count (the wrapper reads it once per device), or minus
// the CUDA error.
int segment_agg_sm_count(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount,
                                           device);
  return err == cudaSuccess ? v : -(int)err;
}

// One launch over the window [base, base + W) of the slots: out points at
// slot base.  blocks is a multiple of the kind's cluster size.  acc (at least W
// 32-bit words) and ticket (one) are zeroed device memory that only
// launches on this stream use; each launch leaves them zeroed.
// partials holds (blocks / SUM_CLUSTER) * W doubles for sum_f32 when there
// is more than one cluster.  Rows [head, head + 4k) are read 16 bytes
// at a time when vec is 1 (the wrapper checked the alignment).
int segment_agg(const void* codes, const void* ok, const void* values,
                int n, int head, int vec, int base, int W, int kind,
                int blocks, void* acc, void* partials, void* ticket,
                void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks <= 0 || blocks % (kind == SUM_F32 ? SUM_CLUSTER : HIST_CLUSTER) ||
      W <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case COUNT:   return launch_hist<COUNT>(codes, ok, values, n, head, vec, base, W, blocks, acc, ticket, out, st);
    case SUM_I32: return launch_hist<SUM_I32>(codes, ok, values, n, head, vec, base, W, blocks, acc, ticket, out, st);
    case MIN_I32: return launch_hist<MIN_I32>(codes, ok, values, n, head, vec, base, W, blocks, acc, ticket, out, st);
    case MAX_I32: return launch_hist<MAX_I32>(codes, ok, values, n, head, vec, base, W, blocks, acc, ticket, out, st);
    case MIN_F32: return launch_hist<MIN_F32>(codes, ok, values, n, head, vec, base, W, blocks, acc, ticket, out, st);
    case MAX_F32: return launch_hist<MAX_F32>(codes, ok, values, n, head, vec, base, W, blocks, acc, ticket, out, st);
    case SUM_F32:
      return launch(sum_kernel, blocks, SUM_CLUSTER, (size_t)W * sizeof(double), st,
                    static_cast<const int*>(codes),
                    static_cast<const uint8_t*>(ok),
                    static_cast<const float*>(values), n, base, W,
                    static_cast<double*>(partials), static_cast<int*>(ticket),
                    out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
