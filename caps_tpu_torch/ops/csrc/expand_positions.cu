// Segmented-expand positions: invert offsets = cumsum(counts).
//
// Replaces caps_tpu/ops/expand.py expand_positions (Pallas _expand_kernel).
// For each output slot t < out_cap it gives the left row l it expands
// from, the match position r_pos = lo[l] + t - offsets[l - 1], and
// valid = t < total; invalid slots are 0.  Arithmetic is int32 modulo
// 2^32, as in the TPU kernel (the wrapper bounds out_cap + cap_l).
//
// Bound: bytes.  The floor is the three outputs (9 B a slot) plus one
// read of counts and lo.  A binary search of offsets per slot would make
// each slot wait on ~log2(cap_l) dependent loads from L2; instead this is
// a load-balanced merge path over the merged sequence of the slots
// [0, total) and the row ends:
//
//   row k ends at merged position E[k] = offsets[k] + k, and slot t sits
//   at t + (rows ended before it), so a tile of NV merged items is cut
//   by the number of row ends before its first item.
//
// 1. scan_reduce: each block sums NV counts.
// 2. scan_partition: each block takes its prefix from the block sums,
//    scans its NV rows, writes E[k] and base[k] = lo[k] - offsets[k-1] - k
//    (so r_pos = base[k] + merged position), and, for every tile
//    boundary b*NV in (E[k-1], E[k]], split[b] = k.  The partition costs
//    no search at all, and this pass replaces the torch prelude.  Loads
//    and stores go through shared memory, coalesced.
// 3. expand_tiles: block b loads its window of E and base into shared
//    memory with coalesced loads; each thread finds its start by one
//    binary search in shared memory and walks VT merged items serially
//    (a row end advances the row, a slot stages its row in shared
//    memory); the store phase derives r_pos = base[k] + t + k and
//    valid = t < total from the staged row and writes with 16-byte
//    stores.  24.8 KB of shared memory lets eight blocks share an SM.
//    A tile past the last row end is padding and stores zeros.
//
// A zero-count row costs one merged item and never a slot, so no
// compaction prelude is needed; a row with millions of matches spans as
// many tiles as its slots need.  The grid comes from out_cap + cap_l,
// which the host knows: the total stays on the card.
#include <cuda_runtime.h>
#include <stdint.h>

static constexpr int THREADS = 256;          // ops/expand.py THREADS
static constexpr int VT = 8;                 // ops/expand.py VT
static constexpr int NV = THREADS * VT;      // items a tile, rows a scan tile
static constexpr int WARPS = THREADS / 32;

template <typename T>
__device__ __forceinline__ unsigned load_u32(const T* p, int i) {
  return (unsigned)(long long)__ldg(p + i);
}

__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  unsigned s = 0;
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// shared-memory index with one pad word every 32: a thread's VT
// consecutive items are VT words apart, which would otherwise put
// VT / 4 ... 8 threads of a warp on one bank
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

template <typename C>
__global__ void __launch_bounds__(THREADS)
scan_reduce(const C* __restrict__ counts, int cap_l,
            unsigned* __restrict__ partial) {
  __shared__ unsigned red[WARPS];
  const int base = blockIdx.x * NV;
  unsigned s = 0;
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    int k = base + v * THREADS + threadIdx.x;
    if (k < cap_l) s += load_u32(counts, k);
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

template <typename C, typename L>
__global__ void __launch_bounds__(THREADS)
scan_partition(const C* __restrict__ counts, const L* __restrict__ lo,
               int cap_l, const unsigned* __restrict__ partial,
               int n_tiles, int* __restrict__ ends, int* __restrict__ base,
               int* __restrict__ split) {
  __shared__ unsigned red[WARPS];
  __shared__ unsigned warp_tot[WARPS];
  __shared__ unsigned c_s[NV + NV / 32];
  __shared__ unsigned l_s[NV + NV / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * NV;
  // coalesced loads of the tile's counts and lo
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    const int i = v * THREADS + tid;
    const bool in = row0 + i < cap_l;
    c_s[skew(i)] = in ? load_u32(counts, row0 + i) : 0u;
    l_s[skew(i)] = in ? load_u32(lo, row0 + i) : 0u;
  }
  unsigned prefix = 0;
  for (int i = tid; i < (int)blockIdx.x; i += THREADS) prefix += partial[i];
  prefix = block_sum(prefix, red);  // its barriers also publish c_s, l_s
  // thread tid owns the VT consecutive rows row0 + tid*VT + v
  unsigned c[VT], l[VT];
  unsigned mine = 0;
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    c[v] = c_s[skew(tid * VT + v)];
    l[v] = l_s[skew(tid * VT + v)];
    mine += c[v];
  }
  // exclusive scan of the threads' sums: in the warp, then over warps
  unsigned incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  unsigned before = prefix + incl - mine;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];

#pragma unroll
  for (int v = 0; v < VT; ++v) {
    const int k = row0 + tid * VT + v;
    const unsigned start = before;          // offsets[k - 1]
    before += c[v];                         // offsets[k]
    const int e = (int)(before + (unsigned)k);
    // staged in place of the row's count and lo (only this thread
    // reads those slots)
    c_s[skew(tid * VT + v)] = (unsigned)e;
    l_s[skew(tid * VT + v)] = l[v] - start - (unsigned)k;
    if (k >= cap_l) continue;
    // tile boundaries b * NV in (E[k-1], E[k]] start inside row k's run
    const int e_prev = (int)(start + (unsigned)k) - 1;
    int b_lo = (e_prev + NV) / NV;
    if (b_lo < 0) b_lo = 0;
    int b_hi = e / NV;
    if (b_hi > n_tiles) b_hi = n_tiles;
    for (int b = b_lo; b <= b_hi; ++b) split[b] = k;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    const int i = v * THREADS + tid;
    if (row0 + i < cap_l) {
      ends[row0 + i] = (int)c_s[skew(i)];
      base[row0 + i] = (int)l_s[skew(i)];
    }
  }
}

// Store slots j0 .. j0 + n - 1 of the three outputs, slot i's values
// (l_idx, r_pos, valid) = get(i): scalar stores up to a multiple of 4
// slots, then 16-byte stores of l_idx and r_pos and 4-byte stores of
// valid, then a scalar tail (the outputs come from torch.empty, so
// their starts are 256-byte aligned).
template <typename F>
__device__ __forceinline__ void store_slots(long long j0, int n,
                                            int* __restrict__ l_idx,
                                            int* __restrict__ r_pos,
                                            uint8_t* __restrict__ valid,
                                            F get) {
  if (n <= 0) return;
  const int head = (int)min((long long)((-j0) & 3), (long long)n);
  const int body = (n - head) & ~3;
  const int tail = n - head - body;
  const int tid = threadIdx.x;
  if (tid < head + tail) {
    const int i = tid < head ? tid : head + body + (tid - head);
    const int3 x = get(i);
    l_idx[j0 + i] = x.x;
    r_pos[j0 + i] = x.y;
    valid[j0 + i] = (uint8_t)x.z;
  }
  for (int i = head + 4 * tid; i < head + body; i += 4 * THREADS) {
    const int3 a = get(i), b = get(i + 1), c = get(i + 2), d = get(i + 3);
    const long long t = j0 + i;
    *reinterpret_cast<int4*>(l_idx + t) = make_int4(a.x, b.x, c.x, d.x);
    *reinterpret_cast<int4*>(r_pos + t) = make_int4(a.y, b.y, c.y, d.y);
    *reinterpret_cast<uchar4*>(valid + t) =
        make_uchar4(a.z, b.z, c.z, d.z);
  }
}

__global__ void __launch_bounds__(THREADS)
expand_tiles(const int* __restrict__ ends, const int* __restrict__ base,
             int cap_l, int out_cap, const int* __restrict__ split,
             int* __restrict__ l_idx, int* __restrict__ r_pos,
             uint8_t* __restrict__ valid) {
  // 24.8 KB: eight blocks an SM
  __shared__ int e_s[NV + 1];
  __shared__ int b_s[NV + 1];
  __shared__ int l_s[NV + NV / 32];
  const int tid = threadIdx.x;
  const long long D = (long long)blockIdx.x * NV;
  // E[cap_l - 1] = total + cap_l - 1: the last row end
  const long long e_last = cap_l > 0 ? (long long)__ldg(&ends[cap_l - 1])
                                     : -1;
  if (D > e_last) {
    // padding: every item is a slot past the total
    const long long t0 = D - cap_l;
    const long long n = min((long long)NV, out_cap - t0);
    store_slots(t0, (int)n, l_idx, r_pos, valid,
                [](int) { return make_int3(0, 0, 0); });
    return;
  }
  const int i0 = __ldg(&split[blockIdx.x]);
  const int i1 = (D + NV <= e_last) ? __ldg(&split[blockIdx.x + 1]) : cap_l;
  const int rows_hi = i1 < cap_l - 1 ? i1 : cap_l - 1;
  const int n_w = rows_hi - i0 + 1;
  for (int i = tid; i < n_w; i += THREADS) {
    e_s[i] = __ldg(&ends[i0 + i]);
    b_s[i] = __ldg(&base[i0 + i]);
  }
  __syncthreads();

  const int p0 = (int)D + tid * VT;
  // rows of the window that end before p0
  int a = 0, b = n_w;
  while (a < b) {
    int m = (a + b) >> 1;
    if (e_s[m] < p0) a = m + 1; else b = m;
  }
  int k = i0 + a;
  const long long j0 = D - i0;
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    const int p = p0 + v;
    if (k < cap_l && e_s[k - i0] == p) {
      ++k;                                  // row k's end: no slot
      continue;
    }
    // slot t = p - k belongs to row k (past the last row: padding)
    l_s[skew((int)((long long)p - k - j0))] = k;
  }
  __syncthreads();
  long long n_out = NV - (i1 - i0);
  if (j0 + n_out > out_cap) n_out = out_cap - j0;
  // r_pos = base[k] + merged position = base[k] + t + k; valid = t < total
  const long long total = e_last - (cap_l - 1);
  store_slots(j0, (int)n_out, l_idx, r_pos, valid, [&](int i) {
    const long long t = j0 + i;
    if (t >= total) return make_int3(0, 0, 0);
    const int k = l_s[skew(i)];
    return make_int3(k, (int)((unsigned)b_s[k - i0] + (unsigned)t
                              + (unsigned)k), 1);
  });
}

template <typename C, typename L>
static cudaError_t scan(const void* counts, const void* lo, int cap_l,
                 int scan_tiles, int n_tiles, unsigned* partial, int* ends,
                 int* base, int* split, cudaStream_t s) {
  scan_reduce<C><<<scan_tiles, THREADS, 0, s>>>(
      static_cast<const C*>(counts), cap_l, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_partition<C, L><<<scan_tiles, THREADS, 0, s>>>(
      static_cast<const C*>(counts), static_cast<const L*>(lo), cap_l,
      partial, n_tiles, ends, base, split);
  return cudaGetLastError();
}

// counts_64 / lo_64: 1 for int64 tensors, 0 for int32.  scratch holds
// ends (cap_l) + base (cap_l) + partial (scan_tiles) + split
// (n_tiles + 1) int32 words.  The wrapper computes scan_tiles =
// ceil(cap_l / NV) and n_tiles = ceil((out_cap + cap_l) / NV).
extern "C" int expand_positions(const void* counts, int counts_64,
                                const void* lo, int lo_64, int cap_l,
                                int out_cap, int scan_tiles, int n_tiles,
                                void* scratch, void* l_idx, void* r_pos,
                                void* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ends = static_cast<int*>(scratch);
  int* base = ends + cap_l;
  unsigned* partial = reinterpret_cast<unsigned*>(base + cap_l);
  int* split = base + cap_l + scan_tiles;
  cudaError_t err = cudaSuccess;
  if (cap_l > 0) {
    if (counts_64 && lo_64)
      err = scan<long long, long long>(counts, lo, cap_l, scan_tiles,
                                       n_tiles, partial, ends, base, split, s);
    else if (counts_64)
      err = scan<long long, int>(counts, lo, cap_l, scan_tiles, n_tiles,
                                 partial, ends, base, split, s);
    else if (lo_64)
      err = scan<int, long long>(counts, lo, cap_l, scan_tiles, n_tiles,
                                 partial, ends, base, split, s);
    else
      err = scan<int, int>(counts, lo, cap_l, scan_tiles, n_tiles, partial,
                           ends, base, split, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_tiles > 0) {
    expand_tiles<<<n_tiles, THREADS, 0, s>>>(
        ends, base, cap_l, out_cap, split, static_cast<int*>(l_idx),
        static_cast<int*>(r_pos), static_cast<uint8_t*>(valid));
    err = cudaGetLastError();
  }
  return (int)err;
}
