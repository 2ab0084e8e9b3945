// Stable multi-plane sort permutation: a merge sort by co-ranking.
//
// Replaces caps_tpu/ops/sort.py bitonic_sort_perm (Pallas _stage_kernel).
// Keys arrive as P int32 planes (split_planes), each of length cap (a
// power of two, 256..16384).  The comparator is strict: planes
// lexicographically, then the original row index — so the result is THE
// stable ascending permutation, and any algorithm that yields it computes
// the function of the TPU's bitonic network.
//
// Bound: in practice latency.  The data is small (P * cap * 4 B in,
// cap * 4 B out); what costs is the chain of dependent compares, the
// barriers between them and the launch.  A bitonic network at cap 1024
// is 55 dependent stages with a block barrier each and half the threads
// idle.  This design:
//
// 1. sort_chunk: a block of C <= 1024 threads sorts a chunk of C rows,
//    a row a thread (ops/sort.py picks C; timing on the card showed a
//    row a thread beats a larger chunk with several rows a thread).  It
//    stages the chunk's P planes in shared memory once, every load of a
//    thread in flight together, and drops the planes on which every row
//    of the chunk equals its first row (the main path's high words and
//    null flags).  Each row then travels as one int4: its first three
//    active planes and its index.  log2(C) merge passes follow: in each,
//    every row finds its place by a binary search in its partner run
//    (co-ranking): pos = own offset + count of partner rows that order
//    before it.  A probe is one 16-byte shared-memory load and a compare
//    in registers; only rows equal on three planes read further planes.
//    Every thread works in every pass, and while the next pass's runs
//    lie inside one warp the pass ends with __syncwarp, not a block
//    barrier (4 of the log2(C) barriers).
// 2. sort_merge: above C, log2(cap / C) passes over all SMs, one thread
//    a row, each a binary search in its partner run in device memory
//    (the planes, 4 MB at most, sit in L2) over all P planes.
//
// One launch for cap <= C, 1 + log2(cap / C) above.  The plane pointers
// travel in the kernel parameters (no stacking copy) for P <= 64; above
// that the wrapper stacks them and passes one base pointer.
#include <cuda_runtime.h>
#include <stdint.h>

static constexpr int MAX_PTRS = 64;
static constexpr int MAX_THREADS = 1024;   // ops/sort.py MAX_THREADS
static constexpr int MERGE_THREADS = 256;  // threads of a merge-pass block
static constexpr int PACKED = 3;           // active planes packed beside the index

struct Planes {
  const int* ptr[MAX_PTRS];
  const int* stacked;  // non-null: plane p at stacked + p * cap
  int P;
  int cap;
};

__device__ __forceinline__ const int* plane(const Planes& k, int p) {
  return k.stacked ? k.stacked + (size_t)p * k.cap : k.ptr[p];
}

// does row b order before row a?  Each carries its first PACKED active
// planes and its row index (.w); further active planes are read from
// the staged keys at their offsets.
__device__ __forceinline__ bool before_packed(int4 b, int4 a,
                                              const int* keys,
                                              const int* off, int na) {
  if (b.x != a.x) return b.x < a.x;
  if (b.y != a.y) return b.y < a.y;
  if (b.z != a.z) return b.z < a.z;
  for (int j = PACKED; j < na; ++j) {
    int x = keys[off[j] + b.w], y = keys[off[j] + a.w];
    if (x != y) return x < y;
  }
  return b.w < a.w;
}

__global__ void __launch_bounds__(MAX_THREADS)
sort_chunk(const __grid_constant__ Planes k, int* __restrict__ out) {
  extern __shared__ int4 smem4[];
  const int n = blockDim.x, P = k.P, q = threadIdx.x;  // a row a thread
  int4* buf = smem4;                      // 2 * n packed rows
  int* keys = reinterpret_cast<int*>(smem4 + 2 * n);   // P * n
  int* differ = keys + (size_t)P * n;     // P
  int* off = differ + P;                  // max(P, PACKED)
  __shared__ int n_active;
  const size_t row0 = (size_t)blockIdx.x * n;

  // stage the row's planes: up to 8 loads in flight a thread
  for (int p0 = 0; p0 < P; p0 += 8) {
    int v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (p0 + j < P) v[j] = __ldg(plane(k, p0 + j) + row0 + q);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (p0 + j < P) keys[(size_t)(p0 + j) * n + q] = v[j];
  }
  for (int p = q; p < P; p += n) differ[p] = 0;
  __syncthreads();
  // a plane on which every row equals row 0 decides no compare
  for (int p = 0; p < P; ++p)
    if (keys[(size_t)p * n + q] != keys[(size_t)p * n]) differ[p] = 1;
  __syncthreads();
  if (q == 0) {
    int m = 0;
    for (int p = 0; p < P; ++p)
      if (differ[p]) off[m++] = p * n;
    n_active = m;
    for (int j = m; j < P || j < PACKED; ++j) off[j] = 0;
  }
  __syncthreads();
  const int na = n_active;
  int4 mine = make_int4(na > 0 ? keys[off[0] + q] : 0,
                        na > 1 ? keys[off[1] + q] : 0,
                        na > 2 ? keys[off[2] + q] : 0, q);
  int4* src = buf;
  int4* dst = buf + n;
  src[q] = mine;
  __syncwarp();
  for (int w = 1; w < n; w <<= 1) {
    const int run0 = q & ~(2 * w - 1);
    const int pb = (q & w) ? run0 : run0 + w;   // the partner run
    int lo = 0, hi = w;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before_packed(src[pb + mid], mine, keys, off, na)) lo = mid + 1;
      else hi = mid;
    }
    dst[run0 + (q & (w - 1)) + lo] = mine;
    // the next pass reads runs of 4w: inside this warp while 4w <= 32
    if (4 * w <= 32) __syncwarp(); else __syncthreads();
    int4* t = src; src = dst; dst = t;
    mine = src[q];
  }
  out[row0 + q] = (int)row0 + mine.w;
}

__device__ __forceinline__ bool before_global(const Planes& k, int b,
                                              int a) {
  for (int p = 0; p < k.P; ++p) {
    const int* pl = plane(k, p);
    int x = __ldg(pl + b), y = __ldg(pl + a);
    if (x != y) return x < y;
  }
  return b < a;
}

__global__ void __launch_bounds__(MERGE_THREADS)
sort_merge(const __grid_constant__ Planes k, int w,
           const int* __restrict__ src, int* __restrict__ dst) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= k.cap) return;
  const int a = src[q];
  const int run0 = q & ~(2 * w - 1);
  const int pb = (q & w) ? run0 : run0 + w;
  int lo = 0, hi = w;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before_global(k, __ldg(src + pb + mid), a)) lo = mid + 1;
    else hi = mid;
  }
  dst[run0 + (q & (w - 1)) + lo] = a;
}

// ptrs: P plane pointers (P <= 64), or null with stacked set (P planes
// of cap int32, plane-major).  chunk (rows and threads of a block) and
// smem come from ops/sort.py sort_geometry; tmp is a cap-long int32 scratch, used when
// chunk < cap.
extern "C" int bitonic_sort_perm(const void* const* ptrs, const void* stacked,
                                 int P, int cap, int chunk, int smem,
                                 void* perm, void* tmp, void* stream) {
  if (P < 1 || (!stacked && P > MAX_PTRS) || chunk < 32 ||
      chunk > MAX_THREADS || cap % chunk)
    return (int)cudaErrorInvalidValue;
  Planes k = {};
  k.P = P;
  k.cap = cap;
  k.stacked = static_cast<const int*>(stacked);
  if (!stacked)
    for (int p = 0; p < P; ++p) k.ptr[p] = static_cast<const int*>(ptrs[p]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      sort_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int passes = 0;
  for (int c = chunk; c < cap; c <<= 1) ++passes;
  // pass i reads bufs[(passes - i) % 2], so the last one writes perm
  int* bufs[2] = {static_cast<int*>(perm), static_cast<int*>(tmp)};
  sort_chunk<<<cap / chunk, chunk, smem, s>>>(k, bufs[passes % 2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int i = 0, w = chunk; w < cap; ++i, w <<= 1) {
    sort_merge<<<(cap + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0,
                 s>>>(k, w, bufs[(passes - i) % 2], bufs[(passes - i - 1) % 2]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
