// Dense-domain segment aggregation: the group-by histogram.
//
// Replaces caps_tpu/ops/segment.py dense_segment_agg (Pallas _agg_kernel).
// out[s] = agg{ values[r] : codes[r] == s, ok[r] }, s in [0, S), with the
// kinds count, sum_f32, sum_i32, min_i32, max_i32, min_f32, max_f32 and
// the identities 0 / INT_MAX / INT_MIN / +inf / -inf for empty slots.
//
// Bound: bytes.  Each row is read once (code + ok + value, 9 bytes) and
// the histogram is tiny (S <= 4096), so the floor is n * 9 B over the
// card's memory rate.  Design: the TPU kernel compares every row with
// every slot of a segment tile (dense VPU work, MXU for sums).  Here each
// block keeps a privatized histogram of all S slots in shared memory
// (S * 4 B <= 16 KB) and streams rows through it with shared-memory
// atomics (integer atomics commute, so the result is deterministic);
// min/max over floats ride integer atomics on an order-preserving int
// image of the float.  Float sums must not depend on atomic timing (the
// engine's determinism check digests results), so sum_f32 instead loads a
// tile of rows into shared memory and lets each thread add up its slots
// over the tile in row order, in double, rounding to float once at the
// end.  Every block writes its partial histogram; a second kernel reduces
// the partials over blocks in block order.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

enum { COUNT = 0, SUM_F32 = 1, SUM_I32 = 2, MIN_I32 = 3, MAX_I32 = 4,
       MIN_F32 = 5, MAX_F32 = 6 };

static constexpr int THREADS = 256;
static constexpr int F32_TILE = 1024;

// Monotone float -> int32 image: a < b as floats iff key(a) < key(b).
__device__ __forceinline__ int f2key(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : (i ^ 0x7FFFFFFF);
}
__device__ __forceinline__ float key2f(int k) {
  return __int_as_float(k >= 0 ? k : (k ^ 0x7FFFFFFF));
}

template <int KIND>
__device__ __forceinline__ int ident() {
  if (KIND == MIN_I32) return INT_MAX;
  if (KIND == MAX_I32) return INT_MIN;
  if (KIND == MIN_F32) return 0x7F800000;                 // key(+inf)
  if (KIND == MAX_F32) return (int)(0xFF800000u ^ 0x7FFFFFFFu);  // key(-inf)
  return 0;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
hist_partials(const int* __restrict__ codes, const uint8_t* __restrict__ ok,
              const void* __restrict__ values, int n, int S,
              int* __restrict__ partials) {
  extern __shared__ int hist[];
  for (int s = threadIdx.x; s < S; s += blockDim.x) hist[s] = ident<KIND>();
  __syncthreads();
  const int* vi = static_cast<const int*>(values);
  const float* vf = static_cast<const float*>(values);
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += gridDim.x * blockDim.x) {
    int c = __ldg(&codes[r]);
    if (!__ldg(&ok[r]) || c < 0 || c >= S) continue;
    if (KIND == COUNT) atomicAdd(&hist[c], 1);
    if (KIND == SUM_I32) atomicAdd(&hist[c], __ldg(&vi[r]));
    if (KIND == MIN_I32) atomicMin(&hist[c], __ldg(&vi[r]));
    if (KIND == MAX_I32) atomicMax(&hist[c], __ldg(&vi[r]));
    if (KIND == MIN_F32) atomicMin(&hist[c], f2key(__ldg(&vf[r])));
    if (KIND == MAX_F32) atomicMax(&hist[c], f2key(__ldg(&vf[r])));
  }
  __syncthreads();
  int* mine = partials + (size_t)blockIdx.x * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) mine[s] = hist[s];
}

__global__ void __launch_bounds__(THREADS)
sum_f32_partials(const int* __restrict__ codes, const uint8_t* __restrict__ ok,
                 const float* __restrict__ values, int n, int S,
                 double* __restrict__ partials) {
  __shared__ int tc[F32_TILE];
  __shared__ float tv[F32_TILE];
  double* mine = partials + (size_t)blockIdx.x * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) mine[s] = 0.0;
  for (int base = blockIdx.x * F32_TILE; base < n;
       base += gridDim.x * F32_TILE) {
    for (int r = threadIdx.x; r < F32_TILE; r += blockDim.x) {
      int g = base + r;
      bool live = g < n && __ldg(&ok[g]);
      tc[r] = live ? __ldg(&codes[g]) : -1;
      tv[r] = live ? __ldg(&values[g]) : 0.f;
    }
    __syncthreads();
    // fixed order: rows ascending within the tile, tiles ascending per
    // block — only this thread ever touches mine[s]
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      double acc = 0.0;
      for (int r = 0; r < F32_TILE; ++r)
        if (tc[r] == s) acc += (double)tv[r];
      mine[s] += acc;
    }
    __syncthreads();
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
reduce_partials(const void* __restrict__ partials, int blocks, int S,
                void* __restrict__ out) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  if (KIND == SUM_F32) {
    const double* p = static_cast<const double*>(partials);
    double acc = 0.0;
    for (int b = 0; b < blocks; ++b) acc += p[(size_t)b * S + s];
    static_cast<float*>(out)[s] = (float)acc;
    return;
  }
  const int* p = static_cast<const int*>(partials);
  int acc = ident<KIND>();
  for (int b = 0; b < blocks; ++b) {
    int v = p[(size_t)b * S + s];
    if (KIND == COUNT || KIND == SUM_I32) acc += v;
    if (KIND == MIN_I32 || KIND == MIN_F32) acc = min(acc, v);
    if (KIND == MAX_I32 || KIND == MAX_F32) acc = max(acc, v);
  }
  if (KIND == MIN_F32 || KIND == MAX_F32)
    static_cast<float*>(out)[s] = key2f(acc);
  else
    static_cast<int*>(out)[s] = acc;
}

template <int KIND>
static int launch(const int* codes, const uint8_t* ok, const void* values,
                  int n, int S, void* partials, int blocks, void* out,
                  cudaStream_t stream) {
  if (KIND == SUM_F32)
    sum_f32_partials<<<blocks, THREADS, 0, stream>>>(
        codes, ok, static_cast<const float*>(values), n, S,
        static_cast<double*>(partials));
  else
    hist_partials<KIND><<<blocks, THREADS, S * sizeof(int), stream>>>(
        codes, ok, values, n, S, static_cast<int*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<KIND><<<(S + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      partials, blocks, S, out);
  return (int)cudaGetLastError();
}

extern "C" {

// Blocks the launch uses for n rows: the wrapper sizes the (blocks, S)
// partials scratch with it (double for sum_f32, int32 otherwise).
int segment_agg_blocks(int n, int kind) {
  int per_block = kind == SUM_F32 ? F32_TILE : THREADS * 8;
  int b = (n + per_block - 1) / per_block;
  return b < 1 ? 1 : (b > 264 ? 264 : b);
}

int segment_agg(const void* codes, const void* ok, const void* values,
                int n, int S, int kind, void* partials, int blocks,
                void* out, void* stream) {
  const int* c = static_cast<const int*>(codes);
  const uint8_t* o = static_cast<const uint8_t*>(ok);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case COUNT:   return launch<COUNT>(c, o, values, n, S, partials, blocks, out, st);
    case SUM_F32: return launch<SUM_F32>(c, o, values, n, S, partials, blocks, out, st);
    case SUM_I32: return launch<SUM_I32>(c, o, values, n, S, partials, blocks, out, st);
    case MIN_I32: return launch<MIN_I32>(c, o, values, n, S, partials, blocks, out, st);
    case MAX_I32: return launch<MAX_I32>(c, o, values, n, S, partials, blocks, out, st);
    case MIN_F32: return launch<MIN_F32>(c, o, values, n, S, partials, blocks, out, st);
    case MAX_F32: return launch<MAX_F32>(c, o, values, n, S, partials, blocks, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
