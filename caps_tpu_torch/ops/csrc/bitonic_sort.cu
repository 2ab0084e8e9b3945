// Stable multi-plane sort permutation: a bitonic network in one block.
//
// Replaces caps_tpu/ops/sort.py bitonic_sort_perm (Pallas _stage_kernel).
// Keys arrive as P int32 planes (split_planes), plane-major, each of
// length cap (a power of two, 256..16384).  The comparator is strict:
// planes lexicographically, then the original row index — so the
// network's result is THE stable ascending permutation, bit-identical
// to a stable sort.
//
// Bound: operations, in practice latency.  The data is small (P * cap *
// 4 B in, cap * 4 B out), but the network has log2(cap) * (log2(cap)+1)/2
// dependent stages.  Design: the TPU kernel keeps every plane as a
// (R, 128) tile in VMEM and permutes sublanes/lanes.  Here P planes of up
// to 64 KB each do not all fit in shared memory, so one block of 1024
// threads keeps only the index permutation in shared memory (cap * 4 B
// <= 64 KB, dynamic) and compares rows by reading their planes through
// the read-only cache; a __syncthreads separates stages.  One block uses
// one SM: a faster multi-block merge is later work.
#include <cuda_runtime.h>
#include <stdint.h>

static constexpr int THREADS = 1024;

__device__ __forceinline__ bool row_greater(const int* __restrict__ planes,
                                            int P, int cap, int a, int b) {
  for (int p = 0; p < P; ++p) {
    int x = __ldg(&planes[(size_t)p * cap + a]);
    int y = __ldg(&planes[(size_t)p * cap + b]);
    if (x != y) return x > y;
  }
  return a > b;
}

__global__ void __launch_bounds__(THREADS)
bitonic_sort_kernel(const int* __restrict__ planes, int P, int cap,
                    int* __restrict__ perm) {
  extern __shared__ int idx[];
  for (int i = threadIdx.x; i < cap; i += blockDim.x) idx[i] = i;
  __syncthreads();
  const int half = cap >> 1;
  for (int k = 2; k <= cap; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int w = threadIdx.x; w < half; w += blockDim.x) {
        // w-th compare-exchange pair (i, i | j) with bit j of i clear
        int i = ((w & ~(j - 1)) << 1) | (w & (j - 1));
        int l = i | j;
        int a = idx[i], b = idx[l];
        bool ascending = (i & k) == 0;
        if (row_greater(planes, P, cap, a, b) == ascending) {
          idx[i] = b;
          idx[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < cap; i += blockDim.x) perm[i] = idx[i];
}

extern "C" int bitonic_sort_perm(const void* planes, int P, int cap,
                                 void* perm, void* stream) {
  size_t smem = (size_t)cap * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bitonic_sort_kernel<<<1, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(planes), P, cap, static_cast<int*>(perm));
  return (int)cudaGetLastError();
}
