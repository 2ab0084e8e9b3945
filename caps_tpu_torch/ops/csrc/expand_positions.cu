// Segmented-expand positions: invert offsets = cumsum(counts).
//
// Replaces caps_tpu/ops/expand.py expand_positions (Pallas _expand_kernel).
// For each output slot t < out_cap it gives the left row l it expands
// from, the match position r_pos = lo[l] + t - offsets[l - 1], and
// valid = t < total; invalid slots are 0.  All arithmetic is int32, as
// in the TPU kernel (the wrapper bounds out_cap below 2^31).
//
// Bound: bytes.  The floor is the three outputs (9 B a slot) plus one
// read of offsets and lo.  Design: the TPU kernel avoids gathers by
// comparing a VMEM window of offsets against a whole tile of slots.  A
// GPU gathers cheaply, so here one thread owns one slot and binary-
// searches the upper bound of t in offsets (read through the read-only
// cache; the top levels of the search are shared by every thread and
// stay cached).  Rows with a zero count never win an upper bound, so no
// compaction prelude is needed.  The total is offsets[cap_l - 1], read
// on the device: the launch needs no host round trip.
#include <cuda_runtime.h>
#include <stdint.h>

static constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
expand_positions_kernel(const int* __restrict__ offsets,
                        const int* __restrict__ lo, int cap_l, int out_cap,
                        int* __restrict__ l_idx, int* __restrict__ r_pos,
                        uint8_t* __restrict__ valid) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= out_cap) return;
  int total = cap_l > 0 ? __ldg(&offsets[cap_l - 1]) : 0;
  if (t >= total) {
    l_idx[t] = 0;
    r_pos[t] = 0;
    valid[t] = 0;
    return;
  }
  // first k with offsets[k] > t; exists because offsets[cap_l-1] > t
  int a = 0, b = cap_l - 1;
  while (a < b) {
    int m = (a + b) >> 1;
    if (__ldg(&offsets[m]) > t) b = m; else a = m + 1;
  }
  int seg_start = a > 0 ? __ldg(&offsets[a - 1]) : 0;
  l_idx[t] = a;
  r_pos[t] = __ldg(&lo[a]) + (t - seg_start);
  valid[t] = 1;
}

extern "C" int expand_positions(const void* offsets, const void* lo,
                                int cap_l, int out_cap, void* l_idx,
                                void* r_pos, void* valid, void* stream) {
  int blocks = (out_cap + THREADS - 1) / THREADS;
  expand_positions_kernel<<<blocks, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(lo), cap_l,
      out_cap, static_cast<int*>(l_idx), static_cast<int*>(r_pos),
      static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}
