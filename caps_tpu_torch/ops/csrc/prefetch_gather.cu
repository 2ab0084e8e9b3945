// Tile gather by a prefetched block index, doubled.
//
// Replaces caps_tpu/ops/probe.py k2 (the "prefetch" family's Pallas
// program: PrefetchScalarGridSpec, out tile i = 2 * x tile blk[i]).
// For every output tile i < n_tiles and j < tile:
//     out[i * tile + j] = 2 * x[blk[i] * tile + j]
// with blk[i] in [0, n_src).  An out-of-range blk[i] sets *err = 1 and
// writes zeros to output tile i; nothing is read out of bounds.
//
// Bound: bytes.  Each output tile reads one source tile and writes itself
// (8 B an element) plus one 4-byte index, so the floor is
// 8 * tile * n_tiles + 4 * n_tiles bytes over the card's memory rate.
// Design: the TPU kernel brings blk ahead of the grid (scalar prefetch)
// so the DMA engine knows each step's source block.  On the GPU a block
// loads its own index: one block per output tile, thread 0 reads blk[i]
// once into shared memory, and the block copies the source tile with
// 16-byte loads and stores when the tile and both pointers allow it
// (neighbouring threads on neighbouring addresses), 4-byte ones otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

static constexpr int THREADS = 64;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
prefetch_gather_kernel(const int* __restrict__ x, const int* __restrict__ blk,
                       int tile, int n_src, int* __restrict__ out,
                       int* __restrict__ err) {
  __shared__ int src;
  const long long i = blockIdx.x;
  if (threadIdx.x == 0) {
    int b = __ldg(&blk[i]);
    if (b < 0 || b >= n_src) {
      *err = 1;  // every writer stores 1: the race is benign
      b = -1;
    }
    src = b;
  }
  __syncthreads();
  const int b = src;
  if (VEC) {
    const int n4 = tile >> 2;
    int4* o = reinterpret_cast<int4*>(out + i * tile);
    if (b < 0) {
      for (int j = threadIdx.x; j < n4; j += blockDim.x)
        o[j] = make_int4(0, 0, 0, 0);
      return;
    }
    const int4* s = reinterpret_cast<const int4*>(x + (long long)b * tile);
    for (int j = threadIdx.x; j < n4; j += blockDim.x) {
      int4 v = __ldg(&s[j]);
      o[j] = make_int4(2 * v.x, 2 * v.y, 2 * v.z, 2 * v.w);
    }
  } else {
    int* o = out + i * tile;
    if (b < 0) {
      for (int j = threadIdx.x; j < tile; j += blockDim.x) o[j] = 0;
      return;
    }
    const int* s = x + (long long)b * tile;
    for (int j = threadIdx.x; j < tile; j += blockDim.x)
      o[j] = 2 * __ldg(&s[j]);
  }
}

extern "C" int prefetch_gather(const void* x, const void* blk, int tile,
                               int n_tiles, int n_src, void* out, void* err,
                               void* stream) {
  if (n_tiles == 0 || tile == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (tile % 4 == 0)
      && (reinterpret_cast<uintptr_t>(x) % 16 == 0)
      && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int* xi = static_cast<const int*>(x);
  const int* bi = static_cast<const int*>(blk);
  int* oi = static_cast<int*>(out);
  int* ei = static_cast<int*>(err);
  if (vec)
    prefetch_gather_kernel<true><<<n_tiles, THREADS, 0, st>>>(
        xi, bi, tile, n_src, oi, ei);
  else
    prefetch_gather_kernel<false><<<n_tiles, THREADS, 0, st>>>(
        xi, bi, tile, n_src, oi, ei);
  return (int)cudaGetLastError();
}
