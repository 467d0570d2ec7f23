// duplicate_with_keys: one (Gaussian id, sort key) pair per tile a Gaussian
// survives in.
//
// Replaces latentsplat_tpu/ops/rasterize/expand.py::expand_by_counts
// (_expand_kernel). The TPU kernel copied every attribute row of Gaussian i
// into pair columns [start_i, start_i + count_i) with indicator matmuls,
// because gathers serialize on the TPU. Here the pair buffer holds only the
// Gaussian id and an int64 key (tile << 32 | float bits of depth); the
// compositor reads attributes through the id, so nothing but 12 bytes per
// pair is written and sorted.
//
// Bound: memory. Per Gaussian it reads 20 bytes (offset, mask, base, nx,
// depth) and writes 12 bytes per pair; at the flagship scale (393k
// Gaussians, ~0.7M pairs) that is under 20 MB, i.e. a few microseconds of
// HBM time. One thread per Gaussian walks the <= cap set bits of its
// surviving-slot mask, so there are no atomics: the exclusive offsets come
// from a cumsum outside the kernel, as in the JAX package.
//
// Depth of a live Gaussian is > 0, so its float bits order like the value.
// The caller sorts keys stably; pairs are written Gaussian-major, so equal
// depths break ties by Gaussian index, like the JAX package's stable ranks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void duplicate_with_keys_kernel(
    int num_gaussians,
    const int64_t* __restrict__ offsets,  // inclusive prefix sum of pair counts
    const int32_t* __restrict__ mask,     // surviving rect slots, bit s = slot s
    const int32_t* __restrict__ base,     // tile id of the rect's top-left slot
    const int32_t* __restrict__ nx,       // rect width in tiles
    const float* __restrict__ depth,
    int tiles_x,
    int32_t* __restrict__ gids,
    int64_t* __restrict__ keys) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= num_gaussians) return;
  uint32_t bits = static_cast<uint32_t>(mask[g]);
  if (bits == 0u) return;
  int64_t out = offsets[g] - __popc(bits);
  const int b = base[g];
  const int w = nx[g];
  const int64_t depth_bits = static_cast<int64_t>(__float_as_uint(depth[g]));
  while (bits != 0u) {
    const int slot = __ffs(bits) - 1;
    bits &= bits - 1u;
    const int row = slot / w;
    const int col = slot - row * w;
    const int64_t tile = b + row * tiles_x + col;
    gids[out] = g;
    keys[out] = (tile << 32) | depth_bits;
    ++out;
  }
}

}  // namespace

extern "C" int duplicate_with_keys(
    int num_gaussians, const void* offsets, const void* mask, const void* base,
    const void* nx, const void* depth, int tiles_x, void* gids, void* keys,
    void* stream) {
  if (num_gaussians > 0) {
    const int threads = 256;
    const int blocks = (num_gaussians + threads - 1) / threads;
    duplicate_with_keys_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        num_gaussians, static_cast<const int64_t*>(offsets),
        static_cast<const int32_t*>(mask), static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(nx), static_cast<const float*>(depth), tiles_x,
        static_cast<int32_t*>(gids), static_cast<int64_t*>(keys));
  }
  return static_cast<int>(cudaGetLastError());
}
