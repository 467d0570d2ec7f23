// reduce_pairs: sum each Gaussian's per-pair gradient rows into one row.
//
// Replaces latentsplat_tpu/ops/rasterize/expand.py::reduce_by_counts
// (_contract_kernel). The TPU kernel first unsorted the pair gradients with a
// second sort keyed by the carried pair index, then summed each Gaussian's
// pair columns with indicator matmuls over CHUNK-aligned windows. Here the
// gradient rows stay in sorted order: `inverse` maps each Gaussian-major pair
// position (the order duplicate_with_keys wrote) to its sorted position, and
// one thread per (Gaussian, attribute) reads its <= cap rows through it and
// adds them in Gaussian-major order. No atomics, so the result is
// deterministic; dead Gaussians (count 0) get zero rows.
//
// Bound: memory. Per pair it reads one int64 index and 6 + NCH floats of a
// row that lies wherever the sort put it (a gather), and per Gaussian it
// writes one row: ~0.7M pairs x ~64 bytes at the flagship scale, tens of
// microseconds of HBM time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void reduce_pairs_kernel(
    int num_gaussians, int row,
    const float* __restrict__ d_pairs,     // (P, row) in sorted order
    const int64_t* __restrict__ inverse,   // (P,) Gaussian-major position -> sorted position
    const int64_t* __restrict__ offsets,   // (G,) inclusive prefix sum of pair counts
    float* __restrict__ out) {             // (G, row)
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(num_gaussians) * row) return;
  const int64_t g = idx / row;
  const int r = static_cast<int>(idx - g * row);
  const int64_t end = offsets[g];
  const int64_t begin = g == 0 ? 0 : offsets[g - 1];
  float acc = 0.0f;
  for (int64_t p = begin; p < end; ++p) acc += d_pairs[inverse[p] * row + r];
  out[idx] = acc;
}

}  // namespace

extern "C" int reduce_pairs(
    int num_gaussians, int row, const void* d_pairs, const void* inverse,
    const void* offsets, void* out, void* stream) {
  const int64_t total = static_cast<int64_t>(num_gaussians) * row;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    reduce_pairs_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        num_gaussians, row, static_cast<const float*>(d_pairs),
        static_cast<const int64_t*>(inverse), static_cast<const int64_t*>(offsets),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
