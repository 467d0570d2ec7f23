// reduce_pairs: sum each Gaussian's per-pair gradient rows into one row.
//
// Replaces latentsplat_tpu/ops/rasterize/expand.py::reduce_by_counts
// (_contract_kernel). The TPU kernel summed each Gaussian's pair columns of
// the expanded, Gaussian-major layout with indicator matmuls over
// CHUNK-aligned windows. Here the rows arrive in that same Gaussian-major
// layout (composite_backward writes each pair's row where
// duplicate_with_keys put the pair), so each Gaussian's rows are one
// contiguous segment and the kernel is a streaming segmented sum:
// R / V threads per Gaussian, each owning V adjacent floats of the row
// (V = 2 where the row length is even), consecutive Gaussians in
// consecutive thread groups. A thread reads its Gaussian's two offsets and
// then walks the segment, adding one V-float load per row in slot order,
// so neighbouring threads read neighbouring addresses and every row is
// read once. Dead Gaussians (count 0) get zero rows. No atomics: the
// result is deterministic, and it equals a sequential sum of the rows in
// slot order bit for bit.
//
// Bound: memory. Per pair one row of R floats is read, per Gaussian two
// int64 offsets are read and one row written: ~53 MB at the flagship
// view (506k pairs, 393k Gaussians, R = 14), ~16 us at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static void add(T& a, const T& b) { a += b; }
  __device__ static T zero() { return 0.0f; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
  }
  __device__ static T zero() { return make_float2(0.0f, 0.0f); }
};

template <int R>
__global__ void reduce_pairs_kernel(
    int num_gaussians,
    const float* __restrict__ d_rows,      // (P, R) Gaussian-major
    const int64_t* __restrict__ offsets,   // (G,) inclusive prefix sum of pair counts
    float* __restrict__ out) {             // (G, R)
  constexpr int kV = R % 2 == 0 ? 2 : 1;
  constexpr int kLanes = R / kV;           // threads per Gaussian
  using V = Vec<kV>;
  using T = typename V::T;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(num_gaussians) * kLanes) return;
  const int64_t g = idx / kLanes;
  const int lane = static_cast<int>(idx - g * kLanes);
  const int64_t end = offsets[g];
  const int64_t begin = g == 0 ? 0 : offsets[g - 1];
  const T* src = reinterpret_cast<const T*>(d_rows) + begin * kLanes + lane;
  T acc = V::zero();
#pragma unroll 4
  for (int64_t p = begin; p < end; ++p, src += kLanes) V::add(acc, *src);
  reinterpret_cast<T*>(out)[idx] = acc;
}

template <int R>
void launch(int num_gaussians, const void* d_rows, const void* offsets, void* out,
            cudaStream_t stream) {
  constexpr int kLanes = R % 2 == 0 ? R / 2 : R;
  const int64_t total = static_cast<int64_t>(num_gaussians) * kLanes;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  reduce_pairs_kernel<R><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      num_gaussians, static_cast<const float*>(d_rows), static_cast<const int64_t*>(offsets),
      static_cast<float*>(out));
}

}  // namespace

// Instantiated for the row lengths of composite_backward (6 + 4, 6 + 5, 6 + 8
// and 6 + 12).
extern "C" int reduce_pairs(int num_gaussians, int row, const void* d_rows, const void* offsets,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_gaussians > 0) {
    switch (row) {
      case 10:
        launch<10>(num_gaussians, d_rows, offsets, out, s);
        break;
      case 11:
        launch<11>(num_gaussians, d_rows, offsets, out, s);
        break;
      case 14:
        launch<14>(num_gaussians, d_rows, offsets, out, s);
        break;
      case 18:
        launch<18>(num_gaussians, d_rows, offsets, out, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
