// composite_forward: front-to-back alpha compositing of each 16x16 tile's
// depth-sorted pair segment.
//
// Replaces latentsplat_tpu/ops/rasterize/pallas_kernels.py::composite_pairs_fwd
// (_fwd_kernel). The TPU kernel composited 512-pair chunks with log-space
// prefix-sum matmuls on the MXU and stopped a whole tile only after a chunk
// in which every pixel saturated. Here one block owns one tile and one
// thread owns one pixel: each thread walks the tile's pairs in order,
// multiplying its transmittance and accumulating channels, and stops on its
// own as soon as T < 1e-4 (after adding that pair's contribution). The block
// leaves once all 256 pixels are done.
//
// Bound: per (pair, pixel) work is ~20 flops plus one expf; per pair the
// block reads the pair's Gaussian id and 6 + NCH floats of attributes,
// gathered through the id into shared memory in batches of 256 pairs (one
// pair per thread), so every attribute is fetched once per tile and then
// broadcast from shared memory to the 256 pixels. The ~0.7M pairs of a
// flagship view make the kernel compute- and latency-bound, not bandwidth-
// bound.
//
// Arithmetic is rounded operation by operation (no FMA contraction) in the
// same order as the plain PyTorch version, composite_forward_reference, so
// the two agree to float rounding of the accumulation and make the same
// alpha-threshold and early-stop decisions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kBatch = 256;
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaThreshold = static_cast<float>(1.0 / 255.0);
constexpr float kTransmittanceMin = 1e-4f;

template <int NCH>
__global__ void __launch_bounds__(kPixels) composite_forward_kernel(
    const int32_t* __restrict__ gids,         // (P,) depth-sorted within each tile
    const int32_t* __restrict__ tile_ranges,  // (T + 1,) pair range of each tile
    const float* __restrict__ attrs,          // (G, 6 + NCH): x, y, a, b, c, opacity, channels
    int tiles_x, int height, int width,
    float* __restrict__ out_channels,         // (NCH, H, W)
    float* __restrict__ out_transmittance,    // (H, W)
    int32_t* __restrict__ out_last) {         // (H, W) exclusive end of contributing pairs
  constexpr int kStride = 6 + NCH;
  __shared__ float s_attr[kStride][kBatch];

  const int tile = blockIdx.x;
  const int px = (tile % tiles_x) * kTile + static_cast<int>(threadIdx.x) % kTile;
  const int py = (tile / tiles_x) * kTile + static_cast<int>(threadIdx.x) / kTile;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = tile_ranges[tile];
  const int end = tile_ranges[tile + 1];

  float t = 1.0f;
  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  int last = start;
  bool done = false;

  for (int batch = start; batch < end; batch += kBatch) {
    if (__syncthreads_count(done) == kPixels) break;
    const int idx = batch + static_cast<int>(threadIdx.x);
    if (idx < end) {
      const float* a = attrs + static_cast<int64_t>(gids[idx]) * kStride;
#pragma unroll
      for (int r = 0; r < kStride; ++r) s_attr[r][threadIdx.x] = a[r];
    }
    __syncthreads();
    const int n = min(kBatch, end - batch);
    for (int j = 0; j < n && !done; ++j) {
      const float dx = __fsub_rn(fx, s_attr[0][j]);
      const float dy = __fsub_rn(fy, s_attr[1][j]);
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s_attr[2][j], dx), dx),
                                   __fmul_rn(__fmul_rn(s_attr[4][j], dy), dy));
      const float power =
          __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(s_attr[3][j], dx), dy));
      if (power > 0.0f) continue;
      const float alpha = fminf(kAlphaClamp, __fmul_rn(s_attr[5][j], expf(power)));
      if (alpha < kAlphaThreshold) continue;
      const float weight = __fmul_rn(alpha, t);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        acc[c] = __fadd_rn(acc[c], __fmul_rn(s_attr[6 + c][j], weight));
      }
      t = __fmul_rn(t, __fsub_rn(1.0f, alpha));
      last = batch + j + 1;
      if (t < kTransmittanceMin) done = true;
    }
    __syncthreads();
  }

  const int pixel = py * width + px;
  const int64_t plane = static_cast<int64_t>(height) * width;
#pragma unroll
  for (int c = 0; c < NCH; ++c) out_channels[c * plane + pixel] = acc[c];
  out_transmittance[pixel] = t;
  out_last[pixel] = last;
}

template <int NCH>
void launch(int num_tiles, const void* gids, const void* tile_ranges, const void* attrs,
            int tiles_x, int height, int width, void* channels, void* transmittance,
            void* last, cudaStream_t stream) {
  composite_forward_kernel<NCH><<<num_tiles, kPixels, 0, stream>>>(
      static_cast<const int32_t*>(gids), static_cast<const int32_t*>(tile_ranges),
      static_cast<const float*>(attrs), tiles_x, height, width,
      static_cast<float*>(channels), static_cast<float*>(transmittance),
      static_cast<int32_t*>(last));
}

}  // namespace

// Channel counts the kernel is instantiated for (payload + expected depth):
// 8 = 3 color + 4 latent features + depth (the flagship), 5 = 4 + depth.
extern "C" int composite_forward_channels(int index) {
  constexpr int kChannels[] = {5, 8};
  return index < static_cast<int>(sizeof(kChannels) / sizeof(int)) ? kChannels[index] : -1;
}

extern "C" int composite_forward(
    int n_channels, int num_tiles, const void* gids, const void* tile_ranges,
    const void* attrs, int tiles_x, int height, int width, void* channels,
    void* transmittance, void* last, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    switch (n_channels) {
      case 5:
        launch<5>(num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, channels,
                  transmittance, last, s);
        break;
      case 8:
        launch<8>(num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, channels,
                  transmittance, last, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
