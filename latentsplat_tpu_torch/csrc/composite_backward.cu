// composite_backward: per-pair gradients of the tile compositor, replaying
// each tile's depth-sorted pairs back to front.
//
// Replaces latentsplat_tpu/ops/rasterize/pallas_kernels.py::composite_pairs_bwd
// (_bwd_kernel). The TPU kernel replayed whole 512-pair chunks with
// triangular-matmul prefix and suffix scans in log space, and accumulated
// per-pair gradients by read-modify-writes of overlapping chunk windows,
// which the sequential TPU grid made race-free. Here one block owns one
// tile and one thread owns one pixel, as in composite_forward. The block
// walks its tile's pairs from the largest per-pixel `last` down to the tile
// start, staging batches of 64 pairs' attributes in shared memory. A pixel
// takes part only for pairs below its own `last`, which are exactly the
// pairs its forward composited (the forward stops each pixel on its own).
//
// Per (pair, pixel) it recomputes alpha with the forward's rules and
// rounding (0.99 clamp, drop when power > 0 or alpha < 1/255, expf),
// recovers the transmittance before the pair as T / (1 - alpha) (finite
// because alpha <= 0.99), and carries the suffix
// S = g_T * T_final + sum of later pairs' alpha * T * (c . g):
//   d_alpha   = (c . g) * T - S / (1 - alpha), zero where alpha was clamped
//   d_opacity = d_alpha * exp(power),  d_power = d_alpha * alpha
//   -> conic a/b/c and mean x/y;  d_channel = alpha * T * g.
// Each pair's 6 + NCH partials are summed over the tile: a warp shuffle
// reduction, then the 8 warps' sums, written to shared memory per warp and
// added in warp order at the end of the batch. No atomics, so the result
// is deterministic; a pair belongs to one tile, so blocks never share a row.
//
// Bound: per (pair, pixel) ~40 flops, one expf and one division, plus a
// warp reduction of 6 + NCH values for every pair that any lane of the
// warp uses (skipped when none does); per pair the block reads 6 + NCH
// floats once and writes one row of d_pairs. Compute- and latency-bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kBatch = 64;
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaThreshold = static_cast<float>(1.0 / 255.0);

template <int NCH>
__global__ void __launch_bounds__(kPixels) composite_backward_kernel(
    const int32_t* __restrict__ gids,         // (P,) depth-sorted within each tile
    const int32_t* __restrict__ tile_ranges,  // (T + 1,)
    const float* __restrict__ attrs,          // (G, 6 + NCH)
    int tiles_x, int height, int width,
    const int32_t* __restrict__ last,         // (H, W) exclusive end of contributing pairs
    const float* __restrict__ t_final,        // (H, W)
    const float* __restrict__ g_channels,     // (NCH, H, W) cotangent of the channels
    const float* __restrict__ g_t,            // (H, W) cotangent of T_final
    float* __restrict__ d_pairs) {            // (P, 6 + NCH), zero-filled by the caller
  constexpr int kStride = 6 + NCH;
  __shared__ float s_attr[kStride][kBatch];
  __shared__ float s_part[kWarps][kBatch][kStride];
  __shared__ int s_end;

  const int tile = blockIdx.x;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int px = (tile % tiles_x) * kTile + static_cast<int>(threadIdx.x) % kTile;
  const int py = (tile / tiles_x) * kTile + static_cast<int>(threadIdx.x) / kTile;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int pixel = py * width + px;
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int start = tile_ranges[tile];

  const int my_last = last[pixel];
  float t = t_final[pixel];
  float g[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) g[c] = g_channels[c * plane + pixel];
  float suffix = __fmul_rn(g_t[pixel], t);

  if (threadIdx.x == 0) s_end = start;
  __syncthreads();
  atomicMax(&s_end, my_last);
  __syncthreads();
  const int end = s_end;

  for (int hi = end; hi > start; hi -= kBatch) {
    const int lo = max(start, hi - kBatch);
    const int n = hi - lo;
    if (static_cast<int>(threadIdx.x) < n) {
      const float* a = attrs + static_cast<int64_t>(gids[lo + threadIdx.x]) * kStride;
#pragma unroll
      for (int r = 0; r < kStride; ++r) s_attr[r][threadIdx.x] = a[r];
    }
    __syncthreads();
    for (int k = n - 1; k >= 0; --k) {
      float part[kStride];
#pragma unroll
      for (int r = 0; r < kStride; ++r) part[r] = 0.0f;
      bool used = false;
      if (lo + k < my_last) {
        const float ca = s_attr[2][k], cb = s_attr[3][k], cc = s_attr[4][k];
        const float dx = __fsub_rn(fx, s_attr[0][k]);
        const float dy = __fsub_rn(fy, s_attr[1][k]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                     __fmul_rn(__fmul_rn(cc, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
        if (power <= 0.0f) {
          const float e = expf(power);
          const float raw = __fmul_rn(s_attr[5][k], e);
          const float alpha = fminf(kAlphaClamp, raw);
          if (alpha >= kAlphaThreshold) {
            used = true;
            const float one_minus = __fsub_rn(1.0f, alpha);
            const float t_before = __fdiv_rn(t, one_minus);
            const float w = __fmul_rn(alpha, t_before);
            float cg = 0.0f;
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              cg = __fadd_rn(cg, __fmul_rn(s_attr[6 + c][k], g[c]));
              part[6 + c] = __fmul_rn(w, g[c]);
            }
            if (raw < kAlphaClamp) {
              const float d_alpha =
                  __fsub_rn(__fmul_rn(cg, t_before), __fdiv_rn(suffix, one_minus));
              const float d_pow = __fmul_rn(d_alpha, alpha);
              part[0] = __fmul_rn(__fadd_rn(__fmul_rn(ca, dx), __fmul_rn(cb, dy)), d_pow);
              part[1] = __fmul_rn(__fadd_rn(__fmul_rn(cc, dy), __fmul_rn(cb, dx)), d_pow);
              part[2] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dx), dx), d_pow);
              part[3] = __fmul_rn(__fmul_rn(-dx, dy), d_pow);
              part[4] = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dy), dy), d_pow);
              part[5] = __fmul_rn(d_alpha, e);
            }
            suffix = __fadd_rn(suffix, __fmul_rn(w, cg));
            t = t_before;
          }
        }
      }
      if (__any_sync(0xffffffffu, used)) {
#pragma unroll
        for (int r = 0; r < kStride; ++r) {
          float v = part[r];
#pragma unroll
          for (int offset = 16; offset > 0; offset >>= 1) {
            v += __shfl_down_sync(0xffffffffu, v, offset);
          }
          if (lane == 0) s_part[warp][k][r] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kStride; ++r) s_part[warp][k][r] = 0.0f;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * kStride; idx += kPixels) {
      const int k = idx / kStride;
      const int r = idx - k * kStride;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_part[w][k][r];
      d_pairs[static_cast<int64_t>(lo + k) * kStride + r] = sum;
    }
    __syncthreads();
  }
}

template <int NCH>
void launch(int num_tiles, const void* gids, const void* tile_ranges, const void* attrs,
            int tiles_x, int height, int width, const void* last, const void* t_final,
            const void* g_channels, const void* g_t, void* d_pairs, cudaStream_t stream) {
  composite_backward_kernel<NCH><<<num_tiles, kPixels, 0, stream>>>(
      static_cast<const int32_t*>(gids), static_cast<const int32_t*>(tile_ranges),
      static_cast<const float*>(attrs), tiles_x, height, width,
      static_cast<const int32_t*>(last), static_cast<const float*>(t_final),
      static_cast<const float*>(g_channels), static_cast<const float*>(g_t),
      static_cast<float*>(d_pairs));
}

}  // namespace

// Instantiated for the channel counts of composite_forward (5 and 8).
extern "C" int composite_backward(
    int n_channels, int num_tiles, const void* gids, const void* tile_ranges,
    const void* attrs, int tiles_x, int height, int width, const void* last,
    const void* t_final, const void* g_channels, const void* g_t, void* d_pairs,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles > 0) {
    switch (n_channels) {
      case 5:
        launch<5>(num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, last, t_final,
                  g_channels, g_t, d_pairs, s);
        break;
      case 8:
        launch<8>(num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, last, t_final,
                  g_channels, g_t, d_pairs, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
