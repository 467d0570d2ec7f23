// tile_cull: each (item, Gaussian) row's tile rect, exact ellipse-tile cull
// and surviving-slot mask of a render pass, in one launch.
//
// Replaces no TPU kernel: the JAX package computes this bookkeeping in jnp
// (latentsplat_tpu/ops/rasterize/tiled.py::_tile_rects), which XLA fuses
// into a few loops. The port's plain version
// (ops/rasterize/tiled.py::tile_rects_reference) is that code in PyTorch:
// ~40 unfused elementwise operations for each of the cap rect slots, each a
// launch that writes and re-reads an (N G,) float32 temporary (~370
// launches a 9-slot pass; 41.6 ms of a 30-view, 393,216-Gaussian pass on
// an H100). This kernel is that function with every intermediate in
// registers: one thread per row.
//
// Bound: memory. A row reads 9 floats (mean2d 2, extent 2, conic 3,
// opacity, radius) and writes counts, base, nx and the mask: 52 bytes
// (56 with an int64 mask); 613 MB for the 30-view pass, ~0.18 ms at
// 3.35 TB/s. mean2d and extent are read as float2, the rest as floats;
// neighbouring threads read neighbouring rows, so every load is coalesced.
// No shared memory and no atomics.
//
// The mask decides which pairs exist, and so the sort and every pixel, so
// the kernel gives the plain version's bits, not values within a
// tolerance. It evaluates PyTorch's float32 operations in their order, each
// rounded once: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn keep nvcc
// from contracting a multiply and an add into an FMA. Where PyTorch's
// order is not the formula's, the kernel follows PyTorch: `(s + 0.5) /
// nx_f` is a Python scalar over a tensor, which torch computes as
// reciprocal(nx_f) * (s + 0.5), and `v / TILE` is v * (1 / 16). The
// threshold uses logf, as torch's CUDA log does. min and max return NaN
// when either operand is NaN, and clamp a NaN input, as torch.minimum,
// torch.maximum and torch.clamp do (fminf would drop it). Float to int32 is
// a static_cast, as torch's conversion on the card (NaN gives 0).
//
// Two shortcuts leave the outputs as they are: a slot at or past the
// rect's slot count (min(nx ny, cap)) has bit 0 whatever its quadratic
// form, so the slot loop stops there (most rects hold 1-4 slots); and a
// dead row (radius <= 0 or NaN) gets counts 0, base N T, nx 1 and mask 0
// whatever its rect, so it skips the loop.
//
// One launch serves a pass, the N (scene, view) items of a render call:
// row n G + g is item n's Gaussian g, and `base` is the pass tile id
// n T + ty0 tiles_x + tx0 (T = tiles_x tiles_y), or N T for a dead row.
// The mask is 32 bits wide up to 32 slots and 64 above (a template
// argument); the cap, the margin and the sizes are runtime arguments.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp(v, min=lo): a NaN input stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

// _rects' tile_index: clamp(floor(v / TILE), 0, n - 1) as int32.
__device__ __forceinline__ int tile_index(float v, int n) {
  const float t = floorf(__fmul_rn(v, 0.0625f));
  return static_cast<int>(t != t ? t : fminf(fmaxf(t, 0.0f), static_cast<float>(n - 1)));
}

struct Conic {
  float half_a, b, half_c, neg_b, a_s, c_s;
};

// q_at_x: the least q(a, dy) over dy in [dy0, dy1].
__device__ __forceinline__ float q_at_x(const Conic& k, float a, float dy0, float dy1) {
  const float yc = nan_min(nan_max(__fdiv_rn(__fmul_rn(k.neg_b, a), k.c_s), dy0), dy1);
  const float t1 = __fmul_rn(__fmul_rn(k.half_a, a), a);
  const float t2 = __fmul_rn(__fmul_rn(k.b, a), yc);
  const float t3 = __fmul_rn(__fmul_rn(k.half_c, yc), yc);
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

// q_at_y: the least q(dx, b) over dx in [dx0, dx1].
__device__ __forceinline__ float q_at_y(const Conic& k, float b, float dx0, float dx1) {
  const float xc = nan_min(nan_max(__fdiv_rn(__fmul_rn(k.neg_b, b), k.a_s), dx0), dx1);
  const float t1 = __fmul_rn(__fmul_rn(k.half_a, xc), xc);
  const float t2 = __fmul_rn(__fmul_rn(k.b, xc), b);
  const float t3 = __fmul_rn(__fmul_rn(k.half_c, b), b);
  return __fadd_rn(__fadd_rn(t1, t2), t3);
}

// Mask: uint32_t (caps up to 32 slots) or uint64_t (up to 64).
template <typename Mask>
__global__ void __launch_bounds__(kThreads) tile_cull_kernel(
    int rows, int gaussians, int tiles_x, int tiles_y, int cap, float margin,
    const float2* __restrict__ mean2d,   // (N G,) pixel coordinates
    const float2* __restrict__ extent,   // (N G,) threshold-aware half-extents
    const float* __restrict__ conic,     // (N G, 3) a, b, c
    const float* __restrict__ opacity,   // (N G,)
    const float* __restrict__ radius,    // (N G,) 0 if culled
    int32_t* __restrict__ counts, int32_t* __restrict__ base, int32_t* __restrict__ nx_out,
    Mask* __restrict__ mask_out) {
  const int i = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (i >= rows) return;
  const int num_tiles = tiles_x * tiles_y;
  const int dead_base = rows / gaussians * num_tiles;
  const float r = radius[i];
  if (!(r > 0.0f)) {
    counts[i] = 0;
    base[i] = dead_base;
    nx_out[i] = 1;
    mask_out[i] = Mask(0);
    return;
  }
  const float2 m = mean2d[i];
  const float2 e = extent[i];
  const int tx0 = tile_index(__fsub_rn(m.x, e.x), tiles_x);
  const int tx1 = tile_index(__fadd_rn(m.x, e.x), tiles_x);
  const int ty0 = tile_index(__fsub_rn(m.y, e.y), tiles_y);
  const int ty1 = tile_index(__fadd_rn(m.y, e.y), tiles_y);
  const int nx = tx1 - tx0 + 1;
  const int ny = ty1 - ty0 + 1;
  const int rect_counts = min(nx * ny, cap);

  const float ca = conic[3 * i], cb = conic[3 * i + 1], cc = conic[3 * i + 2];
  const Conic k{__fmul_rn(0.5f, ca), cb, __fmul_rn(0.5f, cc), -cb, clamp_min(ca, 1e-12f), clamp_min(cc, 1e-12f)};
  const float thresh = __fadd_rn(logf(__fmul_rn(255.0f, clamp_min(opacity[i], 1e-12f))), margin);
  const float tx0_f = static_cast<float>(tx0), ty0_f = static_cast<float>(ty0), nx_f = static_cast<float>(nx);
  const float inv_nx = __fdiv_rn(1.0f, nx_f);
  Mask mask = 0;
  int surv = 0;
  for (int s = 0; s < rect_counts; ++s) {
    const float s_f = static_cast<float>(s);
    const float row_f = floorf(__fmul_rn(inv_nx, __fadd_rn(s_f, 0.5f)));
    const float col_f = __fsub_rn(s_f, __fmul_rn(row_f, nx_f));
    const float dx0 = __fsub_rn(__fmul_rn(__fadd_rn(tx0_f, col_f), 16.0f), m.x);
    const float dx1 = __fadd_rn(dx0, 15.0f);
    const float dy0 = __fsub_rn(__fmul_rn(__fadd_rn(ty0_f, row_f), 16.0f), m.y);
    const float dy1 = __fadd_rn(dy0, 15.0f);
    const bool inside = dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f;
    const float q_min = inside ? 0.0f
                               : nan_min(nan_min(q_at_x(k, dx0, dy0, dy1), q_at_x(k, dx1, dy0, dy1)),
                                         nan_min(q_at_y(k, dy0, dx0, dx1), q_at_y(k, dy1, dx0, dx1)));
    if (q_min <= thresh) {
      mask |= Mask(1) << s;
      ++surv;
    }
  }
  const bool live = surv > 0;
  counts[i] = surv;
  base[i] = live ? i / gaussians * num_tiles + ty0 * tiles_x + tx0 : dead_base;
  nx_out[i] = live ? nx : 1;
  mask_out[i] = mask;
}

template <typename Mask>
int launch(int rows, int gaussians, int tiles_x, int tiles_y, int cap, float margin, const void* mean2d,
           const void* extent, const void* conic, const void* opacity, const void* radius, void* counts,
           void* base, void* nx, void* mask, void* stream) {
  if (rows > 0) {
    tile_cull_kernel<Mask><<<(rows + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, gaussians, tiles_x, tiles_y, cap, margin, static_cast<const float2*>(mean2d),
        static_cast<const float2*>(extent), static_cast<const float*>(conic), static_cast<const float*>(opacity),
        static_cast<const float*>(radius), static_cast<int32_t*>(counts), static_cast<int32_t*>(base),
        static_cast<int32_t*>(nx), static_cast<Mask*>(mask));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows = N G (items N of `gaussians` rows each); mean2d and extent 8-byte
// aligned; the mask int32 for caps up to 32, int64 above (up to 64).
extern "C" int tile_cull(int rows, int gaussians, int tiles_x, int tiles_y, int cap, float margin,
                         const void* mean2d, const void* extent, const void* conic, const void* opacity,
                         const void* radius, void* counts, void* base, void* nx, void* mask, void* stream) {
  return cap <= 32 ? launch<uint32_t>(rows, gaussians, tiles_x, tiles_y, cap, margin, mean2d, extent, conic,
                                      opacity, radius, counts, base, nx, mask, stream)
                   : launch<uint64_t>(rows, gaussians, tiles_x, tiles_y, cap, margin, mean2d, extent, conic,
                                      opacity, radius, counts, base, nx, mask, stream);
}
