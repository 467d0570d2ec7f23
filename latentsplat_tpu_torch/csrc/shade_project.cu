// shade_project: the shade of a render pass in one launch. Each (item,
// Gaussian) row gets its composited payload (the SH color, +0.5 and clamped
// at 0, and the SH feature, +0.5, towards the item's camera) and its EWA
// projection (the scene pre-normalized by 1/near when scale-invariant):
// the ScreenGaussians fields that tile_cull, duplicate_with_keys and
// composite_forward read.
//
// Replaces no TPU kernel: the JAX package evaluates the SH terms and the
// projection in jnp (latentsplat_tpu/ops/sh.py::eval_sh,
// latentsplat_tpu/ops/rasterize/camera.py), which XLA fuses. The port's plain
// version (ops/rasterize/shade.py::shade_reference: api.view_channels,
// ops/sh.py::eval_sh and camera.project_gaussians_to_screen) is that code in
// PyTorch: ~100 unfused elementwise launches over the pass's (N G) rows, one
// a SH term, each writing and re-reading (N G, C) float32 temporaries, after
// N gathered copies of the scene's rows (27.7 ms of a 30-view,
// 393,216-Gaussian pass on an H100). This kernel is that function with every
// intermediate in registers.
//
// Bound: memory. A Gaussian's rows are read once: its geometry (13 floats)
// and its SH tables (3 x 25 + 4 x 9 floats at the flagship's degrees); each
// (item, Gaussian) row writes mean2d 2, conic 3, depth, radius, opacity,
// the C payload channels and extent 2 floats. For the 30-view pass that is
// ~1.0 GB, ~0.30 ms at 3.35 TB/s; the arithmetic, ~500 float32 operations a
// row, takes about half that.
//
// Design. A block owns 64 Gaussians of one scene and every item of that
// scene in the pass (item n of the pass is global item start + n, of scene
// (start + n) / views). It first copies its Gaussians' SH tables into
// shared memory, coalesced, coefficient-major with a row stride of 65 so
// that neither the copy nor the reads conflict on banks. Then, 32 items at a
// time, its first threads compute each item's camera (the 1/near scale,
// the world-to-camera transform, focal lengths, guard band) into shared
// memory, and each thread walks the items of its Gaussian (1, 2 or 4
// threads a Gaussian, by the scene's item count, each taking every per-th
// item): the view direction, the 25 basis values, each channel's sum (four
// channels' sums in flight at once) and the projection in registers, then
// the row written. So each SH coefficient leaves device memory once a pass
// and is read from shared memory once an item; no gathered copy of the
// scene is made. Neighbouring threads hold neighbouring Gaussians: every
// global load and store of a warp is one contiguous stretch, and a warp
// reads its item's camera as one broadcast.
//
// The outputs decide which pairs exist, their order and every pixel, so the
// kernel gives the plain version's bits, not values within a tolerance. It
// evaluates PyTorch's float32 operations in their order, each rounded once:
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn keep nvcc from
// contracting a multiply and an add into an FMA, and divide and take roots
// as IEEE does (as torch's kernels do). Where PyTorch's order is not the
// formula's, the kernel follows PyTorch: `1.0 / t` and `128.0 / t` are a
// Python scalar over a tensor, which torch computes as reciprocal(t) * s;
// Python constants are rounded to float32 as torch rounds a scalar;
// `eval_sh` adds its terms in coefficient order; a sum of three over the
// last axis (`(t0 * st0).sum(-1)`) is torch's reduction on the card, which
// gives two threads the columns (0, 2) and (1) and adds (a0 + a2) + a1 to a
// zero (so -0 reads +0). The opacity threshold uses logf, as torch's CUDA
// log does. min and max return NaN when either operand is NaN, and clamp
// keeps a NaN input, as torch.minimum, torch.maximum and torch.clamp do
// (fminf would drop it).
//
// The payload path (render_depth's per-item payloads) writes no channels:
// the wrapper hands the payload on as they are, as the plain version does.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGaussians = 64;          // Gaussians a block
constexpr int kStride = kGaussians + 1;  // shared row stride of one coefficient
constexpr int kMaxBasis = 25;           // degree 4

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp(v, min=lo): a NaN input stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

// torch's (a * b).sum(-1) over three columns on the card (see the head).
__device__ __forceinline__ float sum3(float a0, float a1, float a2) { return add(add(add(a0, a2), a1), 0.0f); }

// A Python float, rounded as torch rounds a scalar for a float32 tensor.
__device__ __forceinline__ constexpr float f(double v) { return static_cast<float>(v); }

// ops/sh.py::_sh_basis_terms at unit direction (x, y, z), up to `degree`,
// each term in its Python order of operations.
__device__ __forceinline__ void sh_basis(float x, float y, float z, int degree, float (&b)[kMaxBasis]) {
  b[0] = mul(f(0.28209479177387814), 1.0f);
  if (degree < 1) return;
  b[1] = mul(f(-0.4886025119029199), x);
  b[2] = mul(f(0.4886025119029199), y);
  b[3] = mul(f(-0.4886025119029199), z);
  if (degree < 2) return;
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
  b[4] = mul(f(1.0925484305920792), xz);
  b[5] = mul(f(-1.0925484305920792), xy);
  b[6] = mul(f(0.31539156525252005), sub(sub(mul(2.0f, yy), zz), xx));
  b[7] = mul(f(-1.0925484305920792), yz);
  b[8] = mul(f(0.5462742152960396), sub(zz, xx));
  if (degree < 3) return;
  const float zz3_xx = sub(mul(3.0f, zz), xx);
  const float yy4_zz_xx = sub(sub(mul(4.0f, yy), zz), xx);
  const float zz_xx = sub(zz, xx);
  const float zz_xx3 = sub(zz, mul(3.0f, xx));
  b[9] = mul(mul(f(-0.5900435899266435), x), zz3_xx);
  b[10] = mul(mul(f(2.890611442640554), xz), y);
  b[11] = mul(mul(f(-0.4570457994644658), x), yy4_zz_xx);
  b[12] = mul(mul(f(0.3731763325901154), y), sub(sub(mul(2.0f, yy), mul(3.0f, zz)), mul(3.0f, xx)));
  b[13] = mul(mul(f(-0.4570457994644658), z), yy4_zz_xx);
  b[14] = mul(mul(f(1.445305721320277), y), zz_xx);
  b[15] = mul(mul(f(-0.5900435899266435), z), zz_xx3);
  if (degree < 4) return;
  const float yy7_1 = sub(mul(7.0f, yy), 1.0f);
  const float yy7_3 = sub(mul(7.0f, yy), 3.0f);
  b[16] = mul(mul(f(2.5033429417967046), xz), zz_xx);
  b[17] = mul(mul(f(-1.7701307697799304), xy), zz3_xx);
  b[18] = mul(mul(f(0.9461746957575601), xz), yy7_1);
  b[19] = mul(mul(f(-0.6690465435572892), xy), yy7_3);
  b[20] = mul(f(0.10578554691520431), add(mul(yy, sub(mul(35.0f, yy), 30.0f)), 3.0f));
  b[21] = mul(mul(f(-0.6690465435572892), yz), yy7_3);
  b[22] = mul(mul(f(0.47308734787878004), zz_xx), yy7_1);
  b[23] = mul(mul(f(-1.7701307697799304), yz), zz_xx3);
  b[24] = mul(f(0.6258357354491761), sub(mul(zz, zz_xx3), mul(xx, zz3_xx)));
}

// eval_sh of `channels` channels of one table into out[0 .. channels): each
// channel's coefficients coefficient-major in shared memory from `coef`
// (channel c's term k at (c stride + k) kStride), `terms` of them, added in
// coefficient order; +0.5, and clamped at 0 for color. Four channels at a
// time, so that four independent sums are in flight.
__device__ __forceinline__ void sh_channels(const float* coef, int channels, int stride, int terms,
                                            const float (&b)[kMaxBasis], bool clamp, float* out) {
  for (int c0 = 0; c0 < channels; c0 += 4) {
    const int m = min(4, channels - c0);
    float acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = i < m ? mul(coef[(c0 + i) * stride * kStride], b[0]) : 0.0f;
#pragma unroll
    for (int k = 1; k < kMaxBasis; ++k) {
      if (k < terms) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < m) acc[i] = add(acc[i], mul(coef[((c0 + i) * stride + k) * kStride], b[k]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < m) out[c0 + i] = clamp ? clamp_min(add(acc[i], 0.5f), 0.0f) : add(acc[i], 0.5f);
    }
  }
}

struct Table {
  const float* sh;   // (B, G, channels, stride) or null
  int channels, stride, degree;
};

struct Params {
  int items, gaussians, start, views, width, height, scale_invariant, blocks_a_scene;
  const float* means;        // (B, G, 3) world
  const float* covariances;  // (B, G, 3, 3) world
  const float* opacities;    // (B, G)
  Table color, feature;
  const float* extrinsics;   // (N, 4, 4) cam-to-world
  const float* intrinsics;   // (N, 3, 3) normalized
  const float* near;         // (N,)
  float2* mean2d;            // (N, G)
  float* conic;              // (N, G, 3)
  float* depth;              // (N, G)
  float* radius;             // (N, G)
  float* opacity;            // (N, G)
  float* channels;           // (N, G, 3 + feature channels), null on the payload path
  float2* extent;            // (N, G)
};

// An item's camera as every row of it uses it, field f of slot i of a
// block's kItems cameras at f * kItems + i in shared memory.
enum CameraField {
  kC0, kC1, kC2,                                     // the camera's position (unscaled)
  kScale, kScale2,                                   // 1 / near and its square (1 unless scale-invariant)
  kR00, kR01, kR02, kR10, kR11, kR12, kR20, kR21, kR22,  // world-to-camera rotation
  kT0, kT1, kT2,                                     // world-to-camera translation (scaled)
  kFx, kFy, kCx, kCy, kLimX, kLimY,
  kCameraFields
};
constexpr int kItems = 32;

// api._render's scale-invariant pre-normalization and the item-level part
// of camera.project_gaussians_to_screen, for pass item n.
__device__ __forceinline__ void set_camera(float* cam, const Params& p, int n) {
  const float* e = p.extrinsics + 16 * n;
  const float* in = p.intrinsics + 9 * n;
  float t0 = e[3], t1 = e[7], t2 = e[11], scale = 1.0f;
  cam[kC0 * kItems] = t0;
  cam[kC1 * kItems] = t1;
  cam[kC2 * kItems] = t2;
  if (p.scale_invariant) {
    scale = mul(div(1.0f, p.near[n]), 1.0f);
    t0 = mul(t0, scale);
    t1 = mul(t1, scale);
    t2 = mul(t2, scale);
  }
  cam[kScale * kItems] = scale;
  cam[kScale2 * kItems] = mul(scale, scale);
  // camera.world_to_camera: rot[i][j] = e[j][i], trans = -(rot t).
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) cam[(kR00 + 3 * i + j) * kItems] = e[4 * j + i];
    cam[(kT0 + i) * kItems] = -add(add(mul(e[i], t0), mul(e[4 + i], t1)), mul(e[8 + i], t2));
  }
  const float fx = mul(in[0], static_cast<float>(p.width)), fy = mul(in[4], static_cast<float>(p.height));
  cam[kFx * kItems] = fx;
  cam[kFy * kItems] = fy;
  cam[kCx * kItems] = mul(in[2], static_cast<float>(p.width));
  cam[kCy * kItems] = mul(in[5], static_cast<float>(p.height));
  cam[kLimX * kItems] = mul(f(1.3), mul(div(1.0f, fx), f(0.5 * p.width)));
  cam[kLimY * kItems] = mul(f(1.3), mul(div(1.0f, fy), f(0.5 * p.height)));
}

// Copies `rows` Gaussians' table rows (each `width` floats, contiguous from
// `src`) to shared memory, coefficient j of Gaussian r at (j0 + j) kStride + r.
__device__ __forceinline__ void stage(float* smem, int j0, const float* __restrict__ src, int width, int rows) {
  for (int e = static_cast<int>(threadIdx.x); e < rows * width; e += static_cast<int>(blockDim.x)) {
    const int r = e / width;
    smem[(j0 + e - r * width) * kStride + r] = src[e];
  }
}

// Three blocks of 256 threads an SM (80 registers, a few bytes spilled):
// on the 30-view pass 0.70 ms against 0.83 at two blocks' 101 registers.
__global__ void __launch_bounds__(256, 3) shade_project_kernel(const Params p) {
  extern __shared__ float coeffs[];
  __shared__ float cameras[kCameraFields * kItems];
  const int scene_block = static_cast<int>(blockIdx.x) / p.blocks_a_scene;
  const int g0 = (static_cast<int>(blockIdx.x) - scene_block * p.blocks_a_scene) * kGaussians;
  const int scene = p.start / p.views + scene_block;
  const int first = max(p.start, scene * p.views) - p.start;
  const int last = min(p.start + p.items, (scene + 1) * p.views) - p.start;
  const int rows = min(kGaussians, p.gaussians - g0);
  const size_t scene_row = static_cast<size_t>(scene) * p.gaussians;
  const int color_width = p.color.sh ? p.color.channels * p.color.stride : 0;
  if (p.color.sh) stage(coeffs, 0, p.color.sh + (scene_row + g0) * color_width, color_width, rows);
  if (p.feature.sh) {
    const int width = p.feature.channels * p.feature.stride;
    stage(coeffs, color_width, p.feature.sh + (scene_row + g0) * width, width, rows);
  }
  const int local = static_cast<int>(threadIdx.x) % kGaussians;
  const int part = static_cast<int>(threadIdx.x) / kGaussians, per = static_cast<int>(blockDim.x) / kGaussians;
  const bool live = local < rows;
  const int g = g0 + (live ? local : 0);
  const size_t gi = scene_row + g;

  const float m0 = p.means[3 * gi], m1 = p.means[3 * gi + 1], m2 = p.means[3 * gi + 2];
  float cov[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) cov[k] = p.covariances[9 * gi + k];
  const float op = p.opacities[gi];
  // Per Gaussian: the opacity test and the extents' threshold.
  const bool op_ok = op > f(1.0 / 255.0);
  const float log_op = add(logf(mul(255.0f, clamp_min(op, f(1e-12)))), f(1e-3));
  const float two_lo = mul(2.0f, clamp_min(log_op, 0.0f));
  const int color_terms = (p.color.degree + 1) * (p.color.degree + 1);
  const int feature_terms = (p.feature.degree + 1) * (p.feature.degree + 1);
  const int basis_degree = max(p.color.degree, p.feature.degree);
  const int n_channels = (p.color.sh ? p.color.channels : 0) + (p.feature.sh ? p.feature.channels : 0);
  const float right = f(p.width - 0.5), bottom = f(p.height - 0.5);

  for (int chunk = first; chunk < last; chunk += kItems) {
    const int count = min(kItems, last - chunk);
    __syncthreads();   // the tables are staged and the last chunk's cameras read
    if (static_cast<int>(threadIdx.x) < count) set_camera(cameras + threadIdx.x, p, chunk + threadIdx.x);
    __syncthreads();
    if (!live) continue;
    for (int i = part; i < count; i += per) {
      const int n = chunk + i;
      const float* cam = cameras + i;
      const size_t row = static_cast<size_t>(n) * p.gaussians + g;

      if (p.channels) {
        // api.view_channels: the unit direction from the camera, unscaled.
        const float d0 = sub(m0, cam[kC0 * kItems]), d1 = sub(m1, cam[kC1 * kItems]);
        const float d2 = sub(m2, cam[kC2 * kItems]);
        const float norm = add(root(add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2))), f(1e-12));
        float b[kMaxBasis];
        sh_basis(div(d0, norm), div(d1, norm), div(d2, norm), basis_degree, b);
        float* out = p.channels + row * n_channels;
        if (p.color.sh) sh_channels(coeffs + local, p.color.channels, p.color.stride, color_terms, b, true, out);
        if (p.feature.sh) {
          sh_channels(coeffs + color_width * kStride + local, p.feature.channels, p.feature.stride, feature_terms, b,
                      false, out + (p.color.sh ? p.color.channels : 0));
        }
      }

      const float scale = cam[kScale * kItems], s2 = cam[kScale2 * kItems];
      const float ms0 = p.scale_invariant ? mul(m0, scale) : m0;
      const float ms1 = p.scale_invariant ? mul(m1, scale) : m1;
      const float ms2 = p.scale_invariant ? mul(m2, scale) : m2;
      float s[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) s[k] = p.scale_invariant ? mul(cov[k], s2) : cov[k];
      float r[3][3];
#pragma unroll
      for (int k = 0; k < 9; ++k) r[k / 3][k % 3] = cam[(kR00 + k) * kItems];

      // camera.project_gaussians_to_screen.
      const float p_x = add(add(add(mul(r[0][0], ms0), mul(r[0][1], ms1)), mul(r[0][2], ms2)), cam[kT0 * kItems]);
      const float p_y = add(add(add(mul(r[1][0], ms0), mul(r[1][1], ms1)), mul(r[1][2], ms2)), cam[kT1 * kItems]);
      const float z = add(add(add(mul(r[2][0], ms0), mul(r[2][1], ms1)), mul(r[2][2], ms2)), cam[kT2 * kItems]);
      const float fx = cam[kFx * kItems], fy = cam[kFy * kItems];
      const float lim_x = cam[kLimX * kItems], lim_y = cam[kLimY * kItems];

      const float safe_z = z > f(1e-6) ? z : f(1e-6);
      const float mx = sub(add(div(mul(fx, p_x), safe_z), cam[kCx * kItems]), 0.5f);
      const float my = sub(add(div(mul(fy, p_y), safe_z), cam[kCy * kItems]), 0.5f);
      const float tx = mul(nan_max(nan_min(div(p_x, safe_z), lim_x), -lim_x), safe_z);
      const float ty = mul(nan_max(nan_min(div(p_y, safe_z), lim_y), -lim_y), safe_z);

      const float inv_z = mul(div(1.0f, safe_z), 1.0f);
      const float inv_z2 = mul(inv_z, inv_z);
      const float j00 = mul(fx, inv_z);
      const float j02 = mul(mul(-fx, tx), inv_z2);
      const float j11 = mul(fy, inv_z);
      const float j12 = mul(mul(-fy, ty), inv_z2);
      float a[3], bb[3], sa[3], sb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a[k] = add(mul(j00, r[0][k]), mul(j02, r[2][k]));
        bb[k] = add(mul(j11, r[1][k]), mul(j12, r[2][k]));
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sa[k] = add(add(mul(a[0], s[k]), mul(a[1], s[3 + k])), mul(a[2], s[6 + k]));
        sb[k] = add(add(mul(bb[0], s[k]), mul(bb[1], s[3 + k])), mul(bb[2], s[6 + k]));
      }
      const float c00 = add(sum3(mul(a[0], sa[0]), mul(a[1], sa[1]), mul(a[2], sa[2])), f(0.3));
      float c01 = sum3(mul(a[0], sb[0]), mul(a[1], sb[1]), mul(a[2], sb[2]));
      const float c11 = add(sum3(mul(bb[0], sb[0]), mul(bb[1], sb[1]), mul(bb[2], sb[2])), f(0.3));
      const float c01_max = mul(f(0.99), root(clamp_min(mul(c00, c11), 0.0f)));
      c01 = nan_max(nan_min(c01, c01_max), -c01_max);

      const float det = sub(mul(c00, c11), mul(c01, c01));
      const bool det_ok = det > 0.0f;
      const float safe_det = det_ok ? det : 1.0f;
      const float mid = mul(0.5f, add(c00, c11));
      const float lambda1 = add(mid, root(clamp_min(sub(mul(mid, mid), det), f(0.1))));
      const float rad = ceilf(mul(3.0f, root(clamp_min(lambda1, 0.0f))));

      const bool valid = z > f(0.2) && det_ok && op_ok && add(mx, rad) >= -0.5f && sub(mx, rad) <= right &&
                         add(my, rad) >= -0.5f && sub(my, rad) <= bottom;
      const float rad_out = valid ? rad : 0.0f;
      const float ext_x = nan_min(rad_out, add(root(mul(two_lo, clamp_min(c00, 0.0f))), f(0.01)));
      const float ext_y = nan_min(rad_out, add(root(mul(two_lo, clamp_min(c11, 0.0f))), f(0.01)));

      p.mean2d[row] = make_float2(mx, my);
      p.conic[3 * row] = div(c11, safe_det);
      p.conic[3 * row + 1] = div(-c01, safe_det);
      p.conic[3 * row + 2] = div(c00, safe_det);
      p.depth[row] = z;
      p.radius[row] = rad_out;
      p.opacity[row] = valid ? op : 0.0f;
      p.extent[row] = valid ? make_float2(ext_x, ext_y) : make_float2(0.0f, 0.0f);
    }
  }
}

}  // namespace

// A pass of `items` items (global items start .. start + items - 1, `views`
// a scene) over `gaussians` Gaussians a scene. A table with degree -1 is
// absent; with both absent (the payload path) `channels` is not written.
// Every pointer is float32, contiguous; mean2d and extent 8-byte aligned.
// Returns cudaErrorInvalidValue, launching nothing, where a block's 64
// Gaussians' table rows and its cameras exceed the shared memory a block
// may take.
extern "C" int shade_project(int items, int gaussians, int start, int views, int width, int height,
                             int scale_invariant, int color_stride, int color_degree, int feature_channels,
                             int feature_stride, int feature_degree, const void* means, const void* covariances,
                             const void* opacities, const void* color_sh, const void* feature_sh,
                             const void* extrinsics, const void* intrinsics, const void* near, void* mean2d,
                             void* conic, void* depth, void* radius, void* opacity, void* channels, void* extent,
                             void* stream) {
  if (items <= 0 || gaussians <= 0) return 0;
  Params p;
  p.items = items;
  p.gaussians = gaussians;
  p.start = start;
  p.views = views;
  p.width = width;
  p.height = height;
  p.scale_invariant = scale_invariant;
  p.blocks_a_scene = (gaussians + kGaussians - 1) / kGaussians;
  p.means = static_cast<const float*>(means);
  p.covariances = static_cast<const float*>(covariances);
  p.opacities = static_cast<const float*>(opacities);
  p.color = {color_degree >= 0 ? static_cast<const float*>(color_sh) : nullptr, 3, color_stride, color_degree};
  p.feature = {feature_degree >= 0 ? static_cast<const float*>(feature_sh) : nullptr, feature_channels,
               feature_stride, feature_degree};
  p.extrinsics = static_cast<const float*>(extrinsics);
  p.intrinsics = static_cast<const float*>(intrinsics);
  p.near = static_cast<const float*>(near);
  p.mean2d = static_cast<float2*>(mean2d);
  p.conic = static_cast<float*>(conic);
  p.depth = static_cast<float*>(depth);
  p.radius = static_cast<float*>(radius);
  p.opacity = static_cast<float*>(opacity);
  p.channels = (p.color.sh || p.feature.sh) ? static_cast<float*>(channels) : nullptr;
  p.extent = static_cast<float2*>(extent);

  // Threads a Gaussian: up to 4, no more than a scene's items in the pass.
  const int scene_items = min(items, views);
  const int per_gaussian = scene_items >= 4 ? 4 : (scene_items >= 2 ? 2 : 1);
  const int scenes = (start + items - 1) / views - start / views + 1;
  const int widths = (p.color.sh ? 3 * color_stride : 0) + (p.feature.sh ? feature_channels * feature_stride : 0);
  const int shared = widths * kStride * static_cast<int>(sizeof(float));
  int device = 0, most = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // The cameras' static shared memory counts against the same limit.
  if (shared + static_cast<int>(sizeof(float)) * kCameraFields * kItems > most) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shared > 48 * 1024) {
    rc = cudaFuncSetAttribute(shade_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  shade_project_kernel<<<scenes * p.blocks_a_scene, kGaussians * per_gaussian, shared,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
