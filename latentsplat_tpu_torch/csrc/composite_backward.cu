// composite_backward: per-pair gradients of the tile compositor, replaying
// each tile's depth-sorted pairs back to front.
//
// Replaces latentsplat_tpu/ops/rasterize/pallas_kernels.py::composite_pairs_bwd
// (_bwd_kernel). The TPU kernel replayed whole 512-pair chunks with
// triangular-matmul prefix and suffix scans in log space, and accumulated
// per-pair gradients by read-modify-writes of overlapping chunk windows,
// which the sequential TPU grid made race-free. Here one block owns one
// tile and one thread owns one pixel; warp w owns the tile's rows 2w and
// 2w + 1. The block walks its tile's pairs from the tile's largest
// per-pixel `last` down to the tile start, staging batches of 64 pairs'
// attributes in shared memory (one 16-float row per pair, 20 for the
// 12-channel payload of `variational: latents`, read as float4; the row's
// last two floats hold the pair's footprint rows).
// A pixel takes part only for pairs below its own `last`, which are
// exactly the pairs its forward composited (the forward stops each pixel
// on its own).
//
// Per (pair, pixel) it recomputes alpha with the forward's rules and
// rounding (0.99 clamp, drop when power > 0 or alpha < 1/255, expf), so
// its decisions match composite_forward, recovers the transmittance before
// the pair as T * (1 / (1 - alpha)) (finite because alpha <= 0.99), and
// carries the suffix S = g_T * T_final + sum of later pairs'
// alpha * T * (c . g):
//   d_alpha   = (c . g) * T - S / (1 - alpha), zero where alpha was clamped
//   d_opacity = d_alpha * exp(power),  d_power = d_alpha * alpha
//   -> conic a/b/c and mean x/y;  d_channel = alpha * T * g.
// That value path is left to the compiler's contractions (FMA): it decides
// nothing, and its rounding is inside the gradient tolerance.
//
// Where a pair's 6 + NCH partials fit 16 slots (NCH <= 10), a warp steps
// over two pairs at a time, so that their alpha tests overlap, and sums
// both pairs' partials (each padded to 16) over its 32 pixels by recursive
// halving: at each of five steps a lane keeps half of its values and adds
// its partner's copy of that half, so lane l ends with the warp sum of
// value l after 31 shuffles (a shuffle tree per value takes 70 per pair),
// and the lanes store the 2 x 16 sums in one instruction. The 18 partials
// of the 12-channel payload take all 32 slots of one pair, so that
// instantiation steps over one pair at a time with the same exchange. A warp skips the alpha tests of a pair whose footprint (the
// rows where alpha can reach 1/255, widened by a margin far above float
// rounding) misses its two rows, and of pairs above its own largest
// `last`; it stores zeros when none of its lanes composited either pair.
// At the end of each batch the 8 warps' sums are added in warp order and
// written to d_rows[order[pos]], the pair's Gaussian-major position, where
// reduce_pairs sums contiguous segments; rows of pairs past the tile's
// largest `last` are written as zeros, so every row is written. No
// atomics, so the result is deterministic; a pair belongs to one tile, so
// blocks never share a row.
//
// Bound: operations. Per (pair, pixel) below the pixel's `last` ~14 and
// per composited (pair, pixel) ~60 more, against which the kernel pays for
// whole warps (a composited pair uses about a quarter of a warp's lanes),
// the shuffle exchange, and each tile's serial walk (under bf16_mm, the
// walk of one scan block, and a second pass of alpha tests for the
// suffix; see below).
//
// The fast family (FAST) reproduces the values of the TPU kernel's `fast`
// switch (pallas_kernels.py:600-637) and of the bfloat16 gradient rows
// (tiled.py:662-679), with knobs chosen at run time:
// - f16_xy: the staged mean is rounded to float16 relative to the tile's
//   origin, as composite_forward stages it.
// - bf16_mm: the transmittance before a pair is exp(lt + p16), with lt
//   the log T at the start of the pair's SCAN_BLOCK-block and p16 the
//   bfloat16 sum of log1p(-alpha) of the pixel's earlier pairs in it: the
//   forward wrote (lt, the block's whole bf16 sum) to the block state, and
//   walking back the pixel subtracts each pair's term from that sum. The
//   reciprocal recovery of the exact path cannot give the forward's
//   rounding. The suffix is float32 over later blocks and the sum of
//   bfloat16-rounded contributions within the block; c . g takes bfloat16
//   channels and cotangents; each partial that is summed over the pixels
//   is rounded to bfloat16 first (the channel partials are products of
//   two bfloat16 values). That path is rounded explicitly, in the plain
//   version's order, so that the rounded terms agree.
// - bf16_grads: each row is rounded to bfloat16 when it is written.
//
// Under bf16_mm the walk is split at the scan blocks (SPLIT): a block's
// replay needs, besides the block state, only one float32 number per
// pixel from the rest of the tile, the suffix entering it. So two
// launches run one block of 256 threads per (tile, scan block), one per
// row of the block state (its capacity, known from shapes; a block finds
// its tile by a binary search of the state's tile offsets and leaves at
// once on an unused row):
// 1. suffix_kernel replays each pixel's pairs of the block back to front
//    with the arithmetic of partials_log (the same log_step) and
//    writes the float32 sum of their contributions, suffix32, to a
//    (capacity, 256) scratch; no partials, no exchange.
// 2. composite_backward_kernel<SPLIT> starts each pixel from g_T T_final
//    plus the suffix32 of the tile's later blocks, added from the last
//    down, which is the order in which the serial walk enters them (an
//    unused block adds +0.0, which changes no sum after the first +0.0,
//    and the serial walk's first entry adds +0.0 too), and runs the
//    serial kernel's body over its <= 128 pairs.
// Each pixel's per-pair values, each warp's sum and the 8 warps' sum in
// warp order are those of the serial walk, so the rows are the same bits;
// the longest chain is one block's 128 pairs, not a tile's thousands.
//
// One launch replays a pass: the N (scene, view) items of a render call,
// with tiles n T + t (T = one view's tile count) and one tile-sorted pair
// array, as composite_forward composited it. A block splits its tile id
// into (item n, local tile t), replays at item n's own pixel coordinates
// and reads item n's planes of `last`, T_final and the cotangents
// ((N, ...) each); the scan blocks are counted from the item's first pair
// (tile_ranges[n T]), so every row has the bits of a launch over that
// item alone.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kBatch = 64;
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaThreshold = static_cast<float>(1.0 / 255.0);
constexpr unsigned kFull = 0xffffffffu;
// The fast family's scan block and knob bits (kernels.py _knob_bits).
constexpr int kScanBlock = 128;
constexpr int kF16Xy = 1;
constexpr int kBf16Mm = 2;
constexpr int kBf16Grads = 4;

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The layout of one instantiation: a pair's attribute row (kStride floats)
// staged as kRow floats whose last two hold its footprint rows, kPart
// exchange slots per pair (so 32 / kPart pairs per warp step), and kSlots
// floats per pair and warp in the shared partial sums.
template <int NCH>
struct Layout {
  static constexpr int kStride = 6 + NCH;
  static constexpr int kRow = kStride + 2 <= 16 ? 16 : (kStride + 2 + 3) / 4 * 4;
  static constexpr int kFootprint = kRow - 2;
  static constexpr int kPart = kStride <= 16 ? 16 : 32;
  static constexpr int kPairs = 32 / kPart;
  static constexpr int kSlots = kPart == 16 ? 16 : kStride;
  static_assert(kStride <= 32, "a pair's partials fit one warp exchange");
  static_assert(kFootprint % 4 == 2, "the footprint rows are a float4's z and w");
};

// One halving step over N values: the lane whose bit kOffset is set keeps
// values kHalf..2 kHalf-1, its partner 0..kHalf-1, and each adds the
// other's copy of the half it keeps.
template <int kHalf, int kOffset, int N>
__device__ __forceinline__ void halve(float (&v)[N], int lane) {
  const bool upper = (lane & kOffset) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kOffset);
  }
}

// Sums v[0..31] over the warp in 31 shuffles; lane l returns the sum of
// value l.
__device__ __forceinline__ float warp_sum32(float (&v)[32], int lane) {
  halve<16, 16>(v, lane);
  halve<8, 8>(v, lane);
  halve<4, 4>(v, lane);
  halve<2, 2>(v, lane);
  halve<1, 1>(v, lane);
  return v[0];
}

// The rows [lo, hi] outside which alpha < 1/255 at every pixel: for a
// positive-definite conic -power >= dy^2 (ac - b^2) / (2a), and alpha
// needs -power <= log(255 opacity). Widened by 1e-3 relative and 0.05 px;
// empty when opacity < 1/255, unbounded when the conic is not positive
// definite.
template <int N>
__device__ __forceinline__ float2 footprint_rows(const float (&a)[N]) {
  const float ca = a[2], cb = a[3], cc = a[4], opacity = a[5];
  if (!(opacity * 255.0f >= 1.0f)) return make_float2(INFINITY, -INFINITY);
  const float det = ca * cc - cb * cb;
  if (!(ca > 0.0f && det > 0.0f)) return make_float2(-INFINITY, INFINITY);
  const float tau = logf(255.0f * opacity) * 1.001f + 1e-3f;
  const float half = sqrtf(2.0f * tau * ca / det) * 1.001f + 0.05f;
  return make_float2(a[1] - half, a[1] + half);
}

// The forward's alpha test of one (pair, pixel), with its rounding. `e` is
// clamped to exp(0) where power > 0 so that a lane that fails the test
// still computes finite partials (which it then multiplies by zero).
struct Hit {
  float dx, dy, e, raw, alpha;
  bool pass;
};

__device__ __forceinline__ Hit alpha_test(const float4& q0, const float4& q1, float fx, float fy,
                                          bool in_range) {
  Hit h;
  const float ca = q0.z, cb = q0.w, cc = q1.x;
  h.dx = __fsub_rn(fx, q0.x);
  h.dy = __fsub_rn(fy, q0.y);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, h.dx), h.dx),
                               __fmul_rn(__fmul_rn(cc, h.dy), h.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, h.dx), h.dy));
  h.e = expf(fminf(power, 0.0f));
  h.raw = __fmul_rn(q1.y, h.e);
  h.alpha = fminf(kAlphaClamp, h.raw);
  h.pass = in_range && power <= 0.0f && h.alpha >= kAlphaThreshold;
  return h;
}

// One (pair, pixel)'s 6 + NCH partials into part[0..kPart-1], stepping
// the pixel's transmittance t and suffix back over the pair. Branch-free: a
// lane that failed the alpha test takes alpha = 0, so t and suffix keep
// their values and every partial is zero.
template <int NCH>
__device__ __forceinline__ void partials(const float4 (&row)[Layout<NCH>::kRow / 4], const Hit& h,
                                         const float (&g)[NCH], float& t, float& suffix,
                                         float* part) {
  constexpr int kRow = Layout<NCH>::kRow;
  float a[kRow];
#pragma unroll
  for (int i = 0; i < kRow / 4; ++i) {
    a[4 * i] = row[i].x;
    a[4 * i + 1] = row[i].y;
    a[4 * i + 2] = row[i].z;
    a[4 * i + 3] = row[i].w;
  }
  const float ca = a[2], cb = a[3], cc = a[4];
  const float alpha = h.pass ? h.alpha : 0.0f;
  const float inv = __frcp_rn(1.0f - alpha);
  const float t_before = t * inv;
  const float w = alpha * t_before;
  float cg_dot = 0.0f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    cg_dot += a[6 + c] * g[c];
    part[6 + c] = w * g[c];
  }
  const float d_alpha = h.pass && h.raw < kAlphaClamp ? cg_dot * t_before - suffix * inv : 0.0f;
  const float d_pow = d_alpha * alpha;
  const float dx = h.dx, dy = h.dy;
  part[0] = (ca * dx + cb * dy) * d_pow;
  part[1] = (cc * dy + cb * dx) * d_pow;
  part[2] = -0.5f * dx * dx * d_pow;
  part[3] = -dx * dy * d_pow;
  part[4] = -0.5f * dy * dy * d_pow;
  part[5] = d_alpha * h.e;
#pragma unroll
  for (int r = 6 + NCH; r < Layout<NCH>::kPart; ++r) part[r] = 0.0f;
  suffix += w * cg_dot;
  t = t_before;
}

// A pixel's replay state in one scan block under bf16_mm: the block's log
// T at its start, the bf16 sum of log1p(-alpha) of the pixel's pairs in it
// before the current one (both read from the block state at the pixel's
// first pair of the block, walking back), and its float32 and bfloat16
// sums of the contributions of the later pairs in the block.
struct Replay {
  float lt = 0.0f, prefix16 = 0.0f, suffix32 = 0.0f, suffix16 = 0.0f;
  bool entered = false;
};

// Steps the replay back over a pair the pixel composited at alpha: the
// entry's (lt, bf16 sum) on the block's first such pair, then that pair's
// bf16 term off the prefix.
__device__ __forceinline__ void log_step(Replay& r, const float2* entry, float alpha) {
  if (!r.entered) {
    const float2 v = *entry;
    r.lt = v.x;
    r.prefix16 = v.y;
    r.entered = true;
  }
  r.prefix16 = __fsub_rn(r.prefix16, bf16_round(log1pf(-alpha)));
}

// c . g over the bfloat16 channels of the staged row a and the bfloat16
// cotangents g, left to right.
template <int NCH, int N>
__device__ __forceinline__ float channel_dot(const float (&a)[N], const float (&g)[NCH]) {
  float cg = __fmul_rn(a[6], g[0]);
#pragma unroll
  for (int c = 1; c < NCH; ++c) cg = __fadd_rn(cg, __fmul_rn(a[6 + c], g[c]));
  return cg;
}

template <int N>
__device__ __forceinline__ void unpack(const float4* row, float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    a[4 * i] = row[i].x;
    a[4 * i + 1] = row[i].y;
    a[4 * i + 2] = row[i].z;
    a[4 * i + 3] = row[i].w;
  }
}

// partials() under bf16_mm (see the header), inside one scan block:
// `suffix` is the float32 suffix of the tile's later blocks, `g` the
// bfloat16 cotangents, the row's channels bfloat16; `entry` the pixel's
// entry of the block's state.
template <int NCH>
__device__ __forceinline__ void partials_log(const float4 (&row)[Layout<NCH>::kRow / 4], const Hit& h,
                                             const float (&g)[NCH], Replay& r, float suffix,
                                             const float2* entry, float* part) {
  float a[Layout<NCH>::kRow];
  unpack(row, a);
  const float ca = a[2], cb = a[3], cc = a[4];
  const float alpha = h.pass ? h.alpha : 0.0f;
  if (h.pass) log_step(r, entry, alpha);
  const float one_minus = __fsub_rn(1.0f, alpha);
  const float t_before = expf(__fadd_rn(r.lt, r.prefix16));
  const float w = __fmul_rn(alpha, t_before);
  const float w16 = bf16_round(w);
  const float cg = channel_dot(a, g);
#pragma unroll
  for (int c = 0; c < NCH; ++c) part[6 + c] = __fmul_rn(w16, g[c]);
  const float d_alpha =
      h.pass && h.raw < kAlphaClamp
          ? __fsub_rn(__fmul_rn(cg, t_before), __fdiv_rn(__fadd_rn(suffix, r.suffix16), one_minus))
          : 0.0f;
  const float d_pow = __fmul_rn(d_alpha, alpha);
  const float dx = h.dx, dy = h.dy;
  part[0] = bf16_round(__fmul_rn(__fadd_rn(__fmul_rn(ca, dx), __fmul_rn(cb, dy)), d_pow));
  part[1] = bf16_round(__fmul_rn(__fadd_rn(__fmul_rn(cc, dy), __fmul_rn(cb, dx)), d_pow));
  part[2] = bf16_round(__fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dx), dx), d_pow));
  part[3] = bf16_round(__fmul_rn(__fmul_rn(-dx, dy), d_pow));
  part[4] = bf16_round(__fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dy), dy), d_pow));
  part[5] = bf16_round(__fmul_rn(d_alpha, h.e));
#pragma unroll
  for (int k = 6 + NCH; k < Layout<NCH>::kPart; ++k) part[k] = 0.0f;
  if (h.pass) r.suffix16 = __fadd_rn(r.suffix16, bf16_round(__fmul_rn(w, cg)));
}

// Loads the attribute row of Gaussian `gid` padded to kRow floats, with
// f16_xy's rounded mean (tile origin ox, oy), bf16_mm's bfloat16 channels
// and the footprint rows in its last two floats.
template <int NCH>
__device__ __forceinline__ void stage_row(const float* __restrict__ attrs, int gid, float ox, float oy,
                                          bool f16_xy, bool bf16_mm, float4* dst) {
  using L = Layout<NCH>;
  const float* src = attrs + static_cast<int64_t>(gid) * L::kStride;
  float a[L::kRow];
#pragma unroll
  for (int r = 0; r < L::kRow; ++r) a[r] = r < L::kStride ? src[r] : 0.0f;
  if (f16_xy) {
    a[0] = __fadd_rn(__half2float(__float2half_rn(__fsub_rn(a[0], ox))), ox);
    a[1] = __fadd_rn(__half2float(__float2half_rn(__fsub_rn(a[1], oy))), oy);
  }
  if (bf16_mm) {
#pragma unroll
    for (int r = 6; r < L::kStride; ++r) a[r] = bf16_round(a[r]);
  }
  const float2 rows = footprint_rows(a);
  a[L::kFootprint] = rows.x;
  a[L::kFootprint + 1] = rows.y;
#pragma unroll
  for (int i = 0; i < L::kRow / 4; ++i) dst[i] = make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
}

// The scan block of block-state row `row`: its pass tile (the last of the
// pass's n_tiles tiles whose first row is <= row, by binary search of
// `offsets`), its index in the tile, its pair range [lo, hi) and its
// item's first pair (the tile's item: tile / num_tiles). False for a row
// no tile uses.
struct ScanBlock {
  int tile, index, lo, hi, start, first;
};

__device__ __forceinline__ bool find_block(const int32_t* __restrict__ tile_ranges,
                                           const int32_t* __restrict__ offsets, int n_tiles, int num_tiles,
                                           int row, ScanBlock& b) {
  int lo = 0, hi = n_tiles;   // offsets[0] == 0 <= row
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] <= row) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int start = tile_ranges[lo], stop = tile_ranges[lo + 1];
  b.first = tile_ranges[lo / num_tiles * num_tiles];
  const int first = (start - b.first) / kScanBlock;
  b.tile = lo;
  b.index = row - offsets[lo];
  if (stop <= start || b.index > (stop - 1 - b.first) / kScanBlock - first) return false;
  b.start = start;
  b.lo = max(start, b.first + (first + b.index) * kScanBlock);
  b.hi = min(stop, b.first + (first + b.index + 1) * kScanBlock);
  return true;
}

// The largest `last` of the tile (at least `start`) and of the calling
// warp, from each thread's own; `scratch` holds kWarps ints.
__device__ __forceinline__ int tile_last(int my_last, int start, int* scratch, int& warp_last) {
  warp_last = __reduce_max_sync(kFull, my_last);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = warp_last;
  __syncthreads();
  int end = start;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) end = max(end, scratch[w]);
  return end;
}

// The first launch under bf16_mm: one block per block-state row, one
// thread per pixel; writes each pixel's suffix32 of its pairs in the scan
// block (+0.0 where it composited none) to suffix_out[row * 256 + pixel],
// for every scan block below the tile's largest `last` but the tile's
// first.
template <int NCH>
__global__ void __launch_bounds__(kPixels) suffix_kernel(
    const int32_t* __restrict__ gids, const int32_t* __restrict__ tile_ranges,
    const float* __restrict__ attrs, int items, int num_tiles, int tiles_x, int width,
    const int32_t* __restrict__ last, const float* __restrict__ g_channels, int64_t plane, int knobs,
    const int32_t* __restrict__ block_offsets, const float2* __restrict__ block_state,
    float* __restrict__ suffix_out) {
  using L = Layout<NCH>;
  __shared__ float4 attr[kScanBlock][L::kRow / 4];
  __shared__ int scratch[kWarps];
  const int row = static_cast<int>(blockIdx.x);
  ScanBlock b;
  // A tile's first scan block has no earlier block to read its sums.
  if (!find_block(tile_ranges, block_offsets, items * num_tiles, num_tiles, row, b) || b.index == 0) return;
  const int tid = static_cast<int>(threadIdx.x);
  const int item = b.tile / num_tiles;
  const int tile = b.tile - item * num_tiles;
  const int tx0 = (tile % tiles_x) * kTile;
  const int ty0 = (tile / tiles_x) * kTile;
  const int px = tx0 + tid % kTile;
  const int py = ty0 + tid / kTile;
  const int64_t pixel = item * plane + py * width + px;
  const float fx = static_cast<float>(px), fy = static_cast<float>(py);
  const float warp_y0 = static_cast<float>(ty0 + 2 * (tid >> 5));
  const int my_last = last[pixel];
  int warp_last;
  const int end = tile_last(my_last, b.start, scratch, warp_last);
  if (b.lo >= end) return;
  const int n = min(b.hi, end) - b.lo;
  if (tid < n) {
    stage_row<NCH>(attrs, gids[b.lo + tid], static_cast<float>(tx0), static_cast<float>(ty0), knobs & kF16Xy,
                   true, attr[tid]);
  }
  float g[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    g[c] = bf16_round(g_channels[(static_cast<int64_t>(item) * NCH + c) * plane + py * width + px]);
  }
  const float2* entry = block_state + static_cast<int64_t>(row) * kPixels + tid;
  __syncthreads();

  Replay r;
  for (int k = min(n, warp_last - b.lo) - 1; k >= 0; --k) {
    const float4 f = attr[k][L::kFootprint / 4];
    if (!(f.z <= warp_y0 + 1.0f && f.w >= warp_y0)) continue;
    const Hit h = alpha_test(attr[k][0], attr[k][1], fx, fy, b.lo + k < my_last);
    if (!h.pass) continue;
    log_step(r, entry, h.alpha);
    float a[L::kRow];
    unpack(attr[k], a);
    const float t_before = expf(__fadd_rn(r.lt, r.prefix16));
    r.suffix32 = __fadd_rn(r.suffix32, __fmul_rn(__fmul_rn(h.alpha, t_before), channel_dot(a, g)));
  }
  suffix_out[static_cast<int64_t>(row) * kPixels + tid] = r.suffix32;
}

// Shared memory of one block: the batch's attribute rows and destinations,
// and the warps' partial sums, both double-buffered across batches so
// that one barrier per batch suffices.
template <int NCH>
struct Shared {
  float4 attr[kBatch][Layout<NCH>::kRow / 4];
  int64_t dst[2][kBatch];
  float part[2][kWarps][kBatch][Layout<NCH>::kSlots];
  int end[kWarps];
};

// SPLIT (FAST with bf16_mm): one block per block-state row, walking one
// scan block from the suffix that suffix_kernel's sums give; otherwise one
// block per tile, walking the whole tile.
// The split walk's thousands of short blocks are latency-bound: it runs
// three blocks (24 warps) an SM, at most 80 registers a thread.
template <int NCH, bool FAST, bool SPLIT>
__global__ void __launch_bounds__(kPixels, SPLIT ? 3 : 2) composite_backward_kernel(
    const int32_t* __restrict__ gids,         // (P,) depth-sorted within each tile
    const int32_t* __restrict__ tile_ranges,  // (T + 1,)
    const int64_t* __restrict__ order,        // (P,) sorted position -> Gaussian-major position
    const float* __restrict__ attrs,          // (N G, 6 + NCH)
    int items, int num_tiles, int tiles_x, int height, int width,   // num_tiles: T, one view's
    const int32_t* __restrict__ last,         // (N, H, W) exclusive end of contributing pairs
    const float* __restrict__ t_final,        // (N, H, W)
    const float* __restrict__ g_channels,     // (N, NCH, H, W) cotangent of the channels
    const float* __restrict__ g_t,            // (N, H, W) cotangent of T_final
    float* __restrict__ d_rows,               // (P, 6 + NCH) Gaussian-major
    int knobs,                                // FAST: kF16Xy | kBf16Grads (| kBf16Mm when SPLIT)
    const int32_t* __restrict__ block_offsets,  // SPLIT: (N T,) first state row of each tile
    const float2* __restrict__ block_state,     // SPLIT: (B, 256) from composite_forward
    const float* __restrict__ suffix_in) {      // SPLIT: (B, 256) from suffix_kernel
  static_assert(FAST || !SPLIT, "the split walk is the log-space replay of the fast family");
  using L = Layout<NCH>;
  constexpr int kStride = L::kStride;
  constexpr int kRow = L::kRow;
  constexpr int kFootprint = L::kFootprint;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<NCH>& sm = *reinterpret_cast<Shared<NCH>*>(smem_raw);

  ScanBlock b;
  if constexpr (SPLIT) {
    if (!find_block(tile_ranges, block_offsets, items * num_tiles, num_tiles, static_cast<int>(blockIdx.x), b)) {
      return;
    }
  } else {
    b.tile = static_cast<int>(blockIdx.x);
    b.lo = b.start = tile_ranges[b.tile];
    b.hi = tile_ranges[b.tile + 1];
  }
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int item = b.tile / num_tiles;
  const int tile = b.tile - item * num_tiles;
  const int tx0 = (tile % tiles_x) * kTile;
  const int ty0 = (tile / tiles_x) * kTile;
  const int px = tx0 + tid % kTile;
  const int py = ty0 + tid / kTile;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const float warp_y0 = static_cast<float>(ty0 + 2 * warp);
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t pixel = item * plane + py * width + px;
  const float* const g_pixel = g_channels + static_cast<int64_t>(item) * NCH * plane + (py * width + px);
  const bool f16_xy = FAST && (knobs & kF16Xy);
  const bool bf16_grads = FAST && (knobs & kBf16Grads);

  const int my_last = last[pixel];
  float t = t_final[pixel];
  float g[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    g[c] = g_pixel[c * plane];
    if (SPLIT) g[c] = bf16_round(g[c]);
  }
  float suffix = __fmul_rn(g_t[pixel], t);

  // Above its own largest `last` a warp only stores zeros; the tile's
  // largest `last` bounds the walk.
  int warp_last;
  const int end = tile_last(my_last, b.start, sm.end, warp_last);
  const int start = b.lo;
  const int walk_end = min(b.hi, end);

  // Pairs no pixel composited get zero rows.
  for (int p = max(start, end) + tid; p < b.hi; p += kPixels) {
    float* row = d_rows + order[p] * kStride;
#pragma unroll
    for (int r = 0; r < kStride; ++r) row[r] = 0.0f;
  }
  if (walk_end <= start) return;

  Replay replay;
  const float2* entry = nullptr;
  if constexpr (SPLIT) {
    // The later blocks' suffix32, from the tile's last walked block down.
    const int64_t row0 = block_offsets[b.tile];
    entry = block_state + (row0 + b.index) * kPixels + tid;
    suffix = __fadd_rn(suffix, 0.0f);
    // Loaded eight at a time, so that the loads overlap; added in order.
    for (int k = (end - 1 - b.first) / kScanBlock - (b.start - b.first) / kScanBlock; k > b.index; k -= 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = k - j > b.index ? suffix_in[(row0 + k - j) * kPixels + tid] : 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (k - j > b.index) suffix = __fadd_rn(suffix, v[j]);
      }
    }
  }
  auto pair_partials = [&](const float4 (&row)[kRow / 4], const Hit& h, float* part) {
    if constexpr (SPLIT) {
      partials_log<NCH>(row, h, g, replay, suffix, entry, part);
    } else {
      partials<NCH>(row, h, g, t, suffix, part);
    }
  };

  int buf = 0;
  const bool mine = (lane & 15) < kStride;
  for (int hi = walk_end; hi > start; hi -= kBatch, buf ^= 1) {
    const int lo = max(start, hi - kBatch);
    const int n = hi - lo;
    if (tid < n) {
      stage_row<NCH>(attrs, gids[lo + tid], static_cast<float>(tx0), static_cast<float>(ty0), f16_xy, SPLIT,
                     sm.attr[tid]);
      sm.dst[buf][tid] = order[lo + tid];
    }
    __syncthreads();
    if constexpr (L::kPairs == 2) {
      // Two pairs per step, a = k and b = k - 1 (back to front). Lane l
      // ends with value l & 15 of pair a (l < 16) or b, and stores it.
      for (int k = n - 1; k >= 0; k -= 2) {
        const bool has_b = k >= 1;
        const int kb = has_b ? k - 1 : k;
        float sum = 0.0f;
        if (lo + kb < warp_last) {
          // Footprint rows (z, w) against the warp's rows y0 and y0 + 1.
          // Footprint rows (z, w) against the warp's rows y0 and y0 + 1.
          const float4 fa = sm.attr[k][kFootprint / 4];
          const float4 fb = sm.attr[kb][kFootprint / 4];
          const bool near_a = fa.z <= warp_y0 + 1.0f && fa.w >= warp_y0;
          const bool near_b = has_b && fb.z <= warp_y0 + 1.0f && fb.w >= warp_y0;
          if (near_a || near_b) {
            float4 ra[kRow / 4], rb[kRow / 4];
            ra[0] = sm.attr[k][0];
            ra[1] = sm.attr[k][1];
            rb[0] = sm.attr[kb][0];
            rb[1] = sm.attr[kb][1];
            const Hit ha = alpha_test(ra[0], ra[1], fx, fy, near_a && lo + k < my_last);
            const Hit hb = alpha_test(rb[0], rb[1], fx, fy, near_b && lo + kb < my_last);
            if (__any_sync(kFull, ha.pass || hb.pass)) {
#pragma unroll
              for (int i = 2; i < kRow / 4; ++i) {
                ra[i] = sm.attr[k][i];
                rb[i] = sm.attr[kb][i];
              }
              float part[32];
              pair_partials(ra, ha, part);
              pair_partials(rb, hb, part + 16);
              sum = warp_sum32(part, lane);
            }
          }
        }
        if (mine && (lane < 16 || has_b)) sm.part[buf][warp][lane < 16 ? k : kb][lane & 15] = sum;
      }
    } else {
      // One pair per step; lane l ends with value l of the pair.
      for (int k = n - 1; k >= 0; --k) {
        float sum = 0.0f;
        if (lo + k < warp_last) {
          const float4 fa = sm.attr[k][kFootprint / 4];
          if (fa.z <= warp_y0 + 1.0f && fa.w >= warp_y0) {
            float4 ra[kRow / 4];
            ra[0] = sm.attr[k][0];
            ra[1] = sm.attr[k][1];
            const Hit ha = alpha_test(ra[0], ra[1], fx, fy, lo + k < my_last);
            if (__any_sync(kFull, ha.pass)) {
#pragma unroll
              for (int i = 2; i < kRow / 4; ++i) ra[i] = sm.attr[k][i];
              float part[32];
              pair_partials(ra, ha, part);
              sum = warp_sum32(part, lane);
            }
          }
        }
        if (lane < kStride) sm.part[buf][warp][k][lane] = sum;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * kStride; idx += kPixels) {
      const int k = idx / kStride;
      const int r = idx - k * kStride;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += sm.part[buf][w][k][r];
      d_rows[sm.dst[buf][k] * kStride + r] = bf16_grads ? bf16_round(sum) : sum;
    }
  }
}

// Launches one instantiation: SPLIT runs suffix_kernel and then the split
// walk over the block state's `capacity` rows, writing the scratch
// `suffix` (capacity, 256) in between; otherwise one block per tile.
template <int NCH, bool FAST, bool SPLIT>
cudaError_t launch(int items, int num_tiles, const void* gids, const void* tile_ranges, const void* order,
                   const void* attrs, int tiles_x, int height, int width, const void* last,
                   const void* t_final, const void* g_channels, const void* g_t, void* d_rows,
                   int knobs, const void* block_offsets, const void* block_state, int capacity,
                   void* suffix, cudaStream_t stream) {
  auto kernel = composite_backward_kernel<NCH, FAST, SPLIT>;
  constexpr int kBytes = static_cast<int>(sizeof(Shared<NCH>));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const auto* ids = static_cast<const int32_t*>(gids);
  const auto* ranges = static_cast<const int32_t*>(tile_ranges);
  const auto* rows = static_cast<const float*>(attrs);
  const auto* offsets = static_cast<const int32_t*>(block_offsets);
  const auto* state = static_cast<const float2*>(block_state);
  if constexpr (SPLIT) {
    suffix_kernel<NCH><<<capacity, kPixels, 0, stream>>>(
        ids, ranges, rows, items, num_tiles, tiles_x, width, static_cast<const int32_t*>(last),
        static_cast<const float*>(g_channels), static_cast<int64_t>(height) * width, knobs, offsets, state,
        static_cast<float*>(suffix));
  }
  kernel<<<SPLIT ? capacity : items * num_tiles, kPixels, kBytes, stream>>>(
      ids, ranges, static_cast<const int64_t*>(order), rows, items, num_tiles, tiles_x, height, width,
      static_cast<const int32_t*>(last), static_cast<const float*>(t_final),
      static_cast<const float*>(g_channels), static_cast<const float*>(g_t), static_cast<float*>(d_rows), knobs,
      offsets, state, static_cast<const float*>(suffix));
  return cudaSuccess;
}

}  // namespace

// Instantiated for the channel counts of composite_forward (4, 5, 8 and 12);
// a pass of `items` views of num_tiles tiles each.
extern "C" int composite_backward(
    int n_channels, int items, int num_tiles, const void* gids, const void* tile_ranges, const void* order,
    const void* attrs, int tiles_x, int height, int width, const void* last, const void* t_final,
    const void* g_channels, const void* g_t, void* d_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (items > 0 && num_tiles > 0) {
#define LAUNCH(N)                                                                                         \
  launch<N, false, false>(items, num_tiles, gids, tile_ranges, order, attrs, tiles_x, height, width, last, t_final, \
                          g_channels, g_t, d_rows, 0, nullptr, nullptr, 0, nullptr, s)
    switch (n_channels) {
      case 4:
        err = LAUNCH(4);
        break;
      case 5:
        err = LAUNCH(5);
        break;
      case 8:
        err = LAUNCH(8);
        break;
      case 12:
        err = LAUNCH(12);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The fast family, at composite_fast_channels' counts (5, 8 and 12);
// `knobs` is kF16Xy | kBf16Mm | kBf16Grads. bf16_mm reads the block state
// (block_offsets, block_state of `capacity` rows) that
// composite_forward_fast wrote and takes the split walk, with `suffix`
// (capacity, 256 floats) as its scratch: two launches.
extern "C" int composite_backward_fast(
    int n_channels, int knobs, int items, int num_tiles, const void* gids, const void* tile_ranges,
    const void* order, const void* attrs, int tiles_x, int height, int width, const void* last,
    const void* t_final, const void* g_channels, const void* g_t, const void* block_offsets,
    const void* block_state, int capacity, void* suffix, void* d_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const bool split = (knobs & kBf16Mm) != 0;
  if (split && (block_offsets == nullptr || block_state == nullptr || suffix == nullptr || capacity <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (items > 0 && num_tiles > 0) {
#define LAUNCH(N)                                                                                           \
  (split ? launch<N, true, true>(items, num_tiles, gids, tile_ranges, order, attrs, tiles_x, height, width, last,    \
                                 t_final, g_channels, g_t, d_rows, knobs, block_offsets, block_state,         \
                                 capacity, suffix, s)                                                        \
         : launch<N, true, false>(items, num_tiles, gids, tile_ranges, order, attrs, tiles_x, height, width, last,   \
                                  t_final, g_channels, g_t, d_rows, knobs, nullptr, nullptr, 0, nullptr, s))
    switch (n_channels) {
      case 5:
        err = LAUNCH(5);
        break;
      case 8:
        err = LAUNCH(8);
        break;
      case 12:
        err = LAUNCH(12);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
