// composite_forward: front-to-back alpha compositing of each 16x16 tile's
// depth-sorted pair segment.
//
// Replaces latentsplat_tpu/ops/rasterize/pallas_kernels.py::composite_pairs_fwd
// (pallas_kernels.py:399, _fwd_kernel). The TPU kernel composited 512-pair
// chunks with log-space prefix-sum matmuls on the MXU and stopped a whole
// tile only after a chunk in which every pixel saturated. Here one block of
// 64 threads owns one 8x8 quarter of a tile and one thread owns one pixel;
// warp w owns the 4-row x 8-column block at rows 4w..4w+3 of the quarter.
// Each thread walks the tile's pairs in order, multiplying its
// transmittance and accumulating channels, and stops on its own as soon as
// T < 1e-4 (after adding that pair's contribution). A warp leaves the walk
// once its 32 pixels are done, the block once its 64 are. The four quarters
// of a tile each stage all of its pairs, but stop on their own and spread a
// heavy tile over four SMs; one 256-thread block per tile measured slower.
//
// Bound: float operations, counted as chip_smoke.py's composite_work counts
// them: ~14 per (pair, pixel) evaluation up to the pixel's stop and
// 2 NCH + 3 per composited (pair, pixel). Each tile's walk is serial, so
// what the kernel pays for is the warp instructions of that walk:
// - The footprint cull. When a pair is staged, its footprint box (the
//   rows and columns outside which alpha < 1/255 at every pixel, widened
//   far beyond float rounding) is turned into one bit per warp block it
//   meets. A warp reads 32 pairs' bits in one ballot and steps only over
//   the pairs whose bit is set, so a pair whose footprint misses its 4 x 8
//   pixels costs it nothing. A culled pair could not composite at any of
//   the warp's pixels, so T, the channels and `last` are the same bits as
//   without the cull.
// - Two pairs per step. The quad, expf and alpha of the warp's next two
//   kept pairs are independent, so both are computed before either is
//   applied (in order), which overlaps their latencies; the channels are
//   read and summed only when some lane of the warp composites.
// - The next batch is prefetched. While the block composites batch k from
//   one half of a double-buffered shared array, each thread holds in
//   registers the attribute row of its pair of batch k + 1 (its Gaussian
//   id was loaded a batch earlier still) and stores it, padded to 16
//   floats (20 for the 12-channel payload of `variational: latents`) and
//   read back as float4, into the other half: one barrier per batch of 64
//   pairs.
//
// Every operation that decides or accumulates (power, alpha, weight,
// channel sums, the T update and the T < 1e-4 test) is rounded explicitly
// (no FMA contraction), in the same order as the plain PyTorch version,
// composite_forward_reference, so the two make the same alpha-threshold
// and early-stop decisions and `last` agrees exactly. The expected-depth
// channel reaches tens, where contracted channel sums would eat into the
// 1e-5 tolerance.
//
// The fast family (FAST, and COEF on top of it) reproduces the values of
// the TPU kernel's `fast` and `coef` switches (_mm(fast=True) and
// _chunk_alpha_coef, pallas_kernels.py:116-187, 356-369), not its
// matmuls. Knobs, chosen at run time in a FAST instantiation:
// - f16_xy: when a pair is staged, its mean is rounded to float16 relative
//   to the tile's origin and moved back (the footprint box is computed
//   from the rounded row, so the cull stays exact for it).
// - bf16_mm: the compositor runs in log space. Each pixel keeps log T at
//   the start of the current SCAN_BLOCK-block of pair positions (128,
//   aligned in the tile-sorted pair array, as the TPU's block-partitioned
//   scan was) and the block's float32 and bfloat16 sums of
//   log1p(-alpha); a pair's weight is alpha exp(lt + bf16 sum), rounded to
//   bfloat16 like its channels (rounded when staged), and the channel sum
//   of their products is float32. A pixel stops once lt + float32 sum <
//   log(1e-4). When a pixel leaves a block it composited in, it writes
//   (lt, bf16 sum) to the block state, from which the backward recovers
//   the same transmittances.
// - COEF (serving): staging replaces the row's geometry by the six
//   quadratic coefficients of power + log(opacity) over the tile-relative
//   pixel basis [px^2, px, py^2, py, px py, 1], built from the rounded row
//   in the JAX package's order of operations, so a pair's alpha is one
//   5-term dot product and an expf; as on the TPU there is no power > 0
//   guard. COEF implies f16_xy and bf16_mm.
// Those paths are rounded explicitly too, in the plain version's order.
//
// One launch composites a pass: the N (scene, view) items of a render
// call, whose tiles are numbered n T + t (T = one view's tile count) and
// whose pairs form one tile-sorted array. A block splits its tile id into
// (item n, local tile t), composites at the pixel coordinates of item n's
// own view (coordinates of a stacked image would lose bits in
// pixel - mean) and writes item n's planes of the (N, NCH, H, W) channels
// and (N, H, W) transmittance and `last`. Under bf16_mm the scan blocks
// are counted from the item's first pair (tile_ranges[n T]), so each
// item's values are those of a launch over that item alone.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kQuarter = 8;    // a block's pixels: one 8x8 quarter of a tile
constexpr int kWarpRows = 4;   // a warp's pixels: 4 rows x 8 columns
constexpr int kWarps = kQuarter / kWarpRows;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = kThreads;  // pairs staged per batch, one per thread
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaThreshold = static_cast<float>(1.0 / 255.0);
constexpr float kTransmittanceMin = 1e-4f;
// A conic with det <= kDetMin * a * c is treated as not positive definite
// (no cull): the camera clamps |rho| <= 0.99 (det >= 0.0199 a c), and
// nearer to degenerate the rounding of power could outgrow the box margins.
constexpr float kDetMin = 1e-3f;
constexpr unsigned kFull = 0xffffffffu;
// The fast family's scan block (pallas_kernels.py SCAN_BLOCK) and
// float32(log(1e-4)), its stop test in log space.
constexpr int kScanBlock = 128;
constexpr float kLogTransmittanceMin = -0x1.26bb1cp+3f;
// Knob bits of composite_forward_fast (kernels.py _knob_bits).
constexpr int kF16Xy = 1;
constexpr int kBf16Mm = 2;

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float f16_round(float x) { return __half2float(__float2half_rn(x)); }

// Floats per staged row: 16, or the row rounded up to whole float4s.
template <int NCH>
constexpr int kRow = 6 + NCH <= 16 ? 16 : (6 + NCH + 3) / 4 * 4;

// The box [x0, x1] x [y0, y1] outside which the forward's alpha test fails
// at every pixel: for a positive-definite conic (a, b, c),
// -power >= dx^2 det / (2c) and -power >= dy^2 det / (2a), and alpha needs
// -power <= log(255 opacity). Widened by 1e-3 relative and 0.05 px; empty
// when opacity < 1/255 (alpha <= opacity), unbounded when the conic is not
// positive definite. kernels.py::footprint_box_reference is the same box.
__device__ __forceinline__ float4 footprint_box(float x, float y, float ca, float cb, float cc,
                                                float opacity) {
  if (!(opacity >= kAlphaThreshold)) return make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  const float det = ca * cc - cb * cb;
  if (!(ca > 0.0f && cc > 0.0f && det > kDetMin * (ca * cc))) {
    return make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  }
  const float tau = logf(255.0f * opacity) * 1.001f + 1e-3f;
  const float hx = sqrtf(2.0f * tau * cc / det) * 1.001f + 0.05f;
  const float hy = sqrtf(2.0f * tau * ca / det) * 1.001f + 0.05f;
  return make_float4(x - hx, x + hx, y - hy, y + hy);
}

// Bit w set: the pair's footprint box meets warp w's pixels, rows
// y0 + 4w .. y0 + 4w + 3 and columns x0 .. x0 + 7 of a quarter.
template <int N>
__device__ __forceinline__ uint32_t warp_bits(const float (&a)[N], int x0, int y0) {
  const float4 box = footprint_box(a[0], a[1], a[2], a[3], a[4], a[5]);
  const float fx0 = static_cast<float>(x0);
  if (!(box.x <= fx0 + (kQuarter - 1) && box.y >= fx0)) return 0u;
  uint32_t bits = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float by = static_cast<float>(y0 + w * kWarpRows);
    bits |= static_cast<uint32_t>(box.z <= by + (kWarpRows - 1) && box.w >= by) << w;
  }
  return bits;
}

// The forward's alpha test of one (pair, pixel), rounded as the plain
// version rounds it. Power > 0 or alpha < 1/255 fails.
struct Hit {
  float alpha;
  bool pass;
};

__device__ __forceinline__ Hit alpha_test(const float4& q0, const float4& q1, float fx, float fy) {
  const float dx = __fsub_rn(fx, q0.x);
  const float dy = __fsub_rn(fy, q0.y);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(q0.z, dx), dx),
                               __fmul_rn(__fmul_rn(q1.x, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(q0.w, dx), dy));
  const float alpha = fminf(kAlphaClamp, __fmul_rn(q1.y, expf(power)));
  return {alpha, power <= 0.0f && alpha >= kAlphaThreshold};
}

// The coefficient layout's alpha test: c . basis summed left to right,
// then min(0.99, expf); no power > 0 guard.
__device__ __forceinline__ Hit alpha_test_coef(const float4& q0, const float4& q1, const float (&basis)[5]) {
  float p = __fmul_rn(q0.x, basis[0]);
  p = __fadd_rn(p, __fmul_rn(q0.y, basis[1]));
  p = __fadd_rn(p, __fmul_rn(q0.z, basis[2]));
  p = __fadd_rn(p, __fmul_rn(q0.w, basis[3]));
  p = __fadd_rn(p, __fmul_rn(q1.x, basis[4]));
  p = __fadd_rn(p, q1.y);
  const float alpha = fminf(kAlphaClamp, expf(p));
  return {alpha, alpha >= kAlphaThreshold};
}

// The fast family's staging of one attribute row in place: f16_xy's
// rounded mean (tile origin ox, oy), the footprint bits from the rounded
// row, bf16_mm's bfloat16 channels and COEF's coefficients. Returns the
// warp bits.
template <int N, bool COEF>
__device__ __forceinline__ uint32_t prepare_fast(float (&a)[N], float ox, float oy, bool f16_xy, bool bf16_mm,
                                                 int x0, int y0) {
  float xr = __fsub_rn(a[0], ox), yr = __fsub_rn(a[1], oy);
  if (f16_xy) {
    xr = f16_round(xr);
    yr = f16_round(yr);
    a[0] = __fadd_rn(xr, ox);
    a[1] = __fadd_rn(yr, oy);
  }
  const uint32_t bits = warp_bits(a, x0, y0);
  if (bf16_mm) {
#pragma unroll
    for (int c = 6; c < N; ++c) a[c] = bf16_round(a[c]);   // the padding stays 0
  }
  if constexpr (COEF) {
    const float ca = a[2], cb = a[3], cc = a[4];
    const float log_op = logf(fmaxf(a[5], 1e-12f));
    const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, xr), xr), __fmul_rn(__fmul_rn(cc, yr), yr));
    a[0] = __fmul_rn(-0.5f, ca);
    a[1] = __fadd_rn(__fmul_rn(ca, xr), __fmul_rn(cb, yr));
    a[2] = __fmul_rn(-0.5f, cc);
    a[3] = __fadd_rn(__fmul_rn(cc, yr), __fmul_rn(cb, xr));
    a[4] = -cb;
    a[5] = __fsub_rn(__fsub_rn(log_op, __fmul_rn(0.5f, quad)), __fmul_rn(__fmul_rn(cb, xr), yr));
  }
  return bits;
}

// A pixel's log-space state under bf16_mm: log T at the current block's
// start, the block's float32 and bfloat16 sums of log1p(-alpha), and the
// block's index (-1 before the first composited pair).
struct LogState {
  float lt = 0.0f, sum32 = 0.0f, sum16 = 0.0f;
  int block = -1;
};

// Adds one pair (staged row `row`, position pos in its item) at alpha under bf16_mm;
// on leaving a block, writes its (lt, bf16 sum) to `state` (if not null)
// at state_base + block * 256, the pixel's entry of the block's row.
// Returns whether the pixel stops.
template <int NCH>
__device__ __forceinline__ bool composite_log(const float4 (&row)[kRow<NCH> / 4], float alpha, int pos,
                                              LogState& s, float (&acc)[NCH], float2* state,
                                              int64_t state_base) {
  float a[kRow<NCH>];
#pragma unroll
  for (int i = 0; i < kRow<NCH> / 4; ++i) {
    a[4 * i] = row[i].x;
    a[4 * i + 1] = row[i].y;
    a[4 * i + 2] = row[i].z;
    a[4 * i + 3] = row[i].w;
  }
  const int block = pos / kScanBlock;
  if (block != s.block) {
    if (state != nullptr && s.block >= 0) {
      state[state_base + static_cast<int64_t>(s.block) * (kTile * kTile)] = make_float2(s.lt, s.sum16);
    }
    s.lt = __fadd_rn(s.lt, s.sum32);
    s.sum32 = 0.0f;
    s.sum16 = 0.0f;
    s.block = block;
  }
  const float la = log1pf(-alpha);
  const float weight = bf16_round(__fmul_rn(alpha, expf(__fadd_rn(s.lt, s.sum16))));
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(a[6 + c], weight));
  s.sum32 = __fadd_rn(s.sum32, la);
  s.sum16 = __fadd_rn(s.sum16, bf16_round(la));
  return __fadd_rn(s.lt, s.sum32) < kLogTransmittanceMin;
}

// Adds one pair (staged row `row`) at alpha to the pixel's channels and
// transmittance.
template <int NCH>
__device__ __forceinline__ void composite(const float4 (&row)[kRow<NCH> / 4], float alpha, float& t,
                                          float (&acc)[NCH]) {
  float a[kRow<NCH>];
#pragma unroll
  for (int i = 0; i < kRow<NCH> / 4; ++i) {
    a[4 * i] = row[i].x;
    a[4 * i + 1] = row[i].y;
    a[4 * i + 2] = row[i].z;
    a[4 * i + 3] = row[i].w;
  }
  const float weight = __fmul_rn(alpha, t);
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(a[6 + c], weight));
  t = __fmul_rn(t, __fsub_rn(1.0f, alpha));
}

template <int NCH, bool FAST, bool COEF>
__global__ void __launch_bounds__(kThreads, 512 / kThreads) composite_forward_kernel(
    const int32_t* __restrict__ gids,         // (P,) depth-sorted within each tile
    const int32_t* __restrict__ tile_ranges,  // (N T + 1,) pair range of each tile of the pass
    const float* __restrict__ attrs,          // (N G, 6 + NCH): x, y, a, b, c, opacity, channels
    int num_tiles, int tiles_x, int height, int width,   // num_tiles: T, one view's
    float* __restrict__ out_channels,         // (N, NCH, H, W)
    float* __restrict__ out_transmittance,    // (N, H, W)
    int32_t* __restrict__ out_last,           // (N, H, W) exclusive end of contributing pairs
    int knobs,                                // FAST: kF16Xy | kBf16Mm
    const int32_t* __restrict__ block_offsets,  // FAST, bf16_mm: (N T,) first state row of each tile
    float2* __restrict__ block_state) {       // FAST, bf16_mm: (B, 256) or null
  static_assert(FAST || !COEF, "the coefficient layout is a fast-family variant");
  constexpr int kStride = 6 + NCH;
  constexpr int kPad = kRow<NCH>;
  constexpr int kAcross = kTile / kQuarter;
  static_assert(kStride <= kPad, "a staged row holds the whole attribute row");
  __shared__ float4 s_row[2][kBatch][kPad / 4];
  __shared__ uint32_t s_bits[2][kBatch];

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int item_tile = static_cast<int>(blockIdx.x) / (kAcross * kAcross);
  const int quarter = static_cast<int>(blockIdx.x) % (kAcross * kAcross);
  const int item = item_tile / num_tiles;
  const int tile = item_tile - item * num_tiles;
  const int tx0 = (tile % tiles_x) * kTile;
  const int ty0 = (tile / tiles_x) * kTile;
  const int x0 = tx0 + (quarter % kAcross) * kQuarter;
  const int y0 = ty0 + (quarter / kAcross) * kQuarter;
  const int px = x0 + lane % kQuarter;
  const int py = y0 + warp * kWarpRows + lane / kQuarter;
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const int start = tile_ranges[item_tile];
  const int end = tile_ranges[item_tile + 1];
  const bool f16_xy = COEF || (FAST && (knobs & kF16Xy));
  const bool bf16_mm = COEF || (FAST && (knobs & kBf16Mm));
  // COEF: this pixel's tile-relative basis [px^2, px, py^2, py, px py].
  const float rx = static_cast<float>(px - tx0), ry = static_cast<float>(py - ty0);
  const float basis[5] = {rx * rx, rx, ry * ry, ry, rx * ry};
  // bf16_mm: the item's first pair, from which scan blocks are counted,
  // and this pixel's entries of the block state.
  const int item_first = bf16_mm ? tile_ranges[item * num_tiles] : 0;
  float2* const state = bf16_mm ? block_state : nullptr;
  const int64_t state_base =
      state != nullptr
          ? (static_cast<int64_t>(block_offsets[item_tile]) - (start - item_first) / kScanBlock) * (kTile * kTile) +
                (py - ty0) * kTile + (px - tx0)
          : 0;

  // Stages the row `a` of pair `batch + tid` into half `buf`.
  auto stage = [&](float (&a)[kPad], int buf) {
    uint32_t bits;
    if constexpr (FAST) {
      bits = prepare_fast<kPad, COEF>(a, static_cast<float>(tx0), static_cast<float>(ty0), f16_xy, bf16_mm, x0, y0);
    } else {
      bits = warp_bits(a, x0, y0);
    }
#pragma unroll
    for (int i = 0; i < kPad / 4; ++i) {
      s_row[buf][tid][i] = make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
    }
    s_bits[buf][tid] = bits;
  };
  auto load = [&](int gid, float (&a)[kPad]) {
    const float* src = attrs + static_cast<int64_t>(gid) * kStride;
#pragma unroll
    for (int r = 0; r < kPad; ++r) a[r] = r < kStride ? __ldg(src + r) : 0.0f;
  };
  auto test = [&](const float4& q0, const float4& q1) {
    if constexpr (COEF) {
      return alpha_test_coef(q0, q1, basis);
    } else {
      return alpha_test(q0, q1, fx, fy);
    }
  };

  float t = 1.0f;
  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  LogState ls;
  int last = start;
  bool done = false;
  bool warp_done = false;
  // Adds the pair at position pos (staged row `row`) at alpha.
  auto add = [&](const float4 (&row)[kPad / 4], float alpha, int pos) {
    if (FAST && bf16_mm) {
      done = composite_log<NCH>(row, alpha, pos - item_first, ls, acc, state, state_base);
    } else {
      composite<NCH>(row, alpha, t, acc);
      done = t < kTransmittanceMin;
    }
    last = pos + 1;
  };

  if (start + tid < end) {
    float a[kPad];
    load(gids[start + tid], a);
    stage(a, 0);
  }
  int gid = start + kBatch + tid < end ? gids[start + kBatch + tid] : 0;
  __syncthreads();

  int buf = 0;
  for (int batch = start; batch < end; batch += kBatch, buf ^= 1) {
    // This thread's pair of the next batch: its row is loaded now and
    // stored after the walk; the id after it is loaded a batch ahead.
    const int next = batch + kBatch + tid;
    float a[kPad];
    if (next < end) load(gid, a);
    if (next + kBatch < end) gid = gids[next + kBatch];

    const int n = min(kBatch, end - batch);
    for (int c0 = 0; c0 < n && !warp_done; c0 += 32) {
      uint32_t kept = __ballot_sync(kFull, c0 + lane < n && ((s_bits[buf][c0 + lane] >> warp) & 1u));
      while (kept != 0u) {
        const int ja = c0 + __ffs(kept) - 1;
        kept &= kept - 1u;
        const bool has_b = kept != 0u;
        const int jb = has_b ? c0 + __ffs(kept) - 1 : ja;
        kept &= kept - 1u;
        float4 ra[kPad / 4], rb[kPad / 4];
        ra[0] = s_row[buf][ja][0];
        ra[1] = s_row[buf][ja][1];
        rb[0] = s_row[buf][jb][0];
        rb[1] = s_row[buf][jb][1];
        const Hit ha = test(ra[0], ra[1]);
        const Hit hb = test(rb[0], rb[1]);
        if (__any_sync(kFull, !done && (ha.pass || (has_b && hb.pass)))) {
#pragma unroll
          for (int i = 2; i < kPad / 4; ++i) {
            ra[i] = s_row[buf][ja][i];
            rb[i] = s_row[buf][jb][i];
          }
          if (!done && ha.pass) add(ra, ha.alpha, batch + ja);
          if (!done && has_b && hb.pass) add(rb, hb.alpha, batch + jb);
          if (__all_sync(kFull, done)) {
            warp_done = true;
            break;
          }
        }
      }
    }

    if (next < end) stage(a, buf ^ 1);
    if (__syncthreads_count(done) == kThreads) break;
  }

  if (FAST && bf16_mm) {
    if (state != nullptr && ls.block >= 0) {
      state[state_base + static_cast<int64_t>(ls.block) * (kTile * kTile)] = make_float2(ls.lt, ls.sum16);
    }
    t = expf(__fadd_rn(ls.lt, ls.sum32));
  }
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t pixel = item * plane + py * width + px;
  float* const channels = out_channels + static_cast<int64_t>(item) * NCH * plane + (py * width + px);
#pragma unroll
  for (int c = 0; c < NCH; ++c) channels[c * plane] = acc[c];
  out_transmittance[pixel] = t;
  out_last[pixel] = last;
}

template <int NCH, bool FAST, bool COEF>
void launch(int items, int num_tiles, const void* gids, const void* tile_ranges, const void* attrs,
            int tiles_x, int height, int width, void* channels, void* transmittance,
            void* last, int knobs, const void* block_offsets, void* block_state, cudaStream_t stream) {
  constexpr int kQuarters = (kTile / kQuarter) * (kTile / kQuarter);
  composite_forward_kernel<NCH, FAST, COEF><<<items * num_tiles * kQuarters, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(gids), static_cast<const int32_t*>(tile_ranges),
      static_cast<const float*>(attrs), num_tiles, tiles_x, height, width,
      static_cast<float*>(channels), static_cast<float*>(transmittance),
      static_cast<int32_t*>(last), knobs, static_cast<const int32_t*>(block_offsets),
      static_cast<float2*>(block_state));
}

}  // namespace

// Channel counts the kernel is instantiated for (payload + expected depth):
// 12 = 3 color + 4 latent means + 4 latent logvars + depth (`variational:
// latents`), 8 = 3 color + 4 latent features + depth (the flagship),
// 5 = 4 + depth, 4 = the 3-channel depth payload of render_depth + depth.
extern "C" int composite_forward_channels(int index) {
  constexpr int kChannels[] = {4, 5, 8, 12};
  return index < static_cast<int>(sizeof(kChannels) / sizeof(int)) ? kChannels[index] : -1;
}

// A pass of `items` views of num_tiles tiles each (see the header).
extern "C" int composite_forward(
    int n_channels, int items, int num_tiles, const void* gids, const void* tile_ranges,
    const void* attrs, int tiles_x, int height, int width, void* channels,
    void* transmittance, void* last, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items > 0 && num_tiles > 0) {
    switch (n_channels) {
      case 4:
        launch<4, false, false>(items, num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, channels,
                                transmittance, last, 0, nullptr, nullptr, s);
        break;
      case 5:
        launch<5, false, false>(items, num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, channels,
                                transmittance, last, 0, nullptr, nullptr, s);
        break;
      case 8:
        launch<8, false, false>(items, num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, channels,
                                transmittance, last, 0, nullptr, nullptr, s);
        break;
      case 12:
        launch<12, false, false>(items, num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, channels,
                                 transmittance, last, 0, nullptr, nullptr, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Channel counts of the fast family, in both composite kernels: those the
// splatting decoder composites (5 = 4 latent features + depth, when it
// renders no color; 8; 12). render_depth's 4 renders exact only.
extern "C" int composite_fast_channels(int index) {
  constexpr int kChannels[] = {5, 8, 12};
  return index < static_cast<int>(sizeof(kChannels) / sizeof(int)) ? kChannels[index] : -1;
}

// The fast family: coef != 0 launches the coefficient layout (f16_xy and
// bf16_mm implied), else `knobs` (kF16Xy | kBf16Mm) selects. Under bf16_mm,
// block_state (with block_offsets) receives the backward's per-block
// state, or is null when no backward follows.
extern "C" int composite_forward_fast(
    int n_channels, int coef, int knobs, int items, int num_tiles, const void* gids, const void* tile_ranges,
    const void* attrs, int tiles_x, int height, int width, void* channels, void* transmittance,
    void* last, const void* block_offsets, void* block_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items > 0 && num_tiles > 0) {
#define LAUNCH_FAST(N)                                                                              \
  (coef ? launch<N, true, true>(items, num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, channels, \
                                transmittance, last, knobs, block_offsets, block_state, s)            \
        : launch<N, true, false>(items, num_tiles, gids, tile_ranges, attrs, tiles_x, height, width, channels, \
                                 transmittance, last, knobs, block_offsets, block_state, s))
    switch (n_channels) {
      case 5:
        LAUNCH_FAST(5);
        break;
      case 8:
        LAUNCH_FAST(8);
        break;
      case 12:
        LAUNCH_FAST(12);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LAUNCH_FAST
  }
  return static_cast<int>(cudaGetLastError());
}
