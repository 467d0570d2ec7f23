// group_norm_silu: group normalisation of a channels-last (NHWC) float32
// or bfloat16 tensor, with SiLU after it where asked, forward and backward.
// A bfloat16 tensor is read and written in bfloat16 and every sum,
// statistic and product is float32, as for a float32 one; gamma and beta
// are float32 (the wrapper converts them).
//
// Replaces no TPU kernel: the JAX package's VAE (latentsplat_tpu/model/
// autoencoder/kl.py) leaves GroupNorm + SiLU to XLA, which fuses them. The
// port's plain version (ops/group_norm.py::group_norm_silu_reference) is
// nn.GroupNorm then F.silu: on the card, PyTorch's group norm takes NCHW
// only, so around every norm of a channels-last network it copied the
// tensor to NCHW and back, and the SiLU was a pass of its own.
//
// Bound: memory. The VAE decoder's largest norms run over 30 x 256 x 256
// x 128-256 floats (1-2 GB). The forward makes three passes: statistics
// (read x), a tiny merge, and the normalisation (read x, write y). The
// backward makes five: per-channel sums (read x and dy), a tiny merge, and
// dx (read x and dy, write dx). The normalised tensor is never stored: the
// backward recomputes it from x and the (sample, group) statistics.
//
// Layout. A (sample, row) is one pixel's C channels, contiguous; a thread
// owns VEC = 4 channels (one 16-byte float4 or 8-byte load of four
// bfloat16; 1 when C % 4 or an address forbids it)
// at a fixed column of the row, and a block of 256 threads covers 256 / (C
// / VEC) rows a step (one row of up to 1024 threads when C / VEC > 256).
// Neighbouring threads read neighbouring addresses: every load is
// coalesced. The grid is (chunks, N): block (k, n) walks rows k P .. k P +
// P - 1 of sample n (P = ceil(HW / chunks)), four rows a thread in flight.
//
// Statistics. Each thread keeps a Welford mean and M2 a channel over its
// rows (one reciprocal a row for its VEC channels); the block merges its
// rows' states with Chan's formula in shared memory, then each group's D =
// C / groups channels, and writes (count, mean, M2) a (sample, chunk,
// group). One warp a (sample, group) merges the chunks the same way, and
// gives mean and rstd = 1 / sqrt(M2 / count + eps). A group whose values
// are all equal gets its value as the mean exactly and M2 = 0 (every delta
// is 0), so it normalises to beta exactly. The forward writes y = (x -
// mean) (rstd gamma) + beta, then y / (1 + exp(-y)) with SiLU.
//
// Backward. With xh = (x - mean) rstd and g the upstream gradient times
// SiLU's derivative at y (or the gradient itself without SiLU), each block
// sums g xh and g a channel over its rows (written a (sample, chunk,
// channel)); one block a sample adds the chunks into S1 = sum g xh and S2 =
// sum g a (sample, channel), which the wrapper sums over samples into
// dgamma and dbeta, and forms each group's A = sum gamma S1 and B = sum
// gamma S2. Then dx = rstd gamma g - rstd B / M - xh rstd A / M (M = HW D).
//
// Shift. Where the wrapper passes a per-channel shift (the bias of the
// convolution that wrote x, which the VAE runs without it), every pass
// reads x + shift in registers in place of x: the float32 sum, rounded to
// bfloat16 for a bfloat16 x, as PyTorch's `add_` of the bias rounds it, so
// the norm sees the bits it saw when the bias was added in a pass of its
// own. The backward keeps the unshifted x and shifts it again; dx is the
// gradient of the shifted value too, and the shift's is its per-channel
// sum (the wrapper's).
//
// Any (N, H, W, C) with C divisible by `groups` and C / VEC <= 1024; the
// kernels allocate nothing (the wrapper passes the scratch) and launch on
// the given stream.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;

struct Stat {
  float n, mean, m2;
};

// Chan et al.'s merge of two (count, mean, M2) states; an empty side
// leaves the other as it is.
__device__ __forceinline__ Stat chan(Stat a, Stat b) {
  if (b.n == 0.0f) return a;
  if (a.n == 0.0f) return b;
  const float n = a.n + b.n;
  const float f = b.n / n;
  const float d = b.mean - a.mean;
  return {n, fmaf(d, f, a.mean), a.m2 + b.m2 + d * d * a.n * f};
}

using bf16 = __nv_bfloat16;

// VEC values of T at p, as float32: one float4, or one 8-byte load of
// four bfloat16, or one value.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else if constexpr (std::is_same_v<T, float>) {
    v[0] = *p;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// VEC float32 values written to p as T (bfloat16 rounded to nearest).
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&a);
    t.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else if constexpr (std::is_same_v<T, float>) {
    *p = v[0];
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// A float32 result as T stores it: bfloat16's rounding, float32 as it is.
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// The thread's VEC channels of the shift (none where `shift` is null),
// added to each x it loads.
template <typename T, int VEC>
struct Shift {
  bool on;
  float s[VEC];

  __device__ __forceinline__ Shift(const float* shift, int col) : on(shift != nullptr) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) s[i] = on ? shift[col * VEC + i] : 0.0f;
  }

  __device__ __forceinline__ void apply(float (&v)[VEC]) const {
    if (!on) return;
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = rounded<T>(v[i] + s[i]);
  }
};

__device__ __forceinline__ float sigmoid(float y) { return 1.0f / (1.0f + expf(-y)); }

// A thread's place in its block: `col` of the row's `cols` vectors, `row`
// of the `rows` rows a step; threads past rows x cols idle.
struct Place {
  int cols, rows, col, row;
  bool active;
};

template <int VEC>
__device__ __forceinline__ Place place(int c) {
  const int cols = c / VEC;
  const int rows = max(1, static_cast<int>(blockDim.x) / cols);
  const int t = threadIdx.x;
  return {cols, rows, t % cols, t / cols, t / cols < rows};
}

__device__ __forceinline__ int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Per channel of the thread's vector: the group's mean and rstd, rstd
// gamma and beta.
template <int VEC>
struct Coefs {
  float mean[VEC], rstd[VEC], scale[VEC], beta[VEC];
};

template <int VEC>
__device__ __forceinline__ Coefs<VEC> coefs(int n, int c, int groups, int col, const float* mean,
                                            const float* rstd, const float* gamma, const float* beta) {
  Coefs<VEC> k;
  const int d = c / groups;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int ch = col * VEC + i;
    const int g = n * groups + ch / d;
    k.mean[i] = mean[g];
    k.rstd[i] = rstd[g];
    k.scale[i] = rstd[g] * gamma[ch];
    k.beta[i] = beta[ch];
  }
  return k;
}

// ---- forward -----------------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void welford(const float (&v)[VEC], float& count, float (&mean)[VEC], float (&m2)[VEC]) {
  count += 1.0f;
  const float inv = 1.0f / count;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float d = v[i] - mean[i];
    mean[i] = fmaf(d, inv, mean[i]);
    m2[i] = fmaf(d, v[i] - mean[i], m2[i]);
  }
}

// partials: (N, chunks, groups, 3) float (count, mean, M2).
template <typename T, int VEC, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
    stats_kernel(int hw, int c, int groups, int per_chunk, const T* __restrict__ x, const float* __restrict__ shift,
                 float* __restrict__ partials) {
  extern __shared__ float smem[];
  const Place p = place<VEC>(c);
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * per_chunk, r1 = min(hw, r0 + per_chunk);
  float count = 0.0f, mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.0f;
  if (p.active) {
    const Shift<T, VEC> sh(shift, p.col);
    const T* base = x + static_cast<size_t>(n) * hw * c + p.col * VEC;
    int r = r0 + p.row;
    for (; r + (kUnroll - 1) * p.rows < r1; r += kUnroll * p.rows) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<T, VEC>(base + static_cast<size_t>(r + u * p.rows) * c, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sh.apply(v[u]);
        welford<VEC>(v[u], count, mean, m2);
      }
    }
    for (; r < r1; r += p.rows) {
      float v[VEC];
      load<T, VEC>(base + static_cast<size_t>(r) * c, v);
      sh.apply(v);
      welford<VEC>(v, count, mean, m2);
    }
  }
  const int t = threadIdx.x;
  float* s_n = smem;
  float* s_mean = s_n + blockDim.x;
  float* s_m2 = s_mean + blockDim.x * VEC;
  s_n[t] = count;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s_mean[t * VEC + i] = mean[i];
    s_m2[t * VEC + i] = m2[i];
  }
  __syncthreads();
  for (int s = next_pow2(p.rows) / 2; s > 0; s >>= 1) {
    if (p.active && p.row < s && p.row + s < p.rows) {
      const int o = t + s * p.cols;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const Stat m = chan({s_n[t], s_mean[t * VEC + i], s_m2[t * VEC + i]},
                            {s_n[o], s_mean[o * VEC + i], s_m2[o * VEC + i]});
        s_mean[t * VEC + i] = m.mean;
        s_m2[t * VEC + i] = m.m2;
      }
      s_n[t] += s_n[o];
    }
    __syncthreads();
  }
  // Row 0's threads hold the columns' states: channel ch at s_mean[ch].
  const int d = c / groups;
  for (int g = t; g < groups; g += blockDim.x) {
    Stat acc{0.0f, 0.0f, 0.0f};
    for (int ch = g * d; ch < g * d + d; ++ch) acc = chan(acc, {s_n[ch / VEC], s_mean[ch], s_m2[ch]});
    float* out = partials + ((static_cast<size_t>(n) * gridDim.x + chunk) * groups + g) * 3;
    out[0] = acc.n;
    out[1] = acc.mean;
    out[2] = acc.m2;
  }
}

// One warp a (sample, group): mean and rstd (N, groups).
__global__ void stats_merge_kernel(int chunks, int groups, float eps, const float* __restrict__ partials,
                                   float* __restrict__ mean, float* __restrict__ rstd) {
  const int n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int g = warp; g < groups; g += warps) {
    Stat acc{0.0f, 0.0f, 0.0f};
    for (int k = lane; k < chunks; k += 32) {
      const float* q = partials + ((static_cast<size_t>(n) * chunks + k) * groups + g) * 3;
      acc = chan(acc, {q[0], q[1], q[2]});
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Stat o{__shfl_down_sync(0xffffffffu, acc.n, off), __shfl_down_sync(0xffffffffu, acc.mean, off),
                   __shfl_down_sync(0xffffffffu, acc.m2, off)};
      acc = chan(acc, o);
    }
    if (lane == 0) {
      mean[n * groups + g] = acc.mean;
      rstd[n * groups + g] = 1.0f / sqrtf(fmaxf(acc.m2 / acc.n, 0.0f) + eps);
    }
  }
}

template <typename T, int VEC, bool SILU, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
    normalize_kernel(int hw, int c, int groups, int per_chunk, const T* __restrict__ x,
                     const float* __restrict__ shift, const float* __restrict__ mean, const float* __restrict__ rstd, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y) {
  const Place p = place<VEC>(c);
  if (!p.active) return;
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * per_chunk, r1 = min(hw, r0 + per_chunk);
  const Coefs<VEC> k = coefs<VEC>(n, c, groups, p.col, mean, rstd, gamma, beta);
  const Shift<T, VEC> sh(shift, p.col);
  const size_t offset = static_cast<size_t>(n) * hw * c + p.col * VEC;
  auto apply = [&](float (&v)[VEC]) {
    sh.apply(v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float o = fmaf(v[i] - k.mean[i], k.scale[i], k.beta[i]);
      v[i] = SILU ? o / (1.0f + expf(-o)) : o;
    }
  };
  int r = r0 + p.row;
  for (; r + (kUnroll - 1) * p.rows < r1; r += kUnroll * p.rows) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<T, VEC>(x + offset + static_cast<size_t>(r + u * p.rows) * c, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      apply(v[u]);
      store<T, VEC>(y + offset + static_cast<size_t>(r + u * p.rows) * c, v[u]);
    }
  }
  for (; r < r1; r += p.rows) {
    float v[VEC];
    load<T, VEC>(x + offset + static_cast<size_t>(r) * c, v);
    apply(v);
    store<T, VEC>(y + offset + static_cast<size_t>(r) * c, v);
  }
}

// ---- backward ----------------------------------------------------------------

// The upstream gradient through SiLU at y = (x - mean) rstd gamma + beta,
// as the forward computed y; the gradient itself without SiLU.
template <bool SILU>
__device__ __forceinline__ float gate(float centered, float scale, float beta, float dy) {
  if (!SILU) return dy;
  const float y = fmaf(centered, scale, beta);
  const float s = sigmoid(y);
  return dy * s * (1.0f + y * (1.0f - s));
}

// partials: (N, chunks, 2, C) float, sum g xh and sum g a channel.
template <typename T, int VEC, bool SILU, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
    grad_sums_kernel(int hw, int c, int groups, int per_chunk, const T* __restrict__ x,
                     const float* __restrict__ shift, const T* __restrict__ dy, const float* __restrict__ mean, const float* __restrict__ rstd,
                     const float* __restrict__ gamma, const float* __restrict__ beta, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const Place p = place<VEC>(c);
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * per_chunk, r1 = min(hw, r0 + per_chunk);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.0f;
  if (p.active) {
    const Coefs<VEC> k = coefs<VEC>(n, c, groups, p.col, mean, rstd, gamma, beta);
    const Shift<T, VEC> sh(shift, p.col);
    const size_t offset = static_cast<size_t>(n) * hw * c + p.col * VEC;
    auto add = [&](float (&v)[VEC], const float (&w)[VEC]) {
      sh.apply(v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float centered = v[i] - k.mean[i];
        const float g = gate<SILU>(centered, k.scale[i], k.beta[i], w[i]);
        s1[i] = fmaf(g, centered * k.rstd[i], s1[i]);
        s2[i] += g;
      }
    };
    int r = r0 + p.row;
    for (; r + (kUnroll - 1) * p.rows < r1; r += kUnroll * p.rows) {
      float v[kUnroll][VEC], w[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t at = offset + static_cast<size_t>(r + u * p.rows) * c;
        load<T, VEC>(x + at, v[u]);
        load<T, VEC>(dy + at, w[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(v[u], w[u]);
    }
    for (; r < r1; r += p.rows) {
      float v[VEC], w[VEC];
      const size_t at = offset + static_cast<size_t>(r) * c;
      load<T, VEC>(x + at, v);
      load<T, VEC>(dy + at, w);
      add(v, w);
    }
  }
  const int t = threadIdx.x;
  float* a = smem;
  float* b = smem + blockDim.x * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[t * VEC + i] = s1[i];
    b[t * VEC + i] = s2[i];
  }
  __syncthreads();
  for (int s = next_pow2(p.rows) / 2; s > 0; s >>= 1) {
    if (p.active && p.row < s && p.row + s < p.rows) {
      const int o = t + s * p.cols;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        a[t * VEC + i] += a[o * VEC + i];
        b[t * VEC + i] += b[o * VEC + i];
      }
    }
    __syncthreads();
  }
  if (p.active && p.row == 0) {
    float* out = partials + (static_cast<size_t>(n) * gridDim.x + chunk) * 2 * c + p.col * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[i] = a[t * VEC + i];
      out[c + i] = b[t * VEC + i];
    }
  }
}

// One block a sample: sums (N, 2, C) = the chunks' partials added, and
// coef (N, groups, 2) = (-rstd B / M, -rstd A / M).
__global__ void grad_merge_kernel(int hw, int c, int groups, int chunks, const float* __restrict__ partials,
                                  const float* __restrict__ rstd, const float* __restrict__ gamma,
                                  float* __restrict__ sums, float* __restrict__ coef) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      const float* q = partials + (static_cast<size_t>(n) * chunks + k) * 2 * c;
      a += q[ch];
      b += q[c + ch];
    }
    smem[ch] = a;
    smem[c + ch] = b;
    sums[static_cast<size_t>(n) * 2 * c + ch] = a;
    sums[static_cast<size_t>(n) * 2 * c + c + ch] = b;
  }
  __syncthreads();
  const int d = c / groups;
  const float inv_m = 1.0f / (static_cast<float>(hw) * static_cast<float>(d));
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float a = 0.0f, b = 0.0f;
    for (int ch = g * d; ch < g * d + d; ++ch) {
      a = fmaf(gamma[ch], smem[ch], a);
      b = fmaf(gamma[ch], smem[c + ch], b);
    }
    const float r = rstd[n * groups + g];
    coef[(n * groups + g) * 2] = -r * b * inv_m;
    coef[(n * groups + g) * 2 + 1] = -r * a * inv_m;
  }
}

template <typename T, int VEC, bool SILU, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
    grad_input_kernel(int hw, int c, int groups, int per_chunk, const T* __restrict__ x,
                      const float* __restrict__ shift, const T* __restrict__ dy, const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ coef, T* __restrict__ dx) {
  const Place p = place<VEC>(c);
  if (!p.active) return;
  const int n = blockIdx.y;
  const int r0 = blockIdx.x * per_chunk, r1 = min(hw, r0 + per_chunk);
  const Coefs<VEC> k = coefs<VEC>(n, c, groups, p.col, mean, rstd, gamma, beta);
  float c0[VEC], c1[VEC];
  const int d = c / groups;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int g = n * groups + (p.col * VEC + i) / d;
    c0[i] = coef[g * 2];
    c1[i] = coef[g * 2 + 1];
  }
  const Shift<T, VEC> sh(shift, p.col);
  const size_t offset = static_cast<size_t>(n) * hw * c + p.col * VEC;
  auto grad = [&](float (&v)[VEC], const float (&w)[VEC]) {
    sh.apply(v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float centered = v[i] - k.mean[i];
      const float g = gate<SILU>(centered, k.scale[i], k.beta[i], w[i]);
      v[i] = fmaf(k.scale[i], g, fmaf(centered * k.rstd[i], c1[i], c0[i]));
    }
  };
  int r = r0 + p.row;
  for (; r + (kUnroll - 1) * p.rows < r1; r += kUnroll * p.rows) {
    float v[kUnroll][VEC], w[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t at = offset + static_cast<size_t>(r + u * p.rows) * c;
      load<T, VEC>(x + at, v[u]);
      load<T, VEC>(dy + at, w[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      grad(v[u], w[u]);
      store<T, VEC>(dx + offset + static_cast<size_t>(r + u * p.rows) * c, v[u]);
    }
  }
  for (; r < r1; r += p.rows) {
    float v[VEC], w[VEC];
    const size_t at = offset + static_cast<size_t>(r) * c;
    load<T, VEC>(x + at, v);
    load<T, VEC>(dy + at, w);
    grad(v, w);
    store<T, VEC>(dx + at, v);
  }
}

// ---- launchers ---------------------------------------------------------------

// A block's threads: 256, or one row of C / VEC vectors (rounded up to
// warps) when a row holds more. BLOCK, the kernels' launch bound, is 256
// or 1024 to match: compiled for 1024 threads a thread gets at most 64
// registers, which the four rows in flight would overflow.
int block_threads(int cols) { return cols <= kThreads ? kThreads : (cols + 31) / 32 * 32; }

template <typename T, int VEC, bool SILU, int BLOCK>
struct Forward {
  static void run(int n, int hw, int c, int groups, int chunks, float eps, const void* x, const float* shift,
                  const float* gamma, const float* beta, void* y, float* partials, float* mean, float* rstd,
                  cudaStream_t stream) {
    const int threads = block_threads(c / VEC);
    const dim3 grid(chunks, n);
    const int per_chunk = (hw + chunks - 1) / chunks;
    const size_t shared = static_cast<size_t>(threads) * (1 + 2 * VEC) * sizeof(float);
    stats_kernel<T, VEC, BLOCK><<<grid, threads, shared, stream>>>(hw, c, groups, per_chunk,
                                                                   static_cast<const T*>(x), shift, partials);
    stats_merge_kernel<<<n, 32 * (groups < 32 ? groups : 32), 0, stream>>>(chunks, groups, eps, partials, mean,
                                                                           rstd);
    normalize_kernel<T, VEC, SILU, BLOCK><<<grid, threads, 0, stream>>>(
        hw, c, groups, per_chunk, static_cast<const T*>(x), shift, mean, rstd, gamma, beta, static_cast<T*>(y));
  }
};

template <typename T, int VEC, bool SILU, int BLOCK>
struct Backward {
  static void run(int n, int hw, int c, int groups, int chunks, const void* x, const float* shift, const void* dy,
                  const float* mean, const float* rstd, const float* gamma, const float* beta, void* dx,
                  float* partials, float* sums, float* coef, cudaStream_t stream) {
    const int threads = block_threads(c / VEC);
    const dim3 grid(chunks, n);
    const int per_chunk = (hw + chunks - 1) / chunks;
    const size_t shared = static_cast<size_t>(threads) * 2 * VEC * sizeof(float);
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    grad_sums_kernel<T, VEC, SILU, BLOCK><<<grid, threads, shared, stream>>>(
        hw, c, groups, per_chunk, xt, shift, dyt, mean, rstd, gamma, beta, partials);
    grad_merge_kernel<<<n, kThreads, 2 * static_cast<size_t>(c) * sizeof(float), stream>>>(
        hw, c, groups, chunks, partials, rstd, gamma, sums, coef);
    grad_input_kernel<T, VEC, SILU, BLOCK><<<grid, threads, 0, stream>>>(
        hw, c, groups, per_chunk, xt, shift, dyt, mean, rstd, gamma, beta, coef, static_cast<T*>(dx));
  }
};

// The vector width: 4 where C and every address allow (4 values of
// `bytes` each), else 1; 0 for a shape the kernels do not take (C not
// divisible by groups, a row wider than 1024 vectors, more than 65535
// samples).
int vector_width(int n, int hw, int c, int groups, int chunks, int bytes,
                 std::initializer_list<const void*> pointers) {
  if (n < 1 || n > 65535 || hw < 1 || c < 1 || groups < 1 || chunks < 1 || c % groups != 0) return 0;
  if (2 * static_cast<size_t>(c) * sizeof(float) > 48 * 1024) return 0;
  bool aligned = c % 4 == 0;
  for (const void* p : pointers) aligned = aligned && reinterpret_cast<uintptr_t>(p) % (4 * bytes) == 0;
  const int vec = aligned ? 4 : 1;
  return c / vec <= kMaxThreads ? vec : 0;
}

// Calls F<T, VEC, SILU, BLOCK>::run for the launch's vector width, SiLU
// and block.
template <template <typename, int, bool, int> class F, typename T, typename... Args>
void dispatch_width(int vec, bool silu, int c, Args... args) {
  const bool wide = c / vec > kThreads;
  if (vec == 4) {
    if (silu) {
      wide ? F<T, 4, true, kMaxThreads>::run(args...) : F<T, 4, true, kThreads>::run(args...);
    } else {
      wide ? F<T, 4, false, kMaxThreads>::run(args...) : F<T, 4, false, kThreads>::run(args...);
    }
  } else if (silu) {
    wide ? F<T, 1, true, kMaxThreads>::run(args...) : F<T, 1, true, kThreads>::run(args...);
  } else {
    wide ? F<T, 1, false, kMaxThreads>::run(args...) : F<T, 1, false, kThreads>::run(args...);
  }
}

// The same, first choosing T: bfloat16 or float.
template <template <typename, int, bool, int> class F, typename... Args>
void dispatch(bool is_bf16, int vec, bool silu, int c, Args... args) {
  if (is_bf16) {
    dispatch_width<F, bf16>(vec, silu, c, args...);
  } else {
    dispatch_width<F, float>(vec, silu, c, args...);
  }
}

}  // namespace

// x and y (N, H, W, C) channels-last, float32 or (is_bf16) bfloat16, hw =
// H W; shift (C,) float32 or null; gamma and beta (C,) float32; partials (N, chunks, groups, 3)
// scratch; mean and rstd (N, groups) float32 out. Returns a CUDA error code
// (1, invalid value, for a shape it does not take).
extern "C" int group_norm_silu_forward(int n, int hw, int c, int groups, int chunks, float eps, int silu,
                                       int is_bf16, const void* x, const void* shift, const void* gamma,
                                       const void* beta, void* y, void* partials, void* mean, void* rstd,
                                       void* stream) {
  const int vec = vector_width(n, hw, c, groups, chunks, is_bf16 ? 2 : 4, {x, y});
  if (vec == 0) return static_cast<int>(cudaErrorInvalidValue);
  dispatch<Forward>(is_bf16 != 0, vec, silu != 0, c, n, hw, c, groups, chunks, eps, x,
                    static_cast<const float*>(shift), static_cast<const float*>(gamma), static_cast<const float*>(beta), y,
                    static_cast<float*>(partials), static_cast<float*>(mean), static_cast<float*>(rstd),
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// x, dy and dx (N, H, W, C) channels-last, float32 or (is_bf16) bfloat16;
// shift the forward's (or null); mean and rstd the forward's; gamma and
// beta float32; partials (N, chunks, 2, C) and coef (N, groups, 2)
// scratch; sums (N, 2, C) float32 out: per sample, sum g xh and sum g a channel (the wrapper sums them
// over N into dgamma and dbeta).
extern "C" int group_norm_silu_backward(int n, int hw, int c, int groups, int chunks, int silu, int is_bf16,
                                        const void* x, const void* shift, const void* dy, const void* mean,
                                        const void* rstd, const void* gamma, const void* beta, void* dx,
                                        void* partials, void* sums, void* coef, void* stream) {
  const int vec = vector_width(n, hw, c, groups, chunks, is_bf16 ? 2 : 4, {x, dy, dx});
  if (vec == 0) return static_cast<int>(cudaErrorInvalidValue);
  dispatch<Backward>(is_bf16 != 0, vec, silu != 0, c, n, hw, c, groups, chunks, x,
                     static_cast<const float*>(shift), dy,
                     static_cast<const float*>(mean), static_cast<const float*>(rstd),
                     static_cast<const float*>(gamma), static_cast<const float*>(beta), dx,
                     static_cast<float*>(partials), static_cast<float*>(sums), static_cast<float*>(coef),
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
