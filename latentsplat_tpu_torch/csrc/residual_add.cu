// residual_add: out = (a + bias_a) + (b + bias_b) over channels-last
// (N, H, W, C) float32 or bfloat16 tensors, each bias a per-channel
// float32 vector or absent, b absent too (out = a + bias_a).
//
// Replaces no TPU kernel: the JAX package's VAE (latentsplat_tpu/model/
// autoencoder/kl.py) leaves its convolutions' biases and its residual and
// skip sums to XLA, which fuses them. On the card, PyTorch's convolution
// writes cuDNN's output and then adds the bias in a pass of its own over
// the whole tensor, and each residual or skip sum is another. The VAE
// (model/autoencoder/kl.py) runs its convolutions without the bias and
// hands each bias to the kernel that reads the conv's output next: the
// group norm (csrc/group_norm_silu.cu, as a shift) or this sum.
//
// Rounding: the unfused ops' in their order. A biased operand is rounded
// as PyTorch's `add_` rounds it (float32: one IEEE add; bfloat16: the add
// in float32, rounded to bfloat16), then the sum is rounded, so the
// output has the bits of `(conv_a + bias_a) + (conv_b + bias_b)`.
//
// Bound: memory. The VAE decoder's largest sum reads two 30 x 256 x 256 x
// 128 float32 tensors and writes one (3.02 GB). A thread owns VEC
// channels of a row (16 bytes: four float32 or eight bfloat16; one value
// where C % VEC or an address forbids it) at a fixed column, so its
// biases sit in registers; neighbouring threads read neighbouring
// addresses. A block of 256 threads covers 256 / (C / VEC) rows a step
// (grid.y splits a row of more than 256 vectors), four rows a thread in
// flight, kRowsPerThread rows a thread in all.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kRowsPerThread = 8;

using bf16 = __nv_bfloat16;

// VEC values of T at p as float32: 16 bytes, or one value.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1 && std::is_same_v<T, float>) {
    v[0] = *p;
  } else if constexpr (VEC == 1) {
    v[0] = __bfloat162float(*p);
  } else if constexpr (std::is_same_v<T, float>) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const unsigned words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// VEC float32 values written to p as T (bfloat16 rounded to nearest).
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (std::is_same_v<T, float>) {
      *p = v[0];
    } else {
      *p = __float2bfloat16_rn(v[0]);
    }
  } else if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    unsigned words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      words[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    residual_add_kernel(int rows, int c, const T* __restrict__ a, const float* __restrict__ bias_a,
                        const T* __restrict__ b, const float* __restrict__ bias_b, T* __restrict__ out) {
  const int cols = c / VEC;
  const int t = threadIdx.x;
  // rows a step, this thread's column and first row.
  const int step = cols <= kThreads ? kThreads / cols : 1;
  const int col = cols <= kThreads ? t % cols : blockIdx.y * kThreads + t;
  const int row0 = cols <= kThreads ? t / cols : 0;
  if (row0 >= step || col >= cols) return;
  float ba[VEC], bb[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    ba[i] = bias_a ? bias_a[col * VEC + i] : 0.0f;
    bb[i] = bias_b ? bias_b[col * VEC + i] : 0.0f;
  }
  auto sum = [&](float (&va)[VEC], const float (&vb)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float x = bias_a ? rounded<T>(va[i] + ba[i]) : va[i];
      if (b) x += bias_b ? rounded<T>(vb[i] + bb[i]) : vb[i];
      va[i] = x;
    }
  };
  const int per_block = step * kRowsPerThread;
  const int r1 = min(rows, static_cast<int>(blockIdx.x) * per_block + per_block);
  const size_t offset = static_cast<size_t>(col) * VEC;
  int r = blockIdx.x * per_block + row0;
  for (; r + (kUnroll - 1) * step < r1; r += kUnroll * step) {
    float va[kUnroll][VEC], vb[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t at = static_cast<size_t>(r + u * step) * c + offset;
      load<T, VEC>(a + at, va[u]);
      if (b) load<T, VEC>(b + at, vb[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sum(va[u], vb[u]);
      store<T, VEC>(out + static_cast<size_t>(r + u * step) * c + offset, va[u]);
    }
  }
  for (; r < r1; r += step) {
    float va[VEC], vb[VEC];
    const size_t at = static_cast<size_t>(r) * c + offset;
    load<T, VEC>(a + at, va);
    if (b) load<T, VEC>(b + at, vb);
    sum(va, vb);
    store<T, VEC>(out + at, va);
  }
}

template <typename T, int VEC>
void run(int rows, int c, const void* a, const float* bias_a, const void* b, const float* bias_b, void* out,
         cudaStream_t stream) {
  const int cols = c / VEC;
  const int step = cols <= kThreads ? kThreads / cols : 1;
  const int per_block = step * kRowsPerThread;
  const dim3 grid((rows + per_block - 1) / per_block, (cols + kThreads - 1) / kThreads);
  residual_add_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(rows, c, static_cast<const T*>(a), bias_a,
                                                             static_cast<const T*>(b), bias_b, static_cast<T*>(out));
}

}  // namespace

// a, b (optional) and out (rows, C) row-major (a channels-last (N, H, W,
// C) tensor: rows = N H W), float32 or (is_bf16) bfloat16; bias_a and
// bias_b (C,) float32 or null. Returns a CUDA error code (1, invalid value,
// for a shape it does not take).
extern "C" int residual_add(int rows, int c, int is_bf16, const void* a, const void* bias_a, const void* b,
                            const void* bias_b, void* out, void* stream) {
  if (rows < 1 || c < 1 || (c + kThreads - 1) / kThreads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = is_bf16 ? 8 : 4;
  bool aligned = c % vec == 0;
  for (const void* p : {a, b, static_cast<const void*>(out)}) {
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }
  const float* ba = static_cast<const float*>(bias_a);
  const float* bb = static_cast<const float*>(bias_b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    aligned ? run<bf16, 8>(rows, c, a, ba, b, bb, out, s) : run<bf16, 1>(rows, c, a, ba, b, bb, out, s);
  } else {
    aligned ? run<float, 4>(rows, c, a, ba, b, bb, out, s) : run<float, 1>(rows, c, a, ba, b, bb, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
