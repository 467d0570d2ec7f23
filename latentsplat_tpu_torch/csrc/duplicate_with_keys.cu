// duplicate_with_keys: one (Gaussian id, sort key) pair per tile a Gaussian
// survives in.
//
// Replaces latentsplat_tpu/ops/rasterize/expand.py::expand_by_counts
// (_expand_kernel). The TPU kernel copied every attribute row of Gaussian i
// into pair columns [start_i, start_i + count_i) with indicator matmuls,
// because gathers serialize on the TPU. Here the pair buffer holds only the
// Gaussian id and an int64 key (tile << 32 | float bits of depth); the
// compositor reads attributes through the id, so nothing but 12 bytes per
// pair is written and sorted.
//
// Bound: memory. Per Gaussian it reads 16 bytes (mask, base, nx, depth),
// plus one exclusive offset per block, and writes 12 bytes per pair; at
// the flagship scale (393k Gaussians, ~0.5M pairs) that is ~12 MB, a few
// microseconds of HBM time. The pairs of one block's 512 Gaussians are
// contiguous in the output, so the block writes them as one range: a
// block-wide exclusive scan of the Gaussians' pair counts (popcounts of
// their surviving-slot masks) places each Gaussian's pairs in shared
// memory, and the block then stores the range with 16-byte stores (ids
// four at a time, keys two at a time; the range's unaligned ends one
// element at a time), in place of each thread's scattered run. Each
// thread holds two Gaussians, all of whose inputs it loads up front, so
// the grid is one wave of blocks and each block waits on one round of
// loads. The exclusive offsets come from a cumsum outside the kernel, as
// in the JAX package; no atomics.
//
// The slot mask is 32 bits wide on the main path (caps up to 32 slots) and
// 64 bits wide for callers that need a larger cap, such as the whole-scene
// orthographic projections; one template serves both.
//
// Depth of a live Gaussian is > 0, so its float bits order like the value.
// The caller sorts keys stably; pairs are written Gaussian-major,
// slot-ascending, so equal depths break ties by Gaussian index, like the
// JAX package's stable ranks.
//
// One launch serves a pass, the N (scene, view) items of a render call:
// item n's Gaussians are rows n G .. n G + G - 1 of the inputs and its
// rect origins (`base`) are pass tile ids n T + t, so the ids and tiles
// written are the pass's own and one sort orders every item's pairs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// A block takes kSegments segments of 256 Gaussians; thread tid holds
// Gaussian tid of each.
constexpr int kSegments = 2;
// Pairs staged at once, five per Gaussian (a flagship view averages 1.3);
// a block with more pairs writes them in rounds.
constexpr int kStage = 5 * kSegments * kThreads;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int popcount(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int popcount(uint64_t x) { return __popcll(x); }
__device__ __forceinline__ int lowest_bit(uint32_t x) { return __ffs(static_cast<int>(x)) - 1; }
__device__ __forceinline__ int lowest_bit(uint64_t x) {
  return __ffsll(static_cast<long long>(x)) - 1;
}

// Mask: uint32_t or uint64_t, one bit per rect slot.
template <typename Mask>
__global__ void __launch_bounds__(kThreads) duplicate_with_keys_kernel(
    int num_gaussians,
    const int64_t* __restrict__ offsets,  // inclusive prefix sum of pair counts
    const Mask* __restrict__ mask,        // surviving rect slots, bit s = slot s
    const int32_t* __restrict__ base,     // tile id of the rect's top-left slot
    const int32_t* __restrict__ nx,       // rect width in tiles
    const float* __restrict__ depth,
    int tiles_x,
    int32_t* __restrict__ gids,
    int64_t* __restrict__ keys) {
  // Output position q sits at index q - floor4(lo) of s_ids and
  // q - floor2(lo) of s_keys (lo = the round's first position), so that
  // aligned output chunks are aligned in shared memory too.
  __shared__ __align__(16) int32_t s_ids[kStage + 4];
  __shared__ __align__(16) int64_t s_keys[kStage + 2];
  __shared__ int s_warp[kSegments][kWarps];

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g0 = static_cast<int>(blockIdx.x) * kSegments * kThreads;
  const int64_t first = g0 == 0 ? 0 : offsets[g0 - 1];
  Mask bits[kSegments];
  int b[kSegments], w[kSegments];
  float inv_w[kSegments];
  int64_t depth_bits[kSegments];
#pragma unroll
  for (int k = 0; k < kSegments; ++k) {
    const int g = g0 + k * kThreads + tid;
    const bool valid = g < num_gaussians;
    bits[k] = valid ? mask[g] : Mask(0);
    b[k] = valid ? base[g] : 0;
    w[k] = valid ? nx[g] : 1;
    inv_w[k] = 1.0f / static_cast<float>(w[k]);
    depth_bits[k] = valid ? static_cast<int64_t>(__float_as_uint(depth[g])) : 0;
  }

  // Exclusive scan of the counts, segment by segment.
  int incl[kSegments];
#pragma unroll
  for (int k = 0; k < kSegments; ++k) {
    incl[k] = popcount(bits[k]);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl[k], d);
      if (lane >= d) incl[k] += v;
    }
    if (lane == 31) s_warp[k][warp] = incl[k];
  }
  __syncthreads();
  int local[kSegments];
  int total = 0;
#pragma unroll
  for (int k = 0; k < kSegments; ++k) {
    local[k] = total + incl[k] - popcount(bits[k]);
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      local[k] += v < warp ? s_warp[k][v] : 0;
      total += s_warp[k][v];
    }
  }

  for (int r0 = 0; r0 < total; r0 += kStage) {
    const int64_t lo = first + r0;
    const int m = min(kStage, total - r0);
    const int head4 = static_cast<int>(lo & 3);
    const int head2 = static_cast<int>(lo & 1);
#pragma unroll
    for (int k = 0; k < kSegments; ++k) {
      Mask rest = bits[k];
      for (int p = local[k] - r0; rest != Mask(0); ++p) {
        const int slot = lowest_bit(rest);
        rest &= rest - Mask(1);
        if (p < 0 || p >= m) continue;
        // slot / w, exactly: (slot + 0.5) / w lies 0.5 / w inside its unit
        // interval (w is a width in tiles), far beyond the product's rounding.
        const int row = __float2int_rz((static_cast<float>(slot) + 0.5f) * inv_w[k]);
        const int64_t tile = b[k] + row * tiles_x + (slot - row * w[k]);
        s_ids[head4 + p] = g0 + k * kThreads + tid;
        s_keys[head2 + p] = (tile << 32) | depth_bits[k];
      }
    }
    __syncthreads();
    const int64_t lo4 = lo - head4;
    for (int c = tid; c < (head4 + m + 3) / 4; c += kThreads) {
      const int64_t q = lo4 + 4 * c;
      if (q >= lo && q + 4 <= lo + m) {
        *reinterpret_cast<int4*>(gids + q) = *reinterpret_cast<const int4*>(s_ids + 4 * c);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (q + e >= lo && q + e < lo + m) gids[q + e] = s_ids[4 * c + e];
        }
      }
    }
    const int64_t lo2 = lo - head2;
    for (int c = tid; c < (head2 + m + 1) / 2; c += kThreads) {
      const int64_t q = lo2 + 2 * c;
      if (q >= lo && q + 2 <= lo + m) {
        *reinterpret_cast<longlong2*>(keys + q) = *reinterpret_cast<const longlong2*>(s_keys + 2 * c);
      } else {
        for (int e = 0; e < 2; ++e) {
          if (q + e >= lo && q + e < lo + m) keys[q + e] = s_keys[2 * c + e];
        }
      }
    }
    __syncthreads();
  }
}

template <typename Mask>
int launch(int num_gaussians, const void* offsets, const void* mask, const void* base,
           const void* nx, const void* depth, int tiles_x, void* gids, void* keys,
           void* stream) {
  if (num_gaussians > 0) {
    const int blocks = (num_gaussians + kSegments * kThreads - 1) / (kSegments * kThreads);
    duplicate_with_keys_kernel<Mask><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        num_gaussians, static_cast<const int64_t*>(offsets), static_cast<const Mask*>(mask),
        static_cast<const int32_t*>(base), static_cast<const int32_t*>(nx),
        static_cast<const float*>(depth), tiles_x, static_cast<int32_t*>(gids),
        static_cast<int64_t*>(keys));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gids and keys must be 16-byte aligned (as torch's allocations are).
// mask: int32 per Gaussian (caps up to 32 slots).
extern "C" int duplicate_with_keys(
    int num_gaussians, const void* offsets, const void* mask, const void* base,
    const void* nx, const void* depth, int tiles_x, void* gids, void* keys,
    void* stream) {
  return launch<uint32_t>(num_gaussians, offsets, mask, base, nx, depth, tiles_x, gids, keys, stream);
}

// The same with an int64 mask per Gaussian (caps up to 64 slots).
extern "C" int duplicate_with_keys64(
    int num_gaussians, const void* offsets, const void* mask, const void* base,
    const void* nx, const void* depth, int tiles_x, void* gids, void* keys,
    void* stream) {
  return launch<uint64_t>(num_gaussians, offsets, mask, base, nx, depth, tiles_x, gids, keys, stream);
}
