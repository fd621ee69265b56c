// Shared device helpers for the solver kernels (sm_90a, plain C interface).
//
// Exactness: every kernel here must agree bit for bit with its plain
// PyTorch version and with the XLA reference (karpenter_tpu/ops/). Float
// work is float32 with IEEE division and no fused multiply-add (the build
// passes -fmad=false and never --use_fast_math); integer sums wrap as
// int32 two's complement, as XLA's do.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace kt {

constexpr int32_t kBigFit = 1 << 30;  // fits_count's "unbounded"
constexpr int32_t kBigDom = 1 << 28;  // _BIGI: "unbounded" slot capacity
constexpr unsigned kFull = 0xffffffffu;
// an entry point's return when its shapes are empty and nothing launched
// (CUDA error codes are >= 0); the wrapper then counts no launch
constexpr int kNothingLaunched = -1;
// ... and when its thread-block cluster cannot be placed on the card
// (cudaOccupancyMaxActiveClusters is 0); the wrapper raises with the reason
constexpr int kClusterUnplaced = -2;

// fits_count (karpenter_tpu/ops/feasibility.py:68): float32
// floor(headroom / max(req, 1e-9)) per positive request, min over R, +inf
// (no positive request) -> 2**30, 0 when a zero-request dimension is
// already over; float -> int32 truncates and saturates like XLA's convert.
__device__ __forceinline__ int32_t fits_count(const float* alloc, const float* base,
                                              const float* req, int R) {
  bool ok_zero = true;
  float n = INFINITY;
  for (int r = 0; r < R; ++r) {
    const float h = __fsub_rn(alloc[r], base[r]);
    const float q = req[r];
    if (!(q > 0.0f) && !(h >= 0.0f)) ok_zero = false;
    const float per = (q > 0.0f) ? floorf(__fdiv_rn(h, fmaxf(q, 1e-9f))) : INFINITY;
    n = fminf(n, per);
  }
  if (isinf(n)) n = 1073741824.0f;
  if (!ok_zero) return 0;
  return __float2int_rz(fmaxf(n, 0.0f));
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// jnp.clip(x, lo, hi) == min(max(x, lo), hi), in that order
__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return min(max(x, lo), hi);
}

inline int grid_for(long long n, int block) {
  long long g = (n + block - 1) / block;
  return static_cast<int>(g < 1 ? 1 : g);
}

}  // namespace kt
