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

// parity: const kBigFit = 2**30
constexpr int32_t kBigFit = 1 << 30;  // fits_count's "unbounded"
// parity: const kBigDom = 2**28
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
// parity: const 1e-9
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

// 4-byte asynchronous copy from global to shared memory (cp.async, sm_80
// and later): both addresses 4-byte aligned; the bytes are there after
// cp_async_wait_all and a barrier
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

// 16-byte asynchronous copy (cp.async.cg: through L2 only), both
// addresses 16-byte aligned; as cp_async4 otherwise
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n bytes from global ``src`` to shared ``dst`` by the block's threads:
// 4-byte cp.async for the body where the two addresses agree mod 4, plain
// byte copies for the head and tail (and for all of it where they do not)
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src, int n, int tid,
                                            int nthreads) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), b = reinterpret_cast<uintptr_t>(dst);
  const int head = ((a ^ b) & 3) ? n : min(n, static_cast<int>((4 - (a & 3)) & 3));
  const int body = (n - head) & ~3;
#pragma unroll 1
  for (int i = tid; i < body / 4; i += nthreads) cp_async4(dst + head + 4 * i, src + head + 4 * i);
#pragma unroll 1
  for (int i = tid; i < n - body; i += nthreads) {
    const int j = i < head ? i : body + i;
    dst[j] = src[j];
  }
}

// Let ``kernel`` take ``smem`` bytes of dynamic shared memory (past 48 KB
// the runtime asks for it; the attribute is the current device's, so it
// is set on each such call). Returns the runtime's error code; a refusal
// is also cleared from the runtime's last error, so that the next launch
// in the process does not report it as its own.
template <class Kernel>
inline int allow_dynamic_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

inline int grid_for(long long n, int block) {
  long long g = (n + block - 1) / block;
  return static_cast<int>(g < 1 ? 1 : g);
}

}  // namespace kt

// Phase clocks (measurement only; tenant_scan.py builds pack.cu,
// pack_classed.cu and fresh_feasibility.cu once more with
// -DKT_PHASE_CLOCKS, libraries that neither the solver nor chip_smoke.py
// loads): at the end of each phase the block meets at a barrier and
// thread 0 of block (0, 0, 0) adds the %globaltimer nanoseconds since the
// last mark to its phase's total, one slot per phase of the kernel's own
// enum. The marks' extra barriers are the build's own cost.
constexpr int kMaxPhases = 16;
#ifdef KT_PHASE_CLOCKS
__device__ unsigned long long phase_ns[kMaxPhases];

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_MARK(k)                                     \
  do {                                                    \
    __syncthreads();                                      \
    if (blockIdx.x + blockIdx.y + blockIdx.z == 0 &&       \
        threadIdx.x == 0) {                               \
      const unsigned long long now_ = globaltimer();      \
      phase_ns[k] += now_ - clock_at;                     \
      clock_at = now_;                                    \
    }                                                     \
  } while (0)
#define PHASE_START unsigned long long clock_at = threadIdx.x == 0 ? globaltimer() : 0

// The first ``n`` phase totals in nanoseconds into ``host``, then every
// total zeroed; synchronous. Returns cudaGetLastError().
inline int read_phase_clocks(unsigned long long* host, int n) {
  if (n < 0 || n > kMaxPhases) return static_cast<int>(cudaErrorInvalidValue);
  cudaMemcpyFromSymbol(host, phase_ns, sizeof(unsigned long long) * n);
  const unsigned long long zero[kMaxPhases] = {};
  cudaMemcpyToSymbol(phase_ns, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
#else
#define PHASE_MARK(k) \
  do {                \
  } while (0)
#define PHASE_START
#endif
