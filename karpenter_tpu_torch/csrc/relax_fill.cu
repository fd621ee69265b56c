// Kernel B9: the relaxation pre-solver's bulk rounding.
//
// Replaces karpenter_tpu/ops/relax.py:relax_fill (:244, inside
// _jit_relax_fill; an XLA program on the TPU). For every easy group i and
// bulk claim slot j, claim_fills[i, j] is the overlap of the group's
// cumulative pod interval [a_i, a_i + count_i) with the claim's capacity
// window [rel * n_per, rel * n_per + n_per) (rel = j minus the run's first
// slot), kept only for the run's own kc slots; each claim's type mask
// keeps the types whose fit n_fit survives the claim's total fill.
//
// Two grids in one launch sequence on the caller's stream:
//  - [GE, NR], one thread per cell: the interval overlap. Thread j == 0 of
//    each row also writes unplaced[i] (the whole count when the run has no
//    feasible template).
//  - [NR, T], one thread per cell: c_tmask = cl_avail & (cl_nfit >=
//    cl_fill). Thread t == 0 of each slot copies c_pool[j].
//
// Integer arithmetic: XLA computes the windows in int32 and wraps. A run
// whose n_per is fits_count's "unbounded" 2**30 drives rel * n_per past
// int32 on the slots outside the run; signed overflow is undefined in
// C++, so every window operation goes through common.cuh's unsigned
// wrap_* helpers: every lane, masked or kept, equals JAX's bit for bit.
//
// Bound on the H100: launch latency. The identical 50k x 400 batch gives
// GE = 1, NR = 1024, T = 400: ~0.4 MB of type-mask and n_fit rows read and
// ~0.4 MB written, a few integer operations per cell.
#include "common.cuh"

namespace {

__global__ void claim_fills_kernel(
    int GE, int NR, const int32_t* __restrict__ ge_count,
    const int32_t* __restrict__ ge_a, const int32_t* __restrict__ ge_off,
    const int32_t* __restrict__ ge_nper, const int32_t* __restrict__ ge_kc,
    int32_t* __restrict__ claim_fills, int32_t* __restrict__ unplaced) {
  // with NR == 0 one thread per group still writes unplaced
  const int NN = NR > 0 ? NR : 1;
  const long long total = static_cast<long long>(GE) * NN;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(idx % NN);
    const int i = static_cast<int>(idx / NN);
    const int32_t count = ge_count[i], nper_raw = ge_nper[i];
    if (j == 0) unplaced[i] = nper_raw > 0 ? 0 : count;
    if (NR == 0) continue;
    const int32_t rel = kt::wrap_sub(j, ge_off[i]);
    const int32_t nper = max(nper_raw, 1);
    const int32_t lo = ge_a[i];
    const int32_t hi = kt::wrap_add(lo, count);
    const int32_t win_lo = kt::wrap_mul(rel, nper);
    const int32_t win_hi = kt::wrap_add(win_lo, nper);
    const int32_t fill = kt::clip(kt::wrap_sub(min(hi, win_hi), max(lo, win_lo)), 0, nper);
    const bool in_run = rel >= 0 && rel < ge_kc[i] && nper_raw > 0;
    claim_fills[static_cast<size_t>(i) * NR + j] = in_run ? fill : 0;
  }
}

__global__ void claim_masks_kernel(
    int NR, int T, const int32_t* __restrict__ cl_run_pool,
    const int32_t* __restrict__ cl_fill, const uint8_t* __restrict__ cl_avail,
    const int32_t* __restrict__ cl_nfit, uint8_t* __restrict__ c_tmask,
    int32_t* __restrict__ c_pool) {
  // with T == 0 one thread per slot still copies c_pool
  const int TT = T > 0 ? T : 1;
  const long long total = static_cast<long long>(NR) * TT;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(idx % TT);
    const int j = static_cast<int>(idx / TT);
    if (t == 0) c_pool[j] = cl_run_pool[j];
    if (T == 0) continue;
    const size_t cell = static_cast<size_t>(j) * T + t;
    c_tmask[cell] = cl_avail[cell] && cl_nfit[cell] >= cl_fill[j];
  }
}

}  // namespace

extern "C" int kt_relax_fill(
    int GE, int NR, int T,
    const int32_t* ge_count, const int32_t* ge_a, const int32_t* ge_off,
    const int32_t* ge_nper, const int32_t* ge_kc,
    const int32_t* cl_run_pool, const int32_t* cl_fill, const uint8_t* cl_avail,
    const int32_t* cl_nfit,
    int32_t* claim_fills, uint8_t* c_tmask, int32_t* c_pool, int32_t* unplaced,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (GE == 0 && NR == 0) return kt::kNothingLaunched;
  constexpr int kBlock = 256;
  if (GE > 0) {
    const long long cells = static_cast<long long>(GE) * (NR > 0 ? NR : 1);
    claim_fills_kernel<<<kt::grid_for(cells, kBlock), kBlock, 0, stream>>>(
        GE, NR, ge_count, ge_a, ge_off, ge_nper, ge_kc, claim_fills, unplaced);
  }
  if (NR > 0) {
    const long long cells = static_cast<long long>(NR) * (T > 0 ? T : 1);
    claim_masks_kernel<<<kt::grid_for(cells, kBlock), kBlock, 0, stream>>>(
        NR, T, cl_run_pool, cl_fill, cl_avail, cl_nfit, c_tmask, c_pool);
  }
  return static_cast<int>(cudaGetLastError());
}
