// Kernel B9: the relaxation pre-solver's bulk rounding.
//
// Replaces karpenter_tpu/ops/relax.py:relax_fill (:244, inside
// _jit_relax_fill; an XLA program on the TPU), together with the host
// gather of its [NR, T] rows that karpenter_tpu/ops/relax.py:solve_bulk
// does before it. For every easy group i and bulk claim slot j,
// claim_fills[i, j] is the overlap of the group's cumulative pod interval
// [a_i, a_i + count_i) with the claim's capacity window
// [rel * n_per, rel * n_per + n_per) (rel = j minus the run's first slot),
// kept only for the run's own kc slots; each claim's type mask keeps the
// types whose fit n_fit survives the claim's total fill.
//
// Inputs: ``ge`` [5, GE] int32 (rows count, a, off, n_per, kc), ``cl``
// [3, NR] int32 (rows pool, fill, run: the slot's template p_star, its
// total pods and its run), B3's head tables ``type_ok`` [P, CRp, T] bool
// and ``n_fit`` [P, CRp, T] int32 as the card holds them, and n_r, the
// slots in use. Slot j reads row (pool[j], run[j]) of both tables, which
// every slot below n_r must name (ops/relax.py:fill_args builds them so);
// a slot at or past n_r is unavailable, exactly as the host gather set
// cl_avail[n_r:] = False.
//
// Design: one launch, its grid split into regions by block, so no thread
// branches per element:
//  - fills: one thread per [GE, NR] cell, the window arithmetic;
//  - masks: 4 consecutive cells of the flat [NR, T] mask a thread, each
//    read from its slot's table row, one 4-byte store (the flat offset 4q
//    of a fresh allocation always is aligned), byte stores for the tail;
//  - rows: c_pool[j] = pool[j] and unplaced[i] (the whole count when the
//    run has no feasible template, else 0).
//
// Integer arithmetic: XLA computes the windows in int32 and wraps. A run
// whose n_per is fits_count's "unbounded" 2**30 drives rel * n_per past
// int32 on the slots outside the run; signed overflow is undefined in
// C++, so every window operation goes through common.cuh's unsigned
// wrap_* helpers: every lane, masked or kept, equals JAX's bit for bit.
//
// Bound on the H100: bytes, and below them launch latency. The identical
// 50k x 400 batch gives GE = 1, NR = 1024, T = 400 and one run (P = 1,
// CRp = 1): ~0.4 MB of mask written, 4 KB of fills, ~14 KB read (the
// slot vectors and one 400-type row of each table).
#include "common.cuh"

namespace {

constexpr int kBlock = 256;

// the blocks of each region: fill cells, mask quads, rows
struct Regions {
  int fills, masks, rows;
};

struct Slots {
  const int32_t* pool;
  const int32_t* fill;
  const int32_t* run;
};

// slot j's mask cell at type t: available in its table row and its fit
// surviving the slot's total fill
__device__ __forceinline__ uint8_t mask_cell(const Slots& s, const uint8_t* __restrict__ type_ok,
                                             const int32_t* __restrict__ n_fit, int j, int t,
                                             int T, int CRp, int n_r) {
  if (j >= n_r) return 0;
  const size_t cell = (static_cast<size_t>(s.pool[j]) * CRp + s.run[j]) * T + t;
  return type_ok[cell] && n_fit[cell] >= s.fill[j];
}

__global__ void __launch_bounds__(kBlock) relax_fill(
    int GE, int NR, int T, int CRp, int n_r, Regions rg,
    const int32_t* __restrict__ ge, const int32_t* __restrict__ cl,
    const uint8_t* __restrict__ type_ok, const int32_t* __restrict__ n_fit,
    int32_t* __restrict__ claim_fills, uint8_t* __restrict__ c_tmask,
    int32_t* __restrict__ c_pool, int32_t* __restrict__ unplaced) {
  const int32_t* ge_count = ge;
  const int32_t* ge_a = ge + GE;
  const int32_t* ge_off = ge + 2 * GE;
  const int32_t* ge_nper = ge + 3 * GE;
  const int32_t* ge_kc = ge + 4 * GE;
  const Slots s{cl, cl + NR, cl + 2 * NR};
  int b = blockIdx.x;
  if (b < rg.fills) {
    const long long total = static_cast<long long>(GE) * NR;
    for (long long idx = static_cast<long long>(b) * kBlock + threadIdx.x; idx < total;
         idx += static_cast<long long>(rg.fills) * kBlock) {
      const int i = static_cast<int>(idx / NR), j = static_cast<int>(idx % NR);
      const int32_t count = ge_count[i], nper_raw = ge_nper[i];
      const int32_t rel = kt::wrap_sub(j, ge_off[i]);
      const int32_t nper = max(nper_raw, 1);
      const int32_t lo = ge_a[i];
      const int32_t hi = kt::wrap_add(lo, count);
      const int32_t win_lo = kt::wrap_mul(rel, nper);
      const int32_t win_hi = kt::wrap_add(win_lo, nper);
      const int32_t fill = kt::clip(kt::wrap_sub(min(hi, win_hi), max(lo, win_lo)), 0, nper);
      const bool in_run = rel >= 0 && rel < ge_kc[i] && nper_raw > 0;
      claim_fills[idx] = in_run ? fill : 0;
    }
    return;
  }
  b -= rg.fills;
  if (b < rg.masks) {
    const long long total = static_cast<long long>(NR) * T;
    for (long long c0 = (static_cast<long long>(b) * kBlock + threadIdx.x) * 4; c0 < total;
         c0 += static_cast<long long>(rg.masks) * kBlock * 4) {
      int j = static_cast<int>(c0 / T), t = static_cast<int>(c0 % T);
      uint32_t word = 0;
      const int n = c0 + 4 <= total ? 4 : static_cast<int>(total - c0);
      for (int k = 0; k < n; ++k) {
        word |= static_cast<uint32_t>(mask_cell(s, type_ok, n_fit, j, t, T, CRp, n_r))
                << (8 * k);
        if (++t == T) {
          t = 0;
          ++j;
        }
      }
      if (n == 4) {
        *reinterpret_cast<uint32_t*>(c_tmask + c0) = word;
      } else {
        for (int k = 0; k < n; ++k) c_tmask[c0 + k] = static_cast<uint8_t>(word >> (8 * k));
      }
    }
    return;
  }
  b -= rg.masks;
  for (int x = b * kBlock + threadIdx.x; x < NR || x < GE; x += rg.rows * kBlock) {
    if (x < NR) c_pool[x] = s.pool[x];
    if (x < GE) unplaced[x] = ge_nper[x] > 0 ? 0 : ge_count[x];
  }
}

// blocks for n work items of ``per`` a block, at least 1 where n > 0, at
// most ``cap``
int blocks_for(long long n, long long per, int cap) {
  const long long b = (n + per - 1) / per;
  return static_cast<int>(b < cap ? b : cap);
}

}  // namespace

extern "C" int kt_relax_fill(
    int GE, int NR, int T, int CRp, int n_r,
    const int32_t* ge, const int32_t* cl, const uint8_t* type_ok, const int32_t* n_fit,
    int32_t* claim_fills, uint8_t* c_tmask, int32_t* c_pool, int32_t* unplaced,
    void* stream_ptr) {
  const long long fills = static_cast<long long>(GE) * NR;
  const long long quads = (static_cast<long long>(NR) * T + 3) / 4;
  Regions rg{blocks_for(fills, kBlock, 1024), blocks_for(quads, kBlock, 2048),
             blocks_for(NR > GE ? NR : GE, kBlock, 64)};
  const int blocks = rg.fills + rg.masks + rg.rows;
  if (blocks == 0) return kt::kNothingLaunched;
  relax_fill<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      GE, NR, T, CRp, n_r, rg, ge, cl, type_ok, n_fit, claim_fills, c_tmask, c_pool, unplaced);
  return static_cast<int>(cudaGetLastError());
}
