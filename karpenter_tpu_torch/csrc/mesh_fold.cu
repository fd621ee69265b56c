// The solver mesh's fold: the shards' feasibility partials into the
// replicated tables, once per feasibility stage, on the lead device.
//
// Replaces the stage-boundary all-reduce of
// karpenter_tpu/parallel/mesh.py:sharded_solve_fn / sharded_scenarios_fn
// (GSPMD's segment_sum fold and the table gather that
// karpenter_tpu/ops/solve.py:_solve_with's table_sharding asks for before
// the scan), which no kernel body of the JAX package computes. The D data
// shards x M model shards of a scenario block each wrote int32 failure
// counts over their slices (fresh_feasibility.cu's and
// existing_feasibility.cu's partial modes); this kernel sums the D counts
// of each cell (int32, wrapping: exact in any order), and finishes the
// cell with the device functions the single-device kernels end with
// (tables_finish.cuh):
//   compat_pg [P, G]    = compat_of(p_tol, sum_d fail_c)
//   type_ok   [P, G, T] = fresh_cell(compat, sum_d fail_t, tonly)
//   n_fit     [P, G, T] = model shard m's n_fit at its type offset
//   cap_ng [S, N, G]    = node_cap(sum_d nfail, n_tol, cap)
// Model shard m's cells sit at types [m * T/M, (m + 1) * T/M). With D = 0
// the parts are final (the dense route's type slices of B3, their
// compat_pg passed as p_tol) and the fold only gathers them.
//
// Bound on the H100: memory. A fresh cell reads 4 D + 5 bytes and writes
// 5 (plus 4 D + 1 a (p, g) pair, for the compat); an existing cell reads
// 4 D + 4 + S and writes 4 S. At the constrained cell (P 1, G 256, T 800,
// D 8) that is ~8.6 MB, ~2.6 us at 3.35 TB/s.
//
// Design: one launch in regions by block, as wire_pack.cu and
// relax_fill.cu: the first blocks take the fresh cells, a cell a thread
// (consecutive threads consecutive types, so every partial's loads
// coalesce), the rest the existing cells, a (node, group) a thread writing
// its S gated values. The shards' pointers ride the launch as kernel
// parameters (at most kMaxShards of each kind), so the partials are read
// where each shard wrote them, with no gather copy.
#include "tables_finish.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxShards = 64;  // parallel/mesh.py:MAX_SHARDS

struct Shards {
  const void* p[kMaxShards];
};

__global__ void __launch_bounds__(kBlock) fold(
    int D, int M, int P, int G, int T, int N, int S, int fresh_blocks,
    const Shards fail_t, const Shards fail_c, const Shards tonly, const Shards nfit,
    const Shards nfail, const uint8_t* __restrict__ p_tol, const int32_t* __restrict__ cap,
    const uint8_t* __restrict__ n_tol, uint8_t* __restrict__ compat_pg,
    uint8_t* __restrict__ type_ok, int32_t* __restrict__ n_fit, int32_t* __restrict__ cap_ng) {
  if (static_cast<int>(blockIdx.x) < fresh_blocks) {
    const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
    if (i >= static_cast<long long>(P) * G * T) return;
    const int Tm = T / M;
    const long long pg = i / T;
    const int t = static_cast<int>(i - pg * T);
    const int m = t / Tm;
    const long long at = pg * Tm + (t - m * Tm);
    int32_t cfail = 0, fails = 0;
    for (int d = 0; d < D; ++d) {
      cfail = kt::wrap_add(cfail, static_cast<const int32_t*>(fail_c.p[d])[pg]);
      fails = kt::wrap_add(fails, static_cast<const int32_t*>(fail_t.p[d * M + m])[at]);
    }
    const bool compat = kt::compat_of(p_tol[pg], cfail);
    if (t == 0) compat_pg[pg] = compat;
    type_ok[i] = kt::fresh_cell(compat, fails, static_cast<const uint8_t*>(tonly.p[m])[at]);
    n_fit[i] = static_cast<const int32_t*>(nfit.p[m])[at];
    return;
  }
  const long long cells = static_cast<long long>(N) * G;
  const long long i = static_cast<long long>(blockIdx.x - fresh_blocks) * kBlock + threadIdx.x;
  if (i >= cells) return;
  int32_t fails = 0;
  for (int d = 0; d < D; ++d)
    fails = kt::wrap_add(fails, static_cast<const int32_t*>(nfail.p[d])[i]);
  const int32_t room = cap[i];
  for (int s = 0; s < S; ++s) cap_ng[s * cells + i] = kt::node_cap(fails, n_tol[s * cells + i], room);
}

Shards shards(const void* const* host, int n) {
  Shards out{};
  for (int j = 0; j < n; ++j) out.p[j] = host[j];
  return out;
}

}  // namespace

// D data shards x M model shards: fail_t (D * M host pointers to [P, G,
// T/M] int32, data major), fail_c (D, [P, G] int32), tonly (M, [P, G,
// T/M] bool), nfit (M, [P, G, T/M] int32), nfail (D, [N, G] int32; N may
// be 0, then cap, n_tol and cap_ng are not read), p_tol [P, G], cap [N, G],
// n_tol [S, N, G]; outputs compat_pg [P, G], type_ok [P, G, T], n_fit [P,
// G, T], cap_ng [S, N, G]. The pointer arrays are host memory.
extern "C" int kt_mesh_fold(
    int D, int M, int P, int G, int T, int N, int S,
    const void* const* fail_t, const void* const* fail_c, const void* const* tonly,
    const void* const* nfit, const void* const* nfail,
    const uint8_t* p_tol, const int32_t* cap, const uint8_t* n_tol,
    uint8_t* compat_pg, uint8_t* type_ok, int32_t* n_fit, int32_t* cap_ng,
    void* stream_ptr) {
  if (M < 1 || D < 0 || D > kMaxShards || M > kMaxShards || D * M > kMaxShards || T % M)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long fresh = static_cast<long long>(P) * G * T;
  const long long exist = static_cast<long long>(N) * G;
  const int fresh_blocks = static_cast<int>((fresh + kBlock - 1) / kBlock);
  const int exist_blocks = S > 0 ? static_cast<int>((exist + kBlock - 1) / kBlock) : 0;
  if (fresh_blocks + exist_blocks == 0) return kt::kNothingLaunched;
  fold<<<fresh_blocks + exist_blocks, kBlock, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      D, M, P, G, T, N, S, fresh_blocks, shards(fail_t, D * M), shards(fail_c, D),
      shards(tonly, M), shards(nfit, M), shards(nfail, N > 0 ? D : 0), p_tol, cap, n_tol,
      compat_pg, type_ok, n_fit, cap_ng);
  return static_cast<int>(cudaGetLastError());
}
