// Kernel B3: the dense feasibility tables, two entries in one library.
//
// Replaces karpenter_tpu/ops/feasibility.py:fresh_claim_feasibility (:84)
// and existing_node_feasibility (:298), the dense twins of B1 and B2 (XLA
// programs on the TPU): the same tables by the full [P, G, T, K, V1]
// requirement join, with no live-pair index. The relaxation pre-solver
// (ops/relax.py:solve_bulk) runs the fresh entry over its easy runs' head
// groups; ops/solve.py runs both when sparse_groups is False.
//
//  - kt_dense_fresh: one thread per (p, g, t) walks the K keys and V1
//    values of the merged claim p ∪ g against type t, the type's
//    zone/capacity-type offerings and fits_count, and writes type_ok and
//    n_fit; the thread with t == 0 of each (p, g) also writes compat_pg,
//    which every thread of the row computes for itself (K x V1 byte ANDs,
//    cheaper than a second launch and a barrier).
//  - kt_dense_existing: one thread per (n, g): strict compatibility (no
//    well-known allowance, existingnode.go:96), fits_count against
//    n_avail - n_base, gated by n_tol; under a scenario batch n_tol and
//    cap_ng are [S, N, G] and each thread writes its S gated values.
//
// Bound on the H100: launch latency at the shapes the port runs. The relax
// path's fresh table is CRp x T cells (1 x 400 on an identical batch),
// the ops dense route's P x G x T (64 x 400 on the mixed 50k snapshot);
// each cell reads ~K x V1 bytes of masks it shares with its neighbours
// (L1-resident) and does R float divisions in fits_count. No shared
// memory, no atomics: every output cell has one writer.
//
// The cell functions live in dense_feasibility.cuh, so a scan can compute
// a table row per step with them.
#include "dense_feasibility.cuh"

namespace {

__global__ void dense_fresh(
    int P, int G, int T, int K, int V1, int R, int O, int zone_kid, int ct_kid,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint8_t* __restrict__ g_mask, const float* __restrict__ g_req,
    const uint8_t* __restrict__ p_def, const uint8_t* __restrict__ p_neg,
    const uint8_t* __restrict__ p_mask, const float* __restrict__ p_daemon,
    const uint8_t* __restrict__ p_tol, const uint8_t* __restrict__ p_titype_ok,
    const uint8_t* __restrict__ t_def, const uint8_t* __restrict__ t_mask,
    const float* __restrict__ t_alloc,
    const uint8_t* __restrict__ o_avail, const int32_t* __restrict__ o_zone,
    const int32_t* __restrict__ o_ct, const uint8_t* __restrict__ well_known,
    uint8_t* __restrict__ compat_pg, uint8_t* __restrict__ type_ok,
    int32_t* __restrict__ n_fit) {
  // with T == 0 one thread per (p, g) still writes compat_pg
  const int TT = T > 0 ? T : 1;
  const long long total = static_cast<long long>(P) * G * TT;
  const size_t KV = static_cast<size_t>(K) * V1;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(i % TT);
    const int g = static_cast<int>((i / TT) % G);
    const int p = static_cast<int>(i / (static_cast<long long>(TT) * G));
    const size_t pg = static_cast<size_t>(p) * G + g;
    const uint8_t* pd = p_def + static_cast<size_t>(p) * K;
    const uint8_t* pm = p_mask + p * KV;
    const uint8_t* gd = g_def + static_cast<size_t>(g) * K;
    const uint8_t* gm = g_mask + g * KV;
    const bool compat =
        p_tol[pg] && kt::dense_compatible(pd, p_neg + static_cast<size_t>(p) * K, pm, gd,
                                          g_neg + static_cast<size_t>(g) * K, gm,
                                          well_known, K, V1);
    if (t == 0) compat_pg[pg] = compat;
    if (T == 0) continue;
    const bool tc = kt::dense_type_compat(t_def + static_cast<size_t>(t) * K, t_mask + t * KV,
                                          pd, pm, gd, gm, K, V1);
    const bool off = kt::dense_offering_ok(
        pm + static_cast<size_t>(zone_kid) * V1, pm + static_cast<size_t>(ct_kid) * V1,
        gm + static_cast<size_t>(zone_kid) * V1, gm + static_cast<size_t>(ct_kid) * V1,
        o_avail + static_cast<size_t>(t) * O, o_zone + static_cast<size_t>(t) * O,
        o_ct + static_cast<size_t>(t) * O, O);
    const int32_t nf = kt::fits_count(t_alloc + static_cast<size_t>(t) * R,
                                      p_daemon + static_cast<size_t>(p) * R,
                                      g_req + static_cast<size_t>(g) * R, R);
    n_fit[pg * T + t] = nf;
    type_ok[pg * T + t] =
        tc && off && nf >= 1 && p_titype_ok[static_cast<size_t>(p) * T + t] && compat;
  }
}

__global__ void dense_existing(
    int S, int N, int G, int K, int V1, int R,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint8_t* __restrict__ g_mask, const float* __restrict__ g_req,
    const uint8_t* __restrict__ n_def, const uint8_t* __restrict__ n_mask,
    const float* __restrict__ n_avail, const float* __restrict__ n_base,
    const uint8_t* __restrict__ n_tol, int32_t* __restrict__ cap_ng) {
  const long long total = static_cast<long long>(N) * G;
  const size_t KV = static_cast<size_t>(K) * V1;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(i % G);
    const int n = static_cast<int>(i / G);
    // a node's labels are never negated, and existing nodes get no
    // well-known allowance: both sides of the strict direction are null
    const bool compat = kt::dense_compatible(
        n_def + static_cast<size_t>(n) * K, nullptr, n_mask + n * KV,
        g_def + static_cast<size_t>(g) * K, g_neg + static_cast<size_t>(g) * K,
        g_mask + g * KV, nullptr, K, V1);
    const int32_t cap =
        compat ? kt::fits_count(n_avail + static_cast<size_t>(n) * R,
                                n_base + static_cast<size_t>(n) * R,
                                g_req + static_cast<size_t>(g) * R, R)
               : 0;
    for (int s = 0; s < S; ++s)
      cap_ng[s * total + i] = n_tol[s * total + i] ? cap : 0;
  }
}

}  // namespace

extern "C" int kt_dense_fresh(
    int P, int G, int T, int K, int V1, int R, int O, int zone_kid, int ct_kid,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* p_def, const uint8_t* p_neg, const uint8_t* p_mask,
    const float* p_daemon, const uint8_t* p_tol, const uint8_t* p_titype_ok,
    const uint8_t* t_def, const uint8_t* t_mask, const float* t_alloc,
    const uint8_t* o_avail, const int32_t* o_zone, const int32_t* o_ct,
    const uint8_t* well_known,
    uint8_t* compat_pg, uint8_t* type_ok, int32_t* n_fit,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long rows = static_cast<long long>(P) * G;
  if (rows == 0) return kt::kNothingLaunched;
  const long long cells = rows * (T > 0 ? T : 1);
  constexpr int kBlock = 256;
  dense_fresh<<<kt::grid_for(cells, kBlock), kBlock, 0, stream>>>(
      P, G, T, K, V1, R, O, zone_kid, ct_kid, g_def, g_neg, g_mask, g_req,
      p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok, t_def, t_mask,
      t_alloc, o_avail, o_zone, o_ct, well_known, compat_pg, type_ok, n_fit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kt_dense_existing(
    int S, int N, int G, int K, int V1, int R,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* n_def, const uint8_t* n_mask, const float* n_avail,
    const float* n_base, const uint8_t* n_tol,
    int32_t* cap_ng, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long cells = static_cast<long long>(N) * G;
  if (cells == 0 || S == 0) return kt::kNothingLaunched;
  constexpr int kBlock = 128;
  dense_existing<<<kt::grid_for(cells, kBlock), kBlock, 0, stream>>>(
      S, N, G, K, V1, R, g_def, g_neg, g_mask, g_req, n_def, n_mask, n_avail,
      n_base, n_tol, cap_ng);
  return static_cast<int>(cudaGetLastError());
}
