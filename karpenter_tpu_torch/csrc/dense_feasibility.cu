// Kernel B3: the dense feasibility tables, two entries in one library.
//
// Replaces karpenter_tpu/ops/feasibility.py:fresh_claim_feasibility (:84)
// and existing_node_feasibility (:298), the dense twins of B1 and B2 (XLA
// programs on the TPU): the same tables by the full [P, G, T, K, V1]
// requirement join, with no live-pair index. The relaxation pre-solver
// (ops/relax.py:solve_bulk) runs the fresh entry over its easy runs' head
// groups; ops/solve.py runs both when sparse_groups is False.
//
//  - each entry first turns the [., K, V1] byte masks it reads into bit
//    words (row_words, into the wrapper's scratch: [K, W] per group,
//    template, type or node), then runs the cells of
//    dense_feasibility.cuh over them;
//  - kt_dense_fresh: one thread per (p, g, t) intersects the K keys of
//    the merged claim p ∪ g with type t, tests the type's zone /
//    capacity-type offerings and fits_count, and writes type_ok and
//    n_fit; the thread with t == 0 of each (p, g) also writes compat_pg,
//    which every thread of the row computes for itself (K x W word ANDs,
//    cheaper than a second launch and a barrier).
//  - kt_dense_existing: one thread per (n, g): strict compatibility (no
//    well-known allowance, existingnode.go:96), fits_count against
//    n_avail - n_base, gated by n_tol; under a scenario batch n_tol and
//    cap_ng are [S, N, G] and each thread writes its S gated values.
//
// Bound on the H100: launch latency at the shapes the port runs. The relax
// path's fresh table is CRp x T cells (1 x 400 on an identical batch),
// the ops dense route's P x G x T (64 x 400 on the mixed 50k snapshot);
// each cell reads ~K x W words it shares with its neighbours
// (L1-resident) and does R float divisions in fits_count. No shared
// memory, no atomics: every output cell has one writer.
#include "dense_feasibility.cuh"

namespace {

// the bit words of up to three [rows, K, V1] byte mask arrays (``r`` =
// rows * K mask rows each, 0 for an unused one) in one grid-stride pass
__global__ void row_words(int V1, int W,
                          const uint8_t* m0, long long r0, uint32_t* w0,
                          const uint8_t* m1, long long r1, uint32_t* w1,
                          const uint8_t* m2, long long r2, uint32_t* w2) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  kt::mask_words(m0, r0, V1, W, w0, i0, step);
  kt::mask_words(m1, r1, V1, W, w1, i0, step);
  kt::mask_words(m2, r2, V1, W, w2, i0, step);
}

__global__ void dense_fresh(
    int P, int G, int T, int K, int W, int R, int O, int zone_kid, int ct_kid,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint32_t* __restrict__ g_w, const float* __restrict__ g_req,
    const uint8_t* __restrict__ p_def, const uint8_t* __restrict__ p_neg,
    const uint32_t* __restrict__ p_w, const float* __restrict__ p_daemon,
    const uint8_t* __restrict__ p_tol, const uint8_t* __restrict__ p_titype_ok,
    const uint8_t* __restrict__ t_def, const uint32_t* __restrict__ t_w,
    const float* __restrict__ t_alloc,
    const uint8_t* __restrict__ o_avail, const int32_t* __restrict__ o_zone,
    const int32_t* __restrict__ o_ct, const uint8_t* __restrict__ well_known,
    uint8_t* __restrict__ compat_pg, uint8_t* __restrict__ type_ok,
    int32_t* __restrict__ n_fit) {
  // with T == 0 one thread per (p, g) still writes compat_pg
  const int TT = T > 0 ? T : 1;
  const long long total = static_cast<long long>(P) * G * TT;
  const size_t KW = static_cast<size_t>(K) * W;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(i % TT);
    const int g = static_cast<int>((i / TT) % G);
    const int p = static_cast<int>(i / (static_cast<long long>(TT) * G));
    const size_t pg = static_cast<size_t>(p) * G + g;
    const uint8_t* pd = p_def + static_cast<size_t>(p) * K;
    const uint32_t* pw = p_w + p * KW;
    const uint8_t* gd = g_def + static_cast<size_t>(g) * K;
    const uint32_t* gw = g_w + g * KW;
    const bool compat =
        p_tol[pg] && kt::dense_compatible(pd, p_neg + static_cast<size_t>(p) * K, pw, gd,
                                          g_neg + static_cast<size_t>(g) * K, gw,
                                          well_known, K, W);
    if (t == 0) compat_pg[pg] = compat;
    if (T == 0) continue;
    const bool tc = kt::dense_type_compat(t_def + static_cast<size_t>(t) * K, t_w + t * KW,
                                          pd, pw, gd, gw, K, W);
    const bool off = kt::dense_offering_ok(
        pw + static_cast<size_t>(zone_kid) * W, pw + static_cast<size_t>(ct_kid) * W,
        gw + static_cast<size_t>(zone_kid) * W, gw + static_cast<size_t>(ct_kid) * W,
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
    int S, int N, int G, int K, int W, int R,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint32_t* __restrict__ g_w, const float* __restrict__ g_req,
    const uint8_t* __restrict__ n_def, const uint32_t* __restrict__ n_w,
    const float* __restrict__ n_avail, const float* __restrict__ n_base,
    const uint8_t* __restrict__ n_tol, int32_t* __restrict__ cap_ng) {
  const long long total = static_cast<long long>(N) * G;
  const size_t KW = static_cast<size_t>(K) * W;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(i % G);
    const int n = static_cast<int>(i / G);
    // a node's labels are never negated, and existing nodes get no
    // well-known allowance: both sides of the strict direction are null
    const bool compat = kt::dense_compatible(
        n_def + static_cast<size_t>(n) * K, nullptr, n_w + n * KW,
        g_def + static_cast<size_t>(g) * K, g_neg + static_cast<size_t>(g) * K,
        g_w + g * KW, nullptr, K, W);
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

// ``words`` is the wrapper's scratch: (G + P + T) x K x W words
extern "C" int kt_dense_fresh(
    int P, int G, int T, int K, int V1, int R, int O, int zone_kid, int ct_kid,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* p_def, const uint8_t* p_neg, const uint8_t* p_mask,
    const float* p_daemon, const uint8_t* p_tol, const uint8_t* p_titype_ok,
    const uint8_t* t_def, const uint8_t* t_mask, const float* t_alloc,
    const uint8_t* o_avail, const int32_t* o_zone, const int32_t* o_ct,
    const uint8_t* well_known, uint32_t* words,
    uint8_t* compat_pg, uint8_t* type_ok, int32_t* n_fit,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long rows = static_cast<long long>(P) * G;
  if (rows == 0) return kt::kNothingLaunched;
  const int W = (V1 + 31) / 32;
  const size_t KW = static_cast<size_t>(K) * W;
  uint32_t* g_w = words;
  uint32_t* p_w = g_w + G * KW;
  uint32_t* t_w = p_w + P * KW;
  constexpr int kBlock = 256;
  const long long nw = static_cast<long long>(G + P + T) * K * W;
  row_words<<<kt::grid_for(nw, kBlock), kBlock, 0, stream>>>(
      V1, W, g_mask, static_cast<long long>(G) * K, g_w, p_mask, static_cast<long long>(P) * K,
      p_w, t_mask, static_cast<long long>(T) * K, t_w);
  const long long cells = rows * (T > 0 ? T : 1);
  dense_fresh<<<kt::grid_for(cells, kBlock), kBlock, 0, stream>>>(
      P, G, T, K, W, R, O, zone_kid, ct_kid, g_def, g_neg, g_w, g_req,
      p_def, p_neg, p_w, p_daemon, p_tol, p_titype_ok, t_def, t_w,
      t_alloc, o_avail, o_zone, o_ct, well_known, compat_pg, type_ok, n_fit);
  return static_cast<int>(cudaGetLastError());
}

// ``words`` is the wrapper's scratch: (G + N) x K x W words
extern "C" int kt_dense_existing(
    int S, int N, int G, int K, int V1, int R,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* n_def, const uint8_t* n_mask, const float* n_avail,
    const float* n_base, const uint8_t* n_tol, uint32_t* words,
    int32_t* cap_ng, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long cells = static_cast<long long>(N) * G;
  if (cells == 0 || S == 0) return kt::kNothingLaunched;
  const int W = (V1 + 31) / 32;
  uint32_t* g_w = words;
  uint32_t* n_w = g_w + static_cast<size_t>(G) * K * W;
  const long long nw = static_cast<long long>(G + N) * K * W;
  row_words<<<kt::grid_for(nw, 256), 256, 0, stream>>>(
      V1, W, g_mask, static_cast<long long>(G) * K, g_w, n_mask, static_cast<long long>(N) * K,
      n_w, nullptr, 0, nullptr);
  constexpr int kBlock = 128;
  dense_existing<<<kt::grid_for(cells, kBlock), kBlock, 0, stream>>>(
      S, N, G, K, W, R, g_def, g_neg, g_w, g_req, n_def, n_w, n_avail,
      n_base, n_tol, cap_ng);
  return static_cast<int>(cudaGetLastError());
}
