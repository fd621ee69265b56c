// Kernel B1: fresh-claim feasibility tables over the live-pair index.
//
// Replaces karpenter_tpu/ops/feasibility.py:fresh_claim_feasibility_sparse
// (an XLA program on the TPU). For every template p, pod group g and
// instance type t: compat_pg[p,g], type_ok[p,g,t], n_fit[p,g,t].
//
// Bound on the H100: memory and launch latency. At the mixed 50k x 400
// cell (P=1, G=64, T=400, K=16, V1=4) it reads ~150 KB of masks and
// writes ~130 KB of tables; every term is a few byte loads and ANDs, and
// the only float work is R divisions per (p,g,t) in fits_count.
//
// Design: three launches on one stream, no host sync.
//  1. zero the [P,G,T] correction and [P,G] compat-failure counters;
//  2. one thread per (p, live pair l, t) (plus t == T for the pod-vs-
//     template term): the exact merged term minus the group-independent
//     base term, times the pair weight, added onto group gk_g[l] with an
//     integer atomicAdd — integer sums are exact in any order, so the
//     result is the JAX segment_sum whatever the interleaving;
//  3. one thread per (p,g,t): base failures over K (value-slot overlap as
//     a byte AND loop, no float matmul), plus the corrections, the
//     offering row (merged with the group's zone/ct row only for groups
//     listed in goff_idx, exactly as the JAX scatter), fits_count and the
//     fused type_ok AND.
#include "common.cuh"

namespace {

using kt::fits_count;

__device__ __forceinline__ bool any_and(const uint8_t* a, const uint8_t* b, int V1) {
  for (int v = 0; v < V1; ++v)
    if (a[v] && b[v]) return true;
  return false;
}

__global__ void pair_corrections(
    int P, int G, int T, int K, int V1, int L,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint8_t* __restrict__ g_mask,
    const uint8_t* __restrict__ p_def, const uint8_t* __restrict__ p_neg,
    const uint8_t* __restrict__ p_mask,
    const uint8_t* __restrict__ t_def, const uint8_t* __restrict__ t_mask,
    const uint8_t* __restrict__ well_known,
    const int32_t* __restrict__ gk_g, const int32_t* __restrict__ gk_k,
    const int32_t* __restrict__ gk_w,
    int32_t* __restrict__ adj, int32_t* __restrict__ cfail) {
  const long long total = static_cast<long long>(P) * L * (T + 1);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(i % (T + 1));
    const int l = static_cast<int>((i / (T + 1)) % L);
    const int p = static_cast<int>(i / (static_cast<long long>(T + 1) * L));
    const int32_t w = gk_w[l];
    if (w == 0) continue;
    const int g = gk_g[l], k = gk_k[l];
    const uint8_t* gm = g_mask + (static_cast<size_t>(g) * K + k) * V1;
    const uint8_t* pm = p_mask + (static_cast<size_t>(p) * K + k) * V1;
    const bool gdef = g_def[g * K + k], pdef = p_def[p * K + k];
    if (t < T) {
      const uint8_t* tm = t_mask + (static_cast<size_t>(t) * K + k) * V1;
      bool ov3 = false, ovb = false;
      for (int v = 0; v < V1; ++v) {
        ov3 = ov3 || (tm[v] && gm[v] && pm[v]);
        ovb = ovb || (tm[v] && pm[v]);
      }
      const bool tdef = t_def[t * K + k];
      const int pair_fail = !(ov3 || !(tdef && (pdef || gdef)));
      const int base_fail = !(ovb || !(tdef && pdef));
      const int32_t delta = kt::wrap_mul(pair_fail - base_fail, w);
      if (delta != 0)
        atomicAdd(adj + (static_cast<size_t>(p) * G + g) * T + t, delta);
    } else {
      const bool gneg = g_neg[g * K + k], pneg = p_neg[p * K + k];
      const bool term = any_and(pm, gm, V1) || (pneg && gneg) || !(pdef && gdef);
      const bool custom = !gdef || well_known[k] || pdef || gneg;
      if (!(term && custom)) atomicAdd(cfail + static_cast<size_t>(p) * G + g, w);
    }
  }
}

__global__ void tables(
    int P, int G, int T, int K, int V1, int R, int O, int LZ,
    int zone_kid, int ct_kid,
    const uint8_t* __restrict__ g_mask, const float* __restrict__ g_req,
    const uint8_t* __restrict__ p_def, const uint8_t* __restrict__ p_mask,
    const float* __restrict__ p_daemon, const uint8_t* __restrict__ p_tol,
    const uint8_t* __restrict__ p_titype_ok,
    const uint8_t* __restrict__ t_def, const uint8_t* __restrict__ t_mask,
    const float* __restrict__ t_alloc,
    const uint8_t* __restrict__ o_avail, const int32_t* __restrict__ o_zone,
    const int32_t* __restrict__ o_ct,
    const int32_t* __restrict__ goff_idx,
    const int32_t* __restrict__ adj, const int32_t* __restrict__ cfail,
    uint8_t* __restrict__ compat_pg, uint8_t* __restrict__ type_ok,
    int32_t* __restrict__ n_fit) {
  // with T == 0 one thread per (p,g) still writes compat_pg
  const int TT = T > 0 ? T : 1;
  const long long total = static_cast<long long>(P) * G * TT;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(i % TT);
    const int g = static_cast<int>((i / TT) % G);
    const int p = static_cast<int>(i / (static_cast<long long>(TT) * G));
    const size_t pg = static_cast<size_t>(p) * G + g;
    const bool compat = p_tol[pg] && cfail[pg] == 0;
    if (t == 0) compat_pg[pg] = compat;
    if (T == 0) continue;
    // group-independent base: template vs type, all K keys
    int32_t fails = 0;
    for (int k = 0; k < K; ++k) {
      const bool ov = any_and(t_mask + (static_cast<size_t>(t) * K + k) * V1,
                              p_mask + (static_cast<size_t>(p) * K + k) * V1, V1);
      fails += !(ov || !(t_def[t * K + k] && p_def[p * K + k]));
    }
    const bool tc = kt::wrap_add(fails, adj[pg * T + t]) == 0;
    // offering row: merged with the group's zone/ct rows for listed groups
    bool merged = false;
    for (int j = 0; j < LZ && !merged; ++j) merged = goff_idx[j] == g;
    const uint8_t* pz = p_mask + (static_cast<size_t>(p) * K + zone_kid) * V1;
    const uint8_t* pc = p_mask + (static_cast<size_t>(p) * K + ct_kid) * V1;
    const uint8_t* gz = g_mask + (static_cast<size_t>(g) * K + zone_kid) * V1;
    const uint8_t* gc = g_mask + (static_cast<size_t>(g) * K + ct_kid) * V1;
    bool off = false;
    for (int o = 0; o < O && !off; ++o) {
      if (!o_avail[t * O + o]) continue;
      const int32_t z = o_zone[t * O + o], c = o_ct[t * O + o];
      const int zi = max(z, 0), ci = max(c, 0);
      const bool z_ok = (z < 0) || (pz[zi] && (!merged || gz[zi]));
      const bool c_ok = (c < 0) || (pc[ci] && (!merged || gc[ci]));
      off = z_ok && c_ok;
    }
    const int32_t nf = fits_count(t_alloc + static_cast<size_t>(t) * R,
                                  p_daemon + static_cast<size_t>(p) * R,
                                  g_req + static_cast<size_t>(g) * R, R);
    n_fit[pg * T + t] = nf;
    type_ok[pg * T + t] =
        tc && off && nf >= 1 && p_titype_ok[static_cast<size_t>(p) * T + t] && compat;
  }
}

}  // namespace

extern "C" int kt_fresh_feasibility(
    int P, int G, int T, int K, int V1, int R, int O, int L, int LZ,
    int zone_kid, int ct_kid,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* p_def, const uint8_t* p_neg, const uint8_t* p_mask,
    const float* p_daemon, const uint8_t* p_tol, const uint8_t* p_titype_ok,
    const uint8_t* t_def, const uint8_t* t_mask, const float* t_alloc,
    const uint8_t* o_avail, const int32_t* o_zone, const int32_t* o_ct,
    const uint8_t* well_known,
    const int32_t* gk_g, const int32_t* gk_k, const int32_t* gk_w,
    const int32_t* goff_idx,
    int32_t* adj, int32_t* cfail,
    uint8_t* compat_pg, uint8_t* type_ok, int32_t* n_fit,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long cells = static_cast<long long>(P) * G * T;
  if (static_cast<long long>(P) * G == 0) return kt::kNothingLaunched;
  if (cells > 0) cudaMemsetAsync(adj, 0, sizeof(int32_t) * cells, stream);
  cudaMemsetAsync(cfail, 0, sizeof(int32_t) * P * G, stream);
  constexpr int kBlock = 256;
  const long long pairs = static_cast<long long>(P) * L * (T + 1);
  if (pairs > 0) {
    pair_corrections<<<kt::grid_for(pairs, kBlock), kBlock, 0, stream>>>(
        P, G, T, K, V1, L, g_def, g_neg, g_mask, p_def, p_neg, p_mask, t_def,
        t_mask, well_known, gk_g, gk_k, gk_w, adj, cfail);
  }
  tables<<<kt::grid_for(cells > 0 ? cells : P * G, kBlock), kBlock, 0, stream>>>(
      P, G, T, K, V1, R, O, LZ, zone_kid, ct_kid, g_mask, g_req, p_def, p_mask,
      p_daemon, p_tol, p_titype_ok, t_def, t_mask, t_alloc, o_avail, o_zone,
      o_ct, goff_idx, adj, cfail, compat_pg, type_ok, n_fit);
  return static_cast<int>(cudaGetLastError());
}
