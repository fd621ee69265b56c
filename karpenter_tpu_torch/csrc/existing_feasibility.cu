// Kernel B2: existing-node capacity table over the live-pair index.
//
// Replaces karpenter_tpu/ops/feasibility.py:existing_node_feasibility_sparse
// (an XLA program on the TPU): cap_ng[n,g], how many pods of group g fit
// on existing node n — strict compatibility over the live (group, key)
// pairs (no well-known allowance, existingnode.go:96), then fits_count
// against n_avail - n_base, gated on the node's tolerance row n_tol.
// Under the consolidation scenario axis (ops/solve.py:
// solve_scenarios_core_packed, where JAX's vmap batches only n_tol) n_tol
// is [S, N, G], and so is cap_ng.
//
// Bound on the H100: launch latency. N x G cells (32 x 64 on the
// state-node smoke snapshot, 2048 x 1 on the consolidation one) each read a
// few hundred bytes of masks.
//
// Design: one thread per (n, g), looping over the L live pairs and keeping
// those of its own group — the segment sum of the JAX form, summed in
// one thread, so the integer total is exact. No shared memory, no atomics.
// Compatibility and room do not depend on the scenario, so each thread
// computes them once and writes its S gated values.
#include "common.cuh"

namespace {

__global__ void node_caps(
    int S, int N, int G, int K, int V1, int R, int L,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint8_t* __restrict__ g_mask, const float* __restrict__ g_req,
    const uint8_t* __restrict__ n_def, const uint8_t* __restrict__ n_mask,
    const float* __restrict__ n_avail, const float* __restrict__ n_base,
    const uint8_t* __restrict__ n_tol,
    const int32_t* __restrict__ gk_g, const int32_t* __restrict__ gk_k,
    const int32_t* __restrict__ gk_w, int32_t* __restrict__ cap_ng) {
  const long long total = static_cast<long long>(N) * G;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(i % G);
    const int n = static_cast<int>(i / G);
    int32_t fail = 0;
    for (int l = 0; l < L; ++l) {
      if (gk_g[l] != g) continue;
      const int k = gk_k[l];
      const uint8_t* nm = n_mask + (static_cast<size_t>(n) * K + k) * V1;
      const uint8_t* gm = g_mask + (static_cast<size_t>(g) * K + k) * V1;
      bool ov = false;
      for (int v = 0; v < V1 && !ov; ++v) ov = nm[v] && gm[v];
      const bool ndef = n_def[n * K + k], gdef = g_def[g * K + k];
      const bool term = ov || !(ndef && gdef);
      const bool custom = !gdef || ndef || g_neg[g * K + k];
      if (!(term && custom)) fail = kt::wrap_add(fail, gk_w[l]);
    }
    const int32_t cap =
        fail == 0 ? kt::fits_count(n_avail + static_cast<size_t>(n) * R,
                                   n_base + static_cast<size_t>(n) * R,
                                   g_req + static_cast<size_t>(g) * R, R)
                  : 0;
    for (int s = 0; s < S; ++s)
      cap_ng[s * total + i] = n_tol[s * total + i] ? cap : 0;
  }
}

}  // namespace

extern "C" int kt_existing_feasibility(
    int S, int N, int G, int K, int V1, int R, int L,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* n_def, const uint8_t* n_mask, const float* n_avail,
    const float* n_base, const uint8_t* n_tol,
    const int32_t* gk_g, const int32_t* gk_k, const int32_t* gk_w,
    int32_t* cap_ng, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long cells = static_cast<long long>(N) * G;
  if (cells == 0 || S == 0) return kt::kNothingLaunched;
  constexpr int kBlock = 128;
  node_caps<<<kt::grid_for(cells, kBlock), kBlock, 0, stream>>>(
      S, N, G, K, V1, R, L, g_def, g_neg, g_mask, g_req, n_def, n_mask,
      n_avail, n_base, n_tol, gk_g, gk_k, gk_w, cap_ng);
  return static_cast<int>(cudaGetLastError());
}
