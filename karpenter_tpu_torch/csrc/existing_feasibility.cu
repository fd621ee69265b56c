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
// state-node smoke snapshot, 2048 x G at the consolidation chunk) each
// read a few dozen bytes and write S int32.
//
// Design: one launch. A block owns a tile of TN nodes x TG groups (TG the
// power of two >= G up to 32, TN = 256 / TG, halved while the grid has
// fewer than 132 blocks or the node words pass 32 KB: 32 nodes x 64
// groups take TG 32, TN 1, 64 blocks; the consolidation chunk's 2048 x 1,
// TG 1, TN 8, 256 blocks) and keeps in shared memory its nodes' mask rows
// as bit words (dense_feasibility.cuh), built in the launch, and a [TN, TG]
// failure count. The live pairs (nonzero weight) of its groups are
// gathered from the index in chunks of 256, in any order, and each
// (pair, node) adds its weight onto its (node, group) count by a
// shared-memory integer atomic (int32 wraps; exact in any order): work
// O(N x L + N x G x R), each cell seeing only its own group's pairs.
// Compatibility and room do not depend on the scenario, so each cell
// computes them once and writes its S gated values. A wide value
// vocabulary (the words of the nodes and of a chunk of 256 pairs past the
// card's 227 KB: at K = 16 from V1 = 8,192) narrows the nodes, then the
// pair chunk, to 1; past even that (at K = 16, V1 = 131,072) the block
// keeps no words and reads each from the byte rows in device memory where
// it needs it. Every layout computes the same table.
//
// Partial mode (kt_existing_feasibility_partial, the solver mesh's data
// shards; the existing-node half of karpenter_tpu/parallel/mesh.py's
// GSPMD partition): the same kernel over one data shard's live pairs,
// unfinished: each cell's int32 failure count nfail and, on the shard
// that adds the base (data shard 0), the node's fits cap. The fold
// (mesh_fold.cu) sums the shards' counts and gates each scenario with the
// same device function as this kernel's finish (tables_finish.cuh).
#include "dense_feasibility.cuh"
#include "tables_finish.cuh"

namespace {

using kt::row_word;
using kt::RowWords;

constexpr int kBlock = 256;
constexpr int kDefBit = 1 << 30, kNegBit = 1 << 29;  // a gathered pair's key | flags
constexpr size_t kNodeWords = 32 * 1024;
// the card's 227 KB a block, less a margin for the static n_pairs
constexpr size_t kSmemMax = 227 * 1024 - 16;

__host__ __device__ inline size_t smem_bytes(int K, int W, int TN, int TG, int PC) {
  // node words [TN, K, W], pair words [PC, W], fail counts [TN, TG],
  // pair group/key/weight [PC] each, node defs [TN, K]
  return 4u * (static_cast<size_t>(TN) * K * W + static_cast<size_t>(PC) * W + TN * TG +
               3 * PC) +
         static_cast<size_t>(TN) * K;
}

// ``kRows``: the block keeps no mask words (a value vocabulary too wide
// for even one node's and one pair's words), every word read from the
// byte rows in device memory where it is needed; ``PC`` live pairs a
// gathering pass. ``kPart``: the partial mode (nfail, and the fits cap
// where ``with_base``, written in place of cap_ng).
template <bool kRows, bool kPart>
__global__ void __launch_bounds__(kBlock) node_caps(
    int S, int N, int G, int K, int V1, int R, int L, int TN, int TG, int PC, bool x4,
    bool with_base,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint8_t* __restrict__ g_mask, const float* __restrict__ g_req,
    const uint8_t* __restrict__ n_def, const uint8_t* __restrict__ n_mask,
    const float* __restrict__ n_avail, const float* __restrict__ n_base,
    const uint8_t* __restrict__ n_tol,
    const int32_t* __restrict__ gk_g, const int32_t* __restrict__ gk_k,
    const int32_t* __restrict__ gk_w, int32_t* __restrict__ cap_ng,
    int32_t* __restrict__ nfail_out, int32_t* __restrict__ cap_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int n_pairs;
  const int W = (V1 + 31) / 32, Ws = kRows ? 0 : W;
  uint32_t* nw = reinterpret_cast<uint32_t*>(smem_raw);  // [TN, K, W]
  uint32_t* pair_w = nw + static_cast<size_t>(TN) * K * Ws;  // [PC, W]
  int32_t* nfail = reinterpret_cast<int32_t*>(pair_w + PC * Ws);  // [TN, TG]
  int32_t* pair_g = nfail + TN * TG;
  int32_t* pair_k = pair_g + PC;
  int32_t* pair_wt = pair_k + PC;
  uint8_t* ndef = reinterpret_cast<uint8_t*>(pair_wt + PC);  // [TN, K]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TN, g0 = blockIdx.y * TG;
  const int nn = min(TN, N - n0), ng = min(TG, G - g0);
  const int KW = K * W;
  auto row = [&](const uint8_t* mask, size_t r) { return RowWords{mask + r * V1, V1, x4}; };
  // key k's words of the tile's node nl, and the gathered pair j's
  auto n_words = [&](int nl, int k) {
    if constexpr (kRows) return row(n_mask, static_cast<size_t>(n0 + nl) * K + k);
    else return static_cast<const uint32_t*>(nw + nl * KW + k * W);
  };
  auto pair_words = [&](int j) {
    if constexpr (kRows)
      return row(g_mask, static_cast<size_t>(g0 + pair_g[j]) * K + (pair_k[j] & (kNegBit - 1)));
    else return static_cast<const uint32_t*>(pair_w + j * W);
  };

  if constexpr (!kRows) {
#pragma unroll 1
    for (int i = tid; i < nn * KW; i += kBlock)
      nw[i] = row_word(n_mask + (static_cast<size_t>(n0) * K + i / W) * V1, V1, i % W, x4);
  }
#pragma unroll 1
  for (int i = tid; i < nn * K; i += kBlock) ndef[i] = n_def[static_cast<size_t>(n0) * K + i];
#pragma unroll 1
  for (int i = tid; i < TN * TG; i += kBlock) nfail[i] = 0;

#pragma unroll 1
  for (int c0 = 0; c0 < L; c0 += PC) {
    if (tid == 0) n_pairs = 0;
    __syncthreads();
    const int l = c0 + tid;
    if (tid < PC && l < L) {
      const int32_t w = gk_w[l];
      const int g = gk_g[l];
      if (w != 0 && g >= g0 && g < g0 + ng) {
        const int k = gk_k[l];
        const int j = atomicAdd(&n_pairs, 1);
        const size_t gk = static_cast<size_t>(g) * K + k;
        if constexpr (!kRows)
          for (int v = 0; v < W; ++v) pair_w[j * W + v] = row_word(g_mask + gk * V1, V1, v, x4);
        pair_g[j] = g - g0;
        pair_k[j] = k | (g_def[gk] ? kDefBit : 0) | (g_neg[gk] ? kNegBit : 0);
        pair_wt[j] = w;
      }
    }
    __syncthreads();
    const int np = n_pairs;
#pragma unroll 1
    for (int i = tid; i < np * nn; i += kBlock) {
      const int j = i / nn, nl = i % nn;
      const int k = pair_k[j] & (kNegBit - 1);
      const bool gdef = pair_k[j] & kDefBit, gneg = pair_k[j] & kNegBit;
      const bool nd = ndef[nl * K + k];
      const bool term = kt::words_meet(n_words(nl, k), pair_words(j), W) || !(nd && gdef);
      const bool custom = !gdef || nd || gneg;
      if (!(term && custom)) atomicAdd(&nfail[nl * TG + pair_g[j]], pair_wt[j]);
    }
    __syncthreads();
  }
  __syncthreads();

  const long long cells = static_cast<long long>(N) * G;
#pragma unroll 1
  for (int i = tid; i < nn * TG; i += kBlock) {
    const int nl = i / TG, gl = i % TG;
    if (gl >= ng) continue;
    const int n = n0 + nl, g = g0 + gl;
    const long long at = static_cast<long long>(n) * G + g;
    auto fits = [&] {
      return kt::fits_count(n_avail + static_cast<size_t>(n) * R,
                            n_base + static_cast<size_t>(n) * R,
                            g_req + static_cast<size_t>(g) * R, R);
    };
    if constexpr (kPart) {
      nfail_out[at] = nfail[i];
      if (with_base) cap_out[at] = fits();
      continue;
    }
    // compatibility and room do not depend on the scenario: the fits only
    // where no pair failed, each scenario gated on its n_tol
    const int32_t cap = nfail[i] == 0 ? fits() : 0;
#pragma unroll 4
    for (int s = 0; s < S; ++s)
      cap_ng[s * cells + at] = kt::node_cap(nfail[i], n_tol[s * cells + at], cap);
  }
}

// One launch of node_caps, whole (kPart false) or partial.
template <bool kPart>
int launch_existing(int S, int N, int G, int K, int V1, int R, int L, bool with_base,
                    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
                    const float* g_req, const uint8_t* n_def, const uint8_t* n_mask,
                    const float* n_avail, const float* n_base, const uint8_t* n_tol,
                    const int32_t* gk_g, const int32_t* gk_k, const int32_t* gk_w,
                    int32_t* cap_ng, int32_t* nfail, int32_t* cap, void* stream_ptr) {
  if (static_cast<long long>(N) * G == 0 || S == 0) return kt::kNothingLaunched;
  const int W = (V1 + 31) / 32;
  int TG = 1;
  while (TG < G && TG < 32) TG <<= 1;
  // TN nodes a block: 256 / TG, halved while the grid has fewer than 132
  // blocks (a block's loads are its latency) or the node words pass 32 KB
  int TN = kBlock / TG;
  const long long g_tiles = (G + TG - 1) / TG;
  while (TN > 1 && (g_tiles * ((N + TN - 1) / TN) < 132 ||
                    4u * static_cast<size_t>(TN) * K * W > kNodeWords))
    TN >>= 1;
  // past the card's 227 KB (a wide value vocabulary): the nodes, then the
  // pair chunk, narrowed to 1; past that no words kept (kRows)
  int PC = kBlock;
  while (smem_bytes(K, W, TN, TG, PC) > kSmemMax && (TN > 1 || PC > 1)) {
    if (TN > 1) TN >>= 1;
    else PC >>= 1;
  }
  const bool rows = smem_bytes(K, W, TN, TG, PC) > kSmemMax;
  if (rows) PC = kBlock;
  const size_t smem = smem_bytes(K, rows ? 0 : W, TN, TG, PC);
  auto kernel = rows ? node_caps<true, kPart> : node_caps<false, kPart>;
  const int rc = kt::allow_dynamic_smem(kernel, smem);  // very wide masks: past 48 KB
  if (rc) return rc;
  const bool x4 = V1 % 4 == 0 && reinterpret_cast<uintptr_t>(n_mask) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(g_mask) % 4 == 0;
  const dim3 grid((N + TN - 1) / TN, (G + TG - 1) / TG);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      S, N, G, K, V1, R, L, TN, TG, PC, x4, with_base, g_def, g_neg, g_mask, g_req, n_def,
      n_mask, n_avail, n_base, n_tol, gk_g, gk_k, gk_w, cap_ng, nfail, cap);
  return static_cast<int>(cudaGetLastError());
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
  return launch_existing<false>(S, N, G, K, V1, R, L, true, g_def, g_neg, g_mask, g_req, n_def,
                                n_mask, n_avail, n_base, n_tol, gk_g, gk_k, gk_w, cap_ng,
                                nullptr, nullptr, stream_ptr);
}

// The partial mode over one data shard's live pairs (L, gk_*): nfail
// [N, G] and, with ``with_base``, cap [N, G] (else it may be null). No
// n_tol: the fold gates the scenarios.
extern "C" int kt_existing_feasibility_partial(
    int N, int G, int K, int V1, int R, int L, int with_base,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* n_def, const uint8_t* n_mask, const float* n_avail,
    const float* n_base,
    const int32_t* gk_g, const int32_t* gk_k, const int32_t* gk_w,
    int32_t* nfail, int32_t* cap, void* stream_ptr) {
  return launch_existing<true>(1, N, G, K, V1, R, L, with_base != 0, g_def, g_neg, g_mask, g_req,
                               n_def, n_mask, n_avail, n_base, nullptr, gk_g, gk_k, gk_w, nullptr,
                               nfail, cap, stream_ptr);
}
