// Kernel B3: the dense feasibility tables, two entries in one library.
//
// Replaces karpenter_tpu/ops/feasibility.py:fresh_claim_feasibility (:84)
// and existing_node_feasibility (:298), the dense twins of B1 and B2 (XLA
// programs on the TPU): the same tables by the full [P, G, T, K, V1]
// requirement join, with no live-pair index. The relaxation pre-solver
// (ops/relax.py:solve_bulk) runs the fresh entry over its easy runs' head
// groups; ops/solve.py runs both when sparse_groups is False.
//
// Bound on the H100: launch latency at the shapes the port runs. The relax
// path's fresh table is CRp x T cells (1 x 400 on an identical batch),
// the ops dense route's P x G x T (64 x 400 on the mixed 50k snapshot);
// each cell reads ~K x W words it shares with its tile and does R float
// divisions in fits_count.
//
// Design: one launch an entry, no global scratch, no atomics. A block owns
// a tile of the table (fresh: one template p, TG groups x TT types;
// existing: TN nodes x TG groups) and runs a short chain of phases, each
// waiting on memory at most once:
//  1. the tile's rows into shared memory, all loads in flight at once and
//     one wait: the bit words of its mask rows, built straight from device
//     memory (dense_feasibility.cuh's row_word, one call site), beside the
//     asynchronous copies (cp.async) of its defined and negated keys,
//     offerings, allocatable and request rows. The fresh entry keeps each
//     group's words merged with p's (p ∧ g, merge_requirements): a key's
//     overlap with the template is then whether its merged words are
//     nonzero, and the claim's type test and offering test read them as
//     they are;
//  2. fresh: compat_pg once per (p, g) of the tile, by one thread a group
//     (compatible_by over the merged words), written by the blocks of the
//     first type tile;
//  3. a cell a thread: fresh, type_compat_by over a type's words and the
//     merged words, offering_ok_by over the merged zone and capacity-type
//     words, fits_count and the fused AND; existing, the strict
//     compatible_by over node and group words and fits_count, written once
//     per scenario gated by n_tol.
// Tiles: fresh 32 types x 8 groups, the groups doubled up to 64 while the
// grid has more than 4 x 132 blocks (104 blocks at 64 x 400, 13 at 1 x
// 400); existing 256 / TG nodes x TG groups, TG the power of two >= G up
// to 32 (8 blocks at 32 nodes x 64 groups).
//
// Wide value vocabularies: shared memory grows with V1 only through the
// words, [TT + TG, K, W] fresh and [TN + TG, K, W] existing (W = V1 / 32);
// past the card's 227 KB the tiles narrow until they fit, and past the
// widest V1 at which one row of each side fits (at K = 16: V1 = 32,768
// fits, V1 = 65,536 does not) the block keeps no words and reads each
// from the byte rows in device memory where it needs it (kRows). Every
// layout computes the same tables, so the entries take any V1.
#include "dense_feasibility.cuh"

namespace {

using kt::bit;
using kt::row_word;
using kt::RowWords;
using kt::words_meet;

constexpr int kBlock = 256;
// the card's 227 KB a block, less a margin
constexpr size_t kSmemMax = 227 * 1024 - 16;

__host__ __device__ inline int words_of(int n) { return (n + 31) / 32; }

// How a block holds its mask rows: as bit words in shared memory
// (kWords), or not at all, every word read from the byte rows in device
// memory where it is needed (kRows).
enum Mode { kWords, kRows };

// the AND of two word rows, word by word: merged p ∧ g words read from
// device memory (kRows), indexing and testing bits like a word array
struct AndWords {
  RowWords a, b;
  __device__ __forceinline__ uint32_t operator[](int w) const { return a[w] & b[w]; }
};

__device__ __forceinline__ bool bit(const AndWords& m, int v) { return bit(m.a, v) && bit(m.b, v); }

// some value slot set in a word row
template <class A>
__device__ __forceinline__ bool any_word(const A& a, int W) {
  for (int w = 0; w < W; ++w)
    if (a[w]) return true;
  return false;
}

// n bytes from device to shared memory by the whole block, out of line
// (one copy of its code for the rows a block stages)
__device__ __noinline__ void stage(void* dst, const void* src, int n) {
  kt::stage_bytes(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src), n, threadIdx.x,
                  kBlock);
}

// The fresh entry's block: its types' words [TT, K, W] and its groups'
// words merged with p's [TG, K, W] (none in kRows), and the staged rows.
// Every array starts 4-byte aligned; the host sizes it with the same
// constructor.
struct FreshSmem {
  uint32_t *tw, *mw;
  int32_t *oz, *oc;
  float *alloc, *daemon, *req;
  uint8_t *tdef, *pdef, *pneg, *gdef, *gneg, *wk, *oa, *tok, *ptol, *compat;
  size_t bytes;

  __host__ __device__ FreshSmem(void* at, int K, int V1, int R, int O, int TG, int TT,
                                Mode mode) {
    char* c = static_cast<char*>(at);
    auto take = [&c](size_t n) { char* p = c; c += (n + 3) & ~size_t{3}; return p; };
    const size_t KW = mode == kRows ? 0 : static_cast<size_t>(K) * words_of(V1);
    tw = reinterpret_cast<uint32_t*>(take(4 * TT * KW));  // [TT, K, W]
    mw = reinterpret_cast<uint32_t*>(take(4 * TG * KW));  // [TG, K, W] p ∧ g
    oz = reinterpret_cast<int32_t*>(take(4 * TT * O));    // [TT, O]
    oc = reinterpret_cast<int32_t*>(take(4 * TT * O));
    alloc = reinterpret_cast<float*>(take(4 * TT * R));   // [TT, R]
    daemon = reinterpret_cast<float*>(take(4 * R));
    req = reinterpret_cast<float*>(take(4 * TG * R));     // [TG, R]
    tdef = reinterpret_cast<uint8_t*>(take(TT * K));
    pdef = reinterpret_cast<uint8_t*>(take(K));
    pneg = reinterpret_cast<uint8_t*>(take(K));
    gdef = reinterpret_cast<uint8_t*>(take(TG * K));
    gneg = reinterpret_cast<uint8_t*>(take(TG * K));
    wk = reinterpret_cast<uint8_t*>(take(K));
    oa = reinterpret_cast<uint8_t*>(take(TT * O));
    tok = reinterpret_cast<uint8_t*>(take(TT));
    ptol = reinterpret_cast<uint8_t*>(take(TG));
    compat = reinterpret_cast<uint8_t*>(take(TG));
    bytes = static_cast<size_t>(c - static_cast<char*>(at));
  }
};

// The existing entry's block: its nodes' and groups' words [TN, K, W] and
// [TG, K, W] (none in kRows), and the staged rows.
struct ExistSmem {
  uint32_t *nw, *gw;
  float *avail, *base, *req;
  uint8_t *ndef, *gdef, *gneg;
  size_t bytes;

  __host__ __device__ ExistSmem(void* at, int K, int V1, int R, int TN, int TG, Mode mode) {
    char* c = static_cast<char*>(at);
    auto take = [&c](size_t n) { char* p = c; c += (n + 3) & ~size_t{3}; return p; };
    const size_t KW = mode == kRows ? 0 : static_cast<size_t>(K) * words_of(V1);
    nw = reinterpret_cast<uint32_t*>(take(4 * TN * KW));  // [TN, K, W]
    gw = reinterpret_cast<uint32_t*>(take(4 * TG * KW));  // [TG, K, W]
    avail = reinterpret_cast<float*>(take(4 * TN * R));   // [TN, R]
    base = reinterpret_cast<float*>(take(4 * TN * R));
    req = reinterpret_cast<float*>(take(4 * TG * R));     // [TG, R]
    ndef = reinterpret_cast<uint8_t*>(take(TN * K));
    gdef = reinterpret_cast<uint8_t*>(take(TG * K));
    gneg = reinterpret_cast<uint8_t*>(take(TG * K));
    bytes = static_cast<size_t>(c - static_cast<char*>(at));
  }
};

// The mode of a block whose shared memory is bytes(mode) at tiles (A, B):
// kWords, narrowing A (then B) by halves to 1 while it passes the card;
// else kRows at the tiles it started with.
template <class Bytes>
Mode pick_mode(int& A, int& B, const Bytes& bytes) {
  const int A0 = A, B0 = B;
  while (bytes(kWords) > kSmemMax && (A > 1 || B > 1)) {
    if (A > 1) A >>= 1;
    else B >>= 1;
  }
  if (bytes(kWords) <= kSmemMax) return kWords;
  A = A0, B = B0;
  return kRows;
}

void fresh_tiling(int P, int G, int T, int K, int V1, int R, int O, int& TT, int& TG,
                  Mode& mode) {
  TT = 32, TG = 8;
  auto blocks = [&] {
    return static_cast<long long>(P) * ((G + TG - 1) / TG) * (T > 0 ? (T + TT - 1) / TT : 1);
  };
  while (blocks() > 4 * 132 && TG < 64) TG <<= 1;
  mode = pick_mode(TT, TG, [&](Mode m) {
    return FreshSmem(nullptr, K, V1, R, O, TG, TT, m).bytes;
  });
}

void exist_tiling(int N, int G, int K, int V1, int R, int& TN, int& TG, Mode& mode) {
  TG = 1;
  while (TG < G && TG < 32) TG <<= 1;
  TN = kBlock / TG;
  mode = pick_mode(TN, TG, [&](Mode m) { return ExistSmem(nullptr, K, V1, R, TN, TG, m).bytes; });
}

// fits_count of a cell, its R loop unrolled where R is 5 (the encoder's
// resources) so that the R divisions overlap
__device__ __forceinline__ int32_t cell_fits(const float* alloc, const float* base,
                                             const float* req, int R) {
  return R == 5 ? kt::fits_count(alloc, base, req, 5) : kt::fits_count(alloc, base, req, R);
}

template <Mode M>
__global__ void __launch_bounds__(kBlock) dense_fresh(
    int G, int T, int K, int V1, int R, int O, int TG, int TT, int zone_kid, int ct_kid, bool x4,
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FreshSmem s(smem_raw, K, V1, R, O, TG, TT, M);
  const int W = words_of(V1), KW = K * W, tid = threadIdx.x;
  const int t0 = blockIdx.x * TT, g0 = blockIdx.y * TG, p = blockIdx.z;
  const int nt = max(0, min(TT, T - t0)), ng = min(TG, G - g0);
  auto row = [&](const uint8_t* mask, size_t r) { return RowWords{mask + r * V1, V1, x4}; };
  // key k's words of the tile's type t, and of its group gl merged with p's
  auto t_words = [&](int t, int k) {
    if constexpr (M == kRows) return row(t_mask, static_cast<size_t>(t0 + t) * K + k);
    else return static_cast<const uint32_t*>(s.tw + (t * K + k) * W);
  };
  auto m_words = [&](int gl, int k) {
    if constexpr (M == kRows)
      return AndWords{row(p_mask, static_cast<size_t>(p) * K + k),
                      row(g_mask, static_cast<size_t>(g0 + gl) * K + k)};
    else return static_cast<const uint32_t*>(s.mw + (gl * K + k) * W);
  };

  // 1. the tile's rows, one wait: the words straight from device memory
  //    (their loads in flight beside the copies), the rest by cp.async
  stage(s.tdef, t_def + static_cast<size_t>(t0) * K, nt * K);
  stage(s.oa, o_avail + static_cast<size_t>(t0) * O, nt * O);
  stage(s.oz, o_zone + static_cast<size_t>(t0) * O, 4 * nt * O);
  stage(s.oc, o_ct + static_cast<size_t>(t0) * O, 4 * nt * O);
  stage(s.alloc, t_alloc + static_cast<size_t>(t0) * R, 4 * nt * R);
  stage(s.tok, p_titype_ok + static_cast<size_t>(p) * T + t0, nt);
  stage(s.pdef, p_def + static_cast<size_t>(p) * K, K);
  stage(s.pneg, p_neg + static_cast<size_t>(p) * K, K);
  stage(s.daemon, p_daemon + static_cast<size_t>(p) * R, 4 * R);
  stage(s.gdef, g_def + static_cast<size_t>(g0) * K, ng * K);
  stage(s.gneg, g_neg + static_cast<size_t>(g0) * K, ng * K);
  stage(s.req, g_req + static_cast<size_t>(g0) * R, 4 * ng * R);
  stage(s.ptol, p_tol + static_cast<size_t>(p) * G + g0, ng);
  stage(s.wk, well_known, K);
  if constexpr (M == kWords) {
    // four words a trip, so that a thread's loads are in flight together
    const int e0 = nt * KW, e1 = e0 + ng * KW;
#pragma unroll 4
    for (int i = tid; i < e1; i += kBlock) {
      if (i < e0) {
        s.tw[i] = row_word(t_mask + (static_cast<size_t>(t0) * K + i / W) * V1, V1, i % W, x4);
      } else {
        const int j = i - e0, k = (j / W) % K;
        s.mw[j] = row_word(g_mask + (static_cast<size_t>(g0) * K + j / W) * V1, V1, j % W, x4) &
                  row_word(p_mask + (static_cast<size_t>(p) * K + k) * V1, V1, j % W, x4);
      }
    }
  }
  kt::cp_async_wait_all();
  __syncthreads();

  // 2. compat_pg once per (p, g): a key overlaps the template where its
  //    merged words are nonzero
#pragma unroll 1
  for (int gl = tid; gl < ng; gl += kBlock) {
    const bool ok = s.ptol[gl] &&
                    kt::compatible_by(s.pdef, s.pneg, s.gdef + gl * K, s.gneg + gl * K, s.wk, K,
                                      [&](int k) { return any_word(m_words(gl, k), W); });
    s.compat[gl] = ok;
    if (blockIdx.x == 0) compat_pg[static_cast<size_t>(p) * G + g0 + gl] = ok;
  }
  __syncthreads();

  // 3. a cell a thread
#pragma unroll 1
  for (int i = tid; i < ng * TT; i += kBlock) {
    const int gl = i / TT, t = i % TT;
    if (t >= nt) continue;
    const int32_t nf = cell_fits(s.alloc + t * R, s.daemon, s.req + gl * R, R);
    bool ok = nf >= 1 && s.tok[t] && s.compat[gl];
    if (ok) {
      ok = kt::type_compat_by(s.tdef + t * K, s.pdef, s.gdef + gl * K, K, [&](int k) {
        return words_meet(t_words(t, k), m_words(gl, k), W);
      });
    }
    if (ok) {
      const auto mz = m_words(gl, zone_kid);
      const auto mc = m_words(gl, ct_kid);
      ok = kt::offering_ok_by(s.oa + t * O, s.oz + t * O, s.oc + t * O, O,
                              [&](int z) { return bit(mz, z); },
                              [&](int c) { return bit(mc, c); });
    }
    const size_t at = (static_cast<size_t>(p) * G + g0 + gl) * T + t0 + t;
    n_fit[at] = nf;
    type_ok[at] = ok;
  }
}

template <Mode M>
__global__ void __launch_bounds__(kBlock) dense_existing(
    int S, int N, int G, int K, int V1, int R, int TN, int TG, bool x4,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint8_t* __restrict__ g_mask, const float* __restrict__ g_req,
    const uint8_t* __restrict__ n_def, const uint8_t* __restrict__ n_mask,
    const float* __restrict__ n_avail, const float* __restrict__ n_base,
    const uint8_t* __restrict__ n_tol, int32_t* __restrict__ cap_ng) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ExistSmem s(smem_raw, K, V1, R, TN, TG, M);
  const int W = words_of(V1), KW = K * W, tid = threadIdx.x;
  const int g0 = blockIdx.x * TG, n0 = blockIdx.y * TN;
  const int ng = min(TG, G - g0), nn = min(TN, N - n0);
  auto row = [&](const uint8_t* mask, size_t r) { return RowWords{mask + r * V1, V1, x4}; };
  auto n_words = [&](int nl, int k) {
    if constexpr (M == kRows) return row(n_mask, static_cast<size_t>(n0 + nl) * K + k);
    else return static_cast<const uint32_t*>(s.nw + (nl * K + k) * W);
  };
  auto g_words = [&](int gl, int k) {
    if constexpr (M == kRows) return row(g_mask, static_cast<size_t>(g0 + gl) * K + k);
    else return static_cast<const uint32_t*>(s.gw + (gl * K + k) * W);
  };

  // 1. the tile's rows, one wait: the words straight from device memory,
  //    the rest by cp.async
  stage(s.ndef, n_def + static_cast<size_t>(n0) * K, nn * K);
  stage(s.avail, n_avail + static_cast<size_t>(n0) * R, 4 * nn * R);
  stage(s.base, n_base + static_cast<size_t>(n0) * R, 4 * nn * R);
  stage(s.gdef, g_def + static_cast<size_t>(g0) * K, ng * K);
  stage(s.gneg, g_neg + static_cast<size_t>(g0) * K, ng * K);
  stage(s.req, g_req + static_cast<size_t>(g0) * R, 4 * ng * R);
  if constexpr (M == kWords) {
    const int e0 = nn * KW, e1 = e0 + ng * KW;
#pragma unroll 4
    for (int i = tid; i < e1; i += kBlock) {
      const bool node = i < e0;
      const int j = node ? i : i - e0;
      const uint8_t* r = node ? n_mask + (static_cast<size_t>(n0) * K + j / W) * V1
                              : g_mask + (static_cast<size_t>(g0) * K + j / W) * V1;
      (node ? s.nw : s.gw)[j] = row_word(r, V1, j % W, x4);
    }
  }
  kt::cp_async_wait_all();
  __syncthreads();

  // 2. a cell a thread: strict compatibility (a node's labels are never
  //    negated and get no well-known allowance), its room, S gated writes
  const long long NG = static_cast<long long>(N) * G;
#pragma unroll 1
  for (int i = tid; i < nn * TG; i += kBlock) {
    const int nl = i / TG, gl = i % TG;
    if (gl >= ng) continue;
    const bool compat = kt::compatible_by(s.ndef + nl * K, nullptr, s.gdef + gl * K,
                                          s.gneg + gl * K, nullptr, K, [&](int k) {
                                            return words_meet(n_words(nl, k), g_words(gl, k), W);
                                          });
    const int32_t cap = compat ? cell_fits(s.avail + nl * R, s.base + nl * R, s.req + gl * R, R)
                               : 0;
    const long long at = static_cast<long long>(n0 + nl) * G + g0 + gl;
    for (int sc = 0; sc < S; ++sc) cap_ng[sc * NG + at] = n_tol[sc * NG + at] ? cap : 0;
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
  if (static_cast<long long>(P) * G == 0) return kt::kNothingLaunched;
  int TT, TG;
  Mode mode;
  fresh_tiling(P, G, T, K, V1, R, O, TT, TG, mode);
  const size_t smem = FreshSmem(nullptr, K, V1, R, O, TG, TT, mode).bytes;
  auto kernel = mode == kWords ? dense_fresh<kWords> : dense_fresh<kRows>;
  const int rc = kt::allow_dynamic_smem(kernel, smem);
  if (rc) return rc;
  const bool x4 = V1 % 4 == 0 && (reinterpret_cast<uintptr_t>(g_mask) |
                                  reinterpret_cast<uintptr_t>(p_mask) |
                                  reinterpret_cast<uintptr_t>(t_mask)) % 4 == 0;
  // with T == 0 one column of blocks still writes compat_pg
  const dim3 grid(T > 0 ? (T + TT - 1) / TT : 1, (G + TG - 1) / TG, P);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      G, T, K, V1, R, O, TG, TT, zone_kid, ct_kid, x4, g_def, g_neg, g_mask, g_req, p_def,
      p_neg, p_mask, p_daemon, p_tol, p_titype_ok, t_def, t_mask, t_alloc, o_avail, o_zone,
      o_ct, well_known, compat_pg, type_ok, n_fit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kt_dense_existing(
    int S, int N, int G, int K, int V1, int R,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* n_def, const uint8_t* n_mask, const float* n_avail,
    const float* n_base, const uint8_t* n_tol,
    int32_t* cap_ng, void* stream_ptr) {
  if (static_cast<long long>(N) * G == 0 || S == 0) return kt::kNothingLaunched;
  int TN, TG;
  Mode mode;
  exist_tiling(N, G, K, V1, R, TN, TG, mode);
  const size_t smem = ExistSmem(nullptr, K, V1, R, TN, TG, mode).bytes;
  auto kernel = mode == kWords ? dense_existing<kWords> : dense_existing<kRows>;
  const int rc = kt::allow_dynamic_smem(kernel, smem);
  if (rc) return rc;
  const bool x4 = V1 % 4 == 0 && (reinterpret_cast<uintptr_t>(g_mask) |
                                  reinterpret_cast<uintptr_t>(n_mask)) % 4 == 0;
  const dim3 grid((G + TG - 1) / TG, (N + TN - 1) / TN);
  kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      S, N, G, K, V1, R, TN, TG, x4, g_def, g_neg, g_mask, g_req, n_def, n_mask, n_avail,
      n_base, n_tol, cap_ng);
  return static_cast<int>(cudaGetLastError());
}

// The tiles and mode each entry takes at these shapes, for the wrappers'
// telemetry: fresh (``N`` < 0: G, T, P as given) or existing (N nodes):
// writes the two tiles (fresh TT, TG; existing TN, TG), the mode (0
// words, 1 rows) and the block's shared memory bytes to ``out`` [4].
extern "C" int kt_dense_layout(int P, int N, int G, int T, int K, int V1, int R, int O,
                               long long* out) {
  int A, B;
  Mode mode;
  size_t bytes;
  if (N < 0) {
    fresh_tiling(P, G, T, K, V1, R, O, A, B, mode);
    bytes = FreshSmem(nullptr, K, V1, R, O, B, A, mode).bytes;
  } else {
    exist_tiling(N, G, K, V1, R, A, B, mode);
    bytes = ExistSmem(nullptr, K, V1, R, A, B, mode).bytes;
  }
  out[0] = A, out[1] = B, out[2] = mode, out[3] = static_cast<long long>(bytes);
  return 0;
}
