// Kernel B1: fresh-claim feasibility tables over the live-pair index.
//
// Replaces karpenter_tpu/ops/feasibility.py:fresh_claim_feasibility_sparse
// (an XLA program on the TPU). For every template p, pod group g and
// instance type t: compat_pg[p,g], type_ok[p,g,t], n_fit[p,g,t].
//
// Bound on the H100: memory and launch latency. At diverse-ref (P=1,
// G=2048, T=400) it writes 4.1 MB of tables and reads ~40 KB of masks;
// per cell the work is a few shared-memory loads, R float divisions in
// fits_count and one offering test for the groups goff_idx lists.
//
// Design: one launch, no global scratch, no global atomics. A block owns
// one template p, a tile of TG groups and a tile of TT types
// (grid TT-tiles x TG-tiles x P, 256 threads). At these shapes a block's
// time is the latency of its chain of phases, so no phase waits on
// memory more than once and each spreads its work over the block:
//  1. the tile's rows staged in shared memory by asynchronous copies
//     (cp.async), all in flight at once: its types' mask, defined-key and
//     offering rows, offering ids and allocatable rows; p's mask,
//     defined-key and daemon rows; its groups' requests, p_tol and zone/
//     capacity-type rows; meanwhile the sums and flags go to zero and the
//     first chunk of the pair index and of goff_idx load into registers.
//     Then the bit words (dense_feasibility.cuh, 4 bytes at a time where
//     the rows allow) from the staged rows, and goff_idx's groups of the
//     tile flagged (repeats are idempotent);
//  2. once per (p, t) of the tile, spread over (type, key) and (type,
//     offering): the group-independent base failures (shared-memory
//     integer adds) and the template-only offering row;
//  3. the live pairs (nonzero weight) of the tile's groups, gathered from
//     the index in chunks of 256 whatever their order: each pair's
//     compatibility failure added onto its group, and its (exact merged
//     term - base term) x weight onto each (group, type) cell, by
//     shared-memory integer atomics. Integer sums wrap as int32 and are
//     exact in any order, so padding anywhere and a pair listed twice are
//     the JAX segment_sum;
//  4. a cell a thread: base + correction, the offering row (merged with
//     the group's rows for listed groups, as the JAX scatter), fits_count
//     and the fused type_ok AND; where
//     T % 4 == 0 each quad of lanes writes its four types as one 4-byte
//     and one 16-byte store. compat_pg is written once per (p, g), by the
//     blocks of the first type tile.
//
// A block runs each phase's code once, so the code's size is latency
// too (instruction fetches): the block-strided loops stay rolled, the
// staging runs out of line and the bit words come from one call site
// (the phase clocks, -DKT_PHASE_CLOCKS, split a block's time by phase).
//
// Tiling (kt_fresh_feasibility): 32 types x 8 groups (a cell a thread),
// the groups doubled up to 64 while the grid has more than 4 x 132 blocks,
// types narrowed while the block's shared memory passes 48 KB (wide
// masks). At the main path's shapes (K = 16, V1 = 4, R = 5, O = 8):
//   mixed 50k x 400 (G=64, T=400):   TG 8,  104 blocks, 13,632 B;
//   diverse-ref     (G=2048, T=400): TG 64, 416 blocks, 23,208 B;
//   constrained     (G=256, T=800):  TG 16, 400 blocks, 15,000 B.
// Wide value vocabularies: the staged byte rows grow with V1 (a block
// stages [TT, K, V1] + [K, V1] + 2 [TG, V1] bytes), so where they do not
// fit the card's 227 KB with the types narrowed to 4 (at K = 16 from V1 =
// 1024 with 64-group tiles, V1 = 2048 at any tile) the block stages bit
// words in place of mask bytes (Mode::kDirect). One grid-wide pass before
// the tables (fresh_words) packs every row the tables read into words
// once a launch, across the card: the types' and templates' [K, V1]
// masks, each group's zone and capacity-type rows and the live pairs'
// group rows, a thread a word from two 16-byte loads. At phase 10's
// team-In input (K 16, V1 2048, T 400, G 64) it reads t_mask's 13.1 MB
// once, where blocks that each built their own words from the byte rows
// read each type's rows once per group tile (~150 MB). The tables kernel
// then stages its tile's words with 16-byte cp.async like any other row
// and walks them a quad of words at a time, each lane of a warp from
// another quad (quads_meet: its rows lie a multiple of the 32 banks
// apart); a gathered pair's words arrive by one thread's cp.async, all in
// flight at once. Shared memory grows with V1 only through the bit
// words, [TT, K, W] + [K, W] + 2 [TG, W] + [PC, W] (W = V1 / 32), the
// pair chunk PC only as wide as the index, the types narrowed to 16 past
// 48 KB, and then the types, the groups and the chunk narrow until they
// fit.
// Past the widest V1 at which even one type, one group and one pair fit
// (at K = 16: V1 = 32,768 fits, V1 = 65,536 does not), the block keeps
// no words at all and reads every word from the byte rows in device memory
// where it needs it (Mode::kRows). Every mode computes the same tables.
//
// Partial mode (kt_fresh_feasibility_partial, the solver mesh's shard
// stage; replaces the feasibility half of
// karpenter_tpu/parallel/mesh.py:sharded_solve_fn's GSPMD partition):
// the same kernel over one shard's slices, the types of its model shard
// and the live pairs of its data shard, with nothing finished. It writes
// each cell's int32 key failures fail_t (the pairs' corrections, plus the
// base where ``with_base``) and each (p, g)'s compatibility failures
// fail_c; with the base (data shard 0) also the type-only parts (a fit,
// the template admits the type, an offering) and n_fit. The fold
// (mesh_fold.cu) sums the data shards' counts and finishes them with the
// same device functions as phase 4 here (tables_finish.cuh). Bound as
// above: a shard writes 9 bytes a cell where the full kernel writes 5.
#include "dense_feasibility.cuh"
#include "tables_finish.cuh"

namespace {

using kt::bit;
using kt::row_word;
using kt::RowWords;
using kt::words_meet;
using kt::words_meet3;

constexpr int kBlock = 256;
constexpr int kDefBit = 1 << 30;  // a gathered pair's key | (g_def << 30)
// the card's 227 KB a block, less a margin for the static n_pairs
constexpr size_t kSmemDefault = 48 * 1024, kSmemMax = 227 * 1024 - 16;

__host__ __device__ inline int words_of(int n) { return (n + 31) / 32; }

// the phase clocks' slots (common.cuh: KT_PHASE_CLOCKS)
enum Phase { kPhStage, kPhWords, kPhBase, kPhPairs, kPhCompat, kPhCells, kPhases };
static_assert(kPhases <= kMaxPhases, "one clock slot per phase");

// How a block holds its mask rows: staged as bytes and turned into bit
// words in shared memory (kStaged); bit words staged from fresh_words'
// pass (kDirect); or none, every word read from the byte rows in device
// memory where it is needed (kRows).
enum Mode { kStaged, kDirect, kRows };

// The block's shared memory: the staged raw rows (byte masks as torch
// stores them, offering ids, allocatable rows, requests), the bit words
// built from them, and the block's sums and flags. Every array starts
// 4-byte aligned; the host sizes it with the same constructor. The mask
// rows' bytes are staged only in kStaged, their words kept only outside
// kRows; in kDirect every array starts 16-byte aligned (stage_words).
struct Smem {
  uint32_t *pw, *pdw, *tw, *tdw, *aw, *gzw, *gcw, *pair_w;
  int32_t *oz, *oc, *adj, *base, *cfail, *pair_g, *pair_k, *pair_wt;
  float *alloc, *daemon, *req;
  uint8_t *raw_t, *raw_td, *raw_oa, *raw_p, *raw_pd, *raw_gz, *raw_gc;
  uint8_t *tok, *ptol, *toff, *listed, *compat;
  size_t bytes;

  __host__ __device__ Smem(void* at, int K, int V1, int R, int O, int TG, int TT, int PC,
                           Mode mode) {
    char* c = static_cast<char*>(at);
    const size_t al = mode == kDirect ? 15 : 3;
    auto take = [&c, al](size_t n) { char* p = c; c += (n + al) & ~al; return p; };
    const size_t W = mode == kRows ? 0 : words_of(V1), KD = words_of(K), OW = words_of(O);
    const size_t V1s = mode == kStaged ? V1 : 0, V1r = mode == kStaged ? (V1 + 3) & ~3 : 0;
    pw = reinterpret_cast<uint32_t*>(take(4 * K * W));           // [K, W] p's masks
    pdw = reinterpret_cast<uint32_t*>(take(4 * KD));             // [KD] p's defined keys
    tw = reinterpret_cast<uint32_t*>(take(4 * TT * K * W));      // [TT, K, W]
    tdw = reinterpret_cast<uint32_t*>(take(4 * TT * KD));        // [TT, KD]
    aw = reinterpret_cast<uint32_t*>(take(4 * TT * OW));         // [TT, OW] o_avail
    gzw = reinterpret_cast<uint32_t*>(take(4 * TG * W));         // [TG, W]
    gcw = reinterpret_cast<uint32_t*>(take(4 * TG * W));         // [TG, W]
    pair_w = reinterpret_cast<uint32_t*>(take(4 * PC * W));      // [PC, W]
    oz = reinterpret_cast<int32_t*>(take(4 * TT * O));           // [TT, O]
    oc = reinterpret_cast<int32_t*>(take(4 * TT * O));           // [TT, O]
    adj = reinterpret_cast<int32_t*>(take(4 * TG * TT));         // [TG, TT]
    base = reinterpret_cast<int32_t*>(take(4 * TT));
    cfail = reinterpret_cast<int32_t*>(take(4 * TG));
    pair_g = reinterpret_cast<int32_t*>(take(4 * PC));
    pair_k = reinterpret_cast<int32_t*>(take(4 * PC));
    pair_wt = reinterpret_cast<int32_t*>(take(4 * PC));
    alloc = reinterpret_cast<float*>(take(4 * TT * R));          // [TT, R]
    daemon = reinterpret_cast<float*>(take(4 * R));
    req = reinterpret_cast<float*>(take(4 * TG * R));            // [TG, R]
    raw_t = reinterpret_cast<uint8_t*>(take(size_t{1} * TT * K * V1s));  // [TT, K, V1]
    raw_td = reinterpret_cast<uint8_t*>(take(size_t{1} * TT * K));      // [TT, K]
    raw_oa = reinterpret_cast<uint8_t*>(take(size_t{1} * TT * O));      // [TT, O]
    raw_p = reinterpret_cast<uint8_t*>(take(size_t{1} * K * V1s));      // [K, V1]
    raw_pd = reinterpret_cast<uint8_t*>(take(K));
    raw_gz = reinterpret_cast<uint8_t*>(take(TG * V1r));                // [TG, V1r]
    raw_gc = reinterpret_cast<uint8_t*>(take(TG * V1r));
    tok = reinterpret_cast<uint8_t*>(take(TT));
    ptol = reinterpret_cast<uint8_t*>(take(TG));
    toff = reinterpret_cast<uint8_t*>(take(TT));
    listed = reinterpret_cast<uint8_t*>(take(TG));
    compat = reinterpret_cast<uint8_t*>(take(TG));
    bytes = static_cast<size_t>(c - static_cast<char*>(at));
  }
};

// kt::stage_bytes by the whole block, out of line: one copy of its code
// for the dozen rows a block stages (a block runs its code once, so
// its size is latency)
__device__ __noinline__ void stage(void* dst, const void* src, int n) {
  kt::stage_bytes(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(src), n, threadIdx.x,
                  kBlock);
}

// ``n`` words from global ``src`` to shared ``dst`` by the block's
// threads: 16-byte cp.async where both start 16-byte aligned, 4-byte
// otherwise (and for the tail); out of line, as stage
__device__ __noinline__ void stage_words(uint32_t* dst, const uint32_t* src, int n) {
  const int q = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) ? 0
                                                                                            : n / 4;
#pragma unroll 1
  for (int i = threadIdx.x; i < q; i += kBlock) kt::cp_async16(dst + 4 * i, src + 4 * i);
#pragma unroll 1
  for (int i = 4 * q + threadIdx.x; i < n; i += kBlock) kt::cp_async4(dst + i, src + i);
}

// The words fresh_words packs for kDirect, in one buffer: each type's [K]
// mask rows, each template's, each group's zone row then its
// capacity-type row, and the live pairs' group rows in index order, W
// words a row (a weight-0 pad's row left unwritten: no block reads it).
struct DirectWords {
  const uint32_t* at;
  size_t op, og, ol;  // where the templates', the groups' and the pairs' rows start
  __host__ __device__ DirectWords(const uint32_t* words, int T, int P, int G, int K, int W)
      : at(words),
        op(static_cast<size_t>(T) * K * W),
        og(op + static_cast<size_t>(P) * K * W),
        ol(og + static_cast<size_t>(2) * G * W) {}
  __device__ const uint32_t* t() const { return at; }
  __device__ const uint32_t* p() const { return at + op; }
  __device__ const uint32_t* g() const { return at + og; }
  __device__ const uint32_t* l() const { return at + ol; }
  __host__ __device__ static long long rows(int T, int P, int G, int K, int L) {
    return static_cast<long long>(T + P) * K + 2LL * G + L;
  }
};

// kDirect's word pass over the whole card, before the tables: word w of
// row r of DirectWords' rows is words[r * W + w], a thread a word
// (grid-stride), two 16-byte loads where ``x16`` (V1 % 32 == 0 and the
// three masks 16-byte aligned).
__global__ void __launch_bounds__(256) fresh_words(
    int T, int P, int G, int K, int V1, int L, int zone_kid, int ct_kid, bool x16,
    const uint8_t* __restrict__ t_mask, const uint8_t* __restrict__ p_mask,
    const uint8_t* __restrict__ g_mask, const int32_t* __restrict__ gk_g,
    const int32_t* __restrict__ gk_k, const int32_t* __restrict__ gk_w,
    uint32_t* __restrict__ words) {
  const int W = words_of(V1);
  const long long n = DirectWords::rows(T, P, G, K, L) * W;
  const long long TK = static_cast<long long>(T) * K, PK = static_cast<long long>(P) * K;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    long long r = i / W;
    const int w = static_cast<int>(i - r * W);
    const uint8_t* row;
    if (r < TK) {
      row = t_mask + r * V1;
    } else if ((r -= TK) < PK) {
      row = p_mask + r * V1;
    } else if ((r -= PK) < 2LL * G) {
      const long long g = r < G ? r : r - G;
      row = g_mask + (g * K + (r < G ? zone_kid : ct_kid)) * V1;
    } else {
      r -= 2LL * G;
      const int32_t g = gk_g[r], k = gk_k[r];
      if (gk_w[r] == 0 || g < 0 || g >= G || k < 0 || k >= K) continue;
      row = g_mask + (static_cast<size_t>(g) * K + k) * V1;
    }
    words[i] = kt::row_word16(row, V1, w, x16);
  }
}

// words_meet / words_meet3 (dense_feasibility.cuh) over kDirect's word
// rows in shared memory (16-byte aligned, W % 4 == 0: 16-byte loads), each
// thread from the quad of its lane round to the quad before it: any order
// gives the same answer, and the threads of a warp walk rows that lie a
// multiple of 32 words apart (neighbouring (type, key) rows, W = 64 at V1
// 2048), which in step would read one bank over and over.
__device__ __forceinline__ bool quads_meet(const uint32_t* a, const uint32_t* b, int W) {
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  const int W4 = W / 4;
  for (int v = 0, w = (threadIdx.x & 31) % W4; v < W4; ++v, w = w + 1 == W4 ? 0 : w + 1) {
    const uint4 x = a4[w], y = b4[w];
    if ((x.x & y.x) | (x.y & y.y) | (x.z & y.z) | (x.w & y.w)) return true;
  }
  return false;
}

__device__ __forceinline__ bool quads_meet3(const uint32_t* a, const uint32_t* b,
                                            const uint32_t* c, int W) {
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  const uint4* c4 = reinterpret_cast<const uint4*>(c);
  const int W4 = W / 4;
  for (int v = 0, w = (threadIdx.x & 31) % W4; v < W4; ++v, w = w + 1 == W4 ? 0 : w + 1) {
    const uint4 x = a4[w], y = b4[w], z = c4[w];
    if ((x.x & y.x & z.x) | (x.y & y.y & z.y) | (x.z & y.z & z.z) | (x.w & y.w & z.w))
      return true;
  }
  return false;
}

// ``n`` words from global ``src`` to shared ``dst`` by the calling thread
// alone, every copy in flight at once (16-byte cp.async where both are
// 16-byte aligned and n % 4 == 0), then waited for
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src, int n) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if (n % 4 == 0 && (at & 15) == 0)
    for (int v = 0; v < n; v += 4) kt::cp_async16(dst + v, src + v);
  else
    for (int v = 0; v < n; ++v) kt::cp_async4(dst + v, src + v);
  kt::cp_async_wait_all();
}

// fits_count of a cell, its R loop unrolled where R is 5 (the encoder's
// cpu, memory, pods, ephemeral storage and one extended resource) so that
// the R divisions overlap: one more copy of its code; any other R by the
// loop
__device__ __forceinline__ int32_t cell_fits(const float* alloc, const float* base,
                                             const float* req, int R) {
  return R == 5 ? kt::fits_count(alloc, base, req, 5) : kt::fits_count(alloc, base, req, R);
}

// The block's tiles and mode: 32 types x 8 groups (a cell a thread), the
// groups doubled up to 64 while the grid has more than 4 x 132 blocks;
// staged with the types narrowed to 16 while the block passes 48 KB and
// to 4 while it passes the card's 227 KB; past that kDirect, from 32
// types again with the pair chunk halved while it holds two index lengths
// ``L`` (at least 32), the types narrowed to 16 while it passes 48 KB,
// then to 4, the groups to 1, the pair chunk to 32, then the types and the
// chunk to 1 while it passes 227 KB; past that kRows. The mode does not
// depend on L.
void fresh_tiling(int P, int G, int T, int K, int V1, int R, int O, int L, int& TT, int& TG,
                  int& PC, Mode& mode) {
  TT = 32, TG = 8, PC = kBlock;
  auto blocks = [&] {
    return static_cast<long long>(P) * ((G + TG - 1) / TG) * (T > 0 ? (T + TT - 1) / TT : 1);
  };
  while (blocks() > 4 * 132 && TG < 64) TG <<= 1;
  auto bytes = [&](Mode m) { return Smem(nullptr, K, V1, R, O, TG, TT, PC, m).bytes; };
  mode = kStaged;
  while (TT > 16 && bytes(kStaged) > kSmemDefault) TT >>= 1;
  while (TT > 4 && bytes(kStaged) > kSmemMax) TT >>= 1;
  if (bytes(kStaged) <= kSmemMax) return;
  mode = kDirect, TT = 32;
  while (PC > 32 && PC / 2 >= L) PC >>= 1;
  while (TT > 16 && bytes(kDirect) > kSmemDefault) TT >>= 1;
  while (bytes(kDirect) > kSmemMax) {
    if (TT > 4) TT >>= 1;
    else if (TG > 1) TG >>= 1;
    else if (PC > 32) PC >>= 1;
    else if (TT > 1) TT >>= 1;
    else if (PC > 1) PC >>= 1;
    else break;
  }
  if (bytes(kDirect) <= kSmemMax) return;
  mode = kRows, TT = 32, TG = 8, PC = kBlock;
  while (blocks() > 4 * 132 && TG < 64) TG <<= 1;
  while (TT > 4 && bytes(kRows) > kSmemMax) TT >>= 1;
}

// at most 64 registers, so that four blocks share an SM: diverse-ref's
// 416 blocks are one wave on the 132 SMs. ``M`` is how the block holds
// its mask rows (Mode); ``x4``: the mask rows in device memory take 4-byte
// loads (V1 % 4 == 0 and 4-byte aligned bases). ``kPart``: the partial
// mode (fail_t, fail_c and, ``with_base``, tonly and n_fit written in
// place of compat_pg, type_ok and n_fit). ``words``: fresh_words' pass
// (kDirect only).
template <Mode M, bool kPart>
__global__ void __launch_bounds__(kBlock, 4) fresh_tables(
    int G, int T, int K, int V1, int R, int O, int L, int LZ, int TG, int TT, int PC,
    int zone_kid, int ct_kid, bool wide, bool x4, bool with_base,
    const uint32_t* __restrict__ words,
    const uint8_t* __restrict__ g_def, const uint8_t* __restrict__ g_neg,
    const uint8_t* __restrict__ g_mask, const float* __restrict__ g_req,
    const uint8_t* __restrict__ p_def, const uint8_t* __restrict__ p_neg,
    const uint8_t* __restrict__ p_mask, const float* __restrict__ p_daemon,
    const uint8_t* __restrict__ p_tol, const uint8_t* __restrict__ p_titype_ok,
    const uint8_t* __restrict__ t_def, const uint8_t* __restrict__ t_mask,
    const float* __restrict__ t_alloc,
    const uint8_t* __restrict__ o_avail, const int32_t* __restrict__ o_zone,
    const int32_t* __restrict__ o_ct, const uint8_t* __restrict__ well_known,
    const int32_t* __restrict__ gk_g, const int32_t* __restrict__ gk_k,
    const int32_t* __restrict__ gk_w, const int32_t* __restrict__ goff_idx,
    uint8_t* __restrict__ compat_pg, uint8_t* __restrict__ type_ok,
    int32_t* __restrict__ n_fit, int32_t* __restrict__ fail_t, int32_t* __restrict__ fail_c,
    uint8_t* __restrict__ tonly) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int n_pairs;
  const Smem s(smem_raw, K, V1, R, O, TG, TT, PC, M);
  const int W = words_of(V1), KD = words_of(K), OW = words_of(O), KW = K * W;
  const int V1r = (V1 + 3) & ~3;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT, g0 = blockIdx.y * TG, p = blockIdx.z;
  const int nt = max(0, min(TT, T - t0)), ng = min(TG, G - g0);
  const DirectWords dw(words, T, gridDim.z, G, K, W);
  PHASE_START;
  // key k's words of the tile's type t, of p, and of the gathered pair j;
  // the tile's groups' zone and capacity-type words: in shared memory, or
  // (kRows) read from the byte rows in device memory
  auto row = [&](const uint8_t* mask, size_t r) { return RowWords{mask + r * V1, V1, x4}; };
  auto t_words = [&](int t, int k) {
    if constexpr (M == kRows) return row(t_mask, static_cast<size_t>(t0 + t) * K + k);
    else return static_cast<const uint32_t*>(s.tw + t * KW + k * W);
  };
  auto p_words = [&](int k) {
    if constexpr (M == kRows) return row(p_mask, static_cast<size_t>(p) * K + k);
    else return static_cast<const uint32_t*>(s.pw + k * W);
  };
  auto pair_words = [&](int j) {
    if constexpr (M == kRows)
      return row(g_mask, static_cast<size_t>(g0 + s.pair_g[j]) * K + (s.pair_k[j] & (kDefBit - 1)));
    else return static_cast<const uint32_t*>(s.pair_w + j * W);
  };
  auto gz_words = [&](int gl) {
    if constexpr (M == kRows) return row(g_mask, static_cast<size_t>(g0 + gl) * K + zone_kid);
    else return static_cast<const uint32_t*>(s.gzw + gl * W);
  };
  auto gc_words = [&](int gl) {
    if constexpr (M == kRows) return row(g_mask, static_cast<size_t>(g0 + gl) * K + ct_kid);
    else return static_cast<const uint32_t*>(s.gcw + gl * W);
  };

  // 1. the tile's rows into shared memory as asynchronous copies, all in
  //    flight at once (a block pays about one round trip to memory, not
  //    one a row); meanwhile the sums and flags go to zero and the first
  //    chunk of the pair index and of goff_idx load into registers. The
  //    mask rows' bytes only in kStaged, their words from fresh_words'
  //    pass in kDirect.
  if constexpr (M == kStaged) {
    stage(s.raw_t, t_mask + static_cast<size_t>(t0) * K * V1, nt * K * V1);
    stage(s.raw_p, p_mask + static_cast<size_t>(p) * K * V1, K * V1);
  }
  if constexpr (M == kDirect) {
    stage_words(s.tw, dw.t() + static_cast<size_t>(t0) * KW, nt * KW);
    stage_words(s.pw, dw.p() + static_cast<size_t>(p) * KW, KW);
    stage_words(s.gzw, dw.g() + static_cast<size_t>(g0) * W, ng * W);
    stage_words(s.gcw, dw.g() + (static_cast<size_t>(G) + g0) * W, ng * W);
  }
  stage(s.raw_td, t_def + static_cast<size_t>(t0) * K, nt * K);
  stage(s.raw_oa, o_avail + static_cast<size_t>(t0) * O, nt * O);
  stage(s.oz, o_zone + static_cast<size_t>(t0) * O, 4 * nt * O);
  stage(s.oc, o_ct + static_cast<size_t>(t0) * O, 4 * nt * O);
  stage(s.alloc, t_alloc + static_cast<size_t>(t0) * R, 4 * nt * R);
  stage(s.raw_pd, p_def + static_cast<size_t>(p) * K, K);
  stage(s.daemon, p_daemon + static_cast<size_t>(p) * R, 4 * R);
  stage(s.req, g_req + static_cast<size_t>(g0) * R, 4 * ng * R);
  stage(s.tok, p_titype_ok + static_cast<size_t>(p) * T + t0, nt);
  stage(s.ptol, p_tol + static_cast<size_t>(p) * G + g0, ng);
  // the groups' zone and capacity-type rows: one range each
  if constexpr (M == kStaged) {
    if (V1 % 4 == 0 && reinterpret_cast<uintptr_t>(g_mask) % 4 == 0) {
      const int C = V1 / 4;
#pragma unroll 1
      for (int i = tid; i < ng * C; i += kBlock) {
        const uint8_t* r = g_mask + static_cast<size_t>(g0 + i / C) * K * V1 + 4 * (i % C);
        uint8_t* at = s.raw_gz + (i / C) * V1r + 4 * (i % C);
        kt::cp_async4(at, r + static_cast<size_t>(zone_kid) * V1);
        kt::cp_async4(at + (s.raw_gc - s.raw_gz), r + static_cast<size_t>(ct_kid) * V1);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < ng * V1; i += kBlock) {
        const uint8_t* r = g_mask + static_cast<size_t>(g0 + i / V1) * K * V1 + i % V1;
        s.raw_gz[(i / V1) * V1r + i % V1] = r[static_cast<size_t>(zone_kid) * V1];
        s.raw_gc[(i / V1) * V1r + i % V1] = r[static_cast<size_t>(ct_kid) * V1];
      }
    }
  }
#pragma unroll 1
  for (int i = tid; i < TG * TT; i += kBlock) s.adj[i] = 0;
#pragma unroll 1
  for (int i = tid; i < TT; i += kBlock) {
    s.base[i] = 0;
    s.toff[i] = 0;
  }
#pragma unroll 1
  for (int i = tid; i < TG; i += kBlock) {
    s.cfail[i] = 0;
    s.listed[i] = 0;
  }
  const bool have = tid < L && tid < PC;  // this thread's pair of the first chunk
  int32_t my_g = 0, my_k = 0, my_w = 0, my_goff = -1;
  if (have) {
    my_w = gk_w[tid];
    my_g = gk_g[tid];
    my_k = gk_k[tid];
  }
  if (tid < LZ) my_goff = goff_idx[tid];
  kt::cp_async_wait_all();
  __syncthreads();
  PHASE_MARK(kPhStage);

  // the bit words of the rows, all from one call site (one copy of
  // row_word's code): types' masks, defined keys and offering
  // availability, p's masks and defined keys, groups' zone and
  // capacity-type rows, from the staged rows (the mask rows' only in
  // kStaged: kDirect staged their words, kRows keeps none); goff_idx's
  // groups of the tile flagged (repeats are idempotent)
  {
    const int KWs = M == kStaged ? KW : 0, Ws = M == kStaged ? W : 0;
    const int e0 = nt * KWs, e1 = e0 + nt * KD, e2 = e1 + nt * OW, e3 = e2 + KWs, e4 = e3 + KD,
              e5 = e4 + ng * Ws, e6 = e5 + ng * Ws;
#pragma unroll 1
    for (int i = tid; i < e6; i += kBlock) {
      const uint8_t* r;
      uint32_t* dst;
      int len, w;
      if (i < e0) {
        r = s.raw_t + static_cast<size_t>(i / W) * V1, len = V1, w = i % W, dst = s.tw + i;
      } else if (i < e1) {
        r = s.raw_td + ((i - e0) / KD) * K, len = K, w = (i - e0) % KD, dst = s.tdw + i - e0;
      } else if (i < e2) {
        r = s.raw_oa + ((i - e1) / OW) * O, len = O, w = (i - e1) % OW, dst = s.aw + i - e1;
      } else if (i < e3) {
        r = s.raw_p + ((i - e2) / W) * V1, len = V1, w = (i - e2) % W, dst = s.pw + i - e2;
      } else if (i < e4) {
        r = s.raw_pd, len = K, w = i - e3, dst = s.pdw + i - e3;
      } else if (i < e5) {
        r = s.raw_gz + ((i - e4) / W) * V1r, len = V1, w = (i - e4) % W, dst = s.gzw + i - e4;
      } else {
        r = s.raw_gc + ((i - e5) / W) * V1r, len = V1, w = (i - e5) % W, dst = s.gcw + i - e5;
      }
      // every staged row starts 4-byte aligned where its length is a multiple of 4
      *dst = row_word(r, len, w, len % 4 == 0);
    }
  }
  if (my_goff >= g0 && my_goff < g0 + ng) s.listed[my_goff - g0] = 1;
#pragma unroll 1
  for (int i = tid + kBlock; i < LZ; i += kBlock) {
    const int g = goff_idx[i];
    if (g >= g0 && g < g0 + ng) s.listed[g - g0] = 1;
  }
  __syncthreads();
  PHASE_MARK(kPhWords);

  // 2. once per (p, t), spread over (type, key) and (type, offering):
  //    the group-independent base failures and the template-only
  //    offering row
  const auto pz = p_words(zone_kid);
  const auto pc = p_words(ct_kid);
  auto offer = [&](int t, int o, const auto& gz, const auto& gc) {
    if (!bit(s.aw + t * OW, o)) return false;
    const int32_t z = s.oz[t * O + o], c = s.oc[t * O + o];
    return (z < 0 || (bit(pz, z) && bit(gz, z))) && (c < 0 || (bit(pc, c) && bit(gc, c)));
  };
  // (a partial without the base counts only its pairs' corrections);
  // kDirect's word rows take quads_meet where W % 4 == 0
  const bool quads = M == kDirect && W % 4 == 0;
  auto meets = [&](const auto& a, const auto& b) {
    if constexpr (M == kDirect) return quads ? quads_meet(a, b, W) : words_meet(a, b, W);
    else return words_meet(a, b, W);
  };
  auto meets3 = [&](const auto& a, const auto& b, const auto& c) {
    if constexpr (M == kDirect) return quads ? quads_meet3(a, b, c, W) : words_meet3(a, b, c, W);
    else return words_meet3(a, b, c, W);
  };
  const int base_n = !kPart || with_base ? nt : 0;
#pragma unroll 1
  for (int i = tid; i < base_n * K; i += kBlock) {
    const int t = i / K, k = i % K;
    if (!(meets(t_words(t, k), p_words(k)) ||
          !(bit(s.tdw + t * KD, k) && bit(s.pdw, k))))
      atomicAdd(&s.base[t], 1);
  }
#pragma unroll 1
  for (int i = tid; i < base_n * O; i += kBlock)
    if (offer(i / O, i % O, pz, pc)) s.toff[i / O] = 1;
  PHASE_MARK(kPhBase);

  // 3. the tile's live pairs, chunk by chunk (PC a chunk), in any order
#pragma unroll 1
  for (int c0 = 0; c0 < L; c0 += PC) {
    if (tid == 0) n_pairs = 0;
    __syncthreads();
    const int l = c0 + tid;
    int32_t w = 0, g = -1, k = 0;
    if (c0 == 0) {
      if (have) w = my_w, g = my_g, k = my_k;
    } else if (tid < PC && l < L) {
      w = gk_w[l], g = gk_g[l], k = gk_k[l];
    }
    if (w != 0 && g >= g0 && g < g0 + ng) {
      const int j = atomicAdd(&n_pairs, 1);
      const size_t gk = static_cast<size_t>(g) * K + k;
      const RowWords gr = row(g_mask, gk);
      bool meet;
      if constexpr (M == kRows) {
        meet = words_meet(p_words(k), gr, W);
      } else {
        uint32_t* gm = s.pair_w + j * W;
        if constexpr (M == kDirect) {
          copy_words(gm, dw.l() + static_cast<size_t>(l) * W, W);
        } else {
#pragma unroll 1
          for (int v = 0; v < W; ++v) gm[v] = gr[v];
        }
        meet = meets(p_words(k), static_cast<const uint32_t*>(gm));
      }
      const bool gdef = g_def[gk], gneg = g_neg[gk];
      const bool pdef = bit(s.pdw, k), pneg = p_neg[static_cast<size_t>(p) * K + k];
      s.pair_g[j] = g - g0;
      s.pair_k[j] = k | (gdef ? kDefBit : 0);
      s.pair_wt[j] = w;
      // pod-vs-template compatibility (with the well-known allowance)
      const bool term = meet || (pneg && gneg) || !(pdef && gdef);
      const bool custom = !gdef || well_known[k] || pdef || gneg;
      if (!(term && custom)) atomicAdd(&s.cfail[g - g0], w);
    }
    __syncthreads();
    const int np = n_pairs;
#pragma unroll 1
    for (int i = tid; i < np * nt; i += kBlock) {
      const int j = i / nt, t = i % nt;
      const int kj = s.pair_k[j] & (kDefBit - 1);
      const bool gdef = s.pair_k[j] & kDefBit;
      const auto tk = t_words(t, kj);
      const auto pk = p_words(kj);
      const bool tdef = bit(s.tdw + t * KD, kj), pdef = bit(s.pdw, kj);
      const int pair_fail = !(meets3(tk, pair_words(j), pk) || !(tdef && (pdef || gdef)));
      const int base_fail = !(meets(tk, pk) || !(tdef && pdef));
      const int32_t delta = kt::wrap_mul(pair_fail - base_fail, s.pair_wt[j]);
      if (delta != 0) atomicAdd(&s.adj[s.pair_g[j] * TT + t], delta);
    }
    __syncthreads();  // the chunk applied before the next one is gathered
  }
  __syncthreads();
  PHASE_MARK(kPhPairs);
#pragma unroll 1
  for (int gl = tid; gl < ng; gl += kBlock) {
    if constexpr (kPart) {
      if (blockIdx.x == 0) fail_c[static_cast<size_t>(p) * G + g0 + gl] = s.cfail[gl];
    } else {
      s.compat[gl] = kt::compat_of(s.ptol[gl], s.cfail[gl]);
      if (blockIdx.x == 0) compat_pg[static_cast<size_t>(p) * G + g0 + gl] = s.compat[gl];
    }
  }
  __syncthreads();
  PHASE_MARK(kPhCompat);

  if constexpr (kPart) {
    // 4'. the partial cells, one a thread: the key failures, and with the
    //     base the type-only part (offering merged with the group's rows
    //     for listed groups) and the fit
#pragma unroll 1
    for (int i = tid; i < ng * TT; i += kBlock) {
      const int gl = i / TT, t = i % TT;
      if (t >= nt) continue;
      const size_t at = (static_cast<size_t>(p) * G + g0 + gl) * T + t0 + t;
      fail_t[at] = kt::wrap_add(s.base[t], s.adj[gl * TT + t]);
      if (with_base) {
        const int32_t nf = cell_fits(s.alloc + t * R, s.daemon, s.req + gl * R, R);
        bool off = false;
        if (kt::type_only(nf, s.tok[t], true)) {
          if (!s.listed[gl]) {
            off = s.toff[t];
          } else {
            const auto gz = gz_words(gl);
            const auto gc = gc_words(gl);
            for (int o = 0; o < O && !off; ++o) off = offer(t, o, gz, gc);
          }
        }
        tonly[at] = kt::type_only(nf, s.tok[t], off);
        n_fit[at] = nf;
      }
    }
    PHASE_MARK(kPhCells);
    return;
  }

  // 4. the cells, one a thread: base + correction, the offering row
  //    (merged with the group's rows for listed groups), fits_count, the
  //    fused AND. Where T % 4 == 0 each quad of lanes (four types of one
  //    row) writes its cells as one 4-byte and one 16-byte store.
  const int cells = ng * TT;
#pragma unroll 1
  for (int i0 = 0; i0 < cells; i0 += kBlock) {  // the same trip count in every thread
    const int i = i0 + tid, gl = i / TT, t = i % TT;
    const bool live = i < cells && t < nt;
    int32_t nf = 0;
    uint32_t ok = 0;
    if (live) {
      nf = cell_fits(s.alloc + t * R, s.daemon, s.req + gl * R, R);
      if (kt::type_only(nf, s.tok[t], true) && s.compat[gl] &&
          kt::keys_pass(kt::wrap_add(s.base[t], s.adj[gl * TT + t]))) {
        if (!s.listed[gl]) {
          ok = s.toff[t];
        } else {
          const auto gz = gz_words(gl);
          const auto gc = gc_words(gl);
          for (int o = 0; o < O && !ok; ++o) ok = offer(t, o, gz, gc);
        }
      }
    }
    const size_t at = (static_cast<size_t>(p) * G + g0 + gl) * T + t0 + t;
    if (wide) {
      const int32_t n1 = __shfl_down_sync(kt::kFull, nf, 1);
      const int32_t n2 = __shfl_down_sync(kt::kFull, nf, 2);
      const int32_t n3 = __shfl_down_sync(kt::kFull, nf, 3);
      const uint32_t okq = ok | __shfl_down_sync(kt::kFull, ok, 1) << 8 |
                           __shfl_down_sync(kt::kFull, ok, 2) << 16 |
                           __shfl_down_sync(kt::kFull, ok, 3) << 24;
      if (live && (t & 3) == 0) {
        *reinterpret_cast<uint32_t*>(type_ok + at) = okq;
        *reinterpret_cast<int4*>(n_fit + at) = make_int4(nf, n1, n2, n3);
      }
    } else if (live) {
      type_ok[at] = ok;
      n_fit[at] = nf;
    }
  }
  PHASE_MARK(kPhCells);
}

// One launch of fresh_tables, whole (kPart false) or partial.
template <bool kPart>
int launch_fresh(int P, int G, int T, int K, int V1, int R, int O, int L, int LZ, int zone_kid,
                 int ct_kid, bool with_base, const uint8_t* g_def, const uint8_t* g_neg,
                 const uint8_t* g_mask, const float* g_req, const uint8_t* p_def,
                 const uint8_t* p_neg, const uint8_t* p_mask, const float* p_daemon,
                 const uint8_t* p_tol, const uint8_t* p_titype_ok, const uint8_t* t_def,
                 const uint8_t* t_mask, const float* t_alloc, const uint8_t* o_avail,
                 const int32_t* o_zone, const int32_t* o_ct, const uint8_t* well_known,
                 const int32_t* gk_g, const int32_t* gk_k, const int32_t* gk_w,
                 const int32_t* goff_idx, uint8_t* compat_pg, uint8_t* type_ok, int32_t* n_fit,
                 int32_t* fail_t, int32_t* fail_c, uint8_t* tonly, uint32_t* words,
                 long long words_n, void* stream_ptr) {
  if (static_cast<long long>(P) * G == 0) return kt::kNothingLaunched;
  int TT, TG, PC;
  Mode mode;
  fresh_tiling(P, G, T, K, V1, R, O, L, TT, TG, PC, mode);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = Smem(nullptr, K, V1, R, O, TG, TT, PC, mode).bytes;
  auto kernel = mode == kStaged   ? fresh_tables<kStaged, kPart>
                : mode == kDirect ? fresh_tables<kDirect, kPart>
                                  : fresh_tables<kRows, kPart>;
  const int rc = kt::allow_dynamic_smem(kernel, smem);  // wide masks: past 48 KB
  if (rc) return rc;
  const bool wide = !kPart && TT % 4 == 0 && T % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(type_ok) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(n_fit) % 16 == 0;
  const bool x4 = V1 % 4 == 0 && (reinterpret_cast<uintptr_t>(g_mask) |
                                  reinterpret_cast<uintptr_t>(p_mask) |
                                  reinterpret_cast<uintptr_t>(t_mask)) % 4 == 0;
  if (mode == kDirect) {
    // the rows' words across the card, once, before the tables
    const long long n = DirectWords::rows(T, P, G, K, L) * words_of(V1);
    if (words == nullptr || words_n < n) return static_cast<int>(cudaErrorInvalidValue);
    const bool x16 = V1 % 32 == 0 && ((reinterpret_cast<uintptr_t>(g_mask) |
                                       reinterpret_cast<uintptr_t>(p_mask) |
                                       reinterpret_cast<uintptr_t>(t_mask)) & 15) == 0;
    const int blocks = kt::grid_for(n, 256);  // at most 8 a SM, a grid-stride loop past that
    fresh_words<<<blocks < 132 * 8 ? blocks : 132 * 8, 256, 0, stream>>>(
        T, P, G, K, V1, L, zone_kid, ct_kid, x16, t_mask, p_mask, g_mask, gk_g, gk_k, gk_w,
        words);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(T > 0 ? (T + TT - 1) / TT : 1, (G + TG - 1) / TG, P);
  kernel<<<grid, kBlock, smem, stream>>>(
      G, T, K, V1, R, O, L, LZ, TG, TT, PC, zone_kid, ct_kid, wide, x4, with_base, words, g_def,
      g_neg, g_mask, g_req, p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok, t_def, t_mask,
      t_alloc, o_avail, o_zone, o_ct, well_known, gk_g, gk_k, gk_w, goff_idx, compat_pg,
      type_ok, n_fit, fail_t, fail_c, tonly);
  return static_cast<int>(cudaGetLastError());
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
    uint8_t* compat_pg, uint8_t* type_ok, int32_t* n_fit,
    // the direct mode's words (kt_fresh_feasibility_layout's words; may be
    // null where it asks for none) and their count
    uint32_t* words, long long words_n,
    void* stream_ptr) {
  return launch_fresh<false>(P, G, T, K, V1, R, O, L, LZ, zone_kid, ct_kid, true, g_def, g_neg,
                             g_mask, g_req, p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
                             t_def, t_mask, t_alloc, o_avail, o_zone, o_ct, well_known, gk_g,
                             gk_k, gk_w, goff_idx, compat_pg, type_ok, n_fit, nullptr, nullptr,
                             nullptr, words, words_n, stream_ptr);
}

// The partial mode over one mesh shard's slices (the types of its model
// shard: T, t_*, o_*, p_titype_ok [P, T]; the live pairs of its data
// shard: L, gk_*): fail_t [P, G, T], fail_c [P, G] and, with ``with_base``,
// tonly [P, G, T] and n_fit [P, G, T] (else both may be null).
extern "C" int kt_fresh_feasibility_partial(
    int P, int G, int T, int K, int V1, int R, int O, int L, int LZ,
    int zone_kid, int ct_kid, int with_base,
    const uint8_t* g_def, const uint8_t* g_neg, const uint8_t* g_mask,
    const float* g_req,
    const uint8_t* p_def, const uint8_t* p_neg, const uint8_t* p_mask,
    const float* p_daemon, const uint8_t* p_tol, const uint8_t* p_titype_ok,
    const uint8_t* t_def, const uint8_t* t_mask, const float* t_alloc,
    const uint8_t* o_avail, const int32_t* o_zone, const int32_t* o_ct,
    const uint8_t* well_known,
    const int32_t* gk_g, const int32_t* gk_k, const int32_t* gk_w,
    const int32_t* goff_idx,
    int32_t* fail_t, int32_t* fail_c, uint8_t* tonly, int32_t* n_fit,
    uint32_t* words, long long words_n,
    void* stream_ptr) {
  return launch_fresh<true>(P, G, T, K, V1, R, O, L, LZ, zone_kid, ct_kid, with_base != 0, g_def,
                            g_neg, g_mask, g_req, p_def, p_neg, p_mask, p_daemon, p_tol,
                            p_titype_ok, t_def, t_mask, t_alloc, o_avail, o_zone, o_ct,
                            well_known, gk_g, gk_k, gk_w, goff_idx, nullptr, nullptr, n_fit,
                            fail_t, fail_c, tonly, words, words_n, stream_ptr);
}

// The tiling and mode kt_fresh_feasibility takes at these shapes with an
// index of ``L`` pairs: writes TT, TG, PC, the mode (0 staged, 1 direct,
// 2 rows), the block's shared memory bytes and the words the direct mode
// asks the caller for (0 in the others) to ``out`` [6].
extern "C" int kt_fresh_feasibility_layout(int P, int G, int T, int K, int V1, int R, int O,
                                           int L, long long* out) {
  int TT, TG, PC;
  Mode mode;
  fresh_tiling(P, G, T, K, V1, R, O, L, TT, TG, PC, mode);
  out[0] = TT, out[1] = TG, out[2] = PC, out[3] = mode;
  out[4] = static_cast<long long>(Smem(nullptr, K, V1, R, O, TG, TT, PC, mode).bytes);
  out[5] = mode == kDirect ? DirectWords::rows(T, P, G, K, L) * words_of(V1) : 0;
  return 0;
}

#ifdef KT_PHASE_CLOCKS
// The first ``n`` phase clocks' totals in nanoseconds (Phase order) into
// ``host``, then zeroed; synchronous. Returns cudaGetLastError().
extern "C" int kt_fresh_feasibility_phase_clocks(unsigned long long* host, int n) {
  return read_phase_clocks(host, n);
}
#endif
