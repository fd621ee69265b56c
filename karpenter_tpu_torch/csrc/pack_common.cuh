// The packing scan's phases, shared by kernel B4 (pack.cu, one step per
// group) and kernel B5 (pack_classed.cu, one step per feasibility class
// with an inner loop over its member groups). Each phase is the device
// form of one part of karpenter_tpu/ops/packing.py's step body; both
// kernels call the same functions, so the two scans place a group the
// same way, bit for bit.
//
// Every function here is called by all threads of one 1024-thread block
// (in B4, the block of a cluster's rank that runs the phase); those that
// end in a block barrier say so. The claim-axis phases take the live
// extent (the open claims) as an argument and never walk to NMAX.
// Reductions and scans are integer (exact in any order) and cost one
// barrier each; argmin/argmax break ties at the lowest index; float32
// ledgers use two IEEE roundings per a*b+c (built with -fmad=false), as
// XLA computes them.
//
// The tiled mode (Dims::tiled; packing.py:_tile_rows, the HBM-scaling
// route): the four feasibility tables are never materialised. At the head
// of each real step (B4) or class (B5) tile_rows builds that group's rows
// (compat_row [P], type_ok_row and n_fit_row [P, T], cap_row [N]) into the
// block's own scratch in device memory (Rows: P*T bytes + P*T int32 + P +
// N int32 per scenario, 256 KB at 64 pools x 800 types, past an SM's
// shared memory), with kernel B3's cell functions (dense_feasibility.cuh)
// and common.cuh's fits_count; the block's In then points its table
// pointers at that scratch, and every reader indexes through trow / tcap,
// which read column ``hi`` of a [P, G(, T)] table, or the step's one row.
//
// Both scans run as thread-block clusters (launch_clusters, cluster_sync)
// and carry the same phase clocks (KT_PHASE_CLOCKS), each over its own
// phase enum.
#pragma once

#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "common.cuh"
#include "dense_feasibility.cuh"

namespace {

namespace cg = cooperative_groups;

using kt::bit;
using kt::clip;
using kt::fits_count;
using kt::kBigDom;
using kt::kFull;
using kt::mask_word;
using kt::row_word16;
using kt::rows_x16;
using kt::wrap_add;
using kt::wrap_mul;
using kt::wrap_sub;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the block reductions read one warp total per lane");
// the most minValues teams of more than one warp (team_minvalues): each
// syncs on its own named barrier, 1 .. kMaxMvTeams (0 is __syncthreads')
constexpr int kMaxMvTeams = 8;
// How a scan kernel takes the minValues caps, one instantiation each
// (mv_path picks it per launch): no floors (no minValues code at all); a
// warp an entity (warp_minvalues), at a narrow catalog whose fits every
// warp keeps in shared memory (an instance-family floor: MW in the tens);
// or teams of threads (team_minvalues), at a wide one (an instance-type
// floor: MW in the thousands). Each path's code weighs only on its own
// launches: the scans run at the 64 registers of their 1024-thread launch
// bound, where a phase's registers spill in every other phase.
enum MvPath { kMvNone, kMvWarp, kMvTeam };
constexpr int kMvWarpMW = 256;  // the widest catalog the warp path takes
// domain-constraint modes (solver/encode.py:DMODE_*)
constexpr int kSpread = 1, kAffinity = 2, kGateSpread = 3, kGateAff = 4;

// Phase clocks: common.cuh (KT_PHASE_CLOCKS), one slot per phase of each
// scan's own enum.

// The cluster's barrier (release / acquire at cluster scope: the state
// one rank wrote before it is what the others read after it); the
// block's own with no cluster.
__device__ __forceinline__ void cluster_sync(int ranks) {
  if (ranks > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The clusters of ``c`` blocks of ``kernel`` the card holds at once with
// ``cfg``'s shared memory (for c = 1, blocks), asked of the runtime once
// per kernel, device, size and shared memory, not per launch.
template <class Kernel>
int max_active(Kernel kernel, int c, cudaLaunchConfig_t cfg, int& n) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>, int> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), dev, c,
                                   cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> hold(mu);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    n = hit->second;
    return 0;
  }
  if (c == 1) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      cfg.dynamicSmemBytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    n = per_sm * sms;
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  known[key] = n;
  return 0;
}

// The cluster for a launch of S scenarios: the largest of max_c, max_c /
// 2, ... 2 blocks of which the card holds S clusters at once, else 1.
// Writes the blocks, the clusters of that size the card holds and those
// of max_c blocks to ``c``, ``fit`` and ``fit_max``; returns
// kClusterUnplaced when not one cluster of max_c fits.
template <class Kernel>
int pick_cluster(Kernel kernel, int max_c, int S, const cudaLaunchConfig_t& cfg, int& c,
                 int& fit, int& fit_max) {
  int rc = max_active(kernel, max_c, cfg, fit_max);
  if (rc) return rc;
  if (fit_max < 1) return kt::kClusterUnplaced;
  c = max_c;
  fit = fit_max;
  while (c > 1 && fit < S) {
    c /= 2;
    rc = max_active(kernel, c, cfg, fit);
    if (rc) return rc;
  }
  return 0;
}

// Launch ``kernel`` (kThreads threads a block, ``smem`` bytes of dynamic
// shared memory, on ``stream``) as S clusters, one per scenario, of the
// width pick_cluster chooses; the kernel's last parameter receives that
// width. Writes it, how many clusters of it and of max_c blocks the card
// holds at once to ``cluster`` (may be null). Returns cudaGetLastError()
// or kClusterUnplaced.
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), int max_c, int S, size_t smem,
                    cudaStream_t stream, int* cluster, Args... args) {
  // a layout the card refuses names its own error, not kClusterUnplaced
  const int rc0 = kt::allow_dynamic_smem(kernel, smem);
  if (rc0) return rc0;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  int c = 1, fit = 0, fit_max = 0;
  const int rc = pick_cluster(kernel, max_c, S, cfg, c, fit, fit_max);
  if (rc) return rc;
  if (cluster) {
    cluster[0] = c;
    cluster[1] = fit;
    cluster[2] = fit_max;
  }
  cfg.gridDim = dim3(static_cast<unsigned>(S) * c);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  if (c > 1) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cudaLaunchKernelEx(&cfg, kernel, args..., c);
  return static_cast<int>(cudaGetLastError());
}

// The block reductions' scratch: two slots of each kind, used in turn by
// every reduction and scan, so each costs ONE barrier: a reduction writes
// the slots the last one did not use, and the one after it writes these
// again only once every thread has passed the next barrier, after its
// reads.
struct RedBufs {
  int32_t i32[2][kWarps];
  unsigned long long u64[2][kWarps];
  float f32[2][kWarps];
};

// Each thread's handle on the block's RedBufs: which slot comes next (the
// same on every thread: all of them run every reduction, in order).
struct Shared {
  RedBufs* b;
  int par;
  __device__ int next() {
    const int p = par;
    par ^= 1;
    return p;
  }
};

// the warp totals of one reduction: lane w of every warp gets warp w's
__device__ __forceinline__ int32_t warp_totals_i32(int32_t v, Shared& sh) {
  int32_t* slot = sh.b->i32[sh.next()];
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  return slot[threadIdx.x & 31];
}

__device__ int32_t block_sum(int32_t v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = wrap_add(v, __shfl_xor_sync(kFull, v, o));
  v = warp_totals_i32(v, sh);
  for (int o = 16; o; o >>= 1) v = wrap_add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ int32_t block_max(int32_t v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  v = warp_totals_i32(v, sh);
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ int32_t block_min(int32_t v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  v = warp_totals_i32(v, sh);
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ unsigned long long block_min_u64(unsigned long long v, Shared& sh) {
  for (int o = 16; o; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(kFull, v, o);
    v = u < v ? u : v;
  }
  unsigned long long* slot = sh.b->u64[sh.next()];
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  v = slot[threadIdx.x & 31];
  for (int o = 16; o; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(kFull, v, o);
    v = u < v ? u : v;
  }
  return v;
}

// float max over the warps in index order, as before the one-barrier
// form (the limit debit's maxima reach the pool ledger)
__device__ float block_max_f(float v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  float* slot = sh.b->f32[sh.next()];
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = slot[0];
  for (int w = 1; w < kWarps; ++w) s = fmaxf(s, slot[w]);
  return s;
}

// inclusive prefix sum of one value per thread across the block (int32,
// wrapping); *total receives the block's sum
__device__ int32_t block_scan(int32_t x, Shared& sh, int32_t* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = wrap_add(x, y);
  }
  int32_t* slot = sh.b->i32[sh.next()];
  if (lane == 31) slot[wid] = x;
  __syncthreads();
  // lane w scans the warp totals: its inclusive prefix over warps 0..w
  int32_t t = slot[lane];
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, t, o);
    if (lane >= o) t = wrap_add(t, y);
  }
  *total = __shfl_sync(kFull, t, 31);
  const int32_t upto = __shfl_sync(kFull, t, wid);  // warps 0..wid
  const int32_t mine = __shfl_sync(kFull, x, 31);   // this warp's total
  return wrap_add(wrap_sub(upto, mine), x);
}

// the (npods, index) key of the least-loaded slot, ties to the lowest index
__device__ __forceinline__ unsigned long long load_key(int32_t npods, int s) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(npods) ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(s);
}

// jnp's floor division of int32
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// The launch's offered sets (offer_words: each zone and capacity type
// that a_tzc or any reservation offers at all) as bit words [W], and the
// word ranges [zlo, zhi) and [clo, chi) that hold their bits. Every
// offering word the scan reads (st.atz, st.atc, the held and the
// reservations' words) is 0 at a zone outside z and has no bit outside c
// (atz's capacity-type bits), so an offering test walks only these; a
// value no offering names satisfies no test.
struct Offered {
  const uint32_t* z; const uint32_t* c;
  int zlo, zhi, clo, chi;
};

// any (z, c) with zone bit z, capacity-type bit c and a_tzc[t, z, c]: an
// OR over the set zone bits that some offering names, and over the
// capacity-type words that can hold an offered bit (mask_word sets none
// past V1)
__device__ __forceinline__ bool offer(const Offered& of, const uint32_t* atz, int t, int V1,
                                      int W, const uint32_t* cz, const uint32_t* cc) {
  const int clo = of.clo, chi = of.chi;
  for (int wz = of.zlo; wz < of.zhi; ++wz)
    for (uint32_t b = cz[wz] & of.z[wz]; b; b &= b - 1) {
      const int z = wz * 32 + __ffs(b) - 1;
      const uint32_t* row = atz + (static_cast<size_t>(t) * V1 + z) * W;
      for (int w = clo; w < chi; ++w)
        if (row[w] & cc[w]) return true;
    }
  return false;
}

// an offering of type t in domain v of the constrained axis (dkey 0: zone,
// 1: capacity type) under the entity's words on both axes — one cell of
// packing.py's toff_nt / toff_pt. atz[t, z] holds capacity-type bits,
// atc[t, c] zone bits: only the other axis's offered words can hold one.
__device__ __forceinline__ bool offer_in(const Offered& of, const uint32_t* atz,
                                         const uint32_t* atc, int dkey, int t, int v, int V1,
                                         int W, const uint32_t* cz, const uint32_t* cc) {
  const uint32_t* con = dkey == 0 ? cz : cc;
  const uint32_t* oth = dkey == 0 ? cc : cz;
  if (!bit(con, v)) return false;
  const uint32_t* row = (dkey == 0 ? atz : atc) + (static_cast<size_t>(t) * V1 + v) * W;
  const int lo = dkey == 0 ? of.clo : of.zlo, hi = dkey == 0 ? of.chi : of.zhi;
  for (int w = lo; w < hi; ++w)
    if (row[w] & oth[w]) return true;
  return false;
}

struct Dims {
  int G, T, P, N, R, K, V1, NMAX, JH, JD, zone_kid, ct_kid, wf_iters, W;
  bool has_domains, has_contrib;
  // minValues keys, values per key and their words; reservations
  int MV, MW, MWW, NRES;
  // offerings per type; the tiled mode (per-step rows, no tables)
  int O;
  bool tiled;
  // the launch's wide part of Smem lies in device memory (scan_layout)
  bool spill;
  // the claims a chunk of the claim caps sizes at once, each with its
  // own [V1] row of per-domain capacities in Smem (scan_layout: kWarps,
  // fewer where those rows would not fit shared memory)
  int cw;
  // the teams that take minValues caps at once, each with its own [MW]
  // row of fits in Smem (scan_layout: kWarps, a warp a team; else 8, 4, 2
  // or 1 where those rows would not fit shared memory)
  int mvt;
};

struct In {
  const int32_t* g_count; const float* g_req; const uint8_t* g_def;
  const uint8_t* g_neg; const uint8_t* g_mask; const int32_t* g_hcap;
  const uint8_t* g_haff; const int32_t* g_hstg; const int32_t* g_hscap;
  const uint8_t* g_hself;
  const uint8_t* compat_pg; const uint8_t* type_ok; const int32_t* n_fit;
  const int32_t* cap_ng;
  const float* t_alloc; const float* t_cap; const uint8_t* a_tzc;
  const float* p_daemon; const float* p_limit; const uint8_t* p_has_limit;
  const uint8_t* p_tol;
  const float* n_avail; const float* n_base; const int32_t* n_hcnt;
  const int32_t* nh_cnt0; const uint8_t* well_known;
  const int32_t* g_dmode; const int32_t* g_dkey; const int32_t* g_dskew;
  const uint8_t* g_dmin0; const int32_t* g_dprior; const uint8_t* g_dreg;
  const int32_t* g_drank; const int32_t* g_dtg; const uint8_t* p_mask;
  const int32_t* n_dzone; const int32_t* n_dct; const int32_t* dd0;
  // contributor counting: shared hostname / domain slots each group
  // counts toward, and each domain slot's axis
  const uint8_t* g_hcontrib; const uint8_t* g_dcontrib; const int32_t* dtg_key;
  // minValues floors [P, MV] and value one-hots [T, MV, MW]; the
  // reservation ledger's capacities [NRES] and availability
  // [NRES, T, V1, V1]
  const int32_t* p_mvmin; const uint8_t* t_mvoh; const int32_t* res_cap0;
  const uint8_t* a_res;
  // the tiled mode's row inputs (packing.py:TileInputs): template and
  // type requirement rows, the types' offerings [T, O], the node
  // requirement rows and tolerations [N, G]
  const uint8_t* p_def; const uint8_t* p_neg; const uint8_t* p_titype_ok;
  const uint8_t* t_def; const uint8_t* t_mask; const uint8_t* o_avail;
  const int32_t* o_zone; const int32_t* o_ct; const uint8_t* n_def;
  const uint8_t* n_mask; const uint8_t* n_tol;
};

// The tiled mode's scratch (device memory): one scenario's rows for the
// step, compat_row [P], type_ok_row [P, T], n_fit_row [P, T] and cap_row
// [N]; and the mask words every scenario shares, built once per launch
// (tile_words): types' tw [T, K, W], templates' pw [P, K, W], nodes' nw
// [N, K, W].
struct Rows {
  uint8_t* compat; uint8_t* tok; int32_t* nfit; int32_t* cap;
  uint32_t* tw; uint32_t* pw; uint32_t* nw;
};

// offset of template p's row for group (or class head) ``hi`` in the
// compat / type_ok / n_fit tables ([P, G(, T)]; times T for the last two),
// or of its row in the step's tiled rows ([P(, T)])
__device__ __forceinline__ size_t trow(const Dims& d, int p, int hi) {
  return d.tiled ? static_cast<size_t>(p) : static_cast<size_t>(p) * d.G + hi;
}

// offset of node n's cap for ``hi`` in cap_ng [N, G], or in the cap row
__device__ __forceinline__ size_t tcap(const Dims& d, int n, int hi) {
  return d.tiled ? static_cast<size_t>(n) : static_cast<size_t>(n) * d.G + hi;
}

// point the block's table pointers at its tiled rows (thread 0, before
// the first barrier of the kernel)
__device__ void use_rows(const Dims& d, In& in, const Rows& rw) {
  if (!d.tiled) return;
  in.compat_pg = rw.compat;
  in.type_ok = rw.tok;
  in.n_fit = rw.nfit;
  in.cap_ng = rw.cap;
}

// The mask words every scenario's row build shares (Rows::tw, pw, nw), one
// grid-stride pass before the scan kernel.
__global__ void tile_words(Dims d, In in, Rows rw) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  kt::mask_words(in.t_mask, static_cast<long long>(d.T) * d.K, d.V1, d.W, rw.tw, i0, step);
  kt::mask_words(in.p_mask, static_cast<long long>(d.P) * d.K, d.V1, d.W, rw.pw, i0, step);
  kt::mask_words(in.n_mask, static_cast<long long>(d.N) * d.K, d.V1, d.W, rw.nw, i0, step);
}

// parity: dtype float32
// parity: dtype int32
// parity: dtype bool
struct State {  // PackState in device memory (plus per-step scratch)
  float* exist_used; float* c_used; int32_t* c_npods; uint8_t* c_def;
  uint8_t* c_neg; uint8_t* c_mask; int32_t* ch_cnt; int32_t* nhc;
  float* pool_rem; int32_t* exist_cap; int32_t* claim_cap;
  int32_t* claim_fill; uint8_t* avail; uint32_t* atz;
  // domains: a_tzc[t, :, c] as zone bit words, the templates' per-domain
  // offering table, per-claim per-domain capacity, claim domain slots,
  // the shared-domain carry
  uint32_t* atc; uint8_t* toff_pt; int32_t* percap; int32_t* c_slot;
  int32_t* ddc;
  // the reservation ledger res_rem [NRES]; per-claim minValues caps
  // [NMAX] (B4: this step's cap_mv; B5: the maintained headroom mvcapv)
  int32_t* res_rem; int32_t* mvcap;
  // word tables shared by every scenario (static_words): each type's
  // minValues values per key [T, MV, MWW + 1] (the last word the span of
  // words that hold a value, lo | hi << 16); each reservation's
  // a_res[r, t, z, :] over capacity types [NRES, T, V1, W]; the held
  // availability (a_tzc or any reservation) on both axes [T, V1, W]
  uint32_t* mvw; uint32_t* ares_z; uint32_t* aheld_z; uint32_t* aheld_c;
  // the launch's offered zone and capacity-type sets [W] (offer_words)
  uint32_t* offz; uint32_t* offc;
  // the wide part of Smem where the launch spills it: one slice of
  // spill_stride bytes per block of the grid (scan_layout)
  unsigned char* spill;
};

struct Out {
  int32_t* c_pool; uint8_t* c_tmask; int32_t* n_open; uint8_t* overflow;
  int32_t* exist_fills; int32_t* claim_fills; int32_t* unplaced;
  int32_t* c_dzone; int32_t* c_dct; uint8_t* c_resv;
};

// per-step shared memory, carved from the dynamic allocation (the wide
// part from device memory where the launch spills: carve)
struct Smem {
  // the wide part: grows with the value axis (V1, its words W) and the
  // minValues axis (MW); the arrays of a path the launch never takes are
  // empty (wide_layout)
  uint32_t* cz;     // [kWarps][2][W] per-warp claim zone / capacity-type words
  uint32_t* gw;     // [K][W] the group's requirement mask words
  uint32_t* gz;     // the zone key's row of gw
  uint32_t* gc;     // ... the capacity-type key's
  uint32_t* pz;     // [P][W] template ∧ group zone words
  uint32_t* pc;     // [P][W]
  uint32_t* fresh;  // [W] fresh_ok_d bits
  int32_t* qd;      // [NSLOT] the group's domain quota
  int32_t* qrem;    // [NSLOT] what is left of it
  int32_t* ddead;   // [NSLOT] retired slots of the fresh-claim loop
  int32_t* sflag;   // [NSLOT] slots with a claim of positive cap
  // has_domains only (else empty):
  int32_t* D0;      // [V1] domain counts: priors + the shared carry
  int32_t* czcap;   // [V1] existing-node capacity per domain
  int32_t* wcap;    // [V1] water-fill caps of the quota
  int32_t* wnp;     // [V1] water-fill levels of the quota
  float* cumf;      // [V1] cumulative quota shares
  int32_t* pcap;    // [cw][V1] per-claim per-domain capacity of a claim-caps chunk
  int32_t* pmax;    // [V1] per-domain best fit of a bulk's template (B5)
  // has_contrib only:
  int32_t* dsum;    // [4][V1] contributor sums: node zone, node ct, claim zone, claim ct
  // MV > 0 only:
  int32_t* mvf;     // [mvt][MW] each minValues team's per-value fits, 0 between uses
  uint32_t* pze;    // [W] a bulk template's zone words (in the pinned domain)
  uint32_t* pce;    // [W] ... capacity-type words
  uint32_t* oz;     // [W] the launch's offered zones (offer_words)
  uint32_t* oc;     // [W] ... capacity types
  // the core part: bounded by the templates, the reservations, the
  // resources and the keys
  int32_t* mvp;     // [P] each template's minValues cap for a bulk
  int32_t* rflag;   // [NRES] reservations compatible with a bulk
  int32_t* flags;   // [1] the ledger crossed zero: rebuild the step words
  int32_t* list;    // [kThreads] claims gathered for a chunked phase
  int32_t* cand;    // [kThreads] ... and its candidates (B4's claim caps)
  int32_t* nlist;   // [2] the two lists' lengths
  int32_t* cbest;   // [kWarps] a chunk's claims' best fits (B4's claim caps)
  int32_t* mvc;     // [kWarps] a chunk's claims' minValues caps
  float* req;       // [R]
  uint8_t* gdef;    // [K]
  uint8_t* gneg;    // [K]
  uint8_t* pcompat; // [P] the step's compat_row (tile_rows; fresh_claims)
  Offered off;      // the offered sets over oz, oc (load_offered)
};

// Where each array of Smem's wide part starts, in 4-byte words from its
// head, and where the part ends. The arrays only a domain batch reads are
// empty without has_domains, the contributor sums without has_contrib,
// the minValues fits without floors: a domain-free batch at V1 2,048 needs
// its [V1 + 2] quota slots and its words only.
struct WideLay {
  size_t cz, gw, pz, pc, fresh, qd, qrem, ddead, sflag, D0, czcap, wcap, wnp, cumf, pcap, pmax,
      dsum, mvf, pze, pce, oz, oc, end;
};

__host__ __device__ inline WideLay wide_layout(const Dims& d) {
  const size_t W = d.W, V1 = d.V1, NSLOT = V1 + 2, P = d.P;
  const size_t DV = d.has_domains ? V1 : 0;
  WideLay l;
  size_t at = 0;
  l.cz = at, at += kWarps * 2 * W;
  l.gw = at, at += static_cast<size_t>(d.K) * W;
  l.pz = at, at += P * W;
  l.pc = at, at += P * W;
  l.fresh = at, at += W;
  l.qd = at, at += NSLOT;
  l.qrem = at, at += NSLOT;
  l.ddead = at, at += NSLOT;
  l.sflag = at, at += NSLOT;
  l.D0 = at, at += DV;
  l.czcap = at, at += DV;
  l.wcap = at, at += DV;
  l.wnp = at, at += DV;
  l.cumf = at, at += DV;
  l.pcap = at, at += static_cast<size_t>(d.cw) * DV;
  l.pmax = at, at += DV;
  l.dsum = at, at += d.has_contrib ? 4 * V1 : 0;
  l.mvf = at, at += d.MV ? static_cast<size_t>(d.mvt) * d.MW : 0;
  l.pze = at, at += W;
  l.pce = at, at += W;
  l.oz = at, at += W;
  l.oc = at, at += W;
  l.end = at;
  return l;
}

// Bytes of Smem's wide and core parts. Where both fit a block's shared
// memory the launch carves both from it; past that (a domain batch's
// per-domain arrays at a vocabulary of a few thousand values a key, or a
// wide minValues catalog) the wide part moves to the launch's spill
// scratch in device memory and only the core part stays shared: the same
// arrays at the same indices, so the scan decides the same at any width,
// only slower there.
__host__ __device__ inline size_t wide_bytes(const Dims& d) {
  return sizeof(uint32_t) * wide_layout(d).end;
}

__host__ __device__ inline size_t core_bytes(const Dims& d) {
  return sizeof(uint32_t) * (d.P + d.NRES + 1 + 2 * kThreads + 2 + 2 * kWarps + d.R) +
         2 * static_cast<size_t>(d.K) + d.P;
}

// one block's slice of the spill scratch (16-byte aligned)
__host__ __device__ inline size_t spill_stride(const Dims& d) {
  return (wide_bytes(d) + 15) & ~size_t{15};
}

// Set d.spill for a launch of ``kernel`` and write the dynamic shared
// memory it asks for: both parts of Smem where they fit the block beside
// the kernel's static shared memory, else the core part alone.
template <class Kernel>
int scan_layout(Kernel kernel, Dims& d, size_t& smem) {
  // the dynamic shared memory a block of ``kernel`` may have on the
  // current device, asked of the runtime once per kernel and device
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> caps;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  size_t cap;
  {
    std::lock_guard<std::mutex> hold(mu);
    const auto hit = caps.find(key);
    if (hit != caps.end()) {
      cap = hit->second;
    } else {
      int optin = 0;
      cudaFuncAttributes fa;
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
      if (e != cudaSuccess) return static_cast<int>(e);
      cap = caps[key] = static_cast<size_t>(optin) - fa.sharedSizeBytes;
    }
  }
  // a domain batch's claim caps size fewer claims a chunk before the
  // whole wide part leaves shared memory (each claim's maxima are its own,
  // so the chunking changes no result)
  // and a wide minValues catalog's caps take fewer, larger teams (each
  // team's fits are its own entity's, so the teams change no result)
  auto over = [&] { return wide_bytes(d) + core_bytes(d) > cap; };
  d.cw = d.mvt = kWarps;
  while (d.has_domains && d.cw > 1 && over()) d.cw /= 2;
  while (d.MV && d.mvt > 1 && over()) d.mvt = d.mvt == kWarps ? kMaxMvTeams : d.mvt / 2;
  d.spill = over();
  if (d.spill) d.cw = d.mvt = kWarps;
  smem = d.spill ? core_bytes(d) : wide_bytes(d) + core_bytes(d);
  return 0;
}

// The minValues path (MvPath) of a launch at its layout (scan_layout):
// none without floors; a warp an entity where the catalog is narrow and
// every warp has its own row of fits; else teams.
__host__ __device__ inline int mv_path(const Dims& d) {
  if (!d.MV) return kMvNone;
  return d.MW <= kMvWarpMW && d.mvt == kWarps ? kMvWarp : kMvTeam;
}

// A launch of ``kernel`` over S scenarios, in clusters of at most max_c
// blocks, at these dims: writes the dynamic shared memory a block asks
// for and the spill scratch the wrapper allocates (0 where Smem fits
// shared memory, else one slice per block of the widest grid) to
// ``out`` [2]. Returns a CUDA error code, 0 on success.
template <class Kernel>
int layout_info(Kernel kernel, Dims d, int S, int max_c, long long* out) {
  size_t smem = 0;
  const int rc = scan_layout(kernel, d, smem);
  if (rc) return rc;
  out[0] = static_cast<long long>(smem);
  out[1] = d.spill ? static_cast<long long>(S) * max_c * static_cast<long long>(spill_stride(d)) : 0;
  return 0;
}

// A launch's Smem layout (scan_layout) with its spill scratch checked:
// returns cudaErrorInvalidValue when the wide part spills and ``spill_n``
// bytes at ``spill`` are fewer than layout_info asks.
template <class Kernel>
int scan_smem(Kernel kernel, Dims& d, State& st, int S, int max_c, unsigned char* spill,
              long long spill_n, size_t& smem) {
  const int rc = scan_layout(kernel, d, smem);
  if (rc) return rc;
  if (d.spill &&
      (spill == nullptr || spill_n < static_cast<long long>(S) * max_c *
                                         static_cast<long long>(spill_stride(d))))
    return static_cast<int>(cudaErrorInvalidValue);
  st.spill = spill;
  return 0;
}

// The block's Smem: the wide part from the block's slice of the spill
// scratch ``spill`` where the launch spills, else from the head of
// ``dyn``; the core part from ``dyn`` after it.
__device__ void carve(unsigned char* dyn, const Dims& d, Smem& m, unsigned char* spill) {
  const int W = d.W;
  const WideLay l = wide_layout(d);
  uint32_t* w0 = reinterpret_cast<uint32_t*>(d.spill ? spill + blockIdx.x * spill_stride(d) : dyn);
  int32_t* i0 = reinterpret_cast<int32_t*>(w0);
  m.cz = w0 + l.cz;
  m.gw = w0 + l.gw;
  m.gz = m.gw + d.zone_kid * W;
  m.gc = m.gw + d.ct_kid * W;
  m.pz = w0 + l.pz;
  m.pc = w0 + l.pc;
  m.fresh = w0 + l.fresh;
  m.qd = i0 + l.qd;
  m.qrem = i0 + l.qrem;
  m.ddead = i0 + l.ddead;
  m.sflag = i0 + l.sflag;
  m.D0 = i0 + l.D0;
  m.czcap = i0 + l.czcap;
  m.wcap = i0 + l.wcap;
  m.wnp = i0 + l.wnp;
  m.cumf = reinterpret_cast<float*>(w0 + l.cumf);
  m.pcap = i0 + l.pcap;
  m.pmax = i0 + l.pmax;
  m.dsum = i0 + l.dsum;
  m.mvf = i0 + l.mvf;
  m.pze = w0 + l.pze;
  m.pce = w0 + l.pce;
  m.oz = w0 + l.oz;
  m.oc = w0 + l.oc;
  m.mvp = reinterpret_cast<int32_t*>(d.spill ? dyn : reinterpret_cast<unsigned char*>(w0 + l.end));
  m.rflag = m.mvp + d.P;
  m.flags = m.rflag + d.NRES;
  m.list = m.flags + 1;
  m.cand = m.list + kThreads;
  m.nlist = m.cand + kThreads;
  m.cbest = m.nlist + 2;
  m.mvc = m.cbest + kWarps;
  m.req = reinterpret_cast<float*>(m.mvc + kWarps);
  m.gdef = reinterpret_cast<uint8_t*>(m.req + d.R);
  m.gneg = m.gdef + d.K;
  m.pcompat = m.gneg + d.K;
  m.off = Offered{m.oz, m.oc, 0, 0, 0, 0};
}

// The launch's offered sets into the block's Smem (m.oz, m.oc) and the
// word ranges that hold their bits (m.off; empty ranges where nothing is
// offered); the minValues teams' fits to zero (team_minvalues keeps them
// so). Call after carve's barrier (thread 0 owns m); ends in a barrier.
__device__ void load_offered(const Dims& d, const State& st, Smem& m) {
  for (int w = threadIdx.x; w < d.W; w += kThreads) {
    m.oz[w] = st.offz[w];
    m.oc[w] = st.offc[w];
  }
  if (d.MV)
    for (int i = threadIdx.x; i < d.mvt * d.MW; i += kThreads) m.mvf[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int zlo = d.W, zhi = 0, clo = d.W, chi = 0;
    for (int w = 0; w < d.W; ++w) {
      if (m.oz[w]) zlo = min(zlo, w), zhi = w + 1;
      if (m.oc[w]) clo = min(clo, w), chi = w + 1;
    }
    m.off.zlo = zlo, m.off.zhi = zhi, m.off.clo = clo, m.off.chi = chi;
  }
  __syncthreads();
}

// The group being placed: thread 0 fills it in shared memory, every
// thread reads it. ``gi`` indexes the per-group inputs, ``ti`` the
// feasibility tables' group column (the class head in B5, whose members
// share their tables), ``dkey`` the constrained axis (the class's in B5).
struct Grp {
  int gi, ti, jhc, jd, mode, dkey, kid_sel;
  int32_t count, hcap, scap_h;
  bool haff, has_h, hself, counted, dyn, has_d;
};

__device__ void load_group(const Dims& d, const In& in, int gi, int ti, int dkey, Grp& g) {
  g.gi = gi;
  g.ti = ti;
  g.count = in.g_count[gi];
  g.hcap = in.g_hcap[gi];
  g.haff = in.g_haff[gi];
  // shared hostname constraint: self owners capped at scap_h - count and
  // counted; gate owners blocked above the threshold, never counted
  const int32_t jh = in.g_hstg[gi];
  g.has_h = jh >= 0;
  g.hself = in.g_hself[gi];
  g.jhc = min(max(jh, 0), d.JH - 1);
  g.counted = g.has_h && g.hself;
  g.scap_h = in.g_hscap[gi];
  // domain-constraint descriptors: the machinery runs for the dynamic
  // groups of a has_domains batch only (packing.py's lax.cond(dyn, ...))
  g.mode = d.has_domains ? in.g_dmode[gi] : 0;
  g.dyn = g.mode > 0;
  g.dkey = dkey;
  g.kid_sel = dkey == 0 ? d.zone_kid : d.ct_kid;
  g.jd = in.g_dtg[gi];
  g.has_d = g.dyn && g.jd >= 0;
}

__device__ __forceinline__ int32_t h_allow(const Grp& g, int32_t cnt) {
  if (!g.has_h) return kBigDom;
  if (g.hself) return max(wrap_sub(g.scap_h, cnt), 0);
  return cnt > g.scap_h ? 0 : kBigDom;
}

// a node's domain slot on the constrained axis: ANY for a group without
// domains, DEAD for a node in no registered domain
__device__ __forceinline__ int nd_slot(const Dims& d, const In& in, const Grp& g, int n) {
  if (!g.dyn) return d.V1;
  const int32_t raw = g.dkey == 0 ? in.n_dzone[n] : in.n_dct[n];
  const uint8_t* reg = in.g_dreg + static_cast<size_t>(g.gi) * d.V1;
  // a value id at or past V1 lands in no domain, like DEAD
  return (raw >= 0 && raw < d.V1 && reg[raw]) ? raw : d.V1 + 1;
}

// an offering of type t in zone z and capacity type c under the current
// ledger (packing.py's a_step): in a_tzc, or reserved in a reservation
// with capacity left
__device__ __forceinline__ bool step_avail(const Dims& d, const In& in, const State& st, int t,
                                           int z, int c) {
  const size_t cell = (static_cast<size_t>(t) * d.V1 + z) * d.V1 + c;
  if (in.a_tzc[cell]) return true;
  for (int r = 0; r < d.NRES; ++r)
    if (st.res_rem[r] > 0 && in.a_res[static_cast<size_t>(r) * d.T * d.V1 * d.V1 + cell])
      return true;
  return false;
}

// The offering bit words of the current ledger: st.atz [T, V1(z), W] over
// capacity types and, with domains, st.atc [T, V1(c), W] over zones.
// offer_words builds them for the starting ledger before the scan; a
// ledger's scan rebuilds its scenario's here whenever a reservation's
// remaining capacity reaches zero (it never rises): atz as a_tzc's words
// ORed with the words (static_words' ares_z) of each reservation with
// capacity left. Call after a barrier that published st.res_rem; ends in
// one.
__device__ void step_words(const Dims& d, const In& in, const State& st) {
  const int tid = threadIdx.x, T = d.T, V1 = d.V1, W = d.W;
  const long long cells = static_cast<long long>(T) * V1 * W;
  const bool x16 = rows_x16(in.a_tzc, V1);
  for (long long i = tid; i < cells; i += kThreads) {
    uint32_t bits = row_word16(in.a_tzc + (i / W) * V1, V1, static_cast<int>(i % W), x16);
    for (int r = 0; r < d.NRES; ++r)
      if (st.res_rem[r] > 0) bits |= st.ares_z[r * cells + i];
    st.atz[i] = bits;
  }
  if (d.has_domains)
    for (int i = tid; i < T * V1 * W; i += kThreads) {
      const int t = i / (V1 * W), c = (i / W) % V1, w = i % W;
      uint32_t bits = 0;
      for (int z = w * 32; z < V1 && z < w * 32 + 32; ++z)
        bits |= static_cast<uint32_t>(step_avail(d, in, st, t, z, c)) << (z - w * 32);
      st.atc[i] = bits;
    }
  __syncthreads();
}

// The offering words of the starting ledger (res_rem = res_cap0) and the
// launch's offered sets, one grid-stride pass over the whole card before
// the scan (the scan's own block would read T x V1 x V1 bytes alone):
// st.atz [T, V1(z), W] over capacity types, a thread a word from 32
// consecutive bytes of a_tzc (two 16-byte loads, issued before any is
// combined) ORed with those of each reservation with capacity, and, with
// domains, st.atc [T, V1(c), W] over zones; each ``copies`` times, one
// slice apart (a ledger's scenarios rebuild their own words as
// reservations drain; without a ledger the words never change and every
// scenario reads the one slice). st.offz / st.offc [W] (zeroed by the
// caller) get each zone and capacity type that a_tzc or any reservation
// offers at all (packing.py's a_held): every offering word the scan reads
// lies inside them (Offered).
__global__ void offer_words(Dims d, In in, State st, int copies) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int T = d.T, V1 = d.V1, W = d.W, NRES = d.NRES;
  const long long cells = static_cast<long long>(T) * V1 * W;
  const size_t plane = static_cast<size_t>(T) * V1 * V1;
  const bool x16 = rows_x16(in.a_tzc, V1) && (NRES == 0 || rows_x16(in.a_res, V1));
  for (long long i = i0; i < cells; i += step) {
    const size_t tz = static_cast<size_t>(i / W);
    const int w = static_cast<int>(i % W);
    uint32_t cur = row_word16(in.a_tzc + tz * V1, V1, w, x16), held = cur;
    for (int r = 0; r < NRES; ++r) {
      const uint32_t b = row_word16(in.a_res + r * plane + tz * V1, V1, w, x16);
      held |= b;
      if (in.res_cap0[r] > 0) cur |= b;
    }
    for (int c = 0; c < copies; ++c) st.atz[c * cells + i] = cur;
    if (held) {
      const int z = static_cast<int>(tz % V1);
      atomicOr(&st.offc[w], held);
      atomicOr(&st.offz[z >> 5], 1u << (z & 31));
    }
  }
  if (!d.has_domains) return;
  for (long long i = i0; i < cells; i += step) {
    const int t = static_cast<int>(i / (static_cast<long long>(V1) * W));
    const int c = static_cast<int>((i / W) % V1), wz = static_cast<int>(i % W);
    uint32_t bits = 0;
    for (int z = wz * 32; z < V1 && z < wz * 32 + 32; ++z) {
      const size_t cell = (static_cast<size_t>(t) * V1 + z) * V1 + c;
      bool on = in.a_tzc[cell];
      for (int r = 0; r < NRES && !on; ++r) on = in.res_cap0[r] > 0 && in.a_res[r * plane + cell];
      bits |= static_cast<uint32_t>(on) << (z - wz * 32);
    }
    for (int k = 0; k < copies; ++k) st.atc[k * cells + i] = bits;
  }
}

// offer_words' grid over ``cells`` words: 256 threads a block, at most
// the 2,048 threads each of the card's 132 SMs holds at once (a
// grid-stride loop past that)
inline int offer_blocks(long long cells) {
  const int g = kt::grid_for(cells, 256);
  return g < 132 * 8 ? g : 132 * 8;
}

// The word tables every scenario shares (State::mvw, ares_z, aheld_z,
// aheld_c), one grid-stride pass before the scan kernel: t_mvoh's values
// as words (for the kMvTeam path a warp a (type, key) row, with the span
// of words that hold a value: an instance type offers one value of its
// own key, so its walk in team_minvalues reads one word, not MWW; for the
// warp path, which walks every word of a narrow row, a thread a word);
// each reservation's a_res[r, t, z, :]; the held availability a_tzc |
// any_r a_res[r] (packing.py's a_held) on both axes. Launched with a
// multiple of 32 threads a block, after scan_layout.
__global__ void static_words(Dims d, In in, State st) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int T = d.T, V1 = d.V1, W = d.W, MW = d.MW, MWW = d.MWW, NRES = d.NRES;
  const int lane = threadIdx.x & 31;
  const bool x16 = rows_x16(in.t_mvoh, MW);
  if (mv_path(d) == kMvWarp) {
    for (long long i = i0; i < static_cast<long long>(T) * d.MV * MWW; i += step) {
      const long long tj = i / MWW;
      const int ww = static_cast<int>(i % MWW);
      st.mvw[tj * (MWW + 1) + ww] = mask_word(in.t_mvoh + tj * MW, MW, ww);
    }
  } else {
    for (long long r = i0 >> 5; r < static_cast<long long>(T) * d.MV; r += step >> 5) {
      const uint8_t* row = in.t_mvoh + r * MW;
      uint32_t* words = st.mvw + r * (MWW + 1);
      int lo = MWW, hi = 0;
      for (int w0 = 0; w0 < MWW; w0 += 32) {
        const int w = w0 + lane;
        const uint32_t bits = w < MWW ? row_word16(row, MW, w, x16) : 0u;
        if (w < MWW) words[w] = bits;
        const unsigned on = __ballot_sync(kFull, bits != 0);
        if (on) lo = min(lo, w0 + __ffs(on) - 1), hi = w0 + 32 - __clz(on);
      }
      if (lane == 0) words[MWW] = lo < hi ? static_cast<uint32_t>(lo | hi << 16) : 0u;
    }
  }
  const long long cells = static_cast<long long>(T) * V1 * W;
  for (long long i = i0; i < NRES * cells; i += step)
    st.ares_z[i] = mask_word(in.a_res + (i / W) * V1, V1, static_cast<int>(i % W));
  if (!NRES) return;
  for (long long i = i0; i < cells; i += step) {
    const int t = static_cast<int>(i / (V1 * W)), v = static_cast<int>((i / W) % V1);
    const int w = static_cast<int>(i % W);
    const size_t tv = static_cast<size_t>(t) * V1 + v;
    uint32_t bz = mask_word(in.a_tzc + tv * V1, V1, w);
    for (int r = 0; r < NRES; ++r)
      bz |= mask_word(in.a_res + (static_cast<size_t>(r) * T * V1 + tv) * V1, V1, w);
    st.aheld_z[i] = bz;
    if (d.has_domains) {
      uint32_t bc = 0;
      for (int z = w * 32; z < V1 && z < w * 32 + 32; ++z) {
        const size_t cell = (static_cast<size_t>(t) * V1 + z) * V1 + v;
        bool on = in.a_tzc[cell];
        for (int r = 0; r < NRES && !on; ++r)
          on = in.a_res[static_cast<size_t>(r) * T * V1 * V1 + cell];
        bc |= static_cast<uint32_t>(on) << (z - w * 32);
      }
      st.aheld_c[i] = bc;
    }
  }
}

// the offering words claim s sees on each axis: what it holds once it
// holds reservations (packing.py's off_held / a_held), else the current
// ledger's
__device__ __forceinline__ const uint32_t* claim_atz(const Dims& d, const State& st,
                                                     const Out& out, int s) {
  return (d.NRES && out.c_resv[s]) ? st.aheld_z : st.atz;
}

__device__ __forceinline__ const uint32_t* claim_atc(const Dims& d, const State& st,
                                                     const Out& out, int s) {
  return (d.NRES && out.c_resv[s]) ? st.aheld_c : st.atc;
}

// parity: phase min-values
// minvalues_cap (packing.py:153) for one entity, by one whole warp (the
// kMvWarp path). For each key j with a floor, f[w] is the largest fit over
// the entity's masked types offering catalog value w (``cell(t, fit)``
// says whether type t is masked and gives its fit), and the key's cap is
// the floor-th largest f[w]: the largest x with #{w : f[w] >= x} >=
// floor, selected by counting, bit by bit from the top (int32 fits; only
// the k-th value matters, so nothing is sorted). A floor of 0 imposes no
// cap (kBigDom), one above MW gives 0; the cap is the min over keys.
// fits_count is never negative, so f starting at 0 equals the reference's
// max over where(mask, fit, 0). Ends in __syncwarp.
template <class Cell>
__device__ int32_t warp_minvalues(const Dims& d, const State& st, const Smem& m,
                                  const int32_t* floors, Cell cell) {
  const int lane = threadIdx.x & 31;
  int32_t* f = m.mvf + (threadIdx.x >> 5) * d.MW;
  int32_t cap = kBigDom;
  for (int j = 0; j < d.MV; ++j) {
    const int32_t fl = floors[j];
    if (fl <= 0) continue;
    if (fl > d.MW) {
      cap = 0;
      continue;
    }
    for (int w = lane; w < d.MW; w += 32) f[w] = 0;
    __syncwarp();
    for (int t = lane; t < d.T; t += 32) {
      int32_t fit;
      if (!cell(t, fit)) continue;
      const uint32_t* words = st.mvw + (static_cast<size_t>(t) * d.MV + j) * (d.MWW + 1);
      for (int ww = 0; ww < d.MWW; ++ww)
        for (uint32_t b = words[ww]; b; b &= b - 1) atomicMax(&f[ww * 32 + __ffs(b) - 1], fit);
    }
    __syncwarp();
    int32_t x = 0;
    for (int bitpos = 30; bitpos >= 0; --bitpos) {
      const int32_t cand = x | (1 << bitpos);
      unsigned cnt = 0;
      for (int w = lane; w < d.MW; w += 32) cnt += f[w] >= cand ? 1u : 0u;
      if (static_cast<int32_t>(__reduce_add_sync(kFull, cnt)) >= fl) x = cand;
    }
    cap = min(cap, x);
    __syncwarp();
  }
  return cap;
}

// The minValues teams for ``n`` entities: the power of two of at least n
// up to the layout's d.mvt, teams of more than one warp at most kMaxMvTeams
// (a named barrier each), or a warp a team where the layout affords
// kWarps teams and n needs more than kMaxMvTeams.
__device__ __forceinline__ int mv_teams(const Dims& d, int n) {
  if (d.mvt == kWarps && n > kMaxMvTeams) return kWarps;
  int t = 1;
  while (t < n && t < d.mvt && t < kMaxMvTeams) t <<= 1;
  return t;
}

// the barrier of team ``k`` of ``nt`` threads: a warp's, the block's, or
// named barrier k + 1
__device__ __forceinline__ void team_sync(int k, int nt) {
  if (nt == 32)
    __syncwarp();
  else if (nt == kThreads)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(k + 1), "r"(nt) : "memory");
}

// The floor-th largest of the fits ``f`` [MW] (every entry >= 0; 0 at
// every value no masked type offers), by one warp, exactly: the positive
// entries compacted to the head of f in slot order (the rest zeroed), then
// the largest x with #{f >= x} >= floor, bit by bit from the top bit of
// their maximum (int32 fits), over the compacted entries only; f is all
// zero again when it returns. Fewer positive entries than the floor give
// 0 (the zeros are the rest); a floor of 1 is their maximum. 0 < floor <=
// MW.
__device__ int32_t warp_select(int32_t* f, int MW, int32_t floor) {
  const int lane = threadIdx.x & 31;
  int c = 0;
  int32_t mx = 0;
  for (int w0 = 0; w0 < MW; w0 += 32) {
    const int w = w0 + lane;
    const int32_t v = w < MW ? f[w] : 0;
    const unsigned on = __ballot_sync(kFull, v > 0);
    if (!on) continue;
    // a moved entry lands at or below its own slot, in this chunk or in
    // the zeroed tail of the compacted head
    if (v > 0) f[w] = 0;
    __syncwarp();
    if (v > 0) f[c + __popc(on & ((1u << lane) - 1))] = v;
    __syncwarp();
    c += __popc(on);
    mx = max(mx, v);
  }
  for (int o = 16; o; o >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, o));
  int32_t x = 0;
  if (floor == 1) {
    x = mx;
  } else if (floor <= c) {
    for (int b = 31 - __clz(mx); b >= 0; --b) {
      const int32_t cand = x | (1 << b);
      unsigned cnt = 0;
      for (int i = lane; i < c; i += 32) cnt += f[i] >= cand ? 1u : 0u;
      if (static_cast<int32_t>(__reduce_add_sync(kFull, cnt)) >= floor) x = cand;
    }
  }
  for (int i = lane; i < c; i += 32) f[i] = 0;
  __syncwarp();
  return x;
}

// minvalues_cap (packing.py:153) for ``n`` entities (templates or claims),
// by teams of threads (mv_teams), entity e by team e % teams (the kMvTeam
// path). For each key
// j with a floor, f[w] is the largest fit over the entity's masked types
// offering catalog value w (``cell(e, t, fit)`` says whether type t is
// masked for e and gives its fit): the team's threads walk the types, each
// type's value words only over their span (static_words), into the team's
// row of m.mvf by shared atomicMax; the team's first warp then takes the
// key's cap, the floor-th largest f[w] (warp_select). A floor of 0 imposes
// no cap (kBigDom), one above MW gives 0; the cap is the min over keys.
// fits_count is never negative, so f starting at 0 equals the reference's
// max over where(mask, fit, 0), and a fit of 0 leaves it as it is.
// ``floors(e)`` gives e's [MV] floors, or null where e takes no cap;
// ``put(e, cap)`` runs on the team's first thread. A team takes no more
// warps than its walk needs at two types a thread (the rest of its share
// of the block waits at the caller's next barrier). Call with every
// thread of the block, after a barrier that publishes what ``floors`` and
// ``cell`` read; m.mvf is zero before and after. Its callers call it from
// out of line (template_minvalues, and the scans' claim-side callers), so
// that its registers do not weigh on the phases around it.
template <class Floors, class Cell, class Put>
__device__ __forceinline__ void team_minvalues(const Dims& d, const State& st, const Smem& m,
                                               int n, Floors floors, Cell cell, Put put) {
  const int teams = mv_teams(d, n), share = kThreads / teams;
  int nt = share;
  while (nt > 32 && nt >= d.T) nt >>= 1;
  const int k = threadIdx.x / share, r = threadIdx.x - k * share;
  if (r >= nt) return;
  int32_t* f = m.mvf + static_cast<size_t>(k) * d.MW;
  const int MWW = d.MWW;
  for (int e = k; e < n; e += teams) {
    const int32_t* fl = floors(e);
    int32_t cap = kBigDom;
    for (int j = 0; fl != nullptr && j < d.MV; ++j) {
      const int32_t floor = fl[j];
      if (floor <= 0) continue;
      if (floor > d.MW) {
        cap = 0;
        continue;
      }
      for (int t = r; t < d.T; t += nt) {
        int32_t fit;
        if (!cell(e, t, fit) || fit <= 0) continue;
        const uint32_t* words = st.mvw + (static_cast<size_t>(t) * d.MV + j) * (MWW + 1);
        const uint32_t span = words[MWW];
        for (int ww = span & 0xffffu; ww < static_cast<int>(span >> 16); ++ww)
          for (uint32_t b = words[ww]; b; b &= b - 1) atomicMax(&f[ww * 32 + __ffs(b) - 1], fit);
      }
      team_sync(k, nt);
      if (r < 32) cap = min(cap, warp_select(f, d.MW, floor));
      team_sync(k, nt);
    }
    if (r == 0) put(e, cap);
  }
}

// each template's minValues cap for a bulk over its available types
// (st.avail) and its fits for the group or class head ``ti``, into m.mvp
// (team_minvalues, a team a template: one template takes as many warps
// as its types need, up to the whole block)
__device__ __noinline__ void template_minvalues(const Dims& d, const In& in, const State& st,
                                                const Smem& m, int ti) {
  team_minvalues(
      d, st, m, d.P, [&](int p) { return in.p_mvmin + static_cast<size_t>(p) * d.MV; },
      [&](int p, int t, int32_t& fit) {
        fit = in.n_fit[trow(d, p, ti) * d.T + t];
        return st.avail[static_cast<size_t>(p) * d.T + t] != 0;
      },
      [&](int p, int32_t c) { m.mvp[p] = c; });
}

// ---- pack state init (PackState, packing.py:357) ----
// parity: state exist_used, c_used, c_npods, c_active, c_pool, c_tmask
// parity: state c_def, c_neg, c_mask, c_dzone, c_dct, ch_cnt, nhc
// parity: state ddc, res_rem, c_resv, pool_rem, n_open, overflow
// Ends in a block barrier.
__device__ void init_state(const Dims& d, const In& in, const State& st, const Out& out) {
  const int tid = threadIdx.x;
  const int T = d.T, N = d.N, R = d.R, K = d.K, V1 = d.V1, NMAX = d.NMAX, W = d.W;
  for (int i = tid; i < N * R; i += kThreads) st.exist_used[i] = in.n_base[i];
  for (int i = tid; i < NMAX * R; i += kThreads) st.c_used[i] = 0.0f;
  // the per-step claim state too: the live extent never rewrites a slot
  // past n_open, so each holds these until a bulk opens it
  for (int i = tid; i < NMAX; i += kThreads) {
    st.c_npods[i] = 0;
    out.c_pool[i] = 0;
    out.c_dzone[i] = -1;
    out.c_dct[i] = -1;
    out.c_resv[i] = 0;
    st.claim_cap[i] = 0;
    st.claim_fill[i] = 0;
    if (d.has_domains) st.c_slot[i] = V1 + 1;  // DEAD
    if (d.MV) st.mvcap[i] = 0;
  }
  if (d.has_domains)
    for (long long i = tid; i < static_cast<long long>(NMAX) * V1; i += kThreads) st.percap[i] = 0;
  for (long long i = tid; i < static_cast<long long>(NMAX) * T; i += kThreads)
    out.c_tmask[i] = 0;
  for (int i = tid; i < NMAX * K; i += kThreads) {
    st.c_def[i] = 0;
    st.c_neg[i] = 0;
  }
  // four values a store (V1 % 4 == 0: ops/packing.py:_check_scan_inputs)
  uint32_t* cm = reinterpret_cast<uint32_t*>(st.c_mask);
  for (long long i = tid; i < static_cast<long long>(NMAX) * K * V1 / 4; i += kThreads)
    cm[i] = 0x01010101u;
  for (int i = tid; i < NMAX * d.JH; i += kThreads) st.ch_cnt[i] = 0;
  for (int i = tid; i < N * d.JH; i += kThreads) st.nhc[i] = in.nh_cnt0[i];
  for (int i = tid; i < d.JD * V1; i += kThreads) st.ddc[i] = in.dd0[i];
  for (int i = tid; i < d.P * R; i += kThreads) st.pool_rem[i] = in.p_limit[i];
  for (int r = tid; r < d.NRES; r += kThreads) st.res_rem[r] = in.res_cap0[r];
  // the starting ledger's offering words: offer_words, before the scan
  __syncthreads();
}

// The group's request and requirement rows (row ``gi`` of the group
// inputs) and its mask words into Smem. No barrier.
__device__ void load_rows(const Dims& d, const In& in, int gi, const Smem& m) {
  const int tid = threadIdx.x, K = d.K, V1 = d.V1;
  for (int i = tid; i < d.R; i += kThreads) m.req[i] = in.g_req[static_cast<size_t>(gi) * d.R + i];
  for (int i = tid; i < K; i += kThreads) {
    m.gdef[i] = in.g_def[gi * K + i];
    m.gneg[i] = in.g_neg[gi * K + i];
  }
  kt::mask_words(in.g_mask + static_cast<size_t>(gi) * K * V1, K, V1, d.W, m.gw, tid, kThreads);
}

// block ``rank``'s share [lo, hi) of [0, n) among ``ranks`` blocks of a
// cluster: contiguous, in rank order
__device__ __forceinline__ void rank_share(int n, int rank, int ranks, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(n) * rank / ranks);
  hi = static_cast<int>(static_cast<long long>(n) * (rank + 1) / ranks);
}

// parity: phase tile-rows
// packing.py:_tile_rows for group (or class head) ``hi``: compat_row =
// p_tol ∧ Compatible(template, group) with the well-known allowance;
// type_ok_row = the type ∩ (template ∪ group) intersect ∧ an offering
// under the merged zone / capacity-type masks ∧ n_fit >= 1 ∧
// p_titype_ok ∧ compat_row; n_fit_row = fits_count(t_alloc, p_daemon,
// g_req) (written as zeros on a row whose compat_row is false, a row the
// scan never reads); cap_row = strict node compatibility (no allowance) ∧
// n_tol, times fits_count(n_avail, n_base, g_req). B3's cell functions
// over the mask words (the group's from load_rows, in shared memory), and
// the bit-exact fits_count. Block ``rank`` of a cluster of ``ranks``
// builds its share: the templates' compat_row and the nodes' cap_row of
// its share of P and N, and the cells of its share of the types, for
// every template (each block works out every compat_row for itself, in
// m.pcompat). Needs tile_words and load_rows(hi); call after a barrier;
// ends in one (a block barrier: the cluster's ranks then meet at theirs).
// Kept out of line: inlined into the scan it slowed every step of the
// tenant cell's scan by ~16%, untiled steps too, with the row build's own
// time unchanged (tenant_scan.py, H100).
__device__ __noinline__ void tile_rows(const Dims& d, const In& in, const Rows& rw,
                                       const Smem& m, int hi, int rank, int ranks) {
  const int tid = threadIdx.x, P = d.P, T = d.T, K = d.K, R = d.R, O = d.O, W = d.W;
  const size_t KW = static_cast<size_t>(K) * W;
  int p_lo, p_hi, n_lo, n_hi, t_lo, t_hi;
  rank_share(P, rank, ranks, p_lo, p_hi);
  rank_share(d.N, rank, ranks, n_lo, n_hi);
  rank_share(T, rank, ranks, t_lo, t_hi);
  for (int p = tid; p < P; p += kThreads) {
    const bool ok = in.p_tol[static_cast<size_t>(p) * d.G + hi] &&
                    kt::dense_compatible(in.p_def + static_cast<size_t>(p) * K,
                                         in.p_neg + static_cast<size_t>(p) * K, rw.pw + p * KW,
                                         m.gdef, m.gneg, m.gw, in.well_known, K, W);
    m.pcompat[p] = ok;
    if (p >= p_lo && p < p_hi) rw.compat[p] = ok;
  }
  for (int n = n_lo + tid; n < n_hi; n += kThreads) {
    // a node's labels are never negated and get no well-known allowance
    const bool ok = in.n_tol[static_cast<size_t>(n) * d.G + hi] &&
                    kt::dense_compatible(in.n_def + static_cast<size_t>(n) * K, nullptr,
                                         rw.nw + n * KW, m.gdef, m.gneg, m.gw, nullptr, K, W);
    rw.cap[n] = ok ? fits_count(in.n_avail + static_cast<size_t>(n) * R,
                                in.n_base + static_cast<size_t>(n) * R, m.req, R)
                   : 0;
  }
  __syncthreads();
  // the (template, type) cells of the share, templates outer. A template
  // the group is not compatible with has no type_ok cell, and then its
  // n_fit row is never read (the scan reads n_fit only where type_ok
  // holds: the avail cells, and the bulk template p_star's row, which has
  // one), so its row is written as zeros without a fits_count: under a
  // tenant taint that is every template but the group's own
  const int TS = t_hi - t_lo;
  for (int i = tid; i < P * TS; i += kThreads) {
    const int p = i / TS, t = t_lo + (i - p * TS);
    const size_t cell = static_cast<size_t>(p) * T + t;
    if (!m.pcompat[p]) {
      rw.nfit[cell] = 0;
      rw.tok[cell] = 0;
      continue;
    }
    const uint32_t* pw = rw.pw + p * KW;
    const int32_t nf = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                  in.p_daemon + static_cast<size_t>(p) * R, m.req, R);
    const bool ok =
        nf >= 1 && in.p_titype_ok[cell] &&
        kt::dense_type_compat(in.t_def + static_cast<size_t>(t) * K, rw.tw + t * KW,
                              in.p_def + static_cast<size_t>(p) * K, pw, m.gdef, m.gw, K, W) &&
        kt::dense_offering_ok(pw + static_cast<size_t>(d.zone_kid) * W,
                              pw + static_cast<size_t>(d.ct_kid) * W, m.gz, m.gc,
                              in.o_avail + static_cast<size_t>(t) * O,
                              in.o_zone + static_cast<size_t>(t) * O,
                              in.o_ct + static_cast<size_t>(t) * O, O);
    rw.nfit[cell] = nf;
    rw.tok[cell] = ok;
  }
  __syncthreads();
}


// The templates' zone / capacity-type words merged with the group
// requirement rows of ``gi`` (packing.py's pzm / pcm) into m.pz / m.pc.
// Ends in a barrier.
__device__ void template_words(const Dims& d, const In& in, const Smem& m, int gi) {
  const int tid = threadIdx.x, V1 = d.V1, W = d.W, K = d.K;
  const uint8_t* gm = in.g_mask + static_cast<size_t>(gi) * K * V1;
  for (int i = tid; i < d.P * W; i += kThreads) {
    const uint8_t* pm = in.p_mask + static_cast<size_t>(i / W) * K * V1;
    m.pz[i] = mask_word(pm + d.zone_kid * V1, V1, i % W) & mask_word(gm + d.zone_kid * V1, V1, i % W);
    m.pc[i] = mask_word(pm + d.ct_kid * V1, V1, i % W) & mask_word(gm + d.ct_kid * V1, V1, i % W);
  }
  __syncthreads();
}

// The templates' per-domain offering table toff_pt [P, T, V1] on axis
// ``dkey`` under the current ledger, and fresh_ok_d (some type a template
// may open for the group in table column ``ti`` has an offering in the
// domain). Needs template_words; ends in a barrier.
__device__ void template_domains(const Dims& d, const In& in, const State& st, const Smem& m,
                                 int ti, int dkey) {
  const int tid = threadIdx.x, P = d.P, T = d.T, V1 = d.V1, W = d.W;
  for (int i = tid; i < W; i += kThreads) m.fresh[i] = 0;
  __syncthreads();
  for (long long i = tid; i < static_cast<long long>(P) * T * V1; i += kThreads) {
    const int p = static_cast<int>(i / (static_cast<long long>(T) * V1));
    const int t = static_cast<int>((i / V1) % T), v = static_cast<int>(i % V1);
    const bool ok = offer_in(m.off, st.atz, st.atc, dkey, t, v, V1, W, m.pz + p * W, m.pc + p * W);
    st.toff_pt[i] = ok;
    if (ok && in.type_ok[trow(d, p, ti) * T + t])
      atomicOr(&m.fresh[v >> 5], 1u << (v & 31));
  }
  __syncthreads();
}

// Is open claim ``s`` compatible with the group (packing.py: key_ok ∧
// custom_ok ∧ the template's tolerations and compatibility in table
// column ``ti``)? Called by one whole warp; every lane gets the answer.
__device__ bool warp_claim_compat(const Dims& d, const In& in, const State& st, const Out& out,
                                  const Smem& m, int s, int ti) {
  const int lane = threadIdx.x & 31, K = d.K, V1 = d.V1, W = d.W;
  // the claim's template first: one read answers for most claims of a
  // batch over several pools (the same on every lane)
  const int pp = out.c_pool[s];
  if (!(in.p_tol[pp * d.G + ti] && in.compat_pg[trow(d, pp, ti)])) return false;
  // a lane a key: key_ok = overlap || (sn && gneg) || !(sd && gdef), the
  // overlap of the claim's and the group's values only where the rest does
  // not settle it; a lane walks its key's words itself up to kLaneWords,
  // and past that the warp walks each such key's words together (the
  // lanes' 16-byte loads where the rows allow)
  constexpr int kLaneWords = 4;
  const uint8_t* row = st.c_mask + static_cast<size_t>(s) * K * V1;
  const bool x16 = rows_x16(row, V1);
  bool ok = true;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    bool need = false;
    if (k < K) {
      const bool sd = st.c_def[s * K + k], sn = st.c_neg[s * K + k];
      const bool custom = !m.gdef[k] || in.well_known[k] || sd || m.gneg[k];
      if (!custom) {
        ok = false;
      } else if (!((sn && m.gneg[k]) || !(sd && m.gdef[k]))) {
        need = W > kLaneWords;
        if (!need) {
          bool ov = false;
          for (int w = 0; w < W && !ov; ++w)
            ov = (row_word16(row + static_cast<size_t>(k) * V1, V1, w, x16) & m.gw[k * W + w]) != 0;
          ok = ok && ov;
        }
      }
    }
    if (!__all_sync(kFull, ok)) return false;
    for (unsigned b = __ballot_sync(kFull, need); b; b &= b - 1) {
      const int kk = k0 + __ffs(b) - 1;
      const uint8_t* sm = row + static_cast<size_t>(kk) * V1;
      bool ov = false;
      for (int w = lane; w < W && !ov; w += 32)
        ov = (row_word16(sm, V1, w, x16) & m.gw[kk * W + w]) != 0;
      if (!__any_sync(kFull, ov)) return false;
    }
  }
  return true;
}

// The warp's claim zone / capacity-type words, merged with the group's:
// every word, W past 32 too (lane l takes words l, l + 32, ...). Called by
// one whole warp; ends in __syncwarp.
__device__ uint32_t* warp_claim_words(const Dims& d, const State& st, const Smem& m, int s) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, W = d.W;
  uint32_t* wcz = m.cz + wid * 2 * W;
  const uint8_t* row = st.c_mask + static_cast<size_t>(s) * d.K * d.V1;
  const uint8_t* rz = row + static_cast<size_t>(d.zone_kid) * d.V1;
  const uint8_t* rc = row + static_cast<size_t>(d.ct_kid) * d.V1;
  const bool x16 = rows_x16(rz, d.V1) && rows_x16(rc, d.V1);
  for (int w = lane; w < W; w += 32) {
    wcz[w] = row_word16(rz, d.V1, w, x16) & m.gz[w];
    wcz[W + w] = row_word16(rc, d.V1, w, x16) & m.gc[w];
  }
  __syncwarp();
  return wcz;
}

// hostname-affinity single-entity pin over the node caps ``cap`` [N]:
// with priors the prior-holding nodes, without, the first node with room
// hosts everyone. Returns whether an existing node serves the group.
// Call after a barrier that published ``cap``; ends in a barrier.
__device__ bool haff_pin_nodes(const Dims& d, const In& in, const Grp& g, int32_t* cap, Shared& sh) {
  const int tid = threadIdx.x, N = d.N, G = d.G;
  bool served = false;
  if (N && g.haff) {
    int32_t prior = 0, first_free = INT_MAX;
    for (int n = tid; n < N; n += kThreads) {
      prior |= in.n_hcnt[static_cast<size_t>(n) * G + g.gi] > 0;
      if (cap[n] >= 1) first_free = min(first_free, n);
    }
    const bool has_prior = block_max(prior, sh) > 0;
    first_free = block_min(first_free, sh);
    const bool has_free = first_free != INT_MAX;
    for (int n = tid; n < N; n += kThreads) {
      const bool keep = has_prior ? in.n_hcnt[static_cast<size_t>(n) * G + g.gi] > 0
                                  : (has_free && n == first_free);
      if (!keep) cap[n] = 0;
    }
    served = has_prior || has_free;
  }
  __syncthreads();
  return served;
}

// The live extent: the claim-axis phases walk slots [0, ns), ns the open
// claims (n_open), never NMAX. Every slot at or past n_open holds its
// initial state (init_state: no pods, no capacity, no fill, no domain, no
// pin, a clear type mask), so it adds nothing to a sum, a max, a scan or
// a water-fill, and no slot past it is ever written but by the bulk that
// opens it. g_hcap >= 0 (HCAP_NONE or a topology cap), so the caps the
// full walk gave those slots were 0.

// slots a thread keeps in registers for the water-fill's bisection trips
// (live extents up to kWfRegs x 1024; past that the trips read the slots)
constexpr int kWfRegs = 2;

// waterfill (packing.py:105): smallest level L with
// sum(clip(L - npods, 0, cap)) >= n by bisection ((lo + hi) // 2, at most
// `iters` trips), then the deficit layer handed out by slot index, over
// the live slots [0, ns). With `slot_of`, only slots s with slot_of[s] ==
// sl take part: the others act as (npods _BIGI, cap 0), which contribute
// nothing and are never filled, and their `fill` entries are left
// untouched. Each thread's slots stay in registers across the trips when
// ns <= kWfRegs x 1024. Ends in a barrier.
__device__ void waterfill(const int32_t* npods, const int32_t* cap, int32_t n,
                          int iters, int32_t* fill, int ns, Shared& sh,
                          const int32_t* slot_of = nullptr, int sl = 0) {
  const int tid = threadIdx.x;
  auto member = [&](int s) { return s < ns && (slot_of == nullptr || slot_of[s] == sl); };
  const bool cached = ns <= kWfRegs * kThreads;  // block-uniform
  int32_t rnp[kWfRegs], rcap[kWfRegs];
  bool rin[kWfRegs];
#pragma unroll
  for (int j = 0; j < kWfRegs; ++j) {
    const int s = tid + j * kThreads;
    rin[j] = cached && member(s);
    rnp[j] = rin[j] ? npods[s] : 0;
    rcap[j] = rin[j] ? cap[s] : 0;  // cap 0 adds nothing anywhere below
  }
  // the empty and the non-member slots of the full walk added hmax 0
  int32_t tot = 0, hmax = 0;
  if (cached) {
#pragma unroll
    for (int j = 0; j < kWfRegs; ++j) {
      tot = wrap_add(tot, rcap[j]);
      hmax = max(hmax, rcap[j] > 0 ? rnp[j] + rcap[j] : 0);
    }
  } else {
    for (int s = tid; s < ns; s += kThreads) {
      const int32_t c = member(s) ? cap[s] : 0;
      tot = wrap_add(tot, c);
      hmax = max(hmax, c > 0 ? npods[s] + c : 0);
    }
  }
  n = min(n, block_sum(tot, sh));
  int32_t lo = 0, hi = block_max(hmax, sh) + 1;
  for (int i = 0; hi - lo > 1 && i < iters; ++i) {
    const int32_t mid = (lo + hi) / 2;
    int32_t f = 0;
    if (cached) {
#pragma unroll
      for (int j = 0; j < kWfRegs; ++j) f = wrap_add(f, clip(mid - rnp[j], 0, rcap[j]));
    } else {
      for (int s = tid; s < ns; s += kThreads)
        if (member(s)) f = wrap_add(f, clip(mid - npods[s], 0, cap[s]));
    }
    if (block_sum(f, sh) >= n)
      hi = mid;
    else
      lo = mid;
  }
  const int32_t level = hi;
  int32_t bsum = 0;
  if (cached) {
#pragma unroll
    for (int j = 0; j < kWfRegs; ++j)
      bsum = wrap_add(bsum, clip(level - 1 - rnp[j], 0, rcap[j]));
  } else {
    for (int s = tid; s < ns; s += kThreads)
      if (member(s)) bsum = wrap_add(bsum, clip(level - 1 - npods[s], 0, cap[s]));
  }
  const int32_t deficit = wrap_sub(n, block_sum(bsum, sh));
  // the deficit layer by slot index: one block scan per 1024 slots
  auto layer = [&](int s, bool m, int32_t np, int32_t c, int32_t& carry) {
    int32_t b = 0;
    bool elig = false;
    if (m) {
      b = clip(level - 1 - np, 0, c);
      elig = (b < c) && (np <= level - 1);
    }
    int32_t chunk;
    const int32_t rank = wrap_add(carry, block_scan(elig ? 1 : 0, sh, &chunk));
    if (m) fill[s] = b + ((elig && rank <= deficit) ? 1 : 0);
    carry = wrap_add(carry, chunk);
  };
  int32_t carry = 0;
  if (cached) {
#pragma unroll
    for (int j = 0; j < kWfRegs; ++j)
      if (j * kThreads < ns) layer(tid + j * kThreads, rin[j], rnp[j], rcap[j], carry);
  } else {
    for (int base = 0; base < ns; base += kThreads) {
      const int s = base + tid;
      const bool m = member(s);
      layer(s, m, m ? npods[s] : 0, m ? cap[s] : 0, carry);
    }
  }
  __syncthreads();
}

// waterfill1 (packing.py:82): for n <= 1 the pod lands on the first
// least-loaded slot with capacity, no bisection; over the live slots [0,
// ns). Ends in a barrier.
__device__ void waterfill1(const int32_t* npods, const int32_t* cap, int32_t n, int iters,
                           int32_t* fill, int ns, Shared& sh) {
  if (n > 1) {
    waterfill(npods, cap, n, iters, fill, ns, sh);
    return;
  }
  unsigned long long key = ~0ull;
  for (int s = threadIdx.x; s < ns; s += kThreads)
    if (cap[s] > 0) {
      const unsigned long long k2 = load_key(npods[s], s);
      key = k2 < key ? k2 : key;
    }
  key = block_min_u64(key, sh);
  const int tstar = (n >= 1 && key != ~0ull) ? static_cast<int>(key & 0xffffffffu) : -1;
  for (int s = threadIdx.x; s < ns; s += kThreads) fill[s] = s == tstar ? 1 : 0;
  __syncthreads();
}

// the same water-fill by one thread over a few slots (the domain quota);
// ``wf1``: waterfill1's closed form for n <= 1
__device__ void waterfill_serial(const int32_t* npods, const int32_t* cap, int32_t n,
                                 int iters, int32_t* fill, int M, bool wf1) {
  if (wf1 && n <= 1) {
    int best = -1;
    int32_t bv = 0;
    for (int s = 0; s < M; ++s) {
      const int32_t v = cap[s] > 0 ? npods[s] : kBigDom;
      if (s == 0 || v < bv) { bv = v; best = s; }
    }
    bool any = false;
    for (int s = 0; s < M; ++s) any = any || cap[s] > 0;
    for (int s = 0; s < M; ++s) fill[s] = (n >= 1 && any && s == best) ? 1 : 0;
    return;
  }
  int32_t tot = 0, hmax = INT_MIN;
  for (int s = 0; s < M; ++s) {
    tot = wrap_add(tot, cap[s]);
    hmax = max(hmax, cap[s] > 0 ? npods[s] + cap[s] : 0);
  }
  n = min(n, tot);
  int32_t lo = 0, hi = hmax + 1;
  for (int i = 0; hi - lo > 1 && i < iters; ++i) {
    const int32_t mid = (lo + hi) / 2;
    int32_t f = 0;
    for (int s = 0; s < M; ++s) f = wrap_add(f, clip(mid - npods[s], 0, cap[s]));
    if (f >= n)
      hi = mid;
    else
      lo = mid;
  }
  const int32_t level = hi;
  int32_t bsum = 0;
  for (int s = 0; s < M; ++s) bsum = wrap_add(bsum, clip(level - 1 - npods[s], 0, cap[s]));
  const int32_t deficit = wrap_sub(n, bsum);
  int32_t rank = 0;
  for (int s = 0; s < M; ++s) {
    const int32_t b = clip(level - 1 - npods[s], 0, cap[s]);
    const bool elig = (b < cap[s]) && (npods[s] <= level - 1);
    if (elig) ++rank;
    fill[s] = b + ((elig && rank <= deficit) ? 1 : 0);
  }
}

// ---- domain quota qd[NSLOT] (packing.py "domain quota qd") ----
// For a dynamic group over the node caps ``cap`` [N] and the per-claim
// per-domain capacity st.percap (0 on claims that are not live) of the
// live slots [0, ns). Needs m.D0 and m.fresh; ``wf1``: the quota
// water-fill is waterfill1 (B5).
// Call after a barrier; ends in one.
__device__ void domain_quota(const Dims& d, const In& in, const State& st, const Out& out,
                             const Smem& m, const Grp& g, const int32_t* cap, bool wf1,
                             int ns, Shared& sh) {
  const int tid = threadIdx.x, N = d.N, V1 = d.V1, JH = d.JH;
  const int NSLOT = V1 + 2;
  for (int v = tid; v < V1; v += kThreads) m.czcap[v] = 0;
  __syncthreads();
  for (int n = tid; n < N; n += kThreads) {
    const int sl = nd_slot(d, in, g, n);
    if (sl < V1) atomicAdd(&m.czcap[sl], cap[n]);
  }
  // AFFINITY bootstrap anchors: the first fitting node's domain, the
  // least-loaded eligible pinned claim's domain
  int32_t first_n = INT_MAX;
  unsigned long long claim_key = ~0ull;
  if (g.mode == kAffinity) {
    for (int n = tid; n < N; n += kThreads)
      if (cap[n] >= 1 && nd_slot(d, in, g, n) < V1) first_n = min(first_n, n);
    first_n = block_min(first_n, sh);
    const int32_t* pin_axis = g.dkey == 0 ? out.c_dzone : out.c_dct;
    for (int s = tid; s < ns; s += kThreads) {
      int32_t pmax = 0;
      for (int v = 0; v < V1; ++v) pmax = max(pmax, st.percap[static_cast<size_t>(s) * V1 + v]);
      int32_t ccap = min(pmax, g.hcap);
      ccap = min(ccap, h_allow(g, st.ch_cnt[s * JH + g.jhc]));
      if (pin_axis[s] >= 0 && ccap >= 1) {
        const unsigned long long k2 = load_key(st.c_npods[s], s);
        claim_key = k2 < claim_key ? k2 : claim_key;
      }
    }
    claim_key = block_min_u64(claim_key, sh);
  }
  __syncthreads();
  if (tid == 0) {
    const int gi = g.gi, mode = g.mode;
    const int32_t count = g.count;
    const int32_t skew = in.g_dskew[gi];
    const bool min0 = in.g_dmin0[gi];
    const uint8_t* reg = in.g_dreg + static_cast<size_t>(gi) * V1;
    const int32_t* drank = in.g_drank + static_cast<size_t>(gi) * V1;
    for (int sl = 0; sl < NSLOT; ++sl) m.qd[sl] = 0;
    for (int v = 0; v < V1; ++v)
      m.wcap[v] = min(wrap_add(m.czcap[v], bit(m.fresh, v) ? kBigDom : 0), kBigDom);  // realcap
    if (mode == kAffinity) {
      // all pods pin to ONE domain: a nonempty shared domain binds every
      // follower; else the bootstrap walks existing nodes, open claims,
      // then the lowest-rank fresh-feasible domain
      int d_follow = 0, d_fresh = 0;
      int32_t best_follow = 0, best_fresh = 0;
      bool follow = false, any_fresh = false;
      for (int v = 0; v < V1; ++v) {
        const bool nonempty = m.D0[v] > 0 && reg[v];
        const bool fresh = bit(m.fresh, v) && reg[v];
        const int32_t rf = nonempty ? drank[v] : kBigDom;
        const int32_t rr = fresh ? drank[v] : kBigDom;
        if (v == 0 || rf < best_follow) { best_follow = rf; d_follow = v; }
        if (v == 0 || rr < best_fresh) { best_fresh = rr; d_fresh = v; }
        follow = follow || nonempty;
        any_fresh = any_fresh || fresh;
      }
      const bool has_exist = first_n != INT_MAX;
      const bool has_claim = claim_key != ~0ull;
      int d_aff = d_fresh;
      if (follow) {
        d_aff = d_follow;
      } else if (has_exist) {
        const int32_t raw = g.dkey == 0 ? in.n_dzone[first_n] : in.n_dct[first_n];
        d_aff = min(max(raw, 0), V1 - 1);
      } else if (has_claim) {
        const int s = static_cast<int>(claim_key & 0xffffffffu);
        d_aff = min(max((g.dkey == 0 ? out.c_dzone : out.c_dct)[s], 0), V1 - 1);
      }
      if (follow || has_exist || has_claim || any_fresh) m.qd[d_aff] = count;
    } else if (mode == kSpread || mode >= kGateSpread) {
      // SPREAD: the level cap L* = maxSkew + min over registered domains
      // of (prior + capacity), 0 under minDomains; GATE: domains within
      // skew of the static min (gate-spread) or nonempty (gate-affinity)
      int32_t lim = kBigDom;
      for (int v = 0; v < V1; ++v) {
        if (mode == kSpread)
          lim = min(lim, reg[v] ? wrap_add(m.D0[v], m.wcap[v]) : kBigDom);
        else
          lim = min(lim, reg[v] ? m.D0[v] : kBigDom);
      }
      if (min0) lim = 0;
      const int32_t lstar = wrap_add(skew, lim);
      for (int v = 0; v < V1; ++v) {
        int32_t c;
        if (mode == kSpread) {
          c = min(reg[v] ? clip(wrap_sub(lstar, m.D0[v]), 0, m.wcap[v]) : 0, count);
        } else {
          const bool allowed = reg[v] && (mode == kGateAff ? m.D0[v] > 0
                                                            : wrap_sub(m.D0[v], lim) <= skew);
          c = allowed ? min(m.wcap[v], count) : 0;
        }
        m.wnp[v] = reg[v] ? m.D0[v] : kBigDom;
        m.wcap[v] = c;
      }
      waterfill_serial(m.wnp, m.wcap, count, d.wf_iters, m.qd, V1, wf1);
    }
  }
  __syncthreads();
}

// the domain-free quota: every pod in ANY. Ends in a barrier.
__device__ void any_quota(const Dims& d, const Smem& m, int32_t count) {
  for (int sl = threadIdx.x; sl < d.V1 + 2; sl += kThreads) m.qd[sl] = sl == d.V1 ? count : 0;
  __syncthreads();
}

// parity: phase existing-nodes
// ---- 1. existing nodes, fixed priority order ----
// Tier-1 fill of the node caps ``cap`` under per-domain budgets: within
// each slot the prefix scan keeps node priority order; unconstrained
// groups have every node in ANY and this is plain greedy_prefix_fill.
// Writes the group's exist_fills row, exist_used and the counted nhc
// column, and m.qrem. Returns the pods placed. Ends in a barrier.
// parity: tiebreak cumsum
__device__ int32_t tier1_fill(const Dims& d, const In& in, const State& st, const Out& out,
                              const Smem& m, const Grp& g, const int32_t* cap,
                              bool haff_exist_served, Shared& sh) {
  const int tid = threadIdx.x, N = d.N, R = d.R, JH = d.JH;
  int32_t placed_exist = 0;
  int32_t* fills = out.exist_fills + static_cast<size_t>(g.gi) * N;
  // a domain-free group has every node in ANY and quota nowhere else: the
  // other slots place nothing and keep nothing (any_quota)
  const int sl0 = g.dyn ? 0 : d.V1, sl1 = g.dyn ? d.V1 + 2 : d.V1 + 1;
  if (!g.dyn)
    for (int sl = tid; sl < d.V1 + 2; sl += kThreads)
      if (sl != d.V1) m.qrem[sl] = 0;
  for (int sl = sl0; sl < sl1; ++sl) {
    const int32_t budget = m.qd[sl];
    int32_t local = 0;
    if (budget > 0 && N) {
      int32_t carry = 0;
      for (int base = 0; base < N; base += kThreads) {
        const int n = base + tid;
        const bool in_slot = n < N && nd_slot(d, in, g, n) == sl;
        const int32_t x = in_slot ? cap[n] : 0;
        int32_t chunk;
        const int32_t incl = block_scan(x, sh, &chunk);
        if (in_slot) {
          const int32_t before = wrap_add(carry, wrap_sub(incl, x));
          const int32_t fill = clip(wrap_sub(budget, before), 0, x);
          fills[n] = fill;
          local = wrap_add(local, fill);
          if (fill != 0) {
            for (int r = 0; r < R; ++r)
              st.exist_used[static_cast<size_t>(n) * R + r] += static_cast<float>(fill) * m.req[r];
            if (g.counted) st.nhc[n * JH + g.jhc] = wrap_add(st.nhc[n * JH + g.jhc], fill);
          }
        }
        carry = wrap_add(carry, chunk);
      }
    } else {
      for (int n = tid; n < N; n += kThreads)
        if (nd_slot(d, in, g, n) == sl) fills[n] = 0;
    }
    const int32_t placed = budget > 0 && N ? block_sum(local, sh) : 0;
    placed_exist = wrap_add(placed_exist, placed);
    // a served existing-entity pin absorbs what fits; the remainder of a
    // hostname-affinity group errors, never spills to claims
    if (tid == 0) m.qrem[sl] = haff_exist_served ? 0 : wrap_sub(budget, placed);
  }
  __syncthreads();
  return placed_exist;
}

// parity: phase open-claims
// ---- 2. open claims, least-loaded first: a domain-free group ----
// Over st.claim_cap (already clamped) of the live slots [0, ns); hostname
// affinity restricts it to the least-loaded eligible claim. ``wf1``: the water-fill is waterfill1
// (B5). Writes st.claim_fill. Call after a barrier; ends in one.
__device__ void tier2_any(const Dims& d, const State& st, const Smem& m, const Grp& g, bool wf1,
                          int ns, Shared& sh) {
  const int tid = threadIdx.x, ANY = d.V1;
  bool haff_any_claim = false;
  if (g.haff) {
    // parity: tiebreak argmin
    unsigned long long key = ~0ull;
    for (int s = tid; s < ns; s += kThreads)
      if (st.claim_cap[s] >= 1) {
        const unsigned long long k2 = load_key(st.c_npods[s], s);
        key = k2 < key ? k2 : key;
      }
    key = block_min_u64(key, sh);
    haff_any_claim = key != ~0ull;
    const int tstar = static_cast<int>(key & 0xffffffffu);
    for (int s = tid; s < ns; s += kThreads)
      if (!(haff_any_claim && s == tstar)) st.claim_cap[s] = 0;
  }
  __syncthreads();
  if (wf1)
    waterfill1(st.c_npods, st.claim_cap, m.qrem[ANY], d.wf_iters, st.claim_fill, ns, sh);
  else
    waterfill(st.c_npods, st.claim_cap, m.qrem[ANY], d.wf_iters, st.claim_fill, ns, sh);
  int32_t local = 0;
  for (int s = tid; s < ns; s += kThreads) local = wrap_add(local, st.claim_fill[s]);
  const int32_t placed = block_sum(local, sh);
  if (tid == 0) {
    m.qrem[ANY] = wrap_sub(m.qrem[ANY], placed);
    // a served claim pin absorbs what fits; the remainder errors
    if (haff_any_claim)
      for (int sl = 0; sl < d.V1 + 2; ++sl) m.qrem[sl] = 0;
  }
  __syncthreads();
}

// ---- 2. open claims: a dynamic group ----
// Over the live slots [0, ns). One domain per claim (spread_domain_choice): admissible domains have
// capacity on the claim (st.percap, 0 on claims that are not live) and
// remaining quota; a claim's cap also takes its minValues cap st.mvcap; claims rank in slot order for the quota-proportional
// pick. Then one water-fill per domain slot with claims (a slot whose
// every cap is 0 hands out nothing); ``single`` (B5, count <= 1): at most
// one slot carries quota, so one least-loaded pick in the slot with the
// largest quota. Writes st.c_slot, st.claim_cap, st.claim_fill. Call
// after a barrier; ends in one.
__device__ void tier2_domains(const Dims& d, const State& st, const Smem& m, const Grp& g,
                              bool single, int ns, Shared& sh) {
  const int tid = threadIdx.x, V1 = d.V1, JH = d.JH;
  const int NSLOT = V1 + 2, DEAD = V1 + 1;
  int32_t carry = 0;
  for (int base = 0; base < ns; base += kThreads) {
    const int s = base + tid;
    bool adm = false;
    if (s < ns)
      for (int v = 0; v < V1 && !adm; ++v)
        adm = st.percap[static_cast<size_t>(s) * V1 + v] >= 1 && m.qrem[v] > 0;
    int32_t chunk;
    const int32_t incl = block_scan(adm ? 1 : 0, sh, &chunk);
    if (s < ns) st.c_slot[s] = adm ? wrap_sub(wrap_add(carry, incl), 1) : -1;  // rank
    carry = wrap_add(carry, chunk);
  }
  const int32_t n_adm = carry;
  if (tid == 0) {
    // cumulative quota shares, float32 as XLA computes them
    int32_t total = 0;
    for (int v = 0; v < V1; ++v) total = wrap_add(total, max(m.qrem[v], 0));
    int32_t acc = 0;
    const float denom = __int2float_rn(max(total, 1));
    for (int v = 0; v < V1; ++v) {
      acc = wrap_add(acc, max(m.qrem[v], 0));
      m.cumf[v] = __fdiv_rn(__int2float_rn(acc), denom);
    }
    for (int sl = 0; sl < NSLOT; ++sl) m.sflag[sl] = 0;
  }
  __syncthreads();
  const float n_f = __int2float_rn(max(n_adm, 1));
  for (int s = tid; s < ns; s += kThreads) {
    const int32_t rank = st.c_slot[s];
    int cs = DEAD;
    if (rank >= 0) {
      const int32_t* pc = st.percap + static_cast<size_t>(s) * V1;
      // greedy: the admissible domain with the largest remaining quota
      // parity: tiebreak argmax
      int d_greedy = 0;
      int32_t bq = 0;
      for (int v = 0; v < V1; ++v) {
        const int32_t q = (pc[v] >= 1 && m.qrem[v] > 0) ? m.qrem[v] : -1;
        if (v == 0 || q > bq) { bq = q; d_greedy = v; }
      }
      // proportional: the first cumulative share >= (rank + 0.5) / n
      // parity: const 0.5
      // parity: tiebreak searchsorted
      const float x = __fdiv_rn(__fadd_rn(__int2float_rn(rank), 0.5f), n_f);
      int d_prop = V1;
      for (int v = 0; v < V1; ++v)
        if (m.cumf[v] >= x) { d_prop = v; break; }
      d_prop = min(d_prop, V1 - 1);
      const bool prop_ok = pc[d_prop] >= 1 && m.qrem[d_prop] > 0;
      cs = (prop_ok && g.mode == kSpread) ? d_prop : d_greedy;
      int32_t c = min(pc[cs], g.hcap);
      c = min(c, g.count);
      if (d.MV) c = min(c, st.mvcap[s]);
      c = min(c, h_allow(g, st.ch_cnt[s * JH + g.jhc]));
      st.claim_cap[s] = c;
      if (c > 0) m.sflag[cs] = 1;
    } else {
      st.claim_cap[s] = min(min(min(0, g.hcap), g.count), h_allow(g, st.ch_cnt[s * JH + g.jhc]));
    }
    st.c_slot[s] = cs;
    st.claim_fill[s] = 0;
  }
  __syncthreads();
  if (single) {
    // the slot with the largest remaining quota, its least-loaded claim
    int s_star = 0;
    for (int sl = 1; sl < NSLOT; ++sl)
      if (m.qrem[sl] > m.qrem[s_star]) s_star = sl;
    unsigned long long key = ~0ull;
    for (int s = tid; s < ns; s += kThreads)
      if (st.c_slot[s] == s_star && st.claim_cap[s] >= 1) {
        const unsigned long long k2 = load_key(st.c_npods[s], s);
        key = k2 < key ? k2 : key;
      }
    key = block_min_u64(key, sh);
    const bool take = m.qrem[s_star] >= 1 && key != ~0ull;
    if (take)
      for (int s = tid; s < ns; s += kThreads)
        if (s == static_cast<int>(key & 0xffffffffu)) st.claim_fill[s] = 1;
    __syncthreads();
    if (tid == 0 && take) m.qrem[s_star] = wrap_sub(m.qrem[s_star], 1);
    __syncthreads();
    return;
  }
  for (int sl = 0; sl < V1; ++sl) {
    if (!m.sflag[sl]) continue;
    waterfill(st.c_npods, st.claim_cap, m.qrem[sl], d.wf_iters, st.claim_fill, ns, sh,
              st.c_slot, sl);
    int32_t local = 0;
    for (int s = tid; s < ns; s += kThreads)
      if (st.c_slot[s] == sl) local = wrap_add(local, st.claim_fill[s]);
    const int32_t placed = block_sum(local, sh);
    if (tid == 0) m.qrem[sl] = wrap_sub(m.qrem[sl], placed);
    __syncthreads();
  }
  __syncthreads();
}

// Commit of the claims in [lo, hi) that got pods: their requirement rows
// merge the group's, a dynamic group's claim is pinned to its domain (the
// constrained-axis mask row narrows to it), and load, pod count and the
// counted hostname column grow by the fill. With ``tmask`` (B4) the
// claim's type mask also drops the types that no longer survive: add_fit
// saw the pre-fill load, so "still fits" is add_fit >= fill, and a pinned
// claim's types need an offering there (B5 settles type masks once per
// class instead). The claims with a fill are gathered (m.list, a window
// of 1024 slots at a time) and committed kWarps at a time, warp j working
// out claim j's words and the block's threads sharing the chunk's
// (claim, type) and (claim, key, value) cells: a step that fills a few
// claims does not wait on one warp's walk over each claim's types. Each
// claim's updates are its own, so the gathering order does not matter.
// Call after a barrier; ends in one (a block barrier: a cluster's ranks
// meet at their own).
__device__ void commit_claims(const Dims& d, const In& in, const State& st, const Out& out,
                              const Smem& m, const Grp& g, bool tmask, int lo, int hi) {
  const int tid = threadIdx.x, wid = tid >> 5;
  const int T = d.T, R = d.R, K = d.K, V1 = d.V1, W = d.W, JH = d.JH, KV = K * V1;
  for (int base = lo; base < hi; base += kThreads) {
    if (tid == 0) m.nlist[0] = 0;
    __syncthreads();
    if (base + tid < hi && st.claim_fill[base + tid] != 0)
      m.list[atomicAdd(m.nlist, 1)] = base + tid;
    __syncthreads();
    const int n = m.nlist[0];
    for (int c0 = 0; c0 < n; c0 += kWarps) {
      const int nc = min(kWarps, n - c0);
      const int32_t* cl = m.list + c0;
      // a pinned claim narrows to its slot's domain (c_slot: tier 2's)
      auto pin = [&](int s) { return g.dyn && st.c_slot[s] < V1 ? st.c_slot[s] : -1; };
      if (tmask && wid < nc && st.claim_fill[cl[wid]] > 0) warp_claim_words(d, st, m, cl[wid]);
      __syncthreads();
      if (tmask)
        for (int i = tid; i < nc * T; i += kThreads) {
          const int j = i / T, t = i - j * T, s = cl[j];
          const int32_t fill = st.claim_fill[s];
          uint8_t* cell = out.c_tmask + static_cast<size_t>(s) * T + t;
          if (fill <= 0 || !*cell) continue;
          const uint32_t* wcz = m.cz + j * 2 * W;
          const uint32_t* wcc = wcz + W;
          const uint32_t* az = claim_atz(d, st, out, s);
          const int32_t af = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                        st.c_used + static_cast<size_t>(s) * R, m.req, R);
          bool keep = in.type_ok[trow(d, out.c_pool[s], g.ti) * T + t] &&
                      offer(m.off, az, t, V1, W, wcz, wcc) && af >= fill;
          const int cs = pin(s);
          if (keep && cs >= 0)
            keep = offer_in(m.off, az, claim_atc(d, st, out, s), g.dkey, t, cs, V1, W, wcz, wcc);
          if (!keep) *cell = 0;
        }
      // four values a thread, one 4-byte read and write (V1 % 4 == 0)
      const int KV4 = KV / 4;
      for (long long i = tid; i < static_cast<long long>(nc) * KV4; i += kThreads) {
        const int j = static_cast<int>(i / KV4), c = 4 * static_cast<int>(i % KV4), s = cl[j];
        if (st.claim_fill[s] <= 0) continue;
        const int cs = pin(s), key = c / V1, v = c % V1;
        uint32_t nib = (m.gw[key * W + (v >> 5)] >> (v & 31)) & 0xfu;
        if (cs >= 0 && key == g.kid_sel) nib &= (cs >= v && cs < v + 4) ? 1u << (cs - v) : 0u;
        uint32_t* cell = reinterpret_cast<uint32_t*>(st.c_mask + static_cast<size_t>(s) * KV + c);
        const uint32_t keep = (nib & 1u) | (nib & 2u) << 7 | (nib & 4u) << 14 | (nib & 8u) << 21;
        *cell = (__vcmpne4(*cell, 0u) & 0x01010101u) & keep;
      }
      for (int i = tid; i < nc * K; i += kThreads) {
        const int s = cl[i / K], k = i % K;
        if (st.claim_fill[s] <= 0) continue;
        st.c_def[s * K + k] = st.c_def[s * K + k] || m.gdef[k];
        st.c_neg[s * K + k] = st.c_neg[s * K + k] && m.gneg[k];
      }
      for (int j = tid; j < nc; j += kThreads) {
        const int s = cl[j];
        const int32_t fill = st.claim_fill[s];
        const int cs = fill > 0 ? pin(s) : -1;
        if (cs >= 0) (g.dkey == 0 ? out.c_dzone : out.c_dct)[s] = cs;
        st.c_npods[s] = wrap_add(st.c_npods[s], fill);
        if (g.counted) st.ch_cnt[s * JH + g.jhc] = wrap_add(st.ch_cnt[s * JH + g.jhc], fill);
      }
      __syncthreads();  // the type cells read the pre-fill load
      for (int i = tid; i < nc * R; i += kThreads) {
        const int s = cl[i / R], r = i % R;
        st.c_used[static_cast<size_t>(s) * R + r] +=
            static_cast<float>(st.claim_fill[s]) * m.req[r];
      }
      __syncthreads();
    }
  }
}

// What a fresh-claim bulk tells B5's maintained claim summaries; B4 keeps
// none. ``trip`` runs block-wide once the bulk's template is chosen,
// ``open`` for each slot opened (by the thread that opens it; with the
// bulk template's minValues cap), ``cell``
// for each (slot, type) of the opened claims.
struct NoBulkHook {
  __device__ void trip(const uint8_t*, const int32_t*, int, Shared&) const {}
  __device__ void open(int, int32_t, int32_t, int, int32_t) const {}
  __device__ void cell(int, int, int32_t, int32_t) const {}
};

// parity: phase fresh-claims
// ---- 3. new claims from the highest-weight feasible template ----
// Each trip serves the slot with the largest remaining quota and opens
// one BULK of k identical claims of one template against a frozen avail
// set; a no-progress trip retires the slot. With minValues floors a
// template whose available set misses them is infeasible and the
// per-claim fill is capped (m.mvp); with a reservation ledger the avail
// set is re-gated on what the current ledger offers, the bulk is bounded
// by the smallest compatible reservation, its claims hold reservations
// (c_resv) and debit each compatible one a slot, and a reservation that
// drains rebuilds the step words. Adds the takes to st.claim_fill. Needs
// m.pz / m.pc (template_words) when a ledger is on. Call after a barrier;
// ends in one. ``kMV``: the kernel's minValues path (MvPath).
// parity: tiebreak argmax
template <int kMV, class Hook>
__device__ void fresh_claims(const Dims& d, const In& in, const State& st, const Out& out,
                             const Smem& m, const Grp& g, int32_t& n_open, bool& overflow,
                             const Hook& hook, Shared& sh, float* s_debit) {
  const int tid = threadIdx.x, lane = tid & 31;
  const bool mv = kMV != kMvNone && d.MV;
  const int T = d.T, P = d.P, R = d.R, K = d.K, V1 = d.V1, W = d.W, NRES = d.NRES;
  const int NMAX = d.NMAX, JH = d.JH, NSLOT = V1 + 2, ANY = V1, DEAD = V1 + 1;
  for (int sl = tid; sl < NSLOT; sl += kThreads) m.ddead[sl] = sl == DEAD;
  // the templates compatible with the group: type_ok holds only where
  // compat_pg does (B1's and B3's tables and tile_rows fold it in), so the
  // avail cells of the others are false without a read of type_ok
  for (int p = tid; p < P; p += kThreads) m.pcompat[p] = in.compat_pg[trow(d, p, g.ti)];
  __syncthreads();
  while (!overflow) {
    // the slot with the largest remaining quota, the first of equals: the
    // least (inverted order-preserving quota, slot) key, every warp over
    // every slot (the same answer in each, no barrier)
    unsigned long long key = ~0ull;
    for (int sl = lane; sl < NSLOT; sl += 32) {
      const int32_t q = m.ddead[sl] ? -1 : m.qrem[sl];
      const uint32_t inv = ~(static_cast<uint32_t>(q) ^ 0x80000000u);
      const unsigned long long k2 =
          (static_cast<unsigned long long>(inv) << 32) | static_cast<uint32_t>(sl);
      key = k2 < key ? k2 : key;
    }
    for (int o = 16; o; o >>= 1) {
      const unsigned long long u = __shfl_xor_sync(kFull, key, o);
      key = u < key ? u : key;
    }
    const int d_sel = static_cast<int>(key & 0xffffffffu);
    const int32_t bq = static_cast<int32_t>(~static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
    if (bq <= 0) break;
    const int32_t rem_d = m.qrem[d_sel];
    const bool pinned = g.dyn && d_sel != ANY;  // a domain-pinned bulk
    int32_t p_min = P;
    for (int i = tid; i < P * T; i += kThreads) {
      const int p = i / T, t = i % T;
      bool ok = m.pcompat[p] && in.type_ok[trow(d, p, g.ti) * T + t];
      if (ok && in.p_has_limit[p])
        for (int r = 0; r < R && ok; ++r)
          ok = in.t_cap[static_cast<size_t>(t) * R + r] <= st.pool_rem[p * R + r];
      if (ok && pinned) ok = st.toff_pt[static_cast<size_t>(i) * V1 + d_sel];
      // the ledger re-gate: what the current ledger still offers, overall
      // or in the selected domain
      if (ok && NRES)
        ok = pinned ? offer_in(m.off, st.atz, st.atc, g.dkey, t, d_sel, V1, W, m.pz + p * W,
                               m.pc + p * W)
                    : offer(m.off, st.atz, t, V1, W, m.pz + p * W, m.pc + p * W);
      st.avail[i] = ok;
      if (ok && !mv) p_min = min(p_min, p);
    }
    if (mv) {
      // each template's minValues cap over its available types
      // (template_minvalues); a template below 1 opens nothing
      __syncthreads();
      if constexpr (kMV == kMvWarp) {
        for (int p = tid >> 5; p < P; p += kWarps) {  // a warp a template
          const uint8_t* avp = st.avail + static_cast<size_t>(p) * T;
          const int32_t* nfp = in.n_fit + trow(d, p, g.ti) * T;
          const int32_t c = warp_minvalues(d, st, m, in.p_mvmin + static_cast<size_t>(p) * d.MV,
                                           [&](int t, int32_t& fit) {
                                             fit = nfp[t];
                                             return avp[t] != 0;
                                           });
          if (lane == 0) m.mvp[p] = c;
        }
      } else if constexpr (kMV == kMvTeam) {
        template_minvalues(d, in, st, m, g.ti);
      }
      __syncthreads();
      for (int i = tid; i < P * T; i += kThreads)
        if (st.avail[i] && m.mvp[i / T] >= 1) p_min = min(p_min, i / T);
    }
    p_min = block_min(p_min, sh);  // first feasible template in weight order
    const bool any_feasible = p_min < P;
    const int p_star = any_feasible ? p_min : 0;
    const uint8_t* av = st.avail + static_cast<size_t>(p_star) * T;
    const int32_t* nf = in.n_fit + trow(d, p_star, g.ti) * T;
    int32_t best = INT_MIN;
    for (int t = tid; t < T; t += kThreads) best = max(best, av[t] ? nf[t] : 0);
    const int32_t n_fit_max = block_max(best, sh);
    int32_t n_per = min(n_fit_max, g.hcap);
    const int32_t mv_open = mv ? m.mvp[p_star] : kBigDom;
    n_per = min(n_per, mv_open);
    n_per = min(n_per, g.counted ? g.scap_h : kBigDom);
    // pessimistic limit debit: max capacity over the claim's options
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
      for (int t = tid; t < T; t += kThreads)
        mx = fmaxf(mx, av[t] ? in.t_cap[static_cast<size_t>(t) * R + r] : 0.0f);
      mx = block_max_f(mx, sh);
      if (tid == 0) s_debit[r] = mx;
    }
    __syncthreads();
    float k_limit = INFINITY;
    if (in.p_has_limit[p_star])
      for (int r = 0; r < R; ++r)
        if (s_debit[r] > 0.0f)
          k_limit = fminf(k_limit, floorf(__fdiv_rn(st.pool_rem[p_star * R + r],
                                                    fmaxf(s_debit[r], 1e-9f))));
    const int32_t k_need = __float2int_rz(ceilf(
        __fdiv_rn(static_cast<float>(rem_d), static_cast<float>(max(n_per, 1)))));
    const int32_t k_cap = isinf(k_limit) ? (1 << 30) : __float2int_rz(k_limit);
    int32_t k_want = min(k_need, k_cap);
    bool any_resv = false;
    if (NRES) {
      // every claim of the bulk holds one slot of each compatible
      // reservation (one with remaining capacity that offers a type of
      // the bulk's template, in the pinned domain for a pinned bulk): the
      // smallest remaining one bounds the bulk
      for (int w = tid; w < W; w += kThreads) {
        uint32_t z = m.pz[p_star * W + w], c = m.pc[p_star * W + w];
        if (pinned) {
          const uint32_t oh = (d_sel >> 5) == w ? 1u << (d_sel & 31) : 0u;
          if (g.dkey == 0) z &= oh; else c &= oh;
        }
        m.pze[w] = z;
        m.pce[w] = c;
      }
      for (int r = tid; r < NRES; r += kThreads) m.rflag[r] = 0;
      __syncthreads();
      const size_t rstride = static_cast<size_t>(T) * V1 * W;
      for (long long i = tid; i < static_cast<long long>(NRES) * T; i += kThreads) {
        const int r = static_cast<int>(i / T), t = static_cast<int>(i % T);
        if (av[t] && st.res_rem[r] > 0 &&
            offer(m.off, st.ares_z + r * rstride, t, V1, W, m.pze, m.pce))
          m.rflag[r] = 1;
      }
      __syncthreads();
      int32_t k_resv = 1 << 30;
      for (int r = 0; r < NRES; ++r)
        if (m.rflag[r]) {
          any_resv = true;
          k_resv = min(k_resv, st.res_rem[r]);
        }
      k_want = min(k_want, k_resv);
    }
    const int32_t slot = n_open;
    const int32_t k_slots = max(NMAX - slot, 0);
    if (g.haff) k_want = min(k_want, 1);
    int32_t k = min(k_want, k_slots);
    const bool ok = any_feasible && k > 0 && n_per > 0;
    if (!ok) k = 0;
    const int d_pin = pinned ? d_sel : -1;
    hook.trip(av, nf, d_pin, sh);
    // bulk_takes: domain-pinned bulks and every bulk of a domain batch
    // split rem_d evenly; ANY bulks of domain-free batches fill n_per per
    // claim, then the remainder
    const bool even = d.has_domains || d_sel != ANY;
    const int32_t served = min(rem_d, wrap_mul(k, n_per));
    const int32_t take_base = k > 0 ? floordiv(served, max(k, 1)) : 0;
    const int32_t take_extra = wrap_sub(served, wrap_mul(take_base, max(k, 1)));
    auto take_of = [&](int s) -> int32_t {
      if (even) return take_base + ((s - slot) < take_extra ? 1 : 0);
      return clip(wrap_sub(rem_d, wrap_mul(s - slot, n_per)), 0, n_per);
    };

    int32_t local = 0;
    for (int s = slot + tid; s < slot + k; s += kThreads) {
      const int32_t take = take_of(s);
      for (int r = 0; r < R; ++r)
        st.c_used[static_cast<size_t>(s) * R + r] =
            in.p_daemon[p_star * R + r] + static_cast<float>(take) * m.req[r];
      st.c_npods[s] = take;
      out.c_pool[s] = p_star;
      if (pinned) (g.dkey == 0 ? out.c_dzone : out.c_dct)[s] = d_sel;
      st.claim_fill[s] = wrap_add(st.claim_fill[s], take);
      out.c_resv[s] = any_resv;
      hook.open(s, take, n_fit_max, d_pin, mv_open);
      local = wrap_add(local, take);
    }
    // the new claims' requirement rows and hostname counts, cell by cell
    // over the block; claims opened for a dynamic group are domain-pinned
    // from birth
    const int KV = K * V1;
    // four values a thread, one 4-byte store (V1 % 4 == 0: a key's row
    // holds whole groups of four)
    uint32_t* cm = reinterpret_cast<uint32_t*>(st.c_mask + static_cast<size_t>(slot) * KV);
    for (long long i = tid; i < static_cast<long long>(k) * KV / 4; i += kThreads) {
      const int c = static_cast<int>((4 * i) % KV), key = c / V1, v = c % V1;
      uint32_t nib = (m.gw[key * W + (v >> 5)] >> (v & 31)) & 0xfu;
      if (pinned && key == g.kid_sel)
        nib &= (d_sel >= v && d_sel < v + 4) ? 1u << (d_sel - v) : 0u;
      cm[i] = (nib & 1u) | (nib & 2u) << 7 | (nib & 4u) << 14 | (nib & 8u) << 21;
    }
    for (int i = tid; i < k * K; i += kThreads) {
      st.c_def[slot * K + i] = m.gdef[i % K];
      st.c_neg[slot * K + i] = m.gneg[i % K];
    }
    for (int i = tid; i < k * JH; i += kThreads)
      st.ch_cnt[slot * JH + i] = (g.counted && i % JH == g.jhc) ? take_of(slot + i / JH) : 0;
    for (long long i = tid; i < static_cast<long long>(k) * T; i += kThreads) {
      const int s = slot + static_cast<int>(i / T), t = static_cast<int>(i % T);
      const int32_t take = take_of(s);
      out.c_tmask[static_cast<size_t>(s) * T + t] = av[t] && nf[t] >= take;
      hook.cell(s, t, take, nf[t]);
    }
    const int32_t placed = block_sum(local, sh);
    if (ok && in.p_has_limit[p_star])
      for (int r = tid; r < R; r += kThreads)
        st.pool_rem[p_star * R + r] += (-s_debit[r]) * static_cast<float>(k);
    n_open = slot + k;
    if (any_feasible && n_per > 0 && k_want > k_slots) overflow = true;
    __syncthreads();
    if (tid == 0) {
      m.qrem[d_sel] = wrap_sub(m.qrem[d_sel], placed);
      // haff groups retire after ONE trip (a second opens a second entity)
      if (placed == 0 || g.haff) m.ddead[d_sel] = 1;
      // the ledger debit: a slot of each compatible reservation per claim
      int32_t drained = 0;
      if (k > 0)
        for (int r = 0; r < NRES; ++r)
          if (m.rflag[r]) {
            st.res_rem[r] = wrap_sub(st.res_rem[r], k);
            drained |= st.res_rem[r] <= 0;
          }
      m.flags[0] = drained;
    }
    __syncthreads();
    // a reservation ran out: its offerings leave the step's availability
    if (NRES && m.flags[0]) step_words(d, in, st);
  }
}

// parity: phase spread-counters
// shared domain carry: a SELF owner's per-domain placements feed the next
// sharing group's counts (gate modes never count themselves). No barrier.
__device__ void spread_carry(const Dims& d, const State& st, const Smem& m, const Grp& g) {
  if (g.has_d && g.mode < kGateSpread)
    for (int v = threadIdx.x; v < d.V1; v += kThreads) {
      int32_t* c = st.ddc + static_cast<size_t>(min(g.jd, d.JD - 1)) * d.V1 + v;
      *c = wrap_add(*c, wrap_sub(m.qd[v], m.qrem[v]));
    }
}

// Contributor counting (packing.py:1153, the oracle's record() rule): the
// group counts toward the shared hostname slots of its g_hcontrib row on
// every node and claim it filled, and toward the shared domain slots of
// its g_dcontrib row by domain: existing-node fills by the node's zone /
// capacity type, claim fills only where the claim's zone (capacity-type)
// mask row is single-valued, dtg_key choosing each slot's axis; claims
// over the live slots [0, ns), the bulks' included. Integer adds, exact in
// any order. Call after a barrier; ends in one.
__device__ void contrib_counts(const Dims& d, const In& in, const State& st, const Out& out,
                               const Smem& m, const Grp& g, int ns) {
  const int tid = threadIdx.x, N = d.N, V1 = d.V1, JH = d.JH, JD = d.JD, K = d.K;
  const uint8_t* hrow = in.g_hcontrib + static_cast<size_t>(g.gi) * JH;
  const uint8_t* drow = in.g_dcontrib + static_cast<size_t>(g.gi) * JD;
  int32_t* ze = m.dsum;
  int32_t* ce = ze + V1;
  int32_t* zc = ce + V1;
  int32_t* cc = zc + V1;
  for (int i = tid; i < 4 * V1; i += kThreads) m.dsum[i] = 0;
  __syncthreads();
  const int32_t* efill = out.exist_fills + static_cast<size_t>(g.gi) * N;
  for (int n = tid; n < N; n += kThreads) {
    const int32_t f = efill[n];
    if (f == 0) continue;
    const int32_t z = in.n_dzone[n], c = in.n_dct[n];
    if (z >= 0 && z < V1) atomicAdd(&ze[z], f);
    if (c >= 0 && c < V1) atomicAdd(&ce[c], f);
    for (int j = 0; j < JH; ++j)
      if (hrow[j]) st.nhc[n * JH + j] = wrap_add(st.nhc[n * JH + j], f);
  }
  for (int s = tid; s < ns; s += kThreads) {
    const int32_t f = st.claim_fill[s];
    if (f == 0) continue;
    const uint8_t* row = st.c_mask + static_cast<size_t>(s) * K * V1;
    int nz = 0, nc = 0, vz = 0, vc = 0;
    for (int v = 0; v < V1; ++v) {
      if (row[d.zone_kid * V1 + v]) { ++nz; vz = v; }
      if (row[d.ct_kid * V1 + v]) { ++nc; vc = v; }
    }
    if (nz == 1) atomicAdd(&zc[vz], f);
    if (nc == 1) atomicAdd(&cc[vc], f);
    for (int j = 0; j < JH; ++j)
      if (hrow[j]) st.ch_cnt[s * JH + j] = wrap_add(st.ch_cnt[s * JH + j], f);
  }
  __syncthreads();
  for (int i = tid; i < JD * V1; i += kThreads) {
    const int j = i / V1, v = i % V1;
    if (drow[j])
      st.ddc[i] = wrap_add(st.ddc[i], in.dtg_key[j] == 0 ? wrap_add(ze[v], zc[v])
                                                          : wrap_add(ce[v], cc[v]));
  }
  __syncthreads();
}

// The group's claim_fills row over the live slots [0, ns), the bulks'
// included (from st.claim_fill; the wrapper zeroes the rest once), and its
// unplaced count. Call after a barrier; ends in one.
__device__ void group_outputs(const Dims& d, const State& st, const Out& out, const Grp& g,
                              int32_t placed_exist, int ns, Shared& sh) {
  int32_t local = 0;
  for (int s = threadIdx.x; s < ns; s += kThreads) {
    const int32_t f = st.claim_fill[s];
    out.claim_fills[static_cast<size_t>(g.gi) * d.NMAX + s] = f;
    local = wrap_add(local, f);
  }
  const int32_t placed_claims = block_sum(local, sh);
  if (threadIdx.x == 0)
    out.unplaced[g.gi] = wrap_sub(wrap_sub(g.count, placed_exist), placed_claims);
  __syncthreads();
}

}  // namespace
