// Kernel B4: the grouped first-fit-decreasing packing scan.
//
// Replaces karpenter_tpu/ops/packing.py:pack (a lax.scan over groups on
// the TPU, step body packing.py:425) in the scope the PyTorch port
// covers: has_contrib=False, untiled tables, no reservations, no
// minValues, with or without the domain machinery (has_domains). Its
// sequential twin is karpenter_tpu/native/solve_core.cc:kt_solve; the
// phases below carry the same names.
//
// Bound on the H100: latency, not bytes or operations. The scan is
// sequential over groups; each step is a chain of dependent block-wide
// reductions (claim caps, a prefix scan over existing nodes, up to
// wf_iters bisection trips per water-fill, bulk openings), each a few
// microseconds of barrier latency over at most NMAX x T cells.
//
// Design: ONE persistent thread block of 1024 threads walks every group in
// FFD order — no launch per scan step, which would cost more than the
// step. The carried state (PackState) lives in device memory the wrapper
// allocates (c_tmask alone is 400 KB at the 50k x 400 cell, beyond the
// 227 KB of shared memory; the 50 MB L2 holds all of it); per-step group
// rows live in shared memory. Per-claim work (compatibility, per-type fit,
// survival) runs one warp per claim with lanes over types, so it needs no
// block barrier. Reductions and scans are integer (exact in any order);
// argmin/argmax break ties at the lowest index; float32 ledgers use two
// IEEE roundings per a*b+c (built with -fmad=false), as XLA computes them.
//
// Domains (has_domains; packing.py:496-1152): a dynamic group (g_dmode >
// 0) gets a quota qd over its V1 domain slots plus ANY and DEAD. Per step
// the kernel computes the templates' per-domain offering table toff_pt
// [P, T, V1] into device scratch; the claims' table toff_nt [NMAX, T, V1]
// is never stored (megabytes per step at NMAX ~ 1k, T = 800): each use
// re-derives its cell from the claim's zone/capacity-type words and the
// offering bit table, inside the per-claim max (percap [NMAX, V1], kept
// with shared-memory atomicMax per warp) and inside the survival check.
// The quota itself (the spread level cap, the gate caps, the affinity
// bootstrap, one water-fill over at most V1 domains) is a handful of V1
// values: thread 0 computes it serially. Tier 1 runs one prefix scan per
// domain slot with quota; tier 2 picks one domain per claim
// (spread_domain_choice: float32 with __int2float_rn / __fadd_rn /
// __fdiv_rn, searchsorted left) and runs one water-fill per slot; tier 3
// opens domain-pinned bulks split evenly. Per-claim domain state (c_slot,
// percap) and the shared-domain carry ddc live in device scratch.
//
// Scenario grid (kernel B7, karpenter_tpu/ops/solve.py:357
// solve_scenarios_core_packed, which vmaps this scan over consolidation
// scenarios): block s of a <<<S, 1024>>> launch walks scenario s. The
// batched inputs (g_count, cap_ng, and n_hcnt / nh_cnt0 / g_dprior / dd0
// when the topology priors are per scenario) carry a scenario stride, 0
// when shared; every State and Out buffer holds S slices and each block
// offsets into its own. The scan body is the same for every S, so
// scenarios walk the same groups in the same order with the same ties and
// bisection; S = 1 is the plain solve. Scenarios are independent, so
// blocks never synchronise with each other; a batch wider than the 132
// SMs queues.
#include "common.cuh"

namespace {

using kt::clip;
using kt::fits_count;
using kt::kBigDom;
using kt::kFull;
using kt::wrap_add;
using kt::wrap_mul;
using kt::wrap_sub;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// domain-constraint modes (solver/encode.py:DMODE_*)
constexpr int kSpread = 1, kAffinity = 2, kGateSpread = 3, kGateAff = 4;

struct Shared {
  int32_t i32[kWarps];
  unsigned long long u64[kWarps];
  float f32[kWarps];
};

__device__ int32_t block_sum(int32_t v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = wrap_add(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.i32[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t s = 0;
  for (int w = 0; w < kWarps; ++w) s = wrap_add(s, sh.i32[w]);
  return s;
}

__device__ int32_t block_max(int32_t v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.i32[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t s = sh.i32[0];
  for (int w = 1; w < kWarps; ++w) s = max(s, sh.i32[w]);
  return s;
}

__device__ int32_t block_min(int32_t v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.i32[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t s = sh.i32[0];
  for (int w = 1; w < kWarps; ++w) s = min(s, sh.i32[w]);
  return s;
}

__device__ unsigned long long block_min_u64(unsigned long long v, Shared& sh) {
  for (int o = 16; o; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(kFull, v, o);
    v = u < v ? u : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.u64[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long s = sh.u64[0];
  for (int w = 1; w < kWarps; ++w) s = sh.u64[w] < s ? sh.u64[w] : s;
  return s;
}

__device__ float block_max_f(float v, Shared& sh) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh.f32[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sh.f32[0];
  for (int w = 1; w < kWarps; ++w) s = fmaxf(s, sh.f32[w]);
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
  __syncthreads();
  if (lane == 31) sh.i32[wid] = x;
  __syncthreads();
  int32_t pre = 0, tot = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < wid) pre = wrap_add(pre, sh.i32[w]);
    tot = wrap_add(tot, sh.i32[w]);
  }
  *total = tot;
  return wrap_add(pre, x);
}

// the (npods, cap) key of the least-loaded slot, ties to the lowest index
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

// `other`'s bit c of word w: the claim/template value-slot mask row
__device__ __forceinline__ uint32_t mask_word(const uint8_t* row, int V1, int w) {
  uint32_t bits = 0;
  for (int c = 0; c < 32 && w * 32 + c < V1; ++c)
    bits |= static_cast<uint32_t>(row[w * 32 + c] != 0) << c;
  return bits;
}

__device__ __forceinline__ bool bit(const uint32_t* words, int v) {
  return (words[v >> 5] >> (v & 31)) & 1u;
}

// any (z, c) with zone bit z, capacity-type bit c and a_tzc[t, z, c]
__device__ __forceinline__ bool offer(const uint32_t* atz, int t, int V1, int W,
                                      const uint32_t* cz, const uint32_t* cc) {
  for (int z = 0; z < V1; ++z) {
    if (!bit(cz, z)) continue;
    const uint32_t* row = atz + (static_cast<size_t>(t) * V1 + z) * W;
    for (int w = 0; w < W; ++w)
      if (row[w] & cc[w]) return true;
  }
  return false;
}

// an offering of type t in domain v of the constrained axis (dkey 0: zone,
// 1: capacity type) under the entity's words on both axes — one cell of
// packing.py's toff_nt / toff_pt. atz[t, z] holds capacity-type bits,
// atc[t, c] zone bits.
__device__ __forceinline__ bool offer_in(const uint32_t* atz, const uint32_t* atc,
                                         int dkey, int t, int v, int V1, int W,
                                         const uint32_t* cz, const uint32_t* cc) {
  const uint32_t* con = dkey == 0 ? cz : cc;
  const uint32_t* oth = dkey == 0 ? cc : cz;
  if (!bit(con, v)) return false;
  const uint32_t* row = (dkey == 0 ? atz : atc) + (static_cast<size_t>(t) * V1 + v) * W;
  for (int w = 0; w < W; ++w)
    if (row[w] & oth[w]) return true;
  return false;
}

struct Dims {
  int G, T, P, N, R, K, V1, NMAX, JH, JD, zone_kid, ct_kid, wf_iters, W;
  bool has_domains;
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
};

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
};

struct Out {
  int32_t* c_pool; uint8_t* c_tmask; int32_t* n_open; uint8_t* overflow;
  int32_t* exist_fills; int32_t* claim_fills; int32_t* unplaced;
  int32_t* c_dzone; int32_t* c_dct; uint8_t* c_resv;
};

// elements between consecutive scenarios' slices of the batched inputs
// (0: shared by every scenario)
struct Strides {
  long long g_count, cap_ng, n_hcnt, nh_cnt0, g_dprior, dd0;
};

// point every batched input, State and Out buffer at scenario s's slice
__device__ void own_slice(const Dims& d, const Strides& sc, long long s,
                          In& in, State& st, Out& out) {
  const long long N = d.N, NMAX = d.NMAX, R = d.R, K = d.K, V1 = d.V1;
  const long long JH = d.JH, JD = d.JD, P = d.P, T = d.T, G = d.G, W = d.W;
  const long long dom = d.has_domains ? 1 : 0;
  in.g_count += s * sc.g_count;
  in.cap_ng += s * sc.cap_ng;
  in.n_hcnt += s * sc.n_hcnt;
  in.nh_cnt0 += s * sc.nh_cnt0;
  in.g_dprior += s * sc.g_dprior;
  in.dd0 += s * sc.dd0;
  st.exist_used += s * N * R;
  st.c_used += s * NMAX * R;
  st.c_npods += s * NMAX;
  st.c_def += s * NMAX * K;
  st.c_neg += s * NMAX * K;
  st.c_mask += s * NMAX * K * V1;
  st.ch_cnt += s * NMAX * JH;
  st.nhc += s * N * JH;
  st.pool_rem += s * P * R;
  st.exist_cap += s * N;
  st.claim_cap += s * NMAX;
  st.claim_fill += s * NMAX;
  st.avail += s * P * T;
  st.atz += s * T * V1 * W;
  st.atc += s * dom * T * V1 * W;
  st.toff_pt += s * dom * P * T * V1;
  st.percap += s * dom * NMAX * V1;
  st.c_slot += s * dom * NMAX;
  st.ddc += s * JD * V1;
  out.c_pool += s * NMAX;
  out.c_tmask += s * NMAX * T;
  out.n_open += s;
  out.overflow += s;
  out.exist_fills += s * G * N;
  out.claim_fills += s * G * NMAX;
  out.unplaced += s * G;
  out.c_dzone += s * NMAX;
  out.c_dct += s * NMAX;
  out.c_resv += s * NMAX;
}

// waterfill (packing.py:105): smallest level L with
// sum(clip(L - npods, 0, cap)) >= n by bisection ((lo + hi) // 2, at most
// `iters` trips), then the deficit layer handed out by slot index. With
// `slot_of`, only slots s with slot_of[s] == sl take part: the others act
// as (npods _BIGI, cap 0), which contribute nothing and are never filled,
// and their `fill` entries are left untouched.
__device__ void waterfill(const int32_t* npods, const int32_t* cap, int32_t n,
                          int iters, int32_t* fill, int NMAX, Shared& sh,
                          const int32_t* slot_of = nullptr, int sl = 0) {
  const int tid = threadIdx.x;
  auto member = [&](int s) { return slot_of == nullptr || slot_of[s] == sl; };
  int32_t tot = 0, hmax = INT_MIN;
  for (int s = tid; s < NMAX; s += kThreads) {
    const int32_t c = member(s) ? cap[s] : 0;
    tot = wrap_add(tot, c);
    hmax = max(hmax, c > 0 ? npods[s] + c : 0);
  }
  n = min(n, block_sum(tot, sh));
  int32_t lo = 0, hi = block_max(hmax, sh) + 1;
  for (int i = 0; hi - lo > 1 && i < iters; ++i) {
    const int32_t mid = (lo + hi) / 2;
    int32_t f = 0;
    for (int s = tid; s < NMAX; s += kThreads)
      if (member(s)) f = wrap_add(f, clip(mid - npods[s], 0, cap[s]));
    if (block_sum(f, sh) >= n)
      hi = mid;
    else
      lo = mid;
  }
  const int32_t level = hi;
  int32_t bsum = 0;
  for (int s = tid; s < NMAX; s += kThreads)
    if (member(s)) bsum = wrap_add(bsum, clip(level - 1 - npods[s], 0, cap[s]));
  const int32_t deficit = wrap_sub(n, block_sum(bsum, sh));
  int32_t carry = 0;
  for (int base = 0; base < NMAX; base += kThreads) {
    const int s = base + tid;
    int32_t b = 0;
    bool elig = false;
    const bool m = s < NMAX && member(s);
    if (m) {
      b = clip(level - 1 - npods[s], 0, cap[s]);
      elig = (b < cap[s]) && (npods[s] <= level - 1);
    }
    int32_t chunk;
    const int32_t rank = wrap_add(carry, block_scan(elig ? 1 : 0, sh, &chunk));
    if (m) fill[s] = b + ((elig && rank <= deficit) ? 1 : 0);
    carry = wrap_add(carry, chunk);
  }
  __syncthreads();
}

// the same water-fill by one thread over a few slots (the domain quota)
__device__ void waterfill_serial(const int32_t* npods, const int32_t* cap, int32_t n,
                                 int iters, int32_t* fill, int M) {
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

__global__ void __launch_bounds__(kThreads, 1)
pack_scan(Dims d, In in0, State st0, Out out0, Strides sc) {
  // this block's scenario slices, kept in shared memory rather than in
  // registers, which the 1024-thread launch bound already holds to 64
  __shared__ In in;
  __shared__ State st;
  __shared__ Out out;
  if (threadIdx.x == 0) {
    in = in0;
    st = st0;
    out = out0;
    own_slice(d, sc, blockIdx.x, in, st, out);
  }
  __syncthreads();
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  __shared__ float s_debit[32];
  const int G = d.G, T = d.T, P = d.P, N = d.N, R = d.R, K = d.K, V1 = d.V1;
  const int NMAX = d.NMAX, JH = d.JH, JD = d.JD, W = d.W;
  const int NSLOT = V1 + 2, ANY = V1, DEAD = V1 + 1;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  // per-step group rows, per-warp claim zone/ct words, domain slots
  uint32_t* s_cz = reinterpret_cast<uint32_t*>(dyn);  // [kWarps][2][W]
  uint32_t* s_gz = s_cz + kWarps * 2 * W;              // [W]
  uint32_t* s_gc = s_gz + W;                           // [W]
  uint32_t* s_pz = s_gc + W;                           // [P][W] template ∧ group
  uint32_t* s_pc = s_pz + P * W;                       // [P][W]
  uint32_t* s_fresh = s_pc + P * W;                    // [W] fresh_ok_d bits
  int32_t* s_qd = reinterpret_cast<int32_t*>(s_fresh + W);  // [NSLOT]
  int32_t* s_qrem = s_qd + NSLOT;                           // [NSLOT]
  int32_t* s_ddead = s_qrem + NSLOT;                        // [NSLOT]
  int32_t* s_sflag = s_ddead + NSLOT;                       // [NSLOT]
  int32_t* s_D0 = s_sflag + NSLOT;                          // [V1]
  int32_t* s_czcap = s_D0 + V1;                             // [V1]
  int32_t* s_wcap = s_czcap + V1;                           // [V1]
  int32_t* s_wnp = s_wcap + V1;                             // [V1]
  float* s_cumf = reinterpret_cast<float*>(s_wnp + V1);     // [V1]
  int32_t* s_pcap = reinterpret_cast<int32_t*>(s_cumf + V1);  // [kWarps][V1]
  float* s_req = reinterpret_cast<float*>(s_pcap + kWarps * V1);  // [R]
  uint8_t* s_gdef = reinterpret_cast<uint8_t*>(s_req + R);  // [K]
  uint8_t* s_gneg = s_gdef + K;                              // [K]
  uint8_t* s_gmask = s_gneg + K;                             // [K * V1]

  // ---- pack state init (PackState, packing.py:357) ----
  // parity: state exist_used, c_used, c_npods, c_active, c_pool, c_tmask
  // parity: state c_def, c_neg, c_mask, c_dzone, c_dct, ch_cnt, nhc
  // parity: state ddc, c_resv, pool_rem, n_open, overflow
  for (int i = tid; i < N * R; i += kThreads) st.exist_used[i] = in.n_base[i];
  for (int i = tid; i < NMAX * R; i += kThreads) st.c_used[i] = 0.0f;
  for (int i = tid; i < NMAX; i += kThreads) {
    st.c_npods[i] = 0;
    out.c_pool[i] = 0;
    out.c_dzone[i] = -1;
    out.c_dct[i] = -1;
    out.c_resv[i] = 0;
  }
  for (long long i = tid; i < static_cast<long long>(NMAX) * T; i += kThreads)
    out.c_tmask[i] = 0;
  for (int i = tid; i < NMAX * K; i += kThreads) {
    st.c_def[i] = 0;
    st.c_neg[i] = 0;
  }
  for (long long i = tid; i < static_cast<long long>(NMAX) * K * V1; i += kThreads)
    st.c_mask[i] = 1;
  for (int i = tid; i < NMAX * JH; i += kThreads) st.ch_cnt[i] = 0;
  for (int i = tid; i < N * JH; i += kThreads) st.nhc[i] = in.nh_cnt0[i];
  for (int i = tid; i < JD * V1; i += kThreads) st.ddc[i] = in.dd0[i];
  for (int i = tid; i < P * R; i += kThreads) st.pool_rem[i] = in.p_limit[i];
  // a_tzc[t, z, :] as bit words over the capacity-type axis
  for (int i = tid; i < T * V1 * W; i += kThreads)
    st.atz[i] = mask_word(in.a_tzc + static_cast<size_t>(i / W) * V1, V1, i % W);
  if (d.has_domains) {
    // ... and a_tzc[t, :, c] as bit words over the zone axis
    for (int i = tid; i < T * V1 * W; i += kThreads) {
      const int t = i / (V1 * W), c = (i / W) % V1, w = i % W;
      uint32_t bits = 0;
      for (int z = w * 32; z < V1 && z < w * 32 + 32; ++z)
        bits |= static_cast<uint32_t>(in.a_tzc[(static_cast<size_t>(t) * V1 + z) * V1 + c] != 0)
                << (z - w * 32);
      st.atc[i] = bits;
    }
  }
  int32_t n_open = 0;
  bool overflow = false;
  __syncthreads();

  for (int gi = 0; gi < G; ++gi) {
    const int32_t count = in.g_count[gi];
    if (count <= 0) {
      // padded / empty groups place nothing and mutate nothing
      for (int n = tid; n < N; n += kThreads) out.exist_fills[gi * N + n] = 0;
      for (int s = tid; s < NMAX; s += kThreads)
        out.claim_fills[static_cast<size_t>(gi) * NMAX + s] = 0;
      if (tid == 0) out.unplaced[gi] = 0;
      continue;
    }
    const float* req_g = in.g_req + static_cast<size_t>(gi) * R;
    for (int i = tid; i < R; i += kThreads) s_req[i] = req_g[i];
    for (int i = tid; i < K; i += kThreads) {
      s_gdef[i] = in.g_def[gi * K + i];
      s_gneg[i] = in.g_neg[gi * K + i];
    }
    for (int i = tid; i < K * V1; i += kThreads)
      s_gmask[i] = in.g_mask[static_cast<size_t>(gi) * K * V1 + i];
    for (int i = tid; i < W; i += kThreads) {
      s_gz[i] = mask_word(in.g_mask + (static_cast<size_t>(gi) * K + d.zone_kid) * V1, V1, i);
      s_gc[i] = mask_word(in.g_mask + (static_cast<size_t>(gi) * K + d.ct_kid) * V1, V1, i);
    }
    const int32_t hcap = in.g_hcap[gi];
    const bool haff = in.g_haff[gi];
    // shared hostname constraint: self owners capped at scap_h - count and
    // counted; gate owners blocked above the threshold, never counted
    const int32_t jh = in.g_hstg[gi];
    const bool has_h = jh >= 0;
    const bool hself = in.g_hself[gi];
    const int jhc = min(max(jh, 0), JH - 1);
    const bool counted = has_h && hself;
    const int32_t scap_h = in.g_hscap[gi];
    auto h_allow = [&](int32_t cnt) -> int32_t {
      if (!has_h) return kBigDom;
      if (hself) return max(wrap_sub(scap_h, cnt), 0);
      return cnt > scap_h ? 0 : kBigDom;
    };
    // domain-constraint descriptors: the machinery runs for the dynamic
    // groups of a has_domains batch only (packing.py's lax.cond(dyn, ...))
    const int mode = d.has_domains ? in.g_dmode[gi] : 0;
    const bool dyn = mode > 0;
    const int dkey = in.g_dkey[gi];
    const int kid_sel = dkey == 0 ? d.zone_kid : d.ct_kid;
    const int32_t jd = in.g_dtg[gi];
    const bool has_d = dyn && jd >= 0;
    const uint8_t* reg = in.g_dreg + static_cast<size_t>(gi) * V1;
    // node domain slot on the constrained axis
    auto nd_slot = [&](int n) -> int {
      if (!dyn) return ANY;
      const int32_t raw = dkey == 0 ? in.n_dzone[n] : in.n_dct[n];
      // a value id at or past V1 lands in no domain, like DEAD
      return (raw >= 0 && raw < V1 && reg[raw]) ? raw : DEAD;
    };
    if (dyn) {
      for (int v = tid; v < V1; v += kThreads) {
        s_D0[v] = wrap_add(in.g_dprior[static_cast<size_t>(gi) * V1 + v],
                           has_d ? st.ddc[static_cast<size_t>(min(jd, JD - 1)) * V1 + v] : 0);
        s_czcap[v] = 0;
      }
      for (int i = tid; i < W; i += kThreads) s_fresh[i] = 0;
      const uint8_t* gm = in.g_mask + static_cast<size_t>(gi) * K * V1;
      for (int i = tid; i < P * W; i += kThreads) {
        const uint8_t* pm = in.p_mask + static_cast<size_t>(i / W) * K * V1;
        s_pz[i] = mask_word(pm + d.zone_kid * V1, V1, i % W) &
                  mask_word(gm + d.zone_kid * V1, V1, i % W);
        s_pc[i] = mask_word(pm + d.ct_kid * V1, V1, i % W) &
                  mask_word(gm + d.ct_kid * V1, V1, i % W);
      }
    }
    const uint8_t* type_ok_row = in.type_ok;  // [P, G, T] at (p, gi, t)
    __syncthreads();

    if (dyn) {
      // per-domain offering availability of each template (toff_pt), and
      // fresh_ok_d: some (template, type) the group may open has an
      // offering in the domain
      for (long long i = tid; i < static_cast<long long>(P) * T * V1; i += kThreads) {
        const int p = static_cast<int>(i / (static_cast<long long>(T) * V1));
        const int t = static_cast<int>((i / V1) % T), v = static_cast<int>(i % V1);
        const bool ok = offer_in(st.atz, st.atc, dkey, t, v, V1, W, s_pz + p * W, s_pc + p * W);
        st.toff_pt[i] = ok;
        if (ok && type_ok_row[(static_cast<size_t>(p) * G + gi) * T + t])
          atomicOr(&s_fresh[v >> 5], 1u << (v & 31));
      }
    }

    // ---- claim-side feasibility: cap_any, clamped to claim_cap; per
    // domain percap for dynamic groups (0 on claims that are not live) ----
    for (int s = wid; s < NMAX; s += kWarps) {
      int32_t cap_any = 0;
      bool live = false;
      int32_t* wpc = s_pcap + wid * V1;
      if (s < n_open) {  // c_active
        bool ok = true;
        for (int k = lane; k < K; k += 32) {
          const uint8_t* sm = st.c_mask + (static_cast<size_t>(s) * K + k) * V1;
          bool ov = false;
          for (int v = 0; v < V1 && !ov; ++v) ov = sm[v] && s_gmask[k * V1 + v];
          const bool sd = st.c_def[s * K + k], sn = st.c_neg[s * K + k];
          const bool key_ok = ov || (sn && s_gneg[k]) || !(sd && s_gdef[k]);
          const bool custom = !s_gdef[k] || in.well_known[k] || sd || s_gneg[k];
          ok = ok && key_ok && custom;
        }
        ok = __all_sync(kFull, ok);
        const int pp = out.c_pool[s];
        ok = ok && in.p_tol[pp * G + gi] && in.compat_pg[pp * G + gi];
        if (ok) {
          live = true;
          uint32_t* wcz = s_cz + wid * 2 * W;
          uint32_t* wcc = wcz + W;
          if (lane < W) {
            const uint8_t* row = st.c_mask + static_cast<size_t>(s) * K * V1;
            wcz[lane] = mask_word(row + d.zone_kid * V1, V1, lane) & s_gz[lane];
            wcc[lane] = mask_word(row + d.ct_kid * V1, V1, lane) & s_gc[lane];
          }
          if (dyn)
            for (int v = lane; v < V1; v += 32) wpc[v] = 0;
          __syncwarp();
          const uint8_t* tok = type_ok_row + (static_cast<size_t>(pp) * G + gi) * T;
          int32_t best = 0;
          for (int t = lane; t < T; t += 32) {
            if (!out.c_tmask[static_cast<size_t>(s) * T + t] || !tok[t]) continue;
            const int32_t af = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                          st.c_used + static_cast<size_t>(s) * R, s_req, R);
            if (af < 1 || !offer(st.atz, t, V1, W, wcz, wcc)) continue;
            best = max(best, af);
            if (dyn)
              for (int v = 0; v < V1; ++v)
                if (offer_in(st.atz, st.atc, dkey, t, v, V1, W, wcz, wcc))
                  atomicMax(&wpc[v], af);
          }
          for (int o = 16; o; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o));
          cap_any = best;
          __syncwarp();
        }
      }
      if (dyn)
        for (int v = lane; v < V1; v += 32)
          st.percap[static_cast<size_t>(s) * V1 + v] = live ? wpc[v] : 0;
      __syncwarp();
      if (lane == 0) {
        int32_t c = min(cap_any, hcap);  // open claims carry no prior
        c = min(c, count);
        c = min(c, h_allow(st.ch_cnt[s * JH + jhc]));
        st.claim_cap[s] = c;
      }
    }
    __syncthreads();

    // parity: phase existing-nodes
    // ---- 1. existing nodes, fixed priority order ----
    bool haff_exist_served = false;
    for (int n = tid; n < N; n += kThreads) {
      int32_t ec = in.cap_ng[static_cast<size_t>(n) * G + gi] > 0
                       ? fits_count(in.n_avail + static_cast<size_t>(n) * R,
                                    st.exist_used + static_cast<size_t>(n) * R, s_req, R)
                       : 0;
      ec = min(ec, max(wrap_sub(hcap, in.n_hcnt[static_cast<size_t>(n) * G + gi]), 0));
      ec = min(ec, h_allow(st.nhc[n * JH + jhc]));
      st.exist_cap[n] = ec;
    }
    if (N && haff) {
      // hostname-affinity single-entity pin: with priors the prior-holding
      // nodes; without, the first node with room hosts everyone
      int32_t prior = 0, first_free = INT_MAX;
      for (int n = tid; n < N; n += kThreads) {
        prior |= in.n_hcnt[static_cast<size_t>(n) * G + gi] > 0;
        if (st.exist_cap[n] >= 1) first_free = min(first_free, n);
      }
      const bool has_prior = block_max(prior, sh) > 0;
      first_free = block_min(first_free, sh);
      const bool has_free = first_free != INT_MAX;
      for (int n = tid; n < N; n += kThreads) {
        const bool keep = has_prior ? in.n_hcnt[static_cast<size_t>(n) * G + gi] > 0
                                    : (has_free && n == first_free);
        if (!keep) st.exist_cap[n] = 0;
      }
      haff_exist_served = has_prior || has_free;
    }
    __syncthreads();

    // ---- domain quota qd[NSLOT] ----
    if (dyn) {
      for (int n = tid; n < N; n += kThreads) {
        const int sl = nd_slot(n);
        if (sl < V1) atomicAdd(&s_czcap[sl], st.exist_cap[n]);
      }
      // AFFINITY bootstrap anchors: the first fitting node's domain, the
      // least-loaded eligible pinned claim's domain
      int32_t first_n = INT_MAX;
      unsigned long long claim_key = ~0ull;
      if (mode == kAffinity) {
        for (int n = tid; n < N; n += kThreads)
          if (st.exist_cap[n] >= 1 && nd_slot(n) < V1) first_n = min(first_n, n);
        first_n = block_min(first_n, sh);
        const int32_t* pin_axis = dkey == 0 ? out.c_dzone : out.c_dct;
        for (int s = tid; s < NMAX; s += kThreads) {
          int32_t pmax = 0;
          for (int v = 0; v < V1; ++v) pmax = max(pmax, st.percap[static_cast<size_t>(s) * V1 + v]);
          int32_t ccap = min(pmax, hcap);
          ccap = min(ccap, h_allow(st.ch_cnt[s * JH + jhc]));
          if (pin_axis[s] >= 0 && ccap >= 1) {
            const unsigned long long k2 = load_key(st.c_npods[s], s);
            claim_key = k2 < claim_key ? k2 : claim_key;
          }
        }
        claim_key = block_min_u64(claim_key, sh);
      }
      __syncthreads();
      if (tid == 0) {
        const int32_t skew = in.g_dskew[gi];
        const bool min0 = in.g_dmin0[gi];
        const int32_t* drank = in.g_drank + static_cast<size_t>(gi) * V1;
        for (int sl = 0; sl < NSLOT; ++sl) s_qd[sl] = 0;
        for (int v = 0; v < V1; ++v)
          s_wcap[v] = min(wrap_add(s_czcap[v], bit(s_fresh, v) ? kBigDom : 0), kBigDom);  // realcap
        if (mode == kAffinity) {
          // all pods pin to ONE domain: a nonempty shared domain binds every
          // follower; else the bootstrap walks existing nodes, open claims,
          // then the lowest-rank fresh-feasible domain
          int d_follow = 0, d_fresh = 0;
          int32_t best_follow = 0, best_fresh = 0;
          bool follow = false, any_fresh = false;
          for (int v = 0; v < V1; ++v) {
            const bool nonempty = s_D0[v] > 0 && reg[v];
            const bool fresh = bit(s_fresh, v) && reg[v];
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
            const int32_t raw = dkey == 0 ? in.n_dzone[first_n] : in.n_dct[first_n];
            d_aff = min(max(raw, 0), V1 - 1);
          } else if (has_claim) {
            const int s = static_cast<int>(claim_key & 0xffffffffu);
            d_aff = min(max((dkey == 0 ? out.c_dzone : out.c_dct)[s], 0), V1 - 1);
          }
          if (follow || has_exist || has_claim || any_fresh) s_qd[d_aff] = count;
        } else if (mode == kSpread || mode >= kGateSpread) {
          // SPREAD: the level cap L* = maxSkew + min over registered domains
          // of (prior + capacity), 0 under minDomains; GATE: domains within
          // skew of the static min (gate-spread) or nonempty (gate-affinity)
          int32_t lim = kBigDom;
          for (int v = 0; v < V1; ++v) {
            if (mode == kSpread)
              lim = min(lim, reg[v] ? wrap_add(s_D0[v], s_wcap[v]) : kBigDom);
            else
              lim = min(lim, reg[v] ? s_D0[v] : kBigDom);
          }
          if (min0) lim = 0;
          const int32_t lstar = wrap_add(skew, lim);
          for (int v = 0; v < V1; ++v) {
            int32_t c;
            if (mode == kSpread) {
              c = min(reg[v] ? clip(wrap_sub(lstar, s_D0[v]), 0, s_wcap[v]) : 0, count);
            } else {
              const bool allowed = reg[v] && (mode == kGateAff ? s_D0[v] > 0
                                                                : wrap_sub(s_D0[v], lim) <= skew);
              c = allowed ? min(s_wcap[v], count) : 0;
            }
            s_wnp[v] = reg[v] ? s_D0[v] : kBigDom;
            s_wcap[v] = c;
          }
          waterfill_serial(s_wnp, s_wcap, count, d.wf_iters, s_qd, V1);
        }
      }
    } else if (tid == 0) {
      for (int sl = 0; sl < NSLOT; ++sl) s_qd[sl] = sl == ANY ? count : 0;
    }
    __syncthreads();

    // tier-1 fill under per-domain budgets: within each slot the prefix
    // scan keeps node priority order; unconstrained groups have every node
    // in ANY and this is plain greedy_prefix_fill
    // parity: tiebreak cumsum
    int32_t placed_exist = 0;
    for (int sl = 0; sl < NSLOT; ++sl) {
      const int32_t budget = s_qd[sl];
      int32_t local = 0;
      if (budget > 0 && N) {
        int32_t carry = 0;
        for (int base = 0; base < N; base += kThreads) {
          const int n = base + tid;
          const bool in_slot = n < N && nd_slot(n) == sl;
          const int32_t x = in_slot ? st.exist_cap[n] : 0;
          int32_t chunk;
          const int32_t incl = block_scan(x, sh, &chunk);
          if (in_slot) {
            const int32_t before = wrap_add(carry, wrap_sub(incl, x));
            const int32_t fill = clip(wrap_sub(budget, before), 0, x);
            out.exist_fills[gi * N + n] = fill;
            local = wrap_add(local, fill);
            if (fill != 0) {
              for (int r = 0; r < R; ++r)
                st.exist_used[static_cast<size_t>(n) * R + r] += static_cast<float>(fill) * s_req[r];
              if (counted) st.nhc[n * JH + jhc] = wrap_add(st.nhc[n * JH + jhc], fill);
            }
          }
          carry = wrap_add(carry, chunk);
        }
      } else {
        for (int n = tid; n < N; n += kThreads)
          if (nd_slot(n) == sl) out.exist_fills[gi * N + n] = 0;
      }
      const int32_t placed = budget > 0 && N ? block_sum(local, sh) : 0;
      placed_exist = wrap_add(placed_exist, placed);
      // a served existing-entity pin absorbs what fits; the remainder of a
      // hostname-affinity group errors, never spills to claims
      if (tid == 0) s_qrem[sl] = haff_exist_served ? 0 : wrap_sub(budget, placed);
    }
    __syncthreads();

    // parity: phase open-claims
    // ---- 2. open claims, least-loaded first ----
    for (int s = tid; s < NMAX; s += kThreads) st.claim_fill[s] = 0;
    if (!dyn) {
      bool haff_any_claim = false;
      if (haff) {
        // restrict to the least-loaded eligible open claim
        // parity: tiebreak argmin
        unsigned long long key = ~0ull;
        for (int s = tid; s < NMAX; s += kThreads)
          if (st.claim_cap[s] >= 1) {
            const unsigned long long k2 = load_key(st.c_npods[s], s);
            key = k2 < key ? k2 : key;
          }
        key = block_min_u64(key, sh);
        haff_any_claim = key != ~0ull;
        const int tstar = static_cast<int>(key & 0xffffffffu);
        for (int s = tid; s < NMAX; s += kThreads)
          if (!(haff_any_claim && s == tstar)) st.claim_cap[s] = 0;
      }
      __syncthreads();
      waterfill(st.c_npods, st.claim_cap, s_qrem[ANY], d.wf_iters, st.claim_fill, NMAX, sh);
      int32_t local = 0;
      for (int s = tid; s < NMAX; s += kThreads) local = wrap_add(local, st.claim_fill[s]);
      const int32_t placed = block_sum(local, sh);
      if (tid == 0) {
        s_qrem[ANY] = wrap_sub(s_qrem[ANY], placed);
        // a served claim pin absorbs what fits; the remainder errors
        if (haff_any_claim)
          for (int sl = 0; sl < NSLOT; ++sl) s_qrem[sl] = 0;
      }
    } else {
      // one domain per claim (spread_domain_choice): admissible domains
      // have capacity on the claim and remaining quota; claims rank in
      // slot order for the quota-proportional pick
      int32_t carry = 0;
      for (int base = 0; base < NMAX; base += kThreads) {
        const int s = base + tid;
        bool adm = false;
        if (s < NMAX)
          for (int v = 0; v < V1 && !adm; ++v)
            adm = st.percap[static_cast<size_t>(s) * V1 + v] >= 1 && s_qrem[v] > 0;
        int32_t chunk;
        const int32_t incl = block_scan(adm ? 1 : 0, sh, &chunk);
        if (s < NMAX) st.c_slot[s] = adm ? wrap_sub(wrap_add(carry, incl), 1) : -1;  // rank
        carry = wrap_add(carry, chunk);
      }
      const int32_t n_adm = carry;
      if (tid == 0) {
        // cumulative quota shares, float32 as XLA computes them
        int32_t total = 0;
        for (int v = 0; v < V1; ++v) total = wrap_add(total, max(s_qrem[v], 0));
        int32_t acc = 0;
        const float denom = __int2float_rn(max(total, 1));
        for (int v = 0; v < V1; ++v) {
          acc = wrap_add(acc, max(s_qrem[v], 0));
          s_cumf[v] = __fdiv_rn(__int2float_rn(acc), denom);
        }
        for (int sl = 0; sl < NSLOT; ++sl) s_sflag[sl] = 0;
      }
      __syncthreads();
      const float n_f = __int2float_rn(max(n_adm, 1));
      for (int s = tid; s < NMAX; s += kThreads) {
        const int32_t rank = st.c_slot[s];
        int cs = DEAD;
        if (rank >= 0) {
          const int32_t* pc = st.percap + static_cast<size_t>(s) * V1;
          // greedy: the admissible domain with the largest remaining quota
          // parity: tiebreak argmax
          int d_greedy = 0;
          int32_t bq = 0;
          for (int v = 0; v < V1; ++v) {
            const int32_t q = (pc[v] >= 1 && s_qrem[v] > 0) ? s_qrem[v] : -1;
            if (v == 0 || q > bq) { bq = q; d_greedy = v; }
          }
          // proportional: the first cumulative share >= (rank + 0.5) / n
          // parity: const 0.5
          // parity: tiebreak searchsorted
          const float x = __fdiv_rn(__fadd_rn(__int2float_rn(rank), 0.5f), n_f);
          int d_prop = V1;
          for (int v = 0; v < V1; ++v)
            if (s_cumf[v] >= x) { d_prop = v; break; }
          d_prop = min(d_prop, V1 - 1);
          const bool prop_ok = pc[d_prop] >= 1 && s_qrem[d_prop] > 0;
          cs = (prop_ok && mode == kSpread) ? d_prop : d_greedy;
          int32_t c = min(pc[cs], hcap);
          c = min(c, count);
          c = min(c, h_allow(st.ch_cnt[s * JH + jhc]));
          st.claim_cap[s] = c;
          if (c > 0) s_sflag[cs] = 1;
        } else {
          st.claim_cap[s] = min(min(min(0, hcap), count), h_allow(st.ch_cnt[s * JH + jhc]));
        }
        st.c_slot[s] = cs;
      }
      __syncthreads();
      // one water-fill per domain slot with claims (a slot whose every cap
      // is 0 hands out nothing)
      for (int sl = 0; sl < V1; ++sl) {
        if (!s_sflag[sl]) continue;
        waterfill(st.c_npods, st.claim_cap, s_qrem[sl], d.wf_iters, st.claim_fill, NMAX, sh,
                  st.c_slot, sl);
        int32_t local = 0;
        for (int s = tid; s < NMAX; s += kThreads)
          if (st.c_slot[s] == sl) local = wrap_add(local, st.claim_fill[s]);
        const int32_t placed = block_sum(local, sh);
        if (tid == 0) s_qrem[sl] = wrap_sub(s_qrem[sl], placed);
        __syncthreads();
      }
    }
    __syncthreads();

    // survival + commit of the claims that got pods (one warp per claim):
    // add_fit saw the pre-fill load, so "still fits" is add_fit >= fill; a
    // dynamic group's claim is pinned to its domain (the constrained-axis
    // mask row narrows to it, its types need an offering there)
    for (int s = wid; s < NMAX; s += kWarps) {
      const int32_t fill = st.claim_fill[s];
      if (fill == 0) continue;
      if (fill > 0) {
        const int pp = out.c_pool[s];
        const int cs = dyn ? st.c_slot[s] : ANY;
        const bool tighten = dyn && cs < V1;
        uint32_t* wcz = s_cz + wid * 2 * W;
        uint32_t* wcc = wcz + W;
        uint8_t* row = st.c_mask + static_cast<size_t>(s) * K * V1;
        if (lane < W) {
          wcz[lane] = mask_word(row + d.zone_kid * V1, V1, lane) & s_gz[lane];
          wcc[lane] = mask_word(row + d.ct_kid * V1, V1, lane) & s_gc[lane];
        }
        __syncwarp();
        const uint8_t* tok = type_ok_row + (static_cast<size_t>(pp) * G + gi) * T;
        for (int t = lane; t < T; t += 32) {
          uint8_t* cell = out.c_tmask + static_cast<size_t>(s) * T + t;
          if (!*cell) continue;
          const int32_t af = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                        st.c_used + static_cast<size_t>(s) * R, s_req, R);
          bool keep = tok[t] && offer(st.atz, t, V1, W, wcz, wcc) && af >= fill;
          if (keep && tighten) keep = offer_in(st.atz, st.atc, dkey, t, cs, V1, W, wcz, wcc);
          if (!keep) *cell = 0;
        }
        for (int k = lane; k < K; k += 32) {
          st.c_def[s * K + k] = st.c_def[s * K + k] || s_gdef[k];
          st.c_neg[s * K + k] = st.c_neg[s * K + k] && s_gneg[k];
          for (int v = 0; v < V1; ++v)
            row[k * V1 + v] = row[k * V1 + v] && s_gmask[k * V1 + v] &&
                              !(tighten && k == kid_sel && v != cs);
        }
        if (tighten && lane == 0) (dkey == 0 ? out.c_dzone : out.c_dct)[s] = cs;
        __syncwarp();
      }
      for (int r = lane; r < R; r += 32)
        st.c_used[static_cast<size_t>(s) * R + r] += static_cast<float>(fill) * s_req[r];
      if (lane == 0) {
        st.c_npods[s] = wrap_add(st.c_npods[s], fill);
        if (counted) st.ch_cnt[s * JH + jhc] = wrap_add(st.ch_cnt[s * JH + jhc], fill);
      }
    }
    if (tid == 0)
      for (int sl = 0; sl < NSLOT; ++sl) s_ddead[sl] = sl == DEAD;
    __syncthreads();

    // parity: phase fresh-claims
    // ---- 3. new claims from the highest-weight feasible template ----
    // Each trip serves the slot with the largest remaining quota and opens
    // one BULK of k identical claims of one template against a frozen
    // avail set; a no-progress trip retires the slot.
    // parity: tiebreak argmax
    while (!overflow) {
      int d_sel = 0;
      int32_t bq = 0;
      bool any = false;
      for (int sl = 0; sl < NSLOT; ++sl) {
        const int32_t q = s_ddead[sl] ? -1 : s_qrem[sl];
        any = any || q > 0;
        if (sl == 0 || q > bq) { bq = q; d_sel = sl; }
      }
      if (!any) break;
      const int32_t rem_d = s_qrem[d_sel];
      const bool pinned = dyn && d_sel != ANY;  // a domain-pinned bulk
      int32_t p_min = P;
      for (int i = tid; i < P * T; i += kThreads) {
        const int p = i / T, t = i % T;
        bool ok = type_ok_row[(static_cast<size_t>(p) * G + gi) * T + t];
        if (ok && in.p_has_limit[p])
          for (int r = 0; r < R && ok; ++r)
            ok = in.t_cap[static_cast<size_t>(t) * R + r] <= st.pool_rem[p * R + r];
        if (ok && pinned) ok = st.toff_pt[static_cast<size_t>(i) * V1 + d_sel];
        st.avail[i] = ok;
        if (ok) p_min = min(p_min, p);
      }
      p_min = block_min(p_min, sh);  // first feasible template in weight order
      const bool any_feasible = p_min < P;
      const int p_star = any_feasible ? p_min : 0;
      const uint8_t* av = st.avail + static_cast<size_t>(p_star) * T;
      const int32_t* nf = in.n_fit + (static_cast<size_t>(p_star) * G + gi) * T;
      int32_t best = INT_MIN;
      for (int t = tid; t < T; t += kThreads) best = max(best, av[t] ? nf[t] : 0);
      int32_t n_per = min(block_max(best, sh), hcap);
      n_per = min(n_per, counted ? scap_h : kBigDom);
      // pessimistic limit debit: max capacity over the claim's options
      for (int r = 0; r < R; ++r) {
        float m = -INFINITY;
        for (int t = tid; t < T; t += kThreads)
          m = fmaxf(m, av[t] ? in.t_cap[static_cast<size_t>(t) * R + r] : 0.0f);
        m = block_max_f(m, sh);
        if (tid == 0) s_debit[r] = m;
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
      const int32_t slot = n_open;
      const int32_t k_slots = max(NMAX - slot, 0);
      if (haff) k_want = min(k_want, 1);
      int32_t k = min(k_want, k_slots);
      const bool ok = any_feasible && k > 0 && n_per > 0;
      if (!ok) k = 0;
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
              in.p_daemon[p_star * R + r] + static_cast<float>(take) * s_req[r];
        st.c_npods[s] = take;
        out.c_pool[s] = p_star;
        for (int kk = 0; kk < K; ++kk) {
          st.c_def[s * K + kk] = s_gdef[kk];
          st.c_neg[s * K + kk] = s_gneg[kk];
        }
        // claims opened for a dynamic group are domain-pinned from birth
        for (int i = 0; i < K * V1; ++i)
          st.c_mask[static_cast<size_t>(s) * K * V1 + i] =
              s_gmask[i] && !(pinned && i / V1 == kid_sel && i % V1 != d_sel);
        if (pinned) (dkey == 0 ? out.c_dzone : out.c_dct)[s] = d_sel;
        for (int j = 0; j < JH; ++j)
          st.ch_cnt[s * JH + j] = (counted && j == jhc) ? take : 0;
        st.claim_fill[s] = wrap_add(st.claim_fill[s], take);
        local = wrap_add(local, take);
      }
      for (long long i = tid; i < static_cast<long long>(k) * T; i += kThreads) {
        const int s = slot + static_cast<int>(i / T), t = static_cast<int>(i % T);
        out.c_tmask[static_cast<size_t>(s) * T + t] = av[t] && nf[t] >= take_of(s);
      }
      const int32_t placed = block_sum(local, sh);
      if (ok && in.p_has_limit[p_star])
        for (int r = tid; r < R; r += kThreads)
          st.pool_rem[p_star * R + r] += (-s_debit[r]) * static_cast<float>(k);
      n_open = slot + k;
      if (any_feasible && n_per > 0 && k_want > k_slots) overflow = true;
      __syncthreads();
      if (tid == 0) {
        s_qrem[d_sel] = wrap_sub(s_qrem[d_sel], placed);
        // haff groups retire after ONE trip (a second opens a second entity)
        if (placed == 0 || haff) s_ddead[d_sel] = 1;
      }
      __syncthreads();
    }

    // parity: phase spread-counters
    // shared domain carry: a SELF owner's per-domain placements feed the
    // next sharing group's counts (gate modes never count themselves)
    if (has_d && mode < kGateSpread)
      for (int v = tid; v < V1; v += kThreads)
        st.ddc[static_cast<size_t>(min(jd, JD - 1)) * V1 + v] = wrap_add(
            st.ddc[static_cast<size_t>(min(jd, JD - 1)) * V1 + v], wrap_sub(s_qd[v], s_qrem[v]));

    // per-group outputs: claim fills and the unplaced count
    int32_t local = 0;
    for (int s = tid; s < NMAX; s += kThreads) {
      const int32_t f = st.claim_fill[s];
      out.claim_fills[static_cast<size_t>(gi) * NMAX + s] = f;
      local = wrap_add(local, f);
    }
    const int32_t placed_claims = block_sum(local, sh);
    if (tid == 0) out.unplaced[gi] = wrap_sub(wrap_sub(count, placed_exist), placed_claims);
    __syncthreads();
  }
  if (tid == 0) {
    out.n_open[0] = n_open;
    out.overflow[0] = overflow;
  }
}

}  // namespace

extern "C" int kt_pack(
    int S, int G, int T, int P, int N, int R, int K, int V1, int NMAX, int JH,
    int JD, int zone_kid, int ct_kid, int wf_iters, int has_domains,
    // scenario strides of the batched inputs (0: shared)
    long long s_g_count, long long s_cap_ng, long long s_n_hcnt,
    long long s_nh_cnt0, long long s_g_dprior, long long s_dd0,
    // groups (FFD order)
    const int32_t* g_count, const float* g_req, const uint8_t* g_def,
    const uint8_t* g_neg, const uint8_t* g_mask, const int32_t* g_hcap,
    const uint8_t* g_haff, const int32_t* g_hstg, const int32_t* g_hscap,
    const uint8_t* g_hself,
    // feasibility tables
    const uint8_t* compat_pg, const uint8_t* type_ok, const int32_t* n_fit,
    const int32_t* cap_ng,
    // types, offerings, templates, existing nodes
    const float* t_alloc, const float* t_cap, const uint8_t* a_tzc,
    const float* p_daemon, const float* p_limit, const uint8_t* p_has_limit,
    const uint8_t* p_tol,
    const float* n_avail, const float* n_base, const int32_t* n_hcnt,
    const int32_t* nh_cnt0, const uint8_t* well_known,
    // domain-constraint descriptors, template masks, node domains, carry
    const int32_t* g_dmode, const int32_t* g_dkey, const int32_t* g_dskew,
    const uint8_t* g_dmin0, const int32_t* g_dprior, const uint8_t* g_dreg,
    const int32_t* g_drank, const int32_t* g_dtg, const uint8_t* p_mask,
    const int32_t* n_dzone, const int32_t* n_dct, const int32_t* dd0,
    // state + scratch
    float* exist_used, float* c_used, int32_t* c_npods, uint8_t* c_def,
    uint8_t* c_neg, uint8_t* c_mask, int32_t* ch_cnt, int32_t* nhc,
    float* pool_rem, int32_t* exist_cap, int32_t* claim_cap,
    int32_t* claim_fill, uint8_t* avail, uint32_t* atz,
    uint32_t* atc, uint8_t* toff_pt, int32_t* percap, int32_t* c_slot,
    int32_t* ddc,
    // outputs
    int32_t* c_pool, uint8_t* c_tmask, int32_t* n_open, uint8_t* overflow,
    int32_t* exist_fills, int32_t* claim_fills, int32_t* unplaced,
    int32_t* c_dzone, int32_t* c_dct, uint8_t* c_resv,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (R > 32 || JH < 1 || JD < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return kt::kNothingLaunched;
  const int W = (V1 + 31) / 32;
  Dims d{G, T, P, N, R, K, V1, NMAX, JH, JD, zone_kid, ct_kid, wf_iters, W,
         has_domains != 0};
  In in{g_count, g_req, g_def, g_neg, g_mask, g_hcap, g_haff, g_hstg, g_hscap,
        g_hself, compat_pg, type_ok, n_fit, cap_ng, t_alloc, t_cap, a_tzc,
        p_daemon, p_limit, p_has_limit, p_tol, n_avail, n_base, n_hcnt,
        nh_cnt0, well_known, g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior,
        g_dreg, g_drank, g_dtg, p_mask, n_dzone, n_dct, dd0};
  State st{exist_used, c_used, c_npods, c_def, c_neg, c_mask, ch_cnt, nhc,
           pool_rem, exist_cap, claim_cap, claim_fill, avail, atz,
           atc, toff_pt, percap, c_slot, ddc};
  Out out{c_pool, c_tmask, n_open, overflow, exist_fills, claim_fills,
          unplaced, c_dzone, c_dct, c_resv};
  Strides sc{s_g_count, s_cap_ng, s_n_hcnt, s_nh_cnt0, s_g_dprior, s_dd0};
  const int NSLOT = V1 + 2;
  const size_t words = static_cast<size_t>(kWarps) * 2 * W + 2 * W + 2 * P * W + W +
                       4 * NSLOT + 5 * V1 + static_cast<size_t>(kWarps) * V1 + R;
  const size_t smem = sizeof(uint32_t) * words + static_cast<size_t>(K) * (2 + V1);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(pack_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  pack_scan<<<S, kThreads, smem, stream>>>(d, in, st, out, sc);
  return static_cast<int>(cudaGetLastError());
}
