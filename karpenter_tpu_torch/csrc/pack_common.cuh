// The packing scan's phases, shared by kernel B4 (pack.cu, one step per
// group) and kernel B5 (pack_classed.cu, one step per feasibility class
// with an inner loop over its member groups). Each phase is the device
// form of one part of karpenter_tpu/ops/packing.py's step body; both
// kernels call the same functions, so the two scans place a group the
// same way, bit for bit.
//
// Every function here is called by all threads of one 1024-thread block;
// those that end in a block barrier say so. Reductions and scans are
// integer (exact in any order); argmin/argmax break ties at the lowest
// index; float32 ledgers use two IEEE roundings per a*b+c (built with
// -fmad=false), as XLA computes them.
#pragma once

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

// bit c of word w of a value-slot mask row: the claim/template masks
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
  bool has_domains, has_contrib;
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

// per-step shared memory, carved from the dynamic allocation
struct Smem {
  uint32_t* cz;     // [kWarps][2][W] per-warp claim zone / capacity-type words
  uint32_t* gz;     // [W] the group's zone words
  uint32_t* gc;     // [W] ... capacity-type words
  uint32_t* pz;     // [P][W] template ∧ group zone words
  uint32_t* pc;     // [P][W]
  uint32_t* fresh;  // [W] fresh_ok_d bits
  int32_t* qd;      // [NSLOT] the group's domain quota
  int32_t* qrem;    // [NSLOT] what is left of it
  int32_t* ddead;   // [NSLOT] retired slots of the fresh-claim loop
  int32_t* sflag;   // [NSLOT] slots with a claim of positive cap
  int32_t* D0;      // [V1] domain counts: priors + the shared carry
  int32_t* czcap;   // [V1] existing-node capacity per domain
  int32_t* wcap;    // [V1] water-fill caps of the quota
  int32_t* wnp;     // [V1] water-fill levels of the quota
  float* cumf;      // [V1] cumulative quota shares
  int32_t* pcap;    // [kWarps][V1] per-warp per-domain claim capacity
  int32_t* dsum;    // [4][V1] contributor sums: node zone, node ct, claim zone, claim ct
  int32_t* pmax;    // [V1] per-domain best fit of a bulk's template
  float* req;       // [R]
  uint8_t* gdef;    // [K]
  uint8_t* gneg;    // [K]
  uint8_t* gmask;   // [K * V1]
};

inline size_t smem_bytes(int P, int W, int V1, int K, int R) {
  const int NSLOT = V1 + 2;
  const size_t words = static_cast<size_t>(kWarps) * 2 * W + 2 * W + 2 * static_cast<size_t>(P) * W +
                       W + 4 * NSLOT + 5 * V1 + static_cast<size_t>(kWarps) * V1 + 5 * V1 + R;
  return sizeof(uint32_t) * words + static_cast<size_t>(K) * (2 + V1);
}

__device__ void carve(unsigned char* dyn, const Dims& d, Smem& m) {
  const int W = d.W, P = d.P, V1 = d.V1, NSLOT = d.V1 + 2;
  m.cz = reinterpret_cast<uint32_t*>(dyn);
  m.gz = m.cz + kWarps * 2 * W;
  m.gc = m.gz + W;
  m.pz = m.gc + W;
  m.pc = m.pz + P * W;
  m.fresh = m.pc + P * W;
  m.qd = reinterpret_cast<int32_t*>(m.fresh + W);
  m.qrem = m.qd + NSLOT;
  m.ddead = m.qrem + NSLOT;
  m.sflag = m.ddead + NSLOT;
  m.D0 = m.sflag + NSLOT;
  m.czcap = m.D0 + V1;
  m.wcap = m.czcap + V1;
  m.wnp = m.wcap + V1;
  m.cumf = reinterpret_cast<float*>(m.wnp + V1);
  m.pcap = reinterpret_cast<int32_t*>(m.cumf + V1);
  m.dsum = m.pcap + kWarps * V1;
  m.pmax = m.dsum + 4 * V1;
  m.req = reinterpret_cast<float*>(m.pmax + V1);
  m.gdef = reinterpret_cast<uint8_t*>(m.req + d.R);
  m.gneg = m.gdef + d.K;
  m.gmask = m.gneg + d.K;
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

// ---- pack state init (PackState, packing.py:357) ----
// parity: state exist_used, c_used, c_npods, c_active, c_pool, c_tmask
// parity: state c_def, c_neg, c_mask, c_dzone, c_dct, ch_cnt, nhc
// parity: state ddc, c_resv, pool_rem, n_open, overflow
// Ends in a block barrier.
__device__ void init_state(const Dims& d, const In& in, const State& st, const Out& out) {
  const int tid = threadIdx.x;
  const int T = d.T, N = d.N, R = d.R, K = d.K, V1 = d.V1, NMAX = d.NMAX, W = d.W;
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
  for (int i = tid; i < NMAX * d.JH; i += kThreads) st.ch_cnt[i] = 0;
  for (int i = tid; i < N * d.JH; i += kThreads) st.nhc[i] = in.nh_cnt0[i];
  for (int i = tid; i < d.JD * V1; i += kThreads) st.ddc[i] = in.dd0[i];
  for (int i = tid; i < d.P * R; i += kThreads) st.pool_rem[i] = in.p_limit[i];
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
  __syncthreads();
}

// The group's request and requirement rows (row ``gi`` of the group
// inputs) into shared memory. No barrier.
__device__ void load_rows(const Dims& d, const In& in, int gi, const Smem& m) {
  const int tid = threadIdx.x, K = d.K, V1 = d.V1;
  for (int i = tid; i < d.R; i += kThreads) m.req[i] = in.g_req[static_cast<size_t>(gi) * d.R + i];
  for (int i = tid; i < K; i += kThreads) {
    m.gdef[i] = in.g_def[gi * K + i];
    m.gneg[i] = in.g_neg[gi * K + i];
  }
  for (int i = tid; i < K * V1; i += kThreads)
    m.gmask[i] = in.g_mask[static_cast<size_t>(gi) * K * V1 + i];
  for (int i = tid; i < d.W; i += kThreads) {
    m.gz[i] = mask_word(in.g_mask + (static_cast<size_t>(gi) * K + d.zone_kid) * V1, V1, i);
    m.gc[i] = mask_word(in.g_mask + (static_cast<size_t>(gi) * K + d.ct_kid) * V1, V1, i);
  }
}

// The templates' per-domain offering table toff_pt [P, T, V1] on axis
// ``dkey``, and fresh_ok_d (some type a template may open for the group
// in table column ``ti`` has an offering in the domain), for the group
// requirement rows of ``gi``. Two barriers; ends in one.
__device__ void template_domains(const Dims& d, const In& in, const State& st, const Smem& m,
                                 int gi, int ti, int dkey) {
  const int tid = threadIdx.x, P = d.P, T = d.T, V1 = d.V1, W = d.W, K = d.K;
  for (int i = tid; i < W; i += kThreads) m.fresh[i] = 0;
  const uint8_t* gm = in.g_mask + static_cast<size_t>(gi) * K * V1;
  for (int i = tid; i < P * W; i += kThreads) {
    const uint8_t* pm = in.p_mask + static_cast<size_t>(i / W) * K * V1;
    m.pz[i] = mask_word(pm + d.zone_kid * V1, V1, i % W) & mask_word(gm + d.zone_kid * V1, V1, i % W);
    m.pc[i] = mask_word(pm + d.ct_kid * V1, V1, i % W) & mask_word(gm + d.ct_kid * V1, V1, i % W);
  }
  __syncthreads();
  for (long long i = tid; i < static_cast<long long>(P) * T * V1; i += kThreads) {
    const int p = static_cast<int>(i / (static_cast<long long>(T) * V1));
    const int t = static_cast<int>((i / V1) % T), v = static_cast<int>(i % V1);
    const bool ok = offer_in(st.atz, st.atc, dkey, t, v, V1, W, m.pz + p * W, m.pc + p * W);
    st.toff_pt[i] = ok;
    if (ok && in.type_ok[(static_cast<size_t>(p) * d.G + ti) * T + t])
      atomicOr(&m.fresh[v >> 5], 1u << (v & 31));
  }
  __syncthreads();
}

// Is open claim ``s`` compatible with the group (packing.py: key_ok ∧
// custom_ok ∧ the template's tolerations and compatibility in table
// column ``ti``)? Called by one whole warp; every lane gets the answer.
__device__ bool warp_claim_compat(const Dims& d, const In& in, const State& st, const Out& out,
                                  const Smem& m, int s, int ti) {
  const int lane = threadIdx.x & 31, K = d.K, V1 = d.V1;
  bool ok = true;
  for (int k = lane; k < K; k += 32) {
    const uint8_t* sm = st.c_mask + (static_cast<size_t>(s) * K + k) * V1;
    bool ov = false;
    for (int v = 0; v < V1 && !ov; ++v) ov = sm[v] && m.gmask[k * V1 + v];
    const bool sd = st.c_def[s * K + k], sn = st.c_neg[s * K + k];
    const bool key_ok = ov || (sn && m.gneg[k]) || !(sd && m.gdef[k]);
    const bool custom = !m.gdef[k] || in.well_known[k] || sd || m.gneg[k];
    ok = ok && key_ok && custom;
  }
  ok = __all_sync(kFull, ok);
  const int pp = out.c_pool[s];
  return ok && in.p_tol[pp * d.G + ti] && in.compat_pg[pp * d.G + ti];
}

// The warp's claim zone / capacity-type words, merged with the group's.
// Called by one whole warp; ends in __syncwarp.
__device__ uint32_t* warp_claim_words(const Dims& d, const State& st, const Smem& m, int s) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, W = d.W;
  uint32_t* wcz = m.cz + wid * 2 * W;
  if (lane < W) {
    const uint8_t* row = st.c_mask + static_cast<size_t>(s) * d.K * d.V1;
    wcz[lane] = mask_word(row + d.zone_kid * d.V1, d.V1, lane) & m.gz[lane];
    wcz[W + lane] = mask_word(row + d.ct_kid * d.V1, d.V1, lane) & m.gc[lane];
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

// waterfill (packing.py:105): smallest level L with
// sum(clip(L - npods, 0, cap)) >= n by bisection ((lo + hi) // 2, at most
// `iters` trips), then the deficit layer handed out by slot index. With
// `slot_of`, only slots s with slot_of[s] == sl take part: the others act
// as (npods _BIGI, cap 0), which contribute nothing and are never filled,
// and their `fill` entries are left untouched. Ends in a barrier.
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

// waterfill1 (packing.py:82): for n <= 1 the pod lands on the first
// least-loaded slot with capacity, no bisection. Ends in a barrier.
__device__ void waterfill1(const int32_t* npods, const int32_t* cap, int32_t n, int iters,
                           int32_t* fill, int NMAX, Shared& sh) {
  if (n > 1) {
    waterfill(npods, cap, n, iters, fill, NMAX, sh);
    return;
  }
  unsigned long long key = ~0ull;
  for (int s = threadIdx.x; s < NMAX; s += kThreads)
    if (cap[s] > 0) {
      const unsigned long long k2 = load_key(npods[s], s);
      key = k2 < key ? k2 : key;
    }
  key = block_min_u64(key, sh);
  const int tstar = (n >= 1 && key != ~0ull) ? static_cast<int>(key & 0xffffffffu) : -1;
  for (int s = threadIdx.x; s < NMAX; s += kThreads) fill[s] = s == tstar ? 1 : 0;
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
// per-domain capacity st.percap (0 on claims that are not live). Needs
// m.D0 and m.fresh; ``wf1``: the quota water-fill is waterfill1 (B5).
// Call after a barrier; ends in one.
__device__ void domain_quota(const Dims& d, const In& in, const State& st, const Out& out,
                             const Smem& m, const Grp& g, const int32_t* cap, bool wf1,
                             Shared& sh) {
  const int tid = threadIdx.x, N = d.N, NMAX = d.NMAX, V1 = d.V1, JH = d.JH;
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
    for (int s = tid; s < NMAX; s += kThreads) {
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
  if (threadIdx.x == 0)
    for (int sl = 0; sl < d.V1 + 2; ++sl) m.qd[sl] = sl == d.V1 ? count : 0;
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
  for (int sl = 0; sl < d.V1 + 2; ++sl) {
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
// Over st.claim_cap (already clamped); hostname affinity restricts it to
// the least-loaded eligible claim. ``wf1``: the water-fill is waterfill1
// (B5). Writes st.claim_fill. Call after a barrier; ends in one.
__device__ void tier2_any(const Dims& d, const State& st, const Smem& m, const Grp& g, bool wf1,
                          Shared& sh) {
  const int tid = threadIdx.x, NMAX = d.NMAX, ANY = d.V1;
  bool haff_any_claim = false;
  if (g.haff) {
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
  if (wf1)
    waterfill1(st.c_npods, st.claim_cap, m.qrem[ANY], d.wf_iters, st.claim_fill, NMAX, sh);
  else
    waterfill(st.c_npods, st.claim_cap, m.qrem[ANY], d.wf_iters, st.claim_fill, NMAX, sh);
  int32_t local = 0;
  for (int s = tid; s < NMAX; s += kThreads) local = wrap_add(local, st.claim_fill[s]);
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
// One domain per claim (spread_domain_choice): admissible domains have
// capacity on the claim (st.percap, 0 on claims that are not live) and
// remaining quota; claims rank in slot order for the quota-proportional
// pick. Then one water-fill per domain slot with claims (a slot whose
// every cap is 0 hands out nothing); ``single`` (B5, count <= 1): at most
// one slot carries quota, so one least-loaded pick in the slot with the
// largest quota. Writes st.c_slot, st.claim_cap, st.claim_fill. Call
// after a barrier; ends in one.
__device__ void tier2_domains(const Dims& d, const State& st, const Smem& m, const Grp& g,
                              bool single, Shared& sh) {
  const int tid = threadIdx.x, NMAX = d.NMAX, V1 = d.V1, JH = d.JH;
  const int NSLOT = V1 + 2, DEAD = V1 + 1;
  int32_t carry = 0;
  for (int base = 0; base < NMAX; base += kThreads) {
    const int s = base + tid;
    bool adm = false;
    if (s < NMAX)
      for (int v = 0; v < V1 && !adm; ++v)
        adm = st.percap[static_cast<size_t>(s) * V1 + v] >= 1 && m.qrem[v] > 0;
    int32_t chunk;
    const int32_t incl = block_scan(adm ? 1 : 0, sh, &chunk);
    if (s < NMAX) st.c_slot[s] = adm ? wrap_sub(wrap_add(carry, incl), 1) : -1;  // rank
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
    for (int s = tid; s < NMAX; s += kThreads)
      if (st.c_slot[s] == s_star && st.claim_cap[s] >= 1) {
        const unsigned long long k2 = load_key(st.c_npods[s], s);
        key = k2 < key ? k2 : key;
      }
    key = block_min_u64(key, sh);
    const bool take = m.qrem[s_star] >= 1 && key != ~0ull;
    if (take)
      for (int s = tid; s < NMAX; s += kThreads)
        if (s == static_cast<int>(key & 0xffffffffu)) st.claim_fill[s] = 1;
    __syncthreads();
    if (tid == 0 && take) m.qrem[s_star] = wrap_sub(m.qrem[s_star], 1);
    __syncthreads();
    return;
  }
  for (int sl = 0; sl < V1; ++sl) {
    if (!m.sflag[sl]) continue;
    waterfill(st.c_npods, st.claim_cap, m.qrem[sl], d.wf_iters, st.claim_fill, NMAX, sh,
              st.c_slot, sl);
    int32_t local = 0;
    for (int s = tid; s < NMAX; s += kThreads)
      if (st.c_slot[s] == sl) local = wrap_add(local, st.claim_fill[s]);
    const int32_t placed = block_sum(local, sh);
    if (tid == 0) m.qrem[sl] = wrap_sub(m.qrem[sl], placed);
    __syncthreads();
  }
  __syncthreads();
}

// Commit of the claims that got pods (one warp per claim): their
// requirement rows merge the group's, a dynamic group's claim is pinned
// to its domain (the constrained-axis mask row narrows to it), and load,
// pod count and the counted hostname column grow by the fill. With
// ``tmask`` (B4) the claim's type mask also drops the types that no
// longer survive: add_fit saw the pre-fill load, so "still fits" is
// add_fit >= fill, and a pinned claim's types need an offering there (B5
// settles type masks once per class instead). Call after a barrier; ends
// in one.
__device__ void commit_claims(const Dims& d, const In& in, const State& st, const Out& out,
                              const Smem& m, const Grp& g, bool tmask) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int T = d.T, R = d.R, K = d.K, V1 = d.V1, W = d.W, JH = d.JH;
  for (int s = wid; s < d.NMAX; s += kWarps) {
    const int32_t fill = st.claim_fill[s];
    if (fill == 0) continue;
    if (fill > 0) {
      const int cs = g.dyn ? st.c_slot[s] : V1;
      const bool tighten = g.dyn && cs < V1;
      uint8_t* row = st.c_mask + static_cast<size_t>(s) * K * V1;
      if (tmask) {
        const uint32_t* wcz = warp_claim_words(d, st, m, s);
        const uint32_t* wcc = wcz + W;
        const int pp = out.c_pool[s];
        const uint8_t* tok = in.type_ok + (static_cast<size_t>(pp) * d.G + g.ti) * T;
        for (int t = lane; t < T; t += 32) {
          uint8_t* cell = out.c_tmask + static_cast<size_t>(s) * T + t;
          if (!*cell) continue;
          const int32_t af = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                        st.c_used + static_cast<size_t>(s) * R, m.req, R);
          bool keep = tok[t] && offer(st.atz, t, V1, W, wcz, wcc) && af >= fill;
          if (keep && tighten) keep = offer_in(st.atz, st.atc, g.dkey, t, cs, V1, W, wcz, wcc);
          if (!keep) *cell = 0;
        }
      }
      for (int k = lane; k < K; k += 32) {
        st.c_def[s * K + k] = st.c_def[s * K + k] || m.gdef[k];
        st.c_neg[s * K + k] = st.c_neg[s * K + k] && m.gneg[k];
        for (int v = 0; v < V1; ++v)
          row[k * V1 + v] = row[k * V1 + v] && m.gmask[k * V1 + v] &&
                            !(tighten && k == g.kid_sel && v != cs);
      }
      if (tighten && lane == 0) (g.dkey == 0 ? out.c_dzone : out.c_dct)[s] = cs;
      __syncwarp();
    }
    for (int r = lane; r < R; r += 32)
      st.c_used[static_cast<size_t>(s) * R + r] += static_cast<float>(fill) * m.req[r];
    if (lane == 0) {
      st.c_npods[s] = wrap_add(st.c_npods[s], fill);
      if (g.counted) st.ch_cnt[s * JH + g.jhc] = wrap_add(st.ch_cnt[s * JH + g.jhc], fill);
    }
  }
  __syncthreads();
}

// What a fresh-claim bulk tells B5's maintained claim summaries; B4 keeps
// none. ``trip`` runs block-wide once the bulk's template is chosen,
// ``open`` for each slot opened (by the thread that opens it), ``cell``
// for each (slot, type) of the opened claims.
struct NoBulkHook {
  __device__ void trip(const uint8_t*, const int32_t*, int, Shared&) const {}
  __device__ void open(int, int32_t, int32_t, int) const {}
  __device__ void cell(int, int, int32_t, int32_t) const {}
};

// parity: phase fresh-claims
// ---- 3. new claims from the highest-weight feasible template ----
// Each trip serves the slot with the largest remaining quota and opens
// one BULK of k identical claims of one template against a frozen avail
// set; a no-progress trip retires the slot. Adds the takes to
// st.claim_fill. Call after a barrier; ends in one.
// parity: tiebreak argmax
template <class Hook>
__device__ void fresh_claims(const Dims& d, const In& in, const State& st, const Out& out,
                             const Smem& m, const Grp& g, int32_t& n_open, bool& overflow,
                             const Hook& hook, Shared& sh, float* s_debit) {
  const int tid = threadIdx.x, T = d.T, P = d.P, R = d.R, K = d.K, V1 = d.V1;
  const int NMAX = d.NMAX, JH = d.JH, G = d.G, NSLOT = V1 + 2, ANY = V1, DEAD = V1 + 1;
  if (tid == 0)
    for (int sl = 0; sl < NSLOT; ++sl) m.ddead[sl] = sl == DEAD;
  __syncthreads();
  while (!overflow) {
    int d_sel = 0;
    int32_t bq = 0;
    bool any = false;
    for (int sl = 0; sl < NSLOT; ++sl) {
      const int32_t q = m.ddead[sl] ? -1 : m.qrem[sl];
      any = any || q > 0;
      if (sl == 0 || q > bq) { bq = q; d_sel = sl; }
    }
    if (!any) break;
    const int32_t rem_d = m.qrem[d_sel];
    const bool pinned = g.dyn && d_sel != ANY;  // a domain-pinned bulk
    int32_t p_min = P;
    for (int i = tid; i < P * T; i += kThreads) {
      const int p = i / T, t = i % T;
      bool ok = in.type_ok[(static_cast<size_t>(p) * G + g.ti) * T + t];
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
    const int32_t* nf = in.n_fit + (static_cast<size_t>(p_star) * G + g.ti) * T;
    int32_t best = INT_MIN;
    for (int t = tid; t < T; t += kThreads) best = max(best, av[t] ? nf[t] : 0);
    const int32_t n_fit_max = block_max(best, sh);
    int32_t n_per = min(n_fit_max, g.hcap);
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
      for (int kk = 0; kk < K; ++kk) {
        st.c_def[s * K + kk] = m.gdef[kk];
        st.c_neg[s * K + kk] = m.gneg[kk];
      }
      // claims opened for a dynamic group are domain-pinned from birth
      for (int i = 0; i < K * V1; ++i)
        st.c_mask[static_cast<size_t>(s) * K * V1 + i] =
            m.gmask[i] && !(pinned && i / V1 == g.kid_sel && i % V1 != d_sel);
      if (pinned) (g.dkey == 0 ? out.c_dzone : out.c_dct)[s] = d_sel;
      for (int j = 0; j < JH; ++j)
        st.ch_cnt[s * JH + j] = (g.counted && j == g.jhc) ? take : 0;
      st.claim_fill[s] = wrap_add(st.claim_fill[s], take);
      hook.open(s, take, n_fit_max, d_pin);
      local = wrap_add(local, take);
    }
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
    }
    __syncthreads();
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
// mask row is single-valued, dtg_key choosing each slot's axis. Integer
// adds, exact in any order. Call after a barrier; ends in one.
__device__ void contrib_counts(const Dims& d, const In& in, const State& st, const Out& out,
                               const Smem& m, const Grp& g) {
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
  for (int s = tid; s < d.NMAX; s += kThreads) {
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

// The group's claim_fills row (from st.claim_fill) and its unplaced
// count. Call after a barrier; ends in one.
__device__ void group_outputs(const Dims& d, const State& st, const Out& out, const Grp& g,
                              int32_t placed_exist, Shared& sh) {
  int32_t local = 0;
  for (int s = threadIdx.x; s < d.NMAX; s += kThreads) {
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
