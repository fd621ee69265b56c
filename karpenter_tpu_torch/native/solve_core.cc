// Copied from karpenter_tpu/native/solve_core.cc.
// Native host solver core: the C++ twin of ops/solve.py::solve_core.
//
// Implements the same decision problem as the JAX kernel — fused feasibility
// tables (ops/feasibility.py) + grouped first-fit-decreasing packing
// (ops/packing.py) — over the identical dense snapshot arrays, with the same
// tie-breaking (greedy prefix fill over existing nodes, integer water-fill
// over open claims, highest-weight-template-first for new claims), and the
// same topology forms (per-entity hostname caps; per-step domain quotas for
// zone/capacity-type spread and affinity bootstrap). The reference's runtime
// is a compiled (Go) binary; this is the TPU build's native runtime path:
// used as the host fallback when no accelerator is attached, and as an
// independent implementation the JAX kernel is parity-tested against
// (tests/test_native.py).
//
// Scalar float math is done in float32 to match XLA's element types so the
// two implementations agree bit-for-bit on fits counts.
//
// The parity anchors below declare this twin's semantic skeleton —
// phases, shared constants, dtypes, tie-break disciplines, and the
// carried-state inventory — which karpenter_tpu/analysis/parity.py checks
// against the AST-derived skeletons of pack/pack_classed. When a semantic
// landmark moves here, move its anchor with it; when one is added to the
// JAX kernels, add the matching anchor or presubmit fails with PAR5xx.
//
// parity: dtype float32
// parity: dtype int32
// parity: dtype bool

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <limits>

namespace {

using std::int32_t;
using std::uint8_t;

constexpr float kInf = std::numeric_limits<float>::infinity();
// parity: const kBigFit = 2**30
constexpr int32_t kBigFit = 1 << 30;
// parity: const kBigDom = 2**28
constexpr int32_t kBigDom = 1 << 28;  // "unbounded" domain capacity (_BIGI)

// fits_count (ops/feasibility.py:68-80): identical float32 semantics,
// including the division epsilon.
// parity: const 1e-9
inline int32_t fits_count(const float* alloc, const float* base, const float* req,
                          int R) {
  bool ok_zero = true;
  float n = kInf;
  for (int r = 0; r < R; ++r) {
    float headroom = alloc[r] - base[r];
    if (!(req[r] > 0.0f) && !(headroom >= 0.0f)) ok_zero = false;
    float per = (req[r] > 0.0f)
                    ? std::floor(headroom / std::max(req[r], 1e-9f))
                    : kInf;
    n = std::min(n, per);
  }
  if (std::isinf(n)) n = static_cast<float>(kBigFit);
  if (!ok_zero) return 0;
  return static_cast<int32_t>(std::max(n, 0.0f));
}

struct Dims {
  int G, T, P, N, R, K, V1, O, NMAX, zone_kid, ct_kid;
};

// Type t has an available offering in domain slot d of the constrained axis
// (dkey 0 = zone-major of a_tzc, 1 = capacity-type) under `other` on the
// other axis. Callers separately require the constrained-axis mask to admit
// d (the JAX kernel's toff = einsum(other) ∧ dom-row).
inline bool off_in_domain(const uint8_t* az /* [V1, V1] */, int dkey, int d,
                          const uint8_t* other, int V1) {
  if (dkey == 0) {
    for (int c = 0; c < V1; ++c)
      if (az[d * V1 + c] && other[c]) return true;
  } else {
    for (int z = 0; z < V1; ++z)
      if (az[z * V1 + d] && other[z]) return true;
  }
  return false;
}

// greedy_prefix_fill (ops/packing.py): the running `before` total is the
// exclusive prefix sum — slot priority order is the tie rule.
// parity: tiebreak cumsum
inline void greedy_prefix_fill(const std::vector<int32_t>& cap, int32_t n,
                               std::vector<int32_t>& fill) {
  int32_t before = 0;
  for (size_t i = 0; i < cap.size(); ++i) {
    int32_t f = n - before;
    if (f < 0) f = 0;
    if (f > cap[i]) f = cap[i];
    fill[i] = f;
    before += cap[i];
  }
}

// waterfill (ops/packing.py): identical level/deficit semantics — the
// deficit layer hands out by slot index, exactly argmin's tie rule.
// parity: tiebreak argmin
inline void waterfill(const std::vector<int32_t>& npods,
                      const std::vector<int32_t>& cap, int32_t n,
                      std::vector<int32_t>& fills) {
  int64_t total_cap = 0;
  for (int32_t c : cap) total_cap += c;
  if (n > total_cap) n = static_cast<int32_t>(total_cap);
  auto f = [&](int64_t level) {
    int64_t s = 0;
    for (size_t i = 0; i < cap.size(); ++i) {
      int64_t v = level - npods[i];
      if (v < 0) v = 0;
      if (v > cap[i]) v = cap[i];
      s += v;
    }
    return s;
  };
  int64_t hi = 1;
  for (size_t i = 0; i < cap.size(); ++i)
    hi = std::max<int64_t>(hi, static_cast<int64_t>(npods[i]) + cap[i] + 1);
  int64_t lo = 0;
  while (lo + 1 < hi) {  // smallest level with f(level) >= n
    int64_t mid = (lo + hi) / 2;
    if (f(mid) >= n)
      hi = mid;
    else
      lo = mid;
  }
  int64_t level = (f(0) >= n) ? 0 : hi;
  int64_t deficit = n;
  std::vector<uint8_t> elig(cap.size(), 0);
  for (size_t i = 0; i < cap.size(); ++i) {
    int64_t base = (level - 1) - npods[i];
    if (base < 0) base = 0;
    if (base > cap[i]) base = cap[i];
    fills[i] = static_cast<int32_t>(base);
    deficit -= base;
    elig[i] = (base < cap[i]) && (npods[i] <= level - 1);
  }
  int64_t rank = 0;
  for (size_t i = 0; i < cap.size(); ++i) {
    if (elig[i]) {
      ++rank;
      if (rank <= deficit) fills[i] += 1;
    }
  }
}

// minvalues_cap (ops/packing.py): largest fill k keeping every minValues
// floor satisfied after the fill narrows options to {t : mask && fit >= k}.
// For key j / catalog value w, f_w = max fit over masked types offering w;
// the floor_j-th largest f_w (descending order statistic) is the cap for
// that key; the result is the min over constrained keys. Identical
// semantics to the JAX twin's sorted take_along_axis.
inline int32_t minvalues_cap_one(const uint8_t* tmask, const int32_t* fit,
                                 const int32_t* floors, const uint8_t* t_mvoh,
                                 int T, int MV, int MW) {
  int32_t cap = kBigDom;
  std::vector<int32_t> f(MW);
  for (int j = 0; j < MV; ++j) {
    const int32_t need = floors[j];
    if (need <= 0) continue;
    if (need > MW) return 0;  // floors beyond the catalog's value count
    std::fill(f.begin(), f.end(), 0);
    for (int t = 0; t < T; ++t) {
      if (!tmask[t] || fit[t] <= 0) continue;
      const uint8_t* row = t_mvoh + (static_cast<size_t>(t) * MV + j) * MW;
      for (int w = 0; w < MW; ++w)
        if (row[w]) f[w] = std::max(f[w], fit[t]);
    }
    std::nth_element(f.begin(), f.begin() + (need - 1), f.end(),
                     std::greater<int32_t>());
    cap = std::min(cap, f[need - 1]);
  }
  return cap;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 when NMAX overflowed (caller doubles and retries,
// matching the JAX driver's overflow loop).
int kt_solve(
    // dims
    int G, int T, int P, int N, int R, int K, int V1, int O, int NMAX,
    int zone_kid, int ct_kid, int JH, int JD, int NRES, int MV, int MW,
    // groups (FFD order)
    const int32_t* g_count, const float* g_req, const uint8_t* g_def,
    const uint8_t* g_neg, const uint8_t* g_mask,
    const int32_t* g_hcap,  // [G] per-entity hostname-topology cap
    const uint8_t* g_haff,  // [G] hostname-affinity: whole group on 1 entity
    // domain-keyed constraint descriptors (ops/packing.py DMODE_*)
    const int32_t* g_dmode, const int32_t* g_dkey, const int32_t* g_dskew,
    const uint8_t* g_dmin0,
    const int32_t* g_dprior,  // [G, V1]
    const uint8_t* g_dreg,    // [G, V1]
    const int32_t* g_drank,   // [G, V1]
    // shared-constraint slots + caps
    const int32_t* g_hstg, const int32_t* g_hscap, const int32_t* g_dtg,
    // shared-constraint roles: g_hself[G] (cap vs gate), contribution rows
    // g_hcontrib[G,JH] / g_dcontrib[G,JD] (the oracle's record() rule)
    const uint8_t* g_hself, const uint8_t* g_hcontrib,
    const uint8_t* g_dcontrib,
    // templates
    const uint8_t* p_def, const uint8_t* p_neg, const uint8_t* p_mask,
    const float* p_daemon, const float* p_limit, const uint8_t* p_has_limit,
    const uint8_t* p_tol, const uint8_t* p_titype_ok,
    // instance types
    const uint8_t* t_def, const uint8_t* t_mask, const float* t_alloc,
    const float* t_cap,
    // offerings
    const uint8_t* o_avail, const int32_t* o_zone, const int32_t* o_ct,
    const uint8_t* a_tzc,   // [T, V1, V1] (reserved offerings excluded
                            // when the reservation ledger is active)
    const int32_t* res_cap0,  // [NRES] reservation capacities
    const uint8_t* a_res,     // [NRES, T, V1, V1] per-reservation availability
    // existing nodes
    const uint8_t* n_def, const uint8_t* n_mask, const float* n_avail,
    const float* n_base, const uint8_t* n_tol,
    const int32_t* n_hcnt,  // [N, G] prior selected-pod counts
    const int32_t* n_dzone, const int32_t* n_dct,  // [N] domain value ids
    const int32_t* nh_cnt0,  // [N, JH] shared hostname-constraint priors
    const int32_t* dd0,      // [JD, V1] shared domain carry init
    const int32_t* dtg_key,  // [JD] shared domain-constraint axis (0=zone)
    const uint8_t* well_known,
    const int32_t* p_mvmin,  // [P, MV] per-template minValues floors
    const uint8_t* t_mvoh,   // [T, MV, MW] per-type catalog-value one-hots
    // outputs
    int32_t* out_c_pool,      // [NMAX]
    uint8_t* out_c_tmask,     // [NMAX, T]
    int32_t* out_n_open,      // [1]
    uint8_t* out_overflow,    // [1]
    int32_t* out_exist_fills, // [G, N]
    int32_t* out_claim_fills, // [G, NMAX]
    int32_t* out_unplaced,    // [G]
    int32_t* out_c_dzone,     // [NMAX] pinned zone value id (-1 = unpinned)
    int32_t* out_c_dct,       // [NMAX] pinned capacity-type value id
    uint8_t* out_c_resv       // [NMAX] claim holds its reservations
) {
  const int KV = K * V1;
  const int NSLOT = V1 + 2;  // V1 domains + ANY + DEAD
  const int ANY = V1, DEAD = V1 + 1;

  // ---- feasibility tables (ops/feasibility.py) ------------------------
  // compat_pg [P,G], type_ok_pgt [P,G,T], n_fit_pgt [P,G,T]
  //
  // Sparse/segment mirror of fresh_claim_feasibility_sparse: a (group,
  // key) pair is *live* when its requirement row differs from the neutral
  // (undefined, non-negated, all-true) row — the same live set the
  // encoder's compacted nonzero-mask index (encode.build_segment_index)
  // names for the JAX twins. Neutral rows collapse every intersect term
  // to the group-independent template-vs-type base, so the base is
  // hoisted out of the G loop and each group touches only its live keys;
  // cost scales with live pairs instead of G x K x V1.
  std::vector<uint8_t> compat_pg(P * G);
  std::vector<uint8_t> type_ok_pgt(static_cast<size_t>(P) * G * T);
  std::vector<int32_t> n_fit_pgt(static_cast<size_t>(P) * G * T);

  // live (group, key) pairs, CSR-style per group
  std::vector<int32_t> live_start(G + 1, 0);
  std::vector<int32_t> live_key;
  live_key.reserve(G);
  for (int g = 0; g < G; ++g) {
    for (int k = 0; k < K; ++k) {
      bool neutral = !g_def[g * K + k] && !g_neg[g * K + k];
      if (neutral) {
        const uint8_t* gm = g_mask + g * KV + k * V1;
        for (int v = 0; v < V1 && neutral; ++v) neutral = gm[v];
      }
      if (!neutral) live_key.push_back(k);
    }
    live_start[g + 1] = static_cast<int32_t>(live_key.size());
  }

  // hoisted per-(p,t,k) base term + per-(p,t) failure totals
  // base_ok = any_v(t_mask & p_mask) | !(t_def & p_def)
  std::vector<uint8_t> base_fail_ptk(static_cast<size_t>(P) * T * K);
  std::vector<int32_t> base_total_pt(static_cast<size_t>(P) * T, 0);
  std::vector<uint8_t> off_base_pt(static_cast<size_t>(P) * T);
  for (int p = 0; p < P; ++p) {
    for (int t = 0; t < T; ++t) {
      int32_t total = 0;
      for (int k = 0; k < K; ++k) {
        bool overlap = false;
        const uint8_t* tm = t_mask + t * KV + k * V1;
        const uint8_t* pm = p_mask + p * KV + k * V1;
        for (int v = 0; v < V1 && !overlap; ++v) overlap = tm[v] && pm[v];
        bool ok = overlap || !(t_def[t * K + k] && p_def[p * K + k]);
        base_fail_ptk[(static_cast<size_t>(p) * T + t) * K + k] = !ok;
        total += !ok;
      }
      base_total_pt[static_cast<size_t>(p) * T + t] = total;
      // template-only offering base (neutral zone/ct rows leave the
      // merged mask equal to the template's)
      bool off = false;
      const uint8_t* pzm = p_mask + p * KV + zone_kid * V1;
      const uint8_t* pcm = p_mask + p * KV + ct_kid * V1;
      for (int o = 0; o < O && !off; ++o) {
        if (!o_avail[t * O + o]) continue;
        int32_t z = o_zone[t * O + o], c = o_ct[t * O + o];
        off = ((z < 0) || pzm[z]) && ((c < 0) || pcm[c]);
      }
      off_base_pt[static_cast<size_t>(p) * T + t] = off;
    }
  }

  for (int p = 0; p < P; ++p) {
    for (int g = 0; g < G; ++g) {
      int32_t ls = live_start[g], le = live_start[g + 1];
      // pod-vs-template compatibility: neutral keys are vacuous for both
      // the intersect term and the custom-label allowance
      bool compat = p_tol[p * G + g];
      for (int32_t l = ls; l < le && compat; ++l) {
        int k = live_key[l];
        bool overlap = false;
        const uint8_t* pm = p_mask + p * KV + k * V1;
        const uint8_t* gm = g_mask + g * KV + k * V1;
        for (int v = 0; v < V1 && !overlap; ++v) overlap = pm[v] && gm[v];
        bool exempt = p_neg[p * K + k] && g_neg[g * K + k];
        bool both = p_def[p * K + k] && g_def[g * K + k];
        bool custom = !g_def[g * K + k] || well_known[k] ||
                      p_def[p * K + k] || g_neg[g * K + k];
        compat = (overlap || exempt || !both) && custom;
      }
      compat_pg[p * G + g] = compat;
      // merged zone/ct offering rows only differ when those rows are live
      bool zc_live = false;
      for (int32_t l = ls; l < le && !zc_live; ++l)
        zc_live = live_key[l] == zone_kid || live_key[l] == ct_kid;
      for (int t = 0; t < T; ++t) {
        size_t idx = (static_cast<size_t>(p) * G + g) * T + t;
        int32_t nf = fits_count(t_alloc + t * R, p_daemon + p * R,
                                g_req + g * R, R);
        n_fit_pgt[idx] = nf;
        // type intersect: hoisted base failures +/- live-pair corrections
        int32_t fail = base_total_pt[static_cast<size_t>(p) * T + t];
        for (int32_t l = ls; l < le; ++l) {
          int k = live_key[l];
          bool overlap3 = false;
          const uint8_t* tm = t_mask + t * KV + k * V1;
          const uint8_t* pm = p_mask + p * KV + k * V1;
          const uint8_t* gm = g_mask + g * KV + k * V1;
          for (int v = 0; v < V1 && !overlap3; ++v)
            overlap3 = tm[v] && pm[v] && gm[v];
          bool cdef = p_def[p * K + k] || g_def[g * K + k];
          bool pair_ok = overlap3 || !(t_def[t * K + k] && cdef);
          fail += static_cast<int32_t>(!pair_ok) -
                  base_fail_ptk[(static_cast<size_t>(p) * T + t) * K + k];
        }
        bool tc = fail == 0;
        bool off;
        if (zc_live) {
          off = false;
          const uint8_t* pzm = p_mask + p * KV + zone_kid * V1;
          const uint8_t* pcm = p_mask + p * KV + ct_kid * V1;
          const uint8_t* gzm = g_mask + g * KV + zone_kid * V1;
          const uint8_t* gcm = g_mask + g * KV + ct_kid * V1;
          for (int o = 0; o < O && !off; ++o) {
            if (!o_avail[t * O + o]) continue;
            int32_t z = o_zone[t * O + o], c = o_ct[t * O + o];
            off = ((z < 0) || (pzm[z] && gzm[z])) &&
                  ((c < 0) || (pcm[c] && gcm[c]));
          }
        } else {
          off = off_base_pt[static_cast<size_t>(p) * T + t];
        }
        type_ok_pgt[idx] = tc && off && (nf >= 1) &&
                           p_titype_ok[p * T + t] && compat;
      }
    }
  }

  // cap_ng [N, G] (existing_node_feasibility; strict compatibility —
  // same live-pair contraction: neutral keys are vacuous node-side too)
  std::vector<int32_t> cap_ng(static_cast<size_t>(N) * G, 0);
  for (int n = 0; n < N; ++n) {
    for (int g = 0; g < G; ++g) {
      if (!n_tol[n * G + g]) continue;
      bool compat = true;
      for (int32_t l = live_start[g]; l < live_start[g + 1] && compat; ++l) {
        int k = live_key[l];
        bool overlap = false;
        const uint8_t* nm = n_mask + n * KV + k * V1;
        const uint8_t* gm = g_mask + g * KV + k * V1;
        for (int v = 0; v < V1 && !overlap; ++v) overlap = nm[v] && gm[v];
        bool both = n_def[n * K + k] && g_def[g * K + k];
        bool custom = !g_def[g * K + k] || n_def[n * K + k] ||
                      g_neg[g * K + k];
        compat = (overlap || !both) && custom;
      }
      if (!compat) continue;
      cap_ng[static_cast<size_t>(n) * G + g] =
          fits_count(n_avail + n * R, n_base + n * R, g_req + g * R, R);
    }
  }

  // ---- pack state ------------------------------------------------------
  // the carried-state inventory, one variable per PackState field
  // parity: state exist_used, c_used, c_npods, c_active, c_pool, c_tmask
  // parity: state c_def, c_neg, c_mask, c_dzone, c_dct
  // parity: state ch_cnt, nhc, ddc, res_rem, c_resv
  // parity: state pool_rem, n_open, overflow
  std::vector<float> exist_used(n_base, n_base + static_cast<size_t>(N) * R);
  std::vector<float> c_used(static_cast<size_t>(NMAX) * R, 0.0f);
  std::vector<int32_t> c_npods(NMAX, 0);
  std::vector<uint8_t> c_active(NMAX, 0);
  std::vector<int32_t> c_pool(NMAX, 0);
  std::vector<uint8_t> c_tmask(static_cast<size_t>(NMAX) * T, 0);
  std::vector<uint8_t> c_def(static_cast<size_t>(NMAX) * K, 0);
  std::vector<uint8_t> c_neg(static_cast<size_t>(NMAX) * K, 0);
  std::vector<uint8_t> c_mask(static_cast<size_t>(NMAX) * KV, 1);
  std::vector<int32_t> c_dzone(NMAX, -1), c_dct(NMAX, -1);
  // shared-constraint carries (counts accumulate across groups)
  std::vector<int32_t> ch_cnt(static_cast<size_t>(NMAX) * JH, 0);
  std::vector<int32_t> nhc(nh_cnt0, nh_cnt0 + static_cast<size_t>(N) * JH);
  std::vector<int32_t> ddc(dd0, dd0 + static_cast<size_t>(JD) * V1);
  // reservation ledger (reservationmanager.go:28-85): availability views
  // for unheld placements (a_step: live reservations only) and for claims
  // already holding reservations (a_held: all reservations)
  const size_t a_sz = static_cast<size_t>(T) * V1 * V1;
  std::vector<int32_t> res_rem(res_cap0, res_cap0 + NRES);
  std::vector<uint8_t> c_resv(NMAX, 0);
  std::vector<uint8_t> a_step(a_tzc, a_tzc + a_sz);
  std::vector<uint8_t> a_held(a_tzc, a_tzc + a_sz);
  auto refresh_a_step = [&]() {
    std::copy(a_tzc, a_tzc + a_sz, a_step.begin());
    for (int r = 0; r < NRES; ++r) {
      if (res_rem[r] <= 0) continue;
      const uint8_t* ar = a_res + static_cast<size_t>(r) * a_sz;
      for (size_t i = 0; i < a_sz; ++i) a_step[i] |= ar[i];
    }
  };
  refresh_a_step();
  for (int r = 0; r < NRES; ++r) {
    const uint8_t* ar = a_res + static_cast<size_t>(r) * a_sz;
    for (size_t i = 0; i < a_sz; ++i) a_held[i] |= ar[i];
  }
  auto a_for_claim = [&](int s) -> const uint8_t* {
    return (NRES && c_resv[s]) ? a_held.data() : a_step.data();
  };
  std::vector<float> pool_rem(p_limit, p_limit + static_cast<size_t>(P) * R);
  int32_t n_open = 0;
  bool overflow = false;

  std::memset(out_exist_fills, 0, sizeof(int32_t) * G * N);
  std::memset(out_claim_fills, 0, sizeof(int32_t) * G * NMAX);
  std::memset(out_unplaced, 0, sizeof(int32_t) * G);

  std::vector<int32_t> exist_cap(N), exist_fill(N);
  std::vector<int32_t> claim_cap(NMAX), claim_fill(NMAX);
  std::vector<int32_t> c_slot(NMAX);
  std::vector<int32_t> qd(NSLOT), qrem(NSLOT);
  std::vector<int32_t> wf_npods(NMAX), wf_cap(NMAX), wf_fill(NMAX);
  std::vector<uint8_t> other_row(V1);
  // batch-level domain presence (the JAX kernels' has_domains static):
  // gates the tier-3 balanced-bulk-birth rule below
  bool has_domains = false;
  for (int g = 0; g < G; ++g)
    if (g_dmode[g] > 0) {
      has_domains = true;
      break;
    }

  for (int gi = 0; gi < G; ++gi) {
    int32_t count = g_count[gi];
    const float* req = g_req + gi * R;
    const uint8_t* gdef = g_def + gi * K;
    const uint8_t* gneg = g_neg + gi * K;
    const uint8_t* gmask = g_mask + gi * KV;

    // hostname-topology per-entity cap (see ops/packing.py step): spread's
    // skew bound collapses to "<= maxSkew selected pods per node/claim"
    // because hostname domains have a global min of 0.
    const int32_t hc = g_hcap[gi];
    // hostname-affinity single-entity pin (topologygroup.go:277-324
    // hostname case); n_hcnt rows hold the matching-pod priors for these
    // groups (the cap combo is demoted at encode time)
    const bool haff = g_haff[gi];

    // domain-keyed constraint descriptors
    const int32_t mode = g_dmode[gi];
    const bool dyn = mode > 0;
    const int dkey = g_dkey[gi];
    const int kid_sel = (dkey == 0) ? zone_kid : ct_kid;
    const int other_kid = (dkey == 0) ? ct_kid : zone_kid;
    const int32_t skew = g_dskew[gi];
    const bool min0 = g_dmin0[gi];
    const uint8_t* reg = g_dreg + static_cast<size_t>(gi) * V1;
    const int32_t* drank = g_drank + static_cast<size_t>(gi) * V1;
    // shared constraints: counts from the carries. Self owners (hself) are
    // capped at scap_h minus the entity's count and counted; gate owners
    // are blocked where the count exceeds the threshold, never counted.
    const int32_t jh = g_hstg[gi];
    const bool has_h = jh >= 0;
    const bool hself = has_h && g_hself[gi];
    const int32_t scap_h = g_hscap[gi];
    auto h_allow = [&](int32_t cnt) -> int32_t {
      if (!has_h) return kBigFit;
      if (hself) return std::max(scap_h - cnt, 0);
      return (cnt > scap_h) ? 0 : kBigFit;
    };
    const int32_t jd = g_dtg[gi];
    const bool has_d = jd >= 0;
    std::vector<int32_t> D0v(V1);
    for (int v = 0; v < V1; ++v)
      D0v[v] = g_dprior[static_cast<size_t>(gi) * V1 + v] +
               (has_d ? ddc[static_cast<size_t>(jd) * V1 + v] : 0);
    const int32_t* D0 = D0v.data();

    // parity: phase min-values
    // dense minValues: per-claim cap on this step's joins so the narrowed
    // option set keeps every constrained key's distinct-value floor
    // satisfied (the oracle's per-Add SatisfiesMinValues recount). Mirrors
    // ops/packing.py's cap_mv over tm = c_tmask ∧ type_ok ∧ off ∧ fits.
    std::vector<int32_t> cap_mv(MV ? NMAX : 0, kBigDom);
    if (MV) {
      std::vector<uint8_t> mv_mask(T);
      std::vector<int32_t> mv_fit(T);
      for (int s = 0; s < NMAX; ++s) {
        if (!c_active[s]) continue;
        const int pp = c_pool[s];
        const int32_t* floors = p_mvmin + static_cast<size_t>(pp) * MV;
        bool any_floor = false;
        for (int j = 0; j < MV; ++j) any_floor = any_floor || floors[j] > 0;
        if (!any_floor) continue;
        const uint8_t* sm = c_mask.data() + static_cast<size_t>(s) * KV;
        for (int t = 0; t < T; ++t) {
          mv_mask[t] = 0;
          mv_fit[t] = 0;
          if (!c_tmask[static_cast<size_t>(s) * T + t]) continue;
          if (!type_ok_pgt[(static_cast<size_t>(pp) * G + gi) * T + t])
            continue;
          int32_t add = fits_count(
              t_alloc + t * R, c_used.data() + static_cast<size_t>(s) * R,
              req, R);
          if (add < 1) continue;
          bool off = false;
          const uint8_t* az =
              a_for_claim(s) + static_cast<size_t>(t) * V1 * V1;
          for (int z = 0; z < V1 && !off; ++z) {
            if (!(sm[zone_kid * V1 + z] && gmask[zone_kid * V1 + z]))
              continue;
            for (int c = 0; c < V1; ++c)
              if (az[z * V1 + c] && sm[ct_kid * V1 + c] &&
                  gmask[ct_kid * V1 + c]) {
                off = true;
                break;
              }
          }
          if (!off) continue;
          mv_mask[t] = 1;
          mv_fit[t] = add;
        }
        cap_mv[s] = minvalues_cap_one(mv_mask.data(), mv_fit.data(), floors,
                                      t_mvoh, T, MV, MW);
      }
    }

    // parity: phase existing-nodes
    // ---- 1. existing nodes, fixed priority order ----
    for (int n = 0; n < N; ++n) {
      exist_cap[n] =
          (cap_ng[static_cast<size_t>(n) * G + gi] > 0)
              ? fits_count(n_avail + n * R, exist_used.data() + n * R, req, R)
              : 0;
      exist_cap[n] = std::min(
          exist_cap[n],
          std::max(hc - n_hcnt[static_cast<size_t>(n) * G + gi], 0));
      if (has_h)
        exist_cap[n] = std::min(
            exist_cap[n], h_allow(nhc[static_cast<size_t>(n) * JH + jh]));
    }
    bool haff_exist_served = false;
    if (haff && N) {
      bool has_prior = false;
      for (int n = 0; n < N; ++n)
        if (n_hcnt[static_cast<size_t>(n) * G + gi] > 0) {
          has_prior = true;
          break;
        }
      if (has_prior) {
        // candidates are exactly the prior-holding nodes (nonempty domains)
        for (int n = 0; n < N; ++n)
          if (n_hcnt[static_cast<size_t>(n) * G + gi] <= 0) exist_cap[n] = 0;
        haff_exist_served = true;
      } else {
        // bootstrap: the first node with capacity hosts everyone
        int first_free = -1;
        for (int n = 0; n < N; ++n)
          if (exist_cap[n] >= 1) {
            first_free = n;
            break;
          }
        for (int n = 0; n < N; ++n)
          if (n != first_free) exist_cap[n] = 0;
        haff_exist_served = first_free >= 0;
      }
    }

    // node domain slot on the constrained axis
    std::vector<int32_t> nd_slot(N, ANY);
    if (dyn) {
      for (int n = 0; n < N; ++n) {
        int32_t d = (dkey == 0) ? n_dzone[n] : n_dct[n];
        nd_slot[n] = (d >= 0 && d < V1 && reg[d]) ? d : DEAD;
      }
    }

    // ---- domain quota qd[NSLOT] (ops/packing.py step) ------------------
    std::fill(qd.begin(), qd.end(), 0);
    if (!dyn) {
      qd[ANY] = count;
    } else {
      std::vector<int32_t> czcap(V1, 0);
      for (int n = 0; n < N; ++n)
        if (nd_slot[n] < V1) czcap[nd_slot[n]] += exist_cap[n];
      // fresh_ok_d: any (template, type) feasible with an offering in d,
      // under the template∪group masks on both axes
      std::vector<uint8_t> fresh_ok(V1, 0);
      for (int p = 0; p < P; ++p) {
        const uint8_t* pm = p_mask + static_cast<size_t>(p) * KV;
        for (int v = 0; v < V1; ++v)
          other_row[v] = pm[other_kid * V1 + v] && gmask[other_kid * V1 + v];
        for (int t = 0; t < T; ++t) {
          if (!type_ok_pgt[(static_cast<size_t>(p) * G + gi) * T + t]) continue;
          const uint8_t* az = a_step.data() + static_cast<size_t>(t) * V1 * V1;
          for (int d = 0; d < V1; ++d) {
            if (fresh_ok[d]) continue;
            if (!(pm[kid_sel * V1 + d] && gmask[kid_sel * V1 + d])) continue;
            if (off_in_domain(az, dkey, d, other_row.data(), V1))
              fresh_ok[d] = 1;
          }
        }
      }
      std::vector<int32_t> realcap(V1);
      for (int d = 0; d < V1; ++d)
        realcap[d] =
            std::min<int32_t>(czcap[d] + (fresh_ok[d] ? kBigDom : 0), kBigDom);
      if (mode == 3 || mode == 4) {
        // GATE modes (DMODE_GATE_SPREAD / DMODE_GATE_AFF): the group is
        // constrained by the carry-evolved counts but never moves them.
        // gate-spread admits domains within skew of the STATIC min
        // (topologygroup.go:233-244 with selects=false); gate-affinity
        // admits currently nonempty domains (:277-290). Capacity within a
        // domain is unbounded, so the per-domain cap is just feasibility.
        int32_t mstat = kBigDom;
        for (int d = 0; d < V1; ++d)
          if (reg[d]) mstat = std::min(mstat, D0[d]);
        if (min0) mstat = 0;
        std::vector<int32_t> npods(V1), scap(V1);
        for (int d = 0; d < V1; ++d) {
          npods[d] = reg[d] ? D0[d] : kBigDom;
          bool allowed =
              reg[d] && (mode == 3 ? (D0[d] - mstat <= skew) : (D0[d] > 0));
          scap[d] = allowed ? std::min(realcap[d], count) : 0;
        }
        std::vector<int32_t> qfill(V1);
        waterfill(npods, scap, count, qfill);
        for (int d = 0; d < V1; ++d) qd[d] = qfill[d];
      } else if (mode == 1 /* DMODE_SPREAD */) {
        // L* = maxSkew + min over registered domains of (D0 + cap): the
        // closed form of sequential min-count-within-maxSkew selection
        // (topologygroup.go:205-251); minDomains pins the min to 0
        int32_t mfloor = kBigDom;
        for (int d = 0; d < V1; ++d)
          if (reg[d]) mfloor = std::min(mfloor, D0[d] + realcap[d]);
        if (min0) mfloor = 0;
        int64_t lstar = static_cast<int64_t>(skew) + mfloor;
        std::vector<int32_t> npods(V1), scap(V1);
        for (int d = 0; d < V1; ++d) {
          npods[d] = reg[d] ? D0[d] : kBigDom;
          int64_t c = reg[d] ? std::max<int64_t>(lstar - D0[d], 0) : 0;
          scap[d] = static_cast<int32_t>(
              std::min<int64_t>(c, realcap[d]));
        }
        std::vector<int32_t> qfill(V1);
        waterfill(npods, scap, count, qfill);
        for (int d = 0; d < V1; ++d) qd[d] = qfill[d];
      } else {  // DMODE_AFFINITY: bootstrap pins the group to one domain;
        // with a shared carry, a nonempty domain binds every follower
        int32_t d_aff = -1;
        int32_t best_follow = kBigDom;
        for (int d = 0; d < V1; ++d)
          if (D0[d] > 0 && reg[d] && drank[d] < best_follow) {
            best_follow = drank[d];
            d_aff = d;
          }
        for (int n = 0; n < N && d_aff < 0; ++n)
          if (exist_cap[n] >= 1 && nd_slot[n] < V1) d_aff = nd_slot[n];
        if (d_aff < 0) {
          // claim anchor (mirrors ops/packing.py): the oracle's bootstrap
          // pod walks open claims least-loaded-first before opening
          // fresh, so the least-loaded eligible PINNED claim's domain
          // binds the family
          int32_t best_load = kBigDom;
          for (int s = 0; s < NMAX; ++s) {
            if (!c_active[s]) continue;
            int32_t pin = (dkey == 0) ? c_dzone[s] : c_dct[s];
            if (pin < 0) continue;
            if (c_npods[s] >= best_load) continue;
            if (hc < 1) continue;
            if (has_h &&
                h_allow(ch_cnt[static_cast<size_t>(s) * JH + jh]) < 1)
              continue;
            const uint8_t* sm = c_mask.data() + static_cast<size_t>(s) * KV;
            const uint8_t* sd = c_def.data() + static_cast<size_t>(s) * K;
            const uint8_t* sn = c_neg.data() + static_cast<size_t>(s) * K;
            bool compat = true;
            for (int k = 0; k < K && compat; ++k) {
              bool overlap = false;
              for (int v = 0; v < V1; ++v)
                if (sm[k * V1 + v] && gmask[k * V1 + v]) {
                  overlap = true;
                  break;
                }
              bool exempt = sn[k] && gneg[k];
              if (!(overlap || exempt || !(sd[k] && gdef[k]))) compat = false;
              if (gdef[k] && !well_known[k] && !sd[k] && !gneg[k])
                compat = false;
            }
            int pp = c_pool[s];
            compat = compat && p_tol[pp * G + gi] && compat_pg[pp * G + gi];
            if (!compat) continue;
            bool fits1 = false;
            for (int t = 0; t < T && !fits1; ++t) {
              if (!c_tmask[static_cast<size_t>(s) * T + t]) continue;
              if (!type_ok_pgt[(static_cast<size_t>(pp) * G + gi) * T + t])
                continue;
              if (fits_count(t_alloc + t * R,
                             c_used.data() + static_cast<size_t>(s) * R, req,
                             R) < 1)
                continue;
              const uint8_t* azt =
                  a_for_claim(s) + static_cast<size_t>(t) * V1 * V1;
              for (int z = 0; z < V1 && !fits1; ++z) {
                if (!(sm[zone_kid * V1 + z] && gmask[zone_kid * V1 + z]))
                  continue;
                for (int c = 0; c < V1; ++c)
                  if (azt[z * V1 + c] && sm[ct_kid * V1 + c] &&
                      gmask[ct_kid * V1 + c]) {
                    fits1 = true;
                    break;
                  }
              }
            }
            if (!fits1) continue;
            best_load = c_npods[s];
            d_aff = pin;
          }
        }
        if (d_aff < 0) {
          int32_t best_rank = kBigDom;
          for (int d = 0; d < V1; ++d)
            if (fresh_ok[d] && reg[d] && drank[d] < best_rank) {
              best_rank = drank[d];
              d_aff = d;
            }
        }
        if (d_aff >= 0) qd[d_aff] = count;
      }
    }
    std::copy(qd.begin(), qd.end(), qrem.begin());

    // tier-1 fill under per-domain budgets (prefix order within each slot)
    {
      std::vector<int32_t> placed(NSLOT, 0);
      for (int n = 0; n < N; ++n) {
        int32_t f = qd[nd_slot[n]] - placed[nd_slot[n]];
        if (f < 0) f = 0;
        if (f > exist_cap[n]) f = exist_cap[n];
        exist_fill[n] = f;
        placed[nd_slot[n]] += f;
      }
      for (int n = 0; n < N; ++n) {
        if (exist_fill[n] > 0) {
          for (int r = 0; r < R; ++r)
            exist_used[static_cast<size_t>(n) * R + r] += exist_fill[n] * req[r];
          out_exist_fills[static_cast<size_t>(gi) * N + n] = exist_fill[n];
          qrem[nd_slot[n]] -= exist_fill[n];
          if (hself) nhc[static_cast<size_t>(n) * JH + jh] += exist_fill[n];
        }
      }
    }
    // a served existing-entity pin absorbs what fits; the remainder of a
    // hostname-affinity group errors rather than spilling to claims
    if (haff && haff_exist_served) std::fill(qrem.begin(), qrem.end(), 0);

    // parity: phase open-claims
    // ---- 2. open claims, least-loaded first ----
    std::vector<uint8_t> got(NMAX, 0);
    std::vector<int32_t> percap_d(dyn ? static_cast<size_t>(NMAX) * V1 : 0, 0);
    std::vector<uint8_t> adm_any(dyn ? NMAX : 0, 0);
    for (int s = 0; s < NMAX; ++s) {
      claim_cap[s] = 0;
      claim_fill[s] = 0;
      c_slot[s] = dyn ? DEAD : ANY;
      if (!c_active[s]) continue;
      // claim-vs-group key compatibility (overlap | exempt | not both
      // defined) + custom-label rule + template tolerance/compat
      bool compat = true;
      const uint8_t* sm = c_mask.data() + static_cast<size_t>(s) * KV;
      const uint8_t* sd = c_def.data() + static_cast<size_t>(s) * K;
      const uint8_t* sn = c_neg.data() + static_cast<size_t>(s) * K;
      for (int k = 0; k < K && compat; ++k) {
        bool overlap = false;
        for (int v = 0; v < V1; ++v)
          if (sm[k * V1 + v] && gmask[k * V1 + v]) {
            overlap = true;
            break;
          }
        bool exempt = sn[k] && gneg[k];
        if (!(overlap || exempt || !(sd[k] && gdef[k]))) compat = false;
        if (gdef[k] && !well_known[k] && !sd[k] && !gneg[k]) compat = false;
      }
      int pp = c_pool[s];
      compat = compat && p_tol[pp * G + gi] && compat_pg[pp * G + gi];
      if (!compat) continue;
      // per-type: options ∧ template-group table ∧ fits under load ∧
      // offering under merged masks (per admissible domain when dynamic)
      for (int v = 0; v < V1; ++v)
        other_row[v] = sm[other_kid * V1 + v] && gmask[other_kid * V1 + v];
      int32_t best = 0;
      for (int t = 0; t < T; ++t) {
        if (!c_tmask[static_cast<size_t>(s) * T + t]) continue;
        if (!type_ok_pgt[(static_cast<size_t>(pp) * G + gi) * T + t]) continue;
        int32_t add = fits_count(t_alloc + t * R,
                                 c_used.data() + static_cast<size_t>(s) * R,
                                 req, R);
        if (add < 1) continue;
        // offering over merged zone/ct masks via the ledger-aware view
        bool off = false;
        const uint8_t* az = a_for_claim(s) + static_cast<size_t>(t) * V1 * V1;
        for (int z = 0; z < V1 && !off; ++z) {
          if (!(sm[zone_kid * V1 + z] && gmask[zone_kid * V1 + z])) continue;
          for (int c = 0; c < V1; ++c) {
            if (az[z * V1 + c] && sm[ct_kid * V1 + c] &&
                gmask[ct_kid * V1 + c]) {
              off = true;
              break;
            }
          }
        }
        if (!off) continue;
        if (add > best) best = add;
        if (dyn) {
          for (int d = 0; d < V1; ++d) {
            if (!(sm[kid_sel * V1 + d] && gmask[kid_sel * V1 + d])) continue;
            if (off_in_domain(az, dkey, d, other_row.data(), V1)) {
              int32_t& pc = percap_d[static_cast<size_t>(s) * V1 + d];
              pc = std::max(pc, add);
            }
          }
        }
      }
      if (dyn) {
        // domain assignment is deferred to the quota-proportional pass
        // below (it needs the eligible-claim count first)
        for (int d = 0; d < V1; ++d) {
          if (percap_d[static_cast<size_t>(s) * V1 + d] >= 1 &&
              qrem[d] >= 1) {
            adm_any[s] = 1;
            break;
          }
        }
        continue;
      }
      claim_cap[s] = best;
      claim_cap[s] = std::min(claim_cap[s], hc);  // open claims carry no prior
      if (MV) claim_cap[s] = std::min(claim_cap[s], cap_mv[s]);
      if (has_h)
        claim_cap[s] = std::min(
            claim_cap[s], h_allow(ch_cnt[static_cast<size_t>(s) * JH + jh]));
    }
    if (dyn) {
      // quota-proportional claim spread (mirrors ops/packing.py tier-2):
      // eligible claims are ranked in slot order and cut by cumulative
      // quota; a claim whose proportional domain is inadmissible falls
      // back to the largest-remaining-quota pick (ties by lowest d).
      int32_t total_q = 0;
      int n_elig = 0;
      for (int d = 0; d < V1; ++d) total_q += std::max(qrem[d], 0);
      for (int s = 0; s < NMAX; ++s) n_elig += adm_any[s] ? 1 : 0;
      std::vector<float> cumf(V1, 0.0f);
      {
        int32_t acc = 0;
        const float denom = static_cast<float>(std::max(total_q, 1));
        // parity: const 0.5
        for (int d = 0; d < V1; ++d) {
          acc += std::max(qrem[d], 0);
          cumf[d] = static_cast<float>(acc) / denom;
        }
      }
      int rank = 0;
      for (int s = 0; s < NMAX; ++s) {
        if (!adm_any[s]) continue;
        const float x = (static_cast<float>(rank) + 0.5f) /
                        static_cast<float>(std::max(n_elig, 1));
        ++rank;
        // first cumulative-quota bucket >= x: searchsorted's left rule
        // parity: tiebreak searchsorted
        int d_prop = V1 - 1;
        for (int d = 0; d < V1; ++d)
          if (cumf[d] >= x) {
            d_prop = d;
            break;
          }
        int d_star;
        // proportional spread applies to self-selecting spread only
        // (mode == DMODE_SPREAD); gate/affinity modes keep the greedy
        // pick — identical to ops/packing.py's `prop_ok & (mode ==
        // DMODE_SPREAD)` gate
        if (mode == 1 &&
            percap_d[static_cast<size_t>(s) * V1 + d_prop] >= 1 &&
            qrem[d_prop] >= 1) {
          d_star = d_prop;
        } else {
          int32_t best_q = -1;
          d_star = DEAD;
          for (int d = 0; d < V1; ++d) {
            if (percap_d[static_cast<size_t>(s) * V1 + d] < 1) continue;
            if (qrem[d] < 1) continue;
            if (qrem[d] > best_q) {
              best_q = qrem[d];
              d_star = d;
            }
          }
        }
        c_slot[s] = d_star;
        claim_cap[s] =
            (d_star < V1) ? percap_d[static_cast<size_t>(s) * V1 + d_star] : 0;
        claim_cap[s] = std::min(claim_cap[s], hc);
        if (MV) claim_cap[s] = std::min(claim_cap[s], cap_mv[s]);
        if (has_h)
          claim_cap[s] = std::min(
              claim_cap[s], h_allow(ch_cnt[static_cast<size_t>(s) * JH + jh]));
      }
    }
    // hostname-affinity: restrict tier 2 to the least-loaded eligible open
    // claim (the oracle's in-flight order) — one entity only
    bool haff_claim_served = false;
    if (haff) {
      int tstar = -1;
      int32_t bestload = kBigDom;
      for (int s = 0; s < NMAX; ++s)
        if (c_slot[s] == ANY && claim_cap[s] >= 1 && c_npods[s] < bestload) {
          bestload = c_npods[s];
          tstar = s;
        }
      for (int s = 0; s < NMAX; ++s)
        if (s != tstar) claim_cap[s] = 0;
      haff_claim_served = tstar >= 0;
    }
    // per-slot water-fill with the slot's remaining quota as budget
    for (int sl = 0; sl < NSLOT; ++sl) {
      if (qrem[sl] <= 0) continue;
      bool any = false;
      for (int s = 0; s < NMAX; ++s) {
        bool in = (c_slot[s] == sl);
        wf_npods[s] = in ? c_npods[s] : kBigDom;
        wf_cap[s] = in ? claim_cap[s] : 0;
        any = any || (in && claim_cap[s] > 0);
      }
      if (!any) continue;
      waterfill(wf_npods, wf_cap, qrem[sl], wf_fill);
      for (int s = 0; s < NMAX; ++s)
        if (wf_fill[s] > 0) {
          claim_fill[s] = wf_fill[s];
          qrem[sl] -= wf_fill[s];
        }
    }
    if (haff && haff_claim_served) std::fill(qrem.begin(), qrem.end(), 0);
    for (int s = 0; s < NMAX; ++s) {
      if (claim_fill[s] <= 0) continue;
      got[s] = 1;
      c_npods[s] += claim_fill[s];
      if (hself) ch_cnt[static_cast<size_t>(s) * JH + jh] += claim_fill[s];
      for (int r = 0; r < R; ++r)
        c_used[static_cast<size_t>(s) * R + r] += claim_fill[s] * req[r];
      out_claim_fills[static_cast<size_t>(gi) * NMAX + s] = claim_fill[s];
    }
    // commit claim requirement/type-mask mutations for claims that got pods
    for (int s = 0; s < NMAX; ++s) {
      if (!got[s]) continue;
      uint8_t* sm = c_mask.data() + static_cast<size_t>(s) * KV;
      uint8_t* sd = c_def.data() + static_cast<size_t>(s) * K;
      uint8_t* sn = c_neg.data() + static_cast<size_t>(s) * K;
      int pp = c_pool[s];
      const bool tighten = dyn && c_slot[s] < V1;
      for (int k = 0; k < K; ++k) {
        sd[k] = sd[k] || gdef[k];
        sn[k] = sn[k] && gneg[k];
        for (int v = 0; v < V1; ++v) sm[k * V1 + v] = sm[k * V1 + v] && gmask[k * V1 + v];
      }
      if (tighten) {
        // pin the claim to the selected domain (the oracle tightens node
        // requirements to the chosen single domain, topology.go:220-242)
        for (int v = 0; v < V1; ++v)
          if (v != c_slot[s]) sm[kid_sel * V1 + v] = 0;
        if (dkey == 0)
          c_dzone[s] = c_slot[s];
        else
          c_dct[s] = c_slot[s];
      }
      for (int t = 0; t < T; ++t) {
        if (!c_tmask[static_cast<size_t>(s) * T + t]) continue;
        bool keep = type_ok_pgt[(static_cast<size_t>(pp) * G + gi) * T + t];
        if (keep) {
          // offering under the (now merged, possibly pinned) masks
          bool off = false;
          const uint8_t* az =
              a_for_claim(s) + static_cast<size_t>(t) * V1 * V1;
          for (int z = 0; z < V1 && !off; ++z) {
            if (!sm[zone_kid * V1 + z]) continue;
            for (int c = 0; c < V1; ++c)
              if (az[z * V1 + c] && sm[ct_kid * V1 + c]) {
                off = true;
                break;
              }
          }
          keep = off;
        }
        if (keep) {
          for (int r = 0; r < R; ++r)
            if (t_alloc[t * R + r] < c_used[static_cast<size_t>(s) * R + r]) {
              keep = false;
              break;
            }
        }
        c_tmask[static_cast<size_t>(s) * T + t] = keep;
      }
    }

    // parity: phase fresh-claims
    // ---- 3. new claims from highest-weight feasible template ----
    // Serve one domain slot per iteration (largest remaining quota — the
    // argmax pick, first-hit ties by lowest slot index); a no-progress
    // slot is retired so other domains still get served.
    // parity: tiebreak argmax
    std::vector<uint8_t> ddead(NSLOT, 0);
    ddead[DEAD] = 1;
    while (!overflow) {
      int d_sel = -1;
      int32_t best_q = 0;
      for (int sl = 0; sl < NSLOT; ++sl)
        if (!ddead[sl] && qrem[sl] > best_q) {
          best_q = qrem[sl];
          d_sel = sl;
        }
      if (d_sel < 0) break;
      const bool is_any = (d_sel == ANY);

      // template/type availability in the selected domain
      auto type_avail = [&](int p, int t) -> bool {
        if (!type_ok_pgt[(static_cast<size_t>(p) * G + gi) * T + t])
          return false;
        if (p_has_limit[p]) {
          for (int r = 0; r < R; ++r)
            if (t_cap[t * R + r] > pool_rem[static_cast<size_t>(p) * R + r])
              return false;
        }
        if (!is_any) {
          const uint8_t* pm = p_mask + static_cast<size_t>(p) * KV;
          if (!(pm[kid_sel * V1 + d_sel] && gmask[kid_sel * V1 + d_sel]))
            return false;
          for (int v = 0; v < V1; ++v)
            other_row[v] =
                pm[other_kid * V1 + v] && gmask[other_kid * V1 + v];
          if (!off_in_domain(a_step.data() + static_cast<size_t>(t) * V1 * V1,
                             dkey, d_sel, other_row.data(), V1))
            return false;
        }
        if (NRES) {
          // the static type_ok table saw the full catalog; re-gate on the
          // ledger-aware view under the template∪group zone/ct masks
          const uint8_t* pm = p_mask + static_cast<size_t>(p) * KV;
          const uint8_t* az = a_step.data() + static_cast<size_t>(t) * V1 * V1;
          bool any = false;
          for (int z = 0; z < V1 && !any; ++z) {
            if (!(pm[zone_kid * V1 + z] && gmask[zone_kid * V1 + z])) continue;
            for (int c = 0; c < V1; ++c)
              if (az[z * V1 + c] && pm[ct_kid * V1 + c] &&
                  gmask[ct_kid * V1 + c]) {
                any = true;
                break;
              }
          }
          if (!any) return false;
        }
        return true;
      };

      int p_star = -1;
      int32_t mv_cap_sel = kBigDom;
      std::vector<uint8_t> mv_av(MV ? T : 0);
      std::vector<int32_t> mv_ft(MV ? T : 0);
      for (int p = 0; p < P && p_star < 0; ++p) {
        bool anyt = false;
        for (int t = 0; t < T; ++t)
          if (type_avail(p, t)) {
            anyt = true;
            break;
          }
        if (!anyt) continue;
        if (MV) {
          // a template whose available set cannot satisfy its floors is
          // infeasible for this bulk (filter_instance_types' minValues
          // validation) — fall through to the next template in weight order
          for (int t = 0; t < T; ++t) {
            mv_av[t] = type_avail(p, t);
            mv_ft[t] =
                n_fit_pgt[(static_cast<size_t>(p) * G + gi) * T + t];
          }
          int32_t mc = minvalues_cap_one(
              mv_av.data(), mv_ft.data(),
              p_mvmin + static_cast<size_t>(p) * MV, t_mvoh, T, MV, MW);
          if (mc < 1) continue;
          mv_cap_sel = mc;
        }
        p_star = p;
      }
      if (p_star < 0) {
        ddead[d_sel] = 1;
        continue;
      }
      // one BULK of identical claims for this domain (frozen avail set),
      // matching the JAX body: k bounded by demand, the pool-limit ledger
      // (identical debit per claim) and the remaining slots
      std::vector<uint8_t> avail_t(T);
      int32_t n_per = 0;
      std::vector<float> debit(R, 0.0f);
      for (int t = 0; t < T; ++t) {
        avail_t[t] = type_avail(p_star, t);
        if (!avail_t[t]) continue;
        n_per = std::max(
            n_per, n_fit_pgt[(static_cast<size_t>(p_star) * G + gi) * T + t]);
        for (int r = 0; r < R; ++r)
          debit[r] = std::max(debit[r], t_cap[t * R + r]);
      }
      n_per = std::min(n_per, hc);
      if (MV) n_per = std::min(n_per, mv_cap_sel);
      // fresh claims have count 0: self owners cap at scap_h; gate owners
      // are unblocked (0 never exceeds the threshold)
      if (hself) n_per = std::min(n_per, scap_h);
      if (n_per <= 0) {
        ddead[d_sel] = 1;
        continue;
      }
      const int32_t rem_d = qrem[d_sel];
      // reservation clamp: every claim of the bulk reserves one slot per
      // compatible reservation (idempotent per hostname)
      bool any_resv = false;
      std::vector<uint8_t> r_compat(NRES ? NRES : 1, 0);
      int64_t k_resv = kBigFit;
      if (NRES) {
        const uint8_t* pm = p_mask + static_cast<size_t>(p_star) * KV;
        // domain-pinned bulks only count reservations usable in the pin
        const bool pin_z = !is_any && dkey == 0;
        const bool pin_c = !is_any && dkey == 1;
        for (int r = 0; r < NRES; ++r) {
          if (res_rem[r] <= 0) continue;
          bool compat = false;
          for (int t = 0; t < T && !compat; ++t) {
            if (!avail_t[t]) continue;
            const uint8_t* ar =
                a_res + (static_cast<size_t>(r) * T + t) * V1 * V1;
            for (int z = 0; z < V1 && !compat; ++z) {
              if (pin_z && z != d_sel) continue;
              if (!(pm[zone_kid * V1 + z] && gmask[zone_kid * V1 + z]))
                continue;
              for (int c = 0; c < V1; ++c) {
                if (pin_c && c != d_sel) continue;
                if (ar[z * V1 + c] && pm[ct_kid * V1 + c] &&
                    gmask[ct_kid * V1 + c]) {
                  compat = true;
                  break;
                }
              }
            }
          }
          if (compat) {
            r_compat[r] = 1;
            any_resv = true;
            k_resv = std::min<int64_t>(k_resv, res_rem[r]);
          }
        }
      }
      int64_t k_limit = kBigFit;
      if (p_has_limit[p_star]) {
        for (int r = 0; r < R; ++r)
          if (debit[r] > 0.0f)
            k_limit = std::min<int64_t>(
                k_limit,
                static_cast<int64_t>(std::floor(
                    pool_rem[static_cast<size_t>(p_star) * R + r] /
                    std::max(debit[r], 1e-9f))));
      }
      int64_t k_want = std::min<int64_t>(
          (rem_d + n_per - 1) / n_per, std::max<int64_t>(k_limit, 0));
      if (any_resv) k_want = std::min(k_want, k_resv);
      // hostname-affinity: ONE fresh claim hosts the bootstrap
      if (haff) k_want = std::min<int64_t>(k_want, 1);
      int64_t k_slots = NMAX - n_open;
      if (k_want > k_slots) overflow = true;
      int64_t k = std::min(k_want, k_slots);
      if (k <= 0) {
        ddead[d_sel] = 1;
        continue;
      }
      int32_t placed = 0;
      // bulk births mirror ops/packing.py tier-3: domain-pinned bulks —
      // and ALL bulks of a domain-constrained batch — split rem_d evenly
      // (base + 1-pod remainders); ANY bulks of domain-free batches keep
      // the concentrating full-then-partial fill
      const bool even_bulk = has_domains || !is_any;
      const int32_t served =
          static_cast<int32_t>(std::min<int64_t>(rem_d, k * n_per));
      const int32_t base_take = static_cast<int32_t>(served / k);
      const int32_t extra_take = static_cast<int32_t>(served - base_take * k);
      for (int64_t i = 0; i < k; ++i) {
        int32_t n_take =
            even_bulk
                ? base_take + (i < extra_take ? 1 : 0)
                : std::min<int32_t>(rem_d - static_cast<int32_t>(i) * n_per,
                                    n_per);
        int slot = n_open++;
        c_active[slot] = 1;
        c_pool[slot] = p_star;
        c_npods[slot] = n_take;
        for (int r = 0; r < R; ++r)
          c_used[static_cast<size_t>(slot) * R + r] =
              p_daemon[static_cast<size_t>(p_star) * R + r] + n_take * req[r];
        for (int t = 0; t < T; ++t)
          c_tmask[static_cast<size_t>(slot) * T + t] =
              avail_t[t] &&
              (n_fit_pgt[(static_cast<size_t>(p_star) * G + gi) * T + t] >=
               n_take);
        std::memcpy(c_def.data() + static_cast<size_t>(slot) * K, gdef, K);
        std::memcpy(c_neg.data() + static_cast<size_t>(slot) * K, gneg, K);
        std::memcpy(c_mask.data() + static_cast<size_t>(slot) * KV, gmask, KV);
        if (dyn && !is_any) {
          // claims opened for a dynamic group are domain-pinned from birth
          uint8_t* sm = c_mask.data() + static_cast<size_t>(slot) * KV;
          for (int v = 0; v < V1; ++v)
            if (v != d_sel) sm[kid_sel * V1 + v] = 0;
          if (dkey == 0)
            c_dzone[slot] = d_sel;
          else
            c_dct[slot] = d_sel;
        }
        out_claim_fills[static_cast<size_t>(gi) * NMAX + slot] = n_take;
        if (hself) ch_cnt[static_cast<size_t>(slot) * JH + jh] = n_take;
        c_resv[slot] = any_resv;
        placed += n_take;
      }
      if (any_resv) {
        for (int r = 0; r < NRES; ++r)
          if (r_compat[r]) res_rem[r] -= static_cast<int32_t>(k);
        refresh_a_step();
      }
      if (p_has_limit[p_star])
        for (int r = 0; r < R; ++r)
          pool_rem[static_cast<size_t>(p_star) * R + r] -=
              debit[r] * static_cast<float>(k);
      qrem[d_sel] -= placed;
      if (placed == 0) ddead[d_sel] = 1;
      // haff: a second trip would open a second entity — retire the slot
      if (haff) ddead[d_sel] = 1;
    }
    // parity: phase spread-counters
    // shared domain carry: a SELF owner's per-domain placements feed the
    // next sharing group's counts (gate modes never count themselves)
    if (has_d && mode <= 2)
      for (int d = 0; d < V1; ++d)
        ddc[static_cast<size_t>(jd) * V1 + d] += qd[d] - qrem[d];
    // contributor counting (the oracle's record() rule,
    // scheduling/topology.py:491-498): existing-node placements count by
    // the node's domain; claim placements count only when the claim's key
    // axis is pinned to a single value (hostname is always single per
    // claim, so ch_cnt takes every claim fill).
    {
      bool anyh = false, anyd = false;
      for (int j = 0; j < JH; ++j)
        anyh = anyh || g_hcontrib[static_cast<size_t>(gi) * JH + j];
      for (int j = 0; j < JD; ++j)
        anyd = anyd || g_dcontrib[static_cast<size_t>(gi) * JD + j];
      if (anyh) {
        for (int j = 0; j < JH; ++j) {
          if (!g_hcontrib[static_cast<size_t>(gi) * JH + j]) continue;
          for (int n = 0; n < N; ++n)
            nhc[static_cast<size_t>(n) * JH + j] +=
                out_exist_fills[static_cast<size_t>(gi) * N + n];
          for (int s = 0; s < NMAX; ++s)
            ch_cnt[static_cast<size_t>(s) * JH + j] +=
                out_claim_fills[static_cast<size_t>(gi) * NMAX + s];
        }
      }
      if (anyd) {
        std::vector<int32_t> cnt_z(V1, 0), cnt_c(V1, 0);
        for (int n = 0; n < N; ++n) {
          int32_t f = out_exist_fills[static_cast<size_t>(gi) * N + n];
          if (!f) continue;
          if (n_dzone[n] >= 0 && n_dzone[n] < V1) cnt_z[n_dzone[n]] += f;
          if (n_dct[n] >= 0 && n_dct[n] < V1) cnt_c[n_dct[n]] += f;
        }
        for (int s = 0; s < NMAX; ++s) {
          int32_t f = out_claim_fills[static_cast<size_t>(gi) * NMAX + s];
          if (!f) continue;
          const uint8_t* sm = c_mask.data() + static_cast<size_t>(s) * KV;
          int zn = 0, zlast = -1, cn = 0, clast = -1;
          for (int v = 0; v < V1; ++v) {
            if (sm[zone_kid * V1 + v]) { ++zn; zlast = v; }
            if (sm[ct_kid * V1 + v]) { ++cn; clast = v; }
          }
          if (zn == 1) cnt_z[zlast] += f;
          if (cn == 1) cnt_c[clast] += f;
        }
        for (int j = 0; j < JD; ++j) {
          if (!g_dcontrib[static_cast<size_t>(gi) * JD + j]) continue;
          const int32_t* src = (dtg_key[j] == 0) ? cnt_z.data() : cnt_c.data();
          for (int d = 0; d < V1; ++d)
            ddc[static_cast<size_t>(j) * V1 + d] += src[d];
        }
      }
    }
    // fill-based, matching the JAX kernel's count - sum(fills): quota
    // bookkeeping under-reports here — the haff path zeroes qrem after a
    // served pin precisely so the remainder errors instead of spilling
    int64_t placed_total = 0;
    for (int n = 0; n < N; ++n)
      placed_total += out_exist_fills[static_cast<size_t>(gi) * N + n];
    for (int s = 0; s < NMAX; ++s)
      placed_total += out_claim_fills[static_cast<size_t>(gi) * NMAX + s];
    out_unplaced[gi] = count - static_cast<int32_t>(placed_total);
  }

  std::memcpy(out_c_pool, c_pool.data(), sizeof(int32_t) * NMAX);
  std::memcpy(out_c_tmask, c_tmask.data(), sizeof(uint8_t) * NMAX * T);
  std::memcpy(out_c_dzone, c_dzone.data(), sizeof(int32_t) * NMAX);
  std::memcpy(out_c_dct, c_dct.data(), sizeof(int32_t) * NMAX);
  std::memcpy(out_c_resv, c_resv.data(), sizeof(uint8_t) * NMAX);
  out_n_open[0] = n_open;
  out_overflow[0] = overflow ? 1 : 0;
  return overflow ? 1 : 0;
}

}  // extern "C"
