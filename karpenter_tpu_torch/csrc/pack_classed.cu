// Kernel B5: the class-batched packing scan.
//
// Replaces karpenter_tpu/ops/packing.py:pack_classed (a lax.scan over
// feasibility classes on the TPU, class body packing.py:1342) in the
// scope the PyTorch port covers: untiled tables, no reservations, no
// minValues, with or without domains and contributor counting. The
// driver routes a batch here when its groups share few feasibility
// classes (the reference's diverse mix: ~1,900 groups in ~30 classes).
//
// Bound on the H100: latency, as B4's. One persistent block of 1024
// threads walks the classes in order (a class step depends on the last
// one) and, inside each, its member groups in order. What batching buys
// is the class head: the tables that depend only on the class (requests,
// masks and tolerations are identical across its members) are built once
// into device scratch the wrapper allocates: the claims' fit counts af0
// [NMAX, T], offering rows off0 [NMAX, T] and, for a dynamic class, their
// per-domain offering table toff_nt0 [NMAX, T, V1]; the templates' toff_pt
// [P, T, V1]; the group-mask rows off_grp [T] / toff_grp [T, V1] that a
// claim opened in the class carries. A member then reads only per-claim
// summaries (capv [NMAX], percapv [NMAX, V1]) and maintains them by exact
// integer decrements (every member requests the same vector, so a fill of
// k lowers every fit count by exactly k: quantized requests are
// integer-valued float32 below 2^24); claims opened in the class take
// their summaries in closed form, pinned claims collapse to their lane.
// The claims' type masks settle once per class against the final pins and
// the class-total fills. Every phase a member runs (existing nodes, the
// domain quota, tier 2, the fresh-claim bulks, the carries, contributor
// counting) is pack_common.cuh's, shared with kernel B4, with
// pack_classed's waterfill1 where it uses one.
//
// Fills go straight into the group rows class_start + m (the TPU's [C,
// lmax] member buffers and their inv_idx gather are a layout, not part of
// the function); rows of groups that place nothing stay as the entry's
// memset leaves them: zero.
#include "pack_common.cuh"

namespace {

struct Classes {
  const int32_t* start; const int32_t* len; const uint8_t* dyn; const int32_t* dkey;
  int C;
};

// the class head tables and per-claim summaries (device scratch)
struct Head {
  int32_t* capv; int32_t* percapv; int32_t* af0; uint8_t* off0; uint8_t* toff_nt0;
  uint8_t* live; int32_t* cfills; int32_t* pin0; uint8_t* off_grp; uint8_t* toff_grp;
  int32_t* e_cap;
};

// a fresh-claim bulk's effect on the maintained summaries of the claims
// it opens (packing.py:1997-2030): capv = n_fit_max - take; percapv from
// the group-mask availability toff_grp, pinned bulks to their lane; af0 =
// n_fit - take; cfills 0; live
struct ClassedBulkHook {
  const Head* h;  // the kernel's shared copy
  int32_t* pmax;  // [V1] shared: the bulk template's best fit per domain
  int T, V1;
  bool has_domains, cdyn;
  __device__ void trip(const uint8_t* av, const int32_t* nf, int, Shared& sh) const {
    if (!has_domains) return;
    for (int v = 0; v < V1; ++v) {
      int32_t best = 0;
      if (cdyn)
        for (int t = threadIdx.x; t < T; t += kThreads)
          if (av[t] && h->toff_grp[static_cast<size_t>(t) * V1 + v]) best = max(best, nf[t]);
      best = block_max(best, sh);
      if (threadIdx.x == 0) pmax[v] = best;
    }
    __syncthreads();
  }
  __device__ void open(int s, int32_t take, int32_t n_fit_max, int d_pin) const {
    h->capv[s] = wrap_sub(n_fit_max, take);
    if (has_domains)
      for (int v = 0; v < V1; ++v) {
        const int32_t p = max(wrap_sub(pmax[v], take), 0);
        h->percapv[static_cast<size_t>(s) * V1 + v] = (d_pin >= 0 && v != d_pin) ? 0 : p;
      }
    h->cfills[s] = 0;
    h->live[s] = 1;
  }
  __device__ void cell(int s, int t, int32_t take, int32_t nf_t) const {
    h->af0[static_cast<size_t>(s) * T + t] = wrap_sub(nf_t, take);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
pack_classed_scan(Dims d, In in0, State st0, Out out0, Classes cls0, Head hd0) {
  __shared__ In in;
  __shared__ State st;
  __shared__ Out out;
  __shared__ Classes cls;
  __shared__ Head hd;
  __shared__ Smem m;
  __shared__ Grp g;
  __shared__ Shared sh;
  __shared__ float s_debit[32];
  extern __shared__ __align__(16) unsigned char dyn[];
  if (threadIdx.x == 0) {
    in = in0;
    st = st0;
    out = out0;
    cls = cls0;
    hd = hd0;
    carve(dyn, d, m);
  }
  __syncthreads();
  const int G = d.G, T = d.T, N = d.N, R = d.R, V1 = d.V1, NMAX = d.NMAX, JH = d.JH, W = d.W;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;

  init_state(d, in, st, out);
  int32_t n_open = 0;
  bool overflow = false;

  for (int ci = 0; ci < cls.C; ++ci) {
    const int cl = cls.len[ci];
    if (cl <= 0) continue;  // a class of padding groups: skipped whole
    const int cs = cls.start[ci];
    const bool cdyn = d.has_domains && cls.dyn[ci];
    const int cdk = cls.dkey[ci];

    // ---- class-invariant head tables (packing.py:1343-1541) ----
    load_rows(d, in, cs, m);
    __syncthreads();
    for (int t = tid; t < T; t += kThreads) {
      hd.off_grp[t] = offer(st.atz, t, V1, W, m.gz, m.gc);
      if (cdyn)
        for (int v = 0; v < V1; ++v)
          hd.toff_grp[static_cast<size_t>(t) * V1 + v] =
              offer_in(st.atz, st.atc, cdk, t, v, V1, W, m.gz, m.gc);
    }
    if (cdyn) template_domains(d, in, st, m, cs, cs, cdk);
    for (int n = tid; n < N; n += kThreads)
      st.exist_cap[n] = in.cap_ng[static_cast<size_t>(n) * G + cs] > 0
                            ? fits_count(in.n_avail + static_cast<size_t>(n) * R,
                                         st.exist_used + static_cast<size_t>(n) * R, m.req, R)
                            : 0;
    // every open claim's compatibility, fit counts, offering rows and
    // capacity summaries at the head (one warp per claim)
    for (int s = wid; s < NMAX; s += kWarps) {
      const int32_t pin = (cdk == 0 ? out.c_dzone : out.c_dct)[s];
      if (s >= n_open) {
        // not open yet: nothing to read until a bulk opens it
        if (lane == 0) {
          hd.capv[s] = 0;
          hd.live[s] = 0;
          hd.cfills[s] = 0;
          hd.pin0[s] = pin;
        }
        if (d.has_domains)
          for (int v = lane; v < V1; v += 32) hd.percapv[static_cast<size_t>(s) * V1 + v] = 0;
        continue;
      }
      const bool live0 = warp_claim_compat(d, in, st, out, m, s, cs);
      const uint32_t* wcz = warp_claim_words(d, st, m, s);
      const uint32_t* wcc = wcz + W;
      int32_t* wpc = m.pcap + wid * V1;
      if (cdyn)
        for (int v = lane; v < V1; v += 32) wpc[v] = 0;
      __syncwarp();
      const uint8_t* tok = in.type_ok + (static_cast<size_t>(out.c_pool[s]) * G + cs) * T;
      int32_t best = 0;
      for (int t = lane; t < T; t += 32) {
        const size_t st_i = static_cast<size_t>(s) * T + t;
        const int32_t af = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                      st.c_used + static_cast<size_t>(s) * R, m.req, R);
        const bool o = offer(st.atz, t, V1, W, wcz, wcc);
        hd.af0[st_i] = af;
        hd.off0[st_i] = o;
        const bool tm = out.c_tmask[st_i] && tok[t] && o;
        if (tm) best = max(best, af);
        if (cdyn)
          for (int v = 0; v < V1; ++v) {
            const bool od = offer_in(st.atz, st.atc, cdk, t, v, V1, W, wcz, wcc);
            hd.toff_nt0[st_i * V1 + v] = od;
            if (tm && od) atomicMax(&wpc[v], af);
          }
      }
      for (int o = 16; o; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o));
      __syncwarp();
      if (lane == 0) {
        hd.capv[s] = best;
        hd.live[s] = live0;
        hd.cfills[s] = 0;
        hd.pin0[s] = pin;
      }
      if (d.has_domains)
        for (int v = lane; v < V1; v += 32)
          hd.percapv[static_cast<size_t>(s) * V1 + v] = cdyn ? wpc[v] : 0;
      __syncwarp();
    }
    const int32_t n_open0 = n_open;
    __syncthreads();

    // ---- the member groups, in FFD order (packing.py:1543) ----
    for (int j = 0; j < cl; ++j) {
      const int gi = cs + j;
      if (in.g_count[gi] <= 0) continue;
      if (tid == 0) load_group(d, in, gi, cs, cdk, g);
      __syncthreads();
      if (g.dyn)
        for (int v = tid; v < V1; v += kThreads)
          m.D0[v] = wrap_add(in.g_dprior[static_cast<size_t>(gi) * V1 + v],
                             g.has_d ? st.ddc[static_cast<size_t>(min(g.jd, d.JD - 1)) * V1 + v] : 0);
      for (int n = tid; n < N; n += kThreads) {
        int32_t ec = min(st.exist_cap[n],
                         max(wrap_sub(g.hcap, in.n_hcnt[static_cast<size_t>(n) * G + gi]), 0));
        hd.e_cap[n] = min(ec, h_allow(g, st.nhc[n * JH + g.jhc]));
      }
      // tier 2 and the affinity anchor read the summaries of live claims
      if (g.dyn)
        for (int i = tid; i < NMAX * V1; i += kThreads) {
          const int s = i / V1;
          st.percap[i] = (s < n_open && hd.live[s]) ? hd.percapv[i] : 0;
        }
      __syncthreads();
      const bool haff_exist_served = haff_pin_nodes(d, in, g, hd.e_cap, sh);
      if (g.dyn)
        domain_quota(d, in, st, out, m, g, hd.e_cap, true, sh);
      else
        any_quota(d, m, g.count);
      const int32_t placed_exist = tier1_fill(d, in, st, out, m, g, hd.e_cap,
                                              haff_exist_served, sh);
      // same-request decrement: exact
      for (int n = tid; n < N; n += kThreads)
        st.exist_cap[n] = wrap_sub(st.exist_cap[n], out.exist_fills[static_cast<size_t>(gi) * N + n]);

      // ---- 2. open claims, from the maintained summaries ----
      if (g.dyn) {
        tier2_domains(d, st, m, g, g.count <= 1, sh);
      } else {
        for (int s = tid; s < NMAX; s += kThreads) {
          int32_t c = (s < n_open && hd.live[s]) ? hd.capv[s] : 0;
          c = min(c, g.hcap);
          c = min(c, g.count);
          st.claim_cap[s] = min(c, h_allow(g, st.ch_cnt[s * JH + g.jhc]));
        }
        __syncthreads();
        tier2_any(d, st, m, g, true, sh);
      }
      commit_claims(d, in, st, out, m, g, false);
      // summary maintenance: exact decrements, then a pin zeroes the
      // other lanes and collapses capv to the pinned one
      for (int s = tid; s < NMAX; s += kThreads) {
        const int32_t f = st.claim_fill[s];
        if (f == 0) continue;
        hd.cfills[s] = wrap_add(hd.cfills[s], f);
        if (d.has_domains) {
          const int c_s = st.c_slot[s];
          const bool tighten = g.dyn && f > 0 && c_s < V1;
          int32_t* pv = hd.percapv + static_cast<size_t>(s) * V1;
          for (int v = 0; v < V1; ++v) {
            const int32_t x = max(wrap_sub(pv[v], f), 0);
            pv[v] = (tighten && v != c_s) ? 0 : x;
          }
          hd.capv[s] = tighten ? pv[c_s] : wrap_sub(hd.capv[s], f);
        } else {
          hd.capv[s] = wrap_sub(hd.capv[s], f);
        }
      }
      __syncthreads();

      // ---- 3. fresh claims ----
      fresh_claims(d, in, st, out, m, g, n_open, overflow,
                   ClassedBulkHook{&hd, m.pmax, T, V1, d.has_domains, cdyn}, sh, s_debit);
      spread_carry(d, st, m, g);
      __syncthreads();
      if (d.has_contrib) contrib_counts(d, in, st, out, m, g);
      group_outputs(d, st, out, g, placed_exist, sh);
    }

    // ---- end-of-class type-mask settlement (packing.py:2160-2191) ----
    // one intersection with the final pins and the class-total fills:
    // type_ok of the claim's template ∧ its offering row (head row; at a
    // pin taken in the class, the head's per-domain row; for a claim
    // opened in the class, the group-mask row) ∧ fit >= class fills
    for (int s = wid; s < n_open; s += kWarps) {
      const int32_t cf = hd.cfills[s];
      if (cf <= 0) continue;
      const bool is_new = s >= n_open0;
      const int32_t pin_rel = (cdk == 0 ? out.c_dzone : out.c_dct)[s];
      const int pinc = min(max(pin_rel, 0), V1 - 1);
      const bool newpin = pin_rel >= 0 && pin_rel != hd.pin0[s] && !is_new;
      const uint8_t* tok = in.type_ok + (static_cast<size_t>(out.c_pool[s]) * G + cs) * T;
      for (int t = lane; t < T; t += 32) {
        const size_t st_i = static_cast<size_t>(s) * T + t;
        bool off;
        if (is_new)
          off = (d.has_domains && pin_rel >= 0)
                    ? (cdyn && hd.toff_grp[static_cast<size_t>(t) * V1 + pinc])
                    : hd.off_grp[t];
        else if (d.has_domains && newpin)
          off = cdyn && hd.toff_nt0[st_i * V1 + pinc];
        else
          off = hd.off0[st_i];
        if (!(tok[t] && off && hd.af0[st_i] >= cf)) out.c_tmask[st_i] = 0;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    out.n_open[0] = n_open;
    out.overflow[0] = overflow;
  }
}

}  // namespace

extern "C" int kt_pack_classed(
    int G, int T, int P, int N, int R, int K, int V1, int NMAX, int JH, int JD,
    int C, int zone_kid, int ct_kid, int wf_iters, int has_domains, int has_contrib,
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
    // contributor rows and each shared domain slot's axis
    const uint8_t* g_hcontrib, const uint8_t* g_dcontrib, const int32_t* dtg_key,
    // the class partition
    const int32_t* class_start, const int32_t* class_len, const uint8_t* class_dyn,
    const int32_t* class_dkey,
    // state + scratch
    float* exist_used, float* c_used, int32_t* c_npods, uint8_t* c_def,
    uint8_t* c_neg, uint8_t* c_mask, int32_t* ch_cnt, int32_t* nhc,
    float* pool_rem, int32_t* exist_cap, int32_t* claim_cap,
    int32_t* claim_fill, uint8_t* avail, uint32_t* atz,
    uint32_t* atc, uint8_t* toff_pt, int32_t* percap, int32_t* c_slot,
    int32_t* ddc,
    // class head tables and per-claim summaries
    int32_t* capv, int32_t* percapv, int32_t* af0, uint8_t* off0, uint8_t* toff_nt0,
    uint8_t* live, int32_t* cfills, int32_t* pin0, uint8_t* off_grp, uint8_t* toff_grp,
    int32_t* e_cap,
    // outputs
    int32_t* c_pool, uint8_t* c_tmask, int32_t* n_open, uint8_t* overflow,
    int32_t* exist_fills, int32_t* claim_fills, int32_t* unplaced,
    int32_t* c_dzone, int32_t* c_dct, uint8_t* c_resv,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (R > 32 || JH < 1 || JD < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (V1 + 31) / 32;
  // rows of skipped classes and of count-0 members stay zero
  cudaMemsetAsync(exist_fills, 0, sizeof(int32_t) * static_cast<size_t>(G) * N, stream);
  cudaMemsetAsync(claim_fills, 0, sizeof(int32_t) * static_cast<size_t>(G) * NMAX, stream);
  cudaMemsetAsync(unplaced, 0, sizeof(int32_t) * static_cast<size_t>(G), stream);
  Dims d{G, T, P, N, R, K, V1, NMAX, JH, JD, zone_kid, ct_kid, wf_iters, W,
         has_domains != 0, has_contrib != 0};
  In in{g_count, g_req, g_def, g_neg, g_mask, g_hcap, g_haff, g_hstg, g_hscap,
        g_hself, compat_pg, type_ok, n_fit, cap_ng, t_alloc, t_cap, a_tzc,
        p_daemon, p_limit, p_has_limit, p_tol, n_avail, n_base, n_hcnt,
        nh_cnt0, well_known, g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior,
        g_dreg, g_drank, g_dtg, p_mask, n_dzone, n_dct, dd0,
        g_hcontrib, g_dcontrib, dtg_key};
  State st{exist_used, c_used, c_npods, c_def, c_neg, c_mask, ch_cnt, nhc,
           pool_rem, exist_cap, claim_cap, claim_fill, avail, atz,
           atc, toff_pt, percap, c_slot, ddc};
  Out out{c_pool, c_tmask, n_open, overflow, exist_fills, claim_fills,
          unplaced, c_dzone, c_dct, c_resv};
  Classes cls{class_start, class_len, class_dyn, class_dkey, C};
  Head hd{capv, percapv, af0, off0, toff_nt0, live, cfills, pin0, off_grp, toff_grp, e_cap};
  const size_t smem = smem_bytes(P, W, V1, K, R);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(pack_classed_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  pack_classed_scan<<<1, kThreads, smem, stream>>>(d, in, st, out, cls, hd);
  return static_cast<int>(cudaGetLastError());
}
