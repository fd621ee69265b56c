// Kernel B4: the grouped first-fit-decreasing packing scan.
//
// Replaces karpenter_tpu/ops/packing.py:pack (a lax.scan over groups on
// the TPU, step body packing.py:425) in the scope the PyTorch port
// covers: untiled tables, no reservations, no minValues, with or without
// the domain machinery (has_domains) and contributor counting
// (has_contrib). Its sequential twin is
// karpenter_tpu/native/solve_core.cc:kt_solve; the phases carry the same
// names. The phases themselves live in pack_common.cuh, shared with
// kernel B5 (pack_classed.cu).
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
// Contributor counting (has_contrib; packing.py:1153): after its step a
// group adds its node and claim fills to the shared hostname counts of
// its contributor slots (nhc, ch_cnt) and, by domain, to the shared
// domain counts (ddc); claim fills count by domain only where the claim's
// mask row on that axis is single-valued. Integer atomics into four [V1]
// shared-memory sums, exact in any order.
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
#include "pack_common.cuh"

namespace {

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

__global__ void __launch_bounds__(kThreads, 1)
pack_scan(Dims d, In in0, State st0, Out out0, Strides sc) {
  // this block's scenario slices, kept in shared memory rather than in
  // registers, which the 1024-thread launch bound already holds to 64
  __shared__ In in;
  __shared__ State st;
  __shared__ Out out;
  __shared__ Smem m;
  __shared__ Grp g;
  __shared__ Shared sh;
  __shared__ float s_debit[32];
  extern __shared__ __align__(16) unsigned char dyn[];
  if (threadIdx.x == 0) {
    in = in0;
    st = st0;
    out = out0;
    own_slice(d, sc, blockIdx.x, in, st, out);
    carve(dyn, d, m);
  }
  __syncthreads();
  const int G = d.G, T = d.T, N = d.N, R = d.R, V1 = d.V1, NMAX = d.NMAX, JH = d.JH, W = d.W;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;

  init_state(d, in, st, out);
  int32_t n_open = 0;
  bool overflow = false;

  for (int gi = 0; gi < G; ++gi) {
    if (in.g_count[gi] <= 0) {
      // padded / empty groups place nothing and mutate nothing
      for (int n = tid; n < N; n += kThreads) out.exist_fills[gi * N + n] = 0;
      for (int s = tid; s < NMAX; s += kThreads)
        out.claim_fills[static_cast<size_t>(gi) * NMAX + s] = 0;
      if (tid == 0) out.unplaced[gi] = 0;
      continue;
    }
    if (tid == 0) load_group(d, in, gi, gi, in.g_dkey[gi], g);
    load_rows(d, in, gi, m);
    __syncthreads();
    if (g.dyn) {
      const bool has_d = g.has_d;
      for (int v = tid; v < V1; v += kThreads)
        m.D0[v] = wrap_add(in.g_dprior[static_cast<size_t>(gi) * V1 + v],
                           has_d ? st.ddc[static_cast<size_t>(min(g.jd, d.JD - 1)) * V1 + v] : 0);
      template_domains(d, in, st, m, gi, gi, g.dkey);
    }

    // ---- claim-side feasibility: cap_any, clamped to claim_cap; per
    // domain percap for dynamic groups (0 on claims that are not live) ----
    for (int s = wid; s < NMAX; s += kWarps) {
      int32_t cap_any = 0;
      bool live = false;
      int32_t* wpc = m.pcap + wid * V1;
      if (s < n_open && warp_claim_compat(d, in, st, out, m, s, gi)) {  // c_active
        live = true;
        const uint32_t* wcz = warp_claim_words(d, st, m, s);
        const uint32_t* wcc = wcz + W;
        if (g.dyn)
          for (int v = lane; v < V1; v += 32) wpc[v] = 0;
        __syncwarp();
        const int pp = out.c_pool[s];
        const uint8_t* tok = in.type_ok + (static_cast<size_t>(pp) * G + gi) * T;
        int32_t best = 0;
        for (int t = lane; t < T; t += 32) {
          if (!out.c_tmask[static_cast<size_t>(s) * T + t] || !tok[t]) continue;
          const int32_t af = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                        st.c_used + static_cast<size_t>(s) * R, m.req, R);
          if (af < 1 || !offer(st.atz, t, V1, W, wcz, wcc)) continue;
          best = max(best, af);
          if (g.dyn)
            for (int v = 0; v < V1; ++v)
              if (offer_in(st.atz, st.atc, g.dkey, t, v, V1, W, wcz, wcc))
                atomicMax(&wpc[v], af);
        }
        for (int o = 16; o; o >>= 1) best = max(best, __shfl_xor_sync(kFull, best, o));
        cap_any = best;
        __syncwarp();
      }
      if (g.dyn)
        for (int v = lane; v < V1; v += 32)
          st.percap[static_cast<size_t>(s) * V1 + v] = live ? wpc[v] : 0;
      __syncwarp();
      if (lane == 0) {
        int32_t c = min(cap_any, g.hcap);  // open claims carry no prior
        c = min(c, g.count);
        c = min(c, h_allow(g, st.ch_cnt[s * JH + g.jhc]));
        st.claim_cap[s] = c;
      }
    }

    // node caps at the current load, the group's per-entity caps
    for (int n = tid; n < N; n += kThreads) {
      int32_t ec = in.cap_ng[static_cast<size_t>(n) * G + gi] > 0
                       ? fits_count(in.n_avail + static_cast<size_t>(n) * R,
                                    st.exist_used + static_cast<size_t>(n) * R, m.req, R)
                       : 0;
      ec = min(ec, max(wrap_sub(g.hcap, in.n_hcnt[static_cast<size_t>(n) * G + gi]), 0));
      ec = min(ec, h_allow(g, st.nhc[n * JH + g.jhc]));
      st.exist_cap[n] = ec;
    }
    __syncthreads();
    const bool haff_exist_served = haff_pin_nodes(d, in, g, st.exist_cap, sh);

    if (g.dyn)
      domain_quota(d, in, st, out, m, g, st.exist_cap, false, sh);
    else
      any_quota(d, m, g.count);
    const int32_t placed_exist = tier1_fill(d, in, st, out, m, g, st.exist_cap,
                                            haff_exist_served, sh);
    if (g.dyn)
      tier2_domains(d, st, m, g, false, sh);
    else
      tier2_any(d, st, m, g, false, sh);
    commit_claims(d, in, st, out, m, g, true);
    fresh_claims(d, in, st, out, m, g, n_open, overflow, NoBulkHook{}, sh, s_debit);
    spread_carry(d, st, m, g);
    __syncthreads();
    if (d.has_contrib) contrib_counts(d, in, st, out, m, g);
    group_outputs(d, st, out, g, placed_exist, sh);
  }
  if (tid == 0) {
    out.n_open[0] = n_open;
    out.overflow[0] = overflow;
  }
}

}  // namespace

extern "C" int kt_pack(
    int S, int G, int T, int P, int N, int R, int K, int V1, int NMAX, int JH,
    int JD, int zone_kid, int ct_kid, int wf_iters, int has_domains, int has_contrib,
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
    // contributor rows and each shared domain slot's axis
    const uint8_t* g_hcontrib, const uint8_t* g_dcontrib, const int32_t* dtg_key,
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
  Strides sc{s_g_count, s_cap_ng, s_n_hcnt, s_nh_cnt0, s_g_dprior, s_dd0};
  const size_t smem = smem_bytes(P, W, V1, K, R);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(pack_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  pack_scan<<<S, kThreads, smem, stream>>>(d, in, st, out, sc);
  return static_cast<int>(cudaGetLastError());
}
