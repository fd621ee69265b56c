// Kernel B4: the grouped first-fit-decreasing packing scan.
//
// Replaces karpenter_tpu/ops/packing.py:pack (a lax.scan over groups on
// the TPU, step body packing.py:425): tables or the tiled mode, with or
// without the domain machinery (has_domains), contributor counting
// (has_contrib), minValues floors (MV > 0) and the reservation ledger
// (NRES > 0). Its sequential twin is
// karpenter_tpu/native/solve_core.cc:kt_solve; the phases carry the same
// names. The phases themselves live in pack_common.cuh, shared with
// kernel B5 (pack_classed.cu).
//
// Bound on the H100: latency, not bytes or operations. The scan is
// sequential over groups; each step is a chain of dependent block-wide
// reductions (claim caps, a prefix scan over existing nodes, up to
// wf_iters bisection trips per water-fill, bulk openings), each a barrier
// over the open claims x T cells.
//
// Design: ONE persistent thread-block cluster of up to 8 blocks of 1024
// threads (pick_cluster) walks every group in FFD order — no launch per scan step, which
// would cost more than the step. The carried state (PackState) lives in
// device memory the wrapper allocates (c_tmask alone is 13 MB at the
// tenant cell, beyond the 227 KB of shared memory; the 50 MB L2 holds
// it); per-step group rows live in each block's shared memory. The claim
// axis runs to the open claims (n_open), never NMAX (pack_common.cuh: the
// live extent). The three phases whose work is per claim or per cell fan
// out over the cluster's blocks, each rank a contiguous share of the
// live claims (of the types, for tile_rows): the claim-side feasibility
// and commit_claims, one warp per claim with lanes over types, and the
// tiled row build. Every other phase (node caps, quota, tier 1, tier 2,
// the fresh-claim bulks, contributor counting, the outputs) runs on rank
// 0 as on one block while the other ranks wait at the cluster barrier,
// whose release / acquire order the State one rank writes before another
// reads it; each rank loads the step's group rows into its own shared
// memory (no wait on rank 0), and reads rank 0's claim count after each
// step through distributed shared memory. Reductions and scans are
// integer (exact in any order) and cost one barrier each; argmin/argmax
// break ties at the lowest index; float32 ledgers use two IEEE roundings
// per a*b+c (built with -fmad=false), as XLA computes them.
//
// The offering words (pack_common.cuh:offer_words): the scan's offering
// tests are ORs over bit words of a_tzc, [T, V1(z), W] over capacity types
// (and, with domains, [T, V1(c), W] over zones). One grid-stride pass
// over the whole card builds them before the scan, a thread a word from
// 32 consecutive bytes (T x V1 x V1 bytes: 1.68 GB at V1 2,048, T 400,
// ~220 ms on an H100 through the scan's own block), once a launch and
// shared by every scenario, or once a scenario under a reservation
// ledger, whose drains rebuild that scenario's words in the scan. The same
// pass ORs together each zone and capacity type that any offering names
// (the offered sets, Offered): every test walks only those zones and
// capacity-type words, and a dynamic group's per-domain claim caps only
// those domains. A domain-free batch carves no per-domain array (Smem's
// wide part is then its V1 + 2 quota slots and its words: 63,973 B at V1
// 2,048), and a domain batch sizes fewer claims a claim-caps chunk before
// its per-domain rows would leave shared memory (scan_layout), so at V1
// 2,048 nothing spills.
//
// Domains (has_domains; packing.py:496-1152): a dynamic group (g_dmode >
// 0) gets a quota qd over its V1 domain slots plus ANY and DEAD. Per step
// the kernel computes the templates' per-domain offering table toff_pt
// [P, T, V1] into device scratch; the claims' table toff_nt [NMAX, T, V1]
// is never stored (megabytes per step at NMAX ~ 1k, T = 800): each use
// re-derives its cell from the claim's zone/capacity-type words and the
// offering bit table, inside the per-claim max (percap [NMAX, V1], kept
// with shared-memory atomicMax, one row a claim of the chunk) and inside
// the survival check.
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
// minValues (MV > 0; packing.py:596, :805, :969-982): each step caps a
// live claim's tier-2 join at its minValues cap, and a bulk's templates
// each get their cap over their available types (a template below 1
// opens nothing). Three builds of the scan (pack_common.cuh:MvPath, picked
// per launch by mv_path): without floors, none of this code; at a narrow
// catalog (an instance-family floor, MW in the tens), a warp an entity
// (warp_minvalues: per-value best fits in shared memory, the floor-th
// largest selected by counting); at a wide one (an instance-type floor
// over 1,100 types, MW 2,048), teams of threads out of line
// (team_minvalues: a walk of each type's value words over their span, then
// the floor-th largest selected by one warp over the compacted fits, bit
// by bit from the top bit of their maximum; one template takes as many
// warps as its types need). There a warp a claim would need 256 KB of
// fits a block, so the layout takes fewer, larger teams (scan_layout: 8
// teams of 128 threads, 64 KB) and nothing spills.
//
// The reservation ledger (NRES > 0; packing.py:352, :485-517, :583-591,
// :940-1036, :1100-1104): st.atz / st.atc hold the current ledger's
// offering words (a_tzc plus the reserved offerings whose reservation has
// capacity left), the scenario's own, rebuilt by rank 0 only when a
// reservation drains (atz as word ORs of a_tzc's and the live
// reservations' words); claims holding reservations read the held words
// instead. A bulk re-gates its avail set
// on the current words, counts the compatible reservations over each
// reservation's words (an OR over zone and capacity-type bits, no float
// sums), is bounded by the smallest remaining one, marks its claims
// c_resv and debits the ledger. A static pass (static_words) builds the
// word tables before the scan.
//
// The tiled mode (tiled; packing.py:382 _tile_rows, used at :429): no
// [P, G, T] tables. After load_group each real step builds its group's
// rows into the block's Rows scratch (tile_rows, pack_common.cuh: two
// more barriers per step, P x T cells of B3's cell functions over bit
// words: the types', templates' and nodes' built once per launch by
// tile_words, the group's by load_rows) and reads them where it read the
// tables' column; an empty step builds nothing.
//
// Scenario grid (kernel B7, karpenter_tpu/ops/solve.py:357
// solve_scenarios_core_packed, which vmaps this scan over consolidation
// scenarios): cluster s of a launch of S clusters walks scenario s. The
// batched inputs (g_count, cap_ng or, tiled, n_tol, and n_hcnt / nh_cnt0 /
// g_dprior / dd0 when the topology priors are per scenario) carry a
// scenario stride, 0 when shared; every State, Rows and Out buffer holds
// S slices and each block
// offsets into its own (each scenario replays the ledger from res_cap0);
// the static word tables are shared. The scan body is the same for every S, so
// scenarios walk the same groups in the same order with the same ties and
// bisection; S = 1 is the plain solve. Scenarios are independent, so
// clusters never synchronise with each other. The card holds only so many
// clusters at once (1 block per SM, clusters within a GPC), so the launch
// narrows the cluster until all S fit (pick_cluster); past the SMs, single
// blocks queue.
#include "pack_common.cuh"

namespace {

// The most blocks in the thread-block cluster that walks one scenario: 8,
// the portable maximum, was fastest at every shape of the A/B over 1, 2,
// 4 and 8 (PERF.md §6). A launch of S scenarios takes the largest cluster
// of 8, 4 or 2 blocks of which the card holds S at once (pick_cluster), so
// a scenario batch never queues a second wave behind a wider cluster;
// single blocks where not even clusters of 2 fit. A card that cannot
// place a cluster of 8 with the scan's shared memory at all refuses the
// launch (kClusterUnplaced), never runs it smaller.
constexpr int kMaxCluster = 8;

// the phase clocks' slots (pack_common.cuh: KT_PHASE_CLOCKS)
enum Phase {
  kPhInit, kPhLoad, kPhTile, kPhClaims, kPhExist, kPhQuota, kPhTier1, kPhTier2,
  kPhCommit, kPhFresh, kPhContrib, kPhOutputs, kPhases
};
static_assert(kPhases <= kMaxPhases, "one clock slot per phase");

// elements between consecutive scenarios' slices of the batched inputs
// (0: shared by every scenario)
struct Strides {
  long long g_count, cap_ng, n_hcnt, nh_cnt0, g_dprior, dd0, n_tol;
};

// point every batched input, State, Rows and Out buffer at scenario s's
// slice
__device__ void own_slice(const Dims& d, const Strides& sc, long long s,
                          In& in, State& st, Rows& rw, Out& out) {
  const long long N = d.N, NMAX = d.NMAX, R = d.R, K = d.K, V1 = d.V1;
  const long long JH = d.JH, JD = d.JD, P = d.P, T = d.T, G = d.G, W = d.W;
  const long long dom = d.has_domains ? 1 : 0;
  in.g_count += s * sc.g_count;
  in.cap_ng += s * sc.cap_ng;
  in.n_hcnt += s * sc.n_hcnt;
  in.nh_cnt0 += s * sc.nh_cnt0;
  in.g_dprior += s * sc.g_dprior;
  in.dd0 += s * sc.dd0;
  in.n_tol += s * sc.n_tol;
  const long long tiled = d.tiled ? 1 : 0;
  rw.compat += s * tiled * P;
  rw.tok += s * tiled * P * T;
  rw.nfit += s * tiled * P * T;
  rw.cap += s * tiled * N;
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
  // the offering words: a ledger's scenarios each rebuild their own, the
  // others share the launch's one slice (offer_words)
  const long long res = d.NRES ? 1 : 0;
  st.atz += s * res * T * V1 * W;
  st.atc += s * res * dom * T * V1 * W;
  st.toff_pt += s * dom * P * T * V1;
  st.percap += s * dom * NMAX * V1;
  st.c_slot += s * dom * NMAX;
  st.ddc += s * JD * V1;
  st.res_rem += s * d.NRES;
  st.mvcap += s * (d.MV ? NMAX : 0);
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

// A claim's caps for the step: cap_any, its best fit over its masked
// types, and the minValues cap cap_mv, clamped to claim_cap; per domain
// percap for dynamic groups (0 on claims that are not compatible).
__device__ __forceinline__ void settle_caps(const Dims& d, const State& st, const Grp& g, int s,
                                            int32_t cap_any, int32_t cap_mv) {
  int32_t c = min(cap_any, g.hcap);  // open claims carry no prior
  c = min(c, g.count);
  c = min(c, cap_mv);
  c = min(c, h_allow(g, st.ch_cnt[s * d.JH + g.jhc]));
  st.claim_cap[s] = c;
  if (d.MV) st.mvcap[s] = cap_mv;
}

// The minValues caps of a claim-caps chunk's ``nc`` claims ``cl`` for
// group gi into m.mvc, a team a claim (team_minvalues; out of line): over
// each claim's masked types that its template admits, that fit at least
// one pod and that an offering it can take offers (a claim with no
// capacity, m.cbest < 1, takes nothing whatever its cap: none taken)
__device__ __noinline__ void claim_minvalues(const Dims& d, const In& in, const State& st,
                                             const Out& out, const Smem& m, const int32_t* cl,
                                             int nc, int gi) {
  const int T = d.T, R = d.R, V1 = d.V1, W = d.W;
  team_minvalues(
      d, st, m, nc,
      [&](int j) {
        return m.cbest[j] >= 1 ? in.p_mvmin + static_cast<size_t>(out.c_pool[cl[j]]) * d.MV
                               : nullptr;
      },
      [&](int j, int t, int32_t& fit) {
        const int s = cl[j];
        if (!out.c_tmask[static_cast<size_t>(s) * T + t] ||
            !in.type_ok[trow(d, out.c_pool[s], gi) * T + t])
          return false;
        fit = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                         st.c_used + static_cast<size_t>(s) * R, m.req, R);
        const uint32_t* wcz = m.cz + j * 2 * W;
        return fit >= 1 && offer(m.off, claim_atz(d, st, out, s), t, V1, W, wcz, wcz + W);
      },
      [&](int j, int32_t c) { m.mvc[j] = c; });
}

// The claim-side feasibility of the open claims [lo, hi) for group gi
// (c_active, packing.py's claim caps), a window of 1024 slots at a time:
// one thread per slot settles the claims whose template cannot take the
// group, one warp per remaining slot checks the group's keys, and the
// compatible claims are sized kWarps at a time (a domain group's d.cw, the
// rows of m.pcap; scan_layout), warp j working out claim j's words, the
// block's threads sharing the chunk's (claim, type) cells (the best fit by
// shared atomicMax into m.cbest, per domain into m.pcap over the domains
// some offering names), the chunk's minValues caps taken a team a claim
// (team_minvalues), and warp j writing claim j's caps. The maxima do not
// depend on the gathering order, the chunking or the teams. Call after a
// barrier; ends in one. ``kMV``: as fresh_claims' (kMvWarp: warp j takes
// claim j's minValues cap itself).
template <int kMV>
__device__ void claim_caps(const Dims& d, const In& in, const State& st, const Out& out,
                           const Smem& m, const Grp& g, int gi, int lo, int hi) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int T = d.T, R = d.R, V1 = d.V1, W = d.W;
  auto no_domains = [&](int s, int from, int step) {
    if (g.dyn)
      for (int v = from; v < V1; v += step) st.percap[static_cast<size_t>(s) * V1 + v] = 0;
  };
  for (int base = lo; base < hi; base += kThreads) {
    if (tid == 0) m.nlist[0] = m.nlist[1] = 0;
    __syncthreads();
    const int s0 = base + tid;
    if (s0 < hi) {
      const int pp = out.c_pool[s0];
      if (in.p_tol[pp * d.G + gi] && in.compat_pg[trow(d, pp, gi)]) {
        m.cand[atomicAdd(m.nlist + 1, 1)] = s0;
      } else {
        no_domains(s0, 0, 1);
        settle_caps(d, st, g, s0, 0, kBigDom);
      }
    }
    __syncthreads();
    for (int i = wid; i < m.nlist[1]; i += kWarps) {
      const int s = m.cand[i];
      if (warp_claim_compat(d, in, st, out, m, s, gi)) {
        if (lane == 0) m.list[atomicAdd(m.nlist, 1)] = s;
      } else {
        no_domains(s, lane, 32);
        if (lane == 0) settle_caps(d, st, g, s, 0, kBigDom);
      }
    }
    __syncthreads();
    const int n = m.nlist[0];
    const int cw = g.dyn ? d.cw : kWarps;
    for (int c0 = 0; c0 < n; c0 += cw) {
      const int nc = min(cw, n - c0);
      const int32_t* cl = m.list + c0;
      if (wid < nc) {
        warp_claim_words(d, st, m, cl[wid]);
        if (g.dyn)
          for (int v = lane; v < V1; v += 32) m.pcap[wid * V1 + v] = 0;
        if (lane == 0) m.cbest[wid] = 0;
      }
      __syncthreads();
      for (int i = tid; i < nc * T; i += kThreads) {
        const int j = i / T, t = i - j * T, s = cl[j];
        if (!out.c_tmask[static_cast<size_t>(s) * T + t] ||
            !in.type_ok[trow(d, out.c_pool[s], gi) * T + t])
          continue;
        const int32_t af = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                      st.c_used + static_cast<size_t>(s) * R, m.req, R);
        const uint32_t* wcz = m.cz + j * 2 * W;
        const uint32_t* wcc = wcz + W;
        const uint32_t* az = claim_atz(d, st, out, s);
        if (af < 1 || !offer(m.off, az, t, V1, W, wcz, wcc)) continue;
        atomicMax(&m.cbest[j], af);
        if (g.dyn) {
          // a domain no offering names has no offering of any type
          const uint32_t* ac = claim_atc(d, st, out, s);
          const uint32_t* dom = g.dkey == 0 ? m.off.z : m.off.c;
          const int hi = g.dkey == 0 ? m.off.zhi : m.off.chi;
          for (int wv = g.dkey == 0 ? m.off.zlo : m.off.clo; wv < hi; ++wv)
            for (uint32_t b = dom[wv]; b; b &= b - 1) {
              const int v = wv * 32 + __ffs(b) - 1;
              if (offer_in(m.off, az, ac, g.dkey, t, v, V1, W, wcz, wcc))
                atomicMax(&m.pcap[j * V1 + v], af);
            }
        }
      }
      __syncthreads();
      if constexpr (kMV == kMvTeam) {
        if (d.MV) {
          claim_minvalues(d, in, st, out, m, cl, nc, gi);
          __syncthreads();
        }
      }
      if (wid < nc) {
        const int s = cl[wid];
        const int32_t best = m.cbest[wid];
        int32_t cap_mv = kBigDom;
        // a claim with no capacity takes nothing whatever its cap
        if constexpr (kMV == kMvTeam) {
          if (d.MV && best >= 1) cap_mv = m.mvc[wid];
        } else if constexpr (kMV == kMvWarp) {
          if (d.MV && best >= 1) {
            const int pp = out.c_pool[s];
            const uint8_t* tok = in.type_ok + trow(d, pp, gi) * T;
            const uint8_t* tms = out.c_tmask + static_cast<size_t>(s) * T;
            const float* used = st.c_used + static_cast<size_t>(s) * R;
            const uint32_t* wcz = m.cz + wid * 2 * W;
            const uint32_t* wcc = wcz + W;
            const uint32_t* az = claim_atz(d, st, out, s);
            cap_mv = warp_minvalues(d, st, m, in.p_mvmin + static_cast<size_t>(pp) * d.MV,
                                    [&](int t, int32_t& fit) {
                                      if (!tms[t] || !tok[t]) return false;
                                      fit = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                                       used, m.req, R);
                                      return fit >= 1 && offer(m.off, az, t, V1, W, wcz, wcc);
                                    });
          }
        }
        if (g.dyn)
          for (int v = lane; v < V1; v += 32)
            st.percap[static_cast<size_t>(s) * V1 + v] = m.pcap[wid * V1 + v];
        if (lane == 0) settle_caps(d, st, g, s, best, cap_mv);
      }
      __syncthreads();
    }
  }
}

// ``kMV``: the minValues path it is built with (MvPath; mv_path)
template <int kMV>
__global__ void __launch_bounds__(kThreads, 1)
pack_scan(Dims d, In in0, State st0, Rows rw0, Out out0, Strides sc, int ranks) {
  // this block's scenario slices, kept in shared memory rather than in
  // registers, which the 1024-thread launch bound already holds to 64
  __shared__ In in;
  __shared__ State st;
  __shared__ Rows rw;
  __shared__ Out out;
  __shared__ Smem m;
  __shared__ Grp g;
  __shared__ RedBufs red;
  __shared__ float s_debit[32];
  // rank 0's open claims after each step, read by the other ranks
  __shared__ int32_t s_open;
  extern __shared__ __align__(16) unsigned char dyn[];
  PHASE_START;
  // ranks: the blocks of this launch's clusters, uniform over the grid
  const int rank = ranks > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const bool lead = rank == 0;
  if (threadIdx.x == 0) {
    in = in0;
    st = st0;
    rw = rw0;
    out = out0;
    own_slice(d, sc, blockIdx.x / ranks, in, st, rw, out);
    use_rows(d, in, rw);
    carve(dyn, d, m, st0.spill);
  }
  __syncthreads();
  load_offered(d, st, m);
  Shared sh{&red, 0};
  const int G = d.G, N = d.N, R = d.R, V1 = d.V1, JH = d.JH;
  const int tid = threadIdx.x;

  if (lead) init_state(d, in, st, out);
  int32_t n_open = 0;
  bool overflow = false;
  cluster_sync(ranks);
  PHASE_MARK(kPhInit);

  for (int gi = 0; gi < G; ++gi) {
    // padded / empty groups place nothing and mutate nothing; their
    // output rows keep the wrapper's zeros
    if (in.g_count[gi] <= 0) continue;
    if (tid == 0) load_group(d, in, gi, gi, in.g_dkey[gi], g);
    load_rows(d, in, gi, m);
    __syncthreads();
    PHASE_MARK(kPhLoad);
    if (d.tiled) {
      tile_rows(d, in, rw, m, gi, rank, ranks);
      cluster_sync(ranks);
    }
    PHASE_MARK(kPhTile);
    if (lead) {
      if (g.dyn || d.NRES) template_words(d, in, m, gi);
      if (g.dyn) {
        const bool has_d = g.has_d;
        for (int v = tid; v < V1; v += kThreads)
          m.D0[v] = wrap_add(in.g_dprior[static_cast<size_t>(gi) * V1 + v],
                             has_d ? st.ddc[static_cast<size_t>(min(g.jd, d.JD - 1)) * V1 + v] : 0);
        template_domains(d, in, st, m, gi, g.dkey);
      }
    }
    PHASE_MARK(kPhQuota);

    // ---- claim-side feasibility over this rank's share of the live
    // claims (slots past n_open keep init_state's) ----
    int lo, hi;
    rank_share(n_open, rank, ranks, lo, hi);
    claim_caps<kMV>(d, in, st, out, m, g, gi, lo, hi);
    cluster_sync(ranks);
    PHASE_MARK(kPhClaims);

    int32_t placed_exist = 0;
    if (lead) {
      // node caps at the current load, the group's per-entity caps
      for (int n = tid; n < N; n += kThreads) {
        int32_t ec = in.cap_ng[tcap(d, n, gi)] > 0
                         ? fits_count(in.n_avail + static_cast<size_t>(n) * R,
                                      st.exist_used + static_cast<size_t>(n) * R, m.req, R)
                         : 0;
        ec = min(ec, max(wrap_sub(g.hcap, in.n_hcnt[static_cast<size_t>(n) * G + gi]), 0));
        ec = min(ec, h_allow(g, st.nhc[n * JH + g.jhc]));
        st.exist_cap[n] = ec;
      }
      __syncthreads();
      const bool haff_exist_served = haff_pin_nodes(d, in, g, st.exist_cap, sh);
      PHASE_MARK(kPhExist);
      if (g.dyn)
        domain_quota(d, in, st, out, m, g, st.exist_cap, false, n_open, sh);
      else
        any_quota(d, m, g.count);
      PHASE_MARK(kPhQuota);
      placed_exist = tier1_fill(d, in, st, out, m, g, st.exist_cap, haff_exist_served, sh);
      PHASE_MARK(kPhTier1);
      if (g.dyn)
        tier2_domains(d, st, m, g, false, n_open, sh);
      else
        tier2_any(d, st, m, g, false, n_open, sh);
    }
    cluster_sync(ranks);
    PHASE_MARK(kPhTier2);
    commit_claims(d, in, st, out, m, g, true, lo, hi);
    cluster_sync(ranks);
    PHASE_MARK(kPhCommit);
    if (lead) {
      fresh_claims<kMV>(d, in, st, out, m, g, n_open, overflow, NoBulkHook{}, sh, s_debit);
      spread_carry(d, st, m, g);
      __syncthreads();
      PHASE_MARK(kPhFresh);
      if (d.has_contrib) contrib_counts(d, in, st, out, m, g, n_open);
      PHASE_MARK(kPhContrib);
      group_outputs(d, st, out, g, placed_exist, n_open, sh);
      if (tid == 0) s_open = n_open;
    }
    // the step's state, and rank 0's open claims, before the next step
    cluster_sync(ranks);
    if (ranks > 1 && !lead) n_open = *cg::this_cluster().map_shared_rank(&s_open, 0);
    PHASE_MARK(kPhOutputs);
  }
  if (lead && tid == 0) {
    out.n_open[0] = n_open;
    out.overflow[0] = overflow;
  }
  // rank 0's shared memory outlives the other ranks' last read of it
  if (ranks > 1) cg::this_cluster().sync();
}

}  // namespace

extern "C" int kt_pack(
    int S, int G, int T, int P, int N, int R, int K, int V1, int NMAX, int JH,
    int JD, int MV, int MW, int NRES, int O, int zone_kid, int ct_kid, int wf_iters,
    int has_domains, int has_contrib, int tiled,
    // scenario strides of the batched inputs (0: shared)
    long long s_g_count, long long s_cap_ng, long long s_n_hcnt,
    long long s_nh_cnt0, long long s_g_dprior, long long s_dd0, long long s_n_tol,
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
    // minValues tables, the reservation ledger
    const int32_t* p_mvmin, const uint8_t* t_mvoh, const int32_t* res_cap0,
    const uint8_t* a_res,
    // the tiled mode's row inputs
    const uint8_t* p_def, const uint8_t* p_neg, const uint8_t* p_titype_ok,
    const uint8_t* t_def, const uint8_t* t_mask, const uint8_t* o_avail,
    const int32_t* o_zone, const int32_t* o_ct, const uint8_t* n_def,
    const uint8_t* n_mask, const uint8_t* n_tol,
    // state + scratch
    float* exist_used, float* c_used, int32_t* c_npods, uint8_t* c_def,
    uint8_t* c_neg, uint8_t* c_mask, int32_t* ch_cnt, int32_t* nhc,
    float* pool_rem, int32_t* exist_cap, int32_t* claim_cap,
    int32_t* claim_fill, uint8_t* avail, uint32_t* atz,
    uint32_t* atc, uint8_t* toff_pt, int32_t* percap, int32_t* c_slot,
    int32_t* ddc, int32_t* res_rem, int32_t* mvcap,
    // word tables shared by the scenarios; the offered zones and
    // capacity types [2, W] (offer_words; zeroed by the caller)
    uint32_t* mvw, uint32_t* ares_z, uint32_t* aheld_z, uint32_t* aheld_c,
    uint32_t* offered,
    // the tiled rows, S slices, and the shared mask words
    // (empty untiled)
    uint8_t* r_compat, uint8_t* r_tok, int32_t* r_nfit, int32_t* r_cap,
    uint32_t* tw, uint32_t* pw, uint32_t* nw,
    // outputs
    int32_t* c_pool, uint8_t* c_tmask, int32_t* n_open, uint8_t* overflow,
    int32_t* exist_fills, int32_t* claim_fills, int32_t* unplaced,
    int32_t* c_dzone, int32_t* c_dct, uint8_t* c_resv,
    // the spill scratch (csrc/pack_common.cuh:layout_info; empty where
    // Smem fits shared memory) and its bytes
    unsigned char* spill, long long spill_n,
    // out (host, may be null): the cluster's blocks, how many clusters of
    // that size and of 8 blocks the card holds at once with the scan's
    // shared memory
    int* cluster,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (R > 32 || JH < 1 || JD < 1 || (MV && (MW < 1 || MW > 32 * 0xffff)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return kt::kNothingLaunched;
  const int W = (V1 + 31) / 32;
  Dims d{G, T, P, N, R, K, V1, NMAX, JH, JD, zone_kid, ct_kid, wf_iters, W,
         has_domains != 0, has_contrib != 0, MV, MW, (MW + 31) / 32, NRES,
         O, tiled != 0};
  In in{g_count, g_req, g_def, g_neg, g_mask, g_hcap, g_haff, g_hstg, g_hscap,
        g_hself, compat_pg, type_ok, n_fit, cap_ng, t_alloc, t_cap, a_tzc,
        p_daemon, p_limit, p_has_limit, p_tol, n_avail, n_base, n_hcnt,
        nh_cnt0, well_known, g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior,
        g_dreg, g_drank, g_dtg, p_mask, n_dzone, n_dct, dd0,
        g_hcontrib, g_dcontrib, dtg_key, p_mvmin, t_mvoh, res_cap0, a_res,
        p_def, p_neg, p_titype_ok, t_def, t_mask, o_avail, o_zone, o_ct,
        n_def, n_mask, n_tol};
  Rows rw{r_compat, r_tok, r_nfit, r_cap, tw, pw, nw};
  State st{exist_used, c_used, c_npods, c_def, c_neg, c_mask, ch_cnt, nhc,
           pool_rem, exist_cap, claim_cap, claim_fill, avail, atz,
           atc, toff_pt, percap, c_slot, ddc, res_rem, mvcap,
           mvw, ares_z, aheld_z, aheld_c, offered, offered + W};
  Out out{c_pool, c_tmask, n_open, overflow, exist_fills, claim_fills,
          unplaced, c_dzone, c_dct, c_resv};
  Strides sc{s_g_count, s_cap_ng, s_n_hcnt, s_nh_cnt0, s_g_dprior, s_dd0, s_n_tol};
  // Smem's layout, before anything launches
  size_t smem = 0;
  // (the instantiations differ in code only, not in their static shared memory)
  const int rc = scan_smem(pack_scan<kMvNone>, d, st, S, kMaxCluster, spill, spill_n, smem);
  if (rc) return rc;
  {
    // the starting ledger's offering words across the card: a slice per
    // scenario under a ledger, else one for all
    const long long cells = static_cast<long long>(T) * V1 * W;
    offer_words<<<offer_blocks(cells), 256, 0, stream>>>(d, in, st, NRES ? S : 1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (MV || NRES) {
    static_words<<<132, 256, 0, stream>>>(d, in, st);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (tiled) {
    tile_words<<<132, 256, 0, stream>>>(d, in, rw);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // one cluster of c blocks per scenario (pick_cluster)
  const int path = mv_path(d);
  const auto kernel = path == kMvNone   ? pack_scan<kMvNone>
                      : path == kMvWarp ? pack_scan<kMvWarp>
                                        : pack_scan<kMvTeam>;
  return launch_clusters(kernel, kMaxCluster, S, smem, stream, cluster, d, in, st, rw, out,
                         sc);
}

// kt_pack's layout at these shapes (pack_common.cuh:layout_info): its
// dynamic shared memory and spill scratch bytes into ``out`` [2].
extern "C" int kt_pack_layout(int S, int P, int R, int K, int V1, int MV, int MW, int NRES,
                              int has_domains, int has_contrib, long long* out) {
  Dims d{};
  d.P = P, d.R = R, d.K = K, d.V1 = V1, d.W = (V1 + 31) / 32, d.MV = MV, d.MW = MW;
  d.NRES = NRES, d.has_domains = has_domains != 0, d.has_contrib = has_contrib != 0;
  return layout_info(pack_scan<kMvNone>, d, S, kMaxCluster, out);
}

#ifdef KT_PHASE_CLOCKS
// The first ``n`` phase clocks' totals in nanoseconds (Phase order) into
// ``host``, then zeroed; synchronous. Returns cudaGetLastError().
extern "C" int kt_pack_phase_clocks(unsigned long long* host, int n) {
  return read_phase_clocks(host, n);
}
#endif
