// Kernel B5: the class-batched packing scan.
//
// Replaces karpenter_tpu/ops/packing.py:pack_classed (a lax.scan over
// feasibility classes on the TPU, class body packing.py:1342): tables or
// the tiled mode, with or without domains, contributor counting and
// minValues floors; no reservation ledger, which pack_classed never
// takes (the driver routes such batches to B4). The
// driver routes a batch here when its groups share few feasibility
// classes (the reference's diverse mix: ~1,900 groups in ~30 classes).
//
// Bound on the H100: latency, as B4's. One persistent thread-block cluster
// of up to kMaxCluster blocks of 1024 threads walks the classes in order (a
// class step depends on the last one) and, inside each, its member groups
// in order. What batching buys is the class head: the tables that depend
// only on the class (requests, masks and tolerations are identical across
// its members) are built once into device scratch the wrapper allocates:
// the claims' fit counts af0 [NMAX, T], offering rows off0 [NMAX, T] and,
// for a dynamic class, their per-domain offering table toff_nt0 [NMAX, T,
// V1]; the templates' toff_pt [P, T, V1]; the group-mask rows off_grp [T] /
// toff_grp [T, V1] that a claim opened in the class carries. A member then
// reads only per-claim summaries (capv [NMAX], and per domain State's
// percap [NMAX, V1], which tier 2 and the quota read as they are) and
// maintains them by exact integer decrements (every member requests the
// same vector, so a fill of k lowers every fit count by exactly k:
// quantized requests are integer-valued float32 below 2^24); claims opened
// in the class take their summaries in closed form, pinned claims collapse
// to their lane. minValues (MV > 0; packing.py:1526-1536, :1728, :1861,
// :1891-1903, :2021-2026) rides the same discipline: the head computes each
// live claim's minValues headroom (warp_minvalues or team_minvalues, by
// the launch's MvPath, over its masked types, into st.mvcap), a member's
// fill lowers it by exactly the fill, and a
// claim opened in the class starts at its bulk template's cap less its
// take. The claims' type masks settle once per class against the final
// pins and the class-total fills. Every phase a member runs (existing
// nodes, the domain quota, tier 2, the fresh-claim bulks, the carries,
// contributor counting) is pack_common.cuh's, shared with kernel B4, with
// pack_classed's waterfill1 where it uses one.
//
// The claim axis runs to the open claims (n_open), never NMAX
// (pack_common.cuh: the live extent): the head, the claim caps, the
// summary maintenance and the settlement walk [0, n_open). The head works
// only for the claims that can take the class (head_claims): the others
// get zero summaries and no type walk; the live ones are gathered and
// their (claim, type) cells spread over the block, each claim's best fits
// kept by integer atomicMax (exact in any order). The cluster shares the
// per-claim work as B4's does: each rank takes a contiguous share of the
// open claims for the head, commit_claims, the summary maintenance and the
// settlement, and of the types for the class rows (tile_rows, off_grp);
// the existing nodes, the quota, tier 1, tier 2, the fresh-claim bulks,
// contributor counting and the outputs run on rank 0 while the others wait
// at the cluster barrier, whose release / acquire order the state one rank
// writes before another reads it. A member costs two such barriers: after
// tier 2, and after the commits, the summaries and rank 0's bulks (which
// touch only the slots they open); rank 0 then counts contributors and
// writes the member's outputs while the others go on to the next member's
// first barrier or to the settlement, which read none of it. Each rank
// loads the class's rows into its own shared memory, and reads rank 0's
// claim count after each member through distributed shared memory.
//
// Fills go straight into the group rows class_start + m (the TPU's [C,
// lmax] member buffers and their inv_idx gather are a layout, not part of
// the function); rows of groups that place nothing, and the columns past
// the live claims, keep the wrapper's zeros.
//
// The tiled mode (tiled; packing.py:1335, :1347-1385): the class head
// builds the class's feasibility rows once (tile_rows, pack_common.cuh)
// into the Rows scratch, and every member and the end-of-class settlement
// read them, as JAX computes them once per class.
#include "pack_common.cuh"

namespace {

// The most blocks in the cluster that walks the classes: 8, the portable
// maximum, was fastest at all three shapes of the A/B over 1, 2, 4 and 8
// (PERF.md §6). With S = 1 pick_cluster takes it whenever one such
// cluster fits, and refuses the launch with kClusterUnplaced when none
// does. tenant_scan.py's A/B builds set it with -DKT_MAX_CLUSTER.
#ifdef KT_MAX_CLUSTER
constexpr int kMaxCluster = KT_MAX_CLUSTER;
#else
constexpr int kMaxCluster = 8;
#endif

// the phase clocks' slots (pack_common.cuh: KT_PHASE_CLOCKS)
enum Phase {
  kPhInit, kPhHead, kPhExist, kPhQuota, kPhTier1, kPhTier2, kPhCommit, kPhSummaries,
  kPhFresh, kPhContrib, kPhOutputs, kPhSettle, kPhases
};
static_assert(kPhases <= kMaxPhases, "one clock slot per phase");

struct Classes {
  const int32_t* start; const int32_t* len; const uint8_t* dyn; const int32_t* dkey;
  int C;
};

// the class head tables and per-claim summaries (device scratch; the
// per-domain summaries are State's percap)
struct Head {
  int32_t* capv; int32_t* af0; uint8_t* off0; uint8_t* toff_nt0; int32_t* cfills;
  int32_t* pin0; uint8_t* off_grp; uint8_t* toff_grp; int32_t* e_cap;
};

// a fresh-claim bulk's effect on the maintained summaries of the claims
// it opens (packing.py:1997-2030): capv = n_fit_max - take; percap from
// the group-mask availability toff_grp, pinned bulks to their lane; af0 =
// n_fit - take; cfills 0
struct ClassedBulkHook {
  const Head* h;  // the kernel's shared copy
  int32_t* pmax;  // [V1] shared: the bulk template's best fit per domain
  int32_t* percap;  // [NMAX, V1] the maintained per-domain summaries
  int32_t* mvcap;  // [NMAX] the maintained minValues headroom
  const uint32_t* offered;  // [W] the class axis's offered values (Offered)
  int T, V1;
  bool has_domains, cdyn, mv;
  __device__ void trip(const uint8_t* av, const int32_t* nf, int, Shared& sh) const {
    if (!has_domains) return;
    for (int v = 0; v < V1; ++v) {
      // toff_grp has no offering in a domain no offering names: its best
      // is 0 without a reduction (the branch is the same on every thread)
      if (!bit(offered, v)) {
        if (threadIdx.x == 0) pmax[v] = 0;
        continue;
      }
      int32_t best = 0;
      if (cdyn)
        for (int t = threadIdx.x; t < T; t += kThreads)
          if (av[t] && h->toff_grp[static_cast<size_t>(t) * V1 + v]) best = max(best, nf[t]);
      best = block_max(best, sh);
      if (threadIdx.x == 0) pmax[v] = best;
    }
    __syncthreads();
  }
  __device__ void open(int s, int32_t take, int32_t n_fit_max, int d_pin, int32_t mv_open) const {
    h->capv[s] = wrap_sub(n_fit_max, take);
    if (mv) mvcap[s] = wrap_sub(mv_open, take);
    if (has_domains)
      for (int v = 0; v < V1; ++v) {
        const int32_t p = max(wrap_sub(pmax[v], take), 0);
        percap[static_cast<size_t>(s) * V1 + v] = (d_pin >= 0 && v != d_pin) ? 0 : p;
      }
    h->cfills[s] = 0;
  }
  __device__ void cell(int s, int t, int32_t take, int32_t nf_t) const {
    h->af0[static_cast<size_t>(s) * T + t] = wrap_sub(nf_t, take);
  }
};

// The minValues headroom mvcapv0 of a head chunk's ``nc`` claims ``cl``
// into m.mvc, a team a claim (team_minvalues; out of line): over each
// claim's masked types that class head ``cs``'s template row admits and
// that it can take an offering of (hd.off0), at its fits hd.af0 (a claim
// with no capacity, m.cbest < 1, never takes a pod this class, so its
// headroom is never read: none taken)
__device__ __noinline__ void head_minvalues(const Dims& d, const In& in, const State& st,
                                            const Out& out, const Smem& m, const Head& hd,
                                            const int32_t* cl, int nc, int cs) {
  const int T = d.T;
  team_minvalues(
      d, st, m, nc,
      [&](int j) {
        return m.cbest[j] >= 1 ? in.p_mvmin + static_cast<size_t>(out.c_pool[cl[j]]) * d.MV
                               : nullptr;
      },
      [&](int j, int t, int32_t& fit) {
        const int s = cl[j];
        const size_t at = static_cast<size_t>(s) * T + t;
        fit = hd.af0[at];
        return out.c_tmask[at] && in.type_ok[trow(d, out.c_pool[s], cs) * T + t] &&
               hd.off0[at];
      },
      [&](int j, int32_t c) { m.mvc[j] = c; });
}

// The class head for the open claims [lo, hi) (packing.py:1343-1541),
// class ``cs`` (the head's table column) on axis ``cdk``: each claim's
// compatibility with the class and, for a compatible ("live") claim, its
// fit counts af0 and offering rows off0 (toff_nt0 per domain for a dynamic
// class ``cdyn``) over the T types, and its summaries: its best fit over
// its masked types (type mask ∧ type_ok ∧ offering) in capv, per domain in
// st.percap, its minValues headroom in st.mvcap, cfills 0 and its pin on
// the axis at the head, pin0.
//
// A claim the class cannot take skips the type walk; it gets zero
// summaries only: capv 0, percap 0, cfills 0, mvcap 0 and pin0. That is
// exact: with capv 0 (domain-free members) and percap 0 (dynamic members)
// its tier-2 cap is 0 in every member of the class, so it takes no fill
// (a water-fill hands nothing to a slot of cap 0; the hostname-affinity
// and single-pod picks, and the affinity anchor, need a cap >= 1); it is
// never committed, so its requirements never change and it cannot become
// compatible later in the class; its cfills stay 0 and the settlement
// skips it at cf <= 0. Its af0 / off0 / toff_nt0 rows are read only by
// the settlement and by a live claim's minValues headroom, never for it,
// and stay unwritten. (The walk it skips gave it its best fits, which
// every reader masked to 0 by its liveness: the zeros are that masking.)
//
// A window of 1024 slots at a time: one thread per slot settles the
// claims whose template cannot take the class (under a tenant taint,
// every claim of another tenant), one warp per remaining slot checks the
// class's keys, and the live claims are sized kWarps at a time (a domain
// class's d.cw, the rows of m.pcap; scan_layout), warp j
// working out claim j's words, the block's threads sharing the chunk's
// (claim, type) cells (the best fit by shared atomicMax into m.cbest, per
// domain into m.pcap), the chunk's minValues headroom taken a team a
// claim (head_minvalues), and warp j writing claim j's summaries. Call
// after a barrier; ends in one. ``kMV``: as fresh_claims' (kMvWarp: warp
// j takes claim j's minValues headroom itself).
template <int kMV>
__device__ void head_claims(const Dims& d, const In& in, const State& st, const Out& out,
                            const Smem& m, const Head& hd, int cs, int cdk, bool cdyn, int lo,
                            int hi) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int T = d.T, R = d.R, V1 = d.V1, W = d.W;
  const int32_t* pin_axis = cdk == 0 ? out.c_dzone : out.c_dct;
  // a claim the class cannot take: its summaries (the lanes of the
  // caller from ``from`` by ``step``; the scalars by the one at 0)
  auto dead = [&](int s, int from, int step) {
    if (d.has_domains)
      for (int v = from; v < V1; v += step) st.percap[static_cast<size_t>(s) * V1 + v] = 0;
    if (from == 0) {
      hd.capv[s] = 0;
      hd.cfills[s] = 0;
      hd.pin0[s] = pin_axis[s];
      if (d.MV) st.mvcap[s] = 0;
    }
  };
  for (int base = lo; base < hi; base += kThreads) {
    if (tid == 0) m.nlist[0] = m.nlist[1] = 0;
    __syncthreads();
    const int s0 = base + tid;
    if (s0 < hi) {
      const int pp = out.c_pool[s0];
      if (in.p_tol[pp * d.G + cs] && in.compat_pg[trow(d, pp, cs)])
        m.cand[atomicAdd(m.nlist + 1, 1)] = s0;
      else
        dead(s0, 0, 1);
    }
    __syncthreads();
    for (int i = wid; i < m.nlist[1]; i += kWarps) {
      const int s = m.cand[i];
      if (warp_claim_compat(d, in, st, out, m, s, cs)) {
        if (lane == 0) m.list[atomicAdd(m.nlist, 1)] = s;
      } else {
        dead(s, lane, 32);
      }
    }
    __syncthreads();
    const int n = m.nlist[0];
    const int cw = cdyn ? d.cw : kWarps;
    for (int c0 = 0; c0 < n; c0 += cw) {
      const int nc = min(cw, n - c0);
      const int32_t* cl = m.list + c0;
      if (wid < nc) {
        warp_claim_words(d, st, m, cl[wid]);
        if (cdyn)
          for (int v = lane; v < V1; v += 32) m.pcap[wid * V1 + v] = 0;
        if (lane == 0) m.cbest[wid] = 0;
      }
      __syncthreads();
      for (int i = tid; i < nc * T; i += kThreads) {
        const int j = i / T, t = i - j * T, s = cl[j];
        const size_t st_i = static_cast<size_t>(s) * T + t;
        const uint32_t* wcz = m.cz + j * 2 * W;
        const uint32_t* wcc = wcz + W;
        const int32_t af = fits_count(in.t_alloc + static_cast<size_t>(t) * R,
                                      st.c_used + static_cast<size_t>(s) * R, m.req, R);
        const bool o = offer(m.off, st.atz, t, V1, W, wcz, wcc);
        hd.af0[st_i] = af;
        hd.off0[st_i] = o;
        const bool tm = out.c_tmask[st_i] && in.type_ok[trow(d, out.c_pool[s], cs) * T + t] && o;
        if (tm) atomicMax(&m.cbest[j], af);
        if (cdyn)
          for (int v = 0; v < V1; ++v) {
            const bool od = offer_in(m.off, st.atz, st.atc, cdk, t, v, V1, W, wcz, wcc);
            hd.toff_nt0[st_i * V1 + v] = od;
            if (tm && od) atomicMax(&m.pcap[j * V1 + v], af);
          }
      }
      __syncthreads();
      if constexpr (kMV == kMvTeam) {
        if (d.MV) {
          head_minvalues(d, in, st, out, m, hd, cl, nc, cs);
          __syncthreads();
        }
      }
      if (wid < nc) {
        const int s = cl[wid];
        const int32_t best = m.cbest[wid];
        int32_t mvc = 0;
        if constexpr (kMV == kMvTeam) {
          if (d.MV && best >= 1) mvc = m.mvc[wid];
        } else if constexpr (kMV == kMvWarp) {
          if (d.MV && best >= 1) {
            const size_t row = static_cast<size_t>(s) * T;
            const uint8_t* tok = in.type_ok + trow(d, out.c_pool[s], cs) * T;
            mvc = warp_minvalues(d, st, m, in.p_mvmin + static_cast<size_t>(out.c_pool[s]) * d.MV,
                                 [&](int t, int32_t& fit) {
                                   fit = hd.af0[row + t];
                                   return out.c_tmask[row + t] && tok[t] && hd.off0[row + t];
                                 });
          }
        }
        if (d.has_domains)
          for (int v = lane; v < V1; v += 32)
            st.percap[static_cast<size_t>(s) * V1 + v] = cdyn ? m.pcap[wid * V1 + v] : 0;
        if (lane == 0) {
          if (d.MV) st.mvcap[s] = mvc;
          hd.capv[s] = best;
          hd.cfills[s] = 0;
          hd.pin0[s] = pin_axis[s];
        }
      }
      __syncthreads();
    }
  }
}

// The end-of-class type-mask settlement (packing.py:2160-2191) of the
// open claims [lo, hi): one intersection with the final pins and the
// class-total fills, for each claim the class filled (cfills > 0; claims
// opened before the class at or past ``n_open0`` are new): type_ok of the
// claim's template ∧ its offering row (head row; at a pin taken in the
// class, the head's per-domain row; for a claim opened in the class, the
// group-mask row) ∧ fit >= class fills. The filled claims are gathered a
// window of 1024 slots at a time and their (claim, type) cells spread
// over the block. Call after a barrier; ends in one.
__device__ void settle_class(const Dims& d, const In& in, const Out& out, const Smem& m,
                             const Head& hd, int cs, int cdk, bool cdyn, int n_open0, int lo,
                             int hi) {
  const int tid = threadIdx.x, T = d.T, V1 = d.V1;
  const int32_t* pin_axis = cdk == 0 ? out.c_dzone : out.c_dct;
  for (int base = lo; base < hi; base += kThreads) {
    if (tid == 0) m.nlist[0] = 0;
    __syncthreads();
    if (base + tid < hi && hd.cfills[base + tid] > 0) m.list[atomicAdd(m.nlist, 1)] = base + tid;
    __syncthreads();
    const long long cells = static_cast<long long>(m.nlist[0]) * T;
    for (long long i = tid; i < cells; i += kThreads) {
      const int s = m.list[i / T], t = static_cast<int>(i % T);
      const int32_t cf = hd.cfills[s];
      const bool is_new = s >= n_open0;
      const int32_t pin_rel = pin_axis[s];
      const int pinc = min(max(pin_rel, 0), V1 - 1);
      const bool newpin = pin_rel >= 0 && pin_rel != hd.pin0[s] && !is_new;
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
      if (!(in.type_ok[trow(d, out.c_pool[s], cs) * T + t] && off && hd.af0[st_i] >= cf))
        out.c_tmask[st_i] = 0;
    }
    __syncthreads();
  }
}

// ``kMV``: the minValues path it is built with (MvPath; mv_path)
template <int kMV>
__global__ void __launch_bounds__(kThreads, 1)
pack_classed_scan(Dims d, In in0, State st0, Rows rw0, Out out0, Classes cls0, Head hd0,
                  int ranks) {
  __shared__ In in;
  __shared__ State st;
  __shared__ Rows rw;
  __shared__ Out out;
  __shared__ Classes cls;
  __shared__ Head hd;
  __shared__ Smem m;
  __shared__ Grp g;
  __shared__ RedBufs red;
  __shared__ float s_debit[32];
  // rank 0's open claims after each member, read by the other ranks
  __shared__ int32_t s_open;
  extern __shared__ __align__(16) unsigned char dyn[];
  PHASE_START;
  // ranks: the blocks of the cluster
  const int rank = ranks > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const bool lead = rank == 0;
  if (threadIdx.x == 0) {
    in = in0;
    st = st0;
    rw = rw0;
    use_rows(d, in, rw);
    out = out0;
    cls = cls0;
    hd = hd0;
    carve(dyn, d, m, st0.spill);
  }
  __syncthreads();
  load_offered(d, st, m);
  Shared sh{&red, 0};
  const int G = d.G, T = d.T, N = d.N, R = d.R, V1 = d.V1, JH = d.JH, W = d.W;
  const int tid = threadIdx.x;

  if (lead) init_state(d, in, st, out);
  int32_t n_open = 0;
  bool overflow = false;
  cluster_sync(ranks);
  PHASE_MARK(kPhInit);

  for (int ci = 0; ci < cls.C; ++ci) {
    const int cl = cls.len[ci];
    if (cl <= 0) continue;  // a class of padding groups: skipped whole
    const int cs = cls.start[ci];
    const bool cdyn = d.has_domains && cls.dyn[ci];
    const int cdk = cls.dkey[ci];

    // ---- class-invariant head tables (packing.py:1343-1541) ----
    // each rank: the class's rows in its own shared memory, its share of
    // the tiled rows and of the group-mask rows
    load_rows(d, in, cs, m);
    __syncthreads();
    if (d.tiled) {
      tile_rows(d, in, rw, m, cs, rank, ranks);
      cluster_sync(ranks);
    }
    int lo, hi;
    rank_share(T, rank, ranks, lo, hi);
    for (int t = lo + tid; t < hi; t += kThreads) {
      hd.off_grp[t] = offer(m.off, st.atz, t, V1, W, m.gz, m.gc);
      if (cdyn)
        for (int v = 0; v < V1; ++v)
          hd.toff_grp[static_cast<size_t>(t) * V1 + v] =
              offer_in(m.off, st.atz, st.atc, cdk, t, v, V1, W, m.gz, m.gc);
    }
    // rank 0's own tables: the templates' per-domain offerings (the bulks
    // and the quota), the existing nodes' caps
    if (lead) {
      if (cdyn) {
        template_words(d, in, m, cs);
        template_domains(d, in, st, m, cs, cdk);
      }
      for (int n = tid; n < N; n += kThreads)
        st.exist_cap[n] = in.cap_ng[tcap(d, n, cs)] > 0
                              ? fits_count(in.n_avail + static_cast<size_t>(n) * R,
                                           st.exist_used + static_cast<size_t>(n) * R, m.req, R)
                              : 0;
    }
    // each rank's share of the open claims: compatibility, fit counts,
    // offering rows and capacity summaries
    rank_share(n_open, rank, ranks, lo, hi);
    head_claims<kMV>(d, in, st, out, m, hd, cs, cdk, cdyn, lo, hi);
    const int32_t n_open0 = n_open;
    cluster_sync(ranks);
    PHASE_MARK(kPhHead);

    // ---- the member groups, in FFD order (packing.py:1543) ----
    for (int j = 0; j < cl; ++j) {
      const int gi = cs + j;
      if (in.g_count[gi] <= 0) continue;
      if (tid == 0) load_group(d, in, gi, cs, cdk, g);
      __syncthreads();
      int32_t placed_exist = 0;
      if (lead) {
        if (g.dyn)
          for (int v = tid; v < V1; v += kThreads)
            m.D0[v] = wrap_add(in.g_dprior[static_cast<size_t>(gi) * V1 + v],
                               g.has_d ? st.ddc[static_cast<size_t>(min(g.jd, d.JD - 1)) * V1 + v] : 0);
        for (int n = tid; n < N; n += kThreads) {
          int32_t ec = min(st.exist_cap[n],
                           max(wrap_sub(g.hcap, in.n_hcnt[static_cast<size_t>(n) * G + gi]), 0));
          hd.e_cap[n] = min(ec, h_allow(g, st.nhc[n * JH + g.jhc]));
        }
        __syncthreads();
        const bool haff_exist_served = haff_pin_nodes(d, in, g, hd.e_cap, sh);
        PHASE_MARK(kPhExist);
        // the quota and tier 2 read the maintained summaries as they are:
        // st.percap is 0 on claims the class cannot take
        if (g.dyn)
          domain_quota(d, in, st, out, m, g, hd.e_cap, true, n_open, sh);
        else
          any_quota(d, m, g.count);
        PHASE_MARK(kPhQuota);
        placed_exist = tier1_fill(d, in, st, out, m, g, hd.e_cap, haff_exist_served, sh);
        // same-request decrement: exact
        for (int n = tid; n < N; n += kThreads)
          st.exist_cap[n] =
              wrap_sub(st.exist_cap[n], out.exist_fills[static_cast<size_t>(gi) * N + n]);
        PHASE_MARK(kPhTier1);

        // ---- 2. open claims, from the maintained summaries ----
        if (g.dyn) {
          tier2_domains(d, st, m, g, g.count <= 1, n_open, sh);
        } else {
          // capv is 0 on claims the class cannot take
          for (int s = tid; s < n_open; s += kThreads) {
            int32_t c = min(hd.capv[s], g.hcap);
            c = min(c, g.count);
            if (d.MV) c = min(c, st.mvcap[s]);
            st.claim_cap[s] = min(c, h_allow(g, st.ch_cnt[s * JH + g.jhc]));
          }
          __syncthreads();
          tier2_any(d, st, m, g, true, n_open, sh);
        }
      }
      // the fills and domain slots of tier 2
      cluster_sync(ranks);
      PHASE_MARK(kPhTier2);
      // each rank's share of the claims tier 2 filled; rank 0 then opens
      // the bulks, whose slots lie past every share (the claims opened
      // before them are not read or written there)
      rank_share(n_open, rank, ranks, lo, hi);
      commit_claims(d, in, st, out, m, g, false, lo, hi);
      PHASE_MARK(kPhCommit);
      // summary maintenance: exact decrements, then a pin zeroes the other
      // lanes and collapses capv to the pinned one; the minValues headroom
      // drops by the fill
      for (int s = lo + tid; s < hi; s += kThreads) {
        const int32_t f = st.claim_fill[s];
        if (f == 0) continue;
        hd.cfills[s] = wrap_add(hd.cfills[s], f);
        if (d.MV) st.mvcap[s] = max(wrap_sub(st.mvcap[s], f), 0);
        if (d.has_domains) {
          const int c_s = st.c_slot[s];
          const bool tighten = g.dyn && f > 0 && c_s < V1;
          int32_t* pv = st.percap + static_cast<size_t>(s) * V1;
          for (int v = 0; v < V1; ++v) {
            const int32_t x = max(wrap_sub(pv[v], f), 0);
            pv[v] = (tighten && v != c_s) ? 0 : x;
          }
          hd.capv[s] = tighten ? pv[c_s] : wrap_sub(hd.capv[s], f);
        } else {
          hd.capv[s] = wrap_sub(hd.capv[s], f);
        }
      }
      PHASE_MARK(kPhSummaries);

      // ---- 3. fresh claims: rank 0 ----
      if (lead) {
        __syncthreads();
        fresh_claims<kMV>(d, in, st, out, m, g, n_open, overflow,
                     ClassedBulkHook{&hd, m.pmax, st.percap, st.mvcap,
                                     cdk == 0 ? m.off.z : m.off.c, T, V1, d.has_domains,
                                     cdyn, d.MV > 0},
                     sh, s_debit);
        spread_carry(d, st, m, g);
        __syncthreads();
        PHASE_MARK(kPhFresh);
        if (tid == 0) s_open = n_open;
      }
      // the commits, the summaries and the bulks' claims, and rank 0's open
      // claims: the other ranks go on to the next member (to its tier-2
      // barrier) or to the settlement, neither of which reads what rank 0
      // writes next
      cluster_sync(ranks);
      if (ranks > 1 && !lead) n_open = *cg::this_cluster().map_shared_rank(&s_open, 0);
      // ---- contributor counts and the member's outputs: rank 0 ----
      if (lead) {
        if (d.has_contrib) contrib_counts(d, in, st, out, m, g, n_open);
        PHASE_MARK(kPhContrib);
        group_outputs(d, st, out, g, placed_exist, n_open, sh);
        PHASE_MARK(kPhOutputs);
      }
    }

    // ---- end-of-class type-mask settlement, each rank's share ----
    rank_share(n_open, rank, ranks, lo, hi);
    settle_class(d, in, out, m, hd, cs, cdk, cdyn, n_open0, lo, hi);
    cluster_sync(ranks);
    PHASE_MARK(kPhSettle);
  }
  if (lead && tid == 0) {
    out.n_open[0] = n_open;
    out.overflow[0] = overflow;
  }
  // rank 0's shared memory outlives the other ranks' last read of it
  if (ranks > 1) cg::this_cluster().sync();
}

}  // namespace

extern "C" int kt_pack_classed(
    int G, int T, int P, int N, int R, int K, int V1, int NMAX, int JH, int JD,
    int MV, int MW, int O, int C, int zone_kid, int ct_kid, int wf_iters, int has_domains,
    int has_contrib, int tiled,
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
    // minValues tables; the (empty) reservation ledger
    const int32_t* p_mvmin, const uint8_t* t_mvoh, const int32_t* res_cap0,
    const uint8_t* a_res,
    // the tiled mode's row inputs
    const uint8_t* p_def, const uint8_t* p_neg, const uint8_t* p_titype_ok,
    const uint8_t* t_def, const uint8_t* t_mask, const uint8_t* o_avail,
    const int32_t* o_zone, const int32_t* o_ct, const uint8_t* n_def,
    const uint8_t* n_mask, const uint8_t* n_tol,
    // the class partition
    const int32_t* class_start, const int32_t* class_len, const uint8_t* class_dyn,
    const int32_t* class_dkey,
    // state + scratch
    float* exist_used, float* c_used, int32_t* c_npods, uint8_t* c_def,
    uint8_t* c_neg, uint8_t* c_mask, int32_t* ch_cnt, int32_t* nhc,
    float* pool_rem, int32_t* exist_cap, int32_t* claim_cap,
    int32_t* claim_fill, uint8_t* avail, uint32_t* atz,
    uint32_t* atc, uint8_t* toff_pt, int32_t* percap, int32_t* c_slot,
    int32_t* ddc, int32_t* res_rem, int32_t* mvcap,
    // each type's minValues values per key, as words; the offered zones
    // and capacity types [2, W] (offer_words; zeroed by the caller)
    uint32_t* mvw, uint32_t* offered,
    // the tiled rows and the shared mask words (empty untiled)
    uint8_t* r_compat, uint8_t* r_tok, int32_t* r_nfit, int32_t* r_cap,
    uint32_t* tw, uint32_t* pw, uint32_t* nw,
    // class head tables and per-claim summaries (the per-domain ones are
    // percap above)
    int32_t* capv, int32_t* af0, uint8_t* off0, uint8_t* toff_nt0, int32_t* cfills,
    int32_t* pin0, uint8_t* off_grp, uint8_t* toff_grp, int32_t* e_cap,
    // outputs
    int32_t* c_pool, uint8_t* c_tmask, int32_t* n_open, uint8_t* overflow,
    int32_t* exist_fills, int32_t* claim_fills, int32_t* unplaced,
    int32_t* c_dzone, int32_t* c_dct, uint8_t* c_resv,
    // the spill scratch (csrc/pack_common.cuh:layout_info; empty where
    // Smem fits shared memory) and its bytes
    unsigned char* spill, long long spill_n,
    // out (host, may be null): the cluster's blocks, how many clusters of
    // that size and of kMaxCluster blocks the card holds at once with the
    // scan's shared memory
    int* cluster,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (R > 32 || JH < 1 || JD < 1 || (MV && (MW < 1 || MW > 32 * 0xffff)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = (V1 + 31) / 32;
  // no reservation ledger here (NRES = 0)
  Dims d{G, T, P, N, R, K, V1, NMAX, JH, JD, zone_kid, ct_kid, wf_iters, W,
         has_domains != 0, has_contrib != 0, MV, MW, (MW + 31) / 32, 0, O, tiled != 0};
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
           mvw, nullptr, nullptr, nullptr, offered, offered + W};
  Out out{c_pool, c_tmask, n_open, overflow, exist_fills, claim_fills,
          unplaced, c_dzone, c_dct, c_resv};
  Classes cls{class_start, class_len, class_dyn, class_dkey, C};
  Head hd{capv, af0, off0, toff_nt0, cfills, pin0, off_grp, toff_grp, e_cap};
  // Smem's layout, before anything launches
  size_t smem = 0;
  // (the instantiations differ in code only, not in their static shared memory)
  const int rc = scan_smem(pack_classed_scan<kMvNone>, d, st, 1, kMaxCluster, spill, spill_n,
                           smem);
  if (rc) return rc;
  {
    // the offering words across the card (no ledger: one set)
    const long long cells = static_cast<long long>(T) * V1 * W;
    offer_words<<<offer_blocks(cells), 256, 0, stream>>>(d, in, st, 1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (MV) {
    static_words<<<132, 256, 0, stream>>>(d, in, st);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (tiled) {
    tile_words<<<132, 256, 0, stream>>>(d, in, rw);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // one cluster (pick_cluster with S = 1)
  const int path = mv_path(d);
  const auto kernel = path == kMvNone   ? pack_classed_scan<kMvNone>
                      : path == kMvWarp ? pack_classed_scan<kMvWarp>
                                        : pack_classed_scan<kMvTeam>;
  return launch_clusters(kernel, kMaxCluster, 1, smem, stream, cluster, d, in, st, rw,
                         out, cls, hd);
}

// kt_pack_classed's layout at these shapes (pack_common.cuh:
// layout_info): its dynamic shared memory and spill scratch bytes into
// ``out`` [2].
extern "C" int kt_pack_classed_layout(int P, int R, int K, int V1, int MV, int MW,
                                      int has_domains, int has_contrib, long long* out) {
  Dims d{};
  d.P = P, d.R = R, d.K = K, d.V1 = V1, d.W = (V1 + 31) / 32, d.MV = MV, d.MW = MW;
  d.has_domains = has_domains != 0, d.has_contrib = has_contrib != 0;
  return layout_info(pack_classed_scan<kMvNone>, d, 1, kMaxCluster, out);
}

#ifdef KT_PHASE_CLOCKS
// The first ``n`` phase clocks' totals in nanoseconds (Phase order) into
// ``host``, then zeroed; synchronous. Returns cudaGetLastError().
extern "C" int kt_pack_classed_phase_clocks(unsigned long long* host, int n) {
  return read_phase_clocks(host, n);
}
#endif
