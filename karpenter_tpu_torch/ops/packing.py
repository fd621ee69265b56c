"""Grouped first-fit-decreasing packing: the PyTorch port of
karpenter_tpu/ops/packing.py:pack.

The scan runs over pod *groups* (equivalence classes) in FFD order; each
step places a whole group:

1. existing nodes, in priority order, greedy prefix fill (the per-pod
   "first accepting node in fixed order" collapses to a cumsum);
2. open claims, least-loaded first (the per-pod "sort by fewest pods,
   first accepting" collapses to an integer water-fill, solved by
   bisection);
3. new claims from the highest-weight feasible template, opened in bulks,
   each bulk debiting the NodePool limit ledger (subtractMax,
   scheduler.go:498-515).

Domain-keyed topology (``has_domains``): a group whose zone or
capacity-type constraint is dynamic (g_dmode > 0) gets a per-step quota
``qd`` over the domain slots — self-selecting spread water-fills domains
under the skew-derived level cap, affinity pins the group to one
bootstrap domain, gate modes admit domains by the carried counts — and
every tier serves the slots: per-domain budgets over existing nodes, one
domain per open claim (``spread_domain_choice``), domain-pinned bulks of
fresh claims split evenly (``bulk_takes``). Shared domain constraints
carry their counts across steps (``dd0`` -> the ``ddc`` carry).

Contributor counting (``has_contrib``): a group whose pods are selected by
a shared hostname or domain constraint it does not own adds its
placements to that constraint's carried counts (``nhc``, ``ch_cnt``,
``ddc``) after its step.

Scope of this port: what ``pack`` traces with tile_feasibility=False, no
reservations (NRES=0) and no minValues (MV=0), with has_domains and
has_contrib either way. Any other static raises NotImplementedError
before anything runs (ROADMAP.md item A4b).

``pack`` is the public wrapper: its plain version ``pack_reference`` (a
host loop over groups, exact and slow) for CPU tensors, kernel B4
(csrc/pack.cu, one persistent thread block per solve) for CUDA tensors.

``pack_classed`` is the same scan restructured over feasibility classes
(packing.py:pack_classed, the route the driver takes for batches of many
small groups that share few classes): ``pack_classed_reference`` for CPU
tensors, kernel B5 (csrc/pack_classed.cu) for CUDA tensors.

Scenario batches (consolidation's probe sets, ops/solve.py:
solve_scenarios_core_packed): ``g_count`` [S, G] and ``cap_ng`` [S, N, G],
with ``n_hcnt`` / ``nh_cnt0`` / ``g_dprior`` / ``dd0`` either shared or
[S, ...]; every output gains a leading [S]. The plain version loops over
the scenarios and stacks; the kernel runs one block per scenario in one
launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .feasibility import f32_to_i32, fits_count

_BIGI = 2**28  # "unbounded" slot capacity; keeps int32 bisection safe

# domain-constraint modes (solver/encode.py:DMODE_*)
DMODE_SPREAD = 1
DMODE_AFFINITY = 2
DMODE_GATE_SPREAD = 3
DMODE_GATE_AFF = 4


def check_scope(tile_feasibility, n_res, n_mv):
    """Raise NotImplementedError for the statics this slice does not port
    (has_domains and has_contrib are ported, either way)."""
    missing = [
        name
        for name, on in (
            ("tile_feasibility (tiled tables)", tile_feasibility),
            ("reservations (NRES > 0)", n_res > 0),
            ("minValues (MV > 0)", n_mv > 0),
        )
        if on
    ]
    if missing:
        raise NotImplementedError(
            "the PyTorch pack covers untiled tables, no reservations and no "
            "minValues; this batch needs " + ", ".join(missing)
            + " (ROADMAP.md item A4b)"
        )


def _sum32(x):
    return x.sum(dtype=torch.int32)


def _cumsum32(x, dim=0):
    return torch.cumsum(x, dim, dtype=torch.int32)


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi) == min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _i32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def greedy_prefix_fill(cap, n):
    """Fill slots in order: slot i gets min(cap_i, remaining)."""
    before = _cumsum32(cap) - cap
    return _clip(n - before, torch.zeros_like(cap), cap)


def waterfill(npods, cap, n, iters: int = 32):
    """Distribute n pods to slots, always to the least-loaded slot with
    remaining capacity (ties by slot index); returns fills int32.

    The smallest water level L with sum(clip(L - npods, 0, cap)) >= n,
    found by bisection with midpoint (lo + hi) // 2, at most ``iters``
    trips; the deficit layer is handed out by slot index."""
    n = torch.minimum(n, _sum32(cap))
    zero = torch.zeros_like(cap)

    def f(level):
        return _sum32(_clip(level - npods, zero, cap))

    hi0 = torch.where(cap > 0, npods + cap, zero).max() + 1
    lo, hi = 0, int(hi0)
    i = 0
    n_v = int(n)
    while hi - lo > 1 and i < iters:
        mid = (lo + hi) // 2
        if int(f(_i32(mid, cap.device))) >= n_v:
            hi = mid
        else:
            lo = mid
        i += 1
    level = _i32(hi, cap.device)
    base = _clip((level - 1) - npods, zero, cap)
    deficit = n - _sum32(base)
    elig = (base < cap) & (npods <= level - 1)
    rank = _cumsum32(elig.to(torch.int32))
    return base + (elig & (rank <= deficit)).to(torch.int32)


def waterfill1(npods, cap, n, iters: int = 32):
    """``waterfill`` with the closed form for n <= 1 (packing.py:
    waterfill1): the one pod lands on the first least-loaded slot with
    capacity, no bisection trips. The class-batched scan's quota and
    domain-free tier 2 use it."""
    if int(n) <= 1:
        elig = cap > 0
        fills = torch.zeros_like(cap)
        if int(n) >= 1 and bool(elig.any()):
            big = torch.full_like(npods, _BIGI)
            fills[int(torch.argmin(torch.where(elig, npods, big)))] = 1
        return fills
    return waterfill(npods, cap, n, iters=iters)


def spread_domain_choice(adm, qrem_v, mode: int, V1: int, DEAD: int):
    """Tier-2 domain of each open claim (packing.py:spread_domain_choice):
    the admissible domain with the largest remaining quota (ties by lowest
    index); for self-selecting spread the quota-PROPORTIONAL pick instead —
    eligible claims rank in slot order and cut the rank axis by cumulative
    quota (float32, searchsorted left) — when that domain is admissible.
    ``adm`` [NMAX, V1] bool, ``qrem_v`` [V1] int32. Returns (c_slot
    [NMAX] int32, any_adm [NMAX] bool); inadmissible claims get DEAD."""
    i32, f32 = torch.int32, torch.float32
    any_adm = adm.any(1)
    d_greedy = torch.argmax(
        torch.where(adm, qrem_v[None, :], torch.full_like(qrem_v, -1)[None, :]), 1
    ).to(i32)
    qv = torch.clamp_min(qrem_v, 0)
    total_q = _sum32(qv)
    rank = _cumsum32(any_adm.to(i32)) - 1
    n_adm = torch.clamp_min(_sum32(any_adm.to(i32)), 1)
    x = (rank.to(f32) + 0.5) / n_adm.to(f32)
    cum = _cumsum32(qv).to(f32) / torch.clamp_min(total_q, 1).to(f32)
    d_prop = torch.clamp(torch.searchsorted(cum, x), 0, V1 - 1).to(i32)
    prop_ok = adm.gather(1, d_prop.long()[:, None])[:, 0]
    d_star = torch.where(prop_ok & (mode == DMODE_SPREAD), d_prop, d_greedy)
    return torch.where(any_adm, d_star, torch.full_like(d_star, DEAD)), any_adm


def bulk_takes(rem_d, k, n_per, slots, slot, is_any, has_domains: bool):
    """Tier-3 per-slot takes of a fresh-claim bulk (packing.py:bulk_takes):
    domain-pinned bulks, and every bulk of a domain batch, split ``rem_d``
    evenly (base + 1-pod remainders); ANY bulks of domain-free batches
    fill n_per per claim, then the remainder. int32 tensors in, takes
    [NMAX] int32 and the in-bulk mask out."""
    in_bulk = (slots >= slot) & (slots < slot + k)
    kk = torch.clamp_min(k, 1)
    served = torch.minimum(rem_d, k * n_per)
    base = torch.where(
        k > 0, torch.div(served, kk, rounding_mode="floor"), torch.zeros_like(served)
    )
    extra = served - base * kk
    takes = base + ((slots - slot) < extra).to(torch.int32)
    if not has_domains and bool(is_any):
        takes = _clip(rem_d - (slots - slot) * n_per, torch.zeros_like(slots), n_per)
    return torch.where(in_bulk, takes, torch.zeros_like(takes)), in_bulk


def _domain_avail(dkey, cz, cc, pzm, pcm, a_f):
    """Per-domain offering availability on the constrained axis
    (packing.py:_domain_avail): toff_nt [NMAX, T, V1] for the claims and
    toff_pt [P, T, V1] for the templates — an offering in domain slot d
    under the entity's mask on the OTHER axis. The float32 contractions
    sum 0/1 products, so ``> 0`` is an exact OR of ANDs."""
    f32 = torch.float32
    if dkey == 0:
        nt = (torch.einsum("nc,tzc->ntz", cc.to(f32), a_f) > 0) & cz[:, None, :]
        pt = (torch.einsum("pc,tzc->ptz", pcm.to(f32), a_f) > 0) & pzm[:, None, :]
    else:
        nt = (torch.einsum("nz,tzc->ntc", cz.to(f32), a_f) > 0) & cc[:, None, :]
        pt = (torch.einsum("pz,tzc->ptc", pzm.to(f32), a_f) > 0) & pcm[:, None, :]
    return nt, pt


def _h_allow(has_h: bool, hself: bool, scap_h):
    """Per-entity allowance under a group's shared hostname constraint:
    self owners are capped at scap_h - count, gate owners blocked where
    the count already exceeds scap_h, other groups unbounded."""
    def allow(cnt):
        if not has_h:
            return torch.full_like(cnt, _BIGI)
        if hself:
            return torch.clamp_min(scap_h - cnt, 0)
        return torch.where(cnt > scap_h, torch.zeros_like(cnt), torch.full_like(cnt, _BIGI))
    return allow


def _haff_pin_nodes(cap, prior_col):
    """Hostname-affinity single-entity pin over the node caps: with
    priors (``prior_col`` > 0) the prior-holding nodes, without, the first
    node with room hosts everyone. Returns (caps, served)."""
    zero = torch.zeros_like(cap)
    prior_nodes = prior_col > 0
    if bool(prior_nodes.any()):
        return torch.where(prior_nodes, cap, zero), True
    free = cap >= 1
    if bool(free.any()):
        pin = int(torch.argmax(free.to(torch.int32)))
        keep = torch.arange(cap.shape[0], device=cap.device) == pin
        return torch.where(keep, cap, zero), True
    return zero, False


def _domain_sums(fill, dom, V1):
    """[V1] sums of ``fill`` by domain id ``dom`` (ids outside [0, V1)
    count nowhere, as jax.nn.one_hot drops them)."""
    ok = (dom >= 0) & (dom < V1)
    out = torch.zeros((V1 + 1,), dtype=torch.int32, device=fill.device)
    out.index_add_(0, torch.where(ok, dom, torch.full_like(dom, V1)).long(), fill)
    return out[:V1]


def _contrib_add(hrow, drow, exist_fill, claim_fill, c_mask, n_dzone, n_dct,
                 dtg_key, nhc, ch_cnt, ddc, zone_kid, ct_kid):
    """Contributor counting, in place (packing.py:1153, the oracle's
    record() rule): a group counts toward the shared hostname slots of
    ``hrow`` [JH] on every node and claim it filled, and toward the shared
    domain slots of ``drow`` [JD] by domain: existing-node fills by the
    node's zone / capacity type, claim fills only where the claim's zone
    (capacity-type) mask row is single-valued, as ``dtg_key`` picks the
    axis of each slot. Integer adds, exact in any order."""
    i32 = torch.int32
    V1 = c_mask.shape[2]
    hrow, drow = hrow.to(i32), drow.to(i32)
    if nhc.shape[0]:
        nhc += exist_fill[:, None] * hrow[None, :]
    ch_cnt += claim_fill[:, None] * hrow[None, :]
    zrow = c_mask[:, zone_kid].to(i32)  # [NMAX, V1]
    crow = c_mask[:, ct_kid].to(i32)
    zero = torch.zeros_like(claim_fill)
    zc = (torch.where(zrow.sum(1) == 1, claim_fill, zero)[:, None] * zrow).sum(0, dtype=i32)
    cc = (torch.where(crow.sum(1) == 1, claim_fill, zero)[:, None] * crow).sum(0, dtype=i32)
    ze = _domain_sums(exist_fill, n_dzone, V1)
    ce = _domain_sums(exist_fill, n_dct, V1)
    per_slot = torch.where((dtg_key == 0)[:, None], (ze + zc)[None, :], (ce + cc)[None, :])
    ddc += drow[:, None] * per_slot


def pack_reference(
    g_count, g_req, g_def, g_neg, g_mask,
    g_hcap, g_haff,
    g_hstg, g_hscap, g_hself,
    compat_pg, type_ok_pgt, n_fit_pgt,
    cap_ng,
    t_alloc, t_cap,
    a_tzc,
    p_daemon, p_limit, p_has_limit, p_tol,
    n_avail, n_base,
    n_hcnt,
    nh_cnt0,
    well_known,
    g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior, g_dreg, g_drank, g_dtg,
    p_mask, n_dzone, n_dct, dd0,
    g_hcontrib, g_dcontrib, dtg_key,
    *,
    nmax: int,
    zone_kid: int,
    ct_kid: int,
    has_domains: bool,
    has_contrib: bool = False,
    wf_iters: int = 32,
):
    """Plain version of the grouped-FFD scan (the JAX step body, line for
    line, as a host loop over groups; while-loop conditions read back with
    ``.item()``). The domain machinery runs only for dynamic groups
    (g_dmode > 0) of a ``has_domains`` batch, like the JAX ``lax.cond``s.
    Returns (c_pool, c_tmask, n_open, overflow, exist_fills, claim_fills,
    unplaced, c_dzone, c_dct, c_resv), the outputs of
    ops/solve.py:solve_core."""
    dev = g_count.device
    i32, f32 = torch.int32, torch.float32
    G = g_count.shape[0]
    P, T = type_ok_pgt.shape[0], type_ok_pgt.shape[2]
    N = n_avail.shape[0]
    R = t_alloc.shape[1]
    K, V1 = g_mask.shape[1], g_mask.shape[2]
    JH = nh_cnt0.shape[1]
    JD = dd0.shape[0]
    NSLOT, ANY, DEAD = V1 + 2, V1, V1 + 1
    a_tzc_f = a_tzc.to(f32)

    exist_used = n_base.clone()
    c_used = torch.zeros((nmax, R), dtype=f32, device=dev)
    c_npods = torch.zeros((nmax,), dtype=i32, device=dev)
    c_active = torch.zeros((nmax,), dtype=torch.bool, device=dev)
    c_pool = torch.zeros((nmax,), dtype=i32, device=dev)
    c_tmask = torch.zeros((nmax, T), dtype=torch.bool, device=dev)
    c_def = torch.zeros((nmax, K), dtype=torch.bool, device=dev)
    c_neg = torch.zeros((nmax, K), dtype=torch.bool, device=dev)
    c_mask = torch.ones((nmax, K, V1), dtype=torch.bool, device=dev)
    c_dzone = torch.full((nmax,), -1, dtype=i32, device=dev)
    c_dct = torch.full((nmax,), -1, dtype=i32, device=dev)
    ch_cnt = torch.zeros((nmax, JH), dtype=i32, device=dev)
    nhc = nh_cnt0.to(i32).clone()
    ddc = dd0.to(i32).clone()
    pool_rem = p_limit.clone()
    n_open = 0
    overflow = False

    exist_fills = torch.zeros((G, N), dtype=i32, device=dev)
    claim_fills = torch.zeros((G, nmax), dtype=i32, device=dev)
    unplaced = torch.zeros((G,), dtype=i32, device=dev)
    slots = torch.arange(nmax, dtype=i32, device=dev)
    bigi = _i32(_BIGI, dev)
    zero_n = torch.zeros((N,), dtype=i32, device=dev)
    zero_c = torch.zeros((nmax,), dtype=i32, device=dev)

    for gi in range(G):
        count = g_count[gi]
        if int(count) <= 0:
            continue  # padded / empty groups place nothing, mutate nothing
        req = g_req[gi]
        gdef, gneg, gmask = g_def[gi], g_neg[gi], g_mask[gi]
        compat_row = compat_pg[:, gi]  # [P]
        type_ok_row = type_ok_pgt[:, gi, :]  # [P, T]
        n_fit_row = n_fit_pgt[:, gi, :]  # [P, T]
        cap_row = cap_ng[:, gi]  # [N]
        hcap = g_hcap[gi]
        haff = bool(g_haff[gi])
        # shared hostname constraint: self owners capped at scap_h - count
        # and counted; gate owners blocked above the threshold, never counted
        jh = int(g_hstg[gi])
        has_h = jh >= 0
        hself = bool(g_hself[gi])
        jhc = min(max(jh, 0), JH - 1)
        counted = has_h and hself  # jh_oh is one-hot at jhc iff counted
        scap_h = g_hscap[gi]

        h_allow = _h_allow(has_h, hself, scap_h)

        # domain-constraint descriptors; the machinery runs for dynamic
        # groups of a has_domains batch only
        mode = int(g_dmode[gi])
        dyn = has_domains and mode > 0
        dkey = int(g_dkey[gi])
        kid_sel = zone_kid if dkey == 0 else ct_kid

        cz = c_mask[:, zone_kid] & gmask[zone_kid][None, :]  # [NMAX, V1]
        cc = c_mask[:, ct_kid] & gmask[ct_kid][None, :]
        if dyn:
            jd = int(g_dtg[gi])
            has_d = jd >= 0
            skew = g_dskew[gi]
            min0 = bool(g_dmin0[gi])
            D0 = g_dprior[gi] + (ddc[min(max(jd, 0), JD - 1)] if has_d else 0)
            reg = g_dreg[gi]  # [V1]
            drank = g_drank[gi]  # [V1]
            pzm = p_mask[:, zone_kid, :] & gmask[zone_kid][None, :]  # [P, V1]
            pcm = p_mask[:, ct_kid, :] & gmask[ct_kid][None, :]
            toff_nt, toff_pt = _domain_avail(dkey, cz, cc, pzm, pcm, a_tzc_f)

        # claim-level compatibility with the group
        overlap = (c_mask & gmask[None]).any(-1)  # [NMAX, K]
        exempt = c_neg & gneg[None, :]
        key_ok = overlap | exempt | ~(c_def & gdef[None, :])
        custom_ok = (
            ~gdef[None, :] | well_known[None, :] | c_def | gneg[None, :]
        ).all(-1)
        cp = c_pool.long()
        claim_compat = key_ok.all(-1) & custom_ok
        claim_compat = claim_compat & p_tol[cp, gi] & compat_row[cp]
        claim_live = c_active & claim_compat

        # per-type feasibility on each claim: options ∧ table ∧ fits under
        # the current load ∧ an offering under the merged zone/ct masks
        merged_mask = c_mask & gmask[None]
        tm = c_tmask & type_ok_row[cp]
        add_fit = fits_count(t_alloc[None], c_used[:, None, :], req[None, None, :])
        off = torch.einsum("nz,tzc,nc->nt", cz.to(f32), a_tzc_f, cc.to(f32)) > 0
        tm = tm & off & (add_fit >= 1)
        cap_any = torch.where(
            claim_live, torch.where(tm, add_fit, 0).amax(-1), zero_c
        )
        if dyn:
            # per-claim per-domain capacity, shared by the affinity
            # bootstrap's claim anchor and tier 2
            percap = torch.where(
                tm[:, :, None] & toff_nt, add_fit[:, :, None], 0
            ).amax(1)  # [NMAX, V1]

        # ---- 1. existing nodes, fixed priority order ----
        exist_cap = torch.where(
            cap_row > 0, fits_count(n_avail, exist_used, req[None, :]), zero_n
        )
        exist_cap = torch.minimum(
            exist_cap, torch.clamp_min(hcap - n_hcnt[:, gi], 0)
        )
        haff_exist_served = False
        if N:
            exist_cap = torch.minimum(exist_cap, h_allow(nhc[:, jhc]))
            if haff:
                exist_cap, haff_exist_served = _haff_pin_nodes(exist_cap, n_hcnt[:, gi])

        qd = torch.zeros((NSLOT,), dtype=i32, device=dev)
        if dyn:
            # node domain slot on the constrained axis (DEAD: unregistered)
            nd_raw = n_dzone if dkey == 0 else n_dct  # [N]
            nd_ok = (nd_raw >= 0) & reg[nd_raw.clamp(0, V1 - 1).long()]
            nd_slot = torch.where(nd_ok, nd_raw, torch.full_like(nd_raw, DEAD))
            nd_oh = torch.nn.functional.one_hot(nd_slot.long(), NSLOT).to(i32)
            qd[:V1] = _domain_quota(
                mode, count, D0, reg, drank, skew, min0, exist_cap, nd_raw,
                nd_slot, nd_oh, type_ok_row, toff_pt, percap, claim_live,
                c_npods, hcap, h_allow(ch_cnt[:, jhc]),
                c_dzone if dkey == 0 else c_dct, V1, wf_iters,
            )
            # tier-1 fill under per-domain budgets: the prefix order within
            # each slot keeps node priority
            slot_cap = exist_cap[:, None] * nd_oh  # [N, NSLOT]
            pre_own = ((_cumsum32(slot_cap) - slot_cap) * nd_oh).sum(1, dtype=i32)
            budget = qd[nd_slot.long()]
            exist_fill = _clip(budget - pre_own, zero_n, exist_cap)
            qrem = qd - (exist_fill[:, None] * nd_oh).sum(0, dtype=i32)
        else:
            qd[ANY] = count
            exist_fill = greedy_prefix_fill(exist_cap, count)
            qrem = qd.clone()
            qrem[ANY] -= _sum32(exist_fill)
        if haff_exist_served:
            # the remainder of a served hostname-affinity pin errors
            qrem = torch.zeros_like(qrem)
        exist_used = exist_used + exist_fill[:, None].to(f32) * req[None, :]
        if counted:
            nhc[:, jhc] += exist_fill

        # ---- 2. open claims, least-loaded first ----
        def clamp(cap):
            cap = torch.minimum(cap, hcap)  # open claims carry no prior
            cap = torch.minimum(cap, count)  # keeps int32 waterfill sums safe
            return torch.minimum(cap, h_allow(ch_cnt[:, jhc]))

        if dyn:
            # one domain per claim, then one waterfill per domain slot
            adm = claim_live[:, None] & (percap >= 1) & (qrem[:V1] > 0)[None, :]
            c_slot, _ = spread_domain_choice(adm, qrem[:V1], mode, V1, DEAD)
            cap_dom = percap.gather(1, c_slot.clamp(0, V1 - 1).long()[:, None])[:, 0]
            claim_cap = clamp(torch.where(c_slot < V1, cap_dom, zero_c))
            claim_fill = zero_c
            placed_sd = torch.zeros((NSLOT,), dtype=i32, device=dev)
            for sl in range(NSLOT):
                m = c_slot == sl
                cap_s = torch.where(m, claim_cap, zero_c)
                if not bool((cap_s > 0).any()):
                    continue  # every cap 0: the waterfill hands out nothing
                f = waterfill(
                    torch.where(m, c_npods, bigi), cap_s, qrem[sl], iters=wf_iters
                )
                claim_fill = claim_fill + f
                placed_sd[sl] = _sum32(f)
            qrem = qrem - placed_sd
        else:
            claim_cap = clamp(cap_any)
            haff_any_claim = False
            if haff:
                elig = claim_cap >= 1
                haff_any_claim = bool(elig.any())
                if haff_any_claim:
                    tstar = int(torch.argmin(torch.where(elig, c_npods, bigi)))
                    claim_cap = torch.where(slots == tstar, claim_cap, zero_c)
                else:
                    claim_cap = zero_c
            claim_fill = waterfill(c_npods, claim_cap, qrem[ANY], iters=wf_iters)
            qrem = qrem.clone()
            qrem[ANY] -= _sum32(claim_fill)
            if haff_any_claim:
                qrem = torch.zeros_like(qrem)

        got = claim_fill > 0
        # survival: add_fit saw the pre-fill load, so "still fits after the
        # fill" is add_fit >= pods added
        surv = type_ok_row[cp] & off & (add_fit >= claim_fill[:, None])
        if dyn:
            # a claim that took pods is pinned to its domain: its
            # constrained-axis mask row narrows to it and its surviving
            # types need an offering there
            tighten = got & (c_slot < V1)
            pin = c_slot.clamp(0, V1 - 1)
            toff_at = toff_nt.gather(
                2, pin.long()[:, None, None].expand(nmax, T, 1)
            )[..., 0]
            surv = surv & (toff_at | ~tighten[:, None])
            d_oh = torch.nn.functional.one_hot(pin.long(), V1).bool()
            krow = torch.zeros((K,), dtype=torch.bool, device=dev)
            krow[kid_sel] = True
            tight_mask = merged_mask & (~krow[None, :, None] | d_oh[:, None, :])
            new_mask = torch.where(tighten[:, None, None], tight_mask, merged_mask)
            c_mask = torch.where(got[:, None, None], new_mask, c_mask)
            if dkey == 0:
                c_dzone = torch.where(tighten, pin, c_dzone)
            else:
                c_dct = torch.where(tighten, pin, c_dct)
        else:
            c_mask = torch.where(got[:, None, None], merged_mask, c_mask)
        c_tmask = torch.where(got[:, None], c_tmask & surv, c_tmask)
        c_used = c_used + claim_fill[:, None].to(f32) * req[None, :]
        c_npods = c_npods + claim_fill
        if counted:
            ch_cnt[:, jhc] += claim_fill
        c_def = c_def | (got[:, None] & gdef[None, :])
        c_neg = torch.where(got[:, None], c_neg & gneg[None, :], c_neg)

        # ---- 3. new claims from the highest-weight feasible template ----
        # Each trip serves the domain slot with the largest remaining quota
        # and opens one BULK of identical claims of one template there.
        ddead = torch.zeros((NSLOT,), dtype=torch.bool, device=dev)
        ddead[DEAD] = True
        while bool(((qrem > 0) & ~ddead).any()) and not overflow:
            d_sel = int(torch.argmax(torch.where(ddead, torch.full_like(qrem, -1), qrem)))
            rem_d = qrem[d_sel]
            is_any = d_sel == ANY
            within = torch.where(
                p_has_limit[:, None],
                (t_cap[None, :, :] <= pool_rem[:, None, :]).all(-1),
                torch.ones((P, T), dtype=torch.bool, device=dev),
            )
            avail = type_ok_row & within  # [P, T]
            if dyn and not is_any:
                avail = avail & toff_pt[:, :, d_sel]
            feas_p = avail.any(-1)
            any_feasible = bool(feas_p.any())
            p_star = int(torch.argmax(feas_p.to(i32)))  # first in weight order
            n_per = torch.minimum(
                torch.where(avail[p_star], n_fit_row[p_star], 0).amax(), hcap
            )
            n_per = torch.minimum(
                n_per, scap_h if counted else bigi
            )
            # pessimistic limit debit: max capacity over the claim's options
            debit = torch.where(
                avail[p_star][:, None], t_cap, torch.zeros_like(t_cap)
            ).amax(0)  # [R]
            if bool(p_has_limit[p_star]):
                eps = torch.tensor(1e-9, dtype=f32, device=dev)
                per = torch.where(
                    debit > 0,
                    torch.floor(pool_rem[p_star] / torch.maximum(debit, eps)),
                    torch.tensor(float("inf"), dtype=f32, device=dev),
                )
                k_limit = per.amin()
            else:
                k_limit = torch.tensor(float("inf"), dtype=f32, device=dev)
            k_need = f32_to_i32(
                torch.ceil(rem_d.to(f32) / torch.clamp_min(n_per, 1).to(f32))
            )
            k_cap = f32_to_i32(
                torch.where(torch.isinf(k_limit), torch.full_like(k_limit, 2.0**30), k_limit)
            )
            k_want = int(torch.minimum(k_need, k_cap))
            slot = n_open
            k_slots = max(nmax - slot, 0)
            if haff:
                k_want = min(k_want, 1)
            k = min(k_want, k_slots)
            n_per_v = int(n_per)
            ok = any_feasible and k > 0 and n_per_v > 0
            k = k if ok else 0

            takes, _ = bulk_takes(
                rem_d, _i32(k, dev), n_per, slots, slot, is_any, has_domains
            )
            placed = _sum32(takes)

            if k:
                sl = slice(slot, slot + k)
                tk = takes[sl]
                c_used[sl] = p_daemon[p_star][None, :] + tk[:, None].to(f32) * req[None, :]
                c_npods[sl] = tk
                c_active[sl] = True
                c_pool[sl] = p_star
                c_tmask[sl] = avail[p_star][None, :] & (n_fit_row[p_star][None, :] >= tk[:, None])
                c_def[sl] = gdef[None, :]
                c_neg[sl] = gneg[None, :]
                c_mask[sl] = gmask[None]
                if dyn and not is_any:
                    # claims opened for a dynamic group are domain-pinned
                    # from birth
                    c_mask[sl, kid_sel] = False
                    c_mask[sl, kid_sel, d_sel] = gmask[kid_sel, d_sel]
                    (c_dzone if dkey == 0 else c_dct)[sl] = d_sel
                ch_cnt[sl] = 0
                if counted:
                    ch_cnt[sl, jhc] = tk
            if ok and bool(p_has_limit[p_star]):
                pool_rem[p_star] = pool_rem[p_star] + (-debit) * float(k)
            n_open = slot + k
            overflow = overflow or (any_feasible and n_per_v > 0 and k_want > k_slots)
            claim_fill = claim_fill + takes
            qrem = qrem.clone()
            qrem[d_sel] -= placed
            # a no-progress trip retires the slot; haff groups retire after
            # ONE trip (a second would open a second entity)
            if int(placed) == 0 or haff:
                ddead[d_sel] = True

        # shared domain carry: a SELF owner's per-domain placements feed
        # the next sharing group's counts (gate modes never count)
        if dyn and has_d and mode < DMODE_GATE_SPREAD:
            ddc[jd] += qd[:V1] - qrem[:V1]
        if has_contrib:
            _contrib_add(
                g_hcontrib[gi], g_dcontrib[gi], exist_fill, claim_fill, c_mask,
                n_dzone, n_dct, dtg_key, nhc, ch_cnt, ddc, zone_kid, ct_kid,
            )
        exist_fills[gi] = exist_fill
        claim_fills[gi] = claim_fill
        unplaced[gi] = count - _sum32(exist_fill) - _sum32(claim_fill)

    c_resv = torch.zeros((nmax,), dtype=torch.bool, device=dev)
    return (
        c_pool, c_tmask,
        torch.tensor(n_open, dtype=i32, device=dev),
        torch.tensor(overflow, dtype=torch.bool, device=dev),
        exist_fills, claim_fills, unplaced, c_dzone, c_dct, c_resv,
    )


def _domain_quota(
    mode, count, D0, reg, drank, skew, min0, exist_cap, nd_raw, nd_slot,
    nd_oh, type_ok_row, toff_pt, percap, claim_live, c_npods, hcap,
    h_allow_c, pin_axis, V1, wf_iters, wf=None,
):
    """The dynamic group's quota over its V1 domain slots (packing.py
    step, "domain quota qd"): self-selecting spread water-fills domains
    under the level cap L* = maxSkew + min over registered domains of
    (prior + capacity) (0 under minDomains); the gate modes admit domains
    within skew of the static min (gate-spread) or currently nonempty
    (gate-affinity); affinity puts the whole group on one domain, chosen
    follower -> first fitting node -> least-loaded pinned claim -> lowest
    rank fresh domain. ``wf`` is the water-fill (``waterfill``; the
    class-batched scan passes ``waterfill1``)."""
    i32 = torch.int32
    dev = D0.device
    bigi = _i32(_BIGI, dev)
    zero_v = torch.zeros((V1,), dtype=i32, device=dev)
    big_v = torch.full((V1,), _BIGI, dtype=i32, device=dev)
    czcap_exist = (exist_cap[:, None] * nd_oh[:, :V1]).sum(0, dtype=i32)
    fresh_ok_d = (type_ok_row[:, :, None] & toff_pt).any(1).any(0)  # [V1]
    realcap = torch.minimum(
        czcap_exist + torch.where(fresh_ok_d, big_v, zero_v), bigi
    )
    if mode == DMODE_AFFINITY:
        N = exist_cap.shape[0]
        has_exist, d_exist = False, 0
        if N:
            n_elig = (exist_cap >= 1) & (nd_slot < V1)
            has_exist = bool(n_elig.any())
            first_n = int(torch.argmax(n_elig.to(i32)))
            d_exist = min(max(int(nd_raw[first_n]), 0), V1 - 1)
        ccap_a = torch.minimum(percap.amax(1), hcap)
        ccap_a = torch.minimum(ccap_a, h_allow_c)
        elig_c = claim_live & (pin_axis >= 0) & (ccap_a >= 1)
        has_claim = bool(elig_c.any())
        nstar_c = int(torch.argmin(torch.where(elig_c, c_npods, bigi)))
        d_claim = min(max(int(pin_axis[nstar_c]), 0), V1 - 1)
        fresh_feas = fresh_ok_d & reg
        d_fresh = int(torch.argmin(torch.where(fresh_feas, drank, big_v)))
        nonempty = (D0 > 0) & reg
        d_follow = int(torch.argmin(torch.where(nonempty, drank, big_v)))
        follow = bool(nonempty.any())
        q = torch.zeros((V1,), dtype=i32, device=dev)
        if follow or has_exist or has_claim or bool(fresh_feas.any()):
            d_aff = (
                d_follow if follow
                else d_exist if has_exist
                else d_claim if has_claim
                else d_fresh
            )
            q[d_aff] = count
        return q
    if mode >= DMODE_GATE_SPREAD:
        mstat = (
            _i32(0, dev) if min0 else torch.where(reg, D0, big_v).min()
        )
        allowed = reg & ((D0 > 0) if mode == DMODE_GATE_AFF else (D0 - mstat <= skew))
        caps = torch.where(allowed, torch.minimum(realcap, count), zero_v)
    elif mode == DMODE_SPREAD:
        emax = torch.where(reg, D0 + realcap, big_v)
        mfloor = _i32(0, dev) if min0 else emax.min()
        lstar = skew + mfloor
        caps = torch.minimum(
            torch.where(reg, _clip(lstar - D0, zero_v, realcap), zero_v), count
        )
    else:
        return zero_v.clone()
    wf = wf or waterfill
    return wf(torch.where(reg, D0, big_v), caps, count, iters=wf_iters)


class PackState(NamedTuple):
    """The scan's final state (packing.py:PackState): what the class-batched
    scan returns beside its fills. ``res_rem`` is empty (no reservation
    ledger in this port)."""
    exist_used: torch.Tensor  # [N, R] float32
    c_used: torch.Tensor  # [NMAX, R] float32
    c_npods: torch.Tensor  # [NMAX] int32
    c_active: torch.Tensor  # [NMAX] bool
    c_pool: torch.Tensor  # [NMAX] int32
    c_tmask: torch.Tensor  # [NMAX, T] bool
    c_def: torch.Tensor  # [NMAX, K] bool
    c_neg: torch.Tensor  # [NMAX, K] bool
    c_mask: torch.Tensor  # [NMAX, K, V1] bool
    c_dzone: torch.Tensor  # [NMAX] int32
    c_dct: torch.Tensor  # [NMAX] int32
    ch_cnt: torch.Tensor  # [NMAX, JH] int32
    nhc: torch.Tensor  # [N, JH] int32
    ddc: torch.Tensor  # [JD, V1] int32
    res_rem: torch.Tensor  # [0] int32
    c_resv: torch.Tensor  # [NMAX] bool
    pool_rem: torch.Tensor  # [P, R] float32
    n_open: torch.Tensor  # [] int32
    overflow: torch.Tensor  # [] bool


def classed_results(state, exist_fills, claim_fills, unplaced):
    """The 10 outputs of ops/solve.py:solve_core from the class-batched
    scan's (state, fills, unplaced)."""
    return (
        state.c_pool, state.c_tmask, state.n_open, state.overflow,
        exist_fills, claim_fills, unplaced, state.c_dzone, state.c_dct,
        state.c_resv,
    )


def pack_classed_reference(
    g_count, g_req, g_def, g_neg, g_mask,
    g_hcap, g_haff,
    g_hstg, g_hscap, g_hself,
    compat_pg, type_ok_pgt, n_fit_pgt,
    cap_ng,
    t_alloc, t_cap,
    a_tzc,
    p_daemon, p_limit, p_has_limit, p_tol,
    n_avail, n_base,
    n_hcnt,
    nh_cnt0,
    well_known,
    g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior, g_dreg, g_drank, g_dtg,
    p_mask, n_dzone, n_dct, dd0,
    g_hcontrib, g_dcontrib, dtg_key,
    class_start, class_len, class_dyn, class_dkey, inv_idx,
    *,
    nmax: int,
    lmax: int,
    zone_kid: int,
    ct_kid: int,
    has_domains: bool,
    has_contrib: bool = False,
    wf_iters: int = 32,
):
    """Plain version of the class-batched scan (packing.py:pack_classed,
    kernel B5), structure for structure: one step per feasibility class
    (``class_start``/``class_len``: a contiguous run of FFD-sorted groups
    with identical requests, masks and tolerations; ``class_dyn``/
    ``class_dkey``: whether a member is domain-dynamic, and on which axis).

    The class head builds the class-invariant tables once: the claims'
    offering rows ``off0`` and, for a dynamic class, their per-domain
    table ``toff_nt0`` [NMAX, T, V1], the templates' ``toff_pt`` and the
    group-mask rows ``off_grp``/``toff_grp`` a claim opened in the class
    carries; the fit counts ``add_fit0`` and the per-claim capacity
    summaries ``capv`` [NMAX] / ``percapv`` [NMAX, V1]. Each member then
    places its group reading only the summaries, which it maintains by
    exact integer decrements (every member requests the same vector, so
    a fill of k lowers every fit count by exactly k); claims pinned or
    opened mid-class take their rows from the head tables. The claims'
    type masks settle once at the end of the class, against the final
    pins and the class's total fills. Outputs go through [C, lmax] member
    buffers and back to the group axis by ``inv_idx``.

    Returns (PackState, exist_fills [G, N], claim_fills [G, NMAX],
    unplaced [G]), as pack_classed does."""
    dev = g_count.device
    i32, f32, b = torch.int32, torch.float32, torch.bool
    P, T = type_ok_pgt.shape[0], type_ok_pgt.shape[2]
    N = n_avail.shape[0]
    R = t_alloc.shape[1]
    K, V1 = g_mask.shape[1], g_mask.shape[2]
    JH = nh_cnt0.shape[1]
    JD = dd0.shape[0]
    C = class_start.shape[0]
    NSLOT, ANY, DEAD = V1 + 2, V1, V1 + 1
    a_tzc_f = a_tzc.to(f32)

    exist_used = n_base.clone()
    c_used = torch.zeros((nmax, R), dtype=f32, device=dev)
    c_npods = torch.zeros((nmax,), dtype=i32, device=dev)
    c_active = torch.zeros((nmax,), dtype=b, device=dev)
    c_pool = torch.zeros((nmax,), dtype=i32, device=dev)
    c_tmask = torch.zeros((nmax, T), dtype=b, device=dev)
    c_def = torch.zeros((nmax, K), dtype=b, device=dev)
    c_neg = torch.zeros((nmax, K), dtype=b, device=dev)
    c_mask = torch.ones((nmax, K, V1), dtype=b, device=dev)
    c_dzone = torch.full((nmax,), -1, dtype=i32, device=dev)
    c_dct = torch.full((nmax,), -1, dtype=i32, device=dev)
    ch_cnt = torch.zeros((nmax, JH), dtype=i32, device=dev)
    nhc = nh_cnt0.to(i32).clone()
    ddc = dd0.to(i32).clone()
    pool_rem = p_limit.clone()
    n_open = 0
    overflow = False

    ebuf = torch.zeros((C, lmax, N), dtype=i32, device=dev)
    cbuf = torch.zeros((C, lmax, nmax), dtype=i32, device=dev)
    ubuf = torch.zeros((C, lmax), dtype=i32, device=dev)
    slots = torch.arange(nmax, dtype=i32, device=dev)
    bigi = _i32(_BIGI, dev)
    zero_n = torch.zeros((N,), dtype=i32, device=dev)
    zero_c = torch.zeros((nmax,), dtype=i32, device=dev)

    for ci in range(C):
        cs, cl = int(class_start[ci]), int(class_len[ci])
        if cl <= 0:
            continue  # a class of padding groups: skipped whole
        cdyn = bool(class_dyn[ci])
        cdk = int(class_dkey[ci])
        # ---- class-invariant head tables ----
        gih = cs
        req = g_req[gih]
        gdef, gneg, gmask = g_def[gih], g_neg[gih], g_mask[gih]
        compat_row = compat_pg[:, gih]  # [P]
        type_ok_row = type_ok_pgt[:, gih, :]  # [P, T]
        n_fit_row = n_fit_pgt[:, gih, :]  # [P, T]
        cap_row = cap_ng[:, gih]  # [N]
        gz, gc = gmask[zone_kid], gmask[ct_kid]
        # every touch within the class merges the same gmask, so these
        # claim rows hold for all members
        cz0 = c_mask[:, zone_kid] & gz[None, :]  # [NMAX, V1]
        cc0 = c_mask[:, ct_kid] & gc[None, :]
        pzm = p_mask[:, zone_kid, :] & gz[None, :]  # [P, V1]
        pcm = p_mask[:, ct_kid, :] & gc[None, :]
        off0 = torch.einsum("nz,tzc,nc->nt", cz0.to(f32), a_tzc_f, cc0.to(f32)) > 0
        # the row every claim opened in this class carries (its mask is gmask)
        off_grp = torch.einsum("z,tzc,c->t", gz.to(f32), a_tzc_f, gc.to(f32)) > 0
        if has_domains:
            if cdyn:
                toff_nt0, toff_pt = _domain_avail(cdk, cz0, cc0, pzm, pcm, a_tzc_f)
                if cdk == 0:
                    toff_grp = (torch.einsum("c,tzc->tz", gc.to(f32), a_tzc_f) > 0) & gz[None, :]
                else:
                    toff_grp = (torch.einsum("z,tzc->tc", gz.to(f32), a_tzc_f) > 0) & gc[None, :]
            else:
                toff_nt0 = torch.zeros((nmax, T, V1), dtype=b, device=dev)
                toff_pt = torch.zeros((P, T, V1), dtype=b, device=dev)
                toff_grp = torch.zeros((T, V1), dtype=b, device=dev)
        exist_cap = (
            torch.where(cap_row > 0, fits_count(n_avail, exist_used, req[None, :]), zero_n)
            if N else zero_n
        )
        add_fit0 = fits_count(t_alloc[None], c_used[:, None, :], req[None, None, :])
        overlap = (c_mask & gmask[None]).any(-1)  # [NMAX, K]
        exempt = c_neg & gneg[None, :]
        key_ok = overlap | exempt | ~(c_def & gdef[None, :])
        custom_ok = (~gdef[None, :] | well_known[None, :] | c_def | gneg[None, :]).all(-1)
        cp = c_pool.long()
        # c_active is applied per member (opens flip it mid-class)
        live = key_ok.all(-1) & custom_ok & p_tol[cp, gih] & compat_row[cp]
        tor = type_ok_row[cp]  # [NMAX, T]
        # per-claim capacity summaries, the only claim-side state a member
        # reads: a fill of k <= capv keeps the max-fit type alive, so capv
        # (and each percapv lane) drops by exactly k; a pin collapses capv
        # to the pinned lane
        tm0 = c_tmask & tor & off0
        capv = torch.where(tm0, add_fit0, 0).amax(-1)  # [NMAX]
        if has_domains:
            percapv = torch.where(
                tm0[:, :, None] & toff_nt0, add_fit0[:, :, None], 0
            ).amax(1)  # [NMAX, V1]
        af0 = add_fit0.clone()
        cfills = zero_c.clone()
        n_open0 = n_open
        pin0_rel = (c_dzone if cdk == 0 else c_dct).clone()
        kid_sel = zone_kid if cdk == 0 else ct_kid

        for j in range(cl):
            gi = cs + j
            count = g_count[gi]
            if int(count) <= 0:
                continue
            hcap = g_hcap[gi]
            haff = bool(g_haff[gi])
            jh = int(g_hstg[gi])
            has_h = jh >= 0
            hself = bool(g_hself[gi])
            jhc = min(max(jh, 0), JH - 1)
            counted = has_h and hself
            scap_h = g_hscap[gi]

            h_allow = _h_allow(has_h, hself, scap_h)

            mode = int(g_dmode[gi])
            dyn = has_domains and mode > 0
            jd = int(g_dtg[gi])
            has_d = jd >= 0

            # ---- 1. existing nodes ----
            e_cap = torch.minimum(exist_cap, torch.clamp_min(hcap - n_hcnt[:, gi], 0))
            haff_exist_served = False
            if N:
                e_cap = torch.minimum(e_cap, h_allow(nhc[:, jhc]))
                if haff:
                    e_cap, haff_exist_served = _haff_pin_nodes(e_cap, n_hcnt[:, gi])
            claim_live = c_active & live
            qd = torch.zeros((NSLOT,), dtype=i32, device=dev)
            if dyn:
                D0 = g_dprior[gi] + (ddc[min(jd, JD - 1)] if has_d else 0)
                reg = g_dreg[gi]
                nd_raw = n_dzone if cdk == 0 else n_dct
                nd_ok = (nd_raw >= 0) & reg[nd_raw.clamp(0, V1 - 1).long()]
                nd_slot = torch.where(nd_ok, nd_raw, torch.full_like(nd_raw, DEAD))
                nd_oh = torch.nn.functional.one_hot(nd_slot.long(), NSLOT).to(i32)
                qd[:V1] = _domain_quota(
                    mode, count, D0, reg, g_drank[gi], g_dskew[gi], bool(g_dmin0[gi]),
                    e_cap, nd_raw, nd_slot, nd_oh, type_ok_row, toff_pt, percapv,
                    claim_live, c_npods, hcap, h_allow(ch_cnt[:, jhc]),
                    c_dzone if cdk == 0 else c_dct, V1,
                    wf_iters, wf=waterfill1,
                )
                slot_cap = e_cap[:, None] * nd_oh
                pre_own = ((_cumsum32(slot_cap) - slot_cap) * nd_oh).sum(1, dtype=i32)
                exist_fill = _clip(qd[nd_slot.long()] - pre_own, zero_n, e_cap)
                qrem = qd - (exist_fill[:, None] * nd_oh).sum(0, dtype=i32)
            else:
                qd[ANY] = count
                exist_fill = greedy_prefix_fill(e_cap, count)
                qrem = qd.clone()
                qrem[ANY] -= _sum32(exist_fill)
            if haff_exist_served:
                qrem = torch.zeros_like(qrem)
            exist_used = exist_used + exist_fill[:, None].to(f32) * req[None, :]
            if counted:
                nhc[:, jhc] += exist_fill
            exist_cap = exist_cap - exist_fill  # same-request decrement: exact

            # ---- 2. open claims, from the maintained summaries ----
            def clamp(cap):
                cap = torch.minimum(cap, hcap)
                cap = torch.minimum(cap, count)
                return torch.minimum(cap, h_allow(ch_cnt[:, jhc]))

            c_slot = torch.full((nmax,), ANY, dtype=i32, device=dev)
            if dyn:
                percap = torch.where(claim_live[:, None], percapv, 0)
                adm = claim_live[:, None] & (percap >= 1) & (qrem[:V1] > 0)[None, :]
                c_slot, _ = spread_domain_choice(adm, qrem[:V1], mode, V1, DEAD)
                cap_dom = percap.gather(1, c_slot.clamp(0, V1 - 1).long()[:, None])[:, 0]
                claim_cap = clamp(torch.where(c_slot < V1, cap_dom, zero_c))
                if int(count) <= 1:
                    # at most one slot carries quota: one least-loaded pick
                    s_star = int(torch.argmax(qrem))
                    elig = (c_slot == s_star) & (claim_cap >= 1)
                    tstar = int(torch.argmin(torch.where(elig, c_npods, bigi)))
                    take = int(int(qrem[s_star]) >= 1 and bool(elig.any()))
                    claim_fill = torch.where(slots == tstar, take, 0).to(i32)
                    qrem = qrem.clone()
                    qrem[s_star] -= take
                else:
                    claim_fill = zero_c
                    placed_sd = torch.zeros((NSLOT,), dtype=i32, device=dev)
                    for sl in range(NSLOT):
                        m = c_slot == sl
                        cap_s = torch.where(m, claim_cap, zero_c)
                        if not bool((cap_s > 0).any()):
                            continue  # every cap 0: the waterfill hands out nothing
                        f = waterfill(
                            torch.where(m, c_npods, bigi), cap_s, qrem[sl], iters=wf_iters
                        )
                        claim_fill = claim_fill + f
                        placed_sd[sl] = _sum32(f)
                    qrem = qrem - placed_sd
            else:
                claim_cap = clamp(torch.where(claim_live, capv, zero_c))
                haff_any_claim = False
                if haff:
                    elig = claim_cap >= 1
                    haff_any_claim = bool(elig.any())
                    if haff_any_claim:
                        tstar = int(torch.argmin(torch.where(elig, c_npods, bigi)))
                        claim_cap = torch.where(slots == tstar, claim_cap, zero_c)
                    else:
                        claim_cap = zero_c
                claim_fill = waterfill1(c_npods, claim_cap, qrem[ANY], iters=wf_iters)
                qrem = qrem.clone()
                qrem[ANY] -= _sum32(claim_fill)
                if haff_any_claim:
                    qrem = torch.zeros_like(qrem)

            got = claim_fill > 0
            c_used = c_used + claim_fill[:, None].to(f32) * req[None, :]
            c_npods = c_npods + claim_fill
            if counted:
                ch_cnt[:, jhc] += claim_fill
            c_def = c_def | (got[:, None] & gdef[None, :])
            c_neg = torch.where(got[:, None], c_neg & gneg[None, :], c_neg)
            merged_mask = c_mask & gmask[None]
            if has_domains:
                tighten = got & (c_slot < V1) if dyn else torch.zeros_like(got)
                pin = c_slot.clamp(0, V1 - 1)
                d_oh = torch.nn.functional.one_hot(pin.long(), V1).bool()
                krow = torch.zeros((K,), dtype=b, device=dev)
                krow[kid_sel] = True
                tight_mask = merged_mask & (~krow[None, :, None] | d_oh[:, None, :])
                new_mask = torch.where(tighten[:, None, None], tight_mask, merged_mask)
                c_mask = torch.where(got[:, None, None], new_mask, c_mask)
                if cdk == 0:
                    c_dzone = torch.where(tighten, pin, c_dzone)
                else:
                    c_dct = torch.where(tighten, pin, c_dct)
                # exact decrements; a pin zeroes the other lanes
                percapv = torch.clamp_min(percapv - claim_fill[:, None], 0)
                percapv = torch.where(tighten[:, None], percapv * d_oh, percapv)
                capv = torch.where(
                    tighten, percapv.gather(1, pin.long()[:, None])[:, 0], capv - claim_fill
                )
            else:
                c_mask = torch.where(got[:, None, None], merged_mask, c_mask)
                capv = capv - claim_fill
            cfills = cfills + claim_fill

            # ---- 3. fresh claims ----
            ddead = torch.zeros((NSLOT,), dtype=b, device=dev)
            ddead[DEAD] = True
            while bool(((qrem > 0) & ~ddead).any()) and not overflow:
                d_sel = int(torch.argmax(torch.where(ddead, torch.full_like(qrem, -1), qrem)))
                rem_d = qrem[d_sel]
                is_any = d_sel == ANY
                within = torch.where(
                    p_has_limit[:, None],
                    (t_cap[None, :, :] <= pool_rem[:, None, :]).all(-1),
                    torch.ones((P, T), dtype=b, device=dev),
                )
                avail = type_ok_row & within
                if has_domains and not is_any:
                    avail = avail & toff_pt[:, :, d_sel]
                feas_p = avail.any(-1)
                any_feasible = bool(feas_p.any())
                p_star = int(torch.argmax(feas_p.to(i32)))
                n_fit_max = torch.where(avail[p_star], n_fit_row[p_star], 0).amax()
                n_per = torch.minimum(n_fit_max, hcap)
                n_per = torch.minimum(n_per, scap_h if counted else bigi)
                debit = torch.where(
                    avail[p_star][:, None], t_cap, torch.zeros_like(t_cap)
                ).amax(0)
                if bool(p_has_limit[p_star]):
                    eps = torch.tensor(1e-9, dtype=f32, device=dev)
                    per = torch.where(
                        debit > 0,
                        torch.floor(pool_rem[p_star] / torch.maximum(debit, eps)),
                        torch.tensor(float("inf"), dtype=f32, device=dev),
                    )
                    k_limit = per.amin()
                else:
                    k_limit = torch.tensor(float("inf"), dtype=f32, device=dev)
                k_need = f32_to_i32(
                    torch.ceil(rem_d.to(f32) / torch.clamp_min(n_per, 1).to(f32))
                )
                k_cap = f32_to_i32(
                    torch.where(torch.isinf(k_limit), torch.full_like(k_limit, 2.0**30), k_limit)
                )
                k_want = int(torch.minimum(k_need, k_cap))
                slot = n_open
                k_slots = max(nmax - slot, 0)
                if haff:
                    k_want = min(k_want, 1)
                k = min(k_want, k_slots)
                n_per_v = int(n_per)
                ok = any_feasible and k > 0 and n_per_v > 0
                k = k if ok else 0
                takes, _ = bulk_takes(
                    rem_d, _i32(k, dev), n_per, slots, slot, is_any, has_domains
                )
                placed = _sum32(takes)
                d_pin = d_sel if dyn and not is_any else -1
                if k:
                    sl = slice(slot, slot + k)
                    tk = takes[sl]
                    c_used[sl] = p_daemon[p_star][None, :] + tk[:, None].to(f32) * req[None, :]
                    c_npods[sl] = tk
                    c_active[sl] = True
                    c_pool[sl] = p_star
                    c_tmask[sl] = avail[p_star][None, :] & (n_fit_row[p_star][None, :] >= tk[:, None])
                    c_def[sl] = gdef[None, :]
                    c_neg[sl] = gneg[None, :]
                    c_mask[sl] = gmask[None]
                    if d_pin >= 0:
                        # claims opened for a dynamic group are pinned at birth
                        c_mask[sl, kid_sel] = False
                        c_mask[sl, kid_sel, d_pin] = gmask[kid_sel, d_pin]
                    c_dzone[sl] = d_pin if cdk == 0 else -1
                    c_dct[sl] = d_pin if cdk == 1 else -1
                    ch_cnt[sl] = 0
                    if counted:
                        ch_cnt[sl, jhc] = tk
                    # the opened claims' summaries: takes <= the best
                    # available fit, so capv is n_fit_max - takes; the
                    # per-domain maxima reduce over the group-mask row
                    capv[sl] = n_fit_max - tk
                    if has_domains:
                        pmax = torch.where(
                            avail[p_star][:, None] & toff_grp, n_fit_row[p_star][:, None], 0
                        ).amax(0)  # [V1]
                        prow = torch.clamp_min(pmax[None, :] - tk[:, None], 0)
                        if d_pin >= 0:
                            prow = prow * (torch.arange(V1, device=dev) == d_pin).to(i32)[None, :]
                        percapv[sl] = prow
                    af0[sl] = n_fit_row[p_star][None, :] - tk[:, None]
                    cfills[sl] = 0
                    live[sl] = True
                    tor[sl] = type_ok_row[p_star][None, :]
                if ok and bool(p_has_limit[p_star]):
                    pool_rem[p_star] = pool_rem[p_star] + (-debit) * float(k)
                n_open = slot + k
                overflow = overflow or (any_feasible and n_per_v > 0 and k_want > k_slots)
                claim_fill = claim_fill + takes
                qrem = qrem.clone()
                qrem[d_sel] -= placed
                if int(placed) == 0 or haff:
                    ddead[d_sel] = True

            # shared domain carry, then contributor counting
            if dyn and has_d and mode < DMODE_GATE_SPREAD:
                ddc[jd] += qd[:V1] - qrem[:V1]
            if has_contrib:
                _contrib_add(
                    g_hcontrib[gi], g_dcontrib[gi], exist_fill, claim_fill, c_mask,
                    n_dzone, n_dct, dtg_key, nhc, ch_cnt, ddc, zone_kid, ct_kid,
                )
            ebuf[ci, j] = exist_fill
            cbuf[ci, j] = claim_fill
            ubuf[ci, j] = count - _sum32(exist_fill) - _sum32(claim_fill)

        # ---- end-of-class type-mask settlement ----
        # one intersection with the final pins and the class-total fills
        # equals the per-member updates pack makes
        is_new = slots >= n_open0
        pin_rel = c_dzone if cdk == 0 else c_dct
        if has_domains:
            pinc = pin_rel.clamp(0, V1 - 1).long()
            newpin = (pin_rel >= 0) & (pin_rel != pin0_rel) & ~is_new
            toff_at_pin = toff_nt0.gather(2, pinc[:, None, None].expand(nmax, T, 1))[..., 0]
            grp_at_pin = toff_grp.t()[pinc]  # [NMAX, T]
            off_new = torch.where((pin_rel >= 0)[:, None], grp_at_pin, off_grp[None, :])
            off_fin = torch.where(
                is_new[:, None], off_new, torch.where(newpin[:, None], toff_at_pin, off0)
            )
        else:
            off_fin = torch.where(is_new[:, None], off_grp[None, :], off0)
        touched = cfills > 0
        surv = tor & off_fin & (af0 >= cfills[:, None])
        c_tmask = torch.where(touched[:, None], c_tmask & surv, c_tmask)

    state = PackState(
        exist_used=exist_used, c_used=c_used, c_npods=c_npods, c_active=c_active,
        c_pool=c_pool, c_tmask=c_tmask, c_def=c_def, c_neg=c_neg, c_mask=c_mask,
        c_dzone=c_dzone, c_dct=c_dct, ch_cnt=ch_cnt, nhc=nhc, ddc=ddc,
        res_rem=torch.zeros((0,), dtype=i32, device=dev),
        c_resv=torch.zeros((nmax,), dtype=b, device=dev), pool_rem=pool_rem,
        n_open=torch.tensor(n_open, dtype=i32, device=dev),
        overflow=torch.tensor(overflow, dtype=b, device=dev),
    )
    inv = inv_idx.long()
    return (
        state,
        ebuf.reshape(C * lmax, N)[inv],
        cbuf.reshape(C * lmax, nmax)[inv],
        ubuf.reshape(C * lmax)[inv],
    )


# (position, rank with the scenario axis) of each input a scenario batch
# may carry per scenario: g_count, cap_ng, n_hcnt, nh_cnt0, g_dprior, dd0
_SCENARIO_ARGS = ((0, 2), (13, 3), (23, 3), (24, 3), (30, 3), (37, 3))


def pack_scenarios_reference(*args, **statics):
    """Plain version of the scenario-batched scan: ``pack_reference`` on
    each scenario's slice of the batched inputs (``g_count`` [S, G],
    ``cap_ng`` [S, N, G]; ``n_hcnt``, ``nh_cnt0``, ``g_dprior`` and ``dd0``
    when they carry a scenario axis, else shared), outputs stacked on a
    leading [S]."""
    per = []
    for si in range(args[0].shape[0]):
        a = list(args)
        for i, rank in _SCENARIO_ARGS:
            if a[i].dim() == rank:
                a[i] = a[i][si]
        per.append(pack_reference(*a, **statics))
    return tuple(torch.stack(outs) for outs in zip(*per))


def pack(*args, nmax: int, zone_kid: int, ct_kid: int, has_domains: bool,
         has_contrib: bool = False, wf_iters: int = 32):
    """The grouped-FFD scan over ``pack_reference``'s positional inputs:
    ``pack_reference`` for CPU tensors, kernel B4 (csrc/pack.cu) for CUDA
    tensors. Same outputs either way. A 2-D ``g_count`` [S, G] is a
    scenario batch (module docstring)."""
    statics = dict(nmax=nmax, zone_kid=zone_kid, ct_kid=ct_kid,
                   has_domains=has_domains, has_contrib=has_contrib,
                   wf_iters=wf_iters)
    if args[0].device.type == "cpu":
        if args[0].dim() == 2:
            return pack_scenarios_reference(*args, **statics)
        return pack_reference(*args, **statics)
    return _launch_pack(*args, **statics)


def pack_classed(*args, nmax: int, lmax: int, zone_kid: int, ct_kid: int,
                 has_domains: bool, has_contrib: bool = False, wf_iters: int = 32):
    """The class-batched scan over ``pack_classed_reference``'s positional
    inputs (``pack_reference``'s, then the class arrays):
    ``pack_classed_reference`` for CPU tensors, kernel B5
    (csrc/pack_classed.cu) for CUDA tensors. Returns (PackState,
    exist_fills, claim_fills, unplaced) either way."""
    statics = dict(nmax=nmax, lmax=lmax, zone_kid=zone_kid, ct_kid=ct_kid,
                   has_domains=has_domains, has_contrib=has_contrib,
                   wf_iters=wf_iters)
    if args[0].device.type == "cpu":
        return pack_classed_reference(*args, **statics)
    return _launch_pack_classed(*args, **statics)


# the number of the scan's positional inputs (pack_reference's order,
# which is also the kernels' C order); B5 takes the class arrays after them
_SCAN_INPUTS = 41


def _check_scan_inputs(args):
    """Shapes, dtypes and device of the scan's positional inputs (a
    scenario batch's leading [S] on g_count and cap_ng, and on n_hcnt,
    nh_cnt0, g_dprior, dd0 when batched); raises on what the kernels do
    not take. Returns (dims dict, S, batched-axis strides)."""
    (g_count, g_req, g_def, g_neg, g_mask, g_hcap, g_haff, g_hstg, g_hscap,
     g_hself, compat_pg, type_ok_pgt, n_fit_pgt, cap_ng, t_alloc, t_cap, a_tzc,
     p_daemon, p_limit, p_has_limit, p_tol, n_avail, n_base, n_hcnt, nh_cnt0,
     well_known, g_dmode, g_dkey, g_dskew, g_dmin0, g_dprior, g_dreg, g_drank,
     g_dtg, p_mask, n_dzone, n_dct, dd0, g_hcontrib, g_dcontrib, dtg_key) = args
    G, K, V1 = g_mask.shape
    P, T = type_ok_pgt.shape[0], type_ok_pgt.shape[2]
    N, R = n_avail.shape
    JH = nh_cnt0.shape[-1]
    JD = dd0.shape[-2]
    # scenario batch: g_count [S, G]; the plain solve is one scenario
    # without the axis
    lead = tuple(g_count.shape[:-1])
    S = g_count.shape[0] if lead else 1
    leads = {name: tuple(x.shape[:-2]) for name, x in (
        ("n_hcnt", n_hcnt), ("nh_cnt0", nh_cnt0), ("g_dprior", g_dprior),
        ("dd0", dd0))}
    for name, ld in leads.items():
        if ld not in ((), lead):
            raise ValueError(f"{name} scenario axes {ld} vs g_count's {lead}")
    if JH < 1 or JD < 1 or R > 32:
        raise ValueError(
            f"the scan kernels need JH >= 1, JD >= 1 and R <= 32 (JH={JH}, JD={JD}, R={R})")
    dev = g_mask.device
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    for t, name, dt, shape in (
        (g_count, "g_count", i32, lead + (G,)), (g_req, "g_req", f32, (G, R)),
        (g_def, "g_def", b, (G, K)), (g_neg, "g_neg", b, (G, K)),
        (g_mask, "g_mask", b, (G, K, V1)), (g_hcap, "g_hcap", i32, (G,)),
        (g_haff, "g_haff", b, (G,)), (g_hstg, "g_hstg", i32, (G,)),
        (g_hscap, "g_hscap", i32, (G,)), (g_hself, "g_hself", b, (G,)),
        (compat_pg, "compat_pg", b, (P, G)),
        (type_ok_pgt, "type_ok_pgt", b, (P, G, T)),
        (n_fit_pgt, "n_fit_pgt", i32, (P, G, T)),
        (cap_ng, "cap_ng", i32, lead + (N, G)),
        (t_alloc, "t_alloc", f32, (T, R)), (t_cap, "t_cap", f32, (T, R)),
        (a_tzc, "a_tzc", b, (T, V1, V1)),
        (p_daemon, "p_daemon", f32, (P, R)), (p_limit, "p_limit", f32, (P, R)),
        (p_has_limit, "p_has_limit", b, (P,)), (p_tol, "p_tol", b, (P, G)),
        (n_avail, "n_avail", f32, (N, R)), (n_base, "n_base", f32, (N, R)),
        (n_hcnt, "n_hcnt", i32, leads["n_hcnt"] + (N, G)),
        (nh_cnt0, "nh_cnt0", i32, leads["nh_cnt0"] + (N, JH)),
        (well_known, "well_known", b, (K,)),
        (g_dmode, "g_dmode", i32, (G,)), (g_dkey, "g_dkey", i32, (G,)),
        (g_dskew, "g_dskew", i32, (G,)), (g_dmin0, "g_dmin0", b, (G,)),
        (g_dprior, "g_dprior", i32, leads["g_dprior"] + (G, V1)),
        (g_dreg, "g_dreg", b, (G, V1)), (g_drank, "g_drank", i32, (G, V1)),
        (g_dtg, "g_dtg", i32, (G,)), (p_mask, "p_mask", b, (P, K, V1)),
        (n_dzone, "n_dzone", i32, (N,)), (n_dct, "n_dct", i32, (N,)),
        (dd0, "dd0", i32, leads["dd0"] + (JD, V1)),
        (g_hcontrib, "g_hcontrib", b, (G, JH)), (g_dcontrib, "g_dcontrib", b, (G, JD)),
        (dtg_key, "dtg_key", i32, (JD,)),
    ):
        _build.check(t, name, dt, shape, dev)
    dims = dict(G=G, T=T, P=P, N=N, R=R, K=K, V1=V1, JH=JH, JD=JD)
    strides = (
        G if lead else 0, N * G if lead else 0,
        N * G if leads["n_hcnt"] else 0, N * JH if leads["nh_cnt0"] else 0,
        G * V1 if leads["g_dprior"] else 0, JD * V1 if leads["dd0"] else 0,
    )
    return dims, S, strides


def _scan_buffers(dims, S, nmax, has_domains, dev, lead=()):
    """The scan's PackState and per-step scratch, one slice per scenario
    (the kernels initialize all of it; the domain scratch is empty
    without domains), and its 10 outputs with ``lead``."""
    G, T, P, N, R, K, V1, JH, JD = (dims[k] for k in "G T P N R K V1 JH JD".split())
    W = (V1 + 31) // 32
    b, i32, f32 = torch.bool, torch.int32, torch.float32

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    dom = (lambda n: n) if has_domains else (lambda n: 0)
    state = tuple(empty((S,) + shape, dt) for shape, dt in (
        ((N, R), f32), ((nmax, R), f32), ((nmax,), i32),
        ((nmax, K), b), ((nmax, K), b), ((nmax, K, V1), b),
        ((nmax, JH), i32), ((N, JH), i32), ((P, R), f32),
        ((N,), i32), ((nmax,), i32), ((nmax,), i32),
        ((P, T), b), ((T, V1, W), i32),
        # domains: a_tzc transposed words, toff_pt, per-domain claim
        # capacity, claim domain slot, the ddc carry
        ((dom(T), V1, W), i32), ((dom(P), T, V1), b),
        ((dom(nmax), V1), i32), ((dom(nmax),), i32), ((JD, V1), i32),
    ))
    outs = tuple(empty(lead + shape, dt) for shape, dt in (
        ((nmax,), i32), ((nmax, T), b), ((), i32), ((), b),
        ((G, N), i32), ((G, nmax), i32), ((G,), i32),
        ((nmax,), i32), ((nmax,), i32), ((nmax,), b),
    ))
    return state, outs


def _launch_pack(*args, nmax: int, zone_kid: int, ct_kid: int, has_domains: bool,
                 has_contrib: bool = False, wf_iters: int = 32):
    import ctypes

    dims, S, strides = _check_scan_inputs(args)
    dev = args[0].device
    dyn = bool(has_domains)
    state, outs = _scan_buffers(dims, S, nmax, dyn, dev, lead=tuple(args[0].shape[:-1]))
    fn = _build.library("pack").kt_pack
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(
            *(ctypes.c_int(int(v)) for v in (
                S, dims["G"], dims["T"], dims["P"], dims["N"], dims["R"], dims["K"],
                dims["V1"], nmax, dims["JH"], dims["JD"], zone_kid, ct_kid,
                wf_iters, int(dyn), int(bool(has_contrib)))),
            *(ctypes.c_longlong(v) for v in strides),
            *(p(x) for x in args),
            *(p(x) for x in state),
            *(p(x) for x in outs),
            _build.stream(),
        )
    # a domain batch runs the scan's domain machinery, a contributor batch
    # its contributor counting: each counted on its own as well
    _build.launched("pack", rc, scenarios=S, variants=(
        ("pack_domains",) * dyn + ("pack_contrib",) * bool(has_contrib)))
    return outs


def _launch_pack_classed(*args, nmax: int, lmax: int, zone_kid: int, ct_kid: int,
                         has_domains: bool, has_contrib: bool = False, wf_iters: int = 32):
    import ctypes

    scan, classes = args[:_SCAN_INPUTS], args[_SCAN_INPUTS:]
    dims, S, _ = _check_scan_inputs(scan)
    if S != 1 or scan[0].dim() != 1:
        raise ValueError("the class-batched scan takes no scenario axis")
    G, T, N, V1 = dims["G"], dims["T"], dims["N"], dims["V1"]
    dev = scan[0].device
    b, i32 = torch.bool, torch.int32
    class_start, class_len, class_dyn, class_dkey, inv_idx = classes
    C = class_start.shape[0]
    for t, name, dt, shape in (
        (class_start, "class_start", i32, (C,)), (class_len, "class_len", i32, (C,)),
        (class_dyn, "class_dyn", b, (C,)), (class_dkey, "class_dkey", i32, (C,)),
        (inv_idx, "inv_idx", i32, (G,)),
    ):
        _build.check(t, name, dt, shape, dev)
    dyn = bool(has_domains)
    state, outs = _scan_buffers(dims, 1, nmax, dyn, dev)
    state = tuple(x[0] for x in state)
    dom = (lambda n: n) if dyn else (lambda n: 0)
    # the class head tables and per-claim summaries: capv, percapv, af0,
    # off0, toff_nt0, live, cfills, pin0, off_grp, toff_grp, e_cap
    head = tuple(torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
        ((nmax,), i32), ((dom(nmax), V1), i32), ((nmax, T), i32),
        ((nmax, T), b), ((dom(nmax), T, V1), b), ((nmax,), b),
        ((nmax,), i32), ((nmax,), i32), ((T,), b), ((dom(T), V1), b),
        ((N,), i32),
    ))
    fn = _build.library("pack_classed").kt_pack_classed
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(
            *(ctypes.c_int(int(v)) for v in (
                G, T, dims["P"], N, dims["R"], dims["K"], V1, nmax, dims["JH"],
                dims["JD"], C, zone_kid, ct_kid, wf_iters, int(dyn),
                int(bool(has_contrib)))),
            *(p(x) for x in scan),
            # inv_idx is not passed: fills go straight to the group rows
            *(p(x) for x in classes[:4]),
            *(p(x) for x in state),
            *(p(x) for x in head),
            *(p(x) for x in outs),
            _build.stream(),
        )
    _build.launched("pack_classed", rc)
    (c_pool, c_tmask, n_open, overflow, exist_fills, claim_fills, unplaced,
     c_dzone, c_dct, c_resv) = outs
    (exist_used, c_used, c_npods, c_def, c_neg, c_mask, ch_cnt, nhc, pool_rem,
     *_scratch, ddc) = state
    pack_state = PackState(
        exist_used=exist_used, c_used=c_used, c_npods=c_npods,
        c_active=torch.arange(nmax, device=dev) < n_open, c_pool=c_pool,
        c_tmask=c_tmask, c_def=c_def, c_neg=c_neg, c_mask=c_mask,
        c_dzone=c_dzone, c_dct=c_dct, ch_cnt=ch_cnt, nhc=nhc, ddc=ddc,
        res_rem=torch.zeros((0,), dtype=i32, device=dev), c_resv=c_resv,
        pool_rem=pool_rem, n_open=n_open, overflow=overflow,
    )
    return pack_state, exist_fills, claim_fills, unplaced
