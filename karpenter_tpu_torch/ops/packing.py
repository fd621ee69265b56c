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

Scope of this port: exactly what ``pack`` traces with has_domains=False,
has_contrib=False, tile_feasibility=False, no reservations (NRES=0) and
no minValues (MV=0) — existing nodes, the per-entity hostname caps
(g_hcap, g_haff), the shared hostname slots (g_hstg/g_hscap/g_hself,
nh_cnt0), the pool-limit ledger, several weighted templates. Any other
static raises NotImplementedError before anything runs.

``pack`` is the public wrapper: its plain version ``pack_reference`` (a
host loop over groups, exact and slow) for CPU tensors, kernel B4
(csrc/pack.cu, one persistent thread block per solve) for CUDA tensors.

Scenario batches (consolidation's probe sets, ops/solve.py:
solve_scenarios_core_packed): ``g_count`` [S, G] and ``cap_ng`` [S, N, G],
with ``n_hcnt`` / ``nh_cnt0`` either shared or [S, ...]; every output
gains a leading [S]. The plain version loops over the scenarios and
stacks; the kernel runs one block per scenario in one launch.
"""

from __future__ import annotations

import torch

from .. import _build
from .feasibility import f32_to_i32, fits_count

_BIGI = 2**28  # "unbounded" slot capacity; keeps int32 bisection safe


def check_scope(has_domains, has_contrib, tile_feasibility, n_res, n_mv):
    """Raise NotImplementedError for the statics this slice does not port."""
    missing = [
        name
        for name, on in (
            ("has_domains (domain quotas)", has_domains),
            ("has_contrib (contributor counting)", has_contrib),
            ("tile_feasibility (tiled tables)", tile_feasibility),
            ("reservations (NRES > 0)", n_res > 0),
            ("minValues (MV > 0)", n_mv > 0),
        )
        if on
    ]
    if missing:
        raise NotImplementedError(
            "the PyTorch pack covers has_domains=False, has_contrib=False, "
            "untiled tables, no reservations and no minValues; this batch "
            "needs " + ", ".join(missing) + " (ROADMAP.md item A4)"
        )


def _sum32(x):
    return x.sum(dtype=torch.int32)


def _cumsum32(x):
    return torch.cumsum(x, 0, dtype=torch.int32)


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
    nmax: int,
    zone_kid: int,
    ct_kid: int,
    wf_iters: int = 32,
):
    """Plain version of the grouped-FFD scan (the JAX step body, line for
    line, as a host loop over groups; while-loop conditions read back with
    ``.item()``). Returns (c_pool, c_tmask, n_open, overflow, exist_fills,
    claim_fills, unplaced, c_dzone, c_dct, c_resv), the outputs of
    ops/solve.py:solve_core."""
    dev = g_count.device
    i32, f32 = torch.int32, torch.float32
    G = g_count.shape[0]
    P, T = type_ok_pgt.shape[0], type_ok_pgt.shape[2]
    N = n_avail.shape[0]
    R = t_alloc.shape[1]
    K, V1 = g_mask.shape[1], g_mask.shape[2]
    JH = nh_cnt0.shape[1]
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
    ch_cnt = torch.zeros((nmax, JH), dtype=i32, device=dev)
    nhc = nh_cnt0.to(i32).clone()
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

        def h_allow(cnt):
            if not has_h:
                return torch.full_like(cnt, _BIGI)
            if hself:
                return torch.clamp_min(scap_h - cnt, 0)
            return torch.where(cnt > scap_h, torch.zeros_like(cnt), bigi)

        cz = c_mask[:, zone_kid] & gmask[zone_kid][None, :]  # [NMAX, V1]
        cc = c_mask[:, ct_kid] & gmask[ct_kid][None, :]

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
                # hostname-affinity single-entity pin: with priors the
                # prior-holding nodes; without, the first node with room
                prior_nodes = n_hcnt[:, gi] > 0
                has_prior = bool(prior_nodes.any())
                free = exist_cap >= 1
                has_free = bool(free.any())
                if has_prior:
                    exist_cap = torch.where(prior_nodes, exist_cap, zero_n)
                elif has_free:
                    pin = int(torch.argmax(free.to(i32)))
                    exist_cap = torch.where(slots[:N] == pin, exist_cap, zero_n)
                else:
                    exist_cap = zero_n
                haff_exist_served = has_prior or has_free
        exist_fill = greedy_prefix_fill(exist_cap, count)
        qrem = count - _sum32(exist_fill)  # the ANY slot's remaining quota
        if haff_exist_served:
            qrem = torch.zeros_like(qrem)
        exist_used = exist_used + exist_fill[:, None].to(f32) * req[None, :]
        if counted:
            nhc[:, jhc] += exist_fill

        # ---- 2. open claims, least-loaded first ----
        claim_cap = torch.minimum(cap_any, hcap)  # open claims carry no prior
        claim_cap = torch.minimum(claim_cap, count)
        claim_cap = torch.minimum(claim_cap, h_allow(ch_cnt[:, jhc]))
        haff_any_claim = False
        if haff:
            elig = claim_cap >= 1
            haff_any_claim = bool(elig.any())
            if haff_any_claim:
                tstar = int(torch.argmin(torch.where(elig, c_npods, bigi)))
                claim_cap = torch.where(slots == tstar, claim_cap, zero_c)
            else:
                claim_cap = zero_c
        claim_fill = waterfill(c_npods, claim_cap, qrem, iters=wf_iters)
        qrem = qrem - _sum32(claim_fill)
        if haff_any_claim:
            qrem = torch.zeros_like(qrem)

        got = claim_fill > 0
        # survival: add_fit saw the pre-fill load, so "still fits after the
        # fill" is add_fit >= pods added
        surv = type_ok_row[cp] & off & (add_fit >= claim_fill[:, None])
        c_tmask = torch.where(got[:, None], c_tmask & surv, c_tmask)
        c_used = c_used + claim_fill[:, None].to(f32) * req[None, :]
        c_npods = c_npods + claim_fill
        if counted:
            ch_cnt[:, jhc] += claim_fill
        c_def = c_def | (got[:, None] & gdef[None, :])
        c_neg = torch.where(got[:, None], c_neg & gneg[None, :], c_neg)
        c_mask = torch.where(got[:, None, None], merged_mask, c_mask)

        # ---- 3. new claims from the highest-weight feasible template ----
        # Only the ANY slot carries quota without domains: each trip opens a
        # BULK of identical claims of one template (frozen avail set).
        dead = False
        while int(qrem) > 0 and not dead and not overflow:
            rem_d = qrem
            within = torch.where(
                p_has_limit[:, None],
                (t_cap[None, :, :] <= pool_rem[:, None, :]).all(-1),
                torch.ones((P, T), dtype=torch.bool, device=dev),
            )
            avail = type_ok_row & within  # [P, T]
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

            in_bulk = (slots >= slot) & (slots < slot + k)
            takes = torch.where(
                in_bulk,
                _clip(rem_d - (slots - slot) * n_per, zero_c, n_per.expand(nmax)),
                zero_c,
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
                ch_cnt[sl] = 0
                if counted:
                    ch_cnt[sl, jhc] = tk
            if ok and bool(p_has_limit[p_star]):
                pool_rem[p_star] = pool_rem[p_star] + (-debit) * float(k)
            n_open = slot + k
            overflow = overflow or (any_feasible and n_per_v > 0 and k_want > k_slots)
            claim_fill = claim_fill + takes
            qrem = qrem - placed
            # a no-progress trip retires the slot; haff groups retire after
            # ONE trip (a second would open a second entity)
            dead = int(placed) == 0 or haff

        exist_fills[gi] = exist_fill
        claim_fills[gi] = claim_fill
        unplaced[gi] = count - _sum32(exist_fill) - _sum32(claim_fill)

    c_dzone = torch.full((nmax,), -1, dtype=i32, device=dev)
    c_dct = torch.full((nmax,), -1, dtype=i32, device=dev)
    c_resv = torch.zeros((nmax,), dtype=torch.bool, device=dev)
    return (
        c_pool, c_tmask,
        torch.tensor(n_open, dtype=i32, device=dev),
        torch.tensor(overflow, dtype=torch.bool, device=dev),
        exist_fills, claim_fills, unplaced, c_dzone, c_dct, c_resv,
    )


# (position, rank with the scenario axis) of each input a scenario batch
# may carry per scenario: g_count, cap_ng, n_hcnt, nh_cnt0
_SCENARIO_ARGS = ((0, 2), (13, 3), (23, 3), (24, 3))


def pack_scenarios_reference(*args, **statics):
    """Plain version of the scenario-batched scan: ``pack_reference`` on
    each scenario's slice of the batched inputs (``g_count`` [S, G],
    ``cap_ng`` [S, N, G]; ``n_hcnt`` [S, N, G] and ``nh_cnt0`` [S, N, JH]
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


def pack(
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
    nmax: int,
    zone_kid: int,
    ct_kid: int,
    wf_iters: int = 32,
):
    """The grouped-FFD scan: ``pack_reference`` for CPU tensors, kernel B4
    (csrc/pack.cu) for CUDA tensors. Same outputs either way. A 2-D
    ``g_count`` [S, G] is a scenario batch (module docstring)."""
    args = (
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
    )
    statics = dict(nmax=nmax, zone_kid=zone_kid, ct_kid=ct_kid, wf_iters=wf_iters)
    if g_count.device.type == "cpu":
        if g_count.dim() == 2:
            return pack_scenarios_reference(*args, **statics)
        return pack_reference(*args, **statics)
    return _launch_pack(*args, **statics)


def _launch_pack(
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
    nmax: int,
    zone_kid: int,
    ct_kid: int,
    wf_iters: int = 32,
):
    import ctypes

    G, K, V1 = g_mask.shape
    P, T = type_ok_pgt.shape[0], type_ok_pgt.shape[2]
    N, R = n_avail.shape
    JH = nh_cnt0.shape[-1]
    # scenario batch: g_count [S, G]; the plain solve is one scenario
    # without the axis
    lead = tuple(g_count.shape[:-1])
    S = g_count.shape[0] if lead else 1
    hlead = tuple(n_hcnt.shape[:-2])
    h0lead = tuple(nh_cnt0.shape[:-2])
    if hlead not in ((), lead) or h0lead not in ((), lead):
        raise ValueError(
            f"n_hcnt/nh_cnt0 scenario axes {hlead}/{h0lead} vs g_count's {lead}"
        )
    if JH < 1 or R > 32:
        raise ValueError(f"pack kernel needs JH >= 1 and R <= 32 (JH={JH}, R={R})")
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
        (n_hcnt, "n_hcnt", i32, hlead + (N, G)),
        (nh_cnt0, "nh_cnt0", i32, h0lead + (N, JH)),
        (well_known, "well_known", b, (K,)),
    ):
        _build.check(t, name, dt, shape, dev)
    W = (V1 + 31) // 32

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    # PackState and per-step scratch, one slice per scenario (the kernel
    # initializes all of it)
    state = tuple(empty((S,) + shape, dt) for shape, dt in (
        ((N, R), f32), ((nmax, R), f32), ((nmax,), i32),
        ((nmax, K), b), ((nmax, K), b), ((nmax, K, V1), b),
        ((nmax, JH), i32), ((N, JH), i32), ((P, R), f32),
        ((N,), i32), ((nmax,), i32), ((nmax,), i32),
        ((P, T), b), ((T, V1, W), i32),
    ))
    outs = tuple(empty(lead + shape, dt) for shape, dt in (
        ((nmax,), i32), ((nmax, T), b), ((), i32), ((), b),
        ((G, N), i32), ((G, nmax), i32), ((G,), i32),
        ((nmax,), i32), ((nmax,), i32), ((nmax,), b),
    ))
    strides = (
        G if lead else 0, N * G if lead else 0,
        N * G if hlead else 0, N * JH if h0lead else 0,
    )
    fn = _build.library("pack").kt_pack
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(
            *(ctypes.c_int(int(v)) for v in (
                S, G, T, P, N, R, K, V1, nmax, JH, zone_kid, ct_kid, wf_iters)),
            *(ctypes.c_longlong(v) for v in strides),
            p(g_count), p(g_req), p(g_def), p(g_neg), p(g_mask),
            p(g_hcap), p(g_haff), p(g_hstg), p(g_hscap), p(g_hself),
            p(compat_pg), p(type_ok_pgt), p(n_fit_pgt), p(cap_ng),
            p(t_alloc), p(t_cap), p(a_tzc),
            p(p_daemon), p(p_limit), p(p_has_limit), p(p_tol),
            p(n_avail), p(n_base), p(n_hcnt), p(nh_cnt0), p(well_known),
            *(p(x) for x in state),
            *(p(x) for x in outs),
            _build.stream(),
        )
    _build.launched("pack", rc, scenarios=S)
    return outs
