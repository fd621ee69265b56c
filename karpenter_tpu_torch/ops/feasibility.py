"""Batched feasibility tables: the PyTorch port of karpenter_tpu/ops/feasibility.py.

The per-pod filters of the reference — per-key set walks in
Requirements.Intersects/Compatible (requirements.go:241-262, 177-196) and
the per-instance-type scan in filterInstanceTypesByRequirements
(nodeclaim.go:363-426) — become masked AND/ANY reductions over
(entities x keys x value-slots) boolean tensors.

Two device kernels live here, each as a public wrapper beside its plain
PyTorch version (``*_reference``):

- ``fresh_claim_feasibility_sparse`` (kernel ``csrc/fresh_feasibility.cu``)
- ``existing_node_feasibility_sparse`` (kernel ``csrc/existing_feasibility.cu``)

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the hand-written kernel, or raises. The plain versions mirror
the JAX functions line for line and are bit-exact with them
(tests/test_torch_feasibility.py).
"""

from __future__ import annotations

import torch

from .. import _build

_BIG_FIT = 2**30  # fits_count's "unbounded" (no positive request)
_I32_MAX = 2**31 - 1


def requirements_intersect(a_def, a_neg, a_mask, b_def, b_neg, b_mask):
    """Batched Requirements.Intersects (requirements.go:241-262). Masks are
    [..., K, V1]; undefined keys carry all-true masks, so the overlap test
    alone is correct for them."""
    overlap = (a_mask & b_mask).any(-1)  # [..., K]
    exempt = a_neg & b_neg
    ok = overlap | exempt | ~(a_def & b_def)
    return ok.all(-1)


def requirements_compatible(
    node_def, node_neg, node_mask, pod_def, pod_neg, pod_mask, well_known
):
    """Batched Requirements.Compatible with AllowUndefinedWellKnownLabels
    (requirements.go:177-196): custom labels the pod constrains positively
    must be defined node-side."""
    custom_ok = (~pod_def | well_known | node_def | pod_neg).all(-1)
    return custom_ok & requirements_intersect(
        node_def, node_neg, node_mask, pod_def, pod_neg, pod_mask
    )


def merge_requirements(a_def, a_neg, a_mask, b_def, b_neg, b_mask):
    """Requirement-set union-with-intersection (Requirements.Add): masks
    AND, defined OR, neg only survives when both sides are negative."""
    return a_def | b_def, a_neg & b_neg, a_mask & b_mask


def offering_ok(zone_mask, ct_mask, o_avail, o_zone, o_ct):
    """'Has an available compatible offering' (nodeclaim.go:389-397).

    zone_mask/ct_mask: [..., V1]; o_avail/o_zone/o_ct: [T, O]. Returns
    [..., T]: any available offering whose zone and capacity-type values
    the masks admit (a negative id admits any value)."""
    z_ok = zone_mask[..., o_zone.clamp(min=0).long()] | (o_zone < 0)  # [..., T, O]
    c_ok = ct_mask[..., o_ct.clamp(min=0).long()] | (o_ct < 0)
    return (o_avail & z_ok & c_ok).any(-1)


def f32_to_i32(x):
    """float32 -> int32 as XLA converts: truncation toward zero, saturating
    at the int32 range (the CUDA kernels use __float2int_rz, which does the
    same)."""
    big = x >= 2.0**31
    small = x < -(2.0**31)
    y = x.clamp(-(2.0**31), 2147483520.0).to(torch.int32)
    y = torch.where(big, torch.full_like(y, _I32_MAX), y)
    return torch.where(small, torch.full_like(y, -_I32_MAX - 1), y)


def fits_count(alloc, base, req):
    """How many identical pods of ``req`` fit on top of ``base`` within
    ``alloc`` (resources.Fits, resources.go:217-231, applied repeatedly).

    alloc/base/req broadcast to [..., R] float32. float32
    ``floor(headroom / max(req, 1e-9))`` with IEEE division; +inf (no
    positive request) maps to 2**30. Returns int32."""
    headroom = alloc - base
    ok_zero = ((req > 0) | (headroom >= 0)).all(-1)
    eps = torch.tensor(1e-9, dtype=torch.float32, device=req.device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=req.device)
    per = torch.where(req > 0, torch.floor(headroom / torch.maximum(req, eps)), inf)
    n = per.amin(-1)
    n = torch.where(torch.isinf(n), torch.full_like(n, float(_BIG_FIT)), n)
    n = torch.where(ok_zero, n.clamp(min=0.0), torch.zeros_like(n))
    return f32_to_i32(n)


def fresh_claim_feasibility_sparse_reference(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    gk_g, gk_k, gk_w, goff_idx,
    zone_kid: int,
    ct_kid: int,
):
    """Plain version of karpenter_tpu/ops/feasibility.py:
    fresh_claim_feasibility_sparse — the group-independent [P, T, K] base,
    corrected only on the L live (group, key) pairs by a segment sum onto
    the group axis, with offering rows recomputed for the non-neutral
    groups of ``goff_idx``.

    Returns compat_pg [P, G] bool, type_ok [P, G, T] bool,
    n_fit [P, G, T] int32."""
    P, K, V1 = p_mask.shape
    G = g_mask.shape[0]
    T = t_mask.shape[0]
    i32 = torch.int32
    gg, kk = gk_g.long(), gk_k.long()

    # group-independent per-key base: template ∪ neutral-group vs type
    ov_base = (t_mask[None, :, :, :] & p_mask[:, None, :, :]).any(-1)  # [P,T,K]
    base_ok = ov_base | ~(t_def[None, :, :] & p_def[:, None, :])
    base_fail = (~base_ok).to(i32)
    base_total = base_fail.sum(-1, dtype=i32)  # [P, T]

    # live-pair corrections (type axis)
    gm_l = g_mask[gg, kk]  # [L, V1]
    tm_l = t_mask[:, kk]  # [T, L, V1]
    pm_l = p_mask[:, kk]  # [P, L, V1]
    ov3 = ((tm_l & gm_l[None])[None] & pm_l[:, None]).any(-1)  # [P, T, L]
    cdef_l = p_def[:, kk] | g_def[gg, kk][None, :]  # [P, L]
    pair_ok = ov3 | ~(t_def[:, kk][None, :, :] & cdef_l[:, None, :])
    delta = ((~pair_ok).to(i32) - base_fail[:, :, kk]) * gk_w[None, None, :]
    adj = torch.zeros((G, P, T), dtype=i32, device=g_mask.device)
    adj.index_add_(0, gg, delta.permute(2, 0, 1))
    type_compat = (base_total[:, None, :] + adj.permute(1, 0, 2)) == 0

    # pod-vs-template compatibility over live pairs only
    pneg_l = p_neg[:, kk]
    gneg_l = g_neg[gg, kk]
    pdef_l = p_def[:, kk]
    gdef_l = g_def[gg, kk]
    ov2 = (pm_l & gm_l[None]).any(-1)  # [P, L]
    term_c = ov2 | (pneg_l & gneg_l[None, :]) | ~(pdef_l & gdef_l[None, :])
    custom_c = ~gdef_l[None, :] | well_known[kk][None, :] | pdef_l | gneg_l[None, :]
    fail_c = (~(term_c & custom_c)).to(i32) * gk_w[None, :]
    cfail = torch.zeros((G, P), dtype=i32, device=g_mask.device)
    cfail.index_add_(0, gg, fail_c.t())
    compat_pg = p_tol & (cfail.t() == 0)

    # offerings: template-only base + non-neutral-group rows
    off_base = offering_ok(
        p_mask[:, zone_kid, :], p_mask[:, ct_kid, :], o_avail, o_zone, o_ct
    )  # [P, T]
    go = goff_idx.long()
    off_corr = offering_ok(
        p_mask[:, None, zone_kid, :] & g_mask[go, zone_kid][None],
        p_mask[:, None, ct_kid, :] & g_mask[go, ct_kid][None],
        o_avail, o_zone, o_ct,
    )  # [P, LZ, T]
    off = off_base[:, None, :].expand(P, G, T).clone()
    off[:, go, :] = off_corr

    n_fit = fits_count(
        t_alloc[None, None, :, :], p_daemon[:, None, None, :],
        g_req[None, :, None, :],
    )  # [P, G, T]

    type_ok = (
        type_compat & off & (n_fit >= 1) & p_titype_ok[:, None, :]
        & compat_pg[:, :, None]
    )
    return compat_pg, type_ok, n_fit


def existing_node_feasibility_sparse_reference(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base, n_tol,
    gk_g, gk_k, gk_w,
):
    """Plain version of karpenter_tpu/ops/feasibility.py:
    existing_node_feasibility_sparse: strict compatibility over the live
    pairs (a segment sum), then fits_count against n_avail - n_base, gated
    on n_tol. Returns cap_ng [N, G] int32, or [S, N, G] for a scenario
    batch's n_tol [S, N, G] (only the gate is per scenario, as under JAX's
    vmap: the final where broadcasts)."""
    G = g_mask.shape[0]
    i32 = torch.int32
    gg, kk = gk_g.long(), gk_k.long()
    gm_l = g_mask[gg, kk]  # [L, V1]
    nm_l = n_mask[:, kk]  # [N, L, V1]
    ov = (nm_l & gm_l[None]).any(-1)  # [N, L]
    ndef_l = n_def[:, kk]
    gdef_l = g_def[gg, kk]
    gneg_l = g_neg[gg, kk]
    term = ov | ~(ndef_l & gdef_l[None, :])
    custom = ~gdef_l[None, :] | ndef_l | gneg_l[None, :]
    fail = (~(term & custom)).to(i32) * gk_w[None, :]
    nfail = torch.zeros((G, n_mask.shape[0]), dtype=i32, device=g_mask.device)
    nfail.index_add_(0, gg, fail.t())
    compat = nfail.t() == 0  # [N, G]
    cap = fits_count(n_avail[:, None, :], n_base[:, None, :], g_req[None, :, :])
    return torch.where(compat & n_tol, cap, torch.zeros_like(cap))


def fresh_claim_feasibility_sparse(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    gk_g, gk_k, gk_w, goff_idx,
    zone_kid: int,
    ct_kid: int,
):
    """compat_pg [P, G], type_ok [P, G, T], n_fit [P, G, T]: the plain
    version for CPU tensors, kernel B1 (csrc/fresh_feasibility.cu) for
    CUDA tensors."""
    args = (
        g_def, g_neg, g_mask, g_req,
        p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
        t_def, t_mask, t_alloc,
        o_avail, o_zone, o_ct,
        well_known,
        gk_g, gk_k, gk_w, goff_idx,
    )
    if g_mask.device.type == "cpu":
        return fresh_claim_feasibility_sparse_reference(
            *args, zone_kid=zone_kid, ct_kid=ct_kid
        )
    return _launch_fresh(*args, zone_kid=zone_kid, ct_kid=ct_kid)


def existing_node_feasibility_sparse(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base, n_tol,
    gk_g, gk_k, gk_w,
):
    """cap_ng [N, G] (or [S, N, G] for n_tol [S, N, G]): the plain
    version for CPU tensors, kernel B2 (csrc/existing_feasibility.cu) for
    CUDA tensors."""
    args = (
        g_def, g_neg, g_mask, g_req,
        n_def, n_mask, n_avail, n_base, n_tol,
        gk_g, gk_k, gk_w,
    )
    if g_mask.device.type == "cpu":
        return existing_node_feasibility_sparse_reference(*args)
    return _launch_existing(*args)


def _launch_fresh(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    gk_g, gk_k, gk_w, goff_idx,
    zone_kid: int,
    ct_kid: int,
):
    import ctypes

    G, K, V1 = g_mask.shape
    P, R = p_daemon.shape
    T, O = o_avail.shape
    L, LZ = gk_g.shape[0], goff_idx.shape[0]
    dev = g_mask.device
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    for t, name, dt, shape in (
        (g_def, "g_def", b, (G, K)), (g_neg, "g_neg", b, (G, K)),
        (g_mask, "g_mask", b, (G, K, V1)), (g_req, "g_req", f32, (G, R)),
        (p_def, "p_def", b, (P, K)), (p_neg, "p_neg", b, (P, K)),
        (p_mask, "p_mask", b, (P, K, V1)), (p_daemon, "p_daemon", f32, (P, R)),
        (p_tol, "p_tol", b, (P, G)), (p_titype_ok, "p_titype_ok", b, (P, T)),
        (t_def, "t_def", b, (T, K)), (t_mask, "t_mask", b, (T, K, V1)),
        (t_alloc, "t_alloc", f32, (T, R)),
        (o_avail, "o_avail", b, (T, O)), (o_zone, "o_zone", i32, (T, O)),
        (o_ct, "o_ct", i32, (T, O)), (well_known, "well_known", b, (K,)),
        (gk_g, "gk_g", i32, (L,)), (gk_k, "gk_k", i32, (L,)),
        (gk_w, "gk_w", i32, (L,)), (goff_idx, "goff_idx", i32, (LZ,)),
    ):
        _build.check(t, name, dt, shape, dev)
    adj = torch.empty((P, G, T), dtype=i32, device=dev)
    cfail = torch.empty((P, G), dtype=i32, device=dev)
    compat_pg = torch.empty((P, G), dtype=b, device=dev)
    type_ok = torch.empty((P, G, T), dtype=b, device=dev)
    n_fit = torch.empty((P, G, T), dtype=i32, device=dev)
    fn = _build.library("fresh_feasibility").kt_fresh_feasibility
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(
            *(ctypes.c_int(int(v)) for v in (
                P, G, T, K, V1, R, O, L, LZ, zone_kid, ct_kid)),
            p(g_def), p(g_neg), p(g_mask), p(g_req),
            p(p_def), p(p_neg), p(p_mask), p(p_daemon), p(p_tol),
            p(p_titype_ok),
            p(t_def), p(t_mask), p(t_alloc),
            p(o_avail), p(o_zone), p(o_ct),
            p(well_known),
            p(gk_g), p(gk_k), p(gk_w), p(goff_idx),
            p(adj), p(cfail), p(compat_pg), p(type_ok), p(n_fit),
            _build.stream(),
        )
    _build.launched("fresh_feasibility", rc)
    return compat_pg, type_ok, n_fit


def _launch_existing(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base, n_tol,
    gk_g, gk_k, gk_w,
):
    import ctypes

    G, K, V1 = g_mask.shape
    N, R = n_avail.shape
    L = gk_g.shape[0]
    # a scenario batch gates on n_tol [S, N, G]; the plain solve's [N, G]
    # is one scenario without the axis
    lead = tuple(n_tol.shape[:-2])
    S = n_tol.shape[0] if lead else 1
    dev = g_mask.device
    b, i32, f32 = torch.bool, torch.int32, torch.float32
    for t, name, dt, shape in (
        (g_def, "g_def", b, (G, K)), (g_neg, "g_neg", b, (G, K)),
        (g_mask, "g_mask", b, (G, K, V1)), (g_req, "g_req", f32, (G, R)),
        (n_def, "n_def", b, (N, K)), (n_mask, "n_mask", b, (N, K, V1)),
        (n_avail, "n_avail", f32, (N, R)), (n_base, "n_base", f32, (N, R)),
        (n_tol, "n_tol", b, lead + (N, G)),
        (gk_g, "gk_g", i32, (L,)), (gk_k, "gk_k", i32, (L,)),
        (gk_w, "gk_w", i32, (L,)),
    ):
        _build.check(t, name, dt, shape, dev)
    cap_ng = torch.empty(lead + (N, G), dtype=i32, device=dev)
    fn = _build.library("existing_feasibility").kt_existing_feasibility
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(
            *(ctypes.c_int(int(v)) for v in (S, N, G, K, V1, R, L)),
            p(g_def), p(g_neg), p(g_mask), p(g_req),
            p(n_def), p(n_mask), p(n_avail), p(n_base), p(n_tol),
            p(gk_g), p(gk_k), p(gk_w),
            p(cap_ng),
            _build.stream(),
        )
    _build.launched("existing_feasibility", rc, scenarios=S)
    return cap_ng
