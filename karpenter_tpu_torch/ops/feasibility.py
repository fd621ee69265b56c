"""Batched feasibility tables: the PyTorch port of karpenter_tpu/ops/feasibility.py.

The per-pod filters of the reference — per-key set walks in
Requirements.Intersects/Compatible (requirements.go:241-262, 177-196) and
the per-instance-type scan in filterInstanceTypesByRequirements
(nodeclaim.go:363-426) — become masked AND/ANY reductions over
(entities x keys x value-slots) boolean tensors.

Four device kernels live here, each as a public wrapper beside its plain
PyTorch version (``*_reference``), and the solver mesh's stage
(parallel/mesh.py) beside them:

- ``fresh_claim_feasibility_sparse`` (kernel B1, ``csrc/fresh_feasibility.cu``)
- ``existing_node_feasibility_sparse`` (kernel B2, ``csrc/existing_feasibility.cu``)
- ``fresh_claim_feasibility`` and ``existing_node_feasibility``, the dense
  twins (kernel B3, ``csrc/dense_feasibility.cu``): the same tables by the
  full requirement join, with no live-pair index. The relaxation
  pre-solver (ops/relax.py) runs the fresh one over its run heads, and
  ``ops/solve.py`` takes both when ``sparse_groups`` is False.
- ``fresh_claim_feasibility_partial`` and ``existing_node_feasibility_partial``
  (B1's and B2's partial modes): one mesh shard's int32 failure counts over
  its slice of the live pairs (and of the types), with the type-only parts
  from the data shard that adds the base;
- ``mesh_fold`` (``csrc/mesh_fold.cu``): the shards' partials summed and
  finished, once, into the replicated tables (``fresh_finish`` and
  ``existing_finish``, which B1's and B2's plain versions end with too).

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it launches the hand-written kernel, or raises. The plain versions mirror
the JAX functions line for line and are bit-exact with them
(tests/test_torch_feasibility.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build
from ..parallel.mesh import MAX_SHARDS

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
    # analysis: sanctioned[SHP602] an int64 index, as torch indexes (kernel: int32)
    z_ok = zone_mask[..., o_zone.clamp(min=0).long()] | (o_zone < 0)  # [..., T, O]
    # analysis: sanctioned[SHP602] an int64 index, as torch indexes (kernel: int32)
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
    groups of ``goff_idx``: ``fresh_finish`` of the whole input's
    ``fresh_claim_feasibility_partial_reference``.

    Returns compat_pg [P, G] bool, type_ok [P, G, T] bool,
    n_fit [P, G, T] int32."""
    fail_t, fail_c, tonly, n_fit = fresh_claim_feasibility_partial_reference(
        g_def, g_neg, g_mask, g_req,
        p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
        t_def, t_mask, t_alloc,
        o_avail, o_zone, o_ct,
        well_known,
        gk_g, gk_k, gk_w, goff_idx,
        zone_kid=zone_kid, ct_kid=ct_kid, with_base=True,
    )
    return fresh_finish(p_tol, fail_t, fail_c, tonly, n_fit)


def fresh_finish(p_tol, fail_t, fail_c, tonly, n_fit):
    """The fresh tables from their parts (shared by B1's plain version and
    the mesh fold's): a (template, group) pair is compatible when the
    template tolerates the group and no live pair failed; a type admits
    it when, besides, every key passed and its type-only part holds."""
    compat_pg = p_tol & (fail_c == 0)
    type_ok = (fail_t == 0) & tonly & compat_pg[:, :, None]
    return compat_pg, type_ok, n_fit


def fresh_claim_feasibility_partial_reference(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    gk_g, gk_k, gk_w, goff_idx,
    zone_kid: int,
    ct_kid: int,
    with_base: bool,
):
    """Plain version of B1's partial mode: the int32 failure counts of a
    slice of the live pairs over a slice of the types (the inputs are the
    slices: ``t_*``, ``o_*`` and ``p_titype_ok`` over the types, ``gk_*``
    over the pairs).

    Returns fail_t [P, G, T] (each (group, type) cell's key failures: the
    pairs' corrections, plus the group-independent base when
    ``with_base``), fail_c [P, G] (the pairs' compatibility failures) and,
    with ``with_base``, the type-only parts tonly [P, G, T] bool (an
    offering, a fit, the template admits the type) and n_fit [P, G, T]
    int32; else None for both. Integer sums wrap as int32, so the parts of
    any split sum to the whole input's (``mesh_fold``)."""
    P, K, V1 = p_mask.shape
    G = g_mask.shape[0]
    T = t_mask.shape[0]
    i32 = torch.int32
    # analysis: sanctioned[SHP602] int64 segment index for index_add_ (kernel: int32)
    gg, kk = gk_g.long(), gk_k.long()

    # group-independent per-key base: template ∪ neutral-group vs type
    ov_base = (t_mask[None, :, :, :] & p_mask[:, None, :, :]).any(-1)  # [P,T,K]
    base_ok = ov_base | ~(t_def[None, :, :] & p_def[:, None, :])
    base_fail = (~base_ok).to(i32)

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
    fail_t = adj.permute(1, 0, 2)
    if with_base:
        fail_t = base_fail.sum(-1, dtype=i32)[:, None, :] + fail_t  # [P, G, T]

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
    if not with_base:
        return fail_t.contiguous(), cfail.t().contiguous(), None, None

    # offerings: template-only base + non-neutral-group rows
    off_base = offering_ok(
        p_mask[:, zone_kid, :], p_mask[:, ct_kid, :], o_avail, o_zone, o_ct
    )  # [P, T]
    # analysis: sanctioned[SHP602] an int64 index, as torch indexes (kernel: int32)
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
    tonly = off & (n_fit >= 1) & p_titype_ok[:, None, :]
    return fail_t.contiguous(), cfail.t().contiguous(), tonly, n_fit


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
    nfail, cap = existing_node_feasibility_partial_reference(
        g_def, g_neg, g_mask, g_req, n_def, n_mask, n_avail, n_base,
        gk_g, gk_k, gk_w, with_base=True,
    )
    return existing_finish(nfail, cap, n_tol)


def existing_finish(nfail, cap, n_tol):
    """cap_ng from its parts (shared by B2's plain version and the mesh
    fold's): a node takes a group's pods where no live pair failed and the
    node tolerates the group."""
    return torch.where((nfail == 0) & n_tol, cap, torch.zeros_like(cap))


def existing_node_feasibility_partial_reference(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base,
    gk_g, gk_k, gk_w,
    with_base: bool,
):
    """Plain version of B2's partial mode over a slice of the live pairs:
    nfail [N, G] int32, the pairs' strict-compatibility failures, and with
    ``with_base`` cap [N, G] int32, fits_count against n_avail - n_base
    (else None)."""
    G = g_mask.shape[0]
    i32 = torch.int32
    # analysis: sanctioned[SHP602] int64 segment index for index_add_ (kernel: int32)
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
    if not with_base:
        return nfail.t().contiguous(), None
    cap = fits_count(n_avail[:, None, :], n_base[:, None, :], g_req[None, :, :])
    return nfail.t().contiguous(), cap


def mesh_fold_reference(fail_t, fail_c, tonly, n_fit, p_tol,
                        nfail=None, cap=None, n_tol=None):
    """Plain version of the mesh fold (csrc/mesh_fold.cu): the partials of
    D data shards x M model shards, stacked one buffer per input, summed
    and finished into the replicated tables.

    ``fail_t`` [D, M, P, G, Tm] int32 and ``fail_c`` [D, P, G] int32, the
    data shards' failure counts (None for D = 0: the parts are then final,
    the dense route's type slices, with its compat_pg as ``p_tol``);
    ``tonly`` [M, P, G, Tm] bool and ``n_fit`` [M, P, G, Tm] int32, model
    shard m's types at offset m * Tm; ``p_tol`` [P, G]. ``nfail`` [D, N, G]
    int32, ``cap`` [N, G] and ``n_tol`` [(S,) N, G] for the existing-node
    table, or ``cap`` None for none. Returns compat_pg [P, G], type_ok
    [P, G, M * Tm], n_fit [P, G, M * Tm] and cap_ng [(S,) N, G] (or None).
    The int32 sums wrap, so any order of the shards gives the same tables."""
    M, P, G, Tm = tonly.shape

    def cells(parts):  # [M, P, G, Tm] -> [P, G, M * Tm]
        return parts.permute(1, 2, 0, 3).reshape(P, G, M * Tm)

    def total(parts, zero):  # the wrapping int32 sum over the data shards
        for part in (() if parts is None else parts):
            zero = zero + part
        return zero

    i32 = torch.int32
    fails = total(fail_t, torch.zeros((M, P, G, Tm), dtype=i32, device=p_tol.device))
    cfail = total(fail_c, torch.zeros((P, G), dtype=i32, device=p_tol.device))
    compat_pg, type_ok, nf = fresh_finish(p_tol, cells(fails), cfail, cells(tonly), cells(n_fit))
    cap_ng = None
    if cap is not None:
        cap_ng = existing_finish(total(nfail, torch.zeros_like(cap)), cap, n_tol)
    return compat_pg, type_ok, nf, cap_ng


def fresh_claim_feasibility_reference(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    zone_kid: int,
    ct_kid: int,
):
    """Plain version of karpenter_tpu/ops/feasibility.py:
    fresh_claim_feasibility — for every (template P, group G): can a fresh
    claim from P host pods of G, and on which instance types, by the full
    [P, G, T, K, V1] requirement join.

    Returns compat_pg [P, G] bool, type_ok [P, G, T] bool,
    n_fit [P, G, T] int32."""
    # claim requirements = template ∪ group
    c_def, c_neg, c_mask = merge_requirements(
        p_def[:, None, :], p_neg[:, None, :], p_mask[:, None, :, :],
        g_def[None, :, :], g_neg[None, :, :], g_mask[None, :, :, :],
    )  # [P, G, K(,V1)]

    compat_pg = p_tol & requirements_compatible(
        p_def[:, None, :], p_neg[:, None, :], p_mask[:, None, :, :],
        g_def[None, :, :], g_neg[None, :, :], g_mask[None, :, :, :],
        well_known,
    )  # [P, G]

    # instance-type compatibility vs merged claim requirements
    # (compatible() in nodeclaim.go:428-430 is Intersects only)
    t_neg = torch.zeros_like(t_def)
    type_compat = requirements_intersect(
        t_def[None, None, :, :], t_neg[None, None, :, :], t_mask[None, None, :, :, :],
        c_def[:, :, None, :], c_neg[:, :, None, :], c_mask[:, :, None, :, :],
    )  # [P, G, T]

    # offerings vs merged zone/capacity-type masks
    off = offering_ok(
        c_mask[:, :, zone_kid, :], c_mask[:, :, ct_kid, :], o_avail, o_zone, o_ct
    )  # [P, G, T]

    n_fit = fits_count(
        t_alloc[None, None, :, :], p_daemon[:, None, None, :], g_req[None, :, None, :]
    )  # [P, G, T]

    type_ok = (
        type_compat & off & (n_fit >= 1) & p_titype_ok[:, None, :] & compat_pg[:, :, None]
    )
    return compat_pg, type_ok, n_fit


def existing_node_feasibility_reference(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base, n_tol,
    well_known,
):
    """Plain version of karpenter_tpu/ops/feasibility.py:
    existing_node_feasibility — for every (existing node N, group G): room
    for pods of G. Existing nodes have concrete labels, so compatibility
    is the strict direction (no well-known allowance, existingnode.go:96).

    Returns cap_ng [N, G] int32, or [S, N, G] for a scenario batch's
    n_tol [S, N, G] (only the gate is per scenario)."""
    n_neg = torch.zeros_like(n_def)
    compat = requirements_compatible(
        n_def[:, None, :], n_neg[:, None, :], n_mask[:, None, :, :],
        g_def[None, :, :], g_neg[None, :, :], g_mask[None, :, :, :],
        torch.zeros_like(well_known),
    )  # [N, G]
    cap = fits_count(
        n_avail[:, None, :], n_base[:, None, :], g_req[None, :, :]
    )  # [N, G]
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


def fresh_claim_feasibility(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    zone_kid: int,
    ct_kid: int,
    out=None,
):
    """compat_pg [P, G], type_ok [P, G, T], n_fit [P, G, T] by the dense
    join: the plain version for CPU tensors, kernel B3's fresh entry
    (csrc/dense_feasibility.cu) for CUDA tensors; written into ``out``'s
    three tensors (contiguous, e.g. slices of a mesh block's stacked
    buffers) where it is given."""
    args = (
        g_def, g_neg, g_mask, g_req,
        p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
        t_def, t_mask, t_alloc,
        o_avail, o_zone, o_ct,
        well_known,
    )
    if g_mask.device.type == "cpu":
        return _into(out, fresh_claim_feasibility_reference(
            *args, zone_kid=zone_kid, ct_kid=ct_kid))
    return _launch_dense_fresh(*args, zone_kid=zone_kid, ct_kid=ct_kid, out=out)


def existing_node_feasibility(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base, n_tol,
    well_known,
):
    """cap_ng [N, G] (or [S, N, G] for n_tol [S, N, G]) by the dense join:
    the plain version for CPU tensors, kernel B3's existing entry
    (csrc/dense_feasibility.cu) for CUDA tensors."""
    args = (
        g_def, g_neg, g_mask, g_req,
        n_def, n_mask, n_avail, n_base, n_tol,
        well_known,
    )
    if g_mask.device.type == "cpu":
        return existing_node_feasibility_reference(*args)
    return _launch_dense_existing(*args)


def fresh_claim_feasibility_partial(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    gk_g, gk_k, gk_w, goff_idx,
    zone_kid: int,
    ct_kid: int,
    with_base: bool,
    out=None,
):
    """One mesh shard's fresh partials (fail_t, fail_c, tonly, n_fit; the
    last two None without ``with_base``) over its slices: the plain version
    for CPU tensors, B1's partial mode (csrc/fresh_feasibility.cu:
    kt_fresh_feasibility_partial) for CUDA tensors. With ``out`` (four
    contiguous tensors, the last two None without ``with_base``: a shard's
    slices of its block's stacked buffers) the partials are written there."""
    args = (
        g_def, g_neg, g_mask, g_req,
        p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
        t_def, t_mask, t_alloc,
        o_avail, o_zone, o_ct,
        well_known,
        gk_g, gk_k, gk_w, goff_idx,
    )
    if g_mask.device.type == "cpu":
        return _into(out, fresh_claim_feasibility_partial_reference(
            *args, zone_kid=zone_kid, ct_kid=ct_kid, with_base=with_base))
    return _launch_fresh(*args, zone_kid=zone_kid, ct_kid=ct_kid, partial=True,
                         with_base=with_base, out=out)


def existing_node_feasibility_partial(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base,
    gk_g, gk_k, gk_w,
    with_base: bool,
    out=None,
):
    """One data shard's existing-node partials (nfail, and cap with
    ``with_base``, else None) over its live-pair slice: the plain version
    for CPU tensors, B2's partial mode (csrc/existing_feasibility.cu:
    kt_existing_feasibility_partial) for CUDA tensors; written into
    ``out`` (nfail, cap or None) where it is given."""
    args = (g_def, g_neg, g_mask, g_req, n_def, n_mask, n_avail, n_base, gk_g, gk_k, gk_w)
    if g_mask.device.type == "cpu":
        return _into(out, existing_node_feasibility_partial_reference(
            *args, with_base=with_base))
    return _launch_existing_partial(*args, with_base=with_base, out=out)


def mesh_fold(fail_t, fail_c, tonly, n_fit, p_tol, nfail=None, cap=None, n_tol=None):
    """The mesh's stacked partials folded into the replicated tables
    (``mesh_fold_reference``'s contract): the plain version for CPU
    tensors, one launch of csrc/mesh_fold.cu for CUDA tensors, all on
    ``p_tol``'s device."""
    if p_tol.device.type == "cpu":
        return mesh_fold_reference(fail_t, fail_c, tonly, n_fit, p_tol, nfail, cap, n_tol)
    return _launch_mesh_fold(fail_t, fail_c, tonly, n_fit, p_tol, nfail, cap, n_tol)


def _into(out, result):
    """``result`` written into ``out``'s tensors where ``out`` is given
    (None entries skipped), as the kernels write into it; the tensors
    returned."""
    if out is None:
        return result
    for o, r in zip(out, result):
        if o is not None and r is not None:
            o.copy_(r)
    return tuple(r if o is None else o for o, r in zip(out, result))


def _outputs(out, names, dtypes, shapes, dev):
    """A launch's outputs: ``out``'s first len(names) tensors, each
    checked, or len(names) new ones."""
    if out is None:
        return [torch.empty(s, dtype=d, device=dev) for _, d, s in zip(names, dtypes, shapes)]
    for t, name, dtype, shape in zip(out, names, dtypes, shapes):
        _build.check(t, name, dtype, shape, dev)
    return list(out[:len(names)])


def _fresh_entry():
    """kt_fresh_feasibility with its argument types: 11 ints, then the 21
    inputs, the 3 outputs and the direct mode's words as pointers, the
    words' count and the stream."""
    return _build.bind("fresh_feasibility", "kt_fresh_feasibility",
                       (ctypes.c_int,) * 11 + (ctypes.c_void_p,) * 25
                       + (ctypes.c_longlong, ctypes.c_void_p))


def _existing_entry():
    """kt_existing_feasibility with its argument types: 7 ints, then the 12
    inputs, the output and the stream as pointers."""
    return _build.bind("existing_feasibility", "kt_existing_feasibility",
                       (ctypes.c_int,) * 7 + (ctypes.c_void_p,) * 14)


def _fresh_partial_entry():
    """kt_fresh_feasibility_partial with its argument types: 12 ints,
    then the 21 inputs, the 4 outputs and the direct mode's words as
    pointers, the words' count and the stream."""
    return _build.bind("fresh_feasibility", "kt_fresh_feasibility_partial",
                       (ctypes.c_int,) * 12 + (ctypes.c_void_p,) * 26
                       + (ctypes.c_longlong, ctypes.c_void_p))


# the words B1's direct mode asks for at each launch shape (device, P, G,
# T, K, V1, R, O, L), as fresh_layout reports them (0 in the other modes)
_fresh_words: Dict[tuple, int] = {}


def _direct_words(dev, P, G, T, K, V1, R, O, L) -> torch.Tensor:
    """The scratch of B1's direct mode (its word pass's output,
    csrc/fresh_feasibility.cu:DirectWords: the words of the types' and the
    templates' [K] mask rows, each group's zone and capacity-type rows and
    the index's L pair rows); empty where the launch takes another mode."""
    key = (dev.index, P, G, T, K, V1, R, O, L)
    n = _fresh_words.get(key)
    if n is None:
        with _build.device_scope(dev):
            n = _fresh_words[key] = fresh_layout(P, G, T, K, V1, R, O, L)["words"]
    return torch.empty((n,), dtype=torch.int32, device=dev)


def _launch_fresh(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    gk_g, gk_k, gk_w, goff_idx,
    zone_kid: int,
    ct_kid: int,
    partial: bool = False,
    with_base: bool = True,
    out=None,
):
    G, K, V1 = g_mask.shape
    P, R = p_daemon.shape
    T, O = o_avail.shape
    L, LZ = gk_g.shape[0], goff_idx.shape[0]
    dev = g_mask.device
    ins = (g_def, g_neg, g_mask, g_req, p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
           t_def, t_mask, t_alloc, o_avail, o_zone, o_ct, well_known,
           gk_g, gk_k, gk_w, goff_idx)
    for t, name, dtype, shape in zip(ins, _FRESH_NAMES, _FRESH_DTYPES, (
            (G, K), (G, K), (G, K, V1), (G, R), (P, K), (P, K), (P, K, V1), (P, R), (P, G),
            (P, T), (T, K), (T, K, V1), (T, R), (T, O), (T, O), (T, O), (K,),
            (L,), (L,), (L,), (LZ,))):
        _build.check(t, name, dtype, shape, dev)
    if not (0 <= zone_kid < K and 0 <= ct_kid < K):
        raise ValueError(f"zone_kid {zone_kid} / ct_kid {ct_kid} outside K={K}")
    if partial:
        # B1's partial mode: the failure counts, and with the base the
        # type-only parts; nothing finished
        i32 = torch.int32
        parts = _outputs(out, ("fail_t", "fail_c", "tonly", "n_fit")[:4 if with_base else 2],
                         (i32, i32, torch.bool, i32), ((P, G, T), (P, G), (P, G, T), (P, G, T)),
                         dev)
        fail_t, fail_c, tonly, n_fit = parts + [None] * (4 - len(parts))
        words = _direct_words(dev, P, G, T, K, V1, R, O, L)
        with _build.device_scope(dev):
            rc = _fresh_partial_entry()(
                P, G, T, K, V1, R, O, L, LZ, zone_kid, ct_kid, int(with_base),
                *(t.data_ptr() for t in ins),
                fail_t.data_ptr(), fail_c.data_ptr(),
                0 if tonly is None else tonly.data_ptr(),
                0 if n_fit is None else n_fit.data_ptr(),
                words.data_ptr(), words.numel(),
                _build.raw_stream(dev),
            )
        _build.launched("fresh_partial", rc)
        return fail_t, fail_c, tonly, n_fit
    compat_pg = torch.empty((P, G), dtype=torch.bool, device=dev)
    type_ok = torch.empty((P, G, T), dtype=torch.bool, device=dev)
    n_fit = torch.empty((P, G, T), dtype=torch.int32, device=dev)
    words = _direct_words(dev, P, G, T, K, V1, R, O, L)
    with _build.device_scope(dev):
        rc = _fresh_entry()(
            P, G, T, K, V1, R, O, L, LZ, zone_kid, ct_kid,
            *(t.data_ptr() for t in ins),
            compat_pg.data_ptr(), type_ok.data_ptr(), n_fit.data_ptr(),
            words.data_ptr(), words.numel(),
            _build.raw_stream(dev),
        )
    _build.launched("fresh_feasibility", rc)
    return compat_pg, type_ok, n_fit


_FRESH_NAMES = ("g_def", "g_neg", "g_mask", "g_req", "p_def", "p_neg", "p_mask", "p_daemon",
                "p_tol", "p_titype_ok", "t_def", "t_mask", "t_alloc", "o_avail", "o_zone",
                "o_ct", "well_known", "gk_g", "gk_k", "gk_w", "goff_idx")
_FRESH_DTYPES = ((torch.bool,) * 3 + (torch.float32,) + (torch.bool,) * 3 + (torch.float32,)
                 + (torch.bool,) * 4 + (torch.float32, torch.bool, torch.int32, torch.int32,
                                        torch.bool) + (torch.int32,) * 4)
_EXIST_NAMES = ("g_def", "g_neg", "g_mask", "g_req", "n_def", "n_mask", "n_avail", "n_base",
                "n_tol", "gk_g", "gk_k", "gk_w")
_EXIST_DTYPES = ((torch.bool,) * 3 + (torch.float32,) + (torch.bool,) * 2
                 + (torch.float32,) * 2 + (torch.bool,) + (torch.int32,) * 3)


def _launch_existing(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base, n_tol,
    gk_g, gk_k, gk_w,
):
    G, K, V1 = g_mask.shape
    N, R = n_avail.shape
    L = gk_g.shape[0]
    # a scenario batch gates on n_tol [S, N, G]; the plain solve's [N, G]
    # is one scenario without the axis
    lead = tuple(n_tol.shape[:-2])
    S = n_tol.shape[0] if lead else 1
    dev = g_mask.device
    ins = (g_def, g_neg, g_mask, g_req, n_def, n_mask, n_avail, n_base, n_tol, gk_g, gk_k, gk_w)
    for t, name, dtype, shape in zip(ins, _EXIST_NAMES, _EXIST_DTYPES, (
            (G, K), (G, K), (G, K, V1), (G, R), (N, K), (N, K, V1), (N, R), (N, R),
            lead + (N, G), (L,), (L,), (L,))):
        _build.check(t, name, dtype, shape, dev)
    cap_ng = torch.empty(lead + (N, G), dtype=torch.int32, device=dev)
    with _build.device_scope(dev):
        rc = _existing_entry()(
            S, N, G, K, V1, R, L,
            *(t.data_ptr() for t in ins),
            cap_ng.data_ptr(),
            _build.raw_stream(dev),
        )
    _build.launched("existing_feasibility", rc, scenarios=S)
    return cap_ng


def _existing_partial_entry():
    """kt_existing_feasibility_partial with its argument types: 7 ints,
    then the 11 inputs, the 2 outputs and the stream as pointers."""
    return _build.bind("existing_feasibility", "kt_existing_feasibility_partial",
                       (ctypes.c_int,) * 7 + (ctypes.c_void_p,) * 14)


def _launch_existing_partial(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base,
    gk_g, gk_k, gk_w,
    with_base: bool,
    out=None,
):
    G, K, V1 = g_mask.shape
    N, R = n_avail.shape
    L = gk_g.shape[0]
    dev = g_mask.device
    ins = (g_def, g_neg, g_mask, g_req, n_def, n_mask, n_avail, n_base, gk_g, gk_k, gk_w)
    names = _EXIST_NAMES[:8] + _EXIST_NAMES[9:]
    dtypes = _EXIST_DTYPES[:8] + _EXIST_DTYPES[9:]
    for t, name, dtype, shape in zip(ins, names, dtypes, (
            (G, K), (G, K), (G, K, V1), (G, R), (N, K), (N, K, V1), (N, R), (N, R),
            (L,), (L,), (L,))):
        _build.check(t, name, dtype, shape, dev)
    parts = _outputs(out, ("nfail", "cap")[:2 if with_base else 1], (torch.int32,) * 2,
                     ((N, G),) * 2, dev)
    nfail, cap = parts + [None] * (2 - len(parts))
    with _build.device_scope(dev):
        rc = _existing_partial_entry()(
            N, G, K, V1, R, L, int(with_base),
            *(t.data_ptr() for t in ins),
            nfail.data_ptr(), 0 if cap is None else cap.data_ptr(),
            _build.raw_stream(dev),
        )
    _build.launched("existing_partial", rc)
    return nfail, cap


def _mesh_fold_entry():
    """kt_mesh_fold with its argument types: 7 ints, then the 8 inputs, the
    4 outputs and the stream as pointers."""
    return _build.bind("mesh_fold", "kt_mesh_fold",
                       (ctypes.c_int,) * 7 + (ctypes.c_void_p,) * 13)


def _launch_mesh_fold(fail_t, fail_c, tonly, n_fit, p_tol, nfail, cap, n_tol):
    M, P, G, Tm = tonly.shape
    D = 0 if fail_t is None else fail_t.shape[0]
    if not 1 <= max(D, 1) * M <= MAX_SHARDS:
        raise ValueError(f"mesh_fold: {D} x {M} shards (at most {MAX_SHARDS})")
    dev = p_tol.device
    i32 = torch.int32
    _build.check(p_tol, "p_tol", torch.bool, (P, G), dev)
    _build.check(tonly, "tonly", torch.bool, (M, P, G, Tm), dev)
    _build.check(n_fit, "n_fit", i32, (M, P, G, Tm), dev)
    if D:
        _build.check(fail_t, "fail_t", i32, (D, M, P, G, Tm), dev)
        _build.check(fail_c, "fail_c", i32, (D, P, G), dev)
    N, S, lead = 0, 1, ()
    if cap is not None:
        N = cap.shape[0]
        lead = tuple(n_tol.shape[:-2])
        S = n_tol.shape[0] if lead else 1
        _build.check(cap, "cap", i32, (N, G), dev)
        _build.check(n_tol, "n_tol", torch.bool, lead + (N, G), dev)
        if D:
            _build.check(nfail, "nfail", i32, (D, N, G), dev)
    T = M * Tm
    compat_pg = torch.empty((P, G), dtype=torch.bool, device=dev)
    type_ok = torch.empty((P, G, T), dtype=torch.bool, device=dev)
    n_fit_out = torch.empty((P, G, T), dtype=i32, device=dev)
    cap_ng = torch.empty(lead + (N, G), dtype=i32, device=dev) if cap is not None else None
    with _build.device_scope(dev):
        rc = _mesh_fold_entry()(
            D, M, P, G, Tm, N, S,
            fail_t.data_ptr() if D else 0, fail_c.data_ptr() if D else 0,
            tonly.data_ptr(), n_fit.data_ptr(),
            nfail.data_ptr() if D and N else 0,
            p_tol.data_ptr(), cap.data_ptr() if N else 0, n_tol.data_ptr() if N else 0,
            compat_pg.data_ptr(), type_ok.data_ptr(), n_fit_out.data_ptr(),
            cap_ng.data_ptr() if N else 0,
            _build.raw_stream(dev),
        )
    _build.launched("mesh_fold", rc)
    return compat_pg, type_ok, n_fit_out, cap_ng


def _dense_fresh_entry():
    """kt_dense_fresh with its argument types: 9 ints, then the 17 inputs,
    the 3 outputs and the stream as pointers."""
    return _build.bind("dense_feasibility", "kt_dense_fresh",
                       (ctypes.c_int,) * 9 + (ctypes.c_void_p,) * 21)


def _dense_existing_entry():
    """kt_dense_existing with its argument types: 6 ints, then the 9
    inputs, the output and the stream as pointers."""
    return _build.bind("dense_feasibility", "kt_dense_existing",
                       (ctypes.c_int,) * 6 + (ctypes.c_void_p,) * 11)


_DENSE_NAMES = _FRESH_NAMES[:17]
_DENSE_DTYPES = _FRESH_DTYPES[:17]


def _launch_dense_fresh(
    g_def, g_neg, g_mask, g_req,
    p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
    t_def, t_mask, t_alloc,
    o_avail, o_zone, o_ct,
    well_known,
    zone_kid: int,
    ct_kid: int,
    out=None,
):
    G, K, V1 = g_mask.shape
    P, R = p_daemon.shape
    T, O = o_avail.shape
    dev = g_mask.device
    ins = (g_def, g_neg, g_mask, g_req, p_def, p_neg, p_mask, p_daemon, p_tol, p_titype_ok,
           t_def, t_mask, t_alloc, o_avail, o_zone, o_ct, well_known)
    for t, name, dtype, shape in zip(ins, _DENSE_NAMES, _DENSE_DTYPES, (
            (G, K), (G, K), (G, K, V1), (G, R), (P, K), (P, K), (P, K, V1), (P, R), (P, G),
            (P, T), (T, K), (T, K, V1), (T, R), (T, O), (T, O), (T, O), (K,))):
        _build.check(t, name, dtype, shape, dev)
    if not (0 <= zone_kid < K and 0 <= ct_kid < K):
        raise ValueError(f"zone_kid {zone_kid} / ct_kid {ct_kid} outside K={K}")
    compat_pg, type_ok, n_fit = _outputs(
        out, ("compat_pg", "type_ok", "n_fit"), (torch.bool, torch.bool, torch.int32),
        ((P, G), (P, G, T), (P, G, T)), dev)
    with _build.device_scope(dev):
        rc = _dense_fresh_entry()(
            P, G, T, K, V1, R, O, zone_kid, ct_kid,
            *(t.data_ptr() for t in ins),
            compat_pg.data_ptr(), type_ok.data_ptr(), n_fit.data_ptr(),
            _build.raw_stream(dev),
        )
    _build.launched("dense_feasibility", rc, variants=("dense_fresh",))
    return compat_pg, type_ok, n_fit


def _launch_dense_existing(
    g_def, g_neg, g_mask, g_req,
    n_def, n_mask, n_avail, n_base, n_tol,
    well_known,
):
    G, K, V1 = g_mask.shape
    N, R = n_avail.shape
    # a scenario batch gates on n_tol [S, N, G], as for B2
    lead = tuple(n_tol.shape[:-2])
    S = n_tol.shape[0] if lead else 1
    dev = g_mask.device
    ins = (g_def, g_neg, g_mask, g_req, n_def, n_mask, n_avail, n_base, n_tol)
    for t, name, dtype, shape in zip(ins, _EXIST_NAMES, _EXIST_DTYPES, (
            (G, K), (G, K), (G, K, V1), (G, R), (N, K), (N, K, V1), (N, R), (N, R),
            lead + (N, G))):
        _build.check(t, name, dtype, shape, dev)
    # existing nodes get no well-known allowance: checked, not passed
    _build.check(well_known, "well_known", torch.bool, (K,), dev)
    cap_ng = torch.empty(lead + (N, G), dtype=torch.int32, device=dev)
    with _build.device_scope(dev):
        rc = _dense_existing_entry()(
            S, N, G, K, V1, R,
            *(t.data_ptr() for t in ins),
            cap_ng.data_ptr(),
            _build.raw_stream(dev),
        )
    _build.launched("dense_feasibility", rc, scenarios=S, variants=("dense_existing",))
    return cap_ng


def fresh_layout(P: int, G: int, T: int, K: int, V1: int, R: int, O: int, L: int) -> dict:
    """The tiles, mode and shared memory B1 (csrc/fresh_feasibility.cu)
    takes at these shapes with an index of L pairs: TT, TG, the pair chunk
    PC, the mode ("staged": mask bytes staged in shared memory; "direct":
    bit words from a word pass across the card, staged; "rows": no words
    kept, each read from the byte rows), the block's bytes and the words
    the direct mode's pass writes (0 in the others). Loads the library; no
    launch."""
    out = (ctypes.c_longlong * 6)()
    _build.bind("fresh_feasibility", "kt_fresh_feasibility_layout",
                (ctypes.c_int,) * 8 + (ctypes.c_void_p,))(
        P, G, T, K, V1, R, O, L, ctypes.addressof(out))
    return dict(TT=out[0], TG=out[1], PC=out[2], mode=("staged", "direct", "rows")[out[3]],
                smem=out[4], words=out[5])


def dense_layout(P: int, N: int, G: int, T: int, K: int, V1: int, R: int, O: int) -> dict:
    """The tiles, mode and shared memory of B3's fresh entry (``N`` < 0)
    or existing entry (N nodes) at these shapes: the two tiles (fresh TT
    and TG, existing TN and TG), the mode ("words": bit words built
    straight from device memory; "rows": none kept, each read from the
    byte rows) and the block's bytes. Loads the library; no launch."""
    out = (ctypes.c_longlong * 4)()
    _build.bind("dense_feasibility", "kt_dense_layout",
                (ctypes.c_int,) * 8 + (ctypes.c_void_p,))(
        P, N, G, T, K, V1, R, O, ctypes.addressof(out))
    return dict(tiles=(out[0], out[1]), mode=("words", "rows")[out[2]], smem=out[3])
