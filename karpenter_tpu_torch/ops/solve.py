"""The fused solve: the PyTorch port of karpenter_tpu/ops/solve.py.

One dispatch runs the feasibility tables (ops/feasibility.py), the
packing scan (ops/packing.py) and the wire pack on the device the
arguments live on: four kernel launches on CUDA (B1, B2 when there are
existing nodes, B4, B6), their plain versions on the CPU. Outputs stay on
the device until TorchSolver's single drain.

Not in this slice (each raises NotImplementedError): the dense
feasibility twins (B3) and the tiled mode, the class-batched scan (B5),
the scenario axis (B7) and the row-delta apply (B8).
"""

from __future__ import annotations

import torch

from .. import _build, faults, obs
from ..solver.encode import SOLVE_ARG_NAMES
from .feasibility import (
    existing_node_feasibility_sparse,
    fresh_claim_feasibility_sparse,
)
from .packing import check_scope, pack


def _feasibility_tables(a, zone_kid: int, ct_kid: int):
    """The [P,G(,T)] / [N,G] tables the scan consumes, from the sparse
    (segment-contraction) twins over the encoder's live-pair index."""
    compat_pg, type_ok, n_fit = fresh_claim_feasibility_sparse(
        a["g_def"], a["g_neg"], a["g_mask"], a["g_req"],
        a["p_def"], a["p_neg"], a["p_mask"], a["p_daemon"], a["p_tol"],
        a["p_titype_ok"],
        a["t_def"], a["t_mask"], a["t_alloc"],
        a["o_avail"], a["o_zone"], a["o_ct"],
        a["well_known"],
        a["gk_g"], a["gk_k"], a["gk_w"], a["goff_idx"],
        zone_kid=zone_kid,
        ct_kid=ct_kid,
    )
    if a["n_avail"].shape[0]:
        cap_ng = existing_node_feasibility_sparse(
            a["g_def"], a["g_neg"], a["g_mask"], a["g_req"],
            a["n_def"], a["n_mask"], a["n_avail"], a["n_base"], a["n_tol"],
            a["gk_g"], a["gk_k"], a["gk_w"],
        )
    else:
        cap_ng = torch.zeros(
            (0, a["g_count"].shape[0]), dtype=torch.int32,
            device=a["g_count"].device,
        )
    return compat_pg, type_ok, n_fit, cap_ng


def solve_core(
    *args,
    nmax: int,
    zone_kid: int,
    ct_kid: int,
    has_domains: bool = True,
    has_contrib: bool = False,
    tile_feasibility: bool = False,
    wf_iters: int = 32,
    sparse_groups: bool = False,
):
    """ops/solve.py:solve_core over the positional ``solve_args`` tuple
    (encode.SOLVE_ARG_NAMES order, tensors on one device). Returns the 10
    outputs (c_pool, c_tmask, n_open, overflow, exist_fills, claim_fills,
    unplaced, c_dzone, c_dct, c_resv)."""
    a = dict(zip(SOLVE_ARG_NAMES, args))
    check_scope(
        has_domains, has_contrib, tile_feasibility,
        a["res_cap0"].shape[0], a["p_mvmin"].shape[1],
    )
    if not sparse_groups:
        raise NotImplementedError(
            "the dense feasibility twins (B3) are not ported; pass "
            "sparse_groups=True (bit-exact with the dense tables)"
        )
    compat_pg, type_ok, n_fit, cap_ng = _feasibility_tables(a, zone_kid, ct_kid)
    return pack(
        a["g_count"], a["g_req"], a["g_def"], a["g_neg"], a["g_mask"],
        a["g_hcap"], a["g_haff"],
        a["g_hstg"], a["g_hscap"], a["g_hself"],
        compat_pg, type_ok, n_fit,
        cap_ng,
        a["t_alloc"], a["t_cap"],
        a["a_tzc"],
        a["p_daemon"], a["p_limit"], a["p_has_limit"], a["p_tol"],
        a["n_avail"], a["n_base"],
        a["n_hcnt"],
        a["nh_cnt0"],
        a["well_known"],
        nmax=nmax,
        zone_kid=zone_kid,
        ct_kid=ct_kid,
        wf_iters=wf_iters,
    )


# MSB-first bit weights, matching numpy's unpackbits(bitorder="big")
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def wire_pack_reference(outs, fills_dtype):
    """Plain version of ops/solve.py:_wire_pack: the [NMAX, T] claim/type
    mask bit-packs 8x into uint8 rows, c_pool/c_dzone/c_dct narrow to
    int16 and the fill matrices to ``fills_dtype``."""
    (c_pool, c_tmask, n_open, overflow,
     exist_fills, claim_fills, unplaced, c_dzone, c_dct, c_resv) = outs
    n, t = c_tmask.shape
    t_pad = -(-t // 8) * 8
    padded = torch.nn.functional.pad(c_tmask.to(torch.uint8), (0, t_pad - t))
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=c_tmask.device)
    packed = (padded.reshape(n, t_pad // 8, 8) * weights).sum(-1).to(torch.uint8)
    return (
        c_pool.to(torch.int16),
        packed,
        n_open,
        overflow,
        exist_fills.to(fills_dtype),
        claim_fills.to(fills_dtype),
        unplaced,
        c_dzone.to(torch.int16),
        c_dct.to(torch.int16),
        c_resv,
    )


def wire_pack(outs, fills_dtype):
    """The wire-compact outputs: ``wire_pack_reference`` for CPU tensors,
    kernel B6 (csrc/wire_pack.cu) for CUDA tensors."""
    if outs[1].device.type == "cpu":
        return wire_pack_reference(outs, fills_dtype)
    return _launch_wire_pack(outs, fills_dtype)


def _launch_wire_pack(outs, fills_dtype):
    import ctypes

    (c_pool, c_tmask, n_open, overflow,
     exist_fills, claim_fills, unplaced, c_dzone, c_dct, c_resv) = outs
    if fills_dtype not in (torch.int16, torch.int32):
        raise ValueError(f"fills_dtype {fills_dtype}: int16 or int32 only")
    nmax, t = c_tmask.shape
    g, n = exist_fills.shape
    dev = c_tmask.device
    i32 = torch.int32
    for x, name, dt, shape in (
        (c_pool, "c_pool", i32, (nmax,)), (c_tmask, "c_tmask", torch.bool, (nmax, t)),
        (exist_fills, "exist_fills", i32, (g, n)),
        (claim_fills, "claim_fills", i32, (g, nmax)),
        (c_dzone, "c_dzone", i32, (nmax,)), (c_dct, "c_dct", i32, (nmax,)),
    ):
        _build.check(x, name, dt, shape, dev)
    pool16 = torch.empty((nmax,), dtype=torch.int16, device=dev)
    packed = torch.empty((nmax, -(-t // 8)), dtype=torch.uint8, device=dev)
    exist_out = torch.empty((g, n), dtype=fills_dtype, device=dev)
    claim_out = torch.empty((g, nmax), dtype=fills_dtype, device=dev)
    dzone16 = torch.empty((nmax,), dtype=torch.int16, device=dev)
    dct16 = torch.empty((nmax,), dtype=torch.int16, device=dev)
    fn = _build.library("wire_pack").kt_wire_pack
    p = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(
            ctypes.c_int(nmax), ctypes.c_int(t), ctypes.c_int(g), ctypes.c_int(n),
            ctypes.c_int(int(fills_dtype == torch.int16)),
            p(c_pool), p(c_tmask), p(exist_fills), p(claim_fills),
            p(c_dzone), p(c_dct),
            p(pool16), p(packed), p(exist_out), p(claim_out),
            p(dzone16), p(dct16),
            _build.stream(),
        )
    _build.launched("wire_pack", rc)
    return (
        pool16, packed, n_open, overflow, exist_out, claim_out, unplaced,
        dzone16, dct16, c_resv,
    )


def solve_core_packed(*args, fills_dtype=torch.int32, **statics):
    return wire_pack(solve_core(*args, **statics), fills_dtype)


# -- fault seam -------------------------------------------------------------
#
# The kernels stay pure; chaos testing (faults/) hooks the HOST side of the
# dispatch: an error site before the call and a mutation site on the
# outputs (the garbage-solve shape the invariant guard must catch). With no
# injector installed each costs one global None check.


def dispatch_packed(*args, **kw):
    faults.hit(faults.SOLVER_DISPATCH, kernel="pack")
    with obs.span("kernel.dispatch", kernel="pack"):
        out = solve_core_packed(*args, **kw)
    return faults.mutate(faults.SOLVER_OUTPUT, out, kernel="pack")
