"""The fused solve: the PyTorch port of karpenter_tpu/ops/solve.py.

One dispatch runs the feasibility tables (ops/feasibility.py), the
packing scan (ops/packing.py) and the wire pack on the device the
arguments live on: four kernel launches on CUDA (B1, B2 when there are
existing nodes, B4, B6), their plain versions on the CPU. Outputs stay on
the device until TorchSolver's single drain.

The scenario axis (B7, consolidation's probe sets) is the same dispatch
with ``g_count`` [S, G] and ``n_tol`` [S, N, G] batched (plus the prior
arrays ``n_hcnt``, ``nh_cnt0``, ``g_dprior`` and ``dd0`` under
``batch_topo``): B1 still launches once, since its
inputs are shared; B2 writes [S, N, G]; B4 runs one block per scenario;
B6 folds the scenarios into its rows. Still four launches per dispatch.

The row-delta apply (B8, ``delta_apply_rows``) keeps the solve's
arguments resident on the card between solves (solver/residency.py):
churn moves only the changed rows, scattered into a copy of the resident
buffer by csrc/apply_rows.cu.

The class-batched variant (``solve_core_classed``, B5 in place of B4)
runs the same dispatch over the driver's class partition: batches of many
small groups sharing few feasibility classes.

Not in this slice (each raises NotImplementedError): the dense
feasibility twins (B3) and the tiled mode.
"""

from __future__ import annotations

import math

import torch

from .. import _build, faults, obs
from ..solver.encode import SOLVE_ARG_NAMES
from .feasibility import (
    existing_node_feasibility_sparse,
    fresh_claim_feasibility_sparse,
)
from .packing import check_scope, classed_results, pack, pack_classed


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
        # no existing nodes: an empty table, with n_tol's scenario axis
        cap_ng = torch.zeros(
            tuple(a["n_tol"].shape[:-2]) + (0, a["g_mask"].shape[0]),
            dtype=torch.int32, device=a["g_mask"].device,
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
    unplaced, c_dzone, c_dct, c_resv). Given a scenario batch (see
    ``solve_scenarios_core_packed``) every output has a leading [S]."""
    a = dict(zip(SOLVE_ARG_NAMES, args))
    return pack(
        *_scan_inputs(a, zone_kid, ct_kid, tile_feasibility, sparse_groups),
        nmax=nmax,
        zone_kid=zone_kid,
        ct_kid=ct_kid,
        has_domains=has_domains,
        has_contrib=has_contrib,
        wf_iters=wf_iters,
    )


def _scan_inputs(a, zone_kid, ct_kid, tile_feasibility, sparse_groups):
    """The scan's positional inputs from the named solve args ``a``: the
    scope check, then the feasibility tables (B1, and B2 when there are
    existing nodes)."""
    check_scope(tile_feasibility, a["res_cap0"].shape[0], a["p_mvmin"].shape[1])
    if not sparse_groups:
        raise NotImplementedError(
            "the dense feasibility twins (B3) are not ported; pass "
            "sparse_groups=True (bit-exact with the dense tables)"
        )
    return pack_args(a, *_feasibility_tables(a, zone_kid, ct_kid))


def solve_core_classed(
    *args,
    nmax: int,
    lmax: int,
    zone_kid: int,
    ct_kid: int,
    has_domains: bool = True,
    has_contrib: bool = False,
    tile_feasibility: bool = False,
    wf_iters: int = 32,
    sparse_groups: bool = False,
):
    """ops/solve.py:solve_core_classed: ``solve_core`` over the
    class-batched scan (B5). Trailing positional args after the solve
    args: class_start, class_len, class_dyn, class_dkey, inv_idx (the
    driver's class partition, staged per solve); ``lmax`` the member
    bucket. The same 10 outputs as ``solve_core``, decision for decision.
    Like pack_classed, it takes no reservation ledger (NRES > 0 raises)."""
    n = len(SOLVE_ARG_NAMES)
    a = dict(zip(SOLVE_ARG_NAMES, args[:n]))
    classes = args[n:]
    if len(classes) != 5:
        raise ValueError(f"expected the 5 class arrays after the solve args, got {len(classes)}")
    return classed_results(*pack_classed(
        *_scan_inputs(a, zone_kid, ct_kid, tile_feasibility, sparse_groups),
        *classes,
        nmax=nmax,
        lmax=lmax,
        zone_kid=zone_kid,
        ct_kid=ct_kid,
        has_domains=has_domains,
        has_contrib=has_contrib,
        wf_iters=wf_iters,
    ))


# the solve args the packing scan reads, in its positional order around the
# four feasibility tables (ops/packing.py:pack_reference)
PACK_HEAD = ("g_count", "g_req", "g_def", "g_neg", "g_mask", "g_hcap",
             "g_haff", "g_hstg", "g_hscap", "g_hself")
PACK_TAIL = ("t_alloc", "t_cap", "a_tzc", "p_daemon", "p_limit",
             "p_has_limit", "p_tol", "n_avail", "n_base", "n_hcnt", "nh_cnt0",
             "well_known", "g_dmode", "g_dkey", "g_dskew", "g_dmin0",
             "g_dprior", "g_dreg", "g_drank", "g_dtg", "p_mask", "n_dzone",
             "n_dct", "dd0", "g_hcontrib", "g_dcontrib", "dtg_key")


def pack_args(a, compat_pg, type_ok, n_fit, cap_ng):
    """The packing scan's positional inputs from the named solve args
    ``a`` and the feasibility tables."""
    return (
        [a[n] for n in PACK_HEAD] + [compat_pg, type_ok, n_fit, cap_ng]
        + [a[n] for n in PACK_TAIL]
    )


# MSB-first bit weights, matching numpy's unpackbits(bitorder="big")
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def wire_pack_reference(outs, fills_dtype):
    """Plain version of ops/solve.py:_wire_pack: the [NMAX, T] claim/type
    mask bit-packs 8x into uint8 rows, c_pool/c_dzone/c_dct narrow to
    int16 and the fill matrices to ``fills_dtype``. Leading scenario axes
    pass through (the pack is row-wise, the rest elementwise)."""
    (c_pool, c_tmask, n_open, overflow,
     exist_fills, claim_fills, unplaced, c_dzone, c_dct, c_resv) = outs
    *lead, n, t = c_tmask.shape
    t_pad = -(-t // 8) * 8
    padded = torch.nn.functional.pad(c_tmask.to(torch.uint8), (0, t_pad - t))
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=c_tmask.device)
    packed = (
        padded.reshape(*lead, n, t_pad // 8, 8) * weights
    ).sum(-1).to(torch.uint8)
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
    # a scenario batch's leading [S] (absent for the plain solve)
    lead = tuple(c_tmask.shape[:-2])
    S = math.prod(lead)
    nmax, t = c_tmask.shape[-2:]
    g, n = exist_fills.shape[-2:]
    dev = c_tmask.device
    i32 = torch.int32
    for x, name, dt, shape in (
        (c_pool, "c_pool", i32, (nmax,)), (c_tmask, "c_tmask", torch.bool, (nmax, t)),
        (exist_fills, "exist_fills", i32, (g, n)),
        (claim_fills, "claim_fills", i32, (g, nmax)),
        (c_dzone, "c_dzone", i32, (nmax,)), (c_dct, "c_dct", i32, (nmax,)),
    ):
        _build.check(x, name, dt, lead + shape, dev)

    def empty(shape, dtype):
        return torch.empty(lead + shape, dtype=dtype, device=dev)

    pool16 = empty((nmax,), torch.int16)
    packed = empty((nmax, -(-t // 8)), torch.uint8)
    exist_out = empty((g, n), fills_dtype)
    claim_out = empty((g, nmax), fills_dtype)
    dzone16 = empty((nmax,), torch.int16)
    dct16 = empty((nmax,), torch.int16)
    fn = _build.library("wire_pack").kt_wire_pack
    p = _build.ptr
    # The kernel's mask pack is row-wise and its narrowing casts are
    # elementwise over flat buffers, so S scenarios ride one launch as
    # S * NMAX mask rows and pool entries, with the fills counted as
    # g x (S * n) and g x (S * NMAX) elements: the same element counts as
    # [S, g, n] and [S, g, NMAX].
    with torch.cuda.device(dev):
        rc = fn(
            ctypes.c_int(S * nmax), ctypes.c_int(t), ctypes.c_int(g),
            ctypes.c_int(S * n),
            ctypes.c_int(int(fills_dtype == torch.int16)),
            p(c_pool), p(c_tmask), p(exist_fills), p(claim_fills),
            p(c_dzone), p(c_dct),
            p(pool16), p(packed), p(exist_out), p(claim_out),
            p(dzone16), p(dct16),
            _build.stream(),
        )
    _build.launched("wire_pack", rc, scenarios=S)
    return (
        pool16, packed, n_open, overflow, exist_out, claim_out, unplaced,
        dzone16, dct16, c_resv,
    )


def solve_core_packed(*args, fills_dtype=torch.int32, **statics):
    return wire_pack(solve_core(*args, **statics), fills_dtype)


def solve_core_classed_packed(*args, fills_dtype=torch.int32, **statics):
    return wire_pack(solve_core_classed(*args, **statics), fills_dtype)


# -- scenario axis ----------------------------------------------------------
#
# Consolidation's replacement search solves one cluster snapshot many times,
# varying only which candidate nodes are gone (n_tol rows zeroed: a node no
# group tolerates receives no fills) and which of their pods are back in the
# workload (g_count). Everything else is encoded once and shared.

SCENARIO_BATCHED_ARGS = ("g_count", "n_tol")
# topology-carrying searches additionally batch the prior arrays (g_dprior
# and dd0 are read by the scan's domain machinery, under has_domains)
SCENARIO_TOPO_BATCHED_ARGS = SCENARIO_BATCHED_ARGS + (
    "g_dprior", "n_hcnt", "nh_cnt0", "dd0",
)
# each name's rank without the scenario axis
_UNBATCHED_RANK = {
    "g_count": 1, "n_tol": 2, "g_dprior": 2, "n_hcnt": 2, "nh_cnt0": 2,
    "dd0": 2,
}


def solve_scenarios_core_packed(
    *args, fills_dtype=torch.int32, batch_topo: bool = False, **statics
):
    """ops/solve.py:solve_scenarios_core_packed: solve_core_packed over a
    leading scenario axis on (g_count, n_tol), plus the topology prior
    arrays when ``batch_topo``; every other arg is shared. Outputs gain a
    leading [S] and stay wire-packed per scenario. One launch of each
    kernel covers every scenario."""
    batched = SCENARIO_TOPO_BATCHED_ARGS if batch_topo else SCENARIO_BATCHED_ARGS
    a = dict(zip(SOLVE_ARG_NAMES, args))
    S = a["g_count"].shape[0]
    for name, rank in _UNBATCHED_RANK.items():
        want = rank + 1 if name in batched else rank
        if a[name].dim() != want or (name in batched and a[name].shape[0] != S):
            raise ValueError(
                f"{name}: shape {tuple(a[name].shape)}, expected rank {want}"
                + (f" with {S} scenarios" if name in batched else "")
            )
    return wire_pack(solve_core(*args, **statics), fills_dtype)


# -- device-resident delta apply (B8) ----------------------------------------
#
# The residency store (solver/residency.py) keeps the encoded cluster on the
# device between solves; churn arrives as row deltas. The apply returns a
# fresh buffer and leaves the old one valid: a launched dispatch (a
# consolidation prefetch, an overflow resubmit) may still read it.

_APPLY_DTYPES = {torch.bool: 1, torch.int32: 4, torch.float32: 4}


def _rows_on(arr, idx, rows):
    """``idx`` (int32) and ``rows`` (arr's dtype) as tensors on arr's
    device; numpy inputs are copied there."""
    import numpy as np

    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32))
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    idx = idx.to(arr.device, torch.int32).contiguous()
    rows = rows.to(arr.device).contiguous()
    if rows.dtype != arr.dtype or tuple(rows.shape) != (idx.shape[0],) + tuple(arr.shape[1:]):
        raise ValueError(
            f"rows {rows.dtype}{tuple(rows.shape)} do not fit {idx.shape[0]} rows of "
            f"{arr.dtype}{tuple(arr.shape)}"
        )
    return idx, rows


def delta_apply_rows_reference(arr, idx, rows):
    """Plain version of ops/solve.py:_apply_rows_core: ``arr`` with
    ``arr[idx] = rows`` as a new tensor (``index_copy`` on a clone). A
    negative index counts from the end; one outside the rows is dropped."""
    n = arr.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    return arr.clone().index_copy_(0, idx[keep], rows[keep])


def delta_apply_rows(arr, idx, rows):
    """Row update of a device-resident buffer: ``arr[idx] = rows``, as a new
    tensor; ``arr`` itself is left as it was. ``arr`` is bool,
    int32 or float32 with any trailing shape; ``idx`` [n] int32 and
    ``rows`` [n, ...] may be numpy arrays. The plain version for a CPU
    ``arr``, kernel B8 (csrc/apply_rows.cu) for a CUDA one."""
    if not len(idx):
        return arr
    idx, rows = _rows_on(arr, idx, rows)
    if arr.device.type == "cpu":
        return delta_apply_rows_reference(arr, idx, rows)
    return _launch_apply_rows(arr, idx, rows)


def _launch_apply_rows(arr, idx, rows):
    import ctypes

    if arr.dtype not in _APPLY_DTYPES:
        raise ValueError(f"delta_apply_rows: dtype {arr.dtype} (bool, int32, float32 only)")
    if not arr.is_contiguous():
        raise ValueError("delta_apply_rows: the resident buffer is not contiguous")
    out = arr.clone()
    row_elems = math.prod(arr.shape[1:])
    fn = _build.library("apply_rows").kt_apply_rows
    with torch.cuda.device(arr.device):
        rc = fn(
            ctypes.c_longlong(arr.shape[0]), ctypes.c_longlong(idx.shape[0]),
            ctypes.c_longlong(row_elems), ctypes.c_int(_APPLY_DTYPES[arr.dtype]),
            _build.ptr(idx), _build.ptr(rows), _build.ptr(out), _build.stream(),
        )
    _build.launched("apply_rows", rc)
    return out


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


def dispatch_classed_packed(*args, **kw):
    faults.hit(faults.SOLVER_DISPATCH, kernel="pack_classed")
    with obs.span("kernel.dispatch", kernel="pack_classed"):
        out = solve_core_classed_packed(*args, **kw)
    return faults.mutate(faults.SOLVER_OUTPUT, out, kernel="pack_classed")


def dispatch_scenarios_packed(*args, **kw):
    faults.hit(faults.SOLVER_SCENARIOS, kernel="scenarios")
    with obs.span("kernel.dispatch", kernel="scenarios"):
        out = solve_scenarios_core_packed(*args, **kw)
    return faults.mutate(faults.SOLVER_OUTPUT, out, kernel="scenarios")
