"""The fused solve: the PyTorch port of karpenter_tpu/ops/solve.py.

One dispatch runs the feasibility tables (ops/feasibility.py), the
packing scan (ops/packing.py) and the wire pack on the device the
arguments live on: four kernel launches on CUDA (B1, B2 when there are
existing nodes, B4, B6), their plain versions on the CPU. Outputs stay on
the device until TorchSolver's single drain. With ``sparse_groups``
False the tables come from the dense twins (B3's two entries) in place
of B1 and B2, as in the JAX package; the driver passes True.

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

Over the solver mesh (B10, parallel/mesh.py: ``solve_core_mesh``,
``solve_scenarios_core_mesh_packed``) each of the D x M shards of a
scenario block launches B1's partial mode over its live-pair and type
slices (and D of them B2's), one fold (csrc/mesh_fold.cu) finishes the
tables on the block's lead device, and B4 and B6 run there once. A row
update of a buffer sharded on its leading axis applies shard-locally
(``delta_apply_rows_sharded``): each shard's B8 launch gets only its own
rows.

minValues floors and the reservation ledger ride the same dispatch
(B4, and B5 for minValues). So does the tiled mode
(``tile_feasibility``, the HBM-scaling route the driver takes when the
tables would pass 1.5 GiB): no table launch at all, zero-G placeholders,
and the scan (B4, B5 or B7's grid) builds each step's rows itself.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from .. import _build, faults, obs
from ..solver.encode import SOLVE_ARG_NAMES
from .feasibility import (
    existing_node_feasibility,
    existing_node_feasibility_partial,
    existing_node_feasibility_sparse,
    fresh_claim_feasibility,
    fresh_claim_feasibility_partial,
    fresh_claim_feasibility_sparse,
    mesh_fold,
)
from .packing import PACK_HEAD, PACK_TAIL, TileInputs, classed_results, pack, pack_classed


_FRESH_ARGS = ("g_def", "g_neg", "g_mask", "g_req",
               "p_def", "p_neg", "p_mask", "p_daemon", "p_tol", "p_titype_ok",
               "t_def", "t_mask", "t_alloc", "o_avail", "o_zone", "o_ct",
               "well_known")
_EXIST_ARGS = ("g_def", "g_neg", "g_mask", "g_req",
               "n_def", "n_mask", "n_avail", "n_base", "n_tol")
_SPARSE_INDEX = ("gk_g", "gk_k", "gk_w")


def _feasibility_tables(a, zone_kid: int, ct_kid: int, sparse_groups: bool = True,
                        tile_feasibility: bool = False):
    """The [P,G(,T)] / [N,G] tables the scan consumes: from the sparse
    (segment-contraction) twins over the encoder's live-pair index (B1,
    B2) when ``sparse_groups``, else from the dense twins (B3). The tables
    are bit-exact either way. In the tiled mode, zero-G placeholders
    ([P,0], [P,0,T], [P,0,T], [N,0] with n_tol's scenario axis) and no
    launch: the scan builds its own rows."""
    if tile_feasibility:
        P, T = a["p_titype_ok"].shape
        dev = a["p_titype_ok"].device
        lead = tuple(a["n_tol"].shape[:-2])
        return (
            torch.zeros((P, 0), dtype=torch.bool, device=dev),
            torch.zeros((P, 0, T), dtype=torch.bool, device=dev),
            torch.zeros((P, 0, T), dtype=torch.int32, device=dev),
            torch.zeros(lead + (a["n_avail"].shape[0], 0), dtype=torch.int32, device=dev),
        )
    fresh = [a[n] for n in _FRESH_ARGS]
    if sparse_groups:
        compat_pg, type_ok, n_fit = fresh_claim_feasibility_sparse(
            *fresh, *(a[n] for n in _SPARSE_INDEX), a["goff_idx"],
            zone_kid=zone_kid, ct_kid=ct_kid,
        )
    else:
        compat_pg, type_ok, n_fit = fresh_claim_feasibility(
            *fresh, zone_kid=zone_kid, ct_kid=ct_kid,
        )
    if a["n_avail"].shape[0]:
        exist = [a[n] for n in _EXIST_ARGS]
        if sparse_groups:
            cap_ng = existing_node_feasibility_sparse(
                *exist, *(a[n] for n in _SPARSE_INDEX)
            )
        else:
            cap_ng = existing_node_feasibility(*exist, a["well_known"])
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
        tile_feasibility=tile_feasibility,
        wf_iters=wf_iters,
    )


def _scan_inputs(a, zone_kid, ct_kid, tile_feasibility, sparse_groups):
    """The scan's positional inputs from the named solve args ``a``: the
    feasibility tables (B1, and B2 when there are existing nodes; B3 in
    their place without ``sparse_groups``; placeholders in the tiled
    mode, where ``sparse_groups`` is not read)."""
    return pack_args(a, *_feasibility_tables(
        a, zone_kid, ct_kid, sparse_groups, tile_feasibility))


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
    Like pack_classed, it takes no reservation ledger (NRES > 0 raises
    ValueError; the driver routes such batches to ``solve_core``)."""
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
        tile_feasibility=tile_feasibility,
        wf_iters=wf_iters,
    ))


def pack_args(a, compat_pg, type_ok, n_fit, cap_ng):
    """The packing scan's positional inputs from the named solve args
    ``a`` and the feasibility tables."""
    return (
        [a[n] for n in PACK_HEAD] + [compat_pg, type_ok, n_fit, cap_ng]
        + [a[n] for n in PACK_TAIL] + [TileInputs(*(a[n] for n in TileInputs._fields))]
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


def _wire_pack_entry():
    """kt_wire_pack with its argument types: 5 ints, then the 6 inputs,
    the 6 outputs and the stream as pointers."""
    return _build.bind("wire_pack", "kt_wire_pack", (ctypes.c_int,) * 5 + (ctypes.c_void_p,) * 13)


def _launch_wire_pack(outs, fills_dtype):
    (c_pool, c_tmask, n_open, overflow,
     exist_fills, claim_fills, unplaced, c_dzone, c_dct, c_resv) = outs
    if fills_dtype is not torch.int16 and fills_dtype is not torch.int32:
        raise ValueError(f"fills_dtype {fills_dtype}: int16 or int32 only")
    # a scenario batch's leading [S] (absent for the plain solve)
    lead = c_tmask.shape[:-2]
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
    i16 = torch.int16
    pool16 = torch.empty(lead + (nmax,), dtype=i16, device=dev)
    packed = torch.empty(lead + (nmax, -(-t // 8)), dtype=torch.uint8, device=dev)
    exist_out = torch.empty(lead + (g, n), dtype=fills_dtype, device=dev)
    claim_out = torch.empty(lead + (g, nmax), dtype=fills_dtype, device=dev)
    dzone16 = torch.empty(lead + (nmax,), dtype=i16, device=dev)
    dct16 = torch.empty(lead + (nmax,), dtype=i16, device=dev)
    # The kernel's mask pack is row-wise and its narrowing casts are
    # elementwise over flat buffers, so S scenarios ride one launch as
    # S * NMAX mask rows and pool entries, with the fills counted as
    # g x (S * n) and g x (S * NMAX) elements: the same element counts as
    # [S, g, n] and [S, g, NMAX].
    with _build.device_scope(dev):
        rc = _wire_pack_entry()(
            S * nmax, t, g, S * n, int(fills_dtype is i16),
            c_pool.data_ptr(), c_tmask.data_ptr(), exist_fills.data_ptr(),
            claim_fills.data_ptr(), c_dzone.data_ptr(), c_dct.data_ptr(),
            pool16.data_ptr(), packed.data_ptr(), exist_out.data_ptr(), claim_out.data_ptr(),
            dzone16.data_ptr(), dct16.data_ptr(),
            _build.raw_stream(dev),
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
# device between solves; churn arrives as row deltas. Two twins, as in the
# JAX package: the plain apply (the default) returns a fresh buffer and
# leaves the old one valid, since a queue token (a consolidation prefetch,
# an overflow resubmit, a sidecar solve sharing the store) may still read
# it. The donated apply (KTPU_DONATE_DELTA=1, on a CUDA tensor; a CPU
# tensor takes the plain apply, as JAX's CPU backend does) writes the rows
# into the buffer itself, so a 50k-pod encoding is never held twice on the
# card, and hands back a new tensor over the same memory: the old tensor
# object is emptied, so a token still holding it raises at its next launch
# (JAX deletes a donated buffer) instead of computing on rows its host
# snapshot never had.

def _rows_on(arr, idx, rows):
    """``idx`` (int32) and ``rows`` (arr's dtype) as tensors on arr's
    device; numpy inputs are copied there."""
    import numpy as np

    dev = arr.device
    if (isinstance(idx, torch.Tensor) and isinstance(rows, torch.Tensor)
            and idx.device == dev == rows.device and idx.dtype == torch.int32
            and rows.dtype == arr.dtype and idx.is_contiguous() and rows.is_contiguous()
            and rows.shape[1:] == arr.shape[1:] and rows.shape[0] == idx.shape[0]):
        return idx, rows  # already in place: no dispatcher round trips
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


def delta_apply_rows_inplace_reference(arr, idx, rows):
    """Plain version of the donated twin (ops/solve.py:_apply_rows_donated):
    ``arr[idx] = rows`` written into ``arr`` itself (``index_copy_``), which
    it returns. A negative index counts from the end; one outside the rows
    is dropped."""
    n = arr.shape[0]
    # analysis: sanctioned[SHP602] index_copy_ takes an int64 index only
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    return arr.index_copy_(0, idx[keep], rows[keep])


def delta_apply_rows_reference(arr, idx, rows):
    """Plain version of ops/solve.py:_apply_rows_core: ``arr`` with
    ``arr[idx] = rows`` as a new tensor (the in-place version on a clone)."""
    return delta_apply_rows_inplace_reference(arr.clone(), idx, rows)


def delta_apply_rows(arr, idx, rows):
    """Row update of a device-resident buffer: ``arr[idx] = rows``. ``arr``
    has any dtype and trailing shape (the kernel moves rows as bytes);
    ``idx`` [n] int32 and ``rows`` [n, ...] may be numpy arrays. The plain
    version for a CPU ``arr``: a new tensor, ``arr`` left as it was. For a
    CUDA one kernel B8 (csrc/apply_rows.cu, one launch): out of place by
    default; under KTPU_DONATE_DELTA=1 in place, and then ``arr`` must not
    be used after the call: it is emptied, and the residency store replaces
    its reference with the return value (see the module note)."""
    if not len(idx):
        return arr
    if arr.device.type == "cpu":
        return delta_apply_rows_reference(arr, *_rows_on(arr, idx, rows))
    _build.live(arr, "delta_apply_rows")
    if os.environ.get("KTPU_DONATE_DELTA") == "1":
        return _launch_apply_rows_inplace(arr, *_rows_on(arr, idx, rows))
    return _launch_apply_rows(arr, *_rows_on(arr, idx, rows))


def _apply_rows_fn():
    """kt_apply_rows with its argument types, set once."""
    return _build.bind("apply_rows", "kt_apply_rows",
                       (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int) + (ctypes.c_void_p,) * 5)


def _apply_rows_inplace_fn():
    """kt_apply_rows_inplace with its argument types, set once."""
    return _build.bind("apply_rows", "kt_apply_rows_inplace",
                       (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int) + (ctypes.c_void_p,) * 4)


def _launch_apply_rows_inplace(arr, idx, rows):
    """The donated apply: the delta rows written into ``arr``'s memory (one
    launch, nothing else of the buffer touched); returns a new tensor over
    that memory and empties ``arr`` (``_build.donate``)."""
    if not arr.is_contiguous():
        raise ValueError("delta_apply_rows: the resident buffer is not contiguous")
    dev = arr.device
    with _build.device_scope(dev):
        rc = _apply_rows_inplace_fn()(
            arr.shape[0], math.prod(arr.shape[1:]) * arr.element_size(), idx.shape[0],
            arr.data_ptr(), idx.data_ptr(), rows.data_ptr(), _build.raw_stream(dev),
        )
    _build.launched("apply_rows_inplace", rc)
    return _build.donate(arr)


def _launch_apply_rows(arr, idx, rows):
    if not arr.is_contiguous():
        raise ValueError("delta_apply_rows: the resident buffer is not contiguous")
    dev = arr.device
    out = torch.empty_like(arr)
    with _build.device_scope(dev):
        rc = _apply_rows_fn()(
            arr.shape[0], math.prod(arr.shape[1:]) * arr.element_size(), idx.shape[0],
            arr.data_ptr(), idx.data_ptr(), rows.data_ptr(), out.data_ptr(),
            _build.raw_stream(dev),
        )
    _build.launched("apply_rows", rc)
    return out


def _decompose_rows_by_shard(idx, rows, block: int, n_shards: int):
    """Global row index -> (shard, local row): per-shard local indices,
    values, and live masks, padded to a shared pow2 bucket so nearby
    delta sizes share one compiled program. A non-empty shard pads with
    REPEATS of its own first (index, row) pair — idempotent duplicates,
    exactly like the plain path's bucket padding — because padding with
    masked writes of the CURRENT row-0 value would race a real update to
    local row 0 under duplicate-index scatter semantics (the old value
    could win and silently revert the delta). Only fully-empty shards
    carry live=False slots (their row-0 rewrite of the current value is
    conflict-free by construction)."""
    import numpy as _np

    per = [
        _np.flatnonzero((idx >= j * block) & (idx < (j + 1) * block))
        for j in range(n_shards)
    ]
    m = max((len(p) for p in per), default=0)
    bucket = 1
    while bucket < m:
        bucket *= 2
    lidx = _np.zeros((n_shards, bucket), _np.int32)
    live = _np.zeros((n_shards, bucket), bool)
    lrows = _np.zeros((n_shards, bucket) + rows.shape[1:], rows.dtype)
    for j, p in enumerate(per):
        k = len(p)
        if not k:
            continue
        lidx[j, :k] = idx[p] - j * block
        lrows[j, :k] = rows[p]
        lidx[j, k:] = lidx[j, 0]
        lrows[j, k:] = lrows[j, 0]
        live[j, :] = True
    return lidx, lrows, live


def delta_apply_rows_sharded(pieces, idx, rows):
    """``delta_apply_rows`` on a buffer sharded on its leading axis: the
    shards' blocks ``pieces`` (equal row counts, each on its shard's
    device), updated at the global rows ``idx`` (numpy int32) with
    ``rows`` (numpy). The global index decomposes on the host into (shard,
    local row) (``_decompose_rows_by_shard``); each shard with a row to
    change gets one B8 launch over its own (local row, value) pairs, the
    bucket's idempotent repeats included, and no other work; a shard with
    none keeps its buffer. Returns the new list of blocks."""
    import numpy as np

    idx = np.asarray(idx)
    if not len(idx):
        return list(pieces)
    rows = np.asarray(rows)
    block = pieces[0].shape[0]
    lidx, lrows, live = _decompose_rows_by_shard(idx, rows, block, len(pieces))
    return [
        delta_apply_rows(piece, lidx[j], lrows[j]) if live[j].any() else piece
        for j, piece in enumerate(pieces)
    ]


# -- the solver mesh (B10) ----------------------------------------------------
#
# parallel/mesh.py places the padded args (``MeshArgs``); these run one
# solve over them. Scenario block s's feasibility stage: with one shard,
# the single-device launches on its device; else each shard (s, d, m) its
# partials over its slices (B1's partial mode on every shard, B2's on the
# model-0 shard of each data slice; the dense route B3 on the types of the
# model shards of data slice 0, whose tables are final), written into one
# stacked buffer per input on the block's lead device (a shard on another
# device computes there and is copied in) and folded there by one
# mesh_fold launch. The scan and the wire pack then run once, on the
# block's lead device.

_EXIST_PARTIAL_ARGS = ("g_def", "g_neg", "g_mask", "g_req", "n_def", "n_mask", "n_avail",
                       "n_base")


def _shard_into(dev, lead, views, launch, wanted):
    """A shard's outputs in ``views``, slices of its block's stacked
    buffers on ``lead``: a shard on the lead device launches into them
    (``launch(views)``); another computes on its own device and each of
    its ``wanted`` outputs is copied in."""
    if dev == lead:
        launch(views)
        return
    for view, part, want in zip(views, launch(None), wanted):
        if want:
            view.copy_(part)


def _mesh_tables(margs, s: int, a, zone_kid, ct_kid, sparse_groups, tile_feasibility):
    """Scenario block ``s``'s tables on its lead device; ``a`` is the
    block's whole args there."""
    mesh = margs.mesh
    _, D, M = mesh.devices.shape
    if tile_feasibility or D * M == 1:
        return _feasibility_tables(a, zone_kid, ct_kid, sparse_groups, tile_feasibility)
    lead = mesh.devices[s, 0, 0]
    P, G = a["p_tol"].shape
    slab = (M, P, G, a["t_alloc"].shape[0] // M)
    i32 = torch.int32
    tonly = torch.empty(slab, dtype=torch.bool, device=lead)
    n_fit = torch.empty(slab, dtype=i32, device=lead)
    if not sparse_groups:
        # the dense route: B3 over each model shard's types; final tables
        # gathered by the fold (no partial sums: D = 0). Every shard's
        # compat_pg is the same (it reads no type): shard 0's is kept
        compat = torch.empty((P, G), dtype=torch.bool, device=lead)
        for m in range(M):
            _shard_into(
                mesh.devices[s, 0, m], lead, (compat, tonly[m], n_fit[m]),
                lambda out: fresh_claim_feasibility(
                    *(margs.at(n, s, 0, m) for n in _FRESH_ARGS),
                    zone_kid=zone_kid, ct_kid=ct_kid, out=out),
                (m == 0, True, True))
        compat_pg, type_ok, n_fit, _ = mesh_fold(None, None, tonly, n_fit, compat)
        if a["n_avail"].shape[0]:
            cap_ng = existing_node_feasibility(*(a[n] for n in _EXIST_ARGS), a["well_known"])
        else:
            cap_ng = _no_nodes(a)
        return compat_pg, type_ok, n_fit, cap_ng
    fail_t = torch.empty((D,) + slab, dtype=i32, device=lead)
    fail_c = torch.empty((D, P, G), dtype=i32, device=lead)
    for d in range(D):
        base = d == 0
        for m in range(M):
            # fail_c reads no type: the M shards of a data slice write the
            # same counts into its one slot, and shard (d, 0)'s is kept
            _shard_into(
                mesh.devices[s, d, m], lead,
                (fail_t[d, m], fail_c[d], tonly[m] if base else None, n_fit[m] if base else None),
                lambda out: fresh_claim_feasibility_partial(
                    *(margs.at(n, s, d, m) for n in _FRESH_ARGS + _SPARSE_INDEX + ("goff_idx",)),
                    zone_kid=zone_kid, ct_kid=ct_kid, with_base=base, out=out),
                (True, m == 0, base, base))
    nfail = cap = None
    N = a["n_avail"].shape[0]
    if N:
        nfail = torch.empty((D, N, G), dtype=i32, device=lead)
        cap = torch.empty((N, G), dtype=i32, device=lead)
        for d in range(D):
            _shard_into(
                mesh.devices[s, d, 0], lead, (nfail[d], cap if d == 0 else None),
                lambda out: existing_node_feasibility_partial(
                    *(margs.at(n, s, d, 0) for n in _EXIST_PARTIAL_ARGS + _SPARSE_INDEX),
                    with_base=d == 0, out=out),
                (True, d == 0))
    compat_pg, type_ok, n_fit, cap_ng = mesh_fold(
        fail_t, fail_c, tonly, n_fit, a["p_tol"], nfail, cap, a["n_tol"])
    return compat_pg, type_ok, n_fit, cap_ng if cap is not None else _no_nodes(a)


def _no_nodes(a):
    """The empty existing-node table, with n_tol's scenario axis."""
    return torch.zeros(
        tuple(a["n_tol"].shape[:-2]) + (0, a["g_mask"].shape[0]),
        dtype=torch.int32, device=a["g_mask"].device,
    )


def _block_solve(margs, s, nmax, zone_kid, ct_kid, has_domains=True, has_contrib=False,
                 tile_feasibility=False, wf_iters=32, sparse_groups=False):
    a = {n: margs.whole(n, s) for n in SOLVE_ARG_NAMES}
    tables = _mesh_tables(margs, s, a, zone_kid, ct_kid, sparse_groups, tile_feasibility)
    return pack(
        *pack_args(a, *tables),
        nmax=nmax, zone_kid=zone_kid, ct_kid=ct_kid, has_domains=has_domains,
        has_contrib=has_contrib, tile_feasibility=tile_feasibility, wf_iters=wf_iters,
    )


def solve_core_mesh(
    margs,
    mesh,
    nmax: int,
    zone_kid: int,
    ct_kid: int,
    has_domains: bool = True,
    has_contrib: bool = False,
    tile_feasibility: bool = False,
    wf_iters: int = 32,
    sparse_groups: bool = False,
):
    """``solve_core`` over ``mesh`` (parallel/mesh.py:sharded_solve_fn):
    the args placed on it (``margs``), the 10 outputs on its lead device,
    equal to the single-device solve's on the padded args."""
    if margs.mesh != mesh:
        raise ValueError(f"arguments placed on {margs.mesh}, solve over {mesh}")
    return _block_solve(margs, 0, nmax, zone_kid, ct_kid, has_domains, has_contrib,
                        tile_feasibility, wf_iters, sparse_groups)


def solve_core_mesh_packed(margs, mesh, fills_dtype=torch.int32, **statics):
    return wire_pack(solve_core_mesh(margs, mesh, **statics), fills_dtype)


def solve_scenarios_core_mesh_packed(
    margs, mesh, fills_dtype=torch.int32, batch_topo: bool = False, **statics
):
    """``solve_scenarios_core_packed`` over ``mesh``: scenario block s of
    the 'scenario' axis solved by its own devices (its stacked args are
    the block's scenarios), the blocks' outputs gathered on the lead
    device in scenario order."""
    if margs.mesh != mesh:
        raise ValueError(f"arguments placed on {margs.mesh}, solve over {mesh}")
    batched = SCENARIO_TOPO_BATCHED_ARGS if batch_topo else SCENARIO_BATCHED_ARGS
    if set(batched) != set(margs.stacked):
        raise ValueError(f"stacked args {sorted(margs.stacked)}, expected {sorted(batched)}")
    outs = [
        wire_pack(_block_solve(margs, s, **statics), fills_dtype)
        for s in range(mesh.devices.shape[0])
    ]
    if len(outs) == 1:
        return outs[0]
    lead = mesh.lead
    return tuple(torch.cat([o[i].to(lead) for o in outs]) for i in range(len(outs[0])))


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


def dispatch_mesh_packed(fn, args, mesh):
    """The sharded solve (parallel/mesh.py:sharded_solve_packed_fn over
    ``mesh``; ``args`` the padded args or a one-element sequence of their
    MeshArgs) behind the same fault and trace seams as its single-device
    twin."""
    faults.hit(faults.SOLVER_DISPATCH, kernel="mesh")
    with obs.span("kernel.dispatch", kernel="mesh"):
        out = fn(*args)
    return faults.mutate(faults.SOLVER_OUTPUT, out, kernel="mesh")


def dispatch_scenarios_mesh_packed(fn, args, mesh):
    """The scenario-sharded dispatch (sharded_scenarios_fn over ``mesh``):
    the probe set of a consolidation search over the mesh's leading
    'scenario' axis in one submit."""
    faults.hit(faults.SOLVER_SCENARIOS, kernel="scenarios-mesh")
    with obs.span("kernel.dispatch", kernel="scenarios-mesh"):
        out = fn(*args)
    return faults.mutate(faults.SOLVER_OUTPUT, out, kernel="scenarios-mesh")
