#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (karpenter_tpu_torch) on one card.

    python3 chip_smoke.py        # from the repo root, on a machine with CUDA

Phases, one line of output each; any failure exits non-zero and prints
no result:

1. device and build: the card's name and power limit, then every kernel
   of csrc/ compiled from the checkout with nvcc (one process per source,
   all at once);
2. kernels vs plain versions: each kernel of the main path (B1 fresh
   feasibility, B2 existing-node caps, B4 packing scan, B6 wire pack) runs
   on the card at the main path's shapes — the mixed 50,000-pod x
   400-type snapshot, and for B2 a 2,000-pod snapshot over 32 existing
   nodes — beside its ``*_reference`` on the same CUDA tensors. Tolerance:
   exact equality of every output. Median times over repeats (CUDA
   events);
   Phase 2 also holds B7, the consolidation dispatch (B1 shared, B2 over
   n_tol [S, N, G], B4 one block per scenario, B6 over S rows), at the
   consolidation path's shapes: 16 single-node scenarios over the
   2,000-node cluster's shared encoding (N=2048, T=50); and B4 over a
   domain batch (the scan's domain machinery: BASELINE config[2], 50,000
   constrained pods x 800 types) and B8, the row-delta apply, at the
   largest row delta of a real churn tick of that batch (also against
   ``Tensor.index_copy``);
3. end to end: TorchSolver(device="cuda").solve on the 50k x 400 batch,
   then on the 2,000-pod batch over 32 nodes, each path with the launch
   counters zeroed just before it and read just after it (B1, B4, B6 must
   have run on the first, B1, B2, B4, B6 on the second);
   every pod placed, 0 errors, and the same decisions (by pod name) as the
   same solves with device="cpu"; solve p50 over 5 warm solves and the
   per-phase split of one traced solve;
4. consolidation: MultiNodeConsolidation, then SingleNodeConsolidation,
   compute_command over build_*_consolidation_env(2000) on the card, the
   launch counters zeroed before each path and read after it: every
   dispatch a scenario batch (the S > 1 ``pack`` launches equal the
   method's dispatches, no single-scenario ``pack`` launch), no sequential
   fallback, and the same command, probes and dispatches as the
   device="cpu" run; p50 over 5 warm passes on fresh envs and the phase
   split of one traced pass;
5. the constrained loop (BASELINE config[2], 50k x 800): a cold solve on
   the card, counted (a domain ``pack`` launch), with the decisions and
   placed/error counts of device="cpu"; cold p50 over 5 solves, each from
   a fresh EncodeCache, and the split of one traced cold solve; then two
   warm-ups and 4 churn ticks (bench.py's constrained-churn protocol,
   workloads.churn_tick) on one EncodeCache, each tick counted on its own
   (a fifth, traced tick gives the span split):
   it rides row deltas through B8 with no full re-encode and decides as a
   card solve of the same pods fully re-encoded and restaged over the same
   vocab (the warm encoding's contract, the JAX package's too); a repeat
   solve hits REUSE with zero full puts; no sequential fallback anywhere.
   Tick p50, and the traced tick's span split beside the traced cold
   solve's.
6. the reference's diverse 5-class mix (bench.py:_build("diverse-ref"):
   diverse_reference_mix(5,000) x 400 types), whose ~1,900 groups share
   ~30 feasibility classes, so the driver routes it to the class-batched
   scan: the same loop as phase 5 (cold solve == cpu, 1,000 claims and 0
   errors, cold p50 over 5 fresh EncodeCaches and a traced split; bench's
   diverse-churn protocol, 50 pods swapped per tick, each tick == a full
   re-encode over the same vocab, row deltas through B8, REUSE on the
   repeat, 0 fallbacks), every solve counted: one B5 (pack_classed) launch
   per dispatch and no B4 (pack) launch; then the same batch once with
   SolverConfig(classed=False), counted: B4 with contributor counting,
   deciding as the classed solve.

Phase 2 also holds B5 against pack_classed_reference (every output and
the final state) and B4 with contributor counting (the same batch with
the classed route off) against pack_reference, on the diverse batch.

Then one JSON line of per-kernel numbers (B1, B2, B4, B4 over domains, B4
with contributor counting, B5, B6, B7, B8), the nvidia-smi line, and the
last line ``{"ok": true, "device": {...}}``.
"""

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
N_PODS, N_TYPES = 50_000, 400
N_TYPES_C = 800  # BASELINE config[2]: 50k constrained pods x 800 types
N_TICKS = 4
NODE_PODS, N_NODES = 2_000, 32
# bench.py:_build("diverse-ref"): diverse_reference_mix(5,000) x 400 types,
# which the JAX package solves into 1,000 claims with no pod error
N_DIVERSE, DIVERSE_CLAIMS = 5_000, 1_000
CONS_NODES, CONS_SCENARIOS = 2_000, 16  # BASELINE config[3]; one sweep chunk
REPLACES = {
    "fresh_feasibility": "karpenter_tpu/ops/feasibility.py:141",
    "existing_feasibility": "karpenter_tpu/ops/feasibility.py:264",
    "pack": "karpenter_tpu/ops/packing.py:277",
    "wire_pack": "karpenter_tpu/ops/solve.py:267",
    "solve_scenarios": "karpenter_tpu/ops/solve.py:357",
    "pack_domains": "karpenter_tpu/ops/packing.py:277",
    "pack_contrib": "karpenter_tpu/ops/packing.py:1153",
    "pack_classed": "karpenter_tpu/ops/packing.py:1230",
    "apply_rows": "karpenter_tpu/ops/solve.py:400",
}
# the source of each kernel row (B4 with domains and with contributor
# counting are pack.cu's domain and contributor paths)
SOURCES = {"pack_domains": "pack", "pack_contrib": "pack", "solve_scenarios": "pack"}
# the one PyTorch call that computes a kernel's function, timed beside it
LIBRARY = {"apply_rows": "Tensor.index_copy"}
# B7 is the scenario-batched dispatch of these kernels; pack.cu holds its
# scenario grid
B7_SOURCES = ("pack", "existing_feasibility", "wire_pack", "fresh_feasibility")
# the kernels each end-to-end path must launch: B2 only runs with nodes
PATH_KERNELS = {
    "50k": ("fresh_feasibility", "pack", "wire_pack"),
    "nodes": ("fresh_feasibility", "existing_feasibility", "pack", "wire_pack"),
    "constrained": ("fresh_feasibility", "pack", "pack_domains", "wire_pack"),
    "ticks": ("fresh_feasibility", "pack", "pack_domains", "wire_pack", "apply_rows"),
    "diverse": ("fresh_feasibility", "pack_classed", "wire_pack"),
    "diverse_ticks": ("fresh_feasibility", "pack_classed", "wire_pack", "apply_rows"),
    # the same batch with the classed route off: B4 with contributor counting
    "diverse_per_group": ("fresh_feasibility", "pack", "pack_domains", "pack_contrib",
                          "wire_pack"),
}
# ... and those it must not launch: the classed route replaces B4
PATH_ABSENT = {"diverse": ("pack",), "diverse_ticks": ("pack",),
               "diverse_per_group": ("pack_classed",)}
# ... and those each consolidation path must launch over a scenario batch
CONS_KERNELS = ("existing_feasibility", "pack", "wire_pack")
# the solve args each feasibility kernel reads, in its wrapper's order
B1_NAMES = ("g_def", "g_neg", "g_mask", "g_req", "p_def", "p_neg", "p_mask",
            "p_daemon", "p_tol", "p_titype_ok", "t_def", "t_mask", "t_alloc",
            "o_avail", "o_zone", "o_ct", "well_known", "gk_g", "gk_k", "gk_w",
            "goff_idx")
B2_NAMES = ("g_def", "g_neg", "g_mask", "g_req", "n_def", "n_mask", "n_avail",
            "n_base", "n_tol", "gk_g", "gk_k", "gk_w")


class SmokeFailure(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def ptxas_summary(text):
    """Registers and spill bytes per kernel from nvcc's -Xptxas -v output."""
    regs = re.findall(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill stores", text)
    return f"registers {'/'.join(regs)}, spill stores {'/'.join(spills)} B"


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(read_write_bytes, ops):
    t_bytes = read_write_bytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(kernel_out, ref_out):
    """Max |kernel - reference| over every output (a shape or dtype
    mismatch raises)."""
    err = 0.0
    for i, (k, r) in enumerate(zip(kernel_out, ref_out)):
        if k.shape != r.shape or k.dtype != r.dtype:
            raise SmokeFailure(f"output {i}: {k.dtype}{tuple(k.shape)} vs "
                               f"{r.dtype}{tuple(r.shape)}")
        d = (k.to("cpu").double() - r.to("cpu").double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def build_batch(torch_solver_cls, config_cls, pods, n_types, state_nodes=(),
                device="cuda", cache=None):
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver.example import example_nodepool

    pools = [example_nodepool()]
    its = corpus.generate(n_types)
    its_by_pool = {p.name: list(its) for p in pools}
    topo = Topology(Client(TestClock()), list(state_nodes), pools, its_by_pool, pods)
    return torch_solver_cls(
        pools, its_by_pool, topo, state_nodes=list(state_nodes),
        config=config_cls(device=device), encode_cache=cache,
    )


def host_snapshot(solver, pods):
    """The main path's padded solve_args (numpy), snapshot, statics and the
    encode delta for ``solver``'s batch, built exactly as
    TorchSolver._solve_fast builds them."""
    from karpenter_tpu_torch.solver import encode as enc

    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    if rest:
        raise SmokeFailure(f"{len(rest)} pods left the dense path")
    snap, (a_tzc, res_cap0, a_res), _, _, delta = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    N = enc._next_pow2(len(snap.existing_names), floor=1) if snap.existing_names else 0
    statics = solver._kernel_statics(snap, G)
    return snap.padded(G, N).solve_args(a_tzc, res_cap0, a_res), snap, statics, delta


def device_snapshot(solver, pods):
    """The main path's kernel inputs for ``solver``'s batch: the padded
    solve_args on the card, the statics, NMAX and the fills dtype."""
    import torch

    from karpenter_tpu_torch.solver.args import to_device_args

    host, snap, statics, _ = host_snapshot(solver, pods)
    fit = solver._fit_matrix(snap)
    nmax = solver._select_nmax(snap, fit, None)
    fills = torch.int16 if solver._fill_bound(snap, fit) < 2**15 else torch.int32
    return to_device_args(host, "cuda"), statics, nmax, fills


def phase_kernels(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 2: every kernel against its plain version on the card."""
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import example_state_nodes
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    rows = {}
    pods = mixed_pods(N_PODS)
    solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES)
    args, statics, nmax, fills = device_snapshot(solver, pods)
    a = dict(zip(SOLVE_ARG_NAMES, args))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    P, G, T = a["p_titype_ok"].shape[0], a["g_count"].shape[0], a["t_alloc"].shape[0]
    K, V1 = a["g_mask"].shape[1:]
    R, O, L = a["t_alloc"].shape[1], a["o_avail"].shape[1], a["gk_g"].shape[0]

    # ---- B1 fresh feasibility ----
    b1_in = [a[n] for n in B1_NAMES]
    b1 = feas.fresh_claim_feasibility_sparse(*b1_in, zone_kid=zk, ct_kid=ck)
    b1_ref = feas.fresh_claim_feasibility_sparse_reference(*b1_in, zone_kid=zk, ct_kid=ck)
    torch.cuda.synchronize()
    ops = P * T * K * V1 + P * L * T * V1 + P * G * T * (2 * R + O)
    rows["fresh_feasibility"] = dict(
        max_abs_err=max_abs_err(b1, b1_ref),
        ms=cuda_ms(lambda: feas.fresh_claim_feasibility_sparse(*b1_in, zone_kid=zk, ct_kid=ck), 50),
        plain_ms=cuda_ms(lambda: feas.fresh_claim_feasibility_sparse_reference(*b1_in, zone_kid=zk, ct_kid=ck), 10),
        bound=bound_ms(nbytes(b1_in) + nbytes(b1), ops),
        shape=f"P={P} G={G} T={T} K={K} V1={V1} R={R} O={O} L={L}",
    )

    # ---- B4 packing scan and B6 wire pack on the 50k tables ----
    cap_ng = torch.zeros((0, G), dtype=torch.int32, device="cuda")
    pack_in = solve_mod.pack_args(a, *b1, cap_ng)
    st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"])
    while True:
        b4 = packing_mod.pack(*pack_in, **st)
        if not bool(b4[3].item()):
            break
        st["nmax"] *= 2
    b4_ref = packing_mod.pack_reference(*pack_in, **st)
    torch.cuda.synchronize()
    n_open = int(b4[2].item())
    ops = pack_ops(a["g_count"], b4[5], b4[2], T, R, V1)
    rows["pack"] = dict(
        max_abs_err=max_abs_err(b4, b4_ref),
        ms=cuda_ms(lambda: packing_mod.pack(*pack_in, **st), 20),
        plain_ms=cuda_ms(lambda: packing_mod.pack_reference(*pack_in, **st), 3),
        bound=bound_ms(nbytes(pack_in) + nbytes(b4), ops),
        shape=f"G={G} T={T} NMAX={st['nmax']} claims={n_open} wf_iters={st['wf_iters']}",
    )
    b6 = solve_mod.wire_pack(b4, fills)
    b6_ref = solve_mod.wire_pack_reference(b4, fills)
    torch.cuda.synchronize()
    b6_in = [b4[i] for i in (0, 1, 4, 5, 7, 8)]
    b6_out = [b6[i] for i in (0, 1, 4, 5, 7, 8)]
    rows["wire_pack"] = dict(
        max_abs_err=max_abs_err(b6, b6_ref),
        ms=cuda_ms(lambda: solve_mod.wire_pack(b4, fills), 50),
        plain_ms=cuda_ms(lambda: solve_mod.wire_pack_reference(b4, fills), 20),
        bound=bound_ms(nbytes(b6_in) + nbytes(b6_out), b4[1].numel() + sum(x.numel() for x in b6_out)),
        shape=f"NMAX={st['nmax']} T={T} fills={fills}",
    )

    # ---- B2 existing-node caps on the state-node snapshot ----
    pods2 = mixed_pods(NODE_PODS)
    solver2 = build_batch(torch_solver_cls, config_cls, pods2, N_TYPES,
                          state_nodes=example_state_nodes(N_NODES))
    args2, _, _, _ = device_snapshot(solver2, pods2)
    a2 = dict(zip(SOLVE_ARG_NAMES, args2))
    b2_in = [a2[n] for n in B2_NAMES]
    b2 = feas.existing_node_feasibility_sparse(*b2_in)
    b2_ref = feas.existing_node_feasibility_sparse_reference(*b2_in)
    torch.cuda.synchronize()
    if not int(b2.max()):
        raise SmokeFailure("B2: no node has room for any group")
    N2, G2, L2 = a2["n_avail"].shape[0], a2["g_count"].shape[0], a2["gk_g"].shape[0]
    rows["existing_feasibility"] = dict(
        max_abs_err=max_abs_err([b2], [b2_ref]),
        ms=cuda_ms(lambda: feas.existing_node_feasibility_sparse(*b2_in), 50),
        plain_ms=cuda_ms(lambda: feas.existing_node_feasibility_sparse_reference(*b2_in), 20),
        bound=bound_ms(nbytes(b2_in) + nbytes([b2]), N2 * L2 * V1 + N2 * G2 * 2 * R),
        shape=f"N={N2} G={G2} L={L2} R={R}",
    )
    rows["solve_scenarios"] = scenario_row()
    rows.update(constrained_rows(torch_solver_cls, config_cls, encode_cache_cls))
    rows.update(diverse_rows(torch_solver_cls, config_cls))
    for name, row in rows.items():
        if row["max_abs_err"] != 0.0:
            raise SmokeFailure(f"{name}: kernel disagrees with its plain version "
                               f"(max |diff| {row['max_abs_err']})")
    return rows


def pack_ops(g_count, claim_fills, n_open, T, R, V1, dyn=None, P=1, classes=None):
    """Operations the scan's inputs need: per group step, each claim
    opened at an earlier step is checked against every type (2R fits
    compares, V1 x V1 offering cells), plus a few per claim slot. A
    dynamic group's step (``dyn`` [G] bool: g_dmode > 0) adds the per-domain
    offering cells of each claim and template type (V1 x V1 each) and a
    per-domain claim pass. Over a leading scenario axis, the sum over
    scenarios. With ``classes`` (class_start, class_len, class_dyn: the
    class-batched scan) the per-type work runs once per class head, over
    the claims opened before the class, and each member step costs only
    its per-claim summaries."""
    import torch

    g_count, claim_fills, n_open = g_count.cpu(), claim_fills.cpu(), n_open.cpu()
    if g_count.dim() == 1:
        g_count, claim_fills, n_open = g_count[None], claim_fills[None], n_open[None]
    G, nmax = claim_fills.shape[1:]
    dyn = [False] * G if dyn is None else [bool(x) for x in dyn.cpu()]
    ops = 0
    for counts, fills, opened in zip(g_count, claim_fills, n_open):
        first = [int(torch.nonzero(fills[:, s])[0, 0]) for s in range(int(opened))]
        if classes is not None:
            for cs, cl, cdyn in zip(*(x.cpu().tolist() for x in classes)):
                if cl <= 0:
                    continue
                live = sum(1 for f in first if f < cs)
                ops += live * T * (2 * R + V1 * V1)
                if cdyn:
                    ops += (live + P) * T * V1 * V1
                for g in range(cs, cs + cl):
                    if int(counts[g]) > 0:
                        ops += nmax * 8 + (nmax * V1 * 8 if dyn[g] else 0)
            continue
        for g in range(G):
            if int(counts[g]) <= 0:
                continue
            live = sum(1 for f in first if f < g)
            ops += live * T * (2 * R + V1 * V1) + nmax * 8
            if dyn[g]:
                ops += (live + P) * T * V1 * V1 + nmax * V1 * 8
    return ops


def scenario_snapshot(device="cuda"):
    """The consolidation path's B7 inputs: one single-node chunk of
    CONS_SCENARIOS scenarios (each removes one candidate) over
    build_consolidation_env(CONS_NODES)'s shared encoding, staged by
    TorchSolver.submit_scenarios exactly as the search stages them."""
    from karpenter_tpu_torch.controllers.disruption.helpers import ScenarioSimulator
    from karpenter_tpu_torch.solver.workloads import build_consolidation_env

    ctx, _, candidates, _ = build_consolidation_env(CONS_NODES, device)
    sim = ScenarioSimulator(
        ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
        encode_cache=ctx.encode_cache, solver_config=ctx.solver_config,
    )
    chunk = [[c] for c in candidates[:CONS_SCENARIOS]]
    token = sim._solver.submit_scenarios(sim._scenarios_of(chunk))
    if token is None:
        raise SmokeFailure("the consolidation chunk declined the scenario batch")
    return token


def plain_scenarios(args, nmax, fills, zone_kid, ct_kid, wf_iters, has_domains, **_):
    """B7's plain version on the same tensors: each kernel's *_reference
    in the dispatch's order (B1 once, B2 over n_tol [S, N, G], the scan
    per scenario, the wire pack over S rows)."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

    a = dict(zip(SOLVE_ARG_NAMES, args))
    compat_pg, type_ok, n_fit = feas.fresh_claim_feasibility_sparse_reference(
        *(a[n] for n in B1_NAMES), zone_kid=zone_kid, ct_kid=ct_kid)
    cap_ng = feas.existing_node_feasibility_sparse_reference(*(a[n] for n in B2_NAMES))
    outs = packing_mod.pack_scenarios_reference(
        *solve_mod.pack_args(a, compat_pg, type_ok, n_fit, cap_ng),
        nmax=nmax, zone_kid=zone_kid, ct_kid=ct_kid, has_domains=has_domains,
        wf_iters=wf_iters)
    return solve_mod.wire_pack_reference(outs, fills)


def scenario_row():
    """Phase 2's B7 row: B2[S], B4[S] and B6[S rows] each against its
    plain version, and the whole scenario dispatch against plain_scenarios,
    at the consolidation shapes. Tolerance: exact equality."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

    token = scenario_snapshot()
    args, statics = token["args"], dict(token["statics"])
    fills = token["fills_dtype"]
    a = dict(zip(SOLVE_ARG_NAMES, args))
    S, G = a["g_count"].shape
    N, R = a["n_avail"].shape
    T, K, V1 = a["t_mask"].shape
    P, L, O = a["p_def"].shape[0], a["gk_g"].shape[0], a["o_avail"].shape[1]
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    st = dict(nmax=token["nmax"], zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"])

    def dispatch():
        return solve_mod.solve_scenarios_core_packed(
            *args, fills_dtype=fills, batch_topo=False, **dict(statics, nmax=st["nmax"]))

    while bool(dispatch()[3].any().item()):  # the search's overflow doubling
        st["nmax"] *= 2
    nmax = st["nmax"]
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    b2_in = [a[n] for n in B2_NAMES]
    b2 = feas.existing_node_feasibility_sparse(*b2_in)
    b2_ref = feas.existing_node_feasibility_sparse_reference(*b2_in)
    b4_in = solve_mod.pack_args(a, *b1, b2)
    b4 = packing_mod.pack(*b4_in, **st)
    b4_ref = packing_mod.pack_scenarios_reference(*b4_in, **st)
    b6 = solve_mod.wire_pack(b4, fills)
    b6_ref = solve_mod.wire_pack_reference(b4, fills)
    full = dispatch()
    full_ref = plain_scenarios(args, fills=fills, **st)
    torch.cuda.synchronize()
    if int(b4[4][:len(token["scenarios"])].sum()) < 1:
        raise SmokeFailure("B7: the consolidation chunk placed no pod on a node")
    parts = {
        "B2[S]": max_abs_err([b2], [b2_ref]),
        "B4[S]": max_abs_err(b4, b4_ref),
        "B6[S]": max_abs_err(b6, b6_ref),
        "dispatch": max_abs_err(full, full_ref),
    }
    part_ms = {
        "B2[S]": cuda_ms(lambda: feas.existing_node_feasibility_sparse(*b2_in), 50),
        "B4[S]": cuda_ms(lambda: packing_mod.pack(*b4_in, **st), 20),
        "B6[S]": cuda_ms(lambda: solve_mod.wire_pack(b4, fills), 50),
    }
    # bytes: the dispatch's inputs read once, its wire outputs written once
    used = set(B1_NAMES) | set(B2_NAMES) | {
        "g_count", "g_hcap", "g_haff", "g_hstg", "g_hscap", "g_hself", "t_cap",
        "a_tzc", "p_limit", "p_has_limit", "n_hcnt", "nh_cnt0"}
    ops = (P * T * K * V1 + P * L * T * V1 + P * G * T * (2 * R + O)  # B1
           + N * L * V1 + S * N * G * 2 * R  # B2: compat once, room per scenario
           + pack_ops(a["g_count"], b4[5], b4[2], T, R, V1)  # B4
           + full[1].numel() * 8 + sum(x.numel() for x in full))  # B6
    return dict(
        max_abs_err=max(parts.values()),
        parts=parts,
        part_ms=part_ms,
        ms=cuda_ms(dispatch, 20),
        plain_ms=cuda_ms(lambda: plain_scenarios(args, fills=fills, **st), 3),
        bound=bound_ms(nbytes([a[n] for n in used]) + nbytes(full), ops),
        shape=f"S={S} N={N} G={G} T={T} NMAX={nmax} claims={b4[2].tolist()}",
    )


def constrained_rows(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 2's rows for the constrained loop's kernels: B4 over the
    domain batch (constrained_mix(50k) x 800 types, has_domains) against
    pack_reference, and B8 at the largest row delta of the loop's first
    churn tick (the same pods and tick seed as phase 5) against its plain
    version and against Tensor.index_copy. Tolerance: exact equality."""
    import random

    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.args import put, to_device_args
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.residency import DeviceResidentArgs
    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick, constrained_mix

    rows = {}
    cache = encode_cache_cls()
    pods = constrained_mix(N_PODS)
    solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES_C, device="cuda",
                         cache=cache)
    host_a, snap, statics, _ = host_snapshot(solver, pods)
    if not statics["has_domains"]:
        raise SmokeFailure("the constrained batch carries no domain group")
    fit = solver._fit_matrix(snap)
    a = dict(zip(SOLVE_ARG_NAMES, to_device_args(host_a, "cuda")))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    P, G, T = a["p_titype_ok"].shape[0], a["g_count"].shape[0], a["t_alloc"].shape[0]
    K, V1 = a["g_mask"].shape[1:]
    R = a["t_alloc"].shape[1]
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    cap_ng = torch.zeros((0, G), dtype=torch.int32, device="cuda")
    pack_in = solve_mod.pack_args(a, *b1, cap_ng)
    st = dict(nmax=solver._select_nmax(snap, fit, None), zone_kid=zk, ct_kid=ck,
              wf_iters=statics["wf_iters"], has_domains=True)
    while True:
        b4 = packing_mod.pack(*pack_in, **st)
        if not bool(b4[3].item()):
            break
        st["nmax"] *= 2
    b4_ref = packing_mod.pack_reference(*pack_in, **st)
    torch.cuda.synchronize()
    dyn = a["g_dmode"] > 0
    ops = pack_ops(a["g_count"], b4[5], b4[2], T, R, V1, dyn=dyn, P=P)
    rows["pack_domains"] = dict(
        max_abs_err=max_abs_err(b4, b4_ref),
        ms=cuda_ms(lambda: packing_mod.pack(*pack_in, **st), 5),
        plain_ms=cuda_ms(lambda: packing_mod.pack_reference(*pack_in, **st), 1),
        bound=bound_ms(nbytes(pack_in) + nbytes(b4), ops),
        shape=(f"G={G} ({int((a['g_count'] > 0).sum())} real, {int(dyn.sum())} dynamic) "
               f"T={T} P={P} K={K} V1={V1} NMAX={st['nmax']} claims={int(b4[2])} "
               f"wf_iters={st['wf_iters']}"),
    )

    # the first churn tick's encode against the same cache: its delta names
    # the changed rows of each argument class, as the residency store sees them
    tick_pods = churn_tick(pods, constrained_mix, random.Random(CHURN_SEED))
    solver_b = build_batch(torch_solver_cls, config_cls, tick_pods, N_TYPES_C, device="cuda",
                           cache=cache)
    host_b, _, _, delta = host_snapshot(solver_b, tick_pods)
    best = None
    for name, ha, hb in zip(SOLVE_ARG_NAMES, host_a, host_b):
        _, idx = DeviceResidentArgs._class_of(name, delta)
        if idx is None or not len(idx) or ha.shape != hb.shape:
            continue
        size = len(idx) * (hb.nbytes // max(hb.shape[0], 1))
        if best is None or size > best[0]:
            best = (size, name, ha, hb, idx)
    if best is None:
        raise SmokeFailure("the churn tick carried no row delta")
    _, name, ha, hb, idx_np = best
    arr = put(name, ha, "cuda")
    idx = torch.from_numpy(idx_np.astype(np.int32)).to("cuda")
    vals = torch.from_numpy(np.ascontiguousarray(hb[idx_np])).to("cuda")
    idx64 = idx.long()
    b8 = solve_mod.delta_apply_rows(arr, idx, vals)
    b8_ref = solve_mod.delta_apply_rows_reference(arr, idx, vals)
    torch.cuda.synchronize()
    if not torch.equal(b8.cpu(), torch.from_numpy(np.ascontiguousarray(hb))):
        raise SmokeFailure(f"B8: {name} after the row delta differs from the tick's encode")
    rows["apply_rows"] = dict(
        max_abs_err=max_abs_err([b8], [b8_ref]),
        ms=cuda_ms(lambda: solve_mod.delta_apply_rows(arr, idx, vals), 50),
        plain_ms=cuda_ms(lambda: solve_mod.delta_apply_rows_reference(arr, idx, vals), 20),
        library_ms=cuda_ms(lambda: arr.index_copy(0, idx64, vals), 50),
        bound=bound_ms(2 * nbytes([arr]) + nbytes([idx, vals]), vals.numel()),
        shape=f"{name} {tuple(arr.shape)} {arr.dtype}, {len(idx_np)} rows",
    )
    return rows


def diverse_rows(torch_solver_cls, config_cls):
    """Phase 2's rows for the diverse mix's kernels (diverse_reference_mix(
    5,000) x 400 types, the batch phase 6 solves): B5, the class-batched
    scan, over the driver's class partition against
    pack_classed_reference (every output and every field of the final
    state), and B4 with contributor counting on the same inputs (the
    classed route off) against pack_reference. Tolerance: exact
    equality."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.solver.args import put, to_device_args
    from karpenter_tpu_torch.solver.driver import _CLASS_ARG_NAMES
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix

    pods = diverse_reference_mix(N_DIVERSE)
    solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES)
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    if rest:
        raise SmokeFailure(f"diverse: {len(rest)} pods left the dense path")
    snap, avail, _, _, _ = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    run = snap.padded(G, 0)
    statics = solver._kernel_statics(snap, G)
    if not (statics["has_domains"] and statics["has_contrib"]):
        raise SmokeFailure(f"diverse: statics {statics}")
    partition = solver._classed_partition(run, avail[1])
    if partition is None:
        raise SmokeFailure("diverse: the driver does not route the batch to the classed scan")
    cls_host, lmax = partition
    cls = [put(n, x, "cuda") for n, x in zip(_CLASS_ARG_NAMES, cls_host)]
    a = dict(zip(enc.SOLVE_ARG_NAMES, to_device_args(run.solve_args(*avail), "cuda")))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    P, T = a["p_titype_ok"].shape
    K, V1 = a["g_mask"].shape[1:]
    R = a["t_alloc"].shape[1]
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    cap_ng = torch.zeros((0, G), dtype=torch.int32, device="cuda")
    pack_in = solve_mod.pack_args(a, *b1, cap_ng)
    st = dict(nmax=solver._select_nmax(snap, solver._fit_matrix(snap), None), zone_kid=zk,
              ct_kid=ck, wf_iters=statics["wf_iters"], has_domains=True, has_contrib=True)

    def b5():
        return packing_mod.pack_classed(*pack_in, *cls, lmax=lmax, **st)

    def b5_ref():
        return packing_mod.pack_classed_reference(*pack_in, *cls, lmax=lmax, **st)

    while True:  # the driver's overflow doubling
        out5 = b5()
        if not bool(out5[0].overflow.item()):
            break
        st["nmax"] *= 2
    ref5 = b5_ref()
    out4 = packing_mod.pack(*pack_in, **st)
    ref4 = packing_mod.pack_reference(*pack_in, **st)
    torch.cuda.synchronize()
    state, fills = list(out5[0]), list(out5[1:])
    ref_state, ref_fills = list(ref5[0]), list(ref5[1:])
    n_open = out5[0].n_open
    dyn = a["g_dmode"] > 0
    shape = (f"G={G} ({len(snap.groups)} real, {int(dyn.sum())} dynamic) "
             f"classes={int((cls_host[1] > 0).sum())} lmax={lmax} T={T} P={P} K={K} V1={V1} "
             f"JH={a['nh_cnt0'].shape[1]} JD={a['dd0'].shape[0]} NMAX={st['nmax']} "
             f"claims={int(n_open)} wf_iters={st['wf_iters']}")
    classes = (cls[0], cls[1], cls[2])
    return {
        "pack_classed": dict(
            max_abs_err=max_abs_err(state + fills, ref_state + ref_fills),
            ms=cuda_ms(b5, 5), plain_ms=cuda_ms(b5_ref, 1),
            bound=bound_ms(nbytes(pack_in) + nbytes(cls) + nbytes(state + fills),
                           pack_ops(a["g_count"], fills[1], n_open, T, R, V1, dyn=dyn,
                                    P=P, classes=classes)),
            shape=shape,
        ),
        "pack_contrib": dict(
            max_abs_err=max_abs_err(out4, ref4),
            ms=cuda_ms(lambda: packing_mod.pack(*pack_in, **st), 3),
            plain_ms=cuda_ms(lambda: packing_mod.pack_reference(*pack_in, **st), 1),
            bound=bound_ms(nbytes(pack_in) + nbytes(out4),
                           pack_ops(a["g_count"], out4[5], out4[2], T, R, V1, dyn=dyn, P=P)),
            shape=shape + ", classed route off",
        ),
    }


def decisions(results, pods):
    name = {p.uid: p.metadata.name for p in pods}
    claims = sorted(
        (c.template.node_pool_name, tuple(sorted(p.metadata.name for p in c.pods)),
         tuple(it.name for it in c.instance_type_options))
        for c in results.new_node_claims
    )
    existing = sorted((en.name, tuple(sorted(p.metadata.name for p in en.pods)))
                      for en in results.existing_nodes)
    return claims, existing, sorted(name[u] for u in results.pod_errors)


def phase_end_to_end(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 3: the main path through TorchSolver.solve, counted."""
    import torch

    from karpenter_tpu_torch import _build, obs
    from karpenter_tpu_torch.solver.example import example_state_nodes
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    def make(device, n_pods, n_nodes=0, cache=None):
        pods = mixed_pods(n_pods)
        nodes = example_state_nodes(n_nodes) if n_nodes else ()
        solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES,
                             state_nodes=nodes, device=device, cache=cache)
        return solver, pods

    def run(device, n_pods, n_nodes=0, cache=None):
        solver, pods = make(device, n_pods, n_nodes, cache)
        return solver.solve(pods), pods

    def counted(label, n_pods, n_nodes=0):
        """One path on the card, its launch counts zeroed just before and
        read just after; each kernel in PATH_KERNELS[label] must have run."""
        solver, pods = make("cuda", n_pods, n_nodes)
        _build.reset_launches()
        res = solver.solve(pods)
        counts = dict(_build.launches)
        missing = [k for k in PATH_KERNELS[label] if counts[k] < 1]
        if missing:
            raise SmokeFailure(f"{label} path never launched {missing} (counts {counts})")
        return res, pods, counts

    res_a, pods_a, launches_a = counted("50k", N_PODS)
    res_b, pods_b, launches_b = counted("nodes", NODE_PODS, N_NODES)
    launches = {"50k": launches_a, "nodes": launches_b}
    for res, pods, label in ((res_a, pods_a, "50k"), (res_b, pods_b, "nodes")):
        uids = {p.uid for p in pods}
        placed = sum(len(c.pods) for c in res.new_node_claims) + sum(
            sum(p.uid in uids for p in en.pods) for en in res.existing_nodes)
        if res.pod_errors or placed != len(pods):
            raise SmokeFailure(f"{label}: {len(res.pod_errors)} errors, "
                               f"{placed}/{len(pods)} placed")
    cpu_a = decisions(*run("cpu", N_PODS))
    cpu_b = decisions(*run("cpu", NODE_PODS, N_NODES))
    if decisions(res_a, pods_a) != cpu_a or decisions(res_b, pods_b) != cpu_b:
        raise SmokeFailure("CUDA decisions differ from the device='cpu' solve")

    cache = encode_cache_cls()
    run("cuda", N_PODS, cache=cache)  # warm the catalog encode
    times = []
    for _ in range(5):
        solver, pods = make("cuda", N_PODS, cache=cache)
        t0 = time.perf_counter()
        solver.solve(pods)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    solver, pods = make("cuda", N_PODS, cache=cache)
    tracer = obs.install(obs.Tracer(obs.PerfClock()))
    try:
        solver.solve(pods)
    finally:
        obs.uninstall()
    totals = tracer.phase_totals()
    phases = {k: totals.get(f"solve.{k}", 0.0) * 1e3
              for k in ("partition", "encode", "transfer", "dispatch", "guard",
                        "decode")}
    # the rest of the traced solve: oracle hand-off, claim truncation, audit
    phases["other"] = totals.get("solve", 0.0) * 1e3 - sum(phases.values())
    return dict(
        launches=launches,
        claims_50k=len(res_a.new_node_claims),
        claims_nodes=len(res_b.new_node_claims),
        solve_p50_ms=statistics.median(times),
        solve_ms=times,
        phase_ms=phases,
    )


def command_signature(cmd):
    """A consolidation Command by name: decision, disrupted candidates,
    each replacement's options and requirements."""
    return (
        cmd.decision,
        sorted(c.name for c in cmd.candidates),
        [[it.name for it in rep.instance_type_options] for rep in cmd.replacements],
        [repr(sorted(map(repr, rep.requirements))) for rep in cmd.replacements],
    )


def abandoned_prefetch(label, method, candidates, budgets):
    """1 when the single-node sweep ended with one chunk prefetched and
    never collected: it submits chunk n+1 while deciding chunk n, so a
    sweep that succeeds before reaching the next chunk leaves that launch
    behind, which is no dispatch of the search."""
    if label != "single":
        return 0
    from karpenter_tpu_torch.controllers.disruption.methods import _budget_filter

    swept = _budget_filter(method.sort_candidates(candidates), budgets)
    return int(len(swept) > method.last_probes)


def phase_consolidation():
    """Phase 4: both consolidation methods through compute_command on the
    card, each path counted on its own."""
    import torch

    from karpenter_tpu_torch import _build, obs
    from karpenter_tpu_torch.solver import workloads as wl

    out = {}
    for label, build in (("multi", wl.build_consolidation_env),
                         ("single", wl.build_single_consolidation_env)):
        ctx, method, candidates, budgets = build(CONS_NODES, "cpu")
        want = (command_signature(method.compute_command(candidates, budgets)),
                method.last_probes, method.last_dispatches)

        ctx, method, candidates, budgets = build(CONS_NODES, "cuda")
        _build.reset_launches()
        cmd = method.compute_command(candidates, budgets)
        torch.cuda.synchronize()
        counts, scen = dict(_build.launches), dict(_build.scenario_launches)
        got = (command_signature(cmd), method.last_probes, method.last_dispatches)
        solvers = [e["solver"] for e in ctx.scenario_envs._entries.values()]
        fallbacks = sum(sv.fallback_solves for sv in solvers)
        if not solvers or fallbacks:
            raise SmokeFailure(f"{label}: {fallbacks} sequential fallbacks "
                               f"({[sv.last_fallback_reasons for sv in solvers]})")
        prefetched = abandoned_prefetch(label, method, candidates, budgets)
        if not 1 <= scen["pack"] - prefetched == method.last_dispatches:
            raise SmokeFailure(f"{label}: {scen['pack']} scenario-batched pack launches "
                               f"for {method.last_dispatches} dispatches "
                               f"+ {prefetched} prefetch")
        if counts["pack"] != scen["pack"]:
            raise SmokeFailure(f"{label}: {counts['pack'] - scen['pack']} single-"
                               "scenario pack launches during the search")
        missing = [k for k in CONS_KERNELS if scen[k] < 1]
        if counts["fresh_feasibility"] < 1 or missing:
            raise SmokeFailure(f"{label} path never launched {missing} "
                               f"(counts {counts}, scenario {scen})")
        if got != want:
            raise SmokeFailure(f"{label}: the CUDA command {got[0][:2]} "
                               f"({got[1]} probes, {got[2]} dispatches) differs from "
                               f"the device='cpu' run's {want[0][:2]} ({want[1]}, {want[2]})")

        # p50 over 5 warm passes, each on a fresh env (the first pass warms)
        times = []
        for _ in range(6):
            ctx, method, candidates, budgets = build(CONS_NODES, "cuda")
            gc.collect()
            t0 = time.perf_counter()
            method.compute_command(candidates, budgets)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ctx, method, candidates, budgets = build(CONS_NODES, "cuda")
        tracer = obs.install(obs.Tracer(obs.PerfClock()))
        try:
            method.compute_command(candidates, budgets)
            torch.cuda.synchronize()
        finally:
            obs.uninstall()
        totals = tracer.phase_totals()
        phases = {k: totals.get(k, 0.0) * 1e3
                  for k in ("scenario.build", "solve.encode", "solve.transfer",
                            "kernel.dispatch", "solve.dispatch", "solve.guard",
                            "solve.decode")}
        # the rest of the traced decision: candidate walk, pricing, audit
        phases["other"] = totals.get(f"consolidate.{label}", 0.0) * 1e3 - sum(phases.values())
        out[label] = dict(
            decision=cmd.decision, disrupted=len(cmd.candidates),
            probes=method.last_probes, dispatches=got[2],
            launches=counts, scenario_launches=scen, prefetched=prefetched,
            p50_ms=statistics.median(times[1:]), ms=times[1:], phase_ms=phases,
        )
    return out


def phase_constrained(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 5: the constrained provisioning loop, cold and warm, on the
    card (BASELINE config[2]; bench.py's constrained-churn protocol)."""
    from karpenter_tpu_torch.solver.workloads import constrained_mix

    return provisioning_loop(torch_solver_cls, config_cls, encode_cache_cls, constrained_mix,
                             N_PODS, N_TYPES_C, "constrained", "ticks")


def phase_diverse(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 6: the reference's diverse 5-class mix, cold and warm, on the
    card (bench.py's diverse-ref batch and diverse-churn protocol), every
    solve through the class-batched scan (B5)."""
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix

    out = provisioning_loop(torch_solver_cls, config_cls, encode_cache_cls,
                            diverse_reference_mix, N_DIVERSE, N_TYPES, "diverse",
                            "diverse_ticks")
    if out["claims"] != DIVERSE_CLAIMS or out["errors"] or out["placed"] != N_DIVERSE:
        raise SmokeFailure(f"diverse: {out['claims']} claims, {out['placed']} placed, "
                           f"{out['errors']} errors (want {DIVERSE_CLAIMS}, {N_DIVERSE}, 0)")
    # the same batch through SolverConfig(classed=False): B4 with its
    # contributor counting, deciding as the classed route does
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver.example import example_nodepool

    pods = diverse_reference_mix(N_DIVERSE)
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(N_TYPES)}
    runs = {}
    for classed in (True, False):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        solver = torch_solver_cls(pools, its, topo, encode_cache=encode_cache_cls(),
                                  config=config_cls(device="cuda", classed=classed))
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solver.solve(pods)
        torch.cuda.synchronize()
        runs[classed] = (decisions(res, pods), dict(_build.launches),
                         (time.perf_counter() - t0) * 1e3)
    counts = runs[False][1]
    missing = [k for k in PATH_KERNELS["diverse_per_group"] if counts[k] < 1]
    extra = [k for k in PATH_ABSENT["diverse_per_group"] if counts[k]]
    if missing or extra:
        raise SmokeFailure(f"diverse_per_group path: missing {missing}, launched {extra} "
                           f"(counts {counts})")
    if runs[False][0] != runs[True][0]:
        raise SmokeFailure("diverse: the per-group scan (B4) decides otherwise than B5")
    out["launches"]["diverse_per_group"] = counts
    out["per_group_ms"], out["classed_ms"] = runs[False][2], runs[True][2]
    return out


def provisioning_loop(torch_solver_cls, config_cls, encode_cache_cls, mix, n_pods, n_types,
                      cold_label, tick_label):
    """A provisioning loop on the card over ``mix(n_pods)`` x ``n_types``
    types: a cold solve counted as ``cold_label`` with the decisions and
    placed/error counts of device="cpu"; cold p50 over 5 fresh
    EncodeCaches and one traced cold solve; two warm-ups and N_TICKS churn
    ticks (workloads.churn_tick) counted as ``tick_label``, each riding row
    deltas through B8 and equal to a full re-encode over the same vocab,
    plus one traced tick; an unchanged repeat hitting REUSE; no sequential
    fallback anywhere."""
    import random

    import torch

    from karpenter_tpu_torch import _build, obs
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver.example import example_nodepool
    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick

    # one catalog for the whole loop, as a provisioner holds it
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}

    def solver_for(pods, cache, device="cuda"):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        return torch_solver_cls(pools, its, topo, config=config_cls(device=device),
                                encode_cache=cache)

    def counted(label, solver, pods):
        """One solve with the launch counts zeroed just before and read just
        after; each kernel of PATH_KERNELS[label] must have run, none of
        PATH_ABSENT[label], and B5 (on its paths) once per dispatch."""
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solver.solve(pods)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.launches)
        missing = [k for k in PATH_KERNELS[label] if counts[k] < 1]
        if missing:
            raise SmokeFailure(f"{label} path never launched {missing} (counts {counts})")
        extra = [k for k in PATH_ABSENT.get(label, ()) if counts[k]]
        if extra:
            raise SmokeFailure(f"{label} path launched {extra} (counts {counts})")
        if "pack_classed" in PATH_KERNELS[label] and counts["pack_classed"] != solver.last_dispatches:
            raise SmokeFailure(f"{label}: {counts['pack_classed']} B5 launches for "
                               f"{solver.last_dispatches} dispatches")
        if solver.fallback_solves:
            raise SmokeFailure(f"{label}: sequential fallbacks {solver.last_fallback_reasons}")
        return res, counts, ms

    def placed_errors(res, pods):
        uids = {p.uid for p in pods}
        placed = sum(sum(p.uid in uids for p in c.pods) for c in res.new_node_claims)
        return placed, len(res.pod_errors)

    def traced(solver, pods):
        tracer = obs.install(obs.Tracer(obs.PerfClock()))
        try:
            t0 = time.perf_counter()
            solver.solve(pods)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            obs.uninstall()
        totals = tracer.phase_totals()
        phases = {k: totals.get(f"solve.{k}", 0.0) * 1e3
                  for k in ("partition", "encode", "transfer", "dispatch", "guard",
                            "decode")}
        phases["other"] = totals.get("solve", 0.0) * 1e3 - sum(phases.values())
        # the wall time past the solve span: the audit record's claim
        # pricing, which runs only under tracing
        phases["audit"] = ms - totals.get("solve", 0.0) * 1e3
        return ms, phases

    pods = mix(n_pods)
    # cold, counted, against the plain versions on the CPU
    res, cold_counts, _ = counted(cold_label, solver_for(pods, encode_cache_cls()), pods)
    cpu = solver_for(pods, encode_cache_cls(), "cpu").solve(pods)
    if decisions(res, pods) != decisions(cpu, pods):
        raise SmokeFailure(f"{cold_label}: CUDA decisions differ from the device='cpu' solve")
    if placed_errors(res, pods) != placed_errors(cpu, pods):
        raise SmokeFailure(f"{cold_label}: placed/errors {placed_errors(res, pods)} vs cpu "
                           f"{placed_errors(cpu, pods)}")
    placed, errors = placed_errors(res, pods)
    claims = len(res.new_node_claims)
    # cold p50: every solve from a fresh EncodeCache (full encode, full staging)
    cold_ms = []
    for _ in range(5):
        solver = solver_for(pods, encode_cache_cls())
        gc.collect()
        t0 = time.perf_counter()
        solver.solve(pods)
        torch.cuda.synchronize()
        cold_ms.append((time.perf_counter() - t0) * 1e3)
    cold_traced_ms, cold_phases = traced(solver_for(pods, encode_cache_cls()), pods)

    # warm: two warm-ups (a-priori, then adaptive NMAX), then the churn ticks
    cache = encode_cache_cls()
    rng = random.Random(CHURN_SEED)
    solver_for(pods, cache).solve(pods)
    solver_for(pods, cache).solve(pods)
    ticks = []
    tick_counts = {}
    # N_TICKS timed ticks, then one traced tick for the span split (the
    # tracer waits on the staging and prices the claims for the audit, so
    # traced and untraced times do not compare)
    for i in range(N_TICKS + 1):
        pods = churn_tick(pods, mix, rng)
        s = solver_for(pods, cache)
        gc.collect()
        tracer = obs.install(obs.Tracer(obs.PerfClock())) if i == N_TICKS else None
        try:
            res, counts, ms = counted(tick_label, s, pods)
        finally:
            if tracer is not None:
                obs.uninstall()
        totals = tracer.phase_totals() if tracer is not None else {}
        store = cache.device_store
        full = not s.last_encode_reused and s.last_delta_rows == 0
        device_rows, full_puts = store.last_delta_rows, store.last_full_puts
        if full or device_rows < 1 or counts["apply_rows"] < 1:
            raise SmokeFailure(
                f"tick {len(ticks) + 1}: full re-encode {full}, device delta rows "
                f"{device_rows}, B8 launches {counts['apply_rows']}")
        # the same pods fully re-encoded and restaged over the same vocab:
        # the warm encoding's contract. A fresh EncodeCache interns the zone
        # values in another order and breaks ties elsewhere, in the JAX
        # package as here (tests/test_torch_residency.py pins the reference
        # doing so on this protocol)
        cache.cluster.invalidate("full re-encode check")
        store.reset()
        full_res = solver_for(pods, cache).solve(pods)
        if decisions(res, pods) != decisions(full_res, pods):
            raise SmokeFailure(f"tick {len(ticks) + 1}: decisions differ from a full re-encode")
        for k, v in counts.items():
            tick_counts[k] = tick_counts.get(k, 0) + v
        tick = dict(ms=ms, encode_delta_rows=s.last_delta_rows,
                    device_delta_rows=device_rows, full_puts=full_puts,
                    b8=counts["apply_rows"])
        if tracer is None:
            ticks.append(tick)
        else:
            traced_tick = dict(tick, phases={
                k: totals.get(f"solve.{k}", 0.0) * 1e3
                for k in ("partition", "encode", "transfer", "delta_apply", "dispatch",
                          "guard", "decode")})
            traced_tick["phases"]["other"] = (
                totals.get("solve", 0.0) * 1e3 - sum(traced_tick["phases"].values())
                + traced_tick["phases"]["delta_apply"])
            traced_tick["phases"]["audit"] = ms - totals.get("solve", 0.0) * 1e3
    # an unchanged repeat: REUSE, no transfer at all
    s = solver_for(pods, cache)
    s.solve(pods)
    store = cache.device_store
    if not s.last_encode_reused or store.last_full_puts or s.fallback_solves:
        raise SmokeFailure(f"repeat: reused {s.last_encode_reused}, full puts "
                           f"{store.last_full_puts}, fallbacks {s.fallback_solves}")
    return dict(
        claims=claims, placed=placed, errors=errors,
        launches={cold_label: cold_counts, tick_label: tick_counts},
        cold_p50_ms=statistics.median(cold_ms), cold_ms=cold_ms,
        cold_traced_ms=cold_traced_ms, cold_phases=cold_phases,
        tick_p50_ms=statistics.median(t["ms"] for t in ticks), ticks=ticks,
        traced_tick=traced_tick,
    )


def pin_one_card():
    """The smoke uses one card: expose only the first visible one, so that
    torch.cuda.device_count() is the number of cards it used."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    elif visible.strip():
        os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0].strip()


def main():
    pin_one_card()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import _build
        from karpenter_tpu_torch.solver.driver import (
            EncodeCache,
            SolverConfig,
            TorchSolver,
        )
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    logs = _build.build(force=True, verbose=True)
    build_s = time.perf_counter() - t0
    log(f"phase 1 device+build: {smi} | {len(logs)} kernels built in "
        f"{build_s:.2f} s | " + "; ".join(
            f"{name}: {ptxas_summary(text)}" for name, text in logs.items()))

    rows = phase_kernels(TorchSolver, SolverConfig, EncodeCache)
    b7 = rows["solve_scenarios"]
    log("phase 2 kernels==plain: " + "; ".join(
        f"{k} [{r['shape']}] {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound'][0]:.6f} ms"
        + (f", {LIBRARY[k]} {r['library_ms']:.4f} ms" if k in LIBRARY else "") + ")"
        for k, r in rows.items())
        + " | B7 parts " + " ".join(
            f"{k}={b7['part_ms'][k]:.4f}ms(err {b7['parts'][k]})" for k in b7["part_ms"]))

    e2e = phase_end_to_end(TorchSolver, SolverConfig, EncodeCache)
    log(f"phase 3 end-to-end: {N_PODS} pods x {N_TYPES} types -> "
        f"{e2e['claims_50k']} claims, 0 errors, decisions == cpu; "
        f"p50 {e2e['solve_p50_ms']:.1f} ms of "
        + "/".join(f"{t:.1f}" for t in e2e["solve_ms"]) + " ms; phases "
        + " ".join(f"{k}={v:.1f}ms" for k, v in e2e["phase_ms"].items())
        + "; launches " + " ".join(f"{p}={c}" for p, c in e2e["launches"].items()))

    cons = phase_consolidation()
    log("phase 4 consolidation: " + "; ".join(
        f"{label} {c['decision']} {c['disrupted']} in {c['probes']} probes / "
        f"{c['dispatches']} dispatches == cpu, 0 fallbacks; p50 {c['p50_ms']:.1f} ms of "
        + "/".join(f"{t:.1f}" for t in c["ms"]) + " ms; phases "
        + " ".join(f"{k}={v:.1f}ms" for k, v in c["phase_ms"].items())
        + f"; launches {c['launches']} scenario {c['scenario_launches']}"
        + f" (1 an uncollected prefetch)" * c["prefetched"]
        for label, c in cons.items()))

    con = phase_constrained(TorchSolver, SolverConfig, EncodeCache)
    log(f"phase 5 constrained loop: {N_PODS} pods x {N_TYPES_C} types -> {con['claims']} "
        f"claims, {con['placed']} placed, {con['errors']} errors, decisions == cpu; "
        f"cold p50 {con['cold_p50_ms']:.1f} ms of " + "/".join(f"{t:.1f}" for t in con["cold_ms"])
        + f" ms; traced cold {con['cold_traced_ms']:.1f} ms: "
        + " ".join(f"{k}={v:.1f}ms" for k, v in con["cold_phases"].items())
        + f"; {N_TICKS} ticks (each == a full re-encode, row deltas, B8, no full "
        f"re-encode) p50 {con['tick_p50_ms']:.1f} ms: " + "; ".join(
            f"{t['ms']:.1f} ms (encode delta rows {t['encode_delta_rows']}, device delta "
            f"rows {t['device_delta_rows']}, full puts {t['full_puts']}, B8 {t['b8']})"
            for t in con["ticks"])
        + f"; traced tick {con['traced_tick']['ms']:.1f} ms: " + " ".join(
            f"{k}={v:.2f}ms" for k, v in con["traced_tick"]["phases"].items())
        + "; repeat REUSE, 0 full puts, 0 fallbacks; launches "
        + " ".join(f"{p}={c}" for p, c in con["launches"].items()))

    div = phase_diverse(TorchSolver, SolverConfig, EncodeCache)
    log(f"phase 6 diverse loop: {N_DIVERSE} pods x {N_TYPES} types (classed route) -> "
        f"{div['claims']} claims, {div['placed']} placed, {div['errors']} errors, decisions "
        f"== cpu; cold p50 {div['cold_p50_ms']:.1f} ms of "
        + "/".join(f"{t:.1f}" for t in div["cold_ms"])
        + f" ms; traced cold {div['cold_traced_ms']:.1f} ms: "
        + " ".join(f"{k}={v:.1f}ms" for k, v in div["cold_phases"].items())
        + f"; {N_TICKS} ticks (each == a full re-encode, row deltas, B8, no full "
        f"re-encode) p50 {div['tick_p50_ms']:.1f} ms: " + "; ".join(
            f"{t['ms']:.1f} ms (encode delta rows {t['encode_delta_rows']}, device delta "
            f"rows {t['device_delta_rows']}, full puts {t['full_puts']}, B8 {t['b8']})"
            for t in div["ticks"])
        + f"; traced tick {div['traced_tick']['ms']:.1f} ms: " + " ".join(
            f"{k}={v:.2f}ms" for k, v in div["traced_tick"]["phases"].items())
        + "; repeat REUSE, 0 full puts, 0 fallbacks; classed=False solve (B4 with "
        f"contributor counting) == classed solve, {div['per_group_ms']:.1f} ms vs "
        f"{div['classed_ms']:.1f} ms; launches "
        + " ".join(f"{p}={c}" for p, c in div["launches"].items()))

    # every path's own counts: the solves, the searches, the two loops
    paths = dict(e2e["launches"])
    paths.update({label: c["launches"] for label, c in cons.items()})
    paths.update(con["launches"])
    paths.update(div["launches"])
    scen_paths = {label: c["scenario_launches"] for label, c in cons.items()}
    kernels = []
    for name, row in rows.items():
        bms, by = row["bound"]
        if name == "solve_scenarios":  # B7: the S > 1 dispatches of the searches
            by_path = {p: c["pack"] for p, c in scen_paths.items()}
            source = "karpenter_tpu_torch/csrc/pack.cu"
            extra = dict(sources=[f"karpenter_tpu_torch/csrc/{k}.cu" for k in B7_SOURCES],
                         parts_ms=row["part_ms"])
        else:
            by_path = {p: c[name] for p, c in paths.items()}
            source = f"karpenter_tpu_torch/csrc/{SOURCES.get(name, name)}.cu"
            extra = {"library": LIBRARY[name]} if name in LIBRARY else {}
        kernels.append(dict(
            name=name, route="cuda", source=source,
            replaces=REPLACES[name],
            launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=bms, bound_by=by, library_ms=row.get("library_ms"),
            **extra,
        ))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),  # 1: pin_one_card
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
