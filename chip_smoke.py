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
   2,000-node cluster's shared encoding (N=2048, T=50);
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
   split of one traced pass.

Then one JSON line of per-kernel numbers, the nvidia-smi line, and the
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
NODE_PODS, N_NODES = 2_000, 32
CONS_NODES, CONS_SCENARIOS = 2_000, 16  # BASELINE config[3]; one sweep chunk
REPLACES = {
    "fresh_feasibility": "karpenter_tpu/ops/feasibility.py:141",
    "existing_feasibility": "karpenter_tpu/ops/feasibility.py:264",
    "pack": "karpenter_tpu/ops/packing.py:277",
    "wire_pack": "karpenter_tpu/ops/solve.py:267",
    "solve_scenarios": "karpenter_tpu/ops/solve.py:357",
}
# B7 is the scenario-batched dispatch of these kernels; pack.cu holds its
# scenario grid
B7_SOURCES = ("pack", "existing_feasibility", "wire_pack", "fresh_feasibility")
# the kernels each end-to-end path must launch: B2 only runs with nodes
PATH_KERNELS = {
    "50k": ("fresh_feasibility", "pack", "wire_pack"),
    "nodes": ("fresh_feasibility", "existing_feasibility", "pack", "wire_pack"),
}
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


def device_snapshot(solver, pods):
    """The main path's kernel inputs for ``solver``'s batch: the padded
    solve_args on the card, the statics, NMAX and the fills dtype, built
    exactly as TorchSolver._solve_fast builds them."""
    import torch

    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.solver.args import to_device_args

    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    if rest:
        raise SmokeFailure(f"{len(rest)} pods left the dense path")
    snap, (a_tzc, res_cap0, a_res), _, _, _ = solver._encode_batch(groups)
    fit = solver._fit_matrix(snap)
    nmax = solver._select_nmax(snap, fit, None)
    G = enc._next_pow2(len(snap.groups), floor=8)
    N = enc._next_pow2(len(snap.existing_names), floor=1) if snap.existing_names else 0
    statics = solver._kernel_statics(snap, G)
    args = to_device_args(snap.padded(G, N).solve_args(a_tzc, res_cap0, a_res), "cuda")
    fills = torch.int16 if solver._fill_bound(snap, fit) < 2**15 else torch.int32
    return args, statics, nmax, fills


def phase_kernels(torch_solver_cls, config_cls):
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
    pack_in = pack_args(a, *b1, cap_ng)
    st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"])
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
    for name, row in rows.items():
        if row["max_abs_err"] != 0.0:
            raise SmokeFailure(f"{name}: kernel disagrees with its plain version "
                               f"(max |diff| {row['max_abs_err']})")
    return rows


def pack_ops(g_count, claim_fills, n_open, T, R, V1):
    """Operations the scan's inputs need: per group step, each claim
    opened at an earlier step is checked against every type (2R fits
    compares, V1 x V1 offering cells), plus a few per claim slot. Over a
    leading scenario axis, the sum over scenarios."""
    import torch

    g_count, claim_fills, n_open = g_count.cpu(), claim_fills.cpu(), n_open.cpu()
    if g_count.dim() == 1:
        g_count, claim_fills, n_open = g_count[None], claim_fills[None], n_open[None]
    G, nmax = claim_fills.shape[1:]
    ops = 0
    for counts, fills, opened in zip(g_count, claim_fills, n_open):
        first = [int(torch.nonzero(fills[:, s])[0, 0]) for s in range(int(opened))]
        live = sum(sum(1 for f in first if f < g) for g in range(G) if int(counts[g]) > 0)
        ops += live * T * (2 * R + V1 * V1) + G * nmax * 8
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


def plain_scenarios(args, nmax, fills, zone_kid, ct_kid, wf_iters, **_):
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
        *pack_args(a, compat_pg, type_ok, n_fit, cap_ng),
        nmax=nmax, zone_kid=zone_kid, ct_kid=ct_kid, wf_iters=wf_iters)
    return solve_mod.wire_pack_reference(outs, fills)


def pack_args(a, compat_pg, type_ok, n_fit, cap_ng):
    return (
        [a[n] for n in ("g_count", "g_req", "g_def", "g_neg", "g_mask",
                        "g_hcap", "g_haff", "g_hstg", "g_hscap", "g_hself")]
        + [compat_pg, type_ok, n_fit, cap_ng]
        + [a[n] for n in ("t_alloc", "t_cap", "a_tzc", "p_daemon", "p_limit",
                          "p_has_limit", "p_tol", "n_avail", "n_base", "n_hcnt",
                          "nh_cnt0", "well_known")]
    )


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
    st = dict(nmax=token["nmax"], zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"])

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
    b4_in = pack_args(a, *b1, b2)
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

    rows = phase_kernels(TorchSolver, SolverConfig)
    b7 = rows["solve_scenarios"]
    log("phase 2 kernels==plain: " + "; ".join(
        f"{k} [{r['shape']}] {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound'][0]:.6f} ms)" for k, r in rows.items())
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

    # every path's own counts: the two solves, then the two searches
    paths = dict(e2e["launches"])
    paths.update({label: c["launches"] for label, c in cons.items()})
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
            source = f"karpenter_tpu_torch/csrc/{name}.cu"
            extra = {}
        kernels.append(dict(
            name=name, route="cuda", source=source,
            replaces=REPLACES[name],
            launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=bms, bound_by=by, library_ms=None,
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
