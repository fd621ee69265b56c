"""The CUDA kernels against their plain versions, on the card.

Every case builds its inputs with the port alone (no jax, no
karpenter_tpu: the card's machine has neither), runs the fused solve on
CUDA tensors — kernels B1, B2, B4, B6 — and on CPU tensors — their plain
versions — and requires exact equality of every output. The cases reach
the pack kernel's paths the chip smoke's mixed batch does not: hostname
caps and affinity, shared hostname slots, existing nodes, the NodePool
limit ledger over weighted templates, and overflow. The scenario cases run
the consolidation dispatch (ops/solve.py:solve_scenarios_core_packed):
B2 over n_tol [S, N, G], B4 one block per scenario, B6 over S rows, with
padded scenarios and per-scenario topology priors. The domain cases run
B4's domain machinery (zonal and capacity-type spread, affinity, a gate
owner, priors on zoned nodes; one block and the scenario grid with
per-scenario domain priors), the B8 cases the row-delta apply
(every dtype, a duplicate index, negative and dropped indices, the old
tensor untouched), and the last section B5, the class-batched scan, on
class batches (both domain axes, contributor rows, existing nodes,
overflow, a domain-free batch: every field of the final state), B4's
contributor counting (one block and the scenario grid), and the diverse
1,000 x 400 solve on the card against the CPU. The relax section holds
B3's two entries against their plain versions and B1's/B2's tables (at
the example shapes, over nodes, at G = 1), the ops dense route against
the sparse one, B9 against its plain version on every lane (infeasible
rows, padding, n_per = 2**30, T = 0), and TorchSolver's default route
on the zonal partial mix against the CPU in claim slot order. The tiled
section runs the scans in the tiled mode (tile_feasibility: no table
launch, each step's rows built in the scan): B4 over plain, limited,
domain, minValues and ledger batches and over existing nodes (the cap
row), B5 over the diverse mix with and without nodes, and B7's grid with
per-scenario n_tol, each against its plain tiled version and against
the untiled kernel. The last sections hold B4's live extent and cluster
(NMAX at least 8x the claims on each path, the overflow boundary and the
driver's doubling retry, B7's grid of clusters against each scenario
solved alone), B5's (8 tainted tenant pools whose class heads see claims
of other pools, untiled and tiled; a class head that finds no claim it
can take, by pool or by a zone clash; overflow and doubling; launches
back to back, and over junk-filled scratch) and B8 in one launch on its
edge cases (rows of 15 bytes,
rows the blocks' share does not divide, every row, aliased and dropped
indices, an empty delta), and B8's in-place entry (KTPU_DONATE_DELTA=1)
on the same cases, on mask and count rows and from an unaligned base,
against its plain in-place version, with a tensor donated away raising
at its next launch (a queue token resubmitted after a donating churn
tick). The last section holds B1 and B2 over any
order of the live-pair index (shuffled, weight-0 padding interleaved, a
pair repeated, goff_idx repeated, P = 2, two mask words a key, the
scenario axis) with junk-filled outputs, at the main path's shapes
(mixed 50k, diverse-ref, constrained 50k also reordered, 32 nodes with
16 scenarios), one kernel a call under torch.profiler, and every
malformed input raising through the wrappers. The wide-vocabulary section
(ROADMAP C1) holds B1 and B2 at K = 16, V1 = 2,048 and 65,536 (B1's
layouts by width), B4 with domains and B5 at V1 = 2,048 (their per-step
arrays spilled), the minValues scans at MW = 2,048, two wide solves
against device="cpu", and B3 and B6, one launch a call, at their paths'
shapes and at wide masks. The ladder section runs the degradation ladder
(``SolverConfig.health``) on the card: a dispatch fault to the oracle
rung and back on the kernel rung past the cool-down, a corrupted output
of card tensors quarantined before decode, a scenario-dispatch fault
declining a consolidation search to per-probe solves with the same
command (raising without a ladder), a fault of the card's own (a launch
error, a guard rejection; not injected) propagating with a ladder set,
and the native host backend equal to the card's exact route. The
sidecar section runs the cross-tenant batch lane on the card (four
tenants in one scenario dispatch, equal to their solo card solves and
the CPU union; a launch error of the union, not injected, reaching all
four) and four tenants solving from four threads at once, equal to their
serial answers with the launch counters equal to the serial run's. The
twin section replays the digital twin's small chaos replay on the card:
its canonical audit and fault log equal to the device="cpu" replay's.

Marked ``cuda``: they skip where there is no card. On the card, from the
repo root: ``python -m pytest tests/test_torch_cuda.py -q --noconftest``
(tests/conftest.py imports jax).
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.api import labels
from karpenter_tpu_torch.api import resources as res
from karpenter_tpu_torch.api.objects import (
    LabelSelector,
    NodePool,
    NodePoolSpec,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodSpec,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.cloudprovider import corpus
from karpenter_tpu_torch.kube import Client, TestClock
from karpenter_tpu_torch.ops.solve import (
    solve_core,
    solve_scenarios_core_packed,
    wire_pack,
)
from karpenter_tpu_torch.scheduling.topology import Topology
from karpenter_tpu_torch.solver import encode as enc
from karpenter_tpu_torch.solver.args import to_device_args
from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver
from karpenter_tpu_torch.solver.example import (
    example_nodepool,
    example_pods,
    example_snapshot_arrays,
    example_state_nodes,
)
from karpenter_tpu_torch.solver.workloads import constrained_mix, mixed_pods, spot_od_pools

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def slots(results):
    """The claims in slot order (sorted pod names, options in their own
    order): decode mints claim identities from it."""
    return [(tuple(sorted(p.metadata.name for p in c.pods)),
             tuple(it.name for it in c.instance_type_options))
            for c in results.new_node_claims]


def _pods(n, cpu_m, app=None, anti=False, spread=False, co=False):
    terms = {}
    sel = LabelSelector(match_labels={"app": app}) if app else None
    if anti:
        terms["pod_anti_affinity"] = [PodAffinityTerm(topology_key=labels.HOSTNAME, label_selector=sel)]
    if co:
        terms["pod_affinity"] = [PodAffinityTerm(topology_key=labels.HOSTNAME, label_selector=sel)]
    if spread:
        terms["topology_spread_constraints"] = [TopologySpreadConstraint(
            max_skew=1, topology_key=labels.HOSTNAME,
            when_unsatisfiable="DoNotSchedule", label_selector=sel)]
    return [
        Pod(
            metadata=ObjectMeta(name=f"{app or 'p'}-{cpu_m}-{i}",
                                labels={"app": app} if app else {}),
            spec=PodSpec(requests={res.CPU: cpu_m, res.MEMORY: 2**30 * res.MILLI},
                         **terms),
        )
        for i in range(n)
    ]


def _pool(name, weight, cpu_limit=None):
    limits = {res.CPU: res.parse_quantity(cpu_limit)} if cpu_limit else {}
    return NodePool(metadata=ObjectMeta(name=name),
                    spec=NodePoolSpec(limits=limits, weight=weight))


def _snapshot(pods, pools=None, n_types=20, n_nodes=0):
    pools = pools or [example_nodepool()]
    its = {p.name: corpus.generate(n_types) for p in pools}
    nodes = example_state_nodes(n_nodes)
    topo = Topology(Client(TestClock()), nodes, pools, its, pods)
    solver = TorchSolver(pools, its, topo, state_nodes=nodes,
                         config=SolverConfig(device="cpu"))
    groups, rest = enc.partition_and_group(pods, topology=topo)
    assert not rest
    snap, avail, *_ = solver._encode_batch(groups)
    statics = solver._kernel_statics(snap, len(snap.groups))
    statics["nmax"] = solver._estimate_nmax(snap, solver._fit_matrix(snap))
    return snap.solve_args(*avail), statics


def _kernels_equal_plain(args, statics, cuda):
    plain = solve_core(*to_device_args(args, "cpu"), **statics)
    kern = solve_core(*to_device_args(args, cuda), **statics)
    for i, (k, p) in enumerate(zip(kern, plain)):
        assert k.dtype == p.dtype and k.shape == p.shape, i
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"output {i}")
    for dtype in (torch.int16, torch.int32):
        for i, (k, p) in enumerate(zip(wire_pack(kern, dtype), wire_pack(plain, dtype))):
            np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"wire {i}")
    return plain


@pytest.mark.parametrize("n_pods,n_types,shapes", [(16, 4, 1), (200, 40, 8), (1000, 60, 25)])
def test_example_snapshots(cuda, n_pods, n_types, shapes):
    args, statics = example_snapshot_arrays(n_pods, n_types, shapes)
    _kernels_equal_plain(args, dict(statics, sparse_groups=True), cuda)


@pytest.mark.parametrize("n_nodes", [1, 8, 33])
def test_existing_nodes(cuda, n_nodes):
    args, statics = _snapshot(mixed_pods(400), n_types=30, n_nodes=n_nodes)
    out = _kernels_equal_plain(args, statics, cuda)
    assert int(out[4].sum()) > 0


@pytest.mark.parametrize("n_nodes", [0, 3])
def test_hostname_caps_and_shared_slots(cuda, n_nodes):
    pods = (
        _pods(4, 1000, "x", anti=True) + _pods(4, 2000, "x", anti=True)
        + _pods(5, 1000, "y", spread=True) + _pods(5, 3000, "y", spread=True)
        + _pods(12, 500, "z", spread=True) + _pods(30, 250)
    )
    args, statics = _snapshot(pods, n_types=12, n_nodes=n_nodes)
    assert (np.asarray(args[14]) >= 0).any()  # shared hostname slots
    _kernels_equal_plain(args, statics, cuda)


@pytest.mark.parametrize("n_nodes", [0, 2])
def test_hostname_affinity(cuda, n_nodes):
    pods = _pods(5, 1000, "co", co=True) + _pods(8, 2000)
    args, statics = _snapshot(pods, n_types=16, n_nodes=n_nodes)
    assert np.asarray(args[6]).any()
    _kernels_equal_plain(args, statics, cuda)


@pytest.mark.parametrize("limit", ["12", "40"])
def test_weighted_templates_with_limits(cuda, limit):
    pools = [_pool("heavy", 80, limit), _pool("light", 20)]
    args, statics = _snapshot(mixed_pods(150, gpu_fraction=0.0), pools, n_types=20)
    _kernels_equal_plain(args, statics, cuda)


def test_spot_od_pools(cuda):
    args, statics = _snapshot(mixed_pods(600), spot_od_pools(), n_types=30)
    _kernels_equal_plain(args, statics, cuda)


@pytest.mark.parametrize("nmax", [1, 4])
def test_overflow(cuda, nmax):
    args, statics = example_snapshot_arrays(200, 40, 8)
    out = _kernels_equal_plain(args, dict(statics, nmax=nmax, sparse_groups=True), cuda)
    assert bool(out[3])


_B1 = ("g_def", "g_neg", "g_mask", "g_req", "p_def", "p_neg", "p_mask",
       "p_daemon", "p_tol", "p_titype_ok", "t_def", "t_mask", "t_alloc",
       "o_avail", "o_zone", "o_ct", "well_known", "gk_g", "gk_k", "gk_w",
       "goff_idx")
_B2 = ("g_def", "g_neg", "g_mask", "g_req", "n_def", "n_mask", "n_avail",
       "n_base", "n_tol", "gk_g", "gk_k", "gk_w")


def test_empty_shapes(cuda):
    """No instance types: B1 still writes compat_pg, and counts its launch.
    No existing nodes: B2 launches nothing and counts nothing."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas

    args, statics = example_snapshot_arrays(64, 16, 4)
    a = dict(zip(enc.SOLVE_ARG_NAMES, to_device_args(args, cuda)))
    a["p_titype_ok"] = a["p_titype_ok"][:, :0].contiguous()
    for n in ("t_def", "t_mask", "t_alloc", "o_avail", "o_zone", "o_ct",
              "n_def", "n_mask", "n_avail", "n_base", "n_tol"):
        a[n] = a[n][:0].contiguous()
    kw = dict(zone_kid=statics["zone_kid"], ct_kid=statics["ct_kid"])
    _build.reset_launches()
    kern = feas.fresh_claim_feasibility_sparse(*(a[n] for n in _B1), **kw)
    assert _build.launches["fresh_feasibility"] == 1
    plain = feas.fresh_claim_feasibility_sparse_reference(
        *(a[n].cpu() for n in _B1), **kw)
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy())
    assert plain[0].any()  # compat_pg is not all False by construction
    cap = feas.existing_node_feasibility_sparse(*(a[n] for n in _B2))
    assert tuple(cap.shape) == (0, a["g_mask"].shape[0])
    assert _build.launches["existing_feasibility"] == 0


def test_solver_decisions_match_cpu(cuda):
    def solve(device):
        pods = mixed_pods(3000)
        pools = [example_nodepool()]
        its = {pools[0].name: corpus.generate(60)}
        nodes = example_state_nodes(12)
        topo = Topology(Client(TestClock()), nodes, pools, its, pods)
        solver = TorchSolver(pools, its, topo, state_nodes=nodes,
                             config=SolverConfig(device=device))
        r = solver.solve(pods)
        return (
            slots(r),
            sorted((en.name, tuple(sorted(p.metadata.name for p in en.pods)))
                   for en in r.existing_nodes),
            len(r.pod_errors),
        )

    assert solve("cuda") == solve("cpu")


def _scenario_args(args, S, real, seed, batch_topo=False):
    """``args`` with a scenario axis: per real scenario a seeded subset of
    each group and a seeded set of removed nodes (n_tol rows zeroed);
    scenarios past ``real`` stay padded (g_count 0, no node). Under
    ``batch_topo`` the prior arrays gain the axis too, with seeded extra
    hostname priors."""
    rng = np.random.default_rng(seed)
    a = dict(zip(enc.SOLVE_ARG_NAMES, (np.asarray(x) for x in args)))
    N, G = a["n_tol"].shape
    g_count = np.zeros((S, G), np.int32)
    n_tol = np.zeros((S, N, G), bool)
    for si in range(real):
        g_count[si] = rng.integers(0, a["g_count"] + 1)
        n_tol[si] = a["n_tol"] & (rng.random(N) < 0.7)[:, None]
    a["g_count"], a["n_tol"] = g_count, n_tol
    if batch_topo:
        for name in ("g_dprior", "n_hcnt", "nh_cnt0", "dd0"):
            a[name] = np.repeat(a[name][None], S, axis=0)
        a["n_hcnt"] = a["n_hcnt"] + rng.integers(0, 2, a["n_hcnt"].shape, dtype=np.int32)
        a["nh_cnt0"] = a["nh_cnt0"] + rng.integers(0, 2, a["nh_cnt0"].shape, dtype=np.int32)
    return [a[n] for n in enc.SOLVE_ARG_NAMES]


def _scenarios_equal_plain(args, statics, cuda, batch_topo=False):
    from karpenter_tpu_torch import _build

    for fills in (torch.int16, torch.int32):
        kw = dict(statics, fills_dtype=fills, batch_topo=batch_topo)
        plain = solve_scenarios_core_packed(*to_device_args(args, "cpu"), **kw)
        _build.reset_launches()
        kern = solve_scenarios_core_packed(*to_device_args(args, cuda), **kw)
        torch.cuda.synchronize()
        # one launch each: B1 shared, B2/B4/B6 over every scenario
        assert _build.scenario_launches["pack"] == 1
        assert _build.scenario_launches["wire_pack"] == 1
        assert _build.launches["fresh_feasibility"] == 1
        assert _build.scenario_launches["fresh_feasibility"] == 0
        for i, (k, p) in enumerate(zip(kern, plain)):
            assert k.dtype == p.dtype and k.shape == p.shape, i
            np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"output {i}")
    return plain


@pytest.mark.parametrize("S,real", [(8, 5), (16, 16), (16, 1)])
def test_scenario_batch(cuda, S, real):
    args, statics = _snapshot(mixed_pods(1500), n_types=30, n_nodes=33)
    out = _scenarios_equal_plain(_scenario_args(args, S, real, seed=S + real), statics, cuda)
    assert int(out[4].sum()) > 0 and int(out[2].max()) > 0  # nodes and claims
    assert (out[2][real:] == 0).all() and not out[4][real:].any()  # padded


def test_scenario_batch_topology_priors(cuda):
    """batch_topo: n_hcnt / nh_cnt0 carry the scenario axis (a nonzero
    stride in the kernel), over hostname caps and shared slots."""
    pods = (
        _pods(4, 1000, "x", anti=True) + _pods(5, 1000, "y", spread=True)
        + _pods(12, 500, "z", spread=True) + _pods(30, 250)
    )
    args, statics = _snapshot(pods, n_types=12, n_nodes=6)
    _scenarios_equal_plain(
        _scenario_args(args, 8, 6, seed=3, batch_topo=True), statics, cuda,
        batch_topo=True,
    )


def test_scenario_batch_no_nodes_and_overflow(cuda):
    """No existing nodes (B2 launches nothing) and an NMAX too small for
    some scenarios: the overflow flags are per scenario."""
    args, statics = example_snapshot_arrays(200, 40, 8)
    out = _scenarios_equal_plain(
        _scenario_args(args, 8, 7, seed=1), dict(statics, nmax=4, sparse_groups=True), cuda)
    assert out[3].any()


def _single_sweep_env(device):
    """A single-node sweep that walks past its first chunk: 40 nodes of
    31.58 CPU each holding three 10-CPU pods, so no candidate consolidates
    and the sweep prefetches every chunk after the first."""
    from test_torch_scenarios import _candidates, _env

    from karpenter_tpu_torch.controllers.disruption.methods import (
        SingleNodeConsolidation,
    )

    ctx = _env("karpenter_tpu_torch", 40, seed=5, pods_per_node=(3,),
               pod_cpus=(10000,), pod_mems=(2048,), device=device)
    candidates = _candidates("karpenter_tpu_torch", ctx)
    return SingleNodeConsolidation(ctx), candidates, {"default": len(candidates)}


def test_prefetch_error_reraises_inline(cuda):
    """A submit error in the sweep's prefetch is swallowed there, and the
    same error raises at the chunk's inline solve: never a silent fallback
    to per-candidate solves."""
    from karpenter_tpu_torch import faults

    method, candidates, budgets = _single_sweep_env("cuda")
    assert len(candidates) > 16
    inj = faults.install(faults.FaultInjector(
        [faults.FaultRule(site=faults.SOLVER_SCENARIOS, after=1)]))
    try:
        with pytest.raises(faults.InjectedFault):
            method.compute_command(candidates, budgets)
    finally:
        faults.uninstall()
    assert inj.fired(faults.SOLVER_SCENARIOS) == 2  # the prefetch, then inline


_DRAIN_FAULT = """
import ctypes, torch
from karpenter_tpu_torch import _build
from karpenter_tpu_torch.controllers.disruption.helpers import ScenarioSimulator
from karpenter_tpu_torch.solver.workloads import build_consolidation_env

ctx, method, candidates, budgets = build_consolidation_env(64, "cuda")
sim = ScenarioSimulator(ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
                        encode_cache=ctx.encode_cache, solver_config=ctx.solver_config)
_build.library("pack"); _build.library("wire_pack"); _build.library("existing_feasibility")
ptr = _build.ptr
def bad(t):  # the scenario g_count [S, G]: an unmapped address for B4
    if t.dtype == torch.int32 and t.dim() == 2 and t.shape[0] == 8 and t.shape[1] == 1:
        return ctypes.c_void_p(16)
    return ptr(t)
_build.ptr = bad
try:
    sim.solve([candidates[:k] for k in (1, 2, 3)])
except Exception as exc:
    print("RAISED", type(exc).__name__, exc)
else:
    print("NOT RAISED")
"""


def test_kernel_fault_raises_by_the_drain(cuda):
    """A device fault inside a scenario dispatch (B4 reading an unmapped
    address) raises out of the solve, at the latest at collect_scenarios'
    drain. In a child process: the fault ends its CUDA context."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _DRAIN_FAULT], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert "RAISED" in proc.stdout and "NOT RAISED" not in proc.stdout, (
        proc.stdout[-2000:] + proc.stderr[-2000:])
    assert "illegal" in proc.stdout.lower() or "CUDA error" in proc.stdout


# -- B4 with domains ------------------------------------------------------------


def _spread_pods(n, cpu_m, app, key=labels.TOPOLOGY_ZONE, skew=1, gate_on=None):
    """Pods labelled ``app`` spreading over ``key``; with ``gate_on`` the
    constraint selects that app instead (a gate owner of its constraint)."""
    sel = LabelSelector(match_labels={"app": gate_on or app})
    return [
        Pod(
            metadata=ObjectMeta(name=f"{app}-{cpu_m}-{i}", labels={"app": app}),
            spec=PodSpec(
                requests={res.CPU: cpu_m, res.MEMORY: 2**30 * res.MILLI},
                topology_spread_constraints=[TopologySpreadConstraint(
                    max_skew=skew, topology_key=key,
                    when_unsatisfiable="DoNotSchedule", label_selector=sel)],
            ),
        )
        for i in range(n)
    ]


def _zone_affinity_pods(n, cpu_m, app):
    sel = LabelSelector(match_labels={"app": app})
    return [
        Pod(metadata=ObjectMeta(name=f"{app}-{i}", labels={"app": app}),
            spec=PodSpec(requests={res.CPU: cpu_m, res.MEMORY: 2**30 * res.MILLI},
                         pod_affinity=[PodAffinityTerm(topology_key=labels.TOPOLOGY_ZONE,
                                                       label_selector=sel)]))
        for i in range(n)
    ]


def _domain_snapshot(pods, n_types=30, n_nodes=0, prior_app=None):
    """``_snapshot`` with zoned state nodes whose every other node runs a
    pod labelled ``prior_app`` (topology priors)."""
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}
    nodes = example_state_nodes(n_nodes)
    client = Client(TestClock())
    for i, sn in enumerate(nodes):
        client.create(sn.node)
        if prior_app and i % 2 == 0:
            pod = Pod(metadata=ObjectMeta(name=f"prior-{i}", labels={"app": prior_app}),
                      spec=PodSpec(requests={res.CPU: 100}, node_name=sn.node.metadata.name))
            pod.status.phase = "Running"
            client.create(pod)
            sn.update_pod(pod, is_daemon=False)
    topo = Topology(client, nodes, pools, its, pods)
    solver = TorchSolver(pools, its, topo, state_nodes=nodes,
                         config=SolverConfig(device="cpu"))
    groups, rest = enc.partition_and_group(pods, topology=topo)
    assert not rest
    snap, avail, *_ = solver._encode_batch(groups)
    statics = solver._kernel_statics(snap, len(snap.groups))
    statics["nmax"] = solver._estimate_nmax(snap, solver._fit_matrix(snap))
    assert statics["has_domains"]
    return snap.solve_args(*avail), statics


_DOMAIN_CASES = {
    "zonal-spread": lambda: _domain_snapshot(
        _spread_pods(40, 1000, "zs") + _spread_pods(13, 2000, "zs2", skew=2)
        + _pods(30, 500)),
    "capacity-type-spread": lambda: _domain_snapshot(
        _spread_pods(17, 1000, "cs", key=labels.CAPACITY_TYPE_LABEL_KEY)),
    "zonal-affinity": lambda: _domain_snapshot(
        _zone_affinity_pods(9, 1000, "za") + _pods(12, 2000)),
    "gate-owner": lambda: _domain_snapshot(
        _spread_pods(9, 1000, "g") + _spread_pods(7, 2000, "other", gate_on="g")),
    "priors-on-zoned-nodes": lambda: _domain_snapshot(
        _spread_pods(120, 1000, "zp"), n_nodes=9, prior_app="zp"),
    "affinity-over-nodes": lambda: _domain_snapshot(
        _zone_affinity_pods(6, 1000, "zn"), n_nodes=5, prior_app=None),
    "constrained-mix": lambda: _domain_snapshot(constrained_mix(3000), n_types=60,
                                                n_nodes=12),
}


@pytest.mark.parametrize("case", sorted(_DOMAIN_CASES))
def test_domain_batches(cuda, case):
    """B4's domain machinery, one block, against pack_reference; the launch
    counts as a domain pack."""
    from karpenter_tpu_torch import _build

    args, statics = _DOMAIN_CASES[case]()
    _build.reset_launches()
    out = _kernels_equal_plain(args, statics, cuda)
    assert _build.launches["pack_domains"] == 1
    assert int(out[2]) > 0 or int(out[4].sum()) > 0


def test_domain_scenario_batch(cuda):
    """The scenario grid over a domain batch: g_dprior [S, G, V1] and dd0
    [S, JD, V1] carry seeded per-scenario priors (nonzero strides)."""
    args, statics = _DOMAIN_CASES["priors-on-zoned-nodes"]()
    a = _scenario_args(args, 8, 6, seed=5, batch_topo=True)
    rng = np.random.default_rng(5)
    i = enc.SOLVE_ARG_NAMES.index("g_dprior")
    a[i] = a[i] + rng.integers(0, 3, a[i].shape, dtype=np.int32)
    i = enc.SOLVE_ARG_NAMES.index("dd0")
    a[i] = a[i] + rng.integers(0, 2, a[i].shape, dtype=np.int32)
    _scenarios_equal_plain(a, statics, cuda, batch_topo=True)


# -- B8: the row-delta apply ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.float32])
@pytest.mark.parametrize("shape", [(5000,), (1024, 3), (256, 16, 4)])
def test_apply_rows(cuda, dtype, shape):
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.solve import delta_apply_rows, delta_apply_rows_reference

    g = torch.Generator().manual_seed(len(shape))
    if dtype == torch.bool:
        arr = torch.rand(shape, generator=g) < 0.5
        rows = torch.rand((70,) + shape[1:], generator=g) < 0.5
    else:
        arr = torch.randint(-99, 99, shape, generator=g).to(dtype)
        rows = torch.randint(-99, 99, (70,) + shape[1:], generator=g).to(dtype)
    idx = torch.randperm(shape[0], generator=g)[:69].to(torch.int32)
    idx = torch.cat([idx, idx[3:4]])  # a duplicate carrying the same row
    rows[69] = rows[3]
    plain = delta_apply_rows_reference(arr, idx, rows)
    old = arr.to(cuda)
    _build.reset_launches()
    kern = delta_apply_rows(old, idx.to(cuda), rows.to(cuda))
    torch.cuda.synchronize()
    assert _build.launches["apply_rows"] == 1
    assert kern.dtype == dtype and kern.data_ptr() != old.data_ptr()
    np.testing.assert_array_equal(kern.cpu().numpy(), plain.numpy())
    np.testing.assert_array_equal(old.cpu().numpy(), arr.numpy())  # untouched


def test_apply_rows_numpy_and_edge_indices(cuda):
    """numpy idx/rows are copied onto the card; a negative index counts
    from the end and one outside the rows is dropped, as in the plain
    version; the resident buffer is never written."""
    from karpenter_tpu_torch.ops.solve import delta_apply_rows, delta_apply_rows_reference

    arr = torch.arange(4000, dtype=torch.int32).reshape(1000, 4)
    idx = np.array([7, -1, 0, 1000, -1001], np.int32)
    rows = np.arange(-20, 0, dtype=np.int32).reshape(5, 4)
    want = delta_apply_rows_reference(arr, torch.from_numpy(idx), torch.from_numpy(rows))
    buf = arr.to(cuda)
    out = delta_apply_rows(buf, idx, rows)
    torch.cuda.synchronize()
    assert out.data_ptr() != buf.data_ptr()
    np.testing.assert_array_equal(out.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(buf.cpu().numpy(), arr.numpy())


def test_warm_churn_on_the_card(cuda):
    """Churn ticks of the constrained mix on the card ride row deltas
    through B8 and decide as the same ticks on the CPU."""
    import random

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.solver.driver import EncodeCache
    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick

    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(60)}

    def solve(pods, device, cache):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        s = TorchSolver(pools, its, topo, config=SolverConfig(device=device),
                        encode_cache=cache)
        r = s.solve(pods)
        sig = [(tuple(sorted(p.uid for p in c.pods)),
                 tuple(it.name for it in c.instance_type_options))
                for c in r.new_node_claims]
        return sig, s

    caches = {d: EncodeCache() for d in ("cuda", "cpu")}
    rng = random.Random(CHURN_SEED)
    pods = constrained_mix(2000)
    for device, cache in caches.items():
        solve(pods, device, cache)
        solve(pods, device, cache)
    b8 = 0
    for _ in range(3):
        pods = churn_tick(pods, constrained_mix, rng)
        _build.reset_launches()
        warm, s = solve(pods, "cuda", caches["cuda"])
        assert s.last_delta_rows > 0 and s.fallback_solves == 0
        assert _build.launches["pack_domains"] == 1
        b8 += _build.launches["apply_rows"]
        assert warm == solve(pods, "cpu", caches["cpu"])[0]
    assert b8 >= 3


# -- B5, the class-batched scan, and B4's contributor counting --------------------


def _scan_snapshot(pods, pools, its, n_nodes=0, nmax=None, nodes=None, **solver_kw):
    """The padded solve args, statics and class partition of ``pods`` over
    ``pools`` and the catalog ``its`` (and ``n_nodes`` example state nodes,
    or ``nodes``), encoded by the port."""
    its = {p.name: list(its) for p in pools}
    nodes = example_state_nodes(n_nodes) if nodes is None else nodes
    topo = Topology(Client(TestClock()), nodes, pools, its, pods)
    solver = TorchSolver(pools, its, topo, state_nodes=nodes,
                         config=SolverConfig(device="cpu"), **solver_kw)
    groups, rest = enc.partition_and_group(
        pods, topology=topo, merge_bootstrap_affinity=not solver.oracle.reserved_capacity_enabled)
    assert not rest
    snap, avail, *_ = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    N = enc._next_pow2(len(snap.existing_names), floor=1) if snap.existing_names else 0
    run = snap.padded(G, N)
    statics = solver._kernel_statics(snap, G)
    statics["nmax"] = nmax or solver._estimate_nmax(snap, solver._fit_matrix(snap))
    return run.solve_args(*avail), statics, enc.class_partition(run)


def _classed_snapshot(pods, n_types=30, n_nodes=0, nmax=None):
    """The padded solve args (G to the next power of two, as the driver
    pads them: padding classes), statics and class partition of ``pods``
    over ``n_nodes`` zoned state nodes, encoded by the port."""
    return _scan_snapshot(pods, [example_nodepool()], corpus.generate(n_types), n_nodes, nmax)


def _classed_equal_plain(args, statics, classes, cuda):
    """B5 against pack_classed_reference: every PackState field, the fills
    and unplaced; then the wire-packed classed solve. One B5 launch, no
    B4 launch."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import packing as tp
    from karpenter_tpu_torch.ops.solve import (
        _feasibility_tables, pack_args, solve_core_classed,
    )

    *arrs, lmax = classes
    st = dict(nmax=statics["nmax"], zone_kid=statics["zone_kid"], ct_kid=statics["ct_kid"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"],
              wf_iters=statics["wf_iters"])
    outs = []
    for dev in ("cpu", cuda):
        a = dict(zip(enc.SOLVE_ARG_NAMES, to_device_args(args, dev)))
        cls = [torch.from_numpy(np.asarray(x)).to(dev) for x in arrs]
        _build.reset_launches()
        scan = tp.pack_classed(
            *pack_args(a, *_feasibility_tables(a, st["zone_kid"], st["ct_kid"])),
            *cls, lmax=lmax, **st)
        full = solve_core_classed(*a.values(), *cls, lmax=lmax, **dict(
            statics, sparse_groups=True))
        outs.append((scan, wire_pack(full, torch.int32)))
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
            assert _build.launches["pack_classed"] == 2 and _build.launches["pack"] == 0
    ((ps, *pf), pw), ((ks, *kf), kw) = outs
    for f in tp.PackState._fields:
        np.testing.assert_array_equal(getattr(ks, f).cpu().numpy(), getattr(ps, f).numpy(),
                                      err_msg=f)
    for i, (k, p) in enumerate(zip(kf, pf)):
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"fills {i}")
    for i, (k, p) in enumerate(zip(kw, pw)):
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"wire {i}")
    return ps, pf


def _zoned_nodes_classes():
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix

    return _classed_snapshot(diverse_reference_mix(300), n_nodes=9)


_CLASSED_CASES = {
    # zone-dynamic classes, hostname and domain contributor rows, padding
    "diverse-600": lambda: _classed_snapshot(_diverse(600), n_types=40),
    "diverse-nodes": _zoned_nodes_classes,
    "diverse-overflow": lambda: _classed_snapshot(_diverse(300), nmax=8),
    # a zone-dynamic class and a capacity-type-dynamic class
    "mixed-axes": lambda: _classed_snapshot(
        _spread_pods(20, 500, "za") + _spread_pods(20, 500, "cb",
                                                   key=labels.CAPACITY_TYPE_LABEL_KEY)),
    # one shared hostname target across classes
    "anti-affinity": lambda: _classed_snapshot(
        _pods(12, 100, "anti", anti=True) + _pods(12, 200, "anti", anti=True)
        + _pods(12, 300, "anti", anti=True)),
    "zonal-affinity": lambda: _classed_snapshot(
        _zone_affinity_pods(10, 100, "za") + _zone_affinity_pods(10, 200, "za")),
    "domain-free": lambda: _classed_snapshot(mixed_pods(1000), n_nodes=5),
}


def _diverse(n):
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix

    return diverse_reference_mix(n)


@pytest.mark.parametrize("case", sorted(_CLASSED_CASES))
def test_classed_batches(cuda, case):
    """B5 equals its plain version on class batches: domains on each axis,
    contributors, existing nodes, overflow, a domain-free batch."""
    args, statics, classes = _CLASSED_CASES[case]()
    ps, _ = _classed_equal_plain(args, statics, classes, cuda)
    if case == "diverse-overflow":
        assert bool(ps.overflow)
    if case.startswith("diverse"):
        assert statics["has_contrib"] and statics["has_domains"]
        assert (classes[1] == 0).any()
    if case == "mixed-axes":
        cl = classes[1]
        assert sorted(classes[3][cl > 0].tolist()) == [0, 1]
    assert int(ps.n_open) > 0


@pytest.mark.parametrize("n_nodes", [0, 9])
def test_pack_contrib(cuda, n_nodes):
    """B4 with contributor counting (classed off) against pack_reference,
    one block; counted as a contributor pack."""
    from karpenter_tpu_torch import _build

    args, statics, _ = _classed_snapshot(_diverse(300), n_nodes=n_nodes)
    assert statics["has_contrib"]
    _build.reset_launches()
    _kernels_equal_plain(args, statics, cuda)
    assert _build.launches["pack_contrib"] == 1 and _build.launches["pack_classed"] == 0


def test_pack_contrib_scenario_grid(cuda):
    """The scenario grid over a contributor batch: nhc, ch_cnt and ddc per
    scenario, with per-scenario priors."""
    args, statics, _ = _classed_snapshot(_diverse(200), n_nodes=9)
    assert statics["has_contrib"]
    _scenarios_equal_plain(_scenario_args(args, 8, 6, seed=9, batch_topo=True), statics,
                           cuda, batch_topo=True)


def test_diverse_solve_matches_cpu(cuda):
    """diverse_reference_mix(1000) x 400 through TorchSolver: the classed
    route on the card decides as on the CPU; one B5 launch per solve."""
    from karpenter_tpu_torch import _build

    pods = _diverse(1000)
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(400)}

    def solve(device):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        s = TorchSolver(pools, its, topo, config=SolverConfig(device=device))
        r = s.solve(pods)
        return slots(r), sorted(r.pod_errors)

    _build.reset_launches()
    got = solve("cuda")
    assert _build.launches["pack_classed"] >= 1 and _build.launches["pack"] == 0
    assert got == solve("cpu") and got[0]


# -- B3, the dense tables, and B9, the relaxation bulk's rounding ---------------

_B3 = _B1[:17]  # the dense fresh table takes no live-pair index
_B3E = _B2[:9] + ("well_known",)


@pytest.mark.parametrize("case", ["example-64", "example-1000", "nodes-5", "one-group"])
def test_dense_tables(cuda, case):
    """B3's fresh and existing entries against their plain versions and
    against B1's / B2's tables on the same inputs, each entry counted on
    its own; at the example shapes, over existing nodes, and at G = 1."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas

    if case.startswith("example"):
        n = int(case.split("-")[1])
        args, statics = example_snapshot_arrays(n, 16 if n < 100 else 60, 4 if n < 100 else 25)
    elif case == "nodes-5":
        args, statics = _snapshot(mixed_pods(300), n_types=30, n_nodes=5)
    else:
        args, statics = _snapshot(_pods(40, 500), n_types=30, n_nodes=3)
    a = dict(zip(enc.SOLVE_ARG_NAMES, to_device_args(args, cuda)))
    c = dict(zip(enc.SOLVE_ARG_NAMES, to_device_args(args, "cpu")))
    if case == "one-group":
        assert a["g_mask"].shape[0] == 1
    kw = dict(zone_kid=statics["zone_kid"], ct_kid=statics["ct_kid"])
    _build.reset_launches()
    kern = feas.fresh_claim_feasibility(*(a[n] for n in _B3), **kw)
    assert _build.launches["dense_fresh"] == 1 and _build.launches["dense_existing"] == 0
    plain = feas.fresh_claim_feasibility_reference(*(c[n] for n in _B3), **kw)
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in _B1), **kw)
    for i, (k, p, s) in enumerate(zip(kern, plain, b1)):
        assert k.dtype == p.dtype == s.dtype and k.shape == p.shape == s.shape, i
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"output {i}")
        np.testing.assert_array_equal(k.cpu().numpy(), s.cpu().numpy(), err_msg=f"B1 {i}")
    assert plain[1].any()
    if a["n_avail"].shape[0]:
        cap = feas.existing_node_feasibility(*(a[n] for n in _B3E))
        assert _build.launches["dense_existing"] == 1
        np.testing.assert_array_equal(
            cap.cpu().numpy(), feas.existing_node_feasibility_reference(*(c[n] for n in _B3E)).numpy())
        np.testing.assert_array_equal(
            cap.cpu().numpy(), feas.existing_node_feasibility_sparse(*(a[n] for n in _B2)).cpu().numpy())
        assert int(cap.max()) > 0


def test_dense_route_solve_core(cuda):
    """solve_core(sparse_groups=False) on the card: B3 in place of B1/B2,
    equal to the plain dense route and to the sparse route."""
    args, statics = _snapshot(mixed_pods(400), n_types=30, n_nodes=8)
    dense = _kernels_equal_plain(args, dict(statics, sparse_groups=False), cuda)
    sparse = _kernels_equal_plain(args, dict(statics, sparse_groups=True), cuda)
    for i, (d, s) in enumerate(zip(dense, sparse)):
        np.testing.assert_array_equal(d.numpy(), s.numpy(), err_msg=f"output {i}")


def _fill_inputs(seed, GE, NR, T, P=3, CRp=4):
    """Seeded relax_fill inputs (ge, cl, type_ok, n_fit, n_r): infeasible
    rows (n_per 0), padding groups and slots (slots past n_r), n_per =
    2**30 and a window past int32, slots reading every table row."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    ge = np.stack([
        rng.integers(0, 60, GE), rng.integers(0, 200, GE),
        rng.integers(0, max(NR, 1), GE), rng.integers(1, 40, GE), rng.integers(0, 6, GE),
    ]).astype(i32)
    if GE >= 8:
        ge[0, -2:] = 0
        ge[1, 3] = 2**31 - 20
        ge[3, [1, 5]] = 0
        ge[3, [2, 6, 7]] = 2**30
        ge[4, 6] = 3
    cl = np.stack([rng.integers(0, P, NR), rng.integers(0, 50, NR),
                   rng.integers(0, CRp, NR)]).astype(i32)
    n_r = NR
    if NR >= 8:
        cl[1, -5:] = 0
        n_r = NR - 5
    type_ok = rng.random((P, CRp, T)) < 0.7
    n_fit = rng.integers(0, 60, (P, CRp, T)).astype(i32)
    return ge, cl, type_ok, n_fit, n_r


@pytest.mark.parametrize("GE,NR,T", [(12, 64, 20), (1, 1024, 400), (1, 1, 1), (16, 8, 0),
                                     (3, 5, 7)])
def test_relax_fill(cuda, GE, NR, T):
    """B9 against its plain version on every lane, edge rows included, in
    one launch."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.relax import relax_fill, relax_fill_reference

    *host, n_r = _fill_inputs(GE + NR, GE, NR, T)
    _build.reset_launches()
    kern = relax_fill(*(torch.from_numpy(x).to(cuda) for x in host), n_r)
    torch.cuda.synchronize()
    assert _build.launches["relax_fill"] == 1
    plain = relax_fill_reference(*(torch.from_numpy(x) for x in host), n_r)
    for i, (k, p) in enumerate(zip(kern, plain)):
        assert k.dtype == p.dtype and k.shape == p.shape, i
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"output {i}")


def _zonal_partial(n_easy, n_solo):
    """chip_smoke phase 7c's zonal partial mix at a small size."""
    zones = ("test-zone-a", "test-zone-b", "test-zone-c")
    lbl = {"app": "solo"}
    sel = LabelSelector(match_labels=lbl)

    def pod(name, cpu_m, zone, own=None):
        return Pod(
            metadata=ObjectMeta(name=name, labels=own or {}),
            spec=PodSpec(
                requests={res.CPU: cpu_m, res.MEMORY: 2**30 * res.MILLI},
                node_selector={labels.TOPOLOGY_ZONE: zone},
                pod_anti_affinity=[PodAffinityTerm(topology_key=labels.HOSTNAME,
                                                   label_selector=sel)] if own else None,
            ),
        )

    pods = [pod(f"z-{i}", (1 + i % 3) * 500, zones[i % 3]) for i in range(n_easy)]
    pods += [pod(f"solo-{i}", 700, zones[1], own=lbl) for i in range(n_solo)]
    return pods


def test_relax_solve_matches_cpu(cuda):
    """TorchSolver's default route on the card: the zonal partial mix
    relax-routed through B3 and B9, the claims equal to the CPU run's in
    slot order, with equal relax telemetry."""
    from karpenter_tpu_torch import _build

    pods = _zonal_partial(1200, 40)
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(60)}

    def solve(device):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        s = TorchSolver(pools, its, topo, config=SolverConfig(device=device))
        r = s.solve(pods)
        return ([(tuple(sorted(p.metadata.name for p in c.pods)),
                  tuple(it.name for it in c.instance_type_options))
                 for c in r.new_node_claims], sorted(r.pod_errors),
                (s.last_relax_pods, s.last_relax_claims, s.last_relax_residual_pods,
                 s.relax_rejects))

    _build.reset_launches()
    got = solve("cuda")
    assert _build.launches["dense_fresh"] == 1 and _build.launches["relax_fill"] == 1
    assert got == solve("cpu")
    assert got[2][0] == 800 and got[2][3] == 0


# -- minValues floors and the reservation ledger (B4, B5, B7) --------------------


def _mv_pools():
    from karpenter_tpu_torch.solver.example import minvalues_nodepool

    return [minvalues_nodepool()]


_MV_CASES = {
    "mixed": lambda: (mixed_pods(1500, gpu_fraction=0.0), 30, 0),
    "cap-binds": lambda: (_pods(200, 250), 20, 0),
    "constrained": lambda: (constrained_mix(1000), 30, 0),
    "constrained-nodes": lambda: (constrained_mix(600), 30, 9),
    "nodes": lambda: (mixed_pods(800, gpu_fraction=0.0), 30, 12),
}


@pytest.mark.parametrize("case", sorted(_MV_CASES))
def test_pack_minvalues(cuda, case):
    """B4 with minValues floors (instance-family Exists, minValues 2)
    against pack_reference, one block; counted as a minValues pack."""
    from karpenter_tpu_torch import _build

    pods, n_types, n_nodes = _MV_CASES[case]()
    args, statics, _ = _scan_snapshot(pods, _mv_pools(), corpus.generate(n_types), n_nodes)
    assert np.asarray(args[enc.SOLVE_ARG_NAMES.index("p_mvmin")]).any()
    _build.reset_launches()
    out = _kernels_equal_plain(args, statics, cuda)
    assert _build.launches["pack_minvalues"] == 1 and _build.launches["pack_resv"] == 0
    assert int(out[2]) > 0


def _reserved(n_types, every, capacity, zones=("test-zone-a",)):
    from karpenter_tpu_torch.solver.example import reserved_catalog

    return reserved_catalog(n_types, every=every, capacity=capacity, zones=zones)


_RESV_CASES = {
    # one reservation of capacity 1: the first bulk drains it
    "drain": lambda: (_pods(8, 1000), [example_nodepool()], _reserved(4, 4, 1), 0),
    "mixed": lambda: (mixed_pods(1500, gpu_fraction=0.0), [example_nodepool()],
                      _reserved(40, 5, 3), 0),
    "pinned": lambda: (constrained_mix(1000), [example_nodepool()],
                       _reserved(30, 4, 2, ("test-zone-a", "test-zone-c")), 0),
    "nodes": lambda: (mixed_pods(800, gpu_fraction=0.0), [example_nodepool()],
                      _reserved(30, 3, 4), 12),
    "with-minvalues": lambda: (mixed_pods(800, gpu_fraction=0.0), _mv_pools(),
                               _reserved(30, 4, 2), 0),
}


@pytest.mark.parametrize("case", sorted(_RESV_CASES))
def test_pack_reservations(cuda, case):
    """B4 with a reservation ledger against pack_reference, one block:
    c_resv among the outputs; counted as a ledger pack."""
    from karpenter_tpu_torch import _build

    pods, pools, its, n_nodes = _RESV_CASES[case]()
    args, statics, _ = _scan_snapshot(pods, pools, its, n_nodes, reserved_capacity_enabled=True)
    assert np.asarray(args[enc.SOLVE_ARG_NAMES.index("res_cap0")]).shape[0] > 0
    _build.reset_launches()
    out = _kernels_equal_plain(args, statics, cuda)
    assert _build.launches["pack_resv"] == 1
    assert _build.launches["pack_minvalues"] == (case == "with-minvalues")
    assert out[9].any()


@pytest.mark.parametrize("case", ["minvalues", "reservations"])
def test_scenario_grid_minvalues_reservations(cuda, case):
    """The scenario grid (B7) over minValues floors and over a reservation
    ledger: every scenario replays res_cap0 from the start."""
    if case == "minvalues":
        args, statics, _ = _scan_snapshot(mixed_pods(800, gpu_fraction=0.0), _mv_pools(),
                                          corpus.generate(30), 9)
    else:
        args, statics, _ = _scan_snapshot(mixed_pods(800, gpu_fraction=0.0),
                                          [example_nodepool()], _reserved(30, 3, 3), 9,
                                          reserved_capacity_enabled=True)
    out = _scenarios_equal_plain(_scenario_args(args, 8, 6, seed=11), statics, cuda)
    assert int(out[2].max()) > 0


_CLASSED_MV_CASES = {
    "diverse": lambda: (_diverse(300), 30, 0, None),
    "diverse-nodes": lambda: (_diverse(200), 30, 6, None),
    "diverse-overflow": lambda: (_diverse(200), 30, 0, 8),
    "mixed-domain-free": lambda: (mixed_pods(600, gpu_fraction=0.0), 30, 0, None),
}


@pytest.mark.parametrize("case", sorted(_CLASSED_MV_CASES))
def test_classed_minvalues(cuda, case):
    """B5 with minValues floors against pack_classed_reference: every
    PackState field, the fills, the wire-packed solve; counted as a
    minValues class-batched scan."""
    from karpenter_tpu_torch import _build

    pods, n_types, n_nodes, nmax = _CLASSED_MV_CASES[case]()
    args, statics, classes = _scan_snapshot(pods, _mv_pools(), corpus.generate(n_types),
                                            n_nodes, nmax=nmax)
    _classed_equal_plain(args, statics, classes, cuda)
    assert _build.launches["pack_classed_minvalues"] == 2


def test_minvalues_and_reservations_solve_match_cpu(cuda):
    """TorchSolver on the card against the CPU: mixed 3,000 x 60 over the
    minValues pool, then over a reservation catalog (default mode): the
    claims in slot order and the reservations each claim holds."""
    from karpenter_tpu_torch import _build

    def solve(device, pools, its, **kw):
        its = {p.name: list(its) for p in pools}
        pods = mixed_pods(3000, gpu_fraction=0.0)
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        s = TorchSolver(pools, its, topo, config=SolverConfig(device=device), **kw)
        r = s.solve(pods)
        return (slots(r), sorted(r.pod_errors),
                [sorted(o.reservation_id() for o in c.reserved_offerings)
                 for c in r.new_node_claims])

    _build.reset_launches()
    got = solve("cuda", _mv_pools(), corpus.generate(60))
    assert _build.launches["pack_minvalues"] >= 1
    assert got == solve("cpu", _mv_pools(), corpus.generate(60)) and got[0]
    its = _reserved(60, 5, 10)
    _build.reset_launches()
    got = solve("cuda", [example_nodepool()], its, reserved_capacity_enabled=True)
    assert _build.launches["pack_resv"] >= 1
    assert got == solve("cpu", [example_nodepool()], _reserved(60, 5, 10),
                        reserved_capacity_enabled=True)
    assert any(got[2])


# -- the tiled mode (tile_feasibility): per-step rows in B4, B5 and B7 ------------


def _tiled(statics):
    return dict(statics, tile_feasibility=True, sparse_groups=False)


def _tiled_equal_plain(args, statics, cuda):
    """The tiled solve on the card against its plain version (pack_reference
    with tile_feasibility) and against the untiled kernels: every output.
    One tiled B4 launch and no table launch (B1, B2, B3)."""
    from karpenter_tpu_torch import _build

    _build.reset_launches()
    out = _kernels_equal_plain(args, _tiled(statics), cuda)
    assert _build.launches["pack_tiled"] == 1 and _build.launches["pack"] == 1
    assert not any(_build.launches[k] for k in (
        "fresh_feasibility", "existing_feasibility", "dense_feasibility"))
    untiled = solve_core(*to_device_args(args, cuda), **dict(statics, sparse_groups=True))
    for i, (u, p) in enumerate(zip(untiled, out)):
        np.testing.assert_array_equal(u.cpu().numpy(), p.numpy(), err_msg=f"untiled {i}")
    return out


_TILED_CASES = {
    "example-200": lambda: _snapshot(example_pods(200, 8), n_types=40),
    # N > 0: the cap row (strict node compatibility, n_tol)
    "nodes-9": lambda: _snapshot(mixed_pods(600), n_types=30, n_nodes=9),
    "limits": lambda: _snapshot(mixed_pods(800), pools=[_pool("heavy", 80, "12"),
                                                         _pool("light", 20)], n_types=30),
    "domains": lambda: _DOMAIN_CASES["priors-on-zoned-nodes"](),
    "minvalues": lambda: _scan_snapshot(mixed_pods(400, gpu_fraction=0.0), _mv_pools(),
                                        corpus.generate(30))[:2],
    "ledger": lambda: _scan_snapshot(mixed_pods(400, gpu_fraction=0.0), [example_nodepool()],
                                     _reserved(40, 5, 3), reserved_capacity_enabled=True)[:2],
}


@pytest.mark.parametrize("case", sorted(_TILED_CASES))
def test_tiled_pack(cuda, case):
    """B4 in the tiled mode: == its plain version and == the untiled B4."""
    args, statics = _TILED_CASES[case]()
    out = _tiled_equal_plain(args, statics, cuda)
    assert int(out[2]) > 0 or int(out[4].sum()) > 0


@pytest.mark.parametrize("n_nodes", [0, 9])
def test_tiled_classed(cuda, n_nodes):
    """B5 in the tiled mode (one row build per class head): every field of
    the final state and the fills == pack_classed_reference tiled, and the
    wire-packed solve == the untiled B5's."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.solve import solve_core_classed
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix

    args, statics, classes = _classed_snapshot(diverse_reference_mix(300), n_nodes=n_nodes)
    *arrs, lmax = classes
    outs = []
    for dev, st in (("cpu", _tiled(statics)), (cuda, _tiled(statics)),
                    (cuda, dict(statics, sparse_groups=True))):
        a = to_device_args(args, dev)
        cls = [torch.from_numpy(np.asarray(x)).to(dev) for x in arrs]
        _build.reset_launches()
        outs.append(wire_pack(solve_core_classed(*a, *cls, lmax=lmax, **st), torch.int32))
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
            tiled = st["tile_feasibility"]
            assert _build.launches["pack_classed"] == 1
            assert _build.launches["pack_classed_tiled"] == int(tiled)
            assert _build.launches["fresh_feasibility"] == int(not tiled)
    plain, kern, untiled = outs
    for i, (k, p, u) in enumerate(zip(kern, plain, untiled)):
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"output {i}")
        np.testing.assert_array_equal(u.cpu().numpy(), p.numpy(), err_msg=f"untiled {i}")
    assert int(plain[2]) > 0


@pytest.mark.parametrize("S,real", [(8, 5), (16, 11)])
def test_tiled_scenario_grid(cuda, S, real):
    """B7 in the tiled mode: S blocks, each building its rows with its own
    n_tol slice (seeded removed nodes), == the plain scenario solve tiled
    and == the untiled grid."""
    from karpenter_tpu_torch import _build

    args, statics = _snapshot(mixed_pods(1500), n_types=30, n_nodes=33)
    a = _scenario_args(args, S, real, seed=S + real)
    kw = dict(_tiled(statics), fills_dtype=torch.int32, batch_topo=False)
    plain = solve_scenarios_core_packed(*to_device_args(a, "cpu"), **kw)
    _build.reset_launches()
    kern = solve_scenarios_core_packed(*to_device_args(a, cuda), **kw)
    torch.cuda.synchronize()
    assert _build.scenario_launches["pack_tiled"] == 1
    assert _build.launches["existing_feasibility"] == _build.launches["fresh_feasibility"] == 0
    untiled = solve_scenarios_core_packed(*to_device_args(a, cuda), **dict(
        kw, tile_feasibility=False, sparse_groups=True))
    for i, (k, p, u) in enumerate(zip(kern, plain, untiled)):
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"output {i}")
        np.testing.assert_array_equal(u.cpu().numpy(), p.numpy(), err_msg=f"untiled {i}")
    assert int(plain[4].sum()) > 0 and int(plain[2].max()) > 0


# -- B4's live extent and thread-block cluster, B7's grid of clusters -------------


_WIDE_CASES = {
    "free": lambda: _snapshot(mixed_pods(400), n_types=30, n_nodes=3),
    "domains": lambda: _DOMAIN_CASES["priors-on-zoned-nodes"](),
    "contrib": lambda: _classed_snapshot(_diverse(300))[:2],
    "minvalues": lambda: _scan_snapshot(mixed_pods(400, gpu_fraction=0.0), _mv_pools(),
                                        corpus.generate(30))[:2],
    "ledger": lambda: _scan_snapshot(mixed_pods(400, gpu_fraction=0.0), [example_nodepool()],
                                     _reserved(40, 5, 3), reserved_capacity_enabled=True)[:2],
    "tiled": lambda: (lambda a, st: (a, _tiled(st)))(
        *_snapshot(mixed_pods(400), n_types=30, n_nodes=3)),
}


@pytest.mark.parametrize("case", sorted(_WIDE_CASES))
def test_pack_nmax_far_past_the_claims(cuda, case):
    """B4 with NMAX at least 8x the claims it opens, on each of its paths:
    the claim-axis phases walk only the open claims, and every output,
    the columns past them included, equals pack_reference."""
    args, statics = _WIDE_CASES[case]()
    n_open = int(solve_core(*to_device_args(args, "cpu"), **statics)[2])
    assert n_open > 0
    nmax = 1 << (8 * n_open - 1).bit_length()
    out = _kernels_equal_plain(args, dict(statics, nmax=nmax), cuda)
    assert int(out[2]) == n_open and not bool(out[3])


def test_pack_overflow_boundary(cuda):
    """B4 at the overflow boundary: NMAX one below the claims the batch
    opens overflows and NMAX at the claims does not, each equal to
    pack_reference; through the driver, the doubling retry (fresh zeroed
    outputs) decides as the CPU."""
    args, statics = _snapshot(mixed_pods(400), n_types=30)
    n_open = int(solve_core(*to_device_args(args, "cpu"), **statics)[2])
    assert bool(_kernels_equal_plain(args, dict(statics, nmax=n_open - 1), cuda)[3])
    assert not bool(_kernels_equal_plain(args, dict(statics, nmax=n_open), cuda)[3])

    def solve(device):
        pods = mixed_pods(400)
        pools = [example_nodepool()]
        its = {pools[0].name: corpus.generate(30)}
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        solver = TorchSolver(pools, its, topo, config=SolverConfig(
            device=device, max_claims=n_open - 1, relax=False))
        return slots(solver.solve(pods)), solver.last_dispatches

    got = solve("cuda")
    assert got == solve("cpu") and got[1] == 2


def test_scenario_grid_of_clusters(cuda):
    """B7 at S=16, one cluster per scenario: every scenario of the grid
    equals that scenario solved alone on the card, and the plain
    scenario solve."""
    from karpenter_tpu_torch.ops.solve import solve_core_packed

    args, statics = _snapshot(mixed_pods(1500), n_types=30, n_nodes=33)
    a = _scenario_args(args, 16, 16, seed=29)
    _scenarios_equal_plain(a, statics, cuda)
    grid = solve_scenarios_core_packed(*to_device_args(a, cuda), **dict(
        statics, fills_dtype=torch.int32, batch_topo=False))
    gi, ti = enc.SOLVE_ARG_NAMES.index("g_count"), enc.SOLVE_ARG_NAMES.index("n_tol")
    for si in range(16):
        one = list(a)
        one[gi], one[ti] = a[gi][si], a[ti][si]
        alone = solve_core_packed(*to_device_args(one, cuda), **dict(
            statics, fills_dtype=torch.int32))
        for i, (g, s) in enumerate(zip(grid, alone)):
            np.testing.assert_array_equal(g[si].cpu().numpy(), s.cpu().numpy(),
                                          err_msg=f"scenario {si} output {i}")


@pytest.mark.parametrize("S", [64, 160])
def test_scenario_grid_narrows_its_cluster(cuda, S):
    """B7 over more scenarios than the card holds clusters of 8: the
    launch takes a cluster of which all S fit at once (single blocks past
    the SMs), and the grid equals the plain scenario solve; a single
    solve keeps the cluster of 8."""
    from karpenter_tpu_torch.ops import packing
    from karpenter_tpu_torch.ops.solve import solve_core_packed

    args, statics = _snapshot(mixed_pods(300), n_types=30, n_nodes=9)
    packing.clusters.clear()
    _scenarios_equal_plain(_scenario_args(args, S, S, seed=31), statics, cuda)
    c, fit, fit8 = packing.clusters[S]
    assert c in (1, 2, 4, 8) and fit8 >= 1
    assert fit >= S or c == 1
    assert c == 8 or fit8 < S
    solve_core_packed(*to_device_args(args, cuda), **dict(statics, fills_dtype=torch.int32))
    assert packing.clusters[1][0] == 8


# -- B5's live extent, its class head and its cluster ----------------------------


def _tenant_classes(n_tenants, n_deployments, n_types=24, nmax=None):
    """Tenant Deployments over tainted, limited NodePools (the tenant
    cell's shape: solver/example.py), encoded by the port with the class
    partition forced."""
    from karpenter_tpu_torch.solver.example import tenant_pods, tenant_pools

    return _scan_snapshot(tenant_pods(n_deployments, n_tenants), tenant_pools(n_tenants),
                          corpus.generate(n_types), nmax=nmax)


def _zone_pods(n, cpu_m, zone):
    return [Pod(metadata=ObjectMeta(name=f"{zone}-{cpu_m}-{i}"),
                spec=PodSpec(requests={res.CPU: cpu_m, res.MEMORY: 2**30 * res.MILLI},
                             node_selector={labels.TOPOLOGY_ZONE: zone}))
            for i in range(n)]


def _b5_equal_plain(args, statics, classes, cuda, tiled=False, launches=1):
    """B5 on the card ``launches`` times back to back at one NMAX against
    pack_classed_reference on the same inputs (``tiled``: both building
    each class head's rows): every PackState field and the fills, each
    launch. Returns the plain outputs and the cluster the launches took
    (ops/packing.py:classed_clusters)."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import packing as tp
    from karpenter_tpu_torch.ops.solve import _feasibility_tables, pack_args

    *arrs, lmax = classes
    st = dict(nmax=statics["nmax"], lmax=lmax, zone_kid=statics["zone_kid"],
              ct_kid=statics["ct_kid"], has_domains=statics["has_domains"],
              has_contrib=statics["has_contrib"], wf_iters=statics["wf_iters"],
              tile_feasibility=tiled)

    def inputs(dev):
        a = dict(zip(enc.SOLVE_ARG_NAMES, to_device_args(args, dev)))
        cls = [torch.from_numpy(np.asarray(x)).to(dev) for x in arrs]
        return pack_args(a, *_feasibility_tables(a, st["zone_kid"], st["ct_kid"],
                                                 tile_feasibility=tiled)) + cls

    ps, *pf = plain = tp.pack_classed(*inputs("cpu"), **st)
    x = inputs(cuda)
    tp.classed_clusters.clear()
    _build.reset_launches()
    for k in range(launches):
        ks, *kf = tp.pack_classed(*x, **st)
        torch.cuda.synchronize()
        for f in tp.PackState._fields:
            np.testing.assert_array_equal(getattr(ks, f).cpu().numpy(), getattr(ps, f).numpy(),
                                          err_msg=f"launch {k}: {f}")
        for i, (kk, p) in enumerate(zip(kf, pf)):
            np.testing.assert_array_equal(kk.cpu().numpy(), p.numpy(),
                                          err_msg=f"launch {k}: fills {i}")
        del ks, kf
    assert _build.launches["pack_classed"] == launches
    assert _build.launches["pack_classed_tiled"] == launches * int(tiled)
    return plain, tp.classed_clusters["pack_classed"]


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
def test_classed_tenant_pools(cuda, tiled):
    """B5 over 8 tainted tenant pools x 80 VPA-sized Deployments, each its
    own class, so every class head sees the claims of 7 pools that cannot
    take it (no type walk for them): == its plain version, untiled and
    tiled, launched as one cluster of the kernel's width."""
    args, statics, classes = _tenant_classes(8, 80)
    (ps, *_), cluster = _b5_equal_plain(args, statics, classes, cuda, tiled=tiled)
    n = int(ps.n_open)
    assert n > 0 and len(set(ps.c_pool[:n].tolist())) == 8
    assert cluster[0] == 8 and cluster[2] >= 1


@pytest.mark.parametrize("case", ["other-pool", "zone-clash"])
def test_classed_head_finds_no_claim(cuda, case):
    """A class whose head finds no open claim it can take: the second
    tenant's Deployment after the first's claims (their template does not
    tolerate it), or a zone-b class after zone-a claims (their zone keys
    clash). == its plain version; the class opens claims of its own."""
    if case == "other-pool":
        args, statics, classes = _tenant_classes(2, 2)
    else:
        args, statics, classes = _scan_snapshot(
            _zone_pods(12, 2000, "test-zone-a") + _zone_pods(12, 1000, "test-zone-b"),
            [example_nodepool()], corpus.generate(30))
    assert int((classes[1] > 0).sum()) == 2
    (ps, *_), _ = _b5_equal_plain(args, statics, classes, cuda)
    n = int(ps.n_open)
    if case == "other-pool":
        assert sorted(set(ps.c_pool[:n].tolist())) == [0, 1]
    else:
        zone_kid = statics["zone_kid"]
        zones = ps.c_mask[:n, zone_kid].numpy()
        assert (zones.sum(1) == 1).all() and len({z.argmax() for z in zones}) == 2


def test_classed_overflow_doubled(cuda):
    """The multi-pool batch at an NMAX it overflows, then at each doubling
    until it does not (the driver's retry): each launch == its plain
    version at that NMAX."""
    args, statics, classes = _tenant_classes(8, 80, nmax=8)
    while True:
        (ps, *_), _ = _b5_equal_plain(args, statics, classes, cuda)
        if not bool(ps.overflow):
            break
        statics = dict(statics, nmax=statics["nmax"] * 2)
    assert statics["nmax"] > 8 and int(ps.n_open) > 8


def test_classed_back_to_back_dirty_scratch(cuda, monkeypatch):
    """Two B5 launches back to back at one NMAX (the caching allocator
    hands the second the first's head scratch), then two more with every
    CUDA buffer torch.empty allocates filled with junk first: each == its
    plain version. No reader looks past the open claims, or at the head
    rows of a claim the class cannot take."""
    args, statics, classes = _tenant_classes(8, 80)
    for tiled in (False, True):
        _b5_equal_plain(args, statics, classes, cuda, tiled=tiled, launches=2)
    _junk_empty(monkeypatch)
    for tiled in (False, True):
        _b5_equal_plain(args, statics, classes, cuda, tiled=tiled, launches=2)


# -- B8 in one launch, on its edge cases ------------------------------------------


def b8_case(case, rng):
    """(arr, idx int32, rows) numpy arrays of one edge case of the row
    apply (also held against JAX in tests/test_torch_live_extent.py)."""
    if case == "ragged-rows":  # 15-byte rows: block ranges off 16-byte alignment
        arr, rows = rng.random((9001, 3, 5)) < 0.5, rng.random((400, 3, 5)) < 0.5
        idx = rng.choice(9001, 400, replace=False)
    elif case == "uneven-blocks":  # rows that the blocks' share does not divide
        arr = rng.integers(-99, 99, (5003, 7)).astype(np.int32)
        rows = rng.integers(-99, 99, (333, 7)).astype(np.int32)
        idx = rng.choice(5003, 333, replace=False)
    elif case == "every-row":  # n_delta == n_rows, past one chunk of indices
        arr = rng.random((4099, 16)).astype(np.float32)
        rows = rng.random((4099, 16)).astype(np.float32)
        idx = rng.permutation(4099)
    else:  # duplicates, negatives and indices outside the rows
        arr = rng.integers(-99, 99, (64, 4)).astype(np.int32)
        rows = rng.integers(-99, 99, (9, 4)).astype(np.int32)
        idx = np.array([5, 5, -1, -64, 64, -65, 1000, 0, 63])
        # a duplicate carries its row twice: 5 and 5, -64 and 0, -1 and 63
        rows[1], rows[7], rows[8] = rows[0], rows[3], rows[2]
    return arr, idx.astype(np.int32), rows


@pytest.mark.parametrize("case", ["ragged-rows", "uneven-blocks", "every-row", "edge-indices"])
def test_apply_rows_one_launch(cuda, case):
    """B8 writes the whole output in one launch (no copy of the buffer
    before it), equal to delta_apply_rows_reference; the resident buffer
    is left as it was."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.solve import delta_apply_rows, delta_apply_rows_reference

    arr, idx, rows = b8_case(case, np.random.default_rng(len(case)))
    want = delta_apply_rows_reference(torch.from_numpy(arr), torch.from_numpy(idx),
                                      torch.from_numpy(rows))
    buf = torch.from_numpy(arr).to(cuda)
    _build.reset_launches()
    out = delta_apply_rows(buf, torch.from_numpy(idx).to(cuda), torch.from_numpy(rows).to(cuda))
    torch.cuda.synchronize()
    assert _build.launches["apply_rows"] == 1
    np.testing.assert_array_equal(out.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(buf.cpu().numpy(), arr)


def test_apply_rows_empty_delta(cuda):
    """An empty delta returns the buffer itself and launches nothing."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.solve import delta_apply_rows

    buf = torch.arange(12, dtype=torch.int32, device=cuda).reshape(4, 3)
    _build.reset_launches()
    assert delta_apply_rows(buf, np.zeros(0, np.int32), np.zeros((0, 3), np.int32)) is buf
    assert _build.launches["apply_rows"] == 0


# -- B8's donated entry: the rows written in place ----------------------------------


def b8_inplace_case(case, rng):
    """(arr, idx, rows) of b8_case, or of the in-place entry's own cases:
    mask rows of 2,048 bytes (16-byte moves, the tenant tick's g_mask
    width) and int32 counts (4-byte rows)."""
    if case == "mask-rows":
        arr, rows = rng.random((3000, 16, 128)) < 0.5, rng.random((700, 16, 128)) < 0.5
        return arr, rng.choice(3000, 700, replace=False).astype(np.int32), rows
    if case == "counts":
        arr = rng.integers(0, 99, 4096).astype(np.int32)
        return arr, rng.choice(4096, 900, replace=False).astype(np.int32), \
            rng.integers(0, 99, 900).astype(np.int32)
    return b8_case(case, rng)


@pytest.mark.parametrize("case", ["ragged-rows", "uneven-blocks", "every-row", "edge-indices",
                                  "mask-rows", "counts", "unaligned-base"])
def test_apply_rows_inplace(cuda, case, monkeypatch):
    """KTPU_DONATE_DELTA=1: one launch of the in-place entry (counted
    under its own name, no out-of-place B8), equal to the plain in-place
    version on the same CUDA tensors and to the CPU's; the result lies in
    the buffer's own memory and the old tensor object is emptied."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.solve import (
        delta_apply_rows,
        delta_apply_rows_inplace_reference,
    )

    rng = np.random.default_rng(len(case))
    if case == "unaligned-base":  # rows of 16 bytes from a base 1 byte off
        arr, idx, rows = b8_inplace_case("mask-rows", rng)
        arr, rows = arr[:, 0, :16], np.ascontiguousarray(rows[:, 0, :16])
        flat = torch.zeros(arr.size + 1, dtype=torch.bool, device=cuda)
        buf = flat[1:].view(arr.shape)
        buf.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    else:
        arr, idx, rows = b8_inplace_case(case, rng)
        buf = torch.from_numpy(arr).to(cuda)
    idx_d, rows_d = torch.from_numpy(idx).to(cuda), torch.from_numpy(rows).to(cuda)
    want = delta_apply_rows_inplace_reference(buf.clone(), idx_d, rows_d)
    cpu = delta_apply_rows_inplace_reference(torch.from_numpy(np.array(arr)),
                                             torch.from_numpy(idx), torch.from_numpy(rows))
    ptr = buf.data_ptr()
    monkeypatch.setenv("KTPU_DONATE_DELTA", "1")
    _build.reset_launches()
    out = delta_apply_rows(buf, idx_d, rows_d)
    torch.cuda.synchronize()
    assert (_build.launches["apply_rows_inplace"], _build.launches["apply_rows"]) == (1, 0)
    assert out.data_ptr() == ptr and buf.numel() == 0
    assert torch.equal(out, want)
    np.testing.assert_array_equal(out.cpu().numpy(), cpu.numpy())


def test_donated_tensor_raises(cuda, monkeypatch):
    """A launch that reads a tensor donated away raises, never computing on
    the rows written in its place: the row apply itself, and a queue token
    staged before a donating batch on the same EncodeCache (10 of 200
    Deployments swapped: group-row deltas on the batch's shared encoding)
    when it is resubmitted (an overflow resubmit, a late prefetch). The
    token's own launched outputs, enqueued before the in-place write, stay
    valid."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.solve import delta_apply_rows
    from karpenter_tpu_torch.solver.driver import EncodeCache, Scenario
    from karpenter_tpu_torch.solver.example import tenant_pods, tenant_pools

    monkeypatch.setenv("KTPU_DONATE_DELTA", "1")
    buf = torch.arange(12, dtype=torch.int32, device=cuda).reshape(4, 3)
    new = delta_apply_rows(buf, np.array([1], np.int32), np.full((1, 3), 7, np.int32))
    with pytest.raises(ValueError, match="donated"):
        delta_apply_rows(buf, np.array([2], np.int32), np.full((1, 3), 8, np.int32))
    assert new[1].tolist() == [7, 7, 7]

    pools = tenant_pools(4)
    catalog = corpus.generate(60)
    its = {p.name: list(catalog) for p in pools}

    def solver(pods, cache):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        return TorchSolver(pools, its, topo, config=SolverConfig(device="cuda"),
                           encode_cache=cache)

    cache = EncodeCache()
    pods = tenant_pods(200, 4)
    tick = [p for p in pods if p.metadata.labels["app"] not in {f"d{i}" for i in range(10)}]
    tick += tenant_pods(10, 4, seed=99, first=200)
    warm = solver(pods, cache)
    first = warm.solve_scenarios([Scenario(pods=pods)])
    token = warm.submit_scenarios([Scenario(pods=pods)])
    _build.reset_launches()
    solver(tick, cache).solve_scenarios([Scenario(pods=tick)])
    assert _build.launches["apply_rows_inplace"] >= 1
    assert slots(warm.collect_scenarios(token)[0]) == slots(first[0])
    with pytest.raises(Exception):
        warm._submit_scenario_dispatch(token)


# -- B1 and B2 over any order of the live-pair index ---------------------------------
#
# The generators below make the inputs of both kernels from a numpy seed;
# tests/test_torch_feasibility_index.py holds the plain versions against
# JAX on the same cases.

B1_NAMES = _B1
B2_NAMES = _B2
INDEX_CASES = ("shuffled", "padding-interleaved", "pair-repeated", "goff-repeats",
               "two-templates", "wide-masks", "scenario-axis", "vocabulary-masks",
               "huge-masks", "vocab-2048", "vocab-rows")


def random_tables(rng, P, G, T, N, K, V1, R, O, S=0):
    """B1's and B2's inputs but the live-pair index, by solve-arg name
    (numpy): random requirement rows (definitions, negations, masks),
    requests, offerings (ids -1 admit any value), tolerations; n_tol
    [S, N, G] where S > 0."""
    def reqs(n, p_def):
        return (rng.random((n, K)) < p_def, rng.random((n, K)) < 0.2,
                rng.random((n, K, V1)) < 0.7)

    a = {}
    a["g_def"], a["g_neg"], a["g_mask"] = reqs(G, 0.5)
    a["p_def"], a["p_neg"], a["p_mask"] = reqs(P, 0.3)
    a["t_def"], _, a["t_mask"] = reqs(T, 0.6)
    a["n_def"], _, a["n_mask"] = reqs(N, 0.8)
    f32 = np.float32
    a["g_req"] = rng.choice(np.array([0, 250, 1000, 4e3], f32), (G, R))
    a["p_daemon"] = rng.uniform(0, 500, (P, R)).astype(f32)
    a["t_alloc"] = rng.uniform(0, 2e4, (T, R)).astype(f32)
    a["n_avail"] = rng.uniform(0, 2e4, (N, R)).astype(f32)
    a["n_base"] = rng.uniform(0, 1e4, (N, R)).astype(f32)
    a["p_tol"] = rng.random((P, G)) < 0.9
    a["p_titype_ok"] = rng.random((P, T)) < 0.9
    a["o_avail"] = rng.random((T, O)) < 0.7
    a["o_zone"] = rng.integers(-1, V1, (T, O)).astype(np.int32)
    a["o_ct"] = rng.integers(-1, V1, (T, O)).astype(np.int32)
    a["well_known"] = rng.random(K) < 0.5
    a["n_tol"] = rng.random(((S,) if S else ()) + (N, G)) < 0.8
    return a


def reorder_index(rng, gk_g, gk_k, gk_w, goff_idx, n_pad=0, repeats=0, goff_twice=False):
    """A live-pair index in another order: its first ``repeats`` pairs
    listed once more, ``n_pad`` weight-0 pads of random (group, key)
    interleaved, the whole shuffled; goff_idx shuffled (with each entry
    twice under ``goff_twice``). Returns gk_g, gk_k, gk_w, goff_idx
    (int32)."""
    G = int(max(gk_g.max(initial=0), goff_idx.max(initial=0))) + 1
    K = int(gk_k.max(initial=0)) + 1
    g = np.concatenate([gk_g, gk_g[:repeats], rng.integers(0, G, n_pad)])
    k = np.concatenate([gk_k, gk_k[:repeats], rng.integers(0, K, n_pad)])
    w = np.concatenate([gk_w, gk_w[:repeats], np.zeros(n_pad, np.int64)])
    order = rng.permutation(len(g))
    goff = np.concatenate([goff_idx, goff_idx]) if goff_twice else goff_idx
    return (g[order].astype(np.int32), k[order].astype(np.int32), w[order].astype(np.int32),
            rng.permutation(goff).astype(np.int32))


def sparse_index_case(case, seed=0):
    """One case of INDEX_CASES: (inputs by solve-arg name, zone_kid,
    ct_kid). L distinct live (group, key) pairs of weight 1 or 2 and LZ
    listed groups, then the index reordered as the case says; T = 37 in
    "two-templates" (no four-type stores), V1 = 40 in "wide-masks" (two
    bit words a key), n_tol [16, N, G] in "scenario-axis", K = 16 and
    V1 = 128 in "vocabulary-masks" (B1's block past 48 KB of shared
    memory), K = 4 and V1 = 2048 in "huge-masks" (B2's block past it
    too), K = 16 and V1 = 2048 in "vocab-2048" (a value vocabulary of
    1,024+ values: B1's mask bytes past the card's shared memory, its
    words built straight from device memory) and V1 = 65,536 in
    "vocab-rows" (G = 16, T = 8, N = 4: past even B1's words, every word
    read from the byte rows)."""
    rng = np.random.default_rng([seed, INDEX_CASES.index(case)])
    P = 2 if case == "two-templates" else 1
    T = {"two-templates": 37, "vocab-rows": 8}.get(case, 36)
    V1 = {"wide-masks": 40, "vocabulary-masks": 128, "huge-masks": 2048, "vocab-2048": 2048,
          "vocab-rows": 65536}.get(case, 5)
    S = 16 if case == "scenario-axis" else 0
    G, N, K, R, O, L, LZ = 40, 9, 6, 3, 4, 70, 12
    if case == "vocab-rows":
        G, N = 16, 4
    K = {"vocabulary-masks": 16, "huge-masks": 4, "vocab-2048": 16, "vocab-rows": 16}.get(case, K)
    a = random_tables(rng, P, G, T, N, K, V1, R, O, S)
    cells = rng.choice(G * K, L, replace=False)
    cells.sort()  # the encoder's order: by group, then key
    gk = (cells // K, cells % K, rng.choice([1, 2], L), rng.choice(G, LZ, replace=False))
    if case in ("shuffled", "wide-masks", "vocabulary-masks", "huge-masks", "vocab-2048",
                "vocab-rows"):
        idx = reorder_index(rng, *gk)
    elif case == "padding-interleaved":
        idx = reorder_index(rng, *gk, n_pad=40)
    elif case == "pair-repeated":
        idx = reorder_index(rng, *gk, n_pad=5, repeats=7)
    elif case == "goff-repeats":
        idx = reorder_index(rng, *gk, goff_twice=True)
    else:  # two-templates, scenario-axis: every reordering at once
        idx = reorder_index(rng, *gk, n_pad=20, repeats=5, goff_twice=True)
    a.update(zip(("gk_g", "gk_k", "gk_w", "goff_idx"), idx))
    return a, 1, 2


def _on(a, names, device):
    return [torch.from_numpy(np.ascontiguousarray(a[n])).to(device) for n in names]


def _junk_empty(monkeypatch):
    """Every CUDA buffer torch.empty allocates comes back filled with junk."""
    empty = torch.empty

    def junk(*args, **kw):
        t = empty(*args, **kw)
        if t.is_cuda and t.numel():
            t.fill_(True if t.dtype == torch.bool else float("nan") if t.is_floating_point()
                    else torch.iinfo(t.dtype).max // 2 + 7)
        return t

    monkeypatch.setattr(torch, "empty", junk)


def _device_kernels(fn, reps=20):
    """The device activities torch.profiler sees a call of ``fn``, by name:
    over ``reps`` calls, host and device traced (as chip_smoke.py's
    device_ms), each activity's records per call rounded (the tracer may
    drop a record of a call this short)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_call = []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA") and ev.count:
            per_call += [ev.key] * round(ev.count / reps)
    return per_call


def _tables_equal_plain(a, zk, ck, cuda, kernels=True):
    """B1 and B2 (where N > 0) on the card against their plain versions
    on the CPU, one launch each."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas

    _build.reset_launches()
    got = feas.fresh_claim_feasibility_sparse(*_on(a, B1_NAMES, cuda), zone_kid=zk, ct_kid=ck)
    want = feas.fresh_claim_feasibility_sparse_reference(*_on(a, B1_NAMES, "cpu"),
                                                         zone_kid=zk, ct_kid=ck)
    assert _build.launches["fresh_feasibility"] == 1
    for name, k, p in zip(("compat_pg", "type_ok", "n_fit"), got, want):
        assert k.dtype == p.dtype and k.shape == p.shape, name
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=name)
    if not a["n_avail"].shape[0]:
        return want
    got = feas.existing_node_feasibility_sparse(*_on(a, B2_NAMES, cuda))
    want2 = feas.existing_node_feasibility_sparse_reference(*_on(a, B2_NAMES, "cpu"))
    assert _build.launches["existing_feasibility"] == 1
    assert got.dtype == want2.dtype and got.shape == want2.shape
    np.testing.assert_array_equal(got.cpu().numpy(), want2.numpy(), err_msg="cap_ng")
    return want


@pytest.mark.parametrize("case", INDEX_CASES)
def test_sparse_tables_any_index_order(cuda, case, monkeypatch):
    """B1 and B2 over a reordered live-pair index (shuffled, weight-0
    padding interleaved, pairs repeated, goff_idx repeated, P = 2, two
    mask words a key, the scenario axis) equal their plain versions, with
    every output buffer junk-filled first: each cell is written."""
    a, zk, ck = sparse_index_case(case)
    _junk_empty(monkeypatch)
    compat_pg, type_ok, _ = _tables_equal_plain(a, zk, ck, cuda)
    assert type_ok.any() and not type_ok.all() and compat_pg.any()


def _path_args(pods, n_types, n_nodes=0):
    """The solve args (numpy, by name) and statics of a batch, padded as
    TorchSolver pads them (G to a power of two, at least 8)."""
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}
    nodes = example_state_nodes(n_nodes)
    topo = Topology(Client(TestClock()), nodes, pools, its, pods)
    solver = TorchSolver(pools, its, topo, state_nodes=nodes, config=SolverConfig(device="cpu"))
    groups, rest = enc.partition_and_group(pods, topology=topo)
    assert not rest
    snap, avail, *_ = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    N = enc._next_pow2(n_nodes, floor=1) if n_nodes else 0
    statics = solver._kernel_statics(snap, G)
    args = snap.padded(G, N).solve_args(*avail)
    return dict(zip(enc.SOLVE_ARG_NAMES, (np.asarray(x) for x in args))), statics


@pytest.mark.parametrize("shape", ["mixed-50k", "diverse-ref", "constrained-50k",
                                   "constrained-50k-shuffled", "nodes-32-scenarios"])
def test_sparse_tables_path_shapes(cuda, shape):
    """B1 (and B2 over nodes) at the main path's shapes: mixed 50k x 400
    (G=64), diverse-ref 5,000 x 400 (G=2048), constrained 50k x 800
    (G=256, the live pairs), the latter over its index reordered, and the
    2,000-pod batch over 32 nodes with a scenario axis of 16."""
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix

    if shape == "mixed-50k":
        a, st = _path_args(mixed_pods(50_000), 400)
    elif shape == "diverse-ref":
        a, st = _path_args(diverse_reference_mix(5_000), 400)
    elif shape.startswith("constrained"):
        a, st = _path_args(constrained_mix(50_000), 800)
        assert (a["gk_w"] != 0).sum() > 0
        if shape.endswith("shuffled"):
            idx = reorder_index(np.random.default_rng(5), a["gk_g"], a["gk_k"], a["gk_w"],
                                a["goff_idx"], n_pad=64, repeats=9, goff_twice=True)
            a.update(zip(("gk_g", "gk_k", "gk_w", "goff_idx"), idx))
    else:
        a, st = _path_args(mixed_pods(2_000), 400, n_nodes=32)
        rng = np.random.default_rng(3)
        a["n_tol"] = a["n_tol"][None] & (rng.random((16,) + a["n_tol"].shape) < 0.7)
    _, type_ok, _ = _tables_equal_plain(a, st["zone_kid"], st["ct_kid"], cuda)
    assert type_ok.any()


def test_sparse_tables_one_kernel_each(cuda):
    """torch.profiler sees one kernel per call of each wrapper: no memset,
    no copy, no second pass."""
    from karpenter_tpu_torch.ops import feasibility as feas

    a, zk, ck = sparse_index_case("scenario-axis")
    b1_in, b2_in = _on(a, B1_NAMES, cuda), _on(a, B2_NAMES, cuda)
    b1 = _device_kernels(lambda: feas.fresh_claim_feasibility_sparse(
        *b1_in, zone_kid=zk, ct_kid=ck))
    b2 = _device_kernels(lambda: feas.existing_node_feasibility_sparse(*b2_in))
    assert len(b1) == 1 and "fresh_tables" in b1[0], b1
    assert len(b2) == 1 and "node_caps" in b2[0], b2


_MALFORMED = {
    "dtype": lambda x: x.to(torch.float64) if x.is_floating_point() else x.to(torch.int64),
    "shape": lambda x: x[:-1],
    "device": lambda x: x.cpu(),
    "contiguity": lambda x: torch.stack([x, x], -1)[..., 0],
}


@pytest.mark.parametrize("fault", sorted(_MALFORMED))
@pytest.mark.parametrize("kernel", ["fresh", "existing"])
def test_sparse_wrappers_raise_on_malformed_inputs(cuda, kernel, fault):
    """Each wrapper raises ValueError on a malformed input (a wrong dtype,
    shape, device or layout, in each position) and launches nothing; B1
    also on a zone or capacity-type key outside K."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas

    a, zk, ck = sparse_index_case("shuffled")
    names = B1_NAMES if kernel == "fresh" else B2_NAMES
    good = _on(a, names, cuda)

    def call(ins, **kw):
        if kernel == "fresh":
            return feas.fresh_claim_feasibility_sparse(*ins, **dict(dict(zone_kid=zk, ct_kid=ck),
                                                                    **kw))
        return feas.existing_node_feasibility_sparse(*ins)

    _build.reset_launches()
    # g_mask decides the route (a CPU g_mask is the plain version's), so it
    # stays on the card for the device fault
    for i in range(len(names)):
        if fault == "device" and names[i] == "g_mask":
            continue
        if fault == "shape" and names[i] == "goff_idx":  # any length LZ is well formed
            continue
        bad = list(good)
        bad[i] = _MALFORMED[fault](good[i])
        with pytest.raises(ValueError):
            call(bad)
    if kernel == "fresh":
        for kw in (dict(zone_kid=a["g_mask"].shape[1]), dict(ct_kid=-1)):
            with pytest.raises(ValueError):
                call(good, **kw)
    assert not any(_build.launches.values())
    call(good)
    assert _build.launches[f"{kernel}_feasibility"] == 1


# -- wide value vocabularies (ROADMAP C1), and B3 and B6 redesigned --------------
#
# V1 = pow2(most values of one key + 1): a per-team label of 1,100 values
# takes it to 2,048, past the mask bytes B1 stages and the per-step
# arrays B4 and B5 keep in shared memory. The kernels must return what
# the plain versions (and the JAX reference, tests/test_torch_wide_vocab.py)
# return at any width.

N_TEAMS = 1_100


def _wide_domain_batch():
    """tests/test_torch_wide_vocab.py's domain batch in the port's objects:
    zonal self-spread pods, pods of three teams, one pod pinned to a zone
    no type offers and one excluded from every offered zone, over a pool
    listing 1,100 teams (V1 2048), with nodes in zone a, zone b and the
    outside zone."""
    from chip_smoke import TEAM_KEY, team_pool
    from karpenter_tpu_torch.api.objects import NodeAffinity, NodeSelectorRequirement
    from karpenter_tpu_torch.solver.workloads import _pod

    def zone_req(op, values):
        return NodeAffinity(required=[(NodeSelectorRequirement(labels.TOPOLOGY_ZONE, op,
                                                               tuple(values)),)])

    sel = LabelSelector(match_labels={"app": "zs"})
    pods = [_pod(f"zs-{i}", 500, 512, labels={"app": "zs"},
                 topology_spread_constraints=[TopologySpreadConstraint(
                     max_skew=1, topology_key=labels.TOPOLOGY_ZONE,
                     when_unsatisfiable="DoNotSchedule", label_selector=sel)])
            for i in range(9)]
    pods += [_pod(f"team-{i}", 250 * (1 + i % 3), 1024, node_selector={TEAM_KEY: f"team-{i % 3}"})
             for i in range(12)]
    pods.append(_pod("outside-in", 500, 1024, node_affinity=zone_req("In", ("zone-outside",))))
    pods.append(_pod("outside-notin", 500, 1024, node_affinity=zone_req(
        "NotIn", ("test-zone-a", "test-zone-b", "test-zone-c"))))
    nodes = example_state_nodes(3)
    for sn, zone in zip(nodes, ("test-zone-a", "test-zone-b", "zone-outside")):
        sn.node.metadata.labels[labels.TOPOLOGY_ZONE] = zone
    return pods, [team_pool([f"team-{i}" for i in range(N_TEAMS)])], nodes


def _spilled(library, V1):
    """The spill scratch the last launches of ``library`` at V1 took
    (ops/packing.py:layouts): > 0 where the scan's per-step arrays passed
    a block's shared memory."""
    from karpenter_tpu_torch.ops import packing as tp

    at = 6 if library == "pack" else 5  # the key's V1: (library, device, [S,] P, R, K, V1, ...)
    got = [v[1] for k, v in tp.layouts.items() if k[0] == library and k[at] == V1]
    assert got, (library, V1, list(tp.layouts))
    return max(got)


@pytest.mark.parametrize("case,mode", [("vocab-2048", "direct"), ("vocab-rows", "rows")])
def test_sparse_tables_wide_vocab(cuda, case, mode):
    """B1 and B2 at K = 16, V1 = 2,048 (B1's mask bytes past the card's
    shared memory: its words built straight from device memory) and V1 =
    65,536 (past even B1's words: every word read from the byte rows, B1's
    global path), exact against their plain versions."""
    from karpenter_tpu_torch.ops.feasibility import fresh_layout

    a, zk, ck = sparse_index_case(case)
    P, G, T = a["p_tol"].shape + a["p_titype_ok"].shape[1:]
    K, V1 = a["g_mask"].shape[1:]
    lay = fresh_layout(P, G, T, K, V1, a["g_req"].shape[1], a["o_avail"].shape[1],
                       a["gk_g"].shape[0])
    assert lay["mode"] == mode and lay["smem"] <= 227 * 1024, lay
    _, type_ok, _ = _tables_equal_plain(a, zk, ck, cuda)
    assert type_ok.any() and not type_ok.all()


def _team_ops_args():
    """Solve args (numpy, by name), zone_kid and ct_kid of pods over a pool
    listing 1,100 teams x corpus.generate(400) (K 16, V1 2048) whose team
    key meets every operator: In one team, NotIn three teams, NotIn every
    team, Exists and DoesNotExist."""
    from chip_smoke import N_TEAMS, TEAM_KEY, team_pods, team_pool
    from karpenter_tpu_torch.api.objects import NodeAffinity, NodeSelectorRequirement
    from karpenter_tpu_torch.solver.workloads import _pod

    teams = [f"team-{i}" for i in range(N_TEAMS)]

    def team_req(op, values=()):
        return NodeAffinity(required=[(NodeSelectorRequirement(TEAM_KEY, op, tuple(values)),)])

    pods = team_pods(24)
    pods += [_pod(f"notin-{i}", 500 + 250 * i, 1024,
                  node_affinity=team_req("NotIn", teams[90 * i:90 * i + 3])) for i in range(6)]
    pods.append(_pod("notin-all", 500, 1024, node_affinity=team_req("NotIn", teams)))
    pods += [_pod(f"exists-{i}", 750, 2048, node_affinity=team_req("Exists")) for i in range(2)]
    pods += [_pod(f"dne-{i}", 750, 2048, node_affinity=team_req("DoesNotExist"))
             for i in range(2)]
    args, statics, _ = _scan_snapshot(pods, [team_pool(teams)], corpus.generate(400))
    a = dict(zip(enc.SOLVE_ARG_NAMES, (np.asarray(x) for x in args)))
    return a, statics["zone_kid"], statics["ct_kid"]


def test_sparse_tables_team_operators_v1_2048(cuda):
    """B1 in its direct mode (the word pass across the card, then the
    tables) at V1 2048 over NotIn, DoesNotExist, Exists and In on the wide
    key, whole and in its partial mode with and without the base, exact
    against the plain versions; the wrapper's words are the layout's."""
    from karpenter_tpu_torch.ops import feasibility as feas

    a, zk, ck = _team_ops_args()
    P, G, T = a["p_tol"].shape + a["p_titype_ok"].shape[1:]
    K, V1 = a["g_mask"].shape[1:]
    R, O, L = a["g_req"].shape[1], a["o_avail"].shape[1], a["gk_g"].shape[0]
    assert (K, V1) == (16, 2048)
    lay = feas.fresh_layout(P, G, T, K, V1, R, O, L)
    assert lay["mode"] == "direct" and lay["smem"] <= 227 * 1024, lay
    assert lay["words"] == feas._direct_words(cuda, P, G, T, K, V1, R, O, L).numel() > 0
    compat_pg, type_ok, _ = _tables_equal_plain(a, zk, ck, cuda)
    assert type_ok.any() and not compat_pg.all()
    for base in (True, False):
        got = feas.fresh_claim_feasibility_partial(*_on(a, B1_NAMES, cuda), zone_kid=zk,
                                                   ct_kid=ck, with_base=base)
        want = feas.fresh_claim_feasibility_partial_reference(
            *_on(a, B1_NAMES, "cpu"), zone_kid=zk, ct_kid=ck, with_base=base)
        for name, k, p in zip(("fail_t", "fail_c", "tonly", "n_fit"), got, want):
            if p is None:
                assert k is None, name
                continue
            np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=name)
    # B2's partial mode without the base returns no cap, as its plain version
    b, _, _ = sparse_index_case("shuffled")
    nfail, cap = feas.existing_node_feasibility_partial(
        *_on(b, [n for n in B2_NAMES if n != "n_tol"], cuda), with_base=False)
    assert cap is None and nfail.shape == (b["n_avail"].shape[0], b["g_mask"].shape[0])


def test_pack_domains_and_classed_wide_vocab(cuda):
    """B4 over the domain batch at V1 = 2,048 (its per-step arrays in shared
    memory: the claim caps size fewer claims a chunk) against
    pack_reference, and B5 on the same batch against
    pack_classed_reference: every output, the claims' domains included."""
    from karpenter_tpu_torch import _build

    pods, pools, nodes = _wide_domain_batch()
    args, statics, classes = _scan_snapshot(pods, pools, corpus.generate(20), nodes=nodes)
    assert np.asarray(args[enc.SOLVE_ARG_NAMES.index("g_mask")]).shape[2] == 2048
    assert statics["has_domains"]
    _build.reset_launches()
    out = _kernels_equal_plain(args, statics, cuda)
    assert _build.launches["pack_domains"] == 1 and int(out[2]) > 0
    assert _spilled("pack", 2048) == 0
    _classed_equal_plain(args, statics, classes, cuda)
    assert _spilled("pack_classed", 2048) == 0


@pytest.mark.parametrize("floor", [1, 2, 50, "above-MW"])
def test_pack_minvalues_wide_catalog(cuda, floor):
    """minValues on the instance type over 1,100 types (MW 2048, past the
    1,024 the scans took before) at floors of 1, 2 (the pool's own),
    50 and one past MW (every cap 0: no claim opens): B4 with floors
    against pack_reference, B5 with floors against pack_classed_reference
    and B7's scenario grid against its plain version, every scan's fits in
    shared memory (no spill scratch)."""
    from chip_smoke import type_pool
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import packing as tp

    args, statics, classes = _scan_snapshot(mixed_pods(600, gpu_fraction=0.0),
                                            [type_pool(min_values=2)], corpus.generate(1100))
    i = enc.SOLVE_ARG_NAMES.index("p_mvmin")
    MW = np.asarray(args[enc.SOLVE_ARG_NAMES.index("t_mvoh")]).shape[-1]
    mvmin = np.array(args[i])
    assert MW == 2048 and mvmin.any()
    mvmin[mvmin > 0] = MW + 1 if floor == "above-MW" else floor
    args = list(args)
    args[i] = mvmin
    tp.layouts.clear()
    _build.reset_launches()
    out = _kernels_equal_plain(args, statics, cuda)
    assert _build.launches["pack_minvalues"] == 1
    assert (int(out[2]) == 0) == (floor == "above-MW")
    _classed_equal_plain(args, statics, classes, cuda)
    _scenarios_equal_plain(_scenario_args(args, 4, 3, seed=21), statics, cuda)
    assert tp.layouts and all(spill == 0 for _, spill in tp.layouts.values()), tp.layouts


def _wide_ledger_batch(capacity=1):
    """The wide domain batch (V1 2048) over a reserved catalog: a
    reservation of ``capacity`` in test-zone-a on every fourth type, so
    the first bulk that holds one drains it and the scan rebuilds its
    offering words mid-scan."""
    pods, pools, nodes = _wide_domain_batch()
    its = _reserved(20, 4, capacity)
    return _scan_snapshot(pods, pools, its, nodes=nodes, reserved_capacity_enabled=True)


def _high_zone_catalog(n_zones=1_100):
    """A batch whose zone key carries ``n_zones`` values (V1 2048), with the
    launch's offered zones at both ends of the vocabulary: pods requiring
    one of zone-0000 .. zone-<n_zones - 1> (the In list registers them in
    order, first), pods pinned to zone-1090 (a zone id near the top),
    zonal self-spread pods and a pod excluded from every named zone, over
    corpus.generate(20) where types 3 and 11 also offer zone-1090; then
    a_tzc edited so that types 5 and 17 offer the overflow slot V1 - 1 on
    demand (the encoder interns every offered zone, so no catalog reaches
    it, but the scans take any a_tzc)."""
    from karpenter_tpu_torch.api.objects import NodeAffinity, NodeSelectorRequirement
    from karpenter_tpu_torch.solver.workloads import _pod

    zones = [f"zone-{i:04d}" for i in range(n_zones)]

    def zone_req(op, values):
        return NodeAffinity(required=[(NodeSelectorRequirement(labels.TOPOLOGY_ZONE, op,
                                                               tuple(values)),)])

    its = corpus.generate(20)
    wide = corpus.generate(20, zones=("test-zone-a", "test-zone-b", "test-zone-c", "zone-1090"))
    its[3], its[11] = wide[3], wide[11]
    sel = LabelSelector(match_labels={"app": "zs"})
    pods = [_pod(f"any-{i}", 1500, 512, node_affinity=zone_req("In", zones)) for i in range(4)]
    pods += [_pod(f"zs-{i}", 500, 512, labels={"app": "zs"},
                  topology_spread_constraints=[TopologySpreadConstraint(
                      max_skew=1, topology_key=labels.TOPOLOGY_ZONE,
                      when_unsatisfiable="DoNotSchedule", label_selector=sel)])
             for i in range(6)]
    pods += [_pod(f"high-{i}", 250, 1024, node_affinity=zone_req("In", ("zone-1090",)))
             for i in range(3)]
    pods.append(_pod("unlisted", 250, 1024, node_affinity=zone_req(
        "NotIn", ("test-zone-a", "test-zone-b", "test-zone-c", *zones))))
    args, statics, classes = _scan_snapshot(pods, [example_nodepool()], its)
    i = enc.SOLVE_ARG_NAMES.index("a_tzc")
    a_tzc = np.array(args[i])
    for t in (5, 17):  # the first capacity type the type offers at all
        a_tzc[t, -1, np.nonzero(a_tzc[t].any(axis=0))[0][0]] = True
    args = list(args)
    args[i] = a_tzc
    return args, statics, classes


def test_pack_ledger_drains_at_v1_2048(cuda):
    """B4 at V1 2048 with domains and a reservation ledger whose
    reservations (capacity 1) drain mid-scan, so the scan rebuilds its
    offering words from the reservations' word tables: every output
    against pack_reference; no per-step array spilled."""
    from karpenter_tpu_torch import _build

    args, statics, _ = _wide_ledger_batch()
    a = dict(zip(enc.SOLVE_ARG_NAMES, args))
    assert np.asarray(a["g_mask"]).shape[2] == 2048 and statics["has_domains"]
    assert np.asarray(a["res_cap0"]).shape[0] > 0 and (np.asarray(a["res_cap0"]) == 1).all()
    _build.reset_launches()
    out = _kernels_equal_plain(args, statics, cuda)
    assert _build.launches["pack_resv"] == 1 and _build.launches["pack_domains"] == 1
    # a claim holds a reservation (c_resv): its bulk drained it (capacity 1)
    assert out[9].any() and int(out[2]) > 0
    assert _spilled("pack", 2048) == 0


@pytest.mark.parametrize("ledger", [False, True], ids=["shared-words", "per-scenario-words"])
def test_scenario_grid_wide_vocab(cuda, ledger):
    """B7's grid over 6 scenarios (4 real) at V1 2048 with domains: without
    a ledger every scenario reads the launch's one set of offering words,
    with one (capacity 1, drained mid-scan) each scenario rebuilds its own;
    every scenario against pack_reference on its slice."""
    if ledger:
        args, statics, _ = _wide_ledger_batch()
    else:
        pods, pools, nodes = _wide_domain_batch()
        args, statics, _ = _scan_snapshot(pods, pools, corpus.generate(20), nodes=nodes)
    assert np.asarray(args[enc.SOLVE_ARG_NAMES.index("g_mask")]).shape[2] == 2048
    out = _scenarios_equal_plain(_scenario_args(args, 6, 4, seed=20 + ledger), statics, cuda)
    assert int(out[2].max()) > 0 and (out[2][4:] == 0).all()


def test_pack_offers_top_zone_and_overflow(cuda):
    """B4 and B5 over a zone key of 1,100 values (V1 2048) whose offerings
    name zone-1090 (a zone id near the top) and the overflow slot V1 - 1:
    the offered sets reach both ends of the vocabulary's words, and the
    pods pinned to zone-1090 land there, exact against the plain
    versions."""
    args, statics, classes = _high_zone_catalog()
    a = dict(zip(enc.SOLVE_ARG_NAMES, (np.asarray(x) for x in args)))
    V1 = a["g_mask"].shape[2]
    offered = np.nonzero(a["a_tzc"].any(axis=(0, 2)))[0]
    assert V1 == 2048 and statics["has_domains"]
    assert offered.max() == V1 - 1 and (offered >= 1024).sum() >= 2, offered
    out = _kernels_equal_plain(args, statics, cuda)
    # every pod placed but the one no named zone admits, a claim in zone-1090
    assert int(out[6].sum()) == 1 and (out[7][: int(out[2])] >= 1024).any()
    _classed_equal_plain(args, statics, classes, cuda)


@pytest.mark.parametrize("case", ["team-in", "minvalues-types"])
def test_wide_vocab_solve_matches_cpu(cuda, case):
    """TorchSolver(device="cuda") against device="cpu" on two of ROADMAP
    C1's inputs, claims in slot order: a pool listing 1,100 teams with 40
    pods (K 16, V1 2048) and minValues 2 on the instance type over 1,100
    types at mixed_pods(2000) (MW 2048)."""
    from chip_smoke import team_pods, team_pool, type_pool

    if case == "team-in":
        pods = team_pods(40)
        pools, its = [team_pool([f"team-{i}" for i in range(N_TEAMS)])], corpus.generate(400)
    else:
        pods, pools, its = mixed_pods(2000), [type_pool(min_values=2)], corpus.generate(1100)
    got = {}
    for device in ("cpu", "cuda"):
        by_pool = {p.name: list(its) for p in pools}
        topo = Topology(Client(TestClock()), [], pools, by_pool, pods)
        s = TorchSolver(pools, by_pool, topo, config=SolverConfig(device=device))
        res = s.solve(pods)
        got[device] = (slots(res), sorted(res.pod_errors))
    assert got["cuda"] == got["cpu"] and got["cpu"][0] and not got["cpu"][1]


def _dense_case(case):
    """B3's inputs (numpy, by solve-arg name) and (zone_kid, ct_kid): the
    dense route's shape (mixed 50k x 400, G 64), the relax path's (its
    first group alone: 1 x 400), the state-node snapshot (32 nodes x 64
    groups), and random rows at K = 16, V1 = 2,048 and 65,536."""
    if case in ("dense-64x400", "relax-1x400"):
        a, st = _path_args(mixed_pods(50_000), 400)
        if case == "relax-1x400":
            for n in ("g_def", "g_neg", "g_mask", "g_req"):
                a[n] = a[n][:1]
            a["p_tol"] = a["p_tol"][:, :1]
            a["n_tol"] = a["n_tol"][:, :1]
        return a, st["zone_kid"], st["ct_kid"]
    if case == "nodes-32x64":
        a, st = _path_args(mixed_pods(2_000), 400, n_nodes=32)
        return a, st["zone_kid"], st["ct_kid"]
    V1 = {"vocab-2048": 2048, "vocab-rows": 65536}[case]
    rng = np.random.default_rng([21, V1])
    return random_tables(rng, 2, 12, 20, 6, 16, V1, 3, 4), 1, 2


@pytest.mark.parametrize("case,mode", [
    ("dense-64x400", "words"), ("relax-1x400", "words"), ("nodes-32x64", "words"),
    ("vocab-2048", "words"), ("vocab-rows", "rows")])
def test_dense_tables_one_launch(cuda, case, mode):
    """B3's fresh and existing entries at their paths' shapes and at K =
    16, V1 = 2,048 and 65,536: exact against their plain versions, one
    kernel a call under torch.profiler (no word pass, no memset), the
    layout each takes."""
    from karpenter_tpu_torch.ops import feasibility as feas

    a, zk, ck = _dense_case(case)
    fresh_in, exist_in = _on(a, _B3, cuda), _on(a, _B3E, cuda)
    kw = dict(zone_kid=zk, ct_kid=ck)
    got = feas.fresh_claim_feasibility(*fresh_in, **kw)
    want = feas.fresh_claim_feasibility_reference(*_on(a, _B3, "cpu"), **kw)
    for name, k, p in zip(("compat_pg", "type_ok", "n_fit"), got, want):
        assert k.dtype == p.dtype and k.shape == p.shape, name
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=name)
    assert want[1].any()
    P, G = a["p_tol"].shape
    T, K, V1 = a["t_mask"].shape
    R, O = a["g_req"].shape[1], a["o_avail"].shape[1]
    assert feas.dense_layout(P, -1, G, T, K, V1, R, O)["mode"] == mode
    fresh = _device_kernels(lambda: feas.fresh_claim_feasibility(*fresh_in, **kw))
    assert len(fresh) == 1 and "dense_fresh" in fresh[0], fresh
    N = a["n_avail"].shape[0]
    if N:
        cap = feas.existing_node_feasibility(*exist_in)
        want = feas.existing_node_feasibility_reference(*_on(a, _B3E, "cpu"))
        np.testing.assert_array_equal(cap.cpu().numpy(), want.numpy(), err_msg="cap_ng")
        assert int(want.max()) > 0
        assert feas.dense_layout(P, N, G, T, K, V1, R, O)["mode"] == mode
        exist = _device_kernels(lambda: feas.existing_node_feasibility(*exist_in))
        assert len(exist) == 1 and "dense_existing" in exist[0], exist


def _wire_outs(rng, lead, nmax, T, G, N, device):
    """Random outputs of the scan (the ten of solve_core) with ``lead``
    scenario axes: masks half set, fills and per-claim ids past int16 so
    the narrowing wraps, on ``device``."""
    i32 = np.int32
    big = rng.integers(-(2**31), 2**31 - 1, size=lead + (nmax,), dtype=np.int64).astype(i32)
    outs = (
        np.where(rng.random(lead + (nmax,)) < 0.5, rng.integers(0, 64, lead + (nmax,)), big),
        rng.random(lead + (nmax, T)) < 0.5,
        rng.integers(0, nmax, lead).astype(i32), rng.random(lead) < 0.5,
        rng.integers(-(2**20), 2**20, lead + (G, N)),
        rng.integers(-(2**20), 2**20, lead + (G, nmax)),
        rng.integers(0, 9, lead + (G,)),
        rng.integers(-1, 40000, lead + (nmax,)), rng.integers(-1, 3, lead + (nmax,)),
        rng.random(lead + (nmax,)) < 0.1,
    )
    return tuple(torch.from_numpy(np.ascontiguousarray(
        x.astype(i32) if x.dtype != np.bool_ else x)).to(device) for x in outs)


@pytest.mark.parametrize("case", ["mixed-50k", "scenarios-16", "odd-widths", "no-nodes"])
def test_wire_pack_one_launch(cuda, case):
    """B6 at the solve's shape (NMAX 1024, T 400, G 64), the consolidation
    chunk's (S = 16, NMAX 64, T 50, G 1, N 2048), odd widths (T 37, fills
    not a multiple of 8: the unaligned mask rows and the tails) and no
    nodes: exact against wire_pack_reference for both fill dtypes, the
    narrowing wrapping as XLA's convert, one kernel a call."""
    from karpenter_tpu_torch.ops.solve import wire_pack_reference

    lead, nmax, T, G, N = {"mixed-50k": ((), 1024, 400, 64, 0),
                           "scenarios-16": ((16,), 64, 50, 1, 2048),
                           "odd-widths": ((3,), 29, 37, 5, 7),
                           "no-nodes": ((), 100, 400, 13, 0)}[case]
    rng = np.random.default_rng(len(case))
    kern = _wire_outs(rng, lead, nmax, T, G, N, cuda)
    plain = tuple(x.cpu() for x in kern)
    for dtype in (torch.int16, torch.int32):
        got = wire_pack(kern, dtype)
        want = wire_pack_reference(plain, dtype)
        for i, (k, p) in enumerate(zip(got, want)):
            assert k.dtype == p.dtype and k.shape == p.shape, i
            np.testing.assert_array_equal(k.cpu().numpy(), p.numpy(), err_msg=f"wire {i}")
    names = _device_kernels(lambda: wire_pack(kern, torch.int16))
    assert len(names) == 1 and "wire_pack" in names[0], names


# -- the degradation ladder on the card ----------------------------------------------


def _ladder_solve(device, pods, **config):
    """Slot-order claims and pod errors of one solve of ``pods`` over the
    example NodePool and 40 types, and the audit record's (rung, guard)."""
    from karpenter_tpu_torch import obs

    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(40)}
    topo = Topology(Client(TestClock()), [], pools, its, pods)
    s = TorchSolver(pools, its, topo, config=SolverConfig(device=device, **config))
    r = s.solve(pods)
    rec = obs.AUDIT.last()
    return ([(tuple(sorted(p.metadata.name for p in c.pods)),
              tuple(it.name for it in c.instance_type_options)) for c in r.new_node_claims],
            sorted(r.pod_errors)), (rec.rung, rec.guard.split(":")[0])


def _fault(site, **rule):
    from karpenter_tpu_torch import faults

    faults.install(faults.FaultInjector([faults.FaultRule(getattr(faults, site), **rule)]))


@pytest.fixture
def no_faults():
    from karpenter_tpu_torch import faults

    yield
    faults.uninstall()


def test_ladder_dispatch_fault_and_recovery(cuda, no_faults):
    """A dispatch fault on the card: the oracle's Results with the breaker
    open; past the cool-down the kernel rung again, equal to the plain
    card solve."""
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.faults.breaker import SolverHealth

    pods = mixed_pods(300)
    plain, _ = _ladder_solve(cuda, pods)
    oracle, _ = _ladder_solve(cuda, pods, force_oracle=True)
    clock = TestClock()
    health = SolverHealth(clock, failure_threshold=1, cooldown=60.0)
    _fault("SOLVER_DISPATCH")
    got, rung = _ladder_solve(cuda, pods, health=health)
    faults.uninstall()
    assert got == oracle and rung == ("oracle", "ok") and not health.allow_kernel()
    clock.step(60.0)
    got, rung = _ladder_solve(cuda, pods, health=health)
    assert got == plain and rung == ("kernel", "ok") and health.level() == 0


def test_ladder_corrupt_card_outputs_quarantined(cuda, no_faults):
    """A SOLVER_OUTPUT mutation of the card's tensors (claim fills
    negative) is rejected by the guard before decode: the oracle's Results,
    the kernel rung quarantined; without a ladder the error surfaces."""
    from karpenter_tpu_torch.faults.breaker import SolverHealth
    from karpenter_tpu_torch.faults.guard import SolverIntegrityError

    def corrupt(outs):
        assert outs[5].is_cuda  # mutated on the card, before the drain
        outs = list(outs)
        outs[5] = outs[5] - 7
        return tuple(outs)

    pods = mixed_pods(200)
    oracle, _ = _ladder_solve(cuda, pods, force_oracle=True)
    _fault("SOLVER_OUTPUT", mutate=corrupt)
    with pytest.raises(SolverIntegrityError):
        _ladder_solve(cuda, pods, relax=False)
    health = SolverHealth(TestClock(), cooldown=60.0)
    got, rung = _ladder_solve(cuda, pods, health=health, relax=False)
    assert got == oracle and rung == ("oracle", "quarantined")
    assert health.quarantines == 1 and not health.allow_kernel()


def test_ladder_scenario_fault_declines_to_per_probe(cuda, no_faults):
    """A scenario-dispatch fault in a consolidation search on the card:
    with a ladder the batch declines, the per-probe replay gives the
    batched search's command, the batched rung down and the kernel rung
    up; without one the fault raises."""
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.faults.breaker import SolverHealth
    from karpenter_tpu_torch.solver.workloads import build_consolidation_env

    def search(health=None):
        ctx, method, candidates, budgets = build_consolidation_env(40, "cuda")
        ctx.solver_config = SolverConfig(device="cuda", health=health)
        cmd = method.compute_command(candidates, budgets)
        return cmd.decision, sorted(c.name for c in cmd.candidates), \
            [[it.name for it in r.instance_type_options] for r in cmd.replacements]

    batched = search(SolverHealth(TestClock(), failure_threshold=1))
    health = SolverHealth(TestClock(), failure_threshold=1)
    _fault("SOLVER_SCENARIOS")
    assert search(health) == batched
    assert not health.allow_batched() and health.allow_kernel()
    with pytest.raises(faults.InjectedFault):
        search()


@pytest.mark.parametrize("kind", ["launch", "guard"])
def test_ladder_card_fault_propagates(cuda, no_faults, monkeypatch, kind):
    """A fault of the card's own, not injected, propagates with a ladder
    set and leaves it untouched: a launch error (each launch check raising
    after its kernel ran, so the context stays sound) or a guard rejection
    of the card's outputs; the search's batched rung likewise."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.faults.breaker import SolverHealth
    from karpenter_tpu_torch.faults.guard import SolverIntegrityError
    from karpenter_tpu_torch.solver.workloads import build_consolidation_env

    real = _build.launched

    def launched(name, rc, *a, **k):
        real(name, rc, *a, **k)
        raise _build.KernelLaunchError(f"{name}: launch error (not injected)")

    def verify(self, *a, **k):
        raise SolverIntegrityError(["claim fills negative (not injected)"])

    if kind == "launch":
        monkeypatch.setattr(_build, "launched", launched)
    else:
        monkeypatch.setattr(TorchSolver, "_verify_solution", verify)
    want = _build.KernelLaunchError if kind == "launch" else SolverIntegrityError
    health = SolverHealth(TestClock(), failure_threshold=1)
    with pytest.raises(want):
        _ladder_solve(cuda, mixed_pods(200), health=health, relax=False)
    ctx, method, candidates, budgets = build_consolidation_env(40, "cuda")
    ctx.solver_config = SolverConfig(device="cuda", health=health)
    with pytest.raises(want):
        method.compute_command(candidates, budgets)
    assert (health.allow_kernel(), health.allow_batched(), health.quarantines,
            health.level()) == (True, True, 0, 0)


def test_native_backend_equals_card(cuda):
    """backend="native" (the C++ host core) equals the card's exact route
    in slot order on the mixed batch."""
    pods = mixed_pods(500)
    card, _ = _ladder_solve(cuda, pods, relax=False)
    native, rung = _ladder_solve(cuda, pods, backend="native")
    assert native == card and rung == ("kernel", "ok")


# -- the solver sidecar on the card: the batch lane, concurrent tenants ------------


def _tenant_snaps(n_pods, n_types, tenants=4):
    """Each tenant's decoded solve request: ``mixed_pods(n_pods, seed=i)``
    renamed ``t<i>-mixed-<j>`` (no pod shared) over one NodePool object and
    ``n_types`` types, with no state nodes."""
    from karpenter_tpu_torch.solver import wire

    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}
    out = {}
    for i in range(1, tenants + 1):
        pods = mixed_pods(n_pods, seed=i)
        for j, p in enumerate(pods):
            p.metadata.name = f"t{i}-mixed-{j}"
            p.metadata.uid = f"uid-t{i}-mixed-{j}"
        out[f"t{i}"] = wire.encode_solve_request(
            pods, pools, its, solver_options={"reserved_capacity_enabled": False})
    return out


def _at_once(svc, requests):
    """Every tenant's solve from its own thread at once: each tenant's
    claims in slot order with its pod errors, or the exception it
    raised."""
    import threading

    from karpenter_tpu_torch.solver import wire

    out = {}

    def run(tid, req):
        try:
            r = svc.solve_for(tid, wire.decode_solve_request(req))
            out[tid] = (slots(r), sorted(r.pod_errors))
        except Exception as exc:
            out[tid] = exc

    threads = [threading.Thread(target=run, args=item) for item in requests.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    return out


def _serially(svc, requests):
    from karpenter_tpu_torch.solver import wire

    out = {}
    for tid, req in requests.items():
        r = svc.solve_for(tid, wire.decode_solve_request(req))
        out[tid] = (slots(r), sorted(r.pod_errors))
    return out


def _tenant_service(device, window=0.0, tenants=4):
    from karpenter_tpu_torch.solver.service import TenantService
    from karpenter_tpu_torch.solver.tenancy import TenantRegistry

    return TenantService(registry=TenantRegistry(clock=TestClock()),
                         config=SolverConfig(device=device), batch_window=window,
                         batch_max=tenants)


def test_tenant_batch_lane_one_scenario_dispatch(cuda):
    """Four tenants' same-shape solves batched into one union solve: one
    scenario dispatch of the kernels for all four (B1, the pack.cu grid,
    B6 over the scenarios), each tenant's answer its own solo card solve
    and the CPU union's."""
    from karpenter_tpu_torch import _build

    requests = _tenant_snaps(300, 40)
    svc = _tenant_service("cuda", window=2.0)
    _build.reset_launches()
    got = _at_once(svc, requests)
    launches, scen = dict(_build.launches), dict(_build.scenario_launches)
    assert svc.batcher.counts() == {"batched": 1, "declined": 0}
    assert scen["pack"] == 1 and launches["pack"] == 1
    assert launches["fresh_feasibility"] == 1 and scen["wire_pack"] == 1
    cpu_svc = _tenant_service("cpu", window=2.0)
    assert _at_once(cpu_svc, requests) == got
    assert cpu_svc.batcher.counts() == {"batched": 1, "declined": 0}
    assert _serially(_tenant_service("cuda"), requests) == got
    assert all(claims for claims, _ in got.values())


def test_tenant_batch_lane_launch_error_reaches_everyone(cuda, monkeypatch):
    """A launch error of the union solve, not injected, reaches all four
    participants; none is solved solo, the batch neither batched nor
    declined."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.solver.service import TenantService

    real = _build.launched

    def launched(name, rc, *a, **k):
        real(name, rc, *a, **k)
        raise _build.KernelLaunchError(f"{name}: launch error (not injected)")

    solo = []
    real_solo = TenantService._solve_solo
    monkeypatch.setattr(TenantService, "_solve_solo",
                        lambda self, t, s: solo.append(t.tenant_id) or real_solo(self, t, s))
    requests = _tenant_snaps(300, 40)
    svc = _tenant_service("cuda", window=2.0)
    monkeypatch.setattr(_build, "launched", launched)
    got = _at_once(svc, requests)
    monkeypatch.setattr(_build, "launched", real)
    assert sorted(got) == sorted(requests)
    assert all(isinstance(r, _build.KernelLaunchError) for r in got.values()), got
    assert solo == []
    assert svc.batcher.counts() == {"batched": 0, "declined": 0}


def test_concurrent_tenants_match_serial(cuda):
    """Four tenants solving on the card from four threads at once (the
    sidecar's worker pool) each get their serial answer, and the launch
    counters count every launch of the four (no update lost)."""
    from karpenter_tpu_torch import _build

    requests = _tenant_snaps(1000, 100)
    _build.reset_launches()
    serial = _serially(_tenant_service("cuda"), requests)
    serial_launches = dict(_build.launches)
    for _ in range(3):
        _build.reset_launches()
        assert _at_once(_tenant_service("cuda"), requests) == serial
        assert dict(_build.launches) == serial_launches
    assert serial_launches["pack"] >= 4


# -- the digital twin ----------------------------------------------------------


def test_twin_small_replay_matches_cpu(cuda):
    """The small chaos replay (tests/e2e/test_twin.py's shapes, run to
    minute 8 so that consolidation searches fire) on the card: the same
    canonical audit and fault log as the device="cpu" replay, every
    record on a kernel rung, the card's kernels launched (B7's grid
    among them), and no device memory held once the twin is closed."""
    import gc

    from karpenter_tpu_torch import _build

    import twin_cases as tc

    def replay(device):
        twin = tc.mod("karpenter_tpu_torch", "sim.twin").ClusterTwin(
            tc.small_trace("karpenter_tpu_torch"),
            profile=tc.small_profile("karpenter_tpu_torch"),
            config=tc.small_config("karpenter_tpu_torch", device=device, minutes=8),
            fault_rules=tc.chaos_plan("karpenter_tpu_torch"))
        with twin:
            twin.run()
            out = (twin.canonical_audit(), tuple(twin.fault_log()),
                   {r.rung for r in twin.audit.query()})
        tc.release_seams("karpenter_tpu_torch")
        return out

    gc.collect()
    before = torch.cuda.memory_allocated()
    _build.reset_launches()
    card = replay("cuda")
    torch.cuda.synchronize()
    counts, scen = dict(_build.launches), dict(_build.scenario_launches)
    gc.collect()
    assert torch.cuda.memory_allocated() <= before
    assert card[:2] == replay("cpu")[:2]
    assert card[1] and card[2] <= {"kernel", "batched"}
    for kernel in ("fresh_feasibility", "existing_feasibility", "pack", "wire_pack"):
        assert counts[kernel] > 0, counts
    assert scen["pack"] > 0, scen


# -- the solver mesh (B10): B1's and B2's partial modes, the fold --------------
#
# mesh_partials makes one sparse_index_case's partials as the mesh cuts it
# (T padded to the model shards, the live pairs to the data shards); on the
# CPU tests/test_torch_mesh.py holds them, folded, against JAX's tables.


def mesh_partials(a, D, M, zk, ck, device):
    """Every (data, model) shard's partials of the case ``a`` over its
    slices on ``device``, written as the mesh writes them into one stacked
    buffer per input (``out=`` slices) — fresh (fail_t, fail_c, tonly,
    n_fit) in (data, model) order and existing (nfail, cap) per data shard
    — and the fold's stacked inputs: (shards, fold args)."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.parallel import mesh as pm
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

    m = pm.make_mesh(D * M, data=D, devices=["cpu"] * (D * M))
    # the scan's arguments are not read: empty stand-ins
    args = [a[n] if n in a else np.zeros((1, 0) if n == "a_res" else (0,), np.int32)
            for n in SOLVE_ARG_NAMES]
    pieces = pm.shard_args(pm.pad_args_for_mesh(args, m), m)
    t = {k: {n: torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for n, x in zip(SOLVE_ARG_NAMES, v)} for k, v in pieces.items()}
    whole = t[0, 0, 0]
    P, G = whole["p_tol"].shape
    N = whole["n_avail"].shape[0]
    slab = (M, P, G, t[0, 0, 0]["t_alloc"].shape[0])
    i32 = torch.int32
    fail_t = torch.empty((D,) + slab, dtype=i32, device=device)
    fail_c = torch.empty((D, P, G), dtype=i32, device=device)
    tonly = torch.empty(slab, dtype=torch.bool, device=device)
    n_fit = torch.empty(slab, dtype=i32, device=device)
    nfail = torch.empty((D, N, G), dtype=i32, device=device)
    cap = torch.empty((N, G), dtype=i32, device=device)
    shards = []
    for d in range(D):
        base = d == 0
        for mi in range(M):
            out = feas.fresh_claim_feasibility_partial(
                *(t[0, d, mi][n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck, with_base=base,
                out=(fail_t[d, mi], fail_c[d], tonly[mi] if base else None,
                     n_fit[mi] if base else None))
            shards.append(("fresh", d, mi, out))
        out = feas.existing_node_feasibility_partial(
            *(t[0, d, 0][n] for n in B2_NAMES if n != "n_tol"), with_base=base,
            out=(nfail[d], cap if base else None))
        shards.append(("existing", d, 0, out))
    return shards, (fail_t, fail_c, tonly, n_fit, whole["p_tol"], nfail, cap, whole["n_tol"])


@pytest.mark.parametrize("case", ["padding-interleaved", "two-templates", "scenario-axis",
                                  "vocab-2048"])
@pytest.mark.parametrize("data", [1, 2, 8])
def test_mesh_partials_and_fold(cuda, case, data, monkeypatch):
    """B1's and B2's partial modes on every shard, and one fold launch
    over them, equal their plain versions exactly (junk-filled outputs
    underneath); the fold equals B1's and B2's own tables on the whole
    input."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas

    _junk_empty(monkeypatch)
    a, zk, ck = sparse_index_case(case)
    D, M = data, 8 // data
    _build.reset_launches()
    got_shards, fold_args = mesh_partials(a, D, M, zk, ck, cuda)
    assert _build.launches["fresh_partial"] == D * M
    assert _build.launches["existing_partial"] == D
    want_shards, want_args = mesh_partials(a, D, M, zk, ck, "cpu")
    for (kind, d, mi, got), (_, _, _, want) in zip(got_shards, want_shards):
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g is None) == (w is None), (kind, d, mi, i)
            if g is not None:
                np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                              err_msg=f"{kind}[{d},{mi}] output {i}")
    folded = feas.mesh_fold(*fold_args)
    assert _build.launches["mesh_fold"] == 1
    want = feas.mesh_fold_reference(*want_args)
    for name, g, w in zip(("compat_pg", "type_ok", "n_fit", "cap_ng"), folded, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=name)
    T = a["t_alloc"].shape[0]
    whole = feas.fresh_claim_feasibility_sparse(*_on(a, B1_NAMES, cuda), zone_kid=zk, ct_kid=ck)
    for name, g, w in zip(("compat_pg", "type_ok", "n_fit"), folded, whole):
        g = g[:, :, :T] if g.dim() == 3 else g
        assert torch.equal(g, w), name
    assert torch.equal(folded[3], feas.existing_node_feasibility_sparse(*_on(a, B2_NAMES, cuda)))


def test_mesh_fold_gathers_final_parts(cuda):
    """With no data shard (D = 0: the dense route's B3 type slices) the
    fold gathers the model shards' final tables at their type offsets."""
    from karpenter_tpu_torch.ops import feasibility as feas

    rng = np.random.default_rng(4)
    P, G, Tm, M = 2, 5, 7, 3
    tonly = torch.from_numpy(rng.random((M, P, G, Tm)) < 0.5)
    n_fit = torch.from_numpy(rng.integers(0, 9, (M, P, G, Tm)).astype(np.int32))
    compat = torch.from_numpy(rng.random((P, G)) < 0.7)
    want = feas.mesh_fold_reference(None, None, tonly, n_fit, compat)
    got = feas.mesh_fold(None, None, tonly.to(cuda), n_fit.to(cuda), compat.to(cuda))
    assert got[3] is None and want[3] is None
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def _fold_inputs(rng, D, M, P, G, Tm, N=0, S=0, wide=False):
    """Random stacked fold inputs: int32 counts (full-range, so the sums
    wrap, with ``wide``; else mostly zero, so cells pass) and gates."""
    def counts(shape):
        if wide:
            return torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                                    .astype(np.int32))
        return torch.from_numpy((rng.random(shape) < 0.1).astype(np.int32)
                                * rng.integers(-2, 3, shape).astype(np.int32))

    fold = [counts((D, M, P, G, Tm)), counts((D, P, G)),
            torch.from_numpy(rng.random((M, P, G, Tm)) < 0.8),
            torch.from_numpy(rng.integers(0, 50, (M, P, G, Tm)).astype(np.int32)),
            torch.from_numpy(rng.random((P, G)) < 0.9)]
    if not N:
        return fold
    n_tol = torch.from_numpy(rng.random((S, N, G) if S > 1 else (N, G)) < 0.8)
    return fold + [counts((D, N, G)),
                   torch.from_numpy(rng.integers(0, 9, (N, G)).astype(np.int32)), n_tol]


@pytest.mark.parametrize("case", [
    # (D, M, P, G, Tm, N, S, wide): T/M a multiple of 4 (the vector path)
    # or not (a cell a thread), D = 3 and past one chunk of 8 partials,
    # sums that wrap, a node region with S > 1 and N * G not a multiple of 4
    (8, 1, 1, 256, 800, 0, 0, False),
    (3, 2, 2, 9, 13, 5, 1, False),
    (3, 4, 1, 16, 100, 16, 4, True),
    (11, 2, 2, 7, 6, 3, 3, True),
    (2, 4, 3, 33, 8, 7, 2, False),
])
def test_mesh_fold_stacked_shapes(cuda, case):
    """The fold over random stacked partials equals its plain version
    exactly, on both of its paths (4 cells a thread and a cell a thread),
    with wrapping sums and a scenario-gated node region, one launch."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas

    D, M, P, G, Tm, N, S, wide = case
    ins = _fold_inputs(np.random.default_rng(sum(case[:7])), D, M, P, G, Tm, N, S, wide)
    want = feas.mesh_fold_reference(*ins)
    _build.reset_launches()
    got = feas.mesh_fold(*(x.to(cuda) for x in ins))
    assert _build.launches["mesh_fold"] == 1
    assert (got[3] is None) == (N == 0)
    for name, g, w in zip(("compat_pg", "type_ok", "n_fit", "cap_ng"), got, want):
        if w is not None:
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(), err_msg=name)


def test_mesh_fold_unaligned_views(cuda):
    """Stacked inputs that are contiguous views at an offset no vector
    divides take the cell-a-thread path and fold the same."""
    from karpenter_tpu_torch.ops import feasibility as feas

    D, M, P, G, Tm = 3, 2, 1, 8, 16
    ins = _fold_inputs(np.random.default_rng(6), D, M, P, G, Tm)
    want = feas.mesh_fold_reference(*ins)
    shifted = []
    for x in ins:
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        view = flat[1:].view(x.shape)
        view.copy_(x.to(cuda))
        shifted.append(view)
    got = feas.mesh_fold(*shifted)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_mesh_fold_refuses_too_many_shards(cuda):
    from karpenter_tpu_torch.ops import feasibility as feas

    one = torch.zeros((65, 1, 1, 1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shards"):
        feas.mesh_fold(one, one[:, 0, 0], one[0].bool(), one[0],
                       torch.ones((1, 1), dtype=torch.bool, device=cuda))


def test_mesh_fold_checks_each_stacked_input(cuda):
    """A stacked input of the wrong shape, dtype or layout is refused by
    name before the launch."""
    from karpenter_tpu_torch.ops import feasibility as feas

    ins = [x.to(cuda) for x in _fold_inputs(np.random.default_rng(7), 2, 2, 1, 4, 8)]
    bad = list(ins)
    bad[0] = ins[0][:, :1].contiguous()
    with pytest.raises(ValueError, match="fail_t"):
        feas.mesh_fold(*bad)
    bad = list(ins)
    bad[3] = ins[3].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="n_fit"):
        feas.mesh_fold(*bad)


@pytest.mark.parametrize("data", [8, 2])
def test_mesh_solve_on_one_card(cuda, data):
    """The sharded solve over 8 positions of one card: the outputs of the
    packed mesh solve equal the single-device dispatch's on the same
    padded args, D x M fresh partials, D existing ones, one fold, B4 and
    B6 once."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.solve import solve_core_packed
    from karpenter_tpu_torch.parallel import mesh as pm
    from karpenter_tpu_torch.solver.args import to_device_args

    args, statics = _snapshot(mixed_pods(300), n_types=40, n_nodes=6)
    statics = dict(statics, sparse_groups=True)
    m = pm.make_mesh(8, data=data, devices=[cuda] * 8)
    padded = pm.pad_args_for_mesh(args, m)
    fn = pm.sharded_solve_packed_fn(m, torch.int32, **statics)
    margs = pm.place_args(padded, m)
    _build.reset_launches()
    got = fn(margs)
    counts = dict(_build.launches)
    want = solve_core_packed(*to_device_args(padded, cuda), fills_dtype=torch.int32, **statics)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    D, M = data, 8 // data
    assert counts["fresh_partial"] == D * M and counts["existing_partial"] == D
    assert counts["mesh_fold"] == 1 and counts["pack"] == 1 and counts["wire_pack"] == 1
    assert counts["fresh_feasibility"] == 0 and counts["existing_feasibility"] == 0


def test_mesh_row_apply_on_one_card(cuda):
    """The shard-local row apply on 8 blocks of one card: one B8 launch
    per shard with a row to change, the blocks equal the full update."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops.solve import delta_apply_rows_sharded

    rng = np.random.default_rng(5)
    host = rng.standard_normal((64, 4)).astype(np.float32)
    idx = np.asarray([0, 5, 9, 17, 33, 34, 63], np.int32)
    rows = rng.standard_normal((len(idx), 4)).astype(np.float32)
    pieces = [torch.from_numpy(host[j * 8:(j + 1) * 8].copy()).to(cuda) for j in range(8)]
    _build.reset_launches()
    out = delta_apply_rows_sharded(pieces, idx, rows)
    assert _build.launches["apply_rows"] == len({int(i) // 8 for i in idx})
    want = host.copy()
    want[idx] = rows
    np.testing.assert_array_equal(torch.cat(out).cpu().numpy(), want)
