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
1,000 x 400 solve on the card against the CPU.

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
            sorted((tuple(sorted(p.metadata.name for p in c.pods)),
                    tuple(it.name for it in c.instance_type_options))
                   for c in r.new_node_claims),
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
        sig = sorted((tuple(sorted(p.uid for p in c.pods)),
                      tuple(it.name for it in c.instance_type_options))
                     for c in r.new_node_claims)
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


def _classed_snapshot(pods, n_types=30, n_nodes=0, nmax=None):
    """The padded solve args (G to the next power of two, as the driver
    pads them: padding classes), statics and class partition of ``pods``
    over ``n_nodes`` zoned state nodes, encoded by the port."""
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}
    nodes = example_state_nodes(n_nodes)
    topo = Topology(Client(TestClock()), nodes, pools, its, pods)
    solver = TorchSolver(pools, its, topo, state_nodes=nodes,
                         config=SolverConfig(device="cpu"))
    groups, rest = enc.partition_and_group(pods, topology=topo)
    assert not rest
    snap, avail, *_ = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    N = enc._next_pow2(len(snap.existing_names), floor=1) if snap.existing_names else 0
    run = snap.padded(G, N)
    statics = solver._kernel_statics(snap, G)
    statics["nmax"] = nmax or solver._estimate_nmax(snap, solver._fit_matrix(snap))
    return run.solve_args(*avail), statics, enc.class_partition(run)


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
        return (sorted((tuple(sorted(p.metadata.name for p in c.pods)),
                        tuple(it.name for it in c.instance_type_options))
                       for c in r.new_node_claims), sorted(r.pod_errors))

    _build.reset_launches()
    got = solve("cuda")
    assert _build.launches["pack_classed"] >= 1 and _build.launches["pack"] == 0
    assert got == solve("cpu") and got[0]
