"""Port parity for minValues floors (MV > 0), on the CPU.

A NodePool requirement with ``minValues`` (instance-family ``Exists`` with
``min_values=2``, say) keeps every claim of the pool flexible across at
least that many distinct values of the key. The JAX package counts the
values densely (karpenter_tpu/ops/packing.py:minvalues_cap) inside both
scans; the port's plain versions must equal it exactly:

(a) ``minvalues_cap`` against JAX's over seeded numpy inputs: floors of
    0 (no cap), floors above the value axis W (cap 0), ties;
(b) ``pack_reference`` (kernel B4's plain version) and
    ``pack_classed_reference`` (B5's) against JAX ``pack`` and
    ``pack_classed`` over minValues pools, every output, with and without
    domains, contributors and existing nodes, and the scenario-batched
    solve against JAX's vmapped one;
(c) ``TorchSolver(device="cpu")`` against ``TpuSolver``, claims in slot
    order, on the minValues cases of tests/test_instance_selection.py and
    tests/test_dense_constraints.py (objects rebuilt through
    ``test_torch_residency.to_port``);
(d) consolidation over a minValues pool at 200 nodes against the JAX
    methods.

Tolerance: exact equality throughout.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from helpers import make_nodepool, make_pods, make_state_node
from karpenter_tpu.api.objects import NodeSelectorRequirement
from karpenter_tpu.cloudprovider import corpus
from karpenter_tpu.solver.workloads import (
    constrained_mix, diverse_reference_mix, mixed_pods,
)

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")
OUT_NAMES = ("c_pool", "c_tmask", "n_open", "overflow", "exist_fills",
             "claim_fills", "unplaced", "c_dzone", "c_dct", "c_resv")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def mv_pool(key=corpus.INSTANCE_FAMILY_LABEL, op="Exists", values=(), floor=2, **kw):
    """A NodePool (JAX objects) whose one requirement carries a minValues
    floor."""
    return make_nodepool(requirements=[
        NodeSelectorRequirement(key, op, tuple(values), min_values=floor)], **kw)


def two_key_pool():
    return make_nodepool(requirements=[
        NodeSelectorRequirement(corpus.INSTANCE_FAMILY_LABEL, "In", ("c", "m", "r"),
                                min_values=2),
        NodeSelectorRequirement(corpus.INSTANCE_CPU_LABEL, "Exists", (), min_values=3),
    ])


# -- (a) minvalues_cap ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_minvalues_cap_matches_jax(seed):
    """Seeded [B, T] masks and fits over a [T, MV, W] value table: floors
    drawn from 0..W+2 (0 and > W included), fits from a few values (ties
    within and across values), some types offering no value of a key and
    some several."""
    import jax.numpy as jnp
    from karpenter_tpu.ops.packing import minvalues_cap as jax_cap
    from karpenter_tpu_torch.ops.packing import minvalues_cap

    rng = np.random.default_rng(seed)
    B, T, MV, W = 7, int(rng.integers(3, 40)), int(rng.integers(1, 4)), int(2 ** rng.integers(0, 6))
    tmask = rng.random((B, T)) < 0.6
    fit = rng.choice([0, 1, 2, 3, 5, 8, 2**30], size=(B, T)).astype(np.int32)
    floors = rng.integers(0, W + 3, size=(B, MV)).astype(np.int32)
    floors[0] = 0  # a row with no floor at all
    t_mvoh = rng.random((T, MV, W)) < (1.5 / W)
    want = np.asarray(jax_cap(jnp.asarray(tmask), jnp.asarray(fit), jnp.asarray(floors),
                              jnp.asarray(t_mvoh)))
    got = minvalues_cap(torch.from_numpy(tmask), torch.from_numpy(fit),
                        torch.from_numpy(floors), torch.from_numpy(t_mvoh))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[0]) == 2**28  # floors of 0 impose no cap


def test_minvalues_cap_floor_above_w_and_ties():
    """A floor above W caps at 0; the k-th largest counts tied values once
    per value."""
    from karpenter_tpu_torch.ops.packing import minvalues_cap

    t_mvoh = torch.zeros((4, 1, 4), dtype=torch.bool)
    for t, w in enumerate((0, 1, 1, 2)):
        t_mvoh[t, 0, w] = True
    fit = torch.tensor([[5, 3, 7, 3]], dtype=torch.int32)
    tm = torch.ones((1, 4), dtype=torch.bool)
    cap = lambda fl: int(minvalues_cap(tm, fit, torch.tensor([[fl]], dtype=torch.int32), t_mvoh))
    # per-value fits: w0 5, w1 7, w2 3, w3 0
    assert [cap(f) for f in (1, 2, 3, 4, 5)] == [7, 5, 3, 0, 0]


# -- (b) the plain scans against JAX's --------------------------------------------


def snapshot(pods, pools=None, its=None, state_nodes=(), n_types=20, **solver_kw):
    """The JAX encoding of ``pods`` over ``pools`` (JAX objects): named
    padded solve args (numpy), the kernel statics and the forced class
    partition."""
    from karpenter_tpu.kube import Client, TestClock
    from karpenter_tpu.scheduling.topology import Topology
    from karpenter_tpu.solver import TpuSolver
    from karpenter_tpu.solver import encode as enc

    pools = pools or [mv_pool()]
    its = corpus.generate(n_types) if its is None else its
    its_by_pool = {p.name: list(its) for p in pools}
    topo = Topology(Client(TestClock()), list(state_nodes), pools, its_by_pool, pods)
    solver = TpuSolver(pools, its_by_pool, topo, state_nodes=list(state_nodes), **solver_kw)
    groups, rest = enc.partition_and_group(
        pods, topology=topo,
        merge_bootstrap_affinity=not solver.oracle.reserved_capacity_enabled)
    assert not rest, "the batch must tensorize fully"
    snap, avail, *_ = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    N = enc._next_pow2(len(snap.existing_names), floor=1) if snap.existing_names else 0
    run = snap.padded(G, N)
    statics = solver._kernel_statics(snap, G)
    a = dict(zip(enc.SOLVE_ARG_NAMES, run.solve_args(*avail)))
    return a, statics, enc.class_partition(run)


def assert_pack_equal(j, t):
    """JAX pack's (state, fills...) against the port's 10 outputs."""
    from test_torch_classed import _assert_equal

    js, jf = j[0], j[1:]
    want = (js.c_pool, js.c_tmask, js.n_open, js.overflow, *jf, js.c_dzone,
            js.c_dct, js.c_resv)
    for name, jx, tx in zip(OUT_NAMES, want, t):
        _assert_equal(name, jx, tx)


def _nodes(n, cpu="4", memory="16Gi"):
    return [make_state_node(name=f"mvn-{i}", cpu=cpu, memory=memory,
                            zone=corpus.DEFAULT_ZONES[i % 3]) for i in range(n)]


# (pods, pools, state nodes, catalog size). corpus.generate(20) holds the
# c family and m-1x only, so a floor of 2 over instance-family caps every
# claim at what m-1x fits; 2-CPU pods fit no m type, so their template
# misses its floor and they stay unplaced
PACK_CASES = {
    # domain-free; a second template without floors; two floored keys
    "mixed": lambda: (mixed_pods(300, gpu_fraction=0.0), [mv_pool()], (), 30),
    "mixed-two-keys": lambda: (mixed_pods(200, gpu_fraction=0.0), [two_key_pool()], (), 40),
    "mixed-two-pools": lambda: (
        mixed_pods(200), [mv_pool(name="mv", weight=50), make_nodepool(name="open")], (), 30),
    "in-three-families": lambda: (
        make_pods(40, cpu="1"), [mv_pool(op="In", values=("c", "m", "r"), floor=3)], (), 40),
    "cap-binds": lambda: (make_pods(30, cpu="250m"), [mv_pool()], (), 20),
    "unsatisfiable": lambda: (make_pods(12, cpu="2"), [mv_pool()], (), 20),
    # has_domains (zonal spread), existing nodes
    "constrained": lambda: (constrained_mix(300), [mv_pool()], (), 30),
    "constrained-nodes": lambda: (constrained_mix(200), [mv_pool()], _nodes(4), 30),
    # has_contrib and domains (the diverse mix on the per-group scan)
    "diverse": lambda: (diverse_reference_mix(150), [mv_pool()], (), 30),
    "mixed-nodes": lambda: (mixed_pods(200, gpu_fraction=0.0), [mv_pool()], _nodes(3), 30),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_reference_matches_jax(case):
    """pack_reference == JAX pack over a minValues pool: the 10 outputs."""
    from test_torch_classed import _both_scans

    pods, pools, nodes, n_types = PACK_CASES[case]()
    a, statics, _ = snapshot(pods, pools, state_nodes=nodes, n_types=n_types)
    assert a["p_mvmin"].shape[1] > 0 and a["p_mvmin"].any()
    j, t = _both_scans(a, statics, nmax=128)
    assert_pack_equal(j, t)
    if case == "unsatisfiable":
        assert int(np.asarray(j[0].n_open)) == 0 and int(np.asarray(j[3]).sum()) == 12
    else:
        assert int(np.asarray(j[0].n_open)) > 0
    if case.startswith("constrained") or case == "diverse":
        assert statics["has_domains"]
    if nodes:
        assert int(np.asarray(j[1]).sum()) > 0, "no existing-node fill"


CLASSED_CASES = {
    "diverse": lambda: (diverse_reference_mix(300), (), 30, 64),
    "diverse-nodes": lambda: (diverse_reference_mix(120), _nodes(4, cpu="8"), 30, 64),
    "diverse-overflow": lambda: (diverse_reference_mix(200), (), 30, 8),
    "mixed-domain-free": lambda: (mixed_pods(300), (), 30, 64),
}


@pytest.mark.parametrize("case", list(CLASSED_CASES))
def test_pack_classed_reference_matches_jax(case):
    """pack_classed_reference == JAX pack_classed over a minValues pool:
    every field of the final PackState, the fills and the unplaced
    counts."""
    from karpenter_tpu_torch.ops.packing import PackState
    from test_torch_classed import _assert_equal, _both_scans

    pods, nodes, n_types, nmax = CLASSED_CASES[case]()
    a, statics, classes = snapshot(pods, [mv_pool()], state_nodes=nodes, n_types=n_types)
    j, t = _both_scans(a, statics, nmax=nmax, classes=classes)
    for f in PackState._fields:
        _assert_equal(f, getattr(j[0], f), getattr(t[0], f))
    for name, jx, tx in zip(("exist_fills", "claim_fills", "unplaced"), j[1:], t[1:]):
        _assert_equal(name, jx, tx)
    assert statics["has_domains"] == case.startswith("diverse")
    if case == "diverse-overflow":
        assert bool(j[0].overflow)


@pytest.mark.parametrize("S,real", [(8, 5), (16, 11)])
def test_scenario_batch_matches_jax(S, real):
    """B7's plain version over a minValues pool and 6 state nodes: seeded
    per-scenario group counts and removed nodes, against JAX's vmapped
    solve_all_scenarios_packed, every output of every scenario."""
    from karpenter_tpu_torch.ops.solve import solve_scenarios_core_packed
    from karpenter_tpu_torch.solver.args import to_device_args
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from test_torch_scenarios import _assert_outputs_equal, _jax_scenarios

    a, statics, _ = snapshot(mixed_pods(200, gpu_fraction=0.0), [mv_pool()],
                             state_nodes=_nodes(6))
    G, (N, _) = a["g_count"].shape[0], a["n_tol"].shape
    rng = np.random.default_rng(S)
    g_count_s = np.zeros((S, G), np.int32)
    n_tol_s = np.zeros((S, N, G), bool)
    for si in range(real):
        g_count_s[si] = rng.integers(0, a["g_count"] + 1)
        n_tol_s[si] = a["n_tol"] & (rng.random(N) < 0.7)[:, None]
    args = dict(a, g_count=g_count_s, n_tol=n_tol_s)
    args = to_device_args([args[n] for n in SOLVE_ARG_NAMES], "cpu")
    st = {k: v for k, v in statics.items() if k != "nmax"}
    port = solve_scenarios_core_packed(*args, nmax=64, fills_dtype=torch.int32,
                                       batch_topo=False, **st)
    _assert_outputs_equal(port, _jax_scenarios(args, st, 64, torch.int32, False))
    assert int(port[2][:real].max()) > 0 and (port[2][real:] == 0).all()


# -- (c) TorchSolver against TpuSolver, claims in slot order ----------------------


def _diverse_catalog(pkg):
    """tests/test_instance_selection.py:diverse_catalog for either package."""
    labels, corp = _mod(pkg, "api.labels"), _mod(pkg, "cloudprovider.corpus")
    return [corp.make_instance_type(f, c, arch=arch, os=os)
            for f in ("c", "m", "r") for c in (2, 4, 8, 16)
            for arch in (labels.ARCHITECTURE_AMD64, labels.ARCHITECTURE_ARM64)
            for os in ("linux", "windows")]


def _req(key, op, values, floor):
    return NodeSelectorRequirement(key, op, tuple(values), min_values=floor)


FAM, CPU = corpus.INSTANCE_FAMILY_LABEL, corpus.INSTANCE_CPU_LABEL
# (pools, catalog, pods): tests/test_instance_selection.py:TestMinValues and
# tests/test_dense_constraints.py:TestMinValuesPartialReach, as JAX objects
SOLVER_CASES = {
    "in-spans-families": lambda: (
        [make_nodepool(requirements=[_req(FAM, "In", ("c", "m", "r"), 2)])],
        "diverse", make_pods(4, cpu="1")),
    "in-unsatisfiable": lambda: (
        [make_nodepool(requirements=[_req(FAM, "In", ("c", "m", "r"), 4)])],
        "diverse", make_pods(2, cpu="1")),
    "gt": lambda: (
        [make_nodepool(requirements=[_req(CPU, "Gt", ("2",), 2)])],
        "diverse", make_pods(2, cpu="1")),
    "gt-unsatisfiable": lambda: (
        [make_nodepool(requirements=[_req(CPU, "Gt", ("8",), 2)])],
        [("c", c) for c in (2, 4, 8, 16)], make_pods(2, cpu="1")),
    "lt": lambda: (
        [make_nodepool(requirements=[_req(CPU, "Lt", ("16",), 3)])],
        "diverse", make_pods(2, cpu="1")),
    "lt-unsatisfiable": lambda: (
        [make_nodepool(requirements=[_req(CPU, "Lt", ("4",), 2)])],
        [("c", c) for c in (2, 4, 8)], make_pods(2, cpu="1")),
    "max-of-same-key": lambda: (
        [make_nodepool(requirements=[_req(FAM, "In", ("c", "m", "r"), 1),
                                     _req(FAM, "NotIn", ("g",), 3)])],
        "diverse", make_pods(2, cpu="1")),
    "multiple-keys": lambda: (
        [make_nodepool(requirements=[_req(FAM, "In", ("c", "m", "r"), 2),
                                     _req(CPU, "Exists", (), 3)])],
        "diverse", make_pods(2, cpu="1")),
    "partial-reach": lambda: _partial_reach(),
    "unsatisfiable-floor": lambda: (
        [make_nodepool(requirements=[_req(FAM, "In", ("c",), 3)])],
        [("c", c) for c in (2, 4)], make_pods(2, cpu="1")),
    "exists-mixed-300": lambda: ([mv_pool()], 30, mixed_pods(300, gpu_fraction=0.0)),
    "exists-constrained-200": lambda: ([mv_pool()], 30, constrained_mix(200)),
    "exists-diverse-150": lambda: ([mv_pool()], 30, diverse_reference_mix(150)),
}


def _partial_reach():
    from karpenter_tpu.api.objects import Taint, Toleration

    pools = [
        make_nodepool(name="mv", weight=10,
                      taints=[Taint(key="team", value="x", effect="NoSchedule")],
                      requirements=[_req(FAM, "Exists", (), 2)]),
        make_nodepool(name="open"),
    ]
    pods = make_pods(6, cpu="1") + make_pods(
        3, cpu="1", tolerations=[Toleration(key="team", operator="Exists")])
    return pools, 16, pods


def _catalog(pkg, spec):
    corp = _mod(pkg, "cloudprovider.corpus")
    if spec == "diverse":
        return _diverse_catalog(pkg)
    if isinstance(spec, int):
        return corp.generate(spec)
    return [corp.make_instance_type(f, c) for f, c in spec]


def solve_both(pools, catalog, pods, state_nodes=(), classed=None, **solver_kw):
    """TpuSolver and TorchSolver(device="cpu") over the same JAX-built
    batch (the port's objects through to_port). Returns ({pkg: signature},
    {pkg: Results})."""
    from test_torch_residency import port_state_node, signature, to_port

    sigs, results = {}, {}
    for pkg in PKGS:
        tpkg = pkg == "karpenter_tpu_torch"
        conv = to_port if tpkg else (lambda x: x)
        drv = _mod(pkg, "solver.driver")
        ps = [conv(p) for p in pools]
        its = {p.name: _catalog(pkg, catalog) for p in ps}
        nodes = [port_state_node(sn) if tpkg else sn for sn in state_nodes]
        batch = [conv(p) for p in pods]
        kube = _mod(pkg, "kube")
        topo = _mod(pkg, "scheduling.topology").Topology(
            kube.Client(kube.TestClock()), nodes, ps, its, batch)
        cfg = dict(classed=classed, device="cpu") if tpkg else dict(classed=classed)
        cls = drv.TorchSolver if tpkg else drv.TpuSolver
        solver = cls(ps, its, topo, state_nodes=nodes, config=drv.SolverConfig(**cfg),
                     encode_cache=drv.EncodeCache(), **solver_kw)
        results[pkg] = solver.solve(batch)
        sigs[pkg] = signature(results[pkg])
        assert solver.fallback_solves == 0, solver.last_fallback_reasons
    return sigs, results


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_equals_tpu_solver(case):
    pools, catalog, pods = SOLVER_CASES[case]()
    sigs, results = solve_both(pools, catalog, pods)
    assert sigs["karpenter_tpu_torch"] == sigs["karpenter_tpu"]
    res = results["karpenter_tpu_torch"]
    if "unsatisfiable" in case:
        assert res.pod_errors and not res.new_node_claims
    else:
        assert res.new_node_claims and not res.pod_errors


@pytest.mark.parametrize("classed", [True, False], ids=["classed", "per-group"])
def test_diverse_routes_equal_tpu_solver(classed):
    """The diverse mix over a minValues pool: forced onto the class-batched
    scan (B5 with minValues) and onto the per-group scan (B4 with
    contributors and minValues), TorchSolver decides as TpuSolver does."""
    sigs, results = solve_both([mv_pool()], 30, diverse_reference_mix(200), classed=classed)
    assert sigs["karpenter_tpu_torch"] == sigs["karpenter_tpu"]
    assert results["karpenter_tpu_torch"].new_node_claims


def test_scenarios_equal_tpu_solver():
    """solve_scenarios over a minValues pool: the scenario batch (B7 with
    minValues) decides as TpuSolver's does, scenario by scenario."""
    from test_torch_scenarios import _results_by_name
    from test_torch_solver import _build

    got = {}
    for pkg in PKGS:
        Scenario = _mod(pkg, "solver.driver").Scenario
        solver, pods = _build(pkg, "constrained_mix", 200, 20, pools="minvalues")
        results = solver.solve_scenarios([Scenario(pods=pods), Scenario(pods=pods[:50]),
                                          Scenario(pods=pods[100:])])
        assert results is not None and solver.fallback_solves == 0
        got[pkg] = [_results_by_name(r, pkg, None) for r in results]
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]


# -- (d) consolidation over a minValues pool --------------------------------------


def minvalues_consolidation_env(pkg, n_nodes, **kw):
    """build_consolidation_env(n_nodes) of ``pkg`` with its NodePool
    carrying an instance-family Exists requirement with minValues 2 (the
    pool object is shared by the cluster and the scenario solvers, so the
    requirement is set before the first probe)."""
    objs = _mod(pkg, "api.objects")
    corp = _mod(pkg, "cloudprovider.corpus")
    ctx, method, candidates, budgets = _mod(pkg, "solver.workloads").build_consolidation_env(
        n_nodes, **kw)
    pool = ctx.client.list(objs.NodePool)[0]
    pool.spec.template.spec.requirements = [
        objs.NodeSelectorRequirement(corp.INSTANCE_FAMILY_LABEL, "Exists", (), min_values=2)]
    return ctx, method, candidates, budgets


def test_consolidation_equals_jax():
    """MultiNodeConsolidation at 200 nodes over the minValues pool: the
    port's command equals the JAX method's, in as many probes and
    dispatches, with no sequential fallback."""
    from test_torch_scenarios import _command_signature

    got = {}
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
        ctx, m, candidates, budgets = minvalues_consolidation_env(pkg, 200, **kw)
        cmd = m.compute_command(candidates, budgets)
        got[pkg] = (_command_signature(cmd), m.last_probes, m.last_dispatches)
        if pkg == "karpenter_tpu_torch":
            solvers = [e["solver"] for e in ctx.scenario_envs._entries.values()]
            assert solvers and all(s.fallback_solves == 0 for s in solvers)
            assert all(s.oracle.templates[0].requirements.has_min_values() for s in solvers)
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert got["karpenter_tpu"][1] > 0
