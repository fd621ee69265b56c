"""Port parity for consolidation's scenario axis (kernel B7), on the CPU.

The JAX package is the reference; both packages build the same seeded
clusters from their own object models, and everything is compared by
name (the two packages mint uids from separate counters):

(a) the plain scenario-batched solve (ops/solve.py:
    solve_scenarios_core_packed: B1 once, B2 [S], B4 per scenario, B6 over
    S rows) equals JAX's vmapped ``solve_all_scenarios_packed`` exactly,
    every output of every scenario, padded scenarios included;
(b) ``TorchSolver(device="cpu").solve_scenarios`` equals
    ``TpuSolver.solve_scenarios`` scenario by scenario, and the port's own
    per-subset ``simulate_scheduling``; scenarios stay fill-isolated;
(c) Multi- and SingleNodeConsolidation decide as the JAX methods do at
    BASELINE config[3]'s shape cut to 200 nodes, in as many probes and
    dispatches, with no sequential fallback;
(d) a zonal-spread scenario batch decides as JAX's does, over the
    default pool and over a minValues pool.
"""

import importlib
import random

import numpy as np
import pytest
import torch

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _env(pkg, n_nodes, seed, pods_per_node=(1, 2), pending=0, n_types=40,
         pod_cpus=(250, 500, 750, 1200), pod_mems=(256, 512, 1024),
         device="cpu"):
    """tests/test_scenario_batch.py:build_env for either package: a seeded
    consolidatable cluster of a mid-priced type, each node holding a
    random set of small pods, plus optional pending pods. The port's
    simulations run on ``device``."""
    objs = _mod(pkg, "api.objects")
    labels = _mod(pkg, "api.labels")
    res = _mod(pkg, "api.resources")
    kube = _mod(pkg, "kube")
    corpus = _mod(pkg, "cloudprovider.corpus")
    mi = 2**20 * res.MILLI
    rng = random.Random(seed)
    clock = kube.TestClock()
    clock.step(3600.0)
    client = kube.Client(clock)
    its = corpus.generate(n_types)
    provider = _mod(pkg, "cloudprovider.kwok").KwokCloudProvider(client, its)
    cluster = _mod(pkg, "controllers.state").Cluster(client)
    pool = objs.NodePool(
        metadata=objs.ObjectMeta(name="default"),
        spec=objs.NodePoolSpec(
            template=objs.NodeClaimTemplate(spec=objs.NodeClaimSpec())
        ),
    )
    pool.spec.disruption.consolidate_after = 10.0
    client.create(pool)
    sized = sorted(
        (it for it in its if it.capacity.get(res.CPU, 0) >= 4000
         and it.capacity.get(res.MEMORY, 0) >= 8 * 1024 * mi),
        key=lambda it: min((o.price for o in it.offerings if o.available), default=1e9),
    )
    it = sized[len(sized) // 2]
    off = min((o for o in it.offerings if o.available), key=lambda o: o.price)

    def pod(name, node_name=""):
        p = objs.Pod(
            metadata=objs.ObjectMeta(name=name),
            spec=objs.PodSpec(requests={
                res.CPU: rng.choice(pod_cpus),
                res.MEMORY: rng.choice(pod_mems) * mi,
            }),
        )
        if node_name:
            p.spec.node_name = node_name
            p.status.phase = "Running"
        return p

    for i in range(n_nodes):
        name = f"n-{i}"
        node_labels = {
            labels.HOSTNAME: name, labels.INSTANCE_TYPE: it.name,
            labels.TOPOLOGY_ZONE: off.zone(),
            labels.CAPACITY_TYPE_LABEL_KEY: off.capacity_type(),
            labels.NODEPOOL_LABEL_KEY: pool.name,
        }
        claim = objs.NodeClaim(
            metadata=objs.ObjectMeta(name=name, labels=dict(node_labels)),
            spec=objs.NodeClaimSpec(),
        )
        claim.status.provider_id = f"test://{i}"
        claim.status.capacity = dict(it.capacity)
        claim.status.allocatable = dict(it.allocatable())
        for cond in (objs.COND_LAUNCHED, objs.COND_REGISTERED,
                     objs.COND_INITIALIZED, objs.COND_CONSOLIDATABLE):
            claim.conds().set(cond, "True", now=clock.now())
        node = objs.Node(metadata=objs.ObjectMeta(name=name, labels=node_labels),
                         provider_id=f"test://{i}")
        node.status.capacity = dict(it.capacity)
        node.status.allocatable = dict(it.allocatable())
        node.status.ready = True
        client.create(claim)
        client.create(node)
        for j in range(rng.choice(pods_per_node)):
            client.create(pod(f"fill-{i}-{j}", node_name=name))
    for j in range(pending):
        client.create(pod(f"pend-{j}"))
    ctl = _mod(pkg, "controllers.disruption.controller")
    kw = {}
    if pkg == "karpenter_tpu_torch":
        kw["solver_config"] = _mod(pkg, "solver.driver").SolverConfig(device=device)
    return ctl.DisruptionContext(
        client=client, cluster=cluster, cloud_provider=provider, clock=clock,
        recorder=_mod(pkg, "events.recorder").Recorder(clock),
        spot_to_spot_enabled=True, **kw,
    )


def _candidates(pkg, ctx):
    helpers = _mod(pkg, "controllers.disruption.helpers")
    method = _mod(pkg, "controllers.disruption.methods").MultiNodeConsolidation(ctx)
    return sorted(
        (c for c in helpers.get_candidates(
            ctx.client, ctx.cluster, ctx.cloud_provider, ctx.clock)
         if method.should_disrupt(c)),
        key=lambda c: c.disruption_cost,
    )


def _simulator(pkg, ctx, candidates):
    helpers = _mod(pkg, "controllers.disruption.helpers")
    return helpers.ScenarioSimulator(
        ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
        encode_cache=ctx.encode_cache, state_snapshot=ctx.cluster.nodes(),
        solver_config=ctx.solver_config,
    )


def _results_by_name(results, pkg, ctx):
    """A scenario's Results by name: claims (pool, pods, options) in slot
    order, the pods each existing node took, pod errors (``ctx`` None:
    their count)."""
    claims = [
        (c.template.node_pool_name, tuple(sorted(p.metadata.name for p in c.pods)),
         tuple(it.name for it in c.instance_type_options))
        for c in results.new_node_claims
    ]
    existing = sorted(
        (en.name, tuple(sorted(p.metadata.name for p in en.pods)))
        for en in results.existing_nodes if en.pods
    )
    if ctx is None:
        return claims, existing, len(results.pod_errors)
    name = {p.uid: p.metadata.name
            for p in ctx.client.list(_mod(pkg, "api.objects").Pod)}
    return claims, existing, sorted(name[u] for u in results.pod_errors)


def _subsets(candidates, sizes):
    return [candidates[:k] for k in sizes]


# -- (a) the plain scenario solve against JAX's vmapped one -------------------


def _jax_scenarios(args, statics, nmax, fills_dtype, batch_topo):
    import jax.numpy as jnp
    from karpenter_tpu.ops.solve import solve_all_scenarios_packed

    out = solve_all_scenarios_packed(
        *[np.asarray(a) for a in args], nmax=nmax,
        fills_dtype=jnp.int16 if fills_dtype == torch.int16 else jnp.int32,
        batch_topo=batch_topo, **statics,
    )
    return [np.asarray(x) for x in out]


def _assert_outputs_equal(port, ref):
    assert len(port) == len(ref) == 10
    for i, (p, r) in enumerate(zip(port, ref)):
        p = p.numpy()
        assert p.shape == r.shape, (i, p.shape, r.shape)
        assert p.dtype == r.dtype, (i, p.dtype, r.dtype)
        np.testing.assert_array_equal(p, r, err_msg=f"output {i}")


@pytest.mark.parametrize("sizes", [(1, 2, 3, 5, 8), (1, 2, 4, 6, 9, 12, 15, 17, 20)])
def test_consolidation_env_solve_equals_jax(sizes):
    """S=8 (5 real) and S=16 (9 real): the args of the port's own submit
    over build_consolidation_env(200)'s shared encoding."""
    from karpenter_tpu_torch.ops.solve import solve_scenarios_core_packed
    from karpenter_tpu_torch.solver.workloads import build_consolidation_env

    ctx, _, _, _ = build_consolidation_env(200, device="cpu")
    candidates = _candidates("karpenter_tpu_torch", ctx)
    sim = _simulator("karpenter_tpu_torch", ctx, candidates)
    token = sim._solver.submit_scenarios(sim._scenarios_of(_subsets(candidates, sizes)))
    args = token["args"]
    S = args[0].shape[0]
    assert S == (8 if len(sizes) <= 8 else 16) and S > len(sizes)
    kw = dict(nmax=token["nmax"], fills_dtype=token["fills_dtype"],
              batch_topo=token["batch_topo"], **token["statics"])
    port = solve_scenarios_core_packed(*args, **kw)
    _assert_outputs_equal(port, _jax_scenarios(
        args, token["statics"], kw["nmax"], kw["fills_dtype"], kw["batch_topo"]))
    n_open = port[2].numpy()
    assert (n_open[len(sizes):] == 0).all()  # padded scenarios open nothing
    assert not port[3].numpy().any()
    assert int(port[4][:len(sizes)].sum()) > 0  # existing nodes took pods


@pytest.mark.parametrize("S,real,fills", [(8, 6, torch.int16), (16, 11, torch.int32)])
def test_state_node_batch_equals_jax(S, real, fills):
    """A mixed batch over 8 state nodes; per scenario, a seeded subset of
    each group and a seeded set of removed nodes; scenarios past ``real``
    stay padded (g_count 0, no node)."""
    from karpenter_tpu_torch.ops.solve import solve_scenarios_core_packed
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.solver.args import to_device_args

    from test_torch_solver import _build

    solver, pods = _build("karpenter_tpu_torch", "mixed_pods", 300, 30, n_nodes=8)
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    assert not rest
    snap, avail, *_ = solver._encode_batch(groups, scenario=True)
    G = enc._next_pow2(len(snap.groups), floor=1)
    N = enc._next_pow2(len(snap.existing_names), floor=1)
    statics = solver._kernel_statics(snap, G)
    nmax = solver._estimate_nmax(snap, solver._fit_matrix(snap))
    run = snap.padded(G, N)
    args = list(run.solve_args(*avail))
    rng = np.random.default_rng(S)
    g_count_s = np.zeros((S, G), np.int32)
    n_tol_s = np.zeros((S, N, G), bool)
    for si in range(real):
        g_count_s[si] = rng.integers(0, run.g_count + 1)
        n_tol_s[si] = run.n_tol & (rng.random(N) < 0.7)[:, None]
    args[enc.SOLVE_ARG_NAMES.index("g_count")] = g_count_s
    args[enc.SOLVE_ARG_NAMES.index("n_tol")] = n_tol_s
    args = to_device_args(args, "cpu")
    port = solve_scenarios_core_packed(
        *args, nmax=nmax, fills_dtype=fills, batch_topo=False, **statics)
    _assert_outputs_equal(port, _jax_scenarios(args, statics, nmax, fills, False))
    assert int(port[4].sum()) > 0 and int(port[2][:real].min()) >= 0
    assert (port[2][real:] == 0).all() and not port[4][real:].any()


def test_batch_topo_shapes_are_checked():
    """Under batch_topo the prior arrays must carry the scenario axis."""
    from karpenter_tpu_torch.ops.solve import solve_scenarios_core_packed
    from karpenter_tpu_torch.solver.args import to_device_args
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import example_snapshot_arrays

    args, statics = example_snapshot_arrays(64, 16, 4)
    a = list(args)
    a[0] = np.stack([a[0]] * 8)
    i = SOLVE_ARG_NAMES.index("n_tol")
    a[i] = np.stack([a[i]] * 8)
    a = to_device_args(a, "cpu")
    with pytest.raises(ValueError, match="expected rank 3 with 8 scenarios"):
        solve_scenarios_core_packed(*a, batch_topo=True, sparse_groups=True, **statics)


# -- (b) TorchSolver.solve_scenarios against TpuSolver's ---------------------


@pytest.fixture(scope="module")
def scenario_results():
    """Each package's simulator over one seeded cluster (2 pending pods),
    solving the same candidate prefixes in one batch."""
    out = {}
    sizes = (1, 2, 3, 5, 8, 13)
    for pkg in PKGS:
        ctx = _env(pkg, 16, seed=4, pending=2)
        candidates = _candidates(pkg, ctx)
        sim = _simulator(pkg, ctx, candidates)
        results = sim.solve(_subsets(candidates, sizes))
        out[pkg] = (ctx, candidates, sim, results)
    return sizes, out


def test_solve_scenarios_equals_jax(scenario_results):
    sizes, out = scenario_results
    jax_results, port_results = out["karpenter_tpu"][3], out["karpenter_tpu_torch"][3]
    assert jax_results is not None and port_results is not None
    assert len(port_results) == len(jax_results) == len(sizes)
    jctx, tctx = out["karpenter_tpu"][0], out["karpenter_tpu_torch"][0]
    for k, j, t in zip(sizes, jax_results, port_results):
        assert (_results_by_name(t, "karpenter_tpu_torch", tctx)
                == _results_by_name(j, "karpenter_tpu", jctx)), k
    sim = out["karpenter_tpu_torch"][2]
    assert sim.available and sim._solver.fallback_solves == 0
    assert sim.dispatches == out["karpenter_tpu"][2].dispatches == 1


def test_solve_scenarios_equals_own_sequential_solves(scenario_results):
    from karpenter_tpu_torch.controllers.disruption.helpers import simulate_scheduling

    sizes, out = scenario_results
    ctx, candidates, _, batched = out["karpenter_tpu_torch"]
    snapshot = ctx.cluster.nodes()
    for k, br in zip(sizes, batched):
        sr = simulate_scheduling(
            ctx.client, ctx.cluster, ctx.cloud_provider, candidates[:k],
            encode_cache=ctx.encode_cache, state_snapshot=snapshot,
            solver_config=ctx.solver_config,
        )
        # group members are interchangeable, so compare claim shapes and
        # per-node counts, as tests/test_scenario_batch.py does
        assert set(br.pod_errors) == set(sr.pod_errors)
        assert sorted(
            (len(c.pods), tuple(it.name for it in c.instance_type_options))
            for c in br.new_node_claims
        ) == sorted(
            (len(c.pods), tuple(it.name for it in c.instance_type_options))
            for c in sr.new_node_claims
        ), k
        assert (
            {en.name: len(en.pods) for en in br.existing_nodes if en.pods}
            == {en.name: len(en.pods) for en in sr.existing_nodes if en.pods}
        ), k


def test_scenarios_isolated():
    """tests/test_scenario_batch.py:417 on the port: one scenario's fills
    never leak into another's Results (per-scenario node clones), and the
    shared node models stay untouched."""
    pkg = "karpenter_tpu_torch"
    ctx = _env(pkg, 8, seed=6, pods_per_node=(2,))
    candidates = _candidates(pkg, ctx)
    sim = _simulator(pkg, ctx, candidates)
    before = {en.name: len(en.pods) for en in sim._solver.oracle.existing_nodes}
    r1, r2 = sim.solve([[candidates[0]], [candidates[0]]])
    f1 = {en.name: len(en.pods) for en in r1.existing_nodes if en.pods}
    f2 = {en.name: len(en.pods) for en in r2.existing_nodes if en.pods}
    assert f1 == f2
    assert sum(f1.values()) > sum(before.values())  # the scenario placed pods
    assert {en.name: len(en.pods) for en in sim._solver.oracle.existing_nodes} == before


def _mixed_scenarios(pkg, max_claims):
    """Both packages' solvers over 300 mixed pods (no nodes), NMAX forced
    to ``max_claims``, and three workload subsets as scenarios."""
    from test_torch_solver import _build

    solver, pods = _build(pkg, "mixed_pods", 300, 30)
    drv = _mod(pkg, "solver.driver")
    kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    solver.config = drv.SolverConfig(max_claims=max_claims, **kw)
    return solver, [drv.Scenario(pods=pods[:k]) for k in (100, 300, 7)]


def test_overflow_redispatches_the_batch():
    """NMAX too small for the widest scenario: the whole batch goes again
    at 2x NMAX until none overflows, and the answer equals JAX's."""
    got = {}
    for pkg in PKGS:
        solver, scenarios = _mixed_scenarios(pkg, max_claims=2)
        results = solver.solve_scenarios(scenarios)
        got[pkg] = ([_results_by_name(r, pkg, None) for r in results],
                    solver.last_scenario_dispatches)
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert got["karpenter_tpu_torch"][1] > 1


def test_guard_rejects_a_corrupt_batch():
    """A garbage kernel output (n_open past NMAX in one scenario) fails
    the per-scenario guard before anything decodes: SolverIntegrityError
    propagates out of solve_scenarios, nothing re-solves."""
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.faults.guard import SolverIntegrityError

    def corrupt(out):
        n_open = out[2].clone()
        n_open[0] += 1000
        return out[:2] + (n_open,) + tuple(out[3:])

    solver, scenarios = _mixed_scenarios("karpenter_tpu_torch", max_claims=None)
    faults.install(faults.FaultInjector(
        [faults.FaultRule(site=faults.SOLVER_OUTPUT, mutate=corrupt)]))
    try:
        with pytest.raises(SolverIntegrityError):
            solver.solve_scenarios(scenarios)
    finally:
        faults.uninstall()
    assert solver.fallback_solves == 0


def test_empty_and_declined_batches():
    """No scenarios solve to []; force_oracle declines (None) without
    counting a fallback, as in the JAX package."""
    from karpenter_tpu_torch.solver.driver import SolverConfig

    ctx = _env("karpenter_tpu_torch", 4, seed=0)
    candidates = _candidates("karpenter_tpu_torch", ctx)
    sim = _simulator("karpenter_tpu_torch", ctx, candidates)
    solver = sim._solver
    assert solver.solve_scenarios([]) == []
    solver.config = SolverConfig(device="cpu", force_oracle=True)
    assert solver.solve_scenarios(sim._scenarios_of([candidates[:1]])) is None
    assert solver.fallback_solves == 0


def test_prefetch_error_reraises_inline():
    """ScenarioSimulator.prefetch swallows a submit error; the same error
    then raises at the chunk's inline solve, so the sweep never falls back
    to per-candidate solves unseen. 40 nodes of 31.58 CPU each hold three
    10-CPU pods: no candidate consolidates, so the sweep reaches chunk 2."""
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.controllers.disruption.methods import (
        SingleNodeConsolidation,
    )

    ctx = _env("karpenter_tpu_torch", 40, seed=5, pods_per_node=(3,),
               pod_cpus=(10000,), pod_mems=(2048,))
    candidates = _candidates("karpenter_tpu_torch", ctx)
    method = SingleNodeConsolidation(ctx)
    inj = faults.install(faults.FaultInjector(
        [faults.FaultRule(site=faults.SOLVER_SCENARIOS, after=1)]))
    try:
        with pytest.raises(faults.InjectedFault):
            method.compute_command(candidates, {"default": len(candidates)})
    finally:
        faults.uninstall()
    assert inj.fired(faults.SOLVER_SCENARIOS) == 2  # the prefetch, then inline
    assert method.last_probes == 16  # only the first chunk decided


# -- (c) the consolidation methods against the JAX ones ----------------------


def _command_signature(cmd):
    return (
        cmd.decision,
        sorted(c.name for c in cmd.candidates),
        [[it.name for it in rep.instance_type_options] for rep in cmd.replacements],
        [repr(sorted(map(repr, rep.requirements))) for rep in cmd.replacements],
    )


@pytest.mark.parametrize("method,decision,disrupted,probes,dispatches", [
    ("multi", "delete", 20, 16, 2),
    ("single", "delete", 1, 16, 1),
])
def test_compute_command_equals_jax(method, decision, disrupted, probes, dispatches):
    got = {}
    for pkg in PKGS:
        wl = _mod(pkg, "solver.workloads")
        build = (wl.build_consolidation_env if method == "multi"
                 else wl.build_single_consolidation_env)
        kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
        ctx, m, candidates, budgets = build(200, **kw)
        cmd = m.compute_command(candidates, budgets)
        got[pkg] = (_command_signature(cmd), m.last_probes, m.last_dispatches)
        if pkg == "karpenter_tpu_torch":
            solvers = [e["solver"] for e in ctx.scenario_envs._entries.values()]
            assert solvers and all(s.fallback_solves == 0 for s in solvers)
            assert all(s.config.device == "cpu" for s in solvers)
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    sig, n_probes, n_dispatches = got["karpenter_tpu_torch"]
    assert (sig[0], len(sig[1]), n_probes, n_dispatches) == (
        decision, disrupted, probes, dispatches)


def test_sequential_path_equals_batched():
    """The port's sequential per-probe evaluator (the decline path) decides
    as its batched search does, in one solve per probe."""
    cmds = {}
    for batched in (True, False):
        ctx = _env("karpenter_tpu_torch", 40, seed=3, pending=1)
        ctx.scenario_batch = batched
        m = _mod("karpenter_tpu_torch", "controllers.disruption.methods")
        method = m.MultiNodeConsolidation(ctx)
        candidates = _candidates("karpenter_tpu_torch", ctx)
        budgets = _mod("karpenter_tpu_torch", "controllers.disruption.helpers") \
            .build_budget_mapping(ctx.client, ctx.cluster, method.reason, ctx.clock.now())
        cmds[batched] = (_command_signature(method.compute_command(candidates, budgets)),
                         method.last_probes, method.last_dispatches)
    assert cmds[True][0] == cmds[False][0]
    assert cmds[True][2] <= 2 and cmds[False][2] == cmds[False][1]


# -- (d) outside the ported scope ---------------------------------------------


def test_domain_scenario_batch_raises():
    """A zonal-spread workload (has_domains) is ported: the scenario batch
    decides as TpuSolver's does, scenario by scenario. So is the same
    batch over a minValues pool (ROADMAP item A4b's first part): it rides
    the batch, never declines, and decides as JAX's does."""
    from test_torch_solver import _build

    for pools in ("default", "minvalues"):
        got = {}
        for pkg in PKGS:
            Scenario = _mod(pkg, "solver.driver").Scenario
            solver, pods = _build(pkg, "constrained_mix", 200, 20, pools=pools)
            results = solver.solve_scenarios([Scenario(pods=pods), Scenario(pods=pods[:50])])
            assert results is not None and solver.fallback_solves == 0
            got[pkg] = [_results_by_name(r, pkg, None) for r in results]
        assert got["karpenter_tpu_torch"] == got["karpenter_tpu"], pools
