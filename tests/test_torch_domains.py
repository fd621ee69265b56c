"""Port parity for the packing scan's domain machinery (has_domains), on the CPU.

The JAX package is the reference. The same numpy arrays, encoded by the
JAX package and padded to shared shapes (so JAX compiles its scan once per
static set), go through JAX's ``solve_all`` and the port's ``solve_core``
on CPU tensors, whose scan is ops/packing.py:pack_reference — the plain
version of kernel B4. Tolerance: exact equality of all 10 outputs.

Covered: zonal self-spread at maxSkew 1 and 2, minDomains, zonal affinity
(the bootstrap), a non-self-selecting spread (a gate owner on a shared
carry), zone + hostname spread together, capacity-type spread (dkey 1),
existing nodes in zones holding prior pods, the domain helpers
(``spread_domain_choice``, ``bulk_takes``) on random inputs, the scenario
axis with per-scenario domain priors (batch_topo), TorchSolver against
TpuSolver on constrained_mix(2000) x 400 and on the zonal cases, and
Multi/SingleNodeConsolidation over a 200-node zonal-spread cluster against
the JAX methods.
"""

import importlib
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers import affinity_term, make_pod, make_pods, make_state_node, spread_constraint
from karpenter_tpu.api import labels
from karpenter_tpu.ops import packing as jpack
from karpenter_tpu.ops.solve import solve_all
from karpenter_tpu_torch.ops import packing as tp
from karpenter_tpu_torch.ops.solve import solve_core
from karpenter_tpu_torch.solver.args import to_device_args

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")
OUT_NAMES = (
    "c_pool", "c_tmask", "n_open", "overflow", "exist_fills", "claim_fills",
    "unplaced", "c_dzone", "c_dct", "c_resv",
)
ZONES = ("test-zone-a", "test-zone-b", "test-zone-c")
# every case runs at these padded shapes and statics
G_PAD, N_PAD, NMAX, N_TYPES = 8, 4, 32, 20


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _domain_snapshot(pods, n_nodes=0, priors=()):
    """solve_args + statics of the JAX encoding of ``pods`` over ``n_nodes``
    existing nodes (zones round-robin, 4 CPU each), padded to G_PAD groups
    and N_PAD nodes. ``priors`` are (node index, labels) of running pods
    bound to those nodes: topology priors of the spread/affinity groups."""
    from karpenter_tpu.cloudprovider import corpus
    from karpenter_tpu.kube import Client, TestClock
    from karpenter_tpu.scheduling.topology import Topology
    from karpenter_tpu.solver import TpuSolver
    from karpenter_tpu.solver import encode as enc
    from karpenter_tpu.solver.example import example_nodepool

    nodes = [make_state_node(name=f"dn-{i}", cpu="4", zone=ZONES[i % len(ZONES)])
             for i in range(n_nodes)]
    client = Client(TestClock())
    for sn in nodes:
        client.create(sn.node)
    for i, lbl in priors:
        pod = make_pod(labels=lbl, node_name=f"dn-{i}", phase="Running")
        client.create(pod)
        nodes[i].update_pod(pod, is_daemon=False)
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(N_TYPES)}
    topo = Topology(client, nodes, pools, its, pods)
    solver = TpuSolver(pools, its, topo, state_nodes=nodes)
    groups, rest = enc.partition_and_group(pods, topology=topo)
    assert not rest, "the batch must tensorize fully"
    snap, avail, *_ = solver._encode_batch(groups)
    assert len(snap.groups) <= G_PAD and n_nodes <= N_PAD
    statics = solver._kernel_statics(snap, G_PAD)
    statics.update(nmax=NMAX, wf_iters=16, sparse_groups=True)
    assert statics["has_domains"] and not statics["has_contrib"]
    return snap.padded(G_PAD, N_PAD if n_nodes else 0).solve_args(*avail), statics, snap


def _parity(args, statics):
    import jax

    j_out = [np.asarray(x) for x in jax.device_get(solve_all(*args, **statics))]
    t_out = solve_core(*to_device_args(args, "cpu"), **statics)
    for name, j, t in zip(OUT_NAMES, j_out, t_out):
        t = t.numpy()
        assert t.shape == j.shape, f"{name}: {t.shape} vs {j.shape}"
        mism = np.argwhere(t.astype(j.dtype) != j)
        assert not mism.size, f"{name} diverges at {mism[:5].tolist()}"
    return j_out


def _zspread(n, cpu="1", key=labels.TOPOLOGY_ZONE, app="zs", **kw):
    return make_pods(n, cpu=cpu, labels={"app": app},
                     spread=[spread_constraint(key, labels={"app": app}, **kw)])


CASES = {
    "zonal-spread-skew1": lambda: (_zspread(12) + make_pods(8, cpu="2"),),
    "zonal-spread-skew2": lambda: (_zspread(10, max_skew=2),),
    "min-domains": lambda: (_zspread(6, min_domains=5),),
    "zonal-affinity-bootstrap": lambda: (make_pods(
        8, cpu="1", labels={"app": "za"},
        pod_affinity=[affinity_term(labels.TOPOLOGY_ZONE, {"app": "za"})]),),
    "gate-owner": lambda: (
        _zspread(5, app="g") + make_pods(
            4, cpu="2", memory="2Gi", labels={"app": "other"},
            spread=[spread_constraint(labels.TOPOLOGY_ZONE, labels={"app": "g"})]),),
    "zone-and-hostname": lambda: (make_pods(
        6, cpu="1", labels={"app": "zh"},
        spread=[spread_constraint(labels.TOPOLOGY_ZONE, labels={"app": "zh"}),
                spread_constraint(labels.HOSTNAME, labels={"app": "zh"})]),),
    "capacity-type-spread": lambda: (_zspread(9, key=labels.CAPACITY_TYPE_LABEL_KEY),),
    "nodes-with-priors": lambda: (
        _zspread(14, app="zp"), 3, [(0, {"app": "zp"}), (0, {"app": "zp"}), (1, {"app": "zp"})]),
    "affinity-over-nodes": lambda: (make_pods(
        6, cpu="1", labels={"app": "zn"},
        pod_affinity=[affinity_term(labels.TOPOLOGY_ZONE, {"app": "zn"})]), 3),
}
# the domain mode each case must exercise (solver/encode.py:DMODE_*)
WANT_MODES = {
    "zonal-affinity-bootstrap": {2}, "gate-owner": {1, 3},
    "affinity-over-nodes": {2},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_with_domains_equals_jax(case):
    args, statics, snap = _domain_snapshot(*CASES[case]())
    modes = set(snap.g_dmode[snap.g_dmode > 0].tolist())
    assert modes >= WANT_MODES.get(case, {1}), modes
    if case == "capacity-type-spread":
        assert (snap.g_dkey[snap.g_dmode > 0] == 1).all()
    if case == "nodes-with-priors":
        assert snap.g_dprior.any()
    out = _parity(args, statics)
    assert int(out[2]) > 0 or out[4].any()  # claims opened or nodes filled


# -- the domain helpers on random inputs --------------------------------------


@settings(max_examples=40, deadline=None)
@given(
    data=st.data(),
    nmax=st.sampled_from([5, 12]),
    V1=st.sampled_from([1, 4]),
    mode=st.sampled_from([1, 2, 3, 4]),
)
def test_spread_domain_choice_equals_jax(data, nmax, V1, mode):
    """Random admissibility and quotas (negative ones too): the greedy
    argmax, the float32 quota-proportional pick and its fallback."""
    adm = np.array(data.draw(st.lists(st.booleans(), min_size=nmax * V1,
                                      max_size=nmax * V1))).reshape(nmax, V1)
    qrem = np.array(data.draw(st.lists(st.integers(-3, 40), min_size=V1, max_size=V1)),
                    np.int32)
    DEAD = V1 + 1
    j_slot, j_any = jpack.spread_domain_choice(adm, qrem, np.int32(mode), V1, DEAD)
    t_slot, t_any = tp.spread_domain_choice(torch.from_numpy(adm), torch.from_numpy(qrem),
                                            mode, V1, DEAD)
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(t_any.numpy(), np.asarray(j_any))


@settings(max_examples=60, deadline=None)
@given(
    rem=st.integers(0, 200), k=st.integers(0, 9), n_per=st.integers(0, 30),
    slot=st.integers(0, 6), is_any=st.booleans(), has_domains=st.booleans(),
)
def test_bulk_takes_equals_jax(rem, k, n_per, slot, is_any, has_domains):
    slots = np.arange(16, dtype=np.int32)
    i32 = np.int32
    j_takes, j_in = jpack.bulk_takes(i32(rem), i32(k), i32(n_per), slots, i32(slot),
                                     np.bool_(is_any), has_domains)
    t_takes, t_in = tp.bulk_takes(
        torch.tensor(rem, dtype=torch.int32), torch.tensor(k, dtype=torch.int32),
        torch.tensor(n_per, dtype=torch.int32), torch.from_numpy(slots), slot,
        is_any, has_domains)
    np.testing.assert_array_equal(t_takes.numpy(), np.asarray(j_takes))
    np.testing.assert_array_equal(t_in.numpy(), np.asarray(j_in))


# -- TorchSolver against TpuSolver ---------------------------------------------


def test_constrained_2000x400_equals_tpu_solver():
    """BASELINE config[2]'s mix, cut to 2,000 pods over 400 types."""
    from test_torch_solver import _solve_both

    jd, td = _solve_both("constrained_mix", 2000, 400)
    assert td == jd
    assert len(jd[0]) > 100 and not jd[2]


@pytest.mark.parametrize("case", ["zonal-spread-skew1", "zonal-affinity-bootstrap",
                                  "gate-owner", "nodes-with-priors"])
def test_solver_zonal_cases_equal_tpu_solver(case):
    """The zonal shapes of tests/test_solver_parity.py through both solvers
    (the port's objects rebuilt from the JAX ones, same uids)."""
    from karpenter_tpu.solver.example import example_nodepool

    from test_torch_residency import port_state_node, signature, to_port

    pods, n_nodes, priors = (list(CASES[case]()) + [0, ()])[:3]
    got = {}
    for pkg in PKGS:
        tpkg = pkg == "karpenter_tpu_torch"
        conv = to_port if tpkg else (lambda x: x)
        nodes = [make_state_node(name=f"dn-{i}", cpu="4", zone=ZONES[i % len(ZONES)])
                 for i in range(n_nodes)]
        client = _mod(pkg, "kube").Client(_mod(pkg, "kube").TestClock())
        for sn in nodes:
            client.create(conv(sn.node))
        if tpkg:
            nodes = [port_state_node(sn) for sn in nodes]
        for i, lbl in priors:
            pod = conv(make_pod(labels=lbl, node_name=f"dn-{i}", phase="Running"))
            client.create(pod)
            nodes[i].update_pod(pod, is_daemon=False)
        pools = [conv(example_nodepool())]
        its = {pools[0].name: _mod(pkg, "cloudprovider.corpus").generate(N_TYPES)}
        batch = [conv(p) for p in pods]
        topo = _mod(pkg, "scheduling.topology").Topology(client, nodes, pools, its, batch)
        drv = _mod(pkg, "solver.driver")
        kw = {"config": drv.SolverConfig(device="cpu")} if tpkg else {}
        solver = (drv.TorchSolver if tpkg else drv.TpuSolver)(
            pools, its, topo, state_nodes=nodes, **kw)
        got[pkg] = signature(solver.solve(batch))
        assert solver.fallback_solves == 0
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]


# -- the scenario axis over domain priors, and consolidation --------------------


def _topo_env(pkg, n_nodes, seed, pending=2, device="cpu"):
    """tests/test_dense_constraints.py:build_topo_env for either package: a
    seeded consolidatable cluster over the catalog's zones whose fill pods
    carry self-selecting zonal spread (two deployments), plus pending pods
    of the same deployments."""
    objs = _mod(pkg, "api.objects")
    res = _mod(pkg, "api.resources")
    kube = _mod(pkg, "kube")
    corpus = _mod(pkg, "cloudprovider.corpus")
    lbl = _mod(pkg, "api.labels")
    mi = 2**20 * res.MILLI
    rng = random.Random(seed)
    clock = kube.TestClock()
    clock.step(3600.0)
    client = kube.Client(clock)
    its = corpus.generate(30)
    provider = _mod(pkg, "cloudprovider.kwok").KwokCloudProvider(client, its)
    cluster = _mod(pkg, "controllers.state").Cluster(client)
    pool = objs.NodePool(
        metadata=objs.ObjectMeta(name="default"),
        spec=objs.NodePoolSpec(template=objs.NodeClaimTemplate(spec=objs.NodeClaimSpec())),
    )
    pool.spec.disruption.consolidate_after = 10.0
    client.create(pool)
    sized = sorted(
        (it for it in its if it.capacity.get(res.CPU, 0) >= 4000
         and it.capacity.get(res.MEMORY, 0) >= 8 * 1024 * mi),
        key=lambda it: min((o.price for o in it.offerings if o.available), default=1e9),
    )
    it = sized[len(sized) // 2]
    zoned = {}
    for o in it.offerings:
        if o.available and o.zone() not in zoned:
            zoned[o.zone()] = o
    zones = sorted(zoned)
    assert len(zones) >= 2

    def pod(name, app, cpu_m, mem_mi, node_name=""):
        sel = objs.LabelSelector(match_labels={"app": app})
        p = objs.Pod(
            metadata=objs.ObjectMeta(name=name, labels={"app": app}),
            spec=objs.PodSpec(
                requests={res.CPU: cpu_m, res.MEMORY: mem_mi * mi},
                topology_spread_constraints=[objs.TopologySpreadConstraint(
                    max_skew=1, topology_key=lbl.TOPOLOGY_ZONE,
                    when_unsatisfiable="DoNotSchedule", label_selector=sel)],
            ),
        )
        if node_name:
            p.spec.node_name = node_name
            p.status.phase = "Running"
        return p

    for i in range(n_nodes):
        name = f"n-{i}"
        off = zoned[zones[i % len(zones)]]
        node_labels = {
            lbl.HOSTNAME: name, lbl.INSTANCE_TYPE: it.name,
            lbl.TOPOLOGY_ZONE: off.zone(),
            lbl.CAPACITY_TYPE_LABEL_KEY: off.capacity_type(),
            lbl.NODEPOOL_LABEL_KEY: pool.name,
        }
        claim = objs.NodeClaim(metadata=objs.ObjectMeta(name=name, labels=dict(node_labels)),
                               spec=objs.NodeClaimSpec())
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
        for j in range(rng.choice((1, 2))):
            client.create(pod(f"fill-{i}-{j}", f"d{(i + j) % 2}",
                              rng.choice((250, 500, 750)), rng.choice((256, 512, 1024)),
                              node_name=name))
    for j in range(pending):
        client.create(pod(f"pend-{j}", f"d{j % 2}", 500, 512))
    kw = {}
    if pkg == "karpenter_tpu_torch":
        kw["solver_config"] = _mod(pkg, "solver.driver").SolverConfig(device=device)
    return _mod(pkg, "controllers.disruption.controller").DisruptionContext(
        client=client, cluster=cluster, cloud_provider=provider, clock=clock,
        recorder=_mod(pkg, "events.recorder").Recorder(clock),
        spot_to_spot_enabled=True, **kw,
    )


def _consolidate(pkg, method, n_nodes, seed=2):
    """compute_command of the named method over ``_topo_env``; returns
    (command signature, probes, dispatches, fallbacks, the submitted
    scenario tokens)."""
    from test_torch_scenarios import _command_signature

    drv = _mod(pkg, "solver.driver")
    cls_s = drv.TorchSolver if pkg == "karpenter_tpu_torch" else drv.TpuSolver
    tokens = []
    submit = cls_s.submit_scenarios

    def recording(self, scenarios):
        tok = submit(self, scenarios)
        tokens.append(tok)
        return tok

    cls_s.submit_scenarios = recording
    try:
        ctx = _topo_env(pkg, n_nodes, seed=seed)
        methods = _mod(pkg, "controllers.disruption.methods")
        m = (methods.MultiNodeConsolidation if method == "multi"
             else methods.SingleNodeConsolidation)(ctx)
        helpers = _mod(pkg, "controllers.disruption.helpers")
        candidates = sorted(
            (c for c in helpers.get_candidates(ctx.client, ctx.cluster,
                                               ctx.cloud_provider, ctx.clock)
             if m.should_disrupt(c)),
            key=lambda c: c.disruption_cost,
        )
        budgets = helpers.build_budget_mapping(ctx.client, ctx.cluster, m.reason,
                                               ctx.clock.now())
        cmd = m.compute_command(candidates, budgets)
    finally:
        cls_s.submit_scenarios = submit
    fallbacks = sum(e["solver"].fallback_solves for e in ctx.scenario_envs._entries.values())
    return _command_signature(cmd), m.last_probes, m.last_dispatches, fallbacks, tokens


def test_topology_scenario_batch_equals_jax():
    """The multi-node search's probe set over a 60-node zonal cluster: the
    port's submit stages per-scenario domain priors (g_dprior [S, G, V1],
    dd0 [S, JD, V1]: batch_topo), and the plain scenario solve on exactly
    those args equals JAX's vmapped one, every output of every scenario."""
    from test_torch_scenarios import _assert_outputs_equal, _jax_scenarios

    from karpenter_tpu_torch.ops.solve import solve_scenarios_core_packed

    *_, fallbacks, tokens = _consolidate("karpenter_tpu_torch", "multi", 60)
    tok = next(t for t in tokens if t is not None and "slot" in t)
    assert fallbacks == 0 and tok["batch_topo"] and tok["statics"]["has_domains"]
    args = tok["args"]
    names = _mod("karpenter_tpu_torch", "solver.encode").SOLVE_ARG_NAMES
    gp, dd0 = args[names.index("g_dprior")], args[names.index("dd0")]
    assert gp.dim() == 3 and dd0.dim() == 3
    # the scenarios' domain priors differ (by the included candidates' pods)
    priors = torch.cat([gp.flatten(1), dd0.flatten(1)], 1)[:tok["S_real"]]
    assert any(not torch.equal(priors[0], p) for p in priors[1:])
    kw = dict(nmax=tok["nmax"], fills_dtype=tok["fills_dtype"], batch_topo=True,
              **tok["statics"])
    port = solve_scenarios_core_packed(*args, **kw)
    _assert_outputs_equal(port, _jax_scenarios(
        args, tok["statics"], kw["nmax"], kw["fills_dtype"], True))


@pytest.mark.parametrize("method", ["multi", "single"])
@pytest.mark.parametrize("n_nodes", [60, 200])
def test_consolidation_zonal_equals_jax(method, n_nodes):
    """Both methods over the zonal-spread cluster decide as the JAX
    methods, in as many probes and dispatches, with the same sequential
    fallbacks: none at 60 nodes, where every probe set is one
    domain-carrying scenario batch; at 200 nodes both packages decline
    the topology plan to per-probe solves alike."""
    got = {pkg: _consolidate(pkg, method, n_nodes) for pkg in PKGS}
    assert got["karpenter_tpu_torch"][:4] == got["karpenter_tpu"][:4]
    if n_nodes == 60:
        sig, probes, dispatches, fallbacks, tokens = got["karpenter_tpu_torch"]
        assert fallbacks == 0 and dispatches >= 1
        assert all(t["batch_topo"] and t["statics"]["has_domains"] for t in tokens)
