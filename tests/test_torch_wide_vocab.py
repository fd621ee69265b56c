"""Port parity on wide value vocabularies (ROADMAP §C1), on the CPU.

V1, the padded value axis, is pow2(most values of any one key + 1): a
per-team label with more than 1,023 values takes it to 2,048. The JAX
package is the reference; the port's plain versions (the ones the CUDA
kernels are held to bit for bit on the card, tests/test_torch_cuda.py)
must take any width. Held here, inputs from numpy seeds, exact equality:

- B1's and B2's plain versions (the sparse tables) and B3's (the dense
  ones) against the JAX functions at K = 16, V1 = 2,048;
- the scans' plain versions (B4 through solve_core, and B5 through
  TorchSolver's classed route) against JAX on a domain batch at V1 =
  2,048 whose zone key has few values while the team key has 1,100, with
  a zone value outside the catalog (an In on a zone no type offers, a
  NotIn over every offered zone: the OVERFLOW slot) and a node in that
  zone;
- ``TorchSolver(device="cpu")`` against ``TpuSolver`` in slot order on
  two inputs of ROADMAP §C1: a NodePool listing 1,100 teams with 40 pods
  (padded shape (16, 2048)), and minValues 2 on the instance type over a
  catalog of 1,100 types at mixed_pods(2000) (minValues axis MW 2048).

The 1,100-pod per-team input (about 170 s on the CPU) runs on the card
(chip_smoke.py phase 10), not here.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import feasibility as jf
from karpenter_tpu_torch.ops import feasibility as tf
from test_torch_cuda import B1_NAMES, B2_NAMES, random_tables, sparse_index_case

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")
TEAM_KEY = "example.com/team"
N_TEAMS = 1_100


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _same(name, jax_out, torch_out):
    j, t = np.asarray(jax_out), torch_out.numpy()
    assert t.shape == j.shape and t.dtype == j.dtype, name
    mism = np.argwhere(t != j)
    assert not mism.size, f"{name} diverges at {mism[:5].tolist()}"


def _t(a, names):
    return [torch.from_numpy(np.ascontiguousarray(a[n])) for n in names]


# -- the tables: B1 and B2 (sparse), B3 (dense) ----------------------------------


def test_sparse_tables_at_v1_2048():
    """B1's and B2's plain versions against JAX at K = 16, V1 = 2,048 over
    a reordered live-pair index (the card's INDEX_CASES entry)."""
    a, zk, ck = sparse_index_case("vocab-2048")
    assert a["g_mask"].shape[1:] == (16, 2048)
    j_out = jf.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    t_out = tf.fresh_claim_feasibility_sparse(*_t(a, B1_NAMES), zone_kid=zk, ct_kid=ck)
    for name, jo, to in zip(("compat_pg", "type_ok", "n_fit"), j_out, t_out):
        _same(name, jo, to)
    assert t_out[1].any() and not t_out[1].all()
    j_cap = jf.existing_node_feasibility_sparse(*(a[n] for n in B2_NAMES))
    t_cap = tf.existing_node_feasibility_sparse(*_t(a, B2_NAMES))
    _same("cap_ng", j_cap, t_cap)
    assert int(t_cap.max()) > 0


B3_NAMES = B1_NAMES[:17]
B3E_NAMES = B2_NAMES[:9] + ("well_known",)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_tables_at_v1_2048(seed):
    """B3's two plain versions against JAX's dense tables at K = 16, V1 =
    2,048, on random requirement rows (masks 70% set, so keys overlap
    and miss), two templates."""
    a = random_tables(np.random.default_rng([11, seed]), P=2, G=12, T=20, N=6, K=16, V1=2048,
                      R=3, O=4)
    kw = dict(zone_kid=1, ct_kid=2)
    j_out = jf.fresh_claim_feasibility(*(a[n] for n in B3_NAMES), **kw)
    t_out = tf.fresh_claim_feasibility_reference(*_t(a, B3_NAMES), **kw)
    for name, jo, to in zip(("compat_pg", "type_ok", "n_fit"), j_out, t_out):
        _same(name, jo, to)
    assert t_out[0].any() and t_out[1].any()
    _same("cap_ng", jf.existing_node_feasibility(*(a[n] for n in B3E_NAMES)),
          tf.existing_node_feasibility_reference(*_t(a, B3E_NAMES)))


# -- the scans on a domain batch at V1 = 2048 -------------------------------------

ZONES = ("test-zone-a", "test-zone-b", "test-zone-c")
OUTSIDE = "zone-outside"


def _team_pool(pkg, values=None):
    """A NodePool whose one requirement is the team key: Exists, or In
    ``values``."""
    objs = _mod(pkg, "api.objects")
    req = (objs.NodeSelectorRequirement(TEAM_KEY, "Exists", ()) if values is None
           else objs.NodeSelectorRequirement(TEAM_KEY, "In", tuple(values)))
    return objs.NodePool(metadata=objs.ObjectMeta(name="default"), spec=objs.NodePoolSpec(
        template=objs.NodeClaimTemplate(spec=objs.NodeClaimSpec(requirements=[req]))))


def _domain_batch(pkg):
    """Zonal self-spread pods, pods of three teams, a pod pinned to a zone
    no type offers and one excluded from every offered zone, over a pool
    listing 1,100 teams, with three nodes in zone a, zone b and the
    outside zone."""
    objs = _mod(pkg, "api.objects")
    labels = _mod(pkg, "api.labels")
    wl = _mod(pkg, "solver.workloads")

    def zone_req(op, values):
        return objs.NodeAffinity(required=[(
            objs.NodeSelectorRequirement(labels.TOPOLOGY_ZONE, op, tuple(values)),)])

    sel = objs.LabelSelector(match_labels={"app": "zs"})
    pods = [wl._pod(f"zs-{i}", 500, 512, labels={"app": "zs"},
                    topology_spread_constraints=[objs.TopologySpreadConstraint(
                        max_skew=1, topology_key=labels.TOPOLOGY_ZONE,
                        when_unsatisfiable="DoNotSchedule", label_selector=sel)])
            for i in range(9)]
    pods += [wl._pod(f"team-{i}", 250 * (1 + i % 3), 1024,
                     node_selector={TEAM_KEY: f"team-{i % 3}"}) for i in range(12)]
    pods.append(wl._pod("outside-in", 500, 1024, node_affinity=zone_req("In", (OUTSIDE,))))
    pods.append(wl._pod("outside-notin", 500, 1024, node_affinity=zone_req("NotIn", ZONES)))
    return pods


def _nodes(pkg):
    from test_torch_solver import _state_nodes

    labels = _mod(pkg, "api.labels")
    nodes = _state_nodes(pkg, 3)
    for sn, zone in zip(nodes, ("test-zone-a", "test-zone-b", OUTSIDE)):
        sn.node.metadata.labels[labels.TOPOLOGY_ZONE] = zone
    return nodes


def _solver(pkg, pools, its, pods, nodes=(), **cfg):
    kube = _mod(pkg, "kube")
    drv = _mod(pkg, "solver.driver")
    its_by_pool = {p.name: list(its) for p in pools}
    topo = _mod(pkg, "scheduling.topology").Topology(
        kube.Client(kube.TestClock()), list(nodes), pools, its_by_pool, pods)
    if pkg == "karpenter_tpu":
        return drv.TpuSolver(pools, its_by_pool, topo, state_nodes=list(nodes),
                             config=drv.SolverConfig(**cfg))
    return drv.TorchSolver(pools, its_by_pool, topo, state_nodes=list(nodes),
                           config=drv.SolverConfig(device="cpu", **cfg))


def test_scan_domain_batch_at_v1_2048():
    """B4's plain version (solve_core on CPU tensors) against JAX's
    solve_all on the domain batch encoded by the JAX package at V1 =
    2,048: every output, the claims' domains (c_dzone) included."""
    from karpenter_tpu.ops.solve import solve_all
    from karpenter_tpu.solver import encode as enc
    from karpenter_tpu_torch.ops.solve import solve_core
    from karpenter_tpu_torch.solver.args import to_device_args

    corpus = _mod("karpenter_tpu", "cloudprovider.corpus")
    pods = _domain_batch("karpenter_tpu")
    solver = _solver("karpenter_tpu", [_team_pool("karpenter_tpu",
                                                  [f"team-{i}" for i in range(N_TEAMS)])],
                     corpus.generate(20), pods, _nodes("karpenter_tpu"))
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    assert not rest
    snap, avail, *_ = solver._encode_batch(groups)
    assert snap.vocab.padded_shape()[1] == 2048
    zone_vals = snap.vocab.values[snap.vocab.key_ids[_mod("karpenter_tpu", "api.labels")
                                                     .TOPOLOGY_ZONE]]
    assert OUTSIDE in zone_vals and len(zone_vals) < 8
    G = enc._next_pow2(len(snap.groups), floor=8)
    statics = solver._kernel_statics(snap, G)
    statics.update(nmax=64, wf_iters=16, sparse_groups=True)
    assert statics["has_domains"]
    args = snap.padded(G, 4).solve_args(*avail)
    j_out = [np.asarray(x) for x in jax.device_get(solve_all(*args, **statics))]
    t_out = solve_core(*to_device_args(args, "cpu"), **statics)
    for i, (j, t) in enumerate(zip(j_out, t_out)):
        t = t.numpy()
        assert t.shape == j.shape, i
        assert not np.argwhere(t.astype(j.dtype) != j).size, f"output {i}"
    assert int(j_out[2]) > 0 and (j_out[7][: int(j_out[2])] >= 0).any()


def _snapshot(solver, pods):
    """The port solver's encoded snapshot of ``pods``, as its solve builds it."""
    from karpenter_tpu_torch.solver import encode as enc

    groups, _ = enc.partition_and_group(pods, topology=solver.oracle.topology)
    return solver._encode_batch(groups)[0]


def _decisions(results, pods):
    from test_torch_solver import decisions

    return decisions(results, pods)


@pytest.mark.parametrize("classed", [False, True], ids=["per-group", "classed"])
def test_solver_domain_batch_at_v1_2048(classed):
    """TorchSolver(device="cpu") against TpuSolver on the domain batch, B4
    and B5's plain versions by the route, claims in slot order; the pod
    pinned to the zone no type offers lands on the node there."""
    got = {}
    for pkg in PKGS:
        corpus = _mod(pkg, "cloudprovider.corpus")
        pods = _domain_batch(pkg)
        s = _solver(pkg, [_team_pool(pkg, [f"team-{i}" for i in range(N_TEAMS)])],
                    corpus.generate(20), pods, _nodes(pkg), classed=classed)
        got[pkg] = _decisions(s.solve(pods), pods)
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    claims, existing, _ = got["karpenter_tpu"]
    assert claims and any("outside-in" in pods for _, pods in existing)


# -- TorchSolver against TpuSolver on ROADMAP §C1's inputs ------------------------


def test_solver_team_in_list():
    """A NodePool listing 1,100 teams (``example.com/team In [team-0 ..
    team-1099]``) with 40 pods, pod i selecting team-i: padded shape
    (16, 2048), 40 claims, the same decisions in slot order."""
    got = {}
    for pkg in PKGS:
        corpus = _mod(pkg, "cloudprovider.corpus")
        wl = _mod(pkg, "solver.workloads")
        pods = [wl._pod(f"team-{i}", 500, 1024, node_selector={TEAM_KEY: f"team-{i}"})
                for i in range(40)]
        s = _solver(pkg, [_team_pool(pkg, [f"team-{i}" for i in range(N_TEAMS)])],
                    corpus.generate(400), pods)
        got[pkg] = _decisions(s.solve(pods), pods)
        if pkg == "karpenter_tpu_torch":
            assert _snapshot(s, pods).vocab.padded_shape() == (16, 2048)
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert len(got["karpenter_tpu"][0]) == 40 and not got["karpenter_tpu"][2]


def test_solver_instance_type_minvalues_1100_types():
    """minValues 2 on the instance type over 1,100 types (a floor over a
    catalog wider than 1,024 values: MW 2048) at mixed_pods(2000): the
    same decisions in slot order."""
    got = {}
    for pkg in PKGS:
        corpus = _mod(pkg, "cloudprovider.corpus")
        labels = _mod(pkg, "api.labels")
        objs = _mod(pkg, "api.objects")
        pool = objs.NodePool(metadata=objs.ObjectMeta(name="default"), spec=objs.NodePoolSpec(
            template=objs.NodeClaimTemplate(spec=objs.NodeClaimSpec(requirements=[
                objs.NodeSelectorRequirement(labels.INSTANCE_TYPE, "Exists", (),
                                             min_values=2)]))))
        pods = _mod(pkg, "solver.workloads").mixed_pods(2000)
        s = _solver(pkg, [pool], corpus.generate(1100), pods)
        got[pkg] = _decisions(s.solve(pods), pods)
        if pkg == "karpenter_tpu_torch":
            assert _snapshot(s, pods).t_mvoh.shape[-1] == 2048
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert got["karpenter_tpu"][0] and not got["karpenter_tpu"][2]
