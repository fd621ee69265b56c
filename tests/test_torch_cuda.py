"""The CUDA kernels against their plain versions, on the card.

Every case builds its inputs with the port alone (no jax, no
karpenter_tpu: the card's machine has neither), runs the fused solve on
CUDA tensors — kernels B1, B2, B4, B6 — and on CPU tensors — their plain
versions — and requires exact equality of every output. The cases reach
the pack kernel's paths the chip smoke's mixed batch does not: hostname
caps and affinity, shared hostname slots, existing nodes, the NodePool
limit ledger over weighted templates, and overflow.

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
from karpenter_tpu_torch.ops.solve import solve_core, wire_pack
from karpenter_tpu_torch.scheduling.topology import Topology
from karpenter_tpu_torch.solver import encode as enc
from karpenter_tpu_torch.solver.args import to_device_args
from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver
from karpenter_tpu_torch.solver.example import (
    example_nodepool,
    example_snapshot_arrays,
    example_state_nodes,
)
from karpenter_tpu_torch.solver.workloads import mixed_pods, spot_od_pools

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
