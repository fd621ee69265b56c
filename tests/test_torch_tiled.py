"""Port parity for the tiled mode (``tile_feasibility``), on the CPU.

Past ~1.5 GiB of [P, G, T] feasibility tables (``P * G * T * 5`` bytes)
the JAX driver stops materialising them: the scan builds each step's
rows from the mask arrays (karpenter_tpu/ops/packing.py:_tile_rows; once
per class head in pack_classed). The port's plain versions do the same
(``ops/packing.py:_tile_rows_reference``); kernels B4, B5 and B7's grid
build the rows in device scratch (tests/test_torch_cuda.py holds them to
these plain versions on the card).

Each case sends the same encoded arrays through the JAX program with
``tile_feasibility=True`` (``solve_all``, ``solve_all_classed_packed``,
``solve_all_scenarios_packed``, on the CPU) and through the port's plain
tiled version, and requires exact equality of every output; the same
case holds the port's tiled run to its own untiled run. The cases: the
three of tests/test_solver_parity.py:TestTiledFeasibility (plain;
zonal and hostname spread; two existing nodes), contributor counting on
a small diverse mix, a minValues pool, a reservation ledger, the
class-batched scan over a diverse mix, a scenario batch of three with
distinct ``n_tol``, and a 4-tenant set of tainted, limited NodePools
(the tenant cell's shape at 24 types and 40 Deployments). The gate test
encodes 6,000 one-replica Deployments over 64 tenant pools and 800
types, where both drivers choose the tiled mode.

Tolerance: exact equality throughout.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import make_nodepool, make_pods, make_state_node, snapshot_args, spread_constraint
from karpenter_tpu.api import labels
from karpenter_tpu.solver.workloads import diverse_reference_mix, mixed_pods
from karpenter_tpu_torch.ops.solve import (
    solve_core,
    solve_core_classed_packed,
    solve_scenarios_core_packed,
)
from karpenter_tpu_torch.solver.args import to_device_args
from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

OUT_NAMES = ("c_pool", "c_tmask", "n_open", "overflow", "exist_fills",
             "claim_fills", "unplaced", "c_dzone", "c_dct", "c_resv")
TILED = dict(tile_feasibility=True, sparse_groups=False)
UNTILED = dict(tile_feasibility=False, sparse_groups=True)


def _equal(port, ref, what):
    assert len(port) == len(ref) == 10
    for name, p, r in zip(OUT_NAMES, port, ref):
        p, r = p.numpy(), np.asarray(r)
        assert p.shape == r.shape, f"{what} {name}: {p.shape} vs {r.shape}"
        mism = np.argwhere(p.astype(r.dtype) != r)
        assert not mism.size, f"{what} {name} diverges at {mism[:5].tolist()}"


def _statics(statics, nmax=None):
    st = {k: v for k, v in statics.items() if k not in ("tile_feasibility", "sparse_groups")}
    if nmax is not None:
        st["nmax"] = nmax
    return st


def solve_three(args, statics, nmax=None):
    """JAX solve_all tiled, the port's solve_core tiled and untiled on the
    same arrays; the three must agree on all 10 outputs. Returns the JAX
    outputs."""
    import jax
    from karpenter_tpu.ops.solve import solve_all

    st = _statics(statics, nmax)
    args = [np.asarray(x) for x in args]
    want = [np.asarray(x) for x in jax.device_get(solve_all(*args, **st, **TILED))]
    tiled = solve_core(*to_device_args(args, "cpu"), **st, **TILED)
    _equal(tiled, want, "tiled vs JAX")
    untiled = solve_core(*to_device_args(args, "cpu"), **st, **UNTILED)
    _equal(untiled, [t.numpy() for t in tiled], "untiled vs tiled")
    return want


def _named(a):
    return [a[n] for n in SOLVE_ARG_NAMES]


# -- tests/test_solver_parity.py:TestTiledFeasibility -----------------------------


def _tiled_state_node(name, zone="test-zone-a"):
    from karpenter_tpu.api import resources as res
    from karpenter_tpu.api.objects import Node, ObjectMeta
    from karpenter_tpu.controllers.state import StateNode

    node = Node(metadata=ObjectMeta(name=name, labels={labels.TOPOLOGY_ZONE: zone,
                                                       labels.HOSTNAME: name}))
    node.status.capacity = {"cpu": res.parse_quantity("8"),
                            "memory": res.parse_quantity("32Gi")}
    node.status.allocatable = dict(node.status.capacity)
    node.status.ready = True
    return StateNode(node=node)


@pytest.mark.parametrize("workload", ["plain", "topology", "existing-nodes"])
def test_tiled_feasibility_cases(workload):
    """TestTiledFeasibility's three batches over a weighted pool pair (the
    heavier one limited): the port's tiled scan == JAX's, == its own
    untiled scan."""
    state_nodes = ()
    node_pools = [make_nodepool("low", weight=1),
                  make_nodepool("high", weight=50, limits={"cpu": "64"})]
    if workload == "plain":
        pods = make_pods(60, cpu="1", memory="1Gi") + make_pods(30, cpu="2", memory="4Gi")
    elif workload == "existing-nodes":
        pods = make_pods(20, cpu="1", memory="1Gi") + make_pods(6, cpu="2", memory="4Gi")
        state_nodes = (_tiled_state_node("t-n1"), _tiled_state_node("t-n2"))
    else:
        app = {"t": "zs"}
        pods = (make_pods(40, cpu="1")
                + make_pods(12, cpu="1", labels=app,
                            spread=[spread_constraint(labels.TOPOLOGY_ZONE, labels=app)])
                + make_pods(8, cpu="2", labels={"t": "hs"},
                            spread=[spread_constraint(labels.HOSTNAME, labels={"t": "hs"})]))
    args, statics = snapshot_args(pods, node_pools=node_pools, n_types=24,
                                  state_nodes=state_nodes)
    out = solve_three(args, statics)
    assert int(out[2]) > 0
    if workload == "existing-nodes":
        assert np.asarray(args[SOLVE_ARG_NAMES.index("n_avail")]).shape[0] == 2
        assert int(out[4].sum()) > 0  # the cap row placed pods on the nodes
    if workload == "topology":
        assert statics["has_domains"]


# -- contributors, minValues, the ledger ------------------------------------------


def test_tiled_contributors():
    """A small diverse mix on the per-group scan (classed off): contributor
    counting over the tiled rows."""
    from test_torch_classed import _snapshot

    a, statics, _ = _snapshot(diverse_reference_mix(120))
    assert statics["has_contrib"] and statics["has_domains"]
    out = solve_three(_named(a), statics, nmax=64)
    assert int(out[2]) > 0


def test_tiled_minvalues():
    """A minValues pool (instance-family Exists, minValues 2) over existing
    nodes."""
    from test_torch_minvalues import _nodes, mv_pool, snapshot

    a, statics, _ = snapshot(mixed_pods(200, gpu_fraction=0.0), [mv_pool()],
                             state_nodes=_nodes(3), n_types=30)
    assert a["p_mvmin"].any()
    out = solve_three(_named(a), statics, nmax=128)
    assert int(out[2]) > 0


def test_tiled_reservation_ledger():
    """A reservation ledger (reserved offerings in two zones, capacity 2):
    bulks drain reservations over the tiled rows."""
    from test_torch_minvalues import snapshot
    from test_torch_reservations import reserved_types

    its = reserved_types("karpenter_tpu", 30, 3, 2, ("test-zone-a", "test-zone-b"))
    a, statics, _ = snapshot(mixed_pods(200, gpu_fraction=0.0), [make_nodepool()], its=its,
                             reserved_capacity_enabled=True)
    assert a["res_cap0"].shape[0] > 0
    out = solve_three(_named(a), statics, nmax=128)
    assert bool(out[9].any())  # claims hold reservations


# -- the class-batched scan -------------------------------------------------------


@pytest.mark.parametrize("n_nodes", [0, 4])
def test_tiled_classed(n_nodes):
    """B5's plain version in the tiled mode (one row build per class head)
    over a diverse mix: == JAX solve_all_classed_packed tiled, == the
    port's untiled classed solve."""
    import jax
    import jax.numpy as jnp
    from karpenter_tpu.ops.solve import solve_all_classed_packed
    from test_torch_classed import _snapshot, _zonal_nodes

    a, statics, classes = _snapshot(diverse_reference_mix(160),
                                    state_nodes=_zonal_nodes(n_nodes) if n_nodes else ())
    *arrs, lmax = classes
    st = _statics(statics, 64)
    args = _named(a)
    want = [np.asarray(x) for x in jax.device_get(solve_all_classed_packed(
        *args, *arrs, lmax=lmax, fills_dtype=jnp.int32, **st, **TILED))]
    cls = [torch.from_numpy(np.asarray(x)) for x in arrs]
    got = {mode: solve_core_classed_packed(*to_device_args(args, "cpu"), *cls, lmax=lmax,
                                           fills_dtype=torch.int32, **st, **kw)
           for mode, kw in (("tiled", TILED), ("untiled", UNTILED))}
    _equal(got["tiled"], want, "classed tiled vs JAX")
    _equal(got["untiled"], want, "classed untiled vs tiled")
    assert int(want[2]) > 0


# -- the scenario grid ------------------------------------------------------------


def test_tiled_scenarios_distinct_n_tol():
    """Three scenarios over four nodes, each with its own removed nodes
    (n_tol [3, N, G]) and group counts: the cap row reads each scenario's
    own n_tol. == JAX's vmapped tiled solve, == the port's untiled one."""
    from test_torch_minvalues import _nodes, snapshot
    from test_torch_scenarios import _jax_scenarios

    a, statics, _ = snapshot(mixed_pods(150, gpu_fraction=0.0), [make_nodepool()],
                             state_nodes=_nodes(4), n_types=20)
    G, (N, _) = a["g_count"].shape[0], a["n_tol"].shape
    rng = np.random.default_rng(3)
    g_count = np.stack([rng.integers(0, a["g_count"] + 1) for _ in range(3)]).astype(np.int32)
    n_tol = np.stack([a["n_tol"] & keep[:, None] for keep in (
        np.ones(N, bool), np.arange(N) % 2 == 0, np.arange(N) >= 2)])
    assert len({t.tobytes() for t in n_tol}) == 3
    args = to_device_args(_named(dict(a, g_count=g_count, n_tol=n_tol)), "cpu")
    st = _statics(statics)
    want = _jax_scenarios(args, dict(st, **TILED), 64, torch.int32, False)
    for kw in (TILED, UNTILED):
        got = solve_scenarios_core_packed(*args, nmax=64, fills_dtype=torch.int32,
                                          batch_topo=False, **st, **kw)
        _equal(got, want, f"scenarios {kw}")
    assert int(np.asarray(want[4]).sum()) > 0  # nodes took pods


# -- the tenant cell's shape ------------------------------------------------------


def _tenant_objects(n_tenants, n_deployments, n_types, **kw):
    """The port's tenant pools and pods (solver/example.py) rebuilt as JAX
    objects, and the JAX catalog of ``n_types`` types."""
    from karpenter_tpu.cloudprovider import corpus
    from karpenter_tpu_torch.solver.example import tenant_pods, tenant_pools
    from test_torch_residency import to_jax

    pool_kw = {"cpu_limit": kw.pop("cpu_limit")} if "cpu_limit" in kw else {}
    pools = to_jax(tenant_pools(n_tenants, **pool_kw))
    pods = to_jax(tenant_pods(n_deployments, n_tenants, **kw))
    return pools, pods, corpus.generate(n_types)


@pytest.mark.parametrize("cpu_limit", [4000, 24])
def test_tiled_tenant_pools(cpu_limit):
    """Four tainted NodePools, each limited (4,000 CPUs: not binding; 24:
    binding), 40 VPA-sized Deployments over 24 types: the tiled scan ==
    JAX's, == the untiled scan. Each group tolerates one pool only."""
    from test_torch_minvalues import snapshot

    pools, pods, its = _tenant_objects(4, 40, 24, cpu_limit=cpu_limit)
    a, statics, _ = snapshot(pods, pools, its=its)
    assert a["p_has_limit"].all() and (a["p_tol"].sum(0)[a["g_count"] > 0] == 1).all()
    out = solve_three(_named(a), statics, nmax=256)
    assert int(out[2]) > 0
    assert (int(out[6].sum()) > 0) == (cpu_limit == 24)  # the quota binds


def test_gate_statics_match_jax():
    """6,000 one-replica Deployments over 64 tenant pools and 800 types:
    G buckets to 8192 and P * G * T * 5 = 2,097,152,000 B passes the
    1,610,612,736 B gate, so the port's _kernel_statics and JAX's both
    choose the tiled mode (sparse_groups its inverse) and agree on every
    static. Encode only."""
    import importlib

    from karpenter_tpu_torch.solver.driver import SolverConfig
    from test_torch_residency import to_port

    pools, pods, its = _tenant_objects(64, 6000, 800, replicas=1)
    statics = []
    for pkg, conv, kw in (("karpenter_tpu", lambda x: x, {}),
                          ("karpenter_tpu_torch", to_port,
                           {"config": SolverConfig(device="cpu")})):
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        kube, enc = mod("kube"), mod("solver.encode")
        solver_cls = mod("solver.driver").TpuSolver if pkg == "karpenter_tpu" else \
            mod("solver.driver").TorchSolver
        p_pools, p_pods, p_its = conv(pools), conv(pods), conv(its)
        itp = {p.name: list(p_its) for p in p_pools}
        topo = mod("scheduling.topology").Topology(
            kube.Client(kube.TestClock()), [], p_pools, itp, p_pods)
        solver = solver_cls(p_pools, itp, topo, **kw)
        groups, rest = enc.partition_and_group(p_pods, topology=topo)
        assert not rest
        snap, *_ = solver._encode_batch(groups)
        G = enc._next_pow2(len(snap.groups), floor=8)
        P, T = len(snap.templates), len(snap.instance_types)
        assert (G, P, T) == (8192, 64, 800) and P * G * T * 5 == 2_097_152_000 > 3 << 29
        statics.append(solver._kernel_statics(snap, G))
    assert statics[0] == statics[1]
    assert statics[1]["tile_feasibility"] and not statics[1]["sparse_groups"]
