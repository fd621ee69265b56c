"""Port parity for the reservation ledger (NRES > 0), on the CPU.

Offerings of Karpenter's reserved capacity type carry a reservation id
and a capacity (reservationmanager.go:28-85). With
``reserved_capacity_enabled`` the JAX package excludes them from the
offering table ``a_tzc`` and carries them as a ledger: ``res_cap0``
[NRES] capacities, ``a_res`` [NRES, T, Vz, Vc] availability, the scan's
``res_rem`` carry and each claim's ``c_resv``. The port's plain version
of kernel B4 must equal JAX ``pack`` exactly:

(a) ``pack_reference`` against JAX ``pack``: a bulk that drains its only
    reservation, domain-pinned bulks (zonal spread), existing nodes,
    minValues floors and the ledger together, and the scenario-batched
    solve (every scenario replays a fresh ledger) against JAX's vmapped
    one;
(b) ``TorchSolver(device="cpu")`` against ``TpuSolver``: claims in slot
    order and the reservations each claim holds (``reserved_offerings``);
(c) the port of tests/test_dense_constraints.py:TestScenarioReservations:
    a scenario batch equals per-scenario sequential solves, and the strict
    reservation mode still declines to the host oracle.

Tolerance: exact equality throughout.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from helpers import make_nodepool, make_pods
from karpenter_tpu.solver.workloads import constrained_mix, mixed_pods
from test_torch_minvalues import _nodes, assert_pack_equal, mv_pool, snapshot

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def reserved_types(pkg, n_types, every, capacity, zones=("test-zone-a",)):
    """corpus.generate(n_types) of ``pkg`` with one reserved offering (price
    0.001, reservation id ``res-<type>``, ``capacity``) in each of ``zones``
    on every ``every``-th type, built as
    tests/test_dense_constraints.py:TestScenarioReservations builds them."""
    labels = _mod(pkg, "api.labels")
    cp = _mod(pkg, "cloudprovider.types")
    rq = _mod(pkg, "api.requirements")
    its = _mod(pkg, "cloudprovider.corpus").generate(n_types)
    for it in its[every - 1::every]:
        for zone in zones:
            it.offerings.append(cp.Offering(
                requirements=rq.Requirements(
                    rq.Requirement(labels.CAPACITY_TYPE_LABEL_KEY, rq.Operator.IN,
                                   [labels.CAPACITY_TYPE_RESERVED]),
                    rq.Requirement(labels.TOPOLOGY_ZONE, rq.Operator.IN, [zone]),
                    rq.Requirement(cp.RESERVATION_ID_LABEL, rq.Operator.IN,
                                   [f"res-{it.name}-{zone}"]),
                ),
                price=0.001, available=True, reservation_capacity=capacity,
            ))
    return its


# -- (a) the plain scan against JAX's ---------------------------------------------


# (pods, pools, state nodes, catalog size, reserved every, capacity, zones)
PACK_CASES = {
    # one reservation of capacity 1: the first bulk drains it
    "drain-only-reservation": lambda: (make_pods(8, cpu="1"), None, (), 4, 4, 1,
                                       ("test-zone-a",)),
    "mixed": lambda: (mixed_pods(300, gpu_fraction=0.0), None, (), 40, 5, 3,
                      ("test-zone-a",)),
    "mixed-two-zones": lambda: (mixed_pods(200, gpu_fraction=0.0), None, (), 30, 3, 2,
                                ("test-zone-a", "test-zone-b")),
    # zonal spread: domain-pinned bulks count only reservations in their zone
    "domain-pinned": lambda: (constrained_mix(300), None, (), 30, 4, 2,
                              ("test-zone-a", "test-zone-c")),
    "domain-pinned-nodes": lambda: (constrained_mix(200), None, _nodes(4), 30, 3, 5,
                                    ("test-zone-b",)),
    "existing-nodes": lambda: (mixed_pods(200, gpu_fraction=0.0), None, _nodes(3), 30, 4, 2,
                               ("test-zone-a",)),
    # minValues floors and the ledger in one scan
    "with-minvalues": lambda: (mixed_pods(200, gpu_fraction=0.0), [mv_pool()], (), 30, 4, 2,
                               ("test-zone-a",)),
}


def _case_snapshot(case):
    pods, pools, nodes, n_types, every, cap, zones = PACK_CASES[case]()
    its = reserved_types("karpenter_tpu", n_types, every, cap, zones)
    return snapshot(pods, pools or [make_nodepool()], its=its, state_nodes=nodes,
                    reserved_capacity_enabled=True)


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_reference_matches_jax(case):
    """pack_reference == JAX pack with a reservation ledger: the 10
    outputs, c_resv among them."""
    from test_torch_classed import _both_scans

    a, statics, _ = _case_snapshot(case)
    assert a["res_cap0"].shape[0] > 0
    j, t = _both_scans(a, statics, nmax=128)
    assert_pack_equal(j, t)
    c_resv = np.asarray(j[0].c_resv)
    assert c_resv.any(), "no claim holds a reservation"
    if case.startswith("drain"):
        assert int(c_resv.sum()) == 1 and not np.asarray(j[0].res_rem).any()
    if case.startswith("domain"):
        assert statics["has_domains"]


@pytest.mark.parametrize("S,real", [(8, 5), (16, 12)])
def test_scenario_batch_matches_jax(S, real):
    """B7's plain version with a ledger: seeded per-scenario group counts
    and removed nodes, each scenario replaying res_cap0 from the start,
    against JAX's vmapped solve_all_scenarios_packed."""
    from karpenter_tpu_torch.ops.solve import solve_scenarios_core_packed
    from karpenter_tpu_torch.solver.args import to_device_args
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from test_torch_scenarios import _assert_outputs_equal, _jax_scenarios

    a, statics, _ = _case_snapshot("existing-nodes")
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
    resv = port[9].numpy()
    assert resv[:real].any(axis=1).sum() >= 2  # several scenarios reserve


# -- (b) TorchSolver against TpuSolver ----------------------------------------------


def held(results):
    """Per claim in slot order: the reservation ids it holds."""
    return [tuple(sorted(o.reservation_id() for o in c.reserved_offerings))
            for c in results.new_node_claims]


def solve_both(pods, n_types, every, capacity, zones=("test-zone-a",), pools=None,
               state_nodes=(), **solver_kw):
    """TpuSolver and TorchSolver(device="cpu") with reserved capacity
    enabled over the same batch. Returns ({pkg: (signature, held)},
    {pkg: solver})."""
    from test_torch_residency import port_state_node, signature, to_port

    out, solvers = {}, {}
    for pkg in PKGS:
        tpkg = pkg == "karpenter_tpu_torch"
        conv = to_port if tpkg else (lambda x: x)
        drv = _mod(pkg, "solver.driver")
        ps = [conv(p) for p in (pools or [make_nodepool()])]
        its = {p.name: reserved_types(pkg, n_types, every, capacity, zones) for p in ps}
        nodes = [port_state_node(sn) if tpkg else sn for sn in state_nodes]
        batch = [conv(p) for p in pods]
        kube = _mod(pkg, "kube")
        topo = _mod(pkg, "scheduling.topology").Topology(
            kube.Client(kube.TestClock()), nodes, ps, its, batch)
        cls = drv.TorchSolver if tpkg else drv.TpuSolver
        cfg = drv.SolverConfig(device="cpu") if tpkg else drv.SolverConfig()
        solver = cls(ps, its, topo, state_nodes=nodes, config=cfg,
                     encode_cache=drv.EncodeCache(), reserved_capacity_enabled=True,
                     **solver_kw)
        res = solver.solve(batch)
        out[pkg] = (signature(res), held(res))
        solvers[pkg] = solver
    return out, solvers


SOLVER_CASES = {
    "drain-only-reservation": lambda: dict(pods=make_pods(8, cpu="1"), n_types=4,
                                           every=4, capacity=1),
    "mixed-300": lambda: dict(pods=mixed_pods(300, gpu_fraction=0.0), n_types=40, every=5,
                              capacity=3),
    "constrained-300": lambda: dict(pods=constrained_mix(300), n_types=30, every=4,
                                    capacity=2, zones=("test-zone-a", "test-zone-c")),
    "state-nodes": lambda: dict(pods=mixed_pods(200, gpu_fraction=0.0), n_types=30, every=4,
                                capacity=2, state_nodes=_nodes(3)),
    "minvalues-pool": lambda: dict(pods=mixed_pods(200, gpu_fraction=0.0), n_types=30,
                                   every=4, capacity=2, pools=[mv_pool()]),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_equals_tpu_solver(case):
    out, solvers = solve_both(**SOLVER_CASES[case]())
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]
    assert any(out["karpenter_tpu"][1]), "no claim holds a reservation"
    assert solvers["karpenter_tpu_torch"].fallback_solves == 0


@pytest.mark.parametrize("capacity", [1, 2])
def test_mixed_batch_hands_reservations_to_oracle(capacity):
    """A batch split between the kernel path and the host oracle (host-port
    pods route to the oracle) books each reservation once: the oracle's
    ReservationManager is handed the kernel claims' holdings before it
    solves the rest, so the port holds the same reservations on the same
    claim slots as TpuSolver."""
    pods = make_pods(8, cpu="1") + make_pods(4, cpu="1", host_ports=[8080])
    out, solvers = solve_both(pods, n_types=4, every=4, capacity=capacity)
    assert out["karpenter_tpu_torch"] == out["karpenter_tpu"]
    held_ids = [r for claim in out["karpenter_tpu"][1] for r in claim]
    assert held_ids and len(held_ids) <= capacity  # never booked past capacity
    assert solvers["karpenter_tpu_torch"].fallback_solves == 1  # the oracle-routed pods


# -- (c) TestScenarioReservations, on the port ----------------------------------------


def _scenario_solver(pkg, pods, **kw):
    drv = _mod(pkg, "solver.driver")
    kube = _mod(pkg, "kube")
    pool = make_nodepool()
    if pkg == "karpenter_tpu_torch":
        from test_torch_residency import to_port

        pool, pods = to_port(pool), to_port(pods)
    its = {pool.name: reserved_types(pkg, 4, 2, 1)}
    topo = _mod(pkg, "scheduling.topology").Topology(
        kube.Client(kube.TestClock()), [], [pool], its, pods)
    cfg = drv.SolverConfig(device="cpu") if pkg == "karpenter_tpu_torch" else None
    return drv.TpuSolver if pkg == "karpenter_tpu" else drv.TorchSolver, \
        dict(node_pools=[pool], instance_types=its, topology=topo, config=cfg,
             reserved_capacity_enabled=True, **kw), pods


def _sig(results):
    return (len(results.new_node_claims),
            sorted(len(c.reserved_offerings) for c in results.new_node_claims),
            len(results.pod_errors))


def test_batched_matches_per_scenario_sequential():
    """Each scenario of one batch consumes a fresh ledger replay: the
    batch equals per-scenario solves on fresh solvers, in both packages."""
    got = {}
    for pkg in PKGS:
        Scenario = _mod(pkg, "solver.driver").Scenario
        pods = make_pods(6, cpu="1")
        cls, kw, pods = _scenario_solver(pkg, pods)
        solver = cls(**kw)
        subsets = [pods[:2], pods[:4], pods]
        batched = solver.solve_scenarios([Scenario(pods=s) for s in subsets])
        assert batched is not None and solver.last_scenario_dispatches >= 1
        seq = []
        for k in (2, 4, 6):
            cls2, kw2, sub = _scenario_solver(pkg, make_pods(6, cpu="1")[:k])
            seq.append(_sig(cls2(**kw2).solve(sub)))
        assert [_sig(r) for r in batched] == seq
        got[pkg] = seq
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert any(s[1] and s[1][-1] for s in got["karpenter_tpu"])


def test_strict_mode_still_declines():
    """The strict reservation mode raises mid-Add in the oracle: solve goes
    to the host oracle before anything is encoded, and solve_scenarios
    declines, both counted as fallbacks, in both packages."""
    got = {}
    for pkg in PKGS:
        inflight = _mod(pkg, "scheduling.inflight")
        Scenario = _mod(pkg, "solver.driver").Scenario
        pods = make_pods(3, cpu="1")
        cls, kw, pods = _scenario_solver(
            pkg, pods, reserved_offering_mode=inflight.RESERVED_OFFERING_MODE_STRICT)
        solver = cls(**kw)
        assert solver.solve_scenarios([Scenario(pods=pods)]) is None
        assert solver.fallback_solves >= 1
        before = solver.fallback_solves
        res = solver.solve(pods)
        assert solver.fallback_solves == before + 1
        assert solver.last_dispatches == 0
        got[pkg] = (_sig(res), sorted(solver.last_fallback_reasons))
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
