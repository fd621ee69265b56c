# Copied from karpenter_tpu/solver/example.py, building TorchSolvers; example_state_nodes is new.
"""Self-contained example snapshot builders (no test fixtures needed).

Used by chip_smoke.py and the port's parity tests.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..api import resources as res
from ..api.objects import NodePool, NodePoolSpec, ObjectMeta, Pod, PodSpec
from ..cloudprovider import corpus
from ..kube import Client, TestClock
from ..scheduling.topology import Topology
from . import encode as enc
from .driver import SolverConfig, TorchSolver


def example_pods(count: int, shapes: int = 1, zonal: int = 0) -> List[Pod]:
    """``zonal`` of the pods additionally carry a self-selecting zonal
    topology-spread constraint, exercising the kernel's domain-quota path."""
    from ..api import labels as labels_mod
    from ..api.objects import LabelSelector, TopologySpreadConstraint

    pods = []
    for i in range(count):
        s = i % shapes
        spread = []
        pod_labels = {}
        if i < zonal:
            # one uniform shape: the zonal pods must form a single
            # equivalence class (a shared spread constraint across groups
            # demotes them all to the host oracle)
            s = 0
            pod_labels = {"example": "zonal"}
            spread = [
                TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=labels_mod.TOPOLOGY_ZONE,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=LabelSelector(match_labels=dict(pod_labels)),
                )
            ]
        pods.append(
            Pod(
                metadata=ObjectMeta(name=f"pod-{i}", labels=pod_labels),
                spec=PodSpec(
                    requests={
                        res.CPU: (1 + s % 7) * res.MILLI,
                        res.MEMORY: (1 + s % 9) * 2**30 * res.MILLI,
                    },
                    topology_spread_constraints=spread,
                ),
            )
        )
    return pods


def example_nodepool(name: str = "default") -> NodePool:
    return NodePool(metadata=ObjectMeta(name=name), spec=NodePoolSpec())


def example_solver(
    n_pods: int, n_types: int, shapes: int = 1, zonal: int = 0,
    config: Optional[SolverConfig] = None,
) -> Tuple[TorchSolver, List[Pod]]:
    pods = example_pods(n_pods, shapes, zonal=zonal)
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}
    topology = Topology(Client(TestClock()), [], pools, its, pods)
    return TorchSolver(pools, its, topology, config=config), pods


def example_snapshot_arrays(
    n_pods: int, n_types: int, shapes: int = 1, zonal: int = 0
):
    """Encoded snapshot + static kwargs for solve_core, ready to feed the
    kernels directly (host-side encode only: no device is touched)."""
    solver, pods = example_solver(
        n_pods, n_types, shapes, zonal=zonal, config=SolverConfig(device="cpu")
    )
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    assert not rest
    templates = solver.oracle.templates
    snap = enc.encode(
        groups,
        templates,
        {t.node_pool_name: t.instance_type_options for t in templates},
        daemon_overhead=solver.oracle.daemon_overhead,
    )
    a_tzc, res_cap0, a_res = solver._offering_availability(snap)
    nmax = solver._estimate_nmax(snap, solver._fit_matrix(snap))
    statics = dict(
        nmax=nmax,
        zone_kid=snap.zone_kid,
        ct_kid=snap.ct_kid,
        has_domains=bool((snap.g_dmode > 0).any()),
        has_contrib=bool(snap.g_hcontrib.any() or snap.g_dcontrib.any()),
    )
    return snap.solve_args(a_tzc, res_cap0, a_res), statics


def example_state_nodes(count: int, cpu_cores: int = 16, mem_gib: int = 64):
    """``count`` ready nodes (``cpu_cores`` CPUs, ``mem_gib`` GiB, 110 pods)
    spread over the corpus zones, as StateNodes; every other node already
    runs a pod that uses half its CPU and memory."""
    from ..api import labels as labels_mod
    from ..api.objects import Node
    from ..controllers.state import StateNode

    zones = corpus.DEFAULT_ZONES
    out = []
    for i in range(count):
        name = f"node-{i}"
        node = Node(
            metadata=ObjectMeta(
                name=name,
                labels={
                    labels_mod.TOPOLOGY_ZONE: zones[i % len(zones)],
                    labels_mod.HOSTNAME: name,
                },
            ),
        )
        node.status.capacity = {
            res.CPU: cpu_cores * res.MILLI,
            res.MEMORY: mem_gib * 2**30 * res.MILLI,
            res.PODS: 110 * res.MILLI,
        }
        node.status.allocatable = dict(node.status.capacity)
        node.status.ready = True
        sn = StateNode(node=node)
        if i % 2:
            pod = Pod(
                metadata=ObjectMeta(name=f"bound-{i}"),
                spec=PodSpec(
                    requests={
                        res.CPU: cpu_cores * res.MILLI // 2,
                        res.MEMORY: mem_gib * 2**30 * res.MILLI // 2,
                    },
                    node_name=name,
                ),
            )
            pod.status.phase = "Running"
            sn.update_pod(pod, is_daemon=False)
        out.append(sn)
    return out
