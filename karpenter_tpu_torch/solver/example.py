# Copied from karpenter_tpu/solver/example.py, building TorchSolvers; example_state_nodes, minvalues_nodepool, reserved_catalog, tenant_pools and tenant_pods are new.
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


def minvalues_nodepool(name: str = "default", min_values: int = 2) -> NodePool:
    """A NodePool whose one requirement is instance-family Exists with a
    minValues floor: every claim keeps at least ``min_values`` families
    among its instance-type options."""
    from ..api.objects import NodeClaimSpec, NodeClaimTemplate, NodeSelectorRequirement

    return NodePool(metadata=ObjectMeta(name=name), spec=NodePoolSpec(
        template=NodeClaimTemplate(spec=NodeClaimSpec(requirements=[
            NodeSelectorRequirement(corpus.INSTANCE_FAMILY_LABEL, "Exists", (),
                                    min_values=min_values)]))))


def reserved_catalog(n_types: int, every: int = 25, capacity: int = 20,
                     zones=("test-zone-a",)):
    """corpus.generate(n_types) with one reserved offering (capacity type
    reserved, price 0.001, reservation id ``res-<type>-<zone>``,
    ``capacity``) in each of ``zones`` on every ``every``-th type: on-demand
    capacity reservations, which a solver with
    ``reserved_capacity_enabled`` carries as a reservation ledger."""
    from ..api import labels as labels_mod
    from ..api.requirements import Operator, Requirement, Requirements
    from ..cloudprovider import types as cp

    its = corpus.generate(n_types)
    for it in its[every - 1::every]:
        for zone in zones:
            it.offerings.append(cp.Offering(
                requirements=Requirements(
                    Requirement(labels_mod.CAPACITY_TYPE_LABEL_KEY, Operator.IN,
                                [labels_mod.CAPACITY_TYPE_RESERVED]),
                    Requirement(labels_mod.TOPOLOGY_ZONE, Operator.IN, [zone]),
                    Requirement(cp.RESERVATION_ID_LABEL, Operator.IN, [f"res-{it.name}-{zone}"]),
                ),
                price=0.001, available=True, reservation_capacity=capacity,
            ))
    return its


def tenant_pools(n: int, cpu_limit: int = 4000) -> List[NodePool]:
    """``n`` NodePools ``tenant-00`` ... one per tenant team of a shared
    cluster: each template carries the taint ``tenant=tNN:NoSchedule``
    (only that tenant's pods land there) and each pool is capped by
    ``spec.limits`` at ``cpu_limit`` CPUs, a team quota."""
    from ..api.objects import NodeClaimSpec, NodeClaimTemplate, Taint

    return [
        NodePool(metadata=ObjectMeta(name=f"tenant-{i:02d}"), spec=NodePoolSpec(
            template=NodeClaimTemplate(spec=NodeClaimSpec(
                taints=[Taint(key="tenant", value=f"t{i:02d}", effect="NoSchedule")])),
            limits={res.CPU: cpu_limit * res.MILLI}))
        for i in range(n)
    ]


def tenant_pods(n_deployments: int, n_tenants: int, seed: int = 17,
                replicas: Optional[int] = None, first: int = 0) -> List[Pod]:
    """Deployments ``first`` ... ``first + n_deployments - 1``, deployment d
    of tenant d % ``n_tenants``, each with its own requests
    (VPA-rightsized: cpu 50..4000m in steps of 10, memory 64..16384 Mi in
    steps of 16) and 1..16 replicas (or ``replicas``), drawn in order from
    ``random.Random(seed)``; every pod tolerates its tenant's taint
    (``tenant_pools``) and carries the label ``app=d<N>``."""
    import random

    from ..api.objects import Toleration

    rng = random.Random(seed)
    pods = []
    for d in range(first, first + n_deployments):
        cpu_m = rng.randrange(50, 4001, 10)
        mem_mi = rng.randrange(64, 16385, 16)
        count = rng.randint(1, 16) if replicas is None else replicas
        tol = Toleration(key="tenant", operator="Equal", value=f"t{d % n_tenants:02d}",
                         effect="NoSchedule")
        for r in range(count):
            pods.append(Pod(
                metadata=ObjectMeta(name=f"d{d}-{r}", labels={"app": f"d{d}"}),
                spec=PodSpec(
                    requests={res.CPU: cpu_m, res.MEMORY: mem_mi * 2**20 * res.MILLI},
                    tolerations=[tol],
                ),
            ))
    return pods
