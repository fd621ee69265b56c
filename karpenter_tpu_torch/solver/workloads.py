# Copied from karpenter_tpu/solver/workloads.py, without diverse_reference_mix; the consolidation envs take a device; adds churn_tick.
"""Benchmark workload generators (BASELINE.json configs).

Deterministic (seeded) pod/cluster builders mirroring the reference's
benchmark harness (scheduling_benchmark_test.go:236-249 and its random
cpu/memory/label tables) plus the BASELINE-specific configs. Used by
bench.py and tests/test_perf_floor.py; kept in the package so the solver
sidecar can regenerate identical workloads.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

from ..api import labels as labels_mod
from ..api import resources as res
from ..api.objects import (
    LabelSelector,
    NodeSelectorRequirement,
    ObjectMeta,
    NodeAffinity,
    Pod,
    PodSpec,
    TopologySpreadConstraint,
)

# the reference's random tables (scheduling_benchmark_test.go:357-381)
_CPUS_M = (100, 250, 500, 1000, 1500)
_MEM_MI = (100, 256, 512, 1024, 2048, 4096)
_LABEL_VALUES = ("a", "b", "c", "d", "e", "f", "g")

_MI = 2**20 * res.MILLI


def _pod(name: str, cpu_m: int, mem_mi: int, labels: Dict[str, str] = None,
         gpu: int = 0, **spec_kwargs) -> Pod:
    requests = {res.CPU: cpu_m, res.MEMORY: mem_mi * _MI}
    if gpu:
        requests["nvidia.com/gpu"] = gpu * res.MILLI
    return Pod(
        metadata=ObjectMeta(name=name, labels=dict(labels or {})),
        spec=PodSpec(requests=requests, **spec_kwargs),
    )


def identical_pods(count: int) -> List[Pod]:
    """BASELINE config[0]: identical cpu/mem pods."""
    return [_pod(f"ident-{i}", 1000, 2048) for i in range(count)]


def mixed_pods(count: int, seed: int = 7, gpu_fraction: float = 0.05) -> List[Pod]:
    """BASELINE config[1]: mixed cpu/mem/gpu pods over the reference's
    random request tables."""
    rng = random.Random(seed)
    pods = []
    for i in range(count):
        gpu = 1 if rng.random() < gpu_fraction else 0
        pods.append(
            _pod(
                f"mixed-{i}",
                rng.choice(_CPUS_M),
                rng.choice(_MEM_MI),
                labels={"my-label": rng.choice(_LABEL_VALUES)},
                gpu=gpu,
            )
        )
    return pods


def _self_spread(key: str, labels: Dict[str, str], max_skew: int = 1):
    return TopologySpreadConstraint(
        max_skew=max_skew,
        topology_key=key,
        when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels=dict(labels)),
    )


def constrained_mix(count: int, seed: int = 11) -> List[Pod]:
    """BASELINE config[2]: nodeAffinity + topology spread (zone/hostname).

    Deployment-shaped: constraints are self-selecting per deployment (the
    realistic spread shape — a Deployment's constraint selects its own
    replicas), so the whole mix rides the TPU fast path. 40% generic,
    20% zonal node affinity, 20% zonal spread, 20% hostname spread.
    """
    rng = random.Random(seed)
    pods: List[Pod] = []
    n_generic = count * 4 // 10
    n_aff = count * 2 // 10
    n_zspread = count * 2 // 10
    n_hspread = count - n_generic - n_aff - n_zspread

    for i in range(n_generic):
        pods.append(
            _pod(f"gen-{i}", rng.choice(_CPUS_M), rng.choice(_MEM_MI))
        )
    zones = ["test-zone-a", "test-zone-b", "test-zone-c"]
    for i in range(n_aff):
        pick = sorted(rng.sample(zones, 2))
        pods.append(
            _pod(
                f"aff-{i}", rng.choice(_CPUS_M), rng.choice(_MEM_MI),
                node_affinity=NodeAffinity(
                    required=[
                        (
                            NodeSelectorRequirement(
                                labels_mod.TOPOLOGY_ZONE, "In", tuple(pick)
                            ),
                        )
                    ]
                ),
            )
        )
    # spread classes: deployments of ~500 replicas, one shape each so every
    # deployment is a single tensor group
    def deployments(n: int, key: str, prefix: str) -> None:
        size = 500
        d = 0
        while n > 0:
            k = min(size, n)
            lbl = {prefix: f"d{d}"}
            cpu, mem = rng.choice(_CPUS_M), rng.choice(_MEM_MI)
            for i in range(k):
                pods.append(
                    _pod(
                        f"{prefix}-{d}-{i}", cpu, mem, labels=lbl,
                        topology_spread_constraints=[_self_spread(key, lbl)],
                    )
                )
            n -= k
            d += 1

    deployments(n_zspread, labels_mod.TOPOLOGY_ZONE, "zs")
    deployments(n_hspread, labels_mod.HOSTNAME, "hs")
    return pods


# the constrained-churn protocol's tick seed (bench.py:run_constraint_churn)
CHURN_SEED = 7


def churn_tick(pods: List[Pod], mix, rng: random.Random) -> List[Pod]:
    """One reconcile tick of bench.py's constrained-churn protocol: k =
    len(pods) // 100 pods (at least one) swapped for pods of a same-seed
    regeneration ``mix(len(pods))``, positions and picks drawn from
    ``rng`` (``random.Random(CHURN_SEED)`` for the protocol). The shape
    pool stays that of the mix; group counts shift, and now and then the
    label-keyed group set."""
    n = len(pods)
    k = max(1, n // 100)
    regen = mix(n)
    idx = rng.sample(range(n), k)
    jdx = rng.sample(range(len(regen)), k)
    out = list(pods)
    for i, j in zip(idx, jdx):
        out[i] = regen[j]
    return out


def spot_od_pools():
    """BASELINE config[4]: weighted spot + on-demand pools with limits."""
    from ..api.objects import (
        NodeClaimSpec, NodePool, NodePoolSpec,
        NodeClaimTemplate as NodeClaimTemplateSpec,
    )

    def pool(name: str, ct: str, weight: int, cpu_limit: str):
        return NodePool(
            metadata=ObjectMeta(name=name),
            spec=NodePoolSpec(
                template=NodeClaimTemplateSpec(
                    spec=NodeClaimSpec(
                        requirements=[
                            NodeSelectorRequirement(
                                labels_mod.CAPACITY_TYPE_LABEL_KEY, "In", (ct,)
                            )
                        ]
                    )
                ),
                weight=weight,
                limits={res.CPU: res.parse_quantity(cpu_limit)},
            ),
        )

    return [
        pool("spot", labels_mod.CAPACITY_TYPE_SPOT, 80, "3000"),
        pool("on-demand", labels_mod.CAPACITY_TYPE_ON_DEMAND, 20, "100000"),
    ]


def build_single_consolidation_env(n_nodes: int, device: str = "cuda") -> Tuple:
    """A single-node-consolidation variant of the consolidation env: same
    underutilized cluster, method = SingleNodeConsolidation (the
    per-candidate sweep the scenario batch evaluates in chunks). Returns
    (ctx, SingleNodeConsolidation, candidates, budgets)."""
    from ..controllers.disruption.methods import SingleNodeConsolidation

    ctx, _multi, candidates, budgets = build_consolidation_env(n_nodes, device)
    method = SingleNodeConsolidation(ctx)
    return ctx, method, candidates, budgets


def build_consolidation_env(n_nodes: int, device: str = "cuda") -> Tuple:
    """BASELINE config[3]: an underutilized cluster of ``n_nodes`` ready for
    multi-node consolidation.

    State is fabricated directly (Initialized NodeClaims + Nodes + one
    half-utilizing bound pod each) — the watch-fed Cluster ingests it
    exactly as live informer events would — so the benchmark times the
    consolidation search itself, not cluster bring-up. Every simulation
    solve runs on ``device`` ("cuda": the kernels; "cpu": their plain
    versions). Returns (ctx, MultiNodeConsolidation, candidates, budgets)."""
    from ..api.objects import (
        COND_CONSOLIDATABLE, COND_INITIALIZED, COND_LAUNCHED, COND_REGISTERED,
        Node, NodeClaim, NodeClaimSpec, NodePool, NodePoolSpec,
        NodeClaimTemplate as NodeClaimTemplateSpec,
    )
    from ..cloudprovider import corpus
    from ..cloudprovider.kwok import KwokCloudProvider
    from ..controllers.disruption.controller import DisruptionContext
    from ..controllers.disruption.helpers import (
        build_budget_mapping, get_candidates,
    )
    from ..controllers.disruption.methods import MultiNodeConsolidation
    from ..controllers.state import Cluster
    from ..events.recorder import Recorder
    from ..kube import Client, TestClock
    from .driver import SolverConfig

    clock = TestClock()
    clock.step(3600.0)
    client = Client(clock)
    its = corpus.generate(50)
    provider = KwokCloudProvider(client, its)
    cluster = Cluster(client)

    pool = NodePool(
        metadata=ObjectMeta(name="default"),
        spec=NodePoolSpec(template=NodeClaimTemplateSpec(spec=NodeClaimSpec())),
    )
    pool.spec.disruption.consolidate_after = 10.0
    client.create(pool)

    # a deliberately oversized node type: the filler pod uses <40% of it,
    # so consolidation can re-pack fillers onto fewer, cheaper nodes
    def fits(it):
        return (
            it.capacity.get(res.CPU, 0) >= 4000
            and it.capacity.get(res.MEMORY, 0) >= 8 * 1024 * _MI
        )

    candidates_it = sorted(
        (it for it in its if fits(it)),
        key=lambda it: min(
            (o.price for o in it.offerings if o.available), default=1e9
        ),
    )
    it = candidates_it[len(candidates_it) // 2]  # mid-priced: room to go cheaper
    offering = min(
        (o for o in it.offerings if o.available), key=lambda o: o.price
    )

    for i in range(n_nodes):
        name = f"bench-{i}"
        pid = f"bench://{i}"
        node_labels = {
            labels_mod.HOSTNAME: name,
            labels_mod.INSTANCE_TYPE: it.name,
            labels_mod.TOPOLOGY_ZONE: offering.zone(),
            labels_mod.CAPACITY_TYPE_LABEL_KEY: offering.capacity_type(),
            labels_mod.NODEPOOL_LABEL_KEY: pool.name,
        }
        claim = NodeClaim(
            metadata=ObjectMeta(name=name, labels=dict(node_labels)),
            spec=NodeClaimSpec(),
        )
        claim.status.provider_id = pid
        claim.status.capacity = dict(it.capacity)
        claim.status.allocatable = dict(it.allocatable())
        now = clock.now()
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED,
                     COND_CONSOLIDATABLE):
            claim.conds().set(cond, "True", now=now)
        node = Node(
            metadata=ObjectMeta(name=name, labels=node_labels),
            provider_id=pid,
        )
        node.status.capacity = dict(it.capacity)
        node.status.allocatable = dict(it.allocatable())
        node.status.ready = True
        filler = _pod(f"fill-{i}", 750, 1024)
        filler.spec.node_name = name
        filler.status.phase = "Running"
        client.create(claim)
        client.create(node)
        client.create(filler)

    ctx = DisruptionContext(
        client=client,
        cluster=cluster,
        cloud_provider=provider,
        clock=clock,
        recorder=Recorder(clock),
        spot_to_spot_enabled=True,
        solver_config=SolverConfig(device=device),
    )
    method = MultiNodeConsolidation(ctx)
    candidates = [
        c
        for c in get_candidates(
            ctx.client, ctx.cluster, ctx.cloud_provider, clock
        )
        if method.should_disrupt(c)
    ]
    budgets = build_budget_mapping(
        ctx.client, ctx.cluster, method.reason, clock.now()
    )
    return ctx, method, candidates, budgets
