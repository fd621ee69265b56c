# Copied from karpenter_tpu/solver/workloads.py, pod and pool builders only.
"""Benchmark workload generators (BASELINE.json configs).

Deterministic (seeded) pod/cluster builders mirroring the reference's
benchmark harness (scheduling_benchmark_test.go:236-249 and its random
cpu/memory/label tables) plus the BASELINE-specific configs. Used by
bench.py and tests/test_perf_floor.py; kept in the package so the solver
sidecar can regenerate identical workloads.
"""

from __future__ import annotations

import random
from typing import Dict, List

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
