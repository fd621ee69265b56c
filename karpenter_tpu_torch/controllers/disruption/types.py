# Copied from karpenter_tpu/controllers/disruption/types.py.
"""Disruption candidates and commands (reference: disruption/types.go:48-177,
pkg/utils/disruption/disruption.go:37-78)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ...api import labels as labels_mod
from ...api.objects import Node, NodeClaim, NodePool, Pod
from ...cloudprovider import types as cp

POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


def eviction_cost(pod: Pod) -> float:
    """Per-pod disruption cost in [-10, 10], default 1
    (disruption.go:48-70)."""
    cost = 1.0
    raw = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if raw is not None:
        try:
            cost += float(raw) / 2**27
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += pod.spec.priority / 2**25
    return max(-10.0, min(10.0, cost))


def rescheduling_cost(pods: List[Pod]) -> float:
    return sum(eviction_cost(p) for p in pods)


def lifetime_remaining(now: float, claim: NodeClaim) -> float:
    """Fraction of node lifetime remaining in [0, 1]
    (disruption.go:32-46)."""
    if claim.spec.expire_after is None:
        return 1.0
    age = now - claim.metadata.creation_timestamp
    total = claim.spec.expire_after
    if total <= 0:
        return 1.0
    return max(0.0, min(1.0, (total - age) / total))


@dataclass
class Candidate:
    """A state node eligible for disruption."""

    state_node: object  # controllers.state.StateNode
    node: Node
    node_claim: NodeClaim
    node_pool: NodePool
    instance_type: Optional[cp.InstanceType]
    capacity_type: str
    zone: str
    price: float
    disruption_cost: float
    reschedulable_pods: List[Pod] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def provider_id(self) -> str:
        return self.node.provider_id


@dataclass
class Command:
    """A disruption decision: delete candidates, optionally launching
    replacements first (types.go:119-141)."""

    candidates: List[Candidate] = field(default_factory=list)
    replacements: List[object] = field(default_factory=list)  # claim models
    reason: str = ""
    consolidation_type: str = ""

    @property
    def decision(self) -> str:
        if not self.candidates:
            return "no-op"
        return "replace" if self.replacements else "delete"
