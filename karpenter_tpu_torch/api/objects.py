# Copied from karpenter_tpu/api/objects.py.
"""Core API objects (CRD-equivalents) as plain dataclasses.

Mirrors the reference's pkg/apis/v1 data model (nodepool.go, nodeclaim.go)
plus the slices of core k8s objects (Pod, Node, DaemonSet) the controllers
consume. These are in-process objects stored in karpenter_tpu.kube — there is
no real apiserver; the kube package provides the durable-store semantics.
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import labels as labels_mod
from . import resources as res
from .requirements import Requirement, Requirements

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"{next(_uid_counter):08x}-{uuid.uuid4().hex[:12]}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    finalizers: List[str] = field(default_factory=list)
    owner_uids: List[str] = field(default_factory=list)
    resource_version: int = 0


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str
    value: str = ""


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"
    value: str = ""
    effect: str = ""
    toleration_seconds: Optional[int] = None


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str
    values: Tuple[str, ...] = ()
    min_values: Optional[int] = None

    def to_requirement(self) -> Requirement:
        return Requirement(self.key, self.operator, self.values, min_values=self.min_values)


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    requirements: Tuple[NodeSelectorRequirement, ...]


@dataclass
class NodeAffinity:
    # OR-of-ANDs; only the first term is honored until relaxation removes it
    # (reference: requirements.go:104-108, preferences.go:103-124).
    required: List[Tuple[NodeSelectorRequirement, ...]] = field(default_factory=list)
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: Tuple[str, ...] = ()


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, target: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if target.get(k) != v:
                return False
        for expr in self.match_expressions:
            value = target.get(expr.key)
            if expr.operator == "In":
                if value is None or value not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if value is not None and value in expr.values:
                    return False
            elif expr.operator == "Exists":
                if value is None:
                    return False
            elif expr.operator == "DoesNotExist":
                if value is not None:
                    return False
            else:
                raise ValueError(f"unknown selector operator {expr.operator}")
        return True

    def key(self) -> tuple:
        # memoized: group_key hashes every constraint-carrying pod's
        # selectors in the 50k-pod hot loop
        k = getattr(self, "_key_cache", None)
        if k is None:
            k = (
                tuple(sorted(self.match_labels.items())),
                tuple(
                    sorted(
                        (e.key, e.operator, tuple(sorted(e.values)))
                        for e in self.match_expressions
                    )
                ),
            )
            object.__setattr__(self, "_key_cache", k)
        return k


@dataclass
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: Tuple[str, ...] = ()


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None
    node_affinity_policy: str = "Honor"  # Honor | Ignore
    node_taints_policy: str = "Ignore"  # Honor | Ignore


@dataclass
class HostPort:
    port: int
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class PersistentVolumeClaimRef:
    claim_name: str


@dataclass
class PodSpec:
    node_selector: Dict[str, str] = field(default_factory=dict)
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: List[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity: List[PodAffinityTerm] = field(default_factory=list)
    preferred_pod_affinity: List[WeightedPodAffinityTerm] = field(default_factory=list)
    preferred_pod_anti_affinity: List[WeightedPodAffinityTerm] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    requests: res.ResourceList = field(default_factory=dict)
    limits: res.ResourceList = field(default_factory=dict)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    host_ports: List[HostPort] = field(default_factory=list)
    volumes: List[PersistentVolumeClaimRef] = field(default_factory=list)
    node_name: str = ""
    scheduler_name: str = "default-scheduler"
    priority: Optional[int] = None
    priority_class_name: str = ""
    preemption_policy: str = "PreemptLowerPriority"
    restart_policy: str = "Always"
    termination_grace_period_seconds: Optional[int] = None


@dataclass
class PodCondition:
    type: str
    status: str
    reason: str = ""
    last_transition_time: float = 0.0


@dataclass
class PodStatus:
    phase: str = "Pending"
    conditions: List[PodCondition] = field(default_factory=list)
    nominated_node_name: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def name(self) -> str:
        return self.metadata.name

    def bound(self) -> bool:
        return bool(self.spec.node_name)


@dataclass
class NodeStatus:
    capacity: res.ResourceList = field(default_factory=dict)
    allocatable: res.ResourceList = field(default_factory=dict)
    ready: bool = False
    conditions: List[PodCondition] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provider_id: str = ""
    taints: List[Taint] = field(default_factory=list)
    status: NodeStatus = field(default_factory=NodeStatus)
    unschedulable: bool = False

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def uid(self) -> str:
        return self.metadata.uid


# --- NodeClaim -------------------------------------------------------------

# Status condition types (reference: nodeclaim_status.go:26-33)
COND_LAUNCHED = "Launched"
COND_REGISTERED = "Registered"
COND_INITIALIZED = "Initialized"
COND_CONSOLIDATABLE = "Consolidatable"
COND_DRIFTED = "Drifted"
COND_INSTANCE_TERMINATING = "InstanceTerminating"
COND_CONSISTENT_STATE_FOUND = "ConsistentStateFound"
COND_DISRUPTION_REASON = "DisruptionReason"
COND_READY = "Ready"
COND_NODE_REGISTRATION_HEALTHY = "NodeRegistrationHealthy"


@dataclass
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


class ConditionSet:
    """Minimal condition bookkeeping over a NodeClaim/NodePool status."""

    def __init__(self, conditions: List[Condition]):
        self._conditions = conditions

    def get(self, cond_type: str) -> Optional[Condition]:
        for c in self._conditions:
            if c.type == cond_type:
                return c
        return None

    def is_true(self, cond_type: str) -> bool:
        c = self.get(cond_type)
        return c is not None and c.status == "True"

    def set(self, cond_type: str, status: str, reason: str = "", message: str = "", now: float = 0.0) -> bool:
        """Upsert; returns True when anything changed. The transition time
        only moves when the status flips."""
        c = self.get(cond_type)
        if c is None:
            self._conditions.append(
                Condition(cond_type, status, reason, message, last_transition_time=now)
            )
            return True
        changed = (c.status, c.reason, c.message) != (status, reason, message)
        if c.status != status:
            c.last_transition_time = now
        c.status = status
        c.reason = reason
        c.message = message
        return changed

    def clear(self, cond_type: str) -> None:
        self._conditions[:] = [c for c in self._conditions if c.type != cond_type]


@dataclass
class NodeClassRef:
    group: str = labels_mod.GROUP
    kind: str = "KWOKNodeClass"
    name: str = "default"


@dataclass
class NodeClaimSpec:
    """Immutable after creation (reference: nodeclaim.go:141-149)."""

    requirements: List[NodeSelectorRequirement] = field(default_factory=list)
    resources_requests: res.ResourceList = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    node_class_ref: NodeClassRef = field(default_factory=NodeClassRef)
    expire_after: Optional[float] = None  # seconds; None == Never
    termination_grace_period: Optional[float] = None

    def scheduling_requirements(self) -> Requirements:
        return Requirements(*(r.to_requirement() for r in self.requirements))


@dataclass
class NodeClaimStatus:
    provider_id: str = ""
    image_id: str = ""
    node_name: str = ""
    capacity: res.ResourceList = field(default_factory=dict)
    allocatable: res.ResourceList = field(default_factory=dict)
    conditions: List[Condition] = field(default_factory=list)
    last_pod_event_time: float = 0.0


@dataclass
class NodeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def conds(self) -> ConditionSet:
        return ConditionSet(self.status.conditions)

    @property
    def nodepool_name(self) -> str:
        return self.metadata.labels.get(labels_mod.NODEPOOL_LABEL_KEY, "")

    @property
    def capacity_type(self) -> str:
        return self.metadata.labels.get(labels_mod.CAPACITY_TYPE_LABEL_KEY, "")


# --- NodePool --------------------------------------------------------------

# Disruption reasons (reference: nodepool.go disruption reasons)
REASON_UNDERUTILIZED = "Underutilized"
REASON_EMPTY = "Empty"
REASON_DRIFTED = "Drifted"

CONSOLIDATION_WHEN_EMPTY = "WhenEmpty"
CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED = "WhenEmptyOrUnderutilized"


@dataclass
class Budget:
    """Disruption budget window (reference: nodepool.go:86-121, 296-367).

    ``nodes`` is an absolute count ("5") or percentage ("20%"). ``schedule``
    is a cron expression gating when the budget is active, for ``duration``
    seconds. ``reasons`` empty means all reasons.
    """

    nodes: str = "10%"
    reasons: Tuple[str, ...] = ()
    schedule: Optional[str] = None
    duration: Optional[float] = None


@dataclass
class Disruption:
    consolidate_after: Optional[float] = 0.0  # seconds; None == Never
    consolidation_policy: str = CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED
    budgets: List[Budget] = field(default_factory=lambda: [Budget(nodes="10%")])


@dataclass
class NodeClaimTemplate:
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplate = field(default_factory=NodeClaimTemplate)
    disruption: Disruption = field(default_factory=Disruption)
    limits: res.ResourceList = field(default_factory=dict)
    weight: int = 1  # 1-100, higher wins (reference: nodepool.go:130-138)


@dataclass
class NodePoolStatus:
    resources: res.ResourceList = field(default_factory=dict)
    node_class_observed_generation: int = 0
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class NodePool:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)
    status: NodePoolStatus = field(default_factory=NodePoolStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def conds(self) -> ConditionSet:
        return ConditionSet(self.status.conditions)


@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_spec: PodSpec = field(default_factory=PodSpec)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: Optional[str] = None
    volume_name: str = ""
    requests: res.ResourceList = field(default_factory=dict)


@dataclass
class PersistentVolume:
    """A bound volume; ``zones`` mirrors the PV's node-affinity zone terms and
    ``driver`` the CSI driver that provisioned it (reference:
    volumetopology.go getPersistentVolumeTopology / volumeusage.go)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    zones: Tuple[str, ...] = ()
    driver: str = ""
    storage_class_name: Optional[str] = None


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    zones: Tuple[str, ...] = ()  # allowed topologies
    provisioner: str = ""  # CSI driver name


@dataclass
class VolumeAttachment:
    """A CSI volume attached to a node (storagev1.VolumeAttachment). Its
    existence blocks node termination until the attacher detaches it
    (reference: termination/controller.go:193-243)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    node_name: str = ""
    pv_name: str = ""  # spec.source.persistentVolumeName

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class CSINode:
    """Per-node CSI driver attach limits (reference: volumeusage.go reads
    CSINode.spec.drivers[].allocatable.count). ``metadata.name`` is the node
    name."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    driver_limits: Dict[str, int] = field(default_factory=dict)  # driver -> max volumes


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: LabelSelector = field(default_factory=LabelSelector)
    min_available: Optional[str] = None  # int or percent string
    max_unavailable: Optional[str] = None
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0
    disruptions_allowed: int = 0
