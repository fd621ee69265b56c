# Copied from karpenter_tpu/controllers/state.py, StateNode class only.
"""Cluster state cache: the StateNode view only.

StateNode is the merged Node+NodeClaim view (reference: statenode.go);
reads fall back to the NodeClaim before the Node is registered. Existing
nodes enter a solve as StateNodes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..api import labels as labels_mod
from ..api import resources as res
from ..api import taints as taints_mod
from ..api.objects import (
    COND_INITIALIZED,
    COND_REGISTERED,
    Node,
    NodeClaim,
    Pod,
    Taint,
)
from ..scheduling.hostports import HostPortUsage
from ..scheduling.volumeusage import VolumeUsage


class StateNode:
    """Merged Node + NodeClaim view (reference: statenode.go:115-455)."""

    def __init__(self, node: Optional[Node] = None, node_claim: Optional[NodeClaim] = None):
        self.node = node
        self.node_claim = node_claim
        self.pods: List[Pod] = []
        self.hostport_usage = HostPortUsage()
        self.volume_usage = VolumeUsage()
        self.volume_limits: Dict[str, int] = {}  # csi driver -> max volumes
        self.pod_requests: Dict[str, res.ResourceList] = {}
        self.daemonset_requests: Dict[str, res.ResourceList] = {}
        self.mark_for_deletion = False
        self.nominated_until: float = 0.0

    # -- identity ---------------------------------------------------------

    @property
    def name(self) -> str:
        if self.node is not None:
            return self.node.name
        return self.node_claim.name if self.node_claim is not None else ""

    def hostname(self) -> str:
        return self.labels().get(labels_mod.HOSTNAME, self.name)

    @property
    def provider_id(self) -> str:
        if self.node is not None and self.node.provider_id:
            return self.node.provider_id
        if self.node_claim is not None:
            return self.node_claim.status.provider_id
        return ""

    # -- status -----------------------------------------------------------

    def registered(self) -> bool:
        return self.node_claim is not None and self.node_claim.conds().is_true(COND_REGISTERED)

    def initialized(self) -> bool:
        if self.node_claim is not None:
            return self.node_claim.conds().is_true(COND_INITIALIZED)
        return self.node is not None  # non-managed nodes count as initialized

    def managed(self) -> bool:
        return self.node_claim is not None

    def deleting(self) -> bool:
        for obj in (self.node, self.node_claim):
            if obj is not None and obj.metadata.deletion_timestamp is not None:
                return True
        return False

    # -- merged reads (pre-Registered reads come from the NodeClaim,
    # statenode.go:264-309) ----------------------------------------------

    def labels(self) -> Dict[str, str]:
        if self.registered() or self.node_claim is None:
            if self.node is not None:
                return self.node.metadata.labels
        return self.node_claim.metadata.labels if self.node_claim is not None else {}

    def annotations(self) -> Dict[str, str]:
        src = self.node if (self.registered() or self.node_claim is None) else self.node_claim
        return src.metadata.annotations if src is not None else {}

    def taints(self) -> List[Taint]:
        """Effective taints: ephemeral/startup taints are ignored until the
        node is initialized (statenode.go:289-307)."""
        if self.initialized() and self.node is not None:
            return list(self.node.taints)
        source = self.node if (self.registered() and self.node is not None) else self.node_claim
        if source is None:
            return []
        raw = source.taints if isinstance(source, Node) else source.spec.taints
        startup = set()
        if self.node_claim is not None:
            startup = {
                (t.key, t.effect) for t in self.node_claim.spec.startup_taints
            }
        return [
            t
            for t in raw
            if not taints_mod.is_ephemeral(t) and (t.key, t.effect) not in startup
        ]

    def capacity(self) -> res.ResourceList:
        if self.node is not None and self.node.status.capacity:
            return self.node.status.capacity
        if self.node_claim is not None:
            return self.node_claim.status.capacity
        return {}

    def allocatable(self) -> res.ResourceList:
        if self.node is not None and self.node.status.allocatable:
            return self.node.status.allocatable
        if self.node_claim is not None:
            return self.node_claim.status.allocatable
        return {}

    def pod_request_total(self) -> res.ResourceList:
        return res.merge(*self.pod_requests.values()) if self.pod_requests else {}

    def daemonset_request_total(self) -> res.ResourceList:
        return (
            res.merge(*self.daemonset_requests.values()) if self.daemonset_requests else {}
        )

    def available(self) -> res.ResourceList:
        """allocatable - sum(pod requests) (statenode.go:329-366)."""
        return res.subtract(self.allocatable(), self.pod_request_total())

    def nominated(self, now: float) -> bool:
        return self.nominated_until > now

    def nominate(self, now: float, window: float = 20.0) -> None:
        self.nominated_until = now + window

    # -- disruptability (statenode.go:183-232) ----------------------------

    def disruptable_error(self, pdb_limits=None, now: float = 0.0) -> Optional[str]:
        if self.node is None or self.node_claim is None:
            return "node is not managed or not yet registered"
        if self.mark_for_deletion or self.deleting():
            return "node is deleting or marked for deletion"
        if self.nominated(now):
            return "node is nominated for a pending pod"
        for pod in self.pods:
            if (
                pod.metadata.annotations.get(labels_mod.DO_NOT_DISRUPT_ANNOTATION_KEY)
                == "true"
            ):
                return f"pod {pod.name} has do-not-disrupt"
        if pdb_limits is not None:
            err = pdb_limits.can_evict_pods(self.reschedulable_pods())
            if err:
                return err
        return None

    def reschedulable_pods(self) -> List[Pod]:
        from ..utils.pod import is_reschedulable

        return [p for p in self.pods if is_reschedulable(p)]

    # -- pod bookkeeping --------------------------------------------------

    def update_pod(self, pod: Pod, is_daemon: bool, resolved_volumes=None) -> None:
        if pod.uid not in self.pod_requests:
            self.pods.append(pod)
        else:
            self.pods = [p if p.uid != pod.uid else pod for p in self.pods]
        self.pod_requests[pod.uid] = dict(pod.spec.requests)
        if is_daemon:
            self.daemonset_requests[pod.uid] = dict(pod.spec.requests)
        self.hostport_usage.add(pod)
        if resolved_volumes:
            self.volume_usage.add(pod, resolved_volumes)

    def remove_pod(self, uid: str) -> None:
        self.pods = [p for p in self.pods if p.uid != uid]
        self.pod_requests.pop(uid, None)
        self.daemonset_requests.pop(uid, None)
        self.hostport_usage.delete_pod(uid)
        self.volume_usage.delete_pod(uid)

    def deep_copy(self) -> "StateNode":
        out = StateNode(self.node, self.node_claim)
        out.pods = list(self.pods)
        out.pod_requests = {k: dict(v) for k, v in self.pod_requests.items()}
        out.daemonset_requests = {k: dict(v) for k, v in self.daemonset_requests.items()}
        out.hostport_usage = self.hostport_usage.copy()
        out.volume_usage = self.volume_usage.copy()
        out.volume_limits = dict(self.volume_limits)
        out.mark_for_deletion = self.mark_for_deletion
        out.nominated_until = self.nominated_until
        return out
