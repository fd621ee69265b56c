# Copied from karpenter_tpu/controllers/termination.py.
"""Node termination: finalizer-driven taint -> drain -> delete instance.

Mirror of the reference's pkg/controllers/node/termination
(controller.go:88-259, terminator/terminator.go:55-177,
terminator/eviction.go:117-226): evictions proceed in priority groups
(non-critical before critical, daemons last), PDB-blocked evictions retry,
and the termination grace period deadline force-deletes stragglers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..api import labels as labels_mod
from ..api import taints as taints_mod
from ..api.objects import (
    Node,
    NodeClaim,
    PersistentVolumeClaim,
    Pod,
    Taint,
    VolumeAttachment,
)
from ..events import Event, Recorder
from ..kube import Client
from ..kube.store import ConflictError, NotFoundError
from ..metrics import Histogram
from ..utils import pod as pod_utils
from ..utils.pdb import Limits

TERMINATION_DURATION = Histogram("node_termination_duration_seconds", "")

CRITICAL_PRIORITY = 2_000_000_000


class EvictionQueue:
    """Rate-limited eviction attempts with PDB 429 handling
    (eviction.go:117-226)."""

    def __init__(self, client: Client, recorder: Recorder):
        self.client = client
        self.recorder = recorder

    def evict(self, pods: Sequence[Pod]) -> List[Pod]:
        """Try to evict each pod; returns the pods that remain blocked."""
        limits = Limits.from_client(self.client)
        blocked = []
        for pod in pods:
            err = limits.can_evict_pods([pod])
            if err is not None:
                self.recorder.publish(
                    Event(pod.uid, "Warning", "FailedEviction", err)
                )
                blocked.append(pod)
                continue
            pod.metadata.deletion_timestamp = self.client.clock.now()
            try:
                self.client.delete(pod)
            except KeyError:
                pass
            limits.record_eviction(pod)
        return blocked


class TerminationController:
    def __init__(self, client: Client, cloud_provider, recorder: Optional[Recorder] = None):
        self.client = client
        self.cloud_provider = cloud_provider
        self.clock = client.clock
        self.recorder = recorder or Recorder(self.clock)
        self.eviction_queue = EvictionQueue(client, self.recorder)

    def reconcile_all(self) -> None:
        for node in self.client.list(Node):
            if node.metadata.deletion_timestamp is not None:
                try:
                    self.reconcile(node)
                except (ConflictError, NotFoundError):
                    # transient store conflict (or a concurrent deleter
                    # won) mid-drain: termination is re-entrant per step,
                    # the next pass resumes this node
                    continue

    def reconcile(self, node: Node) -> None:
        """Drive one deleting node toward removal; re-entrant per step."""
        if labels_mod.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return
        # also delete the owning NodeClaim (controller.go:181-191)
        claim = self._claim_for(node)
        if claim is not None and claim.metadata.deletion_timestamp is None:
            self.client.delete(claim)

        self.taint(node)
        remaining = self.drain(node)
        if remaining and not self._past_grace(node):
            return  # requeue until drained or deadline
        if remaining:
            # grace deadline passed: force-delete stragglers
            for pod in remaining:
                try:
                    self.client.delete(pod)
                except KeyError:
                    pass
        # wait for drained pods' volumes to detach before terminating the
        # instance so stateful pods re-attach cleanly elsewhere; the
        # terminationGracePeriod deadline overrides the wait
        # (termination/controller.go:143-153, 193-243)
        if not self._volumes_detached(node) and not self._past_grace(node):
            return  # requeue until the attacher catches up
        # instance termination via the claim finalizer path, or directly
        if claim is not None:
            return  # lifecycle controller finishes via claim finalizer
        self.client.remove_finalizer(node, labels_mod.TERMINATION_FINALIZER)

    # -- volume detach wait (controller.go:193-243) -----------------------

    def _volumes_detached(self, node: Node) -> bool:
        """VolumeAttachments of DRAIN-ABLE pods must be gone; attachments
        still backing non-drainable pods (e.g. do-not-disrupt stragglers
        about to be force-deleted) never block."""
        attachments = [
            va
            for va in self.client.list(VolumeAttachment)
            if va.node_name == node.name
        ]
        if not attachments:
            return True
        blocked_pvs = set()
        for p in self.client.list(Pod):
            if p.spec.node_name != node.name or not pod_utils.is_active(p):
                continue
            if pod_utils.is_reschedulable(p):
                continue  # drain-able pods' volumes must detach
            for ref in p.spec.volumes:
                pvc = self.client.try_get(
                    PersistentVolumeClaim,
                    ref.claim_name,
                    namespace=p.metadata.namespace,
                )
                if pvc is not None and pvc.volume_name:
                    blocked_pvs.add(pvc.volume_name)
        return all(va.pv_name in blocked_pvs for va in attachments)

    # -- taint ("cordon", terminator.go:55-92) ----------------------------

    def taint(self, node: Node) -> None:
        if not any(t.key == labels_mod.DISRUPTED_TAINT_KEY for t in node.taints):
            node.taints.append(
                Taint(key=labels_mod.DISRUPTED_TAINT_KEY, effect=taints_mod.NO_SCHEDULE)
            )
            self.client.update(node)

    # -- drain (terminator.go:94-138) -------------------------------------

    def drain(self, node: Node) -> List[Pod]:
        """Evict pods in groups: non-critical non-daemon, critical non-daemon,
        non-critical daemon, critical daemon. Returns pods still present."""
        pods = [
            p
            # indexed read (kube/store.py): cost ∝ this node's pods
            for p in self.client.list(
                Pod, field_selector={"spec.nodeName": node.name}
            )
            if pod_utils.is_active(p)
        ]
        groups = [[], [], [], []]
        for p in pods:
            critical = (p.spec.priority or 0) >= CRITICAL_PRIORITY or (
                p.spec.priority_class_name in ("system-cluster-critical", "system-node-critical")
            )
            daemon = bool(p.metadata.owner_uids) and self._owned_by_daemonset(p)
            groups[(2 if daemon else 0) + (1 if critical else 0)].append(p)
        # only evict the first non-empty group per pass (ordered drain)
        for group in groups:
            evictable = [p for p in group if pod_utils.is_reschedulable(p)]
            if evictable:
                self.eviction_queue.evict(evictable)
                break
        return [
            p
            for p in self.client.list(
                Pod, field_selector={"spec.nodeName": node.name}
            )
            if pod_utils.is_active(p) and pod_utils.is_reschedulable(p)
        ]

    def _owned_by_daemonset(self, pod: Pod) -> bool:
        from ..api.objects import DaemonSet

        ds_uids = {d.metadata.uid for d in self.client.list(DaemonSet)}
        return any(uid in ds_uids for uid in pod.metadata.owner_uids)

    def _past_grace(self, node: Node) -> bool:
        claim = self._claim_for(node)
        if claim is None or claim.spec.termination_grace_period is None:
            return False
        deleted_at = node.metadata.deletion_timestamp or self.clock.now()
        return self.clock.now() >= deleted_at + claim.spec.termination_grace_period

    def _claim_for(self, node: Node) -> Optional[NodeClaim]:
        for claim in self.client.list(NodeClaim):
            if claim.status.provider_id and claim.status.provider_id == node.provider_id:
                return claim
        return None
