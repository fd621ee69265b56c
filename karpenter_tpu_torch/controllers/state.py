# Copied from karpenter_tpu/controllers/state.py.
"""Cluster state cache: StateNode and Cluster.

Mirror of the reference's pkg/controllers/state (cluster.go, statenode.go):
an in-memory, watch-fed view of nodes, nodeclaims, pod bindings and
daemonsets that the scheduler snapshots. StateNode is the merged
Node+NodeClaim view; reads fall back to the NodeClaim before the Node is
registered.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..api import labels as labels_mod
from ..api import resources as res
from ..api import taints as taints_mod
from ..api.objects import (
    COND_CONSOLIDATABLE,
    COND_INITIALIZED,
    COND_REGISTERED,
    CSINode,
    DaemonSet,
    Node,
    NodeClaim,
    Pod,
    PodDisruptionBudget,
    Taint,
)
from ..kube import Client, Event
from ..kube.store import ADDED, DELETED, MODIFIED
from ..metrics import Gauge
from ..scheduling.hostports import HostPortUsage
from ..scheduling.volumeusage import VolumeResolver, VolumeUsage

# cluster-state sync gauges (reference: state/metrics.go)
CLUSTER_STATE_NODE_COUNT = Gauge(
    "cluster_state_node_count", "Current count of nodes in cluster state"
)
CLUSTER_STATE_SYNCED = Gauge(
    "cluster_state_synced",
    "1 if cluster state matches the API server's view, else 0",
)
CLUSTER_STATE_UNSYNCED_SECONDS = Gauge(
    "cluster_state_unsynced_time_seconds",
    "How long cluster state has been out of sync",
)


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


class Cluster:
    """Watch-fed cluster state (reference: cluster.go:48-746)."""

    CONSOLIDATION_RECHECK = 300.0  # forced re-check window (cluster.go:457-483)

    def __init__(self, client: Client):
        self._client = client
        self._lock = threading.RLock()
        self._nodes: Dict[str, StateNode] = {}  # provider_id -> StateNode
        self._node_name_to_provider_id: Dict[str, str] = {}
        self._claim_name_to_provider_id: Dict[str, str] = {}
        self._bindings: Dict[str, str] = {}  # pod uid -> node name
        self._daemonsets: Dict[str, DaemonSet] = {}
        self._anti_affinity_pods: Set[str] = set()
        self._unconsolidated_at: float = 0.0
        self._consolidated_at: float = 0.0
        self._volume_resolver = VolumeResolver(client)
        # pod scheduling-latency bookkeeping (cluster.go:61-64, 352-435)
        self._pod_acks: Dict[str, float] = {}  # uid -> first provisioner sight
        self._pods_schedulable_times: Dict[str, float] = {}  # uid -> success time
        self._pods_scheduling_attempted: Dict[str, float] = {}  # uid -> first attempt
        # analysis: sanctioned[GRD1303] informer callback registered before the initial list; the store notifies outside its own lock (kube/store.py) so _on_event taking Cluster._lock cannot deadlock — pinned by tests/test_races.py
        client.watch(self._on_event)
        self._synced_once = False
        self._unsynced_since: Optional[float] = None
        # informer semantics are LIST + watch, not watch alone: a cluster
        # built over a pre-populated store (restart onto the file-backed
        # backend, a late-started replica) replays current objects as
        # synthetic ADDED events — without this, recovery sees an empty
        # world and the controllers dismantle a healthy cluster
        self._initial_list()

    def _initial_list(self) -> None:
        from ..api.objects import (
            CSINode, DaemonSet, PersistentVolume, PersistentVolumeClaim,
            StorageClass,
        )

        # claims before nodes (node events attach to tracked claims),
        # nodes before pods (bindings attach to tracked nodes)
        for kind in (
            NodeClaim, Node, Pod, DaemonSet, CSINode,
            PersistentVolumeClaim, PersistentVolume, StorageClass,
        ):
            try:
                objs = self._client.list(kind)
            # analysis: ignore[RTY701] capability probe — an unlistable kind means "empty", not a retriable fault
            except Exception:
                continue
            for obj in objs:
                self._on_event(Event(ADDED, kind.__name__, obj))

    # -- sync gate (cluster.go:101-180; gauges state/metrics.go) ----------

    def synced(self) -> bool:
        """All NodeClaims with provider ids and all Nodes are tracked."""
        ok = self._synced_inner()
        now = self._client.clock.now()
        with self._lock:
            if ok:
                self._unsynced_since = None
            elif self._unsynced_since is None:
                self._unsynced_since = now
            CLUSTER_STATE_SYNCED.set(1.0 if ok else 0.0)
            CLUSTER_STATE_UNSYNCED_SECONDS.set(
                0.0 if ok else now - self._unsynced_since
            )
            CLUSTER_STATE_NODE_COUNT.set(float(len(self._nodes)))
        return ok

    def _synced_inner(self) -> bool:
        with self._lock:
            for claim in self._client.list(NodeClaim):
                pid = claim.status.provider_id
                if pid and pid not in self._nodes:
                    return False
            for node in self._client.list(Node):
                if node.provider_id and node.provider_id not in self._nodes:
                    return False
                if not node.provider_id and node.name not in self._node_name_to_provider_id:
                    return False
        return True

    # -- snapshot ---------------------------------------------------------

    def nodes(self) -> List[StateNode]:
        """Deep-copied snapshot (cluster.go:218-225)."""
        with self._lock:
            return [sn.deep_copy() for sn in self._nodes.values()]

    def node_for_name(self, name: str) -> Optional[StateNode]:
        with self._lock:
            pid = self._node_name_to_provider_id.get(name)
            return self._nodes.get(pid) if pid else None

    def node_for_provider_id(self, provider_id: str) -> Optional[StateNode]:
        with self._lock:
            return self._nodes.get(provider_id)

    def daemonsets(self) -> List[DaemonSet]:
        with self._lock:
            return list(self._daemonsets.values())

    def for_pods_with_anti_affinity(self, fn: Callable[[Pod, Node], bool]) -> None:
        with self._lock:
            uids = list(self._anti_affinity_pods)
        for uid in uids:
            try:
                pod = self._client.get_by_uid(uid)
            except KeyError:
                continue
            node = self._client.try_get(Node, pod.spec.node_name)
            if node is not None:
                if not fn(pod, node):
                    return

    # -- consolidation memoization (cluster.go:457-483) -------------------

    def mark_unconsolidated(self, now: float) -> None:
        with self._lock:
            self._unconsolidated_at = now

    def mark_consolidated(self, now: float) -> float:
        with self._lock:
            self._consolidated_at = now
            return now

    def consolidation_state(self, now: float) -> float:
        """A timestamp token; changes when cluster changed or every 5 min."""
        with self._lock:
            if self._unconsolidated_at > self._consolidated_at:
                return self._unconsolidated_at
            if now - self._consolidated_at > self.CONSOLIDATION_RECHECK:
                return now
            return self._consolidated_at

    # -- nomination (cluster.go:229-247) ----------------------------------

    def nominate_node(self, node_name: str, now: float) -> None:
        sn = self.node_for_name(node_name)
        if sn is not None:
            sn.nominate(now)

    # -- pod scheduling-latency bookkeeping (cluster.go:352-435) ----------

    def ack_pods(self, *uids: str) -> None:
        """Stamp the first time the provisioner saw each pod (AckPods)."""
        now = self._client.clock.now()
        with self._lock:
            for uid in uids:
                self._pod_acks.setdefault(uid, now)

    def pod_ack_time(self, uid: str) -> Optional[float]:
        with self._lock:
            return self._pod_acks.get(uid)

    def mark_pod_scheduling_decisions(
        self, errors: Dict[str, object], *scheduled_uids: str
    ) -> None:
        """Record the outcome of one scheduling round
        (MarkPodSchedulingDecisions, cluster.go:382-407)."""
        now = self._client.clock.now()
        with self._lock:
            for uid in scheduled_uids:
                self._pods_scheduling_attempted.setdefault(uid, now)
                self._pods_schedulable_times.setdefault(uid, now)
            for uid in errors:
                self._pods_scheduling_attempted.setdefault(uid, now)
                self._pods_schedulable_times.pop(uid, None)

    def pod_scheduling_decision_time(self, uid: str) -> Optional[float]:
        with self._lock:
            return self._pods_scheduling_attempted.get(uid)

    def pod_scheduling_success_time(self, uid: str) -> Optional[float]:
        with self._lock:
            return self._pods_schedulable_times.get(uid)

    def mark_for_deletion(self, *provider_ids: str) -> None:
        with self._lock:
            for pid in provider_ids:
                if pid in self._nodes:
                    self._nodes[pid].mark_for_deletion = True

    def unmark_for_deletion(self, *provider_ids: str) -> None:
        with self._lock:
            for pid in provider_ids:
                if pid in self._nodes:
                    self._nodes[pid].mark_for_deletion = False

    # -- checkpoint (sim/twin.py) -----------------------------------------

    def export_state(self) -> dict:
        """The informer layer's in-memory knowledge, for the twin
        checkpoint. The store alone cannot reproduce it: watch-fed
        tracking legitimately LAGS the store (an in-place provider-id
        mutation whose status update hit a conflict is visible to a
        LIST but was never an event), iteration order of ``_nodes`` is
        event-arrival order (and feeds encode row order, hence replay
        determinism), and ``mark_for_deletion``/``nominated_until`` are
        in-memory flags with no store representation at all."""
        with self._lock:
            return {
                "tracked": [
                    (
                        pid,
                        sn.node is not None,
                        sn.node_claim is not None,
                        sn.mark_for_deletion,
                        sn.nominated_until,
                    )
                    for pid, sn in self._nodes.items()
                ],
                "claim_map": dict(self._claim_name_to_provider_id),
                "node_map": dict(self._node_name_to_provider_id),
                "pod_acks": dict(self._pod_acks),
                "pods_schedulable": dict(self._pods_schedulable_times),
                "pods_attempted": dict(self._pods_scheduling_attempted),
                "consolidated_at": self._consolidated_at,
                "unconsolidated_at": self._unconsolidated_at,
            }

    def restore_state(self, state: dict) -> None:
        """Reconcile a freshly LIST-built Cluster down to the
        checkpointed knowledge: drop trackings the interrupted run had
        not ingested yet (they will re-arrive as the same watch events),
        restore the in-memory flags, and restore iteration order."""
        with self._lock:
            known = {t[0] for t in state["tracked"]}
            for pid in [p for p in self._nodes if p not in known]:
                del self._nodes[pid]
            rebuilt: Dict[str, StateNode] = {}
            for pid, has_node, has_claim, mark, nominated in state["tracked"]:
                sn = self._nodes.get(pid)
                if sn is None:
                    continue
                if not has_claim:
                    sn.node_claim = None
                if not has_node:
                    sn.node = None
                sn.mark_for_deletion = mark
                sn.nominated_until = nominated
                rebuilt[pid] = sn
            self._nodes = rebuilt
            self._claim_name_to_provider_id = dict(state["claim_map"])
            self._node_name_to_provider_id = dict(state["node_map"])
            self._pod_acks = dict(state["pod_acks"])
            self._pods_schedulable_times = dict(state["pods_schedulable"])
            self._pods_scheduling_attempted = dict(state["pods_attempted"])
            self._consolidated_at = state["consolidated_at"]
            self._unconsolidated_at = state["unconsolidated_at"]

    # -- watch handlers (informer controllers; state/informer/*.go) -------

    def _on_event(self, event: Event) -> None:
        handler = {
            "Node": self._handle_node,
            "NodeClaim": self._handle_node_claim,
            "Pod": self._handle_pod,
            "DaemonSet": self._handle_daemonset,
            "CSINode": self._handle_csinode,
            "PersistentVolumeClaim": self._handle_volume_object,
            "PersistentVolume": self._handle_volume_object,
            "StorageClass": self._handle_volume_object,
        }.get(event.kind)
        if handler is not None:
            # safe under the lock: these are Cluster's OWN informer methods
            # (the dict above binds self._handle_*), not external callbacks.
            # They only read back into the Client — the documented
            # cluster -> store order — and never re-enter watcher code.
            with self._lock:
                handler(event)  # analysis: ignore[LCK202] dispatch table of our own bound methods, not external callbacks
            self.mark_unconsolidated(self._client.clock.now())

    def _handle_node(self, event: Event) -> None:
        node: Node = event.object
        if event.type == DELETED:
            pid = self._node_name_to_provider_id.pop(node.name, None)
            if pid is not None:
                sn = self._nodes.get(pid)
                if sn is not None:
                    if sn.node_claim is not None:
                        sn.node = None
                    else:
                        del self._nodes[pid]
            return
        pid = node.provider_id or f"node://{node.name}"
        old_pid = self._node_name_to_provider_id.get(node.name)
        if old_pid is not None and old_pid != pid:
            # providerID appeared/changed after registration: drop the entry
            # tracked under the old id (reference: cluster.go:606-612)
            self._nodes.pop(old_pid, None)
        self._node_name_to_provider_id[node.name] = pid
        sn = self._nodes.get(pid)
        if sn is None:
            # adopt a NodeClaim tracked under the same provider id
            sn = StateNode(node=node)
            self._nodes[pid] = sn
        else:
            sn.node = node
        self._rebuild_node_pods(sn, node.name)

    def _handle_node_claim(self, event: Event) -> None:
        claim: NodeClaim = event.object
        if event.type == DELETED:
            pid = self._claim_name_to_provider_id.pop(claim.name, None)
            if pid is not None:
                sn = self._nodes.get(pid)
                if sn is not None:
                    if sn.node is not None:
                        sn.node_claim = None
                    else:
                        del self._nodes[pid]
            return
        pid = claim.status.provider_id
        if not pid:
            return  # not launched yet; tracked once provider id exists
        self._claim_name_to_provider_id[claim.name] = pid
        sn = self._nodes.get(pid)
        if sn is None:
            self._nodes[pid] = StateNode(node_claim=claim)
        else:
            sn.node_claim = claim

    def _handle_pod(self, event: Event) -> None:
        pod: Pod = event.object
        if event.type == DELETED:
            self._anti_affinity_pods.discard(pod.uid)
            self._pod_acks.pop(pod.uid, None)
            self._pods_schedulable_times.pop(pod.uid, None)
            self._pods_scheduling_attempted.pop(pod.uid, None)
            node_name = self._bindings.pop(pod.uid, None)
            if node_name is not None:
                sn = self._state_node_by_name(node_name)
                if sn is not None:
                    sn.remove_pod(pod.uid)
            return
        if pod.spec.pod_anti_affinity:
            self._anti_affinity_pods.add(pod.uid)
        old_node = self._bindings.get(pod.uid)
        if pod.status.phase in ("Succeeded", "Failed"):
            # terminal pods release node usage (reference: cluster.go:337-349)
            if old_node is not None:
                sn = self._state_node_by_name(old_node)
                if sn is not None:
                    sn.remove_pod(pod.uid)
                self._bindings.pop(pod.uid, None)
            return
        if pod.spec.node_name:
            if old_node and old_node != pod.spec.node_name:
                sn = self._state_node_by_name(old_node)
                if sn is not None:
                    sn.remove_pod(pod.uid)
            self._bindings[pod.uid] = pod.spec.node_name
            sn = self._state_node_by_name(pod.spec.node_name)
            if sn is not None:
                resolved, _ = self._volume_resolver.resolve(pod)
                sn.update_pod(
                    pod, is_daemon=self._is_daemon_pod(pod), resolved_volumes=resolved
                )

    def _handle_volume_object(self, event: Event) -> None:
        """PVC/PV/StorageClass changes shift volume identities (an unbound
        claim binding to a PV renames ns/claim -> pv-name), so re-resolve
        every bound volume-bearing pod; VolumeUsage.add retracts the stale
        resolution."""
        for uid, node_name in list(self._bindings.items()):
            try:
                pod = self._client.get_by_uid(uid)
            except KeyError:
                continue
            if not pod.spec.volumes:
                continue
            sn = self._state_node_by_name(node_name)
            if sn is None:
                continue
            resolved, err = self._volume_resolver.resolve(pod)
            if err is None:
                sn.volume_usage.add(pod, resolved)

    def _handle_csinode(self, event: Event) -> None:
        """CSINode attach limits feed StateNode.volume_limits
        (volumeusage.go reads CSINode.spec.drivers[].allocatable.count)."""
        csinode = event.object
        sn = self._state_node_by_name(csinode.metadata.name)
        if sn is None:
            return
        if event.type == DELETED:
            sn.volume_limits = {}
        else:
            sn.volume_limits = dict(csinode.driver_limits)

    def _handle_daemonset(self, event: Event) -> None:
        ds: DaemonSet = event.object
        if event.type == DELETED:
            self._daemonsets.pop(ds.metadata.uid, None)
        else:
            self._daemonsets[ds.metadata.uid] = ds

    def _is_daemon_pod(self, pod: Pod) -> bool:
        return any(uid in self._daemonsets for uid in pod.metadata.owner_uids)

    def _state_node_by_name(self, name: str) -> Optional[StateNode]:
        pid = self._node_name_to_provider_id.get(name)
        return self._nodes.get(pid) if pid else None

    def _rebuild_node_pods(self, sn: StateNode, node_name: str) -> None:
        sn.pods = []
        sn.pod_requests = {}
        sn.daemonset_requests = {}
        sn.hostport_usage = HostPortUsage()
        sn.volume_usage = VolumeUsage()
        csinode = self._client.try_get(CSINode, node_name)
        if csinode is not None:
            sn.volume_limits = dict(csinode.driver_limits)
        # indexed read: only this node's pods, not every pod in the store
        # (the informer-rebuild wall at 100k-node scale was store-scan
        # dominated — kube/store.py field index over spec.nodeName)
        for pod in self._client.list(
            Pod, field_selector={"spec.nodeName": node_name}
        ):
            if pod.status.phase not in (
                "Succeeded",
                "Failed",
            ):
                self._bindings[pod.uid] = node_name
                resolved, _ = self._volume_resolver.resolve(pod)
                sn.update_pod(
                    pod, is_daemon=self._is_daemon_pod(pod), resolved_volumes=resolved
                )
