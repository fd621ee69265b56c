# Copied from karpenter_tpu/controllers/metrics_controllers.py.
"""Per-object metrics controllers.

Plays the role of pkg/controllers/metrics/{node,nodepool,pod} plus the
cluster-state gauges (state/metrics.go): level-triggered publishers that scan
the store/cluster each pass and republish every series, so deleted objects
drop out of the exposition automatically.

Metric names/labels mirror the reference:
- node gauges          metrics/node/controller.go:55-125
- nodepool limit/usage metrics/nodepool/controller.go:54-80
- pod state + latency  metrics/pod/controller.go:64-163
- cluster state        state/metrics.go
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api import labels as labels_mod
from ..api import resources as res
from ..api.objects import Node, NodePool, Pod
from ..utils import pod as pod_utils
from ..kube import Client
from ..metrics import Gauge, Histogram
from .state import Cluster

# -- node (metrics/node/controller.go) --------------------------------------

NODE_ALLOCATABLE = Gauge("node_allocatable", "Node allocatable by resource type")
NODE_TOTAL_POD_REQUESTS = Gauge("node_total_pod_requests", "Pod resource requests on the node")
NODE_TOTAL_POD_LIMITS = Gauge("node_total_pod_limits", "Pod resource limits on the node")
NODE_TOTAL_DAEMON_REQUESTS = Gauge("node_total_daemon_requests", "Daemon requests on the node")
NODE_TOTAL_DAEMON_LIMITS = Gauge("node_total_daemon_limits", "Daemon limits on the node")
NODE_LIFETIME = Gauge("node_current_lifetime_seconds", "Node age in seconds")
NODE_UTILIZATION = Gauge("node_utilization_percent", "requests / allocatable * 100")

# -- nodepool (metrics/nodepool/controller.go) ------------------------------

NODEPOOL_LIMIT = Gauge("nodepool_limit", "NodePool spec.limits by resource type")
NODEPOOL_USAGE = Gauge("nodepool_usage", "NodePool status.resources by resource type")

# -- pod (metrics/pod/controller.go) ----------------------------------------

POD_STATE = Gauge("pod_state", "Pod state broken out by phase")
POD_STARTUP_DURATION = Histogram(
    "pod_startup_duration_seconds", "creation -> Running")
POD_UNSTARTED_TIME = Gauge(
    "pod_unstarted_time_seconds", "seconds since creation while not Running")
POD_BOUND_DURATION = Histogram(
    "pod_bound_duration_seconds", "creation -> bound to a node")
POD_UNBOUND_TIME = Gauge(
    "pod_unbound_time_seconds", "seconds since creation while unbound")
POD_PROV_BOUND_DURATION = Histogram(
    "pod_provisioning_bound_duration_seconds", "provisioner ACK -> bound")
POD_PROV_UNBOUND_TIME = Gauge(
    "pod_provisioning_unbound_time_seconds", "seconds since ACK while unbound")
POD_PROV_STARTUP_DURATION = Histogram(
    "pod_provisioning_startup_duration_seconds", "scheduling decision -> Running")
POD_PROV_UNSTARTED_TIME = Gauge(
    "pod_provisioning_unstarted_time_seconds", "seconds since ACK while not Running")
POD_SCHEDULING_UNDECIDED_TIME = Gauge(
    "pod_provisioning_scheduling_undecided_time_seconds",
    "seconds since ACK with no scheduling decision yet")

# cluster-state gauges live with the Cluster itself (state.py), which also
# tracks unsynced time; re-exported here for the reconcile below


def _emit_resource_gauge(gauge: Gauge, rl, base_labels: Dict[str, str]) -> None:
    for name, millis in rl.items():
        gauge.set(millis / res.MILLI, {**base_labels, "resource_type": name})


class NodeMetricsController:
    """metrics/node/controller.go:55-125 — per-node resource gauges."""

    def __init__(self, client: Client, cluster: Cluster):
        self.client = client
        self.cluster = cluster

    def reconcile_all(self) -> None:
        for g in (NODE_ALLOCATABLE, NODE_TOTAL_POD_REQUESTS, NODE_TOTAL_POD_LIMITS,
                  NODE_TOTAL_DAEMON_REQUESTS, NODE_TOTAL_DAEMON_LIMITS,
                  NODE_LIFETIME, NODE_UTILIZATION):
            g.clear()
        now = self.client.clock.now()
        pods_by_node: Dict[str, list] = {}
        for pod in self.client.list(Pod):
            if pod.spec.node_name and pod.status.phase not in ("Succeeded", "Failed"):
                pods_by_node.setdefault(pod.spec.node_name, []).append(pod)
        state_nodes = self.cluster.nodes()
        daemon_uids = {uid for sn in state_nodes for uid in sn.daemonset_requests}
        daemonset_uids = {ds.metadata.uid for ds in self.cluster.daemonsets()}
        for node in self.client.list(Node):
            base = {
                "node_name": node.name,
                "nodepool": node.metadata.labels.get(labels_mod.NODEPOOL_LABEL_KEY, ""),
            }
            allocatable = node.status.allocatable or node.status.capacity
            _emit_resource_gauge(NODE_ALLOCATABLE, allocatable, base)
            pod_requests: res.ResourceList = {}
            pod_limits: res.ResourceList = {}
            daemon_requests: res.ResourceList = {}
            daemon_limits: res.ResourceList = {}
            for pod in pods_by_node.get(node.name, ()):
                is_daemon = pod.uid in daemon_uids or pod_utils.is_owned_by_daemonset(
                    pod, daemonset_uids
                )
                if is_daemon:
                    daemon_requests = res.merge(daemon_requests, pod.spec.requests)
                    daemon_limits = res.merge(daemon_limits, pod.spec.limits)
                else:
                    pod_requests = res.merge(pod_requests, pod.spec.requests)
                    pod_limits = res.merge(pod_limits, pod.spec.limits)
            _emit_resource_gauge(NODE_TOTAL_POD_REQUESTS, pod_requests, base)
            _emit_resource_gauge(NODE_TOTAL_POD_LIMITS, pod_limits, base)
            _emit_resource_gauge(NODE_TOTAL_DAEMON_REQUESTS, daemon_requests, base)
            _emit_resource_gauge(NODE_TOTAL_DAEMON_LIMITS, daemon_limits, base)
            NODE_LIFETIME.set(
                max(now - node.metadata.creation_timestamp, 0.0), base)
            total_requests = res.merge(pod_requests, daemon_requests)
            for name, alloc in allocatable.items():
                if alloc <= 0:
                    continue
                used = total_requests.get(name, 0)
                NODE_UTILIZATION.set(
                    100.0 * used / alloc, {**base, "resource_type": name})
        # cluster.synced() refreshes the cluster_state_* gauges (state.py)
        self.cluster.synced()


class NodePoolMetricsController:
    """metrics/nodepool/controller.go:54-80 — limit/usage gauges."""

    def __init__(self, client: Client):
        self.client = client

    def reconcile_all(self) -> None:
        NODEPOOL_LIMIT.clear()
        NODEPOOL_USAGE.clear()
        for pool in self.client.list(NodePool):
            base = {"nodepool": pool.name}
            if pool.spec.limits:
                _emit_resource_gauge(NODEPOOL_LIMIT, pool.spec.limits, base)
            if pool.status.resources:
                _emit_resource_gauge(NODEPOOL_USAGE, pool.status.resources, base)


class PodMetricsController:
    """metrics/pod/controller.go:64-163 — pod phase + scheduling-latency
    series, fed by the Cluster's ACK/decision bookkeeping."""

    def __init__(self, client: Client, cluster: Cluster):
        self.client = client
        self.cluster = cluster
        self._bound_seen: Dict[str, float] = {}  # uid -> bound stamp
        self._running_seen: Dict[str, float] = {}  # uid -> running stamp

    def reconcile_all(self) -> None:
        for g in (POD_STATE, POD_UNSTARTED_TIME, POD_UNBOUND_TIME,
                  POD_PROV_UNBOUND_TIME, POD_PROV_UNSTARTED_TIME,
                  POD_SCHEDULING_UNDECIDED_TIME):
            g.clear()
        now = self.client.clock.now()
        live = set()
        for pod in self.client.list(Pod):
            live.add(pod.uid)
            base = {"name": pod.name, "namespace": pod.metadata.namespace}
            POD_STATE.set(1.0, {**base, "phase": pod.status.phase,
                                "node": pod.spec.node_name or ""})
            created = pod.metadata.creation_timestamp
            ack = self.cluster.pod_ack_time(pod.uid)
            decided = self.cluster.pod_scheduling_decision_time(pod.uid)
            schedulable = self.cluster.pod_scheduling_success_time(pod.uid)

            if pod.bound():
                if pod.uid not in self._bound_seen:
                    self._bound_seen[pod.uid] = now
                    POD_BOUND_DURATION.observe(max(now - created, 0.0))
                    if ack is not None:
                        POD_PROV_BOUND_DURATION.observe(max(now - ack, 0.0))
            else:
                POD_UNBOUND_TIME.set(max(now - created, 0.0), base)
                if ack is not None:
                    POD_PROV_UNBOUND_TIME.set(max(now - ack, 0.0), base)

            if pod.status.phase == "Running":
                if pod.uid not in self._running_seen:
                    self._running_seen[pod.uid] = now
                    POD_STARTUP_DURATION.observe(max(now - created, 0.0))
                    if schedulable is not None:
                        POD_PROV_STARTUP_DURATION.observe(
                            max(now - schedulable, 0.0))
            elif pod.status.phase == "Pending":
                POD_UNSTARTED_TIME.set(max(now - created, 0.0), base)
                if ack is not None:
                    POD_PROV_UNSTARTED_TIME.set(max(now - ack, 0.0), base)
                if ack is not None and decided is None:
                    POD_SCHEDULING_UNDECIDED_TIME.set(max(now - ack, 0.0), base)
        for uid in list(self._bound_seen):
            if uid not in live:
                del self._bound_seen[uid]
        for uid in list(self._running_seen):
            if uid not in live:
                del self._running_seen[uid]


__all__ = [
    "NodeMetricsController",
    "NodePoolMetricsController",
    "PodMetricsController",
]
