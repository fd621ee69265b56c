# Copied from karpenter_tpu/sim/binder.py.
"""kube-scheduler stand-in: binds pending pods onto ready nodes.

The reference never binds pods itself — kube-scheduler does. In-process, the
test/simulation harness needs a binder (the role the reference's
ExpectProvisioned test helper plays, expectations.go:295-352): pending pods
bind onto nodes with capacity whose labels/taints admit them.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from ..api import labels as labels_mod
from ..api import resources as res
from ..api import taints as taints_mod
from ..api.objects import CSINode, Node, Pod
from ..api.requirements import Requirements, pod_requirements
from ..kube import Client, NotFoundError
from ..scheduling.volumetopology import VolumeTopology
from ..scheduling.volumeusage import VolumeUsage
from ..utils import pod as pod_utils


class Binder:
    def __init__(self, client: Client):
        self.client = client
        self.volume_topology = VolumeTopology(client)

    def bind_all(self) -> List[Pod]:
        """One binding pass; returns newly bound pods."""
        all_pods = self.client.list(Pod)
        pending = [p for p in all_pods if pod_utils.is_provisionable(p)]
        if not pending:
            # day-scale twin ticks hit this constantly: pay nothing when
            # there is nothing to bind (the used/placement maps below are
            # O(nodes + pods) but not free at 2k nodes / 20k pods)
            return []
        nodes = [n for n in self.client.list(Node) if n.metadata.deletion_timestamp is None]
        bound = []
        nodes_by_name = {n.name: n for n in nodes}
        # one pass over pods (not nodes x pods): group active bound pods
        # by node, then fold each node's requests
        by_node: Dict[str, List[Pod]] = {}
        for p in all_pods:
            if p.spec.node_name in nodes_by_name and pod_utils.is_active(p):
                by_node.setdefault(p.spec.node_name, []).append(p)
        used = {n.name: {} for n in nodes}
        used.update(
            {
                name: res.merge(*(p.spec.requests for p in plist))
                for name, plist in by_node.items()
            }
        )
        volume_usage = self._build_volume_usage(nodes, all_pods)
        placements = [
            (p, nodes_by_name[name])
            for name, plist in by_node.items()
            for p in plist
        ]
        # only placements with anti-affinity terms can repel new pods; keep
        # the inverse-anti scan off the O(pods x nodes) hot path
        anti_placements = [
            (p, n) for p, n in placements if p.spec.pod_anti_affinity
        ]
        for pod in pending:
            node = self._find_node(
                pod, nodes, used, volume_usage, placements, anti_placements
            )
            if node is not None:
                pod.spec.node_name = node.name
                try:
                    self.client.update(pod)
                except NotFoundError:
                    # evicted concurrently; not bound — and none of the
                    # pass-local state below may see the phantom pod
                    pod.spec.node_name = None
                    continue
                used[node.name] = res.merge(used[node.name], pod.spec.requests)
                if pod.spec.volumes:
                    resolved, _ = self.volume_topology.resolver.resolve(pod)
                    volume_usage.setdefault(node.name, VolumeUsage()).add(pod, resolved)
                placements.append((pod, node))
                if pod.spec.pod_anti_affinity:
                    anti_placements.append((pod, node))
                bound.append(pod)
        return bound

    def _build_volume_usage(self, nodes, all_pods) -> Dict[str, VolumeUsage]:
        usage: Dict[str, VolumeUsage] = {}
        for p in all_pods:
            if p.spec.volumes and p.spec.node_name and pod_utils.is_active(p):
                resolved, _ = self.volume_topology.resolver.resolve(p)
                usage.setdefault(p.spec.node_name, VolumeUsage()).add(p, resolved)
        return usage

    def _find_node(
        self,
        pod: Pod,
        nodes: List[Node],
        used,
        volume_usage,
        placements=(),
        anti_placements=(),
    ) -> Optional[Node]:
        # the kube-scheduler's volume plugins see zonal PV constraints and
        # CSI attach limits; mirror both so sim bindings match provisioning
        if pod.spec.volumes:
            pod = copy.deepcopy(pod)
            self.volume_topology.inject(pod)
        topo_ctx = self._topology_ctx(pod, nodes, placements)
        if topo_ctx is None:
            return None  # unsatisfiable required affinity: stays pending
        for node in nodes:
            if node.unschedulable or not node.status.ready:
                continue
            if taints_mod.tolerates_pod(node.taints, pod) is not None:
                continue
            node_reqs = Requirements.from_labels(node.metadata.labels)
            if node_reqs.compatible(pod_requirements(pod)) is not None:
                continue
            requests = res.merge(used.get(node.name, {}), pod.spec.requests)
            if not res.fits(requests, node.status.allocatable):
                continue
            if pod.spec.volumes and not self._volumes_fit(pod, node, volume_usage):
                continue
            if not self._topology_ok(pod, node, topo_ctx, anti_placements):
                continue
            return node
        return None

    @staticmethod
    def _term_ns(term, owner_ns):
        return set(term.namespaces) if term.namespaces else {owner_ns}

    def _topology_ctx(self, pod: Pod, nodes, placements):
        """Node-independent part of the topology filters, computed once per
        pod: spread counts per constraint and admissible domains per
        required-affinity term. Returns None when a required affinity can
        never be satisfied (non-self-selecting with no matching pod — the
        solver refuses the same shape, topology.go:277-324)."""
        ns = pod.metadata.namespace
        spread = []
        if pod.spec.topology_spread_constraints:
            # nodeAffinityPolicy=Honor (the kube-scheduler default, and the
            # solver's own domain universe): only domains of nodes the pod
            # itself can land on participate in the skew calculation
            reqs = pod_requirements(pod)
            eligible = [
                n2
                for n2 in nodes
                if Requirements.from_labels(n2.metadata.labels).compatible(reqs)
                is None
            ]
        for tsc in pod.spec.topology_spread_constraints:
            if tsc.when_unsatisfiable != "DoNotSchedule":
                continue
            key = tsc.topology_key
            counts = {}
            for n2 in eligible:
                d2 = n2.metadata.labels.get(key)
                if d2 is not None:
                    counts.setdefault(d2, 0)
            for p2, n2 in placements:
                d2 = n2.metadata.labels.get(key)
                if (
                    d2 in counts
                    and p2.metadata.namespace == ns
                    and tsc.label_selector is not None
                    and tsc.label_selector.matches(p2.metadata.labels)
                ):
                    counts[d2] += 1
            min_count = min(counts.values()) if counts else 0
            spread.append((key, tsc.max_skew, counts, min_count))
        aff_domains = []  # (key, allowed domain set or None for any)
        for term in pod.spec.pod_affinity:
            key = term.topology_key
            matching = {
                n2.metadata.labels.get(key)
                for p2, n2 in placements
                if p2.metadata.namespace in self._term_ns(term, ns)
                and term.label_selector is not None
                and term.label_selector.matches(p2.metadata.labels)
                and n2.metadata.labels.get(key) is not None
            }
            if matching:
                aff_domains.append((key, matching))
            else:
                # bootstrap only for a SELF-selecting pod (kube-scheduler
                # and topology.go:277-324's nextDomainAffinity agree): a
                # required affinity on pods that don't exist and never
                # will (the pod doesn't select itself) cannot bind
                if not (
                    ns in self._term_ns(term, ns)
                    and term.label_selector is not None
                    and term.label_selector.matches(pod.metadata.labels)
                ):
                    return None
                aff_domains.append((key, None))
        anti_blocked = []  # (key, domains holding a matching pod)
        for term in pod.spec.pod_anti_affinity:
            key = term.topology_key
            blocked = {
                n2.metadata.labels.get(key)
                for p2, n2 in placements
                if p2.metadata.namespace in self._term_ns(term, ns)
                and term.label_selector is not None
                and term.label_selector.matches(p2.metadata.labels)
                and n2.metadata.labels.get(key) is not None
            }
            anti_blocked.append((key, blocked))
        return ns, spread, aff_domains, anti_blocked

    def _topology_ok(self, pod: Pod, node: Node, ctx, anti_placements) -> bool:
        """The kube-scheduler's PodTopologySpread + InterPodAffinity
        filters for one candidate node: DoNotSchedule spread keeps skew
        <= maxSkew, required pod affinity needs a matching pod in the
        node's domain (self-selecting bootstrap aside), required
        anti-affinity is enforced in BOTH directions (a bound pod's anti
        terms also repel the new pod)."""
        ns, spread, aff_domains, anti_blocked = ctx
        labels = node.metadata.labels
        for key, max_skew, counts, min_count in spread:
            dom = labels.get(key)
            if dom is None or dom not in counts:
                return False
            if counts[dom] + 1 - min_count > max_skew:
                return False
        for key, allowed in aff_domains:
            dom = labels.get(key)
            if dom is None:
                return False
            if allowed is not None and dom not in allowed:
                return False
        for key, blocked in anti_blocked:
            dom = labels.get(key)
            if dom is not None and dom in blocked:
                return False
        for p2, n2 in anti_placements:
            for term in p2.spec.pod_anti_affinity:
                key = term.topology_key
                d2 = n2.metadata.labels.get(key)
                if (
                    d2 is not None
                    and d2 == labels.get(key)
                    and ns in self._term_ns(term, p2.metadata.namespace)
                    and term.label_selector is not None
                    and term.label_selector.matches(pod.metadata.labels)
                ):
                    return False
        return True

    def _volumes_fit(self, pod: Pod, node: Node, volume_usage) -> bool:
        csinode = self.client.try_get(CSINode, node.name)
        if csinode is None or not csinode.driver_limits:
            return True
        resolved, err = self.volume_topology.resolver.resolve(pod)
        if err is not None:
            return False
        usage = volume_usage.setdefault(node.name, VolumeUsage())
        return usage.validate(resolved, csinode.driver_limits) is None
