# Copied from karpenter_tpu/scheduling/topology.py.
"""Topology tracking: spread, pod affinity, pod anti-affinity.

Host-side mirror of the reference's topology engine
(topology.go, topologygroup.go, topologynodefilter.go,
topologydomaingroup.go). This is the semantic oracle; the tensorized forms
live in solver/encode.py (TopoSpec distillation: hostname per-entity caps,
domain-quota descriptors, shared-constraint carries) and ops/packing.py
(the kernel's quota water-fill and count carries), and
tests/test_solver_parity.py asserts agreement between the two.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..api import labels as labels_mod
from ..api import taints as taints_mod
from ..api.objects import LabelSelector, Node, Pod, Taint
from ..api.requirements import Operator, Requirement, Requirements

MAX_SKEW_UNBOUNDED = 2**31 - 1

HONOR = "Honor"
IGNORE = "Ignore"


class TopologyType(str, Enum):
    SPREAD = "topology spread"
    POD_AFFINITY = "pod affinity"
    POD_ANTI_AFFINITY = "pod anti-affinity"


class TopologyDomainGroup:
    """Universe of domains for one topology key, annotated with the taint
    sets of the NodePools providing each domain
    (reference: topologydomaingroup.go:25-72)."""

    def __init__(self):
        self._domains: Dict[str, List[Tuple[Taint, ...]]] = {}

    def insert(self, domain: str, taints: Sequence[Taint] = ()) -> None:
        taints = tuple(taints)
        if domain not in self._domains or not taints:
            self._domains[domain] = [taints]
            return
        if not self._domains[domain][0]:
            return  # already tracking the always-eligible empty taint set
        self._domains[domain].append(taints)

    def for_each_domain(self, pod, taint_policy: str, fn: Callable[[str], None]) -> None:
        for domain, taint_groups in self._domains.items():
            if taint_policy == IGNORE:
                fn(domain)
                continue
            for taints in taint_groups:
                if taints_mod.tolerates_pod(taints, pod) is None:
                    fn(domain)
                    break

    def domains(self) -> Set[str]:
        return set(self._domains)


class TopologyNodeFilter:
    """Node-inclusion policy for spread counting
    (reference: topologynodefilter.go:26-97). Zero-value filter matches all
    nodes — affinity/anti-affinity topologies use that.
    """

    def __init__(
        self,
        requirements: Optional[List[Requirements]] = None,
        taint_policy: str = IGNORE,
        affinity_policy: str = HONOR,
        tolerations: Sequence = (),
    ):
        self.requirements = requirements or []
        self.taint_policy = taint_policy
        self.affinity_policy = affinity_policy
        self.tolerations = list(tolerations)

    @classmethod
    def for_pod(cls, pod: Pod, taint_policy: str, affinity_policy: str) -> "TopologyNodeFilter":
        selector_reqs = Requirements.from_labels(pod.spec.node_selector or {})
        affinity = pod.spec.node_affinity
        if affinity is None or not affinity.required:
            return cls(
                [selector_reqs], taint_policy, affinity_policy, pod.spec.tolerations
            )
        # node-affinity OR-terms: any term + the node selector may match
        reqs_list = []
        for term in affinity.required:
            reqs = Requirements(*selector_reqs.values())
            reqs.add(*(t.to_requirement() for t in term))
            reqs_list.append(reqs)
        return cls(reqs_list, taint_policy, affinity_policy, pod.spec.tolerations)

    def matches(self, taints: Sequence[Taint], node_requirements: Requirements) -> bool:
        matches_affinity = True
        if self.affinity_policy == HONOR:
            matches_affinity = self._matches_requirements(node_requirements)
        matches_taints = True
        if self.taint_policy == HONOR:
            matches_taints = taints_mod.tolerates(taints, self.tolerations) is None
        return matches_affinity and matches_taints

    def _matches_requirements(self, node_requirements: Requirements) -> bool:
        if not self.requirements or self.affinity_policy == IGNORE:
            return True
        return any(
            node_requirements.compatible(req) is None for req in self.requirements
        )

    def key(self) -> tuple:
        return (
            tuple(
                tuple(sorted((r.key, repr(r)) for r in reqs)) for reqs in self.requirements
            ),
            self.taint_policy,
            self.affinity_policy,
            tuple(sorted((t.key, t.operator, t.value, t.effect) for t in self.tolerations)),
        )


class TopologyGroup:
    """Per-constraint domain->count tracker
    (reference: topologygroup.go:56-149)."""

    def __init__(
        self,
        topology_type: TopologyType,
        key: str,
        pod: Pod,
        namespaces: Set[str],
        selector: Optional[LabelSelector],
        max_skew: int,
        min_domains: Optional[int],
        taint_policy: Optional[str],
        affinity_policy: Optional[str],
        domain_group: TopologyDomainGroup,
    ):
        self.type = topology_type
        self.key = key
        self.namespaces = set(namespaces)
        self.selector = selector
        self.max_skew = max_skew
        self.min_domains = min_domains
        if topology_type is TopologyType.SPREAD:
            self.node_filter = TopologyNodeFilter.for_pod(
                pod, taint_policy or IGNORE, affinity_policy or HONOR
            )
        else:
            self.node_filter = TopologyNodeFilter()  # matches everything
        self.domains: Dict[str, int] = {}
        self.empty_domains: Set[str] = set()
        self.owners: Set[str] = set()
        domain_group.for_each_domain(pod, self.node_filter.taint_policy, self._init_domain)

    def _init_domain(self, domain: str) -> None:
        if domain not in self.domains:
            self.domains[domain] = 0
            self.empty_domains.add(domain)

    # -- identity (dedup across owner pods; topologygroup.go:181-198) -----

    def hash_key(self) -> tuple:
        return (
            self.key,
            self.type,
            frozenset(self.namespaces),
            self.selector.key() if self.selector is not None else None,
            self.max_skew,
            self.node_filter.key(),
        )

    # -- ownership --------------------------------------------------------

    def add_owner(self, uid: str) -> None:
        self.owners.add(uid)

    def remove_owner(self, uid: str) -> None:
        self.owners.discard(uid)

    def is_owned_by(self, uid: str) -> bool:
        return uid in self.owners

    # -- counting ---------------------------------------------------------

    def record(self, *domains: str) -> None:
        for domain in domains:
            self.domains[domain] = self.domains.get(domain, 0) + 1
            self.empty_domains.discard(domain)

    def register(self, *domains: str) -> None:
        for domain in domains:
            if domain not in self.domains:
                self.domains[domain] = 0
                self.empty_domains.add(domain)

    def unregister(self, *domains: str) -> None:
        for domain in domains:
            self.domains.pop(domain, None)
            self.empty_domains.discard(domain)

    def selects(self, pod: Pod) -> bool:
        if pod.metadata.namespace not in self.namespaces:
            return False
        if self.selector is None:
            return False  # nil selector selects nothing (labels.Nothing())
        return self.selector.matches(pod.metadata.labels)

    def counts(self, pod: Pod, taints: Sequence[Taint], requirements: Requirements) -> bool:
        """Would the pod count against this topology if scheduled onto a node
        with the given requirements (topologygroup.go:147-149)."""
        return self.selects(pod) and self.node_filter.matches(taints, requirements)

    # -- domain selection (topologygroup.go:205-366) ----------------------

    def get(self, pod: Pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        if self.type is TopologyType.SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type is TopologyType.POD_AFFINITY:
            return self._next_domain_affinity(pod, pod_domains, node_domains)
        return self._next_domain_anti_affinity(pod_domains, node_domains)

    def _candidate_domains(self, node_domains: Requirement) -> Iterable[str]:
        if node_domains.operator() is Operator.IN:
            return [d for d in sorted(node_domains.values) if d in self.domains]
        return [d for d in sorted(self.domains) if node_domains.has(d)]

    def _next_domain_spread(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        global_min = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)
        min_domain, min_count = None, math.inf
        for domain in self._candidate_domains(node_domains):
            count = self.domains[domain]
            if self_selecting:
                count += 1
            if count - global_min <= self.max_skew and count < min_count:
                min_domain, min_count = domain, count
        if min_domain is None:
            return Requirement(pod_domains.key, Operator.DOES_NOT_EXIST)
        return Requirement(pod_domains.key, Operator.IN, [min_domain])

    def _domain_min_count(self, pod_domains: Requirement) -> int:
        # hostname topologies can always mint a fresh node: min is 0
        # (topologygroup.go:253-274)
        if self.key == labels_mod.HOSTNAME:
            return 0
        counts = [c for d, c in self.domains.items() if pod_domains.has(d)]
        minimum = min(counts) if counts else MAX_SKEW_UNBOUNDED
        if self.min_domains is not None and len(counts) < self.min_domains:
            minimum = 0
        return minimum

    def _next_domain_affinity(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        options = [
            d
            for d in self._candidate_domains(node_domains)
            if pod_domains.has(d) and self.domains[d] > 0
        ]
        if options:
            return Requirement(pod_domains.key, Operator.IN, options)
        # bootstrap: a self-selecting pod with no compatible placed pods may
        # pick a viable domain (topologygroup.go:277-324)
        if self.selects(pod) and (
            len(self.domains) == len(self.empty_domains)
            or not self._any_compatible_pod_domain(pod_domains)
        ):
            intersected = pod_domains.intersection(node_domains)
            for domain in sorted(self.domains):
                if intersected.has(domain):
                    return Requirement(pod_domains.key, Operator.IN, [domain])
            for domain in sorted(self.domains):
                if pod_domains.has(domain):
                    return Requirement(pod_domains.key, Operator.IN, [domain])
        return Requirement(pod_domains.key, Operator.DOES_NOT_EXIST)

    def _any_compatible_pod_domain(self, pod_domains: Requirement) -> bool:
        return any(
            pod_domains.has(d) and count > 0 for d, count in self.domains.items()
        )

    def _next_domain_anti_affinity(
        self, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        options = [
            d
            for d in sorted(self.empty_domains)
            if node_domains.has(d) and pod_domains.has(d)
        ]
        if options:
            return Requirement(pod_domains.key, Operator.IN, options)
        return Requirement(pod_domains.key, Operator.DOES_NOT_EXIST)


def ignored_for_topology(pod: Pod) -> bool:
    """Terminal / terminating pods don't count (reference: topology.go:522+)."""
    return pod.status.phase in ("Succeeded", "Failed") or pod.metadata.deletion_timestamp is not None


class Topology:
    """Cross-group topology tracker for one scheduling run
    (reference: topology.go:45-98)."""

    def __init__(
        self,
        client,
        state_nodes: Sequence,
        node_pools: Sequence,
        instance_types: Dict[str, List],
        pods: Sequence[Pod],
        cluster=None,
    ):
        self._client = client
        self._state_nodes = list(state_nodes)
        self._cluster = cluster
        self.domain_groups = build_domain_groups(node_pools, instance_types)
        self.topology_groups: Dict[tuple, TopologyGroup] = {}
        self.inverse_topology_groups: Dict[tuple, TopologyGroup] = {}
        # pod uid -> owned forward groups; avoids scanning every group per
        # placement attempt (add_requirements is the oracle's hot loop)
        self._owner_index: Dict[str, List[TopologyGroup]] = {}
        self.excluded_pods: Set[str] = {p.uid for p in pods}
        self._update_inverse_affinities()
        for pod in pods:
            self.update(pod)

    # -- group construction ----------------------------------------------

    def update(self, pod: Pod) -> None:
        """(Re)register the pod as owner of its topologies; called again
        after preference relaxation (topology.go:157-189)."""
        spec = pod.spec
        has_constraints = bool(
            spec.topology_spread_constraints
            or spec.pod_affinity
            or spec.pod_anti_affinity
            or spec.preferred_pod_affinity
            or spec.preferred_pod_anti_affinity
        )
        if has_constraints or pod.uid in self._owner_index:
            for tg in self._owner_index.pop(pod.uid, ()):
                tg.remove_owner(pod.uid)
        if not has_constraints:
            # constraint-free pods own no topology groups; this walk runs
            # once per pod per Topology build (50k times on the headline
            # batch), so the common case takes one attribute sweep
            return

        if spec.pod_anti_affinity:
            self._update_inverse_anti_affinity(pod, None)

        groups = self._new_for_topologies(pod) + self._new_for_affinities(pod)
        owned: List[TopologyGroup] = []
        for tg in groups:
            key = tg.hash_key()
            existing = self.topology_groups.get(key)
            if existing is None:
                self._count_domains(tg)
                self.topology_groups[key] = tg
            else:
                tg = existing
            tg.add_owner(pod.uid)
            if tg not in owned:  # duplicate constraints share one group
                owned.append(tg)
        if owned:
            self._owner_index[pod.uid] = owned

    def _new_for_topologies(self, pod: Pod) -> List[TopologyGroup]:
        return [
            TopologyGroup(
                TopologyType.SPREAD,
                tsc.topology_key,
                pod,
                {pod.metadata.namespace},
                tsc.label_selector,
                tsc.max_skew,
                tsc.min_domains,
                tsc.node_taints_policy,
                tsc.node_affinity_policy,
                self.domain_groups.get(tsc.topology_key, TopologyDomainGroup()),
            )
            for tsc in pod.spec.topology_spread_constraints
        ]

    def _new_for_affinities(self, pod: Pod) -> List[TopologyGroup]:
        groups = []
        terms = [(TopologyType.POD_AFFINITY, t) for t in pod.spec.pod_affinity]
        terms += [(TopologyType.POD_AFFINITY, wt.term) for wt in pod.spec.preferred_pod_affinity]
        terms += [(TopologyType.POD_ANTI_AFFINITY, t) for t in pod.spec.pod_anti_affinity]
        terms += [
            (TopologyType.POD_ANTI_AFFINITY, wt.term)
            for wt in pod.spec.preferred_pod_anti_affinity
        ]
        for ttype, term in terms:
            groups.append(
                TopologyGroup(
                    ttype,
                    term.topology_key,
                    pod,
                    self._namespaces(pod, term),
                    term.label_selector,
                    MAX_SKEW_UNBOUNDED,
                    None,
                    None,
                    None,
                    self.domain_groups.get(term.topology_key, TopologyDomainGroup()),
                )
            )
        return groups

    def _namespaces(self, pod: Pod, term) -> Set[str]:
        if term.namespaces:
            return set(term.namespaces)
        return {pod.metadata.namespace}

    # -- inverse anti-affinity (topology.go:273-313) ----------------------

    def _update_inverse_affinities(self) -> None:
        for p in self._client.list(Pod):
            if not p.spec.pod_anti_affinity or not p.bound():
                continue
            if p.uid in self.excluded_pods or ignored_for_topology(p):
                continue
            node = self._client.try_get(Node, p.spec.node_name)
            self._update_inverse_anti_affinity(
                p, node.metadata.labels if node is not None else {}
            )

    def _update_inverse_anti_affinity(self, pod: Pod, domains: Optional[Dict[str, str]]) -> None:
        for term in pod.spec.pod_anti_affinity:
            tg = TopologyGroup(
                TopologyType.POD_ANTI_AFFINITY,
                term.topology_key,
                pod,
                self._namespaces(pod, term),
                term.label_selector,
                MAX_SKEW_UNBOUNDED,
                None,
                None,
                None,
                self.domain_groups.get(term.topology_key, TopologyDomainGroup()),
            )
            key = tg.hash_key()
            existing = self.inverse_topology_groups.get(key)
            if existing is None:
                self.inverse_topology_groups[key] = tg
            else:
                tg = existing
            if domains is not None and tg.key in domains:
                tg.record(domains[tg.key])
            tg.add_owner(pod.uid)

    # -- counting from live cluster (topology.go:318-420) -----------------

    def _count_domains(self, tg: TopologyGroup) -> None:
        # register domains present on real nodes even without selected pods
        for sn in self._state_nodes:
            node = getattr(sn, "node", sn)
            if node is None or not isinstance(node, Node):
                continue
            if not tg.node_filter.matches(
                node.taints, Requirements.from_labels(node.metadata.labels)
            ):
                continue
            domain = node.metadata.labels.get(tg.key)
            if domain is not None:
                tg.register(domain)

        node_cache: Dict[str, Optional[Node]] = {}
        for pod in self._client.list(Pod):
            if pod.metadata.namespace not in tg.namespaces:
                continue
            if tg.selector is None or not tg.selector.matches(pod.metadata.labels):
                continue
            if ignored_for_topology(pod) or pod.uid in self.excluded_pods:
                continue
            if not pod.spec.node_name:
                continue
            if pod.spec.node_name not in node_cache:
                node_cache[pod.spec.node_name] = self._client.try_get(Node, pod.spec.node_name)
            node = node_cache[pod.spec.node_name]
            if node is None:
                continue  # leaked binding to a deleted node
            domain = node.metadata.labels.get(tg.key)
            if domain is None and tg.key == labels_mod.HOSTNAME:
                domain = node.metadata.name
            if domain is None:
                continue
            if not tg.node_filter.matches(
                node.taints, Requirements.from_labels(node.metadata.labels)
            ):
                continue
            tg.record(domain)

    # -- scheduling API (topology.go:192-270) -----------------------------

    def record(self, pod: Pod, taints: Sequence[Taint], requirements: Requirements) -> None:
        for tg in self.topology_groups.values():
            if tg.counts(pod, taints, requirements):
                domains = requirements.get(tg.key)
                if tg.type is TopologyType.POD_ANTI_AFFINITY:
                    tg.record(*domains.values_list())
                elif not domains.complement and len(domains.values) == 1:
                    tg.record(next(iter(domains.values)))
        for tg in self.inverse_topology_groups.values():
            if tg.is_owned_by(pod.uid):
                tg.record(*requirements.get(tg.key).values_list())

    def add_requirements(
        self,
        pod: Pod,
        taints: Sequence[Taint],
        pod_requirements: Requirements,
        node_requirements: Requirements,
    ) -> Tuple[Optional[Requirements], Optional[str]]:
        """Tighten node requirements with topology-selected domains; returns
        (requirements, None) or (None, error) (topology.go:220-242)."""
        requirements = Requirements(*node_requirements.values())
        for tg in self._matching_topologies(pod, taints, node_requirements):
            pod_domains = (
                pod_requirements.get(tg.key)
                if pod_requirements.has(tg.key)
                else Requirement(tg.key, Operator.EXISTS)
            )
            node_domains = (
                node_requirements.get(tg.key)
                if node_requirements.has(tg.key)
                else Requirement(tg.key, Operator.EXISTS)
            )
            domains = tg.get(pod, pod_domains, node_domains)
            if not domains.complement and not domains.values:
                return None, (
                    f"unsatisfiable topology constraint for {tg.type.value},"
                    f" key={tg.key}"
                )
            requirements.add(domains)
        return requirements, None

    def owned_topologies(self, uid: str):
        """Forward TopologyGroups owned by a pod, via the owner index."""
        return self._owner_index.get(uid, ())

    def register(self, topology_key: str, domain: str) -> None:
        for tg in list(self.topology_groups.values()) + list(
            self.inverse_topology_groups.values()
        ):
            if tg.key == topology_key:
                tg.register(domain)

    def unregister(self, topology_key: str, domain: str) -> None:
        for tg in list(self.topology_groups.values()) + list(
            self.inverse_topology_groups.values()
        ):
            if tg.key == topology_key:
                tg.unregister(domain)

    def _matching_topologies(
        self, pod: Pod, taints: Sequence[Taint], requirements: Requirements
    ) -> List[TopologyGroup]:
        """Forward groups apply only to their OWNER pods; inverse
        anti-affinity groups apply to any pod they select that would count on
        this node (reference: topology.go:513-528)."""
        out = list(self._owner_index.get(pod.uid, ()))
        for tg in self.inverse_topology_groups.values():
            if tg.counts(pod, taints, requirements):
                out.append(tg)
        return out


def build_domain_groups(
    node_pools: Sequence, instance_types: Dict[str, List]
) -> Dict[str, TopologyDomainGroup]:
    """Universe of domains per topology key from nodepool x instance-type
    requirements (reference: topology.go:100-138)."""
    groups: Dict[str, TopologyDomainGroup] = {}
    pool_index = {np.name: np for np in node_pools}
    for np_name, its in instance_types.items():
        np = pool_index[np_name]
        template = np.spec.template
        taints = template.spec.taints
        for it in its:
            requirements = Requirements(
                *(r.to_requirement() for r in template.spec.requirements)
            )
            requirements.add(*Requirements.from_labels(template.labels).values())
            requirements.add(*it.requirements.values())
            for req in requirements:
                groups.setdefault(req.key, TopologyDomainGroup())
                for domain in req.values_list():
                    groups[req.key].insert(domain, taints)
        requirements = Requirements(
            *(r.to_requirement() for r in template.spec.requirements)
        )
        requirements.add(*Requirements.from_labels(template.labels).values())
        for req in requirements:
            if req.operator() is Operator.IN:
                groups.setdefault(req.key, TopologyDomainGroup())
                for domain in req.values_list():
                    groups[req.key].insert(domain, taints)
    return groups
