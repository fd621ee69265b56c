# Copied from karpenter_tpu/scheduling/scheduler.py.
"""The scheduling simulation driver.

Host-side mirror of the reference's Scheduler.Solve
(scheduler.go:80-134, 270-425): FFD queue -> place each pod on existing
nodes, then open in-flight claims (fewest pods first), then a new claim from
the highest-weight feasible NodePool; on failure relax preferences and
requeue. This implementation is the exact-semantics oracle and fallback; the
TPU solver (karpenter_tpu.solver) accelerates the same decision problem and
is parity-tested against this.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import labels as labels_mod
from ..api import resources as res
from ..api import taints as taints_mod
from ..api.objects import Node, NodePool, Pod
from ..api.requirements import (
    Operator,
    Requirement,
    Requirements,
    has_preferred_node_affinity,
    pod_requirements,
    strict_pod_requirements,
)
from ..cloudprovider import types as cp
from .inflight import (
    ExistingNode,
    InFlightNodeClaim,
    PodData,
    RESERVED_OFFERING_MODE_FALLBACK,
    ReservedOfferingError,
    filter_instance_types,
)
from .preferences import Preferences
from .queue import Queue
from .reservation import ReservationManager
from .template import MAX_INSTANCE_TYPES, NodeClaimTemplate
from .topology import Topology


class AddError:
    """Lazily-formatted placement failure for one pod; ``reserved`` marks a
    reservation-policy failure which must not trigger relaxation
    (scheduler.go:313-321)."""

    __slots__ = ("parts", "reserved")

    def __init__(self, parts, reserved=False):
        self.parts = parts
        self.reserved = reserved

    def __str__(self) -> str:
        if not self.parts:
            return "no nodepool matched pod"
        return "; ".join(
            f"incompatible with nodepool {p[0]!r}, {p[1]}" if isinstance(p, tuple) else str(p)
            for p in self.parts
        )

    def __repr__(self) -> str:
        return str(self)


@dataclass
class Results:
    """Outcome of one Solve (reference: scheduler.go:161-165)."""

    new_node_claims: List[InFlightNodeClaim] = field(default_factory=list)
    existing_nodes: List[ExistingNode] = field(default_factory=list)
    pod_errors: Dict[str, str] = field(default_factory=dict)  # pod uid -> error

    def all_pods_scheduled(self) -> bool:
        return not self.pod_errors

    def truncate_instance_types(self, max_types: int = MAX_INSTANCE_TYPES) -> "Results":
        """Price-ordered truncation per new claim (scheduler.go:249-267).

        Runs at the end of every solve (oracle and TPU paths), so all
        consumers — provisioning, disruption replacements, the solver
        sidecar — see validated, launchable option sets. Claims already
        within the cap skip the price sort; minValues (when present) is
        still validated over the full set.

        The price sort is memoized on the inputs it actually depends on:
        the options list, the requirement entries over keys any offering
        defines (zone/capacity-type/reservation), and the presence set of
        positively-constrained custom keys (the Compatible asymmetry makes
        every offering incompatible when one is undefined offering-side,
        types.go:289-293 + requirements.go:178-188). Claims opened from
        the same group bulk — and across bulks, claims pinned to the same
        domain — share these, and on shapes like the diverse mix (~1,000
        one-pod anti-affinity claims) the per-claim Python sort otherwise
        dwarfs the entire kernel solve."""
        valid = []
        memo: dict = {}
        okeys_memo: dict = {}
        for claim in self.new_node_claims:
            options = claim.instance_type_options
            reqs = claim.requirements
            if len(options) <= max_types:
                err = None
                if reqs.has_min_values():
                    _, err = cp.satisfies_min_values(options, reqs)
                truncated = options
            elif reqs.has_min_values():
                # minValues depends on every requirement entry; don't
                # risk key coarsening on the rare pools that use it
                truncated, err = cp.truncate(options, reqs, max_types)
            else:
                # object identity, not names: distinct per-pool catalogs
                # may reuse type names with different offerings, and the
                # InstanceType objects are stable for this call's lifetime
                names = tuple(map(id, options))
                okeys = okeys_memo.get(names)
                if okeys is None:
                    seen: set = set()
                    for it in options:
                        for o in it.offerings:
                            seen.update(o.requirements.keys())
                    okeys = okeys_memo[names] = tuple(sorted(seen))
                custom_pos = tuple(sorted(
                    r.key
                    for r in reqs
                    if r.key not in labels_mod.WELL_KNOWN_LABELS
                    and r.key not in okeys
                    and r.operator() in ("In", "Exists", "Gt", "Lt")
                ))
                # full requirement state, NOT repr: __repr__ is lossy
                # ('k Exists' for both defined-Exists and undefined; Gt/Lt
                # bounds drop intersected values), and defined-vs-undefined
                # changes the Compatible asymmetry's verdict
                def _req_state(k):
                    if not reqs.has(k):
                        return None
                    r = reqs.get(k)
                    return (
                        r.complement, tuple(sorted(r.values)),
                        r.greater_than, r.less_than,
                    )

                key = (
                    names,
                    tuple(_req_state(k) for k in okeys),
                    custom_pos,
                )
                hit = memo.get(key)
                if hit is None:
                    hit = memo[key] = cp.truncate(options, reqs, max_types)
                cached, err = hit
                truncated = list(cached)
            if err is not None:
                for pod in claim.pods:
                    self.pod_errors[pod.uid] = (
                        f"nodepool {claim.template.node_pool_name!r} couldn't meet"
                        f" minValues requirements after truncation"
                    )
            else:
                claim.instance_type_options = truncated
                valid.append(claim)
        self.new_node_claims = valid
        return self

    def node_count(self) -> int:
        return len(self.new_node_claims)

    def total_price(self) -> float:
        """Packing cost: sum of each new claim's cheapest launchable price.

        The packing-cost comparator used for oracle-vs-TPU parity
        (BASELINE.json metric)."""
        total = 0.0
        for claim in self.new_node_claims:
            prices = [
                cp.min_compatible_price(it, claim.requirements)
                for it in claim.instance_type_options
            ]
            total += min(prices) if prices else 0.0
        return total


_LOG = logging.getLogger("karpenter_tpu.scheduler")


class Scheduler:
    def __init__(
        self,
        node_pools: Sequence[NodePool],
        instance_types: Dict[str, List[cp.InstanceType]],
        topology: Topology,
        state_nodes: Sequence = (),
        daemonset_pods: Sequence[Pod] = (),
        reserved_offering_mode: str = RESERVED_OFFERING_MODE_FALLBACK,
        reserved_capacity_enabled: bool = False,
        clock=None,
        volume_resolver=None,
        node_model_cache: Optional[dict] = None,
    ):
        self.clock = clock
        self.volume_resolver = volume_resolver
        # cross-solve cache for the pure per-node model inputs (taints,
        # daemon remainder, label requirements) — consolidation's binary
        # search rebuilds a Scheduler per probe over the SAME snapshot
        # nodes, and this construction dominated per-probe host time
        self._node_model_cache = node_model_cache
        # tolerate PreferNoSchedule during relaxation if any pool taints with it
        tolerate_pns = any(
            t.effect == taints_mod.PREFER_NO_SCHEDULE
            for np in node_pools
            for t in np.spec.template.spec.taints
        )
        self.preferences = Preferences(tolerate_prefer_no_schedule=tolerate_pns)
        self.topology = topology
        self.reservation_manager = ReservationManager(instance_types)
        self.reserved_offering_mode = reserved_offering_mode
        self.reserved_capacity_enabled = reserved_capacity_enabled

        # templates in weight order, pre-filtered to feasible instance types
        # (scheduler.go:104-114); order: weight desc, then name
        self.templates: List[NodeClaimTemplate] = []
        for np in sorted(node_pools, key=lambda p: (-p.spec.weight, p.name)):
            nct = NodeClaimTemplate(np)
            options, _ = filter_instance_types(
                instance_types.get(np.name, []), nct.requirements, {}, {}, {}
            )
            if not options:
                continue  # pool requirements filtered out all instance types
            nct.instance_type_options = options
            self.templates.append(nct)

        self.daemon_overhead = {
            nct: _daemon_overhead(nct, daemonset_pods) for nct in self.templates
        }
        self.remaining_resources: Dict[str, res.ResourceList] = {
            np.name: dict(np.spec.limits) for np in node_pools if np.spec.limits
        }
        self.cached_pod_data: Dict[str, PodData] = {}
        self.new_node_claims: List[InFlightNodeClaim] = []
        self.existing_nodes: List[ExistingNode] = []
        self._calculate_existing_nodes(state_nodes, daemonset_pods)

    # -- existing nodes (scheduler.go:427-463) ----------------------------

    @staticmethod
    def _node_identity(sn) -> tuple:
        """Cache identity of a StateNode's pure model inputs: labels and
        taints can only change with the backing objects' resource
        versions."""
        node_rv = sn.node.metadata.resource_version if sn.node is not None else -1
        claim_rv = (
            sn.node_claim.metadata.resource_version
            if sn.node_claim is not None
            else -1
        )
        return (sn.name, node_rv, claim_rv)

    def _calculate_existing_nodes(self, state_nodes, daemonset_pods) -> None:
        cache = self._node_model_cache
        daemon_fp = (
            tuple(
                (p.uid, p.metadata.resource_version) for p in daemonset_pods
            )
            if cache is not None
            else ()
        )
        # content-shared label requirements: fleets are homogeneous, so the
        # non-hostname label shape repeats across thousands of nodes. The
        # shared base is built once per distinct shape; each node's
        # requirements are a fresh container over the SHARED Requirement
        # entries plus its own hostname pin (safe: Requirements.add never
        # mutates stored entries, it replaces them with intersections).
        shared_base: dict = {}
        for sn in state_nodes:
            hit = None
            if cache is not None:
                key = self._node_identity(sn) + (daemon_fp,)
                hit = cache.get(key)
            if hit is not None:
                taints, daemon_requests, base_entries = hit
                # a FRESH container per solve over the shared (immutable)
                # Requirement entries: the container itself is mutated by
                # decode's existing-node fill commit, so handing out a
                # cached container would leak one solve's fills into the
                # next solve's node model
                base_reqs = Requirements(*base_entries)
            else:
                taints = sn.taints()
                daemons = []
                for p in daemonset_pods:
                    if taints_mod.tolerates_pod(taints, p) is not None:
                        continue
                    if (
                        Requirements.from_labels(sn.labels()).compatible(pod_requirements(p))
                        is not None
                    ):
                        continue
                    daemons.append(p)
                daemon_requests = res.merge(*(p.spec.requests for p in daemons)) if daemons else {}
                base_reqs = None
                if cache is not None:
                    labels = sn.labels()
                    ckey = tuple(
                        sorted(
                            (k, v)
                            for k, v in labels.items()
                            if k != labels_mod.HOSTNAME
                        )
                    )
                    shared = shared_base.get(ckey)
                    if shared is None:
                        shared = shared_base[ckey] = Requirements.from_labels(
                            {
                                k: v
                                for k, v in labels.items()
                                if k != labels_mod.HOSTNAME
                            }
                        ).values()
                    # the hostname pin subsumes the hostname label (its
                    # value IS the label's, statenode hostname fallback
                    # included), so base+pin == build_requirements(sn)
                    base_reqs = Requirements(*shared)
                    base_reqs.add(
                        Requirement(
                            labels_mod.HOSTNAME, Operator.IN, [sn.hostname()]
                        )
                    )
                    # cache the ENTRIES, not the container (see the hit
                    # path above)
                    cache[key] = (
                        taints, daemon_requests, tuple(base_reqs.values())
                    )
            self.existing_nodes.append(
                ExistingNode(
                    sn, self.topology, taints, daemon_requests,
                    base_requirements=base_reqs,
                )
            )
            pool = sn.labels().get(labels_mod.NODEPOOL_LABEL_KEY)
            if pool in self.remaining_resources:
                self.remaining_resources[pool] = res.subtract(
                    self.remaining_resources[pool], sn.capacity()
                )
        self.existing_nodes.sort(key=lambda n: (not n.initialized(), n.name))
        # resource-version churn retires entries; bound the long-lived
        # provisioner cache rather than leak one entry per rv bump
        if cache is not None and len(cache) > max(10_000, 8 * len(self.existing_nodes)):
            cache.clear()

    # -- per-pod placement (scheduler.go:357-425) -------------------------

    def _update_cached_pod_data(self, pod: Pod) -> None:
        requirements = pod_requirements(pod)
        strict = requirements
        if has_preferred_node_affinity(pod):
            strict = strict_pod_requirements(pod)
        resolved_volumes, volume_error = (), None
        if pod.spec.volumes and self.volume_resolver is not None:
            resolved_volumes, volume_error = self.volume_resolver.resolve(pod)
        self.cached_pod_data[pod.uid] = PodData(
            requests=dict(pod.spec.requests),
            requirements=requirements,
            strict_requirements=strict,
            resolved_volumes=resolved_volumes,
            volume_error=volume_error,
        )

    def _add(self, pod: Pod) -> Optional[AddError]:
        pod_data = self.cached_pod_data[pod.uid]
        # a pod whose PVC can't be resolved can never run anywhere — fail it
        # instead of launching capacity for it (volumetopology.go:152-199;
        # matters for disruption simulations, which bypass Provisioner
        # validation)
        if pod_data.volume_error is not None:
            return AddError([pod_data.volume_error])
        # 1. existing nodes, initialized first
        for node in self.existing_nodes:
            if node.add(pod, pod_data) is None:
                return None
        # 2. open in-flight claims, fewest pods first
        self.new_node_claims.sort(key=lambda c: len(c.pods))
        for claim in self.new_node_claims:
            try:
                if claim.add(pod, pod_data) is None:
                    return None
            except ReservedOfferingError:
                continue
        # 3. new claim from the highest-weight feasible template
        errs = []
        reserved = False
        for nct in self.templates:
            instance_types = nct.instance_type_options
            if nct.node_pool_name in self.remaining_resources:
                instance_types = _filter_by_remaining_resources(
                    instance_types, self.remaining_resources[nct.node_pool_name]
                )
                if not instance_types:
                    errs.append(
                        f"all instance types exceed limits for nodepool"
                        f" {nct.node_pool_name!r}"
                    )
                    continue
            claim = InFlightNodeClaim(
                nct,
                self.topology,
                self.daemon_overhead[nct],
                instance_types,
                self.reservation_manager,
                self.reserved_offering_mode,
                self.reserved_capacity_enabled,
            )
            try:
                err = claim.add(pod, pod_data)
            except ReservedOfferingError as e:
                claim.destroy()
                errs.append(f"reserved offering policy for {nct.node_pool_name!r}: {e}")
                reserved = True
                # don't fall back to lower-weight pools past a reservation error
                break
            if err is not None:
                claim.destroy()
                errs.append((nct.node_pool_name, err))
                continue
            self.new_node_claims.append(claim)
            if nct.node_pool_name in self.remaining_resources:
                self.remaining_resources[nct.node_pool_name] = _subtract_max(
                    self.remaining_resources[nct.node_pool_name],
                    claim.instance_type_options,
                )
            return None
        return AddError(errs, reserved=reserved)

    # -- the solve loop (scheduler.go:270-339) ----------------------------

    def solve(self, pods: Sequence[Pod]) -> Results:
        for p in pods:
            self._update_cached_pod_data(p)
        queue = Queue(
            list(pods), {uid: d.requests for uid, d in self.cached_pod_data.items()}
        )
        pod_errors: Dict[str, str] = {}
        relaxed_uids: set = set()
        # injected clock when provided (the project's clock convention,
        # kube/clock.py) — tests can then drive the progress threshold
        _now = self.clock.now if self.clock is not None else time.monotonic
        solve_start = _now()
        last_progress = solve_start
        placed = 0
        while True:
            pod = queue.pop()
            if pod is None:
                break
            # the reference logs progress every minute inside long Solves
            # (scheduler.go:297-300)
            now = _now()
            if now - last_progress >= 60.0:
                last_progress = now
                _LOG.info(
                    "computing scheduling decision for provisionable pods: "
                    "%d placed, elapsed %.0fs",
                    placed,
                    now - solve_start,
                )
            err = self._add(pod)
            if err is None:
                pod_errors.pop(pod.uid, None)
                placed += 1
                continue
            pod_errors[pod.uid] = err
            relaxed = False
            if not err.reserved:
                if pod.uid not in relaxed_uids and _has_relaxable_terms(
                    pod, self.preferences.tolerate_prefer_no_schedule
                ):
                    # relaxation mutates the pod spec, but callers hand us
                    # LIVE store objects (and disruption probes share pods
                    # across simulations): mutate a private copy, the way
                    # the reference's cache-backed client hands its
                    # scheduler deep copies (preferences.go:38-146 relaxes
                    # without ever touching the informer's object)
                    import copy

                    pod = copy.deepcopy(pod)
                    relaxed_uids.add(pod.uid)
                relaxed = self.preferences.relax(pod)
                if relaxed:
                    self.topology.update(pod)
                    self._update_cached_pod_data(pod)
            queue.push(pod, relaxed)
        for claim in self.new_node_claims:
            claim.finalize()
        return Results(
            new_node_claims=self.new_node_claims,
            existing_nodes=self.existing_nodes,
            pod_errors=pod_errors,
        ).truncate_instance_types()


def _has_relaxable_terms(pod: Pod, tolerate_pns: bool) -> bool:
    """Anything Preferences.relax could mutate (preferences.py): extra
    required node-affinity OR-terms, preferred terms, ScheduleAnyway
    spreads, or (when pools taint PreferNoSchedule) the toleration append.
    Pods with none of these skip the defensive deep copy."""
    spec = pod.spec
    na = spec.node_affinity
    if na is not None and (na.preferred or len(na.required) > 1):
        return True
    if spec.preferred_pod_affinity or spec.preferred_pod_anti_affinity:
        return True
    if any(
        t.when_unsatisfiable == "ScheduleAnyway"
        for t in spec.topology_spread_constraints
    ):
        return True
    return tolerate_pns


def _daemon_overhead(nct: NodeClaimTemplate, daemonset_pods: Sequence[Pod]) -> res.ResourceList:
    """Total requests of daemon pods compatible with the template
    (scheduler.go:466-492)."""
    compatible = [p for p in daemonset_pods if _daemon_compatible(nct, p)]
    return res.merge(*(p.spec.requests for p in compatible)) if compatible else {}


def _daemon_compatible(nct: NodeClaimTemplate, pod: Pod) -> bool:
    import copy

    pod = copy.deepcopy(pod)
    prefs = Preferences()
    prefs._tolerate_prefer_no_schedule_taints(pod)
    if taints_mod.tolerates_pod(nct.taints, pod) is not None:
        return False
    while True:
        if (
            nct.requirements.compatible(
                strict_pod_requirements(pod), labels_mod.WELL_KNOWN_LABELS
            )
            is None
        ):
            return True
        if prefs._remove_required_node_affinity_term(pod) is None:
            return False


def _subtract_max(
    remaining: res.ResourceList, instance_types: Sequence[cp.InstanceType]
) -> res.ResourceList:
    """Pessimistically subtract the max capacity per resource
    (scheduler.go:498-515)."""
    if not instance_types:
        return remaining
    max_caps = res.max_resources(*(it.capacity for it in instance_types))
    return {k: v - max_caps.get(k, 0) for k, v in remaining.items()}


def _filter_by_remaining_resources(
    instance_types: Sequence[cp.InstanceType], remaining: res.ResourceList
) -> List[cp.InstanceType]:
    """Drop instance types whose capacity exceeds any remaining limit
    (scheduler.go:517-534)."""
    out = []
    for it in instance_types:
        if all(it.capacity.get(name, 0) <= q for name, q in remaining.items()):
            out.append(it)
    return out
