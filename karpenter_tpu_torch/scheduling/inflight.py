# Copied from karpenter_tpu/scheduling/inflight.py.
"""In-flight NodeClaim and ExistingNode simulation models.

Mirror of the reference's nodeclaim.go:83-434 and existingnode.go:31-122: the
Add(pod) discipline — taints -> host ports -> requirements compat+tighten ->
topology tighten -> instance-type filter -> reserved-offering accounting —
committing mutations only when every gate passes.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import labels as labels_mod
from ..api import resources as res
from ..api import taints as taints_mod
from ..api.objects import Pod, Taint
from ..api.requirements import Operator, Requirement, Requirements
from ..cloudprovider import types as cp
from .hostports import HostPortUsage
from .reservation import ReservationManager
from .template import NodeClaimTemplate
from .topology import Topology

# reserved-offering modes (reference: scheduler.go:49-78)
RESERVED_OFFERING_MODE_FALLBACK = "fallback"
RESERVED_OFFERING_MODE_STRICT = "strict"


class ReservedOfferingError(Exception):
    """Failure to adhere to the reservation policy; not relaxable."""


class PodData:
    """Cached per-pod scheduling data (reference: scheduler.go:136-141).
    Volume resolution is pod-scoped and node-independent, so it's cached
    here rather than re-walked per ExistingNode attempt."""

    __slots__ = (
        "requests",
        "requirements",
        "strict_requirements",
        "resolved_volumes",
        "volume_error",
    )

    def __init__(
        self,
        requests,
        requirements,
        strict_requirements,
        resolved_volumes=(),
        volume_error=None,
    ):
        self.requests = requests
        self.requirements = requirements
        self.strict_requirements = strict_requirements
        self.resolved_volumes = resolved_volumes
        self.volume_error = volume_error


def filter_instance_types(
    instance_types: Sequence[cp.InstanceType],
    requirements: Requirements,
    pod_requests: res.ResourceList,
    daemon_requests: res.ResourceList,
    total_requests: res.ResourceList,
) -> Tuple[List[cp.InstanceType], Optional[str]]:
    """compatible && fits && hasOffering filter, with minValues validation
    (reference: nodeclaim.go:363-426). Returns (remaining, error)."""
    remaining = []
    any_compat = any_fits = any_offering = False
    for it in instance_types:
        it_compat = it.requirements.intersects(requirements) is None
        it_fits = res.fits(total_requests, it.allocatable())
        it_offering = cp.has_compatible(cp.available(it.offerings), requirements)
        any_compat |= it_compat
        any_fits |= it_fits
        any_offering |= it_offering
        if it_compat and it_fits and it_offering:
            remaining.append(it)
    if requirements.has_min_values():
        _, err = cp.satisfies_min_values(remaining, requirements)
        if err is not None:
            remaining = []
    if not remaining:
        detail = (
            f"no instance type satisfied resources {res.to_string(total_requests)}"
            f" and requirements (compatible={any_compat}, fits={any_fits},"
            f" offering={any_offering})"
        )
        return [], detail
    return remaining, None


_hostname_seq = itertools.count(1)


class InFlightNodeClaim:
    """A simulated node being built up during a Solve
    (reference: nodeclaim.go:83-165)."""

    def __init__(
        self,
        template: NodeClaimTemplate,
        topology: Topology,
        daemon_resources: res.ResourceList,
        instance_types: List[cp.InstanceType],
        reservation_manager: Optional[ReservationManager] = None,
        reserved_offering_mode: str = RESERVED_OFFERING_MODE_FALLBACK,
        reserved_capacity_enabled: bool = False,
    ):
        self.template = template
        self.topology = topology
        self.hostname = f"hostname-placeholder-{next(_hostname_seq):05d}"
        self.requirements = Requirements(*template.requirements.values())
        self.requirements.add(
            Requirement(labels_mod.HOSTNAME, Operator.IN, [self.hostname])
        )
        topology.register(labels_mod.HOSTNAME, self.hostname)
        self.instance_type_options = list(instance_types)
        self.daemon_resources = daemon_resources
        self.requests: res.ResourceList = dict(daemon_resources)
        self.pods: List[Pod] = []
        self.hostport_usage = HostPortUsage()
        self.reservation_manager = reservation_manager
        self.reserved_offering_mode = reserved_offering_mode
        self.reserved_capacity_enabled = reserved_capacity_enabled
        self.reserved_offerings: List[cp.Offering] = []

    def add(self, pod: Pod, pod_data: PodData) -> Optional[str]:
        """Try to place the pod; mutates state only on success. Returns an
        error string (or raises ReservedOfferingError) on failure."""
        err = taints_mod.tolerates_pod(self.template.taints, pod)
        if err is not None:
            return err
        err = self.hostport_usage.conflicts(pod)
        if err is not None:
            return err

        claim_requirements = Requirements(*self.requirements.values())
        err = claim_requirements.compatible(
            pod_data.requirements, labels_mod.WELL_KNOWN_LABELS
        )
        if err is not None:
            return err  # kept unformatted: hot path (nodeclaim.go:125-127)
        claim_requirements.add(*pod_data.requirements.values())

        topo_requirements, err = self.topology.add_requirements(
            pod,
            self.template.taints,
            pod_data.strict_requirements,
            claim_requirements,
        )
        if err is not None:
            return err
        err = claim_requirements.compatible(topo_requirements, labels_mod.WELL_KNOWN_LABELS)
        if err is not None:
            return err
        claim_requirements.add(*topo_requirements.values())

        requests = res.merge(self.requests, pod_data.requests)
        remaining, err = filter_instance_types(
            self.instance_type_options,
            claim_requirements,
            pod_data.requests,
            self.daemon_resources,
            requests,
        )
        if err is not None:
            return err

        reserved = self._reserve_offerings(remaining, claim_requirements)

        # commit
        self.pods.append(pod)
        self.instance_type_options = remaining
        self.requests = requests
        self.requirements = claim_requirements
        self.topology.record(pod, self.template.taints, claim_requirements)
        self.hostport_usage.add(pod)
        self._release_stale_reservations(self.reserved_offerings, reserved)
        self.reserved_offerings = reserved
        return None

    # -- reserved offerings (nodeclaim.go:186-233) ------------------------

    def _reserve_offerings(
        self, instance_types: List[cp.InstanceType], requirements: Requirements
    ) -> List[cp.Offering]:
        if not self.reserved_capacity_enabled or self.reservation_manager is None:
            return []
        has_compatible = False
        reserved: List[cp.Offering] = []
        for it in instance_types:
            for o in it.offerings:
                if (
                    o.capacity_type() != labels_mod.CAPACITY_TYPE_RESERVED
                    or not o.available
                ):
                    continue
                if not requirements.is_compatible(
                    o.requirements, labels_mod.WELL_KNOWN_LABELS
                ):
                    continue
                has_compatible = True
                if self.reservation_manager.reserve(self.hostname, o):
                    reserved.append(o)
        if self.reserved_offering_mode == RESERVED_OFFERING_MODE_STRICT:
            if has_compatible and not reserved:
                raise ReservedOfferingError(
                    "compatible reserved offerings exist but could not be reserved"
                )
            if self.reserved_offerings and not reserved:
                raise ReservedOfferingError(
                    "updated constraints would remove all reserved offering options"
                )
        return reserved

    def _release_stale_reservations(
        self, current: List[cp.Offering], updated: List[cp.Offering]
    ) -> None:
        if self.reservation_manager is None:
            return
        updated_ids = {o.reservation_id() for o in updated}
        for o in current:
            if o.reservation_id() not in updated_ids:
                self.reservation_manager.release(self.hostname, o)

    def destroy(self) -> None:
        """Roll back topology/reservation registration for an unused claim
        (nodeclaim.go:235-246)."""
        self.topology.unregister(labels_mod.HOSTNAME, self.hostname)
        if self.reservation_manager is not None:
            self.reservation_manager.release(self.hostname, *self.reserved_offerings)

    def finalize(self) -> None:
        """Swap the placeholder hostname for the real claim name
        (nodeclaim.go:242-258). Only the NAME is minted here — the full CR
        materializes at launch (to_node_claim), where truncation-time
        minValues validation may still refuse it."""
        name = self.template.new_claim_name()
        self.topology.unregister(labels_mod.HOSTNAME, self.hostname)
        self.hostname = name
        self.topology.register(labels_mod.HOSTNAME, self.hostname)
        self.requirements.add(
            Requirement(labels_mod.HOSTNAME, Operator.IN, [self.hostname])
        )

    def remove_expensive_types_than(self, max_price: float, requirements: Requirements) -> bool:
        """Keep only instance types strictly cheaper than max_price
        (nodeclaim.go RemoveInstanceTypeOptionsByPriceAndMinValues).
        Returns False if that empties the options or breaks minValues."""
        kept = [
            it
            for it in self.instance_type_options
            if cp.min_compatible_price(it, requirements) < max_price
        ]
        if requirements.has_min_values():
            _, err = cp.satisfies_min_values(kept, requirements)
            if err is not None:
                return False
        if not kept:
            return False
        self.instance_type_options = kept
        return True


class ExistingNode:
    """Add(pod) against a real or in-flight cluster node
    (reference: existingnode.go:31-122)."""

    @staticmethod
    def build_requirements(state_node) -> Requirements:
        """The node's label requirements + hostname pin. Add() REPLACES
        self.requirements with a merged copy, but the TPU decode's
        existing-node fill commit mutates the container in place — so
        schedulers caching across solves must cache the (immutable)
        Requirement ENTRIES and hand each solve a fresh container
        (Scheduler._calculate_existing_nodes does exactly that)."""
        reqs = Requirements.from_labels(state_node.labels())
        reqs.add(
            Requirement(labels_mod.HOSTNAME, Operator.IN, [state_node.hostname()])
        )
        return reqs

    def __init__(
        self,
        state_node,
        topology: Topology,
        taints: List[Taint],
        daemon_resources: res.ResourceList,
        base_requirements: Requirements = None,
    ):
        self.state_node = state_node
        self.topology = topology
        self.cached_taints = taints
        self.cached_available = state_node.available()
        self.volume_usage = getattr(state_node, "volume_usage", None)
        self.volume_usage = self.volume_usage.copy() if self.volume_usage else None
        self.volume_limits = dict(getattr(state_node, "volume_limits", {}) or {})
        # daemon resources not already scheduled to the node, floored at 0
        remaining_daemons = res.subtract(
            daemon_resources, state_node.daemonset_request_total()
        )
        self.requests = {k: max(v, 0) for k, v in remaining_daemons.items()}
        self.requirements = (
            base_requirements
            if base_requirements is not None
            else self.build_requirements(state_node)
        )
        self.pods: List[Pod] = []
        self.hostport_usage = state_node.hostport_usage.copy()
        topology.register(labels_mod.HOSTNAME, state_node.hostname())

    @property
    def name(self) -> str:
        return self.state_node.name

    def initialized(self) -> bool:
        return self.state_node.initialized()

    def add(self, pod: Pod, pod_data: PodData) -> Optional[str]:
        err = taints_mod.tolerates_pod(self.cached_taints, pod)
        if err is not None:
            return err
        err = self.hostport_usage.conflicts(pod)
        if err is not None:
            return err
        # csi volume attach limits (existingnode.go volume check)
        resolved_volumes = pod_data.resolved_volumes
        if pod.spec.volumes and self.volume_usage is not None:
            if pod_data.volume_error is not None:
                return pod_data.volume_error
            err = self.volume_usage.validate(resolved_volumes, self.volume_limits)
            if err is not None:
                return err
        requests = res.merge(self.requests, pod_data.requests)
        if not res.fits(requests, self.cached_available):
            return "exceeds node resources"
        err = self.requirements.compatible(pod_data.requirements)
        if err is not None:
            return err
        node_requirements = Requirements(*self.requirements.values())
        node_requirements.add(*pod_data.requirements.values())

        topo_requirements, err = self.topology.add_requirements(
            pod, self.cached_taints, pod_data.strict_requirements, node_requirements
        )
        if err is not None:
            return err
        err = node_requirements.compatible(topo_requirements)
        if err is not None:
            return err
        node_requirements.add(*topo_requirements.values())

        # commit
        self.pods.append(pod)
        self.requests = requests
        self.requirements = node_requirements
        self.topology.record(pod, self.cached_taints, node_requirements)
        self.hostport_usage.add(pod)
        if resolved_volumes and self.volume_usage is not None:
            self.volume_usage.add(pod, resolved_volumes)
        return None
