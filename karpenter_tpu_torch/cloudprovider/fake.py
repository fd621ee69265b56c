# Copied from karpenter_tpu/cloudprovider/fake.py.
"""Fake provider for unit tests: call recording + error injection.

Mirror of the reference's pkg/cloudprovider/fake (cloudprovider.go:113-192,
instancetype.go:155-200): in-memory create/get/list/delete, injectable
next-call errors, a created-claim log, and a synthesized diverse corpus.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

from ..api import labels as labels_mod
from ..api.objects import NodeClaim, ObjectMeta
from ..api.requirements import Requirements
from . import corpus
from .icecache import InsufficientCapacityCache, mask_unavailable_offerings
from .types import (
    CloudProvider,
    InstanceType,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    RepairPolicy,
    available,
    cheapest,
    compatible_offerings,
)


def instance_types(count: int = 5) -> List[InstanceType]:
    """Synthesize ``count`` diverse instance types (fake/instancetype.go:155-200)."""
    return corpus.generate(count)


class FakeCloudProvider(CloudProvider):
    def __init__(
        self,
        types: Optional[Sequence[InstanceType]] = None,
        clock=None,
    ):
        self._instance_types = list(types if types is not None else instance_types())
        # public, possibly None: MetricsCloudProvider reads the injected
        # clock when present (same contract as kwok)
        self.clock = clock
        self.created: Dict[str, NodeClaim] = {}
        self.create_calls: List[NodeClaim] = []
        self.delete_calls: List[NodeClaim] = []
        self.next_create_err: Optional[Exception] = None
        self.next_get_err: Optional[Exception] = None
        self.next_delete_err: Optional[Exception] = None
        self.allowed_create_calls: Optional[int] = None
        self.drifted: str = ""
        self._repair_policies: List[RepairPolicy] = []
        self._seq = itertools.count(1)
        self._tombstones: set = set()
        # ICE cache mirrors kwok's: clock-driven TTL skip of failed
        # offerings; tests mark cells via mark_insufficient_capacity
        self.ice_cache = (
            InsufficientCapacityCache(clock) if clock is not None else None
        )

    def mark_insufficient_capacity(
        self, instance_type: str, zone: str, capacity_type: str
    ) -> None:
        if self.ice_cache is None:
            raise RuntimeError("FakeCloudProvider built without a clock")
        self.ice_cache.mark_unavailable(instance_type, zone, capacity_type)

    def name(self) -> str:
        return "fake"

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        self.create_calls.append(node_claim)
        if self.next_create_err is not None:
            err, self.next_create_err = self.next_create_err, None
            raise err
        if self.allowed_create_calls is not None and len(self.create_calls) > self.allowed_create_calls:
            raise InsufficientCapacityError("exceeded allowed create calls")
        reqs = node_claim.spec.scheduling_requirements()
        ice_active = self.ice_cache is not None and self.ice_cache.active()
        for it in self._instance_types:
            if reqs.intersects(it.requirements) is not None:
                continue
            ofs = compatible_offerings(available(it.offerings), reqs)
            if ice_active:
                ofs = self.ice_cache.filter_offerings(it.name, ofs)
            of = cheapest(ofs)
            if of is None:
                continue
            provider_id = f"fake://{node_claim.name}/{next(self._seq)}"
            node_claim.status.provider_id = provider_id
            node_claim.status.capacity = dict(it.capacity)
            node_claim.status.allocatable = dict(it.allocatable())
            node_claim.metadata.labels.setdefault(labels_mod.INSTANCE_TYPE, it.name)
            node_claim.metadata.labels.setdefault(
                labels_mod.CAPACITY_TYPE_LABEL_KEY, of.capacity_type()
            )
            node_claim.metadata.labels.setdefault(labels_mod.TOPOLOGY_ZONE, of.zone())
            self.created[provider_id] = node_claim
            return node_claim
        raise InsufficientCapacityError(f"no compatible instance type for {node_claim.name}")

    def delete(self, node_claim: NodeClaim) -> None:
        self.delete_calls.append(node_claim)
        if self.next_delete_err is not None:
            err, self.next_delete_err = self.next_delete_err, None
            raise err
        pid = node_claim.status.provider_id
        if pid not in self.created:
            # typed NotFound for unknown ids and double-deletes alike
            if pid in self._tombstones:
                raise NodeClaimNotFoundError(f"{pid} already terminated")
            raise NodeClaimNotFoundError(pid or "<no provider id>")
        del self.created[pid]
        self._tombstones.add(pid)

    def get(self, provider_id: str) -> NodeClaim:
        if self.next_get_err is not None:
            err, self.next_get_err = self.next_get_err, None
            raise err
        claim = self.created.get(provider_id)
        if claim is None:
            raise NodeClaimNotFoundError(provider_id)
        return claim

    def list(self) -> List[NodeClaim]:
        return list(self.created.values())

    def get_instance_types(self, node_pool) -> List[InstanceType]:
        if self.ice_cache is not None and self.ice_cache.active():
            return mask_unavailable_offerings(
                self._instance_types, self.ice_cache
            )
        return list(self._instance_types)

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return self.drifted

    def repair_policies(self) -> List[RepairPolicy]:
        return self._repair_policies
