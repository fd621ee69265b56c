# Copied from karpenter_tpu/cloudprovider/types.py.
"""CloudProvider SPI: instance types, offerings, typed errors.

Mirror of the reference's pkg/cloudprovider/types.go. InstanceType collections
are plain lists; the ordering/truncation/minValues helpers are module
functions (Python has no method-on-slice idiom).
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..api import labels as labels_mod
from ..api import resources as res
from ..api.requirements import Operator, Requirement, Requirements

RESERVATION_ID_LABEL = labels_mod.RESERVATION_ID_LABEL

_MAX_PRICE = math.inf


def _capacity_type_requirements(value: str) -> Requirements:
    return Requirements(Requirement(labels_mod.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [value]))


RESERVED_REQUIREMENT = _capacity_type_requirements(labels_mod.CAPACITY_TYPE_RESERVED)
SPOT_REQUIREMENT = _capacity_type_requirements(labels_mod.CAPACITY_TYPE_SPOT)
ON_DEMAND_REQUIREMENT = _capacity_type_requirements(labels_mod.CAPACITY_TYPE_ON_DEMAND)


@dataclass
class Offering:
    """Where an InstanceType is purchasable (zone x capacity-type), with price
    and availability (reference: types.go:252-276)."""

    requirements: Requirements
    price: float
    available: bool = True
    reservation_capacity: int = 0

    def capacity_type(self) -> str:
        return self.requirements.get(labels_mod.CAPACITY_TYPE_LABEL_KEY).any()

    def zone(self) -> str:
        return self.requirements.get(labels_mod.TOPOLOGY_ZONE).any()

    def reservation_id(self) -> str:
        return self.requirements.get(RESERVATION_ID_LABEL).any()


@dataclass
class InstanceTypeOverhead:
    kube_reserved: res.ResourceList = field(default_factory=dict)
    system_reserved: res.ResourceList = field(default_factory=dict)
    eviction_threshold: res.ResourceList = field(default_factory=dict)

    def total(self) -> res.ResourceList:
        return res.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


@dataclass
class InstanceType:
    """A purchasable machine shape (reference: types.go:94-123).

    ``requirements`` must define every well-known label; ``capacity`` is the
    full resource capacity; allocatable = capacity - overhead (memoized).
    """

    name: str
    requirements: Requirements
    offerings: List[Offering]
    capacity: res.ResourceList
    overhead: InstanceTypeOverhead = field(default_factory=InstanceTypeOverhead)
    _allocatable: Optional[res.ResourceList] = field(default=None, repr=False, compare=False)

    def allocatable(self) -> res.ResourceList:
        if self._allocatable is None:
            self._allocatable = res.subtract(self.capacity, self.overhead.total())
        return self._allocatable


def available(offerings: Sequence[Offering]) -> List[Offering]:
    return [o for o in offerings if o.available]


def compatible_offerings(offerings: Sequence[Offering], reqs: Requirements) -> List[Offering]:
    """Offerings whose labels satisfy reqs (reference: types.go:289-293)."""
    return [
        o
        for o in offerings
        if reqs.is_compatible(o.requirements, labels_mod.WELL_KNOWN_LABELS)
    ]


def has_compatible(offerings: Sequence[Offering], reqs: Requirements) -> bool:
    return any(
        reqs.is_compatible(o.requirements, labels_mod.WELL_KNOWN_LABELS) for o in offerings
    )


def cheapest(offerings: Sequence[Offering]) -> Optional[Offering]:
    return min(offerings, key=lambda o: o.price, default=None)


def most_expensive(offerings: Sequence[Offering]) -> Optional[Offering]:
    return max(offerings, key=lambda o: o.price, default=None)


def worst_launch_price(offerings: Sequence[Offering], reqs: Requirements) -> float:
    """Worst-case launch price with capacity-type precedence
    reserved > spot > on-demand (reference: types.go:315-325)."""
    for ct_reqs in (RESERVED_REQUIREMENT, SPOT_REQUIREMENT, ON_DEMAND_REQUIREMENT):
        compat = compatible_offerings(compatible_offerings(offerings, reqs), ct_reqs)
        if compat:
            return most_expensive(compat).price
    return _MAX_PRICE


def _min_compatible_price_general(it: InstanceType, reqs: Requirements) -> float:
    ofs = compatible_offerings(available(it.offerings), reqs)
    return cheapest(ofs).price if ofs else _MAX_PRICE


def min_compatible_price(
    it: InstanceType, reqs: Requirements, _memo: Optional[dict] = None
) -> float:
    """Cheapest available compatible offering's price.

    ``_memo`` (an order_by_price-scoped dict) caches the per-(key,
    value-set) admission verdicts: one claim signature's catalog sort
    asks the same few questions of hundreds of types' offerings.

    Fast path: offering requirements are concrete In-sets (zone /
    capacity-type / reservation id), so ``reqs.is_compatible(offering)``
    folds to per-key ``Requirement.has`` membership — the general
    Requirements walk costs ~5us per offering and dominates group-heavy
    decodes (Results.truncate_instance_types sorts every distinct claim
    signature's catalog through here; the diverse mix paid ~0.7 s/solve).
    Offerings carrying complements or empty value sets take the exact
    general path. Semantics are identical: compatible() only tests the
    offering's keys for definedness (well-known allowance) and
    intersects() only shared keys, and has_intersection against an In-set
    is exactly any(existing.has(v))."""
    best = _MAX_PRICE
    wk = labels_mod.WELL_KNOWN_LABELS
    for o in it.offerings:
        if not o.available or o.price >= best:
            continue
        ok = True
        for orq in o.requirements:
            if orq.complement or not orq.values:
                return min(best, _min_compatible_price_general(it, reqs))
            mk = (orq.key, *sorted(orq.values)) if len(orq.values) > 1 \
                else (orq.key, next(iter(orq.values)))
            adm = _memo.get(mk) if _memo is not None else None
            if adm is None:
                if orq.key in reqs:
                    rr = reqs.get(orq.key)
                    adm = any(rr.has(v) for v in orq.values)
                else:
                    # custom label positively constrained offering-side
                    # with no claim-side definition: Compatible's
                    # asymmetry (requirements.py:compatible) rejects it
                    adm = orq.key in wk
                if _memo is not None:
                    _memo[mk] = adm
            if not adm:
                ok = False
                break
        if ok:
            best = o.price
    return best


def order_by_price(
    instance_types: Sequence[InstanceType], reqs: Requirements
) -> List[InstanceType]:
    """Sort by cheapest compatible available offering, name tie-break
    (reference: types.go:125-142)."""
    memo: dict = {}
    return sorted(
        instance_types,
        key=lambda it: (min_compatible_price(it, reqs, memo), it.name),
    )


def compatible_instance_types(
    instance_types: Sequence[InstanceType], reqs: Requirements
) -> List[InstanceType]:
    return [it for it in instance_types if has_compatible(available(it.offerings), reqs)]


def satisfies_min_values(
    instance_types: Sequence[InstanceType], reqs: Requirements
) -> Tuple[int, Optional[str]]:
    """Minimum prefix length of instance_types meeting every minValues
    requirement, or an error naming the first unmet key
    (reference: types.go:155-233). Order-dependent: callers sort by price
    first.
    """
    if not reqs.has_min_values():
        return 0, None
    values_for_key: Dict[str, Set[str]] = {}
    min_keys = [r.key for r in reqs if r.min_values is not None]
    incompatible_key = ""
    for i, it in enumerate(instance_types):
        for key in min_keys:
            values_for_key.setdefault(key, set()).update(
                it.requirements.get(key).values_list()
            )
        incompatible_key = ""
        for key, vals in values_for_key.items():
            needed = reqs.get(key).min_values or 0
            if len(vals) < needed:
                incompatible_key = key
                break
        if not incompatible_key:
            return i + 1, None
    if incompatible_key:
        return len(list(instance_types)), f'minValues requirement is not met for "{incompatible_key}"'
    return len(list(instance_types)), None


def truncate(
    instance_types: Sequence[InstanceType], reqs: Requirements, max_items: int
) -> Tuple[List[InstanceType], Optional[str]]:
    """Price-ordered truncation to max_items, validating minValues
    (reference: types.go:235-247). On minValues violation, returns the input
    untruncated with an error.
    """
    ordered = order_by_price(instance_types, reqs)
    truncated = ordered[:max_items]
    if reqs.has_min_values():
        _, err = satisfies_min_values(truncated, reqs)
        if err is not None:
            return list(instance_types), f"validating minValues, {err}"
    return truncated, None


# --- typed errors (reference: types.go:327-437) ---------------------------


class CloudProviderError(Exception):
    pass


class NodeClaimNotFoundError(CloudProviderError):
    pass


class InsufficientCapacityError(CloudProviderError):
    """Create failed for all capacity pools; unrecoverable for this config."""


class NodeClassNotReadyError(CloudProviderError):
    pass


class CreateError(CloudProviderError):
    def __init__(self, message: str, condition_reason: str = "", condition_message: str = ""):
        super().__init__(message)
        self.condition_reason = condition_reason
        self.condition_message = condition_message or message


@dataclass
class RepairPolicy:
    """Unhealthy-node condition the provider wants force-repaired after a
    toleration window (reference: types.go:51-59)."""

    condition_type: str
    condition_status: str
    toleration_duration: float  # seconds


class CloudProvider(abc.ABC):
    """The provider SPI (reference: types.go:62-90)."""

    @abc.abstractmethod
    def create(self, node_claim):
        """Launch capacity for a NodeClaim; returns the updated NodeClaim with
        provider_id/capacity/allocatable resolved."""

    @abc.abstractmethod
    def delete(self, node_claim) -> None:
        ...

    @abc.abstractmethod
    def get(self, provider_id: str):
        ...

    @abc.abstractmethod
    def list(self) -> List:
        ...

    @abc.abstractmethod
    def get_instance_types(self, node_pool) -> List[InstanceType]:
        ...

    @abc.abstractmethod
    def is_drifted(self, node_claim) -> str:
        """Returns a drift reason or empty string."""

    def repair_policies(self) -> List[RepairPolicy]:
        return []

    @abc.abstractmethod
    def name(self) -> str:
        ...
