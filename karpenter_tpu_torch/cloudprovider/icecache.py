# Copied from karpenter_tpu/cloudprovider/icecache.py.
"""Insufficient-capacity (ICE) cache: skip offerings that just failed.

Mirror of the reference's unavailable-offerings cache
(aws/pkg/cache + kwok's launch path): when a create fails for lack of
capacity in a specific ``(instance type, zone, capacity type)`` cell, that
offering is marked unavailable for a TTL so the very next provisioning
round doesn't re-pick the same doomed offering — the solver sees the
offering as unavailable through ``get_instance_types`` and routes around
it, and the cell quietly re-enters the pool once the TTL lapses.

Clock-driven (kube/clock.py): tests expire entries by advancing the
injected TestClock, never by sleeping.
"""

from __future__ import annotations

from typing import Dict, Tuple

DEFAULT_TTL = 180.0  # seconds; the reference caches ICE cells for minutes


class InsufficientCapacityCache:
    def __init__(self, clock, ttl: float = DEFAULT_TTL):
        self._clock = clock
        self.ttl = ttl
        self._until: Dict[Tuple[str, str, str], float] = {}

    def mark_unavailable(
        self, instance_type: str, zone: str, capacity_type: str
    ) -> None:
        self._until[(instance_type, zone, capacity_type)] = (
            self._clock.now() + self.ttl
        )

    def is_unavailable(
        self, instance_type: str, zone: str, capacity_type: str
    ) -> bool:
        key = (instance_type, zone, capacity_type)
        until = self._until.get(key)
        if until is None:
            return False
        if self._clock.now() >= until:
            del self._until[key]
            return False
        return True

    def filter_offerings(self, instance_type: str, offerings):
        """The offerings of ``instance_type`` not currently ICE-cached —
        the one predicate shared by the providers' create paths and the
        catalog masking below (key shape changes land in one place)."""
        return [
            o
            for o in offerings
            if not self.is_unavailable(
                instance_type, o.zone(), o.capacity_type()
            )
        ]

    def active(self) -> bool:
        """True when any entry may still be live — the providers' fast-path
        gate: an empty cache must cost nothing on get_instance_types."""
        if not self._until:
            return False
        now = self._clock.now()
        expired = [k for k, t in self._until.items() if now >= t]
        for k in expired:
            del self._until[k]
        return bool(self._until)

    def __len__(self) -> int:
        self.active()  # sweep expired
        return len(self._until)


def mask_unavailable_offerings(instance_types, ice: "InsufficientCapacityCache"):
    """Copies of ``instance_types`` with ICE-cached offerings flagged
    unavailable; types untouched by the cache are returned by reference
    (the common case costs one membership scan, no copies)."""
    from dataclasses import replace

    out = []
    for it in instance_types:
        hit = any(
            o.available
            and ice.is_unavailable(it.name, o.zone(), o.capacity_type())
            for o in it.offerings
        )
        if not hit:
            out.append(it)
            continue
        offerings = [
            replace(o, available=False)
            if o.available
            and ice.is_unavailable(it.name, o.zone(), o.capacity_type())
            else o
            for o in it.offerings
        ]
        # _allocatable is a memoized cache keyed to capacity, which is
        # unchanged; carrying it over avoids re-deriving per call
        out.append(replace(it, offerings=offerings))
    return out


__all__ = ["InsufficientCapacityCache", "mask_unavailable_offerings", "DEFAULT_TTL"]
