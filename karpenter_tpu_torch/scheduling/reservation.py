# Copied from karpenter_tpu/scheduling/reservation.py.
"""Reserved-capacity ledger (reference: reservationmanager.go:28-85)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Set

from ..api import labels as labels_mod
from ..cloudprovider.types import Offering


class ReservationManager:
    def __init__(self, instance_types_by_pool: Dict[str, List]):
        self._capacity: Dict[str, int] = {}
        self._reservations: Dict[str, Set[str]] = {}  # hostname -> reservation ids
        for its in instance_types_by_pool.values():
            for it in its:
                for o in it.offerings:
                    if o.capacity_type() != labels_mod.CAPACITY_TYPE_RESERVED:
                        continue
                    rid = o.reservation_id()
                    # track the least capacity seen per reservation id
                    if rid not in self._capacity or self._capacity[rid] > o.reservation_capacity:
                        self._capacity[rid] = o.reservation_capacity

    def reserve(self, hostname: str, offering: Offering) -> bool:
        rid = offering.reservation_id()
        held = self._reservations.setdefault(hostname, set())
        if rid in held:
            return True  # idempotent per host
        if rid not in self._capacity:
            raise RuntimeError(f"reserving unknown reservation id {rid!r}")
        if self._capacity[rid] == 0:
            return False
        self._capacity[rid] -= 1
        held.add(rid)
        return True

    def release(self, hostname: str, *offerings: Offering) -> None:
        held = self._reservations.get(hostname)
        if not held:
            return
        for o in offerings:
            rid = o.reservation_id()
            if rid in held:
                held.discard(rid)
                self._capacity[rid] += 1
