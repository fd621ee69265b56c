# Copied from karpenter_tpu/kube/leader.py.
"""Lease-based leader election (reference: operator.go:137-141).

The reference delegates to controller-runtime's coordination/v1 Lease
machinery for active/passive HA; this is the same protocol over the
in-process store: one Lease object per election name, acquired when free or
expired, renewed while held. Non-leader operators keep their watch-fed
caches warm but skip reconciling (``Operator.step`` gates on ``is_leader``).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field

from ..api.objects import ObjectMeta
from .store import AlreadyExistsError, ConflictError


@dataclass
class Lease:
    """coordination/v1 Lease analog."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    renew_time: float = 0.0
    lease_duration_seconds: float = 15.0

    @property
    def name(self) -> str:
        return self.metadata.name


class LeaderElector:
    """Acquire-or-renew loop over a named Lease.

    ``try_acquire`` is called once per operator step: it renews when held,
    steals when the previous holder's lease expired, and reports standby
    otherwise — the lease-duration/renew-deadline shape of
    client-go's leaderelection package.
    """

    def __init__(
        self,
        client,
        name: str = "karpenter-leader-election",
        namespace: str = "kube-system",
        lease_duration: float = 15.0,
        identity: str = "",
    ):
        self._client = client
        self._name = name
        self._namespace = namespace
        self._duration = lease_duration
        self.identity = identity or f"operator-{uuid.uuid4().hex[:8]}"

    def _get(self):
        for lease in self._client.list(Lease):
            if (
                lease.metadata.name == self._name
                and lease.metadata.namespace == self._namespace
            ):
                return lease
        return None

    def try_acquire(self) -> bool:
        now = self._client.clock.now()
        lease = self._get()
        if lease is None:
            lease = Lease(
                metadata=ObjectMeta(name=self._name, namespace=self._namespace),
                holder_identity=self.identity,
                renew_time=now,
                lease_duration_seconds=self._duration,
            )
            try:
                self._client.create(lease)
                return True
            except AlreadyExistsError:
                return False  # lost the race; stand by until next step
        if lease.holder_identity == self.identity:
            lease.renew_time = now
            self._update(lease)
            return True
        if now - lease.renew_time > lease.lease_duration_seconds:
            # previous holder went dark: steal the lease
            lease.holder_identity = self.identity
            lease.renew_time = now
            return self._update(lease)
        return False

    def _update(self, lease) -> bool:
        try:
            self._client.update(lease)
            return True
        except (ConflictError, KeyError):
            return False
