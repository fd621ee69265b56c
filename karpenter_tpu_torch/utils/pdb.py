# Copied from karpenter_tpu/utils/pdb.py.
"""PodDisruptionBudget limits (reference: pkg/utils/pdb/limits.go).

The kube disruption controller normally maintains
``status.disruptionsAllowed``; in-process there is no such controller, so
Limits derives the allowance from ``min_available`` / ``max_unavailable``
over the PDB's matching pods (the way k8s's disruption controller computes
it), simulates multi-pod evictions, and decrements as evictions happen —
the role the eviction API's 429 bookkeeping plays against a real apiserver.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..api.objects import Pod, PodDisruptionBudget
from . import pod as pod_utils


def _parse_int_or_percent(value: str, total: int, round_up: bool) -> int:
    value = str(value)
    if value.endswith("%"):
        pct = int(value[:-1])
        raw = total * pct / 100.0
        return -int(-raw // 1) if round_up else int(raw)
    return int(value)


class Limits:
    """Evictability check across all PDBs in the cluster."""

    def __init__(self, pdbs: List[PodDisruptionBudget], pods: Sequence[Pod] = ()):
        self._pdbs = pdbs
        self._remaining: Dict[Tuple[str, str], int] = {
            self._key(pdb): self._compute_allowed(pdb, pods) for pdb in pdbs
        }

    @classmethod
    def from_client(cls, client) -> "Limits":
        return cls(client.list(PodDisruptionBudget), client.list(Pod))

    @staticmethod
    def _key(pdb: PodDisruptionBudget) -> Tuple[str, str]:
        return (pdb.metadata.namespace, pdb.metadata.name)

    def _compute_allowed(self, pdb: PodDisruptionBudget, pods: Sequence[Pod]) -> int:
        matching = [
            p
            for p in pods
            if p.metadata.namespace == pdb.metadata.namespace
            and pdb.selector.matches(p.metadata.labels)
            and pod_utils.is_active(p)
        ]
        expected = pdb.expected_pods or len(matching)
        healthy = len([p for p in matching if p.spec.node_name])
        if pdb.min_available is not None:
            desired = _parse_int_or_percent(pdb.min_available, expected, round_up=True)
            return max(0, healthy - desired)
        if pdb.max_unavailable is not None:
            max_unavail = _parse_int_or_percent(
                pdb.max_unavailable, expected, round_up=True
            )
            unhealthy = max(0, expected - healthy)
            return max(0, max_unavail - unhealthy)
        # neither field set (invalid in k8s): honor an explicit status value
        return pdb.disruptions_allowed

    def allowed(self, pdb: PodDisruptionBudget) -> int:
        return self._remaining.get(self._key(pdb), 0)

    def matching(self, pod: Pod) -> List[PodDisruptionBudget]:
        return [
            pdb
            for pdb in self._pdbs
            if pdb.metadata.namespace == pod.metadata.namespace
            and pdb.selector.matches(pod.metadata.labels)
        ]

    def can_evict_pods(self, pods: List[Pod]) -> Optional[str]:
        """Error if evicting ALL the pods together would violate a PDB; also
        flags pods covered by multiple PDBs (the eviction API refuses
        those). Simulates against the current remaining allowance without
        consuming it."""
        remaining = dict(self._remaining)
        for pod in pods:
            matching = self.matching(pod)
            if len(matching) > 1:
                return (
                    f"pod {pod.metadata.namespace}/{pod.name} matches multiple PDBs"
                )
            if matching:
                pdb = matching[0]
                key = self._key(pdb)
                if remaining.get(key, 0) <= 0:
                    return (
                        f"PDB {pdb.metadata.namespace}/{pdb.metadata.name} "
                        f"prevents eviction of pod {pod.name}"
                    )
                remaining[key] -= 1
        return None

    def record_eviction(self, pod: Pod) -> None:
        """Consume allowance for an eviction that actually happened."""
        for pdb in self.matching(pod):
            key = self._key(pdb)
            self._remaining[key] = self._remaining.get(key, 0) - 1
