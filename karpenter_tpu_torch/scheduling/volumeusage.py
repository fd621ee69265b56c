# Copied from karpenter_tpu/scheduling/volumeusage.py.
"""Per-node volume-attachment tracking against CSI driver limits.

Mirror of the reference's pkg/scheduling/volumeusage.go: each node tracks
which unique volumes (per CSI driver) are attached; adding a pod may not push
any driver past its CSINode attach limit. The scheduler consults this from
ExistingNode.Add (existingnode.go volume-limit check); new in-flight claims
have no CSINode yet, so limits only apply to existing nodes — same as the
reference.

VolumeResolver is the single PVC -> PV / StorageClass resolution walk, shared
by attach-limit accounting (driver + volume id) and zonal topology injection
(zones) — volumetopology.py consumes the same ResolvedVolume records.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Set, Tuple

from ..api.objects import (
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)
from ..kube.store import NotFoundError


class ResolvedVolume(NamedTuple):
    driver: str  # CSI driver ("" when unresolvable: uncounted)
    volume_id: str  # PV name when bound, else ns/claim
    zones: Tuple[str, ...]  # zonal constraint from the PV or StorageClass


class VolumeResolver:
    """Resolves a pod's PVC references to (csi driver, volume id, zones).

    Bound PVCs resolve through their PersistentVolume (volume name is the
    identity); unbound PVCs resolve through their StorageClass provisioner
    with the claim itself as identity (reference: volumeusage.go
    resolveDriver/VolumeName + volumetopology.go getPersistentVolumeTopology).
    PVCs are namespaced; PVs and StorageClasses are cluster-scoped."""

    def __init__(self, client):
        self.client = client

    def resolve(
        self, pod: Pod, strict: bool = False
    ) -> Tuple[List[ResolvedVolume], Optional[str]]:
        """Returns ([ResolvedVolume], error). A missing PVC is always an
        error; with ``strict`` a missing StorageClass on an unbound PVC is
        too (volumetopology.go:152-199's validation), otherwise the volume
        resolves driverless and uncounted (tolerant of in-tree volumes)."""
        out: List[ResolvedVolume] = []
        ns = getattr(pod.metadata, "namespace", "default")
        for ref in pod.spec.volumes:
            try:
                pvc = self.client.get(PersistentVolumeClaim, ref.claim_name, ns)
            except NotFoundError:
                return [], f"persistentvolumeclaim {ref.claim_name!r} not found"
            driver = ""
            volume_id = f"{ns}/{ref.claim_name}"
            zones: Tuple[str, ...] = ()
            if pvc.volume_name:
                pv = self.client.try_get(PersistentVolume, pvc.volume_name)
                if pv is not None:
                    driver = pv.driver
                    volume_id = pvc.volume_name
                    zones = pv.zones
            elif pvc.storage_class_name:
                sc = self.client.try_get(StorageClass, pvc.storage_class_name)
                if sc is None:
                    if strict:
                        return [], (
                            f"storageclass {pvc.storage_class_name!r} for claim"
                            f" {ref.claim_name!r} not found"
                        )
                else:
                    driver = sc.provisioner
                    zones = sc.zones
            if driver:
                out.append(ResolvedVolume(driver, volume_id, zones))
            elif zones:
                out.append(ResolvedVolume("", volume_id, zones))
        return out, None


class VolumeUsage:
    """Tracks unique volumes per CSI driver attached to one node."""

    def __init__(self):
        self._volumes: Dict[str, Set[str]] = {}  # driver -> volume ids
        self._pod_volumes: Dict[str, List[Tuple[str, str]]] = {}  # pod uid

    def add(self, pod: Pod, resolved: Sequence) -> None:
        # retract a previous resolution first: a PVC binding changes its
        # volume identity from ns/claim to the PV name
        if pod.uid in self._pod_volumes:
            self.delete_pod(pod.uid)
        counted = [(r[0], r[1]) for r in resolved if r[0]]
        self._pod_volumes[pod.uid] = counted
        for driver, vid in counted:
            self._volumes.setdefault(driver, set()).add(vid)

    def delete_pod(self, uid: str) -> None:
        resolved = self._pod_volumes.pop(uid, ())
        for driver, vid in resolved:
            vols = self._volumes.get(driver)
            if vols is None:
                continue
            # only drop the volume if no remaining pod references it
            if not any(
                (driver, vid) in other for other in self._pod_volumes.values()
            ):
                vols.discard(vid)

    def snapshot(self) -> Dict[str, List[Tuple[str, str]]]:
        """Wire-portable form: pod uid -> [(driver, volume id)]. The
        per-driver volume sets are derivable, so only the pod map ships."""
        return {uid: list(pairs) for uid, pairs in self._pod_volumes.items()}

    @classmethod
    def from_snapshot(cls, snap) -> "VolumeUsage":
        vu = cls()
        for uid, pairs in (snap or {}).items():
            counted = [(d, v) for d, v in pairs]
            vu._pod_volumes[uid] = counted
            for d, v in counted:
                if d:
                    vu._volumes.setdefault(d, set()).add(v)
        return vu

    def has(self, driver: str, volume_id: str) -> bool:
        """True when the volume is already attached to this node (the
        solver's dense attach-slot ledger routes such pods host-side:
        per-node dedup can't be expressed as a uniform request)."""
        return volume_id in self._volumes.get(driver, ())

    def attached(self) -> Iterable[Tuple[str, str]]:
        """Every (driver, volume id) currently attached — the solver's
        batch-admission precomputation."""
        for driver, vols in self._volumes.items():
            for vid in vols:
                yield (driver, vid)

    def attached_count(self, driver: str) -> int:
        """Distinct volumes attached for one driver (the encoder's
        remaining-attach-slot column derives from this)."""
        return len(self._volumes.get(driver, ()))

    def attached_counts(self) -> Dict[str, int]:
        """Per-driver distinct-volume counts (delta-tag content)."""
        return {d: len(v) for d, v in self._volumes.items()}

    def validate(self, resolved: Sequence, limits: Dict[str, int]) -> Optional[str]:
        """Error string if adding ``resolved`` would exceed any driver's
        attach limit (volumeusage.go exceedsLimits)."""
        proposed: Dict[str, Set[str]] = {}
        for r in resolved:
            driver, vid = r[0], r[1]
            if not driver:
                continue
            existing = self._volumes.get(driver, set())
            if vid in existing:
                continue
            proposed.setdefault(driver, set()).add(vid)
        for driver, new in proposed.items():
            limit = limits.get(driver)
            if limit is None:
                continue
            count = len(self._volumes.get(driver, set())) + len(new)
            if count > limit:
                return (
                    f"would exceed csi driver {driver!r} volume limit"
                    f" ({count} > {limit})"
                )
        return None

    def copy(self) -> "VolumeUsage":
        out = VolumeUsage()
        out._volumes = {d: set(v) for d, v in self._volumes.items()}
        out._pod_volumes = {u: list(v) for u, v in self._pod_volumes.items()}
        return out
