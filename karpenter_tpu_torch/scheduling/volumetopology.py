# Copied from karpenter_tpu/scheduling/volumetopology.py.
"""PVC zone-topology injection, run before scheduling.

Mirror of the reference's
pkg/controllers/provisioning/scheduling/volumetopology.go: pods that
reference zonal volumes (bound PVs with zone affinity, or StorageClasses
with allowed zonal topologies) must land in those zones, so the injector
rewrites the pod's required node affinity to include the zone requirement
(volumetopology.go:42-78). validate_persistent_volume_claims rejects pods
whose PVCs or StorageClasses don't exist (volumetopology.go:152-199).

Resolution itself (PVC -> PV/StorageClass walk) is shared with the
attach-limit accounting via VolumeResolver (volumeusage.py).
"""

from __future__ import annotations

from typing import List, Optional

from ..api import labels as labels_mod
from ..api.objects import NodeAffinity, NodeSelectorRequirement, Pod
from .volumeusage import VolumeResolver


class VolumeTopology:
    def __init__(self, client):
        self.resolver = VolumeResolver(client)

    # -- injection (volumetopology.go:42-78) ------------------------------

    def inject(self, pod: Pod) -> None:
        """Add zonal volume requirements to the pod's required node
        affinity. Mutates the (already deep-copied) scheduling pod."""
        resolved, _ = self.resolver.resolve(pod)
        requirements: List[NodeSelectorRequirement] = [
            NodeSelectorRequirement(labels_mod.TOPOLOGY_ZONE, "In", tuple(r.zones))
            for r in resolved
            if r.zones
        ]
        if not requirements:
            return
        if pod.spec.node_affinity is None:
            pod.spec.node_affinity = NodeAffinity()
        affinity = pod.spec.node_affinity
        if affinity.required:
            # zone requirements apply to every OR-term (volumetopology.go:66-73)
            affinity.required = [
                tuple(term) + tuple(requirements) for term in affinity.required
            ]
        else:
            affinity.required = [tuple(requirements)]

    # -- validation (volumetopology.go:152-199) ----------------------------

    def validate_persistent_volume_claims(self, pod: Pod) -> Optional[str]:
        """Error if any referenced PVC (or an unbound PVC's StorageClass)
        doesn't exist; such pods are ignored by provisioning."""
        _, err = self.resolver.resolve(pod, strict=True)
        return err
