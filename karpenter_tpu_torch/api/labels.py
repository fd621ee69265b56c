# Copied from karpenter_tpu/api/labels.py.
"""Well-known labels, taint keys, and label-domain policy.

Mirror of the reference's pkg/apis/v1/labels.go and taints.go. The framework's
own group is ``karpenter.tpu`` (the reference uses ``karpenter.sh``); the
kubernetes well-known label names are identical because pods reference them.
"""

from __future__ import annotations

from typing import Optional

GROUP = "karpenter.tpu"

# kubernetes well-known labels
TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
TOPOLOGY_REGION = "topology.kubernetes.io/region"
INSTANCE_TYPE = "node.kubernetes.io/instance-type"
ARCH = "kubernetes.io/arch"
OS = "kubernetes.io/os"
HOSTNAME = "kubernetes.io/hostname"
WINDOWS_BUILD = "node.kubernetes.io/windows-build"

ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"

# capacity types (reference: labels.go:31-37)
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"

# framework-specific labels (reference: labels.go:40-45)
NODEPOOL_LABEL_KEY = f"{GROUP}/nodepool"
NODE_INITIALIZED_LABEL_KEY = f"{GROUP}/initialized"
NODE_REGISTERED_LABEL_KEY = f"{GROUP}/registered"
CAPACITY_TYPE_LABEL_KEY = f"{GROUP}/capacity-type"

# annotations (reference: labels.go:48-54)
DO_NOT_DISRUPT_ANNOTATION_KEY = f"{GROUP}/do-not-disrupt"
NODEPOOL_HASH_ANNOTATION_KEY = f"{GROUP}/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION_KEY = f"{GROUP}/nodepool-hash-version"
NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY = f"{GROUP}/nodeclaim-termination-timestamp"

# finalizers (reference: labels.go:57-59)
TERMINATION_FINALIZER = f"{GROUP}/termination"

# taints (reference: taints.go:32-40)
DISRUPTED_TAINT_KEY = f"{GROUP}/disrupted"
UNREGISTERED_TAINT_KEY = f"{GROUP}/unregistered"

# WellKnownLabels: restricted-domain labels that pods/nodepools may still
# constrain (reference: labels.go:79-92). Cloud providers register their
# labels into this set — the reference's AWS provider inserts
# karpenter.k8s.aws/instance-* via apis.WellKnownLabels, and
# fake/cloudprovider.go:44 inserts the reservation-id label. This build's
# reference provider (cloudprovider/corpus.py) serves the instance
# family/size/cpu/memory labels, so they are registered here: pods and
# pools may constrain them, and the compat algebra treats them as
# allow-undefined (a claim that doesn't pin them can still host the pod —
# instance-type filtering resolves the constraint).
RESERVATION_ID_LABEL = f"{GROUP}/reservation-id"
INSTANCE_FAMILY_LABEL = f"{GROUP}/instance-family"
INSTANCE_SIZE_LABEL = f"{GROUP}/instance-size"
INSTANCE_CPU_LABEL = f"{GROUP}/instance-cpu"
INSTANCE_MEMORY_LABEL = f"{GROUP}/instance-memory"
WELL_KNOWN_LABELS = frozenset(
    {
        NODEPOOL_LABEL_KEY,
        TOPOLOGY_ZONE,
        TOPOLOGY_REGION,
        INSTANCE_TYPE,
        ARCH,
        OS,
        CAPACITY_TYPE_LABEL_KEY,
        WINDOWS_BUILD,
        RESERVATION_ID_LABEL,
        INSTANCE_FAMILY_LABEL,
        INSTANCE_SIZE_LABEL,
        INSTANCE_CPU_LABEL,
        INSTANCE_MEMORY_LABEL,
    }
)

# Restricted domains: kubelet-reserved or framework-reserved (labels.go:63-67)
RESTRICTED_LABEL_DOMAINS = ("kubernetes.io", "k8s.io", GROUP)
LABEL_DOMAIN_EXCEPTIONS = (
    "kops.k8s.io",
    "node.kubernetes.io",
    "node-restriction.kubernetes.io",
)

# Labels that must never appear in requirements (labels.go:94-97)
RESTRICTED_LABELS = frozenset({HOSTNAME})

# Alias translation applied when constructing requirements (labels.go:99-107)
NORMALIZED_LABELS = {
    "failure-domain.beta.kubernetes.io/zone": TOPOLOGY_ZONE,
    "beta.kubernetes.io/arch": ARCH,
    "beta.kubernetes.io/os": OS,
    "beta.kubernetes.io/instance-type": INSTANCE_TYPE,
    "failure-domain.beta.kubernetes.io/region": TOPOLOGY_REGION,
}


def normalize(key: str) -> str:
    return NORMALIZED_LABELS.get(key, key)


def get_label_domain(key: str) -> str:
    """Prefix before '/', or empty for unprefixed keys (labels.go:140-145)."""
    if "/" in key:
        return key.split("/", 1)[0]
    return ""


def is_restricted_node_label(key: str) -> bool:
    """True if the framework must not inject this label onto nodes: well-known
    labels (cloud-provider-owned) and restricted domains
    (reference: labels.go:120-138).
    """
    if key in WELL_KNOWN_LABELS:
        return True
    domain = get_label_domain(key)
    for exc in LABEL_DOMAIN_EXCEPTIONS:
        if domain.endswith(exc):
            return False
    for restricted in RESTRICTED_LABEL_DOMAINS:
        if domain.endswith(restricted):
            return True
    return key in RESTRICTED_LABELS


def is_restricted_label(key: str) -> Optional[str]:
    """Error string if the label may not be used in requirements at all
    (reference: labels.go:109-118). Well-known labels (including
    provider-registered instance labels) are always allowed.
    """
    if key in WELL_KNOWN_LABELS:
        return None
    if is_restricted_node_label(key):
        return f"label {key} is restricted; specify a well known label or an unrestricted custom label"
    return None
