# Copied from karpenter_tpu/utils/pod.py.
"""Pod classification helpers (reference: pkg/utils/pod/scheduling.go)."""

from __future__ import annotations

from ..api import labels as labels_mod
from ..api.objects import Pod


def is_terminal(pod: Pod) -> bool:
    return pod.status.phase in ("Succeeded", "Failed")


def is_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_scheduled(pod: Pod) -> bool:
    return bool(pod.spec.node_name)


def is_preempting(pod: Pod) -> bool:
    return bool(pod.status.nominated_node_name)


def is_owned_by_daemonset(pod: Pod, daemonset_uids) -> bool:
    return any(uid in daemonset_uids for uid in pod.metadata.owner_uids)


def is_provisionable(pod: Pod) -> bool:
    """Unschedulable pending pods the provisioner should act on."""
    return (
        not is_scheduled(pod)
        and not is_preempting(pod)
        and not is_terminal(pod)
        and not is_terminating(pod)
        and pod.status.phase == "Pending"
    )


def is_reschedulable(pod: Pod) -> bool:
    """Pods that must be able to land elsewhere when a node is disrupted."""
    return not is_terminal(pod) and not is_terminating(pod) and not is_owned_by_node(pod)


def is_owned_by_node(pod: Pod) -> bool:
    # static/mirror pods: owner is the node itself; approximated by annotation
    return pod.metadata.annotations.get("kubernetes.io/config.source") == "file"


def is_disruptable(pod: Pod) -> bool:
    return pod.metadata.annotations.get(labels_mod.DO_NOT_DISRUPT_ANNOTATION_KEY) != "true"


def is_active(pod: Pod) -> bool:
    return not is_terminal(pod) and not is_terminating(pod)
