# Copied from karpenter_tpu/api/taints.py.
"""Taint / toleration matching (reference: pkg/scheduling/taints.go)."""

from __future__ import annotations

from typing import List, Optional, Sequence

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

TAINT_NODE_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_NODE_UNREACHABLE = "node.kubernetes.io/unreachable"
TAINT_EXTERNAL_CLOUD_PROVIDER = "node.cloudprovider.kubernetes.io/uninitialized"


def tolerates_taint(toleration, taint) -> bool:
    """corev1.Toleration.ToleratesTaint semantics.

    Empty effect on the toleration matches all effects; empty key with
    operator Exists matches all taints; operator defaults to Equal.
    """
    if toleration.effect and toleration.effect != taint.effect:
        return False
    if toleration.key and toleration.key != taint.key:
        return False
    op = toleration.operator or "Equal"
    if op == "Exists":
        # upstream ToleratesTaint matches unconditionally; API validation
        # separately forbids a value with Exists
        return True
    if op == "Equal":
        return (toleration.value or "") == (taint.value or "")
    return False


def tolerates(taints: Sequence, tolerations: Sequence) -> Optional[str]:
    """All taints must be tolerated (reference: taints.go:50-64).

    Returns an error string naming the first untolerated taints, or None.
    """
    errs = []
    for taint in taints:
        if not any(tolerates_taint(t, taint) for t in tolerations):
            errs.append(f"did not tolerate {taint.key}={taint.value}:{taint.effect}")
    return "; ".join(errs) if errs else None


def tolerates_pod(taints: Sequence, pod) -> Optional[str]:
    return tolerates(taints, pod.spec.tolerations or [])


def match_taint(a, b) -> bool:
    """Taints are identified by (key, effect) (corev1 Taint.MatchTaint)."""
    return a.key == b.key and a.effect == b.effect


def merge(taints: Sequence, with_taints: Sequence) -> List:
    """Union keeping the first occurrence per (key, effect) (taints.go:66-80)."""
    out = list(taints)
    for taint in with_taints:
        if not any(match_taint(taint, t) for t in out):
            out.append(taint)
    return out


def is_ephemeral(taint) -> bool:
    """Taints expected to disappear during node initialization
    (reference: taints.go:35-41)."""
    from . import labels

    if taint.effect == NO_SCHEDULE and taint.key in (
        TAINT_NODE_NOT_READY,
        TAINT_NODE_UNREACHABLE,
        TAINT_EXTERNAL_CLOUD_PROVIDER,
    ):
        return True
    return taint.key == labels.UNREGISTERED_TAINT_KEY and taint.effect == NO_EXECUTE
