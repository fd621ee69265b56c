# Copied from karpenter_tpu/solver/wire.py.
"""Wire codec for the solver service boundary.

The reference has no RPC seam — its scheduler is in-process — but the
TPU-native design places the batch solver in a sidecar reached over the
datacenter network (SURVEY.md §5 "Distributed communication backend"): the
controller ships a pod/instance-type snapshot, the sidecar returns packed
NodeClaims. This module is the snapshot codec: a tagged, msgpack-encoded
tree over the API dataclasses, plus explicit codecs for the slotted
Requirement/Requirements set-algebra types.

Objects are serialized structurally ("__t" type tags), so the format is
self-describing and language-neutral (any peer that can emit the same tags
can drive the solver).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional

import msgpack

from .. import obs
from ..api import objects as obj
from ..api import resources as res
from ..api.requirements import Requirement, Requirements
from ..cloudprovider import types as cp

# Every dataclass that may appear in a snapshot. Reconstruction looks the
# class up by tag and calls it with decoded fields.
_CLASSES = {
    cls.__name__: cls
    for cls in (
        obj.ObjectMeta,
        obj.Taint,
        obj.Toleration,
        obj.NodeSelectorRequirement,
        obj.PreferredSchedulingTerm,
        obj.NodeAffinity,
        obj.LabelSelector,
        obj.LabelSelectorRequirement,
        obj.PodAffinityTerm,
        obj.WeightedPodAffinityTerm,
        obj.TopologySpreadConstraint,
        obj.HostPort,
        obj.PersistentVolumeClaimRef,
        obj.PodSpec,
        obj.PodCondition,
        obj.PodStatus,
        obj.Pod,
        obj.NodeClassRef,
        obj.NodeClaimSpec,
        obj.NodeClaimTemplate,
        obj.Budget,
        obj.Disruption,
        obj.NodePoolSpec,
        obj.NodePoolStatus,
        obj.NodePool,
        obj.DaemonSet,
        obj.Node,
        obj.NodeStatus,
        obj.NodeClaim,
        obj.NodeClaimStatus,
        obj.Condition,
        obj.PersistentVolumeClaim,
        obj.PersistentVolume,
        obj.StorageClass,
        cp.Offering,
        cp.InstanceTypeOverhead,
        cp.InstanceType,
    )
}


def to_wire(value: Any) -> Any:
    """Recursively convert an API object tree to msgpack-able primitives."""
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, Requirement):
        return {
            "__t": "Requirement",
            "key": value.key,
            "complement": value.complement,
            "values": sorted(value.values),
            "greater_than": value.greater_than,
            "less_than": value.less_than,
            "min_values": value.min_values,
        }
    if isinstance(value, Requirements):
        return {"__t": "Requirements", "items": [to_wire(r) for r in value]}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out: Dict[str, Any] = {"__t": type(value).__name__}
        for f in dataclasses.fields(value):
            if f.name.startswith("_"):
                continue  # memoized/private fields are rebuilt on the far side
            out[f.name] = to_wire(getattr(value, f.name))
        return out
    if isinstance(value, dict):
        return {k: to_wire(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [to_wire(v) for v in value]
    raise TypeError(f"cannot serialize {type(value).__name__} for the wire")


def from_wire(value: Any) -> Any:
    """Inverse of to_wire."""
    if isinstance(value, dict):
        tag = value.get("__t")
        if tag == "Requirement":
            return Requirement._raw(
                key=value["key"],
                complement=value["complement"],
                values=set(value["values"]),
                greater_than=value["greater_than"],
                less_than=value["less_than"],
                min_values=value["min_values"],
            )
        if tag == "Requirements":
            return Requirements(*(from_wire(r) for r in value["items"]))
        if tag is not None:
            cls = _CLASSES.get(tag)
            if cls is None:
                raise TypeError(f"unknown wire tag {tag!r}")
            fields = {
                k: from_wire(v) for k, v in value.items() if k != "__t"
            }
            return cls(**fields)
        return {k: from_wire(v) for k, v in value.items()}
    if isinstance(value, list):
        return [from_wire(v) for v in value]
    return value


# -- state-node snapshots ---------------------------------------------------


def encode_state_node(sn) -> Dict[str, Any]:
    """StateNode → wire: the merged Node/NodeClaim objects, the node's bound
    pods (with which of them are daemons), and the usage surfaces the
    scheduler's ExistingNode model reads. The sidecar reconstructs a
    StateNode that answers labels()/taints()/available()/hostport_usage
    identically, so existing-capacity packing matches the controller's
    in-process solve (scheduler.go:357-425 packs existing nodes FIRST)."""
    return {
        "node": to_wire(sn.node),
        "node_claim": to_wire(sn.node_claim),
        "pods": [to_wire(p) for p in sn.pods],
        "daemon_uids": sorted(sn.daemonset_requests),
        "volume_limits": dict(sn.volume_limits),
        "volume_usage": sn.volume_usage.snapshot(),
        "mark_for_deletion": bool(sn.mark_for_deletion),
        "nominated_until": float(sn.nominated_until),
    }


def decode_state_node(raw: Dict[str, Any]):
    from ..controllers.state import StateNode

    sn = StateNode(
        node=from_wire(raw["node"]), node_claim=from_wire(raw["node_claim"])
    )
    from ..scheduling.volumeusage import VolumeUsage

    sn.volume_limits = dict(raw.get("volume_limits") or {})
    sn.volume_usage = VolumeUsage.from_snapshot(raw.get("volume_usage"))
    sn.mark_for_deletion = raw.get("mark_for_deletion", False)
    sn.nominated_until = raw.get("nominated_until", 0.0)
    daemons = set(raw.get("daemon_uids", ()))
    for p in (from_wire(x) for x in raw.get("pods", [])):
        sn.update_pod(p, is_daemon=p.uid in daemons)
    return sn


# -- snapshot / result envelopes -------------------------------------------


def encode_solve_request(
    pods,
    node_pools,
    instance_types: Dict[str, List[cp.InstanceType]],
    daemonset_pods=(),
    solver_options: Optional[Dict[str, Any]] = None,
    state_nodes=(),
    volume_objects=(),
) -> bytes:
    """solver_options carries behavior knobs (feature gates) that must match
    between controller and sidecar — e.g. reserved_capacity_enabled.
    ``volume_objects`` are the PVC/PV/StorageClass objects pending pods
    reference, so the sidecar's VolumeResolver answers identically to the
    controller's (volumeusage.go resolveDriver/VolumeName)."""
    with obs.span("wire.encode_request", pods=len(pods)):
        return msgpack.packb(
            {
                "pods": [to_wire(p) for p in pods],
                "node_pools": [to_wire(np_) for np_ in node_pools],
                "instance_types": {
                    pool: [to_wire(it) for it in its]
                    for pool, its in instance_types.items()
                },
                "daemonset_pods": [to_wire(p) for p in daemonset_pods],
                "solver_options": dict(solver_options or {}),
                "state_nodes": [encode_state_node(sn) for sn in state_nodes],
                "volume_objects": [to_wire(o) for o in volume_objects],
            },
            use_bin_type=True,
        )


def decode_solve_request(data: bytes) -> Dict[str, Any]:
    with obs.span("wire.decode_request", bytes=len(data)):
        return _decode_solve_request(data)


def _decode_solve_request(data: bytes) -> Dict[str, Any]:
    raw = msgpack.unpackb(data, raw=False)
    return {
        "pods": [from_wire(p) for p in raw["pods"]],
        "node_pools": [from_wire(np_) for np_ in raw["node_pools"]],
        "instance_types": {
            pool: [from_wire(it) for it in its]
            for pool, its in raw["instance_types"].items()
        },
        "daemonset_pods": [from_wire(p) for p in raw.get("daemonset_pods", [])],
        "solver_options": raw.get("solver_options", {}),
        "state_nodes": [
            decode_state_node(sn) for sn in raw.get("state_nodes", [])
        ],
        # None (vs []) marks a client that predates the volume protocol;
        # the sidecar then skips PVC resolution rather than failing every
        # PVC-bearing pod with "not found" against its empty scratch store
        "volume_objects": (
            [from_wire(o) for o in raw["volume_objects"]]
            if "volume_objects" in raw
            else None
        ),
    }


def encode_solve_response(results, state_nodes_packed: int = 0) -> bytes:
    """Results → wire. Claims reference instance types by name and pods by
    uid; the caller reassembles against its own objects. Existing-node
    placements travel as (node name, newly placed pod uids);
    ``state_nodes_packed`` acknowledges how many shipped state nodes the
    solve actually packed against, so a client that sent state nodes can
    fail fast against a sidecar that silently dropped them."""
    claims = []
    for claim in results.new_node_claims:
        claims.append(
            {
                "pool": claim.template.node_pool_name,
                "instance_types": [it.name for it in claim.instance_type_options],
                "pod_uids": [p.uid for p in claim.pods],
                "requirements": to_wire(claim.requirements),
            }
        )
    existing = [
        {"name": en.name, "pod_uids": [p.uid for p in en.pods]}
        for en in results.existing_nodes
    ]
    return msgpack.packb(
        {
            "claims": claims,
            "existing": existing,
            "state_nodes_packed": int(state_nodes_packed),
            "pod_errors": {uid: str(err) for uid, err in results.pod_errors.items()},
        },
        use_bin_type=True,
    )


def decode_solve_response(data: bytes) -> Dict[str, Any]:
    raw = msgpack.unpackb(data, raw=False)
    for claim in raw["claims"]:
        claim["requirements"] = from_wire(claim["requirements"])
    return raw


__all__ = [
    "to_wire",
    "from_wire",
    "encode_solve_request",
    "decode_solve_request",
    "encode_solve_response",
    "decode_solve_response",
]
