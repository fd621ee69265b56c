# Copied from karpenter_tpu/controllers/nodeclaim_disruption.py.
"""NodeClaim Consolidatable/Drifted condition management.

Mirror of pkg/controllers/nodeclaim/disruption: Consolidatable flips once
consolidateAfter has elapsed since the last pod event
(disruption/consolidation.go:38-79); Drifted tracks static-hash drift,
requirement drift, instance-type disappearance, and provider-reported drift
(disruption/drift.go:41-165).
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

from ..api import labels as labels_mod
from ..api.objects import (
    COND_CONSOLIDATABLE,
    COND_DRIFTED,
    COND_INITIALIZED,
    NodeClaim,
    NodePool,
)
from ..api.requirements import Requirements
from ..kube import Client, NotFoundError

DRIFT_RECHECK = 300.0  # 5-min provider re-check


def nodepool_hash(pool: NodePool) -> str:
    """Static-field hash for drift detection (nodepool.go:271-283)."""
    template = pool.spec.template
    payload = {
        "labels": sorted(template.labels.items()),
        "annotations": sorted(template.annotations.items()),
        "taints": sorted(
            (t.key, t.value, t.effect) for t in template.spec.taints
        ),
        "startup_taints": sorted(
            (t.key, t.value, t.effect) for t in template.spec.startup_taints
        ),
        "expire_after": template.spec.expire_after,
        "termination_grace_period": template.spec.termination_grace_period,
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def stamp_nodepool_hash(claim, pool) -> None:
    """Stamp the pool's static-field hash onto a claim at creation, feeding
    drift detection and registration health (hash/controller.go:39-124)."""
    if pool is not None:
        claim.metadata.annotations[labels_mod.NODEPOOL_HASH_ANNOTATION_KEY] = (
            nodepool_hash(pool)
        )


def materialize_claim(client, claim_model, pools):
    """Turn a scheduler claim model into a created NodeClaim CR: price-
    truncated instance types, termination finalizer, nodepool-hash stamp.
    Shared by provisioning and disruption replacement launches."""
    claim = claim_model.template.to_node_claim(
        instance_type_options=claim_model.instance_type_options,
        requirements=claim_model.requirements,
    )
    claim.metadata.finalizers.append(labels_mod.TERMINATION_FINALIZER)
    stamp_nodepool_hash(claim, pools.get(claim_model.template.node_pool_name))
    client.create(claim)
    return claim


class NodeClaimDisruptionController:
    def __init__(self, client: Client, cloud_provider):
        self.client = client
        self.cloud_provider = cloud_provider
        self.clock = client.clock
        self._last_provider_check: dict = {}

    def reconcile_all(self) -> None:
        for claim in self.client.list(NodeClaim):
            if claim.metadata.deletion_timestamp is None:
                self.reconcile(claim)

    def reconcile(self, claim: NodeClaim) -> None:
        pool = self.client.try_get(NodePool, claim.nodepool_name)
        if pool is None:
            return
        self._consolidatable(claim, pool)
        self._drifted(claim, pool)
        try:
            self.client.update_status(claim)
        except NotFoundError:
            pass  # finalized concurrently; conditions are moot

    # -- Consolidatable (disruption/consolidation.go:38-79) ---------------

    def _consolidatable(self, claim: NodeClaim, pool: NodePool) -> None:
        conds = claim.conds()
        after = pool.spec.disruption.consolidate_after
        if after is None:  # Never
            conds.clear(COND_CONSOLIDATABLE)
            return
        if not conds.is_true(COND_INITIALIZED):
            return
        last_event = claim.status.last_pod_event_time or claim.metadata.creation_timestamp
        if self.clock.now() - last_event >= after:
            conds.set(COND_CONSOLIDATABLE, "True", now=self.clock.now())
        else:
            conds.clear(COND_CONSOLIDATABLE)

    # -- Drifted (disruption/drift.go:41-165) ------------------------------

    def _drifted(self, claim: NodeClaim, pool: NodePool) -> None:
        conds = claim.conds()
        if not claim.conds().is_true(COND_INITIALIZED):
            return
        reason = self._drift_reason(claim, pool)
        if reason:
            conds.set(COND_DRIFTED, "True", reason, now=self.clock.now())
        else:
            conds.clear(COND_DRIFTED)

    def _drift_reason(self, claim: NodeClaim, pool: NodePool) -> Optional[str]:
        # static-hash drift
        claim_hash = claim.metadata.annotations.get(labels_mod.NODEPOOL_HASH_ANNOTATION_KEY)
        if claim_hash is not None and claim_hash != nodepool_hash(pool):
            return "NodePoolDrifted"
        # requirement drift: the claim's labels must satisfy pool requirements
        pool_reqs = Requirements(
            *(r.to_requirement() for r in pool.spec.template.spec.requirements)
        )
        claim_labels = Requirements.from_labels(claim.metadata.labels)
        if claim_labels.intersects(pool_reqs) is not None:
            return "RequirementsDrifted"
        # instance type no longer offered
        it_name = claim.metadata.labels.get(labels_mod.INSTANCE_TYPE)
        if it_name is not None:
            names = {it.name for it in self.cloud_provider.get_instance_types(pool)}
            if it_name not in names:
                return "InstanceTypeNotFound"
        # provider-reported drift, re-checked every 5 min
        last = self._last_provider_check.get(claim.uid, -DRIFT_RECHECK)
        if self.clock.now() - last >= DRIFT_RECHECK:
            self._last_provider_check[claim.uid] = self.clock.now()
            provider_reason = self.cloud_provider.is_drifted(claim)
            if provider_reason:
                return provider_reason
        return None


class PodEventsController:
    """Stamps status.lastPodEventTime on bind/unbind
    (podevents/controller.go:42-119) — feeds consolidateAfter."""

    def __init__(self, client: Client):
        self.client = client
        client.watch(self._on_event)

    def _on_event(self, event) -> None:
        if event.kind != "Pod":
            return
        pod = event.object
        node_name = pod.spec.node_name
        if not node_name:
            return
        from ..api.objects import Node

        node = self.client.try_get(Node, node_name)
        if node is None:
            return
        for claim in self.client.list(NodeClaim):
            if claim.status.provider_id == node.provider_id:
                claim.status.last_pod_event_time = self.client.clock.now()
                return
