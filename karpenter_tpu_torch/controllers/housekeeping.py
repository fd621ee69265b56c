# Copied from karpenter_tpu/controllers/housekeeping.py.
"""Housekeeping controllers: expiration, garbage collection, node repair,
consistency, and NodePool status.

Mirrors of pkg/controllers/nodeclaim/{expiration,garbagecollection,
consistency} (expiration/controller.go:40-107,
garbagecollection/controller.go:59-124, consistency/nodeshape.go:28),
pkg/controllers/node/health (health/controller.go:50-237), and
pkg/controllers/nodepool/{hash,counter,readiness}
(hash/controller.go:39-124, counter/controller.go).
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional

from ..api import labels as labels_mod
from ..api import validation
from ..api import resources as res
from ..api.objects import (
    COND_CONSISTENT_STATE_FOUND,
    COND_NODE_REGISTRATION_HEALTHY,
    COND_READY,
    COND_REGISTERED,
    Node,
    NodeClaim,
    NodePool,
)
from ..cloudprovider.types import CloudProviderError, NodeClaimNotFoundError
from ..events import Event, Recorder
from ..kube import Client, NotFoundError
from ..metrics import Counter
from .nodeclaim_disruption import nodepool_hash
from .state import Cluster

NODE_SHAPE_TOLERANCE = 0.90  # consistency/nodeshape.go:28
MAX_REPAIR_FRACTION = 0.20  # health/controller.go:196-198

CLAIMS_EXPIRED = Counter("nodeclaims_expired_total", "")
INSTANCES_COLLECTED = Counter("instances_garbage_collected_total", "")

_GC_LOG = logging.getLogger("karpenter_tpu.housekeeping")
NODES_REPAIRED = Counter("nodes_repaired_total", "")


class ExpirationController:
    """Forceful deletion of NodeClaims past expireAfter — no simulation
    (expiration/controller.go:40-107)."""

    def __init__(self, client: Client, recorder: Optional[Recorder] = None):
        self.client = client
        self.clock = client.clock
        self.recorder = recorder or Recorder(self.clock)

    def reconcile_all(self) -> None:
        now = self.clock.now()
        for claim in self.client.list(NodeClaim):
            if claim.metadata.deletion_timestamp is not None:
                continue
            expire_after = claim.spec.expire_after
            if expire_after is None:
                continue
            if now - claim.metadata.creation_timestamp >= expire_after:
                CLAIMS_EXPIRED.inc(labels={"nodepool": claim.nodepool_name})
                self.recorder.publish(
                    Event(claim.uid, "Normal", "Expired", "nodeclaim expired")
                )
                try:
                    self.client.delete(claim)
                except NotFoundError:
                    pass  # finalized concurrently; already gone


class GarbageCollectionController:
    """Deletes cloud instances whose NodeClaims are gone, and NodeClaims
    whose instances are gone (garbagecollection/controller.go:59-124)."""

    def __init__(self, client: Client, cloud_provider):
        self.client = client
        self.cloud_provider = cloud_provider

    def reconcile(self) -> None:
        claims = {c.status.provider_id for c in self.client.list(NodeClaim) if c.status.provider_id}
        for cloud_claim in self.cloud_provider.list():
            if cloud_claim.status.provider_id not in claims:
                try:
                    self.cloud_provider.delete(cloud_claim)
                    INSTANCES_COLLECTED.inc()
                except NodeClaimNotFoundError:
                    pass  # raced with another deleter; already gone
                except CloudProviderError as exc:
                    # transient provider failure: the orphan survives until
                    # the next GC pass — never let it crash the roster
                    _GC_LOG.debug(
                        "garbage collection of %s deferred: %s",
                        cloud_claim.status.provider_id, exc,
                    )
        # claims whose instances disappeared (and are registered)
        cloud_ids = {c.status.provider_id for c in self.cloud_provider.list()}
        for claim in self.client.list(NodeClaim):
            if (
                claim.status.provider_id
                and claim.status.provider_id not in cloud_ids
                and claim.conds().is_true(COND_REGISTERED)
                and claim.metadata.deletion_timestamp is None
            ):
                self.client.delete(claim)


class HealthController:
    """Force-deletes nodes with provider-declared unhealthy conditions past
    their toleration, capped at 20% of a NodePool
    (health/controller.go:50-237)."""

    def __init__(self, client: Client, cloud_provider, cluster: Cluster):
        self.client = client
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.clock = client.clock

    def reconcile_all(self) -> None:
        policies = self.cloud_provider.repair_policies()
        if not policies:
            return
        now = self.clock.now()
        by_pool: Dict[str, List[Node]] = {}
        unhealthy: List[Node] = []
        for node in self.client.list(Node):
            pool = node.metadata.labels.get(labels_mod.NODEPOOL_LABEL_KEY, "")
            by_pool.setdefault(pool, []).append(node)
            for policy in policies:
                for cond in node.status.conditions:
                    if (
                        cond.type == policy.condition_type
                        and cond.status == policy.condition_status
                        and now - cond.last_transition_time >= policy.toleration_duration
                    ):
                        unhealthy.append(node)
                        break
        # deletions made THIS pass are tracked by name: the listing above
        # is a snapshot, and depending on the store backend a just-issued
        # delete may (shared-reference memory store) or may not (any store
        # returning copies, kube/filestore.py) be reflected in it — a
        # name-deduplicated union counts correctly either way
        marked: Dict[str, set] = {}
        for node in unhealthy:
            pool = node.metadata.labels.get(labels_mod.NODEPOOL_LABEL_KEY, "")
            pool_nodes = by_pool.get(pool, [])
            pool_marked = marked.setdefault(pool, set())
            repairing = len(
                {
                    n.name
                    for n in pool_nodes
                    if n.metadata.deletion_timestamp is not None
                }
                | pool_marked
            )
            # <=20% of a pool may repair at once, rounding UP like PDB
            # percentages (health/controller.go:195-198): 1 of 3 is fine
            allowed = math.ceil(MAX_REPAIR_FRACTION * len(pool_nodes))
            if pool_nodes and repairing >= allowed:
                continue
            if node.metadata.deletion_timestamp is None:
                try:
                    self.client.delete(node)
                except NotFoundError:
                    continue  # terminated concurrently; nothing to repair
                NODES_REPAIRED.inc(labels={"nodepool": pool})
                pool_marked.add(node.name)


class ConsistencyController:
    """NodeShape invariant: a launched node must provide >=90% of the
    claim's expected resources (consistency/nodeshape.go:28)."""

    def __init__(self, client: Client, recorder: Optional[Recorder] = None):
        self.client = client
        self.recorder = recorder or Recorder(client.clock)

    def reconcile_all(self) -> None:
        for claim in self.client.list(NodeClaim):
            if not claim.conds().is_true(COND_REGISTERED):
                continue
            node = self.client.try_get(Node, claim.status.node_name)
            if node is None:
                continue
            consistent = True
            for name, expected in claim.status.capacity.items():
                actual = node.status.capacity.get(name, 0)
                if expected > 0 and actual < expected * NODE_SHAPE_TOLERANCE:
                    consistent = False
                    self.recorder.publish(
                        Event(
                            claim.uid,
                            "Warning",
                            "FailedConsistencyCheck",
                            f"expected {expected} of {name}, node has {actual}",
                        )
                    )
            claim.conds().set(
                COND_CONSISTENT_STATE_FOUND,
                "True" if consistent else "False",
                now=self.client.clock.now(),
            )
            try:
                self.client.update_status(claim)
            except NotFoundError:
                pass  # finalized concurrently; condition is moot


class NodePoolStatusController:
    """Hash bookkeeping + resource counting + readiness
    (nodepool/hash, nodepool/counter, nodepool/readiness)."""

    def __init__(self, client: Client, cluster: Cluster):
        self.client = client
        self.cluster = cluster

    def reconcile_all(self) -> None:
        now = self.client.clock.now()
        nodes = self.cluster.nodes()
        claims_by_pool: Dict[str, List[NodeClaim]] = {}
        for claim in self.client.list(NodeClaim):
            claims_by_pool.setdefault(claim.nodepool_name, []).append(claim)
        for pool in self.client.list(NodePool):
            # drift-hash annotation (hash/controller.go:39-124)
            current_hash = nodepool_hash(pool)
            prev_hash = pool.metadata.annotations.get(
                labels_mod.NODEPOOL_HASH_ANNOTATION_KEY
            )
            pool.metadata.annotations[labels_mod.NODEPOOL_HASH_ANNOTATION_KEY] = (
                current_hash
            )
            # registration health (registrationhealth/controller.go): a spec
            # change resets the condition; a claim launched from the CURRENT
            # spec that registered proves the spec produces viable nodes
            if prev_hash is not None and prev_hash != current_hash:
                pool.conds().set(
                    COND_NODE_REGISTRATION_HEALTHY, "Unknown",
                    reason="NodePoolSpecChanged", now=now,
                )
            elif any(
                c.conds().is_true(COND_REGISTERED)
                and c.metadata.annotations.get(
                    labels_mod.NODEPOOL_HASH_ANNOTATION_KEY
                ) == current_hash
                for c in claims_by_pool.get(pool.name, [])
            ):
                pool.conds().set(COND_NODE_REGISTRATION_HEALTHY, "True", now=now)
            # status.resources aggregation (counter/controller.go)
            total: res.ResourceList = {}
            count = 0
            for sn in nodes:
                if sn.labels().get(labels_mod.NODEPOOL_LABEL_KEY) == pool.name:
                    total = res.merge(total, sn.capacity())
                    count += 1
            total["nodes"] = count * res.MILLI
            pool.status.resources = total
            # schema-tier validation gates readiness (the reference's
            # nodepool validation controller + CRD CEL rules;
            # api/validation.py)
            verrs = validation.validate_node_pool(pool)
            if verrs:
                pool.conds().set(
                    COND_READY, "False", reason="ValidationFailed",
                    message="; ".join(verrs[:3]), now=now,
                )
            else:
                pool.conds().set(COND_READY, "True", now=now)
            self.client.update_status(pool)
