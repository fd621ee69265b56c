# Copied from karpenter_tpu/controllers/lifecycle.py.
"""NodeClaim lifecycle: Launch -> Registration -> Initialization -> Liveness.

Mirror of the reference's pkg/controllers/nodeclaim/lifecycle: sub-reconcilers
walk each claim through its conditions; the finalizer ensures the cloud
instance is terminated before the claim disappears
(lifecycle/controller.go:59-286, launch.go, registration.go,
initialization.go, liveness.go).
"""

from __future__ import annotations

from typing import List, Optional

from ..api import labels as labels_mod
from ..api import validation
from ..api import resources as res
from ..api import taints as taints_mod
from ..api.objects import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_NODE_REGISTRATION_HEALTHY,
    COND_REGISTERED,
    Node,
    NodeClaim,
    NodePool,
)
from ..cloudprovider.types import (
    CloudProviderError,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
)
from ..events import Event, Recorder
from ..faults.backoff import RetryTracker
from ..kube import Client
from ..kube.store import ConflictError, NotFoundError
from ..metrics import Counter

LIVENESS_TTL = 15 * 60.0  # liveness.go:44

CLAIMS_LAUNCHED = Counter("nodeclaims_launched_total", "")
CLAIMS_REGISTERED = Counter("nodeclaims_registered_total", "")
CLAIMS_INITIALIZED = Counter("nodeclaims_initialized_total", "")
CLAIMS_TERMINATED = Counter("nodeclaims_terminated_total", "")


class LifecycleController:
    def __init__(self, client: Client, cloud_provider, recorder: Optional[Recorder] = None):
        self.client = client
        self.cloud_provider = cloud_provider
        self.clock = client.clock
        self.recorder = recorder or Recorder(self.clock)
        # cross-pass backoff per claim: a failed cloud create/delete is
        # NOT re-attempted every tick — attempts space out exponentially
        # on the injected clock (faults/backoff.py), the in-process analog
        # of controller-runtime's rate-limited requeue
        self._launch_retry = RetryTracker(self.clock, initial=5.0, max_delay=120.0)
        self._delete_retry = RetryTracker(self.clock, initial=5.0, max_delay=120.0)

    def reconcile_all(self) -> None:
        claims = self.client.list(NodeClaim)
        self._launch_retry.prune(c.uid for c in claims)
        self._delete_retry.prune(c.uid for c in claims)
        for claim in claims:
            try:
                self.reconcile(claim)
            except (ConflictError, NotFoundError):
                # transient store conflict (or the claim finalized
                # concurrently): the level-triggered loop retries this
                # claim on the next pass with fresh state
                continue

    def reconcile(self, claim: NodeClaim) -> None:
        if claim.metadata.deletion_timestamp is not None:
            self._finalize(claim)
            return
        self._launch(claim)
        self._register(claim)
        self._initialize(claim)
        self._liveness(claim)

    # -- launch (launch.go:45-143) ----------------------------------------

    def _launch(self, claim: NodeClaim) -> None:
        conds = claim.conds()
        if conds.is_true(COND_LAUNCHED):
            return
        if not self._launch_retry.ready(claim.uid):
            return  # backing off a failed create; retried when due
        # schema-tier admission (the CRD CEL rules, nodeclaim.go:38-41):
        # an invalid claim can never produce a node; delete it like an
        # unrecoverable launch failure
        verrs = validation.validate_node_claim(claim)
        if verrs:
            self.recorder.publish(
                Event(claim.uid, "Warning", "ValidationFailed",
                      "; ".join(verrs[:3]))
            )
            self.client.delete(claim)
            self._finalize(claim)
            return
        try:
            self.cloud_provider.create(claim)
        except InsufficientCapacityError as e:
            # unrecoverable for this claim's constraints: delete it so the
            # provisioner can retry with fresh state (launch.go:70-86)
            self.recorder.publish(
                Event(claim.uid, "Warning", "LaunchFailed", str(e))
            )
            self.client.delete(claim)
            self._finalize(claim)
            return
        except CloudProviderError as e:
            # transient provider failure (timeout, throttle): surface it on
            # the claim and back off before the next attempt — liveness
            # still bounds how long an unlaunched claim may live
            self._launch_retry.failure(claim.uid)
            conds.set(COND_LAUNCHED, "False", "LaunchFailed", str(e), now=self.clock.now())
            self.client.update_status(claim)
            return
        self._launch_retry.success(claim.uid)
        conds.set(COND_LAUNCHED, "True", now=self.clock.now())
        CLAIMS_LAUNCHED.inc(labels={"nodepool": claim.nodepool_name})
        self.client.update_status(claim)

    # -- registration (registration.go:47-145) ----------------------------

    def _register(self, claim: NodeClaim) -> None:
        conds = claim.conds()
        if not conds.is_true(COND_LAUNCHED) or conds.is_true(COND_REGISTERED):
            return
        node = self._node_for(claim)
        if node is None:
            return
        # sync labels/annotations/taints from the claim onto the node, and
        # drop the unregistered taint
        for k, v in claim.metadata.labels.items():
            node.metadata.labels.setdefault(k, v)
        node.metadata.labels[labels_mod.NODE_REGISTERED_LABEL_KEY] = "true"
        node.metadata.owner_uids = [claim.uid]
        node.taints = [
            t for t in node.taints if t.key != labels_mod.UNREGISTERED_TAINT_KEY
        ]
        # managed nodes drain through the termination controller before
        # disappearing (registration adds the finalizer in the reference)
        if labels_mod.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(labels_mod.TERMINATION_FINALIZER)
        self.client.update(node)
        claim.status.node_name = node.name
        conds.set(COND_REGISTERED, "True", now=self.clock.now())
        CLAIMS_REGISTERED.inc(labels={"nodepool": claim.nodepool_name})
        self.client.update_status(claim)

    # -- initialization (initialization.go:41-143) ------------------------

    def _initialize(self, claim: NodeClaim) -> None:
        conds = claim.conds()
        if not conds.is_true(COND_REGISTERED) or conds.is_true(COND_INITIALIZED):
            return
        node = self._node_for(claim)
        if node is None or not node.status.ready:
            return
        # startup taints must have cleared
        startup = {(t.key, t.effect) for t in claim.spec.startup_taints}
        for t in node.taints:
            if (t.key, t.effect) in startup or taints_mod.is_ephemeral(t):
                return
        # all expected resources registered (initialization.go:41-45)
        for name, q in claim.status.capacity.items():
            if q > 0 and node.status.capacity.get(name, 0) == 0:
                return
        node.metadata.labels[labels_mod.NODE_INITIALIZED_LABEL_KEY] = "true"
        self.client.update(node)
        conds.set(COND_INITIALIZED, "True", now=self.clock.now())
        CLAIMS_INITIALIZED.inc(labels={"nodepool": claim.nodepool_name})
        self.client.update_status(claim)

    # -- liveness (liveness.go:43-105) ------------------------------------

    def _liveness(self, claim: NodeClaim) -> None:
        conds = claim.conds()
        if conds.is_true(COND_REGISTERED):
            return
        age = self.clock.now() - claim.metadata.creation_timestamp
        if age > LIVENESS_TTL:
            self.recorder.publish(
                Event(
                    claim.uid, "Warning", "FailedRegistration",
                    f"deleting NodeClaim unregistered after {int(age)}s",
                )
            )
            # a registration timeout marks the owning pool unhealthy
            # (registrationhealth/controller.go: the False half)
            pool = self.client.try_get(NodePool, claim.nodepool_name)
            if pool is not None:
                pool.conds().set(
                    COND_NODE_REGISTRATION_HEALTHY, "False",
                    reason="RegistrationTimeout", now=self.clock.now(),
                )
                self.client.update_status(pool)
            self.client.delete(claim)
            self._finalize(claim)

    # -- finalizer (lifecycle/controller.go:173-253) ----------------------

    def _finalize(self, claim: NodeClaim) -> None:
        if labels_mod.TERMINATION_FINALIZER not in claim.metadata.finalizers:
            return
        if claim.status.provider_id:
            if not self._delete_retry.ready(claim.uid):
                return  # instance termination backing off; finalizer holds
            try:
                self.cloud_provider.delete(claim)
            except NodeClaimNotFoundError:
                pass  # already gone
            except CloudProviderError as e:
                # transient: keep the finalizer (the instance MUST die
                # before the claim may disappear) and back off the retry
                self._delete_retry.failure(claim.uid)
                self.recorder.publish(
                    Event(claim.uid, "Warning", "TerminationFailed", str(e))
                )
                return
            self._delete_retry.success(claim.uid)
        node = self.client.try_get(Node, claim.status.node_name) if claim.status.node_name else None
        if node is None:
            node = self._node_for(claim)
        if node is not None:
            try:
                self.client.delete(node)
            except KeyError:
                pass
        CLAIMS_TERMINATED.inc(labels={"nodepool": claim.nodepool_name})
        self.client.remove_finalizer(claim, labels_mod.TERMINATION_FINALIZER)

    def _node_for(self, claim: NodeClaim) -> Optional[Node]:
        for node in self.client.list(Node):
            if node.provider_id == claim.status.provider_id:
                return node
        return None
