# Copied from karpenter_tpu/cloudprovider/kwok.py.
"""kwok-style reference provider: NodeClaims become Nodes with no kubelet.

Mirror of the reference harness (kwok/cloudprovider/cloudprovider.go:44-216):
``create`` picks the cheapest compatible offering, synthesizes the Node's
labels from the claim requirements + instance type, and registers the Node
after ``registration_delay`` simulated seconds (the reference does this on a
goroutine; here registrations are flushed by ``process_registrations``, driven
by the controller loop or tests).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .. import faults
from ..api import labels as labels_mod
from ..api import resources as res
from ..api import taints as taints_mod
from ..api.objects import Node, NodeClaim, NodeStatus, ObjectMeta, Taint
from ..api.requirements import Requirements
from ..kube import Client
from . import corpus
from .icecache import InsufficientCapacityCache, mask_unavailable_offerings
from .types import (
    CloudProvider,
    InstanceType,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    Offering,
    available,
    cheapest,
    compatible_offerings,
)


@dataclass
class KwokInstance:
    provider_id: str
    node: Node
    instance_type: InstanceType
    offering: Offering
    terminated: bool = False


class KwokCloudProvider(CloudProvider):
    def __init__(
        self,
        client: Client,
        instance_types: Optional[Sequence[InstanceType]] = None,
        registration_delay: float = 0.0,
    ):
        self._client = client
        # public: MetricsCloudProvider reads the injected clock off the
        # wrapped provider so its duration histograms replay-deterministic
        self.clock = client.clock
        self._instance_types = list(instance_types if instance_types is not None else corpus.generate())
        self._by_name = {it.name: it for it in self._instance_types}
        self._instances: Dict[str, KwokInstance] = {}
        self._pending: List[tuple] = []  # (due_time, KwokInstance)
        self._registration_delay = registration_delay
        self._seq = itertools.count(1)
        # terminated provider ids: a second delete (or a get) for one of
        # these is a typed NodeClaimNotFoundError, never a KeyError leaking
        # through the termination controller
        self._tombstones: set = set()
        # failed offerings are skipped for a TTL, keyed (instance type,
        # zone, capacity type) — the reference's ICE cache
        self.ice_cache = InsufficientCapacityCache(client.clock)
        self._rehydrate()

    def _rehydrate(self) -> None:
        """Rebuild the simulated cloud from the store: a real provider's
        instances outlive the controller process, so a restart over a
        durable store (kube/filestore.py) must find its fleet intact —
        otherwise garbage collection reaps every healthy claim as
        'instance gone'. This is the provider side of the reference's
        hydration concern (its clouds are genuinely external)."""
        max_seq = 0
        for claim in self._client.list(NodeClaim):
            pid = claim.status.provider_id
            if not pid or not pid.startswith("kwok://"):
                continue
            it = self._by_name.get(
                claim.metadata.labels.get(labels_mod.INSTANCE_TYPE, "")
            )
            if it is None:
                continue
            zone = claim.metadata.labels.get(labels_mod.TOPOLOGY_ZONE, "")
            ct = claim.metadata.labels.get(
                labels_mod.CAPACITY_TYPE_LABEL_KEY, ""
            )
            offering = next(
                (
                    o
                    for o in it.offerings
                    if o.zone() == zone and o.capacity_type() == ct
                ),
                None,
            ) or (it.offerings[0] if it.offerings else None)
            if offering is None:
                continue
            node = self._client.try_get(Node, claim.name)
            instance = None
            if node is None:
                # crashed between create() and registration: rebuild the
                # pending registration too, or the Node never appears and
                # liveness reaps the claim
                node = self._to_node(claim, it, offering, pid)
                instance = KwokInstance(pid, node, it, offering)
                self._pending.append((self._client.clock.now(), instance))
            self._instances[pid] = instance or KwokInstance(
                pid, node, it, offering
            )
            tail = pid.rsplit("-", 1)[-1]
            if tail.isdigit():
                max_seq = max(max_seq, int(tail))
        if max_seq:
            self._seq = itertools.count(max_seq + 1)

    def name(self) -> str:
        return "kwok"

    # -- SPI ---------------------------------------------------------------

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        reqs = node_claim.spec.scheduling_requirements()
        ice_active = self.ice_cache.active()
        # cheapest compatible (instance type, offering) pair, mirroring
        # kwok/cloudprovider/cloudprovider.go:168-216
        best = None
        for it in self._instance_types:
            if reqs.intersects(it.requirements) is not None:
                continue
            ofs = compatible_offerings(available(it.offerings), reqs)
            if ice_active:
                ofs = self.ice_cache.filter_offerings(it.name, ofs)
            # also respect requirements tightened to the instance type
            merged = Requirements(*reqs.values())
            merged.add(*it.requirements.values())
            ofs = compatible_offerings(ofs, merged)
            of = cheapest(ofs)
            if of is not None and (best is None or of.price < best[1].price):
                best = (it, of)
        if best is None:
            raise InsufficientCapacityError(
                f"no compatible instance type/offering for {node_claim.name}"
            )
        it, offering = best
        try:
            # chaos seam: the real cloud fails launches with per-offering
            # insufficient capacity, timeouts, or generic provider errors
            faults.hit(
                faults.PROVIDER_CREATE,
                claim=node_claim.name,
                instance_type=it.name,
                zone=offering.zone(),
                capacity_type=offering.capacity_type(),
            )
        except InsufficientCapacityError:
            # a per-offering ICE: remember the failed cell for a TTL so the
            # retry (next reconcile) routes around it instead of re-picking
            self.ice_cache.mark_unavailable(
                it.name, offering.zone(), offering.capacity_type()
            )
            raise
        provider_id = f"kwok://{node_claim.name}-{next(self._seq)}"

        node = self._to_node(node_claim, it, offering, provider_id)
        instance = KwokInstance(provider_id, node, it, offering)
        self._instances[provider_id] = instance

        now = self._client.clock.now()
        self._pending.append((now + self._registration_delay, instance))

        node_claim.status.provider_id = provider_id
        node_claim.status.image_id = f"kwok-image-{it.name}"
        node_claim.status.capacity = dict(it.capacity)
        node_claim.status.allocatable = dict(it.allocatable())
        # stamp the chosen type's single-valued requirement keys as labels
        # (the reference's providers return the launched NodeClaim with the
        # full instance label set): pre-registration state nodes answer
        # labels() from the claim, so pods constraining provider labels
        # (instance-cpu etc.) must match the in-flight node — otherwise the
        # next provisioning cycle double-provisions
        for key, v in it.requirements.single_valued_labels().items():
            node_claim.metadata.labels.setdefault(key, v)
        node_claim.metadata.labels.setdefault(labels_mod.INSTANCE_TYPE, it.name)
        node_claim.metadata.labels.setdefault(
            labels_mod.CAPACITY_TYPE_LABEL_KEY, offering.capacity_type()
        )
        node_claim.metadata.labels.setdefault(labels_mod.TOPOLOGY_ZONE, offering.zone())
        return node_claim

    def _to_node(
        self, claim: NodeClaim, it: InstanceType, offering: Offering, provider_id: str
    ) -> Node:
        node_labels = dict(claim.metadata.labels)
        # concrete values for every instance-type requirement key
        for req in it.requirements:
            v = req.any()
            if v:
                node_labels[req.key] = v
        node_labels[labels_mod.INSTANCE_TYPE] = it.name
        node_labels[labels_mod.TOPOLOGY_ZONE] = offering.zone()
        node_labels[labels_mod.CAPACITY_TYPE_LABEL_KEY] = offering.capacity_type()
        # claim requirements refine labels (e.g. a specific zone subset)
        for req in claim.spec.scheduling_requirements():
            if not req.has(node_labels.get(req.key, "")):
                v = req.any()
                if v:
                    node_labels[req.key] = v
        node_labels[labels_mod.HOSTNAME] = claim.name

        node_taints = taints_mod.merge(
            list(claim.spec.taints),
            [Taint(key=labels_mod.UNREGISTERED_TAINT_KEY, effect=taints_mod.NO_EXECUTE)],
        )
        return Node(
            metadata=ObjectMeta(name=claim.name, labels=node_labels),
            provider_id=provider_id,
            taints=node_taints,
            status=NodeStatus(
                capacity=dict(it.capacity),
                allocatable=dict(it.allocatable()),
                ready=True,
            ),
        )

    def process_registrations(self, now: Optional[float] = None) -> List[Node]:
        """Create Node objects whose registration delay has elapsed."""
        now = self._client.clock.now() if now is None else now
        due = [inst for t, inst in self._pending if t <= now and not inst.terminated]
        self._pending = [(t, i) for t, i in self._pending if t > now and not i.terminated]
        created = []
        for inst in due:
            try:
                # chaos seam: registration-never-completes — the kubelet
                # (or its network path) stalls; the instance stays pending
                # and liveness eventually reaps the claim
                faults.hit(faults.PROVIDER_REGISTER, name=inst.node.name)
                if self._client.try_get(Node, inst.node.name) is None:
                    self._client.create(inst.node)
                    created.append(inst.node)
            except Exception:
                # ANY failure (injected fault, store conflict, crash
                # mid-write) defers this instance rather than dropping it:
                # `due` was already popped from _pending, and a silently
                # lost registration stalls the claim until the liveness
                # reaper — the orphan class the chaos soak forbids
                self._pending.append((now + 1.0, inst))
        return created

    def reclaim(self, provider_id: str) -> bool:
        """The cloud takes an instance back (a spot reclaim): the
        instance terminates WITHOUT any claim/store involvement — exactly
        what the control plane sees when real spot capacity vanishes. The
        garbage-collection controller notices the missing instance on its
        next pass and reaps the claim. Returns False for ids already
        gone (idempotent, like the cloud's own eventual consistency)."""
        inst = self._instances.pop(provider_id, None)
        if inst is None:
            return False
        inst.terminated = True
        self._tombstones.add(provider_id)
        return True

    def delete(self, node_claim: NodeClaim) -> None:
        pid = node_claim.status.provider_id
        faults.hit(faults.PROVIDER_DELETE, provider_id=pid)
        inst = self._instances.pop(pid, None) if pid else None
        if inst is None:
            # typed NotFound for an unknown id AND for a double-delete
            # (tombstoned) — both idempotent from the controllers' view
            if pid in self._tombstones:
                raise NodeClaimNotFoundError(f"{pid} already terminated")
            raise NodeClaimNotFoundError(pid or "<no provider id>")
        inst.terminated = True
        self._tombstones.add(pid)

    def get(self, provider_id: str) -> NodeClaim:
        inst = self._instances.get(provider_id) if provider_id else None
        if inst is None or inst.terminated:
            raise NodeClaimNotFoundError(provider_id or "<no provider id>")
        return self._instance_to_claim(inst)

    def list(self) -> List[NodeClaim]:
        return [
            self._instance_to_claim(i) for i in self._instances.values() if not i.terminated
        ]

    def _instance_to_claim(self, inst: KwokInstance) -> NodeClaim:
        claim = NodeClaim(metadata=ObjectMeta(name=inst.node.name, labels=dict(inst.node.metadata.labels)))
        claim.status.provider_id = inst.provider_id
        claim.status.capacity = dict(inst.instance_type.capacity)
        claim.status.allocatable = dict(inst.instance_type.allocatable())
        return claim

    def get_instance_types(self, node_pool) -> List[InstanceType]:
        if self.ice_cache.active():
            # ICE-cached offerings read as unavailable so the solver routes
            # around recently failed capacity cells until the TTL lapses
            return mask_unavailable_offerings(
                self._instance_types, self.ice_cache
            )
        return list(self._instance_types)

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return ""

    # -- checkpoint (sim/twin.py) -----------------------------------------

    def export_state(self) -> dict:
        """The provider-side state the store CANNOT rebuild through
        ``_rehydrate``: pending-registration due times, tombstones, ICE
        entries, and the instance-id sequence. A resumed twin constructs a
        fresh provider over the restored store (rehydration recovers the
        fleet) and then applies this on top."""
        seq = next(self._seq)
        self._seq = itertools.count(seq)  # peeked, not consumed
        return {
            "seq": seq,
            "pending": [(t, inst.provider_id) for t, inst in self._pending],
            "tombstones": set(self._tombstones),
            "ice": dict(self.ice_cache._until),
            "ice_ttl": self.ice_cache.ttl,
        }

    def restore_state(self, state: dict) -> None:
        self._seq = itertools.count(int(state["seq"]))
        self._tombstones = set(state["tombstones"])
        self.ice_cache._until = dict(state["ice"])
        self.ice_cache.ttl = float(state["ice_ttl"])
        # _rehydrate queued node-less instances at due=now; re-time them
        # from the checkpoint (and drop rehydrated entries the checkpoint
        # says were not pending — e.g. instances that registered between
        # rehydration's guess and the interrupted run's reality)
        by_pid = {inst.provider_id: inst for _, inst in self._pending}
        self._pending = [
            (t, by_pid[pid])
            for t, pid in state["pending"]
            if pid in by_pid
        ]
