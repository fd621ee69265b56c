# Copied from karpenter_tpu/controllers/provisioning.py, 5 lines changed: TpuSolver renamed TorchSolver, 3 comment lines reworded.
"""Provisioning controller: pending pods -> NodeClaim CRs.

Mirror of the reference's pkg/controllers/provisioning (provisioner.go,
batcher.go): a debounce batcher over pod triggers; each cycle gates on
cluster sync, snapshots state, builds topology, runs the solver
(device fast path with host-oracle fallback — solver/driver.py), and creates
NodeClaim CRs for the result. Node binding is the kube-scheduler's job; the
sim harness (sim/binder.py) stands in for it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .. import obs
from ..api import labels as labels_mod
from ..api.objects import DaemonSet, Node, NodeClaim, NodePool, Pod
from ..api.requirements import Requirements, pod_requirements
from ..events import Event, Recorder
from ..faults.backoff import Backoff
from ..kube import Client
from ..kube.store import ConflictError
from ..metrics import Counter, Gauge, Histogram
from ..scheduling.inflight import ExistingNode, InFlightNodeClaim
from ..scheduling.scheduler import Results
from ..scheduling.template import MAX_INSTANCE_TYPES
from ..scheduling.topology import Topology
from ..scheduling.volumetopology import VolumeTopology
from ..scheduling.volumeusage import VolumeResolver
from ..solver.driver import EncodeCache, SolverConfig, TorchSolver
from ..utils import pod as pod_utils
from .state import Cluster

SCHEDULING_DURATION = Histogram("scheduling_duration_seconds", "Solve wall time")
QUEUE_DEPTH = Gauge("scheduler_queue_depth", "Pods waiting in the batcher")
PODS_SCHEDULED = Counter("pods_scheduled_total", "Pods placed by the provisioner")
PODS_UNSCHEDULABLE = Gauge("unschedulable_pods_count", "Pods that failed to schedule")
NODECLAIMS_CREATED = Counter("nodeclaims_created_total", "NodeClaims created")
UNFINISHED_WORK = Gauge(
    "scheduler_unfinished_work_seconds",
    "Age of the in-flight Solve (scheduling/metrics.go:34-72)",
)
# incremental always-warm solving: how often the reconcile
# loop's encode amortized — the warm-path health signals the churn bench
# rows assert offline
ENCODE_REUSED = Counter(
    "scheduler_encode_reused_total",
    "Solves that reused the prior cluster encoding verbatim "
    "(content-hash fast path)",
)
ENCODE_DELTA_ROWS = Counter(
    "scheduler_encode_delta_rows_total",
    "Axis rows transferred as device deltas instead of full snapshots",
)
DISPATCH_QUEUE_DEPTH = Gauge(
    "solver_dispatch_queue_depth",
    "In-flight kernel dispatches left in the two-slot queue after the "
    "solve (nonzero = an abandoned speculative prefetch)",
)
# dense in-kernel constraints: how often work still fell off
# the batched path for representability reasons — the reference configs
# must keep this at zero (bench.py's fallback_solves column asserts it)
SEQUENTIAL_FALLBACK = Counter(
    "scheduler_sequential_fallback_total",
    "Solve/scenario events routed through the sequential host path by a "
    "remnant gate (strict reservations, oracle-routed pods, scenario "
    "topology declines)",
)


class Batcher:
    """Debounce window over triggers (reference: batcher.go:33-110): starts
    on the first trigger, extends while triggers keep arriving within
    idle_duration, capped at max_duration."""

    def __init__(self, clock, idle_duration: float = 1.0, max_duration: float = 10.0):
        self._clock = clock
        self.idle_duration = idle_duration
        self.max_duration = max_duration
        self._window_start: Optional[float] = None
        self._last_trigger: Optional[float] = None
        self._triggered: set = set()

    def trigger(self, uid: str) -> None:
        now = self._clock.now()
        if self._window_start is None:
            self._window_start = now
        self._last_trigger = now
        self._triggered.add(uid)

    def ready(self) -> bool:
        if self._window_start is None:
            return False
        now = self._clock.now()
        if now - self._window_start >= self.max_duration:
            return True
        return now - self._last_trigger >= self.idle_duration

    def reset(self) -> None:
        self._window_start = None
        self._last_trigger = None
        self._triggered = set()

    def __len__(self) -> int:
        return len(self._triggered)


class Provisioner:
    """The singleton provisioning reconciler (provisioner.go:72-139)."""

    def __init__(
        self,
        client: Client,
        cloud_provider,
        cluster: Cluster,
        recorder: Optional[Recorder] = None,
        solver_config: Optional[SolverConfig] = None,
        batch_idle_duration: float = 1.0,
        batch_max_duration: float = 10.0,
        reserved_capacity_enabled: bool = False,
        solver_address: Optional[str] = None,
    ):
        self.client = client
        self.cloud_provider = cloud_provider
        self.cluster = cluster
        self.clock = client.clock
        self.recorder = recorder or Recorder(self.clock)
        self.solver_config = solver_config
        # gRPC sidecar target (host:port). Set -> solves ship to the
        # solver process (solver/service.py) instead of running in-process
        self.solver_address = solver_address
        self.reserved_capacity_enabled = reserved_capacity_enabled
        self._encode_cache = EncodeCache()  # survives across schedule() calls
        # transient store conflicts (a real apiserver's 409s) get a couple
        # of bounded in-cycle retries on the injected clock; conflicts that
        # outlive the budget leave the pods pending for the next cycle
        self._store_backoff = Backoff(
            self.clock, initial=0.05, max_delay=1.0, max_attempts=3
        )
        self.batcher = Batcher(self.clock, batch_idle_duration, batch_max_duration)
        self.volume_topology = VolumeTopology(client)
        self.volume_resolver = VolumeResolver(client)
        client.watch(self._on_event)

    def _volume_objects(self, pods) -> List:
        """PVC/PV/StorageClass objects the pending pods reference — the
        sidecar rebuilds attach-limit/zonal state from these (wire.py)."""
        from ..api.objects import (
            PersistentVolume, PersistentVolumeClaim, StorageClass,
        )

        if not any(p.spec.volumes for p in pods):
            return []
        out: List = []
        for kind in (PersistentVolumeClaim, PersistentVolume, StorageClass):
            out.extend(self.client.list(kind))
        return out

    # -- triggers (provisioning/controller.go:44-119) ---------------------

    def _on_event(self, event) -> None:
        if event.kind == "Pod" and event.type in ("ADDED", "MODIFIED"):
            if pod_utils.is_provisionable(event.object):
                # ACK for scheduling-latency metrics (controller.go:63-66)
                self.cluster.ack_pods(event.object.uid)
                self.trigger(event.object.uid)

    def trigger(self, uid: str) -> None:
        self.batcher.trigger(uid)
        QUEUE_DEPTH.set(float(len(self.batcher)))

    # -- the reconcile cycle ----------------------------------------------

    def reconcile(self, force: bool = False) -> Optional[Results]:
        """One pass: returns Results if a solve ran, else None."""
        if not force and not self.batcher.ready():
            return None
        self.batcher.reset()
        QUEUE_DEPTH.set(0.0)
        if not self.cluster.synced():
            return None
        pods = self.get_pending_pods()
        pods += self.get_deleting_node_pods()
        if not pods:
            return None
        # ACK the whole batch: covers pods that were already pending before
        # this Provisioner was constructed (no watch replay on restart)
        self.cluster.ack_pods(*(p.uid for p in pods))
        results = self.schedule(pods)
        scheduled_uids = [
            p.uid for p in pods if p.uid not in results.pod_errors
        ]
        self.cluster.mark_pod_scheduling_decisions(
            results.pod_errors, *scheduled_uids
        )
        # the commit phase (store writes + nominations) gets its own span
        # so a trace splits decision time from apply time
        with obs.span(
            "provision.commit", claims=len(results.new_node_claims)
        ):
            self.create_node_claims(results)
            self.nominate(results)
        return results

    def get_pending_pods(self) -> List[Pod]:
        return [
            p
            for p in self.client.list(Pod)
            if pod_utils.is_provisionable(p) and self._validate(p)
        ]

    def get_deleting_node_pods(self) -> List[Pod]:
        """Reschedulable pods on draining nodes (provisioner.go:158-177)."""
        out = []
        for sn in self.cluster.nodes():
            if sn.mark_for_deletion or sn.deleting():
                out.extend(p for p in sn.pods if pod_utils.is_reschedulable(p))
        return out

    def _validate(self, pod: Pod) -> bool:
        if pod.spec.scheduler_name != "default-scheduler":
            return False
        # pods with missing PVCs/StorageClasses are ignored, matching
        # provisioner.go:456-463 + volumetopology.go:152-199
        if pod.spec.volumes:
            err = self.volume_topology.validate_persistent_volume_claims(pod)
            if err is not None:
                self.recorder.publish(
                    Event(
                        object_uid=pod.uid,
                        type="Warning",
                        reason="FailedScheduling",
                        message=err,
                    )
                )
                return False
        return True

    # -- scheduling (provisioner.go:216-359) ------------------------------

    def schedule(self, pods: List[Pod]) -> Results:
        with obs.span("provision.schedule", pods=len(pods)):
            return self._schedule(pods)

    def _schedule(self, pods: List[Pod]) -> Results:
        t0 = self.clock.now()
        # zonal-volume requirement injection (volumetopology.go:42-78); copy
        # volume-bearing pods so the store objects stay unmutated
        pods = [copy.deepcopy(p) if p.spec.volumes else p for p in pods]
        for p in pods:
            if p.spec.volumes:
                self.volume_topology.inject(p)
        state_nodes = [
            sn
            for sn in self.cluster.nodes()
            if not (sn.mark_for_deletion or sn.deleting())
        ]
        node_pools = self._ready_node_pools()
        instance_types = {
            np_.name: self.cloud_provider.get_instance_types(np_) for np_ in node_pools
        }
        daemonset_pods = self._daemonset_pods()
        topology = Topology(
            self.client, state_nodes, node_pools, instance_types, pods,
            cluster=self.cluster,
        )
        if self.solver_address:
            # controller/sidecar split (deploy/docker-compose.yml): the
            # solve ships over the gRPC seam with the full cluster view —
            # state nodes, daemonsets, and the volume objects pending pods
            # reference — so the sidecar packs identically to in-process
            from ..solver.service import RemoteSolver

            solver = RemoteSolver(
                self.solver_address,
                node_pools,
                instance_types,
                daemonset_pods=daemonset_pods,
                state_nodes=state_nodes,
                volume_objects=self._volume_objects(pods),
                reserved_capacity_enabled=self.reserved_capacity_enabled,
                # carries the per-call gRPC deadline and the degradation
                # ladder into the remote seam (retry once, then solve
                # in-process — service.py:RemoteSolver); the long-lived
                # encode cache keeps outage-time fallback solves from
                # re-encoding the catalog every cycle
                config=self.solver_config,
                encode_cache=self._encode_cache,
            )
        else:
            solver = TorchSolver(
                node_pools,
                instance_types,
                topology,
                state_nodes=state_nodes,
                daemonset_pods=daemonset_pods,
                config=self.solver_config,
                encode_cache=self._encode_cache,
                volume_resolver=self.volume_resolver,
                reserved_capacity_enabled=self.reserved_capacity_enabled,
            )
        # the in-flight-solve age gauge ticks on a side thread so the
        # metrics server can observe long solves mid-flight, the way the
        # reference's ticker does (scheduling/metrics.go:34-72)
        import threading
        import time as _time

        stop = threading.Event()
        # deliberately wall-clock, not the injected clock: this gauge
        # reports how long a REAL solve has been in flight to the metrics
        # server; simulated time would freeze it mid-solve
        wall0 = _time.monotonic()  # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: gauge measures real in-flight solve age

        def _tick():
            while not stop.wait(1.0):
                # analysis: sanctioned[BLK302,CLK1001] same wall-time boundary as wall0
                UNFINISHED_WORK.set(_time.monotonic() - wall0)
            # the ticker owns the final reset: a pending set() racing a
            # main-thread reset could otherwise leave the gauge stuck
            # nonzero between batches
            UNFINISHED_WORK.set(0.0)

        ticker = threading.Thread(target=_tick, daemon=True)
        ticker.start()
        try:
            results = solver.solve(pods)
        finally:
            stop.set()
        SCHEDULING_DURATION.observe(max(self.clock.now() - t0, 0.0))
        PODS_UNSCHEDULABLE.set(float(len(results.pod_errors)))
        scheduled = len(pods) - len(results.pod_errors)
        if scheduled:
            PODS_SCHEDULED.inc(value=scheduled)
        # incremental-encode telemetry (RemoteSolver solves report through
        # their in-process fallback only; the sidecar's own metrics carry
        # its warm-path numbers)
        if getattr(solver, "last_encode_reused", False):
            ENCODE_REUSED.inc()
        delta_rows = getattr(solver, "last_delta_rows", 0)
        if delta_rows:
            ENCODE_DELTA_ROWS.inc(value=delta_rows)
        fallbacks = getattr(solver, "fallback_solves", 0)
        if fallbacks:
            SEQUENTIAL_FALLBACK.inc(value=fallbacks)
        queue = getattr(solver, "_queue", None)
        if queue is not None:
            DISPATCH_QUEUE_DEPTH.set(float(queue.depth()))
        return results

    def _ready_node_pools(self) -> List[NodePool]:
        pools = []
        for np_ in self.client.list(NodePool):
            if np_.metadata.deletion_timestamp is not None:
                continue
            pools.append(np_)
        return sorted(pools, key=lambda p: (-p.spec.weight, p.name))

    def _daemonset_pods(self) -> List[Pod]:
        """Synthetic pods for each daemonset template
        (provisioner.go:429-454)."""
        out = []
        for ds in self.client.list(DaemonSet):
            pod = Pod(spec=ds.pod_spec)
            pod.metadata.name = f"daemon-{ds.name}"
            pod.metadata.owner_uids = [ds.metadata.uid]
            out.append(pod)
        return out

    # -- claim creation (provisioner.go:374-412) --------------------------

    def create_node_claims(self, results: Results) -> List[NodeClaim]:
        from .nodeclaim_disruption import materialize_claim

        pools = {np_.name: np_ for np_ in self.client.list(NodePool)}
        created = []
        for claim_model in results.new_node_claims:
            try:
                # bounded, clock-driven retry on transient store conflicts;
                # a conflict that survives the budget leaves these pods
                # pending and the next cycle re-solves with fresh state
                claim = self._store_backoff.call(
                    lambda: materialize_claim(
                        self.client, claim_model, pools
                    ),
                    retriable=(ConflictError,),
                )
            except ConflictError as exc:
                for pod in claim_model.pods:
                    self.recorder.publish(
                        Event(
                            object_uid=pod.uid,
                            type="Warning",
                            reason="RetryableCreateFailed",
                            message=f"store conflict creating NodeClaim: {exc}",
                        )
                    )
                continue
            except ValueError as exc:
                # launch-time refusal (e.g. minValues unmet after the
                # 60-type truncation): pods stay pending and retry next
                # cycle, mirroring the reference's failed-launch event
                for pod in claim_model.pods:
                    self.recorder.publish(
                        Event(
                            object_uid=pod.uid,
                            type="Warning",
                            reason="FailedLaunch",
                            message=str(exc),
                        )
                    )
                continue
            NODECLAIMS_CREATED.inc(
                labels={"nodepool": claim_model.template.node_pool_name}
            )
            created.append(claim)
            claim_model.created_name = claim.name  # type: ignore[attr-defined]
        return created

    def nominate(self, results: Results) -> None:
        """Nominate existing nodes that received pods so disruption leaves
        them alone (provisioner.go + cluster.go:229-247)."""
        now = self.clock.now()
        for existing in results.existing_nodes:
            if existing.pods:
                self.cluster.nominate_node(existing.name, now)
                for pod in existing.pods:
                    self.recorder.publish(
                        Event(
                            object_uid=pod.uid,
                            type="Normal",
                            reason="Nominated",
                            message=f"should schedule on node {existing.name}",
                        )
                    )


def _requirements_to_selectors(reqs: Requirements):
    from ..api.objects import NodeSelectorRequirement

    out = []
    for r in reqs:
        out.append(
            NodeSelectorRequirement(
                r.key,
                r.operator().value,
                tuple(r.values_list()),
                min_values=r.min_values,
            )
        )
    return out
