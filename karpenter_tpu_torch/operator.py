# Copied from karpenter_tpu/operator.py, the port's solver backends, the profiler hook records torch.profiler, and shutdown releases the device-resident solve state.
"""Operator: wires the controller roster over one store + provider.

Plays the role of pkg/operator + pkg/controllers/controllers.go:62-113: one
object owns the store, state cache, and every controller; ``step()`` runs one
level-triggered reconcile pass (the in-process analog of controller-runtime's
requeue loop), and ``run(until)`` advances simulated time.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

from .controllers.disruption import DisruptionController
from .controllers.disruption.controller import DisruptionContext
from .controllers.housekeeping import (
    ConsistencyController,
    ExpirationController,
    GarbageCollectionController,
    HealthController,
    NodePoolStatusController,
)
from .controllers.lifecycle import LifecycleController
from .controllers.metrics_controllers import (
    NodeMetricsController,
    NodePoolMetricsController,
    PodMetricsController,
)
from .controllers.nodeclaim_disruption import (
    NodeClaimDisruptionController,
    PodEventsController,
)
from .controllers.provisioning import Provisioner
from .controllers.state import Cluster
from .controllers.termination import TerminationController
from . import obs
from .events import Event, REASON_RECONCILE_ERROR, Recorder
from .faults.backoff import RetryTracker
from .faults.breaker import SolverHealth
from .kube import Client, Clock, RealClock
from .metrics import Counter
from .options import Options
from .solver.driver import SolverConfig

RECONCILE_ERRORS = Counter(
    "controller_reconcile_errors_total",
    "Reconcile passes that raised; requeued with backoff",
)


def profile_path(trace_path: str) -> str:
    """Where ``--enable-profiling``'s torch.profiler trace goes: beside
    the obs trace (``<trace_path>.torch.json``), or ``torch_profile.json``
    in the working directory when no trace path is set."""
    return f"{trace_path}.torch.json" if trace_path else "torch_profile.json"


@dataclass
class OperatorOptions:
    batch_idle_duration: float = 1.0  # options.go:100-101
    batch_max_duration: float = 10.0
    spot_to_spot_consolidation: bool = False  # feature gate
    node_repair: bool = False  # feature gate
    reserved_capacity: bool = False  # feature gate
    solver_config: Optional[SolverConfig] = None
    # gRPC solver-sidecar target (deploy/docker-compose.yml's split); ""
    # keeps solves in-process
    solver_address: str = ""
    # active/passive HA (operator.go:137-141); in-process default is a
    # single operator, so election is opt-in via the CLI flags
    leader_election: bool = False
    leader_election_name: str = "karpenter-leader-election"
    leader_election_namespace: str = "kube-system"
    # the reference serves pprof behind --enable-profiling
    # (operator.go:159-175); here torch.profiler records the operator's
    # run (host and CUDA activity) and shutdown() writes its Chrome trace
    # to ``profile_path(trace_path)``. PyTorch has no profiler server:
    # profiling_port is kept for the options' sake and serves nothing
    enable_profiling: bool = False
    profiling_port: int = 9999
    # decision-path span tracing (obs/): off by default (the no-op seam
    # costs one global check per call site); the seed makes replayed
    # chaos runs produce identical traces
    enable_tracing: bool = False
    trace_seed: int = 0
    # shutdown artifacts: Chrome trace-event JSON (Perfetto-loadable) and
    # the Prometheus text exposition of metrics.REGISTRY; "" skips
    trace_path: str = ""
    metrics_dump_path: str = ""

    @classmethod
    def from_options(cls, opts: "Options") -> "OperatorOptions":
        """Map parsed CLI/env Options (options.py) onto the operator knobs."""
        solver_config = None
        if opts.solver_backend != "kernels" or opts.solver_mesh:
            solver_config = SolverConfig(
                backend=opts.solver_backend,
                mesh=opts.solver_mesh or None,
            )
        return cls(
            batch_idle_duration=opts.batch_idle_duration,
            batch_max_duration=opts.batch_max_duration,
            spot_to_spot_consolidation=opts.feature_gates.spot_to_spot_consolidation,
            node_repair=opts.feature_gates.node_repair,
            reserved_capacity=opts.feature_gates.reserved_capacity,
            leader_election=not opts.disable_leader_election,
            leader_election_name=opts.leader_election_name,
            leader_election_namespace=opts.leader_election_namespace
            or "kube-system",
            enable_profiling=opts.enable_profiling,
            solver_config=solver_config,
            solver_address=opts.solver_address,
            enable_tracing=opts.enable_tracing,
            trace_seed=opts.trace_seed,
            trace_path=opts.trace_path,
            metrics_dump_path=opts.metrics_dump_path,
        )


class Operator:
    def __init__(
        self,
        client: Client,
        cloud_provider,
        options: Optional[OperatorOptions] = None,
    ):
        self.options = options or OperatorOptions()
        self.client = client
        self.clock = client.clock
        self.cloud_provider = cloud_provider
        # decision-path tracing: one operator-scoped tracer on the
        # injected clock, installed process-globally so the solver seams
        # (driver/ops/service/wire) pick it up without explicit threading
        # — the same installation pattern the fault injector uses
        self.tracer = None
        if self.options.enable_tracing:
            self.tracer = obs.install(
                obs.Tracer(self.clock, seed=self.options.trace_seed)
            )
        self.recorder = Recorder(self.clock)
        self.cluster = Cluster(client)
        # the solver degradation ladder is operator-scoped: one SolverHealth
        # survives the per-solve TorchSolver instances (provisioning AND
        # disruption share it through the config), so breaker state and
        # cool-downs apply to the solver path as a whole
        solver_config = self.options.solver_config or SolverConfig()
        if solver_config.health is None:
            solver_config.health = SolverHealth(
                self.clock, recorder=self.recorder
            )
        self.options.solver_config = solver_config
        self.solver_health = solver_config.health
        # crashed controller passes requeue with exponential backoff
        # instead of hot-looping (or taking the whole roster down)
        self._requeue = RetryTracker(
            self.clock, initial=2.0, factor=2.0, max_delay=60.0
        )

        self.provisioner = Provisioner(
            client,
            cloud_provider,
            self.cluster,
            recorder=self.recorder,
            solver_config=self.options.solver_config,
            batch_idle_duration=self.options.batch_idle_duration,
            batch_max_duration=self.options.batch_max_duration,
            reserved_capacity_enabled=self.options.reserved_capacity,
            solver_address=self.options.solver_address or None,
        )
        self.lifecycle = LifecycleController(client, cloud_provider, self.recorder)
        self.termination = TerminationController(client, cloud_provider, self.recorder)
        self.nodeclaim_disruption = NodeClaimDisruptionController(client, cloud_provider)
        self.podevents = PodEventsController(client)
        self.disruption = DisruptionController(
            DisruptionContext(
                client=client,
                cluster=self.cluster,
                cloud_provider=cloud_provider,
                clock=self.clock,
                recorder=self.recorder,
                spot_to_spot_enabled=self.options.spot_to_spot_consolidation,
                solver_config=self.options.solver_config,
            ),
            provisioner=self.provisioner,
        )
        self.expiration = ExpirationController(client, self.recorder)
        self.garbage_collection = GarbageCollectionController(client, cloud_provider)
        self.health = HealthController(client, cloud_provider, self.cluster)
        self.consistency = ConsistencyController(client, self.recorder)
        self.nodepool_status = NodePoolStatusController(client, self.cluster)
        self.node_metrics = NodeMetricsController(client, self.cluster)
        self.nodepool_metrics = NodePoolMetricsController(client)
        self.pod_metrics = PodMetricsController(client, self.cluster)
        self.leader_elector = None
        self.profiler = None
        if self.options.leader_election:
            from .kube.leader import LeaderElector

            self.leader_elector = LeaderElector(
                client,
                name=self.options.leader_election_name,
                namespace=self.options.leader_election_namespace,
            )
        if self.options.enable_profiling:
            self._start_profiler()

    def _start_profiler(self) -> None:
        """torch.profiler over the operator's run — the pprof analog
        (operator.go:159-175): host activity, and the card's kernels where
        CUDA is available; ``shutdown()`` writes the Chrome trace."""
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        self.profiler.start()

    def is_leader(self) -> bool:
        return self.leader_elector is None or self.leader_elector.try_acquire()

    def _guarded(self, name: str, fn, *args, **kwargs) -> None:
        """Run one controller pass the way controller-runtime would: an
        exception is recorded (metric + event) and the controller requeues
        with exponential backoff instead of taking the roster down. The
        level-triggered loop makes the skip safe — nothing is lost, the
        next ready pass re-reads the store."""
        if not self._requeue.ready(name):
            return
        try:
            with obs.span(f"reconcile.{name}"):
                fn(*args, **kwargs)
        except Exception as exc:
            self._requeue.failure(name)
            RECONCILE_ERRORS.inc(
                labels={"controller": name, "error": type(exc).__name__}
            )
            self.recorder.publish(
                Event(
                    object_uid=f"controller/{name}",
                    type="Warning",
                    reason=REASON_RECONCILE_ERROR,
                    message=f"{name}: {type(exc).__name__}: {exc}",
                )
            )
            return
        self._requeue.success(name)

    def roster(
        self, force_provision: bool = False, force_disruption: bool = False
    ):
        """The ordered reconcile roster as (name, zero-arg callable)
        pairs — the stepping seam. ``step()`` consumes it; the cluster
        twin (sim/twin.py) iterates it directly so it can interleave
        trace events and sample per-controller wall latency without the
        roster order ever living in two places."""
        entries = []
        if hasattr(self.cloud_provider, "process_registrations"):
            entries.append(
                ("registrations", self.cloud_provider.process_registrations)
            )
        entries.append(
            (
                "provisioner",
                functools.partial(
                    self.provisioner.reconcile, force=force_provision
                ),
            )
        )
        entries.append(("lifecycle", self.lifecycle.reconcile_all))
        entries.append(("termination", self.termination.reconcile_all))
        entries.append(
            ("nodeclaim_disruption", self.nodeclaim_disruption.reconcile_all)
        )
        entries.append(
            ("nodepool_status", self.nodepool_status.reconcile_all)
        )
        entries.append(("expiration", self.expiration.reconcile_all))
        entries.append(
            ("garbage_collection", self.garbage_collection.reconcile)
        )
        if self.options.node_repair:
            entries.append(("health", self.health.reconcile_all))
        entries.append(("consistency", self.consistency.reconcile_all))
        entries.append(
            (
                "disruption",
                functools.partial(
                    self.disruption.reconcile, force=force_disruption
                ),
            )
        )
        entries.append(("node_metrics", self.node_metrics.reconcile_all))
        entries.append(
            ("nodepool_metrics", self.nodepool_metrics.reconcile_all)
        )
        entries.append(("pod_metrics", self.pod_metrics.reconcile_all))
        return entries

    def step(self, force_provision: bool = False, force_disruption: bool = False) -> None:
        """One reconcile pass over the roster. Non-leader replicas keep
        their watch-fed caches warm but do not reconcile
        (operator.go:137-141)."""
        if not self.is_leader():
            return
        for name, fn in self.roster(force_provision, force_disruption):
            self._guarded(name, fn)

    def run(self, duration: float, tick: float = 1.0) -> None:
        """Advance simulated time, stepping each tick (TestClock only)."""
        end = self.clock.now() + duration
        while self.clock.now() < end:
            self.step()
            self.clock.sleep(tick)

    def shutdown(self) -> None:
        """Flush observability artifacts (the reference dumps final metric
        state on SIGTERM the same way): the Prometheus exposition of
        metrics.REGISTRY and, with tracing on, the Chrome trace. Then
        release the process-global tracer installation."""
        from .metrics import REGISTRY

        # the card's memory goes with the operator's run, not with its last
        # reference: the residency stores of both encode caches and the
        # scenario simulators' cached solvers
        for cache in (self.provisioner._encode_cache, self.disruption.ctx.encode_cache):
            cache.release_device()
        self.disruption.ctx.scenario_envs.clear()
        if self.profiler is not None:
            self.profiler.stop()
            self.profiler.export_chrome_trace(
                profile_path(self.options.trace_path)
            )
            self.profiler = None
        if self.options.metrics_dump_path:
            REGISTRY.dump(self.options.metrics_dump_path)
        if self.tracer is not None:
            if self.options.trace_path:
                self.tracer.dump(self.options.trace_path)
            if obs.active() is self.tracer:
                obs.uninstall()
