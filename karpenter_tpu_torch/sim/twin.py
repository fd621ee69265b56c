# Copied from karpenter_tpu/sim/twin.py, 25 lines changed: TwinConfig.solver_config (each operator solves on its own copy of it, the SLO wall's oracle pack on it), 3 comment lines reworded.
"""Trace-driven cluster twin: deterministic day-scale churn replay.

The twin fuses the pieces the repo already has — the in-process
``kube.Client``, the kwok provider, the full operator roster
(``Operator.roster()``), the ``FaultInjector`` and the decision audit
trail — into one deterministic replay loop:

- a **churn trace** (sim/trace.py) supplies the outside world: pod
  creates/deletes, label flips, spot reclaims, ICE waves, node capacity
  edits, applied on the injected clock;
- **fault plans** interleave at the instrumented seams exactly as in the
  chaos soak (same ``FaultRule`` vocabulary, same seeded schedule);
- every **simulated minute** the SLO wall (sim/slo.py) is asserted over
  that minute's artifacts: the audit trail's decision window, wall-clock
  decision latencies, guard verdicts, fallback counters, and the store
  itself.

Determinism contract (pinned by tests/e2e/test_twin.py): same seed +
same trace + same fault plan ⇒ byte-identical **canonical audit
records** (:func:`canonical_audit`) and byte-identical **fault logs**.
The canonical form is the decision content of each record — it excludes
exactly the two warm-state provenance fields (``encode_reused``,
``delta_rows``), which legitimately differ between a warm continuation
and a cold resume while the *decisions* stay identical (the solver's
warm==cold contract), and ``trace_id``, whose RNG stream restarts with
the fresh tracer a resume builds. Everything else — decision ids,
timestamps (injected clock), durations (injected clock under tracing),
costs, rungs, guard verdicts, fault sites — must match to the byte.

``checkpoint()``/``resume()`` implement interruption: the checkpoint
captures the store (insertion order included), the clock, the twin RNG,
the injector (RNG + counters + log), the audit trail (sequence counter
included), provider-side residue (pending registrations, tombstones,
ICE cells), breaker/backoff state, and the consolidation memos. Resume
rebuilds a fresh operator over the restored store — solver warm state is
deliberately NOT checkpointed (the first post-resume solve re-encodes
from scratch; decisions are pinned identical warm or cold).
"""

from __future__ import annotations

import copy
import dataclasses
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import faults, obs
from ..api import labels as labels_mod
from ..api import resources as res
from ..api.objects import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
    Node,
    NodeClaim,
    NodeClaimSpec,
    NodeClaimTemplate,
    NodePool,
    NodePoolSpec,
    ObjectMeta,
    Pod,
    PodSpec,
)
from ..kube import Client, TestClock
from ..solver.driver import SolverConfig
from ..utils import pod as pod_utils
from .binder import Binder
from .slo import MinuteReport, SLOConfig, SLOViolationError, SLOWall
from .trace import (
    CAPACITY_EDIT,
    ICE_WAVE,
    LABEL_FLIP,
    POD_CREATE,
    POD_DELETE,
    SPOT_RECLAIM,
    TraceEvent,
)

_MI = 2**20 * res.MILLI


# -- bootstrap ---------------------------------------------------------------


@dataclass
class ClusterProfile:
    """The twin's base cluster, fabricated directly (the bench precedent,
    solver/workloads.py:build_consolidation_env): Initialized claims +
    registered Nodes + Running bound pods, sized so the fleet starts
    ~``utilization`` full. The kwok provider rehydrates its instances
    from the store, so the fabricated fleet is indistinguishable from one
    the roster launched."""

    nodes: int = 100
    pods_per_node: int = 8
    n_types: int = 24
    type_spread: int = 4  # distinct instance types across the fleet
    spot_fraction: float = 0.25
    utilization: float = 0.72
    seed: int = 0


def _eligible_types(its) -> list:
    out = [
        it
        for it in its
        if float(it.capacity.get(res.CPU, 0)) >= 4000
        and float(it.capacity.get(res.MEMORY, 0)) >= 8 * 1024 * _MI
        and any(o.available for o in it.offerings)
    ]
    out.sort(
        key=lambda it: min(
            (o.price for o in it.offerings if o.available), default=1e9
        )
    )
    return out


def bootstrap(client, its, profile: ClusterProfile) -> None:
    """Fabricate the base cluster into ``client``: one NodePool, then
    ``profile.nodes`` claims/nodes with ``pods_per_node`` Running pods
    each. Deterministic for a (profile, catalog) pair."""
    pool = NodePool(
        metadata=ObjectMeta(name="default"),
        spec=NodePoolSpec(
            template=NodeClaimTemplate(spec=NodeClaimSpec()),
        ),
    )
    # consolidation stays armed but lazy: the base fleet is sized to be
    # well-utilized, so disruption reconciles run without constantly
    # rewriting the cluster under the trace
    pool.spec.disruption.consolidate_after = 300.0
    client.create(pool)
    eligible = _eligible_types(its)
    if not eligible:
        raise ValueError("catalog has no bootstrap-eligible instance types")
    # cheapest eligible types: the fabricated fleet starts near the
    # oracle pack's price band, so the cost SLO measures DRIFT under
    # churn (the thing a twin can regress on), not the fabrication gap
    chosen = eligible[: max(1, profile.type_spread)]
    clock = client.clock
    now = clock.now()
    for i in range(profile.nodes):
        it = chosen[i % len(chosen)]
        offs = [o for o in it.offerings if o.available]
        spot = [o for o in offs if o.capacity_type() == "spot"]
        od = [o for o in offs if o.capacity_type() != "spot"]
        if spot and (i < profile.spot_fraction * profile.nodes or not od):
            offering = min(spot, key=lambda o: o.price)
        else:
            offering = min(od or offs, key=lambda o: o.price)
        name = f"twin-{i}"
        pid = f"kwok://{name}-{i + 1}"
        node_labels = {
            labels_mod.HOSTNAME: name,
            labels_mod.INSTANCE_TYPE: it.name,
            labels_mod.TOPOLOGY_ZONE: offering.zone(),
            labels_mod.CAPACITY_TYPE_LABEL_KEY: offering.capacity_type(),
            labels_mod.NODEPOOL_LABEL_KEY: pool.name,
        }
        claim = NodeClaim(
            metadata=ObjectMeta(name=name, labels=dict(node_labels)),
            spec=NodeClaimSpec(),
        )
        claim.status.provider_id = pid
        claim.status.capacity = dict(it.capacity)
        claim.status.allocatable = dict(it.allocatable())
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED):
            claim.conds().set(cond, "True", now=now)
        node = Node(
            metadata=ObjectMeta(name=name, labels=dict(node_labels)),
            provider_id=pid,
        )
        node.status.capacity = dict(it.capacity)
        node.status.allocatable = dict(it.allocatable())
        node.status.ready = True
        client.create(claim)
        client.create(node)
        # fillers: pods_per_node Running pods totalling ~utilization of
        # the node's cpu, memory scaled to match. Shapes are QUANTIZED to
        # a small per-type set (a fleet runs deployments of identical
        # pods, not 20k unique shapes): the solver's group axis G stays
        # in the tens, the realistic regime the bench grid pins — per-pod
        # random jitter would silently turn the twin into the group-heavy
        # diverse-ref shape at 20x the kernel cost
        cpu_alloc = float(it.allocatable().get(res.CPU, 0))
        mem_alloc = float(it.allocatable().get(res.MEMORY, 0))
        per_cpu = int(cpu_alloc * profile.utilization / profile.pods_per_node)
        per_mem = int(mem_alloc * profile.utilization / profile.pods_per_node)
        for j in range(profile.pods_per_node):
            scale = (0.75, 1.0, 1.25)[(i + j) % 3]
            pod = Pod(
                metadata=ObjectMeta(
                    name=f"base-{i}-{j}",
                    labels={"ktpu.io/twin-base": "true"},
                ),
                spec=PodSpec(
                    requests={
                        res.CPU: max(50, int(per_cpu * scale)),
                        res.MEMORY: max(int(64 * _MI), int(per_mem * scale)),
                    },
                    node_name=name,
                ),
            )
            pod.status.phase = "Running"
            client.create(pod)


# -- the twin ----------------------------------------------------------------


@dataclass
class TwinConfig:
    seed: int = 0
    minutes: int = 10
    steps_per_minute: int = 2
    slo: SLOConfig = field(default_factory=SLOConfig)
    # raise SLOViolationError at the first failing minute (the regression
    # wall); False collects reports for offline inspection (bench.py)
    assert_slos: bool = True
    # deterministic per-pass consolidation probe cap
    # (DisruptionContext.probe_budget): the injected clock stands still
    # inside a roster pass, so the reference's wall-clock sweep timeouts
    # never fire here — without a cap a 2k-node single-node sweep would
    # probe every candidate every pass. None = uncapped.
    probe_budget: Optional[int] = 48
    # the operator's solver: None is SolverConfig's default, the card,
    # raising where there is none, as every entry point of the port does
    # (the tests pass SolverConfig(device="cpu")). Each operator gets its
    # own copy without a SolverHealth: Operator writes a fresh one into the
    # config it is given, and a resumed twin's operator must hold the
    # health its checkpoint restores, not the interrupted run's
    solver_config: Optional[SolverConfig] = None


class ClusterTwin:
    """One deterministic replay: trace + fault plan + SLO wall over the
    full operator roster. Use as a context manager, or call ``close()`` —
    the twin installs process-global seams (fault injector, tracer via
    the operator, a fresh audit log) that must be released."""

    def __init__(
        self,
        trace: Sequence[TraceEvent],
        profile: Optional[ClusterProfile] = None,
        config: Optional[TwinConfig] = None,
        fault_rules: Optional[Callable[[object], List[faults.FaultRule]]] = None,
        _restore: Optional[dict] = None,
    ):
        from ..cloudprovider import corpus
        from ..cloudprovider.kwok import KwokCloudProvider
        from ..operator import Operator, OperatorOptions

        self.trace = sorted(trace, key=lambda e: e.t)
        self.profile = profile or ClusterProfile()
        self.config = config or TwinConfig()
        # this operator's own copy of the solver config, made before any
        # process-global seam is installed: without a card the default
        # raises here
        solver_config = (
            dataclasses.replace(self.config.solver_config, health=None)
            if self.config.solver_config is not None
            else SolverConfig()
        )
        self._fault_rules = fault_rules
        self.clock = TestClock()
        self.client = Client(self.clock)
        self._its = corpus.generate(self.profile.n_types)
        if _restore is None:
            bootstrap(self.client, self._its, self.profile)
        else:
            self.clock.set(_restore["clock"])
            self.client.import_objects(_restore["store"])
        # the replay origin: trace event times and fault-plan schedules
        # are all relative to it. A resumed twin must rebuild the SAME
        # plan the interrupted run had, so fault_rules below receives a
        # clock frozen at the ORIGIN, never the live (restored) clock —
        # anchoring a plan's `until` at resume time would stretch the
        # fault window and fork the replay.
        self._t0 = (
            float(_restore["t0"]) if _restore is not None else self.clock.now()
        )
        self.provider = KwokCloudProvider(self.client, self._its)
        self.operator = Operator(
            self.client,
            self.provider,
            options=OperatorOptions(
                enable_tracing=True, trace_seed=self.config.seed,
                solver_config=solver_config,
            ),
        )
        if self.config.probe_budget is not None:
            self.operator.disruption.ctx.probe_budget = (
                self.config.probe_budget
            )
        self.binder = Binder(self.client)
        # fresh process-global audit trail: decision ids start at d000001
        # for every run, so canonical artifacts compare across runs
        self.audit = obs.install_audit()
        self.injector = None
        if fault_rules is not None:
            self.injector = faults.install(
                faults.FaultInjector(
                    fault_rules(TestClock(start=self._t0)),
                    seed=self.config.seed,
                    clock=self.clock,
                )
            )
        # the twin's own RNG: runtime-dependent event targets (which spot
        # node, which ICE cells, which node's capacity drifts) draw here
        self.rng = random.Random(self.config.seed * 7919 + 13)
        self.slo_wall = SLOWall(
            self.config.slo, solver_config=self.config.solver_config
        )
        self.reports: List[MinuteReport] = []
        # trace replay position (self._t0, the replay origin, is set above
        # before the fault plan is built)
        self._cursor = 0
        self._minute = 0
        # applied-weather telemetry (assertions + the bench twin row)
        self.reclaimed = 0
        self.iced_cells = 0
        # tracked workload: name -> spec template; the twin plays the
        # ReplicaSet role for both base and churn pods (drained pods are
        # recreated with the same name, deterministic either way)
        self._workload: Dict[str, dict] = {}
        if _restore is None:
            for pod in self.client.list(Pod):
                self._track(pod)
        # wall-clock decision-latency sampler: joined to audit appends via
        # the on_record observer; never written into the records (those
        # stay byte-deterministic)
        self._lat_window: List[float] = []
        self._perf_mark = time.perf_counter()
        self._wall_spent = 0.0  # roster wall time, for bench solves/sec
        self.audit.on_record(self._on_audit_record)
        self._closed = False
        if _restore is not None:
            try:
                self._restore_runtime(_restore)
            except BaseException:
                # a refused resume must not leak the process-global
                # seams the constructor already installed
                self.close()
                raise

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "ClusterTwin":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.audit.remove_observer(self._on_audit_record)
        if self.injector is not None and faults.active() is self.injector:
            faults.uninstall()
        self.operator.shutdown()
        obs.uninstall_audit()

    # -- workload tracking -------------------------------------------------

    def _track(self, pod: Pod) -> None:
        self._workload[pod.metadata.name] = {
            "cpu": pod.spec.requests.get(res.CPU, 0),
            "memory": pod.spec.requests.get(res.MEMORY, 0),
            "labels": dict(pod.metadata.labels),
            "deleted": False,
        }

    def _make_tracked_pod(self, name: str) -> Pod:
        spec = self._workload[name]
        pod = Pod(
            metadata=ObjectMeta(name=name, labels=dict(spec["labels"])),
            spec=PodSpec(
                requests={
                    res.CPU: spec["cpu"],
                    res.MEMORY: spec["memory"],
                }
            ),
        )
        pod.status.phase = "Pending"
        return pod

    def _reconcile_workload(self) -> int:
        """The ReplicaSet role: recreate tracked pods the drain deleted
        (same name, fresh uid). Returns how many were recreated."""
        live = {p.metadata.name for p in self.client.list(Pod)}
        created = 0
        for name, spec in self._workload.items():
            if spec["deleted"] or name in live:
                continue
            self.client.create(self._make_tracked_pod(name))
            created += 1
        return created

    # -- trace application -------------------------------------------------

    def _apply_due_events(self, until_t: float) -> int:
        """Apply every trace event with ``t`` <= ``until_t`` (relative to
        the replay origin) that hasn't been applied yet."""
        applied = 0
        while (
            self._cursor < len(self.trace)
            and self.trace[self._cursor].t <= until_t
        ):
            self._apply_event(self.trace[self._cursor])
            self._cursor += 1
            applied += 1
        return applied

    def _apply_event(self, ev: TraceEvent) -> None:
        if ev.kind == POD_CREATE:
            for k in range(max(1, ev.count)):
                name = ev.name if ev.count <= 1 else f"{ev.name}-{k}"
                pod = Pod(
                    metadata=ObjectMeta(name=name, labels=dict(ev.labels)),
                    spec=PodSpec(
                        requests={
                            res.CPU: ev.cpu_m,
                            res.MEMORY: ev.mem_mi * _MI,
                        }
                    ),
                )
                pod.status.phase = "Pending"
                self.client.create(pod)
                self._track(pod)
        elif ev.kind == POD_DELETE:
            spec = self._workload.get(ev.name)
            if spec is not None:
                spec["deleted"] = True
            pod = self.client.try_get(Pod, ev.name)
            if pod is not None:
                self.client.delete(pod)
        elif ev.kind == LABEL_FLIP:
            spec = self._workload.get(ev.name)
            if spec is not None:
                spec["labels"][ev.key] = ev.value
            pod = self.client.try_get(Pod, ev.name)
            if pod is not None:
                pod.metadata.labels[ev.key] = ev.value
                self.client.update(pod)
        elif ev.kind == SPOT_RECLAIM:
            self._apply_spot_reclaim(ev)
        elif ev.kind == ICE_WAVE:
            self._apply_ice_wave(ev)
        elif ev.kind == CAPACITY_EDIT:
            self._apply_capacity_edit(ev)
        else:  # pragma: no cover - from_dict validates kinds
            raise ValueError(f"unknown trace event kind {ev.kind!r}")

    def _apply_spot_reclaim(self, ev: TraceEvent) -> None:
        """The cloud takes back ``count`` spot instances: provider-side
        termination only; the roster's GC/termination path must notice
        and re-provision."""
        spot_nodes = sorted(
            n.name
            # indexed read (kube/store.py label index): only the spot
            # nodes, not the whole 100k-node roster
            for n in self.client.list(
                Node,
                label_selector={labels_mod.CAPACITY_TYPE_LABEL_KEY: "spot"},
            )
            if n.provider_id and n.metadata.deletion_timestamp is None
        )
        if not spot_nodes:
            return
        picks = self.rng.sample(spot_nodes, min(ev.count, len(spot_nodes)))
        for name in picks:
            node = self.client.try_get(Node, name)
            if node is not None and node.provider_id:
                if self.provider.reclaim(node.provider_id):
                    self.reclaimed += 1

    def _apply_ice_wave(self, ev: TraceEvent) -> None:
        """``count`` offering cells go insufficient-capacity for ``ttl``
        seconds: the provider's ICE cache masks them, the solver routes
        around them until the TTL lapses."""
        cells = sorted(
            {
                (it.name, o.zone(), o.capacity_type())
                for it in self._its
                for o in it.offerings
                if o.available
            }
        )
        if not cells:
            return
        picks = self.rng.sample(cells, min(ev.count, len(cells)))
        cache = self.provider.ice_cache
        old_ttl = cache.ttl
        cache.ttl = ev.ttl or old_ttl
        try:
            for it_name, zone, ct in picks:
                cache.mark_unavailable(it_name, zone, ct)
                self.iced_cells += 1
        finally:
            cache.ttl = old_ttl

    def _apply_capacity_edit(self, ev: TraceEvent) -> None:
        """One node's allocatable drifts to ``scale`` of its capacity
        (system-reserved growth, kubelet reconfig), clamped so the drift
        never manufactures overcommit — that's the guard's jurisdiction,
        not the trace's."""
        names = sorted(
            n.name
            for n in self.client.list(Node)
            if n.metadata.deletion_timestamp is None
        )
        if not names:
            return
        name = names[self.rng.randrange(len(names))]
        node = self.client.try_get(Node, name)
        if node is None:
            return
        pods = [
            p
            for p in self.client.list(
                Pod, field_selector={"spec.nodeName": name}
            )
            if pod_utils.is_active(p)
        ]
        used = res.merge(*(p.spec.requests for p in pods)) if pods else {}
        new_alloc = dict(node.status.allocatable)
        for r in (res.CPU, res.MEMORY):
            cap = float(node.status.capacity.get(r, 0))
            new_alloc[r] = int(max(float(used.get(r, 0)), cap * ev.scale))
        node.status.allocatable = new_alloc
        self.client.update(node)

    # -- the replay loop ---------------------------------------------------

    def _harness_writes(self):
        """Context: the twin's own store writes (trace application, the
        ReplicaSet role, the binder) model the OUTSIDE WORLD — the cloud
        reclaiming an instance, the kubelet binding a pod — not the
        control plane under test, so the fault plan must not crash them
        (the chaos suite's `_operator_kinds` convention, generalized).
        Site call counters still advance while quieted, so the fault
        schedule stays deterministic."""
        import contextlib

        @contextlib.contextmanager
        def quiet():
            inj = faults.active()
            if inj is None:
                yield
                return
            prev = inj.enabled
            inj.enabled = False
            try:
                yield
            finally:
                inj.enabled = prev

        return quiet()

    def _on_audit_record(self, rec) -> None:
        now = time.perf_counter()
        self._lat_window.append((now - self._perf_mark) * 1000.0)
        self._perf_mark = now

    def _roster_pass(self) -> None:
        t0 = time.perf_counter()
        for name, fn in self.operator.roster(force_provision=True):
            self._perf_mark = time.perf_counter()
            self.operator._guarded(name, fn)
        self._wall_spent += time.perf_counter() - t0

    def run(self) -> List[MinuteReport]:
        """Replay every remaining simulated minute; returns the per-minute
        reports. Raises :class:`SLOViolationError` at the first failing
        minute when ``config.assert_slos``."""
        while self._minute < self.config.minutes:
            self.run_minute()
        return self.reports

    def run_minute(self) -> MinuteReport:
        """One simulated minute: ``steps_per_minute`` roster passes with
        due trace events applied before each, then the SLO wall."""
        from ..controllers.provisioning import SEQUENTIAL_FALLBACK

        m = self._minute
        window_start = self._t0 + m * 60.0
        window_end = window_start + 60.0
        fallback0 = SEQUENTIAL_FALLBACK.value()
        delta_fb0 = self.operator.solver_health.delta_fallbacks
        self._lat_window = []
        step_len = 60.0 / self.config.steps_per_minute
        for step in range(self.config.steps_per_minute):
            target = window_start + (step + 1) * step_len
            with self._harness_writes():
                self._apply_due_events(target - self._t0)
                self._reconcile_workload()
            self._roster_pass()
            with self._harness_writes():
                self.binder.bind_all()
            if self.clock.now() < target:
                self.clock.set(target)
        report = self.slo_wall.evaluate(
            minute=m,
            client=self.client,
            provider=self.provider,
            now=self.clock.now(),
            records=self.audit.window(window_start, window_end),
            latencies_ms=list(self._lat_window),
            fallback_delta=int(SEQUENTIAL_FALLBACK.value() - fallback0),
            delta_fallback_delta=(
                self.operator.solver_health.delta_fallbacks - delta_fb0
            ),
        )
        self.reports.append(report)
        self._minute += 1
        if self.config.assert_slos and report.violations:
            raise SLOViolationError(report)
        return report

    # -- bench accessors ---------------------------------------------------

    def roster_wall_s(self) -> float:
        """Wall-clock seconds spent in roster passes (bootstrap, SLO
        sweeps, and trace application excluded) — the replay-loop cost
        the bench twin row's ``best_ms`` gates."""
        return self._wall_spent

    def solves_per_sec(self) -> float:
        """Sustained decision throughput: audit records per second of
        roster wall time (the bench.py twin row's headline)."""
        n = len(self.audit.query())
        return n / self._wall_spent if self._wall_spent > 0 else 0.0

    def worst_minute(self) -> Optional[MinuteReport]:
        if not self.reports:
            return None
        return max(self.reports, key=lambda r: r.p99_latency_ms)

    # -- determinism artifacts ---------------------------------------------

    def canonical_audit(self) -> bytes:
        return canonical_audit(self.audit.query())

    def fault_log(self) -> List[Tuple[str, int, int]]:
        return list(self.injector.log) if self.injector is not None else []

    # -- checkpoint / resume -----------------------------------------------

    def checkpoint(self) -> dict:
        """A picklable snapshot of the replay at the CURRENT minute
        boundary (call between run_minute() calls). Solver warm state
        (EncodeCache banks, device buffers) is deliberately excluded: the
        solver's contract pins warm and cold decisions identical, so a cold
        resume replays the same decisions."""
        op = self.operator
        methods_state = []
        for method in op.disruption.methods:
            methods_state.append(
                {
                    "last_consolidation_state": getattr(
                        method, "_last_consolidation_state", None
                    ),
                    "unseen_pools": set(
                        getattr(method, "previously_unseen_node_pools", ())
                    ),
                    "suppress": getattr(method, "suppress_memoization", False),
                }
            )
        return {
            "minute": self._minute,
            "t0": self._t0,
            "clock": self.clock.now(),
            "cursor": self._cursor,
            "store": self.client.export_objects(),
            "rng": self.rng.getstate(),
            "workload": copy.deepcopy(self._workload),
            "reports": [r.as_dict() for r in self.reports],
            "audit": self.audit.export_state(),
            "injector": (
                self.injector.export_state()
                if self.injector is not None
                else None
            ),
            "provider": self.provider.export_state(),
            "health": op.solver_health.export_state(),
            "requeue": op._requeue.export_state(),
            "lifecycle_retries": (
                op.lifecycle._launch_retry.export_state(),
                op.lifecycle._delete_retry.export_state(),
            ),
            "store_backoff_rng": op.provisioner._store_backoff.export_rng(),
            "cluster": op.cluster.export_state(),
            "consolidation": {
                "methods": methods_state,
                "queue": copy.deepcopy(op.disruption.queue.items),
                # a command awaiting its validation TTL references the
                # METHOD that computed it — checkpoint the method's index
                # in the roster, not the object (it drags the whole
                # DisruptionContext, RLocks included, into the pickle);
                # restore re-binds to the LIVE method at that index
                "pending": (
                    (
                        copy.deepcopy(op.disruption._pending[0]),
                        op.disruption._pending[1],
                        op.disruption.methods.index(
                            op.disruption._pending[2]
                        ),
                    )
                    if op.disruption._pending is not None
                    else None
                ),
            },
            "wall_spent": self._wall_spent,
        }

    def _restore_runtime(self, ckpt: dict) -> None:
        op = self.operator
        self._minute = int(ckpt["minute"])
        self._t0 = float(ckpt["t0"])
        self._cursor = int(ckpt["cursor"])
        self.rng.setstate(ckpt["rng"])
        self._workload = copy.deepcopy(ckpt["workload"])
        self._wall_spent = float(ckpt.get("wall_spent", 0.0))
        self.audit.restore_state(ckpt["audit"])
        if ckpt["injector"] is not None:
            if self.injector is None:
                # resuming a chaos replay WITHOUT its fault plan would
                # silently fork the byte-identical contract — the plan is
                # part of the replay's identity, like the trace
                raise ValueError(
                    "checkpoint carries fault-injector state; resume() "
                    "needs the same fault_rules the interrupted run used"
                )
            self.injector.restore_state(ckpt["injector"])
        self.provider.restore_state(ckpt["provider"])
        op.solver_health.restore_state(ckpt["health"])
        op._requeue.restore_state(ckpt["requeue"])
        launch, delete = ckpt["lifecycle_retries"]
        op.lifecycle._launch_retry.restore_state(launch)
        op.lifecycle._delete_retry.restore_state(delete)
        op.provisioner._store_backoff.restore_rng(ckpt["store_backoff_rng"])
        op.cluster.restore_state(ckpt["cluster"])
        cons = ckpt["consolidation"]
        for method, ms in zip(op.disruption.methods, cons["methods"]):
            if ms["last_consolidation_state"] is not None:
                method._last_consolidation_state = ms[
                    "last_consolidation_state"
                ]
            if hasattr(method, "previously_unseen_node_pools"):
                method.previously_unseen_node_pools = set(ms["unseen_pools"])
            if hasattr(method, "suppress_memoization"):
                method.suppress_memoization = ms["suppress"]
        op.disruption.queue.items = copy.deepcopy(cons["queue"])
        if cons["pending"] is not None:
            cmd, computed_at, method_idx = cons["pending"]
            op.disruption._pending = (
                copy.deepcopy(cmd),
                computed_at,
                op.disruption.methods[method_idx],
            )
        else:
            op.disruption._pending = None

    @classmethod
    def resume(
        cls,
        ckpt: dict,
        trace: Sequence[TraceEvent],
        profile: Optional[ClusterProfile] = None,
        config: Optional[TwinConfig] = None,
        fault_rules=None,
    ) -> "ClusterTwin":
        """Rebuild a twin from ``checkpoint()`` output plus the SAME
        trace/profile/config/fault plan the interrupted run used (the
        checkpoint carries state, not configuration — configuration is
        the replay's identity)."""
        return cls(
            trace,
            profile=profile,
            config=config,
            fault_rules=fault_rules,
            _restore=ckpt,
        )


# -- canonical audit ---------------------------------------------------------

_CANONICAL_FIELDS = (
    "decision_id", "kind", "timestamp", "duration_ms", "encode_hash",
    "pods", "claims", "errors", "scenario_count", "dispatches", "rung",
    "guard", "cost", "fault_sites", "oracle_cost", "attrs",
)


def canonical_audit(records) -> bytes:
    """The byte-stable decision-content serialization of audit records —
    the replay-determinism artifact. Excludes ``trace_id`` (fresh tracer
    RNG after a resume) and the warm-state provenance pair
    ``encode_reused``/``delta_rows`` (legitimately warm-vs-cold), per the
    module docstring's contract."""
    import json

    lines = []
    for r in records:
        d = {f: getattr(r, f) for f in _CANONICAL_FIELDS}
        lines.append(json.dumps(d, sort_keys=True, default=str))
    return ("\n".join(lines) + "\n").encode()


__all__ = [
    "ClusterProfile", "TwinConfig", "ClusterTwin", "bootstrap",
    "canonical_audit",
]
