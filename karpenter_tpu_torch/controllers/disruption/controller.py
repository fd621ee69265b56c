# Copied from karpenter_tpu/controllers/disruption/controller.py, 1 comment line reworded.
"""The disruption controller and orchestration queue.

Mirror of the reference's disruption/controller.go:54-323 and
orchestration/queue.go:57-189: every cycle gates on cluster sync, un-taints
leftovers, then tries Drift -> Emptiness -> MultiNode -> SingleNode in order,
stopping at the first command; executeCommand taints candidates, launches
replacements, and hands the command to the async queue which waits for
replacements to initialize before deleting the candidates.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...api import labels as labels_mod
from ...api import taints as taints_mod
from ...api.objects import (
    COND_DISRUPTION_REASON,
    COND_INITIALIZED,
    Node,
    NodeClaim,
    NodePool,
    Taint,
)
from ...events import Event, Recorder
from ...kube import Client, NotFoundError
from ...metrics import Counter, Gauge
from ..state import Cluster
from .helpers import build_budget_mapping, get_candidates
from .methods import (
    Drift,
    Emptiness,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from .types import Candidate, Command
from .validation import VALIDATION_TTL, Validator

POLL_INTERVAL = 10.0  # controller.go:68
QUEUE_BASE_DELAY = 1.0  # orchestration/queue.go:51-55
QUEUE_MAX_DELAY = 10.0
QUEUE_TIMEOUT = 600.0

DECISIONS = Counter("disruption_decisions_total", "")
ELIGIBLE_NODES = Gauge("disruption_eligible_nodes", "")
ALLOWED_DISRUPTIONS = Gauge("disruption_allowed_disruptions", "")
VALIDATION_FAILURES = Counter(
    "disruption_validation_failures_total",
    "Commands abandoned because TTL re-validation found stale state",
)


@dataclass
class DisruptionContext:
    client: Client
    cluster: Cluster
    cloud_provider: object
    clock: object
    recorder: Recorder
    spot_to_spot_enabled: bool = False
    # the operator's SolverConfig (backend/mesh selection): every
    # scheduling simulation this engine runs must use the same solver the
    # provisioner does
    solver_config: object = None
    # one catalog-fingerprinted encode cache shared by every scheduling
    # simulation this engine runs: the multi-node binary search's O(log n)
    # probes (methods.py) and the 15s-TTL validation re-simulations all hit
    # the same instance-type/template catalog, so the vocab + static arrays
    # encode once per catalog change instead of once per probe
    encode_cache: object = None
    # scenario-batched consolidation probes (methods.py): None = on unless
    # KTPU_SCENARIO_BATCH=0; True/False force. The sequential per-probe
    # loop remains the fallback and the semantic reference either way.
    scenario_batch: object = None
    # deterministic per-pass probe cap for the consolidation searches.
    # The reference bounds them by WALL-clock timeouts
    # (multinodeconsolidation.go:36, singlenodeconsolidation.go:34); under
    # an injected clock simulated time stands still inside a reconcile
    # pass, so a twin replaying a 2k-node cluster would sweep every
    # candidate every pass. A probe budget is the deterministic analog:
    # the sweep stops after N probes with the same resume semantics a
    # timeout has (suppress_memoization + previously_unseen_node_pools).
    # None = unbounded (production wall-clock bounds still apply).
    probe_budget: object = None
    # content-keyed cache of built ScenarioSimulator environments
    # (helpers.ScenarioEnvCache): consolidation searches over an
    # unchanged cluster/workload reuse the built Topology + solver and
    # warm encode instead of re-paying the ~130 ms scenario.build per
    # fresh environment (the dominant fixed cost of
    # a 2k-node twin minute).
    scenario_envs: object = None

    def __post_init__(self):
        if self.encode_cache is None:
            from ...solver.driver import EncodeCache

            self.encode_cache = EncodeCache()
        if self.scenario_envs is None:
            from .helpers import ScenarioEnvCache

            self.scenario_envs = ScenarioEnvCache()


@dataclass
class QueueItem:
    command: Command
    replacement_names: List[str]
    added_at: float
    attempts: int = 0
    next_try: float = 0.0


class OrchestrationQueue:
    """Async command completion (orchestration/queue.go)."""

    def __init__(self, ctx: DisruptionContext, provisioner=None):
        self.ctx = ctx
        self.items: List[QueueItem] = []

    def has_provider_id(self, provider_id: str) -> bool:
        return any(
            c.provider_id == provider_id
            for item in self.items
            for c in item.command.candidates
        )

    def add(self, command: Command, replacement_names: List[str]) -> None:
        self.items.append(
            QueueItem(command, replacement_names, self.ctx.clock.now())
        )

    def reconcile(self) -> None:
        now = self.ctx.clock.now()
        remaining = []
        for item in self.items:
            if now < item.next_try:
                remaining.append(item)
                continue
            done = self._process(item, now)
            if not done:
                remaining.append(item)
        self.items = remaining

    def _process(self, item: QueueItem, now: float) -> bool:
        if now - item.added_at > QUEUE_TIMEOUT:
            self._fail(item, "timed out waiting for replacements")
            return True
        # all replacements must be Initialized before candidates die
        for name in item.replacement_names:
            claim = self.ctx.client.try_get(NodeClaim, name)
            if claim is None:
                self._fail(item, f"replacement {name} disappeared")
                return True
            if not claim.conds().is_true(COND_INITIALIZED):
                item.attempts += 1
                item.next_try = now + min(
                    QUEUE_BASE_DELAY * 2 ** min(item.attempts, 10), QUEUE_MAX_DELAY
                )
                return False
        for candidate in item.command.candidates:
            # try_get -> delete races the lifecycle thread's finalizer
            # removal; a candidate vanishing mid-step is the desired
            # outcome, not an error (queue.go runs client.IgnoreNotFound)
            try:
                claim = self.ctx.client.try_get(NodeClaim, candidate.node_claim.name)
                if claim is not None and claim.metadata.deletion_timestamp is None:
                    self.ctx.client.delete(claim)
            except NotFoundError:
                pass
            try:
                node = self.ctx.client.try_get(Node, candidate.node.name)
                if node is not None and node.metadata.deletion_timestamp is None:
                    self.ctx.client.delete(node)
            except NotFoundError:
                pass
        DECISIONS.inc(
            labels={
                "decision": item.command.decision,
                "reason": item.command.reason.lower() or "unknown",
            }
        )
        return True

    def _fail(self, item: QueueItem, message: str) -> None:
        """Un-taint candidates and release state marks (queue.go failures)."""
        for candidate in item.command.candidates:
            node = self.ctx.client.try_get(Node, candidate.node.name)
            if node is not None:
                _remove_disruption_taint(self.ctx.client, node)
            self.ctx.cluster.unmark_for_deletion(candidate.provider_id)
            self.ctx.recorder.publish(
                Event(candidate.node_claim.uid, "Warning", "DisruptionFailed", message)
            )


def _remove_disruption_taint(client: Client, node: Node) -> None:
    before = len(node.taints)
    node.taints = [
        t for t in node.taints if t.key != labels_mod.DISRUPTED_TAINT_KEY
    ]
    if len(node.taints) != before:
        try:
            client.update(node)
        except NotFoundError:
            pass  # terminated concurrently; taint is moot


class DisruptionController:
    def __init__(
        self,
        ctx: DisruptionContext,
        provisioner=None,
    ):
        self.ctx = ctx
        self.provisioner = provisioner
        self.queue = OrchestrationQueue(ctx)
        self.validator = Validator(ctx)
        # consolidation command awaiting its TTL re-validation
        # (validation.go:56-215): (command, computed_at, method)
        self._pending: Optional[Tuple[Command, float, object]] = None
        self.methods = [
            Drift(ctx),
            Emptiness(ctx.clock),
            MultiNodeConsolidation(ctx),
            SingleNodeConsolidation(ctx),
        ]
        self._last_run = -POLL_INTERVAL

    def reconcile(self, force: bool = False) -> Optional[Command]:
        now = self.ctx.clock.now()
        self.queue.reconcile()
        if not force and now - self._last_run < POLL_INTERVAL:
            return None
        self._last_run = now
        if not self.ctx.cluster.synced():
            return None
        self._untaint_leftovers()
        if self._pending is not None:
            # a consolidation command is waiting out its validation TTL;
            # the operator loop keeps running meanwhile (the reference
            # blocks only its disruption goroutine, validation.go:56-83)
            cmd, computed_at, method = self._pending
            if now - computed_at < VALIDATION_TTL:
                return None
            self._pending = None
            stale = self.validator.is_valid(cmd, queue=self.queue, method=method)
            if stale is None:
                self.execute(cmd)
                return cmd
            VALIDATION_FAILURES.inc(labels={"method": cmd.reason})
            self.ctx.recorder.publish(
                Event(
                    cmd.candidates[0].node_claim.uid if cmd.candidates else "",
                    "Normal",
                    "DisruptionValidationFailed",
                    stale,
                )
            )
            # fall through: recompute from fresh state this pass
        for method in self.methods:
            cmd = self._disrupt(method)
            if cmd is not None and cmd.decision != "no-op":
                return cmd
        return None

    def _untaint_leftovers(self) -> None:
        """Remove disruption taints from nodes not tracked by the queue
        (controller.go:124-141) — crash recovery idempotence."""
        for node in self.ctx.client.list(Node):
            if node.metadata.deletion_timestamp is not None:
                continue
            has_taint = any(
                t.key == labels_mod.DISRUPTED_TAINT_KEY for t in node.taints
            )
            if has_taint and not self.queue.has_provider_id(node.provider_id):
                _remove_disruption_taint(self.ctx.client, node)

    def _disrupt(self, method) -> Optional[Command]:
        now = self.ctx.clock.now()
        candidates = get_candidates(
            self.ctx.client,
            self.ctx.cluster,
            self.ctx.cloud_provider,
            self.ctx.clock,
            queue=self.queue,
        )
        candidates = [c for c in candidates if method.should_disrupt(c)]
        ELIGIBLE_NODES.set(float(len(candidates)), labels={"method": method.reason})
        if not candidates:
            return None
        if hasattr(method, "is_consolidated") and method.is_consolidated():
            return None
        budgets = build_budget_mapping(
            self.ctx.client, self.ctx.cluster, method.reason, now
        )
        for pool, allowed in budgets.items():
            ALLOWED_DISRUPTIONS.set(float(allowed), labels={"nodepool": pool})
        cmd = method.compute_command(candidates, budgets)
        if cmd.decision == "no-op":
            if hasattr(method, "mark_consolidated") and not getattr(
                method, "suppress_memoization", False
            ):
                method.mark_consolidated()
            return cmd
        if method.reason in ("Empty", "Underutilized"):
            # consolidation acts only after surviving the TTL re-validation
            # on a later pass (validation.go:56-215); drift skips validation
            self._pending = (cmd, now, method)
            return cmd
        self.execute(cmd)
        return cmd

    # -- executeCommand (controller.go:199-247) ---------------------------

    def execute(self, command: Command) -> None:
        now = self.ctx.clock.now()
        for candidate in command.candidates:
            node = self.ctx.client.try_get(Node, candidate.node.name)
            if node is not None and not any(
                t.key == labels_mod.DISRUPTED_TAINT_KEY for t in node.taints
            ):
                node.taints.append(
                    Taint(
                        key=labels_mod.DISRUPTED_TAINT_KEY,
                        effect=taints_mod.NO_SCHEDULE,
                    )
                )
                try:
                    self.ctx.client.update(node)
                except NotFoundError:
                    pass  # terminated concurrently
            candidate.node_claim.conds().set(
                COND_DISRUPTION_REASON, "True", command.reason, now=now
            )
            try:
                self.ctx.client.update_status(candidate.node_claim)
            except NotFoundError:
                pass  # finalized concurrently
            self.ctx.cluster.mark_for_deletion(candidate.provider_id)
            self.ctx.recorder.publish(
                Event(
                    candidate.node_claim.uid,
                    "Normal",
                    "DisruptionLaunching",
                    f"disrupting node via {command.reason}",
                )
            )
        try:
            replacement_names = self._launch_replacements(command)
        except ValueError as exc:
            # launch refusal (e.g. minValues unmet after the replacement's
            # option filtering): roll back so candidates aren't stranded
            # cordoned — the reference un-taints on launch failure
            # (controller.go:219-231)
            for candidate in command.candidates:
                node = self.ctx.client.try_get(Node, candidate.node.name)
                if node is not None:
                    node.taints = [
                        t
                        for t in node.taints
                        if t.key != labels_mod.DISRUPTED_TAINT_KEY
                    ]
                    try:
                        self.ctx.client.update(node)
                    except NotFoundError:
                        pass  # terminated concurrently
                self.ctx.cluster.unmark_for_deletion(candidate.provider_id)
                self.ctx.recorder.publish(
                    Event(
                        candidate.node_claim.uid,
                        "Warning",
                        "DisruptionLaunchFailed",
                        str(exc),
                    )
                )
            return
        self.queue.add(command, replacement_names)

    def _launch_replacements(self, command: Command) -> List[str]:
        from ...api.objects import NodeClaim
        from ..nodeclaim_disruption import materialize_claim

        pools = {np_.name: np_ for np_ in self.ctx.client.list(NodePool)}
        names: List[str] = []
        created: List[NodeClaim] = []
        try:
            for claim_model in command.replacements:
                claim = materialize_claim(self.ctx.client, claim_model, pools)
                created.append(claim)
                names.append(claim.name)
        except ValueError:
            # all-or-nothing: reap the replacements already created so a
            # partial launch doesn't orphan unneeded capacity
            for claim in created:
                try:
                    self.ctx.client.delete(claim)
                except NotFoundError:
                    pass  # reaped concurrently
            raise
        return names
