# Copied from karpenter_tpu/controllers/disruption/methods.py, 1 comment line reworded.
"""Disruption methods: Emptiness, Drift, Multi- and Single-node
consolidation.

Mirror of the reference's method implementations
(emptiness.go:33-134, drift.go:37-127, multinodeconsolidation.go:36-222,
singlenodeconsolidation.go:34-174, consolidation.go:45-326). Each method
computes a Command; the controller tries them in order and stops at the
first success. Consolidation's inner oracle is the batch solver, so every
binary-search probe is one batched Solve.
"""

from __future__ import annotations

import os
import time as _time
from typing import Callable, Dict, List, Optional, Sequence

from ... import obs
from ...api import labels as labels_mod
from ...api.objects import (
    COND_CONSOLIDATABLE,
    COND_DRIFTED,
    CONSOLIDATION_WHEN_EMPTY,
    CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED,
)
from ...api.requirements import Operator, Requirement
from ...cloudprovider import types as cp
from .helpers import ScenarioSimulator, simulate_scheduling
from .types import Candidate, Command

MULTI_NODE_CONSOLIDATION_TIMEOUT = 60.0  # multinodeconsolidation.go:36
SINGLE_NODE_CONSOLIDATION_TIMEOUT = 180.0  # singlenodeconsolidation.go:34
MAX_MULTI_NODE_CANDIDATES = 100  # multinodeconsolidation.go:80-82
MIN_SPOT_TO_SPOT_TYPES = 15  # consolidation.go:48-49

# scenario-batched probe evaluation (ops/solve.py scenario axis):
# - the multi-node binary search primes this many midpoint-tree probes in
#   its first dispatch (levels 0-3 of the search tree over <= 100
#   candidates); the refinement dispatch covers the surviving interval
# - the single-node sweep evaluates candidates in chunks of this size
_SCENARIO_PRIME_BUDGET = 15
_SINGLE_NODE_BATCH = 16


def _scenario_batching_enabled(ctx) -> bool:
    """Scenario batching is on by default; a DisruptionContext attribute
    (tests, operator config) or KTPU_SCENARIO_BATCH=0/1 overrides."""
    flag = getattr(ctx, "scenario_batch", None)
    if flag is not None:
        return bool(flag)
    env = os.environ.get("KTPU_SCENARIO_BATCH")
    if env is not None:
        return env != "0"
    return True


def _prefetch_enabled(ctx) -> bool:
    """Double-buffered chunk prefetch in the single-node sweep.
    On by default; a DisruptionContext attribute or KTPU_PREFETCH=0/1
    overrides (the equivalence suite flips it to pin decisions identical
    with and without the async queue)."""
    flag = getattr(ctx, "scenario_prefetch", None)
    if flag is not None:
        return bool(flag)
    env = os.environ.get("KTPU_PREFETCH")
    if env is not None:
        return env != "0"
    return True


def _bsearch_tree_mids(n: int, budget: int) -> List[int]:
    """The first midpoints a binary search over [1, n] can ever visit:
    breadth-first levels of its fixed midpoint tree, whole levels only,
    up to ``budget`` nodes. Every actual search path walks root-to-leaf
    through this tree, so priming these answers the search's first
    ceil(log2(level_count)) probes whatever the outcomes are."""
    out: List[int] = []
    level = [(1, n)]
    while level:
        mids = [(lo + hi) // 2 for lo, hi in level if lo <= hi]
        if not mids or len(out) + len(mids) > budget:
            break
        out.extend(mids)
        level = [
            iv
            for lo, hi in level
            if lo <= hi
            for iv in ((lo, (lo + hi) // 2 - 1), ((lo + hi) // 2 + 1, hi))
        ]
    return out


_RUNG_RANK = {"batched": 0, "kernel": 1, "oracle": 2, "dropped": 3}


def _audit_consolidation(method, kind: str, sp, cmd: Command) -> None:
    """Decision-level audit record for a consolidation search, correlated
    with the per-solve records its probes emitted: with tracing on, the
    search's rung/guard aggregate the SAME-TRACE solve records (worst
    rung used, first non-ok guard verdict), so a mid-search quarantine is
    visible at decision level too. Untraced searches can't correlate and
    report "untracked" rather than claim a verdict."""
    trace_id = getattr(sp, "trace_id", "")
    solve_recs = obs.AUDIT.query(trace_id=trace_id) if trace_id else []
    if solve_recs:
        rung = max(
            (r.rung for r in solve_recs),
            key=lambda r: _RUNG_RANK.get(r, 0),
        )
        guard = next(
            (r.guard for r in solve_recs if r.guard != "ok"), "ok"
        )
    else:
        health = getattr(method.ctx.solver_config, "health", None)
        rung = (
            ("batched", "kernel", "oracle")[health.level()]
            if health is not None
            else "untracked"
        )
        guard = "untracked"
    obs.AUDIT.record(
        kind=kind,
        trace_id=trace_id,
        duration_ms=round(getattr(sp, "duration", 0.0) * 1000, 3),
        encode_hash=getattr(method.ctx.encode_cache, "content_hash", ""),
        pods=sum(len(c.reschedulable_pods) for c in cmd.candidates),
        claims=len(cmd.replacements),
        errors=0,
        scenario_count=method.last_probes,
        dispatches=method.last_dispatches,
        rung=rung,
        guard=guard,
        cost=sum(c.price for c in cmd.candidates),
        attrs={"decision": cmd.decision, "disrupted": len(cmd.candidates)},
    )


class Method:
    reason = ""
    consolidation_type = ""

    def should_disrupt(self, candidate: Candidate) -> bool:
        raise NotImplementedError

    def compute_command(self, candidates: List[Candidate], budgets: Dict[str, int]) -> Command:
        raise NotImplementedError

    def class_name(self) -> str:
        return "graceful"


def _budget_filter(candidates: List[Candidate], budgets: Dict[str, int]) -> List[Candidate]:
    """Take candidates per-pool up to the allowed budget."""
    taken: Dict[str, int] = {}
    out = []
    for c in candidates:
        pool = c.node_pool.name
        if taken.get(pool, 0) < budgets.get(pool, 0):
            taken[pool] = taken.get(pool, 0) + 1
            out.append(c)
    return out


class Emptiness(Method):
    """Delete empty consolidatable nodes in bulk (emptiness.go:33-134)."""

    reason = "Empty"
    consolidation_type = "empty"

    def __init__(self, clock):
        self.clock = clock

    def should_disrupt(self, candidate: Candidate) -> bool:
        if candidate.node_pool.spec.disruption.consolidate_after is None:
            return False
        return (
            candidate.node_claim.conds().is_true(COND_CONSOLIDATABLE)
            and not candidate.reschedulable_pods
        )

    def compute_command(self, candidates, budgets) -> Command:
        empty = [c for c in candidates if not c.reschedulable_pods]
        empty = _budget_filter(empty, budgets)
        return Command(candidates=empty, reason=self.reason, consolidation_type=self.consolidation_type)


class Drift(Method):
    """Replace drifted nodes, oldest first (drift.go:37-127)."""

    reason = "Drifted"
    consolidation_type = ""

    def __init__(self, ctx):
        self.ctx = ctx  # DisruptionContext

    def class_name(self) -> str:
        return "eventual"

    def should_disrupt(self, candidate: Candidate) -> bool:
        return candidate.node_claim.conds().is_true(COND_DRIFTED)

    def compute_command(self, candidates, budgets) -> Command:
        candidates = sorted(
            candidates, key=lambda c: c.node_claim.metadata.creation_timestamp
        )
        candidates = _budget_filter(candidates, budgets)
        # delete all empty drifted nodes in one shot
        empty = [c for c in candidates if not c.reschedulable_pods]
        if empty:
            return Command(candidates=empty, reason=self.reason)
        # else per-candidate simulate + replace
        for c in candidates:
            results = simulate_scheduling(
                self.ctx.client, self.ctx.cluster, self.ctx.cloud_provider, [c],
                encode_cache=self.ctx.encode_cache,
                solver_config=self.ctx.solver_config,
            )
            if results.pod_errors:
                continue
            return Command(
                candidates=[c],
                replacements=list(results.new_node_claims),
                reason=self.reason,
            )
        return Command(reason=self.reason)


class ConsolidationBase(Method):
    """Shared consolidation logic (consolidation.go:45-326)."""

    reason = "Underutilized"

    def __init__(self, ctx):
        self.ctx = ctx
        self._last_consolidation_state = -1.0

    def should_disrupt(self, candidate: Candidate) -> bool:
        policy = candidate.node_pool.spec.disruption.consolidation_policy
        if policy != CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED:
            return False
        if candidate.node_pool.spec.disruption.consolidate_after is None:
            return False
        return candidate.node_claim.conds().is_true(COND_CONSOLIDATABLE)

    def is_consolidated(self) -> bool:
        """Cluster-unchanged memoization (consolidation.go:79-86)."""
        return (
            self.ctx.cluster.consolidation_state(self.ctx.clock.now())
            == self._last_consolidation_state
        )

    def mark_consolidated(self) -> None:
        self._last_consolidation_state = self.ctx.cluster.mark_consolidated(
            self.ctx.clock.now()
        )

    # -- the core replacement computation ------------------------------

    def compute_consolidation(
        self, candidates: List[Candidate], state_snapshot=None
    ) -> Command:
        results = simulate_scheduling(
            self.ctx.client, self.ctx.cluster, self.ctx.cloud_provider, candidates,
            encode_cache=self.ctx.encode_cache,
            state_snapshot=state_snapshot,
            solver_config=self.ctx.solver_config,
        )
        return self._decision_from_results(candidates, results)

    def _decision_from_results(
        self, candidates: List[Candidate], results
    ) -> Command:
        """The pricing/spot decision rules over one simulation's Results —
        shared by the per-probe simulate above and the scenario-batched
        search, whose Results arrive en masse from one kernel dispatch."""
        if results.pod_errors:
            return Command()
        if not results.new_node_claims:
            return Command(candidates=list(candidates), reason=self.reason,
                           consolidation_type=self.consolidation_type)
        if len(results.new_node_claims) != 1:
            return Command()

        replacement = results.new_node_claims[0]
        candidate_price = sum(c.price for c in candidates)
        all_spot = all(
            c.capacity_type == labels_mod.CAPACITY_TYPE_SPOT for c in candidates
        )
        replacement.instance_type_options = cp.order_by_price(
            replacement.instance_type_options, replacement.requirements
        )
        if all_spot and replacement.requirements.get(
            labels_mod.CAPACITY_TYPE_LABEL_KEY
        ).has(labels_mod.CAPACITY_TYPE_SPOT):
            return self._spot_to_spot(candidates, replacement, candidate_price)

        if not _remove_types_priced_at_or_above(replacement, candidate_price):
            return Command()

        # OD -> [OD, spot] replacements must pin spot so a failed spot launch
        # doesn't produce a pricier on-demand node (consolidation.go:211-219)
        ct_req = replacement.requirements.get(labels_mod.CAPACITY_TYPE_LABEL_KEY)
        if ct_req.has(labels_mod.CAPACITY_TYPE_SPOT) and ct_req.has(
            labels_mod.CAPACITY_TYPE_ON_DEMAND
        ):
            replacement.requirements.add(
                Requirement(
                    labels_mod.CAPACITY_TYPE_LABEL_KEY,
                    Operator.IN,
                    [labels_mod.CAPACITY_TYPE_SPOT],
                )
            )
        return Command(
            candidates=list(candidates),
            replacements=[replacement],
            reason=self.reason,
            consolidation_type=self.consolidation_type,
        )

    def _spot_to_spot(self, candidates, replacement, candidate_price) -> Command:
        """Spot->spot churn protection (consolidation.go:232-305)."""
        if not self.ctx.spot_to_spot_enabled:
            return Command()
        replacement.requirements.add(
            Requirement(
                labels_mod.CAPACITY_TYPE_LABEL_KEY,
                Operator.IN,
                [labels_mod.CAPACITY_TYPE_SPOT],
            )
        )
        if not _remove_types_priced_at_or_above(replacement, candidate_price):
            return Command()
        if len(candidates) > 1:
            return Command(
                candidates=list(candidates),
                replacements=[replacement],
                reason=self.reason,
                consolidation_type=self.consolidation_type,
            )
        if len(replacement.instance_type_options) < MIN_SPOT_TO_SPOT_TYPES:
            return Command()
        # cap launch flexibility to prevent continual consolidation
        if replacement.requirements.has_min_values():
            needed, _ = cp.satisfies_min_values(
                replacement.instance_type_options, replacement.requirements
            )
            cap = max(MIN_SPOT_TO_SPOT_TYPES, needed)
        else:
            cap = MIN_SPOT_TO_SPOT_TYPES
        replacement.instance_type_options = replacement.instance_type_options[:cap]
        return Command(
            candidates=list(candidates),
            replacements=[replacement],
            reason=self.reason,
            consolidation_type=self.consolidation_type,
        )


def _remove_types_priced_at_or_above(replacement, max_price: float) -> bool:
    """Keep strictly cheaper instance types; False if none remain or
    minValues would break (nodeclaim RemoveInstanceTypeOptionsByPrice...)."""
    kept = [
        it
        for it in replacement.instance_type_options
        if cp.min_compatible_price(it, replacement.requirements) < max_price
    ]
    if replacement.requirements.has_min_values() and kept:
        _, err = cp.satisfies_min_values(kept, replacement.requirements)
        if err is not None:
            return False
    if not kept:
        return False
    replacement.instance_type_options = kept
    return True


class MultiNodeConsolidation(ConsolidationBase):
    """Binary search for the largest disruptable candidate prefix whose pods
    fit into <= 1 replacement (multinodeconsolidation.go:112-167).

    The search itself is a replay over precomputed probe answers: the
    scenario-batched solver evaluates the first levels of the search's
    midpoint tree in ONE kernel dispatch, the replay walks the standard
    lo/hi updates against those answers, and a second dispatch covers
    whatever interval survives — every probe point of the search in <= 2
    dispatches, with decisions identical to the sequential probe loop
    (tests/test_scenario_batch.py pins the equivalence). When the batch
    cannot be represented (see TpuSolver.solve_scenarios), the same replay
    runs over a per-probe sequential evaluator."""

    consolidation_type = "multi"

    def compute_command(self, candidates, budgets) -> Command:
        with obs.span(
            "consolidate.multi", candidates=len(candidates)
        ) as sp:
            cmd = self._compute_command(candidates, budgets)
        _audit_consolidation(self, "consolidation-multi", sp, cmd)
        return cmd

    def _compute_command(self, candidates, budgets) -> Command:
        # probe/dispatch telemetry for the bench's consolidation entry;
        # reset BEFORE any early return so a no-probe decision never
        # reports the previous decision's timings
        self.last_probe_ms: List[float] = []
        self.last_probes = 0
        self.last_dispatches = 0
        candidates = _budget_filter(
            sorted(candidates, key=lambda c: c.disruption_cost), budgets
        )
        candidates = candidates[:MAX_MULTI_NODE_CANDIDATES]
        if len(candidates) < 2:
            return Command()
        deadline = self.ctx.clock.now() + MULTI_NODE_CONSOLIDATION_TIMEOUT
        # one cluster snapshot serves every probe of the binary search
        snapshot = self.ctx.cluster.nodes()
        evaluator = None
        if _scenario_batching_enabled(self.ctx):
            evaluator = self._batched_evaluator(candidates, snapshot)
        if evaluator is None:
            evaluator = self._sequential_evaluator(candidates, snapshot)

        probe_budget = getattr(self.ctx, "probe_budget", None)
        lo, hi = 1, len(candidates)
        last_valid = Command()
        while lo <= hi:
            if self.ctx.clock.now() >= deadline:
                break
            if probe_budget is not None and self.last_probes >= probe_budget:
                # deterministic per-pass cap (DisruptionContext.probe_budget):
                # same bail-out as the wall-clock timeout, for harnesses
                # whose injected clock stands still inside a pass
                break
            mid = (lo + hi) // 2
            cmd = evaluator(mid, lo, hi)
            if cmd is None:
                # batched path became unrepresentable mid-search (cluster
                # state is fixed for the snapshot, so this is defensive):
                # finish sequentially
                evaluator = self._sequential_evaluator(candidates, snapshot)
                cmd = evaluator(mid, lo, hi)
            if cmd.decision != "no-op":
                last_valid = cmd
                lo = mid + 1
            else:
                hi = mid - 1
        return last_valid

    def _probe_command(self, subset, results) -> Command:
        """One probe's decision from its simulation Results, including the
        don't-replace-with-what-we-delete rule (filterOutSameType,
        multinodeconsolidation.go:185-222)."""
        cmd = self._decision_from_results(subset, results)
        if cmd.decision == "replace":
            self._filter_out_same_type(cmd, subset)
            if not cmd.replacements[0].instance_type_options:
                cmd = Command()
        return cmd

    def _sequential_evaluator(
        self, candidates, snapshot
    ) -> Callable[[int, int, int], Command]:
        def evaluate(mid: int, lo: int, hi: int) -> Command:
            subset = candidates[:mid]
            # wall-clock on purpose: probe latency diagnostics measure the
            # real solver, not simulated time (the reconcile DEADLINE in
            # compute_command does go through the injected clock)
            _t0 = _time.perf_counter()  # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: probe latency diagnostic, not reconcile timing
            results = simulate_scheduling(
                self.ctx.client, self.ctx.cluster, self.ctx.cloud_provider,
                subset,
                encode_cache=self.ctx.encode_cache,
                state_snapshot=snapshot,
                solver_config=self.ctx.solver_config,
            )
            self.last_probe_ms.append(
                # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: probe latency diagnostic, not reconcile timing
                round((_time.perf_counter() - _t0) * 1000, 1)
            )
            self.last_probes += 1
            self.last_dispatches += 1
            return self._probe_command(subset, results)

        return evaluate

    def _batched_evaluator(
        self, candidates, snapshot
    ) -> Optional[Callable[[int, int, int], Optional[Command]]]:
        """Probe evaluator over the scenario-batched solver: primes the
        midpoint-tree probes eagerly (dispatch 1), answers the refinement
        interval lazily when the replay first steps outside the primed set
        (dispatch 2). Returns None when the cluster/workload cannot ride
        the batch at all."""
        probe_cache: Dict[int, Command] = {}
        n = len(candidates)
        sim = ScenarioSimulator(
            self.ctx.client, self.ctx.cluster, self.ctx.cloud_provider,
            candidates,
            encode_cache=self.ctx.encode_cache,
            state_snapshot=snapshot,
            solver_config=self.ctx.solver_config,
            env_cache=getattr(self.ctx, "scenario_envs", None),
        )

        def evaluate_mids(mids: List[int]) -> bool:
            # wall-clock on purpose, as in the sequential evaluator
            _t0 = _time.perf_counter()  # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: probe latency diagnostic, not reconcile timing
            before = sim.dispatches
            results = sim.solve([candidates[:m] for m in mids])
            if results is None:
                return False
            self.last_probe_ms.append(
                # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: probe latency diagnostic, not reconcile timing
                round((_time.perf_counter() - _t0) * 1000, 1)
            )
            self.last_probes += len(mids)
            self.last_dispatches += sim.dispatches - before
            for m, res in zip(mids, results):
                probe_cache[m] = self._probe_command(candidates[:m], res)
            return True

        if not evaluate_mids(_bsearch_tree_mids(n, _SCENARIO_PRIME_BUDGET)):
            return None

        def evaluate(mid: int, lo: int, hi: int) -> Optional[Command]:
            if mid not in probe_cache:
                # every remaining probe of the search lies inside [lo, hi]
                remaining = [
                    m for m in range(lo, hi + 1) if m not in probe_cache
                ]
                if not evaluate_mids(remaining):
                    return None
            return probe_cache[mid]

        return evaluate

    def _filter_out_same_type(self, cmd: Command, candidates) -> None:
        replacement = cmd.replacements[0]
        deleted_names = {
            c.instance_type.name for c in candidates if c.instance_type is not None
        }
        replacement.instance_type_options = [
            it
            for it in replacement.instance_type_options
            if it.name not in deleted_names
        ]


class SingleNodeConsolidation(ConsolidationBase):
    """Per-candidate sweep, cheapest-to-disrupt first, interweaving
    candidates across NodePools and prioritizing pools left unseen by a
    previous timed-out run (singlenodeconsolidation.go:34-174)."""

    consolidation_type = "single"

    def compute_command(self, candidates, budgets) -> Command:
        with obs.span(
            "consolidate.single", candidates=len(candidates)
        ) as sp:
            cmd = self._compute_command(candidates, budgets)
        _audit_consolidation(self, "consolidation-single", sp, cmd)
        return cmd

    def __init__(self, ctx):
        super().__init__(ctx)
        self.previously_unseen_node_pools: set = set()
        # True when the last pass must not be memoized as "consolidated"
        # (timed out or budget-constrained, singlenodeconsolidation.go:112-121)
        self.suppress_memoization = False

    def sort_candidates(self, candidates) -> List[Candidate]:
        """Disruption-cost base order, then round-robin across pools with
        previously-unseen pools first (singlenodeconsolidation.go:138-174)."""
        by_pool: Dict[str, List[Candidate]] = {}
        for c in sorted(candidates, key=lambda c: c.disruption_cost):
            by_pool.setdefault(c.node_pool.name, []).append(c)
        ordered_pools = [p for p in self.previously_unseen_node_pools if p in by_pool]
        ordered_pools += [p for p in by_pool if p not in self.previously_unseen_node_pools]
        out: List[Candidate] = []
        depth = max((len(v) for v in by_pool.values()), default=0)
        for i in range(depth):
            for pool in ordered_pools:
                if i < len(by_pool[pool]):
                    out.append(by_pool[pool][i])
        return out

    def _compute_command(self, candidates, budgets) -> Command:
        self.suppress_memoization = False
        self.last_probe_ms: List[float] = []
        self.last_probes = 0
        self.last_dispatches = 0
        ordered = self.sort_candidates(candidates)
        budgeted = _budget_filter(ordered, budgets)
        constrained_by_budgets = len(budgeted) < len(ordered)
        all_pools = {c.node_pool.name for c in ordered}
        deadline = self.ctx.clock.now() + SINGLE_NODE_CONSOLIDATION_TIMEOUT
        seen_pools: set = set()
        timed_out = False
        # one cluster snapshot serves the whole per-candidate sweep; taken
        # lazily so budget-exhausted reconciles don't pay the deep copy
        snapshot = self.ctx.cluster.nodes() if budgeted else []
        evaluator = self._sweep_evaluator(budgeted, snapshot)
        probe_budget = getattr(self.ctx, "probe_budget", None)
        for i, c in enumerate(budgeted):
            if self.ctx.clock.now() >= deadline:
                timed_out = True
                break
            if probe_budget is not None and self.last_probes >= probe_budget:
                # deterministic per-pass cap — timeout semantics (resume
                # from unseen pools next pass, no consolidated memo)
                timed_out = True
                break
            seen_pools.add(c.node_pool.name)
            cmd = evaluator(i)
            if cmd.decision != "no-op":
                # early success: unseen-pool bookkeeping keeps its prior
                # value, like the reference's early return
                return cmd
        # remember pools never reached so the next run starts there
        self.previously_unseen_node_pools = all_pools - seen_pools
        if timed_out or constrained_by_budgets:
            # don't let the controller memoize this as "cluster
            # consolidated": work was skipped, not absent
            self.suppress_memoization = True
        return Command()

    def _sweep_evaluator(self, budgeted, snapshot) -> Callable[[int], Command]:
        """Per-candidate decision evaluator. Scenario batching evaluates
        _SINGLE_NODE_BATCH candidates per kernel dispatch (chunked so an
        early success doesn't pay for the whole sweep); decisions are
        identical to the sequential per-candidate simulate, and the sweep
        loop's order/timeout semantics are unchanged either way."""
        cache: Dict[int, Command] = {}
        sim: Optional[ScenarioSimulator] = None
        if _scenario_batching_enabled(self.ctx) and budgeted:
            # under a probe budget the sweep can only reach the first
            # budget(+chunk) candidates this pass — building the shared
            # encoding over the full universe would pay a 20k-pod union
            # encode for probes that cannot happen (the next pass resumes
            # from the unseen pools with its own budget)
            probe_budget = getattr(self.ctx, "probe_budget", None)
            universe = (
                budgeted
                if probe_budget is None
                else budgeted[: probe_budget + _SINGLE_NODE_BATCH]
            )
            sim = ScenarioSimulator(
                self.ctx.client, self.ctx.cluster, self.ctx.cloud_provider,
                universe,
                encode_cache=self.ctx.encode_cache,
                state_snapshot=snapshot,
                solver_config=self.ctx.solver_config,
                env_cache=getattr(self.ctx, "scenario_envs", None),
            )

        def evaluate(i: int) -> Command:
            if sim is not None and sim.available and i not in cache:
                chunk = budgeted[i : i + _SINGLE_NODE_BATCH]
                _t0 = _time.perf_counter()  # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: probe latency diagnostic, not reconcile timing
                before = sim.dispatches
                results = sim.solve([[c] for c in chunk])
                if results is not None and _prefetch_enabled(self.ctx):
                    # double-buffered sweep: submit the NEXT chunk's
                    # dispatch while this chunk's Results become decisions
                    # (and while the sweep walks its candidates) — the
                    # kernel computes in the queue's second slot, so the
                    # sweep never blocks on XLA at a chunk boundary. An
                    # early success abandons the prefetch (queue evicts).
                    nxt = budgeted[
                        i + _SINGLE_NODE_BATCH
                        : i + 2 * _SINGLE_NODE_BATCH
                    ]
                    if nxt:
                        sim.prefetch([[c] for c in nxt])
                if results is not None:
                    self.last_probe_ms.append(
                        # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: probe latency diagnostic, not reconcile timing
                        round((_time.perf_counter() - _t0) * 1000, 1)
                    )
                    self.last_probes += len(chunk)
                    self.last_dispatches += sim.dispatches - before
                    for j, (c, res) in enumerate(zip(chunk, results)):
                        cache[i + j] = self._decision_from_results([c], res)
            if i in cache:
                return cache[i]
            _t0 = _time.perf_counter()  # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: probe latency diagnostic, not reconcile timing
            cmd = self.compute_consolidation(
                [budgeted[i]], state_snapshot=snapshot
            )
            self.last_probe_ms.append(
                # analysis: sanctioned[BLK302,CLK1001] wall-time boundary: probe latency diagnostic, not reconcile timing
                round((_time.perf_counter() - _t0) * 1000, 1)
            )
            self.last_probes += 1
            self.last_dispatches += 1
            return cmd

        return evaluate
