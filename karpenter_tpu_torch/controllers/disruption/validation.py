# Copied from karpenter_tpu/controllers/disruption/validation.py.
"""Consolidation command validation.

Mirror of the reference's validation.go:56-215: after a command is computed
the controller waits out a TTL (15s, consolidation.go:46) and re-checks the
world before acting — candidates must still be disruptable candidates (not
deleted, not nominated, PDBs still permitting), the per-pool disruption
budgets must still allow the deletions, empty-node deletes must still be
empty, and replacement commands must re-simulate consistently: every pod
must still reschedule and the replacement's instance types must be a subset
of what a fresh simulation would allow.
"""

from __future__ import annotations

from typing import Optional

from ...api import labels as labels_mod
from .helpers import build_budget_mapping, get_candidates, simulate_scheduling
from .types import Command

VALIDATION_TTL = 15.0  # consolidation.go:46


class Validator:
    """Re-validates a computed command against fresh cluster state."""

    def __init__(self, ctx):
        self.ctx = ctx

    def is_valid(self, command: Command, queue=None, method=None) -> Optional[str]:
        """None when the command is still sound; otherwise the reason it is
        stale (validation.go:83-215). ``method`` re-applies the computing
        method's eligibility filter so policy changes made during the TTL
        (consolidation disabled, condition cleared) abandon the command."""
        if command.decision == "no-op":
            return None
        now = self.ctx.clock.now()
        fresh = get_candidates(
            self.ctx.client,
            self.ctx.cluster,
            self.ctx.cloud_provider,
            self.ctx.clock,
            queue=queue,
        )
        if method is not None:
            fresh = [c for c in fresh if method.should_disrupt(c)]
        fresh_by_pid = {c.provider_id: c for c in fresh}
        for cand in command.candidates:
            if cand.provider_id not in fresh_by_pid:
                return f"candidate {cand.node.name} is no longer disruptable"

        # budgets may have tightened since compute (validation.go:150-170)
        budgets = build_budget_mapping(
            self.ctx.client, self.ctx.cluster, command.reason, now
        )
        per_pool: dict = {}
        for cand in command.candidates:
            pool = cand.node_pool.name
            per_pool[pool] = per_pool.get(pool, 0) + 1
        for pool, count in per_pool.items():
            if count > budgets.get(pool, 0):
                return f"nodepool {pool} budget no longer allows {count} disruptions"

        if command.reason == "Empty":
            # emptiness never re-simulates; the nodes just have to still be
            # pod-free (emptiness.go:33-134)
            for cand in command.candidates:
                sn = fresh_by_pid[cand.provider_id].state_node
                if sn.reschedulable_pods():
                    return f"node {cand.node.name} is no longer empty"
            return None

        # consolidation (delete-only or replacement): re-simulate against
        # fresh state — spare capacity that absorbed the pods at compute
        # time may have been consumed during the TTL
        results = simulate_scheduling(
            self.ctx.client,
            self.ctx.cluster,
            self.ctx.cloud_provider,
            [fresh_by_pid[c.provider_id] for c in command.candidates],
            encode_cache=self.ctx.encode_cache,
            solver_config=self.ctx.solver_config,
        )
        if results.pod_errors:
            return "pods are no longer fully re-schedulable"
        if len(results.new_node_claims) > len(command.replacements):
            return "fresh simulation needs more replacement nodes"
        if results.new_node_claims:
            # the launched types must be a SUBSET of what a fresh solve
            # allows (validation.go:181-215); a shrunk option set means the
            # original command could launch a now-invalid type
            fresh_names = {
                it.name
                for claim in results.new_node_claims
                for it in claim.instance_type_options
            }
            for rep in command.replacements:
                if not all(it.name in fresh_names for it in rep.instance_type_options):
                    return "replacement instance types drifted from fresh simulation"
        return None


__all__ = ["VALIDATION_TTL", "Validator"]
