# Copied from karpenter_tpu/scheduling/preferences.py.
"""Preference relaxation (reference: preferences.go:38-146).

When a pod fails to schedule, soft constraints are dropped one per attempt,
in a fixed order: extra required node-affinity OR-terms first, then preferred
pod affinity, preferred pod anti-affinity, preferred node affinity (heaviest
first), ScheduleAnyway topology spreads, and optionally a PreferNoSchedule
toleration.
"""

from __future__ import annotations

from typing import Optional

from ..api.objects import Pod, Toleration
from ..api.taints import PREFER_NO_SCHEDULE


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod: Pod) -> bool:
        relaxations = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_schedule_anyway_spread,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule_taints)
        for fn in relaxations:
            if fn(pod) is not None:
                return True
        return False

    def _remove_required_node_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.node_affinity
        if affinity is None or len(affinity.required) <= 1:
            return None  # cannot remove the last OR-term
        removed = affinity.required.pop(0)
        return f"removed required node affinity term {removed}"

    def _remove_preferred_node_affinity_term(self, pod: Pod) -> Optional[str]:
        affinity = pod.spec.node_affinity
        if affinity is None or not affinity.preferred:
            return None
        affinity.preferred.sort(key=lambda t: -t.weight)
        removed = affinity.preferred.pop(0)
        return f"removed preferred node affinity term weight={removed.weight}"

    def _remove_preferred_pod_affinity_term(self, pod: Pod) -> Optional[str]:
        if not pod.spec.preferred_pod_affinity:
            return None
        pod.spec.preferred_pod_affinity.sort(key=lambda t: -t.weight)
        removed = pod.spec.preferred_pod_affinity.pop(0)
        return f"removed preferred pod affinity weight={removed.weight}"

    def _remove_preferred_pod_anti_affinity_term(self, pod: Pod) -> Optional[str]:
        if not pod.spec.preferred_pod_anti_affinity:
            return None
        pod.spec.preferred_pod_anti_affinity.sort(key=lambda t: -t.weight)
        removed = pod.spec.preferred_pod_anti_affinity.pop(0)
        return f"removed preferred pod anti-affinity weight={removed.weight}"

    def _remove_schedule_anyway_spread(self, pod: Pod) -> Optional[str]:
        for i, tsc in enumerate(pod.spec.topology_spread_constraints):
            if tsc.when_unsatisfiable == "ScheduleAnyway":
                pod.spec.topology_spread_constraints.pop(i)
                return f"removed ScheduleAnyway spread on {tsc.topology_key}"
        return None

    def _tolerate_prefer_no_schedule_taints(self, pod: Pod) -> Optional[str]:
        for t in pod.spec.tolerations:
            if t.operator == "Exists" and t.effect == PREFER_NO_SCHEDULE and not t.key:
                return None
        pod.spec.tolerations.append(
            Toleration(operator="Exists", effect=PREFER_NO_SCHEDULE)
        )
        return "added PreferNoSchedule toleration"
