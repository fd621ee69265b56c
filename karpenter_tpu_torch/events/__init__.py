# Copied from karpenter_tpu/events/__init__.py.
from .recorder import Event, Recorder

# Well-known reasons for the robustness tier (faults/): controllers and
# the solver ladder publish these so chaos tests and operators can key off
# stable strings instead of message prose.
REASON_RECONCILE_ERROR = "ReconcileError"
REASON_SOLVER_QUARANTINED = "SolverQuarantined"
REASON_SOLVER_DEGRADED = "SolverDegraded"
REASON_SOLVER_RESTORED = "SolverRestored"

__all__ = [
    "Event", "Recorder",
    "REASON_RECONCILE_ERROR", "REASON_SOLVER_QUARANTINED",
    "REASON_SOLVER_DEGRADED", "REASON_SOLVER_RESTORED",
]
