# Copied from karpenter_tpu/faults/breaker.py.
"""Circuit breaker + the solver's degradation ladder.

The solve hot path has three rungs, fastest first:

1. **batched** — the scenario-batched kernel (one vmapped dispatch for a
   whole consolidation probe set, ops/solve.py:solve_all_scenarios_packed);
2. **kernel** — the per-probe fused kernel (solve_all_packed /
   solve_all_classed_packed, or the native C++ core);
3. **oracle** — the exact host scheduler (scheduling/scheduler.py), the
   semantic source of truth. Always available; never guarded.

Each guarded rung sits behind a ``CircuitBreaker``: consecutive failures
trip it open, a clock-driven cool-down admits a half-open probe, and a
probe success closes it again — so the solver drops DOWN the ladder when
a rung misbehaves and re-probes UPWARD once the cool-down passes
(CvxCluster's degradation argument for LP allocators; the reference
treats provider errors as first-class state the same way). An integrity
violation caught by faults/guard.py trips the rung immediately
(quarantine) instead of counting toward the threshold: a kernel emitting
garbage must not get ``failure_threshold`` chances to corrupt a commit.

``SolverHealth`` is the shared handle threaded through ``SolverConfig``:
one instance per operator, surviving the per-solve TpuSolver instances,
publishing rung changes as events and metrics.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from .. import obs
from ..events import (
    REASON_SOLVER_DEGRADED,
    REASON_SOLVER_QUARANTINED,
    REASON_SOLVER_RESTORED,
)
from ..metrics import Counter, Gauge

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

DEGRADATION_RUNG = Gauge(
    "solver_degradation_rung",
    "Current solver rung: 0=scenario-batched, 1=per-probe kernel, 2=host oracle",
)
BREAKER_TRIPS = Counter(
    "solver_breaker_trips_total",
    "Circuit-breaker trips per solver rung",
)
QUARANTINES = Counter(
    "solver_quarantines_total",
    "Solves discarded by the post-solve invariant guard",
)
DELTA_FALLBACKS = Counter(
    "solver_delta_fallbacks_total",
    "Guard-rejected incremental solves retried on a full re-encode "
    "(the degradation ladder's half-step: warm encode state shed, "
    "no rung tripped)",
)


class CircuitBreaker:
    """Consecutive-failure breaker with a clock-driven cool-down.

    closed → open after ``failure_threshold`` consecutive failures (or an
    explicit ``trip()``); open → half-open once ``cooldown`` seconds pass
    on the injected clock; a half-open success closes, a half-open
    failure re-opens and restarts the cool-down."""

    def __init__(self, clock, failure_threshold: int = 3, cooldown: float = 60.0):
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self.state = CLOSED
        self.failures = 0
        self.trips = 0
        self._opened_at = 0.0

    def allow(self) -> bool:
        if self.state == OPEN and (
            self.clock.now() - self._opened_at >= self.cooldown
        ):
            self.state = HALF_OPEN
        return self.state != OPEN

    def record_success(self) -> None:
        self.state = CLOSED
        self.failures = 0

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == HALF_OPEN or self.failures >= self.failure_threshold:
            self.trip()

    def trip(self) -> None:
        self.state = OPEN
        self.trips += 1
        self.failures = 0
        self._opened_at = self.clock.now()


class DegradationLadder:
    """Ordered rungs, fastest first; every rung but the last sits behind a
    breaker, and the last is unconditional."""

    def __init__(
        self,
        clock,
        rungs: Sequence[str] = ("batched", "kernel", "oracle"),
        failure_threshold: int = 2,
        cooldown: float = 120.0,
    ):
        self.rungs = tuple(rungs)
        self.breakers: Dict[str, CircuitBreaker] = {
            rung: CircuitBreaker(clock, failure_threshold, cooldown)
            for rung in self.rungs[:-1]
        }

    def allows(self, rung: str) -> bool:
        breaker = self.breakers.get(rung)
        return breaker is None or breaker.allow()

    def record(self, rung: str, ok: bool) -> None:
        breaker = self.breakers.get(rung)
        if breaker is None:
            return
        if ok:
            breaker.record_success()
        else:
            breaker.record_failure()

    def trip(self, rung: str) -> None:
        breaker = self.breakers.get(rung)
        if breaker is not None:
            breaker.trip()

    def current(self) -> str:
        for rung in self.rungs:
            if self.allows(rung):
                return rung
        return self.rungs[-1]

    def level(self) -> int:
        return self.rungs.index(self.current())


class SolverHealth:
    """The solver path's ladder, shared across TpuSolver instances.

    ``allow_batched``/``allow_kernel`` gate the two accelerated rungs
    (a quarantined kernel also takes the batched rung with it — both run
    the same kernels); ``record_*`` feed successes/failures to the
    breakers; ``quarantine`` trips a rung immediately on an integrity
    violation. Rung changes are published as events through ``recorder``
    (events/recorder.py) and mirrored in the metrics above."""

    RUNGS = ("batched", "kernel", "oracle")

    def __init__(
        self,
        clock,
        recorder=None,
        failure_threshold: int = 2,
        cooldown: float = 120.0,
        metric_labels: Optional[Dict[str, str]] = None,
    ):
        self.clock = clock
        self.recorder = recorder
        self.ladder = DegradationLadder(
            clock, self.RUNGS, failure_threshold, cooldown
        )
        self.quarantines = 0
        self.delta_fallbacks = 0
        self._last_level = 0
        # multi-tenant service (solver/tenancy.py): each tenant's ladder
        # publishes its own metric series (tenant=<id>). None keeps the
        # original unlabeled series — the single-operator deployments and
        # every existing dashboard/test read those unchanged. Cardinality
        # stays bounded because TenantRegistry.max_tenants bounds who can
        # mint a labeled SolverHealth.
        self._labels = dict(metric_labels) if metric_labels else None
        DEGRADATION_RUNG.set(0.0, labels=self._labels)

    def _rung_labels(self, rung: str) -> Dict[str, str]:
        if self._labels is None:
            return {"rung": rung}
        merged = {"rung": rung}
        merged.update(self._labels)
        return merged

    # -- gates --------------------------------------------------------------

    def allow_batched(self) -> bool:
        return self.ladder.allows("batched") and self.ladder.allows("kernel")

    def allow_kernel(self) -> bool:
        return self.ladder.allows("kernel")

    # -- outcomes -----------------------------------------------------------

    def record_batched(self, ok: bool, reason: str = "") -> None:
        self._record("batched", ok, reason)

    def record_kernel(self, ok: bool, reason: str = "") -> None:
        self._record("kernel", ok, reason)

    def delta_fallback(self, reason: str) -> None:
        """The ladder's half-step (between "incremental kernel" and a
        quarantine): the invariant guard rejected a solve that ran on a
        delta-applied / reused encoding, the driver shed the warm state
        (row banks, prior snapshot, device buffers) and is retrying once
        on a full re-encode. No breaker trips — if the fresh encoding
        solves clean the rung keeps its standing; if it trips the guard
        again, quarantine() follows as usual."""
        self.delta_fallbacks += 1
        DELTA_FALLBACKS.inc(labels=self._labels)
        obs.event("solver.delta_fallback", reason=reason[:200])
        self._publish(
            REASON_SOLVER_DEGRADED,
            f"incremental encoding shed after guard rejection: {reason}",
        )

    def quarantine(self, rung: str, reason: str) -> None:
        """Integrity violation: trip the rung NOW and drop to the oracle
        (the violating solve is discarded by the caller, never committed)."""
        self.quarantines += 1
        obs.event("solver.quarantine", rung=rung, reason=reason)
        QUARANTINES.inc(labels=self._labels)
        self.ladder.trip(rung)
        BREAKER_TRIPS.inc(labels=self._rung_labels(rung))
        self._publish(
            REASON_SOLVER_QUARANTINED,
            f"solver {rung} rung quarantined: {reason}",
        )
        self._observe(probe_succeeded=False)

    def _record(self, rung: str, ok: bool, reason: str) -> None:
        breaker = self.ladder.breakers[rung]
        trips_before = breaker.trips
        self.ladder.record(rung, ok)
        if breaker.trips > trips_before:
            # breaker trips land on the open span so a trace of a degraded
            # decision shows exactly which phase tripped which rung
            obs.event("solver.breaker_trip", rung=rung, reason=reason)
            BREAKER_TRIPS.inc(labels=self._rung_labels(rung))
            self._publish(
                REASON_SOLVER_DEGRADED,
                f"solver {rung} rung opened after repeated failures"
                + (f": {reason}" if reason else ""),
            )
        self._observe(probe_succeeded=ok)

    def level(self) -> int:
        """Effective rung index (0=batched, 1=kernel, 2=oracle) from the
        composite gates — what the NEXT solve will try. Public: the
        decision audit trail (obs/audit.py) records it per decision."""
        return self._level()

    def _level(self) -> int:
        """Effective rung index from the composite gates (a quarantined
        kernel takes the batched rung with it, which the raw ladder's
        per-breaker view can't see)."""
        if self.allow_batched():
            return 0
        if self.allow_kernel():
            return 1
        return 2

    def _observe(self, probe_succeeded: bool) -> None:
        """Refresh the rung gauge (it reports what the NEXT solve will
        try, half-open probes included), but only announce a restore when
        an actual probe SUCCEEDED — a cool-down lapsing merely admits a
        probe, it proves nothing yet."""
        level = self._level()
        if probe_succeeded and level < self._last_level:
            self._publish(
                REASON_SOLVER_RESTORED,
                f"solver re-probed upward to the {self.RUNGS[level]} rung",
            )
        # after a failed probe the observation-time half-open flip of an
        # unrelated breaker must not lower the remembered level, or the
        # NEXT success would miss its restore announcement
        if probe_succeeded or level > self._last_level:
            self._last_level = level
        DEGRADATION_RUNG.set(float(level), labels=self._labels)

    # -- checkpoint (sim/twin.py) -------------------------------------------

    def export_state(self) -> dict:
        """Breaker/ladder state a resumed twin replay must carry over —
        a half-open cool-down or a pending quarantine changes which rung
        the NEXT solve tries, so losing it would fork the replay."""
        return {
            "quarantines": self.quarantines,
            "delta_fallbacks": self.delta_fallbacks,
            "last_level": self._last_level,
            "breakers": {
                rung: {
                    "state": b.state,
                    "failures": b.failures,
                    "trips": b.trips,
                    "opened_at": b._opened_at,
                }
                for rung, b in self.ladder.breakers.items()
            },
        }

    def restore_state(self, state: dict) -> None:
        self.quarantines = int(state["quarantines"])
        self.delta_fallbacks = int(state["delta_fallbacks"])
        self._last_level = int(state["last_level"])
        for rung, bs in state["breakers"].items():
            b = self.ladder.breakers[rung]
            b.state = bs["state"]
            b.failures = int(bs["failures"])
            b.trips = int(bs["trips"])
            b._opened_at = float(bs["opened_at"])
        DEGRADATION_RUNG.set(float(self._level()), labels=self._labels)

    def _publish(self, reason: str, message: str) -> None:
        if self.recorder is None:
            return
        from ..events import Event

        self.recorder.publish(
            Event(
                object_uid="solver",
                type=(
                    "Normal" if reason == REASON_SOLVER_RESTORED
                    else "Warning"
                ),
                reason=reason,
                message=message,
            )
        )


__all__ = [
    "CircuitBreaker", "DegradationLadder", "SolverHealth",
    "CLOSED", "OPEN", "HALF_OPEN",
    "DEGRADATION_RUNG", "BREAKER_TRIPS", "QUARANTINES",
]
