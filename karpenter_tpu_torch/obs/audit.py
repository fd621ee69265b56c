# Copied from karpenter_tpu/obs/audit.py, 2 comment lines reworded.
"""Decision audit trail: one structured record per completed solve.

Every decision the solver commits (a provisioning solve, a scenario-batched
consolidation dispatch, a quarantined solve that fell to the oracle) leaves
an ``AuditRecord`` in a ring-buffer ``AuditLog``: decision id, trace id (so
the record correlates with the span trace and the XProf device timeline),
encode content hash, scenario count, dispatch count, the degradation rung
that produced the answer, the invariant-guard verdict, and the fault sites
that fired during the solve (correlated against the fault injector's log).

The chaos soak and the PARITY.md cost-gap workflow query this instead of
scraping logs: ``AUDIT.query(kind=..., rung=...)`` answers "which decisions
did the oracle rung make while the kernel sat quarantined" directly.

The log is always on — appending one small record per solve is noise next
to the solve itself, and the records never influence decisions (the
byte-identical-decisions contract in tests/test_obs.py covers the tracer
AND the audit path). ``maxlen`` bounds memory like the tracer's span
buffer does.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Deque, Dict, List, Optional

from ..kube.clock import RealClock

# THE wall-time fallback for the observability tier — one object, one
# seam: obs/__init__ imports this same instance for its audit-timestamp
# fallback (CLK10xx whitelists exactly the RealClock class, nothing
# else in the tier reads the wall clock)
_REAL_CLOCK = RealClock()


@dataclass
class AuditRecord:
    """One solver decision, in the shape the soak/parity workflows query.

    ``rung`` names the degradation-ladder rung that produced the committed
    answer ("batched" | "kernel" | "oracle" | "dropped"); ``guard`` is the
    invariant-guard verdict ("ok" or "quarantined: <violations>");
    ``fault_sites`` lists the injector sites that fired during this solve
    (empty outside chaos runs). ``oracle_cost`` is filled only where an
    oracle reference run is affordable (bench.py's cost-delta configs)."""

    decision_id: str
    kind: str  # "solve" | "scenarios"
    trace_id: str
    timestamp: float
    duration_ms: float
    encode_hash: str
    pods: int
    claims: int
    errors: int
    scenario_count: int
    dispatches: int
    rung: str
    guard: str
    # packing cost of the committed decision. None when tracing is off:
    # total_price() walks every claim's option list, and the always-on
    # audit path must stay O(1) next to the solve (the <2% bench budget)
    cost: Optional[float] = None
    fault_sites: List[str] = field(default_factory=list)
    oracle_cost: Optional[float] = None
    # incremental-encode provenance: whether the solve reused
    # the prior cluster encoding verbatim (content-hash fast path) and
    # how many axis rows rode the device delta instead of a full
    # transfer. None on records that never touched the encode path
    # (consolidation decision-level records aggregate their solves).
    encode_reused: Optional[bool] = None
    delta_rows: Optional[int] = None
    attrs: Dict[str, object] = field(default_factory=dict)


class AuditLog:
    """Bounded, thread-safe decision trail. Decision ids are sequential
    ("d000001", ...) — deterministic under replay, unlike uuids.

    ``clock`` is a zero-arg callable providing ``timestamp`` for records
    that don't pass one — ONE timebase per log, so ``query(since=...)``
    compares like with like (obs.__init__ wires the installed tracer's
    clock, falling back to wall time)."""

    def __init__(self, maxlen: int = 1024, clock=None):
        self._records: Deque[AuditRecord] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._seq = 0
        self._clock = clock
        # append observers (the twin's wall-latency sampler): called AFTER
        # the record lands, outside the lock — observers may query the log
        self._observers: List = []

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock()
        return _REAL_CLOCK.now()

    def record(self, **fields) -> AuditRecord:
        fields.setdefault("timestamp", self._now())
        with self._lock:
            self._seq += 1
            rec = AuditRecord(decision_id=f"d{self._seq:06d}", **fields)
            self._records.append(rec)
        for cb in list(self._observers):
            cb(rec)
        return rec

    def on_record(self, callback) -> None:
        """Register an append observer ``callback(record)`` — how the
        cluster twin joins wall-clock latency samples to decision ids
        without adding non-deterministic fields to the records."""
        self._observers.append(callback)

    def remove_observer(self, callback) -> None:
        try:
            self._observers.remove(callback)
        except ValueError:
            pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def last(self) -> Optional[AuditRecord]:
        with self._lock:
            return self._records[-1] if self._records else None

    def query(
        self,
        kind: Optional[str] = None,
        rung: Optional[str] = None,
        trace_id: Optional[str] = None,
        since: Optional[float] = None,
        until: Optional[float] = None,
    ) -> List[AuditRecord]:
        """Filtered records. ``since`` is inclusive, ``until`` exclusive —
        the half-open [since, until) window the twin's per-minute SLO wall
        slices the trail into (adjacent minutes never double-count a
        record)."""
        with self._lock:
            records = list(self._records)
        return [
            r
            for r in records
            if (kind is None or r.kind == kind)
            and (rung is None or r.rung == rung)
            and (trace_id is None or r.trace_id == trace_id)
            and (since is None or r.timestamp >= since)
            and (until is None or r.timestamp < until)
        ]

    def window(self, since: float, until: float) -> List[AuditRecord]:
        """All records in the half-open [since, until) window — one
        simulated minute of the twin's SLO wall."""
        return self.query(since=since, until=until)

    def export_state(self) -> dict:
        """Serializable full state (records + sequence counter) — the
        twin checkpoints this so a resumed replay continues decision ids
        ("d%06d") exactly where the interrupted run stopped."""
        with self._lock:
            return {
                "seq": self._seq,
                "maxlen": self._records.maxlen,
                "records": [asdict(r) for r in self._records],
            }

    def restore_state(self, state: dict) -> None:
        with self._lock:
            self._seq = int(state["seq"])
            self._records = deque(
                (AuditRecord(**r) for r in state["records"]),
                maxlen=state.get("maxlen") or self._records.maxlen,
            )

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._seq = 0

    def to_json(self) -> str:
        with self._lock:
            records = list(self._records)
        return json.dumps([asdict(r) for r in records], indent=1)

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(self.to_json())


__all__ = ["AuditRecord", "AuditLog"]
