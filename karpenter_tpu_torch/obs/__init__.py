# Copied from karpenter_tpu/obs/__init__.py.
"""Observability: decision-path span tracing + the decision audit trail.

Two instruments over the solve path, both designed to cost nothing when
idle (the faults/ zero-overhead discipline):

- ``trace.Tracer`` — clock-injected, seeded-deterministic span tracer
  threaded through reconcile → encode → transfer → dispatch → decode →
  guard → commit (and across the RemoteSolver gRPC hop via metadata).
  Installed process-globally like the fault injector; call sites use the
  module-level ``span()``/``event()`` helpers, which are a single global
  ``None`` check when no tracer is installed.
- ``audit.AuditLog`` — ring-buffer decision trail; the module-global
  ``AUDIT`` receives one record per completed solve from
  solver/driver.py.

See README "Observability" for the span taxonomy and the audit-record
schema.
"""

from __future__ import annotations

from typing import Optional

from .audit import AuditLog, AuditRecord
from .audit import _REAL_CLOCK
from .trace import (
    NOOP_SPAN,
    PARENT_ID_METADATA_KEY,
    PHASE_DURATION,
    TRACE_ID_METADATA_KEY,
    PerfClock,
    Span,
    Tracer,
    validate_chrome_trace,
)

# -- process-global installation seam (mirrors faults.install) ---------------

_TRACER: Optional[Tracer] = None

# _REAL_CLOCK (imported from audit.py so the tier has exactly ONE
# wall-time fallback object): every "else wall time" stamp routes
# through that single named kube.clock.RealClock seam, so the
# clock-discipline analysis (CLK10xx) has one sanctioned source to
# whitelist and the determinism contract has one seam to replace under
# replay.

# monotonic fallback for DURATION measurement: wall time (RealClock) may
# step under NTP, so deltas never ride it — PerfClock is the documented
# monotonic seam
_PERF_CLOCK = PerfClock()


def now() -> float:
    """Timestamp for the solve path: the installed tracer's injected
    clock when tracing is on, the named RealClock seam otherwise. The
    only way the solve path may read time — raw ``time.*`` reads in
    controllers/faults/obs/solver are CLK10xx findings."""
    if _TRACER is not None:
        return _TRACER.clock.now()
    return _REAL_CLOCK.now()


def duration_clock():
    """The clock to measure durations with: the installed tracer's
    injected clock under tracing (replay-deterministic), the monotonic
    PerfClock seam otherwise (NEVER RealClock: an NTP step between two
    reads would record negative durations). Callers capture the clock
    ONCE per measured interval so an install/uninstall racing the
    interval cannot mix timebases."""
    if _TRACER is not None:
        return _TRACER.clock
    return _PERF_CLOCK


def _audit_now() -> float:
    """One timebase for every audit record in the log: the installed
    tracer's clock when tracing is on, the RealClock seam otherwise —
    never a mix WITHIN a record source, so ``AUDIT.query(since=...)``
    is coherent."""
    return now()


# the process-wide decision trail; always on (records never influence
# decisions, and one small append per solve is noise next to the solve)
_DEFAULT_AUDIT = AuditLog(clock=_audit_now)
AUDIT = _DEFAULT_AUDIT


def install_audit(log: Optional[AuditLog] = None, maxlen: int = 65536) -> AuditLog:
    """Swap the process-global decision trail for ``log`` (or a fresh,
    larger-ring one) and return it — the cluster twin's isolation seam:
    a twin run starts its audit trail at d000001 regardless of what the
    process solved before, so canonical audit artifacts from two runs
    compare byte-for-byte. Pair with :func:`uninstall_audit`. Call sites
    read ``obs.AUDIT`` per record, so the swap takes effect immediately."""
    global AUDIT
    AUDIT = log if log is not None else AuditLog(maxlen=maxlen, clock=_audit_now)
    return AUDIT


def uninstall_audit() -> None:
    """Restore the default process-wide trail after a twin run."""
    global AUDIT
    AUDIT = _DEFAULT_AUDIT


def install(tracer: Tracer) -> Tracer:
    global _TRACER
    _TRACER = tracer
    return tracer


def uninstall() -> None:
    global _TRACER
    _TRACER = None


def active() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **attrs):
    """A context-managed span on the installed tracer; the shared no-op
    span (one global read, no allocation) when tracing is off."""
    if _TRACER is None:
        return NOOP_SPAN
    return _TRACER.span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Attach an instant event to the installed tracer's current span;
    no-op (one global read) when tracing is off or no span is open."""
    if _TRACER is not None:
        _TRACER.event(name, **attrs)


def current_span():
    """The calling thread's open span, or None (also when tracing is
    off) — what the RemoteSolver reads to propagate trace context."""
    if _TRACER is None:
        return None
    return _TRACER.current()


__all__ = [
    "Span", "Tracer", "PerfClock", "NOOP_SPAN", "PHASE_DURATION",
    "AuditLog", "AuditRecord", "AUDIT", "install_audit", "uninstall_audit",
    "TRACE_ID_METADATA_KEY", "PARENT_ID_METADATA_KEY",
    "install", "uninstall", "active", "span", "event", "current_span",
    "now", "duration_clock", "validate_chrome_trace",
]
