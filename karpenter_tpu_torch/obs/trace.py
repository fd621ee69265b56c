# Copied from karpenter_tpu/obs/trace.py.
"""Clock-injected span tracer for the decision path.

The solve hot path crosses five machines' worth of seams — operator
reconcile, scenario build, cluster encode, host↔device transfer, kernel
dispatch, decode, invariant guard, commit — and BENCH_r05 shows the kernel
at 2.4–25 ms while the end-to-end decision costs ~286 ms. This module is
the instrument that splits that gap: every phase runs inside a ``Span``,
spans nest into traces, and a completed trace exports as Chrome
trace-event JSON (loadable in Perfetto / chrome://tracing) plus per-phase
duration histograms in ``metrics.REGISTRY``.

Design constraints (mirroring faults/__init__.py, the sibling seam):

- **Zero overhead when off.** Instrumented call sites go through the
  module-level ``span()``/``event()`` helpers, which cost one global
  ``None`` check and return a shared no-op context manager when no tracer
  is installed. With tracing off the solver's decisions are byte-identical
  to an uninstrumented run (pinned by tests/test_obs.py, the same
  contract tests/test_faults.py pins for the injector).
- **Deterministic.** Span/trace ids come from a seeded ``random.Random``;
  timestamps come from the injected clock. The same seed over the same
  call sequence replays the exact same trace, so chaos replays produce
  identical traces (the property the fault log already has).
- **Thread-correct.** The active-span stack is thread-local (the gRPC
  sidecar solves on a thread pool); the finished-span buffer is
  lock-guarded and bounded.

Trace context crosses the RemoteSolver gRPC hop as metadata
(``ktpu-trace-id``/``ktpu-parent-id``, solver/service.py) so sidecar spans
stitch into the caller's trace.
"""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..metrics import Histogram

# per-phase duration histograms: the span taxonomy is a bounded set of
# names (see README "Observability"), so the phase label stays well under
# the registry's cardinality guard
PHASE_DURATION = Histogram(
    "trace_phase_duration_seconds",
    "Span durations by phase (decision-path tracing)",
)

# gRPC metadata keys carrying trace context across the RemoteSolver hop
TRACE_ID_METADATA_KEY = "ktpu-trace-id"
PARENT_ID_METADATA_KEY = "ktpu-parent-id"


class PerfClock:
    """Wall-clock for standalone tracing (bench, the trace smoke): the
    operator injects its own Clock; this is for callers without one.

    One of the two documented RealClock seams (with kube.clock.RealClock)
    that the clock-discipline analysis (CLK10xx) whitelists — the ONLY
    places in controllers/faults/obs/solver allowed to read ``time.*``
    directly. Everything else threads an injected clock or obs.now()."""

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    @staticmethod
    def sleep(seconds: float) -> None:
        time.sleep(seconds)


@dataclass
class Span:
    """One timed phase. Use as a context manager (the OBS801 analysis rule
    flags spans opened without one)."""

    tracer: "Tracer"
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float
    end: Optional[float] = None
    attrs: Dict[str, object] = field(default_factory=dict)
    events: List[Tuple[float, str, Dict[str, object]]] = field(
        default_factory=list
    )

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def add_event(self, name: str, **attrs) -> None:
        self.events.append((self.tracer.clock.now(), name, attrs))

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.tracer._finish(self)
        return False

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start


class _NoopSpan:
    """Shared do-nothing span: what ``span()`` hands out when tracing is
    off. Stateless, so one instance serves every call site."""

    __slots__ = ()

    trace_id = ""
    span_id = ""
    parent_id = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def annotate(self, **attrs) -> "_NoopSpan":
        return self

    def add_event(self, name: str, **attrs) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Seeded, clock-injected span tracer.

    ``span(name)`` returns a context-managed Span parented on the calling
    thread's current span; ``dump(path)``/``export_chrome()`` emit the
    Chrome trace-event form. ``max_spans`` bounds the finished buffer
    (ring semantics: oldest spans drop first), so a long-lived operator
    can leave tracing on without unbounded growth.
    """

    def __init__(self, clock=None, seed: int = 0, max_spans: int = 100_000):
        self.clock = clock if clock is not None else PerfClock()
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._finished: List[Span] = []
        self.max_spans = max_spans
        self.dropped = 0

    # -- ids ----------------------------------------------------------------

    def _new_id(self) -> str:
        # drawn under the lock by callers; deterministic per (seed, call
        # sequence) so chaos replays produce identical traces
        return f"{self._rng.getrandbits(64):016x}"

    # -- span lifecycle ------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def span(
        self,
        name: str,
        *,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        **attrs,
    ) -> Span:
        """A new span, parented on the thread's current span unless an
        explicit ``trace_id``/``parent_id`` is given (the sidecar passes
        the caller's ids from gRPC metadata so its spans stitch into the
        remote trace). Explicitly-parented spans are marked
        ``remote_parent`` — their parent may live in ANOTHER process's
        tracer, so this process's trace dump legitimately lacks it and
        the validator's dangling-parent check exempts it."""
        remote_parent = parent_id is not None
        parent = self.current()
        with self._lock:
            span_id = self._new_id()
            if trace_id is None:
                trace_id = (
                    parent.trace_id if parent is not None else self._new_id()
                )
        if parent_id is None and parent is not None:
            parent_id = parent.span_id
        span = Span(
            tracer=self,
            name=name,
            trace_id=trace_id,
            span_id=span_id,
            parent_id=parent_id,
            start=self.clock.now(),
            attrs=dict(attrs),
        )
        if remote_parent:
            span.attrs["remote_parent"] = True
        return span

    def event(self, name: str, **attrs) -> None:
        """Attach an instant event to the calling thread's current span
        (dropped when no span is open)."""
        cur = self.current()
        if cur is not None:
            cur.add_event(name, **attrs)

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _finish(self, span: Span) -> None:
        span.end = self.clock.now()
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # defensive: out-of-order close
            stack.remove(span)
        PHASE_DURATION.observe(span.duration, labels={"phase": span.name})
        with self._lock:
            self._finished.append(span)
            if len(self._finished) > self.max_spans:
                drop = len(self._finished) - self.max_spans
                del self._finished[:drop]
                self.dropped += drop

    # -- introspection / export ---------------------------------------------

    def finished(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            spans = list(self._finished)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            # under the same lock as _finish's `dropped +=`: a reset
            # racing a drop must not resurrect the pre-clear count
            self.dropped = 0

    def phase_totals(self) -> Dict[str, float]:
        """{span name: summed duration seconds} over the finished buffer —
        the aggregation bench.py's per-phase columns read."""
        out: Dict[str, float] = {}
        for s in self.finished():
            out[s.name] = out.get(s.name, 0.0) + s.duration
        return out

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON (the Perfetto-loadable form): one
        complete ("X") event per finished span, μs timestamps from the
        injected clock, span/trace/parent ids in ``args``; span events
        ride as instant ("i") events."""
        events: List[dict] = []
        for s in sorted(self.finished(), key=lambda s: (s.start, s.span_id)):
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "ts": round(s.start * 1e6, 3),
                    "dur": round(max(s.duration, 0.0) * 1e6, 3),
                    "pid": 1,
                    "tid": 1,
                    "cat": "ktpu",
                    "args": {
                        "span_id": s.span_id,
                        "trace_id": s.trace_id,
                        "parent_id": s.parent_id,
                        **{k: _jsonable(v) for k, v in s.attrs.items()},
                    },
                }
            )
            for ts, name, attrs in s.events:
                events.append(
                    {
                        "name": name,
                        "ph": "i",
                        "ts": round(ts * 1e6, 3),
                        "dur": 0,
                        "pid": 1,
                        "tid": 1,
                        "cat": "ktpu",
                        "s": "t",
                        "args": {
                            "span_id": s.span_id,
                            "trace_id": s.trace_id,
                            "parent_id": s.span_id,
                            **{k: _jsonable(v) for k, v in attrs.items()},
                        },
                    }
                )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.export_chrome(), fh, indent=1)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# -- trace validation --------------------------------------------------------


def validate_chrome_trace(doc: dict, schema: dict) -> List[str]:
    """Violations of the checked-in minimal trace schema
    (hack/trace_schema.json) plus the structural invariants no schema can
    express: no dangling parent span ids, non-negative durations,
    monotonic (non-decreasing) timestamps in export order under the
    injected clock. Returns [] when the trace is valid."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["trace document missing 'traceEvents'"]
    events = doc["traceEvents"]
    req_keys = schema.get("required_event_keys", [])
    req_args = schema.get("required_arg_keys", [])
    allowed_ph = set(schema.get("ph", []))
    span_ids = {
        e.get("args", {}).get("span_id")
        for e in events
        if e.get("ph") == "X"
    }
    last_ts = None
    for i, e in enumerate(events):
        for k in req_keys:
            if k not in e:
                problems.append(f"event {i} missing key {k!r}")
        args = e.get("args", {})
        for k in req_args:
            if k not in args:
                problems.append(f"event {i} args missing {k!r}")
        if allowed_ph and e.get("ph") not in allowed_ph:
            problems.append(f"event {i} has unknown ph {e.get('ph')!r}")
        if e.get("dur", 0) < 0:
            problems.append(f"event {i} has negative duration")
        ts = e.get("ts")
        if e.get("ph") == "X":
            if last_ts is not None and ts is not None and ts < last_ts:
                problems.append(
                    f"event {i} timestamp {ts} regresses below {last_ts}"
                )
            if ts is not None:
                last_ts = ts
        parent = args.get("parent_id")
        if (
            parent is not None
            and parent not in span_ids
            and not args.get("remote_parent")
        ):
            # remote_parent spans were stitched from gRPC metadata: their
            # parent lives in the CALLER process's tracer, so its absence
            # from this dump is correct, not a leak
            problems.append(
                f"event {i} ({e.get('name')!r}) has dangling parent span id"
                f" {parent}"
            )
        if args.get("span_id") in (None, "") or args.get("trace_id") in (
            None,
            "",
        ):
            problems.append(f"event {i} missing span/trace id")
    return problems


__all__ = [
    "Span", "Tracer", "PerfClock", "NOOP_SPAN", "PHASE_DURATION",
    "TRACE_ID_METADATA_KEY", "PARENT_ID_METADATA_KEY",
    "validate_chrome_trace",
]
