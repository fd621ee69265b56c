# Copied from karpenter_tpu/events/recorder.py.
"""Deduplicating, rate-limited event recorder
(reference: pkg/events/recorder.go:47-95).

Events identical in (object uid, reason, message) are suppressed for a TTL
(2 min in the reference) and rate-limited per reason.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import obs

DEDUPE_TTL = 120.0
RATE_LIMIT_QPS = 10.0
RATE_LIMIT_BURST = 25


@dataclass
class Event:
    object_uid: str
    type: str  # Normal | Warning
    reason: str
    message: str
    involved_kind: str = ""
    involved_name: str = ""
    timestamp: float = 0.0


class Recorder:
    def __init__(self, clock):
        self._clock = clock
        self._seen: Dict[tuple, float] = {}
        self._tokens: Dict[str, float] = {}
        self._token_time: Dict[str, float] = {}
        self.events: List[Event] = []

    def publish(self, event: Event) -> bool:
        now = self._clock.now()
        event.timestamp = now
        key = (event.object_uid, event.reason, event.message)
        last = self._seen.get(key)
        if last is not None and now - last < DEDUPE_TTL:
            return False
        if not self._take_token(event.reason, now):
            return False
        self._seen[key] = now
        self.events.append(event)
        # correlate the event stream with the decision trace: a published
        # event lands as an instant event on whatever span is open (the
        # reconcile pass, a solve phase); no-op without an active tracer
        obs.event(
            "k8s.event",
            reason=event.reason,
            type=event.type,
            object_uid=event.object_uid,
        )
        return True

    def _take_token(self, reason: str, now: float) -> bool:
        tokens = self._tokens.get(reason, float(RATE_LIMIT_BURST))
        then = self._token_time.get(reason, now)
        tokens = min(RATE_LIMIT_BURST, tokens + (now - then) * RATE_LIMIT_QPS)
        if tokens < 1.0:
            self._tokens[reason] = tokens
            self._token_time[reason] = now
            return False
        self._tokens[reason] = tokens - 1.0
        self._token_time[reason] = now
        return True

    def for_reason(self, reason: str) -> List[Event]:
        return [e for e in self.events if e.reason == reason]
