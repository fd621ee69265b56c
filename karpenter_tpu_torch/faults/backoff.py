# Copied from karpenter_tpu/faults/backoff.py.
"""Clock-driven exponential backoff — the one retry primitive every seam
shares.

Two shapes of retry exist in a level-triggered control plane:

- **In-cycle** (``Backoff.call``): a transient store conflict is worth a
  couple of immediate bounded retries inside the same reconcile pass —
  waiting happens through the *injected* clock (``Clock.sleep``), so tests
  on a TestClock advance simulated time instead of blocking, and the
  BLK3xx analysis tier stays green (no ``time.sleep`` anywhere).
- **Cross-pass** (``RetryTracker``): a failed cloud create should not be
  re-attempted on every tick. The tracker records a failure per key and
  gates the next attempt behind an exponentially growing, jittered
  deadline read off the injected clock — the in-process analog of
  controller-runtime's rate-limited requeue.

Jitter is drawn from a seeded per-instance RNG so chaos runs replay
exactly (see faults/__init__.py's determinism contract).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple


class Backoff:
    """Exponential backoff schedule with deterministic jitter.

    ``delay(attempt)`` is ``min(max_delay, initial * factor**attempt)``
    scaled by ``1 + jitter*u`` with ``u`` from the seeded RNG. ``call``
    runs a callable with at most ``max_attempts`` tries, sleeping the
    schedule on the injected clock between them, and re-raises the last
    retriable error when the budget is spent."""

    def __init__(
        self,
        clock,
        initial: float = 1.0,
        factor: float = 2.0,
        max_delay: float = 60.0,
        jitter: float = 0.1,
        max_attempts: int = 4,
        seed: int = 0,
    ):
        self.clock = clock
        self.initial = initial
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self.max_attempts = max_attempts
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        base = min(self.max_delay, self.initial * self.factor ** attempt)
        if self.jitter:
            base *= 1.0 + self.jitter * self._rng.random()
        return base

    def export_rng(self):
        """Jitter-RNG state for the twin checkpoint: post-resume delays
        must draw the same jitter the uninterrupted run would have."""
        return self._rng.getstate()

    def restore_rng(self, state) -> None:
        self._rng.setstate(state)

    def call(self, fn: Callable[[], object], retriable=(Exception,)):
        attempt = 0
        while True:
            try:
                return fn()
            except retriable:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                self.clock.sleep(self.delay(attempt - 1))


@dataclass
class _RetryState:
    attempts: int
    next_at: float


class RetryTracker:
    """Per-key cross-pass retry gate for level-triggered controllers.

    ``ready(key)`` says whether the key may be attempted now;
    ``failure(key)`` records a failure and schedules the next attempt
    (returning the delay); ``success(key)`` clears the key's state. Keys
    with no recorded failure are always ready, so the tracker costs
    nothing on the healthy path."""

    def __init__(
        self,
        clock,
        initial: float = 2.0,
        factor: float = 2.0,
        max_delay: float = 300.0,
        jitter: float = 0.1,
        seed: int = 0,
    ):
        self.clock = clock
        self._backoff = Backoff(
            clock, initial=initial, factor=factor, max_delay=max_delay,
            jitter=jitter, seed=seed,
        )
        self._state: Dict[object, _RetryState] = {}

    def ready(self, key) -> bool:
        st = self._state.get(key)
        return st is None or self.clock.now() >= st.next_at

    def failure(self, key) -> float:
        st = self._state.get(key)
        attempts = st.attempts + 1 if st is not None else 1
        delay = self._backoff.delay(attempts - 1)
        self._state[key] = _RetryState(attempts, self.clock.now() + delay)
        return delay

    def success(self, key) -> None:
        self._state.pop(key, None)

    def attempts(self, key) -> int:
        st = self._state.get(key)
        return st.attempts if st is not None else 0

    def prune(self, live_keys) -> None:
        """Drop state for keys that no longer exist (deleted claims)."""
        live = set(live_keys)
        for key in [k for k in self._state if k not in live]:
            del self._state[key]

    # -- checkpoint (sim/twin.py) -------------------------------------------

    def export_state(self) -> dict:
        """Per-key backoff deadlines + jitter-RNG state: a controller that
        was mid-backoff at checkpoint time must stay backed off exactly as
        long after resume, or the replay forks."""
        return {
            "rng": self._backoff.export_rng(),
            "state": {
                k: (st.attempts, st.next_at) for k, st in self._state.items()
            },
        }

    def restore_state(self, state: dict) -> None:
        self._backoff.restore_rng(state["rng"])
        self._state = {
            k: _RetryState(attempts, next_at)
            for k, (attempts, next_at) in state["state"].items()
        }


__all__ = ["Backoff", "RetryTracker"]
