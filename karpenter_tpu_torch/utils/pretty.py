# Copied from karpenter_tpu/utils/pretty.py.
"""Log-noise suppression: the ChangeMonitor analog.

The reference gates repeat log lines for slow-changing discoveries behind
a value-hash cache with a 24h TTL (pkg/utils/pretty/changemonitor.go —
the TTL re-admits a line daily so restarted log collection still captures
it; provisioner.go:187,197 use it to log a pod's scheduling relegation
once, not per reconcile). Same contract here over a plain dict; values
hash structurally (dicts/sets order-free, like hashstructure's
SlicesAsSets for the set-ish cases).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

DEFAULT_TTL = 24 * 60 * 60.0


def _structural_hash(value: Any) -> int:
    if isinstance(value, dict):
        return hash(
            ("dict", frozenset((k, _structural_hash(v)) for k, v in value.items()))
        )
    if isinstance(value, (set, frozenset)):
        return hash(("set", frozenset(_structural_hash(v) for v in value)))
    if isinstance(value, (list, tuple)):
        return hash(("seq", tuple(_structural_hash(v) for v in value)))
    return hash(value)


class ChangeMonitor:
    """has_changed(key, value) -> True when value's hash differs from the
    last observation of key (or the observation expired). Callers gate
    per-reconcile log lines on it so steady state stays quiet."""

    def __init__(self, ttl: float = DEFAULT_TTL, clock=None):
        self._ttl = ttl
        self._clock = clock
        self._last_seen: Dict[str, Tuple[int, float]] = {}
        self._next_sweep = 0.0

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else time.monotonic()

    def has_changed(self, key: str, value: Any) -> bool:
        hv = _structural_hash(value)
        now = self._now()
        existing = self._last_seen.get(key)
        if existing is not None:
            old_hv, seen_at = existing
            if old_hv == hv and now - seen_at < self._ttl:
                return False
        self._last_seen[key] = (hv, now)
        # opportunistic expiry sweep keeps the map bounded without a
        # timer; time-gated so a burst of >10k live (unexpired) keys
        # cannot trigger an O(n) rebuild per insertion
        if len(self._last_seen) > 10_000 and now >= self._next_sweep:
            cutoff = now - self._ttl
            self._last_seen = {
                k: v for k, v in self._last_seen.items() if v[1] >= cutoff
            }
            self._next_sweep = now + self._ttl / 10.0
        return True
