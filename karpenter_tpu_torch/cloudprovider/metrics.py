# Copied from karpenter_tpu/cloudprovider/metrics.py.
"""CloudProvider metrics decorator.

Mirror of pkg/cloudprovider/metrics/cloudprovider.go: wraps any provider
with per-method duration histograms and error counters, keeping the SPI
surface unchanged so it can be layered over kwok/fake/real providers.
"""

from __future__ import annotations

import time
from typing import List

from ..kube import RealClock
from ..metrics import Counter, Histogram
from .types import (
    CloudProvider,
    CloudProviderError,
    InstanceType,
    InsufficientCapacityError,
    RepairPolicy,
)

METHOD_DURATION = Histogram(
    "cloudprovider_duration_seconds",
    "Duration of cloud provider method calls",
)
METHOD_ERRORS = Counter(
    "cloudprovider_errors_total",
    "Total cloud provider method errors",
)
INSUFFICIENT_CAPACITY = Counter(
    "cloudprovider_insufficient_capacity_total",
    "Create calls that failed for lack of capacity (feeds the ICE cache)",
)


class MetricsCloudProvider(CloudProvider):
    """Decorator: same SPI, instrumented."""

    def __init__(self, inner: CloudProvider):
        self.inner = inner
        # durations read the inner provider's injected clock when it
        # carries a SIMULATED one (kwok/fake expose .clock), so chaos-soak
        # latency histograms are deterministic under replay: an injected-
        # latency rule advances the TestClock by exactly its configured
        # delay, and the same seed reproduces the same histogram. A
        # RealClock is wall time (time.time) — an NTP step would record
        # negative durations — so production keeps monotonic perf_counter,
        # as do providers without a clock (a real cloud SDK).
        clock = getattr(inner, "clock", None)
        if clock is not None and not isinstance(clock, RealClock):
            self._now = clock.now
        else:
            self._now = time.perf_counter

    def _timed(self, method: str, fn, *args, **kwargs):
        labels = {"method": method, "provider": self.inner.name()}
        t0 = self._now()
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            METHOD_ERRORS.inc(
                labels={**labels, "error": type(e).__name__}
            )
            if isinstance(e, InsufficientCapacityError):
                INSUFFICIENT_CAPACITY.inc(
                    labels={"provider": self.inner.name()}
                )
            raise
        finally:
            METHOD_DURATION.observe(self._now() - t0, labels)

    def create(self, node_claim):
        return self._timed("Create", self.inner.create, node_claim)

    def delete(self, node_claim) -> None:
        return self._timed("Delete", self.inner.delete, node_claim)

    def get(self, provider_id: str):
        return self._timed("Get", self.inner.get, provider_id)

    def list(self) -> List:
        return self._timed("List", self.inner.list)

    def get_instance_types(self, node_pool) -> List[InstanceType]:
        return self._timed(
            "GetInstanceTypes", self.inner.get_instance_types, node_pool
        )

    def is_drifted(self, node_claim) -> str:
        return self._timed("IsDrifted", self.inner.is_drifted, node_claim)

    def repair_policies(self) -> List[RepairPolicy]:
        return self.inner.repair_policies()

    def name(self) -> str:
        return self.inner.name()

    def __getattr__(self, item):
        # pass through provider extensions (e.g. kwok's
        # process_registrations) so the decorator is transparent
        return getattr(self.inner, item)


__all__ = [
    "MetricsCloudProvider", "METHOD_DURATION", "METHOD_ERRORS",
    "INSUFFICIENT_CAPACITY",
]
