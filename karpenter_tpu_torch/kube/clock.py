# Copied from karpenter_tpu/kube/clock.py.
"""Injectable clock, mirroring the reference's use of k8s.io/utils/clock.

Controllers never call time.time() directly; tests drive a TestClock the way
the reference's suites drive clock.FakeClock.
"""

from __future__ import annotations

import abc
import time


class Clock(abc.ABC):
    @abc.abstractmethod
    def now(self) -> float:
        ...

    @abc.abstractmethod
    def sleep(self, seconds: float) -> None:
        ...

    def since(self, t: float) -> float:
        return self.now() - t


class RealClock(Clock):
    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class TestClock(Clock):
    __test__ = False  # not a pytest class

    def __init__(self, start: float = 1_000_000.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self._now += seconds

    def step(self, seconds: float) -> None:
        self._now += seconds

    def set(self, t: float) -> None:
        self._now = t
