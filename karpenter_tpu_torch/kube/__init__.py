# Copied from karpenter_tpu/kube/__init__.py, without FileClient.
from .clock import Clock, RealClock, TestClock
from .store import Client, Event, NotFoundError, ConflictError, AlreadyExistsError

__all__ = [
    "Clock",
    "RealClock",
    "TestClock",
    "Client",
    "Event",
    "NotFoundError",
    "ConflictError",
    "AlreadyExistsError",
]
