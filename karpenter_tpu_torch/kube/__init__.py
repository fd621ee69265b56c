# Copied from karpenter_tpu/kube/__init__.py.
from .clock import Clock, RealClock, TestClock
from .filestore import FileClient
from .store import Client, Event, NotFoundError, ConflictError, AlreadyExistsError

__all__ = [
    "Clock",
    "RealClock",
    "TestClock",
    "Client",
    "FileClient",
    "Event",
    "NotFoundError",
    "ConflictError",
    "AlreadyExistsError",
]
