# Copied from karpenter_tpu/metrics/__init__.py.
from .registry import Counter, Gauge, Histogram, Registry, REGISTRY

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY"]
