# Copied from karpenter_tpu/scheduling/__init__.py.
from .hostports import HostPortUsage
from .queue import Queue
from .topology import (
    Topology,
    TopologyDomainGroup,
    TopologyGroup,
    TopologyNodeFilter,
    TopologyType,
)

__all__ = [
    "HostPortUsage",
    "Queue",
    "Topology",
    "TopologyDomainGroup",
    "TopologyGroup",
    "TopologyNodeFilter",
    "TopologyType",
]
