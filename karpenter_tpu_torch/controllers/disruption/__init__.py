# Copied from karpenter_tpu/controllers/disruption/__init__.py.
from .controller import DisruptionController
from .types import Candidate, Command

__all__ = ["DisruptionController", "Candidate", "Command"]
