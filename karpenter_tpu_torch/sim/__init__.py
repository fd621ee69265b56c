# Copied from karpenter_tpu/sim/__init__.py.
from .binder import Binder

__all__ = ["Binder"]

# trace/slo/twin are imported as submodules (karpenter_tpu.sim.twin etc.)
# rather than re-exported here: the binder is the only piece the operator
# path needs, and the twin pulls in the whole controller roster.
