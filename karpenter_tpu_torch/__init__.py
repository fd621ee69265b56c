"""karpenter_tpu_torch — the PyTorch/CUDA port of karpenter_tpu.

A second package beside the JAX one: the same provisioning solve and
consolidation search, with their device programs as hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).
The JAX package stays the reference; each ported module is held exactly
against it (tests/test_torch_*.py). Nothing here imports jax or
karpenter_tpu: host modules the solve needs are copied, each naming its
source on its first line.

Layout (each module at the relative path of its JAX counterpart):
  api/ cloudprovider/ kube/ events/ scheduling/ faults/ obs/ metrics/
  utils/ controllers/
                  copied host modules (controllers/: the cluster state and
                  the disruption methods)
  solver/         encode + vocab (copied), args (numpy -> device tensors),
                  driver (TorchSolver), example + workloads builders
  ops/            feasibility, packing, solve: plain PyTorch versions and
                  the wrappers that launch the kernels on CUDA tensors
  csrc/           the CUDA kernels; _build.py compiles them with nvcc
"""

__version__ = "0.1.0"
