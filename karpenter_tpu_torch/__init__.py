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
  utils/ controllers/ sim/
                  copied host modules (controllers/: the cluster state,
                  provisioning, lifecycle, termination, housekeeping,
                  metrics and the disruption methods; sim/: the pod binder)
  operator.py options.py __main__.py
                  the control plane: ``python -m karpenter_tpu_torch``
  solver/         encode + vocab (copied), args (numpy -> device tensors),
                  driver (TorchSolver), example + workloads builders, and
                  the sidecar: wire (copied), tenancy, service
                  (``python -m karpenter_tpu_torch.solver.service``)
  ops/            feasibility, packing, solve: plain PyTorch versions and
                  the wrappers that launch the kernels on CUDA tensors
  parallel/       the solver mesh: one solve over several devices
  csrc/           the CUDA kernels; _build.py compiles them with nvcc
"""

__version__ = "0.1.0"
