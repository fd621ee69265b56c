"""Static-analysis tier for the PyTorch/CUDA port: AST passes for the
hazards the runtime cannot see, pointed at ``karpenter_tpu_torch/``.

The JAX package's analyzer (``karpenter_tpu/analysis``), carried over:
most families are verbatim copies (each file names its source on its
first line) run over the port's tree, one is retargeted, and three are
the port's own:

- parity.py (PAR50x): the three bit-exact twins of the packing scan —
  the plain versions ``pack_reference`` / ``pack_classed_reference``
  (ops/packing.py), the CUDA scans (``csrc/pack_common.cuh`` with
  ``pack.cu`` and ``pack_classed.cu``, read as one twin) and the C++
  host core ``native/solve_core.cc`` — compared by semantic skeletons
  and ``parity:`` anchors, with torch's dtypes and reductions in the
  vocabulary;
- device.py (DTX9xx): the torch host-sync rule. Tensors made on or moved
  to the card, kernel launchers' returns and the residency store's
  buffers are tracked to the sinks that wait for the card (truthiness,
  ``int()``/``float()``, ``.item()``/``.tolist()``/``.numpy()``,
  ``np.asarray``, iteration, printing); every ``.cpu()`` and
  ``torch.cuda.synchronize`` is DTX906 and must carry
  ``# analysis: sanctioned[DTX906] reason``. ``chip_smoke.py`` holds the
  sanctioned sites against the syncs the card reports;
- cli.py: the port's targets and its own, empty baseline
  (``karpenter_tpu_torch/analysis/baseline.txt``).

The retargeted family: shapes (SHP6xx), JAX's axis/dtype walker over
torch: axes bound at the ``torch`` constructors, ``*_like``, ``new_*``
and ``.shape`` unpacking, propagated through torch's operators, views
and reductions; explicit 64-bit dtypes (the int64 index tensors torch
requires are sanctioned at their lines); literal non-pow2 dims; and
SHP604 at the mesh's sinks ``place`` and ``cut`` (parallel/mesh.py's
specs), over ops/, solver/ and parallel/.

The verbatim families: locks (LCK2xx), blocking (BLK3xx), schema drift
(SCH4xx, api/schema.py against the copied api/crds/), retry (RTY7xx),
obs (OBS8xx), clock (CLK10xx), det (DET11xx), args (ARG12xx: the kernel
registry's surfaces), guarded (GRD13xx), atomicity (ATM14xx) and the
stale-suppression audit (STALE001).

Left out, by design: tracer (TRC1xx). It concerns Python control flow
under ``jit`` tracing (a branch on a traced value, a Python loop unrolled
into the program), and the port runs eagerly, with no tracing; its
host-sync half is the torch host-sync rule above (device.py).

The ``args`` pass reads the solver mesh's surface too
(``parallel/mesh.py``: ARG_SPECS against ``pad_args_for_mesh``, ARG1204).

Run ``python -m karpenter_tpu_torch.analysis`` from the repo root; it
exits nonzero on any new finding. Suppress with an inline
``# analysis: ignore[RULE] reason`` on the flagged line (or the line
above; ``//`` in C++ sources) or a baseline entry; documented boundary
crossings carry ``# analysis: sanctioned[RULE] reason`` — counted
separately, audited for staleness all the same (STALE001).
"""

from typing import Dict

from .findings import (
    Finding,
    Severity,
    filter_suppressed,
    load_baseline,
    partition_findings,
)


def all_rules() -> Dict[str, str]:
    """Every rule id the port ships -> one-line description, aggregated
    from the pass modules. tests/test_torch_analysis.py asserts each has
    a seeded-bad fixture."""
    from . import (
        args_registry, atomicity, blocking, clock, det, device, guarded,
        locks, obs, parity, retry, schema_drift, shapes, stale,
    )

    out: Dict[str, str] = {}
    for mod in (
        locks, blocking, schema_drift, parity, shapes, retry, obs, device,
        clock, det, args_registry, guarded, atomicity, stale,
    ):
        out.update(getattr(mod, "RULES", {}))
    for rule in NOT_SHIPPED:
        out.pop(rule)
    return out


# rules of a copied module that never run over the port: none since the
# mesh surface (parallel/mesh.py) is there for ARG1204
NOT_SHIPPED = ()


__all__ = [
    "Finding", "Severity", "load_baseline", "filter_suppressed",
    "partition_findings", "all_rules",
]
