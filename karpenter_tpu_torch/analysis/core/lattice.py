# Copied from karpenter_tpu/analysis/core/lattice.py.
"""Small integer join-semilattices for the dataflow passes.

Every pass models values as small non-negative integers ordered by
``max``: 0 is bottom ("nothing interesting"), the largest level is top.
Two disciplines coexist on that shape:

- **taint-style** (tracer): the interesting kind (TRACED) is the top —
  joining "traced on one path" with "static on the other" yields traced,
  so a sink reachable with a traced value on ANY path flags. Missing
  names default to bottom.
- **poison-to-unknown** (device, clock): UNKNOWN sits ABOVE the
  interesting kind. A merge with a value the analysis lost track of
  poisons the result to unknown, and sinks flag only on the *definite*
  kind — the false-negative-over-false-positive rule shapes.py pinned,
  now a lattice property instead of a convention.

The ``Lattice`` object is a tiny descriptor: the default for unbound
names and the top used for poisoning. Join is always ``max``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Lattice:
    """Join-semilattice descriptor over {0 .. top} with join = max.

    ``default`` is the value assumed for names with no binding (bottom
    for taint-style lattices, top/unknown for poison-style ones when a
    pass prefers to distrust unbound names).
    """

    top: int
    default: int = 0

    def join(self, a: int, b: int) -> int:
        return a if a >= b else b


__all__ = ["Lattice"]
