# Copied from karpenter_tpu/analysis/core/__init__.py.
"""Shared dataflow core for the analysis passes.

The first-generation passes (TRC/BLK/RTY/OBS) were per-function AST
pattern matchers: one sequential walk, one mutable name->kind table, no
notion of control flow or of values crossing a helper call. That shape
cannot see the flows the device-residency (DTX9xx) and clock-discipline
(CLK10xx) contracts are about — a device array threaded through an
``if``/``else`` merge into a truthiness test, a ``time.monotonic``
reference stashed in a variable and called three statements later, a
helper that returns a kernel-dispatch result under a different name.

This package is the replacement substrate, shared by every dataflow-
shaped rule family:

- ``cfg``       — intraprocedural control-flow graph over function bodies
                  (basic blocks of *atoms*: statements, branch tests,
                  loop binds, nested defs), with loop back-edges and
                  conservative exception edges;
- ``lattice``   — small integer join-semilattices with pointwise-join
                  environments (name -> lattice value), including the
                  poison-to-unknown discipline: an analysis that loses
                  track of a value joins it to TOP and never flags it
                  (false negatives over false positives, the same rule
                  shapes.py pinned);
- ``dataflow``  — the forward worklist engine: fixpoint block-entry
                  environments, then a deterministic per-block check
                  sweep re-running the transfer for intra-block
                  precision;
- ``summaries`` — one-level call-graph summaries for same-module
                  helpers (mirroring how PAR5xx resolves shared
                  constants): a bare-name call to a local helper gets
                  the join of the helper's return-expression kinds
                  instead of defaulting to unknown.

Rule families hosted on the core: tracer.py (TRC1xx, migrated),
retry.py (RTY7xx bound detection, migrated), device.py (DTX9xx),
clock.py (CLK10xx). The passes stay parse-only: nothing here imports
the analyzed code.
"""

from .cfg import CFG, Atom, Block, build_cfg
from .dataflow import Env, run_forward, sweep
from .lattice import Lattice
from .summaries import ModuleInfo, ReturnSummaries, load_modules

__all__ = [
    "CFG", "Atom", "Block", "build_cfg",
    "Env", "run_forward", "sweep",
    "Lattice",
    "ModuleInfo", "ReturnSummaries", "load_modules",
]
