# Copied from karpenter_tpu/analysis/core/dataflow.py.
"""Forward worklist dataflow over the core CFG.

Two phases, both driven by a client-supplied transfer function:

1. ``run_forward`` — fixpoint: block-entry environments computed by
   iterating transfer over atoms and joining into successors until
   nothing changes. Monotone by construction (environments only move up
   the lattice under ``max``-join), so termination is bounded by
   |blocks| x |names| x lattice height.
2. ``sweep`` — the reporting pass: blocks visited in syntactic order,
   each starting from its fixpoint entry environment, re-running
   transfer after the client's per-atom check hook so intra-block
   precision matches a sequential read of the source.

Environments are plain ``name -> int`` dicts wrapped with lattice-aware
join; clients keep richer side tables (helper summaries, flagged lines)
on their own analysis object.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .cfg import CFG, Atom
from .lattice import Lattice


class Env:
    """name -> lattice value with pointwise join. Missing names read as
    the lattice default."""

    __slots__ = ("lattice", "kinds")

    def __init__(self, lattice: Lattice, kinds: Dict[str, int] = None):
        self.lattice = lattice
        self.kinds: Dict[str, int] = dict(kinds or {})

    def get(self, name: str) -> int:
        return self.kinds.get(name, self.lattice.default)

    def has(self, name: str) -> bool:
        return name in self.kinds

    def set(self, name: str, kind: int) -> None:
        self.kinds[name] = kind

    def clone(self) -> "Env":
        return Env(self.lattice, self.kinds)

    def join_from(self, other: "Env") -> bool:
        """Pointwise join ``other`` into self; True when self changed."""
        changed = False
        for name, kind in other.kinds.items():
            mine = self.kinds.get(name)
            if mine is None:
                self.kinds[name] = kind
                changed = True
            else:
                joined = self.lattice.join(mine, kind)
                if joined != mine:
                    self.kinds[name] = joined
                    changed = True
        return changed


TransferFn = Callable[[Atom, Env], None]
CheckFn = Callable[[Atom, Env], None]


def run_forward(cfg: CFG, init: Env, transfer: TransferFn) -> Dict[int, Env]:
    """Fixpoint block-entry environments for ``cfg`` from ``init``."""
    entry_envs: Dict[int, Env] = {cfg.entry: init.clone()}
    worklist: List[int] = [cfg.entry]
    while worklist:
        bid = worklist.pop(0)
        env = entry_envs[bid].clone()
        for atom in cfg.block(bid).atoms:
            transfer(atom, env)
        for succ in cfg.block(bid).succs:
            known = entry_envs.get(succ)
            if known is None:
                entry_envs[succ] = env.clone()
                worklist.append(succ)
            elif known.join_from(env):
                if succ not in worklist:
                    worklist.append(succ)
    return entry_envs


def sweep(
    cfg: CFG,
    entry_envs: Dict[int, Env],
    init: Env,
    transfer: TransferFn,
    check: CheckFn,
) -> None:
    """Deterministic reporting sweep: every block in id (syntactic)
    order, checks interleaved with transfer for intra-block precision.
    Unreachable blocks (no fixpoint env) run from ``init`` — findings in
    dead code are still findings."""
    for block in cfg.blocks:
        env = entry_envs.get(block.id)
        env = env.clone() if env is not None else init.clone()
        for atom in block.atoms:
            check(atom, env)
            transfer(atom, env)


__all__ = ["Env", "run_forward", "sweep", "TransferFn", "CheckFn"]
