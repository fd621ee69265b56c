# Copied from karpenter_tpu/analysis/core/cfg.py.
"""Intraprocedural CFG over a function body.

Blocks hold *atoms* — the unit the transfer functions consume:

- ``("stmt", node)``   a simple statement (Assign, Expr, Return, ...)
- ``("test", expr)``   a branch condition being evaluated (``label``
                       says which construct: if / while / assert)
- ``("for", node)``    a For header: the iterable is evaluated and the
                       loop target bound once per entry
- ``("with", item)``   one withitem: context expr evaluated, optional
                       ``as`` target bound
- ``("except", h)``    an except handler's name binding
- ``("def", node)``    a nested FunctionDef/AsyncFunctionDef/ClassDef

Edges follow Python's control flow: if/else diamonds, loop back-edges
(with ``break``/``continue`` routed to the loop exit/header), try bodies
with conservative exception edges (every block spawned inside a ``try``
body edges to every handler entry — a may-analysis over-approximation,
since the exception can fire at any point), and ``finally`` blocks on
the join. ``return``/``raise`` terminate their block; ``return`` still
edges into enclosing ``finally`` atoms via the exit path being cut —
the analyses here are flow-insensitive past a return, which is safe for
join-based may-analyses.

Block ids increase in syntactic creation order, so a deterministic
check sweep over ``sorted(blocks)`` reports findings in source order.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass
class Atom:
    kind: str  # "stmt" | "test" | "for" | "with" | "except" | "def"
    node: ast.AST
    label: str = ""


@dataclass
class Block:
    id: int
    atoms: List[Atom] = field(default_factory=list)
    succs: List[int] = field(default_factory=list)

    def edge(self, other: "Block") -> None:
        if other.id not in self.succs:
            self.succs.append(other.id)


@dataclass
class CFG:
    entry: int
    blocks: List[Block]

    def block(self, bid: int) -> Block:
        return self.blocks[bid]


_SIMPLE = (
    ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr, ast.Return,
    ast.Raise, ast.Delete, ast.Pass, ast.Global, ast.Nonlocal,
    ast.Import, ast.ImportFrom,
)

_TERMINATORS = (ast.Return, ast.Raise)


class _Builder:
    def __init__(self):
        self.blocks: List[Block] = []
        # (header_block, after_block) per enclosing loop, for continue/break
        self.loops: List[Tuple[Block, Block]] = []

    def new(self) -> Block:
        b = Block(id=len(self.blocks))
        self.blocks.append(b)
        return b

    # -- statement walk ---------------------------------------------------

    def walk(self, stmts: Sequence[ast.stmt], cur: Block) -> Optional[Block]:
        """Append ``stmts`` starting at ``cur``; returns the fall-through
        block, or None when every path terminated (return/raise/break)."""
        for stmt in stmts:
            if cur is None:
                # dead code after a terminator: still walked (findings in
                # unreachable code are findings), rooted in a fresh block
                cur = self.new()
            cur = self._stmt(stmt, cur)
        return cur

    def _stmt(self, stmt: ast.stmt, cur: Block) -> Optional[Block]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            cur.atoms.append(Atom("def", stmt))
            return cur
        if isinstance(stmt, _SIMPLE):
            cur.atoms.append(Atom("stmt", stmt))
            if isinstance(stmt, _TERMINATORS):
                return None
            return cur
        if isinstance(stmt, ast.Assert):
            cur.atoms.append(Atom("test", stmt.test, "assert"))
            if stmt.msg is not None:
                cur.atoms.append(Atom("stmt", ast.Expr(value=stmt.msg)))
            return cur
        if isinstance(stmt, ast.If):
            cur.atoms.append(Atom("test", stmt.test, "if"))
            after = self.new()
            then_entry = self.new()
            cur.edge(then_entry)
            then_exit = self.walk(stmt.body, then_entry)
            if then_exit is not None:
                then_exit.edge(after)
            if stmt.orelse:
                else_entry = self.new()
                cur.edge(else_entry)
                else_exit = self.walk(stmt.orelse, else_entry)
                if else_exit is not None:
                    else_exit.edge(after)
            else:
                cur.edge(after)
            return after
        if isinstance(stmt, ast.While):
            header = self.new()
            cur.edge(header)
            header.atoms.append(Atom("test", stmt.test, "while"))
            after = self.new()
            body_entry = self.new()
            header.edge(body_entry)
            header.edge(after)
            self.loops.append((header, after))
            body_exit = self.walk(stmt.body, body_entry)
            self.loops.pop()
            if body_exit is not None:
                body_exit.edge(header)
            return self._loop_else(stmt, header, after)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            header = self.new()
            cur.edge(header)
            header.atoms.append(Atom("for", stmt))
            after = self.new()
            body_entry = self.new()
            header.edge(body_entry)
            header.edge(after)
            self.loops.append((header, after))
            body_exit = self.walk(stmt.body, body_entry)
            self.loops.pop()
            if body_exit is not None:
                body_exit.edge(header)
            return self._loop_else(stmt, header, after)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                cur.atoms.append(Atom("with", item))
            return self.walk(stmt.body, cur)
        if isinstance(stmt, ast.Try):
            first_body_block = len(self.blocks)
            body_entry = self.new()
            cur.edge(body_entry)
            # one block boundary after every body statement: the
            # exception can fire between any two of them, so each
            # partial-execution state must be a block exit the handler
            # edges can observe
            body_exit: Optional[Block] = body_entry
            for s in stmt.body:
                if body_exit is None:
                    body_exit = self.new()
                nxt = self._stmt(s, body_exit)
                if nxt is None:
                    body_exit = None
                else:
                    boundary = self.new()
                    nxt.edge(boundary)
                    body_exit = boundary
            body_blocks = self.blocks[first_body_block:]
            after = self.new()
            # handlers: the exception may fire anywhere in the body, so
            # every body-spawned block (and the pre-try block) edges in
            for handler in stmt.handlers:
                h_entry = self.new()
                h_entry.atoms.append(Atom("except", handler))
                cur.edge(h_entry)
                for b in body_blocks:
                    b.edge(h_entry)
                h_exit = self.walk(handler.body, h_entry)
                if h_exit is not None:
                    h_exit.edge(after)
            if stmt.orelse:
                if body_exit is not None:
                    else_exit = self.walk(stmt.orelse, body_exit)
                    if else_exit is not None:
                        else_exit.edge(after)
            elif body_exit is not None:
                body_exit.edge(after)
            if stmt.finalbody:
                fin_exit = self.walk(stmt.finalbody, after)
                return fin_exit
            return after
        if isinstance(stmt, ast.Break):
            if self.loops:
                cur.edge(self.loops[-1][1])
            return None
        if isinstance(stmt, ast.Continue):
            if self.loops:
                cur.edge(self.loops[-1][0])
            return None
        if isinstance(stmt, ast.Match):
            cur.atoms.append(Atom("test", stmt.subject, "match"))
            after = self.new()
            for case in stmt.cases:
                c_entry = self.new()
                cur.edge(c_entry)
                c_exit = self.walk(case.body, c_entry)
                if c_exit is not None:
                    c_exit.edge(after)
            cur.edge(after)  # no case may match
            return after
        # anything else (future syntax): treat as an opaque statement
        cur.atoms.append(Atom("stmt", stmt))
        return cur

    def _loop_else(self, stmt, header: Block, after: Block) -> Block:
        if stmt.orelse:
            else_entry = self.new()
            header.edge(else_entry)
            else_exit = self.walk(stmt.orelse, else_entry)
            if else_exit is not None:
                else_exit.edge(after)
        return after


def build_cfg(body: Sequence[ast.stmt]) -> CFG:
    """CFG for a statement list (a function body or a module)."""
    builder = _Builder()
    entry = builder.new()
    builder.walk(body, entry)
    return CFG(entry=entry.id, blocks=builder.blocks)


__all__ = ["Atom", "Block", "CFG", "build_cfg"]
