# Copied from karpenter_tpu/analysis/atomicity.py.
"""Pass: atomicity and tree-wide lock order (ATM14xx).

Two hazards the per-class guarded-by inference (guarded.py) cannot see:

- **ATM1401 check-then-act across a lock release.** A guarded read binds
  a local, the lock is released, the local feeds a branch decision, and
  the branch re-acquires the same lock to write the same attribute. The
  window between release and re-acquire is the classic lost-update
  shape (the adaptive ``nmax_hint`` bug class): another thread's write
  lands in the gap and the late writer clobbers it. The fix is either
  one critical section or a commutative merge (``max``/CAS) computed
  UNDER the second lock.
- **ATM1402 interprocedural lock-order cycles across modules.** The
  locks pass (LCK201) claims cycles whose locks live in one module; this
  pass runs the SAME held-set symbolic walk (locks.build_analyzer) over
  the whole threaded tree and claims the complementary population —
  acquisition cycles threading through ≥2 modules (EncodeCache →
  residency → queue edges), which a store-local scan can never connect.

Both ride the PR-16 call-graph core: one ``load_modules`` parse feeds
the locks-pass walk, and the ATM1401 scan reuses its lock-identity
resolution (``expr_lock``) so ``self._cv``/inherited locks resolve the
same way everywhere.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core.summaries import load_modules
from .findings import Finding, Severity, SourceFile
from .locks import _Analyzer, _ClassInfo, _File, _short, build_analyzer

RULES = {
    "ATM1400": "unparsable file (atomicity pass)",
    "ATM1401": "check-then-act split across a lock release "
               "(lost-update window)",
    "ATM1402": "interprocedural lock-order cycle across modules",
}

_MUTATORS = frozenset({
    "append", "add", "clear", "pop", "popitem", "update", "setdefault",
    "remove", "extend", "discard", "insert", "popleft", "appendleft",
})


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _attr_reads(node: ast.AST) -> Set[str]:
    """`self.attr` loads anywhere under ``node`` (bare or subscripted)."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        attr = _self_attr(sub)
        if attr is not None:
            out.add(attr)
    return out


def _attr_writes(stmts: Sequence[ast.stmt]) -> Dict[str, int]:
    """attr -> first write line for writes inside ``stmts``: assignments
    to ``self.attr``/``self.attr[k]`` and mutator method calls."""
    out: Dict[str, int] = {}

    def note(attr: Optional[str], line: int) -> None:
        if attr is not None and attr not in out:
            out[attr] = line

    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    note(_self_attr(target), node.lineno)
                    if isinstance(target, (ast.Subscript, ast.Attribute)):
                        note(_self_attr(target.value), node.lineno)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                note(_self_attr(node.target), node.lineno)
                if isinstance(node.target, (ast.Subscript, ast.Attribute)):
                    note(_self_attr(node.target.value), node.lineno)
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in _MUTATORS:
                note(_self_attr(node.func.value), node.lineno)
    return out


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _CheckThenAct:
    """Per-method linear scan for the ATM1401 shape."""

    def __init__(self, analyzer: _Analyzer, findings: List[Finding]):
        self.analyzer = analyzer
        self.findings = findings

    def scan_method(self, file: _File, cls: _ClassInfo,
                    fn: ast.FunctionDef) -> None:
        self._scan_seq(file, cls, fn.body, tainted={})

    def _with_lock(self, stmt: ast.With, file: _File,
                   cls: _ClassInfo) -> Optional[str]:
        for item in stmt.items:
            info = self.analyzer.expr_lock(item.context_expr, file, cls)
            if info is not None:
                return info.ident
        return None

    def _scan_seq(self, file: _File, cls: _ClassInfo,
                  stmts: Sequence[ast.stmt],
                  tainted: Dict[str, Tuple[str, str, int]]) -> None:
        """``tainted`` maps a local name to (lock ident, attr, read line)
        for locals bound from a guarded read whose lock has since been
        released."""
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                lock = self._with_lock(stmt, file, cls)
                if lock is not None:
                    # harvest locals bound from guarded reads; the lock
                    # releases when this block ends
                    for inner in stmt.body:
                        if isinstance(inner, ast.Assign) and \
                                len(inner.targets) == 1 and \
                                isinstance(inner.targets[0], ast.Name):
                            reads = _attr_reads(inner.value)
                            if reads:
                                attr = sorted(reads)[0]
                                tainted[inner.targets[0].id] = (
                                    lock, attr, inner.lineno
                                )
                    self._scan_seq(file, cls, stmt.body, dict(tainted))
                    continue
                self._scan_seq(file, cls, stmt.body, tainted)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                test_names = _names_in(stmt.test)
                hits = {
                    name: info for name, info in tainted.items()
                    if name in test_names
                }
                if hits:
                    self._flag_reacquire(file, cls, stmt, hits)
                for children in (stmt.body, stmt.orelse):
                    self._scan_seq(file, cls, children, dict(tainted))
                continue
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name):
                # rebinding a tainted local severs the taint
                tainted.pop(stmt.targets[0].id, None)
            for attr_name in ("body", "orelse", "finalbody"):
                children = getattr(stmt, attr_name, None)
                if children:
                    self._scan_seq(file, cls, children, dict(tainted))
            for handler in getattr(stmt, "handlers", []) or []:
                self._scan_seq(file, cls, handler.body, dict(tainted))

    def _flag_reacquire(
        self, file: _File, cls: _ClassInfo, branch: ast.stmt,
        hits: Dict[str, Tuple[str, str, int]],
    ) -> None:
        """A branch decided by a stale guarded read: flag any with-block
        inside it that re-acquires the same lock and writes the read
        attribute."""
        for node in ast.walk(branch):
            if not isinstance(node, ast.With):
                continue
            lock = self._with_lock(node, file, cls)
            if lock is None:
                continue
            writes = _attr_writes(node.body)
            for local, (t_lock, attr, read_line) in sorted(hits.items()):
                if t_lock == lock and attr in writes:
                    self.findings.append(
                        Finding(
                            "ATM1401", Severity.ERROR, file.path,
                            node.lineno,
                            f"check-then-act on self.{attr}: read under "
                            f"{_short(lock)} at line {read_line} into "
                            f"'{local}', decision taken after release, "
                            "write re-acquires the lock — another "
                            "thread's update in the gap is lost; merge "
                            "into one critical section or recompute "
                            "under the second lock",
                        )
                    )


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Run the atomicity pass; returns (findings, sources)."""
    findings: List[Finding] = []
    modules, sources, errors = load_modules(paths)
    for path, exc in errors:
        findings.append(
            Finding("ATM1400", Severity.ERROR, path, 0, f"unparsable: {exc}")
        )
    # tree-wide acquisition graph: the locks-pass walk, cross-module
    # cycles claimed here (module-local ones are LCK201's)
    analyzer = build_analyzer(modules)
    analyzer.findings = []  # drop the walk's LCK202/LCK203 (locks' beat)
    analyzer.detect_cycles(rule="ATM1402", cross_module_only=True)
    findings.extend(analyzer.findings)

    cta = _CheckThenAct(analyzer, findings)
    for f in analyzer.files:
        for cls in f.classes.values():
            if not any(c.locks for c in analyzer.mro(cls)):
                continue
            for mname, method in cls.methods.items():
                if mname != "__init__":
                    cta.scan_method(f, cls, method)

    unique: Dict[Tuple[str, str, int], Finding] = {}
    for finding in findings:
        unique.setdefault((finding.rule, finding.path, finding.line), finding)
    return list(unique.values()), sources
