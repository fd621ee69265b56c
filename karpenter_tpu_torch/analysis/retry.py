# Copied from karpenter_tpu/analysis/retry.py.
"""Pass 7: retry/except hygiene in the fault-handling paths.

The robustness tier (karpenter_tpu/faults/) only works if every seam
either retries through a clock-driven ``Backoff``/``RetryTracker`` or
surfaces its failure where the breaker and the requeue machinery can see
it. Two anti-patterns defeat it structurally, and both are statically
visible:

- **RTY701 — swallowed failure**: an ``except Exception:`` (or bare
  ``except:`` / ``except BaseException:``) whose body is only
  ``pass``/``continue``/``...``. The fault disappears: no event, no
  metric, no backoff, and the chaos soak can never attribute the orphan
  it produces. Typed catches (``except ConflictError: continue``) are the
  designed idiom and are NOT flagged — the type documents exactly which
  transient the level-triggered loop absorbs.
- **RTY702 — unbounded retry loop**: a ``while True`` loop whose
  ``except`` handler keeps looping (``continue``, or a body that just
  falls through) with no visible bound anywhere in the loop — no attempt
  counter, no ``Backoff``/``RetryTracker``/clock call, no
  raise/break/return in the handler. Under a persistent fault such a
  loop spins the reconcile thread forever; ``Backoff.call`` is the
  bounded replacement.

Hosted on the dataflow core's module layer (analysis/core/summaries):
the bound detection reaches through helpers over the module-set call
graph — a loop whose handler calls ``self._pause()`` or a module-level
``_backoff_step()`` that itself touches a Backoff/clock/attempt bound
(directly, or through further helpers) is bounded, where the
first-generation AST matcher only saw the loop's own text and flagged
it (those false positives are why the reach exists; suppressions they
used to require are deleted, not kept). Recursive helper clusters
collapse to "no bound" by SCC — a cycle can't vouch for itself.

The bound detection stays deliberately permissive (any attempt-counter-ish
name comparison, any backoff/clock reference, any escape statement in the
handler counts): the rule exists to catch the *structurally* unbounded
shape, not to lint retry style.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .astutil import dotted_name
from .core.summaries import (
    ModuleInfo,
    SummaryTable,
    build_call_graph,
    load_modules,
    resolve_local,
)
from .findings import Finding, Severity, SourceFile

RULES = {
    "RTY700": "unparsable file (retry pass)",
    "RTY701": "broad exception handler silently swallows the failure",
    "RTY702": "retry loop without a Backoff/attempt/clock bound",
}

_BROAD = {"Exception", "BaseException"}
_SWALLOW_BODY = (ast.Pass, ast.Continue)
_BOUND_NAME_HINTS = ("backoff", "attempt", "retries", "tries", "deadline")
_BOUND_CALL_ATTRS = {"sleep", "delay", "ready", "failure", "call", "retry"}

# summary values for the call-graph helper reach
_NO_BOUND = 0
_HAS_BOUND = 1


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in _BROAD for n in names)


def _swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler body does nothing but loop/fall through."""
    return all(
        isinstance(stmt, _SWALLOW_BODY)
        or (isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis)
        for stmt in handler.body
    )


def _ident_chain(node: ast.AST) -> str:
    """Lowercased dotted-ish identifier text of a Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts)).lower()


def _own_bound_evidence(node: ast.AST) -> bool:
    """Bound evidence in ``node``'s own text (no helper reach)."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            ident = _ident_chain(sub)
            if any(h in ident for h in _BOUND_NAME_HINTS):
                return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            if sub.func.attr in _BOUND_CALL_ATTRS:
                return True
    return False


def _call_targets(
    node: ast.AST, mod: ModuleInfo, modules: Dict[str, ModuleInfo]
) -> List[Tuple[ModuleInfo, ast.FunctionDef]]:
    """Resolvable helper targets of every call inside ``node``: bare
    names through resolve_local, ``self._helper()`` against every class
    method table in the module (conservative: any method of that name
    counts)."""
    out: List[Tuple[ModuleInfo, ast.FunctionDef]] = []
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        raw = dotted_name(sub.func)
        if raw is not None and "." not in raw:
            target = resolve_local(mod, raw, modules)
            if target is not None:
                out.append(target)
        elif (
            isinstance(sub.func, ast.Attribute)
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id == "self"
        ):
            for table in mod.index.methods.values():
                if sub.func.attr in table:
                    out.append((mod, table[sub.func.attr]))
                    break
    return out


def _helper_bound_summary(
    mod: ModuleInfo,
    fn: ast.FunctionDef,
    modules: Dict[str, ModuleInfo],
    summaries: SummaryTable,
) -> int:
    """Does the helper carry bound evidence — in its own body, or in any
    helper it reaches over the call graph? Bottom-up through the
    SummaryTable; recursive clusters read _NO_BOUND by SCC collapse (a
    cycle of helpers deferring to each other proves nothing)."""

    def compute() -> int:
        if _own_bound_evidence(fn):
            return _HAS_BOUND
        for t_mod, t_fn in _call_targets(fn, mod, modules):
            if t_fn is fn:
                continue
            if _helper_bound_summary(t_mod, t_fn, modules, summaries):
                return _HAS_BOUND
        return _NO_BOUND

    return summaries.get((mod.path, fn.name), compute)


def _has_bound(
    loop: ast.While,
    mod: Optional[ModuleInfo],
    modules: Dict[str, ModuleInfo],
    summaries: Optional[SummaryTable],
) -> bool:
    """Any structural evidence the loop's retrying is bounded — in the
    loop's own text, or any number of helper hops away on the call
    graph."""
    if _own_bound_evidence(loop):
        return True
    if mod is None or summaries is None:
        return False
    for t_mod, t_fn in _call_targets(loop, mod, modules):
        if _helper_bound_summary(t_mod, t_fn, modules, summaries):
            return True
    return False


def _handler_escapes(handler: ast.ExceptHandler) -> bool:
    """The handler itself can leave the loop (raise/break/return)."""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Break, ast.Return)):
            return True
    return False


def _loops_forever(test: ast.expr) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    findings: List[Finding] = []
    modules, sources, errors = load_modules(paths)
    for path, exc in errors:
        findings.append(
            Finding("RTY700", Severity.ERROR, path, 0, f"unparsable: {exc}")
        )
    summaries = SummaryTable(default=_NO_BOUND, graph=build_call_graph(modules))
    for path, mod in modules.items():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ExceptHandler):
                if _is_broad(node) and _swallows(node):
                    findings.append(
                        Finding(
                            "RTY701", Severity.ERROR, path, node.lineno,
                            "broad except swallows the failure with no "
                            "event/metric/backoff; catch the specific "
                            "transient type, or record before requeueing",
                        )
                    )
            elif isinstance(node, ast.While) and _loops_forever(node.test):
                retrying = [
                    h
                    for t in ast.walk(node)
                    if isinstance(t, ast.Try)
                    for h in t.handlers
                    if not _handler_escapes(h)
                ]
                if retrying and not _has_bound(node, mod, modules, summaries):
                    findings.append(
                        Finding(
                            "RTY702", Severity.ERROR, path, node.lineno,
                            "while-True retry loop with a non-escaping "
                            "except handler and no visible bound (attempt "
                            "counter, Backoff/RetryTracker, clock); use "
                            "faults.backoff.Backoff.call",
                        )
                    )
    return findings, sources
