# Copied from karpenter_tpu/analysis/obs.py.
"""Pass 8: observability hygiene (the obs/ tracing + metrics tiers).

Two anti-patterns structurally defeat the observability layer, and both
are statically visible:

- **OBS801 — span leak**: a ``tracer.span(...)`` / ``obs.span(...)`` call
  whose result is not closed deterministically. A span opened outside a
  ``with`` (and without a ``finally`` that ``.end()``s it) never pops the
  thread-local stack: every later span in that thread parents onto the
  leaked one, the Chrome export carries a dangling subtree, and the phase
  histograms silently miss the phase. Allowed shapes: the direct context
  manager (``with x.span(...)``), returning the span to the caller (a
  factory hands the context manager up — obs.span itself is this shape),
  passing it straight into ``enter_context``, and the assign-then-
  ``finally``-close idiom.
- **OBS802 — per-call metric churn**: a ``Counter``/``Gauge``/
  ``Histogram`` constructed inside a function. Every construction
  registers a NEW metric in the global registry (metrics/registry.py), so
  a per-call construction grows the registry without bound and forks the
  time series the scrape sees. Metrics belong at module scope, created
  once at import. Constructions that pass an explicit ``registry=`` are
  exempt — a scoped registry (tests, a sandboxed dump) is the designed
  way to build metrics dynamically.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from .astutil import iter_py_files, parse_file
from .findings import Finding, Severity, SourceFile

RULES = {
    "OBS800": "unparsable file (observability pass)",
    "OBS801": "span opened without context-manager or finally close",
    "OBS802": "metric constructed outside module scope (registry churn)",
}

_METRIC_NAMES = {"Counter", "Gauge", "Histogram"}


def _is_span_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr == "span"
    if isinstance(f, ast.Name):
        return f.id == "span"
    return False


def _metric_ctor_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name) and f.id in _METRIC_NAMES:
        return f.id
    if isinstance(f, ast.Attribute) and f.attr in _METRIC_NAMES:
        return f.attr
    return ""


def _allowed_span_calls(tree: ast.AST) -> Set[int]:
    """ids of span Call nodes used in one of the allowed closing shapes."""
    allowed: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.With) or isinstance(node, ast.AsyncWith):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    allowed.add(id(item.context_expr))
        elif isinstance(node, ast.Return) and isinstance(
            node.value, ast.Call
        ):
            # a factory returning the context manager for the caller's
            # `with` (obs.span itself, helpers that decorate a span)
            allowed.add(id(node.value))
        elif isinstance(node, ast.Call):
            # stack.enter_context(tracer.span(...))
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "enter_context":
                for arg in node.args:
                    if isinstance(arg, ast.Call):
                        allowed.add(id(arg))
    # conditional-expression returns: `return a.span() if c else NOOP`
    for node in ast.walk(tree):
        if isinstance(node, ast.Return) and isinstance(
            node.value, ast.IfExp
        ):
            for side in (node.value.body, node.value.orelse):
                if isinstance(side, ast.Call):
                    allowed.add(id(side))
    return allowed


def _finally_closed_targets(func: ast.AST) -> Set[str]:
    """Variable names ``X`` with ``X.end(...)`` / ``X.__exit__(...)``
    inside some ``finally`` block of ``func``."""
    out: Set[str] = set()
    for node in ast.walk(func):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        for stmt in node.finalbody:
            for call in ast.walk(stmt):
                if (
                    isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr in ("end", "__exit__", "close")
                    and isinstance(call.func.value, ast.Name)
                ):
                    out.add(call.func.value.id)
    return out


def _check_module(tree: ast.Module, path: str) -> List[Finding]:
    findings: List[Finding] = []
    allowed = _allowed_span_calls(tree)

    # map every node to its enclosing function (for OBS801's finally
    # idiom and OBS802's module-scope test)
    func_of: Dict[int, ast.AST] = {}
    for func in ast.walk(tree):
        if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for child in ast.walk(func):
                # innermost function wins: walk assigns outer first, inner
                # later, so later writes overwrite
                func_of[id(child)] = func

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _is_span_call(node) and id(node) not in allowed:
            func = func_of.get(id(node))
            target = _assigned_name(node, func)
            if (
                func is not None
                and target
                and target in _finally_closed_targets(func)
            ):
                continue
            findings.append(
                Finding(
                    "OBS801", Severity.ERROR, path, node.lineno,
                    "span opened without `with` or a finally close: the "
                    "thread-local span stack leaks and later spans parent "
                    "onto the leaked one; use `with tracer.span(...)`",
                )
            )
        ctor = _metric_ctor_name(node)
        if ctor and id(node) in func_of:
            if any(kw.arg == "registry" for kw in node.keywords):
                continue  # scoped registry: the designed dynamic shape
            findings.append(
                Finding(
                    "OBS802", Severity.ERROR, path, node.lineno,
                    f"{ctor} constructed inside a function registers a "
                    "new metric in the global registry on every call; "
                    "construct metrics at module scope (or pass an "
                    "explicit registry= for a scoped one)",
                )
            )
    return findings


def _assigned_name(call: ast.Call, func) -> str:
    """The simple name the call's result is bound to in the enclosing
    function, or "" (looks for ``name = <call>``)."""
    if func is None:
        return ""
    for node in ast.walk(func):
        if (
            isinstance(node, ast.Assign)
            and node.value is call
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            return node.targets[0].id
    return ""


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    findings: List[Finding] = []
    sources: Dict[str, SourceFile] = {}
    for path in iter_py_files(paths):
        try:
            src, tree = parse_file(path)
        except (OSError, SyntaxError) as exc:
            findings.append(
                Finding("OBS800", Severity.ERROR, path, 0, f"unparsable: {exc}")
            )
            continue
        sources[path] = src
        findings.extend(_check_module(tree, path))
    return findings, sources
