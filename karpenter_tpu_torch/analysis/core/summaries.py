# Copied from karpenter_tpu/analysis/core/summaries.py.
"""Module loading and call-graph function summaries.

``load_modules`` parses a file set once into ``ModuleInfo`` handles
(source, tree, import aliases, function index) shared by every rule
family on the core — the same one-read-per-file discipline findings.py's
``SourceFile`` established.

``resolve_local`` resolves a bare callee name used in one module to a
function def anywhere in the scanned set — locally, or through a
``from .x import name`` alias — mirroring how PAR5xx resolves shared
constants across the kernel twins.

``CallGraph`` indexes every resolvable call edge over the scanned module
set up front — bare-name and from-import callees plus the conservative
``self._helper()`` method resolution the retry pass pioneered — and
collapses its strongly connected components (iterative Tarjan).
``SummaryTable`` rides it: ``get(key, compute)`` memoizes per-function
summaries like the old one-level ``ReturnSummaries``, but a client's
``compute`` thunk may now recurse through ``get`` for its own callees,
so flow facts propagate bottom-up through ANY number of helper hops.
Cycle safety is structural, not accidental: every member of a nontrivial
SCC (mutual or self recursion) is pinned to the lattice default before
computation starts, so recursive clusters read as unknown on every path
— deterministically, independent of which member is queried first. The
``_busy`` guard remains as a backstop for edges the graph cannot see
(dynamic dispatch, getattr), where it degrades to the old one-level
behavior instead of looping.

``ReturnSummaries`` (the one-level table) survives as a graph-free
``SummaryTable``: existing callers keep working, and a pass migrates by
building the graph and letting its compute thunks recurse.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

from ..astutil import FunctionIndex, dotted_name, import_aliases, iter_py_files, parse_file
from ..findings import SourceFile

# (module path, function name) — the summary/graph node key every
# core-hosted pass already uses
Key = Tuple[str, str]


@dataclass
class ModuleInfo:
    """One parsed module, shared by the core-hosted passes."""

    path: str
    src: SourceFile
    tree: ast.Module
    aliases: Dict[str, str] = field(default_factory=dict)
    index: FunctionIndex = None

    def __post_init__(self):
        if not self.aliases:
            self.aliases = import_aliases(self.tree)
        if self.index is None:
            self.index = FunctionIndex(self.tree)


def load_modules(
    paths: List[str],
) -> Tuple[Dict[str, ModuleInfo], Dict[str, SourceFile], List[Tuple[str, Exception]]]:
    """Parse a file set once: (modules by path, sources by path,
    [(path, error)] for unparsable files — each pass maps those onto its
    own x00 rule)."""
    modules: Dict[str, ModuleInfo] = {}
    sources: Dict[str, SourceFile] = {}
    errors: List[Tuple[str, Exception]] = []
    for path in iter_py_files(paths):
        try:
            src, tree = parse_file(path)
        except (OSError, SyntaxError) as exc:
            errors.append((path, exc))
            continue
        modules[path] = ModuleInfo(path=path, src=src, tree=tree)
        sources[path] = src
    return modules, sources, errors


def resolve_local(
    mod: ModuleInfo, name: str, modules: Dict[str, ModuleInfo]
) -> Optional[Tuple[ModuleInfo, ast.FunctionDef]]:
    """Resolve a bare name used in ``mod`` to a function def in the
    scanned set — locally, or through a ``from .x import name`` alias."""
    if name in mod.index.functions:
        return mod, mod.index.functions[name]
    origin = mod.aliases.get(name)
    if not origin or "." not in origin:
        return None
    mod_part, _, fn_name = origin.rpartition(".")
    base = mod_part.lstrip(".") or ""
    tail = base.rpartition(".")[2] if base else ""
    for other in modules.values():
        stem = os.path.splitext(os.path.basename(other.path))[0]
        if stem == tail and fn_name in other.index.functions:
            return other, other.index.functions[fn_name]
    return None


def _iter_defs(mod: ModuleInfo):
    """(name, FunctionDef) for every module-level function and every
    method, in source order — the call-graph node set. Method names key
    like function names (the convention the pass summary keys use); a
    collision joins their edges, which only widens cycles — safe."""
    for fname, fn in mod.index.functions.items():
        yield fname, fn
    for table in mod.index.methods.values():
        for fname, fn in table.items():
            yield fname, fn


def _callees(
    mod: ModuleInfo, fn: ast.FunctionDef, modules: Dict[str, ModuleInfo]
) -> List[Key]:
    """Resolvable callee keys of ``fn``: bare-name calls through
    ``resolve_local``, plus ``self._helper()`` against every method table
    in the module (conservative, matching the retry pass)."""
    out: List[Key] = []
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        raw = dotted_name(sub.func)
        if raw is not None and "." not in raw:
            hit = resolve_local(mod, raw, modules)
            if hit is not None:
                out.append((hit[0].path, hit[1].name))
        elif (
            isinstance(sub.func, ast.Attribute)
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id == "self"
        ):
            for table in mod.index.methods.values():
                if sub.func.attr in table:
                    out.append((mod.path, sub.func.attr))
                    break
    return out


class CallGraph:
    """Module-set call graph with SCC collapse.

    ``edges`` maps every function/method key to its resolvable callees;
    ``cycle_members`` is the union of all nontrivial SCCs (size > 1, or a
    self-edge) — the keys a ``SummaryTable`` pins to the lattice default
    so recursion can never observe a half-computed summary.
    """

    def __init__(self, modules: Dict[str, ModuleInfo]):
        self.edges: Dict[Key, Tuple[Key, ...]] = {}
        for path in sorted(modules):
            mod = modules[path]
            for fname, fn in _iter_defs(mod):
                key = (mod.path, fname)
                direct = _callees(mod, fn, modules)
                # a name collision (same key from two defs) joins edges
                self.edges.setdefault(key, ())
                self.edges[key] = tuple(
                    dict.fromkeys(self.edges[key] + tuple(direct))
                )
        self.cycle_members: FrozenSet[Key] = self._collapse()

    def _collapse(self) -> FrozenSet[Key]:
        """Iterative Tarjan; returns members of every nontrivial SCC."""
        index: Dict[Key, int] = {}
        low: Dict[Key, int] = {}
        on_stack: Dict[Key, bool] = {}
        stack: List[Key] = []
        counter = [0]
        cyclic: List[Key] = []

        for root in self.edges:
            if root in index:
                continue
            # explicit DFS stack: (node, iterator over callees)
            work = [(root, iter(self.edges.get(root, ())))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack[root] = True
            while work:
                node, it = work[-1]
                advanced = False
                for callee in it:
                    if callee not in self.edges:
                        continue  # resolved into a module outside the set
                    if callee not in index:
                        index[callee] = low[callee] = counter[0]
                        counter[0] += 1
                        stack.append(callee)
                        on_stack[callee] = True
                        work.append((callee, iter(self.edges.get(callee, ()))))
                        advanced = True
                        break
                    if on_stack.get(callee):
                        low[node] = min(low[node], index[callee])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc: List[Key] = []
                    while True:
                        member = stack.pop()
                        on_stack[member] = False
                        scc.append(member)
                        if member == node:
                            break
                    if len(scc) > 1 or node in self.edges.get(node, ()):
                        cyclic.extend(scc)
        return frozenset(cyclic)


def build_call_graph(modules: Dict[str, ModuleInfo]) -> CallGraph:
    """The scanned set's call graph — build once per pass run, share
    across every summary table that run creates."""
    return CallGraph(modules)


class SummaryTable:
    """Memoized function summaries over a call graph.

    Without a graph this is exactly the old one-level ``ReturnSummaries``
    (the ``_busy`` guard returns the default on any re-entry). With a
    graph, clients' compute thunks recurse through ``get`` for their
    callees and summaries propagate bottom-up arbitrarily deep; members
    of a nontrivial SCC are pinned to the default up front, so mutual
    recursion reads as unknown on every query order.
    """

    def __init__(self, default: int, graph: Optional[CallGraph] = None):
        self.default = default
        self.graph = graph
        self._memo: Dict[tuple, int] = {}
        self._busy: set = set()

    def get(self, key: tuple, compute: Callable[[], int]) -> int:
        if key in self._memo:
            return self._memo[key]
        if self.graph is not None and key in self.graph.cycle_members:
            # SCC collapse: recursive clusters are unknown/default by
            # construction, independent of traversal order
            self._memo[key] = self.default
            return self.default
        if key in self._busy:
            return self.default  # edge the graph missed: one level only
        self._busy.add(key)
        try:
            out = compute()
        finally:
            self._busy.discard(key)
        self._memo[key] = out
        return out


class ReturnSummaries(SummaryTable):
    """Backward-compatible one-level table (no graph)."""

    def __init__(self, default: int):
        super().__init__(default, graph=None)


__all__ = [
    "CallGraph",
    "ModuleInfo",
    "ReturnSummaries",
    "SummaryTable",
    "build_call_graph",
    "load_modules",
    "resolve_local",
]
