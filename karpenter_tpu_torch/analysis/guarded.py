# Copied from karpenter_tpu/analysis/guarded.py.
"""Pass: guarded-by inference over the threaded surface (GRD13xx).

The reference leans on Go's race detector; Python has no ``-race``, so
this pass infers the guarded-by relation statically and ratchets it. Per
class that constructs a ``threading.Lock``/``RLock``, it observes every
``self.`` attribute access through a held-lock symbolic walk (the
locks-pass walk, riding the same ``_File``/``_ClassInfo`` harvest):
accesses inside ``with self._lock`` bodies — including through helper
calls, interprocedurally — are *guarded by* that lock; everything else
is lock-free. ``__init__`` is construction time and exempt.

Thread roots are modeled explicitly over the PR-16 call graph:

- ``threading.Thread(target=...)`` targets (the provisioning ticker),
- callables handed to ``Operator._guarded`` (the controller roster —
  each entry is a reconcile loop the operator may thread),
- ``DispatchQueue.submit``/executor ``.submit`` edges (async dispatch),
- gRPC servicer handlers (``grpc.GenericRpcHandler`` subclasses — their
  handler methods run on the server's thread pool).

A lock-owning class's public methods are themselves thread-root
surfaces: the lock IS the class's declaration that entries race, so two
distinct entry methods count as two roots even when no explicit root
reaches them (this is also what lets the lock-deletion mutation pin in
tests/test_analysis.py fire on a standalone copied module).

Rules:
- GRD1300: unparsable file (guarded pass)
- GRD1301: attribute accessed both under its inferred guard and
  lock-free, reachable from ≥2 thread roots, with at least one write —
  the torn-read/lost-update shape
- GRD1302: guarded mutable state escaping by reference (``return
  self._attr`` without a copy wrapper) — the caller mutates or iterates
  it outside the lock
- GRD1303: ``__init__``-published callback that acquires a lock —
  re-entry from the publisher's (unknown) lock context is the ABBA
  window the store layer documents (the PR-1 callback-under-lock rule
  generalized beyond the store)
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .astutil import dotted_name
from .core.summaries import (
    CallGraph,
    ModuleInfo,
    SummaryTable,
    build_call_graph,
    load_modules,
)
from .findings import Finding, Severity, SourceFile
from .locks import _Analyzer, _ClassInfo, _File, _short

RULES = {
    "GRD1300": "unparsable file (guarded pass)",
    "GRD1301": "attribute accessed both under its inferred guard and "
               "lock-free from ≥2 thread roots",
    "GRD1302": "guarded mutable state escapes by reference (no copy)",
    "GRD1303": "__init__-published callback acquires a lock",
}

_MAX_DEPTH = 8

# container-mutating method names: `self._attr.append(x)` is a write
_MUTATORS = frozenset({
    "append", "add", "clear", "pop", "popitem", "update", "setdefault",
    "remove", "extend", "discard", "insert", "popleft", "appendleft",
    "extendleft", "rotate", "sort", "reverse",
})
# wrapping a guarded attr in one of these copies it out — not an escape
_COPY_WRAPPERS = frozenset({
    "list", "dict", "set", "tuple", "sorted", "frozenset", "deepcopy",
    "copy", "len", "sum", "min", "max", "str", "repr", "bool", "iter",
})
# __init__ RHS shapes that make an attribute mutable container state
_MUTABLE_CALLS = frozenset({
    "dict", "list", "set", "deque", "defaultdict", "OrderedDict",
    "Counter", "bytearray",
})
# callee-name fragments that publish a callable to another component
_PUBLISH_HINTS = (
    "watch", "subscribe", "register", "add_handler", "add_listener",
    "on_event", "callback", "observe", "listen", "attach", "hook",
)
# collection names that receiving `x.append(self.m)` counts as publishing
_PUBLISH_COLLECTIONS = (
    "watcher", "handler", "callback", "listener", "observer", "hook",
)

# one attribute access observed by the walk
# (attr, is_write, lock_ident-or-None, line, entry_method)
Access = Tuple[str, bool, Optional[str], int, str]


class _ClassAccess:
    """Accumulated per-class access observations."""

    def __init__(self) -> None:
        self.accesses: List[Access] = []

    def add(self, attr: str, write: bool, lock: Optional[str], line: int,
            entry: str) -> None:
        self.accesses.append((attr, write, lock, line, entry))


class _Walker:
    """Held-lock symbolic walk recording `self.` attribute accesses.

    Mirrors the locks-pass walk (same `with`/contextmanager handling,
    same self-call recursion with a depth/memo guard) but its product is
    the access log, not the acquisition graph."""

    def __init__(self, analyzer: _Analyzer) -> None:
        self.analyzer = analyzer
        self.acc: _ClassAccess = _ClassAccess()
        self._memo: Set[Tuple[str, int, FrozenSet[str]]] = set()

    def walk_entry(self, file: _File, cls: _ClassInfo,
                   fn: ast.FunctionDef) -> None:
        self._walk_fn(file, cls, fn, entry=fn.name, held=(), depth=0)

    def _walk_fn(self, file: _File, cls: _ClassInfo, fn: ast.FunctionDef,
                 entry: str, held: Tuple[str, ...], depth: int) -> None:
        key = (entry, id(fn), frozenset(held))
        if key in self._memo or depth > _MAX_DEPTH:
            return
        self._memo.add(key)
        self._walk_stmts(file, cls, fn.body, entry, held, depth)

    def _walk_stmts(self, file: _File, cls: _ClassInfo,
                    stmts: Sequence[ast.stmt], entry: str,
                    held: Tuple[str, ...], depth: int) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                new_held = held
                for item in stmt.items:
                    ctx = item.context_expr
                    info = self.analyzer.expr_lock(ctx, file, cls)
                    if info is not None:
                        new_held = new_held + (info.ident,)
                        continue
                    if isinstance(ctx, ast.Call):
                        target = self.analyzer._resolve_self_call(
                            ctx, file, cls
                        )
                        if target is not None:
                            t_cls, t_fn, receiver = target
                            for ident in sorted(
                                self.analyzer.cm_held_locks(
                                    t_cls.file, receiver or t_cls, t_fn
                                )
                            ):
                                new_held = new_held + (ident,)
                        self._scan_expr(file, cls, ctx, entry, held, depth)
                self._walk_stmts(file, cls, stmt.body, entry, new_held,
                                 depth)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs run in unknown lock context
            if isinstance(stmt, ast.Assign):
                for target in stmt.targets:
                    self._scan_store(file, cls, target, entry, held)
                self._scan_expr(file, cls, stmt.value, entry, held, depth)
                continue
            if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                attr = self._self_attr(stmt.target)
                if attr is not None:
                    # AugAssign reads AND writes the slot
                    if isinstance(stmt, ast.AugAssign):
                        self._record(cls, attr, False, held, stmt.lineno,
                                     entry)
                    self._record(cls, attr, True, held, stmt.lineno, entry)
                else:
                    self._scan_store(file, cls, stmt.target, entry, held)
                if stmt.value is not None:
                    self._scan_expr(file, cls, stmt.value, entry, held,
                                    depth)
                continue
            if hasattr(stmt, "body"):
                for expr in (getattr(stmt, "test", None),
                             getattr(stmt, "iter", None)):
                    if expr is not None:
                        self._scan_expr(file, cls, expr, entry, held, depth)
                for attr_name in ("body", "orelse", "finalbody"):
                    children = getattr(stmt, attr_name, None)
                    if children:
                        self._walk_stmts(file, cls, children, entry, held,
                                         depth)
                for handler in getattr(stmt, "handlers", []) or []:
                    self._walk_stmts(file, cls, handler.body, entry, held,
                                     depth)
                continue
            for expr in ast.iter_child_nodes(stmt):
                if isinstance(expr, ast.expr):
                    self._scan_expr(file, cls, expr, entry, held, depth)

    # -- expression scanning ------------------------------------------------

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        """attr name when node is a bare ``self.attr`` reference."""
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _store_attr(self, node: ast.AST) -> Optional[str]:
        """attr written by an assignment target: ``self.a``,
        ``self.a[k]``, or ``self.a.b`` (writing through a sub-object
        mutates the attr's referent)."""
        attr = self._self_attr(node)
        if attr is not None:
            return attr
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self._self_attr(node.value)
        return None

    def _scan_store(self, file: _File, cls: _ClassInfo, target: ast.AST,
                    entry: str, held: Tuple[str, ...]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._scan_store(file, cls, elt, entry, held)
            return
        attr = self._store_attr(target)
        if attr is not None:
            self._record(cls, attr, True, held, target.lineno, entry)
            return
        # non-self target: its index/value expressions are reads
        for sub in ast.iter_child_nodes(target):
            if isinstance(sub, ast.expr):
                self._scan_expr(file, cls, sub, entry, held, 0)

    def _scan_expr(self, file: _File, cls: _ClassInfo, node: ast.AST,
                   entry: str, held: Tuple[str, ...], depth: int) -> None:
        if isinstance(node, ast.Lambda):
            return  # runs later, in unknown lock context
        if isinstance(node, ast.Call):
            self._scan_call(file, cls, node, entry, held, depth)
            return
        attr = self._self_attr(node)
        if attr is not None:
            self._record(cls, attr, False, held, node.lineno, entry)
            return
        for sub in ast.iter_child_nodes(node):
            self._scan_expr(file, cls, sub, entry, held, depth)

    def _scan_call(self, file: _File, cls: _ClassInfo, node: ast.Call,
                   entry: str, held: Tuple[str, ...], depth: int) -> None:
        func = node.func
        handled_receiver = False
        if isinstance(func, ast.Attribute):
            recv_attr = self._self_attr(func.value)
            if recv_attr is not None:
                # self.attr.m(...): mutator call = write, else read
                self._record(cls, recv_attr, func.attr in _MUTATORS, held,
                             node.lineno, entry)
                handled_receiver = True
            elif self._self_attr(func) is not None:
                # self.helper(...): recurse if resolvable, else it's not
                # an attribute access at all
                target = self.analyzer._resolve_self_call(node, file, cls)
                if target is not None:
                    t_cls, t_fn, receiver = target
                    if (receiver or t_cls) is cls:
                        self._walk_fn(t_cls.file, cls, t_fn, entry, held,
                                      depth + 1)
                handled_receiver = True
        if not handled_receiver and isinstance(func, ast.expr):
            self._scan_expr(file, cls, func, entry, held, depth)
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            self._scan_expr(file, cls, arg, entry, held, depth)

    def _record(self, cls: _ClassInfo, attr: str, write: bool,
                held: Tuple[str, ...], line: int, entry: str) -> None:
        if attr in cls.locks or attr in ("lock", "_lock"):
            return  # the guards themselves are not guarded state
        lock = held[-1] if held else None
        self.acc.add(attr, write, lock, line, entry)


# -- thread roots -----------------------------------------------------------


def _thread_roots(modules: Dict[str, ModuleInfo]) -> Dict[Tuple[str, str], str]:
    """(module_path, fn_name) -> root kind, for every explicitly modeled
    thread root in the scanned set."""
    roots: Dict[Tuple[str, str], str] = {}

    def _mark(path: str, name: Optional[str], kind: str) -> None:
        if name:
            roots.setdefault((path, name.rpartition(".")[2]), kind)

    for path, mod in modules.items():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                bases = {dotted_name(b) or "" for b in node.bases}
                if any(
                    b.rpartition(".")[2] in ("GenericRpcHandler", "Servicer")
                    or b.endswith("Servicer")
                    for b in bases
                ):
                    for item in node.body:
                        if isinstance(item, ast.FunctionDef) and \
                                item.name != "__init__":
                            _mark(path, item.name, "grpc-handler")
                continue
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            tail = name.rpartition(".")[2]
            if tail == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        _mark(path, dotted_name(kw.value), "thread-target")
            elif tail == "_guarded" and name.startswith("self."):
                # Operator._guarded(name, fn): the roster's reconcile fns
                if len(node.args) >= 2:
                    _mark(path, dotted_name(node.args[1]),
                          "controller-loop")
            elif tail == "submit":
                # DispatchQueue.submit(label, fn) / executor.submit(fn)
                for arg in node.args:
                    target = dotted_name(arg)
                    if target:
                        _mark(path, target, "submit-edge")
                    elif isinstance(arg, ast.Lambda):
                        for sub in ast.walk(arg.body):
                            if isinstance(sub, ast.Call):
                                _mark(path, dotted_name(sub.func),
                                      "submit-edge")
            elif any(h in tail.lower() for h in _PUBLISH_HINTS):
                # watch(self._on_event) and friends: the callback runs on
                # the publisher's (informer/server) thread
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    target = dotted_name(arg)
                    if target and target.startswith("self."):
                        _mark(path, target, "watch-callback")
    return roots


def _root_reach(
    roots: Dict[Tuple[str, str], str], graph: CallGraph
) -> Dict[Tuple[str, str], Set[str]]:
    """key -> set of root kinds reaching it (forward BFS per root)."""
    reach: Dict[Tuple[str, str], Set[str]] = {}
    for root, kind in roots.items():
        if root not in graph.edges:
            reach.setdefault(root, set()).add(kind)
            continue
        seen = {root}
        frontier = [root]
        while frontier:
            node = frontier.pop()
            reach.setdefault(node, set()).add(kind)
            for callee in graph.edges.get(node, ()):
                if callee not in seen and callee in graph.edges:
                    seen.add(callee)
                    frontier.append(callee)
    return reach


# -- per-class rule checks --------------------------------------------------


def _mutable_attrs(cls: _ClassInfo) -> Set[str]:
    """Attributes ``__init__`` binds to a mutable container."""
    out: Set[str] = set()
    init = cls.methods.get("__init__")
    if init is None:
        return out
    for stmt in ast.walk(init):
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        target = stmt.targets[0]
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            continue
        value = stmt.value
        mutable = isinstance(
            value, (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp,
                    ast.SetComp)
        )
        if not mutable and isinstance(value, ast.Call):
            name = (dotted_name(value.func) or "").rpartition(".")[2]
            mutable = name in _MUTABLE_CALLS
        if mutable:
            out.add(target.attr)
    return out


def _is_entry(file: _File, mname: str,
              reach: Dict[Tuple[str, str], Set[str]]) -> bool:
    """Methods walked as their own thread entry: the public/dunder
    surface plus anything an explicit thread root reaches by name.
    Private helpers are analyzed only through recursion from entries —
    a `_stage_locked`-style helper is, by convention and by callers,
    always entered with the lock already held."""
    if mname == "__init__":
        return False  # construction happens-before publication
    if not mname.startswith("_"):
        return True
    if mname.startswith("__") and mname.endswith("__"):
        return True  # dunder: external protocol surface (len/iter/enter)
    return (file.path, mname) in reach


def _check_class(
    file: _File,
    cls: _ClassInfo,
    analyzer: _Analyzer,
    reach: Dict[Tuple[str, str], Set[str]],
    acquires: "_AcquireSummaries",
    findings: List[Finding],
) -> None:
    walker = _Walker(analyzer)
    for mname, method in cls.methods.items():
        if not _is_entry(file, mname, reach):
            continue
        walker.walk_entry(file, cls, method)
    accesses = walker.acc.accesses

    by_attr: Dict[str, List[Access]] = {}
    for rec in accesses:
        by_attr.setdefault(rec[0], []).append(rec)

    mutable = _mutable_attrs(cls)
    for attr in sorted(by_attr):
        recs = by_attr[attr]
        guarded = [r for r in recs if r[2] is not None]
        unguarded = [r for r in recs if r[2] is None]
        writes = [r for r in recs if r[1]]
        if not (guarded and unguarded and writes):
            continue
        entries = {r[4] for r in recs}
        kinds: Set[str] = set()
        for entry in entries:
            kinds |= reach.get((file.path, entry), set())
        if len(entries) < 2 and len(kinds) < 2:
            continue
        lock = max(
            (r[2] for r in guarded),
            key=lambda ident: sum(1 for r in guarded if r[2] == ident),
        )
        site = min(unguarded, key=lambda r: r[3])
        via = f" (thread roots: {', '.join(sorted(kinds))})" if kinds else ""
        findings.append(
            Finding(
                "GRD1301", Severity.ERROR, file.path, site[3],
                f"self.{attr} is guarded by {_short(lock)} in "
                f"{len(guarded)} site(s) but accessed lock-free in "
                f"{site[4]}(); entries {{{', '.join(sorted(entries))}}} "
                f"race on it{via} — hold the lock or sanction the "
                "single-threaded contract",
            )
        )

    # GRD1302: `return self._attr` of guarded mutable state, bare
    guarded_attrs = {r[0] for r in accesses if r[2] is not None}
    for mname, method in cls.methods.items():
        if mname == "__init__":
            continue
        for node in ast.walk(method):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not method:
                continue
            value = None
            if isinstance(node, ast.Return):
                value = node.value
            elif isinstance(node, (ast.Yield, ast.YieldFrom)):
                value = node.value
            if value is None:
                continue
            attr = None
            if (
                isinstance(value, ast.Attribute)
                and isinstance(value.value, ast.Name)
                and value.value.id == "self"
            ):
                attr = value.attr
            if attr is None or attr not in guarded_attrs or \
                    attr not in mutable:
                continue
            findings.append(
                Finding(
                    "GRD1302", Severity.ERROR, file.path, node.lineno,
                    f"guarded mutable self.{attr} escapes {mname}() by "
                    "reference — the caller iterates/mutates it outside "
                    f"the lock; return a copy (list/dict) instead",
                )
            )

    # GRD1303: __init__ publishes a bound method that acquires a lock
    init = cls.methods.get("__init__")
    if init is None:
        return
    for node in ast.walk(init):
        if not isinstance(node, ast.Call):
            continue
        callee = (dotted_name(node.func) or "").lower()
        published: List[Tuple[str, int]] = []
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if (
                isinstance(arg, ast.Attribute)
                and isinstance(arg.value, ast.Name)
                and arg.value.id == "self"
                and arg.attr in cls.methods
            ):
                published.append((arg.attr, node.lineno))
        if not published:
            continue
        tail = callee.rpartition(".")[2]
        is_publish = any(h in tail for h in _PUBLISH_HINTS) or (
            tail == "append"
            and any(h in callee for h in _PUBLISH_COLLECTIONS)
        )
        if not is_publish:
            continue
        for mname, line in published:
            if acquires.method_acquires(file, cls, mname):
                findings.append(
                    Finding(
                        "GRD1303", Severity.ERROR, file.path, line,
                        f"__init__ publishes self.{mname} as a callback "
                        "and it acquires a lock — re-entry from the "
                        "publisher's lock context is an ABBA window; "
                        "publish after construction or drop the lock "
                        "from the callback",
                    )
                )


class _AcquireSummaries:
    """Bottom-up 'does this function acquire any lock?' summaries over
    the call graph (SummaryTable recursion — SCCs read as 0/unknown)."""

    def __init__(self, modules: Dict[str, ModuleInfo], graph: CallGraph):
        self.modules = modules
        self.graph = graph
        self.table = SummaryTable(default=0, graph=graph)

    def _direct(self, fn: ast.FunctionDef) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    name = dotted_name(item.context_expr) or ""
                    if name.rpartition(".")[2] in ("lock", "_lock",
                                                   "rlock", "_rlock"):
                        return True
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr == "acquire":
                return True
        return False

    def key_acquires(self, key: Tuple[str, str]) -> bool:
        def compute() -> int:
            mod = self.modules.get(key[0])
            fn = None
            if mod is not None:
                fn = mod.index.functions.get(key[1])
                if fn is None:
                    for table in mod.index.methods.values():
                        if key[1] in table:
                            fn = table[key[1]]
                            break
            if fn is None:
                return 0
            if self._direct(fn):
                return 1
            for callee in self.graph.edges.get(key, ()):
                if callee != key and self.key_acquires(callee):
                    return 1
            return 0

        return bool(self.table.get(key, compute))

    def method_acquires(self, file: _File, cls: _ClassInfo,
                        mname: str) -> bool:
        return self.key_acquires((file.path, mname))


# -- entry ------------------------------------------------------------------


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Run the guarded-by pass; returns (findings, sources)."""
    findings: List[Finding] = []
    modules, sources, errors = load_modules(paths)
    for path, exc in errors:
        findings.append(
            Finding("GRD1300", Severity.ERROR, path, 0, f"unparsable: {exc}")
        )
    files = [_File(m.path, m.src, m.tree) for m in modules.values()]
    analyzer = _Analyzer(files)
    graph = build_call_graph(modules)
    reach = _root_reach(_thread_roots(modules), graph)
    acquires = _AcquireSummaries(modules, graph)
    for f in files:
        for cls in f.classes.values():
            if not any(c.locks for c in analyzer.mro(cls)):
                continue
            _check_class(f, cls, analyzer, reach, acquires, findings)
    # one finding per (rule, site)
    unique: Dict[Tuple[str, str, int], Finding] = {}
    for finding in findings:
        unique.setdefault((finding.rule, finding.path, finding.line), finding)
    return list(unique.values()), sources
