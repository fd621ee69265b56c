# Copied from karpenter_tpu/analysis/locks.py.
"""Pass 2: lock-order and callback-under-lock analysis.

The store/state layer is a two-lock system with a documented ordering:
informer handlers run under the Cluster lock and call back into Client
reads (cluster -> store), so the store must NEVER invoke watcher callbacks
while its own lock is held (store -> cluster would close the ABBA cycle —
see kube/filestore.py::_atomic's docstring, and tests/test_races.py for
the dynamic pin). This pass extracts the static acquisition graph and
checks that ordering for every method in the configured file set.

Mechanics (AST only, no imports):
- lock identities are ``file::Class.attr`` for instance locks created in
  ``__init__`` (resolved through single-inheritance bases, so
  ``FileClient._lock`` IS ``Client._lock``) and ``file::name`` for module
  globals;
- attribute types come from ``__init__`` parameter annotations and direct
  constructions (``self._client = client  # client: Client``), so calls
  like ``self._client.list(...)`` resolve cross-class;
- a symbolic walk of each method tracks the held-lock set through ``with``
  blocks, ``.acquire()``/``.release()`` pairs, and ``@contextmanager``
  helpers (locks held at ``yield`` count as held in the caller's body),
  recursing through same-set method calls with dynamic dispatch from the
  entry class.

Since PR 19 the pass loads its file set through the call-graph core
(``core.summaries.load_modules`` — one parse per file, shared with the
GRD/ATM passes) and runs tree-wide, not just over the store layer.
``build_analyzer`` exposes the walked acquisition graph to the atomicity
pass: LCK201 claims cycles whose locks live in ONE module; cycles
spanning modules are ATM1402's (atomicity.py), so the two rules
partition the cycle space.

Rules:
- LCK201: cycle in the acquisition-order graph (ABBA deadlock)
- LCK202: watcher/callback invoked while a lock is held
- LCK203: non-reentrant Lock re-acquired while already held
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .astutil import dotted_name, import_aliases
from .core.summaries import load_modules
from .findings import Finding, Severity, SourceFile

RULES = {
    "LCK200": "unparsable file (locks pass)",
    "LCK201": "cycle in the lock acquisition-order graph (ABBA deadlock)",
    "LCK202": "watcher/callback invoked while a lock is held",
    "LCK203": "non-reentrant Lock re-acquired while already held",
}

_CALLBACK_COLLECTION_HINTS = ("watcher", "handler", "callback", "listener")
_CALLBACK_PARAM_NAMES = {"fn", "func", "callback", "handler", "cb"}
_MAX_DEPTH = 8


class _LockInfo:
    def __init__(self, ident: str, reentrant: bool):
        self.ident = ident
        self.reentrant = reentrant


class _ClassInfo:
    def __init__(self, file: "_File", node: ast.ClassDef):
        self.file = file
        self.node = node
        self.name = node.name
        self.bases = [dotted_name(b) or "" for b in node.bases]
        self.methods: Dict[str, ast.FunctionDef] = {
            item.name: item
            for item in node.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # attr -> bare type name (classes) — from __init__
        self.attr_types: Dict[str, str] = {}
        # attr -> _LockInfo — locks constructed in __init__/class body
        self.locks: Dict[str, _LockInfo] = {}
        self._harvest()

    def _harvest(self) -> None:
        init = self.methods.get("__init__")
        body = list(init.body) if init else []
        body += [n for n in self.node.body if isinstance(n, ast.Assign)]
        for stmt in ast.walk(ast.Module(body=body, type_ignores=[])):
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            target = stmt.targets[0]
            attr = None
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                attr = target.attr
            if attr is None:
                continue
            lock_kind = _lock_constructor(stmt.value)
            if lock_kind is not None:
                ident = f"{self.file.path}::{self.name}.{attr}"
                self.locks[attr] = _LockInfo(ident, reentrant=lock_kind == "RLock")
                continue
            type_name = _constructed_type(stmt.value)
            if type_name is None and init is not None:
                type_name = _param_annotation(init, stmt.value)
            if type_name:
                self.attr_types[attr] = type_name


def _lock_constructor(value: ast.AST) -> Optional[str]:
    """'Lock'/'RLock' when the expression constructs a threading lock."""
    for node in ast.walk(value):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            tail = name.rpartition(".")[2]
            if tail in ("Lock", "RLock"):
                return tail
    return None


def _constructed_type(value: ast.AST) -> Optional[str]:
    """Bare class name when the RHS (or an `or` arm) constructs a class."""
    for node in ast.walk(value):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name and name[0].isupper():
                return name.rpartition(".")[2]
    return None


def _param_annotation(init: ast.FunctionDef, value: ast.AST) -> Optional[str]:
    """Type of ``self.x = param`` from the __init__ signature annotation."""
    names = {n.id for n in ast.walk(value) if isinstance(n, ast.Name)}
    for arg in init.args.args + init.args.kwonlyargs:
        if arg.arg in names and arg.annotation is not None:
            ann = arg.annotation
            # Optional[X] / "X" strings
            if isinstance(ann, ast.Subscript):
                base = dotted_name(ann.value) or ""
                if base.rpartition(".")[2] == "Optional":
                    ann = ann.slice
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                return ann.value.rpartition(".")[2]
            name = dotted_name(ann)
            if name and name[0].isupper():
                return name.rpartition(".")[2]
    return None


class _File:
    def __init__(self, path: str, src: SourceFile, tree: ast.Module):
        self.path = path
        self.src = src
        self.tree = tree
        self.aliases = import_aliases(tree)
        self.classes: Dict[str, _ClassInfo] = {}
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.module_locks: Dict[str, _LockInfo] = {}
        self.global_types: Dict[str, str] = {}
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = _ClassInfo(self, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if isinstance(target, ast.Name):
                    kind = _lock_constructor(node.value)
                    if kind is not None:
                        self.module_locks[target.id] = _LockInfo(
                            f"{self.path}::{target.id}", reentrant=kind == "RLock"
                        )
                    else:
                        tname = _constructed_type(node.value)
                        if tname:
                            self.global_types[target.id] = tname


class _Analyzer:
    def __init__(self, files: List[_File]):
        self.files = files
        self.findings: List[Finding] = []
        # bare class name -> _ClassInfo (unique across the small file set)
        self.class_table: Dict[str, _ClassInfo] = {}
        ambiguous: Set[str] = set()
        for f in files:
            for name, info in f.classes.items():
                if name in self.class_table:
                    ambiguous.add(name)
                self.class_table[name] = info
        for name in ambiguous:
            self.class_table.pop(name, None)
        # acquisition edges: (from_ident, to_ident) -> (path, line)
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._memo: Set[Tuple[int, str, FrozenSet[str]]] = set()
        self._cm_memo: Dict[int, Set[str]] = {}

    # -- type / lock resolution ------------------------------------------

    def resolve_base(self, cls: _ClassInfo) -> Optional[_ClassInfo]:
        for base in cls.bases:
            info = self.class_table.get(base.rpartition(".")[2])
            if info is not None:
                return info
        return None

    def mro(self, cls: _ClassInfo) -> List[_ClassInfo]:
        out, seen = [], set()
        cur: Optional[_ClassInfo] = cls
        while cur is not None and id(cur) not in seen:
            seen.add(id(cur))
            out.append(cur)
            cur = self.resolve_base(cur)
        return out

    def lock_of(self, cls: Optional[_ClassInfo], attr: str) -> Optional[_LockInfo]:
        for c in self.mro(cls) if cls else []:
            if attr in c.locks:
                return c.locks[attr]
        return None

    def attr_type(self, cls: Optional[_ClassInfo], attr: str) -> Optional[_ClassInfo]:
        for c in self.mro(cls) if cls else []:
            if attr in c.attr_types:
                return self.class_table.get(c.attr_types[attr])
        return None

    def find_method(
        self, cls: Optional[_ClassInfo], name: str
    ) -> Optional[Tuple[_ClassInfo, ast.FunctionDef]]:
        for c in self.mro(cls) if cls else []:
            if name in c.methods:
                return c, c.methods[name]
        return None

    def expr_lock(
        self, node: ast.AST, file: _File, cls: Optional[_ClassInfo]
    ) -> Optional[_LockInfo]:
        """Lock identity of a `with`/.acquire() context expression."""
        name = dotted_name(node)
        if name is None:
            return None
        parts = name.split(".")
        if len(parts) == 1:
            return file.module_locks.get(parts[0])
        if parts[0] == "self" and cls is not None:
            owner: Optional[_ClassInfo] = cls
            for attr in parts[1:-1]:
                owner = self.attr_type(owner, attr)
                if owner is None:
                    return None
            info = self.lock_of(owner, parts[-1])
            if info is not None:
                return info
            # unresolved but lock-named attribute on a known class: give it
            # an identity so fixtures without __init__ bodies still work
            if parts[-1] in ("lock", "_lock") and owner is not None:
                return owner.locks.setdefault(
                    parts[-1],
                    _LockInfo(
                        f"{owner.file.path}::{owner.name}.{parts[-1]}",
                        reentrant=False,
                    ),
                )
        return None

    def cm_held_locks(self, file: _File, cls: _ClassInfo, fn: ast.FunctionDef) -> Set[str]:
        """Lock identities held at any yield of a @contextmanager method."""
        if id(fn) in self._cm_memo:
            return self._cm_memo[id(fn)]
        self._cm_memo[id(fn)] = set()  # cycle guard
        held_at_yield: Set[str] = set()

        def walk(stmts: Sequence[ast.stmt], held: Tuple[_LockInfo, ...]) -> None:
            for stmt in stmts:
                if isinstance(stmt, ast.With):
                    locks = []
                    for item in stmt.items:
                        info = self.expr_lock(item.context_expr, file, cls)
                        if info is not None:
                            locks.append(info)
                    walk(stmt.body, held + tuple(locks))
                    continue
                for sub in ast.walk(stmt):
                    if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                        held_at_yield.update(l.ident for l in held)
                for attr in ("body", "orelse", "finalbody", "handlers"):
                    children = getattr(stmt, attr, None)
                    if children and not isinstance(stmt, ast.With):
                        inner = []
                        for c in children:
                            if isinstance(c, ast.ExceptHandler):
                                inner.extend(c.body)
                            elif isinstance(c, ast.stmt):
                                inner.append(c)
                        if inner:
                            walk(inner, held)

        # top-level statement walk only (nested defs don't yield for us)
        for stmt in fn.body:
            if isinstance(stmt, ast.With):
                locks = [
                    info
                    for item in stmt.items
                    if (info := self.expr_lock(item.context_expr, file, cls))
                ]
                walk(stmt.body, tuple(locks))
            else:
                walk([stmt], ())
        self._cm_memo[id(fn)] = held_at_yield
        return held_at_yield

    def _lock_by_ident(self, ident: str) -> _LockInfo:
        return _LockInfo(ident, reentrant=True)

    # -- the symbolic walk -------------------------------------------------

    def analyze_method(
        self,
        file: _File,
        dyn_cls: Optional[_ClassInfo],
        fn: ast.FunctionDef,
        held: Tuple[_LockInfo, ...],
        depth: int = 0,
        entry: str = "",
    ) -> None:
        key = (id(fn), entry, frozenset(l.ident for l in held))
        if key in self._memo or depth > _MAX_DEPTH:
            return
        self._memo.add(key)
        callable_locals = self._callable_locals(fn)
        self._walk(file, dyn_cls, fn, list(fn.body), held, depth, entry,
                   callable_locals)

    def _callable_locals(self, fn: ast.FunctionDef) -> Set[str]:
        """Local names that hold externally-supplied callables: bound by
        iterating a watcher/handler/callback collection, loaded from a
        container of them, or passed as a Callable-annotated/named param."""
        out: Set[str] = set()
        for arg in fn.args.args + fn.args.kwonlyargs:
            ann = ""
            if arg.annotation is not None:
                ann = ast.dump(arg.annotation)
            if "Callable" in ann or arg.arg in _CALLBACK_PARAM_NAMES:
                out.add(arg.arg)
        for node in ast.walk(fn):
            source = None
            if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
                source = node.iter
                target = node.target.id
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                source = node.value
                target = node.targets[0].id
            else:
                continue
            for sub in ast.walk(source):
                name = dotted_name(sub) if isinstance(sub, (ast.Attribute, ast.Name)) else None
                if name and any(h in name.lower() for h in _CALLBACK_COLLECTION_HINTS):
                    out.add(target)
                    break
        return out

    def _acquire(
        self,
        lock: _LockInfo,
        held: Tuple[_LockInfo, ...],
        file: _File,
        line: int,
        entry: str,
    ) -> Tuple[_LockInfo, ...]:
        for h in held:
            if h.ident == lock.ident:
                if not lock.reentrant:
                    self.findings.append(
                        Finding(
                            "LCK203", Severity.ERROR, file.path, line,
                            f"non-reentrant lock {_short(lock.ident)} "
                            f"re-acquired while already held"
                            + (f" (via {entry})" if entry else ""),
                        )
                    )
                return held  # reentrant: no new edge
        for h in held:
            self.edges.setdefault((h.ident, lock.ident), (file.path, line))
        return held + (lock,)

    def _walk(
        self,
        file: _File,
        dyn_cls: Optional[_ClassInfo],
        fn: ast.FunctionDef,
        stmts: Sequence[ast.stmt],
        held: Tuple[_LockInfo, ...],
        depth: int,
        entry: str,
        callable_locals: Set[str],
    ) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                new_held = held
                for item in stmt.items:
                    ctx = item.context_expr
                    info = self.expr_lock(ctx, file, dyn_cls)
                    if info is not None:
                        new_held = self._acquire(
                            info, new_held, file, ctx.lineno, entry
                        )
                        continue
                    # `with self._atomic():` — contextmanager helper
                    if isinstance(ctx, ast.Call):
                        target = self._resolve_self_call(ctx, file, dyn_cls)
                        if target is not None:
                            t_cls, t_fn, receiver = target
                            for ident in sorted(
                                self.cm_held_locks(
                                    t_cls.file, receiver or t_cls, t_fn
                                )
                            ):
                                info = _LockInfo(ident, reentrant=True)
                                new_held = self._acquire(
                                    info, new_held, file, ctx.lineno, entry
                                )
                self._walk(file, dyn_cls, fn, stmt.body, new_held, depth,
                           entry, callable_locals)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs analyzed only if invoked (skip)
            if hasattr(stmt, "body"):
                # compound statement: scan its header expressions, then
                # recurse into each body exactly once with the same held set
                for expr in (
                    getattr(stmt, "test", None), getattr(stmt, "iter", None)
                ):
                    if expr is not None:
                        self._scan_calls(expr, file, dyn_cls, held, depth,
                                         entry, callable_locals)
                for attr in ("body", "orelse", "finalbody"):
                    children = getattr(stmt, attr, None)
                    if children:
                        self._walk(file, dyn_cls, fn, children, held, depth,
                                   entry, callable_locals)
                for handler in getattr(stmt, "handlers", []) or []:
                    self._walk(file, dyn_cls, fn, handler.body, held, depth,
                               entry, callable_locals)
                continue
            self._scan_calls(stmt, file, dyn_cls, held, depth, entry,
                             callable_locals)

    def _scan_calls(
        self,
        node: ast.AST,
        file: _File,
        dyn_cls: Optional[_ClassInfo],
        held: Tuple[_LockInfo, ...],
        depth: int,
        entry: str,
        callable_locals: Set[str],
    ) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._handle_call(
                    sub, file, dyn_cls, held, depth, entry, callable_locals
                )

    def _resolve_self_call(
        self, call: ast.Call, file: _File, dyn_cls: Optional[_ClassInfo]
    ) -> Optional[Tuple[_ClassInfo, ast.FunctionDef, Optional[_ClassInfo]]]:
        """(defining_class, method, dynamic_receiver_class) for a resolvable
        call. The receiver class stays ``dyn_cls`` only for ``self.m()`` and
        ``super().m()``; ``self.attr.m()`` dispatches on the attr's type."""
        name = dotted_name(call.func)
        if name is None:
            # super().m(...)
            func = call.func
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Call)
                and dotted_name(func.value.func) == "super"
                and dyn_cls is not None
            ):
                base = self.resolve_base(
                    self.class_table.get(dyn_cls.name) or dyn_cls
                )
                hit = self.find_method(base, func.attr)
                if hit is not None:
                    return hit[0], hit[1], dyn_cls
            return None
        parts = name.split(".")
        if parts[0] == "self" and dyn_cls is not None:
            owner: Optional[_ClassInfo] = dyn_cls
            for attr in parts[1:-1]:
                owner = self.attr_type(owner, attr)
                if owner is None:
                    return None
            hit = self.find_method(owner, parts[-1])
            if hit is not None:
                receiver = dyn_cls if len(parts) == 2 else owner
                return hit[0], hit[1], receiver
            return None
        if len(parts) == 2:
            # module-global instance (e.g. a metrics Gauge)
            owner = self.class_table.get(file.global_types.get(parts[0], ""))
            if owner is not None:
                hit = self.find_method(owner, parts[1])
                if hit is not None:
                    return hit[0], hit[1], owner
        return None

    def _handle_call(
        self,
        node: ast.Call,
        file: _File,
        dyn_cls: Optional[_ClassInfo],
        held: Tuple[_LockInfo, ...],
        depth: int,
        entry: str,
        callable_locals: Set[str],
    ) -> None:
        name = dotted_name(node.func)
        # .acquire() outside a with — record as an edge source point
        if isinstance(node.func, ast.Attribute) and node.func.attr == "acquire":
            info = self.expr_lock(node.func.value, file, dyn_cls)
            if info is not None:
                self._acquire(info, held, file, node.lineno, entry)
            return
        if held and name and len(name.split(".")) == 1:
            # a bare call of a callback-shaped name: tracked callable
            # locals, or names that announce themselves (handler/fn/cb/...)
            if name in callable_locals or name in _CALLBACK_PARAM_NAMES:
                locks = ", ".join(sorted(_short(l.ident) for l in held))
                self.findings.append(
                    Finding(
                        "LCK202", Severity.ERROR, file.path, node.lineno,
                        f"callback '{name}(...)' invoked while holding "
                        f"{locks}"
                        + (f" (entered via {entry})" if entry else "")
                        + "; release the lock before notifying",
                    )
                )
                return
        target = self._resolve_self_call(node, file, dyn_cls)
        if target is not None:
            t_cls, t_fn, receiver = target
            next_entry = entry or f"{(dyn_cls or t_cls).name}"
            self.analyze_method(
                t_cls.file, receiver, t_fn, held, depth + 1,
                entry=f"{next_entry} -> {t_cls.name}.{t_fn.name}"
                if held else "",
            )

    # -- cycle detection ---------------------------------------------------

    def detect_cycles(
        self, rule: str = "LCK201", cross_module_only: bool = False
    ) -> None:
        """Report acquisition-order cycles.

        The default (LCK201) reports cycles whose locks all live in one
        module — the store-layer ABBA class this pass was built for. With
        ``cross_module_only`` the SAME graph yields the complementary set
        (cycles spanning ≥2 modules) under the caller's rule id: the
        atomicity pass (ATM1402) runs the tree-wide walk and claims those,
        so the two rules partition the cycle space instead of
        double-reporting one deadlock."""
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
        seen: Set[FrozenSet[str]] = set()

        def dfs(start: str, node: str, path: List[str]) -> None:
            for nxt in sorted(graph.get(node, ())):
                if nxt == start and len(path) > 1:
                    key = frozenset(path)
                    if key in seen:
                        continue
                    seen.add(key)
                    cycle = path + [start]
                    modules = {p.partition("::")[0] for p in path}
                    if cross_module_only != (len(modules) > 1):
                        continue
                    site = self.edges.get((path[-1], start)) or \
                        self.edges.get((path[0], path[1]), ("", 0))
                    if cross_module_only:
                        msg = (
                            "interprocedural lock-order cycle across "
                            "modules: "
                            + " -> ".join(_short(p) for p in cycle)
                            + " (ABBA deadlock potential; keep one global "
                            "acquisition order across layers)"
                        )
                    else:
                        msg = (
                            "lock-order cycle: "
                            + " -> ".join(_short(p) for p in cycle)
                            + " (ABBA deadlock; keep a single global "
                            "acquisition order)"
                        )
                    self.findings.append(
                        Finding(rule, Severity.ERROR, site[0], site[1], msg)
                    )
                elif nxt not in path:
                    dfs(start, nxt, path + [nxt])

        for node in sorted(graph):
            dfs(node, node, [node])


def _short(ident: str) -> str:
    path, _, name = ident.partition("::")
    import os

    return f"{os.path.basename(path)}::{name}"


def build_analyzer(modules) -> "_Analyzer":
    """A fully-walked acquisition analyzer over core-loaded modules.

    Shared entry for this pass and the atomicity pass (ATM1402): both
    need the same held-set symbolic walk and the same acquisition-edge
    graph; they differ only in which cycle population they claim. The
    walk also emits LCK202/LCK203 findings into ``analyzer.findings`` —
    callers keep or drop those by rule."""
    files = [_File(m.path, m.src, m.tree) for m in modules.values()]
    analyzer = _Analyzer(files)
    for f in files:
        for cls in f.classes.values():
            for mname, method in cls.methods.items():
                analyzer.analyze_method(f, cls, method, held=())
        for fn in f.functions.values():
            analyzer.analyze_method(f, None, fn, held=())
    return analyzer


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Run the lock-order pass over the given files/directories."""
    modules, sources, errors = load_modules(paths)
    parse_findings = [
        Finding("LCK200", Severity.ERROR, path, 0, f"unparsable: {exc}")
        for path, exc in errors
    ]
    analyzer = build_analyzer(modules)
    analyzer.findings = parse_findings + analyzer.findings
    analyzer.detect_cycles()
    # one finding per (rule, site): entry paths multiply otherwise
    unique: Dict[Tuple[str, str, int], Finding] = {}
    for finding in analyzer.findings:
        unique.setdefault((finding.rule, finding.path, finding.line), finding)
    return list(unique.values()), sources
