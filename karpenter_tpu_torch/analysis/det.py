# Copied from karpenter_tpu/analysis/det.py.
"""Pass 11: order discipline (DET11xx) for the determinism surface.

PR 14's PYTHONHASHSEED cost drift was this bug class exactly:
``Vocab.observe`` iterated ``Requirement.values`` (a ``set``) in hash
order, so two processes interned the same zone names at different value
ids and every argmin tie-break over those ids diverged — caught only by
a full parity round, fixed by ``sorted(r.values)`` and pinned by a
six-seed two-process dynamic test. The dynamic pin can only sample; this
pass closes the class statically over the determinism surface
(``solver/``, ``ops/``, ``sim/``, ``obs/``).

A dataflow pass on the shared core: values born from **unordered
sources** are tracked through assignments, set algebra, and helper
returns (bottom-up over the module-set call graph, core.summaries), and
flagged when one reaches an **order-sensitive sink** without passing
through ``sorted()``/explicit canonicalization first. Everything the
analysis loses track of joins to UNKNOWN and never flags (the same
poison-to-unknown discipline as DTX9xx).

Unordered sources:

- ``set`` literals and set comprehensions, ``set()``/``frozenset()``
  calls, set-algebra results (``|``/``&``/``-``/``^``, ``.union()``...);
- attribute loads declared set-typed by an annotation the pass can see —
  class-body or ``self.x: Set[...]`` declarations across the scanned set
  PLUS the ``karpenter_tpu/api`` value-object modules (so
  ``r.values`` resolves through ``Requirement.values: Set[str]`` even
  when ``api/`` is outside the scan scope), with receivers typed from
  parameter annotations, constructor calls, and ``__iter__ ->
  Iterator[T]`` element chaining;
- ``os.environ`` (per-process environment order);
- ``dict(unordered)`` — the dict itself is insertion-stable (a language
  guarantee since 3.7, which is why plain dict views are NOT sources)
  but its insertion order inherits the set's hash order, so views and
  iteration over it stay tainted.

Order-sensitive sinks (flag only on *definite* UNORDERED):

- DET1101: ``for``-iteration — the iteration order escapes into
  whatever the body appends/interns/emits (the Vocab.observe shape);
- DET1102: order-fixing materialization — ``list()``/``tuple()``/
  ``enumerate()`` or a list comprehension over an unordered iterable;
- DET1103: ``.join()`` over an unordered iterable — a canonical-record
  string whose bytes depend on hash order;
- DET1104: an unseeded global-RNG draw (``random.*`` module functions,
  ``np.random.*`` legacy functions) — the decision surface must thread
  seeded ``np.random.default_rng(seed)``/``random.Random(seed)``
  instances so twin replays are byte-identical.

Order-insensitive consumption stays silent by construction:
membership tests (``x in s``), ``len``/``sum``/``min``/``max``/
``any``/``all`` reductions, and ``sorted()`` — the canonicalizer —
yields an ORDERED value. Deliberate unordered uses that the lattice
cannot prove commutative carry ``# analysis: sanctioned[DET...]``
boundary annotations (counted separately, stale-audited), mirroring the
CLK1001/DTX906 dialects.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .astutil import call_name, dotted_name
from .core.cfg import Atom, build_cfg
from .core.dataflow import Env, run_forward, sweep
from .core.lattice import Lattice
from .core.summaries import (
    ModuleInfo,
    SummaryTable,
    build_call_graph,
    load_modules,
    resolve_local,
)
from .findings import Finding, Severity, SourceFile

RULES = {
    "DET1100": "unparsable file (order-discipline pass)",
    "DET1101": "iteration over an unordered value (hash-order escape)",
    "DET1102": "order-fixing materialization of an unordered value",
    "DET1103": "join over an unordered value (hash-ordered record)",
    "DET1104": "unseeded global RNG on the determinism surface",
}

ORDERED = 0
UNORDERED = 1
UNKNOWN = 2  # poison: lost track -> never flag

LATTICE = Lattice(top=UNKNOWN, default=ORDERED)

# annotation heads that declare a set-typed attribute
_SET_ANNOTATIONS = {"set", "frozenset", "Set", "FrozenSet", "AbstractSet",
                    "MutableSet"}
# set methods that return another unordered set
_SET_PRODUCERS = {"union", "intersection", "difference",
                  "symmetric_difference", "copy"}
# dict views: ordered on an insertion-stable dict, tainted on a dict
# built from an unordered source (the receiver kind decides)
_DICT_VIEWS = {"keys", "values", "items"}
# commutative reductions: consuming a set through these is the sanctioned
# "counter" use and yields an order-free scalar
_REDUCERS = {"len", "sum", "min", "max", "any", "all", "bool", "sorted",
             "str", "repr", "int", "float", "abs"}
# order-fixing materializers (the DET1102 sinks)
_MATERIALIZERS = {"list", "tuple", "enumerate"}

# unseeded global-RNG draws. random.Random / np.random.default_rng /
# Generator / SeedSequence construct seeded instances and stay silent —
# instance method calls never canonicalize to these module paths.
_GLOBAL_RNG = {
    "random.random", "random.randint", "random.randrange", "random.choice",
    "random.choices", "random.shuffle", "random.sample", "random.uniform",
    "random.gauss", "random.seed", "random.getrandbits", "random.betavariate",
}
_NP_RNG_OK = {"default_rng", "Generator", "SeedSequence", "RandomState",
              "BitGenerator", "PCG64", "Philox"}


def _annotation_is_set(ann: ast.AST) -> Optional[bool]:
    """True/False when the annotation decides set-ness, None when it is
    unreadable (string forward refs to non-set types, unions...)."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        head = ann.value.split("[", 1)[0].rpartition(".")[2]
        return head in _SET_ANNOTATIONS or None
    if isinstance(ann, ast.Subscript):
        head = dotted_name(ann.value)
        if head is not None:
            tail = head.rpartition(".")[2]
            if tail == "Optional":
                return _annotation_is_set(ann.slice)
            return tail in _SET_ANNOTATIONS
        return None
    head = dotted_name(ann)
    if head is None:
        return None
    return head.rpartition(".")[2] in _SET_ANNOTATIONS


def _class_name_of(ann: ast.AST) -> Optional[str]:
    """Bare class name an annotation refers to ('Requirements' from
    ``Requirements`` / ``"Requirements"`` / ``mod.Requirements``)."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split("[", 1)[0].rpartition(".")[2] or None
    name = dotted_name(ann)
    if name is None:
        return None
    return name.rpartition(".")[2]


class ClassTable:
    """Set-typed attribute declarations and iteration element types,
    collected from class defs across the scanned set plus the api/
    support modules. Name-keyed by bare class name; a redefinition
    merges conservatively (conflicting set-ness reads as unknown)."""

    def __init__(self):
        # class -> attr -> True (set) / False (not a set) / None (conflict)
        self.attrs: Dict[str, Dict[str, Optional[bool]]] = {}
        # class -> element class name from `__iter__ -> Iterator[T]`
        self.elem: Dict[str, str] = {}

    def add_module(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self._add_class(node)

    def _add_class(self, cls: ast.ClassDef) -> None:
        table = self.attrs.setdefault(cls.name, {})

        def record(attr: str, is_set: Optional[bool]) -> None:
            if is_set is None:
                return
            if attr in table:
                if table[attr] is not None and table[attr] != is_set:
                    table[attr] = None  # conflicting declarations: unknown
            else:
                table[attr] = is_set

        for item in cls.body:
            if isinstance(item, ast.AnnAssign) and isinstance(
                item.target, ast.Name
            ):
                record(item.target.id, _annotation_is_set(item.annotation))
        for item in ast.walk(cls):
            if isinstance(item, ast.AnnAssign) and isinstance(
                item.target, ast.Attribute
            ):
                if (
                    isinstance(item.target.value, ast.Name)
                    and item.target.value.id == "self"
                ):
                    record(item.target.attr,
                           _annotation_is_set(item.annotation))
            elif isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if item.name == "__iter__" and item.returns is not None:
                    ret = item.returns
                    if isinstance(ret, ast.Subscript):
                        head = dotted_name(ret.value) or ""
                        if head.rpartition(".")[2] in ("Iterator", "Iterable"):
                            elem = _class_name_of(ret.slice)
                            if elem:
                                self.elem[cls.name] = elem

    def attr_is_set(self, cls: Optional[str], attr: str) -> Optional[bool]:
        if cls is None:
            return None
        return self.attrs.get(cls, {}).get(attr)


def _support_paths() -> List[str]:
    """The api/ value-object modules: always fed to the ClassTable (never
    scanned for findings) so Requirement-style attribute kinds resolve
    even when the scan scope is a single copied file (the static
    mutation test copies solver/vocab.py into a tmpdir)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    api = os.path.join(pkg, "api")
    if not os.path.isdir(api):
        return []
    return [
        os.path.join(api, name)
        for name in sorted(os.listdir(api))
        if name.endswith(".py")
    ]


def _var_types(
    fn_body: List[ast.stmt],
    params: Optional[ast.arguments],
    table: ClassTable,
    self_class: Optional[str],
) -> Dict[str, str]:
    """Flow-insensitive receiver typing: parameter annotations,
    constructor calls, AnnAssigns, and `for x in typed` element chaining
    (two rounds reach chains like reqs -> r)."""
    types: Dict[str, str] = {}
    if self_class:
        types["self"] = self_class
    if params is not None:
        for arg in params.posonlyargs + params.args + params.kwonlyargs:
            if arg.annotation is not None:
                cname = _class_name_of(arg.annotation)
                if cname and cname in table.attrs:
                    types[arg.arg] = cname
    for _ in range(2):
        for stmt in fn_body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target = node.targets[0]
                    if isinstance(target, ast.Name) and isinstance(
                        node.value, ast.Call
                    ):
                        callee = dotted_name(node.value.func)
                        if callee:
                            tail = callee.rpartition(".")[2]
                            if tail in table.attrs:
                                types[target.id] = tail
                elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name
                ):
                    cname = _class_name_of(node.annotation)
                    if cname and cname in table.attrs:
                        types[node.target.id] = cname
                elif isinstance(node, (ast.For, ast.comprehension)):
                    target = node.target
                    it = node.iter
                    if isinstance(target, ast.Name) and isinstance(
                        it, ast.Name
                    ):
                        src = types.get(it.id)
                        if src and src in table.elem:
                            types[target.id] = table.elem[src]
    return types


class _OrderAnalysis:
    """One function (or module body) under the order lattice."""

    def __init__(
        self,
        mod: ModuleInfo,
        modules: Dict[str, ModuleInfo],
        findings: List[Finding],
        summaries: Optional[SummaryTable],
        table: ClassTable,
        types: Dict[str, str],
    ):
        self.mod = mod
        self.modules = modules
        self.findings = findings
        self.summaries = summaries
        self.table = table
        self.types = types
        self._flagged: Set[Tuple[int, str]] = set()

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if (line, rule) in self._flagged:
            return
        self._flagged.add((line, rule))
        self.findings.append(
            Finding(rule, Severity.ERROR, self.mod.path, line, message)
        )

    # -- classification ---------------------------------------------------

    def kind(self, node: ast.AST, env: Env) -> int:
        if isinstance(node, ast.Constant):
            return ORDERED
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Attribute):
            name = dotted_name(node)
            if name is not None:
                head, _, rest = name.partition(".")
                origin = self.mod.aliases.get(head, head)
                if (origin + ("." + rest if rest else "")) == "os.environ":
                    return UNORDERED
            if isinstance(node.value, ast.Name):
                is_set = self.table.attr_is_set(
                    self.types.get(node.value.id), node.attr
                )
                if is_set is True:
                    return UNORDERED
                if is_set is False:
                    return ORDERED
            return UNKNOWN
        if isinstance(node, ast.Set):
            return UNORDERED
        if isinstance(node, ast.SetComp):
            return UNORDERED
        if isinstance(node, (ast.List, ast.Tuple, ast.Dict)):
            return ORDERED
        if isinstance(node, ast.ListComp):
            return ORDERED  # flagged as DET1102 at the check when tainted
        if isinstance(node, (ast.GeneratorExp, ast.DictComp)):
            # defers / inherits the generators' order
            return max(
                (self.kind(g.iter, env) for g in node.generators),
                default=ORDERED,
            )
        if isinstance(node, ast.Call):
            return self._call_kind(node, env)
        if isinstance(node, ast.NamedExpr):
            return self.kind(node.value, env)
        if isinstance(node, ast.BinOp):
            # set algebra (| & - ^) keeps the taint; scalar arithmetic is
            # ORDERED v ORDERED and joins clean
            return max(self.kind(node.left, env), self.kind(node.right, env))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return ORDERED
            return self.kind(node.operand, env)
        if isinstance(node, ast.BoolOp):
            return max((self.kind(v, env) for v in node.values),
                       default=ORDERED)
        if isinstance(node, ast.Compare):
            return ORDERED  # membership tests are the sanctioned use
        if isinstance(node, ast.IfExp):
            return max(self.kind(node.body, env), self.kind(node.orelse, env))
        if isinstance(node, ast.Starred):
            return self.kind(node.value, env)
        if isinstance(node, ast.JoinedStr):
            return ORDERED
        if isinstance(node, ast.Lambda):
            return ORDERED
        return UNKNOWN

    def _call_kind(self, node: ast.Call, env: Env) -> int:
        cname = call_name(node, self.mod.aliases)
        arg0 = node.args[0] if node.args else None
        if cname in ("set", "frozenset"):
            return UNORDERED
        if cname == "sorted":
            return ORDERED  # THE canonicalizer
        if cname in _REDUCERS:
            return ORDERED
        if cname in _MATERIALIZERS:
            return ORDERED  # the sink check flags; result order is fixed
        if cname == "dict":
            # insertion order inherits an unordered source's hash order
            if arg0 is not None and self.kind(arg0, env) == UNORDERED:
                return UNORDERED
            return ORDERED
        if cname == "reversed" and arg0 is not None:
            return self.kind(arg0, env)
        if isinstance(node.func, ast.Attribute):
            recv = self.kind(node.func.value, env)
            if node.func.attr in _SET_PRODUCERS or node.func.attr in _DICT_VIEWS:
                return recv  # set algebra / dict views carry the receiver
            if node.func.attr == "add":
                return ORDERED
        # call-graph reach: a helper returning a set taints its caller
        raw = dotted_name(node.func)
        if (
            self.summaries is not None
            and raw is not None
            and "." not in raw
            and not env.has(raw)
        ):
            hit = resolve_local(self.mod, raw, self.modules)
            if hit is not None:
                return _return_kind(hit[0], hit[1], self)
        return UNKNOWN

    def _unordered_names(self, node: ast.AST, env: Env) -> str:
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and env.get(sub.id) == UNORDERED:
                if sub.id not in out:
                    out.append(sub.id)
            elif isinstance(sub, ast.Attribute):
                if self.kind(sub, env) == UNORDERED:
                    name = dotted_name(sub)
                    if name and name not in out:
                        out.append(name)
        return ", ".join(out) or "an unordered value"

    # -- transfer ---------------------------------------------------------

    def _bind_target(self, target: ast.AST, kind: int, env: Env) -> None:
        if isinstance(target, ast.Name):
            env.set(target.id, kind)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_target(elt, UNKNOWN, env)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, kind, env)

    def _bind_walrus(self, node: ast.AST, env: Env) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.NamedExpr) and isinstance(
                sub.target, ast.Name
            ):
                env.set(sub.target.id, self.kind(sub.value, env))

    def transfer(self, atom: Atom, env: Env) -> None:
        node = atom.node
        if atom.kind == "stmt":
            self._bind_walrus(node, env)
            if isinstance(node, ast.Assign):
                kind = self.kind(node.value, env)
                for target in node.targets:
                    self._bind_target(target, kind, env)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._bind_target(
                    node.target, self.kind(node.value, env), env
                )
            elif isinstance(node, ast.AugAssign):
                if isinstance(node.target, ast.Name):
                    env.set(
                        node.target.id,
                        max(env.get(node.target.id),
                            self.kind(node.value, env)),
                    )
        elif atom.kind == "test":
            self._bind_walrus(node, env)
        elif atom.kind == "for":
            self._bind_walrus(node.iter, env)
            # elements of any iterable are scalar values; their own
            # order-ness is a fresh question
            self._bind_target(node.target, ORDERED, env)
        elif atom.kind == "with":
            self._bind_walrus(node.context_expr, env)
            if node.optional_vars is not None:
                self._bind_target(node.optional_vars, UNKNOWN, env)
        elif atom.kind == "except":
            if node.name:
                env.set(node.name, ORDERED)

    # -- checks -----------------------------------------------------------

    def check(self, atom: Atom, env: Env) -> None:
        node = atom.node
        if atom.kind == "stmt":
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._check_expr(child, env)
        elif atom.kind == "test":
            self._check_expr(node, env)
        elif atom.kind == "for":
            if self.kind(node.iter, env) == UNORDERED:
                self._flag(
                    "DET1101", node,
                    f"iteration over unordered value(s) "
                    f"({self._unordered_names(node.iter, env)}) runs in "
                    "PYTHONHASHSEED order; wrap in sorted() so interned "
                    "ids / emitted records are content-ordered, or mark "
                    "the loop `# analysis: sanctioned[DET1101] reason` "
                    "if the body is provably commutative",
                )
            self._check_expr(node.iter, env)
        elif atom.kind == "with":
            self._check_expr(node.context_expr, env)
        elif atom.kind == "def":
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(
                    self.mod, node, self.findings, self.modules,
                    self.summaries, self.table, shared_flags=self._flagged,
                )
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        _check_function(
                            self.mod, item, self.findings, self.modules,
                            self.summaries, self.table,
                            self_class=node.name,
                            shared_flags=self._flagged,
                        )

    def _check_expr(self, node: ast.AST, env: Env) -> None:
        if isinstance(node, ast.Call):
            self._check_call(node, env)
        elif isinstance(node, ast.ListComp):
            for gen in node.generators:
                if self.kind(gen.iter, env) == UNORDERED:
                    self._flag(
                        "DET1102", node,
                        "list comprehension over unordered value(s) "
                        f"({self._unordered_names(gen.iter, env)}) "
                        "freezes an arbitrary hash order; iterate "
                        "sorted(...) instead",
                    )
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.comprehension, ast.keyword,
                                  ast.FormattedValue)):
                self._check_expr(child, env)

    def _check_call(self, node: ast.Call, env: Env) -> None:
        cname = call_name(node, self.mod.aliases)
        arg0 = node.args[0] if node.args else None
        if cname in _MATERIALIZERS and arg0 is not None:
            if self.kind(arg0, env) == UNORDERED:
                self._flag(
                    "DET1102", node,
                    f"{cname}() over unordered value(s) "
                    f"({self._unordered_names(arg0, env)}) freezes an "
                    "arbitrary hash order into an indexable sequence; "
                    "use sorted() to pin a content order",
                )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
            and arg0 is not None
            and self.kind(arg0, env) == UNORDERED
        ):
            self._flag(
                "DET1103", node,
                "join over unordered value(s) "
                f"({self._unordered_names(arg0, env)}) produces a "
                "hash-ordered record; canonical strings must join "
                "sorted(...)",
            )
        elif cname in _GLOBAL_RNG or (
            cname.startswith("numpy.random.")
            and cname.rpartition(".")[2] not in _NP_RNG_OK
        ):
            self._flag(
                "DET1104", node,
                f"{cname} draws from the unseeded global RNG; the "
                "determinism surface threads seeded "
                "np.random.default_rng(seed)/random.Random(seed) "
                "instances (twin replays must be byte-identical)",
            )


def _param_env(fn: ast.AST, base: Env) -> Env:
    """Parameters are UNKNOWN: the pass only flags values whose unordered
    origin it can actually see (poison-to-unknown)."""
    env = base
    args = fn.args
    for arg in args.posonlyargs + args.args + args.kwonlyargs:
        env.set(arg.arg, UNKNOWN)
    if args.vararg is not None:
        env.set(args.vararg.arg, UNKNOWN)
    if args.kwarg is not None:
        env.set(args.kwarg.arg, UNKNOWN)
    return env


def _return_kind(mod: ModuleInfo, fn: ast.FunctionDef,
                 caller: "_OrderAnalysis") -> int:
    """Call-graph return summary: does the helper hand back an unordered
    value? Bottom-up through the shared SummaryTable; recursive clusters
    read UNKNOWN by SCC collapse."""
    summaries = caller.summaries

    def compute() -> int:
        types = _var_types(fn.body, fn.args, caller.table, None)
        analysis = _OrderAnalysis(
            mod, caller.modules, [], summaries, caller.table, types
        )
        init = _param_env(fn, Env(LATTICE))
        cfg = build_cfg(fn.body)
        envs = run_forward(cfg, init, analysis.transfer)
        out = [ORDERED]

        def collect(atom: Atom, env: Env) -> None:
            if (
                atom.kind == "stmt"
                and isinstance(atom.node, ast.Return)
                and atom.node.value is not None
            ):
                out.append(analysis.kind(atom.node.value, env))

        sweep(cfg, envs, init, analysis.transfer, collect)
        return max(out)

    return summaries.get((mod.path, fn.name), compute)


def _check_function(
    mod: ModuleInfo,
    fn: ast.FunctionDef,
    findings: List[Finding],
    modules: Dict[str, ModuleInfo],
    summaries: Optional[SummaryTable],
    table: ClassTable,
    self_class: Optional[str] = None,
    shared_flags: Optional[Set[Tuple[int, str]]] = None,
) -> None:
    types = _var_types(fn.body, fn.args, table, self_class)
    analysis = _OrderAnalysis(mod, modules, findings, summaries, table, types)
    if shared_flags is not None:
        analysis._flagged = shared_flags
    init = _param_env(fn, Env(LATTICE))
    cfg = build_cfg(fn.body)
    envs = run_forward(cfg, init, analysis.transfer)
    sweep(cfg, envs, init, analysis.transfer, analysis.check)


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Run the order-discipline pass; returns (findings, sources)."""
    findings: List[Finding] = []
    modules, sources, errors = load_modules(paths)
    for path, exc in errors:
        findings.append(
            Finding("DET1100", Severity.ERROR, path, 0, f"unparsable: {exc}")
        )
    table = ClassTable()
    scanned = set(modules)
    for path in _support_paths():
        if path in scanned:
            continue
        try:
            with open(path, encoding="utf-8") as fh:
                table.add_module(ast.parse(fh.read(), filename=path))
        except (OSError, SyntaxError):
            continue  # support modules are best-effort, never findings
    for mod in modules.values():
        table.add_module(mod.tree)
    summaries = SummaryTable(default=UNKNOWN, graph=build_call_graph(modules))
    for mod in modules.values():
        types = _var_types(
            [s for s in mod.tree.body
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef))],
            None, table, None,
        )
        analysis = _OrderAnalysis(mod, modules, findings, summaries, table,
                                  types)
        init = Env(LATTICE)
        cfg = build_cfg(
            [s for s in mod.tree.body
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef))]
        )
        envs = run_forward(cfg, init, analysis.transfer)
        sweep(cfg, envs, init, analysis.transfer, analysis.check)
        for fn in mod.index.functions.values():
            _check_function(mod, fn, findings, modules, summaries, table)
        for cls_name, cls_table in mod.index.methods.items():
            for fn in cls_table.values():
                _check_function(mod, fn, findings, modules, summaries, table,
                                self_class=cls_name)
    return findings, sources
