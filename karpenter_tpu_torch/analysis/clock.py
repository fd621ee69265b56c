# Copied from karpenter_tpu/analysis/clock.py.
"""Pass 10: clock discipline (CLK10xx) for the determinism contracts.

The PR-5/PR-6 replay contracts — byte-identical decisions, seeded fault
and trace logs — only hold if every timestamp in the decision path flows
from an injected clock. A single raw ``time.time()`` (or a
``time.monotonic`` reference stashed in a variable and called later)
makes a replayed run diverge from its recording in a way no test can
pin. BLK302 already catches direct wall-clock *calls* in the reconcile
targets; this family covers the determinism surface (controllers/,
faults/, obs/, solver/) with real dataflow:

- CLK1001: a wall-clock read — ``time.time``/``monotonic``/
  ``perf_counter`` (and ``_ns`` variants), ``datetime.now``/``utcnow``/
  ``today`` — reached by a direct call, through a variable the analysis
  tracked the function reference into (``f = time.monotonic`` ...
  ``f()``), or through a local helper that RETURNS a wall-clock callable
  (``f = _pick_clock()`` ... ``f()`` — return-kind summaries propagate
  bottom-up over the module-set call graph, core.summaries, with
  recursive clusters collapsed to plain);
- CLK1002: a wall-clock callable escaping as a value (assigned, passed,
  returned) — a hidden clock source the injection seams can't replace.

Sanctioned sources, and nothing else: the documented RealClock seams —
methods of a class named ``RealClock`` (kube/clock.py) or ``PerfClock``
(obs/trace.py) — plus sites carrying an explicit
``# analysis: sanctioned[CLK1001]`` boundary annotation (real-wall-time
diagnostics like the in-flight-solve age gauge measure wall time BY
DESIGN; the sanction documents that, a suppression would hide it).
Everything else threads the injected clock or ``obs.now()``.
"""

from __future__ import annotations

import ast
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
    "CLK1000": "unparsable file (clock-discipline pass)",
    "CLK1001": "wall-clock read outside an injected clock / RealClock seam",
    "CLK1002": "wall-clock callable escapes as a value (hidden clock source)",
}

PLAIN = 0
CLOCKFN = 1  # a wall-clock callable tracked through bindings

LATTICE = Lattice(top=CLOCKFN, default=PLAIN)

_WALL_CLOCK_FNS = {
    "time.time", "time.monotonic", "time.perf_counter",
    "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns",
    "time.process_time", "time.process_time_ns", "time.clock_gettime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

# the documented RealClock seams: the only classes whose methods may
# read the wall clock directly (kube/clock.py, obs/trace.py)
_SEAM_CLASSES = {"RealClock", "PerfClock"}


def _canonical(name: str, aliases: Dict[str, str]) -> str:
    head, _, rest = name.partition(".")
    origin = aliases.get(head, head)
    return origin + ("." + rest if rest else "")


class _ClockAnalysis:
    """One function under the clock lattice: wall-clock function
    references tracked through bindings; calls and escapes flagged."""

    def __init__(
        self,
        mod: ModuleInfo,
        findings: List[Finding],
        modules: Optional[Dict[str, ModuleInfo]] = None,
        summaries: Optional[SummaryTable] = None,
    ):
        self.mod = mod
        self.findings = findings
        self.modules = modules if modules is not None else {mod.path: mod}
        self.summaries = summaries
        self._flagged: Set[Tuple[int, str]] = set()

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if (line, rule) in self._flagged:
            return
        # sanctioned sites still EMIT: partition_findings classifies them
        # into the sanctioned channel (so the CLI can count the boundary
        # and the stale audit can see the marker is live)
        self._flagged.add((line, rule))
        self.findings.append(
            Finding(rule, Severity.ERROR, self.mod.path, line, message)
        )

    # -- classification ---------------------------------------------------

    def _is_wall_clock_ref(self, node: ast.AST) -> bool:
        name = dotted_name(node)
        if name is None:
            return False
        return _canonical(name, self.mod.aliases) in _WALL_CLOCK_FNS

    def kind(self, node: ast.AST, env: Env) -> int:
        if isinstance(node, ast.Name):
            if self._is_wall_clock_ref(node):
                return CLOCKFN
            return env.get(node.id)
        if isinstance(node, ast.Attribute):
            if self._is_wall_clock_ref(node):
                return CLOCKFN
            return PLAIN
        if isinstance(node, ast.IfExp):
            return max(self.kind(node.body, env), self.kind(node.orelse, env))
        if isinstance(node, ast.BoolOp):
            # `clock or time.monotonic` keeps the fallback visible
            return max((self.kind(v, env) for v in node.values), default=PLAIN)
        if isinstance(node, ast.NamedExpr):
            return self.kind(node.value, env)
        if isinstance(node, ast.Call):
            # call-graph reach: a bare-name call resolving to a local
            # helper takes the helper's summarized return kind — a
            # helper that hands back time.monotonic makes its call site
            # a clock source (`f = _pick_clock(); ... f()`)
            raw = dotted_name(node.func)
            if (
                self.summaries is not None
                and raw is not None
                and "." not in raw
                and not env.has(raw)
            ):
                hit = resolve_local(self.mod, raw, self.modules)
                if hit is not None:
                    return _return_kind(
                        hit[0], hit[1], self.modules, self.summaries
                    )
            return PLAIN
        return PLAIN

    # -- transfer ---------------------------------------------------------

    def _bind_target(self, target: ast.AST, kind: int, env: Env) -> None:
        if isinstance(target, ast.Name):
            env.set(target.id, kind)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_target(elt, PLAIN, env)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, kind, env)

    def transfer(self, atom: Atom, env: Env) -> None:
        node = atom.node
        if atom.kind == "stmt":
            if isinstance(node, ast.Assign):
                kind = self.kind(node.value, env)
                for target in node.targets:
                    self._bind_target(target, kind, env)
                # `self._now = time.perf_counter` escapes through the
                # instance; attribute stores can't be tracked further
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._bind_target(
                    node.target, self.kind(node.value, env), env
                )
        elif atom.kind == "for":
            self._bind_target(node.target, PLAIN, env)

    # -- checks -----------------------------------------------------------

    def check(self, atom: Atom, env: Env) -> None:
        node = atom.node
        if atom.kind == "def":
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                check_function(self.mod, node, self.findings, parent=self)
            elif isinstance(node, ast.ClassDef):
                _check_class(self.mod, node, self.findings,
                             modules=self.modules, summaries=self.summaries)
            return
        if atom.kind == "for":
            self._check_expr(node.iter, env)
            return
        if atom.kind == "with":
            self._check_expr(node.context_expr, env)
            return
        if atom.kind == "test":
            self._check_expr(node, env)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._check_expr(child, env)

    def _check_expr(self, node: ast.AST, env: Env) -> None:
        if isinstance(node, ast.Call):
            cname = call_name(node, self.mod.aliases)
            if cname in _WALL_CLOCK_FNS:
                self._flag(
                    "CLK1001", node,
                    f"{cname} reads the wall clock; thread the injected "
                    "clock (kube/clock.py) or obs.now() so replays are "
                    "deterministic",
                )
            elif (
                isinstance(node.func, ast.Name)
                and env.get(node.func.id) == CLOCKFN
            ):
                self._flag(
                    "CLK1001", node,
                    f"{node.func.id}() resolves to a wall-clock function "
                    "bound earlier; thread the injected clock instead",
                )
            # arguments may still smuggle a clock reference out; the
            # callee itself was just checked as a call, so a plain
            # dotted callee is NOT re-checked as an escaping reference
            for child in list(node.args) + [kw.value for kw in node.keywords]:
                self._check_expr(child, env)
            if not isinstance(node.func, (ast.Name, ast.Attribute)):
                self._check_expr(node.func, env)
            return
        if self._is_wall_clock_ref(node):
            # a bare reference in value position: assigned, passed,
            # returned — a clock source injection can't replace
            name = dotted_name(node)
            self._flag(
                "CLK1002", node,
                f"{_canonical(name, self.mod.aliases)} escapes as a "
                "value; inject a Clock (kube/clock.py) so tests and "
                "replays can drive time",
            )
            return
        if isinstance(node, ast.Lambda):
            self._check_expr(node.body, env)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.comprehension, ast.keyword,
                                  ast.FormattedValue)):
                self._check_expr(child, env)


def _return_kind(
    mod: ModuleInfo,
    fn: ast.FunctionDef,
    modules: Dict[str, ModuleInfo],
    summaries: SummaryTable,
) -> int:
    """Does the helper return a wall-clock callable? Joined over every
    return expression, bottom-up over the call graph (a helper returning
    another helper's clock result resolves too); recursive clusters read
    PLAIN by SCC collapse."""

    def compute() -> int:
        analysis = _ClockAnalysis(mod, [], modules=modules, summaries=summaries)
        init = Env(LATTICE)
        cfg = build_cfg(fn.body)
        envs = run_forward(cfg, init, analysis.transfer)
        out = [PLAIN]

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


def check_function(
    mod: ModuleInfo,
    fn: ast.FunctionDef,
    findings: List[Finding],
    parent: "_ClockAnalysis" = None,
    modules: Optional[Dict[str, ModuleInfo]] = None,
    summaries: Optional[SummaryTable] = None,
) -> None:
    if parent is not None:
        modules = modules if modules is not None else parent.modules
        summaries = summaries if summaries is not None else parent.summaries
    analysis = _ClockAnalysis(mod, findings, modules=modules, summaries=summaries)
    if parent is not None:
        analysis._flagged = parent._flagged
    init = Env(LATTICE)
    cfg = build_cfg(fn.body)
    envs = run_forward(cfg, init, analysis.transfer)
    sweep(cfg, envs, init, analysis.transfer, analysis.check)


def _check_class(
    mod: ModuleInfo,
    cls: ast.ClassDef,
    findings: List[Finding],
    modules: Optional[Dict[str, ModuleInfo]] = None,
    summaries: Optional[SummaryTable] = None,
):
    if cls.name in _SEAM_CLASSES:
        return  # the documented RealClock seams read the wall clock
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            check_function(mod, item, findings, modules=modules,
                           summaries=summaries)
        elif isinstance(item, ast.ClassDef):
            _check_class(mod, item, findings, modules=modules,
                         summaries=summaries)


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Run the clock-discipline pass; returns (findings, sources)."""
    findings: List[Finding] = []
    modules, sources, errors = load_modules(paths)
    for path, exc in errors:
        findings.append(
            Finding("CLK1000", Severity.ERROR, path, 0, f"unparsable: {exc}")
        )
    summaries = SummaryTable(default=PLAIN, graph=build_call_graph(modules))
    for mod in modules.values():
        # module body (constants like `_NOW = time.time()`), then every
        # top-level function and class method
        analysis = _ClockAnalysis(mod, findings, modules=modules,
                                  summaries=summaries)
        init = Env(LATTICE)
        cfg = build_cfg(
            [s for s in mod.tree.body
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef))]
        )
        envs = run_forward(cfg, init, analysis.transfer)
        sweep(cfg, envs, init, analysis.transfer, analysis.check)
        for fn in mod.index.functions.values():
            check_function(mod, fn, findings, modules=modules,
                           summaries=summaries)
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                _check_class(mod, node, findings, modules=modules,
                             summaries=summaries)
    return findings, sources
