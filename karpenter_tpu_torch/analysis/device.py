"""Pass 9: the torch host-sync rule (DTX9xx) for the port's solve path.

The card runs ahead of the host only while nothing on the host waits for
it: one stray sync — a truthiness test on a CUDA tensor, ``int()`` /
``.item()``, an ``np.asarray`` on a device tensor, iteration, a print —
blocks until the stream drains, serializing the launches the warm path is
meant to overlap with host work. This pass machine-checks where the host
may wait.

Hosted on the dataflow core: values are tracked as DEVICE from their
origins —

- tensors made on, or moved to, a device: ``torch.*(..., device=d)``,
  ``x.to(d)``, ``x.cuda()`` (a literal ``"cpu"`` device makes a HOST
  value), and torch operations on a DEVICE operand;
- the kernel launchers' returns, by the naming convention of ops/
  (``dispatch_*`` in ops/solve.py, the ``_launch_*`` wrappers of the
  csrc bindings), and the two-slot dispatch queue that carries them
  (``_queue.submit``'s slot and ``_queue.drain``'s outputs,
  solver/residency.py:DispatchQueue);
- the residency store's buffers: attributes named by the resident
  convention ``dev_*`` / ``_dev_*`` (solver/residency.py's
  ``_dev_buffers``) hold device tensors ACROSS solves, so loads from them
  are DEVICE-born whatever object carries them. (The convention wants the
  underscore: ``_device``, which holds a ``torch.device``, is no buffer.)

— through assignments, attributes, tuple unpacks, and helper calls
(return-kind summaries propagate bottom-up over the module-set call
graph, core.summaries); everything the analysis loses track of joins to
UNKNOWN and never flags (poison-to-unknown), and recursive helper clusters
collapse to UNKNOWN by SCC. Tensor metadata (``.shape``, ``.dtype``,
``.device``, ``.numel()``, ``.data_ptr()``, ...) is HOST. Host-sync sinks
flag only on *definite* device values:

- DTX901: truthiness — ``if``/``while``/``assert``/ternary/``not``/
  ``bool()`` on a device value
- DTX902: host materialization — ``float()``/``int()``/``complex()``,
  ``.item()``/``.tolist()``/``.numpy()``
- DTX903: host-numpy call (``np.asarray``/``np.array``/any ``numpy.*``)
  on a device value
- DTX904: Python iteration over a device value (``for``, unpacking,
  ``list()``/``sorted()``/``min()``/...)
- DTX905: ``print``/f-string/``str()`` interpolation of a device value
- DTX906: explicit host wait — EVERY ``.cpu()`` (and ``.to("cpu")``),
  ``torch.cuda.synchronize`` and stream/event ``.synchronize()``,
  whatever it is called on. This one is not an error to *have*; it is an
  error to have UNSANCTIONED: the drain, the relax readbacks and the
  traced runs' staging wait carry ``# analysis: sanctioned[DTX906]
  reason`` annotations, and a change must not widen the set. (A sanction
  is an audited boundary marker, not a suppression — see findings.py.)

The plain PyTorch versions (``*_reference`` functions and what they
define) are outside the rule: they are the kernels' CPU stand-ins and
read values back by design.

Some syncs no static sink shows: torch waits inside an operation (a
blocking host->device copy from pageable memory, a ``nonzero``, a
boolean-mask index). ``IMPLICIT_SYNCS`` lists those the card reported
(``torch.cuda.set_sync_debug_mode``, chip_smoke.py phase 15), each with
its reason; the smoke holds every sync the card reports to them and to
the DTX906 sanctions.

``.cpu()`` and sanctioned sinks yield HOST downstream, so the decode path
(all host numpy after the readback) stays silent.
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
    "DTX900": "unparsable file (device-residency pass)",
    "DTX901": "truthiness/branch on a device value (host sync)",
    "DTX902": "host materialization of a device value",
    "DTX903": "host-numpy call on a device value (implicit readback)",
    "DTX904": "python iteration over a device value (host sync)",
    "DTX905": "print/f-string interpolation of a device value",
    "DTX906": "host wait for the card outside a sanctioned site",
}

HOST = 0
DEVICE = 1
UNKNOWN = 2  # poison: lost track -> never flag

LATTICE = Lattice(top=UNKNOWN, default=HOST)

# torch APIs that return host/python values or are control surface
_HOST_TORCH = (
    "torch.device", "torch.cuda", "torch.Size", "torch.iinfo",
    "torch.finfo", "torch.is_tensor", "torch.no_grad", "torch.inference_mode",
    "torch.get_default_dtype", "torch.manual_seed", "torch.Generator",
    "torch.profiler", "torch.backends", "torch.from_numpy",
)
# host waits, whatever they are called on (DTX906)
_SYNC_CALLS = ("torch.cuda.synchronize",)
_SYNC_METHODS = {"cpu", "synchronize"}
# kernel-launch naming convention (ops/): these return device tensors by
# contract even through the fault-seam wrappers
_DISPATCH_PREFIXES = ("dispatch_", "_launch_")
# the dispatch queue (solver/residency.py:DispatchQueue) that the solver
# holds as ``_queue``: a submitted slot holds a launcher's outputs, and
# draining it hands them back
_QUEUE_ATTR = "_queue"
_QUEUE_METHODS = {"submit", "drain"}
# device-resident attribute naming convention (solver/residency.py):
# attributes holding device buffers BETWEEN solves — loads are
# DEVICE-born, so host sinks on them flag even though the carrying
# object itself is untracked ("no host crossing between solves")
_RESIDENT_ATTR_PREFIXES = ("dev_", "_dev_")
# the plain versions, outside the rule
_PLAIN_SUFFIX = "_reference"

_SHAPE_ATTRS = {"shape", "ndim", "size", "dtype", "itemsize", "nbytes",
                "device", "is_cuda", "layout", "requires_grad"}
# tensor methods that return host metadata
_HOST_METHODS = {"numel", "dim", "size", "stride", "element_size",
                 "data_ptr", "is_contiguous", "nelement", "ndimension",
                 "get_device", "storage_offset"}
_MATERIALIZERS = {"float", "int", "complex"}
_MATERIALIZER_METHODS = {"item", "tolist", "numpy"}
_ITERATORS = {"list", "tuple", "set", "sorted", "sum", "min", "max",
              "any", "all", "iter", "enumerate", "zip", "map", "filter",
              "frozenset"}
_STRINGIFIERS = {"str", "repr", "format", "print"}
_HOST_BUILTINS = {"len", "isinstance", "issubclass", "getattr", "hasattr",
                  "type", "range", "id", "callable"}

# Syncs the card reports that no sink of this pass can see, each
# sanctioned with its reason: (path from the repo root, function,
# reason). chip_smoke.py phase 15 holds every sync the card reports under
# torch.cuda.set_sync_debug_mode("warn") to these and to the DTX906
# sanctions.
IMPLICIT_SYNCS = (
    ("karpenter_tpu_torch/solver/args.py", "put",
     "a blocking host->device copy from pageable memory: torch waits for "
     "the stream before it copies. The scenario batch stages its "
     "per-scenario g_count and n_tol stacks here on every call; a warm "
     "solve that reuses its buffers stages nothing"),
)


def _is_cpu(node: ast.AST) -> bool:
    """A literal CPU device: ``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
        "torch.device", "device"
    ):
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _is_device_arg(node: ast.AST) -> bool:
    """Whether a positional ``.to()`` argument names a device rather than
    a dtype: a string, a ``torch.device(...)``, a ``.device`` attribute or
    a name that says so (``dev``, ``device``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in ("torch.device", "device")
    if isinstance(node, ast.Attribute):
        return node.attr == "device"
    if isinstance(node, ast.Name):
        return "dev" in node.id
    return False


def _to_target(node: ast.Call) -> Optional[ast.AST]:
    """The device a ``.to(...)`` call moves to, or None (a dtype cast)."""
    for kw in node.keywords:
        if kw.arg == "device":
            return kw.value
    if node.args and _is_device_arg(node.args[0]):
        return node.args[0]
    return None


class _DeviceAnalysis:
    """One function (or module body) under the device-residency lattice."""

    def __init__(
        self,
        mod: ModuleInfo,
        modules: Dict[str, ModuleInfo],
        findings: List[Finding],
        summaries: Optional[SummaryTable],
    ):
        self.mod = mod
        self.modules = modules
        self.findings = findings
        self.summaries = summaries
        self._flagged: Set[Tuple[int, str]] = set()
        # return-kind summaries of nested defs seen in this scope, joined
        # across conditional re-definitions
        self._local_ret: Dict[str, int] = {}

    # -- reporting --------------------------------------------------------

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
            return HOST
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return HOST
            if node.attr.startswith(_RESIDENT_ATTR_PREFIXES):
                # the device-resident naming convention: dev_*/_dev_*
                # attributes hold device buffers between solves, so a
                # load is DEVICE-born regardless of the carrying object
                return DEVICE
            return self.kind(node.value, env)
        if isinstance(node, ast.Subscript):
            return self.kind(node.value, env)
        if isinstance(node, ast.Call):
            return self._call_kind(node, env)
        if isinstance(node, ast.NamedExpr):
            return self.kind(node.value, env)
        if isinstance(node, ast.BinOp):
            return max(self.kind(node.left, env), self.kind(node.right, env))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return HOST  # truthiness flagged as a sink, result is bool
            return self.kind(node.operand, env)
        if isinstance(node, ast.BoolOp):
            return max((self.kind(v, env) for v in node.values), default=HOST)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return HOST
            return max(
                self.kind(node.left, env),
                max((self.kind(c, env) for c in node.comparators),
                    default=HOST),
            )
        if isinstance(node, ast.IfExp):
            return max(self.kind(node.body, env), self.kind(node.orelse, env))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return max((self.kind(e, env) for e in node.elts), default=HOST)
        if isinstance(node, ast.Starred):
            return self.kind(node.value, env)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            return max(
                (self.kind(g.iter, env) for g in node.generators),
                default=HOST,
            )
        if isinstance(node, ast.JoinedStr):
            return HOST
        if isinstance(node, (ast.Dict, ast.DictComp)):
            return UNKNOWN
        if isinstance(node, ast.Lambda):
            return UNKNOWN
        if isinstance(node, ast.Slice):
            return HOST
        return UNKNOWN

    def _call_kind(self, node: ast.Call, env: Env) -> int:
        cname = call_name(node, self.mod.aliases)
        if isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if meth == "cpu":
                return HOST  # the readback itself is checked as DTX906
            recv = node.func.value
            if (meth in _QUEUE_METHODS and isinstance(recv, ast.Attribute)
                    and recv.attr == _QUEUE_ATTR):
                return DEVICE
            if meth == "cuda":
                return DEVICE
            if meth == "to":
                target = _to_target(node)
                if target is not None:
                    return HOST if _is_cpu(target) else DEVICE
        if cname:
            last = cname.rpartition(".")[2]
            if any(cname == h or cname.startswith(h + ".")
                   for h in _HOST_TORCH):
                return HOST
            if cname.startswith("torch."):
                return self._torch_kind(node, env)
            if last.startswith(_DISPATCH_PREFIXES):
                return DEVICE
            head = cname.partition(".")[0]
            origin = self.mod.aliases.get(head, head)
            if origin == "numpy" or cname.startswith("numpy."):
                return HOST  # numpy returns host arrays (sink checked)
            if cname in _MATERIALIZERS or cname in _STRINGIFIERS:
                return HOST
            if cname in _HOST_BUILTINS:
                return HOST
            if cname in ("bool",):
                return HOST
            if cname in _ITERATORS:
                return UNKNOWN
        raw = dotted_name(node.func)
        if raw is not None and "." not in raw:
            if raw in self._local_ret:
                return self._local_ret[raw]
            if self.summaries is not None and not env.has(raw):
                hit = resolve_local(self.mod, raw, self.modules)
                if hit is not None:
                    return _return_kind(
                        hit[0], hit[1], self.modules, self.summaries
                    )
        if isinstance(node.func, ast.Attribute):
            recv = self.kind(node.func.value, env)
            if recv == DEVICE:
                if node.func.attr in _MATERIALIZER_METHODS:
                    return HOST  # flagged as DTX902 at the check
                if node.func.attr in _HOST_METHODS:
                    return HOST
                return DEVICE  # .sum/.reshape/.to(dtype)/... stay on device
            if recv == HOST:
                return HOST
        return UNKNOWN

    def _torch_kind(self, node: ast.Call, env: Env) -> int:
        """A ``torch.*`` call: on the device it is given (``device=``),
        else where its operands are — DEVICE if any is, HOST if all are."""
        for kw in node.keywords:
            if kw.arg == "device":
                return HOST if _is_cpu(kw.value) else DEVICE
        kinds = [self.kind(a, env) for a in node.args] + [
            self.kind(kw.value, env) for kw in node.keywords
        ]
        if DEVICE in kinds:
            return DEVICE
        return HOST if all(k == HOST for k in kinds) else UNKNOWN

    def _device_names(self, node: ast.AST, env: Env) -> str:
        out = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and env.get(sub.id) == DEVICE:
                if sub.id not in out:
                    out.append(sub.id)
        return ", ".join(out) or "a device value"

    # -- transfer ---------------------------------------------------------

    def _bind_target(self, target: ast.AST, value: Optional[ast.AST],
                     kind: int, env: Env) -> None:
        if isinstance(target, ast.Name):
            env.set(target.id, kind)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(
                value.elts
            ) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind_target(t, v, self.kind(v, env), env)
                return
            # tuple returns from torch calls and kernel launchers unpack
            # without host iteration: elements inherit the kind
            for elt in target.elts:
                self._bind_target(elt, None, kind, env)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, None, kind, env)

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
                    self._bind_target(target, node.value, kind, env)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._bind_target(
                    node.target, node.value, self.kind(node.value, env), env
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
            iter_kind = self.kind(node.iter, env)
            elem = UNKNOWN if iter_kind != HOST else HOST
            self._bind_target(node.target, None, elem, env)
        elif atom.kind == "with":
            self._bind_walrus(node.context_expr, env)
            if node.optional_vars is not None:
                self._bind_target(
                    node.optional_vars, None, UNKNOWN, env
                )
        elif atom.kind == "except":
            if node.name:
                env.set(node.name, HOST)
        elif atom.kind == "def":
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ret = self._nested_return_kind(node, env)
                prior = self._local_ret.get(node.name)
                self._local_ret[node.name] = (
                    ret if prior is None else max(prior, ret)
                )

    def _nested_return_kind(self, fn: ast.AST, env: Env) -> int:
        """Return-kind summary of a nested def against a snapshot of the
        enclosing scope (closures over device values resolve)."""
        sub = _DeviceAnalysis(self.mod, self.modules, [], self.summaries)
        init = _param_env(fn, Env(LATTICE, dict(env.kinds)))
        cfg = build_cfg(fn.body)
        envs = run_forward(cfg, init, sub.transfer)
        out = [HOST]

        def collect(atom: Atom, e: Env) -> None:
            if (
                atom.kind == "stmt"
                and isinstance(atom.node, ast.Return)
                and atom.node.value is not None
            ):
                out.append(sub.kind(atom.node.value, e))

        sweep(cfg, envs, init, sub.transfer, collect)
        return max(out)

    # -- checks -----------------------------------------------------------

    def check(self, atom: Atom, env: Env) -> None:
        node = atom.node
        if atom.kind == "stmt":
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._check_expr(child, env)
        elif atom.kind == "test":
            if atom.label in ("if", "while", "assert"):
                self._check_truthiness(node, atom.label, env)
            self._check_expr(node, env)
        elif atom.kind == "for":
            if self.kind(node.iter, env) == DEVICE:
                self._flag(
                    "DTX904", node,
                    f"python loop over device value(s) "
                    f"({self._device_names(node.iter, env)}) syncs once "
                    "per element; keep the loop on device or read back "
                    "at the decode boundary",
                )
            self._check_expr(node.iter, env)
        elif atom.kind == "with":
            self._check_expr(node.context_expr, env)
        elif atom.kind == "def":
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(
                    self.mod, node, self.findings, self.modules,
                    self.summaries, parent_env=env, shared_flags=self._flagged,
                )
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        _check_function(
                            self.mod, item, self.findings, self.modules,
                            self.summaries, parent_env=env,
                            shared_flags=self._flagged,
                        )

    def _check_truthiness(self, test: ast.AST, what: str, env: Env) -> None:
        nodes = (
            list(test.values) if isinstance(test, ast.BoolOp) else [test]
        )
        for n in nodes:
            target = n.operand if (
                isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not)
            ) else n
            if self.kind(target, env) == DEVICE:
                self._flag(
                    "DTX901", test,
                    f"python {what} on device value(s) "
                    f"({self._device_names(target, env)}) forces a host "
                    "sync; branch on host metadata or use torch.where",
                )

    def _check_expr(self, node: ast.AST, env: Env) -> None:
        if isinstance(node, ast.Call):
            self._check_call(node, env)
        elif isinstance(node, ast.IfExp):
            self._check_truthiness(node.test, "ternary", env)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            if self.kind(node.operand, env) == DEVICE:
                self._flag(
                    "DTX901", node,
                    "`not` on a device value forces a host sync; compare "
                    "on host metadata or keep the predicate on device",
                )
        elif isinstance(node, ast.FormattedValue):
            if self.kind(node.value, env) == DEVICE:
                self._flag(
                    "DTX905", node,
                    "f-string interpolation of a device value syncs it to "
                    "host; log host metadata or defer to the decode "
                    "boundary",
                )
        elif isinstance(node, ast.NamedExpr):
            self._check_expr(node.value, env)
            if isinstance(node.target, ast.Name):
                env.set(node.target.id, self.kind(node.value, env))
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.comprehension, ast.keyword,
                                  ast.FormattedValue)):
                self._check_expr(child, env)

    def _check_call(self, node: ast.Call, env: Env) -> None:
        cname = call_name(node, self.mod.aliases)
        arg_kinds = [self.kind(a, env) for a in node.args]
        # sanctioned sites still emit: partition_findings routes them into
        # the sanctioned channel, which is how the CLI counts the blessed
        # boundary and how the stale audit sees a marker is live
        if cname in _SYNC_CALLS or (
            isinstance(node.func, ast.Attribute)
            and (
                node.func.attr in _SYNC_METHODS
                or (node.func.attr == "to" and _to_target(node) is not None
                    and _is_cpu(_to_target(node)))
            )
        ):
            what = (f"{cname}()" if cname in _SYNC_CALLS
                    else f".{node.func.attr}()")
            self._flag(
                "DTX906", node,
                f"{what} makes the host wait for the card; a sanctioned "
                "host-sync site must carry an "
                "`# analysis: sanctioned[DTX906]` annotation",
            )
        elif cname in _MATERIALIZERS and DEVICE in arg_kinds:
            self._flag(
                "DTX902", node,
                f"{cname}() materializes a device value on host "
                "(one blocking sync per call)",
            )
        elif cname == "bool" and DEVICE in arg_kinds:
            self._flag(
                "DTX901", node,
                "bool() on a device value forces a host sync",
            )
        elif cname in _ITERATORS and DEVICE in arg_kinds:
            self._flag(
                "DTX904", node,
                f"{cname}() iterates a device value on host (one "
                "sync per element)",
            )
        elif cname in _STRINGIFIERS and DEVICE in arg_kinds:
            self._flag(
                "DTX905", node,
                f"{cname}() renders a device value on host (blocking "
                "sync); print host metadata instead",
            )
        else:
            head = cname.partition(".")[0] if cname else ""
            origin = self.mod.aliases.get(head, head)
            if (origin == "numpy" or cname.startswith("numpy.")) and (
                DEVICE in arg_kinds
                or any(
                    self.kind(kw.value, env) == DEVICE
                    for kw in node.keywords
                )
            ):
                self._flag(
                    "DTX903", node,
                    f"{cname} on a device value is an implicit "
                    "readback; read back once at a sanctioned "
                    "decode boundary instead",
                )
        if isinstance(node.func, ast.Attribute):
            if (
                node.func.attr in _MATERIALIZER_METHODS
                and self.kind(node.func.value, env) == DEVICE
            ):
                self._flag(
                    "DTX902", node,
                    f".{node.func.attr}() materializes a device value on "
                    "host (one blocking sync per call)",
                )


def _param_env(fn: ast.AST, base: Env) -> Env:
    """Parameters are UNKNOWN: the pass only tracks values whose device
    origin it can see (poison-to-unknown keeps helper params silent)."""
    env = base
    args = fn.args
    for arg in args.posonlyargs + args.args + args.kwonlyargs:
        env.set(arg.arg, UNKNOWN)
    if args.vararg is not None:
        env.set(args.vararg.arg, UNKNOWN)
    if args.kwarg is not None:
        env.set(args.kwarg.arg, UNKNOWN)
    return env


def _return_kind(
    mod: ModuleInfo,
    fn: ast.FunctionDef,
    modules: Dict[str, ModuleInfo],
    summaries: SummaryTable,
) -> int:
    """Call-graph helper summary: nested helper calls resolve through
    the same table (bottom-up, SCC-collapsed to UNKNOWN)."""

    def compute() -> int:
        analysis = _DeviceAnalysis(mod, modules, [], summaries=summaries)
        init = _param_env(fn, Env(LATTICE))
        cfg = build_cfg(fn.body)
        envs = run_forward(cfg, init, analysis.transfer)
        out = [HOST]

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
    parent_env: Optional[Env] = None,
    shared_flags: Optional[Set[Tuple[int, str]]] = None,
) -> None:
    if fn.name.endswith(_PLAIN_SUFFIX):
        return  # a plain version: outside the rule, nested defs too
    analysis = _DeviceAnalysis(mod, modules, findings, summaries)
    if shared_flags is not None:
        analysis._flagged = shared_flags
    base = Env(LATTICE, dict(parent_env.kinds)) if parent_env else Env(LATTICE)
    init = _param_env(fn, base)
    cfg = build_cfg(fn.body)
    envs = run_forward(cfg, init, analysis.transfer)
    sweep(cfg, envs, init, analysis.transfer, analysis.check)


def _plain_functions(graph) -> Set[Tuple[str, str]]:
    """The plain versions in the call graph: every ``*_reference``
    function, and every function whose callers in the scanned set are all
    plain (the helpers only the plain versions call)."""
    callers: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
    for key, callees in graph.edges.items():
        for callee in callees:
            callers.setdefault(callee, set()).add(key)
    plain = {key for key in graph.edges if key[1].endswith(_PLAIN_SUFFIX)}
    grew = True
    while grew:
        grew = False
        for key in graph.edges:
            if key not in plain and callers.get(key) and callers[key] <= plain:
                plain.add(key)
                grew = True
    return plain


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Run the host-sync pass; returns (findings, sources)."""
    findings: List[Finding] = []
    modules, sources, errors = load_modules(paths)
    for path, exc in errors:
        findings.append(
            Finding("DTX900", Severity.ERROR, path, 0, f"unparsable: {exc}")
        )
    graph = build_call_graph(modules)
    summaries = SummaryTable(default=UNKNOWN, graph=graph)
    plain = _plain_functions(graph)
    for mod in modules.values():
        # module body first (a top-level `_TABLE = torch.arange(8, device=d)` fed
        # into list()/print()/np.asarray is a host sync like any other);
        # def statements are excluded here — every function and method
        # is analyzed separately below, and the device contract gives
        # module globals no flow into them (fresh UNKNOWN-param envs)
        analysis = _DeviceAnalysis(mod, modules, findings, summaries)
        init = Env(LATTICE)
        cfg = build_cfg(
            [s for s in mod.tree.body
             if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef))]
        )
        envs = run_forward(cfg, init, analysis.transfer)
        sweep(cfg, envs, init, analysis.transfer, analysis.check)
        for fn in mod.index.functions.values():
            if (mod.path, fn.name) not in plain:
                _check_function(mod, fn, findings, modules, summaries)
        for cls, table in mod.index.methods.items():
            for fn in table.values():
                _check_function(mod, fn, findings, modules, summaries)
    return findings, sources
