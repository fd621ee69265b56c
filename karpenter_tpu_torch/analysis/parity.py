"""Pass 5: cross-implementation parity drift between the port's kernel twins.

The packing scan exists three times in the port, and the three must stay
bit-exact (tests/test_torch_*.py and chip_smoke.py assert it dynamically,
but only at the shapes they run):

- the plain PyTorch versions ``pack_reference`` and
  ``pack_classed_reference`` (ops/packing.py), with ``PackState`` as the
  carried state — the first of them is the reference twin;
- the CUDA scans: ``csrc/common.cuh`` (the shared constants and
  fits_count), ``csrc/pack_common.cuh`` (the step's phases as device
  functions) and the two kernels ``csrc/pack.cu`` and
  ``csrc/pack_classed.cu``, read as ONE twin;
- the C++ host core ``native/solve_core.cc``.

This pass makes their *structural* agreement a presubmit property: it
builds a "semantic skeleton" from each twin and reports any divergence, so
a cost-model tweak that lands in one twin fails before a parity suite (or
the card-only path the CPU tests skip) notices.

A skeleton has five components:

- **phases**: the ordered tier sequence (min-values -> existing-nodes ->
  open-claims -> fresh-claims -> spread-counters), declared with anchor
  comments in every twin. ``tile-rows``, the tiled mode's row build
  (``tile_feasibility``), is a *mode phase*: the plain versions and the
  CUDA scans have the mode and must both declare it, the host core builds
  the full tables and has no such phase. Mode phases are compared as a
  set, the tiers in order;
- **consts**: the significant shared numeric constants (sentinels like
  ``2**28``/``2**30``, epsilons like ``1e-9``, the proportional-spread
  offset ``0.5``) — derived from the AST on the Python side (literals plus
  module-level constant names like ``_BIGI``, resolved transitively through
  same-module helpers such as ``spread_domain_choice``);
- **dtypes**: the element-type vocabulary (float32/int32/bool), from
  ``torch.<dtype>`` attributes (``torch.long`` and the other aliases land
  on their canonical names) and ``dtype=bool``-style builtins;
- **tiebreaks**: the order-sensitive reduction disciplines in use
  (argmin/argmax/searchsorted/cumsum, as ``torch.*`` calls or tensor
  methods — each encodes a tie-break rule the reference's sequential walk
  implies);
- **state_fields**: the carried-state inventory, pinned to the
  ``PackState`` NamedTuple declaration.

Python skeletons are extracted from parse trees (astutil). The C++ twins
have no parser here, so they *declare* their skeleton with anchor
comments::

    // parity: phase existing-nodes
    // parity: const 2**28
    // parity: dtype float32
    // parity: tiebreak argmin
    // parity: state c_used, c_npods

Rules:

- PAR500: extraction failure (unparsable file, kernel/state class missing,
  a twin with no anchors at all)
- PAR501: phase-sequence drift between twins
- PAR502: shared-constant drift (present in one twin, absent in another)
- PAR503: dtype-literal drift
- PAR504: tie-break discipline drift
- PAR505: state-field inventory drift (a twin missing a declared field, or
  an anchor naming a field with no Python twin — stale after a rename)
- PAR506: malformed or unknown ``parity:`` anchor

Suppress with ``# analysis: ignore[PAR50x] reason`` (Python) or
``// analysis: ignore[PAR50x] reason`` (C++/CUDA) on or above the flagged
line.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .astutil import dotted_name, import_aliases, parse_file
from .findings import Finding, Severity, SourceFile

RULES = {
    "PAR500": "parity skeleton extraction failure",
    "PAR501": "phase-sequence drift between kernel twins",
    "PAR502": "shared-constant drift between kernel twins",
    "PAR503": "dtype-literal drift between kernel twins",
    "PAR504": "tie-break discipline drift between kernel twins",
    "PAR505": "state-field inventory drift between kernel twins",
    "PAR506": "malformed or unknown parity anchor",
}

# ints below this magnitude are structural (axis numbers, small offsets),
# not shared semantic constants; non-integral floats always count
_SIG_INT_MIN = 1024

_TIEBREAK_OPS = ("argmin", "argmax", "searchsorted", "cumsum")
_DTYPE_NAMES = {
    "float16", "bfloat16", "float32", "float64",
    "int8", "int16", "int32", "int64", "uint8", "bool",
}
# torch's other spellings of the same dtypes
_DTYPE_ALIASES = {
    "half": "float16", "float": "float32", "double": "float64",
    "short": "int16", "int": "int32", "long": "int64",
}
_DTYPE_BUILTINS = {"bool", "int", "float"}
# phases of a static mode (not every twin has the mode): compared as a
# set between the twins that have it, never in the tier order
_MODE_PHASES = frozenset({"tile-rows"})

_ANCHOR_RE = re.compile(r"(?:#|//)\s*parity:\s*(.*?)\s*$")
_SLUG_RE = re.compile(r"^[a-z0-9][a-z0-9_-]*$")

# where a skeleton element was first seen: (path, line)
Loc = Tuple[str, int]


@dataclass
class Skeleton:
    """One twin's semantic skeleton. Element maps carry the place each
    element was first seen at, for finding locations (a C++ twin may span
    several files)."""

    name: str
    path: str
    line: int = 0  # kernel def line (python) / first anchor line (C++)
    phases: List[Tuple[str, Loc]] = field(default_factory=list)
    consts: Dict[str, Loc] = field(default_factory=dict)  # canon value -> loc
    dtypes: Dict[str, Loc] = field(default_factory=dict)
    tiebreaks: Dict[str, Loc] = field(default_factory=dict)
    state_fields: Dict[str, Loc] = field(default_factory=dict)

    def phase_slugs(self) -> List[str]:
        """The tier sequence: the phases in order, mode phases left out."""
        return [slug for slug, _ in self.phases if slug not in _MODE_PHASES]

    def mode_phases(self) -> List[str]:
        return sorted({slug for slug, _ in self.phases if slug in _MODE_PHASES})


def _canon_const(value) -> Optional[str]:
    """Canonical comparison key for a numeric constant, or None when the
    value is insignificant (small structural int) or non-finite."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    if isinstance(value, float):
        if value != value or value in (float("inf"), float("-inf")):
            return None
        if value == int(value):  # integral float: same significance rule
            value = int(value)
        else:
            return repr(value)
    if abs(value) < _SIG_INT_MIN:
        return None
    return repr(value)


def _eval_const_expr(node: ast.AST, table: Dict[str, object]):
    """Restricted constant-expression evaluator: literals, +,-,*,**,//, /,
    unary minus, and names resolved through ``table``. Raises ValueError
    on anything else; arithmetic on admissible operands may still raise
    ArithmeticError (``1/0``, ``10.0**400``) — callers catch both."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        if isinstance(node.value, bool):
            raise ValueError("bool")
        return node.value
    if isinstance(node, ast.Name):
        if node.id in table:
            return table[node.id]
        raise ValueError(f"unknown name {node.id!r}")
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval_const_expr(node.operand, table)
    if isinstance(node, ast.BinOp):
        left = _eval_const_expr(node.left, table)
        right = _eval_const_expr(node.right, table)
        if isinstance(node.op, ast.Pow):
            # bound the exponent: `2**2**30` must not hang the analyzer
            if not isinstance(right, (int, float)) or abs(right) > 256:
                raise ValueError("exponent out of range")
            return left ** right
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.FloorDiv):
            return left // right
        if isinstance(node.op, ast.Div):
            return left / right
    raise ValueError(ast.dump(node))


def _module_const_table(tree: ast.Module) -> Dict[str, object]:
    """{name: value} for top-level ``NAME = <const expr>`` assigns."""
    table: Dict[str, object] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        try:
            table[target.id] = _eval_const_expr(node.value, table)
        except (ValueError, ArithmeticError):
            continue
    return table


# ---------------------------------------------------------------------------
# Python-side extraction
# ---------------------------------------------------------------------------


def _transitive_helpers(
    kernel: ast.FunctionDef, functions: Dict[str, ast.FunctionDef]
) -> List[ast.FunctionDef]:
    """The kernel plus every same-module function it (transitively)
    references — shared helpers like spread_domain_choice contribute their
    constants/ops to every caller's skeleton."""
    seen = {kernel.name}
    order = [kernel]
    frontier = [kernel]
    while frontier:
        fn = frontier.pop()
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                if node.id in functions and node.id not in seen:
                    seen.add(node.id)
                    order.append(functions[node.id])
                    frontier.append(functions[node.id])
    return order


def _collect_anchors(
    src: SourceFile, kind: str, start: int, end: int
) -> List[Tuple[str, Loc]]:
    """The arguments of the ``# parity: <kind>`` anchors in [start, end]."""
    out: List[Tuple[str, Loc]] = []
    for i in range(start, min(end, len(src.lines)) + 1):
        m = _ANCHOR_RE.search(src.lines[i - 1])
        if m and m.group(1).startswith(kind):
            parts = m.group(1).split(None, 1)
            if len(parts) == 2:
                out.append((parts[1].strip(), (src.path, i)))
    return out


def _state_class_fields(tree: ast.Module, state_class: str) -> Dict[str, int]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == state_class:
            fields: Dict[str, int] = {}
            for item in node.body:
                if isinstance(item, ast.AnnAssign) and isinstance(
                    item.target, ast.Name
                ):
                    fields[item.target.id] = item.lineno
            return fields
    return {}


def _torch_dtype(node: ast.Attribute, aliases: Dict[str, str]) -> Optional[str]:
    """The canonical dtype a ``torch.<dtype>`` attribute names, or None."""
    name = dotted_name(node)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    full = aliases.get(head, head) + ("." + rest if rest else "")
    module, _, attr = full.rpartition(".")
    if module != "torch":
        return None
    if attr in _DTYPE_NAMES:
        return attr
    return _DTYPE_ALIASES.get(attr)


def _extract_python_skeleton(
    name: str,
    path: str,
    src: SourceFile,
    tree: ast.Module,
    kernel: ast.FunctionDef,
    functions: Dict[str, ast.FunctionDef],
    declared_fields: Dict[str, int],
    aliases: Dict[str, str],
    const_table: Dict[str, object],
) -> Skeleton:
    sk = Skeleton(name=name, path=path, line=kernel.lineno)
    end = getattr(kernel, "end_lineno", kernel.lineno) or kernel.lineno
    sk.phases = _collect_anchors(src, "phase", kernel.lineno, end)
    # a kernel that carries its state in locals, not in a PackState,
    # declares them: ``# parity: state exist_used, c_used``. A declared
    # field counts only where the kernel assigns a local of that name (so
    # a stale declaration is reported as never carried).
    assigned = {
        node.id for node in ast.walk(kernel)
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store)
    }
    for arg, loc in _collect_anchors(src, "state", kernel.lineno, end):
        for fld in (f.strip() for f in arg.split(",")):
            if fld in assigned or (fld and fld not in declared_fields):
                sk.state_fields.setdefault(fld, loc)

    for fn in _transitive_helpers(kernel, functions):
        for node in ast.walk(fn):
            loc = (path, getattr(node, "lineno", 0))
            # consts: literals (incl. 2**30-style expressions) and
            # module-constant names
            if isinstance(node, (ast.Constant, ast.BinOp)):
                try:
                    value = _eval_const_expr(node, const_table)
                except (ValueError, ArithmeticError):
                    value = None
                key = _canon_const(value) if value is not None else None
                if key is not None:
                    sk.consts.setdefault(key, loc)
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                if node.id in const_table:
                    key = _canon_const(const_table[node.id])
                    if key is not None:
                        sk.consts.setdefault(key, loc)
            # dtypes: torch.float32 / dtype=bool style references
            if isinstance(node, ast.Attribute):
                dtype = _torch_dtype(node, aliases)
                if dtype is not None:
                    sk.dtypes.setdefault(dtype, loc)
            if isinstance(node, ast.Call):
                # tie-breaks: torch.argmin(x) and x.argmin() alike
                fname = (
                    node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else getattr(node.func, "id", "")
                )
                if fname in _TIEBREAK_OPS:
                    sk.tiebreaks.setdefault(fname, loc)
                for kw in node.keywords:
                    if (
                        kw.arg == "dtype"
                        and isinstance(kw.value, ast.Name)
                        and kw.value.id in _DTYPE_BUILTINS
                    ):
                        sk.dtypes.setdefault(kw.value.id, loc)
                # state fields: constructor/_replace kwargs
                if fname == "_replace" or fname in ("PackState",):
                    for kw in node.keywords:
                        if kw.arg in declared_fields:
                            sk.state_fields.setdefault(kw.arg, loc)
            # state fields: attribute loads
            if isinstance(node, ast.Attribute) and node.attr in declared_fields:
                sk.state_fields.setdefault(node.attr, loc)
    return sk


# ---------------------------------------------------------------------------
# C++-side extraction (anchor lexer)
# ---------------------------------------------------------------------------


def extract_cc_skeleton(
    paths, name: str = "native"
) -> Tuple[Skeleton, List[Finding], Dict[str, SourceFile]]:
    """Lex ``// parity:`` anchors out of one C++ twin: a source path, or
    several read in order as one twin. Malformed anchors become PAR506
    findings, never crashes. Raises OSError on an unreadable file."""
    if isinstance(paths, str):
        paths = [paths]
    sk = Skeleton(name=name, path=paths[0])
    findings: List[Finding] = []
    sources: Dict[str, SourceFile] = {}

    for path in paths:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        src = sources[path] = SourceFile(path=path, text=text)

        def malformed(lineno: int, why: str) -> None:
            findings.append(
                Finding(
                    "PAR506", Severity.ERROR, path, lineno,
                    f"malformed parity anchor ({why}); expected "
                    "'// parity: phase|const|dtype|tiebreak|state <arg>'",
                )
            )

        for i, line in enumerate(src.lines, start=1):
            m = _ANCHOR_RE.search(line)
            if not m:
                continue
            loc = (path, i)
            if sk.line == 0:
                sk.path, sk.line = loc
            body = m.group(1)
            parts = body.split(None, 1)
            if not parts:
                malformed(i, "empty anchor")
                continue
            kind = parts[0]
            arg = parts[1].strip() if len(parts) > 1 else ""
            if not arg:
                malformed(i, f"'{kind}' anchor has no argument")
                continue
            if kind == "phase":
                if not _SLUG_RE.match(arg):
                    malformed(i, f"phase slug {arg!r} is not a slug")
                    continue
                sk.phases.append((arg, loc))
            elif kind == "const":
                try:
                    # optional "name =" prefix: `const kBigDom = 2**28`
                    expr = arg.rpartition("=")[2].strip() if "=" in arg else arg
                    value = _eval_const_expr(
                        ast.parse(expr, mode="eval").body, {}
                    )
                except (ValueError, SyntaxError, ArithmeticError):
                    # ZeroDivisionError/OverflowError from `1/0`, `10.0**400`
                    malformed(i, f"unevaluable const expression {arg!r}")
                    continue
                key = _canon_const(value)
                if key is None:
                    malformed(i, f"const {arg!r} is not a significant constant")
                    continue
                sk.consts.setdefault(key, loc)
            elif kind == "dtype":
                sk.dtypes.setdefault(arg.rstrip("_"), loc)
            elif kind == "tiebreak":
                if not _SLUG_RE.match(arg):
                    malformed(i, f"tiebreak slug {arg!r} is not a slug")
                    continue
                sk.tiebreaks.setdefault(arg, loc)
            elif kind == "state":
                for fld in (f.strip() for f in arg.split(",")):
                    if not fld:
                        continue
                    if not _SLUG_RE.match(fld):
                        malformed(i, f"state field {fld!r} is not an identifier")
                        continue
                    sk.state_fields.setdefault(fld, loc)
            else:
                malformed(i, f"unknown anchor kind {kind!r}")
    return sk, findings, sources


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def _compare(
    ref: Skeleton, other: Skeleton, findings: List[Finding],
    modes: bool = True,
) -> None:
    """Report every divergence of ``other`` from ``ref``; with ``modes``
    the two twins share the static modes, so their mode phases must agree
    too."""
    first = other.phases[0][1] if other.phases else (other.path, other.line)
    if ref.phase_slugs() != other.phase_slugs():
        findings.append(
            Finding(
                "PAR501", Severity.ERROR, first[0], first[1],
                f"phase sequence drift: {ref.name}="
                f"{ref.phase_slugs()} vs {other.name}={other.phase_slugs()}",
            )
        )
    if modes and ref.mode_phases() != other.mode_phases():
        findings.append(
            Finding(
                "PAR501", Severity.ERROR, first[0], first[1],
                f"mode phase drift: {ref.name}={ref.mode_phases()} vs "
                f"{other.name}={other.mode_phases()}",
            )
        )
    for label, rule in (
        ("consts", "PAR502"), ("dtypes", "PAR503"), ("tiebreaks", "PAR504")
    ):
        ref_map: Dict[str, Loc] = getattr(ref, label)
        other_map: Dict[str, Loc] = getattr(other, label)
        noun = label.rstrip("s").replace("const", "constant")
        for key in sorted(set(ref_map) - set(other_map)):
            findings.append(
                Finding(
                    rule, Severity.ERROR, other.path, other.line,
                    f"{noun} {key} present in {ref.name} but absent from "
                    f"{other.name} — a change may have landed in only one "
                    "twin",
                )
            )
        for key in sorted(set(other_map) - set(ref_map)):
            path, line = other_map[key]
            findings.append(
                Finding(
                    rule, Severity.ERROR, path, line,
                    f"{noun} {key} in {other.name} has no twin in "
                    f"{ref.name}",
                )
            )


def _check_state_fields(
    sk: Skeleton, declared: Dict[str, int], declared_path: str,
    findings: List[Finding],
) -> None:
    for fld in sorted(set(declared) - set(sk.state_fields)):
        findings.append(
            Finding(
                "PAR505", Severity.ERROR, sk.path, sk.line,
                f"state field '{fld}' declared by PackState is never "
                f"carried by {sk.name}",
            )
        )
    for fld in sorted(set(sk.state_fields) - set(declared)):
        path, line = sk.state_fields[fld]
        findings.append(
            Finding(
                "PAR505", Severity.ERROR, path, line,
                f"state field '{fld}' in {sk.name} has no PackState twin "
                f"in {declared_path} (stale after a rename?)",
            )
        )


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def _cc_twin(
    paths: Sequence[str], name: str, findings: List[Finding],
    sources: Dict[str, SourceFile],
) -> Optional[Skeleton]:
    """One C++ twin's skeleton, or None (with a PAR500) when a file is
    unreadable or the twin declares no anchors."""
    try:
        sk, cc_findings, cc_sources = extract_cc_skeleton(paths, name)
    except OSError as exc:
        findings.append(
            Finding(
                "PAR500", Severity.ERROR, getattr(exc, "filename", None)
                or paths[0], 0, f"unreadable: {exc}",
            )
        )
        return None
    sources.update(cc_sources)
    findings.extend(cc_findings)
    if sk.line == 0:
        findings.append(
            Finding(
                "PAR500", Severity.ERROR, paths[0], 0,
                f"no '// parity:' anchors found — the {name} twin "
                "declares no skeleton",
            )
        )
        return None
    return sk


def check_parity(
    py_path: str,
    cc_path: str,
    cuda_paths: Sequence[str] = (),
    kernels: Sequence[str] = ("pack_reference", "pack_classed_reference"),
    state_class: str = "PackState",
) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Extract one skeleton per twin and report every divergence. The first
    kernel name is the reference twin the others are compared against:
    the other Python kernels, the CUDA twin (``cuda_paths``, read as one;
    it has the static modes) and the host core ``cc_path`` (compared on
    the tiers only: it has no tiled mode)."""
    findings: List[Finding] = []
    sources: Dict[str, SourceFile] = {}

    try:
        src, tree = parse_file(py_path)
    except (OSError, SyntaxError) as exc:
        return (
            [Finding("PAR500", Severity.ERROR, py_path, 0, f"unparsable: {exc}")],
            sources,
        )
    sources[py_path] = src
    aliases = import_aliases(tree)
    const_table = _module_const_table(tree)
    functions = {
        n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
    }
    declared = _state_class_fields(tree, state_class)
    if not declared:
        findings.append(
            Finding(
                "PAR500", Severity.ERROR, py_path, 0,
                f"state class {state_class!r} not found — cannot build the "
                "state-field inventory",
            )
        )

    skeletons: List[Skeleton] = []
    for kname in kernels:
        fn = functions.get(kname)
        if fn is None:
            findings.append(
                Finding(
                    "PAR500", Severity.ERROR, py_path, 0,
                    f"kernel {kname!r} not found in {py_path}",
                )
            )
            continue
        sk = _extract_python_skeleton(
            kname, py_path, src, tree, fn, functions, declared, aliases,
            const_table,
        )
        if not sk.phases:
            findings.append(
                Finding(
                    "PAR500", Severity.ERROR, py_path, fn.lineno,
                    f"kernel {kname!r} declares no '# parity: phase' "
                    "anchors — the phase sequence cannot be compared",
                )
            )
        skeletons.append(sk)

    twins = [(_cc_twin([cc_path], "native", findings, sources), False)]
    if cuda_paths:
        twins.append(
            (_cc_twin(list(cuda_paths), "cuda", findings, sources), True)
        )
    twins = [(sk, modes) for sk, modes in twins if sk is not None]

    if skeletons:
        ref = skeletons[0]
        for other in skeletons[1:]:
            _compare(ref, other, findings)
        for sk, modes in twins:
            _compare(ref, sk, findings, modes=modes)
    if declared:
        for sk in skeletons + [sk for sk, _ in twins]:
            _check_state_fields(sk, declared, py_path, findings)
    return findings, sources
