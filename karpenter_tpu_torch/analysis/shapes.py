# Copied from karpenter_tpu/analysis/shapes.py, its abstract values, the right-aligned join and the "unknown never fires" discipline; the bindings, the propagation and the mesh sinks are retargeted to torch and the port's parallel/mesh.py.
"""Pass 6: axis/dtype abstract interpretation over the port's device code
(ops/, solver/, parallel/).

The kernels' plain versions and their wrappers are index arithmetic over
named axes — S (scenarios), P (templates), G (groups), N (nodes), R
(resources), T (types), K (requirement keys), V1 (interned values), L
(live pairs), nmax (claim slots) — but torch tensors carry none of those
names: a ``[N, R] * [R, N]`` join broadcasts happily and miscomputes
silently. This pass walks every function with a tiny abstract
interpreter:

- **bindings** get an abstract value (axes, dtype): at the ``torch``
  constructors (``torch.zeros((n, r), dtype=torch.float32)``, the shape
  as a tuple, as int varargs or as ``size=``; ``dtype=`` is read,
  ``device=`` ignored), at ``torch.*_like`` and ``Tensor.new_*``, and at
  ``.shape`` unpacking: ``P, G = p_tol.shape`` names ``p_tol``'s axes P
  and G (or, where they are known already, makes P and G their aliases);
  axis identity is taken from the local *names*;
- **propagation** runs through operators and elementwise ``torch`` calls
  (broadcast joins, aligned from the right; ``torch.where`` among them),
  indexing (``[:, None]``, ``...``, integer drops, 1-D gathers),
  ``.unsqueeze`` / ``.view`` / ``.reshape`` / ``.t()`` / ``.T`` /
  ``.transpose`` / ``.permute`` / ``.expand``, reductions with ``dim=``
  (``keepdim`` included), ``.to(dtype)`` / ``.int()`` / ``.bool()`` /
  ``.long()`` and the like, ``torch.einsum`` specs (each letter must bind
  one axis name), ``@`` and ``index_add_`` (JAX's ``segment_sum``);
  anything else degrades to *unknown*, never to a guess — an index the
  walker does not know is not taken for a scalar;
- **checks** fire only when both sides of a fact are known, so unknown
  values can never false-positive. A constructor without ``dtype=`` has
  torch's default dtype, which the walker does not assume.

Rules:

- SHP600: unparsable file
- SHP601: axis-order mismatch — a broadcast join aligns two *different*
  named axes (or an einsum letter binds two different axes, a matmul
  contracts two, an ``index_add_`` index rides another axis than the
  source's indexed one)
- SHP602: 64-bit widening — an explicit ``torch.float64`` / ``double`` /
  ``int64`` / ``long`` in device code (a dtype argument, ``.to``,
  ``.long()``, ``.double()``) or a join of a 32-bit and a 64-bit operand.
  The int64 index tensors torch's indexing ops require are sanctioned at
  their line (``# analysis: sanctioned[SHP602] reason``), not exempted
  here
- SHP603: a literal dimension that is not a power of two, at a
  constructor or a ``.reshape`` / ``.view`` of a tracked tensor: the
  residency store reuses a device buffer only at the same shape
  (solver/residency.py), so every such size is a new buffer
- SHP604: a partition spec of the mesh (parallel/mesh.py: ``spec_of``,
  ``ARG_SPECS`` or a tuple of its axis names) reaches, at the sinks
  ``place(name, x, mesh)`` and ``cut(x, key, spec, dims)``, an array axis
  whose literal dimension is not a power of two — after the encoder's
  pow2 padding every sharded axis IS a pow2 >= the (pow2) mesh axis it
  divides; a non-pow2 dim there skipped ``pad_args_for_mesh`` and cannot
  divide the mesh axis. (``placements(spec, mesh)`` places no array: the
  spec it is given meets the array at ``cut``.)

Host-side numpy is out of scope on purpose: only ``torch`` origins and
tensors the walker tracks construct values, so encode-time ``np.int64``
index math stays silent.
"""

from __future__ import annotations

import ast
import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .astutil import call_name, dotted_name, import_aliases, iter_py_files, parse_file
from .findings import Finding, Severity, SourceFile

RULES = {
    "SHP600": "unparsable file (shape pass)",
    "SHP601": "axis-order mismatch in a broadcast join",
    "SHP602": "silent 64-bit dtype widening in device code",
    "SHP603": "literal dimension bypasses the power-of-two bucket ladder",
    "SHP604": "sharded axis dimension is not shard-divisible after pow2 padding",
}

# axes: tuple of str (named axis) | int (literal dim) | None (unknown dim);
# axes itself None = unknown rank. dtype: canonical string or None.
Axes = Optional[Tuple[object, ...]]


@dataclass(frozen=True)
class AV:
    axes: Axes = None
    dtype: Optional[str] = None


UNKNOWN = AV()
SCALAR = AV(axes=())

_CONSTRUCTORS = {"zeros", "ones", "empty", "full", "arange"}
_LIKE_CONSTRUCTORS = {"zeros_like", "ones_like", "full_like", "empty_like"}
_NEW_CONSTRUCTORS = {"new_zeros", "new_ones", "new_empty", "new_full"}
_ELEMENTWISE = {
    "where", "maximum", "minimum", "clamp", "clip", "add", "sub", "subtract",
    "mul", "multiply", "div", "divide", "floor_divide", "remainder", "fmod",
    "pow", "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "abs", "sign",
    "floor", "ceil", "round", "trunc", "exp", "log", "sqrt", "isinf", "isnan",
    "isfinite", "eq", "ne", "gt", "ge", "lt", "le", "neg", "negative",
}
_BOOL_RESULT = {
    "isinf", "isnan", "isfinite", "logical_and", "logical_or", "logical_xor",
    "logical_not", "eq", "ne", "gt", "ge", "lt", "le",
}
# methods that keep the receiver's axes and dtype
_SAME_METHODS = {
    "clone", "contiguous", "detach", "abs", "floor", "ceil", "neg", "sign",
    "logical_not", "bitwise_not", "clamp", "clamp_min", "clamp_max", "clip",
    "cumsum", "cumprod", "flip", "cpu", "cuda",
}
_REDUCTIONS = {
    "sum", "amin", "amax", "mean", "prod", "any", "all", "argmin", "argmax",
    "count_nonzero", "nansum",
}
# dtype spellings: torch attribute -> canonical name
_TORCH_DTYPES = {
    "float16": "float16", "half": "float16", "bfloat16": "bfloat16",
    "float32": "float32", "float": "float32", "float64": "float64",
    "double": "float64", "int8": "int8", "uint8": "uint8", "int16": "int16",
    "short": "int16", "int32": "int32", "int": "int32", "int64": "int64",
    "long": "int64", "uint32": "uint32", "uint64": "uint64", "bool": "bool",
    "complex64": "complex64", "complex128": "complex128", "cdouble": "complex128",
}
# the casting methods: method -> canonical dtype
_CAST_METHODS = {
    "int": "int32", "long": "int64", "bool": "bool", "float": "float32",
    "double": "float64", "half": "float16", "short": "int16", "byte": "uint8",
}
_DTYPE_64 = {"float64", "int64", "uint64", "complex128"}
_WIDTH_PAIRS = {("float32", "float64"), ("int32", "int64")}
_MESH_AXES = {"scenario", "data", "model"}
_MESH_AXIS_NAMES = {"AXIS_SCENARIO": "scenario", "AXIS_DATA": "data", "AXIS_MODEL": "model"}


def _is_pow2(v: int) -> bool:
    return v >= 0 and (v & (v - 1)) == 0  # 0 and 1 count as bucketed


@functools.lru_cache(maxsize=None)
def mesh_arg_specs() -> Dict[str, Tuple[Optional[str], ...]]:
    """The port's ``parallel/mesh.py:ARG_SPECS``, read from its source (the
    pass imports nothing it analyzes): argument name -> partition tuple."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "parallel", "mesh.py")
    try:
        _, tree = parse_file(path)
    except (OSError, SyntaxError):
        return {}
    for node in tree.body:
        target = node.target if isinstance(node, ast.AnnAssign) else (
            node.targets[0] if isinstance(node, ast.Assign) and len(node.targets) == 1 else None)
        if isinstance(target, ast.Name) and target.id == "ARG_SPECS" and isinstance(
                node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                spec = _literal_spec(v)
                if isinstance(k, ast.Constant) and isinstance(k.value, str) and spec is not None:
                    out[k.value] = spec
            return out
    return {}


def _literal_spec(node: ast.AST) -> Optional[Tuple[Optional[str], ...]]:
    """A partition tuple written out: each entry a mesh axis (its name as a
    string or as parallel/mesh.py's AXIS_* constant) or None; else None."""
    if not isinstance(node, ast.Tuple):
        return None
    out: List[Optional[str]] = []
    for e in node.elts:
        if isinstance(e, ast.Constant) and e.value is None:
            out.append(None)
        elif isinstance(e, ast.Constant) and e.value in _MESH_AXES:
            out.append(e.value)
        elif isinstance(e, ast.Name) and e.id in _MESH_AXIS_NAMES:
            out.append(_MESH_AXIS_NAMES[e.id])
        else:
            return None
    return tuple(out)


def _mesh_callee(cname: str, tail: str) -> bool:
    """Is ``cname`` parallel/mesh.py's function ``tail``: called bare (its
    own module) or through an import of the mesh module?"""
    return cname == tail or (cname.endswith("." + tail) and (
        ".mesh." in cname or cname.startswith("mesh.")))


def _int_of(node: Optional[ast.AST]) -> Optional[int]:
    """An int literal, negative ones included; else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) and not isinstance(
            node.value, bool):
        return node.value
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)
            and isinstance(node.operand.value, int)):
        return -node.operand.value
    return None


class _Env:
    def __init__(self, parent: Optional["_Env"] = None):
        self.parent = parent
        self.vals: Dict[str, AV] = {}
        # axis aliases: a name bound by ``.shape`` unpacking -> the axis it
        # names (another name or a literal dim)
        self.aliases: Dict[str, object] = {}

    def get(self, name: str) -> AV:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.vals:
                return env.vals[name]
            env = env.parent
        return UNKNOWN

    def set(self, name: str, av: AV) -> None:
        self.vals[name] = av

    def axis(self, name: str) -> object:
        env: Optional[_Env] = self
        while env is not None:
            if name in env.aliases:
                return env.aliases[name]
            if name in env.vals:
                return name
            env = env.parent
        return name

    def forget(self, name: str) -> None:
        self.vals[name] = UNKNOWN
        self.aliases.pop(name, None)


def _join_axes(a: Axes, b: Axes) -> Tuple[Axes, Optional[Tuple[object, object]]]:
    """Right-aligned broadcast join. Returns (joined, conflict) where
    conflict is the first (dim_a, dim_b) pair of *known, unequal, non-1*
    dims, or None. An unknown-rank operand poisons the join to unknown:
    keeping the known side would manufacture facts about values the
    interpreter lost track of (the false-positive mode this pass must
    never have)."""
    if a is None or b is None:
        return None, None
    out: List[object] = []
    conflict = None
    la, lb = len(a), len(b)
    for i in range(1, max(la, lb) + 1):
        da = a[-i] if i <= la else 1
        db = b[-i] if i <= lb else 1
        if da == 1:
            out.append(db)
        elif db == 1:
            out.append(da)
        elif da is None:
            out.append(db)
        elif db is None:
            out.append(da)
        elif da == db:
            out.append(da)
        else:
            both_named = isinstance(da, str) and isinstance(db, str)
            both_lits = isinstance(da, int) and isinstance(db, int)
            if (both_named or both_lits) and conflict is None:
                conflict = (da, db)
            out.append(None)
    return tuple(reversed(out)), conflict


def _assigned_names(stmt: ast.AST) -> set:
    """Names the statement may bind, without descending into nested
    scopes (defs/lambdas/classes bind in their own frame). Deliberately
    over-approximate — degrading an extra name to unknown is sound."""
    out = set()
    stack = [stmt]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
            out.add(n.id)
        stack.extend(ast.iter_child_nodes(n))
    return out


def _matmul_axes(
    a: Axes, b: Axes
) -> Tuple[Axes, Optional[Tuple[object, object]]]:
    """``a @ b`` contraction: a's last axis against b's second-to-last
    (or only, for 1-D b). Returns (result_axes, conflict) — conflict is
    the contracted pair when both dims are known and unequal. Batched
    (rank>2 both sides) results degrade to unknown rather than modelling
    the batch-dim broadcast."""
    if a is None or b is None or len(a) == 0 or len(b) == 0:
        return None, None
    ca = a[-1]
    cb = b[-2] if len(b) >= 2 else b[-1]
    conflict = None
    both_named = isinstance(ca, str) and isinstance(cb, str)
    both_lits = isinstance(ca, int) and isinstance(cb, int)
    if (both_named or both_lits) and ca != cb:
        conflict = (ca, cb)
    if len(b) == 1:
        return a[:-1], conflict
    if len(a) == 1:
        return b[:-2] + (b[-1],), conflict
    if len(a) == 2 and len(b) == 2:
        return (a[0], b[-1]), conflict
    return None, conflict


def _join_dtype(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a is None or b is None or a == b:
        return a if a == b else None
    if (a, b) in _WIDTH_PAIRS or (b, a) in _WIDTH_PAIRS:
        return a if a in _DTYPE_64 else b
    return None


def _dim_index(node: Optional[ast.AST], rank: int) -> Optional[int]:
    """A literal dim index, normalized into [0, rank); else None."""
    v = _int_of(node)
    if v is None or not -rank <= v < rank:
        return None
    return v % rank


class _FunctionChecker(ast.NodeVisitor):
    def __init__(
        self,
        path: str,
        aliases: Dict[str, str],
        findings: List[Finding],
        env: _Env,
    ):
        self.path = path
        self.aliases = aliases
        self.findings = findings
        self.env = env
        self._flagged: set = set()
        # names bound to mesh partition specs in this frame: name ->
        # partition tuple (mesh-axis str | None per dim)
        self._specs: Dict[str, Tuple[Optional[str], ...]] = {}
        # names bound to a torch dtype (``i64 = torch.int64``)
        self._dtypes: Dict[str, str] = {}

    # -- reporting --------------------------------------------------------

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if (line, rule) in self._flagged:
            return
        self._flagged.add((line, rule))
        self.findings.append(
            Finding(rule, Severity.ERROR, self.path, line, message)
        )

    def _conflict(self, node: ast.AST, conflict, what: str = "broadcast join aligns") -> None:
        if conflict is not None:
            self._flag(
                "SHP601", node,
                f"{what} axis '{conflict[0]}' with axis '{conflict[1]}' — "
                "operands look transposed",
            )

    # -- name resolution --------------------------------------------------

    def _is_torch(self, cname: str) -> bool:
        return cname.startswith("torch.") and not cname.startswith("torch.cuda.")

    def _dtype_of_node(self, node: Optional[ast.AST]) -> Optional[str]:
        """The canonical dtype a torch dtype expression names, or None."""
        if node is None:
            return None
        if isinstance(node, ast.Name):
            return self._dtypes.get(node.id)
        if isinstance(node, ast.Attribute) and node.attr in _TORCH_DTYPES:
            dn = dotted_name(node) or ""
            head = dn.partition(".")[0]
            if self.aliases.get(head, head) == "torch" and dn.count(".") == 1:
                return _TORCH_DTYPES[node.attr]
        return None

    def _axis_of_dim(self, node: ast.AST) -> object:
        if isinstance(node, ast.Name):
            return self.env.axis(node.id)
        v = _int_of(node)
        if v is not None and v >= 0:
            return v
        return None

    def _shape_of_args(self, args: List[ast.AST], kw: Dict[str, ast.AST]) -> Axes:
        """A constructor's shape: ``size=``, one tuple/list, or int varargs."""
        if "size" in kw:
            return self._shape_axes(kw["size"])
        if len(args) == 1:
            return self._shape_axes(args[0])
        if args and not any(isinstance(a, ast.Starred) for a in args):
            return tuple(self._axis_of_dim(a) for a in args)
        return None

    def _shape_nodes(self, args: List[ast.AST], kw: Dict[str, ast.AST]) -> List[ast.AST]:
        """The dim expressions of a constructor's shape, for SHP603."""
        if "size" in kw:
            node = kw["size"]
        elif len(args) == 1:
            node = args[0]
        else:
            return list(args)
        return list(node.elts) if isinstance(node, (ast.Tuple, ast.List)) else [node]

    def _shape_axes(self, node: ast.AST) -> Axes:
        if isinstance(node, (ast.Tuple, ast.List)):
            if any(isinstance(e, ast.Starred) for e in node.elts):
                return None
            return tuple(self._axis_of_dim(e) for e in node.elts)
        if isinstance(node, ast.Name) and self.env.get(node.id) != UNKNOWN:
            return None  # a tensor or a tracked value, not a dim
        dim = self._axis_of_dim(node)
        return (dim,) if dim is not None else None

    # -- abstract evaluation ----------------------------------------------

    def avof(self, node: ast.AST) -> AV:
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float, bool)):
                return SCALAR
            return UNKNOWN
        if isinstance(node, ast.BinOp):
            a, b = self.avof(node.left), self.avof(node.right)
            if isinstance(node.op, ast.MatMult):
                axes, _ = _matmul_axes(a.axes, b.axes)
            else:
                axes, _ = _join_axes(a.axes, b.axes)
            return AV(axes, _join_dtype(a.dtype, b.dtype))
        if isinstance(node, ast.UnaryOp):
            av = self.avof(node.operand)
            return AV(av.axes, "bool") if isinstance(node.op, ast.Not) else av
        if isinstance(node, ast.Compare):
            avs = [self.avof(node.left)] + [self.avof(c) for c in node.comparators]
            axes = avs[0].axes
            for av in avs[1:]:
                axes, _ = _join_axes(axes, av.axes)
            return AV(axes, "bool")
        if isinstance(node, ast.BoolOp):
            return UNKNOWN
        if isinstance(node, ast.IfExp):
            a, b = self.avof(node.body), self.avof(node.orelse)
            return a if a == b else UNKNOWN
        if isinstance(node, ast.Call):
            return self._call_av(node)
        if isinstance(node, ast.Attribute):
            base = self.avof(node.value)
            if node.attr in ("T", "mT") and base.axes is not None and (
                    node.attr == "mT" or len(base.axes) <= 2):
                axes = base.axes
                return AV(axes[:-2] + (axes[-1], axes[-2]) if len(axes) >= 2 else axes,
                          base.dtype)
            return UNKNOWN
        if isinstance(node, ast.Subscript):
            return self._subscript_av(node)
        return UNKNOWN

    def _spec_of(self, node: Optional[ast.AST]) -> Optional[Tuple[Optional[str], ...]]:
        """The partition tuple ``node`` denotes, or None when it is not a
        statically-known mesh spec: a tuple of mesh axes,
        ``spec_of("name"[, stacked])``, ``ARG_SPECS["name"]`` or a name
        bound to one of these. The pass never guesses."""
        if node is None:
            return None
        if isinstance(node, ast.Name):
            return self._specs.get(node.id)
        literal = _literal_spec(node)
        if literal is not None:
            return literal
        if isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant):
            base = dotted_name(node.value) or ""
            if base.rpartition(".")[2] == "ARG_SPECS":
                return mesh_arg_specs().get(node.slice.value)
            return None
        if isinstance(node, ast.Call):
            cname = call_name(node, self.aliases)
            if _mesh_callee(cname, "spec_of") and node.args:
                return self._named_spec(node.args[0], node.args[1:2] + [
                    k.value for k in node.keywords if k.arg == "stacked"])
        return None

    def _named_spec(self, name_node: ast.AST, stacked: List[ast.AST]):
        """ARG_SPECS[name], with the leading scenario axis when ``stacked``
        is the literal True (None when the name or the flag is unknown)."""
        if not (isinstance(name_node, ast.Constant) and isinstance(name_node.value, str)):
            return None
        spec = mesh_arg_specs().get(name_node.value)
        if spec is None:
            return None
        if not stacked or (isinstance(stacked[0], ast.Constant) and stacked[0].value is False):
            return spec
        if isinstance(stacked[0], ast.Constant) and stacked[0].value is True:
            return ("scenario",) + spec
        return None

    def _check_shard_divisible(self, node: ast.Call, arr_node: ast.AST, spec, sink: str) -> None:
        """SHP604 at the array-meets-spec sinks: every partitioned spec
        entry must sit over a pow2 (or unknown/named) array dim."""
        arr = self.avof(arr_node)
        if not spec or arr.axes is None:
            return
        for i, entry in enumerate(spec):
            if entry is None or i >= len(arr.axes):
                continue
            dim = arr.axes[i]
            if (
                isinstance(dim, int)
                and not isinstance(dim, bool)
                and dim > 1
                and not _is_pow2(dim)
            ):
                self._flag(
                    "SHP604", node,
                    f"{sink} partitions axis {i} (dim {dim}) over mesh"
                    f" axis '{entry}', but {dim} is not a power of two —"
                    " the buffer skipped the pow2 shard padding"
                    " (parallel.mesh.pad_args_for_mesh) and cannot divide"
                    " the mesh axis",
                )

    def _call_av(self, node: ast.Call) -> AV:
        cname = call_name(node, self.aliases)
        tail = cname.rpartition(".")[2]
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        if not self._is_torch(cname):
            if isinstance(node.func, ast.Attribute):
                return self._method_av(node, kw)
            return UNKNOWN
        if tail in _CONSTRUCTORS:
            dtype = self._dtype_of_node(kw.get("dtype"))
            if tail == "arange":
                if len(node.args) == 1:
                    return AV((self._axis_of_dim(node.args[0]),), dtype)
                return AV(None, dtype)
            args = node.args[:1] if tail == "full" else node.args
            return AV(self._shape_of_args(args, kw), dtype)
        if tail in _LIKE_CONSTRUCTORS and node.args:
            base = self.avof(node.args[0])
            dtype = self._dtype_of_node(kw["dtype"]) if "dtype" in kw else base.dtype
            return AV(base.axes, dtype)
        if tail in ("tensor", "as_tensor", "asarray"):
            dtype_node = kw.get("dtype")
            if dtype_node is None and tail == "as_tensor" and len(node.args) > 1:
                dtype_node = node.args[1]
            return AV(None, self._dtype_of_node(dtype_node))
        if tail == "one_hot":
            base = self.avof(node.args[0]) if node.args else UNKNOWN
            dim = self._axis_of_dim(node.args[1]) if len(node.args) > 1 else None
            return AV(base.axes + (dim,) if base.axes is not None else None, None)
        if tail in _ELEMENTWISE:
            axes: Axes = ()
            dtypes = []
            for i, arg in enumerate(node.args):
                av = self.avof(arg)
                axes, _ = _join_axes(axes, av.axes)
                if not (tail == "where" and i == 0):  # where's condition
                    dtypes.append(av.dtype)
            dtype = dtypes[0] if dtypes else None
            for d in dtypes[1:]:
                dtype = _join_dtype(dtype, d)
            if tail in _BOOL_RESULT:
                dtype = "bool"
            return AV(axes, dtype)
        if tail in _REDUCTIONS and node.args:
            return self._reduce_av(tail, self.avof(node.args[0]), node.args[1:], kw)
        if tail == "einsum":
            return self._einsum_av(node)
        if tail == "matmul" and len(node.args) == 2:
            a, b = self.avof(node.args[0]), self.avof(node.args[1])
            return AV(_matmul_axes(a.axes, b.axes)[0], _join_dtype(a.dtype, b.dtype))
        if tail == "gather" and len(node.args) >= 3:
            return AV(self.avof(node.args[2]).axes, self.avof(node.args[0]).dtype)
        return UNKNOWN

    def _reduce_av(self, tail: str, base: AV, args: List[ast.AST], kw) -> AV:
        """A reduction over ``dim`` (positional or ``dim=``), with
        ``keepdim``; no dim reduces everything."""
        dtype = (
            None if tail in ("argmin", "argmax", "count_nonzero")
            else ("bool" if tail in ("any", "all") else base.dtype)
        )
        if "dtype" in kw:
            dtype = self._dtype_of_node(kw["dtype"])
        dim_node = kw.get("dim", args[0] if args else None)
        keep = kw.get("keepdim", args[1] if len(args) > 1 else None)
        if keep is not None and not (isinstance(keep, ast.Constant)
                                     and isinstance(keep.value, bool)):
            return AV(None, dtype)
        keep = keep is not None and keep.value
        if dim_node is None:
            if keep or base.axes is None:
                return AV(None, dtype)
            return AV((), dtype)
        if base.axes is None:
            return AV(None, dtype)
        cands = dim_node.elts if isinstance(dim_node, (ast.Tuple, ast.List)) else [dim_node]
        drops = set()
        for c in cands:
            d = _dim_index(c, len(base.axes))
            if d is None:
                return AV(None, dtype)
            drops.add(d)
        return AV(tuple(1 if i in drops else ax for i, ax in enumerate(base.axes)
                        if keep or i not in drops), dtype)

    def _method_av(self, node: ast.Call, kw) -> AV:
        attr = node.func.attr  # type: ignore[union-attr]
        base = self.avof(node.func.value)  # type: ignore[union-attr]
        args = node.args
        if attr in _CAST_METHODS and not args:
            return AV(base.axes, _CAST_METHODS[attr])
        if attr == "to":
            dtypes = [self._dtype_of_node(a) for a in args] + [self._dtype_of_node(
                kw.get("dtype"))]
            dtype = next((d for d in dtypes if d is not None), None)
            if dtype is None and ("dtype" in kw or any(
                    isinstance(a, ast.Name) and a.id not in self._dtypes for a in args)):
                return AV(base.axes, None)  # a dtype the walker cannot read
            return AV(base.axes, dtype or base.dtype)
        if attr == "type" and args:
            return AV(base.axes, self._dtype_of_node(args[0]))
        if attr in _SAME_METHODS:
            return base
        if attr in _NEW_CONSTRUCTORS:
            dtype = self._dtype_of_node(kw["dtype"]) if "dtype" in kw else base.dtype
            return AV(self._shape_of_args(args[:1] if attr == "new_full" else args, kw),
                      dtype)
        # the sizes given are the result's, whatever the receiver (a -1
        # keeps or infers a dim: unknown unless expand keeps a known one)
        if attr in ("reshape", "view"):
            if len(args) == 1 and self._dtype_of_node(args[0]) is not None:
                return UNKNOWN  # a view as another dtype
            if len(args) == 1 and isinstance(args[0], (ast.Tuple, ast.List)):
                return AV(self._shape_axes(args[0]), base.dtype)
            if args and not any(isinstance(a, ast.Starred) for a in args):
                return AV(tuple(self._axis_of_dim(a) for a in args), base.dtype)
            return UNKNOWN
        if attr == "expand" and args:
            sizes = args[0].elts if len(args) == 1 and isinstance(
                args[0], (ast.Tuple, ast.List)) else args
            if any(isinstance(x, ast.Starred) for x in sizes) or (
                    base.axes is not None and len(sizes) < len(base.axes)):
                return UNKNOWN
            out = []
            for i, x in enumerate(sizes):
                j = i - (len(sizes) - len(base.axes or ()))
                keep = _int_of(x) == -1 and base.axes is not None and j >= 0
                out.append(base.axes[j] if keep else self._axis_of_dim(x))
            return AV(tuple(out), base.dtype)
        if base.axes is None and attr not in _REDUCTIONS and attr not in (
                "index_add_", "index_add"):
            return UNKNOWN
        axes = base.axes
        if attr == "unsqueeze" and args:
            d = _dim_index(args[0], len(axes) + 1)
            return AV(axes[:d] + (1,) + axes[d:], base.dtype) if d is not None else UNKNOWN
        if attr == "t" and not args and len(axes) <= 2:
            return AV(tuple(reversed(axes)), base.dtype)
        if attr in ("transpose", "swapaxes") and len(args) == 2:
            i, j = _dim_index(args[0], len(axes)), _dim_index(args[1], len(axes))
            if i is None or j is None:
                return UNKNOWN
            out = list(axes)
            out[i], out[j] = out[j], out[i]
            return AV(tuple(out), base.dtype)
        if attr == "permute" and args:
            dims = args[0].elts if len(args) == 1 and isinstance(
                args[0], (ast.Tuple, ast.List)) else args
            order = [_dim_index(d, len(axes)) for d in dims]
            if len(order) != len(axes) or None in order or len(set(order)) != len(order):
                return UNKNOWN
            return AV(tuple(axes[i] for i in order), base.dtype)
        if attr == "expand_as" and args:
            return AV(self.avof(args[0]).axes, base.dtype)
        if attr in _REDUCTIONS:
            return self._reduce_av(attr, base, args, kw)
        if attr in ("index_add_", "index_add") and len(args) >= 3:
            return base
        if attr == "gather" and len(args) >= 2:
            return AV(self.avof(args[1]).axes, base.dtype)
        if attr in _ELEMENTWISE:
            out, dtype = axes, base.dtype
            for a in args:
                av = self.avof(a)
                out, _ = _join_axes(out, av.axes)
                dtype = _join_dtype(dtype, av.dtype)
            return AV(out, "bool" if attr in _BOOL_RESULT else dtype)
        return UNKNOWN

    def _einsum_av(self, node: ast.Call) -> AV:
        if not node.args or not isinstance(node.args[0], ast.Constant):
            return UNKNOWN
        spec = node.args[0].value
        if not isinstance(spec, str) or "..." in spec or "->" not in spec:
            return UNKNOWN
        ins, _, out = spec.partition("->")
        in_specs = [s.strip() for s in ins.split(",")]
        operands = node.args[1:]
        letter_axis: Dict[str, str] = {}
        for op_spec, operand in zip(in_specs, operands):
            av = self.avof(operand)
            if av.axes is None or len(av.axes) != len(op_spec):
                continue
            for letter, dim in zip(op_spec, av.axes):
                if not isinstance(dim, str):
                    continue
                prior = letter_axis.get(letter)
                if prior is not None and prior != dim:
                    self._flag(
                        "SHP601", node,
                        f"einsum {spec!r} binds letter '{letter}' to axis "
                        f"'{prior}' and axis '{dim}' — operand axes are "
                        "transposed or the spec is stale",
                    )
                else:
                    letter_axis[letter] = dim
        out_axes = tuple(letter_axis.get(l) for l in out.strip())
        return AV(out_axes if out.strip() else (), None)

    def _subscript_av(self, node: ast.Subscript) -> AV:
        base = self.avof(node.value)
        if base.axes is None:
            return UNKNOWN
        sl = node.slice
        elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        consumed = sum(1 for e in elts if not (
            isinstance(e, ast.Constant) and (e.value is None or e.value is Ellipsis)))
        out: List[object] = []
        pos = 0
        for e in elts:
            if isinstance(e, ast.Slice):
                if pos < len(base.axes):
                    out.append(base.axes[pos])
                pos += 1
            elif isinstance(e, ast.Constant) and e.value is None:
                out.append(1)
            elif isinstance(e, ast.Constant) and e.value is Ellipsis:
                keep = len(base.axes) - consumed
                if keep < 0:
                    return UNKNOWN
                out.extend(base.axes[pos:pos + keep])
                pos += keep
            elif _int_of(e) is not None:
                pos += 1  # integer index drops the dim
            elif isinstance(e, ast.Name):
                av = self.env.get(e.id)
                if av.axes == ():
                    pos += 1  # a scalar index drops the dim
                elif (av.axes is not None and av.dtype != "bool" and len(elts) == 1
                      and len(base.axes) == 1):
                    # 1-D gather: result takes the index's axes
                    return AV(av.axes, base.dtype)
                else:
                    return UNKNOWN  # an index the walker does not know
            else:
                return UNKNOWN
        if pos > len(base.axes):
            return UNKNOWN
        out.extend(base.axes[pos:])
        return AV(tuple(out), base.dtype)

    # -- checks -----------------------------------------------------------

    def _check_literal_dims(self, elts: List[ast.AST], node: ast.AST, where: str) -> None:
        for e in elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                if not isinstance(e.value, bool) and e.value > 1 and not _is_pow2(e.value):
                    self._flag(
                        "SHP603", node,
                        f"literal dimension {e.value} in {where} bypasses "
                        "the power-of-two bucket ladder — the residency "
                        "store reuses a buffer only at the same shape; "
                        "route it through the bucketing helpers or pad to "
                        "a power of two",
                    )

    def _check_dtype_64(self, dtype_node: Optional[ast.AST], ctx: str) -> None:
        """SHP602 at a dtype slot: only a dtype spelled as torch's (or a
        name bound to one) is device code — host ``np.int64`` index math in
        the encoder is intentional and out of scope."""
        name = self._dtype_of_node(dtype_node)
        if name in _DTYPE_64:
            self._flag(
                "SHP602", dtype_node,
                f"explicit {name} in {ctx}: 64-bit types double the bytes "
                "and fall off the kernels' 32-bit paths — use the 32-bit "
                "twin, or sanction an index torch requires",
            )

    # -- statement visitors ----------------------------------------------

    def _bind(self, target: ast.AST, av: AV) -> None:
        if isinstance(target, ast.Name):
            self.env.set(target.id, av)
            self.env.aliases.pop(target.id, None)
            # every rebind clears a tracked spec or dtype (visit_Assign
            # re-records it when the new value IS one): a tuple-unpacked
            # reassignment must poison it, never keep guessing
            self._specs.pop(target.id, None)
            self._dtypes.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, UNKNOWN)

    def _bind_shape(self, targets: List[ast.AST], value: ast.AST) -> None:
        """``P, G = x.shape``: the target names become SCALARs naming x's
        axes — x's axes where it had none (its rank is now known), else
        aliases of the axes it has. ``N = x.shape[0]`` / ``x.size(0)``
        names one axis of a tracked x."""
        if isinstance(value, ast.Attribute) and value.attr == "shape" and isinstance(
                value.value, ast.Name):
            for t in targets:
                if not isinstance(t, (ast.Tuple, ast.List)) or any(
                        not isinstance(e, ast.Name) for e in t.elts):
                    continue
                names = [e.id for e in t.elts]
                for n in names:
                    self.env.set(n, SCALAR)
                x = value.value.id
                av = self.env.get(x)
                if av.axes is None:
                    self.env.set(x, AV(tuple(None if n == "_" else self.env.axis(n)
                                             for n in names), av.dtype))
                elif len(av.axes) == len(names):
                    for n, dim in zip(names, av.axes):
                        if n != "_" and dim is not None:
                            self.env.aliases[n] = dim
            return
        one = None
        if isinstance(value, ast.Subscript) and isinstance(value.value, ast.Attribute) and (
                value.value.attr == "shape" and isinstance(value.value.value, ast.Name)):
            one = (value.value.value.id, value.slice)
        elif (isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute)
              and value.func.attr == "size" and len(value.args) == 1
              and isinstance(value.func.value, ast.Name)):
            one = (value.func.value.id, value.args[0])
        if one is None or len(targets) != 1 or not isinstance(targets[0], ast.Name):
            return
        self.env.set(targets[0].id, SCALAR)
        av = self.env.get(one[0])
        if av.axes is None:
            return
        d = _dim_index(one[1], len(av.axes))
        if d is not None and av.axes[d] is not None:
            self.env.aliases[targets[0].id] = av.axes[d]

    # -- path sensitivity --------------------------------------------------
    # The walker is straight-line: a binding made inside only one branch of
    # a conditional (or a loop body that may run zero times) is not a fact
    # on the fall-through path. Each branch is checked against the
    # pre-branch state, and every name the construct assigns degrades to
    # unknown at its exit — the join that can never false-positive.

    def _degrade_assigned(self, *bodies) -> None:
        for body in bodies:
            for stmt in body:
                for name in _assigned_names(stmt):
                    self.env.forget(name)
                    self._specs.pop(name, None)
                    self._dtypes.pop(name, None)

    def visit_If(self, node: ast.If) -> None:
        self.visit(node.test)
        before = dict(self.env.vals), dict(self.env.aliases)
        for stmt in node.body:
            self.visit(stmt)
        self.env.vals, self.env.aliases = dict(before[0]), dict(before[1])
        for stmt in node.orelse:
            self.visit(stmt)
        self.env.vals, self.env.aliases = before
        self._degrade_assigned(node.body, node.orelse)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        # the loop variable: an int under range(), else unknown
        is_range = isinstance(node.iter, ast.Call) and call_name(
            node.iter, self.aliases) == "range"
        self._bind(node.target, SCALAR if is_range and isinstance(
            node.target, ast.Name) else UNKNOWN)
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self._degrade_assigned([node])

    visit_AsyncFor = visit_For

    def visit_While(self, node: ast.While) -> None:
        self.generic_visit(node)
        self._degrade_assigned([node])

    def visit_Try(self, node: ast.Try) -> None:
        self.generic_visit(node)
        self._degrade_assigned(
            node.body, node.orelse, node.finalbody,
            *[h.body for h in node.handlers],
        )

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        av = self.avof(node.value)
        spec = self._spec_of(node.value)
        dtype = self._dtype_of_node(node.value)
        for t in node.targets:
            self._bind(t, av)
            if isinstance(t, ast.Name):
                if spec is not None:
                    self._specs[t.id] = spec
                if dtype is not None:
                    self._dtypes[t.id] = dtype
            elif isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple) and len(
                    t.elts) == len(node.value.elts):
                # i64, i32 = torch.int64, torch.int32
                for e, v in zip(t.elts, node.value.elts):
                    d = self._dtype_of_node(v)
                    if isinstance(e, ast.Name) and d is not None:
                        self._dtypes[e.id] = d
        self._bind_shape(node.targets, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._bind(node.target, self.avof(node.value))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if isinstance(node.target, ast.Name):
            a = self.env.get(node.target.id)
            b = self.avof(node.value)
            axes, conflict = _join_axes(a.axes, b.axes)
            self._conflict(node, conflict)
            self.env.set(node.target.id, AV(axes, _join_dtype(a.dtype, b.dtype)))

    def visit_BinOp(self, node: ast.BinOp) -> None:
        self.generic_visit(node)
        a, b = self.avof(node.left), self.avof(node.right)
        if isinstance(node.op, ast.MatMult):
            # `@` contracts, it does not broadcast: check the contracted
            # pair, not a right-aligned join (which would flag every
            # legitimate [n,k] @ [k,m])
            self._conflict(node, _matmul_axes(a.axes, b.axes)[1], "matmul contracts")
        else:
            self._conflict(node, _join_axes(a.axes, b.axes)[1])
        if a.dtype and b.dtype and (
            (a.dtype, b.dtype) in _WIDTH_PAIRS
            or (b.dtype, a.dtype) in _WIDTH_PAIRS
        ):
            self._flag(
                "SHP602", node,
                f"join widens {a.dtype}/{b.dtype} to 64-bit — cast the wide "
                "operand down first",
            )

    def visit_Compare(self, node: ast.Compare) -> None:
        self.generic_visit(node)
        prev = self.avof(node.left)
        for comp in node.comparators:
            cur = self.avof(comp)
            self._conflict(node, _join_axes(prev.axes, cur.axes)[1])
            prev = cur

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        cname = call_name(node, self.aliases)
        tail = cname.rpartition(".")[2]
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        if self._is_torch(cname):
            if tail in _CONSTRUCTORS and tail != "arange":
                args = node.args[:1] if tail == "full" else node.args
                self._check_literal_dims(self._shape_nodes(args, kw), node, f"torch.{tail} shape")
            elif tail == "as_tensor" and "dtype" not in kw and len(node.args) > 1:
                self._check_dtype_64(node.args[1], "torch.as_tensor")
            elif tail in _ELEMENTWISE:
                axes: Axes = ()
                for a in node.args:
                    axes, conflict = _join_axes(axes, self.avof(a).axes)
                    self._conflict(node, conflict, f"torch.{tail} joins")
            elif tail == "einsum":
                self._einsum_av(node)  # flags letter conflicts
            elif tail == "matmul" and len(node.args) == 2:
                self._conflict(node, _matmul_axes(self.avof(node.args[0]).axes,
                                                  self.avof(node.args[1]).axes)[1],
                               "matmul contracts")
            self._check_dtype_64(kw.get("dtype"), f"torch.{tail}")
        elif _mesh_callee(cname, "place") and len(node.args) >= 2:
            stacked = node.args[3:4] + [k.value for k in node.keywords if k.arg == "stacked"]
            self._check_shard_divisible(node, node.args[1],
                                        self._named_spec(node.args[0], stacked), "place")
        elif _mesh_callee(cname, "cut") and len(node.args) >= 3:
            self._check_shard_divisible(node, node.args[0], self._spec_of(node.args[2]), "cut")
        elif isinstance(node.func, ast.Attribute):
            self._check_method(node, kw)

    def _check_method(self, node: ast.Call, kw) -> None:
        attr = node.func.attr  # type: ignore[union-attr]
        recv = self.avof(node.func.value)  # type: ignore[union-attr]
        tracked = recv.axes is not None or recv.dtype is not None
        if attr in ("long", "double") and not node.args and not kw:
            # torch's own casts (numpy has no .long()/.double())
            self._flag(
                "SHP602", node,
                f".{attr}() casts to {_CAST_METHODS[attr]} in device code: 64-bit "
                "types double the bytes — use the 32-bit twin, or sanction "
                "an index torch requires",
            )
        elif attr in ("to", "type") or attr in _NEW_CONSTRUCTORS or attr in _REDUCTIONS:
            for a in list(node.args) + [kw.get("dtype")]:
                self._check_dtype_64(a, f".{attr}")
        if attr in _NEW_CONSTRUCTORS:
            args = node.args[:1] if attr == "new_full" else node.args
            self._check_literal_dims(self._shape_nodes(args, kw), node, f".{attr} shape")
        elif attr in ("reshape", "view") and tracked:
            # only values the interpreter tracked are device code — host
            # numpy reshape index math is out of scope
            for a in node.args:
                self._check_literal_dims(
                    list(a.elts) if isinstance(a, (ast.Tuple, ast.List)) else [a],
                    node, f".{attr}")
        elif attr in ("index_add_", "index_add") and len(node.args) >= 3:
            self._check_index_add(node, recv)
        elif attr in _ELEMENTWISE and tracked:
            axes = recv.axes
            for a in node.args:
                axes, conflict = _join_axes(axes, self.avof(a).axes)
                self._conflict(node, conflict, f".{attr} joins")

    def _check_index_add(self, node: ast.Call, out: AV) -> None:
        """``out.index_add_(dim, index, source)``, JAX's segment_sum: the
        index rides the source's ``dim`` axis, and the source's other axes
        are out's."""
        index = self.avof(node.args[1])
        source = self.avof(node.args[2])
        if source.axes is None:
            return
        dim = _dim_index(node.args[0], len(source.axes))
        if dim is None:
            return
        if index.axes is not None and len(index.axes) == 1:
            da, ia = source.axes[dim], index.axes[0]
            both_named = isinstance(da, str) and isinstance(ia, str)
            both_lits = isinstance(da, int) and isinstance(ia, int)
            if (both_named or both_lits) and da != ia:
                self._flag(
                    "SHP601", node,
                    f"index_add_ index rides axis '{ia}' but the source's "
                    f"indexed axis is '{da}' — the compacted index and its "
                    "payload are misaligned",
                )
        if out.axes is not None and len(out.axes) == len(source.axes):
            rest = tuple(1 if i == dim else a for i, a in enumerate(source.axes))
            self._conflict(node, _join_axes(
                tuple(1 if i == dim else a for i, a in enumerate(out.axes)), rest)[1],
                "index_add_ aligns")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        check_function(
            self.path, self.aliases, node, self.findings, parent=self.env
        )

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        env = _Env(parent=self.env)
        for arg in node.args.args + node.args.kwonlyargs:
            env.set(arg.arg, UNKNOWN)
        sub = _FunctionChecker(self.path, self.aliases, self.findings, env)
        sub._dtypes = dict(self._dtypes)
        sub.visit(node.body)


def check_function(
    path: str,
    aliases: Dict[str, str],
    fn: ast.FunctionDef,
    findings: List[Finding],
    parent: Optional[_Env] = None,
) -> None:
    env = _Env(parent=parent)
    for arg in (
        fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    ):
        env.set(arg.arg, UNKNOWN)
    if fn.args.vararg is not None:
        env.set(fn.args.vararg.arg, UNKNOWN)
    if fn.args.kwarg is not None:
        env.set(fn.args.kwarg.arg, UNKNOWN)
    checker = _FunctionChecker(path, aliases, findings, env)
    for stmt in fn.body:
        checker.visit(stmt)


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Run the axis/dtype pass over files/dirs of Python sources."""
    findings: List[Finding] = []
    sources: Dict[str, SourceFile] = {}
    for path in iter_py_files(paths):
        try:
            src, tree = parse_file(path)
        except (OSError, SyntaxError) as exc:
            findings.append(
                Finding("SHP600", Severity.ERROR, path, 0, f"unparsable: {exc}")
            )
            continue
        sources[path] = src
        aliases = import_aliases(tree)
        # module-level statements run through the same checker (constructor
        # sites like module constants are bindings too)
        env = _Env()
        checker = _FunctionChecker(path, aliases, findings, env)
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                check_function(path, aliases, stmt, findings)
            elif isinstance(stmt, ast.ClassDef):
                for item in stmt.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        check_function(path, aliases, item, findings)
            else:
                checker.visit(stmt)
    return findings, sources
