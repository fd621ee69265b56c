# Copied from karpenter_tpu/analysis/args_registry.py.
"""Pass 12: kernel-argument registry consistency (ARG12xx).

The solve kernel's 56-argument tuple is named once —
``solver/encode.py:SOLVE_ARG_NAMES`` — and then re-spelled on five more
surfaces that have no runtime link back to it:

- ``EncodedSnapshot.solve_args`` assembles the tuple (encode side);
- ``parallel/mesh.py:ARG_SPECS`` declares each position's mesh
  partition spec (the SHP6xx shard checks and the scenario axis read it);
- ``parallel/mesh.py:pad_args_for_mesh`` pads exactly the sharded
  positions so every sharded axis divides its mesh dim (the SHP604
  pow2/divisibility guarantee);
- ``native/__init__.py:solve_core_native`` unpacks the same prefix
  positionally for the C++ twin;
- ``solver/residency.py`` partitions the names into device-buffer
  delta classes (NODE_ROW/CROSS/GROUP/GCOUNT, NO_ROW_DELTA), and
  ``ops/solve.py`` picks the scenario-batched subset.

Adding an argument means editing all of them; nothing but convention
keeps them aligned, and a miss is a silent positional skew (the exact
drift class PAR5xx guards between the JAX and C++ kernel *bodies* —
this pass guards the *signatures*). A cross-module content parse
rebuilds every surface from the AST and diffs them against the
authority:

- ARG1201 — an argument missing from (or extra on) a surface:
  ARG_SPECS keys, the solve_args tuple, the native wrapper's
  parameters, or a scenario-batched name that isn't an argument at all.
- ARG1202 — a surface spells the arguments in a different order than
  SOLVE_ARG_NAMES (positional tuples make order part of the contract).
- ARG1203 — residency delta classes inconsistent: a class member that
  is not an argument, two classes claiming the same name, or a
  NO_ROW_DELTA entry outside GROUP_ARGS (row-delta suppression only
  means anything for group-class buffers).
- ARG1204 — a sharded ARG_SPECS entry without the matching
  ``pad_args_for_mesh`` pad (same axis index, same mesh dim), or a pad
  for a replicated entry: the shard-divisibility guarantee SHP604
  relies on would silently not hold for that argument.

Surfaces are detected by content in whatever file set the pass is given
(the fixture twins are tiny multi-file replicas); each check runs only
when both of its surfaces were found, so partial scans stay quiet
rather than guessing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .core.summaries import ModuleInfo, load_modules
from .findings import Finding, Severity, SourceFile

RULES = {
    "ARG1200": "unparsable file (kernel-arg registry pass)",
    "ARG1201": "kernel argument missing from a registry surface",
    "ARG1202": "registry surface orders arguments differently than SOLVE_ARG_NAMES",
    "ARG1203": "residency delta classes inconsistent with the argument registry",
    "ARG1204": "sharded ARG_SPECS entry without a matching mesh pad",
}

_RESIDENCY_SETS = ("NODE_ROW_ARGS", "CROSS_ARGS", "GROUP_ARGS",
                   "GCOUNT_ARGS", "NO_ROW_DELTA")
_SCENARIO_SETS = ("SCENARIO_BATCHED_ARGS", "SCENARIO_TOPO_BATCHED_ARGS")


class _Site:
    """One detected surface: where it lives plus its parsed content."""

    __slots__ = ("path", "line", "value")

    def __init__(self, path: str, line: int, value):
        self.path = path
        self.line = line
        self.value = value


def _str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """A literal tuple/list of string constants, or None."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    out = []
    for elt in node.elts:
        if not (isinstance(elt, ast.Constant) and isinstance(elt.value, str)):
            return None
        out.append(elt.value)
    return tuple(out)


def _str_set(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """frozenset({...}) / set literal of string constants, in source
    order (the order only matters for deterministic reporting)."""
    if isinstance(node, ast.Call):
        callee = node.func
        if (
            isinstance(callee, ast.Name)
            and callee.id in ("frozenset", "set")
            and len(node.args) == 1
        ):
            node = node.args[0]
        else:
            return None
    if isinstance(node, ast.Set):
        out = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            out.append(elt.value)
        return tuple(out)
    return _str_tuple(node)


def _spec_entry(node: ast.AST) -> Optional[Tuple[Optional[str], ...]]:
    """One ARG_SPECS value: a tuple of None / axis-name references.
    Axis names are kept symbolically (the Name/Attribute tail)."""
    if not isinstance(node, ast.Tuple):
        return None
    out: List[Optional[str]] = []
    for elt in node.elts:
        if isinstance(elt, ast.Constant) and elt.value is None:
            out.append(None)
        elif isinstance(elt, (ast.Name, ast.Attribute)):
            tail = elt.attr if isinstance(elt, ast.Attribute) else elt.id
            out.append(tail)
        else:
            return None
    return tuple(out)


class _Surfaces:
    """Everything the file set declared, first definition wins (modules
    arrive in sorted-path order, so collisions resolve deterministically)."""

    def __init__(self):
        self.names: Optional[_Site] = None        # SOLVE_ARG_NAMES tuple
        self.specs: Optional[_Site] = None        # ARG_SPECS ordered dict
        self.pads: Optional[_Site] = None         # {name: (axis, dim_expr)}
        self.native: Optional[_Site] = None       # wrapper param order
        self.assemble: Optional[_Site] = None     # solve_args element order
        self.axis_consts: Dict[str, str] = {}     # AXIS_MODEL -> "model"
        self.residency: Dict[str, _Site] = {}     # set name -> members
        self.scenario: Dict[str, _Site] = {}      # tuple name -> names


def _scan_module(mod: ModuleInfo, out: _Surfaces) -> None:
    path = mod.path
    for node in ast.walk(mod.tree):
        target: Optional[str] = None
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name) and node.value is not None:
            target, value = node.target.id, node.value
        if target is not None:
            line = node.lineno
            if target == "SOLVE_ARG_NAMES" and out.names is None:
                names = _str_tuple(value)
                if names is not None:
                    out.names = _Site(path, line, names)
            elif target == "ARG_SPECS" and out.specs is None:
                specs = _parse_specs(value)
                if specs is not None:
                    out.specs = _Site(path, line, specs)
            elif target.startswith("AXIS_") and isinstance(
                value, ast.Constant
            ) and isinstance(value.value, str):
                out.axis_consts.setdefault(target, value.value)
            elif target in _RESIDENCY_SETS and target not in out.residency:
                members = _str_set(value)
                if members is not None:
                    out.residency[target] = _Site(path, line, members)
            elif target in _SCENARIO_SETS and target not in out.scenario:
                names = _scenario_tuple(value, out)
                if names is not None:
                    out.scenario[target] = _Site(path, line, names)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == "pad_args_for_mesh" and out.pads is None:
                out.pads = _Site(path, node.lineno, _parse_pads(node))
            elif node.name == "solve_core_native" and out.native is None:
                args = node.args
                params = tuple(
                    a.arg for a in args.posonlyargs + args.args
                )
                out.native = _Site(path, node.lineno, params)
            elif node.name == "solve_args" and out.assemble is None:
                elems = _parse_assembly(node)
                if elems is not None:
                    out.assemble = _Site(path, node.lineno, elems)


def _parse_specs(node: ast.AST) -> Optional[Dict[str, Tuple]]:
    if not isinstance(node, ast.Dict):
        return None
    specs: Dict[str, Tuple] = {}
    for key, value in zip(node.keys, node.values):
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            return None
        entry = _spec_entry(value)
        if entry is None:
            return None
        specs[key.value] = entry
    return specs


def _scenario_tuple(node: ast.AST, out: _Surfaces) -> Optional[Tuple[str, ...]]:
    """A scenario-batched tuple, including the ``BASE + ("more",)``
    concatenation spelling (resolved against tuples already seen)."""
    direct = _str_tuple(node)
    if direct is not None:
        return direct
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = right = None
        if isinstance(node.left, ast.Name):
            site = out.scenario.get(node.left.id)
            left = site.value if site is not None else None
        else:
            left = _str_tuple(node.left)
        right = _str_tuple(node.right)
        if left is not None and right is not None:
            return left + right
    return None


def _parse_pads(fn: ast.AST) -> Dict[str, Tuple[int, str]]:
    """{arg name: (padded axis index, mesh-dim expression text)} from
    ``byname[...] = pad_axis(..., axis, dim)`` assignments — both the
    direct-subscript spelling and the for-loop-over-a-name-tuple one."""
    pads: Dict[str, Tuple[int, str]] = {}

    def pad_call(node: ast.AST) -> Optional[Tuple[int, str]]:
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "pad_axis"
                and len(node.args) >= 3):
            return None
        axis = node.args[1]
        if not (isinstance(axis, ast.Constant) and isinstance(axis.value, int)):
            return None
        dim = node.args[2]
        dim_text = dim.id if isinstance(dim, ast.Name) else ""
        return axis.value, dim_text

    def record(name: str, call) -> None:
        if call is not None and name not in pads:
            pads[name] = call

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Subscript):
            sub = node.targets[0].slice
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                record(sub.value, pad_call(node.value))
        elif isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            names = _str_tuple(node.iter)
            if names is None:
                continue
            loop_var = node.target.id
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and \
                        len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], ast.Subscript):
                    sub = stmt.targets[0].slice
                    if isinstance(sub, ast.Name) and sub.id == loop_var:
                        call = pad_call(stmt.value)
                        for name in names:
                            record(name, call)
    return pads


def _parse_assembly(fn: ast.AST) -> Optional[Tuple[str, ...]]:
    """Element names of the solve_args return tuple: ``self.x`` -> x,
    a bare parameter name -> itself. Any other element shape means the
    surface is not the assembly we know how to diff — skip it."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Tuple):
            out = []
            for elt in node.value.elts:
                if isinstance(elt, ast.Attribute) and \
                        isinstance(elt.value, ast.Name) and \
                        elt.value.id == "self":
                    out.append(elt.attr)
                elif isinstance(elt, ast.Name):
                    out.append(elt.id)
                else:
                    return None
            return tuple(out)
    return None


def _order_diff(canon: Tuple[str, ...], other: Tuple[str, ...]) -> Optional[str]:
    """First order disagreement between ``other`` and ``canon`` restricted
    to their common names, rendered for the message; None when aligned."""
    common = set(canon) & set(other)
    want = [n for n in canon if n in common]
    got = [n for n in other if n in common]
    for w, g in zip(want, got):
        if w != g:
            return f"expected {w!r} here, found {g!r}"
    return None


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    """Run the kernel-arg registry pass; returns (findings, sources)."""
    findings: List[Finding] = []
    modules, sources, errors = load_modules(paths)
    for path, exc in errors:
        findings.append(
            Finding("ARG1200", Severity.ERROR, path, 0, f"unparsable: {exc}")
        )
    surfaces = _Surfaces()
    for mod in modules.values():
        _scan_module(mod, surfaces)

    names_site = surfaces.names
    if names_site is None:
        return findings, sources  # no authority in scope: nothing to diff
    canon = names_site.value
    canon_set = set(canon)

    def flag(rule: str, site: _Site, message: str) -> None:
        findings.append(
            Finding(rule, Severity.ERROR, site.path, site.line, message)
        )

    # -- ARG_SPECS: full key parity + order ------------------------------
    if surfaces.specs is not None:
        site = surfaces.specs
        keys = tuple(site.value.keys())
        for name in canon:
            if name not in site.value:
                flag("ARG1201", site,
                     f"ARG_SPECS has no partition spec for {name!r}; every "
                     "SOLVE_ARG_NAMES position needs one (replicated = ())")
        for name in keys:
            if name not in canon_set:
                flag("ARG1201", site,
                     f"ARG_SPECS entry {name!r} is not a SOLVE_ARG_NAMES "
                     "argument (stale key after a rename?)")
        diff = _order_diff(canon, keys)
        if diff is not None:
            flag("ARG1202", site,
                 f"ARG_SPECS key order diverges from SOLVE_ARG_NAMES "
                 f"({diff}); keep the table in tuple order so positional "
                 "reviews stay 1:1")

    # -- solve_args assembly: exact sequence -----------------------------
    if surfaces.assemble is not None:
        site = surfaces.assemble
        elems = site.value
        for name in canon:
            if name not in elems:
                flag("ARG1201", site,
                     f"solve_args never assembles {name!r}; the kernel "
                     "will read a shifted position for every later arg")
        for name in elems:
            if name not in canon_set:
                flag("ARG1201", site,
                     f"solve_args assembles {name!r}, which "
                     "SOLVE_ARG_NAMES does not name")
        diff = _order_diff(canon, elems)
        if diff is not None:
            flag("ARG1202", site,
                 f"solve_args tuple order diverges from SOLVE_ARG_NAMES "
                 f"({diff}); positional consumers (kernel, padding, "
                 "scenario axes) all read this order")

    # -- native wrapper: prefix parity + order ---------------------------
    if surfaces.native is not None:
        site = surfaces.native
        params = site.value
        param_set = set(params)
        for name in canon:
            if name not in param_set:
                flag("ARG1201", site,
                     f"solve_core_native has no parameter {name!r}; the "
                     "C++ twin's positional unpack skews from there on")
        diff = _order_diff(canon, params)
        if diff is not None:
            flag("ARG1202", site,
                 f"solve_core_native parameter order diverges from "
                 f"SOLVE_ARG_NAMES ({diff})")

    # -- residency delta classes -----------------------------------------
    classes = [
        (n, surfaces.residency[n])
        for n in ("NODE_ROW_ARGS", "CROSS_ARGS", "GROUP_ARGS", "GCOUNT_ARGS")
        if n in surfaces.residency
    ]
    for cname, site in classes:
        for member in site.value:
            if member not in canon_set:
                flag("ARG1203", site,
                     f"{cname} member {member!r} is not a SOLVE_ARG_NAMES "
                     "argument; its device buffer would never be staged")
    for i, (a_name, a_site) in enumerate(classes):
        for b_name, b_site in classes[i + 1:]:
            both = sorted(set(a_site.value) & set(b_site.value))
            for member in both:
                flag("ARG1203", a_site,
                     f"{member!r} is claimed by both {a_name} and "
                     f"{b_name}; delta classes must partition the args")
    if "NO_ROW_DELTA" in surfaces.residency and \
            "GROUP_ARGS" in surfaces.residency:
        nrd = surfaces.residency["NO_ROW_DELTA"]
        group = set(surfaces.residency["GROUP_ARGS"].value)
        for member in nrd.value:
            if member not in group:
                flag("ARG1203", nrd,
                     f"NO_ROW_DELTA entry {member!r} is not in GROUP_ARGS; "
                     "row-delta suppression only applies to group-class "
                     "buffers")

    # -- scenario-batched subsets ----------------------------------------
    for sname, site in sorted(surfaces.scenario.items()):
        for member in site.value:
            if member not in canon_set:
                flag("ARG1201", site,
                     f"{sname} batches {member!r}, which is not a "
                     "SOLVE_ARG_NAMES argument; its vmap axis would bind "
                     "to nothing")

    # -- sharded specs vs the mesh pads (the SHP604 guarantee) -----------
    if surfaces.specs is not None and surfaces.pads is not None:
        specs_site = surfaces.specs
        pads_site = surfaces.pads
        pads = pads_site.value
        for name, spec in specs_site.value.items():
            sharded = [
                (i, axis) for i, axis in enumerate(spec) if axis is not None
            ]
            if sharded:
                if name not in pads:
                    flag("ARG1204", pads_site,
                         f"{name!r} is sharded in ARG_SPECS but "
                         "pad_args_for_mesh never pads it; its axis is "
                         "not guaranteed to divide the mesh dim (SHP604)")
                    continue
                pad_axis_idx, dim_text = pads[name]
                want = [i for i, _ in sharded]
                if pad_axis_idx not in want:
                    flag("ARG1204", pads_site,
                         f"{name!r} is padded on axis {pad_axis_idx} but "
                         f"ARG_SPECS shards axis {want[0]}; the pad "
                         "protects the wrong dimension")
                else:
                    axis_name = dict(sharded)[pad_axis_idx]
                    axis_value = surfaces.axis_consts.get(axis_name)
                    if axis_value and dim_text and dim_text != axis_value:
                        flag("ARG1204", pads_site,
                             f"{name!r} pads to a multiple of "
                             f"{dim_text!r} but is sharded on the "
                             f"{axis_value!r} mesh axis")
            elif name in pads:
                flag("ARG1204", pads_site,
                     f"{name!r} is padded in pad_args_for_mesh but "
                     "replicated in ARG_SPECS; one of the two is stale")
    return findings, sources
