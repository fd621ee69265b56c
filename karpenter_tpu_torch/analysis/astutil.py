# Copied from karpenter_tpu/analysis/astutil.py.
"""Shared AST plumbing for the analysis passes.

Nothing here imports the analyzed code — every pass works on parse trees
only, so intentionally-broken fixtures and accelerator-only modules are
safe to scan on any host.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Tuple

from .findings import SourceFile


def parse_file(path: str) -> Tuple[SourceFile, ast.Module]:
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    return SourceFile(path=path, text=text), ast.parse(text, filename=path)


def iter_py_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into a sorted .py file list."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
        elif p.endswith(".py"):
            out.append(p)
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> dotted origin for module-level imports.

    ``import jax.numpy as jnp`` -> {'jnp': 'jax.numpy'};
    ``from jax import lax`` -> {'lax': 'jax.lax'};
    ``from .packing import pack`` -> {'pack': '.packing.pack'}.
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname is not None:
                    out[alias.asname] = alias.name
                else:
                    # `import a.b` binds the name `a` to module `a`; mapping
                    # it to 'a.b' would make use-site resolution re-append
                    # the submodule ('a.b.b.urlopen') and silently miss
                    # every rule keyed on the dotted origin
                    head = alias.name.split(".")[0]
                    out[head] = head
        elif isinstance(node, ast.ImportFrom):
            prefix = ("." * node.level) + (node.module or "")
            for alias in node.names:
                out[alias.asname or alias.name] = f"{prefix}.{alias.name}"
    return out


def resolves_to(name: str, aliases: Dict[str, str], *origins: str) -> bool:
    """Does a dotted use-site name (e.g. 'jnp.cumsum' or 'jax.jit') start
    with any of the given canonical origins ('jax.numpy', 'jax')?"""
    if not name:
        return False
    head, _, rest = name.partition(".")
    origin = aliases.get(head, head)
    full = origin + ("." + rest if rest else "")
    for o in origins:
        if full == o or full.startswith(o + "."):
            return True
    return False


class FunctionIndex:
    """All function/method defs in a module, keyed by qualified name."""

    def __init__(self, tree: ast.Module):
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.methods: Dict[str, Dict[str, ast.FunctionDef]] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                table: Dict[str, ast.FunctionDef] = {}
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        table[item.name] = item
                self.methods[node.name] = table


def call_name(node: ast.Call, aliases: Dict[str, str]) -> str:
    """Canonical dotted name of the callee ('' when not a name chain)."""
    name = dotted_name(node.func)
    if name is None:
        return ""
    head, _, rest = name.partition(".")
    origin = aliases.get(head, head)
    return origin + ("." + rest if rest else "")
