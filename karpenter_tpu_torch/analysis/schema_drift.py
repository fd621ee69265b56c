# Copied from karpenter_tpu/analysis/schema_drift.py.
"""Pass 4: structural drift between api/schema.py and the CRD YAML.

The runtime validation tier (api/validation.py) and the checked-in CRD
artifacts (api/crds/*.yaml) are kept in lockstep by a round-trip test that
IMPORTS the schema module; this pass is the static complement — it diffs
the dict-literal structure of api/schema.py against the YAML without
executing anything, so a hand-edited YAML or a schema change that was
never regenerated fails presubmit even when the test suite is skipped.

The evaluator only follows literals: dicts, lists, constants, module-level
literal constants, and zero-arg calls to local ``_*_schema()`` helpers.
Anything else (``sorted(val.SUPPORTED_OPERATORS)``, ``pattern % ...``)
evaluates to a wildcard that matches any YAML value — so the comparison is
exact on structure (property keys, required lists, literal enums) and
agnostic about values sourced from the runtime validator.

Rules:
- SCH401: key present in schema.py but missing from the YAML artifact
- SCH402: key present in the YAML artifact but not in schema.py
- SCH403: literal value mismatch (enums, required lists, scalars)
- SCH404: artifact missing/unparsable, or PyYAML unavailable (warning)
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, List, Optional, Tuple

from .astutil import parse_file
from .findings import Finding, Severity, SourceFile

RULES = {
    "SCH400": "unparsable schema module (schema pass)",
    "SCH401": "key present in schema.py but missing from the YAML artifact",
    "SCH402": "key present in the YAML artifact but not in schema.py",
    "SCH403": "literal value mismatch (enums, required lists, scalars)",
    "SCH404": "artifact missing/unparsable, or PyYAML unavailable",
}

WILDCARD = object()

# artifact filename -> schema-building function in the module
DEFAULT_ARTIFACTS = {
    "karpenter_tpu_nodepools.yaml": "nodepool_schema",
    "karpenter_tpu_nodeclaims.yaml": "nodeclaim_schema",
}


class _Evaluator:
    def __init__(self, tree: ast.Module):
        self.functions: Dict[str, ast.FunctionDef] = {
            n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
        }
        self._memo: Dict[str, Any] = {}
        self.globals: Dict[str, Any] = {}
        # after _memo: a module-level `X = some_schema()` evaluates through
        # eval_function, which reads the memo
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if isinstance(target, ast.Name):
                    self.globals[target.id] = self._eval(node.value)

    def eval_function(self, name: str) -> Any:
        if name in self._memo:
            return self._memo[name]
        fn = self.functions.get(name)
        if fn is None:
            return WILDCARD
        self._memo[name] = WILDCARD  # cycle guard
        result: Any = WILDCARD
        for stmt in fn.body:
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                result = self._eval(stmt.value)
        self._memo[name] = result
        return result

    def _eval(self, node: ast.AST) -> Any:
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Dict):
            out: Dict[Any, Any] = {}
            for k, v in zip(node.keys, node.values):
                if k is None:  # **spread
                    return WILDCARD
                key = self._eval(k)
                if key is WILDCARD or not isinstance(key, str):
                    return WILDCARD
                out[key] = self._eval(v)
            return out
        if isinstance(node, (ast.List, ast.Tuple)):
            return [self._eval(e) for e in node.elts]
        if isinstance(node, ast.Name):
            return self.globals.get(node.id, WILDCARD)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and not node.args and \
                    not node.keywords:
                return self.eval_function(node.func.id)
            return WILDCARD
        return WILDCARD


def _diff(
    expected: Any, actual: Any, path: str, line: int, artifact: str,
    findings: List[Finding], py_path: str,
) -> None:
    if expected is WILDCARD:
        return
    if isinstance(expected, dict):
        if not isinstance(actual, dict):
            findings.append(
                Finding(
                    "SCH403", Severity.ERROR, py_path, line,
                    f"{artifact}: {path or '<root>'} is a mapping in "
                    f"schema.py but {type(actual).__name__} in the YAML",
                )
            )
            return
        for key in expected:
            child = f"{path}.{key}" if path else key
            if key not in actual:
                findings.append(
                    Finding(
                        "SCH401", Severity.ERROR, py_path, line,
                        f"{artifact}: '{child}' is defined in schema.py "
                        "but missing from the YAML artifact — regenerate "
                        "with `python -m karpenter_tpu.api.schema`",
                    )
                )
            else:
                _diff(expected[key], actual[key], child, line, artifact,
                      findings, py_path)
        for key in actual:
            if key not in expected:
                child = f"{path}.{key}" if path else key
                findings.append(
                    Finding(
                        "SCH402", Severity.ERROR, py_path, line,
                        f"{artifact}: '{child}' exists in the YAML artifact "
                        "but not in schema.py — stale artifact or "
                        "hand-edited YAML",
                    )
                )
        return
    if isinstance(expected, list):
        if not isinstance(actual, list):
            findings.append(
                Finding(
                    "SCH403", Severity.ERROR, py_path, line,
                    f"{artifact}: {path} is a list in schema.py but "
                    f"{type(actual).__name__} in the YAML",
                )
            )
            return
        if any(e is WILDCARD for e in expected):
            return
        if all(isinstance(e, (str, int, float, bool)) for e in expected):
            # scalar lists (enums): compare as sets, order-insensitively
            if set(map(str, expected)) != set(map(str, actual or [])):
                findings.append(
                    Finding(
                        "SCH403", Severity.ERROR, py_path, line,
                        f"{artifact}: {path} differs — schema.py has "
                        f"{sorted(map(str, expected))}, YAML has "
                        f"{sorted(map(str, actual or []))}",
                    )
                )
            return
        if len(expected) != len(actual):
            findings.append(
                Finding(
                    "SCH403", Severity.ERROR, py_path, line,
                    f"{artifact}: {path} has {len(expected)} entries in "
                    f"schema.py but {len(actual)} in the YAML",
                )
            )
            return
        for i, (e, a) in enumerate(zip(expected, actual)):
            _diff(e, a, f"{path}[{i}]", line, artifact, findings, py_path)
        return
    if expected != actual:
        findings.append(
            Finding(
                "SCH403", Severity.ERROR, py_path, line,
                f"{artifact}: {path} is {expected!r} in schema.py but "
                f"{actual!r} in the YAML",
            )
        )


def check_schema(
    schema_py: str,
    crd_dir: str,
    artifacts: Optional[Dict[str, str]] = None,
) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    findings: List[Finding] = []
    sources: Dict[str, SourceFile] = {}
    try:
        src, tree = parse_file(schema_py)
    except (OSError, SyntaxError) as exc:
        return (
            [Finding("SCH400", Severity.ERROR, schema_py, 0,
                     f"unparsable: {exc}")],
            sources,
        )
    sources[schema_py] = src
    try:
        import yaml
    except ImportError:
        return (
            [Finding("SCH404", Severity.WARNING, schema_py, 0,
                     "PyYAML unavailable; schema-drift pass skipped")],
            sources,
        )

    evaluator = _Evaluator(tree)
    for artifact, fn_name in (artifacts or DEFAULT_ARTIFACTS).items():
        expected = evaluator.eval_function(fn_name)
        fn = evaluator.functions.get(fn_name)
        line = fn.lineno if fn is not None else 0
        if expected is WILDCARD:
            findings.append(
                Finding(
                    "SCH404", Severity.WARNING, schema_py, line,
                    f"schema function {fn_name}() not statically "
                    "evaluatable; drift check skipped",
                )
            )
            continue
        ypath = os.path.join(crd_dir, artifact)
        try:
            with open(ypath, encoding="utf-8") as fh:
                actual = yaml.safe_load(fh)
        except (OSError, yaml.YAMLError) as exc:
            findings.append(
                Finding(
                    "SCH404", Severity.ERROR, ypath, 0,
                    f"CRD artifact unreadable: {exc}",
                )
            )
            continue
        _diff(expected, actual, "", line, artifact, findings, schema_py)
    return findings, sources
