"""The PyTorch port stands alone.

Nothing under karpenter_tpu_torch/ nor chip_smoke.py imports jax or the
JAX package (the card's machine has no JAX); every verbatim copy of a host
module, and each function copied into a module that is not one, still
equals its source; and chip_smoke.py refuses to report a
result where there is no card, or no repo around it.
"""

import ast
import difflib
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "karpenter_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu")
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _copies():
    for path in sorted(PORT.rglob("*.py")):
        first = path.read_text().split("\n", 1)[0]
        if first.startswith("# Copied from karpenter_tpu/"):
            yield path, first


@pytest.mark.parametrize("path,first", list(_copies()),
                         ids=lambda x: x.name if isinstance(x, pathlib.Path) else "")
def test_copies_name_their_source(path, first):
    """Each copy's first line names an existing source at the same relative
    path. A verbatim copy (no qualifier) equals it byte for byte; one with
    "N comment line(s) reworded" differs from it in at most N lines."""
    src_rel = first[len("# Copied from "):].rstrip(".").split(",")[0]
    src = ROOT / src_rel
    assert src.is_file(), first
    assert path.relative_to(PORT) == src.relative_to(ROOT / "karpenter_tpu")
    body = path.read_text().split("\n", 1)[1]
    if first == f"# Copied from {src_rel}.":
        assert body == src.read_text()
    elif first.endswith("reworded."):
        n = int(first.split(", ")[1].split()[0])
        diff = difflib.ndiff(src.read_text().splitlines(), body.splitlines())
        assert sum(line.startswith("- ") for line in diff) <= n


# functions copied verbatim into a module that is not a verbatim copy
COPIED_FUNCTIONS = (
    ("solver/workloads.py", "mixed_pods"),
    ("solver/workloads.py", "constrained_mix"),
    ("solver/workloads.py", "diverse_reference_mix"),
)


def _function_source(path, name):
    text = path.read_text()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"{path.relative_to(ROOT)} has no function {name}")


@pytest.mark.parametrize("rel,name", COPIED_FUNCTIONS, ids=lambda x: x)
def test_copied_functions_equal_their_source(rel, name):
    assert _function_source(PORT / rel, name) == _function_source(
        ROOT / "karpenter_tpu" / rel, name)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_without_cuda():
    _assert_refused(_run_smoke(ROOT))


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    _assert_refused(_run_smoke(tmp_path))
