# Copied from karpenter_tpu/analysis/blocking.py.
"""Pass 3: blocking calls in reconcile paths.

Controllers (and the operator loop) are level-triggered and clock-injected:
tests drive a TestClock the way the reference's suites drive
clock.FakeClock, so a direct ``time.sleep``/``time.time`` both blocks the
reconcile thread for real wall-clock time AND desynchronizes from the
simulated clock. Blocking process/network I/O in a reconcile path has the
same shape: it stalls every controller behind the single-threaded step loop.

Rules:
- BLK301: ``time.sleep`` — go through the injectable kube/clock.py
- BLK302: ``time.time``/``time.monotonic`` — use the injected clock's now()
- BLK303: blocking process/network call (subprocess.run/... , socket,
  urllib, requests) in a reconcile path
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from .astutil import call_name, import_aliases, iter_py_files, parse_file
from .findings import Finding, Severity, SourceFile

RULES = {
    "BLK300": "unparsable file (blocking pass)",
    "BLK301": "time.sleep in a reconcile path",
    "BLK302": "direct wall-clock read in a reconcile path",
    "BLK303": "blocking process/network call in a reconcile path",
}

_SLEEPS = {"time.sleep"}
_CLOCK_READS = {"time.time", "time.monotonic", "time.perf_counter"}
_BLOCKING_CALLS = {
    "subprocess.run", "subprocess.call", "subprocess.check_output",
    "subprocess.check_call", "socket.create_connection",
    "urllib.request.urlopen", "requests.get", "requests.post",
    "requests.put", "requests.delete", "requests.request",
}


def check_paths(paths: List[str]) -> Tuple[List[Finding], Dict[str, SourceFile]]:
    findings: List[Finding] = []
    sources: Dict[str, SourceFile] = {}
    for path in iter_py_files(paths):
        try:
            src, tree = parse_file(path)
        except (OSError, SyntaxError) as exc:
            findings.append(
                Finding("BLK300", Severity.ERROR, path, 0, f"unparsable: {exc}")
            )
            continue
        sources[path] = src
        aliases = import_aliases(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node, aliases)
            if cname in _SLEEPS:
                findings.append(
                    Finding(
                        "BLK301", Severity.ERROR, path, node.lineno,
                        "time.sleep blocks the reconcile loop on wall-clock "
                        "time; route it through the injectable "
                        "kube/clock.py Clock.sleep",
                    )
                )
            elif cname in _CLOCK_READS:
                findings.append(
                    Finding(
                        "BLK302", Severity.ERROR, path, node.lineno,
                        f"{cname} reads the wall clock directly; use the "
                        "injected Clock.now() so tests can drive time",
                    )
                )
            elif cname in _BLOCKING_CALLS:
                findings.append(
                    Finding(
                        "BLK303", Severity.ERROR, path, node.lineno,
                        f"blocking call {cname} in a reconcile path stalls "
                        "every controller behind the step loop; move it "
                        "off-thread or behind an injectable seam",
                    )
                )
    return findings, sources
