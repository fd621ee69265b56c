"""CLI for the port's static-analysis tier:
``python -m karpenter_tpu_torch.analysis`` from the repo root.

Default targets, relative to the root (the JAX package's sets, over
``karpenter_tpu_torch/``):

- locks:    the threaded tree (solver/, ops/, controllers/, kube/, obs/,
            metrics/, sim/, operator.py)
- blocking: controllers/, __main__.py, solver/service.py, kube/leader.py
- schema:   api/schema.py vs api/crds/
- parity:   ops/packing.py's plain scans vs native/solve_core.cc and the
            CUDA scans (csrc/common.cuh, pack_common.cuh, pack.cu,
            pack_classed.cu; kernel-twin skeletons)
- shapes:   ops/, solver/, parallel/ (SHP6xx: the torch axis/dtype
            walker and the mesh's shard divisibility)
- retry:    controllers/, solver/, operator.py (swallowed exceptions,
            unbounded retry loops)
- obs:      the whole package (span leaks, per-call metric construction)
- device:   ops/, solver/driver.py, solver/residency.py, faults/guard.py
            (DTX9xx: the torch host-sync rule)
- clock:    controllers/, faults/, obs/, solver/ (CLK10xx clock
            discipline)
- det:      solver/, ops/, sim/, obs/ (DET11xx order discipline:
            unordered sources to order-sensitive sinks)
- args:     solver/encode.py, solver/residency.py, native/__init__.py,
            ops/solve.py (ARG12xx kernel-arg registry surfaces vs
            SOLVE_ARG_NAMES; the mesh surface comes with the port's
            parallel/ package)
- guarded:  the threaded tree (GRD13xx guarded-by inference)
- atomicity: the threaded tree (ATM14xx: check-then-act across a lock
            release, cross-module lock-order cycles)

Positional paths (with ``--pass``) override a pass's default targets so
fixture suites can point a single pass at seeded-bad files. Exit status is
the number of unsuppressed findings capped at 1 — suitable for presubmit.

``--changed-only`` scopes file discovery to ``git diff --name-only
<--base>`` plus untracked files — the presubmit fast lane; the full run
(default, or explicit ``--all``) is the slow-lane gate and the only mode
that runs the stale-suppression audit (STALE001) — staleness can only be
judged when every producing pass ran. ``--prune-baseline`` rewrites the
baseline (``karpenter_tpu_torch/analysis/baseline.txt``, the port's own)
with stale entries dropped.

``--format sarif`` emits SARIF 2.1.0 with the analyzer's own runtime in
the run properties (per-pass seconds); ``--write-baseline`` regenerates
the baseline so bulk grandfathering is a designed workflow instead of a
hand-edit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Set

from . import (
    all_rules,
    args_registry,
    atomicity,
    blocking,
    clock,
    det,
    device,
    guarded,
    locks,
    obs,
    parity,
    retry,
    schema_drift,
    shapes,
    stale,
)
from .astutil import iter_py_files
from .findings import (
    Finding,
    Severity,
    SourceFile,
    load_baseline,
    partition_findings,
    write_baseline,
)

DEFAULT_BASELINE = os.path.join("karpenter_tpu_torch", "analysis", "baseline.txt")

# the whole threaded surface: every layer that constructs a lock or a
# thread — the GRD/ATM set and the locks pass's scope
_THREADED_TREE = [
    "karpenter_tpu_torch/solver",
    "karpenter_tpu_torch/ops",
    "karpenter_tpu_torch/controllers",
    "karpenter_tpu_torch/kube",
    "karpenter_tpu_torch/obs",
    "karpenter_tpu_torch/metrics",
    "karpenter_tpu_torch/sim",
    "karpenter_tpu_torch/operator.py",
]

PASS_TARGETS = {
    "locks": list(_THREADED_TREE),
    "blocking": [
        "karpenter_tpu_torch/controllers",
        "karpenter_tpu_torch/__main__.py",
        # the sidecar's solve path and the leader-election loop are
        # reconcile-shaped too: both run behind level-triggered steps and
        # must stay on the injectable clock
        "karpenter_tpu_torch/solver/service.py",
        "karpenter_tpu_torch/kube/leader.py",
    ],
    "schema": ["karpenter_tpu_torch/api/schema.py", "karpenter_tpu_torch/api/crds"],
    # the plain scans, the host core, then the CUDA scans' sources read
    # as one twin
    "parity": [
        "karpenter_tpu_torch/ops/packing.py",
        "karpenter_tpu_torch/native/solve_core.cc",
        "karpenter_tpu_torch/csrc/common.cuh",
        "karpenter_tpu_torch/csrc/pack_common.cuh",
        "karpenter_tpu_torch/csrc/pack.cu",
        "karpenter_tpu_torch/csrc/pack_classed.cu",
    ],
    # the axis/dtype walker over the device code: the plain versions and
    # the wrappers (ops/), the driver's staging (solver/) and the mesh
    # (parallel/: its specs meet the arrays at place and cut)
    "shapes": [
        "karpenter_tpu_torch/ops",
        "karpenter_tpu_torch/solver",
        "karpenter_tpu_torch/parallel",
    ],
    # retry/except hygiene where the degradation ladder lives: the
    # reconcile roster, the solver path, and the operator's requeue loop
    "retry": [
        "karpenter_tpu_torch/controllers",
        "karpenter_tpu_torch/solver",
        "karpenter_tpu_torch/operator.py",
    ],
    # observability hygiene: span leaks and per-call metric construction
    # anywhere in the package (the obs seams thread through everything)
    "obs": ["karpenter_tpu_torch"],
    # the host-sync rule over the solve path: where device tensors are
    # born (ops/), routed (driver), held BETWEEN solves
    # (solver/residency.py — the dev_*/_dev_* resident-attribute
    # convention), and guarded (faults/guard.py)
    "device": [
        "karpenter_tpu_torch/ops",
        "karpenter_tpu_torch/parallel",
        "karpenter_tpu_torch/solver/driver.py",
        "karpenter_tpu_torch/solver/residency.py",
        "karpenter_tpu_torch/faults/guard.py",
    ],
    # clock discipline over the determinism surface: every timestamp in
    # these trees must flow from an injected clock or a RealClock seam
    "clock": [
        "karpenter_tpu_torch/controllers",
        "karpenter_tpu_torch/faults",
        "karpenter_tpu_torch/obs",
        "karpenter_tpu_torch/solver",
    ],
    # order discipline over the determinism surface: unordered-source
    # values (sets, os.environ, unseeded RNG) must not reach
    # order-sensitive sinks un-sorted (DET11xx — the PYTHONHASHSEED
    # interning class, statically)
    "det": [
        "karpenter_tpu_torch/solver",
        "karpenter_tpu_torch/ops",
        "karpenter_tpu_torch/sim",
        "karpenter_tpu_torch/obs",
    ],
    # the kernel-arg registry's hand-aligned surfaces, diffed against
    # SOLVE_ARG_NAMES (ARG12xx), the mesh's specs and pads among them
    "args": [
        "karpenter_tpu_torch/solver/encode.py",
        "karpenter_tpu_torch/solver/residency.py",
        "karpenter_tpu_torch/native/__init__.py",
        "karpenter_tpu_torch/ops/solve.py",
        "karpenter_tpu_torch/parallel/mesh.py",
    ],
    # guarded-by inference (GRD13xx) and atomicity/lock-order (ATM14xx)
    # over the same threaded tree the generalized locks pass scans
    "guarded": list(_THREADED_TREE),
    "atomicity": list(_THREADED_TREE),
}

# passes whose targets are a comparison pair (or cross-file registry),
# not an independently scannable file set: --changed-only runs them in
# full when ANY of their targets changed — a partial scan would read as
# "surface missing" instead of "surface unchanged"
_PAIR_PASSES = {"schema", "parity", "args"}


def _run_pass(name: str, targets: List[str]):
    if name == "locks":
        return locks.check_paths(targets)
    if name == "blocking":
        return blocking.check_paths(targets)
    if name == "schema":
        schema_py = targets[0]
        crd_dir = targets[1] if len(targets) > 1 else os.path.join(
            os.path.dirname(targets[0]), "crds"
        )
        return schema_drift.check_schema(schema_py, crd_dir)
    if name == "parity":
        py_path = targets[0]
        cc_path = targets[1] if len(targets) > 1 else os.path.join(
            os.path.dirname(os.path.dirname(py_path)),
            "native", "solve_core.cc",
        )
        return parity.check_parity(py_path, cc_path, targets[2:])
    if name == "shapes":
        return shapes.check_paths(targets)
    if name == "retry":
        return retry.check_paths(targets)
    if name == "obs":
        return obs.check_paths(targets)
    if name == "device":
        return device.check_paths(targets)
    if name == "clock":
        return clock.check_paths(targets)
    if name == "det":
        return det.check_paths(targets)
    if name == "args":
        return args_registry.check_paths(targets)
    if name == "guarded":
        return guarded.check_paths(targets)
    if name == "atomicity":
        return atomicity.check_paths(targets)
    raise ValueError(f"unknown pass {name!r}")


# pass name -> producing module, for RULES lookup (stale-audit scope) —
# the single place a new pass registers itself besides PASS_TARGETS
PASS_MODULES = {
    "locks": locks, "blocking": blocking,
    "schema": schema_drift, "parity": parity, "shapes": shapes,
    "retry": retry, "obs": obs, "device": device, "clock": clock,
    "det": det, "args": args_registry, "guarded": guarded,
    "atomicity": atomicity,
}


def _pass_worker(job):
    """Run one pass in a worker process: (name, targets) ->
    (name, findings, sources, seconds). Module-level so the process
    pool can pickle it by reference."""
    name, targets = job
    t0 = time.perf_counter()
    findings, sources = _run_pass(name, targets)
    return name, findings, sources, round(time.perf_counter() - t0, 4)


def _changed_files(root: str, base: str) -> Optional[Set[str]]:
    """Absolute paths changed vs ``base`` (diff + untracked), or None when
    git is unavailable (callers fall back to the full run)."""
    changed: Set[str] = set()
    for args in (
        ["git", "diff", "--name-only", base],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                args, capture_output=True, text=True, cwd=root, timeout=30
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line:
                changed.add(os.path.abspath(os.path.join(root, line)))
    return changed


def _scope_targets(
    name: str, targets: List[str], changed: Set[str]
) -> List[str]:
    """The subset of a pass's targets --changed-only should run."""
    if name in _PAIR_PASSES:
        hit = False
        for t in targets:
            if os.path.isdir(t):
                hit = hit or any(c.startswith(t + os.sep) for c in changed)
            else:
                hit = hit or os.path.abspath(t) in changed
        return targets if hit else []
    out: List[str] = []
    for t in targets:
        for path in iter_py_files([t]):
            if os.path.abspath(path) in changed:
                out.append(path)
    return out


def _sarif(findings: List[Finding], properties: Optional[dict] = None) -> dict:
    """Minimal SARIF 2.1.0 document for the given (unsuppressed) findings."""
    rules_meta = all_rules()
    used = sorted({f.rule for f in findings})
    run = {
        "tool": {
            "driver": {
                # informationUri omitted: SARIF 2.1.0 requires an
                # absolute URI and this tool has no canonical URL
                "name": "karpenter-tpu-analysis",
                "rules": [
                    {
                        "id": rule,
                        "shortDescription": {
                            "text": rules_meta.get(rule, rule)
                        },
                    }
                    for rule in used
                ],
            }
        },
        "results": [
            {
                "ruleId": f.rule,
                "level": (
                    "error" if f.severity == Severity.ERROR
                    else "warning"
                ),
                "message": {"text": f.message},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {
                                "startLine": max(f.line, 1)
                            },
                        }
                    }
                ],
            }
            for f in sorted(
                findings, key=lambda f: (f.path, f.line, f.rule)
            )
        ],
    }
    if properties:
        # analyzer self-runtime rides in the run properties: the SARIF
        # artifact doubles as the BENCH-adjacent record that makes
        # analyzer-speed regressions visible across PRs
        run["properties"] = properties
    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [run],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.analysis",
        description="Static analysis of the PyTorch/CUDA port on the "
        "shared dataflow core: lock ordering, blocking calls, schema "
        "drift, kernel-twin parity, axis/dtype shapes (SHP6xx), retry "
        "hygiene, observability "
        "hygiene, host syncs (DTX9xx), clock "
        "discipline (CLK10xx), order discipline (DET11xx), kernel-arg "
        "registry consistency (ARG12xx), guarded-by inference "
        "(GRD13xx), and atomicity/lock-order (ATM14xx)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="override the selected pass's default targets "
        "(requires exactly one --pass)",
    )
    parser.add_argument(
        "--pass", dest="passes", action="append",
        choices=sorted(PASS_TARGETS),
        help="run only the named pass(es); default: all",
    )
    parser.add_argument(
        "--root", default=".",
        help="repo root the default targets are relative to",
    )
    parser.add_argument(
        "--baseline", default=DEFAULT_BASELINE,
        help=f"baseline file of tolerated findings (default: "
        f"{DEFAULT_BASELINE})",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline file (report everything)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write current findings to the baseline file and exit 0",
    )
    parser.add_argument(
        "--changed-only", action="store_true",
        help="scope file discovery to `git diff --name-only <--base>` "
        "plus untracked files (the presubmit fast lane); skips the "
        "stale-suppression audit",
    )
    parser.add_argument(
        "--base", default="HEAD",
        help="git ref --changed-only diffs against (default: HEAD)",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="force the full run (the default; overrides --changed-only)",
    )
    parser.add_argument(
        "--prune-baseline", action="store_true",
        help="run the full analysis, drop baseline entries matching no "
        "finding, rewrite the baseline, and exit 0",
    )
    parser.add_argument(
        "--format", choices=("text", "sarif"), default="text",
        help="finding output format (sarif: SARIF 2.1.0 JSON on stdout)",
    )
    parser.add_argument(
        "--jobs", type=int, default=1, metavar="N",
        help="run pass modules in an N-process pool (passes are "
        "independent file scans; 1 = in-process, the default)",
    )
    args = parser.parse_args(argv)

    selected = args.passes or sorted(PASS_TARGETS)
    if args.paths and len(selected) != 1:
        parser.error("explicit paths require exactly one --pass")
    if args.prune_baseline:
        # pruning needs the FULL finding set to judge staleness, and a
        # loaded baseline to prune — partial runs would silently prune
        # nothing, and --no-baseline would truncate every entry
        if args.no_baseline:
            parser.error("--prune-baseline conflicts with --no-baseline")
        if args.passes or args.paths or args.write_baseline:
            parser.error(
                "--prune-baseline requires the full run (no --pass, "
                "paths, or --write-baseline)"
            )
        args.changed_only = False  # force the full file set

    root = os.path.abspath(args.root)
    changed: Optional[Set[str]] = None
    if args.changed_only and not args.all and not args.paths:
        changed = _changed_files(root, args.base)
        if changed is None:
            print(
                "analysis: --changed-only needs git; running the full set",
                file=sys.stderr,
            )

    t_start = time.perf_counter()
    jobs: List = []
    for name in selected:
        if args.paths:
            targets = args.paths
        else:
            targets = [os.path.join(root, t) for t in PASS_TARGETS[name]]
            targets = [t for t in targets if os.path.exists(t)]
            if changed is not None:
                targets = _scope_targets(name, targets, changed)
            if not targets:
                continue
        jobs.append((name, targets))

    if args.jobs > 1 and len(jobs) > 1:
        # passes are independent file scans with picklable results; a
        # process pool turns sum-of-pass wall time into max-of-pass.
        # Results are reassembled in selection order, so output and exit
        # status are byte-identical to the sequential run.
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
            max_workers=min(args.jobs, len(jobs))
        ) as pool:
            results = list(pool.map(_pass_worker, jobs))
    else:
        results = [_pass_worker(job) for job in jobs]

    pass_seconds: Dict[str, float] = {}
    all_findings: List[Finding] = []
    all_sources: Dict[str, SourceFile] = {}
    # rule id -> abs paths its pass scanned (stale-audit accuracy gate)
    scanned_by_rule: Dict[str, Set[str]] = {}
    for name, findings, sources, seconds in results:
        pass_seconds[name] = seconds
        all_findings.extend(findings)
        all_sources.update(sources)
        for rule in getattr(PASS_MODULES[name], "RULES", {}):
            scanned_by_rule.setdefault(rule, set()).update(sources)

    # repo-relative paths in output and baseline keys
    def relativize(f: Finding) -> Finding:
        rel = os.path.relpath(f.path, root)
        if rel.startswith(".."):
            rel = f.path
        return Finding(f.rule, f.severity, rel, f.line, f.message)

    rel_sources = {}
    rel_scanned: Dict[str, Set[str]] = {}
    for path, src in all_sources.items():
        rel = os.path.relpath(path, root)
        rel_sources[rel if not rel.startswith("..") else path] = src
    for rule, paths in scanned_by_rule.items():
        rel_scanned[rule] = {
            os.path.relpath(p, root)
            if not os.path.relpath(p, root).startswith("..")
            else p
            for p in paths
        }
    all_findings = [relativize(f) for f in all_findings]

    baseline_path = (
        args.baseline
        if os.path.isabs(args.baseline)
        else os.path.join(root, args.baseline)
    )
    baseline = None if args.no_baseline else load_baseline(baseline_path)

    # stale-suppression audit: full runs only — staleness can only be
    # judged when every pass that could match a marker actually ran
    full_run = (
        not args.paths
        and changed is None
        and not args.passes
        and not args.write_baseline
    )
    stale_findings: List[Finding] = []
    stale_entries: Set = set()
    if full_run and not args.no_baseline:
        stale_findings, stale_entries = stale.audit(
            all_findings, rel_sources, baseline,
            os.path.relpath(baseline_path, root),
            scanned_by_rule=rel_scanned,
        )

    if args.prune_baseline:
        live = sorted((baseline or set()) - stale_entries)
        with open(baseline_path, "w", encoding="utf-8") as fh:
            fh.write(
                "# Static-analysis baseline: known findings tolerated by\n"
                "# `python -m karpenter_tpu_torch.analysis`. One per line,\n"
                "# RULE<TAB>path<TAB>message. Regenerate with "
                "--write-baseline;\n"
                "# prefer inline `# analysis: ignore[RULE] reason` for "
                "findings\n"
                "# that are intentionally safe.\n"
            )
            if not live:
                fh.write(
                    "#\n# Currently empty: every tolerated finding carries "
                    "an inline\n# suppression next to the code it "
                    "describes.\n"
                )
            for rule, fpath, message in live:
                fh.write(f"{rule}\t{fpath}\t{message}\n")
        print(
            f"analysis: pruned {len(stale_entries)} stale baseline "
            f"entr{'y' if len(stale_entries) == 1 else 'ies'}; "
            f"{len(live)} kept"
        )
        for f in stale_findings:
            if f.path != os.path.relpath(baseline_path, root):
                print(f.render())
        return 0

    remaining, suppressed_fs, sanctioned_fs = partition_findings(
        all_findings, rel_sources, baseline
    )
    remaining = remaining + stale_findings

    if args.write_baseline:
        # regenerate from the inline-filtered set only: filtering through
        # the existing baseline would drop still-needed grandfathered
        # entries from the rewritten file
        grandfather, _, _ = partition_findings(all_findings, rel_sources, None)
        write_baseline(baseline_path, grandfather)
        print(
            f"analysis: wrote {len(grandfather)} finding(s) to "
            f"{os.path.relpath(baseline_path, root)}"
        )
        return 0

    total_seconds = round(time.perf_counter() - t_start, 4)
    if args.format == "sarif":
        properties = {
            "analysisSeconds": total_seconds,
            "passSeconds": pass_seconds,
            # sum of per-pass seconds = the sequential-equivalent wall;
            # with --jobs > 1 the gap to analysisSeconds is the measured
            # pool speedup, recorded so it regresses visibly
            "sequentialSeconds": round(sum(pass_seconds.values()), 4),
            "jobs": args.jobs,
            "sanctionedSites": len(sanctioned_fs),
            "suppressedFindings": len(suppressed_fs),
            "changedOnly": changed is not None,
        }
        json.dump(_sarif(remaining, properties), sys.stdout, indent=2)
        print()
    else:
        for f in sorted(remaining, key=lambda f: (f.path, f.line, f.rule)):
            print(f.render())
    errors = [f for f in remaining if f.severity == Severity.ERROR]
    summary = f"analysis: {len(remaining)} finding(s)"
    if len(remaining) != len(errors):
        summary += f" ({len(remaining) - len(errors)} warning-only)"
    if suppressed_fs:
        summary += f" ({len(suppressed_fs)} suppressed)"
    if sanctioned_fs:
        summary += f" ({len(sanctioned_fs)} sanctioned boundary site(s))"
    summary += f" [{total_seconds:.2f}s"
    if changed is not None:
        summary += f", changed-only over {len(changed)} file(s)"
    summary += "]"
    print(summary, file=sys.stderr)
    # warnings (e.g. "pass skipped: PyYAML unavailable") inform but don't
    # fail presubmit; only error-severity findings gate
    return 1 if errors else 0
