# Copied from karpenter_tpu/analysis/stale.py.
"""Stale-suppression audit (STALE001).

Suppressions and sanctions rot: the finding they covered gets fixed, the
code moves, the rule gets smarter (the TRC/RTY dataflow migration is
exactly that), and the marker stays behind — a hole a future regression
walks straight through. This audit flags every tolerance that no longer
tolerates anything:

- a baseline entry (hack/analysis_baseline.txt) matching no produced
  finding;
- an inline ``# analysis: ignore[RULE]`` or ``sanctioned[RULE]`` marker
  whose (line, rule) reach covers no produced finding — including rules
  that no longer exist.

Accuracy requires the producing passes to have RUN on the marker's file,
so the CLI only audits on full runs (every pass, no ``--changed-only``)
and only treats a marker rule as stale when the pass owning that rule
actually scanned the file. ``--prune-baseline`` rewrites the baseline
with the stale entries dropped; stale inline markers are reported for
manual deletion (they carry prose a tool shouldn't silently discard).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import Finding, Severity, SourceFile

RULES = {
    "STALE001": "suppression/sanction no longer matches any finding",
}


def audit(
    findings: Iterable[Finding],
    sources: Dict[str, SourceFile],
    baseline: Optional[Set[Tuple[str, str, str]]],
    baseline_path: str,
    scanned_by_rule: Optional[Dict[str, Set[str]]] = None,
) -> Tuple[List[Finding], Set[Tuple[str, str, str]]]:
    """(STALE001 findings, the stale baseline entries).

    ``findings`` is the PRE-filter set (suppressed and sanctioned ones
    included — a marker that still matches its finding is live).
    ``scanned_by_rule`` maps rule id -> set of paths the owning pass
    scanned; marker rules whose pass never saw the file are skipped
    (unknown rule ids are always stale).
    """
    produced_keys = {f.baseline_key() for f in findings}
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)

    out: List[Finding] = []
    stale_entries: Set[Tuple[str, str, str]] = set()
    for entry in sorted(baseline or ()):
        if entry not in produced_keys:
            stale_entries.add(entry)
            rule, path, message = entry
            out.append(
                Finding(
                    "STALE001", Severity.ERROR, baseline_path, 0,
                    f"baseline entry matches no finding: {rule} at {path} "
                    f"({message[:60]!r}); prune with --prune-baseline",
                )
            )

    for path in sorted(sources):
        src = sources[path]
        path_findings = by_path.get(path, [])
        for marker in src.markers:
            for rule in sorted(marker.rules):
                if (
                    scanned_by_rule is not None
                    and rule in scanned_by_rule
                    and path not in scanned_by_rule[rule]
                ):
                    continue  # owning pass didn't scan this file
                # a rule id no pass ships falls through to the liveness
                # check and is always stale (no finding can ever match)
                live = any(
                    f.rule == rule and marker.covers(f.line)
                    for f in path_findings
                )
                if not live:
                    out.append(
                        Finding(
                            "STALE001", Severity.ERROR, path, marker.line,
                            f"inline {marker.dialect}[{rule}] matches no "
                            "finding on its line or the line below; "
                            "delete the marker",
                        )
                    )
    return out, stale_entries


__all__ = ["RULES", "audit"]
