# Copied from karpenter_tpu/analysis/findings.py.
"""Finding type, severities, and the inline-marker/baseline channels.

A finding is dropped from the gating set through one of three channels:

- an inline **suppression**::

      risky_call()  # analysis: ignore[LCK202] informer handlers are our own

  on the flagged line or the line directly above it — "the rule cannot
  see why this is safe here";

- an inline **sanction**::

      out = jax.device_get(raw)  # analysis: sanctioned[DTX906] decode boundary

  same placement, different meaning: the flagged operation is a
  *documented, audited boundary crossing* (a blessed host-sync point, a
  real-wall-time diagnostic). Sanctions are not suppressions — the CLI
  counts them separately, the device/clock passes treat the crossing as
  legitimate downstream, and PARITY.md's device-residency contract is
  the list of them. Widening the sanctioned set is a reviewed API
  change, not a lint chore;

- a **baseline** entry (hack/analysis_baseline.txt): tab-separated
  ``RULE<TAB>path<TAB>message``, matched line-number-insensitively so
  unrelated edits don't churn the file.

The stale-suppression audit (stale.py, CLI ``--prune-baseline``) flags
entries and markers in any channel that no longer match a produced
finding.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


class Severity:
    ERROR = "error"
    WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    rule: str  # e.g. TRC101
    severity: str  # Severity.*
    path: str  # repo-relative when produced by the CLI
    line: int  # 1-based; 0 when the finding has no single line
    message: str

    def render(self) -> str:
        return f"{self.severity}[{self.rule}] {self.path}:{self.line}: {self.message}"

    def baseline_key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.message)


# both comment dialects: `# analysis: ...` (Python) and `// analysis: ...`
# (the C++ kernel twin scanned by parity.py); `ignore` suppresses,
# `sanctioned` marks a documented boundary crossing
_MARKER_RE = re.compile(
    r"(?:#|//)\s*analysis:\s*(ignore|sanctioned)\[([A-Z0-9,\s]+)\]"
)
# real rule ids always carry a number (TRC101, DTX906, STALE001); bare
# uppercase words are documentation placeholders (`ignore[RULE]`), not
# markers — without this the stale audit flags its own docstrings
_RULE_ID_RE = re.compile(r"^[A-Z]+[0-9]+$")


@dataclass(frozen=True)
class Marker:
    """One inline marker as written: its line, dialect, and rule set."""

    line: int
    dialect: str  # "ignore" | "sanctioned"
    rules: frozenset

    def covers(self, line: int) -> bool:
        """A marker reaches its own line and the line below (so block
        statements like ``with`` can carry it above the flagged call)."""
        return line in (self.line, self.line + 1)


def inline_markers(source_lines: Sequence[str]) -> List[Marker]:
    out: List[Marker] = []
    for i, text in enumerate(source_lines, start=1):
        m = _MARKER_RE.search(text)
        if not m:
            continue
        rules = frozenset(
            r.strip()
            for r in m.group(2).split(",")
            if _RULE_ID_RE.match(r.strip())
        )
        if rules:
            out.append(Marker(line=i, dialect=m.group(1), rules=rules))
    return out


def inline_suppressions(source_lines: Sequence[str]) -> dict:
    """{line_number: {rules}} for every inline ignore marker (legacy
    view; sanctions not included)."""
    out: dict = {}
    for marker in inline_markers(source_lines):
        if marker.dialect != "ignore":
            continue
        out.setdefault(marker.line, set()).update(marker.rules)
        out.setdefault(marker.line + 1, set()).update(marker.rules)
    return out


def load_baseline(path: str) -> Set[Tuple[str, str, str]]:
    entries: Set[Tuple[str, str, str]] = set()
    try:
        with open(path, encoding="utf-8") as fh:
            for raw in fh:
                line = raw.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                parts = line.split("\t", 2)
                if len(parts) == 3:
                    entries.add((parts[0], parts[1], parts[2]))
    except OSError:
        pass
    return entries


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    keys = sorted({f.baseline_key() for f in findings})
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(
            "# Static-analysis baseline: known findings tolerated by\n"
            "# `python -m karpenter_tpu.analysis`. One per line,\n"
            "# RULE<TAB>path<TAB>message. Regenerate with --write-baseline;\n"
            "# prefer inline `# analysis: ignore[RULE] reason` for findings\n"
            "# that are intentionally safe.\n"
        )
        for rule, fpath, message in keys:
            fh.write(f"{rule}\t{fpath}\t{message}\n")


@dataclass
class SourceFile:
    """Parsed-source handle shared by the passes (one read per file)."""

    path: str
    text: str
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.text.splitlines()
        self.markers: List[Marker] = inline_markers(self.lines)

    def _covered(self, line: int, rule: str, dialect: str) -> bool:
        return any(
            m.dialect == dialect and rule in m.rules and m.covers(line)
            for m in self.markers
        )

    def suppressed(self, line: int, rule: str) -> bool:
        return self._covered(line, rule, "ignore")

    def sanctioned(self, line: int, rule: str) -> bool:
        return self._covered(line, rule, "sanctioned")


def partition_findings(
    findings: Iterable[Finding],
    sources: Optional[dict] = None,
    baseline: Optional[Set[Tuple[str, str, str]]] = None,
) -> Tuple[List[Finding], List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed, sanctioned).

    ``sources`` maps finding.path -> SourceFile (for inline markers).
    Suppressed covers baseline entries and inline ignores; sanctioned
    covers inline sanction markers (the documented boundary crossings).
    """
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    sanctioned: List[Finding] = []
    for f in findings:
        if baseline and f.baseline_key() in baseline:
            suppressed.append(f)
            continue
        src = (sources or {}).get(f.path)
        if src is not None and src.suppressed(f.line, f.rule):
            suppressed.append(f)
            continue
        if src is not None and src.sanctioned(f.line, f.rule):
            sanctioned.append(f)
            continue
        kept.append(f)
    return kept, suppressed, sanctioned


def filter_suppressed(
    findings: Iterable[Finding],
    sources: Optional[dict] = None,
    baseline: Optional[Set[Tuple[str, str, str]]] = None,
) -> List[Finding]:
    """Findings not covered by an inline marker (either dialect) or the
    baseline."""
    return partition_findings(findings, sources, baseline)[0]
