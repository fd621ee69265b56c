# Copied from karpenter_tpu/metrics/registry.py.
"""Minimal labeled metrics registry.

Plays the role of the reference's prometheus metrics (pkg/metrics,
namespace "karpenter" — constants.go:27). Dependency-free: a dict-backed
registry with counters/gauges/histograms, a text exposition dump, and full
introspection for tests (the reference asserts metrics in its suites too).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Tuple

NAMESPACE = "karpenter_tpu"

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60
)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((labels or {}).items()))


class Metric:
    def __init__(self, name: str, help_text: str = "", registry: "Registry" = None):
        self.name = f"{NAMESPACE}_{name}" if not name.startswith(NAMESPACE) else name
        self.help = help_text
        self._lock = threading.Lock()
        (registry or REGISTRY).register(self)


class Counter(Metric):
    def __init__(self, name, help_text="", registry=None):
        super().__init__(name, help_text, registry)
        self._values: Dict[tuple, float] = {}

    def inc(self, labels: Optional[Dict[str, str]] = None, value: float = 1.0) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def collect(self):
        # snapshot under the lock: a concurrent inc() inserting a new
        # label key mid-iteration is a RuntimeError (GRD1301 dogfood)
        with self._lock:
            items = list(self._values.items())
        return [("counter", self.name, dict(k), v) for k, v in items]


class Gauge(Metric):
    def __init__(self, name, help_text="", registry=None):
        super().__init__(name, help_text, registry)
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def delete(self, labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values.pop(_label_key(labels), None)

    def delete_partial(self, labels: Dict[str, str]) -> None:
        """Drop every series whose labels are a superset (prometheus
        DeletePartialMatch)."""
        items = set(labels.items())
        with self._lock:
            for key in [k for k in self._values if items.issubset(set(k))]:
                del self._values[key]

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def collect(self):
        with self._lock:
            items = list(self._values.items())
        return [("gauge", self.name, dict(k), v) for k, v in items]


class Histogram(Metric):
    def __init__(self, name, help_text="", buckets: Iterable[float] = _DEFAULT_BUCKETS, registry=None):
        super().__init__(name, help_text, registry)
        self.buckets = sorted(buckets)
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}
        self._totals: Dict[tuple, int] = {}

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            idx = bisect.bisect_left(self.buckets, value)
            for i in range(idx, len(self.buckets)):
                counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        with self._lock:
            return self._totals.get(_label_key(labels), 0)

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._sums.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()

    def collect(self):
        with self._lock:
            pairs = [(k, self._totals[k], self._sums[k]) for k in self._totals]
        return [
            ("histogram", self.name, dict(k), {"count": total, "sum": s})
            for k, total, s in pairs
        ]


def _escape_label(v) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


# a single metric should never explode into unbounded label series (pod
# uids, node names as labels, ...): the guard test in tests/test_obs.py
# fails any metric whose series count crosses this after a full sim run
MAX_LABEL_SERIES = 64


class Registry:
    def __init__(self):
        self._metrics: List[Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: Metric) -> None:
        with self._lock:
            self._metrics.append(metric)

    def collect(self):
        # snapshot the metric list under the registry lock (a concurrent
        # register() grows it); each metric then snapshots its own series
        # under its own lock — registry -> metric is the one acquisition
        # order (render() below follows it too)
        with self._lock:
            metrics = list(self._metrics)
        out = []
        for m in metrics:
            out.extend(m.collect())
        return out

    def exposition(self) -> str:
        """Prometheus text format (for a /metrics endpoint)."""
        lines = []
        for kind, name, labels, value in self.collect():
            label_str = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            label_str = f"{{{label_str}}}" if label_str else ""
            if kind == "histogram":
                lines.append(f"{name}_count{label_str} {value['count']}")
                lines.append(f"{name}_sum{label_str} {value['sum']}")
            else:
                lines.append(f"{name}{label_str} {value}")
        return "\n".join(lines) + "\n"

    def render(self) -> str:
        """Full Prometheus text exposition (format 0.0.4): ``# HELP`` /
        ``# TYPE`` headers per metric family, histogram series expanded
        into cumulative ``_bucket{le=...}`` rows (``+Inf`` included) plus
        ``_sum``/``_count`` — the form real scrapers and promtool expect,
        unlike the test-oriented ``exposition()`` summary above."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            samples = m.collect()
            if not samples:
                continue
            kind = (
                "counter" if isinstance(m, Counter)
                else "gauge" if isinstance(m, Gauge)
                else "histogram"
            )
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {kind}")
            if isinstance(m, Histogram):
                with m._lock:
                    keys = list(m._totals)
                    counts = {k: list(m._counts[k]) for k in keys}
                    sums = dict(m._sums)
                    totals = dict(m._totals)
                for key in keys:
                    labels = dict(key)
                    for le, cum in zip(m.buckets, counts[key]):
                        le_pair = 'le="%s"' % le
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_label_str(labels, le_pair)} {cum}"
                        )
                    inf_pair = 'le="+Inf"'
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_label_str(labels, inf_pair)} {totals[key]}"
                    )
                    lines.append(
                        f"{m.name}_sum{_label_str(labels)} {sums[key]}"
                    )
                    lines.append(
                        f"{m.name}_count{_label_str(labels)} {totals[key]}"
                    )
            else:
                for _kind, name, labels, value in samples:
                    lines.append(f"{name}{_label_str(labels)} {value}")
        return "\n".join(lines) + "\n"

    def dump(self, path: str) -> None:
        """Write the full text exposition to ``path`` (operator shutdown
        and the sim harness flush final metric state through this)."""
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(self.render())

    def series_counts(self) -> Dict[str, int]:
        """{metric name: live label-series count} — the input to the
        cardinality guard."""
        out: Dict[str, int] = {}
        for _kind, name, _labels, _value in self.collect():
            out[name] = out.get(name, 0) + 1
        return out

    def check_cardinality(
        self,
        bound: int = MAX_LABEL_SERIES,
        exempt: Tuple[str, ...] = (),
    ) -> Dict[str, int]:
        """Metrics whose series count exceeds ``bound`` (empty = healthy).
        A nonempty result means some label carries unbounded identity
        (pod uid, node name) and would blow up a real scrape. ``exempt``
        lists name prefixes excluded from the check — the per-node/per-pod
        gauges mirror the reference's identity-labeled metrics and scale
        with cluster size BY DESIGN; everything else must stay bounded."""
        return {
            name: n
            for name, n in self.series_counts().items()
            if n > bound and not any(name.startswith(p) for p in exempt)
        }


REGISTRY = Registry()
