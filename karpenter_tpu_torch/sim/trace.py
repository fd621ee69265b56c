# Copied from karpenter_tpu/sim/trace.py, 1 comment line reworded.
"""Churn traces: the recorded event stream a cluster twin replays.

A trace is an ordered sequence of timestamped cluster events — the
external world's side of a day of cluster life: workload churn (pod
creates/deletes), workload drift (label flips), cloud weather (spot
reclaims, insufficient-capacity waves), and node drift (allocatable
capacity edits). The twin (sim/twin.py) replays a trace against the full
operator roster on the injected clock; the fault plans of the
``FaultInjector`` interleave with it at the instrumented seams.

Schema — one JSON object per line (JSONL), sorted by ``t``:

    {"t": <seconds from twin start>, "kind": <event kind>, ...payload}

Event kinds and payload fields:

    pod-create     name, count, cpu_m, mem_mi, labels
    pod-delete     name
    label-flip     name, key, value        (pod label mutation)
    spot-reclaim   count                   (cloud terminates N spot nodes)
    ice-wave       count, ttl              (N offering cells go ICE)
    capacity-edit  scale                   (one node's allocatable drifts)

Runtime-dependent selection (WHICH spot node is reclaimed, WHICH
offering cells go dark, WHICH node's capacity drifts) happens in the
twin against live cluster state, drawn from the twin's own seeded RNG —
the RNG state is part of the twin checkpoint, so replay and resume stay
deterministic (see README "Cluster twin", seed discipline).

Traces serialize canonically: ``dump_jsonl`` emits sorted-key JSON with
defaults omitted, so a trace file is byte-stable for a given event list.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

POD_CREATE = "pod-create"
POD_DELETE = "pod-delete"
LABEL_FLIP = "label-flip"
SPOT_RECLAIM = "spot-reclaim"
ICE_WAVE = "ice-wave"
CAPACITY_EDIT = "capacity-edit"

EVENT_KINDS = (
    POD_CREATE, POD_DELETE, LABEL_FLIP, SPOT_RECLAIM, ICE_WAVE,
    CAPACITY_EDIT,
)


@dataclass
class TraceEvent:
    """One timestamped churn event. Only the fields meaningful for the
    event's ``kind`` are set; the rest keep their defaults and are
    omitted from the serialized form."""

    t: float
    kind: str
    name: str = ""
    count: int = 0
    cpu_m: int = 0
    mem_mi: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    key: str = ""
    value: str = ""
    scale: float = 0.0
    ttl: float = 0.0

    def to_dict(self) -> dict:
        out: Dict[str, object] = {"t": round(self.t, 3), "kind": self.kind}
        for f, default in (
            ("name", ""), ("count", 0), ("cpu_m", 0), ("mem_mi", 0),
            ("key", ""), ("value", ""), ("scale", 0.0), ("ttl", 0.0),
        ):
            v = getattr(self, f)
            if v != default:
                out[f] = v
        if self.labels:
            out["labels"] = dict(sorted(self.labels.items()))
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        if d.get("kind") not in EVENT_KINDS:
            raise ValueError(f"unknown trace event kind: {d.get('kind')!r}")
        return cls(
            t=float(d["t"]),
            kind=d["kind"],
            name=d.get("name", ""),
            count=int(d.get("count", 0)),
            cpu_m=int(d.get("cpu_m", 0)),
            mem_mi=int(d.get("mem_mi", 0)),
            labels=dict(d.get("labels", {})),
            key=d.get("key", ""),
            value=d.get("value", ""),
            scale=float(d.get("scale", 0.0)),
            ttl=float(d.get("ttl", 0.0)),
        )


def dump_jsonl(events: Sequence[TraceEvent]) -> str:
    """Canonical JSONL form (sorted keys, defaults omitted, t-ordered)."""
    ordered = sorted(events, key=lambda e: e.t)
    return "".join(
        json.dumps(e.to_dict(), sort_keys=True) + "\n" for e in ordered
    )


def write_jsonl(events: Sequence[TraceEvent], path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(dump_jsonl(events))


def read_jsonl(path: str) -> List[TraceEvent]:
    events: List[TraceEvent] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(TraceEvent.from_dict(json.loads(line)))
    events.sort(key=lambda e: e.t)
    return events


@dataclass
class ChurnProfile:
    """Knobs for the seeded trace generator — per-minute churn rates and
    the placement of the fault-shaped waves. Defaults describe a busy but
    survivable cluster minute; the day-scale soak scales ``minutes`` up
    and leaves the rates alone."""

    minutes: int = 10
    # steady churn: this many pod create events per minute, each later
    # paired with a delete of an earlier churn pod (bounded working set)
    pods_per_minute: int = 6
    churn_pod_cap: int = 60  # live churn pods before deletes keep pace
    label_flips_per_minute: int = 1
    capacity_edits_per_minute: int = 1
    # cloud weather: minute -> wave size; empty tuples disable
    reclaim_minutes: Tuple[int, ...] = (3,)
    reclaim_count: int = 2
    ice_minutes: Tuple[int, ...] = (5,)
    ice_cells: int = 6
    ice_ttl: float = 240.0
    # churn pod shapes (cpu millicores, memory MiB)
    pod_shapes: Tuple[Tuple[int, int], ...] = (
        (250, 512), (500, 1024), (1000, 2048), (2000, 4096),
    )


def generate(seed: int, profile: Optional[ChurnProfile] = None) -> List[TraceEvent]:
    """Deterministic churn trace for ``profile``: same seed, same profile
    — byte-identical trace (``dump_jsonl``). Pod deletes and label flips
    only ever reference pods this trace created, so a generated trace is
    self-consistent against any base cluster."""
    profile = profile or ChurnProfile()
    rng = random.Random(seed)
    events: List[TraceEvent] = []
    live: List[str] = []  # churn pods created and not yet deleted
    pod_seq = 0
    for minute in range(profile.minutes):
        base_t = minute * 60.0
        # flips draw at any offset within the minute, so they may only
        # target pods that existed BEFORE the minute started — a flip
        # timestamped ahead of its target's create would break the
        # trace's t-ordered self-consistency
        flippable = list(live)
        offsets = sorted(
            rng.uniform(0.0, 59.0)
            for _ in range(profile.pods_per_minute)
        )
        for off in offsets:
            pod_seq += 1
            cpu_m, mem_mi = profile.pod_shapes[
                rng.randrange(len(profile.pod_shapes))
            ]
            name = f"churn-{pod_seq}"
            events.append(
                TraceEvent(
                    t=base_t + off,
                    kind=POD_CREATE,
                    name=name,
                    count=1,
                    cpu_m=cpu_m,
                    mem_mi=mem_mi,
                    labels={"ktpu.io/churn": "true"},
                )
            )
            live.append(name)
            if len(live) > profile.churn_pod_cap:
                victim = live.pop(rng.randrange(len(live)))
                events.append(
                    TraceEvent(
                        t=base_t + min(off + rng.uniform(1.0, 10.0), 59.9),
                        kind=POD_DELETE,
                        name=victim,
                    )
                )
        live_set = set(live)
        for _ in range(profile.label_flips_per_minute):
            candidates = [n for n in flippable if n in live_set]
            if not candidates:
                break
            target = candidates[rng.randrange(len(candidates))]
            events.append(
                TraceEvent(
                    t=base_t + rng.uniform(0.0, 59.0),
                    kind=LABEL_FLIP,
                    name=target,
                    key="ktpu.io/epoch",
                    value=str(rng.randrange(1 << 16)),
                )
            )
        for _ in range(profile.capacity_edits_per_minute):
            events.append(
                TraceEvent(
                    t=base_t + rng.uniform(0.0, 59.0),
                    kind=CAPACITY_EDIT,
                    scale=round(rng.uniform(0.9, 1.0), 3),
                )
            )
        if minute in profile.reclaim_minutes:
            events.append(
                TraceEvent(
                    t=base_t + rng.uniform(0.0, 30.0),
                    kind=SPOT_RECLAIM,
                    count=profile.reclaim_count,
                )
            )
        if minute in profile.ice_minutes:
            events.append(
                TraceEvent(
                    t=base_t + rng.uniform(0.0, 30.0),
                    kind=ICE_WAVE,
                    count=profile.ice_cells,
                    ttl=profile.ice_ttl,
                )
            )
    events.sort(key=lambda e: e.t)
    return events


__all__ = [
    "TraceEvent", "ChurnProfile", "generate",
    "dump_jsonl", "write_jsonl", "read_jsonl",
    "POD_CREATE", "POD_DELETE", "LABEL_FLIP", "SPOT_RECLAIM", "ICE_WAVE",
    "CAPACITY_EDIT", "EVENT_KINDS",
]
