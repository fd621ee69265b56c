# Copied from karpenter_tpu/sim/slo.py, 7 lines changed: the oracle pack builds its solver from the caller's SolverConfig (SLOWall's solver_config), 1 comment line reworded.
"""The twin's SLO wall: per-simulated-minute assertions over artifacts.

Every SLO reads an artifact the control plane already produces — never a
twin-private side channel — so a wall violation always names evidence an
operator could pull from a live cluster (see PARITY.md "Cluster-twin SLO
wall" for the SLO → artifact mapping):

- **p99 decision latency** — the audit trail's per-minute window of
  decision records (obs.AUDIT.window), joined to the twin's wall-clock
  sampler (AuditLog.on_record). Under replay the records' own
  ``duration_ms`` rides the injected clock (deterministic, part of the
  byte-identical contract), so the wall-clock joins live OUTSIDE the
  records.
- **zero overcommit** — the guard verdicts on the same records, plus a
  direct store sweep (no node holds more than its allocatable).
- **fallback_solves == 0** — no window record on the "oracle"/"dropped"
  rung, and the provisioner's scheduler_sequential_fallback_total
  counter did not advance.
- **no orphaned claims** — registered, non-deleting NodeClaims from
  before the window all have live cloud instances.
- **bounded delta fallbacks** — solver_delta_fallbacks_total advanced at
  most ``max_delta_fallbacks`` in the window.
- **cost vs host oracle** — the live fleet's offering-price sum against
  a from-scratch host-oracle pack of the same workload, on the minutes
  ``cost_check_every`` selects (the oracle pack is O(pods × nodes) host
  work — day-scale replays sample it, they don't pay it per minute). A
  cheap per-minute sanity bound (fleet price vs a resource lower bound)
  runs every minute regardless.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..api import labels as labels_mod
from ..api import resources as res
from ..api.objects import Node, NodeClaim, Pod
from ..utils import pod as pod_utils


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, math.ceil(len(ordered) * p / 100.0))
    return ordered[rank - 1]


@dataclass
class SLOConfig:
    """The wall's thresholds. The defaults describe the tier-1 scaled
    replay; the day-scale soak and the smoke override per scale."""

    p99_decision_latency_ms: float = 5000.0
    # fleet price <= (1 + bound) * host-oracle pack price, on sampled
    # minutes. The oracle packs at 100% density onto the globally
    # cheapest shapes; a live fleet holds headroom and type diversity,
    # so parity is structurally impossible — the bound polices drift
    # (runaway growth, consolidation regressions), not the headroom
    max_cost_vs_oracle: float = 1.0
    cost_check_every: int = 0  # minutes between oracle packs; 0 disables
    # every minute: fleet price <= this multiple of the resource lower
    # bound (a runaway-fleet tripwire, deliberately loose — fragmentation
    # and shape mismatch legitimately cost over the LP-ish bound)
    max_cost_vs_lower_bound: float = 6.0
    max_delta_fallbacks: int = 2
    # claims younger than this are still launching and exempt from the
    # orphan sweep (provider create + registration take real reconciles)
    orphan_grace_s: float = 120.0


@dataclass
class SLOViolation:
    minute: int
    slo: str
    detail: str


@dataclass
class MinuteReport:
    """One simulated minute's SLO wall evaluation."""

    minute: int
    records: int
    p99_latency_ms: float
    max_latency_ms: float
    fallback_solves: int
    delta_fallbacks: int
    guard_bad: int
    overcommitted: int
    orphaned: int
    fleet_price: float
    cost_lower_bound: float
    oracle_price: Optional[float] = None
    violations: List[SLOViolation] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "minute": self.minute,
            "records": self.records,
            "p99_latency_ms": round(self.p99_latency_ms, 3),
            "max_latency_ms": round(self.max_latency_ms, 3),
            "fallback_solves": self.fallback_solves,
            "delta_fallbacks": self.delta_fallbacks,
            "guard_bad": self.guard_bad,
            "overcommitted": self.overcommitted,
            "orphaned": self.orphaned,
            "fleet_price": round(self.fleet_price, 4),
            "cost_lower_bound": round(self.cost_lower_bound, 4),
            "oracle_price": (
                round(self.oracle_price, 4)
                if self.oracle_price is not None
                else None
            ),
            "violations": [
                {"slo": v.slo, "detail": v.detail} for v in self.violations
            ],
        }


class SLOViolationError(AssertionError):
    """A minute failed the wall; carries the full MinuteReport."""

    def __init__(self, report: MinuteReport):
        self.report = report
        lines = "; ".join(f"{v.slo}: {v.detail}" for v in report.violations)
        super().__init__(
            f"SLO wall violated at simulated minute {report.minute}: {lines}"
        )


# -- artifact sweeps ---------------------------------------------------------


def overcommitted_nodes(client) -> List[str]:
    """Nodes holding more than their allocatable — the invariant a
    guard-rejected solve must never commit (same sweep as the chaos
    soak's per-tick assert)."""
    pods = client.list(Pod)
    by_node: Dict[str, list] = {}
    for p in pods:
        if p.spec.node_name and pod_utils.is_active(p):
            by_node.setdefault(p.spec.node_name, []).append(p.spec.requests)
    bad = []
    for node in client.list(Node):
        reqs = by_node.get(node.name)
        total = res.merge(*reqs) if reqs else {}
        if not res.fits(total, node.status.allocatable):
            bad.append(node.name)
    return bad


def orphaned_claims(client, provider, now: float, grace_s: float) -> List[str]:
    """Registered NodeClaims with a provider id, not deleting, older than
    the grace window, whose cloud instance is gone. Garbage collection
    runs every roster step, so at a minute boundary this set is empty in
    a healthy replay — a lingering member means the reap path lost it."""
    live_pids = {c.status.provider_id for c in provider.list()}
    out = []
    for claim in client.list(NodeClaim):
        pid = claim.status.provider_id
        if not pid or pid in live_pids:
            continue
        if claim.metadata.deletion_timestamp is not None:
            continue
        created = claim.metadata.creation_timestamp or now
        if now - created < grace_s:
            continue
        out.append(claim.name)
    return out


def _catalog(provider, client) -> list:
    from ..api.objects import NodePool

    seen: Dict[str, object] = {}
    for pool in client.list(NodePool):
        for it in provider.get_instance_types(pool):
            seen.setdefault(it.name, it)
    return list(seen.values())


def fleet_price(client, provider) -> float:
    """The live fleet's per-hour offering price: for every registered
    Node, the price of the (instance type, zone, capacity type) offering
    its labels name."""
    types = {it.name: it for it in _catalog(provider, client)}
    total = 0.0
    for node in client.list(Node):
        it = types.get(node.metadata.labels.get(labels_mod.INSTANCE_TYPE, ""))
        if it is None:
            continue
        zone = node.metadata.labels.get(labels_mod.TOPOLOGY_ZONE, "")
        ct = node.metadata.labels.get(labels_mod.CAPACITY_TYPE_LABEL_KEY, "")
        for o in it.offerings:
            if o.zone() == zone and o.capacity_type() == ct:
                total += o.price
                break
    return total


def cost_lower_bound(client, provider) -> float:
    """A cheap true lower bound on any feasible fleet's price: total
    requested cpu/memory across active pods, each priced at the best
    $/unit over the catalog's available offerings. No packing, O(pods +
    catalog) — affordable every simulated minute at day scale."""
    cpu_total = 0.0
    mem_total = 0.0
    for p in client.list(Pod):
        if not pod_utils.is_active(p) and not pod_utils.is_provisionable(p):
            continue
        cpu_total += float(p.spec.requests.get(res.CPU, 0))
        mem_total += float(p.spec.requests.get(res.MEMORY, 0))
    best_cpu = None
    best_mem = None
    for it in _catalog(provider, client):
        price = min(
            (o.price for o in it.offerings if o.available), default=None
        )
        if price is None:
            continue
        cpu = float(it.capacity.get(res.CPU, 0))
        mem = float(it.capacity.get(res.MEMORY, 0))
        if cpu > 0:
            rate = price / cpu
            best_cpu = rate if best_cpu is None else min(best_cpu, rate)
        if mem > 0:
            rate = price / mem
            best_mem = rate if best_mem is None else min(best_mem, rate)
    bound = 0.0
    if best_cpu is not None:
        bound = max(bound, cpu_total * best_cpu)
    if best_mem is not None:
        bound = max(bound, mem_total * best_mem)
    return bound


def oracle_pack_price(client, provider, solver_config=None) -> Optional[float]:
    """Host-oracle reference cost: pack every active pod from scratch on
    an empty cluster with the exact host scheduler and price the result.
    Bypasses TorchSolver.solve so the reference pack never lands in the
    audit trail (it is measurement, not a committed decision). Returns
    None when the pack cannot place every pod (the bound would be
    meaningless)."""
    from ..controllers.state import Cluster
    from ..controllers.disruption.helpers import _build_simulation_solver

    pods = []
    for p in client.list(Pod):
        if p.spec.volumes:
            continue  # zonal-volume injection needs per-sim deep copies
        if pod_utils.is_active(p) or pod_utils.is_provisionable(p):
            q = copy.deepcopy(p)
            q.spec.node_name = ""
            pods.append(q)
    if not pods:
        return 0.0
    solver = _build_simulation_solver(
        client, Cluster(client), provider, [], pods,
        solver_config=solver_config,
    )
    results = solver.oracle.solve(pods)
    if results.pod_errors:
        return None
    return results.total_price()


# -- the wall ----------------------------------------------------------------

_BAD_RUNGS = ("oracle", "dropped")


class SLOWall:
    """Evaluates one simulated minute against :class:`SLOConfig`.

    The caller (the twin) supplies the per-minute artifacts: the audit
    window's records, the wall-clock latency samples joined to them, and
    the window deltas of the fallback counters. The wall adds the store
    sweeps (overcommit, orphans, cost) itself."""

    def __init__(self, config: Optional[SLOConfig] = None, solver_config=None):
        self.config = config or SLOConfig()
        self.solver_config = solver_config

    def evaluate(
        self,
        minute: int,
        client,
        provider,
        now: float,
        records,
        latencies_ms: Sequence[float],
        fallback_delta: int,
        delta_fallback_delta: int,
    ) -> MinuteReport:
        cfg = self.config
        violations: List[SLOViolation] = []

        p99 = percentile(latencies_ms, 99)
        if p99 > cfg.p99_decision_latency_ms:
            violations.append(
                SLOViolation(
                    minute, "p99-decision-latency",
                    f"p99 {p99:.1f} ms > {cfg.p99_decision_latency_ms} ms "
                    f"over {len(latencies_ms)} decisions",
                )
            )

        guard_bad = [r for r in records if r.guard not in ("ok", "untracked")]
        if guard_bad:
            violations.append(
                SLOViolation(
                    minute, "guard-verdicts",
                    f"{len(guard_bad)} non-ok guard verdicts "
                    f"(first: {guard_bad[0].decision_id} "
                    f"{guard_bad[0].guard!r})",
                )
            )

        over = overcommitted_nodes(client)
        if over:
            violations.append(
                SLOViolation(
                    minute, "zero-overcommit",
                    f"{len(over)} overcommitted nodes (first: {over[0]})",
                )
            )

        bad_rung = [r for r in records if r.rung in _BAD_RUNGS]
        if bad_rung or fallback_delta:
            violations.append(
                SLOViolation(
                    minute, "fallback-solves",
                    f"{len(bad_rung)} records off the kernel rungs, "
                    f"sequential-fallback counter +{fallback_delta}",
                )
            )

        orphans = orphaned_claims(client, provider, now, cfg.orphan_grace_s)
        if orphans:
            violations.append(
                SLOViolation(
                    minute, "no-orphaned-claims",
                    f"{len(orphans)} orphaned claims (first: {orphans[0]})",
                )
            )

        if delta_fallback_delta > cfg.max_delta_fallbacks:
            violations.append(
                SLOViolation(
                    minute, "delta-fallbacks",
                    f"solver_delta_fallbacks_total +{delta_fallback_delta} "
                    f"> {cfg.max_delta_fallbacks} per minute",
                )
            )

        price = fleet_price(client, provider)
        lb = cost_lower_bound(client, provider)
        if lb > 0 and price > cfg.max_cost_vs_lower_bound * lb:
            violations.append(
                SLOViolation(
                    minute, "cost-lower-bound",
                    f"fleet price {price:.2f} > "
                    f"{cfg.max_cost_vs_lower_bound}x lower bound {lb:.2f}",
                )
            )

        oracle_price = None
        if cfg.cost_check_every and (minute + 1) % cfg.cost_check_every == 0:
            oracle_price = oracle_pack_price(client, provider, self.solver_config)
            if (
                oracle_price is not None
                and oracle_price > 0
                and price > (1.0 + cfg.max_cost_vs_oracle) * oracle_price
            ):
                violations.append(
                    SLOViolation(
                        minute, "cost-vs-oracle",
                        f"fleet price {price:.2f} > "
                        f"(1+{cfg.max_cost_vs_oracle}) x oracle pack "
                        f"{oracle_price:.2f}",
                    )
                )

        return MinuteReport(
            minute=minute,
            records=len(records),
            p99_latency_ms=p99,
            max_latency_ms=max(latencies_ms, default=0.0),
            fallback_solves=fallback_delta + len(bad_rung),
            delta_fallbacks=delta_fallback_delta,
            guard_bad=len(guard_bad),
            overcommitted=len(over),
            orphaned=len(orphans),
            fleet_price=price,
            cost_lower_bound=lb,
            oracle_price=oracle_price,
            violations=violations,
        )


__all__ = [
    "SLOConfig", "SLOViolation", "SLOViolationError", "MinuteReport",
    "SLOWall", "percentile", "overcommitted_nodes", "orphaned_claims",
    "fleet_price", "cost_lower_bound", "oracle_pack_price",
]
