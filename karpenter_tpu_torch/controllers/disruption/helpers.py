# Copied from karpenter_tpu/controllers/disruption/helpers.py, 11 lines changed: TpuSolver renamed TorchSolver, the backend check against the port's "kernels", 3 comment lines reworded.
"""Shared disruption machinery: candidates, budgets, scheduling simulation.

Mirror of the reference's disruption/helpers.go (SimulateScheduling:49-117,
GetCandidates:148-165, BuildDisruptionBudgetMapping:201-249) and the budget
windows in nodepool.go:296-367.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence

from ... import obs
from ...api import labels as labels_mod
from ...api.objects import (
    Budget,
    COND_CONSOLIDATABLE,
    COND_DRIFTED,
    COND_INITIALIZED,
    Node,
    NodeClaim,
    NodePool,
    Pod,
)
from ...scheduling.scheduler import Results
from ...scheduling.topology import Topology
from ...scheduling.volumetopology import VolumeTopology
from ...scheduling.volumeusage import VolumeResolver
from ...solver.driver import Scenario, TorchSolver
from ...utils import pod as pod_utils
from ...utils.pdb import Limits
from ..state import Cluster, StateNode
from .types import Candidate, lifetime_remaining, rescheduling_cost

ALL_REASONS = ("Underutilized", "Empty", "Drifted")


def get_candidates(
    client,
    cluster: Cluster,
    cloud_provider,
    clock,
    condition: Optional[str] = None,
    queue=None,
) -> List[Candidate]:
    """Disruptable state nodes, optionally gated on a status condition
    (helpers.go:148-165)."""
    pdb_limits = Limits.from_client(client)
    now = clock.now()
    pools = {np_.name: np_ for np_ in client.list(NodePool)}
    out = []
    for sn in cluster.nodes():
        if queue is not None and queue.has_provider_id(sn.provider_id):
            continue
        err = sn.disruptable_error(pdb_limits, now)
        if err is not None:
            continue
        claim = sn.node_claim
        node = sn.node
        if claim is None or node is None:
            continue
        if not claim.conds().is_true(COND_INITIALIZED):
            continue
        if condition is not None and not claim.conds().is_true(condition):
            continue
        pool = pools.get(claim.nodepool_name)
        if pool is None:
            continue
        instance_type = _instance_type_of(cloud_provider, pool, claim)
        price = _candidate_price(instance_type, node)
        pods = sn.reschedulable_pods()
        out.append(
            Candidate(
                state_node=sn,
                node=node,
                node_claim=claim,
                node_pool=pool,
                instance_type=instance_type,
                capacity_type=node.metadata.labels.get(
                    labels_mod.CAPACITY_TYPE_LABEL_KEY, ""
                ),
                zone=node.metadata.labels.get(labels_mod.TOPOLOGY_ZONE, ""),
                price=price,
                disruption_cost=rescheduling_cost(pods)
                * lifetime_remaining(now, claim),
                reschedulable_pods=pods,
            )
        )
    return out


def _instance_type_of(cloud_provider, pool, claim):
    name = claim.metadata.labels.get(labels_mod.INSTANCE_TYPE)
    for it in cloud_provider.get_instance_types(pool):
        if it.name == name:
            return it
    return None


def _candidate_price(instance_type, node) -> float:
    if instance_type is None:
        return 0.0
    zone = node.metadata.labels.get(labels_mod.TOPOLOGY_ZONE, "")
    ct = node.metadata.labels.get(labels_mod.CAPACITY_TYPE_LABEL_KEY, "")
    for o in instance_type.offerings:
        if o.zone() == zone and o.capacity_type() == ct:
            return o.price
    return 0.0


def simulate_scheduling(
    client,
    cluster: Cluster,
    cloud_provider,
    candidates: Sequence[Candidate],
    solver_config=None,
    encode_cache=None,
    state_snapshot=None,
) -> Results:
    """Re-run the scheduler as if the candidates were gone
    (helpers.go:49-117): state snapshot minus candidates, their
    reschedulable pods plus pending pods as the workload.

    ``state_snapshot`` lets a caller that probes repeatedly (multi-node
    consolidation's binary search, single-node's sweep) deep-copy the
    cluster ONCE and share it: solves never mutate StateNodes (the
    scheduler's ExistingNode model keeps its own fills), and the per-probe
    copy of a 2k-node cluster dominated the decision's host time."""
    candidate_ids = {c.provider_id for c in candidates}
    state_nodes = [
        sn
        for sn in (
            state_snapshot if state_snapshot is not None else cluster.nodes()
        )
        if sn.provider_id not in candidate_ids
        and not (sn.mark_for_deletion or sn.deleting())
    ]
    pods: List[Pod] = []
    for c in candidates:
        pods.extend(c.reschedulable_pods)
    pods += [
        p for p in client.list(Pod) if pod_utils.is_provisionable(p)
    ]
    # zonal-volume constraints apply in simulation exactly as in provisioning
    # (the reference reuses Provisioner.NewScheduler, helpers.go:82-102)
    volume_topology = VolumeTopology(client)
    pods = [copy.deepcopy(p) if p.spec.volumes else p for p in pods]
    for p in pods:
        if p.spec.volumes:
            volume_topology.inject(p)
    solver = _build_simulation_solver(
        client, cluster, cloud_provider, state_nodes, pods,
        solver_config=solver_config, encode_cache=encode_cache,
    )
    return solver.solve(pods)


def _build_simulation_solver(
    client, cluster, cloud_provider, state_nodes, pods,
    solver_config=None, encode_cache=None,
) -> TorchSolver:
    """The one construction recipe for a disruption-simulation solver —
    shared by the per-subset simulate_scheduling and the scenario-batched
    ScenarioSimulator so the two paths can never drift apart (the
    batched == sequential equivalence depends on identical solvers)."""
    node_pools = sorted(
        client.list(NodePool), key=lambda p: (-p.spec.weight, p.name)
    )
    instance_types = {
        np_.name: cloud_provider.get_instance_types(np_) for np_ in node_pools
    }
    topology = Topology(
        client, state_nodes, node_pools, instance_types, pods, cluster=cluster
    )
    return TorchSolver(
        node_pools,
        instance_types,
        topology,
        state_nodes=state_nodes,
        config=solver_config,
        encode_cache=encode_cache,
        volume_resolver=VolumeResolver(client),
    )


class ScenarioEnvCache:
    """Content-keyed cache of built scenario-simulation environments —
    the warm path for ``scenario.build``.

    A fresh :class:`ScenarioSimulator` pays ~50–130 ms building the
    Topology + TorchSolver/Scheduler over a 2k-node snapshot before its
    first encode, and a reconcile pass builds up to two of them
    (multi-node then single-node consolidation) every tick. The
    environment is a pure function of (state nodes, workload pods,
    NodePools, DaemonSets, catalog): this cache keys on exactly that
    content — object resource versions for store state, identity for the
    provider's catalog lists (the EncodeCache prekey discipline: ICE
    masking hands back fresh copies, which miss; strong refs below keep
    a recycled id from aliasing) — and hands the built solver back when
    nothing changed. Solves never mutate the environment (scenario
    decodes run on fill-isolated clones; per-solve state resets per
    call), which is the same argument that lets one simulator serve a
    whole binary search."""

    def __init__(self, capacity: int = 4):
        from collections import OrderedDict

        self._entries: "OrderedDict" = OrderedDict()
        self._capacity = capacity
        self.hits = 0
        self.misses = 0

    def get(self, key):
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry["solver"]

    def put(self, key, solver, refs) -> None:
        self._entries[key] = {"solver": solver, "refs": refs}
        self._entries.move_to_end(key)
        while len(self._entries) > self._capacity:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()


def _scenario_env_key(client, cloud_provider, state_nodes, workload_pods):
    """(content key, catalog strong-refs) for ScenarioEnvCache. Every
    input is cheaply content-keyable today (store objects carry resource
    versions; catalog lists key by identity) — an input class that
    isn't must grow a bail-out here, not a lossy key."""
    from ...api.objects import DaemonSet

    nodes_sig = []
    for sn in state_nodes:
        node = sn.node
        claim = sn.node_claim
        nodes_sig.append(
            (
                sn.name,
                node.metadata.resource_version if node is not None else -1,
                claim.metadata.resource_version if claim is not None else -1,
            )
        )
    pods_sig = tuple(
        (p.uid, p.metadata.resource_version, p.spec.node_name)
        for p in workload_pods
    )
    pools = sorted(client.list(NodePool), key=lambda p: p.name)
    pools_sig = tuple(
        (p.name, p.metadata.resource_version) for p in pools
    )
    ds_sig = tuple(
        sorted(
            (d.metadata.uid, d.metadata.resource_version)
            for d in client.list(DaemonSet)
        )
    )
    catalog_refs = [
        list(cloud_provider.get_instance_types(p)) for p in pools
    ]
    catalog_sig = tuple(tuple(map(id, its)) for its in catalog_refs)
    return (
        tuple(nodes_sig), pods_sig, pools_sig, ds_sig, catalog_sig,
    ), catalog_refs


class ScenarioSimulator:
    """Scenario-batched simulate_scheduling over one cluster snapshot.

    The snapshot is encoded ONCE with every node present — one Topology,
    one TorchSolver/Scheduler (per-node models shared) for the whole search —
    and each solve() call expresses its candidate subsets as scenarios:
    the subset's nodes masked out, their reschedulable pods (plus the
    shared pending set) back in the workload. All of a call's subsets run
    in a single vmapped kernel dispatch (TorchSolver.solve_scenarios), so a
    binary search's probe set costs dispatches, not solves.

    ``available`` turns False when the batched path cannot represent this
    cluster/workload — pods with volumes (zonal-volume injection
    deep-copies per simulation), non-tensorizable pods, strict-mode
    reservations, non-TPU backends, and the topology remnants
    TorchSolver._plan_scenario_topology documents (candidate pods owning
    anti-affinity or selected by affinity-type constraints). Topology
    SPREAD constraints, minValues pools, and default-mode reservations
    now ride the batch: per-scenario prior deltas, dense
    distinct-value counting, and a per-scenario ledger replay keep a
    topology-constrained consolidation search at <= 2 dispatches —
    callers fall back to the sequential per-subset simulate_scheduling,
    the semantic reference, only on those remnants."""

    def __init__(
        self,
        client,
        cluster: Cluster,
        cloud_provider,
        universe: Sequence[Candidate],
        solver_config=None,
        encode_cache=None,
        state_snapshot=None,
        env_cache: Optional[ScenarioEnvCache] = None,
    ):
        self.available = True
        self.dispatches = 0
        self.env_reused = False
        self._prefetched = None  # (subset key, submit token) — see prefetch()
        if solver_config is not None and (
            solver_config.force_oracle or solver_config.backend != "kernels"
        ):
            # unconditionally unrepresentable: don't pay the Topology +
            # solver construction just for solve_scenarios to decline
            # (mesh configs are left to solve_scenarios — "auto" on a
            # single device still rides the batch)
            self.available = False
            return
        state_nodes = [
            sn
            for sn in (
                state_snapshot
                if state_snapshot is not None
                else cluster.nodes()
            )
            if not (sn.mark_for_deletion or sn.deleting())
        ]
        self._pending = [
            p for p in client.list(Pod) if pod_utils.is_provisionable(p)
        ]
        union_pods: List[Pod] = []
        seen_ids: set = set()
        for c in universe:
            if c.provider_id not in seen_ids:
                seen_ids.add(c.provider_id)
                union_pods.extend(c.reschedulable_pods)
        if any(p.spec.volumes for p in union_pods + self._pending):
            # zonal-volume injection deep-copies pods per simulation; the
            # shared encoding cannot carry per-scenario copies
            self.available = False
            return
        workload = union_pods + self._pending
        key = refs = None
        if env_cache is not None:
            key, refs = _scenario_env_key(
                client, cloud_provider, state_nodes, workload
            )
            cached = env_cache.get(key)
            if cached is not None:
                # warm path: identical snapshot/workload/catalog content —
                # the built Topology + solver (and its warm encode state)
                # serve this search too. The span still opens so traces
                # show WHERE build time went (reused builds cost ~0).
                with obs.span(
                    "scenario.build",
                    nodes=len(state_nodes),
                    candidates=len(universe),
                    reused=True,
                ):
                    self._solver = cached
                self.env_reused = True
                return
        with obs.span(
            "scenario.build",
            nodes=len(state_nodes),
            candidates=len(universe),
            reused=False,
        ):
            self._solver = _build_simulation_solver(
                client, cluster, cloud_provider, state_nodes,
                workload,
                solver_config=solver_config, encode_cache=encode_cache,
            )
        if env_cache is not None:
            env_cache.put(key, self._solver, refs)

    def _scenarios_of(self, subsets: Sequence[Sequence[Candidate]]):
        return [
            Scenario(
                pods=[p for c in subset for p in c.reschedulable_pods]
                + self._pending,
                excluded_provider_ids=frozenset(
                    c.provider_id for c in subset
                ),
            )
            for subset in subsets
        ]

    @staticmethod
    def _subset_key(subsets: Sequence[Sequence[Candidate]]) -> tuple:
        return tuple(
            tuple(c.provider_id for c in subset) for subset in subsets
        )

    def solve(
        self, subsets: Sequence[Sequence[Candidate]]
    ) -> Optional[List[Results]]:
        """Per-subset Results from one batched dispatch, aligned with
        ``subsets`` — or None (and available=False) when the batch cannot
        be represented; nothing has been solved in that case. A matching
        prefetch() token is collected instead of re-dispatching."""
        if not self.available:
            return None
        token = None
        if self._prefetched is not None:
            key, pending = self._prefetched
            self._prefetched = None
            if key == self._subset_key(subsets):
                token = pending
        if token is None:
            token = self._solver.submit_scenarios(self._scenarios_of(subsets))
        results = self._solver.collect_scenarios(token)
        if results is None:
            self.available = False
            return None
        self.dispatches += self._solver.last_scenario_dispatches
        return results

    def prefetch(self, subsets: Sequence[Sequence[Candidate]]) -> None:
        """Speculatively submit the NEXT chunk's dispatch into the
        solver's two-slot queue: the kernel computes while the caller is
        still turning the current chunk's Results into decisions (the
        async double-buffering). A prefetch that loses the
        race (early success ends the sweep) is simply never collected —
        the queue evicts it. Never raises: a prefetch failure must not
        fail the sweep, the chunk will be solved inline when reached."""
        if not self.available or self._prefetched is not None:
            return
        try:
            token = self._solver.submit_scenarios(self._scenarios_of(subsets))
        except Exception:
            return
        if token is not None:
            self._prefetched = (self._subset_key(subsets), token)


# -- budgets (nodepool.go:296-367, helpers.go:201-249) ---------------------


def _parse_budget_nodes(value: str, total: int) -> int:
    if value.endswith("%"):
        pct = int(value[:-1])
        return math.ceil(total * pct / 100.0)
    return int(value)


def _cron_matches(expr: str, t_struct) -> bool:
    """Minimal 5-field cron matcher (minute hour dom month dow)."""
    fields = expr.split()
    if fields and fields[0].startswith("@"):
        shorthand = {
            "@yearly": "0 0 1 1 *", "@annually": "0 0 1 1 *",
            "@monthly": "0 0 1 * *", "@weekly": "0 0 * * 0",
            "@daily": "0 0 0 * *".replace("0 0 0", "0 0"), "@midnight": "0 0 * * *",
            "@hourly": "0 * * * *",
        }
        fields = shorthand.get(fields[0], "* * * * *").split()
    if len(fields) != 5:
        return False
    values = (
        t_struct.tm_min,
        t_struct.tm_hour,
        t_struct.tm_mday,
        t_struct.tm_mon,
        t_struct.tm_wday if t_struct.tm_wday != 6 else 6,  # python: mon=0
    )
    # cron dow: 0=sunday; python tm_wday: 0=monday
    cron_dow = (t_struct.tm_wday + 1) % 7
    values = values[:4] + (cron_dow,)
    for field, value in zip(fields, values):
        if not _cron_field_matches(field, value):
            return False
    return True


def _cron_field_matches(field: str, value: int) -> bool:
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            if value % step == 0 or step == 1:
                return True
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            if int(lo) <= value <= int(hi) and (value - int(lo)) % step == 0:
                return True
        elif int(part) == value and step == 1:
            return True
    return False


def budget_active(budget: Budget, now: float) -> bool:
    """Is the budget's schedule window active at `now`? Budgets without a
    schedule are always active; with a schedule, active if the cron matched
    within the last `duration` seconds."""
    if budget.schedule is None:
        return True
    import time as _time

    duration = budget.duration or 0.0
    # scan minute marks within the window (duration is bounded in practice)
    t = int(now - (now % 60))
    steps = int(duration // 60) + 1
    for i in range(steps):
        ts = t - i * 60
        if _cron_matches(budget.schedule, _time.gmtime(ts)):
            return True
    return False


def allowed_disruptions(pool: NodePool, cluster_nodes: List[StateNode], reason: str, now: float) -> int:
    """allowed = min over active budgets of (budget nodes) - (deleting or
    not-ready nodes in the pool) (helpers.go:201-249)."""
    pool_nodes = [
        sn
        for sn in cluster_nodes
        if sn.labels().get(labels_mod.NODEPOOL_LABEL_KEY) == pool.name
        and sn.managed()
    ]
    total = len(pool_nodes)
    disrupting = sum(
        1
        for sn in pool_nodes
        if sn.mark_for_deletion or sn.deleting() or not sn.initialized()
    )
    allowed = total  # no budgets -> unbounded within pool size
    for budget in pool.spec.disruption.budgets:
        if budget.reasons and reason not in budget.reasons:
            continue
        if not budget_active(budget, now):
            continue
        allowed = min(allowed, _parse_budget_nodes(budget.nodes, total))
    return max(0, allowed - disrupting)


def build_budget_mapping(
    client, cluster: Cluster, reason: str, now: float
) -> Dict[str, int]:
    nodes = cluster.nodes()
    return {
        np_.name: allowed_disruptions(np_, nodes, reason, now)
        for np_ in client.list(NodePool)
    }
