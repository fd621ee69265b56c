"""TorchSolver: the PyTorch port of karpenter_tpu/solver/driver.py:TpuSolver.

Routes pods between the device fast path and the host oracle:

- *Tensorizable* pods (solver/encode.py:is_tensorizable) are grouped,
  encoded to dense arrays, staged on the device (solver/residency.py: the
  buffers stay resident between solves and churn moves only changed rows,
  kernel B8) and solved by one dispatch of the fused kernels
  (ops/solve.py): the sparse feasibility tables, the grouped-FFD packing
  scan and the wire pack.
- Everything else falls through to the exact host oracle
  (scheduling/scheduler.py) in the same solve, sharing existing-node
  capacity with the device placements.

Consolidation's probe sets ride the scenario axis (``solve_scenarios``,
split into ``submit_scenarios`` and ``collect_scenarios``): one shared
encoding of the whole cluster, every probe one scenario of a single
dispatch of the same kernels (ops/solve.py:dispatch_scenarios_packed).

The solve runs on ``SolverConfig.device``: "cuda" (the default) launches
the hand-written kernels, "cpu" runs their plain PyTorch versions. Asking
for CUDA on a host without it raises; nothing falls back.

A guard rejection of a solve that ran on a warm (reused or row-delta)
encoding sheds the warm state and re-solves once from a full re-encode,
on the same device (``_delta_fallback``); a second rejection propagates.

Batches of many small groups that share few feasibility classes (the
reference's diverse mix) take the class-batched scan (B5 in place of B4),
routed exactly as the JAX package routes them (``_classed_partition``).

Not in this slice, each raising NotImplementedError: the relaxation
pre-solver and the multi-GPU mesh (ROADMAP.md items A9, A13), and the
kernel statics outside the ported pack scope (reservations, minValues,
tiled tables: item A4b).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..api import labels as labels_mod
from ..api import resources as res
from ..api.objects import NodePool, Pod
from ..api.requirements import Operator, Requirement, Requirements
from ..cloudprovider import types as cp
from ..faults.guard import (
    DecodeCommitError,
    SolverIntegrityError,
    check_solution,
)
from ..ops.packing import check_scope
from ..scheduling.inflight import RESERVED_OFFERING_MODE_STRICT
from ..scheduling.scheduler import Results, Scheduler
from ..scheduling.template import NodeClaimTemplate
from ..scheduling.topology import Topology
from ..utils.pretty import ChangeMonitor
from . import encode as enc
from .args import put
from .residency import DeviceResidentArgs

_LOG = logging.getLogger("karpenter_tpu_torch.solver")
# once per pod (24h TTL), not once per batch walk: long-pending pods are
# re-partitioned every provisioning round
_ORACLE_ROUTE_CM = ChangeMonitor()


class EncodeCache:
    """Catalog-fingerprinted encode cache that outlives solver instances.

    The Provisioner (and the solver sidecar) build a fresh solver per
    solve, so the instance-type/template encode reuse (see encode.encode)
    only pays off if the vocab + static arrays survive across solvers. The
    fingerprint covers everything the static arrays are derived from; any
    catalog change (new types, price/availability flips, new limits)
    resets the cache."""

    def __init__(self, owner: str = ""):
        import threading

        # multi-tenant attribution (solver/tenancy.py): the control plane
        # this cache's warm state belongs to. Rides the ENCODE_DELTA fault
        # ctx so chaos plans can pin corrupt-delta rules to one tenant's
        # leases; "" for single-operator deployments.
        self.owner = owner
        self._fingerprint = None
        # short content hash of the current catalog fingerprint — the
        # encode_hash every decision audit record carries. Computed once
        # per catalog change (repr of the full fingerprint is megabytes on
        # an 800-type catalog; per-solve hashing would eat the <2% bench
        # budget), read per solve.
        self.content_hash = ""
        self.vocab = enc.Vocab()
        self.cache: dict = {}
        # the persistent cluster encoding (content-keyed row banks +
        # prior-snapshot fast path) outlives solver instances with this
        # cache; a catalog change resets it along with the vocab
        self.cluster = enc.ClusterEncoding(owner=owner)
        # consolidation searches encode a different workload shape (the
        # union of the candidates' pods over the full node set), so the
        # scenario path keeps its own encoding and does not thrash the
        # provisioning one's prior-snapshot fast path
        self.scenario_cluster = enc.ClusterEncoding(owner=owner)
        # device-resident solve arguments (solver/residency.py), one store
        # per encoding, created on first use
        self.device_store = None
        self.scenario_device_store = None
        # pure per-node scheduler model inputs (taints, daemon remainder,
        # label requirements) keyed by object resource versions — catalog-
        # independent, so it survives fingerprint resets. Consolidation
        # probes and successive provisioning rounds over a stable cluster
        # hit this instead of rebuilding every ExistingNode model.
        self.node_models: dict = {}
        # encode mutates the shared vocab/static arrays; concurrent solves
        # (the gRPC sidecar) serialize the host-side encode on this lock
        self.lock = threading.RLock()

    @staticmethod
    def _type_static_fp(it) -> tuple:
        """The immutable per-type fingerprint part (name, capacity,
        requirement content), memoized ON the InstanceType object: the
        provider hands the same objects back every reconcile (ICE masking
        builds fresh copies, which recompute), and repr(requirements)
        over an 800-type catalog was the dominant cost of every lease —
        a steady-state tax the warm encode path can't afford. Offering
        price/availability is NOT memoized: it changes per solve and is
        fingerprinted fresh below."""
        fp = getattr(it, "_ktpu_static_fp", None)
        if fp is None:
            fp = (
                it.name,
                tuple(sorted(it.capacity.items())),
                repr(it.requirements),
            )
            try:
                object.__setattr__(it, "_ktpu_static_fp", fp)
            except (AttributeError, TypeError):
                pass  # slotted/frozen types just recompute per lease
        return fp

    @staticmethod
    def _template_fp(nct) -> tuple:
        """Content tuple for one template. repr(requirements) omits
        min_values (Requirement.__repr__ prints key/operator/values only),
        and the dense minValues tables (p_mvmin/t_mvoh) live in the leased
        static cache — so the floors are fingerprinted explicitly or a
        NodePool minValues edit would serve stale floors until an
        unrelated catalog change."""
        return (
            nct.node_pool_name,
            nct.node_pool_weight,
            tuple(sorted(nct.labels.items())),
            tuple((t.key, t.value, t.effect) for t in nct.taints),
            repr(nct.requirements),
            tuple(
                sorted(
                    (r.key, r.min_values)
                    for r in nct.requirements
                    if r.min_values is not None
                )
            ),
        )

    @staticmethod
    def fingerprint(templates, its_by_pool, daemon_overhead, pool_limits):
        tpl = tuple(EncodeCache._template_fp(nct) for nct in templates)
        # content-addressed (NOT id()): the gRPC sidecar decodes a fresh
        # InstanceType object per request, and the cache must still hit on
        # an unchanged catalog
        types = tuple(
            (
                pool,
                tuple(
                    EncodeCache._type_static_fp(it)
                    + (tuple((o.price, o.available, o.reservation_capacity)
                             for o in it.offerings),)
                    for it in its
                ),
            )
            for pool, its in sorted(its_by_pool.items())
        )
        overhead = tuple(
            sorted(
                (nct.node_pool_name, tuple(sorted(rl.items())))
                for nct, rl in (daemon_overhead or {}).items()
            )
        )
        limits = tuple(
            sorted(
                (pool, tuple(sorted(rl.items())))
                for pool, rl in (pool_limits or {}).items()
            )
        )
        return (tpl, types, overhead, limits)

    def lease(self, templates, its_by_pool, daemon_overhead, pool_limits):
        """Vocab + cache dict for this catalog; resets on fingerprint change.

        An identity fast path skips the deep content fingerprint when the
        provider hands back the SAME InstanceType objects as last lease
        (the steady-state reconcile shape — kwok/fake return their cached
        list; availability changes arrive as fresh masked copies via the
        ICE cache, which breaks identity and recomputes). The per-object
        contract: a live catalog object's content is immutable — changed
        offerings come as new objects, never in-place flips. Strong refs
        to the keyed objects are held so a recycled id can never alias."""
        prekey = (
            tuple(EncodeCache._template_fp(nct) for nct in templates),
            tuple(
                (pool, tuple(map(id, its)))
                for pool, its in sorted(its_by_pool.items())
            ),
            tuple(
                sorted(
                    (nct.node_pool_name, tuple(sorted(rl.items())))
                    for nct, rl in (daemon_overhead or {}).items()
                )
            ),
            tuple(
                sorted(
                    (pool, tuple(sorted(rl.items())))
                    for pool, rl in (pool_limits or {}).items()
                )
            ),
        )
        if prekey == getattr(self, "_prekey", None):
            return self.vocab, self.cache
        fp = self.fingerprint(templates, its_by_pool, daemon_overhead, pool_limits)
        self._prekey = prekey
        # keep the id()-keyed objects alive: a GC'd type whose id is
        # recycled could otherwise satisfy the prekey with different content
        self._prekey_refs = [list(its) for its in its_by_pool.values()]
        if fp != self._fingerprint:
            import hashlib

            self._fingerprint = fp
            self.content_hash = hashlib.blake2b(
                repr(fp).encode(), digest_size=8
            ).hexdigest()
            self.vocab = enc.Vocab()
            self.cache = {}
            # the warm encodings and device buffers are catalog-derived: a
            # changed catalog invalidates both (next encode is full)
            self.cluster.invalidate("catalog changed")
            self.scenario_cluster.invalidate("catalog changed")
            for store in (self.device_store, self.scenario_device_store):
                if store is not None:
                    store.reset()
        return self.vocab, self.cache

    def lease_device_store(self, scenario: bool = False):
        """The device-resident argument store; ``scenario`` selects the
        scenario-side store (paired with ``scenario_cluster``) so
        consolidation searches don't evict the provisioning path's buffers
        and vice versa."""
        if scenario:
            if self.scenario_device_store is None:
                self.scenario_device_store = DeviceResidentArgs(owner=self.owner)
            return self.scenario_device_store
        if self.device_store is None:
            self.device_store = DeviceResidentArgs(owner=self.owner)
        return self.device_store


# the class partition's arrays, in dispatch_classed_packed's order
_CLASS_ARG_NAMES = ("class_start", "class_len", "class_dyn", "class_dkey", "inv_idx")


def _not_in_slice(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md item {item})"
    )


@dataclass
class SolverConfig:
    # "cuda": the hand-written kernels on the current CUDA device (or
    # "cuda:N"); "cpu": their plain PyTorch versions. CUDA on a host
    # without it raises here, never falls back.
    device: str = "cuda"
    max_claims: Optional[int] = None  # NMAX override; default auto-estimated
    force_oracle: bool = False  # route everything host-side (debugging)
    # multi-tenant attribution: rides the decision audit records' attrs
    tenant: str = ""
    # class-batched scan (ops/packing.py:pack_classed, kernel B5): True
    # forces it, False forces the per-group scan, None routes by mean class
    # size (TorchSolver._classed_partition), as the JAX package does
    classed: Optional[bool] = None
    # not in this slice: set, each raises NotImplementedError
    mesh: Optional[object] = None
    relax: Optional[bool] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise _not_in_slice("the multi-GPU mesh (B10)", "A13")
        if self.relax:
            raise _not_in_slice("the relaxation pre-solver (B9)", "A9")
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SolverConfig(device={self.device!r}): CUDA is not available"
                " on this host; pass device='cpu' for the plain versions"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported solver device {self.device!r}")


def _clone_existing_node(en):
    """A fill-isolated copy of an ExistingNode model: decode mutates pods/
    requests/requirements, and scenario fan-out must not leak one scenario's
    placements into another's (or into the shared oracle models)."""
    import copy

    c = copy.copy(en)
    c.pods = list(en.pods)
    c.requests = dict(en.requests)
    c.requirements = Requirements(*en.requirements.values())
    c.volume_usage = en.volume_usage.copy() if en.volume_usage else None
    return c


@dataclass
class Scenario:
    """One cluster what-if for TorchSolver.solve_scenarios: ``pods`` is the
    scenario's workload (a subset of the union the solver encodes) and
    ``excluded_provider_ids`` names the existing nodes absent from the
    cluster in this scenario (consolidation candidates being removed)."""

    pods: List[Pod]
    excluded_provider_ids: frozenset = frozenset()


@dataclass
class DecodedClaim:
    """A claim produced by the device path; duck-types InFlightNodeClaim for
    Results consumers (pods, instance_type_options, requirements,
    template, reserved_offerings)."""

    template: NodeClaimTemplate
    pods: List[Pod]
    instance_type_options: List[cp.InstanceType]
    requirements: Requirements
    reserved_offerings: List[cp.Offering] = field(default_factory=list)

    def finalize(self) -> None:  # parity with InFlightNodeClaim
        pass


class TorchSolver:
    """Drop-in Solve() accelerator at the Scheduler seam, on PyTorch."""

    def __init__(
        self,
        node_pools: Sequence[NodePool],
        instance_types: Dict[str, List[cp.InstanceType]],
        topology: Topology,
        state_nodes: Sequence = (),
        daemonset_pods: Sequence[Pod] = (),
        config: Optional[SolverConfig] = None,
        encode_cache: Optional[EncodeCache] = None,
        **scheduler_kwargs,
    ):
        self.config = config or SolverConfig()
        self.device = torch.device(self.config.device)
        # encode reuse: with a shared EncodeCache the instance-type/template
        # side survives across solver instances
        self._shared_cache = encode_cache or EncodeCache()
        # the oracle scheduler provides template prefiltering, daemon
        # overhead, existing-node models, and the fallback solve loop
        self.oracle = Scheduler(
            node_pools,
            instance_types,
            topology,
            state_nodes=state_nodes,
            daemonset_pods=daemonset_pods,
            node_model_cache=self._shared_cache.node_models,
            **scheduler_kwargs,
        )
        self.pool_limits = {
            np_.name: dict(np_.spec.limits) for np_ in node_pools if np_.spec.limits
        }
        # kernel dispatch count of the last solve_scenarios call (the whole
        # probe set of a search should cost <= 2 dispatches)
        self.last_scenario_dispatches = 0
        # per-solve audit state (obs/audit.py): which rung produced the
        # committed answer and what the invariant guard said
        self.last_dispatches = 0
        self._audit_rung = "kernel"
        self._audit_guard = "ok"
        self.last_encode_reused = False
        self.last_delta_rows = 0
        # whether the last staged solve ran on reused / row-delta buffers
        # (the corrupt-delta fallback's trigger)
        self._last_incremental = False
        # sequential-fallback telemetry: work that fell off the dense path
        # for representability reasons (oracle-routed pods, gated routes)
        self.fallback_solves = 0
        self.last_fallback_reasons: List[str] = []
        # per-solve volume routing state (prepare_volume_routing)
        self._vol_resolved: Dict[str, list] = {}

    def _note_fallback(self, reason: str) -> None:
        self.fallback_solves += 1
        self.last_fallback_reasons.append(reason)
        obs.event("solver.sequential_fallback", reason=reason)

    # -- solve ------------------------------------------------------------

    def solve(self, pods: Sequence[Pod]) -> Results:
        """One committed decision: the routed solve (below) inside a span,
        followed by the decision audit record. Neither instrument touches
        the decision itself (byte-identical-decisions contract,
        tests/test_obs.py)."""
        self.last_dispatches = 0
        self._audit_rung = "kernel"
        self._audit_guard = "ok"
        self.last_encode_reused = False
        self.last_delta_rows = 0
        self._last_incremental = False
        fault_mark = self._fault_log_mark()
        # one duration clock captured per solve: the tracer's injected
        # clock under tracing (replay-deterministic), the monotonic
        # PerfClock seam otherwise — never a raw wall-clock read in the
        # solve path (CLK10xx), and never RealClock for a DELTA (an NTP
        # step between the two reads would record a negative duration)
        dclk = obs.duration_clock()
        t0 = dclk.now()
        with obs.span("solve", pods=len(pods)) as sp:
            results = self._solve_routed(pods)
        self._emit_audit(
            "solve", sp, dclk, t0, fault_mark,
            pods=len(pods),
            claims=len(results.new_node_claims),
            errors=len(results.pod_errors),
            scenario_count=0,
            dispatches=self.last_dispatches,
            # cost enrichment only under tracing: total_price walks every
            # claim's options, and the untraced audit path must stay O(1)
            cost=(
                results.total_price() if obs.active() is not None else None
            ),
        )
        return results

    @staticmethod
    def _fault_log_mark() -> int:
        from .. import faults

        inj = faults.active()
        return len(inj.log) if inj is not None else 0

    def _drain_host(self, out) -> List[np.ndarray]:
        """The single device->host readback of the solve: the kernel's
        outputs cross here (``.cpu()`` waits for the stream), immediately
        ahead of the pre-decode invariant guard."""
        return [x.cpu().numpy() for x in out]

    # -- scenario axis ----------------------------------------------------

    # scenario-count buckets: S pads to a power of two, at least this
    _SCENARIO_FLOOR = 8

    def solve_scenarios(
        self, scenarios: Sequence[Scenario]
    ) -> Optional[List[Results]]:
        """Solve every scenario of one cluster snapshot in a single dispatch
        of the scenario-batched kernels (ops/solve.py:
        dispatch_scenarios_packed).

        The solver must have been constructed with the FULL node set (no
        candidates pre-removed); each scenario masks its removed nodes and
        activates its workload subset over one shared encoding, with
        topology priors batched as per-scenario contribution deltas
        (_plan_scenario_topology). Returns per-scenario Results aligned
        with ``scenarios``, or None when the batch cannot be represented
        scenario-batched — the JAX package's decline set: oracle-routed
        pods, strict-mode reservations, topology shapes the prior deltas
        cannot express, force_oracle. The caller then falls back to
        per-scenario solve()s, and the decline is counted in
        ``fallback_solves``. Statics outside the ported kernel scope raise
        NotImplementedError; a kernel fault raises at the drain.
        ``last_scenario_dispatches`` records the dispatch count of the
        last successful call.

        Split into :meth:`submit_scenarios` (host prep and the launches,
        which do not wait for the card) and :meth:`collect_scenarios`
        (drain, guard, decode, audit): the single-node sweep submits chunk
        n+1 while chunk n's Results become decisions."""
        return self.collect_scenarios(self.submit_scenarios(scenarios))

    def submit_scenarios(self, scenarios: Sequence[Scenario]):
        """Stage one scenario batch and launch its dispatch, without
        waiting for the card. Returns an opaque token for
        collect_scenarios, or None when the batch cannot be represented
        (same decline conditions as solve_scenarios)."""
        self.last_scenario_dispatches = 0
        if not scenarios:
            return {"empty": True}
        if self.config.force_oracle:
            return None
        if (
            self.oracle.reserved_capacity_enabled
            and self.oracle.reserved_offering_mode
            == RESERVED_OFFERING_MODE_STRICT
        ):
            # strict mode raises mid-Add (see _solve_routed): sequential
            self._note_fallback("scenario-strict-reservation")
            return None
        # union workload across scenarios, deduped by pod identity
        union: List[Pod] = []
        seen: set = set()
        for sc in scenarios:
            for p in sc.pods:
                if p.uid not in seen:
                    seen.add(p.uid)
                    union.append(p)
        topo = self.oracle.topology
        if not self.oracle.templates:
            return None
        groups, rest = enc.partition_and_group(
            union,
            topology=topo,
            merge_bootstrap_affinity=not self.oracle.reserved_capacity_enabled,
        )
        if rest:
            self._note_fallback(f"scenario-oracle-routed:{len(rest)}")
            return None
        if not groups:
            return {"noop": True, "scenarios": list(scenarios)}
        # topology priors depend on which candidate nodes remain: the plan
        # decomposes them into per-candidate contribution deltas applied
        # to per-scenario copies of the prior arrays; shapes the deltas
        # cannot express decline to the sequential reference
        topo_plan = None
        if topo.topology_groups or topo.inverse_topology_groups:
            topo_plan = self._plan_scenario_topology(scenarios, groups, topo)
            if topo_plan is None:
                self._note_fallback("scenario-topology-unrepresentable")
                return None

        # the duration clock starts at submit so a prefetched batch's
        # audit record reports wall time of the whole decision
        dclk = obs.duration_clock()
        t0 = dclk.now()
        fault_mark = self._fault_log_mark()
        with obs.span("solve.encode", groups=len(groups)):
            snap, avail, nmax_hint, lease_cache, delta = self._encode_batch(
                groups, scenario=True
            )
        a_tzc, res_cap0, a_res = avail
        fit = self._fit_matrix(snap)
        nmax = self._select_nmax(snap, fit, nmax_hint)
        # pad G only to the next power of two: every padded group step
        # runs for every scenario
        G = enc._next_pow2(len(snap.groups), floor=1)
        N = (
            enc._next_pow2(len(snap.existing_names), floor=1)
            if snap.existing_names
            else 0
        )
        statics = self._kernel_statics(snap, G)
        # outside the ported pack scope: raise before anything launches
        check_scope(
            statics["tile_feasibility"], res_cap0.shape[0], snap.p_mvmin.shape[1],
        )
        snap_run = snap.padded(G, N)
        args = list(snap_run.solve_args(a_tzc, res_cap0, a_res))

        # per-scenario arrays over the shared encoding
        uid_to_group: Dict[str, int] = {}
        for gi, g in enumerate(snap.groups):
            for p in g.pods:
                uid_to_group[p.uid] = gi
        pid_to_node: Dict[str, int] = {}
        for ni, en in enumerate(self.oracle.existing_nodes):
            pid = getattr(en.state_node, "provider_id", None)
            if pid is not None:
                pid_to_node[pid] = ni
        S_real = len(scenarios)
        S = enc._next_pow2(S_real, floor=self._SCENARIO_FLOOR)
        Gb, Nb = len(snap_run.g_count), snap_run.n_tol.shape[0]
        # padded scenarios keep g_count 0: they place nothing
        g_count_s = np.zeros((S, Gb), np.int32)
        n_tol_s = np.zeros((S, Nb, max(Gb, 1)), bool)
        scen_group_pods: List[List[List[Pod]]] = []
        for si, sc in enumerate(scenarios):
            per_group: List[List[Pod]] = [[] for _ in snap.groups]
            for p in sc.pods:
                per_group[uid_to_group[p.uid]].append(p)
            scen_group_pods.append(per_group)
            for gi, pl in enumerate(per_group):
                g_count_s[si, gi] = len(pl)
            ntol = snap_run.n_tol
            if sc.excluded_provider_ids:
                ntol = ntol.copy()
                for pid in sc.excluded_provider_ids:
                    ni = pid_to_node.get(pid)
                    if ni is not None:
                        # a node no group tolerates receives no fills: the
                        # kernel-visible form of "this node is gone"
                        ntol[ni, :] = False
            n_tol_s[si] = ntol
        args[enc.SOLVE_ARG_NAMES.index("g_count")] = g_count_s
        args[enc.SOLVE_ARG_NAMES.index("n_tol")] = n_tol_s
        batch_topo = bool(topo_plan and topo_plan["batch"])
        if batch_topo:
            gp_s, nh_s, nh0_s, dd0_s = self._scenario_topo_arrays(
                topo_plan, snap, snap_run, scenarios, S
            )
            args[enc.SOLVE_ARG_NAMES.index("g_dprior")] = gp_s
            args[enc.SOLVE_ARG_NAMES.index("n_hcnt")] = nh_s
            args[enc.SOLVE_ARG_NAMES.index("nh_cnt0")] = nh0_s
            args[enc.SOLVE_ARG_NAMES.index("dd0")] = dd0_s
        fills_dtype = (
            torch.int16 if self._fill_bound(snap, fit) < 2**15 else torch.int32
        )
        # device residency over the SHARED encoding; the per-scenario stacks
        # (g_count, n_tol, plus the topology prior arrays when the plan
        # carries corrections) are rebuilt per call and copied per batch
        skip = {"g_count", "n_tol"}
        if batch_topo:
            skip |= {"g_dprior", "n_hcnt", "nh_cnt0", "dd0"}
        store = self._shared_cache.lease_device_store(scenario=True)
        with obs.span(
            "solve.transfer",
            reused=bool(delta.reused),
            delta_rows=int(delta.delta_rows),
        ):
            args = store.stage(
                enc.SOLVE_ARG_NAMES, args, delta, self.device,
                skip=frozenset(skip),
            )
            for i, name in enumerate(enc.SOLVE_ARG_NAMES):
                if name in skip:
                    args[i] = put(name, args[i], self.device)
            self._sync_if_traced()

        token = {
            "batch_topo": batch_topo,
            "scenarios": list(scenarios),
            "snap": snap,
            "snap_run": snap_run,
            "args": args,
            "statics": statics,
            "nmax": nmax,
            "fills_dtype": fills_dtype,
            "g_count_s": g_count_s,
            "scen_group_pods": scen_group_pods,
            "S_real": S_real,
            "lease_cache": lease_cache,
            "delta": delta,
            "incremental": store.last_incremental or delta.reused,
            "retry_ok": True,
            "dclk": dclk,
            "t0": t0,
            "fault_mark": fault_mark,
        }
        token["out"] = self._submit_scenario_dispatch(token)
        return token

    def _submit_scenario_dispatch(self, token):
        """Launch one scenario dispatch; its outputs stay on the device
        (on CUDA the launches return before the card finishes)."""
        from ..ops.solve import dispatch_scenarios_packed

        return dispatch_scenarios_packed(
            *token["args"], nmax=token["nmax"],
            fills_dtype=token["fills_dtype"],
            batch_topo=token["batch_topo"],
            **token["statics"],
        )

    def _plan_scenario_topology(self, scenarios, groups, topo):
        """Per-candidate topology-prior contribution plan for one scenario
        batch, or None when the deltas cannot express the sequential
        reference exactly (the caller declines to per-probe solves).

        A scenario's priors differ from the shared (union) encoding only
        by the bound pods of its INCLUDED candidates: the union topology
        treats every candidate's reschedulable pods as pending, so for a
        scenario keeping candidate c, c's pods must be re-counted as
        priors. Each such pod counts toward exactly the constraints whose
        selector matches it — its own group's self-selecting dynamic
        state, and the shared descriptors the group owns or contributes
        to — through four channels:

          nh   n_hcnt[row, gi]     private hostname cap priors
          nh0  nh_cnt0[row, slot]  shared hostname carry priors
          gpr  g_dprior[gi, vid]   private domain-spread priors
          dd0  dd0[slot, vid]      shared domain carry init

        Declines (documented remnants): candidate pods owning
        anti-affinity (the sequential path gates them through the oracle's
        inverse machinery), candidate pods selected by affinity-type or
        statically-folded constraints (their folds baked union counts
        in), hostname folds over several constraints, haff pins, and
        candidate nodes carrying out-of-catalog spread domains (their
        registration would differ per scenario)."""
        from ..scheduling.topology import TopologyType

        cand_pids: set = set()
        for sc in scenarios:
            cand_pids |= set(sc.excluded_provider_ids)
        if not cand_pids:
            return {"by_pid": {}, "cand_pids": cand_pids, "batch": False}
        row_by_name: Dict[str, tuple] = {}
        for ni, en in enumerate(self.oracle.existing_nodes):
            row_by_name[en.name] = (
                ni, getattr(en.state_node, "provider_id", None), en
            )
        # candidate-bound pods of the union, aggregated per (pid, row, gi)
        per: Dict[tuple, int] = {}
        for gi, g in enumerate(groups):
            for p in g.pods:
                nn = p.spec.node_name
                if not nn:
                    continue
                ent = row_by_name.get(nn)
                if ent is None or ent[1] not in cand_pids:
                    continue
                if p.spec.pod_anti_affinity:
                    return None
                per[(ent[1], ent[0], gi)] = per.get(
                    (ent[1], ent[0], gi), 0
                ) + 1
        # out-of-catalog candidate domains: removing the node would
        # unregister the domain in the sequential path, shifting the
        # spread min — checked on candidate NODES (registration is
        # node-based), pods or not
        dyn_keys = {
            g.topo.dkey
            for g in groups
            if g.topo is not None
            and g.topo.dmode
            in (enc.DMODE_SPREAD, enc.DMODE_GATE_SPREAD)
            and g.topo.dkey
        }
        if dyn_keys:
            cand_rows = {
                ni
                for ni, pid, _en in row_by_name.values()
                if pid in cand_pids
            }
            # the loop only ever returns None; which key trips it first is
            # immaterial
            for key in dyn_keys:
                catalog = topo.domain_groups.get(key)
                universe = catalog.domains() if catalog is not None else set()
                for ni in cand_rows:
                    en = self.oracle.existing_nodes[ni]
                    dom = enc._node_single_value(en, key)
                    if dom is not None and dom not in universe:
                        return None
        if not per:
            return {"by_pid": {}, "cand_pids": cand_pids, "batch": False}
        static_folds = list(getattr(topo, "kernel_static_folds", ()))
        aff_tgs = [
            tg
            for tg in topo.topology_groups.values()
            if tg.type is TopologyType.POD_AFFINITY
        ]
        h_slots, d_slots = enc.shared_slot_ids(groups)
        by_pid: Dict[str, list] = {}
        sel_memo: Dict[tuple, bool] = {}
        for (pid, ni, gi), m in sorted(per.items()):
            g = groups[gi]
            rep = g.pods[0]
            en = self.oracle.existing_nodes[ni]
            for tg in static_folds + aff_tgs:
                memo_key = (gi, id(tg))
                hit = sel_memo.get(memo_key)
                if hit is None:
                    hit = sel_memo[memo_key] = tg.selects(rep)
                if hit:
                    return None
            t = g.topo
            if t is None:
                continue  # selected by nothing admitted: no counting
            if t.haff or t.dmode == enc.DMODE_AFFINITY:
                return None
            ch = by_pid.setdefault(pid, [])
            taints = en.cached_taints
            node_reqs = en.requirements
            if t.host_cap is not None:
                if len(t.src_h) != 1 or t.host_nsrc != 1:
                    return None
                if t.src_h[0].node_filter.matches(taints, node_reqs):
                    ch.append(("nh", ni, gi, m))
            desc = t.shared_h if t.h_self else None
            if desc is not None:
                if desc.tg is None:
                    return None
                if desc.tg.node_filter.matches(taints, node_reqs):
                    ch.append(("nh0", ni, h_slots[id(desc)], m))
            for desc in t.contrib_h:
                if desc.tg is None:
                    return None
                if desc.tg.node_filter.matches(taints, node_reqs):
                    ch.append(("nh0", ni, h_slots[id(desc)], m))
            dom_descs = []
            if t.dmode == enc.DMODE_SPREAD and t.shared_d is None:
                if t.src_d is None:
                    return None
                dom = enc._node_single_value(en, t.dkey)
                if (
                    dom is not None
                    and dom in t.dreg
                    and t.src_d.node_filter.matches(taints, node_reqs)
                ):
                    axis = 0 if t.dkey == labels_mod.TOPOLOGY_ZONE else 1
                    ch.append(("gpr", gi, axis, ni, m))
            if t.shared_d is not None and t.dmode == enc.DMODE_SPREAD:
                dom_descs.append(t.shared_d)
            for desc in t.contrib_d:
                if desc.mode != enc.DMODE_SPREAD:
                    return None  # affinity options evolve: sequential
                dom_descs.append(desc)
            for desc in dom_descs:
                if desc.tg is None:
                    return None
                dom = enc._node_single_value(en, desc.key)
                if (
                    dom is not None
                    and dom in desc.reg
                    and desc.tg.node_filter.matches(taints, node_reqs)
                ):
                    axis = 0 if desc.key == labels_mod.TOPOLOGY_ZONE else 1
                    ch.append(("dd0", d_slots[id(desc)], axis, ni, m))
        return {
            "by_pid": by_pid,
            "cand_pids": cand_pids,
            "batch": any(by_pid.values()),
        }

    def _scenario_topo_arrays(self, plan, snap, snap_run, scenarios, S):
        """Per-scenario copies of the topology prior arrays with each
        scenario's included-candidate contributions applied (see
        _plan_scenario_topology). Domain value ids come from the shared
        encoding's node rows — the correction's domain IS the candidate
        node's own zone/capacity-type slot."""
        g_dprior_s = np.repeat(snap_run.g_dprior[None], S, axis=0)
        n_hcnt_s = np.repeat(snap_run.n_hcnt[None], S, axis=0)
        nh0_s = np.repeat(snap_run.nh_cnt0[None], S, axis=0)
        dd0_s = np.repeat(snap_run.dd0[None], S, axis=0)
        by_pid = plan["by_pid"]
        cand_pids = plan["cand_pids"]
        for si, sc in enumerate(scenarios):
            for pid in sorted(cand_pids - set(sc.excluded_provider_ids)):
                for chan in by_pid.get(pid, ()):
                    kind = chan[0]
                    if kind == "nh":
                        _, ni, gi, m = chan
                        n_hcnt_s[si, ni, gi] += m
                    elif kind == "nh0":
                        _, ni, slot, m = chan
                        nh0_s[si, ni, slot] += m
                    elif kind == "gpr":
                        _, gi, axis, ni, m = chan
                        vid = (
                            snap.n_dzone[ni] if axis == 0 else snap.n_dct[ni]
                        )
                        if vid >= 0:
                            g_dprior_s[si, gi, vid] += m
                    else:  # dd0
                        _, slot, axis, ni, m = chan
                        vid = (
                            snap.n_dzone[ni] if axis == 0 else snap.n_dct[ni]
                        )
                        if vid >= 0:
                            dd0_s[si, slot, vid] += m
        return g_dprior_s, n_hcnt_s, nh0_s, dd0_s

    def collect_scenarios(self, token) -> Optional[List[Results]]:
        """Drain, guard, decode, and audit a batch submitted by
        submit_scenarios. Returns per-scenario Results aligned with the
        submitted scenarios, or None on a representability decline (same
        contract as solve_scenarios). A kernel fault raises here, at the
        drain; a guard rejection raises SolverIntegrityError."""
        if token is None:
            return None
        if token.get("empty"):
            return []
        if token.get("noop"):
            return [
                Results(
                    new_node_claims=[],
                    existing_nodes=self.oracle.existing_nodes,
                    pod_errors={},
                )
                for _ in token["scenarios"]
            ]
        self._audit_rung = "batched"
        self._audit_guard = "ok"
        self.last_encode_reused = token["delta"].reused
        self.last_delta_rows = token["delta"].delta_rows
        self._last_incremental = token["incremental"]
        scenarios = token["scenarios"]
        with obs.span("scenarios", scenarios=len(scenarios)) as sp:
            results = self._collect_scenarios_impl(token)
        self._emit_audit(
            "scenarios", sp, token["dclk"], token["t0"],
            token["fault_mark"],
            pods=sum(len(s.pods) for s in scenarios),
            claims=sum(len(r.new_node_claims) for r in results),
            errors=sum(len(r.pod_errors) for r in results),
            scenario_count=len(scenarios),
            dispatches=self.last_scenario_dispatches,
            cost=(
                sum(r.total_price() for r in results)
                if obs.active() is not None
                else None
            ),
        )
        return results

    def _collect_scenarios_impl(self, token) -> List[Results]:
        snap, snap_run = token["snap"], token["snap_run"]
        g_count_s = token["g_count_s"]
        scen_group_pods = token["scen_group_pods"]
        S_real = token["S_real"]
        nmax = token["nmax"]
        out = token["out"]
        dispatches = 0
        # a kernel fault raises out of the drain, a guard rejection out of
        # the guard: nothing is decoded or committed, nothing re-solves
        while True:
            with obs.span("solve.dispatch", nmax=nmax, scenarios=S_real):
                (c_pool, packed, n_open, overflow,
                 exist_fills, claim_fills, unplaced, c_dzone, c_dct,
                 c_resv) = self._drain_host(out)
            dispatches += 1
            if not overflow.any():
                break
            # any scenario overflowed: the whole batch goes again
            nmax *= 2
            token["nmax"] = nmax
            out = self._submit_scenario_dispatch(token)
        self.last_scenario_dispatches = dispatches
        # invariant guard per scenario, still pre-decode: one corrupt
        # scenario poisons the whole batch (they share one dispatch)
        try:
            with obs.span("solve.guard", scenarios=S_real):
                for si in range(S_real):
                    self._verify_solution(
                        snap, snap_run, c_pool[si], packed[si],
                        int(n_open[si]),
                        exist_fills[si], claim_fills[si], unplaced[si], nmax,
                        g_count=g_count_s[si],
                        c_dzone=c_dzone[si], c_dct=c_dct[si],
                    )
        except SolverIntegrityError as exc:
            if not (token["retry_ok"] and self._last_incremental):
                raise
            # the violating batch ran on an incremental encoding: shed the
            # warm state and run the whole batch once more from a full
            # re-encode, on the same device
            self._delta_fallback(str(exc))
            retry = self.submit_scenarios(token["scenarios"])
            if retry is None or "out" not in retry:
                raise
            retry["retry_ok"] = False
            self._last_incremental = retry["incremental"]
            # the audit provenance describes the encode that produced the
            # committed answer, not the discarded incremental attempt
            self.last_encode_reused = retry["delta"].reused
            self.last_delta_rows = retry["delta"].delta_rows
            return self._collect_scenarios_impl(retry)
        if self.config.max_claims is None and S_real:
            lease_cache = token["lease_cache"]
            with self._shared_cache.lock:
                lease_cache["nmax_hint"] = max(
                    lease_cache.get("nmax_hint", 0),
                    int(n_open[:S_real].max()),
                )

        results: List[Results] = []
        with obs.span("solve.decode", scenarios=S_real):
            for si in range(S_real):
                # fills commit onto per-scenario node clones so scenarios
                # never observe each other's placements (only touched nodes
                # clone; the rest share the untouched oracle models)
                nodes = list(self.oracle.existing_nodes)
                for ni in np.nonzero(exist_fills[si].any(axis=0))[0]:
                    if ni < len(nodes):
                        nodes[ni] = _clone_existing_node(nodes[ni])
                claims, errors = self._decode(
                    snap,
                    c_pool[si].astype(np.int32),
                    packed[si],
                    int(n_open[si]),
                    exist_fills[si].astype(np.int32),
                    claim_fills[si].astype(np.int32),
                    unplaced[si],
                    c_dzone[si].astype(np.int32),
                    c_dct[si].astype(np.int32),
                    c_resv[si].astype(bool),
                    group_pods=scen_group_pods[si],
                    existing_nodes=nodes,
                )
                results.append(
                    Results(
                        new_node_claims=claims,
                        existing_nodes=nodes,
                        pod_errors=errors,
                    ).truncate_instance_types()
                )
        return results

    def _delta_fallback(self, reason: str) -> None:
        """Corrupt-delta half-step: invalidate the warm cluster encodings
        and the device-resident buffers so the retry re-encodes and
        re-transfers from scratch. With no degradation ladder in the port,
        the ``solver.delta_fallback`` event is its whole record."""
        self._shared_cache.cluster.invalidate(reason)
        self._shared_cache.scenario_cluster.invalidate(reason)
        for store in (
            self._shared_cache.device_store,
            self._shared_cache.scenario_device_store,
        ):
            if store is not None:
                store.reset()
        obs.event("solver.delta_fallback", reason=reason[:200])

    def _sync_if_traced(self) -> None:
        """Traced runs wait for the staging's copies and row applies, so
        the transfer span holds their time apart from the kernels';
        untraced runs let them overlap with host work."""
        if obs.active() is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _emit_audit(self, kind, sp, dclk, t0, fault_mark, **fields) -> None:
        from .. import faults

        inj = faults.active()
        fired = (
            sorted({s for s, _, _ in inj.log[fault_mark:]})
            if inj is not None
            else []
        )
        # per-tenant attribution on the audit trail: a constant per
        # configured solver, so canonical replay identity is unmoved;
        # merged into any caller-supplied attrs (scenario error details)
        attrs = dict(fields.pop("attrs", None) or {})
        if self.config.tenant:
            attrs.setdefault("tenant", self.config.tenant)
        obs.AUDIT.record(
            kind=kind,
            trace_id=getattr(sp, "trace_id", ""),
            # same clock OBJECT as t0: an install/uninstall racing the
            # solve cannot mix timebases into one delta
            duration_ms=round((dclk.now() - t0) * 1000, 3),
            encode_hash=self._shared_cache.content_hash,
            rung=self._audit_rung,
            guard=self._audit_guard,
            fault_sites=fired,
            encode_reused=self.last_encode_reused,
            delta_rows=self.last_delta_rows,
            attrs=attrs,
            **fields,
        )

    def _solve_routed(self, pods: Sequence[Pod]) -> Results:
        if self.config.force_oracle:
            self._audit_rung = "oracle"
            return self.oracle.solve(pods)
        if (
            self.oracle.reserved_capacity_enabled
            and self.oracle.reserved_offering_mode
            == RESERVED_OFFERING_MODE_STRICT
        ):
            # strict reservation policy raises mid-Add and blocks pool
            # fallback (scheduler.py:244-258): inherently sequential
            self._audit_rung = "oracle"
            self._note_fallback("strict-reservation-mode")
            return self.oracle.solve(pods)
        with obs.span("solve.partition", pods=len(pods)):
            groups, rest = enc.partition_and_group(
                pods,
                topology=self.oracle.topology,
                # the merge's exactness argument needs state-independent
                # bootstrap inputs: a reservation ledger makes offering
                # availability evolve across scan steps
                merge_bootstrap_affinity=not self.oracle.reserved_capacity_enabled,
                volume_shapes=self.prepare_volume_routing(pods),
            )
        if rest:
            self._note_fallback(f"oracle-routed-pods:{len(rest)}")

        if rest and _LOG.isEnabledFor(logging.DEBUG):
            for p in rest:
                if _ORACLE_ROUTE_CM.has_changed(p.uid, "oracle-routed"):
                    _LOG.debug(
                        "pod %s routed to the host oracle (non-tensorizable"
                        " constraints)",
                        p.metadata.name,
                    )
        dev_claims: List[DecodedClaim] = []
        dev_errors: Dict[str, object] = {}
        if groups:
            # a SolverIntegrityError (the invariant guard rejected the raw
            # kernel outputs) or a DecodeCommitError propagates: no host
            # re-solve hides a wrong kernel
            try:
                dev_claims, dev_errors = self._solve_fast(groups)
            except SolverIntegrityError as exc:
                if not self._last_incremental:
                    raise
                # the violating solve ran on a reused / row-delta encoding:
                # drop the warm state (banks, prior snapshot, device
                # buffers) and solve ONCE more, on the card, from a full
                # re-encode; a corrupt delta never commits (the guard ran
                # before decode)
                self._delta_fallback(str(exc))
                dev_claims, dev_errors = self._solve_fast(groups)
        else:
            # nothing rode the kernel: the oracle rung made this decision
            self._audit_rung = "oracle"
        results = self.oracle.solve(rest) if rest else Results(
            new_node_claims=[], existing_nodes=self.oracle.existing_nodes, pod_errors={}
        )
        results.new_node_claims = list(results.new_node_claims) + list(dev_claims)
        results.pod_errors.update(dev_errors)
        # kernel claims get the same post-solve truncation/minValues
        # validation the oracle's claims got (scheduler.go:249-267)
        return results.truncate_instance_types()

    def prepare_volume_routing(
        self, pods: Sequence[Pod]
    ) -> Optional[Dict[str, tuple]]:
        """Per-solve volume resolution for the dense attach-slot ledger.

        Returns the ``volume_shapes`` map partition_and_group consumes:
        uid -> ((shape key), {synthetic resource: request}) for every pod
        whose volumes the kernel can ledger — resolvable, counted volumes
        that are FRESH (not attached to any node) and UNSHARED within the
        batch, so "one pod = len(volumes) new attach slots per driver" is
        exact. Everything else (missing PVC, RWX sharing, re-attachment of
        an existing volume, no resolver) routes host-side. Zonal
        constraints were already injected as node affinity upstream
        (VolumeTopology.inject), so only the attach accounting lives here.
        """
        resolver = getattr(self.oracle, "volume_resolver", None)
        if resolver is None:
            return None
        candidates = [p for p in pods if p.spec.volumes]
        if not candidates:
            return None
        self._vol_resolved = {}
        seen: Dict[tuple, int] = {}
        resolved_by_uid: Dict[str, list] = {}
        for p in candidates:
            resolved, err = resolver.resolve(p)
            if err is not None:
                continue
            resolved_by_uid[p.uid] = resolved
            for r in resolved:
                if r[0]:
                    seen[(r[0], r[1])] = seen.get((r[0], r[1]), 0) + 1
        # attached (driver, vid) pairs across the cluster, computed ONCE:
        # the admission loop below must stay O(volumes), not O(volumes x
        # nodes), on the hot provisioning path
        attached: set = set()
        for en in self.oracle.existing_nodes:
            if en.volume_usage is not None:
                attached.update(en.volume_usage.attached())
        out: Dict[str, tuple] = {}
        for p in candidates:
            resolved = resolved_by_uid.get(p.uid)
            if resolved is None:
                continue
            counted = [(r[0], r[1]) for r in resolved if r[0]]
            if any(seen[c] > 1 for c in counted):
                continue  # shared volume: distinct-id dedup breaks the ledger
            if any(c in attached for c in counted):
                continue  # already attached somewhere: per-node dedup differs
            per_driver: Dict[str, int] = {}
            for d, _vid in counted:
                per_driver[d] = per_driver.get(d, 0) + 1
            shape = tuple(sorted(per_driver.items()))
            reqs = {
                enc.VOL_RES_PREFIX + d: n * res.MILLI
                for d, n in per_driver.items()
            }
            out[p.uid] = (shape, reqs)
            self._vol_resolved[p.uid] = resolved
        return out or None

    # -- fast path --------------------------------------------------------

    def _solve_fast(
        self, groups: List[enc.PodGroup]
    ) -> Tuple[List[DecodedClaim], Dict[str, object]]:
        templates = self.oracle.templates
        if not templates:
            return [], {
                p.uid: "no nodepool matched pod"
                for g in groups
                for p in g.pods
            }
        with obs.span("solve.encode", groups=len(groups)):
            snap, avail, nmax_hint, lease_cache, delta = self._encode_batch(
                groups
            )
        self.last_encode_reused = delta.reused
        self.last_delta_rows = delta.delta_rows
        obs.event(
            "encode.delta", reused=delta.reused, delta_rows=delta.delta_rows
        )
        a_tzc, res_cap0, a_res = avail
        fit = self._fit_matrix(snap)
        # adaptive sizing inside _select_nmax; undershoot is caught by the
        # overflow-doubling retry below
        nmax = self._select_nmax(snap, fit, nmax_hint)
        # bucketed axis sizes: the kernels run on the padded snapshot
        G = enc._next_pow2(len(snap.groups), floor=8)
        N = enc._next_pow2(len(snap.existing_names), floor=1) if snap.existing_names else 0
        statics = self._kernel_statics(snap, G)
        # outside the ported pack scope: raise before anything launches
        check_scope(
            statics["tile_feasibility"], res_cap0.shape[0], snap.p_mvmin.shape[1],
        )
        snap_run = snap.padded(G, N)
        # device residency: the encoded cluster stays on the device between
        # solves (buffers keyed by the encode delta's class versions,
        # solver/residency.py), so this stage moves only the changed rows,
        # or nothing on the content-hash fast path
        store = self._shared_cache.lease_device_store()
        with obs.span(
            "solve.transfer",
            reused=bool(delta.reused),
            delta_rows=int(delta.delta_rows),
        ):
            args = store.stage(
                enc.SOLVE_ARG_NAMES,
                list(snap_run.solve_args(a_tzc, res_cap0, a_res)),
                delta, self.device,
            )
            self._sync_if_traced()
        self._last_incremental = store.last_incremental or delta.reused
        # fill entries are capped at n_fit = capacity/request per claim
        # (packing.py), so this host-side bound proves int16 safety
        fills_dtype = (
            torch.int16 if self._fill_bound(snap, fit) < 2**15 else torch.int32
        )
        from ..ops.solve import dispatch_classed_packed, dispatch_packed

        # the class-batched scan where the JAX router takes it; its class
        # arrays are per solve, staged beside the resident args
        classed_args = self._classed_partition(snap_run, res_cap0)
        if classed_args is not None:
            cls_host, lmax = classed_args
            cls_arrays = [
                put(name, arr, self.device)
                for name, arr in zip(_CLASS_ARG_NAMES, cls_host)
            ]

        def call(nmax):
            if classed_args is not None:
                out = dispatch_classed_packed(
                    *args, *cls_arrays, nmax=nmax, lmax=lmax,
                    fills_dtype=fills_dtype, **statics,
                )
            else:
                out = dispatch_packed(
                    *args, nmax=nmax, fills_dtype=fills_dtype, **statics
                )
            (c_pool, packed, n_open, overflow,
             exist_fills, claim_fills, unplaced, c_dzone, c_dct,
             c_resv) = self._drain_host(out)
            # the type mask stays bit-packed: _decode unpacks only the
            # distinct rows it actually touches
            return (
                c_pool.astype(np.int32), packed, n_open, overflow,
                exist_fills.astype(np.int32),
                claim_fills.astype(np.int32), unplaced,
                c_dzone.astype(np.int32), c_dct.astype(np.int32),
                c_resv.astype(bool),
            )

        while True:
            with obs.span("solve.dispatch", nmax=nmax):
                outs = call(nmax)
            self.last_dispatches += 1
            if not outs[3]:  # overflow
                break
            nmax *= 2
        (c_pool, c_tmask, n_open, overflow,
         exist_fills, claim_fills, unplaced, c_dzone, c_dct,
         c_resv) = outs
        # invariant guard BEFORE decode: a violating solve is discarded
        # with zero state mutated (faults/guard.py)
        with obs.span("solve.guard"):
            self._verify_solution(
                snap, snap_run, c_pool, c_tmask, int(n_open),
                exist_fills, claim_fills, unplaced, nmax,
                c_dzone=c_dzone, c_dct=c_dct,
            )
        if self.config.max_claims is None:
            with self._shared_cache.lock:
                lease_cache["nmax_hint"] = max(
                    lease_cache.get("nmax_hint", 0), int(n_open)
                )
        try:
            with obs.span("solve.decode", claims=int(n_open)):
                return self._decode(
                    snap, c_pool, c_tmask, int(n_open), exist_fills,
                    claim_fills, unplaced, c_dzone, c_dct, c_resv,
                )
        except Exception as exc:
            # decode mutates the live existing-node models as it walks; a
            # crash here may have HALF-committed — flag it so no caller
            # re-solves over the polluted models
            raise DecodeCommitError(
                f"decode aborted mid-commit: {type(exc).__name__}: {exc}"
            ) from exc


    @staticmethod
    def _vocab_bound(snap, kid: int) -> int:
        """Valid value-id bound for a vocab key id (0 when absent)."""
        if 0 <= kid < len(snap.vocab.values):
            return len(snap.vocab.values[kid])
        return 0

    def _verify_solution(
        self, snap, snap_run, c_pool, c_tmask, n_open,
        exist_fills, claim_fills, unplaced, nmax, g_count=None,
        c_dzone=None, c_dct=None,
    ) -> None:
        """Raise SolverIntegrityError if the raw kernel outputs violate a
        post-solve invariant. Runs on every solve (a few small host
        matmuls); the error propagates out of solve().
        ``g_count`` overrides the run snapshot's counts for scenario
        fan-out, where each scenario activates its own subset."""
        violations = check_solution(
            g_count=snap_run.g_count if g_count is None else g_count,
            g_req=snap_run.g_req,
            c_pool=c_pool,
            c_tmask=c_tmask,
            n_open=n_open,
            exist_fills=exist_fills,
            claim_fills=claim_fills,
            unplaced=unplaced,
            t_alloc=snap.t_alloc,
            n_avail=snap.n_avail,
            nmax=nmax,
            P=len(snap.templates),
            templates_pool=[
                nct.node_pool_name for nct in snap.templates
            ],
            p_limit=snap.p_limit,
            p_has_limit=snap.p_has_limit,
            c_dzone=c_dzone,
            c_dct=c_dct,
            zone_vals=self._vocab_bound(snap, snap.zone_kid),
            ct_vals=self._vocab_bound(snap, snap.ct_kid),
        )
        if violations:
            raise SolverIntegrityError(violations)

    def _encode_batch(self, groups: List[enc.PodGroup], scenario: bool = False):
        """Encode ``groups`` against the shared cache. Returns
        (snap, (a_tzc, res_cap0, a_res), nmax_hint, cache, delta) —
        ``cache`` is the LEASED dict this encode ran against; post-solve
        hint writes must target it (not a re-fetched
        self._shared_cache.cache, which a concurrent lease under a changed
        catalog may have replaced — a stale hint written into a fresh
        catalog's dict would mis-size that catalog's first NMAX).
        ``delta`` is the ClusterEncoding's EncodeDelta for this encode.
        ``scenario`` selects the scenario-side ClusterEncoding so
        consolidation searches warm independently of provisioning."""
        templates = self.oracle.templates
        its_by_pool = {
            nct.node_pool_name: nct.instance_type_options for nct in templates
        }
        with self._shared_cache.lock:
            vocab, cache = self._shared_cache.lease(
                templates, its_by_pool, self.oracle.daemon_overhead,
                self.pool_limits,
            )
            cluster = (
                self._shared_cache.scenario_cluster
                if scenario
                else self._shared_cache.cluster
            )
            snap = enc.encode(
                groups,
                templates,
                its_by_pool,
                existing_nodes=self.oracle.existing_nodes,
                daemon_overhead=self.oracle.daemon_overhead,
                pool_limits=self.pool_limits,
                vocab=vocab,
                cache=cache,
                cluster=cluster,
            )
            delta = cluster.last_delta
            reserved_enabled = self.oracle.reserved_capacity_enabled
            avail_key = ("a_tzc", reserved_enabled) + snap.vocab.padded_shape()
            avail = cache.get(avail_key)
            if avail is None:
                avail = cache[avail_key] = self._offering_availability(
                    snap, reserved_enabled
                )
            nmax_hint = cache.get("nmax_hint")
        return snap, avail, nmax_hint, cache, delta

    def _select_nmax(self, snap: enc.EncodedSnapshot, fit, nmax_hint) -> int:
        """NMAX for this snapshot: config override, else the a-priori
        estimate, tightened by the observed-claim-count hint when one has
        been recorded for this catalog."""
        nmax = self.config.max_claims or self._estimate_nmax(snap, fit)
        if self.config.max_claims is None and nmax_hint:
            # size to the observed claim count's own power-of-two bucket
            # (+8 slack), not 1.5x it: the old headroom pushed any hint in
            # (0.66, 1.0] of a bucket into the NEXT one, doubling every
            # [NMAX] op in the scan (diverse-ref: 1000 claims ran at 2048).
            # Claim-count growth past the bucket is caught by the
            # overflow-doubling retry — one extra dispatch on the rare
            # solve that crosses a boundary, instead of 2x kernel cost on
            # every solve that doesn't.
            adaptive = max(
                enc._next_pow2(int(nmax_hint) + 8, floor=8),
                enc._next_pow2(self._nmax_floor(snap, fit), floor=8),
            )
            nmax = min(nmax, adaptive)
        return nmax

    def _kernel_statics(self, snap: enc.EncodedSnapshot, G: int) -> dict:
        """The static kernel arguments for this snapshot; ``G`` is the
        bucketed group-axis size the kernels run at."""
        P = len(snap.templates)
        T = len(snap.instance_types)
        # HBM-scaling gate (SURVEY §7.4.6): beyond ~1.5 GiB of feasibility
        # tables the JAX scan computes per-group rows instead (not ported)
        tiled = P * G * T * 5 > (3 << 29)
        return dict(
            zone_kid=snap.zone_kid,
            ct_kid=snap.ct_kid,
            has_domains=bool((snap.g_dmode > 0).any()),
            has_contrib=bool(snap.g_hcontrib.any() or snap.g_dcontrib.any()),
            tile_feasibility=tiled,
            wf_iters=self._wf_iters(snap),
            sparse_groups=not tiled,
        )

    # below this mean (real groups per feasibility class), per-class head
    # amortization cannot beat the per-group scan's simpler carry
    _CLASSED_MIN_MEAN_SIZE = 4.0

    def _classed_partition(self, snap_run, res_cap0):
        """Class arrays for the class-batched scan, or None for the
        per-group scan (driver.py:_classed_partition, without its
        environment override: ``SolverConfig.classed`` is the only
        switch). Auto mode routes by mean class size: batches like the
        diverse mix (~63 groups per class) take the classed scan; batches
        where every group is its own class stay on pack(). A reservation
        ledger (NRES > 0) always uses pack(); so do minValues batches with
        domain-dynamic groups unless the classed scan is forced."""
        cfg = self.config.classed
        if cfg is False or res_cap0.shape[0] != 0:
            return None
        if (
            cfg is not True
            and snap_run.p_mvmin.shape[1]
            and bool((snap_run.g_dmode > 0).any())
        ):
            return None
        out = enc.class_partition(
            snap_run,
            min_mean_size=0.0 if cfg is True else self._CLASSED_MIN_MEAN_SIZE,
        )
        if out is None:
            return None
        cs, cl, cdyn, cdk, inv, lmax = out
        if cfg is not True:
            n_classes = int((cl > 0).sum())
            if (
                n_classes == 0
                or len(snap_run.groups) / n_classes < self._CLASSED_MIN_MEAN_SIZE
            ):
                return None
        return (cs, cl, cdyn, cdk, inv), lmax

    def _fit_matrix(self, snap: enc.EncodedSnapshot) -> np.ndarray:
        """[G, T] unconstrained pods-per-node fit (inf where a group has no
        positive request). Shared by the NMAX estimate and the fill bound."""
        alloc = snap.t_alloc[None, :, :] - np.min(snap.p_daemon, axis=0)[None, None, :]
        req = snap.g_req[:, None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(req > 0, np.floor(alloc / np.maximum(req, 1e-9)), np.inf)
        return np.min(per, axis=-1)

    def _fill_bound(self, snap: enc.EncodedSnapshot, fit: np.ndarray) -> int:
        """Largest pod count one claim/node can take from one group: per
        group, min(best type fit, group size); the max over groups bounds
        every fill entry, proving narrow output dtypes safe."""
        best = fit.max(axis=1)  # [G] best type fit (may be inf)
        if snap.n_avail.shape[0]:
            req = snap.g_req[:, None, :]
            with np.errstate(divide="ignore", invalid="ignore"):
                per_n = np.where(
                    req > 0,
                    np.floor(snap.n_avail[None, :, :] / np.maximum(req, 1e-9)),
                    np.inf,
                )
            best = np.maximum(best, np.min(per_n, axis=-1).max(axis=1))
        # the hostname-topology caps (private and shared) bound every fill;
        # gate-role g_hscap values are thresholds, not caps, so they only
        # bound self-counted groups
        shared_cap = np.where(snap.g_hself, snap.g_hscap, enc.HCAP_NONE)
        best = np.minimum(np.minimum(best, snap.g_hcap), shared_cap)
        capped = np.minimum(best, snap.g_count.astype(np.float64))
        return int(capped.max()) if capped.size else 0

    def _wf_iters(self, snap: enc.EncodedSnapshot) -> int:
        """Static bisection budget for the kernel's waterfills.

        Every water level the scan can ever probe is bounded by
        (slot prior) + (slot capacity): claim slots carry at most the
        pods-per-entity capacity (the "pods" resource column when tracked,
        else the batch total), domain slots at most the cluster prior plus
        one group's count. ceil(log2(bound)) + 1 trips pin the bisection;
        32 is the int32-safe fallback."""
        total = int(snap.g_count.sum())
        npods_bound = total
        if "pods" in snap.resource_names:
            col = snap.resource_names.index("pods")
            caps = []
            if snap.t_cap.size:
                caps.append(float(np.max(snap.t_cap[:, col])))
            if snap.n_avail.size:
                caps.append(float(np.max(snap.n_avail[:, col])))
            if caps:
                npods_bound = min(total, int(max(caps)))
        prior_bound = int(snap.g_dprior.max()) if snap.g_dprior.size else 0
        # shared-domain carries accumulate other groups' placements into D0
        # across steps, so the domain level can reach priors + batch total
        if (snap.g_dtg >= 0).any() or snap.g_dcontrib.any():
            prior_bound += total
        count_bound = int(snap.g_count.max()) if snap.g_count.size else 0
        level_bound = max(npods_bound, prior_bound) + count_bound + 2
        need = max(1, int(level_bound).bit_length() + 1)
        # bucket to {8, 16, 32}: wf_iters is a static jit arg, and a raw
        # bit_length would fork the compile cache on mere pod-count changes
        # across solves whose bucketed G/N shapes are otherwise identical
        for bucket in (8, 16, 32):
            if need <= bucket:
                return bucket
        return 32

    def _estimate_nmax(self, snap: enc.EncodedSnapshot, fit: np.ndarray) -> int:
        """Host-side claim-count bound: pods per node by the best
        unconstrained fit, clamped by the hostname-topology per-entity cap
        (a maxSkew=1 hostname spread means one claim per pod). Compatibility
        can only shrink the real fit, so this may undershoot; the overflow
        retry doubles NMAX in that case."""
        n_fit = np.where(np.isfinite(fit), fit, 0)
        shared_cap = np.where(snap.g_hself, snap.g_hscap, enc.HCAP_NONE)
        best = np.maximum(
            np.minimum(np.minimum(n_fit.max(axis=1), snap.g_hcap), shared_cap),
            1,
        )
        per_group = np.ceil(snap.g_count / best)
        # hostname-capped groups (spread/anti) SHARE claims: each claim
        # takes up to cap pods from EVERY such group, so their demand is
        # the max, not the sum (summing overestimated a 20-deployment
        # hostname-spread mix 30x, quadrupling kernel time). Resource
        # pressure that breaks sharing is caught by the overflow retry.
        # EXCEPT groups feeding one shared constraint slot: the cap counts
        # their placements jointly (a cross-shape anti-affinity Deployment
        # needs one claim per pod across ALL its shape groups), so demand
        # within a slot sums; distinct slots still share claims.
        capped, demand = self._capped_demand(snap, per_group)
        base = int(per_group[~capped].sum()) + demand
        # domain-constrained groups open claims per domain (zonal spread
        # water-fills across zones), so each may strand partial claims
        # beyond its ceil — at most one per extra domain, and never more
        # than its pod count affords (a 1-pod group strands none)
        dyn = snap.g_dmode > 0
        if len(snap.groups):
            dregs = snap.g_dreg.sum(axis=1)
            extra_per = np.clip(
                np.minimum(snap.g_count - per_group, dregs - 1), 0, None
            )
            extra = int(extra_per[dyn].sum())
        else:
            extra = 0
        # per-group partial-claim slack: only groups with >= 2 pods can
        # leave a partial claim beyond their ceil
        slack = int((snap.g_count >= 2).sum())
        return enc._next_pow2(base + slack + extra + 8, floor=8)

    def _capped_demand(self, snap: enc.EncodedSnapshot, per_group):
        """(capped mask, claim demand) of hostname-capped groups: private
        caps share claims (max); groups on one shared slot count jointly
        (sum within slot, max across)."""
        shared_cap = np.where(snap.g_hself, snap.g_hscap, enc.HCAP_NONE)
        priv_capped = (snap.g_hcap < enc.HCAP_NONE) & ~(
            snap.g_hself & (snap.g_hstg >= 0)
        )
        shared_self = (shared_cap < enc.HCAP_NONE) & (snap.g_hstg >= 0)
        capped = priv_capped | shared_self
        demands = []
        if priv_capped.any():
            demands.append(per_group[priv_capped].max())
        for slot in np.unique(snap.g_hstg[shared_self]):
            demands.append(
                per_group[shared_self & (snap.g_hstg == slot)].sum()
            )
        return capped, (int(max(demands)) if demands else 0)

    def _nmax_floor(self, snap: enc.EncodedSnapshot, fit: np.ndarray) -> int:
        """Hard lower bound on claims: total pods over the largest
        pods-per-claim capacity, plus the hostname-capped demand (an
        anti-affinity group needs a claim per pod regardless of capacity).
        Keeps the adaptive hint from starting a doubling ladder far below
        any feasible size."""
        total = int(snap.g_count.sum())
        cap = total
        if "pods" in snap.resource_names and snap.t_cap.size:
            col = snap.resource_names.index("pods")
            cap = max(1, int(np.max(snap.t_cap[:, col])))
        n_fit = np.where(np.isfinite(fit), fit, 0)
        shared_cap = np.where(snap.g_hself, snap.g_hscap, enc.HCAP_NONE)
        best = np.maximum(
            np.minimum(np.minimum(n_fit.max(axis=1), snap.g_hcap), shared_cap),
            1,
        )
        _, demand = self._capped_demand(snap, np.ceil(snap.g_count / best))
        return max(-(-total // max(cap, 1)), demand)

    def _offering_availability(
        self, snap: enc.EncodedSnapshot, reserved_enabled: bool = False
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(A[T, Vz, Vc], res_cap0[NRES], a_res[NRES, T, Vz, Vc]).

        A: type t has an available offering in (zone z, ct c). With the
        reservation ledger active, reserved offerings are EXCLUDED from A
        and contribute per-reservation availability in a_res instead; the
        kernel re-admits them while their ledger capacity lasts
        (reservationmanager.go:28-85)."""
        T, O = snap.o_avail.shape
        _, V1 = snap.vocab.padded_shape()
        A = np.zeros((T, V1, V1), dtype=bool)
        rids: Dict[str, int] = {}
        caps: List[int] = []
        res_cells: List[Tuple[int, int, int, int]] = []  # (rid, t, z, c)
        for t, it in enumerate(snap.instance_types):
            for o, off in enumerate(it.offerings):
                if (
                    reserved_enabled
                    and off.capacity_type() == labels_mod.CAPACITY_TYPE_RESERVED
                ):
                    # the ledger tracks the least capacity seen per id over
                    # ALL offerings, available or not (reservation.py:15-23)
                    rid = off.reservation_id()
                    r = rids.setdefault(rid, len(rids))
                    if r == len(caps):
                        caps.append(off.reservation_capacity)
                    else:
                        caps[r] = min(caps[r], off.reservation_capacity)
                    if not snap.o_avail[t, o]:
                        continue
                    z, c = snap.o_zone[t, o], snap.o_ct[t, o]
                    if z >= 0 and c >= 0:
                        res_cells.append((r, t, z, c))
                    continue
                if not snap.o_avail[t, o]:
                    continue
                z, c = snap.o_zone[t, o], snap.o_ct[t, o]
                if z >= 0 and c >= 0:
                    A[t, z, c] = True
                elif z >= 0:
                    A[t, z, :] = True
                elif c >= 0:
                    A[t, :, c] = True
                else:
                    A[t, :, :] = True
        nres = len(caps)
        a_res = np.zeros((nres, T, V1, V1), dtype=bool)
        for r, t, z, c in res_cells:
            a_res[r, t, z, c] = True
        return A, np.asarray(caps, dtype=np.int32), a_res

    # -- decode -----------------------------------------------------------

    def _decode(
        self,
        snap: enc.EncodedSnapshot,
        c_pool: np.ndarray,  # [NMAX]
        c_tmask: np.ndarray,  # [NMAX, T]
        n_open: int,
        exist_fills: np.ndarray,  # [G, N]
        claim_fills: np.ndarray,  # [G, NMAX]
        unplaced: np.ndarray,  # [G]
        c_dzone: Optional[np.ndarray] = None,  # [NMAX] pinned zone value ids
        c_dct: Optional[np.ndarray] = None,  # [NMAX] pinned capacity-type ids
        c_resv: Optional[np.ndarray] = None,  # [NMAX] claim holds reservations
        group_pods: Optional[List[List[Pod]]] = None,
        existing_nodes: Optional[List] = None,
    ) -> Tuple[List[DecodedClaim], Dict[str, object]]:
        """``group_pods``/``existing_nodes`` override the decode targets for
        scenario fan-out: scenario s places only its ACTIVE subset of each
        group's pods (group members are equivalent, so any k of them decode
        a fill of k), and commits fills onto per-scenario node clones so
        scenarios never see each other's placements."""
        self._cursors = {}
        existing = (
            existing_nodes if existing_nodes is not None
            else self.oracle.existing_nodes
        )

        def pods_of(gi: int) -> List[Pod]:
            return (
                group_pods[gi] if group_pods is not None
                else snap.groups[gi].pods
            )

        # existing-node fills: commit pods + requests onto the oracle's
        # ExistingNode models so a subsequent oracle pass sees them.
        # Iterate sparse nonzeros only; group-major order so pod cursors
        # advance deterministically per group.
        for gi, ni in zip(*np.nonzero(exist_fills)):
            g = snap.groups[gi]
            en = existing[ni]
            k = int(exist_fills[gi, ni])
            pods = pods_of(gi)[self._g_cursor(gi) : self._g_cursor(gi) + k]
            self._advance(gi, k)
            en.pods.extend(pods)
            en.requests = res.merge(en.requests, *(p.spec.requests for p in pods))
            en.requirements.add(*g.requirements.values())
            # attach-slot ledger commit: mirror ExistingNode.add's
            # volume_usage.add so a subsequent oracle pass (and the next
            # encode's remaining-slot columns) see the attachments
            if en.volume_usage is not None:
                for p in pods:
                    rv = self._vol_resolved.get(p.uid)
                    if rv:
                        en.volume_usage.add(p, rv)

        claims: List[DecodedClaim] = []
        claim_by_slot: Dict[int, DecodedClaim] = {}
        type_ids_cache: Dict[bytes, List[cp.InstanceType]] = {}
        resv_ledger: Optional[Dict[str, int]] = None
        T = len(snap.instance_types)
        packed = c_tmask.dtype == np.uint8 and c_tmask.shape[1] != T
        for slot in range(n_open):
            nct = snap.templates[int(c_pool[slot])]
            row = c_tmask[slot]
            tkey = row.tobytes()
            options = type_ids_cache.get(tkey)
            if options is None:
                if packed:
                    row = np.unpackbits(row)[:T]
                options = [
                    snap.instance_types[t] for t in np.nonzero(row)[0]
                ]
                type_ids_cache[tkey] = options
            claim = DecodedClaim(
                nct, [], options, Requirements(*nct.requirements.values())
            )
            # domain-pinned claims (zonal spread / affinity bootstrap) carry
            # the selected domain as a concrete requirement so the created
            # node lands there (the oracle tightens the in-flight claim the
            # same way, topology.go:220-242)
            for pins, key in (
                (c_dzone, labels_mod.TOPOLOGY_ZONE),
                (c_dct, labels_mod.CAPACITY_TYPE_LABEL_KEY),
            ):
                if pins is None or pins[slot] < 0:
                    continue
                kid = snap.vocab.key_ids[key]
                claim.requirements.add(
                    Requirement(
                        key, Operator.IN, [snap.vocab.values[kid][int(pins[slot])]]
                    )
                )
            if c_resv is not None and c_resv[slot]:
                # mirror the oracle's InFlightNodeClaim surface by replaying
                # the ledger in slot order (claims open in scan order, so
                # this reproduces the kernel's debits): a claim holds only
                # the compatible reserved offerings that still had capacity
                # when it opened
                if resv_ledger is None:
                    resv_ledger = {}
                    for it in snap.instance_types:
                        for o in it.offerings:
                            if (
                                o.capacity_type()
                                == labels_mod.CAPACITY_TYPE_RESERVED
                            ):
                                rid = o.reservation_id()
                                resv_ledger[rid] = min(
                                    resv_ledger.get(rid, o.reservation_capacity),
                                    o.reservation_capacity,
                                )
                held = []
                for it in options:
                    for o in it.offerings:
                        if (
                            o.available
                            and o.capacity_type()
                            == labels_mod.CAPACITY_TYPE_RESERVED
                            and resv_ledger.get(o.reservation_id(), 0) > 0
                            and claim.requirements.is_compatible(
                                o.requirements, labels_mod.WELL_KNOWN_LABELS
                            )
                        ):
                            held.append(o)
                # one slot per reservation ID per claim (a rid may back
                # offerings on several instance types), matching the
                # kernel's res_rem[r] -= k
                # analysis: sanctioned[DET1101] per-rid decrements commute
                for rid in {o.reservation_id() for o in held}:
                    resv_ledger[rid] -= 1
                claim.reserved_offerings = held
            claim_by_slot[slot] = claim
            claims.append(claim)
        for gi, slot in zip(*np.nonzero(claim_fills)):
            g = snap.groups[gi]
            claim = claim_by_slot.get(int(slot))
            if claim is None:
                continue
            k = int(claim_fills[gi, slot])
            claim.pods.extend(
                pods_of(gi)[self._g_cursor(gi) : self._g_cursor(gi) + k]
            )
            self._advance(gi, k)
            claim.requirements.add(*g.requirements.values())

        errors: Dict[str, object] = {}
        for gi, g in enumerate(snap.groups):
            n_err = int(unplaced[gi])
            if n_err:
                for p in pods_of(gi)[
                    self._g_cursor(gi) : self._g_cursor(gi) + n_err
                ]:
                    errors[p.uid] = "no feasible instance type/template for pod group"
        return claims, errors

    def _g_cursor(self, gi: int) -> int:
        return self._cursors.get(gi, 0)

    def _advance(self, gi: int, k: int) -> None:
        self._cursors[gi] = self._cursors.get(gi, 0) + k
