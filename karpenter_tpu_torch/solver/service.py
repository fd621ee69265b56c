# Copied from karpenter_tpu/solver/service.py, building TorchSolvers; the union solve marks a fault of the card (TenantService._solve_union), the binary solves on the card; its docstrings name the port's device.
"""Solver sidecar: multi-tenant gRPC service over the wire codec.

The deployment splits the control plane from the solver: each
controller process (Go-shaped, level-triggered) ships snapshots to this
sidecar, which runs the fused feasibility/packing kernels on its CUDA
card and returns packed claims (SURVEY.md §5). In-process callers keep
using TorchSolver directly; RemoteSolver is the same seam behind a
channel.

Many control planes share one sidecar (the multi-tenant service,
solver/tenancy.py): the tenant id rides the ``ktpu-tenant-id`` request
metadata, and every tenant gets its OWN warm state (``EncodeCache`` →
row banks + device buffers) and its OWN degradation ladder — isolation
machinery, admission control, and QoS tiers live in ``TenantRegistry``.
Error contract over the hop:

- RESOURCE_EXHAUSTED — admission rejected (rate limit, queue bound,
  tier shed, tenant capacity). The client must BACK OFF; solving the
  same view in-process would defeat the quota.
- DEADLINE_EXCEEDED — the solve ran but blew the tenant's latency
  budget. The client's retry/fallback ladder treats it like a slow
  sidecar and falls back in-process.
- INVALID_ARGUMENT / INTERNAL — malformed request / sidecar bug, as
  before. A fault of the card itself (a kernel that did not build or
  launch, a CUDA error, a guard rejection of the card's outputs) is
  INTERNAL on every lane: the batch lane hands it to every participant
  (tenancy.is_card_fault) instead of declining to solo solves.

gRPC's default 4 MiB receive limit bounds a request, as in the JAX
package (``serve`` sets no message-size option): a catalog of a few
hundred instance types and a few thousand pods fill it.

The service is defined with grpc generic handlers over the msgpack codec
in wire.py — no generated stubs, one method:

    /karpenter_tpu.solver.v1.Solver/Solve   (unary-unary, bytes in/out)
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import logging
from concurrent import futures
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import grpc
import msgpack

from .. import faults, obs
from ..api.objects import NodePool, Pod
from ..cloudprovider import types as cp
from ..kube import Client, TestClock
from ..scheduling.scheduler import Results
from ..scheduling.topology import Topology
from . import wire
from .driver import (
    DecodedClaim,
    EncodeCache,
    Scenario,
    SolverConfig,
    TorchSolver,
)
from .tenancy import (
    DEFAULT_TENANT,
    AdmissionError,
    CrossTenantBatcher,
    DeadlineOverrunError,
    TenantRegistry,
    TenantState,
)

_LOG = logging.getLogger("karpenter_tpu_torch.solver.service")

SERVICE_NAME = "karpenter_tpu.solver.v1.Solver"
SOLVE_METHOD = f"/{SERVICE_NAME}/Solve"

# request metadata key carrying the caller's tenant id (lowercase per
# gRPC metadata rules); absent → the "default" tenant. Tier assignment
# is SERVER configuration (TenantRegistry), never client metadata.
TENANT_ID_METADATA_KEY = "ktpu-tenant-id"

# gRPC status codes that mean "the sidecar may answer if asked again" —
# RemoteSolver retries these once, then degrades to an in-process solve
RETRIABLE_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED")
# admission backpressure: retry once after the bounded retry, then RAISE
# (SolverBackpressure) instead of falling back in-process — the service
# refused to spend quota on this view, the client must back off
BACKPRESSURE_CODES = ("RESOURCE_EXHAUSTED",)


class SolverBackpressure(RuntimeError):
    """The sidecar's admission control rejected the solve twice — the
    caller should requeue with backoff. Deliberately NOT an in-process
    fallback: the tenant is over quota, not the sidecar unreachable."""

    def __init__(self, tenant: str, detail: str):
        super().__init__(
            f"solver sidecar admission backpressure"
            + (f" for tenant {tenant!r}" if tenant else "")
            + f": {detail}"
        )
        self.tenant = tenant
        self.detail = detail


class InjectedRpcError(grpc.RpcError):
    """Fault-injection stand-in for a channel-level RPC failure, carrying
    a status code the way a real ``grpc.Call`` error does. Fault plans
    raise this at the ``faults.REMOTE_SOLVE`` site."""

    def __init__(self, code: "grpc.StatusCode"):
        super().__init__(f"injected rpc failure: {code}")
        self._code = code

    def code(self):
        return self._code


def _status_name(exc: "grpc.RpcError") -> str:
    """The status-code name of an RpcError ("UNAVAILABLE", ...), tolerant
    of both real channel errors and injected ones."""
    code = getattr(exc, "code", None)
    if callable(code):
        try:
            code = code()
        except Exception:
            return ""
    return getattr(code, "name", str(code) if code is not None else "")


def build_solver(
    pods: Sequence[Pod],
    node_pools: Sequence[NodePool],
    instance_types,
    daemonset_pods: Sequence[Pod],
    state_nodes: Sequence,
    volume_objects,
    reserved_capacity_enabled: bool,
    config: Optional[SolverConfig] = None,
    encode_cache: Optional[EncodeCache] = None,
    copy_objects: bool = False,
) -> TorchSolver:
    """The one recipe for a solver over a shipped cluster view — used by
    the sidecar for every request and by RemoteSolver's in-process
    fallback, so the two can never pack differently.

    Rebuilds the controller's cluster view: state nodes pack FIRST
    (scheduler.go:357-425), their bound pods feed the topology priors and
    inverse anti-affinity gates, and PVC/PV/StorageClass objects let the
    VolumeResolver answer identically — so the scratch client holds them.
    ``copy_objects`` deep-copies objects into the scratch store (the
    fallback path feeds LIVE controller objects, and the scratch create
    must not bump their resource versions). The scratch store is plain
    memory, not an apiserver — store-chaos plans are exempted so an
    injected store outage can't crash the fallback built to survive it."""
    scratch = Client(TestClock(), fault_injection=False)

    def _add(obj):
        scratch.create(copy.deepcopy(obj) if copy_objects else obj)

    for sn in state_nodes:
        if sn.node is not None:
            _add(sn.node)
        for p in sn.pods:
            _add(p)
    for vo in volume_objects or ():
        _add(vo)
    topology = Topology(scratch, state_nodes, node_pools, instance_types, pods)
    from ..scheduling.volumeusage import VolumeResolver

    # clients predating the volume protocol (volume_objects is None, not
    # []) never ship PVC/PV objects; resolving against the empty scratch
    # store would fail every PVC-bearing pod, so keep the old no-resolver
    # behavior for them
    resolver = VolumeResolver(scratch) if volume_objects is not None else None
    return TorchSolver(
        node_pools,
        instance_types,
        topology,
        state_nodes=state_nodes,
        daemonset_pods=daemonset_pods,
        volume_resolver=resolver,
        config=config,
        # catalog encode amortizes across requests; the cache's lock
        # serializes the host-side encode under the gRPC thread pool
        encode_cache=encode_cache,
        reserved_capacity_enabled=reserved_capacity_enabled,
    )


def _solve_snapshot(data: bytes, config: Optional[SolverConfig]) -> bytes:
    return _solve_decoded(wire.decode_solve_request(data), config)


def _solve_objects(
    snap: dict,
    config: Optional[SolverConfig],
    encode_cache: Optional[EncodeCache] = None,
):
    """One decoded snapshot solved end to end; returns ``(results,
    solver)`` so the tenant layer can read the solver's telemetry
    (fallback_solves) without re-plumbing it through the wire."""
    pods: List[Pod] = snap["pods"]
    solver = build_solver(
        pods,
        snap["node_pools"],
        snap["instance_types"],
        snap["daemonset_pods"],
        snap["state_nodes"],
        snap["volume_objects"],
        # behavior knobs travel in the snapshot so controller and sidecar
        # can never disagree on gate-dependent packing
        bool(snap["solver_options"].get("reserved_capacity_enabled", False)),
        config=config,
        encode_cache=encode_cache,
    )
    return solver.solve(pods), solver


def _solve_decoded(
    snap: dict,
    config: Optional[SolverConfig],
    encode_cache: Optional[EncodeCache] = None,
) -> bytes:
    results, _solver = _solve_objects(snap, config, encode_cache)
    return wire.encode_solve_response(
        results, state_nodes_packed=len(snap["state_nodes"])
    )


def _batch_key(snap: dict) -> Optional[str]:
    """Content key under which a snapshot may join a cross-tenant
    microbatch, or None when its shape must solo-solve.

    Only the shapes whose scenario-batched answer is PROVABLY the solo
    answer batch: identical catalog sections (hashed below — tenants
    with different catalogs land in different batches, never a wrong
    one), no volume objects (the VolumeResolver's scratch store is
    per-request), no pool limits (a shared kernel ledger would meter
    the union, not each tenant), and no topology-spread/affinity pods
    (union topology priors would leak one tenant's bound pods into
    another's spread counting). Everything else declines to the solo
    path — a lost batching opportunity, never a lost decision."""
    if snap["volume_objects"]:
        return None
    for np_ in snap["node_pools"]:
        if getattr(np_.spec, "limits", None):
            return None
    for p in snap["pods"]:
        spec = p.spec
        if getattr(spec, "topology_spread_constraints", None) or getattr(
            spec, "affinity", None
        ):
            return None
    for sn in snap["state_nodes"]:
        # scenario exclusion masks key on provider ids: a node without
        # one cannot be masked out of the other tenants' scenarios
        if not getattr(sn, "provider_id", ""):
            return None
    payload = msgpack.packb(
        wire.to_wire(
            [
                snap["node_pools"],
                snap["instance_types"],
                snap["daemonset_pods"],
                snap["solver_options"],
                snap["volume_objects"] is None,  # old-protocol marker
            ]
        ),
        use_bin_type=True,
    )
    return hashlib.blake2b(payload, digest_size=12).hexdigest()


class TenantService:
    """Multi-tenant solve orchestration behind the gRPC surface.

    One instance per sidecar process: holds the ``TenantRegistry`` (per-
    tenant warm state + admission control), the cross-tenant batcher,
    and the shared-batch-lane ``EncodeCache`` (its OWN isolation domain:
    a corrupt delta in the batch lane sheds the batch lane, never a
    tenant's private cache). Also the in-process facade the concurrency
    storm, the chaos suite, and ``bench.py --tenants`` drive — the gRPC
    handler is a thin codec shell around ``solve_encoded``."""

    def __init__(
        self,
        registry: Optional[TenantRegistry] = None,
        config: Optional[SolverConfig] = None,
        batch_window: float = 0.0,
        batch_max: int = 8,
    ):
        self.registry = registry if registry is not None else TenantRegistry()
        self._base_config = config
        self.batcher = CrossTenantBatcher(
            window=batch_window, max_batch=batch_max
        )
        self._batch_cache = EncodeCache(owner="__batch__")

    def solve_for(self, tenant_id: str, snap: dict) -> Results:
        """Admission → (batched | solo) solve → deadline check, with the
        tenant's ambient fault scope around everything that runs on its
        behalf. Raises ``AdmissionError`` before any work and
        ``DeadlineOverrunError`` after a budget-blowing solve."""
        lease = self.registry.admit(tenant_id)  # AdmissionError propagates
        tenant = lease.tenant
        try:
            t0 = self.registry.clock.now()
            with faults.ambient(tenant=tenant_id):
                # chaos seam: per-tenant solve crashes and latency (the
                # injected-clock sleep is how deadline-overrun plans fire
                # deterministically)
                faults.hit(faults.TENANT_SOLVE, tenant=tenant_id)
                with obs.span(
                    "tenant.solve", tenant=tenant_id, tier=tenant.qos.tier
                ):
                    results, fallbacks = self._solve_admitted(tenant, snap)
            elapsed = self.registry.clock.now() - t0
            if elapsed > tenant.qos.solve_deadline:
                tenant.note_deadline_overrun()
                raise DeadlineOverrunError(
                    tenant_id, elapsed, tenant.qos.solve_deadline
                )
            tenant.note_solve(fallbacks)
            return results
        finally:
            lease.release()

    def solve_encoded(self, tenant_id: str, snap: dict) -> bytes:
        results = self.solve_for(tenant_id, snap)
        return wire.encode_solve_response(
            results, state_nodes_packed=len(snap["state_nodes"])
        )

    def _solve_admitted(self, tenant: TenantState, snap: dict):
        key = None
        if self.batcher.window > 0 and tenant.health.level() == 0:
            # a degraded tenant drops out of the shared batch lane: its
            # rung rides its own ladder, not the batch's
            key = _batch_key(snap)
        if key is None:
            return self._solve_solo(tenant, snap)
        return self.batcher.solve(
            key,
            (tenant, snap),
            solo=lambda: self._solve_solo(tenant, snap),
            grouped=self._solve_union,
        )

    def _solve_solo(self, tenant: TenantState, snap: dict):
        cfg = (
            self._base_config
            if self._base_config is not None
            else SolverConfig()
        )
        cfg = dataclasses.replace(
            cfg, health=tenant.health, tenant=tenant.tenant_id
        )
        results, solver = _solve_objects(snap, cfg, tenant.encode_cache)
        return results, solver.fallback_solves

    def _solve_union(self, requests):
        """One scenario-batched dispatch over every participant's solve:
        union workload + union node set, one ``Scenario`` per tenant
        activating its pods and masking the other tenants' nodes. Returns
        per-request ``(results, fallbacks)`` aligned with ``requests``,
        or None to decline (participants solo-solve). The ``__batch__``
        ambient scope keeps tenant-pinned fault plans out of the shared
        lane — isolation is a property of the per-tenant lanes, and a
        faulted batch lane declines to them."""
        union_pods: List[Pod] = []
        seen_uids = set()
        union_sns: list = []
        seen_nodes = set()
        pids_by_req: List[set] = []
        for _tenant, snap in requests:
            for p in snap["pods"]:
                if p.uid in seen_uids:
                    return None
                seen_uids.add(p.uid)
                union_pods.append(p)
            pids = set()
            for sn in snap["state_nodes"]:
                pid = getattr(sn, "provider_id", "") or ""
                name = sn.node.name if sn.node is not None else pid
                if not pid or pid in seen_nodes or name in seen_nodes:
                    return None
                seen_nodes.add(pid)
                seen_nodes.add(name)
                pids.add(pid)
                union_sns.append(sn)
            pids_by_req.append(pids)
        all_pids: set = set()
        for pids in pids_by_req:
            all_pids |= pids
        fault_mark = TorchSolver._fault_log_mark()
        first = requests[0][1]
        cfg = (
            self._base_config
            if self._base_config is not None
            else SolverConfig()
        )
        cfg = dataclasses.replace(cfg, health=None, tenant="__batch__")
        solver = build_solver(
            union_pods,
            first["node_pools"],
            first["instance_types"],
            first["daemonset_pods"],
            union_sns,
            first["volume_objects"],  # keyed: all-None or all-empty
            bool(
                first["solver_options"].get(
                    "reserved_capacity_enabled", False
                )
            ),
            config=cfg,
            encode_cache=self._batch_cache,
        )
        scenarios = [
            Scenario(
                pods=list(snap["pods"]),
                excluded_provider_ids=frozenset(all_pids - pids_by_req[i]),
            )
            for i, (_tenant, snap) in enumerate(requests)
        ]
        with faults.ambient(tenant="__batch__"):
            try:
                outs = solver.solve_scenarios(scenarios)
            except Exception as exc:
                # a fault of the card itself (no injected fault fired since
                # the batch began) reaches every participant
                # (tenancy.is_card_fault), never their solo solves
                exc.card_fault = solver._card_fault(exc, fault_mark)
                raise
        if outs is None:
            return None
        per_request = []
        for (_tenant, snap), res in zip(requests, outs):
            own = {
                sn.node.name
                for sn in snap["state_nodes"]
                if sn.node is not None
            }
            existing = [en for en in res.existing_nodes if en.name in own]
            per_request.append(
                (
                    Results(
                        new_node_claims=res.new_node_claims,
                        existing_nodes=existing,
                        pod_errors=res.pod_errors,
                    ),
                    0,
                )
            )
        return per_request


class SolverService(grpc.GenericRpcHandler):
    """Generic unary handler for the Solve method.

    Exceptions map to proper gRPC status codes instead of crashing the
    stream through the generic handler: a request the codec cannot decode
    is the CLIENT's bug (INVALID_ARGUMENT — retrying it can never help);
    admission rejection is RESOURCE_EXHAUSTED (back off); a per-tenant
    deadline overrun is DEADLINE_EXCEEDED (client falls back in-process);
    a solve that raises is the sidecar's bug (INTERNAL, retriable by
    policy). RemoteSolver keys its retry/fallback ladder off these."""

    def __init__(
        self,
        config: Optional[SolverConfig] = None,
        tenants: Optional[TenantService] = None,
    ):
        self.config = config
        self.tenants = (
            tenants if tenants is not None else TenantService(config=config)
        )

    def _handle(self, request, context):
        # trace context rides the gRPC metadata (obs/trace.py): when the
        # caller sent one, the sidecar's spans adopt the caller's trace id
        # and parent on the caller's span — so the stitched trace shows
        # the RemoteSolver hop as one tree across both processes
        md = {k: v for k, v in (context.invocation_metadata() or ())}
        tenant_id = md.get(TENANT_ID_METADATA_KEY) or DEFAULT_TENANT
        with obs.span(
            "sidecar.solve",
            trace_id=md.get(obs.TRACE_ID_METADATA_KEY),
            parent_id=md.get(obs.PARENT_ID_METADATA_KEY),
            tenant=tenant_id,
        ):
            try:
                snap = wire.decode_solve_request(request)
            except Exception as exc:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"malformed solve request: {type(exc).__name__}: {exc}",
                )
            try:
                return self.tenants.solve_encoded(tenant_id, snap)
            except AdmissionError as exc:
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"tenant {tenant_id!r} admission rejected "
                    f"({exc.reason}): back off and retry",
                )
            except DeadlineOverrunError as exc:
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(exc))
            except Exception as exc:
                _LOG.exception("solve failed")
                context.abort(
                    grpc.StatusCode.INTERNAL,
                    f"solve failed: {type(exc).__name__}: {exc}",
                )

    def service(self, handler_call_details):
        if handler_call_details.method != SOLVE_METHOD:
            return None
        return grpc.unary_unary_rpc_method_handler(
            self._handle,
            request_deserializer=None,  # raw bytes
            response_serializer=None,
        )


def serve(
    address: str = "127.0.0.1:0",
    config: Optional[SolverConfig] = None,
    max_workers: int = 4,
    registry: Optional[TenantRegistry] = None,
    batch_window: float = 0.0,
) -> "grpc.Server":
    """Start a solver sidecar; returns the started server. The bound port is
    available via server._bound_port (set here) when address ends in :0.
    ``registry`` carries the tenant/QoS configuration (default: a fresh
    registry with standard-tier defaults — unidentified traffic lands on
    the "default" tenant); ``batch_window`` > 0 opts into cross-tenant
    microbatching with that many seconds of batch formation delay."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    tenants = TenantService(
        registry=registry, config=config, batch_window=batch_window
    )
    server.add_generic_rpc_handlers((SolverService(config, tenants=tenants),))
    server._tenant_service = tenants
    port = server.add_insecure_port(address)
    server._bound_port = port
    server.start()
    return server


@dataclass
class RemoteExistingNode:
    """Existing-node placement reassembled from the sidecar's response.
    Duck-types the surface Results consumers read (provisioning.py:262:
    .name for nomination, .pods for events)."""

    name: str
    pods: List[Pod]


class RemoteSolver:
    """Client-side seam: same solve(pods) contract as TorchSolver, but the
    packing runs in the sidecar. Claims come back as instance-type names and
    pod uids and are reassembled against the local objects. Pass the
    cluster's StateNodes (``state_nodes``) so the sidecar packs existing
    capacity first exactly like the in-process solve — without them a
    non-empty cluster over-provisions every batch. Pass the PVC/PV/
    StorageClass objects pending pods reference (``volume_objects``) so
    CSI attach-limit checks match too.

    Every dispatch carries a deadline (``SolverConfig.solve_deadline``
    when a config is given, else ``timeout``). UNAVAILABLE and
    DEADLINE_EXCEEDED get exactly one retry; if the sidecar still doesn't
    answer, the solve degrades to an IN-PROCESS run over the same shipped
    cluster view (``build_solver`` — the sidecar's own recipe), so a gRPC
    outage slows a reconcile instead of failing it. RESOURCE_EXHAUSTED is
    the one status that gets a retry but NEVER the in-process fallback:
    it means the sidecar's admission control rejected this tenant, and
    solving locally would turn the backpressure signal into exactly the
    overload it exists to prevent — ``SolverBackpressure`` propagates so
    the caller re-queues the reconcile instead. Any other status (catalog
    skew, malformed request) propagates: retrying those lies."""

    def __init__(
        self,
        target: str,
        node_pools: Sequence[NodePool],
        instance_types: Dict[str, List[cp.InstanceType]],
        daemonset_pods: Sequence[Pod] = (),
        channel: Optional["grpc.Channel"] = None,
        timeout: float = 30.0,
        reserved_capacity_enabled: bool = False,
        state_nodes: Sequence = (),
        volume_objects: Sequence = (),
        config: Optional[SolverConfig] = None,
        encode_cache: Optional[EncodeCache] = None,
        tenant: str = "",
    ):
        self._channel = channel or grpc.insecure_channel(target)
        self._solve = self._channel.unary_unary(SOLVE_METHOD)
        self.config = config
        # identifies this control plane to the sidecar's TenantRegistry;
        # "" sends no metadata and lands on the "default" tenant
        self.tenant = tenant
        self.timeout = (
            config.solve_deadline if config is not None else timeout
        )
        self.reserved_capacity_enabled = reserved_capacity_enabled
        self.node_pools = list(node_pools)
        self.instance_types = instance_types
        self.daemonset_pods = list(daemonset_pods)
        self.state_nodes = list(state_nodes)
        self.volume_objects = list(volume_objects)
        self.fallback_solves = 0  # telemetry: in-process degradations
        # a sidecar outage makes EVERY reconcile fall back — amortize the
        # host-side catalog encode across those solves. Callers that build
        # a RemoteSolver per cycle (the Provisioner does) must pass their
        # long-lived cache; the per-instance default still de-dups repeat
        # solves on one instance
        self._fallback_cache = encode_cache or EncodeCache()
        self._pools_by_name = {np_.name: np_ for np_ in self.node_pools}
        self._types_by_pool = {
            pool: {it.name: it for it in its}
            for pool, its in instance_types.items()
        }

    def _dispatch(self, request: bytes) -> Optional[bytes]:
        """The raw RPC with one bounded retry on retriable status codes;
        None when the sidecar is out (callers degrade in-process)."""
        # propagate trace context so the sidecar's spans stitch into the
        # caller's trace (obs/trace.py; SolverService._handle reads these),
        # and the tenant id so the sidecar routes to the right control plane
        pairs = []
        cur = obs.current_span()
        if cur is not None:
            pairs.append((obs.TRACE_ID_METADATA_KEY, cur.trace_id))
            pairs.append((obs.PARENT_ID_METADATA_KEY, cur.span_id))
        if self.tenant:
            pairs.append((TENANT_ID_METADATA_KEY, self.tenant))
        metadata = tuple(pairs) or None
        last_backpressure: Optional[grpc.RpcError] = None
        for attempt in range(2):
            try:
                # chaos seam: plans raise InjectedRpcError here to model
                # channel outages, deadline blowouts, and admission rejects
                faults.hit(faults.REMOTE_SOLVE, attempt=attempt)
                with obs.span("remote.dispatch", attempt=attempt):
                    return self._solve(
                        request, timeout=self.timeout, metadata=metadata
                    )
            except grpc.RpcError as exc:
                code = _status_name(exc)
                if code in BACKPRESSURE_CODES:
                    # admission rejection: retriable once (the bucket
                    # refills), but NEVER the in-process fallback
                    last_backpressure = exc
                    _LOG.warning(
                        "solver sidecar rejected tenant %r (attempt %d)",
                        self.tenant or DEFAULT_TENANT, attempt + 1,
                    )
                    continue
                last_backpressure = None
                if code not in RETRIABLE_CODES:
                    raise
                _LOG.warning(
                    "solver sidecar dispatch failed with %s (attempt %d)",
                    code, attempt + 1,
                )
        if last_backpressure is not None:
            raise SolverBackpressure(
                self.tenant or DEFAULT_TENANT, str(last_backpressure)
            ) from last_backpressure
        return None

    def _solve_in_process(self, pods: Sequence[Pod]) -> Results:
        """Degraded rung: the sidecar is unreachable, so run the identical
        solve locally from the parts the request was built from."""
        self.fallback_solves += 1
        with obs.span("remote.fallback", pods=len(pods)):
            return self._build_and_solve(pods)

    def _build_and_solve(self, pods: Sequence[Pod]) -> Results:
        solver = build_solver(
            pods,
            self.node_pools,
            self.instance_types,
            self.daemonset_pods,
            self.state_nodes,
            self.volume_objects,
            self.reserved_capacity_enabled,
            config=self.config,
            encode_cache=self._fallback_cache,
            # live controller objects: never bump their resource versions
            copy_objects=True,
        )
        return solver.solve(pods)

    def solve(self, pods: Sequence[Pod]) -> Results:
        with obs.span("remote.solve", pods=len(pods)):
            return self._solve_remote(pods)

    def _solve_remote(self, pods: Sequence[Pod]) -> Results:
        from ..scheduling.template import NodeClaimTemplate

        request = wire.encode_solve_request(
            pods,
            self.node_pools,
            self.instance_types,
            self.daemonset_pods,
            solver_options={
                "reserved_capacity_enabled": self.reserved_capacity_enabled
            },
            state_nodes=self.state_nodes,
            volume_objects=self.volume_objects,
        )
        raw = self._dispatch(request)
        if raw is None:
            return self._solve_in_process(pods)
        response = wire.decode_solve_response(raw)
        if self.state_nodes and response.get("state_nodes_packed") != len(
            self.state_nodes
        ):
            # a sidecar speaking an older protocol drops unknown request
            # keys: solving against an empty cluster view would silently
            # over-provision — fail as loudly as catalog skew does below
            raise RuntimeError(
                f"sent {len(self.state_nodes)} state nodes but the solver "
                f"acknowledged {response.get('state_nodes_packed', 0)} — "
                "controller/sidecar wire protocol versions are out of sync"
            )
        pods_by_uid = {p.uid: p for p in pods}
        claims: List[DecodedClaim] = []
        for c in response["claims"]:
            pool = self._pools_by_name.get(c["pool"])
            if pool is None:
                raise RuntimeError(
                    f"solver returned a claim for unknown nodepool "
                    f"{c['pool']!r} — controller/sidecar nodepool catalogs "
                    "are out of sync"
                )
            by_name = self._types_by_pool.get(c["pool"], {})
            missing = [n for n in c["instance_types"] if n not in by_name]
            if missing:
                # catalog skew between controller and sidecar must be loud:
                # a claim without options would persist unlaunchable
                raise RuntimeError(
                    f"solver returned unknown instance types for pool "
                    f"{c['pool']!r}: {missing[:5]} — controller/sidecar "
                    "instance-type catalogs are out of sync"
                )
            claims.append(
                DecodedClaim(
                    template=NodeClaimTemplate(pool),
                    pods=[pods_by_uid[uid] for uid in c["pod_uids"]],
                    instance_type_options=[by_name[n] for n in c["instance_types"]],
                    requirements=c["requirements"],
                )
            )
        existing = [
            RemoteExistingNode(
                name=e["name"],
                pods=[pods_by_uid[u] for u in e["pod_uids"]],
            )
            for e in response.get("existing", [])
        ]
        return Results(
            new_node_claims=claims,
            existing_nodes=existing,
            pod_errors=dict(response["pod_errors"]),
        )

    def close(self) -> None:
        self._channel.close()


__all__ = [
    "SOLVE_METHOD", "SolverService", "TenantService", "serve",
    "RemoteSolver", "RemoteExistingNode", "InjectedRpcError",
    "SolverBackpressure", "build_solver",
    "RETRIABLE_CODES", "BACKPRESSURE_CODES", "TENANT_ID_METADATA_KEY",
]


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Standalone sidecar binary: `python -m
    karpenter_tpu_torch.solver.service` — the deployable form of the
    controller/solver process split. It solves on the card: like
    ``SolverConfig()`` it raises where CUDA is not available."""
    import argparse
    import signal
    import threading

    parser = argparse.ArgumentParser(prog="karpenter-tpu-torch-solver")
    parser.add_argument(
        "--listen", default="0.0.0.0:50099",
        help="host:port for the gRPC solve endpoint",
    )
    parser.add_argument("--max-workers", type=int, default=4)
    parser.add_argument(
        "--max-tenants", type=int, default=16,
        help="admission-control bound on distinct tenant ids",
    )
    parser.add_argument(
        "--batch-window", type=float, default=0.0,
        help="cross-tenant microbatch formation window in seconds "
        "(0 disables batching)",
    )
    args = parser.parse_args(argv)
    server = serve(
        address=args.listen,
        config=SolverConfig(),
        max_workers=args.max_workers,
        registry=TenantRegistry(max_tenants=args.max_tenants),
        batch_window=args.batch_window,
    )
    print(f"solver sidecar listening on {args.listen}", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.stop(grace=5).wait()


if __name__ == "__main__":
    main()
