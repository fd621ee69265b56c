# Copied from karpenter_tpu/solver/tenancy.py, a card fault of the union solve passes the batch lane to every participant (is_card_fault, _BatchSlot.fault, CrossTenantBatcher._lead and _follow); 1 comment line reworded for the port.
"""Multi-tenant control planes over one resident solver kernel.

The north star serves many clusters from one accelerator: each control
plane (tenant) ships snapshots to the same sidecar, but NONE of the
warm state that makes solving fast — the catalog-fingerprinted
``EncodeCache``, its ``ClusterEncoding`` row banks, the device-resident
argument buffers — may be shared between tenants. Sharing it would make
one tenant's corrupt delta another tenant's full re-encode, and one
tenant's quarantine everyone's oracle fallback. This module holds the
isolation machinery:

- ``TenantState``: one tenant's warm state (its own ``EncodeCache`` →
  ``ClusterEncoding`` + ``DeviceResidentArgs``), its OWN
  ``SolverHealth`` degradation ladder (faults/breaker.py) publishing
  per-tenant-labeled metrics, a token-bucket rate limiter and a bounded
  in-flight queue.
- ``TenantRegistry``: the tenant table plus global admission control —
  token buckets per tenant, a priority-tiered share of the global
  in-flight pool (premium may fill it, standard three quarters, batch
  half — "Priority Matters"-style tiering, lowest tier shed first
  under contention), and a hard ``max_tenants`` bound that is ALSO the
  cardinality bound for every ``tenant``-labeled metric series.
- ``CrossTenantBatcher``: leader/follower microbatching of same-shape
  solves from different tenants onto the existing scenario axis (one
  vmapped dispatch behind the one blessed drain); a declined batch
  falls back to per-tenant solo solves, never to a wrong answer. A
  fault of the card itself in the union solve (``is_card_fault``) is
  not a decline: it reaches every participant, as a card fault passes
  the solver's own ladder (``TorchSolver._card_fault``).

Typed errors map to the sidecar's gRPC contract: ``AdmissionError`` →
RESOURCE_EXHAUSTED ("back off and retry"), ``DeadlineOverrunError`` →
DEADLINE_EXCEEDED ("fall back in-process") — solver/service.py wires
both, and RemoteSolver distinguishes them on the client side.

Lock discipline (PARITY.md "Tenant isolation contract"): ``TenantState``
and ``TenantRegistry`` each own one ``threading.Lock`` guarding all of
their mutable attributes; the two are never held at once (registry
methods complete their critical section before calling into a tenant),
so no new cross-module lock order is introduced and the GRD13xx/ATM14xx
sanctioned-site inventory is unchanged. ``CrossTenantBatcher``
serializes on a single ``threading.Condition``. Clock reads ride
injected clocks only (``obs.PerfClock`` by default) — never raw
``time.*`` (CLK10xx).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from .. import faults, obs
from .._build import KernelBuildError, KernelLaunchError
from ..faults.breaker import SolverHealth
from ..metrics import Counter, Gauge

DEFAULT_TENANT = "default"

# -- QoS tiers ---------------------------------------------------------------

TIER_PREMIUM = "premium"
TIER_STANDARD = "standard"
TIER_BATCH = "batch"

# fraction of the global in-flight pool a tier may fill: under
# contention the batch tier is shed first, then standard — premium is
# rejected only when the pool itself is full
_TIER_HEADROOM = {
    TIER_PREMIUM: 1.0,
    TIER_STANDARD: 0.75,
    TIER_BATCH: 0.5,
}


@dataclass(frozen=True)
class TenantQoS:
    """Per-tenant admission and latency budget.

    ``rate``/``burst`` parameterize the token bucket (solves per second,
    bucket depth); ``max_queue`` bounds the tenant's in-flight solves
    (the "bounded per-tenant queue" — anything beyond it is rejected,
    not queued, so one tenant's backlog cannot occupy the gRPC thread
    pool); ``solve_deadline`` is the per-tenant latency budget measured
    on the registry clock — an overrun maps to DEADLINE_EXCEEDED so the
    client falls back in-process instead of backing off."""

    tier: str = TIER_STANDARD
    rate: float = 100.0
    burst: float = 128.0
    max_queue: int = 32
    solve_deadline: float = 600.0


TIER_DEFAULTS: Dict[str, TenantQoS] = {
    TIER_PREMIUM: TenantQoS(
        tier=TIER_PREMIUM, rate=200.0, burst=256.0, max_queue=64
    ),
    TIER_STANDARD: TenantQoS(tier=TIER_STANDARD),
    TIER_BATCH: TenantQoS(
        tier=TIER_BATCH, rate=20.0, burst=32.0, max_queue=8
    ),
}


# -- typed error contract ----------------------------------------------------


class AdmissionError(RuntimeError):
    """Admission control rejected the solve BEFORE any work ran — the
    caller should back off and retry (gRPC RESOURCE_EXHAUSTED; the
    client must NOT fall back in-process, the cluster view it would
    solve is the same one the service just refused to spend quota on).
    ``reason`` is one of "rate-limited" | "queue-full" | "tier-shed" |
    "tenant-capacity"."""

    def __init__(self, reason: str, tenant: str):
        super().__init__(f"tenant {tenant!r} admission rejected: {reason}")
        self.reason = reason
        self.tenant = tenant


class DeadlineOverrunError(RuntimeError):
    """The solve ran but blew the tenant's latency budget — the answer
    is stale by contract (gRPC DEADLINE_EXCEEDED; the client's retry/
    fallback ladder treats it like a slow sidecar and solves
    in-process)."""

    def __init__(self, tenant: str, elapsed: float, deadline: float):
        super().__init__(
            f"tenant {tenant!r} solve took {elapsed:.3f}s "
            f"(deadline {deadline:.3f}s)"
        )
        self.tenant = tenant
        self.elapsed = elapsed
        self.deadline = deadline


# -- per-tenant metrics ------------------------------------------------------
# Cardinality contract: every ``tenant`` label below is bounded by
# TenantRegistry.max_tenants (default 16) — the registry refuses to mint
# an N+1st tenant, so the label can never carry unbounded identity.
# Capacity rejections happen BEFORE a tenant exists and use the fixed
# label "(capacity)" so a rogue client spraying fresh tenant ids cannot
# blow up the series map. Pinned by tests/test_tenants.py.

TENANT_SOLVES = Counter(
    "solver_tenant_solves_total",
    "Committed solves per tenant through the multi-tenant service",
)
TENANT_REJECTIONS = Counter(
    "solver_tenant_rejections_total",
    "Admission rejections per tenant and reason "
    "(rate-limited | queue-full | tier-shed; tenant-capacity rejections "
    "carry the fixed tenant label '(capacity)')",
)
TENANT_DEADLINE_OVERRUNS = Counter(
    "solver_tenant_deadline_overruns_total",
    "Solves that ran but blew the tenant's latency budget",
)
TENANT_INFLIGHT = Gauge(
    "solver_tenant_inflight",
    "In-flight solves per tenant (bounded by its QoS max_queue)",
)
TENANT_BATCHES = Counter(
    "solver_tenant_batches_total",
    "Cross-tenant microbatch outcomes (outcome=batched|declined)",
)


class TenantState:
    """One tenant's isolation domain: warm state, ladder, quota.

    The ``EncodeCache`` (and through it the ``ClusterEncoding`` row
    banks and ``DeviceResidentArgs`` buffers) is constructed here, owned
    here, and never handed to another tenant — a corrupt-delta shed or a
    catalog reset stays inside this object. The ``SolverHealth`` ladder
    is equally private: this tenant quarantining its kernel rung cannot
    gate anyone else's batched path.

    All mutable admission state (``_tokens``, ``_inflight``, the stat
    counters) is guarded by ``self._lock``; the metric emissions happen
    after release so the per-metric locks never nest inside it."""

    def __init__(
        self,
        tenant_id: str,
        qos: TenantQoS,
        clock,
        recorder=None,
    ):
        from .driver import EncodeCache

        self.tenant_id = tenant_id
        self.qos = qos
        self.clock = clock
        # per-tenant warm state: the whole warm-encode object graph, one copy
        self.encode_cache = EncodeCache(owner=tenant_id)
        # per-tenant degradation ladder with per-tenant metric series
        self.health = SolverHealth(
            clock,
            recorder=recorder,
            metric_labels={"tenant": tenant_id},
        )
        self._lock = threading.Lock()
        self._tokens = float(qos.burst)
        self._last_refill = clock.now()
        self._inflight = 0
        self._admitted = 0
        self._rejected = 0
        self._solves = 0
        self._fallback_solves = 0
        self._deadline_overruns = 0

    def try_admit(self) -> Optional[str]:
        """Refill the bucket on the injected clock and take one token +
        one queue slot atomically; the rejection reason when either is
        exhausted (None = admitted)."""
        with self._lock:
            now = self.clock.now()
            self._tokens = min(
                float(self.qos.burst),
                self._tokens + (now - self._last_refill) * self.qos.rate,
            )
            self._last_refill = now
            if self._tokens < 1.0:
                self._rejected += 1
                return "rate-limited"
            if self._inflight >= self.qos.max_queue:
                self._rejected += 1
                return "queue-full"
            self._tokens -= 1.0
            self._inflight += 1
            self._admitted += 1
            inflight = self._inflight
        TENANT_INFLIGHT.set(
            float(inflight), labels={"tenant": self.tenant_id}
        )
        return None

    def release(self) -> None:
        with self._lock:
            self._inflight -= 1
            inflight = self._inflight
        TENANT_INFLIGHT.set(
            float(inflight), labels={"tenant": self.tenant_id}
        )

    def note_solve(self, fallback_delta: int = 0) -> None:
        with self._lock:
            self._solves += 1
            self._fallback_solves += fallback_delta
        TENANT_SOLVES.inc(labels={"tenant": self.tenant_id})

    def note_deadline_overrun(self) -> None:
        with self._lock:
            self._deadline_overruns += 1
        TENANT_DEADLINE_OVERRUNS.inc(labels={"tenant": self.tenant_id})

    @property
    def fallback_solves(self) -> int:
        with self._lock:
            return self._fallback_solves

    def stats(self) -> Dict[str, object]:
        """A copied snapshot (never the guarded dicts themselves)."""
        with self._lock:
            return {
                "tenant": self.tenant_id,
                "tier": self.qos.tier,
                "admitted": self._admitted,
                "rejected": self._rejected,
                "solves": self._solves,
                "fallback_solves": self._fallback_solves,
                "deadline_overruns": self._deadline_overruns,
                "inflight": self._inflight,
                "tokens": self._tokens,
            }


class TenantRegistry:
    """The tenant table + global admission control.

    ``max_tenants`` is a hard bound (an N+1st tenant is rejected with
    reason "tenant-capacity") and doubles as the metric-cardinality
    bound for every ``tenant`` label. ``max_inflight`` is the global
    solve pool the tiers share fractionally (see ``_TIER_HEADROOM``).
    ``tiers`` maps tenant id → tier name — tier assignment is SERVICE
    configuration, never client metadata, so a tenant cannot promote
    itself across the trust boundary."""

    def __init__(
        self,
        clock=None,
        max_tenants: int = 16,
        max_inflight: int = 32,
        tiers: Optional[Dict[str, str]] = None,
        default_tier: str = TIER_STANDARD,
        qos: Optional[Dict[str, TenantQoS]] = None,
        recorder=None,
    ):
        self.clock = clock if clock is not None else obs.PerfClock()
        self.max_tenants = max_tenants
        self.max_inflight = max_inflight
        self.default_tier = default_tier
        self.recorder = recorder
        self._tier_of = dict(tiers or {})
        self._qos = dict(TIER_DEFAULTS)
        self._qos.update(qos or {})
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantState] = {}
        self._inflight_total = 0

    def qos_for(self, tenant_id: str) -> TenantQoS:
        tier = self._tier_of.get(tenant_id, self.default_tier)
        return self._qos[tier]

    def get_or_create(self, tenant_id: str) -> TenantState:
        """The tenant's state object, minted on first sight — or
        ``AdmissionError("tenant-capacity")`` at the ``max_tenants``
        bound (which is what keeps every tenant-labeled metric series
        bounded)."""
        with self._lock:
            tenant = self._tenants.get(tenant_id)
            if tenant is None:
                if len(self._tenants) >= self.max_tenants:
                    raise AdmissionError("tenant-capacity", tenant_id)
                tenant = TenantState(
                    tenant_id,
                    self.qos_for(tenant_id),
                    self.clock,
                    recorder=self.recorder,
                )
                self._tenants[tenant_id] = tenant
            return tenant

    def get(self, tenant_id: str) -> Optional[TenantState]:
        with self._lock:
            return self._tenants.get(tenant_id)

    def tenant_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def _admit_global(self, tier: str) -> Optional[str]:
        """Take one global in-flight slot within the tier's headroom
        fraction; the rejection reason when the tier's share is full."""
        headroom = _TIER_HEADROOM.get(tier, _TIER_HEADROOM[TIER_STANDARD])
        with self._lock:
            limit = max(1, int(self.max_inflight * headroom))
            if self._inflight_total >= limit:
                return "tier-shed"
            self._inflight_total += 1
            return None

    def _release_global(self) -> None:
        with self._lock:
            self._inflight_total -= 1

    def admit(self, tenant_id: str) -> "AdmissionLease":
        """Full admission: tenant-capacity → tier headroom → token
        bucket + queue bound, each atomic under its own lock, with the
        global slot compensated when the per-tenant step rejects.
        Raises ``AdmissionError``; on success returns a lease the caller
        MUST release (try/finally) when the solve completes."""
        faults.hit(faults.TENANT_ADMIT, tenant=tenant_id)
        try:
            tenant = self.get_or_create(tenant_id)
        except AdmissionError:
            # fixed label: capacity rejections precede tenant existence,
            # so the tenant id here is unbounded attacker-controlled input
            TENANT_REJECTIONS.inc(
                labels={"tenant": "(capacity)", "reason": "tenant-capacity"}
            )
            raise
        reason = self._admit_global(tenant.qos.tier)
        if reason is not None:
            TENANT_REJECTIONS.inc(
                labels={"tenant": tenant_id, "reason": reason}
            )
            raise AdmissionError(reason, tenant_id)
        reason = tenant.try_admit()
        if reason is not None:
            self._release_global()
            TENANT_REJECTIONS.inc(
                labels={"tenant": tenant_id, "reason": reason}
            )
            raise AdmissionError(reason, tenant_id)
        return AdmissionLease(self, tenant)

    def stats(self) -> List[Dict[str, object]]:
        with self._lock:
            tenants = sorted(self._tenants.values(), key=lambda t: t.tenant_id)
        return [t.stats() for t in tenants]


class AdmissionLease:
    """One admitted solve's slot pair (global + tenant), released once.
    Single-owner by contract (the admitting thread), so the released
    flag needs no lock."""

    def __init__(self, registry: TenantRegistry, tenant: TenantState):
        self.registry = registry
        self.tenant = tenant
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self.tenant.release()
        self.registry._release_global()


# -- cross-tenant microbatching ---------------------------------------------


def is_card_fault(exc: BaseException) -> bool:
    """Whether a union solve's failure is a fault of the card itself: a
    kernel that did not build or launch, or a failure the union solver
    marked ``card_fault`` (solver/service.py:TenantService._solve_union,
    by ``TorchSolver._card_fault``: on CUDA, a failure with no injected
    fault fired since the batch began)."""
    return isinstance(exc, (KernelBuildError, KernelLaunchError)) or bool(
        getattr(exc, "card_fault", False)
    )


class _BatchSlot:
    """One tenant's seat in a forming batch (leader-owned after close)."""

    def __init__(self, item):
        self.item = item
        self.result = None
        self.declined = False
        self.fault: Optional[BaseException] = None


class _Batch:
    def __init__(self, key):
        self.key = key
        self.slots: List[_BatchSlot] = []
        self.done = False


class CrossTenantBatcher:
    """Leader/follower microbatching of same-shape solves.

    The first arrival under a batch key becomes the leader: it waits up
    to ``window`` seconds (on the injected duration clock) for followers
    with the same key, then runs ``grouped(items)`` ONCE — one scenario-
    batched kernel dispatch for every participant. ``grouped`` returns
    per-item results aligned with its input, or None to decline, in
    which case every participant falls back to its own ``solo()`` (the
    correct answer, just without the shared dispatch). A failure of
    ``grouped`` declines the same way, unless it is a fault of the card
    (``is_card_fault``): then every participant raises it. ``window <= 0``
    disables batching entirely (the default — batching is opt-in).

    All shared state is serialized on one ``threading.Condition``; the
    leader closes its batch (removes it from ``_pending``) before
    releasing the lock to solve, so late arrivals start a fresh batch
    rather than racing a solve in progress."""

    def __init__(self, window: float = 0.0, max_batch: int = 8):
        self.window = window
        self.max_batch = max_batch
        self._cond = threading.Condition()
        self._pending: Dict[object, _Batch] = {}
        self._batched = 0
        self._declined = 0

    def counts(self) -> Dict[str, int]:
        with self._cond:
            return {"batched": self._batched, "declined": self._declined}

    def solve(
        self,
        key,
        item,
        solo: Callable[[], object],
        grouped: Callable[[Sequence[object]], Optional[List[object]]],
    ):
        if self.window <= 0 or key is None:
            return solo()
        with self._cond:
            batch = self._pending.get(key)
            if batch is None:
                batch = _Batch(key)
                self._pending[key] = batch
                slot = _BatchSlot(item)
                batch.slots.append(slot)
                leader = True
            else:
                slot = _BatchSlot(item)
                batch.slots.append(slot)
                leader = False
                if len(batch.slots) >= self.max_batch:
                    self._cond.notify_all()  # wake the leader early
        if leader:
            return self._lead(batch, slot, grouped, solo)
        return self._follow(batch, slot, solo)

    def _lead(self, batch, slot, grouped, solo):
        dclk = obs.duration_clock()
        deadline = dclk.now() + self.window
        with self._cond:
            while (
                len(batch.slots) < self.max_batch
                and dclk.now() < deadline
            ):
                self._cond.wait(max(0.001, deadline - dclk.now()))
            # close the batch: late same-key arrivals form a new one
            self._pending.pop(batch.key, None)
            slots = list(batch.slots)
        results = None
        fault = None
        try:
            results = grouped([s.item for s in slots])
        except Exception as exc:
            # a failed union solve must never take the participants down
            # with it — everyone gets the solo answer instead — unless the
            # card itself failed: a solo solve would hide the fault behind
            # other kernels, so every participant raises it
            if is_card_fault(exc):
                fault = exc
            results = None
        with self._cond:
            if fault is not None:
                for s in slots:
                    s.fault = fault
            elif results is None:
                self._declined += 1
                for s in slots:
                    s.declined = True
            else:
                self._batched += 1
                for s, r in zip(slots, results):
                    s.result = r
            batch.done = True
            self._cond.notify_all()
        if fault is not None:
            raise fault
        TENANT_BATCHES.inc(
            labels={
                "outcome": "declined" if results is None else "batched"
            }
        )
        if slot.declined:
            return solo()
        return slot.result

    def _follow(self, batch, slot, solo):
        # the leader always completes (grouped() exceptions are caught, a
        # card fault handed to every slot before the leader raises it),
        # but the wait is still bounded so a killed leader thread cannot
        # park followers forever
        with self._cond:
            for _ in range(2400):
                if batch.done:
                    break
                self._cond.wait(0.25)
            done = batch.done
        if not done:
            raise RuntimeError(
                "cross-tenant batch leader never completed "
                f"(key={batch.key!r})"
            )
        if slot.fault is not None:
            raise slot.fault
        if slot.declined:
            return solo()
        return slot.result


__all__ = [
    "DEFAULT_TENANT",
    "TIER_PREMIUM", "TIER_STANDARD", "TIER_BATCH", "TIER_DEFAULTS",
    "TenantQoS", "TenantState", "TenantRegistry", "AdmissionLease",
    "AdmissionError", "DeadlineOverrunError", "CrossTenantBatcher",
    "is_card_fault",
    "TENANT_SOLVES", "TENANT_REJECTIONS", "TENANT_DEADLINE_OVERRUNS",
    "TENANT_INFLIGHT", "TENANT_BATCHES",
]
