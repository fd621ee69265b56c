# Copied from karpenter_tpu/faults/__init__.py, 1 comment line reworded.
"""Seeded, deterministic fault injection for the control plane's seams.

The north-star deployment puts a gRPC sidecar, an XLA compile cache, an
optional native ``.so``, and a cloud provider on the reconcile hot path —
any of them can fail mid-solve. This package injects those failures on
purpose so the machinery that survives them (faults/backoff.py,
faults/breaker.py, faults/guard.py) is exercised by tests instead of by
outages.

Design constraints:

- **Zero overhead when off.** Every instrumented seam costs one
  module-global ``None`` check (``hit``/``mutate`` below). With no injector
  installed the solver's outputs are byte-identical to an uninstrumented
  build (pinned by tests/test_faults.py).
- **Deterministic.** A ``FaultInjector`` owns a seeded ``random.Random``
  plus per-site call counters, and reads time only from the injected
  clock — the same seed over the same call sequence replays the exact
  same fault schedule (the chaos soak asserts this).
- **Typed.** Rules raise the same exception types the real seam would
  (``ConflictError``, ``InsufficientCapacityError``, gRPC status errors),
  so the handling code under test is the production code.

Sites are plain strings, named here so call sites and fault plans can't
drift apart. Instrumented seams: the object store CRUD
(kube/store.py), cloud provider create/delete/registration
(cloudprovider/kwok.py, fake.py), kernel dispatch + output
(ops/solve.py), the scenario-batched dispatch, the gRPC RemoteSolver
(solver/service.py), and the native ``.so`` load (native/__init__.py).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# -- named sites ------------------------------------------------------------

STORE_CREATE = "store.create"
STORE_UPDATE = "store.update"
STORE_DELETE = "store.delete"
PROVIDER_CREATE = "cloudprovider.create"
PROVIDER_DELETE = "cloudprovider.delete"
PROVIDER_REGISTER = "cloudprovider.register"
SOLVER_DISPATCH = "solver.dispatch"
SOLVER_OUTPUT = "solver.output"
SOLVER_SCENARIOS = "solver.scenarios"
# incremental-encode seams: the delta-encode bookkeeping
# (hit: every ClusterEncoding reuse/finish; mutate: the gathered delta
# rows on their way to the device — a corrupt delta must trip the
# pre-decode invariant guard and fall back to a full re-encode) and the
# two-slot async dispatch queue (hit: submit and drain)
ENCODE_DELTA = "solver.encode_delta"
DISPATCH_QUEUE = "solver.dispatch_queue"
REMOTE_SOLVE = "remote.solve"
NATIVE_LOAD = "native.load"
# relaxation bulk pre-solver (ops/relax.py): mutate corrupts the bulk
# outputs before the merge — the combined solve must trip the invariant
# guard and shed to the full exact kernel, never commit
RELAX_OUTPUT = "solver.relax_output"
# multi-tenant service seams (solver/tenancy.py + service.py): admission
# (hit with tenant= ctx — latency rules model admission stalls, error
# rules model a rejecting policy backend) and the per-tenant solve entry
# (hit with tenant= ctx inside the tenant's ambient scope — latency
# rules on the registry clock model deadline overruns, error rules model
# per-tenant solve crashes)
TENANT_ADMIT = "tenant.admit"
TENANT_SOLVE = "tenant.solve"

ALL_SITES = (
    STORE_CREATE, STORE_UPDATE, STORE_DELETE,
    PROVIDER_CREATE, PROVIDER_DELETE, PROVIDER_REGISTER,
    SOLVER_DISPATCH, SOLVER_OUTPUT, SOLVER_SCENARIOS,
    ENCODE_DELTA, DISPATCH_QUEUE,
    REMOTE_SOLVE, NATIVE_LOAD, RELAX_OUTPUT,
    TENANT_ADMIT, TENANT_SOLVE,
)

# -- ambient context ---------------------------------------------------------
# Deep sites (ENCODE_DELTA, SOLVER_DISPATCH, RELAX_OUTPUT) fire far below
# any code that knows WHICH tenant's solve is running. The ambient scope
# threads that identity down without touching every signature: rules use
# ``match=lambda ctx: ctx.get("tenant") == "a"`` to pin a fault plan to
# one tenant. Per-thread (the sidecar's thread pool runs one solve per
# thread), layered (inner scopes win), and merged into hit/mutate ctx
# only when an injector is installed — the zero-overhead-when-off
# contract still costs exactly one module-global None check.

_AMBIENT = threading.local()


class ambient:
    """Context manager layering ambient fault-site context (e.g.
    ``tenant="a"``) onto every ``hit``/``mutate`` ctx in its dynamic
    extent, for the current thread. Explicit call-site kwargs win over
    ambient keys; inner scopes win over outer ones."""

    __slots__ = ("_ctx",)

    def __init__(self, **ctx):
        self._ctx = ctx

    def __enter__(self) -> "ambient":
        stack = getattr(_AMBIENT, "stack", None)
        if stack is None:
            stack = _AMBIENT.stack = []
        stack.append(self._ctx)
        return self

    def __exit__(self, *exc) -> bool:
        _AMBIENT.stack.pop()
        return False


def ambient_ctx() -> dict:
    """The current thread's merged ambient context (outer → inner)."""
    stack = getattr(_AMBIENT, "stack", None)
    if not stack:
        return {}
    merged: dict = {}
    for frame in stack:
        merged.update(frame)
    return merged


class InjectedFault(Exception):
    """Default exception for rules without an ``error`` factory. Seams that
    absorb a fault in place (e.g. kwok's registration defer) catch exactly
    this type so a typed production error can never be mistaken for an
    injected one."""


@dataclass
class FaultRule:
    """One fault behavior at one site.

    ``error`` is a zero-arg factory returning the exception to raise
    (default: ``InjectedFault``); ``mutate`` instead transforms the value
    passed through ``mutate()`` at output-corruption sites (a rule is one
    or the other). Scheduling knobs: ``probability`` (per matching call,
    drawn from the injector's seeded RNG), ``after`` (skip the first N
    calls at the site), ``times`` (stop after firing N times), ``until``
    (fire only while the injected clock is before this instant — how a
    chaos plan "clears"), ``match`` (predicate over the call-site context
    kwargs), and ``latency`` (seconds slept on the injected clock before
    the error/mutation, or alone for a pure-latency rule)."""

    site: str
    error: Optional[Callable[[], BaseException]] = None
    mutate: Optional[Callable[[object], object]] = None
    probability: float = 1.0
    after: int = 0
    times: Optional[int] = None
    until: Optional[float] = None
    match: Optional[Callable[[dict], bool]] = None
    latency: Optional[float] = None
    fired: int = field(default=0, compare=False)


class FaultInjector:
    """Seeded, clock-injected fault schedule over named sites.

    ``hit(site, **ctx)`` raises when an error rule fires; ``mutate(site,
    value)`` passes ``value`` through any firing mutation rules. ``log``
    records every firing as ``(site, rule_index, site_call_number)`` —
    two runs with the same seed and call sequence produce identical logs.
    ``clear()`` makes the injector inert (the "faults clear" phase of a
    chaos soak) without losing the log."""

    def __init__(
        self,
        rules: List[FaultRule],
        seed: int = 0,
        clock=None,
    ):
        self.rules = list(rules)
        self.seed = seed
        self.rng = random.Random(seed)
        self.clock = clock
        self.enabled = True
        self.calls: Dict[str, int] = {}
        self.log: List[Tuple[str, int, int]] = []

    # -- schedule -----------------------------------------------------------

    def _fires(self, rule: FaultRule, idx: int, n: int, ctx: dict) -> bool:
        if not self.enabled:
            return False
        if n <= rule.after:
            return False
        if rule.times is not None and rule.fired >= rule.times:
            return False
        if (
            rule.until is not None
            and self.clock is not None
            and self.clock.now() >= rule.until
        ):
            return False
        if rule.match is not None and not rule.match(ctx):
            return False
        if rule.probability < 1.0 and self.rng.random() >= rule.probability:
            return False
        rule.fired += 1
        self.log.append((rule.site, idx, n))
        # chaos ↔ trace correlation: a firing leaves an instant event on
        # the open span, so a Perfetto view of a chaos replay shows WHERE
        # in the decision path each fault landed (no-op without a tracer)
        from .. import obs

        obs.event("fault.fired", site=rule.site, rule=idx, call=n)
        return True

    def hit(self, site: str, **ctx) -> None:
        amb = ambient_ctx()
        if amb:
            ctx = {**amb, **ctx}
        n = self.calls[site] = self.calls.get(site, 0) + 1
        for idx, rule in enumerate(self.rules):
            if rule.site != site or rule.mutate is not None:
                continue
            if self._fires(rule, idx, n, ctx):
                if rule.latency is not None and self.clock is not None:
                    self.clock.sleep(rule.latency)
                if rule.error is not None:
                    raise rule.error()
                if rule.latency is None:
                    raise InjectedFault(f"injected fault at {site}")
                # latency-only rule: slept, nothing to raise

    def mutate(self, site: str, value, **ctx):
        amb = ambient_ctx()
        if amb:
            ctx = {**amb, **ctx}
        n = self.calls[site] = self.calls.get(site, 0) + 1
        for idx, rule in enumerate(self.rules):
            if rule.site != site or rule.mutate is None:
                continue
            if self._fires(rule, idx, n, ctx):
                if rule.latency is not None and self.clock is not None:
                    self.clock.sleep(rule.latency)
                value = rule.mutate(value)
        return value

    # -- bookkeeping --------------------------------------------------------

    def fired(self, site: Optional[str] = None) -> int:
        if site is None:
            return len(self.log)
        return sum(1 for s, _, _ in self.log if s == site)

    def clear(self) -> None:
        """Stop all rules from firing (chaos phase over); the log survives
        for replay assertions."""
        self.enabled = False

    # -- checkpoint (sim/twin.py) -------------------------------------------

    def export_state(self) -> dict:
        """RNG state + per-site counters + per-rule fired counts + the
        firing log: a resumed twin replay reconstructs the injector from
        the SAME rule plan and restores this, so the fault schedule
        continues exactly where the interrupted run stopped."""
        return {
            "rng": self.rng.getstate(),
            "enabled": self.enabled,
            "calls": dict(self.calls),
            "fired": [rule.fired for rule in self.rules],
            "log": list(self.log),
        }

    def restore_state(self, state: dict) -> None:
        self.rng.setstate(state["rng"])
        self.enabled = bool(state["enabled"])
        self.calls = dict(state["calls"])
        for rule, fired in zip(self.rules, state["fired"]):
            rule.fired = fired
        self.log = [tuple(entry) for entry in state["log"]]


# -- process-global installation seam ---------------------------------------

_INJECTOR: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    global _INJECTOR
    _INJECTOR = injector
    return injector


def uninstall() -> None:
    global _INJECTOR
    _INJECTOR = None


def active() -> Optional[FaultInjector]:
    return _INJECTOR


def hit(site: str, **ctx) -> None:
    """Consult the installed injector at a named site; no-op (one global
    read) when none is installed."""
    if _INJECTOR is not None:
        _INJECTOR.hit(site, **ctx)


def mutate(site: str, value, **ctx):
    """Pass an output value through the installed injector's mutation
    rules; identity (one global read) when none is installed."""
    if _INJECTOR is None:
        return value
    return _INJECTOR.mutate(site, value, **ctx)


__all__ = [
    "FaultInjector", "FaultRule", "InjectedFault",
    "install", "uninstall", "active", "hit", "mutate",
    "ambient", "ambient_ctx",
    "STORE_CREATE", "STORE_UPDATE", "STORE_DELETE",
    "PROVIDER_CREATE", "PROVIDER_DELETE", "PROVIDER_REGISTER",
    "SOLVER_DISPATCH", "SOLVER_OUTPUT", "SOLVER_SCENARIOS", "RELAX_OUTPUT",
    "ENCODE_DELTA", "DISPATCH_QUEUE",
    "REMOTE_SOLVE", "NATIVE_LOAD", "TENANT_ADMIT", "TENANT_SOLVE",
    "ALL_SITES",
]
