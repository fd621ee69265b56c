"""The cluster twin's small replay and chaos plan, for either package.

``tests/e2e/test_twin.py``'s ``chaos_plan``, ``SMALL_PROFILE``,
``small_trace`` and ``small_config`` (``:53-101``), built from the
package named by ``pkg`` ("karpenter_tpu" or "karpenter_tpu_torch"), so
the port's tests run the JAX package's replay on either. Imports neither
package at module level: the card's tests use it without jax.
"""

import importlib
import math


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def chaos_plan(pkg):
    """Store conflicts, provider ICE and registration stalls for the first
    150 simulated seconds, no solver-crash rules, from ``pkg``'s faults."""
    faults = mod(pkg, "faults")
    ice = mod(pkg, "cloudprovider.types").InsufficientCapacityError
    conflict = mod(pkg, "kube.store").ConflictError

    def operator_kinds(ctx):
        return ctx.get("kind") in ("NodeClaim", "Node")

    def plan(clock):
        until = clock.now() + 150.0
        return [
            faults.FaultRule(
                faults.STORE_CREATE, probability=0.1, until=until,
                error=lambda: conflict("injected conflict"), match=operator_kinds,
            ),
            faults.FaultRule(
                faults.STORE_UPDATE, probability=0.05, until=until,
                error=lambda: conflict("injected conflict"), match=operator_kinds,
            ),
            faults.FaultRule(
                faults.PROVIDER_CREATE, probability=0.15, until=until,
                error=lambda: ice("injected ICE"),
            ),
            faults.FaultRule(faults.PROVIDER_REGISTER, probability=0.2, until=until),
        ]

    return plan


def small_profile(pkg):
    return mod(pkg, "sim.twin").ClusterProfile(nodes=30, pods_per_node=5, n_types=24)


def small_trace(pkg, minutes=5):
    trace = mod(pkg, "sim.trace")
    return trace.generate(5, trace.ChurnProfile(
        minutes=minutes, pods_per_minute=4, reclaim_minutes=(1,), ice_minutes=(2,)))


def small_config(pkg, device=None, **overrides):
    """``small_config`` with no wall-clock bound (the p99 decision latency
    unbounded: the tests hold decisions, never time) and, for the port,
    ``SolverConfig(device=device)``."""
    base = dict(
        seed=9, minutes=5, steps_per_minute=2,
        slo=mod(pkg, "sim.slo").SLOConfig(
            cost_check_every=2, p99_decision_latency_ms=math.inf),
    )
    if device is not None:
        base["solver_config"] = mod(pkg, "solver.driver").SolverConfig(device=device)
    base.update(overrides)
    return mod(pkg, "sim.twin").TwinConfig(**base)


def release_seams(pkg):
    """Uninstall what a twin left installed: the fault injector, the audit
    trail, the tracer."""
    obs = mod(pkg, "obs")
    mod(pkg, "faults").uninstall()
    obs.uninstall_audit()
    if obs.active() is not None:
        obs.uninstall()


def node_claims(pkg, client):
    """The store's NodeClaims by content, sorted: pool, requirements in
    order (the instance-type options among them), the pods on the claim's
    node by name. Not the claims' own names: a launched claim's comes from
    the process-wide uid counter (``api/objects.py:new_uid``), which the
    other tests run in the same process advance, each package's apart."""
    objects = mod(pkg, "api.objects")
    labels = mod(pkg, "api.labels")
    on_node = {}
    for p in client.list(objects.Pod):
        if p.spec.node_name:
            on_node.setdefault(p.spec.node_name, []).append(p.metadata.name)
    return sorted(
        (c.metadata.labels.get(labels.NODEPOOL_LABEL_KEY, ""),
         tuple((r.key, r.operator, tuple(r.values)) for r in c.spec.requirements),
         tuple(sorted(on_node.get(c.status.node_name, ()))))
        for c in client.list(objects.NodeClaim))


def deterministic(report):
    """A MinuteReport's fields less the wall-clock ones."""
    d = report.as_dict()
    for k in ("p99_latency_ms", "max_latency_ms"):
        d.pop(k)
    return d
