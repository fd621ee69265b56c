"""Port parity for the two-slot dispatch queue and B8's donated mode, on the
CPU.

``karpenter_tpu_torch/solver/residency.py:DispatchQueue`` is a copy of the
JAX package's (its methods are checked verbatim by
tests/test_torch_isolation.py); every kernel-backend dispatch of
``TorchSolver`` (pack, pack_classed, mesh, scenarios, scenarios-mesh and
the overflow resubmits) goes through it under JAX's labels. Held here
against the JAX package: the same submit/drain/evict script (depths,
drained outputs, ``queue.depth``/``queue.evict`` events, the
``faults.DISPATCH_QUEUE`` contexts); the two-thread serialized storm of
tests/test_concurrency.py; a ``DISPATCH_QUEUE`` fault at either edge of a
scenario batch (declines with a ladder, the same breaker record; raises
without one) and of a solve (the ladder's oracle rung, the same Results);
the single-node sweep deciding alike with and without the prefetch; the
``solver_dispatch_queue_depth`` gauge after a provisioning solve; the
small twin replayed under the chaos plan plus a ``DISPATCH_QUEUE`` rule.
``KTPU_DONATE_DELTA=1`` on CPU tensors takes the plain out-of-place apply,
as JAX's CPU backend does: the old tensor intact, the decisions unchanged.

Tolerance: exact equality throughout.
"""

from __future__ import annotations

import copy
import importlib
import random
import sys
import threading

import numpy as np
import pytest
import torch

import twin_cases as tc
from helpers import make_pods
from test_torch_ladder import audit, build_solver, health_of, health_state
from test_torch_residency import ChurnCluster, signature

JAX, PORT = PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _no_leaked_seams():
    yield
    for pkg in PKGS:
        tc.release_seams(pkg)


def _config(pkg, **kw):
    if pkg == PORT:
        kw.setdefault("device", "cpu")
    return _mod(pkg, "solver.driver").SolverConfig(**kw)


# -- the queue itself ----------------------------------------------------------


def _queue_script(pkg):
    """Submits and drains on ``pkg``'s DispatchQueue under a tracer and an
    injector whose one rule records every DISPATCH_QUEUE context and fails
    the submit labelled "boom": (depth, drained payload) per step, the
    events of the open span, the contexts, the fault log."""
    obs, faults = _mod(pkg, "obs"), _mod(pkg, "faults")
    ctxs = []

    def match(ctx):
        ctxs.append(dict(ctx))
        return ctx.get("label") == "boom"

    inj = faults.install(faults.FaultInjector([faults.FaultRule(faults.DISPATCH_QUEUE,
                                                                match=match)]))
    tracer = obs.install(obs.Tracer(obs.PerfClock()))
    queue = _mod(pkg, "solver.residency").DispatchQueue()
    payloads = {k: np.full(3, i) for i, k in enumerate("abcd")}
    steps = []
    with obs.span("script"):
        slots = {k: queue.submit(k, lambda k=k: payloads[k]) for k in "abc"}
        steps.append(("after three submits", queue.depth()))
        for k in ("c", "a", "b"):  # "a" was evicted: its outputs still drain
            out = queue.drain(slots[k])
            steps.append((k, queue.depth(), out is payloads[k]))
        with pytest.raises(faults.InjectedFault):
            queue.submit("boom", lambda: payloads["d"])
        steps.append(("after the failed submit", queue.depth()))
        slot = queue.submit("d", lambda: payloads["d"])
        steps.append(("d", queue.drain(slot) is payloads["d"], queue.depth()))
    events = [(name, attrs) for s in tracer.finished("script") for _, name, attrs in s.events]
    return steps, events, ctxs, list(inj.log)


def test_queue_script_equals_jax():
    got = {pkg: _queue_script(pkg) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    steps, events, ctxs, log = got[PORT]
    assert steps[0] == ("after three submits", 2)
    assert ("queue.evict", {"label": "a"}) in events
    assert all(s[2] for s in steps[1:4]) and steps[4] == ("after the failed submit", 0)
    assert {c["op"] for c in ctxs} == {"submit", "drain"} and len(log) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_submit_drain_from_two_threads_serialized(pkg):
    """tests/test_concurrency.py::TestDispatchQueueConcurrent on ``pkg``'s
    queue: its edges serialized on one lock, each thread drains exactly
    what it submitted, and the storm ends with the queue empty."""
    queue = _mod(pkg, "solver.residency").DispatchQueue()
    edge_lock = threading.Lock()
    errors = []
    barrier = threading.Barrier(2)
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def pump(tid):
        try:
            barrier.wait()
            for i in range(50):
                payload = torch.full((4,), tid * 1000 + i)
                with edge_lock:
                    slot = queue.submit(f"t{tid}-{i}", lambda p=payload: p)
                with edge_lock:
                    out = queue.drain(slot)
                assert out is payload, (tid, i)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    try:
        threads = [threading.Thread(target=pump, args=(t,)) for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old_interval)
    assert not errors, errors
    assert queue.depth() == 0


# -- C5: a DISPATCH_QUEUE fault takes the ladder's route ------------------------


def _queue_rule(pkg, op, **rule):
    faults = _mod(pkg, "faults")
    return faults.install(faults.FaultInjector([faults.FaultRule(
        faults.DISPATCH_QUEUE, match=lambda ctx: ctx.get("op") == op, **rule)], seed=0))


def _churn_batch(pkg, op, health):
    """tests/test_delta_encode.py's queue-fault case: one scenario over the
    churn cluster's pods, one DISPATCH_QUEUE rule at ``op``."""
    cluster = ChurnCluster(random.Random(0))
    config = _config(pkg, health=health) if health is not None else None
    solver = cluster.build_solver(pkg, _mod(pkg, "solver.driver").EncodeCache(), config)
    inj = _queue_rule(pkg, op, times=1)
    try:
        out = solver.solve_scenarios(
            [_mod(pkg, "solver.driver").Scenario(pods=list(cluster.pods_for(pkg)))])
    finally:
        _mod(pkg, "faults").uninstall()
    return out, inj, solver


@pytest.mark.parametrize("op", ["submit", "drain"])
def test_queue_fault_declines_the_batch_as_jax(op):
    def trace(pkg):
        health, _ = health_of(pkg)
        out, inj, solver = _churn_batch(pkg, op, health)
        return (out is None, inj.fired(_mod(pkg, "faults").DISPATCH_QUEUE), list(inj.log),
                health.export_state(), audit(pkg), solver._queue.depth())

    got = {pkg: trace(pkg) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    declined, fired, _, state, rung, _ = got[PORT]
    assert declined and fired == 1
    assert state["breakers"]["batched"]["failures"] == 1
    assert rung[:2] == ("scenarios", "batched")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("op", ["submit", "drain"])
def test_queue_fault_raises_without_health(pkg, op):
    with pytest.raises(_mod(pkg, "faults").InjectedFault):
        _churn_batch(pkg, op, None)


@pytest.mark.parametrize("op", ["submit", "drain"])
def test_queue_fault_in_a_solve_takes_the_oracle_rung(op):
    """The same fault in a provisioning solve's pack dispatch: with a
    ladder the kernel rung fails over to the host oracle, with the same
    Results, health and audit rung as JAX."""
    pods = make_pods(8, cpu="1", memory="1Gi")

    def trace(pkg):
        health, _ = health_of(pkg)
        solver, ps = build_solver(pkg, pods, health=health)
        inj = _queue_rule(pkg, op, times=1)
        res = solver.solve(ps)
        return signature(res), health_state(health), audit(pkg), list(inj.log)

    got = {pkg: trace(pkg) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    assert got[PORT][2][1] != "kernel" and got[PORT][3]


# -- the prefetch, the gauge ------------------------------------------------------


def test_single_node_sweep_identical_with_and_without_prefetch(monkeypatch):
    """tests/test_delta_encode.py's prefetch equivalence on the port: the
    queue is pure overlap, never semantics. Every slot a sweep leaves
    behind is an abandoned prefetch, as in JAX's run of the same sweep."""
    def decide(pkg, prefetch):
        monkeypatch.setenv("KTPU_PREFETCH", prefetch)
        wl = _mod(pkg, "solver.workloads")
        args = (40, "cpu") if pkg == PORT else (40,)
        ctx, method, candidates, budgets = wl.build_single_consolidation_env(*args)
        cmd = method.compute_command(candidates, budgets)
        depths = [e["solver"]._queue.depth() for e in ctx.scenario_envs._entries.values()]
        return (cmd.decision, sorted(c.node_claim.name for c in cmd.candidates),
                [sorted(it.name for it in r.instance_type_options) for r in cmd.replacements],
                depths)

    got = {(pkg, p): decide(pkg, p) for pkg in PKGS for p in ("0", "1")}
    assert got[(PORT, "0")][:3] == got[(PORT, "1")][:3]
    assert got[(PORT, "0")][3] and not any(got[(PORT, "0")][3])
    for p in ("0", "1"):
        assert got[(PORT, p)] == got[(JAX, p)]


def test_dispatch_queue_gauge_after_a_provisioning_solve(monkeypatch):
    from test_torch_operator import run_operator
    from test_torch_residency import to_port

    pods = _mod(JAX, "solver.workloads").mixed_pods(30, seed=4)
    got = {}
    for pkg in PKGS:
        gauge = _mod(pkg, "controllers.provisioning").DISPATCH_QUEUE_DEPTH
        gauge.clear()
        ps = copy.deepcopy(pods)
        kw = {"solver_config": _config(pkg)} if pkg == PORT else {}
        run_operator(pkg, to_port(ps) if pkg == PORT else ps, monkeypatch, **kw)
        got[pkg] = gauge.collect()
    assert got[PORT] == got[JAX]
    assert [(v[1].endswith("solver_dispatch_queue_depth"), v[3]) for v in got[PORT]] == [(True, 0.0)]


# -- KTPU_DONATE_DELTA=1 on the CPU ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["bool", "int32", "float32"])
def test_donate_on_cpu_tensors_is_out_of_place(monkeypatch, dtype):
    """JAX's CPU backend never donates; the port's CPU tensors neither: a
    new tensor equal to JAX's, the old one left as it was."""
    from karpenter_tpu.ops.solve import delta_apply_rows as jax_apply
    from karpenter_tpu_torch.ops.solve import delta_apply_rows

    monkeypatch.setenv("KTPU_DONATE_DELTA", "1")
    rng = np.random.default_rng(3)
    host = (rng.random((33, 4, 3)) * 9).astype(dtype)
    idx = np.array([5, -1, 5, 32, 0], np.int32)
    rows = (rng.random((5, 4, 3)) * 9).astype(dtype)
    rows[2] = rows[0]  # a duplicate index carries its row twice
    arr = torch.from_numpy(host.copy())
    out = delta_apply_rows(arr, idx, rows)
    assert out is not arr and out.data_ptr() != arr.data_ptr()
    assert np.array_equal(arr.numpy(), host)
    assert np.array_equal(out.numpy(), np.asarray(jax_apply(host, idx, rows)))


def test_donate_on_cpu_decides_as_the_plain_apply(monkeypatch):
    """The churn script on two caches in lockstep, one solved with
    KTPU_DONATE_DELTA=1 and one without: after every tick the same
    decisions and device delta rows, and every tensor the store held
    before the tick left as it was."""
    cluster = ChurnCluster(random.Random(11))
    caches = {d: _mod(PORT, "solver.driver").EncodeCache() for d in ("0", "1")}
    delta_rows = 0
    for _ in range(6):
        cluster.tick()
        got = {}
        for donate, cache in caches.items():
            monkeypatch.setenv("KTPU_DONATE_DELTA", donate)
            store = cache.device_store
            before = [(t, t.clone()) for t in (store._dev_buffers.values() if store else ())]
            res = cluster.build_solver(PORT, cache).solve(cluster.pods_for(PORT))
            got[donate] = (signature(res), cache.device_store.last_delta_rows)
            assert all(torch.equal(t, kept) for t, kept in before)
        assert got["1"] == got["0"]
        delta_rows += got["0"][1]
    assert delta_rows


# -- the twin under the chaos plan plus DISPATCH_QUEUE -------------------------------


def test_twin_under_dispatch_queue_faults_equals_jax():
    """The small replay to PARITY_MINUTES under twin_cases.chaos_plan plus
    one DISPATCH_QUEUE rule (probability 0.5 inside the plan's window):
    the same canonical audit bytes and fault log as JAX's. The SLO wall
    is not asserted: solves the rule pushes off the kernel rungs breach
    its fallback limit in both packages alike."""
    from test_torch_twin import PARITY_MINUTES

    out = {}
    for pkg in PKGS:
        faults = _mod(pkg, "faults")
        base = tc.chaos_plan(pkg)

        def plan(clock, base=base, faults=faults):
            return base(clock) + [faults.FaultRule(
                faults.DISPATCH_QUEUE, probability=0.5, until=clock.now() + 150.0)]

        device = "cpu" if pkg == PORT else None
        twin = _mod(pkg, "sim.twin").ClusterTwin(
            tc.small_trace(pkg), profile=tc.small_profile(pkg),
            config=tc.small_config(pkg, device=device, minutes=PARITY_MINUTES,
                                   assert_slos=False),
            fault_rules=plan)
        with twin:
            twin.run()
            out[pkg] = (twin.canonical_audit(), list(twin.fault_log()))
        tc.release_seams(pkg)
    assert out[PORT] == out[JAX]
    assert any("solver.dispatch_queue" in str(f) for f in out[PORT][1])
