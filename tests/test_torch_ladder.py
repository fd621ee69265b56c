"""Port parity for the degradation ladder, on the CPU.

The port of tests/test_faults.py's TestBackoff, TestBreakerAndLadder and
TestSolverIntegration: every case runs in both packages, the JAX
package's classes and ``TpuSolver`` against the port's copies and
``TorchSolver(device="cpu")``, each under its own fault injector, and
holds them equal: the same traces of ``Backoff``/``RetryTracker``/
``CircuitBreaker``/``DegradationLadder``/``SolverHealth`` on the injected
clock, the same ``Results`` in slot order (``test_torch_residency.
signature``), the same health state afterwards (``allow_kernel``,
``allow_batched``, ``quarantines``, ``delta_fallbacks``, ``level()``) and
the same audit ``rung`` and ``guard`` verdict. The cases with no JAX
twin: the kernel rung coming back after the cool-down; a
``_build.KernelBuildError`` (nvcc missing), which propagates even with a
ladder, because it is a broken install and not a fault; and a fault of
the card's own (a ``KernelLaunchError``, or on CUDA any failure with no
injected fault behind it), which propagates too, because the ladder
never serves the host oracle in place of the card after a real kernel
fault.

Tolerance: exact equality throughout.
"""

from __future__ import annotations

import copy
import importlib

import pytest
import torch

from helpers import make_nodepool, make_pods
from test_torch_residency import signature, to_port

JAX, PORT = PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    for pkg in PKGS:
        _mod(pkg, "faults").uninstall()


def _both(fn):
    """``fn(pkg)`` in both packages, held equal; the port's value."""
    got = {pkg: fn(pkg) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    return got[PORT]


def build_solver(pkg, pods, n_types=10, cache=None, **config):
    """A solver of ``pkg`` over one default NodePool and ``n_types``
    corpus types (tests/test_faults.py:build_solver); the port's on the
    CPU, over pods rebuilt from its classes. Returns (solver, pods)."""
    drv = _mod(pkg, "solver.driver")
    kube = _mod(pkg, "kube")
    pool = make_nodepool()
    pods = copy.deepcopy(pods)
    if pkg == PORT:
        pool, pods = to_port(pool), to_port(pods)
        config.setdefault("device", "cpu")
    its = {pool.name: _mod(pkg, "cloudprovider.corpus").generate(n_types)}
    topo = _mod(pkg, "scheduling.topology").Topology(
        kube.Client(kube.TestClock()), [], [pool], its, pods)
    cls = drv.TorchSolver if pkg == PORT else drv.TpuSolver
    return cls([pool], its, topo, config=drv.SolverConfig(**config),
               encode_cache=cache or drv.EncodeCache()), pods


def health_of(pkg, **kw):
    clock = _mod(pkg, "kube").TestClock()
    return _mod(pkg, "faults.breaker").SolverHealth(clock, **kw), clock


def health_state(h):
    return (h.allow_kernel(), h.allow_batched(), h.quarantines, h.delta_fallbacks, h.level())


def audit(pkg):
    rec = _mod(pkg, "obs").AUDIT.last()
    return rec.kind, rec.rung, rec.guard.split(":")[0]


def install(pkg, site, **rule):
    f = _mod(pkg, "faults")
    f.install(f.FaultInjector([f.FaultRule(getattr(f, site), **rule)]))


# -- TestBackoff -------------------------------------------------------------------


class TestBackoff:
    def test_delays_grow_and_cap(self):
        def trace(pkg):
            b = _mod(pkg, "faults.backoff").Backoff(
                _mod(pkg, "kube").TestClock(), initial=1.0, factor=2.0, max_delay=5.0,
                jitter=0.0)
            return [b.delay(i) for i in range(4)]

        assert _both(trace) == [1.0, 2.0, 4.0, 5.0]

    def test_jitter_deterministic_per_seed(self):
        def trace(pkg):
            mk = lambda: _mod(pkg, "faults.backoff").Backoff(  # noqa: E731
                _mod(pkg, "kube").TestClock(), jitter=0.5, seed=3)
            first = [mk().delay(i) for i in range(3)]
            assert first == [mk().delay(i) for i in range(3)]
            return first

        _both(trace)

    def test_call_retries_on_injected_clock_then_raises(self):
        def trace(pkg):
            clock = _mod(pkg, "kube").TestClock()
            conflict = _mod(pkg, "kube.store").ConflictError
            b = _mod(pkg, "faults.backoff").Backoff(clock, initial=1.0, jitter=0.0,
                                                    max_attempts=3)
            attempts = []

            def flaky():
                attempts.append(clock.now())
                raise conflict("still conflicting")

            t0 = clock.now()
            with pytest.raises(conflict):
                b.call(flaky, retriable=(conflict,))
            return [a - t0 for a in attempts], clock.now() - t0

        # slept BETWEEN attempts only
        assert _both(trace) == ([0.0, 1.0, 3.0], 3.0)

    def test_call_recovers(self):
        def trace(pkg):
            conflict = _mod(pkg, "kube.store").ConflictError
            b = _mod(pkg, "faults.backoff").Backoff(_mod(pkg, "kube").TestClock(),
                                                    max_attempts=3, jitter=0.0)
            state = {"n": 0}

            def flaky():
                state["n"] += 1
                if state["n"] < 3:
                    raise conflict("conflict")
                return "ok"

            return b.call(flaky, retriable=(conflict,)), state["n"]

        assert _both(trace) == ("ok", 3)

    def test_tracker_gates_and_clears(self):
        def trace(pkg):
            clock = _mod(pkg, "kube").TestClock()
            t = _mod(pkg, "faults.backoff").RetryTracker(clock, initial=4.0, jitter=0.0)
            out = [t.ready("k"), t.failure("k"), t.ready("k")]
            clock.step(4.0)
            out.append(t.ready("k"))
            t.failure("k")  # second failure: 8s
            clock.step(4.0)
            out.append(t.ready("k"))
            t.success("k")
            return out + [t.ready("k"), t.attempts("k")]

        assert _both(trace) == [True, 4.0, False, True, False, True, 0]

    def test_tracker_prune(self):
        def trace(pkg):
            t = _mod(pkg, "faults.backoff").RetryTracker(_mod(pkg, "kube").TestClock())
            t.failure("gone")
            t.failure("kept")
            t.prune(["kept"])
            return t.ready("gone"), t.ready("kept")

        assert _both(trace) == (True, False)


# -- TestBreakerAndLadder ----------------------------------------------------------


class TestBreakerAndLadder:
    def test_breaker_trips_cools_reprobes(self):
        def trace(pkg):
            clock = _mod(pkg, "kube").TestClock()
            b = _mod(pkg, "faults.breaker").CircuitBreaker(clock, failure_threshold=2,
                                                           cooldown=30.0)
            out = [b.allow()]
            b.record_failure()
            out.append(b.allow())
            b.record_failure()  # trip
            out.append(b.allow())
            clock.step(30.0)
            out.append(b.allow())  # half-open probe
            b.record_failure()  # re-trip immediately
            out.append(b.allow())
            clock.step(30.0)
            out.append(b.allow())
            b.record_success()
            return out + [b.allow(), b.state]

        assert _both(trace) == [True, True, False, True, False, True, True, "closed"]

    def test_ladder_degrades_and_recovers(self):
        def trace(pkg):
            clock = _mod(pkg, "kube").TestClock()
            ladder = _mod(pkg, "faults.breaker").DegradationLadder(
                clock, ("batched", "kernel", "oracle"), failure_threshold=1, cooldown=60.0)
            out = [ladder.current()]
            ladder.record("batched", ok=False)
            out.append(ladder.current())
            ladder.record("kernel", ok=False)
            out.append(ladder.current())  # last rung unconditional
            clock.step(60.0)
            return out + [ladder.current(), ladder.level()]  # cool-down re-probe upward

        assert _both(trace) == ["batched", "kernel", "oracle", "batched", 0]

    def test_solver_health_quarantine_and_events(self):
        def trace(pkg):
            clock = _mod(pkg, "kube").TestClock()
            recorder = _mod(pkg, "events").Recorder(clock)
            h = _mod(pkg, "faults.breaker").SolverHealth(clock, recorder=recorder,
                                                         cooldown=60.0)
            out = [health_state(h)]
            h.quarantine("kernel", "conservation violated")
            out.append(health_state(h))  # batched rides the same kernels
            out.append(len(recorder.for_reason("SolverQuarantined")))
            clock.step(60.0)
            out.append(h.allow_kernel())  # half-open re-probe
            h.record_kernel(True)
            return out + [len(recorder.for_reason("SolverRestored")), health_state(h)]

        got = _both(trace)
        assert got[1][:3] == (False, False, 1) and got[2] == 1
        assert got[3] and got[4] == 1 and got[5][:2] == (True, True)

    def test_two_healths_keep_their_own_state(self):
        """Two SolverHealths in one process (two solvers, two tenants'
        labels) share the port's metric registry without colliding."""
        def trace(pkg):
            a, _ = health_of(pkg, failure_threshold=1)
            b, _ = health_of(pkg, failure_threshold=1, metric_labels={"tenant": "t2"})
            a.record_kernel(False, reason="boom")
            return health_state(a), health_state(b)

        a, b = _both(trace)
        assert not a[0] and b[0]


# -- TestSolverIntegration ---------------------------------------------------------


def _corrupt_fills(outs):
    outs = list(outs)
    outs[5] = outs[5] - 7  # claim_fills negative
    return tuple(outs)


def _corrupt_pins(outs):
    outs = list(outs)
    outs[7] = outs[7] + 500  # c_dzone out of vocab
    return tuple(outs)


class TestSolverIntegration:
    def test_zero_overhead_when_off_byte_identical(self):
        """No injector vs installed-but-empty injector vs plain run: the
        committed decisions are identical, and equal across packages."""
        pods = make_pods(40, cpu="1", memory="2Gi")

        def trace(pkg):
            f = _mod(pkg, "faults")
            sigs = []
            for injector in (None, f.FaultInjector([], seed=0), None):
                if injector is not None:
                    f.install(injector)
                solver, ps = build_solver(pkg, pods)
                sigs.append(signature(solver.solve(ps)))
                f.uninstall()
            assert sigs[0] == sigs[1] == sigs[2]
            return sigs[0], audit(pkg)

        assert _both(trace)[1] == ("solve", "kernel", "ok")

    def test_dispatch_fault_degrades_to_oracle(self):
        pods = make_pods(12, cpu="1", memory="1Gi")

        def trace(pkg):
            health, _ = health_of(pkg, failure_threshold=1, cooldown=60.0)
            install(pkg, "SOLVER_DISPATCH")
            solver, ps = build_solver(pkg, pods, health=health)
            results = solver.solve(ps)
            rung = audit(pkg)
            _mod(pkg, "faults").uninstall()
            oracle, ps = build_solver(pkg, pods, force_oracle=True)
            assert signature(results) == signature(oracle.solve(ps))
            return signature(results), health_state(health), rung

        sig, state, rung = _both(trace)
        assert not sig[2] and sig[0]  # every pod placed, by the oracle rung
        assert not state[0] and rung == ("solve", "oracle", "ok")  # breaker tripped

    def test_kernel_rung_recovers_after_cooldown(self):
        """After the breaker's cool-down on the injected clock the next
        solve is back on the kernel rung and equals a health=None solve."""
        pods = make_pods(12, cpu="1", memory="1Gi")

        def trace(pkg):
            health, clock = health_of(pkg, failure_threshold=1, cooldown=60.0)
            install(pkg, "SOLVER_DISPATCH")
            solver, ps = build_solver(pkg, pods, health=health)
            solver.solve(ps)
            _mod(pkg, "faults").uninstall()
            solver, ps = build_solver(pkg, pods, health=health)
            held_open = (solver.solve(ps) and audit(pkg)[1], health_state(health))
            clock.step(60.0)
            solver, ps = build_solver(pkg, pods, health=health)
            back = signature(solver.solve(ps))
            rung = audit(pkg)
            plain, ps = build_solver(pkg, pods)
            assert back == signature(plain.solve(ps))
            return held_open, back, rung, health_state(health)

        held_open, _, rung, state = _both(trace)
        assert held_open[0] == "oracle" and not held_open[1][0]
        assert rung == ("solve", "kernel", "ok") and state[0] and state[4] == 0

    def test_dispatch_fault_propagates_without_health(self):
        pods = make_pods(4)

        def trace(pkg):
            install(pkg, "SOLVER_DISPATCH")
            solver, ps = build_solver(pkg, pods)
            with pytest.raises(_mod(pkg, "faults").InjectedFault) as exc:
                solver.solve(ps)
            return type(exc.value).__name__

        _both(trace)

    def test_corrupt_output_quarantined_never_committed(self):
        """Garbage fills are caught by the guard BEFORE decode: with a
        ladder the batch re-solves on the oracle, without one the
        integrity error surfaces. relax=False pins the exact route."""
        pods = make_pods(10, cpu="1", memory="1Gi")

        def trace(pkg):
            integrity = _mod(pkg, "faults.guard").SolverIntegrityError
            install(pkg, "SOLVER_OUTPUT", mutate=_corrupt_fills)
            solver, ps = build_solver(pkg, pods, relax=False)
            with pytest.raises(integrity):
                solver.solve(ps)
            bare = audit(pkg)
            health, _ = health_of(pkg, cooldown=60.0)
            solver, ps = build_solver(pkg, pods, health=health, relax=False)
            results = solver.solve(ps)
            return signature(results), health_state(health), bare, audit(pkg)

        sig, state, _, rung = _both(trace)
        assert not sig[2]  # the oracle placed everything
        assert state[2] == 1 and not state[0]
        assert rung == ("solve", "oracle", "quarantined")

    def test_corrupt_domain_pins_quarantined_pre_decode(self):
        """The decode-crash vector: garbage c_dzone ids would raise mid-
        commit; the guard rejects them pre-decode."""
        pods = make_pods(6, cpu="1", memory="1Gi")

        def trace(pkg):
            install(pkg, "SOLVER_OUTPUT", mutate=_corrupt_pins)
            solver, ps = build_solver(pkg, pods, relax=False)
            with pytest.raises(_mod(pkg, "faults.guard").SolverIntegrityError):
                solver.solve(ps)
            health, _ = health_of(pkg, cooldown=60.0)
            solver, ps = build_solver(pkg, pods, health=health, relax=False)
            return signature(solver.solve(ps)), health_state(health), audit(pkg)

        assert _both(trace)[2] == ("solve", "oracle", "quarantined")

    def test_corrupt_delta_sheds_warm_state_then_quarantines(self):
        """A rejected solve on a warm (reused) encoding sheds the warm state
        once (the half-step: delta_fallbacks 1, no rung tripped by it),
        the full re-encode is rejected too, and the kernel rung is
        quarantined."""
        pods = make_pods(10, cpu="1", memory="1Gi")

        def trace(pkg):
            health, _ = health_of(pkg, cooldown=60.0)
            cache = _mod(pkg, "solver.driver").EncodeCache()
            warm, ps = build_solver(pkg, pods, cache=cache, health=health, relax=False)
            first = signature(warm.solve(ps))
            install(pkg, "SOLVER_OUTPUT", mutate=_corrupt_fills)
            solver, ps = build_solver(pkg, pods, cache=cache, health=health, relax=False)
            return first, signature(solver.solve(ps)), health_state(health), audit(pkg)

        first, again, state, rung = _both(trace)
        assert not first[2] and not again[2] and state[2:4] == (1, 1)
        assert rung == ("solve", "oracle", "quarantined")

    def test_decode_crash_drops_batch(self):
        """A decode that raises after fills may have landed: the batch is
        dropped (every pod errored, rung "dropped") and the kernel rung
        quarantined; without a ladder DecodeCommitError surfaces."""
        pods = make_pods(6, cpu="1", memory="1Gi")

        def boom(*a, **k):
            raise RuntimeError("decode crashed")

        def trace(pkg):
            guard = _mod(pkg, "faults.guard")
            solver, ps = build_solver(pkg, pods, relax=False)
            solver._decode = boom
            with pytest.raises(guard.DecodeCommitError):
                solver.solve(ps)
            health, _ = health_of(pkg, cooldown=60.0)
            solver, ps = build_solver(pkg, pods, health=health, relax=False)
            solver._decode = boom
            results = solver.solve(ps)
            return signature(results), health_state(health), audit(pkg)

        sig, state, rung = _both(trace)
        assert len(sig[2]) == 6 and state[2] == 1
        assert rung == ("solve", "dropped", "quarantined")

    def test_scenario_fault_declines_batch(self):
        """An injected scenario-dispatch failure makes solve_scenarios
        return None (the per-probe fallback), recording the batched rung
        failure; the per-probe kernel rung stays up."""
        pods = make_pods(8, cpu="1", memory="1Gi")

        def trace(pkg):
            health, _ = health_of(pkg, failure_threshold=1, cooldown=60.0)
            install(pkg, "SOLVER_SCENARIOS")
            solver, ps = build_solver(pkg, pods, health=health)
            out = solver.solve_scenarios([_mod(pkg, "solver.driver").Scenario(pods=ps)])
            rec = _mod(pkg, "obs").AUDIT.last()
            return out, health_state(health), (rec.kind, rec.rung, bool(rec.attrs.get("error")))

        out, state, rung = _both(trace)
        assert out is None and not state[1] and state[0]
        assert rung == ("scenarios", "batched", True)

    def test_scenario_fault_propagates_without_health(self):
        pods = make_pods(8, cpu="1", memory="1Gi")

        def trace(pkg):
            install(pkg, "SOLVER_SCENARIOS")
            solver, ps = build_solver(pkg, pods)
            with pytest.raises(_mod(pkg, "faults").InjectedFault) as exc:
                solver.solve_scenarios([_mod(pkg, "solver.driver").Scenario(pods=ps)])
            return type(exc.value).__name__

        _both(trace)

    def test_corrupt_scenarios_quarantine_batched_rung(self):
        """A corrupt scenario batch is rejected by the per-scenario guard:
        with a ladder the batched rung is quarantined and the batch
        declines; the kernel rung stays up."""
        pods = make_pods(8, cpu="1", memory="1Gi")

        def trace(pkg):
            health, _ = health_of(pkg, cooldown=60.0)
            install(pkg, "SOLVER_OUTPUT", mutate=_corrupt_fills)
            solver, ps = build_solver(pkg, pods, health=health)
            out = solver.solve_scenarios([_mod(pkg, "solver.driver").Scenario(pods=ps)])
            return out, health_state(health), audit(pkg)

        out, state, rung = _both(trace)
        assert out is None and state[:3] == (True, False, 1)
        assert rung == ("scenarios", "batched", "quarantined")


# -- a broken install is not a fault ----------------------------------------------


def test_kernel_build_error_propagates_with_health(monkeypatch, tmp_path):
    """nvcc missing: the dispatch's first kernel build raises
    KernelBuildError, which no rung absorbs, health set or not; the
    ladder records nothing."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import solve as solve_mod

    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found (set CUDA_HOME)")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    # the dispatch's launch path, as a CUDA tensor would take it: the
    # library is built at its first use
    monkeypatch.setattr(solve_mod, "dispatch_packed",
                        lambda *a, **k: _build.library("pack"))
    monkeypatch.setattr(solve_mod, "dispatch_scenarios_packed",
                        lambda *a, **k: _build.library("pack"))
    pods = make_pods(6, cpu="1", memory="1Gi")
    health, _ = health_of(PORT, failure_threshold=1)
    solver, ps = build_solver(PORT, pods, health=health, relax=False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        solver.solve(ps)
    Scenario = _mod(PORT, "solver.driver").Scenario
    with pytest.raises(_build.KernelBuildError):
        solver.solve_scenarios([Scenario(pods=ps)])
    assert health_state(health) == (True, True, 0, 0, 0)


# -- a fault of the card is not the ladder's ----------------------------------------


def test_launch_error_propagates_with_health(monkeypatch):
    """A KernelLaunchError (a launch the card refused) is a fault of the
    card, which the ladder never moves to the host oracle: it propagates
    from the solve and from the batched rung with health set, and the
    ladder records nothing."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import solve as solve_mod

    def refused(*a, **k):
        raise _build.KernelLaunchError("pack: CUDA error 700 at launch")

    monkeypatch.setattr(solve_mod, "dispatch_packed", refused)
    monkeypatch.setattr(solve_mod, "dispatch_scenarios_packed", refused)
    pods = make_pods(6, cpu="1", memory="1Gi")
    health, _ = health_of(PORT, failure_threshold=1)
    solver, ps = build_solver(PORT, pods, health=health, relax=False)
    with pytest.raises(_build.KernelLaunchError):
        solver.solve(ps)
    Scenario = _mod(PORT, "solver.driver").Scenario
    with pytest.raises(_build.KernelLaunchError):
        solver.solve_scenarios([Scenario(pods=ps)])
    assert health_state(health) == (True, True, 0, 0, 0)


@pytest.mark.parametrize("exc", ["RuntimeError", "SolverIntegrityError"])
def test_card_fault_is_what_was_not_injected(exc):
    """On the kernel backend on CUDA, a failure is the card's own (it
    propagates) unless an injected fault fired since the solve began; on
    the CPU plain path and the native backend the ladder takes it, as the
    JAX package's does."""
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.faults.guard import SolverIntegrityError

    err = (SolverIntegrityError(["claim fills negative"]) if exc == "SolverIntegrityError"
           else RuntimeError("CUDA error: an illegal memory access was encountered"))
    pods = make_pods(2)
    cpu, _ = build_solver(PORT, pods)
    native, _ = build_solver(PORT, pods, backend="native")
    card, _ = build_solver(PORT, pods)
    card.device = torch.device("cuda")  # the predicate reads the solver's device
    assert not cpu._card_fault(err, 0) and not native._card_fault(err, 0)
    assert card._card_fault(err, 0)
    faults.install(faults.FaultInjector([faults.FaultRule(faults.SOLVER_OUTPUT)]))
    mark = card._fault_log_mark()
    with pytest.raises(faults.InjectedFault):
        faults.hit(faults.SOLVER_OUTPUT)
    assert not card._card_fault(err, mark)
    assert card._card_fault(err, card._fault_log_mark())
