"""The port's multi-tenant service (karpenter_tpu_torch/solver/tenancy.py and
TenantService) on the CPU, against the JAX package's.

Admission control and QoS tiers decide as the JAX package's on the same
sequence of requests over an injected clock; a deadline overrun maps to
``DeadlineOverrunError``; the fault-isolation witness holds (a victim
tenant's chaos plan quarantines its own ladder and leaves a bystander's
decisions byte-identical, and the victim recovers past the cool-down);
four tenants batched into one union solve each get their solo answer and
JAX's union answer; and a fault of the card in the union solve reaches
every participant, while an injected fault in the batch lane still
declines to solo solves.
"""

import threading

import pytest

from karpenter_tpu_torch import faults
from karpenter_tpu_torch._build import KernelBuildError, KernelLaunchError
from karpenter_tpu_torch.cloudprovider import corpus
from karpenter_tpu_torch.kube import TestClock
from karpenter_tpu_torch.solver import wire
from karpenter_tpu_torch.solver.driver import SolverConfig
from karpenter_tpu_torch.solver.service import TenantService
from karpenter_tpu_torch.solver.tenancy import (
    AdmissionError,
    CrossTenantBatcher,
    DeadlineOverrunError,
    TenantQoS,
    TenantRegistry,
    is_card_fault,
)

from helpers import decision_signature, make_nodepool, make_pods
from test_torch_residency import to_port

CPU = SolverConfig(device="cpu")
N_TYPES = 8
# one NodePool object for every request: same-shape solves share a batch
# key only over the same pool
POOLS = [make_nodepool(name="default")]


@pytest.fixture(autouse=True)
def _clean():
    faults.uninstall()
    yield
    faults.uninstall()


def make_request(n_pods, prefix, pods=None, port=True):
    """One tenant's request, encoded once, by the port's codec or the JAX
    package's (the bytes are identical: tests/test_torch_wire.py)."""
    from karpenter_tpu.cloudprovider import corpus as jax_corpus
    from karpenter_tpu.solver import wire as jax_wire

    if pods is None:
        pods = make_pods(n_pods, cpu="1", memory="1Gi")
        for i, p in enumerate(pods):
            p.metadata.name = f"{prefix}-{i}"
            p.metadata.uid = f"uid-{prefix}-{i}"
    if port:
        return wire.encode_solve_request(
            to_port(pods), to_port(POOLS), {"default": corpus.generate(N_TYPES)},
            solver_options={"reserved_capacity_enabled": False})
    return jax_wire.encode_solve_request(
        pods, POOLS, {"default": jax_corpus.generate(N_TYPES)},
        solver_options={"reserved_capacity_enabled": False})


def snap(request):
    return wire.decode_solve_request(request)


# -- admission control, QoS tiers: the JAX package's decisions ---------------

# each script: registry kwargs, then steps of ("admit", tenant) | ("release",
# index of an earlier admit) | ("step", seconds)
SCRIPTS = {
    "rate_limit_refill": (
        dict(qos={"standard": dict(rate=1.0, burst=2.0)}),
        [("admit", "a"), ("release", 0), ("admit", "a"), ("release", 2), ("admit", "a"),
         ("step", 1.5), ("admit", "a")],
    ),
    "queue_bound": (
        dict(qos={"standard": dict(max_queue=2, burst=10.0)}),
        [("admit", "a"), ("admit", "a"), ("admit", "a"), ("release", 0), ("admit", "a")],
    ),
    "tenant_capacity": (
        dict(max_tenants=2),
        [("admit", "a"), ("admit", "b"), ("admit", "c"), ("admit", "a")],
    ),
    "tier_shed": (
        dict(max_inflight=4, tiers={"gold": "premium", "bulk": "batch"}),
        [("admit", "bulk"), ("admit", "bulk"), ("admit", "bulk"), ("admit", "std"),
         ("admit", "std"), ("admit", "gold"), ("admit", "gold")],
    ),
    "lease_idempotent": (
        dict(),
        [("admit", "a"), ("release", 0), ("release", 0), ("admit", "a")],
    ),
}


def _run_script(pkg, name):
    import importlib

    tenancy = importlib.import_module(f"{pkg}.solver.tenancy")
    kube = importlib.import_module(f"{pkg}.kube")
    kwargs, steps = SCRIPTS[name]
    kwargs = dict(kwargs)
    if "qos" in kwargs:
        kwargs["qos"] = {tier: tenancy.TenantQoS(**q) for tier, q in kwargs["qos"].items()}
    clock = kube.TestClock()
    reg = tenancy.TenantRegistry(clock=clock, **kwargs)
    leases, outcomes = [], []
    for op, arg in steps:
        if op == "admit":
            try:
                leases.append(reg.admit(arg))
                outcomes.append("admitted")
            except tenancy.AdmissionError as exc:
                leases.append(None)
                outcomes.append(exc.reason)
        elif op == "release":
            leases[arg].release()
            leases.append(None)
            outcomes.append("released")
        else:
            clock.step(arg)
            leases.append(None)
            outcomes.append("stepped")
    return outcomes, reg.stats()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_admission_decides_as_jax(name):
    got = _run_script("karpenter_tpu_torch", name)
    assert got == _run_script("karpenter_tpu", name)
    assert any(o not in ("admitted", "released", "stepped") for o in got[0]) or (
        name == "lease_idempotent")


def test_deadline_overrun_on_an_injected_clock():
    clock = TestClock()
    reg = TenantRegistry(clock=clock, qos={"standard": TenantQoS(solve_deadline=1.0)})
    svc = TenantService(registry=reg, config=CPU)
    inj = faults.install(faults.FaultInjector(
        [faults.FaultRule(faults.TENANT_SOLVE, latency=5.0,
                          match=lambda ctx: ctx.get("tenant") == "slow")],
        clock=clock,
    ))
    with pytest.raises(DeadlineOverrunError) as exc_info:
        svc.solve_for("slow", snap(make_request(2, "slow")))
    assert exc_info.value.tenant == "slow" and exc_info.value.elapsed >= 5.0
    assert reg.get("slow").stats()["inflight"] == 0
    assert reg.get("slow").stats()["deadline_overruns"] == 1
    assert svc.solve_for("fast", snap(make_request(2, "fast"))).all_pods_scheduled()
    assert inj.fired(faults.TENANT_SOLVE) == 1


# -- noisy-neighbor fault isolation -------------------------------------------


def _chaos_rules(victim):
    """tests/test_tenants.py's plan, on the port's fault sites: a dispatch
    crash, corrupt kernel output (twice: the warm-encoding retry too), a
    corrupt encode delta, and a service-level crash, all pinned to the
    victim."""

    def only_victim(ctx):
        return ctx.get("tenant") == victim

    def corrupt_fills(outs):
        outs = list(outs)
        outs[5] = outs[5] - 7  # claim fills negative
        return tuple(outs)

    return [
        faults.FaultRule(faults.SOLVER_DISPATCH, times=1, match=only_victim),
        faults.FaultRule(faults.SOLVER_OUTPUT, mutate=corrupt_fills, times=2,
                         match=only_victim),
        faults.FaultRule(faults.ENCODE_DELTA, mutate=lambda vals: vals + 13,
                         match=only_victim),
        faults.FaultRule(faults.TENANT_SOLVE, times=1, after=1, match=only_victim),
    ]


N_ROUNDS = 4


def _requests():
    a = [make_request(3 + i, f"a{i}") for i in range(N_ROUNDS)]
    b = [make_request(2 + i, f"b{i}") for i in range(N_ROUNDS)]
    return a, b


def _run_chaos(clock, a_reqs, b_reqs, seed=7):
    svc = TenantService(registry=TenantRegistry(clock=clock),
                        config=SolverConfig(device="cpu", relax=False))
    inj = faults.install(faults.FaultInjector(_chaos_rules("a"), seed=seed, clock=clock))
    b_sigs, a_errors = [], 0
    try:
        for a_req, b_req in zip(a_reqs, b_reqs):
            try:
                svc.solve_for("a", snap(a_req))
            except faults.InjectedFault:
                a_errors += 1
            b_sigs.append(decision_signature(svc.solve_for("b", snap(b_req))))
    finally:
        faults.uninstall()
    return svc, inj, b_sigs, a_errors


def test_bystander_byte_identical_under_neighbor_chaos():
    """The seeded witness: tenant a's plan fires and rides a down its own
    ladder; tenant b's decisions equal its fault-free solo run's (and the
    JAX package's), its rung, quarantines and fallbacks untouched."""
    from karpenter_tpu.solver.driver import SolverConfig as JaxConfig
    from karpenter_tpu.solver.service import TenantService as JaxService

    a_reqs, b_reqs = _requests()
    baseline_svc = TenantService(config=SolverConfig(device="cpu", relax=False))
    baseline = [decision_signature(baseline_svc.solve_for("b", snap(r))) for r in b_reqs]
    jax_svc = JaxService(config=JaxConfig(relax=False))
    from karpenter_tpu.solver import wire as jax_wire

    jax_baseline = [
        decision_signature(jax_svc.solve_for("b", jax_wire.decode_solve_request(r)))
        for r in b_reqs
    ]
    assert baseline == jax_baseline

    svc, inj, b_sigs, a_errors = _run_chaos(TestClock(), a_reqs, b_reqs)
    fired = {s for s, _, _ in inj.log}
    assert {faults.SOLVER_OUTPUT, faults.SOLVER_DISPATCH, faults.TENANT_SOLVE} <= fired
    a = svc.registry.get("a")
    assert a.health.quarantines >= 1 and a.health.level() > 0
    assert a_errors >= 1
    assert b_sigs == baseline
    b = svc.registry.get("b")
    assert b.health.RUNGS[b.health.level()] == "batched"
    assert b.health.quarantines == 0 and b.health.delta_fallbacks == 0
    assert b.stats()["fallback_solves"] == 0 and b.stats()["rejected"] == 0


def test_victim_recovers_after_faults_clear():
    a_reqs, b_reqs = _requests()
    clock = TestClock()
    svc, inj, _, _ = _run_chaos(clock, a_reqs, b_reqs)
    a = svc.registry.get("a")
    assert a.health.level() > 0
    inj.clear()
    clock.step(130.0)  # past the breaker's 120 s cool-down
    assert svc.solve_for("a", snap(make_request(3, "a-recover"))).all_pods_scheduled()
    assert a.health.level() == 0


def test_fault_log_replay_deterministic():
    a_reqs, b_reqs = _requests()
    _, inj1, sigs1, errs1 = _run_chaos(TestClock(), a_reqs, b_reqs)
    _, inj2, sigs2, errs2 = _run_chaos(TestClock(), a_reqs, b_reqs)
    assert inj1.log and inj1.log == inj2.log
    assert (sigs1, errs1) == (sigs2, errs2)


# -- the cross-tenant batch lane ----------------------------------------------

TENANTS = ("t1", "t2", "t3", "t4")


def _tenant_requests(port=True):
    from karpenter_tpu.solver import workloads as jax_wl

    out = {}
    for i, tid in enumerate(TENANTS, start=1):
        pods = jax_wl.mixed_pods(12, seed=i)
        for j, p in enumerate(pods):
            p.metadata.name = f"{tid}-mixed-{j}"
            p.metadata.uid = f"uid-{tid}-mixed-{j}"
        out[tid] = make_request(0, tid, pods=pods, port=port)
    return out


def _solve_at_once(svc, requests, decode=snap):
    """Every tenant's solve from its own thread at once; each tenant's
    Results or the exception it raised."""
    out = {}

    def run(tid, req):
        try:
            out[tid] = svc.solve_for(tid, decode(req))
        except Exception as exc:
            out[tid] = exc

    threads = [threading.Thread(target=run, args=item) for item in requests.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return out


def _batching_service(window=2.0):
    return TenantService(registry=TenantRegistry(clock=TestClock()), config=CPU,
                         batch_window=window, batch_max=len(TENANTS))


def test_four_tenant_batch_equals_solo_and_jax_union():
    from karpenter_tpu.solver import wire as jax_wire
    from karpenter_tpu.solver.service import TenantService as JaxService
    from karpenter_tpu.solver.tenancy import TenantRegistry as JaxRegistry

    requests = _tenant_requests()
    svc = _batching_service()
    got = _solve_at_once(svc, requests)
    assert svc.batcher.counts() == {"batched": 1, "declined": 0}
    jax_svc = JaxService(registry=JaxRegistry(), batch_window=2.0, batch_max=len(TENANTS))
    jax_got = _solve_at_once(jax_svc, _tenant_requests(port=False),
                             decode=jax_wire.decode_solve_request)
    assert jax_svc.batcher.counts() == {"batched": 1, "declined": 0}
    solo = TenantService(config=CPU)
    for tid, req in requests.items():
        sig = decision_signature(got[tid])
        assert sig[0], "each tenant opens claims"
        assert sig == decision_signature(solo.solve_for(tid, snap(req)))
        assert sig == decision_signature(jax_got[tid])


def _launch_error(*args, **kwargs):
    raise KernelLaunchError("pack: CUDA error 700 at launch (not injected)")


def test_launch_error_in_the_union_reaches_every_participant(monkeypatch):
    from karpenter_tpu_torch.ops import solve as solve_mod

    solo = []
    real_solo = TenantService._solve_solo
    monkeypatch.setattr(TenantService, "_solve_solo",
                        lambda self, t, s: solo.append(t.tenant_id) or real_solo(self, t, s))
    monkeypatch.setattr(solve_mod, "dispatch_scenarios_packed", _launch_error)
    svc = _batching_service()
    got = _solve_at_once(svc, _tenant_requests())
    assert sorted(got) == list(TENANTS)
    assert all(isinstance(r, KernelLaunchError) for r in got.values()), got
    assert len({id(r) for r in got.values()}) == 1  # the one fault of the union
    assert solo == []
    assert svc.batcher.counts() == {"batched": 0, "declined": 0}
    for tid in TENANTS:
        assert svc.registry.get(tid).stats()["inflight"] == 0


def test_injected_batch_fault_declines_to_solo_solves():
    """A fault injected in the batch lane (scoped to ``__batch__``) is no
    fault of the card: the batch declines and every participant gets its
    solo answer."""
    requests = _tenant_requests()
    inj = faults.install(faults.FaultInjector([faults.FaultRule(
        faults.SOLVER_SCENARIOS, match=lambda ctx: ctx.get("tenant") == "__batch__")]))
    svc = _batching_service()
    got = _solve_at_once(svc, requests)
    faults.uninstall()
    assert inj.fired(faults.SOLVER_SCENARIOS) >= 1
    assert svc.batcher.counts() == {"batched": 0, "declined": 1}
    solo = TenantService(config=CPU)
    for tid, req in requests.items():
        assert decision_signature(got[tid]) == decision_signature(solo.solve_for(tid, snap(req)))


@pytest.mark.parametrize("exc,card", [
    (KernelLaunchError("launch"), True),
    (KernelBuildError("nvcc"), True),
    (RuntimeError("plain"), False),
    (ValueError("shape"), False),
])
def test_is_card_fault(exc, card):
    assert is_card_fault(exc) is card
    exc.card_fault = True
    assert is_card_fault(exc)


def test_batcher_hands_a_card_fault_to_followers_and_declines_the_rest():
    """The batcher alone: a card fault of ``grouped`` is raised by the
    leader and every follower; any other failure declines to ``solo``."""
    for raised, want in ((KernelLaunchError("boom"), "fault"), (ValueError("no"), "solo")):
        batcher = CrossTenantBatcher(window=2.0, max_batch=3)
        out = {}

        def grouped(items):
            raise raised

        def run(i):
            try:
                out[i] = batcher.solve("k", i, solo=lambda: "solo", grouped=grouped)
            except Exception as exc:
                out[i] = "fault" if exc is raised else exc

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert out == {0: want, 1: want, 2: want}
        assert batcher.counts() == (
            {"batched": 0, "declined": 0} if want == "fault" else {"batched": 0, "declined": 1})


def test_admission_error_before_any_work():
    svc = TenantService(registry=TenantRegistry(
        clock=TestClock(), qos={"standard": TenantQoS(rate=0.0, burst=1.0)}), config=CPU)
    assert svc.solve_for("a", snap(make_request(2, "a0"))).all_pods_scheduled()
    with pytest.raises(AdmissionError) as exc_info:
        svc.solve_for("a", snap(make_request(2, "a1")))
    assert exc_info.value.reason == "rate-limited"


# -- several tenants at once ----------------------------------------------------


def test_launch_counts_lose_no_update_under_threads():
    """The sidecar's worker threads launch kernels at once: the launch
    counters (a read-modify-write each) must count every launch, with the
    interpreter switching threads as often as it can."""
    import sys

    from karpenter_tpu_torch import _build

    threads_n, per_thread = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launches()
        barrier = threading.Barrier(threads_n)

        def run():
            barrier.wait()
            for _ in range(per_thread):
                _build.launched("pack", 0, scenarios=2, variants=("pack_domains",))

        threads = [threading.Thread(target=run) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        want = threads_n * per_thread
        assert (_build.launches["pack"], _build.launches["pack_domains"],
                _build.scenario_launches["pack"]) == (want, want, want)
    finally:
        sys.setswitchinterval(switch)
        _build.reset_launches()


def test_concurrent_tenants_get_their_serial_answers():
    """Four tenants solving solo from four threads at once, each on its own
    warm state, decide as the same solves one after another."""
    requests = _tenant_requests()
    serial = TenantService(config=CPU)
    want = {tid: decision_signature(serial.solve_for(tid, snap(req)))
            for tid, req in requests.items()}
    for _ in range(2):
        got = _solve_at_once(TenantService(config=CPU), requests)
        assert {tid: decision_signature(r) for tid, r in got.items()} == want
