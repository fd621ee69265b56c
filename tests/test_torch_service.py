"""The port's solver sidecar (karpenter_tpu_torch/solver/service.py) on the
CPU, against the JAX package's.

The port's sidecar (``serve`` with ``SolverConfig(device="cpu")``) answers
a request with the bytes the JAX package's sidecar answers; the JAX
package's ``RemoteSolver`` against the port's sidecar gets the JAX
package's in-process Results; and the error contract holds over the hop:
admission backpressure raises ``SolverBackpressure`` with no in-process
solve, a deadline overrun falls back in process, and a fault of the card
(a ``KernelLaunchError``, in the solo lane or the cross-tenant batch
lane) reaches every caller as INTERNAL and is never solved again. A
request just over gRPC's 4 MiB receive limit meets the same outcome
under both packages.
"""

import threading

import grpc
import pytest

from karpenter_tpu.cloudprovider import corpus as jax_corpus
from karpenter_tpu.solver import wire as jax_wire
from karpenter_tpu.solver import workloads as jax_wl
from karpenter_tpu_torch import faults
from karpenter_tpu_torch._build import KernelLaunchError
from karpenter_tpu_torch.cloudprovider import corpus as port_corpus
from karpenter_tpu_torch.kube import TestClock
from karpenter_tpu_torch.solver.driver import SolverConfig
from karpenter_tpu_torch.solver.service import (
    SOLVE_METHOD,
    RemoteSolver,
    SolverBackpressure,
    TenantService,
    serve,
)
from karpenter_tpu_torch.solver.tenancy import TenantQoS, TenantRegistry

from helpers import decision_signature, make_nodepool
from test_torch_residency import to_port
from test_torch_wire import _both

GRPC_RECEIVE_LIMIT = 4 * 1024 * 1024
CPU = SolverConfig(device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    faults.uninstall()
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def port_sidecar():
    server = serve("127.0.0.1:0", config=CPU)
    yield f"127.0.0.1:{server._bound_port}"
    server.stop(0)


@pytest.fixture(scope="module")
def jax_sidecar():
    from karpenter_tpu.solver.service import serve as jax_serve

    server = jax_serve("127.0.0.1:0")
    yield f"127.0.0.1:{server._bound_port}"
    server.stop(0)


def _call(target, request, tenant=None):
    channel = grpc.insecure_channel(target)
    try:
        md = (("ktpu-tenant-id", tenant),) if tenant else None
        return channel.unary_unary(SOLVE_METHOD)(request, timeout=120.0, metadata=md)
    finally:
        channel.close()


def _catalog(n=8):
    pools = [make_nodepool(name="default")]
    return to_port(pools), {"default": port_corpus.generate(n)}


def _port_pods(n, prefix, seed=0):
    pods = to_port(jax_wl.mixed_pods(n, seed=seed))
    for i, p in enumerate(pods):
        p.metadata.name = f"{prefix}-mixed-{i}"
        p.metadata.uid = f"uid-{prefix}-mixed-{i}"
    return pods


@pytest.mark.parametrize("case", ["mixed", "constrained", "state_nodes"])
def test_sidecar_answers_the_jax_sidecars_bytes(case, port_sidecar, jax_sidecar):
    request, _ = _both(case)
    got = _call(port_sidecar, request, tenant="t0")
    assert got == _call(jax_sidecar, request, tenant="t0")


def test_jax_remote_solver_against_the_port_sidecar(port_sidecar):
    """JAX's client over the port's sidecar gets JAX's in-process answer,
    reassembled against the caller's own objects."""
    from karpenter_tpu.solver.service import RemoteSolver as JaxRemote
    from karpenter_tpu.solver.service import build_solver

    pods = jax_wl.mixed_pods(200, seed=5)
    pools = [make_nodepool(name="default")]
    types = {"default": jax_corpus.generate(40)}
    remote = JaxRemote(port_sidecar, pools, types, tenant="jax-client")
    try:
        got = remote.solve(pods)
    finally:
        remote.close()
    want = build_solver(pods, pools, types, (), (), (), False).solve(pods)
    assert remote.fallback_solves == 0
    assert got.new_node_claims
    assert decision_signature(got) == decision_signature(want)
    by_uid = {p.uid: p for p in pods}
    for claim in got.new_node_claims:
        assert all(by_uid[p.uid] is p for p in claim.pods)


def test_remote_solver_reads_solve_deadline(port_sidecar):
    pools, types = _catalog()
    remote = RemoteSolver(port_sidecar, pools, types,
                          config=SolverConfig(device="cpu", solve_deadline=7.5))
    assert remote.timeout == 7.5
    remote.close()
    assert SolverConfig(device="cpu").solve_deadline == 30.0


def test_backpressure_raises_and_never_solves_in_process():
    server = serve("127.0.0.1:0", config=CPU, registry=TenantRegistry(
        clock=TestClock(), qos={"standard": TenantQoS(rate=0.0, burst=1.0)}))
    target = f"127.0.0.1:{server._bound_port}"
    pools, types = _catalog()
    try:
        greedy = RemoteSolver(target, pools, types, config=CPU, tenant="greedy")
        assert greedy.solve(_port_pods(3, "g0")).all_pods_scheduled()
        with pytest.raises(SolverBackpressure) as exc_info:
            greedy.solve(_port_pods(3, "g1"))  # the bucket is empty, rate 0
        assert exc_info.value.tenant == "greedy"
        assert greedy.fallback_solves == 0
        other = RemoteSolver(target, pools, types, config=CPU, tenant="other")
        assert other.solve(_port_pods(3, "o0")).all_pods_scheduled()
        assert other.fallback_solves == 0
        greedy.close()
        other.close()
    finally:
        server.stop(0)


def test_deadline_overrun_falls_back_in_process():
    """A solve past its tenant's deadline is DEADLINE_EXCEEDED; the client
    retries once, then solves in process with its own config (here the
    CPU), to the sidecar's answer."""
    clock = TestClock()
    faults.install(faults.FaultInjector(
        [faults.FaultRule(faults.TENANT_SOLVE, latency=10.0,
                          match=lambda ctx: ctx.get("tenant") == "slow")],
        clock=clock,
    ))
    server = serve("127.0.0.1:0", config=CPU, registry=TenantRegistry(
        clock=clock, qos={"standard": TenantQoS(solve_deadline=1.0)}))
    target = f"127.0.0.1:{server._bound_port}"
    pools, types = _catalog()
    pods = _port_pods(6, "slow")
    try:
        slow = RemoteSolver(target, pools, types, config=CPU, tenant="slow")
        got = slow.solve(pods)
        assert slow.fallback_solves == 1
        fast = RemoteSolver(target, pools, types, config=CPU, tenant="fast")
        want = fast.solve(pods)
        assert fast.fallback_solves == 0
        assert decision_signature(got) == decision_signature(want)
        assert server._tenant_service.registry.get("slow").stats()["deadline_overruns"] == 2
        slow.close()
        fast.close()
    finally:
        server.stop(0)


def _launch_error(*args, **kwargs):
    raise KernelLaunchError("pack: CUDA error 700 at launch (not injected)")


def test_card_fault_in_the_solo_lane_is_internal(monkeypatch):
    """A launch error passes the tenant's ladder (TorchSolver._card_fault)
    and the hop maps it to INTERNAL, which the client raises: no retry,
    no in-process solve, the tenant's ladder untouched."""
    from karpenter_tpu_torch.ops import solve as solve_mod

    monkeypatch.setattr(solve_mod, "dispatch_packed", _launch_error)
    server = serve("127.0.0.1:0", config=SolverConfig(device="cpu", relax=False))
    target = f"127.0.0.1:{server._bound_port}"
    pools, types = _catalog()
    try:
        remote = RemoteSolver(target, pools, types, config=CPU, tenant="t0")
        with pytest.raises(grpc.RpcError) as exc_info:
            remote.solve(_port_pods(4, "t0"))
        assert exc_info.value.code() == grpc.StatusCode.INTERNAL
        assert "KernelLaunchError" in exc_info.value.details()
        assert remote.fallback_solves == 0
        health = server._tenant_service.registry.get("t0").health
        assert health.level() == 0 and health.quarantines == 0
        remote.close()
    finally:
        server.stop(0)


def _four_tenants(target, pools, types, n=6):
    """Four tenants' solves sent at once; each tenant's outcome (Results,
    or the exception it raised)."""
    out = {}

    def run(i):
        tid = f"t{i}"
        remote = RemoteSolver(target, pools, types, config=CPU, tenant=tid)
        try:
            out[tid] = remote.solve(_port_pods(n, tid, seed=i))
        except Exception as exc:
            out[tid] = exc
        finally:
            remote.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(1, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return out


def _batching_sidecar(config=CPU):
    server = serve("127.0.0.1:0", config=config, max_workers=4, batch_window=2.0)
    server._tenant_service.batcher.max_batch = 4
    return server


def test_card_fault_in_the_batch_lane_reaches_every_caller(monkeypatch):
    """A launch error in the union solve is no decline: all four callers
    get INTERNAL, and no participant is solved solo."""
    from karpenter_tpu_torch.ops import solve as solve_mod

    solo = []
    real_solo = TenantService._solve_solo
    monkeypatch.setattr(TenantService, "_solve_solo",
                        lambda self, t, s: solo.append(t.tenant_id) or real_solo(self, t, s))
    monkeypatch.setattr(solve_mod, "dispatch_scenarios_packed", _launch_error)
    server = _batching_sidecar()
    pools, types = _catalog()
    try:
        out = _four_tenants(f"127.0.0.1:{server._bound_port}", pools, types)
        counts = server._tenant_service.batcher.counts()
    finally:
        server.stop(0)
    assert sorted(out) == ["t1", "t2", "t3", "t4"]
    for tid, got in out.items():
        assert isinstance(got, grpc.RpcError), (tid, got)
        assert got.code() == grpc.StatusCode.INTERNAL
        assert "KernelLaunchError" in got.details()
    assert solo == []
    assert counts == {"batched": 0, "declined": 0}


def test_batch_lane_answers_each_tenants_solo_solve():
    """Over the hop, four tenants batched into one union solve each get
    the answer of their own solo solve."""
    server = _batching_sidecar()
    pools, types = _catalog()
    try:
        out = _four_tenants(f"127.0.0.1:{server._bound_port}", pools, types)
        counts = server._tenant_service.batcher.counts()
    finally:
        server.stop(0)
    assert counts == {"batched": 1, "declined": 0}
    for i in range(1, 5):
        tid = f"t{i}"
        want = TenantService(config=CPU).solve_for(tid, _snap(_port_pods(6, tid, seed=i)))
        assert decision_signature(out[tid]) == decision_signature(want)


def _snap(pods):
    from karpenter_tpu_torch.solver import wire

    pools, types = _catalog()
    return wire.decode_solve_request(wire.encode_solve_request(
        pods, pools, types, solver_options={"reserved_capacity_enabled": False}))


def _oversized_request():
    """A request just over 4 MiB: 400 instance types and enough pods."""
    pods = jax_wl.mixed_pods(4200)
    pools = [make_nodepool(name="default")]
    request = jax_wire.encode_solve_request(
        pods, pools, {"default": jax_corpus.generate(400)},
        solver_options={"reserved_capacity_enabled": False})
    assert GRPC_RECEIVE_LIMIT < len(request) < GRPC_RECEIVE_LIMIT + 256 * 1024
    return request


def test_request_over_the_receive_limit_same_under_both(port_sidecar, jax_sidecar):
    """Both sidecars refuse a request past gRPC's default receive limit
    before any solve, with the same status."""
    request = _oversized_request()
    codes = []
    for target in (port_sidecar, jax_sidecar):
        with pytest.raises(grpc.RpcError) as exc_info:
            _call(target, request, tenant="big")
        codes.append(exc_info.value.code())
    assert codes == [grpc.StatusCode.RESOURCE_EXHAUSTED] * 2


def test_remote_solver_over_the_receive_limit_same_under_both(port_sidecar, jax_sidecar):
    """Each package's RemoteSolver reads the refusal as backpressure: one
    retry, then SolverBackpressure, and no in-process solve."""
    from karpenter_tpu.solver.service import RemoteSolver as JaxRemote
    from karpenter_tpu.solver.service import SolverBackpressure as JaxBackpressure

    pods = jax_wl.mixed_pods(4200)
    pools = [make_nodepool(name="default")]
    outcomes = []
    for remote_cls, backpressure, target, objs in (
        (JaxRemote, JaxBackpressure, jax_sidecar,
         (pods, pools, {"default": jax_corpus.generate(400)})),
        (RemoteSolver, SolverBackpressure, port_sidecar,
         (to_port(pods), to_port(pools), {"default": port_corpus.generate(400)})),
    ):
        kw = {} if remote_cls is JaxRemote else {"config": CPU}
        remote = remote_cls(target, objs[1], objs[2], tenant="big", **kw)
        with pytest.raises(backpressure):
            remote.solve(objs[0])
        outcomes.append(remote.fallback_solves)
        remote.close()
    assert outcomes == [0, 0]
