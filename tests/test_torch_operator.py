"""The port's control plane (karpenter_tpu_torch/operator.py, options.py,
controllers/provisioning.py and the copied controllers) on the CPU,
against the JAX package's.

The port's ``Operator`` over the kwok provider (``SolverConfig(device=
"cpu")``) creates the NodeClaims the JAX package's creates for the same
pending pods, compared by content: pool, instance-type options in order
and pod uids (claim names are minted by each run); with
``solver_address`` at the port's sidecar it creates the same. The flag
set parses as the JAX package's but for ``--solver-backend``'s values,
and ``--solver-mesh`` raises naming ROADMAP item A13. Consolidation's
``ScenarioSimulator`` builds no solver for a backend other than the
kernels.
"""

import copy
import dataclasses
import importlib
import os

import pytest

from karpenter_tpu.solver import workloads as jax_wl
from karpenter_tpu_torch.solver.driver import SolverConfig

from helpers import make_nodepool
from test_torch_residency import to_port

N_TYPES = 120
MAX_STEPS = 5


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def run_operator(pkg, pods, monkeypatch, n_types=N_TYPES, **options):
    """``pkg``'s Operator over kwok with one NodePool and ``pods`` pending,
    stepped (binding what landed) until no pod is pending or MAX_STEPS
    steps have run. Returns each created claim's (pool, instance-type
    options in order, pod uids), the steps, and the pods left pending."""
    kube = _mod(pkg, "kube")
    prov = _mod(pkg, "controllers.provisioning")
    operator = _mod(pkg, "operator")
    clock = kube.TestClock()
    client = kube.Client(clock)
    provider = _mod(pkg, "cloudprovider.kwok").KwokCloudProvider(
        client, _mod(pkg, "cloudprovider.corpus").generate(n_types))
    created = []
    real = prov.Provisioner.create_node_claims

    def spy(self, results):
        claims = real(self, results)
        created.extend(
            (c.template.node_pool_name, tuple(it.name for it in c.instance_type_options),
             tuple(sorted(p.uid for p in c.pods)))
            for c in results.new_node_claims)
        return claims

    monkeypatch.setattr(prov.Provisioner, "create_node_claims", spy)
    op = operator.Operator(client, provider, operator.OperatorOptions(**options))
    binder = _mod(pkg, "sim").Binder(client)
    pool = make_nodepool(name="default")
    client.create(pool if pkg == "karpenter_tpu" else to_port(pool))
    for p in pods:
        client.create(p)
    pod_cls = _mod(pkg, "api.objects").Pod
    for step in range(1, MAX_STEPS + 1):
        op.step(force_provision=True)
        binder.bind_all()
        clock.step(1)
        pending = [p.uid for p in client.list(pod_cls) if not p.spec.node_name]
        if not pending:
            break
    op.shutdown()
    return created, step, sorted(pending)


@pytest.fixture(scope="module")
def pods():
    return jax_wl.mixed_pods(150, seed=2)


@pytest.fixture(scope="module")
def jax_run(pods):
    mp = pytest.MonkeyPatch()
    try:
        return run_operator("karpenter_tpu", copy.deepcopy(pods), mp)
    finally:
        mp.undo()


def test_operator_claims_equal_jax(pods, jax_run, monkeypatch):
    got = run_operator("karpenter_tpu_torch", to_port(copy.deepcopy(pods)), monkeypatch,
                       solver_config=SolverConfig(device="cpu"))
    assert jax_run[0], "the run creates claims"
    assert got == jax_run


def test_operator_through_the_sidecar_equals_in_process(pods, jax_run, monkeypatch):
    from karpenter_tpu_torch.solver.service import RemoteSolver, serve

    calls = []
    real = RemoteSolver.solve
    monkeypatch.setattr(RemoteSolver, "solve",
                        lambda self, p: calls.append(len(p)) or real(self, p))
    server = serve("127.0.0.1:0", config=SolverConfig(device="cpu"))
    try:
        got = run_operator("karpenter_tpu_torch", to_port(copy.deepcopy(pods)), monkeypatch,
                           solver_config=SolverConfig(device="cpu"),
                           solver_address=f"127.0.0.1:{server._bound_port}")
    finally:
        server.stop(0)
    assert calls and calls[0] == len(pods)
    assert got == jax_run


# -- options -------------------------------------------------------------------

ARGVS = [
    [],
    ["--metrics-port", "9090", "--health-probe-port", "9091", "--log-level", "debug"],
    ["--batch-max-duration", "1m30s", "--batch-idle-duration", "500ms"],
    ["--feature-gates", "NodeRepair=true,SpotToSpotConsolidation=true"],
    ["--disable-leader-election", "true", "--leader-election-namespace", "karpenter"],
    ["--solver-address", "solver:50099", "--enable-tracing", "true", "--trace-seed", "7",
     "--trace-path", "/tmp/t.json", "--metrics-dump-path", "/tmp/m.prom"],
    ["--enable-profiling", "true", "--instance-types-file-path", "types.json",
     "--kube-client-qps", "50", "--memory-limit", "1024"],
    ["--solver-backend", "native"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_parse_options_as_jax(argv):
    from karpenter_tpu.options import parse_options as jax_parse
    from karpenter_tpu_torch.options import parse_options

    got = dataclasses.asdict(parse_options(argv))
    want = dataclasses.asdict(jax_parse(argv))
    # the one difference: the port's backend names ("kernels" for "tpu")
    assert got.pop("solver_backend") == {"tpu": "kernels"}.get(
        want["solver_backend"], want["solver_backend"])
    want.pop("solver_backend")
    assert got == want


def test_environment_fallback(monkeypatch):
    from karpenter_tpu_torch.options import parse_options

    monkeypatch.setenv("KARPENTER_SOLVER_ADDRESS", "solver:50099")
    monkeypatch.setenv("SOLVER_BACKEND", "native")
    opts = parse_options([])
    assert (opts.solver_address, opts.solver_backend) == ("solver:50099", "native")


@pytest.mark.parametrize("argv,error", [
    (["--solver-backend", "tpu"], ValueError),
    (["--solver-backend", "cuda"], ValueError),
    (["--solver-mesh", "everywhere"], ValueError),
])
def test_invalid_solver_flags(argv, error):
    from karpenter_tpu_torch.options import parse_options

    with pytest.raises(error):
        parse_options(argv)


def test_solver_mesh_raises_naming_a13(monkeypatch):
    """--solver-mesh auto no longer raises: A13 is ported. The flag parses
    and the operator's SolverConfig carries "auto" on the kernels backend
    (which resolves to one device on a host with fewer than two cards;
    tests/test_torch_mesh.py). Building the config needs CUDA, patched in
    here."""
    import torch

    from karpenter_tpu_torch.operator import OperatorOptions
    from karpenter_tpu_torch.options import parse_options

    opts = parse_options(["--solver-mesh", "auto"])
    assert opts.solver_mesh == "auto"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = OperatorOptions.from_options(opts).solver_config
    assert cfg.mesh == "auto" and cfg.backend == "kernels" and cfg.device == "cuda"


def test_from_options_maps_the_backend():
    from karpenter_tpu_torch.operator import OperatorOptions
    from karpenter_tpu_torch.options import parse_options

    assert OperatorOptions.from_options(parse_options([])).solver_config is None
    native = OperatorOptions.from_options(parse_options(["--solver-backend", "native"]))
    assert native.solver_config.backend == "native"


def test_binary_runs_on_the_card():
    """``python -m karpenter_tpu_torch`` builds the operator on the card:
    where CUDA is not available it raises, with no fallback."""
    import torch

    from karpenter_tpu_torch.__main__ import build_operator
    from karpenter_tpu_torch.options import parse_options

    if torch.cuda.is_available():
        op = build_operator(parse_options(["--disable-leader-election", "true"]))
        assert op.options.solver_config.device == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_operator(parse_options([]))


def test_sidecar_binary_runs_on_the_card():
    import torch

    from karpenter_tpu_torch.solver import service

    if torch.cuda.is_available():
        # main() would serve until signalled; its config is the default's
        assert SolverConfig().device == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        service.main(["--listen", "127.0.0.1:0"])


def test_profiling_writes_a_torch_trace(tmp_path, monkeypatch):
    from karpenter_tpu_torch.operator import profile_path

    trace = str(tmp_path / "run")
    run_operator("karpenter_tpu_torch", to_port(jax_wl.mixed_pods(20, seed=4)), monkeypatch,
                 n_types=8, solver_config=SolverConfig(device="cpu"),
                 enable_profiling=True, trace_path=trace)
    assert profile_path(trace) == trace + ".torch.json"
    assert os.path.getsize(profile_path(trace)) > 0
    assert profile_path("") == "torch_profile.json"


# -- consolidation's simulator --------------------------------------------------


@pytest.mark.parametrize("backend,builds", [("native", False), ("kernels", True)])
def test_scenario_simulator_declines_other_backends(backend, builds, monkeypatch):
    """As the JAX package does for its own backend: the native backend
    cannot batch scenarios, so the simulator builds no Topology and no
    TorchSolver only for solve_scenarios to decline."""
    from karpenter_tpu_torch.controllers.disruption import helpers
    from karpenter_tpu_torch.solver import workloads

    ctx, _method, candidates, _budgets = workloads.build_consolidation_env(20, device="cpu")
    built = []
    real = helpers.TorchSolver.__init__

    def spy(self, *a, **k):
        built.append(1)
        real(self, *a, **k)

    monkeypatch.setattr(helpers.TorchSolver, "__init__", spy)
    sim = helpers.ScenarioSimulator(
        ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
        solver_config=SolverConfig(device="cpu", backend=backend))
    assert sim.available is builds
    assert bool(built) is builds
