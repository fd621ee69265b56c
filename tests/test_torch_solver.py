"""Port parity: TorchSolver(device="cpu") vs TpuSolver, end to end.

Both packages build the same pods, pools and nodes from their own object
models, and both solve; decisions are compared by pod NAME (the two
packages mint pod uids from separate counters, api/objects.py:23):
claims (pool, pods, instance-type options, requirements), existing-node
placements and pod errors must be identical. Also pinned here: the port's
encoder is byte-identical to the JAX one, and the options this slice does
not port raise NotImplementedError.
"""

import importlib

import numpy as np
import pytest
import torch

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _state_nodes(pkg, count):
    """Mirror of karpenter_tpu_torch/solver/example.py:example_state_nodes
    for either package's object model."""
    if pkg == "karpenter_tpu_torch":
        return _mod(pkg, "solver.example").example_state_nodes(count)
    labels = _mod(pkg, "api.labels")
    res = _mod(pkg, "api.resources")
    objs = _mod(pkg, "api.objects")
    corpus = _mod(pkg, "cloudprovider.corpus")
    StateNode = _mod(pkg, "controllers.state").StateNode
    out = []
    for i in range(count):
        name = f"node-{i}"
        node = objs.Node(metadata=objs.ObjectMeta(name=name, labels={
            labels.TOPOLOGY_ZONE: corpus.DEFAULT_ZONES[i % len(corpus.DEFAULT_ZONES)],
            labels.HOSTNAME: name,
        }))
        node.status.capacity = {
            res.CPU: 16 * res.MILLI,
            res.MEMORY: 64 * 2**30 * res.MILLI,
            res.PODS: 110 * res.MILLI,
        }
        node.status.allocatable = dict(node.status.capacity)
        node.status.ready = True
        sn = StateNode(node=node)
        if i % 2:
            pod = objs.Pod(
                metadata=objs.ObjectMeta(name=f"bound-{i}"),
                spec=objs.PodSpec(requests={
                    res.CPU: 8 * res.MILLI,
                    res.MEMORY: 32 * 2**30 * res.MILLI,
                }, node_name=name),
            )
            pod.status.phase = "Running"
            sn.update_pod(pod, is_daemon=False)
        out.append(sn)
    return out


def _build(pkg, workload, n_pods, n_types, pools="default", n_nodes=0):
    corpus = _mod(pkg, "cloudprovider.corpus")
    kube = _mod(pkg, "kube")
    topo = _mod(pkg, "scheduling.topology")
    wl = _mod(pkg, "solver.workloads")
    ex = _mod(pkg, "solver.example")
    drv = _mod(pkg, "solver.driver")
    pods = getattr(wl, workload)(n_pods)
    if pools == "spot":
        node_pools = wl.spot_od_pools()
    elif pools == "minvalues":
        # a pool with a minValues floor (MV > 0): outside the ported scope
        objs = _mod(pkg, "api.objects")
        node_pools = [objs.NodePool(
            metadata=objs.ObjectMeta(name="default"),
            spec=objs.NodePoolSpec(template=objs.NodeClaimTemplate(spec=objs.NodeClaimSpec(
                requirements=[objs.NodeSelectorRequirement(
                    corpus.INSTANCE_FAMILY_LABEL, "Exists", (), min_values=2)]))),
        )]
    else:
        node_pools = [ex.example_nodepool()]
    its = corpus.generate(n_types)
    its_by_pool = {p.name: list(its) for p in node_pools}
    nodes = _state_nodes(pkg, n_nodes)
    t = topo.Topology(kube.Client(kube.TestClock()), nodes, node_pools, its_by_pool, pods)
    if pkg == "karpenter_tpu":
        solver = drv.TpuSolver(node_pools, its_by_pool, t, state_nodes=nodes)
    else:
        solver = drv.TorchSolver(node_pools, its_by_pool, t, state_nodes=nodes,
                                 config=drv.SolverConfig(device="cpu"))
    return solver, pods


def decisions(results, pods):
    name = {p.uid: p.metadata.name for p in pods}
    claims = sorted(
        (
            c.template.node_pool_name,
            tuple(sorted(p.metadata.name for p in c.pods)),
            tuple(it.name for it in c.instance_type_options),
            repr(sorted(map(repr, c.requirements))),
        )
        for c in results.new_node_claims
    )
    existing = sorted(
        (en.name, tuple(sorted(p.metadata.name for p in en.pods)))
        for en in results.existing_nodes
    )
    errors = sorted(name[u] for u in results.pod_errors)
    return claims, existing, errors


def _solve_both(*build_args, **build_kw):
    out = []
    for pkg in PKGS:
        solver, pods = _build(pkg, *build_args, **build_kw)
        out.append(decisions(solver.solve(pods), pods))
    return out


class TestDecisionParity:
    def test_example_solver(self):
        from karpenter_tpu.solver.example import example_solver as jax_example
        from karpenter_tpu_torch.solver.driver import SolverConfig
        from karpenter_tpu_torch.solver.example import example_solver

        js, jp = jax_example(300, 30, 6)
        ts, tp = example_solver(300, 30, 6, config=SolverConfig(device="cpu"))
        jd, td = decisions(js.solve(jp), jp), decisions(ts.solve(tp), tp)
        assert td == jd
        assert jd[0] and not jd[2]

    def test_mixed_2000x60(self):
        jd, td = _solve_both("mixed_pods", 2000, 60)
        assert td == jd
        assert len(jd[0]) > 50 and not jd[2]

    def test_mixed_over_state_nodes(self):
        jd, td = _solve_both("mixed_pods", 600, 40, n_nodes=8)
        assert td == jd
        assert any(pods for _, pods in jd[1])  # existing nodes took pods

    def test_spot_od_pools(self):
        jd, td = _solve_both("mixed_pods", 800, 40, pools="spot")
        assert td == jd
        assert {c[0] for c in jd[0]} <= {"spot", "on-demand"}

    def test_domain_batch_raises(self):
        """constrained_mix carries zonal spread (has_domains): ported, its
        decisions equal TpuSolver's. Over a minValues pool the same batch
        still raises before anything runs, naming ROADMAP item A4b."""
        jd, td = _solve_both("constrained_mix", 200, 20)
        assert td == jd
        assert jd[0] and not jd[2]
        solver, pods = _build("karpenter_tpu_torch", "constrained_mix", 200, 20,
                              pools="minvalues")
        with pytest.raises(NotImplementedError, match="minValues.*A4b"):
            solver.solve(pods)


class TestEncodeParity:
    @pytest.mark.parametrize("n_nodes", [0, 5])
    def test_solve_args_byte_identical(self, n_nodes):
        arrays = []
        for pkg in PKGS:
            enc = _mod(pkg, "solver.encode")
            solver, pods = _build(pkg, "mixed_pods", 500, 40, n_nodes=n_nodes)
            groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
            assert not rest
            snap, avail, *_ = solver._encode_batch(groups)
            arrays.append(snap.solve_args(*avail))
        names = _mod("karpenter_tpu_torch", "solver.encode").SOLVE_ARG_NAMES
        assert names == _mod("karpenter_tpu", "solver.encode").SOLVE_ARG_NAMES
        for name, j, t in zip(names, *arrays):
            j, t = np.asarray(j), np.asarray(t)
            assert (j.dtype, j.shape) == (t.dtype, t.shape), name
            assert j.tobytes() == t.tobytes(), name


class TestConfig:
    def test_default_device_is_cuda_and_refused_without_it(self):
        from karpenter_tpu_torch.solver.driver import SolverConfig

        assert SolverConfig.__dataclass_fields__["device"].default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                SolverConfig()

    @pytest.mark.parametrize("kw,item", [
        ({"mesh": "auto"}, "A13"), ({"classed": True}, "A8"), ({"relax": True}, "A9"),
    ])
    def test_unported_options_raise(self, kw, item):
        """The mesh (A13) and relax (A9) options raise. The class-batched
        scan (A8) is ported: classed=True solves, deciding as TpuSolver
        does (tests/test_torch_classed.py holds it case by case)."""
        from karpenter_tpu_torch.solver.driver import SolverConfig

        if item == "A8":
            got = []
            for pkg in PKGS:
                solver, pods = _build(pkg, "diverse_reference_mix", 150, 20)
                solver.config.classed = True
                got.append(decisions(solver.solve(pods), pods))
            assert SolverConfig(device="cpu", **kw).classed is True
            assert got[0] == got[1] and got[1][0]
            return
        with pytest.raises(NotImplementedError, match=item):
            SolverConfig(device="cpu", **kw)

    def test_scenarios_raise(self):
        """The scenario axis is ported (tests/test_torch_scenarios.py); a
        batch outside the kernel scope (a minValues pool) still raises."""
        from karpenter_tpu_torch.solver.driver import Scenario

        solver, pods = _build("karpenter_tpu_torch", "constrained_mix", 60, 20,
                              pools="minvalues")
        assert solver.solve_scenarios([]) == []
        with pytest.raises(NotImplementedError, match="A4b"):
            solver.solve_scenarios([Scenario(pods=pods)])

    def test_to_device_args_keeps_dtypes(self):
        from karpenter_tpu_torch.solver.args import to_device_args
        from karpenter_tpu_torch.solver.example import example_snapshot_arrays

        args, _ = example_snapshot_arrays(64, 16, 4)
        want = {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int32,
                np.dtype(np.float32): torch.float32}
        for a, t in zip(args, to_device_args(args, "cpu")):
            assert t.dtype == want[np.asarray(a).dtype]
            np.testing.assert_array_equal(t.numpy(), a)
        bad = list(args)
        bad[0] = np.asarray(bad[0], np.int64)
        with pytest.raises(TypeError, match="g_count"):
            to_device_args(bad, "cpu")
