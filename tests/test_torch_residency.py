"""Port parity for the warm path: device residency and the row-delta apply
(kernel B8), on the CPU.

karpenter_tpu_torch/ops/solve.py:delta_apply_rows_reference is the plain
version of B8; it equals JAX's ``delta_apply_rows`` exactly on every dtype
the residency store stages. The churn scripts of tests/test_delta_encode.py
run through TorchSolver(device="cpu") with the port's own residency store
(solver/residency.py): after every tick the warm encoding is byte-identical
to a cold one, the warm decisions equal a cold solver's and TpuSolver's,
and the row-delta counts equal TpuSolver's. Also pinned: REUSE on an
unchanged cluster, the stale-buffer gates, topology batches riding the
delta contract, the corrupt-delta recovery (a guard rejection after a row
delta re-solves once from a full re-encode, on the solver's own device),
and the constrained-churn protocol of bench.py (``churn_tick``), with the
reference's own warm contract on it (a same-vocab re-encode, not a
fresh-cache solve).

The port's objects are rebuilt from the JAX test builders' (``to_port``:
the port's api modules are copies, so every class has a namesake); pods
keep their uids, so decisions compare by uid.
"""

from __future__ import annotations

import dataclasses
import importlib
import random

import numpy as np
import pytest
import torch

from helpers import make_nodepool, make_pod, spread_constraint
from karpenter_tpu.api import labels as labels_mod

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def to_port(obj, memo=None):
    """A karpenter_tpu object graph rebuilt from the port's classes of the
    same names (dataclasses field by field; containers element-wise).
    ``memo`` maps id(source) -> (source, copy) and keeps the source alive,
    so a recycled id can never alias."""
    return _rebuild(obj, "karpenter_tpu", "karpenter_tpu_torch", {} if memo is None else memo)


def to_jax(obj, memo=None):
    """``to_port``'s inverse: a karpenter_tpu_torch object graph rebuilt
    from the JAX package's classes of the same names."""
    return _rebuild(obj, "karpenter_tpu_torch", "karpenter_tpu", {} if memo is None else memo)


def _rebuild(obj, src, dst, memo):
    hit = memo.get(id(obj))
    if hit is not None:
        return hit[1]
    if isinstance(obj, (list, tuple, set, frozenset)):
        out = type(obj)(_rebuild(x, src, dst, memo) for x in obj)
    elif isinstance(obj, dict):
        out = {_rebuild(k, src, dst, memo): _rebuild(v, src, dst, memo) for k, v in obj.items()}
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        assert mod.split(".")[0] == src, mod
        cls = getattr(importlib.import_module(dst + mod[len(src):]), type(obj).__name__)
        fields = dataclasses.fields(obj)
        out = cls(**{f.name: _rebuild(getattr(obj, f.name), src, dst, memo)
                     for f in fields if f.init})
        for f in fields:
            if not f.init:
                object.__setattr__(out, f.name, _rebuild(getattr(obj, f.name), src, dst, memo))
    else:
        out = obj
    memo[id(obj)] = (obj, out)
    return out


def port_state_node(sn):
    """The port's StateNode over a copy of a (pod-free) JAX StateNode's node."""
    from karpenter_tpu_torch.controllers.state import StateNode

    return StateNode(node=to_port(sn.node))


def signature(results):
    """Decisions by pod uid: claims (pool, pods, options, requirements) in
    slot order, each claim's options in their own order; existing-node
    placements, pod errors."""
    return (
        [
            (
                c.template.node_pool_name,
                tuple(sorted(p.uid for p in c.pods)),
                tuple(it.name for it in c.instance_type_options),
                repr(sorted(map(repr, c.requirements))),
            )
            for c in results.new_node_claims
        ],
        sorted(
            (en.name, tuple(sorted(p.uid for p in en.pods)))
            for en in results.existing_nodes
        ),
        sorted(results.pod_errors),
    )


# -- B8: the row-delta apply against JAX's --------------------------------------


@pytest.mark.parametrize("dtype", ["bool", "int32", "float32"])
@pytest.mark.parametrize("shape", [(37,), (37, 3), (20, 4, 5)])
def test_delta_apply_rows_equals_jax(dtype, shape):
    """Any trailing shape; a duplicate index carrying its row twice; the
    old tensor left untouched (the default is out of place)."""
    from karpenter_tpu.ops.solve import delta_apply_rows as jax_apply
    from karpenter_tpu_torch.ops.solve import delta_apply_rows

    rng = np.random.default_rng(len(shape))
    if dtype == "bool":
        arr, rows = rng.random(shape) < 0.5, rng.random((6,) + shape[1:]) < 0.5
    else:
        arr = rng.integers(-50, 50, shape).astype(dtype)
        rows = rng.integers(-50, 50, (6,) + shape[1:]).astype(dtype)
    idx = rng.choice(shape[0], 5, replace=False).astype(np.int32)
    idx = np.append(idx, idx[2])
    rows[5] = rows[2]
    want = np.asarray(jax_apply(arr, idx, rows))
    before = torch.from_numpy(arr.copy())
    got = delta_apply_rows(before, idx, rows)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(before.numpy(), arr)
    assert delta_apply_rows(before, idx[:0], rows[:0]) is before


# -- the churn harness (tests/test_delta_encode.py) for either package ------------

_POD_SHAPES = [
    dict(cpu="1", memory="2Gi"),
    dict(cpu="2", memory="4Gi"),
    dict(cpu="500m", memory="1Gi", labels={"tier": "web"}),
    dict(cpu="1500m", memory="3Gi",
         node_selector={labels_mod.TOPOLOGY_ZONE: "test-zone-a"}),
]
_NODE_SHAPES = [
    dict(cpu="16", memory="64Gi", zone="test-zone-a"),
    dict(cpu="8", memory="32Gi", zone="test-zone-b"),
    dict(cpu="32", memory="128Gi", zone="test-zone-a"),
]
_ZONES = ["test-zone-a", "test-zone-b"]
_ITS = {pkg: _mod(pkg, "cloudprovider.corpus").generate(16) for pkg in PKGS}


class ChurnCluster:
    """tests/test_delta_encode.py:ChurnCluster, materialized for either
    package: pods are shared across ticks (the port's copies memoized, so
    both solvers see stable pod objects), state nodes fresh per solver."""

    OPS = (
        "pod_birth", "pod_delete", "pod_label_flip",
        "node_add", "node_remove", "node_capacity", "node_zone_flip",
        "daemonset_change", "pool_limit_edit", "noop",
    )

    def __init__(self, rng: random.Random):
        self.rng = rng
        self.pods = [make_pod(**_POD_SHAPES[i % len(_POD_SHAPES)]) for i in range(24)]
        self.nodes = [
            ["churn-n%d" % i, dict(_NODE_SHAPES[i % len(_NODE_SHAPES)])]
            for i in range(5)
        ]
        self.daemon_cpu = "100m"
        self.pool_limit = None
        self._memo = {}

    def tick(self, n_ops: int = 2) -> None:
        for _ in range(n_ops):
            op = self.rng.choice(self.OPS)
            getattr(self, "_op_" + op)()

    def _op_noop(self):
        pass

    def _op_pod_birth(self):
        self.pods.append(make_pod(**self.rng.choice(_POD_SHAPES)))

    def _op_pod_delete(self):
        if len(self.pods) > 4:
            self.pods.pop(self.rng.randrange(len(self.pods)))

    def _op_pod_label_flip(self):
        i = self.pods.index(self.rng.choice(self.pods))
        shape = dict(self.rng.choice(_POD_SHAPES))
        shape["node_selector"] = {labels_mod.TOPOLOGY_ZONE: self.rng.choice(_ZONES)}
        self.pods[i] = make_pod(**shape)

    def _op_node_add(self):
        if len(self.nodes) < 9:
            self.nodes.append(["churn-n%d" % self.rng.randrange(100, 1000),
                               dict(self.rng.choice(_NODE_SHAPES))])

    def _op_node_remove(self):
        if len(self.nodes) > 1:
            self.nodes.pop(self.rng.randrange(len(self.nodes)))

    def _op_node_capacity(self):
        _, shape = self.rng.choice(self.nodes)
        shape["cpu"] = self.rng.choice(["8", "16", "24"])

    def _op_node_zone_flip(self):
        _, shape = self.rng.choice(self.nodes)
        shape["zone"] = self.rng.choice(_ZONES)

    def _op_daemonset_change(self):
        self.daemon_cpu = self.rng.choice(["100m", "200m", "300m"])

    def _op_pool_limit_edit(self):
        self.pool_limit = self.rng.choice([None, "5000", "9000"])

    def pods_for(self, pkg):
        if pkg == "karpenter_tpu":
            return self.pods
        return [to_port(p, self._memo) for p in self.pods]

    def build_solver(self, pkg, cache, config=None):
        from helpers import make_state_node

        limits = {"cpu": self.pool_limit} if self.pool_limit else None
        pools = [make_nodepool(limits=limits)]
        sns = [make_state_node(name=n, cpu=s["cpu"], memory=s["memory"], zone=s["zone"])
               for n, s in self.nodes]
        ds = [make_pod(name=None, cpu=self.daemon_cpu, memory="128Mi")]
        pods = self.pods_for(pkg)
        drv = _mod(pkg, "solver.driver")
        kw = {}
        if pkg == "karpenter_tpu_torch":
            pools, ds = to_port(pools), to_port(ds)
            sns = [port_state_node(sn) for sn in sns]
            kw["config"] = config or drv.SolverConfig(device="cpu")
        elif config is not None:
            kw["config"] = config
        its_by_pool = {pools[0].name: list(_ITS[pkg])}
        kube = _mod(pkg, "kube")
        topo = _mod(pkg, "scheduling.topology").Topology(
            kube.Client(kube.TestClock()), sns, pools, its_by_pool, pods)
        cls = drv.TorchSolver if pkg == "karpenter_tpu_torch" else drv.TpuSolver
        return cls(pools, its_by_pool, topo, state_nodes=sns, daemonset_pods=ds,
                   encode_cache=cache, **kw)


def _cache(pkg):
    return _mod(pkg, "solver.driver").EncodeCache()


def _snapshots_identical(a, b):
    assert a.resource_names == b.resource_names
    assert a.existing_names == b.existing_names
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            assert np.array_equal(va, vb), f"delta snapshot diverged in {f.name}"


def _encode(solver, pods):
    enc = importlib.import_module(type(solver).__module__.rsplit(".", 1)[0] + ".encode")
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    assert not rest
    return solver._encode_batch(groups)


@pytest.mark.parametrize("seed", [3, 11])
def test_churn_script_byte_identical_and_same_decisions(seed):
    """Every tick of a seeded churn script: the port's warm encoding equals
    a cold one byte for byte; its warm decisions equal a cold solver's and
    TpuSolver's warm ones; the row-delta counts equal TpuSolver's."""
    cluster = ChurnCluster(random.Random(seed))
    warm = {pkg: _cache(pkg) for pkg in PKGS}
    pkg = "karpenter_tpu_torch"
    enc_warm = _cache(pkg)  # encodes every tick, never solves
    saw_delta = False
    for t in range(10):
        if t:
            cluster.tick(cluster.rng.randrange(1, 3))
        pods = cluster.pods_for(pkg)
        snap_w, *_ = _encode(cluster.build_solver(pkg, enc_warm), pods)
        snap_c, *_ = _encode(cluster.build_solver(pkg, _cache(pkg)), pods)
        _snapshots_identical(snap_w, snap_c)
        got = {}
        for p in PKGS:
            s = cluster.build_solver(p, warm[p])
            got[p] = (signature(s.solve(cluster.pods_for(p))), s.last_encode_reused,
                      s.last_delta_rows)
        cold = signature(cluster.build_solver(pkg, _cache(pkg)).solve(pods))
        assert got[pkg] == got["karpenter_tpu"]
        assert got[pkg][0] == cold
        store = warm[pkg].device_store
        saw_delta |= store.last_delta_rows > 0
    assert saw_delta, "the churn script never took the row-delta path"


def test_unchanged_cluster_reuses_snapshot_verbatim():
    from karpenter_tpu_torch import obs

    cluster = ChurnCluster(random.Random(0))
    cache = _cache("karpenter_tpu_torch")
    pods = cluster.pods_for("karpenter_tpu_torch")
    s1 = cluster.build_solver("karpenter_tpu_torch", cache)
    r1 = s1.solve(pods)
    assert not s1.last_encode_reused
    s2 = cluster.build_solver("karpenter_tpu_torch", cache)
    r2 = s2.solve(pods)
    assert s2.last_encode_reused and s2.last_delta_rows == 0
    assert signature(r1) == signature(r2)
    store = cache.device_store
    assert store.last_incremental and store.last_full_puts == 0
    assert store.last_delta_rows == 0
    rec = obs.AUDIT.last()
    assert rec.encode_reused is True and rec.delta_rows == 0


def test_node_churn_rides_a_row_delta():
    """One node's capacity changes: a row-level delta on the node class,
    applied on the device (B8's plain version here), as TpuSolver counts."""
    cluster = ChurnCluster(random.Random(0))
    caches = {pkg: _cache(pkg) for pkg in PKGS}
    for pkg in PKGS:
        cluster.build_solver(pkg, caches[pkg]).solve(cluster.pods_for(pkg))
    cluster.nodes[2][1]["cpu"] = "24"
    rows = {}
    for pkg in PKGS:
        s = cluster.build_solver(pkg, caches[pkg])
        s.solve(cluster.pods_for(pkg))
        d = caches[pkg].cluster.last_delta
        assert not d.reused and not d.full and list(d.node_rows) == [2]
        rows[pkg] = s.last_delta_rows
    store = caches["karpenter_tpu_torch"].device_store
    assert rows["karpenter_tpu_torch"] == rows["karpenter_tpu"] >= 1
    assert store.last_delta_rows >= 1 and store.last_incremental
    assert caches["karpenter_tpu"].device_store.last_delta_rows == store.last_delta_rows


def _warm_vs_cold(cluster):
    pkg = "karpenter_tpu_torch"
    pods = cluster.pods_for(pkg)
    return (signature(cluster.build_solver(pkg, cluster._warm).solve(pods)),
            signature(cluster.build_solver(pkg, _cache(pkg)).solve(pods)))


class TestStaleBufferGates:
    """The store never feeds the kernel a buffer more than one encode
    behind (the exactly-one-version-behind gate of the row delta)."""

    def _staged_then_unstaged(self):
        pkg = "karpenter_tpu_torch"
        cluster = ChurnCluster(random.Random(2))
        cluster._warm = _cache(pkg)
        cluster.build_solver(pkg, cluster._warm).solve(cluster.pods_for(pkg))
        cluster.nodes[1][1]["cpu"] = "24"
        _encode(cluster.build_solver(pkg, cluster._warm), cluster.pods_for(pkg))
        return cluster

    def test_unstaged_encode_forces_full_restage(self):
        cluster = self._staged_then_unstaged()
        cluster.nodes[2][1]["cpu"] = "8"
        warm, cold = _warm_vs_cold(cluster)
        assert warm == cold

    def test_empty_diff_after_unstaged_bump_restages(self):
        cluster = self._staged_then_unstaged()
        cluster.pods = cluster.pods[:-1]  # pod churn only: empty node diff
        warm, cold = _warm_vs_cold(cluster)
        assert warm == cold
        store = cluster._warm.device_store
        assert store.last_full_puts >= 1  # the node class restaged whole


def _spread_pods(skew, key=labels_mod.HOSTNAME, n=4):
    return [make_pod(cpu="1", memory="1Gi", labels={"app": "s"},
                     spread=[spread_constraint(key, labels={"app": "s"}, max_skew=skew)])
            for _ in range(n)]


def test_topology_batch_rides_delta_contract():
    """An unchanged topology batch re-encodes as REUSE (no full restage);
    a constraint-content change bumps the cross class and still decides
    as a cold solver."""
    pkg = "karpenter_tpu_torch"
    cluster = ChurnCluster(random.Random(4))
    cluster._warm = _cache(pkg)
    cl = cluster._warm.cluster
    cluster.pods = _spread_pods(1)
    cluster.build_solver(pkg, cluster._warm).solve(cluster.pods_for(pkg))
    v1 = cl.v_cross
    warm, cold = _warm_vs_cold(cluster)
    assert cl.last_delta.reused and cl.v_cross == v1
    assert warm == cold
    cluster.pods = _spread_pods(2)
    warm, cold = _warm_vs_cold(cluster)
    assert not cl.last_delta.reused and cl.v_cross > v1
    assert warm == cold


def test_warm_topology_solve_reuses_device_buffers():
    pkg = "karpenter_tpu_torch"
    cluster = ChurnCluster(random.Random(11))
    cache = _cache(pkg)
    cluster.pods = _spread_pods(1, key=labels_mod.TOPOLOGY_ZONE, n=6)
    cluster.build_solver(pkg, cache).solve(cluster.pods_for(pkg))
    store = cache.device_store
    assert store is not None
    cluster.build_solver(pkg, cache).solve(cluster.pods_for(pkg))
    assert store.last_incremental and store.last_full_puts == 0


def test_corrupt_delta_recovers_from_a_full_reencode():
    """A corrupted delta row (inflated node capacity on the device copy)
    trips the pre-decode invariant guard; the solver sheds the warm state
    and re-solves once, on its own device, from a full re-encode: results
    equal a cold solver's, nothing stale is committed, and the fallback is
    an event (no degradation ladder in the port), not a sequential solve."""
    from karpenter_tpu_torch import faults, obs

    pkg = "karpenter_tpu_torch"
    cluster = ChurnCluster(random.Random(0))
    cache = _cache(pkg)
    cluster.build_solver(pkg, cache).solve(cluster.pods_for(pkg))
    cluster.nodes[0][1]["cpu"] = "8"
    solver = cluster.build_solver(pkg, cache)
    inj = faults.install(faults.FaultInjector([faults.FaultRule(
        site=faults.ENCODE_DELTA,
        mutate=lambda vals: np.full_like(vals, 10_000_000),
        match=lambda ctx: ctx.get("name") == "n_avail",
        times=1,
    )], seed=1))
    tracer = obs.install(obs.Tracer(obs.PerfClock()))
    try:
        results = solver.solve(cluster.pods_for(pkg))
    finally:
        obs.uninstall()
        faults.uninstall()
    assert inj.fired(faults.ENCODE_DELTA) == 1
    assert not results.pod_errors and solver.fallback_solves == 0
    cold = cluster.build_solver(pkg, _cache(pkg)).solve(cluster.pods_for(pkg))
    assert signature(results) == signature(cold)
    assert cache.cluster.last_delta.full  # the retry re-encoded in full
    events = [name for sp in tracer.finished() for _, name, _ in sp.events]
    assert events.count("solver.delta_fallback") == 1
    rec = obs.AUDIT.last()
    assert rec.encode_reused is False and rec.delta_rows == 0


def test_corrupt_scenario_delta_recovers_from_a_full_reencode():
    """The scenario path's half-step: a corrupted row delta on the scenario
    store trips the guard in collect_scenarios, and the whole batch runs
    once more from a full re-encode, deciding as a fresh solver does."""
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.solver.driver import Scenario

    pkg = "karpenter_tpu_torch"
    cluster = ChurnCluster(random.Random(0))
    cache = _cache(pkg)

    def batch(solver):
        pods = cluster.pods_for(pkg)
        return solver.solve_scenarios([Scenario(pods=pods), Scenario(pods=pods[:10])])

    batch(cluster.build_solver(pkg, cache))
    cluster.nodes[0][1]["cpu"] = "8"
    solver = cluster.build_solver(pkg, cache)
    inj = faults.install(faults.FaultInjector([faults.FaultRule(
        site=faults.ENCODE_DELTA,
        mutate=lambda vals: np.full_like(vals, 10_000_000),
        match=lambda ctx: ctx.get("name") == "n_avail",
        times=1,
    )], seed=1))
    try:
        results = batch(solver)
    finally:
        faults.uninstall()
    assert inj.fired(faults.ENCODE_DELTA) == 1 and solver.fallback_solves == 0
    assert cache.scenario_cluster.last_delta.full  # the retry re-encoded in full
    fresh = batch(cluster.build_solver(pkg, _cache(pkg)))
    assert [signature(r) for r in results] == [signature(r) for r in fresh]


def test_scenario_store_stays_warm():
    """The scenario path stages the shared encoding through its own store:
    a repeat batch over an unchanged cluster reuses every shared buffer."""
    from test_torch_scenarios import _candidates, _env, _simulator, _subsets

    pkg = "karpenter_tpu_torch"
    ctx = _env(pkg, 12, seed=2, pending=1)
    candidates = _candidates(pkg, ctx)
    first = _simulator(pkg, ctx, candidates).solve(_subsets(candidates, (1, 2)))
    store = ctx.encode_cache.scenario_device_store
    assert store is not None and store.last_full_puts > 0
    again = _simulator(pkg, ctx, candidates).solve(_subsets(candidates, (1, 2)))
    assert store.last_incremental and store.last_full_puts == 0
    assert [signature(r) for r in first] == [signature(r) for r in again]


def test_constrained_churn_protocol_equals_tpu_solver():
    """bench.py's constrained-churn protocol (workloads.churn_tick: 1% of
    the pods swapped per tick from a same-seed regeneration), cut to 1,000
    pods x 60 types: two warm-ups, four ticks riding row deltas with no
    full re-encode, each tick deciding as TpuSolver's warm tick and as a
    full re-encode of the same pods over the same catalog vocab, and a
    repeat solve hitting REUSE with zero full puts. (A fresh EncodeCache
    may intern zone values in another order, which moves ties: the JAX
    package's warm and fresh-cache solves of one tick differ as well.)"""
    from karpenter_tpu.solver.workloads import constrained_mix as jax_mix
    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick

    n, n_types = 1000, 60
    runs = {}
    for pkg in PKGS:
        corpus = _mod(pkg, "cloudprovider.corpus")
        ex = _mod(pkg, "solver.example")
        drv = _mod(pkg, "solver.driver")
        kube = _mod(pkg, "kube")
        mix = _mod(pkg, "solver.workloads").constrained_mix
        pools = [ex.example_nodepool()]
        its = {pools[0].name: corpus.generate(n_types)}
        cache = drv.EncodeCache()

        def solver_for(pods, cache):
            topo = _mod(pkg, "scheduling.topology").Topology(
                kube.Client(kube.TestClock()), [], pools, its, pods)
            kw = {"config": drv.SolverConfig(device="cpu")} if pkg != "karpenter_tpu" else {}
            cls = drv.TpuSolver if pkg == "karpenter_tpu" else drv.TorchSolver
            return cls(pools, its, topo, encode_cache=cache, **kw)

        rng = random.Random(CHURN_SEED)
        pods = mix(n)
        solver_for(pods, cache).solve(pods)
        solver_for(pods, cache).solve(pods)
        ticks = []
        for _ in range(4):
            pods = churn_tick(pods, mix, rng) if pkg != "karpenter_tpu" else \
                churn_tick(pods, jax_mix, rng)
            s = solver_for(pods, cache)
            names = {p.uid: p.metadata.name for p in pods}
            r = s.solve(pods)
            sig = _by_name(r, names)
            if pkg == "karpenter_tpu_torch":
                assert s.last_delta_rows > 0 and cache.device_store.last_delta_rows > 0
                assert s.fallback_solves == 0
                cache.cluster.invalidate("full re-encode check")
                cache.device_store.reset()
                assert sig == _by_name(solver_for(pods, cache).solve(pods), names)
            ticks.append((sig, s.last_delta_rows))
        s2 = solver_for(pods, cache)
        s2.solve(pods)
        assert s2.last_encode_reused
        if pkg == "karpenter_tpu_torch":
            assert cache.device_store.last_full_puts == 0
        runs[pkg] = ticks
    assert runs["karpenter_tpu_torch"] == runs["karpenter_tpu"]


def test_jax_warm_tick_is_a_same_vocab_reencode_not_a_fresh_cache_solve():
    """The reference's own warm contract, on the constrained-churn protocol
    at 2,000 pods x 60 types: each TpuSolver tick decides exactly as a full
    re-encode over the same EncodeCache (same vocab), while a fresh
    EncodeCache interns the zone values in another order and decides
    differently on every tick. This is why the port's warm ticks (here and
    on the card) are held against a same-vocab re-encode."""
    from karpenter_tpu.cloudprovider import corpus
    from karpenter_tpu.scheduling.topology import Topology
    from karpenter_tpu.solver import driver as drv, example as ex
    from karpenter_tpu.solver.workloads import constrained_mix
    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick
    import karpenter_tpu.kube as kube

    pools = [ex.example_nodepool()]
    its = {pools[0].name: corpus.generate(60)}

    def solve(pods, cache):
        topo = Topology(kube.Client(kube.TestClock()), [], pools, its, pods)
        return drv.TpuSolver(pools, its, topo, encode_cache=cache).solve(pods)

    cache = drv.EncodeCache()
    rng = random.Random(CHURN_SEED)
    pods = constrained_mix(2000)
    solve(pods, cache)
    solve(pods, cache)
    differs = []
    for _ in range(4):
        pods = churn_tick(pods, constrained_mix, rng)
        names = {p.uid: p.metadata.name for p in pods}
        warm = _by_name(solve(pods, cache), names)
        assert not cache.cluster.last_delta.full
        fresh_cache = drv.EncodeCache()
        fresh = _by_name(solve(pods, fresh_cache), names)
        differs.append(warm != fresh)
        cache.cluster.invalidate("same-vocab re-encode")
        cache.device_store.reset()
        assert _by_name(solve(pods, cache), names) == warm
    zone = cache.vocab.key_ids["topology.kubernetes.io/zone"]
    fresh_zone = fresh_cache.vocab.key_ids["topology.kubernetes.io/zone"]
    assert cache.vocab.values[zone] != fresh_cache.vocab.values[fresh_zone]
    assert differs == [True] * 4, differs


def _by_name(results, names):
    """Decisions by pod name (the churn regenerates pods, whose uids differ
    between the two packages' runs)."""
    return (
        sorted((c.template.node_pool_name, tuple(sorted(names[p.uid] for p in c.pods)),
                tuple(it.name for it in c.instance_type_options))
               for c in results.new_node_claims),
        sorted(names[u] for u in results.pod_errors),
    )
