"""Port parity for the class-batched scan (B5) and contributor counting, on the CPU.

The JAX package is the reference. Tolerance everywhere: exact equality.

- ``pack_reference`` with ``has_contrib`` (the plain version of kernel B4's
  contributor counting) equals JAX ``pack`` on padded snapshots whose
  groups carry hostname and domain contributor rows, with and without
  existing nodes.
- ``pack_classed_reference`` (the plain version of kernel B5) equals JAX
  ``pack_classed`` on every output and every field of the final state, on
  snapshots with padding classes, dynamic classes on each axis,
  contributor rows, existing nodes and an overflowing NMAX.
- ``TorchSolver(device="cpu")`` with ``classed`` True, False and None
  decides as ``TpuSolver`` with the same setting on the cases of
  tests/test_classed_kernel.py, and routes each batch to the classed scan
  exactly where TpuSolver does.
"""

import importlib

import numpy as np
import pytest
import torch

from helpers import make_state_node
from karpenter_tpu.api import labels
from karpenter_tpu.api.objects import (
    LabelSelector, PodAffinityTerm, TopologySpreadConstraint,
)
from karpenter_tpu.solver.workloads import (
    _pod, constrained_mix, diverse_reference_mix, mixed_pods, spot_od_pools,
)

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")
ZONES = ("test-zone-a", "test-zone-b", "test-zone-c")
# the scan's inputs in JAX pack's positional order (feasibility tables
# in place of the sparse index)
JAX_PACK_NAMES = (
    "g_count g_req g_def g_neg g_mask g_hcap g_haff g_dmode g_dkey g_dskew "
    "g_dmin0 g_dprior g_dreg g_drank g_hstg g_hscap g_dtg g_hself g_hcontrib "
    "g_dcontrib compat_pg type_ok_pgt n_fit_pgt cap_ng t_alloc t_cap a_tzc "
    "res_cap0 a_res p_def p_neg p_mask p_daemon p_limit p_has_limit p_tol "
    "p_titype_ok t_def t_mask o_avail o_zone o_ct n_def n_mask n_avail n_base "
    "n_tol n_hcnt n_dzone n_dct nh_cnt0 dd0 dtg_key well_known p_mvmin t_mvoh"
).split()
TABLE_NAMES = ("compat_pg", "type_ok_pgt", "n_fit_pgt", "cap_ng")
FEAS_NAMES = (
    "g_count g_def g_neg g_mask g_req p_def p_neg p_mask p_daemon p_tol "
    "p_titype_ok t_def t_mask t_alloc o_avail o_zone o_ct n_def n_mask n_avail "
    "n_base n_tol well_known gk_g gk_k gk_w goff_idx"
).split()


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# -- pod batches (JAX objects; the port's solver gets them through to_port) ----


def _spread(key, lbl):
    return TopologySpreadConstraint(
        max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels=lbl),
    )


def _anti_affinity(n=60):
    lbl = {"app": "nginx"}
    return [
        _pod(f"anti-{i}", 100 + 100 * (i % 5), 256, labels=lbl,
             pod_anti_affinity=[PodAffinityTerm(
                 topology_key=labels.HOSTNAME,
                 label_selector=LabelSelector(match_labels=lbl))])
        for i in range(n)
    ]


def _zonal_selectors():
    return [
        _pod(f"zs-{i}", 250, 256, labels={"grp": "abc"[i % 3]},
             topology_spread_constraints=[
                 _spread(labels.TOPOLOGY_ZONE, {"grp": "abc"[i % 3]})])
        for i in range(48)
    ]


def _mixed_axes():
    pods = [
        _pod(f"zs-{i}", 500, 512, labels={"mx": "ab"[i % 2]},
             topology_spread_constraints=[
                 _spread(labels.TOPOLOGY_ZONE, {"mx": "ab"[i % 2]})])
        for i in range(20)
    ]
    pods += [
        _pod(f"cs-{i}", 500, 512, labels={"mx": "cd"[i % 2]},
             topology_spread_constraints=[
                 _spread(labels.CAPACITY_TYPE_LABEL_KEY, {"mx": "cd"[i % 2]})])
        for i in range(20)
    ]
    return pods


def _contributors():
    pods = [_pod(f"c-{i}", 250, 256, labels={"team": "ab"[i % 2]}) for i in range(30)]
    pods += [
        _pod(f"o-{i}", 250, 256, labels={"team": "ab"[i % 2]},
             topology_spread_constraints=[
                 _spread(labels.HOSTNAME, {"team": "ab"[i % 2]})])
        for i in range(30)
    ]
    return pods


def _zonal_contributors():
    # plain pods whose labels a later zonal spread selects: domain
    # contributor rows (g_dcontrib) on the zone axis
    pods = [_pod(f"zc-{i}", 250, 256, labels={"tier": "web"}) for i in range(24)]
    pods += [
        _pod(f"zo-{i}", 500, 512, labels={"tier": "web"},
             topology_spread_constraints=[_spread(labels.TOPOLOGY_ZONE, {"tier": "web"})])
        for i in range(18)
    ]
    return pods


def _zonal_affinity():
    lbl = {"aff": "x"}
    return [
        _pod(f"aff-{i}", 100 + 100 * (i % 3), 256, labels=lbl,
             pod_affinity=[PodAffinityTerm(
                 topology_key=labels.TOPOLOGY_ZONE,
                 label_selector=LabelSelector(match_labels=lbl))])
        for i in range(30)
    ]


def _zonal_nodes(n, cpu="8", memory="16Gi"):
    return [make_state_node(name=f"exists-{i}", cpu=cpu, memory=memory,
                            zone=ZONES[i % len(ZONES)]) for i in range(n)]


# -- the scan on padded snapshots ------------------------------------------------


def _snapshot(pods, n_types=20, state_nodes=()):
    """The JAX encoding of ``pods``: named padded solve args (numpy), the
    kernel statics and the class partition (forced: min_mean_size 0)."""
    from karpenter_tpu.cloudprovider import corpus
    from karpenter_tpu.kube import Client, TestClock
    from karpenter_tpu.scheduling.topology import Topology
    from karpenter_tpu.solver import TpuSolver
    from karpenter_tpu.solver import encode as enc
    from karpenter_tpu.solver.example import example_nodepool

    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}
    topo = Topology(Client(TestClock()), list(state_nodes), pools, its, pods)
    solver = TpuSolver(pools, its, topo, state_nodes=list(state_nodes))
    groups, rest = enc.partition_and_group(pods, topology=topo)
    assert not rest, "the batch must tensorize fully"
    snap, avail, *_ = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    N = enc._next_pow2(len(snap.existing_names), floor=1) if snap.existing_names else 0
    run = snap.padded(G, N)
    statics = solver._kernel_statics(snap, G)
    a = dict(zip(enc.SOLVE_ARG_NAMES, run.solve_args(*avail)))
    classes = enc.class_partition(run)
    return a, statics, classes


def _tables(a, statics):
    """The four feasibility tables, from the JAX package (the sparse twins)."""
    from karpenter_tpu.ops.solve import _feasibility_tables

    return [np.asarray(x) for x in _feasibility_tables(
        *(a[n] for n in FEAS_NAMES), zone_kid=statics["zone_kid"],
        ct_kid=statics["ct_kid"], tile_feasibility=False, sparse_groups=True)]


def _both_scans(a, statics, nmax, classes=None):
    """JAX pack (or pack_classed with ``classes``) and the port's plain
    version on the same arrays. Returns (jax outputs, port outputs)."""
    import jax
    from karpenter_tpu.ops import packing as jpack
    from karpenter_tpu_torch.ops import packing as tp
    from karpenter_tpu_torch.ops.solve import pack_args

    a = dict(a, **dict(zip(TABLE_NAMES, _tables(a, statics))))
    st = dict(nmax=nmax, zone_kid=statics["zone_kid"], ct_kid=statics["ct_kid"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"],
              wf_iters=statics["wf_iters"])
    ta = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    port_in = pack_args(ta, *(ta[n] for n in TABLE_NAMES))
    if classes is None:
        return (jax.device_get(jpack.pack(*(a[n] for n in JAX_PACK_NAMES), **st)),
                tp.pack_reference(*port_in, **st))
    *arrs, lmax = classes
    j = jax.device_get(jpack.pack_classed(
        *(a[n] for n in JAX_PACK_NAMES), *arrs, lmax=lmax, **st))
    t = tp.pack_classed_reference(
        *port_in, *(torch.from_numpy(x) for x in arrs), lmax=lmax, **st)
    return j, t


def _assert_equal(name, j, t):
    j, t = np.asarray(j), t.numpy()
    assert t.shape == j.shape, f"{name}: {t.shape} vs {j.shape}"
    mism = np.argwhere(t.astype(j.dtype) != j)
    assert not mism.size, f"{name} diverges at {mism[:5].tolist()}"


CONTRIB_CASES = {
    "diverse": lambda: (diverse_reference_mix(120), ()),
    "diverse-nodes": lambda: (diverse_reference_mix(120), _zonal_nodes(4)),
    "hostname-owners": lambda: (_contributors(), ()),
    "zonal": lambda: (_zonal_contributors(), ()),
    "zonal-nodes": lambda: (_zonal_contributors(), _zonal_nodes(3, cpu="4")),
}


@pytest.mark.parametrize("case", list(CONTRIB_CASES))
def test_pack_contrib_matches_jax(case):
    """pack_reference(has_contrib=True) == JAX pack: the 10 solve outputs."""
    pods, nodes = CONTRIB_CASES[case]()
    a, statics, _ = _snapshot(pods, state_nodes=nodes)
    assert statics["has_contrib"], "no contributor rows in the batch"
    assert a["g_hcontrib"].any() or a["g_dcontrib"].any()
    j, t = _both_scans(a, statics, nmax=64)
    js, jf = j[0], j[1:]
    want = (js.c_pool, js.c_tmask, js.n_open, js.overflow, *jf, js.c_dzone,
            js.c_dct, js.c_resv)
    names = ("c_pool", "c_tmask", "n_open", "overflow", "exist_fills",
             "claim_fills", "unplaced", "c_dzone", "c_dct", "c_resv")
    for name, jx, tx in zip(names, want, t):
        _assert_equal(name, jx, tx)


CLASSED_CASES = {
    # contributor rows, zone-dynamic classes, padding classes
    "diverse-300": lambda: (diverse_reference_mix(300), (), 40, 64),
    "diverse-overflow": lambda: (diverse_reference_mix(200), (), 30, 8),
    "diverse-nodes": lambda: (diverse_reference_mix(120), _zonal_nodes(4), 30, 64),
    # a zone-dynamic class and a capacity-type-dynamic class
    "mixed-axes": lambda: (_mixed_axes(), (), 30, 32),
    "anti-affinity": lambda: (_anti_affinity(), (), 30, 64),
    "zonal-affinity": lambda: (_zonal_affinity(), (), 30, 32),
    "zonal-contributors-nodes": lambda: (_zonal_contributors(), _zonal_nodes(3, cpu="4"), 20, 32),
    "mixed-domain-free": lambda: (mixed_pods(300), (), 30, 64),
}


@pytest.mark.parametrize("case", list(CLASSED_CASES))
def test_pack_classed_matches_jax(case):
    """pack_classed_reference == JAX pack_classed: every field of the final
    PackState, the fills and the unplaced counts."""
    from karpenter_tpu_torch.ops.packing import PackState

    pods, nodes, n_types, nmax = CLASSED_CASES[case]()
    a, statics, classes = _snapshot(pods, n_types=n_types, state_nodes=nodes)
    cl = classes[1]
    j, t = _both_scans(a, statics, nmax=nmax, classes=classes)
    for f in PackState._fields:
        _assert_equal(f, getattr(j[0], f), getattr(t[0], f))
    for name, jx, tx in zip(("exist_fills", "claim_fills", "unplaced"), j[1:], t[1:]):
        _assert_equal(name, jx, tx)
    if case == "diverse-overflow":
        assert bool(j[0].overflow)
    if case == "mixed-axes":
        dk = classes[3][cl > 0]
        assert sorted(dk.tolist()) == [0, 1] and classes[2][cl > 0].all()
    if case.startswith("diverse"):
        assert (cl == 0).any(), "no padding class"
        assert statics["has_contrib"] and statics["has_domains"]
    if nodes:
        assert int(np.asarray(j[1]).sum()) > 0, "no existing-node fill"


# -- TorchSolver vs TpuSolver, classed True / False / auto -----------------------


SOLVER_CASES = {
    "diverse-300x40": lambda: dict(pods=diverse_reference_mix(300), n_types=40),
    "diverse-150x80": lambda: dict(pods=diverse_reference_mix(150), n_types=80),
    "constrained-400": lambda: dict(pods=constrained_mix(400), n_types=40),
    "mixed-500": lambda: dict(pods=mixed_pods(500), n_types=40),
    "spot-od-300": lambda: dict(pods=mixed_pods(300), n_types=40, pools=spot_od_pools()),
    "identical-200": lambda: dict(pods=[_pod(f"p-{i}", 500, 512) for i in range(200)]),
    "hostname-anti-affinity": lambda: dict(pods=_anti_affinity()),
    "same-class-selectors": lambda: dict(pods=_zonal_selectors()),
    "mixed-domain-axes": lambda: dict(pods=_mixed_axes()),
    "contributors-interleave": lambda: dict(pods=_contributors()),
    "zonal-self-affinity": lambda: dict(pods=_zonal_affinity()),
    "existing-nodes": lambda: dict(pods=diverse_reference_mix(120),
                                   state_nodes=_zonal_nodes(4)),
    "overflow-retry": lambda: dict(pods=diverse_reference_mix(200), max_claims=8),
}


def _solve_both(monkeypatch, case, classed):
    """Both packages' solvers over the same batch with ``classed``; returns
    ({pkg: signature}, {pkg: [routes]}), a route being the class arrays the
    solver's _classed_partition returned (None: the per-group scan)."""
    from karpenter_tpu.solver.example import example_nodepool
    from test_torch_residency import port_state_node, signature, to_port

    monkeypatch.delenv("KTPU_CLASSED", raising=False)
    spec = SOLVER_CASES[case]()
    got, routes = {}, {}
    for pkg in PKGS:
        tpkg = pkg == "karpenter_tpu_torch"
        conv = to_port if tpkg else (lambda x: x)
        drv = _mod(pkg, "solver.driver")
        cls = drv.TorchSolver if tpkg else drv.TpuSolver
        routes[pkg] = []
        orig = cls._classed_partition

        def spy(self, snap_run, res_cap0, _orig=orig, _out=routes[pkg]):
            out = _orig(self, snap_run, res_cap0)
            _out.append(None if out is None else (
                [np.asarray(x).tolist() for x in out[0]], out[1]))
            return out

        monkeypatch.setattr(cls, "_classed_partition", spy)
        pools = [conv(p) for p in spec.get("pools") or [example_nodepool()]]
        its = {p.name: _mod(pkg, "cloudprovider.corpus").generate(spec.get("n_types", 30))
               for p in pools}
        nodes = list(spec.get("state_nodes", ()))
        if tpkg:
            nodes = [port_state_node(sn) for sn in nodes]
        batch = [conv(p) for p in spec["pods"]]
        kube = _mod(pkg, "kube")
        topo = _mod(pkg, "scheduling.topology").Topology(
            kube.Client(kube.TestClock()), nodes, pools, its, batch)
        cfg = dict(classed=classed, max_claims=spec.get("max_claims"))
        if tpkg:
            cfg["device"] = "cpu"
        solver = cls(pools, its, topo, state_nodes=nodes,
                     config=drv.SolverConfig(**cfg), encode_cache=drv.EncodeCache())
        got[pkg] = signature(solver.solve(batch))
        assert solver.fallback_solves == 0
    return got, routes


@pytest.mark.parametrize("classed", [True, False, None], ids=["classed", "per-group", "auto"])
@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_equals_tpu_solver(monkeypatch, case, classed):
    got, routes = _solve_both(monkeypatch, case, classed)
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert routes["karpenter_tpu_torch"] == routes["karpenter_tpu"]
    assert routes["karpenter_tpu"], "the fast path never routed"
    if classed is False:
        assert all(r is None for r in routes["karpenter_tpu"])
    if classed is True:
        assert all(r is not None for r in routes["karpenter_tpu"])


@pytest.mark.parametrize("case,expect_classed", [
    ("diverse-300x40", True), ("mixed-500", False),
], ids=["diverse-routes-classed", "mixed-routes-per-group"])
def test_routing_heuristic(monkeypatch, case, expect_classed):
    """Auto mode: the diverse mix (~60 groups per class) takes the classed
    scan, a batch whose every group is its own class the per-group scan,
    in both packages."""
    _, routes = _solve_both(monkeypatch, case, None)
    for pkg in PKGS:
        assert routes[pkg] and (routes[pkg][-1] is not None) is expect_classed

