"""Port parity for the relaxation bulk pre-solver (ops/relax.py), on the CPU.

The suite of tests/test_relax.py runs through both packages:
TorchSolver(device="cpu") against TpuSolver with the same ``relax``
setting, the claim lists compared **in slot order** (pool, sorted pod
names, type names: decode mints claim identities from slot order, and
the relaxed bulk's claims follow the exact residual's), with equal relax
telemetry (``last_relax_pods/claims/residual_pods``, ``relax_rejects``).
A relax-on solve and a relax-off solve of the port decide alike as
multisets. The default config takes the relax route in both packages
(JAX's ``relax=None``, KTPU_RELAX unset; the port's ``relax=None``).

The ops functions are held against their JAX counterparts field by field:
``plan_bulk`` and ``solve_bulk`` on the same snapshots, and
``relax_fill_reference`` (the plain version of kernel B9) against JAX's
jitted ``relax_fill`` on seeded random inputs with infeasible (n_per 0)
rows, padding slots, n_per = 2**30 and wrapping windows. Tolerance: exact
equality everywhere (bool and int32 outputs; the head tables' fits_count
is bit-exact float32).

Pods come from the JAX test builders of tests/test_relax.py and are
rebuilt from the port's classes (``to_port``), keeping names and uids.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from test_relax import ZONES, _partial_pods, _pod, _separable_pods
from test_torch_residency import to_port

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _solver(pkg, pods, relax, n_types=24, cache=None):
    """A solver of package ``pkg`` over ``pods`` (JAX objects; rebuilt
    from the port's classes for the port) and one default NodePool."""
    corpus = _mod(pkg, "cloudprovider.corpus")
    kube = _mod(pkg, "kube")
    drv = _mod(pkg, "solver.driver")
    pools = [_mod(pkg, "solver.example").example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}
    if pkg == "karpenter_tpu_torch":
        pods = to_port(pods)
        config = drv.SolverConfig(device="cpu", relax=relax)
    else:
        config = drv.SolverConfig(relax=relax)
    topology = _mod(pkg, "scheduling.topology").Topology(
        kube.Client(kube.TestClock()), [], pools, its, pods)
    solver = getattr(drv, "TpuSolver" if pkg == "karpenter_tpu" else "TorchSolver")(
        pools, its, topology, config=config, encode_cache=cache or drv.EncodeCache())
    return solver, pods


def slots(results):
    """Claims in slot order (pool, sorted pod names, type names) and the
    erroring pods' names."""
    claims = [
        (c.template.node_pool_name,
         tuple(sorted(p.metadata.name for p in c.pods)),
         tuple(it.name for it in c.instance_type_options))
        for c in results.new_node_claims
    ]
    return claims, sorted(results.pod_errors)


def telemetry(solver):
    return (solver.last_relax_pods, solver.last_relax_claims,
            solver.last_relax_residual_pods, solver.relax_rejects)


def _solve(pkg, pods, relax, **kw):
    solver, pods = _solver(pkg, pods, relax, **kw)
    return solver, solver.solve(pods)


def _both(pods, relax, **kw):
    """(slots, telemetry) of TpuSolver and of TorchSolver; they must agree."""
    out = []
    for pkg in PKGS:
        s, r = _solve(pkg, pods, relax, **kw)
        out.append((slots(r), telemetry(s)))
    assert out[1] == out[0]
    return out[1]


def multiset(sl):
    claims, errors = sl
    return sorted((pool, pods, tuple(sorted(types))) for pool, pods, types in claims), errors


@pytest.fixture
def default_relax(monkeypatch):
    """TpuSolver's default reads KTPU_RELAX; unset, it is on."""
    monkeypatch.delenv("KTPU_RELAX", raising=False)


class TestSolverParity:
    @pytest.mark.parametrize("relax", [True, None])
    def test_separable_fully_routed(self, relax, default_relax):
        pods = _separable_pods()
        sl, tele = _both(pods, relax)
        assert tele == (len(pods), len(sl[0]), 0, 0)
        off, tele_off = _both(pods, False)
        assert tele_off == (0, 0, 0, 0)
        assert multiset(sl) == multiset(off)

    def test_partial_routing_residual_exact(self, default_relax):
        """A zone-a deployment routes; the zone-b anti-affinity residual
        rides the exact dispatch, whose claims come first in slot order."""
        pods = _partial_pods()
        sl, tele = _both(pods, None)
        assert tele == (300, len(sl[0]) - 40, 40, 0)
        assert all(c[1][0].startswith("anti-") for c in sl[0][:40])
        off, _ = _both(pods, False)
        assert multiset(sl) == multiset(off)

    def test_zonal_partial_mix_slot_order(self, default_relax):
        """The zonal partial mix (chip_smoke phase 7c at 1/160 scale): pod
        i of three sizes selects zone a/b/c[i % 3], beside zone-b pods with
        hostname anti-affinity. The zone-a and zone-c runs route; zone b's
        run can share claims with the anti-affinity pods and stays exact.
        Exact claims first, then the bulk's: the slot order differs from a
        relax-off solve's (FFD order interleaves the runs there), and the
        default configs of both packages agree on it — the difference
        between the two packages' defaults this slice closes."""
        lbl = {"app": "solo"}
        pods = [_pod(f"z-{i}", (1 + i % 3) * 500, zone=ZONES[i % 3]) for i in range(300)]
        pods += [_pod(f"solo-{i}", 700, zone=ZONES[1], labels=lbl, anti=lbl)
                 for i in range(24)]
        sl, tele = _both(pods, None)
        assert tele[0] == 200 and tele[2] == 124 and tele[3] == 0
        off, _ = _both(pods, False)
        assert multiset(sl) == multiset(off)
        assert sl != off

    @pytest.mark.parametrize("mix", ["diverse", "constrained", "anti"])
    def test_reference_mixes_route_nothing(self, mix, default_relax):
        from karpenter_tpu.solver.workloads import constrained_mix, diverse_reference_mix

        if mix == "diverse":
            pods = diverse_reference_mix(250, seed=7)
        elif mix == "constrained":
            pods = constrained_mix(250, seed=5)
        else:
            lbl = {"app": "nginx"}
            pods = [_pod(f"an-{i}", 500, labels=lbl, anti=lbl) for i in range(60)]
        sl, tele = _both(pods, None)
        assert tele[0] == 0 and tele[1] == 0
        assert sl == _both(pods, False)[0]

    def test_mixed_shapes_same_selector_not_routed(self, default_relax):
        pods = [_pod(f"m-{i}", 500 + (i % 2) * 700, zone=ZONES[0]) for i in range(80)]
        sl, tele = _both(pods, None)
        assert tele == (0, 0, 0, 0)  # no plan: nothing counted, as in JAX
        assert sl == _both(pods, False)[0]

    def test_baseline_config0_default_configs(self, default_relax):
        """BASELINE config[0]: identical_pods(500) x corpus.generate(10),
        default configs on both sides: every pod routed, 34 claims, the
        same claims in the same slot order."""
        got = []
        for pkg in PKGS:
            wl = _mod(pkg, "solver.workloads")
            corpus = _mod(pkg, "cloudprovider.corpus")
            kube = _mod(pkg, "kube")
            drv = _mod(pkg, "solver.driver")
            pods = wl.identical_pods(500)
            pools = [_mod(pkg, "solver.example").example_nodepool()]
            its = {pools[0].name: corpus.generate(10)}
            topo = _mod(pkg, "scheduling.topology").Topology(
                kube.Client(kube.TestClock()), [], pools, its, pods)
            if pkg == "karpenter_tpu":
                s = drv.TpuSolver(pools, its, topo)
            else:
                s = drv.TorchSolver(pools, its, topo, config=drv.SolverConfig(device="cpu"))
            got.append((slots(s.solve(pods)), telemetry(s)))
        assert got[1] == got[0]
        assert got[1][1] == (500, 34, 0, 0) and len(got[1][0][0]) == 34

    def test_warm_churn_keeps_reuse_and_true_resident_counts(self, default_relax):
        """Only the dispatch's g_count is replaced: the warm staging still
        rides REUSE / row deltas, and the resident g_count buffer after a
        routed solve holds the true counts, not the zeroed ones."""
        drv_t = _mod("karpenter_tpu_torch", "solver.driver")
        drv_j = _mod("karpenter_tpu", "solver.driver")
        caches = {"karpenter_tpu": drv_j.EncodeCache(), "karpenter_tpu_torch": drv_t.EncodeCache()}
        pods = _separable_pods(300)
        ticks = [pods, pods, pods[:-6] + _separable_pods(300)[:6]]
        for tick in ticks:
            got = []
            for pkg in PKGS:
                s, r = _solve(pkg, tick, True, cache=caches[pkg])
                got.append((slots(r), telemetry(s), s._last_incremental))
            assert got[1] == got[0]
        assert got[1][1][0] == 300
        assert got[1][2], "relax broke the warm staging path"
        store = caches["karpenter_tpu_torch"].device_store
        resident = store._dev_buffers["g_count"].numpy()
        assert resident.sum() == 300 and resident.max() > 0

    def test_corrupt_bulk_sheds_to_full_exact(self, default_relax):
        """A bulk with zeroed fills fails conservation: the guard rejects
        the combined solve and the driver re-dispatches exact with the
        true counts, deciding as a relax-off solve."""
        def corrupt(bulk):
            n_r, r_pool, r_tmask, r_fills, r_unplaced = bulk
            return (n_r, r_pool, r_tmask, np.zeros_like(r_fills), r_unplaced)

        pods = _separable_pods(240)
        got = []
        for pkg in PKGS:
            faults = _mod(pkg, "faults")
            inj = faults.install(faults.FaultInjector(
                [faults.FaultRule(faults.RELAX_OUTPUT, mutate=corrupt)]))
            try:
                s, r = _solve(pkg, pods, True)
            finally:
                faults.uninstall()
            assert inj.fired(faults.RELAX_OUTPUT) == 1
            got.append((slots(r), telemetry(s)))
        assert got[1] == got[0]
        assert got[1][1] == (0, 0, 0, 1)
        assert got[1][0] == _both(pods, False)[0]


class TestRejectOrder:
    """A relax rejection is handled inside the relax block: the exact
    re-dispatch runs on the same (warm) staging, and only that re-solve's
    own guard failure reaches _solve_routed's delta fallback."""

    def _warm_solver(self, pods):
        drv = _mod("karpenter_tpu_torch", "solver.driver")
        cache = drv.EncodeCache()
        _solve("karpenter_tpu_torch", pods, None, cache=cache)
        solver, port_pods = _solver("karpenter_tpu_torch", pods, None, cache=cache)
        calls = []
        inner = solver._delta_fallback
        solver._delta_fallback = lambda reason: (calls.append(reason), inner(reason))
        return solver, port_pods, calls

    @staticmethod
    def _zero_fills(bulk):
        n_r, r_pool, r_tmask, r_fills, r_unplaced = bulk
        return (n_r, r_pool, r_tmask, np.zeros_like(r_fills), r_unplaced)

    @staticmethod
    def _zero_exact_fills(out):
        out = list(out)
        out[5] = torch.zeros_like(out[5])  # claim_fills of the exact dispatch
        return tuple(out)

    def test_relax_reject_never_reaches_the_delta_fallback(self):
        from karpenter_tpu_torch import faults

        pods = _separable_pods(240)
        solver, port_pods, calls = self._warm_solver(pods)
        faults.install(faults.FaultInjector(
            [faults.FaultRule(faults.RELAX_OUTPUT, mutate=self._zero_fills)]))
        try:
            r = solver.solve(port_pods)
        finally:
            faults.uninstall()
        assert solver._last_incremental and not calls
        assert telemetry(solver) == (0, 0, 0, 1)
        assert multiset(slots(r)) == multiset(_both(pods, False)[0])

    def test_exact_resolve_rejection_reaches_the_delta_fallback(self):
        """The bulk is rejected, then the exact re-dispatch's output is
        corrupt too: that rejection sheds the warm state and the solve
        runs once more from a full re-encode, relax-routed again."""
        from karpenter_tpu_torch import faults

        pods = _separable_pods(240)
        solver, port_pods, calls = self._warm_solver(pods)
        inj = faults.install(faults.FaultInjector([
            faults.FaultRule(faults.RELAX_OUTPUT, mutate=self._zero_fills, times=1),
            # the first SOLVER_OUTPUT is the routed dispatch (zeroed counts),
            # the second the exact re-dispatch after the relax rejection
            faults.FaultRule(faults.SOLVER_OUTPUT, mutate=self._zero_exact_fills,
                             after=1, times=1),
        ]))
        try:
            r = solver.solve(port_pods)
        finally:
            faults.uninstall()
        assert len(calls) == 1
        assert inj.fired(faults.SOLVER_OUTPUT) == 1 and inj.fired(faults.RELAX_OUTPUT) == 1
        assert solver.relax_rejects == 1 and solver.last_relax_pods == 240
        assert multiset(slots(r)) == multiset(_both(pods, False)[0])


# -- the ops functions against JAX's -------------------------------------------


def _snapshot(pkg, pods, n_types=24):
    """(snap_run, res_cap0, n_exist) as the driver builds them."""
    solver, pods = _solver(pkg, pods, None, n_types=n_types)
    enc = _mod(pkg, "solver.encode")
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    assert not rest
    snap, (_, res_cap0, _), *_ = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    return snap.padded(G, 0), res_cap0, len(snap.existing_names)


PLAN_FIELDS = ("easy_gids", "ge_run", "run_head", "ge_count", "ge_a", "run_total",
               "easy_pods")
SNAPSHOTS = {
    "separable": lambda: _separable_pods(90),
    "partial": lambda: _partial_pods(60, 12),
    "config0": lambda: [_pod(f"ident-{i}", 1000) for i in range(500)],
    "mixed_shapes": lambda: [_pod(f"m-{i}", 500 + (i % 2) * 700, zone=ZONES[0])
                             for i in range(40)],
    "anti": lambda: [_pod(f"an-{i}", 500, labels={"a": "b"}, anti={"a": "b"})
                     for i in range(20)],
}


@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_plan_and_solve_bulk_match_jax(case):
    from karpenter_tpu.ops import relax as jr
    from karpenter_tpu_torch.ops import relax as tr

    pods = SNAPSHOTS[case]()
    snaps = {pkg: _snapshot(pkg, pods) for pkg in PKGS}
    plans = {}
    for pkg, mod in zip(PKGS, (jr, tr)):
        run, res_cap0, n_exist = snaps[pkg]
        plans[pkg] = mod.plan_bulk(run, res_cap0=res_cap0, n_exist=n_exist)
    pj, pt = plans["karpenter_tpu"], plans["karpenter_tpu_torch"]
    assert (pj is None) == (pt is None)
    if case in ("mixed_shapes", "anti"):
        assert pt is None
        return
    for f in PLAN_FIELDS:
        j, t = np.asarray(getattr(pj, f)), np.asarray(getattr(pt, f))
        assert j.dtype == t.dtype and j.shape == t.shape, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    bj = jr.solve_bulk(pj, snaps["karpenter_tpu"][0])
    bt = tr.solve_bulk(pt, snaps["karpenter_tpu_torch"][0], "cpu")
    assert bt[0] == bj[0] > 0
    for name, j, t in zip(("c_pool", "c_tmask", "claim_fills", "unplaced"), bj[1:], bt[1:]):
        j = np.asarray(j)
        assert j.dtype == t.dtype and j.shape == t.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)


def _fill_inputs(seed, GE=12, NR=64, T=20, P=3, CRp=4):
    """Seeded relax_fill inputs (ge, cl, type_ok, n_fit, n_r) with
    infeasible rows (n_per 0), padding groups and slots (count and fill
    0, slots past n_r), n_per = 2**30 (fits_count's unbounded), offsets
    whose windows leave int32, and slots reading every row of the head
    tables."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    ge = np.stack([
        rng.integers(0, 60, GE),  # count
        rng.integers(0, 200, GE),  # a
        rng.integers(0, NR, GE),  # off
        rng.integers(1, 40, GE),  # n_per
        rng.integers(0, 6, GE),  # kc
    ]).astype(i32)
    ge[0, -2:] = 0  # padding groups
    ge[1, 3] = 2**31 - 20  # hi = a + count wraps
    ge[3, [1, 5]] = 0  # no feasible template
    ge[3, [2, 6, 7]] = 2**30  # rel * n_per leaves int32 on most slots
    ge[4, 6] = 3  # kept lanes past the first window wrap in JAX too
    cl = np.stack([
        rng.integers(0, P, NR),  # pool
        rng.integers(0, 50, NR),  # fill
        rng.integers(0, CRp, NR),  # run
    ]).astype(i32)
    cl[1, -5:] = 0  # padding slots
    type_ok = rng.random((P, CRp, T)) < 0.7
    n_fit = rng.integers(0, 60, (P, CRp, T)).astype(i32)
    n_fit[0, 0, :3] = 2**30
    return ge, cl, type_ok, n_fit, NR - 5


def _gathered(ge, cl, type_ok, n_fit, n_r):
    """JAX relax_fill's nine inputs from B9's: the [NR, T] rows gathered
    on the host, as karpenter_tpu/ops/relax.py:solve_bulk gathers them
    (cl_avail False past n_r)."""
    pool, fill, run = cl
    cl_avail = type_ok[pool, run]
    cl_avail[n_r:] = False
    return (*ge, pool, fill, cl_avail, n_fit[pool, run])


def _assert_fill_equal(want, got):
    for name, w, g in zip(("claim_fills", "c_tmask", "c_pool", "unplaced"), want, got):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_relax_fill_reference_matches_jax(seed):
    """B9's plain version (its gather included) against JAX's relax_fill
    fed the host-gathered rows."""
    from karpenter_tpu.ops.relax import _jit_relax_fill
    from karpenter_tpu_torch.ops.relax import relax_fill, relax_fill_reference

    ge, cl, type_ok, n_fit, n_r = _fill_inputs(seed)
    want = [np.asarray(x) for x in _jit_relax_fill()(*_gathered(ge, cl, type_ok, n_fit, n_r))]
    tin = [torch.from_numpy(x) for x in (ge, cl, type_ok, n_fit)]
    for fn in (relax_fill_reference, relax_fill):  # the wrapper on CPU tensors
        _assert_fill_equal(want, fn(*tin, n_r))
    assert (want[0] > 0).any() and (want[3] > 0).any()  # not vacuous


def _bulk_plan(run_sizes, GE_pad):
    """A BulkPlan over runs of ``run_sizes`` group counts (pods per group
    1 + its index), as plan_bulk lays them out; the group ids run to
    GE_pad so the easy axis pads to a power of two."""
    from karpenter_tpu_torch.ops.relax import BulkPlan

    ge_run = np.repeat(np.arange(len(run_sizes)), run_sizes).astype(np.int32)
    ge_count = (1 + np.arange(len(ge_run))).astype(np.int64)
    cum = np.cumsum(ge_count) - ge_count
    first = np.unique(ge_run, return_index=True)[1]
    ge_a = cum - cum[first][ge_run]
    return BulkPlan(
        easy_gids=np.arange(len(ge_run), dtype=np.int32) * (GE_pad // max(len(ge_run), 1)),
        ge_run=ge_run, run_head=first.astype(np.int32), ge_count=ge_count, ge_a=ge_a,
        run_total=np.bincount(ge_run, weights=ge_count).astype(np.int64),
        easy_pods=int(ge_count.sum()))


def _jax_fill_inputs(plan, type_ok, n_fit):
    """(n_r, JAX relax_fill's nine inputs) from the head tables, the host
    steps of karpenter_tpu/ops/relax.py:solve_bulk line for line."""
    from karpenter_tpu.solver import encode as jenc

    CRr = len(plan.run_head)
    type_ok, n_fit = type_ok[:, :CRr], n_fit[:, :CRr]
    feas_p = type_ok.any(axis=2)
    any_feas = feas_p.any(axis=0)
    p_star = np.argmax(feas_p, axis=0)
    avail = type_ok[p_star, np.arange(CRr)]
    nf = n_fit[p_star, np.arange(CRr)]
    n_per = np.where(any_feas, np.where(avail, nf, 0).max(axis=1), 0).astype(np.int64)
    kc = np.zeros((CRr,), np.int64)
    live = n_per > 0
    kc[live] = -(-plan.run_total[live] // n_per[live])
    off = np.cumsum(kc) - kc
    n_r = int(kc.sum())
    GE = jenc._next_pow2(len(plan.easy_gids), floor=1)
    NR = jenc._next_pow2(max(n_r, 1), floor=1)

    def padg(a):
        out = np.zeros((GE,), a.dtype)
        out[: len(a)] = a
        return out

    cl_run = np.zeros((NR,), np.int64)
    if n_r:
        cl_run[:n_r] = np.repeat(np.arange(CRr), kc)
    last = np.arange(NR) - off[cl_run] == kc[cl_run] - 1
    cl_fill = np.where(last, plan.run_total[cl_run] - (kc[cl_run] - 1) * n_per[cl_run],
                       n_per[cl_run])
    cl_fill[n_r:] = 0
    cl_avail = avail[cl_run]
    cl_avail[n_r:] = False
    return n_r, (
        padg(plan.ge_count.astype(np.int32)), padg(plan.ge_a.astype(np.int32)),
        padg(off[plan.ge_run].astype(np.int32)), padg(n_per[plan.ge_run].astype(np.int32)),
        padg(kc[plan.ge_run].astype(np.int32)), p_star[cl_run].astype(np.int32),
        cl_fill.astype(np.int32), cl_avail, nf[cl_run].astype(np.int32))


# (runs' group counts, P, T): the padded easy axis of tests/test_relax.py's
# shapes, a run per template, and one run of groups with no request
FILL_CASES = {
    "one-run": ((3,), 1, 24),
    "three-runs": ((2, 1, 4), 2, 24),
    "padded-heads": ((1, 2, 1, 1, 2), 3, 30),
}


@pytest.mark.parametrize("unbounded", [False, True])
@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_fill_args_and_relax_fill_match_jax(case, unbounded):
    """fill_args then B9's plain version on seeded head tables (CRp past
    the runs, one run without a feasible template, padding slots) against
    JAX's host steps then relax_fill; ``unbounded`` gives one run
    fits_count's 2**30 pods per claim (groups without requests), where
    rel * n_per wraps int32 on every slot outside the run."""
    from karpenter_tpu.ops.relax import _jit_relax_fill
    from karpenter_tpu_torch.ops.relax import fill_args, fill_inputs, relax_fill_reference
    from karpenter_tpu_torch.solver import encode as tenc

    runs, P, T = FILL_CASES[case]
    plan = _bulk_plan(runs, tenc._next_pow2(sum(runs) + 1, floor=1))
    CRp = tenc._next_pow2(len(runs) + 1, floor=1)
    rng = np.random.default_rng(len(runs) * 10 + P + unbounded)
    type_ok = rng.random((P, CRp, T)) < 0.5
    n_fit = rng.integers(1, 5, (P, CRp, T)).astype(np.int32)
    dead = len(runs) > 1  # the last run has no feasible template
    if dead:
        type_ok[:, len(runs) - 1] = False
    if unbounded:
        n_fit[:, 0] = 2**30
    n_r, want_in = _jax_fill_inputs(plan, type_ok, n_fit)
    want = [np.asarray(x) for x in _jit_relax_fill()(*want_in)]
    got_nr, ge, cl = fill_args(plan, type_ok, n_fit)
    assert got_nr == n_r > 0
    _assert_fill_equal(want, relax_fill_reference(
        *fill_inputs(ge, cl, "cpu"), torch.from_numpy(type_ok), torch.from_numpy(n_fit), n_r))
    ge_n = len(plan.easy_gids)
    assert want[3][ge_n - runs[-1]:ge_n].all() == dead  # the dead run is unplaced
    assert want[0].sum() == plan.run_total[:len(runs) - dead].sum()  # every other pod placed
