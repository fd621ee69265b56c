"""Port parity on wide value vocabularies (ROADMAP §C1), on the CPU.

V1, the padded value axis, is pow2(most values of any one key + 1): a
per-team label with more than 1,023 values takes it to 2,048. The JAX
package is the reference; the port's plain versions (the ones the CUDA
kernels are held to bit for bit on the card, tests/test_torch_cuda.py)
must take any width. Held here, inputs from numpy seeds, exact equality:

- B1's and B2's plain versions (the sparse tables) and B3's (the dense
  ones) against the JAX functions at K = 16, V1 = 2,048;
- the scans' plain versions (B4 through solve_core, and B5 through
  TorchSolver's classed route) against JAX on a domain batch at V1 =
  2,048 whose zone key has few values while the team key has 1,100, with
  a zone value outside the catalog (an In on a zone no type offers, a
  NotIn over every offered zone: the OVERFLOW slot) and a node in that
  zone;
- ``TorchSolver(device="cpu")`` against ``TpuSolver`` in slot order on
  two inputs of ROADMAP §C1: a NodePool listing 1,100 teams with 40 pods
  (padded shape (16, 2048)), and minValues 2 on the instance type over a
  catalog of 1,100 types at mixed_pods(2000) (minValues axis MW 2048).

The 1,100-pod per-team input (about 170 s on the CPU) runs on the card
(chip_smoke.py phase 10), not here.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import feasibility as jf
from karpenter_tpu_torch.ops import feasibility as tf
from test_torch_cuda import B1_NAMES, B2_NAMES, random_tables, sparse_index_case

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")
TEAM_KEY = "example.com/team"
N_TEAMS = 1_100


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _same(name, jax_out, torch_out):
    j, t = np.asarray(jax_out), torch_out.numpy()
    assert t.shape == j.shape and t.dtype == j.dtype, name
    mism = np.argwhere(t != j)
    assert not mism.size, f"{name} diverges at {mism[:5].tolist()}"


def _t(a, names):
    return [torch.from_numpy(np.ascontiguousarray(a[n])) for n in names]


# -- the tables: B1 and B2 (sparse), B3 (dense) ----------------------------------


def test_sparse_tables_at_v1_2048():
    """B1's and B2's plain versions against JAX at K = 16, V1 = 2,048 over
    a reordered live-pair index (the card's INDEX_CASES entry)."""
    a, zk, ck = sparse_index_case("vocab-2048")
    assert a["g_mask"].shape[1:] == (16, 2048)
    j_out = jf.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    t_out = tf.fresh_claim_feasibility_sparse(*_t(a, B1_NAMES), zone_kid=zk, ct_kid=ck)
    for name, jo, to in zip(("compat_pg", "type_ok", "n_fit"), j_out, t_out):
        _same(name, jo, to)
    assert t_out[1].any() and not t_out[1].all()
    j_cap = jf.existing_node_feasibility_sparse(*(a[n] for n in B2_NAMES))
    t_cap = tf.existing_node_feasibility_sparse(*_t(a, B2_NAMES))
    _same("cap_ng", j_cap, t_cap)
    assert int(t_cap.max()) > 0


B3_NAMES = B1_NAMES[:17]
B3E_NAMES = B2_NAMES[:9] + ("well_known",)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_tables_at_v1_2048(seed):
    """B3's two plain versions against JAX's dense tables at K = 16, V1 =
    2,048, on random requirement rows (masks 70% set, so keys overlap
    and miss), two templates."""
    a = random_tables(np.random.default_rng([11, seed]), P=2, G=12, T=20, N=6, K=16, V1=2048,
                      R=3, O=4)
    kw = dict(zone_kid=1, ct_kid=2)
    j_out = jf.fresh_claim_feasibility(*(a[n] for n in B3_NAMES), **kw)
    t_out = tf.fresh_claim_feasibility_reference(*_t(a, B3_NAMES), **kw)
    for name, jo, to in zip(("compat_pg", "type_ok", "n_fit"), j_out, t_out):
        _same(name, jo, to)
    assert t_out[0].any() and t_out[1].any()
    _same("cap_ng", jf.existing_node_feasibility(*(a[n] for n in B3E_NAMES)),
          tf.existing_node_feasibility_reference(*_t(a, B3E_NAMES)))


# -- the scans on a domain batch at V1 = 2048 -------------------------------------

ZONES = ("test-zone-a", "test-zone-b", "test-zone-c")
OUTSIDE = "zone-outside"


def _team_pool(pkg, values=None):
    """A NodePool whose one requirement is the team key: Exists, or In
    ``values``."""
    objs = _mod(pkg, "api.objects")
    req = (objs.NodeSelectorRequirement(TEAM_KEY, "Exists", ()) if values is None
           else objs.NodeSelectorRequirement(TEAM_KEY, "In", tuple(values)))
    return objs.NodePool(metadata=objs.ObjectMeta(name="default"), spec=objs.NodePoolSpec(
        template=objs.NodeClaimTemplate(spec=objs.NodeClaimSpec(requirements=[req]))))


def _domain_batch(pkg):
    """Zonal self-spread pods, pods of three teams, a pod pinned to a zone
    no type offers and one excluded from every offered zone, over a pool
    listing 1,100 teams, with three nodes in zone a, zone b and the
    outside zone."""
    objs = _mod(pkg, "api.objects")
    labels = _mod(pkg, "api.labels")
    wl = _mod(pkg, "solver.workloads")

    def zone_req(op, values):
        return objs.NodeAffinity(required=[(
            objs.NodeSelectorRequirement(labels.TOPOLOGY_ZONE, op, tuple(values)),)])

    sel = objs.LabelSelector(match_labels={"app": "zs"})
    pods = [wl._pod(f"zs-{i}", 500, 512, labels={"app": "zs"},
                    topology_spread_constraints=[objs.TopologySpreadConstraint(
                        max_skew=1, topology_key=labels.TOPOLOGY_ZONE,
                        when_unsatisfiable="DoNotSchedule", label_selector=sel)])
            for i in range(9)]
    pods += [wl._pod(f"team-{i}", 250 * (1 + i % 3), 1024,
                     node_selector={TEAM_KEY: f"team-{i % 3}"}) for i in range(12)]
    pods.append(wl._pod("outside-in", 500, 1024, node_affinity=zone_req("In", (OUTSIDE,))))
    pods.append(wl._pod("outside-notin", 500, 1024, node_affinity=zone_req("NotIn", ZONES)))
    return pods


def _nodes(pkg):
    from test_torch_solver import _state_nodes

    labels = _mod(pkg, "api.labels")
    nodes = _state_nodes(pkg, 3)
    for sn, zone in zip(nodes, ("test-zone-a", "test-zone-b", OUTSIDE)):
        sn.node.metadata.labels[labels.TOPOLOGY_ZONE] = zone
    return nodes


def _solver(pkg, pools, its, pods, nodes=(), **cfg):
    kube = _mod(pkg, "kube")
    drv = _mod(pkg, "solver.driver")
    its_by_pool = {p.name: list(its) for p in pools}
    topo = _mod(pkg, "scheduling.topology").Topology(
        kube.Client(kube.TestClock()), list(nodes), pools, its_by_pool, pods)
    if pkg == "karpenter_tpu":
        return drv.TpuSolver(pools, its_by_pool, topo, state_nodes=list(nodes),
                             config=drv.SolverConfig(**cfg))
    return drv.TorchSolver(pools, its_by_pool, topo, state_nodes=list(nodes),
                           config=drv.SolverConfig(device="cpu", **cfg))


def test_scan_domain_batch_at_v1_2048():
    """B4's plain version (solve_core on CPU tensors) against JAX's
    solve_all on the domain batch encoded by the JAX package at V1 =
    2,048: every output, the claims' domains (c_dzone) included."""
    from karpenter_tpu.ops.solve import solve_all
    from karpenter_tpu.solver import encode as enc
    from karpenter_tpu_torch.ops.solve import solve_core
    from karpenter_tpu_torch.solver.args import to_device_args

    corpus = _mod("karpenter_tpu", "cloudprovider.corpus")
    pods = _domain_batch("karpenter_tpu")
    solver = _solver("karpenter_tpu", [_team_pool("karpenter_tpu",
                                                  [f"team-{i}" for i in range(N_TEAMS)])],
                     corpus.generate(20), pods, _nodes("karpenter_tpu"))
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    assert not rest
    snap, avail, *_ = solver._encode_batch(groups)
    assert snap.vocab.padded_shape()[1] == 2048
    zone_vals = snap.vocab.values[snap.vocab.key_ids[_mod("karpenter_tpu", "api.labels")
                                                     .TOPOLOGY_ZONE]]
    assert OUTSIDE in zone_vals and len(zone_vals) < 8
    G = enc._next_pow2(len(snap.groups), floor=8)
    statics = solver._kernel_statics(snap, G)
    statics.update(nmax=64, wf_iters=16, sparse_groups=True)
    assert statics["has_domains"]
    args = snap.padded(G, 4).solve_args(*avail)
    j_out = [np.asarray(x) for x in jax.device_get(solve_all(*args, **statics))]
    t_out = solve_core(*to_device_args(args, "cpu"), **statics)
    for i, (j, t) in enumerate(zip(j_out, t_out)):
        t = t.numpy()
        assert t.shape == j.shape, i
        assert not np.argwhere(t.astype(j.dtype) != j).size, f"output {i}"
    assert int(j_out[2]) > 0 and (j_out[7][: int(j_out[2])] >= 0).any()


def _snapshot(solver, pods):
    """The port solver's encoded snapshot of ``pods``, as its solve builds it."""
    from karpenter_tpu_torch.solver import encode as enc

    groups, _ = enc.partition_and_group(pods, topology=solver.oracle.topology)
    return solver._encode_batch(groups)[0]


def _decisions(results, pods):
    from test_torch_solver import decisions

    return decisions(results, pods)


@pytest.mark.parametrize("classed", [False, True], ids=["per-group", "classed"])
def test_solver_domain_batch_at_v1_2048(classed):
    """TorchSolver(device="cpu") against TpuSolver on the domain batch, B4
    and B5's plain versions by the route, claims in slot order; the pod
    pinned to the zone no type offers lands on the node there."""
    got = {}
    for pkg in PKGS:
        corpus = _mod(pkg, "cloudprovider.corpus")
        pods = _domain_batch(pkg)
        s = _solver(pkg, [_team_pool(pkg, [f"team-{i}" for i in range(N_TEAMS)])],
                    corpus.generate(20), pods, _nodes(pkg), classed=classed)
        got[pkg] = _decisions(s.solve(pods), pods)
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    claims, existing, _ = got["karpenter_tpu"]
    assert claims and any("outside-in" in pods for _, pods in existing)


# -- TorchSolver against TpuSolver on ROADMAP §C1's inputs ------------------------


def test_solver_team_in_list():
    """A NodePool listing 1,100 teams (``example.com/team In [team-0 ..
    team-1099]``) with 40 pods, pod i selecting team-i: padded shape
    (16, 2048), 40 claims, the same decisions in slot order."""
    got = {}
    for pkg in PKGS:
        corpus = _mod(pkg, "cloudprovider.corpus")
        wl = _mod(pkg, "solver.workloads")
        pods = [wl._pod(f"team-{i}", 500, 1024, node_selector={TEAM_KEY: f"team-{i}"})
                for i in range(40)]
        s = _solver(pkg, [_team_pool(pkg, [f"team-{i}" for i in range(N_TEAMS)])],
                    corpus.generate(400), pods)
        got[pkg] = _decisions(s.solve(pods), pods)
        if pkg == "karpenter_tpu_torch":
            assert _snapshot(s, pods).vocab.padded_shape() == (16, 2048)
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert len(got["karpenter_tpu"][0]) == 40 and not got["karpenter_tpu"][2]


def test_solver_instance_type_minvalues_1100_types():
    """minValues 2 on the instance type over 1,100 types (a floor over a
    catalog wider than 1,024 values: MW 2048) at mixed_pods(2000): the
    same decisions in slot order."""
    got = {}
    for pkg in PKGS:
        corpus = _mod(pkg, "cloudprovider.corpus")
        labels = _mod(pkg, "api.labels")
        objs = _mod(pkg, "api.objects")
        pool = objs.NodePool(metadata=objs.ObjectMeta(name="default"), spec=objs.NodePoolSpec(
            template=objs.NodeClaimTemplate(spec=objs.NodeClaimSpec(requirements=[
                objs.NodeSelectorRequirement(labels.INSTANCE_TYPE, "Exists", (),
                                             min_values=2)]))))
        pods = _mod(pkg, "solver.workloads").mixed_pods(2000)
        s = _solver(pkg, [pool], corpus.generate(1100), pods)
        got[pkg] = _decisions(s.solve(pods), pods)
        if pkg == "karpenter_tpu_torch":
            assert _snapshot(s, pods).t_mvoh.shape[-1] == 2048
    assert got["karpenter_tpu_torch"] == got["karpenter_tpu"]
    assert got["karpenter_tpu"][0] and not got["karpenter_tpu"][2]


# -- the scans against JAX pack on the inputs of B4's Hopper redesign -------------
#
# csrc/pack_common.cuh builds the offering words across the card (one set a
# launch without a ledger, one a scenario with one, rebuilt from the
# reservations' words as they drain), walks only the zones and capacity
# types some offering names, and sizes a domain batch's claim-caps chunk to
# fit shared memory. tests/test_torch_cuda.py holds the kernels to
# pack_reference and pack_scenarios_reference on these inputs; here those
# plain versions are held to JAX pack on them. Tolerance: exact equality.


def _wide_ledger_args():
    """The domain batch at V1 2,048 (JAX objects) over a reserved catalog:
    capacity 1 in test-zone-a on every fourth of 20 types, so the first
    bulk that holds a reservation drains it mid-scan."""
    from test_torch_minvalues import snapshot
    from test_torch_reservations import reserved_types

    pkg = "karpenter_tpu"
    pools = [_team_pool(pkg, [f"team-{i}" for i in range(N_TEAMS)])]
    return snapshot(_domain_batch(pkg), pools, its=reserved_types(pkg, 20, 4, 1),
                    state_nodes=_nodes(pkg), reserved_capacity_enabled=True)


def _high_zone_args(n_zones=N_TEAMS):
    """A zone key of ``n_zones`` values (V1 2,048; JAX objects): pods
    requiring one of zone-0000 .. (registered first, in order), pods pinned
    to zone-1090, zonal self-spread pods and one pod excluded from every
    named zone, over corpus.generate(20) with types 3 and 11 also offering
    zone-1090 (a zone id near the top); then a_tzc with types 5 and 17
    offering the overflow slot V1 - 1 (tests/test_torch_cuda.py's
    _high_zone_catalog, in the JAX package's objects)."""
    from test_torch_minvalues import snapshot

    pkg = "karpenter_tpu"
    objs, labels = _mod(pkg, "api.objects"), _mod(pkg, "api.labels")
    corpus, wl = _mod(pkg, "cloudprovider.corpus"), _mod(pkg, "solver.workloads")
    zones = [f"zone-{i:04d}" for i in range(n_zones)]

    def zone_req(op, values):
        return objs.NodeAffinity(required=[(
            objs.NodeSelectorRequirement(labels.TOPOLOGY_ZONE, op, tuple(values)),)])

    its = corpus.generate(20)
    wide = corpus.generate(20, zones=(*ZONES, "zone-1090"))
    its[3], its[11] = wide[3], wide[11]
    sel = objs.LabelSelector(match_labels={"app": "zs"})
    pods = [wl._pod(f"any-{i}", 1500, 512, node_affinity=zone_req("In", zones))
            for i in range(4)]
    pods += [wl._pod(f"zs-{i}", 500, 512, labels={"app": "zs"},
                     topology_spread_constraints=[objs.TopologySpreadConstraint(
                         max_skew=1, topology_key=labels.TOPOLOGY_ZONE,
                         when_unsatisfiable="DoNotSchedule", label_selector=sel)])
             for i in range(6)]
    pods += [wl._pod(f"high-{i}", 250, 1024, node_affinity=zone_req("In", ("zone-1090",)))
             for i in range(3)]
    pods.append(wl._pod("unlisted", 250, 1024,
                        node_affinity=zone_req("NotIn", (*ZONES, *zones))))
    pool = objs.NodePool(metadata=objs.ObjectMeta(name="default"), spec=objs.NodePoolSpec())
    a, statics, classes = snapshot(pods, [pool], its=its)
    a = dict(a, a_tzc=np.array(a["a_tzc"]))
    for t in (5, 17):  # the first capacity type the type offers at all
        a["a_tzc"][t, -1, np.nonzero(a["a_tzc"][t].any(axis=0))[0][0]] = True
    return a, statics, classes


def test_pack_reference_ledger_drains_at_v1_2048():
    """pack_reference against JAX pack at V1 2,048 with domains and a
    reservation ledger whose reservations (capacity 1) drain mid-scan: the
    10 outputs, c_resv among them."""
    from test_torch_classed import _both_scans
    from test_torch_minvalues import assert_pack_equal

    a, statics, _ = _wide_ledger_args()
    assert a["g_mask"].shape[2] == 2048 and statics["has_domains"]
    assert a["res_cap0"].shape[0] > 0 and (a["res_cap0"] == 1).all()
    j, t = _both_scans(a, statics, nmax=64)
    assert_pack_equal(j, t)
    assert t[9].any() and int(t[2]) > 0


def test_pack_reference_top_zone_and_overflow():
    """pack_reference against JAX pack where the offerings name zone-1090
    (id near the top of 2,048) and the overflow slot V1 - 1: the 10
    outputs; a claim lands in zone-1090."""
    from test_torch_classed import _both_scans
    from test_torch_minvalues import assert_pack_equal

    a, statics, _ = _high_zone_args()
    V1 = a["g_mask"].shape[2]
    offered = np.nonzero(a["a_tzc"].any(axis=(0, 2)))[0]
    assert V1 == 2048 and statics["has_domains"]
    assert offered.max() == V1 - 1 and (offered >= 1024).sum() >= 2, offered
    j, t = _both_scans(a, statics, nmax=64)
    assert_pack_equal(j, t)
    assert (t[7][: int(t[2])] >= 1024).any()


@pytest.mark.parametrize("ledger", [False, True], ids=["shared-words", "per-scenario-words"])
def test_pack_scenarios_reference_at_v1_2048(ledger):
    """pack_scenarios_reference over 4 scenarios (3 real, group counts
    seeded with numpy) at V1 2,048 with domains, with and without a
    draining ledger, against JAX pack on each scenario's slice: every
    scenario replays the ledger from res_cap0."""
    import jax
    from karpenter_tpu.ops import packing as jpack
    from karpenter_tpu_torch.ops import packing as tp
    from karpenter_tpu_torch.ops.solve import pack_args
    from test_torch_classed import JAX_PACK_NAMES, TABLE_NAMES, _tables
    from test_torch_minvalues import assert_pack_equal, snapshot

    if ledger:
        a, statics, _ = _wide_ledger_args()
    else:
        pkg = "karpenter_tpu"
        pools = [_team_pool(pkg, [f"team-{i}" for i in range(N_TEAMS)])]
        a, statics, _ = snapshot(_domain_batch(pkg), pools,
                                 its=_mod(pkg, "cloudprovider.corpus").generate(20),
                                 state_nodes=_nodes(pkg))
    assert a["g_mask"].shape[2] == 2048 and statics["has_domains"]
    a = dict(a, **dict(zip(TABLE_NAMES, _tables(a, statics))))
    S, real = 4, 3
    rng = np.random.default_rng(20 + ledger)
    g_count = np.zeros((S,) + a["g_count"].shape, np.int32)
    for si in range(real):
        g_count[si] = rng.integers(0, a["g_count"] + 1)
    st = dict(nmax=64, zone_kid=statics["zone_kid"], ct_kid=statics["ct_kid"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"],
              wf_iters=statics["wf_iters"])
    ta = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    ta["g_count"] = torch.from_numpy(g_count)
    ta["cap_ng"] = ta["cap_ng"].expand(S, *ta["cap_ng"].shape).contiguous()
    port = tp.pack_scenarios_reference(*pack_args(ta, *(ta[n] for n in TABLE_NAMES)), **st)
    for si in range(S):
        j = jax.device_get(jpack.pack(*(g_count[si] if n == "g_count" else a[n]
                                        for n in JAX_PACK_NAMES), **st))
        assert_pack_equal(j, [x[si] for x in port])
    assert int(port[2][:real].max()) > 0 and (port[2][real:] == 0).all()
    if ledger:
        assert port[9][:real].any()


def test_scan_kernels_refuse_v1_not_a_multiple_of_4():
    """The scan kernels' input check (ops/packing.py:_check_scan_inputs)
    takes the encoder's V1 (a power of two of at least 4) and refuses one
    that is not a multiple of 4 before any launch: the kernels write the
    claims' masks four values a store."""
    from karpenter_tpu_torch.ops import packing as tp
    from karpenter_tpu_torch.ops.solve import pack_args
    from test_torch_classed import TABLE_NAMES, _tables
    from test_torch_minvalues import snapshot

    pkg = "karpenter_tpu"
    pool = _mod(pkg, "api.objects").NodePool(
        metadata=_mod(pkg, "api.objects").ObjectMeta(name="default"),
        spec=_mod(pkg, "api.objects").NodePoolSpec())
    a, statics, _ = snapshot(_mod(pkg, "solver.workloads").mixed_pods(20), [pool])
    a = dict(a, **dict(zip(TABLE_NAMES, _tables(a, statics))))
    ta = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    args = list(pack_args(ta, *(ta[n] for n in TABLE_NAMES)))
    g_mask = args[4]
    assert g_mask.shape[2] == 4
    # V1 4 passes the check and reaches the device's (CPU tensors launch nothing)
    with pytest.raises(ValueError, match="kernels take CUDA tensors"):
        tp._check_scan_inputs(args, False)
    for V1 in (3, 6, 10):
        args[4] = torch.ones(g_mask.shape[:2] + (V1,), dtype=torch.bool)
        with pytest.raises(ValueError, match=r"V1 % 4 == 0"):
            tp._check_scan_inputs(args, False)


@pytest.mark.parametrize("lead", [(), (4,)], ids=["one", "scenarios"])
def test_scan_buffers_zero_fills_and_offered_sets(lead):
    """The scan's buffers (ops/packing.py:_scan_buffers): the fills,
    unplaced and the offered sets [2, W] that offer_words ORs into start
    at zero, share one buffer on 256-byte boundaries without overlapping,
    and have their shapes; the offering words are one slice without a
    ledger and one a scenario with one."""
    from karpenter_tpu_torch.ops import packing as tp

    S = lead[0] if lead else 1
    for NRES in (0, 2):
        dims = dict(G=8, T=5, P=2, N=3, R=4, K=2, V1=2048, JH=1, JD=1, MV=0, MW=0, NRES=NRES,
                    O=2)
        state, words, _, outs = tp._scan_buffers(dims, S, 16, True, False, "cpu", lead=lead)
        W = 2048 // 32
        parts = outs[4:7] + (words[-1],)
        want = (lead + (8, 3), lead + (8, 16), lead + (8,), (2, W))
        assert [tuple(x.shape) for x in parts] == list(want)
        base = parts[0].untyped_storage().data_ptr()
        spans = []
        for x in parts:
            assert x.untyped_storage().data_ptr() == base and x.is_contiguous()
            assert x.dtype == torch.int32 and not x.any()
            off = x.data_ptr() - base
            assert off % 256 == 0
            spans.append((off, off + 4 * x.numel()))
        spans.sort()
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert state[13].shape == ((S if NRES else 1), 5, 2048, W)


# -- minValues at an instance-type floor over a wide catalog (MW 2048) -------------


@pytest.mark.parametrize("floor", [1, 2, 50, "above-MW"])
def test_minvalues_cap_at_mw_2048(floor):
    """The port's plain minvalues_cap (the scans' kernels are held to it on
    the card) against JAX's at MW 2,048 over 1,100 types: key 0 the
    instance type (each type its own value), key 1 a family key (37 values,
    ~30 types each); seeded masks and fits with ties; floors of 1, 2, 50
    and one past MW on both keys, on one key only, and none."""
    import jax.numpy as jnp
    from karpenter_tpu.ops.packing import minvalues_cap as jax_cap
    from karpenter_tpu_torch.ops.packing import minvalues_cap

    rng = np.random.default_rng(2048)
    T, MW = 1_100, 2_048
    t_mvoh = np.zeros((T, 2, MW), bool)
    t_mvoh[np.arange(T), 0, np.arange(T)] = True
    t_mvoh[np.arange(T), 1, np.arange(T) % 37] = True
    B = 6
    tmask = rng.random((B, T)) < np.array([0.9, 0.5, 0.05, 0.01, 0.9, 1.0])[:, None]
    fit = rng.choice([0, 1, 2, 3, 7, 40, 110, 2**20], size=(B, T)).astype(np.int32)
    fl = MW + 1 if floor == "above-MW" else floor
    floors = np.array([[fl, fl], [fl, 0], [0, fl], [fl, fl], [0, 0], [fl, 2]], np.int32)
    want = np.asarray(jax_cap(jnp.asarray(tmask), jnp.asarray(fit), jnp.asarray(floors),
                              jnp.asarray(t_mvoh)))
    got = minvalues_cap(torch.from_numpy(tmask), torch.from_numpy(fit),
                        torch.from_numpy(floors), torch.from_numpy(t_mvoh))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(want[4]) == 2**28  # no floor: no cap
    assert (floor != "above-MW") or not want[[0, 1, 2, 3, 5]].any()


def test_scan_buffers_minvalues_words_and_span():
    """The scans' minValues word table (ops/packing.py:_scan_buffers, built
    on the card by csrc/pack_common.cuh:static_words): [T, MV, MW / 32 + 1]
    int32, each (type, key) row's MW / 32 value words and the span of words
    that hold a value; empty without floors."""
    from karpenter_tpu_torch.ops import packing as tp

    for MV, MW in ((2, 2048), (1, 1024), (1, 24), (0, 0)):
        dims = dict(G=8, T=5, P=2, N=3, R=4, K=2, V1=4, JH=1, JD=1, MV=MV, MW=MW, NRES=0, O=2)
        _, words, _, _ = tp._scan_buffers(dims, 1, 16, False, False, "cpu")
        assert tuple(words[0].shape) == (5, MV, (MW + 31) // 32 + 1)
        assert words[0].dtype == torch.int32
