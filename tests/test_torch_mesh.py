"""The port's solver mesh (parallel/mesh.py, B10) against JAX's on the CPU.

JAX runs on its 8 virtual CPU devices (tests/conftest.py); the port on
``make_mesh(devices=["cpu"] * 8)``, eight positions of one CPU, where
every wrapper runs its kernel's plain version. Mirrors
tests/test_parallel.py: the mesh shapes and factorizations, ARG_SPECS and
the pads byte for byte, the partials and their fold against JAX's tables,
all 10 outputs of every (data, model) factorization of 8 and the packed
bytes against JAX's sharded programs, the driver's Results against
TpuSolver on JAX's mesh, the dense re-factorization, the structure of a
mesh solve (one fold, before the scan, which reads only lead-device
tensors), the shard-local row apply, the warm path and the scenario batch
under the mesh; then what the port decides for itself: "auto" as JAX
resolves it, no relax bulk and no class-batched scan under a mesh, and a
mesh of CPU and CUDA devices refused.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from karpenter_tpu.parallel import mesh as jmesh
from karpenter_tpu.solver.encode import SOLVE_ARG_NAMES as J_NAMES
from karpenter_tpu_torch.ops import feasibility as tf
from karpenter_tpu_torch.ops import solve as tsolve
from karpenter_tpu_torch.parallel import mesh as tmesh
from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

from test_torch_cuda import B1_NAMES, B2_NAMES, mesh_partials, sparse_index_case
from test_torch_solver import decisions

CPU8 = ["cpu"] * 8
DATAS = (1, 2, 4, 8)


def claim_keys(results):
    """tests/test_parallel.py's claim key: each claim's pods and types."""
    return sorted(
        (tuple(sorted(p.metadata.name for p in c.pods)),
         tuple(sorted(t.name for t in c.instance_type_options)))
        for c in results.new_node_claims
    )


def _shape(m):
    return dict(zip(m.axis_names, (int(x) for x in m.devices.shape)))


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(devices=CPU8)


# -- shapes, specs, pads ------------------------------------------------------

SHAPE_CASES = {
    "default": lambda mk: mk(8),
    **{f"data{d}": (lambda d: lambda mk: mk(8, data=d))(d) for d in DATAS},
    "scenario4-data2": lambda mk: mk(8, data=2, scenario=4),
    "four": lambda mk: mk(4),
}


def _port_make(n=None, data=None, scenario=None):
    return tmesh.make_mesh(n, data=data, scenario=scenario, devices=CPU8)


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_mesh_shapes_equal_jax(jax_mesh, case):
    """make_mesh, and scenario_mesh / dense_mesh over it, factor the
    devices as JAX's do."""
    make = SHAPE_CASES[case]
    j, t = make(jmesh.make_mesh), make(_port_make)
    assert t.axis_names == j.axis_names == ("scenario", "data", "model")
    assert _shape(t) == _shape(j)
    for s in (1, 2, 8, 16):
        assert _shape(tmesh.scenario_mesh(t, s)) == _shape(jmesh.scenario_mesh(j, s))
    assert _shape(tmesh.dense_mesh(t)) == _shape(jmesh.dense_mesh(j))
    assert tmesh.dense_mesh(tmesh.dense_mesh(t)) is tmesh.dense_mesh(t)
    assert tmesh.scenario_mesh(t, 8) is tmesh.scenario_mesh(t, 8)


def test_mesh_is_a_key():
    """Equal device grids are equal, hashable meshes (the residency store
    and the program caches key on them); a different grid is not."""
    import pickle

    a, b = _port_make(8, data=2), _port_make(8, data=2)
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != _port_make(8, data=4)
    assert pickle.loads(pickle.dumps(a)) == a
    assert a.lead == torch.device("cpu") and a.kind == "cpu"


def test_arg_specs_equal_jax():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.ARG_SPECS == jmesh.ARG_SPECS
    assert list(tmesh.ARG_SPECS) == list(jmesh.ARG_SPECS)
    assert set(tmesh.ARG_SPECS) == set(SOLVE_ARG_NAMES) and SOLVE_ARG_NAMES == J_NAMES


def _example(n_pods=64, n_types=16, shapes=8):
    from karpenter_tpu.solver.example import example_snapshot_arrays

    return example_snapshot_arrays(n_pods=n_pods, n_types=n_types, shapes=shapes)


@pytest.mark.parametrize("data", DATAS)
def test_pads_byte_equal_jax(jax_mesh, data):
    """pad_args_for_mesh over odd T and L: every argument byte for byte
    JAX's, and shard_args cuts each sharded one into equal pieces."""
    args, _ = _example(n_pods=40, n_types=13, shapes=5)
    j = jmesh.pad_args_for_mesh(args, jmesh.make_mesh(8, data=data))
    m = _port_make(8, data=data)
    t = tmesh.pad_args_for_mesh(args, m)
    for name, a, b in zip(SOLVE_ARG_NAMES, j, t):
        assert (a.dtype, a.shape) == (b.dtype, b.shape) and a.tobytes() == b.tobytes(), name
    pieces = tmesh.shard_args(t, m)
    assert len(pieces) == 8
    by = dict(zip(SOLVE_ARG_NAMES, t))
    for (s, d, mi), shard in pieces.items():
        got = dict(zip(SOLVE_ARG_NAMES, shard))
        L = by["gk_g"].shape[0] // (8 // m.shape["model"])
        np.testing.assert_array_equal(got["gk_g"], by["gk_g"][d * L:(d + 1) * L])
        T = by["t_alloc"].shape[0] // m.shape["model"]
        np.testing.assert_array_equal(got["t_alloc"], by["t_alloc"][mi * T:(mi + 1) * T])
        np.testing.assert_array_equal(got["p_titype_ok"],
                                      by["p_titype_ok"][:, mi * T:(mi + 1) * T])
        assert got["g_mask"] is by["g_mask"]


# -- the partials and the fold against JAX's tables ---------------------------


def _partials_folded(a, D, M, zk, ck):
    """The port's plain partials of every (data, model) shard of a case,
    padded and cut as the mesh cuts them (tests/test_torch_cuda.py's
    generator, which the card runs on the kernels), and their plain fold."""
    shards, fold_args = mesh_partials(a, D, M, zk, ck, "cpu")
    for kind, d, _, out in shards:
        assert (out[-1] is None) == (d > 0), kind
    return tf.mesh_fold(*fold_args)


@pytest.mark.parametrize("case", ["padding-interleaved", "two-templates", "scenario-axis"])
@pytest.mark.parametrize("data", DATAS)
def test_partials_fold_equal_jax_tables(case, data):
    """Any (data, model) split of the live pairs and the types, folded,
    is JAX's fresh_claim_feasibility_sparse and
    existing_node_feasibility_sparse on the whole input; padded types come
    out infeasible."""
    from karpenter_tpu.ops import feasibility as jf

    a, zk, ck = sparse_index_case(case)
    D, M = data, 8 // data
    compat_pg, type_ok, n_fit, cap_ng = _partials_folded(a, D, M, zk, ck)
    j = jf.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    T = a["t_alloc"].shape[0]
    for name, want, got in zip(("compat_pg", "type_ok", "n_fit"), j, (compat_pg, type_ok, n_fit)):
        got = got.numpy()
        if got.ndim == 3:
            got = got[:, :, :T]
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert not type_ok[:, :, T:].any()
    tols = a["n_tol"] if a["n_tol"].ndim == 3 else a["n_tol"][None]
    for s, tol in enumerate(tols):
        want = jf.existing_node_feasibility_sparse(
            *(tol if n == "n_tol" else a[n] for n in B2_NAMES))
        got = cap_ng[s] if cap_ng.dim() == 3 else cap_ng
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"cap_ng[{s}]")


def test_fold_reference_is_the_library_sum():
    """The fold's int32 sums wrap, in any order, as the library's int32
    sum of the stacked partials does."""
    rng = np.random.default_rng(9)
    parts = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (4, 1, 2, 3, 4), dtype=np.int64)
                             .astype(np.int32))
    tonly = torch.ones((1, 2, 3, 4), dtype=torch.bool)
    n_fit = torch.zeros((1, 2, 3, 4), dtype=torch.int32)
    fc = torch.zeros((4, 2, 3), dtype=torch.int32)
    _, type_ok, _, _ = tf.mesh_fold_reference(parts, fc, tonly, n_fit,
                                              torch.ones((2, 3), dtype=torch.bool))
    lib = parts.sum(0, dtype=torch.int32)[0]
    np.testing.assert_array_equal(type_ok.numpy(), (lib == 0).numpy())


def test_shard_into_writes_or_copies():
    """A shard on the lead device launches into its slices of the stacked
    buffers; one on another device computes there and only its wanted
    outputs are copied in."""
    views = (torch.zeros(3, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    seen = []

    def launch(out):
        seen.append(out)
        if out is not None:
            out[0].fill_(7)
            return out
        return torch.ones(3, dtype=torch.int32), torch.full((2,), 5, dtype=torch.int32)

    tsolve._shard_into("cuda:1", "cuda:1", views, launch, (True, True))
    assert seen == [views] and views[0].tolist() == [7, 7, 7]
    tsolve._shard_into("cuda:2", "cuda:1", views, launch, (True, False))
    assert seen[1] is None
    assert views[0].tolist() == [1, 1, 1] and views[1].tolist() == [0, 0]


# -- the sharded programs against JAX's ---------------------------------------

FIELDS = ("c_pool", "c_tmask", "n_open", "overflow", "exist_fills", "claim_fills",
          "unplaced", "c_dzone", "c_dct", "c_resv")


def _many_groups():
    """tests/test_parallel.py:120's input: 400 distinct request shapes
    over 24 types (G >= 300), statics with the sparse index."""
    from karpenter_tpu.api import resources as res
    from karpenter_tpu.api.objects import ObjectMeta, Pod, PodSpec
    from karpenter_tpu.cloudprovider import corpus
    from karpenter_tpu.kube import Client, TestClock
    from karpenter_tpu.scheduling.topology import Topology
    from karpenter_tpu.solver import TpuSolver
    from karpenter_tpu.solver import encode as enc
    from karpenter_tpu.solver.example import example_nodepool

    pods = [Pod(metadata=ObjectMeta(name=f"g-{i}"), spec=PodSpec(requests={
        res.CPU: (100 + i) * res.MILLI // 100,
        res.MEMORY: (64 + i) * 2**20 * res.MILLI})) for i in range(400)]
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(24)}
    solver = TpuSolver(pools, its, Topology(Client(TestClock()), [], pools, its, pods))
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    assert not rest
    templates = solver.oracle.templates
    snap = enc.encode(groups, templates,
                      {t.node_pool_name: t.instance_type_options for t in templates},
                      daemon_overhead=solver.oracle.daemon_overhead)
    a_tzc, res_cap0, a_res = solver._offering_availability(snap)
    nmax = solver._estimate_nmax(snap, solver._fit_matrix(snap))
    statics = dict(nmax=nmax, zone_kid=snap.zone_kid, ct_kid=snap.ct_kid,
                   has_domains=False, sparse_groups=True)
    return snap.solve_args(a_tzc, res_cap0, a_res), statics


def _run_jax(make, args, statics, packed=None):
    m = make()
    padded = jmesh.pad_args_for_mesh(args, m)
    fn = (jmesh.sharded_solve_packed_fn(m, packed, **statics) if packed is not None
          else jmesh.sharded_solve_fn(m, **statics))
    with m:
        out = fn(*padded)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_outputs(jax_mesh):
    """JAX's sharded outputs, computed once: every factorization of the
    example (sparse index), the many-groups input on the default mesh, and
    the packed solve at data 2 x model 4 with int16 fills."""
    import jax.numpy as jnp

    args, statics = _example()
    statics = dict(statics, sparse_groups=True)
    out = {("example", d): _run_jax(lambda: jmesh.make_mesh(8, data=d), args, statics)
           for d in DATAS}
    mg_args, mg_statics = _many_groups()
    out["many_groups"] = _run_jax(lambda: jmesh.make_mesh(8), mg_args, mg_statics)
    out["packed"] = _run_jax(lambda: jmesh.make_mesh(8, data=2), args, statics,
                             packed=jnp.int16)
    return out, (args, statics), (mg_args, mg_statics)


def _assert_outputs(want, got):
    assert len(got) == len(want) == len(FIELDS)
    for name, w, g in zip(FIELDS, want, got):
        g = g.numpy()
        assert (w.dtype, w.shape) == (g.dtype, g.shape), name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("data", DATAS)
def test_every_factorization_equals_jax(jax_outputs, data):
    """All 10 outputs of the port's sharded solve equal JAX's
    sharded_solve_fn on the same (data, model) factorization of 8."""
    out, (args, statics), _ = jax_outputs
    m = _port_make(8, data=data)
    got = tmesh.sharded_solve_fn(m, **statics)(*tmesh.pad_args_for_mesh(args, m))
    _assert_outputs(out["example", data], got)


def test_many_groups_equals_jax(jax_outputs):
    out, _, (args, statics) = jax_outputs
    m = _port_make(8)
    got = tmesh.sharded_solve_fn(m, **statics)(*tmesh.pad_args_for_mesh(args, m))
    assert args[0].shape[0] >= 300
    _assert_outputs(out["many_groups"], got)


def test_packed_bytes_equal_jax(jax_outputs):
    """The wire-packed outputs (uint8 type masks, int16 fills) equal
    JAX's sharded_solve_packed_fn byte for byte."""
    out, (args, statics), _ = jax_outputs
    m = _port_make(8, data=2)
    got = tmesh.sharded_solve_packed_fn(m, torch.int16, **statics)(
        *tmesh.pad_args_for_mesh(args, m))
    for name, w, g in zip(FIELDS, out["packed"], got):
        g = g.numpy()
        assert (w.dtype, w.shape) == (g.dtype, g.shape) and w.tobytes() == g.tobytes(), name


# -- through the driver -------------------------------------------------------


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _solver(pkg, pods, n_types, cfg, cache=None, pools=None):
    corpus = _mod(pkg, "cloudprovider.corpus")
    kube = _mod(pkg, "kube")
    topo = _mod(pkg, "scheduling.topology")
    ex = _mod(pkg, "solver.example")
    drv = _mod(pkg, "solver.driver")
    pools = pools or [ex.example_nodepool()]
    its = {p.name: corpus.generate(n_types) for p in pools}
    t = topo.Topology(kube.Client(kube.TestClock()), [], pools, its, pods)
    cls = drv.TpuSolver if pkg == "karpenter_tpu" else drv.TorchSolver
    return cls(pools, its, t, config=cfg, encode_cache=cache or drv.EncodeCache())


def _cfg(pkg, **kw):
    drv = _mod(pkg, "solver.driver")
    if pkg == "karpenter_tpu_torch":
        kw.setdefault("device", "cpu")
    return drv.SolverConfig(**kw)


def test_driver_mesh_equals_jax(jax_mesh, mesh):
    """TorchSolver under the mesh decides as TpuSolver under JAX's mesh
    and as the port without one, claims in slot order
    (constrained_mix(600) x 24 types: the domain machinery under the
    mesh)."""
    got = {}
    for pkg, m in (("karpenter_tpu", jax_mesh), ("karpenter_tpu_torch", mesh),
                   ("karpenter_tpu_torch", None)):
        pods = _mod(pkg, "solver.workloads").constrained_mix(600)
        res = _solver(pkg, pods, 24, _cfg(pkg, mesh=m)).solve(pods)
        assert not res.pod_errors
        got[pkg, m is None] = decisions(res, pods)
    assert got["karpenter_tpu_torch", False] == got["karpenter_tpu", False]
    assert got["karpenter_tpu_torch", False] == got["karpenter_tpu_torch", True]


def test_dense_mesh_routing(jax_mesh, mesh, monkeypatch):
    """With the sparse index off (JAX's KTPU_SPARSE_FEAS=0; the port's
    statics patched, as it has no such switch) the driver re-factorizes
    onto 'model', the buffers live on the dense mesh, and the decisions
    equal JAX's and the single device's."""
    from karpenter_tpu_torch.solver.driver import TorchSolver

    statics = TorchSolver._kernel_statics
    monkeypatch.setattr(TorchSolver, "_kernel_statics",
                        lambda self, snap, G: dict(statics(self, snap, G), sparse_groups=False))
    monkeypatch.setenv("KTPU_SPARSE_FEAS", "0")
    got = {}
    for pkg, m in (("karpenter_tpu", jax_mesh), ("karpenter_tpu_torch", mesh),
                   ("karpenter_tpu_torch", None)):
        pods = _mod(pkg, "solver.workloads").mixed_pods(300, gpu_fraction=0.0)
        s = _solver(pkg, pods, 16, _cfg(pkg, mesh=m))
        got[pkg, m is None] = decisions(s.solve(pods), pods)
        if pkg == "karpenter_tpu_torch" and m is not None:
            assert s._shared_cache.device_store._mesh_key == tmesh.dense_mesh(mesh)
    assert got["karpenter_tpu_torch", False] == got["karpenter_tpu", False]
    assert got["karpenter_tpu_torch", False] == got["karpenter_tpu_torch", True]


def test_structure_one_fold_before_the_scan(mesh, monkeypatch):
    """In place of JAX's TestScanStructure: a sparse solve over data 2 x
    model 4 launches D x M fresh partials and D existing ones, then ONE
    fold, then the scan once, and every tensor the scan reads is a
    lead-device tensor of the whole (type tables at the padded T)."""
    from karpenter_tpu_torch.solver.example import example_snapshot_arrays

    m = _port_make(8, data=2)
    args, statics = example_snapshot_arrays(64, 16, 8)
    statics = dict(statics, sparse_groups=True)
    padded = tmesh.pad_args_for_mesh(args, m)
    margs = tmesh.place_args(padded, m)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, a, kw))
            return fn(*a, **kw)
        monkeypatch.setattr(tsolve, name, wrapped)

    for name in ("fresh_claim_feasibility_partial", "existing_node_feasibility_partial",
                 "mesh_fold", "pack", "fresh_claim_feasibility_sparse"):
        spy(name, getattr(tsolve, name))
    tsolve.solve_core_mesh(margs, m, **statics)
    names = [c[0] for c in calls]
    N = dict(zip(SOLVE_ARG_NAMES, padded))["n_avail"].shape[0]
    assert names.count("fresh_claim_feasibility_partial") == 8
    assert names.count("existing_node_feasibility_partial") == (2 if N else 0)
    assert names.count("mesh_fold") == 1 and names.count("pack") == 1
    assert "fresh_claim_feasibility_sparse" not in names
    assert names.index("mesh_fold") < names.index("pack") == len(names) - 1
    whole = {id(margs.whole(n)) for n in SOLVE_ARG_NAMES}
    fold_out = calls[names.index("mesh_fold")]
    pack_args = calls[-1][1]
    from karpenter_tpu_torch.ops.packing import PACK_HEAD, PACK_TAIL

    for i, name in enumerate(PACK_HEAD):
        assert id(pack_args[i]) in whole, name
    tail = pack_args[len(PACK_HEAD) + 4:len(PACK_HEAD) + 4 + len(PACK_TAIL)]
    for name, x in zip(PACK_TAIL, tail):
        assert id(x) in whole, name
    T = dict(zip(SOLVE_ARG_NAMES, padded))["t_alloc"].shape[0]
    assert pack_args[len(PACK_HEAD) + 1].shape[-1] == T  # type_ok at the padded T
    assert all(x.device == m.lead for x in pack_args if isinstance(x, torch.Tensor))
    # the partials' type slices are the model shards'
    assert fold_out[1][2][0].shape[-1] == T // 4


# -- the shard-local row apply ------------------------------------------------


def test_decompose_rows_equal_jax():
    from karpenter_tpu.ops import solve as jsolve

    rng = np.random.default_rng(11)
    for idx, block in ((np.asarray([0, 5, 9, 17, 33, 34, 63], np.int32), 8),
                       (np.asarray([0, 8, 9, 10, 11], np.int32), 8),
                       (np.asarray([0, 3, 17], np.int32), 4)):
        rows = rng.standard_normal((len(idx), 4)).astype(np.float32)
        for want, got in zip(jsolve._decompose_rows_by_shard(idx, rows, block, 8),
                             tsolve._decompose_rows_by_shard(idx, rows, block, 8)):
            assert want.dtype == got.dtype and want.tobytes() == got.tobytes()


@pytest.mark.parametrize("idx", [[0, 5, 9, 17, 33, 34, 63], [0, 8, 9, 10, 11], [63]])
def test_shard_local_row_apply(monkeypatch, idx):
    """Row updates of a buffer sharded on its leading axis over 8 shards:
    the blocks equal the full update, each shard with a row to change gets
    one apply over its own local rows only, and the others keep their
    buffer (tests/test_parallel.py:398, :425)."""
    rng = np.random.default_rng(5)
    host = rng.standard_normal((64, 4)).astype(np.float32)
    idx = np.asarray(idx, np.int32)
    rows = rng.standard_normal((len(idx), 4)).astype(np.float32)
    pieces = [torch.from_numpy(host[j * 8:(j + 1) * 8].copy()) for j in range(8)]
    applied = []
    real = tsolve.delta_apply_rows

    def spy(arr, li, lr):
        applied.append((next(j for j, p in enumerate(pieces) if p is arr), np.asarray(li)))
        return real(arr, li, lr)

    monkeypatch.setattr(tsolve, "delta_apply_rows", spy)
    out = tsolve.delta_apply_rows_sharded(pieces, idx, rows)
    want = host.copy()
    want[idx] = rows
    np.testing.assert_array_equal(torch.cat(out).numpy(), want)
    touched = sorted({int(i) // 8 for i in idx})
    assert [j for j, _ in applied] == touched
    for j, li in applied:
        assert set(li) == {int(i) - 8 * j for i in idx if int(i) // 8 == j}
    for j in set(range(8)) - set(touched):
        assert out[j] is pieces[j]


# -- the warm path and the scenario axis under the mesh -----------------------


def _churn_script(pods, ticks=3, k=8):
    import random

    rng = random.Random(13)
    regen = list(pods)
    out = [list(pods)]
    cur = list(pods)
    for _ in range(ticks):
        cur = list(cur)
        idx = rng.sample(range(len(cur)), k)
        jdx = rng.sample(range(len(regen)), k)
        for i, j in zip(idx, jdx):
            cur[i] = regen[jdx[0] if j == i else j]
        out.append(cur)
    return out


def _warm_run(pkg, workload, n, m):
    wl = _mod(pkg, "solver.workloads")
    pods = {
        "mixed": lambda n: wl.mixed_pods(n, gpu_fraction=0.0),
        "constrained": wl.constrained_mix,
        "diverse": wl.diverse_reference_mix,
    }[workload](n)
    cache = _mod(pkg, "solver.driver").EncodeCache()
    out = []
    for tick in _churn_script(pods):
        s = _solver(pkg, tick, 24, _cfg(pkg, mesh=m), cache=cache)
        r = s.solve(tick)
        out.append((bool(s.last_encode_reused), int(s.last_delta_rows), s.fallback_solves,
                    claim_keys(r)))
    return out, cache


@pytest.mark.parametrize("workload", ["mixed", "constrained", "diverse"])
def test_reuse_and_row_delta_survive_mesh(mesh, workload):
    """REUSE and row-delta outcomes, fallbacks and claims under the mesh
    equal the single device's, tick by tick; the buffers live on the mesh,
    the live-pair index in data slices and a replicated one once."""
    n = 400 if workload == "mixed" else 150
    single, _ = _warm_run("karpenter_tpu_torch", workload, n, None)
    sharded, cache = _warm_run("karpenter_tpu_torch", workload, n, mesh)
    assert single == sharded
    assert any(r for r, *_ in single[1:]) or any(rows for _, rows, *_ in single[1:])
    store = cache.device_store
    assert store._mesh_key == mesh
    gk = store._dev_buffers["gk_g"]
    assert sorted(k for _, k in gk if k) == [((0, d),) for d in range(8)]
    assert list(store._dev_buffers["g_mask"]) == [(torch.device("cpu"), ())]


def test_warm_path_equals_jax_single_device(mesh):
    """The mixed script under the port's mesh equals TpuSolver's single
    device, tick by tick (REUSE, row deltas, fallbacks, claims)."""
    jax_single, _ = _warm_run("karpenter_tpu", "mixed", 400, None)
    sharded, _ = _warm_run("karpenter_tpu_torch", "mixed", 400, mesh)
    assert sharded == jax_single


def test_mesh_to_single_device_switch_restages(mesh):
    from karpenter_tpu_torch.solver.driver import EncodeCache
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    pods = mixed_pods(200, gpu_fraction=0.0)
    cache = EncodeCache()
    r1 = _solver("karpenter_tpu_torch", pods, 24, _cfg("karpenter_tpu_torch", mesh=mesh),
                 cache).solve(pods)
    assert cache.device_store._mesh_key == mesh
    s2 = _solver("karpenter_tpu_torch", pods, 24, _cfg("karpenter_tpu_torch"), cache)
    r2 = s2.solve(pods)
    assert claim_keys(r1) == claim_keys(r2)
    assert cache.device_store._mesh_key is None
    assert s2.last_encode_reused and cache.device_store.last_full_puts == len(SOLVE_ARG_NAMES)


@pytest.mark.parametrize("factor", ["data8", "data2-model4"])
def test_scenario_batch_under_mesh(mesh, factor):
    """A consolidation-shaped batch under the mesh: the unsharded batch's
    and TpuSolver's claims, <= 2 dispatches, 0 fallbacks
    (tests/test_parallel.py:594)."""
    m = mesh if factor == "data8" else _port_make(8, data=2)
    got = {}
    for pkg, mm in (("karpenter_tpu", None), ("karpenter_tpu_torch", None),
                    ("karpenter_tpu_torch", m)):
        pods = _mod(pkg, "solver.workloads").mixed_pods(300, gpu_fraction=0.0)
        Scenario = _mod(pkg, "solver.driver").Scenario
        scens = [Scenario(pods=pods[: 50 * (i + 1)]) for i in range(5)]
        s = _solver(pkg, pods, 24, _cfg(pkg, mesh=mm))
        res = s.solve_scenarios(scens)
        assert res is not None and s.fallback_solves == 0
        assert s.last_scenario_dispatches <= 2
        got[pkg, mm is None] = [claim_keys(r) for r in res]
    assert got["karpenter_tpu_torch", False] == got["karpenter_tpu", True]
    assert got["karpenter_tpu_torch", True] == got["karpenter_tpu", True]


def test_scenario_blocks_over_data(mesh, monkeypatch):
    """S = 8 over 'data' 2 x 'model' 4 keeps data 2 in each scenario
    block: each block's stage folds its shards' partials once."""
    from karpenter_tpu_torch.solver.workloads import mixed_pods
    from karpenter_tpu_torch.solver.driver import Scenario

    m = _port_make(8, data=2)
    sm = tmesh.scenario_mesh(m, 8)
    assert _shape(sm) == {"scenario": 2, "data": 1, "model": 4}
    folds = []
    real = tsolve.mesh_fold
    monkeypatch.setattr(tsolve, "mesh_fold", lambda *a, **k: folds.append(1) or real(*a, **k))
    pods = mixed_pods(120, gpu_fraction=0.0)
    s = _solver("karpenter_tpu_torch", pods, 24, _cfg("karpenter_tpu_torch", mesh=m))
    assert s.solve_scenarios([Scenario(pods=pods[: 30 * (i + 1)]) for i in range(4)])
    assert len(folds) == 2  # one per scenario block


# -- what the port decides for itself -----------------------------------------


def test_relax_and_classed_off_under_mesh(mesh, monkeypatch):
    """As in JAX: no relaxation bulk and no class-batched scan under a
    mesh; the decisions are the single device's with both off."""
    from karpenter_tpu_torch.ops import packing

    def refuse(*a, **k):
        raise AssertionError("pack_classed under a mesh")

    monkeypatch.setattr(tsolve, "pack_classed", refuse)
    monkeypatch.setattr(packing, "pack_classed", refuse)
    pkg = "karpenter_tpu_torch"
    wl = _mod(pkg, "solver.workloads")
    for pods, kw in ((wl.identical_pods(300), {}),
                     (wl.diverse_reference_mix(200), {"classed": True})):
        s = _solver(pkg, pods, 20, _cfg(pkg, mesh=mesh, **kw))
        got = decisions(s.solve(pods), pods)
        assert s.last_relax_pods == 0
        off = dict(kw, relax=False)
        if "classed" in off:
            off["classed"] = False
        want = decisions(_solver(pkg, pods, 20, _cfg(pkg, **off)).solve(pods), pods)
        assert got == want


def test_auto_resolution(monkeypatch):
    """mesh="auto": no mesh on the CPU and on one card; a mesh over every
    card past one (device_count patched; nothing launches)."""
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    pods = mixed_pods(20)
    pkg = "karpenter_tpu_torch"
    assert _solver(pkg, pods, 8, _cfg(pkg, mesh="auto"))._resolve_mesh() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((1, None), (4, {"scenario": 1, "data": 4, "model": 1})):
        monkeypatch.setattr(torch.cuda, "device_count", lambda count=count: count)
        s = _solver(pkg, pods, 8, _cfg(pkg, device="cuda", mesh="auto"))
        got = s._resolve_mesh()
        if want is None:
            assert got is None
        else:
            assert _shape(got) == want and s._resolve_mesh() is got
            assert list(got.devices.reshape(-1)) == [torch.device("cuda", i) for i in range(4)]


def test_mixed_devices_refused():
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.Mesh(np.asarray([torch.device("cpu"), torch.device("cuda", 1)],
                              dtype=object).reshape(1, 2, 1))
    cuda_mesh = tmesh.make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="mesh of cuda devices"):
        _cfg("karpenter_tpu_torch", mesh=cuda_mesh)
    with pytest.raises(ValueError, match="mesh"):
        _cfg("karpenter_tpu_torch", mesh="everywhere")
    with pytest.raises(ValueError, match="factor"):
        tmesh.make_mesh(8, data=3, devices=CPU8)


def test_args_of_another_mesh_refused():
    """A program over one mesh refuses arguments placed on another."""
    from karpenter_tpu_torch.solver.example import example_snapshot_arrays

    args, statics = example_snapshot_arrays(16, 4, 1)
    m2, m8 = _port_make(8, data=2), _port_make(8)
    margs = tmesh.place_args(tmesh.pad_args_for_mesh(args, m2), m2)
    with pytest.raises(ValueError, match="placed on"):
        tmesh.sharded_solve_fn(m8, **statics)(margs)
