"""Port parity: the plain PyTorch packing scan, fused solve and wire pack
vs the JAX kernels.

karpenter_tpu_torch/ops/packing.py:pack_reference is the plain version of
kernel B4 and ops/solve.py:wire_pack_reference that of B6. The same numpy
arrays, encoded by the JAX package, go through ``solve_all`` (JAX, on the
CPU) and through the port's ``solve_core`` on ``to_device_args(..., "cpu")``.
Tolerance: exact equality of all 10 outputs, cast to the JAX dtypes.
"""

import numpy as np
import pytest
import torch

from helpers import (
    affinity_term,
    make_nodepool,
    make_pods,
    make_state_node,
    snapshot_args,
    spread_constraint,
)
from karpenter_tpu.api import labels
from karpenter_tpu.ops.packing import waterfill as jax_waterfill
from karpenter_tpu.ops.solve import _wire_pack, solve_all
from karpenter_tpu.solver.example import example_snapshot_arrays
from karpenter_tpu_torch.ops import packing as tp
from karpenter_tpu_torch.ops.solve import solve_core, wire_pack_reference
from karpenter_tpu_torch.solver.args import to_device_args

OUT_NAMES = (
    "c_pool", "c_tmask", "n_open", "overflow", "exist_fills", "claim_fills",
    "unplaced", "c_dzone", "c_dct", "c_resv",
)
EXAMPLE_SHAPES = [(16, 4, 1), (64, 16, 4), (200, 40, 8), (1000, 60, 25)]


def _solve_both(args, statics):
    import jax

    st = dict(statics, sparse_groups=True)
    j_out = [np.asarray(x) for x in jax.device_get(solve_all(*args, **st))]
    t_out = solve_core(*to_device_args(args, "cpu"), **st)
    return j_out, t_out


def _assert_outputs_equal(j_out, t_out):
    for name, j, t in zip(OUT_NAMES, j_out, t_out):
        t = t.numpy()
        assert t.shape == j.shape, f"{name}: {t.shape} vs {j.shape}"
        mism = np.argwhere(t.astype(j.dtype) != j)
        assert not mism.size, f"{name} diverges at {mism[:5].tolist()}"


def _parity(args, statics):
    j_out, t_out = _solve_both(args, statics)
    _assert_outputs_equal(j_out, t_out)
    return j_out


class TestSolveCore:
    @pytest.mark.parametrize("n_pods,n_types,shapes", EXAMPLE_SHAPES)
    def test_example_snapshots(self, n_pods, n_types, shapes):
        args, statics = example_snapshot_arrays(n_pods, n_types, shapes)
        out = _parity(args, statics)
        assert int(out[2]) > 0 and not out[6].any()

    def test_existing_nodes(self):
        """Tier 1: greedy prefix fill over half-full existing nodes."""
        from karpenter_tpu.solver.workloads import mixed_pods

        nodes = [make_state_node(name=f"en-{i}", cpu="4", memory="16Gi")
                 for i in range(5)]
        args, statics = snapshot_args(mixed_pods(300), n_types=30,
                                      state_nodes=nodes)
        out = _parity(args, statics)
        assert out[4].sum() > 0  # existing nodes took pods

    def test_hostname_spread_and_anti_affinity(self):
        """Per-entity caps (g_hcap) on claims and nodes."""
        pods = (
            make_pods(12, cpu="1", labels={"app": "hs"},
                      spread=[spread_constraint(labels.HOSTNAME, labels={"app": "hs"})])
            + make_pods(6, cpu="500m", labels={"app": "anti"},
                        pod_anti_affinity=[affinity_term(labels.HOSTNAME, {"app": "anti"})])
            + make_pods(20, cpu="250m")
        )
        nodes = [make_state_node(name=f"hn-{i}") for i in range(3)]
        args, statics = snapshot_args(pods, n_types=20, state_nodes=nodes)
        assert (np.asarray(args[5]) < 2**30).any(), "hostname cap path not exercised"
        _parity(args, statics)

    @pytest.mark.parametrize("n_nodes", [0, 3])
    def test_shared_hostname_slots(self, n_nodes):
        """Cross-shape anti-affinity / spread: several groups count against
        ONE shared hostname constraint (g_hstg, g_hscap, g_hself, nh_cnt0)."""
        pods = []
        for app, cpus, kind in (("x", ("1", "2"), "anti"), ("y", ("1", "3"), "spread")):
            for cpu in cpus:
                extra = (
                    {"pod_anti_affinity": [affinity_term(labels.HOSTNAME, {"app": app})]}
                    if kind == "anti"
                    else {"spread": [spread_constraint(labels.HOSTNAME, labels={"app": app})]}
                )
                pods += make_pods(4, cpu=cpu, labels={"app": app}, **extra)
        nodes = [make_state_node(name=f"sn-{i}") for i in range(n_nodes)]
        args, statics = snapshot_args(pods, n_types=12, state_nodes=nodes)
        assert (np.asarray(args[14]) >= 0).any(), "shared slots not exercised"
        _parity(args, statics)

    def test_hostname_affinity(self):
        """g_haff: the whole group co-locates on ONE entity."""
        pods = (
            make_pods(5, cpu="1", labels={"app": "co"},
                      pod_affinity=[affinity_term(labels.HOSTNAME, {"app": "co"})])
            + make_pods(8, cpu="2")
        )
        args, statics = snapshot_args(pods, n_types=16)
        assert np.asarray(args[6]).any(), "hostname affinity not exercised"
        _parity(args, statics)

    @pytest.mark.parametrize("limit", ["12", "40"])
    def test_weighted_templates_with_limits(self, limit):
        """Two weighted templates; the heavier one's limit ledger runs out."""
        from karpenter_tpu.solver.workloads import mixed_pods

        pools = [
            make_nodepool("heavy", weight=80, limits={"cpu": limit}),
            make_nodepool("light", weight=20),
        ]
        args, statics = snapshot_args(mixed_pods(150, gpu_fraction=0.0),
                                      node_pools=pools, n_types=20)
        out = _parity(args, statics)
        assert len(set(out[0][: int(out[2])].tolist())) == 2  # both templates

    def test_spot_od_pools(self):
        from karpenter_tpu.solver.workloads import mixed_pods, spot_od_pools

        args, statics = snapshot_args(mixed_pods(400), node_pools=spot_od_pools(),
                                      n_types=30)
        _parity(args, statics)

    @pytest.mark.parametrize("nmax", [1, 4])
    def test_overflow(self, nmax):
        """Too few claim slots: overflow is set and the scan stops opening."""
        args, statics = example_snapshot_arrays(200, 40, 8)
        out = _parity(args, dict(statics, nmax=nmax))
        assert bool(out[3])

    @pytest.mark.parametrize("flag", ["has_domains", "has_contrib", "tile_feasibility"])
    def test_forced_statics_match_jax(self, flag):
        """Each static forced on a batch that does not need it equals JAX's
        solve with the same static: has_domains changes only the tier-3
        bulk split (even, bulk_takes), has_contrib adds nothing, and
        tile_feasibility (the tiled mode: zero-G placeholder tables, rows
        built per step) changes no output at all."""
        args, statics = example_snapshot_arrays(200, 40, 8)
        out = _parity(args, dict(statics, **{flag: True}))
        if flag == "tile_feasibility":
            _assert_outputs_equal(out, _solve_both(args, statics)[1])

    @pytest.mark.parametrize("n_nodes", [0, 5])
    def test_dense_tables_raise(self, n_nodes):
        """The dense route (B3's plain versions in place of B1/B2) is
        ported: solve_core(..., sparse_groups=False) equals JAX's on every
        output, and the dense tables give the sparse route's outputs."""
        import jax

        from karpenter_tpu.solver.workloads import mixed_pods

        nodes = [make_state_node(name=f"dn-{i}", cpu="4", memory="16Gi")
                 for i in range(n_nodes)]
        args, statics = snapshot_args(mixed_pods(200), n_types=20, state_nodes=nodes)
        st = dict(statics, sparse_groups=False)
        j_out = [np.asarray(x) for x in jax.device_get(solve_all(*args, **st))]
        t_out = solve_core(*to_device_args(args, "cpu"), **st)
        _assert_outputs_equal(j_out, t_out)
        _assert_outputs_equal(j_out, _solve_both(args, statics)[1])
        assert int(j_out[2]) > 0


class TestWirePack:
    @pytest.mark.parametrize("n_pods,n_types,shapes", EXAMPLE_SHAPES)
    @pytest.mark.parametrize("fills", ["int16", "int32"])
    def test_matches_jax(self, n_pods, n_types, shapes, fills):
        import jax.numpy as jnp

        args, statics = example_snapshot_arrays(n_pods, n_types, shapes)
        j_out, t_out = _solve_both(args, statics)
        j_packed = [np.asarray(x) for x in _wire_pack(j_out, getattr(jnp, fills))]
        t_packed = wire_pack_reference(t_out, getattr(torch, fills))
        for name, j, t in zip(OUT_NAMES, j_packed, t_packed):
            t = t.numpy()
            assert t.dtype == j.dtype, f"{name}: {t.dtype} vs {j.dtype}"
            np.testing.assert_array_equal(t, j, err_msg=name)


class TestWaterfill:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("iters", [2, 8, 32])
    def test_matches_jax(self, seed, iters):
        """Level bisection, deficit hand-out by slot index, and the iters
        ceiling (a capped bisection must stop where JAX stops)."""
        rng = np.random.default_rng(seed)
        npods = rng.integers(0, 40, 48).astype(np.int32)
        cap = rng.integers(0, 12, 48).astype(np.int32)
        for n in (0, 1, 7, int(cap.sum()) // 2, int(cap.sum()) + 5):
            j = np.asarray(jax_waterfill(npods, cap, np.int32(n), iters=iters))
            t = tp.waterfill(torch.from_numpy(npods), torch.from_numpy(cap),
                             torch.tensor(n, dtype=torch.int32), iters=iters)
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f"n={n}")
