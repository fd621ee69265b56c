"""Port parity: the plain PyTorch feasibility tables vs the JAX ops.

karpenter_tpu_torch/ops/feasibility.py holds the plain versions of kernels
B1 (fresh_claim_feasibility_sparse) and B2
(existing_node_feasibility_sparse). The same numpy arrays, encoded by the
JAX package, go through the JAX function and — via
``to_device_args(..., "cpu")`` — through the port. Tolerance: exact
equality of every output (bool and int32 tables; fits_count is float32
floor division pinned bit-exact by native/solve_core.cc:50).
"""

import numpy as np
import pytest
import torch

from helpers import make_state_node, snapshot_args
from karpenter_tpu.ops import feasibility as jf
from karpenter_tpu.solver.encode import SOLVE_ARG_NAMES
from karpenter_tpu.solver.example import example_snapshot_arrays
from karpenter_tpu_torch.ops import feasibility as tf
from karpenter_tpu_torch.solver.args import to_device_args

EXAMPLE_SHAPES = [(16, 4, 1), (64, 16, 4), (200, 40, 8), (1000, 60, 25)]

FRESH_NAMES = (
    "g_def", "g_neg", "g_mask", "g_req",
    "p_def", "p_neg", "p_mask", "p_daemon", "p_tol", "p_titype_ok",
    "t_def", "t_mask", "t_alloc",
    "o_avail", "o_zone", "o_ct",
    "well_known",
    "gk_g", "gk_k", "gk_w", "goff_idx",
)
EXIST_NAMES = (
    "g_def", "g_neg", "g_mask", "g_req",
    "n_def", "n_mask", "n_avail", "n_base", "n_tol",
    "gk_g", "gk_k", "gk_w",
)


def _assert_same(name, jax_out, torch_out):
    j = np.asarray(jax_out)
    t = torch_out.numpy()
    assert t.shape == j.shape, name
    assert t.dtype == j.dtype, f"{name}: {t.dtype} vs {j.dtype}"
    mism = np.argwhere(t != j)
    assert not mism.size, f"{name} diverges at {mism[:5].tolist()}"


def _fresh_parity(args, zone_kid, ct_kid):
    a = dict(zip(SOLVE_ARG_NAMES, args))
    t = dict(zip(SOLVE_ARG_NAMES, to_device_args(args, "cpu")))
    j_out = jf.fresh_claim_feasibility_sparse(
        *(a[n] for n in FRESH_NAMES), zone_kid=zone_kid, ct_kid=ct_kid
    )
    t_out = tf.fresh_claim_feasibility_sparse(
        *(t[n] for n in FRESH_NAMES), zone_kid=zone_kid, ct_kid=ct_kid
    )
    for name, jo, to in zip(("compat_pg", "type_ok", "n_fit"), j_out, t_out):
        _assert_same(name, jo, to)
    return t_out


def _exist_parity(args):
    a = dict(zip(SOLVE_ARG_NAMES, args))
    t = dict(zip(SOLVE_ARG_NAMES, to_device_args(args, "cpu")))
    j_cap = jf.existing_node_feasibility_sparse(*(a[n] for n in EXIST_NAMES))
    t_cap = tf.existing_node_feasibility_sparse(*(t[n] for n in EXIST_NAMES))
    _assert_same("cap_ng", j_cap, t_cap)
    return t_cap


def _state_nodes(n, half_full=True):
    from helpers import make_pod

    nodes = []
    for i in range(n):
        sn = make_state_node(
            name=f"tn-{i}",
            zone=("test-zone-a", "test-zone-b", "test-zone-c")[i % 3],
        )
        if half_full and i % 2:
            sn.update_pod(
                make_pod(cpu="8", memory="32Gi", node_name=f"tn-{i}",
                         phase="Running"),
                is_daemon=False,
            )
        nodes.append(sn)
    return nodes


class TestFreshTables:
    @pytest.mark.parametrize("n_pods,n_types,shapes", EXAMPLE_SHAPES)
    def test_example_snapshots(self, n_pods, n_types, shapes):
        args, st = example_snapshot_arrays(n_pods, n_types, shapes)
        compat_pg, type_ok, n_fit = _fresh_parity(args, st["zone_kid"], st["ct_kid"])
        assert type_ok.any()  # the tables are not vacuous

    @pytest.mark.parametrize("workload", ["constrained", "diverse"])
    def test_group_heavy_segment_index(self, workload):
        """Defined keys, negations and zone/capacity-type rows: the live
        pair corrections and the goff_idx offering rows all engage."""
        from karpenter_tpu.solver.workloads import (
            constrained_mix,
            diverse_reference_mix,
        )

        pods = (
            constrained_mix(300, seed=5) if workload == "constrained"
            else diverse_reference_mix(250, seed=7)
        )
        args, st = snapshot_args(pods, n_types=24, require_full_routing=False)
        if workload == "constrained":
            a = dict(zip(SOLVE_ARG_NAMES, args))
            assert int(a["gk_w"].sum()) > 0  # selectors define keys
        _fresh_parity(args, st["zone_kid"], st["ct_kid"])


class TestExistingCaps:
    @pytest.mark.parametrize("n_nodes", [1, 6, 13])
    def test_mixed_over_state_nodes(self, n_nodes):
        from karpenter_tpu.solver.workloads import mixed_pods

        args, _ = snapshot_args(
            mixed_pods(200), n_types=30, state_nodes=_state_nodes(n_nodes)
        )
        cap = _exist_parity(args)
        assert int(cap.max()) > 0

    def test_constrained_over_state_nodes(self):
        """Zone selectors against nodes in three zones: the strict
        compatibility term rejects some (node, group) pairs."""
        from karpenter_tpu.solver.workloads import constrained_mix

        args, _ = snapshot_args(
            constrained_mix(200, seed=3), n_types=20,
            state_nodes=_state_nodes(6), require_full_routing=False,
        )
        cap = _exist_parity(args)
        assert int((cap == 0).sum()) > 0


class TestFitsCount:
    def test_bit_exact_on_random_inputs(self):
        """float32 floor(headroom / max(req, 1e-9)), +inf -> 2**30, zero
        requests gated on headroom >= 0 — bit-exact with XLA."""
        rng = np.random.default_rng(3)
        alloc = rng.uniform(0, 1e6, (64, 5)).astype(np.float32)
        base = rng.uniform(0, 1e6, (64, 5)).astype(np.float32)
        req = rng.choice(
            np.array([0.0, 1.0, 250.0, 1e3, 3.3e4, 1e-12], np.float32), (64, 5)
        )
        j = np.asarray(jf.fits_count(alloc, base, req))
        t = tf.fits_count(
            torch.from_numpy(alloc), torch.from_numpy(base), torch.from_numpy(req)
        )
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), j)


class TestRequirementSetOps:
    @pytest.mark.parametrize("seed", range(3))
    def test_match_jax(self, seed):
        """Intersects / Compatible (well-known allowance) / Add on random
        requirement rows, broadcast [A, 1, K(, V1)] x [1, B, K(, V1)]."""
        rng = np.random.default_rng(seed)
        A, B, K, V1 = 5, 7, 6, 4

        def rows(n):
            return (rng.random((n, 1, K)) < 0.5, rng.random((n, 1, K)) < 0.2,
                    rng.random((n, 1, K, V1)) < 0.6)

        a = rows(A)
        b = [np.swapaxes(x, 0, 1) for x in rows(B)]
        well_known = rng.random(K) < 0.5
        ta = [torch.from_numpy(x) for x in a]
        tb = [torch.from_numpy(x) for x in b]
        np.testing.assert_array_equal(
            tf.requirements_intersect(*ta, *tb).numpy(),
            np.asarray(jf.requirements_intersect(*a, *b)),
        )
        np.testing.assert_array_equal(
            tf.requirements_compatible(*ta, *tb, torch.from_numpy(well_known)).numpy(),
            np.asarray(jf.requirements_compatible(*a, *b, well_known)),
        )
        for t, j in zip(tf.merge_requirements(*ta, *tb), jf.merge_requirements(*a, *b)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
