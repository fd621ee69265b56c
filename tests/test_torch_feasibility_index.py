"""Port parity: B1's and B2's plain versions against JAX on any order of
the live-pair index.

The JAX tables (karpenter_tpu/ops/feasibility.py:
fresh_claim_feasibility_sparse, existing_node_feasibility_sparse) sum the
live (group, key) pairs onto the group axis with segment_sum and scatter
the offering rows of goff_idx's groups: neither depends on the index's
order, and the encoder's sort by group is not part of the contract. These
cases pin that order-freedom for the port's plain versions, which the
CUDA kernels are held to bit for bit on the card (the same generators,
tests/test_torch_cuda.py): pairs shuffled, weight-0 padding of random
(group, key) interleaved, a pair listed twice, goff_idx with repeats,
two templates, two mask words a key, the scenario axis of n_tol, and the
constrained snapshot (a JAX encoding, G <= 64) with its index reordered.
Inputs are made from a numpy seed. Tolerance: exact equality of every
output.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import make_state_node, snapshot_args
from karpenter_tpu.ops import feasibility as jf
from karpenter_tpu.solver.encode import SOLVE_ARG_NAMES
from karpenter_tpu_torch.ops import feasibility as tf
from test_torch_cuda import (
    B1_NAMES,
    B2_NAMES,
    INDEX_CASES,
    reorder_index,
    sparse_index_case,
)

CASES = INDEX_CASES + ("constrained-small",)


def _constrained_small():
    """The constrained mix encoded by the JAX package over 6 nodes in three
    zones (G <= 64, live pairs and goff_idx rows), its index reordered:
    shuffled, 16 pads interleaved, 4 pairs repeated, goff_idx twice."""
    from karpenter_tpu.solver.workloads import constrained_mix

    nodes = [make_state_node(name=f"tn-{i}",
                             zone=("test-zone-a", "test-zone-b", "test-zone-c")[i % 3])
             for i in range(6)]
    args, st = snapshot_args(constrained_mix(200, seed=5), n_types=24, state_nodes=nodes,
                             require_full_routing=False)
    a = {n: np.asarray(x) for n, x in zip(SOLVE_ARG_NAMES, args)}
    assert a["g_mask"].shape[0] <= 64 and (a["gk_w"] != 0).sum() > 0
    idx = reorder_index(np.random.default_rng(9), a["gk_g"], a["gk_k"], a["gk_w"],
                        a["goff_idx"], n_pad=16, repeats=4, goff_twice=True)
    a.update(zip(("gk_g", "gk_k", "gk_w", "goff_idx"), idx))
    return a, st["zone_kid"], st["ct_kid"]


def _case(case):
    return _constrained_small() if case == "constrained-small" else sparse_index_case(case)


def _same(name, jax_out, torch_out):
    j, t = np.asarray(jax_out), torch_out.numpy()
    assert t.shape == j.shape and t.dtype == j.dtype, name
    mism = np.argwhere(t != j)
    assert not mism.size, f"{name} diverges at {mism[:5].tolist()}"


@pytest.mark.parametrize("case", CASES)
def test_fresh_tables_any_index_order(case):
    a, zk, ck = _case(case)
    j_out = jf.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    t_out = tf.fresh_claim_feasibility_sparse(
        *(torch.from_numpy(np.ascontiguousarray(a[n])) for n in B1_NAMES),
        zone_kid=zk, ct_kid=ck)
    for name, jo, to in zip(("compat_pg", "type_ok", "n_fit"), j_out, t_out):
        _same(name, jo, to)
    assert t_out[1].any() and t_out[0].any()


@pytest.mark.parametrize("case", CASES)
def test_existing_caps_any_index_order(case):
    a, _, _ = _case(case)
    pre = [a[n] for n in B2_NAMES[:8]]
    post = [a[n] for n in B2_NAMES[9:]]

    def j_caps(tol):
        return jf.existing_node_feasibility_sparse(*pre, tol, *post)

    # the scenario axis: JAX's scenario path vmaps the [N, G] gate
    j_cap = jax.vmap(j_caps)(a["n_tol"]) if a["n_tol"].ndim == 3 else j_caps(a["n_tol"])
    t_cap = tf.existing_node_feasibility_sparse(
        *(torch.from_numpy(np.ascontiguousarray(a[n])) for n in B2_NAMES))
    _same("cap_ng", j_cap, t_cap)
    assert int(t_cap.max()) > 0
