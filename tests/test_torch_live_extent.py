"""The live-extent invariant of the packing scans, on the CPU.

Kernels B4 and B5 walk the claim axis only up to the open claims
(``n_open``), never to NMAX (csrc/pack_common.cuh: "The live extent"). That
is exact because every slot at or past ``n_open`` keeps its initial state,
and because NMAX only bounds the slots, never decides a placement while
the scan does not overflow. This file holds both facts on the reference
and on the port's plain versions, on the parity batches of
test_torch_packing.py, test_torch_classed.py, test_torch_domains.py and
test_torch_tiled.py:

- every claim-axis output past ``n_open`` is its initial value:
  ``claim_fills[:, n_open:] == 0``, ``c_pool`` 0, ``c_tmask`` clear,
  ``c_dzone`` / ``c_dct`` -1, ``c_resv`` clear; the same for the final
  state's ``c_npods``, ``c_used``, ``c_def``, ``c_neg``, ``c_mask`` and
  ``ch_cnt`` where the scan returns it (B5's plain version);
- a run with NMAX doubled gives the same outputs on ``[:n_open]`` (and the
  same exist_fills, unplaced, n_open).

B5's class head works only for the claims that can take the class (a
claim of another tainted pool, or one whose keys clash, gets zero
summaries and no type walk): the tenant cases hold B5's plain version to
JAX ``pack_classed`` on a cluster of 8 tainted tenant pools, where each
class head sees mostly claims of other pools, untiled and tiled, at NMAX
and doubled NMAX.

JAX ``pack`` / ``pack_classed`` / ``solve_all`` run on the CPU as the
parity files run them; the port's ``pack_reference`` /
``pack_classed_reference`` / ``solve_core`` on CPU tensors. Also B8's plain
version against JAX ``delta_apply_rows`` on the edge cases the card tests
give the kernel. Tolerance: exact equality throughout.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import snapshot_args
from karpenter_tpu.solver.example import example_snapshot_arrays
from karpenter_tpu.solver.workloads import diverse_reference_mix, mixed_pods
from test_torch_cuda import b8_case
from test_torch_classed import (
    _anti_affinity,
    _both_scans,
    _mixed_axes,
    _snapshot,
    _zonal_affinity,
    _zonal_selectors,
)
from test_torch_domains import CASES as DOMAIN_CASES
from test_torch_domains import _domain_snapshot

OUT_NAMES = ("c_pool", "c_tmask", "n_open", "overflow", "exist_fills",
             "claim_fills", "unplaced", "c_dzone", "c_dct", "c_resv")
# the claim-axis outputs and their initial values (PackState init)
CLAIM_INIT = {"c_pool": 0, "c_tmask": False, "c_dzone": -1, "c_dct": -1, "c_resv": False}
# ... and the claim-axis state fields
STATE_INIT = {"c_npods": 0, "c_used": 0.0, "c_def": False, "c_neg": False, "c_mask": True,
              "ch_cnt": 0}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _named(outs):
    return {name: _np(x) for name, x in zip(OUT_NAMES, outs)}


def _check_dead_slots(out, what):
    """Every claim-axis output at or past n_open holds its initial value."""
    n = int(out["n_open"])
    assert not bool(out["overflow"]), f"{what}: the base run overflows"
    assert not out["claim_fills"][:, n:].any(), f"{what}: claim_fills past n_open"
    for name, init in CLAIM_INIT.items():
        assert (out[name][n:] == init).all(), f"{what}: {name} past n_open"
    return n


def _check_state(state, n, what):
    for name, init in STATE_INIT.items():
        assert (_np(getattr(state, name))[n:] == init).all(), f"{what}: state {name} past n_open"


def _check_doubled(base, doubled, n, what):
    """The doubled-NMAX run equals the base run on the live slots."""
    assert int(doubled["n_open"]) == n and not bool(doubled["overflow"]), what
    for name in ("exist_fills", "unplaced"):
        np.testing.assert_array_equal(doubled[name], base[name], err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(doubled["claim_fills"][:, :n], base["claim_fills"][:, :n],
                                  err_msg=f"{what}: claim_fills")
    for name in CLAIM_INIT:
        np.testing.assert_array_equal(doubled[name][:n], base[name][:n],
                                      err_msg=f"{what}: {name}")
    _check_dead_slots(doubled, what + " doubled")


def _solve_both(args, statics, nmax):
    """JAX solve_all and the port's solve_core (pack_reference behind the
    feasibility tables) at ``nmax``: their 10 outputs, each equal."""
    import jax
    from karpenter_tpu.ops.solve import solve_all
    from karpenter_tpu_torch.ops.solve import solve_core
    from karpenter_tpu_torch.solver.args import to_device_args

    st = dict(statics, nmax=nmax)
    want = _named(jax.device_get(solve_all(*args, **st)))
    got = _named(solve_core(*to_device_args([np.asarray(x) for x in args], "cpu"), **st))
    for name in OUT_NAMES:
        np.testing.assert_array_equal(got[name].astype(want[name].dtype), want[name],
                                      err_msg=name)
    return want, got


def _extent_case(args, statics, nmax):
    outs = {}
    for m in (nmax, 2 * nmax):
        outs[m] = _solve_both(args, statics, m)
    n = None
    for k, what in enumerate(("jax", "port")):
        base, doubled = outs[nmax][k], outs[2 * nmax][k]
        n = _check_dead_slots(base, what)
        _check_doubled(base, doubled, n, what)
    return n


# -- B4's plain version and JAX pack, through the solve ---------------------------


@pytest.mark.parametrize("n_pods,n_types,shapes", [(64, 16, 4), (200, 40, 8)])
def test_example_snapshots_live_extent(n_pods, n_types, shapes):
    args, statics = example_snapshot_arrays(n_pods, n_types, shapes)
    st = dict(statics, sparse_groups=True)
    assert _extent_case(args, st, statics["nmax"]) > 0


@pytest.mark.parametrize("case", ["zonal-spread-skew1", "zonal-affinity-bootstrap",
                                  "gate-owner", "nodes-with-priors"])
def test_domain_batches_live_extent(case):
    args, statics, _ = _domain_snapshot(*DOMAIN_CASES[case]())
    assert _extent_case(args, statics, statics["nmax"]) > 0


def test_existing_nodes_and_hostname_caps_live_extent():
    from helpers import make_state_node

    nodes = [make_state_node(name=f"en-{i}", cpu="4", memory="16Gi") for i in range(3)]
    args, statics = snapshot_args(mixed_pods(150) + _anti_affinity(12), n_types=20,
                                  state_nodes=nodes)
    assert _extent_case(args, dict(statics, sparse_groups=True), 64) > 0


def test_tiled_live_extent():
    """The tiled mode (each step builds its rows)."""
    args, statics = snapshot_args(mixed_pods(160), n_types=24)
    st = dict(statics, tile_feasibility=True, sparse_groups=False)
    assert _extent_case(args, st, 64) > 0


# -- contributor counting (JAX pack) and B5 (JAX pack_classed) ------------------


@pytest.mark.parametrize("case", ["diverse", "zonal-selectors"])
def test_pack_contrib_live_extent(case):
    pods = diverse_reference_mix(120) if case == "diverse" else _zonal_selectors()
    a, statics, _ = _snapshot(pods)
    outs = {}
    for m in (64, 128):
        j, t = _both_scans(a, statics, nmax=m)
        js, jf = j[0], j[1:]
        outs[m] = (
            _named((js.c_pool, js.c_tmask, js.n_open, js.overflow, *jf, js.c_dzone,
                    js.c_dct, js.c_resv)),
            _named(t),
        )
    for k, what in enumerate(("jax", "port")):
        n = _check_dead_slots(outs[64][k], what)
        _check_doubled(outs[64][k], outs[128][k], n, what)


@pytest.mark.parametrize("case", ["diverse", "mixed-axes", "anti-affinity", "zonal-affinity"])
def test_pack_classed_live_extent(case):
    pods = {"diverse": lambda: diverse_reference_mix(200), "mixed-axes": _mixed_axes,
            "anti-affinity": _anti_affinity, "zonal-affinity": _zonal_affinity}[case]()
    a, statics, classes = _snapshot(pods, n_types=30)
    outs = {}
    for m in (64, 128):
        j, t = _both_scans(a, statics, nmax=m, classes=classes)
        outs[m] = tuple(
            (s, _named((s.c_pool, s.c_tmask, s.n_open, s.overflow, *f, s.c_dzone, s.c_dct,
                        s.c_resv)))
            for s, *f in (j, t))
    for k, what in enumerate(("jax", "port")):
        state, base = outs[64][k]
        n = _check_dead_slots(base, what)
        _check_state(state, n, what)
        _check_doubled(base, outs[128][k][1], n, what)
        _check_state(outs[128][k][0], n, what + " doubled")


def _tenant_classed(n_tenants, n_deployments, n_types):
    """JAX encoding of ``n_deployments`` tenant Deployments over
    ``n_tenants`` tainted, limited pools (solver/example.py, the tenant
    cell's shape) with the class partition forced."""
    from test_torch_minvalues import snapshot
    from test_torch_tiled import _tenant_objects

    pools, pods, its = _tenant_objects(n_tenants, n_deployments, n_types)
    return snapshot(pods, pools, its=its)


def _classed_solve_both(a, statics, classes, nmax, tiled):
    """JAX solve_core_classed and the port's (pack_classed_reference) on the
    same arrays at ``nmax``, untiled or tiled: their 10 outputs, each
    equal."""
    import jax
    from karpenter_tpu.ops.solve import solve_core_classed as jax_classed
    from karpenter_tpu_torch.ops.solve import solve_core_classed
    from karpenter_tpu_torch.solver.args import to_device_args
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

    *arrs, lmax = classes
    st = {k: v for k, v in statics.items() if k not in ("tile_feasibility", "sparse_groups")}
    st.update(nmax=nmax, lmax=lmax, tile_feasibility=tiled, sparse_groups=not tiled)
    args = [np.asarray(a[n]) for n in SOLVE_ARG_NAMES]
    want = _named(jax.device_get(jax.jit(jax_classed, static_argnames=tuple(st))(
        *args, *arrs, **st)))
    got = _named(solve_core_classed(*to_device_args(args, "cpu"),
                                    *(torch.from_numpy(np.asarray(x)) for x in arrs), **st))
    for name in OUT_NAMES:
        np.testing.assert_array_equal(got[name].astype(want[name].dtype), want[name],
                                      err_msg=name)
    return want, got


def _zone_selectors():
    """Three zone-pinned classes and one free class on one pool: the head
    of each pinned class sees the claims pinned to the other zones, whose
    zone keys clash with it."""
    from helpers import make_pods
    from karpenter_tpu.cloudprovider import corpus

    pods = []
    for i, zone in enumerate(corpus.DEFAULT_ZONES[:3]):
        pods += make_pods(12, cpu=f"{1 + i}", memory="2Gi",
                          node_selector={"topology.kubernetes.io/zone": zone})
    return pods + make_pods(10, cpu="1", memory="1Gi")


@pytest.mark.parametrize("case,tiled", [("tenant", False), ("tenant", True),
                                        ("zone-selectors", False)],
                         ids=["tenant-untiled", "tenant-tiled", "zone-selectors"])
def test_pack_classed_heads_skip_claims_live_extent(case, tiled):
    """Class heads that see claims which cannot take the class: 8 tainted
    tenant pools x 80 VPA-sized Deployments, each its own class (every
    head sees the claims of the other 7 pools), untiled and tiled; and
    zone-pinned classes whose heads see claims pinned elsewhere. JAX
    pack_classed == B5's plain version at NMAX and doubled NMAX, the dead
    slots at their initial values."""
    if case == "tenant":
        a, statics, classes = _tenant_classed(8, 80, 24)
        real = a["g_count"] > 0
        assert (a["p_tol"].sum(0)[real] == 1).all(), "each group tolerates one pool"
        assert int((classes[1] > 0).sum()) == 80
    else:
        a, statics, classes = _snapshot(_zone_selectors(), n_types=24)
        assert int((classes[1] > 0).sum()) == 4
    outs = {m: _classed_solve_both(a, statics, classes, m, tiled) for m in (256, 512)}
    for k, what in enumerate(("jax", "port")):
        n = _check_dead_slots(outs[256][k], what)
        _check_doubled(outs[256][k], outs[512][k], n, what)
        if case == "tenant":
            assert len(set(outs[256][k]["c_pool"][:n].tolist())) == 8, "claims of every pool"


# -- B8's plain version on the kernel's edge cases --------------------------------


@pytest.mark.parametrize("case", ["ragged-rows", "uneven-blocks", "every-row", "edge-indices"])
def test_delta_apply_rows_edges_equal_jax(case):
    from karpenter_tpu.ops.solve import delta_apply_rows as jax_apply
    from karpenter_tpu_torch.ops.solve import delta_apply_rows, delta_apply_rows_reference

    arr, idx, rows = b8_case(case, np.random.default_rng(len(case)))
    want = np.asarray(jax_apply(arr, idx, rows))
    before = torch.from_numpy(arr.copy())
    got = delta_apply_rows_reference(before, torch.from_numpy(idx), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(delta_apply_rows(before, idx, rows).numpy(), want)
    np.testing.assert_array_equal(before.numpy(), arr)


def test_delta_apply_rows_empty_delta():
    """An empty delta returns the buffer itself and launches nothing."""
    from karpenter_tpu.ops.solve import delta_apply_rows as jax_apply
    from karpenter_tpu_torch.ops.solve import delta_apply_rows

    arr = np.arange(12, dtype=np.int32).reshape(4, 3)
    idx, rows = np.zeros(0, np.int32), np.zeros((0, 3), np.int32)
    np.testing.assert_array_equal(np.asarray(jax_apply(arr, idx, rows)), arr)
    buf = torch.from_numpy(arr)
    assert delta_apply_rows(buf, idx, rows) is buf
