# Copied from karpenter_tpu/faults/guard.py.
"""Post-solve invariant guard: refuse to commit a kernel solve that lies.

The fused kernel's outputs drive NodeClaim creation and existing-node
nomination; a kernel returning garbage (NaN propagation, a miscompiled
``.so``, an injected corruption from faults/) must be caught BEFORE any of
it is decoded onto the scheduler's node models — the checks here run on
the raw output arrays, so a violation costs nothing to roll back: the
caller quarantines the rung (faults/breaker.py) and re-solves on the host
oracle, whose results are correct by construction (PARITY.md).

Checked invariants, all array-level:

- shape/range sanity: finite values, non-negative fills, ``0 <= n_open <=
  nmax``, claim template ids within range;
- **conservation**: per group, existing fills + claim fills + unplaced
  equals the group's pod count — the property that makes the decode's
  cursor walk place every pod exactly once (decode round-trips);
- **capacity**: each open claim's accumulated requests fit at least one
  instance type the claim's type mask still allows, and each existing
  node's fills fit its available allocatable (daemon overhead is charged
  by the kernel on top of these, so the checks are strictly lenient —
  an honest solve can never trip them);
- **pool limits**: per NodePool, the batch's newly claimed requests stay
  within the pool's remaining limit (the kernel's own ``p_limit`` rows).

Float comparisons carry a small relative tolerance: requests/allocatable
are quantized float32 on device, exact on host float64.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_EPS = 1e-3  # quantized units; fills are integer counts of integer units


class SolverIntegrityError(RuntimeError):
    """A kernel solve violated a post-solve invariant; the solve must be
    discarded, never committed."""

    def __init__(self, violations: Sequence[str]):
        self.violations = list(violations)
        super().__init__(
            "kernel solve failed the invariant guard: "
            + "; ".join(self.violations[:5])
            + (f" (+{len(self.violations) - 5} more)"
               if len(self.violations) > 5 else "")
        )


class DecodeCommitError(RuntimeError):
    """Decode crashed AFTER committing existing-node fills onto the live
    scheduler models. The batch must be dropped (pods re-queue against a
    fresh solver next cycle) — an oracle re-solve in THIS solve would run
    on the polluted models and double-count the aborted placements."""


def _unpack_tmask(c_tmask: np.ndarray, n_open: int, T: int) -> np.ndarray:
    """[n_open, T] bool mask from either the raw bool mask or the
    bit-packed uint8 wire layout (ops/solve.py:_wire_pack). Columns past
    T are mesh padding (parallel/mesh.py pads the type axis to divide the
    mesh); padded types have zero allocatable, so trimming them can only
    make the capacity check stricter, never hide a violation."""
    rows = np.asarray(c_tmask[:n_open])
    if rows.dtype == np.uint8 and rows.shape[1] != T:
        rows = np.unpackbits(rows, axis=1)
    return rows[:, :T].astype(bool)


def check_solution(
    g_count: np.ndarray,          # [G] run-shape group counts
    g_req: np.ndarray,            # [G, R] quantized requests
    c_pool: np.ndarray,           # [NMAX]
    c_tmask: np.ndarray,          # [NMAX, T] bool or [NMAX, ceil(T/8)] u8
    n_open: int,
    exist_fills: np.ndarray,      # [G, N]
    claim_fills: np.ndarray,      # [G, NMAX]
    unplaced: np.ndarray,         # [G]
    t_alloc: np.ndarray,          # [T, R] quantized allocatable
    n_avail: np.ndarray,          # [N_real, R] quantized node headroom
    nmax: int,
    P: int,
    templates_pool: Optional[Sequence[str]] = None,
    p_limit: Optional[np.ndarray] = None,       # [P, R] remaining pool limit
    p_has_limit: Optional[np.ndarray] = None,   # [P, R] limit applies
    c_dzone: Optional[np.ndarray] = None,       # [NMAX] pinned zone ids
    c_dct: Optional[np.ndarray] = None,         # [NMAX] pinned ct ids
    zone_vals: int = 0,                         # valid zone-id bound
    ct_vals: int = 0,                           # valid ct-id bound
) -> List[str]:
    """Violation descriptions for one solve's raw outputs (empty = clean)."""
    v: List[str] = []
    g_count = np.asarray(g_count, np.float64)
    g_req = np.asarray(g_req, np.float64)
    exist_fills = np.asarray(exist_fills, np.float64)
    claim_fills = np.asarray(claim_fills, np.float64)
    unplaced = np.asarray(unplaced, np.float64)

    for name, arr in (
        ("exist_fills", exist_fills), ("claim_fills", claim_fills),
        ("unplaced", unplaced),
    ):
        if arr.size and not np.isfinite(arr).all():
            v.append(f"{name} contains non-finite values")
        elif arr.size and (arr < 0).any():
            v.append(f"{name} contains negative fills")
    if not (0 <= int(n_open) <= nmax):
        v.append(f"n_open={int(n_open)} outside [0, nmax={nmax}]")
    if v:
        return v  # arithmetic below would just cascade from the same rot

    n_open = int(n_open)
    if n_open and (
        (np.asarray(c_pool[:n_open]) < 0).any()
        or (np.asarray(c_pool[:n_open]) >= P).any()
    ):
        v.append(f"claim template ids outside [0, {P})")
        return v

    # domain pins drive vocab lookups in decode: an out-of-range pin would
    # crash mid-commit, so it must be caught here, pre-commit
    for name, pins, bound in (
        ("c_dzone", c_dzone, zone_vals), ("c_dct", c_dct, ct_vals),
    ):
        if pins is None or not n_open:
            continue
        rows = np.asarray(pins[:n_open], np.int64)
        if (rows < -1).any() or (rows >= bound).any():
            v.append(f"{name} pin ids outside [-1, {bound})")
    if v:
        return v

    # conservation: every pod of every group accounted for exactly once
    placed = exist_fills.sum(axis=1) + claim_fills.sum(axis=1) + unplaced
    bad = np.nonzero(np.abs(placed - g_count) > 0.5)[0]
    if bad.size:
        v.append(
            f"{bad.size} group(s) violate pod conservation "
            f"(e.g. group {int(bad[0])}: placed+unplaced="
            f"{placed[bad[0]]:.0f} != count={g_count[bad[0]]:.0f})"
        )

    # capacity: claim slots fit an allowed type; node fills fit headroom
    t_alloc = np.asarray(t_alloc, np.float64)
    T = t_alloc.shape[0]
    if n_open:
        req_slot = claim_fills[:, :n_open].T @ g_req  # [n_open, R]
        mask = _unpack_tmask(c_tmask, n_open, T)      # [n_open, T]
        if not mask.any(axis=1).all():
            v.append("open claim with an empty instance-type mask")
        else:
            fits = (
                req_slot[:, None, :] <= t_alloc[None, :, :] + _EPS
            ).all(axis=2)  # [n_open, T]
            bad = np.nonzero(~(fits & mask).any(axis=1))[0]
            if bad.size:
                v.append(
                    f"{bad.size} claim(s) exceed every allowed instance "
                    f"type's allocatable (e.g. slot {int(bad[0])})"
                )
    n_avail = np.asarray(n_avail, np.float64)
    N_real = n_avail.shape[0]
    if exist_fills.shape[1] > N_real and exist_fills[:, N_real:].any():
        v.append("fills on padded (nonexistent) node rows")
    if N_real:
        req_node = exist_fills[:, :N_real].T @ g_req  # [N_real, R]
        bad = np.nonzero((req_node > n_avail + _EPS).any(axis=1))[0]
        if bad.size:
            v.append(
                f"{bad.size} existing node(s) filled beyond available "
                f"capacity (e.g. node {int(bad[0])})"
            )

    # pool limits: new claims alone must stay within the remaining limit
    if (
        n_open
        and templates_pool is not None
        and p_limit is not None
        and p_has_limit is not None
        and np.asarray(p_has_limit).any()
    ):
        p_limit = np.asarray(p_limit, np.float64)
        p_has_limit = np.asarray(p_has_limit, bool)
        req_slot = claim_fills[:, :n_open].T @ g_req
        pools = {}
        for slot in range(n_open):
            p = int(np.asarray(c_pool)[slot])
            pools.setdefault(templates_pool[p], [p, np.zeros(g_req.shape[1])])
            pools[templates_pool[p]][1] += req_slot[slot]
        for pool, (p, total) in pools.items():
            over = p_has_limit[p] & (total > p_limit[p] + _EPS)
            if over.any():
                v.append(f"claims for pool {pool!r} exceed its limits")
    return v


__all__ = ["SolverIntegrityError", "check_solution"]
