"""Time kernel B4 over the tenant cell's scan, tiled and untiled, on one card.

The tenant cell of chip_smoke.py's phase 9 (tenant-pools-50k: 64 tainted
NodePools capped at 4,000 CPUs over 800 types, 6,000 VPA-sized
Deployments, 50,816 pods) is encoded and staged on the card once, as the
driver stages it; then the scan (ops/packing.py:pack) runs over those
args in the tiled mode (each real step builds its feasibility rows) and
untiled (over B1's tables), alternating, REPS times each after a warm-up,
each call timed with CUDA events. The two modes' outputs must be
identical. Prints the card's name and power limit, then one JSON line:
every time, the medians, and the row build by difference (tiled median -
untiled median).

Two checkouts are compared only within one call on one card: run this
from each in turn, in the order A, B, B, A
(``cd <checkout> && python3 tenant_scan.py``).
"""

from __future__ import annotations

import json
import statistics
import sys

import chip_smoke as cs

REPS = 3


def main():
    cs.pin_one_card()
    import torch

    if not torch.cuda.is_available():
        print("tenant_scan: CUDA is not available", file=sys.stderr)
        return 2
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import packing, solve
    from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import tenant_pods, tenant_pools

    _build.build(names=("fresh_feasibility", "pack"), force=True)
    pods = tenant_pods(cs.N_DEPLOY, cs.N_TENANTS)
    solver = cs.build_batch(TorchSolver, SolverConfig, pods, cs.TENANT_TYPES,
                            pools=tenant_pools(cs.N_TENANTS))
    args, statics, nmax, _ = cs.device_snapshot(solver, pods)
    if not statics["tile_feasibility"]:
        print("tenant_scan: the driver did not choose the tiled mode", file=sys.stderr)
        return 1
    a = dict(zip(SOLVE_ARG_NAMES, args))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"])
    tin = solve.pack_args(a, *solve._feasibility_tables(a, zk, ck, tile_feasibility=True))
    uin = solve.pack_args(a, *solve._feasibility_tables(a, zk, ck, True))
    modes = {"tiled": lambda: packing.pack(*tin, **st, tile_feasibility=True),
             "untiled": lambda: packing.pack(*uin, **st)}
    outs = {mode: cs.timed(fn)[0] for mode, fn in modes.items()}  # warm-up
    err = cs.max_abs_err(outs["tiled"], outs["untiled"])
    if err or bool(outs["tiled"][3]):
        print(f"tenant_scan: max |tiled - untiled| {err}, overflow {bool(outs['tiled'][3])}",
              file=sys.stderr)
        return 1
    ms = {mode: [] for mode in modes}
    for _ in range(REPS):
        for mode, fn in modes.items():
            ms[mode].append(cs.timed(fn)[1])
    p50 = {mode: statistics.median(t) for mode, t in ms.items()}
    print(cs.nvidia_smi_line())
    print(json.dumps(dict(
        ms=ms, p50_ms=p50, row_build_ms=p50["tiled"] - p50["untiled"], nmax=nmax,
        real_steps=int((a["g_count"] > 0).sum()), claims=int(outs["tiled"][2]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
