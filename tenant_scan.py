"""Time kernels B4 and B5, the packing scans, on one card, split by phase;
B1 and B2, the sparse feasibility tables; B3, the dense ones; and B6.

    python3 tenant_scan.py                  # every shape, phase clocks on
    python3 tenant_scan.py --no-clocks      # times only (a checkout without
                                            # the phase-clock builds)
    python3 tenant_scan.py --shapes tenant  # a subset
    python3 tenant_scan.py --shapes diverse_classed --clusters 1 2 4 \
        --classed-clocks pack_classed_clocks pack_classed_clocks_c1
                                            # B5 at each cluster width, and
                                            # its split at two widths
    python3 tenant_scan.py --no-clocks --shapes dense_relax wire_mixed  # B3, B6
    python3 tenant_scan.py --no-clocks --shapes feas_mixed feas_diverse \
        feas_constrained feas_nodes feas_cons
                                            # B1, B2 and B7's dispatch

Five solve shapes, each encoded and staged on the card once, as the
driver stages it (chip_smoke.py's batches):

- ``tenant``: the tenant cell of chip_smoke.py's phase 9 (64 tainted
  NodePools capped at 4,000 CPUs over 800 types, 6,000 VPA-sized
  Deployments, 50,816 pods; NMAX 16384), whose scan the driver runs in the
  tiled mode (each real step builds its feasibility rows); it also runs
  untiled over B1's tables, the two modes alternating, and the row build
  is their difference;
- ``mixed``: mixed_pods(50,000) x 400 types (NMAX 1024, domain-free);
- ``constrained``: constrained_mix(50,000) x 800 types (the domain
  machinery);
- ``diverse_contrib``: diverse_reference_mix(5,000) x 400 types through B4
  (the classed route off: contributor counting);
- ``minvalues``: minvalues-50k, mixed_pods(50,000, no GPU) x 400 types
  over the minValues NodePool (an instance-family floor: B4's minValues
  phases at a narrow catalog).

Each scan runs REPS times after a warm-up (NMAX doubled while it
overflows, as the driver does), timed with CUDA events. With the clocks
on, the same scan then runs once from the phase-clock build of
csrc/pack.cu (``-DKT_PHASE_CLOCKS``, library ``pack_clocks``, built here
only): thread 0 of the block adds %globaltimer nanoseconds per phase
(init, load, tile, claims, exist, quota, tier1, tier2, commit, fresh,
contrib, outputs), and its outputs must equal the timed scan's. The
clock build's barriers at each mark make its total larger than the timed
scan's.

Three shapes of B5, the class-batched scan, each over the driver's class
partition with the classed route forced (SolverConfig(classed=True)), as
chip_smoke.py's phase 2 and phase 9(d) run it:

- ``diverse_classed``: diverse_reference_mix(5,000) x 400 types
  (diverse-ref, NMAX 8192);
- ``diverse_minvalues``: the same pods over the minValues NodePool (B5's
  minValues headroom);
- ``tenant_classed``: the tenant cell, which the driver tiles (B5 builds
  each class head's rows; ~6,000 one-Deployment classes).

Each runs REPS times after a warm-up (CUDA events; NMAX doubled while it
overflows), from the solver's library and, with ``--clusters``, from each
measurement build ``pack_classed_c<C>`` (clusters of at most C blocks;
the solver's library takes 8), in turns, every build's outputs equal to the solver library's. With the
clocks on, once from each library of ``--classed-clocks`` (default
``pack_classed_clocks``, B5's phase-clock build; ``pack_classed_clocks_c1``
the same at one block), split into init, head (the class rows and the
per-claim head), exist, quota, tier1, tier2 (the claim caps included),
commit, summaries, fresh, contrib, outputs and settle, its outputs equal
to the timed scan's. Each row also carries the cluster its launches took
(ops/packing.py:classed_clusters, where the checkout has it).

Two consolidation shapes, B4 over a scenario grid (kernel B7):

- ``cons``: MultiNodeConsolidation at 2,000 nodes (chip_smoke.py's phase
  4), ``cons_minvalues``: the same over the minValues floor (phase 8).
  Each times ``compute_command`` on a fresh environment CONS_PASSES times
  (the first pass apart; host clock after a garbage collection, ending in
  a device sync), then B4
  over the search's 16-scenario chunk through the wrapper (CUDA events)
  and on the device alone (torch.profiler: the scan kernel's time a
  call, and every device activity's), with the cluster the launches took
  (ops/packing.py:clusters, where the checkout has it).

Five shapes of B1 and B2, the sparse feasibility tables that start every
dispatch (``--shapes feas_mixed ...``), each staged as chip_smoke.py's
phase 2 stages it, the kernel's outputs equal to its plain version's:

- ``feas_mixed``: B1 at mixed 50k x 400 (G=64, T=400);
- ``feas_diverse``: B1 at diverse-ref 5,000 x 400 (G=2048);
- ``feas_constrained``: B1 at constrained 50k x 800 (G=256, T=800, the
  only cell with live pairs);
- ``feas_nodes``: B2 at mixed 2,000 x 400 over 32 StateNodes;
- ``feas_cons``: B1 and B2[S] at the consolidation chunk (S=16, N=2048),
  and the whole scenario dispatch (kernel B7) over them;
- ``feas_partial``: B1's partial mode (the solver mesh's shard stage) at
  chip_smoke.py's phase 16 shape, constrained 50k x 800 over data 2 x
  model 4 on the card, shard (0, 0);
- ``feas_team_in``: B1 at chip_smoke.py's phase 10 team-In input (a pool
  listing 1,100 teams, 40 pods: K 16, V1 2048, G 64, T 400), whose masks
  pass the staged mode's shared memory (the direct mode: a word pass
  across the card, then the tables), with the layout the checkout's
  ``fresh_layout`` reports.

Each kernel is timed through its wrapper (CUDA events, the median of
FEAS_REPS calls) and on the device alone (torch.profiler over repeated
wrapper calls: every device activity a call, by name); with the clocks
on, B1 also from its phase-clock build (``fresh_feasibility_clocks``),
split into stage, words, base, pairs, compat and cells; at feas_mixed (B1)
and feas_nodes (B2), where the checkout binds the C entries once, its
launch path is split on the host clock: the whole wrapper, the C entry
alone (ctypes and the launch) and the output allocations.

Three shapes of B3, the dense tables (``--shapes dense_relax dense_route
dense_nodes``): its fresh entry at the relax path's run heads of identical
50k x 400 (1 x 400) and at the dense route's mixed 50k x 400 (G=64), its
existing entry at the state-node snapshot (32 nodes, G=64); and two of B6,
the wire pack (``wire_mixed``: the mixed 50k solve's scan outputs,
``wire_cons``: the consolidation chunk's, S = 16). Each is timed through
its wrapper and on the device alone, as B1 and B2 are, its outputs equal
to its plain version's; these use only the public wrappers, so the script
runs in a checkout of the parent tree as well.

``relax``: B9 at the relax path's shape (identical 50k x 400: GE 1, NR
1024, T 400), its inputs built as the checkout's ops/relax.py:solve_bulk
builds them (from B3's head tables on the card, or, where the checkout's
B9 takes the earlier nine inputs, rows gathered on the host and copied to the
card): the wrapper (CUDA events), the device alone with its activities a
call (torch.profiler), the host microseconds a wrapper call (a sync after
HOST_REPS calls), and ``solve_bulk`` whole, the relax span's work (B3,
its readback, the claim sizes, B9's inputs to the card, B9, its
readback), on the host clock over RELAX_REPS calls, each ending in a
readback; the kernel's outputs equal its plain version's. It uses only
entry points both entries share, so it runs in a parent checkout too.

``fold`` and ``fold_d2m4``: the solver mesh's fold (B10,
csrc/mesh_fold.cu) at phase 16(b)'s shape (D 8 data shards x M 1, P 1,
G 256, T 800: constrained 50k x 800 over data 8) and over data 2 x model
4 (T/M 200), on seeded partials (mostly zero counts; the fold's work does
not depend on them): the wrapper (CUDA events), the device alone
(torch.profiler), the host microseconds a wrapper call (a sync after
HOST_REPS calls), and the library's two yardsticks, ``Tensor.sum(0)`` of
the stacked fail_t and ``torch.stack(partials).sum(0)`` of the D x M
partials as a list; the fold's outputs equal its plain version's. A
checkout whose fold takes the partials as lists (``nfail=()``) is given
them so, so it runs in a parent checkout too.

Four shapes of B4 at a wide value vocabulary (``--shapes wide_team_in
wide_listed wide_mv_types wide_mv_types_800``), each built as
chip_smoke.py's phase 10 builds it (``wide_inputs``, ``device_snapshot``)
and timed and split as the solve shapes above are:

- ``wide_team_in``: a NodePool listing 1,100 teams with 40 pods, pod i
  selecting team-i (K 16, V1 2048, T 400, domain-free);
- ``wide_listed``: a NodePool listing 600 of 800 instance types at
  mixed_pods(50,000) (V1 1024, T 600);
- ``wide_mv_types``: minValues 2 on the instance type over 1,100 types at
  mixed_pods(2,000) (V1 4, MW 2048);
- ``wide_mv_types_800``: the same floor over corpus.generate(800), the
  catalog width of BASELINE's constrained cell (MW 1024).

Each also reports the scan's layout (the dynamic shared memory a block
asks for and the spill scratch, ops/packing.py:layouts), its device
time (torch.profiler: the scan kernel's, and every device activity's a
call: the wrapper's zeroing and word passes too), the plain version's
time (its outputs equal to the kernel's) and the bound, as chip_smoke.py's
``wide_pack_row`` reckons them.

``listed_solve``: the solve that chip_smoke.py's phase 10 times at the
listed pool (600 of 800 types listed, mixed_pods(50,000), V1 1024): the
p50 of 5 cold card solves on a warm catalog cache and one traced solve's
span split (partition, encode, transfer, dispatch, guard, decode, other),
as ``wide_timings`` measures it. Copied into a parent checkout, it times
that checkout's solver, so the end-to-end change of a kernel is read A,
B, B, A.

``wide``: each of chip_smoke.py's wide value vocabularies (ROADMAP §C1)
through one cold ``TorchSolver(device="cuda").solve``, its claims and
seconds or what it raised and where (in a parent checkout with this
chip_smoke.py beside it, the record of what raised before C1's repair).

Prints the card's name and power limit, then one JSON line. Two
checkouts are compared only within one call on one card: run this from
each in turn, in the order A, B, B, A
(``cd <checkout> && python3 tenant_scan.py --no-clocks``).
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import statistics
import sys
import time

import chip_smoke as cs

REPS = 3
CONS_PASSES = 6  # the first warms, as chip_smoke.py's phase 4
SCAN_SHAPES = ("tenant", "mixed", "constrained", "diverse_contrib", "minvalues")
# the wide shapes: chip_smoke.py's wide_inputs label of each, or (for
# the minValues floor at BASELINE's catalog width) the catalog's types
WIDE_SHAPES = {"wide_team_in": "team_in", "wide_listed": "listed_types",
               "wide_mv_types": "mv_types", "wide_mv_types_800": 800}
CLASSED_SHAPES = ("diverse_classed", "diverse_minvalues", "tenant_classed")
CONS_SHAPES = ("cons", "cons_minvalues")
FEAS_SHAPES = ("feas_mixed", "feas_diverse", "feas_constrained", "feas_nodes", "feas_cons",
               "feas_team_in", "feas_partial")
DENSE_SHAPES = ("dense_relax", "dense_route", "dense_nodes")
WIRE_SHAPES = ("wire_mixed", "wire_cons")
# the fold's shapes: (D, M, P, G, T)
FOLD_SHAPES = {"fold": (8, 1, 1, 256, 800), "fold_d2m4": (2, 4, 1, 256, 800)}
RELAX_REPS = 50
SHAPES = (SCAN_SHAPES + tuple(WIDE_SHAPES) + CLASSED_SHAPES + CONS_SHAPES + FEAS_SHAPES
          + DENSE_SHAPES + WIRE_SHAPES + tuple(FOLD_SHAPES) + ("relax", "wide", "listed_solve"))
FEAS_REPS = 200
HOST_REPS = 2000
FEAS_PHASES = ("stage", "words", "base", "pairs", "compat", "cells")
PHASES = ("init", "load", "tile", "claims", "exist", "quota", "tier1", "tier2", "commit",
          "fresh", "contrib", "outputs")
CLASSED_PHASES = ("init", "head", "exist", "quota", "tier1", "tier2", "commit", "summaries",
                  "fresh", "contrib", "outputs", "settle")


def shape_inputs(shape):
    """(pods, n_types, pools, catalog or None) of one shape."""
    from karpenter_tpu_torch.solver import example, workloads

    if shape in WIDE_SHAPES and isinstance(WIDE_SHAPES[shape], int):
        from karpenter_tpu_torch.cloudprovider import corpus

        return (workloads.mixed_pods(cs.MV_PODS), 0, [cs.type_pool(min_values=2)],
                corpus.generate(WIDE_SHAPES[shape]))
    if shape in WIDE_SHAPES:
        _, pools, catalog, pods = [w for w in cs.wide_inputs(full=False)
                                   if w[0] == WIDE_SHAPES[shape]][0]
        return pods, 0, pools(), catalog()
    if shape == "tenant":
        return (example.tenant_pods(cs.N_DEPLOY, cs.N_TENANTS), cs.TENANT_TYPES,
                example.tenant_pools(cs.N_TENANTS), None)
    if shape == "mixed":
        return workloads.mixed_pods(cs.N_PODS), cs.N_TYPES, None, None
    if shape == "minvalues":
        return (workloads.mixed_pods(cs.N_PODS, gpu_fraction=0.0), cs.N_TYPES,
                [example.minvalues_nodepool()], None)
    if shape == "constrained":
        return workloads.constrained_mix(cs.N_PODS), cs.N_TYPES_C, None, None
    return workloads.diverse_reference_mix(cs.N_DIVERSE), cs.N_TYPES, None, None


def phase_clocks(fn, library, n_phases):
    """The per-phase milliseconds of phase-clock build ``library`` over one
    ``fn()``."""
    import torch

    from karpenter_tpu_torch import _build

    read = getattr(_build.library(library), _build._entries(library)[-1])
    buf = (ctypes.c_ulonglong * n_phases)()
    torch.cuda.synchronize()
    if read(buf, n_phases):  # zeroes the totals
        raise RuntimeError("reading the phase clocks failed")
    out = fn()
    torch.cuda.synchronize()
    if read(buf, n_phases):
        raise RuntimeError("reading the phase clocks failed")
    return out, [ns / 1e6 for ns in buf]


def run_shape(shape, clocks):
    import torch

    from karpenter_tpu_torch.ops import packing, solve
    from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

    pods, n_types, pools, catalog = shape_inputs(shape)
    solver = cs.build_batch(TorchSolver, SolverConfig, pods, n_types, pools=pools, its=catalog)
    args, statics, nmax, _ = cs.device_snapshot(solver, pods)
    tiled = bool(statics["tile_feasibility"])
    if tiled != (shape == "tenant"):
        raise RuntimeError(f"{shape}: the driver chose tile_feasibility={tiled}")
    a = dict(zip(SOLVE_ARG_NAMES, args))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"])
    uin = solve.pack_args(a, *solve._feasibility_tables(a, zk, ck, True))
    modes = {"untiled": (uin, {})}
    if tiled:
        tin = solve.pack_args(a, *solve._feasibility_tables(a, zk, ck, tile_feasibility=True))
        modes = {"tiled": (tin, dict(tile_feasibility=True)), **modes}
    while True:  # the driver's overflow doubling
        outs = {m: cs.timed(lambda: packing.pack(*x, **st, **kw))[0]
                for m, (x, kw) in modes.items()}
        if not any(bool(o[3]) for o in outs.values()):
            break
        st["nmax"] *= 2
    main = next(iter(modes))
    if tiled:
        err = cs.max_abs_err(outs["tiled"], outs["untiled"])
        if err:
            raise RuntimeError(f"{shape}: max |tiled - untiled| {err}")
    ms = {m: [] for m in modes}
    for _ in range(REPS):
        for m, (x, kw) in modes.items():
            ms[m].append(cs.timed(lambda: packing.pack(*x, **st, **kw))[1])
    p50 = {m: statistics.median(t) for m, t in ms.items()}
    row = dict(ms=ms, p50_ms=p50, nmax=st["nmax"], claims=int(outs[main][2]),
               real_steps=int((a["g_count"] > 0).sum()), dims=dict(
                   G=int(a["g_count"].shape[0]), T=int(a["t_alloc"].shape[0]),
                   P=int(a["p_titype_ok"].shape[0]), N=int(a["n_avail"].shape[0])),
               has_domains=bool(st["has_domains"]), has_contrib=bool(st["has_contrib"]))
    if tiled:
        row["row_build_ms"] = p50["tiled"] - p50["untiled"]
    if shape in WIDE_SHAPES:
        x, kw = modes[main]
        packing.layouts.clear()
        row["device_ms"] = scan_device_ms(lambda: packing.pack(*x, **st, **kw), reps=5)
        row["layout"] = {"smem": [v[0] for v in packing.layouts.values()],
                         "spill": [v[1] for v in packing.layouts.values()]}
        row["dims"].update(V1=int(a["g_mask"].shape[2]), K=int(a["g_mask"].shape[1]),
                           MW=int(a["t_mvoh"].shape[-1]) if a["t_mvoh"].dim() == 3 else 0)
        # the plain version's time and the bound, as chip_smoke.py's
        # wide_pack_row reckons them
        ref, row["plain_ms"] = cs.timed(lambda: packing.pack_reference(*x, **st, **kw))
        if cs.max_abs_err(outs[main], ref):
            raise RuntimeError(f"{shape}: B4 differs from its plain version")
        P, MV = a["p_mvmin"].shape
        row["bound_ms"], row["bound_by"] = cs.bound_ms(
            cs.nbytes(x) + cs.nbytes(outs[main]),
            cs.pack_ops(a["g_count"], outs[main][5], outs[main][2], row["dims"]["T"],
                        int(a["t_alloc"].shape[1]), row["dims"]["V1"], P=P, mv=MV,
                        offered=cs.offered_words(a)))
    if clocks:
        x, kw = modes[main]
        out, split = phase_clocks(
            lambda: packing._launch_pack(*x, **st, **kw, library="pack_clocks"), "pack_clocks",
            len(PHASES))
        err = cs.max_abs_err(out, outs[main])
        if err:
            raise RuntimeError(f"{shape}: the phase-clock build differs by {err}")
        row["phase_ms"] = dict(zip(PHASES, split))
        row["phase_total_ms"] = sum(split)
    del outs
    torch.cuda.empty_cache()
    return row


def classed_inputs(shape):
    """B5's inputs for one classed shape, as the driver stages them with
    the classed route forced: (scan inputs, class arrays on the card,
    statics, named solve args, host class arrays)."""
    from karpenter_tpu_torch.ops import solve
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.solver.args import put
    from karpenter_tpu_torch.solver.driver import _CLASS_ARG_NAMES, SolverConfig, TorchSolver
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import minvalues_nodepool

    tenant = shape == "tenant_classed"
    pods, n_types, pools, _ = shape_inputs("tenant" if tenant else "diverse_contrib")
    if shape == "diverse_minvalues":
        pools = [minvalues_nodepool()]
    solver = cs.build_batch(TorchSolver, SolverConfig, pods, n_types, pools=pools, classed=True)
    host, snap, _, _ = cs.host_snapshot(solver, pods)
    run = snap.padded(enc._next_pow2(len(snap.groups), floor=8), 0)
    partition = solver._classed_partition(run, host[SOLVE_ARG_NAMES.index("res_cap0")])
    if partition is None:
        raise RuntimeError(f"{shape}: classed=True declined the class-batched scan")
    cls_host, lmax = partition
    cls = [put(n, x, "cuda") for n, x in zip(_CLASS_ARG_NAMES, cls_host)]
    args, statics, nmax, _ = cs.device_snapshot(solver, pods)
    tiled = bool(statics["tile_feasibility"])
    if tiled != tenant:
        raise RuntimeError(f"{shape}: the driver chose tile_feasibility={tiled}")
    a = dict(zip(SOLVE_ARG_NAMES, args))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    scan_in = solve.pack_args(a, *solve._feasibility_tables(a, zk, ck, True,
                                                            tile_feasibility=tiled))
    st = dict(nmax=nmax, lmax=lmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"],
              tile_feasibility=tiled)
    return scan_in, cls, st, a, cls_host


def run_classed(shape, clock_libs, widths):
    """B5 at one classed shape: p50s of the solver's library and of each
    cluster-width build (``widths``), in turns; each phase-clock build's
    split (``clock_libs``)."""
    import torch

    from karpenter_tpu_torch.ops import packing

    scan_in, cls, st, a, cls_host = classed_inputs(shape)

    def b5(library):
        """B5's final state and fills, flat."""
        out = packing._launch_pack_classed(*scan_in, *cls, **st, library=library)
        return list(out[0]) + list(out[1:])

    while True:  # the driver's overflow doubling
        state = packing._launch_pack_classed(*scan_in, *cls, **st)[0]
        if not bool(state.overflow):
            break
        st["nmax"] *= 2
    base, _ = cs.timed(lambda: b5("pack_classed"))
    n_open = int(state.n_open)
    del state
    libs = ["pack_classed"] + [f"pack_classed_c{c}" for c in widths]
    for lib in libs[1:]:  # each build's warm-up, equal to the solver's
        err = cs.max_abs_err(cs.timed(lambda: b5(lib))[0], base)
        if err:
            raise RuntimeError(f"{shape}: {lib} differs by {err}")
    ms = {lib: [] for lib in libs}
    for _ in range(REPS):
        for lib in libs:
            ms[lib].append(cs.timed(lambda: b5(lib))[1])
    row = dict(ms=ms, p50_ms={lib: statistics.median(t) for lib, t in ms.items()},
               nmax=st["nmax"], claims=n_open, classes=int((cls_host[1] > 0).sum()),
               lmax=st["lmax"], real_groups=int((a["g_count"] > 0).sum()), dims=dict(
                   G=int(a["g_count"].shape[0]), T=int(a["t_alloc"].shape[0]),
                   P=int(a["p_titype_ok"].shape[0]), V1=int(a["g_mask"].shape[2]),
                   MV=int(a["p_mvmin"].shape[1])),
               tiled=st["tile_feasibility"], has_domains=bool(st["has_domains"]),
               clusters=dict(getattr(packing, "classed_clusters", {})))
    for lib in clock_libs:
        out, split = phase_clocks(lambda: b5(lib), lib, len(CLASSED_PHASES))
        err = cs.max_abs_err(out, base)
        if err:
            raise RuntimeError(f"{shape}: the phase-clock build {lib} differs by {err}")
        row.setdefault("phase_ms", {})[lib] = dict(zip(CLASSED_PHASES, split))
        row.setdefault("phase_total_ms", {})[lib] = sum(split)
    del base
    torch.cuda.empty_cache()
    return row


def scan_device_ms(fn, reps=20):
    """torch.profiler's device milliseconds a call of ``fn`` over ``reps``
    back-to-back calls: the scan kernel's (pack_scan) and every device
    activity's (the wrapper's zeroing and word passes too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    scan = total = 0.0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA") or not ev.count:
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
        total += t
        if "pack_scan" in ev.key:
            scan += t
    return scan / 1e3 / reps, total / 1e3 / reps


def run_consolidation(shape):
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing, solve
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.workloads import build_consolidation_env

    build = (cs.minvalues_consolidation_env if shape == "cons_minvalues"
             else build_consolidation_env)
    passes, commands = [], set()
    for _ in range(CONS_PASSES):
        ctx, method, candidates, budgets = build(cs.CONS_NODES, "cuda")
        torch.cuda.synchronize()
        gc.collect()  # as chip_smoke.py's passes: no collection inside the timing
        t0 = time.perf_counter()
        cmd = method.compute_command(candidates, budgets)
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) * 1e3)
        commands.add(repr((cs.command_signature(cmd), method.last_probes,
                           method.last_dispatches)))
    if len(commands) != 1:
        raise RuntimeError(f"{shape}: the passes disagree: {commands}")
    token = cs.scenario_snapshot(build=build)
    statics = dict(token["statics"])
    a = dict(zip(SOLVE_ARG_NAMES, token["args"]))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    st = dict(nmax=token["nmax"], zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"])
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in cs.B1_NAMES),
                                             zone_kid=zk, ct_kid=ck)
    b2 = feas.existing_node_feasibility_sparse(*(a[n] for n in cs.B2_NAMES))
    b4_in = solve.pack_args(a, *b1, b2)
    while bool(packing.pack(*b4_in, **st)[3].any().item()):  # overflow doubling
        st["nmax"] *= 2
    out, _ = cs.timed(lambda: packing.pack(*b4_in, **st))
    ms = [cs.timed(lambda: packing.pack(*b4_in, **st))[1] for _ in range(50)]
    scan_ms, device_ms = scan_device_ms(lambda: packing.pack(*b4_in, **st))
    return dict(pass_first_ms=passes[0], pass_ms=passes[1:],
                pass_p50_ms=statistics.median(passes[1:]), command=commands.pop(),
                S=int(a["g_count"].shape[0]), nmax=st["nmax"], claims=out[2].tolist(),
                b4_p50_ms=statistics.median(ms), b4_scan_device_ms=scan_ms,
                b4_device_ms=device_ms,
                clusters={str(k): v for k, v in getattr(packing, "clusters", {}).items()})


def feas_inputs(shape):
    """The solve args (on the card, by name) and statics of one B1/B2
    shape, staged as chip_smoke.py stages them; NMAX and the fills dtype
    for the consolidation chunk (None elsewhere)."""
    from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import example_state_nodes
    from karpenter_tpu_torch.solver import workloads

    if shape == "feas_cons":
        token = cs.scenario_snapshot()
        return (dict(zip(SOLVE_ARG_NAMES, token["args"])), dict(token["statics"]),
                token["nmax"], token["fills_dtype"])
    if shape == "feas_partial":
        return partial_inputs()
    if shape == "feas_team_in":
        pods, _, pools, catalog = shape_inputs("wide_team_in")
        solver = cs.build_batch(TorchSolver, SolverConfig, pods, 0, pools=pools, its=catalog)
        args, statics, _, _ = cs.device_snapshot(solver, pods)
        return dict(zip(SOLVE_ARG_NAMES, args)), statics, None, None
    nodes = ()
    if shape == "feas_mixed":
        pods, n_types = workloads.mixed_pods(cs.N_PODS), cs.N_TYPES
    elif shape == "feas_diverse":
        pods, n_types = workloads.diverse_reference_mix(cs.N_DIVERSE), cs.N_TYPES
    elif shape == "feas_constrained":
        pods, n_types = workloads.constrained_mix(cs.N_PODS), cs.N_TYPES_C
    else:
        pods, n_types = workloads.mixed_pods(cs.NODE_PODS), cs.N_TYPES
        nodes = example_state_nodes(cs.N_NODES)
    solver = cs.build_batch(TorchSolver, SolverConfig, pods, n_types, state_nodes=nodes)
    args, statics, _, _ = cs.device_snapshot(solver, pods)
    return dict(zip(SOLVE_ARG_NAMES, args)), statics, None, None


def partial_inputs():
    """B1's partial mode at chip_smoke.py's phase 16 shape: constrained 50k
    x 800 over a data 2 x model 4 mesh on the card, shard (0, 0) (the base,
    its 200 types, its half of the live pairs): its solve args by name and
    the statics."""
    import torch

    from karpenter_tpu_torch.parallel import mesh as pm
    from karpenter_tpu_torch.solver import workloads
    from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver

    pods = workloads.constrained_mix(cs.N_PODS)
    host, _, statics, _ = cs.host_snapshot(
        cs.build_batch(TorchSolver, SolverConfig, pods, cs.N_TYPES_C), pods)
    card = torch.device("cuda", 0)
    mesh = pm.make_mesh(cs.MESH_SHARDS, data=2, devices=[card] * cs.MESH_SHARDS)
    margs = pm.place_args(pm.pad_args_for_mesh(host, mesh), mesh)
    a = {n: margs.at(n, 0, 0, 0) for n in cs.B1_NAMES}
    a["n_avail"] = a["g_mask"].new_zeros((0, 1))  # no nodes: no B2
    return a, statics, None, None


def feas_time(fn, plain):
    """One kernel's row: max |diff| against ``plain()``, wrapper ms (CUDA
    events) and device ms with the activities a call (torch.profiler)."""
    out, ref = fn(), plain()
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    dev_ms, per_call, how = cs.device_ms(fn, 100)
    return dict(err=cs.max_abs_err(out, ref), ms=cs.cuda_ms(fn, FEAS_REPS), device_ms=dev_ms,
                device_per_call=per_call, device_timing=how)


def host_split(wrapper, entry, args, outs):
    """Host microseconds a call of a B1/B2 wrapper (``wrapper()``), of its C
    entry alone with the same arguments (``entry(*args)``: the ctypes
    conversion and the launch) and of its output allocations
    (``outs()``): perf_counter over HOST_REPS calls each, one device sync
    after each run. The wrapper's checks and the rest are the difference."""
    import torch

    split = {}
    for name, fn in (("wrapper", wrapper), ("entry", lambda: entry(*args)), ("outputs", outs)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_REPS):
            fn()
        split[name + "_us"] = (time.perf_counter() - t0) / HOST_REPS * 1e6
        torch.cuda.synchronize()
    split["checks_and_rest_us"] = split["wrapper_us"] - split["entry_us"] - split["outputs_us"]
    return split


def b1_entry_args(a, b1_in, out, zk, ck):
    """kt_fresh_feasibility's arguments for the inputs ``b1_in`` (solve args
    ``a``) and the outputs ``out``, on the current stream; where the
    checkout's entry takes the direct mode's words (after the outputs),
    the scratch its wrapper allocates, held until the arguments go."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas

    P, G, T = out[1].shape
    dims = (P, G, T, a["g_mask"].shape[1], a["g_mask"].shape[2], a["t_alloc"].shape[1],
            a["o_avail"].shape[1], a["gk_g"].shape[0])
    words = ()
    if hasattr(feas, "_direct_words"):
        scratch = feas._direct_words(a["g_mask"].device, *dims)
        words = (scratch.data_ptr(), scratch.numel())
        b1_entry_args.held = scratch
    return (*dims, a["goff_idx"].shape[0], zk, ck,
            *(t.data_ptr() for t in b1_in), *(t.data_ptr() for t in out), *words,
            torch.cuda.current_stream().cuda_stream)


def b1_phases(a, b1_in, zk, ck, reps=20):
    """B1's per-phase milliseconds a call (FEAS_PHASES, thread 0 of block
    (0, 0, 0)) from its phase-clock build, over ``reps`` launches; the
    build's tables must equal the solver library's."""
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas

    want = feas.fresh_claim_feasibility_sparse(*b1_in, zone_kid=zk, ct_kid=ck)
    out = [torch.empty_like(t) for t in want]
    entry = _build.bind("fresh_feasibility_clocks", "kt_fresh_feasibility",
                        feas._fresh_entry().argtypes)
    args = b1_entry_args(a, b1_in, out, zk, ck)

    def run():
        for _ in range(reps):
            if entry(*args):
                raise RuntimeError("the phase-clock build of B1 failed to launch")

    _, ms = phase_clocks(run, "fresh_feasibility_clocks", len(FEAS_PHASES))
    if cs.max_abs_err(out, want):
        raise RuntimeError("B1's phase-clock build disagrees with the solver library")
    return dict(zip(FEAS_PHASES, (m / reps for m in ms)))


def run_feasibility(shape, clocks=False):
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import solve

    a, statics, nmax, fills = feas_inputs(shape)
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    b1_in = [a[n] for n in cs.B1_NAMES]
    b2_in = [a[n] for n in cs.B2_NAMES] if shape != "feas_partial" else []
    row = dict(P=a["p_def"].shape[0], G=a["g_mask"].shape[0], T=a["t_alloc"].shape[0],
               N=a["n_avail"].shape[0], L=a["gk_g"].shape[0],
               live=int((a["gk_w"] != 0).sum()), LZ=a["goff_idx"].shape[0],
               K=a["g_mask"].shape[1], V1=a["g_mask"].shape[2])
    if shape == "feas_team_in":  # B1's layout there (the checkout's fresh_layout)
        dims = (row["P"], row["G"], row["T"], row["K"], row["V1"], a["t_alloc"].shape[1],
                a["o_avail"].shape[1])
        try:
            row["layout"] = feas.fresh_layout(*dims, L=row["L"])
        except TypeError:  # a checkout whose fresh_layout takes no index length
            row["layout"] = feas.fresh_layout(*dims)
    if shape == "feas_partial":
        row["b1_partial"] = feas_time(
            lambda: feas.fresh_claim_feasibility_partial(*b1_in, zone_kid=zk, ct_kid=ck,
                                                         with_base=True),
            lambda: feas.fresh_claim_feasibility_partial_reference(*b1_in, zone_kid=zk,
                                                                   ct_kid=ck, with_base=True))
    elif shape != "feas_nodes":
        row["b1"] = feas_time(
            lambda: feas.fresh_claim_feasibility_sparse(*b1_in, zone_kid=zk, ct_kid=ck),
            lambda: feas.fresh_claim_feasibility_sparse_reference(*b1_in, zone_kid=zk,
                                                                  ct_kid=ck))
    if row["N"]:
        row["S"] = a["n_tol"].shape[0] if a["n_tol"].dim() == 3 else 1
        row["b2"] = feas_time(lambda: feas.existing_node_feasibility_sparse(*b2_in),
                              lambda: feas.existing_node_feasibility_sparse_reference(*b2_in))
    if shape == "feas_cons":  # B7: the whole scenario dispatch

        def dispatch():
            return solve.solve_scenarios_core_packed(
                *a.values(), fills_dtype=fills, batch_topo=False,
                **dict(statics, nmax=nmax))

        while bool(dispatch()[3].any().item()):  # the search's overflow doubling
            nmax *= 2
        dev_ms, per_call, how = cs.device_ms(dispatch, 20)
        row["b7"] = dict(ms=cs.cuda_ms(dispatch, 50), device_ms=dev_ms,
                         device_per_call=per_call, device_timing=how, nmax=nmax)
    # the launch path's host split, where the checkout binds its entries
    # once (feasibility._fresh_entry / _existing_entry)
    if shape == "feas_mixed" and hasattr(feas, "_fresh_entry"):
        import torch

        P, G, T = row["P"], row["G"], row["T"]
        out = feas.fresh_claim_feasibility_sparse(*b1_in, zone_kid=zk, ct_kid=ck)
        row["b1"]["host"] = host_split(
            lambda: feas.fresh_claim_feasibility_sparse(*b1_in, zone_kid=zk, ct_kid=ck),
            feas._fresh_entry(), b1_entry_args(a, b1_in, out, zk, ck),
            lambda: (torch.empty((P, G), dtype=torch.bool, device="cuda"),
                     torch.empty((P, G, T), dtype=torch.bool, device="cuda"),
                     torch.empty((P, G, T), dtype=torch.int32, device="cuda")))
    if shape == "feas_nodes" and hasattr(feas, "_existing_entry"):
        import torch

        N, G = row["N"], row["G"]
        out = feas.existing_node_feasibility_sparse(*b2_in)
        dims = (1, N, G, a["g_mask"].shape[1], a["g_mask"].shape[2], a["n_avail"].shape[1],
                row["L"])
        stream = torch.cuda.current_stream().cuda_stream
        row["b2"]["host"] = host_split(
            lambda: feas.existing_node_feasibility_sparse(*b2_in), feas._existing_entry(),
            (*dims, *(t.data_ptr() for t in b2_in), out.data_ptr(), stream),
            lambda: torch.empty((N, G), dtype=torch.int32, device="cuda"))
    if clocks and "b1" in row:
        row["b1"]["phases_ms"] = b1_phases(a, b1_in, zk, ck)
    if max(row[k]["err"] for k in ("b1", "b2", "b1_partial") if k in row):
        raise RuntimeError(f"{shape}: a kernel disagrees with its plain version: {row}")
    return row


def dense_inputs(shape):
    """B3's inputs at one of its paths' shapes, on the card: the relax
    path's run heads of identical 50k x 400 (1 x 400, as
    chip_smoke.py:relax_row stages them), the dense route's mixed 50k x
    400 (G=64) and the state-node snapshot (32 nodes, G=64). Returns the
    entry ("fresh" or "existing"), its inputs and (zone_kid, ct_kid)."""
    if shape == "dense_relax":
        from karpenter_tpu_torch.ops import relax as relax_mod
        from karpenter_tpu_torch.solver.args import put
        from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver
        from karpenter_tpu_torch.solver.workloads import identical_pods

        pods = identical_pods(cs.N_IDENT)
        run, plan = cs.relax_plan(cs.build_batch(TorchSolver, SolverConfig, pods, cs.N_TYPES),
                                  pods)
        head = [put(n, x, "cuda") for n, x in
                zip(relax_mod.HEAD_ARG_NAMES, relax_mod.head_args(plan, run))]
        return "fresh", head, (run.zone_kid, run.ct_kid)
    a, statics, _, _ = feas_inputs("feas_mixed" if shape == "dense_route" else "feas_nodes")
    zc = (statics["zone_kid"], statics["ct_kid"])
    if shape == "dense_route":
        return "fresh", [a[n] for n in cs.B3_NAMES], zc
    return "existing", [a[n] for n in cs.B3E_NAMES], zc


def run_dense(shape):
    """B3 at one shape: the wrapper (CUDA events) and the device alone
    (torch.profiler), against its plain version."""
    from karpenter_tpu_torch.ops import feasibility as feas

    entry, ins, (zk, ck) = dense_inputs(shape)
    if entry == "fresh":
        row = feas_time(lambda: feas.fresh_claim_feasibility(*ins, zone_kid=zk, ct_kid=ck),
                        lambda: feas.fresh_claim_feasibility_reference(*ins, zone_kid=zk,
                                                                       ct_kid=ck))
        row["shape"] = "P, G, T = " + ", ".join(map(str, ins[8].shape + ins[9].shape[1:]))
    else:
        row = feas_time(lambda: feas.existing_node_feasibility(*ins),
                        lambda: feas.existing_node_feasibility_reference(*ins))
        row["shape"] = "N, G = " + ", ".join(map(str, ins[8].shape))
    if row["err"]:
        raise RuntimeError(f"{shape}: B3 disagrees with its plain version: {row}")
    return row


def run_wire(shape):
    """B6 at one shape: the mixed 50k x 400 solve's scan outputs (NMAX
    1024) and the consolidation chunk's (S = 16), as chip_smoke.py's phase
    2 makes them; the wrapper (CUDA events) and the device alone
    (torch.profiler), against its plain version."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing
    from karpenter_tpu_torch.ops import solve

    if shape == "wire_mixed":
        a, statics, _, _ = feas_inputs("feas_mixed")
        from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver
        from karpenter_tpu_torch.solver import workloads

        pods = workloads.mixed_pods(cs.N_PODS)
        solver = cs.build_batch(TorchSolver, SolverConfig, pods, cs.N_TYPES)
        _, _, nmax, fills = cs.device_snapshot(solver, pods)
        cap_ng = None
    else:
        a, statics, nmax, fills = feas_inputs("feas_cons")
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in cs.B1_NAMES), zone_kid=zk,
                                             ct_kid=ck)
    if shape == "wire_mixed":
        import torch

        cap_ng = torch.zeros((0, a["g_count"].shape[0]), dtype=torch.int32, device="cuda")
    else:
        cap_ng = feas.existing_node_feasibility_sparse(*(a[n] for n in cs.B2_NAMES))
    st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"])
    pack_in = solve.pack_args(a, *b1, cap_ng)
    while True:
        outs = packing.pack(*pack_in, **st)
        if not bool(outs[3].any().item()):
            break
        st["nmax"] *= 2
    row = feas_time(lambda: solve.wire_pack(outs, fills),
                    lambda: solve.wire_pack_reference(outs, fills))
    row["shape"] = f"{tuple(outs[1].shape)} mask, fills {fills}"
    if row["err"]:
        raise RuntimeError(f"{shape}: B6 disagrees with its plain version: {row}")
    return row


def run_relax():
    """B9 and solve_bulk at the identical 50k x 400 batch's relax plan
    (the module docstring's ``relax``)."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import relax as relax_mod
    from karpenter_tpu_torch.solver.args import put
    from karpenter_tpu_torch.solver.driver import SolverConfig, TorchSolver
    from karpenter_tpu_torch.solver.workloads import identical_pods

    pods = identical_pods(cs.N_IDENT)
    run, plan = cs.relax_plan(cs.build_batch(TorchSolver, SolverConfig, pods, cs.N_TYPES), pods)
    head = [put(n, x, "cuda") for n, x in
            zip(relax_mod.HEAD_ARG_NAMES, relax_mod.head_args(plan, run))]
    _, type_ok, n_fit = feas.fresh_claim_feasibility(
        *head, zone_kid=run.zone_kid, ct_kid=run.ct_kid)
    host_tables = (type_ok.cpu().numpy(), n_fit.cpu().numpy())
    if hasattr(relax_mod, "fill_inputs"):  # one launch over B3's tables
        n_r, ge, cl = relax_mod.fill_args(plan, *host_tables)
        b9_in = (*relax_mod.fill_inputs(ge, cl, "cuda"), type_ok, n_fit, n_r)
        entry = "rows gathered on the card"
    else:  # the earlier two-kernel entry: rows gathered on the host
        n_r, host_in = relax_mod.fill_args(plan, *host_tables)
        b9_in = [put(n, x, "cuda") for n, x in zip(relax_mod.FILL_ARG_NAMES, host_in)]
        entry = "rows gathered on the host"
    row = feas_time(lambda: relax_mod.relax_fill(*b9_in),
                    lambda: relax_mod.relax_fill_reference(*b9_in))
    if row["err"]:
        raise RuntimeError(f"relax: B9 disagrees with its plain version: {row}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        relax_mod.relax_fill(*b9_in)
    row["wrapper_host_us"] = (time.perf_counter() - t0) / HOST_REPS * 1e6
    torch.cuda.synchronize()
    bulk_ms = []
    for _ in range(RELAX_REPS):
        t0 = time.perf_counter()
        bulk = relax_mod.solve_bulk(plan, run, torch.device("cuda"))
        bulk_ms.append((time.perf_counter() - t0) * 1e3)
    if bulk[0] != n_r:
        raise RuntimeError(f"relax: solve_bulk opened {bulk[0]} claims, want {n_r}")
    row.update(entry=entry, claims=n_r, solve_bulk_p50_ms=statistics.median(bulk_ms),
               shape=f"GE={plan.easy_gids.size} runs={len(plan.run_head)} NR="
                     f"{b9_in[1].shape[-1] if entry.endswith('card') else b9_in[6].shape[0]}"
                     f" T={type_ok.shape[2]}")
    return row


def run_fold(shape):
    """The fold at one of FOLD_SHAPES (the module docstring's ``fold``)."""
    import inspect

    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas

    D, M, P, G, T = FOLD_SHAPES[shape]
    Tm = T // M
    rng = np.random.default_rng(18)

    def counts(shape):
        return torch.from_numpy((rng.random(shape) < 0.05).astype(np.int32)).to("cuda")

    fail_t, fail_c = counts((D, M, P, G, Tm)), counts((D, P, G))
    tonly = torch.from_numpy(rng.random((M, P, G, Tm)) < 0.8).to("cuda")
    n_fit = torch.from_numpy(rng.integers(0, 50, (M, P, G, Tm)).astype(np.int32)).to("cuda")
    p_tol = torch.ones((P, G), dtype=torch.bool, device="cuda")
    partials = list(fail_t.view(D * M, P, G, Tm).unbind(0))
    if inspect.signature(feas.mesh_fold).parameters["nfail"].default == ():
        ins = (partials, list(fail_c.unbind(0)), list(tonly.unbind(0)), list(n_fit.unbind(0)),
               p_tol)
        contract = "lists of partials"
    else:
        ins = (fail_t, fail_c, tonly, n_fit, p_tol)
        contract = "stacked partials"
    row = feas_time(lambda: feas.mesh_fold(*ins)[:3],
                    lambda: feas.mesh_fold_reference(*ins)[:3])
    if row["err"]:
        raise RuntimeError(f"{shape}: the fold disagrees with its plain version: {row}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_REPS):
        feas.mesh_fold(*ins)
    row["wrapper_host_us"] = (time.perf_counter() - t0) / HOST_REPS * 1e6
    torch.cuda.synchronize()
    row.update(
        contract=contract,
        library_sum_ms=cs.cuda_ms(lambda: fail_t.sum(0, dtype=torch.int32), FEAS_REPS),
        library_stack_ms=cs.cuda_ms(lambda: torch.stack(partials).sum(0, dtype=torch.int32),
                                    FEAS_REPS),
        bytes=cs.nbytes([fail_t, fail_c, tonly, n_fit, p_tol]) + P * G * (1 + 5 * T),
        shape=f"D={D} M={M} P={P} G={G} T={T}")
    row["bound_ms"] = row["bytes"] / cs.HBM_BYTES_PER_S * 1e3
    return row


def run_wide():
    """Each of chip_smoke.py's wide value vocabularies (wide_inputs) through
    one cold TorchSolver(device="cuda").solve: its claims, pod errors and
    seconds, or the exception it raised and the last frames it passed."""
    import traceback

    import torch

    from karpenter_tpu_torch.solver.driver import EncodeCache, SolverConfig, TorchSolver

    out = {}
    for label, pools, catalog, pods in cs.wide_inputs():
        s = cs.build_batch(TorchSolver, SolverConfig, pods, 0, cache=EncodeCache(),
                           pools=pools(), its=catalog())
        t0 = time.perf_counter()
        try:
            res = s.solve(pods)
            torch.cuda.synchronize()
            out[label] = dict(claims=len(res.new_node_claims), errors=len(res.pod_errors),
                              s=time.perf_counter() - t0)
        except Exception as exc:  # the record of what raises is the result here
            frames = traceback.extract_tb(exc.__traceback__)[-4:]
            out[label] = dict(error=f"{type(exc).__name__}: {exc}", s=time.perf_counter() - t0,
                              where=[f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}" for f in frames])
    return out


def run_listed_solve():
    """chip_smoke.py phase 10's timing of the listed pool (``wide_timings``):
    600 of 800 types listed at mixed_pods(50,000), the p50 of 5 cold
    ``TorchSolver(device="cuda").solve`` calls on a warm catalog cache and
    one traced solve's span split (ms)."""
    from karpenter_tpu_torch.solver.driver import EncodeCache, SolverConfig, TorchSolver

    _, pools, catalog, pods = [w for w in cs.wide_inputs(full=False)
                               if w[0] == "listed_types"][0]

    def solver_for(device, cache=None):
        return cs.build_batch(TorchSolver, SolverConfig, pods, 0, device=device,
                              cache=cache or EncodeCache(), pools=pools(), its=catalog())

    return cs.wide_timings(solver_for, pods, EncodeCache)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-clocks", action="store_true", help="times only")
    ap.add_argument("--shapes", nargs="+", choices=SHAPES, default=list(SHAPES),
                    help="B4's solve shapes (tenant, mixed, constrained, diverse_contrib) and "
                    "wide vocabularies (wide_team_in: V1 2048, K 16; wide_listed: 600 listed "
                    "types at mixed 50k, V1 1024; wide_mv_types: minValues over 1,100 types, "
                    "MW 2048; wide_mv_types_800: over 800, MW 1024), B5's, B7's, B1/B2's "
                    "(feas_team_in: B1 at V1 2048), B3's, B6's, the fold's, B9's, the "
                    "wide solves, and listed_solve: the listed pool's solve p50 and span "
                    "split, as chip_smoke.py's phase 10 (default: all)")
    ap.add_argument("--clusters", nargs="+", type=int, default=[], choices=(1, 2, 4),
                    help="B5 also from its build with clusters of at most C blocks (the "
                    "solver's library takes 8)")
    ap.add_argument("--classed-clocks", nargs="+", default=["pack_classed_clocks"],
                    choices=("pack_classed_clocks", "pack_classed_clocks_c1"),
                    help="B5's phase-clock builds")
    opts = ap.parse_args()
    cs.pin_one_card()
    import torch

    if not torch.cuda.is_available():
        print("tenant_scan: CUDA is not available", file=sys.stderr)
        return 2
    from karpenter_tpu_torch import _build

    clocks = not opts.no_clocks
    classed = any(s in CLASSED_SHAPES for s in opts.shapes)
    clock_libs = opts.classed_clocks if clocks else []
    widths = [f"pack_classed_c{c}" for c in opts.clusters]
    feas_only = all(s in FEAS_SHAPES + DENSE_SHAPES + WIRE_SHAPES + tuple(FOLD_SHAPES)
                    + ("relax",) for s in opts.shapes)
    names = ("fresh_feasibility", "existing_feasibility", "dense_feasibility", "wire_pack", "pack",
             "relax_fill", *(("mesh_fold",) if any(s in FOLD_SHAPES for s in opts.shapes) else ()),
             *(("fresh_feasibility_clocks",)
               if clocks and any(s in FEAS_SHAPES for s in opts.shapes) else ()),
             *(("pack_clocks",) if clocks and not feas_only else ()),
             *(("pack_classed", *clock_libs, *widths) if classed else ()))
    if all(s in FOLD_SHAPES for s in opts.shapes):
        names = ("mesh_fold",)
    logs = _build.build(names=names, force=True, verbose=True)
    rows = {"ptxas": {name: cs.ptxas_summary(text) for name, text in logs.items()}}
    for shape in opts.shapes:
        try:
            if shape in FEAS_SHAPES:
                rows[shape] = run_feasibility(shape, clocks)
            elif shape in DENSE_SHAPES:
                rows[shape] = run_dense(shape)
            elif shape in WIRE_SHAPES:
                rows[shape] = run_wire(shape)
            elif shape == "wide":
                rows[shape] = run_wide()
            elif shape == "relax":
                rows[shape] = run_relax()
            elif shape == "listed_solve":
                rows[shape] = run_listed_solve()
            elif shape in FOLD_SHAPES:
                rows[shape] = run_fold(shape)
            elif shape in CONS_SHAPES:
                rows[shape] = run_consolidation(shape)
            elif shape in CLASSED_SHAPES:
                rows[shape] = run_classed(shape, clock_libs, opts.clusters)
            else:
                rows[shape] = run_shape(shape, clocks)
        except RuntimeError as exc:
            print(f"tenant_scan: {exc}", file=sys.stderr)
            return 1
    print(cs.nvidia_smi_line())
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
