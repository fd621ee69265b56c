#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (karpenter_tpu_torch) on one card.

    python3 chip_smoke.py        # from the repo root, on a machine with CUDA

Phases, one line of output each; any failure exits non-zero and prints
no result:

1. device and build: the card's name and power limit, then every kernel
   of csrc/ compiled from the checkout with nvcc (one process per source,
   all at once);
2. kernels vs plain versions: each kernel of the main path (B1 fresh
   feasibility, B2 existing-node caps, B4 packing scan, B6 wire pack) runs
   on the card at the main path's shapes — the mixed 50,000-pod x
   400-type snapshot, and for B2 a 2,000-pod snapshot over 32 existing
   nodes — beside its ``*_reference`` on the same CUDA tensors. Tolerance:
   exact equality of every output. Median times over repeats (CUDA
   events);
   Phase 2 also holds B7, the consolidation dispatch (B1 shared, B2 over
   n_tol [S, N, G], B4 one cluster per scenario, B6 over S rows; B4 also
   on the device alone, torch.profiler), at the
   consolidation path's shapes: 16 single-node scenarios over the
   2,000-node cluster's shared encoding (N=2048, T=50); and B4 over a
   domain batch (the scan's domain machinery: BASELINE config[2], 50,000
   constrained pods x 800 types) and B8, the row-delta apply, at the
   largest row delta of a real churn tick of that batch (also against
   ``Tensor.index_copy``, through the wrapper and on the device alone:
   torch.profiler's device time over 100 calls, which must show B8's one
   kernel a call and no copy beside it);
3. end to end: TorchSolver(device="cuda").solve on the 50k x 400 batch,
   then on the 2,000-pod batch over 32 nodes, each path with the launch
   counters zeroed just before it and read just after it (B1, B4, B6 must
   have run on the first, B1, B2, B4, B6 on the second);
   every pod placed, 0 errors, and the same decisions (by pod name) as the
   same solves with device="cpu"; solve p50 over 5 warm solves and the
   per-phase split of one traced solve; and the ops dense route
   (dispatch_packed with sparse_groups=False on the 32-node batch: B3's
   fresh and existing entries in place of B1 and B2, counted) equal to
   the sparse route's dispatch;
4. consolidation: MultiNodeConsolidation, then SingleNodeConsolidation,
   compute_command over build_*_consolidation_env(2000) on the card, the
   launch counters zeroed before each path and read after it: every
   dispatch a scenario batch (the S > 1 ``pack`` launches equal the
   method's dispatches, no single-scenario ``pack`` launch), no sequential
   fallback, and the same command, probes and dispatches as the
   device="cpu" run; p50 over 3 warm passes on fresh envs and the phase
   split of one traced pass;
5. the constrained loop (BASELINE config[2], 50k x 800): a cold solve on
   the card, counted (a domain ``pack`` launch), with the decisions and
   placed/error counts of device="cpu"; cold p50 over 5 solves, each from
   a fresh EncodeCache, and the split of one traced cold solve; then two
   warm-ups and 4 churn ticks (bench.py's constrained-churn protocol,
   workloads.churn_tick) on one EncodeCache, each tick counted on its own
   (a fifth, traced tick gives the span split):
   it rides row deltas through B8 with no full re-encode and decides as a
   card solve of the same pods fully re-encoded and restaged over the same
   vocab (the warm encoding's contract, the JAX package's too); a repeat
   solve hits REUSE with zero full puts; no sequential fallback anywhere.
   Tick p50, and the traced tick's span split beside the traced cold
   solve's.
6. the reference's diverse 5-class mix (bench.py:_build("diverse-ref"):
   diverse_reference_mix(5,000) x 400 types), whose ~1,900 groups share
   ~30 feasibility classes, so the driver routes it to the class-batched
   scan: the same loop as phase 5 (cold solve == cpu, 1,000 claims and 0
   errors, cold p50 over 5 fresh EncodeCaches and a traced split; bench's
   diverse-churn protocol, 50 pods swapped per tick, each tick == a full
   re-encode over the same vocab, row deltas through B8, REUSE on the
   repeat, 0 fallbacks), every solve counted: one B5 (pack_classed) launch
   per dispatch and no B4 (pack) launch; then the same batch once with
   SolverConfig(classed=False), counted: B4 with contributor counting,
   deciding as the classed solve.

7. the relax loop (TorchSolver's default route through the relaxation
   bulk pre-solver, kernels B3 and B9), every solve counted: (a) BASELINE
   config[0] (identical_pods(500) x 10 types): 500 pods routed to the
   bulk, 34 claims, the CPU run's claims in slot order; (b) identical
   50k x 400 (identical_pods(50,000): a 50,000-replica Deployment
   scaling up): 50,000 routed, 532 claims == the CPU run in slot order,
   B3 fresh and B9 launched once per solve and B1/B4/B6 once on the
   zeroed counts; cold p50 over 5 fresh EncodeCaches, one traced solve's
   span split (``relax`` included), 4 churn ticks (workloads.churn_tick
   over identical_pods), each relax-routed, incremental (REUSE or row
   deltas) and equal to a same-vocab re-encode, 0 full re-encodes, REUSE
   on the repeat; (c) the zonal partial mix (48,000 zonal Deployment pods
   of three sizes over zones a/b/c beside 400 zone-b pods of a
   one-per-node service, 48,400 x 400): 32,000 routed, 339 bulk + 400
   exact claims == the CPU run in slot order, and the relax-off solve's
   slot order beside it; (d) the same batch with a RELAX_OUTPUT fault
   that zeroes the bulk's fills: relax_rejects == 1, and the decisions of
   the relax-off solve. Phases 3, 5 and 6 report ``relax_pods`` (0: the
   planner routes nothing there, as in the JAX package).

8. the floors-and-ledger loop: NodePools with minValues floors and offerings with
   capacity reservations, every solve counted, each cell's cold solve
   equal to the device="cpu" solve in slot order (and in the reservations
   each claim holds), no relax routing, no sequential fallback, cold p50
   over 5 solves from fresh EncodeCaches: (a) minvalues-50k,
   mixed_pods(50,000, gpu_fraction=0) x 400 over one NodePool whose only
   requirement is instance-family Exists with minValues 2 (B4 with floors);
   (b) reserved-50k, the same pods over the default pool and a catalog
   with one reserved offering (test-zone-a, capacity 20) on every 25th
   type, reserved capacity on in the default mode (B4 with the ledger;
   1..320 claims hold reservations); (c) constrained-minvalues, BASELINE
   config[2]'s constrained_mix(50,000) x 800 over the minValues pool (B4
   with domains and floors); (d) diverse-minvalues,
   diverse_reference_mix(5,000) x 400 over the minValues pool with
   classed=True (B5 with floors), then once on the auto route (B4 with
   contributors and floors); (e) MultiNodeConsolidation at 2,000 nodes
   with the env's NodePool carrying the same floor (B7 with floors), its
   command equal to the device="cpu" run's, p50 over 3 warm passes on
   fresh envs as phase 4. The diverse cells' comparisons
   with device="cpu" run at 1,000 pods (a card solve and a CPU solve of
   diverse_reference_mix(1,000)); their counted and timed card solves at
   5,000.

9. the tenant cell (the tiled mode, ROADMAP item A4b): 64 NodePools
   tenant-00..63, each tainted tenant=tNN:NoSchedule and capped at 4,000
   CPUs, over corpus.generate(800), and 6,000 Deployments
   (example.tenant_pods: VPA-sized requests, 1-16 replicas, round-robin
   over the tenants; 50,816 pods, 6,000 groups, G 8192): the tables would
   take P * G * T * 5 = 2,097,152,000 B, past the 1,610,612,736 B gate,
   so the driver picks the tiled mode by itself. (a) a cold solve,
   counted: B4 tiled and no B1/B2/B3 launch, relax_pods 0, no fallback;
   cold p50 over 3 fresh EncodeCaches when a solve passes 10 s (else 5)
   and one traced solve's span split; (b) the same device args through
   dispatch_packed tiled and untiled (B1 and the untiled B4): the ten
   outputs identical, the scans timed alone (the row build by
   difference), and the solve's Results equal to a solve forced untiled,
   claims in slot order; B8 at the largest row delta of the first tick
   (as phase 2 measures it); (c) two churn ticks that swap 60
   Deployments, each on row deltas through B8 and equal to a same-vocab
   re-encode, then a REUSE repeat; (d) the classed route forced (B5 tiled) deciding
   as B4; (e) TorchSolver.solve_scenarios over the cell and the cell less
   the first tick's removed Deployments (B7's grid tiled), each scenario
   equal to a solve of its pods, claims in slot order.

10. the wide value vocabularies (ROADMAP item C1: the kernels must take any
   width of the padded value axis V1 and of the minValues catalog MW, as
   the reference does): (a) one NodePool whose one requirement is
   example.com/team Exists over corpus.generate(400) and 1,100 pods of
   500m / 1 GiB, pod i selecting team-i (K 16, V1 2048, every pod routed
   to the relax bulk, the exact dispatch still launched); (b) the same
   pool listing team-0..team-1099 with 40 such pods; (c) minValues 2 on
   the instance type over corpus.generate(1100) at mixed_pods(2000) (MW
   2048); (d) a pool listing 600 of corpus.generate(800)'s types at mixed
   50k (V1 1024). Each cold card solve, counted, returns Results with no
   fallback and decides as the device="cpu" solve of the same input in
   slot order ((d) at 2,000 pods); (d)'s cold p50 over 5 fresh
   EncodeCaches beside mixed 50k x 400's (phase 3). Logs each input's K,
   V1, MW and the layout each kernel took (B1's mode, tiles and shared
   memory; B3's where relax ran; each scan's shared memory and spilled
   bytes).

11. the degradation ladder (SolverConfig.health on an injected clock;
   phase_ladder's docstring).

12. the solver sidecar (solver/service.py): the port's serve() on the card
   behind the port's RemoteSolver over gRPC, (a) the solo lane at mixed
   3,000 x 400 (a request under gRPC's default 4 MiB receive limit, its
   response bytes equal to the in-process card and CPU solves'), (b) the
   cross-tenant batch lane, four tenants of 750 pods sent at once, one
   union solve (one scenario dispatch, B7), each tenant's decisions equal
   to its solo card solve and the CPU union's, (c) the error contract:
   backpressure, a deadline overrun falling back in process on the card,
   and a launch error of the batch lane, not injected, reaching all four
   callers as INTERNAL (phase_sidecar's docstring).

13. the operator (operator.py): the port's Operator over the kwok provider
   with 2,000 mixed pods pending over one NodePool and 400 types, stepped
   until no pod is pending (at most 5 steps), on the card, on the CPU and
   through phase 12's sidecar: the same NodeClaims by content.

14. the digital twin (sim/twin.py): the JAX package's tier-1 wall, 2,000
   fabricated nodes and 20,000 pods replayed for 10 simulated minutes of
   churn (a spot-reclaim wave, an ICE wave, the store/provider fault plan)
   through the whole operator roster on the card, every minute's SLO wall
   asserted; the first 6 minutes equal to the device="cpu" replay in a
   child process (canonical audit, fault log, minute reports); a
   checkpoint at minute 6 resumed on the card equal to the uninterrupted
   replay; no device memory held across a closed twin; the launches by
   kernel, and bench.py run_twin's numbers (phase_twin's docstring).

15. the sync audit: one warm mixed 50,000 x 400 TorchSolver.solve and one
   warm consolidation scenario batch (16 single-node scenarios over the
   2,000-node cluster, B7) under torch.cuda.set_sync_debug_mode("warn");
   every sync the card reports, attributed to its innermost frame in
   karpenter_tpu_torch/, must lie at a site the host-sync rule
   (karpenter_tpu_torch/analysis/device.py) sanctions: a DTX906
   sanction, or one of its IMPLICIT_SYNCS. The syncs per solve and per
   batch, by site, and the phase's wall time (phase_sync_audit's
   docstring);
16. the solver mesh (A13, B10) on the one card: mesh="auto" resolving to
   no mesh; B1's and B2's partial modes and the fold (csrc/mesh_fold.cu)
   against their plain versions on every shard; TorchSolver over
   make_mesh(devices=[cuda:0] * 8) at mixed 50k, constrained 50k x 800
   (data 8, and data 2 x model 4), mixed 2,000 over 32 nodes and the
   dense route, a consolidation batch over the scenario mesh and
   constrained churn ticks, each equal to one device's; the launches of
   each solve; a warm mesh solve under the sync audit (phase_mesh's
   docstring).

Phase 2 holds B1 and B2 also at the other shapes of their paths:
B1 at diverse-ref (G=2048) and constrained 50k x 800 (G=256, the only
cell with live pairs), B2 at the consolidation chunk (S=16, N=2048);
each B1/B2 row is also exact over its index reordered (shuffled, weight-0
pads interleaved, goff_idx with a repeat), and torch.profiler must see
one kernel per call (no memset).
Phase 2 also holds B5 against pack_classed_reference (every output and
the final state) and B4 with contributor counting (the same batch with
the classed route off) against pack_reference, on the diverse batch; B3's
fresh entry on the mixed 50k snapshot against its plain version and B1's
tables, its existing entry on B2's 32-node snapshot against its plain
version and B2's table, B9 on the bulk inputs of the identical 50k
batch against its plain version, and the floors-and-ledger variants at phase 8's
cells: B4 with floors (minvalues-50k), B4 with the ledger (reserved-50k),
B5 with floors (diverse-minvalues) and B7 with floors (the consolidation
chunk over the minValues pool); B3's fresh entry also at the relax
path's shape (the identical batch's run heads, 1 x 400); B1 and B4 at
phase 10's team-In input (K 16, V1 2048: B1's direct mode, a word pass
across the card then the tables; B4's row ``pack_wide``), B4 at its
listed-types input (600 of 800 types at mixed 50k, V1 1024;
``pack_listed``) and at its minValues input (minValues 2 on the instance
type over 1,100 types, MW 2048; ``pack_mv_wide``), each B4 row
with the shared memory and spill scratch the scan took; and the
tiled mode forced at the ops
level (tiled_rows): B4 tiled on B2's snapshot, constrained 50k x 800,
reserved-50k and the tenant shape at 600 Deployments, B5 tiled on
diverse-ref and diverse-minvalues, B7's grid tiled on the consolidation
chunk, each equal to the untiled kernel and to its plain tiled version
on the card.

Then one JSON line of per-kernel numbers (B1, B1 at diverse-ref, at
constrained and at V1 2048, B2, B2 at the consolidation chunk, B3 fresh
(also at the relax shape) and existing, B4 at V1 2048, at the listed
types and at MW 2048, B4, B4 over domains, B4 with contributor counting,
B4 with minValues floors, B4 with the reservation ledger, B5, B5 with
floors, B6, B7, B7
with floors, B8, B9, and B4, B5 and B7 in the tiled mode, and phase 16's
B1 and B2 partial modes and the mesh fold; every row
carries its device-only time, torch.profiler over repeated calls of the
wrapper, beside the wrapper's CUDA-event time; B8's row also the
library call's and the tenant tick's delta, B7's its scan on the device
alone), a log line with the cluster each scenario count's B4 launches
and B5's launches took (csrc/pack_common.cuh:pick_cluster; phases 2 and
9(d) log B5's too), the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.
"""

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
N_PODS, N_TYPES = 50_000, 400
N_TYPES_C = 800  # BASELINE config[2]: 50k constrained pods x 800 types
N_TICKS = 4
NODE_PODS, N_NODES = 2_000, 32
# bench.py:_build("diverse-ref"): diverse_reference_mix(5,000) x 400 types,
# which the JAX package solves into 1,000 claims with no pod error
N_DIVERSE, DIVERSE_CLAIMS = 5_000, 1_000
CONS_NODES, CONS_SCENARIOS = 2_000, 16  # BASELINE config[3]; one sweep chunk
# the relax loop's batches, with the JAX package's routing and claim
# counts on the CPU: BASELINE config[0]; identical_pods(50,000) x 400
# (one run, one head); the zonal partial mix (two of its three easy runs)
CONFIG0_PODS, CONFIG0_TYPES, CONFIG0_CLAIMS = 500, 10, 34
N_IDENT, IDENT_CLAIMS = 50_000, 532
N_ZONAL, N_SOLO, ZONAL_ROUTED, ZONAL_BULK_CLAIMS = 48_000, 400, 32_000, 339
# phase 8, the floors-and-ledger loop: reserved-50k's catalog carries one reserved
# offering (test-zone-a, capacity 20) on every 25th of its 400 types:
# 16 reservations, at most 320 claims holding one
RESV_EVERY, RESV_CAP = 25, 20
RESV_MAX_CLAIMS = N_TYPES // RESV_EVERY * RESV_CAP
# phase 8 holds its diverse-minvalues solves against device="cpu" at this
# depth (the card's counted and timed solves stay at N_DIVERSE)
N_DIVERSE_CPU = 1_000
# phase 9, the tenant cell: 64 tainted NodePools capped at 4,000 CPUs
# each (one per tenant team) over 800 types, 6,000 VPA-sized Deployments
# (50,816 pods, 6,000 groups: G 8192) whose tables would take
# P * G * T * 5 = 2,097,152,000 B, past the driver's 1,610,612,736 B gate;
# each churn tick swaps 60 Deployments
N_TENANTS, N_DEPLOY, TENANT_PODS, TENANT_TYPES = 64, 6_000, 50_816, 800
TENANT_BYTES, TILE_GATE = 2_097_152_000, 3 << 29
TENANT_SWAP, TENANT_TICKS, TENANT_TICK_SEED = 60, 2, 7
# phase 2's plain comparison of B4 tiled at the tenant shape (P x T =
# 64 x 800), cut in depth: the plain scan runs a step in tens of ms
N_DEPLOY_PLAIN = 600
# phase 10, the wide value vocabularies (ROADMAP §C1): a per-team label
# with 1,100 teams (K 16, V1 2048), its In list with 40 pods, minValues 2
# on the instance type over 1,100 types (MW 2048), and a pool listing 600
# of 800 types at mixed 50k (V1 1024)
TEAM_KEY = "example.com/team"
N_TEAMS, N_TEAM_IN_PODS = 1_100, 40
MV_TYPES, MV_PODS, MV_TYPES_MW = 1_100, 2_000, 2048
N_LISTED, LISTED_TYPES = 600, 800
# ... whose 50k batch is held to device="cpu" at this depth (the CPU's
# plain scans of the 50k batch at V1 1024 take minutes); the per-team
# input's device="cpu" solve runs in a child process beside phase 10's
# card solves, waited on for at most WIDE_CPU_WAIT_S after them
WIDE_CPU_PODS = 2_000
WIDE_CPU_WAIT_S = 900
# phase 11, the degradation ladder (the only phase that passes a
# SolverConfig.health): mixed 2,000 x 400 and the consolidation env at 200
# nodes; the breaker trips at the first failure and cools down in 60 s of
# an injected clock
LADDER_PODS, LADDER_NODES, LADDER_COOLDOWN = 2_000, 200, 60.0
# phase 12, the solver sidecar: the solo lane at BASELINE config[1]'s mix
# (3,000 x 400, under gRPC's default 4 MiB receive limit), the batch lane
# of four tenants of 750 pods each; the batch window outlasts the spread
# of four such requests' arrivals at the batcher (each decoded and keyed
# first, on the sidecar's worker threads), and max_batch closes the batch
# as soon as the four are in
SIDECAR_PODS, SIDECAR_TENANTS, SIDECAR_TENANT_PODS = 3_000, 4, 750
SIDECAR_WORKERS, SIDECAR_WINDOW, GRPC_RECEIVE_LIMIT = 4, 2.0, 4 * 1024 * 1024
SIDECAR_SMALL_PODS = 200  # the error legs' solves
# phase 13, the operator: mixed 2,000 pending over one NodePool and 400
# types, stepped until no pod is pending or 5 steps have run
OPERATOR_PODS, OPERATOR_STEPS = 2_000, 5
# phase 14, the digital twin: the JAX package's tier-1 wall
# (tests/e2e/test_twin.py:404-436): 2,000 fabricated nodes x 10 pods over
# corpus.generate(24), trace seed 7 (20 minutes of churn, a reclaim wave
# of 4 at minute 2, 6 ICE cells at minute 4), twin seed 7, 2 roster passes
# a minute, a p99 decision-latency wall of 10 s. (a) replays TWIN_MINUTES
# on the card (bench.py's run_twin's 10, past both waves, the fault plan's
# first 150 s and the consolidation of minutes 7-9; the wall's 20 before
# the smoke neared its time limit); (b) the device="cpu" replay in a
# child to TWIN_CPU_MINUTES (past both waves); (c) a checkpoint at
# TWIN_CHECKPOINT (past the ICE wave), resumed on the card to
# TWIN_RESUMED_TO (minutes 7-9, where consolidation runs; 12 before phase
# 17 came, cut to keep the smoke's length)
TWIN_NODES, TWIN_PODS_PER_NODE, TWIN_TYPES, TWIN_SEED = 2_000, 10, 24, 7
TWIN_TRACE_MINUTES, TWIN_P99_MS = 20, 10_000.0
TWIN_MINUTES, TWIN_CPU_MINUTES = 10, 6
TWIN_CHECKPOINT, TWIN_RESUMED_TO = 6, 9
TWIN_CPU_WAIT_S = 600
# phase 16, the solver mesh: 8 positions of the one card (make_mesh's
# devices), and the constrained churn ticks it rides
MESH_SHARDS, MESH_TICKS = 8, 3
# phase 17: the pending pods of its provisioning solve (the gauge), the
# Deployments of its stale-token check, and the constrained batch of its
# donating mesh tick (a tenth of phase 16's, to keep the phase near 60 s)
QUEUE_OPERATOR_PODS, QUEUE_STALE_DEPLOYS, QUEUE_MESH_PODS = 500, 200, 5_000
REPLACES = {
    "fresh_feasibility": "karpenter_tpu/ops/feasibility.py:141",
    "fresh_feasibility_diverse": "karpenter_tpu/ops/feasibility.py:141",
    "fresh_feasibility_constrained": "karpenter_tpu/ops/feasibility.py:141",
    "existing_feasibility": "karpenter_tpu/ops/feasibility.py:264",
    "existing_feasibility_scenarios": "karpenter_tpu/ops/feasibility.py:264",
    "pack": "karpenter_tpu/ops/packing.py:277",
    "wire_pack": "karpenter_tpu/ops/solve.py:267",
    "solve_scenarios": "karpenter_tpu/ops/solve.py:357",
    "pack_domains": "karpenter_tpu/ops/packing.py:277",
    "pack_contrib": "karpenter_tpu/ops/packing.py:1153",
    "pack_classed": "karpenter_tpu/ops/packing.py:1230",
    "apply_rows": "karpenter_tpu/ops/solve.py:400",
    "apply_rows_inplace": "karpenter_tpu/ops/solve.py:404",
    "dense_fresh": "karpenter_tpu/ops/feasibility.py:84",
    "dense_existing": "karpenter_tpu/ops/feasibility.py:298",
    "dense_fresh_relax": "karpenter_tpu/ops/feasibility.py:84",
    "fresh_feasibility_wide": "karpenter_tpu/ops/feasibility.py:141",
    "pack_wide": "karpenter_tpu/ops/packing.py:277",
    "pack_listed": "karpenter_tpu/ops/packing.py:277",
    "pack_mv_wide": "karpenter_tpu/ops/packing.py:153",
    "relax_fill": "karpenter_tpu/ops/relax.py:244",
    "pack_minvalues": "karpenter_tpu/ops/packing.py:601",
    "pack_resv": "karpenter_tpu/ops/packing.py:485",
    "pack_classed_minvalues": "karpenter_tpu/ops/packing.py:1531",
    "scenarios_minvalues": "karpenter_tpu/ops/solve.py:357",
    "pack_tiled": "karpenter_tpu/ops/packing.py:382",
    "pack_classed_tiled": "karpenter_tpu/ops/packing.py:1347",
    "scenarios_tiled": "karpenter_tpu/ops/solve.py:357",
    # B10's stage over the mesh: the shards' partials (GSPMD's partition of
    # the feasibility stage) and the fold at the scan boundary
    "fresh_partial": "karpenter_tpu/parallel/mesh.py:233",
    "existing_partial": "karpenter_tpu/parallel/mesh.py:233",
    "mesh_fold": "karpenter_tpu/ops/solve.py:166",
}
# the source of each kernel row (B4 with domains and with contributor
# counting are pack.cu's domain and contributor paths; B3's two entries
# share dense_feasibility.cu)
SOURCES = {"pack_domains": "pack", "pack_contrib": "pack", "solve_scenarios": "pack",
           "dense_fresh": "dense_feasibility", "dense_existing": "dense_feasibility",
           "pack_minvalues": "pack", "pack_resv": "pack", "scenarios_minvalues": "pack",
           "pack_classed_minvalues": "pack_classed", "pack_tiled": "pack",
           "pack_classed_tiled": "pack_classed", "scenarios_tiled": "pack",
           "fresh_partial": "fresh_feasibility", "existing_partial": "existing_feasibility",
           "apply_rows_inplace": "apply_rows"}
# B1's and B2's rows at the other shapes of their paths: (the kernel, the
# paths whose launches run at that shape; a part of the kernel's own row)
SHAPE_ROWS = {
    "fresh_feasibility_diverse": ("fresh_feasibility", (
        "diverse", "diverse_ticks", "diverse_per_group", "diverse_minvalues",
        "diverse_minvalues_auto")),
    "fresh_feasibility_constrained": ("fresh_feasibility", (
        "constrained", "ticks", "constrained_minvalues")),
    "existing_feasibility_scenarios": ("existing_feasibility", (
        "multi", "single", "cons_minvalues")),
    # B3's fresh entry at the relax path's shape, B1 and B4 at the wide
    # value vocabularies of phase 10
    "dense_fresh_relax": ("dense_fresh", ("config0", "ident", "ident_ticks", "zonal",
                                          "zonal_reject")),
    "fresh_feasibility_wide": ("fresh_feasibility", ("team_exists", "team_in")),
    "pack_wide": ("pack", ("team_exists", "team_in")),
    "pack_listed": ("pack", ("listed_types",)),
    # B4's minValues phases at an instance-type floor over 1,100 types
    "pack_mv_wide": ("pack", ("mv_types",)),
}
# the one PyTorch call that computes a kernel's function, timed beside it
LIBRARY = {"apply_rows": "Tensor.index_copy", "apply_rows_inplace": "Tensor.index_copy_",
           "mesh_fold": "Tensor.sum(0) of the stacked fail_t (no finish)"}
# the fold's earlier yardstick, over the D x M partials as a list
LIBRARY_STACK = "torch.stack(partials).sum(0)"
# B7 is the scenario-batched dispatch of these kernels; pack.cu holds its
# scenario grid
B7_SOURCES = ("pack", "existing_feasibility", "wire_pack", "fresh_feasibility")
RELAX_KERNELS = ("fresh_feasibility", "pack", "wire_pack", "dense_feasibility",
                 "dense_fresh", "relax_fill")
# the kernels each end-to-end path must launch: B2 only runs with nodes
PATH_KERNELS = {
    "50k": ("fresh_feasibility", "pack", "wire_pack"),
    "nodes": ("fresh_feasibility", "existing_feasibility", "pack", "wire_pack"),
    # the same batch through the ops dense route: B3's two entries
    "dense_route": ("dense_feasibility", "dense_fresh", "dense_existing", "pack",
                    "wire_pack"),
    "constrained": ("fresh_feasibility", "pack", "pack_domains", "wire_pack"),
    "ticks": ("fresh_feasibility", "pack", "pack_domains", "wire_pack", "apply_rows"),
    "diverse": ("fresh_feasibility", "pack_classed", "wire_pack"),
    "diverse_ticks": ("fresh_feasibility", "pack_classed", "wire_pack", "apply_rows"),
    # the same batch with the classed route off: B4 with contributor counting
    "diverse_per_group": ("fresh_feasibility", "pack", "pack_domains", "pack_contrib",
                          "wire_pack"),
    # the relax loop: the exact dispatch (B1, B4, B6, on zeroed counts
    # when every pod routes), then B3's fresh entry and B9
    "config0": RELAX_KERNELS,
    "ident": RELAX_KERNELS,
    "ident_ticks": RELAX_KERNELS,
    "zonal": RELAX_KERNELS,
    "zonal_reject": RELAX_KERNELS,
    # the floors-and-ledger loop: B4 with minValues floors, with the reservation ledger,
    # with domains and floors; B5 with floors; the auto route of the
    # diverse mix over floors (B4 with contributors and floors)
    "minvalues": ("fresh_feasibility", "pack", "pack_minvalues", "wire_pack"),
    "reserved": ("fresh_feasibility", "pack", "pack_resv", "wire_pack"),
    "constrained_minvalues": ("fresh_feasibility", "pack", "pack_domains", "pack_minvalues",
                              "wire_pack"),
    "diverse_minvalues": ("fresh_feasibility", "pack_classed", "pack_classed_minvalues",
                          "wire_pack"),
    "diverse_minvalues_auto": ("fresh_feasibility", "pack", "pack_contrib", "pack_minvalues",
                               "wire_pack"),
    # the tenant cell: the tiled mode, chosen by the driver's gate (no
    # table kernel); its churn ticks; the classed route forced (B5
    # tiled); a scenario batch (B7's grid tiled)
    "tenant": ("pack", "pack_tiled", "wire_pack"),
    "tenant_ticks": ("pack", "pack_tiled", "wire_pack", "apply_rows"),
    "tenant_classed": ("pack_classed", "pack_classed_tiled", "wire_pack"),
    "tenant_scenarios": ("pack", "pack_tiled", "wire_pack"),
    # the ladder phase's kernel-rung solve after the cool-down
    "ladder": ("fresh_feasibility", "pack", "wire_pack"),
    # the sidecar: tenant t0's solo solve, the four tenants' union solve
    # (B1, the pack.cu grid and B6 over the scenarios; no B2: no state
    # nodes), a deadline overrun (the sidecar's two solves past the
    # deadline, then the client's in-process one)
    "sidecar_solo": ("fresh_feasibility", "pack", "wire_pack"),
    "sidecar_batch": ("fresh_feasibility", "pack", "wire_pack"),
    "sidecar_fallback": ("fresh_feasibility", "pack", "wire_pack"),
    # the operator's reconcile loop, in process and through the sidecar
    "operator": ("fresh_feasibility", "pack", "wire_pack"),
    "operator_remote": ("fresh_feasibility", "pack", "wire_pack"),
    # the digital twin's replay and its resumed run: provisioning over the
    # fleet's nodes (B1, B2, B4, B6), the residency store's row deltas
    # (B8), the consolidation probes' scenario batches (B7: B2[S], the
    # pack.cu grid, B6[S]; counted apart as scenario launches)
    "twin": ("fresh_feasibility", "existing_feasibility", "pack", "wire_pack", "apply_rows"),
    "twin_resumed": ("fresh_feasibility", "existing_feasibility", "pack", "wire_pack",
                     "apply_rows"),
}
TABLE_KERNELS = ("fresh_feasibility", "existing_feasibility", "dense_feasibility")
# ... and those it must not launch: the classed route replaces B4, the
# dense route B1 and B2
PATH_ABSENT = {"diverse": ("pack",), "diverse_ticks": ("pack",),
               "diverse_per_group": ("pack_classed",),
               "dense_route": ("fresh_feasibility", "existing_feasibility"),
               "minvalues": ("pack_classed", "pack_resv"),
               "reserved": ("pack_classed", "pack_minvalues"),
               "constrained_minvalues": ("pack_classed", "pack_resv"),
               "diverse_minvalues": ("pack",),
               "diverse_minvalues_auto": ("pack_classed",),
               "tenant": TABLE_KERNELS + ("pack_classed",),
               "tenant_ticks": TABLE_KERNELS + ("pack_classed",),
               "tenant_classed": TABLE_KERNELS + ("pack",),
               "tenant_scenarios": TABLE_KERNELS + ("pack_classed",)}
# ... and those each consolidation path must launch over a scenario batch
CONS_KERNELS = ("existing_feasibility", "pack", "wire_pack")
CONS_MV_KERNELS = CONS_KERNELS + ("pack_minvalues",)
# the solve args each feasibility kernel reads, in its wrapper's order
B1_NAMES = ("g_def", "g_neg", "g_mask", "g_req", "p_def", "p_neg", "p_mask",
            "p_daemon", "p_tol", "p_titype_ok", "t_def", "t_mask", "t_alloc",
            "o_avail", "o_zone", "o_ct", "well_known", "gk_g", "gk_k", "gk_w",
            "goff_idx")
B2_NAMES = ("g_def", "g_neg", "g_mask", "g_req", "n_def", "n_mask", "n_avail",
            "n_base", "n_tol", "gk_g", "gk_k", "gk_w")
# B3's two entries: B1's and B2's inputs without the live-pair index
B3_NAMES = B1_NAMES[:17]
B3E_NAMES = B2_NAMES[:9] + ("well_known",)


class SmokeFailure(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def ptxas_summary(text):
    """Registers and spill bytes per kernel from nvcc's -Xptxas -v output."""
    regs = re.findall(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill stores", text)
    return f"registers {'/'.join(regs)}, spill stores {'/'.join(spills)} B"


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed(fn):
    """``fn()``'s result and its milliseconds over that one call (CUDA
    events): the plain scans, seconds long at the cells' shapes, run once
    where the kernels run many times."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def nbytes(tensors):
    """Bytes of ``tensors``; a tuple among them (the scan's TileInputs)
    counts by its members."""
    return sum(nbytes(t) if isinstance(t, tuple) else t.numel() * t.element_size()
               for t in tensors)


def bound_ms(read_write_bytes, ops):
    t_bytes = read_write_bytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(kernel_out, ref_out):
    """Max |kernel - reference| over every output (a shape or dtype
    mismatch raises)."""
    err = 0.0
    for i, (k, r) in enumerate(zip(kernel_out, ref_out)):
        if k.shape != r.shape or k.dtype != r.dtype:
            raise SmokeFailure(f"output {i}: {k.dtype}{tuple(k.shape)} vs "
                               f"{r.dtype}{tuple(r.shape)}")
        d = (k.to("cpu").double() - r.to("cpu").double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def b1_ops(a):
    """B1's least work on solve args ``a`` (by name): per (p, t) the base's
    K x W word ANDs (W = ceil(V1 / 32)) and the template's O offerings, per
    live pair (nonzero weight) and type W more, per group goff_idx lists
    and type O offerings, per cell R subtractions and R divisions."""
    P, K, V1 = a["p_mask"].shape
    G, T = a["g_mask"].shape[0], a["t_mask"].shape[0]
    R, O, W = a["t_alloc"].shape[1], a["o_avail"].shape[1], (V1 + 31) // 32
    live = int((a["gk_w"] != 0).sum())
    listed = int(a["goff_idx"].unique().numel())
    return P * T * (K * W + O) + P * live * T * W + P * listed * T * O + P * G * T * 2 * R


def b2_ops(a):
    """B2's least work: per (node, live pair) W word ANDs, per (node, group)
    R subtractions and R divisions, per scenario cell one gated write."""
    N, R = a["n_avail"].shape
    G, V1 = a["g_mask"].shape[0], a["g_mask"].shape[2]
    live = int((a["gk_w"] != 0).sum())
    return N * live * ((V1 + 31) // 32) + N * G * 2 * R + a["n_tol"].numel()


def _live_index(a):
    """The live entries (nonzero weight) of the pair index: their count,
    their distinct (group, key) pairs and their distinct keys."""
    w = a["gk_w"].cpu().numpy() != 0
    pairs = set(zip(a["gk_g"].cpu().numpy()[w].tolist(), a["gk_k"].cpu().numpy()[w].tolist()))
    return int(w.sum()), pairs, {k for _, k in pairs}


def b1_reads(a, zk, ck):
    """B1's least reads, bytes by input name: the group-independent rows
    (types, offerings, the templates' masks, definitions, daemons, toleration
    and type rows, the groups' requests) whole; the groups' mask rows only
    for live pairs and for the zone and capacity-type keys of the groups
    goff_idx lists, their definition and negation bytes, p_neg and
    well_known only for live pairs' keys; the index's weights and goff_idx
    whole, its groups and keys only at live entries."""
    P, K, V1 = a["p_mask"].shape
    G = a["g_mask"].shape[0]
    n_live, pairs, keys = _live_index(a)
    listed = {g for g in a["goff_idx"].cpu().tolist() if 0 <= g < G}
    rows = pairs | {(g, k) for g in listed for k in (zk, ck)}
    reads = {n: nbytes([a[n]]) for n in (
        "g_req", "p_def", "p_mask", "p_daemon", "p_tol", "p_titype_ok", "t_def", "t_mask",
        "t_alloc", "o_avail", "o_zone", "o_ct", "gk_w", "goff_idx")}
    reads.update(g_mask=len(rows) * V1, g_def=len(pairs), g_neg=len(pairs),
                 p_neg=P * len(keys), well_known=len(keys), gk_g=4 * n_live, gk_k=4 * n_live)
    return reads


def b2_reads(a):
    """B2's least reads, bytes by input name: the nodes' room rows, the
    groups' requests, n_tol and the index's weights whole; the nodes' mask
    and definition rows only for live pairs' keys; the groups' mask,
    definition and negation rows only for live pairs; the index's groups
    and keys only at live entries."""
    N = a["n_avail"].shape[0]
    V1 = a["g_mask"].shape[2]
    n_live, pairs, keys = _live_index(a)
    reads = {n: nbytes([a[n]]) for n in ("n_avail", "n_base", "n_tol", "g_req", "gk_w")}
    reads.update(n_mask=N * len(keys) * V1, n_def=N * len(keys), g_mask=len(pairs) * V1,
                 g_def=len(pairs), g_neg=len(pairs), gk_g=4 * n_live, gk_k=4 * n_live)
    return reads


def one_kernel(name, per_call, n=1):
    """Raise unless torch.profiler saw ``n`` device activities a call of
    the wrapper, one each (its kernels: no memset, no copy beside them)."""
    if per_call is not None and list(per_call.values()) != [1] * n:
        raise SmokeFailure(f"{name}: {per_call} on the device per call, want its {n} kernel(s)")


def shuffled_index(a, seed):
    """Solve args ``a`` (by name) with the live-pair index in another order:
    its entries shuffled, half as many weight-0 pads (group 0, key 0)
    interleaved, and goff_idx shuffled with its first entry repeated. B1's
    and B2's tables must not change (JAX's segment_sum and scatter do not
    depend on the order)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gk = np.stack([a[n].cpu().numpy() for n in ("gk_g", "gk_k", "gk_w")])
    gk = np.concatenate([gk, np.zeros((3, gk.shape[1] // 2 + 1), np.int32)], axis=1)
    gk = gk[:, rng.permutation(gk.shape[1])]
    goff = a["goff_idx"].cpu().numpy()
    goff = rng.permutation(np.concatenate([goff, goff[:1]]))
    out = dict(a)
    for n, x in zip(("gk_g", "gk_k", "gk_w", "goff_idx"), (*gk, goff)):
        out[n] = torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(a[n].device)
    return out


def b1_row(a, zk, ck, label, reps=50, kernels=1):
    """B1's row at solve args ``a`` (by name, on the card): the kernel
    against its plain version, also over shuffled_index(a) (max |diff| over
    both), wrapper ms (CUDA events), device ms (``kernels`` a call: the
    direct mode's word pass and the tables) and the bound from b1_reads and
    b1_ops."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas

    b1_in = [a[n] for n in B1_NAMES]
    shuffled = [shuffled_index(a, 10)[n] for n in B1_NAMES]

    def b1():
        return feas.fresh_claim_feasibility_sparse(*b1_in, zone_kid=zk, ct_kid=ck)

    def plain():
        return feas.fresh_claim_feasibility_sparse_reference(*b1_in, zone_kid=zk, ct_kid=ck)

    out, ref = b1(), plain()
    out_s = feas.fresh_claim_feasibility_sparse(*shuffled, zone_kid=zk, ct_kid=ck)
    torch.cuda.synchronize()
    P, G, T = out[1].shape
    row = with_device(dict(
        max_abs_err=max(max_abs_err(out, ref), max_abs_err(out_s, ref)),
        ms=cuda_ms(b1, reps), plain_ms=cuda_ms(plain, 10),
        bound=bound_ms(sum(b1_reads(a, zk, ck).values()) + nbytes(out), b1_ops(a)),
        shape=(f"{label}: P={P} G={G} T={T} K={a['g_mask'].shape[1]} "
               f"V1={a['g_mask'].shape[2]} R={a['t_alloc'].shape[1]} "
               f"O={a['o_avail'].shape[1]} L={a['gk_g'].shape[0]} "
               f"({int((a['gk_w'] != 0).sum())} live) LZ={a['goff_idx'].shape[0]}; "
               "== plain over a shuffled index"),
    ), b1, 100)
    one_kernel(f"B1 {label}", row["device_per_call"], kernels)
    return row


def b2_row(a, label, reps=50):
    """B2's row at solve args ``a``, as b1_row's."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas

    b2_in = [a[n] for n in B2_NAMES]
    shuffled = [shuffled_index(a, 11)[n] for n in B2_NAMES]

    def b2():
        return feas.existing_node_feasibility_sparse(*b2_in)

    def plain():
        return feas.existing_node_feasibility_sparse_reference(*b2_in)

    out, ref = b2(), plain()
    out_s = feas.existing_node_feasibility_sparse(*shuffled)
    torch.cuda.synchronize()
    if not int(out.max()):
        raise SmokeFailure(f"B2 {label}: no node has room for any group")
    row = with_device(dict(
        max_abs_err=max(max_abs_err([out], [ref]), max_abs_err([out_s], [ref])),
        ms=cuda_ms(b2, reps), plain_ms=cuda_ms(plain, 20),
        bound=bound_ms(sum(b2_reads(a).values()) + nbytes([out]), b2_ops(a)),
        shape=(f"{label}: S={out.shape[0] if out.dim() == 3 else 1} "
               f"N={a['n_avail'].shape[0]} G={a['g_mask'].shape[0]} "
               f"L={a['gk_g'].shape[0]} ({int((a['gk_w'] != 0).sum())} live) "
               f"R={a['n_avail'].shape[1]}; == plain over a shuffled index"),
    ), b2, 100)
    one_kernel(f"B2 {label}", row["device_per_call"])
    return row


def build_batch(torch_solver_cls, config_cls, pods, n_types, state_nodes=(),
                device="cuda", cache=None, pools=None, its=None, classed=None, config_kw=None,
                **solver_kw):
    """A TorchSolver over ``pods``: the default NodePool (or ``pools``) over
    corpus.generate(n_types) (or the catalog ``its``); ``config_kw`` go to
    the SolverConfig beside ``device`` and ``classed``, ``solver_kw`` to
    the scheduler (reserved_capacity_enabled)."""
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver.example import example_nodepool

    pools = pools or [example_nodepool()]
    its = corpus.generate(n_types) if its is None else its
    its_by_pool = {p.name: list(its) for p in pools}
    topo = Topology(Client(TestClock()), list(state_nodes), pools, its_by_pool, pods)
    return torch_solver_cls(
        pools, its_by_pool, topo, state_nodes=list(state_nodes),
        config=config_cls(device=device, classed=classed, **(config_kw or {})),
        encode_cache=cache, **solver_kw,
    )


def team_pool(values=None):
    """A NodePool whose one requirement is ``example.com/team``: Exists, or
    In ``values`` (a per-team label with one value a team)."""
    from karpenter_tpu_torch.api.objects import (
        NodeClaimSpec, NodeClaimTemplate, NodePool, NodePoolSpec, NodeSelectorRequirement,
        ObjectMeta,
    )

    req = (NodeSelectorRequirement(TEAM_KEY, "Exists", ()) if values is None
           else NodeSelectorRequirement(TEAM_KEY, "In", tuple(values)))
    return NodePool(metadata=ObjectMeta(name="default"), spec=NodePoolSpec(
        template=NodeClaimTemplate(spec=NodeClaimSpec(requirements=[req]))))


def type_pool(names=None, min_values=None):
    """A NodePool whose one requirement is the instance type: Exists (with
    ``min_values``), or In ``names`` (a pool that lists its types)."""
    from karpenter_tpu_torch.api import labels as labels_mod
    from karpenter_tpu_torch.api.objects import (
        NodeClaimSpec, NodeClaimTemplate, NodePool, NodePoolSpec, NodeSelectorRequirement,
        ObjectMeta,
    )

    req = (NodeSelectorRequirement(labels_mod.INSTANCE_TYPE, "Exists", (), min_values=min_values)
           if names is None else
           NodeSelectorRequirement(labels_mod.INSTANCE_TYPE, "In", tuple(names)))
    return NodePool(metadata=ObjectMeta(name="default"), spec=NodePoolSpec(
        template=NodeClaimTemplate(spec=NodeClaimSpec(requirements=[req]))))


def team_pods(n):
    """``n`` pods of 500m / 1 GiB, pod i selecting ``example.com/team: team-i``."""
    from karpenter_tpu_torch.solver.workloads import _pod

    return [_pod(f"team-{i}", 500, 1024, node_selector={TEAM_KEY: f"team-{i}"})
            for i in range(n)]


def wide_inputs(full=True):
    """The wide value vocabularies of ROADMAP §C1, each (label, pools(),
    catalog(), pods): a per-team label with 1,100 teams over Exists (K 16,
    V1 2048; ``full=False`` leaves it out), the same label's In list of
    1,100 teams with 40 pods, minValues 2 on the instance type over 1,100
    types (MW 2048), and a pool listing 600 of 800 types at mixed 50k (V1
    1024)."""
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    teams = [f"team-{i}" for i in range(N_TEAMS)]
    out = []
    if full:
        out.append(("team_exists", lambda: [team_pool()], lambda: corpus.generate(N_TYPES),
                    team_pods(N_TEAMS)))
    out.append(("team_in", lambda: [team_pool(teams)], lambda: corpus.generate(N_TYPES),
                team_pods(N_TEAM_IN_PODS)))
    out.append(("mv_types", lambda: [type_pool(min_values=2)],
                lambda: corpus.generate(MV_TYPES), mixed_pods(MV_PODS)))
    listed = [it.name for it in corpus.generate(LISTED_TYPES)[:N_LISTED]]
    out.append(("listed_types", lambda: [type_pool(listed)],
                lambda: corpus.generate(LISTED_TYPES), mixed_pods(N_PODS)))
    return out


def host_snapshot(solver, pods):
    """The main path's padded solve_args (numpy), snapshot, statics and the
    encode delta for ``solver``'s batch, built exactly as
    TorchSolver._solve_fast builds them."""
    from karpenter_tpu_torch.solver import encode as enc

    groups, rest = enc.partition_and_group(
        pods, topology=solver.oracle.topology,
        merge_bootstrap_affinity=not solver.oracle.reserved_capacity_enabled)
    if rest:
        raise SmokeFailure(f"{len(rest)} pods left the dense path")
    snap, (a_tzc, res_cap0, a_res), _, _, delta = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    N = enc._next_pow2(len(snap.existing_names), floor=1) if snap.existing_names else 0
    statics = solver._kernel_statics(snap, G)
    return snap.padded(G, N).solve_args(a_tzc, res_cap0, a_res), snap, statics, delta


def device_snapshot(solver, pods):
    """The main path's kernel inputs for ``solver``'s batch: the padded
    solve_args on the card, the statics, NMAX and the fills dtype."""
    import torch

    from karpenter_tpu_torch.solver.args import to_device_args

    host, snap, statics, _ = host_snapshot(solver, pods)
    fit = solver._fit_matrix(snap)
    nmax = solver._select_nmax(snap, fit, None)
    fills = torch.int16 if solver._fill_bound(snap, fit) < 2**15 else torch.int32
    return to_device_args(host, "cuda"), statics, nmax, fills


def phase_kernels(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 2: every kernel against its plain version on the card."""
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import example_state_nodes
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    rows = {}
    pods = mixed_pods(N_PODS)
    solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES)
    args, statics, nmax, fills = device_snapshot(solver, pods)
    a = dict(zip(SOLVE_ARG_NAMES, args))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    P, G, T = a["p_titype_ok"].shape[0], a["g_count"].shape[0], a["t_alloc"].shape[0]
    K, V1 = a["g_mask"].shape[1:]
    R, O = a["t_alloc"].shape[1], a["o_avail"].shape[1]

    # ---- B1 fresh feasibility ----
    rows["fresh_feasibility"] = b1_row(a, zk, ck, "mixed 50k")
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)

    # ---- B3 fresh, the dense twin, on the same snapshot: == plain, == B1 ----
    b3_in = [a[n] for n in B3_NAMES]
    b3 = feas.fresh_claim_feasibility(*b3_in, zone_kid=zk, ct_kid=ck)
    torch.cuda.synchronize()
    if max_abs_err(b3, b1):
        raise SmokeFailure("B3 fresh: the dense tables differ from B1's")
    rows["dense_fresh"] = dense_fresh_row(b3_in, zk, ck, "mixed 50k, == B1")

    # ---- B4 packing scan and B6 wire pack on the 50k tables ----
    cap_ng = torch.zeros((0, G), dtype=torch.int32, device="cuda")
    pack_in = solve_mod.pack_args(a, *b1, cap_ng)
    st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"])
    while True:
        b4 = packing_mod.pack(*pack_in, **st)
        if not bool(b4[3].item()):
            break
        st["nmax"] *= 2
    b4_ref = packing_mod.pack_reference(*pack_in, **st)
    torch.cuda.synchronize()
    n_open = int(b4[2].item())
    ops = pack_ops(a["g_count"], b4[5], b4[2], T, R, V1, offered=offered_words(a))
    rows["pack"] = with_device(dict(
        max_abs_err=max_abs_err(b4, b4_ref),
        ms=cuda_ms(lambda: packing_mod.pack(*pack_in, **st), 20),
        plain_ms=cuda_ms(lambda: packing_mod.pack_reference(*pack_in, **st), 3),
        bound=bound_ms(nbytes(pack_in) + nbytes(b4), ops),
        shape=f"G={G} T={T} NMAX={st['nmax']} claims={n_open} wf_iters={st['wf_iters']}",
    ), lambda: packing_mod.pack(*pack_in, **st), 20)
    b6 = solve_mod.wire_pack(b4, fills)
    b6_ref = solve_mod.wire_pack_reference(b4, fills)
    torch.cuda.synchronize()
    b6_in = [b4[i] for i in (0, 1, 4, 5, 7, 8)]
    b6_out = [b6[i] for i in (0, 1, 4, 5, 7, 8)]
    rows["wire_pack"] = with_device(dict(
        max_abs_err=max_abs_err(b6, b6_ref),
        ms=cuda_ms(lambda: solve_mod.wire_pack(b4, fills), 50),
        plain_ms=cuda_ms(lambda: solve_mod.wire_pack_reference(b4, fills), 20),
        bound=bound_ms(nbytes(b6_in) + nbytes(b6_out), b4[1].numel() + sum(x.numel() for x in b6_out)),
        shape=f"NMAX={st['nmax']} T={T} fills={fills}",
    ), lambda: solve_mod.wire_pack(b4, fills), 100)

    # ---- B2 existing-node caps on the state-node snapshot ----
    pods2 = mixed_pods(NODE_PODS)
    solver2 = build_batch(torch_solver_cls, config_cls, pods2, N_TYPES,
                          state_nodes=example_state_nodes(N_NODES))
    args2, _, _, _ = device_snapshot(solver2, pods2)
    a2 = dict(zip(SOLVE_ARG_NAMES, args2))
    rows["existing_feasibility"] = b2_row(a2, "32 nodes")
    b2 = feas.existing_node_feasibility_sparse(*(a2[n] for n in B2_NAMES))
    N2, G2 = a2["n_avail"].shape[0], a2["g_count"].shape[0]
    # ---- B3 existing, the dense twin, on the same snapshot: == plain, == B2 ----
    b3e_in = [a2[n] for n in B3E_NAMES]
    (K2, V12), R2 = a2["g_mask"].shape[1:], a2["n_avail"].shape[1]
    b3e = feas.existing_node_feasibility(*b3e_in)
    b3e_ref = feas.existing_node_feasibility_reference(*b3e_in)
    torch.cuda.synchronize()
    if max_abs_err([b3e], [b2]):
        raise SmokeFailure("B3 existing: the dense table differs from B2's")
    rows["dense_existing"] = with_device(dict(
        max_abs_err=max_abs_err([b3e], [b3e_ref]),
        ms=cuda_ms(lambda: feas.existing_node_feasibility(*b3e_in), 50),
        plain_ms=cuda_ms(lambda: feas.existing_node_feasibility_reference(*b3e_in), 20),
        bound=bound_ms(nbytes(b3e_in) + nbytes([b3e]), (G2 + N2) * K2 * V12
                       + N2 * G2 * (K2 * ((V12 + 31) // 32) + 2 * R2)),
        shape=f"N={N2} G={G2} K={K2} V1={V12} R={R2}, == B2",
    ), lambda: feas.existing_node_feasibility(*b3e_in), 100)
    rows["dense_fresh_relax"], rows["relax_fill"] = relax_row(torch_solver_cls, config_cls)
    rows.update(wide_rows(torch_solver_cls, config_cls))
    rows["solve_scenarios"] = scenario_row()
    rows["existing_feasibility_scenarios"] = rows["solve_scenarios"].pop("b2_row")
    rows.update(constrained_rows(torch_solver_cls, config_cls, encode_cache_cls))
    rows.update(diverse_rows(torch_solver_cls, config_cls))
    rows.update(floors_rows(torch_solver_cls, config_cls))
    rows.update(tiled_rows(torch_solver_cls, config_cls))
    for name, row in rows.items():
        if row["max_abs_err"] != 0.0:
            raise SmokeFailure(f"{name}: kernel disagrees with its plain version "
                               f"(max |diff| {row['max_abs_err']})")
    return rows


def wide_rows(torch_solver_cls, config_cls):
    """Phase 2's rows at a wide value vocabulary: at phase 10's team-In
    input (40 pods over a pool listing 1,100 teams, K 16, V1 2048), B1 (its
    direct mode: a word pass across the card, then the tables) and B4; at
    its listed-types input (a pool listing 600 of 800 types at mixed 50k,
    V1 1024, T 600), B4 (``pack_listed``); at its minValues input (minValues
    2 on the instance type over 1,100 types, MW 2048), B4 (``pack_mv_wide``).
    Each against its plain version, B4's rows with the shared memory and
    spill scratch the scan took. Tolerance: exact equality."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

    rows = {}
    for label, want, row in (("team_in", (16, 2048), "pack_wide"),
                             ("listed_types", (16, 1024), "pack_listed"),
                             ("mv_types", MV_TYPES_MW, "pack_mv_wide")):
        _, pools, catalog, pods = [w for w in wide_inputs(full=False) if w[0] == label][0]
        solver = build_batch(torch_solver_cls, config_cls, pods, 0, pools=pools(),
                             its=catalog())
        args, statics, nmax, _ = device_snapshot(solver, pods)
        a = dict(zip(SOLVE_ARG_NAMES, args))
        zk, ck = statics["zone_kid"], statics["ct_kid"]
        P, G, T = a["p_titype_ok"].shape[0], a["g_count"].shape[0], a["t_alloc"].shape[0]
        K, V1 = a["g_mask"].shape[1:]
        R, O = a["t_alloc"].shape[1], a["o_avail"].shape[1]
        got = a["t_mvoh"].shape[-1] if label == "mv_types" else (K, V1)
        if got != want:
            raise SmokeFailure(f"wide rows, {label}: {got} (want {want}: K, V1 or MW)")
        if label == "team_in":
            lay = feas.fresh_layout(P, G, T, K, V1, R, O, a["gk_g"].shape[0])
            rows["fresh_feasibility_wide"] = b1_row(
                a, zk, ck, f"team-in V1 2048, {lay['mode']}, tiles {lay['TT']} x {lay['TG']}, "
                f"pair chunk {lay['PC']}, {lay['smem']} B, {lay['words']} words",
                kernels=2 if lay["mode"] == "direct" else 1)
        rows[row] = wide_pack_row(a, statics, nmax, f"{label} V1 {V1}"
                                  + (f" MW {want}" if label == "mv_types" else ""))
    return rows


def wide_pack_row(a, statics, nmax, label):
    """B4 on the named solve args ``a`` (on the card) over B1's tables,
    NMAX doubled while it overflows, against pack_reference: its wrapper
    and device times, the plain version's, the bound (pack_ops), and the
    shared memory and spill scratch the launch took (packing.layouts)."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod

    zk, ck = statics["zone_kid"], statics["ct_kid"]
    G, T = a["g_count"].shape[0], a["t_alloc"].shape[0]
    V1, R = a["g_mask"].shape[2], a["t_alloc"].shape[1]
    P, MV = a["p_mvmin"].shape
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    cap_ng = torch.zeros((0, G), dtype=torch.int32, device="cuda")
    pack_in = solve_mod.pack_args(a, *b1, cap_ng)
    st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"])
    packing_mod.layouts.clear()
    while True:
        b4 = packing_mod.pack(*pack_in, **st)
        if not bool(b4[3].item()):
            break
        st["nmax"] *= 2
    b4_ref, ref_ms = timed(lambda: packing_mod.pack_reference(*pack_in, **st))
    torch.cuda.synchronize()
    smem, spill = next(iter(packing_mod.layouts.values()))
    return with_device(dict(
        max_abs_err=max_abs_err(b4, b4_ref),
        ms=cuda_ms(lambda: packing_mod.pack(*pack_in, **st), 10),
        plain_ms=ref_ms,
        bound=bound_ms(nbytes(pack_in) + nbytes(b4),
                       pack_ops(a["g_count"], b4[5], b4[2], T, R, V1, P=P, mv=MV,
                                offered=offered_words(a))),
        shape=(f"{label}: G={G} T={T} NMAX={st['nmax']} claims={int(b4[2])}; "
               f"{smem} B shared, {spill} B spilled"),
        smem_bytes=smem, spill_bytes=spill,
    ), lambda: packing_mod.pack(*pack_in, **st), 10)


def dense_fresh_row(b3_in, zk, ck, label):
    """B3's fresh entry on ``b3_in`` (its 17 inputs on the card) against
    its plain version: wrapper and device times, the bound. Tolerance:
    exact equality."""
    from karpenter_tpu_torch.ops import feasibility as feas

    b3 = feas.fresh_claim_feasibility(*b3_in, zone_kid=zk, ct_kid=ck)
    b3_ref = feas.fresh_claim_feasibility_reference(*b3_in, zone_kid=zk, ct_kid=ck)
    P, G = b3_in[8].shape
    T, K, V1 = b3_in[11].shape
    R, O = b3_in[12].shape[1], b3_in[13].shape[1]
    W = (V1 + 31) // 32
    lay = feas.dense_layout(P, -1, G, T, K, V1, R, O)
    return with_device(dict(
        max_abs_err=max_abs_err(b3, b3_ref),
        ms=cuda_ms(lambda: feas.fresh_claim_feasibility(*b3_in, zone_kid=zk, ct_kid=ck), 50),
        plain_ms=cuda_ms(lambda: feas.fresh_claim_feasibility_reference(
            *b3_in, zone_kid=zk, ct_kid=ck), 10),
        # the mask rows' bit words (W = ceil(V1 / 32) per key), compat
        # per (p, g), then per cell the merged K x W join, the offerings
        # and fits_count
        bound=bound_ms(nbytes(b3_in) + nbytes(b3),
                       (G + P + T) * K * V1 + P * G * K * W + P * G * T * (K * W + O + 2 * R)),
        shape=(f"{label}: P={P} G={G} T={T} K={K} V1={V1} R={R} O={O}; {lay['mode']}, "
               f"tiles {lay['tiles'][0]} x {lay['tiles'][1]}, {lay['smem']} B"),
    ), lambda: feas.fresh_claim_feasibility(*b3_in, zone_kid=zk, ct_kid=ck), 100)


def relax_plan(solver, pods):
    """The padded run snapshot of ``solver``'s batch and the relaxation
    plan TorchSolver._solve_fast makes for it."""
    from karpenter_tpu_torch.ops import relax as relax_mod
    from karpenter_tpu_torch.solver import encode as enc

    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    if rest:
        raise SmokeFailure(f"{len(rest)} pods left the dense path")
    snap, (_, res_cap0, _), _, _, _ = solver._encode_batch(groups)
    run = snap.padded(enc._next_pow2(len(snap.groups), floor=8), 0)
    return run, relax_mod.plan_bulk(run, res_cap0=res_cap0, n_exist=len(snap.existing_names))


def relax_row(torch_solver_cls, config_cls):
    """Phase 2's B3 row at the relax path's shape (the fresh entry over the
    identical 50k x 400 batch's run heads: 1 x 400) and B9's row:
    relax_fill on the bulk inputs (B3's head tables on the card, which B9
    reads its rows from, and the host's claim sizes, as
    ops/relax.py:solve_bulk builds them), each against its plain version,
    B9 with one launch a call (its launch count and torch.profiler's
    device activities). B9's bound counts the bytes the entry must move
    once: its slot vectors, the table rows its live slots name and its
    outputs; ``bound_old_formula`` is the same rule over the earlier
    two-kernel entry, which took the [NR, T] rows gathered on the host.
    Tolerance: exact equality."""
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import relax as relax_mod
    from karpenter_tpu_torch.solver.args import put
    from karpenter_tpu_torch.solver.workloads import identical_pods

    pods = identical_pods(N_IDENT)
    run, plan = relax_plan(build_batch(torch_solver_cls, config_cls, pods, N_TYPES), pods)
    if plan is None or plan.easy_pods != N_IDENT:
        raise SmokeFailure(f"B9: the identical batch does not route ({plan})")
    head = [put(n, x, "cuda") for n, x in
            zip(relax_mod.HEAD_ARG_NAMES, relax_mod.head_args(plan, run))]
    _, type_ok, n_fit = feas.fresh_claim_feasibility(
        *head, zone_kid=run.zone_kid, ct_kid=run.ct_kid)
    n_r, ge, cl = relax_mod.fill_args(plan, type_ok.cpu().numpy(), n_fit.cpu().numpy())
    b9_in = (*relax_mod.fill_inputs(ge, cl, "cuda"), type_ok, n_fit, n_r)
    _build.reset_launches()
    b9 = relax_mod.relax_fill(*b9_in)
    if _build.launches["relax_fill"] != 1:
        raise SmokeFailure(f"B9: {_build.launches['relax_fill']} launches a call, want 1")
    b9_ref = relax_mod.relax_fill_reference(*b9_in)
    torch.cuda.synchronize()
    if n_r != IDENT_CLAIMS or int(b9[0][:, :n_r].sum()) != N_IDENT:
        raise SmokeFailure(f"B9: {n_r} claims holding {int(b9[0][:, :n_r].sum())} pods")
    GE, NR = b9[0].shape
    P, CRp, T = type_ok.shape
    rows_read = len({(int(p), int(r)) for p, r in zip(cl[0, :n_r], cl[2, :n_r])})
    out_bytes = nbytes(b9)
    # per fill cell the window arithmetic (~12 integer ops), per mask
    # cell a compare and an AND
    ops = GE * NR * 12 + NR * T * 2
    row = with_device(dict(
        max_abs_err=max_abs_err(b9, b9_ref),
        ms=cuda_ms(lambda: relax_mod.relax_fill(*b9_in), 50),
        plain_ms=cuda_ms(lambda: relax_mod.relax_fill_reference(*b9_in), 20),
        bound=bound_ms(ge.nbytes + cl.nbytes + rows_read * T * 5 + out_bytes, ops),
        # the earlier entry read ge's five [GE] vectors, the slots' pool and
        # fill, and the gathered [NR, T] bool and int32 rows
        bound_old_formula=bound_ms(ge.nbytes + 8 * NR + NR * T * 5 + out_bytes, ops)[0],
        shape=f"GE={GE} NR={NR} T={T} P={P} CRp={CRp} claims={n_r} table rows read {rows_read}",
    ), lambda: relax_mod.relax_fill(*b9_in), 100)
    one_kernel("B9", row["device_per_call"])
    return dense_fresh_row(head, run.zone_kid, run.ct_kid, "relax heads"), row


def offered_words(a):
    """The words one type's offering test reads in the scans
    (csrc/pack_common.cuh:Offered), from the run's a_tzc and a_res: the
    zone rows that some type or reservation offers at all, times the span
    of capacity-type words that holds an offered bit; and, for a per-domain
    test over capacity types, the offered capacity-type rows times the
    zone words' span. A value that no offering names is never walked."""
    held = a["a_tzc"].any(0)  # [V1 zones, V1 capacity types]
    if a["a_res"].numel():
        held = held | a["a_res"].any(0).any(0)
    zones, cts = held.any(1).nonzero().flatten(), held.any(0).nonzero().flatten()

    def span(ids):
        return int(ids[-1]) // 32 - int(ids[0]) // 32 + 1 if ids.numel() else 0

    return zones.numel() * span(cts), cts.numel() * span(zones)


def pack_ops(g_count, claim_fills, n_open, T, R, V1, offered, dyn=None, P=1, classes=None,
             mv=0, nres=0):
    """Operations the scan's inputs need: per group step, each claim
    opened at an earlier step is checked against every type (2R fits
    compares, and the offering test: the type's words over the offered
    zones, ``offered[0]`` words (offered_words), each ANDed with the
    claim's words), plus a few per claim open at the step (the scans walk
    the open claims, never NMAX). A dynamic group's step (``dyn`` [G]
    bool: g_dmode > 0) adds the per-domain offering words of each claim
    and template type (the fewer of ``offered``'s two, every domain at
    once) and a per-domain pass over the open claims. ``mv`` floored
    minValues keys add, per step, each claim's per-value pass over its
    types for each key and one pass over each template's types (its bulk
    cap); ``nres`` reservations add, per step, the compatible-reservation
    words of one bulk (``offered[0]`` per reservation and type) and the
    ledger re-gate of each template's types. Over a leading scenario axis,
    the sum over scenarios. With ``classes`` (class_start, class_len,
    class_dyn: the class-batched scan) the per-type work runs once per
    class head, over the claims opened before the class, and each member
    step costs only its per-claim summaries (and, with ``mv``, one
    template pass)."""
    import torch

    g_count, claim_fills, n_open = g_count.cpu(), claim_fills.cpu(), n_open.cpu()
    if g_count.dim() == 1:
        g_count, claim_fills, n_open = g_count[None], claim_fills[None], n_open[None]
    G = claim_fills.shape[1]
    VW, VWD = offered[0], min(offered)
    dyn = [False] * G if dyn is None else [bool(x) for x in dyn.cpu()]
    ops = 0
    for counts, fills, opened in zip(g_count, claim_fills, n_open):
        first = [int(torch.nonzero(fills[:, s])[0, 0]) for s in range(int(opened))]
        if classes is not None:
            for cs, cl, cdyn in zip(*(x.cpu().tolist() for x in classes)):
                if cl <= 0:
                    continue
                live = sum(1 for f in first if f < cs)
                ops += live * T * (2 * R + VW) * (1 + mv)
                if cdyn:
                    ops += (live + P) * T * VWD
                for g in range(cs, cs + cl):
                    if int(counts[g]) > 0:
                        open_g = sum(1 for f in first if f < g)
                        ops += open_g * 8 + (open_g * V1 * 8 if dyn[g] else 0) + P * T * mv
            continue
        for g in range(G):
            if int(counts[g]) <= 0:
                continue
            live = sum(1 for f in first if f < g)
            ops += live * T * (2 * R + VW) * (1 + mv) + live * 8
            ops += P * T * mv + (nres + P) * T * VW * bool(nres)
            if dyn[g]:
                ops += (live + P) * T * VWD + live * V1 * 8
    return ops


def minvalues_consolidation_env(n_nodes, device):
    """build_consolidation_env(n_nodes) with its NodePool carrying the
    minValues pool's requirement (instance-family Exists, minValues 2),
    set before any probe is solved."""
    from karpenter_tpu_torch.api.objects import NodePool
    from karpenter_tpu_torch.solver.example import minvalues_nodepool
    from karpenter_tpu_torch.solver.workloads import build_consolidation_env

    ctx, method, candidates, budgets = build_consolidation_env(n_nodes, device)
    pool = ctx.client.list(NodePool)[0]
    pool.spec.template.spec.requirements = list(
        minvalues_nodepool().spec.template.spec.requirements)
    return ctx, method, candidates, budgets


def scenario_snapshot(device="cuda", build=None):
    """The consolidation path's B7 inputs: one single-node chunk of
    CONS_SCENARIOS scenarios (each removes one candidate) over
    ``build``(CONS_NODES)'s shared encoding (build_consolidation_env by
    default), staged by TorchSolver.submit_scenarios exactly as the search
    stages them."""
    from karpenter_tpu_torch.controllers.disruption.helpers import ScenarioSimulator
    from karpenter_tpu_torch.solver.workloads import build_consolidation_env

    ctx, _, candidates, _ = (build or build_consolidation_env)(CONS_NODES, device)
    sim = ScenarioSimulator(
        ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
        encode_cache=ctx.encode_cache, solver_config=ctx.solver_config,
    )
    chunk = [[c] for c in candidates[:CONS_SCENARIOS]]
    token = sim._solver.submit_scenarios(sim._scenarios_of(chunk))
    if token is None:
        raise SmokeFailure("the consolidation chunk declined the scenario batch")
    return token


def plain_scenarios(args, nmax, fills, zone_kid, ct_kid, wf_iters, has_domains,
                    has_contrib=False, **_):
    """B7's plain version on the same tensors: each kernel's *_reference
    in the dispatch's order (B1 once, B2 over n_tol [S, N, G], the scan
    per scenario, the wire pack over S rows)."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

    a = dict(zip(SOLVE_ARG_NAMES, args))
    compat_pg, type_ok, n_fit = feas.fresh_claim_feasibility_sparse_reference(
        *(a[n] for n in B1_NAMES), zone_kid=zone_kid, ct_kid=ct_kid)
    cap_ng = feas.existing_node_feasibility_sparse_reference(*(a[n] for n in B2_NAMES))
    outs = packing_mod.pack_scenarios_reference(
        *solve_mod.pack_args(a, compat_pg, type_ok, n_fit, cap_ng),
        nmax=nmax, zone_kid=zone_kid, ct_kid=ct_kid, has_domains=has_domains,
        has_contrib=has_contrib, wf_iters=wf_iters)
    return solve_mod.wire_pack_reference(outs, fills)


def scenario_row(build=None, with_b2=True):
    """Phase 2's B7 row: B2[S], B4[S] and B6[S rows] each against its
    plain version, and the whole scenario dispatch against plain_scenarios,
    at the consolidation shapes (``build``'s cluster: the default pool, or
    the minValues pool's). Tolerance: exact equality. With ``with_b2``, also
    B2's own row at the scenario axis (b2_row), under "b2_row"."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES

    token = scenario_snapshot(build=build)
    args, statics = token["args"], dict(token["statics"])
    fills = token["fills_dtype"]
    a = dict(zip(SOLVE_ARG_NAMES, args))
    S, G = a["g_count"].shape
    N, R = a["n_avail"].shape
    T, V1 = a["t_mask"].shape[0], a["t_mask"].shape[2]
    P = a["p_def"].shape[0]
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    st = dict(nmax=token["nmax"], zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"])
    MV = a["p_mvmin"].shape[1]

    def dispatch():
        return solve_mod.solve_scenarios_core_packed(
            *args, fills_dtype=fills, batch_topo=False, **dict(statics, nmax=st["nmax"]))

    while bool(dispatch()[3].any().item()):  # the search's overflow doubling
        st["nmax"] *= 2
    nmax = st["nmax"]
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    b2_in = [a[n] for n in B2_NAMES]
    b2 = feas.existing_node_feasibility_sparse(*b2_in)
    b2_ref = feas.existing_node_feasibility_sparse_reference(*b2_in)
    b4_in = solve_mod.pack_args(a, *b1, b2)
    b4 = packing_mod.pack(*b4_in, **st)
    b4_ref = packing_mod.pack_scenarios_reference(*b4_in, **st)
    b6 = solve_mod.wire_pack(b4, fills)
    b6_ref = solve_mod.wire_pack_reference(b4, fills)
    full = dispatch()
    full_ref = plain_scenarios(args, fills=fills, **st)
    torch.cuda.synchronize()
    if int(b4[4][:len(token["scenarios"])].sum()) < 1:
        raise SmokeFailure("B7: the consolidation chunk placed no pod on a node")
    parts = {
        "B2[S]": max_abs_err([b2], [b2_ref]),
        "B4[S]": max_abs_err(b4, b4_ref),
        "B6[S]": max_abs_err(b6, b6_ref),
        "dispatch": max_abs_err(full, full_ref),
    }
    part_ms = {
        "B2[S]": cuda_ms(lambda: feas.existing_node_feasibility_sparse(*b2_in), 50),
        "B4[S]": cuda_ms(lambda: packing_mod.pack(*b4_in, **st), 20),
        "B6[S]": cuda_ms(lambda: solve_mod.wire_pack(b4, fills), 50),
    }
    # B4[S] on the device alone: the wrapper's zeroing and word passes and
    # the scan, each activity once a call
    b4_device = device_ms(lambda: packing_mod.pack(*b4_in, **st), 20)
    # bytes: the dispatch's inputs read once (B1's and B2's least reads,
    # the larger of the two where both read an input), its wire outputs
    # written once
    reads = b1_reads(a, zk, ck)
    for n, b in b2_reads(a).items():
        reads[n] = max(reads.get(n, 0), b)
    reads.update((n, nbytes([a[n]])) for n in (
        "g_count", "g_hcap", "g_haff", "g_hstg", "g_hscap", "g_hself", "t_cap",
        "a_tzc", "p_limit", "p_has_limit", "n_hcnt", "nh_cnt0", "p_mvmin", "t_mvoh"))
    ops = (b1_ops(a) + b2_ops(a)
           + pack_ops(a["g_count"], b4[5], b4[2], T, R, V1, P=P, mv=MV,
                      offered=offered_words(a))  # B4
           + full[1].numel() * 8 + sum(x.numel() for x in full))  # B6
    row = with_device(dict(
        max_abs_err=max(parts.values()),
        parts=parts,
        part_ms=part_ms,
        part_device_ms={"B4[S]": b4_device[0]},
        part_device_per_call={"B4[S]": b4_device[1]},
        ms=cuda_ms(dispatch, 20),
        plain_ms=cuda_ms(lambda: plain_scenarios(args, fills=fills, **st), 3),
        bound=bound_ms(sum(reads.values()) + nbytes(full), ops),
        shape=f"S={S} N={N} G={G} T={T} MV={MV} NMAX={nmax} claims={b4[2].tolist()}",
    ), dispatch, 20)
    if with_b2:
        row["b2_row"] = b2_row(a, f"consolidation chunk ({CONS_NODES} nodes)")
    return row


def constrained_rows(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 2's rows for the constrained loop's kernels: B4 over the
    domain batch (constrained_mix(50k) x 800 types, has_domains) against
    pack_reference, and B8 at the largest row delta of the loop's first
    churn tick (the same pods and tick seed as phase 5) against its plain
    version and against Tensor.index_copy. Tolerance: exact equality."""
    import random

    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.args import to_device_args
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick, constrained_mix

    rows = {}
    cache = encode_cache_cls()
    pods = constrained_mix(N_PODS)
    solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES_C, device="cuda",
                         cache=cache)
    host_a, snap, statics, _ = host_snapshot(solver, pods)
    if not statics["has_domains"]:
        raise SmokeFailure("the constrained batch carries no domain group")
    fit = solver._fit_matrix(snap)
    a = dict(zip(SOLVE_ARG_NAMES, to_device_args(host_a, "cuda")))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    P, G, T = a["p_titype_ok"].shape[0], a["g_count"].shape[0], a["t_alloc"].shape[0]
    K, V1 = a["g_mask"].shape[1:]
    R = a["t_alloc"].shape[1]
    if not int((a["gk_w"] != 0).sum()):
        raise SmokeFailure("the constrained batch carries no live (group, key) pair")
    rows["fresh_feasibility_constrained"] = b1_row(a, zk, ck, "constrained 50k")
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    cap_ng = torch.zeros((0, G), dtype=torch.int32, device="cuda")
    pack_in = solve_mod.pack_args(a, *b1, cap_ng)
    st = dict(nmax=solver._select_nmax(snap, fit, None), zone_kid=zk, ct_kid=ck,
              wf_iters=statics["wf_iters"], has_domains=True)
    while True:
        b4 = packing_mod.pack(*pack_in, **st)
        if not bool(b4[3].item()):
            break
        st["nmax"] *= 2
    b4_ref, ref_ms = timed(lambda: packing_mod.pack_reference(*pack_in, **st))
    dyn = a["g_dmode"] > 0
    ops = pack_ops(a["g_count"], b4[5], b4[2], T, R, V1, dyn=dyn, P=P,
                   offered=offered_words(a))
    rows["pack_domains"] = with_device(dict(
        max_abs_err=max_abs_err(b4, b4_ref),
        ms=cuda_ms(lambda: packing_mod.pack(*pack_in, **st), 5),
        plain_ms=ref_ms,
        bound=bound_ms(nbytes(pack_in) + nbytes(b4), ops),
        shape=(f"G={G} ({int((a['g_count'] > 0).sum())} real, {int(dyn.sum())} dynamic) "
               f"T={T} P={P} K={K} V1={V1} NMAX={st['nmax']} claims={int(b4[2])} "
               f"wf_iters={st['wf_iters']}"),
    ), lambda: packing_mod.pack(*pack_in, **st), 5)

    # the first churn tick's encode against the same cache: its delta names
    # the changed rows of each argument class, as the residency store sees them
    tick_pods = churn_tick(pods, constrained_mix, random.Random(CHURN_SEED))
    solver_b = build_batch(torch_solver_cls, config_cls, tick_pods, N_TYPES_C, device="cuda",
                           cache=cache)
    inputs = largest_delta(host_a, *host_snapshot(solver_b, tick_pods)[::3])
    # the inputs ride along for phase 17 (main pops them before the JSON line)
    rows["apply_rows"] = dict(b8_row(inputs), inputs=inputs)
    return rows


def device_ms(fn, reps=100):
    """Device milliseconds per call of ``fn`` and the device activities
    (kernels, copies) it ran per call: torch.profiler's device time over
    ``reps`` back-to-back calls (key_averages, self device time), each
    activity's mean time per record times its records per call, rounded
    (the tracer may drop records of a run this short). Where the profiler
    records no device time: CUDA events around the ``reps`` calls, and no
    activity count (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, per_call = 0.0, {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA") or not ev.count:  # host ops, API calls
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
        # the activity by its name without the parameter list
        name = ev.key.replace("(anonymous namespace)::", "").split("(")[0].strip()
        n = max(1, round(ev.count / reps))
        per_call[name] = per_call.get(name, 0) + n
        us += t / ev.count * n * reps
    if us > 0:
        return us / 1e3 / reps, per_call, "torch.profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, None, "CUDA events"


def with_device(row, fn, reps):
    """``row`` with its device-only time: device_ms over ``reps`` calls of
    ``fn``, the kernel's wrapper (its zeroing and word passes included)."""
    ms, per_call, how = device_ms(fn, reps)
    return dict(row, device_ms=ms, device_per_call=per_call, device_timing=how)


def largest_delta(host_a, host_b, delta):
    """(name, host before, host after, row indices) of the argument with
    the largest row delta (bytes) of a churn tick whose encode ``host_b``
    (and ``delta``) follows ``host_a``'s on one cache."""
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.residency import DeviceResidentArgs

    best = None
    for name, ha, hb in zip(SOLVE_ARG_NAMES, host_a, host_b):
        _, idx = DeviceResidentArgs._class_of(name, delta)
        if idx is None or not len(idx) or ha.shape != hb.shape:
            continue
        size = len(idx) * (hb.nbytes // max(hb.shape[0], 1))
        if best is None or size > best[0]:
            best = (size, name, ha, hb, idx)
    if best is None:
        raise SmokeFailure("the churn tick carried no row delta")
    return best[1:]



def b8_row(inputs):
    """B8's row at a churn tick's largest row delta (``largest_delta``):
    the kernel against its plain version, the tick's encode and
    ``Tensor.index_copy``, timed through the wrapper (CUDA events) and on
    the device alone (device_ms); one device kernel a call, no copy of the
    buffer beside it."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.args import put

    name, ha, hb, idx_np = inputs
    arr = put(name, ha, "cuda")
    idx = torch.from_numpy(idx_np.astype(np.int32)).to("cuda")
    vals = torch.from_numpy(np.ascontiguousarray(hb[idx_np])).to("cuda")
    idx64 = idx.long()
    b8 = solve_mod.delta_apply_rows(arr, idx, vals)
    b8_ref = solve_mod.delta_apply_rows_reference(arr, idx, vals)
    torch.cuda.synchronize()
    if not torch.equal(b8.cpu(), torch.from_numpy(np.ascontiguousarray(hb))):
        raise SmokeFailure(f"B8: {name} after the row delta differs from the tick's encode")
    dev_ms, dev_acts, how = device_ms(lambda: solve_mod.delta_apply_rows(arr, idx, vals))
    lib_dev_ms, lib_acts, _ = device_ms(lambda: arr.index_copy(0, idx64, vals))
    one_kernel("B8", dev_acts)
    return dict(
        max_abs_err=max_abs_err([b8], [b8_ref]),
        ms=cuda_ms(lambda: solve_mod.delta_apply_rows(arr, idx, vals), 50),
        plain_ms=cuda_ms(lambda: solve_mod.delta_apply_rows_reference(arr, idx, vals), 20),
        library_ms=cuda_ms(lambda: arr.index_copy(0, idx64, vals), 50),
        device_ms=dev_ms, library_device_ms=lib_dev_ms, device_timing=how,
        device_per_call=dev_acts, library_device_per_call=lib_acts,
        bound=bound_ms(2 * nbytes([arr]) + nbytes([idx, vals]), vals.numel()),
        shape=f"{name} {tuple(arr.shape)} {arr.dtype}, {len(idx_np)} rows",
    )


def diverse_rows(torch_solver_cls, config_cls):
    """Phase 2's rows for the diverse mix's kernels (diverse_reference_mix(
    5,000) x 400 types, the batch phase 6 solves): B5, the class-batched
    scan, over the driver's class partition against
    pack_classed_reference (every output and every field of the final
    state), and B4 with contributor counting on the same inputs (the
    classed route off) against pack_reference. Tolerance: exact
    equality."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.solver.args import put, to_device_args
    from karpenter_tpu_torch.solver.driver import _CLASS_ARG_NAMES
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix

    pods = diverse_reference_mix(N_DIVERSE)
    solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES)
    groups, rest = enc.partition_and_group(pods, topology=solver.oracle.topology)
    if rest:
        raise SmokeFailure(f"diverse: {len(rest)} pods left the dense path")
    snap, avail, _, _, _ = solver._encode_batch(groups)
    G = enc._next_pow2(len(snap.groups), floor=8)
    run = snap.padded(G, 0)
    statics = solver._kernel_statics(snap, G)
    if not (statics["has_domains"] and statics["has_contrib"]):
        raise SmokeFailure(f"diverse: statics {statics}")
    partition = solver._classed_partition(run, avail[1])
    if partition is None:
        raise SmokeFailure("diverse: the driver does not route the batch to the classed scan")
    cls_host, lmax = partition
    cls = [put(n, x, "cuda") for n, x in zip(_CLASS_ARG_NAMES, cls_host)]
    a = dict(zip(enc.SOLVE_ARG_NAMES, to_device_args(run.solve_args(*avail), "cuda")))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    P, T = a["p_titype_ok"].shape
    K, V1 = a["g_mask"].shape[1:]
    R = a["t_alloc"].shape[1]
    b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    rows = {"fresh_feasibility_diverse": b1_row(a, zk, ck, "diverse-ref")}
    cap_ng = torch.zeros((0, G), dtype=torch.int32, device="cuda")
    pack_in = solve_mod.pack_args(a, *b1, cap_ng)
    st = dict(nmax=solver._select_nmax(snap, solver._fit_matrix(snap), None), zone_kid=zk,
              ct_kid=ck, wf_iters=statics["wf_iters"], has_domains=True, has_contrib=True)

    def b5():
        return packing_mod.pack_classed(*pack_in, *cls, lmax=lmax, **st)

    def b5_ref():
        return packing_mod.pack_classed_reference(*pack_in, *cls, lmax=lmax, **st)

    while True:  # the driver's overflow doubling
        out5 = b5()
        if not bool(out5[0].overflow.item()):
            break
        st["nmax"] *= 2
    ref5, ref5_ms = timed(b5_ref)
    out4 = packing_mod.pack(*pack_in, **st)
    ref4, ref4_ms = timed(lambda: packing_mod.pack_reference(*pack_in, **st))
    state, fills = list(out5[0]), list(out5[1:])
    ref_state, ref_fills = list(ref5[0]), list(ref5[1:])
    n_open = out5[0].n_open
    dyn = a["g_dmode"] > 0
    shape = (f"G={G} ({len(snap.groups)} real, {int(dyn.sum())} dynamic) "
             f"classes={int((cls_host[1] > 0).sum())} lmax={lmax} T={T} P={P} K={K} V1={V1} "
             f"JH={a['nh_cnt0'].shape[1]} JD={a['dd0'].shape[0]} NMAX={st['nmax']} "
             f"claims={int(n_open)} wf_iters={st['wf_iters']}")
    classes = (cls[0], cls[1], cls[2])
    return {
        **rows,
        "pack_classed": with_device(dict(
            max_abs_err=max_abs_err(state + fills, ref_state + ref_fills),
            ms=cuda_ms(b5, 5), plain_ms=ref5_ms,
            bound=bound_ms(nbytes(pack_in) + nbytes(cls) + nbytes(state + fills),
                           pack_ops(a["g_count"], fills[1], n_open, T, R, V1, dyn=dyn,
                                    P=P, classes=classes, offered=offered_words(a))),
            shape=shape,
        ), b5, 5),
        "pack_contrib": with_device(dict(
            max_abs_err=max_abs_err(out4, ref4),
            ms=cuda_ms(lambda: packing_mod.pack(*pack_in, **st), 3),
            plain_ms=ref4_ms,
            bound=bound_ms(nbytes(pack_in) + nbytes(out4),
                           pack_ops(a["g_count"], out4[5], out4[2], T, R, V1, dyn=dyn, P=P,
                                    offered=offered_words(a))),
            shape=shape + ", classed route off",
        ), lambda: packing_mod.pack(*pack_in, **st), 3),
    }


def floors_rows(torch_solver_cls, config_cls):
    """Phase 2's rows for the floors-and-ledger loop's kernel variants, at phase 8's
    cells: B4 with minValues floors (minvalues-50k: mixed_pods(50,000,
    gpu_fraction=0) x 400 over the minValues pool), B4 with the
    reservation ledger (reserved-50k: the same pods over the reserved
    catalog, NRES 16), B5 with floors (diverse-minvalues: the diverse mix
    over the minValues pool, classed) and B4[S] with floors (the
    consolidation chunk over the minValues pool), each against its plain
    version on the same CUDA tensors. Tolerance: exact equality."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.args import put
    from karpenter_tpu_torch.solver.driver import _CLASS_ARG_NAMES
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import minvalues_nodepool, reserved_catalog
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix, mixed_pods

    def scan_inputs(solver, pods):
        args, statics, nmax, _ = device_snapshot(solver, pods)
        a = dict(zip(SOLVE_ARG_NAMES, args))
        zk, ck = statics["zone_kid"], statics["ct_kid"]
        b1 = feas.fresh_claim_feasibility_sparse(*(a[n] for n in B1_NAMES), zone_kid=zk,
                                                 ct_kid=ck)
        cap_ng = torch.zeros((0, a["g_count"].shape[0]), dtype=torch.int32, device="cuda")
        st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
                  has_domains=statics["has_domains"], has_contrib=statics["has_contrib"])
        return a, solve_mod.pack_args(a, *b1, cap_ng), st

    def dims(a):
        return (a["p_titype_ok"].shape[0], a["t_alloc"].shape[0], a["t_alloc"].shape[1],
                a["g_mask"].shape[2], a["p_mvmin"].shape[1], a["res_cap0"].shape[0])

    def b4_row(solver, pods, label):
        a, pack_in, st = scan_inputs(solver, pods)
        while True:  # the driver's overflow doubling
            out = packing_mod.pack(*pack_in, **st)
            if not bool(out[3].item()):
                break
            st["nmax"] *= 2
        ref, ref_ms = timed(lambda: packing_mod.pack_reference(*pack_in, **st))
        P, T, R, V1, MV, NRES = dims(a)
        G = a["g_count"].shape[0]
        return with_device(dict(
            max_abs_err=max_abs_err(out, ref),
            ms=cuda_ms(lambda: packing_mod.pack(*pack_in, **st), 10),
            plain_ms=ref_ms,
            bound=bound_ms(nbytes(pack_in) + nbytes(out),
                           pack_ops(a["g_count"], out[5], out[2], T, R, V1, P=P, mv=MV,
                                    nres=NRES, offered=offered_words(a))),
            shape=(f"{label}: G={G} T={T} P={P} MV={MV} NRES={NRES} NMAX={st['nmax']} "
                   f"claims={int(out[2])} reserved={int(out[9].sum())}"),
        ), lambda: packing_mod.pack(*pack_in, **st), 10)

    rows = {}
    pods = mixed_pods(N_PODS, gpu_fraction=0.0)
    rows["pack_minvalues"] = b4_row(
        build_batch(torch_solver_cls, config_cls, pods, N_TYPES, pools=[minvalues_nodepool()]),
        pods, "minvalues-50k")
    rows["pack_resv"] = b4_row(
        build_batch(torch_solver_cls, config_cls, pods, N_TYPES,
                    its=reserved_catalog(N_TYPES, RESV_EVERY, RESV_CAP),
                    reserved_capacity_enabled=True),
        pods, "reserved-50k")

    # B5 with floors on the diverse mix over the minValues pool (classed)
    pods = diverse_reference_mix(N_DIVERSE)
    solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES,
                         pools=[minvalues_nodepool()], classed=True)
    host, snap, statics, _ = host_snapshot(solver, pods)
    from karpenter_tpu_torch.solver import encode as enc

    run = snap.padded(enc._next_pow2(len(snap.groups), floor=8), 0)
    partition = solver._classed_partition(run, host[SOLVE_ARG_NAMES.index("res_cap0")])
    if partition is None:
        raise SmokeFailure("diverse-minvalues: classed=True declined the class-batched scan")
    cls_host, lmax = partition
    cls = [put(n, x, "cuda") for n, x in zip(_CLASS_ARG_NAMES, cls_host)]
    a, pack_in, st = scan_inputs(solver, pods)

    def b5():
        return packing_mod.pack_classed(*pack_in, *cls, lmax=lmax, **st)

    while True:
        out5 = b5()
        if not bool(out5[0].overflow.item()):
            break
        st["nmax"] *= 2
    ref5, ref5_ms = timed(lambda: packing_mod.pack_classed_reference(
        *pack_in, *cls, lmax=lmax, **st))
    P, T, R, V1, MV, _ = dims(a)
    fills = list(out5[1:])
    rows["pack_classed_minvalues"] = with_device(dict(
        max_abs_err=max_abs_err(list(out5[0]) + fills, list(ref5[0]) + list(ref5[1:])),
        ms=cuda_ms(b5, 3),
        plain_ms=ref5_ms,
        bound=bound_ms(nbytes(pack_in) + nbytes(cls) + nbytes(list(out5[0]) + fills),
                       pack_ops(a["g_count"], fills[1], out5[0].n_open, T, R, V1,
                                dyn=a["g_dmode"] > 0, P=P, classes=tuple(cls[:3]), mv=MV,
                                offered=offered_words(a))),
        shape=(f"diverse-minvalues: G={a['g_count'].shape[0]} "
               f"classes={int((cls_host[1] > 0).sum())} lmax={lmax} T={T} MV={MV} "
               f"NMAX={st['nmax']} claims={int(out5[0].n_open)}"),
    ), b5, 3)
    # B4[S] with floors: the consolidation chunk over the minValues pool
    rows["scenarios_minvalues"] = scenario_row(build=minvalues_consolidation_env, with_b2=False)
    return rows


def tiled_ops(pack_ops_n, real_steps, P, T, K, V1, N, O, R):
    """The tiled mode's operations: the scan's own (``pack_ops_n``) plus
    the row build of each real step (each class head in B5) over bit
    words (W = ceil(V1 / 32) per key): each of the P x T cells intersects
    K x W words, tests O offerings and divides R requests; each template
    row's compatibility is K x W words; each of the N node cells K x W
    words and R divisions."""
    KW = K * ((V1 + 31) // 32)
    return pack_ops_n + real_steps * (P * T * (KW + O + R) + P * KW + N * (KW + R))


def tiled_rows(torch_solver_cls, config_cls):
    """Phase 2's rows for the tiled mode, forced at the ops level
    (tile_feasibility=True, zero-G placeholder tables): each kernel in the
    tiled mode against the untiled kernel on the same CUDA tensors and
    against its plain tiled version (pack_reference,
    pack_classed_reference, pack_scenarios_reference with
    tile_feasibility, on the card). Tolerance: exact equality.

    - pack_tiled (B4): on B2's snapshot (mixed 2,000 x 400 over 32
      StateNodes: the cap row), constrained 50k x 800 (domains),
      reserved-50k (the ledger) and the tenant shape cut in depth
      (N_DEPLOY_PLAIN Deployments over the 64 tenant pools x 800 types:
      the row build's P x T); the row's ms, plain ms and bound are the
      tenant shape's (phase 9 times the kernel at full depth);
    - pack_classed_tiled (B5): diverse-ref 5,000 x 400 (the row's
      numbers) and diverse-minvalues;
    - scenarios_tiled (B7's grid): the 2,000-node consolidation chunk,
      S=16 scenarios each with its own n_tol."""
    import torch

    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver import encode as enc
    from karpenter_tpu_torch.solver.args import put
    from karpenter_tpu_torch.solver.driver import _CLASS_ARG_NAMES
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import (
        example_state_nodes, minvalues_nodepool, reserved_catalog, tenant_pods, tenant_pools,
    )
    from karpenter_tpu_torch.solver.workloads import (
        constrained_mix, diverse_reference_mix, mixed_pods,
    )

    def inputs(solver, pods):
        """The scan's tiled and untiled inputs (B1, and B2 with nodes) and
        the statics of ``solver``'s batch."""
        args, statics, nmax, fills = device_snapshot(solver, pods)
        a = dict(zip(SOLVE_ARG_NAMES, args))
        zk, ck = statics["zone_kid"], statics["ct_kid"]
        st = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
                  has_domains=statics["has_domains"], has_contrib=statics["has_contrib"])
        untiled = solve_mod.pack_args(a, *solve_mod._feasibility_tables(a, zk, ck, True))
        tiled = solve_mod.pack_args(a, *solve_mod._feasibility_tables(
            a, zk, ck, tile_feasibility=True))
        return a, tiled, untiled, st, fills

    def dims(a):
        return (a["p_titype_ok"].shape[0], a["t_alloc"].shape[0], a["t_alloc"].shape[1],
                a["g_mask"].shape[1], a["g_mask"].shape[2], a["n_avail"].shape[0],
                a["o_avail"].shape[1])

    def b4_cell(label, solver, pods, reps):
        a, tiled, untiled, st, _ = inputs(solver, pods)
        while True:  # the driver's overflow doubling
            out = packing_mod.pack(*tiled, **st, tile_feasibility=True)
            if not bool(out[3].item()):
                break
            st["nmax"] *= 2
        ref, ref_ms = timed(lambda: packing_mod.pack_reference(
            *tiled, **st, tile_feasibility=True))
        err = max(max_abs_err(out, packing_mod.pack(*untiled, **st)), max_abs_err(out, ref))
        P, T, R, K, V1, N, O = dims(a)
        steps = int((a["g_count"] > 0).sum())
        ops = pack_ops(a["g_count"], out[5], out[2], T, R, V1,
                       dyn=(a["g_dmode"] > 0) if st["has_domains"] else None, P=P,
                       mv=a["p_mvmin"].shape[1], nres=a["res_cap0"].shape[0],
                       offered=offered_words(a))
        return with_device(dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: packing_mod.pack(*tiled, **st, tile_feasibility=True), reps),
            plain_ms=ref_ms,
            bound=bound_ms(nbytes(tiled) + nbytes(out),
                           tiled_ops(ops, steps, P, T, K, V1, N, O, R)),
            shape=(f"{label}: G={a['g_count'].shape[0]} ({steps} real) P={P} T={T} N={N} "
                   f"K={K} V1={V1} NMAX={st['nmax']} claims={int(out[2])}"),
        ), lambda: packing_mod.pack(*tiled, **st, tile_feasibility=True), reps)

    cells = {}
    pods = mixed_pods(NODE_PODS)
    cells["nodes"] = b4_cell("B2 snapshot", build_batch(
        torch_solver_cls, config_cls, pods, N_TYPES,
        state_nodes=example_state_nodes(N_NODES)), pods, 10)
    pods = constrained_mix(N_PODS)
    cells["constrained"] = b4_cell("constrained 50k", build_batch(
        torch_solver_cls, config_cls, pods, N_TYPES_C), pods, 3)
    pods = mixed_pods(N_PODS, gpu_fraction=0.0)
    cells["reserved"] = b4_cell("reserved-50k", build_batch(
        torch_solver_cls, config_cls, pods, N_TYPES,
        its=reserved_catalog(N_TYPES, RESV_EVERY, RESV_CAP),
        reserved_capacity_enabled=True), pods, 5)
    pods = tenant_pods(N_DEPLOY_PLAIN, N_TENANTS)
    cells["tenant"] = b4_cell(f"tenant {N_DEPLOY_PLAIN} Deployments", build_batch(
        torch_solver_cls, config_cls, pods, TENANT_TYPES,
        pools=tenant_pools(N_TENANTS)), pods, 3)
    rows = {"pack_tiled": dict(cells["tenant"], cells={
        k: dict(err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"], shape=c["shape"])
        for k, c in cells.items()})}
    rows["pack_tiled"]["max_abs_err"] = max(c["max_abs_err"] for c in cells.values())

    def b5_cell(label, pools, reps):
        pods = diverse_reference_mix(N_DIVERSE)
        solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES, pools=pools,
                             classed=True)
        host, snap, _, _ = host_snapshot(solver, pods)
        run = snap.padded(enc._next_pow2(len(snap.groups), floor=8), 0)
        partition = solver._classed_partition(run, host[SOLVE_ARG_NAMES.index("res_cap0")])
        if partition is None:
            raise SmokeFailure(f"{label}: classed=True declined the class-batched scan")
        cls_host, lmax = partition
        cls = [put(n, x, "cuda") for n, x in zip(_CLASS_ARG_NAMES, cls_host)]
        a, tiled, untiled, st, _ = inputs(solver, pods)

        def b5(args, tile):
            return packing_mod.pack_classed(*args, *cls, lmax=lmax, **st, tile_feasibility=tile)

        while True:
            out = b5(tiled, True)
            if not bool(out[0].overflow.item()):
                break
            st["nmax"] *= 2
        ref, ref_ms = timed(lambda: packing_mod.pack_classed_reference(
            *tiled, *cls, lmax=lmax, **st, tile_feasibility=True))
        un = b5(untiled, False)
        flat = list(out[0]) + list(out[1:])
        err = max(max_abs_err(flat, list(ref[0]) + list(ref[1:])),
                  max_abs_err(flat, list(un[0]) + list(un[1:])))
        P, T, R, K, V1, N, O = dims(a)
        heads = int((cls_host[1] > 0).sum())
        ops = pack_ops(a["g_count"], out[2], out[0].n_open, T, R, V1, dyn=a["g_dmode"] > 0,
                       P=P, classes=tuple(cls[:3]), mv=a["p_mvmin"].shape[1],
                       offered=offered_words(a))
        return with_device(dict(
            max_abs_err=err, ms=cuda_ms(lambda: b5(tiled, True), reps), plain_ms=ref_ms,
            bound=bound_ms(nbytes(tiled) + nbytes(cls) + nbytes(flat),
                           tiled_ops(ops, heads, P, T, K, V1, N, O, R)),
            shape=(f"{label}: G={a['g_count'].shape[0]} classes={heads} lmax={lmax} T={T} "
                   f"NMAX={st['nmax']} claims={int(out[0].n_open)}"),
        ), lambda: b5(tiled, True), reps)

    div = b5_cell("diverse-ref", None, 3)
    divmv = b5_cell("diverse-minvalues", [minvalues_nodepool()], 3)
    rows["pack_classed_tiled"] = dict(div, max_abs_err=max(div["max_abs_err"],
                                                           divmv["max_abs_err"]),
                                      cells={k: dict(err=c["max_abs_err"], ms=c["ms"],
                                                     plain_ms=c["plain_ms"], shape=c["shape"])
                                             for k, c in (("diverse", div),
                                                          ("diverse_minvalues", divmv))})

    # B7's grid tiled: the consolidation chunk, each scenario its own n_tol
    token = scenario_snapshot()
    args, statics, fills = token["args"], dict(token["statics"]), token["fills_dtype"]
    a = dict(zip(SOLVE_ARG_NAMES, args))
    zk, ck = statics["zone_kid"], statics["ct_kid"]
    kw = dict(fills_dtype=fills, batch_topo=token["batch_topo"])
    tiled_st = dict(statics, nmax=token["nmax"], tile_feasibility=True, sparse_groups=False)

    def dispatch(st):
        return solve_mod.solve_scenarios_core_packed(*args, **kw, **st)

    while bool(dispatch(tiled_st)[3].any().item()):  # the search's overflow doubling
        tiled_st["nmax"] *= 2
    st = dict(nmax=tiled_st["nmax"], zone_kid=zk, ct_kid=ck, wf_iters=statics["wf_iters"],
              has_domains=statics["has_domains"], has_contrib=statics["has_contrib"])
    tiled_in = solve_mod.pack_args(a, *solve_mod._feasibility_tables(
        a, zk, ck, tile_feasibility=True))

    def plain():
        return solve_mod.wire_pack_reference(packing_mod.pack_scenarios_reference(
            *tiled_in, **st, tile_feasibility=True), fills)

    full = dispatch(tiled_st)
    untiled = dispatch(dict(tiled_st, tile_feasibility=False, sparse_groups=True))
    ref, ref_ms = timed(plain)
    S, G = a["g_count"].shape
    N, R = a["n_avail"].shape
    P, T, K, V1 = a["p_def"].shape[0], a["t_alloc"].shape[0], a["g_mask"].shape[1], \
        a["g_mask"].shape[2]
    O = a["o_avail"].shape[1]
    scan = packing_mod.pack(*tiled_in, **st, tile_feasibility=True)
    steps = int((a["g_count"] > 0).sum())  # real steps over every scenario
    ops = tiled_ops(pack_ops(a["g_count"], scan[5], scan[2], T, R, V1, P=P,
                             offered=offered_words(a)), steps, P, T, K,
                    V1, N, O, R) + full[1].numel() * 8 + sum(x.numel() for x in full)
    rows["scenarios_tiled"] = with_device(dict(
        max_abs_err=max(max_abs_err(full, ref), max_abs_err(full, untiled)),
        ms=cuda_ms(lambda: dispatch(tiled_st), 20),
        plain_ms=ref_ms,
        bound=bound_ms(nbytes(tiled_in) + nbytes(full), ops),
        shape=f"S={S} N={N} G={G} T={T} NMAX={tiled_st['nmax']} claims={scan[2].tolist()}",
    ), lambda: dispatch(tiled_st), 20)
    return rows


def decisions(results, pods):
    """Claims in slot order, each with its options in their own order;
    existing-node placements and pod errors by name."""
    name = {p.uid: p.metadata.name for p in pods}
    claims = [
        (c.template.node_pool_name, tuple(sorted(p.metadata.name for p in c.pods)),
         tuple(it.name for it in c.instance_type_options))
        for c in results.new_node_claims
    ]
    existing = sorted((en.name, tuple(sorted(p.metadata.name for p in en.pods)))
                      for en in results.existing_nodes)
    return claims, existing, sorted(name[u] for u in results.pod_errors)


def phase_end_to_end(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 3: the main path through TorchSolver.solve, counted, and the
    ops dense route on the same nodes batch."""
    import torch

    from karpenter_tpu_torch import _build, obs
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.example import example_state_nodes
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    def dense_route():
        """ops/solve.py:dispatch_packed with sparse_groups=False on the
        2,000-pod batch over 32 nodes (B3's two entries in place of B1 and
        B2), counted, deciding as the sparse route's dispatch."""
        solver, pods = make("cuda", NODE_PODS, N_NODES)
        args, statics, nmax, fills = device_snapshot(solver, pods)
        kw = dict(statics, nmax=nmax, fills_dtype=fills)
        sparse = solve_mod.dispatch_packed(*args, **kw)
        _build.reset_launches()
        dense = solve_mod.dispatch_packed(*args, **dict(kw, sparse_groups=False))
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        missing = [k for k in PATH_KERNELS["dense_route"] if counts[k] < 1]
        extra = [k for k in PATH_ABSENT["dense_route"] if counts[k]]
        if missing or extra:
            raise SmokeFailure(f"dense_route: missing {missing}, launched {extra} ({counts})")
        if max_abs_err(dense, sparse) or not int(dense[4].sum()):
            raise SmokeFailure("dense_route: the dense tables' dispatch differs from the "
                               "sparse route's, or places nothing on a node")
        return counts

    def make(device, n_pods, n_nodes=0, cache=None):
        pods = mixed_pods(n_pods)
        nodes = example_state_nodes(n_nodes) if n_nodes else ()
        solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES,
                             state_nodes=nodes, device=device, cache=cache)
        return solver, pods

    def run(device, n_pods, n_nodes=0, cache=None):
        solver, pods = make(device, n_pods, n_nodes, cache)
        return solver.solve(pods), pods

    def counted(label, n_pods, n_nodes=0):
        """One path on the card, its launch counts zeroed just before and
        read just after; each kernel in PATH_KERNELS[label] must have run."""
        solver, pods = make("cuda", n_pods, n_nodes)
        _build.reset_launches()
        res = solver.solve(pods)
        counts = dict(_build.launches)
        missing = [k for k in PATH_KERNELS[label] if counts[k] < 1]
        if missing:
            raise SmokeFailure(f"{label} path never launched {missing} (counts {counts})")
        relax_pods[label] = solver.last_relax_pods
        dispatches[label] = solver.last_dispatches
        if solver.last_relax_pods:  # the JAX package routes none of these
            raise SmokeFailure(f"{label}: {solver.last_relax_pods} pods relax-routed")
        return res, pods, counts

    relax_pods, dispatches = {}, {}
    res_a, pods_a, launches_a = counted("50k", N_PODS)
    res_b, pods_b, launches_b = counted("nodes", NODE_PODS, N_NODES)
    launches = {"50k": launches_a, "nodes": launches_b, "dense_route": dense_route()}
    for res, pods, label in ((res_a, pods_a, "50k"), (res_b, pods_b, "nodes")):
        uids = {p.uid for p in pods}
        placed = sum(len(c.pods) for c in res.new_node_claims) + sum(
            sum(p.uid in uids for p in en.pods) for en in res.existing_nodes)
        if res.pod_errors or placed != len(pods):
            raise SmokeFailure(f"{label}: {len(res.pod_errors)} errors, "
                               f"{placed}/{len(pods)} placed")
    cpu_a = decisions(*run("cpu", N_PODS))
    cpu_b = decisions(*run("cpu", NODE_PODS, N_NODES))
    if decisions(res_a, pods_a) != cpu_a or decisions(res_b, pods_b) != cpu_b:
        raise SmokeFailure("CUDA decisions differ from the device='cpu' solve")

    cache = encode_cache_cls()
    run("cuda", N_PODS, cache=cache)  # warm the catalog encode
    times = []
    for _ in range(5):
        solver, pods = make("cuda", N_PODS, cache=cache)
        t0 = time.perf_counter()
        solver.solve(pods)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    solver, pods = make("cuda", N_PODS, cache=cache)
    tracer = obs.install(obs.Tracer(obs.PerfClock()))
    try:
        solver.solve(pods)
    finally:
        obs.uninstall()
    totals = tracer.phase_totals()
    phases = {k: totals.get(f"solve.{k}", 0.0) * 1e3
              for k in ("partition", "encode", "transfer", "dispatch", "guard",
                        "decode")}
    # the rest of the traced solve: oracle hand-off, claim truncation, audit
    phases["other"] = totals.get("solve", 0.0) * 1e3 - sum(phases.values())
    return dict(
        launches=launches,
        dispatches=dispatches,
        relax_pods=relax_pods,
        claims_50k=len(res_a.new_node_claims),
        claims_nodes=len(res_b.new_node_claims),
        solve_p50_ms=statistics.median(times),
        solve_ms=times,
        phase_ms=phases,
    )


def command_signature(cmd):
    """A consolidation Command by name: decision, disrupted candidates,
    each replacement's options and requirements."""
    return (
        cmd.decision,
        sorted(c.name for c in cmd.candidates),
        [[it.name for it in rep.instance_type_options] for rep in cmd.replacements],
        [repr(sorted(map(repr, rep.requirements))) for rep in cmd.replacements],
    )


def abandoned_prefetch(label, method, candidates, budgets):
    """1 when the single-node sweep ended with one chunk prefetched and
    never collected: it submits chunk n+1 while deciding chunk n, so a
    sweep that succeeds before reaching the next chunk leaves that launch
    behind, which is no dispatch of the search."""
    if label != "single":
        return 0
    from karpenter_tpu_torch.controllers.disruption.methods import _budget_filter

    swept = _budget_filter(method.sort_candidates(candidates), budgets)
    return int(len(swept) > method.last_probes)


def phase_consolidation():
    """Phase 4: both consolidation methods through compute_command on the
    card, each path counted on its own."""
    import torch

    from karpenter_tpu_torch import _build, obs
    from karpenter_tpu_torch.solver import workloads as wl

    out = {}
    for label, build in (("multi", wl.build_consolidation_env),
                         ("single", wl.build_single_consolidation_env)):
        ctx, method, candidates, budgets = build(CONS_NODES, "cpu")
        want = (command_signature(method.compute_command(candidates, budgets)),
                method.last_probes, method.last_dispatches)

        ctx, method, candidates, budgets = build(CONS_NODES, "cuda")
        _build.reset_launches()
        cmd = method.compute_command(candidates, budgets)
        torch.cuda.synchronize()
        counts, scen = dict(_build.launches), dict(_build.scenario_launches)
        got = (command_signature(cmd), method.last_probes, method.last_dispatches)
        solvers = [e["solver"] for e in ctx.scenario_envs._entries.values()]
        fallbacks = sum(sv.fallback_solves for sv in solvers)
        if not solvers or fallbacks:
            raise SmokeFailure(f"{label}: {fallbacks} sequential fallbacks "
                               f"({[sv.last_fallback_reasons for sv in solvers]})")
        prefetched = abandoned_prefetch(label, method, candidates, budgets)
        if not 1 <= scen["pack"] - prefetched == method.last_dispatches:
            raise SmokeFailure(f"{label}: {scen['pack']} scenario-batched pack launches "
                               f"for {method.last_dispatches} dispatches "
                               f"+ {prefetched} prefetch")
        if counts["pack"] != scen["pack"]:
            raise SmokeFailure(f"{label}: {counts['pack'] - scen['pack']} single-"
                               "scenario pack launches during the search")
        missing = [k for k in CONS_KERNELS if scen[k] < 1]
        if counts["fresh_feasibility"] < 1 or missing:
            raise SmokeFailure(f"{label} path never launched {missing} "
                               f"(counts {counts}, scenario {scen})")
        if got != want:
            raise SmokeFailure(f"{label}: the CUDA command {got[0][:2]} "
                               f"({got[1]} probes, {got[2]} dispatches) differs from "
                               f"the device='cpu' run's {want[0][:2]} ({want[1]}, {want[2]})")

        # p50 over 3 warm passes, each on a fresh env (the first pass warms)
        times = []
        for _ in range(4):
            ctx, method, candidates, budgets = build(CONS_NODES, "cuda")
            gc.collect()
            t0 = time.perf_counter()
            method.compute_command(candidates, budgets)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ctx, method, candidates, budgets = build(CONS_NODES, "cuda")
        tracer = obs.install(obs.Tracer(obs.PerfClock()))
        try:
            method.compute_command(candidates, budgets)
            torch.cuda.synchronize()
        finally:
            obs.uninstall()
        totals = tracer.phase_totals()
        phases = {k: totals.get(k, 0.0) * 1e3
                  for k in ("scenario.build", "solve.encode", "solve.transfer",
                            "kernel.dispatch", "solve.dispatch", "solve.guard",
                            "solve.decode")}
        # the rest of the traced decision: candidate walk, pricing, audit
        phases["other"] = totals.get(f"consolidate.{label}", 0.0) * 1e3 - sum(phases.values())
        out[label] = dict(
            decision=cmd.decision, disrupted=len(cmd.candidates),
            probes=method.last_probes, dispatches=got[2],
            launches=counts, scenario_launches=scen, prefetched=prefetched,
            p50_ms=statistics.median(times[1:]), ms=times[1:], phase_ms=phases,
        )
    return out


def phase_constrained(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 5: the constrained provisioning loop, cold and warm, on the
    card (BASELINE config[2]; bench.py's constrained-churn protocol)."""
    from karpenter_tpu_torch.solver.workloads import constrained_mix

    return provisioning_loop(torch_solver_cls, config_cls, encode_cache_cls, constrained_mix,
                             N_PODS, N_TYPES_C, "constrained", "ticks")


def phase_diverse(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 6: the reference's diverse 5-class mix, cold and warm, on the
    card (bench.py's diverse-ref batch and diverse-churn protocol), every
    solve through the class-batched scan (B5)."""
    from karpenter_tpu_torch.solver.workloads import diverse_reference_mix

    out = provisioning_loop(torch_solver_cls, config_cls, encode_cache_cls,
                            diverse_reference_mix, N_DIVERSE, N_TYPES, "diverse",
                            "diverse_ticks")
    if out["claims"] != DIVERSE_CLAIMS or out["errors"] or out["placed"] != N_DIVERSE:
        raise SmokeFailure(f"diverse: {out['claims']} claims, {out['placed']} placed, "
                           f"{out['errors']} errors (want {DIVERSE_CLAIMS}, {N_DIVERSE}, 0)")
    # the same batch through SolverConfig(classed=False): B4 with its
    # contributor counting, deciding as the classed route does
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver.example import example_nodepool

    pods = diverse_reference_mix(N_DIVERSE)
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(N_TYPES)}
    runs = {}
    for classed in (True, False):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        solver = torch_solver_cls(pools, its, topo, encode_cache=encode_cache_cls(),
                                  config=config_cls(device="cuda", classed=classed))
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solver.solve(pods)
        torch.cuda.synchronize()
        runs[classed] = (decisions(res, pods), dict(_build.launches),
                         (time.perf_counter() - t0) * 1e3)
    counts = runs[False][1]
    missing = [k for k in PATH_KERNELS["diverse_per_group"] if counts[k] < 1]
    extra = [k for k in PATH_ABSENT["diverse_per_group"] if counts[k]]
    if missing or extra:
        raise SmokeFailure(f"diverse_per_group path: missing {missing}, launched {extra} "
                           f"(counts {counts})")
    if runs[False][0] != runs[True][0]:
        raise SmokeFailure("diverse: the per-group scan (B4) decides otherwise than B5")
    out["launches"]["diverse_per_group"] = counts
    out["per_group_ms"], out["classed_ms"] = runs[False][2], runs[True][2]
    return out


def provisioning_loop(torch_solver_cls, config_cls, encode_cache_cls, mix, n_pods, n_types,
                      cold_label, tick_label):
    """A provisioning loop on the card over ``mix(n_pods)`` x ``n_types``
    types: a cold solve counted as ``cold_label`` with the decisions and
    placed/error counts of device="cpu"; cold p50 over 5 fresh
    EncodeCaches and one traced cold solve; two warm-ups and N_TICKS churn
    ticks (workloads.churn_tick) counted as ``tick_label``, each riding row
    deltas through B8 and equal to a full re-encode over the same vocab,
    plus one traced tick; an unchanged repeat hitting REUSE; no sequential
    fallback anywhere."""
    import random

    import torch

    from karpenter_tpu_torch import _build, obs
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver.example import example_nodepool
    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick

    # one catalog for the whole loop, as a provisioner holds it
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(n_types)}

    def solver_for(pods, cache, device="cuda"):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        return torch_solver_cls(pools, its, topo, config=config_cls(device=device),
                                encode_cache=cache)

    def counted(label, solver, pods):
        """One solve with the launch counts zeroed just before and read just
        after; each kernel of PATH_KERNELS[label] must have run, none of
        PATH_ABSENT[label], and B5 (on its paths) once per dispatch."""
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solver.solve(pods)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.launches)
        missing = [k for k in PATH_KERNELS[label] if counts[k] < 1]
        if missing:
            raise SmokeFailure(f"{label} path never launched {missing} (counts {counts})")
        extra = [k for k in PATH_ABSENT.get(label, ()) if counts[k]]
        if extra:
            raise SmokeFailure(f"{label} path launched {extra} (counts {counts})")
        if "pack_classed" in PATH_KERNELS[label] and counts["pack_classed"] != solver.last_dispatches:
            raise SmokeFailure(f"{label}: {counts['pack_classed']} B5 launches for "
                               f"{solver.last_dispatches} dispatches")
        if solver.fallback_solves:
            raise SmokeFailure(f"{label}: sequential fallbacks {solver.last_fallback_reasons}")
        relax_pods.append(solver.last_relax_pods)
        if solver.last_relax_pods:  # the JAX package routes none of these
            raise SmokeFailure(f"{label}: {solver.last_relax_pods} pods relax-routed")
        return res, counts, ms

    relax_pods = []

    def placed_errors(res, pods):
        uids = {p.uid for p in pods}
        placed = sum(sum(p.uid in uids for p in c.pods) for c in res.new_node_claims)
        return placed, len(res.pod_errors)

    def traced(solver, pods):
        tracer = obs.install(obs.Tracer(obs.PerfClock()))
        try:
            t0 = time.perf_counter()
            solver.solve(pods)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            obs.uninstall()
        totals = tracer.phase_totals()
        phases = {k: totals.get(f"solve.{k}", 0.0) * 1e3
                  for k in ("partition", "encode", "transfer", "dispatch", "guard",
                            "decode")}
        phases["other"] = totals.get("solve", 0.0) * 1e3 - sum(phases.values())
        # the wall time past the solve span: the audit record's claim
        # pricing, which runs only under tracing
        phases["audit"] = ms - totals.get("solve", 0.0) * 1e3
        return ms, phases

    pods = mix(n_pods)
    # cold, counted, against the plain versions on the CPU
    res, cold_counts, _ = counted(cold_label, solver_for(pods, encode_cache_cls()), pods)
    cpu = solver_for(pods, encode_cache_cls(), "cpu").solve(pods)
    if decisions(res, pods) != decisions(cpu, pods):
        raise SmokeFailure(f"{cold_label}: CUDA decisions differ from the device='cpu' solve")
    if placed_errors(res, pods) != placed_errors(cpu, pods):
        raise SmokeFailure(f"{cold_label}: placed/errors {placed_errors(res, pods)} vs cpu "
                           f"{placed_errors(cpu, pods)}")
    placed, errors = placed_errors(res, pods)
    claims = len(res.new_node_claims)
    # cold p50: every solve from a fresh EncodeCache (full encode, full staging)
    cold_ms = []
    for _ in range(5):
        solver = solver_for(pods, encode_cache_cls())
        gc.collect()
        t0 = time.perf_counter()
        solver.solve(pods)
        torch.cuda.synchronize()
        cold_ms.append((time.perf_counter() - t0) * 1e3)
    cold_traced_ms, cold_phases = traced(solver_for(pods, encode_cache_cls()), pods)

    # warm: two warm-ups (a-priori, then adaptive NMAX), then the churn ticks
    cache = encode_cache_cls()
    rng = random.Random(CHURN_SEED)
    solver_for(pods, cache).solve(pods)
    solver_for(pods, cache).solve(pods)
    ticks = []
    tick_counts = {}
    # N_TICKS timed ticks, then one traced tick for the span split (the
    # tracer waits on the staging and prices the claims for the audit, so
    # traced and untraced times do not compare)
    for i in range(N_TICKS + 1):
        pods = churn_tick(pods, mix, rng)
        s = solver_for(pods, cache)
        gc.collect()
        tracer = obs.install(obs.Tracer(obs.PerfClock())) if i == N_TICKS else None
        try:
            res, counts, ms = counted(tick_label, s, pods)
        finally:
            if tracer is not None:
                obs.uninstall()
        totals = tracer.phase_totals() if tracer is not None else {}
        store = cache.device_store
        full = not s.last_encode_reused and s.last_delta_rows == 0
        device_rows, full_puts = store.last_delta_rows, store.last_full_puts
        if full or device_rows < 1 or counts["apply_rows"] < 1:
            raise SmokeFailure(
                f"tick {len(ticks) + 1}: full re-encode {full}, device delta rows "
                f"{device_rows}, B8 launches {counts['apply_rows']}")
        # the same pods fully re-encoded and restaged over the same vocab:
        # the warm encoding's contract. A fresh EncodeCache interns the zone
        # values in another order and breaks ties elsewhere, in the JAX
        # package as here (tests/test_torch_residency.py pins the reference
        # doing so on this protocol)
        cache.cluster.invalidate("full re-encode check")
        store.reset()
        full_res = solver_for(pods, cache).solve(pods)
        if decisions(res, pods) != decisions(full_res, pods):
            raise SmokeFailure(f"tick {len(ticks) + 1}: decisions differ from a full re-encode")
        for k, v in counts.items():
            tick_counts[k] = tick_counts.get(k, 0) + v
        tick = dict(ms=ms, encode_delta_rows=s.last_delta_rows,
                    device_delta_rows=device_rows, full_puts=full_puts,
                    b8=counts["apply_rows"])
        if tracer is None:
            ticks.append(tick)
        else:
            traced_tick = dict(tick, phases={
                k: totals.get(f"solve.{k}", 0.0) * 1e3
                for k in ("partition", "encode", "transfer", "delta_apply", "dispatch",
                          "guard", "decode")})
            traced_tick["phases"]["other"] = (
                totals.get("solve", 0.0) * 1e3 - sum(traced_tick["phases"].values())
                + traced_tick["phases"]["delta_apply"])
            traced_tick["phases"]["audit"] = ms - totals.get("solve", 0.0) * 1e3
    # an unchanged repeat: REUSE, no transfer at all
    s = solver_for(pods, cache)
    s.solve(pods)
    store = cache.device_store
    if not s.last_encode_reused or store.last_full_puts or s.fallback_solves:
        raise SmokeFailure(f"repeat: reused {s.last_encode_reused}, full puts "
                           f"{store.last_full_puts}, fallbacks {s.fallback_solves}")
    return dict(
        claims=claims, placed=placed, errors=errors, relax_pods=sum(relax_pods),
        launches={cold_label: cold_counts, tick_label: tick_counts},
        cold_p50_ms=statistics.median(cold_ms), cold_ms=cold_ms,
        cold_traced_ms=cold_traced_ms, cold_phases=cold_phases,
        tick_p50_ms=statistics.median(t["ms"] for t in ticks), ticks=ticks,
        traced_tick=traced_tick,
    )


def zonal_partial_mix(n_zonal, n_solo):
    """The zonal partial mix (the shape of tests/test_relax.py's partial
    batch at scale): pod i of ``n_zonal`` requests (1 + i % 3) x 500m CPU
    and 1 GiB and selects zone test-zone-a/b/c[i % 3] (three zonal
    Deployments), beside ``n_solo`` zone-b pods of 700m with hostname
    anti-affinity on their own label (a one-per-node service)."""
    from karpenter_tpu_torch.api import labels
    from karpenter_tpu_torch.api import resources as res
    from karpenter_tpu_torch.api.objects import (
        LabelSelector,
        ObjectMeta,
        Pod,
        PodAffinityTerm,
        PodSpec,
    )

    zones = ("test-zone-a", "test-zone-b", "test-zone-c")
    own = {"app": "solo"}
    anti = [PodAffinityTerm(topology_key=labels.HOSTNAME,
                            label_selector=LabelSelector(match_labels=own))]

    def pod(name, cpu_m, zone, solo=False):
        return Pod(
            metadata=ObjectMeta(name=name, labels=dict(own) if solo else {}),
            spec=PodSpec(requests={res.CPU: cpu_m, res.MEMORY: 2**30 * res.MILLI},
                         node_selector={labels.TOPOLOGY_ZONE: zone},
                         pod_anti_affinity=list(anti) if solo else None),
        )

    return ([pod(f"zonal-{i}", (1 + i % 3) * 500, zones[i % 3]) for i in range(n_zonal)]
            + [pod(f"solo-{i}", 700, zones[1], solo=True) for i in range(n_solo)])


def slot_order(results):
    """The claims in slot order (pool, sorted pod names, type names), and
    the erroring pods' names: decode mints claim identities from it."""
    claims = [(c.template.node_pool_name, tuple(sorted(p.metadata.name for p in c.pods)),
               tuple(it.name for it in c.instance_type_options))
              for c in results.new_node_claims]
    return claims, sorted(results.pod_errors)


def phase_relax(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 7: the relax loop, TorchSolver's default route, on the card."""
    import random

    import torch

    from karpenter_tpu_torch import _build, faults, obs
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver.example import example_nodepool
    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick, identical_pods

    pools = [example_nodepool()]
    catalogs = {n: {pools[0].name: corpus.generate(n)} for n in (CONFIG0_TYPES, N_TYPES)}

    def solver_for(pods, n_types, cache=None, device="cuda", relax=None):
        its = catalogs[n_types]
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        return torch_solver_cls(pools, its, topo, encode_cache=cache or encode_cache_cls(),
                                config=config_cls(device=device, relax=relax))

    def counted(label, solver, pods, rejects=0):
        """One solve with the launch counts zeroed just before and read just
        after: PATH_KERNELS[label] all ran, B3's fresh entry and B9 once,
        B1/B4/B6 once per exact dispatch; ``rejects`` relax rejections."""
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solver.solve(pods)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.launches)
        missing = [k for k in PATH_KERNELS[label] if counts[k] < 1]
        per_dispatch = [k for k in ("fresh_feasibility", "pack", "wire_pack")
                        if counts[k] != solver.last_dispatches]
        if (missing or per_dispatch or counts["dense_fresh"] != 1 or counts["relax_fill"] != 1
                or counts["dense_existing"]):
            raise SmokeFailure(f"{label}: launches {counts} for {solver.last_dispatches} "
                               f"dispatches (missing {missing})")
        if solver.relax_rejects != rejects or solver.fallback_solves:
            raise SmokeFailure(f"{label}: {solver.relax_rejects} relax rejects, fallbacks "
                               f"{solver.last_fallback_reasons}")
        return res, counts, ms

    def against_cpu(label, res, pods, n_types, routed, claims):
        solver = solver_for(pods, n_types, device="cpu")
        cpu = slot_order(solver.solve(pods))
        got = slot_order(res)
        if got != cpu:
            raise SmokeFailure(f"{label}: the claims differ from the CPU run's in slot order")
        if solver.last_relax_pods != routed or len(got[0]) != claims or got[1]:
            raise SmokeFailure(f"{label}: {solver.last_relax_pods} routed, {len(got[0])} claims, "
                               f"{len(got[1])} errors (want {routed}, {claims}, 0)")

    out = {"launches": {}}
    # (a) BASELINE config[0]
    pods = identical_pods(CONFIG0_PODS)
    s = solver_for(pods, CONFIG0_TYPES)
    res, out["launches"]["config0"], out["config0_ms"] = counted("config0", s, pods)
    if s.last_relax_pods != CONFIG0_PODS or s.last_relax_claims != CONFIG0_CLAIMS:
        raise SmokeFailure(f"config0: {s.last_relax_pods} routed, {s.last_relax_claims} claims")
    against_cpu("config0", res, pods, CONFIG0_TYPES, CONFIG0_PODS, CONFIG0_CLAIMS)

    # (b) identical 50k x 400: cold, traced, then churn ticks
    pods = identical_pods(N_IDENT)
    s = solver_for(pods, N_TYPES)
    res, out["launches"]["ident"], _ = counted("ident", s, pods)
    if s.last_relax_pods != N_IDENT or s.last_relax_claims != IDENT_CLAIMS:
        raise SmokeFailure(f"ident: {s.last_relax_pods} routed, {s.last_relax_claims} claims")
    against_cpu("ident", res, pods, N_TYPES, N_IDENT, IDENT_CLAIMS)
    cold_ms = []
    for _ in range(5):
        s = solver_for(pods, N_TYPES)
        gc.collect()
        t0 = time.perf_counter()
        s.solve(pods)
        torch.cuda.synchronize()
        cold_ms.append((time.perf_counter() - t0) * 1e3)
    s = solver_for(pods, N_TYPES)
    tracer = obs.install(obs.Tracer(obs.PerfClock()))
    try:
        t0 = time.perf_counter()
        s.solve(pods)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        obs.uninstall()
    totals = tracer.phase_totals()
    phases = {k: totals.get(f"solve.{k}", 0.0) * 1e3
              for k in ("partition", "encode", "transfer", "dispatch", "relax", "guard",
                        "decode")}
    phases["other"] = totals.get("solve", 0.0) * 1e3 - sum(phases.values())
    phases["audit"] = traced_ms - totals.get("solve", 0.0) * 1e3
    out.update(ident_cold_ms=cold_ms, ident_traced_ms=traced_ms, ident_phases=phases)

    cache = encode_cache_cls()
    rng = random.Random(CHURN_SEED)
    solver_for(pods, N_TYPES, cache).solve(pods)
    solver_for(pods, N_TYPES, cache).solve(pods)
    ticks, tick_counts = [], {}
    for i in range(N_TICKS):
        pods = churn_tick(pods, identical_pods, rng)
        s = solver_for(pods, N_TYPES, cache)
        gc.collect()
        res, counts, ms = counted("ident_ticks", s, pods)
        store = cache.device_store
        if (s.last_relax_pods != N_IDENT or not s._last_incremental
                or (not s.last_encode_reused and s.last_delta_rows == 0)):
            raise SmokeFailure(f"tick {i + 1}: {s.last_relax_pods} routed, incremental "
                               f"{s._last_incremental}, reused {s.last_encode_reused}, delta rows "
                               f"{s.last_delta_rows}")
        tick = dict(ms=ms, reused=s.last_encode_reused, encode_delta_rows=s.last_delta_rows,
                    device_delta_rows=store.last_delta_rows, full_puts=store.last_full_puts)
        # the same pods fully re-encoded and restaged over the same vocab
        cache.cluster.invalidate("full re-encode check")
        store.reset()
        if slot_order(solver_for(pods, N_TYPES, cache).solve(pods)) != slot_order(res):
            raise SmokeFailure(f"tick {i + 1}: the claims differ from a full re-encode's")
        for k, v in counts.items():
            tick_counts[k] = tick_counts.get(k, 0) + v
        ticks.append(tick)
    s = solver_for(pods, N_TYPES, cache)
    s.solve(pods)
    if not s.last_encode_reused or cache.device_store.last_full_puts or s.last_relax_pods != N_IDENT:
        raise SmokeFailure(f"repeat: reused {s.last_encode_reused}, full puts "
                           f"{cache.device_store.last_full_puts}, routed {s.last_relax_pods}")
    out["launches"]["ident_ticks"] = tick_counts
    out["ticks"] = ticks

    # (c) the zonal partial mix: two easy runs routed, the rest exact
    pods = zonal_partial_mix(N_ZONAL, N_SOLO)
    s = solver_for(pods, N_TYPES)
    res, out["launches"]["zonal"], out["zonal_ms"] = counted("zonal", s, pods)
    if s.last_relax_pods != ZONAL_ROUTED or s.last_relax_claims != ZONAL_BULK_CLAIMS:
        raise SmokeFailure(f"zonal: {s.last_relax_pods} routed, {s.last_relax_claims} bulk claims")
    zonal = slot_order(res)
    n_claims = len(zonal[0])
    against_cpu("zonal", res, pods, N_TYPES, ZONAL_ROUTED, n_claims)
    off = slot_order(solver_for(pods, N_TYPES, relax=False).solve(pods))
    if sorted(zonal[0]) != sorted(off[0]) or zonal[1] != off[1]:
        raise SmokeFailure("zonal: relax on and off decide differently")
    out.update(zonal_claims=n_claims, zonal_exact_claims=n_claims - ZONAL_BULK_CLAIMS,
               zonal_order_differs=zonal != off)

    # (d) a corrupt bulk sheds to the full exact dispatch
    def zero_fills(bulk):
        n_r, r_pool, r_tmask, r_fills, r_unplaced = bulk
        return (n_r, r_pool, r_tmask, r_fills * 0, r_unplaced)

    inj = faults.install(faults.FaultInjector(
        [faults.FaultRule(faults.RELAX_OUTPUT, mutate=zero_fills)]))
    try:
        s = solver_for(pods, N_TYPES)
        res, out["launches"]["zonal_reject"], _ = counted("zonal_reject", s, pods, rejects=1)
    finally:
        faults.uninstall()
    if inj.fired(faults.RELAX_OUTPUT) != 1 or s.last_relax_pods or slot_order(res) != off:
        raise SmokeFailure(f"zonal_reject: fired {inj.fired(faults.RELAX_OUTPUT)}, routed "
                           f"{s.last_relax_pods}, decisions == relax off {slot_order(res) == off}")
    return out


def phase_floors(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 8: the floors-and-ledger loop on the card, NodePools with minValues floors
    and offerings with capacity reservations, every solve counted: each
    cell's cold solve == the device="cpu" solve in slot order (and in the
    reservations each claim holds), no relax routing and no sequential
    fallback, cold p50 over 5 solves from fresh EncodeCaches; then
    MultiNodeConsolidation over the minValues pool at 2,000 nodes."""
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.solver.example import (
        example_nodepool, minvalues_nodepool, reserved_catalog,
    )
    from karpenter_tpu_torch.solver.workloads import (
        constrained_mix, diverse_reference_mix, mixed_pods,
    )

    def held(res):
        return [sorted(o.reservation_id() for o in c.reserved_offerings)
                for c in res.new_node_claims]

    def cell(label, pods, pools, catalog, reps=5, classed=None, cpu_pods=None, **solver_kw):
        """One cell: ``catalog()`` builds a fresh instance-type list per
        solver (reservation capacities are per catalog). With ``cpu_pods``
        the comparison with device="cpu" runs on that smaller batch (a
        card solve and a CPU solve of it); the counted and timed card
        solves stay on ``pods``."""
        def solver_for(device, batch=pods):
            return build_batch(torch_solver_cls, config_cls, batch, 0, device=device,
                               cache=encode_cache_cls(), pools=pools(), its=catalog(),
                               classed=classed, **solver_kw)

        s = solver_for("cuda")
        _build.reset_launches()
        t0 = time.perf_counter()
        res = s.solve(pods)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.launches)
        missing = [k for k in PATH_KERNELS[label] if counts[k] < 1]
        extra = [k for k in PATH_ABSENT.get(label, ()) if counts[k]]
        if missing or extra:
            raise SmokeFailure(f"{label}: missing {missing}, launched {extra} ({counts})")
        if s.fallback_solves or s.last_relax_pods:
            raise SmokeFailure(f"{label}: fallbacks {s.last_fallback_reasons}, "
                               f"{s.last_relax_pods} pods relax-routed")
        batch, card = pods, res
        if cpu_pods is not None:
            batch = cpu_pods
            card = solver_for("cuda", batch).solve(batch)
        cpu = solver_for("cpu", batch).solve(batch)
        if decisions(card, batch) != decisions(cpu, batch) or held(card) != held(cpu):
            raise SmokeFailure(f"{label}: CUDA decisions differ from the device='cpu' solve "
                               f"in slot order ({len(batch)} pods)")
        times = []
        for _ in range(reps):
            s = solver_for("cuda")
            gc.collect()
            t0 = time.perf_counter()
            s.solve(pods)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return dict(claims=len(res.new_node_claims), errors=len(res.pod_errors),
                    reserved=sum(1 for h in held(res) if h), launches=counts,
                    first_ms=first_ms, cold_ms=times,
                    p50_ms=statistics.median(times) if times else first_ms)

    def plain(n):
        return lambda: corpus.generate(n)

    mv_pools, default_pools = (lambda: [minvalues_nodepool()]), (lambda: [example_nodepool()])
    out = {}
    pods = mixed_pods(N_PODS, gpu_fraction=0.0)
    out["minvalues"] = cell("minvalues", pods, mv_pools, plain(N_TYPES))
    out["reserved"] = cell("reserved", pods, default_pools,
                           lambda: reserved_catalog(N_TYPES, RESV_EVERY, RESV_CAP),
                           reserved_capacity_enabled=True)
    r = out["reserved"]
    if not 1 <= r["reserved"] <= RESV_MAX_CLAIMS:
        raise SmokeFailure(f"reserved: {r['reserved']} claims hold reservations "
                           f"(want 1..{RESV_MAX_CLAIMS})")
    out["constrained_minvalues"] = cell("constrained_minvalues", constrained_mix(N_PODS),
                                        mv_pools, plain(N_TYPES_C))
    pods = diverse_reference_mix(N_DIVERSE)
    # the diverse cells' CPU comparisons at N_DIVERSE_CPU pods: the CPU's
    # plain scans of the 5,000-pod batch took most of this phase
    small = diverse_reference_mix(N_DIVERSE_CPU)
    out["diverse_minvalues"] = cell("diverse_minvalues", pods, mv_pools, plain(N_TYPES),
                                    classed=True, cpu_pods=small)
    # the auto route sends floors with domain-dynamic groups to B4 (with
    # its contributor counting); B4-contrib is ~1.5 s a solve: one solve
    out["diverse_minvalues_auto"] = cell("diverse_minvalues_auto", pods, mv_pools,
                                         plain(N_TYPES), reps=0, cpu_pods=small)

    # MultiNodeConsolidation over the minValues pool: B7 with floors
    ctx, method, candidates, budgets = minvalues_consolidation_env(CONS_NODES, "cpu")
    want = (command_signature(method.compute_command(candidates, budgets)),
            method.last_probes, method.last_dispatches)
    ctx, method, candidates, budgets = minvalues_consolidation_env(CONS_NODES, "cuda")
    _build.reset_launches()
    cmd = method.compute_command(candidates, budgets)
    torch.cuda.synchronize()
    counts, scen = dict(_build.launches), dict(_build.scenario_launches)
    got = (command_signature(cmd), method.last_probes, method.last_dispatches)
    solvers = [e["solver"] for e in ctx.scenario_envs._entries.values()]
    if not solvers or sum(sv.fallback_solves for sv in solvers):
        raise SmokeFailure("cons_minvalues: sequential fallbacks "
                           f"{[sv.last_fallback_reasons for sv in solvers]}")
    if not all(sv.oracle.templates[0].requirements.has_min_values() for sv in solvers):
        raise SmokeFailure("cons_minvalues: the scenario solvers lost the minValues floor")
    missing = [k for k in CONS_MV_KERNELS if scen[k] < 1]
    if missing or counts["pack"] != scen["pack"] or scen["pack"] != method.last_dispatches:
        raise SmokeFailure(f"cons_minvalues: missing {missing}, {scen['pack']} scenario packs "
                           f"of {counts['pack']} for {method.last_dispatches} dispatches")
    if got != want:
        raise SmokeFailure(f"cons_minvalues: the CUDA command {got[0][:2]} ({got[1]} probes, "
                           f"{got[2]} dispatches) differs from the device='cpu' run's "
                           f"{want[0][:2]} ({want[1]}, {want[2]})")
    # p50 over 3 warm passes, each on a fresh env, as phase 4's
    times = []
    for _ in range(4):
        ctx, method, candidates, budgets = minvalues_consolidation_env(CONS_NODES, "cuda")
        gc.collect()
        t0 = time.perf_counter()
        method.compute_command(candidates, budgets)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["cons_minvalues"] = dict(decision=cmd.decision, disrupted=len(cmd.candidates),
                                 probes=got[1], dispatches=got[2],
                                 p50_ms=statistics.median(times[1:]), ms=times[1:],
                                 launches=counts, scenario_launches=scen)
    return out


def tenant_tick(pods, k, rng):
    """Churn tick ``k`` of the tenant cell: TENANT_SWAP Deployments, drawn
    by ``rng``, scale away and as many new ones (tenant_pods numbered on
    from the last, seeded per tick) arrive."""
    from karpenter_tpu_torch.solver.example import tenant_pods

    apps = sorted({p.metadata.labels["app"] for p in pods}, key=lambda a: int(a[1:]))
    gone = set(rng.sample(apps, TENANT_SWAP))
    new = tenant_pods(TENANT_SWAP, N_TENANTS, seed=17 + k,
                      first=N_DEPLOY + TENANT_SWAP * (k - 1))
    return [p for p in pods if p.metadata.labels["app"] not in gone] + new


def record_statics(solver, untiled=False):
    """Wrap ``solver._kernel_statics`` so each dispatch's statics and table
    bytes (P * G * T * 5) are recorded; with ``untiled`` the wrapper also
    turns the tiled mode off (tables through B1, the untiled scan), as a
    yardstick for the driver's own choice."""
    seen = []
    own = solver._kernel_statics

    def statics(snap, G):
        st = own(snap, G)
        seen.append((dict(st), len(snap.templates) * G * len(snap.instance_types) * 5))
        if untiled:
            st = dict(st, tile_feasibility=False, sparse_groups=True)
        return st

    solver._kernel_statics = statics
    return seen


def phase_tenant(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 9: the tenant cell on the card, every solve counted. 64
    tainted NodePools capped at 4,000 CPUs over 800 types and 6,000
    VPA-sized Deployments (50,816 pods): the driver's gate picks the tiled
    mode by itself. (a) a cold TorchSolver.solve: B4 tiled, no table
    kernel, no relax routing, no fallback; cold p50 over 3 fresh
    EncodeCaches and one traced solve; (b)
    the same device args through dispatch_packed tiled and untiled (B1
    and the untiled B4): the ten outputs identical, and the solve's
    Results equal to those of a solve forced onto the untiled dispatch,
    claims in slot order; (c) two churn ticks of 60 Deployments, each on
    row deltas through B8 and equal to a same-vocab re-encode, then a
    REUSE repeat; (d) the classed route forced (B5 tiled), deciding as
    (a); (e) a scenario batch (B7's grid tiled: the cell, and the cell
    without one tick's Deployments), each scenario equal to a solve of
    its pods, claims in slot order."""
    import random

    import torch

    from karpenter_tpu_torch import _build, obs
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.scheduling.topology import Topology
    from karpenter_tpu_torch.solver.driver import Scenario
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import tenant_pods, tenant_pools

    pools = tenant_pools(N_TENANTS)
    catalog = corpus.generate(TENANT_TYPES)
    its = {p.name: list(catalog) for p in pools}

    def solver_for(pods, cache=None, classed=None):
        topo = Topology(Client(TestClock()), [], pools, its, pods)
        return torch_solver_cls(pools, its, topo, encode_cache=cache or encode_cache_cls(),
                                config=config_cls(device="cuda", classed=classed))

    def counted(label, solver, pods, scenarios=None):
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solver.solve_scenarios(scenarios) if scenarios else solver.solve(pods)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.launches)
        missing = [k for k in PATH_KERNELS[label] if counts[k] < 1]
        extra = [k for k in PATH_ABSENT.get(label, ()) if counts[k]]
        if missing or extra:
            raise SmokeFailure(f"{label}: missing {missing}, launched {extra} ({counts})")
        if solver.fallback_solves or solver.last_relax_pods:
            raise SmokeFailure(f"{label}: fallbacks {solver.last_fallback_reasons}, "
                               f"{solver.last_relax_pods} pods relax-routed")
        return res, counts, ms

    out = {"launches": {}}
    pods = tenant_pods(N_DEPLOY, N_TENANTS)
    if len(pods) != TENANT_PODS:
        raise SmokeFailure(f"tenant: {len(pods)} pods, want {TENANT_PODS}")

    # (a) cold, the driver's own choice of mode
    s = solver_for(pods)
    seen = record_statics(s)
    res, counts, first_ms = counted("tenant", s, pods)
    st, table_bytes = seen[-1]
    if not (st["tile_feasibility"] and not st["sparse_groups"]
            and table_bytes == TENANT_BYTES > TILE_GATE):
        raise SmokeFailure(f"tenant: statics {st}, tables {table_bytes} B (gate {TILE_GATE} B)")
    out["launches"]["tenant"] = counts
    uids = {p.uid for p in pods}
    out.update(statics=st, table_bytes=table_bytes, first_ms=first_ms,
               claims=len(res.new_node_claims), errors=len(res.pod_errors),
               placed=sum(sum(p.uid in uids for p in c.pods) for c in res.new_node_claims),
               relax_pods=s.last_relax_pods, dispatches=s.last_dispatches)
    cold = []
    for _ in range(3):
        sv = solver_for(pods)
        gc.collect()
        t0 = time.perf_counter()
        sv.solve(pods)
        torch.cuda.synchronize()
        cold.append((time.perf_counter() - t0) * 1e3)
    out["cold_ms"], out["cold_p50_ms"] = cold, statistics.median(cold)
    tracer = obs.install(obs.Tracer(obs.PerfClock()))
    try:
        t0 = time.perf_counter()
        solver_for(pods).solve(pods)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        obs.uninstall()
    totals = tracer.phase_totals()
    phases = {k: totals.get(f"solve.{k}", 0.0) * 1e3
              for k in ("partition", "encode", "transfer", "dispatch", "guard", "decode")}
    phases["other"] = totals.get("solve", 0.0) * 1e3 - sum(phases.values())
    phases["audit"] = traced_ms - totals.get("solve", 0.0) * 1e3
    out["traced_ms"], out["phases"] = traced_ms, phases

    # (b) the same device args, tiled and untiled; the untiled solve's Results
    args, dst, nmax, fills = device_snapshot(solver_for(pods), pods)
    kw = dict(dst, nmax=nmax, fills_dtype=fills)
    tiled = solve_mod.dispatch_packed(*args, **kw)
    torch.cuda.synchronize()
    untiled, untiled_ms = timed(lambda: solve_mod.dispatch_packed(
        *args, **dict(kw, tile_feasibility=False, sparse_groups=True)))
    tiled_again, tiled_ms = timed(lambda: solve_mod.dispatch_packed(*args, **kw))
    out["dispatch_err"] = max(max_abs_err(tiled, untiled), max_abs_err(tiled, tiled_again))
    if out["dispatch_err"]:
        raise SmokeFailure(f"tenant: tiled and untiled dispatches differ "
                           f"(max |diff| {out['dispatch_err']})")
    out["dispatch_ms"] = dict(tiled=tiled_ms, untiled=untiled_ms)
    del tiled, untiled, tiled_again
    # the two scans alone on the same inputs: the tiled scan's time, and
    # its excess over the untiled one (the row build, by difference)
    a = dict(zip(SOLVE_ARG_NAMES, args))
    zk, ck = dst["zone_kid"], dst["ct_kid"]
    pst = dict(nmax=nmax, zone_kid=zk, ct_kid=ck, wf_iters=dst["wf_iters"],
               has_domains=dst["has_domains"], has_contrib=dst["has_contrib"])
    tin = solve_mod.pack_args(a, *solve_mod._feasibility_tables(a, zk, ck, tile_feasibility=True))
    uin = solve_mod.pack_args(a, *solve_mod._feasibility_tables(a, zk, ck, True))
    scan_t, out["scan_tiled_ms"] = timed(lambda: packing_mod.pack(*tin, **pst,
                                                                  tile_feasibility=True))
    scan_u, out["scan_untiled_ms"] = timed(lambda: packing_mod.pack(*uin, **pst))
    if max_abs_err(scan_t, scan_u):
        raise SmokeFailure("tenant: the tiled scan's outputs differ from the untiled scan's")
    out["scan_shape"] = (f"G={a['g_count'].shape[0]} ({int((a['g_count'] > 0).sum())} real) "
                         f"P={a['p_def'].shape[0]} T={a['t_alloc'].shape[0]} NMAX={nmax} "
                         f"claims={int(scan_t[2])}")
    del scan_t, scan_u, uin, args, a
    gc.collect()
    torch.cuda.empty_cache()
    su = solver_for(pods)
    seen_u = record_statics(su, untiled=True)
    _build.reset_launches()
    res_u = su.solve(pods)
    torch.cuda.synchronize()
    if not (seen_u and _build.launches["fresh_feasibility"] and not _build.launches["pack_tiled"]):
        raise SmokeFailure(f"tenant: the untiled yardstick did not run untiled ({_build.launches})")
    if decisions(res, pods) != decisions(res_u, pods):
        raise SmokeFailure("tenant: the tiled solve decides otherwise than the untiled one")
    del res_u, su
    gc.collect()
    torch.cuda.empty_cache()

    # B8 at the largest row delta of (c)'s first tick, on a cache of its own
    bcache = encode_cache_cls()
    host_a = host_snapshot(solver_for(pods, bcache), pods)[0]
    first = tenant_tick(pods, 1, random.Random(TENANT_TICK_SEED))
    out["b8_inputs"] = largest_delta(host_a,
                                     *host_snapshot(solver_for(first, bcache), first)[::3])
    out["b8_tick"] = b8_row(out["b8_inputs"])
    if out["b8_tick"]["max_abs_err"]:
        raise SmokeFailure(f"tenant tick: B8 differs from its plain version "
                           f"({out['b8_tick']['max_abs_err']})")
    del bcache, host_a, first
    gc.collect()

    # (c) churn ticks on one EncodeCache: row deltas, == a same-vocab
    # re-encode; then REUSE
    cache = encode_cache_cls()
    solver_for(pods, cache).solve(pods)
    solver_for(pods, cache).solve(pods)
    rng = random.Random(TENANT_TICK_SEED)
    ticks, tick_counts, tick_pods = [], {}, pods
    for k in range(1, TENANT_TICKS + 1):
        tick_pods = tenant_tick(tick_pods, k, rng)
        sv = solver_for(tick_pods, cache)
        gc.collect()
        tres, tcounts, tms = counted("tenant_ticks", sv, tick_pods)
        store = cache.device_store
        full = not sv.last_encode_reused and sv.last_delta_rows == 0
        if full or store.last_delta_rows < 1 or tcounts["apply_rows"] < 1:
            raise SmokeFailure(f"tenant tick {k}: full re-encode {full}, device delta rows "
                               f"{store.last_delta_rows}, B8 {tcounts['apply_rows']}")
        ticks.append(dict(ms=tms, encode_delta_rows=sv.last_delta_rows,
                          device_delta_rows=store.last_delta_rows,
                          full_puts=store.last_full_puts, b8=tcounts["apply_rows"]))
        cache.cluster.invalidate("full re-encode check")
        store.reset()
        if decisions(tres, tick_pods) != decisions(
                solver_for(tick_pods, cache).solve(tick_pods), tick_pods):
            raise SmokeFailure(f"tenant tick {k}: decisions differ from a same-vocab re-encode")
        for key, v in tcounts.items():
            tick_counts[key] = tick_counts.get(key, 0) + v
    sv = solver_for(tick_pods, cache)
    sv.solve(tick_pods)
    if not sv.last_encode_reused or cache.device_store.last_full_puts or sv.fallback_solves:
        raise SmokeFailure(f"tenant repeat: reused {sv.last_encode_reused}, full puts "
                           f"{cache.device_store.last_full_puts}")
    out["ticks"], out["launches"]["tenant_ticks"] = ticks, tick_counts

    # (d) the classed route forced: B5 tiled
    packing_mod.classed_clusters.clear()
    res_c, counts_c, out["classed_ms"] = counted("tenant_classed", solver_for(pods, classed=True),
                                                 pods)
    out["classed_cluster"] = packing_mod.classed_clusters["pack_classed"]
    if decisions(res_c, pods) != decisions(res, pods):
        raise SmokeFailure("tenant: the class-batched scan (B5 tiled) decides otherwise than B4")
    out["launches"]["tenant_classed"] = counts_c
    del res_c

    # (e) a scenario batch: the cell, and the cell without the first
    # tick's removed Deployments; B7's grid tiled
    apps = {p.metadata.labels["app"] for p in tick_pods}
    less = [p for p in pods if p.metadata.labels["app"] in apps]
    sv = solver_for(pods)
    seen_s = record_statics(sv)
    results, counts_s, out["scenarios_ms"] = counted(
        "tenant_scenarios", sv, pods, scenarios=[Scenario(pods=pods), Scenario(pods=less)])
    if not results or _build.scenario_launches["pack_tiled"] < 1 or not seen_s[-1][0][
            "tile_feasibility"]:
        raise SmokeFailure(f"tenant scenarios: {_build.scenario_launches}")
    # the batch encodes the union of its scenarios' pods (here the cell's
    # own), and a scenario's groups keep their order in it, so each
    # scenario mints the claims of a solve of its pods, in slot order
    want = [decisions(res, pods), decisions(solver_for(less).solve(less), less)]
    if [decisions(r, ps) for r, ps in zip(results, (pods, less))] != want:
        raise SmokeFailure("tenant scenarios: a scenario decides otherwise than a solve of "
                           "its pods (claims in slot order)")
    out["launches"]["tenant_scenarios"] = counts_s
    out["scenario_launches"] = dict(_build.scenario_launches)
    out["scenario_pods"] = [len(pods), len(less)]
    return out


def phase_ladder(torch_solver_cls, config_cls, device="cuda"):
    """Phase 11: the degradation ladder on the card, the one phase that
    passes ``SolverConfig.health`` (a ``SolverHealth`` on an injected clock,
    the breaker tripping at the first failure). On mixed 2,000 x 400:
    (a) a SOLVER_DISPATCH fault: the Results equal a force_oracle run's,
    audit rung "oracle", the breaker open; (b) the next solve while it is
    open stays on the oracle rung; (c) past the cool-down the solve is on
    the kernel rung again and equals the plain health=None card solve in
    slot order; (d) a SOLVER_OUTPUT corruption (claim fills negative, the
    exact route pinned by relax=False) is quarantined by the guard before
    decode: the Results are the oracle's, never the corrupt ones; (e)
    backend="native" equals the card's exact-route Results in slot order.
    On the consolidation env at 200 nodes: (f) a SOLVER_SCENARIOS fault
    declines the batch: the search replays per probe and its command
    equals the batched search's, the batched rung down, the kernel rung
    up; (g) without a ladder the same fault raises. A fault of the card
    itself, not injected, propagates with the ladder set and leaves it
    untouched: (h) a launch error of the solve, (i) a guard rejection of
    the card's outputs, (j) a launch error of the search's batch. Launch
    counts: the recovered solve (c) and the batched search (f), each
    from 0."""
    import contextlib

    import torch

    from karpenter_tpu_torch import _build, faults, obs
    from karpenter_tpu_torch.faults.breaker import SolverHealth
    from karpenter_tpu_torch.kube import TestClock
    from karpenter_tpu_torch.solver import workloads as wl

    cuda = device == "cuda"
    pods = wl.mixed_pods(LADDER_PODS)

    def solve(**config_kw):
        results = build_batch(torch_solver_cls, config_cls, pods, N_TYPES, device=device,
                              config_kw=config_kw).solve(pods)
        if cuda:
            torch.cuda.synchronize()
        rec = obs.AUDIT.last()
        return slot_order(results), (rec.rung, rec.guard.split(":")[0])

    def fault(site, **rule):
        faults.install(faults.FaultInjector([faults.FaultRule(site, **rule)]))

    def state(h):
        return dict(kernel=h.allow_kernel(), batched=h.allow_batched(),
                    quarantines=h.quarantines, level=h.level())

    def check(label, ok, detail):
        if not ok:
            raise SmokeFailure(f"ladder ({label}): {detail}")

    @contextlib.contextmanager
    def card_fault(kind):
        """A fault of the card's own, with no injector installed:
        "launch", each launch check raising after its kernel ran (the
        context stays sound), or "guard", the invariant guard rejecting
        the card's outputs."""
        from karpenter_tpu_torch.faults.guard import SolverIntegrityError

        real_launched, real_verify = _build.launched, torch_solver_cls._verify_solution

        def launched(name, rc, *a, **k):
            real_launched(name, rc, *a, **k)
            raise _build.KernelLaunchError(f"{name}: launch error (not injected)")

        def verify(self, *a, **k):
            raise SolverIntegrityError(["claim fills negative (not injected)"])

        if kind == "launch":
            _build.launched = launched
        else:
            torch_solver_cls._verify_solution = verify
        try:
            yield
        finally:
            _build.launched, torch_solver_cls._verify_solution = real_launched, real_verify

    def propagates(kind, run):
        """The exception type ``run(health)`` raised under a card fault of
        ``kind``, and the ladder's state afterwards."""
        health = SolverHealth(TestClock(), failure_threshold=1, cooldown=LADDER_COOLDOWN)
        raised = None
        with card_fault(kind):
            try:
                run(health)
            except RuntimeError as exc:
                raised = type(exc).__name__
        return raised, state(health)

    untouched = dict(kernel=True, batched=True, quarantines=0, level=0)

    out = {}
    t0 = time.perf_counter()
    plain, _ = solve()
    oracle, rung = solve(force_oracle=True)
    check("oracle reference", rung[0] == "oracle" and not oracle[1], f"{rung}, errors {oracle[1]}")
    clock = TestClock()
    health = SolverHealth(clock, failure_threshold=1, cooldown=LADDER_COOLDOWN)
    fault(faults.SOLVER_DISPATCH)
    try:
        got, rung = solve(health=health)
    finally:
        faults.uninstall()
    check("a", got == oracle and rung == ("oracle", "ok") and not health.allow_kernel(),
          f"{rung}, == force_oracle {got == oracle}, health {state(health)}")
    out["dispatch_fault"] = dict(rung=rung[0], health=state(health))
    got, rung = solve(health=health)
    check("b", got == oracle and rung == ("oracle", "ok"), f"{rung} while the breaker is open")
    clock.step(LADDER_COOLDOWN)
    _build.reset_launches()
    got, rung = solve(health=health)
    out["launches"] = {"ladder": dict(_build.launches)}
    check("c", got == plain and rung == ("kernel", "ok") and health.level() == 0,
          f"{rung}, == plain card solve {got == plain}, health {state(health)}")
    out["recovered"] = dict(rung=rung[0], health=state(health), claims=len(got[0]))
    exact, _ = solve(relax=False)
    health_q = SolverHealth(TestClock(), cooldown=LADDER_COOLDOWN)

    def corrupt(outs):
        outs = list(outs)
        outs[5] = outs[5] - 7  # claim fills negative
        return tuple(outs)

    fault(faults.SOLVER_OUTPUT, mutate=corrupt)
    try:
        got, rung = solve(health=health_q, relax=False)
    finally:
        faults.uninstall()
    check("d", got == oracle and rung == ("oracle", "quarantined")
          and health_q.quarantines == 1 and not health_q.allow_kernel(),
          f"{rung}, == force_oracle {got == oracle}, health {state(health_q)}")
    out["corrupt_output"] = dict(rung=rung[0], guard=rung[1], health=state(health_q))
    native, rung = solve(backend="native")
    check("e", native == exact and rung == ("kernel", "ok"),
          f"{rung}, == the card's exact route {native == exact}")
    out["native_claims"] = len(native[0])
    # a fault of the card's own exists only on the card
    card = {}
    for label, kind, want in (("h", "launch", "KernelLaunchError"),
                              ("i", "guard", "SolverIntegrityError")) if cuda else ():
        raised, after = propagates(kind, lambda h: solve(health=h, relax=False))
        check(label, raised == want and after == untouched,
              f"a {kind} fault of the card gave {raised}, health {after}")
        card[kind] = raised
    out["solves_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()

    def search(health=None):
        ctx, method, candidates, budgets = wl.build_consolidation_env(LADDER_NODES, device)
        ctx.solver_config = config_cls(device=device, health=health)
        cmd = method.compute_command(candidates, budgets)
        if cuda:
            torch.cuda.synchronize()
        return command_signature(cmd), method.last_probes, method.last_dispatches

    health_b = SolverHealth(TestClock(), failure_threshold=1, cooldown=LADDER_COOLDOWN)
    _build.reset_launches()
    batched = search(health_b)
    out["launches"]["ladder_scenarios"] = dict(_build.launches)
    out["scenario_launches"] = dict(_build.scenario_launches)
    check("f batched", batched[2] >= 1 and state(health_b)["level"] == 0,
          f"{batched[2]} dispatches, health {state(health_b)}")
    health_s = SolverHealth(TestClock(), failure_threshold=1, cooldown=LADDER_COOLDOWN)
    fault(faults.SOLVER_SCENARIOS)
    try:
        per_probe = search(health_s)
        raised = None
        try:
            search()
        except faults.InjectedFault as exc:
            raised = type(exc).__name__
    finally:
        faults.uninstall()
    check("f", per_probe[0] == batched[0] and not health_s.allow_batched()
          and health_s.allow_kernel(),
          f"command == batched {per_probe[0] == batched[0]}, health {state(health_s)}")
    check("g", raised == "InjectedFault", f"without a ladder the fault gave {raised}")
    if cuda:
        raised, after = propagates("launch", search)
        check("j", raised == "KernelLaunchError" and after == untouched,
              f"a launch fault of the card's batch gave {raised}, health {after}")
        card["search_launch"] = raised
    out["card_faults"] = card
    out["scenarios"] = dict(decision=batched[0][0], disrupted=len(batched[0][1]),
                            probes=batched[1], dispatches=batched[2],
                            per_probe=per_probe[1], per_probe_dispatches=per_probe[2],
                            health=state(health_s))
    out["search_s"] = time.perf_counter() - t0
    if cuda:
        for path, need in (("ladder", PATH_KERNELS["ladder"]),
                           ("ladder_scenarios", CONS_KERNELS)):
            missing = [k for k in need if out["launches"][path][k] < 1]
            check(path, not missing, f"never launched {missing}")
    return out


def wide_cpu_worker(label, conn):
    """A child process's work: the device="cpu" decisions of the wide input
    ``label``, sent on ``conn``."""
    from karpenter_tpu_torch.solver.driver import EncodeCache, SolverConfig, TorchSolver

    _, pools, catalog, pods = [w for w in wide_inputs() if w[0] == label][0]
    s = build_batch(TorchSolver, SolverConfig, pods, 0, device="cpu", cache=EncodeCache(),
                    pools=pools(), its=catalog())
    conn.send(decisions(s.solve(pods), pods))
    conn.close()


def start_wide_cpu(label):
    """Start the device="cpu" solve of wide input ``label`` in a child
    process (spawned: the parent holds the card); returns the process and
    the end of the pipe its decisions arrive on."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=wide_cpu_worker, args=(label, send), daemon=True)
    proc.start()
    send.close()
    return proc, recv


def phase_wide(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 10: the wide value vocabularies (ROADMAP §C1) on the card,
    every solve counted: a per-team label with 1,100 teams over Exists
    (1,100 pods, K 16, V1 2048), its In list with 40 pods, minValues 2 on
    the instance type over 1,100 types (mixed_pods(2000), MW 2048), and a
    pool listing 600 of 800 types at mixed 50k (V1 1024). Each cold card
    solve returns Results (no raise, no fallback) equal in slot order to
    the device="cpu" solve of the same input: the per-team input's in a
    child process beside the phase's card solves (its relax plan is a
    minute of host work in either process), the listed pool's at
    WIDE_CPU_PODS pods (the CPU's plain scans of the 50k batch take
    minutes). Then, with the child gone, the listed pool's p50 over 5
    solves on a warm catalog cache, as phase 3 times mixed 50k, and one
    traced solve's span split. Reports each input's K, V1, MW and the
    layout each kernel took: B1's mode, tiles and shared memory
    (feasibility.fresh_layout), B3's where relax ran (dense_layout), the
    scans' shared memory and spill scratch (packing.layouts)."""
    out, inputs = {}, {}
    proc, recv = start_wide_cpu("team_exists")
    try:
        for label, pools, catalog, pods in wide_inputs():
            def solver_for(device, batch=pods, cache=None, pools=pools, catalog=catalog):
                return build_batch(torch_solver_cls, config_cls, batch, 0, device=device,
                                   cache=cache or encode_cache_cls(), pools=pools(),
                                   its=catalog())

            inputs[label] = (solver_for, pods)
            out[label] = wide_card_solve(label, solver_for, pods)
        if not recv.poll(WIDE_CPU_WAIT_S):
            raise SmokeFailure(f"wide team_exists: no device='cpu' decisions in "
                               f"{WIDE_CPU_WAIT_S} s")
        try:
            cpu_dec = recv.recv()
        except EOFError:
            raise SmokeFailure(f"wide team_exists: the device='cpu' solve failed (exit code "
                               f"{proc.exitcode})") from None
        if out["team_exists"].pop("card_decisions") != cpu_dec:
            raise SmokeFailure("wide team_exists: CUDA decisions differ from the device='cpu' "
                               "solve in slot order")
    finally:
        if proc.is_alive():
            proc.terminate()
        proc.join(30)
    out["listed_types"].update(wide_timings(*inputs["listed_types"], encode_cache_cls))
    return out


def wide_card_solve(label, solver_for, pods):
    """One wide input's counted cold card solve, its layouts and, but for
    the per-team input (whose CPU run is the child's), its comparison with
    device="cpu"; returns phase 10's row for it."""
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packing as packing_mod
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    s = solver_for("cuda")
    snaps = []  # each dispatch's snapshot and bucketed G
    own = s._kernel_statics
    s._kernel_statics = lambda snap, G: (snaps.append((snap, G)), own(snap, G))[1]
    packing_mod.layouts.clear()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = s.solve(pods)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(_build.launches)
    if counts["fresh_feasibility"] < 1 or counts["pack"] + counts["pack_classed"] < 1:
        raise SmokeFailure(f"wide {label}: the dispatch did not run B1 and a scan ({counts})")
    if s.fallback_solves:
        raise SmokeFailure(f"wide {label}: fallbacks {s.last_fallback_reasons}")
    snap, G = snaps[-1]
    K, V1 = snap.vocab.padded_shape()
    MW = snap.t_mvoh.shape[-1] if snap.p_mvmin.any() else 0  # the floors' catalog width
    P, T = len(snap.templates), len(snap.instance_types)
    R, O = snap.g_req.shape[1], snap.o_avail.shape[1]
    L = snap.padded(G, 0).gk_g.shape[0]  # the live-pair index's length
    lay = dict(b1=feas.fresh_layout(P, G, T, K, V1, R, O, L),
               scans={k[0]: dict(smem=v[0], spill=v[1]) for k, v in packing_mod.layouts.items()})
    if counts["dense_fresh"]:
        lay["b3"] = feas.dense_layout(1, -1, 1, T, K, V1, R, O)
    row = dict(K=K, V1=V1, MW=MW, G=G, T=T, claims=len(res.new_node_claims),
               errors=len(res.pod_errors), relax_pods=s.last_relax_pods, first_ms=first_ms,
               cpu_pods=len(pods), layout=lay, launches=counts)
    if label == "team_exists":
        row["card_decisions"] = decisions(res, pods)
        return row
    batch, card = pods, res
    if label == "listed_types":
        batch = mixed_pods(WIDE_CPU_PODS)
        card = solver_for("cuda", batch).solve(batch)
        row["cpu_pods"] = WIDE_CPU_PODS
    if decisions(card, batch) != decisions(solver_for("cpu", batch).solve(batch), batch):
        raise SmokeFailure(f"wide {label}: CUDA decisions differ from the device='cpu' solve "
                           f"in slot order ({len(batch)} pods)")
    return row


def wide_timings(solver_for, pods, encode_cache_cls):
    """The listed pool's solve at 50k: p50 over 5 solves on a warm catalog
    cache (as phase 3 times mixed 50k) and one traced solve's span split."""
    import torch

    from karpenter_tpu_torch import obs

    cache = encode_cache_cls()
    solver_for("cuda", cache=cache).solve(pods)  # warm the catalog encode
    times = []
    for _ in range(5):
        s = solver_for("cuda", cache=cache)
        gc.collect()
        t0 = time.perf_counter()
        s.solve(pods)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    s = solver_for("cuda", cache=cache)
    tracer = obs.install(obs.Tracer(obs.PerfClock()))
    try:
        s.solve(pods)
    finally:
        obs.uninstall()
    totals = tracer.phase_totals()
    spans = {k: totals.get(f"solve.{k}", 0.0) * 1e3
             for k in ("partition", "encode", "transfer", "dispatch", "guard", "decode")}
    spans["other"] = totals.get("solve", 0.0) * 1e3 - sum(spans.values())
    return dict(ms=times, p50_ms=statistics.median(times), spans=spans)


def tenant_pods(wl, i, n):
    """Tenant ``i``'s pods: ``mixed_pods(n, seed=i)`` renamed
    ``t<i>-mixed-<j>`` (uid the same), so no pod is shared between
    tenants (the union solve declines on a shared uid)."""
    pods = wl.mixed_pods(n, seed=i)
    for j, p in enumerate(pods):
        p.metadata.name = p.metadata.uid = f"t{i}-mixed-{j}"
    return pods


def capturing(remote):
    """``remote`` (a RemoteSolver) keeping the raw response bytes of each
    answered call in ``remote.responses``."""
    call = remote._solve
    remote.responses = []

    def solve(request, **kw):
        raw = call(request, **kw)
        remote.responses.append(raw)
        return raw

    remote._solve = solve
    return remote


def response_content(raw):
    """A solve response's decisions: claims in slot order (pool, type
    names in order, pod uids as a set, requirements), existing-node
    placements and pod errors. A union solve orders the pods inside a
    claim by the union's order (the tenants' arrival order), which the
    bytes carry and the decision does not."""
    from karpenter_tpu_torch.solver import wire

    got = wire.decode_solve_response(raw)
    return ([(c["pool"], tuple(c["instance_types"]), tuple(sorted(c["pod_uids"])),
              repr(sorted(map(repr, c["requirements"])))) for c in got["claims"]],
            sorted((e["name"], tuple(sorted(e["pod_uids"]))) for e in got["existing"]),
            sorted(got["pod_errors"].items()), got["state_nodes_packed"])


def diff_responses(got, want):
    """The first difference of two solve responses, for the log."""
    from karpenter_tpu_torch.solver import wire

    got, want = wire.decode_solve_response(got), wire.decode_solve_response(want)
    for key in ("claims", "existing", "pod_errors", "state_nodes_packed"):
        if got[key] != want[key]:
            if key == "claims":
                for i, (a, b) in enumerate(zip(got[key], want[key])):
                    if a != b:
                        return f"claim {i}: {a} != {b}"
                return f"{len(got[key])} claims != {len(want[key])}"
            return f"{key}: {got[key]} != {want[key]}"
    return "none"


def phase_sidecar(device="cuda"):
    """Phase 12: the port's solver sidecar, ``serve("127.0.0.1:0",
    max_workers=4)`` for the solo lane and with ``batch_window=
    SIDECAR_WINDOW`` for the batch lane (where every batchable solve, a
    lone one too, rides the union solve), solving on the card (its
    default SolverConfig), reached through the port's ``RemoteSolver``. (a)
    The solo lane: tenant t0 sends mixed 3,000 x 400, a request under
    gRPC's 4 MiB receive limit; the response bytes equal the encoded
    in-process solve on the card and the device="cpu" solve's. (b) The
    batch lane: four tenants of 750 pods each send at once (their
    dispatches released together by a barrier); the batcher forms one
    batch (1 batched, 0 declined) and the union solver makes one scenario
    dispatch (B1, the pack.cu grid over 4 scenarios, B6 over them; no B2:
    no state nodes); each tenant's decisions (claims in slot order, their
    pods, options in order; the union orders the pods inside a claim by
    arrival) equal its own solo solve on the card and the device="cpu"
    union's. (c) The error contract, on an
    injected clock: a tenant past its token bucket gets SolverBackpressure
    with no in-process solve; a solve past its tenant's deadline gets
    DEADLINE_EXCEEDED and the client solves in process on the card
    (fallback_solves 1, equal to the sidecar's answer); a launch error
    that was not injected, raised in the batch lane as phase 11 raises
    its own, reaches all four callers as INTERNAL, and no participant is
    solved solo. Launch counts: the solo lane, the batch lane and the
    in-process fallback, each from 0. Returns the running solo-lane
    sidecar for phase 13 beside the results."""
    import threading

    import torch

    from karpenter_tpu_torch import _build, faults
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.kube import TestClock
    from karpenter_tpu_torch.solver import wire
    from karpenter_tpu_torch.solver import workloads as wl
    from karpenter_tpu_torch.solver.driver import SolverConfig
    from karpenter_tpu_torch.solver.example import example_nodepool
    from karpenter_tpu_torch.solver.service import (
        RemoteSolver,
        SolverBackpressure,
        TenantService,
        serve,
    )
    from karpenter_tpu_torch.solver.tenancy import TenantQoS, TenantRegistry

    cuda = device == "cuda"
    pools = [example_nodepool()]
    its = {pools[0].name: corpus.generate(N_TYPES)}
    options = {"reserved_capacity_enabled": False}

    def check(label, ok, detail):
        if not ok:
            raise SmokeFailure(f"sidecar ({label}): {detail}")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def remote(target, tenant, config=None):
        return capturing(RemoteSolver(target, pools, its, tenant=tenant,
                                      config=config or SolverConfig(device=device)))

    def encoded(tenant, pods, **service_kw):
        """The response bytes of ``pods`` solved in process by a fresh
        TenantService."""
        svc = TenantService(**service_kw)
        snap = wire.decode_solve_request(wire.encode_solve_request(
            pods, pools, its, solver_options=options, volume_objects=[]))
        out = svc.solve_encoded(tenant, snap)
        sync()
        return out

    def at_once(target, reqs, config=None):
        """Each tenant's RemoteSolver solve from its own thread, the
        dispatches released together: {tenant: (Results or the exception,
        response bytes)}."""
        barrier = threading.Barrier(len(reqs))
        out = {}

        def run(tid, pods):
            r = remote(target, tid, config)
            dispatch = r._dispatch

            def together(request):
                barrier.wait()
                return dispatch(request)

            r._dispatch = together
            try:
                out[tid] = (r.solve(pods), r.responses)
            except Exception as exc:
                out[tid] = (exc, r.responses)
            finally:
                r.close()

        threads = [threading.Thread(target=run, args=item) for item in reqs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        sync()
        return out

    out = {"launches": {}, "scenario_launches": {}}
    config = None if cuda else SolverConfig(device=device)  # None: the card
    solo_server = serve("127.0.0.1:0", max_workers=SIDECAR_WORKERS, config=config)
    out["server"] = solo_server
    server = serve("127.0.0.1:0", max_workers=SIDECAR_WORKERS, batch_window=SIDECAR_WINDOW,
                   config=config)
    svc = server._tenant_service
    svc.batcher.max_batch = SIDECAR_TENANTS
    target = f"127.0.0.1:{server._bound_port}"
    arrivals = []
    batcher_solve = svc.batcher.solve

    def arrive(*a, **k):
        arrivals.append(time.perf_counter())
        return batcher_solve(*a, **k)

    svc.batcher.solve = arrive

    # (a) the solo lane
    pods = wl.mixed_pods(SIDECAR_PODS)
    request = wire.encode_solve_request(pods, pools, its, solver_options=options,
                                        volume_objects=[])
    check("a size", len(request) < GRPC_RECEIVE_LIMIT,
          f"{len(request)} B of request, past {GRPC_RECEIVE_LIMIT}")
    out["request_bytes"] = len(request)
    t0 = remote(f"127.0.0.1:{solo_server._bound_port}", "t0")
    _build.reset_launches()
    w0 = time.perf_counter()
    got = t0.solve(pods)
    sync()
    out["solo_ms"] = (time.perf_counter() - w0) * 1e3
    out["launches"]["sidecar_solo"] = dict(_build.launches)
    t0.close()
    w0 = time.perf_counter()
    in_process = encoded("t0", pods, config=SolverConfig(device=device))
    out["in_process_ms"] = (time.perf_counter() - w0) * 1e3
    on_cpu = encoded("t0", pods, config=SolverConfig(device="cpu"))
    check("a", t0.responses == [in_process] and in_process == on_cpu
          and t0.fallback_solves == 0 and not got.pod_errors,
          f"hop == in process {t0.responses == [in_process]}, == cpu {in_process == on_cpu}, "
          f"fallbacks {t0.fallback_solves}, errors {len(got.pod_errors)}")
    out["response_bytes"] = len(in_process)
    out["solo_claims"] = len(got.new_node_claims)

    # (b) the batch lane
    reqs = {f"t{i}": tenant_pods(wl, i, SIDECAR_TENANT_PODS)
            for i in range(1, SIDECAR_TENANTS + 1)}
    arrivals.clear()
    _build.reset_launches()
    w0 = time.perf_counter()
    got = at_once(target, reqs)
    out["batch_ms"] = (time.perf_counter() - w0) * 1e3
    out["launches"]["sidecar_batch"] = dict(_build.launches)
    out["scenario_launches"]["sidecar_batch"] = dict(_build.scenario_launches)
    out["arrival_spread_ms"] = (max(arrivals) - min(arrivals)) * 1e3
    counts = svc.batcher.counts()
    check("b batch", counts == {"batched": 1, "declined": 0}
          and (not cuda or out["scenario_launches"]["sidecar_batch"]["pack"] == 1
               and out["launches"]["sidecar_batch"]["pack"] == 1),
          f"batcher {counts}, launches {out['launches']['sidecar_batch']}, arrivals spread "
          f"{out['arrival_spread_ms']:.1f} ms")
    cpu_union = {}

    def cpu_solve(tid, svc_cpu):
        snap = wire.decode_solve_request(wire.encode_solve_request(
            reqs[tid], pools, its, solver_options=options, volume_objects=[]))
        cpu_union[tid] = svc_cpu.solve_encoded(tid, snap)

    svc_cpu = TenantService(config=SolverConfig(device="cpu"), batch_window=60.0,
                            batch_max=SIDECAR_TENANTS)
    threads = [threading.Thread(target=cpu_solve, args=(tid, svc_cpu)) for tid in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check("b cpu union", svc_cpu.batcher.counts() == {"batched": 1, "declined": 0},
          f"the CPU batcher {svc_cpu.batcher.counts()}")
    claims = {}
    for tid, tpods in reqs.items():
        res, raw = got[tid]
        solo = encoded(tid, tpods, config=SolverConfig(device=device))
        hop = response_content(raw[0]) if len(raw) == 1 else None
        check(f"b {tid}", not isinstance(res, Exception) and hop == response_content(solo)
              and hop == response_content(cpu_union[tid]),
              f"{res!r}" if isinstance(res, Exception) else
              f"hop == solo {hop == response_content(solo)}, == cpu union "
              f"{hop == response_content(cpu_union[tid])}"
              + (f": {diff_responses(raw[0], solo)}" if len(raw) == 1 else ""))
        claims[tid] = len(res.new_node_claims)
    out["batch_claims"] = claims

    # (c) the error contract
    clock = TestClock()
    greedy_server = serve("127.0.0.1:0", config=config, registry=TenantRegistry(clock=clock, qos={
                              "standard": TenantQoS(rate=0.0, burst=1.0)}))
    small = wl.mixed_pods(SIDECAR_SMALL_PODS, seed=21)
    try:
        greedy = remote(f"127.0.0.1:{greedy_server._bound_port}", "greedy")
        first = greedy.solve(small)
        raised = None
        try:
            greedy.solve(small)
        except SolverBackpressure as exc:
            raised = type(exc).__name__
        greedy.close()
    finally:
        greedy_server.stop(0)
    check("c backpressure", raised == "SolverBackpressure" and greedy.fallback_solves == 0
          and len(greedy.responses) == 1 and not first.pod_errors,
          f"raised {raised}, fallbacks {greedy.fallback_solves}")
    out["backpressure"] = raised

    faults.install(faults.FaultInjector(
        [faults.FaultRule(faults.TENANT_SOLVE, latency=10.0,
                          match=lambda ctx: ctx.get("tenant") == "slow")], clock=clock))
    slow_server = serve("127.0.0.1:0", config=config, registry=TenantRegistry(clock=clock, qos={
                            "standard": TenantQoS(solve_deadline=1.0)}))
    try:
        slow = remote(f"127.0.0.1:{slow_server._bound_port}", "slow")
        _build.reset_launches()
        fell_back = slow.solve(small)
        sync()
        out["launches"]["sidecar_fallback"] = dict(_build.launches)
        slow.close()
        overruns = slow_server._tenant_service.registry.get("slow").stats()["deadline_overruns"]
    finally:
        slow_server.stop(0)
        faults.uninstall()
    want = encoded("slow", small, config=SolverConfig(device=device))
    got_bytes = wire.encode_solve_response(fell_back)
    check("c deadline", slow.fallback_solves == 1 and overruns == 2 and got_bytes == want,
          f"fallbacks {slow.fallback_solves}, overruns {overruns}, == the in-process solve "
          f"{got_bytes == want}")
    out["deadline"] = dict(fallback_solves=slow.fallback_solves, overruns=overruns)

    card = {}
    if cuda:
        real_launched = _build.launched
        solo_lane = []
        solve_solo = svc._solve_solo

        def launched(name, rc, *a, **k):
            real_launched(name, rc, *a, **k)
            raise _build.KernelLaunchError(f"{name}: launch error (not injected)")

        def solo_spy(tenant, snap):
            solo_lane.append(tenant.tenant_id)
            return solve_solo(tenant, snap)

        svc._solve_solo = solo_spy
        _build.launched = launched
        try:
            failed = at_once(target, reqs)
        finally:
            _build.launched = real_launched
            svc._solve_solo = solve_solo
        codes = {}
        for tid, (res, raw) in failed.items():
            code = getattr(res, "code", None)
            codes[tid] = code().name if callable(code) else type(res).__name__
        check("c launch", set(codes.values()) == {"INTERNAL"} and len(codes) == SIDECAR_TENANTS
              and not solo_lane and svc.batcher.counts() == counts
              and all("KernelLaunchError" in res.details() for res, _ in failed.values()),
              f"codes {codes}, solo solves {solo_lane}, batcher {svc.batcher.counts()}")
        card = codes
    server.stop(0)
    out["card_fault"] = card
    if cuda:
        need = {"sidecar_solo": PATH_KERNELS["sidecar_solo"],
                "sidecar_batch": PATH_KERNELS["sidecar_batch"],
                "sidecar_fallback": PATH_KERNELS["sidecar_fallback"]}
        for path, kernels in need.items():
            missing = [k for k in kernels if out["launches"][path][k] < 1]
            check(path, not missing, f"never launched {missing}")
    return out


def operator_claims(pods, n_types, steps, device="cuda", solver_address=""):
    """The port's Operator over the kwok provider with a TestClock, one
    NodePool over ``n_types`` types and ``pods`` pending, stepped (binding
    what landed) until no pod is pending or ``steps`` steps have run.
    Returns each NodeClaim it created as (pool, instance-type options in
    order, pod uids), the steps and the pods left pending."""
    import copy

    import torch

    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.kube import Client, TestClock
    from karpenter_tpu_torch.operator import Operator, OperatorOptions
    from karpenter_tpu_torch.sim import Binder
    from karpenter_tpu_torch.solver.driver import SolverConfig
    from karpenter_tpu_torch.solver.example import example_nodepool

    clock = TestClock()
    client = Client(clock)
    provider = KwokCloudProvider(client, corpus.generate(n_types))
    op = Operator(client, provider, OperatorOptions(
        solver_config=SolverConfig(device=device), solver_address=solver_address))
    created = []
    create = op.provisioner.create_node_claims

    def record(results):
        claims = create(results)
        created.extend(
            (c.template.node_pool_name, tuple(it.name for it in c.instance_type_options),
             tuple(sorted(p.uid for p in c.pods)))
            for c in results.new_node_claims)
        return claims

    op.provisioner.create_node_claims = record
    binder = Binder(client)
    client.create(example_nodepool())
    for p in copy.deepcopy(pods):
        client.create(p)
    pending = []
    for step in range(1, steps + 1):
        op.step(force_provision=True)
        binder.bind_all()
        clock.step(1)
        pending = [p.uid for p in client.list(Pod) if not p.spec.node_name]
        if not pending:
            break
    if device == "cuda":
        torch.cuda.synchronize()
    op.shutdown()
    return created, step, len(pending)


def phase_operator(sidecar, device="cuda"):
    """Phase 13: the port's Operator over kwok (a Client on a TestClock,
    corpus.generate(400), one NodePool, mixed_pods(2,000) pending), stepped
    with force_provision until no pod is pending or 5 steps have run: on
    the card in process, counted; the same with SolverConfig(device="cpu");
    and on the card with ``solver_address`` at phase 12's sidecar,
    counted. The NodeClaims created must be the same in the three, by
    pool, instance-type options in order and pod uids."""
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.solver import workloads as wl

    pods = wl.mixed_pods(OPERATOR_PODS)
    target = f"127.0.0.1:{sidecar._bound_port}"
    out = {"launches": {}}
    runs = {}
    for label, kw in (("operator", dict(device=device)), ("cpu", dict(device="cpu")),
                      ("operator_remote", dict(device=device, solver_address=target))):
        _build.reset_launches()
        t0 = time.perf_counter()
        runs[label] = operator_claims(pods, N_TYPES, OPERATOR_STEPS, **kw)
        out[f"{label}_s"] = time.perf_counter() - t0
        if label != "cpu":
            out["launches"][label] = dict(_build.launches)
    claims, steps, pending = runs["operator"]
    if not claims or runs["cpu"] != runs["operator"] or runs["operator_remote"] != runs["operator"]:
        raise SmokeFailure(
            f"operator: {len(claims)} claims in {steps} steps ({pending} pending); == cpu "
            f"{runs['cpu'] == runs['operator']}, == through the sidecar "
            f"{runs['operator_remote'] == runs['operator']}")
    out.update(claims=len(claims), steps=steps, pending=pending,
               pods_on_claims=sum(len(c[2]) for c in claims))
    if device == "cuda":
        for path in ("operator", "operator_remote"):
            missing = [k for k in PATH_KERNELS[path] if out["launches"][path][k] < 1]
            if missing:
                raise SmokeFailure(f"operator ({path}): never launched {missing}")
    return out


def twin_chaos_plan(clock):
    """The twin's fault plan (tests/e2e/test_twin.py:53-78), from the
    port's faults: store conflicts on NodeClaims and Nodes, provider ICE
    and registration stalls for the first 150 simulated seconds; no
    solver-crash rule (the wall holds fallback_solves at 0)."""
    from karpenter_tpu_torch import faults
    from karpenter_tpu_torch.cloudprovider.types import InsufficientCapacityError
    from karpenter_tpu_torch.kube.store import ConflictError

    def operator_kinds(ctx):
        return ctx.get("kind") in ("NodeClaim", "Node")

    until = clock.now() + 150.0
    return [
        faults.FaultRule(faults.STORE_CREATE, probability=0.1, until=until,
                         error=lambda: ConflictError("injected conflict"),
                         match=operator_kinds),
        faults.FaultRule(faults.STORE_UPDATE, probability=0.05, until=until,
                         error=lambda: ConflictError("injected conflict"),
                         match=operator_kinds),
        faults.FaultRule(faults.PROVIDER_CREATE, probability=0.15, until=until,
                         error=lambda: InsufficientCapacityError("injected ICE")),
        faults.FaultRule(faults.PROVIDER_REGISTER, probability=0.2, until=until),
    ]


def twin_inputs(device, p99_ms=TWIN_P99_MS):
    """Phase 14's trace, fleet profile and TwinConfig on ``device``."""
    from karpenter_tpu_torch.sim import slo, trace, twin
    from karpenter_tpu_torch.solver.driver import SolverConfig

    events = trace.generate(TWIN_SEED, trace.ChurnProfile(
        minutes=TWIN_TRACE_MINUTES, pods_per_minute=8, reclaim_minutes=(2,), reclaim_count=4,
        ice_minutes=(4,), ice_cells=6))
    profile = twin.ClusterProfile(nodes=TWIN_NODES, pods_per_node=TWIN_PODS_PER_NODE,
                                  n_types=TWIN_TYPES)
    config = twin.TwinConfig(seed=TWIN_SEED, minutes=TWIN_MINUTES, steps_per_minute=2,
                             slo=slo.SLOConfig(p99_decision_latency_ms=p99_ms),
                             solver_config=SolverConfig(device=device))
    return events, profile, config


def twin_artifacts(tw, minutes):
    """The replay's determinism artifacts over its first ``minutes``: the
    canonical audit of the records before the minute's end (bytes), and
    the minute reports less their wall-clock fields."""
    from karpenter_tpu_torch.sim.twin import canonical_audit

    end = tw._t0 + 60.0 * minutes
    reports = []
    for r in tw.reports[:minutes]:
        d = r.as_dict()
        del d["p99_latency_ms"], d["max_latency_ms"]
        reports.append(d)
    return canonical_audit([r for r in tw.audit.query() if r.timestamp < end]), reports


def twin_cpu_worker(conn):
    """A child process's work: the device="cpu" replay of phase 14 to
    TWIN_CPU_MINUTES (no wall-clock bound: it holds decisions), its
    canonical audit, fault log and reports sent on ``conn``."""
    import math

    from karpenter_tpu_torch.sim.twin import ClusterTwin

    events, profile, config = twin_inputs("cpu", p99_ms=math.inf)
    with ClusterTwin(events, profile=profile, config=config,
                     fault_rules=twin_chaos_plan) as tw:
        for _ in range(TWIN_CPU_MINUTES):
            tw.run_minute()
        audit, reports = twin_artifacts(tw, TWIN_CPU_MINUTES)
        conn.send((audit, tuple(tw.fault_log()), reports))
    conn.close()


def no_cuda_tensor(obj):
    """``obj`` pickled; raises if it holds a CUDA tensor."""
    import io
    import pickle

    import torch

    found = []

    class Pickler(pickle.Pickler):
        def reducer_override(self, o):
            if isinstance(o, torch.Tensor) and o.is_cuda:
                found.append(tuple(o.shape))
            return NotImplemented

    buf = io.BytesIO()
    Pickler(buf).dump(obj)
    if found:
        raise SmokeFailure(f"twin checkpoint: holds {len(found)} CUDA tensors {found[:4]}")
    return buf.getvalue()


def watch_controllers(tw, crashes):
    """Record in ``crashes`` every exception a roster pass of ``tw``'s
    operator raises but the fault plan's (a store conflict, the provider's
    ICE): Operator._guarded requeues a crashed controller and goes on, so
    a fault of the card there (TorchSolver._card_fault) would pass
    unseen."""
    from karpenter_tpu_torch.cloudprovider.types import InsufficientCapacityError
    from karpenter_tpu_torch.kube.store import ConflictError

    guarded = tw.operator._guarded

    def watched(name, fn, *args, **kwargs):
        def run(*a, **k):
            try:
                return fn(*a, **k)
            except (ConflictError, InsufficientCapacityError):
                raise
            except Exception as exc:
                crashes.append(f"{name}: {type(exc).__name__}: {exc}")
                raise
        return guarded(name, run, *args, **kwargs)

    tw.operator._guarded = watched


def cuda_allocated():
    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def phase_twin():
    """Phase 14: the digital twin (sim/twin.py) on the card, the JAX
    package's tier-1 wall (TWIN_* above). (a) the replay on the card,
    TWIN_MINUTES simulated minutes of the whole operator roster over kwok
    under the trace and the fault plan, counted: every minute's SLO wall
    asserted (ClusterTwin raises at a failing minute), fallback_solves,
    overcommitted and guard_bad 0 in every minute, every audit record on
    the "kernel" or "batched" rung, no controller crash but the fault
    plan's, the reclaim and ICE waves and the plan bitten; (b) the same
    replay on device="cpu" in a child process beside (a), to
    TWIN_CPU_MINUTES: the card's canonical audit over those minutes, its
    fault log and its minute reports (less their wall-clock fields) equal
    to the child's; (c) (a)'s checkpoint at TWIN_CHECKPOINT pickled (no
    CUDA tensor in it), the twin closed, ClusterTwin.resume on the card
    with the same inputs run to TWIN_RESUMED_TO, counted: its canonical
    audit and fault log equal to (a)'s over the same minutes;
    torch.cuda.memory_allocated() before (a) and after each twin closes,
    which must not grow. Reports bench.py run_twin's fields."""
    import multiprocessing
    import pickle

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.sim.twin import ClusterTwin

    events, profile, config = twin_inputs("cuda")
    out = {"launches": {}, "scenario_launches": {}}
    mem = [cuda_allocated()]
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=twin_cpu_worker, args=(send,), daemon=True)
    proc.start()
    send.close()
    try:
        t0 = time.perf_counter()
        tw = ClusterTwin(events, profile=profile, config=config, fault_rules=twin_chaos_plan)
        out["bootstrap_s"] = time.perf_counter() - t0
        crashes = []
        watch_controllers(tw, crashes)
        logs, ckpt = {}, None
        _build.reset_launches()
        t0 = time.perf_counter()
        with tw:
            for m in range(1, TWIN_MINUTES + 1):
                tw.run_minute()  # raises SLOViolationError at a failing minute
                if m in (TWIN_CPU_MINUTES, TWIN_RESUMED_TO):
                    logs[m] = tuple(tw.fault_log())
                if m == TWIN_CHECKPOINT:
                    ckpt = no_cuda_tensor(tw.checkpoint())
            out["replay_s"] = time.perf_counter() - t0
            out["launches"]["twin"] = dict(_build.launches)
            out["scenario_launches"]["twin"] = dict(_build.scenario_launches)
            reports, records = tw.reports, tw.audit.query()
            bad = [(r.minute, r.fallback_solves, r.overcommitted, r.guard_bad)
                   for r in reports if r.fallback_solves or r.overcommitted or r.guard_bad]
            rungs = sorted({r.rung for r in records})
            if (len(reports) != TWIN_MINUTES or bad or crashes
                    or not set(rungs) <= {"kernel", "batched"} or tw.reclaimed < 1
                    or tw.iced_cells < 1 or tw.injector.fired() < 1):
                raise SmokeFailure(
                    f"twin: {len(reports)} minutes, (minute, fallbacks, overcommitted, guard) "
                    f"{bad}, crashes {crashes[:3]}, rungs {rungs}, reclaimed {tw.reclaimed}, "
                    f"iced {tw.iced_cells}, faults fired {tw.injector.fired()}")
            worst = tw.worst_minute()
            out.update(
                minutes=TWIN_MINUTES, decisions=len(records),
                roster_s_per_minute=tw.roster_wall_s() / TWIN_MINUTES,
                solves_per_s=tw.solves_per_sec(), worst_p99_ms=worst.p99_latency_ms,
                worst_minute=worst.minute, reclaimed=tw.reclaimed, iced=tw.iced_cells,
                faults_fired=tw.injector.fired(), rungs=rungs,
                kinds={k: sum(r.kind == k for r in records)
                       for k in sorted({r.kind for r in records})},
                worst_cost_ratio=max(r.fleet_price / r.cost_lower_bound
                                     for r in reports if r.cost_lower_bound > 0),
                p99_ms=[r.p99_latency_ms for r in reports])
            resumed_want = twin_artifacts(tw, TWIN_RESUMED_TO)[0], logs[TWIN_RESUMED_TO]
            card_cpu = twin_artifacts(tw, TWIN_CPU_MINUTES) + (logs[TWIN_CPU_MINUTES],)
        mem.append(cuda_allocated())

        # (b) the device="cpu" replay, the child's
        if not recv.poll(TWIN_CPU_WAIT_S):
            raise SmokeFailure(f"twin: no device='cpu' replay in {TWIN_CPU_WAIT_S} s")
        try:
            cpu_audit, cpu_log, cpu_reports = recv.recv()
        except EOFError:
            raise SmokeFailure(f"twin: the device='cpu' replay failed (exit code "
                               f"{proc.exitcode})") from None
        same = dict(audit=card_cpu[0] == cpu_audit, fault_log=card_cpu[2] == cpu_log,
                    reports=card_cpu[1] == cpu_reports)
        if not all(same.values()):
            raise SmokeFailure(f"twin: the card's first {TWIN_CPU_MINUTES} minutes differ "
                               f"from the device='cpu' replay's: equal {same}")
        out["cpu_records"] = cpu_audit.count(b"\n")

        # (c) resume the checkpoint on the card
        _build.reset_launches()
        t0 = time.perf_counter()
        resumed = ClusterTwin.resume(pickle.loads(ckpt), events, profile=profile,
                                     config=config, fault_rules=twin_chaos_plan)
        crashes = []
        watch_controllers(resumed, crashes)
        with resumed:
            while resumed._minute < TWIN_RESUMED_TO:
                resumed.run_minute()
            out["resumed_s"] = time.perf_counter() - t0
            out["launches"]["twin_resumed"] = dict(_build.launches)
            out["scenario_launches"]["twin_resumed"] = dict(_build.scenario_launches)
            same = dict(audit=twin_artifacts(resumed, TWIN_RESUMED_TO)[0] == resumed_want[0],
                        fault_log=tuple(resumed.fault_log()) == resumed_want[1])
        mem.append(cuda_allocated())
        if not all(same.values()) or crashes:
            raise SmokeFailure(f"twin resume at minute {TWIN_CHECKPOINT}: equal to the "
                               f"uninterrupted run {same}, crashes {crashes[:3]}")
    finally:
        if proc.is_alive():
            proc.terminate()
        proc.join(30)
    out.update(checkpoint_bytes=len(ckpt), memory_allocated=mem)
    for path in ("twin", "twin_resumed"):
        missing = [k for k in PATH_KERNELS[path] if out["launches"][path][k] < 1]
        if missing or out["scenario_launches"][path]["pack"] < 1:
            raise SmokeFailure(f"{path}: never launched {missing}, scenario launches "
                               f"{out['scenario_launches'][path]}")
    if mem[1] > mem[0] or mem[2] > mem[0]:
        raise SmokeFailure(f"twin: memory_allocated grew across a closed twin: {mem} B")
    return out


def twin_line(twin, secs, smi):
    """Phase 14's log line."""
    return (f"phase 14 digital twin ({secs:.0f} s; {smi}): {TWIN_NODES} nodes x "
        f"{TWIN_PODS_PER_NODE} pods over corpus.generate({TWIN_TYPES}), trace seed {TWIN_SEED}, "
        f"the chaos plan; bootstrap {twin['bootstrap_s']:.1f} s; (a) {twin['minutes']} simulated "
        f"minutes on the card in {twin['replay_s']:.1f} s, every minute's SLO wall passed "
        f"(p99 <= {TWIN_P99_MS:.0f} ms), fallback_solves, overcommitted and guard_bad 0, rungs "
        f"{twin['rungs']}, no controller crash but the plan's; reclaimed {twin['reclaimed']}, "
        f"iced {twin['iced']}, faults fired {twin['faults_fired']}; records "
        + " ".join(f"{k}={v}" for k, v in twin["kinds"].items())
        + f"; run_twin: roster wall {twin['roster_s_per_minute'] * 1e3:.1f} ms per simulated "
        f"minute, {twin['solves_per_s']:.2f} solves/s, {twin['decisions']} decisions, worst "
        f"minute {twin['worst_minute']} p99 {twin['worst_p99_ms']:.1f} ms, worst fleet price / "
        f"lower bound {twin['worst_cost_ratio']:.3f}, reclaimed {twin['reclaimed']}, iced "
        f"{twin['iced']}; p99 by minute " + "/".join(f"{t:.0f}" for t in twin["p99_ms"])
        + f" ms; (b) == the device=\"cpu\" replay over minutes 0-{TWIN_CPU_MINUTES - 1} "
        f"({twin['cpu_records']} records): canonical audit, fault log, reports; (c) checkpoint "
        f"at minute {TWIN_CHECKPOINT} ({twin['checkpoint_bytes']} B pickled, no CUDA tensor), "
        f"resumed on the card to minute {TWIN_RESUMED_TO} in {twin['resumed_s']:.1f} s == the "
        f"uninterrupted run; memory_allocated before (a) / after (a) closed / after the resumed "
        f"closed " + " / ".join(str(b) for b in twin["memory_allocated"])
        + " B; launches " + "; ".join(
            f"{p}: " + " ".join(f"{k}={v}" for k, v in c.items() if v)
            + " (scenario " + " ".join(
                f"{k}={v}" for k, v in twin["scenario_launches"][p].items() if v) + ")"
            for p, c in twin["launches"].items()))


def port_frame():
    """The innermost frame of the running stack in karpenter_tpu_torch/
    as (path from the repo root, line, qualified function name), or
    None when no frame of the port is on it."""
    port = os.path.join(os.path.dirname(os.path.abspath(__file__)), "karpenter_tpu_torch")
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(port + os.sep):
            rel = os.path.relpath(path, os.path.dirname(port))
            return rel, frame.f_lineno, frame.f_code.co_qualname
        frame = frame.f_back
    return None


def card_syncs(fn):
    """``fn()``'s result and every host sync the card reports while it
    runs, under torch.cuda.set_sync_debug_mode("warn"): one (path, line,
    function) per sync, at the innermost frame in karpenter_tpu_torch/
    (("<outside the port>", 0, file:line) where none is on the stack).
    Other warnings pass on as they would."""
    import warnings

    import torch

    syncs = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        syncs.append(port_frame() or ("<outside the port>", 0, f"{filename}:{lineno}"))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, syncs


def sanctioned_syncs():
    """The host-sync rule's sanctioned sites (karpenter_tpu_torch/analysis/
    device.py): each ``sanctioned[DTX906]`` site the pass finds over its
    targets, as (path, first line, last line) of the statement it marks,
    and the implicit syncs the rule lists, as (path, function)."""
    import ast

    from karpenter_tpu_torch.analysis import cli, device
    from karpenter_tpu_torch.analysis.findings import partition_findings

    root = os.path.dirname(os.path.abspath(__file__))
    findings, sources = device.check_paths(
        [os.path.join(root, t) for t in cli.PASS_TARGETS["device"]])
    _, _, sanctioned = partition_findings(findings, sources)
    spans = []
    for f in sanctioned:
        if f.rule != "DTX906":
            continue
        stmts = [n for n in ast.walk(ast.parse(sources[f.path].text))
                 if isinstance(n, ast.stmt) and not isinstance(
                     n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                 and n.lineno <= f.line <= n.end_lineno]
        stmt = min(stmts, key=lambda n: n.end_lineno - n.lineno)
        spans.append((os.path.relpath(f.path, root), stmt.lineno, stmt.end_lineno))
    return spans, {(path, fn) for path, fn, _ in device.IMPLICIT_SYNCS}


def unsanctioned(syncs, spans, implicit):
    """The syncs of ``syncs`` at no sanctioned site."""
    def ok(path, line, fn):
        return (path, fn) in implicit or any(
            path == p and lo <= line <= hi for p, lo, hi in spans)
    return [s for s in syncs if not ok(*s)]


def phase_sync_audit(torch_solver_cls, config_cls, encode_cache_cls):
    """Phase 15: the syncs the card reports against the host-sync rule's
    sanctioned sites. One warm mixed N_PODS x N_TYPES TorchSolver.solve
    (a solve on the same EncodeCache before it) and one warm consolidation
    scenario batch (CONS_SCENARIOS single-node scenarios over the
    CONS_NODES cluster, B7; the same batch once before it), each under
    torch.cuda.set_sync_debug_mode("warn"); every sync is attributed to
    its innermost frame in karpenter_tpu_torch/ and must lie at a site the
    rule sanctions."""
    from karpenter_tpu_torch.controllers.disruption.helpers import ScenarioSimulator
    from karpenter_tpu_torch.solver.workloads import build_consolidation_env, mixed_pods

    spans, implicit = sanctioned_syncs()
    cache = encode_cache_cls()

    def solve():
        solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES, device="cuda",
                             cache=cache)
        return solver.solve(pods)

    pods = mixed_pods(N_PODS)
    solve()
    res, solve_syncs = card_syncs(solve)
    if res.pod_errors or not res.new_node_claims:
        raise SmokeFailure(f"phase 15: the audited solve has {len(res.pod_errors)} errors")

    ctx, _, candidates, _ = build_consolidation_env(CONS_NODES, "cuda")
    sim = ScenarioSimulator(
        ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
        encode_cache=ctx.encode_cache, solver_config=ctx.solver_config,
    )
    chunk = [[c] for c in candidates[:CONS_SCENARIOS]]

    def batch():
        return sim._solver.solve_scenarios(sim._scenarios_of(chunk))

    batch()
    out, batch_syncs = card_syncs(batch)
    if out is None or len(out) != CONS_SCENARIOS:
        raise SmokeFailure("phase 15: the audited scenario batch declined")
    drain = [s for s in solve_syncs if s[2].endswith("_drain_host")]
    if not drain:
        raise SmokeFailure("phase 15: the card reported no sync at the solve's drain, so the "
                           f"audit saw nothing ({solve_syncs})")
    bad = unsanctioned(solve_syncs + batch_syncs, spans, implicit)
    if bad:
        raise SmokeFailure(f"phase 15: syncs at sites the host-sync rule does not sanction: "
                           f"{sorted(set(bad))}")

    def by_site(syncs):
        counts = {}
        for path, line, fn in syncs:
            key = f"{path}:{line} {fn}"
            counts[key] = counts.get(key, 0) + 1
        return counts

    return dict(solve_syncs=len(solve_syncs), batch_syncs=len(batch_syncs),
                solve_sites=by_site(solve_syncs), batch_sites=by_site(batch_syncs),
                statements=len(spans), implicit=len(implicit))


def sync_line(audit, secs, smi):
    return (f"phase 15 sync audit ({secs:.0f} s; {smi}): warm mixed {N_PODS} x {N_TYPES} solve "
            f"{audit['solve_syncs']} syncs (" + ", ".join(
                f"{k} x{v}" for k, v in sorted(audit["solve_sites"].items()))
            + f"); scenario batch S={CONS_SCENARIOS} over {CONS_NODES} nodes "
            f"{audit['batch_syncs']} syncs (" + ", ".join(
                f"{k} x{v}" for k, v in sorted(audit["batch_sites"].items()))
            + f"); every one at a site the host-sync rule sanctions ({audit['statements']} "
            f"DTX906 statements, {audit['implicit']} implicit site(s))")


def mesh_counts_ok(label, counts, dispatches, dims, nodes, blocks=1):
    """Raise unless a mesh solve of ``dispatches`` dispatches over a mesh
    of ``dims`` launched, per dispatch and scenario block, D x M B1
    partials, D B2 partials (with nodes), one fold, B4 and B6 once, and
    no single-device table kernel; with D x M = 1 the block's stage is the
    single-device one (B1, and B2 with nodes), unfolded."""
    D, M = dims["data"], dims["model"]
    n = dispatches * blocks
    if D * M == 1:
        want = dict(fresh_feasibility=n, existing_feasibility=n if nodes else 0,
                    fresh_partial=0, existing_partial=0, mesh_fold=0)
    else:
        want = dict(fresh_partial=D * M * n, existing_partial=D * n if nodes else 0,
                    mesh_fold=n, fresh_feasibility=0, existing_feasibility=0)
    want.update(pack=n, wire_pack=n, pack_classed=0, relax_fill=0)
    got = {k: counts[k] for k in want}
    if got != want:
        raise SmokeFailure(f"{label}: launches {got}, want {want}")


def mesh_rows(torch_solver_cls, config_cls, m8, m24, device="cuda"):
    """Phase 16(b): B1's partial mode and the fold against their plain
    versions on the card, on every shard, at the shapes of (c): B1's
    partials at constrained 50k x 800 over data 2 x model 4 (shard (0, 0)
    timed: the base, its type slice, its half of the live pairs), the fold
    at constrained 50k x 800 over data 8 (8 partials a cell). Tolerance:
    exact equality. B2's partial mode: existing_partial_row."""
    import torch

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.parallel import mesh as pm
    from karpenter_tpu_torch.solver.example import example_state_nodes
    from karpenter_tpu_torch.solver.workloads import constrained_mix, mixed_pods

    rows = {}
    cpods = constrained_mix(N_PODS)
    host, _, statics, _ = host_snapshot(
        build_batch(torch_solver_cls, config_cls, cpods, N_TYPES_C, device=device), cpods)
    zk, ck = statics["zone_kid"], statics["ct_kid"]

    def fresh_shards(mesh):
        """Every shard's B1 partial (kernel, plain) over the placed args."""
        margs = pm.place_args(pm.pad_args_for_mesh(host, mesh), mesh)
        D, M = mesh.shape["data"], mesh.shape["model"]
        out, err = [], 0.0
        for d in range(D):
            for m in range(M):
                ins = [margs.at(n, 0, d, m) for n in B1_NAMES]
                k = feas.fresh_claim_feasibility_partial(*ins, zone_kid=zk, ct_kid=ck,
                                                         with_base=d == 0)
                r = feas.fresh_claim_feasibility_partial_reference(
                    *ins, zone_kid=zk, ct_kid=ck, with_base=d == 0)
                err = max(err, max_abs_err([x for x in k if x is not None],
                                           [x for x in r if x is not None]))
                out.append((d, m, ins, k))
        return margs, out, err

    margs, shards, err24 = fresh_shards(m24)
    ins = shards[0][2]
    a = dict(zip(B1_NAMES, ins))

    def part():
        return feas.fresh_claim_feasibility_partial(*ins, zone_kid=zk, ct_kid=ck, with_base=True)

    def plain():
        return feas.fresh_claim_feasibility_partial_reference(*ins, zone_kid=zk, ct_kid=ck,
                                                              with_base=True)

    out = part()
    P, G, Tm = out[0].shape
    rows["fresh_partial"] = with_device(dict(
        max_abs_err=err24, ms=cuda_ms(part, 50), plain_ms=cuda_ms(plain, 10),
        bound=bound_ms(sum(b1_reads(a, zk, ck).values()) + nbytes(out), b1_ops(a)),
        shape=(f"constrained 50k x {N_TYPES_C} over data 2 x model 4, shard (0, 0): P={P} "
               f"G={G} T={Tm} of {Tm * 4} L={a['gk_g'].shape[0]} "
               f"({int((a['gk_w'] != 0).sum())} live); all 8 shards == plain"),
    ), part, 100)
    one_kernel("B1 partial", rows["fresh_partial"]["device_per_call"])

    # the fold at constrained 50k x 800 over data 8: 8 partials a cell,
    # each shard's written into its slice of the stacked buffers (out=),
    # as ops/solve.py:_mesh_tables writes them
    margs8 = pm.place_args(pm.pad_args_for_mesh(host, m8), m8)
    D, M = m8.shape["data"], m8.shape["model"]
    p_tol = margs8.whole("p_tol")
    P, G = p_tol.shape
    slab = (M, P, G, margs8.at("t_alloc", 0, 0, 0).shape[0])
    fail_t = torch.empty((D,) + slab, dtype=torch.int32, device=p_tol.device)
    fail_c = torch.empty((D, P, G), dtype=torch.int32, device=p_tol.device)
    tonly = torch.empty(slab, dtype=torch.bool, device=p_tol.device)
    n_fit = torch.empty(slab, dtype=torch.int32, device=p_tol.device)
    err_8 = 0.0
    for d in range(D):
        for m in range(M):
            ins8 = [margs8.at(n, 0, d, m) for n in B1_NAMES]
            base = d == 0
            k = feas.fresh_claim_feasibility_partial(
                *ins8, zone_kid=zk, ct_kid=ck, with_base=base,
                out=(fail_t[d, m], fail_c[d], tonly[m] if base else None,
                     n_fit[m] if base else None))
            r = feas.fresh_claim_feasibility_partial_reference(
                *ins8, zone_kid=zk, ct_kid=ck, with_base=base)
            err_8 = max(err_8, max_abs_err([x for x in k if x is not None],
                                           [x for x in r if x is not None]))
    fold_in = (fail_t, fail_c, tonly, n_fit, p_tol)
    partials = list(fail_t.view((D * M,) + slab[1:]).unbind(0))

    def fold():
        return feas.mesh_fold(*fold_in)[:3]

    def fplain():
        return feas.mesh_fold_reference(*fold_in)[:3]

    def library():
        return fail_t.sum(0, dtype=torch.int32)

    def library_stack():
        return torch.stack(partials).sum(0, dtype=torch.int32)

    fout, fref = fold(), fplain()
    whole = feas.fresh_claim_feasibility_sparse(
        *(margs8.whole(n) for n in B1_NAMES), zone_kid=zk, ct_kid=ck)
    T = fout[1].shape[2]
    rows["mesh_fold"] = with_device(dict(
        max_abs_err=max(max_abs_err(fout, fref), max_abs_err(fout, whole), err_8),
        ms=cuda_ms(fold, 50), plain_ms=cuda_ms(fplain, 10), library_ms=cuda_ms(library, 50),
        library_stack_ms=cuda_ms(library_stack, 50),
        bound=bound_ms(nbytes([fail_t, fail_c, tonly, n_fit, p_tol]) + nbytes(fout),
                       P * G * T * D + P * G * D),
        shape=(f"constrained 50k x {N_TYPES_C} over data 8: D={D} P={P} G={G} T={T}; "
               "== plain == B1's tables on the whole input"),
    ), fold, 100)
    one_kernel("mesh fold", rows["mesh_fold"]["device_per_call"])
    return rows


def existing_partial_row(torch_solver_cls, config_cls, m8, cons_args, device="cuda"):
    """Phase 16(b): B2's partial mode against its plain version on the
    card: on each of data 8's shards at mixed 2,000 over 32 nodes (each
    shard's slice of the live pairs), and timed at the consolidation chunk
    (``cons_args``: the shared encoding of (d)'s batch, N = 2048), as each
    scenario block of (d) on data 2 x model 4 runs it (one data shard,
    every pair, the base). Tolerance: exact equality."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.parallel import mesh as pm
    from karpenter_tpu_torch.solver.example import example_state_nodes
    from karpenter_tpu_torch.solver.workloads import mixed_pods

    names = tuple(n for n in B2_NAMES if n != "n_tol")
    npods = mixed_pods(NODE_PODS)
    nhost, _, _, _ = host_snapshot(build_batch(
        torch_solver_cls, config_cls, npods, N_TYPES, device=device,
        state_nodes=example_state_nodes(N_NODES)), npods)
    nmargs = pm.place_args(pm.pad_args_for_mesh(nhost, m8), m8)
    err = 0.0
    for d in range(m8.shape["data"]):
        e_in = [nmargs.at(n, 0, d, 0) for n in names]
        k = feas.existing_node_feasibility_partial(*e_in, with_base=d == 0)
        r = feas.existing_node_feasibility_partial_reference(*e_in, with_base=d == 0)
        err = max(err, max_abs_err([x for x in k if x is not None],
                                   [x for x in r if x is not None]))
    e_in = [cons_args[n] for n in names]
    ea = dict(cons_args)

    def epart():
        return feas.existing_node_feasibility_partial(*e_in, with_base=True)

    def eplain():
        return feas.existing_node_feasibility_partial_reference(*e_in, with_base=True)

    eout = epart()
    err = max(err, max_abs_err(eout, eplain()))
    row = with_device(dict(
        max_abs_err=err, ms=cuda_ms(epart, 50), plain_ms=cuda_ms(eplain, 20),
        bound=bound_ms(sum(b2_reads(ea).values()) - nbytes([ea["n_tol"]]) + nbytes(eout),
                       b2_ops(ea) - ea["n_tol"].numel()),
        shape=(f"the consolidation chunk: N={ea['n_avail'].shape[0]} "
               f"G={ea['g_mask'].shape[0]} L={ea['gk_g'].shape[0]} "
               f"({int((ea['gk_w'] != 0).sum())} live), every pair and the base; all 8 shards "
               f"of mixed {NODE_PODS} over {N_NODES} nodes at data 8 == plain"),
    ), epart, 100)
    one_kernel("B2 partial", row["device_per_call"])
    return row


def phase_mesh(torch_solver_cls, config_cls, encode_cache_cls, device="cuda"):
    """Phase 16: the solver mesh (A13, B10) on the one card. (a)
    SolverConfig(mesh="auto") resolves to no mesh on one card and decides
    as mesh=None at mixed 50k x 400 through B1, not the partials; (b) B1's
    and B2's partial modes and the fold against their plain versions
    (mesh_rows); (c) TorchSolver over make_mesh(devices=[cuda:0] * 8):
    mixed 50k x 400 at data 8, constrained 50k x 800 at data 8 and at data
    2 x model 4, mixed 2,000 over 32 nodes at data 8, each == mesh=None in
    slot order, and the dense route on dense_mesh (B3 on each model
    shard's types, gathered by the fold) == the single-device dense
    dispatch; (d) a consolidation batch at S = 16 over the 2,000-node
    cluster on the data-8 mesh (scenario_mesh: 8 blocks of 2, each B1 +
    B2[2] + B4 + B6) and on data 2 x model 4 (2 blocks of 8, each 4 B1
    partials, a B2 partial and a fold), == the unsharded batch, <= 2
    dispatches, 0 fallbacks; (e) MESH_TICKS constrained churn ticks on the
    data-8 mesh, each == the single-device tick, riding row deltas through
    B8 (replicated buffers: one copy on the one card, one launch), REUSE
    and row-delta outcomes as the single device's, then a REUSE repeat;
    (f) the launch counts of every solve (mesh_counts_ok); (g) one warm
    mesh solve under phase 15's sync audit. (b)'s B2 row is timed at (d)'s
    chunk (existing_partial_row)."""
    import dataclasses
    import random

    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.controllers.disruption.helpers import ScenarioSimulator
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.parallel import mesh as pm
    from karpenter_tpu_torch.solver.args import to_device_args
    from karpenter_tpu_torch.solver.encode import SOLVE_ARG_NAMES
    from karpenter_tpu_torch.solver.example import example_state_nodes
    from karpenter_tpu_torch.solver.workloads import (
        CHURN_SEED, build_consolidation_env, churn_tick, constrained_mix, mixed_pods,
    )

    card = torch.device(device, 0) if device == "cuda" else torch.device(device)
    m8 = pm.make_mesh(devices=[card] * MESH_SHARDS)
    m24 = pm.make_mesh(MESH_SHARDS, data=2, devices=[card] * MESH_SHARDS)
    out = {"launches": {}, "ms": {}}

    def solver(pods, n_types, mesh=None, nodes=0, cache=None):
        return build_batch(torch_solver_cls, config_cls, pods, n_types, cache=cache,
                           device=device,
                           state_nodes=example_state_nodes(nodes) if nodes else (),
                           config_kw={"mesh": mesh})

    def counted(label, s, pods):
        _build.reset_launches()
        t0 = time.perf_counter()
        res = s.solve(pods)
        torch.cuda.synchronize()
        out["ms"][label] = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.launches)
        out["launches"][label] = counts
        if s.fallback_solves or s.last_relax_pods or res.pod_errors:
            raise SmokeFailure(f"{label}: fallbacks {s.last_fallback_reasons}, relax "
                               f"{s.last_relax_pods}, {len(res.pod_errors)} errors")
        return res, counts

    # (a) "auto" on one card
    pods = mixed_pods(N_PODS)
    auto = solver(pods, N_TYPES, "auto")
    if (device == "cuda" and torch.cuda.device_count() != 1) or auto._resolve_mesh() is not None:
        raise SmokeFailure(f"auto: {torch.cuda.device_count()} cards, mesh "
                           f"{auto._resolve_mesh()}")
    res, counts = counted("mesh_auto", auto, pods)
    one = solver(pods, N_TYPES).solve(pods)
    if decisions(res, pods) != decisions(one, pods):
        raise SmokeFailure("auto: decisions differ from mesh=None")
    mesh_counts_ok("mesh_auto", counts, auto.last_dispatches, {"data": 1, "model": 1}, False)
    out["auto_claims"] = len(res.new_node_claims)

    # (b) the kernel rows
    out["rows"] = mesh_rows(torch_solver_cls, config_cls, m8, m24, device)

    # (c) sharded solves on 8 positions of the card
    def mesh_solve(label, pods, n_types, mesh, ref, nodes=0):
        s = solver(pods, n_types, mesh, nodes)
        res, counts = counted(label, s, pods)
        if decisions(res, pods) != decisions(ref, pods):
            raise SmokeFailure(f"{label}: decisions differ from mesh=None")
        mesh_counts_ok(label, counts, s.last_dispatches, mesh.shape, bool(nodes))
        return len(res.new_node_claims)

    out["claims"] = {"mesh_mixed": mesh_solve("mesh_mixed", pods, N_TYPES, m8, one)}
    cpods = constrained_mix(N_PODS)
    cref = solver(cpods, N_TYPES_C).solve(cpods)
    out["claims"]["mesh_constrained"] = mesh_solve("mesh_constrained", cpods, N_TYPES_C, m8,
                                                   cref)
    out["claims"]["mesh_constrained_d2m4"] = mesh_solve("mesh_constrained_d2m4", cpods,
                                                        N_TYPES_C, m24, cref)
    npods = mixed_pods(NODE_PODS)
    nref = solver(npods, N_TYPES, nodes=N_NODES).solve(npods)
    out["claims"]["mesh_nodes"] = mesh_solve("mesh_nodes", npods, N_TYPES, m8, nref,
                                             nodes=N_NODES)
    # the dense route on dense_mesh: B3 on each model shard's type slice
    dm = pm.dense_mesh(m8)
    s0 = solver(pods, N_TYPES)
    host, snap, statics, _ = host_snapshot(s0, pods)
    fit = s0._fit_matrix(snap)
    fills = torch.int16 if s0._fill_bound(snap, fit) < 2**15 else torch.int32
    st = dict(statics, sparse_groups=False, nmax=s0._select_nmax(snap, fit, None))
    padded = pm.pad_args_for_mesh(host, dm)
    margs = pm.place_args(padded, dm)
    _build.reset_launches()
    got = pm.sharded_solve_packed_fn(dm, fills, **st)(margs)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    out["launches"]["mesh_dense"] = counts
    want = solve_mod.dispatch_packed(*to_device_args(padded, card), fills_dtype=fills, **st)
    if max_abs_err(got, want):
        raise SmokeFailure("mesh_dense: the dense mesh dispatch differs from one device's")
    if (counts["dense_fresh"], counts["mesh_fold"], counts["pack"], counts["fresh_partial"]) != (
            dm.shape["model"], 1, 1, 0):
        raise SmokeFailure(f"mesh_dense: launches {counts}")

    # (d) the scenario mesh at the consolidation chunk
    ctx, _, candidates, _ = build_consolidation_env(CONS_NODES, device)
    chunk = [[c] for c in candidates[:CONS_SCENARIOS]]

    def batch(mesh, label=None):
        cfg = dataclasses.replace(ctx.solver_config, mesh=mesh)
        sim = ScenarioSimulator(ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
                                encode_cache=ctx.encode_cache, solver_config=cfg)
        scen = sim._scenarios_of(chunk)
        union = list({p.uid: p for sc in scen for p in sc.pods}.values())
        _build.reset_launches()
        res = sim._solver.solve_scenarios(scen)
        torch.cuda.synchronize()
        if res is None:
            raise SmokeFailure(f"{label or 'batch'}: the scenario batch declined")
        if label:
            counts = dict(_build.launches)
            out["launches"][label] = counts
            s = sim._solver
            if s.fallback_solves or s.last_scenario_dispatches > 2:
                raise SmokeFailure(f"{label}: {s.fallback_solves} fallbacks, "
                                   f"{s.last_scenario_dispatches} dispatches")
            sm = pm.scenario_mesh(mesh, 16)
            mesh_counts_ok(label, counts, s.last_scenario_dispatches, sm.shape, True,
                           blocks=sm.shape["scenario"])
            out.setdefault("scenarios", {})[label] = dict(
                dispatches=s.last_scenario_dispatches, blocks=sm.shape)
        return [decisions(r, union) for r in res]

    sref = batch(None)
    for label, mesh in (("mesh_scenarios", m8), ("mesh_scenarios_d2m4", m24)):
        if batch(mesh, label) != sref:
            raise SmokeFailure(f"{label}: the batch differs from the unsharded batch")
    # B2's partial mode, timed at the chunk's shared encoding
    sim = ScenarioSimulator(ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
                            encode_cache=ctx.encode_cache, solver_config=ctx.solver_config)
    token = sim._solver.submit_scenarios(sim._scenarios_of(chunk))
    if token is None or not isinstance(token.get("args"), list):
        raise SmokeFailure("the consolidation chunk declined the scenario batch")
    out["rows"]["existing_partial"] = existing_partial_row(
        torch_solver_cls, config_cls, m8, dict(zip(SOLVE_ARG_NAMES, token["args"])), device)

    # (e) constrained churn ticks on the data-8 mesh
    cache_m, cache_1 = encode_cache_cls(), encode_cache_cls()
    tpods = cpods
    for _ in range(2):  # a-priori, then adaptive NMAX, on both
        solver(tpods, N_TYPES_C, m8, cache=cache_m).solve(tpods)
        solver(tpods, N_TYPES_C, cache=cache_1).solve(tpods)
    rng = random.Random(CHURN_SEED)
    ticks, tick_counts = [], {}
    for i in range(MESH_TICKS):
        tpods = churn_tick(tpods, constrained_mix, rng)
        s = solver(tpods, N_TYPES_C, m8, cache=cache_m)
        res, counts = counted(f"mesh_tick{i}", s, tpods)
        del out["launches"][f"mesh_tick{i}"]
        s1 = solver(tpods, N_TYPES_C, cache=cache_1)
        _build.reset_launches()
        ref = s1.solve(tpods)
        torch.cuda.synchronize()
        b8_single = _build.launches["apply_rows"]
        if decisions(res, tpods) != decisions(ref, tpods):
            raise SmokeFailure(f"mesh tick {i + 1}: decisions differ from the single device's")
        store, store1 = cache_m.device_store, cache_1.device_store
        outcome = (s.last_encode_reused, s.last_delta_rows, store.last_delta_rows)
        if outcome != (s1.last_encode_reused, s1.last_delta_rows, store1.last_delta_rows):
            raise SmokeFailure(f"mesh tick {i + 1}: warm outcome {outcome} vs single")
        full = not s.last_encode_reused and s.last_delta_rows == 0
        if full or store.last_delta_rows < 1 or counts["apply_rows"] < 1:
            raise SmokeFailure(f"mesh tick {i + 1}: full re-encode {full}, device delta rows "
                               f"{store.last_delta_rows}, B8 {counts['apply_rows']}")
        mesh_counts_ok(f"mesh tick {i + 1}", counts, s.last_dispatches, m8.shape, False)
        for k, v in counts.items():
            tick_counts[k] = tick_counts.get(k, 0) + v
        ticks.append(dict(ms=out["ms"].pop(f"mesh_tick{i}"), encode_delta_rows=s.last_delta_rows,
                          device_delta_rows=store.last_delta_rows, full_puts=store.last_full_puts,
                          b8=counts["apply_rows"], b8_single=b8_single))
    out["launches"]["mesh_ticks"] = tick_counts
    out["ticks"] = ticks
    s = solver(tpods, N_TYPES_C, m8, cache=cache_m)
    s.solve(tpods)
    if not s.last_encode_reused or cache_m.device_store.last_full_puts or s.fallback_solves:
        raise SmokeFailure(f"mesh repeat: reused {s.last_encode_reused}, full puts "
                           f"{cache_m.device_store.last_full_puts}")

    # (g) a warm mesh solve under the sync audit
    spans, implicit = sanctioned_syncs()
    cache = encode_cache_cls()
    solver(pods, N_TYPES, m8, cache=cache).solve(pods)
    _, syncs = card_syncs(lambda: solver(pods, N_TYPES, m8, cache=cache).solve(pods))
    if not [x for x in syncs if x[2].endswith("_drain_host")]:
        raise SmokeFailure(f"mesh sync audit: no sync at the drain ({syncs})")
    bad = unsanctioned(syncs, spans, implicit)
    if bad:
        raise SmokeFailure(f"mesh sync audit: unsanctioned syncs {sorted(set(bad))}")
    out["syncs"] = len(syncs)
    return out


def mesh_line(mesh, secs, total_s, smi):
    rows = mesh["rows"]
    return (
        f"phase 16 solver mesh ({secs:.0f} s, smoke so far {total_s:.0f} s; {smi}): (a) "
        f"mesh=\"auto\" on 1 card -> no mesh, mixed {N_PODS} x {N_TYPES} == mesh=None "
        f"({mesh['auto_claims']} claims, B1 not the partials); (b) " + "; ".join(
            f"{k} [{r['shape']}] {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
            f"({r['device_timing']}), plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.6f} ms ({r['bound'][1]})"
            + (f", {LIBRARY[k]} {r['library_ms']:.4f} ms" if k in LIBRARY else "")
            + (f", {LIBRARY_STACK} {r['library_stack_ms']:.4f} ms"
               if "library_stack_ms" in r else "")
            + f", max |diff| {r['max_abs_err']}" for k, r in rows.items())
        + f"; (c) on make_mesh(devices=[cuda:0] x {MESH_SHARDS}), each == mesh=None in slot "
        "order: " + ", ".join(f"{k} {v} claims {mesh['ms'][k]:.1f} ms"
                              for k, v in mesh["claims"].items())
        + ", dense route on dense_mesh == one device's dispatch; (d) S="
        f"{CONS_SCENARIOS} over {CONS_NODES} nodes == unsharded: " + ", ".join(
            f"{k} {v['dispatches']} dispatch(es) over {v['blocks']}"
            for k, v in mesh["scenarios"].items())
        + f", 0 fallbacks; (e) {MESH_TICKS} constrained ticks on data 8, each == one device's "
        "(warm outcome too): " + "; ".join(
            f"{t['ms']:.1f} ms (encode delta rows {t['encode_delta_rows']}, device delta rows "
            f"{t['device_delta_rows']}, full puts {t['full_puts']}, B8 {t['b8']} vs "
            f"{t['b8_single']} on one device)" for t in mesh["ticks"])
        + "; REUSE repeat; (f) launches " + "; ".join(
            f"{p}: " + " ".join(f"{k}={v}" for k, v in c.items() if v)
            for p, c in mesh["launches"].items())
        + f"; (g) a warm mesh solve {mesh['syncs']} syncs, all sanctioned")


# -- phase 17: the dispatch queue and the donated row apply ----------------------


def queue_events(tracer):
    """The queue's instant events of every finished span, in time order:
    (name, attrs)."""
    events = sorted((ts, name, attrs) for s in tracer.finished() for ts, name, attrs in s.events
                    if name.startswith("queue."))
    return [(name, attrs) for _, name, attrs in events]


def queue_pairs_ok(label, events, kind, dispatches):
    """Raise unless ``events`` are ``dispatches`` submit/drain pairs of
    ``kind``: depth 1 at each submit, 0 at each drain, no eviction."""
    want = [("queue.depth", {"depth": d, "op": op, "label": kind})
            for _ in range(dispatches) for d, op in ((1, "submit"), (0, "drain"))]
    if events != want:
        raise SmokeFailure(f"{label}: queue events {events}, want {dispatches} x submit/drain "
                           f"of {kind!r}")


def per_dispatch(counts, dispatches, kernels):
    return {k: counts[k] / dispatches for k in kernels}


class donating:
    """KTPU_DONATE_DELTA set to ``flag`` ("1" or "0") inside, restored after."""

    def __init__(self, flag):
        self.flag = flag

    def __enter__(self):
        self.old = os.environ.get("KTPU_DONATE_DELTA")
        os.environ["KTPU_DONATE_DELTA"] = self.flag

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("KTPU_DONATE_DELTA", None)
        else:
            os.environ["KTPU_DONATE_DELTA"] = self.old


def cold_device_ms(fn, kernel, reps=50):
    """Device milliseconds of the kernel named ``kernel`` per call of
    ``fn``, with the L2 cache cold: a 128 MB write between calls evicts
    the H100's 50 MB L2, as a churn tick's apply finds its buffer (the
    back-to-back calls of device_ms find the rows they just wrote in L2).
    torch.profiler's self device time of that kernel's records alone;
    None where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA") or not ev.count:
            continue
        name = ev.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
        if name.split()[-1] == kernel:
            t = getattr(ev, "self_device_time_total", None)
            us += getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
            n += ev.count
    return us / 1e3 / n if n else None


def peak_rise(fn):
    """Bytes by which max_memory_allocated rises over what was allocated
    before ``fn()``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - start


def b8_inplace_row(inputs, reps=100):
    """B8's in-place entry (KTPU_DONATE_DELTA=1) at a churn tick's largest
    row delta: exact against its plain in-place version on the same CUDA
    tensors and against the tick's encode, counted under its own name (and
    never as the out-of-place B8), one device kernel a call under
    torch.profiler, its result in the buffer's own memory and the old
    tensor emptied. Timed through the wrapper (CUDA events) and on the
    device alone, beside the out-of-place B8 and Tensor.index_copy_ (in
    place) on the same inputs. Bound: the delta rows read and written and
    their indices read once."""
    import numpy as np
    import torch

    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.solver.args import put

    name, ha, hb, idx_np = inputs
    idx = torch.from_numpy(idx_np.astype(np.int32)).to("cuda")
    vals = torch.from_numpy(np.ascontiguousarray(hb[idx_np])).to("cuda")
    idx64 = idx.long()
    want = torch.from_numpy(np.ascontiguousarray(hb))
    ref = solve_mod.delta_apply_rows_inplace_reference(put(name, ha, "cuda"), idx, vals)
    arr = put(name, ha, "cuda")
    ptr = arr.data_ptr()
    with donating("1"):
        _build.reset_launches()
        out = solve_mod.delta_apply_rows(arr, idx, vals)
        torch.cuda.synchronize()
        counts = (_build.launches["apply_rows_inplace"], _build.launches["apply_rows"])
        if counts != (1, 0) or out.data_ptr() != ptr or arr.numel():
            raise SmokeFailure(f"B8 in place: launches (in place, out of place) {counts}, "
                               f"same memory {out.data_ptr() == ptr}, old tensor emptied "
                               f"{not arr.numel()}")
        if not torch.equal(out, ref) or not torch.equal(out.cpu(), want):
            raise SmokeFailure(f"B8 in place: {name} differs from its plain in-place version "
                               "or from the tick's encode")
        err = max_abs_err([out], [ref])
        box = [out]

        def inplace():
            box[0] = solve_mod.delta_apply_rows(box[0], idx, vals)

        dev_ms, dev_acts, how = device_ms(inplace, reps)
        one_kernel("B8 in place", dev_acts)
        ms = cuda_ms(inplace, 50)
        cold_ms = cold_device_ms(inplace, "apply_rows_inplace")
        inplace_rise = peak_rise(inplace)
    plain_buf = put(name, ha, "cuda")
    lib_buf = put(name, ha, "cuda")
    with donating("0"):
        def out_of_place():
            solve_mod.delta_apply_rows(plain_buf, idx, vals)

        oop_dev_ms, oop_acts, _ = device_ms(out_of_place, reps)
        oop_cold_ms = cold_device_ms(out_of_place, "apply_rows")
        oop_rise = peak_rise(out_of_place)
    lib_dev_ms, lib_acts, _ = device_ms(lambda: lib_buf.index_copy_(0, idx64, vals), reps)
    return dict(
        max_abs_err=err,
        ms=ms,
        plain_ms=cuda_ms(
            lambda: solve_mod.delta_apply_rows_inplace_reference(plain_buf, idx, vals), 20),
        library_ms=cuda_ms(lambda: lib_buf.index_copy_(0, idx64, vals), 50),
        device_ms=dev_ms, device_timing=how, device_per_call=dev_acts,
        out_of_place_device_ms=oop_dev_ms, out_of_place_per_call=oop_acts,
        cold_device_ms=cold_ms, out_of_place_cold_device_ms=oop_cold_ms,
        peak_rise=inplace_rise, out_of_place_peak_rise=oop_rise,
        library_device_ms=lib_dev_ms, library_device_per_call=lib_acts,
        bound=bound_ms(2 * nbytes([vals]) + nbytes([idx]), 0),
        buffer_bytes=nbytes([ref]),
        shape=f"{name} {tuple(ref.shape)} {ref.dtype}, {len(idx_np)} rows",
    )


def tick_b8_inputs(torch_solver_cls, config_cls, encode_cache_cls):
    """largest_delta of phase 5's first constrained churn tick (phase 2's
    B8 row's inputs), for a run of phase 17 alone."""
    import random

    from karpenter_tpu_torch.solver.workloads import CHURN_SEED, churn_tick, constrained_mix

    cache = encode_cache_cls()
    pods = constrained_mix(N_PODS)
    host_a = host_snapshot(build_batch(torch_solver_cls, config_cls, pods, N_TYPES_C,
                                       cache=cache), pods)[0]
    tick = churn_tick(pods, constrained_mix, random.Random(CHURN_SEED))
    return largest_delta(host_a, *host_snapshot(build_batch(
        torch_solver_cls, config_cls, tick, N_TYPES_C, cache=cache), tick)[::3])


def tenant_b8_inputs(torch_solver_cls, config_cls, encode_cache_cls):
    """largest_delta of phase 9's first tenant tick, for a run of phase 17
    alone."""
    import random

    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.solver.example import tenant_pods, tenant_pools

    pools = tenant_pools(N_TENANTS)
    catalog = corpus.generate(TENANT_TYPES)
    its = {p.name: list(catalog) for p in pools}
    cache = encode_cache_cls()
    pods = tenant_pods(N_DEPLOY, N_TENANTS)

    def snap(batch):
        return host_snapshot(build_batch(torch_solver_cls, config_cls, batch, 0, cache=cache,
                                         pools=pools, its=catalog), batch)

    host_a = snap(pods)[0]
    first = tenant_tick(pods, 1, random.Random(TENANT_TICK_SEED))
    return largest_delta(host_a, *snap(first)[::3])


def staging_peaks(store_cls, solve_mod):
    """Wrap the residency store's ``stage`` and the row apply: each stage
    call records (memory allocated at its start, its peak
    max_memory_allocated, the bytes of the largest buffer it row-applied),
    appended to the returned list. Returns (records, undo)."""
    import torch

    records = []
    stage, apply = store_cls.stage, solve_mod.delta_apply_rows
    largest = [0]

    def apply_rows(arr, idx, rows):
        largest[0] = max(largest[0], arr.numel() * arr.element_size())
        return apply(arr, idx, rows)

    def staged(self, *a, **k):
        torch.cuda.synchronize()
        largest[0] = 0
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = stage(self, *a, **k)
        torch.cuda.synchronize()
        records.append((start, torch.cuda.max_memory_allocated(), largest[0]))
        return out

    store_cls.stage, solve_mod.delta_apply_rows = staged, apply_rows

    def undo():
        store_cls.stage, solve_mod.delta_apply_rows = stage, apply

    return records, undo


def swapped_deployments():
    """(pods, the pods a tick later, pools, catalog) of a small tenant
    batch: QUEUE_STALE_DEPLOYS Deployments over 4 tainted pools and 60
    types, then 10 of them swapped for new ones. The swap changes group
    rows, which a consolidation batch's shared encoding stages as row
    deltas (its per-scenario g_count and n_tol are staged apart)."""
    from karpenter_tpu_torch.cloudprovider import corpus
    from karpenter_tpu_torch.solver.example import tenant_pods, tenant_pools

    pods = tenant_pods(QUEUE_STALE_DEPLOYS, 4)
    gone = {f"d{i}" for i in range(10)}
    tick = [p for p in pods if p.metadata.labels["app"] not in gone] + tenant_pods(
        10, 4, seed=99, first=QUEUE_STALE_DEPLOYS)
    return pods, tick, tenant_pools(4), corpus.generate(60)


def phase_queue(torch_solver_cls, config_cls, encode_cache_cls, e2e=None, cons=None,
                b8_inputs=None):
    """Phase 17: the dispatch queue (A15) and B8's donated row apply. (a)
    a warm mixed N_PODS x N_TYPES solve and a warm CONS_SCENARIOS
    consolidation batch (phase 15's inputs) under a tracer: each dispatch
    one queue.depth 1 at its submit and 0 at its drain, labelled "pack" /
    "scenarios", no eviction; launches per dispatch those of phase 3's
    solve and phase 4's multi-node search (``e2e``, ``cons``; without
    them, each path kernel once a dispatch); whether the card was still
    busy when submit returned, logged; solver_dispatch_queue_depth 0 after
    a provisioning solve. (b) a DISPATCH_QUEUE fault at submit and at
    drain: the batch declines, the breaker records it on the batched rung
    (not a card fault), compute_command over LADDER_NODES gives the
    fault-free command, and without a ladder the fault raises. (c) three
    submit_scenarios without a collect: depth 2 and one queue.evict;
    collecting the three gives what collecting each alone gives;
    memory_allocated back to its baseline once the tokens are dropped.
    (d) KTPU_DONATE_DELTA=1: phase 5's protocol (warm-ups and N_TICKS
    constrained churn ticks) decides as the plain loop, every tick through
    the in-place entry and never the out-of-place B8, each tick's staging
    peak (over the staging's start) lower than the plain tick's by at least
    the largest buffer it row-applied; the in-place entry's rows at the
    constrained tick's and the tenant tick's largest delta
    (b8_inplace_row; ``b8_inputs``: phase 2's and phase 9's largest_delta
    as "tick" and "tenant", made here where not given); a tensor donated
    away raising at the row apply and
    at a stale queue token's resubmit; one constrained churn tick on phase
    16's mesh of 8 positions of the card under donation == the
    single-device tick."""
    import gc
    import random

    import torch

    from karpenter_tpu_torch import _build, faults, obs
    from karpenter_tpu_torch.controllers import provisioning
    from karpenter_tpu_torch.controllers.disruption.helpers import ScenarioSimulator
    from karpenter_tpu_torch.faults.breaker import SolverHealth
    from karpenter_tpu_torch.kube import TestClock
    from karpenter_tpu_torch.ops import solve as solve_mod
    from karpenter_tpu_torch.parallel import mesh as pm
    from karpenter_tpu_torch.solver import workloads as wl
    from karpenter_tpu_torch.solver.driver import Scenario
    from karpenter_tpu_torch.solver.residency import DeviceResidentArgs

    out = {"launches": {}, "secs": {}}
    t0 = time.perf_counter()

    def part(label):
        nonlocal t0
        now = time.perf_counter()
        out["secs"][label] = now - t0
        t0 = now

    # (a) the queue on the main path
    def busy_on_submit(solver):
        seen = []
        submit = solver._queue.submit

        def traced_submit(label, fn):
            slot = submit(label, fn)
            ev = torch.cuda.Event()
            ev.record()
            seen.append(not ev.query())
            return slot

        solver._queue.submit = traced_submit
        return seen

    def traced(fn):
        """fn() under a tracer, inside a span of its own: the queue's
        events attach to the open span, and the scenario submit runs
        outside the solver's spans."""
        tracer = obs.install(obs.Tracer(obs.PerfClock()))
        try:
            with obs.span("queue.check"):
                res = fn()
            torch.cuda.synchronize()
        finally:
            obs.uninstall()
        return res, queue_events(tracer)

    cache = encode_cache_cls()
    pods = wl.mixed_pods(N_PODS)
    build_batch(torch_solver_cls, config_cls, pods, N_TYPES, cache=cache).solve(pods)
    solver = build_batch(torch_solver_cls, config_cls, pods, N_TYPES, cache=cache)
    busy = busy_on_submit(solver)
    _build.reset_launches()
    res, events = traced(lambda: solver.solve(pods))
    counts = dict(_build.launches)
    out["launches"]["queue_solve"] = counts
    n = solver.last_dispatches
    if res.pod_errors or solver.fallback_solves:
        raise SmokeFailure(f"queue solve: {len(res.pod_errors)} errors, fallbacks "
                           f"{solver.last_fallback_reasons}")
    queue_pairs_ok("queue solve", events, "pack", n)
    kernels = PATH_KERNELS["50k"]
    want = ({k: 1.0 for k in kernels} if e2e is None else
            per_dispatch(e2e["launches"]["50k"], e2e["dispatches"]["50k"], kernels))
    if per_dispatch(counts, n, kernels) != want:
        raise SmokeFailure(f"queue solve: launches {counts} over {n} dispatches, phase 3 {want}")
    out["solve"] = dict(dispatches=n, busy=busy, depth=solver._queue.depth())

    ctx, _, candidates, _ = wl.build_consolidation_env(CONS_NODES, "cuda")
    sim = ScenarioSimulator(ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
                            encode_cache=ctx.encode_cache, solver_config=ctx.solver_config)
    bsolver = sim._solver
    chunks = [[[c] for c in candidates[i * CONS_SCENARIOS:(i + 1) * CONS_SCENARIOS]]
              for i in range(3)]

    def batch(chunk):
        return bsolver.solve_scenarios(sim._scenarios_of(chunk))

    batch(chunks[0])
    busy = busy_on_submit(bsolver)
    _build.reset_launches()
    bres, events = traced(lambda: batch(chunks[0]))
    counts = dict(_build.launches)
    out["launches"]["queue_batch"] = counts
    n = bsolver.last_scenario_dispatches
    if bres is None or len(bres) != CONS_SCENARIOS:
        raise SmokeFailure("queue batch: the consolidation batch declined")
    queue_pairs_ok("queue batch", events, "scenarios", n)
    kernels = ("fresh_feasibility",) + CONS_KERNELS
    want = ({k: 1.0 for k in kernels} if cons is None else
            per_dispatch(cons["multi"]["launches"], cons["multi"]["dispatches"], kernels))
    if per_dispatch(counts, n, kernels) != want:
        raise SmokeFailure(f"queue batch: launches {counts} over {n} dispatches, phase 4 {want}")
    out["batch"] = dict(dispatches=n, busy=busy, depth=bsolver._queue.depth())
    del bsolver._queue.submit

    gauge = provisioning.DISPATCH_QUEUE_DEPTH
    gauge.clear()
    _build.reset_launches()
    operator_claims(wl.mixed_pods(QUEUE_OPERATOR_PODS), N_TYPES, 1)
    out["launches"]["queue_operator"] = dict(_build.launches)
    if gauge.collect() != [("gauge", gauge.name, {}, 0.0)]:
        raise SmokeFailure(f"solver_dispatch_queue_depth after a provisioning solve: "
                           f"{gauge.collect()}")

    part("a")

    # (b) DISPATCH_QUEUE faults on the card
    def search(health=None):
        ctx, method, cands, budgets = wl.build_consolidation_env(LADDER_NODES, "cuda")
        ctx.solver_config = config_cls(device="cuda", health=health)
        cmd = method.compute_command(cands, budgets)
        torch.cuda.synchronize()
        return command_signature(cmd)

    def rule(op):
        return faults.install(faults.FaultInjector([faults.FaultRule(
            faults.DISPATCH_QUEUE, match=lambda ctx: ctx.get("op") == op, times=1)]))

    clean = search()
    out["faults"] = {}
    for op in ("submit", "drain"):
        health = SolverHealth(TestClock())
        sim_h = ScenarioSimulator(ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
                                  encode_cache=ctx.encode_cache,
                                  solver_config=config_cls(device="cuda", health=health))
        inj = rule(op)
        try:
            declined = sim_h._solver.solve_scenarios(sim_h._scenarios_of(chunks[0])) is None
        finally:
            faults.uninstall()
        rec = health.export_state()["breakers"]
        inj_cmd = rule(op)
        try:
            cmd = search(SolverHealth(TestClock()))
        finally:
            faults.uninstall()
        raised = None
        sim_n = ScenarioSimulator(ctx.client, ctx.cluster, ctx.cloud_provider, candidates,
                                  encode_cache=ctx.encode_cache, solver_config=ctx.solver_config)
        rule(op)
        try:
            sim_n.solve([[c] for c in candidates[:2]])
        except faults.InjectedFault as exc:
            raised = type(exc).__name__
        finally:
            faults.uninstall()
        ok = (declined and inj.fired(faults.DISPATCH_QUEUE) == 1
              and rec["batched"]["failures"] == 1 and rec["kernel"]["failures"] == 0
              and cmd == clean and inj_cmd.fired(faults.DISPATCH_QUEUE) == 1
              and raised == "InjectedFault")
        if not ok:
            raise SmokeFailure(f"queue fault at {op}: declined {declined}, fired "
                               f"{inj.fired(faults.DISPATCH_QUEUE)}, breakers {rec}, command "
                               f"== fault-free {cmd == clean}, without a ladder {raised}")
        out["faults"][op] = dict(batched_failures=rec["batched"]["failures"],
                                 command=cmd[0], raised=raised)

    part("b")

    # (c) eviction
    alone = []
    for chunk in chunks:
        tok = bsolver.submit_scenarios(sim._scenarios_of(chunk))
        alone.append([decisions(r, [p for s in tok["scenarios"] for p in s.pods])
                      for r in bsolver.collect_scenarios(tok)])
        del tok
    gc.collect()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    tracer = obs.install(obs.Tracer(obs.PerfClock()))
    try:
        with obs.span("queue.evict_check"):
            tokens = [bsolver.submit_scenarios(sim._scenarios_of(chunk)) for chunk in chunks]
            depth = bsolver._queue.depth()
            together = [[decisions(r, [p for s in tok["scenarios"] for p in s.pods])
                         for r in bsolver.collect_scenarios(tok)] for tok in tokens]
        torch.cuda.synchronize()
    finally:
        obs.uninstall()
    evicts = [e for e in queue_events(tracer) if e[0] == "queue.evict"]
    del tokens
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if depth != 2 or evicts != [("queue.evict", {"label": "scenarios"})]:
        raise SmokeFailure(f"eviction: depth {depth} after three submits, evictions {evicts}")
    if together != alone:
        raise SmokeFailure("eviction: the three tokens collected together decide otherwise "
                           "than each collected alone")
    if after > baseline:
        raise SmokeFailure(f"eviction: memory_allocated {after} B after the tokens were "
                           f"dropped, baseline {baseline} B")
    out["evict"] = dict(depth=depth, evictions=len(evicts), baseline=baseline, after=after)
    del ctx, sim, bsolver, bres
    gc.collect()
    torch.cuda.empty_cache()

    part("c")

    # (d) donation: phase 5's churn protocol on two caches in lockstep, one
    # plain and one donating, over the same tick pods
    records, undo = staging_peaks(DeviceResidentArgs, solve_mod)
    caches = {"0": encode_cache_cls(), "1": encode_cache_cls()}
    labels = {"0": "queue_plain_ticks", "1": "donated_ticks"}
    tick_counts = {flag: {} for flag in caches}
    tpods = wl.constrained_mix(N_PODS)
    rng = random.Random(wl.CHURN_SEED)
    out["ticks"] = []
    try:
        for flag, cache in caches.items():
            with donating(flag):
                build_batch(torch_solver_cls, config_cls, tpods, N_TYPES_C,
                            cache=cache).solve(tpods)
        for i in range(N_TICKS):
            tpods = wl.churn_tick(tpods, wl.constrained_mix, rng)
            tick = {}
            gc.collect()
            for flag, cache in caches.items():
                s = build_batch(torch_solver_cls, config_cls, tpods, N_TYPES_C, cache=cache)
                del records[:]
                _build.reset_launches()
                with donating(flag):
                    res = s.solve(tpods)
                torch.cuda.synchronize()
                counts = dict(_build.launches)
                for k, v in counts.items():
                    tick_counts[flag][k] = tick_counts[flag].get(k, 0) + v
                if s.fallback_solves or cache.device_store.last_delta_rows < 1:
                    raise SmokeFailure(f"{labels[flag]}: fallbacks {s.last_fallback_reasons}, "
                                       f"device delta rows {cache.device_store.last_delta_rows}")
                start, peak, largest = max(records, key=lambda r: r[2])
                tick[flag] = dict(decisions=decisions(res, tpods), start=start, peak=peak,
                                  largest=largest, inplace=counts["apply_rows_inplace"],
                                  out_of_place=counts["apply_rows"])
            p, d = tick["0"], tick["1"]
            if d["decisions"] != p["decisions"]:
                raise SmokeFailure(f"donated tick {i + 1}: decisions differ from the plain "
                                   "tick's")
            if d["inplace"] < 1 or d["out_of_place"] or p["inplace"] or p["out_of_place"] < 1:
                raise SmokeFailure(f"donated tick {i + 1}: in-place/out-of-place launches "
                                   f"{d['inplace']}/{d['out_of_place']}, plain {p['inplace']}/"
                                   f"{p['out_of_place']}")
            plain_rise, donated_rise = p["peak"] - p["start"], d["peak"] - d["start"]
            if plain_rise - donated_rise < p["largest"]:
                raise SmokeFailure(f"donated tick {i + 1}: staging peak {d['peak']} B "
                                   f"({donated_rise} B over its start) vs plain {p['peak']} B "
                                   f"({plain_rise} B), largest updated buffer {p['largest']} B")
            out["ticks"].append(dict(plain_peak=p["peak"], donated_peak=d["peak"],
                                     plain_rise=plain_rise, donated_rise=donated_rise,
                                     largest=p["largest"], inplace=d["inplace"]))
    finally:
        undo()
    for flag, label in labels.items():
        out["launches"][label] = tick_counts[flag]
    del caches
    gc.collect()
    torch.cuda.empty_cache()

    part("d ticks")
    b8_inputs = dict(b8_inputs or {})
    for key, make in (("tick", tick_b8_inputs), ("tenant", tenant_b8_inputs)):
        if key not in b8_inputs:
            b8_inputs[key] = make(torch_solver_cls, config_cls, encode_cache_cls)
    part("d inputs")
    out["rows"] = {"apply_rows_inplace": b8_inplace_row(b8_inputs["tick"])}
    out["tenant_row"] = b8_inplace_row(b8_inputs["tenant"])
    for label, row in (("tick", out["rows"]["apply_rows_inplace"]),
                       ("tenant tick", out["tenant_row"])):
        if row["max_abs_err"]:
            raise SmokeFailure(f"B8 in place at the {label}'s delta: error {row['max_abs_err']}")

    # a tensor donated away raises: at the row apply, and at a stale
    # queue token's resubmit after a donating tick on the same cache
    stale = torch.arange(12, dtype=torch.int32, device="cuda").reshape(4, 3)
    with donating("1"):
        solve_mod.delta_apply_rows(stale, torch.ones(1, dtype=torch.int32, device="cuda"),
                                   torch.zeros((1, 3), dtype=torch.int32, device="cuda"))
        raised = {}
        try:
            solve_mod.delta_apply_rows(stale, torch.ones(1, dtype=torch.int32, device="cuda"),
                                       torch.zeros((1, 3), dtype=torch.int32, device="cuda"))
        except ValueError as exc:
            raised["apply"] = str(exc)
        cache = encode_cache_cls()
        spods, tick, pools, catalog = swapped_deployments()

        def sbatch(batch):
            return build_batch(torch_solver_cls, config_cls, batch, 0, cache=cache,
                               pools=pools, its=catalog)

        warm = sbatch(spods)
        first = warm.solve_scenarios([Scenario(pods=spods)])
        token = warm.submit_scenarios([Scenario(pods=spods)])
        _build.reset_launches()
        sbatch(tick).solve_scenarios([Scenario(pods=tick)])
        donated_n = _build.launches["apply_rows_inplace"]
        kept = decisions(warm.collect_scenarios(token)[0], spods) == decisions(first[0], spods)
        try:
            warm._submit_scenario_dispatch(token)
        except Exception as exc:  # noqa: BLE001 - any raise is the contract
            raised["token"] = f"{type(exc).__name__}: {exc}"
        torch.cuda.synchronize()
    if set(raised) != {"apply", "token"} or not donated_n or not kept:
        raise SmokeFailure(f"donated away: raised {raised}, in-place launches {donated_n}, "
                           f"the token's own outputs kept {kept}")
    out["stale"] = raised
    part("d rows and stale")

    # one constrained churn tick on the mesh of 8 positions of the card
    m8 = pm.make_mesh(devices=[torch.device("cuda", 0)] * MESH_SHARDS)
    cache_m, cache_1 = encode_cache_cls(), encode_cache_cls()
    mpods = wl.constrained_mix(QUEUE_MESH_PODS)

    def msolver(batch, mesh, cache):
        return build_batch(torch_solver_cls, config_cls, batch, N_TYPES_C, cache=cache,
                           config_kw={"mesh": mesh})

    with donating("1"):
        msolver(mpods, m8, cache_m).solve(mpods)
        msolver(mpods, None, cache_1).solve(mpods)
        mpods = wl.churn_tick(mpods, wl.constrained_mix, random.Random(wl.CHURN_SEED))
        _build.reset_launches()
        sm = msolver(mpods, m8, cache_m)
        res_m = sm.solve(mpods)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        res_1 = msolver(mpods, None, cache_1).solve(mpods)
    out["launches"]["donated_mesh_tick"] = counts
    if decisions(res_m, mpods) != decisions(res_1, mpods):
        raise SmokeFailure("donated mesh tick: decisions differ from the single device's")
    if counts["apply_rows_inplace"] < 1 or counts["apply_rows"] or sm.fallback_solves:
        raise SmokeFailure(f"donated mesh tick: launches {counts}, fallbacks "
                           f"{sm.last_fallback_reasons}")
    mesh_counts_ok("donated mesh tick", counts, sm.last_dispatches, m8.shape, False)
    out["mesh_tick_inplace"] = counts["apply_rows_inplace"]
    part("d mesh")
    return out


def queue_line(q, secs, total_s, smi):
    row, ten = q["rows"]["apply_rows_inplace"], q["tenant_row"]

    def b8(r):
        return (f"[{r['shape']}] {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
                f"({r['device_timing']}, {r['device_per_call']}), L2 cold {r['cold_device_ms']} "
                f"ms vs out-of-place B8 {r['out_of_place_device_ms']:.4f} ms (L2 cold "
                f"{r['out_of_place_cold_device_ms']} ms) and Tensor.index_copy_ "
                f"{r['library_device_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound'][0]:.6f} ms, buffer {r['buffer_bytes']} B, peak rise "
                f"{r['peak_rise']} B vs out of place {r['out_of_place_peak_rise']} B")

    return (
        f"phase 17 dispatch queue and donated row apply ({secs:.0f} s, smoke so far "
        f"{total_s:.0f} s; {smi}): (a) warm mixed {N_PODS} x {N_TYPES} solve "
        f"{q['solve']['dispatches']} dispatch(es), warm S={CONS_SCENARIOS} batch "
        f"{q['batch']['dispatches']}, each queue.depth 1 at submit / 0 at drain, launches per "
        f"dispatch == phases 3 and 4; card still busy when submit returned: solve "
        f"{q['solve']['busy']}, batch {q['batch']['busy']}; solver_dispatch_queue_depth 0 after "
        f"a provisioning solve; (b) DISPATCH_QUEUE fault at " + ", ".join(
            f"{op}: batch declined, batched failures {f['batched_failures']}, command "
            f"{f['command']} == fault-free, without a ladder {f['raised']}"
            for op, f in q["faults"].items())
        + f"; (c) three submits: depth {q['evict']['depth']}, {q['evict']['evictions']} "
        f"eviction, collected == alone, memory_allocated {q['evict']['after']} B <= baseline "
        f"{q['evict']['baseline']} B; (d) KTPU_DONATE_DELTA=1: {N_TICKS} constrained ticks == "
        "the plain ticks, staging peaks (plain/donated, rise over the staging's start, largest "
        "updated buffer) " + "; ".join(
            f"{t['plain_peak']}/{t['donated_peak']} B ({t['plain_rise']}/{t['donated_rise']} B, "
            f"{t['largest']} B, {t['inplace']} in-place launches)" for t in q["ticks"])
        + f"; in place at the tick's largest delta {b8(row)}; at the tenant tick's {b8(ten)}; "
        f"donated away raises: apply ({q['stale']['apply']}), stale token "
        f"({q['stale']['token']}); mesh tick (8 positions) == single device, "
        f"{q['mesh_tick_inplace']} in-place launches; seconds by part "
        + " ".join(f"{k}={v:.1f}" for k, v in q["secs"].items())
    )


def cluster_text(cluster):
    """A scan launch's cluster as csrc/pack_common.cuh:pick_cluster reports
    it: (blocks, such clusters the card holds at once, clusters of the
    kernel's widest)."""
    c, fit, widest = cluster
    return f"{c} blocks ({fit} such clusters fit at once, {widest} of the widest)"


def timed_phase(fn):
    """``fn()``'s result and its wall seconds."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def pin_one_card():
    """The smoke uses one card: expose only the first visible one, so that
    torch.cuda.device_count() is the number of cards it used."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    elif visible.strip():
        os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0].strip()


def main():
    pin_one_card()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from karpenter_tpu_torch import _build
        from karpenter_tpu_torch.ops import packing as packing_mod
        from karpenter_tpu_torch.solver.driver import (
            EncodeCache,
            SolverConfig,
            TorchSolver,
        )
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    logs = _build.build(force=True, verbose=True)
    build_s = time.perf_counter() - t0
    log(f"phase 1 device+build: {smi} | {len(logs)} kernels built in "
        f"{build_s:.2f} s | " + "; ".join(
            f"{name}: {ptxas_summary(text)}" for name, text in logs.items()))

    rows, secs = timed_phase(lambda: phase_kernels(TorchSolver, SolverConfig, EncodeCache))
    b7 = rows["solve_scenarios"]
    log(f"phase 2 kernels==plain ({secs:.0f} s): " + "; ".join(
        f"{k} [{r['shape']}] {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
        f"bound {r['bound'][0]:.6f} ms"
        + (f", by the earlier entry's formula {r['bound_old_formula']:.6f} ms"
           if "bound_old_formula" in r else "")
        + (f", {LIBRARY[k]} {r['library_ms']:.4f} ms" if k in LIBRARY else "")
        + (f"; device alone {r['device_ms']:.4f} ms ({r['device_timing']})"
           if "device_ms" in r else "")
        + (f" vs {r['library_device_ms']:.4f} ms" if "library_device_ms" in r else "") + ")"
        for k, r in rows.items())
        + " | B7 parts " + " ".join(
            f"{k}={b7['part_ms'][k]:.4f}ms(err {b7['parts'][k]})" for k in b7["part_ms"])
        + f", B4[S] on the device alone {b7['part_device_ms']['B4[S]']:.4f} ms "
        f"({b7['part_device_per_call']['B4[S]']}) | B5 cluster "
        + cluster_text(packing_mod.classed_clusters["pack_classed"]))

    e2e, secs = timed_phase(lambda: phase_end_to_end(TorchSolver, SolverConfig, EncodeCache))
    log(f"phase 3 end-to-end ({secs:.0f} s): {N_PODS} pods x {N_TYPES} types -> "
        f"{e2e['claims_50k']} claims, 0 errors, decisions == cpu; "
        f"p50 {e2e['solve_p50_ms']:.1f} ms of "
        + "/".join(f"{t:.1f}" for t in e2e["solve_ms"]) + " ms; phases "
        + " ".join(f"{k}={v:.1f}ms" for k, v in e2e["phase_ms"].items())
        + f"; relax_pods {e2e['relax_pods']}"
        + "; launches " + " ".join(f"{p}={c}" for p, c in e2e["launches"].items()))

    cons, secs = timed_phase(lambda: phase_consolidation())
    log(f"phase 4 consolidation ({secs:.0f} s): " + "; ".join(
        f"{label} {c['decision']} {c['disrupted']} in {c['probes']} probes / "
        f"{c['dispatches']} dispatches == cpu, 0 fallbacks; p50 {c['p50_ms']:.1f} ms of "
        + "/".join(f"{t:.1f}" for t in c["ms"]) + " ms; phases "
        + " ".join(f"{k}={v:.1f}ms" for k, v in c["phase_ms"].items())
        + f"; launches {c['launches']} scenario {c['scenario_launches']}"
        + f" (1 an uncollected prefetch)" * c["prefetched"]
        for label, c in cons.items()))

    con, secs = timed_phase(lambda: phase_constrained(TorchSolver, SolverConfig, EncodeCache))
    log(f"phase 5 constrained loop ({secs:.0f} s): {N_PODS} pods x {N_TYPES_C} types -> "
        f"{con['claims']} "
        f"claims, {con['placed']} placed, {con['errors']} errors, decisions == cpu; "
        f"cold p50 {con['cold_p50_ms']:.1f} ms of " + "/".join(f"{t:.1f}" for t in con["cold_ms"])
        + f" ms; traced cold {con['cold_traced_ms']:.1f} ms: "
        + " ".join(f"{k}={v:.1f}ms" for k, v in con["cold_phases"].items())
        + f"; {N_TICKS} ticks (each == a full re-encode, row deltas, B8, no full "
        f"re-encode) p50 {con['tick_p50_ms']:.1f} ms: " + "; ".join(
            f"{t['ms']:.1f} ms (encode delta rows {t['encode_delta_rows']}, device delta "
            f"rows {t['device_delta_rows']}, full puts {t['full_puts']}, B8 {t['b8']})"
            for t in con["ticks"])
        + f"; traced tick {con['traced_tick']['ms']:.1f} ms: " + " ".join(
            f"{k}={v:.2f}ms" for k, v in con["traced_tick"]["phases"].items())
        + f"; repeat REUSE, 0 full puts, 0 fallbacks; relax_pods {con['relax_pods']}; launches "
        + " ".join(f"{p}={c}" for p, c in con["launches"].items()))

    div, secs = timed_phase(lambda: phase_diverse(TorchSolver, SolverConfig, EncodeCache))
    log(f"phase 6 diverse loop ({secs:.0f} s): {N_DIVERSE} pods x {N_TYPES} types (classed route) -> "
        f"{div['claims']} claims, {div['placed']} placed, {div['errors']} errors, decisions "
        f"== cpu; cold p50 {div['cold_p50_ms']:.1f} ms of "
        + "/".join(f"{t:.1f}" for t in div["cold_ms"])
        + f" ms; traced cold {div['cold_traced_ms']:.1f} ms: "
        + " ".join(f"{k}={v:.1f}ms" for k, v in div["cold_phases"].items())
        + f"; {N_TICKS} ticks (each == a full re-encode, row deltas, B8, no full "
        f"re-encode) p50 {div['tick_p50_ms']:.1f} ms: " + "; ".join(
            f"{t['ms']:.1f} ms (encode delta rows {t['encode_delta_rows']}, device delta "
            f"rows {t['device_delta_rows']}, full puts {t['full_puts']}, B8 {t['b8']})"
            for t in div["ticks"])
        + f"; traced tick {div['traced_tick']['ms']:.1f} ms: " + " ".join(
            f"{k}={v:.2f}ms" for k, v in div["traced_tick"]["phases"].items())
        + "; repeat REUSE, 0 full puts, 0 fallbacks; classed=False solve (B4 with "
        f"contributor counting) == classed solve, {div['per_group_ms']:.1f} ms vs "
        f"{div['classed_ms']:.1f} ms; relax_pods {div['relax_pods']}; launches "
        + " ".join(f"{p}={c}" for p, c in div["launches"].items()))

    rel, secs = timed_phase(lambda: phase_relax(TorchSolver, SolverConfig, EncodeCache))
    log(f"phase 7 relax loop ({secs:.0f} s): (a) config[0] {CONFIG0_PODS} x {CONFIG0_TYPES}: "
        f"{CONFIG0_PODS} routed, {CONFIG0_CLAIMS} claims == cpu in slot order, "
        f"{rel['config0_ms']:.1f} ms; (b) identical {N_IDENT} x {N_TYPES}: {N_IDENT} routed, "
        f"{IDENT_CLAIMS} claims == cpu in slot order, B3 fresh and B9 once per solve, "
        f"B1/B4/B6 once on zeroed counts; cold p50 {statistics.median(rel['ident_cold_ms']):.1f} "
        "ms of " + "/".join(f"{t:.1f}" for t in rel["ident_cold_ms"])
        + f" ms; traced {rel['ident_traced_ms']:.1f} ms: "
        + " ".join(f"{k}={v:.2f}ms" for k, v in rel["ident_phases"].items())
        + f"; {N_TICKS} ticks (each relax-routed, incremental, == a same-vocab re-encode) p50 "
        f"{statistics.median(t['ms'] for t in rel['ticks']):.1f} ms: " + "; ".join(
            f"{t['ms']:.1f} ms (reused {t['reused']}, encode delta rows "
            f"{t['encode_delta_rows']}, device delta rows {t['device_delta_rows']}, full puts "
            f"{t['full_puts']})" for t in rel["ticks"])
        + f"; repeat REUSE; (c) zonal partial {N_ZONAL + N_SOLO} x {N_TYPES}: {ZONAL_ROUTED} "
        f"routed, {ZONAL_BULK_CLAIMS} bulk + {rel['zonal_exact_claims']} exact claims == cpu in "
        f"slot order, {rel['zonal_ms']:.1f} ms; slot order differs from relax off: "
        f"{rel['zonal_order_differs']}; (d) corrupt bulk: relax_rejects 1, == relax off; "
        "launches " + " ".join(f"{p}={c}" for p, c in rel["launches"].items()))

    floors, secs = timed_phase(lambda: phase_floors(TorchSolver, SolverConfig, EncodeCache))
    cells = {k: v for k, v in floors.items() if k != "cons_minvalues"}
    cm = floors["cons_minvalues"]
    log(f"phase 8 floors-and-ledger loop (== cpu in slot order, 0 fallbacks, relax_pods 0) ({secs:.0f} s): " + "; ".join(
        f"{label} -> {c['claims']} claims, {c['errors']} errors"
        + (f", {c['reserved']} holding reservations (<= {RESV_MAX_CLAIMS})"
           if label == "reserved" else "")
        + f", first {c['first_ms']:.1f} ms"
        + (f", cold p50 {c['p50_ms']:.1f} ms of " + "/".join(f"{t:.1f}" for t in c["cold_ms"])
           + " ms" if c["cold_ms"] else "")
        + ", variants " + " ".join(
            f"{k}={c['launches'][k]}" for k in ("pack", "pack_minvalues", "pack_resv",
                                                "pack_domains", "pack_contrib", "pack_classed",
                                                "pack_classed_minvalues") if c["launches"][k])
        for label, c in cells.items())
        + f"; cons_minvalues multi {cm['decision']} {cm['disrupted']} in {cm['probes']} probes / "
        f"{cm['dispatches']} dispatches == cpu, p50 {cm['p50_ms']:.1f} ms of "
        + "/".join(f"{t:.1f}" for t in cm["ms"]) + " ms, scenario launches "
        + " ".join(f"{k}={v}" for k, v in cm["scenario_launches"].items() if v))

    ten, secs = timed_phase(lambda: phase_tenant(TorchSolver, SolverConfig, EncodeCache))
    log(f"phase 9 tenant cell ({secs:.0f} s): {TENANT_PODS} pods ({N_DEPLOY} Deployments) x "
        f"{TENANT_TYPES} types over {N_TENANTS} tainted pools capped at 4,000 CPUs; statics "
        f"{ten['statics']}, tables {ten['table_bytes']} B > gate {TILE_GATE} B -> tiled; "
        f"{ten['claims']} claims, {ten['placed']} placed, {ten['errors']} errors, relax_pods "
        f"{ten['relax_pods']}, 0 fallbacks, {ten['dispatches']} dispatch(es); first "
        f"{ten['first_ms']:.1f} ms, cold p50 {ten['cold_p50_ms']:.1f} ms of "
        + "/".join(f"{t:.1f}" for t in ten["cold_ms"])
        + f" ms ({len(ten['cold_ms'])} fresh EncodeCaches); traced {ten['traced_ms']:.1f} ms: "
        + " ".join(f"{k}={v:.1f}ms" for k, v in ten["phases"].items())
        + f"; (b) dispatch tiled == untiled (max |diff| {ten['dispatch_err']}; tiled "
        f"{ten['dispatch_ms']['tiled']:.1f} ms, untiled {ten['dispatch_ms']['untiled']:.1f} ms), "
        f"scan alone [{ten['scan_shape']}] tiled {ten['scan_tiled_ms']:.1f} ms, untiled "
        f"{ten['scan_untiled_ms']:.1f} ms (row build by difference "
        f"{ten['scan_tiled_ms'] - ten['scan_untiled_ms']:.1f} ms), Results == the untiled "
        f"solve's in slot order; (c) {TENANT_TICKS} ticks of {TENANT_SWAP} Deployments (each == "
        "a same-vocab re-encode, row deltas, B8): " + "; ".join(
            f"{t['ms']:.1f} ms (encode delta rows {t['encode_delta_rows']}, device delta rows "
            f"{t['device_delta_rows']}, full puts {t['full_puts']}, B8 {t['b8']})"
            for t in ten["ticks"])
        + f"; B8 at the first tick's largest delta [{ten['b8_tick']['shape']}] "
        f"{ten['b8_tick']['ms']:.4f} ms ({LIBRARY['apply_rows']} "
        f"{ten['b8_tick']['library_ms']:.4f} ms), device alone "
        f"{ten['b8_tick']['device_ms']:.4f} ms vs {ten['b8_tick']['library_device_ms']:.4f} ms"
        f"; repeat REUSE; (d) classed=True (B5 tiled) == B4, {ten['classed_ms']:.1f} ms, "
        f"B5 cluster {cluster_text(ten['classed_cluster'])}; "
        f"(e) scenario batch of {ten['scenario_pods']} pods (B7 tiled) == solves of its pods, "
        f"{ten['scenarios_ms']:.1f} ms; launches "
        + " ".join(f"{p}={c}" for p, c in ten["launches"].items()))

    wide, secs = timed_phase(lambda: phase_wide(TorchSolver, SolverConfig, EncodeCache))
    log(f"phase 10 wide value vocabularies (each cold card solve returns Results, == cpu in slot "
        f"order, 0 fallbacks) ({secs:.0f} s): " + "; ".join(
            f"{label} K={w['K']} V1={w['V1']} MW={w['MW']} G={w['G']} T={w['T']} -> "
            f"{w['claims']} claims, {w['errors']} errors, relax_pods {w['relax_pods']}, first "
            f"{w['first_ms']:.1f} ms"
            + (f", p50 {w['p50_ms']:.1f} ms of " + "/".join(f"{t:.1f}" for t in w["ms"])
               + f" ms (mixed 50k x {N_TYPES}, phase 3: {e2e['solve_p50_ms']:.1f} ms); traced "
               + " ".join(f"{k}={v:.1f}ms" for k, v in w["spans"].items())
               if "p50_ms" in w else "")
            + f", == cpu at {w['cpu_pods']} pods; B1 {w['layout']['b1']}"
            + (f"; B3 {w['layout']['b3']}" if "b3" in w["layout"] else "")
            + "; scans " + " ".join(f"{k}: {v['smem']} B shared, {v['spill']} B spilled"
                                    for k, v in w["layout"]["scans"].items())
            + "; launches " + " ".join(f"{k}={v}" for k, v in w["launches"].items() if v)
            for label, w in wide.items()))

    lad, secs = timed_phase(lambda: phase_ladder(TorchSolver, SolverConfig))
    sc = lad["scenarios"]
    log(f"phase 11 degradation ladder ({secs:.0f} s; SolverHealth(failure_threshold=1, cooldown="
        f"{LADDER_COOLDOWN:.0f} s) on an injected clock): mixed {LADDER_PODS} x {N_TYPES} "
        f"({lad['solves_s']:.1f} s): (a) SOLVER_DISPATCH fault -> rung "
        f"{lad['dispatch_fault']['rung']}, == force_oracle, health {lad['dispatch_fault']['health']}; "
        f"(b) breaker open -> oracle; (c) after the cool-down rung {lad['recovered']['rung']}, == "
        f"the health=None card solve in slot order ({lad['recovered']['claims']} claims), health "
        f"{lad['recovered']['health']}; (d) SOLVER_OUTPUT corruption -> rung "
        f"{lad['corrupt_output']['rung']}, guard {lad['corrupt_output']['guard']}, == force_oracle, "
        f"health {lad['corrupt_output']['health']}; (e) backend=native == the card's exact route "
        f"({lad['native_claims']} claims); consolidation at {LADDER_NODES} nodes "
        f"({lad['search_s']:.1f} s): (f) batched {sc['decision']} {sc['disrupted']} in "
        f"{sc['probes']} probes / {sc['dispatches']} dispatches; SOLVER_SCENARIOS fault -> per-probe "
        f"replay ({sc['per_probe']} probes, {sc['per_probe_dispatches']} single dispatches), == the "
        f"batched command, health {sc['health']}; "
        f"(g) without health the fault raises; a fault of the card, not injected, propagates "
        f"with the ladder untouched: (h) launch {lad['card_faults']['launch']}, (i) guard "
        f"{lad['card_faults']['guard']}, (j) the batch's launch "
        f"{lad['card_faults']['search_launch']}; launches " + "; ".join(
            f"{p}: " + " ".join(f"{k}={v}" for k, v in c.items() if v)
            for p, c in lad["launches"].items()))

    side, secs = timed_phase(lambda: phase_sidecar())
    log(f"phase 12 solver sidecar ({secs:.0f} s; serve(max_workers={SIDECAR_WORKERS}), the "
        f"batch lane with batch_window={SIDECAR_WINDOW} s, max_batch={SIDECAR_TENANTS}): (a) solo "
        f"lane, t0 mixed {SIDECAR_PODS} x {N_TYPES}: request {side['request_bytes']} B "
        f"(< {GRPC_RECEIVE_LIMIT}), response {side['response_bytes']} B == the in-process card "
        f"solve's == the device=\"cpu\" solve's, {side['solo_claims']} claims, "
        f"{side['solo_ms']:.1f} ms through the hop vs {side['in_process_ms']:.1f} ms in process; "
        f"(b) batch lane, {SIDECAR_TENANTS} tenants x {SIDECAR_TENANT_PODS} pods at once: arrivals "
        f"at the batcher spread over {side['arrival_spread_ms']:.1f} ms, 1 batched, 0 declined, "
        "one scenario dispatch (scenario launches " + " ".join(
            f"{k}={v}" for k, v in side["scenario_launches"]["sidecar_batch"].items() if v)
        + "), each tenant == its solo card solve == the device=\"cpu\" union (claims "
        + " ".join(f"{k}={v}" for k, v in side["batch_claims"].items())
        + f"), {side['batch_ms']:.1f} ms; (c) over its token bucket -> {side['backpressure']}, "
        f"no in-process solve; past its deadline -> DEADLINE_EXCEEDED x "
        f"{side['deadline']['overruns']}, fallback_solves {side['deadline']['fallback_solves']}"
        f" on the card, == the in-process solve; a launch error in the batch lane, not "
        f"injected -> " + " ".join(f"{k}={v}" for k, v in side["card_fault"].items())
        + ", no participant solved solo; launches " + "; ".join(
            f"{p}: " + " ".join(f"{k}={v}" for k, v in c.items() if v)
            for p, c in side["launches"].items()))

    oper, secs = timed_phase(lambda: phase_operator(side["server"]))
    side["server"].stop(0)
    log(f"phase 13 operator ({secs:.0f} s): kwok, corpus.generate({N_TYPES}), mixed "
        f"{OPERATOR_PODS} pending -> {oper['claims']} NodeClaims holding "
        f"{oper['pods_on_claims']} pods in {oper['steps']} steps ({oper['pending']} pending), "
        f"== the device=\"cpu\" run, == through phase 12's sidecar; {oper['operator_s']:.1f} s "
        f"on the card, {oper['cpu_s']:.1f} s on the CPU, {oper['operator_remote_s']:.1f} s "
        "through the sidecar; launches " + "; ".join(
            f"{p}: " + " ".join(f"{k}={v}" for k, v in c.items() if v)
            for p, c in oper["launches"].items()))

    twin, secs = timed_phase(phase_twin)
    log(twin_line(twin, secs, smi))

    audit, secs = timed_phase(lambda: phase_sync_audit(TorchSolver, SolverConfig, EncodeCache))
    log(sync_line(audit, secs, smi))

    mesh, secs = timed_phase(lambda: phase_mesh(TorchSolver, SolverConfig, EncodeCache))
    log(mesh_line(mesh, secs, time.perf_counter() - t0, smi))
    rows.update(mesh["rows"])

    b8_inputs = {"tick": rows["apply_rows"].pop("inputs"), "tenant": ten.pop("b8_inputs")}
    queue, secs = timed_phase(lambda: phase_queue(TorchSolver, SolverConfig, EncodeCache,
                                                  e2e=e2e, cons=cons, b8_inputs=b8_inputs))
    log(queue_line(queue, secs, time.perf_counter() - t0, smi))
    rows.update(queue["rows"])

    # every path's own counts: the solves, the searches, the five loops,
    # the ladder, the sidecar, the operator, the twin
    paths = dict(e2e["launches"])
    paths.update({label: c["launches"] for label, c in cons.items()})
    paths.update(con["launches"])
    paths.update(div["launches"])
    paths.update(rel["launches"])
    paths.update({label: c["launches"] for label, c in cells.items()})
    paths["cons_minvalues"] = cm["launches"]
    paths.update(ten["launches"])
    paths.update({label: w["launches"] for label, w in wide.items()})
    paths.update(lad["launches"])
    paths.update(side["launches"])
    paths.update(oper["launches"])
    paths.update(twin["launches"])
    paths.update(mesh["launches"])
    paths.update(queue["launches"])
    scen_paths = {label: c["scenario_launches"] for label, c in cons.items()}
    scen_paths["ladder_scenarios"] = lad["scenario_launches"]
    scen_paths["sidecar_batch"] = side["scenario_launches"]["sidecar_batch"]
    scen_paths.update(twin["scenario_launches"])
    kernels = []
    for name, row in rows.items():
        bms, by = row["bound"]
        if name == "solve_scenarios":  # B7: the S > 1 dispatches of the searches
            by_path = {p: c["pack"] for p, c in scen_paths.items()}
            source = "karpenter_tpu_torch/csrc/pack.cu"
            extra = dict(sources=[f"karpenter_tpu_torch/csrc/{k}.cu" for k in B7_SOURCES],
                         parts_ms=row["part_ms"], parts_device_ms=row["part_device_ms"])
        elif name == "scenarios_minvalues":  # B7 over floors: phase 8's search
            by_path = {"cons_minvalues": cm["scenario_launches"]["pack_minvalues"]}
            source = "karpenter_tpu_torch/csrc/pack.cu"
            extra = dict(sources=[f"karpenter_tpu_torch/csrc/{k}.cu" for k in B7_SOURCES],
                         parts_ms=row["part_ms"], parts_device_ms=row["part_device_ms"])
        elif name in SHAPE_ROWS:  # B1/B2 at another shape of their paths
            kernel, at = SHAPE_ROWS[name]
            by_path = {p: paths[p][kernel] for p in at}
            source = f"karpenter_tpu_torch/csrc/{SOURCES.get(kernel, kernel)}.cu"
            extra = {"kernel": kernel}
        elif name == "scenarios_tiled":  # B7's grid tiled: phase 9's scenario batch
            by_path = {"tenant_scenarios": ten["scenario_launches"]["pack_tiled"]}
            source = "karpenter_tpu_torch/csrc/pack.cu"
            extra = dict(sources=["karpenter_tpu_torch/csrc/pack.cu",
                                  "karpenter_tpu_torch/csrc/wire_pack.cu"])
        else:
            by_path = {p: c[name] for p, c in paths.items()}
            source = f"karpenter_tpu_torch/csrc/{SOURCES.get(name, name)}.cu"
            extra = {"library": LIBRARY[name]} if name in LIBRARY else {}
        if "cells" in row:  # the tiled rows' cells
            extra["cells"] = row["cells"]
        if name == "apply_rows":  # the library's device-only time; the tenant tick's delta
            extra.update({k: row[k] for k in ("library_device_ms", "library_device_per_call")},
                         tenant_tick={k: v for k, v in ten["b8_tick"].items() if k != "bound"})
        if name == "apply_rows_inplace":  # beside B8 out of place; the tenant tick's delta
            extra.update({k: row[k] for k in (
                "library_device_ms", "library_device_per_call", "out_of_place_device_ms",
                "out_of_place_per_call", "cold_device_ms", "out_of_place_cold_device_ms",
                "peak_rise", "out_of_place_peak_rise", "buffer_bytes")},
                tenant_tick={k: v for k, v in queue["tenant_row"].items() if k != "bound"},
                staging_peaks=queue["ticks"])
        if name in ("pack_wide", "pack_listed", "pack_mv_wide"):  # the scan's layout there
            extra.update({k: row[k] for k in ("shape", "smem_bytes", "spill_bytes")})
        if name == "pack_tiled":  # the scan alone at the tenant cell's full depth
            extra["tenant_cell_ms"] = ten["scan_tiled_ms"]
        if name == "mesh_fold":  # the earlier yardstick, over the partials as a list
            extra.update(library_stack=LIBRARY_STACK, library_stack_ms=row["library_stack_ms"])
        if name == "relax_fill":  # the bound by the earlier entry's formula
            extra["bound_ms_old_formula"] = row["bound_old_formula"]
        kernels.append(dict(
            name=name, route="cuda", source=source,
            replaces=REPLACES[name],
            launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=bms, bound_by=by, library_ms=row.get("library_ms"),
            device_ms=row["device_ms"], device_timing=row["device_timing"],
            device_per_call=row["device_per_call"],
            **extra,
        ))
    # the cluster each scenario count's B4 launches took in this run, and
    # B5's, as csrc/pack_common.cuh:pick_cluster reported them
    log("B4/B7 clusters: " + ", ".join(
        f"S={n}: {cluster_text(c)}" for n, c in sorted(packing_mod.clusters.items()))
        + "; B5: " + cluster_text(packing_mod.classed_clusters["pack_classed"]))
    log(f"smoke: {time.perf_counter() - t0:.0f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),  # 1: pin_one_card
    }}))
    return 0


def stop_resource_tracker():
    """Stop and reap multiprocessing's resource tracker, which the spawned
    children of phases 10 and 14 start: left to exit after this process,
    it outlives it as a zombie that nothing reaps on the card's machine."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_resource_tracker()
    sys.exit(rc)
