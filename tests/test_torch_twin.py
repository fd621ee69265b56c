"""The port's digital twin (karpenter_tpu_torch/sim/trace.py, slo.py,
twin.py) on the CPU, against the JAX package's.

The churn traces are byte for byte the JAX package's for the same seed
and profile. The port's twin (``SolverConfig(device="cpu")``) replays the
JAX package's small chaos replay (``tests/e2e/test_twin.py``'s shapes,
run to minute 8 so that consolidation searches fire) into the same
canonical audit bytes, fault log, minute reports (less their wall-clock
fields) and final NodeClaims, and its SLO sweeps read the same numbers
off the same stores. The port's own replay is deterministic, and a
checkpoint resumed through ``pickle`` replays byte-identically, each
resumed operator on its own ``SolverHealth``. No test bounds wall-clock
time: the p99 decision latency SLO is unbounded here.
"""

import copy
import math
import pickle

import pytest
import torch

import twin_cases as tc

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"
# the parity replay: the small shapes run past consolidate_after (300 s)
PARITY_MINUTES = 8


@pytest.fixture(autouse=True)
def _no_leaked_seams():
    yield
    for pkg in (JAX, PORT):
        tc.release_seams(pkg)


def port_twin(**overrides):
    twin = tc.mod(PORT, "sim.twin")
    return twin.ClusterTwin(
        tc.small_trace(PORT), profile=tc.small_profile(PORT),
        config=tc.small_config(PORT, device="cpu", **overrides),
        fault_rules=tc.chaos_plan(PORT))


# -- traces ------------------------------------------------------------------

TRACE_PROFILES = {
    "default-6": dict(minutes=6),
    "weather-12": dict(minutes=12, pods_per_minute=8, reclaim_minutes=(2, 7),
                       reclaim_count=4, ice_minutes=(4,), ice_cells=6),
}


@pytest.mark.parametrize("seed", [3, 7, 101])
@pytest.mark.parametrize("profile", sorted(TRACE_PROFILES))
def test_trace_bytes_equal_jax(seed, profile):
    dumps = [
        tc.mod(pkg, "sim.trace").dump_jsonl(tc.mod(pkg, "sim.trace").generate(
            seed, tc.mod(pkg, "sim.trace").ChurnProfile(**TRACE_PROFILES[profile])))
        for pkg in (JAX, PORT)
    ]
    assert dumps[0] == dumps[1]
    assert dumps[1]


def test_jsonl_round_trip(tmp_path):
    """The port reads back what it and the JAX package write, to the same
    bytes; both wave kinds are in the trace."""
    trace = tc.mod(PORT, "sim.trace")
    events = trace.generate(7, trace.ChurnProfile(
        minutes=4, reclaim_minutes=(1,), ice_minutes=(2,)))
    assert {trace.SPOT_RECLAIM, trace.ICE_WAVE} <= {e.kind for e in events}
    for pkg in (PORT, JAX):
        path = str(tmp_path / f"{pkg}.jsonl")
        writer = tc.mod(pkg, "sim.trace")
        writer.write_jsonl(writer.generate(7, writer.ChurnProfile(
            minutes=4, reclaim_minutes=(1,), ice_minutes=(2,))), path)
        assert trace.dump_jsonl(trace.read_jsonl(path)) == trace.dump_jsonl(events)


def test_unknown_kind_rejected():
    with pytest.raises(ValueError):
        tc.mod(PORT, "sim.trace").TraceEvent.from_dict({"t": 0.0, "kind": "nope"})


# -- the port against the JAX package ----------------------------------------


def _fabricate_faults(pkg, twin):
    """One overcommitted node and one orphaned claim in ``twin``'s store,
    the same in either package, for the sweeps to find, both of the
    fabricated fleet (``twin-<i>``: a launched claim's name comes from a
    process-wide counter, tc.node_claims): the first such node by name
    that holds a pod shrunk to nothing, the last such claim by name with
    a provider id reclaimed, past the orphan grace. Returns their names."""
    objects = tc.mod(pkg, "api.objects")
    busy = {p.spec.node_name for p in twin.client.list(objects.Pod) if p.spec.node_name}
    node = min((n for n in twin.client.list(objects.Node)
                if n.name in busy and n.name.startswith("twin-")), key=lambda n: n.name)
    node.status.allocatable = {k: 1 for k in node.status.allocatable}
    twin.client.update(node)
    claim = max((c for c in twin.client.list(objects.NodeClaim)
                 if c.status.provider_id and c.name.startswith("twin-")
                 and c.status.node_name != node.name), key=lambda c: c.name)
    assert twin.provider.reclaim(claim.status.provider_id)
    twin.clock.step(twin.config.slo.orphan_grace_s + 1)
    return {"overcommitted_nodes": [node.name], "orphaned_claims": [claim.name]}


SWEEPS = ("overcommitted_nodes", "orphaned_claims", "fleet_price", "cost_lower_bound",
          "oracle_pack_price")


def _sweeps(pkg, twin, solver_config):
    slo = tc.mod(pkg, "sim.slo")
    grace = twin.config.slo.orphan_grace_s
    return {
        "overcommitted_nodes": slo.overcommitted_nodes(twin.client),
        "orphaned_claims": slo.orphaned_claims(
            twin.client, twin.provider, twin.clock.now(), grace),
        "fleet_price": slo.fleet_price(twin.client, twin.provider),
        "cost_lower_bound": slo.cost_lower_bound(twin.client, twin.provider),
        "oracle_pack_price": slo.oracle_pack_price(twin.client, twin.provider,
                                                   *solver_config),
    }


@pytest.fixture(scope="module")
def replays():
    """Each package's small chaos replay to PARITY_MINUTES: its artifacts,
    then the SLO sweeps over its final store with one overcommitted node
    and one orphaned claim fabricated in."""
    out = {}
    for pkg in (JAX, PORT):
        device = "cpu" if pkg == PORT else None
        twin = tc.mod(pkg, "sim.twin").ClusterTwin(
            tc.small_trace(pkg), profile=tc.small_profile(pkg),
            config=tc.small_config(pkg, device=device, minutes=PARITY_MINUTES),
            fault_rules=tc.chaos_plan(pkg))
        with twin:
            twin.run()
            art = {
                "canonical_audit": twin.canonical_audit(),
                "fault_log": twin.fault_log(),
                "reports": [tc.deterministic(r) for r in twin.reports],
                "node_claims": tc.node_claims(pkg, twin.client),
                "kinds": sorted({r.kind for r in twin.audit.query()}),
            }
            art["fabricated"] = _fabricate_faults(pkg, twin)
            cfg = (twin.config.solver_config,) if pkg == PORT else ()
            art["sweeps"] = _sweeps(pkg, twin, cfg)
        tc.release_seams(pkg)
        out[pkg] = art
    return out


@pytest.mark.parametrize("artifact", ["canonical_audit", "fault_log", "reports",
                                      "node_claims"])
def test_twin_matches_jax(replays, artifact):
    jax_art, port_art = replays[JAX][artifact], replays[PORT][artifact]
    assert port_art == jax_art
    assert port_art  # the replay decided, the plan bit, claims stand


def test_parity_replay_covers_the_roster(replays):
    """The parity replay reached provisioning and the consolidation search
    (the scenario batch), and the oracle pack ran on its sampled minutes."""
    assert {"solve", "scenarios", "consolidation-multi"} <= set(replays[PORT]["kinds"])
    assert any(r["oracle_price"] is not None for r in replays[PORT]["reports"])


@pytest.mark.parametrize("sweep", SWEEPS)
def test_slo_sweeps_match_jax(replays, sweep):
    port_val = replays[PORT]["sweeps"][sweep]
    assert port_val == replays[JAX]["sweeps"][sweep]
    if sweep in replays[PORT]["fabricated"]:
        assert port_val == replays[PORT]["fabricated"][sweep]
    else:
        assert port_val > 0


# -- the port's own replay ---------------------------------------------------


def _artifacts(twin):
    return twin.canonical_audit(), tuple(twin.fault_log())


@pytest.mark.parametrize("seed,same", [(9, True), (10, False)])
def test_same_seed_byte_identical(seed, same):
    with port_twin() as twin:
        twin.run()
        first = _artifacts(twin)
    tc.release_seams(PORT)
    with port_twin(seed=seed) as twin:
        twin.run()
        second = _artifacts(twin)
    assert first[0].count(b"\n") > 0 and first[1]
    if same:
        assert second == first
    else:
        assert second[1] != first[1]


def test_no_solver_config_means_the_card():
    """A twin without a solver_config solves on CUDA: where there is none
    it raises as SolverConfig does, before it installs a seam."""
    if torch.cuda.is_available():
        pytest.skip("the host has a card: the default config is valid here")
    twin = tc.mod(PORT, "sim.twin")
    obs = tc.mod(PORT, "obs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.ClusterTwin(tc.small_trace(PORT), profile=tc.small_profile(PORT),
                         config=twin.TwinConfig(), fault_rules=tc.chaos_plan(PORT))
    assert obs.active() is None and tc.mod(PORT, "faults").active() is None
    with port_twin() as twin, pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.mod(PORT, "sim.slo").oracle_pack_price(twin.client, twin.provider)


def test_resume_is_byte_identical_to_uninterrupted():
    with port_twin() as twin:
        twin.run()
        full = _artifacts(twin)
    tc.release_seams(PORT)
    interrupted = port_twin()
    interrupted.run_minute()
    interrupted.run_minute()
    ckpt = pickle.loads(pickle.dumps(interrupted.checkpoint()))
    interrupted.close()
    twin = tc.mod(PORT, "sim.twin")
    with twin.ClusterTwin.resume(
        ckpt, tc.small_trace(PORT), profile=tc.small_profile(PORT),
        config=tc.small_config(PORT, device="cpu"), fault_rules=tc.chaos_plan(PORT),
    ) as resumed:
        assert resumed._minute == 2
        resumed.run()
        assert _artifacts(resumed) == full


def test_checkpoint_with_pending_consolidation_command():
    """A command awaiting its validation TTL pickles with its method's
    roster index; resume re-binds the live method at that index."""
    types = tc.mod(PORT, "controllers.disruption.types")
    twin = port_twin()
    twin.run_minute()
    op = twin.operator
    op.disruption._pending = (types.Command(), twin.clock.now(), op.disruption.methods[-1])
    ckpt = pickle.loads(pickle.dumps(twin.checkpoint()))
    twin.close()
    with tc.mod(PORT, "sim.twin").ClusterTwin.resume(
        ckpt, tc.small_trace(PORT), profile=tc.small_profile(PORT),
        config=tc.small_config(PORT, device="cpu"), fault_rules=tc.chaos_plan(PORT),
    ) as resumed:
        pending = resumed.operator.disruption._pending
        assert pending is not None
        assert pending[2] is resumed.operator.disruption.methods[-1]


def test_resume_without_fault_plan_refuses():
    twin = port_twin()
    twin.run_minute()
    ckpt = twin.checkpoint()
    twin.close()
    with pytest.raises(ValueError, match="fault_rules"):
        tc.mod(PORT, "sim.twin").ClusterTwin.resume(
            ckpt, tc.small_trace(PORT), profile=tc.small_profile(PORT),
            config=tc.small_config(PORT, device="cpu"))
    assert tc.mod(PORT, "obs").active() is None


def test_resumed_operator_holds_the_restored_health():
    """One TwinConfig for the interrupted and the resumed twin: the resumed
    operator's SolverHealth is its own, on its own clock, in the restored
    state, and the caller's SolverConfig stays without one (Operator
    writes a fresh SolverHealth into the config it is given)."""
    config = tc.small_config(PORT, device="cpu")
    interrupted = tc.mod(PORT, "sim.twin").ClusterTwin(
        tc.small_trace(PORT), profile=tc.small_profile(PORT), config=config,
        fault_rules=tc.chaos_plan(PORT))
    interrupted.run_minute()
    ckpt = pickle.loads(pickle.dumps(interrupted.checkpoint()))
    old = interrupted.operator.solver_health
    interrupted.close()
    # the interrupted run's health moves on past the checkpoint
    old.delta_fallbacks += 5
    with tc.mod(PORT, "sim.twin").ClusterTwin.resume(
        ckpt, tc.small_trace(PORT), profile=tc.small_profile(PORT), config=config,
        fault_rules=tc.chaos_plan(PORT),
    ) as resumed:
        health = resumed.operator.solver_health
        assert health is not old
        assert health.clock is resumed.clock
        assert health.export_state() == ckpt["health"]
        assert resumed.operator.options.solver_config.health is health
    assert config.solver_config.health is None
    assert resumed.operator.options.solver_config is not config.solver_config


def test_checkpoint_restores_store_and_clock():
    objects = tc.mod(PORT, "api.objects")
    twin = port_twin()
    twin.run_minute()
    ckpt = copy.deepcopy(twin.checkpoint())
    n_pods, n_nodes = len(twin.client.list(objects.Pod)), len(twin.client.list(objects.Node))
    now = twin.clock.now()
    twin.close()
    with tc.mod(PORT, "sim.twin").ClusterTwin.resume(
        ckpt, tc.small_trace(PORT), profile=tc.small_profile(PORT),
        config=tc.small_config(PORT, device="cpu"), fault_rules=tc.chaos_plan(PORT),
    ) as resumed:
        assert resumed.clock.now() == now
        assert len(resumed.client.list(objects.Pod)) == n_pods
        assert len(resumed.client.list(objects.Node)) == n_nodes
        claim_pids = {c.status.provider_id for c in resumed.client.list(objects.NodeClaim)
                      if c.status.provider_id}
        assert claim_pids <= {c.status.provider_id for c in resumed.provider.list()}


def test_latency_sampler_is_wall_clock_only():
    """The wall-clock samples stay outside the records: an unbounded p99
    SLO passes, a near-zero one trips on the same replay's first minute."""
    slo = tc.mod(PORT, "sim.slo")
    with port_twin(slo=slo.SLOConfig(p99_decision_latency_ms=math.inf)) as twin:
        assert twin.run_minute().violations == []
    tc.release_seams(PORT)
    with port_twin(slo=slo.SLOConfig(p99_decision_latency_ms=1e-6)) as twin:
        with pytest.raises(slo.SLOViolationError) as exc:
            twin.run_minute()
    assert any(v.slo == "p99-decision-latency" for v in exc.value.report.violations)


def test_closed_twin_releases_device_state():
    """Operator.shutdown drops the residency stores of the provisioner's and
    the disruption controller's encode caches and the cached scenario
    solvers: a closed twin that stays referenced holds no device buffer
    (on the card, torch.cuda.memory_allocated() does not grow across it)."""
    with port_twin() as twin:
        for _ in range(7):  # past consolidate_after: the searches ran
            twin.run_minute()
        op = twin.operator
        caches = (op.provisioner._encode_cache, op.disruption.ctx.encode_cache)
        assert caches[0].device_store is not None
        assert caches[1].scenario_device_store is not None
        assert op.disruption.ctx.scenario_envs._entries
    assert all(c.device_store is None and c.scenario_device_store is None for c in caches)
    assert not op.disruption.ctx.scenario_envs._entries
