"""The port's wire codec (karpenter_tpu_torch/solver/wire.py) against the
JAX package's.

The same objects (the JAX package's seeded builders, rebuilt from the
port's classes by ``to_port``; the instance-type catalog from each
package's own seeded corpus) encode to byte-identical solve requests and
responses in both packages, and each package decodes the other's bytes
into objects that re-encode to the same bytes.
"""

import pytest

from karpenter_tpu.cloudprovider import corpus as jax_corpus
from karpenter_tpu.solver import wire as jax_wire
from karpenter_tpu.solver import workloads as jax_wl
from karpenter_tpu_torch.cloudprovider import corpus as port_corpus
from karpenter_tpu_torch.solver import wire as port_wire

from helpers import make_nodepool, make_state_node
from test_torch_residency import port_state_node, to_port

N_TYPES = 40


def _state_nodes():
    out = []
    for i in range(3):
        sn = make_state_node(name=f"wire-node-{i}", cpu="8", memory="32Gi")
        sn.node.provider_id = f"ktpu://wire-node-{i}"
        out.append(sn)
    return out


def _daemonset_pods():
    from helpers import make_pod

    pod = make_pod(name="daemon-logs", cpu="100m", memory="128Mi")
    pod.metadata.uid = "uid-daemon-logs"
    return [pod]


# name -> (pods, state nodes, daemonset pods, volume objects (None: the
# old protocol), solver options)
CASES = {
    "mixed": lambda: (jax_wl.mixed_pods(300), [], [], [], {}),
    "constrained": lambda: (jax_wl.constrained_mix(200), [], _daemonset_pods(), [], {}),
    "state_nodes": lambda: (jax_wl.mixed_pods(120, seed=3), _state_nodes(), [], [],
                            {"reserved_capacity_enabled": True}),
    "old_protocol": lambda: (jax_wl.identical_pods(50), [], [], None, {}),
}


def _both(case):
    """The request of ``case`` encoded by each package, from the same
    objects."""
    pods, sns, daemons, volumes, options = CASES[case]()
    pools = [make_nodepool(name="default")]
    jax_req = jax_wire.encode_solve_request(
        pods, pools, {"default": jax_corpus.generate(N_TYPES)}, daemons,
        solver_options=options, state_nodes=sns,
        volume_objects=volumes if volumes is not None else (),
    )
    port_req = port_wire.encode_solve_request(
        to_port(pods), to_port(pools), {"default": port_corpus.generate(N_TYPES)},
        to_port(daemons), solver_options=options,
        state_nodes=[port_state_node(sn) for sn in sns],
        volume_objects=to_port(volumes) if volumes is not None else (),
    )
    if volumes is None:  # a client that predates the volume protocol
        jax_req, port_req = (_drop_volumes(r) for r in (jax_req, port_req))
    return jax_req, port_req


def _drop_volumes(req):
    import msgpack

    raw = msgpack.unpackb(req, raw=False)
    del raw["volume_objects"]
    return msgpack.packb(raw, use_bin_type=True)


def _reencode(wire, snap):
    return wire.encode_solve_request(
        snap["pods"], snap["node_pools"], snap["instance_types"],
        snap["daemonset_pods"], solver_options=snap["solver_options"],
        state_nodes=snap["state_nodes"], volume_objects=snap["volume_objects"] or (),
    )


@pytest.mark.parametrize("case", sorted(CASES))
def test_requests_byte_identical(case):
    jax_req, port_req = _both(case)
    assert len(jax_req) > 0
    assert port_req == jax_req


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_decodes_the_others_request(case):
    """Decoded by the other package, a request re-encodes to its bytes."""
    jax_req, port_req = _both(case)
    port_snap = port_wire.decode_solve_request(jax_req)
    jax_snap = jax_wire.decode_solve_request(port_req)
    assert type(port_snap["pods"][0]).__module__.startswith("karpenter_tpu_torch.")
    if CASES[case]()[3] is None:
        assert port_snap["volume_objects"] is None and jax_snap["volume_objects"] is None
        return  # the re-encode would add the key the old protocol lacks
    assert _reencode(port_wire, port_snap) == jax_req
    assert _reencode(jax_wire, jax_snap) == port_req


@pytest.mark.parametrize("case", ["mixed", "constrained", "state_nodes"])
def test_responses_byte_identical(case):
    """The same request solved in process by each package (the port on
    the CPU) encodes to the same response bytes, and each package decodes
    the other's response to the same claims."""
    from karpenter_tpu.solver.driver import SolverConfig as JaxConfig
    from karpenter_tpu.solver.service import _solve_decoded as jax_solve
    from karpenter_tpu_torch.solver.driver import SolverConfig
    from karpenter_tpu_torch.solver.service import _solve_decoded as port_solve

    jax_req, _ = _both(case)
    jax_resp = jax_solve(jax_wire.decode_solve_request(jax_req), JaxConfig())
    port_resp = port_solve(port_wire.decode_solve_request(jax_req),
                           SolverConfig(device="cpu"))
    assert port_resp == jax_resp
    got = port_wire.decode_solve_response(jax_resp)
    want = jax_wire.decode_solve_response(port_resp)
    assert got["claims"], "the case opens claims"
    for a, b in zip(got["claims"], want["claims"]):
        assert repr(sorted(map(repr, a["requirements"]))) == repr(
            sorted(map(repr, b["requirements"])))
        assert (a["pool"], a["instance_types"], a["pod_uids"]) == (
            b["pool"], b["instance_types"], b["pod_uids"])
    assert (got["existing"], got["pod_errors"], got["state_nodes_packed"]) == (
        want["existing"], want["pod_errors"], want["state_nodes_packed"])


def test_response_carries_no_minted_name():
    """A claim travels as pool, type names, pod uids and requirements: no
    name the solving side minted, so the two packages' responses can be
    byte-identical though each mints its own claim names."""
    from karpenter_tpu_torch.solver.driver import SolverConfig
    from karpenter_tpu_torch.solver.service import _solve_decoded

    jax_req, _ = _both("mixed")
    resp = port_wire.decode_solve_response(
        _solve_decoded(port_wire.decode_solve_request(jax_req), SolverConfig(device="cpu")))
    for claim in resp["claims"]:
        assert set(claim) == {"pool", "instance_types", "pod_uids", "requirements"}
