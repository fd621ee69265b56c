"""Port parity for the native host backend, on the CPU.

``karpenter_tpu_torch/native`` is a verbatim copy of the JAX package's
C++ host core and its ctypes loader (``tests/test_torch_isolation.py``
holds both copies equal to their sources). ``SolverConfig(backend=
"native")`` asks ``TorchSolver`` for it: the exact, unpadded shapes, no
staging, no relax bulk, the core's raw bool type masks decoded as B6's
packed rows are.

The port of tests/test_native.py's TestDriverBackend, the solver-level
case of TestTopologyParity and TestBuildLifecycle (in a temporary
directory, g++ replaced by a recorder). The port's native solve must equal
``TpuSolver(backend="native")`` in slot order (claims, pods, options,
requirements, pod errors) and the port's own ``device="cpu"`` kernel run
(slot order with the relax bulk off; node count and price with it on, as
the JAX test holds its two backends). A ``NATIVE_LOAD`` fault degrades to
the oracle with a ladder, in both packages alike.

Tolerance: exact equality (prices to 1e-9).
"""

from __future__ import annotations

import copy
import os
import subprocess

import pytest

from test_torch_ladder import _both, _mod, audit, health_of, health_state, install
from test_torch_residency import signature, to_port

JAX, PORT = PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def pods_of(n_pods, shapes=1):
    """The JAX example batch (make once per test: uids are fresh per
    build)."""
    from karpenter_tpu.solver.example import example_pods

    return example_pods(n_pods, shapes)


def example_batch(pkg, pods, n_types, **config):
    """(solver, pods) of ``pkg`` over a copy of the JAX pods ``pods``
    (rebuilt from the port's classes for the port, keeping uids), one
    example NodePool and ``n_types`` corpus types."""
    from karpenter_tpu.solver.example import example_nodepool

    drv = _mod(pkg, "solver.driver")
    kube = _mod(pkg, "kube")
    pods = copy.deepcopy(pods)
    pool = example_nodepool()
    if pkg == PORT:
        pool, pods = to_port(pool), to_port(pods)
        config.setdefault("device", "cpu")
    its = {pool.name: _mod(pkg, "cloudprovider.corpus").generate(n_types)}
    topo = _mod(pkg, "scheduling.topology").Topology(
        kube.Client(kube.TestClock()), [], [pool], its, pods)
    cls = drv.TorchSolver if pkg == PORT else drv.TpuSolver
    return cls([pool], its, topo, config=drv.SolverConfig(**config)), pods


def solve(pkg, pods, n_types, **config):
    solver, ps = example_batch(pkg, pods, n_types, **config)
    return solver.solve(ps)


def _zonal_mix():
    """tests/test_native.py:TestTopologyParity's batch: plain pods, a zonal
    spread, a hostname spread and a zonal affinity."""
    from helpers import affinity_term, make_pods, spread_constraint
    from karpenter_tpu.api import labels

    return (
        make_pods(10, cpu="1", memory="2Gi")
        + make_pods(7, cpu="1", labels={"nm": "zs"},
                    spread=[spread_constraint(labels.TOPOLOGY_ZONE, labels={"nm": "zs"})])
        + make_pods(5, cpu="1", labels={"nm": "hs"},
                    spread=[spread_constraint(labels.HOSTNAME, labels={"nm": "hs"})])
        + make_pods(4, cpu="1", labels={"nm": "za"},
                    pod_affinity=[affinity_term(labels.TOPOLOGY_ZONE, {"nm": "za"})])
    )


class TestDriverBackend:
    def test_native_backend_matches_tpu_backend(self):
        """The port's native solve == JAX's native solve in slot order, ==
        the port's kernel run in slot order with the relax bulk off, and in
        node count, price and errors with it on."""
        pods = pods_of(300, 6)
        native = _both(lambda pkg: signature(solve(pkg, pods, 30, backend="native")))
        exact = solve(PORT, pods, 30, relax=False)
        assert signature(exact) == native
        rn = solve(PORT, pods, 30, backend="native")
        rk = solve(PORT, pods, 30)
        assert rn.node_count() == rk.node_count()
        assert rn.total_price() == pytest.approx(rk.total_price(), abs=1e-9)
        assert len(rn.pod_errors) == len(rk.pod_errors)

    def test_unknown_backend_rejected(self):
        """Any backend but the two raises ValueError at solve time, naming
        both, as in the JAX package."""
        pods = pods_of(16)

        def trace(pkg):
            solver, ps = example_batch(pkg, pods, 4)
            drv = _mod(pkg, "solver.driver")
            solver.config = drv.SolverConfig(backend="cpu", **(
                {"device": "cpu"} if pkg == PORT else {}))
            with pytest.raises(ValueError, match="unknown solver backend") as exc:
                solver.solve(ps)
            return "'native'" in str(exc.value)

        assert _both(trace)
        solver, ps = example_batch(PORT, pods, 4, backend="cpu")
        with pytest.raises(ValueError, match="'kernels' or 'native'"):
            solver.solve(ps)

    def test_native_backend_all_pods_placed(self):
        pods = pods_of(500)

        def trace(pkg):
            results = solve(pkg, pods, 10, backend="native")
            assert not results.pod_errors
            assert sum(len(c.pods) for c in results.new_node_claims) == 500
            return signature(results), audit(pkg)

        assert _both(trace)[1] == ("solve", "kernel", "ok")

    def test_native_backend_declines_scenarios(self):
        """The scenario axis is the kernels' own: solve_scenarios returns
        None on the native backend, in both packages."""
        pods = pods_of(16)

        def trace(pkg):
            solver, ps = example_batch(pkg, pods, 4, backend="native")
            Scenario = _mod(pkg, "solver.driver").Scenario
            return solver.solve_scenarios([Scenario(pods=ps)])

        assert _both(trace) is None

    def test_native_backend_needs_no_card(self):
        """backend="native" on a config whose device is CUDA constructs on
        a host without CUDA (the host core is the caller's explicit
        request) and solves; the kernel backend there raises."""
        import torch

        from karpenter_tpu_torch.solver.driver import SolverConfig

        if torch.cuda.is_available():
            pytest.skip("the host has CUDA")
        SolverConfig(device="cuda", backend="native")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SolverConfig(device="cuda")
        pods = pods_of(64, 2)
        native = solve(PORT, pods, 8, backend="native", device="cuda")
        assert signature(native) == signature(solve(PORT, pods, 8, backend="native"))

    def test_native_load_fault_degrades_to_oracle(self, monkeypatch):
        """A failed load of the core (the NATIVE_LOAD seam) is a backend
        failure: with a ladder the batch goes to the oracle and the kernel
        breaker counts it; without one it propagates."""
        for pkg in PKGS:
            monkeypatch.setattr(_mod(pkg, "native"), "_lib", None)
        pods = pods_of(40, 2)

        def trace(pkg):
            install(pkg, "NATIVE_LOAD")
            solver, ps = example_batch(pkg, pods, 10, backend="native")
            with pytest.raises(_mod(pkg, "faults").InjectedFault):
                solver.solve(ps)
            health, _ = health_of(pkg, failure_threshold=1)
            solver, ps = example_batch(pkg, pods, 10, backend="native", health=health)
            results = solver.solve(ps)
            rung = audit(pkg)
            _mod(pkg, "faults").uninstall()
            oracle = solve(pkg, pods, 10, force_oracle=True)
            assert signature(results) == signature(oracle)
            return signature(results), health_state(health), rung

        _, state, rung = _both(trace)
        assert not state[0] and rung == ("solve", "oracle", "ok")


class TestTopologyParity:
    def test_native_backend_zonal_end_to_end(self):
        """The hostname-cap and domain-quota paths through TorchSolver: the
        port's native solve == JAX's in slot order and == the port's kernel
        run (relax off) in slot order; zones as the kernel run's."""
        from karpenter_tpu_torch.api import labels

        def zone_dist(results):
            out = {}
            for claim in results.new_node_claims:
                zr = claim.requirements.get(labels.TOPOLOGY_ZONE)
                if not zr.complement and len(zr.values) == 1:
                    z = next(iter(zr.values))
                    out[z] = out.get(z, 0) + len(claim.pods)
            return out

        pods = _zonal_mix()
        native = _both(lambda pkg: signature(solve(pkg, pods, 20, backend="native")))
        rn = solve(PORT, pods, 20, backend="native")
        rk = solve(PORT, pods, 20, relax=False)
        assert rn.all_pods_scheduled() and rk.all_pods_scheduled()
        assert signature(rk) == native
        assert zone_dist(rn) == zone_dist(rk) and len(zone_dist(rn)) > 1


class TestBuildLifecycle:
    """build()/available() around a missing, stale or unbuildable shared
    library, and the kernel backend staying serviceable when the native
    toolchain is gone. No real compiler is invoked: the g++ subprocess is
    replaced with a recorder."""

    class _Recorder:
        def __init__(self, returncode=0, stderr=""):
            self.calls = []
            self.returncode = returncode
            self.stderr = stderr

        def __call__(self, cmd, capture_output=True, text=True):
            self.calls.append(cmd)
            if self.returncode == 0:
                # the -o argument is the library path build() expects
                with open(cmd[cmd.index("-o") + 1], "wb") as fh:
                    fh.write(b"\x7fELF fake")
            return subprocess.CompletedProcess(cmd, self.returncode, stdout="",
                                               stderr=self.stderr)

    @pytest.fixture
    def native(self, tmp_path, monkeypatch):
        """The port's native module with its source and library paths in
        tmp and no cached ctypes handle."""
        from karpenter_tpu_torch import native

        src = tmp_path / "solve_core.cc"
        src.write_text("// stand-in source\n")
        monkeypatch.setattr(native, "_SRC", str(src))
        monkeypatch.setattr(native, "_LIB", str(tmp_path / "libkt_solver.so"))
        monkeypatch.setattr(native, "_lib", None)
        return native

    def test_missing_library_triggers_build(self, native, monkeypatch):
        recorder = self._Recorder()
        monkeypatch.setattr(native.subprocess, "run", recorder)
        assert not os.path.exists(native._LIB)
        assert native.build() == native._LIB and os.path.exists(native._LIB)
        assert len(recorder.calls) == 1 and recorder.calls[0][0] == "g++"

    def test_stale_library_rebuilt(self, native, monkeypatch):
        with open(native._LIB, "wb") as fh:
            fh.write(b"old")
        stale = os.path.getmtime(native._SRC) - 60
        os.utime(native._LIB, (stale, stale))
        recorder = self._Recorder()
        monkeypatch.setattr(native.subprocess, "run", recorder)
        native.build()
        assert len(recorder.calls) == 1, "stale .so must be recompiled"

    def test_fresh_library_not_rebuilt(self, native, monkeypatch):
        with open(native._LIB, "wb") as fh:
            fh.write(b"fresh")
        fresh = os.path.getmtime(native._SRC) + 60
        os.utime(native._LIB, (fresh, fresh))
        recorder = self._Recorder()
        monkeypatch.setattr(native.subprocess, "run", recorder)
        assert native.build() == native._LIB
        assert recorder.calls == [], "fresh .so must be reused"
        native.build(force=True)
        assert len(recorder.calls) == 1, "force=True bypasses the mtime check"

    def test_failed_build_raises_and_available_is_false(self, native, monkeypatch):
        monkeypatch.setattr(native.subprocess, "run",
                            self._Recorder(returncode=1, stderr="fatal: no compiler"))
        with pytest.raises(native.NativeBuildError, match="no compiler"):
            native.build()
        assert native.available() is False
        assert native._lib is None, "failed build must not cache a handle"

    def test_kernel_backend_survives_missing_toolchain(self, native, monkeypatch):
        """With the native core unbuildable, the default kernels backend
        still schedules: native is a host path, not a dependency of it."""
        monkeypatch.setattr(native.subprocess, "run",
                            self._Recorder(returncode=1, stderr="g++: not found"))
        assert native.available() is False
        assert solve(PORT, pods_of(16), 4).all_pods_scheduled()
