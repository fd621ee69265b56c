"""The port's static-analysis tier (karpenter_tpu_torch/analysis).

Each rule the port ships fires on a seeded-bad fixture and stays silent on
a clean one (the copied families read the JAX package's fixtures under
tests/analysis_fixtures/ as data; the torch host-sync rule, the
three-way parity and the torch shape walker have their own under
tests/analysis_fixtures_torch/, the walker's held against JAX's pass on
JAX's fixture).
Each family fires on a mutated copy of a real port file, so no rule is
blind to the port's tree. The tree itself is clean: one in-process run of
the whole analyzer finds nothing, and the host-sync rule's sanctions are
the three sites chip_smoke.py's phase 15 holds the card's syncs to.
"""

import ast
import contextlib
import io
import json
import os
import shutil
import threading
import time

import pytest

from karpenter_tpu_torch.analysis import (
    NOT_SHIPPED,
    all_rules,
    args_registry,
    atomicity,
    blocking,
    cli,
    clock,
    det,
    device,
    guarded,
    locks,
    obs,
    parity,
    retry,
    schema_drift,
    shapes,
    stale,
)
from karpenter_tpu_torch.analysis.findings import (
    SourceFile,
    load_baseline,
    partition_findings,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PORT = os.path.join(REPO, "karpenter_tpu_torch")
JAX_FIXTURES = os.path.join(HERE, "analysis_fixtures")
FIXTURES = os.path.join(HERE, "analysis_fixtures_torch")


def jax_fixture(*names):
    return [os.path.join(JAX_FIXTURES, n) for n in names]


def fixture(name):
    return os.path.join(FIXTURES, name)


def port(rel):
    return os.path.join(PORT, rel)


def rules_of(findings):
    return {f.rule for f in findings}


def kept(result):
    """The findings of a (findings, sources) pair that no marker covers."""
    return partition_findings(*result)[0]


PARITY_TWIN = fixture("parity_twin.py")
PARITY_CUDA = [fixture("parity_good.cuh"), fixture("parity_good.cu")]

# family -> (its seeded-bad run, the rules it must produce exactly)
SEEDED_BAD = {
    "locks": (lambda: locks.check_paths(jax_fixture("bad_locks.py")),
              {"LCK201", "LCK202", "LCK203"}),
    "blocking": (lambda: blocking.check_paths(
        jax_fixture("bad_blocking.py", "bad_blocking_service.py")),
        {"BLK301", "BLK302", "BLK303"}),
    "schema": (lambda: schema_drift.check_schema(
        *jax_fixture("drift_schema.py", "drift_crds")),
        {"SCH401", "SCH402", "SCH403"}),
    "parity": (lambda: parity.check_parity(
        PARITY_TWIN, fixture("parity_bad.cc"), PARITY_CUDA),
        {"PAR501", "PAR502", "PAR503", "PAR504", "PAR505", "PAR506"}),
    "shapes": (lambda: shapes.check_paths([fixture("bad_shapes.py")]),
               {"SHP601", "SHP602", "SHP603", "SHP604"}),
    "retry": (lambda: retry.check_paths(jax_fixture("bad_retry.py")),
              {"RTY701", "RTY702"}),
    "obs": (lambda: obs.check_paths(jax_fixture("bad_obs.py")),
            {"OBS801", "OBS802"}),
    "device": (lambda: device.check_paths([fixture("bad_device_sync.py")]),
               {"DTX901", "DTX902", "DTX903", "DTX904", "DTX905", "DTX906"}),
    "device_resident": (
        lambda: device.check_paths([fixture("bad_device_resident.py")]),
        {"DTX901", "DTX903", "DTX904", "DTX906"}),
    "clock": (lambda: clock.check_paths(jax_fixture("bad_clock.py")),
              {"CLK1001", "CLK1002"}),
    "det": (lambda: det.check_paths(jax_fixture("bad_det.py")),
            {"DET1101", "DET1102", "DET1103", "DET1104"}),
    "args": (lambda: args_registry.check_paths([fixture("argreg_bad")]),
             {"ARG1201", "ARG1202", "ARG1203", "ARG1204"}),
    "guarded": (lambda: guarded.check_paths(jax_fixture("bad_guarded.py")),
                {"GRD1301", "GRD1302", "GRD1303"}),
    "atomicity": (lambda: atomicity.check_paths(
        jax_fixture("bad_atomicity.py", "bad_atomicity_peer.py")),
        {"ATM1401", "ATM1402"}),
}

# family -> its clean run: nothing kept
CLEAN = {
    "locks": lambda: locks.check_paths(jax_fixture("good_locks.py")),
    "blocking": lambda: blocking.check_paths(jax_fixture("good_blocking.py")),
    "schema": lambda: schema_drift.check_schema(
        port("api/schema.py"), port("api/crds")),
    "parity": lambda: parity.check_parity(
        PARITY_TWIN, fixture("parity_good.cc"), PARITY_CUDA),
    "shapes": lambda: shapes.check_paths([fixture("good_shapes.py")]),
    "retry": lambda: retry.check_paths(jax_fixture("good_retry.py")),
    "obs": lambda: obs.check_paths(jax_fixture("good_obs.py")),
    "device": lambda: device.check_paths([fixture("good_device_sync.py")]),
    "device_resident": lambda: device.check_paths(
        [fixture("good_device_resident.py")]),
    "clock": lambda: clock.check_paths(jax_fixture("good_clock.py")),
    "det": lambda: det.check_paths(jax_fixture("good_det.py")),
    "args": lambda: args_registry.check_paths(jax_fixture(
        "argreg_good/names.py", "argreg_good/native.py",
        "argreg_good/residency.py")),
    "guarded": lambda: guarded.check_paths(jax_fixture("good_guarded.py")),
    "atomicity": lambda: atomicity.check_paths(
        jax_fixture("good_atomicity.py")),
}


class TestFixtures:
    @pytest.mark.parametrize("family", sorted(SEEDED_BAD))
    def test_seeded_bad_fixture_fires_every_rule(self, family):
        run, expected = SEEDED_BAD[family]
        assert rules_of(run()[0]) == expected

    @pytest.mark.parametrize("family", sorted(CLEAN))
    def test_clean_fixture_silent(self, family):
        findings = kept(CLEAN[family]())
        assert findings == [], [f.render() for f in findings]

    @pytest.mark.parametrize("name", ["good_device_sync.py", "good_device_resident.py"])
    def test_clean_device_fixture_has_one_sanctioned_drain(self, name):
        _, suppressed, sanctioned = partition_findings(
            *device.check_paths([fixture(name)]))
        assert suppressed == []
        assert [f.rule for f in sanctioned] == ["DTX906"]

    @pytest.mark.parametrize("line,rule", [
        (13, "DTX901"),  # .to(dev) is an origin
        (26, "DTX902"),  # .numpy() is a sink
        (32, "DTX903"),  # .cuda() is an origin
        (54, "DTX906"),  # torch.cuda.synchronize, unsanctioned
        (55, "DTX906"),  # a stream's .synchronize()
        (56, "DTX906"),  # .to("cpu") reads back
        (61, "DTX901"),  # a launcher's output
        (70, "DTX901"),  # a device tensor through a helper's summary
        (86, "DTX902"),  # device on both arms of a join
    ])
    def test_host_sync_rule_origins_and_sinks(self, line, rule):
        findings, _ = device.check_paths([fixture("bad_device_sync.py")])
        assert (line, rule) in {(f.line, f.rule) for f in findings}

    def test_plain_versions_outside_the_host_sync_rule(self):
        findings, _ = device.check_paths([fixture("good_device_sync.py")])
        names = {"pack_reference", "_plain_helper"}
        tree = ast.parse(open(fixture("good_device_sync.py")).read())
        plain = [n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name in names]
        assert len(plain) == 2
        assert not [f for f in findings for n in plain
                    if n.lineno <= f.line <= n.end_lineno]

    def test_parity_modes_and_tiers_drift(self):
        """The CUDA twin shares the plain versions' tiled mode, the host
        core does not: a CUDA twin without the tile-rows phase, or with
        a tier run twice, drifts (PAR501 twice); the host core
        without it is in sync."""
        findings, _ = parity.check_parity(
            PARITY_TWIN, fixture("parity_good.cc"),
            [fixture("parity_good.cuh"), fixture("parity_bad.cu")])
        drift = sorted(f.message.split(":")[0] for f in findings
                       if f.rule == "PAR501")
        assert drift == ["mode phase drift", "phase sequence drift"]
        assert rules_of(findings) == {"PAR501", "PAR504"}

    def test_parity_state_anchor_counts_only_assigned_locals(self, tmp_path):
        text = open(PARITY_TWIN).read().replace(
            "# parity: state c_used, c_npods, overflow",
            "# parity: state c_used, c_npods, overflow, c_gone")
        text = text.replace("    overflow = torch.zeros((), dtype=torch.bool)\n", "")
        (tmp_path / "twin.py").write_text(text)
        findings, _ = parity.check_parity(
            str(tmp_path / "twin.py"), fixture("parity_good.cc"), PARITY_CUDA)
        messages = sorted(f.message for f in findings if f.rule == "PAR505")
        assert any("'overflow' declared by PackState is never carried by "
                   "pack_reference" in m for m in messages)
        assert any("'c_gone' in pack_reference has no PackState twin" in m
                   for m in messages)


def _broken(tmp_path):
    broken = tmp_path / "broken.py"
    broken.write_text("def oops(:\n")
    return str(broken)


UNPARSABLE = {
    "LCK200": lambda b: locks.check_paths([b]),
    "BLK300": lambda b: blocking.check_paths([b]),
    "SCH400": lambda b: schema_drift.check_schema(b, jax_fixture("drift_crds")[0]),
    "PAR500": lambda b: parity.check_parity(b, fixture("parity_good.cc"), PARITY_CUDA),
    "SHP600": lambda b: shapes.check_paths([b]),
    "RTY700": lambda b: retry.check_paths([b]),
    "OBS800": lambda b: obs.check_paths([b]),
    "DTX900": lambda b: device.check_paths([b]),
    "CLK1000": lambda b: clock.check_paths([b]),
    "DET1100": lambda b: det.check_paths([b]),
    "ARG1200": lambda b: args_registry.check_paths([b]),
    "GRD1300": lambda b: guarded.check_paths([b]),
    "ATM1400": lambda b: atomicity.check_paths([b]),
}


class TestRuleRegistry:
    @pytest.mark.parametrize("rule", sorted(UNPARSABLE))
    def test_unparsable_file_reported(self, rule, tmp_path):
        assert rules_of(UNPARSABLE[rule](_broken(tmp_path))[0]) == {rule}

    def test_missing_artifacts_reported(self, tmp_path):
        (tmp_path / "crds").mkdir()
        findings, _ = schema_drift.check_schema(
            port("api/schema.py"), str(tmp_path / "crds"))
        assert rules_of(findings) == {"SCH404"}

    def test_every_shipped_rule_has_seeded_bad_coverage(self, tmp_path):
        produced = set()
        for run, _ in SEEDED_BAD.values():
            produced |= rules_of(run()[0])
        for rule, run in UNPARSABLE.items():
            produced |= rules_of(run(_broken(tmp_path))[0])
        (tmp_path / "crds").mkdir()
        produced |= rules_of(schema_drift.check_schema(
            port("api/schema.py"), str(tmp_path / "crds"))[0])
        produced |= rules_of(stale.audit(
            [], {"s.py": SourceFile(path="s.py", text="x = 1  # analysis: ignore[DTX901] gone\n")},
            None, "baseline.txt")[0])
        assert produced == set(all_rules())

    def test_registry_lists_the_shipped_families_only(self):
        rules = all_rules()
        for prefix in ("LCK2", "BLK3", "SCH4", "PAR5", "SHP6", "RTY7", "OBS8", "DTX9",
                       "CLK10", "DET11", "ARG12", "GRD13", "ATM14", "STALE"):
            assert any(r.startswith(prefix) for r in rules), prefix
        assert not any(r.startswith("TRC") for r in rules)
        assert not set(NOT_SHIPPED) & set(rules)
        assert set(cli.PASS_MODULES) == set(cli.PASS_TARGETS)
        assert "tracer" not in cli.PASS_TARGETS
        assert cli.PASS_TARGETS["shapes"] == [
            "karpenter_tpu_torch/ops", "karpenter_tpu_torch/solver",
            "karpenter_tpu_torch/parallel"]
        assert "karpenter_tpu_torch/parallel/mesh.py" in cli.PASS_TARGETS["args"]


def _copy(tmp_path, rel, edit=None, name=None):
    """A copy of the port's ``rel`` under ``tmp_path`` (as ``name``),
    with ``edit`` (old, new) applied once; the old text must be there."""
    text = open(port(rel)).read()
    if edit is not None:
        old, new = edit
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    dst = tmp_path / (name or os.path.basename(rel))
    dst.write_text(text)
    return str(dst)


def _unmark(tmp_path, rel, marker):
    """A copy of ``rel`` with the marker comment ``marker`` taken out (its
    line, or the comment at the end of a code line)."""
    text = open(port(rel)).read()
    lines = text.split("\n")
    hits = [i for i, line in enumerate(lines) if marker in line]
    assert len(hits) == 1, marker
    i = hits[0]
    code = lines[i].split("# analysis:")[0].rstrip()
    if code.strip():
        lines[i] = code
    else:
        del lines[i]
    dst = tmp_path / os.path.basename(rel)
    dst.write_text("\n".join(lines))
    return str(dst)


_STORE_LEASE = '''        with self.lock:
            if scenario:
                if self.scenario_device_store is None:
                    self.scenario_device_store = DeviceResidentArgs(owner=self.owner)
                return self.scenario_device_store
            if self.device_store is None:
                self.device_store = DeviceResidentArgs(owner=self.owner)
            return self.device_store'''


def _mutations():
    """(family, build(tmp_path) -> (findings, sources), the rule that must
    now be kept): each edits a copy of a real port file."""
    def one(check, rel, edit=None):
        return lambda t: check([_copy(t, rel, edit)])

    def unmarked(check, rel, marker):
        return lambda t: check([_unmark(t, rel, marker)])

    def cuda_twin(drop):
        def build(t):
            paths = [_copy(t, f"csrc/{n}") for n in ("common.cuh", "pack_common.cuh",
                                                     "pack.cu", "pack_classed.cu")]
            text = open(paths[1]).read()
            assert text.count(drop + "\n") == 1, drop
            open(paths[1], "w").write(text.replace(drop + "\n", ""))
            return parity.check_parity(port("ops/packing.py"),
                                       port("native/solve_core.cc"), paths)
        return build

    def schema(t):
        crds = t / "crds"
        shutil.copytree(port("api/crds"), crds)
        yaml = crds / "karpenter_tpu_nodepools.yaml"
        text = yaml.read_text()
        assert text.count("    weight:") == 1
        yaml.write_text(text.replace("    weight:", "    heft:"))
        return schema_drift.check_schema(port("api/schema.py"), str(crds))

    def args(t):
        paths = [_copy(t, rel) for rel in ("solver/residency.py", "native/__init__.py",
                                           "ops/solve.py")]
        paths.append(_copy(t, "solver/encode.py", (
            "            self.g_hcap, self.g_haff,\n", "            self.g_hcap,\n")))
        return args_registry.check_paths(paths)

    def args_mesh(t):
        paths = [_copy(t, rel) for rel in ("solver/encode.py", "solver/residency.py",
                                           "native/__init__.py", "ops/solve.py")]
        paths.append(_copy(t, "parallel/mesh.py", (
            '    byname["a_res"] = pad_axis(byname["a_res"], 1, model)\n', "")))
        return args_registry.check_paths(paths)

    def plain_phase(t):
        path = _copy(t, "ops/packing.py")
        text = open(path).read()
        old = "            # parity: phase open-claims\n"
        assert text.count(old) == 1
        open(path, "w").write(text.replace(old, ""))
        return parity.check_parity(path, port("native/solve_core.cc"))

    def stale_marker(t):
        path = _copy(t, "solver/driver.py", (
            "    def _sync_if_traced(self) -> None:\n",
            "    def _sync_if_traced(self) -> None:\n"
            "        # analysis: sanctioned[DTX906] nothing waits here\n"))
        findings, sources = device.check_paths([path])
        scanned = {rule: set(sources) for rule in device.RULES}
        return stale.audit(findings, sources, None, "baseline.txt",
                           scanned_by_rule=scanned)[0], sources

    return [
        ("locks", unmarked(locks.check_paths, "kube/store.py", "ignore[LCK202]"),
         "LCK202"),
        ("blocking", lambda t: blocking.check_paths([_unmark(
            t, "controllers/provisioning.py", "wall-time boundary: gauge")]), "BLK302"),
        ("schema", schema, "SCH401"),
        ("parity_cuda_phase", cuda_twin("// parity: phase open-claims"), "PAR501"),
        ("parity_cuda_mode", cuda_twin("// parity: phase tile-rows"), "PAR501"),
        ("parity_cuda_dtype", cuda_twin("// parity: dtype bool"), "PAR503"),
        ("parity_cuda_tiebreak", cuda_twin("// parity: tiebreak cumsum"), "PAR504"),
        ("parity_cuda_state", cuda_twin(
            "// parity: state ddc, res_rem, c_resv, pool_rem, n_open, overflow"), "PAR505"),
        ("parity_plain_phase", plain_phase, "PAR501"),
        ("parity_native_const", lambda t: parity.check_parity(
            port("ops/packing.py"),
            _copy(t, "native/solve_core.cc", ("// parity: const 1e-9\n", ""))), "PAR502"),
        ("shapes", unmarked(shapes.check_paths, "ops/solve.py",
                            "sanctioned[SHP602] index_copy_ takes"), "SHP602"),
        ("shapes_join", one(shapes.check_paths, "ops/feasibility.py", (
            "    off = off_base[:, None, :].expand(P, G, T).clone()\n",
            "    off = off_base[:, None, :].expand(P, G, T).clone()\n"
            "    off = off & torch.zeros((P, T, G), dtype=torch.bool)\n")), "SHP601"),
        ("retry", unmarked(retry.check_paths, "controllers/state.py", "ignore[RTY701]"),
         "RTY701"),
        ("obs", one(obs.check_paths, "solver/driver.py", (
            "    def _sync_if_traced(self) -> None:\n",
            "    def _leak(self):\n"
            "        sp = obs.span(\"solve.leak\")\n"
            "        return sp\n\n"
            "    def _sync_if_traced(self) -> None:\n")), "OBS801"),
        ("device_drain", unmarked(device.check_paths, "solver/driver.py",
                                  "sanctioned[DTX906] the solve's drain"), "DTX906"),
        ("device_sink", one(device.check_paths, "solver/driver.py", (
            "                            *args, nmax=nmax, fills_dtype=fills_dtype, **statics\n"
            "                        ),\n"
            "                    )\n",
            "                            *args, nmax=nmax, fills_dtype=fills_dtype, **statics\n"
            "                        ),\n"
            "                    )\n"
            "                    n_peek = int(slot[\"out\"][2])  # the claim count ahead of the "
            "drain\n")),
         "DTX902"),
        ("clock", lambda t: clock.check_paths([_unmark(
            t, "controllers/provisioning.py", "wall-time boundary: gauge")]), "CLK1001"),
        ("det", unmarked(det.check_paths, "solver/driver.py",
                         "sanctioned[DET1101] any-mismatch early-return"), "DET1101"),
        ("args", args, "ARG1201"),
        ("args_mesh", args_mesh, "ARG1204"),
        ("guarded", one(guarded.check_paths, "solver/driver.py", (
            _STORE_LEASE, _STORE_LEASE.replace("        with self.lock:\n", "        if True:\n"))),
         "GRD1301"),
        ("atomicity", one(atomicity.check_paths, "solver/driver.py", (
            _STORE_LEASE,
            "        with self.lock:\n"
            "            store = self.device_store\n"
            "        if store is None:\n"
            "            with self.lock:\n"
            "                self.device_store = DeviceResidentArgs(owner=self.owner)\n"
            "        return self.device_store")), "ATM1401"),
        ("stale", stale_marker, "STALE001"),
    ]


MUTATIONS = _mutations()


@pytest.mark.parametrize("family,build,rule", MUTATIONS, ids=[m[0] for m in MUTATIONS])
def test_mutated_port_file_fires(family, build, rule, tmp_path):
    """A seeded drift in a copy of a real port file is kept, with the rule
    the family owns."""
    assert rule in rules_of(kept(build(tmp_path)))


def test_every_family_has_a_mutation():
    families = {family.split("_")[0] for family, *_ in MUTATIONS}
    assert families == set(cli.PASS_TARGETS) | {"stale"}


def _enclosing(path, line):
    """The innermost function of ``path`` around ``line``."""
    tree = ast.parse(open(path).read())
    best = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                node.lineno <= line <= node.end_lineno):
            if best is None or node.lineno > best.lineno:
                best = node
    return best.name


@pytest.fixture(scope="module")
def full_run():
    """The port's whole analyzer, once, in process: the CLI's default run
    from the repo root (every pass, the port's baseline, the stale audit),
    one job, SARIF out."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["--root", REPO, "--jobs", "1", "--format", "sarif"])
    return rc, json.loads(out.getvalue()), err.getvalue()


@pytest.fixture(scope="module")
def host_sync_sanctions():
    targets = [os.path.join(REPO, t) for t in cli.PASS_TARGETS["device"]]
    _, suppressed, sanctioned = partition_findings(*device.check_paths(targets))
    return suppressed, sanctioned


class TestPortTree:
    def test_full_run_clean(self, full_run):
        rc, sarif, err = full_run
        results = sarif["runs"][0]["results"]
        assert rc == 0 and results == [], results
        assert "analysis: 0 finding(s)" in err

    def test_full_run_ran_every_pass(self, full_run):
        props = full_run[1]["runs"][0]["properties"]
        assert set(props["passSeconds"]) == set(cli.PASS_TARGETS)
        assert props["jobs"] == 1 and not props["changedOnly"]

    def test_three_sanctioned_host_sync_sites(self, host_sync_sanctions):
        suppressed, sanctioned = host_sync_sanctions
        assert suppressed == []
        assert {f.rule for f in sanctioned} == {"DTX906"}
        sites = {(os.path.relpath(f.path, PORT), _enclosing(f.path, f.line))
                 for f in sanctioned}
        assert sites == {
            ("solver/driver.py", "_drain_host"),
            ("ops/relax.py", "solve_bulk"),
            ("solver/driver.py", "_sync_if_traced"),
        }
        # the relax site reads back twice: B3's tables, then B9's outputs
        assert len(sanctioned) == 4

    def test_implicit_syncs_name_real_functions(self):
        for path, fn, reason in device.IMPLICIT_SYNCS:
            tree = ast.parse(open(os.path.join(REPO, path)).read())
            assert fn in {n.name for n in ast.walk(tree)
                          if isinstance(n, ast.FunctionDef)}, (path, fn)
            assert reason

    def test_port_baseline_is_its_own_and_empty(self):
        assert cli.DEFAULT_BASELINE == os.path.join(
            "karpenter_tpu_torch", "analysis", "baseline.txt")
        assert load_baseline(os.path.join(REPO, cli.DEFAULT_BASELINE)) == set()
        assert all(t.startswith("karpenter_tpu_torch")
                   for ts in cli.PASS_TARGETS.values() for t in ts)

    def test_real_parity_skeletons_are_substantial(self):
        """The pass must not go quiet by extracting nothing: the three
        twins each yield the full skeleton."""
        from karpenter_tpu_torch.analysis.astutil import import_aliases, parse_file

        py = port("ops/packing.py")
        src, tree = parse_file(py)
        functions = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
        declared = parity._state_class_fields(tree, "PackState")
        assert len(declared) == 19
        tiers = ["min-values", "existing-nodes", "open-claims", "fresh-claims",
                 "spread-counters"]
        skeletons = [parity._extract_python_skeleton(
            name, py, src, tree, functions[name], functions, declared,
            import_aliases(tree), parity._module_const_table(tree))
            for name in ("pack_reference", "pack_classed_reference")]
        cuda = [port(f"csrc/{n}") for n in ("common.cuh", "pack_common.cuh", "pack.cu",
                                             "pack_classed.cu")]
        skeletons += [parity.extract_cc_skeleton(port("native/solve_core.cc"))[0],
                      parity.extract_cc_skeleton(cuda, "cuda")[0]]
        for sk in skeletons:
            assert sk.phase_slugs() == tiers, sk.name
            assert sk.mode_phases() == ([] if sk.name == "native" else ["tile-rows"])
            assert set(sk.consts) == {repr(2**28), repr(2**30), repr(1e-9), repr(0.5)}
            assert set(sk.dtypes) == {"float32", "int32", "bool"}
            assert set(sk.tiebreaks) == {"argmin", "argmax", "searchsorted", "cumsum"}
            assert set(sk.state_fields) == set(declared), sk.name

    def test_cli_exits_nonzero_on_a_seeded_violation(self):
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            rc = cli.main(["--pass", "device", fixture("bad_device_sync.py")])
        assert rc == 1 and "finding(s)" in err.getvalue()


def _pairs(findings, path):
    """Each finding's (enclosing function, rule), counted."""
    from collections import Counter

    return Counter((_enclosing(path, f.line), f.rule) for f in findings)


class TestShapesPass:
    """The torch axis/dtype walker (analysis/shapes.py), mirroring
    tests/test_analysis.py's TestShapesPass and its CLI cases."""

    def test_bad_fixture_flags_every_rule(self):
        findings, _ = shapes.check_paths([fixture("bad_shapes.py")])
        by_rule = {r: len([f for f in findings if f.rule == r]) for r in rules_of(findings)}
        # operator join, where join, einsum, transposed matmul, misaligned
        # index_add_ index, an index_add_ result joined against the
        # pre-segment axis; widening via constructor, .to, join and a
        # positional as_tensor dtype; the constructor dim and the reshape
        # literal; place with ARG_SPECS' spec and cut with spec_of's
        assert by_rule == {"SHP601": 6, "SHP602": 4, "SHP603": 2, "SHP604": 2}
        messages = "\n".join(f.message for f in findings)
        for text in ("index_add_", "einsum", "matmul contracts", "1000", "power of two"):
            assert text in messages, text

    def test_same_pairs_as_jax(self):
        """JAX's pass on JAX's fixture and the port's on its torch
        rendering flag the same (function, rule) pairs, as often."""
        from karpenter_tpu.analysis import shapes as jax_shapes

        jax_path = jax_fixture("bad_shapes.py")[0]
        want = _pairs(jax_shapes.check_paths([jax_path])[0], jax_path)
        got = _pairs(shapes.check_paths([fixture("bad_shapes.py")])[0],
                     fixture("bad_shapes.py"))
        assert got == want
        assert sum(want.values()) == 14

    def test_real_tree_clean(self):
        """ops/, solver/ and parallel/: nothing kept; the 28 sanctioned
        sites are the int64 index tensors torch's ops require."""
        targets = [os.path.join(REPO, t) for t in cli.PASS_TARGETS["shapes"]]
        kept_fs, suppressed, sanctioned = partition_findings(*shapes.check_paths(targets))
        assert kept_fs == [] and suppressed == []
        assert {f.rule for f in sanctioned} == {"SHP602"} and len(sanctioned) == 28

    @staticmethod
    def _run_on(tmp_path, src, name="case.py"):
        p = tmp_path / name
        p.write_text(src)
        return shapes.check_paths([str(p)])[0]

    def test_unknown_rank_never_false_positives(self, tmp_path):
        # joining a tracked tensor against a value the interpreter lost
        # track of must stay silent (the poison-to-unknown rule)
        assert self._run_on(tmp_path, (
            "import torch\n"
            "def f(n, r, blob, idx):\n"
            "    a = torch.zeros((n, r), dtype=torch.float32)\n"
            "    b = blob.some_method()\n"
            "    c = a[idx]\n"
            "    return a + b, c + torch.zeros((r, n))\n")) == []

    def test_spec_rebind_through_tuple_poisons(self, tmp_path):
        # a tuple-unpacking reassignment of a name that held a spec must
        # clear it — checking a spec the name no longer holds would
        # false-positive SHP604
        assert self._run_on(tmp_path, (
            "import torch\n"
            "from karpenter_tpu_torch.parallel.mesh import cut, spec_of\n"
            "def f(mesh, m, build):\n"
            "    spec = spec_of('gk_g')\n"
            "    spec, other = build()\n"
            "    x = torch.zeros((m,))[None, :].expand(48, m)\n"
            "    return cut(x, ((0, 0),), spec, mesh.shape)\n")) == []

    def test_stacked_spec_gains_the_scenario_axis(self, tmp_path):
        findings = self._run_on(tmp_path, (
            "import torch\n"
            "from karpenter_tpu_torch.parallel import mesh as pm\n"
            "def f(mesh, n, g):\n"
            "    x = torch.zeros((n, g))[None].expand(12, n, g)\n"
            "    return pm.place('n_tol', x, mesh, True), pm.place('n_tol', x, mesh)\n"))
        assert [(f.rule, f.line) for f in findings] == [("SHP604", 5)]
        assert "'scenario'" in findings[0].message

    def test_host_numpy_out_of_scope(self, tmp_path):
        # encode-time np.int64 index math is intentional host code
        assert self._run_on(tmp_path, (
            "import numpy as np\n"
            "def g(spans):\n"
            "    arr = np.asarray(spans, np.int64)\n"
            "    return arr.astype(np.float64), arr.sum(dtype=np.int64)\n")) == []

    def test_host_numpy_reshape_out_of_scope(self, tmp_path):
        # .reshape literal-dim checks gate on a tracked receiver
        assert self._run_on(tmp_path, (
            "import numpy as np\n"
            "def g(spans):\n"
            "    return np.asarray(spans, np.int64).reshape(5, 1000)\n")) == []

    def test_branch_rebinding_never_false_positives(self, tmp_path):
        # a rebinding inside one branch is not a fact on the fall-through
        # path: `a` is still [n, r] when flag is False
        assert self._run_on(tmp_path, (
            "import torch\n"
            "def f(n, r, flag):\n"
            "    a = torch.zeros((n, r), dtype=torch.float32)\n"
            "    if flag:\n"
            "        a = a.t()\n"
            "        return a.sum()\n"
            "    return a + torch.zeros(n, r)\n")) == []

    def test_shape_unpacking_names_axes(self, tmp_path):
        """``P, G = x.shape`` names x's axes (a parameter the walker knew
        nothing of), or aliases axes it had; views, reductions and casts
        carry them to the join."""
        findings = self._run_on(tmp_path, (
            "import torch\n"
            "def f(p_tol, type_ok, n):\n"
            "    P, G = p_tol.shape\n"
            "    T = type_ok.shape[-1]\n"
            "    a = torch.zeros((n, 4))\n"
            "    N, R = a.shape\n"
            "    ok = a + torch.ones(N, R)\n"
            "    rows = p_tol.int().unsqueeze(-1).expand(P, G, T)\n"
            "    bad = rows.sum(1) + p_tol\n"
            "    worse = p_tol.t() & p_tol\n"
            "    fine = p_tol.permute(1, 0).transpose(0, 1) | p_tol\n"
            "    return ok, bad, worse, fine\n"))
        assert [(f.rule, f.line) for f in findings] == [("SHP601", 9), ("SHP601", 10)]

    def test_dtype_names_and_casts(self, tmp_path):
        findings = self._run_on(tmp_path, (
            "import torch\n"
            "def f(x, n):\n"
            "    i64, i32 = torch.int64, torch.int32\n"
            "    a = x.to(i64)\n"
            "    b = x.to(i32)\n"
            "    c = x.long()\n"
            "    d = torch.arange(n, dtype=torch.long)\n"
            "    e = x.sum(-1, dtype=torch.int32)\n"
            "    return a, b, c, d, e\n"))
        assert [(f.rule, f.line) for f in findings] == [
            ("SHP602", 4), ("SHP602", 6), ("SHP602", 7)]

    def test_cli_nonzero_on_shape_violations(self):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["--pass", "shapes", fixture("bad_shapes.py")])
        assert rc == 1 and "SHP6" in out.getvalue()

    def test_sarif_output_on_seeded_violation(self):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["--format", "sarif", "--pass", "shapes", fixture("bad_shapes.py")])
        assert rc == 1
        doc = json.loads(out.getvalue())
        results = doc["runs"][0]["results"]
        rules = {"SHP601", "SHP602", "SHP603", "SHP604"}
        assert {r["ruleId"] for r in results} == rules
        assert all(r["level"] == "error" for r in results)
        assert {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]} == rules
        loc = results[0]["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith("bad_shapes.py")
        assert loc["region"]["startLine"] >= 1

    def test_write_baseline_workflow(self, tmp_path):
        """--write-baseline then --baseline: the seeded violations land in
        the file and a rerun against it is clean."""
        baseline = str(tmp_path / "baseline.txt")
        args = ["--pass", "shapes", fixture("bad_shapes.py"), "--baseline", baseline]
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            assert cli.main(args + ["--write-baseline"]) == 0
            text = open(baseline).read()
            assert "SHP601\t" in text and "SHP603\t" in text
            assert cli.main(args) == 0
        assert "suppressed" in err.getvalue()


class TestSmokeAudit:
    """chip_smoke.py phase 15's bookkeeping on the CPU: the sanctioned
    sites it reads from the host-sync rule, and the check it makes of the
    syncs the card reports."""

    @pytest.fixture(scope="class")
    def sanctioned(self):
        import chip_smoke

        return chip_smoke, chip_smoke.sanctioned_syncs()

    @staticmethod
    def _line(rel, text):
        lines = open(os.path.join(REPO, rel)).read().split("\n")
        hits = [i + 1 for i, line in enumerate(lines) if text in line]
        assert len(hits) == 1, text
        return hits[0]

    def test_every_sanctioned_statement_covered(self, sanctioned):
        smoke, (spans, implicit) = sanctioned
        drain = self._line("karpenter_tpu_torch/solver/driver.py",
                           "return [x.cpu().numpy() for x in out]")
        relax = self._line("karpenter_tpu_torch/ops/relax.py",
                           "x.cpu().numpy() for x in relax_fill(")
        syncs = [("karpenter_tpu_torch/solver/driver.py", drain, "TorchSolver._drain_host"),
                 ("karpenter_tpu_torch/ops/relax.py", relax, "solve_bulk.<locals>.<genexpr>"),
                 ("karpenter_tpu_torch/solver/args.py", 30, "put")]
        assert smoke.unsanctioned(syncs, spans, implicit) == []
        assert len(spans) == 4

    def test_a_sync_elsewhere_is_caught(self, sanctioned):
        smoke, (spans, implicit) = sanctioned
        drain = self._line("karpenter_tpu_torch/solver/driver.py",
                           "return [x.cpu().numpy() for x in out]")
        stray = [("karpenter_tpu_torch/solver/driver.py", drain + 1, "TorchSolver._drain_host"),
                 ("karpenter_tpu_torch/ops/packing.py", 1, "pack"),
                 ("<outside the port>", 0, "torch/_tensor.py:1")]
        assert smoke.unsanctioned(stray, spans, implicit) == stray


class TestLeaseRepair:
    """Two solves leasing a fresh EncodeCache's device store at once get
    the same store: the check-then-act runs under EncodeCache.lock (the
    race the guarded pass reported as GRD1301)."""

    @pytest.mark.parametrize("scenario", [False, True])
    def test_concurrent_leases_share_one_store(self, scenario, monkeypatch):
        from karpenter_tpu_torch.solver import driver

        real = driver.DeviceResidentArgs

        def slow(**kw):
            time.sleep(0.05)  # widen the window between the check and the act
            return real(**kw)

        monkeypatch.setattr(driver, "DeviceResidentArgs", slow)
        cache = driver.EncodeCache()
        barrier = threading.Barrier(4)
        got = []

        def lease():
            barrier.wait(timeout=10)
            got.append(cache.lease_device_store(scenario=scenario))

        threads = [threading.Thread(target=lease) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 4 and len({id(s) for s in got}) == 1
        held = cache.scenario_device_store if scenario else cache.device_store
        assert held is got[0]
