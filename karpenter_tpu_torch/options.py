# Copied from karpenter_tpu/options.py, --solver-backend takes the port's backends ("kernels", "native").
"""Operator configuration: CLI flags with environment-variable fallback.

Plays the role of pkg/operator/options (options.go:50-161): every knob is a
flag whose default comes from an env var, durations parse Go-style strings
("10s", "1m30s"), and feature gates arrive as one "Name=bool,..." string
(options.go:128-148). Instead of riding on a context.Context, the parsed
``Options`` object is passed explicitly to the Operator.
"""

from __future__ import annotations

import argparse
import os
import re
from dataclasses import dataclass, field, fields
from typing import List, Optional

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(h|ms|m|s|us|µs|ns)")
_DURATION_UNIT = {
    "h": 3600.0,
    "m": 60.0,
    "s": 1.0,
    "ms": 1e-3,
    "us": 1e-6,
    "µs": 1e-6,
    "ns": 1e-9,
}

VALID_LOG_LEVELS = ("", "debug", "info", "error")  # options.go:34
KNOWN_FEATURE_GATES = ("NodeRepair", "ReservedCapacity", "SpotToSpotConsolidation")


def parse_duration(s: str) -> float:
    """Parse a Go duration string ("10s", "1m30s", "100ms") to seconds."""
    if isinstance(s, (int, float)):
        return float(s)
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    if not s:
        raise ValueError("empty duration")
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += float(m.group(1)) * _DURATION_UNIT[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {s!r}")
    return -total if neg else total


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return int(raw) if raw is not None else default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    if raw not in ("true", "false"):
        raise ValueError(f"{name}={raw!r} is not a valid value, must be true or false")
    return raw == "true"


def _env_duration(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return parse_duration(raw) if raw is not None else default


@dataclass
class FeatureGates:
    """Feature-gate map parsed from "Name=bool,..." (options.go:41-47, 128-148)."""

    node_repair: bool = False
    reserved_capacity: bool = False
    spot_to_spot_consolidation: bool = False

    @classmethod
    def parse(cls, s: str) -> "FeatureGates":
        gates = cls()
        if not s.strip():
            return gates
        attr = {
            "NodeRepair": "node_repair",
            "ReservedCapacity": "reserved_capacity",
            "SpotToSpotConsolidation": "spot_to_spot_consolidation",
        }
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"invalid feature gate {part!r}, expected Name=bool")
            name, _, val = part.partition("=")
            name, val = name.strip(), val.strip().lower()
            if val not in ("true", "false"):
                raise ValueError(f"feature gate {name}={val!r} must be true or false")
            if name in attr:
                setattr(gates, attr[name], val == "true")
            # unknown gates are tolerated (forward compatibility), like
            # utilflag.NewMapStringBool which only errs on malformed syntax
        return gates


@dataclass
class Options:
    """All operator knobs (options.go:50-67). These dataclass defaults are
    the single source of truth; build_parser() reads them, then env vars
    override defaults and explicit flags override env vars."""

    service_name: str = ""
    metrics_port: int = 8080
    health_probe_port: int = 8081
    kube_client_qps: int = 200
    kube_client_burst: int = 300
    enable_profiling: bool = False
    disable_leader_election: bool = False
    leader_election_name: str = "karpenter-leader-election"
    leader_election_namespace: str = ""
    memory_limit: int = -1
    log_level: str = "info"
    log_output_paths: str = "stdout"
    log_error_output_paths: str = "stderr"
    batch_max_duration: float = 10.0  # options.go:100
    batch_idle_duration: float = 1.0  # options.go:101
    feature_gates: FeatureGates = field(default_factory=FeatureGates)
    # kwok-style extension (kwok/options/options.go)
    instance_types_file_path: str = ""
    # solver: "kernels" (the hand-written CUDA kernels) or "native" (C++
    # host core); solver-mesh "auto" shards solves over every CUDA card
    # when more than one is present (SolverConfig.mesh), "" = single device
    solver_backend: str = "kernels"
    solver_mesh: str = ""
    # gRPC solver-sidecar target (host:port); "" = solve in-process
    solver_address: str = ""
    # decision-path span tracing (obs/): off by default; the seed keeps
    # replayed chaos runs producing identical traces
    enable_tracing: bool = False
    trace_seed: int = 0
    # shutdown artifact paths ("" skips): Chrome trace-event JSON and the
    # Prometheus text exposition of the metrics registry
    trace_path: str = ""
    metrics_dump_path: str = ""

    def validate(self) -> None:
        if self.log_level not in VALID_LOG_LEVELS:
            raise ValueError(
                f"invalid log level {self.log_level!r}, must be one of {VALID_LOG_LEVELS}"
            )
        if self.batch_max_duration <= 0:
            raise ValueError("batch-max-duration must be positive")
        if self.batch_idle_duration <= 0:
            raise ValueError("batch-idle-duration must be positive")
        if self.solver_backend not in ("kernels", "native"):
            raise ValueError(
                f"invalid solver backend {self.solver_backend!r},"
                " must be 'kernels' or 'native'"
            )
        if self.solver_mesh not in ("", "auto"):
            raise ValueError(
                f"invalid solver mesh {self.solver_mesh!r},"
                " must be '' or 'auto'"
            )


def build_parser() -> argparse.ArgumentParser:
    """Flag set with env fallback for every flag (FlagSet, options.go:69-103).
    Defaults come from the Options dataclass so they are defined once."""
    d = Options()
    p = argparse.ArgumentParser(prog="karpenter-tpu", add_help=True)
    p.add_argument("--karpenter-service", dest="service_name",
                   default=_env_str("KARPENTER_SERVICE", d.service_name))
    p.add_argument("--metrics-port", dest="metrics_port", type=int,
                   default=_env_int("METRICS_PORT", d.metrics_port))
    p.add_argument("--health-probe-port", dest="health_probe_port", type=int,
                   default=_env_int("HEALTH_PROBE_PORT", d.health_probe_port))
    p.add_argument("--kube-client-qps", dest="kube_client_qps", type=int,
                   default=_env_int("KUBE_CLIENT_QPS", d.kube_client_qps))
    p.add_argument("--kube-client-burst", dest="kube_client_burst", type=int,
                   default=_env_int("KUBE_CLIENT_BURST", d.kube_client_burst))
    p.add_argument("--enable-profiling", dest="enable_profiling",
                   choices=("true", "false"),
                   default=str(_env_bool("ENABLE_PROFILING", d.enable_profiling)).lower())
    p.add_argument("--disable-leader-election", dest="disable_leader_election",
                   choices=("true", "false"),
                   default=str(_env_bool(
                       "DISABLE_LEADER_ELECTION", d.disable_leader_election)).lower())
    p.add_argument("--leader-election-name", dest="leader_election_name",
                   default=_env_str("LEADER_ELECTION_NAME", d.leader_election_name))
    p.add_argument("--leader-election-namespace", dest="leader_election_namespace",
                   default=_env_str(
                       "LEADER_ELECTION_NAMESPACE", d.leader_election_namespace))
    p.add_argument("--memory-limit", dest="memory_limit", type=int,
                   default=_env_int("MEMORY_LIMIT", d.memory_limit))
    p.add_argument("--log-level", dest="log_level",
                   default=_env_str("LOG_LEVEL", d.log_level))
    p.add_argument("--log-output-paths", dest="log_output_paths",
                   default=_env_str("LOG_OUTPUT_PATHS", d.log_output_paths))
    p.add_argument("--log-error-output-paths", dest="log_error_output_paths",
                   default=_env_str("LOG_ERROR_OUTPUT_PATHS", d.log_error_output_paths))
    p.add_argument("--batch-max-duration", dest="batch_max_duration",
                   default=os.environ.get(
                       "BATCH_MAX_DURATION", f"{d.batch_max_duration}s"))
    p.add_argument("--batch-idle-duration", dest="batch_idle_duration",
                   default=os.environ.get(
                       "BATCH_IDLE_DURATION", f"{d.batch_idle_duration}s"))
    p.add_argument("--feature-gates", dest="feature_gates",
                   default=_env_str(
                       "FEATURE_GATES",
                       "NodeRepair=false,ReservedCapacity=false,SpotToSpotConsolidation=false",
                   ))
    p.add_argument("--instance-types-file-path", dest="instance_types_file_path",
                   default=_env_str(
                       "INSTANCE_TYPES_FILE_PATH", d.instance_types_file_path))
    p.add_argument("--solver-backend", dest="solver_backend",
                   default=_env_str("SOLVER_BACKEND", d.solver_backend))
    p.add_argument("--solver-mesh", dest="solver_mesh",
                   default=_env_str("SOLVER_MESH", d.solver_mesh))
    p.add_argument("--solver-address", dest="solver_address",
                   default=_env_str(
                       "KARPENTER_SOLVER_ADDRESS", d.solver_address))
    p.add_argument("--enable-tracing", dest="enable_tracing",
                   choices=("true", "false"),
                   default=str(_env_bool(
                       "ENABLE_TRACING", d.enable_tracing)).lower())
    p.add_argument("--trace-seed", dest="trace_seed", type=int,
                   default=_env_int("TRACE_SEED", d.trace_seed))
    p.add_argument("--trace-path", dest="trace_path",
                   default=_env_str("TRACE_PATH", d.trace_path))
    p.add_argument("--metrics-dump-path", dest="metrics_dump_path",
                   default=_env_str(
                       "METRICS_DUMP_PATH", d.metrics_dump_path))
    return p


def parse_options(argv: Optional[List[str]] = None) -> Options:
    """Parse argv into validated Options; None means sys.argv[1:] (standard
    argparse convention)."""
    ns = build_parser().parse_args(argv)
    opts = Options(
        service_name=ns.service_name,
        metrics_port=ns.metrics_port,
        health_probe_port=ns.health_probe_port,
        kube_client_qps=ns.kube_client_qps,
        kube_client_burst=ns.kube_client_burst,
        enable_profiling=ns.enable_profiling == "true",
        disable_leader_election=ns.disable_leader_election == "true",
        leader_election_name=ns.leader_election_name,
        leader_election_namespace=ns.leader_election_namespace,
        memory_limit=ns.memory_limit,
        log_level=ns.log_level,
        log_output_paths=ns.log_output_paths,
        log_error_output_paths=ns.log_error_output_paths,
        batch_max_duration=parse_duration(ns.batch_max_duration),
        batch_idle_duration=parse_duration(ns.batch_idle_duration),
        feature_gates=FeatureGates.parse(ns.feature_gates),
        instance_types_file_path=ns.instance_types_file_path,
        solver_backend=ns.solver_backend,
        solver_mesh=ns.solver_mesh,
        solver_address=ns.solver_address,
        enable_tracing=ns.enable_tracing == "true",
        trace_seed=ns.trace_seed,
        trace_path=ns.trace_path,
        metrics_dump_path=ns.metrics_dump_path,
    )
    opts.validate()
    return opts


__all__ = [
    "FeatureGates",
    "Options",
    "build_parser",
    "parse_duration",
    "parse_options",
]
