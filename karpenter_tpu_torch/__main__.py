# Copied from karpenter_tpu/__main__.py.
"""Operator binary: the kwok/main.go + pkg/operator equivalent.

``python -m karpenter_tpu`` parses flags/env (options.py), builds the
kwok-style provider over an in-process store, wires the full controller
roster (operator.py), and runs the level-triggered loop under a real clock —
with the metrics exposition and health probes served over HTTP like the
reference's metrics/health servers (operator.go:142-158).
"""

from __future__ import annotations

import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from .cloudprovider import corpus
from .cloudprovider.kwok import KwokCloudProvider
from .cloudprovider.metrics import MetricsCloudProvider
from .kube import Client, RealClock
from .metrics import REGISTRY
from .operator import Operator, OperatorOptions
from .options import Options, parse_options


def _http_server(port: int, handler_cls) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer(("0.0.0.0", port), handler_cls)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def serve_metrics(port: int) -> ThreadingHTTPServer:
    """Prometheus-style exposition (operator.go:142-150)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = REGISTRY.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    return _http_server(port, Handler)


def serve_health(port: int, operator: Operator) -> ThreadingHTTPServer:
    """Liveness + readiness probes (operator.go:151-158): ready once the
    cluster state cache is synced."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/healthz":
                code, body = 200, b"ok"
            elif self.path == "/readyz":
                synced = operator.cluster.synced()
                code, body = (200, b"ok") if synced else (503, b"state not synced")
            else:
                code, body = 404, b""
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    return _http_server(port, Handler)


def build_operator(opts: Options, client: Optional[Client] = None) -> Operator:
    """Options → wired operator over the kwok provider."""
    client = client or Client(RealClock())
    if opts.instance_types_file_path:
        instance_types = corpus.load_file(opts.instance_types_file_path)
    else:
        instance_types = corpus.generate(144)  # kwok corpus size
    provider = MetricsCloudProvider(KwokCloudProvider(client, instance_types))
    return Operator(client, provider, OperatorOptions.from_options(opts))


def main(argv: Optional[List[str]] = None) -> int:
    opts = parse_options(argv)
    operator = build_operator(opts)
    metrics_server = serve_metrics(opts.metrics_port)
    health_server = serve_health(opts.health_probe_port, operator)
    print(
        json.dumps(
            {
                "msg": "operator started",
                "metrics_port": metrics_server.server_address[1],
                "health_probe_port": health_server.server_address[1],
                "feature_gates": vars(opts.feature_gates),
            }
        ),
        flush=True,
    )

    stop = threading.Event()

    def _graceful(_sig, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    # tick through the injected clock (a RealClock here, but the same seam
    # tests drive with a TestClock — and the blocking-call lint enforces)
    while not stop.is_set():
        operator.step()
        operator.clock.sleep(1.0)

    metrics_server.shutdown()
    health_server.shutdown()
    # flush observability artifacts (metrics exposition + Chrome trace)
    operator.shutdown()
    print(json.dumps({"msg": "operator stopped"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
