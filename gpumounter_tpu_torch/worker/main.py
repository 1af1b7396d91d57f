"""The worker daemon.

The counterpart of ``gpumounter_tpu/worker/main.py:225-286``, and of the
original's ``cmd/GPUMounter-worker/main.go``: build the collector (the
kubelet's pod-resources API on KUBELET_POD_RESOURCES_SOCKET), the allocator
and the mounter on the ``NvidiaDeviceBackend`` (or the fake one under
FAKE_DEVICE_DIR), serve gRPC on WORKER_PORT (1200) and the ops port on
METRICS_PORT (``serve_ops``: /healthz, /metrics, /telemetry, /audit,
/trace/<id>, /timeline, /apihealth and POST /tenant-telemetry). The
Kubernetes client is ``k8s.client.default_client``: the pod's service
account in the cluster.

The reference's order (``gpumounter_tpu/worker/main.py:241-283``): with
TPUMOUNTER_LEDGER_DIR set, the ledger's replay (``worker/resync.py``) runs
before the server serves and before the reaper's first pass, so that the
reaper sees the books as the replay left them, with a warning when the last
process died with open transactions; then the slave reaper
(``worker/reaper.py``) starts on the mounter's cgroup controller. On
SIGTERM the reaper and the warm pool's refiller stop, the service drains (new mutations refused, those
in flight finished, the ledger closed clean; WORKER_DRAIN_TIMEOUT_S), and
then the gRPC server stops.

The trace ring, the audit trail and the flight recorder take their
capacities and JSONL sinks from config (TPUMOUNTER_TRACE_RING,
TPUMOUNTER_TRACE_JSONL, ...), and the worker's ApiHealth (whose write plane
gates the deferred releases' retry) its thresholds
(API_HEALTH_DEGRADED_FAILURES, API_HEALTH_DOWN_AFTER_S,
API_HEALTH_RECOVERY_SUCCESSES). The ops port's reads take the read token
(TPUMOUNTER_AUTH_READ_TOKEN) or the mutate token, its POST the mutate token
only, and its tenant store holds TPUMOUNTER_TENANT_MAX tenants and
``_overflow``.

    python -m gpumounter_tpu_torch.worker.main
"""

from __future__ import annotations

import json
import signal
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gpumounter_tpu_torch import obs
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.collector.podresources import PodResourcesClient
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import backend_from_config
from gpumounter_tpu_torch.k8s.client import default_client
from gpumounter_tpu_torch.k8s.health import api_health
from gpumounter_tpu_torch.obs import audit, flight, trace
from gpumounter_tpu_torch.obs.fleet import worker_telemetry_snapshot
from gpumounter_tpu_torch.obs.tenants import (
    TENANT_SNAPSHOTS_REJECTED,
    TENANTS,
    parse_tenant_snapshot,
)
from gpumounter_tpu_torch.utils.auth import check_bearer, required_token, resolve_read_token
from gpumounter_tpu_torch.utils.log import get_logger, init_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.worker.reaper import SlaveReaper
from gpumounter_tpu_torch.worker.resync import LedgerResync
from gpumounter_tpu_torch.worker.server import GpuMountService, build_server

logger = get_logger("worker.main")


def _make_ops_handler(read_token: str | None, mutate_token: str | None, cfg: Config):
    """The worker's ops port (the reference's ``worker/main.py:26-222``):

      * GET /healthz, open for probes: 200 "ok", with "api: <verdict>"
        while the Kubernetes API is unhealthy;
      * GET /metrics: the exposition, with the histograms' trace-id
        exemplars when the scraper asks for OpenMetrics (Accept
        application/openmetrics-text);
      * GET /telemetry (the CollectTelemetry snapshot), /audit, /trace/<id>
        (this process's ring, ``obs.trace.trace_payload``), /timeline and
        /apihealth: the worker's halves of the master's reads, under the
        same query contracts;
      * POST /tenant-telemetry: a tenant's snapshot into the store
        (``obs/tenants.py``); 400 when it does not parse.

    The read scope: the reads take the read token or the mutate token; with
    no read token /metrics stays open and the others want the mutate token.
    The POST wants the mutate token: a read token never writes the store.
    /healthz is always open."""

    def _read_allowed(auth_header: str | None) -> bool:
        if read_token is not None:
            return check_bearer(auth_header, read_token) or (
                mutate_token is not None and check_bearer(auth_header, mutate_token))
        if mutate_token is None:
            return True  # TPUMOUNTER_AUTH=insecure
        return check_bearer(auth_header, mutate_token)

    def _mutate_allowed(auth_header: str | None) -> bool:
        if mutate_token is None:
            return True  # TPUMOUNTER_AUTH=insecure
        return check_bearer(auth_header, mutate_token)

    class _OpsHandler(BaseHTTPRequestHandler):
        def _answer(self, ctype: str, body: bytes) -> None:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, payload) -> None:
            self._answer("application/json", (json.dumps(payload, indent=1) + "\n").encode())

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's name
            parsed = urllib.parse.urlsplit(self.path)
            path, auth = parsed.path, self.headers.get("Authorization")
            if path == "/healthz":
                # liveness stays 200 through an API outage; the verdict is in
                # the body
                state = api_health().state()
                self._answer("text/plain", b"ok\n" if state == "healthy"
                             else f"ok\napi: {state}\n".encode())
                return
            if path == "/metrics":
                if read_token is not None and not _read_allowed(auth):
                    self.send_error(401)
                    return
                if "application/openmetrics-text" in self.headers.get("Accept", ""):
                    self._answer("application/openmetrics-text; version=1.0.0",
                                 REGISTRY.render(openmetrics=True).encode())
                else:
                    self._answer("text/plain; version=0.0.4", REGISTRY.render().encode())
                return
            if path not in ("/apihealth", "/telemetry", "/audit", "/timeline") \
                    and not path.startswith("/trace/"):
                self.send_error(404)
                return
            if not _read_allowed(auth):
                self.send_error(401)
                return
            params = urllib.parse.parse_qs(parsed.query)
            if path == "/apihealth":
                self._json({"api": api_health().payload()})
            elif path == "/telemetry":
                self._json(worker_telemetry_snapshot(cfg=cfg))
            elif path.startswith("/trace/"):
                payload = trace.trace_payload(path[len("/trace/"):])
                if payload is None:
                    self.send_error(404)
                    return
                self._json(payload)
            else:
                query = audit.query_from_params if path == "/audit" else flight.query_from_params
                try:
                    payload = query(params)
                except ValueError:
                    self.send_error(400)
                    return
                self._json(payload)

        def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler's name
            if urllib.parse.urlsplit(self.path).path != "/tenant-telemetry":
                self.send_error(404)
                return
            if not _mutate_allowed(self.headers.get("Authorization")):
                self.send_error(401)
                return
            length = int(self.headers.get("Content-Length") or 0)
            snapshot = parse_tenant_snapshot(self.rfile.read(length) if length else b"")
            if snapshot is None:
                TENANT_SNAPSHOTS_REJECTED.inc()
                self.send_error(400)
                return
            self._json({"stored": TENANTS.ingest(snapshot)})

        def log_message(self, fmt, *args):
            pass

    return _OpsHandler


def serve_ops(port: int, cfg: Config | None = None, host: str = "0.0.0.0"
              ) -> ThreadingHTTPServer:
    """The ops port on `host`:`port` (0: an ephemeral one,
    ``server_address[1]``), serving on a thread of its own. The tenant
    store's cap is TPUMOUNTER_TENANT_MAX; the mutate token is the daemon's
    (fail-closed: AuthConfigError without one, unless
    TPUMOUNTER_AUTH=insecure), the read token TPUMOUNTER_AUTH_READ_TOKEN."""
    cfg = cfg or Config()
    TENANTS.max_tenants = int(cfg.tenant_max)
    handler = _make_ops_handler(resolve_read_token(cfg), required_token(cfg, "worker ops port"),
                                cfg)
    httpd = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=httpd.serve_forever, name="worker-ops", daemon=True).start()
    return httpd


def build_service(cfg: Config) -> GpuMountService:
    """The node's service: the device backend from config, the kubelet over
    its socket, the API server through the default client."""
    collector = GpuCollector(
        backend_from_config(cfg),
        PodResourcesClient(cfg.kubelet_socket, timeout_s=cfg.kubelet_conn_timeout_s,
                           api=cfg.pod_resources_api),
        cfg=cfg)
    return GpuMountService(default_client(), collector, cfg=cfg)


def main() -> None:
    init_logger()
    cfg = Config()
    obs.configure(cfg)
    service = build_service(cfg)
    if service.ledger is not None:
        replay = LedgerResync(service).replay_once()
        if not service.ledger.was_clean_shutdown() and replay["open"]:
            logger.warning("previous worker process crashed; replay converged %d open "
                           "transaction(s)", replay["open"])
        logger.info("ledger replay: %d open transaction(s), %d holding(s) corrected",
                    replay["open"], replay["holdings_corrected"])
    server = build_server(service)
    ops = serve_ops(cfg.metrics_port, cfg)
    reaper = SlaveReaper(service.kube, cfg=cfg,
                         device_controller=service.mounter.controller).start()
    stop = threading.Event()

    def _term(signum, frame):
        logger.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    server.start()
    logger.info("gpu-mounter worker serving gRPC on :%d, ops on :%d; %d GPU(s) in "
                "inventory", server.bound_port, cfg.metrics_port,
                len(service.collector.devices))
    stop.wait()
    reaper.stop()
    if service.pool is not None:
        # the warm holders stay Running: the next process re-adopts them
        # (ensure_node's resync); only the refiller stops
        service.pool.stop()
    drained = service.drain(cfg.drain_timeout_s)
    logger.info("drain %s; stopping gRPC", "clean" if drained else
                "timed out (as a crash: the next start's replay converges it)")
    server.stop(grace=5).wait()
    ops.shutdown()
    ops.server_close()


if __name__ == "__main__":
    main()
