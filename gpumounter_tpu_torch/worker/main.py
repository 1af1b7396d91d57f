"""The worker daemon.

The counterpart of ``gpumounter_tpu/worker/main.py:225-286``, and of the
original's ``cmd/GPUMounter-worker/main.go``: build the collector (the
kubelet's pod-resources API on KUBELET_POD_RESOURCES_SOCKET), the allocator
and the mounter on the ``NvidiaDeviceBackend`` (or the fake one under
FAKE_DEVICE_DIR), serve gRPC on WORKER_PORT (1200) and /healthz on the ops
port (METRICS_PORT). The Kubernetes client is ``k8s.client.default_client``:
the pod's service account in the cluster.

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
API_HEALTH_RECOVERY_SUCCESSES). The ops port's /apihealth, /metrics, /audit,
/trace, /timeline and /telemetry come with the fleet planes.

    python -m gpumounter_tpu_torch.worker.main
"""

from __future__ import annotations

import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gpumounter_tpu_torch import obs
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.collector.podresources import PodResourcesClient
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import backend_from_config
from gpumounter_tpu_torch.k8s.client import default_client
from gpumounter_tpu_torch.utils.log import get_logger, init_logger
from gpumounter_tpu_torch.worker.reaper import SlaveReaper
from gpumounter_tpu_torch.worker.resync import LedgerResync
from gpumounter_tpu_torch.worker.server import GpuMountService, build_server

logger = get_logger("worker.main")


class _OpsHandler(BaseHTTPRequestHandler):
    """/healthz, open for probes."""

    def do_GET(self):
        status, body = (200, b"ok\n") if self.path == "/healthz" else (404, b"not found\n")
        self.send_response(status)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass


def serve_ops(port: int) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _OpsHandler)
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
    ops = serve_ops(cfg.metrics_port)
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
