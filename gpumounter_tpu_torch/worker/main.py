"""The worker daemon.

The counterpart of ``gpumounter_tpu/worker/main.py:225-286``, and of the
original's ``cmd/GPUMounter-worker/main.go``: build the collector (the
kubelet's pod-resources API on KUBELET_POD_RESOURCES_SOCKET), the allocator
and the mounter on the ``NvidiaDeviceBackend`` (or the fake one under
FAKE_DEVICE_DIR), serve gRPC on WORKER_PORT (1200) and /healthz on the ops
port (METRICS_PORT), and stop on SIGTERM. The Kubernetes client is
``k8s.client.default_client``: the pod's service account in the cluster.

The ops port's /metrics, /audit, /trace and /telemetry come with ``obs/``;
the ledger, its replay and the reaper with the worker's ledger slice.

    python -m gpumounter_tpu_torch.worker.main
"""

from __future__ import annotations

import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.collector.podresources import PodResourcesClient
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import backend_from_config
from gpumounter_tpu_torch.k8s.client import default_client
from gpumounter_tpu_torch.utils.log import get_logger
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
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    cfg = Config()
    service = build_service(cfg)
    server = build_server(service)
    ops = serve_ops(cfg.metrics_port)
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
    server.stop(grace=5).wait()
    ops.shutdown()
    ops.server_close()


if __name__ == "__main__":
    main()
