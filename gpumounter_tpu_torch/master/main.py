"""The master daemon.

The counterpart of ``gpumounter_tpu/master/main.py:15-125``, and of the
original's ``cmd/GPUMounter-master/main.go:230-246``: the HTTP API on
MASTER_PORT (8080) over the Kubernetes client of
``k8s.client.default_client`` (the pod's service account in the cluster),
until SIGTERM. The trace ring, the audit trail and the flight recorder take
their capacities and JSONL sinks from config (TPUMOUNTER_TRACE_RING,
TPUMOUNTER_TRACE_JSONL, ...). The reference's background loops (elastic intents, recovery,
defragmenter, autoscaler, canary, fleet collection, shard leases) come with
their packages.

    python -m gpumounter_tpu_torch.master.main
"""

from __future__ import annotations

import signal
import threading

from gpumounter_tpu_torch import obs
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import default_client
from gpumounter_tpu_torch.master.app import MasterApp, build_http_server
from gpumounter_tpu_torch.utils.log import get_logger, init_logger

logger = get_logger("master.main")


def main() -> None:
    init_logger()
    cfg = Config()
    obs.configure(cfg)
    app = MasterApp(default_client(), cfg=cfg)
    httpd = build_http_server(app)

    def _term(signum, frame):
        logger.info("signal %d: shutting down", signum)
        # shutdown() waits for serve_forever, which runs on this thread
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    logger.info("gpu-mounter master serving on :%d", httpd.server_address[1])
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        app.registry.stop()


if __name__ == "__main__":
    main()
