"""The master daemon.

The counterpart of ``gpumounter_tpu/master/main.py:15-125``, and of the
original's ``cmd/GPUMounter-master/main.go:230-246``: the HTTP API on
MASTER_PORT (8080) over the Kubernetes client of
``k8s.client.default_client`` (the pod's service account in the cluster),
until SIGTERM. The trace ring, the audit trail and the flight recorder take
their capacities and JSONL sinks from config (TPUMOUNTER_TRACE_RING,
TPUMOUNTER_TRACE_JSONL, ...). The master's store and its degraded mode read
theirs from the environment too: the ApiHealth thresholds
(API_HEALTH_DEGRADED_FAILURES, API_HEALTH_DOWN_AFTER_S,
API_HEALTH_RECOVERY_SUCCESSES, API_HEALTH_PROBE_INTERVAL_S), the cache's bound
(API_CACHE_MAX_STALENESS_S), the write-behind queue's directory and size
(TPUMOUNTER_WRITEBEHIND_DIR, opened at start and replayed when the API is
healthy; TPUMOUNTER_WRITEBEHIND_MAX_BYTES), the watch-backed store
(TPUMOUNTER_WATCH_STORE, WATCH_STORE_*) and the annotation writes' retries
(K8S_WRITE_ATTEMPTS, K8S_WRITE_RETRY_BASE_S). With TPUMOUNTER_SHARD_COUNT > 1 the
replica runs the shard leases' renew loop (``master/shard.py``: SHARD_LEASE_*,
TPUMOUNTER_REPLICA_ID or HOSTNAME, TPUMOUNTER_ADVERTISE_URL,
TPUMOUNTER_SHARD_PREFERRED) and hands its leases back on exit, so a peer takes
them over at once, and a batch's node groups in flight are capped by shard
(TPUMOUNTER_FANOUT_SHARD_BUDGET, where BULK_NODE_FANOUT caps them all when
the count is 1); MASTER_HTTP_CONCURRENCY sets the admission gate. The fleet
collector (``obs/fleet.py``) pulls every owned worker's telemetry each
FLEET_SCRAPE_INTERVAL_S into the rollup of /fleet and the SLO engine's burn
rates (TPUMOUNTER_SLO_OBJECTIVES, SLO_*), and stops before the app closes;
the read scope is TPUMOUNTER_AUTH_READ_TOKEN. The reference's other
background loops (elastic intents, recovery, defragmenter, autoscaler,
canary) come with their packages.

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
    if cfg.shard_count > 1:
        app.shards.start()
        logger.info("shard manager on: %d shards, replica %s, lease %.0fs",
                    app.shards.shard_count, app.shards.replica_id, app.shards.duration_s)
    app.fleet.start()
    httpd = build_http_server(app)

    def _term(signum, frame):
        logger.info("signal %d: shutting down", signum)
        # shutdown() waits for serve_forever, which runs on this thread
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    logger.info("gpu-mounter master serving on :%d (write-behind queue %s)",
                httpd.server_address[1], cfg.writebehind_dir or "in memory")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if cfg.shard_count > 1:
            # hand the leases back: the peers claim them now, not at expiry
            app.shards.stop(release=True)
        app.close()  # the fleet collector's loop first


if __name__ == "__main__":
    main()
