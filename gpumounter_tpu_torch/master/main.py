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
the read scope is TPUMOUNTER_AUTH_READ_TOKEN. The recovery controller
(``recovery/controller.py``) runs its pass each RECOVERY_INTERVAL_S unless
TPUMOUNTER_RECOVERY=0 (RECOVERY_CONFIRM_FAILURES, RECOVERY_GRACE_S,
RECOVERY_PROBE_TIMEOUT_S), and the health plane's canary prober
(``health/plane.py``) each HEALTH_CANARY_INTERVAL_S while TPUMOUNTER_HEALTH is
on and the interval above 0 (the scorer rides the fleet collector's passes,
HEALTH_*); both stop before the app closes. The elastic reconciler's loop
always runs (ELASTIC_RESYNC_INTERVAL_S, ELASTIC_BACKOFF_*,
ELASTIC_MIN_RECONCILE_INTERVAL_S), and the interrupted migrations are adopted
once at start and at every shard takeover (MIGRATE_*); the reconciler stops
and the machines are waited for before the app closes. The defragmenter's
loop (``defrag/controller.py``) runs each DEFRAG_INTERVAL_S only under
TPUMOUNTER_DEFRAG (DEFRAG_MAX_MOVES, DEFRAG_TENANT_MOVE_BUDGET,
DEFRAG_SNAPSHOT_MAX_AGE_S, DEFRAG_TARGET_BLOCK, DEFRAG_GROUP_FANOUT). The
autoscaler's loop (``autoscale/controller.py``) runs each AUTOSCALE_INTERVAL_S
only under TPUMOUNTER_AUTOSCALE (AUTOSCALE_COOLDOWN_S, AUTOSCALE_STALE_S,
AUTOSCALE_MIN_SAMPLES, AUTOSCALE_HYSTERESIS, AUTOSCALE_MAX_STEP and the rest of
AUTOSCALE_*); its model learns from every collection pass either way. When the
app closes the autoscaler stops first, then the defragmenter.

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
        # a takeover (the first claims and a dead peer's shards alike) drives
        # that shard's interrupted migrations on from their journals; the
        # intents follow at the reconciler's next resync
        def _on_takeover(shards: set) -> None:
            adopted_now = app.migrations.resume_interrupted()
            if adopted_now:
                logger.warning("shard takeover %s: re-driving %d interrupted migration(s): %s",
                               sorted(shards), len(adopted_now), ", ".join(adopted_now))

        app.shards.on_takeover = _on_takeover
        app.shards.start()
        logger.info("shard manager on: %d shards, replica %s, lease %.0fs",
                    app.shards.shard_count, app.shards.replica_id, app.shards.duration_s)
    # the reconciler reads the intents from the pods' annotations when it
    # starts: they outlive a master's restart with no store of their own
    app.elastic.start()
    if cfg.recovery_enabled:
        app.recovery.start()
        logger.info("recovery controller on (interval %.0fs, confirm %d failures + %.0fs "
                    "grace)", cfg.recovery_interval_s, cfg.recovery_confirm_failures,
                    cfg.recovery_grace_s)
    if cfg.health_enabled and cfg.health_canary_interval_s > 0:
        app.canary.start()
        logger.info("health plane on (canary every %.0fs, quarantine budget %.0f%%)",
                    cfg.health_canary_interval_s, cfg.health_quarantine_budget * 100)
    app.fleet.start()
    # plans are in memory and cheap to compute again after a restart; a
    # move's migration journal is what recovers, through the adoption below
    if cfg.defrag_enabled:
        app.defrag.start()
        logger.info("defragmenter on (interval %.0fs, target block %d, max %d moves/plan)",
                    cfg.defrag_interval_s, cfg.defrag_target_block, cfg.defrag_max_moves)
    # the decision state is in memory: a restarted master passes quietly a
    # few times while its fits learn again from live telemetry
    if cfg.autoscale_enabled:
        app.autoscale.start()
        logger.info("autoscaler on (interval %.0fs, cooldown %.0fs, max step %d)",
                    cfg.autoscale_interval_s, cfg.autoscale_cooldown_s, cfg.autoscale_max_step)
    # a master that died in a migration adopts it and drives it on from its
    # journaled phase, rather than leave a tenant half drained
    adopted = app.migrations.resume_interrupted()
    if adopted:
        logger.warning("re-driving %d interrupted migration(s): %s", len(adopted),
                       ", ".join(adopted))
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
        # the autoscaler's, defragmenter's, canary's, recovery's,
        # reconciler's and fleet collector's loops and the migrations'
        # machines first
        app.close()


if __name__ == "__main__":
    main()
