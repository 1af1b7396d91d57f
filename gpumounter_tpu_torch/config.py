"""Configuration of the control plane's mount path and its transport.

The counterpart of ``gpumounter_tpu/config/config.py``, holding only the
fields the device layer, the collector, the allocator, the cgroup layer, the
mounter, the transport, the master (with its slice and batch routes and their
fan-out core), the observability stores, the worker's ledger and drain, the master's
store with its API-outage degraded mode, the sharded masters, the warm pool, the
fleet planes (telemetry, SLOs, tenants, the trace assembly), the recovery
controller, the gray-failure health plane, the elastic reconciler, the live
migration, the capacity plane, the fractional shares and the two daemons read. Every field is an environment variable with the original GPUMounter's value
as default; the names are the reference's where the meaning is the same. NVIDIA-specific: the resource ``nvidia.com/gpu``
(``pkg/util/gpu/types.go:10``), the pool namespace ``gpu-pool``
(``types.go:18``), the worker pods' label ``app=gpu-mounter-worker``, the
request cap ``MAX_GPU_PER_REQUEST``, and where a GPU's identity is read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass
class Config:
    # --- Kubernetes resource model ---
    gpu_resource_name: str = field(default_factory=lambda: _env(
        "GPU_RESOURCE_NAME", "nvidia.com/gpu"))
    pool_namespace: str = field(default_factory=lambda: _env(
        "GPU_POOL_NAMESPACE", "gpu-pool"))
    # Slave-pod image; the original uses an alpine sleep loop
    # (allocator.go:219-226).
    slave_pod_image: str = field(default_factory=lambda: _env(
        "SLAVE_POD_IMAGE", "alpine:latest"))

    # --- device layer ---
    # Where the GPU nodes live (/dev/nvidiaN, nvidiactl, nvidia-uvm*).
    # FAKE_DEVICE_DIR switches to a directory of fake nodes (dry runs).
    device_dir: str = field(default_factory=lambda: _env("DEVICE_DIR", "/dev"))
    fake_device_dir: str = field(default_factory=lambda: _env("FAKE_DEVICE_DIR", ""))
    # Which source ties a node to a GPU: "nvml" (libnvidia-ml through
    # ctypes, the original's nvml_dl.go path) or "procfs" (the driver's
    # /proc/driver/nvidia/gpus/<pci>/information).
    gpu_identity_source: str = field(default_factory=lambda: _env(
        "GPU_IDENTITY_SOURCE", "nvml"))
    nvml_library: str = field(default_factory=lambda: _env(
        "NVML_LIBRARY", "libnvidia-ml.so.1"))
    nvidia_procfs_dir: str = field(default_factory=lambda: _env(
        "NVIDIA_PROCFS_DIR", "/proc/driver/nvidia/gpus"))

    # --- cgroup layer ---
    # CGROUP_DRIVER in {systemd, cgroupfs} (cgroup.go:78-84); "auto" sniffs
    # /sys/fs/cgroup. CGROUP_VERSION "auto" detects v1 against v2.
    cgroup_driver: str = field(default_factory=lambda: _env("CGROUP_DRIVER", "auto"))
    cgroup_root: str = field(default_factory=lambda: _env("CGROUP_ROOT", "/sys/fs/cgroup"))
    cgroup_version: str = field(default_factory=lambda: _env("CGROUP_VERSION", "auto"))

    # --- allocator ---
    # The watch on a slave pod's phase ends after this long.
    slave_pod_timeout_s: float = field(default_factory=lambda: float(
        _env("SLAVE_POD_TIMEOUT_S", "120")))
    slave_pod_name_suffix: str = "-slave-pod-"
    # the warm pool (allocator/pool.py): this many single-GPU holder pods
    # kept Running a node, so that a mount adopts one (a label patch)
    # instead of paying create + schedule + wait; 0 (the default) is the
    # cold path alone. Each warm holder books a GPU while idle. The worker's
    # own node (downward API spec.nodeName), warmed at start when set
    node_name: str = field(default_factory=lambda: _env("NODE_NAME", ""))
    warm_pool_size: int = field(default_factory=lambda: int(_env("WARM_POOL_SIZE", "0")))
    # the floor between refills of a node whose last refill failed (a full
    # node must not see a hot loop of pod creates)
    warm_pool_retry_s: float = field(default_factory=lambda: float(
        _env("WARM_POOL_RETRY_S", "5")))

    # --- the kubelet's pod-resources API ---
    # the original's socket (types.go:6-7); "auto" asks v1, then v1alpha1
    kubelet_socket: str = field(default_factory=lambda: _env(
        "KUBELET_POD_RESOURCES_SOCKET", "/var/lib/kubelet/pod-resources/kubelet.sock"))
    pod_resources_api: str = field(default_factory=lambda: _env("POD_RESOURCES_API", "auto"))
    kubelet_conn_timeout_s: float = field(default_factory=lambda: float(
        _env("KUBELET_CONN_TIMEOUT_S", "10")))

    # --- the daemons' ports ---
    worker_port: int = field(default_factory=lambda: int(_env("WORKER_PORT", "1200")))
    master_port: int = field(default_factory=lambda: int(_env("MASTER_PORT", "8080")))
    # the worker's ops port (/healthz)
    metrics_port: int = field(default_factory=lambda: int(_env("METRICS_PORT", "9400")))

    # --- the master ---
    # the original parses gpuNum and never range-checks it
    # (cmd/GPUMounter-master/main.go:31-43)
    max_gpu_per_request: int = field(default_factory=lambda: int(
        _env("MAX_GPU_PER_REQUEST", "64")))
    worker_label_selector: str = field(default_factory=lambda: _env(
        "WORKER_LABEL_SELECTOR", "app=gpu-mounter-worker"))
    worker_namespace: str = field(default_factory=lambda: _env("WORKER_NAMESPACE", "kube-system"))
    # the target cap of one POST /batch/addgpu, and how many nodes one such
    # request mounts on at once (one worker client a node) when the shards
    # are inactive; with shards, fanout_shard_budget caps each owner shard
    bulk_max_targets: int = field(default_factory=lambda: int(_env("BULK_MAX_TARGETS", "256")))
    bulk_node_fanout: int = field(default_factory=lambda: int(_env("BULK_NODE_FANOUT", "16")))
    # the deadline of a sub-batch proxied to the replica that owns its nodes
    bulk_proxy_timeout_s: float = field(default_factory=lambda: float(
        _env("BULK_PROXY_TIMEOUT_S", "330")))
    # client requests one replica handles at once (0: unbounded); requests
    # forwarded by a peer replica wait on a gate of their own
    master_http_concurrency: int = field(default_factory=lambda: int(
        _env("MASTER_HTTP_CONCURRENCY", "0")))

    # --- sharded masters (master/shard.py) ---
    # node ownership split over this many shards by consistent hashing, one
    # leader a shard through a coordination.k8s.io/v1 Lease; 1 (the
    # default) is one master owning every node, with no lease traffic
    shard_count: int = field(default_factory=lambda: int(_env("TPUMOUNTER_SHARD_COUNT", "1")))
    # the lease's TTL, and the renew cadence (0: a third of the TTL)
    shard_lease_duration_s: float = field(default_factory=lambda: float(
        _env("SHARD_LEASE_DURATION_S", "15")))
    shard_renew_interval_s: float = field(default_factory=lambda: float(
        _env("SHARD_RENEW_INTERVAL_S", "0")))
    # the namespace of the tpumounter-shard-<i> leases ("": worker_namespace)
    shard_lease_namespace: str = field(default_factory=lambda: _env("SHARD_LEASE_NAMESPACE", ""))
    # this replica's identity in the leases: TPUMOUNTER_REPLICA_ID, else
    # $HOSTNAME (a StatefulSet pod's name, stable across restarts), else ""
    # (the shard manager then asks socket.gethostname())
    replica_id: str = field(default_factory=lambda: _env(
        "TPUMOUNTER_REPLICA_ID", "") or _env("HOSTNAME", ""))
    # where peers and clients reach this replica: stamped into the lease, so
    # a non-owner can redirect or proxy to the owner ("": a 503 instead)
    advertise_url: str = field(default_factory=lambda: _env("TPUMOUNTER_ADVERTISE_URL", ""))
    # the never-held shards this replica volunteers for: "auto" is its
    # StatefulSet ordinal modulo the count, "" any, or a list "0,2"; an
    # expired lease is open to every replica whatever this says
    shard_preferred: str = field(default_factory=lambda: _env(
        "TPUMOUNTER_SHARD_PREFERRED", "auto"))

    # --- the shared fan-out core (utils/fanout.py) ---
    # its width (0: 4 x the CPU count, at least 32), and the slots the
    # items of one shard may hold at once inside one pass (0: no cap): the
    # sharded batch's node groups in flight of each owner shard
    fanout_width: int = field(default_factory=lambda: int(_env("TPUMOUNTER_FANOUT_WIDTH", "0")))
    fanout_shard_budget: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_FANOUT_SHARD_BUDGET", "16")))

    # --- master -> worker calls ---
    # deadlines a method; bounded capped-exponential retries on UNAVAILABLE
    # and DEADLINE_EXCEEDED; the breaker opens after this many transport
    # failures in a row and lets one probe through after the reset
    rpc_add_timeout_s: float = field(default_factory=lambda: float(
        _env("RPC_ADD_TIMEOUT_S", "300")))
    rpc_remove_timeout_s: float = field(default_factory=lambda: float(
        _env("RPC_REMOVE_TIMEOUT_S", "120")))
    # CollectTelemetry reads memory: it fails fast, so that one wedged
    # worker cannot stall a fleet pass
    rpc_telemetry_timeout_s: float = field(default_factory=lambda: float(
        _env("RPC_TELEMETRY_TIMEOUT_S", "10")))
    # ProbeGPU is a read-only scan of the pod's GPUs: it fails fast too
    rpc_probe_timeout_s: float = field(default_factory=lambda: float(
        _env("RPC_PROBE_TIMEOUT_S", "15")))
    # QuiesceStatus reads the tenant's ack: the migration machine polls it
    rpc_quiesce_timeout_s: float = field(default_factory=lambda: float(
        _env("RPC_QUIESCE_TIMEOUT_S", "15")))
    rpc_max_attempts: int = field(default_factory=lambda: int(_env("RPC_MAX_ATTEMPTS", "3")))
    rpc_retry_base_s: float = field(default_factory=lambda: float(
        _env("RPC_RETRY_BASE_S", "0.1")))
    rpc_retry_cap_s: float = field(default_factory=lambda: float(_env("RPC_RETRY_CAP_S", "2")))
    breaker_failure_threshold: int = field(default_factory=lambda: int(
        _env("BREAKER_FAILURE_THRESHOLD", "5")))
    breaker_reset_s: float = field(default_factory=lambda: float(_env("BREAKER_RESET_S", "30")))
    # --- Kubernetes write retries (store/k8s.py's annotation stamps) ---
    # a merge-patch of an annotation re-applies safely after a 409 or a 5xx;
    # this many attempts, capped-exponential from the base
    k8s_write_attempts: int = field(default_factory=lambda: int(_env("K8S_WRITE_ATTEMPTS", "3")))
    k8s_write_retry_base_s: float = field(default_factory=lambda: float(
        _env("K8S_WRITE_RETRY_BASE_S", "0.1")))
    # the master's pooled channels: idle ones close after this long, and
    # keepalive pings keep the others warm
    channel_idle_evict_s: float = field(default_factory=lambda: float(
        _env("CHANNEL_IDLE_EVICT_S", "300")))
    channel_keepalive_time_s: float = field(default_factory=lambda: float(
        _env("CHANNEL_KEEPALIVE_TIME_S", "30")))

    # --- auth (utils/auth.py): "token" (the default) needs a secret ---
    auth_mode: str = field(default_factory=lambda: _env("TPUMOUNTER_AUTH", "token"))
    auth_token: str = field(default_factory=lambda: _env("TPUMOUNTER_AUTH_TOKEN", ""))
    auth_token_file: str = field(default_factory=lambda: _env("TPUMOUNTER_AUTH_TOKEN_FILE", ""))
    # the read scope of the observability routes (/metrics, /fleet, /slo,
    # /tenants, /audit, /trace, /timeline, /apihealth, /shards and the
    # worker's ops port): a credential that reads and never mutates; unset,
    # /metrics stays open and the other reads want the mutate token
    auth_read_token: str = field(default_factory=lambda: _env("TPUMOUNTER_AUTH_READ_TOKEN", ""))
    auth_read_token_file: str = field(default_factory=lambda: _env(
        "TPUMOUNTER_AUTH_READ_TOKEN_FILE", ""))

    # --- observability (obs/) ---
    # append-only JSONL sinks of finished spans and audit records ("": the
    # in-memory rings only); the rings always run, and the last
    # trace_ring_capacity spans / audit_capacity records answer /trace/<id>
    # and /audit
    trace_jsonl: str = field(default_factory=lambda: _env("TPUMOUNTER_TRACE_JSONL", ""))
    audit_jsonl: str = field(default_factory=lambda: _env("TPUMOUNTER_AUDIT_JSONL", ""))
    trace_ring_capacity: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_TRACE_RING", "2048")))
    audit_capacity: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_AUDIT_CAPACITY", "4096")))
    # the flight recorder's timeline (root and error spans, audit records,
    # Events) and its optional JSONL spill
    flight_capacity: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_FLIGHT_CAPACITY", "4096")))
    flight_jsonl: str = field(default_factory=lambda: _env("TPUMOUNTER_FLIGHT_JSONL", ""))
    # the fleet's trace plane (obs/assembly.py): the newest spans a worker
    # sends a CollectTelemetry snapshot (0: none), and the master's store
    # of the spans federated from the workers
    span_export_max: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_SPAN_EXPORT_MAX", "512")))
    remote_span_capacity: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_REMOTE_SPAN_CAPACITY", "8192")))
    # the fleet collector's period (obs/fleet.py), also the age past which
    # a /fleet, /slo or /tenants read collects first
    fleet_scrape_interval_s: float = field(default_factory=lambda: float(
        _env("FLEET_SCRAPE_INTERVAL_S", "15")))
    # the SLO objectives as a JSON list (obs/slo.py; "": the defaults), and
    # the two-window burn rate: a breach needs the burn over the threshold
    # in both windows
    slo_objectives: str = field(default_factory=lambda: _env("TPUMOUNTER_SLO_OBJECTIVES", ""))
    slo_fast_window_s: float = field(default_factory=lambda: float(
        _env("SLO_FAST_WINDOW_S", "300")))
    slo_slow_window_s: float = field(default_factory=lambda: float(
        _env("SLO_SLOW_WINDOW_S", "3600")))
    slo_burn_threshold: float = field(default_factory=lambda: float(
        _env("SLO_BURN_THRESHOLD", "2.0")))
    # the worker's tenant store (obs/tenants.py): snapshots from more
    # distinct tenants than this fold into one _overflow entry
    tenant_max: int = field(default_factory=lambda: int(_env("TPUMOUNTER_TENANT_MAX", "256")))

    # --- the worker's durability (worker/ledger.py, resync.py, server.py) ---
    # the fsync'd mount ledger's directory ("": no ledger, no replay; the
    # DaemonSet mounts a hostPath here) and the size past which it is
    # compacted into a snapshot, the open transactions and the epoch
    ledger_dir: str = field(default_factory=lambda: _env("TPUMOUNTER_LEDGER_DIR", ""))
    ledger_max_bytes: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_LEDGER_MAX_BYTES", str(4 * 1024 * 1024))))
    # SIGTERM: how long the drain waits for the batches in flight before it
    # closes the ledger (new mutations are refused UNAVAILABLE from then on)
    drain_timeout_s: float = field(default_factory=lambda: float(_env(
        "WORKER_DRAIN_TIMEOUT_S", "20")))
    # a slave pod's delete after an unmount is tried this many times; what
    # still stands is deferred into the ledger's queue (or, without a
    # ledger, counted as leaked)
    slave_release_attempts: int = field(default_factory=lambda: int(_env(
        "SLAVE_RELEASE_ATTEMPTS", "3")))

    # --- the master's store (store/) and the API-outage degraded mode ---
    # (k8s/health.py, store/cache.py, store/writebehind.py). ApiHealth: this
    # many outage-shaped failures in a row (5xx, transport, timeout) make a
    # plane degraded; a streak this long in seconds makes it down (writes
    # then go straight into the write-behind queue); this many successes in
    # a row bring it back (hysteresis)
    api_health_degraded_failures: int = field(default_factory=lambda: int(_env(
        "API_HEALTH_DEGRADED_FAILURES", "3")))
    api_health_down_after_s: float = field(default_factory=lambda: float(_env(
        "API_HEALTH_DOWN_AFTER_S", "10")))
    api_health_recovery_successes: int = field(default_factory=lambda: int(_env(
        "API_HEALTH_RECOVERY_SUCCESSES", "2")))
    # while the write plane is unhealthy or writes are queued, the store
    # probes it this often (a flush, else a lease touch); 0: no probe
    api_health_probe_interval_s: float = field(default_factory=lambda: float(_env(
        "API_HEALTH_PROBE_INTERVAL_S", "5")))
    # a failed read is answered from the store's cache while the cached copy
    # is younger than this; beyond it the failure propagates
    api_cache_max_staleness_s: float = field(default_factory=lambda: float(_env(
        "API_CACHE_MAX_STALENESS_S", "300")))
    # the fsync'd write-behind queue's directory ("": in memory only, lost
    # on restart) and the size past which it is compacted
    writebehind_dir: str = field(default_factory=lambda: _env("TPUMOUNTER_WRITEBEHIND_DIR", ""))
    writebehind_max_bytes: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_WRITEBEHIND_MAX_BYTES", str(4 * 1024 * 1024))))
    # the watch-backed store (store/watch.py) in place of the list-backed
    # one: off by default; one watch stream's timeout, the relist backoff
    # after a 410 from base to cap, and how long a read waits for the first
    # sync before it reads through the list-backed store
    store_watch_enabled: bool = field(default_factory=lambda: _env(
        "TPUMOUNTER_WATCH_STORE", "0") not in ("0", "false", ""))
    store_watch_timeout_s: float = field(default_factory=lambda: float(_env(
        "WATCH_STORE_TIMEOUT_S", "60")))
    store_watch_relist_base_s: float = field(default_factory=lambda: float(_env(
        "WATCH_STORE_RELIST_BASE_S", "0.5")))
    store_watch_relist_cap_s: float = field(default_factory=lambda: float(_env(
        "WATCH_STORE_RELIST_CAP_S", "30")))
    store_watch_sync_timeout_s: float = field(default_factory=lambda: float(_env(
        "WATCH_STORE_SYNC_TIMEOUT_S", "10")))
    # --- the recovery controller (recovery/controller.py) ---
    # on by default (TPUMOUNTER_RECOVERY=0 turns the master's loop off): it
    # probes every tracked node each RECOVERY_INTERVAL_S and evacuates one
    # confirmed dead, which takes this many failed passes in a row AND
    # RECOVERY_GRACE_S of failure AND the Node NotReady or its worker pod
    # gone (a worker that crashed on a Ready node is left to its replay);
    # the liveness probe (CollectTelemetry) has its own deadline
    recovery_enabled: bool = field(default_factory=lambda: _env(
        "TPUMOUNTER_RECOVERY", "1") not in ("0", "false", ""))
    recovery_interval_s: float = field(default_factory=lambda: float(_env(
        "RECOVERY_INTERVAL_S", "10")))
    recovery_confirm_failures: int = field(default_factory=lambda: int(_env(
        "RECOVERY_CONFIRM_FAILURES", "3")))
    recovery_grace_s: float = field(default_factory=lambda: float(_env(
        "RECOVERY_GRACE_S", "30")))
    recovery_probe_timeout_s: float = field(default_factory=lambda: float(_env(
        "RECOVERY_PROBE_TIMEOUT_S", "5")))

    # --- the gray-failure health plane (health/plane.py) ---
    # on by default (TPUMOUNTER_HEALTH=0 turns it off, and all it gates
    # fails open). A node's mount p95 is an outlier past both multiplier x
    # the fleet's median and median + floor_ms, each signal wanting this
    # many samples; the error ratio past which mounts count as failing
    health_enabled: bool = field(default_factory=lambda: _env(
        "TPUMOUNTER_HEALTH", "1") not in ("0", "false", ""))
    health_p95_multiplier: float = field(default_factory=lambda: float(_env(
        "HEALTH_P95_MULTIPLIER", "8")))
    health_p95_floor_ms: float = field(default_factory=lambda: float(_env(
        "HEALTH_P95_FLOOR_MS", "50")))
    health_min_samples: int = field(default_factory=lambda: int(_env(
        "HEALTH_MIN_SAMPLES", "5")))
    health_error_ratio: float = field(default_factory=lambda: float(_env(
        "HEALTH_ERROR_RATIO", "0.2")))
    # hysteresis, in scoring passes in a row: bad ones to suspect, bad ones
    # to quarantined, clean ones back to healthy
    health_suspect_strikes: int = field(default_factory=lambda: int(_env(
        "HEALTH_SUSPECT_STRIKES", "2")))
    health_quarantine_strikes: int = field(default_factory=lambda: int(_env(
        "HEALTH_QUARANTINE_STRIKES", "4")))
    health_clear_passes: int = field(default_factory=lambda: int(_env(
        "HEALTH_CLEAR_PASSES", "2")))
    # the fraction of the fleet the scorer may quarantine on its own (at
    # least 1 node; an operator's quarantine is exempt), and the fraction of
    # fresh entries below which a pass is skipped (fail-open)
    health_quarantine_budget: float = field(default_factory=lambda: float(_env(
        "HEALTH_QUARANTINE_BUDGET", "0.10")))
    health_min_fresh_fraction: float = field(default_factory=lambda: float(_env(
        "HEALTH_MIN_FRESH_FRACTION", "0.5")))
    # the canary prober: its period (0: no loop) and deadline, and the pod
    # it mounts into on node N, <prefix>N in the namespace
    health_canary_interval_s: float = field(default_factory=lambda: float(_env(
        "HEALTH_CANARY_INTERVAL_S", "30")))
    health_canary_timeout_s: float = field(default_factory=lambda: float(_env(
        "HEALTH_CANARY_TIMEOUT_S", "5")))
    health_canary_namespace: str = field(default_factory=lambda: _env(
        "HEALTH_CANARY_NAMESPACE", "kube-system"))
    health_canary_pod_prefix: str = field(default_factory=lambda: _env(
        "HEALTH_CANARY_POD_PREFIX", "tpumounter-canary-"))
    # canary passes in a row to leave quarantine (clean passive passes when
    # no prober runs), clean passes of probation before healthy, and the
    # passes quarantined and still an outlier before a drain is recommended
    health_rehab_canary_passes: int = field(default_factory=lambda: int(_env(
        "HEALTH_REHAB_CANARY_PASSES", "3")))
    health_probation_passes: int = field(default_factory=lambda: int(_env(
        "HEALTH_PROBATION_PASSES", "3")))
    health_drain_burn_passes: int = field(default_factory=lambda: int(_env(
        "HEALTH_DRAIN_BURN_PASSES", "3")))

    # --- the elastic reconciler (elastic/reconciler.py) ---
    # every intent enters the work queue again this often (a restarted
    # reconciler or a missed edge corrects itself); a failed pass backs off
    # from the base, doubling to the cap, with jitter; the queue hands out
    # at most one key a min interval, whatever the keys
    elastic_resync_interval_s: float = field(default_factory=lambda: float(
        _env("ELASTIC_RESYNC_INTERVAL_S", "10")))
    elastic_backoff_base_s: float = field(default_factory=lambda: float(
        _env("ELASTIC_BACKOFF_BASE_S", "0.5")))
    elastic_backoff_cap_s: float = field(default_factory=lambda: float(
        _env("ELASTIC_BACKOFF_CAP_S", "60")))
    elastic_min_reconcile_interval_s: float = field(default_factory=lambda: float(
        _env("ELASTIC_MIN_RECONCILE_INTERVAL_S", "0.05")))

    # --- the live migration (migrate/orchestrator.py) ---
    # how long the machine waits for the tenant's quiesce, checkpoint and
    # resume acks before it goes on without them (the drain is forced
    # either way: a tenant without the watcher loses the warm pack, not
    # the migration), and its poll of QuiesceStatus
    migrate_quiesce_timeout_s: float = field(default_factory=lambda: float(
        _env("MIGRATE_QUIESCE_TIMEOUT_S", "30")))
    migrate_resume_timeout_s: float = field(default_factory=lambda: float(
        _env("MIGRATE_RESUME_TIMEOUT_S", "30")))
    migrate_checkpoint_timeout_s: float = field(default_factory=lambda: float(
        _env("MIGRATE_CHECKPOINT_TIMEOUT_S", "30")))
    migrate_poll_interval_s: float = field(default_factory=lambda: float(
        _env("MIGRATE_POLL_INTERVAL_S", "0.2")))

    # --- the capacity plane (obs/capacity.py) ---
    # how many blocking hosts a feasibility verdict names; free / total under
    # the tight ratio (or a queue deeper than the free GPUs) reads "tight";
    # the trailing passes the headroom's trend is taken over
    capacity_blocking_hosts_max: int = field(default_factory=lambda: int(
        _env("CAPACITY_BLOCKING_HOSTS_MAX", "8")))
    capacity_tight_free_ratio: float = field(default_factory=lambda: float(
        _env("CAPACITY_TIGHT_FREE_RATIO", "0.1")))
    capacity_trend_samples: int = field(default_factory=lambda: int(
        _env("CAPACITY_TREND_SAMPLES", "64")))

    # --- the defragmenter (defrag/) ---
    # the background loop is off unless TPUMOUNTER_DEFRAG (a run migrates
    # live tenants; GET and POST /defrag work either way) and runs every
    # DEFRAG_INTERVAL_S; a plan moves at most DEFRAG_MAX_MOVES tenants and
    # each at most DEFRAG_TENANT_MOVE_BUDGET times; a snapshot or an adopted
    # plan older than DEFRAG_SNAPSHOT_MAX_AGE_S is refused; the block
    # recovered by default is 4 GPUs on one host (nvidia-h100-80gb-4);
    # DEFRAG_GROUP_FANOUT groups whose hosts are disjoint run at once
    defrag_enabled: bool = field(default_factory=lambda: _env(
        "TPUMOUNTER_DEFRAG", "false").lower() in ("1", "true", "yes"))
    defrag_interval_s: float = field(default_factory=lambda: float(
        _env("DEFRAG_INTERVAL_S", "300")))
    defrag_max_moves: int = field(default_factory=lambda: int(
        _env("DEFRAG_MAX_MOVES", "8")))
    defrag_tenant_move_budget: int = field(default_factory=lambda: int(
        _env("DEFRAG_TENANT_MOVE_BUDGET", "1")))
    defrag_snapshot_max_age_s: float = field(default_factory=lambda: float(
        _env("DEFRAG_SNAPSHOT_MAX_AGE_S", "60")))
    defrag_target_block: int = field(default_factory=lambda: int(
        _env("DEFRAG_TARGET_BLOCK", "4")))
    defrag_group_fanout: int = field(default_factory=lambda: int(
        _env("DEFRAG_GROUP_FANOUT", "2")))

    # --- the autoscaler (autoscale/) ---
    # the loop is off unless TPUMOUNTER_AUTOSCALE (a decision moves live
    # tenants' GPUs; GET /autoscale and the verbs work either way) and runs
    # every AUTOSCALE_INTERVAL_S; after a decision a tenant waits
    # AUTOSCALE_COOLDOWN_S; telemetry older than AUTOSCALE_STALE_S, or fewer
    # than AUTOSCALE_MIN_SAMPLES samples, is refused; a tenant keeps
    # AUTOSCALE_HISTORY samples and the model AUTOSCALE_MAX_TENANTS tenants; a
    # grow wants the queue at AUTOSCALE_QUEUE_GROW and the utilization at
    # AUTOSCALE_UTIL_GROW, a shrink both at or under their _SHRINK; a signal
    # holds AUTOSCALE_HYSTERESIS passes in a row before it fires, and a
    # decision moves at most AUTOSCALE_MAX_STEP GPUs
    autoscale_enabled: bool = field(default_factory=lambda: _env(
        "TPUMOUNTER_AUTOSCALE", "false").lower() in ("1", "true", "yes"))
    autoscale_interval_s: float = field(default_factory=lambda: float(
        _env("AUTOSCALE_INTERVAL_S", "60")))
    autoscale_cooldown_s: float = field(default_factory=lambda: float(
        _env("AUTOSCALE_COOLDOWN_S", "300")))
    autoscale_stale_s: float = field(default_factory=lambda: float(
        _env("AUTOSCALE_STALE_S", "120")))
    autoscale_min_samples: int = field(default_factory=lambda: int(
        _env("AUTOSCALE_MIN_SAMPLES", "4")))
    autoscale_history: int = field(default_factory=lambda: int(
        _env("AUTOSCALE_HISTORY", "64")))
    autoscale_max_tenants: int = field(default_factory=lambda: int(
        _env("AUTOSCALE_MAX_TENANTS", "256")))
    autoscale_queue_grow: float = field(default_factory=lambda: float(
        _env("AUTOSCALE_QUEUE_GROW", "32")))
    autoscale_queue_shrink: float = field(default_factory=lambda: float(
        _env("AUTOSCALE_QUEUE_SHRINK", "2")))
    autoscale_util_grow: float = field(default_factory=lambda: float(
        _env("AUTOSCALE_UTIL_GROW", "0.85")))
    autoscale_util_shrink: float = field(default_factory=lambda: float(
        _env("AUTOSCALE_UTIL_SHRINK", "0.35")))
    autoscale_hysteresis: int = field(default_factory=lambda: int(
        _env("AUTOSCALE_HYSTERESIS", "2")))
    autoscale_max_step: int = field(default_factory=lambda: int(
        _env("AUTOSCALE_MAX_STEP", "2")))

    # --- fractional shares (vchip/) ---
    # off: /shares' admission answers 503 and every grant stays whole-GPU;
    # the weight one GPU can carry (100 reads as percent); the books' bound;
    # a share's default token budget (0: unmetered)
    vchip_enabled: bool = field(default_factory=lambda: _env(
        "TPUMOUNTER_VCHIP", "true").lower() in ("1", "true", "yes"))
    vchip_weight_capacity: int = field(default_factory=lambda: int(
        _env("VCHIP_WEIGHT_CAPACITY", "100")))
    vchip_max_shares: int = field(default_factory=lambda: int(
        _env("VCHIP_MAX_SHARES", "1024")))
    vchip_rate_budget: int = field(default_factory=lambda: int(
        _env("VCHIP_RATE_BUDGET", "0")))

    # the fake API server's watch backlog (k8s/fake.py): events kept for
    # resumable watches, at least 64; a watcher that falls past it has its
    # stream ended (the fake's 410)
    watch_backlog_events: int = field(default_factory=lambda: int(_env(
        "TPUMOUNTER_WATCH_BACKLOG", "8192")))
