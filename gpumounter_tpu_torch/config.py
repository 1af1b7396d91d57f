"""Configuration of the control plane's mount path and its transport.

The counterpart of ``gpumounter_tpu/config/config.py``, holding only the
fields the device layer, the collector, the allocator, the cgroup layer, the
mounter, the transport, the master (with its slice and batch routes and their
fan-out core), the observability stores, the worker's ledger and drain, the master's
store with its API-outage degraded mode, and the two daemons read. Every field is an environment
variable with the original GPUMounter's value as default; the names are the reference's where the
meaning is the same. NVIDIA-specific: the resource ``nvidia.com/gpu``
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
    # request mounts on at once (one worker client a node)
    bulk_max_targets: int = field(default_factory=lambda: int(_env("BULK_MAX_TARGETS", "256")))
    bulk_node_fanout: int = field(default_factory=lambda: int(_env("BULK_NODE_FANOUT", "16")))

    # --- the shared fan-out core (utils/fanout.py) ---
    # its width (0: 4 x the CPU count, at least 32); the reference's
    # TPUMOUNTER_FANOUT_SHARD_BUDGET comes with the owner shards (7h)
    fanout_width: int = field(default_factory=lambda: int(_env("TPUMOUNTER_FANOUT_WIDTH", "0")))

    # --- master -> worker calls ---
    # deadlines a method; bounded capped-exponential retries on UNAVAILABLE
    # and DEADLINE_EXCEEDED; the breaker opens after this many transport
    # failures in a row and lets one probe through after the reset
    rpc_add_timeout_s: float = field(default_factory=lambda: float(
        _env("RPC_ADD_TIMEOUT_S", "300")))
    rpc_remove_timeout_s: float = field(default_factory=lambda: float(
        _env("RPC_REMOVE_TIMEOUT_S", "120")))
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
