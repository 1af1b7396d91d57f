"""The master: the HTTP API, routed to the right node's worker.

The counterpart of ``gpumounter_tpu/master/app.py`` for the original
GPUMounter's surface (``cmd/GPUMounter-master/main.go``) and the reference's
multi-host routes:

  * routes (main.go:232-234):
      GET  /addgpu/namespace/:ns/pod/:pod/gpu/:n/isEntireMount/:bool
      POST /removegpu/namespace/:ns/pod/:pod/force/:bool   (form: uuids,
           repeated or comma-joined)
      GET  /
    plus /healthz (200 "ok", with "api: <verdict>" while the Kubernetes API
    is unhealthy: restarting the master in an outage would dump its cache
    and queue) and /workers (node -> worker address);
  * the API-outage pane, as the reference's: GET /apihealth ->
    {"api": ApiHealth's payload, "store": the store's cache ages, its
    write-behind queue (and the watch store's sync)}; untraced, in the read
    scope;
  * the reference's slice and batch routes, JSON in and out
    (``master/slice_ops.py``):
      POST /addslice      {"pods": [{"namespace", "pod"}, ...],
                           "gpusPerHost": 8, "isEntireMount": true,
                           "acceleratorType": "nvidia-h100-80gb"}
                          -> the plan of each worker's torch.distributed env
      POST /removeslice   {"pods": [...], "force": false}
                          -> {"removed": {pod: result}}
      POST /batch/addgpu  {"targets": [{"namespace", "pod", "gpus",
                           "isEntireMount"}, ...]}
                          -> {"results": [...], "summary": {"total",
                             "success", "byResult"}}
  * the reference's observability reads (``obs/``), in the read scope:
      GET  /audit?namespace=&pod=&op=&trace=&outcome=&limit=
                          -> {"records": [...]}, newest first
      GET  /trace/<id>    -> the assembled trace (``obs.assembly.assemble``):
                             this process's ring joined with the spans the
                             fleet collector federated from the workers, as
                             a waterfall with the wall time by phase and
                             whether it is complete; an incomplete one is
                             assembled again after one fleet pass (at most
                             one a second); 404 when neither holds any
      GET  /timeline?node=&trace=&kind=&from=&to=&limit=
                          -> {"records": [...]}, the flight recorder's;
  * the fleet planes (``obs/fleet.py``, ``obs/slo.py``), in the read scope
    and untraced:
      GET  /metrics       -> the exposition (OpenMetrics, with the
                             histograms' trace-id exemplars, when the
                             Accept header asks for it)
      GET  /fleet         -> the ``FleetCollector``'s rollup, collected
                             first when older than FLEET_SCRAPE_INTERVAL_S
      GET  /slo           -> the ``SloEngine``'s burn rates over it
      GET  /tenants       -> each tenant's steps and disruption windows;
  * the recovery and health planes (``recovery/controller.py``,
    ``health/plane.py``), the reads in the read scope and untraced:
      GET  /recovery      -> each node's liveness verdict, the evacuations
      POST /recovery/evacuate/<node>
                          -> the evacuation's record (manual: no
                             confirmation window, no suspension)
      GET  /health/nodes  -> each node's health state, signals and canary
                             streaks, the quarantine budget, the last pass
      POST /health/quarantine/<node>   {"action": "quarantine" | "release",
                                        "reason": ...}
                          -> {"node", "action", "health": the node's pane};
                             409 for a release the plane refuses (the node
                             is not quarantined, or was evacuated);
    both POSTs are shard-gated like /addgpu and leave an edge audit record;
  * the read scope: with TPUMOUNTER_AUTH_READ_TOKEN set, the reads above
    and /shards take it or the mutate token (which implies read), and
    nothing else; without it /metrics stays open and the other reads want
    the mutate token. The read token never authorizes a mutation;
  * one root span ``http.<route>`` a request (after the auth check, so an
    unauthenticated peer adds no span), its parent the caller's
    ``x-tpumounter-trace`` header when that is valid, its trace id on the
    response as ``X-Tpumounter-Trace``, a failure (an unhandled one too)
    closing it as an error; /, /healthz, /timeline, /apihealth, /shards and
    the fleet planes' reads are not traced, as in the reference. The pod's
    read is a ``k8s.get_pod`` span. The routes that mutate (add, remove,
    batch_add, addslice, removeslice, recovery_evacuate, health_quarantine)
    leave an edge audit record, its outcome "http <status>";
  * the target pod is read to find its node (main.go:52-66): 404 when there
    is no pod, 400 when it is not scheduled;
  * the node's worker comes from ``WorkerRegistry`` (500 when there is
    none), and the call goes over ``WorkerClient`` (main.go:82, 185), or
    over whatever ``worker_client_factory`` the caller passes;
  * every API call of the master feeds the process's ApiHealth
    (``k8s/health.py``: its client is wrapped by ``wrap_health``), and its
    durable state goes through one ``MasterStore`` (``store/``), by default
    ``CachedMasterStore`` over the list-backed store (the watch-backed one
    under TPUMOUNTER_WATCH_STORE): the registry LISTs and watches through
    it, reads fall back to its bounded-staleness cache in an outage, and
    annotation writes defer into its write-behind queue. A pod read that
    fails in an outage answers 500, as the reference's;
  * results map to HTTP as the original's do (main.go:103-116, 206-224):
    add Success 200 "Add GPU Success", InsufficientGPU 500, PodNotFound 400;
    remove PodNotFound, GPUBusy and GPUNotFound 400, Success 200. A breaker
    that is open answers 503 with Retry-After; any other failed call 500.
    A slice answers the status of its ``SliceError``, with Retry-After when
    a breaker was open.

Sharded masters (``master/shard.py``): with the shards active, /addgpu and
/removegpu for a node another replica owns answer 307 to the owner's URL
(503 with Retry-After when the shard has no live owner), the fleet
collector collects the nodes this replica owns, the batch proxies
each peer's sub-batch to it once with FORWARDED_HEADER and the trace
context (a forwarded request never hops again: NotOwner), and every worker
call carries the owner shard's fencing epoch. GET /shards serves the shard
table (untraced). The admission gate (MASTER_HTTP_CONCURRENCY) bounds the
requests a replica handles at once; a forwarded request waits on a gate of
its own, and the wait is an ``http.admission`` span inside the edge span.

As in the reference: gpuNum and a batch target's gpus are range-checked
against MAX_GPU_PER_REQUEST (the original never checks it), a batch holds at
most BULK_MAX_TARGETS targets, every route but the index and /healthz wants
a bearer token (``utils/auth.py``), and a path of no route gets "404 page
not found", /addtpu and /batch/addtpu among them: the port serves the
reference's 41 routes under its names, with the GPU's names for the mounts.

The capacity plane and the fractional shares (``obs/capacity.py``,
``vchip/``), as the reference's routes (``gpumounter_tpu/master/app.py:926-949,
1150-1226``), JSON out:

      GET    /capacity?accel_type=    -> the capacity pane: each node's GPUs
                                         (free, held, warm, fenced), the
                                         fleet's, the feasibility table over
                                         ``topology.FEASIBILITY_SHAPES`` (one
                                         row with accel_type, 404 for an
                                         unknown one), the headroom, the
                                         intents' demand, the shares' view
      GET    /shares                  -> the share books
      POST   /shares                  {"namespace", "pod", "profile", "chips",
                                       "weight", "rate_budget", "inventory"}
                                      -> {"admitted": [...]}; 409 when the
                                         packer refuses, 503 with vchip off
      DELETE /shares/<ns>/<pod>       -> {"released": [...]}; 404

The reads are in the read scope and untraced; the writes want the mutate
token and leave an edge audit record. The plane is built here over the fleet
collector and the reconciler, observes each of the collector's passes and is
registered for the process (``capacity_obs.register_plane``), so that the
reconciler's refusals stamp its verdict; /addgpu's InsufficientGPU stamps it
too (``capacity.reject``) before its 500.

The elastic intents and the live migration (``elastic/``, ``migrate/``), as
the reference's routes (``gpumounter_tpu/master/app.py:328-343,
1559-1680``), JSON in and out:

      GET    /intents                 -> {"intents": [{"namespace", "pod",
                                          "desiredChips", "minChips",
                                          "priority", "status"?}, ...]}
      GET    /intents/<ns>/<pod>      -> the intent and the reconciler's last
                                         outcome; 404 without one
      PUT    /intents/<ns>/<pod>      {"desiredChips", "minChips", "priority"}
                                      -> the intent (400 for a bad one, 404
                                         for no pod); the pod is queued
      DELETE /intents/<ns>/<pod>      -> {"deleted": bool}
      POST   /migrate                 {"source": {"namespace", "pod"},
                                       "destination": {...}, "checkpoint"}
                                      -> the journal as begun (400, 404, 409
                                         before anything moved)
      GET    /migrations              -> {"migrations": [journal, ...]}
      GET    /migrations/<mid>        -> the journal; 404
      POST   /migrations/<mid>/abort  -> {"id", "aborting": true}; 404, 409

They want the mutate token (they name pods and GPUs), the writes leave an
edge audit record, and none is shard-gated, as in the reference: the
reconciler parks a pod on a node it does not own, and a migration's journal
is adopted by the source node's owner. The reconciler and the machine are
built here over the mount path's clients, the store, the shards and
ApiHealth, and handed to the recovery controller, whose evacuation re-drives
their intents and journals; the reconciler's loop runs only after
``elastic.start()``.

The recovery controller and the health plane are built here, as the
reference's (``gpumounter_tpu/master/app.py:577-602``): the controller over
the mount path's client factory, the store, the shards and ApiHealth; the
plane with it and the store, its persisted quarantine set loaded at once;
the plane the fleet collector's ``health`` observer and the controller's
``health``; the canary prober over the mount path's client. Their loops run
only after ``recovery.start()`` and ``canary.start()`` (``master/main.py``).

The defragmenter (``defrag/``), as the reference's routes
(``gpumounter_tpu/master/app.py:380-387, 1030-1096``), JSON out:

      GET  /defrag            -> the gates, the adopted plan, the run in
                                 flight with its barrier samples, the last
                                 runs
      POST /defrag/plan       {"target_block": n} (optional; 400 unless a
                               positive integer) -> the plan, adopted
      POST /defrag/run        {"plan_id": "dfp-..."} (optional) -> the pane;
                               the moves run on a thread of their own
      POST /defrag/pause      -> the pane

GET is in the read scope and untraced; the POSTs want the mutate token and
leave an edge audit record. A refusal answers its own status: 409 (a stale
snapshot or plan, no plan, busy), 503 with Retry-After (the API degraded,
an objective burning). The controller is built after the recovery
controller, over the migration machine, the capacity plane and the fleet
collector, with the health plane, so that quarantined hosts are no move's
destination; its loop runs only after ``defrag.start()`` (``master/main.py``,
under TPUMOUNTER_DEFRAG).

The autoscaler (``autoscale/``), as the reference's routes
(``gpumounter_tpu/master/app.py:395-401, 1098-1150``), JSON out:

      GET  /autoscale          -> the gates, the model's fits, the last pass,
                                  the recent decisions, the cooldowns
      POST /autoscale/pause    -> the pane
      POST /autoscale/resume   -> the pane
      POST /autoscale/evaluate -> one pass now: its record

GET is in the read scope and untraced; the POSTs want the mutate token and
leave an edge audit record (pause and resume theirs too, with the caller's
X-Tpumounter-Actor). A refusal answers its own status: 409 (paused, busy),
503 with Retry-After of AUTOSCALE_INTERVAL_S (the API degraded, an objective
burning, the fleet's view failed). The controller is built after the
defragmenter, over the reconciler, the capacity plane and the fleet
collector, with the SLO engine, ApiHealth, the health plane and the
defragmenter; its model is the collector's ``autoscale_model``, so that
every pass feeds it. Its loop runs only after ``autoscale.start()``
(``master/main.py``, under TPUMOUNTER_AUTOSCALE).
"""

from __future__ import annotations

import contextlib
import inspect
import json
import random
import re
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gpumounter_tpu_torch.autoscale import AutoscaleController, AutoscaleRefused
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.defrag import DefragController, DefragRefused
from gpumounter_tpu_torch.elastic import ElasticReconciler, Intent, IntentError, IntentStore
from gpumounter_tpu_torch.health import CanaryProber, HealthPlane
from gpumounter_tpu_torch.k8s.client import KubeClient, NotFoundError
from gpumounter_tpu_torch.k8s.health import api_health, wrap_health
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.master.shard import ShardManager, epoch_kwargs
from gpumounter_tpu_torch.master.slice_ops import (
    BulkMountCoordinator,
    BulkTarget,
    SliceCoordinator,
    SliceError,
    SliceTarget,
)
from gpumounter_tpu_torch.migrate import MigrationCoordinator, MigrationError
from gpumounter_tpu_torch.obs import assembly, audit, flight, trace
from gpumounter_tpu_torch.obs import capacity as capacity_obs
from gpumounter_tpu_torch.obs.audit import audited
from gpumounter_tpu_torch.obs.fleet import FleetCollector
from gpumounter_tpu_torch.obs.slo import SloEngine
from gpumounter_tpu_torch.recovery import RecoveryController
from gpumounter_tpu_torch.rpc.api import AddGPUResult, RemoveGPUResult
from gpumounter_tpu_torch.rpc.client import ChannelPool, WorkerClient
from gpumounter_tpu_torch.rpc.resilience import BreakerOpenError, CircuitBreaker, FencedError
from gpumounter_tpu_torch.store import (
    CachedMasterStore,
    KubeMasterStore,
    MasterStore,
    WatchMasterStore,
)
from gpumounter_tpu_torch.topology import GPUS_PER_HOST
from gpumounter_tpu_torch.utils.auth import check_bearer, required_token, resolve_read_token
from gpumounter_tpu_torch.utils.fanout import get_core
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.vchip import PackRefused, ShareLimitError, SharePacker, ShareRegistry

logger = get_logger("master")

#: stamped on a sub-batch one replica proxies to another: a forwarded
#: request is answered where it lands (a node it does not own gets a
#: per-target NotOwner, never a second hop), so an ownership flap cannot
#: turn into a proxy loop
FORWARDED_HEADER = "x-tpumounter-forwarded"


class WorkerRegistry:
    """node name -> worker pod IP, kept current by a watch (an informer).

    The original LISTs the worker pods on every request (main.go:68, 171).
    Here one LIST primes the cache, then a watch of the worker pods
    (WORKER_NAMESPACE, WORKER_LABEL_SELECTOR) applies ADDED, MODIFIED and
    DELETED in place, both through the ``MasterStore`` seam (the list-backed
    store when none is given); a read is a cache hit, and a miss makes at most one
    LIST a MISS_RELIST_INTERVAL_S, for a worker the watch has not shown
    yet. Watch events that land while a LIST is in flight are replayed on
    top of its result, so a delta between the LIST's answer and the swap is
    not lost. A watch that fails or ends at once is opened again after a
    jittered, growing delay.

    The registry also owns the breaker and the channel pool that every
    ``WorkerClient`` of the master shares: a worker that is gone takes its
    breaker state and its channel with it, and a breaker that opens drops
    the worker's channel."""

    MISS_RELIST_INTERVAL_S = 1.0
    WATCH_TIMEOUT_S = 60.0
    MIN_HEALTHY_WATCH_S = 5.0
    WATCH_BACKOFF_BASE_S = 0.5
    WATCH_BACKOFF_CAP_S = 15.0

    def __init__(self, kube: KubeClient, cfg=None, store: MasterStore | None = None):
        self.kube = kube
        self.cfg = cfg or Config()
        self.store = store or KubeMasterStore(kube, self.cfg)
        self.breaker = CircuitBreaker(failure_threshold=self.cfg.breaker_failure_threshold,
                                      reset_s=self.cfg.breaker_reset_s)
        self.channel_pool = ChannelPool(cfg=self.cfg)
        self.breaker.on_open = lambda key: self.channel_pool.invalidate(key, "breaker-open")
        # node name -> (worker pod IP, worker pod name); the name makes a
        # DELETED exact when its event carries no podIP
        self._cache: dict[str, tuple[str, str]] = {}
        self._lock = threading.Lock()
        # serializes LISTs; taken before _lock
        self._refresh_mu = threading.Lock()
        self._primed = threading.Event()
        self._last_list = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._watch = None
        self._journal: list[tuple[str, Pod]] | None = None

    # --- lifecycle ---

    def _ensure_started(self) -> None:
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._watch_loop,
                                                name="worker-registry-watch", daemon=True)
                self._thread.start()
        # the first caller waits for the priming LIST, at most 10 s
        self._primed.wait(10.0)

    def stop(self) -> None:
        """Stop the watch (a REST stream closes now; a fake's ends at its
        next event or its timeout) and close every pooled channel."""
        self._stop.set()
        watch = self._watch
        close = getattr(watch, "close", None)
        if close is not None and not inspect.isgenerator(watch):
            close()
        self.channel_pool.close_all()

    # --- the cache ---

    @staticmethod
    def _apply_to(cache: dict[str, tuple[str, str]], etype: str, pod: Pod) -> None:
        if not pod.node_name:
            return
        entry = cache.get(pod.node_name)
        if etype == "DELETED":
            # only if the entry is still this pod's: in a rolling update
            # the new pod's ADDED may land before the old one's DELETED
            if entry is not None and entry[1] == pod.name:
                cache.pop(pod.node_name, None)
            return
        if pod.pod_ip:
            cache[pod.node_name] = (pod.pod_ip, pod.name)

    def _apply(self, etype: str, pod: Pod) -> None:
        with self._lock:
            old = self._cache.get(pod.node_name) if pod.node_name else None
            self._apply_to(self._cache, etype, pod)
            new = self._cache.get(pod.node_name) if pod.node_name else None
            if self._journal is not None:  # a LIST is in flight
                self._journal.append((etype, pod))
        if old is not None and (new is None or new[0] != old[0]):
            # the node's worker moved or went: its channel serves no more
            self.channel_pool.invalidate(f"{old[0]}:{self.cfg.worker_port}", "address-change")
        if etype == "DELETED":
            self._prune()

    def _refresh(self) -> None:
        with self._refresh_mu:
            self._refresh_locked()

    def _refresh_locked(self) -> None:
        """LIST, then the swap with the journal's deltas on top. The caller
        holds _refresh_mu: a second LIST in flight would clobber the
        journal."""
        with self._lock:
            self._journal = []
        try:
            pods = self.store.list_worker_pods()
            cache: dict[str, tuple[str, str]] = {}
            for pod_json in pods:
                p = Pod(pod_json)
                if p.node_name and p.pod_ip:
                    cache[p.node_name] = (p.pod_ip, p.name)
            with self._lock:
                for etype, pod in self._journal:
                    self._apply_to(cache, etype, pod)
                self._cache = cache
                self._last_list = time.monotonic()
        finally:
            with self._lock:
                self._journal = None
        self._prune()
        self._primed.set()

    def _watch_backoff(self, failures: int) -> float:
        cap = min(self.WATCH_BACKOFF_CAP_S,
                  self.WATCH_BACKOFF_BASE_S * 2 ** max(0, failures - 1))
        return random.uniform(cap / 2, cap)

    def _watch_loop(self) -> None:
        short_streams = 0
        while not self._stop.is_set():
            opened = time.monotonic()
            try:
                # (re)prime, then stream the deltas; a LIST at every open
                # covers the window the last stream missed
                self._refresh()
                self._watch = self.store.watch_worker_pods(timeout_s=self.WATCH_TIMEOUT_S)
                for etype, pod_json in self._watch:
                    if self._stop.is_set():
                        return
                    self._apply(etype, Pod(pod_json))
            except Exception as exc:  # noqa: BLE001 — the informer stays up
                if self._stop.is_set():
                    return
                # a stream that lived long did its work: count afresh
                healthy = time.monotonic() - opened >= self.MIN_HEALTHY_WATCH_S
                short_streams = 1 if healthy else short_streams + 1
                delay = self._watch_backoff(short_streams)
                logger.warning("worker watch failed (%s); retrying in %.1fs", exc, delay)
                self._stop.wait(delay)
                continue
            if time.monotonic() - opened >= self.MIN_HEALTHY_WATCH_S:
                short_streams = 0
                continue
            # ended at once without an error (a trimmed backlog, a 410):
            # back off before the LIST and the open
            short_streams += 1
            self._stop.wait(self._watch_backoff(short_streams))

    def _prune(self) -> None:
        with self._lock:
            active = {f"{ip}:{self.cfg.worker_port}" for ip, _ in self._cache.values()}
        self.breaker.prune(active)
        self.channel_pool.retain(active)

    # --- reads ---

    def registry_snapshot(self) -> dict[str, str]:
        self._ensure_started()
        with self._lock:
            return {node: ip for node, (ip, _) in self._cache.items()}

    def _miss_refresh(self) -> None:
        """One LIST for a miss, at most one a MISS_RELIST_INTERVAL_S: misses
        at once wait here and re-check the stamp."""
        with self._refresh_mu:
            with self._lock:
                if time.monotonic() - self._last_list <= self.MISS_RELIST_INTERVAL_S:
                    return
            self._refresh_locked()

    def worker_address(self, node_name: str) -> str | None:
        self._ensure_started()
        with self._lock:
            entry = self._cache.get(node_name)
        if entry is None:
            self._miss_refresh()
            with self._lock:
                entry = self._cache.get(node_name)
        if entry is None:
            return None
        return f"{entry[0]}:{self.cfg.worker_port}"


class _HttpError(Exception):
    def __init__(self, status: int, message: str, headers: dict[str, str] | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


# the reference's route regexes (app.py:303-312), with the gpu names only
_ROUTES: list[tuple[str, re.Pattern, str]] = [
    ("GET", re.compile(r"^/addgpu/namespace/(?P<ns>[^/]+)/pod/(?P<pod>[^/]+)"
                       r"/gpu/(?P<num>[^/]+)/isEntireMount/(?P<entire>[^/]+)$"), "add"),
    ("POST", re.compile(r"^/removegpu/namespace/(?P<ns>[^/]+)/pod/(?P<pod>[^/]+)"
                        r"/force/(?P<force>[^/]+)$"), "remove"),
    ("GET", re.compile(r"^/$"), "index"),
    ("GET", re.compile(r"^/healthz$"), "healthz"),
    ("GET", re.compile(r"^/apihealth$"), "apihealth"),
    ("GET", re.compile(r"^/workers$"), "workers"),
    ("GET", re.compile(r"^/shards$"), "shards"),
    ("POST", re.compile(r"^/batch/addgpu$"), "batch_add"),
    ("POST", re.compile(r"^/addslice$"), "addslice"),
    ("POST", re.compile(r"^/removeslice$"), "removeslice"),
    # the observability reads; /audit and /timeline take their own query
    # string, since the dispatcher matches the raw path
    ("GET", re.compile(r"^/audit(?:\?(?P<query>.*))?$"), "audit"),
    ("GET", re.compile(r"^/trace/(?P<tid>[^/?]+)$"), "trace"),
    ("GET", re.compile(r"^/timeline(?:\?(?P<query>.*))?$"), "timeline"),
    # the fleet planes (obs/fleet.py, obs/slo.py)
    ("GET", re.compile(r"^/metrics$"), "metrics"),
    ("GET", re.compile(r"^/fleet$"), "fleet"),
    ("GET", re.compile(r"^/slo$"), "slo"),
    ("GET", re.compile(r"^/tenants$"), "tenants"),
    # the recovery and health planes (recovery/controller.py, health/plane.py)
    ("GET", re.compile(r"^/recovery$"), "recovery"),
    ("POST", re.compile(r"^/recovery/evacuate/(?P<node>[^/]+)$"), "recovery_evacuate"),
    ("GET", re.compile(r"^/health/nodes$"), "health_nodes"),
    ("POST", re.compile(r"^/health/quarantine/(?P<node>[^/]+)$"), "health_quarantine"),
    # the elastic intents (elastic/): CRUD over the pods' annotations
    ("GET", re.compile(r"^/intents$"), "intents_list"),
    ("GET", re.compile(r"^/intents/(?P<ns>[^/]+)/(?P<pod>[^/]+)$"), "intent_get"),
    ("PUT", re.compile(r"^/intents/(?P<ns>[^/]+)/(?P<pod>[^/]+)$"), "intent_put"),
    ("DELETE", re.compile(r"^/intents/(?P<ns>[^/]+)/(?P<pod>[^/]+)$"), "intent_delete"),
    # the live migration (migrate/)
    ("POST", re.compile(r"^/migrate$"), "migrate_start"),
    ("GET", re.compile(r"^/migrations$"), "migrations_list"),
    ("GET", re.compile(r"^/migrations/(?P<mid>[^/]+)$"), "migration_get"),
    ("POST", re.compile(r"^/migrations/(?P<mid>[^/]+)/abort$"), "migration_abort"),
    # the capacity plane (obs/capacity.py) and the fractional shares (vchip/)
    ("GET", re.compile(r"^/capacity(?:\?(?P<query>.*))?$"), "capacity"),
    ("GET", re.compile(r"^/shares$"), "shares"),
    ("POST", re.compile(r"^/shares$"), "shares_admit"),
    ("DELETE", re.compile(r"^/shares/(?P<ns>[^/]+)/(?P<pod>[^/]+)$"), "shares_release"),
    # the defragmenter (defrag/): one pane and three verbs
    ("GET", re.compile(r"^/defrag$"), "defrag"),
    ("POST", re.compile(r"^/defrag/plan$"), "defrag_plan"),
    ("POST", re.compile(r"^/defrag/run$"), "defrag_run"),
    ("POST", re.compile(r"^/defrag/pause$"), "defrag_pause"),
    # the autoscaler (autoscale/): one pane and three verbs
    ("GET", re.compile(r"^/autoscale$"), "autoscale"),
    ("POST", re.compile(r"^/autoscale/pause$"), "autoscale_pause"),
    ("POST", re.compile(r"^/autoscale/resume$"), "autoscale_resume"),
    ("POST", re.compile(r"^/autoscale/evaluate$"), "autoscale_evaluate"),
]

#: a slice's GPUs per host when the request names none: an H100 host's 8
#: (the reference's 4 is a v5e host's)
DEFAULT_GPUS_PER_HOST = GPUS_PER_HOST["nvidia-h100-80gb"]


def _parse_bool(raw: str, param: str) -> bool:
    low = raw.lower()
    if low in ("true", "1", "t"):
        return True
    if low in ("false", "0", "f"):
        return False
    raise _HttpError(400, f"Invalid param {param}: {raw} (should be true or false)")


def _actor(headers: dict[str, str]) -> str:
    """The caller the audit trail names: the X-Tpumounter-Actor header, else
    "http"."""
    return next((v for k, v in headers.items() if k.lower() == "x-tpumounter-actor"),
                "") or "http"


def _retry_after(seconds: float) -> dict[str, str]:
    return {"Retry-After": str(max(1, int(seconds + 0.5)))}


def _slice_headers(exc: SliceError) -> dict[str, str] | None:
    return None if exc.retry_after_s is None else _retry_after(exc.retry_after_s)


def _json_body(body: bytes, what: str) -> dict:
    try:
        payload = json.loads(body or b"{}")
    except ValueError:
        raise _HttpError(400, "body must be JSON")
    if not isinstance(payload, dict):
        raise _HttpError(400, f'body must be a JSON object with a "{what}" list')
    return payload


def _degraded_or_500(exc: Exception) -> _HttpError:
    """A failed worker call as HTTP: a breaker that opened (or was found
    open) during the call is 503 with Retry-After; a fenced call (this
    master's view of the node's owner is stale) 503 with Retry-After 1, so
    that a client retries against fresh routing; anything else 500."""
    if isinstance(exc, BreakerOpenError):
        return _HttpError(503, f"worker degraded (circuit breaker open): {exc}",
                          headers=_retry_after(exc.retry_after_s))
    if isinstance(exc, FencedError):
        return _HttpError(503, f"stale shard ownership (fenced by worker): {exc}",
                          headers={"Retry-After": "1"})
    return _HttpError(500, f"Service Internal Error: {exc}")


class MasterApp:
    """The request handling, apart from the transport; ``build_http_server``
    serves it."""

    #: open without a token: the liveness surfaces (probes carry none)
    UNAUTHENTICATED_ROUTES = frozenset({"index", "healthz"})
    #: the read scope: the read token or the mutate token; without a read
    #: token /metrics is open and the others want the mutate token (they
    #: name pods, tenants and GPUs)
    READ_ROUTES = frozenset({"metrics", "audit", "trace", "timeline", "apihealth", "shards",
                             "fleet", "slo", "tenants", "recovery", "health_nodes", "capacity",
                             "shares", "defrag", "autoscale"})
    #: never traced: probes, and the panes a dashboard polls (their spans
    #: would rotate the operations' traces out of the ring)
    UNTRACED_ROUTES = frozenset({"index", "healthz", "metrics", "fleet", "slo", "tenants",
                                 "apihealth", "timeline", "shards", "recovery",
                                 "health_nodes", "capacity", "shares", "defrag",
                                 "autoscale"})
    #: never behind the admission gate: a liveness probe or a scrape must
    #: answer while a mount storm fills the replica (a gated /healthz would
    #: turn load into restarts)
    UNGATED_ROUTES = frozenset({"index", "healthz", "metrics"})
    #: the routes that mutate: their edge outcome goes into the audit trail
    #: (the worker's records carry the GPUs of the same trace)
    AUDITED_ROUTES = frozenset({"add", "remove", "batch_add", "addslice", "removeslice",
                                "intent_put", "intent_delete", "migrate_start",
                                "migration_abort", "recovery_evacuate", "health_quarantine",
                                "shares_admit", "shares_release", "defrag_plan", "defrag_run",
                                "defrag_pause", "autoscale_pause", "autoscale_resume",
                                "autoscale_evaluate"})

    def __init__(self, kube: KubeClient, cfg=None, worker_client_factory=None,
                 registry: WorkerRegistry | None = None, store: MasterStore | None = None,
                 shards: ShardManager | None = None, telemetry_client_factory=None):
        """worker_client_factory(address) -> a client with add_gpu,
        remove_gpu and the context-manager protocol; by default a
        ``WorkerClient`` with the deploy's token, the registry's breaker and
        its pooled channel. telemetry_client_factory(address) -> the fleet
        collector's and the recovery probe's client, with
        collect_telemetry; by default a
        ``WorkerClient`` with the deploy's token, a channel of its own and no
        breaker, so that a pass over a worker that is down neither counts
        against the mount path's breaker nor leaves the pooled channel in
        gRPC's reconnect backoff (the reference shares both); when only
        worker_client_factory is given, that one. `store`: by default ``CachedMasterStore`` over
        the list-backed store (the watch-backed one under
        TPUMOUNTER_WATCH_STORE), on the health-tracked client. `shards`: a
        ``ShardManager``, by default an inactive one (this master owns every
        node and stamps epoch 0; ``master/main.py`` starts it when
        TPUMOUNTER_SHARD_COUNT > 1). Without a token this raises
        AuthConfigError, unless TPUMOUNTER_AUTH=insecure (fail-closed)."""
        self.cfg = cfg or Config()
        self._token = required_token(self.cfg, "master HTTP API")
        self._read_token = resolve_read_token(self.cfg)
        self.apihealth = api_health(cfg=self.cfg)
        self.kube = kube = wrap_health(kube, self.apihealth)
        if store is None:
            inner = (WatchMasterStore(kube, self.cfg) if self.cfg.store_watch_enabled
                     else KubeMasterStore(kube, self.cfg))
            store = CachedMasterStore(inner, cfg=self.cfg, apihealth=self.apihealth)
        self.store = store
        self.shards = shards if shards is not None else ShardManager(kube, cfg=self.cfg)
        # the admission gates (master_http_concurrency; 0: none). A peer's
        # forwarded sub-batch waits on a gate of its own, never the clients':
        # two replicas proxying to each other cannot deadlock on their own
        # slots. Its depth is what every other replica's admitted load could
        # forward here at once, so it trips only on a runaway peer
        depth = int(self.cfg.master_http_concurrency)
        self._client_gate = threading.BoundedSemaphore(depth) if depth > 0 else None
        self._forward_gate = (threading.BoundedSemaphore(
            depth * max(1, int(self.cfg.shard_count) - 1)) if depth > 0 else None)
        self.registry = registry or WorkerRegistry(kube, self.cfg, store=self.store)
        self._client_factory = worker_client_factory or (
            lambda addr: WorkerClient(addr, token=self._token, cfg=self.cfg,
                                      breaker=self.registry.breaker,
                                      channel_pool=self.registry.channel_pool))
        if telemetry_client_factory is None:
            telemetry_client_factory = worker_client_factory or (
                lambda addr: WorkerClient(addr, token=self._token, cfg=self.cfg))
        # the elastic reconciler: the routes and its loop share one store and
        # one queue; its loop runs only after elastic.start() (master/main.py),
        # and tests drive reconcile_once themselves
        self.elastic = ElasticReconciler(kube, self.registry, self._client_factory, cfg=self.cfg,
                                         store=IntentStore(kube, self.cfg, backend=self.store),
                                         shards=self.shards, apihealth=self.apihealth)
        # the migration machine, over the same registry and clients; the
        # interrupted ones are adopted by migrations.resume_interrupted()
        # (master/main.py, once the shards are owned)
        self.migrations = MigrationCoordinator(kube, self.registry, self._client_factory,
                                               cfg=self.cfg, store=self.store,
                                               shards=self.shards, apihealth=self.apihealth)
        # the fleet planes: the collector pulls every owned worker's telemetry
        # and feeds the SLO engine; its loop runs only after fleet.start()
        # (master/main.py), and the reads collect on demand when the rollup
        # is stale
        self.slo = SloEngine(cfg=self.cfg, kube=kube)
        self.fleet = FleetCollector(self.registry, telemetry_client_factory, cfg=self.cfg,
                                    slo=self.slo, shards=self.shards)
        # the capacity plane observes every pass and serves /capacity from its
        # node entries; registered for the process, so that the reconciler's
        # refusals stamp its verdict
        self.capacity = capacity_obs.CapacityPlane(self.fleet, cfg=self.cfg,
                                                   elastic=self.elastic)
        self.fleet.capacity = self.capacity
        capacity_obs.register_plane(self.capacity)
        # the recovery plane: liveness verdicts and evacuations; its probe
        # reads the registry's breaker and calls over the collector's client,
        # so that a worker not serving yet neither opens the mount path's
        # breaker nor backs its pooled channel off; its loop runs only after
        # recovery.start() (master/main.py)
        self.recovery = RecoveryController(kube, self.registry, telemetry_client_factory,
                                           cfg=self.cfg, store=self.store, shards=self.shards,
                                           elastic=self.elastic, migrations=self.migrations,
                                           apihealth=self.apihealth)
        # the gray-failure plane: scores every collection pass, its quarantine
        # set restored from the store (a takeover keeps it); the canary's loop
        # runs only after canary.start(). The controller learns the plane so
        # that an evacuation retires its record; quarantined is not dead
        self.health = HealthPlane(self.cfg, recovery=self.recovery, store=self.store)
        self.health.load()
        self.fleet.health = self.health
        self.recovery.health = self.health
        self.canary = CanaryProber(self.health, self.registry, self._client_factory,
                                   cfg=self.cfg)
        # the defragmenter: plans over the capacity plane's verdicts and
        # drives the moves through the migration machine; quarantined hosts
        # are no destination. Its loop runs only after defrag.start()
        # (master/main.py, under TPUMOUNTER_DEFRAG); the routes call plan()
        # and run() themselves
        self.defrag = DefragController(kube, self.migrations, self.capacity, self.fleet,
                                       slo=self.slo, apihealth=self.apihealth,
                                       shards=self.shards, cfg=self.cfg, health=self.health)
        # the fractional shares: the books and the admission behind /shares;
        # the capacity plane reads the books for its fractional view
        self.shares = ShareRegistry(cfg=self.cfg)
        self.packer = SharePacker(self.shares, cfg=self.cfg)
        self.capacity.shares = self.shares
        # the autoscaler: fits the tenants' curves from the fleet's /tenants
        # telemetry and turns queue and utilization into gated intents; its
        # model rides every collection pass, so that it learns while the loop
        # is off. Its loop runs only after autoscale.start() (master/main.py,
        # under TPUMOUNTER_AUTOSCALE); the routes work either way
        self.autoscale = AutoscaleController(self.elastic, self.capacity, self.fleet,
                                             slo=self.slo, apihealth=self.apihealth,
                                             health=self.health, defrag=self.defrag,
                                             cfg=self.cfg)
        self.fleet.autoscale_model = self.autoscale.model
        # root and error spans, audit records and the API's transitions onto
        # the timeline; idempotent
        flight.install(apihealth=self.apihealth)

    def close(self) -> None:
        """Stop the autoscaler's, the defragmenter's, the canary's, the
        recovery controller's, the reconciler's and the fleet collector's
        loops, wait for the migrations' machines, stop the registry's watch
        and its channels, and close the store (its ApiHealth subscription,
        its probe, its watch and its queue). Its capacity plane stops being
        the process's."""
        capacity_obs.unregister_plane(self.capacity)
        self.autoscale.stop()
        self.defrag.stop()
        self.canary.stop()
        self.recovery.stop()
        self.elastic.stop()
        self.migrations.stop()
        self.fleet.stop()
        self.registry.stop()
        self.store.close()

    # --- plumbing ---

    def handle(self, method: str, path: str, body: bytes, headers: dict[str, str]
               ) -> tuple[int, str, str, dict[str, str]]:
        """(status, content_type, body, response headers). A traced
        request's answer carries its trace id, a failure's too."""
        extra: dict[str, str] = {}
        try:
            for m, pattern, name in _ROUTES:
                if m != method:
                    continue
                match = pattern.match(path)
                if match:
                    return self._dispatch(name, match, method, body, headers, extra)
            raise _HttpError(404, "404 page not found")
        except _HttpError as exc:
            return exc.status, "text/plain", exc.message + "\n", {**extra, **exc.headers}
        except Exception as exc:  # noqa: BLE001 — the HTTP boundary
            logger.exception("unhandled error for %s %s", method, path)
            return 500, "text/plain", f"Service Internal Error: {exc}\n", extra

    def _dispatch(self, name: str, match, method: str, body: bytes, headers: dict[str, str],
                  extra: dict[str, str]) -> tuple[int, str, str, dict[str, str]]:
        """One routed request, one root span; its trace id goes into
        `extra`, the answer's headers, as soon as the span opens. The auth
        check runs first: an unauthenticated peer must not churn the ring,
        nor put spans into another's trace through the inbound header. A
        failure leaves the span as an error and reaches ``handle``."""
        self._check_auth(name, headers)
        if name in self.UNTRACED_ROUTES:
            with self._admission(name, headers):
                status, ctype, text = getattr(self, f"_route_{name}")(match, body, headers)
            return status, ctype, text, {}
        inbound = next((v for k, v in headers.items() if k.lower() == trace.TRACE_HEADER), None)
        with trace.span(f"http.{name}", wire_parent=inbound, http_method=method) as ctx:
            extra[trace.RESPONSE_HEADER] = ctx.trace_id
            with self._admission(name, headers):
                if name in self.AUDITED_ROUTES:
                    status, ctype, text = self._audited_route(name, match, body, headers)
                else:
                    status, ctype, text = getattr(self, f"_route_{name}")(match, body, headers)
            return status, ctype, text, extra

    @contextlib.contextmanager
    def _admission(self, name: str, headers: dict[str, str]):
        """The admission gate: at most master_http_concurrency requests at
        once (0: no gate). A forwarded request takes a slot of its own gate.
        Inside a traced route's edge span the wait for a slot is a span of
        its own, ``http.admission``, so a saturated replica's queueing shows
        as a phase instead of vanishing into the edge span."""
        if name in self.UNGATED_ROUTES:
            yield
            return
        forwarded = any(k.lower() == FORWARDED_HEADER for k in headers)
        gate = self._forward_gate if forwarded else self._client_gate
        if gate is None:
            yield
            return
        if trace.current() is not None:
            with trace.span("http.admission", route=name, forwarded=forwarded):
                gate.acquire()
        else:
            gate.acquire()
        try:
            yield
        finally:
            gate.release()

    def _audited_route(self, name: str, match, body: bytes,
                       headers: dict[str, str]) -> tuple[int, str, str]:
        """The route's edge record: the actor (the x-tpumounter-actor header,
        else "http"), the pod when the path names one, "http <status>", the
        time and the edge's trace id."""
        groups = match.groupdict()
        actor = _actor(headers)
        with audited(f"http.{name}", actor=actor, namespace=groups.get("ns", ""),
                     pod=groups.get("pod", "")) as rec:
            try:
                status, ctype, text = getattr(self, f"_route_{name}")(match, body, headers)
            except _HttpError as exc:
                rec["outcome"] = f"http {exc.status}"
                raise
            rec["outcome"] = f"http {status}"
            return status, ctype, text

    def _check_auth(self, route: str, headers: dict[str, str]) -> None:
        if route in self.UNAUTHENTICATED_ROUTES:
            return
        value = next((v for k, v in headers.items() if k.lower() == "authorization"), None)
        if route in self.READ_ROUTES:
            if self._read_token is not None:
                if check_bearer(value, self._read_token) or (
                        self._token is not None and check_bearer(value, self._token)):
                    return
                logger.warning("unauthorized %s read refused", route)
                raise _HttpError(401, "missing or invalid bearer token (read scope)")
            if route == "metrics":
                return  # the scrape surface stays open without a read token
        if self._token is None:
            return
        if not check_bearer(value, self._token):
            logger.warning("unauthenticated %s request refused", route)
            raise _HttpError(401, "missing or invalid bearer token")

    def _shard_gate(self, node: str, path: str) -> None:
        """Another replica owns the node: 307 to the owner's advertised URL
        with `path` (``rpc/http_failover.py`` follows it, the body sent
        again); a shard with no live owner (its lease expired, the renew
        loops racing to claim it): 503 with Retry-After 1."""
        kind, url = self.shards.route(node)
        if kind == "local":
            return
        if kind == "remote" and url:
            raise _HttpError(307, f"node {node} is owned by master replica at {url}",
                             headers={"Location": url.rstrip("/") + path})
        raise _HttpError(503, f"shard for node {node} has no live owner yet; retry",
                         headers={"Retry-After": "1"})

    def _worker_for_pod(self, namespace: str, pod_name: str,
                        redirect_path: str | None = None) -> tuple[str, str]:
        """(worker address, node name), or the _HttpError of the miss. With
        `redirect_path`, a node this replica does not own answers the shard
        gate's 307 or 503 before any worker is looked up."""
        try:
            with trace.span("k8s.get_pod", pod=f"{namespace}/{pod_name}"):
                pod = Pod(self.kube.get_pod(namespace, pod_name))
        except NotFoundError:
            raise _HttpError(404, f"No pod: {pod_name} in namespace: {namespace}")
        node = pod.node_name
        if not node:
            raise _HttpError(400, f"Pod {pod_name} is not scheduled yet")
        if redirect_path is not None:
            self._shard_gate(node, redirect_path)
        address = self.registry.worker_address(node)
        if address is None:
            logger.error("no gpu-mounter worker on node %s", node)
            raise _HttpError(500, "Service Internal Error")
        # a degraded worker: 503 now, not a call queued behind a dial known
        # to hang; a pure read, so the half-open probe's slot stays for the
        # call itself
        retry_after = self.registry.breaker.retry_after(address)
        if retry_after is not None:
            raise _HttpError(503, f"worker on node {node} is degraded (circuit breaker "
                                  f"open); retry in {retry_after:.0f}s",
                             headers=_retry_after(retry_after))
        return address, node

    # --- routes ---

    def _route_index(self, match, body, headers):
        return 200, "text/plain", "tpumounter master\n"

    def _route_healthz(self, match, body, headers):
        # liveness stays 200 through an API outage; the verdict is in the body
        state = self.apihealth.state()
        if state == "healthy":
            return 200, "text/plain", "ok\n"
        return 200, "text/plain", f"ok\napi: {state}\n"

    def _route_apihealth(self, match, body, headers):
        """ApiHealth's verdict, the store's cache ages and its write-behind
        queue."""
        payload = {"api": self.apihealth.payload(), "store": self.store.payload()}
        return 200, "application/json", json.dumps(payload, indent=1) + "\n"

    def _route_audit(self, match, body, headers):
        """The audit trail, filtered (``obs.audit.query_from_params``)."""
        params = urllib.parse.parse_qs(match.group("query") or "")
        try:
            payload = audit.query_from_params(params)
        except ValueError:
            raise _HttpError(400, f"Invalid limit: {params.get('limit')!r}")
        return 200, "application/json", json.dumps(payload, indent=1) + "\n"

    def _route_trace(self, match, body, headers):
        """The assembled trace: this process's ring joined with the workers'
        federated spans. An incomplete one (a worker's half not collected
        yet) is assembled again after one fleet pass, at most one a second
        (a polling dashboard must not turn into a scrape storm)."""
        tid = match.group("tid")
        payload = assembly.assemble(tid)
        if payload is not None and not payload["complete"]:
            try:
                self.fleet.refresh_if_stale(max_age_s=1.0)
            except Exception:  # noqa: BLE001 — the join still answers
                logger.exception("fleet refresh for /trace/%s failed", tid)
            payload = assembly.assemble(tid)
        if payload is None:
            raise _HttpError(404, f"no spans buffered for trace {tid} (expired from the "
                                  f"ring, or minted elsewhere)")
        return 200, "application/json", json.dumps(payload, indent=1) + "\n"

    def _route_timeline(self, match, body, headers):
        """The flight recorder's timeline, filtered
        (``obs.flight.query_from_params``)."""
        params = urllib.parse.parse_qs(match.group("query") or "")
        try:
            payload = flight.query_from_params(params)
        except ValueError:
            raise _HttpError(400, f"Invalid timeline filter: {params!r} (from/to/limit must "
                                  f"be numeric)")
        return 200, "application/json", json.dumps(payload, indent=1) + "\n"

    def _route_metrics(self, match, body, headers):
        """The exposition; OpenMetrics, with the histograms' trace-id
        exemplars, when the Accept header asks for it."""
        accept = next((v for k, v in headers.items() if k.lower() == "accept"), "")
        if "application/openmetrics-text" in accept:
            return (200, "application/openmetrics-text; version=1.0.0",
                    REGISTRY.render(openmetrics=True))
        return 200, "text/plain; version=0.0.4", REGISTRY.render()

    def _route_fleet(self, match, body, headers):
        """The fleet's rollup, collected first when stale."""
        payload = self.fleet.payload(max_age_s=self.cfg.fleet_scrape_interval_s)
        return 200, "application/json", json.dumps(payload, indent=1) + "\n"

    def _route_slo(self, match, body, headers):
        """The burn rates, over a rollup refreshed first when stale."""
        self.fleet.refresh_if_stale(self.cfg.fleet_scrape_interval_s)
        return 200, "application/json", json.dumps(self.slo.payload(), indent=1) + "\n"

    def _route_tenants(self, match, body, headers):
        """Each tenant's steps and disruption windows, joined to the trace
        plane."""
        payload = self.fleet.tenants_payload(max_age_s=self.cfg.fleet_scrape_interval_s)
        return 200, "application/json", json.dumps(payload, indent=1) + "\n"

    def _route_capacity(self, match, body, headers):
        """The capacity pane (``obs/capacity.py``) over the fleet's rollup,
        collected first when stale; ?accel_type= keeps one row of the
        feasibility table, 404 for a shape the table does not have."""
        params = urllib.parse.parse_qs(match.group("query") or "")
        accel = params.get("accel_type", [None])[-1]
        try:
            payload = self.capacity.payload(max_age_s=self.cfg.fleet_scrape_interval_s,
                                            accel_type=accel)
        except KeyError:
            # only the filter raises KeyError by contract; any other stays a 500
            if accel is None:
                raise
            raise _HttpError(404, f"unknown accelerator type {accel!r}; see topology.py's "
                                  f"FEASIBILITY_SHAPES for the known shapes")
        return 200, "application/json", json.dumps(payload, indent=1) + "\n"

    def _route_shares(self, match, body, headers):
        """The share books: every (tenant, GPU, weight, budget), each GPU's
        load and headroom, the totals."""
        return 200, "application/json", json.dumps(self.shares.payload(), indent=1) + "\n"

    def _route_shares_admit(self, match, body, headers):
        """Book a tenant's shares: {"namespace", "pod", "profile", "chips",
        "weight", "rate_budget"?, "inventory": {uuid: node}?}. The packer
        passes over the capacity plane's blocked hosts and the health
        plane's quarantined ones, and ranks its probation hosts last; its
        refusal is 409 (nothing booked), and 503 with vchip off."""
        if not self.cfg.vchip_enabled:
            raise _HttpError(503, "fractional shares are disabled (TPUMOUNTER_VCHIP=false)")
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            raise _HttpError(400, "body must be JSON")
        if not isinstance(payload, dict):
            raise _HttpError(400, "body must be a JSON object")
        namespace, pod = payload.get("namespace"), payload.get("pod")
        if not namespace or not pod:
            raise _HttpError(400, "namespace and pod are required")
        inventory = payload.get("inventory") or {}
        if not isinstance(inventory, dict) or not all(
                isinstance(k, str) and isinstance(v, str) for k, v in inventory.items()):
            raise _HttpError(400, "inventory must map chip uuid -> node name")
        try:
            chips = int(payload.get("chips", 1))
            weight = int(payload.get("weight", 0))
            rate_budget = int(payload.get("rate_budget", 0))
        except (TypeError, ValueError):
            raise _HttpError(400, "chips, weight and rate_budget must be integers")
        try:
            booked = self.packer.admit(
                str(namespace), str(pod), str(payload.get("profile", "balanced")), chips,
                weight, rate_budget=rate_budget, inventory=inventory,
                blocked_hosts=self.capacity.blocked_hosts(
                    max_age_s=self.cfg.fleet_scrape_interval_s),
                excluded_hosts=self.health.excluded_hosts(),
                probation_hosts=self.health.probation_hosts())
        except (PackRefused, ShareLimitError) as exc:
            raise _HttpError(409, str(exc))
        return 200, "application/json", json.dumps(
            {"admitted": [s.to_json() for s in booked]}, indent=1) + "\n"

    def _route_shares_release(self, match, body, headers):
        """Every share of a tenant off the books; 404 when it holds none."""
        ns, pod = match.group("ns"), match.group("pod")
        released = self.packer.release(ns, pod)
        if not released:
            raise _HttpError(404, f"{ns}/{pod} holds no shares")
        return 200, "application/json", json.dumps(
            {"released": [s.to_json() for s in released]}, indent=1) + "\n"

    def _route_recovery(self, match, body, headers):
        """The recovery plane: each node's liveness verdict, the evacuations,
        the confirmation settings."""
        return 200, "application/json", json.dumps(self.recovery.payload(), indent=1) + "\n"

    def _route_recovery_evacuate(self, match, body, headers):
        """A manual evacuation, for an operator who confirmed the death out of
        band: no confirmation window. Shard-gated: the node's owner runs it."""
        node = match.group("node")
        self._shard_gate(node, f"/recovery/evacuate/{node}")
        record = self.recovery.evacuate(node, reason="manual")
        return 200, "application/json", json.dumps(record, indent=1) + "\n"

    def _route_health_nodes(self, match, body, headers):
        """The health plane's pane: each node's state, signals and canary
        streaks (node names ride here, never a series' labels), the budget,
        the last pass's verdict."""
        return 200, "application/json", json.dumps(self.health.payload(), indent=1) + "\n"

    def _route_health_quarantine(self, match, body, headers):
        """An operator's quarantine or release (body {"action": "quarantine" |
        "release", "reason": ...}; quarantine by default). Shard-gated. A
        release the plane refuses (the node is not quarantined, or was
        evacuated) is 409."""
        node = match.group("node")
        self._shard_gate(node, f"/health/quarantine/{node}")
        try:
            req = json.loads(body.decode() or "{}")
        except ValueError:
            raise _HttpError(400, "body is not valid JSON")
        if not isinstance(req, dict):
            raise _HttpError(400, "body must be a JSON object")
        action = str(req.get("action") or "quarantine")
        actor = _actor(headers)
        try:
            if action == "quarantine":
                pane = self.health.quarantine(node, reason=str(req.get("reason") or ""),
                                              actor=actor)
            elif action == "release":
                pane = self.health.release(node, actor=actor)
            else:
                raise _HttpError(400, f"unknown action {action!r} (quarantine or release)")
        except ValueError as exc:
            raise _HttpError(409, str(exc))
        return 200, "application/json", json.dumps(
            {"node": node, "action": action, "health": pane}, indent=1) + "\n"

    # --- the defragmenter (defrag/) ---

    def _route_defrag(self, match, body, headers):
        """The defragmenter's pane: the gates, the adopted plan, the run in
        flight with its barrier samples, the last runs."""
        return 200, "application/json", json.dumps(self.defrag.payload(), indent=1) + "\n"

    def _refusable_call(self, refused, interval_s, fn, *args, **kwargs):
        """A loop's refusal (DefragRefused, AutoscaleRefused) answers its own
        status (409 paused or busy, 503 parked); a 503 carries Retry-After,
        the loop's interval `interval_s`, so that a script backs off."""
        try:
            return fn(*args, **kwargs)
        except refused as exc:
            headers = ({"Retry-After": str(int(interval_s))} if exc.status == 503 else {})
            raise _HttpError(exc.status, str(exc), headers=headers)

    def _defrag_body(self, body: bytes) -> dict:
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            raise _HttpError(400, "body must be JSON")
        if not isinstance(payload, dict):
            raise _HttpError(400, "body must be a JSON object")
        return payload

    def _route_defrag_plan(self, match, body, headers):
        """Compute and adopt a plan from a fresh capacity snapshot; the
        body's "target_block" overrides DEFRAG_TARGET_BLOCK for this plan."""
        target = self._defrag_body(body).get("target_block")
        if target is not None and (not isinstance(target, int) or target < 1):
            raise _HttpError(400, f"target_block must be a positive integer, got {target!r}")
        plan = self._refusable_call(DefragRefused, self.cfg.defrag_interval_s,
                                    self.defrag.plan, target_block=target)
        return 200, "application/json", json.dumps(plan, indent=1) + "\n"

    def _route_defrag_run(self, match, body, headers):
        """Execute the adopted plan on a thread of its own; the body's
        "plan_id" pins the run to that plan (409 when another was adopted
        since)."""
        out = self._refusable_call(DefragRefused, self.cfg.defrag_interval_s, self.defrag.run,
                                   plan_id=self._defrag_body(body).get("plan_id"))
        return 200, "application/json", json.dumps(out, indent=1) + "\n"

    def _route_defrag_pause(self, match, body, headers):
        return 200, "application/json", json.dumps(self.defrag.pause(), indent=1) + "\n"

    # --- the autoscaler (autoscale/) ---

    def _route_autoscale(self, match, body, headers):
        """The autoscaler's pane: the gates, the model's fits with their
        verdicts, the last pass, the recent decisions, the cooldowns."""
        return 200, "application/json", json.dumps(self.autoscale.payload(), indent=1) + "\n"

    def _route_autoscale_pause(self, match, body, headers):
        actor = _actor(headers)
        return 200, "application/json", json.dumps(self.autoscale.pause(actor=actor),
                                                   indent=1) + "\n"

    def _route_autoscale_resume(self, match, body, headers):
        actor = _actor(headers)
        return 200, "application/json", json.dumps(self.autoscale.resume(actor=actor),
                                                   indent=1) + "\n"

    def _route_autoscale_evaluate(self, match, body, headers):
        """One pass now rather than at the loop's interval; nothing fires
        through a closed gate."""
        out = self._refusable_call(AutoscaleRefused, self.cfg.autoscale_interval_s,
                                   self.autoscale.evaluate_once)
        return 200, "application/json", json.dumps(out, indent=1) + "\n"

    def _route_workers(self, match, body, headers):
        lines = [f"{node} {ip}" for node, ip in
                 sorted(self.registry.registry_snapshot().items())]
        return 200, "text/plain", "\n".join(lines) + "\n"

    def _route_shards(self, match, body, headers):
        """The shard table: which replica holds which shard's lease."""
        return 200, "application/json", json.dumps(self.shards.table(), indent=1) + "\n"

    # --- the elastic intents (elastic/) ---

    def _intent_status(self, ns: str, pod: str, intent: Intent) -> dict:
        entry = {"namespace": ns, "pod": pod, **intent.to_json()}
        status = self.elastic.status_for(ns, pod)
        if status is not None:
            entry["status"] = status
        return entry

    def _route_intents_list(self, match, body, headers):
        items = [self._intent_status(ns, pod, intent)
                 for ns, pod, intent in self.elastic.store.list()]
        return 200, "application/json", json.dumps({"intents": items}, indent=1) + "\n"

    def _route_intent_get(self, match, body, headers):
        ns, pod = match.group("ns"), match.group("pod")
        try:
            intent = self.elastic.store.get(ns, pod)
        except NotFoundError:
            raise _HttpError(404, f"No pod: {pod} in namespace: {ns}")
        if intent is None:
            raise _HttpError(404, f"no intent declared for {ns}/{pod}")
        return 200, "application/json", json.dumps(self._intent_status(ns, pod, intent),
                                                   indent=1) + "\n"

    def _route_intent_put(self, match, body, headers):
        """Declare (or replace) the pod's intent, body {"desiredChips",
        "minChips", "priority"}, and queue the pod for a pass."""
        ns, pod = match.group("ns"), match.group("pod")
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            raise _HttpError(400, "body must be JSON")
        try:
            intent = Intent.from_json(payload)
            self.elastic.store.put(ns, pod, intent)
        except IntentError as exc:
            raise _HttpError(400, str(exc))
        except NotFoundError:
            raise _HttpError(404, f"No pod: {pod} in namespace: {ns}")
        logger.info("intent declared: %s/%s -> %s", ns, pod, intent.to_json())
        self.elastic.enqueue(ns, pod, priority=intent.priority)
        return 200, "application/json", json.dumps(self._intent_status(ns, pod, intent),
                                                   indent=1) + "\n"

    def _route_intent_delete(self, match, body, headers):
        """Drop the intent (the pod keeps its GPUs)."""
        ns, pod = match.group("ns"), match.group("pod")
        try:
            had = self.elastic.store.delete(ns, pod)
        except NotFoundError:
            raise _HttpError(404, f"No pod: {pod} in namespace: {ns}")
        return 200, "application/json", json.dumps({"deleted": had}) + "\n"

    # --- the live migration (migrate/) ---

    def _route_migrate_start(self, match, body, headers):
        """Body {"source": {"namespace", "pod"}, "destination": {...},
        "checkpoint": false}; the journal as begun."""
        try:
            payload = json.loads(body or b"{}")
        except ValueError:
            raise _HttpError(400, "body must be JSON")
        if not isinstance(payload, dict):
            raise _HttpError(400, 'body must be a JSON object with "source" and "destination"')

        def _ref(key):
            entry = payload.get(key)
            if not isinstance(entry, dict) or not entry.get("pod"):
                raise _HttpError(400, f'"{key}" must be {{"namespace": ..., "pod": ...}}')
            return entry.get("namespace", "default"), entry["pod"]

        src_ns, src_pod = _ref("source")
        dst_ns, dst_pod = _ref("destination")
        checkpoint = payload.get("checkpoint", False)
        if not isinstance(checkpoint, bool):
            raise _HttpError(400, '"checkpoint" must be a boolean')
        try:
            journal = self.migrations.begin(src_ns, src_pod, dst_ns, dst_pod,
                                            checkpoint=checkpoint)
        except MigrationError as exc:
            raise _HttpError(exc.status, str(exc))
        return 200, "application/json", json.dumps(journal, indent=1) + "\n"

    def _route_migrations_list(self, match, body, headers):
        return 200, "application/json", json.dumps(
            {"migrations": self.migrations.list_migrations()}, indent=1) + "\n"

    def _route_migration_get(self, match, body, headers):
        journal = self.migrations.get(match.group("mid"))
        if journal is None:
            raise _HttpError(404, f"no migration {match.group('mid')}")
        return 200, "application/json", json.dumps(journal, indent=1) + "\n"

    def _route_migration_abort(self, match, body, headers):
        try:
            out = self.migrations.abort(match.group("mid"))
        except MigrationError as exc:
            raise _HttpError(exc.status, str(exc))
        return 200, "application/json", json.dumps(out) + "\n"

    def _route_add(self, match, body, headers):
        ns, pod_name, num_raw = match.group("ns"), match.group("pod"), match.group("num")
        try:
            gpu_num = int(num_raw)
        except ValueError:
            raise _HttpError(400, f"Invalid param gpuNum: {num_raw}")
        if not 0 < gpu_num <= self.cfg.max_gpu_per_request:
            raise _HttpError(400, f"Invalid param gpuNum: {num_raw} (must be 1.."
                                  f"{self.cfg.max_gpu_per_request})")
        entire = _parse_bool(match.group("entire"), "isEntireMount")
        logger.info("AddGPU request: %s/%s num=%d entire=%s", ns, pod_name, gpu_num, entire)
        address, node = self._worker_for_pod(ns, pod_name, redirect_path=match.string)
        with self._client_factory(address) as client:
            try:
                # the owner shard's fencing epoch (field 8; none when the
                # shards are inactive: 0 never fences)
                result = client.add_gpu(pod_name, ns, gpu_num, entire,
                                        **epoch_kwargs(self.shards, node)).add_gpu_result
            except Exception as exc:  # noqa: BLE001 — the worker call's boundary
                logger.error("worker AddGPU failed: %s", exc)
                raise _degraded_or_500(exc)
        if result == AddGPUResult.Success:
            return 200, "text/plain", "Add GPU Success\n"
        if result == AddGPUResult.InsufficientGPU:
            # refused for capacity: the plane's verdict (its last rollup) into
            # the audit trail and the timeline, before the 500
            self.capacity.record_rejection(node, ns, pod_name, gpu_num)
            raise _HttpError(500, f"Insufficient GPU on Node: {node}")
        if result == AddGPUResult.PodNotFound:
            raise _HttpError(400, f"No Pod {pod_name} on Node: {node}")
        raise _HttpError(500, f"unknown worker result {result}")

    def _route_remove(self, match, body, headers):
        ns, pod_name = match.group("ns"), match.group("pod")
        force = _parse_bool(match.group("force"), "force")
        raw_uuids = urllib.parse.parse_qs(body.decode("utf-8", "replace")).get("uuids")
        if not raw_uuids:
            raise _HttpError(400, "Invalid parameter")
        uuids = [u for entry in raw_uuids for u in entry.split(",") if u]
        logger.info("RemoveGPU request: %s/%s uuids=%s force=%s", ns, pod_name, uuids, force)
        address, node = self._worker_for_pod(ns, pod_name, redirect_path=match.string)
        with self._client_factory(address) as client:
            try:
                result = client.remove_gpu(pod_name, ns, uuids, force,
                                           **epoch_kwargs(self.shards, node)).remove_gpu_result
            except Exception as exc:  # noqa: BLE001 — the worker call's boundary
                logger.error("worker RemoveGPU failed: %s", exc)
                raise _degraded_or_500(exc)
        joined = ", ".join(uuids)
        if result == RemoveGPUResult.Success:
            return 200, "text/plain", f"Remove {len(uuids)} GPUs Success\n"
        if result == RemoveGPUResult.PodNotFound:
            raise _HttpError(400, f"No Pod {pod_name} on Node: {node}")
        if result == RemoveGPUResult.GPUBusy:
            raise _HttpError(400, f"Pod: {pod_name} has running processes on GPU: {joined}")
        if result == RemoveGPUResult.GPUNotFound:
            raise _HttpError(400, f"Invalid UUIDs: {joined}")
        raise _HttpError(500, f"unknown worker result {result}")


    # --- the slice and batch routes (master/slice_ops.py) ---

    def _parse_slice_body(self, body: bytes) -> tuple[dict, list[SliceTarget]]:
        payload = _json_body(body, "pods")
        raw = payload.get("pods")
        if not isinstance(raw, list) or not raw:
            raise _HttpError(400, 'JSON body needs "pods": [{"namespace": ..., "pod": ...}, ...]')
        targets = []
        for entry in raw:
            if not isinstance(entry, dict):
                raise _HttpError(400, f'pods entries must be objects {{"namespace", "pod"}}: '
                                      f"{entry!r}")
            pod = entry.get("pod")
            if not pod:
                raise _HttpError(400, f"pods entry missing 'pod': {entry}")
            targets.append(SliceTarget(namespace=entry.get("namespace", "default"), pod=pod))
        return payload, targets

    def _slice_coordinator(self) -> SliceCoordinator:
        return SliceCoordinator(self.kube, self.registry, self._client_factory, self.cfg,
                                shards=self.shards)

    def _route_addslice(self, match, body, headers):
        payload, targets = self._parse_slice_body(body)
        try:
            gpus = int(payload.get("gpusPerHost", DEFAULT_GPUS_PER_HOST))
        except (TypeError, ValueError):
            raise _HttpError(400, f"Invalid gpusPerHost: {payload.get('gpusPerHost')!r}")
        if gpus <= 0:
            raise _HttpError(400, f"Invalid gpusPerHost: {gpus}")
        try:
            plan = self._slice_coordinator().mount_slice(
                targets, gpus, bool(payload.get("isEntireMount", True)),
                accel_type=payload.get("acceleratorType") or None)
        except SliceError as exc:
            raise _HttpError(exc.status, str(exc), headers=_slice_headers(exc))
        return 200, "application/json", json.dumps(plan, indent=1) + "\n"

    def _route_removeslice(self, match, body, headers):
        payload, targets = self._parse_slice_body(body)
        try:
            outcome = self._slice_coordinator().remove_slice(
                targets, bool(payload.get("force", False)))
        except SliceError as exc:
            raise _HttpError(exc.status, str(exc), headers=_slice_headers(exc))
        return 200, "application/json", json.dumps(outcome) + "\n"

    def _parse_bulk_body(self, body: bytes) -> list[BulkTarget]:
        raw = _json_body(body, "targets").get("targets")
        if not isinstance(raw, list) or not raw:
            raise _HttpError(400, 'JSON body needs "targets": [{"namespace", "pod", "gpus", '
                                  '"isEntireMount"}, ...]')
        if len(raw) > self.cfg.bulk_max_targets:
            raise _HttpError(400, f"too many targets: {len(raw)} > "
                                  f"{self.cfg.bulk_max_targets} (BULK_MAX_TARGETS)")
        targets = []
        for entry in raw:
            if not isinstance(entry, dict) or not entry.get("pod"):
                raise _HttpError(400, f"targets entries must be objects with a 'pod': "
                                      f"{entry!r}")
            try:
                gpus = int(entry.get("gpus", 1))
            except (TypeError, ValueError):
                raise _HttpError(400, f"invalid gpus for {entry.get('pod')}: "
                                      f"{entry.get('gpus')!r}")
            if not 0 < gpus <= self.cfg.max_gpu_per_request:
                raise _HttpError(400, f"invalid gpus {gpus} for {entry['pod']} "
                                      f"(must be 1..{self.cfg.max_gpu_per_request})")
            targets.append(BulkTarget(namespace=entry.get("namespace", "default"),
                                      pod=entry["pod"], gpus=gpus,
                                      entire=bool(entry.get("isEntireMount", False))))
        return targets

    def _route_batch_add(self, match, body, headers):
        """One request, many pods' mounts, a result for each: a bad pod, a
        node without its worker or a dead shard never fails the rest of the
        batch. Targets go by their node's owner shard: this replica's mount
        here (grouped by node), a peer's are proxied to it as one sub-batch
        each, overlapping the local mounts; a forwarded request mounts only
        what this replica owns (NotOwner for the rest), and a shard with no
        live owner answers Unowned with retryAfterS."""
        targets = self._parse_bulk_body(body)
        forwarded = any(k.lower() == FORWARDED_HEADER for k in headers)
        coordinator = BulkMountCoordinator(self.kube, self.registry, self._client_factory,
                                           self.cfg, shards=self.shards)
        results: list[dict | None] = [None] * len(targets)
        resolve_errors, by_node = coordinator._resolve_bulk(targets)
        for i, err in resolve_errors.items():
            results[i] = {"namespace": targets[i].namespace, "pod": targets[i].pod, **err}
        local_by_node: dict[str, list[int]] = {}
        remote: dict[str, list[int]] = {}
        for node, indices in by_node.items():
            kind, url = self.shards.route(node)
            if kind == "local":
                local_by_node[node] = indices
                continue
            if kind == "remote" and url and not forwarded:
                remote.setdefault(url, []).extend(indices)
                continue
            for i in indices:
                entry = {"namespace": targets[i].namespace, "pod": targets[i].pod, "node": node}
                if forwarded:  # never a second hop: the client retries
                    entry.update(result="NotOwner", error=f"replica does not own node {node}")
                else:
                    entry.update(result="Unowned", retryAfterS=1,
                                 error=f"shard for node {node} has no live owner yet")
                results[i] = entry

        forwards = []
        if remote:
            # contextvars stay in their thread: each forwarder re-attaches
            # the edge span, so the owner joins this request's trace
            edge_ctx = trace.current()

            def _forward(item: tuple[str, list[int]]) -> None:
                url, indices = item
                with trace.attached(edge_ctx), \
                        trace.span("proxy.batch", url=url, targets=len(indices)):
                    entries = self._proxy_batch(url, [targets[i] for i in indices])
                for i, entry in zip(indices, entries):
                    results[i] = entry

            core = get_core(self.cfg)
            forwards = [core.submit(_forward, item, kind="batch-proxy")
                        for item in remote.items()]
        if local_by_node:
            local = coordinator.mount_bulk(targets, resolution=({}, local_by_node))
            for indices in local_by_node.values():
                for i in indices:
                    results[i] = local[i]
        for fut in forwards:
            fut.result()
        out = [r if r is not None else
               {"namespace": targets[i].namespace, "pod": targets[i].pod,
                "result": "Error", "error": "internal: unprocessed"}
               for i, r in enumerate(results)]
        by_result: dict[str, int] = {}
        for entry in out:
            by_result[entry.get("result", "Error")] = by_result.get(entry.get("result", "Error"),
                                                                    0) + 1
        payload = {"results": out,
                   "summary": {"total": len(out), "success": by_result.get("Success", 0),
                               "byResult": by_result}}
        return 200, "application/json", json.dumps(payload, indent=1) + "\n"

    def _proxy_batch(self, url: str, sub_targets: list[BulkTarget]) -> list[dict]:
        """POST a sub-batch to the replica that owns its nodes, with
        FORWARDED_HEADER and this request's trace context; its entries come
        back in order. Any failure (transport, an answer that is not the
        batch's) becomes a ProxyError entry a target, never an exception
        out of the route."""
        payload = {"targets": [{"namespace": t.namespace, "pod": t.pod, "gpus": t.gpus,
                                "isEntireMount": t.entire} for t in sub_targets]}
        request_headers = {"Content-Type": "application/json", FORWARDED_HEADER: "1",
                           trace.TRACE_HEADER: trace.wire_context()}
        if self._token:
            request_headers["Authorization"] = f"Bearer {self._token}"
        req = urllib.request.Request(url.rstrip("/") + "/batch/addgpu",
                                     data=json.dumps(payload).encode(), method="POST",
                                     headers=request_headers)
        try:
            with urllib.request.urlopen(req, timeout=self.cfg.bulk_proxy_timeout_s) as resp:
                entries = json.loads(resp.read().decode()).get("results", [])
            if len(entries) != len(sub_targets):
                raise ValueError(f"peer answered {len(entries)} results for "
                                 f"{len(sub_targets)} targets")
            return entries
        except Exception as exc:  # noqa: BLE001 — the peer's boundary
            logger.error("bulk proxy to %s failed: %s", url, exc)
            return [{"namespace": t.namespace, "pod": t.pod, "result": "ProxyError",
                     "error": f"owner replica {url} unreachable: {exc}"} for t in sub_targets]


def build_http_server(app: MasterApp, port: int | None = None,
                      host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The API on a ThreadingHTTPServer (not yet serving): `port` None is
    MASTER_PORT, 0 an ephemeral port (``server_address[1]``)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _dispatch(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            status, ctype, text, extra = app.handle(self.command, self.path, body,
                                                    dict(self.headers))
            payload = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            for key, value in extra.items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = do_PUT = do_DELETE = _dispatch

        def log_message(self, fmt, *args):
            logger.debug("http: " + fmt, *args)

    return ThreadingHTTPServer((host, app.cfg.master_port if port is None else port), Handler)
