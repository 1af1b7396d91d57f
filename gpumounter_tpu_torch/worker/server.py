"""The worker's add and remove flows, in process.

The counterpart of ``TpuMountService`` in
``gpumounter_tpu/worker/server.py``, and of the original's
``pkg/server/gpu-mount/server.go``:

  * ``add_gpu`` (AddGPU, server.go:34-99): get the pod -> CanMount gate ->
    slave pods for the GPUs, one per GPU or one for all on an entire mount
    (:61-66) -> grant and inject the batch; a failed mount releases the
    slave pods (:80-95);
  * ``remove_gpu`` (RemoveGPU, :101-179): get the pod -> the slave-held
    GPUs to remove -> a busy check of every GPU before touching any,
    unless forced (:137-153) -> unmount the batch, in one entry into the
    pod's namespace -> release the slave pods whose GPUs are all unmounted
    (:155-175).

Each call is a ``worker.AddGPU`` / ``worker.RemoveGPU`` span whose parent is
the client's span off the wire (``trace_context``, field 7; a fresh trace
when it is absent or malformed), and leaves an audit record whatever its end
(``obs/audit.py``), with the ``worker.rpc`` failpoint at its top. The slave
pods' scheduling is the ``mount.slave_pod_schedule`` span, which carries the
warm pool's outcome (``pool_hit``, ``pool_gap``, ``pool_enabled``: with
WARM_POOL_SIZE > 0 the service builds an ``allocator/pool.py`` pool, from which
single-GPU slaves are adopted first). Outcomes post the
Events ``GPUMounted``, ``GPUUnmounted`` and ``GPUMountFailed`` on the pod
(``k8s/events.py``; the reference's ``TPU*``), and the service installs the
flight recorder's hooks (``obs/flight.py``).

The service shares the node's ``MountLedger`` (``worker/ledger.py``, from
TPUMOUNTER_LEDGER_DIR) with the mounter, which journals every batch into it.
A mutation carries the master's fencing epoch (field 8): an older non-zero
one than the highest taken is refused FAILED_PRECONDITION "FENCED: ..."
(``tpumounter_fenced_writes_total``), a newer one kept in the ledger (a
mutation whose epoch cannot be written there is refused UNAVAILABLE), 0
never fenced. ``drain`` (SIGTERM) refuses new mutations UNAVAILABLE "worker
draining", waits for those in flight and closes the ledger clean. A slave
pod whose delete still fails after SLAVE_RELEASE_ATTEMPTS goes into the
ledger's queue (``tpumounter_slave_release_deferred_total``), retried by the
next release, ``retry_pending_releases`` and the restart's replay; without a
ledger it is counted as leaked and the call raises. The service's API calls
feed the process's ApiHealth (``k8s/health.py``; its client is wrapped by
``wrap_health``): the next release retries every deferred record while the
write plane is healthy, else one, as the reference's.

Each pod's flows are serialized (keyed by UID), so two entire mounts of one
pod cannot both pass the gate. A refused call raises ``ServiceError`` with
its gRPC status code. A call that carries an idempotency key and succeeded
is remembered: the same key again is answered from the first call's
response and mounts or unmounts nothing (the client's retries depend on it).

``collect_telemetry`` answers the fleet collector's CollectTelemetry (the
reference's ``worker/server.py:552-599``): the process's telemetry snapshot
(``obs/fleet.py``) in a ``worker.CollectTelemetry`` span, with the
``worker.rpc`` failpoint; the request's ``quarantined`` drains the node's
warm pool (``WarmPodPool.set_drained``) or lets it refill.

``probe_gpu`` answers ProbeGPU (the reference's ``probe_tpu``,
``worker/server.py:440-502``): the health of every GPU a pod holds, in a
``worker.ProbeGPU`` span with the ``worker.rpc`` failpoint; the health
plane's canary reads it between its add and its remove, and the elastic
reconciler before and after each pass. ``quiesce_status`` answers
QuiesceStatus (the reference's ``worker/server.py:504-547``): the tenant's ack
of a migration's phase (``tpumounter.io/migration-ack``), the holders of the
pod's GPUs and their count, in a ``worker.QuiesceStatus`` span with the
``worker.rpc`` failpoint; the migration machine polls it.

``build_server`` serves the service over gRPC (the counterpart of the
reference's ``build_server``, ``worker/server.py:854-954``): the original's
``gpu_mount.AddGPUService/AddGPU`` and ``gpu_mount.RemoveGPUService/RemoveGPU``,
``gpu_mount.ProbeGPUService/ProbeGPU``,
``gpu_mount.QuiesceStatusService/QuiesceStatus``,
``gpu_mount.TelemetryService/CollectTelemetry`` (left out with
``include_telemetry=False``), the health service, and the bearer-token
interceptor; a ``ServiceError``
becomes an abort with its code. grpc is imported there, on first use
(``utils/lazy_grpc.py``), never when this module is.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from concurrent import futures

from gpumounter_tpu_torch.allocator.pool import WarmPodPool
from gpumounter_tpu_torch.allocator.allocator import (
    GpuAllocator,
    InsufficientGpuError,
    MountType,
    SlavePodError,
)
from gpumounter_tpu_torch.cgroup.ebpf import device_rule
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s.client import KubeClient, NotFoundError
from gpumounter_tpu_torch.k8s.events import post_pod_event
from gpumounter_tpu_torch.k8s.health import api_health, wrap_health
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.nsutil import ns as nsutil
from gpumounter_tpu_torch.obs import flight, trace
from gpumounter_tpu_torch.obs.audit import audited
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.rpc.api import (
    AddGPURequest,
    AddGPUResponse,
    AddGPUResult,
    RemoveGPURequest,
    RemoveGPUResponse,
    RemoveGPUResult,
)
from gpumounter_tpu_torch.utils.auth import check_bearer, required_token
from gpumounter_tpu_torch.utils.lazy_grpc import grpc
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.utils.timing import PhaseTimer
from gpumounter_tpu_torch.worker.ledger import open_ledger
from gpumounter_tpu_torch.worker.mounter import GpuBusyError, GpuMounter, MountError

logger = get_logger("worker.server")

FENCED_WRITES = REGISTRY.counter(
    "tpumounter_fenced_writes_total",
    "Mutating RPCs rejected because they carried a stale fencing epoch "
    "(a partitioned old shard owner trying to mutate this node)")
SLAVE_RELEASE_FAILURES = REGISTRY.counter(
    "tpumounter_slave_release_failures_total",
    "Slave-pod releases that exhausted their bounded retry — leaked "
    "capacity until the reaper or the recovery plane sweeps it")
SLAVE_RELEASE_DEFERRED = REGISTRY.counter(
    "tpumounter_slave_release_deferred_total",
    "Slave-pod releases deferred into the ledger-backed retry queue "
    "after an API outage broke the delete (retried until the pods are "
    "confirmed gone — not a leak)")

#: the tenant's answer to the migration's signal (migrate/journal.py's
#: ANNOT_ACK; the worker keeps its own name, as the reference's)
ANNOT_MIGRATION_ACK = "tpumounter.io/migration-ack"

#: the answer to a mutation that reaches a draining worker
DRAINING = "worker draining (SIGTERM); retry elsewhere"


class ServiceError(RuntimeError):
    """A call the service refuses or cannot complete, with the gRPC status
    code (FAILED_PRECONDITION, INVALID_ARGUMENT, INTERNAL) it maps to."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class _KeyedLocks:
    """Per-key mutual exclusion without unbounded growth: entries are
    refcounted and dropped when the last holder releases."""

    def __init__(self) -> None:
        self._guard = threading.Lock()
        self._entries: dict[str, tuple[threading.Lock, int]] = {}

    @contextlib.contextmanager
    def held(self, key: str):
        with self._guard:
            lock, refs = self._entries.get(key, (threading.Lock(), 0))
            self._entries[key] = (lock, refs + 1)
        lock.acquire()
        try:
            yield
        finally:
            lock.release()
            with self._guard:
                lock, refs = self._entries[key]
                if refs <= 1:
                    del self._entries[key]
                else:
                    self._entries[key] = (lock, refs - 1)


class _IdempotencyCache:
    """Keys of recently completed mutations -> their responses
    (``worker/server.py:96-133`` of the reference). A master whose call
    died in the transport cannot know whether the mount landed; its retry
    sends the same key, and a completed key is answered from here. Bounded
    (oldest first out) and expiring, so an abandoned key pins nothing."""

    def __init__(self, capacity: int = 1024, ttl_s: float = 600.0):
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[float, object]] = {}

    def get(self, key: str):
        if not key:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            if time.monotonic() - entry[0] > self.ttl_s:
                del self._entries[key]
                return None
            return entry[1]

    def put(self, key: str, response) -> None:
        if not key:
            return
        with self._lock:
            while len(self._entries) >= self.capacity:
                self._entries.pop(next(iter(self._entries)))
            self._entries[key] = (time.monotonic(), response)


class GpuMountService:
    def __init__(self, kube: KubeClient, collector: GpuCollector,
                 allocator: GpuAllocator | None = None,
                 mounter: GpuMounter | None = None, cfg=None, pool: WarmPodPool | None = None):
        """pool: the node's warm pool; by default one is built when
        WARM_POOL_SIZE > 0 (it warms NODE_NAME at once when that is set),
        unless an `allocator` is given, which keeps whatever pool it was
        built with (a pool it never draws from would book GPUs for
        nothing)."""
        self.cfg = cfg or Config()
        # every API call of the worker feeds the process's ApiHealth
        self.apihealth = api_health(cfg=self.cfg)
        self.kube = kube = wrap_health(kube, self.apihealth)
        self.collector = collector
        # the node's ledger, from cfg.ledger_dir (none when it is ""); the
        # mounter journals every batch into it
        self.ledger = open_ledger(self.cfg)
        if pool is None and allocator is None and self.cfg.warm_pool_size > 0:
            pool = WarmPodPool(kube, cfg=self.cfg, apihealth=self.apihealth)
        self.pool = pool
        self.allocator = allocator or GpuAllocator(kube, collector, cfg=self.cfg, pool=pool)
        self.mounter = mounter or GpuMounter(collector.backend, cfg=self.cfg, kube=kube)
        self.mounter.ledger = self.ledger
        self._pod_locks = _KeyedLocks()
        self._idem = _IdempotencyCache()
        # The fencing epoch: the highest any master stamped on a mutation,
        # kept in the ledger so that a restart cannot forget it. A mutation
        # with an older non-zero epoch is refused FENCED; 0 (the field
        # absent: the original's single master) is never fenced.
        self._epoch_lock = threading.Lock()
        self._node_epoch = self.ledger.epoch() if self.ledger is not None else 0
        # SIGTERM: once draining, new mutations are refused UNAVAILABLE while
        # the batches in flight finish, so that the ledger closes clean
        self._draining = threading.Event()
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        # root and error spans, audit records and the API's transitions onto
        # the timeline; idempotent
        flight.install(apihealth=self.apihealth)

    # --- the fence and the drain, for both mutations ---

    def _check_epoch(self, epoch: int, method: str) -> None:
        """Refuse a stale epoch; take and persist a newer one."""
        epoch = int(epoch or 0)
        if epoch <= 0:
            return
        if self._draining.is_set():
            # after the drain closed the ledger, the drain's answer, not the
            # persist's LedgerError (gRPC still delivers calls in the stop's
            # grace)
            raise ServiceError("UNAVAILABLE", DRAINING)
        with self._epoch_lock:
            stored = self._node_epoch if epoch < self._node_epoch else None
            if stored is None:
                # the bump in memory fences this process at once; the ledger
                # writes only an epoch above its own, so a call with an epoch
                # whose write failed writes it again
                self._node_epoch = epoch
                if self.ledger is not None:
                    try:
                        self.ledger.record_epoch(epoch)
                    except Exception as exc:  # noqa: BLE001 — any failure to persist
                        # a restart would forget this epoch and take a stale
                        # master's write: no mutation until it is on disk
                        logger.warning("epoch %d not persisted: %s", epoch, exc)
                        raise ServiceError("UNAVAILABLE",
                                           f"epoch {epoch} not persisted: {exc}") from exc
        if stored is not None:
            FENCED_WRITES.inc()
            logger.warning("%s FENCED: stale epoch %d < %d (partitioned old shard owner?)",
                           method, epoch, stored)
            raise ServiceError("FAILED_PRECONDITION",
                               f"FENCED: stale epoch {epoch} < {stored}; this node is owned by "
                               f"a newer master — refresh shard routing")

    @contextlib.contextmanager
    def _mutation(self):
        """The drain's gate and the count of mutations in flight."""
        with self._inflight_cv:
            if self._draining.is_set():
                raise ServiceError("UNAVAILABLE", DRAINING)
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def drain(self, timeout_s: float = 20.0) -> bool:
        """Refuse new mutations, wait for those in flight, then close the
        ledger clean. Returns whether every one finished inside the timeout;
        if not, the ledger is left open, as after a death, and the next
        start's replay converges what they leave."""
        self._draining.set()
        deadline = time.monotonic() + timeout_s
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cv.wait(timeout=remaining)
            clean = self._inflight == 0
        if not clean:
            logger.error("drain timed out with %d mutation(s) in flight; the ledger will show "
                         "them open (as a crash: the replay converges them on restart)",
                         self._inflight)
        if self.ledger is not None and clean:
            self.ledger.close()
        return clean

    # --- CollectTelemetry (the fleet collector's pull) ---

    def collect_telemetry(self, request: api.CollectTelemetryRequest
                          ) -> api.CollectTelemetryResponse:
        """This worker's telemetry snapshot as one JSON payload
        (``obs.fleet.worker_telemetry_snapshot``): the mount-latency
        histogram with its exemplars, the counters, the device-access table
        (read, never swapped), the tenants' snapshots and the newest spans.
        The master's quarantine verdict rides the request: while it is set
        the node's warm holders are drained and their refill paused, and a
        failure of that toggle does not fail the answer. The reference's
        ``capacity`` section comes with the capacity plane."""
        from gpumounter_tpu_torch.obs.fleet import worker_telemetry_snapshot
        with trace.span("worker.CollectTelemetry", wire_parent=request.trace_context):
            failpoints.fire("worker.rpc", method="CollectTelemetry")
            if self.pool is not None and self.cfg.node_name:
                try:
                    self.pool.set_drained(self.cfg.node_name, bool(request.quarantined))
                except Exception:  # noqa: BLE001 — a side effect: never the answer
                    logger.exception("warm-pool drain toggle failed")
            return api.CollectTelemetryResponse(
                collect_telemetry_result=api.CollectTelemetryResult.Success,
                node_name=self.cfg.node_name or "",
                telemetry=json.dumps(worker_telemetry_snapshot(cfg=self.cfg)))

    # --- ProbeGPU (the health plane's canary read; no original analog) ---

    def _pod_devices_and_target(self, pod: Pod):
        """One collector refresh, the pod's GPUs (its slave pods' included)
        and its container's target; None for a container that is gone or
        restarting (the GPU-level facts are still reported, the checks inside
        the container are not)."""
        self.collector.update_status()
        slave_names = {s.name for s in self.allocator.slave_pods_for(pod)}
        devices = self.collector.get_pod_devices(pod.name, pod.namespace,
                                                 slave_pod_names=slave_names, refresh=False)
        try:
            target = self.mounter.resolve_target(pod)
        except MountError:
            target = None
        return devices, target

    def _holder_pids(self, target, dev) -> list[int]:
        if target is not None:
            return self.mounter.holder_pids(target, dev)
        return self.collector.backend.running_pids(dev)

    def probe_gpu(self, request: api.ProbeGPURequest) -> api.ProbeGPUResponse:
        """The health of every GPU the pod holds: the host's node stats as
        the same char device (``backend.probe_device``), the node injected
        into the target's /dev is still there (read in the target's mount
        namespace when it has one), and the /proc scan's holders. Read-only:
        what to do about a dead GPU is the master's to decide."""
        with trace.span("worker.ProbeGPU", wire_parent=request.trace_context,
                        pod=f"{request.namespace}/{request.pod_name}"):
            failpoints.fire("worker.rpc", method="ProbeGPU", pod=request.pod_name)
            try:
                pod = Pod(self.kube.get_pod(request.namespace, request.pod_name))
            except NotFoundError:
                return api.ProbeGPUResponse(api.ProbeGPUResult.PodNotFound)
            devices, target = self._pod_devices_and_target(pod)
            chips = []
            for dev in devices:
                healthy, reason = self.collector.backend.probe_device(dev)
                if healthy and target is not None and not nsutil.device_node_exists(
                        nsutil.device_node_path(target.dev_dir, dev), pid=target.ns_pid):
                    healthy = False
                    reason = "injected device node vanished from target /dev"
                chips.append(api.ChipHealth(uuid=dev.uuid, healthy=healthy, reason=reason,
                                            holder_count=len(self._holder_pids(target, dev))))
            return api.ProbeGPUResponse(api.ProbeGPUResult.Success, chips=chips)

    # --- QuiesceStatus (the migration machine's read-back; no original analog) ---

    def quiesce_status(self, request: api.QuiesceStatusRequest) -> api.QuiesceStatusResponse:
        """What the migration machine cannot see from the master: the
        tenant's ack annotation, and whether any process still holds the
        pod's GPUs. Read-only, as ``probe_gpu``."""
        with trace.span("worker.QuiesceStatus", wire_parent=request.trace_context,
                        pod=f"{request.namespace}/{request.pod_name}"):
            return self._quiesce_status_op(request)

    def _quiesce_status_op(self, request: api.QuiesceStatusRequest
                           ) -> api.QuiesceStatusResponse:
        failpoints.fire("worker.rpc", method="QuiesceStatus", pod=request.pod_name)
        try:
            pod = Pod(self.kube.get_pod(request.namespace, request.pod_name))
        except NotFoundError:
            return api.QuiesceStatusResponse(api.QuiesceStatusResult.PodNotFound)
        acked_id = acked_phase = ""
        raw = pod.annotations.get(ANNOT_MIGRATION_ACK)
        if raw:
            try:
                ack = json.loads(raw)
                if isinstance(ack, dict):
                    acked_id = str(ack.get("id", ""))
                    acked_phase = str(ack.get("phase", ""))
            except ValueError:
                logger.warning("unparseable %s annotation on %s/%s: %r", ANNOT_MIGRATION_ACK,
                               pod.namespace, pod.name, raw)
        devices, target = self._pod_devices_and_target(pod)
        holders: set[int] = set()
        for dev in devices:
            holders.update(self._holder_pids(target, dev))
        return api.QuiesceStatusResponse(api.QuiesceStatusResult.Success, acked_id=acked_id,
                                         acked_phase=acked_phase, holder_count=len(holders),
                                         chip_count=len(devices))

    # --- AddGPU (server.go:34-99) ---

    def add_gpu(self, request: AddGPURequest) -> AddGPUResponse:
        """The span joins the trace the client stamped on the wire, and
        every end (an answer, a refusal, a crash) leaves an audit record."""
        with trace.span("worker.AddGPU", wire_parent=request.trace_context,
                        pod=f"{request.namespace}/{request.pod_name}"), \
                audited("worker.AddGPU", actor="rpc", namespace=request.namespace,
                        pod=request.pod_name, idempotency_key=request.idempotency_key) as rec:
            response = self._add_gpu_op(request)
            rec["chips"] = list(response.uuids)
            rec["outcome"] = AddGPUResult(response.add_gpu_result).name
            return response

    def _add_gpu_op(self, request: AddGPURequest) -> AddGPUResponse:
        timer = PhaseTimer()
        failpoints.fire("worker.rpc", method="AddGPU", pod=request.pod_name)
        self._check_epoch(request.epoch, "AddGPU")
        logger.info("AddGPU %s/%s num=%d entire=%s", request.namespace,
                    request.pod_name, request.gpu_num, request.is_entire_mount)
        if request.gpu_num <= 0:
            raise ServiceError("INVALID_ARGUMENT", f"invalid gpu_num {request.gpu_num}")
        # "add:" and "rm:" keep a key reused across the two methods from
        # answering with the other's response. The record is read before
        # the pod: a completed call is answered even if the pod went since.
        key = f"add:{request.idempotency_key}" if request.idempotency_key else ""
        cached = self._idem.get(key)
        if cached is not None:
            return cached
        try:
            pod = Pod(self.kube.get_pod(request.namespace, request.pod_name))
        except NotFoundError:
            return AddGPUResponse(AddGPUResult.PodNotFound)
        with self._mutation(), self._pod_locks.held(pod.uid):
            # again under the pod's lock: a retry racing its first call
            # waits for it, then reads its answer
            cached = self._idem.get(key)
            if cached is not None:
                logger.info("AddGPU %s/%s replay of idempotency key %s",
                            request.namespace, request.pod_name, request.idempotency_key)
                return cached
            response = self._add_gpu_locked(request, pod, timer)
            if response.add_gpu_result == AddGPUResult.Success:
                self._idem.put(key, response)
            return response

    def _add_gpu_locked(self, request: AddGPURequest, pod: Pod,
                        timer: PhaseTimer) -> AddGPUResponse:
        mount_type = self.allocator.get_mount_type(pod)
        ok, why = self.mounter.can_mount(mount_type, request.is_entire_mount)
        if not ok:
            raise ServiceError("FAILED_PRECONDITION", why)
        per_pod = request.gpu_num if request.is_entire_mount else 1
        pool_stats: dict = {}
        with timer.phase("slave_pod_schedule"), \
                trace.span("mount.slave_pod_schedule", gpus=request.gpu_num):
            try:
                devices, slaves = self.allocator.get_available_gpus(
                    pod, request.gpu_num, per_pod, stats=pool_stats)
                # the warm pool's outcome on the span: pool starvation
                # (pool_gap > 0) against a plain scheduler wait
                trace.set_attrs(pool_hit=pool_stats.get("pool_hit", 0),
                                pool_gap=pool_stats.get("pool_gap", 0),
                                pool_enabled=pool_stats.get("pool_enabled", False))
            except InsufficientGpuError as exc:
                logger.warning("insufficient GPU: %s", exc)
                return AddGPUResponse(AddGPUResult.InsufficientGPU)
            except SlavePodError as exc:
                raise ServiceError("INTERNAL", str(exc)) from exc
        # On v2 our device program replaces the container's: it must keep
        # the GPUs the device plugin gave the pod itself.
        base_rules = [device_rule(d) for d in self.collector.snapshot()
                      if d.pod_name == pod.name and d.namespace == pod.namespace]
        try:
            with timer.phase("mount"):
                target = self.mounter.resolve_target(pod)
                self.mounter.mount_many(target, devices, base_rules=base_rules)
        except MountError as exc:
            # The mounter undid the batch; what is left is the scheduler's
            # books (server.go:86-91).
            logger.error("mount failed (batch rolled back), releasing %d slave "
                         "pod(s): %s", len(slaves), exc)
            self.allocator.delete_slave_pods(slaves, wait=False)
            self._post_event(pod, "GPUMountFailed", str(exc), "Warning")
            raise ServiceError("INTERNAL", str(exc)) from exc
        phases = timer.summary_ms()
        logger.info("AddGPU done: %s", phases)
        self._post_event(pod, "GPUMounted",
                         f"hot-mounted {len(devices)} GPU(s): "
                         f"{', '.join(d.uuid for d in devices)} (phases ms: {phases})")
        return AddGPUResponse(AddGPUResult.Success, uuids=[d.uuid for d in devices],
                              phases_ms=phases)

    # --- RemoveGPU (server.go:101-179) ---

    def remove_gpu(self, request: RemoveGPURequest) -> RemoveGPUResponse:
        """add_gpu's span and audit record, for the remove."""
        with trace.span("worker.RemoveGPU", wire_parent=request.trace_context,
                        pod=f"{request.namespace}/{request.pod_name}"), \
                audited("worker.RemoveGPU", actor="rpc", namespace=request.namespace,
                        pod=request.pod_name, chips=list(request.uuids),
                        idempotency_key=request.idempotency_key) as rec:
            response = self._remove_gpu_op(request)
            rec["outcome"] = RemoveGPUResult(response.remove_gpu_result).name
            return response

    def _remove_gpu_op(self, request: RemoveGPURequest) -> RemoveGPUResponse:
        timer = PhaseTimer()
        failpoints.fire("worker.rpc", method="RemoveGPU", pod=request.pod_name)
        self._check_epoch(request.epoch, "RemoveGPU")
        logger.info("RemoveGPU %s/%s uuids=%s force=%s", request.namespace,
                    request.pod_name, request.uuids, request.force)
        key = f"rm:{request.idempotency_key}" if request.idempotency_key else ""
        cached = self._idem.get(key)
        if cached is not None:
            return cached
        try:
            pod = Pod(self.kube.get_pod(request.namespace, request.pod_name))
        except NotFoundError:
            return RemoveGPUResponse(RemoveGPUResult.PodNotFound)
        with self._mutation(), self._pod_locks.held(pod.uid):
            cached = self._idem.get(key)
            if cached is not None:
                logger.info("RemoveGPU %s/%s replay of idempotency key %s",
                            request.namespace, request.pod_name, request.idempotency_key)
                return cached
            response = RemoveGPUResponse(self._remove_gpu_locked(request, pod, timer),
                                         phases_ms=timer.summary_ms())
            if response.remove_gpu_result == RemoveGPUResult.Success:
                self._idem.put(key, response)
            return response

    def _remove_gpu_locked(self, request: RemoveGPURequest, pod: Pod,
                           timer: PhaseTimer) -> RemoveGPUResult:
        self.collector.update_status()  # one refresh for the whole request
        entire = request.remove_all or \
            self.allocator.get_mount_type(pod, refresh=False) == MountType.ENTIRE
        devices = self.allocator.get_remove_gpus(pod, request.uuids, entire,
                                                 refresh=False)
        if not devices:
            return RemoveGPUResult.GPUNotFound
        try:
            target = self.mounter.resolve_target(pod)
        except MountError as exc:
            raise ServiceError("INTERNAL", str(exc)) from exc
        # The mounter checks every GPU for holders before touching any: no
        # partial removal of a busy request.
        try:
            with timer.phase("unmount"):
                self.mounter.unmount_many(target, devices, force=request.force)
        except GpuBusyError as exc:
            logger.warning("RemoveGPU %s/%s: %s", pod.namespace, pod.name, exc)
            return RemoveGPUResult.GPUBusy
        except MountError as exc:
            # Free what was unmounted before the failure: those GPUs are
            # revoked from the pod and must not stay booked.
            self._release_slaves_for(devices, exc.unmounted, pod)
            raise ServiceError("INTERNAL", str(exc)) from exc
        with timer.phase("slave_pod_release"):
            self._release_slaves_for(devices, devices, pod)
        self._post_event(pod, "GPUUnmounted",
                         f"hot-removed {len(devices)} GPU(s): "
                         f"{', '.join(d.uuid for d in devices)}"
                         + (" (forced)" if request.force else ""))
        return RemoveGPUResult.Success

    def _post_event(self, pod: Pod, reason: str, message: str,
                    event_type: str = "Normal") -> None:
        """An outcome as an Event on the target pod, where `kubectl describe
        pod` shows it; advisory, never raises."""
        post_pod_event(self.kube, pod, reason, message, event_type,
                       component="tpumounter-worker")

    def _release_slaves_for(self, requested: list, unmounted: list, pod: Pod | None = None
                            ) -> None:
        """Delete the slave pods whose every requested GPU was unmounted. A
        slave still holding a mounted GPU (a partial failure of an entire
        mount) keeps its booking: the container still has the GPU.

        The delete is tried cfg.slave_release_attempts times. With a ledger,
        the pods still standing go into its queue (a ``release`` record),
        retried until they are gone: by the next release, by
        ``retry_pending_releases`` and by the restart's replay. Without one
        they are counted as leaked, the pod gets a Warning Event, and the
        call raises."""
        if not unmounted:
            return
        self.probe_pending_releases()
        unmounted_keys = {d.uuid for d in unmounted}
        by_slave: dict[str, list] = {}
        for dev in requested:
            by_slave.setdefault(dev.pod_name, []).append(dev)
        releasable = sorted(slave for slave, devs in by_slave.items()
                            if all(d.uuid in unmounted_keys for d in devs))
        if not releasable:
            return
        attempts = max(1, int(self.cfg.slave_release_attempts))
        last_exc: Exception | None = None
        for attempt in range(1, attempts + 1):
            try:
                self.allocator.delete_slave_pods(releasable)
                return
            except Exception as exc:  # noqa: BLE001 — SlavePodError (the wait timed
                # out) and the API's failures alike leave the booking held
                last_exc = exc
                logger.warning("slave pod release attempt %d/%d failed: %s", attempt, attempts,
                               exc)
                if attempt < attempts:
                    time.sleep(min(0.1 * 2 ** (attempt - 1), 2.0))
        # count and name only what is still there: two of three deleted and
        # one stuck is one leak, not three
        leaked = []
        for name in releasable:
            try:
                self.kube.get_pod(self.cfg.pool_namespace, name)
                leaked.append(name)
            except NotFoundError:
                pass  # the delete landed; its wait timed out
            except Exception as exc:  # noqa: BLE001 — unverifiable: taken as leaked
                logger.debug("leak probe of %s inconclusive (%s); assuming leaked", name, exc)
                leaked.append(name)
        if not leaked:
            return
        if self.ledger is not None:
            rel_id = self.ledger.queue_release(self.cfg.pool_namespace, leaked)
            SLAVE_RELEASE_DEFERRED.inc(float(len(leaked)))
            logger.warning("slave pod release failed after %d attempt(s); %d booking(s) "
                           "deferred into the ledger retry queue as %s (%s): %s", attempts,
                           len(leaked), rel_id, ", ".join(leaked), last_exc)
            return
        SLAVE_RELEASE_FAILURES.inc(float(len(leaked)))
        logger.error("slave pod release failed after %d attempt(s); %d booking(s) stay "
                     "leaked until reaped: %s", attempts, len(leaked), last_exc)
        if pod is not None:
            self._post_event(pod, "GPUSlaveReleaseFailed",
                             f"could not release {len(leaked)} slave pod(s) "
                             f"({', '.join(leaked)}) after unmount: {last_exc}; their GPU "
                             f"bookings are leaked until deleted manually or reaped", "Warning")
        raise ServiceError("INTERNAL", f"GPUs unmounted, but slave pod(s) {leaked} not "
                           f"released: {last_exc}") from last_exc

    def probe_pending_releases(self) -> dict:
        """What each release does first: the releases deferred before it,
        every record while the write plane is healthy, else one (a doomed
        delete costs a client timeout, and one a record in every unmount
        would grow with the outage). ``retry_pending_releases``' summary."""
        if self.apihealth.write_plane_ok():
            return self.retry_pending_releases()
        return self.retry_pending_releases(limit=1)

    def retry_pending_releases(self, limit: int | None = None) -> dict:
        """Drive the ledger's queue of deferred releases: delete every pod
        still standing of each pending record, and close a record
        (release_done) once all its pods are gone. Safe at any time: a
        delete is idempotent and a pod already gone counts as released.
        `limit` bounds the records tried. Returns {"completed": n,
        "pending": m}."""
        if self.ledger is None:
            return {"completed": 0, "pending": 0}
        pending = self.ledger.pending_releases()
        total = len(pending)
        if limit is not None:
            pending = pending[:max(0, limit)]
        completed = 0
        for record in pending:
            namespace = record.get("namespace", self.cfg.pool_namespace)
            remaining = []
            for name in record.get("pods", []):
                try:
                    # the delete of a missing pod is a no-op: here, the pod is gone
                    self.kube.delete_pod(namespace, name, grace_period_seconds=0)
                except Exception as exc:  # noqa: BLE001 — still failing
                    remaining.append(name)
                    logger.info("deferred release of %s still failing: %s", name, exc)
            if not remaining:
                self.ledger.complete_release(record.get("rel", ""))
                completed += 1
                logger.info("deferred slave release %s completed (%s)", record.get("rel"),
                            ", ".join(record.get("pods", [])))
        return {"completed": completed, "pending": total - completed}


# --- the gRPC transport ---

def _bearer_interceptor(token: str):
    """An interceptor that refuses every mount call without
    `authorization: Bearer <secret>` metadata (UNAUTHENTICATED); the health
    service stays open. Built inside a function: a subclass of
    grpc.ServerInterceptor at module top would import grpc with the module."""

    def _deny(request, context):
        context.abort(grpc.StatusCode.UNAUTHENTICATED,
                      "missing or invalid bearer token (authorization metadata)")

    deny_handler = grpc.unary_unary_rpc_method_handler(
        _deny, request_deserializer=lambda b: b, response_serializer=lambda m: m)

    class _BearerTokenInterceptor(grpc.ServerInterceptor):
        def intercept_service(self, continuation, handler_call_details):
            if handler_call_details.method.startswith("/grpc.health."):
                return continuation(handler_call_details)
            meta = dict(handler_call_details.invocation_metadata or ())
            if check_bearer(meta.get("authorization"), token):
                return continuation(handler_call_details)
            logger.warning("unauthenticated %s refused", handler_call_details.method)
            return deny_handler

    return _BearerTokenInterceptor()


def _aborting(method):
    """The service's method as a gRPC handler: a ServiceError aborts the
    call with its code and message."""

    def handler(request, context):
        try:
            return method(request)
        except ServiceError as exc:
            context.abort(getattr(grpc.StatusCode, exc.code), exc.message)

    return handler


def build_server(service: GpuMountService, port: int | None = None,
                 address: str | None = None, max_workers: int = 8,
                 include_telemetry: bool = True):
    """A gRPC server (not started) with the service under the original's
    names, the telemetry service, the health service, and, unless
    TPUMOUNTER_AUTH=insecure, the bearer interceptor: with no secret
    configured this raises AuthConfigError (fail-closed). Binds `address`,
    else [::]:`port`, else [::]:WORKER_PORT; the bound port is
    `server.bound_port` (for ":0"). include_telemetry=False builds a
    worker without CollectTelemetry (as the original's), which answers it
    UNIMPLEMENTED: the fleet collector then scrapes its /metrics."""
    token = required_token(service.cfg, "worker gRPC server")
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         interceptors=[_bearer_interceptor(token)] if token else [])

    def _handler(method, request_cls):
        return grpc.unary_unary_rpc_method_handler(
            _aborting(method), request_deserializer=request_cls.decode,
            response_serializer=lambda m: m.encode())

    registrations = {
        api.ADD_SERVICE: {api.ADD_METHOD: _handler(service.add_gpu, AddGPURequest)},
        api.REMOVE_SERVICE: {api.REMOVE_METHOD: _handler(service.remove_gpu,
                                                         RemoveGPURequest)},
    }
    registrations[api.PROBE_SERVICE] = {api.PROBE_METHOD: _handler(service.probe_gpu,
                                                                   api.ProbeGPURequest)}
    registrations[api.QUIESCE_SERVICE] = {api.QUIESCE_METHOD: _handler(
        service.quiesce_status, api.QuiesceStatusRequest)}
    if include_telemetry:
        registrations[api.TELEMETRY_SERVICE] = {api.TELEMETRY_METHOD: _handler(
            service.collect_telemetry, api.CollectTelemetryRequest)}
    for name, methods in registrations.items():
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(name, methods),))
    from gpumounter_tpu_torch.rpc.health import add_health_service
    add_health_service(server, known_services=set(registrations) | {""})
    server.bound_port = server.add_insecure_port(
        address or f"[::]:{service.cfg.worker_port if port is None else port}")
    return server
