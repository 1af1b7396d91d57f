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

Each pod's flows are serialized (keyed by UID), so two entire mounts of one
pod cannot both pass the gate. A refused call raises ``ServiceError`` with
its gRPC status code. A call that carries an idempotency key and succeeded
is remembered: the same key again is answered from the first call's
response and mounts or unmounts nothing (the client's retries depend on it).

``build_server`` serves the service over gRPC (the counterpart of the
reference's ``build_server``, ``worker/server.py:854-954``): the original's
``gpu_mount.AddGPUService/AddGPU`` and ``gpu_mount.RemoveGPUService/RemoveGPU``,
the health service, and the bearer-token interceptor; a ``ServiceError``
becomes an abort with its code. grpc is imported there, on first use
(``utils/lazy_grpc.py``), never when this module is.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent import futures

from gpumounter_tpu_torch.allocator.allocator import (
    GpuAllocator,
    InsufficientGpuError,
    MountType,
    SlavePodError,
)
from gpumounter_tpu_torch.cgroup.ebpf import device_rule
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient, NotFoundError
from gpumounter_tpu_torch.k8s.types import Pod
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
from gpumounter_tpu_torch.worker.mounter import GpuBusyError, GpuMounter, MountError

logger = get_logger("worker.server")

SLAVE_RELEASE_FAILURES = REGISTRY.counter(
    "tpumounter_slave_release_failures_total",
    "Slave-pod releases that exhausted their bounded retry — leaked "
    "capacity until the reaper or the recovery plane sweeps it")


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
                 mounter: GpuMounter | None = None, cfg=None):
        self.cfg = cfg or Config()
        self.kube = kube
        self.collector = collector
        self.allocator = allocator or GpuAllocator(kube, collector, cfg=self.cfg)
        self.mounter = mounter or GpuMounter(collector.backend, cfg=self.cfg)
        self._pod_locks = _KeyedLocks()
        self._idem = _IdempotencyCache()

    # --- AddGPU (server.go:34-99) ---

    def add_gpu(self, request: AddGPURequest) -> AddGPUResponse:
        timer = PhaseTimer()
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
        with self._pod_locks.held(pod.uid):
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
        with timer.phase("slave_pod_schedule"):
            try:
                devices, slaves = self.allocator.get_available_gpus(
                    pod, request.gpu_num, per_pod)
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
            raise ServiceError("INTERNAL", str(exc)) from exc
        phases = timer.summary_ms()
        logger.info("AddGPU done: %s", phases)
        return AddGPUResponse(AddGPUResult.Success, uuids=[d.uuid for d in devices],
                              phases_ms=phases)

    # --- RemoveGPU (server.go:101-179) ---

    def remove_gpu(self, request: RemoveGPURequest) -> RemoveGPUResponse:
        timer = PhaseTimer()
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
        with self._pod_locks.held(pod.uid):
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
            self._release_slaves_for(devices, exc.unmounted)
            raise ServiceError("INTERNAL", str(exc)) from exc
        with timer.phase("slave_pod_release"):
            self._release_slaves_for(devices, devices)
        return RemoveGPUResult.Success

    def _release_slaves_for(self, requested: list, unmounted: list) -> None:
        """Delete the slave pods whose every requested GPU was unmounted. A
        slave still holding a mounted GPU (a partial failure of an entire
        mount) keeps its booking: the container still has the GPU. A
        deletion that fails raises: the booking would otherwise leak."""
        unmounted_keys = {d.uuid for d in unmounted}
        by_slave: dict[str, list] = {}
        for dev in requested:
            by_slave.setdefault(dev.pod_name, []).append(dev)
        releasable = sorted(slave for slave, devs in by_slave.items()
                            if all(d.uuid in unmounted_keys for d in devs))
        if not releasable:
            return
        try:
            self.allocator.delete_slave_pods(releasable)
        except Exception as exc:
            SLAVE_RELEASE_FAILURES.inc(float(len(releasable)))
            raise ServiceError("INTERNAL", f"GPUs unmounted, but slave pod(s) "
                               f"{releasable} not released: {exc}") from exc


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
                 address: str | None = None, max_workers: int = 8):
    """A gRPC server (not started) with the service under the original's
    names, the health service, and, unless TPUMOUNTER_AUTH=insecure, the
    bearer interceptor: with no secret configured this raises
    AuthConfigError (fail-closed). Binds `address`, else [::]:`port`, else
    [::]:WORKER_PORT; the bound port is `server.bound_port` (for ":0")."""
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
    for name, methods in registrations.items():
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(name, methods),))
    from gpumounter_tpu_torch.rpc.health import add_health_service
    add_health_service(server, known_services=set(registrations) | {""})
    server.bound_port = server.add_insecure_port(
        address or f"[::]:{service.cfg.worker_port if port is None else port}")
    return server
