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
    unless forced (:137-153) -> unmount each -> release the slave pods
    whose GPUs are all unmounted (:155-175).

Each pod's flows are serialized (keyed by UID), so two entire mounts of one
pod cannot both pass the gate. Where the gRPC service aborts a call, this
one raises ``ServiceError`` with the status code the transport will send.
"""

from __future__ import annotations

import contextlib
import threading

from gpumounter_tpu_torch.allocator.allocator import (
    GpuAllocator,
    InsufficientGpuError,
    MountType,
    SlavePodError,
)
from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.k8s.client import KubeClient, NotFoundError
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.rpc.api import (
    AddGPURequest,
    AddGPUResponse,
    AddGPUResult,
    RemoveGPURequest,
    RemoveGPUResponse,
    RemoveGPUResult,
)
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.timing import PhaseTimer
from gpumounter_tpu_torch.worker.mounter import GpuBusyError, GpuMounter, MountError

logger = get_logger("worker.server")


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

    # --- AddGPU (server.go:34-99) ---

    def add_gpu(self, request: AddGPURequest) -> AddGPUResponse:
        timer = PhaseTimer()
        logger.info("AddGPU %s/%s num=%d entire=%s", request.namespace,
                    request.pod_name, request.gpu_num, request.is_entire_mount)
        if request.gpu_num <= 0:
            raise ServiceError("INVALID_ARGUMENT", f"invalid gpu_num {request.gpu_num}")
        try:
            pod = Pod(self.kube.get_pod(request.namespace, request.pod_name))
        except NotFoundError:
            return AddGPUResponse(AddGPUResult.PodNotFound)
        with self._pod_locks.held(pod.uid):
            return self._add_gpu_locked(request, pod, timer)

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
        try:
            with timer.phase("mount"):
                target = self.mounter.resolve_target(pod)
                self.mounter.mount_many(target, devices)
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
        try:
            pod = Pod(self.kube.get_pod(request.namespace, request.pod_name))
        except NotFoundError:
            return RemoveGPUResponse(RemoveGPUResult.PodNotFound)
        with self._pod_locks.held(pod.uid):
            result = self._remove_gpu_locked(request, pod, timer)
        return RemoveGPUResponse(result, phases_ms=timer.summary_ms())

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
        # Busy check across every GPU before touching any: no partial removal.
        if not request.force:
            for dev in devices:
                holders = self.mounter.holder_pids(target, dev)
                if holders:
                    logger.warning("%s busy (PIDs %s)", dev.uuid, holders)
                    return RemoveGPUResult.GPUBusy
        unmounted: list = []
        try:
            with timer.phase("unmount"):
                for dev in devices:
                    self.mounter.unmount(target, dev, force=request.force)
                    unmounted.append(dev)
        except GpuBusyError:
            # Free what was unmounted before the busy GPU: those GPUs are
            # revoked from the pod and must not stay booked.
            self._release_slaves_for(devices, unmounted)
            return RemoveGPUResult.GPUBusy
        except MountError as exc:
            self._release_slaves_for(devices, unmounted)
            raise ServiceError("INTERNAL", str(exc)) from exc
        with timer.phase("slave_pod_release"):
            self._release_slaves_for(devices, unmounted)
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
            raise ServiceError("INTERNAL", f"GPUs unmounted, but slave pod(s) "
                               f"{releasable} not released: {exc}") from exc
