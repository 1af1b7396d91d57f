"""Scheduler coherence: placeholder ("slave") pods hold GPUs in the
Kubernetes scheduler's books while the GPUs are injected into the target.

The counterpart of ``TpuAllocator`` in
``gpumounter_tpu/allocator/allocator.py``, and of the original's
``pkg/util/gpu/allocator/allocator.go``:

  * a slave pod is a sleep loop in the pool namespace that requests
    ``nvidia.com/gpu``, pinned to the owner's node (newGPUSlavePod,
    :189-234);
  * ``get_available_gpus``: create the slaves, wait until they run, map
    Unschedulable to InsufficientGPU, roll back on failure, then read the
    slaves' GPUs from the collector (GetAvailableGPU, :40-96);
  * ``get_remove_gpus``: the pod's slave-held GPUs matching the UUIDs; an
    entire mount removes all; any unmatched UUID gives none (GetRemoveGPU,
    :101-125);
  * ``delete_slave_pods`` and the wait for deletion (:128-156);
  * ``get_mount_type``: entire iff fewer slave pods than GPUs (:158-187).

Waits are watches with a deadline, run concurrently, where the original
busy-polls the phase (:246-317). With a warm pool (``allocator/pool.py``) a
single-GPU allocation adopts pre-scheduled holders first, and only the cold
remainder pays the create-and-wait. The reference's choice among free
accelerators for an ICI-contiguous block is not ported: on an H100 host
every pair of GPUs is one NVSwitch hop apart (``topology.py``), so no free
GPU is a better pick than another.
"""

from __future__ import annotations

import enum
import secrets
import threading

from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.k8s.client import KubeClient, NotFoundError
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.utils.locks import OrderedLock
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("allocator")

#: the NoSchedule taint GKE and the NVIDIA GPU operator put on GPU nodes.
GPU_TAINT_KEY = "nvidia.com/gpu"


class MountType(enum.Enum):
    # MountType strings (pkg/util/gpu/types.go:21-28)
    ENTIRE = "entire-mount"
    SINGLE = "single-mount"
    NONE = "no-mount"
    UNKNOWN = "unknown-mount"


class SlavePodError(RuntimeError):
    pass


class InsufficientGpuError(SlavePodError):
    """The scheduler cannot place the slave pods: not enough free GPUs."""


def base_slave_manifest(cfg, name: str, node_name: str, gpu_num: int,
                        labels: dict, annotations: dict | None = None,
                        ) -> dict:
    """The placeholder pod: a sleep loop requesting ``gpu_num`` of
    ``cfg.gpu_resource_name``, pinned to ``node_name``, tolerating the GPU
    nodes' NoSchedule taint."""
    meta: dict = {"name": name, "namespace": cfg.pool_namespace,
                  "labels": labels}
    if annotations:
        meta["annotations"] = annotations
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": {
            "nodeSelector": {"kubernetes.io/hostname": node_name},
            "restartPolicy": "Never",
            "containers": [{
                "name": "placeholder",
                "image": cfg.slave_pod_image,
                "command": ["sleep", "infinity"],
                "resources": {
                    "limits": {cfg.gpu_resource_name: str(gpu_num)},
                    "requests": {cfg.gpu_resource_name: str(gpu_num)},
                },
            }],
            "tolerations": [{"key": GPU_TAINT_KEY,
                             "operator": "Exists",
                             "effect": "NoSchedule"}],
        },
    }


class GpuAllocator:
    def __init__(self, kube: KubeClient, collector: GpuCollector, cfg=None, pool=None):
        """pool: an optional ``WarmPodPool``, from which single-GPU slaves
        are adopted before any is created."""
        self.kube = kube
        self.collector = collector
        self.cfg = cfg or Config()
        self.pool = pool
        # Serializes slave-pod allocation on this node: two requests that
        # together exceed capacity would otherwise both create slaves, both
        # see Unschedulable and both roll back; serialized, the first wins
        # and the second gets a clean InsufficientGPU.
        self._alloc_mutex = OrderedLock("allocator.alloc")

    def _slave_pod_manifest(self, owner: Pod, gpu_num: int) -> dict:
        # Pod names may be 253 characters: room for the suffix and hex.
        base = owner.name[:200]
        name = f"{base}{self.cfg.slave_pod_name_suffix}{secrets.token_hex(3)}"
        # Ownership lives in labels, not OwnerReferences: slaves sit in the
        # pool namespace and owners elsewhere, and the garbage collector
        # deletes a dependent whose owner is not in its own namespace. The
        # owner's UID is the key (always label-legal); names may pass the
        # 63-character label cap, so they are also kept whole in annotations.
        return base_slave_manifest(
            self.cfg, name, owner.node_name, gpu_num,
            labels={"app": "gpu-pool",
                    "tpumounter.io/owner-uid": owner.uid,
                    "tpumounter.io/owner": owner.name[:63],
                    "tpumounter.io/owner-namespace": owner.namespace[:63]},
            annotations={"tpumounter.io/owner": owner.name,
                         "tpumounter.io/owner-namespace": owner.namespace})

    # --- allocation (GetAvailableGPU, allocator.go:40-96) ---

    def get_available_gpus(self, owner: Pod, total_gpu_num: int,
                           gpu_num_per_pod: int, stats: dict | None = None,
                           ) -> tuple[list[GpuDevice], list[str]]:
        """Adopt warm holders or create slave pods; returns (devices,
        slave_pod_names).

        total_gpu_num must be divisible by gpu_num_per_pod (an entire mount
        is one slave holding all; a single mount one slave per GPU,
        server.go:61-66). `stats`, when given, is filled with the warm
        pool's outcome: pool_hit (slaves adopted warm), pool_gap (slaves
        that paid the cold path) and pool_enabled, so that the caller's span
        tells pool starvation from a plain scheduler wait."""
        if total_gpu_num <= 0 or total_gpu_num % gpu_num_per_pod != 0:
            raise ValueError(f"total_gpu_num={total_gpu_num} not divisible by "
                             f"gpu_num_per_pod={gpu_num_per_pod}")
        if not owner.node_name:
            raise SlavePodError(f"owner pod {owner.namespace}/{owner.name} is not scheduled")
        with self._alloc_mutex:
            return self._allocate_locked(owner, gpu_num_per_pod,
                                         total_gpu_num // gpu_num_per_pod, stats)

    def _allocate_locked(self, owner: Pod, gpu_num_per_pod: int, n_pods: int,
                         stats: dict | None = None,
                         ) -> tuple[list[GpuDevice], list[str]]:
        # the warm fast path, for single-GPU slaves only (the pool stocks no
        # pod holding several): adopted holders already run, so only the
        # cold remainder waits for the scheduler
        adopted: list[str] = []
        if self.pool is not None and gpu_num_per_pod == 1:
            adopted = self.pool.acquire(owner, n_pods)
        if stats is not None:
            stats["pool_enabled"] = (self.pool is not None and gpu_num_per_pod == 1
                                     and self.pool.enabled)
            stats["pool_hit"] = len(adopted)
            stats["pool_gap"] = n_pods - len(adopted)
        created: list[str] = list(adopted)
        try:
            cold: list[str] = []
            for _ in range(n_pods - len(adopted)):
                manifest = self._slave_pod_manifest(owner, gpu_num_per_pod)
                cold.append(Pod(self.kube.create_pod(self.cfg.pool_namespace,
                                                     manifest)).name)
                created.append(cold[-1])
            self._wait_all_running(cold)
            # One kubelet refresh for the whole batch, then per-slave reads.
            self.collector.update_status()
            devices: list[GpuDevice] = []
            for name in created:
                devs = self.collector.get_slave_pod_devices(name, refresh=False)
                if len(devs) != gpu_num_per_pod:
                    raise SlavePodError(
                        f"slave pod {name} reports {len(devs)} GPU(s), expected "
                        f"{gpu_num_per_pod} (device plugin lag?)")
                devices.extend(devs)
        except Exception:
            # adopted holders carry the owner's labels now: they roll back
            # too, which frees their GPUs (the pool refills itself)
            self._rollback(created)
            raise
        logger.info("allocated %d GPU(s) via %d slave pod(s) for %s/%s",
                    len(devices), n_pods, owner.namespace, owner.name)
        return devices, created

    def _wait_all_running(self, names: list[str]) -> None:
        errors: dict[str, Exception] = {}

        def _wait(name: str) -> None:
            def pred(pod_json):
                if pod_json is None:
                    raise SlavePodError(f"slave pod {name} deleted while waiting")
                p = Pod(pod_json)
                if p.phase == "Running":
                    return True
                reason = p.unschedulable_reason()
                if reason:
                    raise InsufficientGpuError(f"slave pod {name} unschedulable: {reason}")
                if p.phase in ("Failed", "Succeeded"):
                    raise SlavePodError(f"slave pod {name} entered phase {p.phase}")
                return False
            try:
                if self.kube.wait_for_pod(self.cfg.pool_namespace, name, pred,
                                          timeout_s=self.cfg.slave_pod_timeout_s) is None:
                    raise SlavePodError(f"slave pod {name} not Running within "
                                        f"{self.cfg.slave_pod_timeout_s}s")
            except Exception as exc:  # noqa: BLE001 — gathered per pod, raised below
                errors[name] = exc

        threads = [threading.Thread(target=_wait, args=(n,), daemon=True) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            insufficient = [e for e in errors.values() if isinstance(e, InsufficientGpuError)]
            raise insufficient[0] if insufficient else next(iter(errors.values()))

    def _rollback(self, names: list[str]) -> None:
        # Rollback on InsufficientGPU / FailedCreated (allocator.go:65-82)
        if names:
            logger.warning("rolling back %d slave pod(s)", len(names))
        self.delete_slave_pods(names, wait=False)

    # --- removal planning (GetRemoveGPU, allocator.go:101-125) ---

    def get_remove_gpus(self, pod: Pod, uuids: list[str], entire_mount: bool,
                        refresh: bool = True) -> list[GpuDevice]:
        """Slave-held devices of `pod` matching `uuids`; all of them for an
        entire mount. Any UUID that matches no slave-held device gives []
        (the worker answers GPUNotFound, server.go:130-135)."""
        slave_names = {p.name for p in self.slave_pods_for(pod)}
        devices = self.collector.get_pod_devices(pod.name, pod.namespace,
                                                 slave_names, refresh=refresh)
        slave_owned = [d for d in devices if d.pod_name in slave_names]
        if entire_mount:
            return slave_owned
        by_uuid = {d.uuid: d for d in slave_owned}
        out = []
        for uuid in uuids:
            dev = by_uuid.get(uuid)
            if dev is None:
                logger.warning("uuid %s not slave-held by %s/%s",
                               uuid, pod.namespace, pod.name)
                return []
            out.append(dev)
        return out

    # --- slave pod deletion (DeleteSlavePods, allocator.go:128-156) ---

    def delete_slave_pods(self, names: list[str], wait: bool = True) -> None:
        for name in names:
            try:
                self.kube.delete_pod(self.cfg.pool_namespace, name,
                                     grace_period_seconds=0)
            except NotFoundError:
                pass
        if wait:
            for name in names:
                gone = self.kube.wait_for_pod(self.cfg.pool_namespace, name,
                                              lambda pod_json: pod_json is None,
                                              timeout_s=self.cfg.slave_pod_timeout_s)
                if gone is None:
                    raise SlavePodError(f"slave pod {name} not deleted within "
                                        f"{self.cfg.slave_pod_timeout_s}s")
        if names and self.pool is not None:
            # their GPUs are free again: a full node's refill backoff ends
            self.pool.capacity_freed()

    def slave_pods_for(self, pod: Pod) -> list[Pod]:
        """Slave pods owned by this pod, by the owner-UID label (the
        original matches a name prefix, collector.go:156-161, which mixes
        up same-named pods of two namespaces)."""
        if pod.uid:
            selector = f"tpumounter.io/owner-uid={pod.uid}"
        else:
            selector = (f"tpumounter.io/owner={pod.name[:63]},"
                        f"tpumounter.io/owner-namespace={pod.namespace[:63]}")
        return [Pod(p) for p in self.kube.list_pods(self.cfg.pool_namespace,
                                                    label_selector=selector)]

    # --- mount type (GetMountType, allocator.go:158-187) ---

    def get_mount_type(self, pod: Pod, refresh: bool = True) -> MountType:
        slaves = self.slave_pods_for(pod)
        if not slaves:
            return MountType.NONE
        slave_names = {p.name for p in slaves}
        devices = self.collector.get_pod_devices(pod.name, pod.namespace,
                                                 slave_names, refresh=refresh)
        slave_held = [d for d in devices if d.namespace == self.cfg.pool_namespace]
        if not slave_held:
            return MountType.UNKNOWN
        if len(slaves) < len(slave_held):
            return MountType.ENTIRE
        if len(slaves) == len(slave_held):
            return MountType.SINGLE
        return MountType.UNKNOWN
