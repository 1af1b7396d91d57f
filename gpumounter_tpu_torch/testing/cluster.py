"""FakeCluster: one GPU node, end to end, in one process.

The counterpart of ``gpumounter_tpu/testing/cluster.py`` for one node. It
wires together:

  * a device backend: a ``FakeDeviceBackend`` (fake nodes in a directory)
    for tests, or the live ``NvidiaDeviceBackend`` on a GPU host;
  * an ``InMemoryKubelet`` that answers pod-resources List;
  * a ``FakeKubeClient`` whose scheduler hook plays the scheduler and the
    NVIDIA device plugin: a pod requesting ``nvidia.com/gpu`` gets free GPUs
    of the backend's inventory, by UUID in NVML index order, its claim
    lands in the kubelet, and it runs; when too few are free it stays
    Pending-Unschedulable, the signal the allocator maps to
    InsufficientGPU (allocator.go:262-270). Deleting the pod frees them.

A target pod has no container behind it: ``DirTargetMounter`` mounts into a
directory that stands for the container's /dev, in the mount namespace of
``ns_pid`` when given, granting on ``cgroup_dirs`` when given.
"""

from __future__ import annotations

import dataclasses
import os
import threading

from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.collector.podresources import InMemoryKubelet
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import DeviceBackend, FakeDeviceBackend
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountTarget
from gpumounter_tpu_torch.worker.server import GpuMountService


class DirTargetMounter(GpuMounter):
    """A mounter whose every target pod is one directory."""

    def __init__(self, backend: DeviceBackend, dev_dir: str, cfg=None,
                 ns_pid: int | None = None, cgroup_dirs=()):
        super().__init__(backend, cfg=cfg)
        self.dev_dir = dev_dir
        self.ns_pid = ns_pid
        self.cgroup_dirs = list(cgroup_dirs)

    def resolve_target(self, pod: Pod) -> MountTarget:
        return MountTarget(dev_dir=self.dev_dir, cgroup_dirs=list(self.cgroup_dirs),
                           ns_pid=self.ns_pid, description=f"{pod.namespace}/{pod.name}",
                           pod=pod)


class FakeCluster:
    def __init__(self, backend: DeviceBackend, node_name: str = "gpu-node-0",
                 scheduler_delay_s: float = 0.0, cfg: Config | None = None):
        self.backend = backend
        self.node_name = node_name
        self.cfg = dataclasses.replace(cfg or Config(), slave_pod_timeout_s=10.0)
        self.kubelet = InMemoryKubelet()
        self._alloc_lock = threading.Lock()
        # GPU UUID (the device plugin's device ID) -> (namespace, pod) or None
        self.assignment: dict[str, tuple[str, str] | None] = {
            d.uuid: None for d in backend.list_devices()}
        self.kube = FakeKubeClient(scheduler_hook=self._schedule, delete_hook=self._reap,
                                   scheduler_delay_s=scheduler_delay_s)

    @classmethod
    def with_fake_gpus(cls, root: str, n_gpus: int = 4, **kwargs) -> "FakeCluster":
        """A node of `n_gpus` fake GPUs under <root>/host-dev."""
        return cls(FakeDeviceBackend.create(os.path.join(root, "host-dev"), n_gpus),
                   **kwargs)

    # --- the scheduler and the device plugin ---

    def _free_ids(self) -> list[str]:
        return [uuid for uuid, owner in self.assignment.items() if owner is None]

    def _schedule(self, pod: dict) -> None:
        p = Pod(pod)
        want = p.resource_limit(self.cfg.gpu_resource_name)
        selector = (pod.get("spec", {}).get("nodeSelector") or {}).get(
            "kubernetes.io/hostname")
        if want == 0:
            pod.setdefault("spec", {}).setdefault("nodeName", selector or self.node_name)
            pod.setdefault("status", {})["phase"] = "Running"
            return
        with self._alloc_lock:
            free = self._free_ids()
            if (selector and selector != self.node_name) or len(free) < want:
                pod.setdefault("status", {}).update({
                    "phase": "Pending",
                    "conditions": [{
                        "type": "PodScheduled", "status": "False",
                        "reason": "Unschedulable",
                        "message": f"0/1 nodes available: insufficient "
                                   f"{self.cfg.gpu_resource_name}"}]})
                return
            assigned = free[:want]
            for uuid in assigned:
                self.assignment[uuid] = (p.namespace, p.name)
            self.kubelet.set_claim(p.name, p.namespace, self.cfg.gpu_resource_name,
                                   assigned)
        pod.setdefault("spec", {})["nodeName"] = self.node_name
        pod.setdefault("status", {})["phase"] = "Running"

    def _reap(self, pod: dict) -> None:
        p = Pod(pod)
        with self._alloc_lock:
            for uuid, owner in self.assignment.items():
                if owner == (p.namespace, p.name):
                    self.assignment[uuid] = None
            self.kubelet.drop_pod(p.name, p.namespace)

    # --- convenience ---

    def free_gpu_count(self) -> int:
        with self._alloc_lock:
            return len(self._free_ids())

    def add_target_pod(self, name: str, namespace: str = "default") -> Pod:
        """A running workload pod (no GPU request) to hot-mount into."""
        self.kube.create_pod(namespace, {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {"containers": [{"name": "main", "image": "app"}]}})
        self.kube.set_pod_status(namespace, name, containerStatuses=[{
            "name": "main", "containerID": f"containerd://{name}-cid",
            "state": {"running": {}}}])
        pod = self.kube.wait_for_pod(
            namespace, name, lambda pj: pj is not None and Pod(pj).phase == "Running",
            timeout_s=5.0)
        if pod is None:
            raise RuntimeError(f"target pod {namespace}/{name} did not reach Running")
        return Pod(self.kube.get_pod(namespace, name))

    def service(self, dev_dir: str, ns_pid: int | None = None, cgroup_dirs=(),
                ) -> GpuMountService:
        """The worker's service for this node, mounting into `dev_dir`."""
        collector = GpuCollector(self.backend, self.kubelet, cfg=self.cfg)
        mounter = DirTargetMounter(self.backend, dev_dir, cfg=self.cfg, ns_pid=ns_pid,
                                   cgroup_dirs=cgroup_dirs)
        return GpuMountService(self.kube, collector, mounter=mounter, cfg=self.cfg)
