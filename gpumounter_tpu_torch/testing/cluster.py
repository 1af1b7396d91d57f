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

For the transport (``tests/test_master.py:24-90`` of the reference):

  * ``serve_kubelet`` serves the kubelet's claims over a real gRPC socket
    (``FakeKubeletServer``), and ``service(..., kubelet="grpc")`` gives the
    collector a ``PodResourcesClient`` on it in place of the in-memory one;
  * ``register_worker`` creates the worker pod the way the DaemonSet would,
    so the master's registry finds the node's worker;
  * ``LoopbackWorkerClient`` reaches a ``GpuMountService`` without grpc, for
    hosts that have none (the card's machine): each call goes through the
    wire codec both ways, and a refused call raises as ``WorkerClient``
    raises it. The master uses it only where a caller passes it.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading

from gpumounter_tpu_torch.collector.collector import GpuCollector
from gpumounter_tpu_torch.collector.podresources import (
    FakeKubeletServer,
    InMemoryKubelet,
    PodResourcesClient,
)
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import DeviceBackend, FakeDeviceBackend
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.rpc import api
from gpumounter_tpu_torch.rpc.resilience import RpcCallError
from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountTarget
from gpumounter_tpu_torch.worker.server import GpuMountService, ServiceError


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
        self._kubelet_server: FakeKubeletServer | None = None
        self._kubelet_dir: str | None = None
        self._kubelet_clients: list[PodResourcesClient] = []

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
                kubelet: str = "memory") -> GpuMountService:
        """The worker's service for this node, mounting into `dev_dir`. Its
        collector reads the kubelet in memory ("memory"), or over gRPC on
        the socket of ``serve_kubelet`` ("grpc")."""
        if kubelet == "grpc":
            podresources = PodResourcesClient(self.serve_kubelet().socket_path, timeout_s=5.0)
            self._kubelet_clients.append(podresources)
        elif kubelet == "memory":
            podresources = self.kubelet
        else:
            raise ValueError(f"kubelet {kubelet!r}: 'memory' or 'grpc'")
        collector = GpuCollector(self.backend, podresources, cfg=self.cfg)
        mounter = DirTargetMounter(self.backend, dev_dir, cfg=self.cfg, ns_pid=ns_pid,
                                   cgroup_dirs=cgroup_dirs)
        return GpuMountService(self.kube, collector, mounter=mounter, cfg=self.cfg)

    # --- the transport ---

    def serve_kubelet(self) -> FakeKubeletServer:
        """The kubelet's pod-resources API (v1) over gRPC on a unix socket in
        a new temporary directory, serving this node's claims; started once,
        stopped by ``stop``."""
        if self._kubelet_server is None:
            self._kubelet_dir = tempfile.mkdtemp(prefix="kubelet-")
            self._kubelet_server = FakeKubeletServer(
                os.path.join(self._kubelet_dir, "kubelet.sock"), kubelet=self.kubelet).start()
        return self._kubelet_server

    def register_worker(self, ip: str = "127.0.0.1") -> dict:
        """The node's worker pod, as the DaemonSet would create it: in
        WORKER_NAMESPACE, labelled WORKER_LABEL_SELECTOR, on this node, at
        `ip`. The master dials it at `ip`:WORKER_PORT of its config."""
        labels = dict(clause.split("=", 1)
                      for clause in self.cfg.worker_label_selector.split(",") if clause)
        return self.kube.create_pod(self.cfg.worker_namespace, {
            "metadata": {"name": f"gpu-mounter-worker-{self.node_name}",
                         "namespace": self.cfg.worker_namespace,
                         "labels": labels},
            "spec": {"nodeName": self.node_name, "containers": [{"name": "worker"}]},
            "status": {"phase": "Running", "podIP": ip}})

    def stop(self) -> None:
        """Close the kubelet clients of ``service`` and stop the kubelet's
        server."""
        for client in self._kubelet_clients:
            client.close()
        self._kubelet_clients.clear()
        if self._kubelet_server is not None:
            self._kubelet_server.stop()
            self._kubelet_server = None
        if self._kubelet_dir is not None:
            os.rmdir(self._kubelet_dir)
            self._kubelet_dir = None


class LoopbackWorkerClient:
    """A worker client with no network: each call encodes its request with
    the wire codec, decodes it on the service's side, calls the
    ``GpuMountService``, and encodes and decodes the response. A
    ``ServiceError`` raises as ``WorkerClient`` raises a refused call: an
    ``RpcCallError`` with the status name and the message as its text.
    ``factory(service)`` is a master's ``worker_client_factory``."""

    def __init__(self, service: GpuMountService, address: str = "loopback"):
        self.service = service
        self.address = address

    @classmethod
    def factory(cls, service: GpuMountService):
        return lambda address: cls(service, address)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _call(self, method, request, response_cls, name: str):
        wire_request = type(request).decode(request.encode())
        try:
            response = method(wire_request)
        except ServiceError as exc:
            raise RpcCallError(exc.message, exc.code, self.address, name) from exc
        return response_cls.decode(response.encode())

    def add_gpu(self, pod_name: str, namespace: str, gpu_num: int,
                is_entire_mount: bool = False, idempotency_key: str = ""
                ) -> api.AddGPUResponse:
        return self._call(self.service.add_gpu,
                          api.AddGPURequest(pod_name, namespace, gpu_num, is_entire_mount,
                                            idempotency_key),
                          api.AddGPUResponse, api.ADD_METHOD)

    def remove_gpu(self, pod_name: str, namespace: str, uuids: list[str],
                   force: bool = False, idempotency_key: str = ""
                   ) -> api.RemoveGPUResponse:
        return self._call(self.service.remove_gpu,
                          api.RemoveGPURequest(pod_name, namespace, list(uuids), force,
                                               idempotency_key=idempotency_key),
                          api.RemoveGPUResponse, api.REMOVE_METHOD)
