"""FakeCluster: GPU nodes, end to end, in one process.

The counterpart of ``gpumounter_tpu/testing/cluster.py``. It wires together,
for each node:

  * a device backend: a ``FakeDeviceBackend`` (fake nodes in a directory)
    for tests, or the live ``NvidiaDeviceBackend`` on a GPU host;
  * an ``InMemoryKubelet`` that answers pod-resources List;

and for all of them one ``FakeKubeClient``, whose scheduler hook plays the
scheduler and the NVIDIA device plugin: a pod requesting ``nvidia.com/gpu``
goes to the node its ``kubernetes.io/hostname`` selector names (else the
first node with enough free GPUs) and gets free GPUs of that node's
inventory, by UUID in NVML index order; its claim lands in that node's
kubelet, and it runs. When too few are free it stays Pending-Unschedulable,
the signal the allocator maps to InsufficientGPU (allocator.go:262-270).
Deleting the pod frees them. ``FakeCluster(backend)`` is one node;
``FakeCluster(nodes={name: backend})`` or ``with_fake_gpus(root,
nodes={name: n})`` several. The one-node views (``node_name``, ``backend``,
``kubelet``, ``assignment``) are the first node's.

Every target pod runs with a pod IP, the address a slice's plan hands its
tenants: the one given, else 10.8.<node's position>.<n + 1> for the node's
n-th target pod, the same in every process (the reference draws it from
``hash()``, which differs between processes).

A target pod has no container behind it: ``DirTargetMounter`` mounts into a
directory that stands for the container's /dev, in the mount namespace of
``ns_pid`` when given, granting on ``cgroup_dirs`` when given.

For the transport (``tests/test_master.py:24-90`` of the reference):

  * ``serve_kubelet(node)`` serves a node's claims over a real gRPC socket
    (``FakeKubeletServer``), and ``service(..., kubelet="grpc")`` gives the
    collector a ``PodResourcesClient`` on it in place of the in-memory one;
  * ``register_worker(ip, node)`` creates the node's worker pod the way the
    DaemonSet would, so the master's registry finds the node's worker;
  * ``WorkerServers`` serves one gRPC worker a node on a local port behind
    the node's registered IP, and ``restart(node, pool)`` is a worker's
    death and restart over the same ledger, with its replay;
  * ``LoopbackWorkerClient`` reaches a ``GpuMountService`` without grpc, for
    hosts that have none (the card's machine): each call goes through the
    wire codec both ways, and a refused call raises as ``WorkerClient``
    raises it (a ``timeout_s`` is taken and has nothing to bound). The
    master uses it only where a caller passes it.

``kill_gpu(index, node)`` marks a fake GPU dead: the backend's probe reports
it and the scheduler skips it from then on.

Every node of the cluster has its Node object in the fake API, Ready, as the
recovery controller reads it (``kube.set_node_ready`` plays a kubelet whose
heartbeats stopped).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time

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
from gpumounter_tpu_torch.rpc.resilience import FencedError, RpcCallError
from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountTarget
from gpumounter_tpu_torch.worker.resync import LedgerResync
from gpumounter_tpu_torch.worker.server import GpuMountService, ServiceError, build_server

HOSTNAME_LABEL = "kubernetes.io/hostname"


class DirTargetMounter(GpuMounter):
    """A mounter whose every target pod is one directory."""

    def __init__(self, backend: DeviceBackend, dev_dir: str, cfg=None,
                 ns_pid: int | None = None, cgroup_dirs=(), kube=None):
        super().__init__(backend, cfg=cfg, kube=kube)
        self.dev_dir = dev_dir
        self.ns_pid = ns_pid
        self.cgroup_dirs = list(cgroup_dirs)

    def resolve_target(self, pod: Pod) -> MountTarget:
        return MountTarget(dev_dir=self.dev_dir, cgroup_dirs=list(self.cgroup_dirs),
                           ns_pid=self.ns_pid, description=f"{pod.namespace}/{pod.name}",
                           pod=pod)


class FakeNode:
    """One node of the cluster: its backend, its kubelet, and its books."""

    def __init__(self, name: str, position: int, backend: DeviceBackend):
        self.name = name
        self.position = position
        self.backend = backend
        self.kubelet = InMemoryKubelet()
        # GPU UUID (the device plugin's device ID) -> (namespace, pod) or None
        self.assignment: dict[str, tuple[str, str] | None] = {
            d.uuid: None for d in backend.list_devices()}
        self.target_pods = 0
        #: UUIDs killed by ``FakeCluster.kill_gpu``: never assigned again
        self.dead: set[str] = set()
        self.kubelet_server: FakeKubeletServer | None = None
        self.kubelet_dir: str | None = None

    def free_ids(self) -> list[str]:
        return [uuid for uuid, owner in self.assignment.items()
                if owner is None and uuid not in self.dead]


def _selector(pod: dict) -> str | None:
    return (pod.get("spec", {}).get("nodeSelector") or {}).get(HOSTNAME_LABEL)


class FakeCluster:
    def __init__(self, backend: DeviceBackend | None = None, node_name: str = "gpu-node-0",
                 scheduler_delay_s: float = 0.0, cfg: Config | None = None,
                 nodes: dict[str, DeviceBackend] | None = None):
        if (backend is None) == (nodes is None):
            raise ValueError("give a backend (one node) or nodes={name: backend}")
        if nodes is None:
            nodes = {node_name: backend}
        self._nodes = {name: FakeNode(name, i, b) for i, (name, b) in enumerate(nodes.items())}
        self.node_name = next(iter(self._nodes))
        self.cfg = dataclasses.replace(cfg or Config(), slave_pod_timeout_s=10.0)
        self._alloc_lock = threading.Lock()
        self.kube = FakeKubeClient(scheduler_hook=self._schedule, delete_hook=self._reap,
                                   scheduler_delay_s=scheduler_delay_s)
        for name in self._nodes:
            self.kube.create_node(name, ready=True)
        self._kubelet_clients: list[PodResourcesClient] = []

    @classmethod
    def with_fake_gpus(cls, root: str, n_gpus: int = 4, nodes: dict[str, int] | None = None,
                       **kwargs) -> "FakeCluster":
        """One node of `n_gpus` fake GPUs under <root>/host-dev, or with
        `nodes` = {name: n}, a node of n under <root>/<name>/host-dev each."""
        if nodes is None:
            return cls(FakeDeviceBackend.create(os.path.join(root, "host-dev"), n_gpus),
                       **kwargs)
        return cls(nodes={name: FakeDeviceBackend.create(os.path.join(root, name, "host-dev"), n)
                          for name, n in nodes.items()}, **kwargs)

    # --- the nodes ---

    def node(self, name: str | None = None) -> FakeNode:
        return self._nodes[name or self.node_name]

    @property
    def node_names(self) -> list[str]:
        return list(self._nodes)

    @property
    def backend(self) -> DeviceBackend:
        return self.node().backend

    @property
    def kubelet(self) -> InMemoryKubelet:
        return self.node().kubelet

    @property
    def assignment(self) -> dict[str, tuple[str, str] | None]:
        return self.node().assignment

    # --- the scheduler and the device plugin ---

    def _pick_node(self, selector: str | None, want: int) -> FakeNode | None:
        """The selector's node if it has `want` free GPUs, else (no
        selector) the first node that has. The caller holds _alloc_lock."""
        if selector:
            candidates = [self._nodes[selector]] if selector in self._nodes else []
        else:
            candidates = list(self._nodes.values())
        return next((n for n in candidates if len(n.free_ids()) >= want), None)

    def _schedule(self, pod: dict) -> None:
        p = Pod(pod)
        want = p.resource_limit(self.cfg.gpu_resource_name)
        selector = _selector(pod)
        if want == 0:
            pod.setdefault("spec", {}).setdefault("nodeName", selector or self.node_name)
            pod.setdefault("status", {})["phase"] = "Running"
            return
        with self._alloc_lock:
            node = self._pick_node(selector, want)
            if node is None:
                pod.setdefault("status", {}).update({
                    "phase": "Pending",
                    "conditions": [{
                        "type": "PodScheduled", "status": "False",
                        "reason": "Unschedulable",
                        "message": f"0/{len(self._nodes)} nodes available: insufficient "
                                   f"{self.cfg.gpu_resource_name}"}]})
                return
            assigned = node.free_ids()[:want]
            for uuid in assigned:
                node.assignment[uuid] = (p.namespace, p.name)
            node.kubelet.set_claim(p.name, p.namespace, self.cfg.gpu_resource_name, assigned)
        pod.setdefault("spec", {})["nodeName"] = node.name
        pod.setdefault("status", {})["phase"] = "Running"

    def _reap(self, pod: dict) -> None:
        p = Pod(pod)
        with self._alloc_lock:
            for node in self._nodes.values():
                for uuid, owner in node.assignment.items():
                    if owner == (p.namespace, p.name):
                        node.assignment[uuid] = None
                node.kubelet.drop_pod(p.name, p.namespace)

    # --- fault injection ---

    def kill_gpu(self, index: int | str, node: str | None = None) -> str:
        """A GPU's death (the reference's ``kill_chip``): the GPU of NVML
        index `index` on `node` is marked dead on the fake backend, so that
        ``probe_device`` reports it unhealthy, and the scheduler never
        assigns it again (a dead GPU does not come back). Its owner keeps
        its claim: the state the reconciler's probe must find and heal.
        Returns its UUID."""
        target = self.node(node)
        dev = next((d for d in target.backend.list_devices() if str(d.index) == str(index)),
                   None)
        if dev is None:
            raise KeyError(f"no GPU {index} on node {target.name}")
        with self._alloc_lock:
            target.dead.add(dev.uuid)
        target.backend.mark_dead(dev.basename)
        return dev.uuid

    # --- convenience ---

    def free_gpu_count(self, node: str | None = None) -> int:
        """Free GPUs of `node`, or of the whole cluster."""
        with self._alloc_lock:
            if node is not None:
                return len(self._nodes[node].free_ids())
            return sum(len(n.free_ids()) for n in self._nodes.values())

    def add_target_pod(self, name: str, namespace: str = "default", node: str | None = None,
                       ip: str | None = None) -> Pod:
        """A running workload pod (no GPU request) to hot-mount into, on
        `node` (the first node by default), at `ip` (by default the node's
        next address of 10.8.<position>.0/24)."""
        target = self.node(node)
        self.kube.create_pod(namespace, {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {"containers": [{"name": "main", "image": "app"}],
                     **({"nodeSelector": {HOSTNAME_LABEL: node}} if node else {})}})
        with self._alloc_lock:
            target.target_pods += 1
            ip = ip or f"10.8.{target.position}.{target.target_pods + 1}"
        self.kube.set_pod_status(namespace, name, podIP=ip, containerStatuses=[{
            "name": "main", "containerID": f"containerd://{name}-cid",
            "state": {"running": {}}}])
        pod = self.kube.wait_for_pod(
            namespace, name, lambda pj: pj is not None and Pod(pj).phase == "Running",
            timeout_s=5.0)
        if pod is None:
            raise RuntimeError(f"target pod {namespace}/{name} did not reach Running")
        return Pod(self.kube.get_pod(namespace, name))

    def service(self, dev_dir: str, ns_pid: int | None = None, cgroup_dirs=(),
                kubelet: str = "memory", node: str | None = None) -> GpuMountService:
        """The worker's service for `node` (the first by default), mounting
        into `dev_dir`. Its collector reads the node's kubelet in memory
        ("memory"), or over gRPC on the socket of ``serve_kubelet`` ("grpc")."""
        target = self.node(node)
        if kubelet == "grpc":
            podresources = PodResourcesClient(self.serve_kubelet(target.name).socket_path,
                                              timeout_s=5.0)
            self._kubelet_clients.append(podresources)
        elif kubelet == "memory":
            podresources = target.kubelet
        else:
            raise ValueError(f"kubelet {kubelet!r}: 'memory' or 'grpc'")
        collector = GpuCollector(target.backend, podresources, cfg=self.cfg)
        mounter = DirTargetMounter(target.backend, dev_dir, cfg=self.cfg, ns_pid=ns_pid,
                                   cgroup_dirs=cgroup_dirs, kube=self.kube)
        return GpuMountService(self.kube, collector, mounter=mounter, cfg=self.cfg)

    # --- the transport ---

    def serve_kubelet(self, node: str | None = None) -> FakeKubeletServer:
        """A node's kubelet pod-resources API (v1) over gRPC on a unix socket
        in a new temporary directory, serving its claims; started once a
        node, stopped by ``stop``."""
        target = self.node(node)
        if target.kubelet_server is None:
            target.kubelet_dir = tempfile.mkdtemp(prefix="kubelet-")
            target.kubelet_server = FakeKubeletServer(
                os.path.join(target.kubelet_dir, "kubelet.sock"),
                kubelet=target.kubelet).start()
        return target.kubelet_server

    def register_worker(self, ip: str = "127.0.0.1", node: str | None = None) -> dict:
        """A node's worker pod, as the DaemonSet would create it: in
        WORKER_NAMESPACE, labelled WORKER_LABEL_SELECTOR, on `node` (the
        first by default), at `ip`. The master dials it at `ip`:WORKER_PORT
        of its config."""
        name = self.node(node).name
        labels = dict(clause.split("=", 1)
                      for clause in self.cfg.worker_label_selector.split(",") if clause)
        return self.kube.create_pod(self.cfg.worker_namespace, {
            "metadata": {"name": f"gpu-mounter-worker-{name}",
                         "namespace": self.cfg.worker_namespace,
                         "labels": labels},
            "spec": {"nodeName": name, "containers": [{"name": "worker"}]},
            "status": {"phase": "Running", "podIP": ip}})

    def stop(self) -> None:
        """Close the kubelet clients of ``service`` and stop every node's
        kubelet server."""
        for client in self._kubelet_clients:
            client.close()
        self._kubelet_clients.clear()
        for node in self._nodes.values():
            if node.kubelet_server is not None:
                node.kubelet_server.stop()
                node.kubelet_server = None
            if node.kubelet_dir is not None:
                os.rmdir(node.kubelet_dir)
                node.kubelet_dir = None


class WorkerServers:
    """One gRPC worker server a node on `host`, at a local port behind the
    node's registered IP (``local_address`` maps a registered worker's
    address to it). ``build_service(node)`` makes a node's service; a
    second one over the same ledger directory is the worker's restart."""

    def __init__(self, build_service, host: str = "127.0.0.1"):
        self.build_service = build_service
        self.host = host
        self.services: dict[str, GpuMountService] = {}
        self.servers: dict = {}
        self.ip_by_node: dict[str, str] = {}
        self.port_by_ip: dict[str, int] = {}

    def start(self, node: str, ip: str) -> None:
        self.ip_by_node[node] = ip
        self._serve(node, self.build_service(node))

    def local_address(self, worker_address: str) -> str:
        return f"{self.host}:{self.port_by_ip[worker_address.rsplit(':', 1)[0]]}"

    def _serve(self, node: str, service: GpuMountService, pool=None) -> None:
        """`service` on a new gRPC server at the node's address; the node's
        server before it stops, and its channel in `pool` serves no more."""
        server = build_server(service, address=f"{self.host}:0")
        server.start()
        self.services[node] = service
        self.adopt(node, server, server.bound_port, [pool] if pool is not None else ())

    def adopt(self, node: str, server, port: int, channel_pools=()) -> None:
        """`server`, already serving on `port` of the host (a gRPC server,
        or a ``worker_process.WorkerProcess``), is the node's worker from
        now on; the node's server before it stops, and each of
        `channel_pools` drops its channel to it."""
        ip = self.ip_by_node[node]
        old, old_port = self.servers.get(node), self.port_by_ip.get(ip)
        self.servers[node], self.port_by_ip[ip] = server, port
        if old is not None:
            old.stop(None).wait()
            for pool in channel_pools:
                pool.invalidate(f"{self.host}:{old_port}", "worker-restart")

    def kill(self, node: str, kube, cfg, channel_pools=()) -> None:
        """The node's death, as the control plane sees it: its worker's
        server stops without grace (a worker process is killed), each of
        `channel_pools` drops its channel to it, its worker pod is deleted
        from `kube` and its Node goes NotReady. What it held stays on disk,
        as on dead hardware."""
        server = self.servers.pop(node, None)
        if server is not None:
            server.stop(None).wait()
        port = self.port_by_ip.get(self.ip_by_node[node])
        for pool in channel_pools:
            pool.invalidate(f"{self.host}:{port}", "node-kill")
        kube.delete_pod(cfg.worker_namespace, f"gpu-mounter-worker-{node}")
        kube.set_node_ready(node, False, reason="KubeletStopped")

    def restart(self, node: str, pool=None) -> tuple[dict, float]:
        """The node's worker dies (its ledger's fd abandoned, no clean
        marker) and a new one starts over the same ledger: the replay, then
        serving. Returns the replay's summary and its ms (host clock)."""
        old = self.services[node]
        if old.ledger is not None:
            old.ledger.abandon()
        service = self.build_service(node)
        t0 = time.perf_counter()
        summary = LedgerResync(service).replay_once()
        replay_ms = (time.perf_counter() - t0) * 1e3
        self._serve(node, service, pool)
        return summary, replay_ms

    def stop(self) -> None:
        for server in self.servers.values():
            server.stop(None).wait()
        for service in self.services.values():
            if service.ledger is not None:
                service.ledger.abandon()


class LoopbackWorkerClient:
    """A worker client with no network: each call encodes its request with
    the wire codec, decodes it on the service's side, calls the
    ``GpuMountService``, and encodes and decodes the response. A
    ``ServiceError`` raises as ``WorkerClient`` raises a refused call: an
    ``RpcCallError`` with the status name and the message as its text, a
    ``FencedError`` for a stale epoch.
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
            if exc.code == "FAILED_PRECONDITION" and exc.message.startswith("FENCED"):
                raise FencedError(f"{name} to {self.address}: {exc.message}", self.address,
                                  name) from exc
            raise RpcCallError(exc.message, exc.code, self.address, name) from exc
        return response_cls.decode(response.encode())

    def add_gpu(self, pod_name: str, namespace: str, gpu_num: int,
                is_entire_mount: bool = False, idempotency_key: str = "", epoch: int = 0,
                timeout_s: float | None = None, share_weight: int = 0,
                share_rate_budget: int = 0) -> api.AddGPUResponse:
        return self._call(self.service.add_gpu,
                          api.AddGPURequest(pod_name, namespace, gpu_num, is_entire_mount,
                                            idempotency_key, epoch=epoch,
                                            share_weight=share_weight,
                                            share_rate_budget=share_rate_budget),
                          api.AddGPUResponse, api.ADD_METHOD)

    def remove_gpu(self, pod_name: str, namespace: str, uuids: list[str],
                   force: bool = False, remove_all: bool = False, idempotency_key: str = "",
                   epoch: int = 0, timeout_s: float | None = None) -> api.RemoveGPUResponse:
        return self._call(self.service.remove_gpu,
                          api.RemoveGPURequest(pod_name, namespace, list(uuids), force,
                                               remove_all=remove_all,
                                               idempotency_key=idempotency_key, epoch=epoch),
                          api.RemoveGPUResponse, api.REMOVE_METHOD)

    def collect_telemetry(self, quarantined: bool = False,
                          timeout_s: float | None = None) -> api.CollectTelemetryResponse:
        return self._call(self.service.collect_telemetry,
                          api.CollectTelemetryRequest(quarantined=quarantined),
                          api.CollectTelemetryResponse, api.TELEMETRY_METHOD)

    def probe_gpu(self, pod_name: str, namespace: str, timeout_s: float | None = None
                  ) -> tuple[api.ProbeGPUResult, list[api.ChipHealth]]:
        response = self._call(self.service.probe_gpu,
                              api.ProbeGPURequest(pod_name, namespace),
                              api.ProbeGPUResponse, api.PROBE_METHOD)
        return api.ProbeGPUResult(response.probe_gpu_result), list(response.chips)

    def quiesce_status(self, pod_name: str, namespace: str, timeout_s: float | None = None
                       ) -> tuple[api.QuiesceStatusResult, api.QuiesceStatusResponse]:
        response = self._call(self.service.quiesce_status,
                              api.QuiesceStatusRequest(pod_name, namespace),
                              api.QuiesceStatusResponse, api.QUIESCE_METHOD)
        return api.QuiesceStatusResult(response.quiesce_status_result), response
