"""Multi-node stacks of both packages for the slice and batch tests.

The reference's is ``tests/test_slice.py``'s fixture: its ``FakeCluster(root,
nodes=...)``, one real gRPC worker a node, worker pods at 10.0.0.<i + 1>, and
a client factory that maps each pod IP to its server's port on localhost.
The port's is ``entry._MasterStack``, the stack its ``slice_check`` and
``master_check`` run: its multi-node ``FakeCluster``, one gRPC worker server
a node with the node's kubelet over gRPC. Both expose the same small
surface, so that one scenario runs on each and records what it sees in the
same words (TPU read as GPU).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

from conftest import AUTH_HEADER

from gpumounter_tpu.collector.collector import TpuCollector
from gpumounter_tpu.collector.podresources import PodResourcesClient
from gpumounter_tpu.master import app as ref_app
from gpumounter_tpu.master import slice_ops as ref_slice
from gpumounter_tpu.rpc.client import WorkerClient as RefWorkerClient
from gpumounter_tpu.testing.cluster import FakeCluster as RefCluster
from gpumounter_tpu.worker.mounter import MountTarget as RefTarget
from gpumounter_tpu.worker.mounter import TpuMounter
from gpumounter_tpu.worker.server import TpuMountService
from gpumounter_tpu.worker.server import build_server as ref_build_server
from gpumounter_tpu_torch import entry
from gpumounter_tpu_torch.master import app as port_app
from gpumounter_tpu_torch.master import slice_ops as port_slice
from gpumounter_tpu_torch.rpc.client import WorkerClient
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.torchside.visibility import gpus_visible_in_dev

N_NODES = 4
PER_NODE = 4
NODES = [f"host-{i}" for i in range(N_NODES)]


def gpu_words(text: str) -> str:
    """The reference's words read as the port's."""
    return (text.replace("TPU", "GPU").replace("chipsPerHost", "gpusPerHost")
            .replace("chips", "gpus").replace("chip", "GPU"))


class _Stack:
    """What the scenarios use: pods, coordinators, clients, HTTP, books.
    A subclass sets kube, cfg, registry, factory, port_by_ip and base."""

    slice_mod = None

    def make_app(self, factory=None, **changes):
        cfg = self.with_cfg(**changes) if changes else self.cfg
        return self.app_module.MasterApp(self.kube, cfg=cfg,
                                         worker_client_factory=factory or self.factory,
                                         registry=self.registry)

    def slice_coordinator(self, factory=None):
        return self.slice_mod.SliceCoordinator(self.kube, self.registry,
                                               factory or self.factory, self.cfg)

    def target(self, pod: str, namespace: str = "default"):
        return self.slice_mod.SliceTarget(namespace, pod)

    def local(self, node: str) -> str:
        """The node's worker server on localhost."""
        ip = self.registry.worker_address(node).rsplit(":", 1)[0]
        return f"localhost:{self.port_by_ip[ip]}"

    def post(self, path: str, payload, app=None, raw: bytes | None = None):
        """(status, parsed JSON or text, headers) of one POST; `app` answers
        in process when given."""
        body = raw if raw is not None else json.dumps(payload).encode()
        if app is not None:
            status, _, text, headers = app.handle("POST", path, body, dict(AUTH_HEADER))
            return status, _decoded(status, text), headers
        req = urllib.request.Request(self.base + path, data=body, method="POST",
                                     headers=dict(AUTH_HEADER))
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, _decoded(resp.status, resp.read().decode()), {}
        except urllib.error.HTTPError as exc:
            return exc.code, _decoded(exc.code, exc.read().decode()), dict(exc.headers)

    def free_by_node(self) -> dict[str, int]:
        return {node: self.free(node) for node in NODES}


def _decoded(status: int, text: str):
    if status == 200 and text.lstrip().startswith("{"):
        return json.loads(text)
    return gpu_words(text.strip())


class RefSliceStack(_Stack):
    app_module = ref_app
    slice_mod = ref_slice

    def __init__(self, root: str):
        self.cluster = RefCluster(os.path.join(root, "ref"),
                                  nodes={n: PER_NODE for n in NODES}).start()
        self.servers, self.dev_dirs, port_by_ip = [], {}, {}
        for i, name in enumerate(self.cluster.node_names):
            cfg = self.cluster.node_cfg(name)
            node = self.cluster.node(name)
            collector = TpuCollector(backend=node.backend, podresources=PodResourcesClient(
                node.kubelet_socket, timeout_s=5.0), cfg=cfg)
            mounter = TpuMounter(node.backend, cfg=cfg)
            dev = os.path.join(root, f"ref-dev-{name}")
            os.makedirs(dev)
            mounter.resolve_target = lambda pod, _d=dev: RefTarget(dev_dir=_d,
                                                                   description=pod.name)
            server = ref_build_server(TpuMountService(self.cluster.kube, collector=collector,
                                                      mounter=mounter, cfg=cfg),
                                      address="localhost:0")
            server.start()
            self.servers.append(server)
            self.dev_dirs[name] = dev
            ip = f"10.0.0.{i + 1}"
            port_by_ip[ip] = server.bound_port
            self.cluster.kube.create_pod(cfg.worker_namespace, {
                "metadata": {"name": f"worker-{name}", "namespace": cfg.worker_namespace,
                             "labels": {"app": "tpu-mounter-worker"}},
                "spec": {"nodeName": name, "containers": [{"name": "w"}]},
                "status": {"phase": "Running", "podIP": ip}})
        self.kube, self.cfg, self.port_by_ip = self.cluster.kube, self.cluster.cfg, port_by_ip
        self.registry = ref_app.WorkerRegistry(self.kube, self.cfg)
        self.factory = lambda address: RefWorkerClient(
            f"localhost:{port_by_ip[address.rsplit(':', 1)[0]]}")
        self.httpd = ref_app.build_http_server(self.make_app(), port=0, host="127.0.0.1")
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.registry.stop()
        for server in self.servers:
            server.stop(grace=None)
        self.cluster.stop()

    def with_cfg(self, **changes):
        return self.cfg.replace(**changes)

    def add_pod(self, name: str, node: str):
        return self.cluster.add_target_pod(name, node=node)

    def free(self, node: str | None = None) -> int:
        return self.cluster.free_chip_count(node)

    def visible(self, node: str) -> int:
        return sum(1 for f in os.listdir(self.dev_dirs[node]) if f.startswith("accel"))

    def mount_slice(self, targets, n, entire=True, accel=None, factory=None):
        return self.slice_coordinator(factory).mount_slice(targets, n, entire,
                                                           accel_type=accel)

    def client(self, node: str, breaker=None):
        return RefWorkerClient(self.local(node), breaker=breaker,
                               breaker_key=self.local(node) if breaker else None)

    def add(self, client, pod: str, n: int, entire: bool = False) -> tuple[str, list]:
        result, uuids = client.add_tpu_detailed(pod, "default", n, entire)
        return gpu_words(result.name), list(uuids)

    def remove(self, client, pod: str, uuids, force=False, remove_all=False) -> str:
        return gpu_words(client.remove_tpu(pod, "default", list(uuids), force=force,
                                           remove_all=remove_all).name)

    def add_method(self):
        return "add_tpu_detailed"

    def unavailable(self, message: str):
        from gpumounter_tpu.rpc.resilience import WorkerUnavailableError
        return WorkerUnavailableError(message)

    def breaker(self, **kw):
        from gpumounter_tpu.rpc.resilience import CircuitBreaker
        return CircuitBreaker(**kw)


class PortSliceStack(_Stack):
    app_module = port_app
    slice_mod = port_slice

    def __init__(self, root: str):
        self.cluster = FakeCluster.with_fake_gpus(os.path.join(root, "port"),
                                                  nodes={n: PER_NODE for n in NODES})
        self.dev_dirs = {name: os.path.join(root, f"port-dev-{name}")
                         for name in self.cluster.node_names}
        for dev in self.dev_dirs.values():
            os.makedirs(dev)
        self.stack = entry._MasterStack(self.cluster, self.dev_dirs)
        self.kube, self.cfg, self.base = self.cluster.kube, self.cluster.cfg, self.stack.base
        self.registry, self.port_by_ip = self.stack.app.registry, self.stack.workers.port_by_ip
        self.factory = self.stack.app._client_factory

    def close(self):
        self.stack.__exit__(None, None, None)

    def with_cfg(self, **changes):
        return dataclasses.replace(self.cfg, **changes)

    def add_pod(self, name: str, node: str):
        return self.cluster.add_target_pod(name, node=node)

    def free(self, node: str | None = None) -> int:
        return self.cluster.free_gpu_count(node)

    def visible(self, node: str) -> int:
        return gpus_visible_in_dev(self.dev_dirs[node])

    def mount_slice(self, targets, n, entire=True, accel=None, factory=None):
        return self.slice_coordinator(factory).mount_slice(targets, n, entire,
                                                           accel_type=accel)

    def client(self, node: str, breaker=None):
        return WorkerClient(self.local(node), breaker=breaker)

    def add(self, client, pod: str, n: int, entire: bool = False) -> tuple[str, list]:
        response = client.add_gpu(pod, "default", n, entire)
        return port_app.AddGPUResult(response.add_gpu_result).name, list(response.uuids)

    def remove(self, client, pod: str, uuids, force=False, remove_all=False) -> str:
        return port_app.RemoveGPUResult(client.remove_gpu(
            pod, "default", list(uuids), force=force,
            remove_all=remove_all).remove_gpu_result).name

    def add_method(self):
        return "add_gpu"

    def unavailable(self, message: str):
        from gpumounter_tpu_torch.rpc.resilience import WorkerUnavailableError
        return WorkerUnavailableError(message)

    def breaker(self, **kw):
        from gpumounter_tpu_torch.rpc.resilience import CircuitBreaker
        return CircuitBreaker(**kw)


def build_stacks(root: str) -> dict[str, _Stack]:
    return {"reference": RefSliceStack(root), "port": PortSliceStack(root)}
