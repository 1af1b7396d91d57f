"""The kubelet's pod-resources API: its messages, a gRPC client, a fake
gRPC kubelet, and an in-memory kubelet.

The counterpart of ``gpumounter_tpu/collector/podresources.py``. The worker
learns which pod holds which device from the kubelet's
PodResourcesLister.List (the original: ``collector.go:165-194``, pinned to
v1alpha1). ``PodResourcesClient`` asks v1 first and falls back to v1alpha1
when v1 answers UNIMPLEMENTED; the two versions share the field numbers
read here, so one message set decodes both. The messages ride the port's
proto3 codec (``rpc/wire.py``).

``GpuCollector`` takes whichever source it is given: a ``PodResourcesClient``
on the kubelet's socket (the daemon), or an ``InMemoryKubelet`` (tests and
the card, whose machine has no grpcio). ``FakeKubeletServer`` serves an
``InMemoryKubelet``'s claims over a real gRPC socket.
"""

from __future__ import annotations

import os
import threading
from concurrent import futures

from gpumounter_tpu_torch.rpc.wire import Field, Message
from gpumounter_tpu_torch.utils.lazy_grpc import grpc
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("podresources")

# k8s.io/kubelet/pkg/apis/podresources
SERVICE_V1 = "v1.PodResourcesLister"
SERVICE_V1ALPHA1 = "v1alpha1.PodResourcesLister"
LIST_METHOD = "List"


class ContainerDevices(Message):
    # v1 and v1alpha1: resource_name = 1, device_ids = 2 (v1 adds topology = 3)
    FIELDS = [
        Field(1, "resource_name", "string"),
        Field(2, "device_ids", "string", repeated=True),
    ]


class ContainerResources(Message):
    # v1 and v1alpha1: name = 1, devices = 2 (v1 adds cpu_ids = 3, memory = 4)
    FIELDS = [
        Field(1, "name", "string"),
        Field(2, "devices", "message", repeated=True, message=ContainerDevices),
    ]


class PodResources(Message):
    FIELDS = [
        Field(1, "name", "string"),
        Field(2, "namespace", "string"),
        Field(3, "containers", "message", repeated=True, message=ContainerResources),
    ]


class ListPodResourcesRequest(Message):
    FIELDS = []


class ListPodResourcesResponse(Message):
    FIELDS = [
        Field(1, "pod_resources", "message", repeated=True, message=PodResources),
    ]


def iter_device_claims(pod_resources: list[PodResources], resource_name: str):
    """Yield (pod_name, namespace, device_id) for one resource across pods
    (the loop that marks devices allocated in UpdateGPUStatus,
    collector.go:113-135, on ResourceName == "nvidia.com/gpu")."""
    for pr in pod_resources:
        for container in pr.containers:
            for dev in container.devices:
                if dev.resource_name != resource_name:
                    continue
                for device_id in dev.device_ids:
                    yield pr.name, pr.namespace, device_id


class PodResourcesClient:
    """The kubelet's List over `unix://<socket>`, v1 then v1alpha1."""

    def __init__(self, socket_path: str, timeout_s: float = 10.0, api: str = "auto"):
        if not os.path.exists(socket_path):
            raise FileNotFoundError(f"kubelet pod-resources socket not found: {socket_path}")
        services = {"auto": [SERVICE_V1, SERVICE_V1ALPHA1], "v1": [SERVICE_V1],
                    "v1alpha1": [SERVICE_V1ALPHA1]}
        if api not in services:
            raise ValueError(f"unknown pod-resources api {api!r}")
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        self._services = services[api]
        #: the version that answered; asked alone from then on
        self.pinned: str | None = self._services[0] if len(self._services) == 1 else None
        self._channel = grpc.insecure_channel(f"unix://{socket_path}")

    def close(self) -> None:
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call_list(self, service: str) -> ListPodResourcesResponse:
        stub = self._channel.unary_unary(
            f"/{service}/{LIST_METHOD}", request_serializer=lambda m: m.encode(),
            response_deserializer=ListPodResourcesResponse.decode)
        return stub(ListPodResourcesRequest(), timeout=self.timeout_s)

    def list(self) -> list[PodResources]:
        if self.pinned is not None:
            return self._call_list(self.pinned).pod_resources
        last_err: Exception | None = None
        for service in self._services:
            try:
                resp = self._call_list(service)
            except grpc.RpcError as exc:
                if exc.code() == grpc.StatusCode.UNIMPLEMENTED:
                    last_err = exc
                    continue
                raise
            self.pinned = service
            logger.debug("pod-resources API pinned to %s", service)
            return resp.pod_resources
        raise RuntimeError(f"kubelet at {self.socket_path} serves no known pod-resources "
                           f"API version: {last_err}")


class InMemoryKubelet:
    """A kubelet's pod-resources answers, held in memory: a list of
    (pod, namespace, container, resource_name, [device_ids]) claims, served
    by ``list()`` as ``PodResourcesClient.list`` serves them."""

    def __init__(self):
        self._lock = threading.Lock()
        self.claims: list[tuple[str, str, str, str, list[str]]] = []

    def list(self) -> list[PodResources]:
        with self._lock:
            claims = list(self.claims)
        pods: dict[tuple[str, str], PodResources] = {}
        for pod, ns, container, resource, ids in claims:
            pr = pods.setdefault((ns, pod), PodResources(name=pod, namespace=ns))
            cr = next((c for c in pr.containers if c.name == container), None)
            if cr is None:
                cr = ContainerResources(name=container)
                pr.containers.append(cr)
            cr.devices.append(ContainerDevices(resource_name=resource,
                                               device_ids=list(ids)))
        return list(pods.values())

    def set_claim(self, pod: str, namespace: str, resource: str,
                  device_ids: list[str], container: str = "main") -> None:
        with self._lock:
            self.claims.append((pod, namespace, container, resource, list(device_ids)))

    def drop_pod(self, pod: str, namespace: str) -> None:
        with self._lock:
            self.claims = [c for c in self.claims if (c[0], c[1]) != (pod, namespace)]


class FakeKubeletServer:
    """A pod-resources gRPC server on a unix socket, serving the claims of
    an ``InMemoryKubelet`` under the API versions it is told (v1, v1alpha1
    or both), for tests of the wire path."""

    def __init__(self, socket_path: str, versions: tuple[str, ...] = ("v1",),
                 kubelet: InMemoryKubelet | None = None):
        self.socket_path = socket_path
        self.kubelet = kubelet or InMemoryKubelet()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        names = {"v1": SERVICE_V1, "v1alpha1": SERVICE_V1ALPHA1}
        for v in versions:
            self._server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
                names[v], {LIST_METHOD: grpc.unary_unary_rpc_method_handler(
                    self._list, request_deserializer=ListPodResourcesRequest.decode,
                    response_serializer=lambda m: m.encode())}),))
        self._server.add_insecure_port(f"unix://{socket_path}")

    def _list(self, request, context) -> ListPodResourcesResponse:
        return ListPodResourcesResponse(pod_resources=self.kubelet.list())

    def start(self) -> "FakeKubeletServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=None).wait()
