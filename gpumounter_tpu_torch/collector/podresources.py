"""The kubelet's pod-resources API, without the wire.

The counterpart of ``gpumounter_tpu/collector/podresources.py``. The worker
learns which pod holds which device from the kubelet's
PodResourcesLister.List (the original: ``collector.go:165-194``). Here are
its messages as plain dataclasses, ``iter_device_claims``, and an in-memory
kubelet that serves the same ``list()`` as the gRPC client. The wire codec,
the gRPC client of the kubelet's socket and the fake gRPC kubelet come with
the transport.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class ContainerDevices:
    resource_name: str = ""
    device_ids: list[str] = field(default_factory=list)


@dataclass
class ContainerResources:
    name: str = ""
    devices: list[ContainerDevices] = field(default_factory=list)


@dataclass
class PodResources:
    name: str = ""
    namespace: str = ""
    containers: list[ContainerResources] = field(default_factory=list)


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
