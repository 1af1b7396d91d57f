"""GpuCollector: the node's GPU inventory and pod <-> GPU ownership.

The counterpart of ``TpuCollector`` in
``gpumounter_tpu/collector/collector.py``, and of the original's
GPUCollector (``collector.go:19-163``):

  * enumerate, then a first ownership refresh (NewGPUCollector, :23-38);
  * ``update_status``: the kubelet's pod-resources List marks owners
    (UpdateGPUStatus, :90-138);
  * ``get_pod_devices``: refresh, then the devices of the pod or of its
    slave pods (GetPodGPUResources, :149-163).

A device ID from the NVIDIA device plugin is a GPU UUID (its default
strategy) or an NVML index (its index strategy). An index is matched only
against the NVML index, never against the minor number or a node's name:
the two orders differ on hosts where PCI order and the driver's minors do.

Where the reference serves a device-only inventory with stale ownership when
the kubelet cannot be asked, this one raises the kubelet's error: every
caller here is a mount or remove flow that would act on the stale marks.
"""

from __future__ import annotations

import copy
import re
import threading

from gpumounter_tpu_torch.collector.podresources import iter_device_claims
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import DeviceBackend
from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("collector")

_INDEX_RE = re.compile(r"^\d+$")


class GpuCollector:
    def __init__(self, backend: DeviceBackend, podresources, cfg=None):
        """podresources: what answers the kubelet's PodResourcesLister.List
        through ``list()``: a ``PodResourcesClient`` on the kubelet's socket,
        or an ``InMemoryKubelet``; the collector uses the one it is given."""
        self.cfg = cfg or Config()
        self.backend = backend
        self._podresources = podresources
        self._lock = threading.RLock()
        self.devices: list[GpuDevice] = []
        self.refresh_inventory()
        self.update_status()

    # --- enumeration (GetGPUInfo, collector.go:40-79) ---

    def refresh_inventory(self) -> None:
        """Enumerate; ownership marks come with the next update_status."""
        with self._lock:
            self.devices = self.backend.list_devices()
            absent = self.backend.absent_companions()
            logger.info("GPU inventory: %d GPU(s)", len(self.devices))
            if absent:
                logger.warning("companion nodes left out: %s",
                               ", ".join(f"{k} ({v})" for k, v in sorted(absent.items())))

    # --- ownership (UpdateGPUStatus, collector.go:90-138) ---

    def _match_device(self, device_id: str) -> GpuDevice | None:
        """Map a device-plugin ID to a GPU: its UUID, its device path, or
        its NVML index. Lock must be held."""
        for dev in self.devices:
            if device_id == dev.uuid or device_id == dev.device_path:
                return dev
        if _INDEX_RE.match(device_id):
            idx = int(device_id)
            for dev in self.devices:
                if dev.index == idx:
                    return dev
        return None

    def update_status(self) -> None:
        """Refresh pod <-> GPU ownership from the kubelet."""
        pod_resources = self._podresources.list()
        with self._lock:
            for dev in self.devices:
                dev.reset_state()
            unmatched: list[str] = []
            for pod, ns, device_id in iter_device_claims(
                    pod_resources, self.cfg.gpu_resource_name):
                dev = self._match_device(device_id)
                if dev is None:
                    unmatched.append(device_id)
                    continue
                dev.mark_allocated(pod, ns)
            if unmatched:
                logger.warning("pod-resources advertises %s=%s not in local "
                               "inventory", self.cfg.gpu_resource_name, unmatched)

    # --- queries ---

    def get_pod_devices(self, pod_name: str, namespace: str,
                        slave_pod_names: set[str] | None = None,
                        refresh: bool = True) -> list[GpuDevice]:
        """GPUs owned by the pod, or by the named slave pods in the pool
        namespace (the allocator passes the names it found by owner label;
        None falls back to the "<pod>-slave-pod-" name prefix)."""
        if refresh:
            self.update_status()
        slave_prefix = pod_name[:200] + self.cfg.slave_pod_name_suffix
        with self._lock:
            out = []
            for dev in self.devices:
                if not dev.pod_name:
                    continue
                if dev.pod_name == pod_name and dev.namespace == namespace:
                    out.append(dev)
                elif dev.namespace == self.cfg.pool_namespace and (
                        dev.pod_name in slave_pod_names
                        if slave_pod_names is not None
                        else dev.pod_name.startswith(slave_prefix)):
                    out.append(dev)
            return out

    def get_slave_pod_devices(self, slave_pod_name: str,
                              refresh: bool = True) -> list[GpuDevice]:
        """GPUs the scheduler handed to one slave pod (allocator.go:85-96)."""
        if refresh:
            self.update_status()
        with self._lock:
            return [d for d in self.devices
                    if d.pod_name == slave_pod_name
                    and d.namespace == self.cfg.pool_namespace]

    def snapshot(self) -> list[GpuDevice]:
        """A copy of the inventory with its ownership marks, as the last
        refresh left them."""
        with self._lock:
            return copy.deepcopy(self.devices)
