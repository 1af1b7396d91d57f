"""The cgroup layer: container cgroup paths, and device grant and revoke on
v1 (``devices.allow``) and v2 (the eBPF device program) behind one
interface.

The counterpart of ``gpumounter_tpu/cgroup/``; the original GPUMounter is
v1 only (``pkg/util/cgroup/cgroup.go``).
"""

from __future__ import annotations

from gpumounter_tpu_torch.cgroup.ebpf import DeviceRule, V2DeviceController
from gpumounter_tpu_torch.cgroup.naming import (
    container_cgroup_dir,
    detect_cgroup_driver,
    detect_cgroup_version,
    expand_slice,
    get_cgroup_pids,
    pod_cgroup_relpath,
    pod_qos_class,
)
from gpumounter_tpu_torch.cgroup.v1 import CgroupError, V1DeviceController

_v2_singleton: V2DeviceController | None = None


def device_controller(version: int):
    """The device controller for a cgroup version. The v2 one is a process
    singleton: it holds the fds of the original programs between a grant
    and its revoke."""
    global _v2_singleton
    if version == 2:
        if _v2_singleton is None:
            _v2_singleton = V2DeviceController()
        return _v2_singleton
    return V1DeviceController()


__all__ = [
    "container_cgroup_dir", "detect_cgroup_driver", "detect_cgroup_version",
    "expand_slice", "get_cgroup_pids", "pod_cgroup_relpath", "pod_qos_class",
    "CgroupError", "V1DeviceController", "V2DeviceController", "DeviceRule",
    "device_controller",
]
