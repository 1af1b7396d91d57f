"""The cgroup layer: container cgroup paths, and the v1 device controller.

The counterpart of ``gpumounter_tpu/cgroup/``. A cgroup v2 host needs the
eBPF device controller (the reference's ``cgroup/ebpf.py``), which this
package does not have yet: the mounter refuses to mount into a v2
container (``V2_MISSING``) rather than mount without a grant.
"""

from __future__ import annotations

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

V2_MISSING = ("cgroup v2 host: the v2 eBPF device controller (cgroup/ebpf.py) is not "
              "ported to gpumounter_tpu_torch yet, and a GPU is never mounted "
              "without a device grant")


__all__ = [
    "container_cgroup_dir", "detect_cgroup_driver", "detect_cgroup_version",
    "expand_slice", "get_cgroup_pids", "pod_cgroup_relpath", "pod_qos_class",
    "CgroupError", "V1DeviceController", "V2_MISSING",
]
