"""GPU device model.

The counterpart of ``gpumounter_tpu/device/tpu.py``, back in the NVIDIA form
of the original GPUMounter (``pkg/device/nvidia.go:10-41``: MinorNumber,
DeviceFilePath, UUID, State, PodName, Namespace; perm "rw", mode 666):

  * ``index`` is the NVML index (PCI order, what the NVIDIA device plugin's
    index strategy advertises) and ``minor`` is the driver's minor number.
    They are two numbers: on an 8-GPU host the two orders can differ.
  * major and minor always come from stat(2) on the node; nothing assumes
    major 195.
  * ``uuid`` is the GPU UUID (``GPU-...``), the device ID the NVIDIA device
    plugin advertises.
  * ``companions`` are the control nodes a CUDA process opens besides its
    GPU's node (``nvidiactl``, ``nvidia-uvm``, ``nvidia-uvm-tools``); they
    travel with every GPU into the container.
"""

from __future__ import annotations

import os
import stat as statmod
from dataclasses import dataclass, field

GPU_FREE_STATE = "GPU_FREE_STATE"            # nvidia.go:21
GPU_ALLOCATED_STATE = "GPU_ALLOCATED_STATE"  # nvidia.go:22

# cgroup device-permission string (nvidia.go:38).
DEVICE_CGROUP_PERMISSION = "rw"
# mknod file mode (nvidia.go:39).
DEVICE_FILE_MODE = 0o666


@dataclass(frozen=True)
class CompanionNode:
    """A device node that travels with every GPU into the container.

    CUDA opens ``nvidiactl`` and ``nvidia-uvm`` (and ``nvidia-uvm-tools``
    for profilers) besides the GPU's own node. They are shared by every GPU
    of the host: injected idempotently, never removed on unmount (alone
    they grant no GPU), and their cgroup rules ride with each GPU's grant
    so that revoking one GPU cannot break another's access to them.
    """
    rel_path: str              # path relative to /dev, e.g. "nvidiactl"
    major: int
    minor: int


@dataclass
class GpuDevice:
    index: int                 # NVML index (PCI order)
    device_path: str           # e.g. /dev/nvidia1 (or a fake path)
    major: int                 # from stat(2), never hardcoded
    minor: int                 # the driver's minor number, from stat(2)
    uuid: str                  # GPU UUID, "GPU-..."
    pci_bus_id: str = ""       # "" where the identity source gives none
    state: str = GPU_FREE_STATE
    pod_name: str = ""
    namespace: str = ""
    companions: list[CompanionNode] = field(default_factory=list)

    @property
    def basename(self) -> str:
        """The node's name, also its path relative to /dev."""
        return os.path.basename(self.device_path)

    def reset_state(self) -> None:
        # ResetState (nvidia.go:50-55)
        self.state = GPU_FREE_STATE
        self.pod_name = ""
        self.namespace = ""

    def mark_allocated(self, pod_name: str, namespace: str) -> None:
        self.state = GPU_ALLOCATED_STATE
        self.pod_name = pod_name
        self.namespace = namespace

    def __str__(self) -> str:
        return (f"GPU{self.index}[{self.uuid}] {self.device_path} "
                f"{self.major}:{self.minor} {self.state}"
                + (f" -> {self.namespace}/{self.pod_name}" if self.pod_name else ""))


def stat_device_numbers(path: str) -> tuple[int, int, bool]:
    """(major, minor, is_char_device) for a filesystem node."""
    st = os.stat(path)
    is_char = statmod.S_ISCHR(st.st_mode)
    rdev = st.st_rdev if is_char else 0
    return os.major(rdev), os.minor(rdev), is_char
