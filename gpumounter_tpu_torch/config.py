"""Configuration of the worker's one-node mount path.

The counterpart of ``gpumounter_tpu/config/config.py``, holding only the
fields the device layer, the collector, the allocator, the cgroup layer and
the mounter read. Every field is an environment variable with the original
GPUMounter's value as default; the names are the reference's where the
meaning is the same. NVIDIA-specific: the resource ``nvidia.com/gpu``
(``pkg/util/gpu/types.go:10``), the pool namespace ``gpu-pool``
(``types.go:18``), and where a GPU's identity is read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass
class Config:
    # --- Kubernetes resource model ---
    gpu_resource_name: str = field(default_factory=lambda: _env(
        "GPU_RESOURCE_NAME", "nvidia.com/gpu"))
    pool_namespace: str = field(default_factory=lambda: _env(
        "GPU_POOL_NAMESPACE", "gpu-pool"))
    # Slave-pod image; the original uses an alpine sleep loop
    # (allocator.go:219-226).
    slave_pod_image: str = field(default_factory=lambda: _env(
        "SLAVE_POD_IMAGE", "alpine:latest"))

    # --- device layer ---
    # Where the GPU nodes live (/dev/nvidiaN, nvidiactl, nvidia-uvm*).
    # FAKE_DEVICE_DIR switches to a directory of fake nodes (dry runs).
    device_dir: str = field(default_factory=lambda: _env("DEVICE_DIR", "/dev"))
    fake_device_dir: str = field(default_factory=lambda: _env("FAKE_DEVICE_DIR", ""))
    # Which source ties a node to a GPU: "nvml" (libnvidia-ml through
    # ctypes, the original's nvml_dl.go path) or "procfs" (the driver's
    # /proc/driver/nvidia/gpus/<pci>/information).
    gpu_identity_source: str = field(default_factory=lambda: _env(
        "GPU_IDENTITY_SOURCE", "nvml"))
    nvml_library: str = field(default_factory=lambda: _env(
        "NVML_LIBRARY", "libnvidia-ml.so.1"))
    nvidia_procfs_dir: str = field(default_factory=lambda: _env(
        "NVIDIA_PROCFS_DIR", "/proc/driver/nvidia/gpus"))

    # --- cgroup layer ---
    # CGROUP_DRIVER in {systemd, cgroupfs} (cgroup.go:78-84); "auto" sniffs
    # /sys/fs/cgroup. CGROUP_VERSION "auto" detects v1 against v2.
    cgroup_driver: str = field(default_factory=lambda: _env("CGROUP_DRIVER", "auto"))
    cgroup_root: str = field(default_factory=lambda: _env("CGROUP_ROOT", "/sys/fs/cgroup"))
    cgroup_version: str = field(default_factory=lambda: _env("CGROUP_VERSION", "auto"))

    # --- allocator ---
    # The watch on a slave pod's phase ends after this long.
    slave_pod_timeout_s: float = field(default_factory=lambda: float(
        _env("SLAVE_POD_TIMEOUT_S", "120")))
    slave_pod_name_suffix: str = "-slave-pod-"
