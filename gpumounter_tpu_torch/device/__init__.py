"""The device layer: the host's NVIDIA GPUs and their nodes."""

from gpumounter_tpu_torch.device.backend import (
    COMPANIONS,
    DeviceBackend,
    FakeDeviceBackend,
    IdentityError,
    NvidiaDeviceBackend,
    NvmlIdentity,
    ProcfsIdentity,
    backend_from_config,
    scan_proc_for_device,
)
from gpumounter_tpu_torch.device.gpu import (
    GPU_ALLOCATED_STATE,
    GPU_FREE_STATE,
    CompanionNode,
    GpuDevice,
    stat_device_numbers,
)

__all__ = [
    "COMPANIONS", "DeviceBackend", "FakeDeviceBackend", "IdentityError",
    "NvidiaDeviceBackend", "NvmlIdentity", "ProcfsIdentity", "backend_from_config",
    "scan_proc_for_device", "GPU_ALLOCATED_STATE", "GPU_FREE_STATE", "CompanionNode",
    "GpuDevice", "stat_device_numbers",
]
