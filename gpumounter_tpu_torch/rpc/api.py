"""The worker's requests and results, without the wire.

The counterpart of ``gpumounter_tpu/rpc/api.py``, under the GPU names of the
original GPUMounter's ``pkg/api/gpu-mount/api.proto`` and with its values
(:12-39), which are also the reference's: RemoveGPUResult has no 3, and
GPUNotFound is 4. Requests are plain dataclasses; the proto3 codec and the
gRPC services come with the transport.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class AddGPUResult(enum.IntEnum):
    # AddGPUResponse.AddGPUResult (api.proto:12-17)
    Success = 0
    InsufficientGPU = 1
    PodNotFound = 2


class RemoveGPUResult(enum.IntEnum):
    # RemoveGPUResponse.RemoveGPUResult (api.proto:32-39)
    Success = 0
    GPUBusy = 1
    PodNotFound = 2
    GPUNotFound = 4


@dataclass
class AddGPURequest:
    # AddGPURequest (api.proto:4-9)
    pod_name: str
    namespace: str
    gpu_num: int
    is_entire_mount: bool = False


@dataclass
class AddGPUResponse:
    add_gpu_result: AddGPUResult
    uuids: list[str] = field(default_factory=list)
    #: the flow's phase timings (ms): slave_pod_schedule, mount, total
    phases_ms: dict[str, float] = field(default_factory=dict)


@dataclass
class RemoveGPURequest:
    # RemoveGPURequest (api.proto:25-30); remove_all removes every
    # slave-held GPU whatever the mount type.
    pod_name: str
    namespace: str
    uuids: list[str] = field(default_factory=list)
    force: bool = False
    remove_all: bool = False


@dataclass
class RemoveGPUResponse:
    remove_gpu_result: RemoveGPUResult
    phases_ms: dict[str, float] = field(default_factory=dict)
