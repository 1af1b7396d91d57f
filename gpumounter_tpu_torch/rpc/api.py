"""The master <-> worker contract, on the wire.

The counterpart of ``gpumounter_tpu/rpc/api.py``, under the GPU names of the
original GPUMounter's ``pkg/api/gpu-mount/api.proto`` and with its values
(:12-39), which are also the reference's: RemoveGPUResult has no 3, and
GPUNotFound is 4. Field numbers are api.proto's (the reference's
``api.py:59-115``); field 6 of both requests, ``idempotency_key``, is the
reference's extension that makes the client's retries safe, and field 2 of
AddGPUResponse, ``uuids``, its extension that names what was mounted. A peer
built against the original proto skips both.

Field 7 of both requests, ``trace_context``, is the reference's too: the
client's ``rpc.<Method>`` span as ``<trace_id>-<span_id>`` (``obs/trace.py``),
which the worker's span takes as its parent; proto3 leaves the empty string
off the wire, so an untraced call's bytes are a peer's of the original
proto. Left out for the packages that carry them: ``prefer_ici`` (field 5,
ICI placement), ``epoch`` (8, ``master/shard.py``) and the share fields
(9-10, ``vchip/``). ``phases_ms`` is on no message of
the reference: it stays off the wire, an in-process reading of the worker's
phase timings.

Services and methods are the original's, ``gpu_mount.AddGPUService/AddGPU``
and ``gpu_mount.RemoveGPUService/RemoveGPU``, which the reference's worker
also registers (its legacy names), so the reference's client with
``legacy=True`` reaches this worker and this client reaches the reference's.
"""

from __future__ import annotations

import enum

from gpumounter_tpu_torch.rpc.wire import Field, Message


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


class AddGPURequest(Message):
    # AddGPURequest (api.proto:4-9), plus fields 6 and 7
    FIELDS = [
        Field(1, "pod_name", "string"),
        Field(2, "namespace", "string"),
        Field(3, "gpu_num", "int32"),
        Field(4, "is_entire_mount", "bool"),
        Field(6, "idempotency_key", "string"),
        Field(7, "trace_context", "string"),
    ]

    def __init__(self, pod_name: str = "", namespace: str = "", gpu_num: int = 0,
                 is_entire_mount: bool = False, idempotency_key: str = "",
                 trace_context: str = ""):
        super().__init__(pod_name=pod_name, namespace=namespace, gpu_num=gpu_num,
                         is_entire_mount=is_entire_mount, idempotency_key=idempotency_key,
                         trace_context=trace_context)


class AddGPUResponse(Message):
    # AddGPUResponse (api.proto:11-19), plus field 2
    FIELDS = [
        Field(1, "add_gpu_result", "enum"),
        Field(2, "uuids", "string", repeated=True),
    ]

    def __init__(self, add_gpu_result: int = AddGPUResult.Success, uuids=(),
                 phases_ms: dict | None = None):
        super().__init__(add_gpu_result=add_gpu_result, uuids=list(uuids))
        #: the flow's phase timings (ms): slave_pod_schedule, mount, total
        self.phases_ms = dict(phases_ms or {})


class RemoveGPURequest(Message):
    # RemoveGPURequest (api.proto:25-30), plus field 5 (the reference's:
    # remove every slave-held GPU whatever the mount type), fields 6 and 7
    FIELDS = [
        Field(1, "pod_name", "string"),
        Field(2, "namespace", "string"),
        Field(3, "uuids", "string", repeated=True),
        Field(4, "force", "bool"),
        Field(5, "remove_all", "bool"),
        Field(6, "idempotency_key", "string"),
        Field(7, "trace_context", "string"),
    ]

    def __init__(self, pod_name: str = "", namespace: str = "", uuids=(),
                 force: bool = False, remove_all: bool = False,
                 idempotency_key: str = "", trace_context: str = ""):
        super().__init__(pod_name=pod_name, namespace=namespace, uuids=list(uuids),
                         force=force, remove_all=remove_all,
                         idempotency_key=idempotency_key, trace_context=trace_context)


class RemoveGPUResponse(Message):
    # RemoveGPUResponse (api.proto:32-41)
    FIELDS = [
        Field(1, "remove_gpu_result", "enum"),
    ]

    def __init__(self, remove_gpu_result: int = RemoveGPUResult.Success,
                 phases_ms: dict | None = None):
        super().__init__(remove_gpu_result=remove_gpu_result)
        self.phases_ms = dict(phases_ms or {})


# gRPC names (api.proto:21-23, 43-45)
ADD_SERVICE = "gpu_mount.AddGPUService"
REMOVE_SERVICE = "gpu_mount.RemoveGPUService"
ADD_METHOD = "AddGPU"
REMOVE_METHOD = "RemoveGPU"
