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
proto. Field 8 of both requests, ``epoch`` (int64), is the reference's
fencing epoch: the worker refuses a mutation whose non-zero epoch is older
than the highest it has taken (FAILED_PRECONDITION "FENCED: ..."); a request
without it decodes to 0, which is never fenced. Left out for the packages
that carry them: ``prefer_ici`` (field 5, ICI placement) and the share
fields (9-10, ``vchip/``). ``phases_ms`` is on no message of
the reference: it stays off the wire, an in-process reading of the worker's
phase timings.

The reference's ``CollectTelemetry`` service (the fleet collector's pull:
field 1 ``trace_context``, field 2 ``quarantined`` of the request; fields
1-3 of the response) is here under ``gpu_mount.TelemetryService``, and its
``ProbeTPU`` (the canary's and the heal's eyes on a pod's accelerators) as
``gpu_mount.ProbeGPUService/ProbeGPU``, its messages the reference's field
for field (``ProbeGPURequest`` 1-3, ``ChipHealth`` 1-4, ``ProbeGPUResponse``
1-2), and its ``QuiesceStatus`` (the migration machine's read of the
tenant's ack) as ``gpu_mount.QuiesceStatusService/QuiesceStatus``, its
messages the reference's too (``QuiesceStatusRequest`` 1-3,
``QuiesceStatusResponse`` 1-5).

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
    # AddGPURequest (api.proto:4-9), plus fields 6-10. Fields 9-10 are the
    # reference's share policy: a share_weight > 0 makes every GPU of the
    # request a fractional grant (a policy entry of that weight and token
    # budget, 0 unmetered) recorded in the ledger's share records; 0, every
    # older caller's, keeps the whole-GPU grant
    FIELDS = [
        Field(1, "pod_name", "string"),
        Field(2, "namespace", "string"),
        Field(3, "gpu_num", "int32"),
        Field(4, "is_entire_mount", "bool"),
        Field(6, "idempotency_key", "string"),
        Field(7, "trace_context", "string"),
        Field(8, "epoch", "int64"),
        Field(9, "share_weight", "int32"),
        Field(10, "share_rate_budget", "int32"),
    ]

    def __init__(self, pod_name: str = "", namespace: str = "", gpu_num: int = 0,
                 is_entire_mount: bool = False, idempotency_key: str = "",
                 trace_context: str = "", epoch: int = 0, share_weight: int = 0,
                 share_rate_budget: int = 0):
        super().__init__(pod_name=pod_name, namespace=namespace, gpu_num=gpu_num,
                         is_entire_mount=is_entire_mount, idempotency_key=idempotency_key,
                         trace_context=trace_context, epoch=epoch, share_weight=share_weight,
                         share_rate_budget=share_rate_budget)


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
    # remove every slave-held GPU whatever the mount type), fields 6-8
    FIELDS = [
        Field(1, "pod_name", "string"),
        Field(2, "namespace", "string"),
        Field(3, "uuids", "string", repeated=True),
        Field(4, "force", "bool"),
        Field(5, "remove_all", "bool"),
        Field(6, "idempotency_key", "string"),
        Field(7, "trace_context", "string"),
        Field(8, "epoch", "int64"),
    ]

    def __init__(self, pod_name: str = "", namespace: str = "", uuids=(),
                 force: bool = False, remove_all: bool = False,
                 idempotency_key: str = "", trace_context: str = "", epoch: int = 0):
        super().__init__(pod_name=pod_name, namespace=namespace, uuids=list(uuids),
                         force=force, remove_all=remove_all,
                         idempotency_key=idempotency_key, trace_context=trace_context,
                         epoch=epoch)


class RemoveGPUResponse(Message):
    # RemoveGPUResponse (api.proto:32-41)
    FIELDS = [
        Field(1, "remove_gpu_result", "enum"),
    ]

    def __init__(self, remove_gpu_result: int = RemoveGPUResult.Success,
                 phases_ms: dict | None = None):
        super().__init__(remove_gpu_result=remove_gpu_result)
        self.phases_ms = dict(phases_ms or {})


# --- the fleet collector's pull (the reference's extension,
# gpumounter_tpu/rpc/api.py:189-247) ---
#
# The payload is one JSON document in a string field (``obs/fleet.py``'s
# tpumounter-telemetry/1): the rollup's shape changes faster than the wire
# should. A worker without the service answers UNIMPLEMENTED, and a payload
# that does not parse is treated the same: the collector scrapes the
# worker's /metrics instead.


class CollectTelemetryResult(enum.IntEnum):
    Success = 0


class CollectTelemetryRequest(Message):
    FIELDS = [
        Field(1, "trace_context", "string"),
        # the master's quarantine verdict on the node it dials: while true
        # the worker drains its warm holders and pauses their refill; absent
        # (an older master) is not quarantined
        Field(2, "quarantined", "bool"),
    ]

    def __init__(self, trace_context: str = "", quarantined: bool = False):
        super().__init__(trace_context=trace_context, quarantined=quarantined)


class CollectTelemetryResponse(Message):
    FIELDS = [
        Field(1, "collect_telemetry_result", "enum"),
        Field(2, "node_name", "string"),   # informational: the collector keys
                                           # by the node it dialed
        Field(3, "telemetry", "string"),   # the JSON snapshot
    ]

    def __init__(self, collect_telemetry_result: int = CollectTelemetryResult.Success,
                 node_name: str = "", telemetry: str = ""):
        super().__init__(collect_telemetry_result=collect_telemetry_result,
                         node_name=node_name, telemetry=telemetry)


# --- a pod's GPUs probed (the reference's extension,
# gpumounter_tpu/rpc/api.py:127-155) ---
#
# The canary's and the heal's eyes on a node: which GPUs the pod holds and
# whether each is alive. Alive: the host's node still stats as the same char
# device and the node injected into the target's /dev is still there;
# holder_count is the /proc scan's, so a caller tells a dead GPU a process
# still holds from an idle one.


class ProbeGPUResult(enum.IntEnum):
    Success = 0
    PodNotFound = 1


class ProbeGPURequest(Message):
    FIELDS = [
        Field(1, "pod_name", "string"),
        Field(2, "namespace", "string"),
        Field(3, "trace_context", "string"),
    ]

    def __init__(self, pod_name: str = "", namespace: str = "", trace_context: str = ""):
        super().__init__(pod_name=pod_name, namespace=namespace, trace_context=trace_context)


class ChipHealth(Message):
    # the reference's name: the persisted wire contract
    FIELDS = [
        Field(1, "uuid", "string"),
        Field(2, "healthy", "bool"),
        Field(3, "reason", "string"),
        Field(4, "holder_count", "int32"),
    ]

    def __init__(self, uuid: str = "", healthy: bool = False, reason: str = "",
                 holder_count: int = 0):
        super().__init__(uuid=uuid, healthy=healthy, reason=reason, holder_count=holder_count)


class ProbeGPUResponse(Message):
    FIELDS = [
        Field(1, "probe_gpu_result", "enum"),
        Field(2, "chips", "message", repeated=True, message=ChipHealth),
    ]

    def __init__(self, probe_gpu_result: int = ProbeGPUResult.Success, chips=()):
        super().__init__(probe_gpu_result=probe_gpu_result, chips=list(chips))


# --- the migration's read-back of the tenant (the reference's extension,
# gpumounter_tpu/rpc/api.py:160-185) ---
#
# The migration machine signals the tenant through the
# tpumounter.io/migration-phase annotation and reads the other side here:
# did the tenant ack the phase (it packs its state and stamps
# tpumounter.io/migration-ack), and does any process still hold the GPUs.
# The worker reads both: it resolves the pod's container and runs the /proc
# scan already.


class QuiesceStatusResult(enum.IntEnum):
    Success = 0
    PodNotFound = 1


class QuiesceStatusRequest(Message):
    FIELDS = [
        Field(1, "pod_name", "string"),
        Field(2, "namespace", "string"),
        Field(3, "trace_context", "string"),
    ]

    def __init__(self, pod_name: str = "", namespace: str = "", trace_context: str = ""):
        super().__init__(pod_name=pod_name, namespace=namespace, trace_context=trace_context)


class QuiesceStatusResponse(Message):
    FIELDS = [
        Field(1, "quiesce_status_result", "enum"),
        Field(2, "acked_id", "string"),      # the migration id the tenant acked
        Field(3, "acked_phase", "string"),   # "quiesced", "checkpointed", "resumed", ""
        Field(4, "holder_count", "int32"),   # the PIDs holding any of the GPUs
        Field(5, "chip_count", "int32"),     # the GPUs the pod holds
    ]

    def __init__(self, quiesce_status_result: int = QuiesceStatusResult.Success,
                 acked_id: str = "", acked_phase: str = "", holder_count: int = 0,
                 chip_count: int = 0):
        super().__init__(quiesce_status_result=quiesce_status_result, acked_id=acked_id,
                         acked_phase=acked_phase, holder_count=holder_count,
                         chip_count=chip_count)


# gRPC names (api.proto:21-23, 43-45); the telemetry, probe and quiesce
# services have no name in the original, and take its package's
ADD_SERVICE = "gpu_mount.AddGPUService"
REMOVE_SERVICE = "gpu_mount.RemoveGPUService"
TELEMETRY_SERVICE = "gpu_mount.TelemetryService"
PROBE_SERVICE = "gpu_mount.ProbeGPUService"
QUIESCE_SERVICE = "gpu_mount.QuiesceStatusService"
ADD_METHOD = "AddGPU"
REMOVE_METHOD = "RemoveGPU"
TELEMETRY_METHOD = "CollectTelemetry"
PROBE_METHOD = "ProbeGPU"
QUIESCE_METHOD = "QuiesceStatus"
