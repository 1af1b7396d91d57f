"""The port's proto3 codec and messages against the reference's and against
google.protobuf's runtime.

The same field values, with the reference's TPU field names read as GPU
(``tpu_num`` is ``gpu_num``), must give the same bytes from both codecs, and
each codec must decode the other's bytes to the same values. All
comparisons are exact.
"""

from __future__ import annotations

import pytest

from gpumounter_tpu.collector import podresources as ref_pr
from gpumounter_tpu.rpc import api as ref_api
from gpumounter_tpu.rpc import health as ref_health
from gpumounter_tpu.rpc import wire as ref_wire
from gpumounter_tpu_torch.collector import podresources as pr
from gpumounter_tpu_torch.rpc import api, health, wire


def _ref_name(name: str) -> str:
    return name.replace("gpu", "tpu")


def _values(msg) -> dict:
    return {f.name: getattr(msg, f.name) for f in msg.FIELDS}


MESSAGES = [
    (api.AddGPURequest, ref_api.AddTPURequest, dict(
        pod_name="trainer", namespace="default", gpu_num=2, is_entire_mount=True,
        idempotency_key="add-0123456789abcdef")),
    (api.AddGPURequest, ref_api.AddTPURequest, dict(
        pod_name="trainer", namespace="default", gpu_num=1)),
    # a negative int32 is a 10-byte varint
    (api.AddGPURequest, ref_api.AddTPURequest, dict(pod_name="p", gpu_num=-3)),
    (api.AddGPURequest, ref_api.AddTPURequest, dict(pod_name="ünïcode-pod", gpu_num=2**31 - 1)),
    (api.AddGPURequest, ref_api.AddTPURequest, dict()),
    # fields 9-10, the share policy: a weight and a budget, and a negative
    # budget's 10-byte varint
    (api.AddGPURequest, ref_api.AddTPURequest, dict(
        pod_name="vc-decode", namespace="default", gpu_num=1, idempotency_key="add-s",
        epoch=3, share_weight=40, share_rate_budget=64)),
    (api.AddGPURequest, ref_api.AddTPURequest, dict(pod_name="p", share_weight=100,
                                                    share_rate_budget=-1)),
    (api.AddGPUResponse, ref_api.AddTPUResponse, dict(
        add_gpu_result=api.AddGPUResult.Success, uuids=["GPU-a", "GPU-b"])),
    (api.AddGPUResponse, ref_api.AddTPUResponse, dict(
        add_gpu_result=api.AddGPUResult.InsufficientGPU)),
    (api.AddGPUResponse, ref_api.AddTPUResponse, dict(add_gpu_result=api.AddGPUResult.PodNotFound)),
    (api.RemoveGPURequest, ref_api.RemoveTPURequest, dict(
        pod_name="trainer", namespace="ns", uuids=["GPU-a", "", "GPU-c"], force=True,
        remove_all=True, idempotency_key="rm-01")),
    (api.RemoveGPURequest, ref_api.RemoveTPURequest, dict(pod_name="trainer", uuids=["GPU-a"])),
    (api.RemoveGPUResponse, ref_api.RemoveTPUResponse, dict(
        remove_gpu_result=api.RemoveGPUResult.GPUNotFound)),
    (api.RemoveGPUResponse, ref_api.RemoveTPUResponse, dict(
        remove_gpu_result=api.RemoveGPUResult.GPUBusy)),
    (health.HealthCheckRequest, ref_health.HealthCheckRequest, dict(service="gpu_mount.X")),
    (health.HealthCheckResponse, ref_health.HealthCheckResponse, dict(status=health.SERVING)),
    (pr.ContainerDevices, ref_pr.ContainerDevices, dict(
        resource_name="nvidia.com/gpu", device_ids=["GPU-a", "0"])),
]


@pytest.mark.parametrize("port_cls, ref_cls, values", MESSAGES,
                         ids=lambda v: v.__name__ if isinstance(v, type) else None)
def test_same_bytes_and_decoded_both_ways(port_cls, ref_cls, values):
    ours = port_cls(**values)
    ref = ref_cls(**{_ref_name(k): v for k, v in values.items()})
    assert ours.encode() == ref.encode()
    back = port_cls.decode(ref.encode())
    assert back == ours and _values(back) == _values(ours)
    theirs = ref_cls.decode(ours.encode())
    assert {k: getattr(theirs, _ref_name(k)) for k in _values(ours)} == _values(ours)


def test_field_numbers_are_the_references():
    for port_cls, ref_cls, _ in MESSAGES:
        ref_fields = {f.number: (f.name, f.kind, f.repeated) for f in ref_cls.FIELDS}
        for f in port_cls.FIELDS:
            assert ref_fields[f.number] == (_ref_name(f.name), f.kind, f.repeated), \
                (port_cls.__name__, f)


def _pod_resources(mod):
    return mod.ListPodResourcesResponse(pod_resources=[
        mod.PodResources(name="trainer", namespace="default", containers=[
            mod.ContainerResources(name="main", devices=[
                mod.ContainerDevices(resource_name="nvidia.com/gpu", device_ids=["GPU-a"]),
                mod.ContainerDevices(resource_name="example.com/nic", device_ids=["n0"])]),
            mod.ContainerResources(name="side")]),
        mod.PodResources(name="slave", namespace="gpu-pool")])


def test_pod_resources_list_is_the_references_bytes():
    ours, ref = _pod_resources(pr), _pod_resources(ref_pr)
    assert ours.encode() == ref.encode()
    back = pr.ListPodResourcesResponse.decode(ref.encode())
    assert back == ours
    assert [c for p in back.pod_resources for c in pr.iter_device_claims([p], "nvidia.com/gpu")] \
        == [("trainer", "default", "GPU-a")]


def test_the_references_extra_fields_are_skipped():
    """A reference request with the field the port leaves out (prefer_ici,
    field 5) decodes to the fields it has, field 7 (trace_context), field 8
    (epoch) and the share fields 9-10 among them."""
    ref = ref_api.AddTPURequest(pod_name="p", namespace="n", tpu_num=3, is_entire_mount=True,
                                prefer_ici=True, idempotency_key="k", trace_context="t-s",
                                epoch=-7, share_weight=2, share_rate_budget=9)
    ours = api.AddGPURequest.decode(ref.encode())
    assert _values(ours) == dict(pod_name="p", namespace="n", gpu_num=3, is_entire_mount=True,
                                 idempotency_key="k", trace_context="t-s", epoch=-7,
                                 share_weight=2, share_rate_budget=9)
    assert 5 not in {f.number for f in api.AddGPURequest.FIELDS}
    ref_rm = ref_api.RemoveTPURequest(pod_name="p", uuids=["a"], trace_context="x", epoch=4)
    assert api.RemoveGPURequest.decode(ref_rm.encode()) == api.RemoveGPURequest(
        "p", uuids=["a"], trace_context="x", epoch=4)


def test_phases_stay_off_the_wire():
    resp = api.AddGPUResponse(api.AddGPUResult.Success, ["GPU-a"], phases_ms={"total": 1.5})
    assert resp.encode() == api.AddGPUResponse(api.AddGPUResult.Success, ["GPU-a"]).encode()
    assert api.AddGPUResponse.decode(resp.encode()).phases_ms == {}


class _Scalars(wire.Message):
    FIELDS = [wire.Field(1, "i32", "int32"), wire.Field(2, "i64", "int64"),
              wire.Field(3, "u64", "uint64"), wire.Field(4, "d", "double"),
              wire.Field(5, "f", "float"), wire.Field(6, "fx64", "fixed64"),
              wire.Field(7, "fx32", "fixed32"), wire.Field(8, "b", "bytes"),
              wire.Field(9, "nums", "int32", repeated=True),
              wire.Field(10, "s", "string")]


class _RefScalars(ref_wire.Message):
    FIELDS = [ref_wire.Field(f.number, f.name, f.kind, f.repeated) for f in _Scalars.FIELDS]


SCALARS = [dict(i32=-1, i64=-(2**63), u64=2**64 - 1, d=-0.5, f=0.25, fx64=2**63, fx32=7,
                b=b"\x00\xff", nums=[0, -1, 300], s="x"),
           dict(i32=2**31 - 1, i64=2**63 - 1, nums=[1]),
           dict()]


@pytest.mark.parametrize("values", SCALARS)
def test_every_wire_type_is_the_references(values):
    ours, ref = _Scalars(**values), _RefScalars(**values)
    assert ours.encode() == ref.encode()
    assert _values(_Scalars.decode(ref.encode())) == _values(ours)


@pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 2**32, 2**63 - 1, -1, -(2**63)])
def test_varints_are_the_references(value):
    assert wire.encode_varint(value) == ref_wire.encode_varint(value)
    raw, pos = wire.decode_varint(wire.encode_varint(value), 0)
    assert (raw, pos) == ref_wire.decode_varint(ref_wire.encode_varint(value), 0)
    assert len(wire.encode_varint(value)) == (10 if value < 0 else pos)


def test_packed_repeated_and_unknown_fields_of_every_wire_type():
    ev = wire.encode_varint
    payload = b"".join(ev(v) for v in [5, 6, 7])
    packed = ev((9 << 3) | wire.LEN) + ev(len(payload)) + payload
    unknown = (ev((20 << 3) | wire.VARINT) + ev(99)
               + ev((21 << 3) | wire.I64) + b"\x01" * 8
               + ev((22 << 3) | wire.LEN) + ev(3) + b"abc"
               + ev((23 << 3) | wire.I32) + b"\x02" * 4)
    data = unknown + packed + ev((1 << 3) | wire.VARINT) + ev(4)
    ours, ref = _Scalars.decode(data), _RefScalars.decode(data)
    assert ours.nums == ref.nums == [5, 6, 7] and ours.i32 == ref.i32 == 4


@pytest.mark.parametrize("data", [b"\x80", b"\x0a\x05ab", b"\x21\x00", b"\x2d\x00\x00"],
                         ids=["varint", "len", "i64", "i32"])
def test_truncated_input_is_refused_as_the_reference_refuses_it(data):
    with pytest.raises(ValueError) as ours:
        _Scalars.decode(data)
    with pytest.raises(ValueError) as ref:
        _RefScalars.decode(data)
    assert str(ours.value) == str(ref.value)


# --- google.protobuf's runtime as a third peer ---

def _protobuf_classes():
    pytest.importorskip("google.protobuf")
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory
    F = descriptor_pb2.FieldDescriptorProto
    pool = descriptor_pool.DescriptorPool()
    fdp = descriptor_pb2.FileDescriptorProto(name="gpu_mount.proto", package="gpu_mount",
                                             syntax="proto3")

    def message(name, fields):
        msg = fdp.message_type.add()
        msg.name = name
        for num, fname, ftype, repeated in fields:
            f = msg.field.add()
            f.name, f.number, f.type = fname, num, ftype
            f.label = F.LABEL_REPEATED if repeated else F.LABEL_OPTIONAL
            if ftype == F.TYPE_ENUM:
                f.type_name = ".gpu_mount.Result"

    enum = fdp.enum_type.add()
    enum.name = "Result"
    for i, n in [(0, "Success"), (1, "One"), (2, "Two"), (4, "Four")]:
        v = enum.value.add()
        v.name, v.number = n, i
    message("AddGPURequest", [(1, "pod_name", F.TYPE_STRING, False),
                              (2, "namespace", F.TYPE_STRING, False),
                              (3, "gpu_num", F.TYPE_INT32, False),
                              (4, "is_entire_mount", F.TYPE_BOOL, False),
                              (6, "idempotency_key", F.TYPE_STRING, False),
                              (7, "trace_context", F.TYPE_STRING, False),
                              (8, "epoch", F.TYPE_INT64, False),
                              (9, "share_weight", F.TYPE_INT32, False),
                              (10, "share_rate_budget", F.TYPE_INT32, False)])
    message("AddGPUResponse", [(1, "add_gpu_result", F.TYPE_ENUM, False),
                               (2, "uuids", F.TYPE_STRING, True)])
    message("RemoveGPURequest", [(1, "pod_name", F.TYPE_STRING, False),
                                 (2, "namespace", F.TYPE_STRING, False),
                                 (3, "uuids", F.TYPE_STRING, True),
                                 (4, "force", F.TYPE_BOOL, False),
                                 (5, "remove_all", F.TYPE_BOOL, False),
                                 (6, "idempotency_key", F.TYPE_STRING, False),
                                 (7, "trace_context", F.TYPE_STRING, False),
                                 (8, "epoch", F.TYPE_INT64, False)])
    message("Zigzag", [(1, "s32", F.TYPE_SINT32, False), (2, "s64", F.TYPE_SINT64, False)])
    pool.Add(fdp)
    return lambda name: message_factory.GetMessageClass(
        pool.FindMessageTypeByName(f"gpu_mount.{name}"))


PROTOBUF = [(api.AddGPURequest, dict(pod_name="p", namespace="ns", gpu_num=4,
                                     is_entire_mount=True, idempotency_key="k",
                                     trace_context="0123456789abcdef0123456789abcdef-0123456789abcdef")),
            (api.AddGPURequest, dict(pod_name="p", gpu_num=-2, epoch=-5)),
            (api.AddGPURequest, dict(pod_name="p", gpu_num=1, share_weight=40,
                                     share_rate_budget=64)),
            (api.AddGPUResponse, dict(add_gpu_result=2, uuids=["GPU-a", "GPU-b"])),
            (api.RemoveGPURequest, dict(pod_name="p", namespace="ns", uuids=["a", "b"],
                                        force=True, remove_all=False, idempotency_key="r",
                                        epoch=2**40 + 3))]


@pytest.mark.parametrize("cls, values", PROTOBUF, ids=lambda v: getattr(v, "__name__", None))
def test_the_protobuf_runtime_agrees(cls, values):
    pb = _protobuf_classes()(cls.__name__)(**values)
    ours = cls(**values)
    assert ours.encode() == pb.SerializeToString()
    assert _values(cls.decode(pb.SerializeToString())) == _values(ours)
    back = _protobuf_classes()(cls.__name__).FromString(ours.encode())
    assert {k: (list(v) if isinstance(v, list) else v) for k, v in _values(ours).items()} == \
        {f.name: (list(getattr(back, f.name)) if f.repeated else getattr(back, f.name))
         for f in cls.FIELDS}


class _Zigzag(wire.Message):
    FIELDS = [wire.Field(1, "s32", "sint32"), wire.Field(2, "s64", "sint64")]


@pytest.mark.parametrize("s32, s64", [(0, 0), (-1, 1), (1, -1), (-(2**31), 2**63 - 1),
                                      (2**31 - 1, -(2**63))])
def test_zigzag_is_the_protobuf_runtimes(s32, s64):
    pb = _protobuf_classes()("Zigzag")(s32=s32, s64=s64)
    ours = _Zigzag(s32=s32, s64=s64)
    assert ours.encode() == pb.SerializeToString()
    assert _values(_Zigzag.decode(pb.SerializeToString())) == dict(s32=s32, s64=s64)
