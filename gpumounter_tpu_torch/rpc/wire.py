"""Hand-rolled protobuf (proto3) wire-format codec.

The counterpart of ``gpumounter_tpu/rpc/wire.py``, kept whole. It stands in
for the original GPUMounter's generated code (pkg/api/gpu-mount/api.pb.go)
with a small declarative codec: a message is a class with a FIELDS spec, and
encode/decode speak the real protobuf wire format, so the same codec talks to
the kubelet's pod-resources gRPC server (a real protobuf peer) and carries
the master <-> worker contract. The port adds sint32/sint64 (zigzag), which
the reference's codec does not take; nothing else differs.

Wire format essentials (proto3):
  tag = (field_number << 3) | wire_type
  wire_type 0 = varint (int32/int64/uint32/uint64/bool/enum; zigzag for sint*)
  wire_type 1 = 64-bit  (fixed64/double)
  wire_type 2 = length-delimited (string/bytes/embedded message/packed repeated)
  wire_type 5 = 32-bit  (fixed32/float)
Defaults are not sent; repeated scalars are written one tag each and read
packed or not; unknown fields are skipped on decode (forward compatibility).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any

VARINT, I64, LEN, I32 = 0, 1, 2, 5

_SCALAR_KINDS = frozenset({
    "int32", "int64", "uint32", "uint64", "bool", "enum",
    "sint32", "sint64",
    "string", "bytes", "double", "float", "fixed64", "fixed32",
})


def encode_varint(value: int) -> bytes:
    if value < 0:
        # proto3 negative int32/int64/enum are encoded as 10-byte two's
        # complement varints (64-bit sign extension).
        value += 1 << 64
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def zigzag_encode(value: int) -> int:
    """sint32/sint64: small magnitudes of either sign as small varints."""
    return (value << 1) ^ -1 if value < 0 else value << 1


def zigzag_decode(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def _to_signed64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _to_signed32(value: int) -> int:
    value &= 0xFFFFFFFFFFFFFFFF
    value = _to_signed64(value)
    # int32 fields arriving as 64-bit varints: truncate like protobuf does.
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


@dataclass(frozen=True)
class Field:
    number: int
    name: str
    kind: str               # one of _SCALAR_KINDS or "message"
    repeated: bool = False
    message: type | None = None  # for kind == "message"

    def __post_init__(self):
        if self.kind == "message":
            if self.message is None:
                raise ValueError(f"field {self.name}: message kind needs a class")
        elif self.kind not in _SCALAR_KINDS:
            raise ValueError(f"field {self.name}: unknown kind {self.kind}")


def _default_for(field: Field) -> Any:
    if field.repeated:
        return []
    if field.kind == "message":
        return None
    if field.kind in ("string",):
        return ""
    if field.kind == "bytes":
        return b""
    if field.kind == "bool":
        return False
    if field.kind in ("double", "float"):
        return 0.0
    return 0


class Message:
    """Base class: subclasses define FIELDS: list[Field]."""

    FIELDS: list[Field] = []
    __field_by_num: dict[int, Field]

    def __init__(self, **kwargs: Any):
        spec = {f.name: f for f in self.FIELDS}
        for f in self.FIELDS:
            setattr(self, f.name, _default_for(f))
        for k, v in kwargs.items():
            if k not in spec:
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    # ---- encoding ----

    def encode(self) -> bytes:
        out = bytearray()
        for f in self.FIELDS:
            value = getattr(self, f.name)
            if f.repeated:
                for item in value:
                    _encode_single(out, f, item)
            else:
                if _is_default(f, value):
                    continue  # proto3: defaults are omitted
                _encode_single(out, f, value)
        return bytes(out)

    # ---- decoding ----

    @classmethod
    def decode(cls, data: bytes):
        msg = cls()
        by_num = {f.number: f for f in cls.FIELDS}
        pos = 0
        while pos < len(data):
            tag, pos = decode_varint(data, pos)
            num, wt = tag >> 3, tag & 7
            f = by_num.get(num)
            if f is None:
                pos = _skip(data, pos, wt)
                continue
            pos = _decode_into(msg, f, data, pos, wt)
        return msg

    # ---- ergonomics ----

    def __repr__(self) -> str:
        parts = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if f.repeated and not v:
                continue
            if not f.repeated and _is_default(f, v):
                continue
            parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    def __eq__(self, other: object) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, f.name) == getattr(other, f.name) for f in self.FIELDS)

    __hash__ = None  # mutable message: explicitly unhashable


def _is_default(f: Field, value: Any) -> bool:
    if f.kind == "message":
        return value is None
    return value == _default_for(f)


def _encode_single(out: bytearray, f: Field, value: Any) -> None:
    kind = f.kind
    if kind in ("int32", "int64", "uint32", "uint64", "bool", "enum"):
        out += encode_varint((f.number << 3) | VARINT)
        out += encode_varint(int(value))
    elif kind in ("sint32", "sint64"):
        out += encode_varint((f.number << 3) | VARINT)
        out += encode_varint(zigzag_encode(int(value)))
    elif kind == "string":
        payload = value.encode("utf-8")
        out += encode_varint((f.number << 3) | LEN)
        out += encode_varint(len(payload))
        out += payload
    elif kind == "bytes":
        out += encode_varint((f.number << 3) | LEN)
        out += encode_varint(len(value))
        out += bytes(value)
    elif kind == "message":
        payload = value.encode()
        out += encode_varint((f.number << 3) | LEN)
        out += encode_varint(len(payload))
        out += payload
    elif kind == "double":
        out += encode_varint((f.number << 3) | I64)
        out += struct.pack("<d", value)
    elif kind == "fixed64":
        out += encode_varint((f.number << 3) | I64)
        out += struct.pack("<Q", value)
    elif kind == "float":
        out += encode_varint((f.number << 3) | I32)
        out += struct.pack("<f", value)
    elif kind == "fixed32":
        out += encode_varint((f.number << 3) | I32)
        out += struct.pack("<I", value)
    else:  # pragma: no cover - guarded by Field.__post_init__
        raise AssertionError(kind)


def _decode_scalar(f: Field, data: bytes, pos: int, wt: int) -> tuple[Any, int]:
    kind = f.kind
    if wt == VARINT:
        raw, pos = decode_varint(data, pos)
        if kind == "bool":
            return bool(raw), pos
        if kind in ("int32", "enum"):
            return _to_signed32(raw), pos
        if kind == "int64":
            return _to_signed64(raw), pos
        if kind == "sint32":
            return _to_signed32(zigzag_decode(raw)), pos
        if kind == "sint64":
            return _to_signed64(zigzag_decode(raw) & 0xFFFFFFFFFFFFFFFF), pos
        return raw, pos  # uint32/uint64
    if wt == LEN:
        size, pos = decode_varint(data, pos)
        payload = data[pos:pos + size]
        if len(payload) != size:
            raise ValueError("truncated length-delimited field")
        pos += size
        if kind == "string":
            return payload.decode("utf-8"), pos
        if kind == "bytes":
            return payload, pos
        raise ValueError(f"unexpected LEN payload for {f.name}")
    if wt == I64:
        payload = data[pos:pos + 8]
        if len(payload) != 8:
            raise ValueError("truncated 64-bit field")
        pos += 8
        if kind == "double":
            return struct.unpack("<d", payload)[0], pos
        return struct.unpack("<Q", payload)[0], pos
    if wt == I32:
        payload = data[pos:pos + 4]
        if len(payload) != 4:
            raise ValueError("truncated 32-bit field")
        pos += 4
        if kind == "float":
            return struct.unpack("<f", payload)[0], pos
        return struct.unpack("<I", payload)[0], pos
    raise ValueError(f"unsupported wire type {wt}")


def _decode_into(msg: Message, f: Field, data: bytes, pos: int, wt: int) -> int:
    if f.kind == "message":
        if wt != LEN:
            raise ValueError(f"message field {f.name} with wire type {wt}")
        size, pos = decode_varint(data, pos)
        payload = data[pos:pos + size]
        if len(payload) != size:
            raise ValueError("truncated embedded message")
        pos += size
        value = f.message.decode(payload)
        if f.repeated:
            getattr(msg, f.name).append(value)
        else:
            setattr(msg, f.name, value)
        return pos

    # packed repeated scalars (proto3 default for numeric repeated fields)
    if f.repeated and wt == LEN and f.kind not in ("string", "bytes"):
        size, pos = decode_varint(data, pos)
        end = pos + size
        if end > len(data):
            raise ValueError("truncated packed field")
        elem_wt = (I64 if f.kind in ("double", "fixed64")
                   else I32 if f.kind in ("float", "fixed32") else VARINT)
        items = getattr(msg, f.name)
        while pos < end:
            value, pos = _decode_scalar(f, data, pos, elem_wt)
            items.append(value)
        return pos

    value, pos = _decode_scalar(f, data, pos, wt)
    if f.repeated:
        getattr(msg, f.name).append(value)
    else:
        setattr(msg, f.name, value)
    return pos


def _skip(data: bytes, pos: int, wt: int) -> int:
    if wt == VARINT:
        _, pos = decode_varint(data, pos)
        return pos
    if wt == I64:
        pos += 8
    elif wt == LEN:
        size, pos = decode_varint(data, pos)
        pos += size
    elif wt == I32:
        pos += 4
    else:
        raise ValueError(f"cannot skip wire type {wt}")
    if pos > len(data):
        raise ValueError("truncated field while skipping")
    return pos


