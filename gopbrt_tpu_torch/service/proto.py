"""Hand-rolled protobuf codec for the render service messages.

Wire-compatible with ``proto/render/service.proto``:

    message RenderRequest  { string scene_id = 1; double time = 2;
                             int32 width = 3; int32 height = 4; }
    message RenderResponse { string path = 1; }

plus three superset fields this server honours (unknown to the Go daemon,
skipped by it per proto3 rules): int32 spp = 5; int32 max_depth = 6;
int64 seed = 7 (the render's seed; 0, the default, renders as a request
without it).

(No protoc/grpc_tools code generation: these two messages are small
enough that a direct proto3 wire implementation is simpler and dependency-
free.  Counterpart of ``gopbrt_tpu/service/proto.py``, of which it is a copy:
the port imports nothing of ``gopbrt_tpu``.  Held against
``google.protobuf`` and the reference codec in tests/test_torch_service.py.)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _skip_field(buf: bytes, i: int, wire_type: int) -> int:
    if wire_type == 0:
        _, i = _decode_varint(buf, i)
    elif wire_type == 1:
        i += 8
    elif wire_type == 2:
        ln, i = _decode_varint(buf, i)
        i += ln
    elif wire_type == 5:
        i += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return i


@dataclass
class RenderRequest:
    scene_id: str = ""
    time: float = 0.0
    width: int = 0
    height: int = 0
    spp: int = 0
    max_depth: int = 0
    seed: int = 0

    def SerializeToString(self) -> bytes:
        out = bytearray()
        if self.scene_id:
            sid = self.scene_id.encode()
            out += b"\x0a" + _encode_varint(len(sid)) + sid
        if self.time != 0.0:
            out += b"\x11" + struct.pack("<d", self.time)
        if self.width:
            out += b"\x18" + _encode_varint(self.width)
        if self.height:
            out += b"\x20" + _encode_varint(self.height)
        if self.spp:
            out += b"\x28" + _encode_varint(self.spp)
        if self.max_depth:
            out += b"\x30" + _encode_varint(self.max_depth)
        if self.seed:
            out += b"\x38" + _encode_varint(self.seed)
        return bytes(out)

    @classmethod
    def FromString(cls, buf: bytes) -> "RenderRequest":
        msg = cls()
        i = 0
        while i < len(buf):
            tag, i = _decode_varint(buf, i)
            field, wt = tag >> 3, tag & 7
            if field == 1 and wt == 2:
                ln, i = _decode_varint(buf, i)
                msg.scene_id = buf[i : i + ln].decode()
                i += ln
            elif field == 2 and wt == 1:
                (msg.time,) = struct.unpack_from("<d", buf, i)
                i += 8
            elif field == 3 and wt == 0:
                msg.width, i = _decode_varint(buf, i)
            elif field == 4 and wt == 0:
                msg.height, i = _decode_varint(buf, i)
            elif field == 5 and wt == 0:
                msg.spp, i = _decode_varint(buf, i)
            elif field == 6 and wt == 0:
                msg.max_depth, i = _decode_varint(buf, i)
            elif field == 7 and wt == 0:
                seed, i = _decode_varint(buf, i)
                msg.seed = seed - (1 << 64) if seed >= 1 << 63 else seed
            else:
                i = _skip_field(buf, i, wt)
        return msg


@dataclass
class RenderResponse:
    path: str = ""

    def SerializeToString(self) -> bytes:
        out = bytearray()
        if self.path:
            p = self.path.encode()
            out += b"\x0a" + _encode_varint(len(p)) + p
        return bytes(out)

    @classmethod
    def FromString(cls, buf: bytes) -> "RenderResponse":
        msg = cls()
        i = 0
        while i < len(buf):
            tag, i = _decode_varint(buf, i)
            field, wt = tag >> 3, tag & 7
            if field == 1 and wt == 2:
                ln, i = _decode_varint(buf, i)
                msg.path = buf[i : i + ln].decode()
                i += ln
            else:
                i = _skip_field(buf, i, wt)
        return msg
