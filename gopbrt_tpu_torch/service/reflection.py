"""gRPC server reflection (v1 + v1alpha), hand-rolled.

Counterpart of ``gopbrt_tpu/service/reflection.py``, of which it is a copy.
The reference daemon registers reflection so `grpcurl` works without proto
files (``cmd/pbrtd/main.go:28``).  The service needs no grpcio-reflection
package: the reflection *protocol* itself is implemented here with the
same hand codec style as service/proto.py: ServerReflectionInfo is a
bidi-streaming RPC whose requests/responses are small proto3 messages, and
the served FileDescriptorProto for render/service.proto is built
programmatically with google.protobuf.descriptor_pb2.  Only
``server.make_server`` imports this module, so the handler runs where grpc
is not installed.

Wire shapes (reflection.proto):
  ServerReflectionRequest  { host=1; file_by_filename=3;
                             file_containing_symbol=4; ...;
                             list_services=7; }
  ServerReflectionResponse { valid_host=1; original_request=2;
                             file_descriptor_response=4 {
                                repeated bytes file_descriptor_proto=1 };
                             list_services_response=6 {
                                repeated ServiceResponse service=1 {name=1} };
                             error_response=7 {error_code=1; error_message=2} }
"""

from __future__ import annotations

import grpc
from google.protobuf import descriptor_pb2

from gopbrt_tpu_torch.service.proto import _decode_varint, _encode_varint, _skip_field

V1_SERVICE = "grpc.reflection.v1.ServerReflection"
V1ALPHA_SERVICE = "grpc.reflection.v1alpha.ServerReflection"
PROTO_FILE = "render/service.proto"


def build_file_descriptor_proto() -> bytes:
    """FileDescriptorProto for render/service.proto (service.proto:1-19,
    plus the spp/max_depth/seed extension fields this server honours)."""
    f = descriptor_pb2.FileDescriptorProto()
    f.name = PROTO_FILE
    f.package = "render"
    f.syntax = "proto3"

    req = f.message_type.add()
    req.name = "RenderRequest"
    T = descriptor_pb2.FieldDescriptorProto

    def add(msg, name, num, ftype):
        fld = msg.field.add()
        fld.name = name
        fld.number = num
        fld.type = ftype
        fld.label = T.LABEL_OPTIONAL

    add(req, "scene_id", 1, T.TYPE_STRING)
    add(req, "time", 2, T.TYPE_DOUBLE)
    add(req, "width", 3, T.TYPE_INT32)
    add(req, "height", 4, T.TYPE_INT32)
    add(req, "spp", 5, T.TYPE_INT32)
    add(req, "max_depth", 6, T.TYPE_INT32)
    add(req, "seed", 7, T.TYPE_INT64)

    resp = f.message_type.add()
    resp.name = "RenderResponse"
    add(resp, "path", 1, T.TYPE_STRING)

    svc = f.service.add()
    svc.name = "Render"
    m = svc.method.add()
    m.name = "Render"
    m.input_type = ".render.RenderRequest"
    m.output_type = ".render.RenderResponse"
    return f.SerializeToString()


def _ld(field_num: int, payload: bytes) -> bytes:
    """length-delimited field."""
    return _encode_varint(field_num << 3 | 2) + _encode_varint(len(payload)) + payload


def _parse_request(buf: bytes) -> dict:
    out = {}
    i = 0
    while i < len(buf):
        tag, i = _decode_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 2 and field in (1, 3, 4, 6, 7):
            ln, i = _decode_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
            key = {
                1: "host",
                3: "file_by_filename",
                4: "file_containing_symbol",
                6: "all_extension_numbers_of_type",
                7: "list_services",
            }[field]
            out[key] = val.decode(errors="replace")
        else:
            i = _skip_field(buf, i, wt)
    return out


class _ReflectionCodec:
    """Raw-bytes passthrough so one handler serves both v1 and v1alpha."""

    @staticmethod
    def FromString(b: bytes) -> bytes:
        return b

    @staticmethod
    def SerializeToString(b: bytes) -> bytes:
        return b


def _make_servicer(service_names):
    fdp = build_file_descriptor_proto()
    known_symbols = (
        "render.Render",
        "render.Render.Render",
        "render.RenderRequest",
        "render.RenderResponse",
    )

    def info(request_iterator, context):
        for raw in request_iterator:
            req = _parse_request(raw)
            body = _ld(2, raw)  # original_request echo
            if "list_services" in req:
                services = b"".join(
                    _ld(1, _ld(1, n.encode())) for n in service_names
                )
                body += _ld(6, services)
            elif "file_containing_symbol" in req or "file_by_filename" in req:
                want = req.get("file_containing_symbol", "")
                fname = req.get("file_by_filename", "")
                if want in known_symbols or fname == PROTO_FILE:
                    body += _ld(4, _ld(1, fdp))
                else:
                    err = (
                        _encode_varint(1 << 3) + _encode_varint(5)  # NOT_FOUND
                        + _ld(2, b"symbol not found")
                    )
                    body += _ld(7, err)
            else:
                err = (
                    _encode_varint(1 << 3) + _encode_varint(12)  # UNIMPLEMENTED
                    + _ld(2, b"not implemented")
                )
                body += _ld(7, err)
            yield body

    return info


def reflection_handlers(service_names):
    """Generic handlers exposing reflection under both v1 and v1alpha."""
    names = tuple(service_names) + (V1_SERVICE, V1ALPHA_SERVICE)
    info = _make_servicer(names)
    handlers = []
    for svc in (V1_SERVICE, V1ALPHA_SERVICE):
        rpc = grpc.stream_stream_rpc_method_handler(
            info,
            request_deserializer=_ReflectionCodec.FromString,
            response_serializer=_ReflectionCodec.SerializeToString,
        )
        handlers.append(
            grpc.method_handlers_generic_handler(
                svc, {"ServerReflectionInfo": rpc}
            )
        )
    return handlers
