"""The port's render service (``gopbrt_tpu_torch/service/``): every case of
``tests/test_service.py`` against the port's codec, handler and reflection,
the codec's bytes against the reference codec's, the handler's image
against ``render``, and a world-2 gloo mesh (rank 0 serves, rank 1
follows) against the single-process image.  The handler runs with
``device="cpu"`` at 8x8."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist_worker import spawn
from gopbrt_tpu.service import proto as jproto
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.service.proto import (RenderRequest, RenderResponse, _decode_varint,
                                            _encode_varint, _skip_field)
from gopbrt_tpu_torch.service.server import RenderService, make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=8, height=8, spp=2, max_depth=2)


def _dynamic_messages():
    """The reference schema through google.protobuf (tests/test_service.py:9-36)."""
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    fdp = descriptor_pb2.FileDescriptorProto()
    fdp.name = "svc_torch_test.proto"
    fdp.package = "render"
    fdp.syntax = "proto3"
    m = fdp.message_type.add()
    m.name = "RenderRequest"
    for i, (n, t) in enumerate([("scene_id", 9), ("time", 1), ("width", 5), ("height", 5)], 1):
        f = m.field.add()
        f.name, f.number, f.type, f.label = n, i, t, 1
    r = fdp.message_type.add()
    r.name = "RenderResponse"
    f = r.field.add()
    f.name, f.number, f.type, f.label = "path", 1, 9, 1
    pool = descriptor_pool.DescriptorPool()
    pool.Add(fdp)
    req = message_factory.GetMessageClass(pool.FindMessageTypeByName("render.RenderRequest"))
    resp = message_factory.GetMessageClass(pool.FindMessageTypeByName("render.RenderResponse"))
    return req, resp


def _png_pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class TestProtoCodec:
    def test_request_roundtrip_self(self):
        r = RenderRequest(scene_id="abc", time=1.5, width=640, height=360)
        assert RenderRequest.FromString(r.SerializeToString()) == r

    def test_request_interop_with_protobuf(self):
        PbReq, _ = _dynamic_messages()
        mine = RenderRequest(scene_id="s1", time=2.25, width=1920, height=1080)
        theirs = PbReq.FromString(mine.SerializeToString())
        assert (theirs.scene_id, theirs.time, theirs.width, theirs.height) == (
            "s1", 2.25, 1920, 1080)
        back = RenderRequest.FromString(PbReq(scene_id="x", time=0.5, width=7,
                                              height=9).SerializeToString())
        assert (back.scene_id, back.time, back.width, back.height) == ("x", 0.5, 7, 9)

    def test_response_interop(self):
        _, PbResp = _dynamic_messages()
        mine = RenderResponse(path="build/render-x.png")
        assert PbResp.FromString(mine.SerializeToString()).path == "build/render-x.png"
        back = RenderResponse.FromString(PbResp(path="a/b.png").SerializeToString())
        assert back.path == "a/b.png"

    def test_empty_and_defaults(self):
        assert RenderRequest.FromString(b"") == RenderRequest()
        assert RenderRequest(width=0).SerializeToString() == b""

    def test_unknown_fields_skipped(self):
        PbReq, _ = _dynamic_messages()
        # an extra varint field 99: tag 99<<3|0 = 792 -> [0x98, 0x06], value 42
        extra = PbReq(width=5).SerializeToString() + bytes([0x98, 0x06, 42])
        assert RenderRequest.FromString(extra).width == 5

    def test_garbage_raises(self):
        with pytest.raises(Exception):
            RenderRequest.FromString(b"\xff\xff\xff\xff")

    def test_spp_depth_superset_fields(self):
        PbReq, _ = _dynamic_messages()
        mine = RenderRequest(scene_id="demo", width=4, height=4, spp=7, max_depth=3)
        theirs = PbReq.FromString(mine.SerializeToString())  # 5/6 -> unknown
        assert theirs.width == 4 and theirs.scene_id == "demo"
        back = RenderRequest.FromString(mine.SerializeToString())
        assert back.spp == 7 and back.max_depth == 3

    @pytest.mark.parametrize("seed", [0, 5, 2**31 + 77, -3])
    def test_seed_superset_field(self, seed):
        PbReq, _ = _dynamic_messages()
        mine = RenderRequest(scene_id="demo", width=4, spp=7, seed=seed)
        wire = mine.SerializeToString()
        assert RenderRequest.FromString(wire) == mine
        # field 7, unknown to the Go daemon's schema, skipped by it
        assert PbReq.FromString(wire).width == 4
        if seed == 0:  # the default is not on the wire: a request without it
            assert wire == RenderRequest(scene_id="demo", width=4, spp=7).SerializeToString()


@pytest.mark.parametrize("fields", [
    {}, dict(scene_id="cornell", time=0.25, width=1920, height=1080),
    dict(scene_id="mesh", width=64, height=36, spp=4, max_depth=3),
    dict(scene_id="été", time=-1.0, width=1 << 20, height=3, spp=300),
], ids=["empty", "cornell", "superset", "utf8-large"])
def test_codec_bytes_match_the_reference(fields):
    mine = RenderRequest(**fields).SerializeToString()
    assert mine == jproto.RenderRequest(**fields).SerializeToString()
    assert RenderRequest.FromString(mine) == RenderRequest(**fields)
    resp = RenderResponse(path=fields.get("scene_id", "") + ".png")
    assert resp.SerializeToString() == jproto.RenderResponse(path=resp.path).SerializeToString()


def test_importing_the_server_imports_no_grpc():
    code = ("import sys, gopbrt_tpu_torch.service.server; "
            "bad = [m for m in sys.modules if m == 'grpc' or m.startswith('grpc.') "
            "or m.startswith('google.protobuf')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("fields", [SMALL, dict(SMALL, scene_id="cornell", time=0.5),
                                    dict(SMALL, scene_id="nope")],
                         ids=["demo", "cornell", "unknown-id"])
def test_handler_image_equals_render(tmp_path, fields):
    svc = RenderService(device="cpu", out_dir=str(tmp_path))
    req = RenderRequest.FromString(RenderRequest(**fields).SerializeToString())
    scene, camera, settings = svc.job(req)
    assert (settings.width, settings.height, settings.spp, settings.max_depth) == (8, 8, 2, 2)
    ref = trender.render(scene, camera, settings, device="cpu")
    torch.testing.assert_close(svc.image(req), ref, rtol=0, atol=0)
    resp = RenderResponse.FromString(svc.render(req, None).SerializeToString())
    assert os.path.dirname(resp.path) == str(tmp_path)
    np.testing.assert_array_equal(_png_pixels(resp.path),
                                  torch.round(ref.clamp(0, 1) * 255).to(torch.uint8).numpy())
    if fields.get("scene_id") == "nope":  # unknown ids render the demo
        torch.testing.assert_close(ref, svc.image(RenderRequest(**SMALL)), rtol=0, atol=0)


def test_empty_request_is_the_demo_request():
    svc = RenderService(device="cpu")
    scene, camera, settings = svc.job(RenderRequest())
    assert (settings.width, settings.height, settings.spp, settings.max_depth,
            settings.samples_per_pass) == (1920, 1080, 16, 10, 1)
    assert camera.shutter_open == 0.0 and camera.shutter_close == 1.0
    _, cam2, _ = svc.job(RenderRequest(time=0.3))
    assert cam2.shutter_open == cam2.shutter_close == float(np.float32(0.3))
    assert svc.job(RenderRequest(scene_id="demo"))[0] is scene  # built once per id


class TestServiceHandler:
    def test_render_rpc_in_process(self, tmp_path):
        """The real grpc server on a scratch port renders 8x8."""
        import grpc

        svc = RenderService(device="cpu", out_dir=str(tmp_path))
        server = make_server(port=0, service=svc)
        port = server.add_insecure_port("localhost:0")
        server.start()
        try:
            chan = grpc.insecure_channel(f"localhost:{port}")
            stub = chan.unary_unary(
                "/render.Render/Render",
                request_serializer=RenderRequest.SerializeToString,
                response_deserializer=RenderResponse.FromString,
            )
            resp = stub(RenderRequest(time=0.5, **SMALL), timeout=560)
            assert resp.path.endswith(".png")
            assert _png_pixels(resp.path).shape == (8, 8, 3)
            chan.close()
        finally:
            server.stop(grace=None)


class TestReflection:
    """The hand-rolled server reflection (service/reflection.py)."""

    @staticmethod
    def _start():
        import grpc

        server = make_server(port=0, service=RenderService(device="cpu"))
        port = server.add_insecure_port("localhost:0")
        server.start()
        return server, grpc.insecure_channel(f"localhost:{port}")

    @staticmethod
    def _call(chan, service, payload: bytes) -> bytes:
        stub = chan.stream_stream(f"/{service}/ServerReflectionInfo",
                                  request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
        return next(iter(stub(iter([payload]), timeout=30)))

    @staticmethod
    def _parse_response(buf: bytes) -> dict:
        out, i = {}, 0
        while i < len(buf):
            tag, i = _decode_varint(buf, i)
            field, wt = tag >> 3, tag & 7
            if wt == 2:
                ln, i = _decode_varint(buf, i)
                out[field] = buf[i:i + ln]
                i += ln
            else:
                i = _skip_field(buf, i, wt)
        return out

    @pytest.mark.parametrize("service", ["grpc.reflection.v1.ServerReflection",
                                         "grpc.reflection.v1alpha.ServerReflection"])
    def test_list_services(self, service):
        server, chan = self._start()
        try:
            payload = _encode_varint(7 << 3 | 2) + _encode_varint(1) + b"*"
            resp = self._parse_response(self._call(chan, service, payload))
            assert 6 in resp and b"render.Render" in resp[6]
        finally:
            server.stop(grace=None)

    def test_file_containing_symbol(self):
        from google.protobuf import descriptor_pb2

        server, chan = self._start()
        try:
            sym = b"render.Render"
            payload = bytes([4 << 3 | 2, len(sym)]) + sym
            resp = self._parse_response(
                self._call(chan, "grpc.reflection.v1.ServerReflection", payload))
            assert 4 in resp
            fdp = descriptor_pb2.FileDescriptorProto.FromString(
                self._parse_response(resp[4])[1])
            assert fdp.package == "render" and fdp.service[0].name == "Render"
            names = [f.name for f in fdp.message_type[0].field]
            assert names == ["scene_id", "time", "width", "height", "spp", "max_depth",
                             "seed"]
        finally:
            server.stop(grace=None)

    def test_unknown_symbol_errors(self):
        server, chan = self._start()
        try:
            sym = b"nope.Nothing"
            payload = bytes([4 << 3 | 2, len(sym)]) + sym
            resp = self._parse_response(
                self._call(chan, "grpc.reflection.v1alpha.ServerReflection", payload))
            assert 7 in resp  # error_response (NOT_FOUND)
        finally:
            server.stop(grace=None)


def test_world_two_serves_the_single_process_image(tmp_path):
    """Rank 0's handler with rank 1 following (gloo, the CPU) gives the
    single-process images, band film and all."""
    requests = [dict(SMALL, height=6), dict(SMALL, scene_id="cornell", time=0.5)]
    res = spawn(2, {"mesh": (2, 1), "service": {"requests": requests}}, tmp_path)
    svc = RenderService(device="cpu")
    for i, kw in enumerate(requests):
        np.testing.assert_allclose(res[0][f"image{i}"].numpy(),
                                   svc.image(RenderRequest(**kw)).numpy(), rtol=0, atol=2e-5)
    assert _png_pixels(res[0]["path"]).shape == (6, 8, 3)


def test_the_seed_is_the_renders_and_the_png_a_span_of_the_call(tmp_path):
    """A request's seed is its render's seed (0, the default, renders as
    before the field); ``render_image`` returns the image its PNG holds, and
    the call is one request of the tracer: the render's spans, then
    ``service.png``."""
    from gopbrt_tpu_torch.utils import trace

    svc = RenderService(device="cpu", out_dir=str(tmp_path))
    scene, camera, settings = svc.job(RenderRequest(seed=12345, **SMALL))
    assert settings.seed == 12345 and svc.job(RenderRequest(**SMALL))[2].seed == 0
    trace.enable()
    try:
        resp, img = svc.render_image(RenderRequest(seed=12345, **SMALL))
    finally:
        trace.disable()
    ref = trender.render(scene, camera, settings, device="cpu")
    torch.testing.assert_close(img, ref, rtol=0, atol=0)
    assert not torch.equal(img, svc.image(RenderRequest(**SMALL)))
    np.testing.assert_array_equal(_png_pixels(resp.path),
                                  torch.round(ref.clamp(0, 1) * 255).to(torch.uint8).numpy())
    req = trace.requests()[-1]
    names = [s.name for s in req.spans]
    assert names[0] == names[1] == trace.REQUEST and names[-1] == "service.png"
    assert "render.li" in names and req.spans[-1].parent == 0


def test_sphereflake_id_is_the_spd_flake():
    """The registry's ``sphereflake``: Haines' SPD balls at size factor 4
    under balls.c's view, built once."""
    from gopbrt_tpu_torch.models import spd

    svc = RenderService(device="cpu")
    scene, camera, settings = svc.job(RenderRequest(scene_id="sphereflake", **SMALL))
    assert scene.prims.count == 7383 and scene.fastinfo.mesh_ok and scene.mesh is not None
    want = spd.sphereflake_camera(8, 8, device="cpu")
    torch.testing.assert_close(camera.camera_to_world, want.camera_to_world)
    torch.testing.assert_close(camera.raster_to_camera, want.raster_to_camera)
    assert svc.job(RenderRequest(scene_id="sphereflake"))[0] is scene


def test_the_benchmark_client_reads_back_each_png(tmp_path, monkeypatch):
    """The benchmark's request client (``portbench/clients/request.py``):
    each response's PNG holds the 8-bit image of the developed one and is
    deleted; a PNG that holds another image, or a damaged one, raises."""
    import importlib.util
    import json
    import tempfile

    from gopbrt_tpu_torch.models import film

    path = os.path.join(REPO, "portbench", "clients", "request.py")
    spec = importlib.util.spec_from_file_location("portbench_client_request", path)
    client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(client)
    with open(os.path.join(REPO, "portbench", "traffic", "request-1080p-16spp-png.json")) as f:
        settings = {**json.load(f)["settings"], **SMALL}
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    frame = client.connect({"name": "demo"}, settings, "cpu")
    img = frame(12345)
    assert img.shape == (8, 8, 3) and float(img.max()) > 0
    (out_dir,) = tmp_path.iterdir()
    assert list(out_dir.iterdir()) == []  # each PNG deleted once read back

    png = film.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(client.png_pixels(png), film.to_uint8(img))
    data = bytearray(open(png, "rb").read())
    data[-20] ^= 1  # a byte of the compressed rows
    open(png, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        client.png_pixels(png)

    real = film.write_png
    monkeypatch.setattr(film, "write_png", lambda p, im: real(p, im * 0.5))
    with pytest.raises(ValueError, match="does not hold"):
        frame(12345)
