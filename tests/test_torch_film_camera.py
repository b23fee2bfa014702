"""The port's camera and film against gopbrt_tpu's."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import film as jfilm
from gopbrt_tpu.models import render as jrender
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import film as tfilm
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.ops import geom as tgeom

W, H = 64, 36


def _close(got, want, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("sampler,spp,sample", [
    ("stratified", 1, 0), ("stratified", 4, 3), ("stratified", 16, 9), ("random", 4, 2),
])
def test_camera_samples_match_jax(sampler, spp, sample):
    js = jrender.RenderSettings(width=W, height=H, spp=spp, sampler=sampler)
    ts = trender.RenderSettings(width=W, height=H, spp=spp, sampler=sampler)
    pixel = np.arange(W * H)
    jp, ju = jrender.camera_samples(js, jnp.asarray(pixel, jnp.uint32),
                                    jnp.full((W * H,), sample, jnp.uint32), jnp.uint32(5))
    tp, tu = trender.camera_samples(ts, torch.tensor(pixel),
                                    torch.full((W * H,), sample), 5)
    _close(tp, jp)
    _close(tu, ju)


def _cameras(lens):
    kw = dict(lens_radius=0.8, focal_distance=120.0) if lens else {}
    m = [[150.0, 150.0, 150.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]
    j = jcam.perspective_camera(jgeom.look_at(*m), W, H, fov_deg=100.0, **kw)
    t = tcam.perspective_camera(tgeom.look_at(*m), W, H, fov_deg=100.0,
                                device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("lens", [False, True])
def test_generate_rays_and_spread_match_jax(lens):
    jc, tc = _cameras(lens)
    r = np.random.default_rng(3)
    p_film = (r.random((500, 2)) * [W, H]).astype(np.float32)
    u_lens = r.random((500, 2)).astype(np.float32)
    jo, jd = jcam.generate_rays(jc, jnp.asarray(p_film), jnp.asarray(u_lens))
    to, td = tcam.generate_rays(tc, torch.tensor(p_film), torch.tensor(u_lens))
    _close(to, jo)
    _close(td, jd)
    jw, js = jcam.pixel_spread(jc)
    tw, ts = tcam.pixel_spread(tc)
    _close([tw, ts], [float(jw), float(js)])


def test_demo_camera_matches_jax():
    jc, tc = jdemo.build_demo_camera(W, H), tdemo.build_demo_camera(W, H, device="cpu")
    _close(tc.raster_to_camera, jc.raster_to_camera)
    _close(tc.camera_to_world, jc.camera_to_world)


@pytest.mark.parametrize("row0,rows", [(0, 16), (16, 16), (32, 16), (10, 7)])
def test_add_samples_rows_matches_jax(row0, rows):
    """Bands at the top, the middle and past the last row (the last band's
    rows beyond the image must drop), onto a film that already holds data."""
    r = np.random.default_rng(row0 + 100 * rows)
    base_rgb = r.random((H, W, 3)).astype(np.float32)
    base_w = r.random((H, W)).astype(np.float32)
    jitter = r.random((rows, W, 2)).astype(np.float32)
    L = (r.random((rows, W, 3)) * 4.0).astype(np.float32)
    jf = jfilm.add_samples_rows(
        jfilm.Film(rgb=jnp.asarray(base_rgb), weight=jnp.asarray(base_w)),
        jnp.int32(row0), jnp.asarray(jitter), jnp.asarray(L))
    tf = tfilm.add_samples_rows(
        tfilm.Film(rgb=torch.tensor(base_rgb), weight=torch.tensor(base_w)),
        row0, torch.tensor(jitter), torch.tensor(L))
    _close(tf.rgb, jf.rgb, atol=1e-5, rtol=1e-5)
    _close(tf.weight, jf.weight, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("gamma,compat_go", [(True, False), (False, False), (True, True)])
def test_develop_matches_jax(gamma, compat_go):
    r = np.random.default_rng(4)
    rgb = (r.random((H, W, 3)) * 3.0 - 0.5).astype(np.float32)
    w = r.random((H, W)).astype(np.float32)
    w[0, :5] = 0.0
    j = jfilm.develop(jfilm.Film(jnp.asarray(rgb), jnp.asarray(w)), gamma=gamma,
                      compat_go=compat_go)
    t = tfilm.develop(tfilm.Film(torch.tensor(rgb), torch.tensor(w)), gamma=gamma,
                      compat_go=compat_go)
    _close(t, j, atol=1e-5, rtol=1e-5)


def _decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB PNG with filter type 0 on every row -> uint8[H, W, 3]."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body)
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header[:4]
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(raw[:, 0] == 0)
    return raw[:, 1:].reshape(h, w, 3)


def test_write_png_decodes_to_jax_uint8(tmp_path):
    r = np.random.default_rng(5)
    img = (r.random((H, W, 3)) * 1.2 - 0.1).astype(np.float32)
    path = tfilm.write_png(str(tmp_path / "out.png"), torch.tensor(img))
    decoded = _decode_png(open(path, "rb").read())
    np.testing.assert_array_equal(decoded, jfilm.to_uint8(jnp.asarray(img)))
