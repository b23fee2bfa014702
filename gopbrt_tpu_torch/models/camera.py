"""Cameras: batched primary-ray generation.

Counterpart of ``gopbrt_tpu/models/camera.py``: ``Camera``, the
perspective, orthographic and look-at cameras, ``generate_rays``,
``pixel_spread``, and the light-tracing adjoints ``we``, ``pdf_we`` and
``sample_wi`` (camera.go:244-324).  The raster->camera->world chain is
built on the host as NewProjectiveCamera does (camera.go:106-124); per ray
it is two affine transforms.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gopbrt_tpu_torch import resolve_device
from gopbrt_tpu_torch.ops import geom
from gopbrt_tpu_torch.ops.geom import normalize
from gopbrt_tpu_torch.ops.sampling import concentric_sample_disk
from gopbrt_tpu_torch.utils import trace

CAM_PERSPECTIVE = 0
CAM_ORTHOGRAPHIC = 1


class Camera(NamedTuple):
    kind: int  # CAM_*
    raster_to_camera: torch.Tensor  # f32[4,4]
    camera_to_world: torch.Tensor  # f32[4,4]
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float


def _screen_to_raster(width, height, screen_window):
    (x0, y0), (x1, y1) = screen_window
    m = geom.scale(float(width), float(height), 1.0)
    m = geom.matmul(m, geom.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0))
    return geom.matmul(m, geom.translate([-x0, -y1, 0.0]))


def perspective_camera(
    camera_to_world,
    width: int,
    height: int,
    fov_deg: float = 90.0,
    screen_window=None,
    lens_radius: float = 0.0,
    focal_distance: float = 1e6,
    shutter_open: float = 0.0,
    shutter_close: float = 1.0,
    device=None,
) -> Camera:
    """NewPerspectiveCamera (camera.go:135-166); tensors on ``device``
    (None = the card)."""
    device = resolve_device(device)
    if screen_window is None:
        aspect = width / height
        if aspect > 1:
            screen_window = ((-aspect, -1.0), (aspect, 1.0))
        else:
            screen_window = ((-1.0, -1.0 / aspect), (1.0, 1.0 / aspect))
    cam_to_screen = geom.perspective(fov_deg, 1e-2, 1000.0)
    r2s = geom.inverse(_screen_to_raster(width, height, screen_window))
    r2c = geom.matmul(geom.inverse(cam_to_screen), r2s)
    c2w = torch.as_tensor(camera_to_world, dtype=torch.float32)
    return Camera(
        kind=CAM_PERSPECTIVE,
        raster_to_camera=r2c.to(device),
        camera_to_world=c2w.to(device),
        lens_radius=float(lens_radius),
        focal_distance=float(focal_distance),
        shutter_open=float(shutter_open),
        shutter_close=float(shutter_close),
    )


def orthographic_camera(camera_to_world, width: int, height: int, screen_window=None,
                        lens_radius: float = 0.0, focal_distance: float = 1e6,
                        device=None) -> Camera:
    """The orthographic camera (camera.py:85-105; the reference declares
    its projection, transform.go:501-502, but never built the camera)."""
    device = resolve_device(device)
    if screen_window is None:
        aspect = width / height
        screen_window = ((-aspect, -1.0), (aspect, 1.0)) if aspect > 1 else (
            (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect))
    cam_to_screen = geom.orthographic(0.0, 1.0)
    s2r = _screen_to_raster(width, height, screen_window)
    r2c = geom.matmul(geom.inverse(cam_to_screen), geom.inverse(s2r))
    c2w = torch.as_tensor(camera_to_world, dtype=torch.float32)
    return Camera(
        kind=CAM_ORTHOGRAPHIC,
        raster_to_camera=r2c.to(device),
        camera_to_world=c2w.to(device),
        lens_radius=float(lens_radius),
        focal_distance=float(focal_distance),
        shutter_open=0.0,
        shutter_close=1.0,
    )


def look_at_camera(eye, target, up, **kw) -> Camera:
    """LookAt + perspective (server.go:152-159's pattern)."""
    return perspective_camera(geom.look_at(eye, target, up), **kw)


def generate_rays(cam: Camera, p_film: torch.Tensor, u_lens: torch.Tensor):
    """Batched GenerateRay (camera.go:167-190): p_film[N,2] raster coords,
    u_lens[N,2] lens samples -> world-space (o[N,3], d[N,3]).  Perspective
    rays leave the origin through the film point; orthographic rays leave
    the film point along +z."""
    n = p_film.shape[0]
    zeros = torch.zeros((n, 1), dtype=torch.float32, device=p_film.device)
    p_cam = geom.apply_point(cam.raster_to_camera, torch.cat([p_film, zeros], -1))
    if cam.kind == CAM_PERSPECTIVE:
        o = torch.zeros((n, 3), dtype=torch.float32, device=p_film.device)
        d = normalize(p_cam)
    elif cam.kind == CAM_ORTHOGRAPHIC:
        o = p_cam
        d = trace.to_card([0.0, 0.0, 1.0], p_film.device).expand(n, 3)
    else:
        raise ValueError(f"unknown camera kind {cam.kind}")
    if cam.lens_radius > 0.0:
        # thin-lens depth of field (camera.go:173-186)
        p_lens = concentric_sample_disk(u_lens) * cam.lens_radius
        ft = cam.focal_distance / torch.clamp(d[:, 2], min=1e-8)
        p_focus = o + d * ft[:, None]
        o = torch.cat([p_lens, zeros], dim=-1)
        d = normalize(p_focus - o)
    o_w = geom.apply_point_affine(cam.camera_to_world, o)
    d_w = geom.apply_vector(cam.camera_to_world, d)
    return o_w, normalize(d_w)


def pixel_spread(cam: Camera):
    """Ray-cone parameters of one pixel, (width0, spread) as floats: the
    world-space footprint of a camera ray at hit distance t is
    ``width0 + spread * t`` (the wavefront stand-in for ray differentials,
    camera.go:192-242).  A camera on the card is copied to the host here,
    which synchronises (the tracer's ``host_syncs``)."""
    r2c = trace.to_host(cam.raster_to_camera)
    corners = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
    p0, p1 = geom.apply_point(r2c, corners)
    dx = (p1 - p0) * torch.tensor([1.0, 1.0, 0.0])
    pix = torch.sqrt(torch.clamp(geom.length_sq(dx), min=1e-30)) * (
        1.0 / math.sqrt(2.0)
    )
    if cam.kind != CAM_PERSPECTIVE:
        return float(pix), 0.0
    ang = pix / torch.sqrt(torch.clamp(geom.length_sq(p0), min=1e-30))
    return 0.0, float(ang)


# ---------------------------------------------------------------------------
# Light-tracing adjoints: We / PdfWe / SampleWi (camera.go:244-324), the
# camera as a sensor of importance We; perspective, as in the reference.
# ---------------------------------------------------------------------------


def _camera_frame(cam: Camera):
    """(position, forward) of the camera in world space."""
    c2w = cam.camera_to_world
    return c2w[:3, 3], normalize(c2w[:3, 2][None, :])[0]


def _lens_area(cam: Camera) -> float:
    """The lens's area in float32 (1 for a pinhole)."""
    if cam.lens_radius > 0.0:
        r = np.float32(cam.lens_radius)
        return float(np.float32(math.pi) * (r * r))
    return 1.0


def _film_area(cam: Camera, width: int, height: int) -> torch.Tensor:
    """Area of the film's image rectangle at z = 1 (camera.go:244-262)."""
    r2c = cam.raster_to_camera
    corners = torch.tensor([[0.0, 0.0, 0.0], [float(width), float(height), 0.0]],
                           device=r2c.device)
    p_min, p_max = geom.apply_point(r2c, corners)
    p_min = p_min / p_min[2]
    p_max = p_max / p_max[2]
    return torch.abs((p_max[0] - p_min[0]) * (p_max[1] - p_min[1]))


def we(cam: Camera, width: int, height: int, o, d):
    """Importance of the camera rays (o, d)[N] (PerspectiveCamera.We):
    1 / (A lensArea cos^4 theta) where the ray points at the film
    rectangle, else 0 -> (we f32[N], raster f32[N,2])."""
    _, forward = _camera_frame(cam)
    cos_t = geom.dot(d, forward.expand_as(d))
    w2c = geom.inverse(cam.camera_to_world)
    focus = cam.focal_distance if cam.lens_radius > 0.0 else 1.0
    safe_cos = torch.where(cos_t <= 0.0, 1.0, cos_t)
    p_focus_c = geom.apply_point_affine(w2c, o + d * (focus / safe_cos)[..., None])
    # camera -> raster is projective: apply_point divides by w
    p_rast = geom.apply_point(geom.inverse(cam.raster_to_camera), p_focus_c)
    in_x = (p_rast[..., 0] >= 0.0) & (p_rast[..., 0] < width)
    in_y = (p_rast[..., 1] >= 0.0) & (p_rast[..., 1] < height)
    valid = (cos_t > 0.0) & in_x & in_y
    cos2 = safe_cos * safe_cos
    w_val = 1.0 / (_film_area(cam, width, height) * _lens_area(cam) * cos2 * cos2)
    return torch.where(valid, w_val, 0.0), p_rast[..., :2]


def pdf_we(cam: Camera, width: int, height: int, o, d):
    """(pdf_pos, pdf_dir) of the camera sampling ray (o, d)
    (PerspectiveCamera.PdfWe): 1 / lensArea and 1 / (A cos^3)."""
    w_val, _ = we(cam, width, height, o, d)
    _, forward = _camera_frame(cam)
    cos_t = geom.dot(d, forward.expand_as(d))
    valid = w_val > 0.0
    safe_cos = torch.where(valid, cos_t, 1.0)
    pdf_pos = torch.where(valid, 1.0 / _lens_area(cam), 0.0)
    pdf_dir = torch.where(valid, 1.0 / (_film_area(cam, width, height) * safe_cos ** 3), 0.0)
    return pdf_pos, pdf_dir


def sample_wi(cam: Camera, width: int, height: int, ref_p, u_lens):
    """A direction from ref_p[N,3] to a point of the lens
    (PerspectiveCamera.SampleWi) -> (wi f32[N,3], we f32[N], pdf f32[N],
    the lens point in world space f32[N,3], raster f32[N,2])."""
    p_lens = concentric_sample_disk(u_lens) * cam.lens_radius
    p_lens_c = torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])], dim=-1)
    p_lens_w = geom.apply_point_affine(cam.camera_to_world, p_lens_c)
    to_cam = p_lens_w - ref_p
    dist = torch.sqrt(torch.clamp(geom.length_sq(to_cam), min=1e-20))
    wi = to_cam / dist[..., None]
    _, forward = _camera_frame(cam)
    # the lens's normal is the camera's forward axis
    cos_l = geom.dot(-wi, forward.expand_as(wi))
    pdf = (dist * dist) / torch.clamp(cos_l * _lens_area(cam), min=1e-20)
    w_val, p_rast = we(cam, width, height, p_lens_w, -wi)
    return wi, w_val, torch.where(cos_l > 1e-7, pdf, 0.0), p_lens_w, p_rast
