"""Cameras: batched primary-ray generation.

Counterpart of ``gopbrt_tpu/models/camera.py`` (``Camera``,
``perspective_camera``, ``generate_rays``, ``pixel_spread``): the
raster->camera->world chain is built on the host as NewProjectiveCamera
does (camera.go:106-124); per ray it is two affine transforms.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gopbrt_tpu_torch import resolve_device
from gopbrt_tpu_torch.ops import geom
from gopbrt_tpu_torch.ops.geom import normalize
from gopbrt_tpu_torch.ops.sampling import concentric_sample_disk

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


def generate_rays(cam: Camera, p_film: torch.Tensor, u_lens: torch.Tensor):
    """Batched GenerateRay (camera.go:167-190): p_film[N,2] raster coords,
    u_lens[N,2] lens samples -> world-space (o[N,3], d[N,3])."""
    if cam.kind != CAM_PERSPECTIVE:
        raise NotImplementedError(
            "only the perspective camera is ported (ROADMAP open item 1.7)"
        )
    n = p_film.shape[0]
    zeros = torch.zeros((n, 1), dtype=torch.float32, device=p_film.device)
    p_cam = geom.apply_point(cam.raster_to_camera, torch.cat([p_film, zeros], -1))
    o = torch.zeros((n, 3), dtype=torch.float32, device=p_film.device)
    d = normalize(p_cam)
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
    camera.go:192-242)."""
    r2c = cam.raster_to_camera.cpu()
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
