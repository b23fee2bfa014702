"""The plain reference of the ``demo`` configuration: go-pbrt's server scene
(``internal/render/server.go:30-164``) and camera on the reference's own
builder, copied from ``gopbrt_tpu_torch/models/demo.py``."""

from __future__ import annotations

from reference.models import camera as cam_mod
from reference.models.scene import Scene, SceneBuilder
from reference.ops import geom


def build_scene(device=None, accelerator: str = "none") -> Scene:
    """server.go:30-132, table-ized; tables on ``device`` (None = the card).
    Its 24 prims intersect by brute force, so it builds no BVH unless
    ``accelerator="bvh"`` asks for one."""
    b = SceneBuilder()
    n = 8
    radius = 2.0
    for k in range(1, n):
        for axis in range(3):
            x = y = z = 0.0
            if axis == 0:
                x = k / n * 100.0
                color = (1.0, 0.0, 0.0)
            elif axis == 1:
                y = k / n * 100.0
                color = (0.0, 1.0, 0.0)
            else:
                z = k / n * 100.0
                color = (0.0, 0.0, 1.0)
            y = max(y, radius / 2.0)
            mat = b.matte(kd=color, sigma=0.0)
            b.sphere(geom.translate([x, y, z]), radius, mat)

    # checkerboard floor disks (server.go:86-102)
    checker = b.checkerboard_texture(
        (1.0, 1.0, 1.0), (0.18, 0.18, 0.18),
        vs=(0.2, 0.0, 0.0), vt=(0.0, 0.0, 0.2), mapping="planar",
    )
    floor_mat = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker)
    disk_xform = geom.matmul(geom.translate([0.0, 0.0, 0.0]), geom.rotate_x(90.0))
    b.disk(disk_xform, radius=10000.0, material=floor_mat, height=0.01)
    b.disk(geom.translate([-50.0, 0.0, -50.0]), radius=10000.0,
           material=floor_mat, height=0.01)

    # lights (server.go:106-130)
    b.distant_light(direction=(-1.0, 1.0, 1.0), radiance=(0.05, 0.05, 0.05))
    b.point_light(p=(50.0, 20.0, 50.0), intensity=(100.0, 100.0, 100.0))
    b.point_light(p=(-50.0, 30.0, -50.0), intensity=(50.0, 50.0, 50.0))
    light_mat = b.matte(kd=(0.0, 0.0, 0.0))
    lp = b.sphere(geom.translate([-10.0, 5.0, 20.0]), 5.0, light_mat)
    b.area_light(lp, radiance=(0.2, 0.2, 0.2), two_sided=False)
    return b.build(accelerator=accelerator, device=device)


def build_camera(width: int, height: int, device=None) -> cam_mod.Camera:
    """server.go:152-159: LookAt(150,150,150 -> 0,0,0) * RotY(-30) * RotX(-30),
    fov=100, screen window [0,1]^2."""
    m = geom.look_at([150.0, 150.0, 150.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    m = geom.matmul(m, geom.rotate_y(-30.0))
    m = geom.matmul(m, geom.rotate_x(-30.0))
    return cam_mod.perspective_camera(
        m, width, height, fov_deg=100.0,
        screen_window=((0.0, 0.0), (1.0, 1.0)), device=device,
    )
