"""The plain reference of the ``mesh10k`` configuration: BASELINE config 3 at
its bench size (a 72 x 72 tessellated sphere, 10,224 plastic triangles, over
a checker floor, a point light and a sphere lamp: 10,226 prims under a BVH)
on the reference's own builder and its own NumPy SAH tree, copied from
``gopbrt_tpu_torch/models/meshes.py``."""

from __future__ import annotations

import math

import numpy as np

from reference.models import camera as cam_mod
from reference.models.scene import Scene, SceneBuilder
from reference.ops import geom


def uv_sphere(n_lat: int, n_lon: int, radius: float = 1.0):
    """Latitude/longitude tessellated sphere: 2*n_lon*(n_lat-1) triangles."""
    verts = [(0.0, 0.0, radius)]
    for i in range(1, n_lat):
        theta = math.pi * i / n_lat
        st, ct = math.sin(theta), math.cos(theta)
        for j in range(n_lon):
            phi = 2.0 * math.pi * j / n_lon
            verts.append((radius * st * math.cos(phi), radius * st * math.sin(phi),
                          radius * ct))
    verts.append((0.0, 0.0, -radius))
    south = len(verts) - 1

    def ring(i, j):
        return 1 + (i - 1) * n_lon + (j % n_lon)

    idx = []
    for j in range(n_lon):  # top cap
        idx.append((0, ring(1, j), ring(1, j + 1)))
    for i in range(1, n_lat - 1):  # body quads
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            idx.append((a, c, b))
            idx.append((b, c, d))
    for j in range(n_lon):  # bottom cap
        idx.append((south, ring(n_lat - 1, j + 1), ring(n_lat - 1, j)))
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def build_scene(n_lat: int = 72, n_lon: int = 72, accelerator: str = "bvh",
                     device=None, mesh_material: str = "plastic") -> Scene:
    """BASELINE config-3 scene: a tessellated-sphere mesh (default
    2*72*71 = 10,224 triangles) over a checkerboard floor, plastic mesh
    material + textured matte floor, one point light + one sphere area
    light (meshes.py:93-120).  Tables on ``device`` (None = the card).

    mesh_material: "plastic" (the config), or "metal", which the mesh
    megakernel does not take, so the same scene runs the general wavefront
    chain with the BVH intersection kernels."""
    return mesh_builder(n_lat, n_lon, mesh_material).build(accelerator=accelerator,
                                                           device=device)


def mesh_builder(n_lat: int = 72, n_lon: int = 72,
                 mesh_material: str = "plastic") -> SceneBuilder:
    """The SceneBuilder of ``build_mesh_scene``, before its build (its
    prims' bounds: ``ops/bvh._prim_bounds_np``)."""
    b = SceneBuilder()
    verts, idx = uv_sphere(n_lat, n_lon, radius=1.0)
    if mesh_material == "plastic":
        mat = b.plastic(kd=(0.25, 0.45, 0.8), ks=(0.6, 0.6, 0.6), roughness=0.12)
    elif mesh_material == "metal":
        mat = b.metal(f0=(0.95, 0.7, 0.3), roughness=0.12)
    else:
        raise ValueError(f"mesh_material must be 'plastic' or 'metal', got {mesh_material!r}")
    b.triangle_mesh(np.asarray(geom.matmul(geom.translate([0.0, 1.0, 0.0]),
                                           geom.rotate_x(-90.0))), verts, idx, mat)
    checker = b.checkerboard_texture((0.9, 0.9, 0.9), (0.15, 0.15, 0.15),
                                     vs=(1.0, 0.0, 0.0), vt=(0.0, 0.0, 1.0),
                                     mapping="planar")
    floor = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker)
    b.disk(np.asarray(geom.rotate_x(-90.0)), radius=50.0, material=floor)
    b.point_light(p=(4.0, 6.0, 4.0), intensity=(60.0, 60.0, 60.0))
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    lamp = b.sphere(np.asarray(geom.translate([-3.0, 4.0, 2.0])), 0.6, dark)
    b.area_light(lamp, radiance=(24.0, 22.0, 18.0), two_sided=False)
    return b


def build_camera(width: int, height: int, device=None) -> cam_mod.Camera:
    return cam_mod.perspective_camera(
        geom.look_at([0.0, 2.2, 4.5], [0.0, 0.9, 0.0], [0.0, 1.0, 0.0]),
        width, height, fov_deg=45.0, device=device)
