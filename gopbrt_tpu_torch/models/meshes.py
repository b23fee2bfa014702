"""Procedural triangle meshes and the BASELINE config-3 mesh scene.

Counterpart of ``gopbrt_tpu/models/meshes.py``: the generators return
(vertices f32[V,3], indices i32[F,3]) in object space, and
``build_mesh_scene`` is the workload of ``benchmarks/bench_mesh.py`` (a
tessellated sphere over a checker floor, plastic mesh, a point light and a
sphere lamp: 10,224 triangles and 10,226 prims at the defaults), which puts
the BVH (``pkg/accelerator/bvh.go``) under load.
"""

from __future__ import annotations

import math

import numpy as np

from gopbrt_tpu_torch.models import camera as cam_mod
from gopbrt_tpu_torch.models.scene import Scene, SceneBuilder
from gopbrt_tpu_torch.ops import geom


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


def torus(n_major: int, n_minor: int, R: float = 1.0, r: float = 0.35):
    """Torus: 2*n_major*n_minor triangles."""
    verts = []
    for i in range(n_major):
        u = 2.0 * math.pi * i / n_major
        cu, su = math.cos(u), math.sin(u)
        for j in range(n_minor):
            v = 2.0 * math.pi * j / n_minor
            cv, sv = math.cos(v), math.sin(v)
            verts.append(((R + r * cv) * cu, (R + r * cv) * su, r * sv))

    def at(i, j):
        return (i % n_major) * n_minor + (j % n_minor)

    idx = []
    for i in range(n_major):
        for j in range(n_minor):
            a, b = at(i, j), at(i + 1, j)
            c, d = at(i, j + 1), at(i + 1, j + 1)
            idx.append((a, b, c))
            idx.append((b, d, c))
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def heightfield(n: int, extent: float = 4.0, amp: float = 0.35, seed: int = 3):
    """Smooth random terrain patch on [-extent/2, extent/2]^2: 2(n-1)^2
    triangles."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent / 2.0, extent / 2.0, n, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    zz = np.zeros_like(xx)
    for k in range(1, 5):  # a few smooth octaves
        fx, fy = rng.uniform(0.5, 1.5, 2) * k
        ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
        zz += (amp / k) * np.sin(fx * xx * 2 + ph1) * np.cos(fy * yy * 2 + ph2)
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)

    def at(i, j):
        return i * n + j

    idx = []
    for i in range(n - 1):
        for j in range(n - 1):
            idx.append((at(i, j), at(i + 1, j), at(i, j + 1)))
            idx.append((at(i + 1, j), at(i + 1, j + 1), at(i, j + 1)))
    return verts, np.asarray(idx, np.int32)


def build_mesh_scene(n_lat: int = 72, n_lon: int = 72, accelerator: str = "bvh",
                     device=None, mesh_material: str = "plastic") -> Scene:
    """BASELINE config-3 scene: a tessellated-sphere mesh (default
    2*72*71 = 10,224 triangles) over a checkerboard floor, plastic mesh
    material + textured matte floor, one point light + one sphere area
    light (meshes.py:93-120).  Tables on ``device`` (None = the card).

    mesh_material: "plastic" (the config), or "metal", which the mesh
    megakernel does not take, so the same scene runs the general wavefront
    chain with the BVH intersection kernels."""
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
    return b.build(accelerator=accelerator, device=device)


def mesh_camera(width: int, height: int, device=None) -> cam_mod.Camera:
    return cam_mod.perspective_camera(
        geom.look_at([0.0, 2.2, 4.5], [0.0, 0.9, 0.0], [0.0, 1.0, 0.0]),
        width, height, fov_deg=45.0, device=device)
