"""The plain reference of the ``sphereflake`` configuration: Eric Haines' SPD
sphereflake (``balls.c``, size factor 4: 7,381 plastic spheres, a matte
floor of two triangles, three point lights; 7,383 prims under a BVH) on the
reference's own builder and its own NumPy SAH tree, the rule copied from
``gopbrt_tpu_torch/models/spd.py``.

One departure from a plain build.  The frozen builder's fast-path gate
(``reference/models/scene.py``, of the program's commit d908b8a) still asks
the mesh megakernel's scenes for triangles with at most 32 other prims, a
limit of the JAX package's TPU kernel; the program's gate no longer does,
and sends the flake to kernel #5, whose plain twin is
``path_li_plain(accel="bvh")``.  Built plainly, the reference would send
the flake to its wavefront chain, which draws other random streams, so
``build_scene`` marks its scene's ``fastinfo`` with ``mesh_ok=True`` and
packs its mesh tables, as the program's builder does: the reference then
traces the flake with ``path_li_plain(accel="bvh")``, whose mathematics is
the frozen one, and the check holds #5 against it lane for lane."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from reference.models import camera as cam_mod
from reference.models.scene import Scene, SceneBuilder
from reference.ops import geom
from reference.ops import mesh_megakernel as ref_mesh

ROOT_RADIUS = 0.5
FLOOR_HALF_WIDTH = 12.0
LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))


def _axis_rotation(axis, angle: float) -> np.ndarray:
    """The right-handed rotation by ``angle`` about the unit ``axis``."""
    x, y, z = axis
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1.0 - math.cos(angle)) * (k @ k)


def objset() -> np.ndarray:
    """balls.c's nine child directions f64[9,3]."""
    s = 1.0 / math.sqrt(2.0)
    trio = np.array([[s, s, 0.0], [s, 0.0, -s], [0.0, s, -s]])
    trio = trio @ _axis_rotation((s, -s, 0.0), math.asin(2.0 / math.sqrt(6.0))).T
    return np.concatenate([trio @ _axis_rotation((0.0, 0.0, 1.0), 2.0 * math.pi * k / 3.0).T
                           for k in range(3)])


def _to_direction(dirs: np.ndarray) -> np.ndarray:
    """The shortest-arc rotation from +z to each unit direction."""
    out = np.empty((len(dirs), 3, 3))
    for i, d in enumerate(dirs):
        if d[2] >= 1.0:
            out[i] = np.eye(3)
        elif d[2] <= -1.0:
            out[i] = _axis_rotation((0.0, 1.0, 0.0), math.pi)
        else:
            axis = np.cross((0.0, 0.0, 1.0), d)
            out[i] = _axis_rotation(axis / np.linalg.norm(axis),
                                    math.acos(min(max(d[2], -1.0), 1.0)))
    return out


def sphereflake(size_factor: int = 4):
    """(centres f64[N,3], radii f64[N]) of the flake, level by level."""
    dirs9 = objset()
    centres, radii = [np.zeros((1, 3))], [np.full(1, ROOT_RADIUS)]
    directions = np.array([[0.0, 0.0, 1.0]])
    for _ in range(size_factor):
        c, r = centres[-1], radii[-1]
        u = np.einsum("pij,kj->pki", _to_direction(directions), dirs9)
        centres.append((c[:, None, :] + (r * (1.0 + 1.0 / 3.0))[:, None, None] * u)
                       .reshape(-1, 3))
        radii.append(np.repeat(r / 3.0, 9))
        directions = u.reshape(-1, 3)
    return np.concatenate(centres), np.concatenate(radii)


def build_scene(size_factor: int = 4, device=None, accelerator: str = "bvh") -> Scene:
    """The flake on the reference's builder, marked for the mesh kernel's
    plain twin (see the module's docstring).  Tables on ``device``."""
    b = SceneBuilder()
    ball = b.plastic(kd=(0.5, 0.45, 0.35), ks=(0.5, 0.5, 0.5), roughness=0.05)
    for c, r in zip(*sphereflake(size_factor)):
        b.sphere(np.asarray(geom.translate(c.tolist())), float(r), ball)
    floor = b.matte(kd=(0.8, 0.6, 0.264))
    h, z = FLOOR_HALF_WIDTH, -ROOT_RADIUS
    corners = np.array([[h, h, z], [-h, h, z], [-h, -h, z], [h, -h, z]], np.float32)
    b.triangle_mesh(np.eye(4, dtype=np.float32), corners,
                    np.array([[0, 1, 2], [0, 2, 3]], np.int32), floor)
    for p in LIGHTS:
        b.point_light(p=p, intensity=(sum(x * x for x in p) / 3.0,) * 3)
    scene = b.build(accelerator=accelerator, device=device)
    scene = scene._replace(fastinfo=dataclasses.replace(scene.fastinfo, mesh_ok=True))
    if ref_mesh.fits(scene):
        scene = scene._replace(mesh=ref_mesh.mesh_tables(scene))
    return scene


def build_camera(width: int, height: int, device=None) -> cam_mod.Camera:
    return cam_mod.perspective_camera(
        geom.look_at([2.1, 1.3, 1.7], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),
        width, height, fov_deg=45.0, device=device)
