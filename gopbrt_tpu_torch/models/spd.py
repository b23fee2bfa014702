"""Eric Haines' Standard Procedural Databases (SPD): the sphereflake.

E. Haines, "A Proposal for Standard Graphics Environments", IEEE CG&A
7(11), 1987; the generator ``balls.c`` of
github.com/erich666/StandardProceduralDatabases.  A sphere of radius r
whose depth left is d > 0 carries nine children of radius r/3, each
tangent to it, in the nine directions of balls.c's ``objset`` turned from
+z onto the parent's own direction; at the default size factor 4 that is
1 + 9 + 81 + 729 + 6,561 = 7,381 spheres over a floor polygon, lit by
three lights: 7,382 objects.

``build_sphereflake_scene`` puts them on the port's builder under one BVH
with NFF's materials mapped onto plastic and matte, and
``sphereflake_camera`` is balls.c's view.  What the rule does not fix
(the floor as two triangles, the lights' intensities, the materials'
mapping, the missing background) is listed under ``assumed`` in the
benchmark's ``configs/sphereflake.json``.
"""

from __future__ import annotations

import math

import numpy as np

from gopbrt_tpu_torch.models import camera as cam_mod
from gopbrt_tpu_torch.models.scene import Scene, SceneBuilder
from gopbrt_tpu_torch.ops import geom

ROOT_RADIUS = 0.5
FLOOR_HALF_WIDTH = 12.0
LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
EYE, LOOK_AT, UP, FOV_DEG = (2.1, 1.3, 1.7), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 45.0


def _axis_rotation(axis, angle: float) -> np.ndarray:
    """The right-handed rotation by ``angle`` about the unit ``axis``
    (Rodrigues) -> f64[3,3]."""
    x, y, z = axis
    k = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1.0 - math.cos(angle)) * (k @ k)


def objset() -> np.ndarray:
    """balls.c's nine child directions f64[9,3]: the trio (1,1,0),
    (1,0,-1), (0,1,-1) over sqrt(2), turned about (1,-1,0)/sqrt(2) by
    asin(2/sqrt(6)), then taken at 0, 120 and 240 degrees about z.  Six lie
    on the equator at azimuths 15 + 60k degrees, three at z = sqrt(2/3)
    at azimuths 45, 165 and 285 degrees."""
    s = 1.0 / math.sqrt(2.0)
    trio = np.array([[s, s, 0.0], [s, 0.0, -s], [0.0, s, -s]])
    tilt = _axis_rotation((s, -s, 0.0), math.asin(2.0 / math.sqrt(6.0)))
    trio = trio @ tilt.T
    return np.concatenate([trio @ _axis_rotation((0.0, 0.0, 1.0), 2.0 * math.pi * k / 3.0).T
                           for k in range(3)])


def _to_direction(dirs: np.ndarray) -> np.ndarray:
    """For each unit direction f64[N,3], the rotation by the shortest arc
    that takes +z to it -> f64[N,3,3]."""
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
    """The spheres of the flake of depth ``size_factor`` -> (centres
    f64[N,3], radii f64[N]), level by level from the root (centre 0,
    radius 0.5, direction +z); N = (9^(size_factor+1) - 1) / 8."""
    if size_factor < 0:
        raise ValueError(f"size_factor must be >= 0, got {size_factor}")
    dirs9 = objset()
    centres, radii, directions = [np.zeros((1, 3))], [np.full(1, ROOT_RADIUS)], \
        np.array([[0.0, 0.0, 1.0]])
    for _ in range(size_factor):
        c, r = centres[-1], radii[-1]
        # u[p, k]: child k's direction of parent p
        u = np.einsum("pij,kj->pki", _to_direction(directions), dirs9)
        centres.append((c[:, None, :] + (r * (1.0 + 1.0 / 3.0))[:, None, None] * u)
                       .reshape(-1, 3))
        radii.append(np.repeat(r / 3.0, 9))
        directions = u.reshape(-1, 3)
    return np.concatenate(centres), np.concatenate(radii)


def sphereflake_builder(size_factor: int = 4) -> SceneBuilder:
    """The SceneBuilder of ``build_sphereflake_scene``, before its build."""
    b = SceneBuilder()
    # NFF "f 1 0.9 0.7 0.5 0.5 3 0 0": Kd x colour, Ks, a shiny lobe
    ball = b.plastic(kd=(0.5, 0.45, 0.35), ks=(0.5, 0.5, 0.5), roughness=0.05)
    for c, r in zip(*sphereflake(size_factor)):
        b.sphere(np.asarray(geom.translate(c.tolist())), float(r), ball)
    # NFF "f 1 0.75 0.33 0.8 0 0 0 0": the floor polygon, tangent to the root
    floor = b.matte(kd=(0.8, 0.6, 0.264))
    h, z = FLOOR_HALF_WIDTH, -ROOT_RADIUS
    corners = np.array([[h, h, z], [-h, h, z], [-h, -h, z], [h, -h, z]], np.float32)
    b.triangle_mesh(np.eye(4, dtype=np.float32), corners,
                    np.array([[0, 1, 2], [0, 2, 3]], np.int32), floor)
    # NFF's unattenuated unit lights: intensity |p|^2 / 3 gives the origin
    # an irradiance of about 1
    for p in LIGHTS:
        b.point_light(p=p, intensity=(sum(x * x for x in p) / 3.0,) * 3)
    return b


def build_sphereflake_scene(size_factor: int = 4, device=None,
                            accelerator: str = "bvh") -> Scene:
    """The SPD sphereflake (balls.c): 7,381 plastic spheres at the default
    size factor 4, a matte floor of two triangles and three point lights,
    under the SAH BVH.  Tables on ``device`` (None = the card)."""
    return sphereflake_builder(size_factor).build(accelerator=accelerator, device=device)


def sphereflake_camera(width: int, height: int, device=None) -> cam_mod.Camera:
    """balls.c's view: from (2.1, 1.3, 1.7) at the origin, z up, a 45
    degree field of view (its own image is 512 x 512)."""
    return cam_mod.perspective_camera(geom.look_at(list(EYE), list(LOOK_AT), list(UP)),
                                      width, height, fov_deg=FOV_DEG, device=device)
