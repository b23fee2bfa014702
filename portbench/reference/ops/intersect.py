"""The primitive table, its shape tags, and the hit record.

Counterpart of ``gopbrt_tpu/ops/intersect.py``: ``Primitives``,
``SurfaceInteraction``, the two-keyframe animation table (``AnimPrims``,
``anim_o2w``, ``_prim_xforms_at``), the per-shape hit geometry
(``_sphere_geometry``, ``_disk_geometry``, ``_triangle_geometry``; the rows
through ``geom.gather_rows``), ``surface_interaction`` (phase 2: the full
hit record of a known winner, at each lane's time on an animated scene)
and ``spawn_ray``.  The t-only shape tests (phase 1) live in
``ops/brute_intersect.py`` (plain PyTorch) and ``csrc/prim_test.cuh``
(CUDA).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.ops import geom
from reference.ops.geom import PI, gamma, normalize
from reference.ops.static_info import PrimInfo

# primitive type tags
SPHERE = 0
DISK = 1
TRIANGLE = 2


class AnimPrims(NamedTuple):
    """Two-keyframe motion of each primitive over the camera shutter (the
    working TransformedPrimitive + AnimatedTransform, primitive.go:82-129,
    transform.go:512-631): decomposed keyframes (``ops/quaternion``), so a
    lane's transform is a lerp and a slerp at its time."""

    t0: torch.Tensor  # f32[P,3] translation keyframes
    t1: torch.Tensor
    q0: torch.Tensor  # f32[P,4] rotation keyframes (x, y, z, w)
    q1: torch.Tensor  # sign-aligned to q0 (the shortest path)
    s0: torch.Tensor  # f32[P,4,4] scale / shear remainders
    s1: torch.Tensor
    animated: torch.Tensor  # bool[P]; False rows keep the static transform


def anim_o2w(anim: AnimPrims, i, time) -> torch.Tensor:
    """Object->world of primitives ``i`` (int64[N]) at ``time`` in [0, 1]
    (f32[N]) (AnimatedTransform.Interpolate, transform.go:564-631)."""
    from reference.ops import quaternion as quat

    dt = torch.clamp(time.to(torch.float32), 0.0, 1.0)
    t = geom.lerp(dt[..., None], anim.t0[i], anim.t1[i])
    q = quat.slerp(dt, anim.q0[i], anim.q1[i])
    s = geom.lerp(dt[..., None, None], anim.s0[i], anim.s1[i])
    m = quat.quat_to_matrix(q) @ s
    m[..., :3, 3] += t
    return m


def _prim_xforms_at(prims: "Primitives", i, time):
    """(o2w, w2o) f32[N,4,4] of primitives ``i`` (int64[N]) at the lanes'
    times; static primitives keep their build transforms exactly."""
    if prims.anim is None or time is None:
        return prims.obj_to_world[i], prims.world_to_obj[i]
    o2w_a = anim_o2w(prims.anim, i, time)
    w2o_a = torch.linalg.inv(o2w_a)
    is_anim = prims.anim.animated[i][..., None, None]
    return (torch.where(is_anim, o2w_a, prims.obj_to_world[i]),
            torch.where(is_anim, w2o_a, prims.world_to_obj[i]))


class Primitives(NamedTuple):
    """SoA primitive table.

    params layout (f32[P, 9]):
      sphere   [radius, z_min, z_max, phi_max_rad, 0...]      (object space)
      disk     [height, radius, inner_radius, phi_max_rad, 0...]
      triangle [p0x,p0y,p0z, p1x,p1y,p1z, p2x,p2y,p2z]        (world space)
    """

    prim_type: torch.Tensor  # int32[P]
    obj_to_world: torch.Tensor  # f32[P,4,4]
    world_to_obj: torch.Tensor  # f32[P,4,4]
    params: torch.Tensor  # f32[P,9]
    material_id: torch.Tensor  # int32[P]
    area_light_id: torch.Tensor  # int32[P], -1 = not an emitter
    reverse_orientation: torch.Tensor  # bool[P]
    pinfo: Optional[PrimInfo] = None
    # the medium interface (MediumAccessor, medium.go:15-25): the medium id
    # inside / outside each prim, -1 vacuum, -2 no transition (a prim
    # without an interface leaves the ray's medium as it is); None where the
    # scene declares no interface
    medium_inside: Optional[torch.Tensor] = None  # int32[P]
    medium_outside: Optional[torch.Tensor] = None  # int32[P]
    # the two-keyframe animation table; None where no primitive moves
    anim: Optional[AnimPrims] = None

    @property
    def count(self) -> int:
        return self.prim_type.shape[0]

    @property
    def types(self) -> tuple:
        return (SPHERE, DISK, TRIANGLE) if self.pinfo is None else self.pinfo.types


class SurfaceInteraction(NamedTuple):
    """SoA hit record (interaction.go:130-148), world space.  ``valid``
    masks misses; every other field is defined on missed lanes too."""

    valid: torch.Tensor  # bool[N]
    t: torch.Tensor  # f32[N]
    p: torch.Tensor  # f32[N,3]
    p_err: torch.Tensor  # f32[N,3]
    n: torch.Tensor  # f32[N,3]  geometric normal
    ns: torch.Tensor  # f32[N,3]  shading normal
    uv: torch.Tensor  # f32[N,2]
    dpdu: torch.Tensor  # f32[N,3]
    dpdv: torch.Tensor  # f32[N,3]
    wo: torch.Tensor  # f32[N,3]
    prim_idx: torch.Tensor  # int32[N]


def _phi(x, y):
    phi = torch.atan2(y, x)
    return torch.where(phi < 0.0, phi + 2.0 * PI, phi)


def _sphere_geometry(oo, od, t, params):
    """Object-space hit, partial derivatives and uv (sphere.go:137-167)."""
    radius, z_min, z_max, phi_max = params.unbind(-1)[:4]
    p = oo + od * t[..., None]
    p = p * (radius / torch.clamp(geom.length(p), min=1e-20))[..., None]
    # avoid the x = y = 0 degenerate phi (sphere.go:138-140)
    tiny = (torch.abs(p[..., 0]) < 1e-10) & (torch.abs(p[..., 1]) < 1e-10)
    p = torch.stack([torch.where(tiny, 1e-5 * radius, p[..., 0]), p[..., 1],
                     p[..., 2]], dim=-1)
    phi = _phi(p[..., 0], p[..., 1])
    theta = torch.arccos(torch.clamp(p[..., 2] / radius, -1.0, 1.0))
    theta_min = torch.arccos(torch.clamp(z_min / radius, -1.0, 1.0))
    theta_max = torch.arccos(torch.clamp(z_max / radius, -1.0, 1.0))
    u = phi / phi_max
    denom = theta_max - theta_min
    wide = torch.abs(denom) > 1e-12
    v = torch.where(wide, (theta - theta_min) / torch.where(wide, denom, 1.0), 0.0)
    z_radius = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    inv_zr = 1.0 / torch.clamp(z_radius, min=1e-20)
    cos_phi = p[..., 0] * inv_zr
    sin_phi = p[..., 1] * inv_zr
    dpdu = torch.stack([-phi_max * p[..., 1], phi_max * p[..., 0],
                        torch.zeros_like(phi)], dim=-1)
    dpdv = torch.stack([p[..., 2] * cos_phi, p[..., 2] * sin_phi,
                        -radius * torch.sin(theta)], dim=-1) * denom[..., None]
    uv = torch.stack([u, v], dim=-1)
    p_err = torch.abs(p) * gamma(5)
    return p, p_err, normalize(p), uv, dpdu, dpdv


def _disk_geometry(oo, od, t, params):
    """Object-space disk hit (disk.go:64-126)."""
    height, radius, inner_radius, phi_max = params.unbind(-1)[:4]
    p = oo + od * t[..., None]
    p = torch.stack([p[..., 0], p[..., 1], height.expand_as(p[..., 2])], dim=-1)
    phi = _phi(p[..., 0], p[..., 1])
    dist = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    u = phi / phi_max
    one_minus = radius - inner_radius
    v = torch.where(one_minus > 1e-12,
                    (radius - dist) / torch.clamp(one_minus, min=1e-12), 0.0)
    zero = torch.zeros_like(phi)
    dpdu = torch.stack([-phi_max * p[..., 1], phi_max * p[..., 0], zero], dim=-1)
    dpdv = torch.stack([p[..., 0], p[..., 1], zero], dim=-1) * torch.where(
        dist > 1e-12, (inner_radius - radius) / torch.clamp(dist, min=1e-12), 0.0
    )[..., None]
    n = torch.stack([zero, zero, torch.ones_like(phi)], dim=-1)
    uv = torch.stack([u, v], dim=-1)
    return p, torch.zeros_like(p), n, uv, dpdu, dpdv


def _triangle_geometry(o, d, t, params):
    """World-space triangle hit with barycentric uv."""
    p0, p1, p2 = params[..., 0:3], params[..., 3:6], params[..., 6:9]
    p = o + d * t[..., None]
    e1 = p1 - p0
    e2 = p2 - p0
    n = normalize(geom.cross(e1, e2), eps=1e-30)
    pvec = geom.cross(d, e2)
    det = geom.dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    tvec = o - p0
    u = geom.dot(tvec, pvec) * inv_det
    qvec = geom.cross(tvec, e1)
    v = geom.dot(d, qvec) * inv_det
    uv = torch.stack([u, v], dim=-1)
    return p, gamma(7) * torch.abs(p), n, uv, e1, e2


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of the 3x3 blocks of m [..., 4, 4], by cofactors."""
    a = m[..., :3, :3]
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))


def surface_interaction(prims: Primitives, hit, t, prim_idx, o, d,
                        time=None) -> SurfaceInteraction:
    """Phase 2: the world-space hit record of each lane's winner
    (sphere.go:172-187 and interaction.go's orientation rules).  With
    ``time`` (f32[N]) on an animated table, each winner's transforms are
    interpolated at its lane's time (TransformedPrimitive.Intersect,
    primitive.go:103-110)."""
    timed = prims.anim is not None and time is not None
    types = prims.types
    has_xf = SPHERE in types or DISK in types  # shapes stored in object space
    idx = prim_idx.long()
    ptype = prims.prim_type[idx]
    params = geom.gather_rows(prims.params, idx)
    rev = prims.reverse_orientation[idx]
    if has_xf:
        if timed:
            o2w, w2o = _prim_xforms_at(prims, idx, time)
        else:
            o2w = geom.gather_rows(prims.obj_to_world, idx)
            w2o = geom.gather_rows(prims.world_to_obj, idx)
        oo = geom.lane_point(w2o, o)
        od = geom.lane_vector(w2o, d)

    geos = []  # (lane mask, (p, p_err, n, uv, dpdu, dpdv)) per present type
    if SPHERE in types:
        geos.append((ptype == SPHERE, _sphere_geometry(oo, od, t, params)))
    if DISK in types:
        geos.append((ptype == DISK, _disk_geometry(oo, od, t, params)))
    if TRIANGLE in types:
        geos.append((ptype == TRIANGLE, _triangle_geometry(o, d, t, params)))

    def sel(k):
        acc = geos[-1][1][k]
        for m, g in geos[-2::-1]:
            acc = torch.where(m[..., None], g[k], acc)
        return acc

    p_l, perr_l, n_l, uv, dpdu_l, dpdv_l = (sel(k) for k in range(6))

    is_tri = ptype == TRIANGLE
    if has_xf:
        p_w, perr_w = geom.apply_point_error(o2w, p_l)
        perr_w = perr_w + geom.lane_vector(torch.abs(o2w), perr_l)
        n_w = normalize(geom.apply_normal(w2o, n_l), eps=1e-30)
        dpdu_w = geom.lane_vector(o2w, dpdu_l)
        dpdv_w = geom.lane_vector(o2w, dpdv_l)
        if TRIANGLE in types:
            # triangles are stored in world space: no transform
            m_tri = is_tri[..., None]
            p = torch.where(m_tri, p_l, p_w)
            p_err = torch.where(m_tri, perr_l, perr_w)
            n = torch.where(m_tri, n_l, n_w)
            dpdu = torch.where(m_tri, dpdu_l, dpdu_w)
            dpdv = torch.where(m_tri, dpdv_l, dpdv_w)
        else:
            p, p_err, n, dpdu, dpdv = p_w, perr_w, n_w, dpdu_w, dpdv_w
        # handedness per primitive, read per lane (of the lane's transform
        # where it moves)
        swap = _det3(o2w) < 0.0 if timed else (_det3(prims.obj_to_world) < 0.0)[idx]
        flip = rev ^ (swap & ~is_tri)
    else:
        p, p_err, n, dpdu, dpdv = p_l, perr_l, n_l, dpdu_l, dpdv_l
        flip = rev
    n = torch.where(flip[..., None], -n, n)
    return SurfaceInteraction(
        valid=hit, t=t, p=p, p_err=p_err, n=n, ns=n, uv=uv, dpdu=dpdu,
        dpdv=dpdv, wo=normalize(-d, eps=1e-30), prim_idx=prim_idx,
    )


def spawn_ray(si: SurfaceInteraction, d_new: torch.Tensor) -> torch.Tensor:
    """Robust origin of a ray leaving the surface (interaction.go:68
    SpawnRay + ray.go:57 OffsetRayOrigin)."""
    return geom.offset_ray_origin(si.p, si.p_err + 1e-4, si.n, d_new)
