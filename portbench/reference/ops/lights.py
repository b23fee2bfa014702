"""Light sampling over the SoA light table.

Counterpart of ``gopbrt_tpu/ops/lights.py``: the table and its tags,
``LiSample``, ``sample_li`` (point, distant, sphere- and disk-area lights),
``pdf_li`` (the MIS denominator of a BSDF ray that hits an emitter),
``le_emitted``, ``sample_le`` (emitted rays, Light.SampleLe) and ``power``
(the power light distribution).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.ops import geom
from reference.ops.geom import PI, dot, gather_rows, length, length_sq, normalize
from reference.ops.sampling import (
    concentric_sample_disk,
    cosine_sample_hemisphere,
    uniform_cone_pdf,
    uniform_sample_sphere,
)

LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_AREA = 2

# area-light shape kinds (mirror the intersect tags)
SHAPE_SPHERE = 0
SHAPE_DISK = 1


class Lights(NamedTuple):
    """SoA light table.

    p: point position / distant direction toward the light (normalized).
    o2w/params/shape_kind: area-light geometry copied from the backing prim.
    prim_idx: backing primitive of an area light (-1 for delta lights).
    """

    light_type: torch.Tensor  # int32[L]
    p: torch.Tensor  # f32[L,3]
    intensity: torch.Tensor  # f32[L,3]
    two_sided: torch.Tensor  # bool[L]
    prim_idx: torch.Tensor  # int32[L]
    shape_kind: torch.Tensor  # int32[L]
    o2w: torch.Tensor  # f32[L,4,4]
    w2o: torch.Tensor  # f32[L,4,4]
    params: torch.Tensor  # f32[L,9]

    @property
    def count(self) -> int:
        return self.light_type.shape[0]


class LiSample(NamedTuple):
    wi: torch.Tensor  # f32[N,3] toward the light
    li: torch.Tensor  # f32[N,3] incident radiance (zero if unsampleable)
    pdf: torch.Tensor  # f32[N]  solid-angle pdf (1 for delta lights)
    dist: torch.Tensor  # f32[N]  shadow-ray length (to the sampled point)
    p_light: torch.Tensor  # f32[N,3] sampled point (invalid for distant)
    is_delta: torch.Tensor  # bool[N]


def _area_sphere_geom(o2w, params):
    """World center and radius of a sphere light (uniform-scale transform)."""
    return o2w[..., :3, 3], params[..., 0] * length(o2w[..., :3, 0])


def _z_normal(w2o, like):
    """+z of the light's object space as a world normal, per lane."""
    z = torch.zeros_like(like)
    n = torch.stack([z[..., 0], z[..., 1], torch.ones_like(like[..., 2])], dim=-1)
    return normalize(geom.apply_normal(w2o, n), eps=1e-20)


def _sample_sphere_li(o2w, params, ref_p, u2):
    """Solid-angle sphere sampling (sphere.go:287-344): a uniform cone from
    outside, uniform area with the solid-angle conversion from inside."""
    center, radius = _area_sphere_geom(o2w, params)
    to_c = center - ref_p
    dc2 = length_sq(to_c)
    dc = torch.sqrt(dc2)
    outside = dc > radius * 1.00001

    # outside: cone sampling
    inv_dc = 1.0 / torch.clamp(dc, min=1e-12)
    wc = to_c * inv_dc[..., None]
    wcx, wcy = geom.coordinate_system(wc)
    sin2_tmax = torch.clamp(radius * radius / torch.clamp(dc2, min=1e-20), 0.0, 1.0)
    cos_tmax = torch.sqrt(torch.clamp(1.0 - sin2_tmax, min=0.0))
    cos_t = (1.0 - u2[..., 0]) + u2[..., 0] * cos_tmax
    sin2_t = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
    ds = dc * cos_t - torch.sqrt(torch.clamp(radius * radius - dc2 * sin2_t, min=0.0))
    cos_a = (dc2 + radius * radius - ds * ds) / torch.clamp(2.0 * dc * radius, min=1e-12)
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = 2.0 * PI * u2[..., 1]
    n_obj = geom.spherical_direction_xyz(sin_a, cos_a, phi, -wcx, -wcy, -wc)
    p_out = center + radius[..., None] * n_obj
    wi_out = normalize(p_out - ref_p, eps=1e-20)
    pdf_out = uniform_cone_pdf(torch.clamp(cos_tmax, max=1.0 - 1e-7))

    # inside: uniform area sampling + conversion
    dir_s = uniform_sample_sphere(u2)
    p_in = center + radius[..., None] * dir_s
    wi_v = p_in - ref_p
    d2 = length_sq(wi_v)
    wi_in = normalize(wi_v, eps=1e-20)
    area = 4.0 * PI * radius * radius
    cos_l = torch.abs(dot(dir_s, -wi_in))
    pdf_in = d2 / torch.clamp(cos_l * area, min=1e-12)

    o3 = outside[..., None]
    wi = torch.where(o3, wi_out, wi_in)
    p_l = torch.where(o3, p_out, p_in)
    n_l = torch.where(o3, n_obj, dir_s)
    pdf = torch.where(outside, pdf_out, pdf_in)
    return wi, p_l, n_l, pdf, length(p_l - ref_p)


def _sample_disk_li(o2w, w2o, params, ref_p, u2):
    """Area-sample a disk emitter (disk.go:160-170) with the solid-angle
    conversion (shape.go:49-64)."""
    height, radius, inner, phi_max = params.unbind(-1)[:4]
    pd = concentric_sample_disk(u2) * radius[..., None]
    p_obj = torch.stack([pd[..., 0], pd[..., 1], height], dim=-1)
    p_l = geom.lane_point(o2w, p_obj)
    n_l = _z_normal(w2o, p_obj)
    wi_v = p_l - ref_p
    d2 = length_sq(wi_v)
    wi = normalize(wi_v, eps=1e-20)
    scale = length(o2w[..., :3, 0])
    area = phi_max * 0.5 * (radius * radius - inner * inner) * scale * scale
    cos_l = torch.abs(dot(n_l, -wi))
    pdf = d2 / torch.clamp(cos_l * area, min=1e-12)
    pdf = torch.where(cos_l < 1e-7, 0.0, pdf)
    return wi, p_l, n_l, pdf, torch.sqrt(d2)


def _rows(lights: Lights, idx):
    i = idx.long()
    return (lights.light_type[i], gather_rows(lights.p, i), gather_rows(lights.intensity, i),
            lights.two_sided[i], gather_rows(lights.o2w, i), gather_rows(lights.w2o, i),
            gather_rows(lights.params, i), lights.shape_kind[i])


def sample_li(lights: Lights, idx, ref_p, u2, world_radius) -> LiSample:
    """Incident radiance from light ``idx`` (per lane) at ref_p: Point
    (point.go:44-49), Distant (distant.go:40-44), DiffuseArea
    (diffuse.go:47-59).  world_radius: f32[] tensor or float."""
    lt, lp, intensity, two_sided, o2w, w2o, params, shape_kind = _rows(lights, idx)

    # point light: Li = I / d^2
    to_l = lp - ref_p
    d2 = length_sq(to_l)
    wi_pt = normalize(to_l, eps=1e-20)
    li_pt = intensity / torch.clamp(d2, min=1e-12)[..., None]
    dist_pt = torch.sqrt(d2)

    # distant light: Li = L from outside the world
    dist_di = torch.zeros_like(d2) + 2.0 * world_radius

    # area light
    wi_s, pl_s, nl_s, pdf_s, dist_s = _sample_sphere_li(o2w, params, ref_p, u2)
    wi_d, pl_d, nl_d, pdf_d, dist_d = _sample_disk_li(o2w, w2o, params, ref_p, u2)
    is_disk = shape_kind == SHAPE_DISK
    d3 = is_disk[..., None]
    wi_ar = torch.where(d3, wi_d, wi_s)
    pl_ar = torch.where(d3, pl_d, pl_s)
    nl_ar = torch.where(d3, nl_d, nl_s)
    pdf_ar = torch.where(is_disk, pdf_d, pdf_s)
    dist_ar = torch.where(is_disk, dist_d, dist_s)
    # one- or two-sided emission (diffuse.go:36-41)
    facing = dot(nl_ar, -wi_ar) > 0.0
    li_ar = torch.where((two_sided | facing)[..., None], intensity, 0.0)
    li_ar = torch.where((pdf_ar > 0.0)[..., None], li_ar, 0.0)

    is_pt = lt == LIGHT_POINT
    is_di = lt == LIGHT_DISTANT
    pt3, di3 = is_pt[..., None], is_di[..., None]
    wi = torch.where(pt3, wi_pt, torch.where(di3, lp, wi_ar))
    li = torch.where(pt3, li_pt, torch.where(di3, intensity, li_ar))
    pdf = torch.where(is_pt | is_di, 1.0, pdf_ar)
    dist = torch.where(is_pt, dist_pt, torch.where(is_di, dist_di, dist_ar))
    p_light = torch.where(pt3, lp, torch.where(di3, ref_p + lp * dist_di[..., None],
                                               pl_ar))
    return LiSample(wi=wi, li=li, pdf=pdf, dist=dist, p_light=p_light,
                    is_delta=is_pt | is_di)


def pdf_li(lights: Lights, idx, ref_p, wi) -> torch.Tensor:
    """Solid-angle pdf that sample_li(idx) generates wi from ref_p — the MIS
    denominator of the BSDF branch (integrator.go:133-192, sphere.go:346-363).
    Delta lights give 0."""
    lt, _, _, _, o2w, w2o, params, shape_kind = _rows(lights, idx)

    center, radius = _area_sphere_geom(o2w, params)
    to_c = center - ref_p
    dc2 = length_sq(to_c)
    outside = dc2 > radius * radius * 1.00002
    sin2_tmax = torch.clamp(radius * radius / torch.clamp(dc2, min=1e-20), 0.0, 1.0)
    cos_tmax = torch.sqrt(torch.clamp(1.0 - sin2_tmax, min=0.0))
    in_cone = dot(normalize(to_c, eps=1e-20), wi) >= cos_tmax - 1e-6
    pdf_sphere = torch.where(outside & in_cone,
                             uniform_cone_pdf(torch.clamp(cos_tmax, max=1.0 - 1e-7)), 0.0)
    # inside: uniform area converted to solid angle along wi (shape.go:29-47)
    oc = ref_p - center
    b_half = dot(oc, wi)
    disc_in = torch.clamp(radius * radius - (length_sq(oc) - b_half * b_half), min=0.0)
    t_hit = -b_half + torch.sqrt(disc_in)
    n_hit = normalize(oc + wi * t_hit[..., None], eps=1e-20)
    cos_hit = torch.abs(dot(n_hit, wi))
    area_sph = 4.0 * PI * radius * radius
    pdf_inside = (t_hit * t_hit) / torch.clamp(cos_hit * area_sph, min=1e-12)
    pdf_sphere = torch.where(outside, pdf_sphere, pdf_inside)

    # disk emitter: the disk plane along wi, area pdf converted
    oo = geom.lane_point(w2o, ref_p)
    od = geom.lane_vector(w2o, wi)
    height, radius_d, inner, phi_max = params.unbind(-1)[:4]
    dz = od[..., 2]
    t_plane = (height - oo[..., 2]) / torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
    p_obj = oo + od * t_plane[..., None]
    r2 = p_obj[..., 0] ** 2 + p_obj[..., 1] ** 2
    on_disk = (t_plane > 1e-4) & (r2 <= radius_d * radius_d) & (r2 >= inner * inner)
    scale = length(o2w[..., :3, 0])
    area = phi_max * 0.5 * (radius_d * radius_d - inner * inner) * scale * scale
    p_w = geom.lane_point(o2w, p_obj)
    n_w = _z_normal(w2o, p_obj)
    d2_w = length_sq(p_w - ref_p)
    cos_l = torch.abs(dot(n_w, -wi))
    pdf_disk = torch.where(on_disk & (cos_l > 1e-7),
                           d2_w / torch.clamp(cos_l * area, min=1e-12), 0.0)

    pdf_area = torch.where(shape_kind == SHAPE_DISK, pdf_disk, pdf_sphere)
    return torch.where(lt == LIGHT_AREA, pdf_area, 0.0)


def le_emitted(lights: Lights, prims_area_light_id, prim_idx, n, wo):
    """Emitted radiance where a ray hits an emissive primitive (AreaLight L,
    diffuse.go:36-41) -> (rgb f32[N,3], light id int32[N], -1 for none)."""
    lid = prims_area_light_id[prim_idx.long()]
    safe = torch.clamp(lid, min=0).long()
    facing = dot(n, wo) > 0.0
    out = torch.where((lights.two_sided[safe] | facing)[..., None],
                      gather_rows(lights.intensity, safe), 0.0)
    return torch.where((lid >= 0)[..., None], out, 0.0), lid


class LeSample(NamedTuple):
    """An emitted ray sampled from a light (Light.SampleLe)."""

    o: torch.Tensor  # f32[N,3] origin on / at the light
    d: torch.Tensor  # f32[N,3] emission direction
    n_light: torch.Tensor  # f32[N,3] the light's normal at o (d for delta lights)
    le: torch.Tensor  # f32[N,3] emitted radiance / intensity
    pdf_pos: torch.Tensor  # f32[N] area pdf of the origin
    pdf_dir: torch.Tensor  # f32[N] solid-angle pdf of the direction


def sample_le(lights: Lights, idx, u1, u2, world_center, world_radius) -> LeSample:
    """An emitted ray of light ``idx`` (lights.py:329-433): Point (uniform
    sphere, point.go:63-66), Distant (a disk outside the world,
    distant.go:58-68), DiffuseArea (a uniform shape point and a cosine
    hemisphere, diffuse.go:65-92); u1 picks the position, u2 the
    direction."""
    lt, lp, intensity, two_sided, o2w, w2o, params, shape_kind = _rows(lights, idx)

    # point: from p, a uniform direction
    d_pt = uniform_sample_sphere(u2)
    o_pt = torch.broadcast_to(lp, d_pt.shape)
    ones = torch.ones(d_pt.shape[:-1], dtype=torch.float32, device=d_pt.device)

    # distant: a concentric disk on the world's bounding sphere, shooting
    # along -w (p points toward the light)
    w = normalize(lp, eps=1e-20)
    v1, v2 = geom.coordinate_system(w)
    cd = concentric_sample_disk(u1)
    p_disk = world_center + world_radius * (cd[..., 0:1] * v1 + cd[..., 1:2] * v2)
    o_di = p_disk + world_radius * w
    pdf_pos_di = torch.broadcast_to(
        torch.as_tensor(1.0 / (PI * world_radius * world_radius), dtype=torch.float32,
                        device=d_pt.device), ones.shape)

    # area: a uniform point of the shape, a cosine hemisphere about n
    center, radius = _area_sphere_geom(o2w, params)
    n_sph = uniform_sample_sphere(u1)
    p_sph = center + radius[..., None] * n_sph
    area_sph = 4.0 * PI * radius * radius
    height, radius_d, inner, phi_max = params.unbind(-1)[:4]
    pd = concentric_sample_disk(u1) * radius_d[..., None]
    p_obj = torch.stack([pd[..., 0], pd[..., 1], height], dim=-1)
    p_dsk = geom.lane_point(o2w, p_obj)
    n_dsk = _z_normal(w2o, p_obj)
    scale = length(o2w[..., :3, 0])
    area_dsk = phi_max * 0.5 * (radius_d * radius_d - inner * inner) * scale * scale
    is_disk = shape_kind == SHAPE_DISK
    p_ar = torch.where(is_disk[..., None], p_dsk, p_sph)
    n_ar = torch.where(is_disk[..., None], n_dsk, n_sph)
    area = torch.where(is_disk, area_dsk, area_sph)
    # two-sided lights pick a side by u2.x (diffuse.go:72-88)
    u2x = u2[..., 0]
    flip = two_sided & (u2x > 0.5)
    u2_remap = torch.stack([
        torch.where(two_sided, torch.clamp(torch.where(flip, 2.0 * (u2x - 0.5), 2.0 * u2x),
                                           max=0.99999994), u2x),
        u2[..., 1]], dim=-1)
    w_local = cosine_sample_hemisphere(u2_remap)
    n_eff = torch.where(flip[..., None], -n_ar, n_ar)
    t1, t2 = geom.coordinate_system(n_eff)
    d_ar = t1 * w_local[..., 0:1] + t2 * w_local[..., 1:2] + n_eff * w_local[..., 2:3]
    pdf_pos_ar = 1.0 / torch.clamp(area, min=1e-20)
    pdf_dir_ar = torch.abs(w_local[..., 2]) / PI * torch.where(two_sided, 0.5, 1.0)

    is_pt = lt == LIGHT_POINT
    is_di = lt == LIGHT_DISTANT
    pt3, di3 = is_pt[..., None], is_di[..., None]
    o = torch.where(pt3, o_pt, torch.where(di3, o_di, p_ar))
    d = torch.where(pt3, d_pt, torch.where(di3, -w, d_ar))
    n_l = torch.where(pt3 | di3, d, n_eff)
    pdf_pos = torch.where(is_pt, ones, torch.where(is_di, pdf_pos_di, pdf_pos_ar))
    pdf_dir = torch.where(is_pt, torch.full_like(ones, 1.0 / (4.0 * PI)),
                          torch.where(is_di, ones, pdf_dir_ar))
    le = torch.broadcast_to(intensity, o.shape)
    # area origins leave the surface on the emitting side
    o = torch.where(pt3 | di3, o, o + n_eff * 1e-4)
    return LeSample(o=o, d=d, n_light=n_l, le=le, pdf_pos=pdf_pos, pdf_dir=pdf_dir)


def power(lights: Lights, world_radius) -> torch.Tensor:
    """Scalar power per light for the power distribution
    (lightdistribution.go:46-68 with its append bug fixed; point.go:51-53)."""
    lt = lights.light_type
    inten = torch.mean(lights.intensity, dim=-1)  # luminance stand-in
    _, radius = _area_sphere_geom(lights.o2w, lights.params)
    scale = length(lights.o2w[..., :3, 0])
    r_d = lights.params[..., 1] * scale
    inner = lights.params[..., 2] * scale
    area_sphere = 4.0 * PI * radius * radius
    area_disk = lights.params[..., 3] * 0.5 * (r_d * r_d - inner * inner)
    area = torch.where(lights.shape_kind == SHAPE_DISK, area_disk, area_sphere)
    sided = torch.where(lights.two_sided, 2.0, 1.0)
    p_point = 4.0 * PI * inten
    p_distant = PI * world_radius * world_radius * inten
    p_area = inten * area * PI * sided
    return torch.where(lt == LIGHT_POINT, p_point,
                       torch.where(lt == LIGHT_DISTANT, p_distant, p_area))
