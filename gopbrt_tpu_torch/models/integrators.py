"""Wavefront integrators: path tracing and direct lighting.

Counterpart of ``gopbrt_tpu/models/integrators.py``: ``PathConfig``, the
intersection dispatch (``_scene_intersect`` / ``_scene_intersect_p``, at
each lane's time on animated scenes), the light pick (the global
distribution, or the spatial grid's voxel at the shading point), bump
mapping (``_apply_bump``), ``_material_at``, the BSSRDF's probe
transport (``_subsurface_transport``), the shading frame,
``_estimate_direct`` (NEE with MIS, the phase function at medium vertices
and the shadow ray's transmittance), the shadow walk across null
boundaries (``_intersect_tr``), ``PathState``, ``_bounce_once`` (the
segment walk through null boundaries, medium distance sampling, medium
vertices and HG sampling), the wavefront loop ``_li_wavefront`` (the JAX
package's ``_li_jnp``), its compacted mode (``_li_compacted``: live
lanes sorted to the front and run in chunks), ``li_direct`` and the
dispatch ``li``.  As in the reference, what a scene lacks (media, null
materials, interfaces, bump, subsurface, motion, the light grid) is left
out in Python: such a scene runs the ops it ran before these features.

The chain's stages run in the tracer's spans (``utils/trace.py``):
``li.intersect`` (the intersection dispatch), ``li.surface`` (the hit's
record, emission, bump, footprint, material, subsurface transport and
shading frame) and ``li.nee`` (each ``_estimate_direct``).  Each bounce
counts the lanes it runs over and those alive entering it
(``li.lanes_run`` / ``li.lanes_live``, keyed by the bounce), and each
copy between host and card counts in ``host_syncs`` (``trace.to_host``).

The whole batch of rays advances bounce by bounce as SoA tensors with an
alive mask, as in the JAX chain, and draws the same counter-based random
numbers, so both packages trace the same paths.  On CUDA tensors the
intersections launch the kernels of ``csrc/bvh_intersect.cu``
(``ops/bvh.bvh_intersect_fused`` / ``bvh_intersect_p_fused``) on scenes
above BRUTE_FORCE_CUTOFF prims with a BVH, those of ``csrc/intersect.cu``
(``ops/brute_intersect.intersect_brute_fused`` /
``intersect_p_brute_fused``) on the others; on CPU tensors they run the
plain versions.  An animated scene runs the plain, time-aware versions
on either device, as the reference turns Pallas off for it
(integrators.py:154-204).  Under ``li``, fast-path scenes run a bounce
megakernel through ``li_fused``: the brute one
(``ops/megakernel.BRUTE``) up to the cutoff, the mesh one
(``ops/mesh_megakernel.MESH``) above it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

from gopbrt_tpu_torch.ops import brute_intersect, megakernel, mesh_megakernel, packed, rng
from gopbrt_tpu_torch.ops import sampling
from gopbrt_tpu_torch.ops import bssrdf as sss_ops
from gopbrt_tpu_torch.ops import media as media_ops
from gopbrt_tpu_torch.ops import bvh as bvh_ops
from gopbrt_tpu_torch.ops import bsdf as bsdf_ops
from gopbrt_tpu_torch.ops import geom
from gopbrt_tpu_torch.ops import intersect as isect
from gopbrt_tpu_torch.ops import lights as light_ops
from gopbrt_tpu_torch.ops import texture as tex_ops
from gopbrt_tpu_torch.ops.geom import dot, gather_rows, normalize
from gopbrt_tpu_torch.ops.rng import (  # noqa: F401  (re-exports)
    D_BSDF_LOBE,
    D_BSDF_UV,
    D_LIGHT_PICK,
    D_LIGHT_UV,
    D_MEDIUM,
    D_PHASE,
    D_RR,
    D_SSS,
    DIM_ALL_LIGHT_BASE,
    DIM_BOUNCE_BASE,
    DIM_CAMERA,
    DIMS_PER_BOUNCE,
)
from gopbrt_tpu_torch.utils import trace

# brute force below this prim count (no BVH)
BRUTE_FORCE_CUTOFF = 64

_F32 = torch.float32


class PathConfig(NamedTuple):
    """Integrator configuration (NewPath, path.go:10-17)."""

    max_depth: int = 5
    rr_threshold: float = 1.0
    rr_start_depth: int = 3  # RR after 3 bounces (path.go:143-153)
    nee: bool = True  # next-event estimation at every vertex
    mis: bool = True  # BSDF-sampled emitter hits weighted against NEE
    # wavefront compaction: each bounce sorts the live lanes to the front
    # and runs only ceil(live / chunk_size) chunks of chunk_size lanes
    # (_li_compacted); one host sync a bounce; not differentiable
    compaction: bool = False
    chunk_size: int = 1 << 18
    # stop the bounce loop once every lane is dead
    early_exit: bool = False
    # the null-boundary crossings a bounce, or a shadow ray, walks through
    # (path.go:72-78); only scenes with a null material walk
    null_passes: int = 2


class _Sampler:
    """The counter streams of one batch: rng.sample_1d(seed, pixel, sample,
    dim) with the (seed, pixel, sample) part of the hash chain computed
    once (rng.stream_u32 hashes dim last), so each draw is one more
    hash_combine."""

    def __init__(self, seed, pixel, sample):
        h = rng.hash_combine(rng.as_u32(seed, pixel.device), rng.as_u32(pixel))
        self.h = rng.hash_combine(h, sample)

    def take(self, idx) -> "_Sampler":
        """The streams of lanes ``idx`` (a compacted chunk)."""
        out = _Sampler.__new__(_Sampler)
        out.h = self.h[idx]
        return out

    def u1(self, dim) -> torch.Tensor:
        return rng.u32_to_unit(rng.hash_combine(self.h, dim))

    def u2(self, dim) -> torch.Tensor:
        return torch.stack([self.u1(dim), self.u1(dim + 1)], dim=-1)


# ---------------------------------------------------------------------------
# Intersection and light-pick dispatch
# ---------------------------------------------------------------------------


def _use_bvh(scene) -> bool:
    """The BVH walk where the scene has a tree and more prims than the
    brute-force cutoff (integrators.py:155, 182)."""
    return scene.bvh_tables is not None and scene.prims.count > BRUTE_FORCE_CUTOFF


def _scene_intersect(scene, o, d, t_max, time=None):
    """Closest hit -> (hit, t, prim_idx): the BVH walk or the brute sweep,
    as kernels on CUDA tensors and as plain versions on CPU tensors
    (integrators.py:144-177).  An animated scene takes the plain versions,
    its moving prims at the lanes' ``time`` where given."""
    with trace.span("li.intersect"):
        args = (o.contiguous(), d.contiguous(), t_max.contiguous())
        anim = scene.prims.anim
        if _use_bvh(scene):
            if anim is not None:
                return bvh_ops.bvh_intersect(scene.bvh_tables, *args,
                                             anim=None if time is None else anim, time=time)
            return bvh_ops.bvh_intersect_fused(scene.bvh_tables, *args)
        table = brute_intersect.scene_table(scene)
        if anim is not None:
            return brute_intersect.intersect_brute(table, *args, moving=_moving(scene, time))
        return brute_intersect.intersect_brute_fused(table, *args)


def _scene_intersect_p(scene, o, d, t_max, time=None):
    """Any hit closer than t_max -> bool[N] (integrators.py:180-204)."""
    with trace.span("li.intersect"):
        args = (o.contiguous(), d.contiguous(), t_max.contiguous())
        anim = scene.prims.anim
        if _use_bvh(scene):
            if anim is not None:
                return bvh_ops.bvh_intersect_p(scene.bvh_tables, *args,
                                               anim=None if time is None else anim, time=time)
            return bvh_ops.bvh_intersect_p_fused(scene.bvh_tables, *args)
        table = brute_intersect.scene_table(scene)
        if anim is not None:
            return brute_intersect.intersect_p_brute(table, *args,
                                                     moving=_moving(scene, time))
        return brute_intersect.intersect_p_brute_fused(table, *args)


def _moving(scene, time):
    """The moving prims' per-lane transforms at ``time``, or None."""
    return None if time is None else brute_intersect.moving_rows(scene.prims, time)


def _voxel_flat(scene, p):
    """Flat index of the light grid's voxel holding each point p
    (integrators.py:207-212); a point outside the grid takes the nearest
    voxel."""
    g = scene.light_grid
    dims_f = g.dims.to(_F32)
    v = torch.floor((p - g.lo) * g.inv_extent * dims_f)
    v = torch.minimum(torch.clamp(v, min=0.0), dims_f - 1.0).to(torch.int64)
    v = torch.minimum(torch.clamp(v, min=0), g.dims - 1)  # NaN points
    return (v[..., 0] * g.dims[1] + v[..., 1]) * g.dims[2] + v[..., 2]


def _light_pick(scene, p, u):
    """Pick a light for NEE at the shading points p: from the light grid's
    distribution of p's voxel where the scene has one (the Spatial
    strategy), else from the global uniform / power distribution
    (integrators.py:215-228).  A discrete decision: no gradient reaches p
    through the voxel index."""
    g = scene.light_grid
    if g is not None:
        flat = _voxel_flat(scene, p)
        return sampling.sample_discrete_rows(gather_rows(g.func, flat), gather_rows(g.cdf, flat),
                                             gather_rows(g.func_int, flat), u)
    return sampling.sample_discrete(scene.light_func, scene.light_cdf,
                                    scene.light_func_int, u)


def _light_pick_pmf(scene, p, light_idx):
    """pmf that _light_pick at p chooses light_idx (the MIS denominator,
    integrators.py:231-245)."""
    g = scene.light_grid
    if g is not None:
        flat = _voxel_flat(scene, p)
        return sampling.pmf_rows(gather_rows(g.func, flat), gather_rows(g.func_int, flat),
                                 light_idx)
    return sampling.discrete_pmf(scene.light_func, scene.light_func_int,
                                 light_idx.long())


def _apply_bump(scene, si: isect.SurfaceInteraction) -> isect.SurfaceInteraction:
    """The shading normal perturbed by the material's bump texture
    (integrators.py:247-278): the height's finite differences along dpdu /
    dpdv; the reference's Material.Bump computes its offset point and then
    discards it (material.go:18-34), as this does."""
    mats = scene.materials
    if mats.bump_tex is None:
        return si
    mid = scene.prims.material_id[si.prim_idx.long()].long()
    bt = mats.bump_tex[mid]
    bscale = gather_rows(mats.bump_scale, mid)
    tex_id = torch.clamp(bt, min=0)
    du = 5e-3

    def height(p, uv):
        return torch.mean(tex_ops.eval_spectrum(scene.textures, tex_id, p, uv), dim=-1)

    h0 = height(si.p, si.uv)
    zero = torch.zeros_like(h0)
    step = torch.full_like(h0, du)
    hu = height(si.p + si.dpdu * du, si.uv + torch.stack([step, zero], dim=-1))
    hv = height(si.p + si.dpdv * du, si.uv + torch.stack([zero, step], dim=-1))
    dhdu = (hu - h0) / du * bscale
    dhdv = (hv - h0) / du * bscale
    ns_b = normalize(geom.cross(si.dpdu + dhdu[..., None] * si.ns,
                                si.dpdv + dhdv[..., None] * si.ns), eps=1e-20)
    # the orientation of the unperturbed shading normal
    ns_b = torch.where(dot(ns_b, si.ns)[..., None] < 0.0, -ns_b, ns_b)
    return si._replace(ns=torch.where((bt >= 0)[..., None], ns_b, si.ns))


def _material_at(scene, si: isect.SurfaceInteraction, fw=None) -> bsdf_ops.MaterialParams:
    """Material parameters at the hits, textures evaluated
    (ComputeScatteringFunctions; integrators.py:281-320).  The one-hot
    matmul of the JAX version is a TPU device; ``geom.gather_rows`` reads
    the same rows."""
    mats = scene.materials
    mid = scene.prims.material_id[si.prim_idx.long()].long()
    kd_tex = mats.kd_tex[mid]
    kd_sampled = tex_ops.eval_spectrum(scene.textures, kd_tex, si.p, si.uv, fw=fw)
    return bsdf_ops.MaterialParams(
        mat_type=mats.mat_type[mid],
        kd=torch.where((kd_tex >= 0)[..., None], kd_sampled, gather_rows(mats.kd, mid)),
        sigma=gather_rows(mats.sigma, mid),
        kr=gather_rows(mats.kr, mid),
        kt=gather_rows(mats.kt, mid),
        eta=gather_rows(mats.eta, mid),
        roughness=gather_rows(mats.roughness, mid),
        info=mats.info,
        sss_cbar=None if mats.sss_cbar is None else gather_rows(mats.sss_cbar, mid),
    )


def _where_si(mask, a: isect.SurfaceInteraction, b: isect.SurfaceInteraction):
    """Lane-select between two SurfaceInteractions (integrators.py:323-332)."""
    return isect.SurfaceInteraction(*(
        torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y)
        for x, y in zip(a, b)))


def _subsurface_transport(scene, si, mp, beta, alive, sampler: "_Sampler", dim_base: int,
                          time=None):
    """The BSSRDF at subsurface entry hits (integrators.py:335-425), S =
    (1 - Fr(theta_o)) Sp Sw: with probability Fr a lane becomes a unit
    mirror; otherwise a probe disk point (axis, channel, Burley radius,
    azimuth) and a closest hit along its chord find the exit on the same
    material, beta takes Sp / pdf_Sp and the lane's hit moves to the exit,
    whose lobe is Sw.  As in the reference: the probe keeps the chord's
    first hit only, and a failed probe kills its lane (quirks, ROADMAP
    section 3).  -> (si, mp, beta, alive)."""
    sss = alive & (mp.mat_type == bsdf_ops.SUBSURFACE)
    fr = bsdf_ops.fr_dielectric(dot(si.wo, si.ns), 1.0, mp.eta)
    reflect = sss & (sampler.u1(dim_base + D_SSS) < fr)
    transmit = sss & ~reflect
    # reflected lanes: the Fresnel weight cancels the choice: a unit mirror
    mp = mp._replace(mat_type=torch.where(reflect, bsdf_ops.MIRROR, mp.mat_type),
                     kr=torch.where(reflect[..., None], 1.0, mp.kr))

    # the probe's disk point in the entry frame
    ss_f, ts_f, ns_f = _shading_frame(si)
    vx, vy, vz, _ = sss_ops.sample_axis_frame(sampler.u1(dim_base + D_SSS + 1),
                                              ss_f, ts_f, ns_f)
    u_chr = sampler.u1(dim_base + D_SSS + 2)
    ch = torch.clamp((u_chr * 3.0).to(torch.int32), max=2)
    u_r = u_chr * 3.0 - ch.to(torch.float32)
    mid = scene.prims.material_id[si.prim_idx.long()]
    d_rgb = gather_rows(scene.materials.sss_d, mid.long())  # [N,3]
    d_ch = torch.gather(d_rgb, -1, ch.long()[..., None])[..., 0]
    r = sss_ops.burley_sample_r(u_r, d_ch)
    r_max = sss_ops.burley_sample_r(torch.full_like(u_r, 0.999), d_ch)
    ok_r = r < r_max
    chord = 2.0 * torch.sqrt(torch.clamp(r_max * r_max - r * r, min=1e-12))
    phi = 2.0 * geom.PI * sampler.u1(dim_base + D_SSS + 3)
    base = si.p + r[..., None] * (torch.cos(phi)[..., None] * vx
                                  + torch.sin(phi)[..., None] * vy)
    p0 = base + (0.5 * chord)[..., None] * vz
    probe_d = -vz
    # lanes that probe nothing carry a 1e-5 chord
    t_probe = torch.where(transmit & ok_r, chord, 1e-5)
    hit_p, t_p, prim_p = _scene_intersect(scene, p0, probe_d, t_probe, time)
    t_p, prim_p = t_p.detach(), prim_p.detach()
    ok = transmit & ok_r & hit_p & (scene.prims.material_id[prim_p.long()] == mid)
    si_exit = isect.surface_interaction(scene.prims, ok, t_p, prim_p, p0, probe_d, time)
    # Sw lives on the outward hemisphere: the frame of the geometric normal
    si_exit = si_exit._replace(ns=si_exit.n, wo=si_exit.n)

    # Sp at the actual radius over the axis- and channel-MIS pdf
    r_act = torch.sqrt(geom.length_sq(si_exit.p - si.p))
    pdf = sss_ops.pdf_sp(si.p, ss_f, ts_f, ns_f, si_exit.p, si_exit.n, d_rgb)
    w_sp = sss_ops.sp(mp.kd, r_act, d_rgb) / torch.clamp(pdf, min=1e-12)[..., None]
    beta = torch.where(ok[..., None], beta * w_sp, beta)
    return _where_si(ok, si_exit, si), mp, beta, alive & ~(transmit & ~ok)


def _shading_frame(si: isect.SurfaceInteraction):
    """Orthonormal shading frame (ss, ts, ns) (reflection.go:120-145), with
    a fallback for a degenerate dpdu."""
    ns = si.ns
    ss = si.dpdu - ns * dot(ns, si.dpdu)[..., None]
    bad = geom.length_sq(ss) < 1e-12
    fb_s, _ = geom.coordinate_system(ns)
    ss = normalize(torch.where(bad[..., None], fb_s, ss), eps=1e-30)
    return ss, geom.cross(ns, ss), ns


def _to_local(ss, ts, ns, v):
    return torch.stack([dot(v, ss), dot(v, ts), dot(v, ns)], dim=-1)


def _to_world(ss, ts, ns, v):
    return ss * v[..., 0:1] + ts * v[..., 1:2] + ns * v[..., 2:3]


def _estimate_direct(scene, si, mp, ss, ts, ns, active, sampler: _Sampler,
                     dim_base: int, fixed_light=None, medium_scatter=None, phase_g=None,
                     medium_ids=None, null_passes: int = 0, time=None):
    """One-light NEE with MIS (UniformSampleOneLight + EstimateDirect,
    integrator.go:48-77, 79-195) over the wavefront -> rgb f32[N,3], already
    divided by the pick pmf (integrators.py:451-573).

    fixed_light: a light index for the sample-all-lights strategy
    (UniformSampleAllLights, integrator.go:23-46): no pick pmf, and each
    light draws from a disjoint dimension region.  The BSDF branch of the
    MIS pair is the emitter hit of the next segment.

    medium_scatter: bool[N] lanes at a medium vertex, whose "BSDF" is the HG
    phase function (g: ``phase_g`` per lane with bounded media, else the
    global medium's) and whose shadow ray starts at the vertex itself.
    The shadow ray's transmittance: walked across null boundaries by
    ``_intersect_tr`` where ``null_passes`` > 0; else in the lane's medium
    ``medium_ids`` (bounded media) or the global medium.  time: the lanes'
    shutter times on an animated scene.
    """
    n_lights = scene.n_lights
    if n_lights == 0:
        return torch.zeros_like(si.p)
    if fixed_light is None:
        # a discrete decision: the index carries no gradient (integrators.py:482-484)
        light_idx, pick_pmf = _light_pick(scene, si.p, sampler.u1(dim_base + D_LIGHT_PICK))
        uv_dim = dim_base + D_LIGHT_UV
    else:
        light_idx = torch.full_like(si.prim_idx, fixed_light)
        pick_pmf = torch.ones_like(si.t)
        uv_dim = DIM_ALL_LIGHT_BASE + dim_base * 64 + 2 * fixed_light

    ls = light_ops.sample_li(scene.lights, light_idx, si.p, sampler.u2(uv_dim),
                             scene.world_radius)
    # BSDF f(wo, wi) |cos(wi, ns)|
    wo_l = _to_local(ss, ts, ns, si.wo)
    wi_l = _to_local(ss, ts, ns, ls.wi)
    f = bsdf_ops.bsdf_f(mp, wo_l, wi_l) * geom.absdot(ls.wi, ns)[..., None]
    b_pdf = bsdf_ops.bsdf_pdf(mp, wo_l, wi_l)
    if medium_scatter is not None:
        # the phase function in place of f cos; its pdf is its value
        ph = media_ops.hg_phase(dot(si.wo, ls.wi),
                                phase_g if phase_g is not None else scene.medium.g)
        f = torch.where(medium_scatter[..., None], ph[..., None], f)
        b_pdf = torch.where(medium_scatter, ph, b_pdf)
    contributes = (active & (ls.pdf > 0.0) & (torch.amax(ls.li, dim=-1) > 0.0)
                   & (torch.amax(f, dim=-1) > 0.0))

    # shadow ray (VisibilityTester.Unoccluded, light.go:46-48), short of the
    # light; lanes that do not contribute get a zero-length ray
    o_sh = isect.spawn_ray(si, ls.wi)
    if medium_scatter is not None:
        # a medium vertex has no surface to offset from
        o_sh = torch.where(medium_scatter[..., None], si.p, o_sh)
    t_sh = ls.dist * (1.0 - geom.SHADOW_EPSILON) - 1e-3
    t_sh = torch.where(contributes, torch.clamp(t_sh, min=1e-4), 1e-4)
    tr = None
    if null_passes > 0:
        # closest hits stepping through null boundaries (Scene.IntersectTr)
        occluded, tr = _intersect_tr(scene, o_sh, ls.wi, t_sh, medium_ids, contributes,
                                     null_passes, time)
    else:
        occluded = _scene_intersect_p(scene, o_sh, ls.wi, t_sh, time)
    vis = contributes & ~occluded

    # delta lights unweighted, area lights by the power heuristic
    weight = torch.where(ls.is_delta, 1.0,
                         sampling.power_heuristic(1, ls.pdf, 1, b_pdf))
    gain = weight / torch.clamp(ls.pdf, min=1e-20) / torch.clamp(pick_pmf, min=1e-20)
    contrib = f * ls.li * gain[..., None]
    if tr is None and medium_ids is not None:
        # bounded media, no null boundary: the segment stays in the
        # vertex's medium (a boundary would occlude)
        sig_t, _, _ = media_ops.table_lookup(scene.media, medium_ids)
        tr = torch.exp(-sig_t * torch.clamp(ls.dist, min=0.0)[..., None])
    elif tr is None and scene.medium is not None:
        # VisibilityTester.Tr along the unoccluded shadow ray
        tr = media_ops.transmittance(scene.medium, ls.dist)
    if tr is not None:
        contrib = contrib * tr
    return torch.where(vis[..., None], contrib, 0.0)


def _intersect_tr(scene, o, d, dist, medium0, active, null_passes: int, time=None):
    """A shadow ray walked across up to ``null_passes`` null boundaries,
    each segment's Beer-Lambert transmittance in the lane's current medium
    (Scene.IntersectTr, scene.go:58-77; integrators.py:576-626) ->
    (occluded bool[N], Tr f32[N,3]).  Any other surface occludes; a lane
    still walking after the budget counts as occluded (the reference's
    truncation)."""
    n = o.shape[0]
    prims = scene.prims
    tr = torch.ones((n, 3), dtype=_F32, device=o.device)
    occl = torch.zeros((n,), dtype=torch.bool, device=o.device)
    o_w, rem, walk = o, dist, active
    mid_w = (medium0 if medium0 is not None
             else torch.full((n,), -1, dtype=torch.int32, device=o.device))
    for _ in range(null_passes + 1):
        t_lim = torch.where(walk, torch.clamp(rem, min=1e-4), 1e-4)
        hit_k, t_k, prim_k = _scene_intersect(scene, o_w, d, t_lim, time)
        hit_k = hit_k & walk
        t_k = t_k.detach()
        if scene.media is not None:
            seg = torch.where(hit_k, t_k, torch.clamp(rem, min=0.0))
            sig_t, _, _ = media_ops.table_lookup(scene.media, mid_w)
            tr = torch.where(walk[..., None], tr * torch.exp(-sig_t * seg[..., None]), tr)
        mat_k = prims.material_id[prim_k.long()].long()
        is_null = hit_k & (scene.materials.mat_type[mat_k] == bsdf_ops.NULLMAT)
        occl = occl | (hit_k & ~is_null)
        # step through the boundary, switching the medium per the interface
        si_b = isect.surface_interaction(prims, is_null, t_k, prim_k, o_w, d, time)
        o_next = geom.offset_ray_origin(si_b.p, si_b.p_err + 1e-4, si_b.n, d)
        o_w = torch.where(is_null[..., None], o_next, o_w)
        rem = torch.where(is_null, rem - t_k, rem)
        if prims.medium_inside is not None:
            mid_w = _cross_interface(prims, prim_k, dot(d, si_b.n) < 0.0, is_null, mid_w)
        walk = is_null & (rem > 1e-4)
    return occl | walk, tr


def _cross_interface(prims, prim_idx, going_in, crossing, mid):
    """The lanes' medium after ``crossing`` the interface of ``prim_idx``:
    the inside medium going in, the outside one going out; -2 (no
    interface) keeps the medium."""
    idx = prim_idx.long()
    iv = torch.where(going_in, prims.medium_inside[idx], prims.medium_outside[idx])
    return torch.where(crossing & (iv > -2), iv, mid)


# ---------------------------------------------------------------------------
# The path integrator
# ---------------------------------------------------------------------------


class PathState(NamedTuple):
    """The wavefront: per-lane path state (SoA), the loop carry."""

    o: torch.Tensor  # f32[N,3] ray origin
    d: torch.Tensor  # f32[N,3] ray direction
    beta: torch.Tensor  # f32[N,3] path throughput
    L: torch.Tensor  # f32[N,3] radiance so far
    eta_scale: torch.Tensor  # f32[N] refraction radiance scaling (path.go:105)
    alive: torch.Tensor  # bool[N]
    specular: torch.Tensor  # bool[N] the last bounce was specular
    prev_bsdf_pdf: torch.Tensor  # f32[N] pdf of the ray's BSDF sample (MIS)
    cone_w: torch.Tensor  # f32[N] ray-cone footprint width at the origin
    # int32[N] the lanes' current medium, a row of Scene.media or -1 (the
    # ray's Medium pointer); None where the scene has neither bounded media
    # nor medium interfaces
    medium: Optional[torch.Tensor] = None
    # f32[N] shutter times (CameraSample.Time -> Ray.Time); None where the
    # scene has no moving prim
    time: Optional[torch.Tensor] = None


def _initial_state(o, d, cone, medium=None, time=None) -> PathState:
    n = o.shape[0]
    dev = o.device
    return PathState(
        o=o, d=d,
        beta=torch.ones((n, 3), dtype=_F32, device=dev),
        L=torch.zeros((n, 3), dtype=_F32, device=dev),
        eta_scale=torch.ones((n,), dtype=_F32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        specular=torch.ones((n,), dtype=torch.bool, device=dev),  # camera rays
        prev_bsdf_pdf=torch.zeros((n,), dtype=_F32, device=dev),
        cone_w=torch.full((n,), 0.0 if cone is None else cone[0], dtype=_F32, device=dev),
        medium=(None if medium is None
                else torch.full((n,), medium, dtype=torch.int32, device=dev)),
        time=(None if time is None
              else torch.broadcast_to(torch.as_tensor(time, dtype=_F32, device=dev), (n,))),
    )


def _start(o, d, pixel, sample, seed, cone, medium=None, time=None):
    """The counter streams of the lanes, the cone spread and the camera
    rays' state, their medium ``medium`` (None: not tracked) and shutter
    times ``time`` (None: a static scene) -> (sampler, spread or None,
    PathState)."""
    n = o.shape[0]
    pixel = torch.broadcast_to(rng.as_u32(pixel, o.device), (n,))
    sample = torch.broadcast_to(rng.as_u32(sample, o.device), (n,))
    return (_Sampler(seed, pixel, sample), None if cone is None else cone[1],
            _initial_state(o, d, cone, medium, time))


def _scene_time(scene, time):
    """The lanes' shutter times where the scene moves, else None."""
    return time if scene.prims.anim is not None else None


def _emitted_mis(scene, st: PathState, hit, prim_idx, si, beta, all_lights=False,
                 mis=True):
    """Emitted radiance at the hits, MIS-weighted: camera and specular rays
    get weight 1 (path.go:48-63); BSDF rays the power-heuristic complement
    of NEE (integrator.go:133-192), their light's pick pmf read at the ray
    origin.  all_lights: every light is sampled at every vertex (pmf 1).
    mis=False (``PathConfig.mis``): BSDF rays get weight 0
    (integrators.py:801-816)."""
    le, hit_light = light_ops.le_emitted(scene.lights, scene.prims.area_light_id,
                                         prim_idx, si.n, si.wo)
    if mis and scene.n_lights > 0:
        lid = torch.clamp(hit_light, min=0)
        l_pdf = light_ops.pdf_li(scene.lights, lid, st.o, st.d)
        pick_pmf = (torch.ones_like(l_pdf) if all_lights
                    else _light_pick_pmf(scene, st.o, lid))
        w = torch.where(st.specular, 1.0, sampling.power_heuristic(
            1, st.prev_bsdf_pdf, 1, l_pdf * pick_pmf))
    else:
        w = torch.where(st.specular, 1.0, 0.0)
    return torch.where((hit & (hit_light >= 0))[..., None], beta * le * w[..., None], 0.0)


def _footprint(st: PathState, cone_spread, t, si):
    """Ray-cone width at the hit and projected onto the surface (capped at
    grazing), or (None, None) without a cone."""
    if cone_spread is None:
        return None, None
    fw_hit = st.cone_w + cone_spread * torch.abs(t)
    return fw_hit, fw_hit * torch.rsqrt(torch.clamp(geom.absdot(si.n, si.wo), min=0.05))


def _sample_bsdf(mp, si, ss, ts, ns, sampler: _Sampler, dim_base: int):
    """BSDF sampling at the hits (path.go:91-101) -> (the sample, its world
    direction)."""
    bs = bsdf_ops.bsdf_sample(mp, _to_local(ss, ts, ns, si.wo),
                              sampler.u2(dim_base + D_BSDF_UV),
                              sampler.u1(dim_base + D_BSDF_LOBE))
    return bs, _to_world(ss, ts, ns, bs.wi)


def _scatter(bs, wi_w, ns, beta, pdf):
    """The throughput after the BSDF sample ``bs`` toward ``wi_w``, divided
    by ``pdf`` -> (whether it carries light, the updated throughput)."""
    ok = (bs.pdf > 1e-9) & (torch.amax(torch.abs(bs.f), dim=-1) > 0.0)
    cos_term = geom.absdot(wi_w, ns)
    beta = beta * torch.where(
        ok[..., None], bs.f * (cos_term / torch.clamp(pdf, min=1e-20))[..., None], 0.0)
    return ok, beta


class _Features(NamedTuple):
    """What of media and null boundaries a scene has (integrators.py:662-676);
    each feature it lacks is left out of the bounce."""

    medium: object  # the global medium, or None
    use_tab: bool  # bounded media
    has_null: bool  # a null material
    has_iface: bool  # medium interfaces on prims

    @property
    def any_medium(self) -> bool:
        return self.medium is not None or self.use_tab


def _features(scene) -> _Features:
    info = scene.materials.info
    return _Features(scene.medium, scene.media is not None,
                     info is not None and bsdf_ops.NULLMAT in info.mat_types,
                     scene.prims.medium_inside is not None)


def _segments(scene, cfg: PathConfig, feat: _Features, sampler: _Sampler, dim_base: int,
              st: PathState):
    """The hit search of a bounce with media or null boundaries
    (integrators.py:678-776): up to 1 + ``cfg.null_passes`` closest-hit
    segments, stepping through null boundaries (switching the medium per
    the interface), each with a sampled scattering distance in the lane's
    medium and the per-channel MIS throughput.  -> (hit, scatter, t,
    prim_idx, o_eff (the finishing segment's origin), beta, p_med (the
    scattering point), the lanes' medium)."""
    n = st.o.shape[0]
    dev = st.o.device
    prims = scene.prims
    n_seg = 1 + (cfg.null_passes if feat.has_null else 0)
    o_cur, d_ray, mid_cur, walking, beta = st.o, st.d, st.medium, st.alive, st.beta
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    scatter = torch.zeros((n,), dtype=torch.bool, device=dev)
    t = torch.full((n,), 1e30, dtype=_F32, device=dev)
    prim_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    o_eff = p_med = st.o
    for k in range(n_seg):
        t_lim = torch.where(walking, 1e30, 1e-4)
        hit_k, t_k, prim_k = _scene_intersect(scene, o_cur, d_ray, t_lim, st.time)
        hit_k = hit_k & walking
        t_k, prim_k = t_k.detach(), prim_k.detach()
        scat_k = torch.zeros_like(hit_k)
        if feat.any_medium:
            # distance sampling on one channel, spectral MIS over the three
            # (HomogeneousMedium.Sample); vacuum lanes have sigma 0
            if feat.use_tab:
                sig_t, sig_s, _ = media_ops.table_lookup(scene.media, mid_cur)
            else:
                sig_t = torch.broadcast_to(feat.medium.sigma_t, (n, 3))
                sig_s = torch.broadcast_to(feat.medium.sigma_s, (n, 3))
            # later segments draw from a disjoint dimension region
            u_mc = sampler.u2(dim_base + D_MEDIUM if k == 0
                              else DIM_ALL_LIGHT_BASE // 2 + dim_base * 64 + 2 * k)
            ch = torch.clamp((u_mc[..., 0] * 3.0).to(torch.int32), max=2)
            st_ch = torch.gather(sig_t, -1, ch.long()[..., None])[..., 0]
            t_m = (-torch.log(torch.clamp(1.0 - u_mc[..., 1], min=1e-7))
                   / torch.clamp(st_ch, min=1e-20)).detach()
            seg = torch.where(hit_k, t_k, 1e8)
            scat_k = walking & (t_m < seg)
            tr = torch.exp(-sig_t * torch.minimum(t_m, seg)[..., None])
            pdf_scat = torch.mean(sig_t * tr, dim=-1)
            pdf_surf = torch.mean(tr, dim=-1)
            w_med = torch.where(scat_k[..., None],
                                tr * sig_s / torch.clamp(pdf_scat, min=1e-20)[..., None],
                                tr / torch.clamp(pdf_surf, min=1e-20)[..., None])
            beta = torch.where(walking[..., None], beta * w_med, beta)
            p_med = torch.where(scat_k[..., None], o_cur + d_ray * t_m[..., None], p_med)
        finish_k = walking
        if feat.has_null:
            mat_k = prims.material_id[prim_k.long()].long()
            is_null_k = (hit_k & ~scat_k
                         & (scene.materials.mat_type[mat_k] == bsdf_ops.NULLMAT))
            finish_k = walking & ~is_null_k
        hit = torch.where(finish_k, hit_k & ~scat_k, hit)
        scatter = torch.where(finish_k, scat_k, scatter)
        t = torch.where(finish_k, t_k, t)
        prim_idx = torch.where(finish_k, prim_k, prim_idx)
        o_eff = torch.where(finish_k[..., None], o_cur, o_eff)
        if not feat.has_null:
            break
        if k + 1 < n_seg:
            # step just past the boundary and switch the medium
            # (medium.go:15-25)
            si_b = isect.surface_interaction(prims, is_null_k, t_k, prim_k, o_cur, d_ray,
                                             st.time)
            o_next = geom.offset_ray_origin(si_b.p, si_b.p_err + 1e-4, si_b.n, d_ray)
            o_cur = torch.where(is_null_k[..., None], o_next, o_cur)
            if feat.has_iface:
                mid_cur = _cross_interface(prims, prim_k, dot(d_ray, si_b.n) < 0.0,
                                           is_null_k, mid_cur)
        walking = walking & is_null_k
    return hit, scatter, t, prim_idx, o_eff, beta, p_med, mid_cur


def _bounce_once(scene, cfg: PathConfig, sampler: _Sampler, bounce_idx: int,
                 st: PathState, cone_spread=None) -> PathState:
    """One path-tracing bounce over the wavefront (integrators.py:654-957).

    A scene without media or null materials intersects one segment; with
    them ``_segments`` walks through null boundaries and samples medium
    vertices, which are spliced into the wavefront (their lobe the HG
    phase function, their next direction HG-sampled).  Bump mapping and
    the BSSRDF's probe transport run where the scene has them; a
    refraction through an interface switches the lane's medium.  NEE runs
    where ``cfg.nee`` (integrators.py:869); ``cfg.mis`` gates the emitter
    hits' MIS weight (``_emitted_mis``).  The reference's gates as they
    are: with nee off and mis on, BSDF-sampled emitter hits keep the
    power-heuristic weight while NEE adds nothing, so the estimate is low;
    with both off only camera and specular rays see emitters.

    The detached-sampling estimator of the reference: the hit search, the
    sampled distance, the sampled direction, its pdf in the throughput and
    in the next MIS weight, and the roulette's survival scale carry no
    gradient (integrators.py:696-697, 721, 883, 889, 904, 939, 951); the
    shading at the hit is derived again from (t, prim) and keeps its
    gradient."""
    dim_base = DIM_BOUNCE_BASE + bounce_idx * DIMS_PER_BOUNCE
    feat = _features(scene)
    scatter = None
    mid_cur = st.medium
    if feat.has_null or feat.any_medium:
        hit, scatter, t, prim_idx, o_eff, beta_in, p_med, mid_cur = _segments(
            scene, cfg, feat, sampler, dim_base, st)
        if not feat.any_medium:
            scatter = None
        alive = st.alive & (hit if scatter is None else hit | scatter)
    else:
        t_lim = torch.where(st.alive, 1e30, 1e-4)
        hit_k, t_k, prim_k = _scene_intersect(scene, st.o, st.d, t_lim, st.time)
        t_k, prim_k = t_k.detach(), prim_k.detach()
        hit = hit_k & st.alive
        t = torch.where(st.alive, t_k, 1e30)
        prim_idx = torch.where(st.alive, prim_k, 0)
        o_eff, beta_in = st.o, st.beta
        # escaped rays find no light: the scene has no infinite lights
        alive = st.alive & hit
    with trace.span("li.surface"):
        si = isect.surface_interaction(scene.prims, hit, t, prim_idx, o_eff, st.d, st.time)
        # per-lane phase asymmetry with bounded media
        phase_g = media_ops.table_lookup(scene.media, mid_cur)[2] if feat.use_tab else None

        # a medium vertex is no emitter hit: ``hit`` excludes it
        L = st.L + _emitted_mis(scene, st, hit, prim_idx, si, beta_in, mis=cfg.mis)

        si = _apply_bump(scene, si)
        fw_hit, fw_surf = _footprint(st, cone_spread, t, si)
        mp = _material_at(scene, si, fw=fw_surf)
        if scatter is not None:
            # splice medium vertices in: at the scattering point, the frame
            # facing back along the ray (MediumInteraction, interaction.go:
            # 299-307), the gathered material neutralized to MATTE
            back = -st.d
            zero = torch.zeros_like(si.p)
            si = _where_si(scatter, si._replace(p=p_med, p_err=zero, n=back, ns=back,
                                                wo=back, dpdu=zero, dpdv=zero), si)
            mp = mp._replace(mat_type=torch.where(scatter, bsdf_ops.MATTE, mp.mat_type))
        beta0 = beta_in
        if scene.materials.sss_d is not None:
            si, mp, beta0, alive = _subsurface_transport(scene, si, mp, beta0, alive,
                                                         sampler, dim_base, st.time)
        ss, ts, ns = _shading_frame(si)
    if cfg.nee:
        with trace.span("li.nee"):
            L = L + beta0 * _estimate_direct(
                scene, si, mp, ss, ts, ns, alive, sampler, dim_base, medium_scatter=scatter,
                phase_g=phase_g, medium_ids=mid_cur if feat.use_tab else None,
                null_passes=cfg.null_passes if feat.has_null else 0, time=st.time)

    bs, wi_w = _sample_bsdf(mp, si, ss, ts, ns, sampler, dim_base)
    wi_w = wi_w.detach()
    ok, beta = _scatter(bs, wi_w, ns, beta0, bs.pdf.detach())
    next_pdf, next_specular = bs.pdf, bs.is_specular
    if scatter is not None:
        # medium vertices go on along an HG-sampled direction: f == pdf, a
        # throughput factor of exactly 1
        wi_m, ph_pdf = media_ops.sample_phase(
            si.wo, sampler.u2(dim_base + D_PHASE),
            phase_g if feat.use_tab else feat.medium.g)
        wi_w = torch.where(scatter[..., None], wi_m.detach(), wi_w)
        ok = ok | scatter
        beta = torch.where(scatter[..., None], beta0, beta)
        next_pdf = torch.where(scatter, ph_pdf, next_pdf)
        next_specular = next_specular & ~scatter
    eta_scale = st.eta_scale * bs.eta_scale
    alive = alive & ok & (torch.amax(beta, dim=-1) > 0.0)
    o_new = isect.spawn_ray(si, wi_w)
    if scatter is not None:
        o_new = torch.where(scatter[..., None], si.p, o_new)
    if feat.has_iface and feat.use_tab:
        # a refraction through an interface (a glass shell) carries the ray
        # into the other medium; medium vertices and reflections keep theirs
        crossed = alive & bs.is_transmission
        if scatter is not None:
            crossed = crossed & ~scatter
        mid_cur = _cross_interface(scene.prims, si.prim_idx, dot(wi_w, si.n) < 0.0, crossed,
                                   mid_cur)

    # Russian roulette (path.go:143-153)
    rr_beta_max = torch.amax(beta * eta_scale[..., None], dim=-1)
    q = torch.clamp(1.0 - rr_beta_max, min=0.05)
    do_rr = (bounce_idx >= cfg.rr_start_depth) & (rr_beta_max < cfg.rr_threshold)
    killed = do_rr & (sampler.u1(dim_base + D_RR) < q)
    beta = beta * torch.where(do_rr & ~killed, 1.0 / (1.0 - q), 1.0).detach()[..., None]

    return PathState(
        o=o_new, d=wi_w, beta=beta, L=L, eta_scale=eta_scale,
        alive=alive & ~killed, specular=next_specular, prev_bsdf_pdf=next_pdf.detach(),
        cone_w=st.cone_w if cone_spread is None else fw_hit, medium=mid_cur, time=st.time,
    )


def _where_state(mask, a: PathState, b: PathState) -> PathState:
    """Lane-select between two PathStates (integrators.py:960-967)."""
    return PathState(*(None if x is None else torch.where(
        mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y) for x, y in zip(a, b)))


def _li_compacted(scene, cfg: PathConfig, sampler: _Sampler, st: PathState,
                  cone_spread) -> PathState:
    """The compacted bounce loop (integrators.py:970-1032): each bounce
    sorts the live lanes to the front (a stable argsort) and runs
    ceil(live / C) chunks of C = min(chunk_size, N) lanes through
    ``_bounce_once``, each chunk's state (its counter streams, medium and
    time columns included) gathered and scattered back; the loop ends at
    max_depth or when no lane lives.  Sizing the chunks reads the live
    count on the host: one sync a bounce.  The last chunk's padding slots
    past N gather lane N - 1 (the reference's clamped gather) and are left
    out of the scatter (its dropped writes); slots past the live count run
    dead and write their lanes back unchanged.  Each bounce counts its
    sync (``host_syncs`` under the key "compaction", on a card), its live
    lanes (``li.lanes_live``) and the chunk slots it runs (``li.lanes_run``)
    in the tracer."""
    n = st.o.shape[0]
    c = min(cfg.chunk_size, n)
    # the state is written in place: the caller's o and d stay theirs
    st = PathState(*(None if x is None else x.clone() for x in st))
    slots = torch.arange(c, device=st.o.device)
    for bounce_idx in range(cfg.max_depth):
        m = int(trace.to_host(st.alive.sum(), key="compaction"))
        trace.count("li.lanes_live", m, key=bounce_idx)
        trace.count("li.lanes_run", math.ceil(m / c) * c, key=bounce_idx)
        if m == 0:
            break
        order = torch.argsort((~st.alive).to(torch.int8), stable=True)
        for k in range(math.ceil(m / c)):
            pos = k * c + slots
            idx = order[torch.clamp(pos, max=n - 1)]
            sub = PathState(*(None if x is None else x[idx] for x in st))
            active = pos < m
            out = _bounce_once(scene, cfg, sampler.take(idx), bounce_idx,
                               sub._replace(alive=sub.alive & active), cone_spread)
            out = _where_state(active, out, sub)
            real = min(c, n - k * c)  # the slots that are not padding
            for x, y in zip(st, out):
                if x is not None:
                    x.index_copy_(0, idx[:real], y[:real])
    return st


def _count_lanes(bounce_idx: int, alive: torch.Tensor) -> None:
    """The lanes a bounce runs over (``li.lanes_run``) and those alive
    entering it (``li.lanes_live``: the mask, which the tracer sums when
    read, so tracing adds no operation to the chain), under the key
    ``bounce_idx``, where the program traces."""
    if trace.on():
        trace.count("li.lanes_run", alive.numel(), key=bounce_idx)
        trace.count("li.lanes_live", alive, key=bounce_idx)


def _sanitize(L: torch.Tensor) -> torch.Tensor:
    """NaN/Inf lanes to zero, negatives clamped (integrator.go:256-262).
    ``torch.maximum``, not ``clamp``: at a channel that is exactly 0 it
    passes half the gradient, as the reference's ``jnp.maximum`` does."""
    bad = ~torch.all(torch.isfinite(L), dim=-1)
    return torch.where(bad[..., None], 0.0, torch.maximum(L, torch.zeros_like(L)))


def _li_wavefront(scene, o, d, pixel, sample, seed, cfg: PathConfig = PathConfig(),
                  cone=None, time=None) -> torch.Tensor:
    """The general wavefront bounce loop (``_li_jnp``,
    integrators.py:1072-1140): radiance f32[N,3] of rays (o, d).

    cone: optional (width0, spread) ray-cone floats enabling filtered
    texture lookups.  time: the rays' shutter times f32[N] (read where the
    scene moves).  cfg.early_exit stops once every lane is dead (one host
    sync per bounce); cfg.compaction runs ``_li_compacted``, which raises
    where autograd would need a gradient through it,
    as the reference's dynamic loops have none.  The camera rays start in
    the scene's camera medium where it has bounded media
    (integrators.py:1106-1110).
    """
    medium = None
    if scene.media is not None:
        medium = scene.camera_medium
    elif scene.prims.medium_inside is not None:
        medium = -1
    sampler, cone_spread, state = _start(o, d, pixel, sample, seed, cone, medium,
                                         _scene_time(scene, time))
    if cfg.compaction:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [o, d] + [v for _, v in packed.float_sources(scene)]):
            raise RuntimeError("PathConfig(compaction=True) is not differentiable (its "
                               "loops depend on the data, as the reference's do); render "
                               "with compaction=False for gradients")
        return _sanitize(_li_compacted(scene, cfg, sampler, state, cone_spread).L)
    for i in range(cfg.max_depth):
        if cfg.early_exit and not bool(trace.to_host(state.alive.any())):
            break
        _count_lanes(i, state.alive)
        state = _bounce_once(scene, cfg, sampler, i, state, cone_spread)
    return _sanitize(state.L)


# ---------------------------------------------------------------------------
# The direct-lighting integrator
# ---------------------------------------------------------------------------


def li_direct(scene, o, d, pixel, sample, seed, max_depth: int = 5, cone=None,
              light_strategy: str = "one", time=None) -> torch.Tensor:
    """Direct-lighting integrator (directlighting.go:62-101;
    integrators.py:1143-1305): NEE at every vertex, recursion through
    specular surfaces only.

    light_strategy: "one" = UniformSampleOneLight; "all" = every light at
    every vertex, no pick pmf.  Diffuse vertices scatter one more segment
    whose only job is the emitter hit with the power-heuristic complement
    (the BSDF branch of EstimateDirect), then die; a final closest-hit pass
    after the bounces reads those segments' emitters.  A global medium
    attenuates every segment by its transmittance, with no in-scattering
    (direct lighting ignores multiple scattering); bump mapping and the
    BSSRDF's probe transport run as in the path integrator.  time: the
    rays' shutter times f32[N] (read where the scene moves).
    """
    if light_strategy not in ("one", "all"):
        raise ValueError(f"light_strategy must be 'one' or 'all', got {light_strategy!r}")
    all_lights = light_strategy == "all"
    sampler, cone_spread, st = _start(o, d, pixel, sample, seed, cone,
                                      time=_scene_time(scene, time))

    def closest(st):
        """The lanes' closest hits, their record, and the state with the
        global medium's transmittance up to the hit."""
        t_max = torch.where(st.alive, 1e30, 1e-4)
        hit, t, prim_idx = _scene_intersect(scene, st.o, st.d, t_max, st.time)
        hit = hit & st.alive
        with trace.span("li.surface"):
            si = isect.surface_interaction(scene.prims, hit, t, prim_idx, st.o, st.d,
                                           st.time)
        if scene.medium is not None:
            st = st._replace(beta=st.beta * media_ops.transmittance(
                scene.medium, torch.where(hit, t, 0.0)))
        return st, hit, t, prim_idx, si

    for bounce_idx in range(max_depth):
        dim_base = DIM_BOUNCE_BASE + bounce_idx * DIMS_PER_BOUNCE
        _count_lanes(bounce_idx, st.alive)
        st, hit, t, prim_idx, si = closest(st)
        with trace.span("li.surface"):
            L = st.L + _emitted_mis(scene, st, hit, prim_idx, si, st.beta, all_lights)
            # diffuse-continuation lanes existed only for the emitter check
            alive = st.alive & hit & st.specular
            si = _apply_bump(scene, si)
            fw_hit, fw_surf = _footprint(st, cone_spread, t, si)
            mp = _material_at(scene, si, fw=fw_surf)
            beta0 = st.beta
            if scene.materials.sss_d is not None:
                si, mp, beta0, alive = _subsurface_transport(scene, si, mp, beta0, alive,
                                                             sampler, dim_base, st.time)
            ss, ts, ns = _shading_frame(si)
        if all_lights:
            for k in range(scene.n_lights):
                with trace.span("li.nee"):
                    L = L + beta0 * _estimate_direct(scene, si, mp, ss, ts, ns, alive,
                                                     sampler, dim_base, fixed_light=k,
                                                     time=st.time)
        else:
            with trace.span("li.nee"):
                L = L + beta0 * _estimate_direct(scene, si, mp, ss, ts, ns, alive,
                                                 sampler, dim_base, time=st.time)
        # specular lanes recurse (directlighting.go:97-101); diffuse lanes
        # get one MIS segment
        bs, wi_w = _sample_bsdf(mp, si, ss, ts, ns, sampler, dim_base)
        ok, beta = _scatter(bs, wi_w, ns, beta0, bs.pdf)
        st = PathState(
            o=isect.spawn_ray(si, wi_w), d=wi_w, beta=beta, L=L,
            eta_scale=st.eta_scale, alive=alive & ok, specular=bs.is_specular,
            prev_bsdf_pdf=bs.pdf, cone_w=st.cone_w if cone_spread is None else fw_hit,
            time=st.time,
        )

    # the emission-only pass: lanes whose last vertex scattered
    _count_lanes(max_depth, st.alive)
    st, hit, _, prim_idx, si = closest(st)
    with trace.span("li.surface"):
        L = st.L + _emitted_mis(scene, st, hit, prim_idx, si, st.beta, all_lights)
    return _sanitize(L)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def li_fused(kernel: megakernel.Kernel, scene, o, d, pixel, sample, seed, cfg: PathConfig,
             cone=None) -> torch.Tensor:
    """Drop-in for ``li`` on the scenes the bounce megakernel ``kernel``
    (``megakernel.BRUTE`` or ``mesh_megakernel.MESH``) takes: radiance
    f32[N,3].  CUDA tensors launch it on the current stream
    (``megakernel.make_launch``); CPU tensors run its plain twin,
    ``megakernel.path_li_plain``.  cone: optional (width0, spread) ray-cone
    floats, with no gradient.  The result carries a gradient to o, d and
    the scene's float tensors by path replay through ``_li_wavefront``
    (``megakernel.replayed``; pallas_mesh_megakernel.py:1521-1556: the mesh
    kernel reads the build's material rows, the replay
    ``scene.materials``).  A cfg with nee or mis off raises."""
    megakernel.check_cfg(cfg)
    if cone is not None and any(torch.is_tensor(c) and c.requires_grad for c in cone):
        raise ValueError("the ray cone is a pair of floats: no gradient reaches it")

    def run():
        if o.device.type == "cpu":
            p, s = megakernel.check_inputs(kernel, scene, o, d, pixel, sample)
            return megakernel.path_li_plain(scene, o, d, p, s, seed, cfg, cone=cone,
                                            accel=kernel.accel)
        out = torch.empty(o.shape, dtype=torch.float32, device=o.device)
        if o.shape[0] == 0:
            return out
        return megakernel.make_launch(kernel, scene, o, d, pixel, sample, seed, cfg, cone, out)()

    def replay(scene_, o_, d_):
        return _li_wavefront(scene_, o_, d_, pixel, sample, seed, cfg, cone=cone)

    return megakernel.replayed(run, replay, scene, o, d)


def li(scene, o: torch.Tensor, d: torch.Tensor, pixel, sample, seed,
       cfg: PathConfig = PathConfig(), cone=None, time=None) -> torch.Tensor:
    """Path.Li (path.go:32-157): radiance f32[N,3] for rays (o, d)[N].

    pixel/sample: uint32 counters (int64 tensors) feeding the stateless
    sampler; cone: optional (width0, spread) ray-cone floats; time: the
    rays' shutter times f32[N] on an animated scene.  The route, read here
    alone: scenes inside the fast-path set, up to the brute-force cutoff,
    run the brute megakernel (integrators.py:103-120; its launch refuses a
    scene it does not fit); mesh fast-path scenes above it with a BVH run
    the mesh megakernel (:123-141); both through ``li_fused``, and both
    need a static scene and neither compaction nor ``early_exit``, and NEE
    with MIS (``cfg.nee`` and ``cfg.mis``), which the kernels bake in.
    Every other run takes the general wavefront loop
    (integrators.py:1059-1069).  The counter ``li.route`` counts each call
    under the way it took: ``brute_megakernel``, ``bvh_megakernel`` or
    ``chain``.
    """
    fi, kernel = scene.fastinfo, None
    if (fi is not None and scene.prims.anim is None and cfg.nee and cfg.mis
            and not cfg.compaction and not cfg.early_exit):
        if fi.ok and scene.prims.count <= BRUTE_FORCE_CUTOFF:
            kernel = megakernel.BRUTE
        elif mesh_megakernel.fits(scene):
            kernel = mesh_megakernel.MESH
    if kernel is None:
        trace.count("li.route", 1, key="chain")
        return _li_wavefront(scene, o, d, pixel, sample, seed, cfg, cone=cone, time=time)
    trace.count("li.route", 1, key=f"{kernel.accel}_megakernel")
    return li_fused(kernel, scene, o, d, pixel, sample, seed, cfg, cone=cone)
