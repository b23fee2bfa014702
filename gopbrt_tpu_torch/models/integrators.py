"""Wavefront integrators: path tracing and direct lighting.

Counterpart of ``gopbrt_tpu/models/integrators.py`` for static surface
scenes (no media, subsurface, null materials, bump or animation):
``PathConfig``, the intersection dispatch
(``_scene_intersect`` / ``_scene_intersect_p``), the global light pick,
``_material_at``, the shading frame, ``_estimate_direct`` (NEE with MIS),
``PathState``, ``_bounce_once``, the wavefront loop ``_li_wavefront`` (the
JAX package's ``_li_jnp``), ``li_direct`` and the dispatch ``li``.

The whole batch of rays advances bounce by bounce as SoA tensors with an
alive mask, as in the JAX chain, and draws the same counter-based random
numbers, so both packages trace the same paths.  On CUDA tensors the
intersections launch the kernels of ``csrc/bvh_intersect.cu``
(``ops/bvh.bvh_intersect_fused`` / ``bvh_intersect_p_fused``) on scenes
above BRUTE_FORCE_CUTOFF prims with a BVH, those of ``csrc/intersect.cu``
(``ops/brute_intersect.intersect_brute_fused`` /
``intersect_p_brute_fused``) on the others; on CPU tensors they run the
plain versions.  Under ``li``, fast-path scenes run the bounce megakernel
(``ops/megakernel.path_li_fused``) and mesh fast-path scenes above the
cutoff the mesh megakernel (``ops/mesh_megakernel.mesh_li_fused``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gopbrt_tpu_torch.ops import brute_intersect, megakernel, mesh_megakernel, rng, sampling
from gopbrt_tpu_torch.ops import bvh as bvh_ops
from gopbrt_tpu_torch.ops import bsdf as bsdf_ops
from gopbrt_tpu_torch.ops import geom
from gopbrt_tpu_torch.ops import intersect as isect
from gopbrt_tpu_torch.ops import lights as light_ops
from gopbrt_tpu_torch.ops import texture as tex_ops
from gopbrt_tpu_torch.ops.geom import dot, normalize
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

# brute force below this prim count (no BVH)
BRUTE_FORCE_CUTOFF = 64

_F32 = torch.float32


class PathConfig(NamedTuple):
    """Integrator configuration (NewPath, path.go:10-17)."""

    max_depth: int = 5
    rr_threshold: float = 1.0
    rr_start_depth: int = 3  # RR after 3 bounces (path.go:143-153)
    # stop the bounce loop once every lane is dead
    early_exit: bool = False


class _Sampler:
    """The counter streams of one batch: rng.sample_1d(seed, pixel, sample,
    dim) with the (seed, pixel, sample) part of the hash chain computed
    once (rng.stream_u32 hashes dim last), so each draw is one more
    hash_combine."""

    def __init__(self, seed, pixel, sample):
        h = rng.hash_combine(rng.as_u32(seed, pixel.device), rng.as_u32(pixel))
        self.h = rng.hash_combine(h, sample)

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


def _scene_intersect(scene, o, d, t_max):
    """Closest hit -> (hit, t, prim_idx): the BVH walk or the brute sweep,
    as kernels on CUDA tensors and as plain versions on CPU tensors
    (integrators.py:144-177)."""
    args = (o.contiguous(), d.contiguous(), t_max.contiguous())
    if _use_bvh(scene):
        return bvh_ops.bvh_intersect_fused(scene.bvh_tables, *args)
    return brute_intersect.intersect_brute_fused(brute_intersect.scene_table(scene), *args)


def _scene_intersect_p(scene, o, d, t_max):
    """Any hit closer than t_max -> bool[N] (integrators.py:180-204)."""
    args = (o.contiguous(), d.contiguous(), t_max.contiguous())
    if _use_bvh(scene):
        return bvh_ops.bvh_intersect_p_fused(scene.bvh_tables, *args)
    return brute_intersect.intersect_p_brute_fused(brute_intersect.scene_table(scene),
                                                   *args)


def _light_pick(scene, u):
    """Pick a light for NEE from the global uniform / power distribution
    (integrators.py:215-228; the spatial grid is not ported)."""
    return sampling.sample_discrete(scene.light_func, scene.light_cdf,
                                    scene.light_func_int, u)


def _light_pick_pmf(scene, light_idx):
    """pmf that _light_pick chooses light_idx (the MIS denominator)."""
    return sampling.discrete_pmf(scene.light_func, scene.light_func_int,
                                 light_idx.long())


def _material_at(scene, si: isect.SurfaceInteraction, fw=None) -> bsdf_ops.MaterialParams:
    """Material parameters at the hits, textures evaluated
    (ComputeScatteringFunctions; integrators.py:281-320).  The one-hot
    matmul of the JAX version is a TPU device; a row gather reads the same
    rows."""
    mats = scene.materials
    mid = scene.prims.material_id[si.prim_idx.long()].long()
    kd_tex = mats.kd_tex[mid]
    kd_sampled = tex_ops.eval_spectrum(scene.textures, kd_tex, si.p, si.uv, fw=fw)
    return bsdf_ops.MaterialParams(
        mat_type=mats.mat_type[mid],
        kd=torch.where((kd_tex >= 0)[..., None], kd_sampled, mats.kd[mid]),
        sigma=mats.sigma[mid],
        kr=mats.kr[mid],
        kt=mats.kt[mid],
        eta=mats.eta[mid],
        roughness=mats.roughness[mid],
        info=mats.info,
    )


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
                     dim_base: int, fixed_light=None):
    """One-light NEE with MIS (UniformSampleOneLight + EstimateDirect,
    integrator.go:48-77, 79-195) over the wavefront -> rgb f32[N,3], already
    divided by the pick pmf.

    fixed_light: a light index for the sample-all-lights strategy
    (UniformSampleAllLights, integrator.go:23-46): no pick pmf, and each
    light draws from a disjoint dimension region.  The BSDF branch of the
    MIS pair is the emitter hit of the next segment.
    """
    n_lights = scene.n_lights
    if n_lights == 0:
        return torch.zeros_like(si.p)
    if fixed_light is None:
        light_idx, pick_pmf = _light_pick(scene, sampler.u1(dim_base + D_LIGHT_PICK))
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
    contributes = (active & (ls.pdf > 0.0) & (torch.amax(ls.li, dim=-1) > 0.0)
                   & (torch.amax(f, dim=-1) > 0.0))

    # shadow ray (VisibilityTester.Unoccluded, light.go:46-48), short of the
    # light; lanes that do not contribute get a zero-length ray
    o_sh = isect.spawn_ray(si, ls.wi)
    t_sh = ls.dist * (1.0 - geom.SHADOW_EPSILON) - 1e-3
    t_sh = torch.where(contributes, torch.clamp(t_sh, min=1e-4), 1e-4)
    vis = contributes & ~_scene_intersect_p(scene, o_sh, ls.wi, t_sh)

    # delta lights unweighted, area lights by the power heuristic
    weight = torch.where(ls.is_delta, 1.0,
                         sampling.power_heuristic(1, ls.pdf, 1, b_pdf))
    gain = weight / torch.clamp(ls.pdf, min=1e-20) / torch.clamp(pick_pmf, min=1e-20)
    return torch.where(vis[..., None], f * ls.li * gain[..., None], 0.0)


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


def _initial_state(o, d, cone) -> PathState:
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
    )


def _start(o, d, pixel, sample, seed, cone):
    """The counter streams of the lanes, the cone spread and the camera
    rays' state -> (sampler, spread or None, PathState)."""
    n = o.shape[0]
    pixel = torch.broadcast_to(rng.as_u32(pixel, o.device), (n,))
    sample = torch.broadcast_to(rng.as_u32(sample, o.device), (n,))
    return (_Sampler(seed, pixel, sample), None if cone is None else cone[1],
            _initial_state(o, d, cone))


def _emitted_mis(scene, st: PathState, hit, prim_idx, si, beta, all_lights=False):
    """Emitted radiance at the hits, MIS-weighted: camera and specular rays
    get weight 1 (path.go:48-63); BSDF rays the power-heuristic complement
    of NEE (integrator.go:133-192), their light's pick pmf read at the ray
    origin.  all_lights: every light is sampled at every vertex (pmf 1)."""
    le, hit_light = light_ops.le_emitted(scene.lights, scene.prims.area_light_id,
                                         prim_idx, si.n, si.wo)
    if scene.n_lights > 0:
        lid = torch.clamp(hit_light, min=0)
        l_pdf = light_ops.pdf_li(scene.lights, lid, st.o, st.d)
        pick_pmf = torch.ones_like(l_pdf) if all_lights else _light_pick_pmf(scene, lid)
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


def _sample_bsdf(mp, si, ss, ts, ns, sampler: _Sampler, dim_base: int, beta):
    """BSDF sampling at the hits (path.go:91-101) -> (the sample, its world
    direction, whether it carries light, the updated throughput)."""
    bs = bsdf_ops.bsdf_sample(mp, _to_local(ss, ts, ns, si.wo),
                              sampler.u2(dim_base + D_BSDF_UV),
                              sampler.u1(dim_base + D_BSDF_LOBE))
    wi_w = _to_world(ss, ts, ns, bs.wi)
    cos_term = geom.absdot(wi_w, ns)
    ok = (bs.pdf > 1e-9) & (torch.amax(torch.abs(bs.f), dim=-1) > 0.0)
    beta = beta * torch.where(
        ok[..., None], bs.f * (cos_term / torch.clamp(bs.pdf, min=1e-20))[..., None], 0.0)
    return bs, wi_w, ok, beta


def _bounce_once(scene, cfg: PathConfig, sampler: _Sampler, bounce_idx: int,
                 st: PathState, cone_spread=None) -> PathState:
    """One path-tracing bounce over the wavefront (integrators.py:654-957),
    surface scenes only: one segment, no medium, subsurface or bump."""
    dim_base = DIM_BOUNCE_BASE + bounce_idx * DIMS_PER_BOUNCE
    t_lim = torch.where(st.alive, 1e30, 1e-4)
    hit_k, t_k, prim_k = _scene_intersect(scene, st.o, st.d, t_lim)
    hit = hit_k & st.alive
    t = torch.where(st.alive, t_k, 1e30)
    prim_idx = torch.where(st.alive, prim_k, 0)
    si = isect.surface_interaction(scene.prims, hit, t, prim_idx, st.o, st.d)

    L = st.L + _emitted_mis(scene, st, hit, prim_idx, si, st.beta)
    # escaped rays find no light: the scene has no infinite lights
    alive = st.alive & hit

    fw_hit, fw_surf = _footprint(st, cone_spread, t, si)
    mp = _material_at(scene, si, fw=fw_surf)
    ss, ts, ns = _shading_frame(si)
    L = L + st.beta * _estimate_direct(scene, si, mp, ss, ts, ns, alive, sampler, dim_base)

    bs, wi_w, ok, beta = _sample_bsdf(mp, si, ss, ts, ns, sampler, dim_base, st.beta)
    eta_scale = st.eta_scale * bs.eta_scale
    alive = alive & ok & (torch.amax(beta, dim=-1) > 0.0)

    # Russian roulette (path.go:143-153)
    rr_beta_max = torch.amax(beta * eta_scale[..., None], dim=-1)
    q = torch.clamp(1.0 - rr_beta_max, min=0.05)
    do_rr = (bounce_idx >= cfg.rr_start_depth) & (rr_beta_max < cfg.rr_threshold)
    killed = do_rr & (sampler.u1(dim_base + D_RR) < q)
    beta = beta * torch.where(do_rr & ~killed, 1.0 / (1.0 - q), 1.0)[..., None]

    return PathState(
        o=isect.spawn_ray(si, wi_w), d=wi_w, beta=beta, L=L, eta_scale=eta_scale,
        alive=alive & ~killed, specular=bs.is_specular, prev_bsdf_pdf=bs.pdf,
        cone_w=st.cone_w if cone_spread is None else fw_hit,
    )


def _sanitize(L: torch.Tensor) -> torch.Tensor:
    """NaN/Inf lanes to zero, negatives clamped (integrator.go:256-262)."""
    bad = ~torch.all(torch.isfinite(L), dim=-1)
    return torch.where(bad[..., None], 0.0, torch.clamp(L, min=0.0))


def _li_wavefront(scene, o, d, pixel, sample, seed, cfg: PathConfig = PathConfig(),
                  cone=None) -> torch.Tensor:
    """The general wavefront bounce loop (``_li_jnp``,
    integrators.py:1072-1140): radiance f32[N,3] of rays (o, d).

    cone: optional (width0, spread) ray-cone floats enabling filtered
    texture lookups.  cfg.early_exit stops once every lane is dead (one
    host sync per bounce).
    """
    sampler, cone_spread, state = _start(o, d, pixel, sample, seed, cone)
    for i in range(cfg.max_depth):
        if cfg.early_exit and not bool(state.alive.any()):
            break
        state = _bounce_once(scene, cfg, sampler, i, state, cone_spread)
    return _sanitize(state.L)


# ---------------------------------------------------------------------------
# The direct-lighting integrator
# ---------------------------------------------------------------------------


def li_direct(scene, o, d, pixel, sample, seed, max_depth: int = 5, cone=None,
              light_strategy: str = "one") -> torch.Tensor:
    """Direct-lighting integrator (directlighting.go:62-101;
    integrators.py:1143-1305): NEE at every vertex, recursion through
    specular surfaces only.

    light_strategy: "one" = UniformSampleOneLight; "all" = every light at
    every vertex, no pick pmf.  Diffuse vertices scatter one more segment
    whose only job is the emitter hit with the power-heuristic complement
    (the BSDF branch of EstimateDirect), then die; a final closest-hit pass
    after the bounces reads those segments' emitters.
    """
    if light_strategy not in ("one", "all"):
        raise ValueError(f"light_strategy must be 'one' or 'all', got {light_strategy!r}")
    all_lights = light_strategy == "all"
    sampler, cone_spread, st = _start(o, d, pixel, sample, seed, cone)

    def closest(st):
        t_max = torch.where(st.alive, 1e30, 1e-4)
        hit, t, prim_idx = _scene_intersect(scene, st.o, st.d, t_max)
        hit = hit & st.alive
        return hit, t, prim_idx, isect.surface_interaction(scene.prims, hit, t,
                                                           prim_idx, st.o, st.d)

    for bounce_idx in range(max_depth):
        dim_base = DIM_BOUNCE_BASE + bounce_idx * DIMS_PER_BOUNCE
        hit, t, prim_idx, si = closest(st)
        L = st.L + _emitted_mis(scene, st, hit, prim_idx, si, st.beta, all_lights)
        # diffuse-continuation lanes existed only for the emitter check
        alive = st.alive & hit & st.specular
        fw_hit, fw_surf = _footprint(st, cone_spread, t, si)
        mp = _material_at(scene, si, fw=fw_surf)
        ss, ts, ns = _shading_frame(si)
        if all_lights:
            for k in range(scene.n_lights):
                L = L + st.beta * _estimate_direct(scene, si, mp, ss, ts, ns, alive,
                                                   sampler, dim_base, fixed_light=k)
        else:
            L = L + st.beta * _estimate_direct(scene, si, mp, ss, ts, ns, alive,
                                               sampler, dim_base)
        # specular lanes recurse (directlighting.go:97-101); diffuse lanes
        # get one MIS segment
        bs, wi_w, ok, beta = _sample_bsdf(mp, si, ss, ts, ns, sampler, dim_base, st.beta)
        st = PathState(
            o=isect.spawn_ray(si, wi_w), d=wi_w, beta=beta, L=L,
            eta_scale=st.eta_scale, alive=alive & ok, specular=bs.is_specular,
            prev_bsdf_pdf=bs.pdf, cone_w=st.cone_w if cone_spread is None else fw_hit,
        )

    # the emission-only pass: lanes whose last vertex scattered
    hit, _, prim_idx, si = closest(st)
    return _sanitize(st.L + _emitted_mis(scene, st, hit, prim_idx, si, st.beta,
                                         all_lights))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def li(scene, o: torch.Tensor, d: torch.Tensor, pixel, sample, seed,
       cfg: PathConfig = PathConfig(), cone=None) -> torch.Tensor:
    """Path.Li (path.go:32-157): radiance f32[N,3] for rays (o, d)[N].

    pixel/sample: uint32 counters (int64 tensors) feeding the stateless
    sampler; cone: optional (width0, spread) ray-cone floats.  Scenes inside
    the fast-path set, up to the brute-force cutoff, run the bounce
    megakernel (integrators.py:103-120); mesh fast-path scenes above it
    with a BVH run the mesh megakernel (:123-141); every other scene, and
    any ``early_exit`` run, runs the general wavefront loop
    (integrators.py:1059-1069).
    """
    fi = scene.fastinfo
    if fi is not None and not cfg.early_exit:
        if fi.ok and scene.prims.count <= BRUTE_FORCE_CUTOFF:
            return megakernel.path_li_fused(scene, o, d, pixel, sample, seed, cfg,
                                            cone=cone)
        if mesh_megakernel.fits(scene):
            return mesh_megakernel.mesh_li_fused(scene, o, d, pixel, sample, seed, cfg,
                                                 cone=cone)
    return _li_wavefront(scene, o, d, pixel, sample, seed, cfg, cone=cone)
