"""The bounce megakernels: the whole path-tracing loop in one CUDA kernel.

Counterpart of ``gopbrt_tpu/ops/pallas_megakernel.py`` and of the loop of
``gopbrt_tpu/ops/pallas_mesh_megakernel.py``.  The CUDA bounce skeleton
(``csrc/bounce.cuh``, path state in registers, persistent lanes that take
the next path when theirs ends) has two instances, each described by a
``Kernel`` record: the brute sweep over scene tables in shared memory
(``BRUTE``, ``csrc/megakernel.cu``) and the BVH walk
(``mesh_megakernel.MESH``, ``csrc/mesh_megakernel.cu``).  ``make_launch``
launches either.  ``path_li_plain`` is the plain version of both, a
lane-vectorised PyTorch transcription of the skeleton that follows it op
for op; ``accel`` picks its intersector.

Scope is the fast-path feature sets (ops/static_info.FastPathInfo): spheres
and disks (``ok``), plus world-space triangles and plastic (``mesh_ok``);
matte, mirror, smooth and rough glass; constant or planar-checker kd with
the ray-cone box filter; point, distant and sphere-area lights.

The kernels are forward only.  The integrator's ``li_fused`` returns their
radiance through ``replayed``, a ``torch.autograd.Function`` whose backward
replays the same paths (the same counter streams) through the
differentiable chain it hands in, ``integrators._li_wavefront``, and
backpropagates there: path-replay backpropagation, as the reference's
``custom_vjp`` (pallas_megakernel.py:1309-1357).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch
from torch.autograd.function import once_differentiable

from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.ops import bvh as bvh_ops
from gopbrt_tpu_torch.ops import packed, rng
from gopbrt_tpu_torch.ops.brute_intersect import (BIG, closest_hit, first_hit, flat_w2o,
                                                  scene_table)
from gopbrt_tpu_torch.ops.bsdf import GLASS, MIRROR, PLASTIC
from gopbrt_tpu_torch.ops.geom import INV_PI, PI, SHADOW_EPSILON
from gopbrt_tpu_torch.ops.intersect import TRIANGLE
from gopbrt_tpu_torch.ops.rng import (
    D_BSDF_LOBE,
    D_BSDF_UV,
    D_LIGHT_PICK,
    D_LIGHT_UV,
    D_RR,
    DIM_BOUNCE_BASE,
    DIMS_PER_BOUNCE,
)
from gopbrt_tpu_torch.utils import trace


# shade-table column layout (per primitive, f32[P, SH_K]) — the layout of
# pallas_megakernel.py:70-88
SH_C1 = 0        # 0-2  kd constant / checker colour 1
SH_C2 = 3        # 3-5  checker colour 2
SH_CHK = 6       # is_checker flag
SH_VS = 7        # 7-9  planar mapping s axis
SH_VT = 10       # 10-12 planar mapping t axis
SH_DS = 13       # 13-14 mapping offsets
SH_ALID = 15     # area_light_id (-1 none)
SH_SCALE2 = 16   # sigma^2 of the uniform scale
SH_TSS = 17      # |vs|
SH_TST = 18      # |vt|
SH_MIR = 19      # is_mirror flag
SH_KR = 20       # 20-22 mirror/glass reflectance
SH_GLS = 23      # is smooth glass flag
SH_KT = 24       # 24-26 glass transmittance
SH_ETA = 27      # glass interior IOR
SH_RGL = 28      # is rough glass flag
SH_ALPHA = 29    # GGX alpha
SH_K = 30
# a material row of the mesh instance (material_table): the shade columns
# (SH_ALID and SH_SCALE2 unused), the plastic flag, padding
SH_PLA = 30
MAT_K = 32
MAX_MATS = 16

# light aux columns (per light, f32[L, LA_K])
LA_TWO = 0       # two_sided flag
LA_CX = 1        # 1-3 sphere-emitter world center
LA_RAD = 4       # sphere-emitter world radius
LA_FUNC = 5      # light-distribution func value
LA_K = 8

# Packed table layout read by csrc/megakernel.cu (struct Tables): every
# table padded to MAX_PRIMS / MAX_LIGHTS rows, all float32, in this order.
MAX_PRIMS = 64
MAX_LIGHTS = 16
TABLE_LAYOUT = (
    ("w2o", MAX_PRIMS * 12),
    ("params", MAX_PRIMS * 9),
    ("shade", MAX_PRIMS * SH_K),
    ("ptype", MAX_PRIMS),
    ("ltype", MAX_LIGHTS),
    ("lpos", MAX_LIGHTS * 3),
    ("lint", MAX_LIGHTS * 3),
    ("laux", MAX_LIGHTS * LA_K),
    ("lcdf", MAX_LIGHTS + 1),
)
TABLE_WORDS = sum(n for _, n in TABLE_LAYOUT)

# kernel flag bits (csrc/megakernel.cu)
FLAG_FULL_SPH = 1
FLAG_FULL_DISK = 2
FLAG_USE_CONE = 4
FLAG_ANY_GLASS = 8
FLAG_ANY_ROUGH = 16


# fp32 operations the CUDA kernels spend on each event that path_li_plain
# and the plain BVH walk count, read off csrc/bounce.cuh (path_hit's
# sections, named below), csrc/prim_test.cuh and csrc/bvh.cuh.  An add,
# multiply, divide, square root, min / max, abs, floor, sine, cosine or
# compare counts one; selects, integer work and the RNG hash count none; an
# expression computed twice counts once.  Rare fallbacks (the degenerate
# shading frame, the farther quadratic root, the clips of partial spheres
# and disks) count none, so a bound built on these is a least count.
OPS_PER_EVENT = {
    # one primitive test (prim_test: the sphere to its discriminant) and
    # the sweep's compare; on a root, the roots and their t_eps
    "sphere_tests": 62,
    "sphere_roots": 18,
    "disk_tests": 49,  # prim_test: world->object, the disk, the sweep's compare
    "triangle_tests": 61,  # prim_test: Moller-Trumbore, the sweep's compare
    # plane_test (the mesh megakernel's walk): N.d, its degenerate cut, t,
    # the hit point, u and v, the accept compares (38), the leaf's compare
    "plane_tests": 39,
    # the BVH walk (bvh.cuh): the slab test of box_hit is 28; a ray's root
    # test; an interior node's two slab tests and its direction compare;
    # a pop's distance compare
    "bvh_roots": 28,
    "bvh_nodes": 57,
    "bvh_pops": 1,
    # a lane that hit a sphere or disk: path_hit's winner geometry, wo, the
    # ray-cone width, the shading frame and the BSDF sample's inputs
    "hits": 204,
    # a lane that hit a triangle: N normalised, p = o + t d, dpdu = e1 (21),
    # and the same rest (81)
    "triangle_hits": 102,
    "cone_hits": 3,  # the ray-cone width at the hit
    "emitter_hits": 7,  # the emitter's facing test
    "emissions": 9,  # the emission added to L
    "emission_mis": 46,  # its MIS weight with sphere_area_pdf_li (outside)
    "checker_hits": 12,  # the planar checker's (s, t)
    "checker_filtered": 66,  # its box filter over the ray-cone footprint
    "checker_unfiltered": 8,  # its parity
    "rough_hits": 31,  # F_o of rough glass, fresnel_diel
    # NEE on a lane that is neither mirror nor smooth glass: the light
    # pick's pmf, cos_i, the f and pdf gates; one compare per CDF entry
    "nee": 20,
    "cdf_steps": 1,
    "nee_point": 18,  # the point light's direction and 1/d^2
    "nee_distant": 1,
    "nee_area_outside": 117,  # the sphere-cone sample and its pdf
    "nee_area_inside": 66,  # the uniform-area sample and its conversion
    "nee_lambert": 8,  # Lambert's f and pdf toward the light
    "nee_rough": 257,  # rough glass's f and pdf, rough_glass_eval (247)
    "nee_plastic": 147,  # plastic's two lobes, ggx_reflection (135)
    "shadow_rays": 11,  # the shadow ray (its walk or sweep counts above)
    "unoccluded": 16,  # the contribution it carries (path_shadow adds it)
    "unoccluded_area": 5,  # the power heuristic of an area light's
    "mirror_samples": 8,  # the BSDF sample: mirror
    "glass_reflect": 44,  # FresnelSpecular, the reflection
    "glass_refract": 74,  # FresnelSpecular, the refraction and etaScale
    "rough_reflect": 371,  # rough glass: ggx_half_vector, reflect, the eval
    "rough_refract": 387,  # rough glass: ggx_half_vector, refract, the eval
    "plastic_ggx": 61,  # plastic's GGX half, with ggx_half_vector
    "lambert_samples": 59,  # the cosine hemisphere (plastic's diffuse half too)
    "plastic_samples": 164,  # plastic's two lobes toward the sample
    "bsdf_ok": 6,  # the throughput update and its gate
    "continues": 15,  # the spawn point and the path's next state
    "roulette": 9,  # Russian roulette
    "paths": 3,  # path_finish
}


def fp32_ops(counts: dict) -> int:
    """fp32 operations of a kernel run whose events path_li_plain counted."""
    return sum(OPS_PER_EVENT[k] * v for k, v in counts.items())


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------


def _shade_rows(scene, mid, alid, scale2) -> torch.Tensor:
    """Shade rows f32[K, SH_K] of the materials ``mid`` (long[K]), with the
    area-light and scale columns given."""
    mats, tex = scene.materials, scene.textures
    mtype = mats.mat_type[mid]
    is_mirror = mtype == MIRROR
    glass = mtype == GLASS
    rough = mats.roughness[mid] > 1e-4
    is_glass = glass & ~rough
    is_rough = glass & rough
    kd = torch.where((is_mirror | glass)[:, None], 0.0, mats.kd[mid])
    kt_id = mats.kd_tex[mid].long()
    safe = torch.clamp(kt_id, min=0)
    is_tex = kt_id >= 0
    is_chk = is_tex & (tex.tex_type[safe] == 1)  # TEX_CHECKERBOARD
    c1 = torch.where(is_tex[:, None], tex.value1[safe], kd)
    c2 = torch.where(is_chk[:, None], tex.value2[safe], c1)
    vs, vt, ds = tex.vs[safe], tex.vt[safe], tex.dsdt[safe]

    def col(x):
        return x.to(torch.float32)[:, None]

    return torch.cat(
        [
            c1, c2, col(is_chk), vs, vt, ds, col(alid), col(scale2),
            col(torch.sqrt(torch.sum(vs * vs, dim=-1))),
            col(torch.sqrt(torch.sum(vt * vt, dim=-1))),
            col(is_mirror), mats.kr[mid], col(is_glass), mats.kt[mid],
            col(mats.eta[mid]), col(is_rough),
            col(torch.clamp(mats.roughness[mid], min=1e-3)),
        ],
        dim=1,
    )


def shade_table(scene) -> torch.Tensor:
    """Per-primitive shading record f32[P, SH_K] (pallas_megakernel.py:1058)."""
    prims = scene.prims
    return _shade_rows(scene, prims.material_id.long(), prims.area_light_id,
                       bvh_ops.prim_scale2(prims))


def material_table(scene) -> torch.Tensor:
    """Per-material shading record f32[M, MAT_K] of the mesh instance
    (pallas_mesh_megakernel.py:188-242 in the SH_* layout): the shade
    columns, then the plastic flag (plastic: Lambert kd + GGX reflection
    with ks in SH_KR, eta and alpha)."""
    mats = scene.materials
    m = mats.mat_type.shape[0]
    dev = mats.kd.device
    rows = _shade_rows(scene, torch.arange(m, device=dev),
                       torch.full((m,), -1.0, device=dev), torch.ones((m,), device=dev))
    pla = (mats.mat_type == PLASTIC).to(torch.float32)[:, None]
    pad = torch.zeros((m, MAT_K - SH_K - 1), dtype=torch.float32, device=dev)
    return torch.cat([rows, pla, pad], dim=1).contiguous()


def light_tables(scene):
    """(ltype i32[L], lpos f32[L,3], lint f32[L,3], laux f32[L,8])
    (pallas_megakernel.py:1108)."""
    lights = scene.lights
    center = lights.o2w[:, :3, 3]
    scale = torch.sqrt(torch.sum(lights.o2w[:, :3, 0] * lights.o2w[:, :3, 0], dim=-1))
    radius_w = lights.params[:, 0] * scale
    zeros = torch.zeros((lights.count, 2), dtype=torch.float32, device=center.device)
    laux = torch.cat(
        [
            lights.two_sided.to(torch.float32)[:, None], center,
            radius_w[:, None], scene.light_func[:, None], zeros,
        ],
        dim=1,
    )
    return lights.light_type, lights.p, lights.intensity, laux


def pack_layout(parts: dict, layout) -> torch.Tensor:
    """The tables ``parts`` as one float32 tensor in ``layout`` order, each
    padded with zero rows to its words."""
    out = []
    for name, words in layout:
        t = parts[name].to(torch.float32)
        pad = torch.zeros((words // t.shape[1] - t.shape[0], t.shape[1]),
                          dtype=torch.float32, device=t.device)
        out.append(torch.cat([t, pad]).reshape(-1))
        assert out[-1].numel() == words
    return torch.cat(out).contiguous()


def light_parts(scene) -> dict:
    """The light tables by TABLE_LAYOUT name."""
    ltype, lpos, lint, laux = light_tables(scene)
    return dict(ltype=ltype[:, None], lpos=lpos, lint=lint, laux=laux,
                lcdf=scene.light_cdf[:, None])


def pack_tables(scene) -> torch.Tensor:
    """All tables as one float32[TABLE_WORDS] tensor in TABLE_LAYOUT order."""
    prims = scene.prims
    parts = dict(
        w2o=flat_w2o(prims),
        params=prims.params,
        shade=shade_table(scene),
        ptype=prims.prim_type[:, None],
        **light_parts(scene),
    )
    return pack_layout(parts, TABLE_LAYOUT)


class KernelTables(NamedTuple):
    """What every launch for one scene reads: the packed tables on the
    scene's device, two scene scalars on the host, and the key of the
    scene tensors they were packed from (``ops/packed.py``)."""

    tables: torch.Tensor  # f32[TABLE_WORDS]
    func_int: float
    world_radius: float
    key: tuple


def fits(scene) -> bool:
    """Whether the CUDA kernel takes the scene: the fast-path feature set,
    at most MAX_PRIMS prims and 1..MAX_LIGHTS lights."""
    return (scene.fastinfo is not None and scene.fastinfo.ok
            and scene.prims.count <= MAX_PRIMS
            and 1 <= scene.lights.count <= MAX_LIGHTS)


def scalar_sources(scene) -> tuple:
    """The scene tensors of a launch's two host scalars."""
    return (scene.light_func_int, scene.world_radius)


def host_scalars(scene, old) -> tuple:
    """(func_int, world_radius) as floats: those of the packed tables
    ``old`` while their tensors stand (their key ends with them), else read
    from the scene."""
    src = scalar_sources(scene)
    if old is not None and packed.holds(old.key[-len(src):], src):
        return old.func_int, old.world_radius
    return float(scene.light_func_int), float(scene.world_radius)


def _table_sources(scene) -> tuple:
    return packed.tensors(scene.prims, scene.materials, scene.textures, scene.lights,
                          scene.light_func, scene.light_cdf) + scalar_sources(scene)


def kernel_tables(scene, old=None) -> KernelTables:
    """Packs the scene for the kernel (the builder does it once per scene);
    ``old``: earlier tables of the scene, whose host scalars are kept while
    their tensors stand."""
    src = _table_sources(scene)
    return KernelTables(pack_tables(scene), *host_scalars(scene, old), packed.key(src))


def tables_for(scene) -> KernelTables:
    """What a launch on ``scene`` reads: ``scene.kernel`` while it was packed
    from the scene's tensors as they stand, else tables packed now (the
    reference packs them per call, pallas_megakernel.py:1225-1232)."""
    kt = scene.kernel
    if kt is not None and packed.holds(kt.key, _table_sources(scene)):
        return kt
    return kernel_tables(scene, kt)


def kernel_flags(scene, use_cone: bool) -> int:
    """The static flags of ``_mega_kernel`` as the CUDA kernel's bit set."""
    pinfo, fi = scene.prims.pinfo, scene.fastinfo
    flags = 0
    if pinfo is not None and pinfo.all_full_spheres:
        flags |= FLAG_FULL_SPH
    if pinfo is not None and pinfo.all_full_disks:
        flags |= FLAG_FULL_DISK
    if use_cone:
        flags |= FLAG_USE_CONE
    if fi.has_glass or fi.has_rough_glass:
        flags |= FLAG_ANY_GLASS
    if fi.has_rough_glass:
        flags |= FLAG_ANY_ROUGH
    return flags


# ---------------------------------------------------------------------------
# Lane helpers on component triples (1-D float32 tensors)
# ---------------------------------------------------------------------------


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _normalize3(x, y, z, eps):
    n2 = x * x + y * y + z * z
    inv = torch.where(n2 > eps, 1.0, 0.0) / torch.sqrt(
        torch.clamp(n2, min=max(eps, 1e-30))
    )
    return x * inv, y * inv, z * inv


def _coord_system(vx, vy, vz):
    sign = torch.where(vz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + vz)
    b = vx * vy * a
    u = (1.0 + sign * vx * vx * a, sign * b, -sign * vx)
    w = (b, sign + vy * vy * a, -vy)
    return u, w


def _fresnel_diel(cos_i, eta):
    ci0 = torch.clamp(cos_i, -1.0, 1.0)
    entering = ci0 > 0.0
    ei = torch.where(entering, 1.0, eta)
    et = torch.where(entering, eta, 1.0)
    ci = torch.abs(ci0)
    sin_i = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-20)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-20)
    return torch.where(tir, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))


def _ggx_d(c_wh, alpha):
    c2 = c_wh * c_wh
    t2 = (1.0 - c2) / torch.clamp(c2, min=1e-20)
    a2 = alpha * alpha
    e = t2 / torch.clamp(a2, min=1e-12)
    d = 1.0 / (PI * a2 * c2 * c2 * (1.0 + e) ** 2 + 1e-20)
    return torch.where(c2 > 1e-16, d, 0.0)


def _ggx_lambda(c_w, alpha):
    c2 = torch.clamp(c_w * c_w, min=1e-20)
    abs_tan = torch.sqrt(torch.clamp(1.0 - c2, min=0.0) / c2)
    a2t2 = (alpha * abs_tan) ** 2
    return (-1.0 + torch.sqrt(1.0 + a2t2)) / 2.0


def _power_heuristic(f, g):
    f2 = f * f
    g2 = g * g
    denom = f2 + g2
    pos = denom > 0.0
    return torch.where(pos, f2 / torch.where(pos, denom, 1.0), 0.0)


def _concentric_disk(u0, u1):
    ox = 2.0 * u0 - 1.0
    oy = 2.0 * u1 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    sx = ox / torch.where(oy == 0.0, 1.0, oy)
    sy = oy / torch.where(ox == 0.0, 1.0, ox)
    theta = torch.where(use_x, (PI / 4.0) * sy, (PI / 2.0) - (PI / 4.0) * sx)
    dx = r * torch.cos(theta)
    dy = r * torch.sin(theta)
    return torch.where(zero, 0.0, dx), torch.where(zero, 0.0, dy)


def _offset_dist(nx, ny, nz, px, py, pz):
    g7 = 7.0 * 5.96e-08 / (1.0 - 7.0 * 5.96e-08)
    err = g7 * (torch.abs(px) + torch.abs(py) + torch.abs(pz))
    anx, any_, anz = torch.abs(nx), torch.abs(ny), torch.abs(nz)
    return (anx + any_ + anz) * 1e-4 + (anx * err + any_ * err + anz * err)


def _sphere_area_pdf_li(rx, ry, rz, wx, wy, wz, cx, cy, cz, rad):
    """Solid-angle pdf of sphere-cone sampling generating w from r
    (pallas_megakernel.py:218-247)."""
    tcx, tcy, tcz = cx - rx, cy - ry, cz - rz
    dc2 = tcx * tcx + tcy * tcy + tcz * tcz
    outside = dc2 > rad * rad * 1.00002
    sin2_tmax = torch.clamp(rad * rad / torch.clamp(dc2, min=1e-20), 0.0, 1.0)
    cos_tmax = torch.sqrt(torch.clamp(1.0 - sin2_tmax, min=0.0))
    ncx, ncy, ncz = _normalize3(tcx, tcy, tcz, 1e-20)
    cos_w = _dot3(ncx, ncy, ncz, wx, wy, wz)
    in_cone = cos_w >= cos_tmax - 1e-6
    pdf_cone = 1.0 / (2.0 * PI * (1.0 - torch.clamp(cos_tmax, max=1.0 - 1e-7)))
    pdf_out = torch.where(outside & in_cone, pdf_cone, 0.0)
    ocx, ocy, ocz = -tcx, -tcy, -tcz
    b_half = _dot3(ocx, ocy, ocz, wx, wy, wz)
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    disc = torch.clamp(rad * rad - (oc2 - b_half * b_half), min=0.0)
    t_hit = -b_half + torch.sqrt(disc)
    nhx, nhy, nhz = _normalize3(
        ocx + wx * t_hit, ocy + wy * t_hit, ocz + wz * t_hit, 1e-20
    )
    cos_hit = torch.abs(_dot3(nhx, nhy, nhz, wx, wy, wz))
    pdf_in = (t_hit * t_hit) / torch.clamp(cos_hit * 4.0 * PI * rad * rad, min=1e-12)
    return torch.where(outside, pdf_out, pdf_in)


def _max3(a, b, c):
    return torch.maximum(a, torch.maximum(b, c))


def _ggx_reflection(nx, ny, nz, wox, woy, woz, cos_o, alpha, eta, wix, wiy, wiz, ci):
    """(refl, mf_pdf, g) of the GGX reflection lobe toward wi, ci = wi . n
    (csrc/bounce.cuh ggx_reflection; pallas_mesh_megakernel.py:891-924)."""
    aco = torch.abs(cos_o)
    same = cos_o * ci > 0.0
    aci = torch.abs(ci)
    hx, hy, hz = wix + wox, wiy + woy, wiz + woz
    h2 = hx * hx + hy * hy + hz * hz
    hx, hy, hz = _normalize3(hx, hy, hz, 1e-20)
    c_wh = _dot3(hx, hy, hz, nx, ny, nz)
    sgn_h = torch.where(c_wh < 0.0, -1.0, 1.0)
    fr = _fresnel_diel(_dot3(wix, wiy, wiz, sgn_h * hx, sgn_h * hy, sgn_h * hz), eta)
    d = _ggx_d(c_wh, alpha)
    g = 1.0 / (1.0 + _ggx_lambda(cos_o, alpha) + _ggx_lambda(ci, alpha))
    degen = (aco < 1e-7) | (aci < 1e-7) | (h2 < 1e-14)
    refl = torch.where(same & ~degen, fr * d * g / torch.clamp(4.0 * aco * aci, min=1e-7),
                       0.0)
    doh = _dot3(wox, woy, woz, hx, hy, hz)
    mf_pdf = torch.where(same, d * torch.abs(c_wh) / torch.clamp(4.0 * torch.abs(doh),
                                                                 min=1e-7), 0.0)
    return refl, mf_pdf, g


def _ggx_half_vector(alpha, ub0, ub1, cos_o, ss, ts, n):
    """A GGX half-vector about n, into wo's hemisphere (csrc/bounce.cuh
    ggx_half_vector)."""
    tan2w = alpha * alpha * ub0 / torch.clamp(1.0 - ub0, min=1e-7)
    ctw = 1.0 / torch.sqrt(1.0 + tan2w)
    stw = torch.sqrt(torch.clamp(1.0 - ctw * ctw, min=0.0))
    phiw = 2.0 * PI * ub1
    cpw = stw * torch.cos(phiw)
    spw = stw * torch.sin(phiw)
    flip_h = torch.where(cos_o < 0.0, -1.0, 1.0)
    return tuple((ss[k] * cpw + ts[k] * spw + n[k] * ctw) * flip_h for k in range(3))


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _with_zero_row(t: torch.Tensor) -> torch.Tensor:
    """t with a zero row appended: index -1 (a miss) selects zeros, as the
    kernel's winner-takes-row select does."""
    return torch.cat([t, torch.zeros((1, t.shape[1]), dtype=t.dtype, device=t.device)])


class _BruteScene:
    """The intersector of csrc/megakernel.cu: brute sweeps over the
    scene's brute table, winners read from per-prim tables."""

    plastic = False

    def __init__(self, scene):
        prims = scene.prims
        self.table = scene_table(scene)
        self.shade = _with_zero_row(shade_table(scene))
        self.w2o = _with_zero_row(self.table.w2o)
        self.params = _with_zero_row(prims.params)
        self.ptype = _with_zero_row(prims.prim_type.to(torch.float32)[:, None])[:, 0]

    def closest(self, o, d, alive, counts):
        """(t, idx) of every lane, idx -1 on a miss; counts the tests of
        the alive lanes."""
        big = torch.full(alive.shape, BIG, dtype=torch.float32, device=alive.device)
        return closest_hit(self.table, *o, *d, big, tally=counts, active=alive)

    def occluded(self, o, d, t_max, active, counts):
        return first_hit(self.table, *o, *d, t_max, tally=counts, active=active) >= 0

    @staticmethod
    def triangle_normal(m, pr):
        """A triangle winner's unnormalised geometric normal: e1 x e2."""
        e1 = (pr[3] - pr[0], pr[4] - pr[1], pr[5] - pr[2])
        e2 = (pr[6] - pr[0], pr[7] - pr[1], pr[8] - pr[2])
        return _cross3(*e1, *e2)

    def winner(self, idx):
        """(ptype f32, w2o columns, params columns, shade columns, area-light
        id, scale2) of each lane's winner."""
        sel = idx.long()
        shade = self.shade[sel].unbind(-1)
        return (self.ptype[sel], self.w2o[sel].unbind(-1), self.params[sel].unbind(-1),
                shade, shade[SH_ALID].to(torch.int32), shade[SH_SCALE2])


class _BVHScene:
    """The intersector of csrc/mesh_megakernel.cu: the BVH walk over
    ``scene.bvh_tables``, winners read from the records and the material
    table."""

    plastic = True

    def __init__(self, scene):
        self.table = scene.bvh_tables
        self.rec = _with_zero_row(self.table.records)
        # the kernel's material rows: made at build where the scene carries
        # them (as the reference's mesh kernel), else from the scene
        mat = material_table(scene) if scene.mesh is None else scene.mesh.mat
        self.mat = _with_zero_row(mat)

    def closest(self, o, d, alive, counts):
        """(t, slot) of every lane, slot -1 on a miss; only alive lanes walk."""
        n = alive.shape[0]
        dev = alive.device
        t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
        slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
        lanes = torch.nonzero(alive).flatten()
        t[lanes], slot[lanes] = bvh_ops.walk(
            self.table, torch.stack(o, -1)[lanes], torch.stack(d, -1)[lanes], t[lanes],
            tally=counts, plane=True)
        return t, slot

    def occluded(self, o, d, t_max, active, counts):
        occ = torch.zeros_like(active)
        lanes = torch.nonzero(active).flatten()
        occ[lanes] = bvh_ops.walk(self.table, torch.stack(o, -1)[lanes],
                                  torch.stack(d, -1)[lanes], t_max[lanes], any_hit=True,
                                  tally=counts, plane=True)[1] >= 0
        return occ

    @staticmethod
    def triangle_normal(m, pr):
        """A triangle winner's unnormalised geometric normal: N of the
        record's planes, as the TPU kernel resolves _RC_N (no cross product)."""
        return m[0], m[1], m[2]

    def winner(self, idx):
        """As _BruteScene.winner; a triangle's w2o columns are its planes."""
        rec = self.rec[idx.long()]
        mat = torch.where(idx >= 0, rec[:, bvh_ops.REC_MAT].long(), -1)
        return (rec[:, bvh_ops.REC_TYPE], rec[:, bvh_ops.REC_W2O:bvh_ops.REC_W2O + 12].unbind(-1),
                rec[:, bvh_ops.REC_PARAMS:bvh_ops.REC_PARAMS + 9].unbind(-1),
                self.mat[mat].unbind(-1), rec[:, bvh_ops.REC_ALID].to(torch.int32),
                rec[:, bvh_ops.REC_SCALE2])


def path_li_plain(scene, o, d, pixel, sample, seed, cfg, cone=None,
                  counts=None, accel: str = "brute", bounces=None) -> torch.Tensor:
    """Radiance f32[N,3] of rays (o, d) — the bounce skeleton of
    csrc/bounce.cuh (``_mega_kernel``, ``_mesh_kernel``) over 1-D lane
    tensors, bounce by bounce, with ``torch.where`` for its selects.

    accel: the intersector, "brute" (the sweep over the scene's brute table, the
    twin of csrc/megakernel.cu) or "bvh" (the walk over
    ``scene.bvh_tables``, the twin of csrc/mesh_megakernel.cu).  counts:
    optional dict; gets, for each event of OPS_PER_EVENT, how often the CUDA
    kernel meets it on these inputs: a thread leaves the loop on a miss,
    runs only its own light's and lobe's branch, and stops its shadow ray
    at the first occluder (the BVH walk: at the end of that leaf).
    bounces: optional int64[N]; the bounces each lane runs are added to it.
    """
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    n_lights = scene.lights.count
    fi = scene.fastinfo
    any_glass = fi.has_glass or fi.has_rough_glass
    any_rough = fi.has_rough_glass
    use_cone = cone is not None
    cone_sp = float(torch.tensor(cone[1] if use_cone else 0.0, dtype=f32))
    func_int = float(scene.light_func_int)
    world_radius = float(scene.world_radius)

    if accel not in ("brute", "bvh"):
        raise ValueError(f"accel must be 'brute' or 'bvh', got {accel!r}")
    check_cfg(cfg)
    hits = _BVHScene(scene) if accel == "bvh" else _BruteScene(scene)
    any_tri = TRIANGLE in scene.prims.types
    any_plastic = hits.plastic and bool((scene.materials.mat_type == PLASTIC).any())
    ltype, lpos, lint, laux = light_tables(scene)
    ltype_f = ltype.to(f32)
    lcdf = scene.light_cdf.tolist()

    h_ps = rng.hash_combine(rng.hash_combine(rng.as_u32(seed, dev),
                                             rng.as_u32(pixel, dev)),
                            rng.as_u32(sample, dev))

    def count(event, mask):
        if counts is not None:
            counts[event] = counts.get(event, 0) + int(mask.sum())

    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ones = torch.ones((n,), dtype=f32, device=dev)
    zeros = torch.zeros((n,), dtype=f32, device=dev)
    bR, bG, bB = ones, ones, ones
    LR, LG, LB = zeros, zeros, zeros
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    spec = ones > 0.5
    prev_pdf = zeros
    cw = zeros + float(torch.tensor(cone[0] if use_cone else 0.0, dtype=f32))
    es = ones
    count("paths", alive)

    for b_abs in range(cfg.max_depth):
        if not bool(alive.any()):
            break
        if bounces is not None:
            bounces += alive.long()
        dim0 = DIM_BOUNCE_BASE + b_abs * DIMS_PER_BOUNCE

        def u1(off):
            return rng.u32_to_unit(rng.hash_combine(h_ps, dim0 + off))

        # ---- closest hit ------------------------------------------------
        t, idx = hits.closest((ox, oy, oz), (dx, dy, dz), alive, counts)
        hit = (idx >= 0) & alive
        if use_cone:
            count("cone_hits", hit)

        # ---- winner geometry --------------------------------------------
        ptype_f, m, pr, shade, alid, scale2 = hits.winner(idx)
        radius = pr[0]
        oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
        ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
        ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
        odx = m[0] * dx + m[1] * dy + m[2] * dz
        ody = m[4] * dx + m[5] * dy + m[6] * dz
        odz = m[8] * dx + m[9] * dy + m[10] * dz
        pox = oox + odx * t
        poy = ooy + ody * t
        poz = ooz + odz * t
        is_sph = ptype_f < 0.5
        plen = torch.sqrt(torch.clamp(pox * pox + poy * poy + poz * poz, min=1e-20))
        s_rep = torch.where(is_sph, radius / plen, 1.0)
        pox, poy, poz = pox * s_rep, poy * s_rep, poz * s_rep
        inv_r = 1.0 / torch.clamp(radius, min=1e-20)
        nx_o = torch.where(is_sph, pox * inv_r, 0.0)
        ny_o = torch.where(is_sph, poy * inv_r, 0.0)
        nz_o = torch.where(is_sph, poz * inv_r, 1.0)
        dux_o, duy_o, duz_o = -poy, pox, torch.zeros_like(pox)

        def w2oT(vx, vy, vz):
            return (
                m[0] * vx + m[4] * vy + m[8] * vz,
                m[1] * vx + m[5] * vy + m[9] * vz,
                m[2] * vx + m[6] * vy + m[10] * vz,
            )

        nx, ny, nz = _normalize3(*w2oT(nx_o, ny_o, nz_o), 1e-30)
        dux, duy, duz = w2oT(dux_o, duy_o, duz_o)
        plx, ply, plz = w2oT(pox - m[3], poy - m[7], poz - m[11])
        px, py, pz = scale2 * plx, scale2 * ply, scale2 * plz
        is_tri = ptype_f > 1.5
        if any_tri:
            # world-space triangle: p = o + t d, n ~ N, dpdu = e1
            e1 = (pr[3] - pr[0], pr[4] - pr[1], pr[5] - pr[2])
            ntx, nty, ntz = _normalize3(*hits.triangle_normal(m, pr), 1e-30)
            px = torch.where(is_tri, ox + dx * t, px)
            py = torch.where(is_tri, oy + dy * t, py)
            pz = torch.where(is_tri, oz + dz * t, pz)
            nx, ny, nz = (torch.where(is_tri, a, b) for a, b in zip((ntx, nty, ntz),
                                                                     (nx, ny, nz)))
            dux, duy, duz = (torch.where(is_tri, a, b) for a, b in zip(e1, (dux, duy, duz)))
        count("hits", hit & ~is_tri)
        count("triangle_hits", hit & is_tri)
        wox, woy, woz = _normalize3(-dx, -dy, -dz, 1e-30)

        # ---- emitted radiance at emitter hits (path.go:48-63 + MIS) -----
        is_emit = hit & (alid >= 0)
        if n_lights > 0:
            el = torch.clamp(alid, min=0).long()
            eint = lint[el].unbind(-1)
            eaux = laux[el].unbind(-1)
            facing = _dot3(nx, ny, nz, wox, woy, woz) > 0.0
            emit_on = (eaux[LA_TWO] > 0.5) | facing
            l_pdf = _sphere_area_pdf_li(
                ox, oy, oz, dx, dy, dz,
                eaux[LA_CX], eaux[LA_CX + 1], eaux[LA_CX + 2], eaux[LA_RAD],
            )
            pick_pmf = (
                eaux[5] / max(func_int * n_lights, 1e-20)
                if func_int > 0.0 else torch.full_like(l_pdf, 1.0 / n_lights)
            )
            w_bsdf = torch.where(spec, 1.0, _power_heuristic(prev_pdf, l_pdf * pick_pmf))
            gain = torch.where(is_emit & emit_on, w_bsdf, 0.0)
            count("emitter_hits", is_emit)
            count("emissions", is_emit & emit_on)
            count("emission_mis", is_emit & emit_on & ~spec)
            LR = LR + bR * eint[0] * gain
            LG = LG + bG * eint[1] * gain
            LB = LB + bB * eint[2] * gain

        alive = alive & hit

        # ---- kd at hit (constant or planar checker; box-filtered over the
        # ray-cone footprint) ---------------------------------------------
        kdr, kdg, kdb = shade[SH_C1], shade[SH_C1 + 1], shade[SH_C1 + 2]
        count("checker_hits", alive & (shade[SH_CHK] > 0.5))
        count("checker_filtered" if use_cone else "checker_unfiltered",
              alive & (shade[SH_CHK] > 0.5))
        if use_cone:
            fw_hit = cw + cone_sp * torch.abs(t)
            fw_surf = fw_hit * torch.rsqrt(
                torch.clamp(torch.abs(_dot3(nx, ny, nz, wox, woy, woz)), min=0.05)
            )
        s_t = shade[SH_DS] + _dot3(px, py, pz, shade[SH_VS], shade[SH_VS + 1],
                                   shade[SH_VS + 2])
        t_t = shade[SH_DS + 1] + _dot3(px, py, pz, shade[SH_VT], shade[SH_VT + 1],
                                       shade[SH_VT + 2])
        if use_cone:
            def bump_int(x):
                h = x * 0.5
                fh = torch.floor(h)
                return fh + 2.0 * torch.clamp(h - fh - 0.5, min=0.0)

            ds_ = torch.clamp(fw_surf * shade[SH_TSS], min=1e-8)
            dt_ = torch.clamp(fw_surf * shade[SH_TST], min=1e-8)
            s_int = (bump_int(s_t + ds_) - bump_int(s_t - ds_)) / (2.0 * ds_)
            t_int = (bump_int(t_t + dt_) - bump_int(t_t - dt_)) / (2.0 * dt_)
            a2 = torch.clamp(s_int + t_int - 2.0 * s_int * t_int, 0.0, 1.0)
            chk = shade[SH_CHK] > 0.5
            kdr = torch.where(chk, kdr + a2 * (shade[SH_C2] - kdr), kdr)
            kdg = torch.where(chk, kdg + a2 * (shade[SH_C2 + 1] - kdg), kdg)
            kdb = torch.where(chk, kdb + a2 * (shade[SH_C2 + 2] - kdb), kdb)
        else:
            par = torch.floor(s_t) + torch.floor(t_t)
            par = par - 2.0 * torch.floor(par * 0.5)
            odd = (par > 0.5) & (shade[SH_CHK] > 0.5)
            kdr = torch.where(odd, shade[SH_C2], kdr)
            kdg = torch.where(odd, shade[SH_C2 + 1], kdg)
            kdb = torch.where(odd, shade[SH_C2 + 2], kdb)

        # ---- shading frame (reflection.go:120-145) ----------------------
        nd = _dot3(nx, ny, nz, dux, duy, duz)
        ssx, ssy, ssz = dux - nx * nd, duy - ny * nd, duz - nz * nd
        bad = ssx * ssx + ssy * ssy + ssz * ssz < 1e-12
        (fbx, fby, fbz), _ = _coord_system(nx, ny, nz)
        ssx = torch.where(bad, fbx, ssx)
        ssy = torch.where(bad, fby, ssy)
        ssz = torch.where(bad, fbz, ssz)
        ssx, ssy, ssz = _normalize3(ssx, ssy, ssz, 1e-30)
        tsx, tsy, tsz = _cross3(nx, ny, nz, ssx, ssy, ssz)
        cos_o = _dot3(wox, woy, woz, nx, ny, nz)
        d_off = _offset_dist(nx, ny, nz, px, py, pz)
        is_mir = shade[SH_MIR] > 0.5
        is_gls = (shade[SH_GLS] > 0.5) if any_glass else torch.zeros_like(is_mir)
        is_rgl = (shade[SH_RGL] > 0.5) if any_rough else torch.zeros_like(is_mir)
        is_pla = (shade[SH_PLA] > 0.5) if any_plastic else torch.zeros_like(is_mir)
        count("rough_hits", alive & is_rgl)
        alpha_g = torch.clamp(shade[SH_ALPHA], min=1e-3)
        eta_rg = torch.clamp(shade[SH_ETA], min=1e-3)

        if any_rough:
            aco_r = torch.abs(cos_o)
            F_o_rgl = _fresnel_diel(cos_o, eta_rg)

            def rough_glass_eval(wix_e, wiy_e, wiz_e):
                """(refl, trans, pdf) of the GGX R+T lobes toward wi
                (pallas_megakernel.py:522-599)."""
                ci_e = _dot3(wix_e, wiy_e, wiz_e, nx, ny, nz)
                same_e = cos_o * ci_e > 0.0
                aci_e = torch.abs(ci_e)
                refl, mf_pdf_r, g_e = _ggx_reflection(nx, ny, nz, wox, woy, woz, cos_o,
                                                      alpha_g, eta_rg, wix_e, wiy_e, wiz_e,
                                                      ci_e)
                eta_t = torch.where(cos_o > 0.0, eta_rg, 1.0 / eta_rg)
                thx = wox + wix_e * eta_t
                thy = woy + wiy_e * eta_t
                thz = woz + wiz_e * eta_t
                thx, thy, thz = _normalize3(thx, thy, thz, 1e-20)
                c_th = _dot3(thx, thy, thz, nx, ny, nz)
                sgn_t = torch.where(c_th < 0.0, -1.0, 1.0)
                thx, thy, thz = sgn_t * thx, sgn_t * thy, sgn_t * thz
                c_th = sgn_t * c_th
                do_h = _dot3(wox, woy, woz, thx, thy, thz)
                di_h = _dot3(wix_e, wiy_e, wiz_e, thx, thy, thz)
                denom = do_h + eta_t * di_h
                fr_t = _fresnel_diel(do_h, eta_rg)
                d_t = _ggx_d(c_th, alpha_g)
                degen_t = same_e | (aci_e < 1e-7) | (aco_r < 1e-7)
                trans = torch.where(
                    degen_t,
                    0.0,
                    (1.0 - fr_t) * torch.abs(
                        d_t * g_e * torch.abs(di_h) * torch.abs(do_h)
                        / torch.clamp(torch.abs(ci_e * cos_o) * denom * denom, min=1e-10)
                    ),
                )
                dwh_dwi = torch.abs(eta_t * eta_t * di_h) / torch.clamp(
                    denom * denom, min=1e-10)
                mf_pdf_t = d_t * torch.abs(c_th) * dwh_dwi
                pdf_e = torch.where(same_e, F_o_rgl * mf_pdf_r,
                                    (1.0 - F_o_rgl) * mf_pdf_t)
                return refl, trans, pdf_e

        # ---- NEE: one-light estimate (integrator.go:48-77, 79-195) ------
        if n_lights > 0:
            nee = alive & ~is_mir & ~is_gls
            count("nee", nee)
            if counts is not None:
                counts["cdf_steps"] = counts.get("cdf_steps", 0) + int(nee.sum()) * len(lcdf)
            u_pick = u1(D_LIGHT_PICK)
            cnt = torch.zeros((n,), dtype=torch.int64, device=dev)
            for c in lcdf:
                cnt = cnt + (c <= u_pick).to(torch.int64)
            lidx = torch.clamp(cnt - 1, 0, n_lights - 1)
            lt = ltype_f[lidx]
            lp = lpos[lidx].unbind(-1)
            lin = lint[lidx].unbind(-1)
            la = laux[lidx].unbind(-1)
            pick_pmf = (
                la[5] / (max(func_int, 1e-30) * n_lights)
                if func_int > 0.0 else torch.full_like(u_pick, 1.0 / n_lights)
            )
            ul0 = u1(D_LIGHT_UV)
            ul1 = u1(D_LIGHT_UV + 1)

            # point light: Li = I/d^2 (point.go:44-49)
            tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
            d2 = tlx * tlx + tly * tly + tlz * tlz
            dist_pt = torch.sqrt(d2)
            wix_pt, wiy_pt, wiz_pt = _normalize3(tlx, tly, tlz, 1e-20)
            inv_d2 = 1.0 / torch.clamp(d2, min=1e-12)

            # area sphere: cone/inside sampling (sphere.go:287-344)
            cx, cy, cz, rad = la[1], la[2], la[3], la[4]
            tcx, tcy, tcz = cx - px, cy - py, cz - pz
            dc2 = tcx * tcx + tcy * tcy + tcz * tcz
            dc = torch.sqrt(dc2)
            outside = dc > rad * 1.00001
            inv_dc = 1.0 / torch.clamp(dc, min=1e-12)
            wcx, wcy, wcz = tcx * inv_dc, tcy * inv_dc, tcz * inv_dc
            (v2x, v2y, v2z), (v3x, v3y, v3z) = _coord_system(wcx, wcy, wcz)
            sin2_tmax = torch.clamp(rad * rad / torch.clamp(dc2, min=1e-20), 0.0, 1.0)
            cos_tmax = torch.sqrt(torch.clamp(1.0 - sin2_tmax, min=0.0))
            cos_t = (1.0 - ul0) + ul0 * cos_tmax
            sin2_t = torch.clamp(1.0 - cos_t * cos_t, min=0.0)
            ds_ = dc * cos_t - torch.sqrt(torch.clamp(rad * rad - dc2 * sin2_t, min=0.0))
            cos_a = (dc2 + rad * rad - ds_ * ds_) / torch.clamp(2.0 * dc * rad, min=1e-12)
            sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
            phi = 2.0 * PI * ul1
            sa_cp = sin_a * torch.cos(phi)
            sa_sp = sin_a * torch.sin(phi)
            nox = -v2x * sa_cp - v3x * sa_sp - wcx * cos_a
            noy = -v2y * sa_cp - v3y * sa_sp - wcy * cos_a
            noz = -v2z * sa_cp - v3z * sa_sp - wcz * cos_a
            plx_o, ply_o, plz_o = cx + rad * nox, cy + rad * noy, cz + rad * noz
            wix_o, wiy_o, wiz_o = _normalize3(plx_o - px, ply_o - py, plz_o - pz, 1e-20)
            pdf_out = 1.0 / (2.0 * PI * (1.0 - torch.clamp(cos_tmax, max=1.0 - 1e-7)))
            # inside: uniform area + conversion
            z_in = 1.0 - 2.0 * ul0
            r_in = torch.sqrt(torch.clamp(1.0 - z_in * z_in, min=0.0))
            nix, niy, niz = r_in * torch.cos(phi), r_in * torch.sin(phi), z_in
            plx_i, ply_i, plz_i = cx + rad * nix, cy + rad * niy, cz + rad * niz
            wvx, wvy, wvz = plx_i - px, ply_i - py, plz_i - pz
            d2i = wvx * wvx + wvy * wvy + wvz * wvz
            wix_i, wiy_i, wiz_i = _normalize3(wvx, wvy, wvz, 1e-20)
            cos_li = torch.abs(_dot3(nix, niy, niz, -wix_i, -wiy_i, -wiz_i))
            pdf_in = d2i / torch.clamp(cos_li * 4.0 * PI * rad * rad, min=1e-12)
            wix_ar = torch.where(outside, wix_o, wix_i)
            wiy_ar = torch.where(outside, wiy_o, wiy_i)
            wiz_ar = torch.where(outside, wiz_o, wiz_i)
            nlx = torch.where(outside, nox, nix)
            nly = torch.where(outside, noy, niy)
            nlz = torch.where(outside, noz, niz)
            plx_a = torch.where(outside, plx_o, plx_i)
            ply_a = torch.where(outside, ply_o, ply_i)
            plz_a = torch.where(outside, plz_o, plz_i)
            pdf_ar = torch.where(outside, pdf_out, pdf_in)
            dist_ar = torch.sqrt((plx_a - px) ** 2 + (ply_a - py) ** 2 + (plz_a - pz) ** 2)
            facing_l = _dot3(nlx, nly, nlz, -wix_ar, -wiy_ar, -wiz_ar) > 0.0
            area_on = ((la[LA_TWO] > 0.5) | facing_l) & (pdf_ar > 0.0)

            is_pt = lt < 0.5
            is_di = (lt > 0.5) & (lt < 1.5)
            is_delta = is_pt | is_di
            count("nee_point", nee & is_pt)
            count("nee_distant", nee & is_di)
            count("nee_area_outside", nee & ~is_delta & outside)
            count("nee_area_inside", nee & ~is_delta & ~outside)
            count("nee_rough", nee & is_rgl)
            count("nee_lambert", nee & ~is_rgl)
            wix = torch.where(is_pt, wix_pt, torch.where(is_di, lp[0], wix_ar))
            wiy = torch.where(is_pt, wiy_pt, torch.where(is_di, lp[1], wiy_ar))
            wiz = torch.where(is_pt, wiz_pt, torch.where(is_di, lp[2], wiz_ar))
            li_gain = torch.where(is_pt, inv_d2, torch.where(is_di | area_on, 1.0, 0.0))
            lir, lig, lib = lin[0] * li_gain, lin[1] * li_gain, lin[2] * li_gain
            ls_pdf = torch.where(is_delta, 1.0, pdf_ar)
            dist = torch.where(is_pt, dist_pt,
                               torch.where(is_di, 2.0 * world_radius, dist_ar))

            cos_i = _dot3(wix, wiy, wiz, nx, ny, nz)
            same = cos_o * cos_i > 0.0
            f_gain = torch.where(same, INV_PI * torch.abs(cos_i), 0.0)
            b_pdf = torch.where(same, torch.abs(cos_i) * INV_PI, 0.0)
            fR_n, fG_n, fB_n = kdr * f_gain, kdg * f_gain, kdb * f_gain
            if any_rough:
                r_e, t_e, p_e = rough_glass_eval(wix, wiy, wiz)
                aci_n = torch.abs(cos_i)
                fR_n = torch.where(is_rgl, (shade[SH_KR] * r_e + shade[SH_KT] * t_e) * aci_n, fR_n)
                fG_n = torch.where(is_rgl, (shade[SH_KR + 1] * r_e + shade[SH_KT + 1] * t_e) * aci_n, fG_n)
                fB_n = torch.where(is_rgl, (shade[SH_KR + 2] * r_e + shade[SH_KT + 2] * t_e) * aci_n, fB_n)
                b_pdf = torch.where(is_rgl, p_e, b_pdf)
            if any_plastic:  # + the GGX reflection lobe, the pdfs averaged
                spec_s, mf_pdf, _ = _ggx_reflection(nx, ny, nz, wox, woy, woz, cos_o, alpha_g,
                                                    eta_rg, wix, wiy, wiz, cos_i)
                cos_gain = torch.where(same, torch.abs(cos_i), 0.0)
                fR_n = torch.where(is_pla, fR_n + shade[SH_KR] * spec_s * cos_gain, fR_n)
                fG_n = torch.where(is_pla, fG_n + shade[SH_KR + 1] * spec_s * cos_gain, fG_n)
                fB_n = torch.where(is_pla, fB_n + shade[SH_KR + 2] * spec_s * cos_gain, fB_n)
                b_pdf = torch.where(is_pla, 0.5 * (b_pdf + mf_pdf), b_pdf)
                count("nee_plastic", nee & is_pla)
            f_max = _max3(fR_n, fG_n, fB_n)
            li_max = _max3(lir, lig, lib)
            contributes = nee & (ls_pdf > 0.0) & (li_max > 0.0) & (f_max > 0.0)

            # shadow ray (VisibilityTester.Unoccluded, light.go:46-48)
            sgn = torch.where(_dot3(wix, wiy, wiz, nx, ny, nz) < 0.0, -1.0, 1.0)
            shx = px + sgn * d_off * nx
            shy = py + sgn * d_off * ny
            shz = pz + sgn * d_off * nz
            t_sh = torch.clamp(dist * (1.0 - SHADOW_EPSILON) - 1e-3, min=1e-4)
            t_sh = torch.where(contributes, t_sh, 1e-6)
            count("shadow_rays", contributes)
            occ = hits.occluded((shx, shy, shz), (wix, wiy, wiz), t_sh, contributes, counts)
            vis = contributes & ~occ
            count("unoccluded", vis)
            count("unoccluded_area", vis & ~is_delta)

            weight = torch.where(is_delta, 1.0, _power_heuristic(ls_pdf, b_pdf))
            gain = weight / torch.clamp(ls_pdf, min=1e-20) / torch.clamp(pick_pmf, min=1e-20)
            gain = torch.where(vis, gain, 0.0)
            LR = LR + bR * fR_n * lir * gain
            LG = LG + bG * fG_n * lig * gain
            LB = LB + bB * fB_n * lib * gain

        # ---- BSDF sample: cosine hemisphere (path.go:91-101) ------------
        ub0 = u1(D_BSDF_UV)
        ub1 = u1(D_BSDF_UV + 1)
        dxl, dyl = _concentric_disk(ub0, ub1)
        zl = torch.sqrt(torch.clamp(1.0 - dxl * dxl - dyl * dyl, min=0.0))
        zl = torch.where(cos_o < 0.0, -zl, zl)
        wix_n = ssx * dxl + tsx * dyl + nx * zl
        wiy_n = ssy * dxl + tsy * dyl + ny * zl
        wiz_n = ssz * dxl + tsz * dyl + nz * zl
        pdf_b = torch.abs(zl) * INV_PI
        cos_n = torch.abs(_dot3(wix_n, wiy_n, wiz_n, nx, ny, nz))
        kd_max = _max3(kdr, kdg, kdb)
        ok = (pdf_b > 1e-9) & (kd_max * INV_PI > 0.0) & (cos_o * zl > 0.0)
        thr = torch.where(ok, (INV_PI * cos_n) / torch.clamp(pdf_b, min=1e-20), 0.0)
        # the throughput of the lanes that are neither mirror nor glass
        fdR, fdG, fdB = kdr * thr, kdg * thr, kdb * thr
        choose_diff = torch.ones_like(is_pla)
        if any_plastic:
            # plastic: the cosine sample or reflection about a GGX
            # half-vector, half and half, then both lobes' f and the
            # averaged pdf toward the sample (pallas_mesh_megakernel.py
            # :1104-1138)
            choose_diff = u1(D_BSDF_LOBE) < 0.5
            whx, why, whz = _ggx_half_vector(alpha_g, ub0, ub1, cos_o, (ssx, ssy, ssz),
                                             (tsx, tsy, tsz), (nx, ny, nz))
            doh_p = _dot3(wox, woy, woz, whx, why, whz)
            wgx, wgy, wgz = _normalize3(2.0 * doh_p * whx - wox, 2.0 * doh_p * why - woy,
                                        2.0 * doh_p * whz - woz, 1e-20)
            wpx = torch.where(choose_diff, wix_n, wgx)
            wpy = torch.where(choose_diff, wiy_n, wgy)
            wpz = torch.where(choose_diff, wiz_n, wgz)
            cos_ip = _dot3(wpx, wpy, wpz, nx, ny, nz)
            same_p = cos_o * cos_ip > 0.0
            spec_p, mf_pdf_p, _ = _ggx_reflection(nx, ny, nz, wox, woy, woz, cos_o, alpha_g,
                                                  eta_rg, wpx, wpy, wpz, cos_ip)
            acip = torch.abs(cos_ip)
            pdf_p = 0.5 * (torch.where(same_p, acip * INV_PI, 0.0) + mf_pdf_p)
            diff_p = torch.where(same_p, INV_PI, 0.0)
            fRp = kdr * diff_p + shade[SH_KR] * spec_p
            fGp = kdg * diff_p + shade[SH_KR + 1] * spec_p
            fBp = kdb * diff_p + shade[SH_KR + 2] * spec_p
            ok_p = (pdf_p > 1e-9) & (_max3(fRp, fGp, fBp) > 0.0)
            thr_p = torch.where(ok_p, acip / torch.clamp(pdf_p, min=1e-20), 0.0)
            wix_n = torch.where(is_pla, wpx, wix_n)
            wiy_n = torch.where(is_pla, wpy, wiy_n)
            wiz_n = torch.where(is_pla, wpz, wiz_n)
            pdf_b = torch.where(is_pla, pdf_p, pdf_b)
            ok = torch.where(is_pla, ok_p, ok)
            fdR = torch.where(is_pla, fRp * thr_p, fdR)
            fdG = torch.where(is_pla, fGp * thr_p, fdG)
            fdB = torch.where(is_pla, fBp * thr_p, fdB)
            count("plastic_ggx", alive & is_pla & ~choose_diff)
            count("plastic_samples", alive & is_pla)
        # mirror: delta reflection (mirror.go:21-32)
        count("mirror_samples", alive & is_mir)
        count("lambert_samples", alive & ~is_mir & ~is_gls & ~is_rgl & (~is_pla | choose_diff))
        wix_m = 2.0 * cos_o * nx - wox
        wiy_m = 2.0 * cos_o * ny - woy
        wiz_m = 2.0 * cos_o * nz - woz
        kr_max = _max3(shade[SH_KR], shade[SH_KR + 1], shade[SH_KR + 2])

        if any_glass:
            # smooth glass: FresnelSpecular (reflection.go:465-536)
            eta_g = torch.clamp(shade[SH_ETA], min=1e-3)
            entering = cos_o > 0.0
            ci = torch.abs(torch.clamp(cos_o, -1.0, 1.0))
            ei = torch.where(entering, 1.0, eta_g)
            et = torch.where(entering, eta_g, 1.0)
            sin_i = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
            sin_t = ei / et * sin_i
            tir = sin_t >= 1.0
            ct_f = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
            r_parl = (et * ci - ei * ct_f) / torch.clamp(et * ci + ei * ct_f, min=1e-20)
            r_perp = (ei * ci - et * ct_f) / torch.clamp(ei * ci + et * ct_f, min=1e-20)
            F = torch.where(tir, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))
            u_lobe = u1(D_BSDF_LOBE)
            choose_r = u_lobe < F
            eta_ratio = torch.where(entering, 1.0 / eta_g, eta_g)
            sgn_e = torch.where(entering, 1.0, -1.0)
            sin2_tt = eta_ratio * eta_ratio * (1.0 - ci * ci)
            ok_t = sin2_tt < 1.0
            cos_tt = torch.sqrt(torch.clamp(1.0 - sin2_tt, min=0.0))
            coef = (eta_ratio * ci - cos_tt) * sgn_e
            wtx, wty, wtz = _normalize3(
                coef * nx - eta_ratio * wox,
                coef * ny - eta_ratio * woy,
                coef * nz - eta_ratio * woz,
                1e-20,
            )
            ktr, ktg, ktb = shade[SH_KT], shade[SH_KT + 1], shade[SH_KT + 2]
            kt_max = _max3(ktr, ktg, ktb)
            er2 = eta_ratio * eta_ratio
            ok_g = (choose_r & (F > 1e-9) & (kr_max > 0.0)) | (
                ~choose_r & ((1.0 - F) > 1e-9) & ok_t & (kt_max > 0.0)
            )
            wix_g = torch.where(choose_r, wix_m, wtx)
            wiy_g = torch.where(choose_r, wiy_m, wty)
            wiz_g = torch.where(choose_r, wiz_m, wtz)
            pdf_g = torch.where(choose_r, F, 1.0 - F)
            fR_g = torch.where(choose_r, shade[SH_KR], er2 * ktr)
            fG_g = torch.where(choose_r, shade[SH_KR + 1], er2 * ktg)
            fB_g = torch.where(choose_r, shade[SH_KR + 2], er2 * ktb)
            count("glass_reflect", alive & is_gls & choose_r)
            count("glass_refract", alive & is_gls & ~choose_r)

            if any_rough:
                # rough glass: GGX NDF half-vector, Fresnel R/T choice
                whx_s, why_s, whz_s = _ggx_half_vector(alpha_g, ub0, ub1, cos_o,
                                                       (ssx, ssy, ssz), (tsx, tsy, tsz),
                                                       (nx, ny, nz))
                doh_s = _dot3(wox, woy, woz, whx_s, why_s, whz_s)
                fr_wh = _fresnel_diel(doh_s, eta_rg)
                choose_rg = u_lobe < fr_wh
                count("rough_reflect", alive & is_rgl & choose_rg)
                count("rough_refract", alive & is_rgl & ~choose_rg)
                wix_rr, wiy_rr, wiz_rr = _normalize3(
                    2.0 * doh_s * whx_s - wox,
                    2.0 * doh_s * why_s - woy,
                    2.0 * doh_s * whz_s - woz,
                    1e-20,
                )
                sgn_o = torch.where(doh_s < 0.0, -1.0, 1.0)
                ci_h = torch.abs(doh_s)
                sin2_h = er2 * (1.0 - ci_h * ci_h)
                ok_mt = sin2_h < 1.0
                cth_h = torch.sqrt(torch.clamp(1.0 - sin2_h, min=0.0))
                coef_h = eta_ratio * ci_h - cth_h
                wix_tt, wiy_tt, wiz_tt = _normalize3(
                    coef_h * sgn_o * whx_s - eta_ratio * wox,
                    coef_h * sgn_o * why_s - eta_ratio * woy,
                    coef_h * sgn_o * whz_s - eta_ratio * woz,
                    1e-20,
                )
                wix_rg = torch.where(choose_rg, wix_rr, wix_tt)
                wiy_rg = torch.where(choose_rg, wiy_rr, wiy_tt)
                wiz_rg = torch.where(choose_rg, wiz_rr, wiz_tt)
                r_s, t_s, pdf_rg = rough_glass_eval(wix_rg, wiy_rg, wiz_rg)
                aci_s = torch.abs(_dot3(wix_rg, wiy_rg, wiz_rg, nx, ny, nz))
                thr_rg = torch.where(pdf_rg > 1e-9, aci_s / torch.clamp(pdf_rg, min=1e-20), 0.0)
                fR_rg = (shade[SH_KR] * r_s + ktr * t_s) * thr_rg
                fG_rg = (shade[SH_KR + 1] * r_s + ktg * t_s) * thr_rg
                fB_rg = (shade[SH_KR + 2] * r_s + ktb * t_s) * thr_rg
                ok_rg = (pdf_rg > 1e-9) & (_max3(fR_rg, fG_rg, fB_rg) > 0.0)

            not_spec = ~is_mir & ~is_gls
            if any_rough:
                not_spec = not_spec & ~is_rgl
                ok = ((is_mir & (kr_max > 0.0)) | (is_gls & ok_g)
                      | (is_rgl & ok_rg) | (not_spec & ok))

                def sel3(a_m, a_g, a_r, a_d):
                    inner = torch.where(is_gls, a_g, torch.where(is_rgl, a_r, a_d))
                    return torch.where(is_mir, a_m, inner)

                wix_n = sel3(wix_m, wix_g, wix_rg, wix_n)
                wiy_n = sel3(wiy_m, wiy_g, wiy_rg, wiy_n)
                wiz_n = sel3(wiz_m, wiz_g, wiz_rg, wiz_n)
                pdf_b = sel3(torch.ones_like(pdf_b), pdf_g, pdf_rg, pdf_b)
                fR = sel3(shade[SH_KR], fR_g, fR_rg, fdR)
                fG = sel3(shade[SH_KR + 1], fG_g, fG_rg, fdG)
                fB = sel3(shade[SH_KR + 2], fB_g, fB_rg, fdB)
                es_new = torch.where(
                    (is_gls & ~choose_r & ok_t) | (is_rgl & ~choose_rg & ok_mt),
                    es / torch.clamp(er2, min=1e-20), es,
                )
            else:
                ok = (is_mir & (kr_max > 0.0)) | (is_gls & ok_g) | (not_spec & ok)
                wix_n = torch.where(is_mir, wix_m, torch.where(is_gls, wix_g, wix_n))
                wiy_n = torch.where(is_mir, wiy_m, torch.where(is_gls, wiy_g, wiy_n))
                wiz_n = torch.where(is_mir, wiz_m, torch.where(is_gls, wiz_g, wiz_n))
                pdf_b = torch.where(is_mir, 1.0, torch.where(is_gls, pdf_g, pdf_b))
                fR = torch.where(is_mir, shade[SH_KR], torch.where(is_gls, fR_g, fdR))
                fG = torch.where(is_mir, shade[SH_KR + 1], torch.where(is_gls, fG_g, fdG))
                fB = torch.where(is_mir, shade[SH_KR + 2], torch.where(is_gls, fB_g, fdB))
                es_new = torch.where(is_gls & ~choose_r & ok_t,
                                     es / torch.clamp(er2, min=1e-20), es)
            spec_next = is_mir | is_gls  # rough glass and plastic are not delta lobes
        else:
            ok = (is_mir & (kr_max > 0.0)) | (~is_mir & ok)
            wix_n = torch.where(is_mir, wix_m, wix_n)
            wiy_n = torch.where(is_mir, wiy_m, wiy_n)
            wiz_n = torch.where(is_mir, wiz_m, wiz_n)
            pdf_b = torch.where(is_mir, 1.0, pdf_b)
            fR = torch.where(is_mir, shade[SH_KR], fdR)
            fG = torch.where(is_mir, shade[SH_KR + 1], fdG)
            fB = torch.where(is_mir, shade[SH_KR + 2], fdB)
            es_new = es
            spec_next = is_mir
        ok_f = torch.where(ok, 1.0, 0.0)
        bR, bG, bB = bR * fR * ok_f, bG * fG * ok_f, bB * fB * ok_f
        es = es_new
        count("bsdf_ok", alive & ok)
        alive = alive & ok & (_max3(bR, bG, bB) > 0.0)
        count("continues", alive)

        sgn_n = torch.where(_dot3(wix_n, wiy_n, wiz_n, nx, ny, nz) < 0.0, -1.0, 1.0)
        ox = px + sgn_n * d_off * nx
        oy = py + sgn_n * d_off * ny
        oz = pz + sgn_n * d_off * nz
        dx, dy, dz = wix_n, wiy_n, wiz_n

        # ---- Russian roulette (path.go:143-153) --------------------------
        rr_max = _max3(bR, bG, bB) * es
        q = torch.clamp(1.0 - rr_max, min=0.05)
        u_rr = u1(D_RR)
        do_rr = (rr_max < cfg.rr_threshold) & (b_abs >= cfg.rr_start_depth)
        killed = do_rr & (u_rr < q)
        count("roulette", alive & do_rr)
        surv = torch.where(do_rr & ~killed, 1.0 / (1.0 - q), 1.0)
        bR, bG, bB = bR * surv, bG * surv, bB * surv
        alive = alive & ~killed

        spec = spec_next
        prev_pdf = pdf_b
        if use_cone:
            cw = fw_hit

    L = torch.stack([LR, LG, LB], dim=-1)
    # NaN/Inf sanitization (renderWorker, integrator.go:256-262)
    bad = ~torch.all(torch.isfinite(L), dim=-1)
    return torch.where(bad[:, None], 0.0, torch.clamp(L, min=0.0))


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 counters (held in int64) as int32 with the same bits."""
    x = rng.as_u32(x)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bounce_entry(lib: str, symbol: str, key: str, own: tuple) -> _build.Entry:
    """A bounce kernel's C entry: o, d, pixel, sample, L, n, tables,
    table_words, its ``own`` arguments' types, n_lights, seed, func_int,
    world_radius, cone_w0, cone_sp, max_depth, rr_start, rr_threshold,
    flags; after the stream the path counter (csrc/lanes.cuh) and an int,
    nonzero for the counting instance, which fills the STATS after it."""
    return _build.Entry(lib, symbol, key,
                        (_P,) * 5 + (_I, _P, _I) + own + (_I, ctypes.c_uint) + (_F,) * 4
                        + (_I, _I, _F, _I), after=(_P, _I))


class Kernel(NamedTuple):
    """A bounce kernel as ``make_launch`` launches it and ``path_li_plain``
    stands in for it."""

    entry: _build.Entry
    tables_for: Callable  # scene -> the packed tables a launch reads
    fits: Callable  # scene -> whether the kernel takes it
    why: str  # the refusal of a scene it does not take
    accel: str  # path_li_plain's intersector: the kernel's plain twin
    own: Callable  # (scene, tables) -> the kernel's own arguments


# the brute instance, csrc/megakernel.cu: its own argument is n_prims
BRUTE = Kernel(bounce_entry("megakernel", "gopbrt_path_li", "megakernel", (_I,)), tables_for,
               fits, "the megakernel takes fast-path scenes of <= 64 prims and 1..16 lights",
               "brute", lambda scene, kt: (scene.prims.count,))


def check_inputs(kernel: Kernel, scene, o, d, pixel, sample, out=None):
    """Checks the rays (with ``out``, also what a launch asks of them,
    ``_build.check_rays``) and that ``kernel`` takes the scene; returns
    pixel and sample as uint32 counters broadcast to [N]."""
    _build.check_rays(o, d, device=scene.device, card=out is not None, out=out)
    if not kernel.fits(scene):
        raise ValueError(kernel.why)
    n = o.shape[0]
    pixel = torch.broadcast_to(rng.as_u32(pixel, o.device), (n,))
    sample = torch.broadcast_to(rng.as_u32(sample, o.device), (n,))
    return pixel, sample


def check_cfg(cfg) -> None:
    """The kernels (and ``path_li_plain``, their plain version) bake in NEE
    with MIS: a cfg with ``nee`` or ``mis`` off is refused, as the
    reference's gates send it to the wavefront chain
    (integrators.py:116-117, 137-138)."""
    if not (cfg.nee and cfg.mis):
        raise ValueError(f"the megakernels trace NEE with MIS; nee={cfg.nee}, mis={cfg.mis} "
                         "runs the wavefront chain (integrators.li)")


def make_launch(kernel: Kernel, scene, o, d, pixel, sample, seed, cfg, cone, out):
    """Everything a CUDA launch of ``kernel`` needs, prepared once: returns
    a callable that launches it on the current stream, writing radiance
    into ``out`` (f32[N,3], on the card).  After ``trace.enable()`` it
    launches the counting instance on a counter of its own and adds its
    STATS to the tracer's counters under the kernel's ``LAUNCHES`` key."""
    pixel, sample = check_inputs(kernel, scene, o, d, pixel, sample, out)
    check_cfg(cfg)
    kt = kernel.tables_for(scene)
    pix32, smp32 = as_i32_bits(pixel), as_i32_bits(sample)
    w0, sp = (0.0, 0.0) if cone is None else (float(cone[0]), float(cone[1]))
    args = (
        o.data_ptr(), d.data_ptr(), pix32.data_ptr(), smp32.data_ptr(), out.data_ptr(),
        o.shape[0], kt.tables.data_ptr(), kt.tables.numel(), *kernel.own(scene, kt),
        scene.lights.count, int(seed) & 0xFFFFFFFF, kt.func_int, kt.world_radius, w0, sp,
        cfg.max_depth, cfg.rr_start_depth, float(cfg.rr_threshold),
        kernel_flags(scene, cone is not None),
    )
    next_path = _build.counter(o.device)

    def launch(_keep=(o, d, kt, scene, pix32, smp32, out, next_path)):
        # _keep holds the tensors behind the pointers in ``args``
        counting = trace.enabled()
        ctr = _build.counter(o.device) if counting else next_path
        _build.launch(kernel.entry, o.device, args, ctr.data_ptr(), int(counting))
        if counting:
            for k, name in enumerate(_build.STATS, 1):
                trace.count(name, ctr[k], key=kernel.entry.key)
        return out

    return launch


# ---------------------------------------------------------------------------
# Gradients: the kernel forward, a path-replay backward
# ---------------------------------------------------------------------------


class _Replay(torch.autograd.Function):
    """The radiance of ``run()`` (a kernel launch, or a plain version under
    no_grad), with a backward that replays the lanes through
    ``replay(scene, o, d)``, the differentiable chain on the same counter
    streams, and takes ``torch.autograd.grad`` there.  The scene's float
    source tensors come in as arguments (``packed.float_sources``), so that
    a gradient reaches them; the backward puts fresh leaves in their places
    with ``_replace`` for those that need one."""

    @staticmethod
    def forward(ctx, run, replay, scene, paths, o, d, *sources):
        ctx.replay, ctx.scene, ctx.paths = replay, scene, paths
        ctx.save_for_backward(o, d, *sources)
        return run()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        need = ctx.needs_input_grad[4:]
        inputs = [x.detach().requires_grad_() if n else x
                  for x, n in zip(ctx.saved_tensors, need)]
        leaves = [x for x, n in zip(inputs, need) if n]
        with torch.enable_grad():
            scene = packed.replace_sources(
                ctx.scene, [p for p, n in zip(ctx.paths, need[2:]) if n],
                [x for x, n in zip(inputs[2:], need[2:]) if n])
            L = ctx.replay(scene, inputs[0], inputs[1])
            got = iter(torch.autograd.grad(L, leaves, grad, allow_unused=True))
        return (None, None, None, None, *(next(got) if n else None for n in need))


def replayed(run, replay, scene, o, d) -> torch.Tensor:
    """``run()``'s radiance f32[N,3], connected by ``_Replay`` to the rays
    and to the scene's float source tensors; ``replay(scene, o, d)`` is the
    differentiable chain on the same lanes (the integrator's
    ``_li_wavefront`` with the same counters, seed and cfg).  A second
    derivative through the replay raises (``once_differentiable``)."""
    paths, sources = zip(*packed.float_sources(scene))
    return _Replay.apply(run, replay, scene, paths, o, d, *sources)
