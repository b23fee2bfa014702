"""BSDF evaluation and sampling over the wavefront, in the local frame.

Counterpart of ``gopbrt_tpu/ops/bsdf.py``: the material tags,
``MaterialParams``, the local-frame trig, Fresnel (dielectric and
Schlick), the Trowbridge-Reitz (GGX) helpers, the lobes (Lambert,
Oren-Nayar, microfacet reflection and transmission) and the dispatchers
``bsdf_f``, ``bsdf_pdf`` and ``bsdf_sample`` over MATTE, MIRROR, GLASS
(smooth and rough), PLASTIC, METAL and the SUBSURFACE exit lobe (the
BSSRDF's directional term Sw, ``ops/bssrdf.sw``, cosine-sampled).
Directions are in the shading frame (z = shading normal).  As in the JAX
module, a scene's static ``MatInfo`` narrows the dispatch to the lobes it
has.  NULLMAT lanes never reach the lobes: the integrators pass through
null boundaries before the dispatch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gopbrt_tpu_torch.ops.geom import INV_PI, PI, dot, normalize
from gopbrt_tpu_torch.ops.sampling import cosine_sample_hemisphere
from gopbrt_tpu_torch.ops.static_info import MatInfo
from gopbrt_tpu_torch.utils import trace

MATTE = 0
MIRROR = 1
GLASS = 2
PLASTIC = 3
METAL = 4
SUBSURFACE = 5
NULLMAT = 6


class MaterialParams(NamedTuple):
    """Per-lane material parameters after texture evaluation (SoA [N,...])."""

    mat_type: torch.Tensor  # int32[N]
    kd: torch.Tensor  # f32[N,3]  diffuse albedo (matte / plastic)
    sigma: torch.Tensor  # f32[N]    Oren-Nayar sigma (degrees)
    kr: torch.Tensor  # f32[N,3]  reflection scale (mirror / glass / metal)
    kt: torch.Tensor  # f32[N,3]  transmission scale (glass)
    eta: torch.Tensor  # f32[N]    interior IOR
    roughness: torch.Tensor  # f32[N] GGX alpha (already remapped)
    info: Optional[MatInfo] = None
    # the SUBSURFACE exit lobe's normalization c-bar per lane; None where
    # the scene has no subsurface material
    sss_cbar: Optional[torch.Tensor] = None  # f32[N]


def _mtypes(mp: MaterialParams) -> tuple:
    if mp.info is None:
        return (MATTE, MIRROR, GLASS, PLASTIC, METAL, SUBSURFACE)
    return mp.info.mat_types


def _glass_split(mp: MaterialParams) -> tuple:
    """(may_be_rough, may_be_smooth) for GLASS lanes, statically."""
    if mp.info is None:
        return True, True
    return mp.info.any_rough_glass, mp.info.any_smooth_glass


def _only(mat_type: int, **kw) -> MatInfo:
    return MatInfo(mat_types=(mat_type,), any_rough_glass=kw.get("rough", False),
                   any_smooth_glass=False, any_oren_nayar=False)


# --- local-frame trig (reflection.go:44-100) -------------------------------


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return torch.sqrt(sin2_theta(w))


def tan2_theta(w):
    return sin2_theta(w) / torch.clamp(cos2_theta(w), min=1e-20)


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 1.0,
                       torch.clamp(w[..., 0] / torch.clamp(s, min=1e-20), -1, 1))


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 0.0,
                       torch.clamp(w[..., 1] / torch.clamp(s, min=1e-20), -1, 1))


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def reflect_local(wo):
    """Mirror reflection about z in the shading frame."""
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def refract(wi, n, eta_ratio):
    """Snell refraction -> (ok, wt) (reflection.go:106-118)."""
    c_i = dot(n, wi)
    sin2_i = torch.clamp(1.0 - c_i * c_i, min=0.0)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    ok = sin2_t < 1.0
    c_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = eta_ratio[..., None] * (-wi) + (eta_ratio * c_i - c_t)[..., None] * n
    return ok, wt


# --- Fresnel ---------------------------------------------------------------


def fr_dielectric(cos_i, eta_i, eta_t):
    """Unpolarised dielectric Fresnel reflectance (reflection.go:21-42);
    indices swap for rays leaving the medium."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-20)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-20)
    return torch.where(tir, 1.0, 0.5 * (r_parl * r_parl + r_perp * r_perp))


def schlick_fresnel(cos_i, f0):
    """Schlick approximation for conductors; f0: f32[...,3]."""
    m = torch.clamp(1.0 - torch.abs(cos_i), 0.0, 1.0)
    return f0 + (1.0 - f0) * (m ** 5)[..., None]


# --- Trowbridge-Reitz / GGX (microfacet.go) --------------------------------


def tr_d(wh, alpha):
    """GGX normal distribution D, isotropic (microfacet.go:47-55)."""
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    a2 = alpha * alpha
    e = t2 / torch.clamp(a2, min=1e-12)
    d = 1.0 / (PI * a2 * c4 * (1.0 + e) ** 2 + 1e-20)
    return torch.where(torch.isfinite(t2) & (c4 > 1e-16), d, 0.0)


def tr_lambda(w, alpha):
    """Smith Lambda for GGX (microfacet.go:56-64)."""
    abs_tan = torch.sqrt(tan2_theta(w))
    a2t2 = (alpha * abs_tan) ** 2
    return torch.where(torch.isfinite(abs_tan),
                       (-1.0 + torch.sqrt(1.0 + a2t2)) / 2.0, 0.0)


def tr_g(wo, wi, alpha):
    """G = 1 / (1 + Lambda(wo) + Lambda(wi)) (microfacet.go:66-71)."""
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_sample_wh(wo, u, alpha):
    """wh ~ D(wh)|cos| (tan^2 = alpha^2 u / (1 - u), phi = 2 pi v), flipped
    into wo's hemisphere."""
    u1 = u[..., 0]
    phi = 2.0 * PI * u[..., 1]
    tan2 = alpha * alpha * u1 / torch.clamp(1.0 - u1, min=1e-7)
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    wh = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    return torch.where((~same_hemisphere(wo, wh))[..., None], -wh, wh)


def tr_pdf(wo, wh, alpha):
    """pdf of tr_sample_wh in the wh measure: D(wh) |cos theta_h|."""
    return tr_d(wh, alpha) * torch.abs(wh[..., 2])


# ---------------------------------------------------------------------------
# Lobes (local frame), each -> rgb f
# ---------------------------------------------------------------------------


def lambert_f(kd, wo, wi):
    """f = R / pi (reflection.go:576-607)."""
    return kd * INV_PI


def oren_nayar_f(kd, sigma_deg, wo, wi):
    """Oren-Nayar (reflection.go:609-668); sigma in degrees."""
    sigma = sigma_deg * (PI / 180.0)
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin_ti = sin_theta(wi)
    sin_to = sin_theta(wo)
    max_cos = torch.clamp(cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo),
                          min=0.0)
    # the direction with the larger |cos| has the smaller theta
    ti_bigger = abs_cos_theta(wi) > abs_cos_theta(wo)
    sin_alpha = torch.where(ti_bigger, sin_to, sin_ti)
    tan_beta = torch.where(
        ti_bigger,
        sin_ti / torch.clamp(abs_cos_theta(wi), min=1e-7),
        sin_to / torch.clamp(abs_cos_theta(wo), min=1e-7),
    )
    return kd * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))[..., None]


def microfacet_reflection_f(kr, eta, alpha, wo, wi, fresnel_kind="dielectric"):
    """GGX reflection lobe (reflection.go:670-736)."""
    c_o = abs_cos_theta(wo)
    c_i = abs_cos_theta(wi)
    wh = wi + wo
    degen = (c_o < 1e-7) | (c_i < 1e-7) | (torch.sum(wh * wh, dim=-1) < 1e-14)
    wh = normalize(wh, eps=1e-20)
    if fresnel_kind == "dielectric":
        f_term = fr_dielectric(dot(wi, torch.where(wh[..., 2:3] < 0, -wh, wh)),
                               1.0, eta)[..., None]
    else:  # Schlick conductor with kr as f0
        f_term = schlick_fresnel(dot(wi, wh), kr)
    val = kr * f_term * (
        tr_d(wh, alpha) * tr_g(wo, wi, alpha) / torch.clamp(4.0 * c_o * c_i, min=1e-7)
    )[..., None]
    return torch.where(degen[..., None] | ~same_hemisphere(wo, wi)[..., None], 0.0, val)


def microfacet_transmission_f(kt, eta_interior, alpha, wo, wi):
    """GGX transmission lobe (reflection.go:738-835), radiance transport."""
    same = same_hemisphere(wo, wi)
    c_o = cos_theta(wo)
    c_i = cos_theta(wi)
    eta = torch.where(c_o > 0, eta_interior, 1.0 / eta_interior)
    wh = normalize(wo + wi * eta[..., None], eps=1e-20)
    wh = torch.where(wh[..., 2:3] < 0, -wh, wh)
    sqrt_denom = dot(wo, wh) + eta * dot(wi, wh)
    f_term = fr_dielectric(dot(wo, wh), 1.0, eta_interior)
    factor = 1.0 / eta  # radiance transport scaling handled via eta_scale
    val = kt * (
        (1.0 - f_term) * torch.abs(
            tr_d(wh, alpha) * tr_g(wo, wi, alpha) * eta * eta
            * torch.abs(dot(wi, wh)) * torch.abs(dot(wo, wh)) * factor * factor
            # |c_i c_o|: the signed product is negative for transmission, and
            # clamping it at +1e-10 floors the denominator (bsdf.py:329-336)
            / torch.clamp(torch.abs(c_i * c_o) * sqrt_denom * sqrt_denom, min=1e-10)
        )
    )[..., None]
    degen = same | (torch.abs(c_i) < 1e-7) | (torch.abs(c_o) < 1e-7)
    return torch.where(degen[..., None], 0.0, val)


# ---------------------------------------------------------------------------
# Whole-material eval / pdf / sample (reflection.go:120-278)
# ---------------------------------------------------------------------------


class BsdfSample(NamedTuple):
    wi: torch.Tensor  # f32[N,3] local
    f: torch.Tensor  # f32[N,3]
    pdf: torch.Tensor  # f32[N]
    is_specular: torch.Tensor  # bool[N]: a delta lobe was sampled
    is_transmission: torch.Tensor  # bool[N]
    eta_scale: torch.Tensor  # f32[N]: radiance scaling (path.go:105-115)


def _matte_f(mp: MaterialParams, wo, wi):
    lam = lambert_f(mp.kd, wo, wi)
    if mp.info is None or mp.info.any_oren_nayar:
        f = torch.where((mp.sigma > 0.0)[..., None],
                        oren_nayar_f(mp.kd, mp.sigma, wo, wi), lam)
    else:
        f = lam
    return torch.where(same_hemisphere(wo, wi)[..., None], f, 0.0)


def _glass_rough_f(mp: MaterialParams, wo, wi):
    fr = microfacet_reflection_f(mp.kr, mp.eta, mp.roughness, wo, wi)
    ft = microfacet_transmission_f(mp.kt, mp.eta, mp.roughness, wo, wi)
    return torch.where(same_hemisphere(wo, wi)[..., None], fr, ft)


def _plastic_f(mp: MaterialParams, wo, wi):
    diff = lambert_f(mp.kd, wo, wi)
    spec = microfacet_reflection_f(mp.kr, mp.eta, mp.roughness, wo, wi)
    return torch.where(same_hemisphere(wo, wi)[..., None], diff + spec, 0.0)


def _metal_f(mp: MaterialParams, wo, wi):
    f = microfacet_reflection_f(mp.kr, mp.eta, mp.roughness, wo, wi, "schlick")
    return torch.where(same_hemisphere(wo, wi)[..., None], f, 0.0)


def _sss_exit_f(mp: MaterialParams, wo, wi):
    """The BSSRDF exit lobe Sw (bsdf.py:386-396): isotropic in azimuth,
    Fresnel-shaped in theta, on the outward hemisphere (the integrator sets
    wo = +ns at the exit)."""
    from gopbrt_tpu_torch.ops.bssrdf import sw

    f = sw(mp.eta, cos_theta(wi), c_bar=mp.sss_cbar)[..., None] * torch.ones_like(mp.kd)
    return torch.where(same_hemisphere(wo, wi)[..., None], f, 0.0)


def bsdf_f(mp: MaterialParams, wo, wi):
    """Non-delta f(wo, wi) (BSDF.F, reflection.go:169-186); delta lobes
    (mirror, smooth glass) give zero."""
    types = _mtypes(mp)
    may_rough, _ = _glass_split(mp)
    branches = []
    if MATTE in types:
        branches.append((mp.mat_type == MATTE, _matte_f(mp, wo, wi)))
    if GLASS in types and may_rough:
        rough_glass = (mp.mat_type == GLASS) & (mp.roughness > 1e-4)
        branches.append((rough_glass, _glass_rough_f(mp, wo, wi)))
    if PLASTIC in types:
        branches.append((mp.mat_type == PLASTIC, _plastic_f(mp, wo, wi)))
    if METAL in types:
        branches.append((mp.mat_type == METAL, _metal_f(mp, wo, wi)))
    if SUBSURFACE in types:
        branches.append((mp.mat_type == SUBSURFACE, _sss_exit_f(mp, wo, wi)))
    f = torch.zeros_like(wo)
    for mask, val in branches:
        f = torch.where(mask[..., None], val, f)
    return f


def bsdf_pdf(mp: MaterialParams, wo, wi):
    """Solid-angle pdf of bsdf_sample (BSDF.Pdf, reflection.go:255-278)."""
    types = _mtypes(mp)
    may_rough, _ = _glass_split(mp)
    need_cos = MATTE in types or PLASTIC in types or SUBSURFACE in types
    need_mfr = (GLASS in types and may_rough) or PLASTIC in types or METAL in types
    same = same_hemisphere(wo, wi)
    if need_cos:
        cos_pdf = abs_cos_theta(wi) * INV_PI
    if need_mfr:
        wh_r = normalize(wi + wo, eps=1e-20)
        mf_pdf_r = tr_pdf(wo, wh_r, mp.roughness) / torch.clamp(
            4.0 * torch.abs(dot(wo, wh_r)), min=1e-7)

    branches = []
    if MATTE in types:
        branches.append((mp.mat_type == MATTE, torch.where(same, cos_pdf, 0.0)))
    if GLASS in types and may_rough:
        # rough glass: Fresnel-weighted reflection or transmission pdf
        eta = torch.where(cos_theta(wo) > 0, mp.eta, 1.0 / mp.eta)
        wh_t = normalize(wo + wi * eta[..., None], eps=1e-20)
        sqrt_denom = dot(wo, wh_t) + eta * dot(wi, wh_t)
        dwh_dwi = torch.abs((eta * eta * dot(wi, wh_t))
                            / torch.clamp(sqrt_denom * sqrt_denom, min=1e-10))
        mf_pdf_t = tr_pdf(wo, wh_t, mp.roughness) * dwh_dwi
        f_term = fr_dielectric(cos_theta(wo), 1.0, mp.eta)
        glass_pdf = torch.where(same, f_term * mf_pdf_r, (1.0 - f_term) * mf_pdf_t)
        branches.append(((mp.mat_type == GLASS) & (mp.roughness > 1e-4), glass_pdf))
    if PLASTIC in types:
        branches.append((mp.mat_type == PLASTIC,
                         torch.where(same, 0.5 * (cos_pdf + mf_pdf_r), 0.0)))
    if METAL in types:
        branches.append((mp.mat_type == METAL, torch.where(same, mf_pdf_r, 0.0)))
    if SUBSURFACE in types:
        # the exit lobe is cosine-sampled (see bsdf_sample)
        branches.append((mp.mat_type == SUBSURFACE, torch.where(same, cos_pdf, 0.0)))
    pdf = torch.zeros_like(wo[..., 0])
    for mask, val in branches:
        pdf = torch.where(mask, val, pdf)
    return pdf


def bsdf_sample(mp: MaterialParams, wo, u2, uc) -> BsdfSample:
    """Sample wi ~ BSDF (BSDF.SampleF, reflection.go:188-253).  u2: f32[N,2]
    for the lobe's 2D sample; uc: f32[N] for the lobe choice (Fresnel R/T,
    plastic diffuse/gloss).  Only the scene's lobes are computed."""
    one = torch.ones_like(wo[..., 0])
    false = torch.zeros_like(one, dtype=torch.bool)

    types = _mtypes(mp)
    may_rough, may_smooth = _glass_split(mp)
    has_rough_glass = GLASS in types and may_rough
    has_smooth_glass = GLASS in types and may_smooth
    need_matte = MATTE in types or PLASTIC in types or SUBSURFACE in types
    need_mfr = has_rough_glass or PLASTIC in types or METAL in types

    if need_matte:
        # cosine hemisphere on wo's side
        wi_matte = cosine_sample_hemisphere(u2)
        flip = trace.to_card([1.0, 1.0, -1.0], wo.device, wo.dtype)
        wi_matte = torch.where(cos_theta(wo)[..., None] < 0, wi_matte * flip, wi_matte)
        pdf_matte = abs_cos_theta(wi_matte) * INV_PI
    if MIRROR in types or has_smooth_glass:
        wi_mirror = reflect_local(wo)
    if has_smooth_glass or has_rough_glass:
        entering = cos_theta(wo) > 0
        eta_ratio = torch.where(entering, 1.0 / mp.eta, mp.eta)

    if has_smooth_glass:
        # FresnelSpecular (reflection.go:465-536, bug #8 fixed)
        f_term = fr_dielectric(cos_theta(wo), 1.0, mp.eta)
        choose_r = uc < f_term
        f_fr = (f_term[..., None] * mp.kr
                / torch.clamp(abs_cos_theta(wi_mirror), min=1e-7)[..., None])
        z = torch.zeros_like(one)
        n_local = torch.stack([z, z, torch.where(entering, 1.0, -1.0)], dim=-1)
        ok_t, wi_ft = refract(wo, n_local, eta_ratio)
        wi_ft = normalize(wi_ft, eps=1e-20)
        # (eta_i / eta_t)^2 in f; eta_scale undoes it for roulette
        f_ft = (((1.0 - f_term) * eta_ratio * eta_ratio)[..., None] * mp.kt
                / torch.clamp(abs_cos_theta(wi_ft), min=1e-7)[..., None])
        wi_glass = torch.where(choose_r[..., None], wi_mirror, wi_ft)
        f_glass = torch.where(choose_r[..., None], f_fr,
                              torch.where(ok_t[..., None], f_ft, 0.0))
        pdf_glass = torch.where(choose_r, f_term, 1.0 - f_term)
        glass_transmit = ~choose_r & ok_t
        eta_scale_glass = torch.where(glass_transmit, 1.0 / (eta_ratio * eta_ratio), 1.0)

    if need_mfr:
        # GGX half-vector sample (rough glass, plastic, metal)
        wh = tr_sample_wh(wo, u2, mp.roughness)
        wi_mfr = normalize(2.0 * dot(wo, wh)[..., None] * wh - wo, eps=1e-20)

    if has_rough_glass:
        fr_wh = fr_dielectric(dot(wo, wh), 1.0, mp.eta)
        choose_rr = uc < fr_wh
        ok_mt, wi_mft = refract(wo, torch.where(dot(wo, wh)[..., None] < 0, -wh, wh),
                                eta_ratio)
        wi_mft = normalize(wi_mft, eps=1e-20)
        wi_rough = torch.where(choose_rr[..., None], wi_mfr, wi_mft)
        f_rough = _glass_rough_f(mp, wo, wi_rough)
        pdf_rough = bsdf_pdf(mp._replace(mat_type=torch.full_like(mp.mat_type, GLASS),
                                         info=_only(GLASS, rough=True)), wo, wi_rough)
        rough_transmit = ~choose_rr & ok_mt
        eta_scale_rough = torch.where(rough_transmit, 1.0 / (eta_ratio * eta_ratio), 1.0)

    if PLASTIC in types:
        # diffuse or glossy by uc, pdf averaged over both lobes
        wi_plastic = torch.where((uc < 0.5)[..., None], wi_matte, wi_mfr)
        f_plastic = _plastic_f(mp, wo, wi_plastic)
        pdf_plastic = bsdf_pdf(mp._replace(mat_type=torch.full_like(mp.mat_type, PLASTIC),
                                           info=_only(PLASTIC)), wo, wi_plastic)
    if METAL in types:
        f_metal = _metal_f(mp, wo, wi_mfr)
        pdf_metal = bsdf_pdf(mp._replace(mat_type=torch.full_like(mp.mat_type, METAL),
                                         info=_only(METAL)), wo, wi_mfr)

    if GLASS in types:
        if may_rough and may_smooth:
            rough_glass = (mp.mat_type == GLASS) & (mp.roughness > 1e-4)
            smooth_glass = (mp.mat_type == GLASS) & ~(mp.roughness > 1e-4)
        elif may_rough:
            rough_glass, smooth_glass = mp.mat_type == GLASS, false
        else:
            rough_glass, smooth_glass = false, mp.mat_type == GLASS

    # precedence-ordered branches: (mask, wi, f, pdf)
    branches = []
    if MATTE in types:
        branches.append((mp.mat_type == MATTE, wi_matte, _matte_f(mp, wo, wi_matte),
                         pdf_matte))
    if MIRROR in types:
        # delta reflection, Fresnel no-op (mirror.go:21-32)
        f_mirror = mp.kr / torch.clamp(abs_cos_theta(wi_mirror), min=1e-7)[..., None]
        branches.append((mp.mat_type == MIRROR, wi_mirror, f_mirror, one))
    if has_smooth_glass:
        branches.append((smooth_glass, wi_glass, f_glass, pdf_glass))
    if has_rough_glass:
        branches.append((rough_glass, wi_rough, f_rough, pdf_rough))
    if PLASTIC in types:
        branches.append((mp.mat_type == PLASTIC, wi_plastic, f_plastic, pdf_plastic))
    if METAL in types:
        branches.append((mp.mat_type == METAL, wi_mfr, f_metal, pdf_metal))
    if SUBSURFACE in types:
        # the exit lobe, cosine-sampled (the entry transport is the
        # integrator's _subsurface_transport, before the dispatch)
        branches.append((mp.mat_type == SUBSURFACE, wi_matte, _sss_exit_f(mp, wo, wi_matte),
                         pdf_matte))
    if not branches:
        raise ValueError("bsdf_sample: empty material set")
    _, wi, f, pdf = branches[-1]
    for mask, wi_b, f_b, pdf_b in branches[-2::-1]:
        wi = torch.where(mask[..., None], wi_b, wi)
        f = torch.where(mask[..., None], f_b, f)
        pdf = torch.where(mask, pdf_b, pdf)

    is_specular = false
    if MIRROR in types:
        is_specular = mp.mat_type == MIRROR
    if has_smooth_glass:
        is_specular = is_specular | smooth_glass
    is_transmission = false
    eta_scale = one
    if has_smooth_glass:
        is_transmission = torch.where(smooth_glass, glass_transmit, is_transmission)
        eta_scale = torch.where(smooth_glass, eta_scale_glass, eta_scale)
    if has_rough_glass:
        is_transmission = torch.where(rough_glass, rough_transmit, is_transmission)
        eta_scale = torch.where(rough_glass, eta_scale_rough, eta_scale)
    return BsdfSample(wi=wi, f=f, pdf=pdf, is_specular=is_specular,
                      is_transmission=is_transmission, eta_scale=eta_scale)
