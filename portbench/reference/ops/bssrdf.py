"""Separable BSSRDF (subsurface scattering) over the wavefront.

Counterpart of ``gopbrt_tpu/ops/bssrdf.py``: the separable BSSRDF

    S(po, wo, pi, wi) = (1 - Fr(cos theta_o)) Sp(po, pi) Sw(wi)

with the Burley / Christensen normalized-diffusion radial profile
Sp(r) = rho (e^{-r/d} + e^{-r/(3d)}) / (8 pi d r) per channel, its CDF and
Newton inverse (12 steps), the probe axis frame (n / s / t at .5 / .25 /
.25), the axis- and channel-MIS pdf ``pdf_sp``, ``sp``, the exit lobe
``sw`` and its normalization from the exact first Fresnel moment (a
64-point midpoint quadrature).  The reference declares the BSSRDF hook but
never fires it (``pkg/pbrt/bssrdf.go:3-12``, ``pkg/integrator/
path.go:120-141``); the probe transport that uses these is
``models/integrators._subsurface_transport``.
"""

from __future__ import annotations

import torch

from reference.ops.geom import PI, dot

# axis-choice probabilities (PBRT SeparableBSSRDF::Sample_Sp)
AXIS_PROB = (0.5, 0.25, 0.25)  # ns, ss, ts

_MOMENT_QUAD_N = 64


def fresnel_moment1(eta):
    """First Fresnel moment 2 int_0^1 Fr(eta, mu) mu dmu by a 64-point
    midpoint quadrature, so that the Sw lobe integrates to 1 over the
    hemisphere."""
    from reference.ops.bsdf import fr_dielectric

    eta = torch.as_tensor(eta, dtype=torch.float32)
    mu = (torch.arange(_MOMENT_QUAD_N, dtype=torch.float32, device=eta.device) + 0.5) \
        / _MOMENT_QUAD_N
    fr = fr_dielectric(mu, 1.0, eta[..., None])
    return 2.0 * torch.mean(fr * mu, dim=-1)


def sw_normalization(eta):
    """c-bar = 1 - moment1(eta): with the exact moment, int Sw cos = 1."""
    return torch.clamp(1.0 - fresnel_moment1(eta), min=1e-4)


def burley_scaling(rho):
    """Christensen-Burley albedo remap s(rho): d = mfp / s turns a mean
    free path into the profile radius."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    return 1.9 - rho + 3.5 * (rho - 0.8) ** 2


def burley_pdf_area(r, d):
    """Unit-albedo profile R(r) = (e^{-r/d} + e^{-r/(3d)}) / (8 pi d r): the
    pdf of the disk point in area measure."""
    d = torch.clamp(d, min=1e-6)
    rc = torch.maximum(r, 1e-6 * d)  # the integrable 1/r pole, clamped
    return (torch.exp(-rc / d) + torch.exp(-rc / (3.0 * d))) / (8.0 * PI * d * rc)


def burley_cdf(r, d):
    """CDF of the radial density 2 pi r R(r):
    1 - e^{-r/d} / 4 - 3 e^{-r/(3d)} / 4."""
    d = torch.clamp(d, min=1e-6)
    return 1.0 - 0.25 * torch.exp(-r / d) - 0.75 * torch.exp(-r / (3.0 * d))


def burley_sample_r(u, d, n_iter: int = 12):
    """The Burley CDF inverted by ``n_iter`` Newton steps: u in [0, 1) ->
    radius."""
    d = torch.clamp(d, min=1e-6)
    u = torch.clamp(u, 0.0, 0.9999)
    r = d  # median-ish start
    for _ in range(n_iter):
        f = burley_cdf(r, d) - u
        # radial pdf (e^{-r/d} + e^{-r/(3d)}) / (4d)
        p = (torch.exp(-r / d) + torch.exp(-r / (3.0 * d))) / (4.0 * d)
        r = torch.minimum(torch.clamp(r - f / torch.clamp(p, min=1e-12), min=0.0), 60.0 * d)
    return r


def sample_axis_frame(u_axis, ss, ts, ns):
    """The probe projection axis: with prob .5 along -ns (frame ss, ts, ns),
    .25 along -ss (ts, ns, ss), .25 along -ts (ns, ss, ts) -> (vx, vy, vz,
    axis id)."""
    a0 = u_axis < AXIS_PROB[0]
    a1 = (~a0) & (u_axis < AXIS_PROB[0] + AXIS_PROB[1])
    axis = torch.where(a0, 0, torch.where(a1, 1, 2)).to(torch.int32)
    m0 = a0[..., None]
    m1 = a1[..., None]
    vx = torch.where(m0, ss, torch.where(m1, ts, ns))
    vy = torch.where(m0, ts, torch.where(m1, ns, ss))
    vz = torch.where(m0, ns, torch.where(m1, ss, ts))
    return vx, vy, vz, axis


def pdf_sp(p_entry, ss, ts, ns, p_exit, n_exit, d_rgb):
    """pdf (area measure at the exit) of the probe scheme, MIS over the
    three projection axes and the three channels
    (SeparableBSSRDF::Pdf_Sp); d_rgb f32[N,3] the channels' radii."""
    dvec = p_exit - p_entry
    d_local = torch.stack([dot(ss, dvec), dot(ts, dvec), dot(ns, dvec)], dim=-1)
    n_local = torch.stack([torch.abs(dot(ss, n_exit)), torch.abs(dot(ts, n_exit)),
                           torch.abs(dot(ns, n_exit))], dim=-1)
    # the projected radius probing along ns / ss / ts
    r_proj = torch.stack([
        torch.sqrt(d_local[..., 0] ** 2 + d_local[..., 1] ** 2),
        torch.sqrt(d_local[..., 1] ** 2 + d_local[..., 2] ** 2),
        torch.sqrt(d_local[..., 2] ** 2 + d_local[..., 0] ** 2),
    ], dim=-1)
    # |n_exit . probe axis|: ns -> n_local[2], ss -> [0], ts -> [1]
    n_axis = torch.stack([n_local[..., 2], n_local[..., 0], n_local[..., 1]], dim=-1)
    ch_prob = 1.0 / 3.0
    pdf = torch.zeros(r_proj.shape[:-1], dtype=torch.float32, device=r_proj.device)
    for axis in range(3):
        pr = burley_pdf_area(r_proj[..., axis][..., None], d_rgb)  # [N,3]
        pdf = pdf + AXIS_PROB[axis] * n_axis[..., axis] * ch_prob * torch.sum(pr, dim=-1)
    return pdf


def sp(rho, r, d_rgb):
    """Spatial term Sp(po, pi) = rho R(|po - pi|) per channel; rho f32[N,3]."""
    return rho * burley_pdf_area(r[..., None], d_rgb)


def sw(eta, cos_theta_i, c_bar=None):
    """Directional exit term Sw(w) = (1 - Fr(eta, cos theta)) / (c-bar pi)
    per lane; c_bar: the material's ``sw_normalization`` (the scene table
    ``Materials.sss_cbar``), computed here where None."""
    from reference.ops.bsdf import fr_dielectric

    if c_bar is None:
        c_bar = sw_normalization(eta)
    fr = fr_dielectric(cos_theta_i, 1.0, eta)
    return (1.0 - fr) / torch.clamp(c_bar * PI, min=1e-6)
