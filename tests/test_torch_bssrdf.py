"""The port's BSSRDF (``gopbrt_tpu_torch/ops/bssrdf.py``) and its exit lobe
(``ops/bsdf`` SUBSURFACE) against the JAX package's ``ops/bssrdf.py`` and
``bsdf._sss_exit_f`` dispatch, on inputs made from numpy seeds.

Bar: within 1e-6 relative (1e-7 absolute near zero): the same float32
formulas; the Fresnel moment's 64-point mean and the Newton inverse's 12
steps may round an ulp apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gopbrt_tpu.ops import bsdf as jbsdf
from gopbrt_tpu.ops import bssrdf as jsss
from gopbrt_tpu.ops import static_info as jstatic
from gopbrt_tpu_torch.ops import bsdf as tbsdf
from gopbrt_tpu_torch.ops import bssrdf as tsss
from gopbrt_tpu_torch.ops import static_info as tstatic

N = 301


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_fresnel_moment_and_normalization():
    eta = np.asarray([1.0, 1.2, 1.33, 1.5, 2.4], np.float32)
    _close(tsss.fresnel_moment1(torch.tensor(eta)), jsss.fresnel_moment1(jnp.asarray(eta)))
    _close(tsss.sw_normalization(torch.tensor(eta)), jsss.sw_normalization(jnp.asarray(eta)))
    rho = np.linspace(0.0, 1.0, 11).astype(np.float32)
    _close(tsss.burley_scaling(rho), jsss.burley_scaling(rho))


@pytest.mark.parametrize("seed", [0, 1])
def test_burley_profile_cdf_and_newton_inverse(seed):
    r = np.random.default_rng(seed)
    d = r.uniform(0.01, 0.5, N).astype(np.float32)
    rad = (r.random(N) * 3.0 * d).astype(np.float32)
    rad[:4] = 0.0  # the clamped 1/r pole
    u = r.random(N).astype(np.float32)
    u[:2] = (0.999, 0.99995)
    _close(tsss.burley_pdf_area(torch.tensor(rad), torch.tensor(d)),
           jsss.burley_pdf_area(jnp.asarray(rad), jnp.asarray(d)))
    _close(tsss.burley_cdf(torch.tensor(rad), torch.tensor(d)),
           jsss.burley_cdf(jnp.asarray(rad), jnp.asarray(d)))
    _close(tsss.burley_sample_r(torch.tensor(u), torch.tensor(d)),
           jsss.burley_sample_r(jnp.asarray(u), jnp.asarray(d)), rtol=2e-6)


def test_axis_frame_pdf_sp_sp_and_sw():
    r = np.random.default_rng(7)
    ns = _unit(r, N)
    ss = _unit(r, N)
    ss = ss - ns * np.sum(ss * ns, 1, keepdims=True)
    ss = (ss / np.linalg.norm(ss, axis=1, keepdims=True)).astype(np.float32)
    ts = np.cross(ns, ss).astype(np.float32)
    u_axis = r.random(N).astype(np.float32)
    got = tsss.sample_axis_frame(*map(torch.tensor, (u_axis, ss, ts, ns)))
    want = jsss.sample_axis_frame(*map(jnp.asarray, (u_axis, ss, ts, ns)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    p_in = r.normal(size=(N, 3)).astype(np.float32)
    p_out = (p_in + r.normal(size=(N, 3)) * 0.2).astype(np.float32)
    n_out = _unit(r, N)
    d_rgb = r.uniform(0.02, 0.4, (N, 3)).astype(np.float32)
    args = (p_in, ss, ts, ns, p_out, n_out, d_rgb)
    _close(tsss.pdf_sp(*map(torch.tensor, args)), jsss.pdf_sp(*map(jnp.asarray, args)),
           rtol=2e-6)
    rho = r.random((N, 3)).astype(np.float32)
    rad = r.uniform(0.0, 1.0, N).astype(np.float32)
    _close(tsss.sp(*map(torch.tensor, (rho, rad, d_rgb))),
           jsss.sp(*map(jnp.asarray, (rho, rad, d_rgb))))
    eta = r.uniform(1.1, 1.6, N).astype(np.float32)
    cos_t = r.uniform(-1.0, 1.0, N).astype(np.float32)
    cbar = np.asarray(jsss.sw_normalization(jnp.asarray(eta)))
    _close(tsss.sw(torch.tensor(eta), torch.tensor(cos_t)),
           jsss.sw(jnp.asarray(eta), jnp.asarray(cos_t)))
    _close(tsss.sw(torch.tensor(eta), torch.tensor(cos_t), torch.tensor(cbar)),
           jsss.sw(jnp.asarray(eta), jnp.asarray(cos_t), jnp.asarray(cbar)))


@pytest.mark.parametrize("with_cbar", [False, True])
def test_subsurface_lobe_f_pdf_and_sample(with_cbar):
    """The exit lobe's three dispatch branches (bsdf.py:418-419, 432,
    468-470, 493, 640-644) on SUBSURFACE lanes mixed with matte and mirror
    lanes (the lobe set of a subsurface scene), wo on both sides."""
    kw = dict(mat_types=(jbsdf.MATTE, jbsdf.MIRROR, jbsdf.SUBSURFACE), any_rough_glass=False,
              any_smooth_glass=False, any_oren_nayar=False)
    r = np.random.default_rng(13)
    mat = r.choice([jbsdf.MATTE, jbsdf.MIRROR, jbsdf.SUBSURFACE], N).astype(np.int32)
    kd = r.random((N, 3)).astype(np.float32)
    kr = r.random((N, 3)).astype(np.float32)
    eta = r.uniform(1.1, 1.6, N).astype(np.float32)
    z = np.zeros(N, np.float32)
    cbar = np.asarray(jsss.sw_normalization(jnp.asarray(eta))) if with_cbar else None
    wo, wi = _unit(r, N), _unit(r, N)
    u2 = r.random((N, 2)).astype(np.float32)
    uc = r.random(N).astype(np.float32)

    def params(mod, info, conv):
        return mod.MaterialParams(mat_type=conv(mat), kd=conv(kd), sigma=conv(z), kr=conv(kr),
                                  kt=conv(kd), eta=conv(eta), roughness=conv(z), info=info,
                                  sss_cbar=None if cbar is None else conv(cbar))

    jmp = params(jbsdf, jstatic.MatInfo(**kw), jnp.asarray)
    tmp = params(tbsdf, tstatic.MatInfo(**kw), torch.tensor)
    _close(tbsdf.bsdf_f(tmp, torch.tensor(wo), torch.tensor(wi)),
           jbsdf.bsdf_f(jmp, jnp.asarray(wo), jnp.asarray(wi)))
    _close(tbsdf.bsdf_pdf(tmp, torch.tensor(wo), torch.tensor(wi)),
           jbsdf.bsdf_pdf(jmp, jnp.asarray(wo), jnp.asarray(wi)))
    got = tbsdf.bsdf_sample(tmp, *map(torch.tensor, (wo, u2, uc)))
    want = jbsdf.bsdf_sample(jmp, *map(jnp.asarray, (wo, u2, uc)))
    for field in ("is_specular", "is_transmission"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    for field in ("wi", "f", "pdf", "eta_scale"):
        _close(getattr(got, field), getattr(want, field), rtol=2e-6, atol=1e-6)
    sss = mat == jbsdf.SUBSURFACE
    assert sss.sum() > 50 and float(got.f.numpy()[sss].max()) > 0.0
