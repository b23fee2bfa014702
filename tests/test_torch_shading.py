"""The port's surface helpers against the JAX functions they port.

surface_interaction and spawn_ray (spheres, partial and scaled; disks;
triangles; reversed orientation), eval_spectrum (constant, planar and uv
checkers with and without the cone filter, the uv texture), bsdf_f /
bsdf_pdf / bsdf_sample for every ported lobe, sample_li / pdf_li /
le_emitted for point, distant, sphere- and disk-area lights, and the power
light distribution.  Inputs come from numpy seeds; both packages get the
same arrays.  Float results agree within rtol 1e-4 / atol 1e-5 (the same
f32 formulas, summed in another order); flags and indices exactly.
"""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carry, carry_prims
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import bsdf as jbsdf
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import intersect as jisect
from gopbrt_tpu.ops import lights as jlights
from gopbrt_tpu.ops import static_info as jstatic
from gopbrt_tpu.ops import texture as jtex
from gopbrt_tpu_torch.ops import bsdf as tbsdf
from gopbrt_tpu_torch.ops import intersect as tisect
from gopbrt_tpu_torch.ops import lights as tlights
from gopbrt_tpu_torch.ops import static_info as tstatic
from gopbrt_tpu_torch.ops import texture as ttex

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL, err=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, err
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=err)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=err)


def _t(*arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _shapes_scene():
    """Full, partial and non-uniformly scaled spheres, an annulus disk, a
    reversed disk, two triangles; a sphere and a disk lamp."""
    b = JaxBuilder()
    m = b.matte()
    b.sphere(np.asarray(jgeom.translate([0.0, 0.0, 0.0])), 1.0, m, z_min=-0.5,
             z_max=0.7, phi_max_deg=270.0)
    b.sphere(np.asarray(jgeom.translate([2.5, 0.0, 0.0]) @ jgeom.scale(1.0, 1.5, 0.8)),
             0.8, m)
    b.sphere(np.asarray(jgeom.translate([-2.5, 0.5, 0.0])), 0.9, m, reverse_orientation=True)
    b.disk(np.asarray(jgeom.translate([0.0, -1.5, 0.0]) @ jgeom.rotate_x(-90.0)), 3.0,
           m, inner_radius=0.6)
    b.disk(np.asarray(jgeom.translate([0.0, 0.0, -2.0])), 3.0, m, reverse_orientation=True)
    b.triangle((-1.0, 1.5, -1.0), (1.0, 1.5, -1.0), (0.0, 1.5, 1.0), m)
    b.triangle((-3.0, -1.0, 1.0), (-1.0, -1.0, 1.0), (-2.0, 1.0, 1.0), m)
    lamp = b.sphere(np.asarray(jgeom.translate([0.0, 4.0, 1.0])), 0.5, m)
    b.area_light(lamp, radiance=(5.0, 4.0, 3.0), two_sided=False)
    panel = b.disk(np.asarray(jgeom.translate([2.0, 3.5, 0.0]) @ jgeom.rotate_x(90.0)),
                   0.8, m)
    b.area_light(panel, radiance=(2.0, 3.0, 4.0), two_sided=True)
    b.point_light(p=(1.0, 5.0, 2.0), intensity=(10.0, 10.0, 10.0))
    b.distant_light(direction=(-1.0, 1.0, 0.5), radiance=(0.3, 0.3, 0.3))
    return b.build(accelerator="none")


@pytest.fixture(scope="module")
def shapes():
    return _shapes_scene()


def test_surface_interaction_and_spawn_ray(shapes):
    r = np.random.default_rng(0)
    n = 3000
    o = (r.normal(size=(n, 3)) * 4.0).astype(np.float32)
    target = (r.random((n, 3)) * [6.0, 4.0, 4.0] - [3.0, 2.0, 2.0]).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    hit, t, idx = jisect.intersect_brute(shapes.prims, jnp.asarray(o), jnp.asarray(d),
                                         jnp.full((n,), 1e30))
    assert float(jnp.mean(hit)) > 0.3
    want = jisect.surface_interaction(shapes.prims, hit, t, idx, jnp.asarray(o),
                                      jnp.asarray(d))
    got = tisect.surface_interaction(carry_prims(shapes.prims), *_t(hit, t, idx, o, d))
    h = torch.tensor(np.asarray(hit))
    for field in ("p", "n", "ns", "uv", "dpdu", "dpdv", "wo"):
        _close(getattr(got, field)[h], np.asarray(getattr(want, field))[h.numpy()], rtol=1e-3,
               atol=1e-4, err=field)
    _close(got.p_err[h], np.asarray(want.p_err)[h.numpy()], rtol=1e-3, atol=1e-7, err="p_err")
    wi = _unit(r, n)
    _close(tisect.spawn_ray(got, torch.tensor(wi))[h],
           np.asarray(jisect.spawn_ray(want, jnp.asarray(wi)))[h.numpy()], rtol=1e-4,
           atol=1e-4)


def _texture_tables():
    b = JaxBuilder()
    b.constant_texture((0.3, 0.6, 0.9))
    b.checkerboard_texture((0.9, 0.8, 0.1), (0.1, 0.2, 0.7), vs=(0.7, 0.0, 0.0),
                           vt=(0.0, 0.0, 0.7), mapping="planar")
    b.checkerboard_texture((1.0, 1.0, 1.0), (0.0, 0.0, 0.0), vs=(8.0, 0.0, 0.0),
                           vt=(0.0, 6.0, 0.0), ds=0.25, dt=0.5, mapping="uv")
    b.uv_texture()
    b.sphere(np.eye(4, dtype=np.float32), 1.0, b.matte())
    b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
    return b.build(accelerator="none")


@pytest.mark.parametrize("filtered", [False, True])
def test_eval_spectrum(filtered):
    js = _texture_tables()
    r = np.random.default_rng(1)
    n = 4000
    tex_id = r.integers(-1, 4, n).astype(np.int32)
    p = (r.normal(size=(n, 3)) * 5.0).astype(np.float32)
    uv = (r.random((n, 2)) * 3.0 - 1.0).astype(np.float32)
    fw = (r.random(n) * 0.5).astype(np.float32) if filtered else None
    want = jtex.eval_spectrum(js.textures, jnp.asarray(tex_id), jnp.asarray(p),
                              jnp.asarray(uv), fw=None if fw is None else jnp.asarray(fw))
    got = ttex.eval_spectrum(carry(js).textures, *_t(tex_id, p, uv),
                             fw=None if fw is None else torch.tensor(fw))
    _close(got, want, atol=1e-5)


def _mat_info(tag, rough=False, smooth=False, oren=False):
    kw = dict(mat_types=(tag,), any_rough_glass=rough, any_smooth_glass=smooth,
              any_oren_nayar=oren)
    return jstatic.MatInfo(**kw), tstatic.MatInfo(**kw)


# (name, material tag, static lobe facts, sigma, roughness, eta)
LOBES = [
    ("lambert", jbsdf.MATTE, {}, 0.0, 0.0, 1.5),
    ("oren_nayar", jbsdf.MATTE, dict(oren=True), 25.0, 0.0, 1.5),
    ("mirror", jbsdf.MIRROR, {}, 0.0, 0.0, 1.5),
    ("smooth_glass", jbsdf.GLASS, dict(smooth=True), 0.0, 0.0, 1.5),
    ("rough_glass", jbsdf.GLASS, dict(rough=True), 0.0, 0.3, 1.45),
    ("plastic", jbsdf.PLASTIC, {}, 0.0, 0.2, 1.5),
    ("metal", jbsdf.METAL, {}, 0.0, 0.15, 1.5),
]


@pytest.mark.parametrize("lobe", LOBES, ids=[lobe[0] for lobe in LOBES])
def test_bsdf_f_pdf_sample(lobe):
    _, tag, facts, sigma, rough, eta = lobe
    r = np.random.default_rng(2 + tag)
    n = 2000
    jinfo, tinfo = _mat_info(tag, **facts)
    cols = dict(
        mat_type=np.full(n, tag, np.int32),
        kd=r.random((n, 3)).astype(np.float32),
        sigma=np.full(n, sigma, np.float32),
        kr=(0.5 + 0.5 * r.random((n, 3))).astype(np.float32),
        kt=(0.5 + 0.5 * r.random((n, 3))).astype(np.float32),
        eta=np.full(n, eta, np.float32),
        roughness=np.full(n, rough, np.float32),
    )
    jmp = jbsdf.MaterialParams(**{k: jnp.asarray(v) for k, v in cols.items()}, info=jinfo)
    tmp = tbsdf.MaterialParams(**{k: torch.tensor(v) for k, v in cols.items()}, info=tinfo)
    wo, wi = _unit(r, n), _unit(r, n)
    u2 = r.random((n, 2)).astype(np.float32)
    uc = r.random(n).astype(np.float32)
    _close(tbsdf.bsdf_f(tmp, *_t(wo, wi)), jbsdf.bsdf_f(jmp, jnp.asarray(wo), jnp.asarray(wi)),
           rtol=1e-3, atol=1e-5, err="f")
    _close(tbsdf.bsdf_pdf(tmp, *_t(wo, wi)),
           jbsdf.bsdf_pdf(jmp, jnp.asarray(wo), jnp.asarray(wi)), rtol=1e-3, atol=1e-5,
           err="pdf")
    got = tbsdf.bsdf_sample(tmp, *_t(wo, u2, uc))
    want = jbsdf.bsdf_sample(jmp, jnp.asarray(wo), jnp.asarray(u2), jnp.asarray(uc))
    for field in ("is_specular", "is_transmission"):
        _close(getattr(got, field), getattr(want, field), err=field)
    for field in ("wi", "f", "pdf", "eta_scale"):
        _close(getattr(got, field), getattr(want, field), rtol=1e-3, atol=1e-4, err=field)


def test_subsurface_exit_lobe_raises():
    """The SUBSURFACE exit lobe no longer raises (it is ported): bsdf_f on
    SUBSURFACE lanes is the reference's Sw lobe; tests/test_torch_bssrdf.py
    holds f, pdf and sample in full."""
    jinfo, tinfo = _mat_info(tbsdf.SUBSURFACE)
    r = np.random.default_rng(4)
    wo, wi = _unit(r, 4), _unit(r, 4)
    wo[:, 2], wi[:, 2] = np.abs(wo[:, 2]), np.abs(wi[:, 2])
    eta = np.full(4, 1.33, np.float32)
    kd = np.full((4, 3), 0.5, np.float32)
    z = np.zeros(4, np.float32)
    jmp = jbsdf.MaterialParams(mat_type=jnp.full((4,), jbsdf.SUBSURFACE), kd=jnp.asarray(kd),
                               sigma=jnp.asarray(z), kr=jnp.asarray(kd), kt=jnp.asarray(kd),
                               eta=jnp.asarray(eta), roughness=jnp.asarray(z), info=jinfo)
    tmp = tbsdf.MaterialParams(mat_type=torch.full((4,), tbsdf.SUBSURFACE), kd=torch.tensor(kd),
                               sigma=torch.tensor(z), kr=torch.tensor(kd), kt=torch.tensor(kd),
                               eta=torch.tensor(eta), roughness=torch.tensor(z), info=tinfo)
    got = tbsdf.bsdf_f(tmp, *_t(wo, wi))
    _close(got, jbsdf.bsdf_f(jmp, jnp.asarray(wo), jnp.asarray(wi)), err="f")
    assert float(got.min()) > 0.0


def test_lights_sample_pdf_and_emission(shapes):
    """All four light kinds, from points outside and inside the sphere lamp."""
    ts = carry(shapes)
    r = np.random.default_rng(3)
    n = 4000
    n_l = shapes.n_lights
    kinds = np.asarray(shapes.lights.light_type)
    assert set(kinds.tolist()) == {jlights.LIGHT_POINT, jlights.LIGHT_DISTANT,
                                   jlights.LIGHT_AREA}
    assert set(np.asarray(shapes.lights.shape_kind)[kinds == jlights.LIGHT_AREA]) == {
        jlights.SHAPE_SPHERE, jlights.SHAPE_DISK}
    idx = r.integers(0, n_l, n).astype(np.int32)
    ref_p = (r.normal(size=(n, 3)) * 2.0).astype(np.float32)
    ref_p[:200] = np.float32([0.0, 4.0, 1.0]) + _unit(r, 200) * 0.3  # inside the lamp
    u2 = r.random((n, 2)).astype(np.float32)
    want = jlights.sample_li(shapes.lights, jnp.asarray(idx), jnp.asarray(ref_p),
                             jnp.asarray(u2), shapes.world_radius)
    got = tlights.sample_li(ts.lights, *_t(idx, ref_p, u2), ts.world_radius)
    _close(got.is_delta, want.is_delta)
    for field in ("wi", "li", "pdf", "dist", "p_light"):
        _close(getattr(got, field), getattr(want, field), rtol=1e-3, atol=1e-4, err=field)
    wi = _unit(r, n)
    wi[::2] = np.asarray(want.wi)[::2]  # half of them toward the sampled point
    _close(tlights.pdf_li(ts.lights, *_t(idx, ref_p, wi)),
           jlights.pdf_li(shapes.lights, jnp.asarray(idx), jnp.asarray(ref_p),
                          jnp.asarray(wi)), rtol=1e-3, atol=1e-4, err="pdf_li")
    prim = r.integers(0, shapes.prims.count, n).astype(np.int32)
    nrm, wo = _unit(r, n), _unit(r, n)
    le_j, lid_j = jlights.le_emitted(shapes.lights, shapes.prims.area_light_id,
                                     jnp.asarray(prim), jnp.asarray(nrm), jnp.asarray(wo))
    le_t, lid_t = tlights.le_emitted(ts.lights, ts.prims.area_light_id, *_t(prim, nrm, wo))
    _close(lid_t, lid_j)
    _close(le_t, le_j)
    assert float(le_t.amax()) > 0.0


def test_power_light_distribution(shapes):
    """power() per light, and the power strategy's tables from both builders."""
    ts = carry(shapes)
    _close(tlights.power(ts.lights, ts.world_radius),
           jlights.power(shapes.lights, shapes.world_radius), rtol=1e-5)
    from gopbrt_tpu_torch.models.scene import SceneBuilder

    def build(cls, **kw):
        b = cls(light_strategy="power")
        m = b.matte()
        b.sphere(np.eye(4, dtype=np.float32), 1.0, m)
        lamp = b.disk(np.eye(4, dtype=np.float32), 0.5, m, height=3.0)
        b.area_light(lamp, radiance=(4.0, 4.0, 4.0))
        b.point_light(p=(0.0, 5.0, 0.0), intensity=(20.0, 10.0, 5.0))
        b.distant_light(direction=(0.0, 1.0, 0.0), radiance=(0.5, 0.5, 0.5))
        return b.build(**kw)

    want = build(JaxBuilder, accelerator="none")
    got = build(SceneBuilder, device="cpu")
    for field in ("light_func", "light_cdf", "light_func_int"):
        _close(getattr(got, field), getattr(want, field), rtol=1e-5, err=field)
    assert asdict(got.materials.info) == asdict(want.materials.info)
