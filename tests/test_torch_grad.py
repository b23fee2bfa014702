"""Gradients of the port: the torch counterparts of tests/test_grad.py, and
the units that carry them, held against gopbrt_tpu.

- ``_nextafter_away``'s backward is the identity to po (geom.py:321-341).
- ``texture._image_lookup`` equals the reference's, NaN and infinite uv
  included, forward and gradient to the atlas; the builder's image
  textures give the reference's tables array for array.
- ``film.add_samples`` (the scatter splat) and ``film.add_samples_rows``
  (the in-place row splat) give the reference's film and gradient to L
  (tests/test_film_camera.py:51-59).
- The checks of tests/test_grad.py through the port's ``render_pass``:
  finite differences for albedo and light intensity (rtol 2e-2), the image
  linear in intensity (rtol 1e-3), albedo recovery with
  ``torch.optim.Adam`` (atol 0.05), and a finite, nonzero atlas gradient.
  These fast-path scenes run ``integrators.li`` through the bounce
  megakernel's ``autograd.Function``: its plain forward, then the path
  replay through ``_li_wavefront``.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_tables_equal, carry, jax_scene_arrays
from gopbrt_tpu.models import film as jfilm
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import filters as jfilters
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import texture as jtex
from gopbrt_tpu_torch.models import camera as cam_mod
from gopbrt_tpu_torch.models import film as film_mod
from gopbrt_tpu_torch.models import integrators
from gopbrt_tpu_torch.models import render as render_mod
from gopbrt_tpu_torch.models.scene import SceneBuilder, scene_to_arrays
from gopbrt_tpu_torch.ops import filters, geom
from gopbrt_tpu_torch.ops import texture as ttex

# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------


def test_nextafter_away_backward_is_identity():
    rng = np.random.default_rng(0)
    po = torch.tensor(rng.normal(size=(64, 3)).astype(np.float32), requires_grad=True)
    offset = torch.tensor(rng.integers(-1, 2, size=(64, 3)).astype(np.float32),
                          requires_grad=True)
    out = geom._nextafter_away(po, offset)
    p, off = po.detach(), offset.detach()
    assert torch.equal(out != p, ((off > 0) & (p > 0)) | ((off < 0) & (p < 0)))
    w = torch.tensor(rng.normal(size=(64, 3)).astype(np.float32))
    g_po, g_off = torch.autograd.grad(torch.sum(out * w), [po, offset], allow_unused=True)
    assert torch.equal(g_po, w)
    assert g_off is None


def _two_image_scene(builder_cls, geom_mod, **build):
    """Two image textures of different sizes (stacked in one atlas), a
    constant texture between them, and the config-5 sphere and lamp."""
    rng = np.random.default_rng(1)
    b = builder_cls()
    t0 = b.image_texture(rng.uniform(size=(8, 8, 3)).astype(np.float32))
    b.constant_texture((0.3, 0.2, 0.1))
    t2 = b.image_texture(rng.uniform(size=(5, 11, 3)).astype(np.float32), su=2.0, sv=0.5)
    b.disk(np.asarray(geom_mod.rotate_x(-90.0)), 40.0, b.matte(kd_tex=t2))
    b.sphere(np.asarray(geom_mod.translate([0.0, 1.0, 0.0])), 1.0, b.matte(kd_tex=t0))
    lamp = b.sphere(np.asarray(geom_mod.translate([-2.0, 3.5, 2.0])), 0.5, b.matte(kd=0.0))
    b.area_light(lamp, radiance=(26.0, 22.0, 18.0))
    return b.build(accelerator="none", **build)


@pytest.fixture(scope="module")
def images():
    js = _two_image_scene(JaxBuilder, jgeom)
    return js, carry(js)


def test_image_texture_tables_match_jax(images):
    """The builder's atlas (vertical packing), image_rect and every other
    table, array for array; and the same FastPathInfo (not on the fast
    path)."""
    js, _ = images
    ts = _two_image_scene(SceneBuilder, geom, device="cpu")
    assert_tables_equal(scene_to_arrays(ts), jax_scene_arrays(js))
    assert asdict(ts.fastinfo) == asdict(js.fastinfo)
    assert not ts.fastinfo.ok and not ts.fastinfo.mesh_ok


@pytest.mark.parametrize("uv", ["finite", "nan"])
def test_image_lookup_matches_jax(images, uv):
    """Bilinear lookup with wrap addressing, forward and the gradient to the
    atlas; "nan": a quarter of the lanes carry NaN or infinite uv, which
    the sanitize maps to 0 so that the atlas gradient stays finite."""
    js, ts = images
    rng = np.random.default_rng(2)
    n = 256
    tex_id = rng.choice([0, 2], size=n).astype(np.int32)
    s = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    t = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    if uv == "nan":
        bad = rng.choice(n, n // 4, replace=False)
        s[bad[0::3]] = np.nan
        t[bad[1::3]] = np.inf
        s[bad[2::3]] = -np.inf
    w = rng.normal(size=(n, 3)).astype(np.float32)

    def jloss(atlas):
        tex = js.textures._replace(atlas=atlas)
        return jnp.sum(jtex._image_lookup(tex, jnp.asarray(tex_id), jnp.asarray(s),
                                          jnp.asarray(t)) * w)

    want = np.asarray(jtex._image_lookup(js.textures, jnp.asarray(tex_id), jnp.asarray(s),
                                         jnp.asarray(t)))
    want_g = np.asarray(jax.grad(jloss)(js.textures.atlas))
    atlas = ts.textures.atlas.clone().requires_grad_()
    got = ttex._image_lookup(ts.textures._replace(atlas=atlas), torch.tensor(tex_id).long(),
                             torch.tensor(s), torch.tensor(t))
    (got_g,) = torch.autograd.grad(torch.sum(got * torch.tensor(w)), [atlas])
    assert np.all(np.isfinite(got_g.numpy()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5, atol=1e-5)


def _splat_inputs(n=96, w=10, h=7):
    rng = np.random.default_rng(3)
    p = np.stack([rng.uniform(-1.5, w + 1.5, n), rng.uniform(-1.5, h + 1.5, n)],
                 -1).astype(np.float32)
    p[:4] = [[0.2, 0.3], [w - 0.1, h - 0.2], [0.0, 3.0], [5.0, 0.0]]  # edges
    return p, rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32), rng.normal(
        size=(h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("radius", [0.5, 1.0])
def test_add_samples_matches_jax(radius):
    """The scatter splat: the same film as the reference's (taps outside the
    film dropped, as its scatter drops them) and the same gradient to L."""
    p, L, w = _splat_inputs()
    h, wd = w.shape[:2]

    def jrun(L_):
        return jfilm.add_samples(jfilm.new_film(wd, h), jnp.asarray(p), L_,
                                 jfilters.box_filter(radius))

    jf = jrun(jnp.asarray(L))
    want_g = np.asarray(jax.grad(lambda L_: jnp.sum(jrun(L_).rgb * w))(jnp.asarray(L)))
    Lt = torch.tensor(L, requires_grad=True)
    tf = film_mod.add_samples(film_mod.new_film(wd, h, device="cpu"), torch.tensor(p), Lt,
                              filters.box_filter(radius))
    np.testing.assert_allclose(tf.weight.numpy(), np.asarray(jf.weight), atol=1e-6)
    np.testing.assert_allclose(tf.rgb.detach().numpy(), np.asarray(jf.rgb),
                               rtol=1e-6, atol=1e-5)
    (g,) = torch.autograd.grad(torch.sum(tf.rgb * torch.tensor(w)), [Lt])
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)


def test_add_samples_rows_gradient_matches_jax():
    """The row splat folds a band into the film in place; autograd records
    the fold, and the gradient to L is the reference's."""
    rng = np.random.default_rng(4)
    wd, h, rows, row0 = 9, 8, 5, 2
    jitter = rng.uniform(0.0, 1.0, (rows, wd, 2)).astype(np.float32)
    L = rng.uniform(0.0, 2.0, (rows, wd, 3)).astype(np.float32)
    w = rng.normal(size=(h, wd, 3)).astype(np.float32)

    def jloss(L_):
        f = jfilm.add_samples_rows(jfilm.new_film(wd, h), row0, jnp.asarray(jitter), L_)
        return jnp.sum(f.rgb * w)

    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(L)))
    Lt = torch.tensor(L, requires_grad=True)
    film = film_mod.new_film(wd, h, device="cpu")
    out = film_mod.add_samples_rows(film, row0, torch.tensor(jitter), Lt)
    assert out.rgb is film.rgb  # in place: no copy of the film
    (g,) = torch.autograd.grad(torch.sum(out.rgb * torch.tensor(w)), [Lt])
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The checks of tests/test_grad.py, through the port
# ---------------------------------------------------------------------------

SETTINGS = render_mod.RenderSettings(width=12, height=12, spp=4, max_depth=2,
                                     samples_per_pass=4)


@pytest.fixture(scope="module")
def cam():
    return cam_mod.perspective_camera(geom.look_at([0.0, 5.0, 1e-3], [0.0, 0.0, 0.0],
                                                   [0.0, 1.0, 0.0]),
                                      12, 12, fov_deg=35.0, device="cpu")


def make_scene(kd=(0.5, 0.4, 0.3), intensity=100.0):
    b = SceneBuilder()
    floor = b.matte(kd=kd)
    b.disk(geom.rotate_x(-90.0), 100.0, floor)
    b.point_light(p=(0.0, 10.0, 0.0), intensity=(intensity,) * 3)
    return b.build(accelerator="none", device="cpu")


def render_linear(scene, cam, settings=SETTINGS):
    """Un-gamma'd image for clean gradient math."""
    film = film_mod.new_film(settings.width, settings.height, device="cpu")
    film = render_mod.render_pass(scene, cam, film, settings, 0, device="cpu")
    return film.rgb / torch.clamp(film.weight[..., None], min=1e-8)


def _with_kd(base, kd):
    return base._replace(materials=base.materials._replace(kd=kd))


def _with_intensity(base, intensity):
    return base._replace(lights=base.lights._replace(intensity=intensity))


class TestGradVsFiniteDifference:
    def test_albedo_gradient(self, cam):
        base = make_scene()
        assert base.fastinfo.ok

        def loss_fn(k):
            return torch.mean(render_linear(_with_kd(base, k.expand(base.materials.kd.shape)),
                                            cam))

        k = torch.tensor(0.5, requires_grad=True)
        (g,) = torch.autograd.grad(loss_fn(k), [k])
        eps = 1e-2
        with torch.no_grad():
            fd = (loss_fn(torch.tensor(0.5 + eps)) - loss_fn(torch.tensor(0.5 - eps))) / (2 * eps)
        # direct lighting is linear in albedo at depth <= 2: a tight match
        np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)
        assert float(g) > 0  # a brighter albedo, a brighter image

    def test_light_intensity_gradient(self, cam):
        base = make_scene()

        def loss_fn(i):
            return torch.mean(render_linear(
                _with_intensity(base, i.expand(base.lights.intensity.shape)), cam))

        i = torch.tensor(100.0, requires_grad=True)
        (g,) = torch.autograd.grad(loss_fn(i), [i])
        with torch.no_grad():
            fd = (loss_fn(torch.tensor(101.0)) - loss_fn(torch.tensor(99.0))) / 2.0
        np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)

    def test_image_is_linear_in_intensity(self, cam):
        # radiance from a point light is exactly linear in I: the detached-
        # sampling estimator keeps that (gradient == image / I)
        base = make_scene(intensity=50.0)
        img = render_linear(base, cam)
        i = torch.tensor(50.0, requires_grad=True)
        (g,) = torch.autograd.grad(torch.sum(render_linear(
            _with_intensity(base, i.expand(base.lights.intensity.shape)), cam)), [i])
        np.testing.assert_allclose(float(g), float(torch.sum(img)) / 50.0, rtol=1e-3)


def test_albedo_recovery(cam):
    """Albedo from a target rendered with known albedo, through a sigmoid
    (raw albedo can be driven negative, where paths die and the gradient
    vanishes), 60 steps of Adam at 0.2 (tests/test_grad.py:95-120)."""
    target = render_linear(make_scene(kd=(0.8, 0.3, 0.1)), cam)
    base = make_scene(kd=(0.5, 0.5, 0.5))
    logit = torch.zeros_like(base.materials.kd, requires_grad=True)
    opt = torch.optim.Adam([logit], lr=0.2)
    for _ in range(60):
        opt.zero_grad()
        loss = torch.mean((render_linear(_with_kd(base, torch.sigmoid(logit)), cam)
                           - target) ** 2)
        loss.backward()
        opt.step()
    np.testing.assert_allclose(torch.sigmoid(logit)[0].detach().numpy(), [0.8, 0.3, 0.1],
                               atol=0.05)


def test_atlas_gradient_finite_and_nonzero():
    """Atlas gradients through the bilinear image texture: missed lanes
    carry garbage uv, which must not scatter NaN into the atlas gradient
    (tests/test_grad.py:129-160).  The image texture puts the scene outside
    the fast path: autograd runs through the torch chain."""
    b = SceneBuilder()
    tex = b.image_texture(np.full((8, 8, 3), 0.5, np.float32))
    m = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=tex)
    b.sphere(geom.translate([0.0, 0.0, 0.0]), 1.0, m)
    b.point_light(p=(0.0, 5.0, 3.0), intensity=(50.0,) * 3)
    scene = b.build(accelerator="none", device="cpu")
    cam = cam_mod.perspective_camera(geom.look_at([0.0, 0.0, 4.0], [0.0, 0.0, 0.0],
                                                  [0.0, 1.0, 0.0]),
                                     16, 16, fov_deg=40.0, device="cpu")
    settings = render_mod.RenderSettings(width=16, height=16, spp=4, max_depth=2,
                                         samples_per_pass=4)
    atlas = scene.textures.atlas.clone().requires_grad_()
    sc = scene._replace(textures=scene.textures._replace(atlas=atlas))
    (g,) = torch.autograd.grad(torch.mean(render_linear(sc, cam, settings)), [atlas])
    assert np.all(np.isfinite(g.numpy())), "NaN in atlas gradient"
    assert float(g.abs().max()) > 0.0, "atlas gradient identically zero"


# ---------------------------------------------------------------------------
# The Function's contract
# ---------------------------------------------------------------------------


def _demo_band(depth=2):
    from gopbrt_tpu_torch.models.demo import build_demo_camera, build_demo_scene, demo_settings

    scene = build_demo_scene(device="cpu")
    settings = demo_settings(16, 9, spp=1)._replace(max_depth=depth)
    _, o, d, pix, smp = render_mod.band_rays(build_demo_camera(16, 9, device="cpu"),
                                             settings, 0, 9, 0)
    return scene, o, d, pix, smp, render_mod.path_config(settings)


def test_li_is_connected_on_the_fast_path():
    """li on a fast-path scene whose tensors need a gradient returns radiance
    connected to them, equal to the kernel's plain forward; with none
    needing one it keeps no graph.  The rays get a gradient too, not finite
    here, as the reference's is not (jax.grad of _li_jnp to o on this band
    is NaN on every lane)."""
    from gopbrt_tpu_torch.ops import megakernel

    scene, o, d, pix, smp, cfg = _demo_band()
    plain = integrators.li(scene, o, d, pix, smp, 0, cfg)
    assert plain.grad_fn is None
    checker = scene.textures.value1.clone().requires_grad_()
    inten = scene.lights.intensity.clone().requires_grad_()
    o_ = o.clone().requires_grad_()
    sc = _with_intensity(scene, inten)
    sc = sc._replace(textures=sc.textures._replace(value1=checker))
    L = integrators.li(sc, o_, d, pix, smp, 0, cfg)
    assert type(L.grad_fn).__name__ == "_ReplayBackward"
    assert torch.equal(L.detach(), plain)
    assert torch.equal(plain, megakernel.path_li_plain(
        scene, o, d, *megakernel.check_inputs(megakernel.BRUTE, scene, o, d, pix, smp), 0, cfg))
    g_c, g_i, g_o = torch.autograd.grad(L.sum(), [checker, inten, o_])
    assert g_o is not None and g_o.shape == o.shape
    for g in (g_c, g_i):
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_unsupported_backward_raises():
    """A cone that asks for a gradient, and a second derivative through the
    replay, raise instead of returning a detached result."""
    scene, o, d, pix, smp, cfg = _demo_band()
    w0 = torch.tensor(0.0, requires_grad=True)
    with pytest.raises(ValueError, match="cone"):
        integrators.li(scene, o, d, pix, smp, 0, cfg, cone=(w0, 0.003))
    inten = scene.lights.intensity.clone().requires_grad_()
    L = integrators.li(_with_intensity(scene, inten), o, d, pix, smp, 0, cfg)
    (g,) = torch.autograd.grad(torch.sum(L * L), [inten], create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()

