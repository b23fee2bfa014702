"""Media, the BSSRDF and bump mapping through the port's torch chain, held
against the JAX package on identical carried scenes and lanes.

- The builder: the port's tables against the JAX builder's, array for
  array, for the reference's media and subsurface families
  (``benchmarks/bench_families.py:77-121``, the port's
  ``models/gallery.FAMILIES``), a bump-mapped matte
  (``tests/test_features.py:207-258``) and a glass shell around an
  absorbing medium (``tests/test_bounded_media.py:128-160``); none on the
  megakernel's fast path.
- ``_li_wavefront`` against ``_li_jnp`` per lane (the JAX side's jnp chain,
  as its own tests run it on the CPU) at 48x27, at each family's depth and
  3 for the small scenes: > 98% of lanes within 1e-3 relative
  (tests/test_megakernel.py:114).  A null sphere without a medium must
  also leave the image as the scene without it gives
  (test_bounded_media.py:54-74; per lane within 1e-4), and a table medium
  holding the camera the global medium's (:33-52; within 1e-5).
- ``li_direct`` with a global fog, with bump and with the BSSRDF: > 99%.
- ``jax.grad`` against torch autograd of sum(L) at 16x16, depth 3, to the
  SSS sphere's albedo and the fog scene's floor kd: within 2e-3 of the
  largest entry (tests/test_torch_grad_parity.py's bar).
"""

import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (as_torch, assert_builder_tables_equal,  # noqa: F401
                           bvh_backend, camera_rays, carry, jax_scene_infos,
                           lane_agreement)
from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu_torch.models import gallery
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import geom as tgeom

W, H = 48, 27
SEED = 7
_jax_li = jax.jit(jint._li_jnp, static_argnames=("cfg",))
_jax_direct = jax.jit(jint.li_direct, static_argnames=("max_depth",))


@functools.cache
def _bench_families():
    """The reference's family builders (benchmarks/bench_families.py)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "bench_families.py")
    spec = importlib.util.spec_from_file_location("bench_families", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the families' cameras (bench_families.py:85-121): eye, look at
FAMILY_VIEWS = {"bounded_media": ((0, 2.4, 6.5), (0, 1.2, 0)),
                "global_fog": ((0, 2.4, 6.5), (0, 1.0, 0)),
                "sss": ((0, 1.5, 4.5), (0, 0.8, 0))}
AXIS_VIEW = ((0.0, 0.0, 5.0), (0.0, 0.0, 0.0))


def bump_scene(cls, geom):
    """A bump-mapped matte sphere (a 32x32 uv checker as its height, scale
    0.5: test_features.py:212-219) on a floor under a point light."""
    b = cls()
    tex = b.checkerboard_texture((1, 1, 1), (0, 0, 0), vs=(32.0, 0, 0), vt=(0, 32.0, 0),
                                 mapping="uv")
    b.sphere(geom.translate([0.0, 1.0, 0.0]), 1.0,
             b.matte(kd=(0.5, 0.5, 0.5), bump_tex=tex, bump_scale=0.5))
    b.disk(geom.rotate_x(-90.0), 20.0, b.matte(kd=(0.4, 0.4, 0.4)))
    b.point_light(p=(3.0, 4.0, 3.0), intensity=(60.0,) * 3)
    return b


def glass_shell_scene(cls, geom):
    """An eta ~1 glass sphere filled with an absorbing medium in front of a
    matte disk (test_bounded_media.py:136-150): the refraction's medium
    switch."""
    b = cls()
    b.disk(np.eye(4), radius=50.0, material=b.matte(kd=(1.0, 1.0, 1.0)))
    b.point_light((4.0, 0.5, 4.0), (16 * math.pi,) * 3)
    interior = b.add_medium((0.4,) * 3)
    ball = b.sphere(geom.translate([0.0, 0.0, 2.0]), 1.0, b.glass(eta=1.0 + 1e-6))
    b.set_medium_interface(ball, inside=interior, outside=-1)
    return b


def null_sphere_scene(cls, geom, with_null=True):
    """A null sphere, no medium, between the camera and a disk
    (test_bounded_media.py:59-70)."""
    b = cls()
    b.disk(np.eye(4), radius=50.0, material=b.matte(kd=(0.7, 0.6, 0.5)))
    b.point_light((0.5, 1.0, 3.0), (20.0,) * 3)
    if with_null:
        b.sphere(geom.translate([0.0, 0.0, 2.0]), 1.0, b.null_material())
    return b


def camera_medium_scene(cls, bounded):
    """A fog filling the scene: a table medium holding the camera, or the
    global medium (test_bounded_media.py:36-48)."""
    b = cls()
    b.disk(np.eye(4), radius=50.0, material=b.matte(kd=(1.0, 1.0, 1.0)))
    b.point_light((0.0, 0.0, 3.0), (9 * math.pi,) * 3)
    if bounded:
        b.set_camera_medium(b.add_medium((0.1,) * 3, (0.05,) * 3, g=0.3))
    else:
        b.set_medium((0.1,) * 3, (0.05,) * 3, g=0.3)
    return b


SMALL = {"bump": (bump_scene, ((0, 1.5, 4.5), (0, 0.8, 0))),
         "glass_shell": (glass_shell_scene, AXIS_VIEW),
         "null_sphere": (null_sphere_scene, AXIS_VIEW)}


def _jax_case(name):
    """(JAX scene, view, depth) of a family or a small scene."""
    if name in FAMILY_VIEWS:
        scene, _, depth = getattr(_bench_families(), name)()
        return scene, FAMILY_VIEWS[name], depth
    build, view = SMALL[name]
    return build(JaxBuilder, jgeom).build(accelerator="none"), view, 3


def _rays(view, width=W, height=H):
    cam = jcam.perspective_camera(jgeom.look_at(list(view[0]), list(view[1]), [0.0, 1.0, 0.0]),
                                  width, height, fov_deg=45.0)
    return camera_rays(cam, width, height, 1, SEED)


@pytest.mark.parametrize("name", ["bounded_media", "global_fog", "sss", "bump",
                                  "glass_shell"])
def test_builder_tables_match_jax(name, bvh_backend):
    """Ints exact, floats within 1e-6 relative, static facts equal; the
    fast path off."""
    if name in FAMILY_VIEWS:
        want, _, _ = getattr(_bench_families(), name)()
        got, _, settings = gallery.FAMILIES[name](W, H, device="cpu")
        assert settings.max_depth == getattr(_bench_families(), name)()[2]
    else:
        build = SMALL[name][0]
        want = build(JaxBuilder, jgeom).build(accelerator="none")
        got = build(SceneBuilder, tgeom).build(accelerator="none", device="cpu")
    assert_builder_tables_equal(got, want, bvh_backend)
    infos = jax_scene_infos(want)
    assert got.materials.info.mat_types == tuple(infos["minfo"]["mat_types"])
    assert got.camera_medium == want.camera_medium
    assert not got.fastinfo.ok and not want.fastinfo.ok


@pytest.mark.parametrize("name", ["bounded_media", "global_fog", "sss", "bump",
                                  "glass_shell", "null_sphere"])
def test_li_wavefront_matches_li_jnp(name):
    js, view, depth = _jax_case(name)
    o, d, pix, smp = _rays(view)
    want = np.asarray(_jax_li(js, o, d, pix, smp, jnp.uint32(SEED),
                              cfg=jint.PathConfig(max_depth=depth)))
    got = tint._li_wavefront(carry(js), *as_torch(o, d, pix, smp), SEED,
                             tint.PathConfig(max_depth=depth)).numpy()
    frac, mean_rel = lane_agreement(got, want)
    print(f"{name}: {frac:.5f} of lanes within 1e-3, mean diff {mean_rel:.2e}, "
          f"mean L {want.mean():.5f}")
    assert frac > 0.98 and mean_rel < 1e-2
    assert np.all(np.isfinite(got)) and want.mean() > 0.0
    if name == "null_sphere":
        bare = null_sphere_scene(SceneBuilder, tgeom, with_null=False).build(
            accelerator="none", device="cpu")
        plain = tint._li_wavefront(bare, *as_torch(o, d, pix, smp), SEED,
                                   tint.PathConfig(max_depth=depth)).numpy()
        # the walk's origin offset past the boundary moves a hit by float
        # rounding: 1e-4 relative (the reference's fixed-ray test, at 1e-5,
        # crosses the sphere head on)
        np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-6)


def test_table_medium_holding_the_camera_is_the_global_medium():
    """Per lane: the port's table medium equals the port's global medium,
    and both equal the reference's table medium (> 98% at 1e-3)."""
    o, d, pix, smp = _rays(AXIS_VIEW)
    cfg = tint.PathConfig(max_depth=3)
    args = as_torch(o, d, pix, smp)
    table = camera_medium_scene(SceneBuilder, True).build(accelerator="none", device="cpu")
    glob = camera_medium_scene(SceneBuilder, False).build(accelerator="none", device="cpu")
    got = tint._li_wavefront(table, *args, SEED, cfg).numpy()
    np.testing.assert_allclose(got, tint._li_wavefront(glob, *args, SEED, cfg).numpy(),
                               rtol=1e-5, atol=1e-6)
    js = camera_medium_scene(JaxBuilder, True).build(accelerator="none")
    want = np.asarray(_jax_li(js, o, d, pix, smp, jnp.uint32(SEED),
                              cfg=jint.PathConfig(max_depth=3)))
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.98 and mean_rel < 1e-2 and want.mean() > 0.0


@pytest.mark.parametrize("name", ["global_fog", "bump", "sss"])
def test_li_direct_matches_jax(name):
    js, view, _ = _jax_case(name)
    o, d, pix, smp = _rays(view)
    want = np.asarray(_jax_direct(js, o, d, pix, smp, jnp.uint32(SEED), max_depth=3))
    got = tint.li_direct(carry(js), *as_torch(o, d, pix, smp), SEED, max_depth=3).numpy()
    frac, mean_rel = lane_agreement(got, want)
    print(f"li_direct {name}: {frac:.5f} of lanes within 1e-3, mean diff {mean_rel:.2e}")
    assert frac > 0.99 and mean_rel < 1e-2 and want.mean() > 0.0


# (family, material row whose kd is the leaf): the SSS sphere's albedo, the
# fog scene's floor
GRAD_CASES = [("sss", 0), ("global_fog", 0)]


@pytest.mark.parametrize("name,row", GRAD_CASES)
def test_grad_matches_jax(name, row):
    """d sum(L) / d kd at 16x16, depth 3: every entry of the material rows
    within 2e-3 of max |g_jax|, and the leaf's own row nonzero."""
    js, view, _ = _jax_case(name)
    o, d, pix, smp = _rays(view, 16, 16)
    cfg_j = jint.PathConfig(max_depth=3)

    def loss_j(kd):
        s = js._replace(materials=js.materials._replace(kd=kd))
        return jnp.sum(jint._li_jnp(s, o, d, pix, smp, jnp.uint32(SEED), cfg=cfg_j))

    g_jax = np.asarray(jax.jit(jax.grad(loss_j))(js.materials.kd))
    ts = carry(js)
    kd = ts.materials.kd.clone().requires_grad_()
    L = tint._li_wavefront(ts._replace(materials=ts.materials._replace(kd=kd)),
                           *as_torch(o, d, pix, smp), SEED, tint.PathConfig(max_depth=3))
    (g,) = torch.autograd.grad(L.sum(), [kd])
    g = g.numpy()
    scale = float(np.abs(g_jax).max())
    err = float(np.abs(g - g_jax).max())
    print(f"{name}: max |g - g_jax| / max |g_jax| = {err / scale:.3e}")
    assert np.all(np.isfinite(g)) and abs(g_jax[row]).max() > 0.0
    assert err <= 2e-3 * scale
