"""The general wavefront path integrator: the port's ``_li_wavefront``
against JAX's ``_li_jnp``, and against the port's own megakernel chain.

The scene sits outside the megakernel's fast path: plastic, metal, an
Oren-Nayar matte, a triangle, a disk area light, a uv checker and the power
light distribution, at 32x32, depth 5, with the ray cone on.  Bar: > 98% of
lanes within 1e-3 relative (tests/test_megakernel.py:114).  The same bar
holds the two chains of the port against each other on fast-path scenes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_torch, camera_rays, carry, lane_agreement
from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import gallery as jgallery
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.ops import megakernel as tmk

W = H = 32
DEPTH, SEED, CONE = 5, 5, (0.0, 0.003)

_jax_li = jax.jit(jint._li_jnp, static_argnames=("cfg",))


def feature_scene():
    """Every feature of the general chain that the fast path lacks."""
    b = JaxBuilder(light_strategy="power")
    uvc = b.checkerboard_texture((0.9, 0.8, 0.2), (0.1, 0.2, 0.6), vs=(8.0, 0.0, 0.0),
                                 vt=(0.0, 8.0, 0.0), mapping="uv")
    b.disk(np.asarray(jgeom.rotate_x(-90.0)), 30.0, b.matte(kd=(1.0, 1.0, 1.0), kd_tex=uvc))
    b.sphere(np.asarray(jgeom.translate([-1.6, 0.8, 0.0])), 0.8,
             b.plastic(kd=(0.2, 0.5, 0.8), ks=(0.3, 0.3, 0.3), roughness=0.1))
    b.sphere(np.asarray(jgeom.translate([0.2, 0.8, -0.5])), 0.8,
             b.metal(f0=(0.95, 0.7, 0.3), roughness=0.2))
    b.sphere(np.asarray(jgeom.translate([1.9, 0.7, 0.3])), 0.7,
             b.matte(kd=(0.7, 0.7, 0.6), sigma=25.0))
    b.triangle((-3.0, 0.0, -2.5), (3.0, 0.0, -2.5), (0.0, 3.5, -2.5),
               b.matte(kd=(0.6, 0.3, 0.3)))
    lamp = b.disk(np.asarray(jgeom.matmul(jgeom.translate([0.0, 4.0, 1.0]),
                                          jgeom.rotate_x(90.0))), 1.0, b.matte(kd=0.0))
    b.area_light(lamp, radiance=(12.0, 11.0, 10.0))
    b.point_light(p=(3.0, 5.0, 3.0), intensity=(8.0, 8.0, 8.0))
    scene = b.build(accelerator="none")
    cam = jcam.perspective_camera(
        jgeom.look_at([0.0, 2.0, 6.0], [0.0, 0.8, 0.0], [0.0, 1.0, 0.0]), W, H, fov_deg=50.0)
    return scene, cam


@pytest.fixture(scope="module")
def features():
    js, cam = feature_scene()
    assert not js.fastinfo.ok
    return js, carry(js), camera_rays(cam, W, H, 1, SEED)


def test_li_wavefront_matches_li_jnp_per_lane(features):
    js, ts, rays = features
    want = np.asarray(_jax_li(js, *rays, jnp.uint32(SEED), jint.PathConfig(max_depth=DEPTH),
                              cone=CONE))
    before = dict(_build.LAUNCHES)
    got = tint._li_wavefront(ts, *as_torch(*rays), SEED, tint.PathConfig(max_depth=DEPTH),
                             cone=CONE)
    assert dict(_build.LAUNCHES) == before  # CPU tensors: the plain intersection
    frac, mean_rel = lane_agreement(got.numpy(), want)
    assert frac > 0.98, f"lane agreement {frac:.4f}"
    assert mean_rel < 1e-2, mean_rel
    assert want.mean() > 1e-2


def test_li_sends_scenes_outside_the_fast_path_to_the_wavefront_chain(features):
    _, ts, rays = features
    args = (ts, *as_torch(*rays), SEED, tint.PathConfig(max_depth=3))
    assert torch.equal(tint.li(*args, cone=CONE), tint._li_wavefront(*args, cone=CONE))


def test_early_exit_gives_the_fixed_depth_result(features):
    _, ts, rays = features
    args = (ts, *as_torch(*rays), SEED)
    full = tint._li_wavefront(*args, tint.PathConfig(max_depth=12))
    early = tint._li_wavefront(*args, tint.PathConfig(max_depth=12, early_exit=True))
    assert torch.equal(full, early)


@pytest.mark.parametrize("name", ["demo", "config4_arealights_glass"])
def test_wavefront_chain_matches_the_megakernel_chain(name):
    """Two independent chains of the port on fast-path scenes: the general
    wavefront loop and the megakernel's plain version, depth 10."""
    if name == "demo":
        js, cam = jdemo.build_demo_scene(accelerator="none"), jdemo.build_demo_camera(W, H)
    else:
        js, cam, _ = jgallery.CONFIGS[name](W, H)
    ts = carry(js)
    assert ts.fastinfo.ok
    rays = as_torch(*camera_rays(cam, W, H, 1, SEED))
    cfg = tint.PathConfig(max_depth=10)
    got = tint._li_wavefront(ts, *rays, SEED, cfg, cone=CONE)
    want = tmk.path_li_plain(ts, *rays, SEED, cfg, cone=CONE)
    assert torch.equal(tint.li(ts, *rays, SEED, cfg, cone=CONE), want)  # fast path
    frac, mean_rel = lane_agreement(got.numpy(), want.numpy())
    assert frac > 0.98, f"lane agreement {frac:.4f}"
    assert mean_rel < 1e-2, mean_rel

