"""The port's bounce megakernel module against gopbrt_tpu's, on the demo.

path_li_plain (the plain version of csrc/megakernel.cu) is held per lane
against the JAX wavefront chain (_li_jnp) and the Pallas megakernel in
interpret mode, on identical scene tables and camera rays, at the bars of
tests/test_megakernel.py.  The CUDA kernel itself is held against
path_li_plain on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (as_torch, camera_rays, carry, lane_agreement,
                           rough_glass_scene)
from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import pallas_megakernel as jmk
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import megakernel as tmk

SEED = 7


@pytest.fixture(scope="module")
def demo():
    js = jdemo.build_demo_scene(accelerator="none")
    camera = jdemo.build_demo_camera(64, 36)
    rays = camera_rays(camera, 64, 36, 1, SEED)
    spread = float(jcam.pixel_spread(camera)[1])
    return js, carry(js), rays, spread


def _reference(kind, js, rays, depth, cone):
    o, d, pixel, sample = rays
    cfg = jint.PathConfig(max_depth=depth, rr_threshold=1.0)
    if kind == "jnp":
        out = jint._li_jnp(js, o, d, pixel, sample, jnp.uint32(SEED), cfg, cone=cone)
    else:
        out = jmk.path_li_fused(js, o, d, pixel, sample, jnp.uint32(SEED), cfg,
                                interpret=True, cone=cone)
    return np.asarray(out)


@pytest.mark.parametrize("ref_kind", ["jnp", "interpret"])
@pytest.mark.parametrize("use_cone", [False, True])
@pytest.mark.parametrize("depth", [1, 5])
def test_plain_matches_jax_on_demo(demo, depth, use_cone, ref_kind):
    js, ts, rays, spread = demo
    cone = (0.0, spread) if use_cone else None
    ref = _reference(ref_kind, js, rays, depth, cone)
    got = tmk.path_li_plain(ts, *as_torch(*rays), SEED,
                            tint.PathConfig(max_depth=depth), cone=cone).numpy()
    assert np.all(np.isfinite(got))
    frac, mean_rel = lane_agreement(got, ref)
    assert frac > 0.99, f"lane agreement {frac:.4f}"
    assert mean_rel < 2e-3, mean_rel
    assert ref.mean() > 1e-3  # the image is not black


@pytest.mark.parametrize("name", ["demo", "rough_glass"])
def test_shade_and_light_tables_match_jax(name):
    if name == "demo":
        js = jdemo.build_demo_scene(accelerator="none")
    else:
        js = rough_glass_scene(JaxBuilder, jgeom).build(accelerator="none")
    ts = carry(js)
    np.testing.assert_array_equal(tmk.shade_table(ts).numpy(),
                                  np.asarray(jmk._shade_table(js)))
    for got, want in zip(tmk.light_tables(ts), jmk._light_tables(js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_tables_follow_the_layout(demo):
    _, ts, _, _ = demo
    packed = tmk.pack_tables(ts)
    assert packed.shape == (tmk.TABLE_WORDS,) and tmk.TABLE_WORDS == 3585
    offsets, pos = {}, 0
    for name, words in tmk.TABLE_LAYOUT:
        offsets[name] = pos
        pos += words
    p = ts.prims.count
    shade = packed[offsets["shade"]:offsets["shade"] + p * tmk.SH_K].reshape(p, -1)
    assert torch.equal(shade, tmk.shade_table(ts))
    assert torch.equal(packed[offsets["lcdf"]:offsets["lcdf"] + ts.n_lights + 1],
                       ts.light_cdf)


@pytest.mark.parametrize("sigma", [0.0, 20.0])
def test_builder_packs_the_kernel_tables_once(sigma):
    """A scene the kernel takes carries its packed tables from the builder;
    an Oren-Nayar scene, outside the fast path, carries none."""
    b = SceneBuilder()
    b.sphere(np.eye(4), 1.0, b.matte(sigma=sigma))
    b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
    scene = b.build(device="cpu")
    if sigma > 0.0:
        assert scene.kernel is None
        return
    assert torch.equal(scene.kernel.tables, tmk.pack_tables(scene))
    assert scene.kernel.func_int == float(scene.light_func_int)
    assert scene.kernel.world_radius == float(scene.world_radius)


def test_fused_on_cpu_runs_the_plain_version_without_a_launch(demo):
    _, ts, rays, spread = demo
    before = _build.LAUNCHES["megakernel"]
    cfg = tint.PathConfig(max_depth=3)
    args = (ts, *as_torch(*rays), SEED, cfg)
    got = tint.li_fused(tmk.BRUTE, *args, cone=(0.0, spread))
    assert torch.equal(got, tmk.path_li_plain(*args, cone=(0.0, spread)))
    assert _build.LAUNCHES["megakernel"] == before


def test_li_raises_outside_the_fast_path():
    """Outside the fast path li runs the general wavefront chain."""
    b = SceneBuilder()
    b.sphere(np.eye(4), 1.0, b.matte(sigma=20.0))  # Oren-Nayar: no megakernel
    b.point_light(p=(0.0, 5.0, 5.0), intensity=(1.0, 1.0, 1.0))
    scene = b.build(device="cpu")
    assert not scene.fastinfo.ok
    o = torch.tensor([[0.0, 0.0, 5.0], [3.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    args = (scene, o, d, torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int64), 0)
    got = tint.li(*args)
    assert torch.equal(got, tint._li_wavefront(*args))
    assert float(got[0].amax()) > 0.0 and float(got[1].amax()) == 0.0
