"""The slice as a whole: the port's render_pass and render against JAX's.

The demo at 64x36, depth 5, through both packages' normal entry points
(each on its own builder; the tables are equal, tests/test_torch_scene.py).
JAX on the CPU runs its wavefront chain; the port runs its plain megakernel.
Bands of 16 rows make the last band reach past the image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lane_agreement
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import film as jfilm
from gopbrt_tpu.models import render as jrender
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import film as tfilm
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu.ops import filters as jfilters
from gopbrt_tpu_torch.ops import filters as tfilters

W, H = 64, 36
KW = dict(width=W, height=H, max_depth=5, chunk_pixels=16 * W)


@pytest.fixture(scope="module")
def scenes():
    return (jdemo.build_demo_scene(accelerator="none"), jdemo.build_demo_camera(W, H),
            tdemo.build_demo_scene(device="cpu"), tdemo.build_demo_camera(W, H, device="cpu"))


def test_render_pass_film_matches_jax(scenes):
    js, jc, ts, tc = scenes
    jset = jrender.RenderSettings(spp=1, **KW)
    tset = trender.RenderSettings(spp=1, **KW)
    jf = jrender.render_pass(js, jc, jfilm.new_film(W, H), jset, jnp.uint32(0))
    tf = trender.render_pass(ts, tc, tfilm.new_film(W, H, device="cpu"), tset, 0,
                             device="cpu")
    np.testing.assert_allclose(tf.weight.numpy(), np.asarray(jf.weight), atol=1e-5)
    frac, mean_rel = lane_agreement(tf.rgb.numpy().reshape(-1, 3),
                                    np.asarray(jf.rgb).reshape(-1, 3))
    assert frac > 0.99, f"pixel agreement {frac:.4f}"
    assert mean_rel < 2e-3, mean_rel


def test_render_image_matches_jax(scenes):
    js, jc, ts, tc = scenes
    jimg = np.asarray(jrender.render(js, jc, jrender.RenderSettings(spp=2, **KW)))
    timg = trender.render(ts, tc, trender.RenderSettings(spp=2, **KW), device="cpu")
    assert timg.shape == (H, W, 3) and bool(torch.isfinite(timg).all())
    assert abs(float(timg.mean()) - jimg.mean()) < 2e-3 * jimg.mean()
    assert jimg.mean() > 0.01


@pytest.mark.parametrize("change", [
    lambda m: dict(filter=m.Filter(m.FILTER_GAUSSIAN, 2.0)),
    lambda m: dict(sampler="halton"),
    lambda m: dict(crop=((0, 0), (0.5, 0.5))),
])
def test_unported_settings_raise(scenes, change):
    """A Gaussian filter, the Halton sampler and a crop window: the port's
    render against JAX's on the same settings (> 99% of pixels within 1e-3
    relative)."""
    js, jc, ts, tc = scenes
    jimg = np.asarray(jrender.render(js, jc, jrender.RenderSettings(
        spp=1, **{**KW, **change(jfilters)})))
    timg = trender.render(ts, tc, trender.RenderSettings(spp=1, **{**KW, **change(tfilters)}),
                          device="cpu").numpy()
    assert timg.shape == jimg.shape and jimg.mean() > 0.01
    frac, mean_rel = lane_agreement(timg.reshape(-1, 3), jimg.reshape(-1, 3))
    assert frac > 0.99 and mean_rel < 2e-3, (frac, mean_rel)
