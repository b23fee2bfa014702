"""The direct-lighting integrator: the port's li_direct against JAX's.

Per lane on the demo at 64x36, depth 3, with both light strategies: > 99%
of lanes within 1e-3 relative (the bar of tests/test_megakernel.py for a
chain that traces the same paths).  Then BASELINE config 1 through the
port's ``render`` against tests/goldens/config1_demo_direct.npz, at the
gates of tests/test_goldens.TOLS.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_torch, camera_rays, carry, lane_agreement
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.models import gallery as tgallery
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models import render as trender
from tests.test_goldens import GOLDEN_DIR, TOLS

W, H, DEPTH, SEED = 64, 36, 3, 11

_jax_li_direct = jax.jit(jint.li_direct, static_argnames=("max_depth", "light_strategy"))


@pytest.fixture(scope="module")
def demo():
    js = jdemo.build_demo_scene(accelerator="none")
    rays = camera_rays(jdemo.build_demo_camera(W, H), W, H, 1, SEED)
    return js, carry(js), rays


@pytest.mark.parametrize("strategy", ["one", "all"])
def test_li_direct_matches_jax_per_lane(demo, strategy):
    js, ts, rays = demo
    cone = (0.0, 0.004)
    want = np.asarray(_jax_li_direct(js, *rays, jnp.uint32(SEED), max_depth=DEPTH,
                                     cone=cone, light_strategy=strategy))
    before = dict(_build.LAUNCHES)
    got = tint.li_direct(ts, *as_torch(*rays), SEED, max_depth=DEPTH, cone=cone,
                         light_strategy=strategy)
    assert dict(_build.LAUNCHES) == before  # CPU tensors: the plain intersection
    assert got.shape == (W * H, 3) and bool(torch.isfinite(got).all())
    frac, mean_rel = lane_agreement(got.numpy(), want)
    assert frac > 0.99, f"lane agreement {frac:.4f}"
    assert mean_rel < 1e-3, mean_rel
    assert want.mean() > 1e-3


def test_li_direct_rejects_an_unknown_strategy(demo):
    _, ts, rays = demo
    with pytest.raises(ValueError, match="light_strategy"):
        tint.li_direct(ts, *as_torch(*rays), SEED, light_strategy="spatial")


def test_config1_render_matches_its_golden():
    name = "config1_demo_direct"
    ref = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["img"].astype(np.float32)
    scene, cam, settings = tgallery.config1(device="cpu")
    img = trender.render(scene, cam, settings, device="cpu").numpy()
    assert img.shape == ref.shape
    diff = np.abs(img - ref)
    mean_tol, pix_tol, frac = TOLS[name]
    assert diff.mean() < mean_tol, f"mean drift {diff.mean():.2e}"
    assert (diff < pix_tol).mean() > frac, f"pixels off: {(diff >= pix_tol).mean():.4f}"


def test_gallery_config3_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgallery.config3(device="cpu")
