"""The goldens of tests/test_goldens.py that the port's other files do not
hold (config 1: test_torch_direct.py; config 3: test_torch_mesh.py),
rendered by the port's plain path on the CPU at the goldens' own settings:

- configs 2 and 4 at the port's gallery.golden_config (GOLDEN_SETTINGS:
  128x128, 64 spp), at the gates of tests/test_goldens.TOLS;
- the demo developed with the reference's WriteImage semantics
  (``compat_go=True``) at 96x54, 4 spp, depth 5, seed 2, at that test's
  gates (mean 1e-3, 0.995 of pixels within 5e-3);

and the port's GOLDEN_SETTINGS / golden_config against the JAX gallery's.
"""

import os

import numpy as np
import pytest

from gopbrt_tpu.models import gallery as jgallery
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import film as tfilm
from gopbrt_tpu_torch.models import gallery as tgallery
from gopbrt_tpu_torch.models import render as trender
from tests.test_goldens import GOLDEN_DIR, TOLS


def _golden(name: str) -> np.ndarray:
    return np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["img"].astype(np.float32)


@pytest.mark.parametrize("name", ["config2_cornell_mirror", "config4_arealights_glass"])
def test_render_matches_its_golden(name):
    scene, cam, settings = tgallery.golden_config(name, device="cpu")
    ref = _golden(name)
    img = trender.render(scene, cam, settings, device="cpu").numpy()
    assert img.shape == ref.shape
    diff = np.abs(img - ref)
    mean_tol, pix_tol, frac = TOLS[name]
    assert diff.mean() < mean_tol, f"mean drift {diff.mean():.2e}"
    assert (diff < pix_tol).mean() > frac, f"pixels off: {(diff >= pix_tol).mean():.4f}"


def test_compat_go_demo_matches_its_golden():
    w, h = 96, 54
    scene = tdemo.build_demo_scene(device="cpu")
    cam = tdemo.build_demo_camera(w, h, device="cpu")
    settings = trender.RenderSettings(width=w, height=h, spp=4, max_depth=5,
                                      samples_per_pass=4, seed=2)
    film = trender.render_pass(scene, cam, tfilm.new_film(w, h, device="cpu"), settings, 0,
                               device="cpu")
    img = tfilm.develop(film, compat_go=True).numpy()
    ref = _golden("compat_go_demo")
    assert img.shape == ref.shape
    diff = np.abs(img - ref)
    assert diff.mean() < 1e-3, f"mean drift {diff.mean():.2e}"
    assert (diff < 5e-3).mean() > 0.995, f"pixels off: {(diff >= 5e-3).mean():.4f}"


def test_golden_settings_match_jax():
    assert tgallery.GOLDEN_SETTINGS == jgallery.GOLDEN_SETTINGS


@pytest.mark.parametrize("name", sorted(jgallery.CONFIGS))
def test_golden_config_matches_jax(name):
    """The settings, field for field (the filter's too); the scenes are the
    configs' builders, which the builder tests hold."""
    want = jgallery.golden_config(name)[2]
    got = tgallery.golden_config(name, device="cpu")[2]
    assert got._fields == want._fields
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (tuple(g) == tuple(w)) if f == "filter" else (g == w), f
