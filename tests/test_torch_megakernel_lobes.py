"""The port's plain megakernel on the mirror and glass lobes, against JAX.

Cornell mirror (gallery.config2), smooth glass (gallery.config4, depth 8)
and rough glass (tests/test_megakernel.py:61-86): path_li_plain per lane
against _li_jnp and the interpret-mode Pallas megakernel, on identical
tables and rays, at the bars of tests/test_megakernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (as_torch, camera_rays, carry, lane_agreement,
                           rough_glass_camera, rough_glass_scene)
from gopbrt_tpu.models import gallery
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import pallas_megakernel as jmk
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.ops import megakernel as tmk

# name -> (seed, depth, lane bar, mean bar)
CASES = {
    "config2": (9, 5, 0.99, 5e-3),
    "config4": (3, 8, 0.98, 1e-2),
    "rough_glass": (13, 5, 0.98, 1e-2),
}


def _scene(name):
    if name == "rough_glass":
        js = rough_glass_scene(JaxBuilder, jgeom).build(accelerator="none")
        return js, rough_glass_camera(48, 48)
    js, camera, _ = getattr(gallery, name)(48, 48)
    return js, camera


@pytest.mark.parametrize("ref_kind", ["jnp", "interpret"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_on_lobes(name, ref_kind):
    seed, depth, lane_bar, mean_bar = CASES[name]
    js, camera = _scene(name)
    assert js.fastinfo.ok
    rays = camera_rays(camera, 48, 48, 1, seed)
    cfg = jint.PathConfig(max_depth=depth, rr_threshold=1.0)
    if ref_kind == "jnp":
        ref = jint._li_jnp(js, *rays, jnp.uint32(seed), cfg)
    else:
        ref = jmk.path_li_fused(js, *rays, jnp.uint32(seed), cfg, interpret=True)
    ref = np.asarray(ref)
    got = tmk.path_li_plain(carry(js), *as_torch(*rays), seed,
                            tint.PathConfig(max_depth=depth)).numpy()
    assert np.all(np.isfinite(got))
    frac, mean_rel = lane_agreement(got, ref)
    assert frac > lane_bar, f"lane agreement {frac:.4f}"
    assert mean_rel < mean_bar, mean_rel


# name -> the lobe events its paths must meet
LOBE_EVENTS = {
    "config2": ("mirror_samples",),
    "config4": ("glass_reflect", "glass_refract"),
    "rough_glass": ("rough_reflect", "rough_refract", "nee_rough", "rough_hits"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_event_counts_follow_the_paths(name):
    """The events path_li_plain counts for the kernel's operation bound:
    counting leaves the radiance as it is, each event has its operation
    count, and the branches of a bounce add up."""
    seed, depth, _, _ = CASES[name]
    js, camera = _scene(name)
    args = (carry(js), *as_torch(*camera_rays(camera, 48, 48, 1, seed)), seed,
            tint.PathConfig(max_depth=depth))
    c = {}
    bounces = torch.zeros((48 * 48,), dtype=torch.int64)
    got = tmk.path_li_plain(*args, counts=c, bounces=bounces)
    assert torch.equal(got, tmk.path_li_plain(*args))
    assert set(c) <= set(tmk.OPS_PER_EVENT)
    assert all(c[k] > 0 for k in LOBE_EVENTS[name])
    g = c.get
    assert c["paths"] == 48 * 48
    # the bounces each lane ran: every lane its first, a lane goes on only
    # after a hit whose sample held
    assert int(bounces.min()) == 1
    assert int(bounces.max()) <= depth
    assert c["hits"] <= int(bounces.sum()) <= 48 * 48 + c["continues"]
    samples = ("mirror_samples", "glass_reflect", "glass_refract", "rough_reflect",
               "rough_refract", "lambert_samples")
    assert sum(g(k, 0) for k in samples) == c["hits"]
    assert c["nee"] + g("mirror_samples", 0) + g("glass_reflect", 0) + g("glass_refract", 0) \
        == c["hits"]
    lights = ("nee_point", "nee_distant", "nee_area_outside", "nee_area_inside")
    assert sum(g(k, 0) for k in lights) == c["nee"]
    assert g("nee_rough", 0) + c["nee_lambert"] == c["nee"]
    assert c["unoccluded"] <= c["shadow_rays"] <= c["nee"]
    assert c["continues"] <= c["bsdf_ok"] <= c["hits"]
    assert tmk.fp32_ops(c) > 0
