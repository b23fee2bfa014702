"""Wavefront compaction (``PathConfig(compaction=True)``) in the port.

The compacted loop sorts live lanes to the front each bounce and runs
them in chunks of ``chunk_size``; each lane's math and random streams are
the uncompacted chain's, so every lane must agree within 1e-5, the
reference's bar (tests/test_render_e2e.py:231-261), with a chunk size that
does not divide the lane count (padding slots).  Scenes: the demo (brute
force), bounded media (the medium column rides the chunks), the 16x16
mesh (the BVH walk) and a moving sphere (the time column).  Then the
port's compacted loop against JAX's ``_li_compacted``, the render setting,
the loop's host syncs and live lanes (the tracer's counters), and the error
under autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_torch, camera_rays, carry, lane_agreement
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import film as tfilm
from gopbrt_tpu_torch.models import gallery, meshes
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.utils import trace

W, H = 48, 27
SEED = 4
CHUNK = 500  # does not divide 48 * 27 = 1296: the last chunk pads 204 slots


def _moving_sphere(device="cpu"):
    b = SceneBuilder()
    b.disk(tgeom.rotate_x(-90.0), 20.0, b.matte(kd=(0.6, 0.6, 0.6)))
    pid = b.sphere(tgeom.translate([-1.0, 1.0, 0.0]), 0.7, b.matte(kd=(0.8, 0.3, 0.2)))
    b.animate(pid, tgeom.translate([1.0, 1.2, 0.0]))
    b.point_light(p=(3.0, 5.0, 3.0), intensity=(60.0,) * 3)
    cam = tcam.perspective_camera(tgeom.look_at([0.0, 2.0, 6.0], [0.0, 0.8, 0.0],
                                                [0.0, 1.0, 0.0]), W, H, fov_deg=45.0,
                                  device=device)
    return b.build(accelerator="none", device=device), cam


def _scene(name):
    """(scene, camera, depth) on the CPU."""
    if name == "demo":
        return tdemo.build_demo_scene(device="cpu"), tdemo.build_demo_camera(W, H, "cpu"), 10
    if name == "bounded_media":
        scene, cam, settings = gallery.bounded_media(W, H, device="cpu")
        return scene, cam, settings.max_depth
    if name == "mesh_bvh":
        return (meshes.build_mesh_scene(n_lat=16, n_lon=16, device="cpu"),
                meshes.mesh_camera(W, H, device="cpu"), 5)
    scene, cam = _moving_sphere()
    return scene, cam, 4


@pytest.mark.parametrize("name", ["demo", "bounded_media", "mesh_bvh", "moving_sphere"])
def test_compacted_equals_the_uncompacted_chain(name):
    scene, cam, depth = _scene(name)
    settings = trender.RenderSettings(width=W, height=H, spp=1, max_depth=depth, seed=SEED)
    _, o, d, pix, smp = trender.band_rays(cam, settings, 0, H, 0)
    time = trender._time(scene, cam, pix, smp, settings)
    assert (time is not None) == (name == "moving_sphere")
    cone = trender._cone(cam, settings)
    off = tint._li_wavefront(scene, o, d, pix, smp, SEED, tint.PathConfig(max_depth=depth),
                             cone=cone, time=time)
    o_in = o.clone()
    trace.enable()
    try:
        with trace.request() as req:
            on = tint._li_wavefront(scene, o, d, pix, smp, SEED,
                                    tint.PathConfig(max_depth=depth, compaction=True,
                                                    chunk_size=CHUNK),
                                    cone=cone, time=time)
    finally:
        trace.disable()
    assert torch.equal(o, o_in)  # the caller's rays are not written
    assert bool(torch.isfinite(on).all()) and float(off.mean()) > 1e-3
    torch.testing.assert_close(on, off, atol=1e-5, rtol=0.0)
    by_bounce = req.counter("li.lanes_live")
    live = [by_bounce[k] for k in sorted(by_bounce)]
    assert live[0] == W * H and all(a >= b for a, b in zip(live, live[1:]))
    # the loop reads its live count once a bounce: a host sync on a card,
    # none on the CPU
    syncs = req.counter("host_syncs").get("compaction", 0)
    assert syncs == (len(live) if on.is_cuda else 0) and len(live) <= depth


def test_compacted_matches_jax_li_compacted():
    js, jcam = jdemo.build_demo_scene(accelerator="none"), jdemo.build_demo_camera(W, H)
    ts = carry(js)
    rays = camera_rays(jcam, W, H, 1, SEED)
    jcfg = jint.PathConfig(max_depth=10, compaction=True, chunk_size=CHUNK)
    want = np.asarray(jax.jit(jint.li, static_argnames=("cfg",))(
        js, *rays, jnp.uint32(SEED), jcfg))
    got = tint.li(ts, *as_torch(*rays), SEED,
                  tint.PathConfig(max_depth=10, compaction=True, chunk_size=CHUNK)).numpy()
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.99 and mean_rel < 1e-2, (frac, mean_rel)


def test_render_setting_compaction():
    """RenderSettings(compaction=True) reaches PathConfig; the film equals
    the uncompacted pass's within 1e-5."""
    scene, cam = tdemo.build_demo_scene(device="cpu"), tdemo.build_demo_camera(W, H, "cpu")
    kw = dict(width=W, height=H, spp=1, max_depth=6, chunk_pixels=9 * W)
    films = []
    for compaction in (False, True):
        settings = trender.RenderSettings(compaction=compaction, **kw)
        assert trender.path_config(settings).compaction == compaction
        films.append(trender.render_pass(scene, cam, tfilm.new_film(W, H, device="cpu"),
                                         settings, 0, device="cpu"))
    torch.testing.assert_close(films[1].rgb, films[0].rgb, atol=1e-5, rtol=0.0)


def test_compaction_under_autograd_raises():
    scene, cam = tdemo.build_demo_scene(device="cpu"), tdemo.build_demo_camera(W, H, "cpu")
    settings = trender.RenderSettings(width=W, height=H, spp=1, max_depth=3)
    _, o, d, pix, smp = trender.band_rays(cam, settings, 0, 4, 0)
    kd = scene.materials.kd.clone().requires_grad_()
    leafy = scene._replace(materials=scene.materials._replace(kd=kd))
    cfg = tint.PathConfig(max_depth=3, compaction=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tint.li(leafy, o, d, pix, smp, SEED, cfg)
    with torch.no_grad():  # no graph: it runs
        assert tint.li(leafy, o, d, pix, smp, SEED, cfg).shape == o.shape
