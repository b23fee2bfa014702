"""Gradients of the port against ``jax.grad`` of the reference, on
identical carried scenes and lanes.

The loss is a weighted sum of the radiance, its weights made with numpy
from a seed, so that each case is a vector-Jacobian product.  The port's
side goes through ``integrators.li``: on these fast-path scenes it runs the
new ``autograd.Function`` (the plain forward, the path-replay backward
through ``_li_wavefront``); ``li_direct`` and ``render_wave`` run autograd
through the torch chain.  The JAX side is ``jax.grad`` of ``_li_jnp``,
``li_direct`` or ``render_wave`` on the CPU, where no Pallas kernel runs.

Bar: every entry within 2e-3 of max|g_jax|, and every requested gradient
non-None and nonzero.  The forwards agree per lane within 1e-3 on > 98%
of lanes (float noise flips a discrete decision on the rest); a flipped
lane moves a gradient entry by its own share, so the lanes are few (at most
512) and the bar is taken against the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_torch, camera_rays, carry
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu_torch.models import integrators as tint

SEED = 3
BAR = 2e-3


def _weights(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.5, 1.5, (n, 3)).astype(np.float32)


def _check(got: dict, want: dict):
    for name, w in want.items():
        g = got[name]
        assert g is not None, f"no gradient reached {name}"
        g, w = g.numpy(), np.asarray(w)
        scale = float(np.abs(w).max())
        assert scale > 0.0, f"the reference's gradient to {name} is zero"
        assert np.all(np.isfinite(g)), name
        err = float(np.abs(g - w).max())
        print(f"{name}: max |g - g_jax| / max |g_jax| = {err / scale:.3e}")
        assert err <= BAR * scale, f"{name}: max |g - g_jax| {err:.3e}, bar {BAR * scale:.3e}"


def _torch_grads(ts, fields: dict, loss):
    """The gradients of loss(scene) to the named (group, field) tensors of
    the carried scene ``ts``."""
    leaves = {name: getattr(getattr(ts, g), f).clone().requires_grad_()
              for name, (g, f) in fields.items()}
    groups = {}
    for name, (g, f) in fields.items():
        groups.setdefault(g, {})[f] = leaves[name]
    scene = ts._replace(**{g: getattr(ts, g)._replace(**kw) for g, kw in groups.items()})
    grads = torch.autograd.grad(loss(scene), list(leaves.values()), allow_unused=True)
    return dict(zip(leaves, grads))


def _jax_grads(js, fields: dict, loss):
    names = list(fields)

    def f(*vals):
        groups = {}
        for name, v in zip(names, vals):
            g, fld = fields[name]
            groups.setdefault(g, {})[fld] = v
        return loss(js._replace(**{g: getattr(js, g)._replace(**kw)
                                   for g, kw in groups.items()}))

    vals = [getattr(getattr(js, g), f) for g, f in fields.values()]
    grads = jax.jit(jax.grad(f, argnums=tuple(range(len(names)))))(*vals)
    return dict(zip(names, grads))


DEMO_FIELDS = {"kd": ("materials", "kd"), "intensity": ("lights", "intensity"),
               "checker": ("textures", "value1")}


@pytest.fixture(scope="module")
def demo():
    """The demo scene through a view of its spheres and floor (the demo
    camera sees only the backdrop disk), 32x16 camera rays."""
    from gopbrt_tpu.models import camera as jcam
    from gopbrt_tpu.ops import geom as jgeom

    js = jdemo.build_demo_scene(accelerator="none")
    cam = jcam.perspective_camera(jgeom.look_at([60.0, 40.0, 120.0], [30.0, 5.0, 20.0],
                                                [0.0, 1.0, 0.0]), 32, 16, fov_deg=30.0)
    return js, carry(js), camera_rays(cam, 32, 16, 1, SEED), _weights(32 * 16, SEED)


@pytest.mark.parametrize("depth", [2, 5])
def test_demo_gradient_matches_jax(demo, depth):
    """The megakernel's Function (plain forward, replay backward) against
    jax.grad(_li_jnp); depth 5 runs the roulette from bounce 3, whose
    survival scale carries no gradient."""
    js, ts, rays, wts = demo
    assert ts.fastinfo.ok
    o, d, pixel, sample = rays
    jcfg = jint.PathConfig(max_depth=depth, rr_threshold=1.0)
    want = _jax_grads(js, DEMO_FIELDS, lambda sc: jnp.sum(
        jint._li_jnp(sc, o, d, pixel, sample, jnp.uint32(SEED), jcfg) * wts))
    to, td, tp, tsm = as_torch(*rays)
    tw = torch.tensor(wts)

    def loss(sc):
        L = tint.li(sc, to, td, tp, tsm, SEED, tint.PathConfig(max_depth=depth))
        assert type(L.grad_fn).__name__ == "_ReplayBackward"
        return torch.sum(L * tw)

    _check(_torch_grads(ts, DEMO_FIELDS, loss), want)


def test_mesh_plastic_kd_gradient_matches_jax():
    """The mesh megakernel's Function on the 16x16 mesh (480 plastic
    triangles under the BVH): the plastic lobe's sampling pdf depends on
    kd, so only the detached-sampling estimator agrees."""
    from gopbrt_tpu.models import meshes as jmeshes

    js = jmeshes.build_mesh_scene(n_lat=16, n_lon=16)
    ts = carry(js)
    assert ts.fastinfo.mesh_ok and ts.mesh is not None
    rays = camera_rays(jmeshes.mesh_camera(16, 16), 16, 16, 1, SEED)
    wts = _weights(16 * 16, SEED + 1)
    o, d, pixel, sample = rays
    jcfg = jint.PathConfig(max_depth=3, rr_threshold=1.0)
    fields = {"kd": ("materials", "kd")}
    want = _jax_grads(js, fields, lambda sc: jnp.sum(
        jint._li_jnp(sc, o, d, pixel, sample, jnp.uint32(SEED), jcfg) * wts))
    to, td, tp, tsm = as_torch(*rays)
    tw = torch.tensor(wts)

    def loss(sc):
        L = tint.li(sc, to, td, tp, tsm, SEED, tint.PathConfig(max_depth=3))
        assert type(L.grad_fn).__name__ == "_ReplayBackward"
        return torch.sum(L * tw)

    _check(_torch_grads(ts, fields, loss), want)


def test_li_direct_kd_gradient_matches_jax(demo):
    """li_direct on BASELINE config 1 (the demo, depth 3): autograd through
    the torch chain, whose BSDF sample keeps its gradient as the
    reference's does (integrators.py:1269-1279)."""
    js, ts, rays, wts = demo
    o, d, pixel, sample = rays
    fields = {"kd": ("materials", "kd"), "checker": ("textures", "value1")}
    want = _jax_grads(js, fields, lambda sc: jnp.sum(
        jint.li_direct(sc, o, d, pixel, sample, jnp.uint32(SEED), max_depth=3) * wts))
    to, td, tp, tsm = as_torch(*rays)
    tw = torch.tensor(wts)
    _check(_torch_grads(ts, fields, lambda sc: torch.sum(
        tint.li_direct(sc, to, td, tp, tsm, SEED, max_depth=3) * tw)), want)


def test_config5_atlas_and_radiance_gradients_match_jax():
    """The config-5 scene at 16x16, 2 spp, through both packages'
    ``render_wave`` (the scatter splat) on explicit lanes: the image atlas
    (bilinear lookup) and the lamp's radiance."""
    from gopbrt_tpu.models import camera as jcam
    from gopbrt_tpu.models import film as jfilm
    from gopbrt_tpu.models import render as jrender
    from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
    from gopbrt_tpu.ops import geom as jgeom
    from gopbrt_tpu_torch.models import film as tfilm
    from gopbrt_tpu_torch.models import gallery as tgallery
    from gopbrt_tpu_torch.models import render as trender

    w = h = 16
    spp = 2
    atlas, rad = tgallery.config5_truth()
    b = JaxBuilder()
    b.disk(np.asarray(jgeom.rotate_x(-90.0)), 40.0, b.matte(kd=(0.4, 0.4, 0.4)))
    m = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=b.image_texture(atlas))
    b.sphere(np.asarray(jgeom.translate([0.0, 1.0, 0.0])), 1.0, m)
    lamp = b.sphere(np.asarray(jgeom.translate([-2.0, 3.5, 2.0])), 0.5, b.matte(kd=0.0))
    b.area_light(lamp, radiance=tuple(rad), two_sided=False)
    js = b.build(accelerator="none")
    jc = jcam.perspective_camera(
        jgeom.look_at([0.0, 1.6, 4.0], [0.0, 0.9, 0.0], [0.0, 1.0, 0.0]), w, h, fov_deg=40.0)
    ts, tc, tset = tgallery.config5(atlas, rad, w, h, device="cpu")
    tset = tset._replace(spp=spp)
    jset = jrender.RenderSettings(width=w, height=h, spp=spp, max_depth=3,
                                  samples_per_pass=1, compaction=False)
    n = w * h
    pixel = np.tile(np.arange(n, dtype=np.uint32), spp)
    sample = np.repeat(np.arange(spp, dtype=np.uint32), n)
    wts = _weights(n, SEED + 2).reshape(h, w, 3)
    fields = {"atlas": ("textures", "atlas"), "intensity": ("lights", "intensity")}

    def jloss(sc):
        f = jrender.render_wave(sc, jc, jfilm.new_film(w, h), jset, jnp.asarray(pixel),
                                jnp.asarray(sample))
        return jnp.sum(f.rgb / jnp.maximum(f.weight[..., None], 1e-8) * wts)

    def tloss(sc):
        f = trender.render_wave(sc, tc, tfilm.new_film(w, h, device="cpu"), tset,
                                torch.tensor(pixel.astype(np.int64)),
                                torch.tensor(sample.astype(np.int64)))
        return torch.sum(f.rgb / torch.clamp(f.weight[..., None], min=1e-8)
                         * torch.tensor(wts))

    want = _jax_grads(js, fields, jloss)
    _check(_torch_grads(ts, fields, tloss), want)
