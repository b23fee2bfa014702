"""The spatial light grid of the port against gopbrt_tpu's.

- The builder's grid tables (``light_grid.*``) against the JAX builder's,
  array for array, for tests/test_features.py's two-light scene, with an
  area sphere and a distant light, and the spatial-lights family of
  ``benchmarks/bench_families.py:124-135`` (the port's
  ``gallery.spatial_lights``); the grid keeps scenes off the fast path.
- ``_light_pick`` / ``_light_pick_pmf`` at points in and outside the
  grid against JAX's, index for index.
- The family per lane: ``_li_wavefront`` against ``_li_jnp`` and
  ``li_direct`` against JAX's on the carried tables at 48x27, > 99% of
  lanes within 1e-3 relative (tests/test_megakernel.py's bar).
- The grid's pick through NEE and the MIS weight of emitter hits, per
  lane: the two-light grid scene and a disk-lamp scene, through
  ``_li_wavefront`` and ``li_direct``, against JAX's.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (as_torch, assert_builder_tables_equal,  # noqa: F401
                           assert_tables_equal, bvh_backend, camera_rays, carry,
                           jax_scene_arrays, lane_agreement)
from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu_torch.models import gallery
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models.scene import SceneBuilder, scene_to_arrays
from gopbrt_tpu_torch.ops import geom as tgeom

W, H = 48, 27
SEED = 9
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


def _grid_scene(builder_cls, geom, **kw):
    """tests/test_features.py's two point lights over a floor, with an area
    sphere and a distant light added, at a 5-voxel grid."""
    b = builder_cls(light_strategy="spatial", spatial_resolution=5)
    mat = b.matte(kd=(0.6, 0.6, 0.6))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 40.0, mat)
    b.point_light(p=(10.0, 3.0, 0.0), intensity=(300.0, 300.0, 300.0))
    b.point_light(p=(-10.0, 3.0, 0.0), intensity=(3.0, 3.0, 3.0))
    lamp = b.sphere(np.asarray(geom.translate([0.0, 4.0, 5.0])), 0.5, b.matte(kd=0.0))
    b.area_light(lamp, radiance=(8.0, 8.0, 8.0))
    b.distant_light(direction=(0.3, 1.0, 0.2), radiance=(0.2, 0.2, 0.2))
    return b.build(accelerator="none", **kw)


@pytest.mark.parametrize("name", ["two_lights", "spatial_lights"])
def test_light_grid_tables_match_jax(name, bvh_backend):
    if name == "two_lights":
        want = _grid_scene(JaxBuilder, jgeom)
        got = _grid_scene(SceneBuilder, tgeom, device="cpu")
    else:
        want = _bench_families().spatial_lights()[0]
        got = gallery.spatial_lights(W, H, device="cpu")[0]
    assert_builder_tables_equal(got, want, bvh_backend)
    g = got.light_grid
    v = int(np.prod(g.dims.numpy()))
    assert g.func.shape == (v, got.n_lights) and g.cdf.shape == (v, got.n_lights + 1)
    np.testing.assert_allclose(g.cdf[:, -1].numpy(), 1.0, atol=1e-5)
    assert not got.fastinfo.ok and got.kernel is None
    carried = carry(want)
    assert_tables_equal(scene_to_arrays(carried), jax_scene_arrays(want))


def test_light_pick_matches_jax():
    js = _grid_scene(JaxBuilder, jgeom)
    ts = carry(js)
    r = np.random.default_rng(2)
    p = r.uniform(-60.0, 60.0, (600, 3)).astype(np.float32)
    p[:3] = [[9.0, 1.0, 0.0], [-9.0, 1.0, 0.0], [1e6, -1e6, 0.0]]
    u = r.random(600).astype(np.float32)
    idx_j, pmf_j = jint._light_pick(js, jnp.asarray(p), jnp.asarray(u))
    idx_t, pmf_t = tint._light_pick(ts, torch.tensor(p), torch.tensor(u))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(pmf_t.numpy(), np.asarray(pmf_j), rtol=1e-6)
    lid = r.integers(0, ts.n_lights, 600).astype(np.int32)
    np.testing.assert_allclose(
        tint._light_pick_pmf(ts, torch.tensor(p), torch.tensor(lid)).numpy(),
        np.asarray(jint._light_pick_pmf(js, jnp.asarray(p), jnp.asarray(lid))), rtol=1e-6)
    np.testing.assert_array_equal(tint._voxel_flat(ts, torch.tensor(p)).numpy(),
                                  np.asarray(jint._voxel_flat(js, jnp.asarray(p))))
    # near the bright light its pmf dominates (tests/test_features.py:176-190)
    pmf = tint._light_pick_pmf(ts, torch.tensor(p[:1]), torch.tensor([0]))
    assert float(pmf[0]) > 0.5


@pytest.fixture(scope="module")
def spatial_family():
    js = _bench_families().spatial_lights()[0]
    cam = jcam.perspective_camera(jgeom.look_at([0.0, 2.4, 8.0], [0.0, 1.0, 0.0],
                                                [0.0, 1.0, 0.0]), W, H, fov_deg=45.0)
    return js, carry(js), camera_rays(cam, W, H, 1, SEED)


def test_spatial_family_per_lane(spatial_family):
    js, ts, rays = spatial_family
    cfg_j, cfg_t = jint.PathConfig(max_depth=3), tint.PathConfig(max_depth=3)
    want = np.asarray(_jax_li(js, *rays, jnp.uint32(SEED), cfg_j))
    got = tint._li_wavefront(ts, *as_torch(*rays), SEED, cfg_t).numpy()
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.99 and mean_rel < 1e-2, (frac, mean_rel)
    assert want.mean() > 1e-2
    torch.testing.assert_close(tint.li(ts, *as_torch(*rays), SEED, cfg_t), torch.tensor(got))


def test_spatial_family_direct_per_lane(spatial_family):
    js, ts, rays = spatial_family
    want = np.asarray(_jax_direct(js, *rays, jnp.uint32(SEED), max_depth=3))
    got = tint.li_direct(ts, *as_torch(*rays), SEED, max_depth=3).numpy()
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.99 and mean_rel < 1e-2, (frac, mean_rel)


def _disk_lamp_scene():
    """A disk lamp and a point light over matte and plastic on a 4-voxel
    grid: emitter hits of BSDF rays, the MIS weight's work, read the grid's
    pmf at the ray origin."""
    b = JaxBuilder(light_strategy="spatial", spatial_resolution=4)
    b.disk(np.asarray(jgeom.rotate_x(-90.0)), 30.0, b.matte(kd=(0.7, 0.7, 0.7)))
    b.sphere(np.asarray(jgeom.translate([0.0, 1.0, 0.0])), 1.0,
             b.plastic(kd=(0.2, 0.5, 0.8), roughness=0.2))
    lamp = b.disk(np.asarray(jgeom.matmul(jgeom.translate([0.0, 4.0, 1.0]),
                                          jgeom.rotate_x(90.0))), 1.5, b.matte(kd=0.0))
    b.area_light(lamp, radiance=(12.0, 11.0, 10.0))
    b.point_light(p=(3.0, 5.0, 3.0), intensity=(8.0, 8.0, 8.0))
    cam = jcam.perspective_camera(jgeom.look_at([0.0, 2.0, 6.0], [0.0, 0.8, 0.0],
                                                [0.0, 1.0, 0.0]), W, H, fov_deg=50.0)
    return b.build(accelerator="none"), cam


@pytest.mark.parametrize("scene_name", ["two_lights", "disk_lamp"])
@pytest.mark.parametrize("entry", ["path", "direct"])
def test_grid_pick_per_lane(scene_name, entry):
    """The grid's pick pmf in NEE and in the MIS weight, per lane against
    JAX's chain; li keeps a grid scene off the megakernel."""
    if scene_name == "two_lights":
        js = _grid_scene(JaxBuilder, jgeom)
        cam = jcam.perspective_camera(jgeom.look_at([0.0, 6.0, 14.0], [0.0, 0.0, 0.0],
                                                    [0.0, 1.0, 0.0]), W, H, fov_deg=60.0)
    else:
        js, cam = _disk_lamp_scene()
    ts = carry(js)
    assert ts.light_grid is not None and ts.kernel is None
    rays = camera_rays(cam, W, H, 1, SEED)
    if entry == "path":
        want = np.asarray(_jax_li(js, *rays, jnp.uint32(SEED), jint.PathConfig(max_depth=4)))
        got = tint.li(ts, *as_torch(*rays), SEED, tint.PathConfig(max_depth=4)).numpy()
    else:
        want = np.asarray(_jax_direct(js, *rays, jnp.uint32(SEED), max_depth=4))
        got = tint.li_direct(ts, *as_torch(*rays), SEED, max_depth=4).numpy()
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.99 and mean_rel < 1e-2, (frac, mean_rel)
    assert want.mean() > 1e-3
