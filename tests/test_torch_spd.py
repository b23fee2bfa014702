"""Haines' SPD sphereflake (``gopbrt_tpu_torch/models/spd.py``) and the mesh
megakernel's gate on scenes of spheres.

- The rule: the counts of size factors 0-4, every child tangent to its
  parent, no two spheres of size factor 3 overlapping, balls.c's nine
  directions, the floor tangent to the root.
- The gate: ``mesh_ok`` for the flake and for a seeded random cloud of 300
  spheres without a triangle, still not for the metal mesh; ``li`` sends
  both to ``li_fused`` on ``mesh_megakernel.MESH`` and counts its route in
  ``li.route``.
- Against the benchmark's frozen reference (``portbench/configs/
  sphereflake.py``, loaded from its path): the port's ``render.render`` on
  the CPU at 64x36, every pixel within 1e-5, for the flake at size factor 2
  and for the cloud, at two seeds.
- The plain twin of kernel #5 (``path_li_plain(accel="bvh")``) against the
  chain ``_li_wavefront`` at tests/test_torch_mesh.py's bar: sphere winners
  found in the BVH shade as the chain shades them.
"""

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import CLOUD_LOOK_AT, lane_agreement, sphere_cloud
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models import meshes as tmeshes
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.models import spd
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.ops import megakernel as tmk
from gopbrt_tpu_torch.ops import mesh_megakernel as tmm
from gopbrt_tpu_torch.ops.intersect import SPHERE, TRIANGLE
from gopbrt_tpu_torch.utils import trace

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
W, H = 64, 36
SEEDS = (2**31 + 101, 2**31 + 977)


def _tree(size_factor):
    """(centres, radii, parent index of each sphere, -1 for the root)."""
    c, r = spd.sphereflake(size_factor)
    parent, start = [-1], 0
    for level in range(size_factor):
        n = 9 ** level
        parent += [start + j // 9 for j in range(9 * n)]
        start += n
    return c, r, np.asarray(parent)


@pytest.mark.parametrize("size_factor,count", [(0, 1), (1, 10), (2, 91), (3, 820),
                                               (4, 7381)])
def test_sphere_counts(size_factor, count):
    c, r = spd.sphereflake(size_factor)
    assert c.shape == (count, 3) and r.shape == (count,)
    assert count == (9 ** (size_factor + 1) - 1) // 8


def test_children_are_tangent_to_their_parents():
    c, r, parent = _tree(4)
    kid = parent >= 0
    gap = np.linalg.norm(c[kid] - c[parent[kid]], axis=-1) - (r[parent[kid]] + r[kid])
    assert np.abs(gap).max() < 1e-6
    np.testing.assert_allclose(r[kid], r[parent[kid]] / 3.0)
    assert r[0] == 0.5 and np.all(c[0] == 0.0)


def test_no_two_spheres_overlap():
    c, r = spd.sphereflake(3)
    dist = np.linalg.norm(c[:, None] - c[None], axis=-1)
    reach = r[:, None] + r[None]
    np.fill_diagonal(dist, np.inf)
    assert (dist - reach).min() > -1e-9


def test_the_nine_directions():
    u = spd.objset()
    np.testing.assert_allclose(np.linalg.norm(u, axis=-1), 1.0, atol=1e-12)
    cos = u @ u.T
    np.fill_diagonal(cos, -1.0)
    assert math.degrees(math.acos(cos.max())) >= 60.0 - 1e-9
    az = np.degrees(np.arctan2(u[:, 1], u[:, 0])) % 360.0
    equator = np.abs(u[:, 2]) < 1e-12
    assert equator.sum() == 6
    np.testing.assert_allclose(np.sort(az[equator]), 15.0 + 60.0 * np.arange(6), atol=1e-9)
    np.testing.assert_allclose(u[~equator, 2], math.sqrt(2.0 / 3.0), atol=1e-12)
    np.testing.assert_allclose(np.sort(az[~equator]), [45.0, 165.0, 285.0], atol=1e-9)


def test_floor_is_tangent_to_the_root_and_lights_are_unit():
    b = spd.sphereflake_builder(1)
    tri = [i for i, t in enumerate(b._prim_type) if t == TRIANGLE]
    assert len(tri) == 2
    z = np.concatenate([b._params[i][[2, 5, 8]] for i in tri])
    np.testing.assert_allclose(z, -spd.ROOT_RADIUS)
    for row in b._lights:
        p = np.asarray(row["p"], np.float64)
        np.testing.assert_allclose(np.asarray(row["intensity"]) / (p @ p), 1.0 / 3.0,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def _cloud(device="cpu"):
    return sphere_cloud(SceneBuilder, tgeom).build(device=device)


def _cloud_camera(width, height, cam_mod=tcam, geom=tgeom):
    return cam_mod.perspective_camera(geom.look_at(*CLOUD_LOOK_AT), width, height,
                                      fov_deg=45.0, device="cpu")


@pytest.fixture(scope="module")
def flake():
    return spd.build_sphereflake_scene(3, device="cpu")


@pytest.mark.parametrize("size_factor", [2, 3])
def test_the_flake_fits_the_mesh_megakernel(size_factor):
    s = spd.build_sphereflake_scene(size_factor, device="cpu")
    assert s.fastinfo.mesh_ok and not s.fastinfo.ok
    assert tmm.fits(s) and s.mesh is not None
    assert s.prims.count == (9 ** (size_factor + 1) - 1) // 8 + 2


def test_a_cloud_without_triangles_fits_the_mesh_megakernel():
    s = _cloud()
    assert s.prims.count == 300 and s.fastinfo.mesh_ok and tmm.fits(s)
    assert s.prims.pinfo.types == (SPHERE,)


def test_the_metal_mesh_stays_off_the_mesh_megakernel():
    s = tmeshes.build_mesh_scene(n_lat=8, n_lon=8, device="cpu", mesh_material="metal")
    assert not s.fastinfo.mesh_ok and not tmm.fits(s)


def _rays(scene_name, seed, width=W, height=H):
    camera = (spd.sphereflake_camera(width, height, device="cpu") if scene_name == "flake"
              else _cloud_camera(width, height))
    st = trender.RenderSettings(width=width, height=height, spp=1, max_depth=4, seed=seed)
    _, o, d, pix, smp = trender.band_rays(camera, st, 0, height, 0)
    return o, d, pix, smp


@pytest.mark.parametrize("scene_name", ["flake", "cloud"])
def test_li_sends_sphere_scenes_to_the_mesh_megakernel(flake, scene_name):
    """Like tests/test_torch_mesh.py's mesh case: ``li`` is the mesh
    megakernel's plain version on CPU tensors (no launch), counted under
    ``bvh_megakernel``; ``early_exit`` runs the chain, counted ``chain``."""
    scene = flake if scene_name == "flake" else _cloud()
    args = (scene, *_rays(scene_name, 5, 16, 16), 5)
    cfg = tint.PathConfig(max_depth=3)
    before = dict(_build.LAUNCHES)
    trace.enable()
    try:
        with trace.request() as req:
            got = tint.li(*args, cfg)
            early = tint.PathConfig(max_depth=3, early_exit=True)
            chain = tint.li(*args, early)
    finally:
        trace.disable()
    assert req.counter("li.route") == {"bvh_megakernel": 1, "chain": 1}
    assert torch.equal(got, tmk.path_li_plain(*args, cfg, accel="bvh"))
    assert torch.equal(tint.li_fused(tmm.MESH, *args, cfg), got)
    assert torch.equal(chain, tint._li_wavefront(*args, early))
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("scene_name", ["flake", "cloud"])
def test_the_plain_twin_agrees_with_the_chain(flake, scene_name):
    """``path_li_plain(accel="bvh")`` against ``_li_wavefront`` on the BVH
    walk, at tests/test_torch_mesh.py's bar (> 98% of lanes within 1e-3,
    mean within 1e-2)."""
    scene = flake if scene_name == "flake" else _cloud()
    o, d, pix, smp = _rays(scene_name, 9, 48, 48)
    cfg = tint.PathConfig(max_depth=5)
    got = tmk.path_li_plain(scene, o, d, pix, smp, 9, cfg, accel="bvh").numpy()
    want = tint._li_wavefront(scene, o, d, pix, smp, 9, cfg).numpy()
    assert np.all(np.isfinite(got))
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.98, f"lane agreement {frac:.4f}"
    assert mean_rel < 1e-2, mean_rel
    assert want.mean() > 1e-2


# ---------------------------------------------------------------------------
# Against the benchmark's reference
# ---------------------------------------------------------------------------


def _reference():
    """The benchmark's ``configs/sphereflake.py`` and the frozen reference's
    render and camera modules, loaded from their paths."""
    if str(PORTBENCH) not in sys.path:
        sys.path.insert(0, str(PORTBENCH))
    from reference.models import camera as ref_cam
    from reference.models import render as ref_render
    from reference.models.scene import SceneBuilder as RefBuilder
    from reference.ops import geom as ref_geom
    from reference.ops import mesh_megakernel as ref_mesh

    spec = importlib.util.spec_from_file_location(
        "portbench_config_sphereflake", PORTBENCH / "configs" / "sphereflake.py")
    cfg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cfg)
    return cfg, ref_cam, ref_render, RefBuilder, ref_geom, ref_mesh


def _settings(seed):
    return dict(width=W, height=H, spp=2, samples_per_pass=2, max_depth=10,
                rr_threshold=1.0, integrator="path", seed=seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scene_name", ["flake", "cloud"])
def test_render_matches_the_benchmark_reference(scene_name, seed):
    cfg, ref_cam, ref_render, RefBuilder, ref_geom, ref_mesh = _reference()
    if scene_name == "flake":
        ref_scene = cfg.build_scene(size_factor=2, device="cpu")
        ref_camera = cfg.build_camera(W, H, device="cpu")
        scene = spd.build_sphereflake_scene(2, device="cpu")
        camera = spd.sphereflake_camera(W, H, device="cpu")
    else:
        # the frozen gate asks for triangles: marked as configs/sphereflake.py
        # marks the flake
        ref_scene = sphere_cloud(RefBuilder, ref_geom).build(device="cpu")
        ref_scene = ref_scene._replace(fastinfo=dataclasses.replace(ref_scene.fastinfo,
                                                                    mesh_ok=True))
        ref_scene = ref_scene._replace(mesh=ref_mesh.mesh_tables(ref_scene))
        ref_camera = _cloud_camera(W, H, ref_cam, ref_geom)
        scene, camera = _cloud(), _cloud_camera(W, H)
    assert ref_mesh.fits(ref_scene)
    got = trender.render(scene, camera, trender.RenderSettings(**_settings(seed)),
                         device="cpu").numpy()
    ref = ref_render.render(ref_scene, ref_camera, ref_render.RenderSettings(**_settings(seed)),
                            device="cpu").numpy()
    assert np.all(np.isfinite(got)) and got.mean() > 1e-2
    assert np.abs(got - ref).max() < 1e-5
