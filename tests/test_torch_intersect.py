"""The port's plain prim_test closest hit against ops.intersect.intersect_brute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import camera_rays, carry
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import intersect as jisect
from gopbrt_tpu_torch.ops import brute_intersect


def _agreement(scene_j, o, d):
    """Fraction of rays where hit, t (1e-3 rel + 1e-4) and prim agree — the
    brute-intersect bar of benchmarks/tpu_smoke.py:83."""
    t_max = np.full((o.shape[0],), 1e30, np.float32)
    hit_j, t_j, idx_j = (np.asarray(x) for x in jisect.intersect_brute(
        scene_j.prims, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    hit_t, t_t, idx_t = (x.numpy() for x in brute_intersect.intersect_brute(
        carry(scene_j).brute, torch.tensor(o), torch.tensor(d), torch.tensor(t_max)))
    same = (hit_t == hit_j) & (np.abs(t_t - t_j) < 1e-3 * np.abs(t_j) + 1e-4)
    same &= ~hit_j | (idx_t == idx_j)
    return float(np.mean(same)), float(np.mean(hit_j))


def test_demo_camera_rays_closest_hit():
    scene = jdemo.build_demo_scene(accelerator="none")
    o, d, _, _ = camera_rays(jdemo.build_demo_camera(64, 36), 64, 36, 1, 3)
    agree, hit_rate = _agreement(scene, np.asarray(o), np.asarray(d))
    assert agree > 0.999, agree
    assert hit_rate > 0.3


def _clipped_scene():
    """Partial spheres (z range, phi < pi, phi > pi), annulus and wedge
    disks, and triangles: every clip branch of prim_test."""
    b = JaxBuilder()
    m = b.matte()
    b.sphere(np.asarray(jgeom.translate([0.0, 0.0, 0.0])), 1.0, m, z_min=-0.5,
             z_max=0.7, phi_max_deg=270.0)
    b.sphere(np.asarray(jgeom.translate([2.5, 0.0, 0.0])), 0.8, m, phi_max_deg=120.0)
    b.sphere(np.asarray(jgeom.translate([-2.5, 0.5, 0.0])), 0.9, m)
    b.disk(np.asarray(jgeom.translate([0.0, -1.5, 0.0]) @ jgeom.rotate_x(-90.0)), 2.0,
           m, inner_radius=0.6, phi_max_deg=200.0)
    b.disk(np.asarray(jgeom.translate([0.0, 0.0, -2.0])), 3.0, m, phi_max_deg=90.0)
    b.triangle((-1.0, 1.5, -1.0), (1.0, 1.5, -1.0), (0.0, 1.5, 1.0), m)
    b.triangle((-3.0, -1.0, 1.0), (-1.0, -1.0, 1.0), (-2.0, 1.0, 1.0), m)
    b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
    return b.build(accelerator="none")


@pytest.mark.parametrize("seed", [0, 1])
def test_clipped_shapes_and_triangles_closest_hit(seed):
    scene = _clipped_scene()
    r = np.random.default_rng(seed)
    n = 4000
    o = (r.normal(size=(n, 3)) * 4.0).astype(np.float32)
    target = (r.random((n, 3)) * [6.0, 4.0, 4.0] - [3.0, 2.0, 2.0]).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    agree, hit_rate = _agreement(scene, o, d)
    assert agree > 0.999, agree
    assert hit_rate > 0.2


@pytest.mark.parametrize("seed", [0, 1])
def test_first_hit_occludes_where_the_closest_hit_does(seed):
    """The any-hit loop of the shadow ray finds a row exactly where the
    closest hit under t_limit exists, never past it, and tests fewer rows."""
    table = carry(_clipped_scene()).brute
    rows = table.rows
    r = np.random.default_rng(seed)
    n = 4000
    o = torch.tensor((r.normal(size=(n, 3)) * 4.0).astype(np.float32))
    d = torch.nn.functional.normalize(-o + torch.tensor(r.normal(size=(n, 3)),
                                                        dtype=torch.float32), dim=1)
    t_lim = torch.tensor(r.random(n).astype(np.float32) * 8.0)
    active = torch.tensor(r.random(n) < 0.7)
    args = (table, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_lim)
    closest_tally, first_tally = {}, {}
    _, closest = brute_intersect.closest_hit(*args, tally=closest_tally, active=active)
    first = brute_intersect.first_hit(*args, tally=first_tally, active=active)
    assert torch.equal(first >= 0, closest >= 0)
    assert bool((first <= closest).all())
    assert 0.1 < float((first >= 0).float().mean()) < 0.9
    n_sph = sum(1 for row in rows if row[0] == 0)
    n_dsk = sum(1 for row in rows if row[0] == 1)
    assert closest_tally["sphere_tests"] == n_sph * int(active.sum())
    assert closest_tally["disk_tests"] == n_dsk * int(active.sum())
    assert 0 < closest_tally["sphere_roots"] < closest_tally["sphere_tests"]
    for key in closest_tally:
        assert first_tally[key] <= closest_tally[key]
    assert first_tally["sphere_tests"] < closest_tally["sphere_tests"]
