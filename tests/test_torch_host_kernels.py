"""The CUDA kernels' own code on the CPU, against the plain versions.

``tests/host_kernels.cpp`` includes csrc/megakernel.cu and
csrc/mesh_megakernel.cu as plain C++ (the GOPBRT_HD path of
csrc/prim_test.cuh: no nvcc, no card) and drives the device functions:
the walk ray by ray, and the bounce skeleton the way its persistent
kernels do, a few lanes in flight, paths taken in a shuffled order, a
lane refilled the moment its path ends.  It is compiled with the host
g++ into ``build/gopbrt_tpu_torch/host_kernels/<hash>/`` at first use;
without a C++ compiler the tests skip.

- The walk of csrc/bvh.cuh over ``bvh_table``'s nodes (both child boxes in
  the parent) against the plain walk ``ops/bvh.walk`` on the 16x16 mesh
  scene: t and record row per lane of ``bvh_walk`` (the kernels' walk),
  and each lane's nodes, interior nodes and pops, walked node by node,
  against the plain walk's tally (the events the kernels' bound counts);
  with triangles in the vertex form (the walk kernels) and in the plane
  form (the mesh megakernel).
- plane_test of csrc/prim_test.cuh against the plain ``ops/bvh.plane_test``.
- The brute intersection kernels' lane (csrc/intersect.cu: the dead-lane
  test, then the sweep of either compile-time instance) against
  ``intersect_brute`` / ``intersect_p_brute``, bit for bit: on the inputs
  of every launch ``li_direct`` makes on config 1 at 64x36 (dead lanes
  included), on the partial-shape and triangle cases of
  tests/test_torch_brute_intersect.py, and on a sphere shrunk to 0.01 in
  world space, whose shadow rays hit it below t = 1e-4 and so are not dead.
- path_init / path_step / path_finish of csrc/bounce.cuh, driven as
  run_paths drives them (path_step is run_paths' own step: a trace, then
  the rest of the bounce or the shadow ray's contribution), against ``path_li_plain`` per lane on
  the demo and the lobe scenes (brute instance) and on the mesh, the SPD
  sphereflake at size factor 3 and a random cloud of 300 spheres without
  a triangle (BVH instance: sphere leaves) at 16x16, at the bars of
  tests/test_megakernel.py; and bit for bit against themselves in another
  interleaving, so the order of refills cannot change a lane's answer.
- The camera-ray kernel's lane (csrc/camera_rays.cu) against
  ``render.band_rays_plain`` on bands of at most 64x16 lanes: stratified
  (1, 8 and 9 samples a pixel), random and Halton samplers, the demo's
  and the mesh's cameras, an orthographic and a thin-lens camera, a band
  whose last rows lie past the image, a crop window's columns; pixel,
  sample and jitter bit for bit, o and d within 2e-7.
- The splat kernel's pixel function (csrc/splat_rows.cu) on every film
  pixel a band reaches against ``film.add_samples_rows_plain``, on a 37
  pixel wide film (not a multiple of the kernel's 32-wide tiles) that holds
  data before the fold: the box filter at radius 0.5, 1 and 2 bit for bit,
  triangle, Gaussian, Mitchell and Lanczos within 1e-6; bands at the first
  row, inside, and past the last row with a NaN in L there.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (CLOUD_LOOK_AT, as_torch, camera_rays, carry, carry_prims,
                           lane_agreement, rough_glass_camera, rough_glass_scene, sphere_cloud)
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import gallery as jgallery
from gopbrt_tpu.models import meshes as jmeshes
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import intersect as jisect
from gopbrt_tpu_torch._build import BUILD_ROOT, CSRC
from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import film as tfilm
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import gallery as tgallery
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models import meshes as tmeshes
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.models import spd
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import brute_intersect as tbi
from gopbrt_tpu_torch.ops import bvh as tbvh
from gopbrt_tpu_torch.ops import camera_rays as tcr
from gopbrt_tpu_torch.ops import filters as tfilters
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.ops import megakernel as tmk
from tests.test_bvh import random_rays
from tests.test_intersect import make_prims, sphere_entry

HARNESS = Path(__file__).resolve().parent / "host_kernels.cpp"
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
W = H = 16
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# the path entries' arguments after their tables: n_lights, seed, func_int,
# world_radius, cone_w0, cone_sp, max_depth, rr_start, rr_threshold,
# flags, o, d, pixel, sample, L, n, lanes, order_seed
_PATH_ARGS = [_I, _U, _F, _F, _F, _F, _I, _I, _F, _I, _P, _P, _P, _P, _P, _I, _I, _U]
# host_camera_rays: r2c, c2w, width, row0, col0, cols, n, seed, sample,
# sampler, nx, ny, kind, lens_radius, focal_distance, jitter, o, d, pixel,
# sample_out
_CAMERA_ARGS = [_P, _P, _I, _I, _I, _I, _I, _U, ctypes.c_longlong, _I, _I, _I, _I, _F, _F] + [_P] * 5


@functools.lru_cache(maxsize=None)
def _compile() -> str:
    sources = [HARNESS, *sorted(CSRC.iterdir())]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / "host_kernels" / h.hexdigest()[:16]
    lib = out_dir / "libhost_kernels.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-I", str(CSRC),
                        str(HARNESS), "-o", str(tmp)], check=True, capture_output=True,
                       text=True)
        os.replace(tmp, lib)
    return str(lib)


@pytest.fixture(scope="module")
def lib():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on this machine for the host harness")
    lib = ctypes.CDLL(_compile())
    lib.host_bvh_walk.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
    lib.host_intersect.argtypes = [_P, _I, _F, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                                   _P]
    lib.host_plane_test.argtypes = [_P, _P, _P, _P, _I, _P]
    lib.host_paths_brute.argtypes = [_P, _I] + _PATH_ARGS
    lib.host_paths_mesh.argtypes = [_P, _P, _P, _I] + _PATH_ARGS
    lib.host_camera_rays.argtypes = _CAMERA_ARGS
    lib.host_splat_rows.argtypes = [_P] * 4 + [_I] * 5 + [ctypes.c_double] * 4
    lib.host_splat_rows.restype = _I
    for fn in (lib.host_bvh_walk, lib.host_intersect, lib.host_plane_test,
               lib.host_paths_brute, lib.host_paths_mesh, lib.host_camera_rays):
        fn.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _np(t: torch.Tensor, dtype) -> np.ndarray:
    return np.ascontiguousarray(t.numpy(), dtype)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    js = jmeshes.build_mesh_scene(n_lat=16, n_lon=16)
    ts = carry(js)
    o, d, pix, smp = as_torch(*camera_rays(jmeshes.mesh_camera(W, H), W, H, 1, 3))
    return js, ts, (o, d, pix, smp)


def _host_walk(lib, table, o, d, t_max, any_hit, plane=False):
    """The harness walk -> (t, slot, nodes and leaves, interior nodes, pops)
    per ray; plane: triangles in the plane form."""
    n = o.shape[0]
    nodes, recs = _np(table.nodes, np.float32), _np(table.records, np.float32)
    o_, d_, tm = _np(o, np.float32), _np(d, np.float32), _np(t_max, np.float32)
    t = np.empty(n, np.float32)
    slot, steps, inner, pops = (np.empty(n, np.int32) for _ in range(4))
    lib.host_bvh_walk(_ptr(nodes), _ptr(recs), table.flags, _ptr(o_), _ptr(d_), _ptr(tm), n,
                      int(any_hit), int(plane), _ptr(t), _ptr(slot), _ptr(steps), _ptr(inner),
                      _ptr(pops))
    return t, slot, steps, inner, pops


def _mesh_rays(ts, o, d):
    """The camera rays, then shadow rays from their hits toward the point
    light; every fourth shadow ray dead (t_max 1e-4)."""
    big = torch.full((o.shape[0],), 1e30)
    t, slot = tbvh.walk(ts.bvh_tables, o, d, big)
    hit = slot >= 0
    p = o + d * (torch.where(hit, t, 1.0) - 1e-3)[:, None]
    to = ts.lights.p[0][None, :] - p
    dist = to.norm(dim=-1)
    t_sh = torch.where(hit, dist * (1.0 - 1e-4), 1e-4)
    t_sh[::4] = 1e-4
    return [(o, d, big), (p.contiguous(), (to / dist[:, None]).contiguous(), t_sh)]


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_matches_the_plain_walk_per_lane(lib, mesh, any_hit):
    """Per lane the kernels' walk finds the plain walk's t and record;
    walked node by node it takes the plain walk's steps, and its
    interior nodes and pops are the tally's bvh_nodes and bvh_pops, its
    roots bvh_roots."""
    _, ts, (o, d, _, _) = mesh
    table = ts.bvh_tables
    for k, (ro, rd, t_max) in enumerate(_mesh_rays(ts, o, d)):
        tally, steps_p = {}, torch.zeros((ro.shape[0],), dtype=torch.int64)
        t_p, slot_p = tbvh.walk(table, ro, rd, t_max, any_hit=any_hit, tally=tally,
                                steps=steps_p)
        t, slot, steps, inner, pops = _host_walk(lib, table, ro, rd, t_max, any_hit)
        if any_hit:  # the walk stops at the end of the leaf of its first hit
            np.testing.assert_array_equal(slot >= 0, slot_p.numpy() >= 0)
        else:
            np.testing.assert_array_equal(slot, slot_p.numpy())
            np.testing.assert_allclose(t, t_p.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(steps, steps_p.numpy())
        assert int(inner.sum()) == tally["bvh_nodes"]
        assert int(pops.sum()) == tally["bvh_pops"]
        walked = t_max > tbvh.DEAD_T_MAX if any_hit else torch.ones_like(t_max, dtype=bool)
        assert int(walked.sum()) == tally["bvh_roots"]
        assert int(pops.sum()) > 0 and (k == 1 or (slot >= 0).mean() > 0.2)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plane_walk_matches_the_plain_walk_per_lane(lib, mesh, any_hit):
    """The mesh megakernel's walk (triangles in the plane form) against the
    plain walk with ``plane=True``: t and record per lane, and the same
    steps, interior nodes, pops and roots; its triangle tests are plane
    tests."""
    _, ts, (o, d, _, _) = mesh
    table = ts.bvh_tables
    for ro, rd, t_max in _mesh_rays(ts, o, d):
        tally, steps_p = {}, torch.zeros((ro.shape[0],), dtype=torch.int64)
        t_p, slot_p = tbvh.walk(table, ro, rd, t_max, any_hit=any_hit, tally=tally,
                                steps=steps_p, plane=True)
        t, slot, steps, inner, pops = _host_walk(lib, table, ro, rd, t_max, any_hit, True)
        if any_hit:
            np.testing.assert_array_equal(slot >= 0, slot_p.numpy() >= 0)
        else:
            np.testing.assert_array_equal(slot, slot_p.numpy())
            np.testing.assert_allclose(t, t_p.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(steps, steps_p.numpy())
        assert int(inner.sum()) == tally["bvh_nodes"]
        assert int(pops.sum()) == tally["bvh_pops"]
        assert tally["plane_tests"] > 0 and "triangle_tests" not in tally


def test_plane_test_matches_the_plain_plane_test(lib, mesh):
    """plane_test of csrc/prim_test.cuh against ops/bvh.plane_test on each
    triangle of the mesh against rays aimed at it and past its edges."""
    _, ts, _ = mesh
    rec = ts.bvh_tables.records
    tri = torch.nonzero(rec[:, tbvh.REC_TYPE] == 2).flatten()
    r = np.random.default_rng(4)
    pick = tri[torch.tensor(r.integers(0, tri.numel(), 4096))]
    v = rec[pick, 0:9].reshape(-1, 3, 3)
    bary = torch.tensor(r.uniform(-0.1, 0.7, (4096, 2)).astype(np.float32))
    target = v[:, 0] + bary[:, :1] * (v[:, 1] - v[:, 0]) + bary[:, 1:] * (v[:, 2] - v[:, 0])
    o = torch.tensor(r.normal(0.0, 5.0, (4096, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(target - o, dim=-1)
    t_limit = torch.full((4096,), 1e30)
    planes = rec[pick, tbvh.REC_W2O:tbvh.REC_W2O + 12].contiguous()
    want = tbvh.plane_test(planes, o, d, t_limit).numpy()
    got = np.empty(4096, np.float32)
    lib.host_plane_test(_ptr(_np(planes, np.float32)), _ptr(_np(o, np.float32)),
                        _ptr(_np(d, np.float32)), _ptr(_np(t_limit, np.float32)), 4096,
                        _ptr(got))
    np.testing.assert_array_equal(got < tbvh.BIG, want < tbvh.BIG)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert 0.3 < (want < tbvh.BIG).mean() < 0.9


# ---------------------------------------------------------------------------
# The brute intersection kernels
# ---------------------------------------------------------------------------


def _host_intersect(lib, table, o, d, t_max, any_hit, instance):
    """The kernels' lane on the host -> (hit, t, prim) or occluded, and the
    lanes taken as dead."""
    n = o.shape[0]
    rec = _np(table.rec, np.float32)
    o_, d_, tm = _np(o, np.float32), _np(d, np.float32), _np(t_max, np.float32)
    hit, occ, dead = (np.zeros(n, np.bool_) for _ in range(3))
    t, idx = np.empty(n, np.float32), np.empty(n, np.int32)
    lib.host_intersect(_ptr(rec), table.count, float(table.dead_d2), instance, table.flags,
                       _ptr(o_), _ptr(d_), _ptr(tm), n, int(any_hit), _ptr(hit),
                       _ptr(t), _ptr(idx), _ptr(occ), _ptr(dead))
    return (occ if any_hit else (hit, t, idx)), dead


def _check_intersect(lib, table, o, d, t_max) -> int:
    """Both kernels' lanes, in every instance the table allows, against the
    plain versions ->
    the number of dead lanes.  Hits, prims, occlusion and the dead lanes'
    answers are equal bit for bit, and so is t but where a sphere's root
    went through torch's CPU sqrt, which is not correctly rounded (one ulp
    off on 0.7% of uniform f32 inputs; sqrtf is): there t is within 1e-6
    relative, or 1e-8 where the roots cancel."""
    hit_p, t_p, idx_p = (x.numpy() for x in tbi.intersect_brute(table, o, d, t_max))
    occ_p = tbi.intersect_p_brute(table, o, d, t_max).numpy()
    for instance in {tbi.INSTANCE_GENERAL, table.instance}:
        (hit, t, idx), dead = _host_intersect(lib, table, o, d, t_max, False, instance)
        np.testing.assert_array_equal(hit, hit_p)
        np.testing.assert_array_equal(idx, idx_p)
        np.testing.assert_array_equal(t[dead], t_p[dead])
        np.testing.assert_allclose(t, t_p, rtol=1e-6, atol=1e-8)
        assert (t == t_p).mean() >= 0.99
        occ, dead_any = _host_intersect(lib, table, o, d, t_max, True, instance)
        np.testing.assert_array_equal(occ, occ_p)
        np.testing.assert_array_equal(dead_any, dead)
    assert not (hit_p[dead].any() or occ_p[dead].any())
    return int(dead.sum())


def test_intersect_lane_on_li_direct_launches(lib, monkeypatch):
    """Every launch li_direct makes over config 1 at 64x36 (camera rays,
    shadow rays, the MIS segments, the final pass): the fast instance
    (all spheres and disks full) and the general one give the plain
    answers, and the launches of dead lanes skip them all."""
    scene, camera, settings = tgallery.config1(64, 36, device="cpu")
    settings = settings._replace(spp=1, samples_per_pass=1)
    _, o, d, pix, smp = trender.band_rays(camera, settings, 0, 36, 0)
    calls = []
    for name in ("intersect_brute_fused", "intersect_p_brute_fused"):
        fn = getattr(tbi, name)
        monkeypatch.setattr(tbi, name, lambda *a, fn=fn: calls.append(a) or fn(*a))
    tint.li_direct(scene, o, d, pix, smp, settings.seed, max_depth=settings.max_depth)
    assert len(calls) == 7
    table = calls[0][0]
    assert table is scene.brute and table.instance == tbi.INSTANCE_FULL_SPH_DISK
    dead = [_check_intersect(lib, *call) for call in calls]
    n = o.shape[0]
    assert dead[0] == 0 and dead.count(n) >= 3, dead  # 4 of 7 on the demo's matte


_EYE = np.eye(4, dtype=np.float32)
# (prims, ray spread, whether the lanes with t_max 1e-4 are dead): spheres
# of r / ||M|| <= 1 leave unit rays live (dead_d2 < 1); a table without
# spheres has no bound
_CLIPPED = {
    "partial_r1": ([(jisect.SPHERE, _EYE, [1.0, 0.0, 1.0, 2 * np.pi], 0),
                    (jisect.SPHERE, _EYE, [1.0, -1.0, 1.0, np.pi / 2], 0),
                    (jisect.DISK, _EYE, [0.0, 2.0, 0.5, 1.5 * np.pi], 0)], 5.0, False),
    "partial_r2": ([(jisect.SPHERE, _EYE, [2.0, 0.0, 2.0, 2 * np.pi], 0),
                    (jisect.SPHERE, _EYE, [2.0, -2.0, 2.0, np.pi / 2], 0),
                    (jisect.DISK, _EYE, [0.0, 2.0, 0.5, 1.5 * np.pi], 0)], 5.0, True),
    "mixed": ([sphere_entry([0.0, 0.0, -2.0], 0.5),
               (jisect.DISK, _EYE, [-5.0, 10.0, 0.0, 2 * np.pi], 1),
               (jisect.TRIANGLE, _EYE, [-1, -1, -8, 1, -1, -8, 0, 1, -8], 2)], 8.0, False),
    "disk_triangle": ([(jisect.DISK, _EYE, [-5.0, 10.0, 0.0, 2 * np.pi], 1),
                       (jisect.TRIANGLE, _EYE, [-1, -1, -8, 1, -1, -8, 0, 1, -8], 2)],
                      8.0, True),
}


@pytest.mark.parametrize("case", list(_CLIPPED))
def test_intersect_lane_on_clipped_shapes_and_triangles(lib, case):
    """The general instance on partial spheres, annulus and wedge disks and
    a triangle, a third of the lanes with t_max 1e-4: dead exactly where
    the table's bound allows."""
    entries, spread, dead = _CLIPPED[case]
    table = tbi.brute_table(carry_prims(make_prims(entries)))
    assert table.instance == tbi.INSTANCE_GENERAL
    o, d = (torch.tensor(np.asarray(a)) for a in random_rays(2048, seed=9, spread=spread))
    t_max = torch.full((2048,), 1e30)
    t_max[::3] = tbi.DEAD_T_MAX
    t_max[1::3] = 6.0
    assert _check_intersect(lib, table, o, d, t_max) == (683 if dead else 0)
    assert bool(tbi.intersect_brute(table, o, d, t_max)[0].any())


def test_intersect_lane_keeps_lanes_a_small_sphere_can_hit(lib):
    """A sphere of radius 1 scaled to 0.01 in world space: rays from just
    outside it hit it below t = 1e-4, so a lane with t_max 1e-4 is not dead
    there (dead_d2 < 1), and the lanes give the plain hits."""
    o2w = np.asarray(jgeom.matmul(jgeom.translate([3.0, -2.0, 1.0]),
                                  jgeom.scale(0.01, 0.01, 0.01)))
    table = tbi.brute_table(carry_prims(make_prims(
        [(jisect.SPHERE, o2w, [1.0, -1.0, 1.0, 2 * np.pi], 0)])))
    assert float(table.dead_d2) < 1e-3
    r = np.random.default_rng(5)
    n = 1024
    out = r.normal(size=(n, 3))
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    center = np.array([3.0, -2.0, 1.0])
    o = center + out * r.uniform(0.01002, 0.0101, (n, 1))
    d = -out + r.normal(scale=0.05, size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)
    t_max = torch.full((n,), tbi.DEAD_T_MAX)
    assert _check_intersect(lib, table, o, d, t_max) == 0
    hit = tbi.intersect_brute(table, o, d, t_max)[0]
    assert 0.2 < float(hit.float().mean()) < 1.0


# ---------------------------------------------------------------------------
# The bounce skeleton
# ---------------------------------------------------------------------------

SEED = 7
# name -> (depth, lane bar, mean bar): tests/test_megakernel.py's bars
SCENES = {
    "demo": (10, 0.99, 2e-3),
    "config2": (5, 0.99, 5e-3),
    "config4": (8, 0.98, 1e-2),
    "rough_glass": (5, 0.98, 1e-2),
    "mesh": (5, 0.98, 1e-2),
    "sphereflake": (10, 0.98, 1e-2),
    "sphere_cloud": (5, 0.98, 1e-2),
}
# the scenes of the BVH instance
BVH_SCENES = ("mesh", "sphereflake", "sphere_cloud")


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(port scene, rays, cone) of a scene at W x H."""
    if name in ("sphereflake", "sphere_cloud"):
        # the port's own scenes: the JAX package has neither
        if name == "sphereflake":
            ts = spd.build_sphereflake_scene(3, device="cpu")
            camera = spd.sphereflake_camera(W, H, device="cpu")
        else:
            ts = sphere_cloud(SceneBuilder, tgeom).build(device="cpu")
            camera = tcam.perspective_camera(tgeom.look_at(*CLOUD_LOOK_AT), W, H,
                                             fov_deg=45.0, device="cpu")
        st = trender.RenderSettings(width=W, height=H, spp=1, seed=SEED)
        _, o, d, pixel, sample = trender.band_rays(camera, st, 0, H, 0)
        return ts, (o, d, pixel, sample), (0.0, 0.004)
    if name == "demo":
        js, camera = jdemo.build_demo_scene(accelerator="none"), jdemo.build_demo_camera(W, H)
    elif name == "rough_glass":
        js = rough_glass_scene(JaxBuilder, jgeom).build(accelerator="none")
        camera = rough_glass_camera(W, H)
    elif name == "mesh":
        js, camera = jmeshes.build_mesh_scene(n_lat=16, n_lon=16), jmeshes.mesh_camera(W, H)
    else:
        js, camera, _ = getattr(jgallery, name)(W, H)
    ts = carry(js)
    cone = (0.0, 0.004) if name in ("demo", "mesh") else None
    return ts, as_torch(*camera_rays(camera, W, H, 1, SEED)), cone


def _host_paths(lib, name, lanes, order_seed):
    ts, (o, d, pixel, sample), cone = _scene(name)
    cfg = tint.PathConfig(max_depth=SCENES[name][0])
    n = o.shape[0]
    o_, d_ = _np(o, np.float32), _np(d, np.float32)
    pix, smp = _np(tmk.as_i32_bits(pixel), np.int32), _np(tmk.as_i32_bits(sample), np.int32)
    L = np.full((n, 3), np.nan, np.float32)
    w0, sp = cone if cone is not None else (0.0, 0.0)
    tail = (ts.lights.count, SEED, float(ts.light_func_int), float(ts.world_radius), w0, sp,
            cfg.max_depth, cfg.rr_start_depth, cfg.rr_threshold,
            tmk.kernel_flags(ts, cone is not None), _ptr(o_), _ptr(d_), _ptr(pix), _ptr(smp),
            _ptr(L), n, lanes, order_seed)
    if name in BVH_SCENES:
        tables = _np(ts.mesh.tables, np.float32)
        bt = ts.bvh_tables
        nodes, recs = _np(bt.nodes, np.float32), _np(bt.records, np.float32)
        lib.host_paths_mesh(_ptr(tables), _ptr(nodes), _ptr(recs), bt.flags, *tail)
    else:
        tables = _np(ts.kernel.tables, np.float32)
        lib.host_paths_brute(_ptr(tables), ts.prims.count, *tail)
    return L


@pytest.mark.parametrize("name", list(SCENES))
def test_bounce_skeleton_matches_path_li_plain(lib, name):
    """init / bounce / finish over lanes refilled in a shuffled order,
    per lane against path_li_plain (the brute instance on the demo and the
    lobe scenes, the BVH instance on the mesh and the sphere scenes)."""
    depth, lane_bar, mean_bar = SCENES[name]
    ts, rays, cone = _scene(name)
    ref = tmk.path_li_plain(ts, *rays, SEED, tint.PathConfig(max_depth=depth), cone=cone,
                            accel="bvh" if name in BVH_SCENES else "brute").numpy()
    got = _host_paths(lib, name, 7, 3)
    assert np.all(np.isfinite(got))
    frac, mean_rel = lane_agreement(got, ref)
    assert frac > lane_bar, f"lane agreement {frac:.4f}"
    assert mean_rel < mean_bar, mean_rel
    assert ref.mean() > 1e-3  # the image is not black


@pytest.mark.parametrize("name", ["demo", "rough_glass", "mesh", "sphereflake"])
def test_bounce_skeleton_is_the_same_in_any_order(lib, name):
    """Paths on one lane, or refilled on many lanes, in three shuffled
    orders: the same radiance, bit for bit."""
    one = _host_paths(lib, name, 1, 0)
    for lanes, seed in ((5, 1), (32, 2)):
        np.testing.assert_array_equal(_host_paths(lib, name, lanes, seed), one)


# ---------------------------------------------------------------------------
# The camera rays
# ---------------------------------------------------------------------------

CAM_W, CAM_H = 64, 36


def _camera(name):
    if name == "demo":
        return tdemo.build_demo_camera(CAM_W, CAM_H, device="cpu")
    if name == "mesh10k":
        return tmeshes.mesh_camera(CAM_W, CAM_H, device="cpu")
    frame = tgeom.look_at([3.0, 4.0, 5.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0])
    if name == "orthographic":
        return tcam.orthographic_camera(frame, CAM_W, CAM_H, device="cpu")
    return tcam.perspective_camera(frame, CAM_W, CAM_H, fov_deg=45.0, lens_radius=0.1,
                                   focal_distance=4.0, device="cpu")  # thin lens


# name -> (camera, sampler, spp, first row, sample index, seed, columns);
# 16 rows a band, the thin lens's last band running 12 rows past the image,
# the crop windows' of their columns only
CAMERA_CASES = {
    "demo-stratified-spp1": ("demo", "stratified", 1, 8, 0, 2**31 + 11, None),
    "demo-stratified-spp8": ("demo", "stratified", 8, 0, 5, 7, None),
    "demo-random": ("demo", "random", 1, 4, 3, 2**31 - 1, None),
    "demo-halton": ("demo", "halton", 16, 20, 12345, 2**33 + 5, None),
    "mesh10k-stratified-spp8": ("mesh10k", "stratified", 8, 12, 13, 2**31 + 99, None),
    "mesh10k-halton": ("mesh10k", "halton", 4, 0, 2**32 - 5, 42, None),  # 21 base-3 digits
    "orthographic-stratified-spp1": ("orthographic", "stratified", 1, 16, 0, 3, None),
    "thin-lens-stratified-spp9": ("thin_lens", "stratified", 9, 2, 7, 2**31 + 5, None),
    "thin-lens-random-past-the-image": ("thin_lens", "random", 1, 32, 1, 17, None),
    "demo-crop-window": ("demo", "stratified", 4, 9, 2, 2**31 + 7, (16, 49)),
    "thin-lens-crop-window-to-the-edge": ("thin_lens", "halton", 4, 20, 3, 11, (40, 64)),
}


@pytest.mark.parametrize("case", list(CAMERA_CASES))
def test_camera_ray_lane_matches_band_rays_plain(lib, case):
    """The kernel's lane on every lane of a band against band_rays_plain:
    pixel, sample and the jitter ((px + u) - px) bit for bit; o and d
    within 2e-7 (o relative to the largest of its components and 1, its
    scale where it is a point of the camera away from the origin), d a unit
    vector.  o and d differ where the plain version's matrix products
    round in BLAS's order."""
    cam_name, sampler, spp, row0, sample_idx, seed, cols = CAMERA_CASES[case]
    camera = _camera(cam_name)
    settings = trender.RenderSettings(width=CAM_W, height=CAM_H, spp=spp, sampler=sampler,
                                      seed=seed)
    x0, x1 = cols or (0, CAM_W)
    n_rows = 16
    n = (x1 - x0) * n_rows
    want = [t.numpy() for t in trender.band_rays_plain(camera, settings, row0, n_rows,
                                                       sample_idx, cols)]
    if cols is not None:  # the window's lanes are those columns of the band's
        band = trender.band_rays_plain(camera, settings, row0, n_rows, sample_idx)
        for w, b in zip(want, band):
            np.testing.assert_array_equal(
                w, b.numpy().reshape(n_rows, CAM_W, -1)[:, x0:x1].reshape(w.shape))
    mode, nx, ny = trender.sampler_grid(settings)
    jitter, o, d = (np.full((n, k), np.nan, np.float32) for k in (2, 3, 3))
    pixel, sample = np.zeros(n, np.int64), np.zeros(n, np.int64)
    lib.host_camera_rays(_ptr(_np(camera.raster_to_camera, np.float32)),
                         _ptr(_np(camera.camera_to_world, np.float32)), CAM_W, row0, x0,
                         x1 - x0, n,
                         seed & 0xFFFFFFFF, sample_idx, tcr.SAMPLERS[mode], nx, ny,
                         camera.kind, camera.lens_radius, camera.focal_distance,
                         _ptr(jitter), _ptr(o), _ptr(d), _ptr(pixel), _ptr(sample))
    np.testing.assert_array_equal(pixel, want[3])
    np.testing.assert_array_equal(sample, want[4])
    np.testing.assert_array_equal(jitter.view(np.int32), want[0].view(np.int32))
    scale = np.maximum(1.0, np.abs(want[1]).max(axis=1, keepdims=True))
    assert np.abs(o - want[1]).max() <= 2e-7 * scale.max()
    assert (np.abs(o - want[1]) <= 2e-7 * scale).all()
    assert np.abs(d - want[2]).max() <= 2e-7
    assert np.abs(np.linalg.norm(d.astype(np.float64), axis=1) - 1.0).max() <= 2.4e-7


# ---------------------------------------------------------------------------
# The row splat
# ---------------------------------------------------------------------------

SPLAT_W, SPLAT_H, SPLAT_ROWS = 37, 40, 16
# name -> (filter, bit for bit)
SPLAT_FILTERS = {
    "box-0.5": (tfilters.box_filter(0.5), True),
    "box-1": (tfilters.box_filter(1.0), True),
    "box-2": (tfilters.box_filter(2.0), True),
    "triangle-2": (tfilters.triangle_filter(2.0), False),
    "gaussian-2": (tfilters.gaussian_filter(2.0, 2.0), False),
    "mitchell-2": (tfilters.mitchell_filter(2.0), False),
    "lanczos-4": (tfilters.lanczos_filter(4.0, 3.0), False),
}
# name -> first row of a 16-row band: the first band, one inside, and the
# last, whose rows 40-47 lie past the image
SPLAT_BANDS = {"first": 0, "inner": 13, "past-the-image": 32}


def _splat_band(row0):
    rng = np.random.default_rng(row0 + 1)
    jitter = rng.random((SPLAT_ROWS, SPLAT_W, 2)).astype(np.float32)
    jitter[0, :4] = [[0.0, 0.0], [0.5, 0.5], [0.0, 0.5], [0.5, 0.0]]  # support edges
    L = (rng.random((SPLAT_ROWS, SPLAT_W, 3)) * 4.0).astype(np.float32)
    if row0 + SPLAT_ROWS > SPLAT_H:  # a NaN on the first row past the image
        L[SPLAT_H - row0, 5, 1] = np.nan
    rgb = rng.random((SPLAT_H, SPLAT_W, 3)).astype(np.float32)
    w = rng.random((SPLAT_H, SPLAT_W)).astype(np.float32)
    return jitter, L, rgb, w


@pytest.mark.parametrize("band", list(SPLAT_BANDS))
@pytest.mark.parametrize("filt_name", list(SPLAT_FILTERS))
def test_splat_pixel_matches_add_samples_rows_plain(lib, filt_name, band):
    """The kernel's pixel function on every film pixel the band reaches
    against the plain splat, folded into a film that holds data: the box
    filter bit for bit (NaN where the plain film is NaN), the others within
    1e-6 of max(1, |value|).  A NaN in L on a row past the image spreads
    (its 0 * L is added) into the last rows, as in the plain version."""
    filt, exact = SPLAT_FILTERS[filt_name]
    row0 = SPLAT_BANDS[band]
    jitter, L, rgb, w = _splat_band(row0)
    want = tfilm.add_samples_rows_plain(
        tfilm.Film(rgb=torch.tensor(rgb), weight=torch.tensor(w)), row0,
        torch.tensor(jitter), torch.tensor(L), filt)
    got_rgb, got_w = rgb.copy(), w.copy()
    assert lib.host_splat_rows(_ptr(got_rgb), _ptr(got_w), _ptr(jitter), _ptr(L), SPLAT_H,
                               SPLAT_W, row0, SPLAT_ROWS, filt.kind, filt.radius, filt.alpha,
                               filt.b, filt.c) == 0
    rr = int(np.ceil(filt.radius))
    nan_rows = np.isnan(want.rgb.numpy()).any(axis=(1, 2)).nonzero()[0]
    assert list(nan_rows) == (list(range(SPLAT_H - rr, SPLAT_H))
                              if band == "past-the-image" else [])
    for got, ref in ((got_rgb, want.rgb.numpy()), (got_w, want.weight.numpy())):
        nan = np.isnan(ref)
        np.testing.assert_array_equal(np.isnan(got), nan)
        if exact:
            np.testing.assert_array_equal(got.view(np.int32)[~nan], ref.view(np.int32)[~nan])
        else:
            err = np.abs(got[~nan] - ref[~nan]) / np.maximum(1.0, np.abs(ref[~nan]))
            assert err.max() <= 1e-6
    # rows the band does not reach keep the film's data
    untouched = np.ones(SPLAT_H, bool)
    untouched[max(0, row0 - rr):row0 + SPLAT_ROWS + rr] = False
    np.testing.assert_array_equal(got_rgb[untouched], rgb[untouched])
