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
  against the plain walk's tally (the events the kernels' bound counts).
- path_init / path_bounce / path_finish of csrc/bounce.cuh against
  ``path_li_plain`` per lane on the demo and the lobe scenes (brute
  instance) and on the mesh (BVH instance) at 16x16, at the bars of
  tests/test_megakernel.py; and bit for bit against themselves in another
  interleaving, so the order of refills cannot change a lane's answer.
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

from _torch_parity import (as_torch, camera_rays, carry, lane_agreement,
                           rough_glass_camera, rough_glass_scene)
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import gallery as jgallery
from gopbrt_tpu.models import meshes as jmeshes
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu_torch._build import BUILD_ROOT, CSRC
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.ops import bvh as tbvh
from gopbrt_tpu_torch.ops import megakernel as tmk

HARNESS = Path(__file__).resolve().parent / "host_kernels.cpp"
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
W = H = 16
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# the path entries' arguments after their tables: n_lights, seed, func_int,
# world_radius, cone_w0, cone_sp, max_depth, rr_start, rr_threshold,
# flags, o, d, pixel, sample, L, n, lanes, order_seed
_PATH_ARGS = [_I, _U, _F, _F, _F, _F, _I, _I, _F, _I, _P, _P, _P, _P, _P, _I, _I, _U]


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
    lib.host_bvh_walk.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P]
    lib.host_paths_brute.argtypes = [_P, _I] + _PATH_ARGS
    lib.host_paths_mesh.argtypes = [_P, _P, _P, _I] + _PATH_ARGS
    for fn in (lib.host_bvh_walk, lib.host_paths_brute, lib.host_paths_mesh):
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


def _host_walk(lib, table, o, d, t_max, any_hit):
    """The harness walk -> (t, slot, nodes and leaves, interior nodes, pops)
    per ray."""
    n = o.shape[0]
    nodes, recs = _np(table.nodes, np.float32), _np(table.records, np.float32)
    o_, d_, tm = _np(o, np.float32), _np(d, np.float32), _np(t_max, np.float32)
    t = np.empty(n, np.float32)
    slot, steps, inner, pops = (np.empty(n, np.int32) for _ in range(4))
    lib.host_bvh_walk(_ptr(nodes), _ptr(recs), table.flags, _ptr(o_), _ptr(d_), _ptr(tm), n,
                      int(any_hit), _ptr(t), _ptr(slot), _ptr(steps), _ptr(inner), _ptr(pops))
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
}


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(port scene, rays, cone) of a scene at W x H."""
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
    if name == "mesh":
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
    lobe scenes, the BVH instance on the mesh)."""
    depth, lane_bar, mean_bar = SCENES[name]
    ts, rays, cone = _scene(name)
    ref = tmk.path_li_plain(ts, *rays, SEED, tint.PathConfig(max_depth=depth), cone=cone,
                            accel="bvh" if name == "mesh" else "brute").numpy()
    got = _host_paths(lib, name, 7, 3)
    assert np.all(np.isfinite(got))
    frac, mean_rel = lane_agreement(got, ref)
    assert frac > lane_bar, f"lane agreement {frac:.4f}"
    assert mean_rel < mean_bar, mean_rel
    assert ref.mean() > 1e-3  # the image is not black


@pytest.mark.parametrize("name", ["demo", "rough_glass", "mesh"])
def test_bounce_skeleton_is_the_same_in_any_order(lib, name):
    """Paths on one lane, or refilled on many lanes, in three shuffled
    orders: the same radiance, bit for bit."""
    one = _host_paths(lib, name, 1, 0)
    for lanes, seed in ((5, 1), (32, 2)):
        np.testing.assert_array_equal(_host_paths(lib, name, lanes, seed), one)
