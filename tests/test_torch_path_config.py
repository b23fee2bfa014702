"""``PathConfig``'s nee / mis / null_passes: the port's ``li`` against the
JAX package's ``_li_jnp`` (what its ``li`` runs on the CPU), per lane.

The scenes are the JAX package's, carried across (``_torch_parity.carry``),
on the CPU: the demo and config 2 (brute force, 24 and 8 prims) at 32x32
and the 16x16 mesh scene (482 prims, the BVH walk) at 16x16, each with nee
off, mis off and both off, depth 4, 4 and 3; the bounded-media family (a
fog ball behind a null boundary) at 32x18, depth 4, with null_passes 0 and
4.  Bar: > 98% of
lanes within 1e-3 relative, the mean within 1e-2
(tests/test_megakernel.py:114).

With nee or mis off the fast-path scenes leave the megakernels for the
wavefront chain, as the reference's gates do (integrators.py:116-117,
137-138), and the megakernels' wrappers refuse such a cfg.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import as_torch, camera_rays, carry, lane_agreement
from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import gallery as jgallery
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models import meshes as jmeshes
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.ops import megakernel as tmk
from gopbrt_tpu_torch.ops import mesh_megakernel as tmm

SEED = 9
_jax_li = jax.jit(jint._li_jnp, static_argnames=("cfg",))

# (nee, mis) of each gated case
GATES = {"nee_off": (False, True), "mis_off": (True, False), "both_off": (False, False)}


@functools.cache
def _bench_families():
    """The reference's family builders (benchmarks/bench_families.py)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "bench_families.py")
    spec = importlib.util.spec_from_file_location("bench_families", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _case(name):
    """(JAX scene, the port's carried scene, JAX camera rays, depth)."""
    if name == "demo":
        js, w, h, depth = jdemo.build_demo_scene(accelerator="none"), 32, 32, 4
        cam = jdemo.build_demo_camera(w, h)
    elif name == "config2":
        (js, cam, _), w, h, depth = jgallery.config2(32, 32), 32, 32, 4
    elif name == "mesh":
        js, w, h, depth = jmeshes.build_mesh_scene(n_lat=16, n_lon=16), 16, 16, 3
        cam = jmeshes.mesh_camera(w, h)
    else:
        js, w, h, depth = _bench_families().bounded_media()[0], 32, 18, 4
        cam = jcam.perspective_camera(jgeom.look_at([0, 2.4, 6.5], [0, 1.2, 0], [0, 1, 0]),
                                      w, h, fov_deg=45.0)
    return js, carry(js), camera_rays(cam, w, h, 1, SEED), depth


def _check(name, cfg_j, cfg_t):
    js, ts, rays, _ = _case(name)
    want = np.asarray(_jax_li(js, *rays, jnp.uint32(SEED), cfg_j))
    before = dict(_build.LAUNCHES)
    got = tint.li(ts, *as_torch(*rays), SEED, cfg_t).numpy()
    assert dict(_build.LAUNCHES) == before  # CPU tensors: no launch
    assert np.all(np.isfinite(got))
    frac, mean_rel = lane_agreement(got, want)
    print(f"{name} {cfg_t}: {frac:.5f} of lanes within 1e-3, mean diff {mean_rel:.2e}, "
          f"mean L {want.mean():.6f}")
    assert frac > 0.98, f"lane agreement {frac:.4f}"
    assert mean_rel < 1e-2, mean_rel
    return got


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("name", ["demo", "config2", "mesh"])
def test_li_with_nee_or_mis_off_matches_li_jnp(name, gate):
    """The demo and config 2 on the brute-force intersection, the mesh on
    the BVH walk, all off their megakernels.  With NEE off only emitter
    hits light a path: at these sizes the demo's paths find its one area
    light (a small sphere) with no ray and the mesh's with few, so those
    images are black or nearly so on both sides; config 2's lamp (a sphere
    under the box's ceiling, seen by camera rays and in its mirror sphere)
    lights every case."""
    nee, mis = GATES[gate]
    depth = _case(name)[3]
    got = _check(name, jint.PathConfig(max_depth=depth, nee=nee, mis=mis),
                 tint.PathConfig(max_depth=depth, nee=nee, mis=mis))
    assert got.mean() > 0.0 or (not nee and name != "config2")


@pytest.mark.parametrize("null_passes", [0, 4])
def test_bounded_media_null_passes_match_li_jnp(null_passes):
    """0: one segment a bounce, shadow rays occluded by the null boundary
    (the any-hit path); 4: up to five segments and a five-step shadow walk."""
    depth = _case("bounded_media")[3]
    got = _check("bounded_media", jint.PathConfig(max_depth=depth, null_passes=null_passes),
                 tint.PathConfig(max_depth=depth, null_passes=null_passes))
    assert got.mean() > 0.0


def test_path_config_defaults_are_the_reference_s():
    got, want = tint.PathConfig(), jint.PathConfig()
    assert got._fields == want._fields
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("name", ["demo", "mesh"])
def test_li_sends_gated_cfgs_off_the_megakernels(name, monkeypatch):
    """On CPU tensors: with nee or mis off, ``li`` never calls the fused
    wrappers (patched to raise) and gives ``_li_wavefront``'s radiance; with
    the defaults it still takes the one wrapper, on the scene's kernel."""
    _, ts, rays, _ = _case(name)
    args = (ts, *as_torch(*rays), SEED)
    calls = []

    def fused(*a, **k):
        calls.append(a[0])
        raise AssertionError("a megakernel ran on a gated cfg")

    monkeypatch.setattr(tint, "li_fused", fused)
    for nee, mis in GATES.values():
        cfg = tint.PathConfig(max_depth=2, nee=nee, mis=mis)
        assert torch.equal(tint.li(*args, cfg), tint._li_wavefront(*args, cfg))
    assert calls == []
    with pytest.raises(AssertionError, match="gated"):
        tint.li(*args, tint.PathConfig(max_depth=2))
    assert calls == [tmk.BRUTE if name == "demo" else tmm.MESH]


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("name", ["demo", "mesh"])
def test_megakernel_wrappers_refuse_a_gated_cfg(name, gate):
    """The kernels bake in NEE with MIS; their wrappers (and the plain
    version) raise rather than render such a cfg."""
    _, ts, rays, _ = _case(name)
    nee, mis = GATES[gate]
    cfg = tint.PathConfig(max_depth=2, nee=nee, mis=mis)
    args = (ts, *as_torch(*rays), SEED, cfg)
    kernel = tmk.BRUTE if name == "demo" else tmm.MESH
    with pytest.raises(ValueError, match="NEE with MIS"):
        tint.li_fused(kernel, *args)
    with pytest.raises(ValueError, match="NEE with MIS"):
        tmk.path_li_plain(*args, accel="brute" if name == "demo" else "bvh")
