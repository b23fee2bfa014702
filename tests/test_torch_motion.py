"""Motion blur in the port against gopbrt_tpu's.

- ``ops/quaternion``: tests/test_media_quat.py:85-150's cases (the matrix
  round trip, slerp, animated transforms, time clamping) on both packages,
  and ``decompose`` / ``slerp`` / ``interpolate`` against JAX's on random
  TRS matrices.  ``decompose``'s float32 inverses are LAPACK's here and
  XLA's there: they agree to a few ulps, not bit for bit.
- The animated builder (``SceneBuilder.animate``): its tables and its
  motion-bounded BVH against the JAX builder's (ints exact, floats within
  1e-6); the BVH's boxes cover the shutter (test_motion.py:88-115's rays).
- Per lane on JAX's carried tables: ``_li_wavefront`` and ``li_direct``
  with the rays' shutter times against ``_li_jnp`` / ``li_direct`` on the
  brute test and on the BVH walk, > 99% of lanes within 1e-3 relative;
  ``render`` of a moving sphere against JAX's.
- The fused wrappers refuse an animated table; the dispatch never gives
  them one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (as_torch, bvh_backend, camera_rays, carry,  # noqa: F401
                           jax_scene_arrays, lane_agreement)
from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models import render as jrender
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import quaternion as jquat
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.models.scene import SceneBuilder, scene_to_arrays
from gopbrt_tpu_torch.ops import brute_intersect as tbrute
from gopbrt_tpu_torch.ops import bvh as tbvh
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.ops import quaternion as tquat

W, H = 48, 32
SEED = 6
X0, X1, R = -1.0, 1.0, 0.5
_jax_li = jax.jit(jint._li_jnp, static_argnames=("cfg",))
_jax_direct = jax.jit(jint.li_direct, static_argnames=("max_depth",))


def _close(got, want, atol=1e-6, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _trs(r):
    return np.asarray(jgeom.matmul(jgeom.matmul(
        jgeom.translate(r.normal(size=3) * 3.0), jgeom.rotate(r.uniform(-180, 180),
                                                             r.normal(size=3))),
        jgeom.scale(*r.uniform(0.5, 2.0, 3))), np.float32)


def test_quaternion_cases_match_jax():
    """test_media_quat.py's TestQuaternion on the port, beside JAX."""
    r = np.random.default_rng(2)
    for _ in range(10):
        axis, deg = r.normal(size=3), r.uniform(-179, 179)
        m = np.asarray(jgeom.rotate(deg, axis))
        q_t = tquat.quat_from_matrix(torch.tensor(m))
        _close(q_t, jquat.quat_from_matrix(jnp.asarray(m)), atol=1e-6)
        _close(tquat.quat_to_matrix(q_t), m, atol=2e-5)
    qa = tquat.quat_from_matrix(tgeom.rotate_z(0.0))
    qb = tquat.quat_from_matrix(tgeom.rotate_z(90.0))
    _close(tquat.quat_to_matrix(tquat.slerp(0.5, qa, qb)), tgeom.rotate_z(45.0), atol=1e-5)
    _close(tquat.slerp(0.0, qa, qb), qa, atol=1e-6)
    a, b = _trs(r), _trs(r)
    _close(tquat.quat_mul(torch.tensor(a[0]), torch.tensor(b[1])),
           jquat.quat_mul(jnp.asarray(a[0]), jnp.asarray(b[1])))


@pytest.mark.parametrize("case", ["identity", "translation", "rotation", "mixed", "clamp"])
def test_animated_transform_cases_match_jax(case):
    """test_media_quat.py's TestAnimatedTransform on both packages."""
    times = (0.0, 0.5, 1.0) if case != "clamp" else (0.0, 0.1, 0.5, 0.9, 1.0)
    span = (0.2, 0.8) if case == "clamp" else (0.0, 1.0)
    if case == "identity":
        a = b = jgeom.translate([1.0, 2.0, 3.0])
    elif case in ("translation", "clamp"):
        a, b = jgeom.translate([0.0, 0.0, 0.0]), jgeom.translate([10.0, 0.0, 0.0])
    elif case == "rotation":
        a, b = jgeom.rotate_z(0.0), jgeom.rotate_z(90.0)
    else:
        a = jgeom.matmul(jgeom.translate([1.0, 0.0, 0.0]), jgeom.rotate_x(10.0))
        b = jgeom.matmul(jgeom.translate([3.0, 0.0, 0.0]), jgeom.rotate_x(70.0))
    a, b = np.asarray(a), np.asarray(b)
    jat = jquat.animated_transform(a, b, *span)
    tat = tquat.animated_transform(a, b, *span)
    for t in times:
        _close(tquat.interpolate(tat, t), jquat.interpolate(jat, t), atol=2e-6)
    mid = tquat.interpolate(tat, 0.5).numpy()
    if case == "rotation":
        _close(mid, tgeom.rotate_z(45.0), atol=1e-4)
    if case == "mixed":
        _close(mid, tgeom.matmul(tgeom.translate([2.0, 0.0, 0.0]), tgeom.rotate_x(40.0)),
               atol=1e-3)


def test_decompose_slerp_interpolate_match_jax():
    r = np.random.default_rng(3)
    ms = np.stack([_trs(r) for _ in range(40)])
    for g, j in zip(tquat.decompose(torch.tensor(ms)), jquat.decompose(jnp.asarray(ms))):
        _close(g, j, atol=2e-6, rtol=2e-6)
    q = tquat.quat_normalize(torch.tensor(r.normal(size=(40, 2, 4)).astype(np.float32)))
    q[:5, 1] = tquat.quat_normalize(q[:5, 0] + 1e-3)  # within cos 0.9995: the lerp branch
    t = r.random(40).astype(np.float32)
    _close(tquat.slerp(torch.tensor(t), q[:, 0], q[:, 1]),
           jquat.slerp(jnp.asarray(t), jnp.asarray(q[:, 0].numpy()),
                       jnp.asarray(q[:, 1].numpy())), atol=2e-6)
    tat = tquat.animated_transform(ms[0], ms[1])
    jat = jquat.animated_transform(ms[0], ms[1])
    _close(tquat.interpolate(tat, torch.tensor(t)), jquat.interpolate(jat, jnp.asarray(t)),
           atol=1e-5, rtol=1e-5)


def _assert_tables_close(got: dict, want: dict):
    """Ints and bools exact; floats within 1e-6 (decompose's inverses)."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)


def _moving_scene(builder_cls, geom, n_fill=0, **kw):
    """A moving sphere (test_motion.py's) and a moving, turning disk over a
    floor; ``n_fill`` static spheres put it above the brute-force cutoff."""
    b = builder_cls()
    mat = b.matte(kd=(0.8, 0.8, 0.8))
    b.disk(np.asarray(geom.rotate_x(-90.0)), 20.0, b.matte(kd=(0.5, 0.6, 0.7)))
    pid = b.sphere(np.asarray(geom.translate([X0, 0.5, 0.0])), R, mat)
    b.animate(pid, np.asarray(geom.translate([X1, 0.5, 0.0])))
    did = b.disk(np.asarray(geom.matmul(geom.translate([0.0, 1.8, -1.0]), geom.rotate_y(20.0))),
                 0.6, b.matte(kd=(0.2, 0.7, 0.3)))
    b.animate(did, np.asarray(geom.matmul(geom.translate([0.5, 2.0, -1.0]),
                                          geom.rotate_y(80.0))))
    for i in range(n_fill):
        b.sphere(np.asarray(geom.translate([-6.0 + 0.3 * (i % 40), 3.5 + i // 40, -4.0])),
                 0.12, mat)
    b.distant_light(direction=(0.0, 0.3, 1.0), radiance=(3.0, 3.0, 3.0))
    b.point_light(p=(2.0, 4.0, 3.0), intensity=(20.0,) * 3)
    return b.build(accelerator="bvh" if n_fill else "none", **kw)


def _camera(mod, geom, **kw):
    return mod.perspective_camera(geom.look_at([0.0, 1.0, 6.0], [0.0, 0.8, 0.0],
                                               [0.0, 1.0, 0.0]), W, H, fov_deg=40.0, **kw)


@pytest.mark.parametrize("n_fill", [0, 70])
def test_animated_builder_tables_match_jax(n_fill, bvh_backend):
    """The tree, where the scene has one, built by the builder the JAX side
    uses in this process on both sides."""
    want = _moving_scene(JaxBuilder, jgeom, n_fill)
    got = _moving_scene(SceneBuilder, tgeom, n_fill, device="cpu")
    assert (got.bvh_tables is None) == (n_fill == 0)
    assert got.bvh_tables is None or got.bvh_tables.backend == bvh_backend
    _assert_tables_close(scene_to_arrays(got), jax_scene_arrays(want))
    assert got.prims.anim.animated.tolist()[:3] == [False, True, True]
    assert not got.fastinfo.ok and got.kernel is None and got.mesh is None
    if n_fill:
        assert got.bvh is not None and got.bvh_tables.animated


def test_animated_bvh_bounds_cover_shutter():
    """test_motion.py:88-115: the moving sphere is found at its end pose at
    time 1, and nothing at its start pose."""
    b = SceneBuilder()
    mat = b.matte(kd=(0.8, 0.8, 0.8))
    pid = b.sphere(tgeom.translate([X0, 0.0, 0.0]), R, mat)
    b.animate(pid, tgeom.translate([X1, 0.0, 0.0]))
    for i in range(5):
        b.sphere(tgeom.translate([0.0, -20.0 - 4 * i, 0.0]), 1.0, mat)
    b.distant_light(direction=(0.0, 0.0, 1.0), radiance=(3.0, 3.0, 3.0))
    scene = b.build(accelerator="bvh", device="cpu")
    assert scene.bvh is not None
    o = torch.tensor([[X1, 0.0, 5.0], [X0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 2)
    hit, t, idx = tbvh.bvh_intersect(scene.bvh_tables, o, d, torch.full((2,), 1e30),
                                     anim=scene.prims.anim, time=torch.tensor([1.0, 1.0]))
    assert bool(hit[0]) and int(idx[0]) == pid and not bool(hit[1])
    hit0, _, _ = tbvh.bvh_intersect(scene.bvh_tables, o, d, torch.full((2,), 1e30),
                                    anim=scene.prims.anim, time=torch.tensor([0.0, 0.0]))
    assert hit0.tolist() == [False, True]


@pytest.fixture(scope="module", params=[0, 70], ids=["brute", "bvh"])
def moving(request):
    js = _moving_scene(JaxBuilder, jgeom, request.param)
    ts = carry(js)  # JAX's own tables
    cam = _camera(jcam, jgeom)
    o, d, pix, smp = camera_rays(cam, W, H, 1, SEED)
    time = jrender.camera_time(cam, pix, smp, jnp.uint32(SEED))
    return js, ts, (o, d, pix, smp), time


def test_camera_time_bit_for_bit(moving):
    _, _, (_, _, pix, smp), time = moving
    got = trender.camera_time(_camera(tcam, tgeom, device="cpu"), *as_torch(pix, smp), SEED)
    np.testing.assert_array_equal(got.numpy(), np.asarray(time))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


def test_moving_scene_path_per_lane(moving):
    js, ts, rays, time = moving
    want = np.asarray(_jax_li(js, *rays, jnp.uint32(SEED), jint.PathConfig(max_depth=3),
                              time=time))
    before = dict(_build.LAUNCHES)
    got = tint.li(ts, *as_torch(*rays), SEED, tint.PathConfig(max_depth=3),
                  time=torch.tensor(np.asarray(time))).numpy()
    assert dict(_build.LAUNCHES) == before
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.99 and mean_rel < 1e-2, (frac, mean_rel)
    assert want.mean() > 1e-2
    static = tint.li(ts, *as_torch(*rays), SEED, tint.PathConfig(max_depth=3)).numpy()
    assert not np.array_equal(static, got)  # the times move the prims


def test_moving_scene_direct_per_lane(moving):
    js, ts, rays, time = moving
    want = np.asarray(_jax_direct(js, *rays, jnp.uint32(SEED), max_depth=3, time=time))
    got = tint.li_direct(ts, *as_torch(*rays), SEED, max_depth=3,
                         time=torch.tensor(np.asarray(time))).numpy()
    frac, mean_rel = lane_agreement(got, want)
    assert frac > 0.99 and mean_rel < 1e-2, (frac, mean_rel)


def test_motion_blur_render_matches_jax():
    settings = dict(width=W, height=H, spp=4, max_depth=2, samples_per_pass=2, seed=SEED)
    js = _moving_scene(JaxBuilder, jgeom)
    jimg = np.asarray(jrender.render(js, _camera(jcam, jgeom), jrender.RenderSettings(**settings)))
    timg = trender.render(carry(js), _camera(tcam, tgeom, device="cpu"),
                          trender.RenderSettings(**settings), device="cpu").numpy()
    frac, mean_rel = lane_agreement(timg.reshape(-1, 3), jimg.reshape(-1, 3))
    assert frac > 0.99 and mean_rel < 2e-3, (frac, mean_rel)


def test_fused_wrappers_refuse_an_animated_table():
    ts = _moving_scene(SceneBuilder, tgeom, 70, device="cpu")
    o, d = torch.zeros((4, 3)), torch.tensor([[0.0, 0.0, -1.0]] * 4)
    t_max = torch.full((4,), 1e30)
    brute = tbrute.brute_table(ts.prims)
    assert brute.animated and ts.bvh_tables.animated
    for fn, table in ((tbrute.intersect_brute_fused, brute),
                      (tbrute.intersect_p_brute_fused, brute),
                      (tbvh.bvh_intersect_fused, ts.bvh_tables),
                      (tbvh.bvh_intersect_p_fused, ts.bvh_tables)):
        with pytest.raises(ValueError, match="animated"):
            fn(table, o, d, t_max)
    static = ts._replace(prims=ts.prims._replace(anim=None))
    assert not tbrute.scene_table(static).animated
