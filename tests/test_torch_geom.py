"""The port's geom, sampling and filters against gopbrt_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gopbrt_tpu.ops import filters as jfilters
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu.ops import sampling as jsampling
from gopbrt_tpu_torch.ops import filters as tfilters
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.ops import sampling as tsampling


def _close(got, want, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_constants_match():
    assert tgeom.ONE_MINUS_EPSILON == jgeom.ONE_MINUS_EPSILON
    assert tgeom.SHADOW_EPSILON == jgeom.SHADOW_EPSILON
    assert tgeom.PI == jgeom.PI


@pytest.mark.parametrize("name,args", [
    ("translate", ([1.5, -2.0, 30.0],)),
    ("scale", (2.0, 0.5, 3.0)),
    ("rotate_x", (37.0,)),
    ("rotate_y", (-30.0,)),
    ("look_at", ([150.0, 150.0, 150.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])),
    ("perspective", (100.0, 1e-2, 1000.0)),
])
def test_transform_constructors_match(name, args):
    _close(getattr(tgeom, name)(*args), getattr(jgeom, name)(*args))


def test_matmul_inverse_and_apply_match():
    r = np.random.default_rng(0)
    a = r.normal(size=(4, 4)).astype(np.float32)
    b = r.normal(size=(4, 4)).astype(np.float32)
    _close(tgeom.matmul(torch.tensor(a), torch.tensor(b)), jgeom.matmul(a, b))
    _close(tgeom.inverse(torch.tensor(a)), jgeom.inverse(jnp.asarray(a)), atol=1e-5,
           rtol=1e-4)
    p = r.normal(size=(100, 3)).astype(np.float32)
    for fn in ("apply_point", "apply_point_affine", "apply_vector"):
        _close(getattr(tgeom, fn)(torch.tensor(a), torch.tensor(p)),
               getattr(jgeom, fn)(jnp.asarray(a), jnp.asarray(p)), atol=1e-5)


def test_vector_ops_match():
    r = np.random.default_rng(1)
    v = r.normal(size=(200, 3)).astype(np.float32)
    v[:3] = 0.0  # zero vectors take the guarded branch
    tv = torch.tensor(v)
    _close(tgeom.length_sq(tv), jgeom.length_sq(jnp.asarray(v)))
    for eps in (0.0, 1e-20):
        _close(tgeom.normalize(tv[3:], eps), jgeom.normalize(jnp.asarray(v[3:]), eps))
    _close(tgeom.normalize(tv, 1e-20), jgeom.normalize(jnp.asarray(v), 1e-20))
    u = v[3:] / np.linalg.norm(v[3:], axis=1, keepdims=True)
    for got, want in zip(tgeom.coordinate_system(torch.tensor(u)),
                         jgeom.coordinate_system(jnp.asarray(u))):
        _close(got, want)


def _lanes(seed, n=300):
    """Random inputs of the shading helpers: vectors, unit vectors, angles."""
    r = np.random.default_rng(seed)
    v = r.normal(size=(4, n, 3)).astype(np.float32)
    u = v / np.linalg.norm(v, axis=-1, keepdims=True)
    s = r.random((n,)).astype(np.float32)
    phi = (r.random((n,)) * 2.0 * np.pi).astype(np.float32)
    return v, u, np.sqrt(1.0 - s * s), s, phi


@pytest.mark.parametrize("name", ["absdot", "face_forward", "spherical_direction",
                                  "spherical_direction_xyz", "offset_ray_origin"])
def test_shading_helpers_match(name):
    """The geometry helpers of the general chain; offset_ray_origin rounds
    one ulp away from p, so it is compared exactly."""
    v, u, sin_t, cos_t, phi = _lanes(5)
    args = {
        "absdot": (v[0], v[1]),
        "face_forward": (u[0], v[1]),
        "spherical_direction": (sin_t, cos_t, phi),
        "spherical_direction_xyz": (sin_t, cos_t, phi, u[0], u[1], u[2]),
        "offset_ray_origin": (v[0] * 10.0, np.abs(v[1]) * 1e-4, u[2], v[3]),
    }[name]
    got = getattr(tgeom, name)(*map(torch.tensor, args))
    want = getattr(jgeom, name)(*map(jnp.asarray, args))
    if name == "offset_ray_origin":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)
    assert tgeom.gamma(3) == pytest.approx(float(jgeom.gamma(3)), rel=1e-6)


@pytest.mark.parametrize("name", ["uniform_sample_sphere", "uniform_sample_cone",
                                  "cosine_sample_hemisphere", "uniform_cone_pdf",
                                  "power_heuristic"])
def test_sampling_warps_match(name):
    r = np.random.default_rng(6)
    u = r.random((400, 2)).astype(np.float32)
    u[:2] = [[0.5, 0.5], [0.0, 0.0]]
    a, b = (r.random((2, 400)) * 5.0).astype(np.float32)
    a[:3], b[:3] = 0.0, [0.0, 1.0, 0.0]  # zero pdfs on both sides
    cos_max = r.uniform(0.0, 0.999, 400).astype(np.float32)
    args = {
        "uniform_sample_sphere": (u,),
        "uniform_sample_cone": (u, cos_max),
        "cosine_sample_hemisphere": (u,),
        "uniform_cone_pdf": (cos_max,),
        "power_heuristic": (1, a, 1, b),
    }[name]
    got = getattr(tsampling, name)(*(torch.tensor(x) if isinstance(x, np.ndarray) else x
                                     for x in args))
    want = getattr(jsampling, name)(*(jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                      for x in args))
    _close(got, want)


def test_concentric_sample_disk_matches():
    r = np.random.default_rng(2)
    u = r.random((500, 2)).astype(np.float32)
    u[:4] = [[0.5, 0.5], [0.5, 0.9], [0.1, 0.5], [0.0, 0.0]]  # axes and center
    _close(tsampling.concentric_sample_disk(torch.tensor(u)),
           jsampling.concentric_sample_disk(jnp.asarray(u)))


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0, 1.0], [0.5, 3.0, 0.0, 1.5],
                                     [0.0, 0.0, 0.0]])
def test_distribution_and_discrete_sampling_match(weights):
    w = np.asarray(weights, np.float32)
    got = tsampling.distribution_1d(torch.tensor(w))
    want = jsampling.distribution_1d(jnp.asarray(w))
    for g, j in zip(got, want):
        _close(g, j)
    u = np.random.default_rng(3).random(300).astype(np.float32)
    u[:3] = [0.0, 0.25, 0.5]  # on CDF steps
    idx_t, pmf_t = tsampling.sample_discrete(*got, torch.tensor(u))
    idx_j, pmf_j = jsampling.sample_discrete(*want, jnp.asarray(u))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(pmf_t, pmf_j)


def test_box_filter_matches():
    """The box filter at two radii, and the Gaussian."""
    r = np.random.default_rng(4)
    dx, dy = (r.random((2, 400)) * 3.0 - 1.5).astype(np.float32)
    for radius in (0.5, 1.0):
        _close(tfilters.evaluate(tfilters.box_filter(radius), torch.tensor(dx),
                                 torch.tensor(dy)),
               jfilters.evaluate(jfilters.box_filter(radius), jnp.asarray(dx),
                                 jnp.asarray(dy)))
    _close(tfilters.evaluate(tfilters.Filter(tfilters.FILTER_GAUSSIAN, 2.0),
                             torch.tensor(dx), torch.tensor(dy)),
           jfilters.evaluate(jfilters.Filter(jfilters.FILTER_GAUSSIAN, 2.0),
                             jnp.asarray(dx), jnp.asarray(dy)))
