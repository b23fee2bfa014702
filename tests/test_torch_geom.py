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
    r = np.random.default_rng(4)
    dx, dy = (r.random((2, 400)) * 3.0 - 1.5).astype(np.float32)
    for radius in (0.5, 1.0):
        _close(tfilters.evaluate(tfilters.box_filter(radius), torch.tensor(dx),
                                 torch.tensor(dy)),
               jfilters.evaluate(jfilters.box_filter(radius), jnp.asarray(dx),
                                 jnp.asarray(dy)))
    with pytest.raises(NotImplementedError):
        tfilters.evaluate(tfilters.Filter(tfilters.FILTER_GAUSSIAN, 2.0),
                          torch.tensor(dx), torch.tensor(dy))
