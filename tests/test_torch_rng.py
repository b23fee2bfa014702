"""The port's counter RNG is bit-exact with gopbrt_tpu/ops/rng.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gopbrt_tpu.ops import rng as jrng
from gopbrt_tpu_torch.ops import rng as trng

# bounce dims 5 + 16*b + k for depth 10, plus the camera dims and dims
# near 2^32
DIMS = np.array(
    list(range(5))
    + [jrng.DIM_BOUNCE_BASE + jrng.DIMS_PER_BOUNCE * b + k
       for b in range(10) for k in range(16)]
    + [2**32 - 1, 2**32 - 2, 2**31, 2**31 - 1, jrng.DIM_ALL_LIGHT_BASE],
    np.uint64,
)
SEEDS = [0, 7, 12345678, 2**31, 2**32 - 1]


def _counters():
    """(pixel, sample, dim) uint32 grids, made from a numpy seed."""
    r = np.random.default_rng(0)
    n = DIMS.size
    pixel = np.concatenate([
        np.arange(64), [2**32 - 1, 2**32 - 2, 2**31, 2**31 - 1],
        r.integers(0, 2**32, n - 68)])
    sample = np.concatenate([[0, 1, 2, 3, 15, 2**32 - 1, 2**31],
                             r.integers(0, 2**32, n - 7)])
    return pixel.astype(np.uint32), sample.astype(np.uint32), DIMS.astype(np.uint32)


def _t(x):
    return torch.tensor(np.asarray(x).astype(np.int64))


def test_hash_u32_bit_exact():
    x = np.concatenate([np.arange(1000), np.arange(2**32 - 1000, 2**32),
                        np.random.default_rng(1).integers(0, 2**32, 5000)]).astype(np.uint32)
    want = np.asarray(jrng.hash_u32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(trng.hash_u32(_t(x)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_and_unit_bit_exact(seed):
    pixel, sample, dim = _counters()
    js = jrng.stream_u32(seed, jnp.asarray(pixel), jnp.asarray(sample), jnp.asarray(dim))
    ts = trng.stream_u32(seed, _t(pixel), _t(sample), _t(dim))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    ju = np.asarray(jrng.u32_to_unit(js))
    tu = trng.u32_to_unit(ts).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    assert tu.min() >= 0.0 and tu.max() < 1.0


@pytest.mark.parametrize("nx,ny", [(1, 1), (2, 2), (4, 4), (3, 5)])
@pytest.mark.parametrize("seed", [0, 2**32 - 1])
def test_stratified_2d_bit_exact(seed, nx, ny):
    pixel, sample, _ = _counters()
    for dim in (0, 2, 2**32 - 2):
        j = np.asarray(jrng.stratified_2d(seed, jnp.asarray(pixel), jnp.asarray(sample),
                                          np.uint32(dim), nx, ny))
        t = trng.stratified_2d(seed, _t(pixel), _t(sample), dim, nx, ny).numpy()
        np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


def test_sample_2d_bit_exact():
    pixel, sample, _ = _counters()
    j = np.asarray(jrng.sample_2d(7, jnp.asarray(pixel), jnp.asarray(sample), np.uint32(2)))
    t = trng.sample_2d(7, _t(pixel), _t(sample), 2).numpy()
    np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))
