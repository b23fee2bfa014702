"""The port's participating media (``gopbrt_tpu_torch/ops/media.py``)
against the JAX package's ``ops/media.py``, function by function, on
inputs made from numpy seeds; and the shadow walk across null boundaries
(``integrators._intersect_tr``) against the reference's on seeded rays
through a null sphere.

Bar: within 1e-6 relative (1e-7 absolute near zero); the walk's occlusion
equal lane for lane and its transmittance within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carry
from gopbrt_tpu.models import integrators as jint
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import media as jmedia
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.ops import media as tmedia

N = 257


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _table(seed):
    r = np.random.default_rng(seed)
    m = 4
    return (r.uniform(0.0, 0.5, (m, 3)).astype(np.float32),
            r.uniform(0.0, 0.8, (m, 3)).astype(np.float32),
            r.uniform(-0.9, 0.9, m).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_table_lookup_with_vacuum_lanes(seed):
    """-1 lanes read zeros (the reference's safe index and mask), other
    lanes their row; no lane wraps to the last row."""
    sa, ss, g = _table(seed)
    mid = np.random.default_rng(seed + 10).integers(-1, 4, N).astype(np.int32)
    mid[:3] = -1
    want = jmedia.table_lookup(jmedia.MediaTable(jnp.asarray(sa), jnp.asarray(ss),
                                                 jnp.asarray(g)), jnp.asarray(mid))
    got = tmedia.table_lookup(tmedia.MediaTable(torch.tensor(sa), torch.tensor(ss),
                                                torch.tensor(g)), torch.tensor(mid))
    for gv, wv in zip(got, want):
        _close(gv, wv)
    assert float(got[0][:3].abs().max()) == 0.0 and float(got[2][:3].abs().max()) == 0.0


def test_transmittance_and_distance_sampling():
    r = np.random.default_rng(3)
    sa, ss = r.uniform(0.0, 0.4, 3).astype(np.float32), r.uniform(0.0, 0.6, 3).astype(np.float32)
    g = np.float32(0.3)
    dist = r.uniform(-1.0, 30.0, N).astype(np.float32)
    u = r.random(N).astype(np.float32)
    ch = r.integers(0, 3, N).astype(np.int32)
    jm = jmedia.HomogeneousMedium(jnp.asarray(sa), jnp.asarray(ss), jnp.asarray(g))
    tm = tmedia.HomogeneousMedium(torch.tensor(sa), torch.tensor(ss), torch.tensor(g))
    _close(tmedia.transmittance(tm, torch.tensor(dist)),
           jmedia.transmittance(jm, jnp.asarray(dist)))
    _close(tmedia.sample_distance(tm, torch.tensor(u), torch.tensor(ch)),
           jmedia.sample_distance(jm, jnp.asarray(u), jnp.asarray(ch)))
    _close(tm.sigma_t, jm.sigma_t)


@pytest.mark.parametrize("g", [0.0, 3e-4, 0.2, -0.7, 0.9])
def test_hg_phase_sample_and_sample_phase(g):
    """Isotropic, the sign-preserving near-isotropic guard, forward and
    backward scattering; the sampled direction's pdf is its phase value."""
    r = np.random.default_rng(5)
    cos_t = r.uniform(-1.0, 1.0, N).astype(np.float32)
    u = r.random(N).astype(np.float32)
    u2 = r.random((N, 2)).astype(np.float32)
    wo = r.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    _close(tmedia.hg_phase(torch.tensor(cos_t), g), jmedia.hg_phase(jnp.asarray(cos_t), g))
    _close(tmedia.hg_sample(torch.tensor(u), g), jmedia.hg_sample(jnp.asarray(u), g),
           atol=1e-6)
    wi, pdf = tmedia.sample_phase(torch.tensor(wo), torch.tensor(u2), g)
    wi_j, pdf_j = jmedia.sample_phase(jnp.asarray(wo), jnp.asarray(u2), g)
    _close(wi, wi_j, atol=1e-6)
    _close(pdf, pdf_j, rtol=1e-5)
    # per-lane g (bounded media)
    gl = np.full(N, g, np.float32)
    _close(tmedia.hg_phase(torch.tensor(cos_t), torch.tensor(gl)),
           jmedia.hg_phase(jnp.asarray(cos_t), jnp.asarray(gl)))


def _null_sphere_scene(with_fog: bool):
    """A null sphere (a fog ball where ``with_fog``) between a floor and a
    second, matte sphere (test_bounded_media.py:54-74, 95-101)."""
    b = JaxBuilder()
    b.disk(np.eye(4), radius=50.0, material=b.matte(kd=(0.7, 0.6, 0.5)))
    ball = b.sphere(np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]],
                               np.float32), 1.0, b.null_material())
    if with_fog:
        fog = b.add_medium((0.1,) * 3, (0.3,) * 3, g=0.0)
        b.set_medium_interface(ball, inside=fog, outside=-1)
    b.sphere(np.asarray([[1, 0, 0, 1.5], [0, 1, 0, 0], [0, 0, 1, 4.0], [0, 0, 0, 1]],
                        np.float32), 0.3, b.matte())
    b.point_light((0.5, 1.0, 6.0), (20.0,) * 3)
    return b.build(accelerator="none")


@pytest.mark.parametrize("with_fog", [False, True])
def test_intersect_tr_matches_the_reference(with_fog):
    """Seeded shadow rays from the floor toward points above the sphere:
    occlusion equal on every lane, transmittance within 1e-5 (the walk's
    passes cut at null_passes count as occluded in both)."""
    js = _null_sphere_scene(with_fog)
    ts = carry(js)
    r = np.random.default_rng(11)
    n = 512
    o = np.concatenate([r.uniform(-1.5, 1.5, (n, 2)), np.full((n, 1), 1e-3)], 1)
    target = np.concatenate([r.uniform(-1.5, 2.0, (n, 2)), r.uniform(3.2, 6.0, (n, 1))], 1)
    d = target - o
    dist = np.linalg.norm(d, axis=1)
    d = (d / dist[:, None]).astype(np.float32)
    o, dist = o.astype(np.float32), dist.astype(np.float32)
    active = r.random(n) < 0.9
    mid = np.full(n, -1, np.int32)
    for passes in (1, 2):
        occ_j, tr_j = jint._intersect_tr(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist),
                                         jnp.asarray(mid), jnp.asarray(active), passes)
        occ_t, tr_t = tint._intersect_tr(ts, torch.tensor(o), torch.tensor(d),
                                         torch.tensor(dist), torch.tensor(mid),
                                         torch.tensor(active), passes)
        np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
        _close(tr_t, tr_j, rtol=1e-5, atol=1e-6)
        assert 0 < int(occ_t.sum()) < n
    if with_fog:
        assert float(tr_t.min()) < 0.9  # some shadow rays cross the fog
