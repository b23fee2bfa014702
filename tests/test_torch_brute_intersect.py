"""The plain twins of TPU kernels #2 and #3 against the Pallas kernels.

``brute_intersect.intersect_brute`` / ``intersect_p_brute`` (what the CUDA
kernels of csrc/intersect.cu compute, and what their wrappers run on CPU
tensors) against ``intersect_brute_pallas`` / ``intersect_p_brute_pallas``
in interpret mode, on the cases of tests/test_pallas.py.  The bar is
``test_pallas.compare``'s: hit masks equal, t within rtol 2e-3, prim ids
equal where t is clear.  The any-hit results are compared exactly.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import carry, carry_prims
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.ops import intersect as jisect
from gopbrt_tpu.ops import pallas_intersect
from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.ops import brute_intersect
from gopbrt_tpu_torch.ops import megakernel as tmk
from tests.test_bvh import random_rays, random_sphere_scene
from tests.test_intersect import make_prims, sphere_entry


def _port(prims, *arrays):
    return (brute_intersect.brute_table(carry_prims(prims)),
            *(torch.tensor(np.asarray(a)) for a in arrays))


def compare(prims, o, d, t_max):
    ph, pt, pi = map(np.asarray, pallas_intersect.intersect_brute_pallas(
        prims, o, d, t_max, interpret=True))
    th, tt, ti = (x.numpy() for x in brute_intersect.intersect_brute(
        *_port(prims, o, d, t_max)))
    np.testing.assert_array_equal(th, ph)
    both = th & ph
    np.testing.assert_allclose(tt[both], pt[both], rtol=2e-3)
    clear = np.abs(tt[both] - pt[both]) <= 1e-6 * np.maximum(pt[both], 1.0)
    np.testing.assert_array_equal(ti[both][clear], pi[both][clear])
    # a miss keeps t_max and prim 0 (pallas_intersect.py:272-273)
    np.testing.assert_array_equal(tt[~th], np.asarray(t_max)[~th])
    assert not ti[~th].any()
    return th.mean()


def compare_any(prims, o, d, t_max):
    want = np.asarray(pallas_intersect.intersect_p_brute_pallas(
        prims, o, d, t_max, interpret=True))
    got = brute_intersect.intersect_p_brute(*_port(prims, o, d, t_max)).numpy()
    return got, want


def test_random_spheres():
    o, d = random_rays(512, seed=40)
    assert compare(random_sphere_scene(30, seed=4), o, d, jnp.full((512,), 1e30)) > 0.0


def test_partial_shapes_wedges():
    prims = make_prims([
        (jisect.SPHERE, np.eye(4, dtype=np.float32), [1.0, 0.0, 1.0, 2 * math.pi], 0),
        (jisect.SPHERE, np.eye(4, dtype=np.float32), [1.0, -1.0, 1.0, math.pi / 2], 0),
        (jisect.DISK, np.eye(4, dtype=np.float32), [0.0, 2.0, 0.5, 1.5 * math.pi], 0),
    ])
    o, d = random_rays(2048, seed=9, spread=5.0)
    assert compare(prims, o, d, jnp.full((2048,), 1e30)) > 0.01


def test_triangles_and_mixed():
    prims = make_prims([
        sphere_entry([0.0, 0.0, -2.0], 0.5),
        (jisect.DISK, np.eye(4, dtype=np.float32), [-5.0, 10.0, 0.0, 2 * math.pi], 1),
        (jisect.TRIANGLE, np.eye(4, dtype=np.float32), [-1, -1, -8, 1, -1, -8, 0, 1, -8], 2),
    ])
    o, d = random_rays(1024, seed=11, spread=8.0)
    assert compare(prims, o, d, jnp.full((1024,), 1e30)) > 0.05


def test_tmax_and_padding():
    o, d = random_rays(777, seed=13)
    compare(random_sphere_scene(10, seed=5), o, d, jnp.full((777,), 30.0))


def test_any_hit():
    o, d = random_rays(512, seed=14)
    got, want = compare_any(random_sphere_scene(20, seed=6), o, d, jnp.full((512,), 1e30))
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_any_hit_early_exit_loop():
    """More than 32 prims: the Pallas kernel's early-exit loop.  Dead lanes
    (t_max 1e-4, the integrators' marker) read unoccluded in both."""
    o, d = random_rays(640, seed=15)
    t_max = np.full((640,), 1e30, np.float32)
    dead = np.arange(640) % 3 == 0
    t_max[dead] = 1e-4
    got, want = compare_any(random_sphere_scene(48, seed=7), o, d, jnp.asarray(t_max))
    assert not want[dead].any() and not got[dead].any()
    np.testing.assert_array_equal(got[~dead], want[~dead])


def test_any_hit_respects_tmax():
    """A hit beyond t_max does not occlude."""
    prims = random_sphere_scene(40, seed=8)
    o, d = random_rays(512, seed=16)
    bh, bt, _ = map(np.asarray, jisect.intersect_brute(prims, o, d, jnp.full((512,), 1e30)))
    t_half = jnp.asarray(np.where(bh, bt * 0.5, 1e30).astype(np.float32))
    got, want = compare_any(prims, o, d, t_half)
    np.testing.assert_array_equal(got, want)


def test_fused_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors the wrappers of the CUDA kernels return the plain
    versions' answers and launch nothing."""
    prims = random_sphere_scene(12, seed=3)
    o, d = random_rays(300, seed=17)
    t_max = np.full((300,), 1e30, np.float32)
    t_max[::4] = 20.0
    args = _port(prims, o, d, t_max)
    before = dict(_build.LAUNCHES)
    for got, want in zip(brute_intersect.intersect_brute_fused(*args),
                         brute_intersect.intersect_brute(*args)):
        assert torch.equal(got, want)
    assert torch.equal(brute_intersect.intersect_p_brute_fused(*args),
                       brute_intersect.intersect_p_brute(*args))
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "t_max"])
def test_fused_wrappers_check_their_inputs(bad):
    prims, o, d, t_max = _port(random_sphere_scene(4, seed=1), *random_rays(16, seed=2),
                               np.full((16,), 1e30, np.float32))
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        d = d[:, :2]
    else:
        t_max = t_max[:8]
    for fn in (brute_intersect.intersect_brute_fused,
               brute_intersect.intersect_p_brute_fused):
        with pytest.raises((TypeError, ValueError)):
            fn(prims, o, d, t_max)


def test_builder_packs_the_intersection_table_once():
    """The scene carries the table as the Pallas kernels read it
    (``_flatten_w2o``, the static full-shape flags), packed by the builder;
    the megakernel's tables and the plain sweeps read that one packing."""
    js = jdemo.build_demo_scene(accelerator="none")
    ts = carry(js)
    table = ts.brute
    np.testing.assert_array_equal(table.w2o.numpy(),
                                  np.asarray(pallas_intersect._flatten_w2o(js.prims)))
    np.testing.assert_array_equal(table.ptype.numpy(), np.asarray(js.prims.prim_type))
    np.testing.assert_array_equal(table.params.numpy(), np.asarray(js.prims.params))
    assert table.ptype.dtype == torch.int32 and table.w2o.is_contiguous()
    assert (table.full_sph, table.full_disk) == (js.prims.pinfo.all_full_spheres,
                                                 js.prims.pinfo.all_full_disks)
    assert table.rows == list(zip(table.ptype.tolist(), table.w2o.tolist(),
                                  table.params.tolist()))
    packed = tmk.pack_tables(ts)
    assert torch.equal(packed[:table.count * 12], table.w2o.reshape(-1))
    # the kernels' rows: w2o, the type, params, zero padding
    rows = torch.cat([table.w2o, table.ptype[:, None].float(), table.params], dim=1)
    assert torch.equal(table.rec[:, :brute_intersect.REC_PARAMS + 9], rows)
    assert not table.rec[:, brute_intersect.REC_PARAMS + 9:].any()
