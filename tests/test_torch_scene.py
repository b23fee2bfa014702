"""The port's SceneBuilder and scene_from_arrays against gopbrt_tpu's."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from _torch_parity import (assert_builder_tables_equal, assert_tables_equal,  # noqa: F401
                           bvh_backend, carry, jax_scene_arrays, jax_scene_infos,
                           match_bvh_backend, rough_glass_scene)
from gopbrt_tpu import native as jnative
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import gallery
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models.scene import SceneBuilder, scene_to_arrays
from gopbrt_tpu_torch.ops import geom as tgeom


def _port_infos(scene):
    return dict(pinfo=asdict(scene.prims.pinfo), minfo=asdict(scene.materials.info),
                fastinfo=asdict(scene.fastinfo), camera_medium=scene.camera_medium)


def test_demo_builder_tables_match_jax(bvh_backend):
    """Ints exact, floats within 1e-6 relative; static facts equal."""
    want = jdemo.build_demo_scene(accelerator="none")
    got = tdemo.build_demo_scene(device="cpu")
    assert_builder_tables_equal(got, want, bvh_backend)
    assert _port_infos(got) == jax_scene_infos(want)
    assert got.fastinfo.ok and got.prims.count == 24 and got.n_lights == 4


def test_rough_glass_builder_tables_match_jax(bvh_backend):
    want = rough_glass_scene(JaxBuilder, jgeom).build(accelerator="none")
    got = rough_glass_scene(SceneBuilder, tgeom).build(device="cpu")
    assert_builder_tables_equal(got, want, bvh_backend)
    assert _port_infos(got) == jax_scene_infos(want)
    assert got.fastinfo.has_rough_glass and not got.fastinfo.has_glass


def _jax_scene(name):
    if name == "demo":
        return jdemo.build_demo_scene(accelerator="none")
    if name == "rough_glass":
        return rough_glass_scene(JaxBuilder, jgeom).build(accelerator="none")
    return getattr(gallery, name)(48, 48)[0]


@pytest.mark.parametrize("name", ["demo", "config2", "config4", "rough_glass"])
def test_scene_from_arrays_carries_exactly(name):
    js = _jax_scene(name)
    ts = carry(js)
    assert_tables_equal(scene_to_arrays(ts), jax_scene_arrays(js))
    assert _port_infos(ts) == jax_scene_infos(js)
    assert ts.fastinfo.ok


def test_non_uniform_scale_leaves_the_fast_path():
    b = SceneBuilder()
    b.sphere(np.diag([1.0, 2.0, 1.0, 1.0]), 1.0, b.matte())
    b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
    assert not b.build(device="cpu").fastinfo.ok


_ANIMATE = lambda b: b.animate(b.sphere(np.eye(4), 1.0, b.matte()),  # noqa: E731
                               np.asarray([[1, 0, 0, 2.0], [0, 1, 0, 0], [0, 0, 1, 0],
                                           [0, 0, 0, 1]], np.float32))


@pytest.mark.parametrize("call", [
    lambda b: b.add_medium((0.1, 0.1, 0.1)),
    lambda b: b.subsurface(),
    lambda b: b.matte(bump_tex=0),
    lambda b: b.set_medium((0.1, 0.1, 0.1)),
    lambda b: b.null_material(),
    _ANIMATE,
])
def test_builder_raises_outside_the_slice(call, bvh_backend):
    """Media, subsurface, bump, null materials and animation are ported:
    the builder takes them, the scene builds outside the megakernel's fast
    path, and an animated scene's tables, the animation table included,
    are the JAX builder's (ints exact, floats within 1e-6: decompose's
    float32 inverses are LAPACK's here, XLA's there)."""
    def build(cls, **kw):
        b = cls()
        call(b)
        b.sphere(np.eye(4), 1.0, b.matte())
        b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
        return b.build(**kw)

    scene = build(SceneBuilder, device="cpu")
    assert not scene.fastinfo.ok and scene.kernel is None
    if call is _ANIMATE:
        want = build(JaxBuilder, accelerator="none")
        assert scene.bvh_tables is None or scene.bvh_tables.backend == bvh_backend
        got, wanted = scene_to_arrays(scene), jax_scene_arrays(want)
        assert sorted(got) == sorted(wanted) and "prims.anim.q0" in got
        for k, w in wanted.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6, err_msg=k)
        assert _port_infos(scene) == jax_scene_infos(want)


def _spheres_65(cls, geom, **kw):
    """65 spheres in a row under a point light: above the brute-force
    cutoff, so the builder builds the SAH BVH."""
    b = cls()
    m = b.matte()
    for i in range(65):
        b.sphere(np.asarray(geom.translate([3.0 * i, 0.0, 0.0])), 1.0, m)
    b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
    return b.build(**kw)


def test_scenes_that_need_a_bvh_raise(bvh_backend):
    """A scene above 64 prims builds its SAH BVH: its tables, the tree
    included, equal the JAX builder's (both built by the builder the JAX
    side uses in this process), and the general chain on the BVH walk
    gives the brute-force chain's radiance.  Its 65 spheres fit the mesh
    megakernel, whose gate takes scenes without triangles (the JAX
    package's does not), so the builder packs its tables."""
    build = _spheres_65
    want = build(JaxBuilder, jgeom)
    got = build(SceneBuilder, tgeom, device="cpu")
    assert got.bvh_tables is not None and got.kernel is None and got.mesh is not None
    assert got.fastinfo.mesh_ok and not want.fastinfo.mesh_ok
    assert_builder_tables_equal(got, want, bvh_backend)
    flat = build(SceneBuilder, tgeom, accelerator="none", device="cpu")
    assert flat.bvh is None and "bvh.node_lo" not in scene_to_arrays(flat)
    n = 64
    o = torch.stack([torch.linspace(-3.0, 195.0, n), torch.full((n,), 4.0),
                     torch.full((n,), 6.0)], dim=-1)
    d = torch.nn.functional.normalize(torch.tensor([0.0, -1.0, -1.5]).expand(n, 3), dim=-1)
    args = (o, d.contiguous(), torch.arange(n), torch.zeros(n, dtype=torch.int64), 3,
            tint.PathConfig(max_depth=3))
    bvh_l = tint._li_wavefront(got, *args)
    torch.testing.assert_close(bvh_l, tint._li_wavefront(flat, *args))
    assert float(bvh_l.amax()) > 0.0


def test_tables_compare_like_with_like_after_the_reference_loader_failed(monkeypatch):
    """The state the reference loader's race leaves in a worker: its
    library failed to load, so JAX builds every tree with NumPy for the
    rest of the process.  ``match_bvh_backend`` then has the port build
    with NumPy too, and the 65-sphere scene's tables, the tree included,
    compare NumPy's tree with NumPy's and agree."""
    monkeypatch.setattr(jnative, "_lib_failed", True)
    monkeypatch.setattr(jnative, "_lib", None)
    assert match_bvh_backend(monkeypatch) == "numpy"
    want = _spheres_65(JaxBuilder, jgeom)
    got = _spheres_65(SceneBuilder, tgeom, device="cpu")
    assert got.bvh_tables.backend == "numpy"
    assert_builder_tables_equal(got, want, "numpy")


def test_power_light_strategy_raises(bvh_backend):
    """The power distribution and the spatial light grid build the JAX
    builder's tables."""
    def build(cls, strategy, **kw):
        b = cls(light_strategy=strategy)
        b.sphere(np.eye(4), 1.0, b.matte())
        b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
        b.distant_light(direction=(0.0, 1.0, 0.0), radiance=(0.2, 0.2, 0.2))
        return b.build(**kw)

    for strategy in ("power", "spatial"):
        want = build(JaxBuilder, strategy, accelerator="none")
        got = build(SceneBuilder, strategy, device="cpu")
        assert_builder_tables_equal(got, want, bvh_backend)
        assert (got.light_grid is not None) == (strategy == "spatial")
