"""The port's SceneBuilder and scene_from_arrays against gopbrt_tpu's."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from _torch_parity import (assert_tables_equal, carry, jax_scene_arrays,
                           jax_scene_infos, rough_glass_scene)
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
                fastinfo=asdict(scene.fastinfo))


def test_demo_builder_tables_match_jax():
    """Ints exact, floats within 1e-6 relative; static facts equal."""
    want = jdemo.build_demo_scene(accelerator="none")
    got = tdemo.build_demo_scene(device="cpu")
    assert_tables_equal(scene_to_arrays(got), jax_scene_arrays(want), rtol=1e-6)
    assert _port_infos(got) == jax_scene_infos(want)
    assert got.fastinfo.ok and got.prims.count == 24 and got.n_lights == 4


def test_rough_glass_builder_tables_match_jax():
    want = rough_glass_scene(JaxBuilder, jgeom).build(accelerator="none")
    got = rough_glass_scene(SceneBuilder, tgeom).build(device="cpu")
    assert_tables_equal(scene_to_arrays(got), jax_scene_arrays(want), rtol=1e-6)
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


@pytest.mark.parametrize("call", [
    lambda b: b.image_texture(np.zeros((4, 4, 3), np.float32)),
    lambda b: b.subsurface(),
    lambda b: b.matte(bump_tex=0),
    lambda b: b.set_medium((0.1, 0.1, 0.1)),
    lambda b: b.null_material(),
    lambda b: b.animate(b.sphere(np.eye(4), 1.0, b.matte()), np.eye(4)),
])
def test_builder_raises_outside_the_slice(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(SceneBuilder())


def test_scenes_that_need_a_bvh_raise():
    """A scene above 64 prims builds its SAH BVH: its tables, the tree
    included, equal the JAX builder's, and the general chain on the BVH
    walk gives the brute-force chain's radiance."""
    def build(cls, geom, **kw):
        b = cls()
        m = b.matte()
        for i in range(65):
            b.sphere(np.asarray(geom.translate([3.0 * i, 0.0, 0.0])), 1.0, m)
        b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
        return b.build(**kw)

    want = build(JaxBuilder, jgeom)
    got = build(SceneBuilder, tgeom, device="cpu")
    assert_tables_equal(scene_to_arrays(got), jax_scene_arrays(want), rtol=1e-6)
    assert got.bvh_tables is not None and got.kernel is None and got.mesh is None
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


def test_power_light_strategy_raises():
    """The power distribution builds the JAX builder's tables; the spatial
    light grid still raises."""
    def build(cls, strategy, **kw):
        b = cls(light_strategy=strategy)
        b.sphere(np.eye(4), 1.0, b.matte())
        b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
        b.distant_light(direction=(0.0, 1.0, 0.0), radiance=(0.2, 0.2, 0.2))
        return b.build(**kw)

    want = build(JaxBuilder, "power", accelerator="none")
    got = build(SceneBuilder, "power", device="cpu")
    assert_tables_equal(scene_to_arrays(got), jax_scene_arrays(want), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(SceneBuilder, "spatial", device="cpu")
