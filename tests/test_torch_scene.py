"""The port's SceneBuilder and scene_from_arrays against gopbrt_tpu's."""

from dataclasses import asdict

import numpy as np
import pytest

from _torch_parity import (assert_tables_equal, carry, jax_scene_arrays,
                           jax_scene_infos, rough_glass_scene)
from gopbrt_tpu.models import demo as jdemo
from gopbrt_tpu.models import gallery
from gopbrt_tpu.models.scene import SceneBuilder as JaxBuilder
from gopbrt_tpu.ops import geom as jgeom
from gopbrt_tpu_torch.models import demo as tdemo
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
    b = SceneBuilder()
    m = b.matte()
    for i in range(65):
        b.sphere(tgeom.translate([3.0 * i, 0.0, 0.0]), 1.0, m)
    b.point_light(p=(0.0, 5.0, 0.0), intensity=(1.0, 1.0, 1.0))
    with pytest.raises(NotImplementedError, match="BVH"):
        b.build(device="cpu")


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
