"""The tables a launch reads follow the scene it is given.

The kernels read a scene through packed tables (``Scene.brute``,
``Scene.kernel``, ``Scene.mesh``), which the builder makes once.  A scene
made with ``_replace`` (the reference's gradient idiom,
tests/test_grad.py:49-53,68-72) or edited in place must not read its
parent's: ``brute_intersect.scene_table``, ``megakernel.tables_for`` and
``mesh_megakernel.tables_for`` (what the launches and the plain versions
call) give the stored tables while they were packed from the scene's
tensors as they stand, and tables packed from the scene otherwise.  As in
the reference, the mesh kernel's material rows and the BVH are made at
build.
"""

import pytest
import torch

from gopbrt_tpu_torch.models import camera as tcam
from gopbrt_tpu_torch.models import demo as tdemo
from gopbrt_tpu_torch.models import gallery as tgallery
from gopbrt_tpu_torch.models import integrators as tint
from gopbrt_tpu_torch.models import meshes as tmeshes
from gopbrt_tpu_torch.models import render as trender
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import brute_intersect as tbi
from gopbrt_tpu_torch.ops import geom as tgeom
from gopbrt_tpu_torch.ops import megakernel as tmk
from gopbrt_tpu_torch.ops import mesh_megakernel as tmm


def _kd(scene, kd: float):
    return scene._replace(materials=scene.materials._replace(
        kd=torch.full_like(scene.materials.kd, kd)))


def _intensity(scene, scale: float):
    return scene._replace(lights=scene.lights._replace(
        intensity=scene.lights.intensity * scale))


@pytest.fixture(scope="module")
def demo():
    return tdemo.build_demo_scene(device="cpu")


@pytest.mark.parametrize("edit", ["kd", "intensity"])
def test_megakernel_tables_follow_a_replaced_scene(demo, edit):
    """The demo's megakernel tables: a scene with another kd or light
    intensity reads tables packed from it, not its parent's; the parent
    still reads its own, packed by the builder."""
    scene = _kd(demo, 0.25) if edit == "kd" else _intensity(demo, 2.0)
    kt = tmk.tables_for(scene)
    assert torch.equal(kt.tables, tmk.pack_tables(scene))
    assert not torch.equal(kt.tables, demo.kernel.tables)
    assert (kt.func_int, kt.world_radius) == (demo.kernel.func_int, demo.kernel.world_radius)
    assert tmk.tables_for(demo) is demo.kernel
    assert tmk.tables_for(scene._replace(kernel=kt)) is kt


def test_tables_follow_an_edit_in_place():
    """A tensor written in place (its version moves) repacks too."""
    scene = tdemo.build_demo_scene(device="cpu")
    old = scene.kernel
    scene.lights.intensity.mul_(0.5)
    kt = tmk.tables_for(scene)
    assert kt is not old and torch.equal(kt.tables, tmk.pack_tables(scene))
    assert not torch.equal(kt.tables, old.tables)


def test_brute_table_follows_a_moved_prim():
    """Config 1 with a sphere moved: the table the kernels and the plain
    sweeps read is the moved scene's, and the chain's intersections see
    the sphere where it now is."""
    base = tgallery.config1(16, 9, device="cpu")[0]
    move = torch.tensor([0.0, 30.0, 0.0])
    o2w, w2o = base.prims.obj_to_world.clone(), base.prims.world_to_obj.clone()
    o2w[0, :3, 3] += move
    w2o[0, :3, 3] -= move  # a translated sphere: w2o = translate(-centre)
    scene = base._replace(prims=base.prims._replace(obj_to_world=o2w, world_to_obj=w2o))
    table = tbi.scene_table(scene)
    fresh = tbi.brute_table(scene.prims)
    for f in ("ptype", "w2o", "params", "rec", "dead_d2"):
        assert torch.equal(getattr(table, f), getattr(fresh, f)), f
    assert not torch.equal(table.w2o, base.brute.w2o)
    assert tbi.scene_table(base) is base.brute
    # rays from the origin at the sphere's old and new centres
    centre = base.prims.obj_to_world[0, :3, 3]
    o = torch.zeros((2, 3))
    d = torch.nn.functional.normalize(torch.stack([centre, centre + move]), dim=-1)
    t_max = torch.full((2,), 1e30)
    hit_b, _, idx_b = tint._scene_intersect(base, o, d, t_max)
    hit_s, _, idx_s = tint._scene_intersect(scene, o, d, t_max)
    assert hit_b[0] and idx_b[0] == 0 and not (hit_s[0] and idx_s[0] == 0)
    assert hit_s[1] and idx_s[1] == 0
    assert bool(tint._scene_intersect_p(scene, o, d, t_max)[1])


def test_mesh_lights_follow_a_replaced_scene():
    """The 16x16 mesh: a light edit reads light rows packed from the
    scene beside the material rows made at build; a kd edit reads the
    build's tables, as the reference's mesh kernel does (its materials are
    cached in build_mesh_tables)."""
    base = tmeshes.build_mesh_scene(n_lat=16, n_lon=16, device="cpu")
    scene = _intensity(base, 3.0)
    mt = tmm.tables_for(scene)
    want = tmk.pack_layout({"mat": tmk.material_table(base), **tmk.light_parts(scene)},
                           tmm.MESH_TABLE_LAYOUT)
    assert torch.equal(mt.tables, want)
    assert not torch.equal(mt.tables, base.mesh.tables)
    assert mt.mat is base.mesh.mat and tmm.tables_for(base) is base.mesh
    assert tmm.tables_for(_kd(base, 0.1)) is base.mesh


def _ball_and_floor(kd: float):
    b = SceneBuilder()
    b.sphere(tgeom.translate([0.0, 1.0, 0.0]), 1.0, b.matte(kd=(kd, kd, kd)))
    b.disk(tgeom.rotate_x(-90.0), 20.0, b.matte(kd=(kd, kd, kd)))
    b.point_light(p=(2.0, 5.0, 3.0), intensity=(40.0, 40.0, 40.0))
    return b.build(device="cpu")


@pytest.mark.parametrize("integrator", ["path", "direct"])
def test_render_of_a_replaced_scene_is_the_built_scene(integrator):
    """base._replace(materials=kd 0.5) reads the tables of the scene built
    with kd 0.5 (what a launch reads, through ``tables_for`` and
    ``scene_table``) and renders as it, bit for bit, at 32x18 (the
    megakernel's plain twin for path, the brute chain for direct), and not
    as base."""
    cam = tcam.perspective_camera(tgeom.look_at([0.0, 2.0, 6.0], [0.0, 1.0, 0.0],
                                                [0.0, 1.0, 0.0]),
                                  32, 18, fov_deg=50.0, device="cpu")
    settings = trender.RenderSettings(width=32, height=18, spp=1, max_depth=3, seed=3,
                                      integrator=integrator)
    base = _ball_and_floor(0.3)
    assert base.kernel is not None  # on the megakernel's fast path
    scene, built = _kd(base, 0.5), _ball_and_floor(0.5)
    assert torch.equal(tmk.tables_for(scene).tables, built.kernel.tables)
    assert not torch.equal(tmk.tables_for(scene).tables, base.kernel.tables)
    assert torch.equal(tbi.scene_table(scene).rec, built.brute.rec)
    got = trender.render(scene, cam, settings, device="cpu")
    want = trender.render(built, cam, settings, device="cpu")
    assert torch.equal(got, want)
    assert not torch.equal(got, trender.render(base, cam, settings, device="cpu"))
