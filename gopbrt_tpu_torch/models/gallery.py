"""The BASELINE benchmark scenes (configs 1-4) on the port's builder.

Counterpart of ``gopbrt_tpu/models/gallery.py``:

  1. the demo scene with the direct-lighting integrator, depth 3;
  2. a Cornell-style box: matte walls and a mirror sphere, path depth 5;
  3. a triangle mesh (1,104 triangles) under the SAH BVH, textured matte
     and plastic, path depth 3;
  4. area lights, MIS and smooth glass, path depth 8.

Each builder returns (scene, camera, settings) with the tables on
``device`` (None = the card).  Configs 1, 2 and 4 build no BVH, as the JAX
ones do (accelerator="none").
"""

from __future__ import annotations

from gopbrt_tpu_torch.models import camera as cam_mod
from gopbrt_tpu_torch.models.render import RenderSettings
from gopbrt_tpu_torch.models.scene import SceneBuilder
from gopbrt_tpu_torch.ops import geom


def config1(width=96, height=54, device=None):
    """Demo scene + direct lighting (BASELINE config 1)."""
    from gopbrt_tpu_torch.models.demo import build_demo_camera, build_demo_scene

    settings = RenderSettings(width=width, height=height, spp=8, max_depth=3,
                              integrator="direct", samples_per_pass=4, seed=11)
    return (build_demo_scene(device=device),
            build_demo_camera(width, height, device=device), settings)


def config2(width=64, height=64, device=None):
    """Cornell-style box: matte walls + mirror sphere, path depth 5."""
    b = SceneBuilder()
    white = b.matte(kd=(0.73, 0.73, 0.73))
    red = b.matte(kd=(0.65, 0.05, 0.05))
    green = b.matte(kd=(0.12, 0.45, 0.15))
    # box walls as big disks, normals facing inward
    b.disk(geom.matmul(geom.translate([0, 0, 0]), geom.rotate_x(-90.0)), 8.0, white)
    b.disk(geom.matmul(geom.translate([0, 4, 0]), geom.rotate_x(90.0)), 8.0, white)
    b.disk(geom.translate([0, 2, -2.0]), 8.0, white)
    b.disk(geom.matmul(geom.translate([-2, 2, 0]), geom.rotate_y(90.0)), 8.0, red)
    b.disk(geom.matmul(geom.translate([2, 2, 0]), geom.rotate_y(-90.0)), 8.0, green)
    b.sphere(geom.translate([-0.7, 0.7, -0.6]), 0.7, b.mirror(kr=(0.9, 0.9, 0.9)))
    b.sphere(geom.translate([0.9, 0.5, 0.2]), 0.5, b.matte(kd=(0.5, 0.5, 0.7)))
    lamp = b.sphere(geom.translate([0.0, 3.6, 0.0]), 0.35, b.matte(kd=(0.0, 0.0, 0.0)))
    b.area_light(lamp, radiance=(22.0, 22.0, 22.0), two_sided=False)
    cam = cam_mod.perspective_camera(
        geom.look_at([0.0, 2.0, 5.2], [0.0, 1.6, 0.0], [0.0, 1.0, 0.0]),
        width, height, fov_deg=55.0, device=device,
    )
    settings = RenderSettings(width=width, height=height, spp=16, max_depth=5,
                              integrator="path", samples_per_pass=4, seed=7)
    return b.build(accelerator="none", device=device), cam, settings


def config3(width=64, height=36, device=None):
    """Triangle mesh under the SAH BVH, textured matte + plastic
    (gallery.py:69-79): 1,104 triangles, above the brute-force cutoff."""
    from gopbrt_tpu_torch.models.meshes import build_mesh_scene, mesh_camera

    settings = RenderSettings(width=width, height=height, spp=8, max_depth=3,
                              integrator="path", samples_per_pass=4, seed=5)
    return (build_mesh_scene(n_lat=24, n_lon=24, device=device),
            mesh_camera(width, height, device=device), settings)


def config4(width=64, height=64, device=None):
    """Area lights + MIS + smooth glass, depth 8 (BASELINE config 4)."""
    b = SceneBuilder()
    checker = b.checkerboard_texture((0.8, 0.8, 0.8), (0.2, 0.2, 0.2),
                                     vs=(0.7, 0.0, 0.0), vt=(0.0, 0.0, 0.7),
                                     mapping="planar")
    b.disk(geom.rotate_x(-90.0), 60.0, b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker))
    glass = b.glass(kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5)
    b.sphere(geom.translate([0.0, 1.2, 0.0]), 1.2, glass)
    b.sphere(geom.translate([2.4, 0.8, -1.4]), 0.8, b.matte(kd=(0.7, 0.3, 0.2)))
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    l1 = b.sphere(geom.translate([-2.5, 4.0, 2.0]), 0.5, dark)
    b.area_light(l1, radiance=(30.0, 28.0, 24.0), two_sided=False)
    l2 = b.sphere(geom.translate([3.0, 5.0, 3.5]), 1.2, dark)
    b.area_light(l2, radiance=(4.0, 5.0, 7.0), two_sided=False)
    cam = cam_mod.perspective_camera(
        geom.look_at([0.0, 2.4, 6.5], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
        width, height, fov_deg=45.0, device=device,
    )
    settings = RenderSettings(width=width, height=height, spp=16, max_depth=8,
                              integrator="path", samples_per_pass=4, seed=3)
    return b.build(accelerator="none", device=device), cam, settings


CONFIGS = {
    "config1_demo_direct": config1,
    "config2_cornell_mirror": config2,
    "config3_mesh_bvh": config3,
    "config4_arealights_glass": config4,
}
