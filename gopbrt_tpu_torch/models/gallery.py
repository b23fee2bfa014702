"""The BASELINE benchmark scenes (configs 1-4) on the port's builder.

Counterpart of ``gopbrt_tpu/models/gallery.py``:

  1. the demo scene with the direct-lighting integrator, depth 3;
  2. a Cornell-style box: matte walls and a mirror sphere, path depth 5;
  3. a triangle mesh (1,104 triangles) under the SAH BVH, textured matte
     and plastic, path depth 3;
  4. area lights, MIS and smooth glass, path depth 8;
  5. inverse rendering: an image-textured sphere and one area light
     (``config5``, its ground truth ``config5_truth``), path depth 3;

and the six families of the reference's per-family ledger
(``benchmarks/bench_families.py:49-136``, 960x544, 1 spp):
``smooth_glass`` (config 4's scene, depth 8), ``rough_glass`` (depth 8),
``bounded_media`` (a fog ball behind a null boundary, depth 5),
``global_fog`` (depth 5), ``sss`` (a Burley BSSRDF sphere, depth 4) and
``spatial_lights`` (two point lights under the spatial light grid, depth
3).

``golden_config(name)`` gives a config as its golden image renders
(``GOLDEN_SETTINGS``).  Each builder returns (scene, camera, settings)
with the tables on ``device`` (None = the card).  Configs 1, 2 and 4 and
the families build no BVH, as the JAX ones do (accelerator="none").
"""

from __future__ import annotations

import numpy as np

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


def config5_truth():
    """The ground truth of BASELINE config 5 (benchmarks/bench_inverse.py:
    67-72): a smooth RGB gradient as a 16x16 albedo atlas, and a warm lamp
    -> (atlas f32[16,16,3], radiance f32[3]) as NumPy arrays."""
    yy, xx = np.mgrid[0:16, 0:16].astype(np.float32) / 15.0
    atlas = np.stack([0.2 + 0.7 * xx, 0.2 + 0.7 * yy, 0.9 - 0.6 * xx * yy], -1)
    return atlas.astype(np.float32), np.asarray([26.0, 22.0, 18.0], np.float32)


def config5(atlas, radiance, width=64, height=64, device=None):
    """Inverse rendering (BASELINE config 5; the scene of
    benchmarks/bench_inverse.py:37-58): an image-textured sphere (``atlas``,
    uv-mapped) on a matte floor disk under one sphere area light of
    ``radiance``, path depth 3, 64 spp a gradient step."""
    b = SceneBuilder()
    b.disk(geom.rotate_x(-90.0), 40.0, b.matte(kd=(0.4, 0.4, 0.4)))
    tex = b.image_texture(atlas)
    b.sphere(geom.translate([0.0, 1.0, 0.0]), 1.0, b.matte(kd=(1.0, 1.0, 1.0), kd_tex=tex))
    lamp = b.sphere(geom.translate([-2.0, 3.5, 2.0]), 0.5, b.matte(kd=(0.0, 0.0, 0.0)))
    b.area_light(lamp, radiance=tuple(float(x) for x in radiance), two_sided=False)
    cam = cam_mod.perspective_camera(
        geom.look_at([0.0, 1.6, 4.0], [0.0, 0.9, 0.0], [0.0, 1.0, 0.0]),
        width, height, fov_deg=40.0, device=device,
    )
    settings = RenderSettings(width=width, height=height, spp=64, max_depth=3,
                              samples_per_pass=1)
    return b.build(accelerator="none", device=device), cam, settings


def _family_camera(eye, look, width, height, device):
    """The families' camera (bench_families.py:38-45): 45 degrees."""
    return cam_mod.perspective_camera(geom.look_at(list(eye), list(look), [0.0, 1.0, 0.0]),
                                      width, height, fov_deg=45.0, device=device)


def _family_settings(width, height, depth):
    return RenderSettings(width=width, height=height, spp=1, max_depth=depth,
                          integrator="path", samples_per_pass=1)


def smooth_glass(width=960, height=544, device=None):
    """Config 4's scene (area lights, MIS, a smooth-glass sphere) at path
    depth 8 (bench_families.py:49-53)."""
    scene, camera, _ = config4(width, height, device=device)
    return scene, camera, _family_settings(width, height, 8)


def rough_glass(width=960, height=544, device=None):
    """A rough-glass sphere (GGX, roughness 0.15) on a checker floor beside
    a matte ball under a sphere lamp, path depth 8 (bench_families.py:
    56-74)."""
    b = SceneBuilder()
    checker = b.checkerboard_texture((0.8, 0.8, 0.8), (0.2, 0.2, 0.2),
                                     vs=(0.7, 0.0, 0.0), vt=(0.0, 0.0, 0.7),
                                     mapping="planar")
    b.disk(geom.rotate_x(-90.0), 60.0, b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker))
    b.sphere(geom.translate([0.0, 1.2, 0.0]), 1.2, b.glass(roughness=0.15))
    b.sphere(geom.translate([2.4, 0.8, -1.4]), 0.8, b.matte(kd=(0.7, 0.3, 0.2)))
    lamp = b.sphere(geom.translate([-2.5, 4.0, 2.0]), 0.5, b.matte(kd=(0.0, 0.0, 0.0)))
    b.area_light(lamp, radiance=(30.0, 28.0, 24.0), two_sided=False)
    return (b.build(accelerator="none", device=device),
            _family_camera((0, 2.4, 6.5), (0, 1.0, 0), width, height, device),
            _family_settings(width, height, 8))


def bounded_media(width=960, height=544, device=None):
    """A fog ball (a bounded medium behind a null-material sphere), a
    matte floor and ball, a point light and a sphere lamp, path depth 5
    (bench_families.py:77-95)."""
    b = SceneBuilder()
    b.disk(geom.rotate_x(-90.0), 60.0, b.matte(kd=(0.6, 0.6, 0.6)))
    fog = b.add_medium(sigma_a=(0.08,) * 3, sigma_s=(0.4,) * 3, g=0.2)
    ball = b.sphere(geom.translate([0.0, 1.5, 0.0]), 1.5, b.null_material())
    b.set_medium_interface(ball, inside=fog)
    b.sphere(geom.translate([2.4, 0.8, -1.4]), 0.8, b.matte(kd=(0.7, 0.3, 0.2)))
    b.point_light(p=(3.0, 5.0, 3.0), intensity=(80.0,) * 3)
    lamp = b.sphere(geom.translate([-2.5, 4.0, 2.0]), 0.5, b.matte(kd=(0.0, 0.0, 0.0)))
    b.area_light(lamp, radiance=(30.0, 28.0, 24.0), two_sided=False)
    return (b.build(accelerator="none", device=device),
            _family_camera((0, 2.4, 6.5), (0, 1.2, 0), width, height, device),
            _family_settings(width, height, 5))


def global_fog(width=960, height=544, device=None):
    """A global homogeneous medium over a matte floor and ball and a point
    light, path depth 5 (bench_families.py:98-109)."""
    b = SceneBuilder()
    b.set_medium(sigma_a=(0.01,) * 3, sigma_s=(0.02,) * 3, g=0.0)
    b.disk(geom.rotate_x(-90.0), 60.0, b.matte(kd=(0.6, 0.6, 0.6)))
    b.sphere(geom.translate([0.0, 1.0, 0.0]), 1.0, b.matte(kd=(0.7, 0.3, 0.2)))
    b.point_light(p=(3.0, 5.0, 3.0), intensity=(80.0,) * 3)
    return (b.build(accelerator="none", device=device),
            _family_camera((0, 2.4, 6.5), (0, 1.0, 0), width, height, device),
            _family_settings(width, height, 5))


def sss(width=960, height=544, device=None):
    """A subsurface sphere (Burley BSSRDF) on a matte floor under a point
    light, path depth 4 (bench_families.py:112-121)."""
    b = SceneBuilder()
    m = b.subsurface(rho=(0.9, 0.6, 0.3), mfp=(0.3,) * 3, eta=1.33)
    b.sphere(geom.translate([0.0, 1.0, 0.0]), 1.0, m)
    b.disk(geom.rotate_x(-90.0), 20.0, b.matte(kd=(0.4, 0.4, 0.4)))
    b.point_light(p=(3.0, 4.0, 3.0), intensity=(60.0,) * 3)
    return (b.build(accelerator="none", device=device),
            _family_camera((0, 1.5, 4.5), (0, 0.8, 0), width, height, device),
            _family_settings(width, height, 4))


def spatial_lights(width=960, height=544, device=None):
    """A matte floor and ball under a bright and a dim point light, lights
    picked by the spatial light grid, path depth 3 (bench_families.py:
    124-135)."""
    b = SceneBuilder(light_strategy="spatial")
    b.disk(geom.rotate_x(-90.0), 40.0, b.matte(kd=(0.6, 0.6, 0.6)))
    b.sphere(geom.translate([0.0, 1.0, 0.0]), 1.0, b.matte(kd=(0.5, 0.5, 0.7)))
    b.point_light(p=(10.0, 3.0, 0.0), intensity=(300.0,) * 3)
    b.point_light(p=(-10.0, 3.0, 0.0), intensity=(3.0,) * 3)
    return (b.build(accelerator="none", device=device),
            _family_camera((0, 2.4, 8.0), (0, 1.0, 0), width, height, device),
            _family_settings(width, height, 3))


FAMILIES = {
    "smooth_glass": smooth_glass,
    "rough_glass": rough_glass,
    "bounded_media": bounded_media,
    "global_fog": global_fog,
    "sss": sss,
    "spatial_lights": spatial_lights,
}


CONFIGS = {
    "config1_demo_direct": config1,
    "config2_cornell_mirror": config2,
    "config3_mesh_bvh": config3,
    "config4_arealights_glass": config4,
}

# the golden images' settings (tests/goldens): configs 2 and 4 carry the
# multi-bounce MIS and specular math, where an estimator bug hides in Monte
# Carlo noise at low spp, so their goldens render bigger and at 64 spp
GOLDEN_SETTINGS = {
    "config2_cornell_mirror": dict(width=128, height=128, spp=64, samples_per_pass=8),
    "config4_arealights_glass": dict(width=128, height=128, spp=64, samples_per_pass=8),
}


def golden_config(name, device=None):
    """(scene, camera, settings) exactly as the golden images render."""
    ov = GOLDEN_SETTINGS.get(name, {})
    if not ov:
        return CONFIGS[name](device=device)
    scene, cam, settings = CONFIGS[name](ov["width"], ov["height"], device=device)
    return scene, cam, settings._replace(spp=ov["spp"],
                                         samples_per_pass=ov["samples_per_pass"])
