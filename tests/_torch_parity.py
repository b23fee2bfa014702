"""Shared helpers of the tests that hold gopbrt_tpu_torch against gopbrt_tpu.

Data crosses between the packages as NumPy arrays only.
"""

from __future__ import annotations

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import torch

from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import render as jrender
from gopbrt_tpu_torch.models.scene import ARRAY_FIELDS, OPTIONAL_GROUPS, scene_from_arrays


def jax_scene_arrays(scene) -> dict:
    """A JAX Scene's tables as NumPy arrays, keyed as ARRAY_FIELDS (the BVH
    where the scene has one)."""
    out = {}
    for name, fields in ARRAY_FIELDS.items():
        table = getattr(scene, name) if name else scene
        if table is None and name in OPTIONAL_GROUPS:
            continue
        for f in fields:
            out[f"{name}.{f}" if name else f] = np.asarray(getattr(table, f))
    return out


def jax_scene_infos(scene) -> dict:
    return dict(pinfo=asdict(scene.prims.pinfo), minfo=asdict(scene.materials.info),
                fastinfo=asdict(scene.fastinfo))


def carry(scene):
    """The JAX scene as the port's Scene on the CPU (identical tables)."""
    return scene_from_arrays(jax_scene_arrays(scene), jax_scene_infos(scene), "cpu")


def carry_prims(prims):
    """A JAX Primitives table as the port's, on the CPU (identical tables)."""
    from gopbrt_tpu_torch.ops.intersect import Primitives
    from gopbrt_tpu_torch.ops.static_info import PrimInfo

    fields = {f: torch.tensor(np.asarray(getattr(prims, f)))
              for f in ARRAY_FIELDS["prims"]}
    pinfo = None if prims.pinfo is None else PrimInfo(**asdict(prims.pinfo))
    return Primitives(**fields, pinfo=pinfo)


def assert_tables_equal(got: dict, want: dict, rtol: float = 0.0):
    """Ints and bools exact; floats within ``rtol`` relative (0 = exact)."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif rtol == 0.0:
            np.testing.assert_array_equal(g.astype(np.float32), w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0.0, err_msg=k)


def rough_glass_scene(builder_cls, geom):
    """Checker floor + rough-glass sphere + matte ball + sphere lamp
    (tests/test_megakernel.py:61-86), on either package's builder."""
    b = builder_cls()
    checker = b.checkerboard_texture(
        (0.8, 0.8, 0.8), (0.2, 0.2, 0.2),
        vs=(0.7, 0.0, 0.0), vt=(0.0, 0.0, 0.7), mapping="planar",
    )
    floor = b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker)
    b.disk(np.asarray(geom.rotate_x(-90.0)), 60.0, floor)
    rough = b.glass(kr=(1.0, 1.0, 1.0), kt=(1.0, 1.0, 1.0), eta=1.5, roughness=0.15)
    b.sphere(np.asarray(geom.translate([0.0, 1.2, 0.0])), 1.2, rough)
    matte = b.matte(kd=(0.7, 0.3, 0.2))
    b.sphere(np.asarray(geom.translate([2.4, 0.8, -1.4])), 0.8, matte)
    dark = b.matte(kd=(0.0, 0.0, 0.0))
    lamp = b.sphere(np.asarray(geom.translate([-2.5, 4.0, 2.0])), 0.5, dark)
    b.area_light(lamp, radiance=(30.0, 28.0, 24.0), two_sided=False)
    return b


def rough_glass_camera(width=48, height=48):
    from gopbrt_tpu.ops import geom

    return jcam.perspective_camera(
        geom.look_at([0.0, 2.4, 6.5], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
        width, height, fov_deg=45.0,
    )


def camera_rays(camera, width, height, spp, seed):
    """JAX camera rays for every pixel's sample 0 -> (o, d, pixel, sample)."""
    settings = jrender.RenderSettings(width=width, height=height, spp=spp)
    n = width * height
    pixel = jnp.arange(n, dtype=jnp.uint32)
    sample = jnp.zeros((n,), jnp.uint32)
    p_film, u_lens = jrender.camera_samples(settings, pixel, sample, jnp.uint32(seed))
    o, d = jcam.generate_rays(camera, p_film, u_lens)
    return o, d, pixel, sample


def as_torch(*arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def lane_agreement(got: np.ndarray, ref: np.ndarray):
    """(fraction of lanes within 1e-3 relative, relative mean difference)
    — the per-lane bar of tests/test_megakernel.py."""
    diff = np.abs(got - ref).max(axis=-1)
    rel = diff / (1e-3 + np.abs(ref).max(axis=-1))
    mean_rel = abs(got.mean() - ref.mean()) / max(ref.mean(), 1e-6)
    return float(np.mean(rel < 1e-3)), float(mean_rel)
