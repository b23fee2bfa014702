"""Shared helpers of the tests that hold gopbrt_tpu_torch against gopbrt_tpu.

Data crosses between the packages as NumPy arrays only.
"""

from __future__ import annotations

import time
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gopbrt_tpu.models import camera as jcam
from gopbrt_tpu.models import render as jrender
from gopbrt_tpu_torch.models.scene import (ARRAY_FIELDS, OPTIONAL_FIELDS, OPTIONAL_GROUPS,
                                           scene_from_arrays, scene_to_arrays, table_of)


def jax_scene_arrays(scene) -> dict:
    """A JAX Scene's tables as NumPy arrays, keyed as ARRAY_FIELDS (the BVH,
    the media, the animation table and the light grid where the scene has
    them) and OPTIONAL_FIELDS (where not None)."""
    out = {}
    for name, fields in ARRAY_FIELDS.items():
        table = table_of(scene, name)
        if table is None and name in OPTIONAL_GROUPS:
            continue
        for f in fields + OPTIONAL_FIELDS.get(name, ()):
            v = getattr(table, f)
            if v is not None:
                out[f"{name}.{f}" if name else f] = np.asarray(v)
    return out


def jax_scene_infos(scene) -> dict:
    return dict(pinfo=asdict(scene.prims.pinfo), minfo=asdict(scene.materials.info),
                fastinfo=asdict(scene.fastinfo), camera_medium=scene.camera_medium)


def jax_bvh_backend() -> str:
    """The builder that the JAX package's ``build_from_bounds(backend="auto")``
    uses in this process: "native" where its loader loaded the library,
    else "numpy".  The loader compiles straight to the library's final
    path, so under xdist a worker can load a file another worker is still
    writing; its failure then sticks for the process
    (gopbrt_tpu/native/__init__.py:44-98) and every JAX tree it builds is
    NumPy's."""
    from gopbrt_tpu import native as jnative

    return "native" if jnative.available() else "numpy"


def match_bvh_backend(monkeypatch) -> str:
    """Make the port's builders build with the JAX side's backend for the
    rest of the test (the NumPy builder: its native library reported
    missing) -> that backend.  A test that compares the two builders'
    trees asserts the port's ``bvh_tables.backend`` equals it first."""
    backend = jax_bvh_backend()
    if backend == "numpy":
        from gopbrt_tpu_torch import native as tnative

        monkeypatch.setattr(tnative, "load", lambda: None)
    return backend


@pytest.fixture
def bvh_backend(monkeypatch) -> str:
    """``match_bvh_backend`` as a fixture."""
    return match_bvh_backend(monkeypatch)


def load_jax_native(tries: int = 40, wait_s: float = 0.25) -> bool:
    """Whether the reference's native builder is loaded in this process,
    loading it again where its loader failed: the library a racing worker
    was writing is complete once it loads, so the loader's failure flag is
    cleared and ``load()`` called again, at most ``tries`` times ``wait_s``
    apart."""
    from gopbrt_tpu import native as jnative

    for _ in range(tries):
        if jnative.load() is not None:
            return True
        time.sleep(wait_s)
        jnative._lib_failed = False
    return jnative.load() is not None


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


def assert_builder_tables_equal(got, want, backend: str, rtol: float = 1e-6):
    """The port builder's Scene ``got`` against the JAX builder's ``want``,
    table for table (``assert_tables_equal``); where the port built a tree,
    first that it built it with ``backend``, the JAX side's
    (``match_bvh_backend``)."""
    if got.bvh_tables is not None:
        assert got.bvh_tables.backend == backend, (got.bvh_tables.backend, backend)
    assert_tables_equal(scene_to_arrays(got), jax_scene_arrays(want), rtol=rtol)


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


def sphere_cloud(builder_cls, geom, n=300, seed=17):
    """A seeded random cloud of ``n`` spheres and no triangle (radii
    log-uniform in [0.02, 0.3], centres uniform in [-2, 2]^3, plastic and
    matte in turn) under two point lights, on a builder of the port's
    SceneBuilder kind (the port's, the benchmark reference's)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-2.0, 2.0, (n, 3))
    radii = np.exp(rng.uniform(np.log(0.02), np.log(0.3), n))
    b = builder_cls()
    mats = (b.plastic(kd=(0.6, 0.3, 0.2), ks=(0.4, 0.4, 0.4), roughness=0.1),
            b.matte(kd=(0.3, 0.5, 0.7)))
    for i, (c, r) in enumerate(zip(centres, radii)):
        b.sphere(np.asarray(geom.translate(c.tolist())), float(r), mats[i % 2])
    b.point_light(p=(4.0, -5.0, 6.0), intensity=(60.0, 60.0, 60.0))
    b.point_light(p=(-5.0, 3.0, 4.0), intensity=(30.0, 30.0, 30.0))
    return b


CLOUD_LOOK_AT = ([0.0, -7.0, 3.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0])


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
