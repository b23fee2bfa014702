#!/usr/bin/env python3
"""Rehearse chip_smoke.py's option phases on the CPU, at small sizes.

    python3 tools/rehearse.py [path-config] [null-passes] [hlbvh] [goldens]

Runs ``path_config_checks``, ``null_passes_checks``, ``hlbvh_checks`` and
``goldens_checks`` of chip_smoke.py (all four without arguments) on CPU
tensors before a chip call: the kernels' wrappers run their plain
versions there, so each is wrapped to count its launch in
``_build.LAUNCHES``, and so are ``render.band_rays`` and
``film.add_samples_rows``, which take their plain versions on the CPU
(the camera-ray and splat kernels' launches); ``torch.cuda.synchronize``
and ``cuda_ms`` are faked.  Sizes: the demo and the 16x16 mesh at 64x36 in bands of 9 rows,
bounded media at 48x27, the 10,224-triangle mesh's bounds with a 64x9
band; the goldens at their own sizes, but configs 2 and 4 at 8 spp, so
those two miss their goldens and exercise the phase's miss report (the
phase then raises, as it must).  ~2 min on 8 cores.
"""

from __future__ import annotations

import functools
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from gopbrt_tpu_torch import _build  # noqa: E402
from gopbrt_tpu_torch.models import film as film_mod  # noqa: E402
from gopbrt_tpu_torch.models import gallery, meshes, render  # noqa: E402
from gopbrt_tpu_torch.models.demo import (build_demo_camera, build_demo_scene,  # noqa: E402
                                          demo_settings)
from gopbrt_tpu_torch.ops import brute_intersect, bvh, megakernel, mesh_megakernel  # noqa: E402

W, H, BAND_ROWS = 64, 36, 9
DEV = "cpu"
PHASES = ("path-config", "null-passes", "hlbvh", "goldens")


def counted(mod, name: str, key: str) -> None:
    """Wrap ``mod.name`` to count a launch under ``key``, as its kernel would."""
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        _build.LAUNCHES[key] += 1
        return fn(*a, **k)
    setattr(mod, name, wrapped)


def mesh_settings():
    return render.RenderSettings(width=W, height=H, spp=1, max_depth=5, integrator="path",
                                 samples_per_pass=1, chunk_pixels=W * BAND_ROWS)


def main(phases) -> None:
    torch.cuda.synchronize = lambda *a, **k: None
    cs.cuda_ms = lambda fn, reps: (fn(), 0.0)[1]
    for mod, name, key in ((brute_intersect, "intersect_brute_fused", "intersect"),
                           (brute_intersect, "intersect_p_brute_fused", "intersect_any"),
                           (bvh, "bvh_intersect_fused", "bvh_intersect"),
                           (bvh, "bvh_intersect_p_fused", "bvh_intersect_any"),
                           (megakernel, "path_li_fused", "megakernel"),
                           (mesh_megakernel, "mesh_li_fused", "mesh_megakernel"),
                           (render, "band_rays", "camera_rays"),
                           (film_mod, "add_samples_rows", "splat_rows")):
        counted(mod, name, key)
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "path-config":
            settings = demo_settings(W, H, spp=1, samples_per_pass=1)._replace(
                chunk_pixels=W * BAND_ROWS)
            out = cs.path_config_checks(DEV, render, film_mod, (
                ("demo", build_demo_scene(device=DEV), build_demo_camera(W, H, device=DEV),
                 settings, "brute"),
                ("mesh", meshes.build_mesh_scene(n_lat=16, n_lon=16, device=DEV),
                 meshes.mesh_camera(W, H, device=DEV), mesh_settings(), "bvh")), "cpu", "-")
        elif phase == "null-passes":
            gallery.FAMILIES = dict(gallery.FAMILIES, bounded_media=functools.partial(
                gallery.bounded_media, 48, 27))
            out = cs.null_passes_checks(DEV, render, film_mod, "cpu", "-")
        elif phase == "hlbvh":
            settings = mesh_settings()
            _, o, d, pix, smp = render.band_rays(meshes.mesh_camera(W, H, device=DEV), settings,
                                                 BAND_ROWS, BAND_ROWS, 0)
            out = cs.hlbvh_checks(DEV, dict(scene=meshes.build_mesh_scene(device=DEV),
                                            band=(o, d, pix, smp), settings=settings),
                                  "cpu", "-")
        elif phase == "goldens":
            golden_config = gallery.golden_config

            def fewer_samples(name, device=None):
                scene, camera, settings = golden_config(name, device=device)
                if name in gallery.GOLDEN_SETTINGS:
                    settings = settings._replace(spp=8)
                return scene, camera, settings
            gallery.golden_config = fewer_samples
            try:
                out = cs.goldens_checks(DEV, render, "cpu", "-")
            except AssertionError as e:
                out = f"raised, as configs 2 and 4 at 8 spp must: {e}"
        else:
            raise SystemExit(f"unknown phase {phase!r}; the phases are {PHASES}")
        print(f"[rehearse] {phase}: {time.perf_counter() - t0:.1f} s -> {out}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or PHASES)
