"""What decides ``correct``: a frame of the window against the plain reference.

The reference (``reference/``, a frozen copy of the program's plain PyTorch
code, and ``configs/<config>.py``, the configuration's scene on it) builds
its own scene tables and tree from the configuration, traces the frame's
camera rays with the frame's seed, splats them with the same box filter and
develops them.  It runs in row bands, after the window, on the program's
device once the program's state is freed.

The number compared is ``px_off``: the share of the compared pixels where
any channel of the program's developed image differs from the reference's
by more than the cell's ``pixel_tol`` (``checks/<cell>.json``).  The paths
of the two agree lane for lane but where rounding turns a decision (a
roulette draw, a hit at a silhouette), so a sound frame reads a small
share; a frame rendered wrong, or in a lower precision, reads a large one.

The controls (``lowp``) are the reference with tensors between its stages
held in bfloat16, the nearest precision below the float32 that the
configuration states: ``"radiance"`` rounds each sample's radiance before
the splat, ``"rays_and_radiance"`` the camera rays' directions before the
integrator as well.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

from reference.models import film as ref_film
from reference.models import integrators as ref_int
from reference.models import render as ref_render
from reference.ops import megakernel as ref_mk
from reference.ops import mesh_megakernel as ref_mesh

HERE = Path(__file__).resolve().parent
CONTROLS = ("radiance", "rays_and_radiance")


def load_module(path: Path):
    """A module of the benchmark loaded from its file (its name may hold
    dots, as a metric's does)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_inputs(config: dict, settings: dict, device):
    """The reference's scene and camera of a configuration, built by its
    own ``configs/<name>.py``."""
    mod = load_module(HERE / "configs" / f"{config['name']}.py")
    kw = config.get("kwargs", {})
    scene = mod.build_scene(device=device, **kw)
    camera = mod.build_camera(settings["width"], settings["height"], device=device)
    return scene, camera


def fast_path(scene):
    """The reference's bounce intersector where its ``li`` traces paths with
    ``path_li_plain`` ("brute" or "bvh"), else None."""
    fi = scene.fastinfo
    if fi is None or scene.prims.anim is not None:
        return None
    if fi.ok and scene.prims.count <= ref_int.BRUTE_FORCE_CUTOFF:
        return "brute"
    return "bvh" if ref_mesh.fits(scene) else None


def _radiance(scene, camera, s, o, d, pixel, sample, counts):
    if s.integrator == "path" and counts is not None:
        accel = fast_path(scene)
        if accel is None:
            raise ValueError("events are counted on the bounce kernels' scenes only")
        return ref_mk.path_li_plain(scene, o, d, pixel, sample, s.seed,
                                    ref_render.path_config(s),
                                    cone=ref_render._cone(camera, s), counts=counts,
                                    accel=accel)
    return ref_render._radiance(scene, o, d, pixel, sample, camera, s)


def reference_rows(scene, camera, settings: dict, seed: int, rows: tuple, counts=None,
                   lowp: str | None = None) -> np.ndarray:
    """The reference's developed image rows [r0, r1) of the frame of
    ``seed``: every sample of the rows they gather from (the filter's
    reach around them), band by band -> f32[r1-r0, W, 3] on the host.
    counts: a dict that gets the events of ``path_li_plain``, summed over
    the lanes traced; lowp: one of CONTROLS, or None."""
    if lowp not in (None,) + CONTROLS:
        raise ValueError(f"no control {lowp!r}")
    s = ref_render.RenderSettings(**settings, seed=seed)
    r0, r1 = rows
    reach = int(math.ceil(s.filter.radius))
    lo, hi = max(0, r0 - reach), min(s.height, r1 + reach)
    dev = scene.device
    film = ref_film.new_film(s.width, s.height, device=dev)
    band = max(1, min(s.chunk_pixels // s.width, hi - lo))
    n_passes = math.ceil(s.spp / s.samples_per_pass)
    with torch.no_grad():
        for p in range(n_passes):
            for b0 in range(lo, hi, band):
                n = min(band, hi - b0)
                for k in range(s.samples_per_pass):
                    jitter, o, d, pixel, sample = ref_render.band_rays(
                        camera, s, b0, n, p * s.samples_per_pass + k)
                    if lowp == "rays_and_radiance":
                        d = d.to(torch.bfloat16).to(torch.float32)
                    L = _radiance(scene, camera, s, o, d, pixel, sample, counts)
                    if lowp:
                        L = L.to(torch.bfloat16).to(torch.float32)
                    film = ref_film.add_samples_rows(film, b0, jitter.reshape(n, s.width, 2),
                                                     L.reshape(n, s.width, 3), s.filter)
        img = ref_film.develop(film)[r0:r1]
    return img.cpu().numpy()


def px_off(got: np.ndarray, ref: np.ndarray, tol: float) -> float:
    """The share of pixels where a channel differs by more than ``tol``
    (a NaN differs)."""
    if got.shape != ref.shape:
        return 1.0
    close = np.abs(got.astype(np.float64) - ref.astype(np.float64)) <= tol
    return float(1.0 - close.all(axis=-1).mean())
