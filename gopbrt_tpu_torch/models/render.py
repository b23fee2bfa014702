"""Render driver: row bands of one sample per pixel, splatted into a film.

Counterpart of ``gopbrt_tpu/models/render.py``: ``RenderSettings``,
``camera_samples``, ``render_wave`` (explicit pixel-sample lanes, splatted
by scatter), ``band_jitter_radiance``, ``render_wave_rows``,
``render_pass`` and ``render``.  Where the JAX driver scans the bands under
``jit``, this one is a Python loop: one ``li`` (path) or ``li_direct``
(direct lighting) call per band.  Crop windows, checkpoints, the Halton
sampler and filters other than the box are a later slice and raise.  Each
band's three stages run inside profiler ranges (``render.band_rays``,
``render.li``, ``render.splat``) that a ``torch.profiler`` trace shows.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from gopbrt_tpu_torch import resolve_device
from gopbrt_tpu_torch.models import camera as cam_mod
from gopbrt_tpu_torch.models import film as film_mod
from gopbrt_tpu_torch.models import integrators
from gopbrt_tpu_torch.ops import rng
from gopbrt_tpu_torch.ops.filters import Filter, box_filter


class RenderSettings(NamedTuple):
    """Render configuration (the knobs hardcoded in server.go:136-164)."""

    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 5
    rr_threshold: float = 1.0
    seed: int = 0
    integrator: str = "path"  # or "direct"
    # NEE light strategy of the direct integrator: "one" =
    # UniformSampleOneLight, "all" = every light at every vertex
    # (directlighting.go:10-15, integrator.go:23-46)
    light_strategy: str = "one"
    stratify: bool = True
    sampler: str = "stratified"  # or "random"
    filter: Filter = box_filter(1.0)
    samples_per_pass: int = 1
    # filtered checker lookups from the per-ray cone footprint, scaled by
    # 1/sqrt(spp) (ScaleDifferentials, integrator.go:246-247)
    texture_aa: bool = True
    crop: Optional[tuple] = None
    # pixels per launch: bounds the per-launch state (render.py:65-69)
    chunk_pixels: int = 1 << 19


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to gopbrt_tpu_torch yet (ROADMAP open item 1.7)"
    )


def camera_samples(settings: RenderSettings, pixel_idx, sample_idx, seed):
    """CameraSample generation (Sampler.GetCameraSample, sampler.go:19-25):
    jittered film position + lens sample from the counter streams."""
    w = settings.width
    px = (pixel_idx % w).to(torch.float32)
    py = (pixel_idx // w).to(torch.float32)
    mode = settings.sampler if settings.stratify else "random"
    if mode == "stratified":
        nx = int(np.floor(np.sqrt(settings.spp))) or 1
        ny = max(settings.spp // nx, 1)
        jitter = rng.stratified_2d(seed, pixel_idx, sample_idx, rng.DIM_CAMERA, nx, ny)
    elif mode == "random":
        jitter = rng.sample_2d(seed, pixel_idx, sample_idx, rng.DIM_CAMERA)
    else:
        _not_ported(f"the {mode!r} sampler")
    p_film = torch.stack([px, py], dim=-1) + jitter
    u_lens = rng.sample_2d(seed, pixel_idx, sample_idx, rng.DIM_CAMERA + 2)
    return p_film, u_lens


def _cone(camera: cam_mod.Camera, settings: RenderSettings):
    if not settings.texture_aa:
        return None
    w0, spread = cam_mod.pixel_spread(camera)
    s = np.float32(1.0 / float(np.sqrt(max(settings.spp, 1))))
    return float(np.float32(w0) * s), float(np.float32(spread) * s)


def _radiance(scene, o, d, pixel, sample, camera, settings: RenderSettings):
    """Radiance of the rays under the settings' integrator."""
    if settings.integrator == "direct":
        return integrators.li_direct(scene, o, d, pixel, sample, settings.seed,
                                     max_depth=settings.max_depth,
                                     cone=_cone(camera, settings),
                                     light_strategy=settings.light_strategy)
    if settings.integrator != "path":
        raise ValueError(f"unknown integrator {settings.integrator!r}")
    return integrators.li(scene, o, d, pixel, sample, settings.seed,
                          path_config(settings), cone=_cone(camera, settings))


def render_wave(scene, camera: cam_mod.Camera, film: film_mod.Film,
                settings: RenderSettings, pixel_idx: torch.Tensor,
                sample_idx: torch.Tensor) -> film_mod.Film:
    """Render one wavefront, a lane per (pixel, sample) pair given as int64
    counters, and splat it with ``film.add_samples`` (render.py:120-156).
    Out of place: returns a new film, differentiable with respect to the
    scene's tensors that the integrator reads."""
    p_film, u_lens = camera_samples(settings, pixel_idx, sample_idx, settings.seed)
    o, d = cam_mod.generate_rays(camera, p_film, u_lens)
    L = _radiance(scene, o, d, pixel_idx, sample_idx, camera, settings)
    return film_mod.add_samples(film, p_film, L, settings.filter)


def band_rays(camera: cam_mod.Camera, settings: RenderSettings, row0: int,
              n_rows: int, sample_idx: int):
    """Camera rays of one sample for every pixel of the band of ``n_rows``
    image rows from ``row0`` -> (jitter f32[N,2], o, d f32[N,3], pixel,
    sample int64[N]), lanes in image order."""
    w = settings.width
    dev = camera.raster_to_camera.device
    y = row0 + torch.arange(n_rows, device=dev)[:, None]
    x = torch.arange(w, device=dev)[None, :]
    pixel_idx = (y * w + x).reshape(-1)
    sample_flat = torch.full_like(pixel_idx, sample_idx)
    p_film, u_lens = camera_samples(settings, pixel_idx, sample_flat, settings.seed)
    # jitter relative to the pixel corner
    px = (pixel_idx % w).to(torch.float32)
    py = (pixel_idx // w).to(torch.float32)
    jitter = p_film - torch.stack([px, py], dim=-1)
    o, d = cam_mod.generate_rays(camera, p_film, u_lens)
    return jitter, o, d, pixel_idx, sample_flat


def path_config(settings: RenderSettings) -> integrators.PathConfig:
    return integrators.PathConfig(max_depth=settings.max_depth,
                                  rr_threshold=settings.rr_threshold)


def band_jitter_radiance(scene, camera: cam_mod.Camera, settings: RenderSettings,
                         row0: int, n_rows: int, sample_idx: int):
    """One sample for every pixel of the band of ``n_rows`` image rows from
    ``row0`` -> (jitter f32[rows,W,2], L f32[rows,W,3])."""
    if settings.integrator not in ("path", "direct"):
        raise ValueError(f"unknown integrator {settings.integrator!r}")
    with record_function("render.band_rays"):
        jitter, o, d, pixel, sample = band_rays(camera, settings, row0, n_rows,
                                                sample_idx)
    with record_function("render.li"):
        L = _radiance(scene, o, d, pixel, sample, camera, settings)
    w = settings.width
    return jitter.reshape(n_rows, w, 2), L.reshape(n_rows, w, 3)


def render_wave_rows(scene, camera, film: film_mod.Film, settings: RenderSettings,
                     row0: int, n_rows: int, sample_idx: int) -> film_mod.Film:
    """Render a band of rows (one sample per pixel) and splat it; rows past
    the image (last band) are traced and dropped by the splat."""
    jitter, L = band_jitter_radiance(scene, camera, settings, row0, n_rows, sample_idx)
    with record_function("render.splat"):
        return film_mod.add_samples_rows(film, row0, jitter, L, settings.filter)


def _check_device(what: str, have: torch.device, want: torch.device):
    if have.type != want.type or (want.index is not None and have.index != want.index):
        raise ValueError(f"{what} lies on {have}, the render runs on {want}")


def render_pass(scene, camera: cam_mod.Camera, film: film_mod.Film,
                settings: RenderSettings, sample_base: int = 0,
                device=None) -> film_mod.Film:
    """One full-image pass of ``samples_per_pass`` spp over row bands of
    ``chunk_pixels``, accumulated into ``film`` (in place; returned)."""
    device = resolve_device(device)
    _check_device("the scene", scene.device, device)
    _check_device("the camera", camera.raster_to_camera.device, device)
    _check_device("the film", film.rgb.device, device)
    if settings.crop is not None:
        _not_ported("crop windows")
    w, h = settings.width, settings.height
    chunk = settings.chunk_pixels or (w * h)
    band_rows = max(1, min(chunk // w, h))
    for r0 in range(0, h, band_rows):
        for s in range(settings.samples_per_pass):
            film = render_wave_rows(scene, camera, film, settings, r0, band_rows,
                                    int(sample_base) + s)
    return film


def render(scene, camera: cam_mod.Camera, settings: RenderSettings,
           checkpoint_path: Optional[str] = None, device=None) -> torch.Tensor:
    """Full render: passes of ``samples_per_pass`` spp, then ``develop`` —
    the developed image f32[H,W,3] in [0,1] on ``device`` (None = the card)."""
    device = resolve_device(device)
    if checkpoint_path is not None:
        _not_ported("checkpoint / resume")
    film = film_mod.new_film(settings.width, settings.height, device=device)
    n_passes = math.ceil(settings.spp / settings.samples_per_pass)
    for p in range(n_passes):
        film = render_pass(scene, camera, film, settings,
                           p * settings.samples_per_pass, device=device)
    return film_mod.develop(film)
