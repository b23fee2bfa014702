"""Render driver: row bands of one sample per pixel, splatted into a film.

Counterpart of ``gopbrt_tpu/models/render.py``: ``RenderSettings``,
``camera_samples`` (stratified, random or Halton), ``camera_time``,
``render_wave`` (explicit pixel-sample lanes, splatted by scatter),
``band_jitter_radiance``, ``render_wave_rows``, ``render_pass``, the crop
window (``crop_pixel_bounds``, ``_render_pass_crop``) and ``render`` with
its progress callback and checkpoint / resume.  Where the JAX render loop scans
the bands under ``jit``, this one is a Python loop: one ``li`` (path) or
``li_direct`` (direct lighting) call per band.  Each ``render`` call is
one request of the tracer (``utils/trace.py``, span ``render.request``),
and each band's three stages run in its spans ``render.band_rays``,
``render.li`` and ``render.splat``, which a ``torch.profiler`` trace shows
as ranges.
"""

from __future__ import annotations

import math
import os
import zipfile
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gopbrt_tpu_torch import resolve_device
from gopbrt_tpu_torch.models import camera as cam_mod
from gopbrt_tpu_torch.models import film as film_mod
from gopbrt_tpu_torch.models import integrators
from gopbrt_tpu_torch.ops import rng, sampling
from gopbrt_tpu_torch.ops.filters import Filter, box_filter
from gopbrt_tpu_torch.utils import trace


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
    # "stratified", "random", or "halton": Halton (2, 3) over the sample
    # index, Cranley-Patterson rotated per pixel (render.py:45-50)
    sampler: str = "stratified"
    filter: Filter = box_filter(1.0)
    samples_per_pass: int = 1
    # wavefront compaction in the path integrator (PathConfig.compaction);
    # off by default, as in the reference
    compaction: bool = False
    # filtered checker lookups from the per-ray cone footprint, scaled by
    # 1/sqrt(spp) (ScaleDifferentials, integrator.go:246-247)
    texture_aa: bool = True
    # crop window ((x0, y0), (x1, y1)) in fractions of the film (film.go:
    # 42-59): only its pixels are sampled and developed; None = full film
    crop: Optional[tuple] = None
    # pixels per launch: bounds the per-launch state (render.py:65-69)
    chunk_pixels: int = 1 << 19


def camera_samples(settings: RenderSettings, pixel_idx, sample_idx, seed):
    """CameraSample generation (Sampler.GetCameraSample, sampler.go:19-25):
    jittered film position + lens sample from the counter streams."""
    w = settings.width
    px = (pixel_idx % w).to(torch.float32)
    py = (pixel_idx // w).to(torch.float32)
    mode = settings.sampler if settings.stratify else "random"
    if mode == "halton":
        # Halton (2, 3) over the sample index, rotated per pixel by the
        # pixel's stream at sample 0 (render.py:77-88)
        h0 = sampling.radical_inverse_base2(sample_idx)
        h1 = sampling.radical_inverse(1, sample_idx)
        r = rng.sample_2d(seed, pixel_idx, 0, rng.DIM_CAMERA)
        jitter = torch.stack([torch.fmod(h0 + r[..., 0], 1.0),
                              torch.fmod(h1 + r[..., 1], 1.0)], dim=-1)
    elif mode == "stratified":
        nx = int(np.floor(np.sqrt(settings.spp))) or 1
        ny = max(settings.spp // nx, 1)
        jitter = rng.stratified_2d(seed, pixel_idx, sample_idx, rng.DIM_CAMERA, nx, ny)
    elif mode == "random":
        jitter = rng.sample_2d(seed, pixel_idx, sample_idx, rng.DIM_CAMERA)
    else:
        raise ValueError(f"unknown sampler {mode!r}")
    p_film = torch.stack([px, py], dim=-1) + jitter
    u_lens = rng.sample_2d(seed, pixel_idx, sample_idx, rng.DIM_CAMERA + 2)
    return p_film, u_lens


def camera_time(camera: cam_mod.Camera, pixel_idx, sample_idx, seed) -> torch.Tensor:
    """Each ray's shutter time (CameraSample.Time, sampler.go:19-25):
    uniform in [shutter_open, shutter_close] from the fifth camera
    dimension."""
    u_t = rng.sample_1d(seed, pixel_idx, sample_idx, rng.DIM_CAMERA + 4)
    return camera.shutter_open + u_t * (camera.shutter_close - camera.shutter_open)


def _time(scene, camera, pixel_idx, sample_idx, settings: RenderSettings):
    """The rays' shutter times where the scene moves, else None."""
    if scene.prims.anim is None:
        return None
    return camera_time(camera, pixel_idx, sample_idx, settings.seed)


def _cone(camera: cam_mod.Camera, settings: RenderSettings):
    if not settings.texture_aa:
        return None
    w0, spread = cam_mod.pixel_spread(camera)
    s = np.float32(1.0 / float(np.sqrt(max(settings.spp, 1))))
    return float(np.float32(w0) * s), float(np.float32(spread) * s)


def _radiance(scene, o, d, pixel, sample, camera, settings: RenderSettings):
    """Radiance of the rays under the settings' integrator."""
    time = _time(scene, camera, pixel, sample, settings)
    if settings.integrator == "direct":
        return integrators.li_direct(scene, o, d, pixel, sample, settings.seed,
                                     max_depth=settings.max_depth,
                                     cone=_cone(camera, settings),
                                     light_strategy=settings.light_strategy, time=time)
    if settings.integrator != "path":
        raise ValueError(f"unknown integrator {settings.integrator!r}")
    return integrators.li(scene, o, d, pixel, sample, settings.seed,
                          path_config(settings), cone=_cone(camera, settings), time=time)


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
                                  rr_threshold=settings.rr_threshold,
                                  compaction=settings.compaction)


def band_jitter_radiance(scene, camera: cam_mod.Camera, settings: RenderSettings,
                         row0: int, n_rows: int, sample_idx: int):
    """One sample for every pixel of the band of ``n_rows`` image rows from
    ``row0`` -> (jitter f32[rows,W,2], L f32[rows,W,3])."""
    if settings.integrator not in ("path", "direct"):
        raise ValueError(f"unknown integrator {settings.integrator!r}")
    with trace.span("render.band_rays"):
        jitter, o, d, pixel, sample = band_rays(camera, settings, row0, n_rows,
                                                sample_idx)
    with trace.span("render.li"):
        L = _radiance(scene, o, d, pixel, sample, camera, settings)
    w = settings.width
    return jitter.reshape(n_rows, w, 2), L.reshape(n_rows, w, 3)


def render_wave_rows(scene, camera, film: film_mod.Film, settings: RenderSettings,
                     row0: int, n_rows: int, sample_idx: int) -> film_mod.Film:
    """Render a band of rows (one sample per pixel) and splat it; rows past
    the image (last band) are traced and dropped by the splat."""
    jitter, L = band_jitter_radiance(scene, camera, settings, row0, n_rows, sample_idx)
    with trace.span("render.splat"):
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
    w, h = settings.width, settings.height
    chunk = settings.chunk_pixels or (w * h)
    band_rows = max(1, min(chunk // w, h))
    for r0 in range(0, h, band_rows):
        for s in range(settings.samples_per_pass):
            film = render_wave_rows(scene, camera, film, settings, r0, band_rows,
                                    int(sample_base) + s)
    return film


def crop_pixel_bounds(settings: RenderSettings):
    """CroppedPixelBounds (film.go:53-59): the crop's pixels [x0, x1) x
    [y0, y1), the bounds rounded up, in Python floats as the reference."""
    (cx0, cy0), (cx1, cy1) = settings.crop
    w, h = settings.width, settings.height
    x0 = int(np.ceil(w * cx0))
    x1 = min(int(np.ceil(w * cx1)), w)
    y0 = int(np.ceil(h * cy0))
    y1 = min(int(np.ceil(h * cy1)), h)
    if not (x1 > x0 and y1 > y0):
        raise ValueError(f"empty crop window {settings.crop}")
    return x0, x1, y0, y1


def _render_pass_crop(scene, camera: cam_mod.Camera, film: film_mod.Film,
                      settings: RenderSettings, sample_base: int = 0,
                      device=None) -> film_mod.Film:
    """One pass over the crop window's pixels only, one ``render_wave`` of
    them a sample (the scatter splat; taps outside the film drop).  Pixel
    ids stay global, so the crop draws the same streams as the same region
    of the full render (render.py:274-297)."""
    device = resolve_device(device)
    _check_device("the scene", scene.device, device)
    x0, x1, y0, y1 = crop_pixel_bounds(settings)
    xs = torch.arange(x0, x1, device=device)[None, :]
    ys = torch.arange(y0, y1, device=device)[:, None]
    pixel_idx = (ys * settings.width + xs).reshape(-1)
    for s in range(settings.samples_per_pass):
        sample_idx = torch.full_like(pixel_idx, int(sample_base) + s)
        film = render_wave(scene, camera, film, settings, pixel_idx, sample_idx)
    return film


def render(scene, camera: cam_mod.Camera, settings: RenderSettings,
           progress: Optional[Callable[[int, int], None]] = None,
           checkpoint_path: Optional[str] = None, checkpoint_every: int = 1,
           device=None) -> torch.Tensor:
    """Full render: passes of ``samples_per_pass`` spp (over the crop
    window where one is set), then ``develop`` -> the image f32[H,W,3] in
    [0,1] (the crop's pixels only) on ``device`` (None = the card).

    progress(done, total) is called after each pass.  checkpoint_path: the
    film and the next pass are saved there atomically every
    ``checkpoint_every`` passes and after the last, and a render resumes
    from a checkpoint of the same settings (render.py:300-381).  The call
    is one request of the tracer (``utils/trace.request``).
    """
    with trace.request():
        device = resolve_device(device)
        film = film_mod.new_film(settings.width, settings.height, device=device)
        n_passes = math.ceil(settings.spp / settings.samples_per_pass)
        start = 0
        if checkpoint_path is not None:
            ck = _load_checkpoint(checkpoint_path, settings, device)
            if ck is not None:
                film, start = ck
        pass_fn = render_pass if settings.crop is None else _render_pass_crop
        for p in range(start, n_passes):
            film = pass_fn(scene, camera, film, settings, p * settings.samples_per_pass,
                           device=device)
            if checkpoint_path is not None and (
                    (p + 1) % max(checkpoint_every, 1) == 0 or p + 1 == n_passes):
                _save_checkpoint(checkpoint_path, settings, film, p + 1)
            if progress is not None:
                trace.synchronize(film.rgb.device)
                progress(p + 1, n_passes)
        img = film_mod.develop(film)
        if settings.crop is not None:
            x0, x1, y0, y1 = crop_pixel_bounds(settings)
            img = img[y0:y1, x0:x1]
        return img


def _checkpoint_key(settings: RenderSettings) -> str:
    """The settings' fingerprint: a checkpoint resumes only the same render
    (the reference's key, render.py:346-350)."""
    return repr((settings.width, settings.height, settings.spp,
                 settings.max_depth, settings.seed, settings.integrator,
                 settings.sampler, settings.samples_per_pass))


def _save_checkpoint(path: str, settings: RenderSettings, film: film_mod.Film,
                     next_pass: int) -> None:
    """The film and the next pass as an npz (the reference's fields rgb,
    weight, next_pass and key), written beside ``path`` and moved over it
    with ``os.replace``."""
    tmp = path + ".tmp"
    np.savez(tmp, rgb=trace.to_host(film.rgb.detach()).numpy(),
             weight=trace.to_host(film.weight.detach()).numpy(), next_pass=np.int64(next_pass),
             key=np.array(_checkpoint_key(settings)))
    # np.savez appends .npz to a name without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def _load_checkpoint(path: str, settings: RenderSettings, device=None):
    """(film on ``device``, next pass) from a checkpoint of the same
    settings, else None (no file, another key, or an unreadable one)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) != _checkpoint_key(settings):
                return None
            film = film_mod.Film(rgb=trace.to_card(z["rgb"], device),
                                 weight=trace.to_card(z["weight"], device))
            return film, int(z["next_pass"])
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None
