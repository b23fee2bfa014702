"""Camera rays of one band in one CUDA launch (``csrc/camera_rays.cu``).

``models/render.band_rays`` calls ``camera_rays`` for a camera on the card
and its plain version, ``render.band_rays_plain``, for a camera on the
CPU.  The kernel computes what the plain version computes, a thread a
lane: the counter hash in uint32, the film and lens samples of
``render.camera_samples`` and ``camera.generate_rays``.  Pixel, sample
and jitter are bit-equal to the plain version; o and d agree within a few
ulps, since the plain version's transforms are matrix products in
(cu)BLAS's order.  The kernel is not differentiable.
"""

from __future__ import annotations

import ctypes

import torch

from gopbrt_tpu_torch import _build

# the samplers of render.camera_samples, as csrc/camera_rays.cu numbers them
SAMPLERS = {"stratified": 0, "random": 1, "halton": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
# r2c, c2w, width, row0, col0, cols, n, seed, sample, sampler, nx, ny, kind,
# lens_radius, focal_distance, jitter, o, d, pixel, sample_out
ENTRY = _build.Entry("camera_rays", "gopbrt_camera_rays", "camera_rays",
                     (_P, _P) + (_I,) * 5 + (ctypes.c_uint, ctypes.c_longlong) + (_I,) * 4
                     + (ctypes.c_float,) * 2 + (_P,) * 5)


def on_card(camera) -> bool:
    """Whether ``band_rays`` launches the kernel: the camera lies on a card."""
    return camera.raster_to_camera.device.type == "cuda"


def camera_rays(camera, width: int, row0: int, n_rows: int, sample_idx: int, seed: int,
                sampler: str, nx: int, ny: int, cols=None):
    """Camera rays of sample ``sample_idx`` for every pixel of the band of
    ``n_rows`` rows of an image ``width`` wide from ``row0`` (of the
    columns [x0, x1) of each row where ``cols`` is (x0, x1)), under the
    sampler ``sampler`` (its stratified grid ``nx`` x ``ny``) -> (jitter
    f32[N,2], o, d f32[N,3], pixel, sample int64[N]), lanes in image order;
    one launch on the current stream, counted in
    ``_build.LAUNCHES["camera_rays"]``."""
    r2c, c2w = camera.raster_to_camera, camera.camera_to_world
    if torch.is_grad_enabled() and (r2c.requires_grad or c2w.requires_grad):
        raise RuntimeError("the camera-ray kernel is not differentiable: a camera that "
                           "requires grad takes render.camera_samples and "
                           "camera.generate_rays")
    dev = r2c.device
    if dev.type != "cuda" or c2w.device != dev:
        raise ValueError(f"the CUDA kernel needs the camera on one card, got {dev}, "
                         f"{c2w.device}")
    if r2c.dtype != torch.float32 or c2w.dtype != torch.float32 or \
            r2c.shape != (4, 4) or c2w.shape != (4, 4):
        raise ValueError("the camera's matrices must be float32 [4, 4]")
    x0, x1 = (0, width) if cols is None else cols
    if not 0 <= x0 < x1 <= width:
        raise ValueError(f"columns [{x0}, {x1}) outside an image {width} wide")
    r2c, c2w = r2c.contiguous(), c2w.contiguous()
    n = n_rows * (x1 - x0)
    jitter = torch.empty((n, 2), dtype=torch.float32, device=dev)
    o = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    pixel = torch.empty((n,), dtype=torch.int64, device=dev)
    sample = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return jitter, o, d, pixel, sample
    _build.launch(ENTRY, dev, (
        r2c.data_ptr(), c2w.data_ptr(), width, row0, x0, x1 - x0, n, int(seed) & 0xFFFFFFFF,
        int(sample_idx), SAMPLERS[sampler], nx, ny, camera.kind, float(camera.lens_radius),
        float(camera.focal_distance), jitter.data_ptr(), o.data_ptr(), d.data_ptr(),
        pixel.data_ptr(), sample.data_ptr()))
    return jitter, o, d, pixel, sample
