"""The row splat of one band and its fold into the film in one CUDA launch
(``csrc/splat_rows.cu``).

``models/film.add_samples_rows`` calls ``splat_rows`` for a film on the
card where no gradient is recorded, and its plain version,
``film.add_samples_rows_plain``, otherwise.  The kernel computes what the
plain version computes, a thread a film pixel: the taps of the samples
that reach the pixel, in ``film.splat_band_halo``'s order, then the fold.
With the box filter the film is bit-equal to the plain version's; the
other filters agree within a few ulps.  The kernel is not differentiable.
"""

from __future__ import annotations

import math

import torch

from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.ops.filters import FILTER_BOX, FILTER_LANCZOS, Filter

# the largest filter radius the kernel takes (csrc/splat_rows.cu
# splat_params): (2 * 64 + 1)^2 taps a pixel
MAX_RADIUS = 64.0


def on_card(film) -> bool:
    """Whether ``add_samples_rows`` may launch the kernel: the film lies on a
    card."""
    return film.rgb.device.type == "cuda"


def splat_rows(film, row0: int, jitter: torch.Tensor, L: torch.Tensor, filt: Filter):
    """Splat one sample for every pixel of the band of image rows from
    ``row0`` (jitter f32[rows, W, 2] in [0, 1)^2 within its pixel, L
    f32[rows, W, 3]) with ``filt`` into ``film`` (rgb f32[H, W, 3], weight
    f32[H, W], on one card), in place -> the same film.  Samples on rows at
    or past the image's last row weigh 0; taps outside the film drop.  One
    launch on the current stream over the film rows the band reaches,
    counted in ``_build.LAUNCHES["splat_rows"]``; none where it reaches
    none."""
    rgb, wsum = film.rgb, film.weight
    if torch.is_grad_enabled() and any(t.requires_grad for t in (rgb, wsum, jitter, L)):
        raise RuntimeError("the splat kernel is not differentiable: a band or film that "
                           "requires grad takes film.add_samples_rows_plain")
    if any(t.dtype != torch.float32 for t in (rgb, wsum, jitter, L)):
        raise ValueError("the film, jitter and L must be float32")
    if wsum.dim() != 2 or rgb.shape != (*wsum.shape, 3):
        raise ValueError(f"a film is rgb [H, W, 3] and weight [H, W], got "
                         f"{tuple(rgb.shape)}, {tuple(wsum.shape)}")
    if jitter.dim() != 3 or jitter.shape[2] != 2 or L.shape != (*jitter.shape[:2], 3):
        raise ValueError(f"a band is jitter [rows, W, 2] and L [rows, W, 3], got "
                         f"{tuple(jitter.shape)}, {tuple(L.shape)}")
    h, w = wsum.shape
    rows = jitter.shape[0]
    if jitter.shape[1] != w:
        raise ValueError(f"band width {jitter.shape[1]} differs from the film width {w}")
    if not (rgb.is_contiguous() and wsum.is_contiguous()):
        raise ValueError("the film's tensors must be contiguous: the kernel adds in place")
    if not FILTER_BOX <= filt.kind <= FILTER_LANCZOS or not 0.0 <= filt.radius <= MAX_RADIUS:
        raise ValueError(f"the kernel takes filters.FILTER_* of radius [0, {MAX_RADIUS}], "
                         f"got {filt}")
    dev = rgb.device
    if dev.type != "cuda" or any(t.device != dev for t in (wsum, jitter, L)):
        raise ValueError(f"the CUDA kernel needs the film and the band on one card, got "
                         f"{dev}, {wsum.device}, {jitter.device}, {L.device}")
    rr = int(math.ceil(filt.radius))
    if min(h, row0 + rows + rr) <= max(0, row0 - rr):
        return film
    jitter, L = jitter.contiguous(), L.contiguous()
    fn = _build.load("splat_rows").gopbrt_splat_rows
    err = fn(rgb.data_ptr(), wsum.data_ptr(), jitter.data_ptr(), L.data_ptr(), h, w, row0, rows,
             filt.kind, float(filt.radius), float(filt.alpha), float(filt.b), float(filt.c),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"splat_rows launch failed: cudaError_t {err}")
    _build.LAUNCHES["splat_rows"] += 1
    return film
