"""Film: filtered sample accumulation, development and PNG output.

Counterpart of ``gopbrt_tpu/models/film.py`` (``Film``, ``new_film``,
``add_samples``, ``add_samples_rows``, ``splat_band_halo``, ``merge``,
``develop``, ``srgb_encode``, ``to_uint8``, ``write_png``).  Unlike the JAX
version, ``add_samples_rows`` accumulates into the film's tensors in place
(one 1080p film is 33 MB; a pass makes no copy of it) and returns the same
film; autograd records the in-place fold, so the film carries a gradient to
L where L has one.
``add_samples`` is out of place, as the reference's scatter.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from reference import resolve_device
from reference.ops.filters import Filter, box_filter, evaluate


class Film(NamedTuple):
    rgb: torch.Tensor  # f32[H,W,3] weighted radiance sum
    weight: torch.Tensor  # f32[H,W]  filter weight sum


def new_film(width: int, height: int, device=None) -> Film:
    """An empty film on ``device`` (None = the card)."""
    device = resolve_device(device)
    return Film(
        rgb=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        weight=torch.zeros((height, width), dtype=torch.float32, device=device),
    )


def _splat_index(i: torch.Tensor, size: int):
    """A tap index as the reference's ``.at[i].add(mode="drop")`` takes it:
    a negative index counts from the end (JAX normalizes indices from
    -size to -1 before the drop), any other outside [0, size) is dropped ->
    (the index clamped into the film, whether the tap lands)."""
    i = torch.where(i < 0, i + size, i)
    inside = (i >= 0) & (i < size)
    return torch.clamp(i, 0, size - 1), inside


def add_samples(film: Film, p_film: torch.Tensor, L: torch.Tensor,
                filt: Filter = box_filter(1.0)) -> Film:
    """Splat samples at continuous film coordinates p_film f32[N,2] with
    radiance L f32[N,3] (film.go:211-248 AddSample; film.py:43-70): each
    sample's filter support as a static K x K set of scatter taps, added
    out of place with ``index_put(accumulate=True)``; a tap that does not
    land adds 0.  Differentiable with respect to L."""
    h, w = film.weight.shape
    r = filt.radius
    # discrete pixels touched: ceil(p - 0.5 - r) .. floor(p - 0.5 + r)
    k = int(np.floor(2 * r)) + 1
    base_x = torch.ceil(p_film[:, 0] - 0.5 - r).long()
    base_y = torch.ceil(p_film[:, 1] - 0.5 - r).long()
    rgb, wsum = film.rgb, film.weight
    for oy in range(k):
        for ox in range(k):
            px, py = base_x + ox, base_y + oy
            # offset from the pixel center to the sample (film.go:232-241)
            fw = evaluate(filt, px.to(torch.float32) + 0.5 - p_film[:, 0],
                          py.to(torch.float32) + 0.5 - p_film[:, 1])
            xi, x_in = _splat_index(px, w)
            yi, y_in = _splat_index(py, h)
            fw = torch.where(x_in & y_in, fw, 0.0)
            rgb = rgb.index_put((yi, xi), fw[:, None] * L, accumulate=True)
            wsum = wsum.index_put((yi, xi), fw, accumulate=True)
    return Film(rgb=rgb, weight=wsum)


def add_samples_rows(film: Film, row0: int, jitter: torch.Tensor,
                     L: torch.Tensor, filt: Filter = box_filter(1.0)) -> Film:
    """Row-aligned dense splat of one sample per pixel for the band of image
    rows starting at ``row0`` (film.go:211-248 AddSample, as shifted dense
    adds).  Taps outside the image and samples on rows at or past the
    image's last row are dropped.

    jitter: f32[rows, W, 2] sample offset within each pixel in [0, 1)^2.
    L:      f32[rows, W, 3].
    """
    rows, w_img = L.shape[0], L.shape[1]
    h_img = film.weight.shape[0]
    if film.weight.shape[1] != w_img:
        raise ValueError("band width differs from the film width")
    acc_rgb, acc_w = splat_band_halo(row0, jitter, L, h_img, filt)
    # fold the halo-extended band (image rows row0-rr ...) into the film
    rr = int(math.ceil(filt.radius))
    y0 = row0 - rr
    lo, hi = max(0, y0), min(h_img, y0 + rows + 2 * rr)
    if hi > lo:
        film.rgb[lo:hi] += acc_rgb[lo - y0:hi - y0]
        film.weight[lo:hi] += acc_w[lo - y0:hi - y0]
    return film


def splat_band_halo(row0: int, jitter: torch.Tensor, L: torch.Tensor, h_img: int,
                    filt: Filter = box_filter(1.0)):
    """The filter taps of one sample per pixel of the band of image rows
    from ``row0`` as halo-extended accumulators (film.py:131-161): (rgb
    f32[rows+2rr, W, 3], w f32[rows+2rr, W]), rr = ceil(filter radius),
    row i holding image row row0 - rr + i.  The first and last rr rows are
    the taps that land on the neighbouring bands (parallel/shard.py
    exchanges them).  Samples on rows at or past ``h_img`` are masked and
    taps outside [0, W) dropped.  ``add_samples_rows`` folds the same
    accumulators into a film.
    """
    rows, w_img = L.shape[0], L.shape[1]
    rr = int(math.ceil(filt.radius))
    jx, jy = jitter[..., 0], jitter[..., 1]
    row_valid = (row0 + torch.arange(rows, device=L.device)) < h_img
    acc_rgb = torch.zeros((rows + 2 * rr, w_img + 2 * rr, 3),
                          dtype=torch.float32, device=L.device)
    acc_w = torch.zeros((rows + 2 * rr, w_img + 2 * rr),
                        dtype=torch.float32, device=L.device)
    for oy in range(-rr, rr + 1):
        for ox in range(-rr, rr + 1):
            # offset from tap pixel center (x+ox+0.5) to sample (x+jx)
            fw = evaluate(filt, ox + 0.5 - jx, oy + 0.5 - jy)
            fw = torch.where(row_valid[:, None], fw, 0.0)
            ys = slice(oy + rr, oy + rr + rows)
            xs = slice(ox + rr, ox + rr + w_img)
            acc_rgb[ys, xs] += fw[..., None] * L
            acc_w[ys, xs] += fw
    return acc_rgb[:, rr:rr + w_img], acc_w[:, rr:rr + w_img]


def merge(a: Film, b: Film) -> Film:
    """Two accumulations summed, out of place (MergeFilmTile, film.go:
    115-132; film.py:164-168)."""
    return Film(rgb=a.rgb + b.rgb, weight=a.weight + b.weight)


def develop(film: Film, gamma: bool = True, compat_go: bool = False) -> torch.Tensor:
    """Resolve the film to display RGB in [0,1] (f32[H,W,3]).

    compat_go reproduces film.go:142-179: no weight normalization, no gamma.
    """
    if compat_go:
        return torch.clamp(film.rgb, 0.0, 1.0)
    img = film.rgb / torch.clamp(film.weight[..., None], min=1e-8)
    img = torch.clamp(img, min=0.0)
    if gamma:
        img = srgb_encode(img)
    return torch.clamp(img, 0.0, 1.0)


def srgb_encode(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, min=0.0)
    return torch.where(
        x <= 0.0031308,
        12.92 * x,
        1.055 * torch.pow(torch.clamp(x, min=1e-8), 1 / 2.4) - 0.055,
    )


def to_uint8(img: torch.Tensor) -> np.ndarray:
    """Quantize on the image's device, then copy the bytes to the host."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path: str, img) -> str:
    """8-bit RGB PNG of the image f32[H,W,3] in [0,1], from the standard
    library alone (zlib level 1, as film.py:207-217 encodes it): each row
    is stored with filter type 0."""
    px = to_uint8(torch.as_tensor(img))
    h, w = px.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: filter byte 0
    raw[:, 1:] = px.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", header))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
        f.write(_png_chunk(b"IEND", b""))
    return path
