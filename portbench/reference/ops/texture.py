"""The texture table and its evaluation at hit points.

Counterpart of ``gopbrt_tpu/ops/texture.py``: the table types and
``eval_spectrum`` with ``_st`` (uv and planar mapping), ``_bump_int`` and
``_checker_filtered`` (the ray-cone box filter) and the bilinear image
atlas lookup ``_image_lookup``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reference.ops.geom import dot, gather_rows

TEX_CONSTANT = 0
TEX_CHECKERBOARD = 1
TEX_UV = 2
TEX_IMAGE = 3

MAP_UV = 0
MAP_PLANAR = 1


class Textures(NamedTuple):
    """SoA texture table (checkerboard.go:15-20, texture.go:9-46)."""

    tex_type: torch.Tensor  # int32[T]
    value1: torch.Tensor  # f32[T,3]
    value2: torch.Tensor  # f32[T,3]
    mapping: torch.Tensor  # int32[T]
    vs: torch.Tensor  # f32[T,3]  planar s axis (or [su, sv, 0] for uv)
    vt: torch.Tensor  # f32[T,3]  planar t axis (or [du, dv, 0] for uv)
    dsdt: torch.Tensor  # f32[T,2] offsets
    atlas: torch.Tensor  # f32[H,W,3] image atlas (1x1 black if unused)
    image_rect: torch.Tensor  # int32[T,4]
    # whether any row is an image texture, known at build: a table without
    # one skips the atlas lookup (its lanes never select it)
    has_image: bool = True


def _st(tex: Textures, tex_id, p, uv):
    """Mapped (s, t) (UVMapping2D.Map / PlanarMapping2D.Map)."""
    mapping = tex.mapping[tex_id]
    vs = gather_rows(tex.vs, tex_id)
    vt = gather_rows(tex.vt, tex_id)
    ds = gather_rows(tex.dsdt, tex_id)
    s_uv = uv[..., 0] * vs[..., 0] + ds[..., 0]
    t_uv = uv[..., 1] * vt[..., 1] + ds[..., 1]
    s_pl = ds[..., 0] + dot(p, vs)
    t_pl = ds[..., 1] + dot(p, vt)
    is_uv = mapping == MAP_UV
    return torch.where(is_uv, s_uv, s_pl), torch.where(is_uv, t_uv, t_pl)


def _image_lookup(tex: Textures, tex_id, s, t):
    """Bilinear atlas fetch with wrap addressing (texture.py:80-110).

    s and t are sanitized first: missed lanes carry garbage uv, and a NaN
    uv makes the bilinear weights NaN, which the gather's backward would
    scatter into the atlas gradient as NaN * 0."""
    s = torch.nan_to_num(s, nan=0.0, posinf=0.0, neginf=0.0)
    t = torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)
    rect = tex.image_rect[tex_id].long()
    y0, x0 = rect[..., 0], rect[..., 1]
    h = torch.clamp(rect[..., 2], min=1)
    w = torch.clamp(rect[..., 3], min=1)
    fx = (s % 1.0) * w.to(torch.float32) - 0.5
    fy = (t % 1.0) * h.to(torch.float32) - 0.5
    x_lo = torch.floor(fx).long()
    y_lo = torch.floor(fy).long()
    ax = (fx - x_lo.to(torch.float32))[..., None]
    ay = (fy - y_lo.to(torch.float32))[..., None]

    atlas = tex.atlas.reshape(-1, 3)
    width = tex.atlas.shape[1]

    def fetch(yy, xx):
        return gather_rows(atlas, (y0 + (yy % h)) * width + x0 + (xx % w))

    return (fetch(y_lo, x_lo) * (1 - ax) * (1 - ay)
            + fetch(y_lo, x_lo + 1) * ax * (1 - ay)
            + fetch(y_lo + 1, x_lo) * (1 - ax) * ay
            + fetch(y_lo + 1, x_lo + 1) * ax * ay)


def _bump_int(x):
    """Closed-form integral of the checker parity from 0 to x."""
    h = x * 0.5
    return torch.floor(h) + 2.0 * torch.clamp(h - torch.floor(h) - 0.5, min=0.0)


def _checker_filtered(v1, v2, s, t, fw_s, fw_t):
    """Box-filtered checkerboard over the (s, t) footprint: the exact
    fractional coverage of the two colours."""
    ds = torch.clamp(fw_s, min=1e-8)
    dt = torch.clamp(fw_t, min=1e-8)
    s_int = (_bump_int(s + ds) - _bump_int(s - ds)) / (2.0 * ds)
    t_int = (_bump_int(t + dt) - _bump_int(t - dt)) / (2.0 * dt)
    area2 = torch.clamp(s_int + t_int - 2.0 * s_int * t_int, 0.0, 1.0)
    return v1 * (1.0 - area2)[..., None] + v2 * area2[..., None]


def eval_spectrum(tex: Textures, tex_id, p, uv, fw=None):
    """Spectrum texture ``tex_id`` (per lane) at p / uv -> rgb f32[N,3].

    Checkerboard: floor(s) + floor(t) parity (checkerboard.go:30-40), or
    with a footprint ``fw`` (f32[N], world units, from the ray cone) the
    box-filtered closed form.  tex_id < 0 gives black.
    """
    safe_id = torch.clamp(tex_id, min=0).long()
    ttype = tex.tex_type[safe_id]
    v1 = gather_rows(tex.value1, safe_id)
    v2 = gather_rows(tex.value2, safe_id)
    s, t = _st(tex, safe_id, p, uv)
    parity = (torch.floor(s).to(torch.int32) + torch.floor(t).to(torch.int32)) % 2
    checker = torch.where((parity == 0)[..., None], v1, v2)
    if fw is not None:
        # world-space cone width -> (s, t) widths by the mapping's scale
        vs = gather_rows(tex.vs, safe_id)
        vt = gather_rows(tex.vt, safe_id)
        scale_s = torch.sqrt(torch.sum(vs * vs, dim=-1))
        scale_t = torch.sqrt(torch.sum(vt * vt, dim=-1))
        checker = _checker_filtered(v1, v2, s, t, fw * scale_s, fw * scale_t)
    uv_dbg = torch.stack([uv[..., 0] % 1.0, uv[..., 1] % 1.0, torch.zeros_like(s)],
                         dim=-1)
    img = _image_lookup(tex, safe_id, s, t) if tex.has_image else 0.0
    out = torch.where(
        (ttype == TEX_CONSTANT)[..., None], v1,
        torch.where((ttype == TEX_CHECKERBOARD)[..., None], checker,
                    torch.where((ttype == TEX_UV)[..., None], uv_dbg, img)),
    )
    return torch.where((tex_id < 0)[..., None], 0.0, out)
