"""The texture table and its tags.

Counterpart of the table types of ``gopbrt_tpu/ops/texture.py``.  Constant
and planar-checker kd (with the ray-cone box filter) are evaluated inside
the bounce megakernel (``ops/megakernel.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    vs: torch.Tensor  # f32[T,3]  planar s axis
    vt: torch.Tensor  # f32[T,3]  planar t axis
    dsdt: torch.Tensor  # f32[T,2] offsets
    atlas: torch.Tensor  # f32[H,W,3] image atlas (1x1 black if unused)
    image_rect: torch.Tensor  # int32[T,4]
