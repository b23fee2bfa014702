"""The light table and its tags.

Counterpart of the table types of ``gopbrt_tpu/ops/lights.py``.  Light
sampling for the slice runs inside the bounce megakernel
(``ops/megakernel.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_AREA = 2

# area-light shape kinds (mirror the intersect tags)
SHAPE_SPHERE = 0
SHAPE_DISK = 1


class Lights(NamedTuple):
    """SoA light table.

    p: point position / distant direction toward the light (normalized).
    o2w/params/shape_kind: area-light geometry copied from the backing prim.
    prim_idx: backing primitive of an area light (-1 for delta lights).
    """

    light_type: torch.Tensor  # int32[L]
    p: torch.Tensor  # f32[L,3]
    intensity: torch.Tensor  # f32[L,3]
    two_sided: torch.Tensor  # bool[L]
    prim_idx: torch.Tensor  # int32[L]
    shape_kind: torch.Tensor  # int32[L]
    o2w: torch.Tensor  # f32[L,4,4]
    w2o: torch.Tensor  # f32[L,4,4]
    params: torch.Tensor  # f32[L,9]

    @property
    def count(self) -> int:
        return self.light_type.shape[0]
