"""The primitive table and its shape tags.

Counterpart of the table types of ``gopbrt_tpu/ops/intersect.py``.  The
shape tests themselves live in ``ops/brute_intersect.py`` (plain PyTorch)
and ``csrc/prim_test.cuh`` (CUDA).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gopbrt_tpu_torch.ops.static_info import PrimInfo

# primitive type tags
SPHERE = 0
DISK = 1
TRIANGLE = 2


class Primitives(NamedTuple):
    """SoA primitive table.

    params layout (f32[P, 9]):
      sphere   [radius, z_min, z_max, phi_max_rad, 0...]      (object space)
      disk     [height, radius, inner_radius, phi_max_rad, 0...]
      triangle [p0x,p0y,p0z, p1x,p1y,p1z, p2x,p2y,p2z]        (world space)
    """

    prim_type: torch.Tensor  # int32[P]
    obj_to_world: torch.Tensor  # f32[P,4,4]
    world_to_obj: torch.Tensor  # f32[P,4,4]
    params: torch.Tensor  # f32[P,9]
    material_id: torch.Tensor  # int32[P]
    area_light_id: torch.Tensor  # int32[P], -1 = not an emitter
    reverse_orientation: torch.Tensor  # bool[P]
    pinfo: Optional[PrimInfo] = None

    @property
    def count(self) -> int:
        return self.prim_type.shape[0]
