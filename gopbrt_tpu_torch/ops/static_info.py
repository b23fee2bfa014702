"""Static scene facts that select kernel code paths.

Counterpart of ``gopbrt_tpu/ops/static_info.py``: plain frozen dataclasses
(the JAX package registers them as static pytree data; PyTorch needs no
such registration).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PrimInfo:
    """Which shape tests a Primitives table needs.

    types: sorted tuple of prim type tags present (SPHERE/DISK/TRIANGLE).
    all_full_spheres: every sphere is full (no z/phi clipping).
    all_full_disks: every disk has inner radius 0 and full phi.
    """

    types: Tuple[int, ...] = (0, 1, 2)
    all_full_spheres: bool = False
    all_full_disks: bool = False


@dataclass(frozen=True)
class MatInfo:
    """Which BSDF lobes a material table needs."""

    mat_types: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    any_rough_glass: bool = True
    any_smooth_glass: bool = True
    any_oren_nayar: bool = True


@dataclass(frozen=True)
class FastPathInfo:
    """Whether the scene fits the bounce megakernel (ops/megakernel.py):
    sphere/disk shapes; matte (sigma 0), mirror, smooth or rough glass;
    constant or planar-checker kd; point/distant/sphere-area lights under a
    global distribution, 1..16 of them; rigid + uniform-scale transforms.

    mesh_ok: whether the scene fits the mesh megakernel
    (ops/mesh_megakernel.py), which gates on it: the conditions above on
    kd, lights and transforms; any mix of triangles, spheres and disks,
    all in the one BVH (the JAX package's gate also asks for triangles and
    at most 32 other prims, which its TPU kernel tests in a separate loop);
    matte (sigma 0), mirror, smooth glass or plastic, at most 16 materials.
    ``mesh_megakernel.fits`` also asks for a BVH and more prims than the
    brute kernel takes.
    """

    ok: bool = False
    mesh_ok: bool = False
    has_glass: bool = False
    has_rough_glass: bool = False
