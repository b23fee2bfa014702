"""The plain reference renderer of the benchmark: a frozen copy of the plain
PyTorch code of ``gopbrt_tpu_torch`` (its ``models/`` and ``ops/`` modules
as of commit d908b8a), kept here so that later changes to the program do
not move the yardstick.

The copy imports nothing of the program and launches no kernel.  It
differs from the program's source only where the program launches its
CUDA kernels:

- ``gopbrt_tpu_torch`` is ``reference`` in every import;
- the kernel wrappers are gone (``ops/megakernel``: ``make_launch``,
  ``replayed``, ``path_li_fused``; ``ops/mesh_megakernel``: ``make_launch``,
  ``mesh_li_fused``; ``ops/brute_intersect`` and ``ops/bvh``: the
  ``*_fused`` intersections);
- ``models/integrators._scene_intersect`` / ``_scene_intersect_p`` call the
  plain sweep and walk, and ``li`` calls ``ops/megakernel.path_li_plain``
  (``accel="bvh"`` on mesh fast-path scenes) where the program launches a
  megakernel;
- ``native`` builds no tree, so every BVH is the NumPy binned SAH.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device the reference runs on: ``None`` means the card."""
    return torch.device("cuda" if device is None else device)
