"""Path-tracing integrator dispatch.

Counterpart of ``gopbrt_tpu/models/integrators.py``: ``PathConfig``, the
RNG-dimension re-exports and ``li``.  The slice ports the megakernel path:
fast-path scenes of at most 64 prims run ``ops/megakernel.path_li_fused``.
The general wavefront chain (``_li_jnp``) and the direct-lighting
integrator are a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gopbrt_tpu_torch.ops import megakernel
from gopbrt_tpu_torch.ops.rng import (  # noqa: F401  (re-exports)
    D_BSDF_LOBE,
    D_BSDF_UV,
    D_LIGHT_PICK,
    D_LIGHT_UV,
    D_MEDIUM,
    D_PHASE,
    D_RR,
    D_SSS,
    DIM_BOUNCE_BASE,
    DIM_CAMERA,
    DIMS_PER_BOUNCE,
)

# the megakernel tests every primitive per ray (no BVH below this count)
BRUTE_FORCE_CUTOFF = 64


class PathConfig(NamedTuple):
    """Integrator configuration (NewPath, path.go:10-17)."""

    max_depth: int = 5
    rr_threshold: float = 1.0
    rr_start_depth: int = 3  # RR after 3 bounces (path.go:143-153)


def li(scene, o: torch.Tensor, d: torch.Tensor, pixel, sample, seed,
       cfg: PathConfig = PathConfig(), cone=None) -> torch.Tensor:
    """Path.Li (path.go:32-157): radiance f32[N,3] for rays (o, d)[N].

    pixel/sample: uint32 counters (int64 tensors) feeding the stateless
    sampler; cone: optional (width0, spread) ray-cone floats.
    """
    fi = scene.fastinfo
    if fi is not None and fi.ok and scene.prims.count <= BRUTE_FORCE_CUTOFF:
        return megakernel.path_li_fused(scene, o, d, pixel, sample, seed, cfg,
                                        cone=cone)
    raise NotImplementedError(
        "only fast-path scenes of <= 64 prims are ported; the general "
        "wavefront chain is ROADMAP open item 1.5"
    )
