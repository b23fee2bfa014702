"""Participating media: homogeneous media, transmittance and the
Henyey-Greenstein phase function.

Counterpart of ``gopbrt_tpu/ops/media.py``: ``HomogeneousMedium`` (one
global medium), ``MediaTable`` (bounded media, one row per medium, the
per-lane ``table_lookup``), Beer-Lambert ``transmittance``,
``sample_distance``, ``hg_phase``, ``hg_sample`` and ``sample_phase``.  The
reference declares the interfaces (``pkg/pbrt/medium.go:5-25``) and the HG
phase function (``pkg/pbrt/interaction.go:309-331``) but ships no concrete
medium; these are the working versions the integrators run
(``models/integrators.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gopbrt_tpu_torch.ops import geom
from gopbrt_tpu_torch.ops.geom import PI, gather_rows
from gopbrt_tpu_torch.utils import trace

INV_4PI = 1.0 / (4.0 * PI)


class HomogeneousMedium(NamedTuple):
    """sigma_a / sigma_s per RGB channel and the HG asymmetry g of the one
    global medium (``SceneBuilder.set_medium``)."""

    sigma_a: torch.Tensor  # f32[3]
    sigma_s: torch.Tensor  # f32[3]
    g: torch.Tensor  # f32[]

    @property
    def sigma_t(self) -> torch.Tensor:
        return self.sigma_a + self.sigma_s


class MediaTable(NamedTuple):
    """SoA table of bounded homogeneous media (``SceneBuilder.add_medium``):
    the prims' (medium_inside, medium_outside) ids and the lanes' current
    medium index its rows; -1 is vacuum."""

    sigma_a: torch.Tensor  # f32[M,3]
    sigma_s: torch.Tensor  # f32[M,3]
    g: torch.Tensor  # f32[M]

    @property
    def count(self) -> int:
        return self.sigma_a.shape[0]


def table_lookup(media: MediaTable, mid: torch.Tensor):
    """Per-lane coefficients (sigma_t f32[N,3], sigma_s f32[N,3], g f32[N])
    of medium ids ``mid`` int32[N]; -1 (vacuum) gives zeros.  The row read
    is the reference's ``safe = max(mid, 0)`` under an in-medium mask
    (media.py:55-68): ``index_select`` raises on -1, plain indexing would
    wrap to the last row."""
    safe = torch.clamp(mid, min=0).long()
    in_med = (mid >= 0)[..., None].to(torch.float32)
    sig_t = gather_rows(media.sigma_a + media.sigma_s, safe) * in_med
    sig_s = gather_rows(media.sigma_s, safe) * in_med
    g = gather_rows(media.g, safe) * in_med[..., 0]
    return sig_t, sig_s, g


def transmittance(medium: HomogeneousMedium, dist: torch.Tensor) -> torch.Tensor:
    """Beer-Lambert Tr = exp(-sigma_t d) (Medium.Tr): dist f32[N] -> [N,3]."""
    return torch.exp(-medium.sigma_t * torch.clamp(dist, min=0.0)[..., None])


def sample_distance(medium: HomogeneousMedium, u: torch.Tensor, channel: torch.Tensor):
    """A scattering distance ~ sigma_t exp(-sigma_t d) on the chosen RGB
    channel (Medium.Sample); the spectral MIS weight is the caller's."""
    st = medium.sigma_t[channel.long()]
    return -torch.log(torch.clamp(1.0 - u, min=1e-7)) / torch.clamp(st, min=1e-20)


def hg_phase(cos_theta: torch.Tensor, g) -> torch.Tensor:
    """Henyey-Greenstein p(cos theta) (interaction.go:309-317 PhaseHG)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def hg_sample(u: torch.Tensor, g) -> torch.Tensor:
    """cos theta ~ HG with theta from the propagation direction (-wo):
    E[cos theta] = g.  ``hg_phase`` takes dot(wo, wi), whose mean is -g, so
    ``sample_phase`` negates this cosine."""
    g = trace.to_card(g, u.device, torch.float32)
    iso = torch.abs(g) < 1e-3
    cos_iso = 1.0 - 2.0 * u
    sq = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * u, min=1e-10)
    two_g = torch.where(torch.abs(g) < 5e-4, 1e-3, 2.0 * g)  # sign-preserving
    cos_hg = (1.0 + g * g - sq * sq) / two_g
    return torch.where(iso, cos_iso, torch.clamp(cos_hg, -1.0, 1.0))


def sample_phase(wo: torch.Tensor, u2: torch.Tensor, g):
    """A scattered direction from the HG phase function at a medium vertex
    (PhaseFunction.SampleP, interaction.go:319-331) -> (wi, pdf), pdf ==
    hg_phase(dot(wo, wi), g).  wo points back along the incoming ray."""
    cos_t = -hg_sample(u2[..., 0], g)  # distributed as hg_phase(., g)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * PI * u2[..., 1]
    vx, vy = geom.coordinate_system(wo)
    wi = (vx * (sin_t * torch.cos(phi))[..., None]
          + vy * (sin_t * torch.sin(phi))[..., None]
          + wo * cos_t[..., None])
    return wi, hg_phase(cos_t, g)
