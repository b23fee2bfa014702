"""Sampling warps, MIS heuristics and 1D distributions on tensors.

Counterpart of ``gopbrt_tpu/ops/sampling.py``: the sphere, cone, disk and
cosine-hemisphere warps, ``power_heuristic``, ``distribution_1d``,
``sample_discrete`` and ``discrete_pmf``.
"""

from __future__ import annotations

import math

import torch

_PI = math.pi
_PI_OVER_2 = math.pi / 2.0
_PI_OVER_4 = math.pi / 4.0


def uniform_sample_sphere(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2 * _PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_cone(u: torch.Tensor, cos_theta_max) -> torch.Tensor:
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2 * _PI * u[..., 1]
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * _PI * (1.0 - cos_theta_max))


def cosine_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic (sampling.go:204-212), 0 where both pdfs are."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    pos = denom > 0.0
    return torch.where(pos, f * f / torch.where(pos, denom, 1.0), 0.0)


def concentric_sample_disk(u: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric disk map (sampling.go ConcentricSampleDisk)."""
    off = 2.0 * u - 1.0
    ox, oy = off[..., 0], off[..., 1]
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)

    def safe(a, b):
        return a / torch.where(b == 0.0, 1.0, b)

    theta = torch.where(
        use_x, _PI_OVER_4 * safe(oy, ox), _PI_OVER_2 - _PI_OVER_4 * safe(ox, oy)
    )
    pt = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return torch.where(zero[..., None], 0.0, pt)


def distribution_1d(func: torch.Tensor):
    """(func, cdf, func_int) from non-negative weights func[n]
    (NewDistribution1D); uniform fallback when all weights are zero."""
    func = torch.as_tensor(func, dtype=torch.float32)
    n = func.shape[-1]
    zero = torch.zeros(func.shape[:-1] + (1,), dtype=torch.float32,
                       device=func.device)
    cdf = torch.cat([zero, torch.cumsum(func, dim=-1) / n], dim=-1)
    func_int = cdf[..., -1]
    positive = func_int[..., None] > 0.0
    cdf = torch.where(
        positive,
        cdf / torch.where(positive, func_int[..., None], 1.0),
        torch.arange(n + 1, dtype=torch.float32, device=func.device) / n,
    )
    return func, cdf, func_int


def sample_discrete(func, cdf, func_int, u):
    """Sample an index ~ func; returns (index, pmf), vectorised over u."""
    n = func.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, n - 1)
    pmf = torch.where(
        func_int > 0.0,
        func[idx] / (torch.clamp(func_int, min=1e-30) * n),
        1.0 / n,
    )
    return idx, pmf


def discrete_pmf(func, func_int, idx):
    """pmf that sample_discrete picks ``idx``, as the integrator's MIS
    denominator reads it (integrators.py:238-244: the product clamped)."""
    n = max(func.shape[-1], 1)
    return torch.where(func_int > 0.0,
                       func[idx] / torch.clamp(func_int * n, min=1e-20), 1.0 / n)
