"""Sampling warps, MIS heuristics and 1D distributions on tensors.

Counterpart of ``gopbrt_tpu/ops/sampling.py``: the sphere, hemisphere,
cone, disk, cosine-hemisphere and triangle warps and their pdfs, the
balance and power heuristics, ``distribution_1d``, ``sample_discrete``,
``discrete_pmf``, the row-wise ``sample_discrete_rows`` / ``pmf_rows`` (the
spatial light grid), ``sample_continuous``, and the radical inverse
(``reverse_bits_32``, ``radical_inverse_base2``, ``radical_inverse``) of
the Halton sampler.  uint32 values are held in int64 masked to 32 bits, as
in ``ops/rng.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.ops.geom import ONE_MINUS_EPSILON

_PI = math.pi
_PI_OVER_2 = math.pi / 2.0
_PI_OVER_4 = math.pi / 4.0


_INV_2PI = 1.0 / (2.0 * math.pi)
_INV_4PI = 1.0 / (4.0 * math.pi)
_MASK = 0xFFFFFFFF


def uniform_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2 * _PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_hemisphere_pdf() -> float:
    return _INV_2PI


def uniform_sphere_pdf() -> float:
    return _INV_4PI


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * (1.0 / _PI)


def uniform_sample_triangle(u: torch.Tensor) -> torch.Tensor:
    """Barycentric (b0, b1) uniform on a triangle."""
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / (nf * f_pdf + ng * g_pdf)


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


def sample_discrete_rows(func_rows, cdf_rows, int_rows, u):
    """Per-lane discrete sampling from row-wise distributions: lane i
    samples from (func_rows[i], cdf_rows[i]) by counting the CDF steps at
    or below u (sampling.py:146-162) -> (index int64[N], pmf f32[N])."""
    n = func_rows.shape[-1]
    idx = torch.clamp(torch.sum((cdf_rows <= u[..., None]).to(torch.int32), dim=-1) - 1,
                      0, n - 1)
    return idx, pmf_rows(func_rows, int_rows, idx)


def pmf_rows(func_rows, int_rows, idx):
    """pmf that sample_discrete_rows returns ``idx`` per lane."""
    n = func_rows.shape[-1]
    f = torch.gather(func_rows, -1, idx.long()[..., None])[..., 0]
    return torch.where(int_rows > 0.0, f / (torch.clamp(int_rows, min=1e-30) * n), 1.0 / n)


def sample_continuous(func, cdf, func_int, u):
    """Sample x in [0, 1) ~ func -> (x, pdf, index) (sampling.py:175-184)."""
    n = func.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True) - 1, 0, n - 1)
    c0 = cdf[idx]
    c1 = cdf[idx + 1]
    step = c1 > c0
    du = torch.where(step, (u - c0) / torch.where(step, c1 - c0, 1.0), u - c0)
    pdf = torch.where(func_int > 0, func[idx] / torch.clamp(func_int, min=1e-30), 0.0)
    return (idx.to(torch.float32) + du) / n, pdf, idx


# the first 64 primes: the radical inverse's bases (sampling.py:192-201)
PRIMES = np.array(
    [
        2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
        67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137,
        139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211,
        223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283,
        293, 307, 311,
    ],
    dtype=np.uint32,
)


def _u32(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.int64) & _MASK


def reverse_bits_32(x) -> torch.Tensor:
    """The 32 bits of each uint32 in reverse order (int64 in [0, 2^32))."""
    x = _u32(x)
    x = ((x << 16) | (x >> 16)) & _MASK
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    return ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)


def radical_inverse_base2(a) -> torch.Tensor:
    """RadicalInverse in base 2: the reversed bits times 2^-32, below 1.
    The uint32 -> float32 conversion rounds to nearest, as JAX's does
    (every value < 2^32 converts from int64 the same)."""
    r = reverse_bits_32(a).to(torch.float32) * 2.3283064365386963e-10
    return torch.clamp(r, max=ONE_MINUS_EPSILON)


def radical_inverse(base_index: int, a) -> torch.Tensor:
    """RadicalInverse (lowdiscrepancy.go:226-244) for a static base index:
    a fixed digit loop over ceil(32 / log2(base)) digits; ``rev * base +
    digit`` wraps modulo 2^32 as the reference's uint32 does, and the
    inverse powers multiply in float32."""
    if base_index == 0:
        return radical_inverse_base2(a)
    base = int(PRIMES[base_index])
    a = _u32(a)
    inv_base = torch.tensor(np.float32(1.0 / base))
    rev = torch.zeros_like(a)
    inv_base_n = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    for _ in range(int(np.ceil(32 / np.log2(base)))):
        live = a > 0
        rev = torch.where(live, (rev * base + a % base) & _MASK, rev)
        inv_base_n = torch.where(live, inv_base_n * inv_base.to(a.device), inv_base_n)
        a = a // base
    return torch.clamp(rev.to(torch.float32) * inv_base_n, max=ONE_MINUS_EPSILON)
