"""Stateless, counter-based random numbers, bit-exact with the JAX package.

Counterpart of ``gopbrt_tpu/ops/rng.py``: every random dimension along a
path is a pure function of ``(seed, pixel, sample, dim)`` — a chained
lowbias32 hash — so the port traces the same paths as the reference.

PyTorch on the CPU has no ``>>`` or ``+`` for ``uint32`` tensors, so the
32-bit arithmetic runs in ``int64`` masked to 32 bits.  Every product is
split into 16-bit halves so no intermediate leaves the int64 range.
Counters are ``int64`` tensors holding values in [0, 2^32).
"""

from __future__ import annotations

import torch

from gopbrt_tpu_torch.ops.geom import ONE_MINUS_EPSILON
from gopbrt_tpu_torch.utils import trace

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

# Sampling-dimension layout (rng.py:36-52): dims 0-4 camera (pixel jitter
# x2, lens x2, time), then a fixed stride of dimensions per bounce.
DIM_CAMERA = 0
DIMS_PER_BOUNCE = 16
DIM_BOUNCE_BASE = 5
# within a bounce:
D_LIGHT_PICK = 0
D_LIGHT_UV = 1  # +2
D_BSDF_UV = 3  # +2
D_BSDF_LOBE = 5
D_RR = 6
D_SSS = 7  # +4
D_MEDIUM = 11  # +2
D_PHASE = 13  # +2
DIM_ALL_LIGHT_BASE = 0x10000


def as_u32(x, device=None) -> torch.Tensor:
    """A counter (Python int or integer tensor) as int64 in [0, 2^32).  A
    Python int put on the card is a copy from the host, which synchronises
    the stream (the tracer's ``host_syncs``)."""
    t = trace.to_card(x, device)
    return t.to(torch.int64) & _MASK


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer (rng.hash_u32)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_combine(h, v) -> torch.Tensor:
    h = as_u32(h)
    v = as_u32(v, device=h.device)
    mix = (v + _GOLDEN + ((h << 6) & _MASK) + (h >> 2)) & _MASK
    return hash_u32(h ^ mix)


def stream_u32(seed, pixel, sample, dim) -> torch.Tensor:
    """uint32 stream of (seed, pixel, sample, dim), held in int64."""
    pixel = as_u32(pixel)
    h = hash_combine(as_u32(seed, device=pixel.device), pixel)
    h = hash_combine(h, sample)
    return hash_combine(h, dim)


def u32_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> f32 in [0, 1): the top 23 bits become the mantissa of a
    float in [1, 2), minus 1 — a bitcast, exactly as rng.u32_to_unit."""
    bits = (0x3F800000 | (as_u32(x) >> 9)).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def sample_1d(seed, pixel, sample, dim) -> torch.Tensor:
    return u32_to_unit(stream_u32(seed, pixel, sample, dim))


def sample_2d(seed, pixel, sample, dim) -> torch.Tensor:
    """(..., 2) point in [0,1)^2; consumes dims ``dim`` and ``dim + 1``."""
    u = sample_1d(seed, pixel, sample, dim)
    v = sample_1d(seed, pixel, sample, as_u32(dim) + 1)
    return torch.stack([u, v], dim=-1)


def stratified_2d(seed, pixel, sample, dim, nx: int, ny: int,
                  jitter: bool = True) -> torch.Tensor:
    """Stratified 2D over an nx*ny grid; the sample index picks the stratum."""
    pixel = as_u32(pixel)
    s = as_u32(sample, device=pixel.device) % (nx * ny)
    sx = (s % nx).to(torch.float32)
    sy = (s // nx).to(torch.float32)
    if jitter:
        jx = sample_1d(seed, pixel, sample, dim)
        jy = sample_1d(seed, pixel, sample, as_u32(dim) + 1)
    else:
        jx = jy = 0.5
    u = torch.clamp((sx + jx) / nx, max=ONE_MINUS_EPSILON)
    v = torch.clamp((sy + jy) / ny, max=ONE_MINUS_EPSILON)
    return torch.stack([u, v], dim=-1)
