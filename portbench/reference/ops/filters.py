"""Reconstruction filters.

Counterpart of ``gopbrt_tpu/ops/filters.py``: the box filter of the
reference (filter.go:20-32) and the rest of PBRT's set, triangle,
Gaussian, Mitchell-Netravali and Lanczos-sinc, evaluated analytically per
splat tap (the splats of ``models/film.py`` take any radius).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

FILTER_BOX = 0
FILTER_TRIANGLE = 1
FILTER_GAUSSIAN = 2
FILTER_MITCHELL = 3
FILTER_LANCZOS = 4


class Filter(NamedTuple):
    kind: int  # FILTER_*
    radius: float  # the splat's footprint
    alpha: float = 2.0  # Gaussian falloff / Lanczos tau
    b: float = 1.0 / 3.0  # Mitchell B
    c: float = 1.0 / 3.0  # Mitchell C


def box_filter(radius: float = 0.5) -> Filter:
    """BoxFilter (filter.go:20-32)."""
    return Filter(FILTER_BOX, radius)


def triangle_filter(radius: float = 2.0) -> Filter:
    return Filter(FILTER_TRIANGLE, radius)


def gaussian_filter(radius: float = 2.0, alpha: float = 2.0) -> Filter:
    return Filter(FILTER_GAUSSIAN, radius, alpha=alpha)


def mitchell_filter(radius: float = 2.0, b: float = 1 / 3, c: float = 1 / 3) -> Filter:
    return Filter(FILTER_MITCHELL, radius, b=b, c=c)


def lanczos_filter(radius: float = 4.0, tau: float = 3.0) -> Filter:
    return Filter(FILTER_LANCZOS, radius, alpha=tau)


def _mitchell_1d(x, b, c):
    """Mitchell-Netravali piecewise cubic over |2x| (PBRT 7.1.4)."""
    x = torch.abs(2.0 * x)
    p1 = ((12 - 9 * b - 6 * c) * x**3 + (-18 + 12 * b + 6 * c) * x**2
          + (6 - 2 * b)) * (1.0 / 6.0)
    p2 = ((-b - 6 * c) * x**3 + (6 * b + 30 * c) * x**2
          + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    return torch.where(x < 1.0, p1, torch.where(x < 2.0, p2, 0.0))


def _sinc(x):
    x = torch.abs(x)
    return torch.where(x < 1e-5, 1.0, torch.sin(math.pi * x) / (math.pi * x + 1e-20))


def evaluate(f: Filter, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Filter weight at offset (dx, dy) from the sample; 0 outside support."""
    r = f.radius
    inside = (torch.abs(dx) <= r) & (torch.abs(dy) <= r)
    if f.kind == FILTER_BOX:
        return torch.where(inside, 1.0, 0.0)
    if f.kind == FILTER_TRIANGLE:
        w = torch.clamp(r - torch.abs(dx), min=0.0) * torch.clamp(r - torch.abs(dy), min=0.0)
    elif f.kind == FILTER_GAUSSIAN:
        expv = math.exp(-f.alpha * r * r)
        gx = torch.clamp(torch.exp(-f.alpha * dx * dx) - expv, min=0.0)
        gy = torch.clamp(torch.exp(-f.alpha * dy * dy) - expv, min=0.0)
        w = gx * gy
    elif f.kind == FILTER_MITCHELL:
        w = _mitchell_1d(dx / r, f.b, f.c) * _mitchell_1d(dy / r, f.b, f.c)
    elif f.kind == FILTER_LANCZOS:
        tau = f.alpha
        w = (_sinc(dx) * _sinc(dx / tau)) * (_sinc(dy) * _sinc(dy / tau))
    else:
        raise ValueError(f"unknown filter kind {f.kind}")
    return torch.where(inside, w, 0.0)
