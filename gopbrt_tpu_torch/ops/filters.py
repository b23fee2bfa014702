"""Reconstruction filters.

Counterpart of ``gopbrt_tpu/ops/filters.py``.  The slice ports the box
filter, the one the demo and every render setting default to; the other
kinds are a later slice and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FILTER_BOX = 0
FILTER_TRIANGLE = 1
FILTER_GAUSSIAN = 2
FILTER_MITCHELL = 3
FILTER_LANCZOS = 4


class Filter(NamedTuple):
    kind: int
    radius: float
    alpha: float = 2.0
    b: float = 1.0 / 3.0
    c: float = 1.0 / 3.0


def box_filter(radius: float = 0.5) -> Filter:
    """BoxFilter (filter.go:20-32)."""
    return Filter(FILTER_BOX, radius)


def evaluate(f: Filter, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Filter weight at offset (dx, dy) from the sample; 0 outside support."""
    if f.kind != FILTER_BOX:
        raise NotImplementedError(
            "only the box filter is ported (ROADMAP open item 1.7)"
        )
    r = f.radius
    inside = (torch.abs(dx) <= r) & (torch.abs(dy) <= r)
    return torch.where(inside, 1.0, 0.0)
