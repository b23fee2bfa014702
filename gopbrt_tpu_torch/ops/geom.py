"""Vector and transform math on float32 tensors.

Counterpart of ``gopbrt_tpu/ops/geom.py``: the constants, the vector ops the
slice needs, and the 4x4 transforms the camera and the scene builder use.

Conventions, as in the JAX module: points / vectors / normals are
``f32[..., 3]``; matrices ``f32[..., 4, 4]`` row-major with row 3 = (0,0,0,1).
The transform constructors build host-side (CPU) float32 tensors; they run
at scene-build time, never on the hot path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
INV_PI = 1.0 / math.pi
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
SHADOW_EPSILON = 1e-4  # pkg/math/math.go:19

_F32 = torch.float32


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector dot product -> [...]."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize; with ``eps`` > 0 guards the zero vector (returns ~0)."""
    n2 = length_sq(v)[..., None]
    keep = torch.where(n2 > eps, 1.0, 0.0)
    return v * keep / torch.sqrt(torch.clamp(n2, min=max(eps, 1e-30)))


def coordinate_system(v1: torch.Tensor):
    """Branch-free Duff et al. orthonormal frame around unit ``v1``."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    v2 = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    v3 = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return v2, v3


# ---------------------------------------------------------------------------
# 4x4 matrices / transforms (host-side, float32)
# ---------------------------------------------------------------------------


def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose transforms: ``a @ b`` (b is applied first)."""
    return torch.as_tensor(a, dtype=_F32) @ torch.as_tensor(b, dtype=_F32)


def inverse(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(torch.as_tensor(m, dtype=_F32))


def translate(delta) -> torch.Tensor:
    m = torch.eye(4, dtype=_F32)
    m[:3, 3] = _as_f32(delta)
    return m


def scale(x, y, z) -> torch.Tensor:
    return torch.diag(_as_f32([x, y, z, 1.0]))


def _rot(c: float, s: float, axis: int) -> torch.Tensor:
    m = torch.eye(4, dtype=_F32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    if axis == 1:  # y-axis has the transposed sign layout
        m[i, i], m[i, j], m[j, i], m[j, j] = c, s, -s, c
    else:
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def rotate_x(deg) -> torch.Tensor:
    t = math.radians(deg)
    return _rot(math.cos(t), math.sin(t), 0)


def rotate_y(deg) -> torch.Tensor:
    t = math.radians(deg)
    return _rot(math.cos(t), math.sin(t), 1)


def look_at(eye, look, up) -> torch.Tensor:
    """Camera-to-world matrix (transform.go ``LookAt``)."""
    eye, look, up = _as_f32(eye), _as_f32(look), _as_f32(up)
    direction = normalize(look - eye)
    right = normalize(cross(normalize(up), direction))
    new_up = cross(direction, right)
    m = torch.stack([right, new_up, direction, eye], dim=-1)  # columns
    return torch.cat([m, _as_f32([[0.0, 0.0, 0.0, 1.0]])], dim=0)


def perspective(fov_deg, near, far) -> torch.Tensor:
    """Perspective projection (transform.go:488-499)."""
    persp = _as_f32(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, far / (far - near), -far * near / (far - near)],
            [0, 0, 1, 0],
        ]
    )
    inv_tan = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    return matmul(scale(inv_tan, inv_tan, 1.0), persp)


def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points with the homogeneous divide (TransformPoint)."""
    r = torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]
    w = torch.einsum("...j,...j->...", m[..., 3, :3], p) + m[..., 3, 3]
    return r / w[..., None]


def apply_point_affine(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points assuming the last row is (0,0,0,1)."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)
