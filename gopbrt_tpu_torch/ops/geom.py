"""Vector and transform math on float32 tensors.

Counterpart of ``gopbrt_tpu/ops/geom.py``: the constants, the vector ops,
the 4x4 transforms of the cameras and the scene builder, rays and the
axis-aligned bounds helpers.

Conventions, as in the JAX module: points / vectors / normals are
``f32[..., 3]``; matrices ``f32[..., 4, 4]`` row-major with row 3 = (0,0,0,1).
The transform constructors build host-side (CPU) float32 tensors; they run
at scene-build time, never on the hot path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gopbrt_tpu_torch.utils import trace

PI = math.pi
INV_PI = 1.0 / math.pi
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
SHADOW_EPSILON = 1e-4  # pkg/math/math.go:19
MAX_F32 = float(np.finfo(np.float32).max)
# f32 machine epsilon / 2, the intended pkg/math/math.go:17 (geom.py:53)
MACHINE_EPSILON = float(np.finfo(np.float32).eps) / 2.0

_F32 = torch.float32


def gamma(n: int) -> float:
    """PBRT's conservative rounding-error bound n*eps / (1 - n*eps)."""
    ne = n * MACHINE_EPSILON
    return ne / (1 - ne)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector dot product -> [...]."""
    return torch.sum(a * b, dim=-1)


def absdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(dot(a, b))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_sq(v))


def face_forward(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flip n into the hemisphere of v (pkg/geometry FaceForward)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def spherical_direction(sin_theta, cos_theta, phi) -> torch.Tensor:
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def spherical_direction_xyz(sin_theta, cos_theta, phi, x, y, z) -> torch.Tensor:
    """Spherical direction in the frame (x, y, z)."""
    return (x * (sin_theta * torch.cos(phi))[..., None]
            + y * (sin_theta * torch.sin(phi))[..., None]
            + z * cos_theta[..., None])


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return length(b - a)


def lerp(t, a, b):
    """Linear interpolation (pkg/math/math.go Lerp)."""
    return (1.0 - t) * a + t * b


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


def identity() -> torch.Tensor:
    return torch.eye(4, dtype=_F32)


def transpose(m: torch.Tensor) -> torch.Tensor:
    return torch.swapaxes(m, -1, -2)


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


def rotate_z(deg) -> torch.Tensor:
    t = math.radians(deg)
    return _rot(math.cos(t), math.sin(t), 2)


def rotate(deg, axis) -> torch.Tensor:
    """Rotation about an arbitrary axis (transform.go ``Rotate``)."""
    a = _as_f32(axis)
    x, y, z = a / torch.linalg.norm(a)
    t = math.radians(float(deg))
    s, c = math.sin(t), math.cos(t)
    zero, one = torch.zeros((), dtype=_F32), torch.ones((), dtype=_F32)
    return torch.stack([
        torch.stack([c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s,
                     zero]),
        torch.stack([x * y * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s,
                     zero]),
        torch.stack([x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, c + z * z * (1 - c),
                     zero]),
        torch.stack([zero, zero, zero, one]),
    ])


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


def orthographic(z_near, z_far) -> torch.Tensor:
    """Orthographic projection (transform.go:501-502)."""
    return matmul(scale(1.0, 1.0, 1.0 / (z_far - z_near)), translate([0.0, 0.0, -z_near]))


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


# Per-lane transforms (m f32[N,4,4] gathered per lane) as products and
# sums of the rows: elementwise ops, no batched matrix product.


def _rows_dot(m3: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m3 @ v per lane: m3 f32[...,3,3], v f32[...,3]."""
    return torch.sum(m3 * v[..., None, :], dim=-1)


def lane_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """apply_point_affine for per-lane matrices."""
    return _rows_dot(m[..., :3, :3], p) + m[..., :3, 3]


def lane_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """apply_vector for per-lane matrices."""
    return _rows_dot(m[..., :3, :3], v)


def apply_normal(m_inv: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Normals transform by the inverse transpose (TransformNormal)."""
    return _rows_dot(m_inv[..., :3, :3].transpose(-1, -2), n)


def apply_point_error(m: torch.Tensor, p: torch.Tensor):
    """Transformed point and its abs-error bound (transform.go:238-265):
    gamma(3) * (|M| |p| + |t|)."""
    err = gamma(3) * (_rows_dot(torch.abs(m[..., :3, :3]), torch.abs(p))
                      + torch.abs(m[..., :3, 3]))
    return lane_point(m, p), err


def swaps_handedness(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.det(m[..., :3, :3]) < 0.0


def ray_at(o: torch.Tensor, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return o + d * t[..., None]


def apply_ray(m: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Transform a ray's origin and direction, the origin moved along the
    direction past its rounding error (TransformRay, geom.py:355-366)."""
    ot, o_err = apply_point_error(m, o)
    dt = apply_vector(m, d)
    len_sq = length_sq(dt)
    t_off = torch.where(len_sq > 0, dot(torch.abs(dt), o_err) / torch.clamp(len_sq, min=1e-30),
                        0.0)
    return ot + dt * t_off[..., None], dt


# ---------------------------------------------------------------------------
# Bounds: an AABB as (lo [...,3], hi [...,3]) (pkg/pbrt/bounds.go)
# ---------------------------------------------------------------------------


def bounds_empty() -> tuple[torch.Tensor, torch.Tensor]:
    return torch.full((3,), MAX_F32, dtype=_F32), torch.full((3,), -MAX_F32, dtype=_F32)


def bounds_union(lo1, hi1, lo2, hi2):
    return torch.minimum(lo1, lo2), torch.maximum(hi1, hi2)


def bounds_union_point(lo, hi, p):
    return torch.minimum(lo, p), torch.maximum(hi, p)


def bounds_diagonal(lo, hi):
    return hi - lo


def bounds_surface_area(lo, hi):
    d = hi - lo
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def bounds_centroid(lo, hi):
    return 0.5 * (lo + hi)


def bounds_bounding_sphere(lo, hi):
    c = bounds_centroid(lo, hi)
    return c, torch.where(torch.all(hi >= lo, dim=-1), distance(c, hi), 0.0)


def bounds_transform(m, lo, hi):
    """An AABB through m: min / max over its 8 transformed corners
    (transform.go TransformBounds)."""
    corners = torch.stack([torch.stack([(hi if i & (1 << k) else lo)[k] for k in range(3)])
                           for i in range(8)])
    tc = apply_point_affine(m, corners)
    return torch.amin(tc, dim=0), torch.amax(tc, dim=0)


def bounds_intersect_p(lo, hi, o, d, t_max, inv_d=None) -> torch.Tensor:
    """Robust slab test (bounds.go:149-185; geom.py:427-441) -> hit mask.

    The far plane is widened by 1 + 2*gamma(3) to stay conservative under
    f32.  Batched over rays and boxes by broadcasting."""
    if inv_d is None:
        inv_d = 1.0 / d
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1)
    t_far = torch.maximum(t0, t1) * (1 + 2 * gamma(3))
    tn = torch.amax(t_near, dim=-1)
    tf = torch.amin(t_far, dim=-1)
    return (tn <= tf) & (tf > 0.0) & (tn < t_max)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for table [P, ...] and int32 or int64 idx [N] -> [N, ...].
    The JAX package's one-hot matmul (intersect.py:436) is a TPU device;
    here ``index_select``, whose backward adds the lanes' gradients with
    atomics (``index_add``).  Plain ``table[idx]`` gives the same rows, but
    its backward on CUDA sorts the indices and adds each row's duplicates
    in one serial loop: with ~10^5 lanes on a few dozen rows that took 97%
    of a gradient step's device time on an H100 (PERF.md)."""
    return torch.index_select(table, 0, idx)


class _NextafterAway(torch.autograd.Function):
    """Each component of po one ulp away from zero where offset != 0.

    ``torch.nextafter`` has no derivative; the op is a sub-ulp rounding, so
    the backward is the identity to po and nothing to offset (the custom
    JVP of geom.py:321-341)."""

    @staticmethod
    def forward(po, offset):
        inf = trace.to_card(float("inf"), po.device, po.dtype)
        up = torch.where(po > 0, torch.nextafter(po, inf), po)
        dn = torch.where(po < 0, torch.nextafter(po, -inf), po)
        return torch.where(offset > 0, up, torch.where(offset < 0, dn, po))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _nextafter_away(po: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Each component of po one ulp away from zero where offset != 0."""
    return _NextafterAway.apply(po, offset)


def offset_ray_origin(p: torch.Tensor, p_err: torch.Tensor, n: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Robust spawn point (ray.go:57-74): offset by dot(|n|, p_err) along
    +-n toward w, then round away from p."""
    d = dot(torch.abs(n), p_err)
    offset = d[..., None] * n
    offset = torch.where(dot(w, n)[..., None] < 0.0, -offset, offset)
    return _nextafter_away(p + offset, offset)
