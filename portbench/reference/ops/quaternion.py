"""Quaternions and two-keyframe animated transforms.

Counterpart of ``gopbrt_tpu/ops/quaternion.py`` (``pkg/pbrt/quaternion.go``
and ``AnimatedTransform``, ``pkg/pbrt/transform.go:512-631``): the
decomposition M = T R S by polar iteration (the reference's TODO at
transform.go:537-539, implemented), slerp, and interpolation batched over
times.  Quaternions are f32[..., 4] as (x, y, z, w).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.ops import geom

_F32 = torch.float32


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_dot(a, b):
    return torch.sum(a * b, dim=-1)


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation (the upper 3x3 of [..., 4, 4] or [..., 3, 3]) -> quaternion:
    Shepperd's method, all four constructions computed and the one of the
    largest diagonal combination kept."""
    r = m[..., :3, :3]
    t = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    w0 = torch.sqrt(torch.clamp(1.0 + t, min=1e-12)) / 2.0
    q0 = torch.stack([(r[..., 2, 1] - r[..., 1, 2]) / (4.0 * w0),
                      (r[..., 0, 2] - r[..., 2, 0]) / (4.0 * w0),
                      (r[..., 1, 0] - r[..., 0, 1]) / (4.0 * w0), w0], dim=-1)

    def axis_major(i, j, k):
        s = torch.sqrt(torch.clamp(1.0 + r[..., i, i] - r[..., j, j] - r[..., k, k],
                                   min=1e-12))
        q = [None] * 4
        q[i] = s / 2.0
        q[j] = (r[..., j, i] + r[..., i, j]) / (2.0 * s)
        q[k] = (r[..., k, i] + r[..., i, k]) / (2.0 * s)
        q[3] = (r[..., k, j] - r[..., j, k]) / (2.0 * s)
        return torch.stack(q, dim=-1)

    use_w = (t > 0.0)[..., None]
    x_big = ((r[..., 0, 0] > r[..., 1, 1]) & (r[..., 0, 0] > r[..., 2, 2]))[..., None]
    y_big = (r[..., 1, 1] > r[..., 2, 2])[..., None]
    q = torch.where(use_w, q0, torch.where(x_big, axis_major(0, 1, 2),
                                           torch.where(y_big, axis_major(1, 2, 0),
                                                       axis_major(2, 0, 1))))
    return quat_normalize(q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 4x4 rotation (quaternion.go ToTransform)."""
    x, y, z, w = q.unbind(-1)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), zero], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), zero], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), zero], -1),
        torch.stack([zero, zero, zero, one], -1),
    ], dim=-2)


def slerp(t, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spherical linear interpolation (quaternion.go Slerp); a normalized
    lerp where the quaternions are within cos 0.9995 of parallel."""
    t = torch.as_tensor(t, dtype=_F32, device=a.device)
    cos_theta = quat_dot(a, b)
    b = torch.where(cos_theta[..., None] < 0.0, -b, b)
    cos_theta = torch.abs(cos_theta)
    near = cos_theta > 0.9995
    lin = quat_normalize(a + t[..., None] * (b - a))
    thetap = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0)) * t
    qperp = quat_normalize(b - a * cos_theta[..., None])
    sph = a * torch.cos(thetap)[..., None] + qperp * torch.sin(thetap)[..., None]
    return torch.where(near[..., None], lin, sph)


class AnimatedTransform(NamedTuple):
    """Two-keyframe rigid + scale animation (transform.go:512-631)."""

    start_m: torch.Tensor  # f32[4,4]
    end_m: torch.Tensor  # f32[4,4]
    start_time: float
    end_time: float
    t0: torch.Tensor  # f32[3] translations
    t1: torch.Tensor
    q0: torch.Tensor  # f32[4] rotations
    q1: torch.Tensor
    s0: torch.Tensor  # f32[4,4] scale / shear remainders
    s1: torch.Tensor
    actually_animated: bool


def decompose(m: torch.Tensor):
    """M = T R S (the PBRT decompose): R by 20 steps of the polar iteration
    R <- (R + R^-T) / 2 in float32, S = R^-1 M without the translation ->
    (t f32[..., 3], q f32[..., 4], s f32[..., 4, 4])."""
    m = torch.as_tensor(m, dtype=_F32)
    t = m[..., :3, 3]
    mask = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 1]], dtype=_F32,
                        device=m.device)
    rot = m * mask
    for _ in range(20):
        rot = 0.5 * (rot + torch.linalg.inv(rot.transpose(-1, -2)))
    m_lin = m.clone()
    m_lin[..., :3, 3] = 0.0
    return t, quat_from_matrix(rot), torch.linalg.inv(rot) @ m_lin


def animated_transform(start_m, end_m, start_time: float = 0.0,
                       end_time: float = 1.0) -> AnimatedTransform:
    start_m = torch.as_tensor(np.array(start_m, dtype=np.float32))
    end_m = torch.as_tensor(np.array(end_m, dtype=np.float32))
    t0, q0, s0 = decompose(start_m)
    t1, q1, s1 = decompose(end_m)
    # the shortest path
    q1 = torch.where(quat_dot(q0, q1) < 0.0, -q1, q1)
    return AnimatedTransform(start_m, end_m, float(start_time), float(end_time), t0, t1, q0,
                             q1, s0, s1, bool(torch.any(torch.abs(start_m - end_m) > 1e-7)))


def interpolate(at: AnimatedTransform, time) -> torch.Tensor:
    """The transform at ``time`` (transform.go Interpolate), batched over
    times; the start matrix where the keyframes are equal."""
    time = torch.as_tensor(time, dtype=_F32, device=at.start_m.device)
    st, et = np.float32(at.start_time), np.float32(at.end_time)
    if et > st:
        dt = (torch.clamp(time, float(st), float(et)) - float(st)) / float(max(et - st, 1e-12))
    else:
        dt = torch.zeros_like(time)
    m = quat_to_matrix(slerp(dt, at.q0, at.q1)) @ geom.lerp(dt[..., None, None], at.s0, at.s1)
    m = m.clone()
    m[..., :3, 3] += geom.lerp(dt[..., None], at.t0, at.t1)
    if not at.actually_animated:
        return torch.broadcast_to(at.start_m, m.shape)
    return m
