"""Brute-force ray intersection: the plain PyTorch tests and the wrappers of
the CUDA kernels.

Counterpart of ``gopbrt_tpu/ops/pallas_intersect.py``: ``prim_test`` is the
math of ``_prim_test`` (sphere with z/phi clips, disk annulus with the phi
wedge, world-space Moller-Trumbore triangle); ``intersect_brute`` and
``intersect_p_brute`` are the plain versions of ``_intersect_kernel`` and
``_intersect_any_kernel``.  Their kernels are ``csrc/intersect.cu``, launched
by ``intersect_brute_fused`` and ``intersect_p_brute_fused``: on CUDA
tensors these launch the kernel (and count it in ``_build.LAUNCHES``), on
CPU tensors they run the plain version.  The CUDA twin of ``prim_test`` is
``csrc/prim_test.cuh``, which the bounce megakernel (``ops/megakernel.py``)
inlines too.  All of them read the table as ``brute_table`` packs it: the
builder once per scene (``Scene.brute``), ``scene_table`` again for a scene
whose prims are no longer the ones it was packed from.  The kernels take
two compile-time instances (``BruteTable.instance``), read the rows
``BruteTable.rec`` from device memory, and answer a dead lane without a
test where ``dead_d2`` proves that no prim can take it.

One primitive is tested against a batch of rays: the primitive's entries
are Python floats holding float32 values (a table row read on the host),
the rays are float32 tensors.  A product or difference of two such floats
rounds to the float32 result when the tensor op takes it; the phi_max
trigonometry and the comparisons with pi and 2*pi run in np.float32, as
the TPU kernel's SMEM scalars do.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.ops import packed
from gopbrt_tpu_torch.ops.intersect import DISK, SPHERE, TRIANGLE, Primitives

BIG = 1e30
_F = np.float32
_TWO_PI_CLIP = _F(2.0 * math.pi - 1e-6)


def _in_wedge(x, y, phi_max):
    """phi(x, y) <= phi_max without atan2: the sign of the 2D cross product
    against the phi_max ray (pallas_intersect.py:59-70).  phi_max: a row's
    float or one f32 per lane."""
    if torch.is_tensor(phi_max):
        cross = x * torch.sin(phi_max) - y * torch.cos(phi_max)
        return torch.where(phi_max <= _F(math.pi), (y >= 0.0) & (cross >= 0.0),
                           ~((y < 0.0) & (cross < 0.0)))
    cross = x * float(np.sin(_F(phi_max))) - y * float(np.cos(_F(phi_max)))
    if _F(phi_max) <= _F(math.pi):
        return (y >= 0.0) & (cross >= 0.0)
    return ~((y < 0.0) & (cross < 0.0))


def _flag(x):
    """A row's comparison as a Python bool; a per-lane one stays a tensor."""
    return x if torch.is_tensor(x) else bool(x)


def prim_test(ptype: int, m, pr, ox, oy, oz, dx, dy, dz, t_limit,
              full_sph: bool = False, full_disk: bool = False,
              tally=None, active=None) -> torch.Tensor:
    """One primitive kind vs a batch of rays -> candidate t (BIG on a miss).

    m: 12 world->object entries (row-major 3x4); pr: 9 params (see
    ops/intersect.Primitives); each entry is either one row's float, for a
    primitive tested against every lane (the brute sweep), or an f32[N]
    tensor, one primitive per lane (the BVH walk's leaf tests,
    ``ops/bvh.prim_test_records``).  t_limit: f32[N].  tally: optional dict
    that counts, over the lanes of the bool mask ``active`` (every lane
    where it is None), the tests one thread per ray makes: "sphere_tests",
    "sphere_roots" (spheres whose discriminant passes), "disk_tests" and
    "triangle_tests".
    """
    if tally is not None:
        key = {SPHERE: "sphere_tests", DISK: "disk_tests"}.get(ptype, "triangle_tests")
        tally[key] = tally.get(key, 0) + (ox.numel() if active is None else int(active.sum()))
    if ptype == TRIANGLE:
        return _triangle(pr, ox, oy, oz, dx, dy, dz, t_limit)
    oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
    ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
    ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
    odx = m[0] * dx + m[1] * dy + m[2] * dz
    ody = m[4] * dx + m[5] * dy + m[6] * dz
    odz = m[8] * dx + m[9] * dy + m[10] * dz
    if ptype == SPHERE:
        return _sphere(pr, oox, ooy, ooz, odx, ody, odz, t_limit, full_sph,
                       tally, active)
    if ptype == DISK:
        return _disk(pr, oox, ooy, ooz, odx, ody, odz, t_limit, full_disk)
    raise ValueError(f"unknown primitive type {ptype}")


def _sphere(pr, oox, ooy, ooz, odx, ody, odz, t_limit, full_sph, tally=None,
            active=None):
    """Recentred quadratic (perpendicular-foot form) with reprojected clips
    (params: radius, zmin, zmax, phimax)."""
    radius = pr[0]
    a = odx * odx + ody * ody + odz * odz
    safe_a = torch.where(a == 0.0, 1.0, a)
    t_foot = -(oox * odx + ooy * ody + ooz * odz) / safe_a
    fx = oox + odx * t_foot
    fy = ooy + ody * t_foot
    fz = ooz + odz * t_foot
    disc_core = radius * radius - (fx * fx + fy * fy + fz * fz)
    ok = (disc_core >= 0.0) & (a > 0.0)
    if tally is not None:
        roots = ok if active is None else ok & active
        tally["sphere_roots"] = tally.get("sphere_roots", 0) + int(roots.sum())
    delta = torch.sqrt(torch.clamp(disc_core, min=0.0) / safe_a)
    lo = t_foot - delta
    hi = t_foot + delta
    olen = torch.sqrt(torch.clamp(oox * oox + ooy * ooy + ooz * ooz, min=1.0))
    dlen = torch.sqrt(torch.clamp(a, min=1e-20))
    t_eps = 1e-4 * olen / dlen

    full = full_sph or _flag((pr[1] <= -radius) & (pr[2] >= radius)
                             & (pr[3] >= _TWO_PI_CLIP))

    def clip_ok(t):
        if full is True:
            return True
        px = oox + odx * t
        py = ooy + ody * t
        pz = ooz + odz * t
        norm = torch.sqrt(torch.clamp(px * px + py * py + pz * pz, min=1e-20))
        s = radius / norm
        pz = pz * s
        return full | ((pz >= pr[1]) & (pz <= pr[2]) & _in_wedge(px * s, py * s, pr[3]))

    v0 = ok & (lo > t_eps) & (lo < t_limit) & clip_ok(lo)
    v1 = ok & (hi > t_eps) & (hi < t_limit) & clip_ok(hi)
    return torch.where(v0, lo, torch.where(v1, hi, BIG))


def _disk(pr, oox, ooy, ooz, odx, ody, odz, t_limit, full_disk):
    """Plane hit inside the annulus and the phi wedge (params: height,
    radius, inner, phimax)."""
    parallel = torch.abs(odz) < 1e-12
    t_pl = (pr[0] - ooz) / torch.where(parallel, 1.0, odz)
    pxd = oox + odx * t_pl
    pyd = ooy + ody * t_pl
    d2 = pxd * pxd + pyd * pyd
    vd = (~parallel) & (t_pl > 1e-4) & (t_pl < t_limit) & (d2 <= pr[1] * pr[1])
    if not full_disk:
        vd = vd & (d2 >= pr[2] * pr[2])
        whole = _flag(pr[3] >= _TWO_PI_CLIP)
        if whole is not True:
            vd = vd & (whole | _in_wedge(pxd, pyd, pr[3]))
    return torch.where(vd, t_pl, BIG)


def _triangle(pr, ox, oy, oz, dx, dy, dz, t_limit):
    """World-space Moller-Trumbore (params: the three vertices)."""
    e1 = [pr[3 + k] - pr[k] for k in range(3)]
    e2 = [pr[6 + k] - pr[k] for k in range(3)]
    pvx = dy * e2[2] - dz * e2[1]
    pvy = dz * e2[0] - dx * e2[2]
    pvz = dx * e2[1] - dy * e2[0]
    det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
    degen = torch.abs(det) < 1e-12
    inv_det = 1.0 / torch.where(degen, 1.0, det)
    tvx, tvy, tvz = ox - pr[0], oy - pr[1], oz - pr[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1[2] - tvz * e1[1]
    qvy = tvz * e1[0] - tvx * e1[2]
    qvz = tvx * e1[1] - tvy * e1[0]
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * inv_det
    vt = (~degen) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > 1e-4) & (
        tt < t_limit
    )
    return torch.where(vt, tt, BIG)


FLAG_FULL_SPH = 1
FLAG_FULL_DISK = 2

# A kernel row of the table (``BruteTable.rec``, f32[P, REC_K], six 16-byte
# words): world->object (12), the type as a float, params (9), padding; the
# first four words hold all that a full sphere or disk reads.
REC_K = 24
REC_TYPE = 12
REC_PARAMS = 13

# The compile-time instances of csrc/intersect.cu: spheres and disks, all
# full (no clip, no triangle code); and every shape with its clips.
INSTANCE_FULL_SPH_DISK = 0
INSTANCE_GENERAL = 1

# A lane with t_max <= DEAD_T_MAX is dead where ``dead_d2`` says so: no
# disk or triangle accepts t <= 1e-4 (csrc/prim_test.cuh), and a sphere
# only where the ray's direction is long in its object space (see
# ``dead_d2``).  The integrators mark a dead lane with t_max 1e-4.
DEAD_T_MAX = float(np.float32(1e-4))
# the margin of dead_d2 on |d|: 1% (squared), far above float rounding
_DEAD_MARGIN2 = 1.01 ** 2


def flat_w2o(prims: Primitives) -> torch.Tensor:
    """Rows 0-2 of each prim's world->object, f32[P, 12] row-major
    (pallas_intersect.py ``_flatten_w2o``)."""
    return prims.world_to_obj[:, :3, :].reshape(prims.count, 12).contiguous()


def dead_d2(ptype: torch.Tensor, w2o: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """f32[1]: the largest |d|^2 at which a ray with t_max <= 1e-4 can hit
    none of these prims (inf without spheres), computed where the table
    lies, with no read back to the host.

    A sphere accepts a root only above t_eps = 1e-4 olen / dlen (olen =
    max(|o'|, 1), dlen = |d'|, o' and d' in object space), so with t_max
    <= 1e-4 it needs olen < dlen (1 + 1e-6).  Where |d'| <= 1 / 1.01 that
    fails: dlen <= 1 and t_eps >= 1e-4.  Where |d'| <= r / 1.01 it puts the
    origin inside the sphere by more than 0.98% of r: the near root is
    negative and the far one beyond 0.0098, far above 1e-4, float rounding
    (about 1e-6 of r / dlen) included.  |d'| <= ||M||_2 |d| for the linear
    part M of world->object, and ||M||_2^2 <= ||M^T M||_inf.  So every
    sphere misses where |d|^2 <= max(1, r^2) / (||M^T M||_inf 1.01^2):
    the least of these over the spheres, in float64, rounded down to f32.
    A sphere of r / ||M||_2 below 1 gives a bound below 1, and unit rays
    then run their tests."""
    if ptype.numel() == 0:
        return torch.full((1,), math.inf, dtype=torch.float32, device=ptype.device)
    m = w2o.to(torch.float64).reshape(-1, 3, 4)[:, :, :3]
    gram = torch.abs(m.transpose(1, 2) @ m).sum(dim=2).amax(dim=1)
    r2 = params[:, 0].to(torch.float64) ** 2
    limit = torch.maximum(r2, torch.ones_like(r2)) / (gram * _DEAD_MARGIN2)
    limit = torch.where(ptype == SPHERE, limit, math.inf)
    return (limit.amin() * (1.0 - 1e-6)).to(torch.float32).reshape(1)


@dataclass(frozen=True, eq=False)
class BruteTable:
    """The primitive table as the brute intersection reads it: the device
    tensors (the kernels read ``rec`` and ``dead_d2``), the static shape
    facts, and the key of the prims it was packed from
    (``ops/packed.py``).  ``models/scene.scene_from_arrays`` packs it once
    as ``Scene.brute``; ``scene_table`` packs again for a scene whose prims
    are no longer those."""

    ptype: torch.Tensor  # int32[P]
    w2o: torch.Tensor  # f32[P,12]: world->object, row-major 3x4
    params: torch.Tensor  # f32[P,9]
    rec: torch.Tensor  # f32[P,REC_K]: the kernels' rows
    dead_d2: torch.Tensor  # f32[1], see dead_d2
    # all spheres full / all disks full: static on the TPU
    # (pallas_intersect.py:240-246); when set, the partial-shape clips are
    # skipped
    full_sph: bool
    full_disk: bool
    types: tuple  # the prim kinds the table may hold
    key: tuple

    @property
    def count(self) -> int:
        return self.ptype.shape[0]

    @property
    def flags(self) -> int:
        return (FLAG_FULL_SPH if self.full_sph else 0) | (
            FLAG_FULL_DISK if self.full_disk else 0)

    @property
    def instance(self) -> int:
        """The kernels' compile-time instance for this table."""
        if set(self.types) <= {SPHERE, DISK} and self.full_sph and self.full_disk:
            return INSTANCE_FULL_SPH_DISK
        return INSTANCE_GENERAL

    @functools.cached_property
    def rows(self) -> list:
        """(ptype, w2o row, params row) per primitive, host floats: what the
        plain versions sweep (read from the device at first use)."""
        return list(zip(self.ptype.tolist(), self.w2o.tolist(), self.params.tolist()))


def _sources(prims: Primitives) -> tuple:
    return (prims.prim_type, prims.world_to_obj, prims.params)


def _rows(ptype: torch.Tensor, w2o: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The kernels' rows f32[P, REC_K] of the flat table."""
    pad = torch.zeros((ptype.shape[0], REC_K - REC_PARAMS - 9), dtype=torch.float32,
                      device=w2o.device)
    return torch.cat([w2o, ptype.to(torch.float32)[:, None], params, pad], dim=1).contiguous()


def brute_table(prims: Primitives) -> BruteTable:
    """Pack ``prims`` for the intersection kernels and their plain versions,
    on the device where they lie."""
    ptype = prims.prim_type.to(torch.int32).contiguous()
    w2o = flat_w2o(prims)
    params = prims.params.contiguous()
    pinfo = prims.pinfo
    return BruteTable(
        ptype, w2o, params, _rows(ptype, w2o, params), dead_d2(ptype, w2o, params),
        pinfo is not None and pinfo.all_full_spheres,
        pinfo is not None and pinfo.all_full_disks,
        tuple(pinfo.types) if pinfo is not None else (SPHERE, DISK, TRIANGLE),
        (packed.key(_sources(prims)), pinfo))


def scene_table(scene) -> BruteTable:
    """The table of ``scene.prims``: ``scene.brute`` while it was packed from
    them, else packed now."""
    t = scene.brute
    prims = scene.prims
    if t is not None and t.key[1] == prims.pinfo and packed.holds(t.key[0], _sources(prims)):
        return t
    return brute_table(prims)


def closest_hit(table: BruteTable, ox, oy, oz, dx, dy, dz, t_limit, tally=None,
                active=None):
    """Brute closest hit over the table rows -> (t_best, idx_best), idx -1
    on a miss (the megakernel's ``closest_hit``, pallas_megakernel.py:290).
    tally / active: see ``prim_test``; every active lane tests every row."""
    t_best = t_limit
    idx_best = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
    for p, (ptype, m, pr) in enumerate(table.rows):
        tp = prim_test(ptype, m, pr, ox, oy, oz, dx, dy, dz, t_best,
                       full_sph=table.full_sph, full_disk=table.full_disk,
                       tally=tally, active=active)
        better = tp < t_best
        t_best = torch.where(better, tp, t_best)
        idx_best = torch.where(better, p, idx_best)
    return t_best, idx_best


def first_hit(table: BruteTable, ox, oy, oz, dx, dy, dz, t_limit, tally=None,
              active=None):
    """Index of the first row (in table order) hit closer than ``t_limit``,
    -1 where none is: the any-hit loop of csrc/megakernel.cu ``occluded``,
    which stops at that row.  Some row is hit exactly where the closest
    hit under ``t_limit`` exists.  tally / active: see ``prim_test``; a lane
    stops counting after its first hit."""
    first = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
    for p, (ptype, m, pr) in enumerate(table.rows):
        testing = None if tally is None else active & (first < 0)
        tp = prim_test(ptype, m, pr, ox, oy, oz, dx, dy, dz, t_limit,
                       full_sph=table.full_sph, full_disk=table.full_disk,
                       tally=tally, active=testing)
        first = torch.where((first < 0) & (tp < t_limit), p, first)
    return first


def intersect_brute(table: BruteTable, o: torch.Tensor, d: torch.Tensor,
                    t_max: torch.Tensor):
    """Closest hit (hit[N], t[N], prim_idx[N]) over the whole table — the
    plain counterpart of ``intersect_brute_pallas``."""
    t, idx = closest_hit(table, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                         d[:, 2], t_max)
    hit = idx >= 0
    return hit, torch.where(hit, t, t_max), torch.clamp(idx, min=0)


def intersect_p_brute(table: BruteTable, o: torch.Tensor, d: torch.Tensor,
                      t_max: torch.Tensor) -> torch.Tensor:
    """Any hit closer than t_max (bool[N]) — the plain counterpart of
    ``intersect_p_brute_pallas``: some row is hit in range."""
    return first_hit(table, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                     t_max) >= 0


# ---------------------------------------------------------------------------
# The wrappers of csrc/intersect.cu
# ---------------------------------------------------------------------------


def _check_rays(table: BruteTable, o, d, t_max):
    if o.dtype != torch.float32 or d.dtype != torch.float32 or t_max.dtype != torch.float32:
        raise TypeError("o, d and t_max must be float32")
    n = o.shape[0]
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape or t_max.shape != (n,):
        raise ValueError(f"o, d must be [N, 3] and t_max [N], got {tuple(o.shape)}, "
                         f"{tuple(d.shape)}, {tuple(t_max.shape)}")
    dev = o.device
    if d.device != dev or t_max.device != dev or table.params.device != dev:
        raise ValueError("rays, t_max and the primitive table must lie on one device")


def _kernel_args(table: BruteTable, o, d, t_max):
    """Pointers and scalars of a launch, all from tensors the caller holds
    across the launch."""
    if o.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {o.device}")
    if not (o.is_contiguous() and d.is_contiguous() and t_max.is_contiguous()):
        raise ValueError("o, d and t_max must be contiguous")
    return (o.data_ptr(), d.data_ptr(), t_max.data_ptr(), o.shape[0], table.rec.data_ptr(),
            table.count, table.dead_d2.data_ptr(), table.instance, table.flags)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def intersect_brute_fused(table: BruteTable, o: torch.Tensor, d: torch.Tensor,
                          t_max: torch.Tensor):
    """Closest hit (hit bool[N], t f32[N], prim_idx int32[N]); t is t_max and
    prim 0 on a miss.  CUDA tensors launch ``gopbrt_intersect`` of
    csrc/intersect.cu on the current stream; CPU tensors run
    ``intersect_brute``."""
    _check_rays(table, o, d, t_max)
    if o.device.type == "cpu":
        return intersect_brute(table, o, d, t_max)
    n = o.shape[0]
    hit = torch.empty((n,), dtype=torch.bool, device=o.device)
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    idx = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n == 0:
        return hit, t, idx
    fn = _build.load("intersect").gopbrt_intersect
    err = fn(*_kernel_args(table, o, d, t_max), hit.data_ptr(), t.data_ptr(),
             idx.data_ptr(), _stream(o.device))
    if err != 0:
        raise RuntimeError(f"intersect launch failed: cudaError_t {err}")
    _build.LAUNCHES["intersect"] += 1
    return hit, t, idx


def intersect_p_brute_fused(table: BruteTable, o: torch.Tensor, d: torch.Tensor,
                            t_max: torch.Tensor) -> torch.Tensor:
    """Any hit closer than t_max (bool[N]).  CUDA tensors launch
    ``gopbrt_intersect_any`` of csrc/intersect.cu on the current stream;
    CPU tensors run ``intersect_p_brute``."""
    _check_rays(table, o, d, t_max)
    if o.device.type == "cpu":
        return intersect_p_brute(table, o, d, t_max)
    n = o.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    if n == 0:
        return occ
    fn = _build.load("intersect").gopbrt_intersect_any
    err = fn(*_kernel_args(table, o, d, t_max), occ.data_ptr(), _stream(o.device))
    if err != 0:
        raise RuntimeError(f"intersect_any launch failed: cudaError_t {err}")
    _build.LAUNCHES["intersect_any"] += 1
    return occ
