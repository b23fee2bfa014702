"""BVH: the host build (SAH or HLBVH), the packed tables, the plain walk
and the wrappers of the BVH intersection kernels.

Counterpart of ``gopbrt_tpu/ops/bvh.py`` and of the TPU cluster kernel
``gopbrt_tpu/ops/pallas_cluster.py``.  The build runs on the host at scene
load: the native C++ builder (``gopbrt_tpu_torch/native``; binned SAH or
HLBVH) or, as the plain version, the NumPy binned-SAH builder, both giving
the flattened depth-first ``LinearBVH`` (bvh.go:80-87, 632-651).

The cluster kernel stands in for a stack walk because the TPU has no
per-lane branching.  On the card the walk itself is the kernel
(``csrc/bvh_intersect.cu`` over ``csrc/bvh.cuh``): one thread walks one
ray, near child first, each interior node one 64-byte fetch that holds
both children's boxes, far children on a stack of STACK_DEPTH entries.
``bvh_intersect`` / ``bvh_intersect_p`` are its plain version, the
lockstep walk of the JAX package's ``_traverse`` over the ``LinearBVH``
columns: every lane advances one node per step, with a per-lane stack;
both test the same leaves in the same order.  The kernels read the tables
``bvh_table`` packs once per scene (``Scene.bvh_tables``): the nodes
(``pack_nodes``) and the primitive records in BVH leaf order, so a leaf
reads contiguous rows.  ``bvh_intersect_fused`` /
``bvh_intersect_p_fused`` launch the kernels on CUDA tensors (counted in
``_build.LAUNCHES``) and run the plain walk on CPU tensors.
"""

from __future__ import annotations

import ctypes
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gopbrt_tpu_torch import _build
from gopbrt_tpu_torch.ops import geom
from gopbrt_tpu_torch.ops import brute_intersect
from gopbrt_tpu_torch.ops.brute_intersect import BIG, FLAG_FULL_DISK, FLAG_FULL_SPH
from gopbrt_tpu_torch.ops.intersect import DISK, SPHERE, TRIANGLE, Primitives

MAX_LEAF = 4
STACK_DEPTH = 64
N_BUCKETS = 12
# the integrators' marker of a dead shadow ray: any-hit lanes with t_max at
# or below it come out unoccluded (pallas_cluster.py:160-169)
DEAD_T_MAX = 2e-4

# primitive record columns (f32[P, REC_K], rows in BVH leaf order), read by
# csrc/bvh.cuh as 16-byte loads: params, type, material, area light, the
# world->object rows (a triangle: its planes), the squared uniform scale
REC_PARAMS = 0   # 0-8
REC_TYPE = 9
REC_MAT = 10
REC_ALID = 11
REC_W2O = 12     # 12-23
REC_SCALE2 = 24
REC_K = 32
# A triangle keeps its Havel-Herout planes in columns 12-23, where a sphere
# or a disk keeps its world->object rows (pallas_mesh_megakernel.py
# :100-119): N = e1 x e2, d_n = N.v0; U = (e2 x N) / |N|^2, d_u = -U.v0;
# V = (N x e1) / |N|^2, d_v = -V.v0; then u = U.p + d_u, v = V.p + d_v.
# an interior node of the packed tree, both children's boxes (csrc/bvh.cuh):
# left lo.xyz, left code, left hi.xyz, split axis, right lo.xyz, right
# code, right hi.xyz, 0; a child's code is its node index if it is
# interior, else ~(first record << LEAF_SHIFT | count).  Node 0 is the
# header: the root's box and code, then zeros.
NODE_K = 16
LEAF_SHIFT = 4


class LinearBVH(NamedTuple):
    """Flattened depth-first BVH (LinearBVHNode, bvh.go:80-87) as SoA."""

    node_lo: torch.Tensor  # f32[Nn,3]
    node_hi: torch.Tensor  # f32[Nn,3]
    node_right: torch.Tensor  # int32[Nn] second-child index (interior), -1 leaf
    node_first: torch.Tensor  # int32[Nn] first ordered-prim index (leaf)
    node_count: torch.Tensor  # int32[Nn] prim count (leaf), 0 interior
    node_axis: torch.Tensor  # int32[Nn] split axis (interior)
    prim_order: torch.Tensor  # int32[P] ordered primitive ids


# ---------------------------------------------------------------------------
# The host build
# ---------------------------------------------------------------------------


def _prim_bounds_np(builder) -> tuple[np.ndarray, np.ndarray]:
    los, his = zip(*[builder._prim_world_bounds(i)
                     for i in range(len(builder._prim_type))])
    return np.asarray(los, np.float32), np.asarray(his, np.float32)


def build_from_bounds(lo: np.ndarray, hi: np.ndarray, backend: str = "auto",
                      method: str = "sah") -> LinearBVH:
    """Build the flat BVH (host tensors).  backend: "auto" prefers the
    native C++ builder and falls back to NumPy; "native" / "numpy" force
    one.  method: "sah" (binned SAH) or "hlbvh" (native only, as in the
    reference: "numpy" raises, and "auto" without the native library
    builds SAH; ``build_timed`` says which was built)."""
    return build_timed(lo, hi, backend, method)[0]


def build_timed(lo: np.ndarray, hi: np.ndarray, backend: str = "auto",
                method: str = "sah") -> tuple[LinearBVH, str, str, float]:
    """``build_from_bounds`` -> (tree, the backend that built it, the method
    it built, build ms)."""
    from gopbrt_tpu_torch import native

    if method not in native.METHODS:
        raise ValueError(f"unknown BVH method {method!r}")
    if backend == "numpy" and method != "sah":
        raise ValueError(f"the NumPy builder builds SAH only, not {method!r}")
    t0 = time.perf_counter()
    if backend in ("auto", "native"):
        out = native.bvh_build(np.asarray(lo, np.float32), np.asarray(hi, np.float32),
                               max_leaf=MAX_LEAF, n_buckets=N_BUCKETS, method=method)
        if out is not None:
            bvh = LinearBVH(*(torch.as_tensor(a) for a in out))
            return bvh, "native", method, (time.perf_counter() - t0) * 1e3
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable (no C++ toolchain?)")
    elif backend != "numpy":
        raise ValueError(f"unknown BVH backend {backend!r}")
    bvh = _build_from_bounds_numpy(lo, hi)
    return bvh, "numpy", "sah", (time.perf_counter() - t0) * 1e3


def _build_from_bounds_numpy(lo: np.ndarray, hi: np.ndarray) -> LinearBVH:
    """Binned SAH, 12 buckets (bvh.go:272-411), depth-first flattened
    (bvh.py:100-203)."""
    p = lo.shape[0]
    centroids = 0.5 * (lo + hi)
    order: list[int] = []
    n_lo, n_hi, n_right, n_first, n_count, n_axis = [], [], [], [], [], []

    def alloc():
        n_lo.append(np.zeros(3, np.float32))
        n_hi.append(np.zeros(3, np.float32))
        n_right.append(-1)
        n_first.append(0)
        n_count.append(0)
        n_axis.append(0)
        return len(n_lo) - 1

    def make_leaf(node, ids):
        n_first[node] = len(order)
        n_count[node] = ids.size
        order.extend(ids.tolist())

    def split_ids(ids, blo, bhi):
        """(left_ids, right_ids, axis), or None to make a leaf."""
        c = centroids[ids]
        clo, chi = c.min(axis=0), c.max(axis=0)
        extent = chi - clo
        axis = int(np.argmax(extent))
        if extent[axis] < 1e-12:
            mid = ids.size // 2  # degenerate: equal counts (bvh.go fallback)
            return ids[:mid], ids[mid:], axis
        b = np.minimum((N_BUCKETS * (c[:, axis] - clo[axis]) / extent[axis]).astype(np.int64),
                       N_BUCKETS - 1)
        costs = np.full(N_BUCKETS - 1, np.inf)
        for split in range(N_BUCKETS - 1):
            lmask = b <= split
            nl = int(lmask.sum())
            nr = ids.size - nl
            if nl == 0 or nr == 0:
                continue
            sa_l = _surface_area(lo[ids[lmask]].min(axis=0), hi[ids[lmask]].max(axis=0))
            sa_r = _surface_area(lo[ids[~lmask]].min(axis=0), hi[ids[~lmask]].max(axis=0))
            costs[split] = 0.125 + (nl * sa_l + nr * sa_r) / max(_surface_area(blo, bhi), 1e-20)
        best = int(np.argmin(costs))
        if costs[best] < ids.size or ids.size > MAX_LEAF:
            if np.isfinite(costs[best]):
                lmask = b <= best
            else:  # all prims in one bucket: median split
                med = np.argsort(c[:, axis], kind="stable")
                lmask = np.zeros(ids.size, bool)
                lmask[med[: ids.size // 2]] = True
            return ids[lmask], ids[~lmask], axis
        return None

    def build(ids) -> int:
        """Depth-first: the left child is node + 1, the right child's index
        is stored."""
        node = alloc()
        blo = lo[ids].min(axis=0)
        bhi = hi[ids].max(axis=0)
        n_lo[node], n_hi[node] = blo, bhi
        split = None if ids.size <= MAX_LEAF else split_ids(ids, blo, bhi)
        if split is None:
            make_leaf(node, ids)
            return node
        left_ids, right_ids, axis = split
        n_axis[node] = axis
        build(left_ids)  # == node + 1
        n_right[node] = build(right_ids)
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * int(np.log2(max(p, 2))) * 64))
    try:
        build(np.arange(p, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old_limit)
    ints = [torch.as_tensor(np.asarray(v, np.int32))
            for v in (n_right, n_first, n_count, n_axis, order)]
    return LinearBVH(torch.as_tensor(np.stack(n_lo)), torch.as_tensor(np.stack(n_hi)),
                     *ints)


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])


# ---------------------------------------------------------------------------
# The packed tables
# ---------------------------------------------------------------------------


class BVHTable(NamedTuple):
    """The tree and the primitive records as the walk reads them, packed
    once per scene (``Scene.bvh_tables``): the kernels read ``nodes`` and
    ``records``, the plain walk the tree's SoA columns and ``records``."""

    bvh: LinearBVH  # on the scene's device
    nodes: torch.Tensor  # f32[1 + interior nodes, NODE_K]; the ints as their bits
    records: torch.Tensor  # f32[P, REC_K], rows in leaf order
    full_sph: bool
    full_disk: bool
    # which builder made the tree and in how many ms (None: carried across)
    backend: Optional[str] = None
    build_ms: Optional[float] = None
    # packed from an animated table (its nodes bound the shutter's motion):
    # the walk kernels refuse it; the plain walk tests moving prims per lane
    animated: bool = False

    @property
    def flags(self) -> int:
        return (FLAG_FULL_SPH if self.full_sph else 0) | (
            FLAG_FULL_DISK if self.full_disk else 0)


def prim_scale2(prims: Primitives) -> torch.Tensor:
    """sigma^2 of each prim's uniform scale, from the world->object rows
    (ops/megakernel.shade_table's SH_SCALE2)."""
    lin = prims.world_to_obj[:, :3, :3]
    inv_s2 = torch.sum(lin[:, 0, :] * lin[:, 0, :], dim=-1)
    return 1.0 / torch.clamp(inv_s2, min=1e-30)


def pack_nodes(bvh: LinearBVH) -> torch.Tensor:
    """The tree as csrc/bvh.cuh walks it: f32[1 + interior nodes, NODE_K],
    the header then each interior node (in the tree's depth-first order)
    with both children's boxes and codes."""
    dev = bvh.node_lo.device
    leaf = bvh.node_count > 0
    if int(bvh.node_count.max()) >= 1 << LEAF_SHIFT:
        raise ValueError(f"leaves hold at most {(1 << LEAF_SHIFT) - 1} prims")
    inner = torch.nonzero(~leaf).flatten()
    index = torch.zeros_like(bvh.node_count)
    index[inner] = torch.arange(1, inner.numel() + 1, dtype=index.dtype, device=dev)
    code = torch.where(leaf, -1 - ((bvh.node_first << LEAF_SHIFT) | bvh.node_count), index)

    def bits(x):
        return x.to(torch.int32).contiguous().view(torch.float32)[:, None]

    def child(c):
        return bvh.node_lo[c], bits(code[c]), bvh.node_hi[c]

    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    header = torch.cat([*child(zero.long()), bits(zero), torch.zeros((1, 8), device=dev)], 1)
    left, right = inner + 1, bvh.node_right[inner].long()
    body = torch.cat([*child(left), bits(bvh.node_axis[inner]), *child(right),
                      bits(torch.zeros_like(inner))], dim=1)
    return torch.cat([header, body]).contiguous()


def triangle_planes(params: np.ndarray) -> np.ndarray:
    """Each triangle's Havel-Herout planes, f32[T, 12] (N, d_n, U, d_u, V,
    d_v), from its world-space vertices f32[T, 9]: in f32 on the host, with
    the formulas of build_mesh_tables (pallas_mesh_megakernel.py:266-286)."""
    p9 = np.asarray(params, np.float32)
    v0 = p9[:, 0:3]
    e1 = p9[:, 3:6] - v0
    e2 = p9[:, 6:9] - v0
    nrm = np.cross(e1, e2).astype(np.float32)
    n2 = np.maximum((nrm * nrm).sum(-1, keepdims=True), 1e-30).astype(np.float32)
    uu = (np.cross(e2, nrm).astype(np.float32) / n2).astype(np.float32)
    vv = (np.cross(nrm, e1).astype(np.float32) / n2).astype(np.float32)
    out = np.zeros((p9.shape[0], 12), np.float32)
    out[:, 0:3] = nrm
    out[:, 3] = (nrm * v0).sum(-1)
    out[:, 4:7] = uu
    out[:, 7] = -(uu * v0).sum(-1)
    out[:, 8:11] = vv
    out[:, 11] = -(vv * v0).sum(-1)
    return out


def bvh_table(bvh: LinearBVH, prims: Primitives, backend: Optional[str] = None,
              build_ms: Optional[float] = None) -> BVHTable:
    """Pack the tree and ``prims`` (in the tree's leaf order) for the walk;
    backend / build_ms: how the tree was built, where it was built here."""
    f32 = torch.float32
    nodes = pack_nodes(bvh)
    order = bvh.prim_order.long()
    p = prims.count
    dev = prims.params.device
    records = torch.zeros((p, REC_K), dtype=f32, device=dev)
    records[:, REC_PARAMS:REC_PARAMS + 9] = prims.params[order]
    records[:, REC_TYPE] = prims.prim_type[order].to(f32)
    records[:, REC_MAT] = prims.material_id[order].to(f32)
    records[:, REC_ALID] = prims.area_light_id[order].to(f32)
    records[:, REC_W2O:REC_W2O + 12] = prims.world_to_obj[order, :3, :].reshape(p, 12)
    tri = torch.nonzero(records[:, REC_TYPE] == TRIANGLE).flatten()
    if tri.numel():
        planes = triangle_planes(records[tri, REC_PARAMS:REC_PARAMS + 9].cpu().numpy())
        records[tri, REC_W2O:REC_W2O + 12] = torch.as_tensor(planes, device=dev)
    records[:, REC_SCALE2] = prim_scale2(prims)[order]
    pinfo = prims.pinfo
    return BVHTable(bvh, nodes, records.contiguous(),
                    pinfo is not None and pinfo.all_full_spheres,
                    pinfo is not None and pinfo.all_full_disks, backend, build_ms,
                    prims.anim is not None)


# ---------------------------------------------------------------------------
# The plain walk
# ---------------------------------------------------------------------------


def plane_test(planes, o, d, t_limit, tally=None) -> torch.Tensor:
    """The Havel-Herout plane-form ray-triangle test of the mesh megakernel
    (csrc/prim_test.cuh plane_test; pallas_mesh_megakernel.py _tri_test_h,
    :330-354) -> candidate t (BIG on a miss).  planes f32[N, 12] (N, d_n,
    U, d_u, V, d_v, one triangle per lane); o, d f32[N, 3]; t_limit f32[N].
    The accept region of the vertex form: |N.d| >= 1e-12, u >= 0, v >= 0,
    u + v <= 1, 1e-4 < t < t_limit.  tally: counts "plane_tests"."""
    if tally is not None:
        tally["plane_tests"] = tally.get("plane_tests", 0) + o.shape[0]
    nx, ny, nz, dn, ux, uy, uz, du, vx, vy, vz, dv = planes.unbind(-1)
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    den = nx * dx + ny * dy + nz * dz
    degen = torch.abs(den) < 1e-12
    tt = (dn - (nx * ox + ny * oy + nz * oz)) / torch.where(degen, 1.0, den)
    px = ox + tt * dx
    py = oy + tt * dy
    pz = oz + tt * dz
    u = ux * px + uy * py + uz * pz + du
    v = vx * px + vy * py + vz * pz + dv
    hit = ~degen & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > 1e-4) & (tt < t_limit)
    return torch.where(hit, tt, BIG)


def prim_test_records(rec, o, d, t_limit, full_sph=False, full_disk=False,
                      tally=None, plane=False) -> torch.Tensor:
    """Each lane's ray against its own primitive record -> candidate t (BIG
    on a miss): ``brute_intersect.prim_test`` with one record per lane.
    rec f32[N, REC_K]; o, d f32[N, 3]; t_limit f32[N].  tally: see
    ``brute_intersect.prim_test``, over every lane.  plane: triangles take
    the plane-form ``plane_test`` of their record's planes (the mesh
    megakernel's walk) instead of the vertex form (the walk kernels')."""
    ptype = rec[:, REC_TYPE].to(torch.int32)
    out = torch.full_like(t_limit, BIG)
    for kind in (TRIANGLE, SPHERE, DISK):
        sel = torch.nonzero(ptype == kind).flatten()
        if sel.numel() == 0:
            continue
        r = rec[sel]
        if plane and kind == TRIANGLE:
            out[sel] = plane_test(r[:, REC_W2O:REC_W2O + 12], o[sel], d[sel], t_limit[sel],
                                  tally)
            continue
        out[sel] = brute_intersect.prim_test(
            kind, r[:, REC_W2O:REC_W2O + 12].unbind(-1), r[:, REC_PARAMS:REC_PARAMS + 9].unbind(-1),
            *o[sel].unbind(-1), *d[sel].unbind(-1), t_limit[sel], full_sph, full_disk, tally)
    return out


def _inv_dir(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)


def walk(table: BVHTable, o: torch.Tensor, d: torch.Tensor, t_max: torch.Tensor,
         any_hit: bool = False, tally=None, steps: Optional[torch.Tensor] = None,
         plane: bool = False, anim=None, time: Optional[torch.Tensor] = None):
    """The lockstep walk (bvh.py:212-312) -> (t f32[N], slot int64[N]):
    the nearest hit closer than t_max and its record row (-1 and t_max
    where none is).  any_hit: a lane stops at its first accepted leaf hit,
    and lanes with t_max <= DEAD_T_MAX are not walked.

    Every lane advances one node per step: a box test against the lane's
    best t, then a leaf's prims (up to MAX_LEAF, in order, a hit kept only
    when strictly closer) or an interior's near child (the second child
    when the ray's direction is negative on the split axis), the far child
    pushed on the lane's stack; a lane whose stack is empty is done.  Done
    lanes leave the working set.

    tally: optional dict; gets the events of csrc/bvh.cuh's walk on these
    rays, which visits the same leaves in the same order: "bvh_roots" (the
    root's box test, one a walked lane), "bvh_nodes" (interior nodes
    expanded, both children's boxes tested), "bvh_pops" (stack pops: the
    far children whose box was hit along with the near child's) and the
    leaf tests by kind (see ``prim_test_records``).  steps: optional
    int64[N]; each lane's steps of csrc/bvh.cuh's walk (the leaves and
    interior nodes it visits) are added to it.  plane: triangles take the
    plane-form test (the mesh megakernel's walk; see
    ``prim_test_records``)."""
    bvh = table.bvh
    n = o.shape[0]
    dev = o.device
    t_out = t_max.clone()
    slot_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lane = torch.nonzero(t_max > DEAD_T_MAX if any_hit else
                         torch.ones((n,), dtype=torch.bool, device=dev)).flatten()
    o, d, t_best = o[lane], d[lane], t_max[lane]
    tm = None if anim is None else time[lane]
    inv_d = _inv_dir(d)
    m = lane.numel()
    slot = torch.full((m,), -1, dtype=torch.int64, device=dev)
    node = torch.zeros((m,), dtype=torch.int64, device=dev)
    sp = torch.zeros((m,), dtype=torch.int64, device=dev)
    stack = torch.zeros((m, STACK_DEPTH), dtype=torch.int64, device=dev)
    k_slots = torch.arange(MAX_LEAF, device=dev)
    node_count = bvh.node_count.long()
    if tally is not None:
        # whether each stack entry is on the stack of csrc/bvh.cuh too
        pushed = torch.zeros((m, STACK_DEPTH), dtype=torch.bool, device=dev)
        if m:
            tally["bvh_roots"] = tally.get("bvh_roots", 0) + m
    while m:
        rows = torch.arange(m, device=dev)
        box = geom.bounds_intersect_p(bvh.node_lo[node], bvh.node_hi[node], o, d, t_best,
                                      inv_d)
        cnt = node_count[node]
        leaf = box & (cnt > 0)
        found = torch.zeros_like(leaf)
        li = torch.nonzero(leaf).flatten()
        if li.numel():
            # a leaf's tests all at once: the nearest accepted prim, the
            # first in order on a tie, is what the sequential loop keeps
            first = bvh.node_first[node[li]].long()
            pl, pk = torch.nonzero(k_slots[None, :] < cnt[li][:, None], as_tuple=True)
            lanes_p = li[pl]
            rec = table.records[first[pl] + pk]
            if anim is not None:
                rec = _moving_records(table, anim, first[pl] + pk, tm[lanes_p], rec)
            tp = prim_test_records(rec, o[lanes_p], d[lanes_p],
                                   t_best[lanes_p], table.full_sph, table.full_disk, tally,
                                   plane)
            tmat = torch.full((li.numel(), MAX_LEAF), float("inf"), device=dev)
            tmat[pl, pk] = tp
            k_best = torch.argmin(tmat, dim=1)
            t_new = tmat[torch.arange(li.numel(), device=dev), k_best]
            better = t_new < t_best[li]
            t_best[li] = torch.where(better, t_new, t_best[li])
            slot[li] = torch.where(better, first + k_best, slot[li])
            if any_hit:
                found[li] = better
        # interior: descend the near child, push the far one
        inter = box & (cnt == 0)
        dir_neg = inv_d[rows, bvh.node_axis[node].long()] < 0.0
        left, right = node + 1, bvh.node_right[node].long()
        near = torch.where(dir_neg, right, left)
        far = torch.where(dir_neg, left, right)
        ii = torch.nonzero(inter).flatten()
        at = torch.clamp(sp[ii], max=STACK_DEPTH - 1)
        stack[ii, at] = far[ii]
        if tally is not None:
            # csrc/bvh.cuh tests both children here and pushes the far one
            # only when both boxes are hit
            def child_hit(c):
                return geom.bounds_intersect_p(bvh.node_lo[c[ii]], bvh.node_hi[c[ii]], o[ii],
                                               d[ii], t_best[ii], inv_d[ii])

            pushed[ii, at] = child_hit(near) & child_hit(far)
            tally["bvh_nodes"] = tally.get("bvh_nodes", 0) + ii.numel()
        if steps is not None:
            steps[lane] += box.long()
        sp = torch.where(inter, torch.clamp(sp + 1, max=STACK_DEPTH), sp)
        # otherwise pop
        can_pop = sp > 0
        pop = ~inter & can_pop
        sp = torch.where(pop, sp - 1, sp)
        popped = stack[rows, torch.clamp(sp, 0, STACK_DEPTH - 1)]
        if tally is not None:  # an any hit that found its hit ends here
            pops = pop & ~found & pushed[rows, torch.clamp(sp, 0, STACK_DEPTH - 1)]
            tally["bvh_pops"] = tally.get("bvh_pops", 0) + int(pops.sum())
        node = torch.where(inter, near, popped)
        done = (~inter & ~can_pop) | found
        if bool(done.any()):
            fin = torch.nonzero(done).flatten()
            t_out[lane[fin]] = t_best[fin]
            slot_out[lane[fin]] = slot[fin]
            keep = torch.nonzero(~done).flatten()
            lane, o, d, inv_d, t_best, slot, node, sp, stack = (
                x[keep] for x in (lane, o, d, inv_d, t_best, slot, node, sp, stack))
            if tm is not None:
                tm = tm[keep]
            if tally is not None:
                pushed = pushed[keep]
            m = lane.numel()
    return t_out, slot_out


def _moving_records(table: BVHTable, anim, slots, time, rec):
    """The records ``rec`` of ``slots`` with each animated prim's
    world->object at its lane's ``time``."""
    from gopbrt_tpu_torch.ops.intersect import anim_o2w

    pid = table.bvh.prim_order[slots].long()
    sel = torch.nonzero(anim.animated[pid]).flatten()
    if sel.numel() == 0:
        return rec
    w2o = torch.linalg.inv(anim_o2w(anim, pid[sel], time[sel]))
    rec = rec.clone()
    rec[sel, REC_W2O:REC_W2O + 12] = w2o[:, :3, :].reshape(-1, 12)
    return rec


def bvh_intersect(table: BVHTable, o: torch.Tensor, d: torch.Tensor, t_max: torch.Tensor,
                  tally=None, anim=None, time=None):
    """Closest hit (bvh.go:659-712) -> (hit bool[N], t f32[N], prim int32[N]);
    t_max and prim 0 on a miss.  anim / time: see ``walk``."""
    t, slot = walk(table, o, d, t_max, tally=tally, anim=anim, time=time)
    hit = slot >= 0
    prim = table.bvh.prim_order[torch.clamp(slot, min=0)]
    return hit, torch.where(hit, t, t_max), torch.where(hit, prim, 0).to(torch.int32)


def bvh_intersect_p(table: BVHTable, o: torch.Tensor, d: torch.Tensor, t_max: torch.Tensor,
                    tally=None, anim=None, time=None) -> torch.Tensor:
    """Any hit closer than t_max (bvh.go:713-765) -> bool[N]; lanes with
    t_max <= DEAD_T_MAX are unoccluded.  anim / time: see ``walk``."""
    return walk(table, o, d, t_max, any_hit=True, tally=tally, anim=anim, time=time)[1] >= 0


# ---------------------------------------------------------------------------
# The wrappers of csrc/bvh_intersect.cu
# ---------------------------------------------------------------------------


_P, _I = ctypes.c_void_p, ctypes.c_int
# o, d, t_max, n, nodes, records, (prim_order,) flags, then the outputs
HIT = _build.Entry("bvh_intersect", "gopbrt_bvh_intersect", "bvh_intersect",
                   (_P,) * 3 + (_I, _P, _P, _P, _I) + (_P,) * 3)
ANY = _build.Entry("bvh_intersect", "gopbrt_bvh_intersect_any", "bvh_intersect_any",
                   (_P,) * 3 + (_I, _P, _P, _I, _P))


def _launch_args(table: BVHTable, o, d, t_max) -> tuple:
    """Checks the rays (on the CPU too); the pointers and scalars of a
    launch on them, from tensors the caller holds across the launch."""
    _build.check_rays(o, d, t_max, device=table.nodes.device, card=o.device.type != "cpu",
                      bvh=table, animated=table.animated)
    return (o.data_ptr(), d.data_ptr(), t_max.data_ptr(), o.shape[0], table.nodes.data_ptr(),
            table.records.data_ptr())


def bvh_intersect_fused(table: BVHTable, o: torch.Tensor, d: torch.Tensor,
                        t_max: torch.Tensor):
    """Closest hit (hit bool[N], t f32[N], prim int32[N]).  CUDA tensors
    launch ``gopbrt_bvh_intersect`` of csrc/bvh_intersect.cu on the current
    stream; CPU tensors run ``bvh_intersect``."""
    args = _launch_args(table, o, d, t_max)
    if o.device.type == "cpu":
        return bvh_intersect(table, o, d, t_max)
    return _build.launch_lanes(HIT, o.device, o.shape[0],
                               (*args, table.bvh.prim_order.data_ptr(), table.flags),
                               torch.bool, torch.float32, torch.int32)


def bvh_intersect_p_fused(table: BVHTable, o: torch.Tensor, d: torch.Tensor,
                          t_max: torch.Tensor) -> torch.Tensor:
    """Any hit closer than t_max (bool[N]).  CUDA tensors launch
    ``gopbrt_bvh_intersect_any`` of csrc/bvh_intersect.cu on the current
    stream; CPU tensors run ``bvh_intersect_p``."""
    args = _launch_args(table, o, d, t_max)
    if o.device.type == "cpu":
        return bvh_intersect_p(table, o, d, t_max)
    return _build.launch_lanes(ANY, o.device, o.shape[0], (*args, table.flags), torch.bool)[0]
