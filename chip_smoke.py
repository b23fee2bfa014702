#!/usr/bin/env python3
"""GPU gate of the PyTorch/CUDA port: the path traces on one card.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises, so the script exits
non-zero and never prints the last line:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: compiles the CUDA sources of gopbrt_tpu_torch (first use), one
   nvcc per source, all at once, and the host BVH builder (g++); prints
   each kernel's registers and spill bytes (ptxas) and the local loads and
   stores of its SASS (cuobjdump: spills and the walk's stack);
3. kernel vs plain, each kernel against its plain PyTorch version on the
   same inputs:
   - the bounce megakernel on one 1920x273 band of the 1080p demo at depth
     10 (the main path's launch shape), and on a lobe scene (checker floor,
     matte, mirror, smooth and rough glass, sphere lamp) at 256x256, depth 8;
   - the closest-hit and any-hit kernels (csrc/intersect.cu) on every
     launch of ``li_direct`` over one band of BASELINE config 1 at 1080p
     (camera rays, shadow rays, the bounces' rays; the instance that ran,
     the dead lanes, answered without a test, and how many of them differ
     from the plain answer, which must be none), and on a 300-prim table
     of every shape kind (the general instance);
   - the general wavefront chain (``_li_wavefront`` on the intersection
     kernels) against the megakernel on the demo band, depth 10, and
     ``li_direct`` on the kernels against ``li_direct`` on the plain
     intersection;
   - on the 10,224-triangle mesh scene (BASELINE config 3, 10,226 prims,
     its BVH built by the native builder): the BVH walk kernels
     (csrc/bvh_intersect.cu) against the brute-force kernels on a band of
     camera rays and of shadow rays, and against the plain walk on every
     launch of ``_li_wavefront`` over a band of the same mesh in metal (the
     general chain on the BVH); the mesh megakernel
     (csrc/mesh_megakernel.cu) against ``path_li_plain(accel="bvh")`` and
     against ``_li_wavefront`` on the kernels, on one band at depth 5;
   - scenes made with ``_replace`` (the reference's gradient idiom), each
     against its plain version at the kernel's bar and changed from the
     base scene's result: the megakernel on the demo band with kd and the
     lights' intensity changed, ``li_direct`` on the brute kernels with the
     spheres moved, the mesh megakernel with the lights' intensity changed;
4. main paths, each through ``render_pass`` with the launch counts set to 0
   just before it and read just after; one warm-up pass, then 5 timed passes
   and one more under ``torch.profiler`` (host ms of each ``render.*`` range,
   the device's busy time):
   - the demo at 1920x1080, 1 spp, path depth 10: 4 megakernel launches per
     pass; then ``render`` at 4 spp, ``develop`` and ``write_png``;
   - config 1 at 1920x1080, 1 spp, direct lighting depth 3, one light per
     vertex: 16 closest-hit and 12 any-hit launches per pass;
   - a scene outside the fast path (plastic, metal, Oren-Nayar, a triangle,
     a disk lamp, a uv checker, the power light distribution) at
     1920x1080, path depth 5: a finite, non-black image;
   - the mesh scene at 1920x1080, 1 spp, path depth 5 (benchmarks/
     bench_mesh.py's workload): 4 mesh megakernel launches per pass;
   - the metal mesh, the general chain on the BVH, at 1920x1080, depth 5:
     BVH walk launches only;
5. the kernels line: time per launch (the BVH walk's also on a band's
   last launch), launches, bound, plain time, device ms per pass from the
   profiled passes.  The brute kernels are timed on every launch of the
   config-1 band, beside the device ms of that launch in the profiled
   pass and its bound by two methods: the work the function needs (the
   tests of the lanes that are not dead, the bytes every lane moves) and
   every lane testing every prim.

Beside the kernel times, ``[lane-slots]`` lines give the lane-slot
efficiency of a launch of one thread per item on the redesigned kernels'
bands (the demo band, the mesh band, the metal mesh's camera and first
shadow rays): the per-item steps the plain versions count (a path's
bounces, a walk's nodes) over the slots of warps of 32 lanes.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, the script fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# bytes per path: o, d, pixel, sample in (32), radiance out (12)
BYTES_PER_PATH = 44
# bytes per ray of the intersection kernels: o, d, t_max in (28); out hit,
# t, prim (9) or occluded (1); bytes per table row: the kernels' 24-word
# row (brute_intersect.REC_K)
BYTES_PER_RAY_CLOSEST, BYTES_PER_RAY_ANY, BYTES_PER_PRIM = 37, 29, 96

W, H, DEPTH = 1920, 1080, 10
MESH_DEPTH = 5
N_PASSES = 5
# __global__ functions of csrc/*.cu, as the profiler names their launches
OWN_KERNELS = ("mega_kernel", "closest_hit_kernel", "any_hit_kernel",
               "bvh_closest_kernel", "bvh_any_kernel", "mesh_kernel")
# the compile-time instances of csrc/intersect.cu (brute_intersect.INSTANCE_*)
INSTANCES = ("full spheres and disks", "general")
# the kernels' wrappers by intersector: closest hit, any hit
FUSED = {"brute": ("intersect_brute_fused", "intersect_p_brute_fused"),
         "bvh": ("bvh_intersect_fused", "bvh_intersect_p_fused")}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def kernel_name(symbol: str):
    """The OWN_KERNELS name in a (mangled) symbol, with its compile-time
    instance where it is a template of csrc/intersect.cu
    (``closest_hit_kernel<0>``), or None."""
    k = next((k for k in OWN_KERNELS if k in symbol), None)
    m = k and re.search(k + r"ILi(\d+)E", symbol)
    return f"{k}<{m.group(1)}>" if m else k


def ptxas_lines(log: str) -> list:
    """ptxas's registers and spills (-v) of each entry function, named."""
    out, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = kernel_name(m.group(1))
        elif "registers" in ln or "spill" in ln:
            out.append((f"{fn}: " if fn else "") + ln.strip())
    return out


def sass_local_ops(lib: str, nvcc: str) -> dict:
    """{kernel: (LDL, STL)}: the local-memory loads and stores in the SASS of
    each of the port's kernels in the library ``lib`` (cuobjdump -sass of
    the toolkit beside ``nvcc``): register spills and the walk's stack."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            if fn:
                counts[fn] = [0, 0]
        elif fn and re.search(r"\bLDL\b", line):
            counts[fn][0] += 1
        elif fn and re.search(r"\bSTL\b", line):
            counts[fn][1] += 1
    return {k: tuple(v) for k, v in counts.items()}


def agreement(got: torch.Tensor, ref: torch.Tensor):
    """(fraction of lanes within 1e-3 relative, relative mean difference,
    max abs error) — the per-lane bar of tests/test_megakernel.py."""
    diff = (got - ref).abs().amax(dim=-1)
    rel = diff / (1e-3 + ref.abs().amax(dim=-1))
    frac = float((rel < 1e-3).float().mean())
    ref_mean = float(ref.mean())
    mean_rel = abs(float(got.mean()) - ref_mean) / max(ref_mean, 1e-6)
    return frac, mean_rel, float(diff.max())


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """(least ms on the card, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def lane_slots(what: str, steps: torch.Tensor) -> None:
    """Prints the lane-slot efficiency of a launch of one thread per item on
    one band: the items' steps (a path's bounces, a walk's nodes) over the
    slots their warps hold, 32 lanes in launch order for as long as the
    warp's longest item."""
    s = steps.long().cpu()
    pad = (-s.numel()) % 32
    warps = torch.cat([s, s.new_zeros(pad)]).reshape(-1, 32)
    eff = float(s.sum()) / max(32.0 * float(warps.amax(dim=1).sum()), 1.0)
    phase("lane-slots", f"{what}: {s.numel()} items, {int(s.sum())} steps (mean "
          f"{float(s.float().mean()):.2f}, max {int(s.max())}); lane-slot efficiency "
          f"{eff:.4f} one thread per item")


def _intersector(accel):
    from gopbrt_tpu_torch.ops import brute_intersect as bi
    from gopbrt_tpu_torch.ops import bvh

    return bi if accel == "brute" else bvh


@contextlib.contextmanager
def swapped_intersection(closest, any_hit, accel="brute"):
    """Route the integrators' intersections through other callables for the
    duration (each gets the wrapped function as its first argument)."""
    mod = _intersector(accel)
    names = FUSED[accel]
    saved = tuple(getattr(mod, k) for k in names)
    setattr(mod, names[0], lambda *a: closest(saved[0], *a))
    setattr(mod, names[1], lambda *a: any_hit(saved[1], *a))
    try:
        yield
    finally:
        for k, fn in zip(names, saved):
            setattr(mod, k, fn)


def recording(calls: list, accel="brute"):
    """Launch the kernels as usual and record each launch's inputs."""
    prefix = "" if accel == "brute" else "bvh_"

    def record(kind):
        def call(fn, table, o, d, t_max):
            calls.append((kind, table, o, d, t_max))
            return fn(table, o, d, t_max)
        return call
    return swapped_intersection(record(prefix + "intersect"),
                                record(prefix + "intersect_any"), accel)


def plain_intersection():
    """The plain versions on the card's tensors, in place of the kernels."""
    from gopbrt_tpu_torch.ops import brute_intersect as bi

    return swapped_intersection(lambda _, *a: bi.intersect_brute(*a),
                                lambda _, *a: bi.intersect_p_brute(*a))


def close_t(t, ref):
    """t agrees with ref: 1e-3 relative + 1e-4 (benchmarks/tpu_smoke.py:79-83)."""
    return (t - ref).abs() < 1e-3 * ref.abs() + 1e-4


def prim_mismatches(table, o, d, t_max, t_k, idx_k, t_p, idx_p, both) -> dict:
    """The prim ids on lanes both hit with t clear (test_pallas.compare's
    1e-6 bar): the kernel's prim must be the plain version's, or a tie, a
    prim whose plain test meets the plain t (close_t) on that lane."""
    from gopbrt_tpu_torch.ops import brute_intersect as bi

    clear = both & ((t_k - t_p).abs() <= 1e-6 * t_p.clamp(min=1.0))
    lanes = torch.nonzero(clear & (idx_k != idx_p)).flatten()
    untied = 0
    for p in idx_k[lanes].unique().tolist():
        sel = lanes[idx_k[lanes] == p]
        ptype, m, pr = table.rows[p]
        tp = bi.prim_test(ptype, m, pr, o[sel, 0], o[sel, 1], o[sel, 2], d[sel, 0],
                          d[sel, 1], d[sel, 2], t_max[sel], full_sph=table.full_sph,
                          full_disk=table.full_disk)
        untied += int((~close_t(tp, t_p[sel])).sum())
    return {"clear": int(clear.sum()), "other_prim": int(lanes.numel()), "untied": untied}


def edge_tie(rec, o, d, t_ref) -> torch.Tensor:
    """Lanes whose triangle record is hit at t_ref once its edges widen by
    1e-5 in barycentrics: a ray through an edge two triangles share, which
    float rounding gives to either."""
    from gopbrt_tpu_torch.ops import bvh

    pr = rec[:, bvh.REC_PARAMS:bvh.REC_PARAMS + 9]
    v0, e1, e2 = pr[:, 0:3], pr[:, 3:6] - pr[:, 0:3], pr[:, 6:9] - pr[:, 0:3]
    pv = torch.linalg.cross(d, e2, dim=-1)
    det = (e1 * pv).sum(-1)
    inv = 1.0 / torch.where(det.abs() < 1e-12, 1.0, det)
    tv = o - v0
    u = (tv * pv).sum(-1) * inv
    qv = torch.linalg.cross(tv, e1, dim=-1)
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    tri = rec[:, bvh.REC_TYPE] == 2
    return tri & (u >= -1e-5) & (v >= -1e-5) & (u + v <= 1.0 + 1e-5) & close_t(t, t_ref)


def bvh_prim_mismatches(table, o, d, t_max, t_k, idx_k, t_p, idx_p, both) -> dict:
    """prim_mismatches for the BVH walk: the kernel's prim tested on its
    record row; a prim hit through a shared edge (``edge_tie``) is a tie."""
    from gopbrt_tpu_torch.ops import bvh

    clear = both & ((t_k - t_p).abs() <= 1e-6 * t_p.clamp(min=1.0))
    lanes = torch.nonzero(clear & (idx_k != idx_p)).flatten()
    edge, untied = 0, 0
    if lanes.numel():
        slot_of = torch.empty_like(table.bvh.prim_order)
        slot_of[table.bvh.prim_order.long()] = torch.arange(
            slot_of.numel(), dtype=slot_of.dtype, device=slot_of.device)
        rec = table.records[slot_of[idx_k[lanes].long()].long()]
        tp = bvh.prim_test_records(rec, o[lanes], d[lanes], t_max[lanes], table.full_sph,
                                   table.full_disk)
        tied = close_t(tp, t_p[lanes])
        on_edge = ~tied & edge_tie(rec, o[lanes], d[lanes], t_p[lanes])
        edge = int(on_edge.sum())
        bad = ~tied & ~on_edge
        untied = int(bad.sum())
        if untied:
            i = int(torch.nonzero(bad).flatten()[0])
            lane = int(lanes[i])
            phase("kernel-vs-plain", f"untied lane {lane}: kernel prim {int(idx_k[lane])} t "
                  f"{float(t_k[lane])!r}, plain prim {int(idx_p[lane])} t {float(t_p[lane])!r}, "
                  f"plain test of the kernel's prim {float(tp[i])!r}")
    return {"clear": int(clear.sum()), "other_prim": int(lanes.numel()), "edge_ties": edge,
            "untied": untied}


def dead_lanes(table, d, t_max) -> torch.Tensor:
    """The lanes csrc/intersect.cu answers without a test: t_max <= 1e-4,
    and |d|^2 within the table's dead_d2 (inf without spheres)."""
    from gopbrt_tpu_torch.ops import brute_intersect as bi

    return (t_max <= bi.DEAD_T_MAX) & ((d * d).sum(dim=-1) <= table.dead_d2)


def check_intersect_call(kind, table, o, d, t_max):
    """Kernel vs plain on one launch's inputs -> (agreeing fraction, max abs
    t error over lanes both hit or the any-hit's max abs error, prim-id
    mismatches of the closest hit or None, (dead lanes, dead lanes whose
    answer is not the plain version's bit for bit) of the brute kernels or
    None).  kind: "intersect" / "intersect_any" (the brute kernels) or
    "bvh_intersect" / "bvh_intersect_any" (the BVH walk)."""
    from gopbrt_tpu_torch.ops import brute_intersect as bi
    from gopbrt_tpu_torch.ops import bvh

    if kind == "bvh_intersect":
        hit_k, t_k, idx_k = bvh.bvh_intersect_fused(table, o, d, t_max)
        hit_p, t_p, idx_p = bvh.bvh_intersect(table, o, d, t_max)
        same = (hit_k == hit_p) & close_t(t_k, t_p)
        both = hit_k & hit_p
        err = float((t_k - t_p)[both].abs().max()) if bool(both.any()) else 0.0
        ids = bvh_prim_mismatches(table, o, d, t_max, t_k, idx_k, t_p, idx_p, both)
        return float(same.float().mean()), err, ids, None
    if kind == "bvh_intersect_any":
        occ_k = bvh.bvh_intersect_p_fused(table, o, d, t_max)
        occ_p = bvh.bvh_intersect_p(table, o, d, t_max)
        return (float((occ_k == occ_p).float().mean()), float((occ_k != occ_p).any()), None,
                None)
    dead = dead_lanes(table, d, t_max)
    if kind == "intersect":
        hit_k, t_k, idx_k = bi.intersect_brute_fused(table, o, d, t_max)
        hit_p, t_p, idx_p = bi.intersect_brute(table, o, d, t_max)
        same = (hit_k == hit_p) & close_t(t_k, t_p)
        both = hit_k & hit_p
        err = float((t_k - t_p)[both].abs().max()) if bool(both.any()) else 0.0
        ids = prim_mismatches(table, o, d, t_max, t_k, idx_k, t_p, idx_p, both)
        off = (hit_k != hit_p) | (t_k != t_p) | (idx_k != idx_p)
        return float(same.float().mean()), err, ids, (int(dead.sum()), int((off & dead).sum()))
    occ_k = bi.intersect_p_brute_fused(table, o, d, t_max)
    occ_p = bi.intersect_p_brute(table, o, d, t_max)
    off = occ_k != occ_p
    return (float((~off).float().mean()), float(off.any()), None,
            (int(dead.sum()), int((off & dead).sum())))


def check_agreement(what: str, agree: float, ids, dead=None) -> None:
    """The kernels' bars: > 0.999 of lanes agree, no closest-hit lane clear
    of ties names another prim, and every dead lane (the brute kernels'
    lanes answered without a test) has the plain answer bit for bit."""
    if agree <= 0.999:
        raise AssertionError(f"{what}: kernel disagrees with its plain version ({agree})")
    if ids is not None and ids["untied"]:
        raise AssertionError(f"{what}: the kernel names other prims {ids}")
    if dead is not None and dead[1]:
        raise AssertionError(f"{what}: {dead[1]} of {dead[0]} dead lanes disagree")


def intersect_flops(kind, table, o, d, t_max, steps=None, active=None):
    """(fp32 operations the kernel's threads need on these rays, the events
    counted): every primitive test of the closest-hit sweep, or the
    any-hit's tests up to each ray's first occluder, of the lanes of
    ``active`` (all where None); for the BVH walk, the events of
    csrc/bvh.cuh as the plain walk counts them (root tests, interior nodes,
    pops, leaf tests), each lane's steps added to ``steps``; at
    ``megakernel.OPS_PER_EVENT`` each."""
    from gopbrt_tpu_torch.ops import brute_intersect as bi
    from gopbrt_tpu_torch.ops import bvh, megakernel

    tally = {}
    if kind.startswith("bvh_"):
        bvh.walk(table, o, d, t_max, any_hit=kind == "bvh_intersect_any", tally=tally,
                 steps=steps)
        return megakernel.fp32_ops(tally), tally
    args = (table, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_max)
    if active is None:
        active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    sweep = bi.closest_hit if kind == "intersect" else bi.first_hit
    sweep(*args, tally=tally, active=active)
    return megakernel.fp32_ops(tally), tally


def brute_bounds(kind, table, o, d, t_max):
    """The bound of one brute launch by two methods, each (ms, "operations"
    or "bytes", fp32 ops): every lane tests every prim and moves a whole
    ray (the first port's count); and what the function needs, the tests
    of the lanes that are not dead (``dead_lanes``: their answer needs no
    test), a live lane moving o, d, t_max and its answer, a dead lane
    t_max, d where the table holds spheres, and its answer."""
    n = o.shape[0]
    per_ray, out = ((BYTES_PER_RAY_CLOSEST, 9) if kind == "intersect"
                    else (BYTES_PER_RAY_ANY, 1))
    table_bytes = table.count * BYTES_PER_PRIM
    flops, _ = intersect_flops(kind, table, o, d, t_max)
    old = bound(flops, n * per_ray + table_bytes) + (flops,)
    dead = dead_lanes(table, d, t_max)
    n_dead = int(dead.sum())
    live_flops, _ = intersect_flops(kind, table, o, d, t_max, active=~dead)
    dead_bytes = 4 + out + (12 if math.isfinite(float(table.dead_d2)) else 0)
    new = bound(live_flops, (n - n_dead) * per_ray + n_dead * dead_bytes
                + table_bytes) + (live_flops,)
    return old, new


def lobe_scene(device):
    """Checker floor, matte / mirror / smooth-glass / rough-glass spheres
    and a sphere lamp, on the port's own builder."""
    from gopbrt_tpu_torch.models import camera as cam_mod
    from gopbrt_tpu_torch.models.scene import SceneBuilder
    from gopbrt_tpu_torch.ops import geom

    b = SceneBuilder()
    checker = b.checkerboard_texture((0.8, 0.8, 0.8), (0.2, 0.2, 0.2),
                                     vs=(0.7, 0.0, 0.0), vt=(0.0, 0.0, 0.7))
    b.disk(geom.rotate_x(-90.0), 60.0, b.matte(kd=(1.0, 1.0, 1.0), kd_tex=checker))
    b.sphere(geom.translate([-2.6, 0.8, -0.5]), 0.8, b.matte(kd=(0.7, 0.3, 0.2)))
    b.sphere(geom.translate([-0.9, 0.9, 0.0]), 0.9, b.mirror(kr=(0.9, 0.9, 0.9)))
    b.sphere(geom.translate([0.9, 0.9, 0.0]), 0.9, b.glass(eta=1.5))
    b.sphere(geom.translate([2.6, 0.8, -0.5]), 0.8, b.glass(eta=1.5, roughness=0.15))
    lamp = b.sphere(geom.translate([-2.5, 4.0, 2.0]), 0.5, b.matte(kd=(0.0, 0.0, 0.0)))
    b.area_light(lamp, radiance=(30.0, 28.0, 24.0))
    scene = b.build(device=device)
    camera = cam_mod.perspective_camera(
        geom.look_at([0.0, 2.4, 6.5], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]),
        256, 256, fov_deg=45.0, device=device)
    return scene, camera


def feature_scene(device):
    """Outside the fast path: plastic, metal and Oren-Nayar spheres, a
    triangle, a uv-checker floor, a disk lamp and a point light under the
    power light distribution (tests/test_torch_wavefront.py's scene)."""
    from gopbrt_tpu_torch.models import camera as cam_mod
    from gopbrt_tpu_torch.models.scene import SceneBuilder
    from gopbrt_tpu_torch.ops import geom

    b = SceneBuilder(light_strategy="power")
    uvc = b.checkerboard_texture((0.9, 0.8, 0.2), (0.1, 0.2, 0.6), vs=(8.0, 0.0, 0.0),
                                 vt=(0.0, 8.0, 0.0), mapping="uv")
    b.disk(geom.rotate_x(-90.0), 30.0, b.matte(kd=(1.0, 1.0, 1.0), kd_tex=uvc))
    b.sphere(geom.translate([-1.6, 0.8, 0.0]), 0.8,
             b.plastic(kd=(0.2, 0.5, 0.8), ks=(0.3, 0.3, 0.3), roughness=0.1))
    b.sphere(geom.translate([0.2, 0.8, -0.5]), 0.8, b.metal(f0=(0.95, 0.7, 0.3), roughness=0.2))
    b.sphere(geom.translate([1.9, 0.7, 0.3]), 0.7, b.matte(kd=(0.7, 0.7, 0.6), sigma=25.0))
    b.triangle((-3.0, 0.0, -2.5), (3.0, 0.0, -2.5), (0.0, 3.5, -2.5),
               b.matte(kd=(0.6, 0.3, 0.3)))
    lamp = b.disk(geom.matmul(geom.translate([0.0, 4.0, 1.0]), geom.rotate_x(90.0)), 1.0,
                  b.matte(kd=0.0))
    b.area_light(lamp, radiance=(12.0, 11.0, 10.0))
    b.point_light(p=(3.0, 5.0, 3.0), intensity=(8.0, 8.0, 8.0))
    camera = cam_mod.perspective_camera(
        geom.look_at([0.0, 2.0, 6.0], [0.0, 0.8, 0.0], [0.0, 1.0, 0.0]), W, H,
        fov_deg=50.0, device=device)
    return b.build(device=device), camera


def big_table(device, n_prims=300, n_rays=1 << 16, seed=7):
    """A random table of every shape kind (full and clipped spheres, annulus
    and wedge disks, triangles) larger than one shared-memory chunk of
    csrc/intersect.cu, and rays aimed into it -> (packed table, o, d, t_max)."""
    from gopbrt_tpu_torch.ops.brute_intersect import brute_table
    from gopbrt_tpu_torch.ops.intersect import DISK, SPHERE, TRIANGLE, Primitives
    from gopbrt_tpu_torch.ops.static_info import PrimInfo

    r = np.random.default_rng(seed)
    kinds = r.integers(0, 3, n_prims)
    o2w = np.tile(np.eye(4, dtype=np.float32), (n_prims, 1, 1))
    params = np.zeros((n_prims, 9), np.float32)
    for i, k in enumerate(kinds):
        c = r.uniform(-20.0, 20.0, 3)
        if k == TRIANGLE:
            params[i] = (c + r.normal(size=(3, 3)) * 2.0).reshape(-1)
            continue
        o2w[i, :3, :3] *= r.uniform(0.5, 1.5)
        o2w[i, :3, 3] = c
        rad = r.uniform(0.5, 2.0)
        phi = 2.0 * math.pi if r.random() < 0.5 else r.uniform(0.5, 6.0)
        if k == SPHERE:
            params[i, :4] = (rad, -rad * r.uniform(0.3, 1.0), rad * r.uniform(0.3, 1.0), phi)
        else:
            params[i, :4] = (r.uniform(-1.0, 1.0), rad, rad * r.uniform(0.0, 0.5), phi)
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    prims = Primitives(
        prim_type=t(kinds.astype(np.int32)), obj_to_world=t(o2w),
        world_to_obj=t(np.linalg.inv(o2w.astype(np.float64)).astype(np.float32)),
        params=t(params), material_id=t(np.zeros(n_prims, np.int32)),
        area_light_id=t(np.full(n_prims, -1, np.int32)),
        reverse_orientation=t(np.zeros(n_prims, bool)),
        pinfo=PrimInfo(types=(SPHERE, DISK, TRIANGLE)),
    )
    o = r.normal(size=(n_rays, 3)) * 40.0
    d = r.uniform(-20.0, 20.0, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(r.random(n_rays) < 0.5, 1e30, r.uniform(1e-4, 60.0, n_rays))
    return (brute_table(prims), t(o.astype(np.float32)), t(d.astype(np.float32)),
            t(t_max.astype(np.float32)))


def timed_passes(render, film_mod, scene, camera, settings, dev):
    """One warm-up pass, then N_PASSES timed ones with the launch counts set
    to 0 just before -> (ms per pass, launch counts, film)."""
    from gopbrt_tpu_torch import _build

    film = film_mod.new_film(settings.width, settings.height, device=dev)
    render.render_pass(scene, camera, film, settings, 0, device=dev)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    for i in range(N_PASSES):
        film = render.render_pass(scene, camera, film, settings, i + 1, device=dev)
    torch.cuda.synchronize()
    dt_ms = (time.perf_counter() - t0) / N_PASSES * 1e3
    return dt_ms, dict(_build.LAUNCHES), film


def profiled_pass(render, scene, camera, film, settings, dev, pass_ms: float):
    """One more pass under the profiler, read by render_pass's stage ranges
    (host time) and the device's busy time -> (the line to print, device
    ms of the pass in each of the port's kernels, by OWN_KERNELS name, and
    the device ms of each of their launches in start order)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        render.render_pass(scene, camera, film, settings, N_PASSES + 1, device=dev)
        torch.cuda.synchronize()
    # a range shows twice, as a host event and as an annotation on the
    # device's timeline; the device is busy for its kernels and copies
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host = {k: sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.name == f"render.{k}" and e.device_type == cpu) / 1e3
            for k in ("band_rays", "li", "splat")}
    work = [e for e in prof.events()
            if e.device_type == cuda and not e.name.startswith("render.")]
    device_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    seq = {k: [e.time_range.elapsed_us() / 1e3
               for e in sorted(work, key=lambda e: e.time_range.start) if k in e.name]
           for k in OWN_KERNELS}
    own = {k: sum(v) for k, v in seq.items() if v}
    busy = (f"device busy {device_ms:.3f} ms in {len(work)} kernels and copies, "
            f"{sum(own.values()):.3f} ms of it in the port's CUDA kernels "
            f"({', '.join(f'{k} {v:.4f}' for k, v in own.items())} ms per pass); idle "
            f"{1.0 - device_ms / pass_ms:.4f} of a timed pass"
            if device_ms > 0 else "device time not measured")
    return ("one profiled pass, host ms by range: "
            + ", ".join(f"{k} {v:.2f}" for k, v in host.items()) + f"; {busy}"), own, seq


def shadow_rays(scene, o, d, t, hit):
    """Shadow rays from the hits of (o, d) toward the scene's first light (a
    point light), stopping short of it; lanes that missed get t_max 1e-4."""
    light = scene.lights.p[0]
    p = o + d * (t - 1e-3)[:, None]
    to = light[None, :] - p
    dist = to.norm(dim=-1)
    t_max = torch.where(hit, dist * (1.0 - 1e-4), 1e-4)
    return p.contiguous(), (to / dist[:, None]).contiguous(), t_max.contiguous()


def mesh_checks(dev, band_rows: int) -> dict:
    """Phase 3 on the mesh scene: the BVH walk kernels against the brute
    kernels and against the plain walk, the mesh megakernel against its plain
    version and the general chain; then their times and bounds.  Returns
    what the later phases print."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import integrators, meshes, render
    from gopbrt_tpu_torch.ops import brute_intersect as bi
    from gopbrt_tpu_torch.ops import bvh, megakernel, mesh_megakernel

    scene = meshes.build_mesh_scene(device=dev)
    bt = scene.bvh_tables
    phase("mesh", f"the mesh scene: {scene.prims.count} prims, BVH of "
          f"{bt.bvh.node_lo.shape[0]} nodes ({bt.nodes.shape[0] - 1} packed interior nodes) "
          f"built by the {bt.backend} builder in {bt.build_ms:.1f} ms")
    if bt.backend != "native" or scene.mesh is None:
        raise AssertionError(f"the mesh scene's tree was built by {bt.backend}, "
                             f"mesh tables {scene.mesh is not None}")
    metal = meshes.build_mesh_scene(device=dev, mesh_material="metal")
    if metal.fastinfo.mesh_ok or metal.mesh is not None:
        raise AssertionError("the metal mesh should lie outside the mesh fast path")
    cam = meshes.mesh_camera(W, H, device=dev)
    settings = render.RenderSettings(width=W, height=H, spp=1, max_depth=MESH_DEPTH,
                                     integrator="path", samples_per_pass=1)
    cfg = render.path_config(settings)
    cone = render._cone(cam, settings)
    _, o, d, pix, smp = render.band_rays(cam, settings, band_rows, band_rows, 0)
    n = o.shape[0]

    # kernel #4 against the brute-force kernels on the whole mesh (an
    # independent oracle): the band's camera rays, then shadow rays
    big = torch.full((n,), 1e30, device=dev)
    hb, tb, pb = bi.intersect_brute_fused(scene.brute, o, d, big)
    hk, tk, pk = bvh.bvh_intersect_fused(scene.bvh_tables, o, d, big)
    c_agree = float(((hk == hb) & close_t(tk, tb)).float().mean())
    both = hk & hb
    prim_eq = float((pk == pb)[both].float().mean()) if bool(both.any()) else 1.0
    so, sd, st = shadow_rays(scene, o, d, tb, hb)
    ob = bi.intersect_p_brute_fused(scene.brute, so, sd, st)
    ok_ = bvh.bvh_intersect_p_fused(scene.bvh_tables, so, sd, st)
    a_agree = float((ob == ok_).float().mean())
    phase("kernel-vs-oracle", f"BVH walk vs the brute kernels over all {scene.prims.count} "
          f"prims, mesh band {W}x{band_rows}: closest {c_agree:.6f} agree (hit and t), "
          f"prim ids equal on {prim_eq:.6f} of the lanes both hit; any hit on "
          f"{int((st > 1e-3).sum())} shadow rays toward the point light: {a_agree:.6f} "
          f"agree, {float(ob.float().mean()):.4f} occluded")
    if not (c_agree > 0.999 and a_agree > 0.999):
        raise AssertionError("the BVH walk disagrees with the brute-force kernels")

    # kernel #4 against its plain walk on every launch of the general chain
    # over a band of the metal mesh
    calls = []
    _build.LAUNCHES.clear()
    with recording(calls, "bvh"):
        integrators._li_wavefront(metal, o, d, pix, smp, settings.seed, cfg, cone=cone)
    if any(k in _build.LAUNCHES for k in ("intersect", "intersect_any", "megakernel")):
        raise AssertionError(f"the BVH chain launched {dict(_build.LAUNCHES)}")
    # kernel #4's times, as tools/ab/kernel_ab.py launches takes them: every
    # launch of the chain over this band on its recorded inputs, right after
    # the chain (cuda_ms: the median of 21 launches after a warm-up)
    fused = {"bvh_intersect": bvh.bvh_intersect_fused,
             "bvh_intersect_any": bvh.bvh_intersect_p_fused}
    walk_ms = [cuda_ms(lambda c=c: fused[c[0]](*c[1:]), reps=21) for c in calls]
    phase("kernel-time", "BVH walk, each launch of the metal-mesh band's chain in order, ms: "
          + ", ".join(f"{k} {t:.4f}" for k, t in zip((c[0] for c in calls), walk_ms)))
    worst = {"bvh_intersect": (1.0, 0.0), "bvh_intersect_any": (1.0, 0.0)}
    for i, call in enumerate(calls):
        agree, err, ids, _ = check_intersect_call(*call)
        live = float((call[4] > 2e-4).float().mean())
        phase("kernel-vs-plain", f"{call[0]} launch {i} of a metal-mesh band ({n} rays, "
              f"{live:.4f} live): {agree:.6f} agree, max abs err {err:.3e}"
              + ("" if ids is None else f", prim ids {ids}"))
        check_agreement(f"{call[0]} launch {i}", agree, ids)
        worst[call[0]] = (min(worst[call[0]][0], agree), max(worst[call[0]][1], err))
    kinds = [c[0] for c in calls]
    if kinds.count("bvh_intersect") != MESH_DEPTH or kinds.count("bvh_intersect_any") != MESH_DEPTH:
        raise AssertionError(f"_li_wavefront made the launches {kinds}")

    # kernel #5 against its plain version and against the general chain
    out = torch.empty_like(o)
    launch = mesh_megakernel.make_launch(scene, o, d, pix, smp, settings.seed, cfg, cone, out)
    mesh_out = launch().clone()
    torch.cuda.synchronize()
    counts, bounces = {}, torch.zeros((n,), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    ref = megakernel.path_li_plain(scene, o, d, pix, smp, settings.seed, cfg, cone=cone,
                                   counts=counts, accel="bvh", bounces=bounces)
    torch.cuda.synchronize()
    mesh_plain_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(mesh_out).all()):
        raise AssertionError("mesh band: non-finite kernel output")
    frac, mean_rel, mesh_err = agreement(mesh_out, ref)
    phase("kernel-vs-plain", f"mesh megakernel, mesh band {W}x{band_rows} ({n} lanes), depth "
          f"{MESH_DEPTH}, cone on: {frac:.5f} of lanes within 1e-3, mean diff {mean_rel:.2e}, "
          f"max abs err {mesh_err:.3e}, mean L {float(ref.mean()):.6f}")
    if not (frac >= 0.9999 and mean_rel < 2e-3):
        raise AssertionError("mesh band: the mesh megakernel disagrees with its plain version")
    # a light edit by _replace: the light rows packed from the new scene
    rmesh = scene._replace(lights=scene.lights._replace(intensity=scene.lights.intensity * 2.0))
    _build.LAUNCHES.clear()
    r_out = mesh_megakernel.mesh_li_fused(rmesh, o, d, pix, smp, settings.seed, cfg, cone=cone)
    r_launches = dict(_build.LAUNCHES)
    r_ref = megakernel.path_li_plain(rmesh, o, d, pix, smp, settings.seed, cfg, cone=cone,
                                     accel="bvh")
    rfrac, rmean, rmax = agreement(r_out, r_ref)
    phase("replace", f"mesh megakernel on the mesh band of base._replace(light intensity "
          f"x 2), launches {r_launches}: {rfrac:.5f} of lanes within 1e-3 of its plain twin, "
          f"mean diff {rmean:.2e}, max abs err {rmax:.3e}; mean L {float(r_out.mean()):.6f} "
          f"against the base's {float(mesh_out.mean()):.6f}")
    if not (rfrac >= 0.9999 and rmean < 2e-3 and r_launches == {"mesh_megakernel": 1}
            and not torch.equal(r_out, mesh_out)):
        raise AssertionError("the mesh megakernel on a replaced scene: not its own lights")
    wave = integrators._li_wavefront(scene, o, d, pix, smp, settings.seed, cfg, cone=cone)
    wfrac, wmean, wmax = agreement(wave, mesh_out)
    phase("chain-vs-chain", f"_li_wavefront on the BVH kernels vs the mesh megakernel, mesh "
          f"band, depth {MESH_DEPTH}: {wfrac:.5f} of lanes within 1e-3, mean diff {wmean:.2e}, "
          f"max abs err {wmax:.3e}")
    if not (wfrac > 0.98 and wmean < 1e-2):
        raise AssertionError("the general chain disagrees with the mesh megakernel")

    # times per launch at the main paths' shapes and the bounds of this
    # band's work
    bt = scene.bvh_tables
    table_bytes = bt.nodes.numel() * 4 + bt.records.numel() * 4
    mesh_ms = cuda_ms(launch, reps=9)
    phase("kernel-time", "mesh megakernel events of the mesh band as [count, fp32 ops]: "
          + json.dumps({k: [v, v * megakernel.OPS_PER_EVENT[k]]
                        for k, v in counts.items()}))
    flops = megakernel.fp32_ops(counts)
    mesh_bound = bound(flops, n * BYTES_PER_PATH + mesh_megakernel.MESH_TABLE_WORDS * 4
                       + table_bytes)
    phase("kernel-time", f"mesh megakernel {mesh_ms:.4f} ms, plain {mesh_plain_ms:.2f} ms per "
          f"band; bound {mesh_bound[0]:.5f} ms by {mesh_bound[1]} ({flops / 1e9:.3f} GFLOP); "
          f"{mesh_bound[0] / mesh_ms:.4f} of the bound")
    lane_slots("mesh band, bounces per path", bounces)
    timing = {"mesh_megakernel": (mesh_ms, mesh_plain_ms) + mesh_bound}
    for kind, plain, per_ray in (
            ("bvh_intersect", bvh.bvh_intersect, BYTES_PER_RAY_CLOSEST),
            ("bvh_intersect_any", bvh.bvh_intersect_p, BYTES_PER_RAY_ANY)):
        # the first launch of each (the camera rays, the first shadow rays)
        # and the last (the last bounce's rays, most of them dead)
        mine = [i for i, c in enumerate(calls) if c[0] == kind]
        for which, i in (("first", mine[0]), ("last", mine[-1])):
            args, k_ms = calls[i][1:], walk_ms[i]
            p_ms = cuda_ms(lambda: plain(*args), reps=1)
            steps = torch.zeros((n,), dtype=torch.int64, device=dev)
            k_flops, tally = intersect_flops(kind, *args, steps=steps)
            b_ms, b_by = bound(k_flops, n * per_ray + table_bytes)
            timing[kind if which == "first" else kind + "_last"] = (k_ms, p_ms, b_ms, b_by)
            phase("kernel-time", f"{kind}, {which} launch: {k_ms:.4f} ms, plain {p_ms:.2f} ms "
                  f"per launch of {n} rays; events {json.dumps(tally)}; "
                  f"bound {b_ms:.5f} ms by {b_by} ({k_flops / 1e9:.4f} GFLOP); "
                  f"{b_ms / k_ms:.4f} of the bound")
            if which == "first":
                lane_slots("metal-mesh camera band, nodes per ray" if kind == "bvh_intersect"
                           else "metal-mesh first shadow band, nodes per ray", steps)
    return dict(scene=scene, metal=metal, cam=cam, settings=settings, timing=timing,
                worst=worst, mesh_err=mesh_err)


def mesh_main_paths(render, film_mod, m: dict, dev, device_name: str, power_limit: str):
    """Phase 4 on the mesh: the mesh scene's pass (the mesh megakernel) and
    the metal mesh's (the general chain on the BVH walk) -> the launch
    counts of each."""
    scene, metal, cam, settings = m["scene"], m["metal"], m["cam"], m["settings"]
    dt, launches, film = timed_passes(render, film_mod, scene, cam, settings, dev)
    if launches != {"mesh_megakernel": 4 * N_PASSES}:
        raise AssertionError(f"mesh main path launched {launches} in {N_PASSES} passes, "
                             f"expected {4 * N_PASSES} mesh megakernel launches")
    img = film_mod.develop(film)
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01):
        raise AssertionError(f"mesh scene: bad image (mean {float(img.mean())})")
    phase("main-path", f"mesh: {N_PASSES} passes of {W}x{H} 1 spp path depth {MESH_DEPTH}: "
          f"{dt:.2f} ms per pass, launches {launches}, image mean {float(img.mean()):.4f}")
    print(json.dumps({
        "metric": f"bvh_mesh10k_rays_per_s_{W}x{H}_depth{MESH_DEPTH}",
        "value": W * H / (dt / 1e3), "unit": "rays/s", "n_prims": scene.prims.count,
        "ms_per_pass": dt, "device": device_name, "power_limit": power_limit,
    }), flush=True)
    k_ms = m["timing"]["mesh_megakernel"][0]
    line, own_m, _ = profiled_pass(render, scene, cam, film, settings, dev, dt)
    phase("main-path", "mesh: " + line
          + f"; the kernel is ~{4 * k_ms:.2f} ms (4 launches at the second band's time)")

    dtc, launches_c, film_c = timed_passes(render, film_mod, metal, cam, settings, dev)
    if not (launches_c.get("bvh_intersect", 0) > 0 and launches_c.get("bvh_intersect_any", 0) > 0
            and set(launches_c) == {"bvh_intersect", "bvh_intersect_any"}):
        raise AssertionError(f"the BVH chain main path launched {launches_c}")
    img_c = film_mod.develop(film_c)
    if not (bool(torch.isfinite(img_c).all()) and float(img_c.mean()) > 0.01):
        raise AssertionError(f"metal mesh: bad image (mean {float(img_c.mean())})")
    per_pass = {k: v // N_PASSES for k, v in launches_c.items()}
    phase("main-path", f"metal mesh, the general chain on the BVH: {N_PASSES} passes of "
          f"{W}x{H} 1 spp path depth {MESH_DEPTH}: {dtc:.2f} ms per pass, launches per pass "
          f"{per_pass}, image mean {float(img_c.mean()):.4f}")
    line, own_c, _ = profiled_pass(render, metal, cam, film_c, settings, dev, dtc)
    phase("main-path", "metal mesh: " + line)
    return launches, launches_c, {**own_m, **own_c}


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gopbrt_tpu_torch import _build, native
    from gopbrt_tpu_torch.models import film as film_mod
    from gopbrt_tpu_torch.models import gallery, integrators, render
    from gopbrt_tpu_torch.models.demo import (build_demo_camera, build_demo_scene,
                                              demo_settings)
    from gopbrt_tpu_torch.ops import brute_intersect as bi
    from gopbrt_tpu_torch.ops import megakernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device_name = torch.cuda.get_device_name(0)
    power_limit = smi.split(",")[-1].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{device_name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda")

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build()
    for name in info:
        _build.load(name)
    build_s = time.perf_counter() - t0
    for name, rec in info.items():
        phase("build", f"{name}: nvcc {rec['seconds']:.1f} s; "
              + " | ".join(ptxas_lines(rec["log"])))
        local = sass_local_ops(rec["path"], _build._nvcc())
        phase("sass", f"{name}: " + ", ".join(f"{k} {v[0]} LDL / {v[1]} STL"
                                                for k, v in local.items()))
    t0 = time.perf_counter()
    if native.load() is None:
        raise AssertionError("the host BVH builder did not build (g++)")
    phase("build", f"total {build_s:.1f} s; the host BVH builder (g++) "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. kernel vs plain ---------------------------------------------
    scene = build_demo_scene(device=dev)
    camera = build_demo_camera(W, H, device=dev)
    settings = demo_settings(W, H, spp=1, samples_per_pass=1)
    band_rows = settings.chunk_pixels // W  # 273 rows: the main path's band
    cfg = render.path_config(settings)
    cone = render._cone(camera, settings)
    _, o, d, pixel, sample = render.band_rays(camera, settings, band_rows, band_rows, 0)
    n_band = o.shape[0]
    out = torch.empty_like(o)
    launch = megakernel.make_launch(scene, o, d, pixel, sample, settings.seed, cfg,
                                    cone, out)
    mega = launch().clone()
    torch.cuda.synchronize()
    counts, bounces = {}, torch.zeros((n_band,), dtype=torch.int64, device=dev)
    ref = megakernel.path_li_plain(scene, o, d, pixel, sample, settings.seed, cfg,
                                   cone=cone, counts=counts, bounces=bounces)
    if not bool(torch.isfinite(mega).all()):
        raise AssertionError("demo band: non-finite kernel output")
    frac, mean_rel, max_abs = agreement(mega, ref)
    phase("kernel-vs-plain", f"megakernel, demo band {W}x{band_rows} ({n_band} lanes), "
          f"depth {DEPTH}, cone on: {frac:.5f} of lanes within 1e-3, mean diff "
          f"{mean_rel:.2e}, max abs err {max_abs:.3e}, mean L {float(ref.mean()):.6f}")
    if not (frac > 0.99 and mean_rel < 2e-3):
        raise AssertionError("demo band: kernel disagrees with its plain version")

    ls, lcam = lobe_scene(dev)
    lset = render.RenderSettings(width=256, height=256, spp=1, max_depth=8, seed=11)
    _, lo, ld, lpix, lsmp = render.band_rays(lcam, lset, 0, 256, 0)
    lcfg = render.path_config(lset)
    lcone = render._cone(lcam, lset)
    lgot = megakernel.path_li_fused(ls, lo, ld, lpix, lsmp, lset.seed, lcfg, cone=lcone)
    lref = megakernel.path_li_plain(ls, lo, ld, lpix, lsmp, lset.seed, lcfg, cone=lcone)
    if not bool(torch.isfinite(lgot).all()):
        raise AssertionError("lobe scene: non-finite kernel output")
    lfrac, lmean, lmax = agreement(lgot, lref)
    phase("kernel-vs-plain", f"megakernel, lobe scene 256x256, depth 8: {lfrac:.5f} of "
          f"lanes within 1e-3, mean diff {lmean:.2e}, max abs err {lmax:.3e}, "
          f"mean L {float(lref.mean()):.6f}")
    if not (lfrac > 0.98 and lmean < 1e-2):
        raise AssertionError("lobe scene: kernel disagrees with its plain version")

    # the intersection kernels on every launch of li_direct over one band of
    # config 1 at 1080p (the inputs the main path gives them)
    scene1, camera1, set1 = gallery.config1(W, H, device=dev)
    set1 = set1._replace(spp=1, samples_per_pass=1)
    _, o1, d1, pix1, smp1 = render.band_rays(camera1, set1, band_rows, band_rows, 0)
    cone1 = render._cone(camera1, set1)
    calls = []
    with recording(calls):
        direct_k = integrators.li_direct(scene1, o1, d1, pix1, smp1, set1.seed,
                                         max_depth=set1.max_depth, cone=cone1,
                                         light_strategy=set1.light_strategy)
    kinds = [c[0] for c in calls]
    if kinds.count("intersect") != 4 or kinds.count("intersect_any") != 3:
        raise AssertionError(f"li_direct made the launches {kinds}")
    worst = {"intersect": (1.0, 0.0), "intersect_any": (1.0, 0.0)}
    for i, call in enumerate(calls):
        agree, err, ids, dead = check_intersect_call(*call)
        live = float((call[4] > 2e-4).float().mean())
        phase("kernel-vs-plain", f"{call[0]} launch {i} of a config-1 band ({n_band} rays, "
              f"{live:.4f} live; instance {INSTANCES[call[1].instance]}; {dead[0]} dead "
              f"lanes, {dead[1]} of them off the plain answer): {agree:.6f} agree, max abs "
              f"err {err:.3e}" + ("" if ids is None else f", prim ids {ids}"))
        check_agreement(f"{call[0]} launch {i}", agree, ids, dead)
        worst[call[0]] = (min(worst[call[0]][0], agree), max(worst[call[0]][1], err))
    big = big_table(dev)
    for kind in ("intersect", "intersect_any"):
        agree, err, ids, dead = check_intersect_call(kind, *big)
        phase("kernel-vs-plain", f"{kind}, {big[0].count}-prim table of every shape kind, "
              f"{big[1].shape[0]} rays (instance {INSTANCES[big[0].instance]}; {dead[0]} "
              f"dead lanes, {dead[1]} off): {agree:.6f} agree, max abs err {err:.3e}"
              + ("" if ids is None else f", prim ids {ids}"))
        check_agreement(f"{kind} on the big table", agree, ids, dead)

    # two chains of the port: li_direct on the kernels vs on the plain
    # intersection; the general wavefront chain vs the megakernel
    with plain_intersection():
        direct_p = integrators.li_direct(scene1, o1, d1, pix1, smp1, set1.seed,
                                         max_depth=set1.max_depth, cone=cone1,
                                         light_strategy=set1.light_strategy)
    dfrac, dmean, dmax = agreement(direct_k, direct_p)
    phase("chain-vs-chain", f"li_direct on the kernels vs on the plain intersection, "
          f"config-1 band: {dfrac:.5f} of lanes within 1e-3, mean diff {dmean:.2e}, "
          f"max abs err {dmax:.3e}, mean L {float(direct_p.mean()):.6f}")
    if not (dfrac > 0.99 and bool(torch.isfinite(direct_k).all())):
        raise AssertionError("li_direct: the kernels change the result")
    wave = integrators._li_wavefront(scene, o, d, pixel, sample, settings.seed, cfg,
                                     cone=cone)
    wfrac, wmean, wmax = agreement(wave, mega)
    phase("chain-vs-chain", f"_li_wavefront on the kernels vs the megakernel, demo band, "
          f"depth {DEPTH}: {wfrac:.5f} of lanes within 1e-3, mean diff {wmean:.2e}, "
          f"max abs err {wmax:.3e}")
    if not (wfrac > 0.98 and wmean < 1e-2):
        raise AssertionError("the general chain disagrees with the megakernel")

    # scenes made with _replace (the reference's gradient idiom) render
    # their own tables: the megakernel with other materials and lights,
    # li_direct on the brute kernels with a prim moved
    rscene = scene._replace(
        materials=scene.materials._replace(kd=scene.materials.kd * 0.5),
        lights=scene.lights._replace(intensity=scene.lights.intensity * 3.0))
    _build.LAUNCHES.clear()
    r_k = megakernel.path_li_fused(rscene, o, d, pixel, sample, settings.seed, cfg, cone=cone)
    r_launches = dict(_build.LAUNCHES)
    r_p = megakernel.path_li_plain(rscene, o, d, pixel, sample, settings.seed, cfg, cone=cone)
    rfrac, rmean, rmax = agreement(r_k, r_p)
    phase("replace", f"megakernel on the demo band of base._replace(kd x 0.5, light "
          f"intensity x 3), launches {r_launches}: {rfrac:.5f} of lanes within 1e-3 of its "
          f"plain twin, mean diff {rmean:.2e}, max abs err {rmax:.3e}; mean L "
          f"{float(r_k.mean()):.6f} against the base's {float(mega.mean()):.6f}")
    if not (rfrac > 0.99 and rmean < 2e-3 and r_launches == {"megakernel": 1}
            and not torch.equal(r_k, mega)):
        raise AssertionError("the megakernel on a replaced scene: not its own tables")
    move = torch.tensor([0.0, 3.0, 0.0], device=dev)
    sph = scene1.prims.prim_type == 0
    o2w, w2o = scene1.prims.obj_to_world.clone(), scene1.prims.world_to_obj.clone()
    o2w[sph, :3, 3] += move
    w2o[sph, :3, 3] -= move  # translated spheres: w2o = translate(-centre)
    mscene = scene1._replace(prims=scene1.prims._replace(obj_to_world=o2w, world_to_obj=w2o))
    mcalls = []
    _build.LAUNCHES.clear()
    with recording(mcalls):
        m_k = integrators.li_direct(mscene, o1, d1, pix1, smp1, set1.seed,
                                    max_depth=set1.max_depth, cone=cone1,
                                    light_strategy=set1.light_strategy)
    m_launches = dict(_build.LAUNCHES)
    if mcalls[0][1] is scene1.brute:
        raise AssertionError("li_direct on a replaced scene read the base scene's table")
    # each launch at the kernels' own bars, on the table packed on the card
    m_agree, m_dead = [], [0, 0]
    for i, call in enumerate(mcalls):
        agree, _, ids, dead = check_intersect_call(*call)
        check_agreement(f"replaced scene {call[0]} launch {i}", agree, ids, dead)
        m_agree.append(agree)
        m_dead = [m_dead[0] + dead[0], m_dead[1] + dead[1]]
    with plain_intersection():
        m_p = integrators.li_direct(mscene, o1, d1, pix1, smp1, set1.seed,
                                    max_depth=set1.max_depth, cone=cone1,
                                    light_strategy=set1.light_strategy)
    mfrac, mmean, mmax = agreement(m_k, m_p)
    phase("replace", f"li_direct on the brute kernels, config-1 band with its spheres moved "
          f"3 up by _replace, launches {m_launches}: kernels vs plain on each launch, min "
          f"agreement {min(m_agree):.6f}, {m_dead[0]} dead lanes, {m_dead[1]} of them off; "
          f"{mfrac:.5f} of lanes within 1e-3 of li_direct on the plain intersection, mean "
          f"diff {mmean:.2e}; "
          f"{float(((m_k - direct_k).abs().amax(dim=-1) > 0).float().mean()):.4f} of the "
          f"lanes changed from the base scene's")
    if not (mfrac > 0.99 and m_launches == {"intersect": 4, "intersect_any": 3}
            and not torch.equal(m_k, direct_k)):
        raise AssertionError("li_direct on a replaced scene: not its own prims")

    # the mesh scene: kernels #4 and #5, their checks, times and bounds
    mesh = mesh_checks(dev, band_rows)

    # kernel and plain times at the main paths' launch shapes (CUDA events,
    # medians); the bounds count what these inputs need
    kernel_ms = cuda_ms(launch, reps=9)
    plain_ms = cuda_ms(lambda: megakernel.path_li_plain(
        scene, o, d, pixel, sample, settings.seed, cfg, cone=cone), reps=3)
    flops = megakernel.fp32_ops(counts)
    phase("kernel-time", "megakernel events of the demo band as [count, fp32 ops]: "
          + json.dumps({k: [v, v * megakernel.OPS_PER_EVENT[k]]
                        for k, v in counts.items()}))
    mega_bound = bound(flops, n_band * BYTES_PER_PATH + megakernel.TABLE_WORDS * 4)
    phase("kernel-time", f"megakernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms per band; "
          f"bound {mega_bound[0]:.5f} ms by {mega_bound[1]} ({flops / 1e9:.3f} GFLOP); "
          f"{mega_bound[0] / kernel_ms:.4f} of the bound")
    lane_slots("demo band, bounces per path", bounces)
    # every launch of the config-1 band: single launches between events,
    # and the bound of each by both methods: every lane tests every prim
    # (the old), and the work the function needs, the live lanes' tests
    # and the bytes each lane moves (the new)
    fused = {"intersect": bi.intersect_brute_fused, "intersect_any": bi.intersect_p_brute_fused}
    plain = {"intersect": bi.intersect_brute, "intersect_any": bi.intersect_p_brute}
    timing, band_launches = {}, []
    for i, (kind, *args) in enumerate(calls):
        k_ms = cuda_ms(lambda: fused[kind](*args), reps=21)
        b_old, b_new = brute_bounds(kind, *args)
        band_launches.append((kind, k_ms, b_old, b_new))
        phase("kernel-time", f"config-1 band launch {i}, {kind}: {k_ms:.4f} ms a single "
              f"launch of {n_band} rays; bound {b_new[0]:.5f} ms by {b_new[1]} (live lanes' "
              f"tests, {b_new[2] / 1e9:.4f} GFLOP), every lane {b_old[0]:.5f} ms by "
              f"{b_old[1]} ({b_old[2] / 1e9:.4f} GFLOP)")
        if kind not in timing:  # the first launch of each: camera, first shadow rays
            p_ms = cuda_ms(lambda: plain[kind](*args), reps=5)
            timing[kind] = (k_ms, p_ms, b_new[0], b_new[1])

    # ---- 4. main paths --------------------------------------------------
    # the demo, path depth 10: the megakernel only
    dt, launches, film = timed_passes(render, film_mod, scene, camera, settings, dev)
    if launches != {"megakernel": 4 * N_PASSES}:
        raise AssertionError(f"demo main path launched {launches} in {N_PASSES} passes, "
                             f"expected {4 * N_PASSES} megakernel launches")
    mega_launches = launches["megakernel"]
    phase("main-path", f"demo: {N_PASSES} passes of {W}x{H} 1 spp depth {DEPTH}: "
          f"{dt:.2f} ms per pass, launches {launches}")
    print(json.dumps({
        "metric": "camera_rays_per_s_1080p_path_depth10", "value": W * H / (dt / 1e3),
        "unit": "rays/s", "device": device_name, "power_limit": power_limit,
    }), flush=True)
    prof_line, own_d, _ = profiled_pass(render, scene, camera, film, settings, dev, dt)
    phase("main-path", "demo: " + prof_line
          + f"; the kernel is {4 * kernel_ms:.2f} ms (4 launches x {kernel_ms:.3f} ms)")

    settings4 = demo_settings(W, H, spp=4, samples_per_pass=1)
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    img = render.render(scene, camera, settings4, device=dev)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = film_mod.write_png(os.path.join(tmp, "demo.png"), img)
        with open(path, "rb") as f:
            png = f.read()
    if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"render: bad image {tuple(img.shape)}")
    img_mean = float(img.mean())
    if not img_mean > 0.01:
        raise AssertionError(f"render: image is black (mean {img_mean})")
    if not png.startswith(b"\x89PNG\r\n\x1a\n"):
        raise AssertionError("write_png: not a PNG")
    phase("render", f"demo {W}x{H} 4 spp in {render_s:.3f} s "
          f"({_build.LAUNCHES['megakernel']} launches), image mean {img_mean:.4f}, "
          f"PNG {len(png)} bytes")

    # config 1: direct lighting depth 3, one light per vertex
    dt1, launches1, film1 = timed_passes(render, film_mod, scene1, camera1, set1, dev)
    want = {"intersect": 16 * N_PASSES, "intersect_any": 12 * N_PASSES}
    if launches1 != want:
        raise AssertionError(f"config-1 main path launched {launches1} in {N_PASSES} "
                             f"passes, expected {want}")
    phase("main-path", f"config 1: {N_PASSES} passes of {W}x{H} 1 spp direct depth "
          f"{set1.max_depth}: {dt1:.2f} ms per pass, launches {launches1}")
    print(json.dumps({
        "metric": "camera_rays_per_s_1080p_direct_depth3", "value": W * H / (dt1 / 1e3),
        "unit": "rays/s", "device": device_name, "power_limit": power_limit,
    }), flush=True)
    img1 = film_mod.develop(film1)
    if not (bool(torch.isfinite(img1).all()) and float(img1.mean()) > 0.01):
        raise AssertionError("config 1: bad image")
    k1 = 4 * sum(b[1] for b in band_launches)
    prof_line, own_1, seq_1 = profiled_pass(render, scene1, camera1, film1, set1, dev, dt1)
    phase("main-path", "config 1: " + prof_line
          + f"; the kernels are ~{k1:.2f} ms (4 bands of the recorded band's single launches)")
    # the profiled pass's device ms of each launch of a band (the mean of
    # the 4 bands), beside that launch's single time and bounds
    for kind, fn in (("intersect", "closest_hit_kernel"), ("intersect_any", "any_hit_kernel")):
        mine = [b for b in band_launches if b[0] == kind]
        per = len(mine)
        if len(seq_1.get(fn, [])) != 4 * per:
            raise AssertionError(f"config-1 profiled pass: {len(seq_1.get(fn, []))} {fn} "
                                 f"launches, expected {4 * per}")
        prof = [statistics.mean(seq_1[fn][k::per]) for k in range(per)]
        phase("kernel-time", f"config-1 profiled pass, {kind} launch k of each band: device "
              "ms (mean of 4 bands) / single launch / bound / bound every lane: "
              + "; ".join(f"{k} {p:.4f} / {b[1]:.4f} / {b[3][0]:.5f} / {b[2][0]:.5f}"
                          for k, (p, b) in enumerate(zip(prof, mine)))
              + f"; 4 x the recorded band's bounds (the other bands' rays differ) "
              f"{4 * sum(b[3][0] for b in mine):.5f} ms, every lane "
              f"{4 * sum(b[2][0] for b in mine):.5f} ms")

    # outside the fast path: the general chain, path depth 5
    fscene, fcam = feature_scene(dev)
    fset = render.RenderSettings(width=W, height=H, spp=1, max_depth=5, seed=5)
    if fscene.fastinfo.ok:
        raise AssertionError("the feature scene should lie outside the fast path")
    dtf, launchesf, filmf = timed_passes(render, film_mod, fscene, fcam, fset, dev)
    imgf = film_mod.develop(filmf)
    if not (launchesf.get("intersect", 0) > 0 and launchesf.get("intersect_any", 0) > 0
            and "megakernel" not in launchesf):
        raise AssertionError(f"feature scene launched {launchesf}")
    if not (bool(torch.isfinite(imgf).all()) and float(imgf.mean()) > 0.01):
        raise AssertionError(f"feature scene: bad image (mean {float(imgf.mean())})")
    fcalls = []
    _, fo, fd, fpix, fsmp = render.band_rays(fcam, fset, band_rows, band_rows, 0)
    with recording(fcalls):
        integrators.li(fscene, fo, fd, fpix, fsmp, fset.seed, render.path_config(fset),
                       cone=render._cone(fcam, fset))
    fagree = []
    for i, call in enumerate(fcalls):
        agree, _, ids, dead = check_intersect_call(*call)
        check_agreement(f"feature scene {call[0]} launch {i}", agree, ids, dead)
        fagree.append(agree)
    phase("main-path", f"feature scene (plastic, metal, Oren-Nayar, triangle, disk lamp, "
          f"uv checker, power lights): {N_PASSES} passes of {W}x{H} 1 spp path depth 5: "
          f"{dtf:.2f} ms per pass, launches {launchesf}, image mean {float(imgf.mean()):.4f}; "
          f"kernels vs plain on one band's {len(fcalls)} launches: min agreement "
          f"{min(fagree):.6f}")

    # the mesh: the mesh megakernel, then the general chain on the BVH
    launches_m, launches_c, own_m = mesh_main_paths(render, film_mod, mesh, dev, device_name,
                                                    power_limit)
    # device ms per pass of each kernel, from the profiled passes
    per_pass = {**own_d, **own_1, **own_m}

    # ---- 5. kernels line ------------------------------------------------
    line = [{
        "name": "megakernel", "route": "cuda",
        "source": "gopbrt_tpu_torch/csrc/megakernel.cu",
        "replaces": "gopbrt_tpu/ops/pallas_megakernel.py:255",
        "launches": mega_launches, "launches_per_pass": mega_launches // N_PASSES,
        "max_abs_err": max_abs, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": mega_bound[0], "bound_by": mega_bound[1], "library_ms": None,
        "ms_per_pass": per_pass.get("mega_kernel"),
    }]
    for kind, line_no, fn in (("intersect", 172, "closest_hit_kernel"),
                              ("intersect_any", 276, "any_hit_kernel")):
        k_ms, p_ms, b_ms, b_by = timing[kind]
        line.append({
            "name": kind, "route": "cuda", "source": "gopbrt_tpu_torch/csrc/intersect.cu",
            "replaces": f"gopbrt_tpu/ops/pallas_intersect.py:{line_no}",
            "launches": launches1[kind], "launches_per_pass": launches1[kind] // N_PASSES,
            "max_abs_err": worst[kind][1], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_per_pass": per_pass.get(fn),
        })
    for name, source, replaces, launches, err, fn in (
            ("bvh_intersect", "bvh_intersect.cu", "pallas_cluster.py:127", launches_c,
             mesh["worst"]["bvh_intersect"][1], "bvh_closest_kernel"),
            ("bvh_intersect_any", "bvh_intersect.cu", "pallas_cluster.py:127", launches_c,
             mesh["worst"]["bvh_intersect_any"][1], "bvh_any_kernel"),
            ("mesh_megakernel", "mesh_megakernel.cu", "pallas_mesh_megakernel.py:357",
             launches_m, mesh["mesh_err"], "mesh_kernel")):
        k_ms, p_ms, b_ms, b_by = mesh["timing"][name]
        row = {
            "name": name, "route": "cuda", "source": f"gopbrt_tpu_torch/csrc/{source}",
            "replaces": f"gopbrt_tpu/ops/{replaces}",
            "launches": launches[name], "launches_per_pass": launches[name] // N_PASSES,
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_per_pass": per_pass.get(fn),
        }
        if name + "_last" in mesh["timing"]:  # the last bounce's launch
            last = mesh["timing"][name + "_last"]
            row.update(ms_last_launch=last[0], bound_ms_last_launch=last[2])
        line.append(row)
    phase("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
