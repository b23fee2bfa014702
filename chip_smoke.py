#!/usr/bin/env python3
"""GPU gate of the PyTorch/CUDA port: the path traces on one card.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises, so the script exits
non-zero and never prints the last line:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: compiles the CUDA sources of gopbrt_tpu_torch (first use), one
   nvcc per source, all at once, the host BVH builder and the C++ tracer
   (g++); prints each kernel's registers and spill bytes (ptxas) and the
   local loads and stores of its SASS (cuobjdump: spills and the walk's
   stack);
3. kernel vs plain, each kernel against its plain PyTorch version on the
   same inputs:
   - ``[camera-rays]``: the camera-ray kernel (csrc/camera_rays.cu) against
     ``render.band_rays_plain`` on one 1920x273 band of four 1080p cameras
     (the demo's and the mesh's, an orthographic one, a thin lens), at
     stratified 1 and 8 spp, random and Halton: pixel, sample and jitter
     bit-equal, o and d within 2e-7 (o relative to its largest component
     where that exceeds 1), d a unit vector; a crop window's columns of a
     band bit-equal to the band's lanes; the device ms of a launch (behind
     a spin kernel) beside its bound (48 B a lane written) and the plain
     version's ms;
   - ``[splat]``: the splat kernel (csrc/splat_rows.cu) through
     ``film.add_samples_rows`` against ``add_samples_rows_plain`` onto a
     1080p film that holds data, on the second 1920x273 band and on the
     last (12 rows past the image, a NaN in L there): the box filter at
     radius 1, 0.5 and 2 bit-equal, triangle, Gaussian, Mitchell and
     Lanczos within 1e-6; the device ms of a launch (behind a spin kernel)
     beside its bound (20 B a sample, 32 B a film pixel) and the plain
     version's ms a band;
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
   - media and subsurface (``family_checks``): every #2 / #3 launch of
     ``_li_wavefront`` over one 960x544 band of each of the reference's
     media and subsurface families (bounded media: closest hits at a finite
     t_max for the null-boundary walks; global fog; the BSSRDF's probe
     chords), each family's chain on the kernels against it on the plain
     intersection, ``li_direct`` with the fog, the BSSRDF and a bump-mapped
     matte (256x256), and d sum(L) / d kd of the SSS sphere and the fog
     floor at 128x128 on the kernels against the plain intersection;
4. main paths, each through ``render_pass`` with the launch counts set to 0
   just before it and read just after; one warm-up pass, then 5 timed passes
   and one more under ``torch.profiler`` (host ms of each ``render.*`` range,
   the device's busy time; a trace that holds fewer of the port's kernels
   than ``_build.LAUNCHES`` counted in the pass dropped events, and the
   pass is profiled again, at most twice, and never timed from it):
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
   - ``[options]`` on the demo at 1920x1080, 2 spp, depth 10 through
     ``render``: the crop window (#1 on the crop's 518,400 lanes, the
     scatter splat; its interior against the full render), the Halton
     sampler, a Mitchell and a Lanczos filter (#1's launches a pass, the
     splat's host ms), a checkpoint resumed to the uninterrupted image;
   - the six families of benchmarks/bench_families.py at their size,
     960x544, 1 spp (one band): smooth and rough glass depth 8 on #1 (one
     launch a pass; #1 against its plain version); bounded media (a fog
     ball behind a null boundary) depth 5, 30 closest-hit launches a pass;
     global fog depth 5, 5 + 5; subsurface depth 4, 8 + 4; the spatial
     light grid depth 3, 3 + 3;
   - ``[compaction]``: ``PathConfig(compaction=True)`` against the
     uncompacted chain on the demo (depth 10) and config 1's scene (path,
     depth 3) on #2 / #3 and the metal mesh (depth 5) on #4: every launch
     on compacted chunks against its plain version, every lane within
     1e-5 at two chunk sizes, the live lanes a bounce, the host syncs, one
     timed 1080p pass with and without (the compacted one through
     ``render_pass``), and a profiled pass of each chain (device busy ms and
     kernels);
   - ``[motion]``: a moving sphere at 1920x1080 (brute force) and an
     82-prim scene with 9 moving prims on the BVH at 512x512: no launch of
     the port's kernels (an animated table takes the plain, time-aware
     intersection), a band on the card against the same lanes on the CPU;
   - ``[shard]`` (``parallel/shard.py``): the demo at 1920x1080, 4 spp,
     depth 10 through ``render_sharded`` with the band film and with the
     replicated film, against ``render`` (every pixel within 2e-5), on a
     world-1 NCCL group and then on four ranks that share the card (data 2
     x sample 2, spawned processes, gloo: NCCL refuses two ranks on one
     device); #1's launches and the ms of each pass;
   - ``[shard-train]``: ``make_train_step`` on BASELINE config 5 (64x64, 64
     spp, depth 3), 10 Adam steps at world 1 and on the four ranks: the
     first step's gradients against single-process autograd (1e-3 of the
     largest entry), a falling loss, #2 / #3's launches, ms per step;
   - ``[service]``: ``RenderService`` on the card through the wire codec,
     the reference's empty request (1920x1080, 16 spp, depth 10; its PNG
     equal to ``render``'s image) and cornell, mesh (#5) and glass at
     1920x1080, 4 spp: seconds, launches, the PNG; over gRPC on a
     localhost port where grpc is installed;
   - ``[cross-validate]`` (``native/baseline.py``): each golden config at its
     published size (benchmarks/cross_validate.py's 480x270 or 480x480, 32
     or 48 spp, a box filter of radius 0.5) rendered on the card and traced
     by the independent C++ tracer (``native/cpu_baseline.cpp --scene``) on
     every core of the host: the images' means and 3x3 region means within
     the config's tolerances, config 1 on #2 / #3, configs 2 and 4 on #1,
     config 3 on #5; the render's ms and launches, the tracer's rays/s on
     the host's CPU;
   - ``[baseline]``: the C++ tracer's demo mode at 1920x1080, 1 spp, depth
     10, and its --scene mode on the 10,224-triangle mesh at 960x544, 1
     spp, depth 5, on one thread and on every core: the host CPU's rays/s;
   - ``[path-config]``: ``PathConfig`` with nee off, mis off and both off
     through ``integrators.li`` on the demo (1920x1080, depth 10) and the
     mesh (1920x1080, depth 5): a default-cfg control pass (#1 / #5) and
     one timed pass of each (no megakernel; #2 / #4, and #3 / #4's any hit
     only with NEE on), the image means; one band of each through ``li``,
     every launch against its plain version, the band against the plain
     intersection (> 98% of lanes within 1e-3);
   - ``[null-passes]``: the bounded-media family at 960x544, depth 5,
     through ``li`` with ``null_passes`` 0, 2 and 4 (5 + 5, 30 and 50
     launches a pass), every launch against its plain version, the pass at
     2 bit-equal to ``render_pass``'s with the default cfg;
   - ``[hlbvh]``: the 10,224-triangle mesh's bounds built SAH and HLBVH on
     one thread and every host core (the host's ms, the node counts), then
     a band of camera rays and their shadow rays through #4 on both trees:
     equal hits and occlusions, t within 1e-6 on the hits, other prims only
     on ties, each launch against its plain walk;
   - ``[goldens]``: the four golden configs as their goldens render
     (``gallery.golden_config``) through ``render.render`` against
     ``tests/goldens/*.npz`` at tests/test_goldens.py's gates, config 1 on
     #2 / #3, configs 2 and 4 on #1, config 3 on #5;
5. the kernels line: time per launch (the BVH walk's also on a band's
   last launch), launches, bound, plain time, device ms per pass from the
   profiled passes; the camera-ray kernel's row and the splat kernel's:
   their launches in the demo's main path (one a band), their ms from
   ``[camera-rays]`` and ``[splat]`` (a launch on the device, and a call's
   with the host's launch).  The brute kernels are timed on every launch of the
   config-1 band, beside the device ms of that launch in the profiled
   pass and its bound by two methods: the work the function needs (the
   tests of the lanes that are not dead, the bytes every lane moves) and
   every lane testing every prim.  ``launches_shard``,
   ``launches_shard_train``, ``launches_service``,
   ``launches_cross_validate``, ``launches_path_config``,
   ``launches_null_passes``, ``launches_hlbvh`` and ``launches_goldens``
   count each kernel's launches on those paths (all ranks).

Beside the kernel times, ``[lane-slots]`` lines give the lane-slot
efficiency of a launch of one thread per item on the redesigned kernels'
bands (the demo band, the mesh band, the metal mesh's camera and first
shadow rays): the per-item steps the plain versions count (a path's
bounces, a walk's nodes) over the slots of warps of 32 lanes.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, the script fails.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import platform
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
from torch.profiler import record_function

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
# BASELINE config 5 (benchmarks/bench_inverse.py:33-35, 127): image side,
# samples a pixel a step, Adam steps
INV_SIZE, INV_SPP, INV_STEPS = 64, 64, 40
# __global__ functions of csrc/*.cu, as the profiler names their launches
OWN_KERNELS = ("mega_kernel", "closest_hit_kernel", "any_hit_kernel",
               "bvh_closest_kernel", "bvh_any_kernel", "mesh_kernel", "camera_rays_kernel",
               "splat_rows_kernel")
# the _build.LAUNCHES name of each of OWN_KERNELS
LAUNCH_KEY = {"mega_kernel": "megakernel", "closest_hit_kernel": "intersect",
              "any_hit_kernel": "intersect_any", "bvh_closest_kernel": "bvh_intersect",
              "bvh_any_kernel": "bvh_intersect_any", "mesh_kernel": "mesh_megakernel",
              "camera_rays_kernel": "camera_rays", "splat_rows_kernel": "splat_rows"}
# profiled_pass: traces after the first one that dropped events
PROFILE_RETRIES = 2
# the compile-time instances of csrc/intersect.cu (brute_intersect.INSTANCE_*)
INSTANCES = ("full spheres and disks", "general")
# the kernels' wrappers by intersector: closest hit, any hit
FUSED = {"brute": ("intersect_brute_fused", "intersect_p_brute_fused"),
         "bvh": ("bvh_intersect_fused", "bvh_intersect_p_fused")}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def camera_launches(settings, passes: int = 1) -> int:
    """The camera-ray kernel's launches in ``passes`` passes of
    ``render_pass``: one a band of ``chunk_pixels`` and sample (a
    ``chain_pass`` is a pass at ``samples_per_pass`` 1)."""
    w, h = settings.width, settings.height
    band_rows = max(1, min((settings.chunk_pixels or w * h) // w, h))
    return math.ceil(h / band_rows) * settings.samples_per_pass * passes


def loop_launches(settings, passes: int = 1) -> dict:
    """The band loop's own launches in ``passes`` passes of ``render_pass``
    on row bands: the camera-ray kernel and the splat kernel, one each a
    band and sample."""
    n = camera_launches(settings, passes)
    return {"camera_rays": n, "splat_rows": n}


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


def cuda_ms(fn, reps: int, spin: bool = False) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after a warm-up.
    spin: each call is queued behind a sleeping kernel, so that the
    events time the device's work and not the host's launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(2_000_000)
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


def plain_intersection(accel="brute"):
    """The plain versions on the card's tensors, in place of the kernels."""
    mod = _intersector(accel)
    closest, any_hit = (("intersect_brute", "intersect_p_brute") if accel == "brute"
                        else ("bvh_intersect", "bvh_intersect_p"))
    return swapped_intersection(lambda _, *a: getattr(mod, closest)(*a),
                                lambda _, *a: getattr(mod, any_hit)(*a), accel)


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


# bytes a lane the camera-ray kernel writes: jitter 8, o 12, d 12, pixel 8,
# sample 8 (it reads two 4x4 matrices, once a block through the cache)
CAMERA_BYTES_PER_LANE = 48
# o and d against band_rays_plain: the plain version's matrix products
# round in cuBLAS's order (o relative to its largest component beyond 1)
CAMERA_TOL = 2e-7


def camera_rays_checks(dev, render, device_name: str, power_limit: str) -> dict:
    """``[camera-rays]``: the camera-ray kernel through ``band_rays`` against
    ``band_rays_plain`` on the card, on the second 1920x273 band of four
    1080p cameras (the demo's and the mesh's perspective ones, an
    orthographic one and a thin lens), each sampler: one launch each,
    synchronised; pixel, sample and jitter bit-equal; o and d within
    CAMERA_TOL; d a unit vector.  Then a crop window's columns of the
    band: the plain version's integers and jitter bit for bit, and the
    band's own lanes (o and d too) bit for bit, so a crop renders the rays
    of the full render.  Then the device ms of a launch (median of single
    launches) beside its bound, the ms of a call as the host's loop sees
    it, and the plain version's ms.  -> {"launches", "max_do", "max_dd",
    "ms", "call_ms", "plain_ms", "bound_ms"} (ms of the demo's stratified
    band)."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import camera as cam_mod
    from gopbrt_tpu_torch.models import demo, meshes
    from gopbrt_tpu_torch.ops import geom

    frame = geom.look_at([3.0, 4.0, 5.0], [0.0, 0.5, 0.0], [0.0, 1.0, 0.0])
    cameras = {"demo": demo.build_demo_camera(W, H, device=dev),
               "mesh10k": meshes.mesh_camera(W, H, device=dev),
               "orthographic": cam_mod.orthographic_camera(frame, W, H, device=dev),
               "thin lens": cam_mod.perspective_camera(frame, W, H, fov_deg=45.0,
                                                       lens_radius=0.1, focal_distance=4.0,
                                                       device=dev)}
    if not (cameras["orthographic"].kind == cam_mod.CAM_ORTHOGRAPHIC and cameras["thin lens"].lens_radius > 0):
        raise AssertionError("[camera-rays]: not an orthographic and a thin-lens camera")
    base = render.RenderSettings(width=W, height=H, spp=1, seed=2**31 + 1017)
    rows = base.chunk_pixels // W
    samplers = {"stratified 1 spp": base, "stratified 8 spp": base._replace(spp=8),
                "random": base._replace(sampler="random"),
                "halton": base._replace(sampler="halton", spp=8)}
    out = {"launches": 0, "max_do": 0.0, "max_dd": 0.0}
    for cname, cam in cameras.items():
        for sname, st in samplers.items():
            before = _build.LAUNCHES["camera_rays"]
            got = render.band_rays(cam, st, rows, rows, 3)
            torch.cuda.synchronize()
            out["launches"] += _build.LAUNCHES["camera_rays"] - before
            if _build.LAUNCHES["camera_rays"] != before + 1:
                raise AssertionError(f"[camera-rays] {cname}, {sname}: band_rays made "
                                     f"{_build.LAUNCHES['camera_rays'] - before} launches")
            want = render.band_rays_plain(cam, st, rows, rows, 3)
            torch.cuda.synchronize()
            same = [torch.equal(g, w) for g, w in zip((got[0], got[3], got[4]),
                                                      (want[0], want[3], want[4]))]
            same_dtype = [g.dtype == w.dtype and g.shape == w.shape
                          for g, w in zip(got, want)]
            scale = want[1].abs().amax(dim=1, keepdim=True).clamp(min=1.0)
            do = float(((got[1] - want[1]).abs() / scale).max())
            dd = float((got[2] - want[2]).abs().max())
            unit = float((got[2].double().norm(dim=1) - 1.0).abs().max())
            exact = float((got[2] == want[2]).all(dim=1).float().mean())
            out["max_do"], out["max_dd"] = max(out["max_do"], do), max(out["max_dd"], dd)
            phase("camera-rays", f"{cname}, {sname}, band of rows {rows}-{2 * rows - 1} "
                  f"({got[1].shape[0]} lanes): jitter, pixel, sample bit-equal {same}; "
                  f"max |do| (relative beyond 1) {do:.3e}, max |dd| {dd:.3e}, d bit-equal "
                  f"on {exact:.4f} of lanes, max ||d| - 1| {unit:.2e}")
            if not (all(same) and all(same_dtype) and do <= CAMERA_TOL and dd <= CAMERA_TOL
                    and unit <= 2.4e-7):
                raise AssertionError(f"[camera-rays] {cname}, {sname}: the kernel "
                                     "disagrees with band_rays_plain")
    # a crop window's columns of the band (the CROP of [options])
    st, cam = samplers["stratified 8 spp"], cameras["thin lens"]
    x0, x1 = W // 4, 3 * W // 4
    before = _build.LAUNCHES["camera_rays"]
    band = render.band_rays(cam, st, rows, rows, 3)
    got = render.band_rays(cam, st, rows, rows, 3, (x0, x1))
    torch.cuda.synchronize()
    out["launches"] += _build.LAUNCHES["camera_rays"] - before
    want = render.band_rays_plain(cam, st, rows, rows, 3, (x0, x1))
    same = [torch.equal(got[i], want[i]) for i in (0, 3, 4)]
    of_band = [torch.equal(g, b.reshape(rows, W, -1)[:, x0:x1].reshape(g.shape))
               for g, b in zip(got, band)]
    phase("camera-rays", f"thin lens, stratified 8 spp, columns [{x0}, {x1}) of the band "
          f"({got[1].shape[0]} lanes): jitter, pixel, sample bit-equal to the plain version "
          f"{same}; jitter, o, d, pixel, sample bit-equal to the band's lanes {of_band}")
    if not (all(same) and all(of_band)):
        raise AssertionError("[camera-rays]: a window's rays differ from the band's")
    st, cam = samplers["stratified 1 spp"], cameras["demo"]
    n = W * rows
    before = _build.LAUNCHES["camera_rays"]
    out["ms"] = cuda_ms(lambda: render.band_rays(cam, st, rows, rows, 0), 50, spin=True)
    out["call_ms"] = cuda_ms(lambda: render.band_rays(cam, st, rows, rows, 0), 50)
    out["launches"] += _build.LAUNCHES["camera_rays"] - before
    out["plain_ms"] = cuda_ms(lambda: render.band_rays_plain(cam, st, rows, rows, 0), 10)
    out["bound_ms"] = n * CAMERA_BYTES_PER_LANE / PEAK_BYTES_PER_S * 1e3
    phase("camera-rays", f"demo band {W}x{rows}, stratified 1 spp: {out['ms']:.4f} ms a "
          f"launch on the device (median of 50 single launches, each behind a sleeping "
          f"kernel; bound {out['bound_ms']:.4f} ms: {n * CAMERA_BYTES_PER_LANE / 1e6:.1f} MB "
          f"at 3.35 TB/s, share {out['bound_ms'] / out['ms']:.3f}); {out['call_ms']:.4f} ms "
          f"a band_rays call between events with the host's launch; plain band_rays "
          f"{out['plain_ms']:.3f} ms; {out['launches']} launches ({device_name}, "
          f"{power_limit})")
    return out


# bytes the splat kernel moves: a sample's jitter and L read once (20); a
# film pixel the band reaches read and written, rgb and weight (16 each way)
SPLAT_SAMPLE_BYTES, SPLAT_PIXEL_BYTES = 20, 32
# the filters other than the box against add_samples_rows_plain, relative
# to max(1, |value|): expf, sinf and the division by the radius are the
# kernel's, not PyTorch's
SPLAT_TOL = 1e-6


def splat_checks(dev, film_mod, device_name: str, power_limit: str, rows: int = 273) -> dict:
    """``[splat]``: the splat kernel through ``add_samples_rows`` against
    ``add_samples_rows_plain`` on the card, onto a 1920x1080 film that holds
    data, on the second 1920x273 band (``rows``: the main paths' band) and
    on the last (rows 819-1091; rows 1080-1091 past the image, a NaN in L on
    row 1080):
    one launch each, synchronised; the box filter at radius 1 (every cell's)
    and at 0.5 and 2 bit for bit, NaN where the plain film is NaN; the
    triangle, Gaussian, Mitchell and Lanczos filters within SPLAT_TOL.
    Then the device ms of a box launch on the second band (median of 50
    single launches, each behind a sleeping kernel) beside its bound, the
    ms of a call as the host's loop sees it, and the plain version's ms a
    band. -> {"launches", "max_err", "ms", "call_ms", "plain_ms",
    "bound_ms"}."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.ops import filters

    gen = torch.Generator(device=dev).manual_seed(2**31 + 19)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    base = film_mod.Film(rgb=rand(H, W, 3), weight=rand(H, W))
    filts = {"box 1": (filters.box_filter(1.0), True), "box 0.5": (filters.box_filter(0.5), True),
             "box 2": (filters.box_filter(2.0), True),
             "triangle 2": (filters.triangle_filter(2.0), False),
             "gaussian 2": (filters.gaussian_filter(2.0, 2.0), False),
             "mitchell 2": (filters.mitchell_filter(2.0), False),
             "lanczos 4": (filters.lanczos_filter(4.0, 3.0), False)}
    out = {"launches": 0, "max_err": 0.0}
    for row0 in (rows, (H - 1) // rows * rows):
        jitter, L = rand(rows, W, 2), rand(rows, W, 3) * 4.0
        past = max(0, row0 + rows - H)
        if past:
            L[H - row0, 7, 1] = float("nan")
        for fname, (filt, exact) in filts.items():
            got = film_mod.Film(base.rgb.clone(), base.weight.clone())
            before = _build.LAUNCHES["splat_rows"]
            film_mod.add_samples_rows(got, row0, jitter, L, filt)
            torch.cuda.synchronize()
            out["launches"] += _build.LAUNCHES["splat_rows"] - before
            if _build.LAUNCHES["splat_rows"] != before + 1:
                raise AssertionError(f"[splat] {fname}: add_samples_rows made "
                                     f"{_build.LAUNCHES['splat_rows'] - before} launches")
            want = film_mod.add_samples_rows_plain(
                film_mod.Film(base.rgb.clone(), base.weight.clone()), row0, jitter, L, filt)
            torch.cuda.synchronize()
            same_nan, bits, err = True, True, 0.0
            for g, w in ((got.rgb, want.rgb), (got.weight, want.weight)):
                nan = torch.isnan(w)
                same_nan &= torch.equal(torch.isnan(g), nan)
                bits &= torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32))
                err = max(err, float(((g[~nan] - w[~nan]).abs()
                                      / w[~nan].abs().clamp(min=1.0)).max()))
            nan_rows = int(torch.isnan(want.rgb).any(dim=2).any(dim=1).sum())
            out["max_err"] = max(out["max_err"], err)
            phase("splat", f"{fname}, band of rows {row0}-{row0 + rows - 1} ({past} past the "
                  f"image): bit-equal {bits}, NaN where the plain film is NaN {same_nan} "
                  f"({nan_rows} film rows hold a NaN), max error {err:.3e} of max(1, |value|)")
            if not (same_nan and (bits if exact else err <= SPLAT_TOL)
                    and (nan_rows > 0) == (past > 0)):
                raise AssertionError(f"[splat] {fname}, rows from {row0}: the kernel "
                                     "disagrees with add_samples_rows_plain")
    jitter, L = rand(rows, W, 2), rand(rows, W, 3)
    film, box = film_mod.Film(base.rgb.clone(), base.weight.clone()), filters.box_filter(1.0)
    before = _build.LAUNCHES["splat_rows"]
    out["ms"] = cuda_ms(lambda: film_mod.add_samples_rows(film, rows, jitter, L, box), 50,
                        spin=True)
    out["call_ms"] = cuda_ms(lambda: film_mod.add_samples_rows(film, rows, jitter, L, box), 50)
    out["launches"] += _build.LAUNCHES["splat_rows"] - before
    out["plain_ms"] = cuda_ms(
        lambda: film_mod.add_samples_rows_plain(film, rows, jitter, L, box), 10)
    nbytes = rows * W * SPLAT_SAMPLE_BYTES + (rows + 2) * W * SPLAT_PIXEL_BYTES
    out["bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
    phase("splat", f"box 1, band {W}x{rows}: {out['ms']:.4f} ms a launch on the device "
          f"(median of 50 single launches, each behind a sleeping kernel; bound "
          f"{out['bound_ms']:.4f} ms: {nbytes / 1e6:.1f} MB at 3.35 TB/s, share "
          f"{out['bound_ms'] / out['ms']:.3f}); {out['call_ms']:.4f} ms an add_samples_rows "
          f"call between events with the host's launch; add_samples_rows_plain "
          f"{out['plain_ms']:.3f} ms; {out['launches']} launches ({device_name}, {power_limit})")
    return out


# spin kernels (torch.cuda._sleep) that open each profiler session of _trace
PRIMER_SPINS = 4
# a device event of a trace: its name, start and duration in microseconds
DeviceEvent = collections.namedtuple("DeviceEvent", "name start_us dur_us")


def _trace(fn, ranges: tuple, host: bool = True):
    """Runs ``fn()`` under the profiler -> (host ms of each
    ``record_function`` range in ``ranges``, the device's kernels and
    copies as DeviceEvents).  A range shows twice, as a host event and as
    an annotation on the device's timeline; the device is busy for its
    kernels and copies.  host=False traces the device only (no host ms).
    The events are read from the profiler's kineto results as they are:
    ``prof.events()`` builds a Python object for each event, over 10x
    slower, seconds for a pass of tens of thousands of kernels.

    Late in a long process, a session loses the records of the card's
    first one to three operations (kernels, copies, annotations), which
    were a pass's first camera-ray kernel: the session opens with
    PRIMER_SPINS spin kernels of its own, left out of the events."""
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PRIMER_SPINS):
            torch.cuda._sleep(500_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host_ms, work = dict.fromkeys(ranges, 0.0), []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name, kind = e.name(), e.device_type()
        if kind == cpu and name in host_ms:
            host_ms[name] += e.duration_ns() / 1e6
        elif kind == cuda and name not in ranges and "spin_kernel" not in name:
            work.append(DeviceEvent(torch._C._demangle(name), e.start_ns() / 1e3,
                                    e.duration_ns() / 1e3))
    return host_ms, work


def profiled_pass(render, scene, camera, film, settings, dev, pass_ms: float):
    """One more pass under the profiler, read by render_pass's stage ranges
    (host time) and the device's busy time -> (the line to print, device
    ms of the pass in each of the port's kernels, by OWN_KERNELS name, and
    the device ms of each of their launches in start order).

    The trace must hold one event of the port's kernels for each launch
    ``_build.LAUNCHES`` counted in the pass.  A trace that holds fewer has
    dropped events: the pass is profiled again, at most PROFILE_RETRIES
    times, and where every trace fell short nothing of it is reported
    (the line says so; both dicts are empty)."""
    from gopbrt_tpu_torch import _build

    for attempt in range(1 + PROFILE_RETRIES):
        before = collections.Counter(_build.LAUNCHES)
        host, work = _trace(
            lambda: render.render_pass(scene, camera, film, settings, N_PASSES + 1, device=dev),
            ("render.band_rays", "render.li", "render.splat"))
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
        traced = {}
        for e in work:
            k = next((LAUNCH_KEY[k] for k in OWN_KERNELS if k in e.name), None)
            if k:
                traced[k] = traced.get(k, 0) + 1
        if traced == launched:
            break
        if any(n > launched.get(k, 0) for k, n in traced.items()):
            raise AssertionError(f"profiled pass: the trace holds {traced} of the port's "
                                 f"kernels, more than the {launched} launched")
        phase("profile", f"the trace dropped events: {traced} of the port's kernels against "
              f"{launched} launched, {len(work)} device events; "
              + ("profiling again" if attempt < PROFILE_RETRIES else "not measured"))
    else:
        return (f"one profiled pass: not measured, each of {1 + PROFILE_RETRIES} traces "
                f"held fewer of the port's kernels than were launched"), {}, {}
    host = {k.split(".")[1]: v for k, v in host.items()}
    device_ms = sum(e.dur_us for e in work) / 1e3
    seq = {k: [e.dur_us / 1e3 for e in sorted(work, key=lambda e: e.start_us) if k in e.name]
           for k in OWN_KERNELS}
    own = {k: sum(v) for k, v in seq.items() if v}
    busy = (f"device busy {device_ms:.3f} ms in {len(work)} kernels and copies, "
            f"{sum(own.values()):.3f} ms of it in the port's CUDA kernels "
            f"({', '.join(f'{k} {v:.4f}' for k, v in own.items())} ms per pass); idle "
            f"{1.0 - device_ms / pass_ms:.4f} of a timed pass"
            if device_ms > 0 else "device time not measured")
    return ("one profiled pass, host ms by range: "
            + ", ".join(f"{k} {v:.2f}" for k, v in host.items()) + f"; {busy}"), own, seq


def profiled(fn, ranges: tuple = ()) -> str:
    """Runs ``fn()`` once more under the profiler -> a line: host ms of each
    ``record_function`` range in ``ranges``, the device's busy ms, its
    kernel count and the five kernels that took the most device time."""
    host, work = _trace(fn, ranges)
    by_name = collections.Counter()
    for e in work:
        by_name[e.name] += e.dur_us / 1e3
    top = ", ".join(f"{name[:60]} {ms:.3f}" for name, ms in by_name.most_common(5))
    return ("host ms by range: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
            + f"; device busy {sum(by_name.values()):.3f} ms in {len(work)} kernels and "
            f"copies; most device ms: {top}")


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
    launch = megakernel.make_launch(mesh_megakernel.MESH, scene, o, d, pix, smp, settings.seed,
                                    cfg, cone, out)
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
    r_out = integrators.li_fused(mesh_megakernel.MESH, rmesh, o, d, pix, smp, settings.seed, cfg,
                                 cone=cone)
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
                worst=worst, mesh_err=mesh_err, band=(o, d, pix, smp, cfg, cone))


def mesh_main_paths(render, film_mod, m: dict, dev, device_name: str, power_limit: str):
    """Phase 4 on the mesh: the mesh scene's pass (the mesh megakernel) and
    the metal mesh's (the general chain on the BVH walk) -> the launch
    counts of each."""
    scene, metal, cam, settings = m["scene"], m["metal"], m["cam"], m["settings"]
    dt, launches, film = timed_passes(render, film_mod, scene, cam, settings, dev)
    want = {"mesh_megakernel": 4 * N_PASSES, **loop_launches(settings, N_PASSES)}
    if launches != want:
        raise AssertionError(f"mesh main path launched {launches} in {N_PASSES} passes, "
                             f"expected {want}")
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
            and set(launches_c) == {"bvh_intersect", "bvh_intersect_any", "camera_rays",
                                    "splat_rows"}
            and all(launches_c[k] == n for k, n in loop_launches(settings, N_PASSES).items())):
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


# launches a pass of each family at one band (bench_families.py's 960x544,
# 1 spp): the glass families run the megakernel (#1) once; on #2 / #3,
# bounded media 3 segments and a 3-step shadow walk of closest hits a
# bounce (a null material: no any hit); global fog a hit and a shadow ray a
# bounce; subsurface a hit, the probe's chord and a shadow ray; the spatial
# lights a hit and a shadow ray a bounce
FAMILY_LAUNCHES = {"smooth_glass": {"megakernel": 1}, "rough_glass": {"megakernel": 1},
                   "bounded_media": {"intersect": 30},
                   "global_fog": {"intersect": 5, "intersect_any": 5},
                   "sss": {"intersect": 8, "intersect_any": 4},
                   "spatial_lights": {"intersect": 3, "intersect_any": 3}}
FAM_GRAD_SIZE = 128


def bump_scene(device, size=256):
    """A bump-mapped matte sphere (a 32x32 uv checker as its height, scale
    0.5, tests/test_torch_media_chain.py's scene) on a floor under a point
    light, and its camera."""
    from gopbrt_tpu_torch.models import camera as cam_mod
    from gopbrt_tpu_torch.models.scene import SceneBuilder
    from gopbrt_tpu_torch.ops import geom

    b = SceneBuilder()
    tex = b.checkerboard_texture((1, 1, 1), (0, 0, 0), vs=(32.0, 0, 0), vt=(0, 32.0, 0),
                                 mapping="uv")
    b.sphere(geom.translate([0.0, 1.0, 0.0]), 1.0,
             b.matte(kd=(0.5, 0.5, 0.5), bump_tex=tex, bump_scale=0.5))
    b.disk(geom.rotate_x(-90.0), 20.0, b.matte(kd=(0.4, 0.4, 0.4)))
    b.point_light(p=(3.0, 4.0, 3.0), intensity=(60.0,) * 3)
    camera = cam_mod.perspective_camera(
        geom.look_at([0.0, 1.5, 4.5], [0.0, 0.8, 0.0], [0.0, 1.0, 0.0]), size, size,
        fov_deg=45.0, device=device)
    return b.build(accelerator="none", device=device), camera


def chains_agree(what: str, run, bar: float, accel="brute", lit=True) -> torch.Tensor:
    """``run()`` on the intersection kernels against ``run()`` on the plain
    intersection, per lane (> ``bar`` within 1e-3) -> the kernels' result.
    lit: the plain result's mean must be above 0."""
    got = run()
    with plain_intersection(accel):
        ref = run()
    frac, mean_rel, max_abs = agreement(got, ref)
    phase("chain-vs-chain", f"{what} on the kernels vs on the plain intersection: "
          f"{frac:.5f} of lanes within 1e-3, mean diff {mean_rel:.2e}, max abs err "
          f"{max_abs:.3e}, mean L {float(ref.mean()):.6f}")
    if not (frac > bar and bool(torch.isfinite(got).all())
            and (float(ref.mean()) > 0.0 or not lit)):
        raise AssertionError(f"{what}: the kernels change the result")
    return got


def family_pass(name, render, film_mod, scene, camera, settings, dev, out: dict,
                device_name: str, power_limit: str) -> None:
    """``[main-path]`` of one family: 1 warm-up, N_PASSES timed passes with
    the launch counts set to 0 just before and read just after
    (``FAMILY_LAUNCHES`` a pass), one profiled; the counts go to
    ``out["launches"]``."""
    dt, launches, film = timed_passes(render, film_mod, scene, camera, settings, dev)
    want = {k: v * N_PASSES for k, v in FAMILY_LAUNCHES[name].items()}
    want.update(loop_launches(settings, N_PASSES))
    if launches != want:
        raise AssertionError(f"{name} main path launched {launches} in {N_PASSES} "
                             f"passes, expected {want}")
    img = film_mod.develop(film)
    mean = float(img.mean())
    if not (bool(torch.isfinite(img).all()) and mean > 0.01):
        raise AssertionError(f"{name}: bad image (mean {mean})")
    out["launches"][name] = launches
    pixels = settings.width * settings.height
    phase("main-path", f"{name}: {N_PASSES} passes of {settings.width}x{settings.height} "
          f"1 spp path depth {settings.max_depth}: {dt:.2f} ms per pass "
          f"({pixels / (dt / 1e3):.0f} camera rays/s), launches per pass "
          f"{FAMILY_LAUNCHES[name]}, image mean {mean:.4f} ({device_name}, "
          f"{power_limit})")
    print(json.dumps({
        "metric": f"family_{name}_camera_rays_per_s_{settings.width}x{settings.height}"
                  f"_depth{settings.max_depth}", "value": pixels / (dt / 1e3), "unit": "rays/s",
        "ms_per_pass": dt, "launches_per_pass": FAMILY_LAUNCHES[name],
        "device": device_name, "power_limit": power_limit}), flush=True)
    line, _, _ = profiled_pass(render, scene, camera, film, settings, dev, dt)
    phase("main-path", f"{name}: " + line)


def family_checks(dev, render, film_mod, device_name: str, power_limit: str) -> dict:
    """The six families of bench_families.py at their own size (glass,
    media, subsurface, the spatial light grid) and a bump-mapped matte:

    - ``[kernel-vs-plain]``: on the glass families (fast path), the
      megakernel (#1) against ``path_li_plain`` on the band (> 0.99 of
      lanes within 1e-3, mean difference < 2e-3); on the
      others every #2 / #3 launch of ``_li_wavefront`` over one band
      against the plain versions (instance, dead lanes and those off the
      plain answer, which must be none; > 0.999 agree; no closest-hit prim
      other than the plain one clear of ties);
    - ``[chain-vs-chain]``: each family's ``_li_wavefront`` on the kernels
      against the same chain on the plain intersection (> 0.98 of lanes
      within 1e-3); ``li_direct`` with the global fog, the BSSRDF and bump
      (> 0.99); ``_li_wavefront`` on the bump scene at 256x256 (> 0.98);
    - ``[main-path]``: ``render_pass`` of each family, 1 warm-up, 5 timed
      passes with the launch counts set to 0 just before and read just
      after (``FAMILY_LAUNCHES`` a pass), one profiled;
    - ``[grad]``: d sum(L) to the SSS sphere's albedo and the fog floor's
      kd at 128x128, the chain on the kernels against the chain on the
      plain intersection (1e-4 of the largest entry).

    -> {"launches": {family: launch counts of the timed passes}, "worst":
    {kind: (least agreement, max abs t error)}, "dead": [dead lanes, off]}."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import gallery, integrators
    from gopbrt_tpu_torch.ops import megakernel

    out = {"launches": {}, "worst": {"intersect": (1.0, 0.0), "intersect_any": (1.0, 0.0),
                                     "megakernel": (1.0, 0.0)}, "dead": [0, 0]}
    for name, build in gallery.FAMILIES.items():
        scene, camera, settings = build(device=dev)
        cfg = render.path_config(settings)
        cone = render._cone(camera, settings)
        _, o, d, pix, smp = render.band_rays(camera, settings, 0, settings.height, 0)
        n = o.shape[0]
        if "megakernel" in FAMILY_LAUNCHES[name]:
            if not megakernel.fits(scene):
                raise AssertionError(f"{name} should lie on the megakernel's fast path")
            got = integrators.li_fused(megakernel.BRUTE, scene, o, d, pix, smp, settings.seed,
                                       cfg, cone=cone)
            ref = megakernel.path_li_plain(scene, o, d, pix, smp, settings.seed, cfg, cone=cone)
            frac, mean_rel, max_abs = agreement(got, ref)
            phase("kernel-vs-plain", f"megakernel, {name} band {settings.width}x"
                  f"{settings.height} ({n} lanes), depth {cfg.max_depth}, cone on: "
                  f"{frac:.5f} of lanes within 1e-3 (bar 0.99), mean diff {mean_rel:.2e} "
                  f"(bar 2e-3), max abs err {max_abs:.3e}, mean L {float(ref.mean()):.6f}")
            if not (frac > 0.99 and mean_rel < 2e-3 and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{name}: the megakernel disagrees with its plain version")
            w = out["worst"]["megakernel"]
            out["worst"]["megakernel"] = (min(w[0], frac), max(w[1], max_abs))
            family_pass(name, render, film_mod, scene, camera, settings, dev, out,
                        device_name, power_limit)
            continue
        if name == "spatial_lights" and scene.light_grid is None:
            raise AssertionError("the spatial-lights family has no light grid")
        calls = []
        with recording(calls):
            integrators._li_wavefront(scene, o, d, pix, smp, settings.seed, cfg, cone=cone)
        kinds = collections.Counter(c[0] for c in calls)
        if dict(kinds) != FAMILY_LAUNCHES[name]:
            raise AssertionError(f"{name}: _li_wavefront made the launches {dict(kinds)}")
        dead_fam, lo = [0, 0], {"intersect": 1.0, "intersect_any": 1.0}
        for i, call in enumerate(calls):
            agree, err, ids, dead = check_intersect_call(*call)
            check_agreement(f"{name} {call[0]} launch {i}", agree, ids, dead)
            dead_fam = [dead_fam[0] + dead[0], dead_fam[1] + dead[1]]
            lo[call[0]] = min(lo[call[0]], agree)
            w = out["worst"][call[0]]
            out["worst"][call[0]] = (min(w[0], agree), max(w[1], err))
            finite = call[4] < 1e29
            phase("kernel-vs-plain", f"{name} {call[0]} launch {i} ({n} rays, "
                  f"{float(finite.float().mean()):.4f} with a finite t_max, "
                  f"{float((call[4] > 2e-4).float().mean()):.4f} live; instance "
                  f"{INSTANCES[call[1].instance]}; {dead[0]} dead lanes, {dead[1]} off): "
                  f"{agree:.6f} agree, max abs err {err:.3e}"
                  + ("" if ids is None else f", prim ids {ids}"))
        out["dead"] = [out["dead"][0] + dead_fam[0], out["dead"][1] + dead_fam[1]]
        del calls
        phase("kernel-vs-plain", f"{name}: {dict(kinds)} launches over one {settings.width}x"
              f"{settings.height} band, depth {cfg.max_depth}; least agreement {lo}; "
              f"{dead_fam[0]} dead lanes, {dead_fam[1]} of them off the plain answer")

        chains_agree(f"{name} _li_wavefront, one band, depth {cfg.max_depth}",
                     lambda: integrators._li_wavefront(scene, o, d, pix, smp, settings.seed,
                                                       cfg, cone=cone), 0.98)
        if name in ("global_fog", "sss", "spatial_lights"):
            chains_agree(f"{name} li_direct, one band, depth 3",
                         lambda: integrators.li_direct(scene, o, d, pix, smp, settings.seed,
                                                       max_depth=3, cone=cone), 0.99)
        family_pass(name, render, film_mod, scene, camera, settings, dev, out, device_name,
                    power_limit)

    bscene, bcam = bump_scene(dev)
    bset = render.RenderSettings(width=256, height=256, spp=1, max_depth=3, seed=5)
    _, bo, bd, bpix, bsmp = render.band_rays(bcam, bset, 0, 256, 0)
    bcone = render._cone(bcam, bset)
    chains_agree("bump scene _li_wavefront, 256x256, depth 3",
                 lambda: integrators._li_wavefront(bscene, bo, bd, bpix, bsmp, bset.seed,
                                                   render.path_config(bset), cone=bcone), 0.98)
    chains_agree("bump scene li_direct, 256x256, depth 3",
                 lambda: integrators.li_direct(bscene, bo, bd, bpix, bsmp, bset.seed,
                                               max_depth=3, cone=bcone), 0.99)

    for name in ("sss", "global_fog"):
        scene, camera, settings = gallery.FAMILIES[name](FAM_GRAD_SIZE, FAM_GRAD_SIZE, device=dev)
        cfg = render.path_config(settings)
        _, o, d, pix, smp = render.band_rays(camera, settings, 0, FAM_GRAD_SIZE, 0)

        def grad():
            kd = scene.materials.kd.detach().clone().requires_grad_()
            L = integrators._li_wavefront(
                scene._replace(materials=scene.materials._replace(kd=kd)), o, d, pix, smp,
                settings.seed, cfg)
            return torch.autograd.grad(L.sum(), [kd])[0]

        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        g_k = grad()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        with plain_intersection():
            g_p = grad()
        scale = float(g_p.abs().max())
        rel = float((g_k - g_p).abs().max()) / scale if scale > 0 else math.inf
        phase("grad", f"{name} {FAM_GRAD_SIZE}x{FAM_GRAD_SIZE}, depth {cfg.max_depth}: "
              f"d sum(L) / d kd on the kernels (launches {launches}, forward and backward "
              f"{ms:.2f} ms) vs on the plain intersection: max diff / max entry {rel:.3e} "
              f"(max entry {scale:.6e}; bar 1e-4); row 0 {g_k[0].tolist()}")
        if not (bool(torch.isfinite(g_k).all()) and rel < 1e-4 and float(g_k[0].abs().max()) > 0):
            raise AssertionError(f"[grad] {name}: the kernels change the gradient")
    return out


# [options]: the demo at 1080p through render: spp, the crop window
OPT_SPP = 2
CROP = ((0.25, 0.25), (0.75, 0.75))


def traced(fn, pass_ms: float) -> str:
    """``fn()`` once under the profiler, the device only -> a line: device
    busy ms, kernel count, the port's kernels' device ms and launches, the
    idle share of a ``pass_ms`` pass."""
    _, work = _trace(fn, (), host=False)
    device_ms = sum(e.dur_us for e in work) / 1e3
    own, count = {}, collections.Counter()
    for e in work:
        k = next((k for k in OWN_KERNELS if k in e.name), None)
        if k:
            own[k] = own.get(k, 0.0) + e.dur_us / 1e3
            count[k] += 1
    line = (f"device busy {device_ms:.3f} ms in {len(work)} kernels and copies, the "
            f"port's kernels " + (", ".join(f"{k} {v:.4f} ms in {count[k]} launches"
                                            for k, v in own.items()) or "none")
            + f"; idle {1.0 - device_ms / pass_ms:.4f} of a {pass_ms:.2f} ms pass"
            if device_ms > 0 else "device time not measured")
    return line


def options_checks(dev, render, film_mod, scene, camera, settings, device_name: str,
                   power_limit: str) -> dict:
    """``[options]`` on the demo at 1920x1080, path depth 10, through
    ``render`` (the megakernel, #1):

    - the uninterrupted render at OPT_SPP spp (``progress`` once a pass);
    - the crop window CROP: one ``render_wave`` of its 518,400 lanes a
      pass (the scatter splat, with atomics), its launches (the camera-ray
      kernel on the window's columns, #1), #1 on the crop's lanes against
      ``path_li_plain``, and its interior pixels (one pixel in from the
      edge: every box tap inside the crop) against the same region of the
      full render, each within 1e-5: both take their rays from the
      camera-ray kernel and weigh a tap from the same rounded film
      position (the row splat's jitter is p_film - pixel), so only the
      order of the adds differs (the scatter splat's atomics);
    - the Halton sampler, a Mitchell and a Lanczos filter: N_PASSES timed
      passes each, #1's launches a pass and the splat's host ms in a
      profiled pass, a finite non-black image; #1 on a Halton band
      against ``path_li_plain``;
    - a checkpoint written after pass 1 of OPT_SPP and resumed: the image
      of the uninterrupted render within 1e-6, ``progress`` called for the
      remaining pass only.

    -> {"launches": the launch counts of these renders, "worst": (least
    agreement, max abs err) of #1}."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import camera as cam_mod
    from gopbrt_tpu_torch.models import integrators
    from gopbrt_tpu_torch.ops import filters, megakernel

    out = {"launches": collections.Counter(), "worst": (1.0, 0.0)}
    base = settings._replace(spp=OPT_SPP, samples_per_pass=1)
    cfg = render.path_config(base)
    cone = render._cone(camera, base)

    def counted(fn):
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        out["launches"].update(launches)
        return res, (time.perf_counter() - t0) * 1e3, launches

    def kernel_vs_plain(what, o, d, pix, smp):
        got = integrators.li_fused(megakernel.BRUTE, scene, o, d, pix, smp, base.seed, cfg,
                                   cone=cone)
        ref = megakernel.path_li_plain(scene, o, d, pix, smp, base.seed, cfg, cone=cone)
        frac, mean_rel, max_abs = agreement(got, ref)
        phase("kernel-vs-plain", f"megakernel, {what} ({o.shape[0]} lanes), depth "
              f"{cfg.max_depth}: {frac:.5f} of lanes within 1e-3, mean diff {mean_rel:.2e}, "
              f"max abs err {max_abs:.3e}, mean L {float(ref.mean()):.6f}")
        if not (frac > 0.99 and mean_rel < 2e-3 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{what}: the megakernel disagrees with its plain version")
        out["worst"] = (min(out["worst"][0], frac), max(out["worst"][1], max_abs))

    calls = []
    full, full_ms, launches = counted(lambda: render.render(
        scene, camera, base, progress=lambda p, n: calls.append((p, n)), device=dev))
    if calls != [(p + 1, OPT_SPP) for p in range(OPT_SPP)]:
        raise AssertionError(f"progress was called {calls}")
    phase("options", f"demo {W}x{H} {OPT_SPP} spp depth {base.max_depth} through render: "
          f"{full_ms:.2f} ms, launches {launches}, progress {calls}")

    crop_set = base._replace(crop=CROP)
    x0, x1, y0, y1 = render.crop_pixel_bounds(crop_set)
    crop, crop_ms, launches = counted(lambda: render.render(scene, camera, crop_set,
                                                            device=dev))
    n_crop = (x1 - x0) * (y1 - y0)
    # a pass: one camera-ray launch for the window, one megakernel launch
    if launches != {"megakernel": OPT_SPP, "camera_rays": OPT_SPP} or \
            tuple(crop.shape) != (y1 - y0, x1 - x0, 3):
        raise AssertionError(f"crop render: launches {launches}, image {tuple(crop.shape)}")
    diff = (crop[1:-1, 1:-1] - full[y0 + 1:y1 - 1, x0 + 1:x1 - 1]).abs().amax(dim=-1)
    phase("options", f"crop {CROP}: pixels [{x0}, {x1}) x [{y0}, {y1}), {n_crop} lanes a pass, "
          f"{crop_ms:.2f} ms for {OPT_SPP} passes, launches {launches}; interior against the "
          f"full render: max diff {float(diff.max()):.3e} (bar 1e-5), "
          f"{int((diff > 1e-6).sum())} of {diff.numel()} pixels over 1e-6; image mean "
          f"{float(crop.mean()):.4f} against the region's {float(full[y0:y1, x0:x1].mean()):.4f}")
    if not (float(diff.max()) <= 1e-5 and bool(torch.isfinite(crop).all())):
        raise AssertionError("the crop's interior differs from the full render")
    xs = torch.arange(x0, x1, device=dev)[None, :]
    ys = torch.arange(y0, y1, device=dev)[:, None]
    cpix = (ys * W + xs).reshape(-1)
    csmp = torch.zeros_like(cpix)
    p_film, u_lens = render.camera_samples(crop_set, cpix, csmp, base.seed)
    kernel_vs_plain("the crop's lanes", *cam_mod.generate_rays(camera, p_film, u_lens), cpix,
                    csmp)

    for what, change in (("halton", dict(sampler="halton")),
                         ("mitchell", dict(filter=filters.mitchell_filter(2.0))),
                         ("lanczos", dict(filter=filters.lanczos_filter(4.0, 3.0)))):
        opt = base._replace(**change)
        dt, launches, film = timed_passes(render, film_mod, scene, camera, opt, dev)
        out["launches"].update(launches)
        img = film_mod.develop(film)
        mean = float(img.mean())
        want = {"megakernel": 4 * N_PASSES, **loop_launches(opt, N_PASSES)}
        if launches != want or not (
                bool(torch.isfinite(img).all()) and mean > 0.01):
            raise AssertionError(f"{what}: launches {launches}, image mean {mean}")
        line, _, _ = profiled_pass(render, scene, camera, film, opt, dev, dt)
        phase("options", f"{what} ({W}x{H}, 1 spp a pass, filter radius {opt.filter.radius}): "
              f"{N_PASSES} passes, {dt:.2f} ms per pass, launches per pass "
              f"{{'megakernel': {launches['megakernel'] // N_PASSES}}}, image mean {mean:.4f} "
              f"({device_name}, {power_limit}); {line}")
        if what == "halton":
            _, ho, hd, hpix, hsmp = render.band_rays(camera, opt, 0, 273, 1)
            kernel_vs_plain("a Halton band of sample 1", ho, hd, hpix, hsmp)

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "film.ckpt")
        film = render.render_pass(scene, camera, film_mod.new_film(W, H, device=dev), base, 0,
                                  device=dev)
        render._save_checkpoint(ck, base, film, 1)
        calls = []
        resumed, _, launches = counted(lambda: render.render(
            scene, camera, base, progress=lambda p, n: calls.append(p), checkpoint_path=ck,
            device=dev))
        diff = float((resumed - full).abs().max())
        phase("options", f"checkpoint after pass 1 of {OPT_SPP}, resumed: progress {calls}, "
              f"launches {launches}; max diff to the uninterrupted render {diff:.3e} (bar 1e-6)")
        if not (calls == list(range(2, OPT_SPP + 1)) and diff <= 1e-6):
            raise AssertionError("the resumed render differs from the uninterrupted one")
    return out


# [compaction]: the lanes' chunk size that divides no band (padding slots)
ODD_CHUNK = 100_003


def chain_pass(render, integrators, film_mod, scene, camera, settings, cfg, dev,
               dispatch=False):
    """A pass of the general chain on every band (``_li_wavefront`` with
    ``cfg``, the row splat), in ``render_pass``'s ranges and one request of
    the tracer -> the film.  dispatch: through ``integrators.li`` with
    ``cfg`` instead, which picks the megakernels or the chain as
    ``render_pass`` does."""
    from gopbrt_tpu_torch.utils import trace

    film = film_mod.new_film(settings.width, settings.height, device=dev)
    band_rows = settings.chunk_pixels // settings.width
    cone = render._cone(camera, settings)
    with trace.request():
        for r0 in range(0, settings.height, band_rows):
            with trace.span("render.band_rays"):
                jitter, o, d, pix, smp = render.band_rays(camera, settings, r0, band_rows, 0)
            with trace.span("render.li"):
                if dispatch:
                    L = integrators.li(scene, o, d, pix, smp, settings.seed, cfg, cone=cone)
                else:
                    L = integrators._li_wavefront(scene, o, d, pix, smp, settings.seed, cfg,
                                                  cone=cone)
            with trace.span("render.splat"):
                film_mod.add_samples_rows(film, r0, jitter.reshape(band_rows, -1, 2),
                                          L.reshape(band_rows, -1, 3), settings.filter)
    return film


def compaction_checks(dev, render, film_mod, runs, device_name: str, power_limit: str) -> dict:
    """``[compaction]``: ``PathConfig(compaction=True)`` against the
    uncompacted chain, for each of ``runs`` ((name, scene, camera,
    settings, accel)): on one band, every kernel launch of the compacted
    chain at the default chunk_size against its plain version (the
    kernels' bars; a chunk's padding slots are there), then the compacted
    radiance at the default and at ODD_CHUNK against the uncompacted
    chain's (every lane within 1e-5; the lanes not bit-equal counted), the
    live lanes a bounce and the host syncs (the tracer's counters); then one
    timed 1080p pass of
    each (the band runs before warm them): the uncompacted chain through
    ``chain_pass``, the compacted one through ``render_pass`` with
    ``RenderSettings(compaction=True)``, the counts set to 0 just before
    each and read just after; then one profiled ``chain_pass`` of each.  -> {"launches": launch counts,
    "worst": {kind: (least agreement, max abs err)}}."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import integrators
    from gopbrt_tpu_torch.utils import trace

    out = {"launches": collections.Counter(), "worst": {}}
    for name, scene, camera, settings, accel in runs:
        t_start = time.perf_counter()
        cfg = render.path_config(settings)
        on = cfg._replace(compaction=True)
        band_rows = settings.chunk_pixels // settings.width
        cone = render._cone(camera, settings)
        _, o, d, pix, smp = render.band_rays(camera, settings, band_rows, band_rows, 0)
        n = o.shape[0]
        calls = []
        trace.enable()
        try:
            with recording(calls, accel), trace.request() as req:
                got = integrators._li_wavefront(scene, o, d, pix, smp, settings.seed, on,
                                                cone=cone)
        finally:
            trace.disable()
        live = req.counter("li.lanes_live")
        stats = {"live": [live[k] for k in sorted(live)],
                 "syncs": req.counter("host_syncs").get("compaction", 0)}
        kinds = collections.Counter(c[0] for c in calls)
        want = {"brute": {"intersect", "intersect_any"},
                "bvh": {"bvh_intersect", "bvh_intersect_any"}}[accel]
        if set(kinds) != want:
            raise AssertionError(f"{name}: the compacted chain launched {dict(kinds)}")
        worst, dead_run = {}, [0, 0]
        for i, call in enumerate(calls):
            agree, err, ids, dead = check_intersect_call(*call)
            check_agreement(f"{name} compacted {call[0]} launch {i}", agree, ids, dead)
            w = worst.get(call[0], (1.0, 0.0))
            worst[call[0]] = (min(w[0], agree), max(w[1], err))
            if dead is not None:
                dead_run = [dead_run[0] + dead[0], dead_run[1] + dead[1]]
        for k, v in worst.items():
            w = out["worst"].get(k, (1.0, 0.0))
            out["worst"][k] = (min(w[0], v[0]), max(w[1], v[1]))
        phase("kernel-vs-plain", f"compaction, {name}: {dict(kinds)} launches on chunks of "
              f"{min(on.chunk_size, n)} lanes over one {settings.width}x{band_rows} band "
              f"({n} lanes), each against its plain version: least agreement, max abs err "
              + ", ".join(f"{k} {v[0]:.6f}, {v[1]:.3e}" for k, v in worst.items())
              + (f"; {dead_run[0]} dead lanes, {dead_run[1]} of them off the plain answer"
                 if accel == "brute" else ""))
        ref = integrators._li_wavefront(scene, o, d, pix, smp, settings.seed, cfg, cone=cone)
        odd = integrators._li_wavefront(scene, o, d, pix, smp, settings.seed,
                                        on._replace(chunk_size=ODD_CHUNK), cone=cone)
        phase("compaction", f"{name}, one band: live lanes a bounce {stats['live']}, host "
              f"syncs {stats['syncs']}")
        for chunk, res in ((on.chunk_size, got), (ODD_CHUNK, odd)):
            diff = (res - ref).abs().amax(dim=-1)
            phase("compaction", f"{name}, chunk_size {chunk}: max abs diff to the uncompacted "
                  f"chain {float(diff.max()):.3e} (bar 1e-5), {int((diff > 0).sum())} of {n} "
                  f"lanes not bit-equal")
            if not (float(diff.max()) <= 1e-5 and bool(torch.isfinite(res).all())):
                raise AssertionError(f"{name}: the compacted chain differs from the uncompacted")

        t_checks = time.perf_counter() - t_start
        # one timed pass of each: the uncompacted chain through chain_pass
        # (render_pass would take the megakernel on the demo), the compacted
        # one through the user's entry point, render_pass with
        # RenderSettings(compaction=True); then one profiled pass of each
        # chain, which also counts the compacted chain's host syncs
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        chain_pass(render, integrators, film_mod, scene, camera, settings, cfg, dev)
        torch.cuda.synchronize()
        dt_u, launches_u = (time.perf_counter() - t0) * 1e3, dict(_build.LAUNCHES)
        film = film_mod.new_film(settings.width, settings.height, device=dev)
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        render.render_pass(scene, camera, film, settings._replace(compaction=True), 0,
                           device=dev)
        torch.cuda.synchronize()
        dt_c, launches_c = (time.perf_counter() - t0) * 1e3, dict(_build.LAUNCHES)
        out["launches"].update(launches_u)
        out["launches"].update(launches_c)
        img = film_mod.develop(film)
        if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01
                and set(launches_c) == want | set(loop_launches(settings))
                and all(launches_c[k] == n for k, n in loop_launches(settings).items())):
            raise AssertionError(f"{name}: compacted render_pass launched {launches_c}, "
                                 f"image mean {float(img.mean())}")
        for mode, c, dt, launches, st in (("uncompacted chain", cfg, dt_u, launches_u, False),
                                          ("compacted render_pass", on, dt_c, launches_c,
                                           True)):
            line = traced(lambda: chain_pass(render, integrators, film_mod, scene, camera,
                                             settings, c, dev), dt)
            syncs = trace.requests()[-1].counter("host_syncs").get("compaction", 0)
            phase("compaction", f"{name}, {mode}: one timed pass of {settings.width}x"
                  f"{settings.height} 1 spp depth {cfg.max_depth}: {dt:.2f} ms, launches "
                  f"{launches}" + (f", host syncs {syncs} a pass" if st else "")
                  + f" ({device_name}, {power_limit}); one profiled pass of the chain: {line}")
        phase("main-path", f"{name} through render_pass with compaction=True: image mean "
              f"{float(img.mean()):.4f}; compacted / uncompacted pass {dt_c / dt_u:.3f}")
        phase("time", f"[compaction] {name}: checks {t_checks:.1f} s, timed and profiled "
              f"passes {time.perf_counter() - t_start - t_checks:.1f} s")
    return out


MOTION_BVH_SIZE = 512
MOTION_BAND_ROWS = 16


def motion_scene(device, n_fill: int):
    """The moving sphere of tests/test_motion.py (a matte sphere of radius
    0.5 sliding from x = -1 to 1 across the shutter, a frontal distant
    light, depth 1) or, with ``n_fill`` > 0, above the brute-force cutoff:
    the sphere, a floor, ``n_fill`` small spheres of which every tenth
    moves up, a point light, on the BVH (depth 3) -> (scene, camera,
    settings at 1920x1080 or MOTION_BVH_SIZE square)."""
    from gopbrt_tpu_torch.models import camera as cam_mod
    from gopbrt_tpu_torch.models.scene import SceneBuilder
    from gopbrt_tpu_torch.ops import geom

    b = SceneBuilder()
    mat = b.matte(kd=(0.8, 0.8, 0.8))
    pid = b.sphere(geom.translate([-1.0, 0.0, 0.0]), 0.5, mat)
    b.animate(pid, geom.translate([1.0, 0.0, 0.0]))
    b.distant_light(direction=(0.0, 0.0, 1.0), radiance=(3.0, 3.0, 3.0))
    if not n_fill:
        cam = cam_mod.perspective_camera(geom.look_at([0.0, 0.0, 6.0], [0.0, 0.0, 0.0],
                                                      [0.0, 1.0, 0.0]), W, H, fov_deg=30.0,
                                         device=device)
        settings = render_settings(W, H, 1)
        return b.build(accelerator="none", device=device), cam, settings
    b.disk(geom.matmul(geom.translate([0.0, -1.0, 0.0]), geom.rotate_x(-90.0)), 20.0,
           b.matte(kd=(0.5, 0.6, 0.7)))
    small = b.matte(kd=(0.7, 0.4, 0.3))
    for i in range(n_fill):
        x, z = -3.0 + 0.6 * (i % 10), -3.0 - 0.6 * (i // 10)
        k = b.sphere(geom.translate([x, -0.7, z]), 0.25, small)
        if i % 10 == 0:
            b.animate(k, geom.translate([x, 0.2, z]))
    b.point_light(p=(2.0, 4.0, 3.0), intensity=(30.0,) * 3)
    s = MOTION_BVH_SIZE
    cam = cam_mod.perspective_camera(geom.look_at([0.0, 2.0, 6.0], [0.0, -0.5, -2.0],
                                                  [0.0, 1.0, 0.0]), s, s, fov_deg=45.0,
                                     device=device)
    return b.build(accelerator="bvh", device=device), cam, render_settings(s, s, 3)


def render_settings(width, height, depth):
    from gopbrt_tpu_torch.models.render import RenderSettings

    return RenderSettings(width=width, height=height, spp=1, max_depth=depth,
                          samples_per_pass=1, seed=13)


def motion_checks(dev, render, film_mod, device_name: str, power_limit: str) -> None:
    """``[motion]``: an animated scene turns the kernels off (the reference
    turns Pallas off for one, integrators.py:154-204).  For the moving
    sphere at 1920x1080 (brute force) and a scene of 82 prims with 9 of
    them moving at MOTION_BVH_SIZE square (the plain, time-aware BVH
    walk): N_PASSES timed passes with the counts set to 0 just before (no
    launch of the port's integrator kernels, the camera-ray kernel's one a
    band), a finite, non-black image, and the
    rows of a band (MOTION_BAND_ROWS rows, the shutter times drawn per
    lane) on the card against the same lanes on the CPU (> 0.99 within
    1e-3 relative)."""
    from gopbrt_tpu_torch.models import integrators

    for what, n_fill in (("moving sphere", 0), ("animated BVH scene", 80)):
        scene, camera, settings = motion_scene(dev, n_fill)
        if scene.prims.anim is None or (n_fill and scene.bvh is None):
            raise AssertionError(f"{what}: not an animated scene")
        dt, launches, film = timed_passes(render, film_mod, scene, camera, settings, dev)
        img = film_mod.develop(film)
        mean = float(img.mean())
        if launches != loop_launches(settings, N_PASSES) or not (
                bool(torch.isfinite(img).all()) and mean > 0.01):
            raise AssertionError(f"{what}: launches {launches}, image mean {mean}")
        cfg = render.path_config(settings)
        lanes = []
        for sc, cam in ((scene, camera), motion_scene("cpu", n_fill)[:2]):
            _, o, d, pix, smp = render.band_rays(cam, settings, settings.height // 2,
                                                 MOTION_BAND_ROWS, 0)
            time_ = render.camera_time(cam, pix, smp, settings.seed)
            lanes.append(integrators.li(sc, o, d, pix, smp, settings.seed, cfg,
                                        cone=render._cone(cam, settings), time=time_).cpu())
        frac, mean_rel, max_abs = agreement(lanes[0], lanes[1])
        phase("motion", f"{what} ({scene.prims.count} prims, "
              f"{int(scene.prims.anim.animated.sum())} moving, "
              f"{'the BVH walk' if n_fill else 'brute force'}), {settings.width}x"
              f"{settings.height} 1 spp depth {settings.max_depth}: {N_PASSES} passes, "
              f"{dt:.2f} ms per pass, launches {launches}, image mean {mean:.4f} "
              f"({device_name}, {power_limit}); {lanes[0].shape[0]} lanes of a band on the card "
              f"against the CPU: {frac:.5f} within 1e-3 (bar 0.99), mean diff {mean_rel:.2e}, "
              f"max abs err {max_abs:.3e}")
        if not (frac > 0.99 and float(lanes[1].mean()) > 0.0):
            raise AssertionError(f"{what}: the card disagrees with the CPU")



def grad_check(what: str, scene, band, seed, kernel: str, replay_kernels: tuple,
               device_name: str, power_limit: str) -> dict:
    """The ``[grad]`` phase on one band: ``integrators.li`` through the
    kernel's ``autograd.Function`` (the kernel forward, the path-replay
    backward through ``_li_wavefront`` on the intersection kernels), with
    every light's intensity scaled by one scalar s = 1, and the materials'
    kd and the textures' first colours (the demo camera sees only the
    checker backdrop) as leaves.  L is exactly linear in s, so d sum(L) / ds
    must equal the kernel's own sum(L) (relative 1e-3, the lanes whose
    discrete decisions float noise flips apart); the kd and colour
    gradients must equal autograd through ``_li_wavefront`` on the same
    lanes (relative 1e-4 of the largest entry of each).  The launch counts
    are set to 0 just before the forward and read after the backward."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import integrators

    o, d, pix, smp, cfg, cone = band
    s = torch.ones((), device=o.device, requires_grad=True)
    kd = scene.materials.kd.detach().clone().requires_grad_()
    col = scene.textures.value1.detach().clone().requires_grad_()

    def with_leaves(kd_, col_):
        return scene._replace(materials=scene.materials._replace(kd=kd_),
                              textures=scene.textures._replace(value1=col_))

    def forward():
        sc = with_leaves(kd, col)
        return integrators.li(sc._replace(lights=sc.lights._replace(
            intensity=sc.lights.intensity * s)), o, d, pix, smp, seed, cfg, cone=cone)

    # the first backward on the card loads its kernels: timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.autograd.grad(forward().sum(), [s, kd, col])
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    L = forward()
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_launches = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    g_s, g_kd, g_col = torch.autograd.grad(L.sum(), [s, kd, col])
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_build.LAUNCHES)
    if type(L.grad_fn).__name__ != "_ReplayBackward" or fwd_launches != {kernel: 1}:
        raise AssertionError(f"[grad] {what}: the forward launched {fwd_launches}, "
                             f"grad_fn {type(L.grad_fn).__name__}")
    if not all(launches.get(k, 0) > 0 for k in replay_kernels):
        raise AssertionError(f"[grad] {what}: the replay launched {launches}")
    total = float(L.detach().double().sum())
    rel_s = abs(float(g_s) - total) / abs(total)
    # the same gradient by autograd through the chain on the same lanes
    kd2 = kd.detach().clone().requires_grad_()
    col2 = col.detach().clone().requires_grad_()
    wave = integrators._li_wavefront(with_leaves(kd2, col2), o, d, pix, smp, seed, cfg,
                                     cone=cone)
    g_kd2, g_col2 = torch.autograd.grad(wave.sum(), [kd2, col2])
    scales = (float(g_kd2.abs().max()), float(g_col2.abs().max()))
    rel = [float((g - g2).abs().max()) / sc_ if sc_ > 0 else float((g - g2).abs().max())
           for g, g2, sc_ in ((g_kd, g_kd2, scales[0]), (g_col, g_col2, scales[1]))]
    finite = (bool(torch.isfinite(g_kd).all() & torch.isfinite(g_col).all())
              and math.isfinite(float(g_s)))
    phase("grad", f"{what} band ({o.shape[0]} lanes, depth {cfg.max_depth}), {kernel} "
          f"forward, path-replay backward: forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms "
          f"(the first forward and backward on the card {cold_ms:.2f} ms), "
          f"peak memory {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated); launches "
          f"{launches}; d sum(L)/ds {float(g_s):.6f} against the kernel's sum(L) "
          f"{total:.6f}: relative {rel_s:.3e} (bar 1e-3); against autograd through "
          f"_li_wavefront, max diff / max entry: kd {rel[0]:.3e} (max entry {scales[0]:.6e}), "
          f"texture colours {rel[1]:.3e} (max entry {scales[1]:.6e}); bar 1e-4")
    L = forward()
    phase("grad", f"{what} band, the replay backward profiled: " + profiled(
        lambda: torch.autograd.grad(L.sum(), [s, kd, col])))
    out = dict(metric=f"grad_replay_{what}_band", lanes=o.shape[0], depth=cfg.max_depth,
               fwd_ms=fwd_ms, bwd_ms=bwd_ms, first_ms=cold_ms, peak_memory_bytes=peak,
               launches=launches,
               rel_s=rel_s, rel_kd=rel[0], rel_colour=rel[1], max_kd_grad=scales[0],
               max_colour_grad=scales[1], device=device_name, power_limit=power_limit)
    print(json.dumps(out), flush=True)
    if not (finite and rel_s < 1e-3 and max(rel) < 1e-4 and max(scales) > 0.0):
        raise AssertionError(f"[grad] {what}: the replay gradient is off")
    return out


def inverse_config5(dev, device_name: str, power_limit: str) -> dict:
    """The ``[inverse]`` phase: BASELINE config 5 (benchmarks/
    bench_inverse.py) on the card.  The target at 64x64, 64 spp, depth 3
    with the true atlas and radiance; then ``steps`` Adam steps at 3e-2 on
    the sigmoid atlas and the log radiance through ``render_wave`` (the
    torch chain forward on the intersection kernels, autograd backward).
    Prints the benchmark's JSON fields; fails unless the loss fell, the
    visible texels' error fell and every loss and gradient is finite.
    The launch counts are set to 0 just before the steps and read after."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import film as film_mod
    from gopbrt_tpu_torch.models import gallery, render

    w = h = INV_SIZE
    spp, steps = INV_SPP, INV_STEPS
    true_atlas, true_rad = gallery.config5_truth()
    scene, cam, settings = gallery.config5(true_atlas, true_rad, w, h, device=dev)
    n = w * h
    pixel = torch.arange(n, device=dev).repeat(spp)
    sample = torch.arange(spp, device=dev).repeat_interleave(n)

    def render64(sc, off):
        film = render.render_wave(sc, cam, film_mod.new_film(w, h, device=dev), settings,
                                  pixel, sample + off)
        return film.rgb / torch.clamp(film.weight[..., None], min=1e-8)

    with torch.no_grad():
        target = render64(scene, 1 << 20)
        # the loss cannot fall below the MSE of two independent renders
        noise_floor = float(torch.mean((render64(scene, 1 << 21) - target) ** 2))
    logit = torch.zeros((16, 16, 3), device=dev, requires_grad=True)  # sigmoid(0) = 0.5
    log_rad = torch.full((3,), math.log(10.0), device=dev, requires_grad=True)
    opt = torch.optim.Adam([logit, log_rad], lr=3e-2)
    losses, finite, vis = [], torch.ones((), dtype=torch.bool, device=dev), None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    t_first = time.perf_counter()
    def step(k):
        opt.zero_grad()
        with record_function("inverse.forward"):
            sc = scene._replace(
                textures=scene.textures._replace(atlas=torch.sigmoid(logit)),
                lights=scene.lights._replace(intensity=torch.exp(log_rad)[None, :]))
            loss = torch.mean((render64(sc, k * spp) - target) ** 2)
        with record_function("inverse.backward"):
            loss.backward()
        with record_function("inverse.adam"):
            opt.step()
        return loss

    for k in range(steps):
        if k == 1:
            t0 = time.perf_counter()
        loss = step(k)
        if vis is None:
            # the texels the view constrains: nonzero gradient at the start
            vis = (logit.grad.abs().amax(dim=-1) > 1e-7).cpu().numpy()
        finite &= torch.isfinite(logit.grad).all() & torch.isfinite(log_rad.grad).all()
        losses.append(float(loss))
        if k == 0:
            first_ms = (time.perf_counter() - t_first) * 1e3
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_build.LAUNCHES)
    # one more step under the profiler, after the timed ones (its update is
    # not in the results below)
    state = (logit.detach().clone(), log_rad.detach().clone())
    prof_line = profiled(lambda: step(steps),
                         ("inverse.forward", "inverse.backward", "inverse.adam"))
    with torch.no_grad():
        logit.copy_(state[0])
        log_rad.copy_(state[1])
    atlas = torch.sigmoid(logit).detach().cpu().numpy()
    err0 = np.abs(0.5 - true_atlas).max(-1)
    err = np.abs(atlas - true_atlas).max(-1)
    rad_err = float(np.abs(np.exp(log_rad.detach().cpu().numpy()) - true_rad).mean())
    out = {
        "metric": "inverse_rendering_config5", "image": f"{w}x{h}", "spp_per_step": spp,
        "steps": steps, "loss_first": losses[0], "loss_last": losses[-1],
        "mc_noise_floor": noise_floor, "visible_texels": int(vis.sum()),
        "atlas_mae_visible_init": float(err0[vis].mean()),
        "atlas_mae_visible_final": float(err[vis].mean()),
        "radiance_mae_final": rad_err, "ms_per_step": ms_per_step,
        "first_step_ms": first_ms, "peak_memory_bytes": peak, "launches": launches,
        "device": device_name, "power_limit": power_limit,
    }
    print(json.dumps(out), flush=True)
    phase("inverse", f"config 5, {steps} Adam steps of {w}x{h} x {spp} spp ({n * spp} lanes), "
          f"depth 3: loss {losses[0]:.6f} -> {losses[-1]:.6f} (noise floor {noise_floor:.6f}), "
          f"visible-texel atlas MAE {out['atlas_mae_visible_init']:.4f} -> "
          f"{out['atlas_mae_visible_final']:.4f} on {int(vis.sum())} texels, radiance MAE "
          f"{rad_err:.3f}; {ms_per_step:.2f} ms per step (first {first_ms:.2f}), peak memory "
          f"{peak / 2**30:.3f} GiB; launches {launches}")
    phase("inverse", f"one more step profiled (a timed step took {ms_per_step:.2f} ms): "
          + prof_line)
    all_finite = bool(finite) and all(math.isfinite(x) for x in losses)
    if not (all_finite and losses[-1] < losses[0]
            and out["atlas_mae_visible_final"] < out["atlas_mae_visible_init"]):
        raise AssertionError("[inverse] config 5 did not train: " + json.dumps(out))
    if not (launches.get("intersect", 0) > 0 and launches.get("intersect_any", 0) > 0
            and "megakernel" not in launches):
        raise AssertionError(f"[inverse] the trainer launched {launches}")
    return out


# ---- the multi-rank render, the train step and the service ----------------

SHARD_SPP = 4  # [shard]: the demo at W x H, depth 10, through render_sharded
SHARED = (2, 2)  # the four ranks that share the card: data x sample
TRAIN_STEPS = 10  # [shard-train]: Adam steps of make_train_step on config 5
SERVICE_SPP = 4  # [service]: cornell, mesh and glass at W x H
RANKS_TIMEOUT_S = 600


def read_png(path: str) -> np.ndarray:
    """The pixels u8[H,W,3] of an 8-bit RGB PNG whose rows all take filter
    0, as ``film.write_png`` writes them."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise AssertionError(f"{path}: not a PNG")
    i, idat, w, h = 8, [], 0, 0
    while i < len(data):
        (n,), tag = struct.unpack(">I", data[i:i + 4]), data[i + 4:i + 8]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", data[i + 8:i + 16])
        elif tag == b"IDAT":
            idat.append(data[i + 8:i + 8 + n])
        i += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: a row takes a PNG filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def shard_renders(mesh, scene, camera, settings, ref) -> dict:
    """``render_sharded`` with the band film and with the replicated film,
    the launch counts set to 0 just before each and read after -> {mode:
    its largest difference from ``ref``, finiteness, ms of each pass, s in
    all, launches}."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.parallel import shard

    out = {}
    for mode, band_film in (("band", True), ("replicated", False)):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        _build.LAUNCHES.clear()
        img = shard.render_sharded(mesh, scene, camera, settings, band_film=band_film,
                                   progress=lambda done, total: marks.append(time.perf_counter()))
        torch.cuda.synchronize()
        out[mode] = {"max_abs_err": float((img - ref).abs().max()),
                     "finite": bool(torch.isfinite(img).all()),
                     "pass_ms": [(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
                     "s": time.perf_counter() - marks[0], "launches": dict(_build.LAUNCHES)}
    return out


def config5_problem(dev, sample: int = 1):
    """BASELINE config 5 at its published 64x64, 64 spp, depth 3 for
    ``make_train_step``: (scene, camera, settings with a rank's share of the
    64 samples in one pass, the target: the true scene's image from other
    samples, as ``[inverse]`` makes it)."""
    from gopbrt_tpu_torch.models import film as film_mod
    from gopbrt_tpu_torch.models import gallery, render

    true_atlas, true_rad = gallery.config5_truth()
    scene, cam, settings = gallery.config5(true_atlas, true_rad, INV_SIZE, INV_SIZE,
                                           device=dev)
    n = INV_SIZE * INV_SIZE
    with torch.no_grad():
        film = render.render_wave(
            scene, cam, film_mod.new_film(INV_SIZE, INV_SIZE, device=dev), settings,
            torch.arange(n, device=dev).repeat(INV_SPP),
            torch.arange(INV_SPP, device=dev).repeat_interleave(n) + (1 << 20))
        target = film.rgb / torch.clamp(film.weight[..., None], min=1e-8)
    return scene, cam, settings._replace(samples_per_pass=INV_SPP // sample), target


def config5_params(dev):
    """Fresh leaves: the atlas' logits (sigmoid 0.5) and the log radiance."""
    return (torch.zeros((16, 16, 3), device=dev, requires_grad=True),
            torch.full((3,), math.log(10.0), device=dev, requires_grad=True))


def config5_scene(scene):
    def to_scene(params):
        logit, log_rad = params
        return scene._replace(
            textures=scene.textures._replace(atlas=torch.sigmoid(logit)),
            lights=scene.lights._replace(intensity=torch.exp(log_rad)[None, :]))
    return to_scene


def train_run(mesh, scene, cam, settings, target) -> dict:
    """TRAIN_STEPS steps of ``make_train_step`` (Adam at 3e-2, as
    ``[inverse]``), the launch counts set to 0 just before the first and
    read after the last -> {losses, the first step's averaged gradients,
    ms of each step, launches}."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.parallel import shard

    params = config5_params(mesh.device)
    opt = torch.optim.Adam(params, lr=3e-2)
    step = shard.make_train_step(mesh, cam, settings, config5_scene(scene), opt)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    losses, ms, grads = [], [], None
    for k in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(params, target)))  # float() waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        if k == 0:
            grads = [p.grad.detach().cpu() for p in params]
    return {"losses": losses, "grads": grads, "ms": ms, "launches": dict(_build.LAUNCHES)}


def grad_off(got, ref) -> float:
    """The largest difference over the largest entry, of the worst tensor."""
    return max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))


def shared_rank(rank: int, world: int, tmp: str) -> None:
    """One of the four ranks that share the card, over gloo (a process of
    its own, started by ``shard_checks``): ``[shard]`` and ``[shard-train]``
    on the rank's cell of the data 2 x sample 2 mesh; its results go to
    ``tmp/rank<r>.pt``."""
    import torch.distributed as dist

    from gopbrt_tpu_torch.models.demo import (build_demo_camera, build_demo_scene,
                                              demo_settings)
    from gopbrt_tpu_torch.parallel import shard

    torch.set_num_threads(2)
    shard.init_distributed(init_method=f"file://{tmp}/store4", rank=rank, world_size=world,
                           backend="gloo")
    mesh = shard.make_mesh(*SHARED)
    dev = mesh.device
    ref = torch.load(os.path.join(tmp, "demo_ref.pt"), map_location=dev)
    out = {"device": str(dev), "backend": dist.get_backend(),
           "shard": shard_renders(mesh, build_demo_scene(device=dev),
                                  build_demo_camera(W, H, device=dev),
                                  demo_settings(W, H, spp=SHARD_SPP, samples_per_pass=1), ref)}
    scene, cam, settings, _ = config5_problem(dev, mesh.sample)
    out["train"] = train_run(mesh, scene, cam, settings,
                             torch.load(os.path.join(tmp, "target.pt"), map_location=dev))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(fn, world: int, tmp: str) -> list:
    """``fn(rank, world, tmp)`` in ``world`` processes -> their results; a
    rank that fails fails the call, and every process is stopped."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, tmp), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{world} ranks still running after {RANKS_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]


def _pass_line(r: dict) -> str:
    return (f"max abs diff {r['max_abs_err']:.3e}, {r['s']:.3f} s, ms per pass "
            + ", ".join(f"{t:.2f}" for t in r["pass_ms"]) + f"; launches {r['launches']}")


def _sum_launches(counts) -> dict:
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return dict(out)


def shard_checks(dev, device_name: str, power_limit: str) -> dict:
    """``[shard]`` and ``[shard-train]``: ``parallel/shard.py`` on the card.

    World 1 on NCCL (a process group over a file store): the demo at
    W x H, depth 10, SHARD_SPP spp through ``render_sharded`` with the
    band film and the replicated film against ``render`` (every pixel
    within 2e-5, the reference's bar, tests/test_sharding.py:59); then
    ``make_train_step`` on config 5, its first step's gradients against
    single-process autograd (1e-3 of the largest entry), the loss falling
    over TRAIN_STEPS steps.  Then the same on four ranks that share the
    card, data 2 x sample 2, over gloo: NCCL refuses two ranks on one
    device.  -> the launches of each path by kernel."""
    import torch.distributed as dist

    from gopbrt_tpu_torch.models import film as film_mod
    from gopbrt_tpu_torch.models import render
    from gopbrt_tpu_torch.models.demo import (build_demo_camera, build_demo_scene,
                                              demo_settings)
    from gopbrt_tpu_torch.parallel import shard

    with tempfile.TemporaryDirectory() as tmp:
        shard.init_distributed(init_method=f"file://{tmp}/store1", rank=0, world_size=1)
        mesh = shard.make_mesh()
        phase("shard", f"world 1 on {dist.get_backend()} over a file store, rank 0 on "
              f"{mesh.device}; {device_name}, {power_limit}")
        scene, camera = build_demo_scene(device=dev), build_demo_camera(W, H, device=dev)
        settings = demo_settings(W, H, spp=SHARD_SPP, samples_per_pass=1)
        t0 = time.perf_counter()
        ref = render.render(scene, camera, settings, device=dev)
        torch.cuda.synchronize()
        phase("shard", f"render, the demo {W}x{H} {SHARD_SPP} spp depth {DEPTH}: "
              f"{time.perf_counter() - t0:.3f} s")
        one = shard_renders(mesh, scene, camera, settings, ref)
        for mode, r in one.items():
            phase("shard", f"world 1, {mode} film: " + _pass_line(r))
        torch.save(ref, os.path.join(tmp, "demo_ref.pt"))

        c5, cam5, set5, target = config5_problem(dev)
        torch.save(target, os.path.join(tmp, "target.pt"))
        # the single-process autograd step's gradients, on the same lanes
        params = config5_params(dev)
        n = INV_SIZE * INV_SIZE
        film = render.render_wave(
            config5_scene(c5)(params), cam5, film_mod.new_film(INV_SIZE, INV_SIZE, device=dev),
            set5, torch.arange(n, device=dev).repeat(INV_SPP),
            torch.arange(INV_SPP, device=dev).repeat_interleave(n))
        loss = torch.mean((film.rgb / torch.clamp(film.weight[..., None], min=1e-8)
                           - target) ** 2)
        loss.backward()
        loss_ref = float(loss.detach())
        g_ref = [p.grad.detach().cpu() for p in params]
        train1 = train_run(mesh, c5, cam5, set5, target)
        off1 = grad_off(train1["grads"], g_ref)
        phase("shard-train", f"world 1, config 5 {INV_SIZE}x{INV_SIZE} x {INV_SPP} spp depth 3, "
              f"{TRAIN_STEPS} Adam steps: loss {train1['losses'][0]:.6f} -> "
              f"{train1['losses'][-1]:.6f} (single-process autograd {loss_ref:.6f}); first "
              f"step's gradients off autograd's by {off1:.3e} of the largest entry; ms per "
              f"step {statistics.median(train1['ms'][1:]):.2f} (median; first "
              f"{train1['ms'][0]:.2f}); launches {train1['launches']}; {device_name}, "
              f"{power_limit}")
        dist.destroy_process_group()

        phase("shard", f"four ranks share the card, data {SHARED[0]} x sample {SHARED[1]}, "
              "over gloo: NCCL refuses two ranks on one device ('Duplicate GPU detected'); "
              "the films and the rendering stay on the card")
        t0 = time.perf_counter()
        ranks = run_ranks(shared_rank, SHARED[0] * SHARED[1], tmp)
        phase("shard", f"four ranks: {time.perf_counter() - t0:.1f} s from spawn to join; "
              f"backends {sorted({r['backend'] for r in ranks})}, devices "
              f"{sorted({r['device'] for r in ranks})}")
        for mode in ("band", "replicated"):
            for k, r in enumerate(ranks):
                phase("shard", f"four ranks, {mode} film, rank {k}: "
                      + _pass_line(r["shard"][mode]))
        off4 = [grad_off(r["train"]["grads"], g_ref) for r in ranks]
        t = ranks[0]["train"]
        phase("shard-train", f"four ranks: loss {t['losses'][0]:.6f} -> {t['losses'][-1]:.6f}; "
              f"first step's gradients off autograd's by {max(off4):.3e} of the largest entry "
              f"(worst rank); ms per step {statistics.median(t['ms'][1:]):.2f} (rank 0, median; "
              f"first {t['ms'][0]:.2f}); launches "
              f"{_sum_launches(r['train']['launches'] for r in ranks)} (all ranks); "
              f"{device_name}, {power_limit}")

    bad = []
    for where, modes in [("world 1", one)] + [(f"rank {k}", r["shard"])
                                              for k, r in enumerate(ranks)]:
        for mode, r in modes.items():
            if not (r["finite"] and r["max_abs_err"] <= 2e-5):
                bad.append(f"{where} {mode}: {r['max_abs_err']:.3e}")
    # 4 bands of the image a sample, a camera-ray launch and a megakernel one
    # each, and on the replicated film a splat launch (the band film splats
    # with splat_band_halo)
    launches = {mode: _sum_launches([one[mode]["launches"]]
                                    + [r["shard"][mode]["launches"] for r in ranks])
                for mode in one}
    for mode in one:
        want = {"megakernel": 4 * SHARD_SPP, "camera_rays": 4 * SHARD_SPP}
        if mode == "replicated":
            want["splat_rows"] = 4 * SHARD_SPP
        got = [one[mode]["launches"], _sum_launches(r["shard"][mode]["launches"] for r in ranks)]
        if any(g != want for g in got):
            bad.append(f"{mode} film launched {got}, expected {want} a render")
    for where, t, off in [("world 1", train1, off1)] + [
            (f"rank {k}", r["train"], o) for k, (r, o) in enumerate(zip(ranks, off4))]:
        if not (all(math.isfinite(x) for x in t["losses"]) and t["losses"][-1] < t["losses"][0]
                and off <= 1e-3):
            bad.append(f"[shard-train] {where}: losses {t['losses']}, gradients off by {off:.3e}")
        if not (t["launches"].get("intersect", 0) > 0 and t["launches"].get("intersect_any", 0) > 0
                and "megakernel" not in t["launches"]):
            bad.append(f"[shard-train] {where} launched {t['launches']}")
    if len({tuple(r["train"]["losses"]) for r in ranks}) != 1:
        bad.append("[shard-train] the four ranks' losses differ")
    if bad:
        raise AssertionError("[shard] " + "; ".join(bad))
    return {"shard": _sum_launches(launches.values()),
            "shard_train": _sum_launches([train1["launches"]]
                                         + [r["train"]["launches"] for r in ranks])}


def service_checks(dev, device_name: str, power_limit: str) -> dict:
    """``[service]``: ``RenderService`` on the card through the wire codec:
    each request's bytes -> ``RenderRequest.FromString`` -> ``render`` ->
    the ``RenderResponse``'s bytes -> the PNG it names.  The reference's
    empty request (1920x1080, 16 spp, depth 10) and cornell, mesh and glass
    at W x H, SERVICE_SPP spp; the launch counts set to 0 just before each
    request and read after.  Each PNG must be the request's image (the
    handler's ``image`` once more: finite, not black); the demo's must be
    ``render``'s of the same settings.  Where grpc is installed, one more
    request goes through ``make_server`` on a localhost port.  -> the
    requests' launches by kernel."""
    import importlib.util

    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import film as film_mod
    from gopbrt_tpu_torch.models import render
    from gopbrt_tpu_torch.service.proto import RenderRequest, RenderResponse
    from gopbrt_tpu_torch.service.server import RenderService, make_server

    requests = [("demo", RenderRequest()),
                *((sid, RenderRequest(scene_id=sid, width=W, height=H, spp=SERVICE_SPP))
                  for sid in ("cornell", "mesh", "glass"))]
    kernel = {"demo": "megakernel", "cornell": "megakernel", "mesh": "mesh_megakernel",
              "glass": "megakernel"}
    total, bad = collections.Counter(), []
    with tempfile.TemporaryDirectory() as out_dir:
        svc = RenderService(device=dev, out_dir=out_dir)
        t0 = time.perf_counter()
        for sid, req in requests:  # the registry's scenes, built once per id
            svc.job(req)
        torch.cuda.synchronize()
        phase("service", f"scenes {[sid for sid, _ in requests]} built on {svc.device} in "
              f"{time.perf_counter() - t0:.2f} s")
        for sid, req in requests:
            wire = req.SerializeToString()
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            resp = svc.render(RenderRequest.FromString(wire), None).SerializeToString()
            secs = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            total.update(launches)
            path = RenderResponse.FromString(resp).path
            px = read_png(path)
            scene, camera, settings = svc.job(req)
            img = (render.render(scene, camera, settings, device=dev) if sid == "demo"
                   else svc.image(req))
            finite = bool(torch.isfinite(img).all())
            same = bool(np.array_equal(px, film_mod.to_uint8(img)))
            mean = float(img.mean())
            phase("service", f"{sid} ({len(wire)} request bytes; {settings.width}x"
                  f"{settings.height}, {settings.spp} spp, depth {settings.max_depth}): "
                  f"{secs:.3f} s, launches {launches}; PNG {path} {os.path.getsize(path)} "
                  f"bytes, {px.shape[1]}x{px.shape[0]}, equal to "
                  + ("render's" if sid == "demo" else "the handler's image once more")
                  + f": {same}; image mean {mean:.4f}; {device_name}, {power_limit}")
            # 4 bands of the image a sample, a camera-ray, an integrator and a
            # splat launch each
            want = {kernel[sid]: 4 * settings.spp, "camera_rays": 4 * settings.spp,
                    "splat_rows": 4 * settings.spp}
            if not (finite and same and mean > 0.01 and launches == want
                    and px.shape == (settings.height, settings.width, 3)):
                bad.append(f"{sid}: finite {finite}, PNG equal {same}, mean {mean}, "
                           f"launches {launches} (expected {want})")
        if importlib.util.find_spec("grpc") is None:
            phase("service", "the gRPC transport was not driven: grpc is not installed")
        else:
            import grpc

            server = make_server(port=0, service=svc)
            port = server.add_insecure_port("localhost:0")
            server.start()
            try:
                with grpc.insecure_channel(f"localhost:{port}") as chan:
                    stub = chan.unary_unary(
                        "/render.Render/Render",
                        request_serializer=RenderRequest.SerializeToString,
                        response_deserializer=RenderResponse.FromString)
                    t0 = time.perf_counter()
                    path = stub(requests[1][1], timeout=300).path
                phase("service", f"cornell over gRPC on localhost:{port}: "
                      f"{time.perf_counter() - t0:.3f} s, PNG {read_png(path).shape}")
            finally:
                server.stop(grace=None)
    if bad:
        raise AssertionError("[service] " + "; ".join(bad))
    return dict(total)


# [cross-validate]: the kernels each golden config's render must launch
# (and no other): #2 / #3 for config 1's direct lighting, #1 for the brute
# fast-path configs 2 and 4, #5 for the mesh of config 3; the camera rays'
# (#6) and the splat's (#7) in every one
VAL_KERNELS = {"config1_demo_direct": {"intersect", "intersect_any", "camera_rays",
                                       "splat_rows"},
               "config2_cornell_mirror": {"megakernel", "camera_rays", "splat_rows"},
               "config3_mesh_bvh": {"mesh_megakernel", "camera_rays", "splat_rows"},
               "config4_arealights_glass": {"megakernel", "camera_rays", "splat_rows"}}
# [baseline]: the mesh scene's size and depth in --scene mode
# (benchmarks/cross_validate.py --mesh-baseline)
MESH_BASE_W, MESH_BASE_H, MESH_BASE_DEPTH = 960, 544, 5


def host_cpu():
    """(the host CPU as the first processor of /proc/cpuinfo gives it: its
    name where reported, vendor, family, model and MHz; the cores this
    process may run on)."""
    info = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for ln in f:
            if not ln.strip():
                break
            key, _, value = ln.partition(":")
            info.setdefault(key.strip(), value.strip())
    desc = (f"{info.get('vendor_id', platform.machine())} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{info.get('cpu MHz', '?')} MHz")
    name = info.get("model name", "unknown")
    return (desc if name == "unknown" else f"{name}, {desc}"), len(os.sched_getaffinity(0))


def cross_validate_checks(dev, device_name: str, power_limit: str) -> dict:
    """``[cross-validate]``: each of ``baseline.VAL_CONFIGS`` at its published
    size rendered by the port on the card (``render_for_check``, the
    launch counts set to 0 just before and read just after) and traced by
    the independent C++ tracer on the host's cores; the two images'
    means and 3x3 region means within the row's tolerances, and each
    render on its kernels (VAL_KERNELS).  Every config runs; a failure
    raises after the last -> the launches of all four renders."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.native import baseline

    cpu, cores = host_cpu()
    total, failed = collections.Counter(), []
    for c in baseline.VAL_CONFIGS:
        scene, camera, settings = baseline.check_config(c.name, device=dev)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        img = baseline.render_for_check(scene, camera, settings, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        total.update(launches)
        port = img.cpu().numpy()
        ref, stats = baseline.trace_scene(scene, camera, c.width, c.height, c.spp, c.depth,
                                          cores, c.mode)
        row = baseline.compare(port, ref, c.mean_tol, c.region_tol)
        on_kernels = set(launches) == VAL_KERNELS[c.name]
        finite = port.shape == (c.height, c.width, 3) and bool(np.isfinite(port).all())
        phase("cross-validate", json.dumps({
            "config": c.name, "size": f"{c.width}x{c.height}", "spp": c.spp,
            "depth": c.depth, "mode": c.mode, **row, "port_ms": ms, "launches": launches,
            "device": device_name, "power_limit": power_limit,
            "cpp_seconds": stats["seconds"], "cpp_rays_per_s_host": stats["rays_per_s"],
            "host_cpu": cpu, "host_cores": cores}))
        if not (row["ok"] and on_kernels and finite):
            failed.append(c.name)
    if failed:
        raise AssertionError(f"[cross-validate] failed for {failed}: outside the tolerances, "
                             f"a non-finite image, or not on the kernels {VAL_KERNELS}")
    return dict(total)


def baseline_runs(mesh_scene) -> None:
    """``[baseline]``: the C++ tracer's demo mode at W x H, 1 spp, depth
    DEPTH (benchmarks/measure_baseline.py) and its --scene mode on the
    10,224-triangle mesh at 960x544, 1 spp, depth 5 (cross_validate.py
    --mesh-baseline), each on one thread and on every core of the host:
    the host CPU's rays/s, not the card's."""
    from gopbrt_tpu_torch.models.meshes import mesh_camera
    from gopbrt_tpu_torch.native import baseline

    cpu, cores = host_cpu()
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "mesh.txt")
        baseline.export_scene(mesh_scene, mesh_camera(MESH_BASE_W, MESH_BASE_H, device="cpu"),
                              dump)
        for metric, run in (
                (f"cpu_demo_rays_per_s_{W}x{H}_depth{DEPTH}",
                 lambda n: baseline.trace_demo(W, H, 1, DEPTH, n)),
                (f"cpu_mesh10k_rays_per_s_{MESH_BASE_W}x{MESH_BASE_H}_depth{MESH_BASE_DEPTH}",
                 lambda n: baseline.trace_dump(dump, MESH_BASE_W, MESH_BASE_H, 1,
                                               MESH_BASE_DEPTH, n)[1])):
            one, every = run(1), run(cores)
            phase("baseline", json.dumps({
                "metric": metric, "per_core_rays_per_s": one["rays_per_s"],
                "all_core_rays_per_s": every["rays_per_s"], "host_cores": cores,
                "thread_scaling_efficiency": every["rays_per_s"] / (one["rays_per_s"] * cores),
                "mean_luminance": one["mean_luminance"], "host_cpu": cpu}))


# [path-config]: the gated PathConfigs (nee, mis), by the names the lines print
PC_GATES = {"nee off": (False, True), "mis off": (True, False), "both off": (False, False)}
# [null-passes]: the null boundaries a bounded-media bounce and shadow ray walk through
NULL_PASSES = (0, 2, 4)


def worst_of(worst: dict, kind: str, agree: float, err: float) -> None:
    """Folds one launch's (agreement, max abs err) into ``worst[kind]``."""
    w = worst.get(kind, (1.0, 0.0))
    worst[kind] = (min(w[0], agree), max(w[1], err))


def check_calls(what: str, calls: list, worst: dict):
    """Every recorded launch against its plain version at the kernels' bars,
    each folded into ``worst`` -> (the launches by kind, the calls' least
    agreement by kind)."""
    kinds, least = collections.Counter(), {}
    for i, call in enumerate(calls):
        agree, err, ids, dead = check_intersect_call(*call)
        check_agreement(f"{what} {call[0]} launch {i}", agree, ids, dead)
        worst_of(worst, call[0], agree, err)
        least[call[0]] = min(least.get(call[0], 1.0), agree)
        kinds[call[0]] += 1
    return dict(kinds), least


def path_config_checks(dev, render, film_mod, runs, device_name: str, power_limit: str) -> dict:
    """``[path-config]``: ``PathConfig`` with nee off, mis off and both off
    (``PC_GATES``) through ``integrators.li``, the dispatch, for each of
    ``runs`` ((name, scene, camera, settings, accel)).  A control pass of
    the default cfg (the scene's megakernel) and one pass of each gated cfg,
    each through ``li`` in ``render_pass``'s bands (``chain_pass(dispatch=
    True)``), timed, the counts set to 0 just before each and read just
    after: a gated pass launches no megakernel, the closest-hit kernel of
    the scene's intersector, and its any-hit kernel only with NEE on.  The
    image means beside the control's; on one lane both the gated cfgs trace
    the same path, so mis off and nee off hold at least what both off does.
    Then one band of each gated cfg through ``li`` on the kernels: every
    launch against its plain version at the kernels' bars, the band against
    the same call on the plain intersection (> 98% of lanes within 1e-3).
    -> {"launches": the passes' launch counts, "worst": {kind: (least
    agreement, max abs err)}}."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import integrators

    out = {"launches": collections.Counter(), "worst": {}}
    for name, scene, camera, settings, accel in runs:
        t_start = time.perf_counter()
        cfg0 = render.path_config(settings)
        closest = "intersect" if accel == "brute" else "bvh_intersect"
        control = "megakernel" if accel == "brute" else "mesh_megakernel"
        means = {}
        for gate, (nee, mis) in (("default", (True, True)), *PC_GATES.items()):
            cfg = cfg0._replace(nee=nee, mis=mis)
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            t0 = time.perf_counter()
            film = chain_pass(render, integrators, film_mod, scene, camera, settings, cfg, dev,
                              dispatch=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(_build.LAUNCHES)
            out["launches"].update(launches)
            want = ({control} if gate == "default"
                    else {closest, closest + "_any"} if nee else {closest}) | {"camera_rays",
                                                                                "splat_rows"}
            img = film_mod.develop(film)
            linear = float(film_mod.develop(film, gamma=False).mean())
            means[gate] = linear
            phase("path-config", f"{name}, {gate} (nee={nee}, mis={mis}): one pass of "
                  f"{settings.width}x{settings.height} 1 spp path depth {cfg.max_depth} through "
                  f"li: {ms:.2f} ms, launches {launches}; image mean {float(img.mean()):.6f}, "
                  f"linear mean {linear:.6f} against the default cfg's {means['default']:.6f} "
                  f"({device_name}, {power_limit})")
            if set(launches) != want or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name}, {gate}: launched {launches}, expected the "
                                     f"kernels {sorted(want)}, or a non-finite image")
        if not (means["mis off"] >= means["both off"] and means["nee off"] >= means["both off"]
                and means["default"] > 0.0):
            raise AssertionError(f"{name}: the gated passes' means {means} are out of order")
        band_rows = settings.chunk_pixels // settings.width
        cone = render._cone(camera, settings)
        _, o, d, pix, smp = render.band_rays(camera, settings, band_rows, band_rows, 0)
        for gate, (nee, mis) in PC_GATES.items():
            cfg = cfg0._replace(nee=nee, mis=mis)
            calls = []
            with recording(calls, accel):
                integrators.li(scene, o, d, pix, smp, settings.seed, cfg, cone=cone)
            kinds, least = check_calls(f"{name}, {gate}", calls, out["worst"])
            phase("kernel-vs-plain", f"{name}, {gate}, one {settings.width}x{band_rows} band "
                  f"through li: launches {kinds}, each against its plain version: least "
                  "agreement " + ", ".join(f"{k} {v:.6f}" for k, v in least.items()))
            # with NEE off only emitter hits light a path: the demo's small
            # lamp may light none of a band's
            chains_agree(f"{name}, {gate}, li on one band", lambda: integrators.li(
                scene, o, d, pix, smp, settings.seed, cfg, cone=cone), 0.98, accel, lit=nee)
        phase("time", f"[path-config] {name}: {time.perf_counter() - t_start:.1f} s")
    out["launches"] = dict(out["launches"])
    return out


def null_passes_checks(dev, render, film_mod, device_name: str, power_limit: str) -> dict:
    """``[null-passes]``: the bounded-media family (a fog ball behind a null
    boundary) at its size, through ``render_pass`` with the default cfg,
    then one pass through ``li`` with each ``PathConfig.null_passes`` of
    NULL_PASSES (the counts set to 0 just before each and read just after;
    every launch recorded, then held against its plain version): at 0 one
    segment a bounce and an any-hit shadow ray, at k > 0 1 + k segments and
    a shadow walk of 1 + k closest hits a bounce; the pass at 2 (the
    default) bit-equal to the default cfg's.  -> {"launches", "worst"} as
    ``path_config_checks``."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import gallery, integrators

    scene, camera, settings = gallery.FAMILIES["bounded_media"](device=dev)
    depth = settings.max_depth
    out = {"launches": collections.Counter(), "worst": {}}
    film0 = film_mod.new_film(settings.width, settings.height, device=dev)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    render.render_pass(scene, camera, film0, settings, 0, device=dev)
    torch.cuda.synchronize()
    out["launches"].update(_build.LAUNCHES)
    mean0 = float(film_mod.develop(film0).mean())
    for k in NULL_PASSES:
        cfg = render.path_config(settings)._replace(null_passes=k)
        calls = []
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with recording(calls):
            film = chain_pass(render, integrators, film_mod, scene, camera, settings, cfg, dev,
                              dispatch=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        out["launches"].update(launches)
        want = ({"intersect": depth, "intersect_any": depth} if k == 0
                else {"intersect": 2 * (1 + k) * depth})
        kinds, least = check_calls(f"bounded media, null_passes {k}", calls, out["worst"])
        img = film_mod.develop(film)
        same = torch.equal(film.rgb, film0.rgb) and torch.equal(film.weight, film0.weight)
        phase("null-passes", f"bounded media {settings.width}x{settings.height} 1 spp path "
              f"depth {depth}, null_passes {k}: one pass through li {ms:.2f} ms, launches "
              f"{launches}, each against its plain version (least agreement "
              + ", ".join(f"{c} {v:.6f}" for c, v in least.items())
              + f"); image mean {float(img.mean()):.6f} against the default cfg's "
              f"{mean0:.6f} through render_pass" + (", bit-equal to it" if same else "")
              + f" ({device_name}, {power_limit})")
        if launches != {**want, **loop_launches(settings._replace(samples_per_pass=1))} \
                or kinds != want or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"null_passes {k}: launched {launches}, expected {want}")
        if k == 2 and not same:
            raise AssertionError("null_passes 2 differs from the default cfg's pass")
    out["launches"] = dict(out["launches"])
    return out


def hlbvh_checks(dev, mesh: dict, device_name: str, power_limit: str) -> dict:
    """``[hlbvh]``: the 10,224-triangle mesh scene's prim bounds built by the
    native builder with method "sah" and "hlbvh", on one thread and on every
    host core (the host CPU's build ms, the median of 3, and the node
    counts; the tree must not depend on the threads); the SAH tree is the
    scene's.  Then the mesh band's camera rays and their shadow rays toward
    the point light through the BVH walk (#4) on both trees, the counts set
    to 0 just before and read just after: the HLBVH tree's hits and
    occlusions equal the SAH tree's, its t within 1e-6 relative on the
    hits, another prim only on a tie (``bvh_prim_mismatches``: the same t
    or a shared edge); each launch against its plain walk.  -> {"launches",
    "worst"}."""
    from gopbrt_tpu_torch import _build, native
    from gopbrt_tpu_torch.models import meshes
    from gopbrt_tpu_torch.ops import bvh

    cpu, cores = host_cpu()
    lo, hi = bvh._prim_bounds_np(meshes.mesh_builder())
    for method in ("sah", "hlbvh"):
        trees = []
        for threads in (1, cores):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                tree = native.bvh_build(lo, hi, bvh.MAX_LEAF, bvh.N_BUCKETS, threads, method)
                times.append((time.perf_counter() - t0) * 1e3)
            trees.append(tree)
            phase("hlbvh", json.dumps({
                "method": method, "prims": lo.shape[0], "threads": threads,
                "host_build_ms": statistics.median(times), "nodes": tree[0].shape[0],
                "host_cpu": cpu}))
        if not all(np.array_equal(a, b) for a, b in zip(*trees)):
            raise AssertionError(f"{method}: the tree depends on the build's threads")
    scene = mesh["scene"]
    sah = scene.bvh_tables
    tree, used, method, build_ms = bvh.build_timed(lo, hi, backend="native", method="hlbvh")
    if (used, method) != ("native", "hlbvh"):
        raise AssertionError(f"asked for a native HLBVH, built {used} {method}")
    hl = bvh.bvh_table(bvh.LinearBVH(*(t.to(dev) for t in tree)), scene.prims, used, build_ms)
    same_sah = all(torch.equal(getattr(sah.bvh, f).cpu(), t) for f, t in zip(
        bvh.LinearBVH._fields, bvh.build_from_bounds(lo, hi, backend="native")))
    if not same_sah:
        raise AssertionError("the scene's tree is not the native SAH build of its bounds")
    o, d = mesh["band"][:2]
    n = o.shape[0]
    big = torch.full((n,), 1e30, device=dev)
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    hs, t_s, p_s = bvh.bvh_intersect_fused(sah, o, d, big)
    hh, t_h, p_h = bvh.bvh_intersect_fused(hl, o, d, big)
    so, sd, st = shadow_rays(scene, o, d, t_s, hs)
    occ_s = bvh.bvh_intersect_p_fused(sah, so, sd, st)
    occ_h = bvh.bvh_intersect_p_fused(hl, so, sd, st)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    ids = bvh_prim_mismatches(hl, o, d, big, t_h, p_h, t_s, p_s, hs & hh)
    t_rel = float(((t_h - t_s).abs() / t_s.abs().clamp(min=1e-30))[hs & hh].max())
    out = {"launches": launches, "worst": {}}
    walk_ms = {}
    for label, tab in (("sah", sah), ("hlbvh", hl)):
        for kind, args in (("bvh_intersect", (tab, o, d, big)),
                           ("bvh_intersect_any", (tab, so, sd, st))):
            agree, err, ids_k, _ = check_intersect_call(kind, *args)
            check_agreement(f"{label} tree {kind}", agree, ids_k)
            worst_of(out["worst"], kind, agree, err)
            fused = bvh.bvh_intersect_fused if kind == "bvh_intersect" else bvh.bvh_intersect_p_fused
            walk_ms[f"{label} {kind}"] = cuda_ms(lambda: fused(*args), reps=21)
    phase("hlbvh", f"the mesh band {mesh['settings'].width}x{n // mesh['settings'].width} "
          f"({n} camera rays, {int((st > 1e-3).sum())} shadow rays) through the BVH walk on "
          f"the SAH tree ({sah.bvh.node_lo.shape[0]} nodes) and the HLBVH tree "
          f"({tree.node_lo.shape[0]} nodes, built in {build_ms:.1f} host ms), launches "
          f"{launches}: hits equal {bool(torch.equal(hs, hh))}, occlusions equal "
          f"{bool(torch.equal(occ_s, occ_h))}, t max rel. diff on hits {t_rel:.3e}, prim ids "
          f"{ids}; each launch against its plain walk: least agreement "
          + ", ".join(f"{k} {v[0]:.6f}" for k, v in out["worst"].items())
          + "; ms a launch " + ", ".join(f"{k} {v:.4f}" for k, v in walk_ms.items())
          + f" ({device_name}, {power_limit})")
    if not (torch.equal(hs, hh) and torch.equal(occ_s, occ_h) and t_rel <= 1e-6
            and ids["untied"] == 0
            and launches == {"bvh_intersect": 2, "bvh_intersect_any": 2}):
        raise AssertionError("the HLBVH tree's walk differs from the SAH tree's")
    return out


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
# the goldens' gates, tests/test_goldens.py:40-45: (mean abs diff, per-pixel
# diff, the fraction of pixels within it), in sRGB
TOLS = {
    "config1_demo_direct": (1e-3, 5e-3, 0.995),
    "config2_cornell_mirror": (5e-4, 5e-3, 0.995),
    "config3_mesh_bvh": (1e-3, 5e-3, 0.995),
    "config4_arealights_glass": (5e-4, 5e-3, 0.995),
}


@contextlib.contextmanager
def plain_kernels():
    """The plain versions of all five kernels on the card's tensors, in
    place of the kernels, for the duration."""
    from gopbrt_tpu_torch.models import integrators
    from gopbrt_tpu_torch.ops import megakernel as mk

    def plain(kernel, scene, o, d, pixel, sample, seed, cfg, cone=None):
        p, s = mk.check_inputs(kernel, scene, o, d, pixel, sample)
        return mk.path_li_plain(scene, o, d, p, s, seed, cfg, cone=cone, accel=kernel.accel)

    saved = integrators.li_fused
    integrators.li_fused = plain
    try:
        with plain_intersection(), plain_intersection("bvh"):
            yield
    finally:
        integrators.li_fused = saved


def goldens_checks(dev, render, device_name: str, power_limit: str) -> dict:
    """``[goldens]``: each golden config as its golden renders
    (``gallery.golden_config``) through ``render.render`` on the card, the
    counts set to 0 just before and read just after, against
    ``tests/goldens/<name>.npz`` at TOLS, on its kernels (VAL_KERNELS).  A
    config outside its gates prints its per-pixel error histogram and its
    image against the same render on the plain versions.  Every config
    runs; a failure raises after the last -> the launches of all four."""
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import gallery

    total, failed = collections.Counter(), []
    for name, (mean_tol, pix_tol, frac_tol) in TOLS.items():
        ref = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["img"].astype(np.float32)
        scene, camera, settings = gallery.golden_config(name, device=dev)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        img = render.render(scene, camera, settings, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        total.update(launches)
        got = img.cpu().numpy()
        diff = np.abs(got - ref) if got.shape == ref.shape else np.full(ref.shape, np.inf)
        within = float((diff < pix_tol).mean())
        ok = float(diff.mean()) < mean_tol and within > frac_tol
        on_kernels = set(launches) == VAL_KERNELS[name]
        phase("goldens", json.dumps({
            "config": name, "size": f"{settings.width}x{settings.height}", "spp": settings.spp,
            "depth": settings.max_depth, "mean_abs_diff": float(diff.mean()),
            "mean_tol": mean_tol, "pixels_within": within, "pixel_tol": pix_tol,
            "fraction_tol": frac_tol, "ok": ok, "render_ms": ms, "launches": launches,
            "device": device_name, "power_limit": power_limit}))
        if not ok:
            edges = [0.0, 1e-4, 1e-3, 5e-3, 1e-2, 5e-2, np.inf]
            hist, _ = np.histogram(diff.max(axis=-1), bins=edges)
            with plain_kernels():
                plain = render.render(scene, camera, settings, device=dev).cpu().numpy()
            phase("goldens", f"{name}: per-pixel max abs diff to the golden by bin "
                  f"{edges}: {hist.tolist()}; the plain versions' render: mean abs diff to "
                  f"the golden {float(np.abs(plain - ref).mean()):.3e}, "
                  f"{float((np.abs(got - plain) < pix_tol).mean()):.5f} of the kernels' "
                  f"pixel channels within {pix_tol} of it")
        if not (ok and on_kernels and bool(np.isfinite(got).all())):
            failed.append(name)
    if failed:
        raise AssertionError(f"[goldens] failed for {failed}: outside tests/test_goldens.py's "
                             f"TOLS, or not on the kernels {VAL_KERNELS}")
    return dict(total)


def main() -> int:
    t_start = time.perf_counter()
    marks = [t_start]

    def stamp(what: str) -> None:
        """A ``[time]`` line: the seconds since the last one."""
        marks.append(time.perf_counter())
        phase("time", f"{what}: {marks[-1] - marks[-2]:.1f} s")

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
    from gopbrt_tpu_torch.native import baseline
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
    t1 = time.perf_counter()
    tracer = baseline.build()
    phase("build", f"total {build_s:.1f} s; the host BVH builder (g++) {t1 - t0:.1f} s; "
          f"the C++ tracer (g++) {time.perf_counter() - t1:.1f} s, {tracer}")

    # ---- 3. kernel vs plain ---------------------------------------------
    cam_rays = camera_rays_checks(dev, render, device_name, power_limit)
    splats = splat_checks(dev, film_mod, device_name, power_limit)
    scene = build_demo_scene(device=dev)
    camera = build_demo_camera(W, H, device=dev)
    settings = demo_settings(W, H, spp=1, samples_per_pass=1)
    band_rows = settings.chunk_pixels // W  # 273 rows: the main path's band
    cfg = render.path_config(settings)
    cone = render._cone(camera, settings)
    _, o, d, pixel, sample = render.band_rays(camera, settings, band_rows, band_rows, 0)
    n_band = o.shape[0]
    out = torch.empty_like(o)
    launch = megakernel.make_launch(megakernel.BRUTE, scene, o, d, pixel, sample, settings.seed,
                                    cfg, cone, out)
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
    lgot = integrators.li_fused(megakernel.BRUTE, ls, lo, ld, lpix, lsmp, lset.seed, lcfg,
                                cone=lcone)
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
    r_k = integrators.li_fused(megakernel.BRUTE, rscene, o, d, pixel, sample, settings.seed, cfg,
                               cone=cone)
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

    stamp("build and the demo / config-1 kernel checks")
    # the mesh scene: kernels #4 and #5, their checks, times and bounds
    mesh = mesh_checks(dev, band_rows)
    stamp("the mesh checks")

    # gradients: the bounce kernels forward, the path replay backward
    grad_demo = grad_check("demo", scene, (o, d, pixel, sample, cfg, cone), settings.seed,
                           "megakernel", ("intersect", "intersect_any"), device_name,
                           power_limit)
    grad_mesh = grad_check("mesh", mesh["scene"], mesh["band"], mesh["settings"].seed,
                           "mesh_megakernel", ("bvh_intersect", "bvh_intersect_any"),
                           device_name, power_limit)

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

    stamp("[grad] and the kernel times")
    # ---- 4. main paths --------------------------------------------------
    # the demo, path depth 10: the megakernel only
    dt, launches, film = timed_passes(render, film_mod, scene, camera, settings, dev)
    want = {"megakernel": 4 * N_PASSES, **loop_launches(settings, N_PASSES)}
    if launches != want:
        raise AssertionError(f"demo main path launched {launches} in {N_PASSES} passes, "
                             f"expected {want}")
    mega_launches, cam_launches = launches["megakernel"], launches["camera_rays"]
    splat_launches = launches["splat_rows"]
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

    stamp("the demo's main path and render")

    # config 1: direct lighting depth 3, one light per vertex
    dt1, launches1, film1 = timed_passes(render, film_mod, scene1, camera1, set1, dev)
    want = {"intersect": 16 * N_PASSES, "intersect_any": 12 * N_PASSES,
            **loop_launches(set1, N_PASSES)}
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
        if not seq_1:
            phase("kernel-time", "config-1 profiled pass: device ms of each launch not measured")
            break
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
            and "megakernel" not in launchesf
            and all(launchesf.get(k) == n for k, n in loop_launches(fset, N_PASSES).items())):
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

    stamp("config 1, the feature scene and the mesh main paths")

    # the render options on the demo: crop, Halton, filters, checkpoint
    # (after the earlier main paths, which run as they ran before them)
    opts = options_checks(dev, render, film_mod, scene, camera, settings, device_name,
                          power_limit)
    stamp("[options]")

    # the six families: glass on #1, media, subsurface and the light grid
    # on #2 / #3
    fam = family_checks(dev, render, film_mod, device_name, power_limit)
    stamp("the families")

    # compaction: the chain on compacted chunks, on #2 / #3 and on #4
    comp = compaction_checks(dev, render, film_mod, (
        ("demo", scene, camera, settings, "brute"),
        ("config 1's scene, path depth 3", scene1, camera1,
         set1._replace(integrator="path"), "brute"),
        ("metal mesh", mesh["metal"], mesh["cam"], mesh["settings"], "bvh")),
        device_name, power_limit)

    # motion blur: the plain, time-aware intersection, no kernel
    stamp("[compaction]")
    motion_checks(dev, render, film_mod, device_name, power_limit)
    stamp("[motion]")

    # config 5: the inverse-rendering trainer
    inverse = inverse_config5(dev, device_name, power_limit)
    stamp("[inverse]")

    # the last of the JAX package: the multi-rank render, the data-parallel
    # train step and the render service, on #1, #2 / #3 and #5
    sharded = shard_checks(dev, device_name, power_limit)
    stamp("[shard] and [shard-train]")
    served = service_checks(dev, device_name, power_limit)
    stamp("[service]")
    # the independent C++ tracer: every golden config's render on the card
    # against it, then its host baselines
    crossed = cross_validate_checks(dev, device_name, power_limit)
    stamp("[cross-validate]")
    baseline_runs(mesh["scene"])
    stamp("[baseline]")
    # the JAX package's last options: PathConfig's nee / mis on the demo (#2
    # / #3) and the mesh (#4), null_passes on bounded media, the HLBVH
    # build under #4, and the golden configs as their goldens render
    gated = path_config_checks(dev, render, film_mod, (
        ("demo", scene, camera, settings, "brute"),
        ("mesh", mesh["scene"], mesh["cam"], mesh["settings"], "bvh")),
        device_name, power_limit)
    stamp("[path-config]")
    nulls = null_passes_checks(dev, render, film_mod, device_name, power_limit)
    stamp("[null-passes]")
    hlbvh = hlbvh_checks(dev, mesh, device_name, power_limit)
    stamp("[hlbvh]")
    goldens = goldens_checks(dev, render, device_name, power_limit)
    stamp("[goldens]")
    slice_launches = {}
    for counts in (grad_demo["launches"], grad_mesh["launches"], inverse["launches"]):
        for k, v in counts.items():
            slice_launches[k] = slice_launches.get(k, 0) + v

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
        # the families' main paths launch it too
        by_family = {f: c.get(kind, 0) for f, c in fam["launches"].items()}
        line.append({
            "name": kind, "route": "cuda", "source": "gopbrt_tpu_torch/csrc/intersect.cu",
            "replaces": f"gopbrt_tpu/ops/pallas_intersect.py:{line_no}",
            "launches": launches1[kind] + sum(by_family.values()),
            "launches_per_pass": launches1[kind] // N_PASSES,
            "launches_families": by_family,
            "max_abs_err": max(worst[kind][1], fam["worst"][kind][1],
                               comp["worst"].get(kind, (1.0, 0.0))[1]), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_per_pass": per_pass.get(fn),
        })
    for name, source, replaces, launches, err, fn in (
            ("bvh_intersect", "bvh_intersect.cu", "pallas_cluster.py:127", launches_c,
             max(mesh["worst"]["bvh_intersect"][1],
                 comp["worst"].get("bvh_intersect", (1.0, 0.0))[1]), "bvh_closest_kernel"),
            ("bvh_intersect_any", "bvh_intersect.cu", "pallas_cluster.py:127", launches_c,
             max(mesh["worst"]["bvh_intersect_any"][1],
                 comp["worst"].get("bvh_intersect_any", (1.0, 0.0))[1]), "bvh_any_kernel"),
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
    # the camera rays (no TPU kernel): the demo main path's launches, one a
    # band of every pass; [camera-rays]'s own launches apart
    line.append({
        "name": "camera_rays", "route": "cuda", "source": "gopbrt_tpu_torch/csrc/camera_rays.cu",
        "replaces": None, "launches": cam_launches,
        "launches_per_pass": cam_launches // N_PASSES,
        "launches_camera_rays": cam_rays["launches"],
        "max_abs_err": max(cam_rays["max_do"], cam_rays["max_dd"]), "ms": cam_rays["ms"],
        "call_ms": cam_rays["call_ms"], "plain_ms": cam_rays["plain_ms"],
        "bound_ms": cam_rays["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "ms_per_pass": per_pass.get("camera_rays_kernel"),
    })
    # the splat (no TPU kernel): the demo main path's launches, one a band
    # of every pass; [splat]'s own launches apart
    line.append({
        "name": "splat_rows", "route": "cuda", "source": "gopbrt_tpu_torch/csrc/splat_rows.cu",
        "replaces": None, "launches": splat_launches,
        "launches_per_pass": splat_launches // N_PASSES, "launches_splat": splats["launches"],
        "max_abs_err": splats["max_err"], "ms": splats["ms"], "call_ms": splats["call_ms"],
        "plain_ms": splats["plain_ms"], "bound_ms": splats["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ms_per_pass": own_d.get("splat_rows_kernel"),
    })
    for row in line:  # the [grad] and [inverse] paths' launches of each kernel
        row["launches_grad_inverse"] = slice_launches.get(row["name"], 0)
        # the [options] and [compaction] phases' launches (their main paths
        # and timed passes; the comparisons with the plain versions apart)
        row["launches_options"] = opts["launches"].get(row["name"], 0)
        row["launches_compaction"] = comp["launches"].get(row["name"], 0)
        # the multi-rank render (all ranks), the train step, the service's requests
        row["launches_shard"] = sharded["shard"].get(row["name"], 0)
        row["launches_shard_train"] = sharded["shard_train"].get(row["name"], 0)
        row["launches_service"] = served.get(row["name"], 0)
        # the four golden configs' renders of [cross-validate]
        row["launches_cross_validate"] = crossed.get(row["name"], 0)
        # the passes of [path-config] and [null-passes], the band of
        # [hlbvh], the renders of [goldens]
        row["launches_path_config"] = gated["launches"].get(row["name"], 0)
        row["launches_null_passes"] = nulls["launches"].get(row["name"], 0)
        row["launches_hlbvh"] = hlbvh["launches"].get(row["name"], 0)
        row["launches_goldens"] = goldens.get(row["name"], 0)
        for phase_worst in (gated["worst"], nulls["worst"], hlbvh["worst"]):
            if row["name"] in phase_worst:
                row["max_abs_err"] = max(row["max_abs_err"], phase_worst[row["name"]][1])
    line[0]["launches_families"] = {f: c.get("megakernel", 0) for f, c in fam["launches"].items()}
    line[0]["max_abs_err"] = max(line[0]["max_abs_err"], opts["worst"][1],
                                 fam["worst"]["megakernel"][1])
    phase("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
