#!/usr/bin/env python3
"""GPU gate of the PyTorch/CUDA port: the demo path trace on one card.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises, so the script exits
non-zero and never prints the last line:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: compiles the CUDA sources of gopbrt_tpu_torch (first use);
3. kernel vs plain: the bounce megakernel against its plain PyTorch
   version on the same inputs — one 1920x273 band of the 1080p demo at
   depth 10 (the main path's launch shape), and a lobe scene (checker
   floor, matte, mirror, smooth and rough glass, sphere lamp) at 256x256,
   depth 8;
4. main path: ``render_pass`` of the demo at 1920x1080, 1 spp, depth 10,
   through the normal entry points — one warm-up pass, then 5 timed
   passes; the launch counter must grow by 4 per pass.  Then ``render`` at
   4 spp, ``develop`` and ``write_png``;
   One more pass runs under ``torch.profiler``: the host time of each
   stage's range and the device's busy time;
5. the kernels line: time per launch, launches, bound, plain time.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, the script fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# bytes per path: o, d, pixel, sample in (32), radiance out (12)
BYTES_PER_PATH = 44

W, H, DEPTH = 1920, 1080, 10


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


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


def main() -> int:
    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import film as film_mod
    from gopbrt_tpu_torch.models import render
    from gopbrt_tpu_torch.models.demo import (build_demo_camera, build_demo_scene,
                                              demo_settings)
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
    _build.load()
    build_s = time.perf_counter() - t0
    for name, rec in info.items():
        ptxas = [ln.strip() for ln in rec["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{name}: nvcc {rec['seconds']:.1f} s; " + " | ".join(ptxas))
    phase("build", f"total {build_s:.1f} s")

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
    got = launch().clone()
    torch.cuda.synchronize()
    counts = {}
    ref = megakernel.path_li_plain(scene, o, d, pixel, sample, settings.seed, cfg,
                                   cone=cone, counts=counts)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("demo band: non-finite kernel output")
    frac, mean_rel, max_abs = agreement(got, ref)
    phase("kernel-vs-plain", f"demo band {W}x{band_rows} ({n_band} lanes), depth {DEPTH}, "
          f"cone on: {frac:.5f} of lanes within 1e-3, mean diff {mean_rel:.2e}, "
          f"max abs err {max_abs:.3e}, mean L {float(ref.mean()):.6f}")
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
    phase("kernel-vs-plain", f"lobe scene 256x256, depth 8: {lfrac:.5f} of lanes within "
          f"1e-3, mean diff {lmean:.2e}, max abs err {lmax:.3e}, "
          f"mean L {float(lref.mean()):.6f}")
    if not (lfrac > 0.98 and lmean < 1e-2):
        raise AssertionError("lobe scene: kernel disagrees with its plain version")

    # kernel and plain times on the demo band (CUDA events, medians)
    kernel_ms = cuda_ms(launch, reps=9)
    plain_ms = cuda_ms(lambda: megakernel.path_li_plain(
        scene, o, d, pixel, sample, settings.seed, cfg, cone=cone), reps=3)
    # the bound counts what this band's paths need: the events the plain
    # version counted, each at its fp32 operations (megakernel.OPS_PER_EVENT)
    flops = megakernel.fp32_ops(counts)
    phase("kernel-time", "events of the demo band as [count, fp32 ops]: " + json.dumps(
        {k: [v, v * megakernel.OPS_PER_EVENT[k]] for k, v in counts.items()}))
    nbytes = n_band * BYTES_PER_PATH + megakernel.TABLE_WORDS * 4
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    phase("kernel-time", f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms per band; "
          f"bound {bound_ms:.5f} ms by {bound_by} ({flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB); {bound_ms / kernel_ms:.4f} of the bound")

    # ---- 4. main path ---------------------------------------------------
    film = film_mod.new_film(W, H, device=dev)
    render.render_pass(scene, camera, film, settings, 0, device=dev)  # warm-up
    torch.cuda.synchronize()
    n_passes = 5
    megakernel.LAUNCHES.clear()
    t0 = time.perf_counter()
    for i in range(n_passes):
        film = render.render_pass(scene, camera, film, settings, i + 1, device=dev)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_passes
    launches = megakernel.LAUNCHES["megakernel"]
    if launches != 4 * n_passes:
        raise AssertionError(f"main path launched the megakernel {launches} times "
                             f"in {n_passes} passes, expected {4 * n_passes}")
    phase("main-path", f"{n_passes} passes of {W}x{H} 1 spp depth {DEPTH}: "
          f"{dt * 1e3:.2f} ms per pass, {launches} megakernel launches")
    print(json.dumps({
        "metric": "camera_rays_per_s_1080p_path_depth10",
        "value": W * H / dt,
        "unit": "rays/s",
        "device": device_name,
        "power_limit": power_limit,
    }), flush=True)

    # where one pass's time goes: one more pass under the profiler, read by
    # render_pass's stage ranges (host time) and the device's busy time
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        render.render_pass(scene, camera, film, settings, n_passes + 1, device=dev)
        torch.cuda.synchronize()
    # a range shows twice, as a host event and as an annotation on the
    # device's timeline; the device is busy for its kernels and copies
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host = {k: sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.name == f"render.{k}" and e.device_type == cpu) / 1e3
            for k in ("band_rays", "li", "splat")}
    device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == cuda and not e.name.startswith("render.")) / 1e3
    busy = (f"device busy {device_ms:.3f} ms, idle {1.0 - device_ms / (dt * 1e3):.4f} "
            f"of a timed pass" if device_ms > 0 else "device time not measured")
    phase("main-path", "one profiled pass, host ms by range: "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
          + f"; {busy}; the kernel is {4 * kernel_ms:.2f} ms (4 launches x "
          f"{kernel_ms:.3f} ms)")

    settings4 = demo_settings(W, H, spp=4, samples_per_pass=1)
    megakernel.LAUNCHES.clear()
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
    phase("render", f"{W}x{H} 4 spp in {render_s:.3f} s "
          f"({megakernel.LAUNCHES['megakernel']} launches), image mean {img_mean:.4f}, "
          f"PNG {len(png)} bytes")

    # ---- 5. kernels line ------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "gopbrt_tpu_torch/csrc/megakernel.cu",
        "replaces": "gopbrt_tpu/ops/pallas_megakernel.py:255",
        "launches": launches,
        "launches_per_pass": launches // n_passes,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
