#!/usr/bin/env python3
"""Checks of the program's tracer (``gopbrt_tpu_torch/utils/trace.py``) on
the card, at the benchmark cells' settings.

    python3 tools/trace_checks.py [--phase syncs,kernels,idle,cost,offcost]
                                  [--cells NAME,...] [--direct-reps N]

- ``syncs``: one frame of each cell (``portbench`` builds it, a warm-up
  frame first) under ``torch.cuda.set_sync_debug_mode("warn")`` with
  tracing on: every synchronising CUDA call the frame makes, by its call
  site in the program, against the frame's ``host_syncs`` counter.
- ``kernels``: kernels #1 and #5 on one 1920x273 band of their cell: the
  counting instance's radiance against the plain instance's (bit for bit),
  its ``paths`` against the lanes and its ``steps`` against the plain
  version's count of the same steps (``path_li_plain``'s ``bounces`` and
  shadow rays); ``warp_slots`` and the lane occupancy; the device ms of a
  launch of each instance, in turns; where ``steps`` differs, the lanes
  that differ (the band halved while a part's counts differ) and the
  plain version's events on each.
- ``idle``: one traced frame of each direct cell (``devtrace.capture``):
  the idle ms inside ``render.li`` split by the program's innermost span
  (the reader of ``li.intersect_idle_ms``) against devtrace's
  ``idle_ms["render.li"]``.
- ``cost``: traced frames of each cell in turns, the program as it is
  and with its tracer cut down to the three profiler ranges it opened
  before it had one (no other span, no counter): the host ms of
  ``render.li``, the operations launched inside it (frame by frame),
  their device ms.
- ``offcost``: untraced frames of each cell in turns, the same two ways:
  what the tracer costs while it is off.

Prints one line a result, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "portbench"))

import torch  # noqa: E402

import harness  # noqa: E402

CELLS = ("demo.path-d10.1080p-1spp", "demo.direct-d3.1080p-8spp",
         "mesh10k.path-d5.1080p-1spp", "mesh10k.direct-d3.1080p-8spp")
SEED = 2147483659
REPS = 3
DIRECT_REPS = [1]  # rounds of the cost phase in a direct cell (--direct-reps)
LAUNCHES = 10
REAL: dict = {}
OUTSIDE = "(outside the program)"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _trace():
    try:
        from gopbrt_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _cell(name: str):
    return harness.load_cell(harness.load_json(ROOT / "BENCHMARK.json"), name)


def _site(stack) -> str:
    """The program's innermost three frames of a stack, innermost first."""
    own = [f for f in stack if "gopbrt_tpu_torch" in f.filename]
    return " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
                       for f in reversed(own[-3:])) or OUTSIDE


def syncs(cells, dev) -> None:
    trace = _trace()
    for name in cells:
        frame = harness.connect(_cell(name), dev)
        frame(harness.frame_seed(SEED, -1))
        torch.cuda.synchronize()
        sites = collections.Counter()

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" in str(message):
                stack = traceback.extract_stack()[:-1]
                site = _site(stack)
                if site == OUTSIDE and not sites[site]:
                    say("syncs", "  the first outside the program: " + " <- ".join(
                        f"{f.filename}:{f.lineno} {f.name}" for f in reversed(stack[-8:])))
                sites[site] += 1

        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            if trace is not None:
                trace.enable()
            try:
                frame(harness.frame_seed(SEED, 0))
            finally:
                if trace is not None:
                    trace.disable()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        counted = trace.requests()[-1].total("host_syncs") if trace is not None else None
        say("syncs", f"{name}: {sum(sites.values())} synchronising calls in one frame, "
            f"host_syncs counted {counted}")
        for site, n in sites.most_common():
            say("syncs", f"  {n} x {site}")


def _program(cell):
    """The cell's scene and camera, built by its configuration's builders."""
    prog, st = cell.config["program"], cell.traffic["settings"]

    def build(spec):
        mod, fn = spec.split(":")
        return getattr(__import__(mod, fromlist=[fn]), fn)

    dev = torch.device("cuda")
    return (build(prog["scene"])(device=dev, **cell.config.get("kwargs", {})),
            build(prog["camera"])(st["width"], st["height"], device=dev))


def kernels(cells, dev) -> None:
    from gopbrt_tpu_torch import _build
    from gopbrt_tpu_torch.models import render
    from gopbrt_tpu_torch.ops import megakernel, mesh_megakernel

    trace = _trace()
    for lib, rec in _build.build().items():
        if "megakernel" in lib:
            lines = [ln.strip() for ln in rec["log"].splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            say("ptxas", f"{lib}: " + " | ".join(lines))
    for cell_name, kernel in (("demo.path-d10.1080p-1spp", megakernel.BRUTE),
                              ("mesh10k.path-d5.1080p-1spp", mesh_megakernel.MESH)):
        key, accel = kernel.entry.key, kernel.accel
        cell = _cell(cell_name)
        scene, camera = _program(cell)
        settings = render.RenderSettings(**cell.traffic["settings"])._replace(
            seed=harness.frame_seed(SEED, 0))
        rows = settings.chunk_pixels // settings.width
        _, o, d, pix, smp = render.band_rays(camera, settings, rows, rows, 0)
        cfg, cone = render.path_config(settings), render._cone(camera, settings)
        out = torch.empty_like(o)
        launch = megakernel.make_launch(kernel, scene, o, d, pix, smp, settings.seed, cfg, cone,
                                        out)
        plain = launch().clone()
        trace.enable()
        try:
            with trace.request() as req:
                counting = launch().clone()
        finally:
            trace.disable()
        torch.cuda.synchronize()
        got = {name: req.counter(name).get(key) for name in _build.STATS}
        counts, bounces = {}, torch.zeros((o.shape[0],), dtype=torch.int64, device=dev)
        ref = megakernel.path_li_plain(scene, o, d, pix, smp, settings.seed, cfg, cone=cone,
                                       counts=counts, accel=accel, bounces=bounces)
        # a step traces the closest hit; the BVH instance traces the shadow
        # ray in a step of its own, the brute one in the same step
        want = int(bounces.sum()) + (counts.get("shadow_rays", 0) if accel == "bvh" else 0)
        off = (counting - ref).abs().amax(dim=-1)
        ms = {False: [], True: []}
        for _ in range(REPS):
            for on in (False, True, True, False):
                ms[on].append(_launch_ms(launch, trace, on))
        launch()  # the plain instance last: out holds its radiance again
        say("kernels", f"{key} on one {settings.width}x{rows} band of {cell_name} "
            f"({o.shape[0]} lanes): counting instance bit-equal to the plain one: "
            f"{torch.equal(plain.view(torch.int32), counting.view(torch.int32))}; paths "
            f"{got['paths']}; steps {got['steps']} against the plain version's {want} "
            f"(bounces {int(bounces.sum())}, shadow rays {counts.get('shadow_rays', 0)}), "
            f"difference {got['steps'] - want}; warp slots {got['warp_slots']}, lane "
            f"occupancy {100.0 * got['steps'] / got['warp_slots']:.2f}%; lanes off the plain "
            f"radiance by more than 1e-3: {int((off > 1e-3).sum())}; ms a launch over "
            f"{LAUNCHES} back to back, median of {2 * REPS} each in turns: plain "
            f"{statistics.median(ms[False]):.4f}, counting {statistics.median(ms[True]):.4f}")
        if got["steps"] != want:
            for lane, k_steps, p_steps, events in _odd_lanes(
                    kernel, scene, (o, d, pix, smp), settings.seed, cfg, cone):
                say("kernels", f"{key}: lane {lane} (pixel {int(pix[lane])}, sample "
                    f"{int(smp[lane])}): kernel steps {k_steps}, plain {p_steps}; radiance "
                    f"kernel {plain[lane].tolist()} plain {ref[lane].tolist()}; the plain "
                    f"version's events on the lane {dict(sorted(events.items()))}")


def _odd_lanes(kernel, scene, rays, seed, cfg, cone, limit=4):
    """The lanes on which the counting instance of ``kernel`` makes another
    number of steps than the plain version counts: the band halved while a
    part's two counts differ, down to single lanes -> [(lane, kernel steps,
    plain steps, the plain version's events on the lane)]."""
    from gopbrt_tpu_torch.ops import megakernel

    trace = _trace()
    key, accel = kernel.entry.key, kernel.accel

    def steps(a: int, b: int):
        part = [x[a:b].contiguous() for x in rays]
        out = torch.empty_like(part[0])
        launch = megakernel.make_launch(kernel, scene, *part, seed, cfg, cone, out)
        trace.enable()
        try:
            with trace.request() as req:
                launch()
        finally:
            trace.disable()
        counts = {}
        bounces = torch.zeros((b - a,), dtype=torch.int64, device=part[0].device)
        megakernel.path_li_plain(scene, *part, seed, cfg, cone=cone, counts=counts,
                                 accel=accel, bounces=bounces)
        want = int(bounces.sum()) + (counts.get("shadow_rays", 0) if accel == "bvh" else 0)
        counts["bounces"] = int(bounces.sum())
        return req.counter("steps").get(key, 0), want, counts

    found, todo = [], [(0, rays[0].shape[0])]
    while todo and len(found) < limit:
        a, b = todo.pop()
        got, want, counts = steps(a, b)
        if got == want:
            continue
        if b - a == 1:
            found.append((a, got, want, counts))
            continue
        m = (a + b) // 2
        todo += [(m, b), (a, m)]
    return found


def _launch_ms(launch, trace, counting: bool) -> float:
    """Device ms a launch of LAUNCHES back to back between CUDA events, the
    counting instance where ``counting``."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if counting:
        trace.enable()
    try:
        with trace.request():
            a.record()
            for _ in range(LAUNCHES):
                launch()
            b.record()
    finally:
        trace.disable()
    b.synchronize()
    return a.elapsed_time(b) / LAUNCHES


def _ranges_only(trace, on: bool) -> None:
    """The tracer as the program is (``on``), or cut down to what the
    program opened before it had one: the profiler ranges of
    ``devtrace.RANGES`` alone, no other span, no counter."""
    import devtrace
    from torch.profiler import record_function

    if on:
        for name, fn in REAL.items():
            setattr(trace, name, fn)
        return
    if not REAL:
        REAL.update((n, getattr(trace, n)) for n in ("span", "request", "count", "on"))
    trace.span = lambda name: record_function(name) if name in devtrace.RANGES else trace._NULL
    trace.request = lambda: trace._NULL
    trace.count = lambda *args, **kw: None
    trace.on = lambda: False


def _median(values):
    values = list(values)
    return None if not values or None in values else statistics.median(values)


def cost(cells, dev) -> None:
    import devtrace
    from gopbrt_tpu_torch import _build

    trace = _trace()
    for name in cells:
        frame = harness.connect(_cell(name), dev)
        frame(harness.frame_seed(SEED, -1))
        got = {True: [], False: []}
        for _ in range(DIRECT_REPS[0] if ".direct-" in name else REPS):
            for on in (True, False, False, True):
                _ranges_only(trace, on)
                try:
                    f = devtrace.capture(lambda: frame(harness.frame_seed(SEED, 2)),
                                         _build.LAUNCHES, lambda m: say("cost", m))
                finally:
                    _ranges_only(trace, True)
                if f is not None:
                    got[on].append(f)
        line = []
        for on, what in ((True, "the program's spans and counters"),
                         (False, "the three ranges alone")):
            fs = got[on]
            line.append(f"{what} ({len(fs)} frames; li.device_kernels by frame "
                        f"{[f.li_ops for f in fs]}, by {sorted({f.how for f in fs})}): li.host_ms "
                        f"{_median(f.host_ms['render.li'] for f in fs)}, li.device_kernels "
                        f"{_median(f.li_ops for f in fs)}, li device ms "
                        f"{_median(f.li_device_ms for f in fs)}, frame ms "
                        f"{_median(f.wall_ms for f in fs)}, idle ms in render.li "
                        f"{_median(f.idle_ms.get('render.li', 0.0) for f in fs)}")
        say("cost", f"{name}, traced frames in turns, medians: " + "; ".join(line))


def offcost(cells, dev) -> None:
    trace = _trace()
    for name in cells:
        frame = harness.connect(_cell(name), dev)
        frame(harness.frame_seed(SEED, -1))
        ms = {True: [], False: []}
        for k in range(REPS + 1 if ".direct-" in name else 12 * REPS):
            for on in (True, False, False, True):
                _ranges_only(trace, on)
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    frame(harness.frame_seed(SEED, k))
                    torch.cuda.synchronize()
                    ms[on].append((time.perf_counter() - t0) * 1e3)
                finally:
                    _ranges_only(trace, True)
        a, b = statistics.median(ms[True]), statistics.median(ms[False])
        say("offcost", f"{name}, untraced frames in turns ({len(ms[True])} each), median ms: "
            f"the program {a:.3f}, with the three ranges alone {b:.3f} ({100 * (a / b - 1):+.2f}%)")


def idle(cells, dev) -> None:
    import devtrace
    from gopbrt_tpu_torch import _build

    split_of = harness.reader("metrics", "li.intersect_idle_ms").idle_by_span
    requests = harness.reader("metrics", "render.host_syncs").requests
    for name in cells:
        if ".direct-" not in name:
            continue
        frame = harness.connect(_cell(name), dev)
        frame(harness.frame_seed(SEED, -1))
        f = devtrace.capture(lambda: frame(harness.frame_seed(SEED, 1)), _build.LAUNCHES,
                             lambda m: say("idle", m))
        if f is None:
            say("idle", f"{name}: no trace held every launch")
            continue
        reqs = requests(harness.Readings(frames=[f], window=None))
        if reqs is None:
            say("idle", f"{name}: the frame's request holds no records")
            continue
        req = reqs[0]
        split = split_of(f, req)
        inside = {k: v for k, v in split.items()
                  if k in ("render.li", "li.intersect", "li.surface", "li.nee")}
        total = sum(inside.values())
        say("idle", f"{name}: idle ms inside render.li by innermost span "
            + ", ".join(f"{k} {v:.3f}" for k, v in inside.items())
            + f"; sum {total:.3f} against devtrace's render.li {f.idle_ms['render.li']:.3f} "
            f"({100.0 * (total / f.idle_ms['render.li'] - 1.0):+.3f}%); spans of the request "
            f"{len(req.spans)}, device operations {len(f.ops)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", default="syncs,kernels,idle,cost,offcost")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--direct-reps", type=int, default=DIRECT_REPS[0])
    args = ap.parse_args(argv)
    DIRECT_REPS[0] = args.direct_reps
    if not torch.cuda.is_available():
        print("trace_checks: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    say("device", f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    cells = args.cells.split(",")
    phases = {"syncs": syncs, "kernels": kernels, "idle": idle, "cost": cost,
              "offcost": offcost}
    for p in args.phase.split(","):
        t0 = time.perf_counter()
        phases[p](cells, dev)
        say("time", f"{p}: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
