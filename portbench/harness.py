"""One run of one cell: set-up, the measured window, the trace, the check.

Everything is found by name from ``BENCHMARK.json``: a cell names its
configuration (``configs/<config>.json``, with the reference's scene in
``configs/<config>.py``) and its traffic mix (``traffic/<traffic>.json``),
which names the client that calls the program's entry
(``clients/<client>.py``); the check's tolerance and limits are
``checks/<cell>.json``; each end-to-end metric is read by
``e2e/<metric>.py`` and each per-layer metric by ``metrics/<metric>.py``
(each a ``read`` function that returns a number, or None where it finds
nothing to read).

The window drives the client in a closed loop with one client: a frame is
one call, ending when the developed image is on the host.  Frame k renders
with the seed ``frame_seed(seed, k)``, so no frame traces the paths of
another.  Frames start until ``seconds`` have passed, and every started
frame completes.
"""

from __future__ import annotations

import collections
import gc
import hashlib
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

import check
import devtrace
import roofline

HERE = Path(__file__).resolve().parent
# top-level module names that no run may load, compared whole: JAX and the
# JAX package, and the JAX package's benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "gopbrt_tpu", "benchmarks", "bench")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list


@dataclass
class Window:
    """The measured window: set-up seconds, the window's start, each
    frame's (start, end) on the host clock, and the camera rays a frame."""

    setup_s: float
    start: float
    frames: list
    rays_per_frame: int


@dataclass
class Readings:
    """What the per-layer readers read: the traced frames (devtrace.Frame),
    the untraced window, and the least ms of a frame's integrator work on
    the card (None where not counted)."""

    frames: list
    window: Window
    least_ms: float | None = None
    bound_by: str | None = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(manifest: dict, name: str) -> Cell:
    """The cell ``name`` of the manifest with its files."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    end_to_end = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    # a per-layer metric without a list of cells belongs to every cell that
    # reports the end-to-end metric it moves
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name,
                config=load_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                check=load_json(HERE / "checks" / f"{name}.json"),
                end_to_end=end_to_end, per_layer=per_layer)


def frame_seed(seed: int, k: int) -> int:
    """The render seed of frame k of the run of ``seed`` (k = -1: the
    warm-up): 31 bits of a hash of both."""
    h = hashlib.sha256(f"{seed}:{k}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def reader(kind: str, name: str):
    return check.load_module(HERE / kind / f"{name}.py")


def connect(cell: Cell, dev):
    """frame(seed) of the client that the cell's traffic names, which the
    harness drives as one client in a closed loop."""
    t = cell.traffic
    if t["loop"] != "closed" or t["clients"] != 1:
        raise ValueError(f"traffic of {cell.name}: the harness drives one client in a "
                         f"closed loop, not {t['clients']} in a {t['loop']} loop")
    return reader("clients", t["client"]).connect(cell.config, t["settings"], dev)


def describe(window: Window, seconds: float) -> str:
    """The window's frames on one line: their count, the extremes and median
    of their ms, and their mean ms in each tenth of the window."""
    frames = window.frames
    ms = sorted((b - a) * 1e3 for a, b in frames)
    tenths = [len(frames) * i // 10 for i in range(11)]
    return (f"frames: {len(frames)} in {frames[-1][1] - window.start:.3f} s (window "
            f"{seconds} s); ms a frame: min {ms[0]:.2f}, median {ms[len(ms) // 2]:.2f}, "
            f"max {ms[-1]:.2f}; by tenth of the window: " + " ".join(
                f"{sum(b - a for a, b in frames[i:j]) / max(j - i, 1) * 1e3:.1f}"
                for i, j in zip(tenths, tenths[1:])))


def breakdown(frames: list) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, in seconds a traced frame."""
    ops, idle = collections.Counter(), collections.Counter()
    for f in frames:
        for name, _, dur_ns in f.ops:
            ops[name[:160]] += dur_ns / 1e9
        for name, ms in f.idle_ms.items():
            idle[name] += ms / 1e3
    n = max(len(frames), 1)
    return {"device_ops": [[k, v / n] for k, v in ops.most_common(10)],
            "idle_gaps": [[k, v / n] for k, v in idle.most_common(10)]}


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda", log=None) -> dict:
    """One run of ``cell`` -> the result line's object."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    from gopbrt_tpu_torch import _build

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    settings = cell.traffic["settings"]
    render_frame = connect(cell, dev)

    # the client's two host buffers, pinned: a frame's image is copied into
    # the first, or into the second where the frame is the one kept for the
    # check (a copy from the card into pageable memory took ~11 ms of a
    # 40 ms demo frame and set most of the runs' spread)
    host = [torch.empty((settings["height"], settings["width"], 3), dtype=torch.float32,
                        pin_memory=on_card) for _ in range(2)]

    def frame(k: int, out: torch.Tensor):
        out.copy_(render_frame(frame_seed(seed, k)))

    for _ in range(cell.traffic["warmup_frames"]):
        frame(-1, host[0])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # the window: frames start until it closes; one frame, drawn from the
    # seed, is kept for the check (reservoir of one)
    pick = random.Random(f"portbench:{seed}")
    start = time.perf_counter()
    setup_s = start - t_process
    end, frames, kept = start + seconds, [], None
    while not frames or time.perf_counter() < end:
        keep = pick.randrange(len(frames) + 1) == 0
        t0 = time.perf_counter()
        frame(len(frames), host[keep])
        frames.append((t0, time.perf_counter()))
        if keep:
            kept = len(frames) - 1
    window = Window(setup_s, start, frames,
                    settings["width"] * settings["height"] * settings["spp"])
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules loaded that no run may load: {bad}")
    log(describe(window, seconds))

    metrics = {}
    result_device = {"platform": "gpu" if on_card else device,
                     "kind": torch.cuda.get_device_name(dev) if on_card else device,
                     "count": 1, "memory_peak_bytes": memory_peak}
    k, img = kept, host[1]
    traced = []
    if trace:
        for _ in range(cell.traffic["trace_frames"]):
            f = devtrace.capture(lambda: frame(k, host[0]), _build.LAUNCHES, log)
            if f is not None:
                traced.append(f)
        log(f"traced frames read: {len(traced)} of {cell.traffic['trace_frames']}"
            + (f" (render.li's device work by {traced[0].how})" if traced else ""))

    del render_frame, frame
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the check: the kept frame against the reference
    height = settings["height"]
    rows = min(cell.check["rows"], height)
    r0 = pick.randrange(height - rows + 1)
    readers = {m["name"]: reader("metrics", m["name"]) for m in cell.per_layer} if trace else {}
    counts = {} if any(getattr(r, "NEEDS_COUNTS", False) for r in readers.values()) else None
    t_ref = time.perf_counter()
    ref_scene, ref_camera = check.reference_inputs(cell.config, settings, dev)
    span = (0, height) if counts is not None else (r0, r0 + rows)
    ref = check.reference_rows(ref_scene, ref_camera, settings, frame_seed(seed, k), span,
                               counts=counts)
    ref = ref[r0 - span[0]:r0 - span[0] + rows]
    numbers = {"px_off": check.px_off(img.numpy()[r0:r0 + rows], ref, cell.check["pixel_tol"])}
    log(f"check: frame {k} of {len(frames)}, rows {r0}-{r0 + rows}, reference "
        f"{time.perf_counter() - t_ref:.1f} s")

    if trace:
        readings = Readings(traced, window)
        if counts is not None:
            readings.least_ms, readings.bound_by = roofline.least_ms(
                counts, window.rays_per_frame,
                roofline.table_bytes(ref_scene, check.fast_path(ref_scene)))
            log(f"roofline: least {readings.least_ms:.5f} ms a frame by "
                f"{readings.bound_by} ({roofline.fp32_ops(counts) / 1e9:.3f} GFLOP)")
        for m in cell.per_layer:
            v = readers[m["name"]].read(readings) if traced else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result_device["busy_s"] = sum(f.busy_ms for f in traced) / 1e3
        result_device["window_s"] = sum(f.wall_ms for f in traced) / 1e3
    else:
        for m in cell.end_to_end:
            v = reader("e2e", m["name"]).read(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    limits = cell.check["limits"]
    checks = {n: {"value": v, "limit": limits.get(n)} for n, v in numbers.items()}
    failed = int(any(c["limit"] is None or not c["value"] <= c["limit"]
                     for c in checks.values()))
    out = {"correct": failed == 0, "attempted": len(frames), "failed": failed,
           "metrics": metrics, "device": result_device}
    if trace and traced:
        out["breakdown"] = breakdown(traced)
    out["checks"] = checks
    return out
