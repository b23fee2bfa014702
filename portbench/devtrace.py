"""One frame under the profiler, reduced to what the per-layer metrics read.

The program's host ranges (``render.band_rays``, ``render.li``,
``render.splat``: ``models/render.py``) and the benchmark's own
``portbench.frame`` around the whole call give host milliseconds; the
card's kernels, copies and sets give device time.  The events are read
from the profiler's kineto results as they are (building a Python object
per event with ``prof.events()`` takes seconds on a frame of a hundred
thousand kernels).

A trace counts only where it holds one event of the program's CUDA kernels
for each launch the program's counter (``_build.LAUNCHES``) counted during
the frame: a trace that holds fewer dropped events and is taken again, at
most ``RETRIES`` times; if every one falls short, the frame is not read.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function

RANGES = ("render.band_rays", "render.li", "render.splat")
FRAME = "portbench.frame"
# idle time outside the program's three ranges: render's own loop,
# develop, the image's copy to the host
OTHER = "frame.other"
RETRIES = 2
# the device symbol of each kernel of the program, by its launch-counter
# key; a key not listed matches the symbols that contain the key itself
KERNEL_SYMBOL = {"megakernel": "mega_kernel", "mesh_megakernel": "mesh_kernel",
                 "intersect": "closest_hit_kernel", "intersect_any": "any_hit_kernel",
                 "bvh_intersect": "bvh_closest_kernel", "bvh_intersect_any": "bvh_any_kernel"}


@dataclass
class Frame:
    """One traced frame: host ms of the frame and of each range, the
    device's operations (name, start ns, duration ns), the count and device
    ms of the operations launched inside ``render.li``, the device's busy
    ms and the idle ms by what the host was doing."""

    wall_ms: float
    host_ms: dict
    ops: list
    li_ops: int | None
    li_device_ms: float | None
    busy_ms: float
    idle_ms: dict = field(default_factory=dict)
    how: str = ""


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(intervals, a, b) -> bool:
    return any(lo <= a and b <= hi for lo, hi in intervals)


def _range_at(host: list, t: int) -> str:
    """The innermost of the program's ranges open on the host at ``t``."""
    best = None
    for name, a, b in host:
        if name in RANGES and a <= t < b and (best is None or a > best[1]):
            best = (name, a)
    return best[0] if best else OTHER


def reduce(events) -> Frame:
    """A frame's reading from its kineto events."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host, notes, ops, runtime_start = [], collections.defaultdict(list), [], {}
    for e in events:
        if e.is_hidden_event():
            continue
        name, kind = e.name(), e.device_type()
        a, d = e.start_ns(), e.duration_ns()
        if kind == cpu:
            if name in RANGES or name == FRAME:
                host.append((name, a, a + d))
            elif name.startswith("cu"):
                runtime_start[e.correlation_id()] = a
        elif kind == cuda:
            if name in RANGES or name == FRAME or e.is_user_annotation():
                notes[name].append((a, a + d))
            else:
                ops.append((torch._C._demangle(name), a, d, e.linked_correlation_id()))
    frame = [(a, b) for n, a, b in host if n == FRAME]
    if len(frame) != 1:
        raise RuntimeError(f"a traced frame holds {len(frame)} {FRAME} ranges")
    fa, fb = frame[0]
    host_ms = {r: sum(b - a for n, a, b in host if n == r) / 1e6 for r in RANGES}
    # the operations launched inside render.li: those inside its device
    # annotation, else those whose launch call lies in its host range
    if notes.get("render.li"):
        li = [d for _, a, d, _ in ops if _inside(notes["render.li"], a, a + d)]
        how = "device annotations"
    elif runtime_start:
        li_host = [(a, b) for n, a, b in host if n == "render.li"]
        li = [d for _, _, d, c in ops
              if c in runtime_start and _inside(li_host, runtime_start[c], runtime_start[c])]
        how = "launch correlation"
    else:
        li, how = None, "no attribution"
    busy = _merge((max(a, fa), min(a + d, fb)) for _, a, d, _ in ops if a + d > fa and a < fb)
    # each idle gap split where the host entered or left one of the ranges
    cuts = sorted({x for n, a, b in host if n in RANGES for x in (a, b)})
    idle = collections.Counter()
    t = fa
    for a, b in busy + [[fb, fb]]:
        if a > t:
            points = [t] + [x for x in cuts if t < x < a] + [a]
            for p, q in zip(points, points[1:]):
                idle[_range_at(host, p)] += (q - p) / 1e6
        t = max(t, b)
    return Frame(wall_ms=(fb - fa) / 1e6, host_ms=host_ms,
                 ops=[(n, a, d) for n, a, d, _ in ops],
                 li_ops=None if li is None else len(li),
                 li_device_ms=None if li is None else sum(li) / 1e6,
                 busy_ms=sum(b - a for a, b in busy) / 1e6, idle_ms=dict(idle), how=how)


def own_kernels(ops, keys) -> dict:
    """Events of the program's kernels in ``ops``, by launch-counter key."""
    out = {}
    for k in keys:
        sym = KERNEL_SYMBOL.get(k, k)
        out[k] = sum(1 for name, _, _ in ops if sym in name)
    return out


def capture(fn, launches: collections.Counter, log) -> Frame | None:
    """``fn()`` (one frame) under the profiler, taken again where the trace
    dropped events -> its Frame, or None where every trace fell short."""
    act = torch.profiler.ProfilerActivity
    for attempt in range(1 + RETRIES):
        before = collections.Counter(launches)
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            with record_function(FRAME):
                fn()
            torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in launches.items() if v != before[k]}
        frame = reduce(prof.profiler.kineto_results.events())
        traced = own_kernels(frame.ops, launched)
        if traced == launched:
            return frame
        if any(n > launched[k] for k, n in traced.items()):
            raise RuntimeError(f"the trace holds {traced} of the program's kernels, more "
                               f"than the {launched} launched")
        log(f"trace: {traced} of the program's kernels against {launched} launched, "
            f"{len(frame.ops)} device operations; "
            + ("tracing again" if attempt < RETRIES else "frame not read"))
    return None
