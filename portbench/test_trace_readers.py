"""The readers of the program's tracer records (``metrics/li.*_idle_ms``,
``li.live_lane_share``, ``render.host_syncs[.tail]``), on synthetic frames
and records on one clock, on the CPU:

    python3 -m pytest portbench/test_trace_readers.py -q

- the idle split by innermost span;
- the idle charged to ``render.li`` and the spans inside it equals
  ``devtrace.reduce``'s ``idle_ms["render.li"]`` for the same events;
- a frame reads the request that opened last before its first device
  operation (a trace taken again counts once);
- the counters' arithmetic;
- None where the program keeps no records.
"""

from __future__ import annotations

import collections
import sys

import pytest
import torch

import devtrace
import harness
from gopbrt_tpu_torch.utils import trace

MS = 1_000_000
IDLE = ("li.intersect_idle_ms", "li.surface_idle_ms", "li.nee_idle_ms")
COUNTED = ("li.live_lane_share", "render.host_syncs", "render.host_syncs.tail")


@pytest.fixture
def tracer(monkeypatch):
    """The program's tracer on, with a ring of its own and a clock the test
    sets: ``play(spec)`` records one request of nested (name, start ms,
    end ms, children) spans and returns it."""
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=trace.RING))
    now = [0]
    monkeypatch.setattr(trace, "_clock", lambda: now[0])
    trace.enable()

    def play(spec, counts=()):
        name, a, b, kids = spec
        now[0] = a * MS
        with (trace.request() if name == trace.REQUEST else trace.span(name)) as req:
            for k in kids:
                play(k)
            for args in counts:
                trace.count(*args)
            now[0] = b * MS
        return req

    try:
        yield play
    finally:
        trace.disable()


def frame(ops_ms):
    """A traced frame of device operations (start ms, end ms)."""
    ops = [("k", a * MS, (b - a) * MS) for a, b in ops_ms]
    return devtrace.Frame(wall_ms=100.0, host_ms={}, ops=ops, li_ops=None, li_device_ms=None,
                          busy_ms=0.0)


def read(name, frames):
    return harness.reader("metrics", name).read(harness.Readings(frames=frames, window=None))


# the request of one band: camera rays, the chain, the splat
BAND = (trace.REQUEST, 0, 100, [
    ("render.band_rays", 0, 30, []),
    ("render.li", 30, 60, [
        ("li.intersect", 31, 35, []),
        ("li.surface", 36, 45, [("li.intersect", 38, 39, [])]),
        ("li.nee", 46, 58, [("li.intersect", 47, 49, [])]),
    ]),
    ("render.splat", 60, 70, []),
])
OPS = [(5, 10), (32, 33), (37, 37.5), (40, 41), (48, 48.5), (50, 52), (62, 63), (80, 81)]


def test_idle_split_by_innermost_span(tracer):
    req = tracer(BAND)
    split = harness.reader("metrics", "li.intersect_idle_ms").idle_by_span(frame(OPS), req)
    assert split == pytest.approx({
        "render.band_rays": 20.0,  # 10-30; 0-5 lies before the first operation
        "render.li": 1.0 + 1.0 + 1.0 + 2.0,  # 30-31, 35-36, 45-46, 58-60
        # 31-32, 33-35; 38-39 inside li.surface; 47-48, 48.5-49 inside li.nee
        "li.intersect": 1.0 + 2.0 + 1.0 + 1.0 + 0.5,
        "li.surface": 1.0 + 0.5 + 1.0 + 4.0,  # 36-37, 37.5-38, 39-40, 41-45
        "li.nee": 1.0 + 1.0 + 6.0,  # 46-47, 49-50, 52-58
        "render.splat": 2.0 + 7.0,  # 60-62, 63-70
        trace.REQUEST: 10.0,  # 70-80: the request's own span, outside the three
    })
    f = frame(OPS)
    assert read("li.intersect_idle_ms", [f]) == pytest.approx(5.5)
    assert read("li.surface_idle_ms", [f]) == pytest.approx(6.5)
    assert read("li.nee_idle_ms", [f, f]) == pytest.approx(8.0)


class Event:
    """A kineto event as devtrace.reduce reads it."""

    def __init__(self, name, kind, a, b):
        self._v = (name, kind, a * MS, (b - a) * MS)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return 0

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return False

    def is_hidden_event(self):
        return False


def test_render_li_and_its_spans_hold_devtraces_render_li_idle(tracer):
    """The program's spans and the profiler's ranges of one frame on one
    clock: the idle the reader charges to render.li and the spans inside
    it is what devtrace charges to the render.li range."""
    req = tracer(BAND)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = [Event(s.name, cpu, s.start_ns / MS, s.end_ns / MS) for s in req.spans
              if s.name in devtrace.RANGES]
    events = ([Event(devtrace.FRAME, cpu, 0, 100)] + ranges
              + [Event("k", cuda, a, b) for a, b in OPS])
    reduced = devtrace.reduce(events)
    split = harness.reader("metrics", "li.intersect_idle_ms").idle_by_span(reduced, req)
    inside = sum(ms for name, ms in split.items() if name in ("render.li", "li.intersect",
                                                                "li.surface", "li.nee"))
    assert inside == pytest.approx(reduced.idle_ms["render.li"]) and inside > 0
    assert split["render.splat"] == pytest.approx(reduced.idle_ms["render.splat"])


def test_a_frame_reads_its_last_request(tracer):
    """devtrace.capture took the frame again: two renders, and the frame
    read is the second, whose request opened last before its operations."""
    first = tracer((trace.REQUEST, 0, 100, [("render.li", 30, 60, [])]),
                   counts=[("host_syncs", 3)])
    again = tracer((trace.REQUEST, 200, 300, [("render.li", 230, 260, [])]),
                   counts=[("host_syncs", 5)])
    reqs = harness.reader("metrics", "render.host_syncs").requests
    later = frame([(205, 210), (240, 241)])
    assert reqs(harness.Readings(frames=[later], window=None)) == [again]
    assert read("render.host_syncs", [later]) == 5
    assert read("render.host_syncs", [frame([(5, 10)]), later]) == 4
    # the request that opened last before the frame's first operation:
    # the operations of the first render, though listed after the second's
    assert reqs(harness.Readings(frames=[frame([(240, 241), (5, 10)])],
                                 window=None)) == [first]
    # an operation before every request reads nothing
    assert read("render.host_syncs", [frame([(-5, -1)])]) is None


def test_counters(tracer):
    # the lanes alive entering a bounce are counted as masks, the tracer
    # sums them when read
    counts = [("li.lanes_run", 100, 0), ("li.lanes_live", torch.ones(100, dtype=torch.bool), 0),
              ("li.lanes_run", 100, 1), ("li.lanes_live", torch.arange(100) < 30, 1),
              ("li.lanes_run", 100, 2), ("li.lanes_live", torch.zeros(100, dtype=torch.bool), 2),
              ("host_syncs", 2), ("host_syncs", 1, "compaction")]
    tracer((trace.REQUEST, 0, 100, []), counts=counts)
    f = frame([(5, 10)])
    assert read("li.live_lane_share", [f]) == pytest.approx(100 * 130 / 300)
    assert read("render.host_syncs", [f]) == read("render.host_syncs.tail", [f]) == 3


def test_none_without_records(tracer, monkeypatch):
    f = frame(OPS)
    # no request at all
    for name in IDLE + COUNTED:
        assert read(name, [f]) is None, name
    # a request without the chain's spans or counts: only host_syncs reads
    tracer((trace.REQUEST, 0, 100, [("render.li", 30, 60, [])]))
    assert read("render.host_syncs", [f]) == 0
    for name in IDLE + COUNTED[:1]:
        assert read(name, [f]) is None, name
    # a program without the tracer (the parent of the change that added it)
    monkeypatch.setitem(sys.modules, "gopbrt_tpu_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["gopbrt_tpu_torch.utils"], "trace")
    for name in IDLE + COUNTED:
        assert read(name, [f]) is None, name
